"""The harness is driven by data: ``BENCHMARK.json`` keeps to the
benchmark's contract, every cell finds its files by name, and a new
configuration, traffic mix, metric and cell are new files and entries that
the harness resolves and dry-runs with no existing file edited."""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmarks import run as br
from benchmarks.tests.tiny import TINY_DATA, TINY_MPOX_DATA, tiny_run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench(root: str = br.ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def line_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_to_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["command"]) <= 32 and all(map(line_ok, b["command"]))
    assert b["paths"] == ["benchmarks"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in b[k]}) == len(b[k])
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    used = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_ok(c["source"]) and line_ok(c["why"])
        assert c["file"].startswith("benchmarks/")
        assert len(c["reduced"]) <= 16 and all(map(NAME.match, c["reduced"]))
        with open(os.path.join(br.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and line_ok(w["why"])
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == {c["name"] for c in b["configs"]}
    ends = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in ends and 1 <= len(b["end_to_end"]) <= 16
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in b["workloads"]}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
    reports = {w: {m["name"] for m in b["end_to_end"]
                   if w in m.get("workloads", cells)} for w in cells}
    for w in cells:
        assert "setup_s" in reports[w] and len(reports[w]) >= 2
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert line_ok(m["layer"]) and m["moves"] in ends
        assert all(m["moves"] in reports[w] for w in m["workloads"])
    layers = {}
    for m in b["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for w in cells:
        assert any(w in m["workloads"] for m in b["per_layer"])
    assert len(json.dumps(b)) <= 64 * 1024


def test_every_cell_finds_its_files():
    b = bench()
    for w in b["workloads"]:
        spec = br.load_spec(br.ROOT, w["name"])
        assert spec["config"]["precision"] == "float64"
        assert {"log_G_gap", "log_coal_gap", "log_other_gap",
                "nodes_unmoved"} <= set(spec["limits"])
        assert spec["per_layer"] and spec["end_to_end"]
        for m in spec["per_layer"]:
            assert callable(br.reader(spec["metrics_dir"], m["name"]))


def test_every_configuration_file_has_its_entry():
    """A file under ``configs/`` that no configuration names is run by
    nothing and checked by nothing."""
    named = {c["file"] for c in bench()["configs"]}
    files = {"benchmarks/configs/" + f
             for f in os.listdir(os.path.join(br.HERE, "configs"))}
    assert files == named


def tree_hashes(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


NEW_METRIC = '''"""calls_traced: the calls of the traced slice (a CPU dry run's
stand-in for a metric a later change adds)."""


def read(rec):
    return float(rec["calls"])
'''


def checkout(tmp_path):
    """A copy of ``BENCHMARK.json`` and the benchmark's folder, and the
    hashes of the folder's files."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(br.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(br.HERE, root / "benchmarks",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    return root, tree_hashes(str(root / "benchmarks"))


def unchanged(root, before: dict) -> bool:
    after = tree_hashes(str(root / "benchmarks"))
    return not [p for p in before if after.get(p) != before[p]]


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    root, before = checkout(tmp_path)
    here = root / "benchmarks"
    (here / "configs" / "tiny-sim-30x600.json").write_text(json.dumps(
        {"name": "tiny-sim-30x600", "source": "a CPU test's dataset",
         "dataset": TINY_DATA, "precision": "float64", "num_cells": 400,
         "reduced": []}))
    (here / "traffic" / "short-calls.json").write_text(json.dumps(
        {"run": {"pop_model": "exp"}, "priors": {}, "call_boundaries": 3,
         "warmup_quiet_calls": 1, "warmup_max_calls": 3, "trace_calls": 2}))
    (here / "metrics" / "calls_traced.py").write_text(NEW_METRIC)
    (here / "limits" / "tiny-short.json").write_text(json.dumps(
        {"log_G_gap": 1e-9, "log_coal_gap": 1e-9, "log_other_gap": 1e-9,
         "nodes_unmoved": 10}))
    b = bench(str(root))
    b["configs"].append({"name": "tiny-sim-30x600", "source": "a test",
                         "file": "benchmarks/configs/tiny-sim-30x600.json",
                         "reduced": [], "why": "a CPU test's dataset"})
    b["workloads"].append({"name": "tiny-short", "config": "tiny-sim-30x600",
                           "traffic": "short-calls", "chips": 1,
                           "why": "a CPU dry run"})
    b["end_to_end"].append({"name": "steps_per_s.tiny", "unit": "steps/s",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["tiny-short"]})
    b["per_layer"].append({"name": "calls_traced", "unit": "calls",
                           "better": "higher", "source": "program_counter",
                           "layer": "driver", "moves": "steps_per_s.tiny",
                           "workloads": ["tiny-short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    spec = br.load_spec(str(root), "tiny-short")
    assert [m["name"] for m in spec["per_layer"]] == ["calls_traced"]
    br.isolate_environment()
    res = br.run_cell(spec, 2 ** 31 + 99, 0.3, True, device="cpu")
    assert res["correct"], res["checks"]
    assert res["metrics"] == {"calls_traced": {"value": 2.0,
                                               "unit": "calls"}}
    res = br.run_cell(spec, 2 ** 31 + 99, 0.3, False, device="cpu")
    assert set(res["metrics"]) == {"steps_per_s.tiny", "setup_s"}
    assert unchanged(root, before)


def test_an_mpox_cell_is_new_files_and_entries(tmp_path):
    """A configuration of APOBEC3-shaped genomes and a traffic mix with the
    mpox model on: new files and entries only, judged by the mpox oracle."""
    root, before = checkout(tmp_path)
    here = root / "benchmarks"
    (here / "configs" / "tiny-apobec-30x600.json").write_text(json.dumps(
        {"name": "tiny-apobec-30x600", "source": "a CPU test's dataset",
         "dataset": TINY_MPOX_DATA, "precision": "float64",
         "num_cells": 400, "reduced": []}))
    (here / "traffic" / "mpox-short.json").write_text(json.dumps(
        {"run": {"pop_model": "exp", "mpox_hack": True}, "priors": {},
         "call_boundaries": 3, "warmup_quiet_calls": 1,
         "warmup_max_calls": 3, "trace_calls": 2}))
    (here / "metrics" / "calls_traced.py").write_text(NEW_METRIC)
    (here / "limits" / "tiny-mpox.json").write_text(json.dumps(
        {"log_G_gap": 1e-11, "log_coal_gap": 1e-11, "log_other_gap": 1e-11,
         "nodes_unmoved": 10}))
    b = bench(str(root))
    b["configs"].append({"name": "tiny-apobec-30x600", "source": "a test",
                         "file": "benchmarks/configs/tiny-apobec-30x600.json",
                         "reduced": [], "why": "a CPU test's dataset"})
    b["workloads"].append({"name": "tiny-mpox",
                           "config": "tiny-apobec-30x600",
                           "traffic": "mpox-short", "chips": 1,
                           "why": "a CPU dry run of the mpox model"})
    b["end_to_end"].append({"name": "steps_per_s.mpox", "unit": "steps/s",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["tiny-mpox"]})
    b["per_layer"].append({"name": "calls_traced", "unit": "calls",
                           "better": "higher", "source": "program_counter",
                           "layer": "driver", "moves": "steps_per_s.mpox",
                           "workloads": ["tiny-mpox"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    spec = br.load_spec(str(root), "tiny-mpox")
    br.isolate_environment()
    res = br.run_cell(spec, 2 ** 31 + 98, 0.3, True, device="cpu")
    assert res["correct"], res["checks"]
    assert res["metrics"] == {"calls_traced": {"value": 2.0,
                                               "unit": "calls"}}
    res = br.run_cell(spec, 2 ** 31 + 98, 0.3, False, device="cpu")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"steps_per_s.mpox", "setup_s"}
    assert res["checks"]["partition_faults"]["value"] == 0
    assert res["checks"]["params_unmoved"]["value"] == 0
    assert unchanged(root, before)


def test_the_result_line_holds_the_contracts_keys():
    res = tiny_run("ebola81-alphanu", trace=True, seconds=0.3)
    line = {k: v for k, v in res.items() if not k.startswith("_")}
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device",
            "breakdown"} <= set(line)
    assert {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
            "window_s"} <= set(line["device"])
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(line["checks"]) == [
        "tip_mismatches", "mutation_faults", "tree_faults", "tip_date_faults",
        "partition_faults", "params_unmoved", "log_G_gap", "log_coal_gap",
        "log_other_gap", "nodes_unmoved"]
    assert line["checks"]["partition_faults"] == {"value": 0.0, "limit": 0}
    assert json.loads(json.dumps(line)) == line


def test_the_command_refuses_without_a_card():
    """Here there is no card: no result line and a non-zero exit."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = subprocess.run(
        [sys.executable, "-m", "benchmarks.run", "--workload", "ebola81-exp",
         "--seed", str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"],
        cwd=br.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_command_fails_without_the_program(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's folder
    has no system to measure."""
    shutil.copy(os.path.join(br.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(br.HERE, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, "-m", "benchmarks.run", "--workload", "ebola81-exp",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "-m", "benchmarks.run", "--workload", "ebola81-exp",
         "--seed", str(2 ** 31 + 5), "--seconds", "2", "--trace", "0"],
        cwd=br.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
