"""The committed mpox cell (``mpox200x197k-exp`` in ``BENCHMARK.json``)
finds its files, and runs on the CPU through the benchmark's own
``run_cell`` from a temporary copy of the benchmark whose configuration
is cut to 30 tips x 600 sites: judged correct by the mpox oracle, with no
partition fault.  The committed files are left as they were."""

import hashlib
import json
import os
import shutil

from benchmarks import run as br

CELL = "mpox200x197k-exp"
CONFIG = "benchmarks/configs/hmpxv1-apobec-200x197209-f64.json"


def _hashes(root: str) -> dict:
    """The benchmark's files, without the caches it builds."""
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x not in ("_cache", "__pycache__")]
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = (
                    hashlib.sha256(fh.read()).hexdigest())
    return out


def test_the_mpox_cell_loads():
    spec = br.load_spec(br.ROOT, CELL)
    cfg, traffic = spec["config"], spec["traffic"]
    assert cfg["name"] == "hmpxv1-apobec-200x197209-f64"
    assert cfg["precision"] == "float64" and cfg["reduced"] == []
    ds = cfg["dataset"]
    assert (ds["kind"], ds["num_tips"], ds["num_sites"]) == (
        "simulated_apobec", 200, 197209)
    assert traffic["run"] == {"pop_model": "exp", "mpox_hack": True}
    assert traffic["call_boundaries"] == "burst"
    assert {m["name"] for m in spec["end_to_end"]} == {
        "steps_per_s.skygrid-alphanu", "setup_s"}
    names = {m["name"] for m in spec["per_layer"]}
    assert {"mpox_moves_device_ms.skygrid-alphanu",
            "mpox_rounds_ops_per_boundary.skygrid-alphanu",
            "graph_capture_s"} <= names
    for m in spec["per_layer"]:
        assert callable(br.reader(spec["metrics_dir"], m["name"]))
    assert {"log_G_gap", "log_coal_gap", "log_other_gap",
            "nodes_unmoved"} <= set(spec["limits"])


def test_the_mpox_cell_runs_cut_to_30_tips_by_600_sites(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(br.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(br.HERE, root / "benchmarks",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    before = _hashes(br.HERE)
    path = root / CONFIG
    cfg = json.loads(path.read_text())
    ds = cfg["dataset"]
    # the same expected differences a genome at 600 sites: mu scaled up by
    # the sites cut away
    cfg["dataset"] = dict(ds, num_tips=30, num_sites=600,
                          mu=ds["mu"] * ds["num_sites"] / 600)
    path.write_text(json.dumps(cfg))
    spec = br.load_spec(str(root), CELL)
    assert spec["config"]["dataset"]["num_tips"] == 30
    # calls of three boundaries, not a burst's 256 at this size: a CPU run
    spec["traffic"] = dict(spec["traffic"], call_boundaries=3)
    br.isolate_environment()
    res = br.run_cell(spec, 2 ** 31 + 23, 0.3, False, device="cpu")
    assert res["correct"], res["checks"]
    assert res["checks"]["partition_faults"]["value"] == 0
    assert res["checks"]["params_unmoved"]["value"] == 0
    assert set(res["metrics"]) == {"steps_per_s.skygrid-alphanu", "setup_s"}
    assert _hashes(br.HERE) == before
