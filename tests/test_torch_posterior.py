"""The port's posterior against the JAX package's.

Whole trajectories of the two packages cannot match bit for bit (threefry
and the torch generator give different streams), so the port's own draws
(the block uniforms, the per-boundary salts, the Gamma draws of the global
moves, how the streams are laid out over parts and boundaries) are held to
the reference through the distribution they sample:

- the port's float64 chain at configuration S of
  ``data/jax_posterior_reference.json`` (``tests/test_f32.py``'s recipe at
  60,000 steps: 20 tips x 400 sites, pinned start), against both committed
  JAX chains (``scripts/jax_posterior_reference.py``), under
  ``tests/test_f32.py``'s rule: each summary's distance in joint
  Monte-Carlo standard errors under max(8, 3 x the JAX null), the null
  being the two JAX chains' distance from each other; the within-window
  drift under 1e-8;
- the committed recipes reproduce their stored truth and tip-delta counts
  in both packages, and the pinned start of configuration R is the same
  tree in both;
- ``scripts/torch_validate_recovery.py`` and
  ``scripts/torch_ess_at_scale.py`` at tiny sizes on the CPU print what
  their JAX counterparts print (the same lines; a superset of the JSON
  keys), and refuse to run without CUDA unless given ``--device cpu``.

The JAX chains are committed, not run here: the JAX package is frozen, so
its posterior at a fixed recipe is a constant.  Configuration R (48 tips x
6,000 sites, VALIDATION.md's) is held on the card (``chip_smoke.py`` phase
15)."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
REF_PATH = os.path.join(REPO, "data", "jax_posterior_reference.json")
sys.path.insert(0, SCRIPTS)
import torch_ess_at_scale  # noqa: E402
import torch_f32_study  # noqa: E402
import torch_validate_recovery  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the chains run many tiny ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    with open(REF_PATH) as f:
        return json.load(f)


def test_port_posterior_matches_jax_reference(ref):
    S = ref["S"]
    cfg = {k: S["recipe"][k] for k in ("tips", "sites", "steps")}
    port = torch_f32_study.run_chain(torch.float64, dict(cfg, seed=5), "cpu")
    chains = S["chains"]
    null = torch_f32_study.compare(chains["5"], chains["1005"])
    bound = max(8.0, 3.0 * null["max_sigma"])
    assert port["max_drift"] < 1e-8
    for seed, chain in chains.items():
        assert chain["max_drift"] < 1e-8
        assert len(chain["trace"]["mu"]) == len(port["trace"]["mu"])
        report = torch_f32_study.compare(port, chain)
        assert report["max_sigma"] < bound, (seed, report["summaries"],
                                             null["summaries"])


def _datasets(recipe: dict, tips: int, sites: int):
    """(port, JAX) simulate_dataset at a stored dataset recipe."""
    from delphy_tpu.sim import simulate_dataset as j_sim

    from delphy_tpu_torch.sim import simulate_dataset
    kw = {k: recipe[k] for k in ("mu", "kappa", "sample_window_days",
                                 "coalescent_n0", "missing_fraction",
                                 "seed") if k in recipe}
    return (simulate_dataset(tips, sites, **kw),
            j_sim(tips, sites, **kw))


@pytest.mark.parametrize("config", ["S", "R"])
def test_reference_fixture_matches_its_recipe(ref, config):
    C = ref[config]
    data = C["recipe"]["data"]
    tips = data.get("tips", C["recipe"].get("tips"))
    sites = data.get("sites", C["recipe"].get("sites"))
    port, jax_ = _datasets(data, tips, sites)
    for got in (port, jax_):
        _, deltas, _, _, _, truth = got
        for chain in C["chains"].values():
            assert chain["truth"]["kappa"] == float(truth["kappa"])
            assert chain["truth"]["root_time"] == float(truth["root_time"])
            assert chain["truth"]["mu_per_year"] == data["mu"] * 365.0
            assert chain["tip_deltas"] == sum(len(d) for d in deltas)
    for a, b in zip(port[1], jax_[1]):
        assert [tuple(x) for x in a] == [tuple(x) for x in b]
    np.testing.assert_array_equal(port[0], jax_[0])
    if config == "R":
        # the port script's dataset is the stored recipe
        vr = torch_validate_recovery.dataset(tips, sites, data["seed"])
        np.testing.assert_array_equal(vr[0], port[0])
        assert vr[5]["root_time"] == port[5]["root_time"]
        run = C["recipe"]["run"]
        for chain in C["chains"].values():
            assert all(len(v) == run["samples"]
                       for v in chain["trace"].values())
    else:
        n = C["recipe"]["steps"]
        chunk = max(50 * (2 * tips - 1), 2000)
        samples = -(-(n - n // 5) // chunk)
        for chain in C["chains"].values():
            assert all(len(v) == samples for v in chain["trace"].values())


def test_pinned_start_is_the_jax_start(ref):
    """Configuration R's chains all start from one tree: the Python
    pipeline (native=False) at rng 101 builds the same tree in both
    packages."""
    from delphy_tpu.init_tree import build_initial_tree as j_build

    from delphy_tpu_torch.init_tree import build_initial_tree
    data, run = ref["R"]["recipe"]["data"], ref["R"]["recipe"]["run"]
    port, jax_ = _datasets(data, data["tips"], data["sites"])
    trees = [build(*ds[:4], names=ds[4], native=False,
                   rng=np.random.default_rng(run["tree_rng"]))
             for build, ds in ((build_initial_tree, port), (j_build, jax_))]
    a, b = trees
    np.testing.assert_array_equal(a.parent, b.parent)
    np.testing.assert_array_equal(a.t, b.t)
    assert a.num_mutations() == b.num_mutations()


def _script(name: str, env: dict, args: list):
    return subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, name)] + args, cwd=REPO,
        env=dict(os.environ, **env), capture_output=True, text=True,
        timeout=300)


def test_validate_recovery_script_on_cpu(tmp_path):
    from delphy_tpu.sim import simulate_dataset as j_sim
    out = tmp_path / "v.json"
    res = _script("torch_validate_recovery.py",
                  {"VAL_T": "12", "VAL_L": "600", "VAL_BURN": "2000",
                   "VAL_SAMPLES": "8", "VAL_THIN": "500"},
                  ["--device", "cpu", "--json", str(out)])
    lines = res.stdout.splitlines()
    # scripts/validate_recovery.py's recipe in the JAX package
    _, deltas, _, _, _, truth = j_sim(
        12, 600, mu=1e-2 / 365.0, kappa=3.0, sample_window_days=400.0,
        coalescent_n0=150.0, missing_fraction=0.05, seed=101)
    n = sum(len(d) for d in deltas)
    assert lines[0] == (f"dataset: 12 tips x 600 sites, {n} tip deltas, "
                        f"seed 101")
    heads = ["samples: 8 (thin 500) in ", "ESS: mu ",
             "clock rate: true 0.0100/yr | posterior ",
             "kappa:      true 3.00   | posterior ",
             f"root time:  true {truth['root_time']:.1f} | posterior ",
             "num_muts:   ", "RECOVERY: "]
    assert len(lines) == 1 + len(heads), res.stdout + res.stderr
    for line, head in zip(lines[1:], heads):
        assert line.startswith(head), (line, head)
    rec = json.loads(out.read_text())
    assert rec["dtype"] == "torch.float64" and rec["device"] == "cpu"
    assert all(len(v) == 8 for v in rec["trace"].values())
    assert rec["max_drift"] < 1e-8
    verdict = lines[-1].split()[-1]
    assert verdict == ("OK" if rec["recovery_ok"] else "OFF")
    assert res.returncode == (0 if rec["recovery_ok"] else 1), res.stderr
    # --against holds only R's dataset with a pinned start
    with pytest.raises(ValueError):
        torch_validate_recovery.check_recipe(rec["knobs"], True, {
            "R": {"recipe": {"data": {"tips": 48, "sites": 6000,
                                      "seed": 101}}}})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            torch_validate_recovery.recovery_chain(rec["knobs"])


def _jax_keys() -> set:
    """The keys of scripts/ess_at_scale.py's JSON line: its ``out`` dict
    literal and the ``out[...] =`` assignments after it."""
    tree = ast.parse(open(os.path.join(SCRIPTS, "ess_at_scale.py")).read())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1):
            t = node.targets[0]
            if isinstance(t, ast.Name) and t.id == "out" \
                    and isinstance(node.value, ast.Dict):
                keys |= {k.value for k in node.value.keys}
            elif (isinstance(t, ast.Subscript) and isinstance(t.value,
                                                             ast.Name)
                  and t.value.id == "out"):
                keys.add(t.slice.value)
    return keys


def test_ess_at_scale_script_on_cpu():
    res = _script("torch_ess_at_scale.py",
                  {"ESS_T": "12", "ESS_L": "600", "ESS_WINDOW": "3",
                   "ESS_SAMPLE_MOVES": "2000"}, ["--device", "cpu"])
    assert res.returncode == 0, res.stdout + res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    jax_keys = _jax_keys()
    assert {"ess_log_post", "ess_per_hour_t_root", "mcse_mu_rel",
            "moves_per_s", "topology_proposed"} <= jax_keys
    assert jax_keys <= set(out), jax_keys - set(out)
    assert {"card", "dtype", "kernels"} <= set(out)
    # float32 as the JAX script; no card and no kernel launch on the CPU
    assert out["dtype"] == "float32" and out["card"] is None
    assert out["kernels"] == {}
    assert (out["T"], out["L"]) == (12, 600)
    assert out["samples"] >= 2 and out["moves"] > 0
    assert 0 < out["ess_mu"] <= out["samples"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            torch_ess_at_scale.main([])
