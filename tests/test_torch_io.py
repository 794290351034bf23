"""The port's I/O layer against the JAX package's, from the same state.

A JAX ``Run`` is stepped on a numpy-seeded simulated dataset and saved with
the JAX package's ``save_run``; ``convert.load_jax_snapshot`` puts a port
``Run`` (CPU) into that state, and the ledger is copied across.  Then both
packages' writers must agree: byte for byte where the output is text or a
flatbuffer built from copied f64 values (Newick, the BEAST .log line, the
three BEAST XML exports, the Tree/TreeInfo/Params flatbuffers, MCC NEXUS), to
1e-12 where a value is computed on each side (the probers' population
integrals, ``ess``), and ``calc_cur_ledger`` of the loaded state to 1e-8.
Snapshot resume on the CPU is compared with ``==``.
"""

import io
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from delphy_tpu import ess as jess
from delphy_tpu import mcc as jmcc
from delphy_tpu import probers as jprobers
from delphy_tpu import sim as jsim
from delphy_tpu.io import beast_out as jbeast_out
from delphy_tpu.io import beast_xml as jbeast_xml
from delphy_tpu.io import dphy as jdphy
from delphy_tpu.io import newick as jnewick
from delphy_tpu.io import snapshot as jsnapshot
from delphy_tpu.phylo import build_random_tree
from delphy_tpu.run import Run as JRun

from delphy_tpu_torch import convert, ess, mcc, probers, sim, tools
from delphy_tpu_torch.io import beast_out, beast_xml, dphy, newick, snapshot
from delphy_tpu_torch.mcmc.moves import Ledger
from delphy_tpu_torch.version import __version__

# these tests run in float64, the port's default precision
DTYPE = torch.float64


def _jax_run(seed=59, T=8, L=100, **kw):
    ref, deltas, miss, dates, names, _ = jsim.simulate_dataset(
        T, L, mu=2e-4, seed=seed)
    tree = build_random_tree(ref, deltas, miss, dates, names=names,
                             rng=np.random.default_rng(seed))
    return JRun(tree, seed=seed, num_cells=64,
                local_moves_per_global_move=200, **kw)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX run, port run) in the same state after 600 steps, ledger
    included, and the sampled trees of the JAX run."""
    jrun = _jax_run()
    trees = []
    for _ in range(3):
        jrun.do_mcmc_steps(200)
        trees.append(jrun.tree())
    path = tmp_path_factory.mktemp("io") / "jax.npz"
    jsnapshot.save_run(jrun, path)
    run = convert.load_jax_snapshot(path, gen_seed=7, device="cpu")
    run.ledger = Ledger(*[torch.tensor(float(v), dtype=DTYPE)
                          for v in jrun.ledger])
    return jrun, run, trees, path


def test_jax_snapshot_loads_into_the_same_state(pair):
    jrun, run, _trees, _path = pair
    assert run.step == jrun.step == 600
    for f in run.ts._fields:
        np.testing.assert_array_equal(getattr(run.ts, f).numpy(),
                                      np.asarray(getattr(jrun.ts, f)), f)
    for f in run.pm._fields:
        np.testing.assert_array_equal(getattr(run.pm, f).numpy(),
                                      np.asarray(getattr(jrun.pm, f)), f)
    assert run.local_moves_attempted == jrun.local_moves_attempted
    assert run._per_block_rate == jrun._per_block_rate
    assert run._topo_debt == jrun._topo_debt
    assert run._P_sticky == jrun._P_sticky
    # the host generator continues from the same state
    assert run.host_rng.integers(2 ** 62) == jrun.host_rng.integers(2 ** 62)
    got, want = run.calc_cur_ledger(), jrun.calc_cur_ledger()
    for f in got._fields:   # stated tolerance: 1e-8
        assert float(getattr(got, f)) == pytest.approx(
            float(getattr(want, f)), abs=1e-8), f
    # and the loaded run steps with a green ledger
    run2 = convert.load_jax_snapshot(pair[3], gen_seed=7, device="cpu")
    run2.do_mcmc_steps(600)
    run2.check_derived_quantities(1e-6)
    run2.tree().check_integrity()


def test_host_view_is_the_run_on_the_host(pair):
    jrun, run, _trees, _path = pair
    hv = run.host_view()
    for f in hv.evo._fields:
        np.testing.assert_array_equal(getattr(hv.evo, f),
                                      np.asarray(getattr(jrun.evo, f)), f)
        assert isinstance(getattr(hv.evo, f), (np.ndarray, np.generic)), f
    for f in hv.pop._fields:
        assert float(getattr(hv.pop, f)) == float(getattr(jrun.pop, f)), f
    assert hv.evo.part.dtype == np.int32
    assert float(hv.ledger.log_posterior) == float(jrun.ledger.log_posterior)
    np.testing.assert_array_equal(hv.t, np.asarray(jrun.ts.t))
    assert hv.root == int(jrun.ts.root) and hv.num_muts is None


def test_newick_and_tree_equal(pair):
    jrun, run, _trees, _path = pair
    jt, t = jrun.tree(), run.tree()
    s = beast_out.newick_string(t)
    assert s == jbeast_out.newick_string(jt)
    a = newick.newick_to_flat_tree(newick.parse_newick(s), t.ref_seq,
                                   t_root=float(t.t[t.root]))
    b = jnewick.newick_to_flat_tree(jnewick.parse_newick(s), jt.ref_seq,
                                    t_root=float(jt.t[jt.root]))
    np.testing.assert_array_equal(a.parent, b.parent)
    np.testing.assert_array_equal(a.t, b.t)


@pytest.mark.parametrize("flags", [
    {}, {"mu_move_enabled": False, "alpha_move_enabled": True},
    {"pop_size_move_enabled": False, "pop_growth_rate_move_enabled": False}])
def test_beast_log_line_equal(pair, flags):
    jrun, run, _trees, _path = pair
    got, want = io.StringIO(), io.StringIO()
    for mod, r, fh in ((beast_out, run, got), (jbeast_out, jrun, want)):
        out = mod.BeastLogOutput(fh, **flags)
        out.write_headers(r.tree())
        out.write_line(r)
    assert got.getvalue() == want.getvalue()
    header, line = got.getvalue().splitlines()
    assert header.startswith("Sample\tposterior\tlikelihood_really_logG")
    assert len(header.split("\t")) == len(line.split("\t"))


def test_beast_trees_file_equal(pair):
    jrun, run, _trees, _path = pair
    got, want = io.StringIO(), io.StringIO()
    for mod, r, fh in ((beast_out, run, got), (jbeast_out, jrun, want)):
        out = mod.BeastTreesOutput(fh)
        out.write_preamble(r.tree())
        out.write_tree(r.tree(), r.step)
        out.write_epilog()
    assert got.getvalue() == want.getvalue()


@pytest.mark.parametrize("fn", ["export_beast2_xml", "export_beast2_7_xml",
                                "export_beast_x_xml"])
def test_beast_xml_exports_equal(pair, fn):
    jrun, run, _trees, _path = pair
    got, want = io.StringIO(), io.StringIO()
    getattr(beast_xml, fn)(got, run.tree(), run)
    getattr(jbeast_xml, fn)(want, jrun.tree(), jrun)
    assert got.getvalue() == want.getvalue()
    assert "<beast" in got.getvalue()


@pytest.mark.parametrize("fb", ["tree", "tree_info", "params"])
def test_flatbuffers_equal(pair, fb):
    jrun, run, _trees, _path = pair
    if fb == "params":
        got, want = dphy.build_params_fb(run), jdphy.build_params_fb(jrun)
    else:
        got = getattr(dphy, f"build_{fb}_fb")(run.tree())
        want = getattr(jdphy, f"build_{fb}_fb")(jrun.tree())
    assert got == want and len(got) > 16


def _write_dphy(mod, run, path):
    with open(path, "wb") as f:
        out = mod.DphyOutput(f)
        out.output_preamble(run, steps_per_sample=100)
        out.output_state(run)
        out.output_epilog()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dphy_crosses_between_the_packages(pair, tmp_path, writer):
    """A .dphy written by one package is read by the other's reader."""
    jrun, run, _trees, _path = pair
    path = tmp_path / "x.dphy"
    if writer == "port":
        _write_dphy(dphy, run, path)
        df, own = jdphy.read_dphy(path), dphy.read_dphy(path)
        assert df.preamble["commit"] == "torch-cuda"
        assert df.preamble["core_version"] == __version__
    else:
        _write_dphy(jdphy, jrun, path)
        df, own = dphy.read_dphy(path), jdphy.read_dphy(path)
    assert len(df.samples) == 1 and df.names == own.names
    (tree, params), (tree0, params0) = df.samples[0], own.samples[0]
    want = run.tree()
    np.testing.assert_array_equal(tree.parent, tree0.parent)
    np.testing.assert_array_equal(tree.children, want.children)
    np.testing.assert_allclose(tree.t, want.t, rtol=1e-6)   # f32 on the wire
    assert tree.num_mutations() == want.num_mutations()
    assert params["step"] == 600 and params["pop_model"]["kind"] == "exp"
    hv = run.host_view()
    assert params["mu"] == float(hv.evo.mu)
    assert params["pop_model"]["n0"] == float(hv.pop.n0)
    assert params["log_G"] == float(hv.ledger.log_G)
    assert {k: v for k, v in params.items() if k not in ("nu", "pop_model")} \
        == {k: v for k, v in params0.items() if k not in ("nu", "pop_model")}


def test_dphy_writer_names_the_missing_package(pair, monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "flatbuffers", None)
    with pytest.raises(ImportError, match="flatbuffers"):
        dphy.build_tree_fb(pair[1].tree())
    with pytest.raises(ImportError, match="flatbuffers"):
        dphy.DphyOutput(io.BytesIO())


def test_mcc_equal(pair):
    _jrun, _run, trees, _path = pair
    got, want = mcc.derive_mcc_tree(trees, seed=3), \
        jmcc.derive_mcc_tree(trees, seed=3)
    assert got.master_index == want.master_index
    np.testing.assert_array_equal(got.posterior_support,
                                  want.posterior_support)
    np.testing.assert_array_equal(got.tree.t, want.tree.t)
    a, b = io.StringIO(), io.StringIO()
    mcc.mcc_to_nexus(got, a)
    jmcc.mcc_to_nexus(want, b)
    assert a.getvalue() == b.getvalue() and "tree MCC =" in a.getvalue()


@pytest.mark.parametrize("kind", ["iid", "ar1", "constant", "short"])
def test_ess_equal(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(size=2000)
    if kind == "ar1":
        for i in range(1, 2000):
            x[i] = 0.95 * x[i - 1] + x[i]
    elif kind == "constant":
        x[:] = 2.0
    elif kind == "short":
        x = x[:3]
    assert ess.ess(x) == pytest.approx(jess.ess(x), rel=1e-12)
    assert ess.mcse(x) == pytest.approx(jess.mcse(x), rel=1e-12)


@pytest.mark.parametrize("g, min_pop", [(0.0, 1.0), (0.01, 1.0),
                                        (-0.02, 30.0), (0.005, 0.0)])
def test_probers_equal(pair, g, min_pop):
    """Tolerance 1e-12: the population integrals are computed by torch on one
    side and XLA on the other."""
    jrun, run, _trees, _path = pair
    tree = run.tree()
    from delphy_tpu import pop as jpop
    vals = dict(t0=run.t_max_tip, n0=100.0, g=g, min_pop=min_pop)
    pop_j = jpop.ExpPopParams(**{k: jnp.float64(v) for k, v in vals.items()})
    pop_h = run.host_view().pop._replace(
        **{k: np.float64(v) for k, v in vals.items()})
    t_root = float(tree.t[tree.root])
    c0, c1 = (int(c) for c in tree.children[tree.root])
    got = probers.probe_ancestors_on_tree(tree, pop_h, [c0, c1],
                                          t_root - 10.0, run.t_max_tip, 30)
    want = jprobers.probe_ancestors_on_tree(jrun.tree(), pop_j, [c0, c1],
                                            t_root - 10.0, run.t_max_tip, 30)
    assert got.shape == (3, 30)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    got = probers.probe_site_states_on_tree(tree, pop_h, 0, t_root - 10.0,
                                            run.t_max_tip, 25)
    want = jprobers.probe_site_states_on_tree(jrun.tree(), pop_j, 0,
                                              t_root - 10.0, run.t_max_tip,
                                              25)
    assert got.shape == (4, 25)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_sim_equal():
    got = sim.simulate_dataset(12, 150, mu=2e-3, kappa=3.0, seed=5)
    want = jsim.simulate_dataset(12, 150, mu=2e-3, kappa=3.0, seed=5)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:5] == want[1:5]
    assert got[5]["root_time"] == want[5]["root_time"]


def test_snapshot_roundtrip_and_exact_resume(pair, tmp_path):
    run = convert.load_jax_snapshot(pair[3], gen_seed=11, device="cpu")
    run.do_mcmc_steps(400)
    path = tmp_path / "state.npz"
    snapshot.save_run(run, path)
    run2 = snapshot.load_run(path, device="cpu")
    assert run2.step == run.step == 1000
    for f in run.ts._fields:
        assert torch.equal(getattr(run2.ts, f), getattr(run.ts, f)), f
    for f in run.pm._fields:
        assert torch.equal(getattr(run2.pm, f), getattr(run.pm, f)), f
    for name in ("_P_sticky", "_n_cap_sticky", "_m_cap_sticky", "_topo_debt",
                 "_per_block_rate", "_boundaries_since_repart",
                 "topology_burst_chunks", "local_moves_attempted",
                 "topology_accepted", "topology_proposed", "dispatch_count",
                 "burst_count", "mut_capacity", "topology_partitions"):
        assert getattr(run2, name) == getattr(run, name), name
    assert torch.equal(run2.gen.get_state(), run.gen.get_state())
    assert float(run2.calc_cur_ledger().log_G) \
        == float(run.calc_cur_ledger().log_G)
    # the resumed run continues the trajectory exactly, through a burst
    bursts = run.burst_count
    run.do_mcmc_steps(600)
    run2.do_mcmc_steps(600)
    assert run.burst_count > bursts
    assert run.log_posterior == run2.log_posterior
    assert torch.equal(run.ts.t, run2.ts.t)


def _rewrite_meta(src, dst, **changes):
    with np.load(src) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["_meta_json"]).decode())
    meta.update(changes)
    arrays["_meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(dst, **arrays)


def test_snapshot_refuses_the_other_device_type(pair, tmp_path):
    run = pair[1]
    path, other = tmp_path / "cpu.npz", tmp_path / "cuda.npz"
    snapshot.save_run(run, path)
    _rewrite_meta(path, other, gen_device_type="cuda")
    with pytest.raises(ValueError, match="written on a cuda device cannot "
                                         "resume on cpu"):
        snapshot.load_run(other, device="cpu")
    if not torch.cuda.is_available():   # the default device is CUDA
        with pytest.raises(RuntimeError, match="CUDA"):
            snapshot.load_run(path)
    with pytest.raises(ValueError, match="not a delphy-tpu-snapshot file"):
        convert.load_jax_snapshot(path, device="cpu")
    with pytest.raises(ValueError, match="not a delphy-tpu-torch-snapshot"):
        snapshot.load_run(pair[3], device="cpu")


@pytest.mark.parametrize("case", ["skygrid", "alpha", "mpox"])
def test_jax_snapshot_of_an_unported_model_raises(tmp_path, case):
    """These snapshots once raised "not ported"; now each loads into a port
    Run in the same state, with the same options, and its ledger recompute
    is the JAX run's (1e-8)."""
    from delphy_tpu.mcmc.global_moves import PriorConfig as JPriorConfig
    kw = {"skygrid": dict(pop_model="skygrid", skygrid_num_parameters=6),
          "alpha": dict(hyp=JPriorConfig(alpha_move_enabled=True)),
          "mpox": dict(mpox_hack=True)}[case]
    jrun = _jax_run(seed=61, L=80, **kw)
    path = tmp_path / "x.npz"
    jsnapshot.save_run(jrun, path)
    run = convert.load_jax_snapshot(path, device="cpu")
    assert run.hyp.alpha_move_enabled == (case == "alpha")
    assert run.mpox_hack == (case == "mpox")
    for f in run.evo._fields:
        np.testing.assert_array_equal(getattr(run.evo, f).numpy(),
                                      np.asarray(getattr(jrun.evo, f)), f)
    if case == "skygrid":
        assert run.pop.type == jrun.pop.type
        for f in ("x", "gamma", "tau"):
            np.testing.assert_array_equal(getattr(run.pop, f).numpy(),
                                          np.asarray(getattr(jrun.pop, f)))
    got, want = run.calc_cur_ledger(), jrun.calc_cur_ledger()
    for f in got._fields:
        assert float(getattr(got, f)) == pytest.approx(
            float(getattr(want, f)), abs=1e-8), f


def test_mcc_from_trees_tool(pair, tmp_path):
    from delphy_tpu import tools as jtools
    _jrun, run, trees, _path = pair
    trees_f = tmp_path / "run.trees"
    with open(trees_f, "w") as fh:
        out = beast_out.BeastTreesOutput(fh)
        out.write_preamble(trees[0])
        for i, t in enumerate(trees + trees):
            out.write_tree(t, 100 * i)
        out.write_epilog()
    got = tools.mcc_from_trees(trees_f, tmp_path / "a.nexus",
                               ref_len=run.ts.num_sites, burn_in=0.25)
    want = jtools.mcc_from_trees(trees_f, tmp_path / "b.nexus",
                                 ref_len=run.ts.num_sites, burn_in=0.25)
    np.testing.assert_array_equal(got.posterior_support,
                                  want.posterior_support)
    assert (tmp_path / "a.nexus").read_text() \
        == (tmp_path / "b.nexus").read_text()
    assert tools.main(["mcc", str(trees_f), str(tmp_path / "c.nexus")]) == 0
    assert "tree MCC =" in (tmp_path / "c.nexus").read_text()


def test_beast_trees_to_snapshot_tool(tmp_path):
    """BEAST .trees + sequences -> a snapshot that resumes on the port."""
    from delphy_tpu_torch.dates import to_iso_date
    from delphy_tpu_torch.io.fasta import TipData
    from delphy_tpu_torch.io.maple import write_maple
    ref, deltas, miss, dates, names, _ = sim.simulate_dataset(
        10, 120, mu=2e-3, missing_fraction=0.02, seed=17)
    tips = [TipData(name=f"s{i}|{to_iso_date(dates[i][0])}",
                    t_min=dates[i][0], t_max=dates[i][1], deltas=deltas[i],
                    miss_intervals=miss[i]) for i in range(10)]
    maple = tmp_path / "in.maple"
    write_maple(str(maple), "ref", ref, tips)
    from delphy_tpu_torch.phylo import build_random_tree as build
    tree = build(ref, deltas, miss, dates, names=[t.name for t in tips],
                 rng=np.random.default_rng(17))
    trees_f = tmp_path / "b.trees"
    with open(trees_f, "w") as fh:
        out = beast_out.BeastTreesOutput(fh)
        out.write_preamble(tree)
        out.write_tree(tree, 0)
        out.write_epilog()
    snap = tmp_path / "conv.npz"
    assert tools.main(["beast-to-snapshot", str(trees_f), str(snap),
                       "--in-maple", str(maple), "--device", "cpu"]) == 0
    run = snapshot.load_run(snap, device="cpu")
    assert run.ts.num_tips == 10
    run.do_mcmc_steps(2 * run.local_moves_per_global_move)
    run.check_derived_quantities(1e-6)
    label, _ = tools.beast_trees_to_snapshot(
        trees_f, tmp_path / "conv.dphy", in_maple=str(maple), device="cpu")
    assert len(dphy.read_dphy(tmp_path / "conv.dphy").samples) == 1
