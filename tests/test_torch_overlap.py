"""The port's overlapped driver against the JAX package's (delphy_tpu/run.py
_do_mcmc_steps_overlapped) on the CPU: the ports of tests/test_overlap.py
(production loop, mixing like the blocking driver, a skygrid cycle), the
host half of a cycle (A/B selection and merge) bit for bit against the JAX
driver with the device half made the identity in both (the port's through
the static buffers of its dispatch graphs), cycles through those buffers
bit for bit against the eager loop, the part-selected
sweep inputs against the reference's _boundary_body, the plain sweep on the
selected rows against sweep_chain_jnp, and the block cap of a skygrid
boundary (the reference's 512, not 64) against the JAX Run."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from delphy_tpu import state as jstate
from delphy_tpu.mcmc.moves import Ledger as JLedger
from delphy_tpu.parallel import block_pallas as jbp
from delphy_tpu.parallel import sweep as jsweep
from delphy_tpu.phylo import build_random_tree
from delphy_tpu.run import Run as JRun
from delphy_tpu.sim import simulate_dataset

from delphy_tpu_torch import convert
from delphy_tpu_torch import run as run_mod
from delphy_tpu_torch.mcmc.kernel import run_global_moves
from delphy_tpu_torch.mcmc.moves import Ledger
from delphy_tpu_torch.parallel import block_cuda as bc
from delphy_tpu_torch.parallel import sweep as sweep_mod
from delphy_tpu_torch.parallel import vsc_device
from delphy_tpu_torch.parallel.sweep import prepare_sweep, select_parts
from delphy_tpu_torch.run import Run


def _tree(seed, T=48, L=400):
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        T, L, mu=2e-3, missing_fraction=0.02, seed=seed)
    return build_random_tree(ref, deltas, miss, dates, names=names,
                             rng=np.random.default_rng(seed))


def make_run(seed=21, T=48, L=400, cls=Run, **kw):
    kw.setdefault("device_partitions", 8)
    if cls is Run:
        kw["device"] = "cpu"
    return cls(_tree(seed, T, L), seed=seed + 2, num_cells=64,
               local_moves_per_global_move=200,
               topology_moves_enabled=True, **kw)


@pytest.fixture
def overlap_env(monkeypatch):
    monkeypatch.setenv("DELPHY_TPU_OVERLAP", "1")


def test_overlap_gate(monkeypatch):
    """The reference's switch: auto is off at 200 local moves per boundary
    (the gate is 6M), 1 forces it on, 0 off."""
    run = make_run()
    monkeypatch.setenv("DELPHY_TPU_OVERLAP", "auto")
    assert not run._overlap_active()
    monkeypatch.setenv("DELPHY_TPU_OVERLAP", "1")
    assert run._overlap_active()
    monkeypatch.setenv("DELPHY_TPU_OVERLAP", "0")
    assert not run._overlap_active()
    run.local_moves_per_global_move = run_mod.OVERLAP_MIN_MOVES + 1
    monkeypatch.setenv("DELPHY_TPU_OVERLAP", "auto")
    assert run._overlap_active()


def test_overlap_production_loop(overlap_env):
    """Several overlapped cycles: the ledger, tree integrity and tip data
    survive, topology moves are proposed, every cycle sweeps and bursts,
    and the L-dispatch swept the selected half of the parts."""
    run = make_run()
    run.topology_burst_chunks = 2
    assert run._overlap_active()
    tip_seqs = [np.asarray(run._host_tree.sequence_at(i))
                for i in range(0, run._host_tree.num_tips, 7)]
    for _ in range(5):
        run.do_mcmc_steps(400)
        cyc = run.last_cycle
        assert cyc["boundaries"] == 2 and cyc["local_moves"] > 0
        assert cyc["selection_width"] == run.pm.node_map.shape[0] // 2
        assert cyc["parts_swept"] == min(cyc["selection_width"],
                                         cyc["parts_real"] - 1)
    assert run.topology_proposed > 0
    assert run.burst_count == 5 and run.dispatch_count == 10
    assert run.local_moves_attempted > 400  # sweeps + bursts both counted
    run.check_derived_quantities(1e-6)
    tree = run.tree()
    tree.check_integrity()
    for j, i in enumerate(range(0, tree.num_tips, 7)):
        np.testing.assert_array_equal(np.asarray(tree.sequence_at(i)),
                                      tip_seqs[j])


def test_overlap_mixes_like_blocking(monkeypatch):
    """Statistical smoke: overlapped and blocking drivers sample the same
    posterior (gross bias only: wrong boundary freezing, double-counted
    deltas)."""
    n = 1200
    lps = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("DELPHY_TPU_OVERLAP", mode)
        run = make_run(seed=5)
        run.topology_burst_chunks = 4
        run.do_mcmc_steps(n)
        lps[mode] = []
        for _ in range(16):
            run.do_mcmc_steps(n // 5)
            lps[mode].append(run.log_posterior)
        assert (run.last_cycle is not None) == (mode == "1")
    mo, mb = np.mean(lps["1"]), np.mean(lps["0"])
    s = max(np.std(lps["1"]), np.std(lps["0"]), 1.0)
    assert abs(mo - mb) < 6.0 * s, (mo, mb, s)


def test_overlap_skygrid_cycle(overlap_env):
    """The overlapped cycle under the skygrid (its host pop and
    HostCoalGrid refresh differ from the exponential model's)."""
    run = make_run(seed=9, T=32, L=300, pop_model="skygrid",
                   skygrid_num_parameters=8)
    run.topology_burst_chunks = 2
    assert run._overlap_active()
    for _ in range(3):
        run.do_mcmc_steps(400)
    assert run.topology_proposed > 0
    run.check_derived_quantities(1e-6)
    run.tree().check_integrity()


def test_overlap_equals_sequential_execution(overlap_env, monkeypatch):
    """An overlapped cycle equals the same cycle with every dispatch forced
    to finish before the host goes on (on the CPU the dispatch is
    synchronous anyway; tests/test_torch_cuda.py repeats this on the card,
    where it is not)."""
    runs = [make_run(seed=13) for _ in range(2)]
    for r in runs:
        r.topology_burst_chunks = 2
        r.do_mcmc_steps(800)
    runs[0].do_mcmc_steps(800)
    orig = run_mod.parts_multi_super_step

    def sequential(*a, **kw):
        out = orig(*a, **kw)
        for x in out[0]:
            x.cpu()
        return out
    monkeypatch.setattr(run_mod, "parts_multi_super_step", sequential)
    runs[1].do_mcmc_steps(800)
    a, b = runs
    assert float(a.ledger.log_G) == float(b.ledger.log_G)
    assert torch.equal(a.ts.t, b.ts.t) and torch.equal(a.ts.mut_t, b.ts.mut_t)
    assert torch.equal(a.gen.get_state(), b.gen.get_state())
    assert a.host_rng.bit_generator.state == b.host_rng.bit_generator.state


# ---------------------------------------------------------------------------
# The host half of a cycle against the JAX driver, bit for bit
# ---------------------------------------------------------------------------

LEDGER_L = (-1234.5, -56.25, 7.125)   # the identity device half's ledger


def _identity_jax(calls):
    def fake(ts, evo, pop, key, tin, tout, pm, n_blocks, t_max_tip, hyp,
             num_cells, n_boundaries, k_max, reform_batch, allow_pallas=True,
             mesh=None, param_moves=True, part_sel=None, nb_max=64):
        calls.append((param_moves, n_boundaries, n_blocks, nb_max,
                      None if part_sel is None else np.asarray(part_sel)))
        led = JLedger(*(jnp.float64(v) for v in LEDGER_L))
        stats = {"local_moves_attempted": jnp.int64(100 * n_boundaries)}
        return (ts, evo, pop, key, led, stats,
                jstate.fuse_for_host((ts, evo, pop)))
    return fake


def _identity_port(calls, monkeypatch):
    """The port's dispatch as the Run calls it on CUDA, through the static
    buffers of its graph cache (``sweep.graph_dispatch`` with the Run's
    ``graphs``), over an identity boundary."""
    def boundary(ts, evo, pop, gen, tin, tout, pm, n_blocks, t_max_tip,
                 hyp, num_cells, param_moves=True, part_sel=None, nb_max=64,
                 mesh=None):
        led = Ledger(*(torch.tensor(v, dtype=torch.float64)
                       for v in LEDGER_L))
        return ts, evo, pop, led, {"local_moves_attempted": torch.tensor(100)}
    monkeypatch.setattr(sweep_mod, "_boundary_body", boundary)

    def fake(ts, evo, pop, gen, tin, tout, pm, n_blocks, t_max_tip, hyp,
             num_cells, n_boundaries, param_moves=True, part_sel=None,
             nb_max=64, mesh=None, graphs=None):
        assert mesh is None and graphs is not None
        calls.append((param_moves, n_boundaries, n_blocks, nb_max,
                      None if part_sel is None else part_sel.numpy()))
        return sweep_mod.graph_dispatch(
            graphs, ts, evo, pop, gen, tin, tout, pm, n_blocks, t_max_tip,
            hyp, num_cells, n_boundaries, param_moves, part_sel, nb_max,
            mesh)
    return fake


@pytest.mark.parametrize("pop_model", ["exp", "skygrid"])
def test_overlap_host_half_matches_jax(overlap_env, monkeypatch, pop_model):
    """Same tree, seed and stencil, the same parameters, and a device half
    that returns its input state in both packages: two overlapped cycles
    make the same A/B selections, burst the same parts, and merge to the
    same tree, partition maps, ledger and host generator state, bit for
    bit.  The port's device half goes through its graph cache's static
    buffers: G's graph and L's, replayed by the second cycle."""
    kw = ({} if pop_model == "exp"
          else dict(pop_model="skygrid", skygrid_num_parameters=8))
    jrun = make_run(seed=19, cls=JRun, **kw)
    run = make_run(seed=19, **kw)
    # the same parameters to the bit (the packages compute q apart)
    run.evo = convert.evo_params_to_torch(jax.device_get(jrun.evo), "cpu")
    run.pop = (convert.exp_pop_to_torch(jax.device_get(jrun.pop), "cpu")
               if pop_model == "exp" else
               convert.skygrid_pop_to_torch(jax.device_get(jrun.pop), "cpu"))
    jcalls, pcalls = [], []
    monkeypatch.setattr(jsweep, "parts_multi_super_step",
                        _identity_jax(jcalls))
    monkeypatch.setattr(run_mod, "parts_multi_super_step",
                        _identity_port(pcalls, monkeypatch))
    for r in (jrun, run):
        r.topology_burst_chunks = 2
        assert r._overlap_active()
        r.do_mcmc_steps(800)                 # two cycles of 2 boundaries
    assert len(jcalls) == len(pcalls) == 4
    for jc, pc in zip(jcalls, pcalls):
        assert jc[:3] == pc[:3]
        if jc[4] is None:
            assert pc[4] is None
        else:
            np.testing.assert_array_equal(pc[4], jc[4])
    assert run.topology_proposed == jrun.topology_proposed > 0
    assert run.topology_accepted == jrun.topology_accepted
    assert run.host_rng.bit_generator.state == \
        jrun.host_rng.bit_generator.state
    assert run._last_cuts == jrun._last_cuts
    for name in ("log_G", "log_coal", "log_other"):
        assert float(getattr(run.ledger, name)) == \
            float(getattr(jrun.ledger, name)), name
    for f in jstate.TreeState._fields:
        np.testing.assert_array_equal(getattr(run.ts, f).numpy(),
                                      np.asarray(getattr(jrun.ts, f)),
                                      err_msg=f)
    pm_j = jax.device_get(jrun.pm)
    for f in pm_j._fields:
        np.testing.assert_array_equal(getattr(run.pm, f).numpy(),
                                      np.asarray(getattr(pm_j, f)),
                                      err_msg=f)
    assert run.local_moves_attempted == jrun.local_moves_attempted
    assert run._per_block_rate == jrun._per_block_rate
    caps = run._graphs.captures
    assert caps[0]["blocks"] == 0 and len(caps) <= 3
    assert run._graphs.replays == 6
    assert not np.array_equal(pcalls[1][4], pcalls[3][4])


def test_overlap_through_buffers_equals_eager(overlap_env, monkeypatch):
    """Two Runs of one seed, three overlapped cycles each: one through the
    static buffers of its graph cache (the dispatches the Run makes on
    CUDA, run as they are on the CPU), one through the eager loop.  The
    state, every parameter, the ledger, the generator states and each
    cycle's record are equal bit for bit; the ledger equals the
    recompute at 1e-9; G's graph and L's were captured once for each block
    count and replayed over the cycles' new selections."""
    from delphy_tpu_torch.state import _leaves
    runs, cycles = [], []
    orig = run_mod.parts_multi_super_step
    for buffers in (True, False):
        sels = []

        def dispatch(*a, graphs=None, **kw):
            assert graphs is not None
            if kw.get("part_sel") is not None:
                sels.append((a[7], kw["part_sel"].clone()))
            if buffers:
                return sweep_mod.graph_dispatch(graphs, *a, **kw)
            return orig(*a, **kw)
        monkeypatch.setattr(run_mod, "parts_multi_super_step", dispatch)
        run = make_run(seed=17)
        run.topology_burst_chunks = 2
        recs = []
        for _ in range(3):
            run.do_mcmc_steps(400)
            recs.append(dict(run.last_cycle))
        runs.append((run, sels))
        cycles.append(recs)
    (a, sels), (b, _sels) = runs
    for x, y in ((a.ts, b.ts), (a.evo, b.evo), (a.pop, b.pop),
                 (a.ledger, b.ledger)):
        assert all(torch.equal(p, q) for p, q in zip(_leaves(x),
                                                     _leaves(y)))
    assert torch.equal(a.gen.get_state(), b.gen.get_state())
    assert a.host_rng.bit_generator.state == b.host_rng.bit_generator.state
    assert a.local_moves_attempted == b.local_moves_attempted
    stages = ("enqueue_GL_s", "wait_G_s", "burst_s", "join_L_s", "merge_s")
    assert [{k: v for k, v in c.items() if k not in stages}
            for c in cycles[0]] == [
        {k: v for k, v in c.items() if k not in stages} for c in cycles[1]]
    a.check_derived_quantities(1e-9)
    a.tree().check_integrity()
    cache = a._graphs
    blocks = {nb for nb, _sel in sels}
    assert sorted(c["blocks"] for c in cache.captures) == sorted(
        {0} | blocks)
    assert cache.replays == sum(c["boundaries"] + 1 for c in cycles[0])
    assert len({tuple(sel.tolist()) for _nb, sel in sels}) > 1


# ---------------------------------------------------------------------------
# part_sel: the gathered sweep inputs and the plain sweep on them
# ---------------------------------------------------------------------------

_CTX_ROWS = {"par": "parent", "t_min": "t_min", "t_max": "t_max",
             "lam": "lam", "dlam": "dlam_miss", "mnode": "mut_node_loc",
             "mvalid": "mut_valid", "msingle": "mut_single",
             "slope": "slope", "b": "b", "part_root": "part_root",
             "is_run_root": "is_run_root", "n_leaves": "n_leaves",
             "n_nodes": "n_nodes"}


@pytest.fixture(scope="module")
def selected_boundary():
    """One locals-only boundary of the reference's _boundary_body with a
    part selection (its gathered sweep inputs captured where it hands them
    to the sweep), and the port's prepare_sweep on the same state with the
    reference's field draw and salt."""
    jrun = make_run(seed=29, cls=JRun, device_partitions=8)
    run = make_run(seed=29, device_partitions=8)
    P = jrun.pm.node_map.shape[0]
    n_real = len(jrun._last_cuts) + 1
    sel = np.full(P // 2, n_real, np.int32)
    pick = np.random.default_rng(3).permutation(n_real)[:min(P // 2,
                                                             n_real - 1)]
    sel[:len(pick)] = np.sort(pick)
    seen = {}
    mp = pytest.MonkeyPatch()
    orig_ctx = jsweep.build_part_ctx

    def build_ctx(pm, ts, caches, evo, b, salt=None):
        seen["b"], seen["salt"] = b, salt
        return orig_ctx(pm, ts, caches, evo, b, salt=salt)

    def sweep_deltas(pm, ctx, k_p, t_p, mut_t_p, keys, sh, *rest):
        seen.update(pm=pm, ctx=ctx, k_p=k_p, t_p=t_p, mut_t_p=mut_t_p, sh=sh)
        return (jnp.zeros_like(t_p), jnp.zeros_like(mut_t_p),
                jnp.float64(0), jnp.float64(0), jnp.int64(0))
    mp.setattr(jsweep, "build_part_ctx", build_ctx)
    mp.setattr(jsweep, "sweep_deltas", sweep_deltas)
    # the global moves compiled (the rest of the body runs eagerly)
    mp.setattr(jsweep, "run_global_moves", jax.jit(
        jsweep.run_global_moves, static_argnames=(
            "hyp", "num_cells", "allow_pallas", "param_moves")))
    try:
        jsweep._boundary_body(
            jrun.ts, jrun.evo, jrun.pop, jrun.key, jrun.tin, jrun.tout,
            jrun.pm, 4, jrun.t_max_tip, jrun.hyp, jrun.num_cells,
            jrun._sweep_k_max, jrun._sweep_reform_batch, allow_pallas=False,
            param_moves=False, part_sel=jnp.asarray(sel))
    finally:
        mp.undo()

    # the port on the same state, with the reference's fields and salt
    ts = convert.tree_state_to_torch(jax.device_get(jrun.ts), "cpu")
    evo = convert.evo_params_to_torch(jax.device_get(jrun.evo), "cpu")
    pop = convert.exp_pop_to_torch(jax.device_get(jrun.pop), "cpu")
    ts, evo, pop, grid, caches, _led, _st = run_global_moves(
        ts, evo, pop, run.gen, run.tin, run.tout, run.t_max_tip, run.hyp,
        run.num_cells, param_moves=False)
    fields = vsc_device.VscFields(A=torch.as_tensor(np.array(seen["sh"].A)),
                                  b=torch.as_tensor(np.array(seen["b"])),
                                  k_p=None)
    orig_port_ctx = sweep_mod.build_part_ctx
    mp.setattr(vsc_device, "sample_fields", lambda *a: fields)
    mp.setattr(sweep_mod, "build_part_ctx",
               lambda pm, ts, caches, evo, b, salt=None: orig_port_ctx(
                   pm, ts, caches, evo, b,
                   salt=torch.tensor(int(seen["salt"]))))
    try:
        got = prepare_sweep(ts, evo, pop, grid, caches, run.pm, run.gen,
                            run.t_max_tip, run.num_cells,
                            part_sel=torch.as_tensor(sel).long())
    finally:
        mp.undo()
    return dict(jax=seen, port=got, sel=sel, pm=run.pm)


def test_part_sel_gathers_match_jax(selected_boundary):
    """The rows the port packs for a part selection are the reference's
    gathered ctx, k_p, t_p, mut_t_p and part maps (ints exact, floats to
    1e-12: the two packages compute lambda and the slopes apart)."""
    j, (stat, ctx_arrs, shared, t_p, mut_t_p) = (selected_boundary["jax"],
                                                 selected_boundary["port"])
    sel = selected_boundary["sel"]
    ctx = j["ctx"]
    assert t_p.shape[0] == len(sel) == np.asarray(j["t_p"]).shape[0]
    for key, field in _CTX_ROWS.items():
        w = np.asarray(getattr(ctx, field))
        g = ctx_arrs[key].numpy().reshape(w.shape)
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0, err_msg=key)
    ch = np.asarray(ctx.children)
    for i, key in enumerate(("c0", "c1")):
        np.testing.assert_array_equal(
            ctx_arrs[key].numpy().reshape(ch.shape[:2]), ch[..., i])
    np.testing.assert_array_equal(t_p.numpy(), np.asarray(j["t_p"]))
    np.testing.assert_array_equal(mut_t_p.numpy(), np.asarray(j["mut_t_p"]))
    np.testing.assert_allclose(ctx_arrs["k_p"].numpy().reshape(t_p.shape[0],
                                                               -1),
                               np.asarray(j["k_p"]), rtol=0, atol=1e-12)
    pm_sel = select_parts(selected_boundary["pm"], torch.as_tensor(sel)
                          .long())
    for f in j["pm"]._fields:
        np.testing.assert_array_equal(getattr(pm_sel, f).numpy(),
                                      np.asarray(getattr(j["pm"], f)),
                                      err_msg=f)


def test_plain_sweep_on_selected_rows_matches_jax_twin(selected_boundary):
    """The port's plain chain on the reference's gathered rows (packed as
    the JAX chain's padded rows) against sweep_chain_jnp with the same
    uniforms.  Tolerance: the JAX twin's series expm1/log1p (relative error
    up to ~3e-10, tests/test_torch_kernels.py)."""
    j = selected_boundary["jax"]
    stat, ctx_arrs, shared = jbp.pack_chain_inputs(
        j["ctx"], j["sh"], jax.device_get(make_run(seed=29, cls=JRun).pop),
        j["k_p"], j["t_p"], j["mut_t_p"], cpb=16)
    P, NB = ctx_arrs["t"].shape[0], 12
    rng = np.random.default_rng(23)
    u_np = jbp.BlockUniforms(
        pri=rng.uniform(size=(P, NB, stat.NC)),
        prop=rng.uniform(size=(P, NB, stat.NC)),
        acc=rng.uniform(size=(P, NB, stat.NC)),
        ref_u=rng.uniform(size=(P, NB, stat.MC)),
        ref_acc=rng.uniform(size=(P, NB, stat.NC)),
        sc=rng.uniform(size=(P, NB, 128)),
        norm=rng.normal(size=(P, NB, 128)))
    want = jax.jit(jbp.sweep_chain_jnp, static_argnames=("stat",))(
        stat, NB, ctx_arrs, shared, jbp.BlockUniforms(*map(jnp.asarray,
                                                           u_np)))

    def T(x):
        a = np.asarray(x)
        return torch.as_tensor(a.astype(np.float64) if np.issubdtype(
            a.dtype, np.floating) else a.copy())
    got = bc.sweep_chain_torch(
        bc.ChainStatics(NC=stat.NC, MC=stat.MC, C=stat.C, C_real=stat.C_real,
                        cpb=stat.cpb), NB,
        {k: T(v) for k, v in ctx_arrs.items()},
        {k: T(v) for k, v in shared.items()}, bc.BlockUniforms(*map(T, u_np)))
    for n, g, w in zip(("t", "mut_t", "k_p", "dG", "dC", "cnt"), got, want):
        g, w = g.numpy().reshape(-1), np.asarray(w).reshape(-1)
        if n == "cnt":
            np.testing.assert_array_equal(g, w)
        elif n in ("t", "mut_t", "k_p"):
            np.testing.assert_allclose(g, w, atol=1e-8, rtol=0, err_msg=n)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-8, atol=1e-9, err_msg=n)
    assert got[5].sum() > 0


# ---------------------------------------------------------------------------
# C2: a skygrid boundary's block cap
# ---------------------------------------------------------------------------

def test_skygrid_boundary_attempts_the_cadence_like_jax(monkeypatch):
    """At 50,000 local moves per boundary a skygrid boundary needs more than
    64 blocks.  The port caps a skygrid dispatch at 512 blocks as the JAX
    Run does, so after three boundaries of moves-per-block feedback both
    attempt the same share of the moves asked for (at the 64-block cap the
    port attempted ~4,150 a boundary, a twelfth of them)."""
    monkeypatch.setenv("DELPHY_TPU_OVERLAP", "0")
    lm = 50_000
    per_boundary = {}
    for name, cls in (("port", Run), ("jax", JRun)):
        kw = dict(device="cpu") if cls is Run else {}
        r = cls(_tree(7, T=30, L=300), seed=7, num_cells=64,
                local_moves_per_global_move=lm, topology_moves_enabled=False,
                pop_model="skygrid", skygrid_num_parameters=8, **kw)
        got = []
        for _ in range(3):
            before = r.local_moves_attempted
            r.do_mcmc_steps(lm)
            got.append(r.local_moves_attempted - before)
        per_boundary[name] = got
    port, jx = per_boundary["port"][-1], per_boundary["jax"][-1]
    assert port > 0.5 * lm, per_boundary
    assert 0.8 * jx < port < 1.25 * jx, per_boundary


def test_snapshot_after_overlapped_cycle_resumes_exactly(overlap_env,
                                                         tmp_path):
    """A run saved after an overlapped cycle and loaded again continues the
    trajectory of the run that never stopped (the snapshot keeps the
    stencil the next cycle cuts the host tree with)."""
    from delphy_tpu_torch.io.snapshot import load_run, save_run
    run = make_run(seed=31)
    run.topology_burst_chunks = 2
    run.do_mcmc_steps(800)
    save_run(run, tmp_path / "ov.npz")
    loaded = load_run(tmp_path / "ov.npz", device="cpu")
    assert loaded._last_cuts == run._last_cuts
    for r in (run, loaded):
        r.do_mcmc_steps(800)
    assert run.log_posterior == loaded.log_posterior
    assert torch.equal(run.ts.t, loaded.ts.t)
    assert torch.equal(run.ts.mut_t, loaded.ts.mut_t)
    assert run.topology_proposed == loaded.topology_proposed
