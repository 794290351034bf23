"""The compiled dispatch (``delphy_tpu_torch/parallel/dispatch_graph.py``)
on the CPU, where no graph is captured:

- the four root gathers of the boundary, now one-element indices, give the
  bits of the 0-d index they replace, and the functions that hold them
  (``calc_Ttwiddle_a``, ``calc_Ttwiddle_l``, ``calc_Ttwiddle_beta_a``,
  ``boundary_grid_bounds``) match the JAX package's to 1e-12 in float64;
- the static buffers: the captured function run as it is (copy in, body,
  copy back, clone out) gives the eager loop's bits over 6 boundaries,
  through a burst's repacked tree;
- the cache key: equal for a repacked tree of the same capacities, apart
  for another block count, m_cap, mutation capacity, dtype or skygrid
  type; the least recently used graph dropped beyond MAX_GRAPHS; every
  dispatch copies all its inputs in;
- the model options (skygrid of each type, alpha/nu, mpox): through the
  same buffers, the eager loop's bits; the skygrid's autograd warm-up
  draws nothing and writes nothing; no boundary reads anything back to
  the host or copies from it;
- the launch tally: a capture's record counts once per replay;
- the overlapped driver and the mesh: two overlapped cycles' G and L
  dispatches through the same buffers give the eager loop's bits, a new
  selection of the same width replaying L's graph; the key separates the
  selection's width, ``param_moves`` and a mesh's size and rank; G, L and
  a mesh boundary make no host read;
- the rule: a dispatch on CUDA goes to the graph on every model option,
  with a part selection, globals only or under a mesh whose all-reduce
  stays on the card; a staged mesh (ranks sharing one card) or a CPU one
  to the eager loop.
"""

import dataclasses
import functools
import threading
import traceback

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from delphy_tpu import evo as jevo
from delphy_tpu import pop as jpop
from delphy_tpu import state as jstate
from delphy_tpu.mcmc import kernel as jkernel
from delphy_tpu.mcmc.global_moves import PriorConfig as JPriorConfig
from delphy_tpu.ops import likelihood as jlk

from delphy_tpu_torch import convert
from delphy_tpu_torch import pop as popm
from delphy_tpu_torch.init_tree import build_initial_tree
from delphy_tpu_torch.mcmc import kernel
from delphy_tpu_torch.mcmc.global_moves import PriorConfig
from delphy_tpu_torch.ops import likelihood as lk
from delphy_tpu_torch.parallel import _cuda
from delphy_tpu_torch.parallel import dispatch_graph as dg
from delphy_tpu_torch.parallel import sweep
from delphy_tpu_torch.parallel.distributed import PartMesh
from delphy_tpu_torch.phylo import build_random_tree
from delphy_tpu_torch.run import Run
from delphy_tpu_torch.sim import simulate_dataset
from delphy_tpu_torch.state import _leaves, pack_state, unpack_state

RTOL = 1e-12
NUM_CELLS = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the Runs' many tiny ops (several threads
    only slow them down beside other test workers on the same cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the four root gathers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both():
    """A simulated tree with missing data, the mpox hack's two partitions,
    random nu and rho = 0.4, in both packages."""
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        20, 300, mu=1e-3, sample_window_days=300.0, missing_fraction=0.05,
        seed=11)
    tree = build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(11))
    part = jevo.apobec_context_partition(tree.sequence_at(0))
    nu = np.random.default_rng(3).gamma(10.0, 0.1, 300)
    e_j = jevo.make_evo_params(300, mu=2e-3, kappa=1.7,
                               pi=np.array([0.3, 0.2, 0.24, 0.26]),
                               alpha=10.0, nu=nu,
                               part=part).with_mpox_rho(rho=0.4)
    ts_j = jstate.pack_state(tree)
    tin, tout = tree.euler_positions()
    return dict(tree=tree, ts_j=ts_j, e_j=e_j,
                ts=convert.tree_state_to_torch(ts_j, device="cpu"),
                e=convert.evo_params_to_torch(e_j, device="cpu"),
                tin_j=jnp.asarray(tin), tout_j=jnp.asarray(tout),
                tin=torch.as_tensor(np.asarray(tin)),
                tout=torch.as_tensor(np.asarray(tout)),
                t_max_tip=float(np.max(tree.t_max[:tree.num_tips])))


def _port_values(b):
    ts, e, tin, tout = b["ts"], b["e"], b["tin"], b["tout"]
    nucum = lk.calc_ref_state_prefix(ts, e)[1]
    t_lo, t_step = kernel.boundary_grid_bounds(ts, b["t_max_tip"], NUM_CELLS)
    return {
        "calc_Ttwiddle_a": lk.calc_Ttwiddle_a(ts, e, tin, tout, nucum),
        "calc_Ttwiddle_l": lk.calc_Ttwiddle_l(ts, e, tin, tout),
        "calc_Ttwiddle_beta_a": lk.calc_Ttwiddle_beta_a(
            ts, e, tin, tout, lk.calc_ref_state_prefix_beta(ts, e)),
        "boundary_grid_bounds": torch.stack([t_lo, t_step])}


SITES = ("calc_Ttwiddle_a", "calc_Ttwiddle_l", "calc_Ttwiddle_beta_a",
         "boundary_grid_bounds")


@pytest.mark.parametrize("name", SITES)
def test_root_gathers_give_the_0d_index_bits(both, name, monkeypatch):
    """Each repaired site against the code it replaced (a 0-d index
    tensor) on the same state: bit for bit, and of the same shape."""
    new = _port_values(both)[name]
    monkeypatch.setattr(lk, "_at_root",
                        lambda x, ts: x[ts.root.long()])
    if name == "boundary_grid_bounds":
        ts, t_max_tip = both["ts"], both["t_max_tip"]
        t_root = ts.t[ts.root.long()]
        span = torch.clamp(t_max_tip - t_root, min=1.0)
        t_lo = t_root - 0.35 * span - 1.0
        old = torch.stack([t_lo, (t_max_tip - t_lo) / NUM_CELLS])
    else:
        old = _port_values(both)[name]
    assert new.shape == old.shape
    assert torch.equal(new, old)


@pytest.fixture(scope="module")
def jax_values(both):
    b = both
    pop_j = jpop.ExpPopParams(t0=b["t_max_tip"], n0=300.0, g=0.002,
                              min_pop=1.0)

    def values(ts, e, tin, tout):
        nucum = jlk.calc_ref_state_prefix(ts, e)[1]
        grid = jkernel.run_global_moves(
            ts, e, pop_j, jax.random.PRNGKey(0), tin, tout, b["t_max_tip"],
            JPriorConfig(), NUM_CELLS, allow_pallas=False,
            param_moves=False)[3]
        return {
            "calc_Ttwiddle_a": jlk.calc_Ttwiddle_a(ts, e, tin, tout, nucum),
            "calc_Ttwiddle_l": jlk.calc_Ttwiddle_l(ts, e, tin, tout),
            "calc_Ttwiddle_beta_a": jlk.calc_Ttwiddle_beta_a(
                ts, e, tin, tout, jlk.calc_ref_state_prefix_beta(ts, e)),
            "boundary_grid_bounds": jnp.stack([grid.t_lo, grid.t_step])}
    return jax.jit(values)(b["ts_j"], b["e_j"], b["tin_j"], b["tout_j"])


@pytest.mark.parametrize("name", SITES)
def test_repaired_functions_match_jax(both, jax_values, name):
    got = _port_values(both)[name].numpy()
    want = np.asarray(jax_values[name])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL)


# ---------------------------------------------------------------------------
# static buffers, the cache key, the tally and the rule
# ---------------------------------------------------------------------------

def _tree(seed=5, T=24, L=300):
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        T, L, mu=2e-3, missing_fraction=0.02, seed=seed)
    return build_random_tree(ref, deltas, miss, dates, names=names,
                             rng=np.random.default_rng(seed))


def _run(dtype=torch.float64, **kw):
    run = Run(_tree(), seed=7, num_cells=NUM_CELLS, device_partitions=4,
              local_moves_per_global_move=200, device="cpu", dtype=dtype,
              **kw)
    run.do_mcmc_steps(400)
    return run


# the model options as Run arguments
OPTIONS = {
    "skygrid staircase": {"pop_model": "skygrid"},
    "skygrid log-linear": {"pop_model": "skygrid",
                           "skygrid_type": popm.LOG_LINEAR},
    "alpha/nu": {"hyp": PriorConfig(alpha_move_enabled=True)},
    "mpox": {"mpox_hack": True},
}


def _args(run, n_blocks=3):
    return (run.ts, run.evo, run.pop, run.gen, run.tin, run.tout, run.pm,
            n_blocks, run.t_max_tip, run.hyp, run.num_cells)


def _repack(run, ts):
    """``ts`` packed again at the run's capacities: new tensors of the
    same shapes (a burst that moved nothing)."""
    return pack_state(unpack_state(ts, names=run.names), run.mut_capacity,
                      run.miss_capacity, run.fs_capacity, device="cpu",
                      dtype=run.dtype)


def _assert_same(a, b):
    la, lb = _leaves(a[:4]), _leaves(b[:4])
    assert len(la) == len(lb)
    assert all(x.shape == y.shape and x.dtype == y.dtype
               and torch.equal(x, y) for x, y in zip(la, lb))
    assert list(a[4]) == list(b[4])
    assert all(torch.equal(a[4][k], b[4][k]) for k in a[4])
    assert all(torch.equal(x, y) for x, y in zip(a[5], b[5]))


def test_static_buffers_give_the_loops_bits():
    """Two dispatches of 3 boundaries through a cache's buffers, the
    second on a burst's repacked tree and the first dispatch's evo and
    pop, against the eager loop from the same generator state: state,
    ledger, stats (local_moves_attempted too), host bundle and generator
    state bit for bit, with one entry in the cache."""
    run = _run()
    start = run.gen.get_state()
    rest = (run.gen, run.tin, run.tout, run.pm, 3, run.t_max_tip, run.hyp,
            run.num_cells, 3)
    a1 = sweep.parts_multi_super_step(run.ts, run.evo, run.pop, *rest)
    a2 = sweep.parts_multi_super_step(_repack(run, a1[0]), a1[1], a1[2],
                                      *rest)
    end = run.gen.get_state()
    run.gen.set_state(start)
    cache = dg.DispatchGraphs()
    b1 = sweep.graph_dispatch(cache, run.ts, run.evo, run.pop, *rest)
    _assert_same(a1, b1)
    b2 = sweep.graph_dispatch(cache, _repack(run, b1[0]), b1[1], b1[2],
                              *rest)
    _assert_same(a2, b2)
    assert torch.equal(run.gen.get_state(), end)
    assert int(b1[4]["local_moves_attempted"]) > 0
    assert len(cache.captures) == len(cache.graphs) == 1
    assert cache.replays == 6
    # the hand-off never aliases a buffer
    bufs = next(iter(cache.buffers.values()))
    ptrs = {b.untyped_storage().data_ptr() for b in bufs.leaves}
    assert not any(x.untyped_storage().data_ptr() in ptrs
                   for x in _leaves(b2[:4]) + list(b2[4].values()))


def test_cache_key(monkeypatch):
    """A repacked tree of the same capacities replays the first entry;
    another block count, m_cap, mutation capacity or dtype makes another."""
    monkeypatch.setattr(dg, "MAX_GRAPHS", 8)
    run = _run()
    cache = dg.DispatchGraphs()

    def dispatch(run, ts=None, n_blocks=3):
        sweep.graph_dispatch(cache, ts if ts is not None else run.ts,
                             run.evo, run.pop, run.gen, run.tin, run.tout,
                             run.pm, n_blocks, run.t_max_tip, run.hyp,
                             run.num_cells, 1)
        return len(cache.captures)

    assert dispatch(run) == 1
    assert dispatch(run, ts=_repack(run, run.ts)) == 1
    assert dispatch(run, n_blocks=4) == 2
    assert dispatch(run) == 2
    m_cap = run.pm.mut_map.shape[1]
    run._m_cap_sticky = m_cap + 16
    run._repartition()
    assert run.pm.mut_map.shape[1] == m_cap + 16
    assert dispatch(run) == 3
    run.mut_capacity += 128
    assert dispatch(run, ts=_repack(run, run.ts)) == 4
    assert dispatch(_run(torch.float32)) == 5
    assert len(set(cache.graphs)) == 5
    assert [c["blocks"] for c in cache.captures] == [3, 4, 3, 3, 3]
    assert cache.dispatches == {3: 6, 4: 1}


def test_cache_key_separates_skygrid_types():
    """Two skygrid dispatches of the same shapes and another type make two
    entries: the capture bakes the type in (``skygrid_log_N``'s code and
    the sweep's build), and it lives in the pytree's static part, not in
    a leaf."""
    run = _run(**OPTIONS["skygrid staircase"])
    log_linear = dataclasses.replace(run.pop, type=popm.LOG_LINEAR)
    assert ([(x.shape, x.dtype) for x in _leaves(run.pop)]
            == [(x.shape, x.dtype) for x in _leaves(log_linear)])
    cache = dg.DispatchGraphs()
    for pop in (run.pop, log_linear, run.pop):
        sweep.graph_dispatch(cache, run.ts, run.evo, pop, run.gen, run.tin,
                             run.tout, run.pm, 2, run.t_max_tip, run.hyp,
                             run.num_cells, 1, nb_max=run._nb_cap())
    assert len(cache.captures) == len(cache.graphs) == 2
    assert cache.replays == 3


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_buffers_give_the_loops_bits(option, monkeypatch):
    """Each model option through a cache's buffers, two dispatches of 2
    boundaries (the second on a burst's repacked tree), against the eager
    loop from the same generator state: state, ledger, stats, host bundle
    and generator state bit for bit, one entry, and the HMC's warm-up run
    once before the capture on a skygrid only."""
    run = _run(**OPTIONS[option])
    warm = []
    orig = kernel.skygrid_hmc_warm_up
    monkeypatch.setattr(sweep, "skygrid_hmc_warm_up",
                        lambda *a: warm.append(orig(*a)))
    start = run.gen.get_state()
    rest = (run.gen, run.tin, run.tout, run.pm, 3, run.t_max_tip, run.hyp,
            run.num_cells, 2)
    kw = {"nb_max": run._nb_cap()}
    a1 = sweep.parts_multi_super_step(run.ts, run.evo, run.pop, *rest, **kw)
    a2 = sweep.parts_multi_super_step(_repack(run, a1[0]), a1[1], a1[2],
                                      *rest, **kw)
    end = run.gen.get_state()
    assert not warm
    run.gen.set_state(start)
    cache = dg.DispatchGraphs()
    b1 = sweep.graph_dispatch(cache, run.ts, run.evo, run.pop, *rest, **kw)
    _assert_same(a1, b1)
    b2 = sweep.graph_dispatch(cache, _repack(run, b1[0]), b1[1], b1[2],
                              *rest, **kw)
    _assert_same(a2, b2)
    assert torch.equal(run.gen.get_state(), end)
    assert int(b2[4]["local_moves_attempted"]) > 0
    assert len(cache.captures) == 1 and cache.replays == 4
    assert len(warm) == (1 if option.startswith("skygrid") else 0)


@pytest.mark.parametrize("option", ["skygrid staircase",
                                    "skygrid log-linear"])
def test_skygrid_warm_up_draws_and_writes_nothing(option):
    """The warm-up before a skygrid capture: the run's and the default
    generator's states and every input as they were, and a force was
    taken (autograd ran)."""
    run = _run(**OPTIONS[option])
    inputs = (run.ts, run.evo, run.pop, run.tin, run.tout, run.pm)
    before = [x.clone() for x in _leaves(inputs)]
    gen, default = run.gen.get_state(), torch.get_rng_state()
    calls = []
    orig = kernel.gm.grad_of

    def grad_of(U, gamma):
        calls.append(orig(U, gamma))
        return calls[-1]
    try:
        kernel.gm.grad_of = grad_of
        kernel.skygrid_hmc_warm_up(run.ts, run.pop, run.t_max_tip, run.hyp,
                                   run.num_cells)
    finally:
        kernel.gm.grad_of = orig
    assert torch.equal(run.gen.get_state(), gen)
    assert torch.equal(torch.get_rng_state(), default)
    assert all(torch.equal(x, y) for x, y in zip(_leaves(inputs), before))
    assert len(calls) == 1 and calls[0].shape == run.pop.gamma.shape
    assert bool(torch.all(torch.isfinite(calls[0])))
    assert not calls[0].requires_grad


class _HostReads(TorchDispatchMode):
    """The operations that, on CUDA tensors, read back to the host
    (``.item()`` and 0-d index tensors) or copy from it (a tensor made
    from Python data), each with the line of the port that made it.
    ``F.one_hot`` reads its input's range back on the CPU only (on the
    card the range check is the device's): its reads are not kept."""

    READS = {"_local_scalar_dense", "lift_fresh", "lift_fresh_copy"}

    def __init__(self):
        super().__init__()
        self.where = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] in self.READS:
            stack = traceback.extract_stack()
            if not any("one_hot(" in (f.line or "") for f in stack):
                port = [f for f in stack if "delphy_tpu_torch" in f.filename]
                self.where.append(f"{port[-1].filename}:{port[-1].lineno}"
                                  if port else "?")
        return func(*args, **(kwargs or {}))


def test_host_reads_are_seen():
    """The detector itself: a 0-d index tensor and a tensor made from a
    list are reads; ``F.one_hot``'s CPU range check and ``torch.full``
    are not."""
    x = torch.arange(5.0)
    with _HostReads() as seen:
        x[torch.tensor(2)]
        torch.nn.functional.one_hot(torch.arange(3), 4)
        torch.full((), 2.5)
    assert len(seen.where) == 2


@pytest.mark.parametrize("option", ["main path"] + list(OPTIONS))
def test_boundaries_read_nothing_back(option):
    """One boundary of each model option (and of the main path) makes no
    host read and no host copy: a capture would fail at the first (the
    kernels' wrappers take their plain versions here, which make
    none either)."""
    run = _run(**OPTIONS.get(option, {}))
    with _HostReads() as seen:
        sweep._boundary_body(run.ts, run.evo, run.pop, run.gen, run.tin,
                             run.tout, run.pm, 2, run.t_max_tip, run.hyp,
                             run.num_cells, nb_max=run._nb_cap())
    assert seen.where == []


def test_cache_drops_the_least_recently_used(monkeypatch):
    """MAX_GRAPHS, read at each capture, bounds the graphs kept; a count
    above nb_max is nb_max's."""
    monkeypatch.setattr(dg, "MAX_GRAPHS", 2)
    run = _run()
    cache = dg.DispatchGraphs()
    for nb in (1, 2, 1, 3, 6):
        sweep.graph_dispatch(cache, run.ts, run.evo, run.pop, run.gen,
                             run.tin, run.tout, run.pm, nb, run.t_max_tip,
                             run.hyp, run.num_cells, 1, nb_max=4)
    assert [k[1] for k in cache.graphs] == [3, 4]
    assert [c["blocks"] for c in cache.captures] == [1, 2, 3, 4]
    assert len(cache.buffers) == 1 and cache.replays == 5


def test_buffers_take_writes_the_version_counter_misses():
    """Every dispatch copies its inputs in: a write through ``.data``
    (which leaves the tensor's version as it was) between two dispatches
    of the same tensors reaches the second, which gives the eager loop's
    bits on the written inputs."""
    run = _run()
    cache = dg.DispatchGraphs()
    rest = (run.gen, run.tin, run.tout, run.pm, 3, run.t_max_tip, run.hyp,
            run.num_cells, 2)
    sweep.graph_dispatch(cache, run.ts, run.evo, run.pop, *rest)
    version = run.evo.mu._version
    run.evo.mu.data.mul_(3.0)
    assert run.evo.mu._version == version
    start = run.gen.get_state()
    b = sweep.graph_dispatch(cache, run.ts, run.evo, run.pop, *rest)
    run.gen.set_state(start)
    a = sweep.parts_multi_super_step(run.ts, run.evo, run.pop, *rest)
    _assert_same(a, b)
    assert len(cache.captures) == 1


def test_tally_counts_a_capture_once_per_replay():
    """Launch counts under a fake capture: recorded, not counted (also not
    another thread's), then each replay adds the record."""
    _cuda.reset_launch_counts()
    with _cuda.recording() as rec:
        _cuda.count_launch("sweep_chain", 8)
        _cuda.count_launch("hky_chain")
        other = threading.Thread(
            target=lambda: _cuda.count_launch("exp_pop_chain"))
        other.start()
        other.join()
    assert rec == [("sweep_chain", 8), ("hky_chain", 1)]
    assert _cuda.launch_counts["exp_pop_chain"] == 1
    assert _cuda.launch_counts["sweep_chain"] == 0
    _cuda.tally(rec, 3)
    _cuda.tally(rec)
    assert _cuda.launch_counts["sweep_chain"] == 4
    assert _cuda.launch_blocks["sweep_chain"] == 32
    assert _cuda.launch_counts["hky_chain"] == 4
    assert _cuda.graph_replays == 4
    assert sum(_cuda.launch_counts.values()) == 9
    _cuda.reset_launch_counts()
    assert _cuda.graph_replays == 0
    assert not any(_cuda.launch_counts.values())


def _pop(kind):
    f = functools.partial(torch.tensor, dtype=torch.float64)
    if kind.startswith("skygrid"):
        return popm.SkygridPopParams(
            x=torch.arange(3.0), gamma=f([1.0] * 3),
            type=popm.LOG_LINEAR if kind.endswith("log-linear")
            else popm.STAIRCASE, tau=f(1.0))
    return popm.ExpPopParams(t0=f(0.0), n0=f(1000.0), g=f(0.0),
                             min_pop=f(1.0))


RULE_CASES = {
    "main path": ({}, True),
    "on the CPU": ({"device": "cpu"}, False),
    "skygrid": ({"pop": "skygrid"}, True),
    "skygrid log-linear": ({"pop": "skygrid log-linear"}, True),
    "alpha/nu": ({"hyp": PriorConfig(alpha_move_enabled=True)}, True),
    "mpox": ({"hyp": PriorConfig(mpox_enabled=True)}, True),
    "part_sel": ({"part_sel": torch.arange(2)}, True),
    # ranks on cards of their own: the all-reduce goes over NCCL on the card
    "mesh": ({"mesh": PartMesh(size=2, rank=1, group=None,
                               device=torch.device("cuda", 1))}, True),
    "globals only": ({"n_blocks": 0}, True),
    # ranks sharing one card: the all-reduce copies through the host
    "staged mesh": ({"mesh": PartMesh(size=2, rank=1, group=None,
                                      device=torch.device("cuda", 0),
                                      staged=True)}, False),
    "staged mesh, on the CPU": ({"device": "cpu", "mesh": PartMesh(
        size=2, rank=1, group=None, device=torch.device("cpu"))}, False),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_graph_rule(case):
    kw, want = RULE_CASES[case]
    args = dict(device="cuda", pop="exp", hyp=PriorConfig(), n_blocks=24,
                part_sel=None, mesh=None)
    args.update(kw)
    assert dg.graph_rule(torch.device(args["device"]), _pop(args["pop"]),
                         args["hyp"], args["n_blocks"], args["part_sel"],
                         args["mesh"]) is want


def test_cpu_dispatch_runs_the_eager_loop(monkeypatch):
    """On the CPU parts_multi_super_step never reaches a graph cache."""
    run = _run()

    def refuse(*a, **kw):
        raise AssertionError("a CPU dispatch reached the graph cache")
    monkeypatch.setattr(dg.DispatchGraphs, "dispatch", refuse)
    out = sweep.parts_multi_super_step(*_args(run), 2)
    assert int(out[4]["local_moves_attempted"]) > 0


# ---------------------------------------------------------------------------
# the overlapped driver's G and L dispatches, and the mesh
# ---------------------------------------------------------------------------

class _LoneMesh(PartMesh):
    """A mesh rank without a group: its all-reduce returns its own buffer
    (what a rank contributes; the sum over the ranks is
    tests/test_torch_mesh.py's)."""

    def all_reduce_sum(self, buf):
        return buf


def _lone(size, rank):
    return _LoneMesh(size=size, rank=rank, group=None,
                     device=torch.device("cpu"))


def _selection(run, rows):
    """An L-dispatch's selection of half the part axis: ``rows`` and pad
    rows (index n_real, where the axis has them) after them."""
    W = run.pm.node_map.shape[0] // 2
    n_real = len(run._last_cuts) + 1
    sel = torch.full((W,), n_real, dtype=torch.long)
    sel[:len(rows)] = torch.as_tensor(rows)
    return sel


def _cycles(dispatch, run, selections):
    """The overlapped driver's dispatches for each selection: G (one
    globals-only boundary), then L (2 boundaries of 3 blocks over the
    selected rows, no parameter moves) on G's state, each cycle on the
    last's; returns every dispatch's output."""
    outs, (ts, evo, pop) = [], (run.ts, run.evo, run.pop)
    for sel in selections:
        g = dispatch(ts, evo, pop, run.gen, run.tin, run.tout, run.pm, 0,
                     run.t_max_tip, run.hyp, run.num_cells, 1,
                     param_moves=True)
        out = dispatch(g[0], g[1], g[2], run.gen, run.tin, run.tout, run.pm,
                       3, run.t_max_tip, run.hyp, run.num_cells, 2,
                       param_moves=False, part_sel=sel,
                       nb_max=run._nb_cap(overlapped=True))
        outs += [g, out]
        ts, evo, pop = out[:3]
    return outs


@pytest.mark.parametrize("option", ["main path", "skygrid staircase"])
def test_overlapped_buffers_give_the_loops_bits(option, monkeypatch):
    """Two overlapped cycles' G and L dispatches through a cache's buffers
    against the eager loop from the same generator state: every output
    and the generator state bit for bit; one G and one L graph, the
    second cycle's other selection of the same width copied into L's
    buffer and replayed without a capture; the skygrid's warm-up before
    G's capture only."""
    run = _run(**OPTIONS.get(option, {}))
    warm = []
    orig = kernel.skygrid_hmc_warm_up
    monkeypatch.setattr(sweep, "skygrid_hmc_warm_up",
                        lambda *a: warm.append(orig(*a)))
    n_real = len(run._last_cuts) + 1
    assert n_real >= 3 and run.pm.node_map.shape[0] == 4
    sels = [_selection(run, [0, n_real - 1]), _selection(run, [1, 2])]
    start = run.gen.get_state()
    want = _cycles(sweep.parts_multi_super_step, run, sels)
    end = run.gen.get_state()
    run.gen.set_state(start)
    cache = dg.DispatchGraphs()
    got = _cycles(functools.partial(sweep.graph_dispatch, cache), run, sels)
    for a, b in zip(want, got):
        _assert_same(a, b)
    assert torch.equal(run.gen.get_state(), end)
    assert not torch.equal(want[1][0].t, want[0][0].t)
    assert int(got[3][4]["local_moves_attempted"]) > 0
    assert int(got[2][4]["local_moves_attempted"]) == 0
    assert [c["blocks"] for c in cache.captures] == [0, 3]
    assert cache.replays == 6 and cache.dispatches == {0: 2, 3: 2}
    assert len(warm) == (1 if option.startswith("skygrid") else 0)


def test_cache_key_separates_overlap_and_mesh(monkeypatch):
    """The key separates ``param_moves``, the globals-only boundary, the
    selection's width and a mesh's size and rank; a new selection of the
    same width, or the same mesh again, replays."""
    monkeypatch.setattr(dg, "MAX_GRAPHS", 16)
    run = _run()
    cache = dg.DispatchGraphs()

    def dispatch(n_blocks=3, **kw):
        sweep.graph_dispatch(cache, run.ts, run.evo, run.pop, run.gen,
                             run.tin, run.tout, run.pm, n_blocks,
                             run.t_max_tip, run.hyp, run.num_cells, 1, **kw)
        return len(cache.captures)

    assert dispatch() == 1
    assert dispatch(param_moves=False) == 2
    assert dispatch(n_blocks=0) == 3
    assert dispatch(param_moves=False, part_sel=torch.tensor([0, 2])) == 4
    assert dispatch(param_moves=False, part_sel=torch.tensor([3, 1])) == 4
    assert dispatch(param_moves=False, part_sel=torch.tensor([0, 1, 2])) == 5
    assert dispatch(mesh=_lone(2, 0)) == 6
    assert dispatch(mesh=_lone(2, 1)) == 7
    assert dispatch(mesh=_lone(4, 1)) == 8
    assert dispatch(mesh=_lone(2, 1)) == 8
    assert len(cache.graphs) == 8
    # the selections share one buffer set, apart from the unselected one
    assert len(cache.buffers) == 3


BOUNDARIES = {
    "G": {"n_blocks": 0},
    "L": {"param_moves": False, "sel": True},
    "mesh": {"mesh": True},
    "mesh, L": {"param_moves": False, "sel": True, "mesh": True},
    "mesh, G": {"n_blocks": 0, "mesh": True},
}


@pytest.mark.parametrize("kind", list(BOUNDARIES))
def test_overlap_and_mesh_boundaries_read_nothing_back(kind):
    """The overlapped driver's G and L boundaries and a mesh rank's (its
    all-reduce stood in for) make no host read and no host copy."""
    run = _run()
    kw = dict(BOUNDARIES[kind])
    n_blocks = kw.pop("n_blocks", 2)
    if kw.pop("sel", False):
        kw["part_sel"] = _selection(run, [0, 1])
    if kw.pop("mesh", False):
        kw["mesh"] = _lone(2, 1)
    with _HostReads() as seen:
        out = sweep._boundary_body(
            run.ts, run.evo, run.pop, run.gen, run.tin, run.tout, run.pm,
            n_blocks, run.t_max_tip, run.hyp, run.num_cells,
            nb_max=run._nb_cap(overlapped=True), **kw)
    assert seen.where == []
    assert (int(out[4]["local_moves_attempted"]) > 0) == (n_blocks > 0)
