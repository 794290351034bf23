"""The compiled form of the JAX package's last jitted programs on the CPU,
where no graph is captured: the unpartitioned ``multi_super_step`` and
``super_step`` (``delphy_tpu_torch/mcmc/kernel.py``) as replays of one
boundary, and the device SPR sweeps (``ops/spr_move.py`` ``_sweeps``:
``spr1_sweep``, ``spr1_sweep_lanes``, ``slide_sweep``; ``ops/spr_miss.py``
``spr1_sweep_miss``, ``spr1_sweep_miss_lanes``) as replays of one move,
each through the static buffers of ``parallel/dispatch_graph.py`` with
``captures_on`` set for the CPU (the body runs as it is at each replay):

- ``multi_super_step`` through the buffers equals its ``_eager`` loop and
  K ``super_step`` calls, on the exponential model and a skygrid: state,
  ledger, move count and generator state bit for bit;
- the free functions' cache keys on the generator object: two generators
  on the same inputs capture two graphs, each replaying its own stream;
- one ``super_step`` boundary and one move of ``spr1_core``,
  ``slide_core`` and ``spr1_miss_core`` make no host read or host copy;
- each SPR sweep through the buffers equals the eager ``_sweeps`` bit for
  bit (trees, counts, delta_log_G, generator state and the recorded
  draws), also with exhaustion forced by a low ``history.ATTEMPTS``, where
  lanes rerun from their first tree and the widened moves run eagerly;
- the rule (CUDA only), the per-thread caches and their ``clear``, the
  move graphs' key (one graph a core and shape, which the lanes share,
  whatever their count) and the copy-back's refusal of an aliased carry.

Each test runs on caches of its own: ``dispatch_graph._THREAD`` is
replaced by a fresh ``threading.local()``.
"""

import threading

import numpy as np
import pytest
import torch

from test_torch_dispatch_graph import _HostReads

from delphy_tpu_torch.evo import make_evo_params
from delphy_tpu_torch.mcmc import kernel
from delphy_tpu_torch.ops import history as hh
from delphy_tpu_torch.ops import spr_miss as pm
from delphy_tpu_torch.ops import spr_move as sm
from delphy_tpu_torch.parallel import dispatch_graph as dg
from delphy_tpu_torch.phylo import (build_random_tree,
                                    rereference_to_root_sequence)
from delphy_tpu_torch.run import Run
from delphy_tpu_torch.sim import simulate_dataset
from delphy_tpu_torch.state import _leaves

NUM_CELLS = 64
LOCAL_MOVES = 300


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _own_caches(monkeypatch):
    """This test's thread caches, apart from any other test's."""
    monkeypatch.setattr(dg, "_THREAD", threading.local())


@pytest.fixture
def graphs_here(monkeypatch):
    """The graph paths taken on the CPU: through the buffers, no capture."""
    monkeypatch.setattr(dg, "captures_on", lambda device: True)


# ---------------------------------------------------------------------------
# the unpartitioned step
# ---------------------------------------------------------------------------

POPS = {"exponential": {}, "skygrid staircase": {"pop_model": "skygrid"}}


def _run(pop):
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        16, 300, mu=2e-3, missing_fraction=0.02, seed=5)
    tree = build_random_tree(ref, deltas, miss, dates, names=names,
                             rng=np.random.default_rng(5))
    return Run(tree, seed=7, num_cells=NUM_CELLS, device="cpu",
               **POPS[pop])


def _step_args(run):
    return (run.tin, run.tout, LOCAL_MOVES, run.t_max_tip, run.hyp,
            run.num_cells)


def _same_step(a, b):
    la, lb = _leaves(a[:4]), _leaves(b[:4])
    assert len(la) == len(lb)
    assert all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(la, lb))
    assert list(a[4]) == list(b[4])
    assert all(a[4][k].dtype == b[4][k].dtype and torch.equal(a[4][k],
                                                              b[4][k])
               for k in a[4])


@pytest.mark.parametrize("pop", list(POPS))
def test_multi_super_step_buffers_give_the_loops_bits(pop, graphs_here,
                                                      monkeypatch):
    """3 boundaries of multi_super_step through a cache's buffers, its
    _eager loop and 3 super_step calls through the same cache, from one
    generator state: state, ledger, stats (the summed move count too) and
    generator state bit for bit; one graph, 6 replays, and on a skygrid
    the HMC's warm-up once before the capture."""
    run = _run(pop)
    warm = []
    orig = kernel.skygrid_hmc_warm_up
    monkeypatch.setattr(kernel, "skygrid_hmc_warm_up",
                        lambda *a: warm.append(orig(*a)))
    start = run.gen.get_state()
    want = kernel.multi_super_step(run.ts, run.evo, run.pop, run.gen,
                                   *_step_args(run), 3, _eager=True)
    end = run.gen.get_state()
    assert not warm
    run.gen.set_state(start)
    got = kernel.multi_super_step(run.ts, run.evo, run.pop, run.gen,
                                  *_step_args(run), 3)
    _same_step(want, got)
    assert torch.equal(run.gen.get_state(), end)
    run.gen.set_state(start)
    state, total = (run.ts, run.evo, run.pop), 0
    for _ in range(3):
        *state, ledger, stats = kernel.super_step(*state, run.gen,
                                                  *_step_args(run))
        total += int(stats["local_moves_attempted"])
    _same_step(want, (*state, ledger, dict(
        stats, local_moves_attempted=torch.tensor(total))))
    assert torch.equal(run.gen.get_state(), end)
    assert total > 0
    n_blocks, _ = kernel.sweep_shape(LOCAL_MOVES, NUM_CELLS)
    cache = dg.thread_cache(dg.DispatchGraphs)
    assert [c["blocks"] for c in cache.captures] == [n_blocks]
    assert cache.replays == 6 and cache.dispatches == {n_blocks: 4}
    assert len(warm) == (1 if pop.startswith("skygrid") else 0)


def test_step_cache_keys_on_the_generator(graphs_here):
    """Two generators on the same inputs: two graphs, each call equal to
    the eager loop on its own generator (a graph replayed on another
    generator would draw the first one's stream), each generator advanced
    by its own call only; the same generator again replays."""
    run = _run("exponential")
    gens = [torch.Generator().manual_seed(s) for s in (11, 12)]
    starts = [g.get_state() for g in gens]
    inputs = (run.ts, run.evo, run.pop)
    want = []
    for g in gens:
        want.append(kernel.multi_super_step(*inputs, g, *_step_args(run),
                                            2, _eager=True))
        want.append(g.get_state())
    for g, s in zip(gens, starts):
        g.set_state(s)
    got = []
    for g in gens:
        got.append(kernel.multi_super_step(*inputs, g, *_step_args(run), 2))
        got.append(g.get_state())
    cache = dg.thread_cache(dg.DispatchGraphs)
    for a, b in ((want[0], got[0]), (want[2], got[2])):
        _same_step(a, b)
    assert torch.equal(want[1], got[1]) and torch.equal(want[3], got[3])
    assert not torch.equal(got[0][0].t, got[2][0].t)
    assert len(cache.captures) == len(cache.graphs) == 2
    assert len(cache.buffers) == 1
    assert all(any(k is g for k in key[0]) for key, g in
               zip(cache.graphs, gens))
    kernel.multi_super_step(*inputs, gens[0], *_step_args(run), 1)
    assert len(cache.captures) == 2 and cache.replays == 5


@pytest.mark.parametrize("pop", list(POPS))
def test_step_boundary_reads_nothing_back(pop):
    """One super_step boundary makes no host read and no host copy: a
    capture would fail at the first."""
    run = _run(pop)
    with _HostReads() as seen:
        kernel.super_step(run.ts, run.evo, run.pop, run.gen,
                          *_step_args(run), _eager=True)
    assert seen.where == []


def test_cpu_runs_the_eager_loops(monkeypatch):
    """Without CUDA neither the step nor a sweep reaches a graph cache."""
    def refuse(*a, **kw):
        raise AssertionError("a CPU call reached a graph cache")
    monkeypatch.setattr(dg.DispatchGraphs, "dispatch", refuse)
    monkeypatch.setattr(sm.MoveGraphs, "graph", refuse)
    run = _run("exponential")
    out = kernel.multi_super_step(run.ts, run.evo, run.pop, run.gen,
                                  *_step_args(run), 2)
    assert int(out[4]["local_moves_attempted"]) > 0
    s = _spr()
    gen = torch.Generator().manual_seed(3)
    sm.spr1_sweep(gen, s["p"], s["args"][0], s["args"][1], 2,
                  *s["args"][2:])
    assert not dg.captures_on("cpu") and dg.captures_on("cuda")
    assert dg.captures_on(torch.device("cuda", 1))


def test_eager_flag_skips_the_graphs(graphs_here, monkeypatch):
    """``_eager=True`` runs the eager loops where the graphs would run."""
    def refuse(*a, **kw):
        raise AssertionError("an _eager call reached a graph cache")
    monkeypatch.setattr(dg.DispatchGraphs, "dispatch", refuse)
    monkeypatch.setattr(sm.MoveGraphs, "graph", refuse)
    run = _run("exponential")
    kernel.super_step(run.ts, run.evo, run.pop, run.gen, *_step_args(run),
                      _eager=True)
    s = _spr()
    gen = torch.Generator().manual_seed(3)
    sm.slide_sweep(gen, s["p"], s["args"][0], s["args"][1], 2,
                   *s["args"][2:], _eager=True)


# ---------------------------------------------------------------------------
# the device SPR sweeps
# ---------------------------------------------------------------------------

def _tensor(a, dtype=torch.float64):
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64))
    return torch.as_tensor(a.astype(np.float64)).to(dtype)


def _rates(tree, mu):
    evo = make_evo_params(tree.num_sites, mu=mu, kappa=2.0, device="cpu")
    q3 = evo.q_tab.numpy().reshape(-1, 4, 4)
    qa = np.stack([-np.diag(q) for q in q3])
    nu, part = evo.nu.numpy(), evo.part.numpy()
    return q3, qa, nu, part, mu * nu * qa[part, tree.ref_seq]


def _spr(dtype=torch.float64):
    """A missation-free tree (12 tips x 300 sites, mu 4e-4, seed 19, as
    tests/test_torch_spr.py's chain) and its move arguments."""
    mu = 4e-4
    ref, deltas, _, dates, names, _ = simulate_dataset(12, 300, mu=mu,
                                                        seed=19)
    tree = build_random_tree(ref, deltas, [[] for _ in range(12)], dates,
                             names=names, rng=np.random.default_rng(19))
    q3, qa, nu, part, rates = _rates(tree, mu)
    args = (_tensor(tree.ref_seq), 300, _tensor([mu], dtype),
            _tensor(nu, dtype), _tensor(q3.reshape(-1), dtype),
            _tensor(qa.reshape(-1), dtype), _tensor(part),
            _tensor([rates.sum()], dtype),
            float(np.max(tree.t_max[:12])))
    return dict(tree=tree, p=sm.pack_tree(tree, device="cpu", dtype=dtype),
                args=args)


def _miss():
    """A tree with missations (10 tips x 200 sites, 10% missing, seed 41,
    as tests/test_torch_spr_miss_chain.py's chain) and its move
    arguments."""
    mu = 4e-4
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        10, 200, mu=mu, missing_fraction=0.1, seed=41)
    tree = build_random_tree(ref, deltas, miss, dates, names=names,
                             rng=np.random.default_rng(41))
    rereference_to_root_sequence(tree)
    q3, qa, nu, part, rates = _rates(tree, mu)
    c = dict(mu=_tensor([mu]), nu=_tensor(nu), qatab=_tensor(qa.reshape(-1)),
             qtab=_tensor(q3.reshape(-1)), part=_tensor(part),
             ref_cum_Q=_tensor(np.concatenate([[0.0], np.cumsum(rates)])),
             ref_seq=_tensor(tree.ref_seq), lambda_ref=_tensor([rates.sum()]))
    WF_ = 4 * max(len(ms) for ms in tree.mutations) + 32
    p = pm.pack_tree_miss(tree, WF_=WF_, device="cpu")
    return dict(tree=tree, p=p, c=c, L=200,
                t_max_tip=float(np.max(np.asarray(tree.t_max)[:10])),
                WRB=2 * p["rs"].shape[1] + 8, WH_=2 * p["msite"].shape[1])


def _sweep(kind, s, n, gen, **kw):
    """One sweep of ``kind`` on ``s``'s tree; a list of lane results."""
    if kind == "spr1_sweep_miss" or kind == "spr1_sweep_miss_lanes":
        lanes = [s["p"]] * (2 if kind.endswith("lanes") else 1)
        return pm.spr1_sweep_miss_lanes(gen, lanes, s["L"], n, s["c"],
                                        s["t_max_tip"], s["WRB"], s["WH_"],
                                        **kw)
    a = s["args"]
    if kind == "slide_sweep":
        return [sm.slide_sweep(gen, s["p"], a[0], a[1], n, *a[2:], **kw)]
    lanes = [s["p"]] * (3 if kind == "spr1_sweep_lanes" else 1)
    return sm.spr1_sweep_lanes(gen, lanes, a[0], a[1], n, *a[2:], **kw)


SWEEPS = {"spr1_sweep": 10, "spr1_sweep_lanes": 6, "slide_sweep": 10,
          "spr1_sweep_miss": 5, "spr1_sweep_miss_lanes": 3}


def _same_sweeps(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x.p) == set(y.p)
        for k in x.p:
            assert x.p[k].dtype == y.p[k].dtype and torch.equal(x.p[k],
                                                                y.p[k]), k
        for f in ("n_accepted", "delta_log_G", "n_eligible", "exhausted"):
            assert torch.equal(getattr(x, f), getattr(y, f)), f


def _same_draws(a, b):
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        assert len(la) == len(lb)
        for da, db in zip(la, lb):
            assert all(torch.equal(x, y) for x, y in zip(dg.leaves(da),
                                                         dg.leaves(db)))


def _sweep_pair(kind, s, n):
    """The sweep through the eager loop and through the buffers of this
    thread's move cache from one generator state: (eager, graph, cache),
    each with its results, recorded draws and end state."""
    out = []
    for eager in (True, False):
        gen = torch.Generator().manual_seed(8)
        rec = []
        res = _sweep(kind, s, n, gen, record=rec, _eager=eager)
        out.append((res, rec, gen.get_state()))
    return out[0], out[1], dg.thread_cache(sm.MoveGraphs)


MOVES = {"spr1_sweep": "_spr1_move", "spr1_sweep_lanes": "_spr1_move",
         "slide_sweep": "_slide_move", "spr1_sweep_miss": "_miss_move",
         "spr1_sweep_miss_lanes": "_miss_move"}


@pytest.fixture(scope="module")
def spr_inputs():
    return {"spr": _spr(), "miss": _miss()}


def _inputs(kind, spr_inputs):
    return spr_inputs["miss" if "miss" in kind else "spr"]


@pytest.mark.parametrize("kind", list(SWEEPS))
def test_sweeps_through_buffers_give_the_loops_bits(kind, spr_inputs,
                                                    graphs_here):
    """Each sweep through the buffers against the eager loop: trees,
    counts, delta_log_G, generator state and recorded draws bit for bit;
    one graph for all the lanes, one replay a lane's move, no eager move
    and no rerun."""
    s = _inputs(kind, spr_inputs)
    n = SWEEPS[kind]
    (want, rec_a, end_a), (got, rec_b, end_b), cache = _sweep_pair(kind, s,
                                                                    n)
    _same_sweeps(want, got)
    _same_draws(rec_a, rec_b)
    assert torch.equal(end_a, end_b)
    assert [c["move"] for c in cache.captures] == [MOVES[kind]]
    assert cache.replays == n * len(got)
    assert cache.eager_moves == cache.reruns == 0
    # the result never aliases a lane's buffers
    ptrs = {b.untyped_storage().data_ptr() for g in cache.graphs.values()
            for b in g.bufs.leaves if isinstance(b, torch.Tensor)}
    assert not any(x.untyped_storage().data_ptr() in ptrs
                   for r in got for x in r.p.values())
    if kind == "spr1_sweep":
        assert int(got[0].n_accepted) >= 2


EXHAUSTED = {"spr1_sweep_lanes": 6, "slide_sweep": 8,
             "spr1_sweep_miss_lanes": 3}


@pytest.mark.parametrize("kind", list(EXHAUSTED))
def test_exhausted_sweeps_rerun_and_match(kind, spr_inputs, graphs_here,
                                          monkeypatch):
    """With 2 history attempts a slot (``history.ATTEMPTS``) moves run out
    of attempts: the eager loop reruns from each lane's first exhausted
    move on widened draws, the graph path reruns the lane from its first
    tree and runs the widened moves eagerly on its buffers; both give the
    same bits, draws and generator state, and no move is left exhausted."""
    monkeypatch.setattr(hh, "ATTEMPTS", 2)
    s = _inputs(kind, spr_inputs)
    (want, rec_a, end_a), (got, rec_b, end_b), cache = _sweep_pair(
        kind, s, EXHAUSTED[kind])
    _same_sweeps(want, got)
    _same_draws(rec_a, rec_b)
    assert torch.equal(end_a, end_b)
    assert cache.reruns > 0 and cache.eager_moves > 0
    assert not any(bool(r.exhausted) for r in got)
    # some move of the record holds more than the first 2 attempts
    widest = max(d.d.u_k.shape[-1] for lane in rec_b for d in lane)
    assert widest > 2


@pytest.mark.parametrize("core", ["spr1_core", "slide_core",
                                  "spr1_miss_core"])
def test_move_cores_read_nothing_back(core, spr_inputs):
    """One move of each SPR core makes no host read and no host copy."""
    gen = torch.Generator().manual_seed(4)
    if core == "spr1_miss_core":
        s = spr_inputs["miss"]
        N = s["p"]["parent"].shape[0]
        d = pm.draw_spr1_miss(gen, N, s["L"], s["WH_"], torch.float64,
                              torch.device("cpu"))
        with _HostReads() as seen:
            pm.spr1_miss_core(s["p"], s["L"], s["c"], s["t_max_tip"], d,
                              s["WRB"])
    else:
        s = spr_inputs["spr"]
        a = s["args"]
        N = s["p"]["parent"].shape[0]
        draw = sm.draw_slide if core == "slide_core" else sm.draw_spr1
        d = draw(gen, N, a[1], torch.float64, torch.device("cpu"))
        with _HostReads() as seen:
            getattr(sm, core)(s["p"], *a, d)
    assert seen.where == []


def test_move_graph_key(spr_inputs, graphs_here):
    """A second sweep of the same shapes replays the graph, and so does a
    sweep of any lane count; another core or dtype captures its own."""
    s = spr_inputs["spr"]
    gen = torch.Generator().manual_seed(2)
    for kind in ("spr1_sweep", "spr1_sweep", "spr1_sweep_lanes",
                 "slide_sweep"):
        _sweep(kind, s, 2, gen)
    cache = dg.thread_cache(sm.MoveGraphs)
    assert [c["move"] for c in cache.captures] == ["_spr1_move",
                                                   "_slide_move"]
    s32 = _spr(torch.float32)
    _sweep("spr1_sweep", s32, 2, gen)
    assert len(cache.captures) == 3 and len(cache.buffers) == 3
    assert cache.replays == 2 + 2 + 6 + 2 + 2


def test_lanes_past_the_cache_bound_share_one_graph(spr_inputs, graphs_here,
                                                    monkeypatch):
    """More lanes than the cache keeps graphs: one capture, and a second
    sweep replays it (no capture lane by lane, no eviction)."""
    monkeypatch.setattr(sm, "MAX_MOVE_GRAPHS", 1)
    s = spr_inputs["spr"]
    a = s["args"]
    gen = torch.Generator().manual_seed(6)
    res = sm.spr1_sweep_lanes(gen, [s["p"]] * 3, a[0], a[1], 2, *a[2:])
    sm.spr1_sweep_lanes(gen, [r.p for r in res], a[0], a[1], 2, *a[2:])
    cache = dg.thread_cache(sm.MoveGraphs)
    assert len(cache.captures) == len(cache.graphs) == 1
    assert cache.replays == 12


def test_lanes_of_other_shapes_are_refused(spr_inputs, graphs_here):
    """The lanes share one graph, so a lane of another shape raises."""
    s = spr_inputs["spr"]
    a = s["args"]
    wide = sm.pack_tree(s["tree"], W=int(s["p"]["msite"].shape[1]) + 2,
                        device="cpu")
    gen = torch.Generator().manual_seed(6)
    with pytest.raises(ValueError):
        sm.spr1_sweep_lanes(gen, [s["p"], wide], a[0], a[1], 2, *a[2:])


def test_thread_caches_are_one_a_thread():
    """The free functions' caches: one of each kind a thread, the same
    object again within a thread."""
    mine = dg.thread_cache(dg.DispatchGraphs)
    assert dg.thread_cache(dg.DispatchGraphs) is mine
    assert isinstance(dg.thread_cache(sm.MoveGraphs), sm.MoveGraphs)
    other = []
    t = threading.Thread(target=lambda: other.append(
        dg.thread_cache(dg.DispatchGraphs)))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert other and other[0] is not mine


def test_clear_drops_this_threads_caches(graphs_here):
    """``clear`` lets go of this thread's graphs, buffers and the
    generators their keys hold; the next call captures again."""
    run = _run("exponential")
    gen = torch.Generator().manual_seed(13)
    kernel.super_step(run.ts, run.evo, run.pop, gen, *_step_args(run))
    cache = dg.thread_cache(dg.DispatchGraphs)
    assert any(k is gen for key in cache.graphs for k in key[0])
    dg.clear()
    fresh = dg.thread_cache(dg.DispatchGraphs)
    assert fresh is not cache and not fresh.graphs and not fresh.buffers
    kernel.super_step(run.ts, run.evo, run.pop, gen, *_step_args(run))
    assert len(fresh.captures) == 1


def test_copy_back_refuses_an_aliased_carry():
    """The copy-back writes new tensors into their buffers, skips a buffer
    handed back as it is, and refuses a view of a buffer it rewrites or an
    output of another shape."""
    bufs = [torch.zeros(4), torch.zeros(3)]
    new = torch.arange(4.0)
    assert dg.copy_back([new, bufs[1]], bufs) == [True, False]
    assert torch.equal(bufs[0], new)
    with pytest.raises(ValueError):
        dg.copy_back([bufs[0][[1, 0, 2, 3]], bufs[0][:3]], bufs)
    with pytest.raises(ValueError):
        dg.copy_back([torch.zeros(5), bufs[1]], bufs)
