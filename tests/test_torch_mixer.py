"""The port's Python topology mixer fallback (``delphy_tpu_torch/topo/``
``site_deltas``, ``history``, ``study``, ``graft``, ``TopologyMixer`` and
the spawn pool of ``topo/parallel.py``) against the JAX package's host
modules, bit for bit on the same trees and ``np.random`` states:

- grafts, moves and peel/apply round trips of ``SprContext`` and
  ``deltas_between``;
- a ``TopologyMixer`` burst: tree arrays, ledger deltas, counts and the
  generator's state after;
- ``run_partitioned_bursts`` with the native kernel forced off, serially
  and through the port's worker pool;
- a port ``Run`` with the native burst forced off: it constructs and steps
  through a burst with its ledger at 1e-6, in one process and with the
  partitioned burst on the pool.
"""

import numpy as np
import pytest

from delphy_tpu import pop as jpop
from delphy_tpu.evo import make_evo_params as j_make_evo_params
from delphy_tpu.phylo import build_random_tree as j_random_tree
from delphy_tpu.sim import simulate_dataset as j_simulate
from delphy_tpu.topo import parallel as jparallel
from delphy_tpu.topo import site_deltas as jsd
from delphy_tpu.topo.graft import SprContext as JSprContext
from delphy_tpu.topo.mixer import HostExpPop as JHostExpPop
from delphy_tpu.topo.mixer import TopologyMixer as JTopologyMixer

import delphy_tpu_torch.native as native
from delphy_tpu_torch import run as run_mod
from delphy_tpu_torch.init_tree import build_initial_tree
from delphy_tpu_torch.phylo import NO_NODE, build_random_tree
from delphy_tpu_torch.sim import simulate_dataset
from delphy_tpu_torch.topo import TopologyMixer
from delphy_tpu_torch.topo import parallel
from delphy_tpu_torch.topo import site_deltas as sd
from delphy_tpu_torch.topo.graft import SprContext, _sibling
from delphy_tpu_torch.topo.mixer import HostExpPop


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the Runs' many tiny ops (several threads
    only slow them down beside other test workers on the same cores)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees(T_, L, mu, seed, missing):
    out = []
    for sim, build in ((j_simulate, j_random_tree),
                       (simulate_dataset, build_random_tree)):
        ref, deltas, miss, dates, names, _ = sim(
            T_, L, mu=mu, missing_fraction=missing, seed=seed)
        out.append(build(ref, deltas, miss, dates, names=names,
                         rng=np.random.default_rng(seed + 1000)))
    jt, pt = out
    rng = np.random.default_rng(seed)
    evo = j_make_evo_params(L, mu=mu, kappa=2.0,
                            pi=(0.28, 0.22, 0.26, 0.24),
                            nu=rng.gamma(8.0, 1 / 8.0, size=L))
    return jt, pt, evo


def _evo_args(evo):
    return (float(evo.mu), np.asarray(evo.nu), np.asarray(evo.q),
            np.asarray(evo.pi))


def _assert_same_tree(got, want):
    for f in ("parent", "children", "t", "t_min", "t_max", "ref_seq"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.root == want.root
    for n in range(want.num_nodes):
        assert [(m.site, m.from_, m.to, m.t) for m in got.mutations[n]] == \
            [(m.site, m.from_, m.to, m.t) for m in want.mutations[n]], n
        assert got.miss_intervals[n] == want.miss_intervals[n], n
        assert got.miss_from_states[n] == want.miss_from_states[n], n


def _graft_key(g):
    return (g.delta_log_G, g.log_alpha_mut, g.rooty,
            [(len(b.hot_muts_to_X), len(b.hot_deltas_to_X), b.T_to_X)
             for b in g.branch_infos])


def _subtree(tree, X):
    out, stack = set(), [X]
    while stack:
        n = stack.pop()
        out.add(n)
        stack += [int(c) for c in tree.children[n] if c != NO_NODE]
    return out


@pytest.mark.parametrize("seed", [0, 7])
def test_graft_moves_and_deltas_match_jax(seed):
    """Round trips (analyze + peel + apply), full moves with a proposed
    graft and deltas_between on the port's copies equal the JAX package's:
    the same grafts, ledger terms and trees (==), from the same rng."""
    jt, pt, evo = _trees(12, 80, 4e-3, seed, 0.15)
    ctx = SprContext(pt, *_evo_args(evo))
    jctx = JSprContext(jt, *_evo_args(evo))
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    for X in range(pt.num_nodes):
        if X == pt.root:
            continue
        ctx.begin_move()
        jctx.begin_move()
        g, jg = ctx.analyze_graft(X), jctx.analyze_graft(X)
        assert _graft_key(g) == _graft_key(jg), X
        ctx.peel_graft(g)
        jctx.peel_graft(jg)
        _assert_same_tree(pt, jt)
        ctx.apply_graft(g)
        jctx.apply_graft(jg)
        _assert_same_tree(pt, jt)
    done = 0
    for trial in range(40):
        X = int(rng.integers(0, pt.num_nodes))
        assert X == int(jrng.integers(0, jt.num_nodes))
        if X == pt.root:
            continue
        P = int(pt.parent[X])
        cands = [n for n in range(pt.num_nodes)
                 if n not in _subtree(pt, X) and n != P]
        SS = int(rng.choice(cands))
        assert SS == int(jrng.choice(cands))
        GG = int(pt.parent[SS]) if SS != pt.root else NO_NODE
        hi = min(float(pt.t[X]), float(pt.t[SS]))
        lo = float(pt.t[GG]) if GG != NO_NODE else hi - 30.0
        if lo >= hi:
            continue
        new_t = float(rng.uniform(lo, hi))
        assert new_t == float(jrng.uniform(lo, hi))
        assert _sibling(pt, P, X) == _sibling(jt, P, X)
        for c, r in ((ctx, rng), (jctx, jrng)):
            c.begin_move()
            old = c.analyze_graft(X)
            c.peel_graft(old)
            c.move(X, SS, new_t)
            new = c.propose_new_graft(X, r)
            c.apply_graft(new)
            if c is ctx:
                pair = (old, new)
        assert _graft_key(pair[0]) == _graft_key(old)
        assert _graft_key(pair[1]) == _graft_key(new)
        pt.check_integrity()
        _assert_same_tree(pt, jt)
        for _ in range(3):
            ba, bb = (int(rng.integers(0, pt.num_nodes)) for _ in range(2))
            assert (ba, bb) == tuple(int(jrng.integers(0, jt.num_nodes))
                                     for _ in range(2))
            if pt.root in (ba, bb):
                continue
            ta, tb = (float(r.uniform(pt.t[int(pt.parent[b])], pt.t[b]))
                      for r, b in ((rng, ba), (rng, bb)))
            assert (ta, tb) == tuple(
                float(jrng.uniform(jt.t[int(jt.parent[b])], jt.t[b]))
                for b in (ba, bb))
            assert sd.deltas_between(pt, (ba, ta), (bb, tb)) == \
                jsd.deltas_between(jt, (ba, ta), (bb, tb))
        done += 1
    assert done >= 10
    assert rng.bit_generator.state == jrng.bit_generator.state


def test_mixer_burst_matches_jax():
    """A 400-move TopologyMixer burst from equal trees and generator states:
    the trees, delta_log_G, delta_log_coal, the counts and the generator's
    state after are the JAX package's, bit for bit."""
    jt, pt, evo = _trees(14, 120, 5e-3, 11, 0.1)
    pop = (200.0, 100.0, 0.0, 1.0)
    t_max_tip = float(np.max(pt.t_max[:pt.num_tips]))
    rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    mixer = TopologyMixer(pt, rng, num_cells=128)
    jmixer = JTopologyMixer(jt, jrng, num_cells=128)
    mixer.run_burst(400, *_evo_args(evo), HostExpPop(*pop), t_max_tip)
    jmixer.run_burst(400, *_evo_args(evo), jpop.ExpPopParams(*pop),
                     t_max_tip)
    pt.check_integrity()
    _assert_same_tree(pt, jt)
    assert (mixer.delta_log_G, mixer.delta_log_coal, mixer.n_accepted,
            mixer.n_proposed) == (jmixer.delta_log_G, jmixer.delta_log_coal,
                                  jmixer.n_accepted, jmixer.n_proposed)
    assert mixer.n_accepted > 0 and mixer.n_proposed == 400
    assert rng.bit_generator.state == jrng.bit_generator.state


@pytest.fixture
def python_mixer(monkeypatch):
    """The native topology kernel forced off in both packages, and the
    port's worker pool usable (the JAX package's runs serially: its result
    does not depend on the pool); the pool is shut afterwards."""
    import delphy_tpu.native as jnative
    monkeypatch.setattr(native, "native_available", lambda: False)
    monkeypatch.setattr(jnative, "native_available", lambda: False)
    monkeypatch.setattr(parallel, "_pool_usable", lambda: True)
    monkeypatch.setattr(jparallel, "_pool_usable", lambda: False)
    yield
    if parallel._POOL is not None:
        parallel._POOL.terminate()
        parallel._POOL.join()
        parallel._POOL = None


@pytest.mark.parametrize("par", [False, True])
def test_partitioned_bursts_on_the_python_mixer_match_jax(python_mixer, par):
    """run_partitioned_bursts with the native kernel off, 4 parts, serially
    and through the spawn pool: the JAX function's result and tree, bit for
    bit."""
    jt, pt, evo = _trees(30, 200, 2e-3, 3, 0.05)
    L = pt.num_sites
    part = np.zeros(L, np.int32)
    q_tab = np.asarray(evo.q)[None]
    pop = (float(np.max(pt.t_max[:pt.num_tips])), 500.0, 0.002, 1.0)
    got = parallel.run_partitioned_bursts(
        pt, 800, 4, HostExpPop(*pop), *_evo_args(evo),
        np.random.default_rng(9), parallel=par, part=part, q_tab=q_tab)
    want = jparallel.run_partitioned_bursts(
        jt, 800, 4, JHostExpPop(*pop), *_evo_args(evo),
        np.random.default_rng(9), parallel=par, part=part, q_tab=q_tab)
    assert got == want and got[1] > 0
    assert (parallel._POOL is not None) == par
    pt.check_integrity()
    _assert_same_tree(pt, jt)


@pytest.mark.parametrize("parts", [1, 4])
def test_run_steps_on_the_python_mixer(python_mixer, monkeypatch, parts):
    """A port Run with the native burst forced off constructs (it raised
    before the fallback was ported) and steps through a dispatch and a
    burst on the Python mixer (parts=1: in this process; parts=4: the
    partitioned burst on the pool), its ledger at 1e-6."""
    made = []

    class CountingMixer(TopologyMixer):
        def __init__(self, *a, **kw):
            made.append(1)
            super().__init__(*a, **kw)
    monkeypatch.setattr(run_mod, "run_burst_native", lambda *a, **kw: None)
    monkeypatch.setattr(run_mod, "TopologyMixer", CountingMixer)
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        20, 300, mu=1e-3, sample_window_days=300.0, missing_fraction=0.02,
        seed=23)
    tree = build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(23))
    run = run_mod.Run(tree, seed=23, num_cells=128, device="cpu",
                      topology_partitions=parts)
    run.do_mcmc_steps(2 * run.local_moves_per_global_move)
    assert run.burst_count >= 1 and run.topology_proposed > 0
    assert run.topology_accepted > 0
    assert (len(made) > 0) == (parts == 1)
    assert (parallel._POOL is not None) == (parts > 1)
    run.check_derived_quantities(1e-6)
    run.tree().check_integrity()


def test_study_log_alpha_takes_c_values_where_the_reference_raises():
    """C7: where every region's weight is 0 (or a region has no length)
    the reference's SprStudy.log_alpha_in_region raises (math.log(0));
    the port's copy returns the native kernel's NaN, which rejects the
    move, and agrees with the reference (==) everywhere else."""
    from delphy_tpu.topo.study import SprStudy as JSprStudy
    from delphy_tpu.topo.study import SprStudyBuilder as JSprStudyBuilder
    from delphy_tpu_torch.topo.study import SprStudy, SprStudyBuilder
    jt, pt, _ = _trees(10, 150, 6e-3, 23, 0.0)
    X = next(i for i in range(pt.num_nodes)
             if i != pt.root and int(pt.parent[i]) != pt.root)
    S = _sibling(pt, int(pt.parent[X]), X)
    studies = []
    for B, St, tr in ((SprStudyBuilder, SprStudy, pt),
                      (JSprStudyBuilder, JSprStudy, jt)):
        b = B(tr, X, float(tr.t[X]), set(), 1)
        b.seed_fill_from(S, 0, {}, True)
        studies.append(St(b, 0.5, 0.8, float(tr.t[X]), float(np.max(tr.t))))
    port, ref = studies
    for i, r in enumerate(port.regions):
        if r.is_above_root() or not r.t_min < r.t_max:
            continue
        t = 0.5 * (r.t_min + r.t_max)
        assert port.log_alpha_in_region(i, t) == ref.log_alpha_in_region(i, t)
    i = next(i for i, r in enumerate(port.regions) if not r.is_above_root())
    # every weight underflowed: log W = -inf, W = 0, sum 0
    for st in (port, ref):
        for r in st.regions:
            r.log_W_over_Wmax, r.W_over_Wmax = -np.inf, 0.0
        st.sum_W = 0.0
    with pytest.raises(ValueError):
        ref.log_alpha_in_region(i, port.regions[i].t_max)
    assert np.isnan(port.log_alpha_in_region(i, port.regions[i].t_max))
