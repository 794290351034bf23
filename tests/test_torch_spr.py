"""The port's device SPR for missation-free trees
(``delphy_tpu_torch/ops/{runset,history,spr_study,spr_move}.py``) against
the JAX package's functions on the same numpy-seeded inputs, in float64 on
the CPU, at the JAX tests' sizes (10-16 tips x 150-300 sites):

- the run-set algebra against Python set oracles and JAX's ``combine``
  (exact);
- the history samplers' cores fed JAX's own draws, replayed from the keys
  as ``ops/history.py`` splits them (k and states exact, times 1e-12), and
  their generator-driven wrappers' distributions against the host sampler
  ``topo/history.py`` (the JAX package's tolerances);
- the bounded study: the flood against JAX's ``bounded_spr_study`` and the
  host DFS (exact sets), the region weights, picks and proposal densities
  (1e-12; 1e-10 where ``gammaincc`` enters), ``find_region``, and the flood
  over a batch of detach candidates ("lanes") against the host DFS;
- ``spr_move``'s blocks (pack/unpack, detach/attach, ``branch_log_G``,
  ``log_alpha_mut``, ``deltas_between_dev``, ``study_regions``,
  ``_straddling_mask``) against JAX's (ints exact, floats 1e-12);
- ``spr1_core``, ``spr1_sweep_core`` and ``slide_core`` fed JAX's draws
  against ``spr1_step``, ``spr1_sweep`` and ``slide_step`` (trees exact,
  times and delta_log_G 1e-12); the lanes form against the lanes run one
  by one (exact); a generator-driven chain of SPR1 and slide moves whose
  summed delta_log_G equals the oracle log_G difference (1e-9).
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import oracles
from delphy_tpu.evo import make_evo_params as j_make_evo_params
from delphy_tpu.ops import history as jh
from delphy_tpu.ops import runset as jrs
from delphy_tpu.ops import spr_move as jsm
from delphy_tpu.ops import spr_study as jss
from delphy_tpu.phylo import build_random_tree as j_random_tree
from delphy_tpu.sim import simulate_dataset as j_simulate

from delphy_tpu_torch.ops import history as hh
from delphy_tpu_torch.ops import runset as rs
from delphy_tpu_torch.ops import spr_move as sm
from delphy_tpu_torch.ops import spr_study as ss
from delphy_tpu_torch.phylo import build_random_tree
from delphy_tpu_torch.sim import simulate_dataset
from delphy_tpu_torch.topo import site_deltas as sd
from delphy_tpu_torch.topo.history import (
    sample_mutational_history, sample_unconstrained_mutational_history)
from delphy_tpu_torch.topo.mixer import _enumerate_straddling
from delphy_tpu_torch.topo.study import SprStudy, SprStudyBuilder

F64 = jnp.float64
KM = hh.KMAX
# candidate attempts replayed per history slot: every slot of these tests
# accepts one of its first 64 (the cores assert it through ``exhausted``)
A_REPLAY = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run thousands of tiny ops, which
    several threads only slow down, most of all beside other test workers
    on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x):
    a = np.asarray(x)
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(a.astype(np.float64))
    if a.dtype == bool:
        return torch.as_tensor(a.copy())
    return torch.as_tensor(a.astype(np.int64))


def T1(x):
    return T(x).reshape(1)


def _close(got, want, tol=1e-12, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, dtype=np.float64),
                               rtol=tol, atol=tol, err_msg=msg)


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


def _trees(T_, L, mu, seed, missing=0.0, keep_miss=False):
    """The same simulated tree built by each package (the JAX one and the
    port's copy), and the JAX side's rng after the build."""
    out = []
    for sim, build in ((j_simulate, j_random_tree),
                       (simulate_dataset, build_random_tree)):
        ref, deltas, miss, dates, names, _ = sim(
            T_, L, mu=mu, missing_fraction=missing, seed=seed)
        rng = np.random.default_rng(seed)
        out.append((build(ref, deltas,
                          miss if keep_miss else [[] for _ in range(T_)],
                          dates, names=names, rng=rng), rng))
    (jt, rng), (pt, _) = out
    return jt, pt, rng


# ---------------------------------------------------------------------------
# runset
# ---------------------------------------------------------------------------

def _rand_intervals(rng, L, max_runs):
    n = int(rng.integers(0, max_runs + 1))
    pts = sorted(rng.choice(2 * L, size=2 * n, replace=False)) if n else []
    out = []
    for i in range(0, 2 * n, 2):
        s, e = int(pts[i]), int(pts[i + 1])
        if s < e:
            out.append((s % L, s % L + (e - s) % (L // 2) + 1))
    sites = set()
    for s, e in out:
        sites.update(range(s, min(e, L)))
    return _sites_to_ivs(sites), sites


def _sites_to_ivs(sites):
    if not sites:
        return []
    arr = sorted(sites)
    out, start, prev = [], arr[0], arr[0]
    for x in arr[1:]:
        if x != prev + 1:
            out.append((start, prev + 1))
            start = x
        prev = x
    out.append((start, prev + 1))
    return out


def _runset_cases(case):
    """[(a intervals, a sites, b intervals, b sites, WR_out)]."""
    if case == "overflow":
        ia = [(0, 1), (2, 3), (4, 5), (6, 7)]
        ib = [(10, 11), (12, 13), (14, 15)]
        return [(ia, None, ib, None, 4), (ia, None, ib, None, 8)]
    if case == "empty":
        return [([(3, 9)], set(range(3, 9)), [], set(), 8),
                ([], set(), [], set(), 8)]
    rng = np.random.default_rng(case)
    out = []
    for _ in range(25):
        ia, sa = _rand_intervals(rng, 500, 5)
        ib, sb = _rand_intervals(rng, 500, 5)
        out.append((ia, sa, ib, sb, 24))
    return out


@pytest.mark.parametrize("case", list(range(8)) + ["overflow", "empty"])
def test_runset_matches_set_oracle(case):
    """combine/contains_many/row_size against Python sets and JAX's combine
    (exact; an overflowing row is compared by its flag and count only, the
    two packages filling it differently)."""
    for ia, sa, ib, sb, WR in _runset_cases(case):
        WR_in = max(WR, 8)
        a = rs.make_row(ia, WR_in)
        b = rs.make_row(ib, WR_in)
        ja = tuple(jnp.asarray(x) for x in jrs.make_row(ia, WR_in))
        jb = tuple(jnp.asarray(x) for x in jrs.make_row(ib, WR_in))
        ops = ([("union", None)] if sa is None else
               [("union", sa | sb), ("minus", sa - sb),
                ("intersect", sa & sb)])
        for op, oracle in ops:
            r, e, cnt, ok = rs.combine(*a, *b, op=op, WR_out=WR)
            jr, je, jc, jok = jrs.combine(*ja, *jb, op=op, WR_out=WR)
            assert bool(ok) == bool(jok) and int(cnt) == int(jc)
            if not bool(ok):
                continue
            got = rs.row_to_intervals(r, e, cnt)
            assert got == jrs.row_to_intervals(jr, je, jc)
            _eq(r, jr)
            _eq(e, je)
            if oracle is not None:
                assert got == _sites_to_ivs(oracle), (op, ia, ib, got)
            for i in range(1, len(got)):
                assert got[i][0] > got[i - 1][1]
        if sa is not None:
            assert int(rs.row_size(*a)) == len(sa)
            mask = rs.contains_many(a[0], a[1], torch.arange(500))
            assert set(np.nonzero(mask.numpy())[0].tolist()) == sa
            for site in (0, 3, 250, 499):
                assert bool(rs.contains(a[0], a[1], site)) == (site in sa)
    if case == "overflow":
        assert [bool(rs.combine(*a, *b, op="union", WR_out=w)[3])
                for w in (4, 8)] == [False, True]


# ---------------------------------------------------------------------------
# history samplers
# ---------------------------------------------------------------------------

def j_hist_draws(key, A):
    """A slot's draws as jh.sample_site_history splits its key: the time
    uniforms, then per rejection attempt a count uniform and KMAX steps."""
    key, t_key = jax.random.split(key)
    u_t = jax.random.uniform(t_key, (KM,), F64)

    def body(k, _):
        k, k_key, c_key = jax.random.split(k, 3)
        return k, (jax.random.uniform(k_key, (), F64),
                   jax.random.randint(c_key, (KM,), 1, 4, jnp.int32))
    _, (u_k, steps) = jax.lax.scan(body, key, None, length=A)
    return u_k, steps, u_t


def j_hist_block(key, S, A):
    return jax.vmap(lambda k: j_hist_draws(k, A))(jax.random.split(key, S))


def _hist_port(h):
    return sm.HistDraws(T(h[0]), T(h[1]), T(h[2]))


@pytest.mark.parametrize("frm,to,min_k,muT", [(0, 2, 1, 1.04), (3, 1, 1, 0.05),
                                              (2, 2, 2, 0.3)])
def test_site_history_core_matches_jax(frm, to, min_k, muT):
    """sample_site_history's core fed JAX's attempts: k and states exact,
    times 1e-12, every site accepted within the replayed attempts."""
    B, T_dur = 200, 0.8
    mu = muT / T_dur
    keys = jax.random.split(jax.random.PRNGKey(3 + min_k), B)
    want = jax.vmap(lambda k: jh.sample_site_history(
        k, jnp.int32(frm), jnp.int32(to), F64(T_dur), F64(mu),
        min_k=min_k))(keys)
    u_k, steps, u_t = jax.vmap(lambda k: j_hist_draws(k, A_REPLAY))(keys)
    k, states, times, found = hh.site_history_core(
        torch.full((B,), frm), torch.full((B,), to),
        torch.tensor(T_dur, dtype=torch.float64),
        torch.tensor(mu, dtype=torch.float64), T(u_k), T(steps), T(u_t),
        min_k)
    assert bool(found.all())
    _eq(k, want[0])
    _eq(states, want[1])
    _close(times, want[2])


def test_history_small_cores_match_jax():
    """k_from_uniform, roundtrip_mask_core and unconstrained_history_core
    fed JAX's draws (k, masks, sites and states exact; times 1e-12)."""
    for lam, min_k in ((0.3, 0), (1.7, 1), (0.02, 2)):
        for i in range(40):
            key = jax.random.PRNGKey(100 + i)
            want = int(jh.sample_k_truncated_poisson(key, F64(lam), min_k))
            u = T1(jax.random.uniform(key, (), F64))
            assert int(hh.k_from_uniform(
                u, torch.tensor(lam, dtype=torch.float64), min_k)) == want
        _close(hh.k_truncated_poisson_weights(
            torch.tensor(lam, dtype=torch.float64), min_k),
            jh.k_truncated_poisson_weights(F64(lam), min_k))
    key = jax.random.PRNGKey(5)
    for T_dur, mu in ((0.9, 0.8), (3.0, 1e-5)):
        want = jh.sample_roundtrip_mask(key, 400, F64(T_dur), F64(mu))
        u = jax.random.uniform(key, (400,), F64)
        _eq(hh.roundtrip_mask_core(T(u), torch.tensor(T_dur,
                                                      dtype=torch.float64),
                                   torch.tensor(mu, dtype=torch.float64)),
            want)
    L, T_dur, mu = 25, 0.7, 0.15
    keys = jax.random.split(jax.random.PRNGKey(1000), 200)
    want = jax.vmap(lambda k: jh.sample_unconstrained_history(
        k, L, F64(T_dur), F64(mu)))(keys)
    k_key, t_key, s_key, c_key = jax.vmap(
        lambda k: jax.random.split(k, 4))(keys).transpose(1, 0, 2)
    got = hh.unconstrained_history_core(
        L, torch.tensor(T_dur, dtype=torch.float64),
        torch.tensor(mu, dtype=torch.float64),
        T(jax.vmap(lambda k: jax.random.uniform(k, (), F64))(k_key)),
        T(jax.vmap(lambda k: jax.random.uniform(k, (KM,), F64))(t_key)),
        T(jax.vmap(lambda k: jax.random.randint(k, (KM,), 0, L))(s_key)),
        T(jax.vmap(lambda k: jax.random.randint(k, (KM,), 1, 4,
                                                jnp.int32))(c_key)))
    for g, w in zip(got[:4], want[:4]):
        _eq(g, w)
    _close(got[4], want[4])
    assert int(got[0].max()) >= 4


def test_history_wrappers_match_host_sampler():
    """The generator-driven wrappers against the host sampler
    topo/history.py, with the JAX package's statistics and tolerances
    (tests/test_distributions.py): event counts, first jumps and first times
    (0.02), the round-trip rate, the unconstrained event counts (0.03)."""
    gen = torch.Generator().manual_seed(3)
    T_dur, mu, frm, to, B = 0.8, 1.3, 0, 2, 30_000
    ks, states, times = hh.sample_constrained_histories(
        gen, torch.full((B,), frm), torch.full((B,), to),
        torch.tensor(T_dur, dtype=torch.float64),
        torch.tensor(mu, dtype=torch.float64))
    ks, states, times = ks.numpy(), states.numpy(), times.numpy()
    rng = np.random.default_rng(11)
    host_ks, host_first, host_t1 = [], [], []
    for _ in range(B // 3):
        muts = sample_mutational_history(rng, 1, T_dur, mu, {0: (frm, to)})
        host_ks.append(len(muts))
        host_first.append(muts[0].to)
        host_t1.append(muts[0].t)
    for k in (1, 2, 3, 4):
        assert abs(np.mean(ks == k) - np.mean(np.asarray(host_ks) == k)) \
            < 0.02, k
    for s in range(4):
        assert abs(np.mean(states[:, 0] == s)
                   - np.mean(np.asarray(host_first) == s)) < 0.02, s
    assert abs(times[:, 0].mean() - np.mean(host_t1)) < 0.02
    assert abs(times[:, 0].std() - np.std(host_t1)) < 0.02
    assert (states[np.arange(B), ks - 1] == to).all() and (ks >= 1).all()

    T_dur, mu, L = 0.9, 0.8, 400
    dev_rate = np.mean([float(hh.sample_roundtrip_mask(
        gen, L, torch.tensor(T_dur, dtype=torch.float64),
        torch.tensor(mu, dtype=torch.float64)).double().mean())
        for _ in range(60)])
    rng = np.random.default_rng(17)
    host_hits = sum(len({m.site for m in sample_mutational_history(
        rng, L, T_dur, mu, {})}) for _ in range(300))
    host_rate = host_hits / (300 * L)
    assert 0.15 * dev_rate < host_rate <= dev_rate * 1.05

    L, T_dur, mu = 25, 0.7, 0.15
    kd, sites, frm, to, times = (x.numpy() for x in
                                 hh.sample_unconstrained_history(
        gen, L, torch.tensor(T_dur, dtype=torch.float64),
        torch.tensor(mu, dtype=torch.float64), batch=8000))
    # each site's forward chain is consistent and ends at A (0)
    for i in range(0, 8000, 400):
        k = kd[i]
        ss_, ff, tt = sites[i, :k], frm[i, :k], to[i, :k]
        assert (np.diff(times[i, :k]) >= 0).all() and (ff != tt).all()
        for l in set(ss_.tolist()):
            idx = np.nonzero(ss_ == l)[0]
            assert (tt[idx[:-1]] == ff[idx[1:]]).all() and tt[idx[-1]] == 0
    rng = np.random.default_rng(4)
    host_ks = [len(sample_unconstrained_mutational_history(rng, L, T_dur,
                                                           mu))
               for _ in range(4000)]
    for kk in range(6):
        assert abs(np.mean(np.asarray(kd) == kk)
                   - np.mean(np.asarray(host_ks) == kk)) < 0.03, kk


# ---------------------------------------------------------------------------
# bounded study
# ---------------------------------------------------------------------------

def _key(r):
    return (r.branch, r.mut_idx, round(r.t_min, 12), round(r.t_max, 12),
            r.min_muts)


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_bounded_study_matches_jax_and_host_dfs(seed):
    """The pointer-doubling flood + rewrites equal JAX's bounded_spr_study
    and the host DFS (max_muts_from_start=1) as region sets, with missing
    sites at X, both can_change_root values, and every composition path
    (+1, 0 or -1) of the one counted crossing exercised."""
    jt, pt, rng = _trees(14, 200, 5e-3, seed, missing=0.1, keep_miss=True)
    packed = ss.pack_study_tree(pt)
    jpacked = jss.pack_study_tree(jt)
    n_checked, mm_seen = 0, set()
    for trial in range(40):
        X = int(rng.integers(0, pt.num_nodes))
        if X == pt.root:
            continue
        P = int(pt.parent[X])
        a, b2 = pt.children[P]
        S = int(b2) if int(a) == X else int(a)
        t_X = float(pt.t[X])
        ccr = bool(rng.integers(0, 2))
        d0 = {}
        for m in pt.mutations[X]:
            sd.push_back(d0, m.site, m.from_, m.to)
        all_sites = sorted({m.site for b in range(pt.num_nodes)
                            for m in pt.mutations[b]} - set(d0))
        k = int(rng.integers(0, max(1, len(all_sites) // 3)))
        missing = (set(int(s) for s in rng.choice(all_sites, size=k,
                                                   replace=False))
                   if k else set())
        got = sorted(_key(r) for r in ss.bounded_spr_study(
            pt, X, t_X, missing, S, 0, d0, ccr, packed=packed, device="cpu"))
        want = sorted(_key(r) for r in jss.bounded_spr_study(
            jt, X, t_X, missing, S, 0, d0, ccr, packed=jpacked))
        b = SprStudyBuilder(pt, X, t_X, missing, max_muts_from_start=1)
        b.seed_fill_from(S, 0, d0, ccr)
        assert got == want == sorted(_key(r) for r in b.result), (trial, X)
        n_checked += 1
        mm_seen.update(r[4] - len(d0) for r in got)
    assert n_checked >= 20
    assert 1 in mm_seen and (0 in mm_seen or -1 in mm_seen), mm_seen


def test_study_flood_lanes_match_host_dfs():
    """The flood over a batch of detach candidates (every non-root X seeded
    at its sibling, the JAX package's vmapped case) equals JAX's vmapped
    flood and each X's raw host DFS."""
    jt, pt, _ = _trees(12, 150, 6e-3, 13)
    p = ss.pack_study_tree(pt)
    R, M = p["R"], p["M"]
    rid_base = p["rid_base"]
    r_above = p["m_branch"] + np.arange(M, dtype=np.int64)
    Xs, seeds = [], []
    for X in range(pt.num_nodes):
        if X == pt.root:
            continue
        P = int(pt.parent[X])
        a, b2 = pt.children[P]
        Xs.append(X)
        seeds.append(int(rid_base[int(b2) if int(a) == X else int(a)]))
    Xs, seeds = np.array(Xs), np.array(seeds)
    ones = np.ones(M, dtype=np.int64)
    jr0, jr1, jv = jax.vmap(lambda s, lo, hi: jss._bounded_flood(
        R, s, lo, hi, jnp.asarray(r_above), jnp.ones(M, dtype=bool),
        jnp.asarray(p["jr_parent"]), jnp.asarray(p["jr_child"]),
        jnp.int32(0), jnp.asarray(ones, jnp.int32),
        jnp.asarray(ones, jnp.int32)))(
        jnp.asarray(seeds), jnp.asarray(rid_base[Xs]),
        jnp.asarray(rid_base[Xs] + p["nb"][Xs]))
    for row, X in enumerate(Xs):
        r0, r1, v1 = ss._bounded_flood(
            R, int(seeds[row]), int(rid_base[X]),
            int(rid_base[X] + p["nb"][X]), T(r_above),
            torch.ones(M, dtype=torch.bool), T(p["jr_parent"]),
            T(p["jr_child"]), 0, T(ones), T(ones))
        _eq(r0, jr0[row])
        _eq(r1, jr1[row])
        _eq(v1, jv[row])
        P = int(pt.parent[X])
        a, b2 = pt.children[P]
        b = SprStudyBuilder(pt, int(X), float(pt.t[X]), set(),
                            max_muts_from_start=1)
        b._raw_fill(int(b2) if int(a) == X else int(a), 0, {})
        host = sorted(int(rid_base[r.branch]) + r.mut_idx for r in b.result)
        assert np.nonzero((r0 | r1).numpy())[0].tolist() == host, X


def _study_args(lambda_X, f, t_X, t_max_tip):
    return (torch.tensor([lambda_X], dtype=torch.float64), f,
            torch.tensor([t_X], dtype=torch.float64), t_max_tip)


def test_study_weights_and_densities_match_jax():
    """study_log_weights, pick_nexus_region, pick_time_in_region and
    log_alpha_in_region against JAX's on the same region lists, the
    above-root region included: 1e-12 for the inner regions, 1e-10 where
    gammaincc enters (the above-root weights, the bisection inverse and the
    densities that use them)."""
    jt, pt, rng = _trees(16, 300, 5e-3, 9, missing=0.08, keep_miss=True)
    t_max_tip = float(np.max(np.asarray(pt.t)[:16]))
    checked_root = studies = 0
    for trial in range(30):
        if studies >= 6 and checked_root >= 3:
            break
        X = int(rng.integers(0, pt.num_nodes))
        if X == pt.root:
            continue
        P = int(pt.parent[X])
        a, b2 = pt.children[P]
        S = int(b2) if int(a) == X else int(a)
        t_X = float(pt.t[X])
        b = SprStudyBuilder(pt, X, t_X, set(), max_muts_from_start=1)
        b.seed_fill_from(S, 0, {}, True)
        if not b.result:
            continue
        studies += 1
        lambda_X, f = 0.002 * 300, 0.8
        host = SprStudy(b, lambda_X, f, t_X, t_max_tip)
        mu = host.mu
        reg = ss.pack_regions(pt, host.regions, device="cpu")
        jreg = jss.pack_regions(jt, host.regions)
        above = reg["above"]
        args = _study_args(lambda_X, f, t_X, t_max_tip)
        lw = ss.study_log_weights(reg, *args,
                                  torch.tensor([mu], dtype=torch.float64))
        jlw = np.asarray(jss.study_log_weights(
            jreg, F64(lambda_X), F64(f), F64(t_X), F64(t_max_tip), F64(mu)))
        _close(lw[~above], jlw[~above])
        _close(lw[above], jlw[above], 1e-10)
        inner = ss.study_log_weights(reg, *args, torch.tensor(
            [mu], dtype=torch.float64), above_root=False)
        _eq(inner[~above], lw[~above])
        # the nexus pick, and the first above-root region where there is one
        picks = [None] + [int(i) for i in torch.nonzero(above)[:1, 0]]
        for i_r in picks:
            for u in (0.037, 0.5, 0.912):
                uu = T1(u)
                if i_r is None:
                    idx = ss.pick_nexus_region(uu, lw)
                    j_idx = jss.pick_nexus_region(F64(u), jnp.asarray(jlw))
                    assert int(idx) == int(j_idx)
                else:
                    idx, j_idx = T1(i_r), jnp.int32(i_r)
                    checked_root += 1
                tol = 1e-10 if above[int(idx)] else 1e-12
                t_new = ss.pick_time_in_region(uu, idx, reg, *args)
                j_t = jss.pick_time_in_region(
                    F64(u), j_idx, jreg, F64(lambda_X), F64(f), F64(t_X),
                    F64(t_max_tip))
                _close(t_new, np.reshape(j_t, 1), tol)
                la = ss.log_alpha_in_region(idx, t_new, lw, reg, *args)
                j_la = jss.log_alpha_in_region(
                    j_idx, j_t, jnp.asarray(jlw), jreg, F64(lambda_X), F64(f),
                    F64(t_X), F64(t_max_tip))
                _close(la, np.reshape(j_la, 1), tol)
                if not above[int(idx)]:
                    _eq(ss.pick_time_in_region(uu, idx, reg, *args,
                                               above_root=False), t_new)
                    _eq(ss.log_alpha_in_region(idx, t_new, lw, reg, *args,
                                               above_root=False), la)
    assert checked_root >= 3


def test_find_region_matches_jax():
    jt, pt, _ = _trees(10, 150, 6e-3, 23)
    X = next(i for i in range(pt.num_nodes)
             if i != pt.root and int(pt.parent[i]) != pt.root)
    P = int(pt.parent[X])
    a, b2 = pt.children[P]
    S = int(b2) if int(a) == X else int(a)
    b = SprStudyBuilder(pt, X, float(pt.t[X]), set(), 1)
    b.seed_fill_from(S, 0, {}, True)
    host = SprStudy(b, 0.5, 0.8, float(pt.t[X]), float(np.max(pt.t)))
    reg = ss.pack_regions(pt, host.regions, device="cpu")
    jreg = jss.pack_regions(jt, host.regions)
    for r in host.regions[:8] + [None]:
        br, tt = ((pt.root, 1e18) if r is None else
                  (r.branch, 0.5 * (max(r.t_min, r.t_max - 10.0) + r.t_max)))
        got = int(ss.find_region(br, tt, reg))
        assert got == int(jss.find_region(jnp.int64(br), F64(tt), jreg)) \
            == host.find_region(br, tt), (br, tt)
        if r is None:
            assert got == -1


# ---------------------------------------------------------------------------
# spr_move blocks
# ---------------------------------------------------------------------------

def _evo_arrays(L, rng, mu, pi=(0.3, 0.2, 0.3, 0.2)):
    evo = j_make_evo_params(L, mu=mu, kappa=2.0, pi=pi,
                            nu=rng.gamma(8.0, 1 / 8.0, size=L))
    q3 = np.asarray(evo.q_tab, dtype=np.float64).reshape(-1, 4, 4)
    qa = np.stack([-np.diag(q3[i]) for i in range(q3.shape[0])])
    return evo, q3, qa


def _jp(tree):
    return jsm.pack_tree(tree)


def _pp(tree):
    return sm.pack_tree(tree, device="cpu")


def _same_tree(got, want, msg=""):
    for k in ("parent", "children", "mcount", "msite", "mfrom", "mto"):
        _eq(got[k], want[k], f"{msg} {k}")
    for k in ("t", "mt"):
        _close(got[k], want[k], msg=f"{msg} {k}")


def _logG(tree, evo):
    return oracles.log_G(tree, float(evo.mu), np.asarray(evo.nu),
                         np.asarray(evo.q), np.asarray(evo.pi))


def test_pack_unpack_and_detach_attach_match_jax():
    """pack/unpack round trip (log_G 1e-12) and detach_attach at X's own
    position with its own history: JAX's tree exactly, integrity, log_G
    unchanged (1e-10)."""
    jt, pt, rng = _trees(12, 150, 6e-3, 7)
    evo, _, _ = _evo_arrays(150, rng, 6e-3)
    lg0 = _logG(pt, evo)
    p0, j0 = _pp(pt), _jp(jt)
    back = sm.unpack_tree(p0, pt)
    back.check_integrity()
    _close(_logG(back, evo), lg0)
    _same_tree(p0, j0, "pack")
    # copies, not aliases, of the tree's arrays
    pt.t[0] += 1.0
    assert float(p0["t"][0]) != float(pt.t[0])
    pt.t[0] -= 1.0
    n_done = 0
    for X in range(pt.num_nodes):
        if X == pt.root or int(pt.parent[X]) == pt.root:
            continue
        P = int(pt.parent[X])
        a, b = pt.children[P]
        S = int(b) if int(a) == X else int(a)
        t_P = float(pt.t[P])
        h = [p0[k][X] for k in ("msite", "mfrom", "mto", "mt")]
        p1 = sm.detach_attach(p0, T1(X), T1(S), T1(t_P), *h,
                              p0["mcount"][X:X + 1])
        j1 = jsm.detach_attach(j0, jnp.int32(X), jnp.int32(S), F64(t_P),
                               *[j0[k][X] for k in ("msite", "mfrom", "mto",
                                                    "mt")],
                               j0["mcount"][X])
        _same_tree(p1, j1, f"X={X}")
        back = sm.unpack_tree(p1, pt)
        back.check_integrity()
        _close(_logG(back, evo), lg0, 1e-10)
        n_done += 1
    assert n_done >= 5


def test_branch_log_G_and_log_alpha_mut_match_jax():
    jt, pt, rng = _trees(12, 150, 6e-3, 9)
    evo, q3, qa = _evo_arrays(150, rng, 6e-3)
    p, jp = _pp(pt), _jp(jt)
    nu, part = np.asarray(evo.nu, dtype=np.float64), np.asarray(evo.part)
    n = 0
    for X in range(pt.num_nodes):
        if X == pt.root:
            continue
        P = int(pt.parent[X])
        lam = 0.37 + 0.01 * X
        got = sm.branch_log_G(
            T1(pt.t[P]), T1(pt.t[X]), T1(lam), p["msite"][X], p["mfrom"][X],
            p["mto"][X], p["mt"][X], p["mcount"][X], T1(evo.mu), T(nu),
            T(q3.reshape(-1)), T(qa.reshape(-1)), T(part))
        want = jsm.branch_log_G(
            F64(pt.t[P]), F64(pt.t[X]), F64(lam), jp["msite"][X],
            jp["mfrom"][X], jp["mto"][X], jp["mt"][X], jp["mcount"][X],
            F64(evo.mu), jnp.asarray(nu), jnp.asarray(q3.reshape(-1)),
            jnp.asarray(qa.reshape(-1)), jnp.asarray(part))
        _close(got, np.reshape(want, 1))
        T_, M, d, mup = float(pt.t[X] - pt.t[P]), len(pt.mutations[X]), \
            min(2, len(pt.mutations[X])), 1e-3 * (1 + X)
        _close(sm.log_alpha_mut(150.0, T1(T_), T1(M), T1(d), T1(mup)),
               np.reshape(jsm.log_alpha_mut(F64(150), F64(T_), F64(M),
                                            F64(d), F64(mup)), 1))
        n += bool(pt.mutations[X])
    assert n >= 5


def test_deltas_between_and_compose_match_jax():
    jt, pt, rng = _trees(14, 120, 6e-3, 13)
    p, jp = _pp(pt), _jp(jt)
    checked = 0
    for trial in range(30):
        ba = int(rng.integers(0, pt.num_nodes))
        bb = int(rng.integers(0, pt.num_nodes))
        if ba == pt.root or bb == pt.root:
            continue
        ta = float(rng.uniform(pt.t[int(pt.parent[ba])], pt.t[ba]))
        tb = float(rng.uniform(pt.t[int(pt.parent[bb])], pt.t[bb]))
        s, f, t_, cnt, ok = sm.deltas_between_dev(p, T1(ba), T1(ta), T1(bb),
                                                  T1(tb))
        js = jsm.deltas_between_dev(jp, jnp.int32(ba), F64(ta),
                                    jnp.int32(bb), F64(tb))
        assert bool(ok) and bool(js[4])
        for g, w in zip((s, f, t_, cnt), js[:4]):
            _eq(g.reshape(-1), np.reshape(w, -1))
        got = {int(s[i]): (int(f[i]), int(t_[i])) for i in range(int(cnt))}
        assert got == sd.deltas_between(pt, (ba, ta), (bb, tb))
        checked += 1
    assert checked >= 15


# one compiled program each (the JAX functions themselves are not jitted)
j_study_regions = jax.jit(jsm.study_regions)
j_straddling_mask = jax.jit(jsm._straddling_mask)


def test_study_regions_and_straddling_mask_match_jax():
    """study_regions (post-detach coordinates) and _straddling_mask against
    JAX's, the regions exactly (t bounds 1e-12), and the study against the
    host builder run as mixer._spr1 runs it (analyze + peel, seeded at
    (S, 0) with the closed deltas, can_change_root=False)."""
    from delphy_tpu_torch.topo.graft import SprContext
    from delphy_tpu_torch.topo.mixer import TopologyMixer
    jt, pt, rng = _trees(14, 150, 6e-3, 17)
    evo, _, _ = _evo_arrays(150, rng, 6e-3)
    p, jp = _pp(pt), _jp(jt)
    W = p["msite"].shape[1]
    checked = 0
    for trial in range(25):
        X = int(rng.integers(0, pt.num_nodes))
        if checked == 10:
            break
        if X == pt.root or int(pt.parent[X]) == pt.root:
            continue
        P = int(pt.parent[X])
        a, b = pt.children[P]
        S = int(b) if int(a) == X else int(a)
        t_X = float(pt.t[X])
        ds, df, dt_, dc = sm.compose_events(
            p["msite"][X], p["mfrom"][X], p["mto"][X],
            torch.arange(W) < p["mcount"][X])
        jd = jsm.compose_events(jp["msite"][X], jp["mfrom"][X],
                                jp["mto"][X], jnp.arange(W) < jp["mcount"][X])
        for g, w in zip((ds, df, dt_, dc), jd):
            _eq(g.reshape(-1), np.reshape(w, -1))
        reg = sm.study_regions(p, T1(X), T1(t_X), ds, dt_, dc, T1(S))
        jreg = j_study_regions(jp, jnp.int32(X), F64(t_X), jd[0], jd[2],
                               jd[3], jnp.int32(S))
        _eq(reg["alive"], jreg["alive"])
        alive = reg["alive"].numpy()
        for k in ("branch", "mut_idx", "mm"):
            _eq(reg[k][alive], np.asarray(jreg[k])[alive], k)
        for k in ("t_min", "t_max", "t_S"):
            _close(reg[k][alive], np.asarray(jreg[k])[alive], msg=k)
        work = pt.copy()
        ctx = SprContext(work, float(evo.mu), np.asarray(evo.nu),
                         np.asarray(evo.q), np.asarray(evo.pi),
                         can_change_root=False)
        ctx.begin_move()
        g = ctx.analyze_graft(X)
        ctx.peel_graft(g)
        d0 = TopologyMixer._summarize_closed(ctx, g)
        builder = SprStudyBuilder(work, X, t_X, set(), max_muts_from_start=1)
        builder.seed_fill_from(S, 0, d0, False)
        host = sorted((r.branch, r.mut_idx, round(r.t_min, 10),
                       round(r.t_max, 10), r.min_muts)
                      for r in builder.result)
        got = sorted((int(reg["branch"][r]), int(reg["mut_idx"][r]),
                      round(float(reg["t_min"][r]), 10),
                      round(float(reg["t_max"][r]), 10), int(reg["mm"][r]))
                     for r in np.nonzero(alive)[0])
        assert got == host, (trial, X)
        checked += 1
    assert checked >= 10

    N = pt.num_nodes
    n_str = 0
    for trial in range(60):
        anc = int(rng.integers(0, N))
        X = int(rng.integers(0, N))
        if pt.is_tip(anc) or X == pt.root:
            continue
        t_cut = float(rng.uniform(pt.t[anc] + 1e-9, np.max(pt.t) + 1.0))
        got = sm._straddling_mask(p["parent"], p["t"], T1(anc), T1(t_cut),
                                  T1(X), p["root"])
        want = j_straddling_mask(jp["parent"], jp["t"], jnp.int32(anc),
                                 F64(t_cut), jnp.int32(X), jp["root"])
        _eq(got, want)
        host = []
        _enumerate_straddling(pt, anc, t_cut, X, host)
        assert np.nonzero(got.numpy())[0].tolist() == sorted(host)
        n_str += 1
    assert n_str >= 15


# ---------------------------------------------------------------------------
# the moves, fed JAX's draws
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("N", "L", "slide"))
def j_move_draws(key, N, L, slide):
    """A move's draws as spr1_step / slide_step split its key."""
    if slide:
        kx, k1, k2, kd, krt, krt2, kmh = jax.random.split(key, 7)
        a = jax.random.normal(k1, (), F64)
    else:
        kx, k1, k2, krt, kd, krt2, kmh = jax.random.split(key, 7)
        a = jax.random.uniform(k1, (), F64)
    return (jax.random.randint(kx, (), 0, N, dtype=jnp.int32), a,
            jax.random.uniform(k2, (), F64),
            jax.random.uniform(krt, (L,), F64),
            j_hist_block(kd, sm.H_D, A_REPLAY),
            j_hist_block(krt2, sm.H_RT, A_REPLAY),
            jax.random.uniform(kmh, (), F64))


def port_draws(key, N, L, slide):
    X, a, b, u_rt, d, r, u_mh = j_move_draws(key, N, L, slide)
    cls = sm.SlideDraws if slide else sm.Spr1Draws
    return cls(T1(X), T1(a), T1(b), T(u_rt), _hist_port(d), _hist_port(r),
               T1(u_mh))


@pytest.fixture(scope="module")
def chain():
    """The JAX tests' chain setting: 12 tips x 300 sites, mu 4e-4 (seed 19),
    the JAX and port packed trees and the move arguments of both."""
    MU = 4e-4
    jt, pt, rng = _trees(12, 300, MU, 19)
    evo, q3, qa = _evo_arrays(300, rng, MU)
    nu, part = np.asarray(evo.nu, dtype=np.float64), np.asarray(evo.part)
    lambda_ref = float(np.sum(MU * nu * qa[part, np.asarray(pt.ref_seq)]))
    t_max_tip = float(np.max(pt.t_max[:pt.num_tips]))
    jargs = (jnp.asarray(np.asarray(jt.ref_seq, dtype=np.int32)), 300,
             F64(MU), jnp.asarray(nu), jnp.asarray(q3.reshape(-1)),
             jnp.asarray(qa.reshape(-1)), jnp.asarray(part),
             F64(lambda_ref), F64(t_max_tip))
    pargs = (T(pt.ref_seq), 300, T1(MU), T(nu), T(q3.reshape(-1)),
             T(qa.reshape(-1)), T(part), T1(lambda_ref), t_max_tip)
    return dict(jt=jt, pt=pt, evo=evo, jp=_jp(jt), pp=_pp(pt), jargs=jargs,
                pargs=pargs)


@pytest.mark.parametrize("move", ["spr1", "slide"])
def test_move_cores_match_jax_steps(chain, move):
    """30 moves of spr1_core / slide_core fed each JAX step's draws: the
    JAX step's accept, eligibility and tree exactly, delta_log_G and times
    1e-12; accepted moves keep the oracle ledger (1e-9) and some accept."""
    slide = move == "slide"
    jstep = jsm.slide_step if slide else jsm.spr1_step
    core = sm.slide_core if slide else sm.spr1_core
    jp, pp, N = chain["jp"], chain["pp"], chain["pt"].num_nodes
    key = jax.random.PRNGKey(4 if slide else 2)
    lg = _logG(chain["pt"], chain["evo"])
    n_acc = n_el = 0
    for it in range(30):
        key, k = jax.random.split(key)
        want = jstep(k, jp, *chain["jargs"])
        got = core(pp, *chain["pargs"], port_draws(k, N, 300, slide))
        assert not bool(got[4]["exhausted"])
        assert bool(got[1]) == bool(want[1]), it
        assert bool(got[3]) == bool(want[3]), it
        _close(got[2], np.reshape(want[2], 1), msg=str(it))
        _same_tree(got[0], want[0], str(it))
        if bool(got[1]):
            back = sm.unpack_tree(got[0], chain["pt"])
            back.check_integrity()
            lg2 = _logG(back, chain["evo"])
            _close(float(got[2]), lg2 - lg, 1e-9)
            lg = lg2
        n_acc += bool(got[1])
        n_el += bool(got[3])
        jp, pp = want[0], got[0]
    assert n_acc >= 5 and n_el >= 12, (n_acc, n_el)


def test_spr1_sweep_core_matches_jax_sweep(chain):
    """spr1_sweep_core on the draws of JAX's spr1_sweep key schedule equals
    JAX's sweep (tree exact, times and delta_log_G 1e-12), and the port's
    generator-driven spr1_sweep replays through spr1_sweep_core exactly."""
    n = 16
    key = jax.random.PRNGKey(9)
    want = jsm.spr1_sweep(key, chain["jp"], chain["jargs"][0], 300, n,
                          *chain["jargs"][2:])
    draws = [port_draws(k, chain["pt"].num_nodes, 300, False)
             for k in jax.random.split(key, n)]
    got = sm.spr1_sweep_core(chain["pp"], *chain["pargs"], draws)
    assert not bool(got.exhausted)
    assert int(got.n_accepted) == int(want[1]) >= 2
    assert int(got.n_eligible) == int(want[3])
    _close(got.delta_log_G, np.reshape(want[2], 1))
    _same_tree(got.p, want[0])

    gen = torch.Generator().manual_seed(5)
    rec = []
    a = sm.spr1_sweep(gen, chain["pp"], chain["pargs"][0], 300, n,
                      *chain["pargs"][2:], record=rec)
    b = sm.spr1_sweep_core(chain["pp"], *chain["pargs"], rec[0])
    assert int(a.n_accepted) == int(b.n_accepted)
    _eq(a.delta_log_G, b.delta_log_G)
    for k in sm.TREE_KEYS:
        _eq(a.p[k], b.p[k])


def test_spr1_lanes_equal_lanes_run_one_by_one(chain):
    """spr1_sweep_lanes over 3 lanes: each lane equal (exactly) to
    spr1_sweep_core on that lane's own draws, the lanes' trees differ."""
    gen = torch.Generator().manual_seed(31)
    rec = []
    lanes = sm.spr1_sweep_lanes(gen, [chain["pp"]] * 3, chain["pargs"][0],
                                300, 12, *chain["pargs"][2:], record=rec)
    assert len(rec) == 3
    for lane, draws in zip(lanes, rec):
        one = sm.spr1_sweep_core(chain["pp"], *chain["pargs"], draws)
        assert int(one.n_accepted) == int(lane.n_accepted)
        _eq(one.delta_log_G, lane.delta_log_G)
        for k in sm.TREE_KEYS:
            _eq(one.p[k], lane.p[k])
    assert sum(int(x.n_accepted) for x in lanes) >= 2


def test_generator_chain_of_spr1_and_slide_keeps_the_oracle_ledger(chain):
    """A generator-driven chain of 6 sweeps (SPR1 and slide, 20 moves each):
    the summed delta_log_G equals the oracle log_G difference (1e-9), the
    tree stays valid with its tips' sequences, and moves accept."""
    gen = torch.Generator().manual_seed(6)
    pt = chain["pt"]
    p = chain["pp"]
    lg0 = _logG(pt, chain["evo"])
    total, n_acc = 0.0, 0
    for i in range(6):
        if i % 2:
            res = sm.slide_sweep(gen, p, chain["pargs"][0], 300, 20,
                                 *chain["pargs"][2:])
        else:
            res = sm.spr1_sweep(gen, p, chain["pargs"][0], 300, 20,
                                *chain["pargs"][2:])
        p = res.p
        total += float(res.delta_log_G)
        n_acc += int(res.n_accepted)
    back = sm.unpack_tree(p, pt)
    back.check_integrity()
    _close(_logG(back, chain["evo"]) - lg0, total, 1e-9)
    for i in range(back.num_tips):
        assert (back.sequence_at(i) == pt.sequence_at(i)).all()
    assert n_acc >= 10, n_acc
