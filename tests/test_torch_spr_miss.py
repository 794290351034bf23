"""The port's device SPR for trees with missations, its pieces
(``delphy_tpu_torch/ops/spr_miss.py``, and ``spr_move.study_regions`` with
the missing-at-X row) against the JAX package's functions and the port's
host graft, in float64 on the CPU, at the JAX tests' sizes (14-16 tips x
250-300 sites, 8-40% of sites missing):

- packing: pack/unpack round trips, ``convert.packed_tree_to_torch`` of
  the JAX packed tree equal to the port's packing (exact);
- the from-state row ops: ``fs_get``/``fs_set``/``fs_bulk_add`` against
  JAX's on random rows (lanes exact), and a sequence of ``fs_set`` calls
  (``_fs_rows_seq``) against the same calls one by one (maps and the
  overflow flag exact);
- lambda and missing-site reads against JAX's and the host graft's
  (1e-12; rows exact, overflow flags exact at small caps, one of them a
  union that overflows partway up the walk and fits at its end);
- ``study_regions`` with the missing-at-X row against JAX's and the host
  study builder as ``mixer._spr1`` runs it (regions exact, bounds 1e-12);
- ``start_inner_dev`` for every inner node against JAX's (every field
  exact or 1e-12) and the host analysis; ``_path_and_sibs`` against JAX's;
- ``finish_dev``, ``peel_inner_dev``, ``move_dev`` and ``apply_inner_dev``
  against JAX's and the host graft's pipeline: trees equal, the fs rows
  compared as maps (the port places new entries in other free lanes),
  delta_log_G and log_alpha_mut 1e-12 (1e-9 against the host); the move
  also on trees given extra from-states, where the normalisation cascade
  and the un-factoring walk move them, and at tight row widths, where both
  packages reject the same moves.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from delphy_tpu.evo import make_evo_params as j_make_evo_params
from delphy_tpu.ops import runset as jrs
from delphy_tpu.ops import spr_miss as jm
from delphy_tpu.ops import spr_move as jsm
from delphy_tpu.phylo import build_random_tree as j_random_tree
from delphy_tpu.phylo import rereference_to_root_sequence as j_reref
from delphy_tpu.sim import simulate_dataset as j_simulate
from delphy_tpu.topo.graft import SprContext as JSprContext

from delphy_tpu_torch import convert
from delphy_tpu_torch.ops import runset as rs
from delphy_tpu_torch.ops import spr_miss as pm
from delphy_tpu_torch.ops import spr_move as sm
from delphy_tpu_torch.phylo import build_random_tree, \
    rereference_to_root_sequence
from delphy_tpu_torch.sim import simulate_dataset
from delphy_tpu_torch.topo.graft import SprContext
from delphy_tpu_torch.topo.mixer import TopologyMixer
from delphy_tpu_torch.topo.study import SprStudyBuilder

F64 = jnp.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run thousands of tiny ops."""
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


def _close(got, want, tol=1e-12, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, dtype=np.float64),
                               rtol=tol, atol=tol, err_msg=msg)


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


def trees(T_, L, seed, missing, mu=2e-3):
    """The same random tree with missations built by each package (the JAX
    one and the port's copy), rereferenced to its root sequence."""
    out = []
    for sim, build, reref in ((j_simulate, j_random_tree, j_reref),
                              (simulate_dataset, build_random_tree,
                               rereference_to_root_sequence)):
        ref, deltas, miss, dates, names, _ = sim(
            T_, L, mu=mu, missing_fraction=missing, seed=seed)
        tree = build(ref, deltas, miss, dates, names=names,
                     rng=np.random.default_rng(seed))
        reref(tree)
        tree.check_integrity()
        out.append(tree)
    return out


def move_args(jt, mu):
    """(host context, the JAX move arguments, the port's) as
    tests/test_spr_miss.py builds them."""
    L = jt.num_sites
    evo = j_make_evo_params(L, mu=mu, kappa=2.0)
    ctx = JSprContext(jt, mu, np.asarray(evo.nu), np.asarray(evo.q),
                      np.asarray(evo.pi), can_change_root=False)
    arrays = dict(nu=np.asarray(evo.nu), qatab=ctx.qa_tab.reshape(-1),
                  qtab=ctx.q_tab.reshape(-1), part=np.asarray(ctx.part),
                  ref_cum_Q=np.asarray(ctx.ref_cum_Q),
                  ref_seq=jt.ref_seq.astype(np.int32))
    ja = {k: jnp.asarray(v) for k, v in arrays.items()}
    ja.update(mu=F64(mu), lambda_ref=F64(ctx.lambda_ref))
    pa = {k: T(v) for k, v in arrays.items()}
    pa.update(mu=T([mu]), lambda_ref=T([ctx.lambda_ref]))
    return ctx, ja, pa


def maps_equal(got, want, template, msg=""):
    """Port and JAX packed trees hold the same tree: topology and times,
    mutation rows (times 1e-12), missation runs and from-state maps."""
    a = pm.unpack_tree_miss(got, template)
    b = jm.unpack_tree_miss(want, template)
    assert a.root == b.root, msg
    _eq(a.parent, b.parent, msg)
    _eq(a.children, b.children, msg)
    _close(a.t, b.t, msg=msg)
    for n in range(a.num_nodes):
        assert [(m.site, m.from_, m.to) for m in a.mutations[n]] == \
            [(m.site, m.from_, m.to) for m in b.mutations[n]], (msg, n)
        _close([m.t for m in a.mutations[n]], [m.t for m in b.mutations[n]],
               msg=f"{msg} {n}")
        assert a.miss_intervals[n] == b.miss_intervals[n], (msg, n)
        assert a.miss_from_states[n] == b.miss_from_states[n], (msg, n)
    return a


def host_equal(a, b, msg=""):
    """A port tree equals a host tree (times exact, as the JAX test)."""
    assert a.root == b.root, msg
    _eq(a.parent, b.parent, msg)
    _eq(np.sort(np.asarray(a.children), 1), np.sort(np.asarray(b.children),
                                                    1), msg)
    np.testing.assert_allclose(a.t, b.t, rtol=0, atol=0, err_msg=msg)
    for n in range(a.num_nodes):
        assert [(m.site, m.from_, m.to, m.t) for m in a.mutations[n]] == \
            [(m.site, m.from_, m.to, m.t) for m in b.mutations[n]], (msg, n)
        assert a.miss_intervals[n] == b.miss_intervals[n], (msg, n)
        assert a.miss_from_states[n] == b.miss_from_states[n], (msg, n)


def inner_nodes(tree):
    return [X for X in range(tree.num_nodes)
            if X != tree.root and int(tree.parent[X]) != tree.root]


# ---------------------------------------------------------------------------
# packing and the from-state rows
# ---------------------------------------------------------------------------

def test_pack_unpack_and_convert_match_jax():
    jt, pt = trees(24, 400, 3, 0.08)
    p = pm.pack_tree_miss(pt, device="cpu")
    jp = jm.pack_tree_miss(jt)
    got = convert.packed_tree_to_torch(
        {k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    assert set(got) == set(p) == set(pm.MISS_KEYS)
    for k in p:
        assert got[k].dtype == p[k].dtype, k
        _eq(got[k], p[k].numpy(), k)
    out = pm.unpack_tree_miss(p, pt)
    out.check_integrity()
    for n in range(pt.num_nodes):
        assert out.mutations[n] == pt.mutations[n]
        assert out.miss_intervals[n] == pt.miss_intervals[n]
        assert out.miss_from_states[n] == pt.miss_from_states[n]
    # copies, not aliases, of the tree's arrays
    pt.t[0] += 1.0
    assert float(p["t"][0]) != float(pt.t[0])


def _rand_row(rng, WFn, L, n):
    sites = rng.choice(L, size=n, replace=False)
    fs = np.full(WFn, -1, np.int64)
    lanes = rng.choice(WFn, size=n, replace=False)
    fs[lanes] = sites
    return fs, rng.integers(0, 4, size=WFn)


def test_fs_row_ops_match_jax():
    """fs_get, fs_set and fs_bulk_add against JAX's on random rows (lanes
    and flags exact), full rows included."""
    rng = np.random.default_rng(4)
    L, WFn = 60, 8
    ref = rng.integers(0, 4, size=L)
    jref, pref = jnp.asarray(ref.astype(np.int32)), T(ref)
    jset = jax.jit(jm.fs_set)
    jadd = jax.jit(jm.fs_bulk_add)
    for trial in range(60):
        fs, fv = _rand_row(rng, WFn, L, int(rng.integers(0, WFn + 1)))
        jfs, jfv = jnp.asarray(fs.astype(np.int32)), jnp.asarray(
            fv.astype(np.int32))
        site = int(rng.choice(fs[fs >= 0])) if (fs >= 0).any() and \
            rng.random() < 0.5 else int(rng.integers(0, L))
        state = int(rng.integers(0, 4))
        assert int(pm.fs_get(T(fs), T(fv), pref, site)) == \
            int(jm.fs_get(jfs, jfv, jref, jnp.int32(site)))
        got = pm.fs_set(T(fs), T(fv), pref, site, state)
        want = jset(jfs, jfv, jref, jnp.int32(site), jnp.int32(state))
        _eq(got[0], want[0])
        _eq(got[1], want[1])
        assert bool(got[2]) == bool(want[2])
        present = set(fs[fs >= 0].tolist())
        A = 5
        add_site = rng.choice(sorted(set(range(L)) - present), size=A,
                              replace=False)
        add_val = rng.integers(0, 4, size=A)
        mask = rng.random(A) < 0.6
        got = pm.fs_bulk_add(T(fs), T(fv), T(add_site), T(add_val),
                             T(mask))
        want = jadd(jfs, jfv, jnp.asarray(add_site.astype(np.int32)),
                    jnp.asarray(add_val.astype(np.int32)),
                    jnp.asarray(mask))
        assert bool(got[2]) == bool(want[2])
        if bool(want[2]):
            _eq(got[0], want[0])
            _eq(got[1], want[1])


def _fs_map(fs, fv):
    return {int(s): int(v) for s, v in zip(fs.tolist(), fv.tolist())
            if s >= 0}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fs_set_sequence_equals_calls_one_by_one(seed):
    """_fs_rows_seq (every op at once, with repeated sites and ops that
    skip rows) against the same fs_set calls one by one: the rows' maps and
    the overflow flag."""
    rng = np.random.default_rng(seed)
    L, WFn, R, O = 30, 8, 4, 16
    ref = T(rng.integers(0, 4, size=L))
    n_over = 0
    for trial in range(25):
        rows = [_rand_row(rng, WFn, L, int(rng.integers(0, WFn + 1)))
                for _ in range(R)]
        op_site = T(rng.integers(0, 10, size=O))
        op_state = T(rng.integers(0, 4, size=O))
        app = T(rng.random((O, R)) < 0.5)
        ss, sv, ok = pm._fs_rows_seq(T(np.stack([r[0] for r in rows])),
                                     T(np.stack([r[1] for r in rows])), ref,
                                     op_site, op_state, app)
        want_ok = True
        for r in range(R):
            s, v = T(rows[r][0]), T(rows[r][1])
            for o in range(O):
                if bool(app[o, r]):
                    s, v, okk = pm.fs_set(s, v, ref, op_site[o],
                                          op_state[o])
                    want_ok &= bool(okk)
            if want_ok:
                assert _fs_map(ss[r], sv[r]) == _fs_map(s, v), (trial, r)
        assert bool(ok) == want_ok, trial
        n_over += not want_ok
    assert 0 < n_over < 25


# ---------------------------------------------------------------------------
# lambda and missing-site reads; the bounded study's missing-at-X branch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reads_case():
    jt, pt = trees(24, 400, 7, 0.08)
    ctx, ja, pa = move_args(jt, 2e-3)
    return jt, pt, ctx, ja, pa, jm.pack_tree_miss(jt), \
        pm.pack_tree_miss(pt, device="cpu")


def test_lambda_and_missing_reads_match_jax_and_host(reads_case):
    jt, pt, ctx, ja, pa, jp, p = reads_case
    lam_args = [ja[k] for k in ("lambda_ref", "mu", "nu", "qatab", "part",
                                "ref_cum_Q", "ref_seq")]
    plam_args = [pa[k] for k in ("lambda_ref", "mu", "nu", "qatab", "part",
                                 "ref_cum_Q", "ref_seq")]
    N = pt.num_nodes
    jlam = jax.jit(jax.vmap(lambda X: jm.lambda_at_dev_miss(
        jp, X, *lam_args)))(jnp.arange(N))
    jnm = jax.jit(jax.vmap(lambda X: jm.num_missing_at_dev(jp, X)))(
        jnp.arange(N))
    L = pt.num_sites
    j_row = jax.jit(jm.missing_at_row, static_argnames=("WR_out",))
    for X in range(N):
        lam = pm.lambda_at_dev_miss(p, X, *plam_args)
        _close(lam, np.reshape(jlam[X], 1), msg=str(X))
        assert float(lam) == pytest.approx(ctx.lambda_at(X), rel=1e-12,
                                           abs=1e-12)
        assert int(pm.num_missing_at_dev(p, X)) == int(jnm[X]) \
            == ctx.num_missing_at(X)
        for WR_out in (32, 2, 1):
            got = pm.missing_at_row(p, X, WR_out)
            want = j_row(jp, X, WR_out=WR_out)
            assert bool(got[3]) == bool(want[3]), (X, WR_out)
            if bool(want[3]):
                for g, w in zip(got[:3], want[:3]):
                    _eq(g.reshape(-1), np.reshape(w, -1))
            if WR_out == 32:   # no row cut short: the host's set
                mask = rs.contains_many(got[0], got[1], torch.arange(L))
                _eq(mask, [ctx._is_site_missing_at(X, s) for s in range(L)])
    X = inner_nodes(pt)[0]
    _close(pm.delta_lambda_across_branch_dev(p, X, *plam_args[1:]),
           np.reshape(jm.delta_lambda_across_branch_dev(jp, X,
                                                        *lam_args[1:]), 1))


def test_missing_at_row_fold_overflows_partway(reads_case):
    """A union that needs two runs partway up the walk and one at its end
    ([0,1), then [2,3), then [1,2)): the fold's cap rejects it in both
    packages, where a union taken at once would fit."""
    jt, pt, _ctx, _ja, _pa, jp, p = reads_case
    X = inner_nodes(pt)[0]
    path = [X, int(pt.parent[X]), int(pt.parent[int(pt.parent[X])])]
    rows = {path[0]: (0, 1), path[1]: (2, 3), path[2]: (1, 2)}
    jq = {k: np.array(v) for k, v in jp.items()}
    n = X
    while n >= 0:
        jq["rs"][n], jq["re"][n], jq["rcnt"][n] = int(jrs.BIG), \
            int(jrs.BIG), 0
        if n in rows:
            jq["rs"][n, 0], jq["re"][n, 0] = rows[n]
            jq["rcnt"][n] = 1
        n = int(pt.parent[n])
    q = convert.packed_tree_to_torch(jq, device="cpu")
    jq = {k: jnp.asarray(v) for k, v in jq.items()}
    for WR_out, fits in ((1, False), (2, True)):
        got = pm.missing_at_row(q, X, WR_out)
        want = jm.missing_at_row(jq, X, WR_out=WR_out)
        assert bool(got[3]) == bool(want[3]) == fits
        assert rs.row_to_intervals(*got[:3]) == [(0, 3)]


def test_study_regions_with_missing_sites_match_jax_and_host(reads_case):
    """study_regions with (miss_rs, miss_re), crossings at the sites missing
    at X not counted, on the peeled tree (as spr1_step_miss calls it):
    JAX's regions and the host builder's as mixer._spr1 seeds it."""
    jt, pt, ctx0, ja, pa, jp, p = reads_case
    WRB, WH_ = 2 * p["rs"].shape[1] + 8, 2 * p["msite"].shape[1]
    WR = p["rs"].shape[1]
    j_start = jax.jit(functools.partial(jm.start_inner_dev, WRB=WRB,
                                        WH_=WH_))
    j_peel = jax.jit(jm.peel_inner_dev)
    j_regions = jax.jit(jsm.study_regions)
    rng = np.random.default_rng(3)
    checked = with_missing = differs = 0
    for X in rng.permutation(inner_nodes(pt))[:10]:
        X = int(X)
        t_X = float(pt.t[X])
        P = int(pt.parent[X])
        S = int(pt.children[P][0] if pt.children[P][1] == X
                else pt.children[P][1])
        G, ok = pm.start_inner_dev(p, X, pa, WRB, WH_)
        p_peel, ok2 = pm.peel_inner_dev(p, G, pa)
        mrs, mre, _, ok3 = pm.missing_at_row(p, X, WR)
        assert bool(ok & ok2 & ok3)
        d0 = pm._summarize_closed_dev(G)
        reg = sm.study_regions(p_peel, T([X]), T([t_X]), d0[0], d0[2], d0[3],
                               T([S]), miss_rs=mrs, miss_re=mre)
        jG, _ = j_start(jp, X, ja)
        jpeel, _ = j_peel(jp, jG, ja)
        jmr = jm.missing_at_row(jp, X, WR_out=WR)
        jd0 = jm._summarize_closed_dev(jG)
        jreg = j_regions(jpeel, jnp.int32(X), F64(t_X), jd0[0], jd0[2],
                         jd0[3], jnp.int32(S), miss_rs=jmr[0],
                         miss_re=jmr[1])
        _eq(reg["alive"], jreg["alive"])
        alive = reg["alive"].numpy()
        counted = sm.study_regions(p_peel, T([X]), T([t_X]), d0[0], d0[2],
                                   d0[3], T([S]))
        differs += not torch.equal(counted["alive"], reg["alive"])
        for k in ("branch", "mut_idx", "mm"):
            _eq(reg[k][alive], np.asarray(jreg[k])[alive], k)
        for k in ("t_min", "t_max"):
            _close(reg[k][alive], np.asarray(jreg[k])[alive], msg=k)
        # the host: analyze + peel, the sites missing at or above X
        work = pt.copy()
        ctx = SprContext(work, float(ja["mu"]), np.asarray(ctx0.nu),
                         np.asarray(ctx0.q), np.asarray(ctx0.pi),
                         can_change_root=False)
        ctx.begin_move()
        g = ctx.analyze_graft(X)
        ctx.peel_graft(g)
        d0h = TopologyMixer._summarize_closed(ctx, g)
        missing = {s for s in range(pt.num_sites)
                   if ctx._is_site_missing_at(X, s)}
        b = SprStudyBuilder(work, X, t_X, missing, max_muts_from_start=1)
        b.seed_fill_from(S, 0, d0h, False)
        host = sorted((r.branch, r.mut_idx, round(r.t_min, 10),
                       round(r.t_max, 10), r.min_muts) for r in b.result)
        got = sorted((int(reg["branch"][r]), int(reg["mut_idx"][r]),
                      round(float(reg["t_min"][r]), 10),
                      round(float(reg["t_max"][r]), 10), int(reg["mm"][r]))
                     for r in np.nonzero(alive)[0])
        assert got == host, X
        checked += 1
        with_missing += bool(missing)
    # the missing sites change the study (crossings there cost nothing)
    assert checked == 10 and with_missing >= 3 and differs >= 1


# ---------------------------------------------------------------------------
# the graft analysis and the surgery
# ---------------------------------------------------------------------------

# one shape for every tree of the surgery tests: one JAX compile each (the
# fs width generous, as tests/test_spr_miss.py packs it: random trees
# slide many mutations, each adding sibling from-states)
SHAPE = dict(W=420, WR=8, WF_=4 * 210 + 32)
WRB_S = 2 * SHAPE["WR"] + 8
WH_S = 4 * SHAPE["W"]


@pytest.fixture(scope="module")
def jax_pieces():
    return dict(
        start=jax.jit(functools.partial(jm.start_inner_dev, WRB=WRB_S,
                                        WH_=WH_S)),
        finish=jax.jit(jm.finish_dev, static_argnames=("L",)),
        peel=jax.jit(jm.peel_inner_dev), move=jax.jit(jm.move_dev),
        apply=jax.jit(jm.apply_inner_dev))


def _packs(jt, pt, **shape):
    shape = shape or SHAPE
    return jm.pack_tree_miss(jt, **shape), \
        pm.pack_tree_miss(pt, device="cpu", **shape)


def test_start_inner_dev_matches_jax_and_host(jax_pieces):
    """Every inner node's analysis: every field of G equal to JAX's (ints
    exact, floats 1e-12), the host's branch infos, and multi-bi walks."""
    n_multi = n_cases = 0
    for seed in range(3):
        jt, pt = trees(16, 300, seed, 0.12)
        ctx, ja, pa = move_args(jt, 2e-3)
        ctx.begin_move()
        jp, p = _packs(jt, pt)
        for X in inner_nodes(pt):
            G, ok = pm.start_inner_dev(p, X, pa, WRB_S, WH_S)
            jG, jok = jax_pieces["start"](jp, X, ja)
            assert bool(ok) == bool(jok), (seed, X)
            for k, w in jG.items():
                g = G[k].reshape(np.shape(w))
                if g.is_floating_point():
                    _close(g, w, msg=f"{seed} {X} {k}")
                else:
                    _eq(g, w, f"{seed} {X} {k}")
            g = ctx._start_graft_analysis(X)
            ctx._finish_graft_analysis(g)
            assert int(G["n_bi"]) == len(g.branch_infos)
            for k, bi in enumerate(g.branch_infos):
                assert (int(G["A"][k]), int(G["B"][k])) == (bi.A, bi.B)
                assert float(G["plX"][k]) == pytest.approx(
                    bi.partial_lambda_at_X, rel=1e-9, abs=1e-12)
                assert [(int(G["hm_s"][k, i]), float(G["hm_tt"][k, i]))
                        for i in range(int(G["hm_cnt"][k]))] == \
                    [(m.site, m.t) for m in bi.hot_muts_to_X]
            n_multi += int(G["n_bi"]) > 1
            n_cases += 1
    assert n_multi >= 10 and n_cases >= 30


def test_path_and_sibs_matches_jax(reads_case):
    """The junction siblings between X and each of its ancestors (and a
    node off its path: the walk runs to the root), as JAX's."""
    jt, pt, _ctx, _ja, _pa, jp, p = reads_case
    j_path = jax.jit(jm._path_and_sibs)
    for X in inner_nodes(pt)[:12]:
        B, ancestors = X, []
        while B >= 0:
            ancestors.append(B)
            B = int(pt.parent[B])
        for B in ancestors + [inner_nodes(pt)[-1]]:
            sibs, n = pm._path_and_sibs(p, X, B)
            jsibs, jn = j_path(jp, jnp.int32(X), jnp.int32(B))
            assert int(n) == int(jn), (X, B)
            _eq(sibs[:int(n)], np.asarray(jsibs)[:int(n)], f"{X} {B}")


def _valid_targets(tree, X):
    """Branches SS (not root, not in X's subtree) with a regraft window
    below t_X (tests/test_spr_miss.py)."""
    t = tree.t
    sub, stack = set(), [X]
    while stack:
        n = stack.pop()
        sub.add(n)
        c0, c1 = tree.children[n]
        if int(c0) >= 0:
            stack.extend([int(c0), int(c1)])
    P = int(tree.parent[X])
    a, b = tree.children[P]
    S = int(b) if int(a) == X else int(a)
    out = []
    for SS in range(tree.num_nodes):
        if SS in sub or SS == tree.root:
            continue
        GG = int(tree.parent[SS]) if SS != P else int(tree.parent[P])
        lo = float(t[GG]) if GG >= 0 else -np.inf
        hi = min(float(t[SS if SS != P else S]), float(t[X]))
        if hi > lo:
            out.append((SS, lo, hi))
    return out


def test_peel_move_apply_match_jax_and_host(jax_pieces):
    """The graft pipeline on random regrafts: the port's finish, peel,
    move and apply against JAX's (trees equal, fs as maps; 1e-12) and the
    host graft's (trees exact; 1e-9), with the host's proposal injected."""
    rng = np.random.default_rng(77)
    n_cases = 0
    for seed in range(4):
        jt0, pt0 = trees(14, 250, seed + 20, 0.15)
        for trial in range(4):
            jt, pt = jt0.copy(), pt0.copy()
            ctx, ja, pa = move_args(jt, 2e-3)
            hctx = SprContext(pt, 2e-3, np.asarray(ctx.nu),
                              np.asarray(ctx.q), np.asarray(ctx.pi),
                              can_change_root=False)
            hctx.begin_move()
            mu_prop = hctx.mu_jc()
            jp, p = _packs(jt, pt)
            X = int(rng.choice(inner_nodes(pt)))
            targets = [(SS, lo, hi) for (SS, lo, hi)
                       in _valid_targets(pt, X)
                       if float(pt.t[X]) - hi < 120.0]
            if not targets:
                continue
            SS, lo, hi = targets[int(rng.integers(len(targets)))]
            t_new = float(rng.uniform(max(lo, hi - 50.0), hi))
            if not lo < t_new < hi:
                continue
            g_old = hctx.analyze_graft(X)
            hctx.peel_graft(g_old)
            host_peel = pt.copy()
            hctx.move(X, SS, t_new)
            host_move = pt.copy()
            g_new = hctx.propose_new_graft(X, rng)
            hctx.apply_graft(g_new)
            host_apply = pt.copy()

            G, ok = pm.start_inner_dev(p, X, pa, WRB_S, WH_S)
            jG, _ = jax_pieces["start"](jp, X, ja)
            assert bool(ok)
            dG, al = pm.finish_dev(p, G, pa, T([mu_prop]), pt.num_sites)
            jdG, jal = jax_pieces["finish"](jp, jG, ja, F64(mu_prop),
                                            L=pt.num_sites)
            _close(dG, np.reshape(jdG, 1))
            _close(al, np.reshape(jal, 1))
            assert float(dG) == pytest.approx(g_old.delta_log_G, rel=1e-9,
                                              abs=1e-9)
            assert float(al) == pytest.approx(g_old.log_alpha_mut,
                                              rel=1e-9, abs=1e-9)
            p_peel, ok = pm.peel_inner_dev(p, G, pa)
            j_peel, jok = jax_pieces["peel"](jp, jG, ja)
            assert bool(ok) and bool(jok)
            maps_equal(p_peel, j_peel, pt0, "peel")
            host_equal(pm.unpack_tree_miss(p_peel, pt0), host_peel, "peel")
            p_move, ok = pm.move_dev(p_peel, X, SS, t_new, pa)
            j_move, jok = jax_pieces["move"](j_peel, X, SS, F64(t_new), ja)
            assert bool(ok) and bool(jok), (seed, trial)
            maps_equal(p_move, j_move, pt0, "move")
            host_equal(pm.unpack_tree_miss(p_move, pt0), host_move, "move")
            # the new analysis, with the host's proposal injected
            G2, ok = pm.start_inner_dev(p_move, X, pa, WRB_S, WH_S)
            jG2, _ = jax_pieces["start"](j_move, X, ja)
            assert bool(ok) and int(G2["n_bi"]) == len(g_new.branch_infos)
            hm = {k: np.zeros((pm.BI_MAX, WH_S), np.int64)
                  for k in ("hm_s", "hm_f", "hm_t2")}
            hm["hm_s"][:] = -1
            hm["hm_tt"] = np.full((pm.BI_MAX, WH_S), np.inf)
            hm["hm_cnt"] = np.zeros(pm.BI_MAX, np.int64)
            for k, bi in enumerate(g_new.branch_infos):
                for i, m in enumerate(bi.hot_muts_to_X):
                    hm["hm_s"][k, i], hm["hm_f"][k, i] = m.site, m.from_
                    hm["hm_t2"][k, i], hm["hm_tt"][k, i] = m.to, m.t
                hm["hm_cnt"][k] = len(bi.hot_muts_to_X)
            G2 = dict(G2, **{k: T(v) for k, v in hm.items()})
            jG2 = dict(jG2, **{k: jnp.asarray(v.astype(np.int32) if
                                              v.dtype == np.int64 else v)
                               for k, v in hm.items()})
            p_app, ok = pm.apply_inner_dev(p_move, G2, pa)
            j_app, jok = jax_pieces["apply"](j_move, jG2, ja)
            assert bool(ok) and bool(jok)
            out = maps_equal(p_app, j_app, pt0, "apply")
            host_equal(out, host_apply, "apply")
            out.check_integrity()
            n_cases += 1
    assert n_cases >= 8


def _add_from_states(tree, rng, frac):
    """Give each node non-ref from-states at a share of its missing sites
    (the packed state the surgery reads; the tree's likelihood is not
    needed here)."""
    for n in range(tree.num_nodes):
        d = dict(tree.miss_from_states[n])
        for s, e in tree.miss_intervals[n]:
            for site in range(s, e):
                if rng.random() < frac:
                    d[site] = (int(tree.ref_seq[site])
                               + int(rng.integers(1, 4))) % 4
        tree.miss_from_states[n] = d


@pytest.mark.parametrize("tight", [False, True])
def test_move_with_from_states_and_tight_rows_matches_jax(jax_pieces,
                                                          tight):
    """move_dev on trees with from-states at a share of their missing
    sites, to random targets: the ok flag always, the tree (fs as maps)
    where ok.  With from-states the normalisation cascade and the
    un-factoring walk move them; at tight row widths (one run and one fs
    lane to spare) some moves overflow in both packages."""
    rng = np.random.default_rng(11 + tight)
    seen = dict(cascade_fs=0, unfactor_fs=0, rejected=0, n=0)
    cascade, unfactor = pm._cascade, pm._unfactor

    def spy(fn, key):
        def f(pd, *a):
            out = fn(pd, *a)
            seen[key] += not torch.equal(out[3], pd["fsite"])
            return out
        return f
    jmove = jax.jit(jm.move_dev) if tight else jax_pieces["move"]
    try:
        pm._cascade = spy(cascade, "cascade_fs")
        pm._unfactor = spy(unfactor, "unfactor_fs")
        for seed in range(3 if tight else 5):
            jt, pt = trees(14, 250, seed + 50, 0.4)
            _add_from_states(jt, np.random.default_rng(seed), 0.05)
            _add_from_states(pt, np.random.default_rng(seed), 0.05)
            ctx, ja, pa = move_args(jt, 2e-3)
            shape = SHAPE
            if tight:
                shape = dict(W=SHAPE["W"], WR=max(
                    len(iv) for iv in pt.miss_intervals) + 1, WF_=max(
                    len(d) for d in pt.miss_from_states) + 1)
            jp, p = _packs(jt, pt, **shape)
            inner = inner_nodes(pt)
            for trial in range(16 if tight else 12):
                X = int(rng.choice(inner))
                SS, lo, hi = (lambda tg: tg[int(rng.integers(len(tg)))])(
                    _valid_targets(pt, X))
                t_new = float(rng.uniform(max(lo, hi - 50.0), hi))
                if not lo < t_new < hi:
                    continue
                got, ok = pm.move_dev(p, X, SS, t_new, pa)
                want, jok = jmove(jp, X, SS, F64(t_new), ja)
                assert bool(ok) == bool(jok), (seed, trial, X, SS)
                if bool(ok):
                    maps_equal(got, want, pt, f"{seed} {trial}")
                seen["rejected"] += not bool(ok)
                seen["n"] += 1
    finally:
        pm._cascade, pm._unfactor = cascade, unfactor
    if tight:
        assert 0 < seen["rejected"] < seen["n"], seen
    else:
        assert seen["cascade_fs"] >= 3 and seen["unfactor_fs"] >= 2, seen
