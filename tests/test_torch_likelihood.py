"""Port likelihood and coalescent functions against the JAX package on the
same state (rtol 1e-12), and the reference's hand-built fixture
(phylo_tree_calc_tests.cpp) replayed on the port (1e-8)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from delphy_tpu import evo as jevo
from delphy_tpu import pop as jpop
from delphy_tpu import state as jstate
from delphy_tpu.init_tree import build_initial_tree
from delphy_tpu.ops import coalescent as jcoal
from delphy_tpu.ops import likelihood as jlk
from delphy_tpu.phylo import FlatTree, Mutation, NO_NODE
from delphy_tpu.sim import simulate_dataset

from delphy_tpu_torch import convert, evo, pop
from delphy_tpu_torch.ops import coalescent as coal
from delphy_tpu_torch.ops import likelihood as lk

RTOL = 1e-12


def _close(got, want, rtol=RTOL, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def both():
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        20, 300, mu=1e-3, sample_window_days=300.0, missing_fraction=0.05,
        seed=11)
    tree = build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(11))
    ts_j = jstate.pack_state(tree)
    pi = np.array([0.3, 0.2, 0.24, 0.26])
    rng = np.random.default_rng(3)
    nu = rng.gamma(10.0, 0.1, 300)
    e_j = jevo.make_evo_params(300, mu=2e-3, kappa=1.7, pi=pi, alpha=10.0,
                               nu=nu)
    tin, tout = tree.euler_positions()
    return dict(tree=tree, ts_j=ts_j, e_j=e_j,
                ts=convert.tree_state_to_torch(ts_j, device="cpu"),
                e=convert.evo_params_to_torch(e_j, device="cpu"),
                tin_j=jnp.asarray(tin), tout_j=jnp.asarray(tout),
                tin=torch.as_tensor(np.asarray(tin)),
                tout=torch.as_tensor(np.asarray(tout)))


def _all_values(ts, e, tin, tout, lkm, path_delta):
    """Every checked likelihood quantity of one package on one state."""
    rq = lkm.calc_ref_cum_Q(ts, e)
    cnt, nucum = lkm.calc_ref_state_prefix(ts, e)
    dlam, dlam_miss = lkm.calc_branch_delta_lambda(ts, e, rq)
    lam = lkm.calc_lambda_i(ts, e, rq)[0]
    rf = lkm.calc_root_state_frequencies(ts, e, cnt)
    return {"path_sums": lkm.path_sums(ts.parent, path_delta),
            "ref_cum_Q": rq, "cnt_prefix": cnt, "nu_prefix": nucum,
            "dlam_total": dlam, "dlam_miss": dlam_miss, "lambda_i": lam,
            "root_freq": rf,
            "log_root_prior": lkm.calc_log_root_prior(rf, e),
            "log_G": lkm.calc_log_G(ts, e, lam, rf),
            "num_muts": lkm.calc_num_muts(ts),
            "num_muts_ab": lkm.calc_num_muts_ab(ts),
            "T_below": lkm.calc_T_below(ts, tin, tout),
            "Ttwiddle_a": lkm.calc_Ttwiddle_a(ts, e, tin, tout, nucum)}


@pytest.fixture(scope="module")
def values(both):
    b = both
    d = np.random.default_rng(5).normal(size=b["ts"].num_nodes)
    got = _all_values(b["ts"], b["e"], b["tin"], b["tout"], lk,
                      torch.as_tensor(d))
    want = jax.jit(lambda ts, e, tin, tout, d: _all_values(
        ts, e, tin, tout, jlk, d))(b["ts_j"], b["e_j"], b["tin_j"],
                                   b["tout_j"], jnp.asarray(d))
    return got, want


@pytest.mark.parametrize("name", [
    "path_sums", "ref_cum_Q", "cnt_prefix", "nu_prefix", "dlam_total",
    "dlam_miss", "lambda_i", "root_freq", "log_root_prior", "log_G",
    "num_muts", "num_muts_ab", "T_below", "Ttwiddle_a"])
def test_likelihood_matches_jax(values, name):
    got, want = values[0][name], values[1][name]
    if name.startswith("num_muts"):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        # dlam entries cancel to ~0 on mutation-free branches
        _close(got, want, atol=1e-15 if name.startswith("dlam") else 0.0)


@functools.partial(jax.jit, static_argnums=5)
def _jax_grid(p, t, is_tip, t_lo, t_step, C):
    grid = jcoal.make_grid(p, t, is_tip, t_lo, t_step, C)
    return grid, jcoal.calc_log_prior(grid, p, t, is_tip)


@pytest.mark.parametrize("n0,g,mp", [
    (500.0, 0.002, 1.0), (500.0, -0.003, 1.0), (500.0, 0.0, 1.0),
    (500.0, 0.004, 0.0), (0.5, 0.01, 1.0), (2000.0, 0.0, 0.0)])
def test_coalescent_matches_jax(both, n0, g, mp):
    ts, ts_j = both["ts"], both["ts_j"]
    p_j = jpop.ExpPopParams(t0=jnp.float64(0.0), n0=jnp.float64(n0),
                            g=jnp.float64(g), min_pop=jnp.float64(mp))
    p = convert.exp_pop_to_torch(p_j, device="cpu")
    t_lo, t_step, C = -420.0, 2.5, 200
    grid_j, lp_j = _jax_grid(p_j, ts_j.t, ts_j.is_tip, jnp.float64(t_lo),
                             jnp.float64(t_step), C)
    grid = coal.make_grid(p, ts.t, ts.is_tip,
                          torch.tensor(t_lo, dtype=torch.float64),
                          torch.tensor(t_step, dtype=torch.float64), C)
    _close(grid.k_bar, grid_j.k_bar, atol=1e-12)
    _close(grid.popsize_bar, grid_j.popsize_bar)
    _close(grid.cell_lbounds(), grid_j.cell_lbounds())
    _close(coal.calc_log_prior(grid, p, ts.t, ts.is_tip), lp_j)
    tt = torch.linspace(-500.0, 10.0, 37, dtype=torch.float64)
    _close(pop.exp_pop_at_time(p, tt),
           jpop.exp_pop_at_time(p_j, jnp.asarray(tt.numpy())))
    _close(pop.exp_pop_integral(p, tt, tt + 3.0),
           jpop.exp_pop_integral(p_j, jnp.asarray(tt.numpy()),
                                 jnp.asarray(tt.numpy()) + 3.0))


def test_hky_q_matches_jax():
    pi = np.array([0.1, 0.2, 0.3, 0.4])
    _close(evo.hky_q(torch.tensor(2.3, dtype=torch.float64),
                     torch.as_tensor(pi)),
           jevo.hky_q(2.3, jnp.asarray(pi)), atol=1e-16)


# ---------------------------------------------------------------------------
# The reference's 5-node fixture (phylo_tree_calc_tests.cpp:14-116), with the
# expectations of tests/test_reference_fixture.py, evaluated on the port
# ---------------------------------------------------------------------------

A, C_, G, T_ = 0, 1, 2, 3
a, b, c, x, r = 0, 1, 2, 3, 4
NU = np.array([0.2, 0.3, 0.4, 0.5])
PART = np.array([0, 1, 0, 1], dtype=np.int32)
MU_P = np.array([0.1, 1.1])


def _q(base):
    q = np.array(base, dtype=np.float64)
    np.fill_diagonal(q, -q.sum(axis=1))
    return q


Q0 = _q([[0.0, 0.6, 0.7, 0.8], [0.9, 0.0, 1.0, 1.1],
         [1.2, 1.3, 0.0, 1.4], [1.5, 1.6, 1.7, 0.0]])
Q1 = _q([[0.0, 2.6, 2.7, 2.8], [2.9, 0.0, 3.0, 3.1],
         [3.2, 3.3, 0.0, 3.4], [3.5, 3.6, 3.7, 0.0]])


def q_l_ab(l, i, j):
    return (Q0 if PART[l] == 0 else Q1)[i, j]


def mnq(l, s):
    return MU_P[PART[l]] * NU[l] * -q_l_ab(l, s, s)


def mnq_ab(l, i, j):
    return MU_P[PART[l]] * NU[l] * q_l_ab(l, i, j)


def _T_l_a():
    e = np.zeros((4, 4))
    e[0][A] += 0.5; e[0][T_] += 0.5          # noqa: E702
    e[0][T_] += 0.5; e[0][C_] += 0.5         # noqa: E702
    e[0][T_] += 2.0
    e[0][A] += 1.0; e[0][T_] += 1.0; e[0][G] += 2.0  # noqa: E702
    e[1][A] += 1.0
    e[1][A] += 1.0
    e[1][A] += 1.0; e[1][G] += 1.0           # noqa: E702
    e[2][A] += 4.0
    return e


@pytest.fixture(scope="module")
def ref_fixture():
    parent = np.array([x, x, r, r, NO_NODE], dtype=np.int32)
    children = np.full((5, 2), NO_NODE, dtype=np.int32)
    children[x] = [a, b]
    children[r] = [x, c]
    mutations = [[] for _ in range(5)]
    mutations[r] = [Mutation(site=2, from_=C_, to=A, t=-1e30)]
    mutations[x] = [Mutation(site=0, from_=A, to=T_, t=-0.5)]
    mutations[a] = [Mutation(site=0, from_=T_, to=C_, t=0.5)]
    mutations[b] = [Mutation(site=1, from_=A, to=G, t=1.0)]
    mutations[c] = [Mutation(site=0, from_=A, to=T_, t=0.0),
                    Mutation(site=0, from_=T_, to=G, t=1.0)]
    miss_intervals = [[] for _ in range(5)]
    miss_intervals[r] = [(3, 4)]
    miss_intervals[x] = [(2, 3)]
    miss_intervals[c] = [(1, 2)]
    miss_from_states = [{} for _ in range(5)]
    miss_from_states[x] = {2: A}
    tree = FlatTree(parent=parent, children=children,
                    t=np.array([1.0, 2.0, 3.0, 0.0, -1.0]),
                    t_min=np.array([1.0, 2.0, 3.0, -np.inf, -np.inf]),
                    t_max=np.array([1.0, 2.0, 3.0, np.inf, np.inf]),
                    root=r, ref_seq=np.array([A, A, C_, A], dtype=np.int8),
                    mutations=mutations, miss_intervals=miss_intervals,
                    miss_from_states=miss_from_states,
                    name=["a", "b", "c", "x", "r"])
    tree.check_integrity()
    from delphy_tpu_torch.state import pack_state
    ts = pack_state(tree, 16, 8, 8, device="cpu")
    e = evo.make_evo_params(4, mu=1.0, kappa=1.0, alpha=1.0,
                            device="cpu")
    e = e._replace(nu=torch.as_tensor(NU), part=torch.as_tensor(PART),
                   q_tab=torch.as_tensor(np.stack([MU_P[0] * Q0,
                                                   MU_P[1] * Q1])))
    tin, tout = tree.euler_positions()
    return ts, e, torch.as_tensor(np.asarray(tin)), \
        torch.as_tensor(np.asarray(tout))


def test_fixture_num_muts(ref_fixture):
    ts = ref_fixture[0]
    assert int(lk.calc_num_muts(ts)) == 5
    M = lk.calc_num_muts_ab(ts).numpy()
    e = np.zeros((4, 4), dtype=np.int64)
    e[A][T_] += 2
    e[T_][C_] += 1
    e[A][G] += 1
    e[T_][G] += 1
    np.testing.assert_array_equal(M, e)


def test_fixture_T_below_and_Ttwiddle_a(ref_fixture):
    ts, e, tin, tout = ref_fixture
    T_below = lk.calc_T_below(ts, tin, tout).numpy()
    assert T_below[r] == pytest.approx(8.0, abs=1e-8)
    _, nucum = lk.calc_ref_state_prefix(ts, e)
    got = lk.calc_Ttwiddle_a(ts, e, tin, tout, nucum).numpy()
    np.testing.assert_allclose(got, (NU[:, None] * _T_l_a()).sum(axis=0),
                               atol=1e-8)


def test_fixture_lambda_i(ref_fixture):
    ts, e, _, _ = ref_fixture
    lam = lk.calc_lambda_i(ts, e, lk.calc_ref_cum_Q(ts, e))[0].numpy()

    def lam_of(states, present):
        return sum(mnq(l, states[l]) for l in range(4) if present[l])

    exp = {r: lam_of([A, A, A, A], [1, 1, 1, 0]),
           x: lam_of([T_, A, A, A], [1, 1, 0, 0]),
           a: lam_of([C_, A, A, A], [1, 1, 0, 0]),
           b: lam_of([T_, G, A, A], [1, 1, 0, 0]),
           c: lam_of([G, A, A, A], [1, 0, 1, 0])}
    for n, want in exp.items():
        assert lam[n] == pytest.approx(want, abs=1e-8), n


def test_fixture_log_G_below_root(ref_fixture):
    ts, e, _, _ = ref_fixture
    lam = lk.calc_lambda_i(ts, e, lk.calc_ref_cum_Q(ts, e))[0]
    cnt, _ = lk.calc_ref_state_prefix(ts, e)
    rf = lk.calc_root_state_frequencies(ts, e, cnt)
    got = float(lk.calc_log_G(ts, e, lam, rf)) \
        - float(lk.calc_log_root_prior(rf, e))
    want = (-mnq(0, A) * 0.5 + np.log(mnq_ab(0, A, T_)) - mnq(0, T_) * 0.5
            - mnq(0, T_) * 0.5 + np.log(mnq_ab(0, T_, C_)) - mnq(0, C_) * 0.5
            - mnq(0, T_) * 2.0
            - mnq(0, A) * 1.0 + np.log(mnq_ab(0, A, T_))
            - mnq(0, T_) * 1.0 + np.log(mnq_ab(0, T_, G)) - mnq(0, G) * 2.0)
    want += (-mnq(1, A) * 1.0 - mnq(1, A) * 1.0
             - mnq(1, A) * 1.0 + np.log(mnq_ab(1, A, G)) - mnq(1, G) * 1.0)
    want += -mnq(2, A) * 4.0
    assert got == pytest.approx(want, abs=1e-8)


def test_fixed_order_sums_match_the_plain_ops():
    """add_at and cumsum0 (the card's fixed-order scatter-add and scan) give
    the plain ops' values; their CUDA formulations are exercised here on
    the CPU through the same tensor calls."""
    from delphy_tpu_torch.ops.likelihood import add_at, cumsum0
    g = torch.Generator().manual_seed(5)
    x = torch.randn(4, dtype=torch.float64, generator=g)
    idx = torch.randint(0, 4, (3000,), generator=g)
    vals = torch.randn(3000, dtype=torch.float64, generator=g) * 1e3
    assert torch.equal(add_at(x, idx, vals), x.index_add(0, idx, vals))
    assert torch.equal(x.index_put((idx,), vals, accumulate=True),
                       x.index_add(0, idx, vals))
    v = torch.randn(50_000, dtype=torch.float64, generator=g)
    assert torch.equal(cumsum0(v), torch.cumsum(v, 0))
    assert torch.equal(torch.cumsum(torch.stack([v, v], 1), 0)[:, 0],
                       torch.cumsum(v, 0))
