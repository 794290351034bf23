"""The port's skygrid population model against the JAX package's on the same
numpy-seeded inputs: the pop functions and priors (rtol 1e-12), the HMC
potential and its autograd gradient (1e-10), the tau, zero-mode and HMC
moves fed the JAX moves' own draws (1e-10; HMC 1e-8 after its 25 leapfrog
steps), and the sweep chain's skygrid log N(t): a log-linear skygrid on an
exponential curve runs the exponential chain's moves (JAX twin, 1e-9), and a
staircase move's log-prior delta is vsc_device.displace_delta's (1e-12)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from delphy_tpu import pop as jpop
from delphy_tpu import state as jstate
from delphy_tpu.init_tree import build_initial_tree
from delphy_tpu.mcmc import global_moves as jgm
from delphy_tpu.mcmc.global_moves import PriorConfig as JPriorConfig
from delphy_tpu.mcmc.kernel import run_global_moves as j_run_global_moves
from delphy_tpu.ops import coalescent as jcoal
from delphy_tpu.parallel import block_pallas as jbp
from delphy_tpu.parallel import vsc_device as jvsc
from delphy_tpu.parallel.sweep import (SweepShared as JSweepShared,
                                       build_part_ctx as j_build_part_ctx)
from delphy_tpu.run import Run as JRun
from delphy_tpu.sim import simulate_dataset

from delphy_tpu_torch import convert, pop
from delphy_tpu_torch.mcmc import global_moves as gm
from delphy_tpu_torch.mcmc.global_moves import PriorConfig
from delphy_tpu_torch.ops import coalescent as coal
from delphy_tpu_torch.parallel import block_cuda as bc

TYPES = {"staircase": pop.STAIRCASE, "log-linear": pop.LOG_LINEAR}
F64 = torch.float64


def T(x):
    a = np.asarray(x)
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(a.astype(np.float64))
    return torch.as_tensor(a.copy())


def _close(got, want, rtol=1e-12, atol=0.0, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _pops(type_, seed=0, M=9, lo=-300.0, hi=0.0):
    """(JAX, port) skygrid pops with random knots and values."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(lo, hi, M + 1))
    g = rng.normal(5.0, 1.5, M + 1)
    tau = rng.uniform(0.5, 3.0)
    p_j = jpop.SkygridPopParams(x=jnp.asarray(x), gamma=jnp.asarray(g),
                                type=type_, tau=jnp.float64(tau))
    return p_j, convert.skygrid_pop_to_torch(p_j, device="cpu")


@pytest.fixture(scope="module")
def tree_state():
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        20, 200, mu=1e-3, sample_window_days=300.0, seed=13)
    tree = build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(13))
    ts_j = jstate.pack_state(tree)
    return ts_j, convert.tree_state_to_torch(ts_j, device="cpu")


# ---------------------------------------------------------------------------
# pop functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(TYPES))
def test_skygrid_log_N_matches_jax(name):
    p_j, p = _pops(TYPES[name])
    x = np.asarray(p_j.x)
    rng = np.random.default_rng(1)
    # before x_0, after x_M, exactly on every knot, and in between
    t = np.concatenate([[x[0] - 50.0, x[-1] + 50.0], x,
                        rng.uniform(x[0] - 10.0, x[-1] + 10.0, 40)])
    want = jpop.skygrid_log_N(p_j, jnp.asarray(t))
    _close(pop.skygrid_log_N(p, T(t)), want)
    _close(pop.pop_at_time(p, T(t)), jpop.pop_at_time(p_j, jnp.asarray(t)))
    # scalars broadcast too
    assert float(pop.skygrid_log_N(p, float(x[3]))) == float(want[5])


def _intervals(x):
    """[a, b] inside one interval, across one knot, across many, wholly
    before x_0 and after x_M, and spanning everything."""
    mid = 0.5 * (x[:-1] + x[1:])
    a = np.concatenate([mid[:3] - 1e-3, mid[:3], [x[0] - 40.0, x[-1] + 1.0,
                                                  x[0] - 5.0, mid[2]]])
    b = np.concatenate([mid[:3] + 1e-3, mid[1:4], [x[0] - 1.0, x[-1] + 30.0,
                                                   x[-1] + 5.0, mid[7]]])
    return a, b


@pytest.mark.parametrize("fn", ["pop_integral", "intensity_integral"])
@pytest.mark.parametrize("name", list(TYPES))
def test_skygrid_integrals_match_jax(name, fn):
    p_j, p = _pops(TYPES[name], seed=2)
    a, b = _intervals(np.asarray(p_j.x))
    want = jax.vmap(lambda u, v: getattr(jpop, fn)(p_j, u, v))(
        jnp.asarray(a), jnp.asarray(b))
    _close(getattr(pop, fn)(p, T(a), T(b)), want)


@pytest.mark.parametrize("name", list(TYPES))
def test_render_population_curve_matches_jax(name):
    p_j, p = _pops(TYPES[name], seed=3)
    host = pop.SkygridPopParams(x=np.asarray(p_j.x),
                                gamma=np.asarray(p_j.gamma), type=p.type,
                                tau=np.float64(p_j.tau))
    _close(pop.render_population_curve(host, -350.0, 20.0, 37),
           jpop.render_population_curve(p_j, -350.0, 20.0, 37))


@functools.partial(jax.jit, static_argnums=5)
def _jax_grid(p, t, is_tip, t_lo, t_step, C):
    grid = jcoal.make_grid(p, t, is_tip, t_lo, t_step, C)
    return grid, jcoal.calc_log_prior(grid, p, t, is_tip)


def _grid_pair(p_j, p, tree_state, C=120):
    ts_j, ts = tree_state
    t_lo, t_step = -450.0, 460.0 / C
    grid_j, lp_j = _jax_grid(p_j, ts_j.t, ts_j.is_tip, jnp.float64(t_lo),
                             jnp.float64(t_step), C)
    grid = coal.make_grid(p, ts.t, ts.is_tip, torch.tensor(t_lo, dtype=F64),
                          torch.tensor(t_step, dtype=F64), C)
    return grid_j, lp_j, grid


@pytest.mark.parametrize("name", list(TYPES))
def test_skygrid_coalescent_prior_matches_jax(name, tree_state):
    p_j, p = _pops(TYPES[name], seed=4, M=12, lo=-420.0, hi=0.0)
    grid_j, lp_j, grid = _grid_pair(p_j, p, tree_state)
    _close(grid.popsize_bar, grid_j.popsize_bar)
    _close(coal.calc_popsize_bars(p, grid.t_lo, grid.t_step, 120),
           grid_j.popsize_bar)
    _close(grid.k_bar, grid_j.k_bar, atol=1e-12)
    ts = tree_state[1]
    _close(coal.calc_log_prior(grid, p, ts.t, ts.is_tip), lp_j)


@pytest.mark.parametrize("barrier", [True, False])
@pytest.mark.parametrize("name", list(TYPES))
def test_gmrf_and_other_priors_match_jax(name, barrier):
    p_j, p = _pops(TYPES[name], seed=5)
    # some gammas below the barrier's location
    p_j = p_j._replace(gamma=p_j.gamma - 5.5)
    p = p._replace(gamma=p.gamma - 5.5)
    for tau_move in (True, False):
        hyp = dict(skygrid_low_gamma_barrier_enabled=barrier,
                   skygrid_tau_move_enabled=tau_move,
                   skygrid_inv_nbar_prior_alpha=2.5,
                   skygrid_inv_nbar_prior_beta=300.0)
        _close(gm.calc_skygrid_gmrf_prior(p, PriorConfig(**hyp)),
               jgm.calc_skygrid_gmrf_prior(p_j, JPriorConfig(**hyp)))
        e_j = _evo_j()
        _close(gm.calc_log_other_priors(
            convert.evo_params_to_torch(e_j, device="cpu"), p,
            PriorConfig(**hyp)),
            jgm.calc_log_other_priors(e_j, p_j, JPriorConfig(**hyp)))


def _evo_j(L=50, seed=6):
    from delphy_tpu.evo import make_evo_params
    rng = np.random.default_rng(seed)
    return make_evo_params(L, mu=1.3e-3, kappa=2.1, pi=(0.3, 0.2, 0.2, 0.3),
                           alpha=rng.uniform(0.3, 4.0),
                           nu=rng.gamma(2.0, 0.5, L))


def test_log_other_priors_alpha_nu_matches_jax():
    e_j = _evo_j(L=300, seed=8)
    p_j = jpop.ExpPopParams(t0=jnp.float64(0.0), n0=jnp.float64(700.0),
                            g=jnp.float64(0.003), min_pop=jnp.float64(1.0))
    _close(gm.calc_log_other_priors(
        convert.evo_params_to_torch(e_j, device="cpu"),
        convert.exp_pop_to_torch(p_j, device="cpu"), PriorConfig()),
        jgm.calc_log_other_priors(e_j, p_j, JPriorConfig()))


# ---------------------------------------------------------------------------
# HMC potential, and the moves from replayed JAX draws
# ---------------------------------------------------------------------------

def _jax_potential(p, grid, t, is_tip, hyp):
    """U of the JAX package's skygrid_hmc_move (global_moves.py:323-338),
    which is a closure there, built from its functions."""
    lbs = grid.cell_lbounds()

    def U(gamma):
        q = p._replace(gamma=gamma)
        nbar = jax.vmap(lambda a: jpop.skygrid_pop_integral(
            q, a, a + grid.t_step))(lbs) / grid.t_step
        nbar = jnp.maximum(nbar, 1e-100)
        u = jnp.sum(grid.t_step * grid.k_bar * (grid.k_bar - 1.0)
                    / (2.0 * nbar))
        logN = jpop.skygrid_log_N(q, t)
        u += jnp.sum(jnp.where(is_tip, 0.0, logN))
        dg = gamma[1:] - gamma[:-1]
        u += 0.5 * p.tau * jnp.sum(dg ** 2)
        if hyp.skygrid_low_gamma_barrier_enabled:
            excess = jnp.maximum(hyp.skygrid_low_gamma_barrier_loc - gamma,
                                 0.0)
            u += jnp.sum((excess / hyp.skygrid_low_gamma_barrier_scale) ** 2)
        gamma_bar = jnp.mean(gamma)
        return u + (hyp.skygrid_inv_nbar_prior_alpha * gamma_bar
                    + hyp.skygrid_inv_nbar_prior_beta * jnp.exp(-gamma_bar))
    return U


HMC_HYP = dict(skygrid_inv_nbar_prior_alpha=1.5,
               skygrid_inv_nbar_prior_beta=200.0,
               skygrid_low_gamma_barrier_loc=3.0)


@pytest.fixture(scope="module", params=list(TYPES))
def hmc_case(request, tree_state):
    """A skygrid over the tree's span with its grid, on both sides."""
    ts_j, ts = tree_state
    p_j, p = _pops(TYPES[request.param], seed=9, M=14, lo=-430.0, hi=0.0)
    grid_j, _lp, grid = _grid_pair(p_j, p, tree_state)
    return dict(p_j=p_j, p=p, grid_j=grid_j, grid=grid, ts_j=ts_j, ts=ts,
                type=request.param)


def test_hmc_potential_and_gradient_match_jax(hmc_case):
    c = hmc_case
    rng = np.random.default_rng(10)
    U_j = _jax_potential(c["p_j"], c["grid_j"], c["ts_j"].t,
                         c["ts_j"].is_tip, JPriorConfig(**HMC_HYP))
    U = gm.skygrid_hmc_potential(c["p"], c["grid"], c["ts"].t,
                                 c["ts"].is_tip, PriorConfig(**HMC_HYP))
    for _ in range(3):
        g = np.asarray(c["p_j"].gamma) + rng.normal(0.0, 0.5, 15)
        _close(U(T(g)), jax.jit(U_j)(jnp.asarray(g)), rtol=1e-10)
        _close(gm.grad_of(U, T(g)), jax.jit(jax.grad(U_j))(jnp.asarray(g)),
               rtol=1e-10, atol=1e-12)


def test_hmc_move_from_replayed_draws(hmc_case):
    c = hmc_case
    hyp_j = JPriorConfig(**HMC_HYP)
    move = jax.jit(jgm.skygrid_hmc_move, static_argnames=("hyp",))
    changed = 0
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = move(key, c["p_j"], c["grid_j"], c["ts_j"].t,
                    c["ts_j"].is_tip, hyp=hyp_j)
        # the JAX move's own draws, split as it splits them
        _key, k_p, k_dt, k_acc = jax.random.split(key, 4)
        z = jax.random.normal(k_p, (15,), jnp.float64)
        e = jax.random.exponential(k_dt, dtype=jnp.float64)
        u = jax.random.uniform(k_acc, (), jnp.float64, 1e-300, 1.0)
        got = gm.skygrid_hmc_core(c["p"], c["grid"], c["ts"].t,
                                  c["ts"].is_tip, PriorConfig(**HMC_HYP),
                                  T(z), T(e), T(u))
        _close(got.gamma, want.gamma, rtol=1e-8, atol=1e-8)
        changed += not np.array_equal(np.asarray(want.gamma),
                                      np.asarray(c["p_j"].gamma))
    assert changed >= 2      # accepted trajectories were compared


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tau_move_from_replayed_draws(seed):
    p_j, p = _pops(pop.STAIRCASE, seed=seed)
    hyp_j = JPriorConfig()
    key = jax.random.PRNGKey(seed)
    want = jgm.skygrid_tau_move(key, p_j, hyp_j)
    shape = hyp_j.skygrid_tau_prior_alpha + 0.5 * 9
    g = jax.random.gamma(key, shape, dtype=jnp.float64)
    got = gm.skygrid_tau_core(p, PriorConfig(), T(g))
    _close(got.tau, want.tau, rtol=1e-10)
    assert float(want.tau) != float(p_j.tau)


@pytest.mark.parametrize("barrier_loc", [0.0, 6.0])
def test_zero_mode_move_from_replayed_draws(hmc_case, barrier_loc):
    """With the barrier's location below every gamma the MH correction is
    0; at 6.0 it is not."""
    c = hmc_case
    hyp = dict(skygrid_inv_nbar_prior_alpha=1.0,
               skygrid_inv_nbar_prior_beta=50.0,
               skygrid_low_gamma_barrier_loc=barrier_loc)
    n_inner = c["ts"].num_nodes - c["ts"].num_tips
    for seed in range(3):
        key = jax.random.PRNGKey(100 + seed)
        want = jgm.skygrid_zero_mode_gibbs_move(key, c["p_j"], c["grid_j"],
                                                n_inner, JPriorConfig(**hyp))
        k_g, k_acc = jax.random.split(key)
        g = jax.random.gamma(k_g, n_inner + 1.0, dtype=jnp.float64)
        u = jax.random.uniform(k_acc, (), jnp.float64, 1e-300, 1.0)
        got = gm.skygrid_zero_mode_core(c["p"], c["grid"],
                                        PriorConfig(**hyp), T(g), T(u))
        _close(got.gamma, want.gamma, rtol=1e-10)


def test_sample_gamma_draws_from_the_gamma_distribution():
    """The wrappers' Gamma(shape, 1) sampler: mean and variance at a shape
    below 1 (the boost) and above it, and its scalar stream unchanged by the
    vector form (a scalar shape with size () is the main path's mu draw)."""
    gen = torch.Generator()
    for shape in (0.4, 3.0, 250.0):
        gen.manual_seed(1)
        x = gm.sample_gamma(gen, shape, size=(20000,))
        assert float(x.mean()) == pytest.approx(shape, rel=0.03)
        assert float(x.var()) == pytest.approx(shape, rel=0.08)
    gen.manual_seed(2)
    a = gm.sample_gamma(gen, torch.tensor(3.0, dtype=F64))
    gen.manual_seed(2)
    x = torch.randn(16, generator=gen, dtype=F64)
    u = torch.rand(16, generator=gen, dtype=F64)
    d = 3.0 - 1.0 / 3.0
    v = (1.0 + 1.0 / np.sqrt(9.0 * d) * x) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(v))
    assert float(a) == float(d * v[int(torch.argmax(ok.int()))])


# ---------------------------------------------------------------------------
# The sweep chain's skygrid log N(t)
# ---------------------------------------------------------------------------

def _tree(seed):
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        20, 300, mu=1e-3, sample_window_days=300.0, missing_fraction=0.02,
        seed=seed)
    return build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(seed))


@pytest.fixture(scope="module")
def jax_boundary():
    """A JAX exponential-model boundary up to the sweep, packed as the JAX
    chain's 128-lane padded rows, and its pop."""
    run = JRun(_tree(31), seed=31, num_cells=200, device_partitions=4,
               topology_moves_enabled=False)
    ts, evo, pop_params, grid, caches, ledger, key, stats = jax.jit(
        j_run_global_moves, static_argnames=("hyp", "num_cells"))(
        run.ts, run.evo, run.pop, run.key, run.tin, run.tout,
        run.t_max_tip, run.hyp, run.num_cells)
    pm = run.pm
    t_p = ts.t[jnp.maximum(pm.node_map, 0)]
    k_p = jax.vmap(jvsc.calc_k_bar_signed, in_axes=(0, 0, None, None, None))(
        t_p, pm.sign, grid.t_lo, grid.t_step, run.num_cells)
    active = jvsc.active_cells(pm.part_t_lo, pm.part_t_hi, grid.t_lo,
                               grid.t_step, run.num_cells)
    fields = jvsc.sample_fields(jax.random.PRNGKey(5), k_p, active,
                                grid.popsize_bar, grid.t_step)
    ctx = j_build_part_ctx(pm, ts, caches, evo, fields.b,
                           salt=jnp.int32(987654321))
    mut_t_p = ts.mut_t[jnp.maximum(pm.mut_map, 0)]
    sh = JSweepShared(A=fields.A, popsize_bar=grid.popsize_bar,
                      t_lo=grid.t_lo, t_step=grid.t_step,
                      t_max_tip=jnp.asarray(run.t_max_tip, t_p.dtype))
    stat, ctx_arrs, shared = jbp.pack_chain_inputs(ctx, sh, pop_params, k_p,
                                                   t_p, mut_t_p, cpb=16)
    return stat, ctx_arrs, shared, pop_params


def _uniforms(P, NB, stat, seed):
    rng = np.random.default_rng(seed)
    return jbp.BlockUniforms(
        pri=rng.uniform(size=(P, NB, stat.NC)),
        prop=rng.uniform(size=(P, NB, stat.NC)),
        acc=rng.uniform(size=(P, NB, stat.NC)),
        ref_u=rng.uniform(size=(P, NB, stat.MC)),
        ref_acc=rng.uniform(size=(P, NB, stat.NC)),
        sc=rng.uniform(size=(P, NB, 128)),
        norm=rng.normal(size=(P, NB, 128)))


def test_loglinear_skygrid_on_an_exp_curve_is_the_exp_chain(jax_boundary):
    """gamma_k = log n0 + g (x_k - t0) on knots spanning every node time and
    the grid: the skygrid chain makes the exponential chain's moves."""
    stat_j, ctx_arrs, shared, pop_j = jax_boundary
    P, NB = ctx_arrs["t"].shape[0], 16
    u_np = _uniforms(P, NB, stat_j, 17)
    want = jax.jit(jbp.sweep_chain_jnp, static_argnames=("stat",))(
        stat_j, NB, ctx_arrs, shared,
        jbp.BlockUniforms(*map(jnp.asarray, u_np)))
    n0, g, t0 = (float(pop_j.n0), float(pop_j.g), float(pop_j.t0))
    t_lo = float(shared["t_lo"])
    x = np.linspace(t_lo - 50.0, float(shared["t_max_tip"]) + 50.0, 181)
    gamma = np.log(n0) + g * (x - t0)
    assert gamma.min() > float(shared["log_min_pop"]) + 1.0   # not binding
    ctx = {k: T(v) for k, v in ctx_arrs.items()}
    sh_exp = {k: T(v) for k, v in shared.items()}
    sh_sky = {k: sh_exp[k] for k in ("A", "nbar", "t_lo", "t_step",
                                     "t_max_tip")}
    sh_sky.update(x=T(x), gamma=T(gamma))
    stat = bc.ChainStatics(NC=stat_j.NC, MC=stat_j.MC, C=stat_j.C,
                           C_real=stat_j.C_real, cpb=stat_j.cpb)
    u = bc.BlockUniforms(*map(T, u_np))
    exp_out = bc.sweep_chain_torch(stat, NB, ctx, sh_exp, u)
    sky_out = bc.sweep_chain_kernel(stat._replace(pop=pop.LOG_LINEAR), NB,
                                    ctx, sh_sky, u)
    for other in (exp_out, want):
        for n, a, b in zip(("t", "mut_t", "k_p", "dG", "dC", "cnt"),
                           sky_out, other):
            a, b = a.numpy().reshape(-1), np.asarray(b).reshape(-1)
            if n == "cnt":
                np.testing.assert_array_equal(a, b)
            elif n in ("t", "mut_t", "k_p"):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-9,
                                           err_msg=n)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12,
                                           err_msg=n)
    assert float(sky_out[5].sum()) > 50


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_staircase_chain_delta_is_vsc_displace_delta(jax_boundary, seed):
    """One block of the plain chain with only its single inner-node move
    (no batched selection, the move accepted whenever in bounds) under a
    staircase skygrid: its dC and k_p are JAX's pop-generic
    vsc_device.displace_delta with a SkygridPopParams."""
    stat_j, ctx_arrs, shared, _pop = jax_boundary
    P = ctx_arrs["t"].shape[0]
    rng = np.random.default_rng(seed)
    t_lo, t_max = float(shared["t_lo"]), float(shared["t_max_tip"])
    x = np.sort(rng.uniform(t_lo, t_max, 8))
    gamma = rng.normal(6.0, 1.0, 8)
    u_np = _uniforms(P, 1, stat_j, 40 + seed)
    sc = u_np.sc.copy()
    sc[..., 0] = 0.1           # an inner-node move
    sc[..., 4] = 1e-300        # accepted whenever in bounds
    u_np = u_np._replace(pri=np.full_like(u_np.pri, -1.0), sc=sc)
    ctx = {k: T(v) for k, v in ctx_arrs.items()}
    sh = {k: T(shared[k]) for k in ("A", "nbar", "t_lo", "t_step",
                                    "t_max_tip")}
    sh.update(x=T(x), gamma=T(gamma))
    stat = bc.ChainStatics(NC=stat_j.NC, MC=stat_j.MC, C=stat_j.C,
                           C_real=stat_j.C_real, cpb=stat_j.cpb,
                           pop=pop.STAIRCASE)
    t_new, _mut, kp_new, _dG, dC, _cnt = bc.sweep_chain_torch(
        stat, 1, ctx, sh, bc.BlockUniforms(*map(T, u_np)))
    p_j = jpop.SkygridPopParams(x=jnp.asarray(x), gamma=jnp.asarray(gamma),
                                type=pop.STAIRCASE, tau=jnp.float64(1.0))
    t0 = np.asarray(ctx_arrs["t"]).reshape(P, -1)
    t1 = t_new.numpy().reshape(P, -1)
    moved = 0
    for p in range(P):
        nodes = np.nonzero(t1[p] != t0[p])[0]
        if len(nodes) == 0:
            assert float(dC[p]) == 0.0
            continue
        (n,) = nodes
        C, Cr = stat_j.C, stat_j.C_real      # padded and live cells
        delta, k_new = jvsc.displace_delta(
            jnp.asarray(ctx_arrs["k_p"]).reshape(P, C)[p, :Cr],
            jnp.asarray(ctx_arrs["b"]).reshape(P, C)[p, :Cr],
            jnp.asarray(shared["A"]).reshape(C)[:Cr],
            jnp.asarray(shared["nbar"]).reshape(C)[:Cr], shared["t_lo"],
            shared["t_step"], p_j, t0[p, n], t1[p, n], False)
        assert float(dC[p]) == pytest.approx(float(delta), rel=1e-12,
                                             abs=1e-12)
        np.testing.assert_allclose(kp_new.numpy().reshape(P, C)[p, :Cr],
                                   np.asarray(k_new), rtol=0, atol=1e-12)
        moved += 1
    assert moved >= 1
