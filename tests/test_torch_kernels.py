"""The port's three chains against the JAX package's twins on the same inputs
and the same uniforms, in f64: hky_chain_torch vs hky_chain_jnp,
exp_pop_chain_torch vs exp_pop_chain_jnp, sweep_chain_torch vs
sweep_chain_jnp.  On the CPU the wrappers (``*_kernel``) run these plain
versions; the CUDA kernels themselves are held against them on the card
(tests/test_torch_cuda.py, chip_smoke.py).

The JAX twins use series expm1/log1p below |x| = 1e-3 (relative error up to
~3e-10); the port uses the library functions, hence the tolerances."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from delphy_tpu import pop as jpop
from delphy_tpu.evo import make_evo_params as j_make_evo
from delphy_tpu.init_tree import build_initial_tree
from delphy_tpu.mcmc.global_moves import PriorConfig as JPriorConfig
from delphy_tpu.mcmc.kernel import run_global_moves as j_run_global_moves
from delphy_tpu.ops import coalescent as jcoal
from delphy_tpu.parallel import block_pallas as jbp
from delphy_tpu.parallel import hky_pallas as jhp
from delphy_tpu.parallel import pop_pallas as jpp
from delphy_tpu.parallel import vsc_device as jvsc
from delphy_tpu.parallel.sweep import (SweepShared as JSweepShared,
                                       build_part_ctx as j_build_part_ctx)
from delphy_tpu.run import Run as JRun
from delphy_tpu.sim import simulate_dataset

from delphy_tpu_torch import convert
from delphy_tpu_torch.mcmc import global_moves as gm
from delphy_tpu_torch.mcmc.kernel import run_global_moves
from delphy_tpu_torch.ops import likelihood as lk
from delphy_tpu_torch.ops.coalescent import CoalGrid
from delphy_tpu_torch.parallel import block_cuda as bc
from delphy_tpu_torch.parallel import hky_cuda, pop_cuda, vsc_device as vsc
from delphy_tpu_torch.parallel.sweep import prepare_sweep, scatter_deltas
from delphy_tpu_torch.run import Run


def T(x):
    """numpy/jax array -> torch tensor (f64 for floats)."""
    a = np.asarray(x)
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(a.astype(np.float64))
    return torch.as_tensor(a.copy())


# ---------------------------------------------------------------------------
# K1: HKY chain
# ---------------------------------------------------------------------------

def _hky_inputs(seed, state=None):
    """(u, evo, tt, M, rf) from ``seed``; ``state`` moves the start where the
    kernel's guards matter: pi at the simplex edge (some frequency
    proposals leave (0, 1)), a zero column of M with zero root
    frequencies, or kappa far from the prior mean."""
    rng = np.random.default_rng(seed)
    pi = np.array([0.004, 0.332, 0.332, 0.332]) if state == "pi_edge" \
        else np.array([0.3, 0.2, 0.25, 0.25])
    kappa = {"kappa_0.05": 0.05, "kappa_200": 200.0}.get(state, 1.7)
    evo = j_make_evo(100, mu=1e-3, kappa=kappa, pi=pi, alpha=10.0)
    tt = rng.uniform(1e4, 1e5, 4)
    M = np.where(~np.eye(4, dtype=bool), rng.integers(0, 200, (4, 4)), 0.0)
    rf = rng.integers(0, 40, 4).astype(np.float64)
    if state == "M_zero_column":
        M[:, 2] = 0.0
        rf[[0, 3]] = 0.0
    u = rng.uniform(size=(10, 128))
    return u, evo, tt, M, rf


@pytest.mark.parametrize("seed,state", [
    (0, None), (4, None), (9, None), (1, "pi_edge"), (2, "M_zero_column"),
    (3, "kappa_0.05"), (5, "kappa_200")],
    ids=["0", "4", "9", "pi_edge", "M_zero_column", "kappa_0.05",
         "kappa_200"])
def test_hky_chain_matches_jax_twin(seed, state):
    u, evo, tt, M, rf = _hky_inputs(seed, state)
    hyp = JPriorConfig()
    hypf = (float(hyp.kappa_prior_mean_log), float(hyp.kappa_prior_sigma_log))
    # the JAX twin's two extra flags switch its moves on; the port always
    # runs both
    want = jhp.hky_chain_jnp(jnp.asarray(u), evo.mu, evo.kappa,
                             evo.pi.reshape(1, 4), jnp.asarray(tt).reshape(1, 4),
                             jnp.asarray(M), jnp.asarray(rf).reshape(1, 4),
                             hypf + (True, True), 10)
    args = (T(u), T(evo.mu), T(evo.kappa), T(evo.pi).reshape(1, 4),
            T(tt).reshape(1, 4), T(M), T(rf).reshape(1, 4), hypf, 10)
    got = hky_cuda.hky_chain_kernel(*args)      # CPU tensors: plain version
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-15)
    # the chain moved, and q stays a proper rate matrix
    assert float(got[0]) != pytest.approx(float(evo.kappa))
    np.testing.assert_allclose(got[2].sum(1).numpy(), 0.0, atol=1e-12)
    if state == "pi_edge":      # a proposal took pi_A out of (0, 1)
        ia = np.floor(u[:, 1] * 4.0)
        ib = (ia + 1 + np.floor(u[:, 2] * 3.0)) % 4
        assert np.any((ib == 0) & (u[:, 0] * 0.01 > 0.004))


def _np_hky_r(kappa):
    a, b = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    return np.where((a != b) & (a % 2 == b % 2), kappa, 0.0) \
        + np.where(a % 2 != b % 2, 1.0, 0.0)


def _np_hky_q(kappa, pi):
    """evo.hky_q in numpy: q_ab = r_ab pi_b / R, R = pi r pi, q_aa = -row
    sum."""
    r = _np_hky_r(kappa)
    q = r * pi[None, :] / (pi @ r @ pi)
    return q - np.diag(q.sum(1))


@pytest.mark.parametrize("move", ["frequency", "kappa"])
def test_hky_folded_log_ratio_identities(move):
    """The identities csrc/hky_chain.cu folds the HKY log-likelihood ratio
    with: per-entry sum over hky_q's rates against the folded form (W_ia,
    W_ib, M_tot, M_ts and the closed forms of R and of the diagonal sum D),
    on random states with zero entries of M and rf."""
    rng = np.random.default_rng(11 if move == "frequency" else 12)
    off = ~np.eye(4, dtype=bool)
    transition = off & (np.arange(4)[:, None] % 2 == np.arange(4) % 2)

    def closed(kappa, p, tt):
        y, z = p[0] + p[2], p[1] + p[3]
        R = 2.0 * (kappa * (p[0] * p[2] + p[1] * p[3]) + y * z)
        D = (kappa * (tt[0] * p[2] + tt[2] * p[0] + tt[1] * p[3]
                      + tt[3] * p[1])
             + (tt[0] + tt[2]) * z + (tt[1] + tt[3]) * y)
        return R, D / R

    for _ in range(500):
        pi = rng.dirichlet(np.ones(4))
        kappa = float(np.exp(rng.normal(1.0, 1.25)))
        mu, tt = 10 ** rng.uniform(-4, -2), rng.uniform(1e3, 1e5, 4)
        M = np.where(off & (rng.uniform(size=(4, 4)) < 0.7),
                     rng.integers(0, 200, (4, 4)), 0.0)
        rf = np.where(rng.uniform(size=4) < 0.7, rng.integers(0, 40, 4), 0.0)
        Mpos = off & (M > 0)
        m_tot = M[Mpos].sum()
        if move == "frequency":
            ia = rng.integers(4)
            ib = (ia + 1 + rng.integers(3)) % 4
            d = rng.uniform(0.0, 0.01)
            if not (pi[ib] - d > 0.0):
                continue
            new_pi, new_kappa = pi.copy(), kappa
            new_pi[ia] += d
            new_pi[ib] -= d
        else:
            new_pi, new_kappa = pi, kappa * rng.uniform(0.75, 1.0 / 0.75)
        q, new_q = _np_hky_q(kappa, pi), _np_hky_q(new_kappa, new_pi)
        plain = (-mu * np.sum((-np.diag(new_q) + np.diag(q)) * tt)
                 + np.sum(M[Mpos] * np.log(new_q[Mpos] / q[Mpos]))
                 + np.sum(np.where(rf > 0, rf * np.log(new_pi / pi), 0.0)))
        R, DR = closed(kappa, pi, tt)
        R_new, DR_new = closed(new_kappa, new_pi, tt)
        np.testing.assert_allclose(R, pi @ _np_hky_r(kappa) @ pi, rtol=1e-14)
        fold = -m_tot * np.log(R_new / R) - mu * (DR_new - DR)
        if move == "frequency":
            W = np.where(Mpos, M, 0.0).sum(0) + np.maximum(rf, 0.0)
            fold += (W[ia] * np.log1p(d / pi[ia])
                     + W[ib] * np.log1p(-d / pi[ib]))
        else:
            fold += M[Mpos & transition].sum() * np.log(new_kappa / kappa)
        assert abs(fold - plain) < 1e-11, (move, fold, plain)


# ---------------------------------------------------------------------------
# K2: exp-pop chain
# ---------------------------------------------------------------------------

def _pop_grid(seed, C=96, N=40):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(-300.0, 0.0, N))
    is_tip = np.zeros(N, bool)
    is_tip[rng.permutation(N)[: N // 2 + 1]] = True
    p = jpop.ExpPopParams(t0=jnp.float64(0.0), n0=jnp.float64(500.0),
                          g=jnp.float64(0.002), min_pop=jnp.float64(1.0))
    grid = jcoal.make_grid(p, jnp.asarray(t), jnp.asarray(is_tip),
                           jnp.float64(-400.0), jnp.float64(5.0), C)
    return grid, jnp.asarray(t), jnp.asarray(is_tip), p


@pytest.mark.parametrize("n0,g,mp", [
    (500.0, 0.002, 1.0), (500.0, -0.003, 1.0), (500.0, 0.0, 1.0),
    (500.0, 0.004, 0.0), (0.5, 0.01, 1.0), (2000.0, 0.0, 0.0)])
def test_exp_pop_lp_rows_matches_jax(n0, g, mp):
    grid, t, is_tip, _ = _pop_grid(7)
    rows = jpp.pack_rows(grid, t, is_tip, jnp.float64)
    want = jax.jit(jpp._lp_rows)(*rows, grid.t_step, jnp.float64(0.0),
                        jnp.float64(mp), jnp.float64(n0), jnp.float64(g))
    f = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    got = pop_cuda.lp_rows(*[T(a) for a in rows], T(grid.t_step), f(0.0),
                           f(mp), f(n0), f(g))
    assert float(got) == pytest.approx(float(want), rel=1e-12)


@pytest.mark.parametrize("seed", [0, 3])
def test_exp_pop_chain_matches_jax_twin(seed):
    grid, t, is_tip, p = _pop_grid(seed)
    u = np.random.default_rng(100 + seed).uniform(size=(50, 128))
    hypf = jpp._hyp_floats(JPriorConfig())
    rows = jpp.pack_rows(grid, t, is_tip, jnp.float64)   # 128-lane padded
    want = jpp.exp_pop_chain_jnp(jnp.asarray(u), *rows, grid.t_step, p.t0,
                                 p.min_pop, p.n0, p.g, hypf, 50)
    got = pop_cuda.exp_pop_chain_kernel(
        T(u), *[T(a) for a in rows], T(grid.t_step), T(p.t0), T(p.min_pop),
        T(p.n0), T(p.g), hypf, 50)
    for g_, w in zip(got, want):
        assert float(g_) == pytest.approx(float(w), rel=1e-9, abs=1e-15)
    assert float(got[0]) != pytest.approx(500.0)
    # the port's own unpadded rows give the same chain
    grid_t = convert.from_numpy(CoalGrid, grid, device="cpu")
    rows_t = pop_cuda.pack_rows(grid_t, T(t), T(is_tip))
    again = pop_cuda.exp_pop_chain_kernel(
        T(u), *rows_t, grid_t.t_step, T(p.t0), T(p.min_pop), T(p.n0),
        T(p.g), pop_cuda.hyp_floats(gm.PriorConfig()), 50)
    for a, b in zip(again, got):
        assert float(a) == pytest.approx(float(b), rel=1e-12)


# ---------------------------------------------------------------------------
# K3: sweep chain
# ---------------------------------------------------------------------------

def _tree(seed):
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        20, 300, mu=1e-3, sample_window_days=300.0, missing_fraction=0.02,
        seed=seed)
    return build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(seed))


@pytest.fixture(scope="module")
def jax_boundary():
    """A JAX boundary context up to the sweep (as tests/test_block_pallas.py
    builds it), packed as the JAX chain's 128-lane padded rows."""
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
    return jbp.pack_chain_inputs(ctx, sh, pop_params, k_p, t_p, mut_t_p,
                                 cpb=16)


def test_sweep_chain_matches_jax_twin(jax_boundary):
    stat, ctx_arrs, shared = jax_boundary
    P, NB = ctx_arrs["t"].shape[0], 16
    rng = np.random.default_rng(17)
    u_np = jbp.BlockUniforms(
        pri=rng.uniform(size=(P, NB, stat.NC)),
        prop=rng.uniform(size=(P, NB, stat.NC)),
        acc=rng.uniform(size=(P, NB, stat.NC)),
        ref_u=rng.uniform(size=(P, NB, stat.MC)),
        ref_acc=rng.uniform(size=(P, NB, stat.NC)),
        sc=rng.uniform(size=(P, NB, 128)),
        norm=rng.normal(size=(P, NB, 128)))
    want = jax.jit(jbp.sweep_chain_jnp, static_argnames=("stat",))(
        stat, NB, ctx_arrs, shared, jbp.BlockUniforms(*map(jnp.asarray, u_np)))
    # the port always runs all three moves, as the JAX sweep does by default
    assert not stat.no_single and not stat.no_reform
    got = bc.sweep_chain_kernel(
        bc.ChainStatics(NC=stat.NC, MC=stat.MC, C=stat.C, C_real=stat.C_real,
                        cpb=stat.cpb), NB,
        {k: T(v) for k, v in ctx_arrs.items()},
        {k: T(v) for k, v in shared.items()},
        bc.BlockUniforms(*map(T, u_np)))
    names = ("t", "mut_t", "k_p", "dG", "dC", "cnt")
    for n, g, w in zip(names, got, want):
        g, w = g.numpy().reshape(-1), np.asarray(w).reshape(-1)
        if n == "cnt":
            np.testing.assert_array_equal(g, w)
        elif n in ("t", "mut_t", "k_p"):
            np.testing.assert_allclose(g, w, atol=1e-8, rtol=0, err_msg=n)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-8, atol=1e-9, err_msg=n)
    assert got[5].sum() > 50
    assert not np.allclose(got[0].numpy(), np.asarray(ctx_arrs["t"]))


@pytest.fixture(scope="module")
def port_boundary():
    run = Run(_tree(23), seed=23, num_cells=200, device_partitions=4,
              topology_moves_enabled=False, device="cpu")
    ts, evo, pop_params, grid, caches, ledger, stats = run_global_moves(
        run.ts, run.evo, run.pop, run.gen, run.tin, run.tout, run.t_max_tip,
        run.hyp, run.num_cells)
    stat, ctx_arrs, shared, t_p, mut_t_p = prepare_sweep(
        ts, evo, pop_params, grid, caches, run.pm, run.gen, run.t_max_tip,
        run.num_cells)
    P, NB = t_p.shape[0], 16
    u = bc.gen_block_uniforms(run.gen, P, NB, stat.NC, stat.MC, "cpu")
    out = bc.sweep_chain_kernel(stat, NB, ctx_arrs, shared, u)
    return dict(run=run, ts=ts, evo=evo, pop=pop_params, grid=grid,
                ledger=ledger, stat=stat, ctx_arrs=ctx_arrs, shared=shared,
                t_p=t_p, mut_t_p=mut_t_p, out=out)


def test_sweep_chain_kp_matches_recompute(port_boundary):
    b = port_boundary
    run, grid, out = b["run"], b["grid"], b["out"]
    t_new = out[0].reshape(b["t_p"].shape)
    assert float(out[5].sum()) > 50
    assert not torch.allclose(t_new, b["t_p"])
    assert bool(torch.isfinite(t_new).all())
    kp_re = vsc.calc_k_bar_signed(t_new, run.pm.sign, grid.t_lo, grid.t_step,
                                  run.num_cells)
    np.testing.assert_allclose(out[2].reshape(kp_re.shape).numpy(),
                               kp_re.numpy(), atol=1e-8)


def test_sweep_chain_dG_matches_log_G_recompute(port_boundary):
    b = port_boundary
    ts, evo, out, stat = b["ts"], b["evo"], b["out"], b["stat"]
    P = b["t_p"].shape[0]
    dt, dmut = scatter_deltas(b["run"].pm, ts.num_nodes, ts.mut_t.shape[0],
                              out[0].reshape(P, stat.NC) - b["t_p"],
                              out[1].reshape(P, stat.MC) - b["mut_t_p"])
    ts2 = ts._replace(t=ts.t + dt, mut_t=ts.mut_t + dmut)
    caches2 = gm.compute_caches(ts2, evo)
    log_G_re = float(lk.calc_log_G(ts2, evo, caches2.lambda_i,
                                   caches2.root_freq))
    log_G_inc = float(b["ledger"].log_G) + float(out[3].sum())
    assert abs(log_G_inc - log_G_re) < 1e-6


def test_sweep_chain_dC_decomposes(port_boundary):
    b = port_boundary
    out, ctx_arrs, shared, stat = b["out"], b["ctx_arrs"], b["shared"], \
        b["stat"]
    P, n_cap = b["t_p"].shape
    k_p0 = ctx_arrs["k_p"].reshape(P, -1)
    k_p1 = out[2].reshape(P, -1)
    bb = ctx_arrs["b"].reshape(P, -1)
    A, nbar = shared["A"].reshape(-1), shared["nbar"].reshape(-1)
    dquad = sum(float(vsc.partial_quad(k_p1[p], bb[p], A, nbar,
                                       shared["t_step"])
                      - vsc.partial_quad(k_p0[p], bb[p], A, nbar,
                                         shared["t_step"]))
                for p in range(P))
    from delphy_tpu_torch import pop as popm
    is_inner = ((ctx_arrs["c0"].reshape(P, -1) >= 0)
                & (torch.arange(n_cap)[None, :]
                   < ctx_arrs["n_nodes"].reshape(P, 1)))
    t_new = out[0].reshape(P, -1)
    lN_old = torch.log(popm.pop_at_time(b["pop"], b["t_p"]))
    lN_new = torch.log(popm.pop_at_time(b["pop"], t_new))
    dpoint = -float(torch.where(is_inner, lN_new - lN_old,
                                torch.zeros_like(lN_new)).sum())
    assert abs(float(out[4].sum()) - (dquad + dpoint)) < 1e-6


def test_sweep_chain_mutation_times_stay_in_branch(port_boundary):
    b = port_boundary
    out, ctx_arrs = b["out"], b["ctx_arrs"]
    P = b["t_p"].shape[0]
    t_new = out[0].reshape(P, -1).numpy()
    mut_new = out[1].reshape(P, -1).numpy()
    n_checked = 0
    for p in range(P):
        mn = ctx_arrs["mnode"][p, 0].numpy()
        mv = ctx_arrs["mvalid"][p, 0].numpy()
        par = ctx_arrs["par"][p, 0].numpy()
        root = int(ctx_arrs["part_root"][p])
        for j in np.nonzero(mv)[0]:
            n = mn[j]
            if n == root or par[n] < 0:
                continue
            assert t_new[p, par[n]] < mut_new[p, j] <= t_new[p, n] + 1e-9
            n_checked += 1
    assert n_checked > 0
