"""Global parameter moves (port of ``delphy_tpu/mcmc/global_moves.py``;
reference Run::run_global_moves, core/run.cpp:695-779): mu Gibbs, the
exponential population chain, the skygrid's tau, zero-mode and HMC moves,
site-rate heterogeneity (alpha and nu) and the mpox hack's mu/rho moves.

Every global boundary starts from a full recompute of the derived
quantities, the moves use closed-form MH/Gibbs deltas, and the ledger is
re-derived from scratch at the end.  Random draws come from the run's
``torch.Generator`` and stay on its device.  Each random move is a core
that takes its draws (standard normals, exponentials, uniforms,
Gamma(shape, 1) variates) and a thin wrapper that draws them, so the cores
can be fed any stream of draws.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import float_dtype
from .. import pop as popm
from ..evo import EvoParams
from ..ops import likelihood as lk
from ..parallel import pop_cuda
from ..state import TreeState
from .moves import Caches


@dataclasses.dataclass(frozen=True)
class PriorConfig:
    """Prior hyperparameters and move toggles (same fields and defaults as
    the reference package's PriorConfig; core/run.cpp:14-41)."""
    mu_prior_alpha: float = 1.0
    mu_prior_beta: float = 0.0
    alpha_prior_mean: float = 1.0
    kappa_prior_mean_log: float = 1.0
    kappa_prior_sigma_log: float = 1.25
    pop_inv_n0_prior_alpha: float = 0.0
    pop_inv_n0_prior_beta: float = 0.0
    pop_g_prior_mu: float = 0.001 / 365.0
    pop_g_prior_scale: float = 30.701135 / 365.0
    pop_g_min: float = -math.inf
    pop_g_max: float = math.inf
    skygrid_tau_prior_alpha: float = 0.001
    skygrid_tau_prior_beta: float = 0.001
    skygrid_low_gamma_barrier_enabled: bool = True
    skygrid_low_gamma_barrier_loc: float = 0.0
    skygrid_low_gamma_barrier_scale: float = 0.35667494393873245
    skygrid_inv_nbar_prior_alpha: float = 0.0
    skygrid_inv_nbar_prior_beta: float = 0.0
    mu_move_enabled: bool = True
    hky_moves_enabled: bool = True
    alpha_move_enabled: bool = False
    pop_size_move_enabled: bool = True
    pop_growth_rate_move_enabled: bool = True
    skygrid_tau_move_enabled: bool = True
    mu_fixed: bool = False
    mpox_enabled: bool = False


def compute_caches(ts: TreeState, evo: EvoParams) -> Caches:
    ref_cum_Q = lk.calc_ref_cum_Q(ts, evo)
    lam, dlam_miss = lk.calc_lambda_i(ts, evo, ref_cum_Q)
    cnt, _ = lk.calc_ref_state_prefix(ts, evo)
    root_freq = lk.calc_root_state_frequencies(ts, evo, cnt)
    return Caches(lambda_i=lam, dlam_miss=dlam_miss, ref_cum_Q=ref_cum_Q,
                  root_freq=root_freq)


def calc_log_other_priors(evo: EvoParams, pop_params, hyp: PriorConfig):
    """Reference Run::calc_cur_log_other_priors (run.cpp:480-560)."""
    lp = (hyp.mu_prior_alpha - 1.0) * torch.log(evo.mu) \
        - hyp.mu_prior_beta * evo.mu
    # alpha ~ Exponential(mean alpha_prior_mean)
    lp = lp - evo.alpha / hyp.alpha_prior_mean - math.log(hyp.alpha_prior_mean)
    # nu_l ~ Gamma(alpha, alpha)
    L = evo.nu.shape[0]
    lp = lp + L * (evo.alpha * torch.log(evo.alpha) - torch.lgamma(evo.alpha))
    lp = lp + (evo.alpha - 1.0) * torch.sum(torch.log(evo.nu)) \
        - evo.alpha * torch.sum(evo.nu)
    # kappa ~ log-normal
    s = hyp.kappa_prior_sigma_log
    lp = lp + (-(torch.log(evo.kappa) - hyp.kappa_prior_mean_log) ** 2
               / (2 * s * s) - 0.5 * math.log(2 * math.pi * s * s)
               - torch.log(evo.kappa))
    if isinstance(pop_params, popm.ExpPopParams):
        lp = lp + (-(hyp.pop_inv_n0_prior_alpha + 1.0)
                   * torch.log(pop_params.n0)
                   - hyp.pop_inv_n0_prior_beta / pop_params.n0)
        lp = lp + (-torch.abs(pop_params.g - hyp.pop_g_prior_mu)
                   / hyp.pop_g_prior_scale
                   - math.log(2.0 * hyp.pop_g_prior_scale))
    else:
        if hyp.skygrid_tau_move_enabled:
            # tau ~ Gamma prior (Gill et al 2012 Eq. 15; run.cpp:536-541)
            tau = pop_params.tau
            lp = lp + ((hyp.skygrid_tau_prior_alpha - 1.0) * torch.log(tau)
                       - hyp.skygrid_tau_prior_beta * tau)
        lp = lp + calc_skygrid_gmrf_prior(pop_params, hyp)
    return lp


def _barrier(gamma, hyp: PriorConfig):
    """The low-population barrier's penalty, sum ((loc - gamma)+ / scale)^2
    (run.cpp:598-606)."""
    excess = torch.clamp(hyp.skygrid_low_gamma_barrier_loc - gamma, min=0.0)
    return torch.sum((excess / hyp.skygrid_low_gamma_barrier_scale) ** 2)


def calc_skygrid_gmrf_prior(p: popm.SkygridPopParams, hyp: PriorConfig):
    """GMRF prior + N_bar InvGamma + low-population barrier
    (run.cpp:564-608)."""
    gamma, tau = p.gamma, torch.as_tensor(p.tau, dtype=p.gamma.dtype,
                                          device=p.gamma.device)
    gamma_bar = torch.mean(gamma)
    lp = (-hyp.skygrid_inv_nbar_prior_alpha * gamma_bar
          - hyp.skygrid_inv_nbar_prior_beta * torch.exp(-gamma_bar))
    dg = gamma[1:] - gamma[:-1]
    lp = lp + torch.sum(0.5 * (torch.log(tau) - math.log(2.0 * math.pi))
                        - 0.5 * dg ** 2 * tau)
    if hyp.skygrid_low_gamma_barrier_enabled:
        lp = lp - _barrier(gamma, hyp)
    return lp


def sample_gamma(gen: torch.Generator, shape, size=None, device=None,
                 tries: int = 16, dtype=None):
    """Gamma(shape, 1) draws by Marsaglia-Tsang on the generator's normals
    and uniforms, over a fixed number of tries (each accepts with
    probability > 0.95), with no host synchronisation.  Shapes below 1 use
    the boost Gamma(shape + 1) U^(1/shape).  ``size`` is the shape of the
    result (default: that of ``shape``, which broadcasts to it); the
    draws are in ``dtype``, by default the float dtype of ``shape``.  A
    Python number ``shape`` is filled in on ``device``: a copy from the host
    would synchronise the stream (and break a CUDA graph's capture)."""
    dt = dtype or float_dtype(shape)
    if isinstance(shape, torch.Tensor):
        shape = torch.as_tensor(shape, dtype=dt, device=device)
    else:
        shape = torch.full((), shape, dtype=dt, device=device)
    dt = shape.dtype
    size = tuple(shape.shape) if size is None else tuple(size)
    dev = shape.device
    boost = shape < 1.0
    a = torch.where(boost, shape + 1.0, shape)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    x = torch.randn((tries,) + size, generator=gen, dtype=dt, device=dev)
    u = torch.rand((tries,) + size, generator=gen, dtype=dt, device=dev)
    u_boost = torch.rand(size, generator=gen, dtype=dt, device=dev)
    v = (1.0 + c * x) ** 3
    safe_v = torch.where(v > 0.0, v, torch.ones_like(v))
    ok = (v > 0.0) & (torch.log(u) < 0.5 * x * x + d - d * safe_v
                      + d * torch.log(safe_v))
    first = torch.argmax(ok.to(torch.int32), 0)
    val = torch.where(ok.any(0), d * torch.gather(safe_v, 0, first[None])[0],
                      d)
    return torch.where(boost, val * u_boost ** (1.0 / shape), val)


def _accept_u(gen: torch.Generator, size, device, dtype):
    """Uniforms in [1e-300, 1) for MH acceptance tests (the floor rounds to
    0 in float32, as the JAX package's does)."""
    return torch.clamp(torch.rand(size, generator=gen, dtype=dtype,
                                  device=device), min=1e-300)


def _accepts(log_mh, u, strict: bool = True):
    """MH acceptance: log_mh > 0 (>= 0 unless ``strict``) or
    log u < log_mh."""
    ge = log_mh > 0.0 if strict else log_mh >= 0.0
    return ge | (torch.log(u) < log_mh)


def mu_gibbs_move(gen: torch.Generator, evo: EvoParams, Ttwiddle_a, num_muts,
                  hyp: PriorConfig) -> EvoParams:
    """Gibbs sample mu ~ Gamma(M + a, Ttwiddle + b) (run.cpp:781-821)."""
    Ttwiddle = torch.sum(evo.q_a * Ttwiddle_a)
    shape = num_muts.to(evo.mu.dtype) + hyp.mu_prior_alpha
    rate = Ttwiddle + hyp.mu_prior_beta
    return evo._replace(mu=sample_gamma(gen, shape) / rate)


def exp_pop_moves(gen: torch.Generator, pop_params: popm.ExpPopParams, grid,
                  t, is_tip, hyp: PriorConfig, n_rounds: int = 50):
    """50 rounds of n0 scale moves + g random-walk moves (run.cpp:1237-1319)
    with k_bar fixed, run as one kernel (parallel/pop_cuda.py)."""
    return pop_cuda.exp_pop_chain(gen, pop_params, grid, t, is_tip, hyp,
                                  n_rounds)


# ---------------------------------------------------------------------------
# Mpox hack (reference mpox_hack_moves, run.cpp:823-952)
# ---------------------------------------------------------------------------

_A, _C, _G, _T = 0, 1, 2, 3
N_TRUNC_GAMMA = 64     # draws per truncated-gamma rejection


def _mpox_stats(M_beta_ab, num_muts, Ttwiddle_beta_a):
    dt = Ttwiddle_beta_a.dtype
    M = num_muts.to(dt)
    M_star = (M_beta_ab[1, _C, _T] + M_beta_ab[1, _G, _A]).to(dt)
    return (M, M_star, torch.sum(Ttwiddle_beta_a),
            Ttwiddle_beta_a[1, _C] + Ttwiddle_beta_a[1, _G])


def mpox_hack_core(evo: EvoParams, M_beta_ab, num_muts, Ttwiddle_beta_a,
                   hyp: PriorConfig, g_mu, g_rho) -> EvoParams:
    """10x pseudo-Gibbs of (mu, rho) under the two-partition APOBEC model:

      mu | rho ~ Gamma[M + a - 1, b + Ttwiddle + 2 rho Ttwiddle*]
      (1 + 6 rho) | mu ~ Gamma[M* + 1, mu Ttwiddle* / 3] truncated to [1, inf)

    with M* = M^1_CT + M^1_GA and Ttwiddle* = Ttwiddle^1_C + Ttwiddle^1_G.
    ``g_mu`` [10] are Gamma(M + a - 1, 1) variates and ``g_rho`` [10, 64]
    Gamma(M* + 1, 1) variates; the truncated draw takes the first of a row's
    64 scaled variates that is >= 1, or 1 when none is (the conditional's
    mass then sits at the boundary)."""
    _M, _M_star, Tt, Tt_star = _mpox_stats(M_beta_ab, num_muts,
                                           Ttwiddle_beta_a)
    mu, rho = evo.mu, evo.mpox_rho
    for i in range(g_mu.shape[0]):
        if hyp.mu_move_enabled and not hyp.mu_fixed:
            mu = g_mu[i] / (Tt + 2.0 * rho * Tt_star + hyp.mu_prior_beta)
        draws = g_rho[i] / (mu * Tt_star / 3.0)
        ok = draws >= 1.0
        # a one-element index: a 0-d index tensor reads it back to the host
        first = torch.argmax(ok.to(torch.int32)).reshape(1)
        k = torch.where(ok.any(), draws[first].reshape(()),
                        torch.ones_like(mu))
        rho = torch.where(Tt_star > 0.0, (k - 1.0) / 6.0, rho)
    return evo.with_mpox_rho(mu=mu, rho=rho)


def mpox_hack_moves(gen: torch.Generator, evo: EvoParams, M_beta_ab,
                    num_muts, Ttwiddle_beta_a, hyp: PriorConfig) -> EvoParams:
    M, M_star, _Tt, _Tt_star = _mpox_stats(M_beta_ab, num_muts,
                                           Ttwiddle_beta_a)
    g_mu = sample_gamma(gen, M + hyp.mu_prior_alpha - 1.0, size=(10,))
    g_rho = sample_gamma(gen, M_star + 1.0, size=(10, N_TRUNC_GAMMA))
    return mpox_hack_core(evo, M_beta_ab, num_muts, Ttwiddle_beta_a, hyp,
                          g_mu, g_rho)


# ---------------------------------------------------------------------------
# Site-rate heterogeneity (run.cpp:1105-1235)
# ---------------------------------------------------------------------------

def _log_p_alpha(alpha, mu, Ttwiddle_l, M_l):
    """log p(alpha) with nu_l integrated out (run.cpp:1157-1181)."""
    L = M_l.shape[0]
    Mf = M_l.to(mu.dtype)
    has = M_l > 0
    r = torch.sum(torch.where(has, torch.lgamma(Mf + alpha),
                              torch.zeros_like(Mf)))
    r = r - torch.sum((Mf + alpha) * torch.log(mu * Ttwiddle_l + alpha))
    return r - (torch.sum(has) * torch.lgamma(alpha)
                - L * alpha * torch.log(alpha))


def alpha_core(evo: EvoParams, Ttwiddle_l, M_l, hyp: PriorConfig, scale, u):
    """10 MH scale moves on alpha (run.cpp:1183-1235): ``scale`` [10] are the
    proposals' factors, uniform on [0.9, 1/0.9), and ``u`` [10] the
    acceptance uniforms.  Returns the new alpha."""
    alpha = evo.alpha
    cur_lp = _log_p_alpha(alpha, evo.mu, Ttwiddle_l, M_l)
    for i in range(scale.shape[0]):
        new_alpha = alpha * scale[i]
        lp_new = _log_p_alpha(new_alpha, evo.mu, Ttwiddle_l, M_l)
        log_mh = (lp_new - cur_lp - (new_alpha - alpha) / hyp.alpha_prior_mean
                  + torch.log(alpha / new_alpha))
        accept = _accepts(log_mh, u[i])
        alpha = torch.where(accept, new_alpha, alpha)
        cur_lp = torch.where(accept, lp_new, cur_lp)
    return alpha


def nu_core(evo: EvoParams, alpha, Ttwiddle_l, M_l, g) -> EvoParams:
    """Gibbs draw of every nu_l ~ Gamma(M_l + alpha, mu Ttwiddle_l + alpha),
    floored at 1e-50 (run.cpp:1105-1155), from Gamma(M_l + alpha, 1)
    variates ``g`` [L]."""
    nu = torch.clamp(g / (evo.mu * Ttwiddle_l + alpha), min=1e-50)
    return evo._replace(alpha=alpha, nu=nu)


def alpha_and_nu_moves(gen: torch.Generator, evo: EvoParams, Ttwiddle_l,
                       M_l, hyp: PriorConfig) -> EvoParams:
    """10 MH scale moves on alpha, then a Gibbs draw of all nu_l."""
    dev, dt = evo.mu.device, evo.mu.dtype
    lo, hi = 0.90, 1.0 / 0.90
    scale = lo + torch.rand(10, generator=gen, dtype=dt,
                            device=dev) * (hi - lo)
    alpha = alpha_core(evo, Ttwiddle_l, M_l, hyp, scale,
                       _accept_u(gen, 10, dev, dt))
    g = sample_gamma(gen, M_l.to(dt) + alpha)
    return nu_core(evo, alpha, Ttwiddle_l, M_l, g)


# ---------------------------------------------------------------------------
# Skygrid (run.cpp:1321-2175)
# ---------------------------------------------------------------------------

def skygrid_tau_core(p: popm.SkygridPopParams, hyp: PriorConfig, g):
    """Gibbs: tau ~ Gamma(a + M/2, b + sum(dgamma^2)/2) (run.cpp:1321-1358)
    from one Gamma(a + M/2, 1) variate ``g``."""
    ssq = torch.sum((p.gamma[1:] - p.gamma[:-1]) ** 2)
    return p._replace(tau=g / (hyp.skygrid_tau_prior_beta + 0.5 * ssq))


def skygrid_tau_move(gen: torch.Generator, p: popm.SkygridPopParams,
                     hyp: PriorConfig):
    shape = hyp.skygrid_tau_prior_alpha + 0.5 * (p.gamma.shape[0] - 1)
    return skygrid_tau_core(p, hyp, sample_gamma(gen, shape,
                                                 device=p.gamma.device,
                                                 dtype=p.gamma.dtype))


def skygrid_zero_mode_core(p: popm.SkygridPopParams, grid, hyp: PriorConfig,
                           g, u):
    """Gibbs draw of the population scale through I_bar = exp(-gamma_bar):
    I_bar ~ Gamma(N_inner + alpha, B + beta), with an MH correction for the
    low-gamma barrier (run.cpp:2016-2175).  ``g`` is one
    Gamma(N_inner + alpha, 1) variate, ``u`` the acceptance uniform."""
    gamma_bar = torch.mean(p.gamma)
    I_bar = torch.exp(-gamma_bar)
    B = torch.sum(0.5 * grid.t_step * grid.k_bar * (grid.k_bar - 1.0)
                  / grid.popsize_bar) / I_bar
    new_I_bar = g / (B + hyp.skygrid_inv_nbar_prior_beta)
    new_gamma = p.gamma + torch.log(I_bar / new_I_bar)
    log_mh = torch.zeros((), dtype=p.gamma.dtype, device=p.gamma.device)
    if hyp.skygrid_low_gamma_barrier_enabled:
        log_mh = _barrier(p.gamma, hyp) - _barrier(new_gamma, hyp)
    blew_up = torch.any(torch.isnan(new_gamma)) | torch.isnan(log_mh)
    accept = ~blew_up & _accepts(log_mh, u, strict=False)
    return p._replace(gamma=torch.where(accept, new_gamma, p.gamma))


def skygrid_zero_mode_gibbs_move(gen: torch.Generator,
                                 p: popm.SkygridPopParams, grid, n_inner: int,
                                 hyp: PriorConfig):
    dev, dt = p.gamma.device, p.gamma.dtype
    g = sample_gamma(gen, n_inner + hyp.skygrid_inv_nbar_prior_alpha,
                     device=dev, dtype=dt)
    return skygrid_zero_mode_core(p, grid, hyp, g,
                                  _accept_u(gen, (), dev, dt))


HMC_STEPS = 25


def skygrid_hmc_potential(p: popm.SkygridPopParams, grid, t, is_tip,
                          hyp: PriorConfig):
    """U(gamma): minus the log density of the gamma_k under the coalescent
    prior on the grid, the GMRF, the barrier and the N_bar prior, as a
    function of gamma (run.cpp:1360-2014)."""
    lbs = grid.cell_lbounds()
    kk = grid.t_step * grid.k_bar * (grid.k_bar - 1.0) / 2.0
    tau = p.tau

    def U(gamma):
        q = p._replace(gamma=gamma)
        nbar = popm.skygrid_pop_integral(q, lbs, lbs + grid.t_step) \
            / grid.t_step
        u_coal = torch.sum(kk / torch.clamp(nbar, min=1e-100))
        logN = popm.skygrid_log_N(q, t)
        u_coal = u_coal + torch.sum(torch.where(is_tip,
                                                torch.zeros_like(logN), logN))
        dg = gamma[1:] - gamma[:-1]
        u_prior = 0.5 * tau * torch.sum(dg ** 2)
        if hyp.skygrid_low_gamma_barrier_enabled:
            u_prior = u_prior + _barrier(gamma, hyp)
        gamma_bar = torch.mean(gamma)
        u_prior = u_prior + (hyp.skygrid_inv_nbar_prior_alpha * gamma_bar
                             + hyp.skygrid_inv_nbar_prior_beta
                             * torch.exp(-gamma_bar))
        return u_coal + u_prior
    return U


def grad_of(U, gamma):
    """dU/dgamma by autograd."""
    with torch.enable_grad():
        g = gamma.detach().requires_grad_(True)
        (dU,) = torch.autograd.grad(U(g), g)
    return dU


def skygrid_hmc_core(p: popm.SkygridPopParams, grid, t, is_tip,
                     hyp: PriorConfig, z, e, u):
    """Mass-preconditioned randomized HMC over the gamma_k
    (run.cpp:1360-2014): masses m_k = tau [k > 0] + tau [k < M] + c_k (c_k
    the coalescences in knot interval k) equalise the normal modes'
    frequencies; position Verlet with dt = e 2 pi / 100 over 25 steps;
    trajectories whose kinetic energy exceeds 100 (M + 1) are rejected on
    both ends.  ``z`` [M+1] are standard normals (the momentum), ``e`` a
    standard exponential, ``u`` the acceptance uniform.  Forces come from
    autograd of the potential."""
    M = p.gamma.shape[0] - 1
    dev, dt = p.gamma.device, p.gamma.dtype
    tau = torch.as_tensor(p.tau, dtype=dt, device=dev)
    kk = torch.searchsorted(p.x, t, right=False).clamp(0, M)
    c_k = torch.zeros(M + 1, dtype=dt, device=dev).index_add_(
        0, kk, torch.where(is_tip, 0.0, 1.0).to(dt))
    k = torch.arange(M + 1, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    m_k = torch.clamp(torch.where(k > 0, tau, zero)
                      + torch.where(k < M, tau, zero) + c_k, min=1e-12)
    inv_m_k = 1.0 / m_k
    U = skygrid_hmc_potential(p, grid, t, is_tip, hyp)

    def K(mom):
        return torch.sum(0.5 * mom ** 2 * inv_m_k)

    K_cap = 100.0 * (M + 1)
    p0 = z * torch.sqrt(m_k)
    dt = e * (2.0 * math.pi / 100.0)
    gamma, mom = p.gamma, p0
    blown = K(p0) > K_cap
    for _ in range(HMC_STEPS):
        gamma = gamma + 0.5 * dt * mom * inv_m_k
        mom = mom - dt * grad_of(U, gamma)
        blown = blown | (K(mom) > K_cap)
        gamma = gamma + 0.5 * dt * mom * inv_m_k
    log_mh = (K(p0) + U(p.gamma)) - (K(mom) + U(gamma))
    blown = blown | torch.any(torch.isnan(gamma)) | torch.isnan(log_mh)
    accept = ~blown & _accepts(log_mh, u)
    return p._replace(gamma=torch.where(accept, gamma, p.gamma))


def skygrid_hmc_move(gen: torch.Generator, p: popm.SkygridPopParams, grid,
                     t, is_tip, hyp: PriorConfig):
    dev, dt = p.gamma.device, p.gamma.dtype
    M = p.gamma.shape[0] - 1
    z = torch.randn(M + 1, generator=gen, dtype=dt, device=dev)
    e = -torch.log1p(-torch.rand((), generator=gen, dtype=dt, device=dev))
    return skygrid_hmc_core(p, grid, t, is_tip, hyp, z, e,
                            _accept_u(gen, (), dev, dt))
