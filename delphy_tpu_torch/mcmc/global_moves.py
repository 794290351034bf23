"""Global parameter moves of the main path (port of
``delphy_tpu/mcmc/global_moves.py``: exponential population model, mu Gibbs
and HKY moves; reference Run::run_global_moves, core/run.cpp:695-779).

Every global boundary starts from a full recompute of the derived
quantities, the moves use closed-form MH/Gibbs deltas, and the ledger is
re-derived from scratch at the end.  Random draws come from the run's
``torch.Generator`` and stay on its device.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import DTYPE
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
    """Reference Run::calc_cur_log_other_priors (run.cpp:480-560),
    exponential population branch."""
    if not isinstance(pop_params, popm.ExpPopParams):
        raise TypeError("only the exponential population model is ported")
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
    lp = lp + (-(hyp.pop_inv_n0_prior_alpha + 1.0) * torch.log(pop_params.n0)
               - hyp.pop_inv_n0_prior_beta / pop_params.n0)
    lp = lp + (-torch.abs(pop_params.g - hyp.pop_g_prior_mu)
               / hyp.pop_g_prior_scale
               - math.log(2.0 * hyp.pop_g_prior_scale))
    return lp


def sample_gamma(gen: torch.Generator, shape, tries: int = 16):
    """One Gamma(shape, 1) draw by Marsaglia-Tsang on the generator's normals
    and uniforms, over a fixed number of tries (each accepts with
    probability > 0.95), with no host synchronisation.  Shapes below 1 use
    the boost Gamma(shape + 1) * U^(1/shape)."""
    shape = torch.as_tensor(shape, dtype=DTYPE)
    dev = shape.device
    boost = shape < 1.0
    a = torch.where(boost, shape + 1.0, shape)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    x = torch.randn(tries, generator=gen, dtype=DTYPE, device=dev)
    u = torch.rand(tries, generator=gen, dtype=DTYPE, device=dev)
    u_boost = torch.rand((), generator=gen, dtype=DTYPE, device=dev)
    v = (1.0 + c * x) ** 3
    safe_v = torch.where(v > 0.0, v, torch.ones_like(v))
    ok = (v > 0.0) & (torch.log(u) < 0.5 * x * x + d - d * safe_v
                      + d * torch.log(safe_v))
    first = torch.argmax(ok.to(torch.int32))
    val = torch.where(ok.any(), d * safe_v[first], d)
    return torch.where(boost, val * u_boost ** (1.0 / shape), val)


def mu_gibbs_move(gen: torch.Generator, evo: EvoParams, Ttwiddle_a, num_muts,
                  hyp: PriorConfig) -> EvoParams:
    """Gibbs sample mu ~ Gamma(M + a, Ttwiddle + b) (run.cpp:781-821)."""
    Ttwiddle = torch.sum(evo.q_a * Ttwiddle_a)
    shape = num_muts.to(DTYPE) + hyp.mu_prior_alpha
    rate = Ttwiddle + hyp.mu_prior_beta
    return evo._replace(mu=sample_gamma(gen, shape) / rate)


def exp_pop_moves(gen: torch.Generator, pop_params: popm.ExpPopParams, grid,
                  t, is_tip, hyp: PriorConfig, n_rounds: int = 50):
    """50 rounds of n0 scale moves + g random-walk moves (run.cpp:1237-1319)
    with k_bar fixed, run as one kernel (parallel/pop_cuda.py)."""
    return pop_cuda.exp_pop_chain(gen, pop_params, grid, t, is_tip, hyp,
                                  n_rounds)
