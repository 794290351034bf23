"""One global-move boundary (port of ``run_global_moves`` of
``delphy_tpu/mcmc/kernel.py``; reference core/run.cpp:695-779), with the
moves in the reference package's order: mu and HKY (or the mpox hack's
mu/rho moves in their place), alpha and nu, then the population model's
moves (the exponential chain, or the skygrid's tau, zero-mode and HMC)."""

from __future__ import annotations

import torch

from .. import pop as popm
from ..evo import EvoParams
from ..ops import coalescent as coal
from ..ops import likelihood as lk
from ..parallel import hky_cuda
from ..state import TreeState
from . import global_moves as gm
from .global_moves import PriorConfig
from .moves import Ledger


def boundary_grid_bounds(ts: TreeState, t_max_tip, num_cells: int):
    """(t_lo, t_step) of the coalescent grid rebuilt around the current tree
    span at every boundary (run.cpp:734-747)."""
    t_root = ts.t[ts.root.long()]
    span = torch.clamp(t_max_tip - t_root, min=1.0)
    t_lo = t_root - 0.35 * span - 1.0
    return t_lo, (t_max_tip - t_lo) / num_cells


def run_global_moves(ts: TreeState, evo: EvoParams, pop_params,
                     gen: torch.Generator, tin, tout, t_max_tip,
                     hyp: PriorConfig, num_cells: int,
                     param_moves: bool = True):
    """Global moves + grid rebuild + ledger recompute.  Returns
    (ts, evo, pop_params, grid, caches, ledger, stats).

    param_moves=False skips every parameter move but keeps the grid rebuild,
    the caches and the full ledger recompute (deterministic)."""
    cnt, nucum = lk.calc_ref_state_prefix(ts, evo)
    root_freq = lk.calc_root_state_frequencies(ts, evo, cnt)
    num_muts = lk.calc_num_muts(ts)
    M_ab = lk.calc_num_muts_ab(ts)
    Ttwiddle_a = lk.calc_Ttwiddle_a(ts, evo, tin, tout, nucum)

    if not param_moves:
        pass
    elif hyp.mpox_enabled:
        # 1 & 2. Gibbs sampling of mu and mu_star under the two-partition
        # APOBEC model (run.cpp:720-724, 823-952)
        M_beta_ab = lk.calc_num_muts_beta_ab(ts, evo)
        nu_prefix_pa = lk.calc_ref_state_prefix_beta(ts, evo)
        Ttwiddle_beta_a = lk.calc_Ttwiddle_beta_a(ts, evo, tin, tout,
                                                  nu_prefix_pa)
        evo = gm.mpox_hack_moves(gen, evo, M_beta_ab, num_muts,
                                 Ttwiddle_beta_a, hyp)
    else:
        # 1. Gibbs sampling of mu (run.cpp:704-709)
        if hyp.mu_move_enabled and not hyp.mu_fixed:
            evo = gm.mu_gibbs_move(gen, evo, Ttwiddle_a, num_muts, hyp)
        # 2. 10x HKY frequency + kappa moves (run.cpp:714-719), one kernel
        if hyp.hky_moves_enabled:
            evo = hky_cuda.hky_chain(gen, evo, Ttwiddle_a, M_ab, root_freq,
                                     hyp, n_rounds=10)

    # 3. alpha moves + Gibbs of all nu_l (run.cpp:729-732)
    if param_moves and hyp.alpha_move_enabled:
        Ttwiddle_l = lk.calc_Ttwiddle_l(ts, evo, tin, tout)
        M_l = lk.calc_num_muts_l(ts)
        evo = gm.alpha_and_nu_moves(gen, evo, Ttwiddle_l, M_l, hyp)

    # 4-pre. rebuild the coalescent grid around the current tree span
    t_lo, t_step = boundary_grid_bounds(ts, t_max_tip, num_cells)
    is_tip = ts.is_tip
    grid = coal.make_grid(pop_params, ts.t, is_tip, t_lo, t_step, num_cells)

    def refresh(grid, pop_params):
        return grid._replace(popsize_bar=coal.calc_popsize_bars(
            pop_params, grid.t_lo, grid.t_step, num_cells))

    # 4. pseudo-Gibbs population moves (run.cpp:749-778)
    if not param_moves:
        pass
    elif isinstance(pop_params, popm.ExpPopParams):
        if hyp.pop_size_move_enabled or hyp.pop_growth_rate_move_enabled:
            # one kernel
            pop_params = gm.exp_pop_moves(gen, pop_params, grid, ts.t,
                                          is_tip, hyp)
            grid = refresh(grid, pop_params)
    else:
        if hyp.skygrid_tau_move_enabled:
            pop_params = gm.skygrid_tau_move(gen, pop_params, hyp)
        n_inner = ts.num_nodes - ts.num_tips
        pop_params = gm.skygrid_zero_mode_gibbs_move(gen, pop_params, grid,
                                                     n_inner, hyp)
        # the zero mode shifts every gamma: refresh popsize_bar before the
        # HMC's baseline and the sweep
        grid = refresh(grid, pop_params)
        pop_params = gm.skygrid_hmc_move(gen, pop_params, grid, ts.t, is_tip,
                                         hyp)
        grid = refresh(grid, pop_params)

    # final ledger: full recompute under the accepted parameters
    caches = gm.compute_caches(ts, evo)
    log_G = lk.calc_log_G(ts, evo, caches.lambda_i, caches.root_freq)
    log_coal = coal.calc_log_prior(grid, pop_params, ts.t, is_tip)
    log_other = gm.calc_log_other_priors(evo, pop_params, hyp)
    ledger = Ledger(log_G=log_G, log_coal=log_coal, log_other=log_other)
    stats = {"num_muts": num_muts, "M_ab": M_ab, "Ttwiddle_a": Ttwiddle_a}
    return ts, evo, pop_params, grid, caches, ledger, stats
