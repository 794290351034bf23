"""The MCMC step (port of ``delphy_tpu/mcmc/kernel.py``): one global-move
boundary (``run_global_moves``; reference core/run.cpp:695-779), with the
moves in the reference package's order: mu and HKY (or the mpox hack's
mu/rho moves in their place), alpha and nu, then the population model's
moves (the exponential chain, or the skygrid's tau, zero-mode and HMC);
and the unpartitioned step: ``super_step`` (a boundary and a sweep of local
moves over the whole tree, ``run_local_sweep``) and ``multi_super_step``
(several in a row).  The partitioned path (``parallel/sweep.py``) runs the
same boundary before its part sweep."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import pop as popm
from ..evo import EvoParams
from ..ops import coalescent as coal
from ..ops import likelihood as lk
from ..parallel import hky_cuda
from ..state import TreeState
from . import global_moves as gm
from . import moves
from .global_moves import PriorConfig
from .moves import Caches, Ledger


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


# ---------------------------------------------------------------------------
# the unpartitioned step
# ---------------------------------------------------------------------------

REFORM_BATCH = 48
SEQ_DISP_PER_BLOCK = 2


def sweep_shape(n_moves: int, num_cells: int):
    """(n_blocks, k_max) of a sweep of ``n_moves`` nominal local moves: a
    block counts its sequential displacements, half of k_max batched
    displacement slots and REFORM_BATCH reforms."""
    k_max = max(8, num_cells // 2)
    nominal = SEQ_DISP_PER_BLOCK + k_max // 2 + REFORM_BATCH
    return (n_moves + nominal - 1) // nominal, k_max


class SweepDraws(NamedTuple):
    """A sweep's random numbers, one row per block (S = SEQ_DISP_PER_BLOCK,
    B = REFORM_BATCH).  Uniforms that feed a log lie in (0, 1)."""
    seq_tip: torch.Tensor      # bool[nb, S]: a tip move (else an inner one)
    seq_node: torch.Tensor     # long[nb, S]: the node moved
    seq_u: torch.Tensor        # f64[nb, S]: bounded-exponential uniform
    seq_z: torch.Tensor        # f64[nb, S]: the root's normal draw
    seq_u_acc: torch.Tensor    # f64[nb, S]
    offset: torch.Tensor       # long[nb]: cell-block offset
    pri: torch.Tensor          # f64[nb, N]: batched-displacement priorities
    disp_u: torch.Tensor       # f64[nb, k_max]
    disp_u_acc: torch.Tensor   # f64[nb, k_max]
    chosen: torch.Tensor       # long[nb, min(B, N)]: branches reformed
    reform_u: torch.Tensor     # f64[nb, M]: new-time uniforms, >= 1e-16
    reform_u_acc: torch.Tensor  # f64[nb, N]


def draw_sweep(gen: torch.Generator, ts: TreeState, n_blocks: int,
               k_max: int, cells_per_block: int = 4) -> SweepDraws:
    """Every random number of a sweep, drawn from ``gen`` on the state's
    device in a dozen calls before the block loop."""
    dev, dt = ts.t.device, ts.t.dtype
    T, N, M = ts.num_tips, ts.num_nodes, ts.mut_t.shape[0]
    shape = (n_blocks, SEQ_DISP_PER_BLOCK)
    tip = torch.rand(shape, generator=gen, dtype=dt, device=dev) >= 0.5
    w = torch.rand(shape, generator=gen, dtype=dt, device=dev)
    node = torch.where(tip, torch.floor(w * T).clamp(max=T - 1),
                       T + torch.floor(w * (N - T)).clamp(max=N - T - 1))
    def u(shape_, lo=1e-300):
        return moves.uniforms(gen, shape_, dev, dt, lo=lo)
    return SweepDraws(
        seq_tip=tip, seq_node=node.long(), seq_u=u(shape),
        seq_z=torch.randn(shape, generator=gen, dtype=dt, device=dev),
        seq_u_acc=u(shape),
        offset=torch.randint(0, cells_per_block, (n_blocks,), generator=gen,
                             device=dev),
        pri=torch.rand((n_blocks, N), generator=gen, dtype=dt, device=dev),
        disp_u=u((n_blocks, k_max)),
        disp_u_acc=u((n_blocks, k_max)),
        chosen=moves.random_branches(gen, N, REFORM_BATCH, n_blocks, dev,
                                     dt),
        reform_u=u((n_blocks, M), lo=1e-16),
        reform_u_acc=u((n_blocks, N)))


def local_sweep_core(ts: TreeState, caches: Caches, grid, ledger: Ledger,
                     evo, pop_params, draws: SweepDraws, t_max_tip):
    """The local moves of a sweep on given draws.  Per block:
      - SEQ_DISP_PER_BLOCK sequential single-node displacements, each an
        inner-node or a tip move as ``draws.seq_tip`` says (they cover the
        root and the wide-window nodes that the colouring cannot batch);
      - one cell-block-coloured batched displacement of up to k_max nodes;
      - one batched reform of REFORM_BATCH branches.
    The inner-or-tip choice is made on the card (``moves.displace_core``
    computes both cases and selects with where): choosing on the host would
    need the choices there, a synchronisation per sweep, to save the half
    of two small moves per block.  Returns (ts, grid, ledger, count), count
    the attempted move-equivalents (a device scalar)."""
    n_blocks, k_max = draws.disp_u.shape
    n_attempted = []
    carry = (ts, caches, grid, ledger)
    for i in range(n_blocks):
        for j in range(SEQ_DISP_PER_BLOCK):
            carry = moves.displace_core(
                carry, draws.seq_tip[i, j:j + 1], draws.seq_node[i, j:j + 1],
                draws.seq_u[i, j:j + 1], draws.seq_z[i, j:j + 1],
                draws.seq_u_acc[i, j:j + 1], pop_params, t_max_tip)
        ts, _, grid, ledger = carry
        ts, grid, ledger, n_att = moves.batched_node_displace_core(
            ts, caches, grid, ledger, pop_params, draws.offset[i:i + 1],
            draws.pri[i], draws.disp_u[i], draws.disp_u_acc[i], k_max)
        ts, ledger = moves.batched_branch_reform_core(
            ts, ledger, evo, draws.chosen[i], draws.reform_u[i],
            draws.reform_u_acc[i])
        carry = (ts, caches, grid, ledger)
        n_attempted.append(n_att)
    ts, _, grid, ledger = carry
    count = torch.stack(n_attempted).sum() \
        + n_blocks * (SEQ_DISP_PER_BLOCK + REFORM_BATCH)
    return ts, grid, ledger, count


def run_local_sweep(ts: TreeState, caches: Caches, grid, ledger: Ledger, evo,
                    pop_params, gen: torch.Generator, n_moves: int,
                    t_max_tip):
    """The local moves of one boundary: as many blocks as ``n_moves``
    nominal moves need, on draws from ``gen``.  Returns (ts, grid, ledger,
    count)."""
    n_blocks, k_max = sweep_shape(n_moves, grid.num_cells)
    draws = draw_sweep(gen, ts, n_blocks, k_max)
    return local_sweep_core(ts, caches, grid, ledger, evo, pop_params, draws,
                            t_max_tip)


def super_step(ts: TreeState, evo: EvoParams, pop_params,
               gen: torch.Generator, tin, tout, n_local_moves: int,
               t_max_tip, hyp: PriorConfig, num_cells: int):
    """One global boundary and ``n_local_moves`` local moves over the whole
    tree.  Returns (ts, evo, pop_params, ledger, stats), with the attempted
    move count in ``stats["local_moves_attempted"]``."""
    ts, evo, pop_params, grid, caches, ledger, stats = run_global_moves(
        ts, evo, pop_params, gen, tin, tout, t_max_tip, hyp, num_cells)
    ts, grid, ledger, count = run_local_sweep(
        ts, caches, grid, ledger, evo, pop_params, gen, n_local_moves,
        t_max_tip)
    return ts, evo, pop_params, ledger, dict(stats,
                                             local_moves_attempted=count)


def multi_super_step(ts: TreeState, evo: EvoParams, pop_params,
                     gen: torch.Generator, tin, tout, n_local_moves: int,
                     t_max_tip, hyp: PriorConfig, num_cells: int,
                     n_boundaries: int):
    """``n_boundaries`` super-steps in a row: the same state and draws as
    that many ``super_step`` calls.  Returns the last ledger and stats, with
    ``local_moves_attempted`` summed over the boundaries."""
    counts = []
    for _ in range(n_boundaries):
        ts, evo, pop_params, ledger, stats = super_step(
            ts, evo, pop_params, gen, tin, tout, n_local_moves, t_max_tip,
            hyp, num_cells)
        counts.append(stats["local_moves_attempted"])
    stats = dict(stats, local_moves_attempted=torch.stack(counts).sum())
    return ts, evo, pop_params, ledger, stats
