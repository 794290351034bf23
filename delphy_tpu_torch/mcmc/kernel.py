"""The MCMC step (port of ``delphy_tpu/mcmc/kernel.py``): one global-move
boundary (``run_global_moves``; reference core/run.cpp:695-779), with the
moves in the reference package's order: mu and HKY (or the mpox hack's
mu/rho moves in their place), alpha and nu, then the population model's
moves (the exponential chain, or the skygrid's tau, zero-mode and HMC);
and the unpartitioned step: ``super_step`` (a boundary and a sweep of local
moves over the whole tree, ``run_local_sweep``) and ``multi_super_step``
(several in a row), on CUDA as replays of one boundary's CUDA graph
(``parallel/dispatch_graph.py``), the counterpart of the JAX package's
jitted programs.  The partitioned path (``parallel/sweep.py``) runs the
same boundary before its part sweep."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import pop as popm
from ..evo import EvoParams
from ..ops import coalescent as coal
from ..ops import likelihood as lk
from ..parallel import dispatch_graph as dg
from ..parallel import hky_cuda
from ..state import TreeState
from . import global_moves as gm
from . import moves
from .global_moves import PriorConfig
from .moves import Caches, Ledger


def boundary_grid_bounds(ts: TreeState, t_max_tip, num_cells: int):
    """(t_lo, t_step) of the coalescent grid rebuilt around the current tree
    span at every boundary (run.cpp:734-747).  The root is gathered with a
    one-element index: a 0-d index tensor reads the index back to the
    host."""
    t_root = ts.t[ts.root.long().reshape(1)].reshape(())
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


def skygrid_hmc_warm_up(ts: TreeState, pop_params: popm.SkygridPopParams,
                        t_max_tip, hyp: PriorConfig, num_cells: int) -> None:
    """The skygrid HMC's force, once, on ``pop_params``' gamma and the grid
    of ``ts``, thrown away: the warm-up that PyTorch asks of autograd on a
    stream before a CUDA graph captures a backward there
    (``dispatch_graph``).  It draws nothing and writes nothing."""
    t_lo, t_step = boundary_grid_bounds(ts, t_max_tip, num_cells)
    grid = coal.make_grid(pop_params, ts.t, ts.is_tip, t_lo, t_step,
                          num_cells)
    gm.grad_of(gm.skygrid_hmc_potential(pop_params, grid, ts.t, ts.is_tip,
                                        hyp), pop_params.gamma)


# ---------------------------------------------------------------------------
# the unpartitioned step
# ---------------------------------------------------------------------------

REFORM_BATCH = 48
SEQ_DISP_PER_BLOCK = 2
# cells per colour block of the unpartitioned sweep's batched displacement
CELLS_PER_BLOCK = 4


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
               k_max: int,
               cells_per_block: int = CELLS_PER_BLOCK) -> SweepDraws:
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


def _super_step(ts: TreeState, evo: EvoParams, pop_params,
                gen: torch.Generator, tin, tout, n_local_moves: int,
                t_max_tip, hyp: PriorConfig, num_cells: int):
    ts, evo, pop_params, grid, caches, ledger, stats = run_global_moves(
        ts, evo, pop_params, gen, tin, tout, t_max_tip, hyp, num_cells)
    ts, grid, ledger, count = run_local_sweep(
        ts, caches, grid, ledger, evo, pop_params, gen, n_local_moves,
        t_max_tip)
    return ts, evo, pop_params, ledger, dict(stats,
                                             local_moves_attempted=count)


def super_step(ts: TreeState, evo: EvoParams, pop_params,
               gen: torch.Generator, tin, tout, n_local_moves: int,
               t_max_tip, hyp: PriorConfig, num_cells: int,
               _eager: bool = False):
    """One global boundary and ``n_local_moves`` local moves over the whole
    tree.  Returns (ts, evo, pop_params, ledger, stats), with the attempted
    move count in ``stats["local_moves_attempted"]``.  On CUDA one replay
    of the boundary's CUDA graph, as the JAX ``super_step`` is a jitted
    program of its own (``multi_super_step`` with one boundary; ``_eager``
    as there)."""
    return multi_super_step(ts, evo, pop_params, gen, tin, tout,
                            n_local_moves, t_max_tip, hyp, num_cells, 1,
                            _eager=_eager)


def multi_super_step(ts: TreeState, evo: EvoParams, pop_params,
                     gen: torch.Generator, tin, tout, n_local_moves: int,
                     t_max_tip, hyp: PriorConfig, num_cells: int,
                     n_boundaries: int, _eager: bool = False):
    """``n_boundaries`` super-steps in a row: the same state and draws as
    that many ``super_step`` calls.  Returns the last ledger and stats, with
    ``local_moves_attempted`` summed over the boundaries.

    On CUDA (``dispatch_graph.captures_on``) the boundaries are replays of
    one boundary's CUDA graph from this thread's
    ``dispatch_graph.DispatchGraphs`` (``dispatch_graph.thread_cache``,
    emptied by ``dispatch_graph.clear``), the counterpart of the JAX
    ``multi_super_step``'s ``lax.scan``: the inputs are copied into static
    buffers, the move count adds up in the graph, and the result is cloned
    out.  The graph is keyed by what the JAX jit takes as static (``hyp``,
    ``num_cells``), by what the capture bakes in (``t_max_tip``, the
    sweep's ``sweep_shape`` and ``CELLS_PER_BLOCK``, the generator object
    it draws from) and by the inputs' signature.  The JAX
    ``n_local_moves`` is traced (its ``fori_loop`` bound is dynamic, so one
    compile serves any count); here the block count it gives is in the key,
    as for ``Run``'s graphs, and a new count captures again.  A capture
    that fails raises.  On the CPU, or with ``_eager`` (private: the
    graph-against-eager checks), the eager loop runs; both give the same
    bits."""
    if not _eager and dg.captures_on(ts.t.device):
        return _graph_steps(ts, evo, pop_params, gen, tin, tout,
                            n_local_moves, t_max_tip, hyp, num_cells,
                            n_boundaries)
    counts = []
    for _ in range(n_boundaries):
        ts, evo, pop_params, ledger, stats = _super_step(
            ts, evo, pop_params, gen, tin, tout, n_local_moves, t_max_tip,
            hyp, num_cells)
        counts.append(stats["local_moves_attempted"])
    stats = dict(stats, local_moves_attempted=torch.stack(counts).sum())
    return ts, evo, pop_params, ledger, stats


def _graph_steps(ts: TreeState, evo: EvoParams, pop_params,
                 gen: torch.Generator, tin, tout, n_local_moves: int,
                 t_max_tip, hyp: PriorConfig, num_cells: int,
                 n_boundaries: int):
    """multi_super_step's graph path through this thread's
    ``DispatchGraphs``: ``n_boundaries`` replays of one super-step over static buffers of (ts, evo, pop_params,
    tin, tout).  A skygrid boundary is warmed up by its HMC's force alone
    before a capture (``skygrid_hmc_warm_up``).  On CPU tensors the body
    runs as it is through the same buffers (the tests' check of the
    plumbing)."""
    n_blocks, k_max = sweep_shape(n_local_moves, num_cells)
    statics = ("super_step", gen, hyp, num_cells, float(t_max_tip), k_max,
               CELLS_PER_BLOCK)

    def body(ts, evo, pop_params, tin, tout):
        return _super_step(ts, evo, pop_params, gen, tin, tout,
                           n_local_moves, t_max_tip, hyp, num_cells)

    def warm_up(ts, evo, pop_params, tin, tout):
        skygrid_hmc_warm_up(ts, pop_params, t_max_tip, hyp, num_cells)

    hmc = isinstance(pop_params, popm.SkygridPopParams)
    graphs = dg.thread_cache(dg.DispatchGraphs)
    return graphs.dispatch(body, (ts, evo, pop_params, tin, tout), gen,
                           statics, n_blocks, n_boundaries,
                           warm_up=warm_up if hmc else None)
