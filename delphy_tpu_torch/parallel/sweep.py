"""Partitioned local-move sweep (port of ``delphy_tpu/parallel/sweep.py``).
Both population models run through the sweep kernel: its skygrid build
takes the place of the JAX package's XLA ``part_sweep`` for a skygrid run
(same moves).  With a ``PartMesh`` (``distributed.py``), the counterpart of
the JAX package's shard_map branch, each rank sweeps its own slice of the
part rows and one all-reduce reassembles the deltas (``mesh_reassemble``).

Each part runs the reference's local move mix (subrun.cpp:98-121) on its own
index view of the global flat arrays, all parts in one launch of the sweep
kernel (block_cuda.py).  Moves in different parts compose exactly because
log_G is branch-additive with every branch in exactly one part, and the
augmented coalescent prior (vsc_device) factorises per part given the
frozen fields.  Reassembly scatter-adds the part-local deltas at owned
indices (padding routes to a trash slot).

A dispatch of boundaries (``parts_multi_super_step``) runs on CUDA as
replays of one boundary's CUDA graph (``dispatch_graph.py``, the
counterpart of the JAX package's jitted scan): the blocking driver's, the
overlapped driver's G and L dispatches and a mesh rank's over NCCL, on
every model option.  A mesh whose ranks share one card and the CPU run an
eager loop of the same boundary.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ..evo import EvoParams
from ..mcmc.kernel import run_global_moves, skygrid_hmc_warm_up
from ..mcmc.moves import Caches
from ..pop import SkygridPopParams
from ..state import TreeState, fuse_for_host
from . import block_cuda as bc
from . import dispatch_graph as dg
from . import vsc_device as vsc

# caps on blocks per boundary, the reference package's: NB_MAX where its
# sweep is the Pallas kernel (an exponential-model run), NB_MAX_SKYGRID
# where it is its XLA sweep (every skygrid run); the overlapped driver's
# half-width sweeps take 2 NB_MAX on the exponential model
NB_MAX = 64
NB_MAX_SKYGRID = 512
# cells per colour block of the batched displacement (DELPHY_TPU_CPB
# overrides it, read at import as the reference reads its default; below 6
# the sweep kernel takes its per-cell k_p scatter)
CELLS_PER_BLOCK = int(os.environ.get("DELPHY_TPU_CPB", "16"))

_M32 = 0xFFFFFFFF


class PartCtx(NamedTuple):
    """Per-part sweep context: static maps + per-boundary gathered caches,
    stacked over a leading part axis."""
    parent: torch.Tensor        # i32[P, n_cap]
    children: torch.Tensor      # i32[P, n_cap, 2]
    part_root: torch.Tensor     # i32[P]
    is_run_root: torch.Tensor   # bool[P]
    n_leaves: torch.Tensor      # i32[P]
    n_nodes: torch.Tensor       # i32[P]
    t_min: torch.Tensor         # float[P, n_cap] (the run's float dtype)
    t_max: torch.Tensor         # float[P, n_cap]
    mut_node_loc: torch.Tensor  # i32[P, m_cap]
    mut_valid: torch.Tensor     # bool[P, m_cap]
    mut_site: torch.Tensor      # i32[P, m_cap]
    mut_single: torch.Tensor    # bool[P, m_cap] only occurrence of (node, site)
    lam: torch.Tensor           # float[P, n_cap] lambda_i at part nodes
    dlam_miss: torch.Tensor     # float[P, n_cap]
    slope: torch.Tensor         # float[P, m_cap] mu nu (qa[from] - qa[to])
    b: torch.Tensor             # float[P, C] frozen vsc linear coefficients


class SweepShared(NamedTuple):
    """Part-independent sweep inputs."""
    A: torch.Tensor             # float[C]
    popsize_bar: torch.Tensor   # float[C]
    t_lo: torch.Tensor          # float scalar (grid)
    t_step: torch.Tensor        # float scalar
    t_max_tip: torch.Tensor     # float scalar


def _mul32(x, c: int):
    """(x * c) mod 2**32 for 0 <= x < 2**32 in int64, without overflow."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def salted_bucket(key64, part_id, salt, n_buckets: int):
    """Murmur3-style avalanche of (key + part_id * 0x9E3779B9) ^ salt in
    uint32 arithmetic, emulated in int64, modulo n_buckets.  Bit-equal to
    the reference package's uint32 hash."""
    key_u = ((key64 & _M32) + _mul32(part_id.to(torch.int64) & _M32,
                                     0x9E3779B9)) & _M32
    x = key_u ^ (salt.to(torch.int64) & _M32)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x % n_buckets


def build_part_ctx(pm, ts: TreeState, caches: Caches, evo: EvoParams, b,
                   salt=None) -> PartCtx:
    """Gather the per-part sweep context from the global arrays.  ``salt``
    (an int scalar tensor, fresh each boundary) perturbs the single-slot
    hash so collision-locked slots vary per boundary (see the reference
    package's build_part_ctx)."""
    nm = pm.node_map.clamp(min=0).long()
    mm = pm.mut_map.clamp(min=0).long()
    site = ts.mut_site[mm]
    frm = ts.mut_from[mm]
    to = ts.mut_to[mm]
    site_c = site.clamp(min=0).long()
    mpart = evo.part[site_c].long()
    qa = evo.qa_tab
    slope = evo.mu * evo.nu[site_c] * (qa[mpart, frm.clamp(min=0).long()]
                                       - qa[mpart, to.clamp(min=0).long()])
    valid = pm.mut_map >= 0
    # slots that are the only occurrence of their (branch, site) pair in the
    # part, via a hashed-key histogram; a collision can only lock a slot
    L = ts.num_sites
    B = 32 * pm.mut_map.shape[-1] + 1
    key64 = (pm.mut_node_local.to(torch.int64) * (L + 1)
             + site.clamp(min=0).to(torch.int64))
    if salt is not None:
        bucket = salted_bucket(key64, pm.part_id[:, None], salt, B - 1)
    else:
        bucket = key64 % (B - 1)
    counts = torch.zeros(B, dtype=torch.int32, device=key64.device)
    counts = counts.index_add(
        0, torch.where(valid, bucket, torch.full_like(bucket, B - 1))
        .reshape(-1), torch.ones(bucket.numel(), dtype=torch.int32,
                                 device=key64.device))
    single = valid & (counts[bucket] == 1)
    return PartCtx(
        parent=pm.parent, children=pm.children, part_root=pm.part_root,
        is_run_root=pm.is_run_root, n_leaves=pm.n_leaves, n_nodes=pm.n_nodes,
        t_min=pm.t_min, t_max=pm.t_max,
        mut_node_loc=pm.mut_node_local, mut_valid=valid,
        mut_site=site, mut_single=single,
        lam=caches.lambda_i[nm], dlam_miss=caches.dlam_miss[nm],
        slope=slope, b=b)


def scatter_deltas(pm, num_nodes: int, num_mut_slots: int, dt_p, dmut_p):
    """Scatter part-local deltas into global-size arrays via the owned-index
    maps (non-owned and padded entries route to a trash slot)."""
    dt = torch.zeros(num_nodes + 1, dtype=dt_p.dtype, device=dt_p.device)
    dt = dt.index_add(0, pm.owned_idx.reshape(-1).long(), dt_p.reshape(-1))
    dmut = torch.zeros(num_mut_slots + 1, dtype=dmut_p.dtype,
                       device=dmut_p.device)
    dmut = dmut.index_add(0, pm.mut_scatter.reshape(-1).long(),
                          dmut_p.reshape(-1))
    return dt[:num_nodes], dmut[:num_mut_slots]


def select_parts(x, part_sel):
    """``x`` (a tensor or a NamedTuple of tensors with a leading part axis)
    gathered down to the part rows ``part_sel`` (None: all of them)."""
    if part_sel is None:
        return x
    if isinstance(x, torch.Tensor):
        return x[part_sel]
    return type(x)(*(a[part_sel] for a in x))


def prepare_sweep(ts: TreeState, evo, pop_params, grid, caches, pm,
                  gen: torch.Generator, t_max_tip, num_cells: int,
                  part_sel=None):
    """Sweep-kernel inputs of a boundary after its global moves: per-part
    lineage staircases, a fresh draw of the decoupling fields (a Gibbs update,
    very_scalable_coalescent.cpp:198-219) and of the hash salt, and the part
    contexts packed as chain rows.  Returns (stat, ctx_arrs, shared, t_p,
    mut_t_p).

    part_sel (i32[P_sel] or a slice, optional): sweep only these part rows,
    the device half of the overlapped driver (run.py) or a rank's shard.
    The fields are still sampled over ALL parts (the augmentation
    conditions on the full boundary state; the other parts' k_bar stays
    frozen, as the reference's frozen cut points, run.cpp:682-693), then
    the context, k_p, t_p and mut_t_p are gathered down to the selected
    rows before packing."""
    nm = pm.node_map.clamp(min=0).long()
    t_p = ts.t[nm]
    k_p = vsc.calc_k_bar_signed(t_p, pm.sign, grid.t_lo, grid.t_step,
                                num_cells)
    active = vsc.active_cells(pm.part_t_lo, pm.part_t_hi, grid.t_lo,
                              grid.t_step, num_cells)
    fields = vsc.sample_fields(gen, k_p, active, grid.popsize_bar,
                               grid.t_step)
    salt = torch.randint(0, 2 ** 31 - 1, (), generator=gen,
                         device=ts.t.device)
    ctx = build_part_ctx(pm, ts, caches, evo, fields.b, salt=salt)
    mut_t_p = ts.mut_t[pm.mut_map.clamp(min=0).long()]
    ctx, k_p, t_p, mut_t_p = (select_parts(x, part_sel)
                              for x in (ctx, k_p, t_p, mut_t_p))
    sh = SweepShared(A=fields.A, popsize_bar=grid.popsize_bar,
                     t_lo=grid.t_lo, t_step=grid.t_step,
                     # a fill, not a copy of a host float: a blocking
                     # host-to-device copy would synchronise the stream
                     # every boundary
                     t_max_tip=torch.full((), float(t_max_tip),
                                          dtype=ts.t.dtype,
                                          device=ts.t.device))
    stat, ctx_arrs, shared = bc.pack_chain_inputs(
        ctx, sh, pop_params, k_p, t_p, mut_t_p, cpb=CELLS_PER_BLOCK)
    return stat, ctx_arrs, shared, t_p, mut_t_p


def mesh_reassemble(mesh, shard: slice, P: int, dt, dmut, dG_p, dC_p,
                    cnt_p):
    """The reassembly collective of a rank's sweep of rows ``shard`` of a
    part axis of width P: its scattered ``dt`` [N] and ``dmut`` [M] and its
    per-part ``dG_p``, ``dC_p`` and ``cnt_p``, each written into its own
    rows of a [P] vector, packed into one float buffer and summed over the
    ranks with one all-reduce (the JAX package psums instead,
    delphy_tpu/parallel/sweep.py:569-573).  Every entry has exactly one
    nonzero contributor, so the sum is exact in any order on any backend.
    Returns (dt, dmut, dG_p, dC_p, cnt_p) of the whole part axis, the
    per-part vectors the columns of one [P, 3] tensor as the sweep's own
    are (block_cuda.sweep_chain_kernel), so a sum over P rounds as the
    single-process path's does.  The buffer is in the run's float dtype:
    8 (N + M + 3P) bytes in float64, 4 (N + M + 3P) in float32 (a part's
    move count, below 2^24, is exact in either)."""
    N, M = dt.shape[0], dmut.shape[0]
    full = torch.zeros((P, 3), dtype=dt.dtype, device=dt.device)
    full[shard] = torch.stack([dG_p, dC_p, cnt_p], 1)
    buf = mesh.all_reduce_sum(torch.cat([dt, dmut, full.reshape(-1)]))
    parts = buf[N + M:].view(P, 3).clone().unbind(1)
    return (buf[:N], buf[N:N + M], *parts)


def _boundary_body(ts: TreeState, evo, pop_params, gen: torch.Generator, tin,
                   tout, pm, n_blocks: int, t_max_tip, hyp, num_cells: int,
                   param_moves: bool = True, part_sel=None,
                   nb_max: int = NB_MAX, mesh=None):
    """One boundary: global moves, then the partitioned local sweep of at
    most nb_max blocks over the part rows part_sel (None: all).  With no
    block to run (the overlapped driver's globals-only boundary) the sweep,
    a no-op, is skipped.  With a mesh, every rank runs the global moves and
    the draws, sweeps its shard of the (selected) rows on uniforms sliced
    from the whole draw, and the deltas are reassembled (mesh_reassemble):
    the result is the single-process boundary's, bit for bit."""
    ts, evo, pop_params, grid, caches, ledger, stats = run_global_moves(
        ts, evo, pop_params, gen, tin, tout, t_max_tip, hyp, num_cells,
        param_moves=param_moves)
    nb = min(n_blocks, nb_max)
    if nb == 0:
        return ts, evo, pop_params, ledger, dict(
            stats, local_moves_attempted=torch.zeros(
                (), dtype=torch.int64, device=ts.t.device))
    P = pm.node_map.shape[0] if part_sel is None else part_sel.shape[0]
    rows = part_sel
    if mesh is not None:
        shard = mesh.shard_rows(P)
        rows = shard if part_sel is None else part_sel[shard]
    stat, ctx_arrs, shared, t_p, mut_t_p = prepare_sweep(
        ts, evo, pop_params, grid, caches, pm, gen, t_max_tip, num_cells,
        rows)
    # all P rows are drawn on every rank: a smaller draw is not a slice of
    # the larger one
    u = bc.gen_block_uniforms(gen, P, nb, stat.NC, stat.MC, ts.t.device,
                              ts.t.dtype)
    if mesh is not None:
        u = select_parts(u, shard)
    t_new, mut_new, _kp, dG_p, dC_p, cnt_p = bc.sweep_chain_kernel(
        stat, nb, ctx_arrs, shared, u)
    P_run = t_p.shape[0]
    dt_p = t_new.reshape(P_run, stat.NC) - t_p
    dmut_p = mut_new.reshape(P_run, stat.MC) - mut_t_p
    dt, dmut = scatter_deltas(select_parts(pm, rows), ts.num_nodes,
                              ts.mut_t.shape[0], dt_p, dmut_p)
    if mesh is not None:
        dt, dmut, dG_p, dC_p, cnt_p = mesh_reassemble(
            mesh, shard, P, dt, dmut, dG_p, dC_p, cnt_p)
    ts = ts._replace(t=ts.t + dt, mut_t=ts.mut_t + dmut)
    # within-sweep coal deltas are under the AUGMENTED prior; the ledger's
    # log_coal is refreshed from the plain prior at the next boundary
    ledger = ledger._replace(log_G=ledger.log_G + torch.sum(dG_p),
                             log_coal=ledger.log_coal + torch.sum(dC_p))
    # summed as integers: a boundary's count passes 2^24 at ~100k tips,
    # beyond float32's exact integers (each part's stays below it)
    stats = dict(stats, local_moves_attempted=torch.sum(
        cnt_p.to(torch.int64)))
    return ts, evo, pop_params, ledger, stats


def parts_multi_super_step(ts: TreeState, evo, pop_params,
                           gen: torch.Generator, tin, tout, pm,
                           n_blocks: int, t_max_tip, hyp, num_cells: int,
                           n_boundaries: int, param_moves: bool = True,
                           part_sel=None, nb_max: int = NB_MAX, mesh=None,
                           graphs=None, _eager: bool = False):
    """n_boundaries partitioned boundaries in one host call.  Returns (ts,
    evo, pop_params, ledger, stats, fused); stats["local_moves_attempted"]
    is a device tensor summed over the boundaries (over every rank's
    parts), and ``fused`` is fuse_for_host((ts, evo, pop_params)) for a
    following topology burst.  part_sel, nb_max and mesh as in
    _boundary_body.

    Where ``dispatch_graph.graph_rule`` says so (on CUDA: the blocking
    driver's dispatches, the overlapped driver's globals-only G
    (``n_blocks`` 0) and part-selected L ones, a mesh rank's whose
    all-reduce goes over NCCL; whatever the population model and the
    moves) the boundaries are replays of one boundary's CUDA graph
    (dispatch_graph.py) from ``graphs``, the caller's cache (a ``Run``'s
    own; None: a cache for this call alone), else (a ``staged`` mesh,
    whose all-reduce goes through the host; the CPU) this eager loop; both
    give the same bits.  Neither reads anything back to the host (a staged
    mesh's all-reduce stages through it): the caller's first read of the
    move count waits for the dispatch (``Run._absorb``).  ``_eager``
    (private) forces the eager loop on CUDA, for the graph-against-eager
    checks."""
    if not _eager and dg.graph_rule(ts.t.device, pop_params, hyp, n_blocks,
                                    part_sel, mesh):
        if graphs is None:
            graphs = dg.DispatchGraphs()
        return graph_dispatch(graphs, ts, evo, pop_params, gen,
                              tin, tout, pm, n_blocks, t_max_tip, hyp,
                              num_cells, n_boundaries, param_moves, part_sel,
                              nb_max, mesh)
    total = None
    for _ in range(n_boundaries):
        ts, evo, pop_params, ledger, stats = _boundary_body(
            ts, evo, pop_params, gen, tin, tout, pm, n_blocks, t_max_tip,
            hyp, num_cells, param_moves=param_moves, part_sel=part_sel,
            nb_max=nb_max, mesh=mesh)
        att = stats["local_moves_attempted"]
        total = att if total is None else total + att
    stats = dict(stats, local_moves_attempted=total)
    fused = fuse_for_host((ts, evo, pop_params))
    return ts, evo, pop_params, ledger, stats, fused


def graph_dispatch(graphs, ts: TreeState, evo, pop_params,
                   gen: torch.Generator, tin, tout, pm, n_blocks: int,
                   t_max_tip, hyp, num_cells: int, n_boundaries: int,
                   param_moves: bool = True, part_sel=None,
                   nb_max: int = NB_MAX, mesh=None):
    """parts_multi_super_step's graph path through ``graphs`` (a
    ``dispatch_graph.DispatchGraphs``): n_boundaries replays of one
    _boundary_body, keyed by the arguments the JAX jit takes as static
    (``hyp`` holds the alpha/nu and mpox switches; ``param_moves``; a
    mesh's size and this rank, which fix the rows a rank sweeps), the
    values the capture bakes in and the block count; the population
    model's type, a skygrid's knot count and type and the selection's
    width are in the inputs' signature.  ``part_sel`` is an input like
    ``ts``: copied into its buffer at every dispatch, never baked in.
    Before a capture a skygrid boundary with parameter moves is warmed up
    by its HMC's force alone (``kernel.skygrid_hmc_warm_up``), and a mesh
    boundary with a sweep by an eager all-reduce of its reassembly
    buffer's size (the NCCL communicator is made outside the capture).
    On CPU tensors the body runs as it is through the same buffers (the
    tests' check of the plumbing).  Returns (ts, evo, pop_params, ledger,
    stats, fused) as parts_multi_super_step does."""
    nb = min(n_blocks, nb_max)
    statics = (hyp, num_cells, nb_max, param_moves, float(t_max_tip),
               CELLS_PER_BLOCK,
               None if mesh is None else (mesh.size, mesh.rank))

    def body(ts, evo, pop_params, tin, tout, pm, part_sel=None):
        return _boundary_body(ts, evo, pop_params, gen, tin, tout, pm,
                              n_blocks, t_max_tip, hyp, num_cells,
                              param_moves=param_moves, part_sel=part_sel,
                              nb_max=nb_max, mesh=mesh)

    hmc = param_moves and isinstance(pop_params, SkygridPopParams)
    reduce = mesh is not None and nb > 0

    def warm_up(ts, evo, pop_params, tin, tout, pm, part_sel=None):
        if hmc:
            skygrid_hmc_warm_up(ts, pop_params, t_max_tip, hyp, num_cells)
        if reduce:
            P = (pm.node_map.shape[0] if part_sel is None
                 else part_sel.shape[0])
            mesh.all_reduce_sum(torch.zeros(
                ts.num_nodes + ts.mut_t.shape[0] + 3 * P, dtype=ts.t.dtype,
                device=ts.t.device))

    inputs = (ts, evo, pop_params, tin, tout, pm)
    if part_sel is not None:
        inputs += (part_sel,)
    out = graphs.dispatch(body, inputs, gen, statics, nb, n_boundaries,
                          warm_up=warm_up if hmc or reduce else None)
    return (*out, fuse_for_host(out[:3]))
