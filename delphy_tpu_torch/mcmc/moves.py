"""Local MCMC moves (port of ``delphy_tpu/mcmc/moves.py``), with the
ledger and the per-boundary caches.

Move semantics mirror the reference's core/subrun.cpp:

  inner-node displace  (subrun.cpp:148-232)
  tip displace         (subrun.cpp:234-285)
  branch reform        (subrun.cpp:287-320)

plus the batched forms the unpartitioned sweep runs (a cell-block-coloured
displacement of many nodes, a reform of many distinct branches).  Node-time
proposals sample exactly from p(t) ~ exp(d_logG_dt t) on [t_min, t_max] by
the bounded exponential's inverse CDF, so the genetic likelihood cancels
from the MH ratio and only the coalescent prior's delta remains.

Each random move is a deterministic ``*_core`` that takes its random numbers
as tensors (node index, uniforms, normal draw, offset, priorities, chosen
branches) and a thin wrapper that draws them from the run's
``torch.Generator`` on the state's device.  A core reads single nodes
through one-element index tensors (``index_select``, ``scatter``), never
through a 0-d tensor or a Python number read back from the device, so
enqueuing a move makes no host synchronisation.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import DTYPE
from .. import pop as popm
from ..evo import EvoParams
from ..ops import coalescent as coal
from ..ops.likelihood import add_at
from ..state import TreeState

INF = math.inf


class Ledger(NamedTuple):
    log_G: torch.Tensor
    log_coal: torch.Tensor
    log_other: torch.Tensor

    @property
    def log_posterior(self):
        return self.log_G + self.log_coal + self.log_other


class Caches(NamedTuple):
    """Derived quantities that stay constant through a local sweep (only
    times move, so lambda_i is invariant; cf. subrun.h:42-65)."""
    lambda_i: torch.Tensor    # f64[N]
    dlam_miss: torch.Tensor   # f64[N]
    ref_cum_Q: torch.Tensor   # f64[L+1]
    root_freq: torch.Tensor   # f64[4]


def uniforms(gen: torch.Generator, size, device, lo: float = 1e-300):
    """Uniforms on [lo, 1) from ``gen`` (the floor keeps their logs
    finite)."""
    return torch.clamp(torch.rand(size, generator=gen, dtype=DTYPE,
                                  device=device), min=lo)


def _pick(x, idx):
    """x[idx] for an index tensor of one (or a few) elements."""
    return x.index_select(0, idx)


def _plus(x, accept, delta):
    """Ledger entry x (0-d) plus delta where accept (one element)."""
    return x + torch.where(accept, delta, 0.0).reshape(())


# ---------------------------------------------------------------------------
# Bounded exponential (distributions.h:38-68)
# ---------------------------------------------------------------------------

def bounded_exp_core(u, lam, a, b):
    """x ~ exp(lam x) on [a, b] from uniforms u in (0, 1), by the inverse
    CDF.  Every branch is computed on guarded inputs and combined with
    where, so any finite a <= b and any lam are safe; arguments
    broadcast."""
    ltr = lam * (b - a)
    safe_lam = torch.where(lam == 0.0, torch.ones_like(lam), lam)
    # clamp the exponent so expm1 stays finite where the branch is not
    # taken; switching to the asymptotic branches at |ltr| = 80 errs by
    # ~e^-80
    ltr_c = torch.clamp(ltr, -80.0, 80.0)
    mid = a + torch.log1p(u * torch.expm1(ltr_c)) / safe_lam
    hi = b + torch.log(u) / safe_lam   # lam > 0, ltr >> 1
    lo = a + torch.log(u) / safe_lam   # lam < 0, ltr << -1
    x = torch.where(lam == 0.0, a + u * (b - a),
                    torch.where((lam > 0.0) & (ltr > 80.0), hi,
                                torch.where((lam < 0.0) & (ltr < -80.0), lo,
                                            mid)))
    return torch.minimum(torch.maximum(x, a), b)


def bounded_exp_sample(gen: torch.Generator, lam, a, b):
    """One draw of x ~ exp(lam x) on [a, b] per element of the broadcast of
    the (tensor) arguments."""
    lam, a, b = torch.broadcast_tensors(lam, a, b)
    return bounded_exp_core(uniforms(gen, lam.shape, lam.device), lam, a, b)


# ---------------------------------------------------------------------------
# single-node helpers
# ---------------------------------------------------------------------------

def _own_mut_time_max(ts: TreeState, node):
    """Latest mutation time on the branch above ``node`` ([1] index; -inf
    if none).  Root deltas are excluded by the callers' root conditions."""
    mask = ts.mut_node == node
    return torch.amax(torch.where(mask, ts.mut_t, -INF), 0, keepdim=True)


def _child_bound(ts: TreeState, child):
    """min(t_child, earliest mutation on the child's branch) per entry of
    ``child`` (node indices, -1 for none: +inf)."""
    valid = child >= 0
    c = child.clamp(min=0)
    mask = (ts.mut_node[None, :] == c[:, None]) & valid[:, None]
    mut_min = torch.amin(torch.where(mask, ts.mut_t[None, :], INF), 1)
    return torch.where(valid, torch.minimum(_pick(ts.t, c), mut_min), INF)


def _mh_accept(u, log_mh):
    """MH acceptance from a uniform u in (0, 1)."""
    return (log_mh >= 0.0) | (torch.log(u) < log_mh)


# ---------------------------------------------------------------------------
# sequential node displacements (subrun.cpp:148-285)
# ---------------------------------------------------------------------------

def displace_core(carry, tip, node, u, z, u_acc, pop_params, t_max_tip):
    """Displace one node in time: an inner node (``tip`` false; the root by
    a Gaussian proposal, any other inner node by the exact bounded
    exponential) or a tip within its date uncertainty (``tip`` true).
    ``tip``, ``node``, ``u`` (the bounded exponential's uniform), ``z``
    (the root's normal draw) and ``u_acc`` hold one element each.  Both
    cases are computed and selected with where, so the choice needs no
    host decision; each selected output is the one the case's own move
    computes."""
    ts, caches, grid, ledger = carry
    is_root = node == ts.root
    old_t = _pick(ts.t, node)
    safe_par = _pick(ts.parent, node).long().clamp(min=0)
    t_par = _pick(ts.t, safe_par)
    own_max = _own_mut_time_max(ts, node)
    ch = _pick(ts.children, node)[0].long()

    # inner node: window between the parent (the grid's second cell for the
    # root, cf. ensure_space) and the children's bounds
    grid_lo = grid.t_lo + grid.t_step
    t_min_in = torch.maximum(torch.where(is_root, grid_lo, t_par),
                             torch.where(is_root, -INF, own_max))
    cb = _child_bound(ts, ch)
    t_max_in = torch.minimum(cb[:1], cb[1:])
    # tip: window inside its date bounds; t_min < t_max implies the tip has
    # date uncertainty (t_min >= its t_min, t_max is its t_max)
    t_min_tip = torch.maximum(_pick(ts.t_min, node),
                              torch.maximum(t_par, own_max))
    t_min = torch.where(tip, t_min_tip, t_min_in)
    t_max = torch.where(tip, _pick(ts.t_max, node), t_max_in)

    lam = _pick(caches.lambda_i, node)
    dlam = _pick(caches.dlam_miss, ch.clamp(min=0))
    d_in = (torch.where(is_root, 0.0, -lam) + (lam + dlam[:1])
            + (lam + dlam[1:]))
    d_logG_dt = torch.where(tip, -lam, d_in)

    # root: Gaussian proposal with a capped scale (subrun.cpp:188-201)
    tree_span = torch.clamp(t_max_tip - t_max, min=0.0)
    delta_scale = torch.minimum(0.5 / torch.clamp(lam, min=1e-300),
                                tree_span)
    root_t = old_t + delta_scale * z
    # others: exact bounded-exponential proposal (an inner window is
    # always finite but for the root's)
    a = torch.where(tip | (t_min > -INF), t_min, old_t - 1.0)
    b = torch.where(tip | (t_max < INF), t_max, old_t + 1.0)
    bexp_t = bounded_exp_core(u, d_logG_dt, torch.minimum(a, b), b)

    new_t = torch.where(is_root, root_t, bexp_t)
    in_bounds = (new_t > t_min) & (new_t < t_max) & (t_min < t_max)
    delta_log_G = d_logG_dt * (new_t - old_t)
    log_alpha = torch.where(is_root, 0.0, delta_log_G)
    delta_coal, new_k = coal.displace_delta(grid, pop_params, old_t, new_t,
                                            tip)
    # the bounded-exponential proposal density cancels delta_log_G
    log_mh = torch.where(tip, delta_coal,
                         delta_log_G + delta_coal - log_alpha)
    accept = in_bounds & _mh_accept(u_acc, log_mh)

    ts = ts._replace(t=ts.t.scatter(0, node,
                                    torch.where(accept, new_t, old_t)))
    grid = grid._replace(k_bar=torch.where(accept, new_k, grid.k_bar))
    ledger = ledger._replace(log_G=_plus(ledger.log_G, accept, delta_log_G),
                             log_coal=_plus(ledger.log_coal, accept,
                                            delta_coal))
    return (ts, caches, grid, ledger)


def _flag(value: bool, like):
    return torch.full((1,), value, dtype=torch.bool, device=like.device)


def inner_node_displace_core(carry, node, u, z, u_acc, pop_params,
                             t_max_tip):
    """Displace inner node ``node`` (subrun.cpp:148-232)."""
    return displace_core(carry, _flag(False, node), node, u, z, u_acc,
                         pop_params, t_max_tip)


def tip_displace_core(carry, node, u, u_acc, pop_params, t_max_tip):
    """Displace tip ``node`` within its date bounds (subrun.cpp:234-285)."""
    return displace_core(carry, _flag(True, node), node, u,
                         torch.zeros_like(u), u_acc, pop_params, t_max_tip)


def inner_node_displace(carry, gen: torch.Generator, pop_params, t_max_tip):
    """Displace one random inner node in time."""
    ts = carry[0]
    dev = ts.t.device
    T, N = ts.num_tips, ts.num_nodes
    node = torch.randint(T, N, (1,), generator=gen, device=dev)
    z = torch.randn(1, generator=gen, dtype=DTYPE, device=dev)
    return inner_node_displace_core(carry, node, uniforms(gen, 1, dev), z,
                                    uniforms(gen, 1, dev), pop_params,
                                    t_max_tip)


def tip_displace(carry, gen: torch.Generator, pop_params, t_max_tip):
    """Displace one random tip within its date-uncertainty bounds."""
    ts = carry[0]
    dev = ts.t.device
    node = torch.randint(0, ts.num_tips, (1,), generator=gen, device=dev)
    return tip_displace_core(carry, node, uniforms(gen, 1, dev),
                             uniforms(gen, 1, dev), pop_params, t_max_tip)


# ---------------------------------------------------------------------------
# branch reforms (subrun.cpp:287-320)
# ---------------------------------------------------------------------------

def _lexsort(key, group):
    """jnp.lexsort((key, group)): the order by group, then by key, ties in
    index order; two stable sorts, the secondary key first."""
    by_key = torch.sort(key, stable=True).indices
    return by_key[torch.sort(group[by_key], stable=True).indices]


def _matched_times(mut_t, raw, group):
    """New times for the slots of each group (a branch's site): the group's
    slots in their old time order receive the group's new times sorted, so
    each site's mutations keep their order along the branch."""
    perm_old = _lexsort(mut_t, group)
    perm_new = _lexsort(raw, group)
    return torch.zeros_like(raw).scatter(0, perm_old, raw[perm_new])


def _mut_slopes(ts: TreeState, evo: EvoParams):
    """d log G / d t of each mutation slot's time:
    mu nu_l (q_a(from) - q_a(to)) in its site's partition."""
    site = ts.mut_site.clamp(min=0).long()
    mpart = evo.part.long()[site]
    return evo.mu * evo.nu[site] * (
        evo.qa_tab[mpart, ts.mut_from.clamp(min=0).long()]
        - evo.qa_tab[mpart, ts.mut_to.clamp(min=0).long()])


def branch_reform_core(carry, X, u, u_acc, evo: EvoParams):
    """Resample every mutation time on the branch above node ``X`` ([1])
    uniformly on (t_P, t_X] (randomize_branch_mutation_times,
    phylo_tree.cpp:579-645); ``u`` [M] are the slots' uniforms in (0, 1)
    and ``u_acc`` the acceptance uniform."""
    ts, caches, grid, ledger = carry
    valid = X != ts.root
    P = _pick(ts.parent, X).long().clamp(min=0)
    t_P, t_X = _pick(ts.t, P), _pick(ts.t, X)
    mask = (ts.mut_node == X) & valid
    raw = t_P + u * (t_X - t_P)
    group = torch.where(mask, ts.mut_site.to(DTYPE), INF)
    new_mut_t = torch.where(mask, _matched_times(ts.mut_t, raw, group),
                            ts.mut_t)
    delta_log_G = torch.sum(torch.where(
        mask, -_mut_slopes(ts, evo) * (new_mut_t - ts.mut_t), 0.0))
    accept = valid & _mh_accept(u_acc, delta_log_G)
    ts = ts._replace(mut_t=torch.where(accept, new_mut_t, ts.mut_t))
    ledger = ledger._replace(log_G=_plus(ledger.log_G, accept, delta_log_G))
    return (ts, caches, grid, ledger)


def branch_reform(carry, gen: torch.Generator, evo: EvoParams, pop_params,
                  t_max_tip):
    """Resample all mutation times on one random branch."""
    ts = carry[0]
    dev = ts.t.device
    X = torch.randint(0, ts.num_nodes, (1,), generator=gen, device=dev)
    u = uniforms(gen, ts.mut_t.shape[0], dev, lo=1e-16)
    return branch_reform_core(carry, X, u, uniforms(gen, 1, dev), evo)


# ---------------------------------------------------------------------------
# batched moves
# ---------------------------------------------------------------------------

def _segment_minmax_mut_times(ts: TreeState):
    """Per-node latest and earliest mutation time on the node's own branch
    (-inf / +inf where none; root deltas excluded).  Max and min are exact
    in any order, so the scatter reductions repeat bit for bit."""
    N = ts.num_nodes
    node_safe = ts.mut_node.clamp(min=0).long()
    valid = (ts.mut_node >= 0) & (ts.mut_node != ts.root)
    own_max = torch.full((N,), -INF, dtype=DTYPE, device=ts.t.device) \
        .scatter_reduce(0, node_safe, torch.where(valid, ts.mut_t, -INF),
                        "amax")
    own_min = torch.full((N,), INF, dtype=DTYPE, device=ts.t.device) \
        .scatter_reduce(0, node_safe, torch.where(valid, ts.mut_t, INF),
                        "amin")
    return own_max, own_min


def batched_node_displace_core(ts: TreeState, caches: Caches, grid,
                               ledger: Ledger, pop_params, offset, pri, u,
                               u_acc, k_max: int, cells_per_block: int = 4):
    """Displace up to k_max nodes (inner and tips) in one vectorised pass;
    ``offset`` ([1], in [0, cells_per_block)) shifts the cell blocks,
    ``pri`` [N] are the priorities, ``u`` and ``u_acc`` [k_max] the slots'
    proposal and acceptance uniforms.  Returns (ts, grid, ledger,
    n_attempted).

    Exactness by colouring: the grid's cells form blocks of
    ``cells_per_block`` at a random offset; a node is a candidate only if
    its whole window [t_lo, t_hi] lies in one block, one candidate per
    block wins (highest priority), and a child whose parent won is dropped.
    The winners then touch disjoint terms of the log-posterior (branch
    terms, k_bar cells, their own -log N(t) point terms), so their
    bounded-exponential MH moves compose exactly like sequential ones.

    The winners are compacted, in ascending node order, into k_max slots
    by an integer prefix sum (exact in any order); winners beyond k_max are
    dropped.  Only the real slots write their node: the JAX function also
    writes node 0's old time from each unfilled slot, and where node 0 is a
    winner and accepted those writes undo its move on the CPU while its
    delta stays in the ledger (a reference behaviour, ROADMAP)."""
    N = ts.num_nodes
    C = grid.num_cells
    cpb = cells_per_block
    n_blocks = C // cpb
    dev = ts.t.device

    own_max, child_min = _segment_minmax_mut_times(ts)
    nodes = torch.arange(N, device=dev)
    is_tip = ts.is_tip
    parent = ts.parent.long()
    safe_par = parent.clamp(min=0)
    c0 = ts.children[:, 0].long()
    c1 = ts.children[:, 1].long()

    def child_bound(c):
        cs = c.clamp(min=0)
        return torch.where(c >= 0, torch.minimum(ts.t[cs], child_min[cs]),
                           INF)

    t_lo = torch.maximum(ts.t[safe_par], own_max)
    t_lo = torch.where(is_tip, torch.maximum(t_lo, ts.t_min), t_lo)
    t_hi = torch.where(is_tip, ts.t_max,
                       torch.minimum(child_bound(c0), child_bound(c1)))
    movable = (nodes != ts.root) & (t_lo < t_hi)

    # block colouring at the offset; the clamp before the integer cast
    # changes no candidate (a clamped window is off the grid either way)
    def cell(t):
        rel = torch.clamp((t - grid.t_lo) / grid.t_step, -cpb - 1.0, C + 1.0)
        return torch.floor(rel).long() + offset
    cell_lo, cell_hi = cell(t_lo), cell(t_hi)
    blk_lo = torch.where(cell_lo >= 0, cell_lo // cpb, -1)
    blk_hi = torch.where(cell_hi >= 0, cell_hi // cpb, -1)
    fits = movable & (cell_lo >= 0) & (cell_hi < C) & (blk_lo == blk_hi)

    pri = torch.where(fits, pri, -1.0)
    blk = blk_lo.clamp(0, n_blocks - 1)
    best = torch.full((n_blocks,), -1.0, dtype=DTYPE, device=dev) \
        .scatter_reduce(0, blk, pri, "amax")
    selected = fits & (pri >= 0.0) & (pri == best[blk])
    # drop children whose parent is selected (tree adjacency)
    selected = selected & ~(selected[safe_par] & (parent >= 0))

    # the first k_max winners in node order, slot k_max for the rest
    pos = torch.cumsum(selected.long(), 0) - 1
    slot = torch.where(selected & (pos < k_max), pos, k_max)
    idx = torch.full((k_max + 1,), -1, dtype=torch.long, device=dev) \
        .scatter(0, slot, nodes)[:k_max]
    slot_ok = idx >= 0
    si = idx.clamp(min=0)

    # d logG/dt per node (subrun.cpp:171-182, 248-252)
    lam = caches.lambda_i[si]
    sc0, sc1 = c0[si], c1[si]
    lam_b0 = torch.where(sc0 >= 0, lam + caches.dlam_miss[sc0.clamp(min=0)],
                         0.0)
    lam_b1 = torch.where(sc1 >= 0, lam + caches.dlam_miss[sc1.clamp(min=0)],
                         0.0)
    d = -lam + lam_b0 + lam_b1

    a, b, old_t = t_lo[si], t_hi[si], ts.t[si]
    new_t = bounded_exp_core(u, d, a, b)
    in_bounds = slot_ok & (new_t > a) & (new_t < b)

    # per-slot coalescent delta over the whole cell axis (disjoint supports)
    node_is_tip = is_tip[si]
    sign = torch.where(node_is_tip, 1.0, -1.0).to(DTYPE)
    lbs = grid.cell_lbounds()[None, :]
    frac_old = torch.clamp((old_t[:, None] - lbs) / grid.t_step, 0.0, 1.0)
    frac_new = torch.clamp((new_t[:, None] - lbs) / grid.t_step, 0.0, 1.0)
    dk = sign[:, None] * (frac_new - frac_old)          # [k_max, C]
    kb = grid.k_bar[None, :]
    delta_quad = -torch.sum(grid.t_step * ((kb + dk) * (kb + dk - 1.0)
                                           - kb * (kb - 1.0))
                            / (2.0 * grid.popsize_bar[None, :]), 1)
    logN_new = torch.log(popm.pop_at_time(pop_params, new_t))
    logN_old = torch.log(popm.pop_at_time(pop_params, old_t))
    delta_coal = delta_quad + torch.where(node_is_tip, 0.0,
                                          -(logN_new - logN_old))

    delta_log_G = d * (new_t - old_t)
    # the bounded-exponential proposal density cancels delta_log_G
    accept = in_bounds & ((delta_coal >= 0.0)
                          | (torch.log(u_acc) < delta_coal))

    # accepted slots write their node; the rest write a scratch entry N
    dst = torch.where(accept, si, N)
    t = torch.cat([ts.t, ts.t[:1]]).scatter(0, dst, new_t)[:N]
    ts = ts._replace(t=t)
    grid = grid._replace(k_bar=grid.k_bar + torch.sum(
        torch.where(accept[:, None], dk, 0.0), 0))
    ledger = ledger._replace(
        log_G=ledger.log_G + torch.sum(torch.where(accept, delta_log_G, 0.0)),
        log_coal=ledger.log_coal + torch.sum(torch.where(accept, delta_coal,
                                                         0.0)))
    return ts, grid, ledger, torch.sum(slot_ok.long())


def batched_node_displace(ts: TreeState, caches: Caches, grid,
                          ledger: Ledger, pop_params, gen: torch.Generator,
                          t_max_tip, k_max: int, cells_per_block: int = 4):
    """batched_node_displace_core on draws from ``gen``.  ``t_max_tip`` is
    unused, as in the JAX function's signature."""
    dev = ts.t.device
    offset = torch.randint(0, cells_per_block, (1,), generator=gen,
                           device=dev)
    pri = torch.rand(ts.num_nodes, generator=gen, dtype=DTYPE, device=dev)
    return batched_node_displace_core(
        ts, caches, grid, ledger, pop_params, offset, pri,
        uniforms(gen, k_max, dev), uniforms(gen, k_max, dev), k_max,
        cells_per_block)


def batched_branch_reform_core(ts: TreeState, ledger: Ledger,
                               evo: EvoParams, chosen, u, u_acc):
    """Resample the mutation times on the distinct branches above the nodes
    ``chosen`` (the root's excluded) in one vectorised pass; ``u`` [M] and
    ``u_acc`` [N] are uniforms in (0, 1).

    Exactness: the EMAT log-likelihood is additive over branches and a
    reform touches only its own branch's mutation times (lambda_i and the
    coalescent prior are unaffected), so reforms of distinct branches are
    independent MH kernels: accepting each on its own equals composing
    them in sequence."""
    N = ts.num_nodes
    L = ts.num_sites
    root = ts.root.long().reshape(1)
    in_batch = torch.zeros(N, dtype=torch.bool, device=ts.t.device) \
        .index_fill(0, chosen, True).index_fill(0, root, False)

    node_safe = ts.mut_node.clamp(min=0).long()
    mut_in = in_batch[node_safe] & (ts.mut_node >= 0)
    t_P = ts.t[ts.parent.long()[node_safe].clamp(min=0)]
    t_X = ts.t[node_safe]
    raw = t_P + u * (t_X - t_P)
    # groups are (branch, site): each keeps its time order
    group = torch.where(mut_in, node_safe.to(DTYPE) * L
                        + ts.mut_site.to(DTYPE), INF)
    new_mut_t = torch.where(mut_in, _matched_times(ts.mut_t, raw, group),
                            ts.mut_t)

    per_slot = torch.where(mut_in, -_mut_slopes(ts, evo)
                           * (new_mut_t - ts.mut_t), 0.0)
    delta_per_node = add_at(torch.zeros(N, dtype=DTYPE, device=ts.t.device),
                            node_safe, per_slot)
    accept_node = in_batch & ((delta_per_node >= 0.0)
                              | (torch.log(u_acc) < delta_per_node))
    accept_slot = accept_node[node_safe] & mut_in

    ts = ts._replace(mut_t=torch.where(accept_slot, new_mut_t, ts.mut_t))
    ledger = ledger._replace(log_G=ledger.log_G + torch.sum(
        torch.where(accept_node, delta_per_node, 0.0)))
    return ts, ledger


def random_branches(gen: torch.Generator, n_nodes: int, batch_size: int,
                    rows: int, device):
    """[rows, min(batch_size, n_nodes)] distinct nodes per row: the head of
    a uniform random permutation (argsort of uniforms)."""
    keys = torch.rand((rows, n_nodes), generator=gen, dtype=DTYPE,
                      device=device)
    return torch.argsort(keys, 1)[:, :batch_size]


def batched_branch_reform(ts: TreeState, ledger: Ledger, evo: EvoParams,
                          gen: torch.Generator, batch_size: int):
    """batched_branch_reform_core on ``batch_size`` distinct random
    branches."""
    dev = ts.t.device
    chosen = random_branches(gen, ts.num_nodes, batch_size, 1, dev)[0]
    return batched_branch_reform_core(
        ts, ledger, evo, chosen,
        uniforms(gen, ts.mut_t.shape[0], dev, lo=1e-16),
        uniforms(gen, ts.num_nodes, dev))
