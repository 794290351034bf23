"""SPR1 and subtree-slide moves for missation-free trees (port of
``delphy_tpu/ops/spr_move.py``), as PyTorch on tensors.

End-to-end device SPR1 on a padded-per-branch tree representation: the
bounded study + weights (``spr_study.py``) pick the regraft edge and time,
the constrained history sampler (``history.py``) proposes the new branch
history, the MH ratio assembles from closed-form branch terms, and the
accepted surgery (detach + merge, split + attach, new branch history) is
fixed-shape tensor rewriting.

Scope (the JAX package's v1 restrictions; ``Run`` keeps the native host
kernel, and this module is a counterpart for tests and measurement):
  * missation-free trees — the graft analysis collapses to ONE branch info
    (hot = all sites; reference spr_move.h:47-84 with empty missation maps),
  * inner moves only: X's parent is not the root, and root-branch regraft
    regions are dropped from the study (no root changes).

Under those restrictions the branch-merge at the detach point and the
branch-split at the attach point are log_G-NEUTRAL, so delta_log_G is just
the new-vs-old P->X branch term — exactly the host graft's delta_log_G
(topo/graft.py _finish_graft_analysis, reference spr_move.cpp:246-316).

Representation: per-branch padded mutation lists (N, W) sorted by time.

How the JAX program's pieces map here:
  * Scalars are one-element tensors, and single nodes are read and written
    through one-element index tensors, never through a Python number read
    back from the device.  Every index is clamped into range: on an
    eligible move every index is in range already (X, its parent, sibling
    and grandparent, the target and its parent are real nodes), and an
    ineligible move's throw-away arithmetic, where JAX would wrap or drop
    an index, cannot fault and is discarded.
  * Every root walk (``lax.while_loop`` up the parent chain, capped at
    P_MAX steps) reads one row of an ancestor table built by pointer
    doubling: seven gathers give each node's first 128 ancestors in order.
    The walk's per-branch work then runs on all the rows at once, with the
    same step cap and the same overflow flags, and no host synchronisation.
  * Each move is a deterministic ``*_core`` fed its draws (``Spr1Draws``,
    ``SlideDraws``) and a wrapper that draws them from a ``torch.Generator``.
    The Nielsen rejection loops become A candidate attempts per history
    slot; a core flags ``exhausted`` when an eligible move has a slot with
    no accepted attempt, and a sweep then gives that move more attempts
    and runs it again (the first accepted attempt of the longer list is the
    same sample).  The sweeps run their moves without reading that flag
    and read all of a sweep's flags once at its end: one host sync per sweep
    (plus a rerun from the first exhausted move, ~1e-5 per move).
  * The JAX ``spr1_step`` and ``slide_step`` are ``spr1_core`` and
    ``slide_core`` on a move's draws; ``spr1_sweep``, ``slide_sweep`` and
    ``spr1_sweep_lanes`` draw them from a generator (``n_moves=1`` for one
    move), and ``spr1_sweep_core`` / ``slide_sweep_core`` replay them.
  * ``vmap`` over chains becomes a lanes form (``spr1_sweep_lanes``): the
    lanes' moves interleaved in one loop, each lane equal to its own run.

The float dtype and the device are the packed tree's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import DEFAULT_DEVICE, resolve_device, resolve_dtype
from ..phylo import FlatTree, Mutation
from . import history as _hist
from . import spr_study as _study

INF = math.inf

D_MAX = 192   # event-buffer slots for a through-root path composition
P_MAX = 96    # max path depth
H_D = 96      # delta-site history slots
H_RT = 24     # round-trip-site history slots
_ANC_COLS = 128   # ancestor-table columns: >= P_MAX + 2, a power of two
_SITE_SENTINEL = 2 ** 30

TREE_KEYS = ("parent", "children", "t", "mcount", "msite", "mfrom", "mto",
             "mt", "root")


# ---------------------------------------------------------------------------
# indexing
# ---------------------------------------------------------------------------

def _g(x, i):
    """x[i] for an index tensor i, clamped into range."""
    return x[i.clamp(0, x.shape[0] - 1)]


def _set(x, i, v):
    """x with row i (a one-element index tensor, clamped into range) set to
    v (a tensor, or a number filled on the device: a number turned into a
    tensor there would be copied from the host, a host sync)."""
    if not isinstance(v, torch.Tensor):
        v = torch.full((), v, dtype=x.dtype, device=x.device)
    return x.index_put((i.clamp(0, x.shape[0] - 1),), v.to(x.dtype))


def _ar(n: int, device):
    return torch.arange(n, device=device)


def _select(accept, new: dict, old: dict) -> dict:
    return {k: torch.where(accept.reshape((1,) * old[k].dim()), new[k],
                           old[k]) for k in TREE_KEYS}


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def pack_tree(tree: FlatTree, W: int | None = None, device=DEFAULT_DEVICE,
              dtype=None) -> dict:
    """FlatTree (no missations) -> padded-per-branch tensors on ``device``
    in ``dtype`` (``resolve_dtype``).  The tensors are copies: the packed
    tree shares no memory with the FlatTree's arrays."""
    N = tree.num_nodes
    if any(iv for iv in tree.miss_intervals):
        raise ValueError("pack_tree takes missation-free trees only")
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)
    counts = np.array([len(tree.mutations[b]) for b in range(N)])
    if W is None:
        W = int(max(8, 2 * counts.max() + 4))
    msite = np.full((N, W), -1, dtype=np.int64)
    mfrom = np.zeros((N, W), dtype=np.int64)
    mto = np.zeros((N, W), dtype=np.int64)
    mt = np.full((N, W), np.inf)
    for b in range(N):
        for i, m in enumerate(tree.mutations[b]):
            msite[b, i], mfrom[b, i], mto[b, i], mt[b, i] = \
                m.site, m.from_, m.to, m.t

    def I(a):
        # torch.from_numpy aliases: copy, so later host edits of the
        # FlatTree cannot reach the packed tree (on the CPU .to() is a
        # no-op that would keep the alias)
        return torch.from_numpy(np.array(a, dtype=np.int64, copy=True)).to(
            dev)

    def F(a):
        return torch.from_numpy(np.array(a, dtype=np.float64, copy=True)).to(
            dev, dtype)
    return dict(parent=I(tree.parent), children=I(tree.children),
                t=F(tree.t), mcount=I(counts), msite=I(msite),
                mfrom=I(mfrom), mto=I(mto), mt=F(mt),
                root=torch.tensor([int(tree.root)], dtype=torch.int64,
                                  device=dev))


def unpack_tree(p, tree_template: FlatTree) -> FlatTree:
    """Padded tensors -> FlatTree (for oracle checks)."""
    out = tree_template.copy()

    def H(x):
        return x.detach().cpu().numpy()
    out.parent = H(p["parent"]).astype(out.parent.dtype)
    out.children = H(p["children"]).astype(out.children.dtype)
    out.t = H(p["t"]).astype(np.float64)
    N = out.num_nodes
    mc = H(p["mcount"])
    ms, mf, mtt, mti = (H(p["msite"]), H(p["mfrom"]), H(p["mto"]),
                        H(p["mt"]).astype(np.float64))
    out.mutations = [
        [Mutation(site=int(ms[b, i]), from_=int(mf[b, i]), to=int(mtt[b, i]),
                  t=float(mti[b, i])) for i in range(int(mc[b]))]
        for b in range(N)
    ]
    return out


# ---------------------------------------------------------------------------
# surgery
# ---------------------------------------------------------------------------

def _sibling(children, P, X):
    c = _g(children, P)
    return torch.where(c[:, 0] == X, c[:, 1], c[:, 0])


def detach(p, X):
    """Detach X: merge its parent P away (branch G->P prepends onto S).
    Returns (packed_detached, S, P).  P becomes a floating spare node; X's
    branch row is left in place (callers overwrite it on attach).

    Pre: X's parent is not the root; counts fit W."""
    parent, children, t = p["parent"], p["children"], p["t"]
    msite, mfrom, mto, mt = p["msite"], p["mfrom"], p["mto"], p["mt"]
    mcount = p["mcount"]
    W = msite.shape[1]
    P = _g(parent, X)
    S = _sibling(children, P, X)
    G = _g(parent, P)

    cp, cs = _g(mcount, P), _g(mcount, S)
    idx = _ar(W, t.device)
    from_p = idx < cp
    src_s = (idx - cp).clamp(0, W - 1)

    def merged(a, pad):
        row_p, row_s = _g(a, P)[0], _g(a, S)[0]
        n = torch.where(from_p, row_p, row_s[src_s])
        return torch.where(idx < cp + cs, n, pad)
    msite = _set(msite, S, merged(msite, -1))
    mfrom = _set(mfrom, S, merged(mfrom, 0))
    mto = _set(mto, S, merged(mto, 0))
    mt = _set(mt, S, merged(mt, INF))
    mcount = _set(mcount, S, cp + cs)
    row_g = _g(children, G)
    children = _set(children, G, torch.where(row_g == P, S, row_g))
    parent = _set(parent, S, G)
    # neutralize P so path walks cannot route through it and the region
    # space stays clean
    parent = _set(parent, P, -1)
    mcount = _set(mcount, P, 0)
    pd = dict(parent=parent, children=children, t=t, mcount=mcount,
              msite=msite, mfrom=mfrom, mto=mto, mt=mt, root=p["root"])
    return pd, S, P


def attach(p, X, P, SS, t_new, h_site, h_from, h_to, h_t, h_count):
    """Re-attach detached X on branch SS at time t_new, reusing spare node P,
    and set X's branch mutations to the sampled history (h_*, time-sorted,
    padded with +inf times / site -1).

    Pre: SS is not X and not in X's (detached) subtree; counts fit W."""
    parent, children, t = p["parent"], p["children"], p["t"]
    msite, mfrom, mto, mt = p["msite"], p["mfrom"], p["mto"], p["mt"]
    mcount = p["mcount"]
    W = msite.shape[1]
    idx = _ar(W, t.device)
    GG = _g(parent, SS)
    css = _g(mcount, SS)
    mt_ss = _g(mt, SS)[0]
    upper = (mt_ss < t_new) & (idx < css)   # go to the new G'->P branch
    n_up = upper.sum().reshape(1)
    # P's row: SS's upper muts (already time-sorted, stable compaction)
    ord_up = torch.argsort((~upper).to(torch.int32), stable=True)
    ord_lo = torch.argsort(torch.where(upper, INF, mt_ss), stable=True)
    n_lo = css - n_up
    rows = {}
    for name, a, pad in (("msite", msite, -1), ("mfrom", mfrom, 0),
                         ("mto", mto, 0), ("mt", mt, INF)):
        row_ss = _g(a, SS)[0]
        a = _set(a, P, torch.where(idx < n_up, row_ss[ord_up], pad))
        # SS keeps the lower muts
        rows[name] = _set(a, SS, torch.where(idx < n_lo, row_ss[ord_lo], pad))
    msite, mfrom, mto, mt = (rows["msite"], rows["mfrom"], rows["mto"],
                             rows["mt"])
    mcount = _set(_set(mcount, P, n_up), SS, n_lo)
    # wire GG -> P -> {SS, X}
    row_gg = _g(children, GG)
    children = _set(children, GG, torch.where(row_gg == SS, P, row_gg))
    parent = _set(parent, P, GG)
    parent = _set(parent, SS, P)
    parent = _set(parent, X, P)
    children = _set(children, P, torch.cat([torch.minimum(SS, X),
                                            torch.maximum(SS, X)]))
    t = _set(t, P, t_new)

    # X's branch = proposed history
    msite = _set(msite, X, h_site)
    mfrom = _set(mfrom, X, h_from)
    mto = _set(mto, X, h_to)
    mt = _set(mt, X, h_t)
    mcount = _set(mcount, X, h_count)
    return dict(parent=parent, children=children, t=t, mcount=mcount,
                msite=msite, mfrom=mfrom, mto=mto, mt=mt, root=p["root"])


def detach_attach(p, X, SS, t_new, h_site, h_from, h_to, h_t, h_count):
    """detach + attach in one call (SS given in the ORIGINAL tree's ids)."""
    pd, S, P = detach(p, X)
    SS = torch.where(SS == P, S, SS)  # old P's branch merged onto S
    return attach(pd, X, P, SS, t_new, h_site, h_from, h_to, h_t, h_count)


def branch_log_G(t_top, t_bot, lam_bot, site, frm, to, tmid, count, mu, nu,
                 qtab, qatab, part):
    """calc_branch_log_G (phylo_tree_calc.h:185-206) over one padded row."""
    active = _ar(site.shape[0], site.device) < count
    s = site.clamp(min=0)
    nus = nu[s]
    ps = part[s] * 4
    qa_f = qatab[ps + frm]
    qa_t = qatab[ps + to]
    qrate = qtab[ps * 4 + frm * 4 + to]
    term = (-mu * nus * (qa_f - qa_t) * (tmid - t_top)
            + torch.log(torch.clamp(mu * nus * qrate, min=1e-300)))
    return (-lam_bot * (t_bot - t_top)
            + torch.where(active, term, 0.0).sum())


def log_alpha_mut(L, T, M, d, mu_prop):
    """Proposal density of a closed branch history (graft.py:487-501,
    spr_move.cpp:799-866): K-truncated-Poisson/uniformization forward terms
    minus the Nielsen endpoint-acceptance normalization."""
    out = -mu_prop * L * T + M * torch.log(mu_prop / 3.0)
    P_AC = -0.25 * torch.expm1(-4.0 / 3.0 * mu_prop * T)
    out = out - ((L - d) * torch.log1p(-3.0 * P_AC) + d * torch.log(P_AC))
    return out


# ---------------------------------------------------------------------------
# Path delta composition (site_deltas.h:42-157)
# ---------------------------------------------------------------------------

def compose_events(site, frm, to, valid):
    """Compose an ordered event sequence into per-site deltas: per site,
    from = first event's from, to = last event's to; identity pairs dropped
    (site_deltas.push_back chains).  Inputs are order-stamped by position
    on the last axis (leading axes are independent rows); invalid slots
    have site < 0.  Returns (sites, froms, tos, count) sorted by site,
    padded with -1; count is one element for a single row, one a row
    otherwise.

    Each group's first and last slot is written once; only the sink slot
    takes duplicate writes."""
    one = site.dim() == 1
    if one:
        site, frm, to, valid = (x[None] for x in (site, frm, to, valid))
    K, D = site.shape
    dev = site.device
    # stable sort by site (invalid last) keeps the event order within each
    # site group
    o = torch.argsort(torch.where(valid, site, _SITE_SENTINEL), dim=1,
                      stable=True)
    s, f, t_, v = (x.gather(1, o) for x in (site, frm, to, valid))
    edge = torch.full((K, 1), -2, dtype=s.dtype, device=dev)
    is_first = v & (s != torch.cat([edge, s[:, :-1]], 1))
    is_last = v & (s != torch.cat([s[:, 1:], edge], 1))
    gid = torch.cumsum(is_first.long(), 1) - 1
    sink = D  # one spare slot as the scatter sink for masked writes
    idx_first = torch.where(is_first, gid, sink)
    idx_last = torch.where(is_last, gid, sink)
    g_site = torch.full((K, D + 1), -1, dtype=s.dtype, device=dev).scatter(
        1, idx_first, s)[:, :D]
    g_from = torch.zeros((K, D + 1), dtype=f.dtype, device=dev).scatter(
        1, idx_first, f)[:, :D]
    g_to = torch.zeros((K, D + 1), dtype=t_.dtype, device=dev).scatter(
        1, idx_last, t_)[:, :D]
    ar = _ar(D, dev)
    keep = ((ar < is_first.sum(1, keepdim=True)) & (g_from != g_to)
            & (g_site >= 0))
    # compact kept entries to the front (stable, site order preserved)
    o2 = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    n_keep = keep.sum(1)
    out = (torch.where(ar < n_keep[:, None], g_site.gather(1, o2), -1),
           g_from.gather(1, o2), g_to.gather(1, o2))
    if one:
        return (*(x[0] for x in out), n_keep)
    return (*out, n_keep)


def _ancestors(parent, nodes, n_cols: int = _ANC_COLS):
    """(len(nodes), n_cols): column j holds parent^j(node), -1 past the root
    (or past a floating node), by pointer doubling."""
    N = parent.shape[0]
    dev = parent.device
    sink = torch.full((1,), N, dtype=parent.dtype, device=dev)
    up = torch.cat([torch.where(parent >= 0, parent, N), sink])
    cols = torch.where(nodes >= 0, nodes, N).reshape(-1, 1)
    while cols.shape[1] < n_cols:
        cols = torch.cat([cols, up[cols]], 1)
        up = up[up]
    cols = cols[:, :n_cols]
    return torch.where(cols == N, -1, cols)


def _append_rows(p, buf, n, ok, rows, use, filt, t_cut, inverse: bool):
    """Append the mutations of branches ``rows`` (in order) to the event
    buffers: row r's slots where ``use[r]``, time-filtered (mt <= t_cut)
    where ``filt[r]``; each row's mutations in reverse-time order and as
    inverses when ``inverse``.  Writes past D_MAX are dropped and clear
    ``ok``."""
    msite, mfrom, mto, mt = p["msite"], p["mfrom"], p["mto"], p["mt"]
    W = msite.shape[1]
    rc = rows.clamp(min=0)
    idx = _ar(W, rows.device)
    sel = (use[:, None] & (idx < p["mcount"][rc][:, None])
           & (~filt[:, None] | (mt[rc] <= t_cut)))
    cnt = sel.sum(1)
    r = torch.cumsum(sel.long(), 1) - 1
    rank = cnt[:, None] - 1 - r if inverse else r
    start = n + torch.cumsum(cnt, 0) - cnt
    pos = start[:, None] + rank
    total = cnt.sum()
    ok = ok & (n + total <= D_MAX)
    dst = torch.where(sel & (pos < D_MAX), pos, D_MAX).reshape(-1)
    bs, bf, bt = buf
    f_src, t_src = (mto, mfrom) if inverse else (mfrom, mto)
    bs = bs.index_put((dst,), msite[rc].reshape(-1))
    bf = bf.index_put((dst,), f_src[rc].reshape(-1))
    bt = bt.index_put((dst,), t_src[rc].reshape(-1))
    return (bs, bf, bt), n + total, ok


def _collect_up(p, b0, t0, inverse: bool, buf, n, ok):
    """Walk b0 -> root appending each branch's mutations (first branch
    time-filtered at t0; reverse-time order when inverse)."""
    path = _ancestors(p["parent"], b0)[0]
    rows = path[:P_MAX]
    first = _ar(P_MAX, rows.device) == 0
    buf, n, ok = _append_rows(p, buf, n, ok, rows, rows >= 0, first, t0,
                              inverse)
    return buf, n, ok & (path[P_MAX:P_MAX + 1] < 0)  # reached the root


def deltas_between_dev(p, ba, ta, bb, tb):
    """Device twin of site_deltas.deltas_between: per-site deltas between
    tree points (ba, ta) and (bb, tb), composed through the root.  Returns
    (sites, froms, tos, count, ok) with ok=False on buffer overflow."""
    dev = p["t"].device
    # D_MAX + 1 slots: the last is the sink of dropped writes
    buf = (torch.full((D_MAX + 1,), -1, dtype=torch.int64, device=dev),
           torch.zeros(D_MAX + 1, dtype=torch.int64, device=dev),
           torch.zeros(D_MAX + 1, dtype=torch.int64, device=dev))
    n = torch.zeros(1, dtype=torch.int64, device=dev)
    ok = torch.ones(1, dtype=torch.bool, device=dev)
    # a -> root: inverse mutations in reverse-time order per branch
    buf, n, ok = _collect_up(p, ba, ta, True, buf, n, ok)
    # root -> b: forward, top-down, the path's first P_MAX nodes
    path = _ancestors(p["parent"], bb)[0, :P_MAX]
    pl = (path >= 0).sum()
    i = _ar(P_MAX, dev)
    rows = path[(pl - 1 - i).clamp(0, P_MAX - 1)]
    buf, n, ok = _append_rows(p, buf, n, ok, rows, i < pl, i == pl - 1, tb,
                              False)
    bs, bf, bt = (b[:D_MAX] for b in buf)
    s, f, t_, cnt = compose_events(bs, bf, bt, _ar(D_MAX, dev) < n)
    return s, f, t_, cnt, ok


# ---------------------------------------------------------------------------
# Device study pipeline: padded rows -> region arrays -> flood -> rewrites
# ---------------------------------------------------------------------------

def study_regions(p, X, t_X, d0_site, d0_t0, d0_cnt, seed_branch,
                  miss_rs=None, miss_re=None):
    """Bounded (<=1 crossing) study on the padded tree, seeded at region
    (seed_branch, 0) with |d0| deltas: returns per-region arrays in
    POST-DETACH coordinates (branch, mut_idx, above, t_min, t_max, mm,
    t_S, alive) over the static region space R = N*W + N + 1 (slot R-1 is
    the sink).  With (miss_rs, miss_re) — a run row of the sites missing at
    X — crossings at those sites are NOT counted (cost-0 edges, host
    study.py:82-87); without, every mutation crossing is counted.

    The flat mutation arrays are gathered (each slot from its branch row),
    not scattered."""
    parent, children, t = p["parent"], p["children"], p["t"]
    msite, mt = p["msite"], p["mt"]
    mfrom, mto = p["mfrom"], p["mto"]
    mcount = p["mcount"]
    N, W = msite.shape
    MC = N * W
    R = MC + N + 1
    root = p["root"]
    dev = t.device

    moff = torch.cat([torch.zeros(1, dtype=mcount.dtype, device=dev),
                      torch.cumsum(mcount, 0)])
    rid_base = moff[:N] + _ar(N, dev)

    # flat mutation arrays (CSR by branch, time order within branch)
    j = _ar(MC, dev)
    j_valid = j < moff[N]
    fb = torch.searchsorted(moff[1:].contiguous(), j, right=True).clamp(
        max=N - 1)
    col = (j - moff[fb]).clamp(0, W - 1)
    fsite = torch.where(j_valid, msite[fb, col], -1)
    ffrom = torch.where(j_valid, mfrom[fb, col], 0)
    fto = torch.where(j_valid, mto[fb, col], 0)
    ft = torch.where(j_valid, mt[fb, col], INF)
    fbranch = torch.where(j_valid, fb, 0)

    r_above = torch.where(j_valid, j + fbranch, R - 1)
    if miss_rs is None:
        counted = j_valid  # no missations: every crossing is counted
    else:
        from . import runset as _rsn
        counted = j_valid & ~_rsn.contains_many(miss_rs, miss_re,
                                                fsite.clamp(min=0))

    # junction pairs; detached/floating nodes (parent < 0) and the root get
    # the sink
    jb = _ar(N, dev)
    j_ok = (jb != root) & (parent >= 0)
    jp_c = parent.clamp(0, N - 1)
    jr_child = torch.where(j_ok, rid_base, R - 1)
    jr_parent = torch.where(j_ok, rid_base[jp_c] + mcount[jp_c], R - 1)

    # composition-effect arrays for the single counted crossing (d0_site is
    # sorted among its first d0_cnt entries; -1 pads would sort FIRST, so
    # re-pad to a huge sentinel for the search)
    D0 = d0_site.shape[0]
    d0s_srch = torch.where(_ar(D0, dev) < d0_cnt, d0_site, _SITE_SENTINEL)
    dpos = torch.searchsorted(d0s_srch, fsite)
    dpos_c = dpos.clamp(0, D0 - 1)
    hit = (dpos < d0_cnt) & (d0_site[dpos_c] == fsite) & j_valid
    t0 = d0_t0[dpos_c]
    d_down = torch.where(hit, torch.where(fto == t0, -1, 0), 1)
    d_up = torch.where(hit, torch.where(ffrom == t0, -1, 0), 1)

    seed_rid = _g(rid_base, seed_branch)
    excl_lo = _g(rid_base, X)
    excl_hi = excl_lo + _g(mcount, X)
    reach0, reach1, vmm1 = _study._bounded_flood(
        R, seed_rid, excl_lo, excl_hi, r_above, counted, jr_parent,
        jr_child, d0_cnt, d_down, d_up)

    # region arrays over R
    rid = _ar(R, dev)
    rb = torch.searchsorted(rid_base, rid, right=True) - 1
    rb_c = rb.clamp(0, N - 1)
    ridx = rid - rid_base[rb_c]
    in_range = (rid < MC + N) & (ridx >= 0) & (ridx <= mcount[rb_c])
    alive = (reach0 | reach1) & in_range
    mm = torch.where(reach0, d0_cnt, vmm1)

    j_lo = (moff[rb_c] + ridx - 1).clamp(0, MC - 1)
    j_hi = (moff[rb_c] + ridx).clamp(0, MC - 1)
    pb = parent[rb_c].clamp(0, N - 1)
    t_min = torch.where(ridx == 0, t[pb], ft[j_lo])
    t_max = torch.where(ridx == mcount[rb_c], t[rb_c], ft[j_hi])
    is_root_b = rb_c == root
    t_min = torch.where(is_root_b, -INF, t_min)
    t_max = torch.where(is_root_b, _g(t, root), t_max)

    # ---- detachment accounting (spr_study.cpp:130-208), inner/no-root-
    # change variant: regions on the root branch are dropped
    P = _g(parent, X)
    S = _sibling(children, P, X)
    nmGP = _g(mcount, P)
    drop = alive & (rb_c == root)
    on_S = alive & (rb_c == S)
    on_P = alive & (rb_c == P)
    # P != root here (inner restriction).  S regions: idx += nmGP; idx==0
    # additionally inherits region_t_min(P, nmGP)
    gpb = _g(parent, P).clamp(0, N - 1)
    tmin_P_last = torch.where(nmGP == 0, _g(t, gpb),
                              _g(ft, (_g(moff, P) + nmGP - 1).clamp(
                                  0, MC - 1)))
    t_min = torch.where(on_S & (ridx == 0), tmin_P_last, t_min)
    ridx = torch.where(on_S, ridx + nmGP, ridx)
    # P regions: idx == nmGP dropped, others become S-branch regions
    drop = drop | (on_P & (ridx == nmGP))
    rb_c = torch.where(on_P & (ridx != nmGP), S, rb_c)
    alive = alive & ~drop
    # t_X future trim
    alive = alive & (t_min < t_X)
    t_max = torch.minimum(t_max, t_X)

    return dict(branch=rb_c, mut_idx=ridx,
                above=torch.zeros(R, dtype=torch.bool, device=dev),
                t_min=t_min, t_max=t_max, mm=mm.to(t.dtype),
                t_S=t[rb_c], alive=alive)


# ---------------------------------------------------------------------------
# The SPR1 and subtree-slide moves
# ---------------------------------------------------------------------------

def _state_at_dev(p, ref_seq, branch, t0, sites):
    """State of each of ``sites`` at point (branch, t0): latest mutation
    at/above wins (site_deltas.state_at), within the first P_MAX branches
    of the root walk."""
    msite, mto, mt = p["msite"], p["mto"], p["mt"]
    W = msite.shape[1]
    dev = sites.device
    rows = _ancestors(p["parent"], branch)[0, :P_MAX]
    rc = rows.clamp(min=0)
    idx = _ar(W, dev)
    first = _ar(P_MAX, dev) == 0
    base = ((rows >= 0)[:, None] & (idx < p["mcount"][rc][:, None])
            & (~first[:, None] | (mt[rc] <= t0)))
    sel = base[None] & (msite[rc][None] == sites[:, None, None])
    any_r = sel.any(2)
    r_star = torch.argmax(any_r.to(torch.int8), 1)
    sel_r = sel[_ar(sites.shape[0], dev), r_star]
    last = torch.argmax(torch.where(sel_r, idx, -1), 1)
    s = mto[rc][r_star, last]
    return torch.where(any_r.any(1), s, ref_seq[sites.clamp(min=0)].long())


def _lambda_at_dev(p, X, lambda_ref, mu, nu, qatab, part):
    """lambda at node X: lambda_ref + per-branch mutation adjustments along
    the root path (phylo_tree_calc.h:107-155, missation-free)."""
    msite, mfrom, mto = p["msite"], p["mfrom"], p["mto"]
    W = msite.shape[1]
    rows = _ancestors(p["parent"], X)[0, :P_MAX]
    rc = rows.clamp(min=0)
    sel = ((rows >= 0)[:, None]
           & (_ar(W, rows.device) < p["mcount"][rc][:, None]))
    s = msite[rc].clamp(min=0)
    ps = part[s] * 4
    d = mu * nu[s] * (qatab[ps + mto[rc]] - qatab[ps + mfrom[rc]])
    return lambda_ref + torch.where(sel, d, 0.0).sum(1).sum()


class HistDraws(NamedTuple):
    """Draws of a block of history slots: A candidate attempts per slot."""
    u_k: torch.Tensor     # [S, A] event-count uniforms
    steps: torch.Tensor   # [S, A, KMAX] chain steps in {1, 2, 3}
    u_t: torch.Tensor     # [S, KMAX] event-time uniforms


class Spr1Draws(NamedTuple):
    X: torch.Tensor       # (1,) node in [0, N)
    u_reg: torch.Tensor   # (1,) region pick
    u_t: torch.Tensor     # (1,) time pick
    u_rt: torch.Tensor    # (L,) round-trip mask
    d: HistDraws          # H_D delta-site slots
    r: HistDraws          # H_RT round-trip slots
    u_mh: torch.Tensor    # (1,) acceptance


class SlideDraws(NamedTuple):
    X: torch.Tensor       # (1,) node in [0, N)
    z: torch.Tensor       # (1,) standard normal displacement
    u_pick: torch.Tensor  # (1,) straddling-branch pick
    u_rt: torch.Tensor    # (L,)
    d: HistDraws
    r: HistDraws
    u_mh: torch.Tensor    # (1,)


def _draw_hist(gen, S: int, A: int, dtype, device) -> HistDraws:
    u_k, steps = _hist.draw_attempts(gen, S, A, dtype, device)
    u_t = torch.rand((S, _hist.KMAX), generator=gen, dtype=dtype,
                     device=device)
    return HistDraws(u_k, steps, u_t)


def draw_spr1(gen, N: int, L: int, dtype, device,
              attempts: int = _hist.ATTEMPTS) -> Spr1Draws:
    def u(n=1):
        return torch.rand((n,), generator=gen, dtype=dtype, device=device)
    return Spr1Draws(
        X=torch.randint(0, N, (1,), generator=gen, device=device),
        u_reg=u(), u_t=u(), u_rt=u(L),
        d=_draw_hist(gen, H_D, attempts, dtype, device),
        r=_draw_hist(gen, H_RT, attempts, dtype, device), u_mh=u())


def draw_slide(gen, N: int, L: int, dtype, device,
               attempts: int = _hist.ATTEMPTS) -> SlideDraws:
    def u(n=1):
        return torch.rand((n,), generator=gen, dtype=dtype, device=device)
    return SlideDraws(
        X=torch.randint(0, N, (1,), generator=gen, device=device),
        z=torch.randn((1,), generator=gen, dtype=dtype, device=device),
        u_pick=u(), u_rt=u(L),
        d=_draw_hist(gen, H_D, attempts, dtype, device),
        r=_draw_hist(gen, H_RT, attempts, dtype, device), u_mh=u())


def more_attempts(gen, draws, attempts: int = _hist.ATTEMPTS):
    """``draws`` with ``attempts`` more candidate attempts per history slot
    appended (the earlier attempts keep their places)."""
    def ext(h: HistDraws) -> HistDraws:
        u_k, steps = _hist.draw_attempts(gen, h.u_k.shape[0], attempts,
                                         h.u_k.dtype, h.u_k.device)
        return h._replace(u_k=torch.cat([h.u_k, u_k], 1),
                          steps=torch.cat([h.steps, steps], 1))
    return draws._replace(d=ext(draws.d), r=ext(draws.r))


def _old_graft(p, Xc, t_P_old, t_X, lam_X, L, mu, nu, qtab, qatab, part,
               mu_prop):
    """X's current branch: its log_G term, its composed deltas and the
    proposal density of its history."""
    W = p["msite"].shape[1]
    M_old = _g(p["mcount"], Xc)
    rows = [_g(p[k], Xc)[0] for k in ("msite", "mfrom", "mto", "mt")]
    dG_old = branch_log_G(t_P_old, t_X, lam_X, *rows, M_old, mu, nu, qtab,
                          qatab, part)
    d0 = compose_events(rows[0], rows[1], rows[2],
                        _ar(W, Xc.device) < M_old)
    dt = t_X.dtype
    alpha_old = log_alpha_mut(float(L), t_X - t_P_old, M_old.to(dt),
                              d0[3].to(dt), mu_prop)
    return dG_old, d0, alpha_old


def _new_branch(p_det, ref_seq, L: int, t_X, SS_det, t_new, S_det, t_P_old,
                d0, lam_X, mu_prop, mu, nu, qtab, qatab, part, draws,
                eligible):
    """The proposed history of X's branch hung at (SS_det, t_new): the
    deltas it must carry, their constrained histories, the round trips, the
    new row in time order, its log_G term and proposal density.  Shared by
    both moves (the JAX functions repeat it)."""
    dev = t_X.device
    dt = t_X.dtype
    W = p_det["msite"].shape[1]
    d0s, d0f, d0t, d0c = d0
    bs, bf2, bt2, bc, ok = deltas_between_dev(p_det, SS_det, t_new, S_det,
                                              t_P_old)
    # compose with d0 (order: new->old path deltas, then old->X deltas)
    cat_s = torch.cat([torch.where(_ar(D_MAX, dev) < bc, bs, -1),
                       torch.where(_ar(d0s.shape[0], dev) < d0c, d0s, -1)])
    nds, ndf, ndt, ndc = compose_events(cat_s, torch.cat([bf2, d0f]),
                                        torch.cat([bt2, d0t]), cat_s >= 0)
    ok = ok & (ndc <= H_D)

    # histories for delta sites
    T_new = t_X - t_new
    h_active = _ar(H_D, dev) < ndc
    h_frm = torch.where(h_active, ndf[:H_D], 0)
    h_to = torch.where(h_active, ndt[:H_D], 1)
    k_d, st_d, tm_d, found_d = _hist.site_history_core(
        h_frm, h_to, T_new, mu_prop, *draws.d, min_k=1)

    # round-trip sites (not delta sites)
    rt_mask = _hist.roundtrip_mask_core(draws.u_rt, T_new, mu_prop)
    DN = nds.shape[0]
    nd_pad = torch.where(_ar(DN, dev) < ndc, nds, _SITE_SENTINEL)
    sit = _ar(L, dev)
    pos = torch.searchsorted(nd_pad, sit)
    is_delta = (pos < ndc) & (nd_pad[pos.clamp(max=DN - 1)] == sit)
    rt_mask = rt_mask & ~is_delta
    n_rt = rt_mask.sum().reshape(1)
    ok = ok & (n_rt <= H_RT)
    # the first H_RT round-trip sites in site order (the JAX function's
    # stable argsort of the mask, as the k-th True of a running count)
    kth = torch.searchsorted(torch.cumsum(rt_mask.long(), 0),
                             _ar(H_RT, dev) + 1).clamp(max=L - 1)
    rt_active = _ar(H_RT, dev) < n_rt
    rt_sites = torch.where(rt_active, kth, -1)
    rt_state = _state_at_dev(p_det, ref_seq, SS_det, t_new,
                             rt_sites.clamp(min=0))
    rt_from = torch.where(rt_active, rt_state, 0)
    k_r, st_r, tm_r, found_r = _hist.site_history_core(
        rt_from, rt_from, T_new, mu_prop, *draws.r, min_k=2)
    # an eligible move whose active slot accepted none of its attempts is
    # not a sample yet: its wrapper reruns it with more attempts
    exhausted = eligible & ok & (
        (h_active & ~found_d).any() | (rt_active & ~found_r).any())

    # assemble the new branch row (global time order)
    KM = _hist.KMAX
    kk = _ar(KM, dev)
    ev_site = torch.cat([
        torch.where(h_active, nds[:H_D], -1).repeat_interleave(KM),
        rt_sites.repeat_interleave(KM)])
    ev_in_k = torch.cat([(kk[None] < k_d[:, None]).reshape(-1),
                         (kk[None] < k_r[:, None]).reshape(-1)])
    ev_act = (torch.cat([h_active.repeat_interleave(KM),
                         rt_active.repeat_interleave(KM)])
              & ev_in_k & (ev_site >= 0))
    ev_to = torch.cat([st_d.reshape(-1), st_r.reshape(-1)])
    # chain froms: previous state in the chain (frm for slot 0)
    prev_d = torch.cat([h_frm[:, None], st_d[:, :-1]], 1).reshape(-1)
    prev_r = torch.cat([rt_from[:, None], st_r[:, :-1]], 1).reshape(-1)
    ev_from = torch.cat([prev_d, prev_r])
    ev_t = torch.cat([tm_d.reshape(-1), tm_r.reshape(-1)]) + t_X
    M_new = ev_act.sum().reshape(1)
    ok = ok & (M_new <= W)
    o = torch.argsort(torch.where(ev_act, ev_t, INF), stable=True)[:W]
    take = _ar(W, dev) < M_new
    row = (torch.where(take, ev_site[o], -1), torch.where(take, ev_from[o], 0),
           torch.where(take, ev_to[o], 0), torch.where(take, ev_t[o], INF))

    dG_new = branch_log_G(t_new, t_X, lam_X, *row, M_new, mu, nu, qtab,
                          qatab, part)
    alpha_new = log_alpha_mut(float(L), T_new, M_new.to(dt), ndc.to(dt),
                              mu_prop)
    return dict(row=row, M_new=M_new, dG_new=dG_new, alpha_new=alpha_new,
                nds=nds, ndt=ndt, ndc=ndc, n_rt=n_rt, ok=ok,
                exhausted=exhausted)


def _pick_x(p, X):
    """X, the eligibility of an inner move of X, and (Xc, P, S, t_X,
    t_P_old) with Xc = 0 where X is not eligible."""
    parent, children, t = p["parent"], p["children"], p["t"]
    N = parent.shape[0]
    root = p["root"]
    P0 = _g(parent, X.clamp(0, N - 1))
    eligible = (X != root) & (P0 >= 0) & (P0 != root)
    Xc = torch.where(eligible, X, 0)
    pX = _g(parent, Xc)
    P = pX.clamp(0, N - 1)
    eligible = eligible & (pX >= 0) & (pX != root)
    S = _sibling(children, P, Xc)
    return eligible, Xc, P, S, _g(t, Xc), _g(t, P)


def spr1_core(p, ref_seq, L: int, mu, nu, qtab, qatab, part, lambda_ref,
              t_max_tip, draws: Spr1Draws, f: float = 0.8):
    """One SPR1 move (missation-free, inner, no root change) on given draws.

    Mirrors mixer._spr1 / subrun.cpp:492-675: pick X, bounded study +
    annealed weights pick (branch, time), JC history proposal, MH with the
    forward/reverse study densities and the closed-branch proposal
    densities; the coalescent term is left to the caller (flat here).
    Returns (p_out, accepted, delta_log_G, eligible, diag); diag's
    ``exhausted`` says the draws held too few history attempts."""
    eligible, Xc, P, S, t_X, t_P_old = _pick_x(p, draws.X)

    lam_X = _lambda_at_dev(p, Xc, lambda_ref, mu, nu, qatab, part)
    eligible = eligible & (lam_X > 0.0)
    mu_prop = lam_X / L

    dG_old, d0, alpha_old = _old_graft(p, Xc, t_P_old, t_X, lam_X, L, mu,
                                       nu, qtab, qatab, part, mu_prop)
    d0s, _, d0t, d0c = d0

    # forward study (pre-detach coordinates; rewrites give post-detach ids)
    reg = study_regions(p, Xc, t_X, d0s, d0t, d0c, S)
    lw = _study.study_log_weights(reg, lam_X, f, t_X, t_max_tip, mu_prop,
                                  above_root=False)
    lw = torch.where(reg["alive"], lw, -INF)
    eligible = eligible & torch.isfinite(lw).any()
    i_fwd = _study.pick_nexus_region(draws.u_reg, lw)
    new_S = _g(reg["branch"], i_fwd)
    t_new = _study.pick_time_in_region(draws.u_t, i_fwd, reg, lam_X, f, t_X,
                                       t_max_tip, above_root=False)
    eligible = eligible & (t_new < t_X) & (t_new > _g(reg["t_min"], i_fwd))
    alpha_fwd = _study.log_alpha_in_region(i_fwd, t_new, lw, reg, lam_X, f,
                                           t_X, t_max_tip, above_root=False)

    # detach; required deltas and proposed history for the new branch
    p_det, S_det, Pf = detach(p, Xc)
    nb = _new_branch(p_det, ref_seq, L, t_X, new_S, t_new, S_det, t_P_old,
                     d0, lam_X, mu_prop, mu, nu, qtab, qatab, part, draws,
                     eligible)
    p_new = attach(p_det, Xc, Pf, new_S, t_new, *nb["row"], nb["M_new"])

    # reverse study on the post-move tree, seeded at the new sibling
    reg_r = study_regions(p_new, Xc, t_X, nb["nds"], nb["ndt"], nb["ndc"],
                          new_S)
    lw_r = _study.study_log_weights(reg_r, lam_X, f, t_X, t_max_tip, mu_prop,
                                    above_root=False)
    lw_r = torch.where(reg_r["alive"], lw_r, -INF)
    hit_old = (reg_r["alive"] & (reg_r["branch"] == S_det)
               & (reg_r["t_min"] < t_P_old) & (t_P_old <= reg_r["t_max"]))
    i_rev = torch.argmax(hit_old.to(torch.int8)).reshape(1)
    found_rev = hit_old.any()
    alpha_rev = _study.log_alpha_in_region(i_rev, t_P_old, lw_r, reg_r,
                                           lam_X, f, t_X, t_max_tip,
                                           above_root=False)

    ok = nb["ok"]
    log_mh = ((nb["dG_new"] - nb["alpha_new"]) - (dG_old - alpha_old)
              + alpha_rev - alpha_fwd)
    accept = (eligible & ok & found_rev
              & ((log_mh >= 0.0) | (torch.log(draws.u_mh) < log_mh)))
    p_out = _select(accept, p_new, p)
    dlg = torch.where(accept, nb["dG_new"] - dG_old, 0.0)
    diag = dict(eligible=eligible, ok=ok, found_rev=found_rev,
                n_regions=torch.isfinite(lw).sum(), ndc=nb["ndc"],
                n_rt=nb["n_rt"], M_new=nb["M_new"], log_mh=log_mh,
                exhausted=nb["exhausted"])
    return p_out, accept, dlg, eligible & ok, diag


def _straddling_mask(parent, t, anc, t_cut, X, root, table=None):
    """Nodes whose branch straddles t_cut inside anc's subtree, excluding
    X's subtree — the device form of enumerate_straddling (mixer.py; native
    Mixer::enumerate_straddling): node n qualifies iff t[n] >= t_cut, every
    ancestor strictly below anc has t < t_cut, n's ancestor chain reaches
    anc within P_MAX steps, and the chain does not pass through X.
    ``table`` is ``_ancestors(parent, all nodes)`` where the caller has it."""
    N = parent.shape[0]
    dev = parent.device
    n0 = _ar(N, dev)
    if table is None:
        table = _ancestors(parent, n0)
    C = table[:, 1:P_MAX + 1]            # parent^1 .. parent^P_MAX
    hit = C == anc
    in_anc = hit.any(1) & (n0 != anc)
    k = torch.argmax(hit.to(torch.int8), 1)[:, None]
    cols = _ar(P_MAX, dev)[None]
    via_x = (n0 == X) | ((C == X) & (cols <= k)).any(1)
    # index -1 (past the root) reads the appended -inf
    t_ext = torch.cat([t, torch.full((1,), -INF, dtype=t.dtype, device=dev)])
    blocked = ((C >= 0) & (cols < k) & (t_ext[C] >= t_cut)).any(1)
    return (t >= t_cut) & in_anc & ~via_x & ~blocked & (n0 != X)


def slide_core(p, ref_seq, L: int, mu, nu, qtab, qatab, part, lambda_ref,
               t_max_tip, draws: SlideDraws):
    """One subtree-slide move (missation-free, inner, no root change) on
    given draws — mixer.py subtree_slide / subrun.cpp:184-209 + native
    Mixer::subtree_slide: displace P along/through branches with a normal
    proposal, with the straddling-count Hastings ratio when the slide hops
    junctions.  Returns (p_out, accepted, delta_log_G, eligible, diag)."""
    parent, t = p["parent"], p["t"]
    N = parent.shape[0]
    dev = t.device
    dt = t.dtype
    root = p["root"]
    eligible, Xc, P, S, t_X, t_P_old = _pick_x(p, draws.X)
    G = _g(parent, P).clamp(0, N - 1)

    lam_X = _lambda_at_dev(p, Xc, lambda_ref, mu, nu, qatab, part)
    eligible = eligible & (lam_X > 0.0)
    mu_prop = lam_X / L

    t_root = _g(t, root)
    span = torch.clamp(t_max_tip - t_root, min=0.0)
    scale = torch.minimum(0.5 / lam_X, span)
    delta_t = scale * draws.z
    t_new = t_P_old + delta_t

    # --- choose the target branch SS + Hastings ratio --------------------
    up_deep = (delta_t < 0) & (t_new < _g(t, G))
    down = delta_t >= 0
    eligible = eligible & ~(down & (t_new > t_X))

    table = _ancestors(parent, _ar(N, dev))
    # climb: highest ancestor whose parent time <= t_new
    path = _g(table, P)[0]
    up_p = path[1:P_MAX + 1]
    climb = (up_p >= 0) & (t_new < t[up_p.clamp(min=0)])
    j = torch.where(climb.all(), P_MAX,
                    torch.argmax((~climb).to(torch.int8))).reshape(1)
    SS_up = path[j]
    # reverse-count for the up case: branches straddling old_t_P under SS_up
    mask_up = _straddling_mask(parent, t, SS_up, t_P_old, Xc, root, table)
    n_up_brs = mask_up.sum().to(dt)
    # forward pick for the down case: branches straddling t_new under P
    # (P's own subtree minus X = S's side; P itself excluded)
    mask_dn = (_straddling_mask(parent, t, P, t_new, Xc, root, table)
               & (_ar(N, dev) != P))
    n_dn_brs = mask_dn.sum()
    down_deep = down & (t_new > _g(t, S))
    csum = torch.cumsum(mask_dn.long(), 0).to(dt)
    pick = torch.searchsorted(csum, torch.floor(draws.u_pick * n_dn_brs)
                              + 1.0)
    SS_dn = pick.clamp(0, N - 1)

    SS = torch.where(up_deep, SS_up, torch.where(down_deep, SS_dn, S))
    log_alpha_ratio = torch.where(
        up_deep, -torch.log(torch.clamp(n_up_brs, min=1.0)),
        torch.where(down_deep, torch.log(torch.clamp(n_dn_brs.to(dt),
                                                     min=1.0)), 0.0))
    eligible = eligible & ~(down_deep & (n_dn_brs == 0))
    eligible = eligible & (SS != root) & (t_new < t_X)
    # the slide's time must land strictly inside SS's branch
    SSc = SS.clamp(0, N - 1)
    pSS = _g(parent, SSc).clamp(0, N - 1)
    eligible = eligible & ((SS == S) | ((t_new <= _g(t, SSc))
                                        & (t_new > _g(t, pSS))))

    # --- old graft terms --------------------------------------------------
    dG_old, d0, alpha_old = _old_graft(p, Xc, t_P_old, t_X, lam_X, L, mu,
                                       nu, qtab, qatab, part, mu_prop)

    # --- detach; target deltas; history (same blocks as spr1_core) --------
    p_det, S_det, Pf = detach(p, Xc)
    SS_det = torch.where(SS == P, S_det, SS)
    eligible = eligible & (t_X - t_new > 0)
    nb = _new_branch(p_det, ref_seq, L, t_X, SS_det, t_new, S_det, t_P_old,
                     d0, lam_X, mu_prop, mu, nu, qtab, qatab, part, draws,
                     eligible)
    p_new = attach(p_det, Xc, Pf, SS_det, t_new, *nb["row"], nb["M_new"])

    ok = nb["ok"]
    log_mh = ((nb["dG_new"] - nb["alpha_new"]) - (dG_old - alpha_old)
              + log_alpha_ratio)
    accept = (eligible & ok
              & ((log_mh >= 0.0) | (torch.log(draws.u_mh) < log_mh)))
    p_out = _select(accept, p_new, p)
    dlg = torch.where(accept, nb["dG_new"] - dG_old, 0.0)
    diag = dict(eligible=eligible, ok=ok, ndc=nb["ndc"], n_rt=nb["n_rt"],
                M_new=nb["M_new"], log_mh=log_mh, exhausted=nb["exhausted"])
    return p_out, accept, dlg, eligible & ok, diag


# ---------------------------------------------------------------------------
# wrappers: draws from a generator, sweeps, lanes
# ---------------------------------------------------------------------------

class SweepResult(NamedTuple):
    p: dict
    n_accepted: torch.Tensor   # (1,) int64
    delta_log_G: torch.Tensor  # (1,) sum over accepted moves
    n_eligible: torch.Tensor   # (1,) int64
    exhausted: torch.Tensor    # (1,) bool: some move lacked attempts


def _sum_moves(p, moves) -> SweepResult:
    dev = p["t"].device
    n_acc = torch.zeros(1, dtype=torch.int64, device=dev)
    n_el = torch.zeros(1, dtype=torch.int64, device=dev)
    dlg = torch.zeros(1, dtype=p["t"].dtype, device=dev)
    exh = torch.zeros(1, dtype=torch.bool, device=dev)
    for acc, g, el, ex in moves:
        n_acc = n_acc + acc.long()
        dlg = dlg + g
        n_el = n_el + el.long()
        exh = exh | ex
    return SweepResult(p, n_acc, dlg, n_el, exh)


def _run_moves(core, p, draws_seq):
    moves = []
    for d in draws_seq:
        p, acc, g, el, diag = core(p, d)
        moves.append((acc, g, el, diag["exhausted"]))
    return _sum_moves(p, moves)


def spr1_sweep_core(p, ref_seq, L: int, mu, nu, qtab, qatab, part,
                    lambda_ref, t_max_tip, draws_seq, f: float = 0.8):
    """SPR1 moves in sequence on given draws, enqueued without a host
    sync.  ``exhausted`` says whether some move lacked history attempts."""
    return _run_moves(lambda pp, d: spr1_core(
        pp, ref_seq, L, mu, nu, qtab, qatab, part, lambda_ref, t_max_tip, d,
        f), p, draws_seq)


def slide_sweep_core(p, ref_seq, L: int, mu, nu, qtab, qatab, part,
                     lambda_ref, t_max_tip, draws_seq):
    """Subtree-slide moves in sequence on given draws (as
    ``spr1_sweep_core``)."""
    return _run_moves(lambda pp, d: slide_core(
        pp, ref_seq, L, mu, nu, qtab, qatab, part, lambda_ref, t_max_tip, d),
        p, draws_seq)


def _sweeps(core, draw, gen, ps, n_moves: int, record,
            more=more_attempts) -> list:
    """n_moves of ``core`` on each packed tree of ``ps`` (lanes interleaved
    move by move), on draws made up front by ``draw()``.  The moves run
    without a host sync; all the lanes' exhaustion flags are read once at
    the end, and a lane whose move lacked attempts reruns from that move
    with more attempts (``more(gen, draws)``: the same samples as a
    move-by-move loop)."""
    draws = [[draw() for _ in range(n_moves)] for _ in ps]
    start = [0] * len(ps)           # each lane's first move still to run
    states = [[p] for p in ps]      # states[lane][m]: the tree before move m
    moves = [[] for _ in ps]
    todo = list(range(len(ps))) if n_moves else []
    while todo:
        for lane in todo:
            del states[lane][start[lane] + 1:]
            del moves[lane][start[lane]:]
        for m in range(min(start[lane] for lane in todo), n_moves):
            for lane in todo:
                if m >= start[lane]:
                    p_out, acc, g, el, diag = core(states[lane][-1],
                                                   draws[lane][m])
                    states[lane].append(p_out)
                    moves[lane].append((acc, g, el, diag["exhausted"]))
        flags = torch.stack([torch.cat([mv[3] for mv in moves[lane]])
                             for lane in todo])
        rerun = []
        # the sweep's one host sync (and one more per rerun, ~1e-5 a move)
        for lane, bad, fl in zip(todo, flags.any(1).tolist(), flags):
            if bad:
                first = int(torch.argmax(fl.to(torch.int8)))
                draws[lane][first] = more(gen, draws[lane][first])
                start[lane] = first
                rerun.append(lane)
        todo = rerun
    if record is not None:
        record.extend(draws)
    return [_sum_moves(st[-1], mv) for st, mv in zip(states, moves)]


def spr1_sweep(gen, p, ref_seq, L: int, n_moves: int, mu, nu, qtab, qatab,
               part, lambda_ref, t_max_tip, f: float = 0.8,
               record=None) -> SweepResult:
    """n_moves sequential SPR1 moves on draws from ``gen`` — the production
    dispatch shape: a whole topology sweep per call, one host sync.
    ``record`` (a list) receives the list of the draws the moves used,
    which ``spr1_sweep_core`` replays."""
    return spr1_sweep_lanes(gen, [p], ref_seq, L, n_moves, mu, nu, qtab,
                            qatab, part, lambda_ref, t_max_tip, f, record)[0]


def spr1_sweep_lanes(gen, ps, ref_seq, L: int, n_moves: int, mu, nu, qtab,
                     qatab, part, lambda_ref, t_max_tip, f: float = 0.8,
                     record=None) -> list:
    """spr1_sweep on each packed tree of ``ps`` (lanes of one shape, the
    counterpart of the JAX package's vmap over chains): the lanes' moves
    interleaved and their exhaustion flags read together, one host sync
    for all the lanes.  Each lane equals spr1_sweep_core on its own draws
    (``record`` receives one list per lane)."""
    dtype, dev = ps[0]["t"].dtype, ps[0]["t"].device
    N = ps[0]["parent"].shape[0]
    return _sweeps(
        lambda pp, d: spr1_core(pp, ref_seq, L, mu, nu, qtab, qatab, part,
                                lambda_ref, t_max_tip, d, f),
        lambda: draw_spr1(gen, N, L, dtype, dev), gen, ps, n_moves, record)


def slide_sweep(gen, p, ref_seq, L: int, n_moves: int, mu, nu, qtab, qatab,
                part, lambda_ref, t_max_tip, record=None) -> SweepResult:
    """n_moves sequential subtree-slide moves on draws from ``gen``, one
    host sync (as ``spr1_sweep``)."""
    dtype, dev = p["t"].dtype, p["t"].device
    N = p["parent"].shape[0]
    return _sweeps(
        lambda pp, d: slide_core(pp, ref_seq, L, mu, nu, qtab, qatab, part,
                                 lambda_ref, t_max_tip, d),
        lambda: draw_slide(gen, N, L, dtype, dev), gen, [p], n_moves,
        record)[0]
