"""SPR1 moves on trees WITH missations (port of
``delphy_tpu/ops/spr_miss.py``), as PyTorch on tensors.

Inner moves, can_change_root=False: the per-part production regime, where
only the part holding the global root runs rooty moves.  This extends the
missation-free device move (``spr_move.py``) with the reference's warm/hot
missation machinery (core/spr_move.cpp:9-316, 868-1070):

- per-branch missations as padded interval-run rows (``runset.py``) plus
  small from-state rows (site, state), the device twin of the native
  kernel's interval-run ``Sites`` and flat fs maps (topo_native.cpp);
- the graft analysis's sliding-set walk (host: topo/graft.py _start_inner);
- peel/apply mutation slides with per-sibling from-state updates;
- detach/attach missation factoring (host: graft.py move(); native:
  topo_native.cpp SprContext::move) as run unions, differences and
  intersections with fixed caps: a cap overflow rejects the proposal (the
  ``ok`` flags of the JAX functions, raised in the same places).

All host-twin formulas cite topo/graft.py, which is pinned move for move to
the native production kernel.  ``Run`` does not call this module (in
either package): it is a counterpart for tests and measurement.

How the JAX program's loops map here (none synchronises the host):
  * A root walk (``lax.while_loop`` up the parent chain, P_MAX steps)
    reads a row of the ancestor table (``spr_move._ancestors``).
  * A fold of run-row set operations along a path (the missing-at union,
    the inherit walk, the normalisation cascade and the un-factoring walk
    of ``move_dev``, the sliding sets of ``start_inner_dev``) is computed
    on the elementary segments of all the rows it reads (every row boundary
    sorted; each segment lies wholly inside or outside each run), where
    each step of the fold is a boolean operation on segment masks and a
    step that feeds on the previous one is a running max along the path.
    The result rows are the canonical runs of the final sets, equal to the
    JAX rows; the overflow flags are those of every intermediate set the
    JAX fold forms, counted from its segment mask.  The JAX inherit walk
    and cascade are unbounded; here they stop at P_MAX nodes, and a walk
    still going there rejects the move (never reached at the depths the
    tests and the benchmark part have).
  * A sequence of ``fs_set`` calls on from-state rows (``_fs_set_seq``)
    resolves each (row, site) to its last write and counts each row's
    entries op by op for the overflow flag.  New entries take free lanes
    in site order where the JAX loops take the first free lane as they
    come: the packed fs rows hold the same site -> state maps in other
    lanes, so rows are compared as maps (``unpack_tree_miss``).
  * Each move is a deterministic ``spr1_miss_core`` fed its draws
    (``Spr1MissDraws``, laid out as the JAX key splits its keys); sweeps
    draw them from a ``torch.Generator`` and read all their moves'
    "too few history attempts" flags once at the end (``spr_move._sweeps``).

The float dtype and the device are the packed tree's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import DEFAULT_DEVICE, resolve_device, resolve_dtype
from ..phylo import FlatTree, Mutation
from . import history as _hist
from . import runset as rsn
from . import spr_study as _study
from .spr_move import (INF, P_MAX, TREE_KEYS, HistDraws, SweepResult,
                       _ancestors, _ar, _g, _run_moves, _set, _sibling,
                       _state_at_dev, _sweeps, attach, compose_events,
                       deltas_between_dev, detach, study_regions)

BI_MAX = 8    # branch-info slots for the sliding walk (host walk depth)
WF = 16       # from-state row slots per node
WH = 64       # hot-mutation / hot-delta slots per branch info
H_RT_MISS = 24   # round-trip-site slots per branch info
BIG = rsn.BIG
_SITE_SENTINEL = 2 ** 30

MISS_KEYS = TREE_KEYS + ("rs", "re", "rcnt", "fsite", "fstate")


# ---------------------------------------------------------------------------
# indexing
# ---------------------------------------------------------------------------

def _node(x, device):
    """A node id as a one-element int64 tensor (a tensor is reshaped; a
    number is filled on the device, not copied from the host)."""
    if isinstance(x, torch.Tensor):
        return x.reshape(1).long()
    return torch.full((1,), int(x), dtype=torch.int64, device=device)


def _scalar(x, like):
    """A float as a one-element tensor of ``like``'s dtype and device."""
    if isinstance(x, torch.Tensor):
        return x.reshape(1).to(like.dtype)
    return torch.full((1,), float(x), dtype=like.dtype, device=like.device)


def _row(x, i):
    """Row i (a one-element index, clamped) of x."""
    return _g(x, i)[0]


def _put_rows(x, idx, vals, write):
    """x with rows ``idx`` (K,) set to ``vals`` (K, ...) where ``write``;
    the other rows go to a sink row (idx distinct where written)."""
    N = x.shape[0]
    ext = torch.cat([x, x[:1]])
    i = torch.where(write, idx.clamp(0, N - 1), N)
    return ext.index_put((i,), vals.to(x.dtype))[:N]


def _select(accept, new: dict, old: dict) -> dict:
    return {k: torch.where(accept.reshape((1,) * old[k].dim()), new[k],
                           old[k]) for k in MISS_KEYS}


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

def pack_tree_miss(tree: FlatTree, W: int | None = None,
                   WR: int | None = None, WF_: int | None = None,
                   device=DEFAULT_DEVICE, dtype=None) -> dict:
    """FlatTree -> padded rows on ``device`` in ``dtype``: mutations (as
    ``spr_move.pack_tree``) plus missation run rows (N, WR) and from-state
    rows (N, WF).  The tensors are copies of the tree's arrays."""
    N = tree.num_nodes
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)
    counts = np.array([len(tree.mutations[b]) for b in range(N)])
    if W is None:
        W = int(max(8, 2 * counts.max() + 4))
    rcounts = np.array([len(tree.miss_intervals[b]) for b in range(N)])
    if WR is None:
        WR = int(max(8, 2 * rcounts.max() + 4))
    fcounts = np.array([len(tree.miss_from_states[b]) for b in range(N)])
    wf = WF_ if WF_ is not None else int(max(WF, 2 * fcounts.max() + 4))

    msite = np.full((N, W), -1, dtype=np.int64)
    mfrom = np.zeros((N, W), dtype=np.int64)
    mto = np.zeros((N, W), dtype=np.int64)
    mt = np.full((N, W), np.inf)
    rs = np.full((N, WR), BIG, np.int64)
    re = np.full((N, WR), BIG, np.int64)
    fsite = np.full((N, wf), -1, np.int64)
    fstate = np.zeros((N, wf), np.int64)
    for b in range(N):
        for i, m in enumerate(tree.mutations[b]):
            msite[b, i], mfrom[b, i], mto[b, i], mt[b, i] = \
                m.site, m.from_, m.to, m.t
        for i, (s, e) in enumerate(tree.miss_intervals[b]):
            rs[b, i], re[b, i] = s, e
        for i, (s, f) in enumerate(sorted(tree.miss_from_states[b].items())):
            fsite[b, i], fstate[b, i] = s, f

    def I(a):
        return torch.from_numpy(np.array(a, dtype=np.int64, copy=True)).to(
            dev)

    def F(a):
        return torch.from_numpy(np.array(a, dtype=np.float64, copy=True)).to(
            dev, dtype)
    return dict(parent=I(tree.parent), children=I(tree.children),
                t=F(tree.t), mcount=I(counts), msite=I(msite),
                mfrom=I(mfrom), mto=I(mto), mt=F(mt), rs=I(rs), re=I(re),
                rcnt=I(rcounts), fsite=I(fsite), fstate=I(fstate),
                root=torch.tensor([int(tree.root)], dtype=torch.int64,
                                  device=dev))


def unpack_tree_miss(p, tree_template: FlatTree) -> FlatTree:
    """Padded tensors -> FlatTree.  The fs rows are read as site -> state
    maps of their active lanes (site >= 0), whatever lanes hold them."""
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
    rs, re, rc = H(p["rs"]), H(p["re"]), H(p["rcnt"])
    out.miss_intervals = [
        [(int(rs[b, i]), int(re[b, i])) for i in range(int(rc[b]))]
        for b in range(N)
    ]
    fsi, fst = H(p["fsite"]), H(p["fstate"])
    out.miss_from_states = []
    for b in range(N):
        d = {}
        for i in range(fsi.shape[1]):
            if fsi[b, i] >= 0:
                d[int(fsi[b, i])] = int(fst[b, i])
        out.miss_from_states.append(d)
    return out


# ---------------------------------------------------------------------------
# From-state row ops (small fixed rows; absent site => ref state)
# ---------------------------------------------------------------------------

def fs_get(fsite_row, fstate_row, ref_seq, site):
    """graft.py _get_from_state: row value or ref (one element)."""
    site = _node(site, fsite_row.device)
    hit = fsite_row == site
    return torch.where(hit.any(), torch.where(hit, fstate_row, 0).sum(),
                       ref_seq[site.clamp(min=0)].long())


def fs_bulk_add(fsite_row, fstate_row, add_site, add_val, add_mask):
    """Append (site, value) pairs into free lanes, all at once, on the last
    axis (leading axes are rows).  Pre: the added sites are not already in
    the row.  Returns (fsite, fstate, ok); ok is False when free lanes run
    out (one element for a single row).  The i-th added entry takes the
    i-th free lane (the JAX function's rule); only the sink lane takes
    duplicate writes."""
    WFn = fsite_row.shape[-1]
    shp = fsite_row.shape[:-1]
    A = add_site.shape[-1]
    dev = fsite_row.device
    add_mask = add_mask.expand(shp + (A,))
    free = fsite_row < 0
    n_add = add_mask.sum(-1)
    n_free = free.sum(-1)
    ok = n_add <= n_free
    add_rank = torch.cumsum(add_mask.long(), -1) - 1
    free_rank = torch.cumsum(free.long(), -1) - 1
    lanes = _ar(WFn, dev).expand(shp + (WFn,))
    lane_of_rank = torch.full(shp + (WFn + 1,), WFn, dtype=torch.int64,
                              device=dev).scatter(
        -1, torch.where(free, free_rank, WFn), lanes)[..., :WFn]
    tgt = torch.where(add_mask & (add_rank < n_free[..., None]),
                      lane_of_rank.gather(-1, add_rank.clamp(0, WFn - 1)),
                      WFn)
    pad = torch.zeros(shp + (1,), dtype=fsite_row.dtype, device=dev)
    fsite_out = torch.cat([fsite_row, pad], -1).scatter(
        -1, tgt, torch.where(add_mask, add_site, 0).expand(shp + (A,)))
    fstate_out = torch.cat([fstate_row, pad], -1).scatter(
        -1, tgt, torch.where(add_mask, add_val, 0).expand(shp + (A,)))
    if fsite_row.dim() == 1:
        ok = ok.reshape(1)
    return fsite_out[..., :WFn], fstate_out[..., :WFn], ok


def fs_set(fsite_row, fstate_row, ref_seq, site, state):
    """graft.py _set_from_state: the ref state erases, else upsert (into
    the first free lane).  Returns (fsite, fstate, ok); ok is False when an
    append finds no free lane."""
    dev = fsite_row.device
    site = _node(site, dev)
    state = _node(state, dev)
    is_ref = state == ref_seq[site.clamp(min=0)].long()
    hit = fsite_row == site
    present = hit.any()
    fsite_e = torch.where(hit, -1, fsite_row)
    fstate_u = torch.where(hit, state, fstate_row)
    free = fsite_row < 0
    first_free = torch.argmax(free.to(torch.int8)).reshape(1)
    can_append = free.any()
    fsite_a = fsite_row.index_put((first_free,), site)
    fstate_a = fstate_row.index_put((first_free,), state)
    fsite_out = torch.where(is_ref, fsite_e,
                            torch.where(present, fsite_row,
                                        torch.where(can_append, fsite_a,
                                                    fsite_row)))
    fstate_out = torch.where(is_ref, fstate_row,
                             torch.where(present, fstate_u,
                                         torch.where(can_append, fstate_a,
                                                     fstate_row)))
    return fsite_out, fstate_out, is_ref | present | can_append


def _fs_rows_seq(row_s, row_v, ref_seq, op_site, op_state, app):
    """``fs_set`` of ops o = 0, 1, ... in turn on each of the rows
    (R, WF), op o on row r where ``app`` (O, R).  Returns the rows and ok
    (one element): the rows hold the maps the JAX loop leaves, an entry
    updated or erased in its lane, a new one in a free lane (site order);
    ok is False where some append met a full row."""
    R, WFn = row_s.shape
    O = op_site.shape[0]
    dev = row_s.device
    o_ref = op_state == ref_seq[op_site.clamp(min=0)].long()
    # ops by site, in op order within a site
    srt = torch.argsort(op_site, stable=True)
    s_s, v_s, ref_s = op_site[srt], op_state[srt], o_ref[srt]
    app_s = app[srt].T                                       # (R, O)
    # each op's site in each row, by a search of the row's sorted sites
    row_sorted, row_lane = torch.sort(row_s, 1)
    at = torch.searchsorted(row_sorted, s_s.expand(R, O).contiguous())
    at = at.clamp(max=WFn - 1)
    pres0 = row_sorted.gather(1, at) == s_s[None, :]
    lane0 = row_lane.gather(1, at)
    pos = _ar(O, dev)
    last = torch.cummax(torch.where(app_s, pos, -1), 1).values
    prev = torch.cat([torch.full((R, 1), -1, dtype=torch.int64, device=dev),
                      last[:, :-1]], 1)
    pc = prev.clamp(min=0)
    same = (prev >= 0) & (s_s[pc] == s_s[None, :])
    pres = torch.where(same, ~ref_s[pc], pres0)              # before the op
    grow = app_s & ~pres & ~ref_s
    delta = grow.long() - (app_s & pres & ref_s).long()
    # entries before each op, in op order
    inv = torch.argsort(srt)
    n0 = (row_s >= 0).sum(1, keepdim=True)
    d_o = delta[:, inv]
    before = n0 + torch.cumsum(d_o, 1) - d_o
    ok = ~(grow[:, inv] & (before >= WFn)).any().reshape(1)
    # each (row, site): its last applied op
    end = torch.cat([s_s[1:] != s_s[:-1],
                     torch.ones(1, dtype=torch.bool, device=dev)])
    fc = last.clamp(min=0)
    touched = end[None] & (last >= 0) & (s_s[fc] == s_s[None, :])
    fin_pres = ~ref_s[fc]
    fin_v = v_s[fc]
    upd = touched & pres0
    lane = torch.where(upd, lane0, WFn)
    pad = torch.zeros((R, 1), dtype=row_s.dtype, device=dev)
    new_s = torch.cat([row_s, pad], 1).scatter(
        1, lane, torch.where(fin_pres, s_s[None, :], -1))[:, :WFn]
    new_v = torch.cat([row_v, pad], 1).scatter(1, lane, fin_v)[:, :WFn]
    new_s, new_v, _ = fs_bulk_add(new_s, new_v, s_s.expand(R, O), fin_v,
                                  touched & ~pres0 & fin_pres)
    return new_s, new_v, ok


def _fs_set_seq(fsite, fstate, ref_seq, rows, op_site, op_state, app):
    """``_fs_rows_seq`` on the rows ``rows`` (R,) of the tree's fs arrays;
    rows that no op applies to (or below 0) are left as they are."""
    rc = rows.clamp(0, fsite.shape[0] - 1)
    s, v, ok = _fs_rows_seq(fsite[rc], fstate[rc], ref_seq, op_site,
                            op_state, app)
    write = app.any(0) & (rows >= 0)
    return (_put_rows(fsite, rows, s, write),
            _put_rows(fstate, rows, v, write), ok)


# ---------------------------------------------------------------------------
# Elementary segments: folds of run-row set operations
# ---------------------------------------------------------------------------

def _segments(*rows):
    """Elementary segments [lo, hi) of run rows: all their boundaries,
    sorted.  Each segment lies wholly inside or outside each run."""
    pts = torch.sort(torch.cat([r.reshape(-1) for r in rows])).values
    return pts[:-1], pts[1:]


def _member(rs, re, x):
    """(K, S): whether x (S,) or (K, S) lies in row k's runs (rows (K, WR)
    sorted by start, padded at BIG): runset.contains_many, row by row."""
    K = rs.shape[0]
    xs = x.expand(K, x.shape[-1]).contiguous()
    i = torch.searchsorted(rs.contiguous(), xs, right=True) - 1
    return (i >= 0) & (xs < re.gather(1, i.clamp(min=0)))


def _runs(keep, lo, hi, WR_out: int, rows: bool = True):
    """The sets that ``keep`` (..., S) marks on the segments as runset rows
    (rs, re, cnt, ok), as ``runset.combine`` returns them (its merge step,
    batched); with ``rows=False`` only (cnt, ok)."""
    dev = lo.device
    nonempty = lo < hi
    keep = keep & nonempty & (lo < BIG)
    S = lo.shape[0]
    marked = torch.where(keep | nonempty, _ar(S, dev), -1)
    last = torch.cummax(marked, -1).values
    prev = torch.cat([torch.full_like(last[..., :1], -1), last[..., :-1]], -1)
    pc = prev.clamp(min=0)
    prev_end = torch.where((prev >= 0) & keep.gather(-1, pc), hi[pc], -1)
    is_start = keep & (lo != prev_end)
    n_out = is_start.sum(-1)
    ok = n_out <= WR_out
    if not rows:
        return n_out, ok
    shp = keep.shape[:-1]
    gid = torch.cumsum(is_start.long(), -1) - 1
    idx_s = torch.where(is_start & (gid < WR_out), gid, WR_out)
    rs = torch.full(shp + (WR_out + 1,), BIG, dtype=torch.int64,
                    device=dev).scatter(-1, idx_s, lo.expand(idx_s.shape))
    idx_e = torch.where(keep & (gid < WR_out), gid, WR_out)
    re = torch.zeros(shp + (WR_out + 1,), dtype=torch.int64,
                     device=dev).scatter_reduce(
        -1, idx_e, hi.expand(idx_e.shape), "amax")
    re = torch.where(_ar(WR_out, dev) < n_out.clamp(max=WR_out)[..., None],
                     re[..., :WR_out], BIG)
    return rs[..., :WR_out], re, n_out, ok


def _seg_of(lo, hi, sites):
    """(index of the segment holding each site, whether one does)."""
    i = torch.searchsorted(lo, sites, right=True) - 1
    ic = i.clamp(0, lo.shape[0] - 1)
    return ic, (i >= 0) & (sites < hi[ic])


def _rows_of(p, nodes, valid=None):
    """The run rows (K, WR) of ``nodes`` (K,), empty where not valid."""
    nc = nodes.clamp(0, p["rs"].shape[0] - 1)
    v = nodes >= 0 if valid is None else valid
    return (torch.where(v[:, None], p["rs"][nc], BIG),
            torch.where(v[:, None], p["re"][nc], BIG))


def _children_of(children, par, cur):
    """Sibling of each cur (K,) under par (K,)."""
    ch = children[par.clamp(0, children.shape[0] - 1)]
    return torch.where(ch[:, 0] == cur, ch[:, 1], ch[:, 0])


# ---------------------------------------------------------------------------
# Read-side lambda math (host twins: graft.py SprContext)
# ---------------------------------------------------------------------------

def _qa_at(qatab, part, site, state):
    s = site.clamp(min=0)
    return qatab[part[s] * 4 + state]


def _dlam_nodes(p, nodes, mu, nu, qatab, part, ref_cum_Q, ref_seq):
    """delta_lambda_across_branch of each node of ``nodes`` (K,)."""
    W = p["msite"].shape[1]
    WR = p["rs"].shape[1]
    nc = nodes.clamp(0, p["msite"].shape[0] - 1)
    dev = nodes.device
    sel = _ar(W, dev) < p["mcount"][nc][:, None]
    s = p["msite"][nc].clamp(min=0)
    dmut = mu * nu[s] * (_qa_at(qatab, part, s, p["mto"][nc])
                         - _qa_at(qatab, part, s, p["mfrom"][nc]))
    out = torch.where(sel, dmut, 0.0).sum(1)
    rsel = _ar(WR, dev) < p["rcnt"][nc][:, None]
    top = ref_cum_Q.shape[0] - 1
    rlo = p["rs"][nc].clamp(0, top)
    rhi = p["re"][nc].clamp(0, top)
    out = out - torch.where(rsel, ref_cum_Q[rhi] - ref_cum_Q[rlo], 0.0).sum(1)
    fs = p["fsite"][nc]
    fsi = fs.clamp(min=0)
    dfs = mu * nu[fsi] * (_qa_at(qatab, part, fsi, p["fstate"][nc])
                          - _qa_at(qatab, part, fsi, ref_seq[fsi].long()))
    return out - torch.where(fs >= 0, dfs, 0.0).sum(1)


def delta_lambda_across_branch_dev(p, node, mu, nu, qatab, part, ref_cum_Q,
                                   ref_seq):
    """graft.py delta_lambda_across_branch: mutation terms + run-telescoped
    missation subtraction + from-state corrections (one element)."""
    return _dlam_nodes(p, _node(node, p["t"].device), mu, nu, qatab, part,
                       ref_cum_Q, ref_seq)


def _walk(p, X):
    """The root walk's nodes: X and its first P_MAX - 1 ancestors."""
    return _ancestors(p["parent"], _node(X, p["t"].device))[0, :P_MAX]


def lambda_at_dev_miss(p, X, lambda_ref, mu, nu, qatab, part, ref_cum_Q,
                       ref_seq):
    """graft.py lambda_at: the walk up from X, at most P_MAX branches."""
    rows = _walk(p, X)
    d = _dlam_nodes(p, rows, mu, nu, qatab, part, ref_cum_Q, ref_seq)
    return lambda_ref + torch.where(rows >= 0, d, 0.0).sum()


def num_missing_at_dev(p, X):
    rows = _walk(p, X)
    rs, re = _rows_of(p, rows)
    rc = p["rcnt"][rows.clamp(min=0)]
    sizes = torch.where(_ar(rs.shape[1], rs.device) < rc[:, None], re - rs,
                        0).sum(1)
    return torch.where(rows >= 0, sizes, 0).sum().reshape(1)


def _prefix_union(rs, re, WR_out: int, first_given: bool = False):
    """The fold ``acc = union(acc, row_k)`` over rows (K, WR) in order,
    each step capped at WR_out: (rs, re, cnt, ok) of the whole union, ok
    False where some partial union needs more than WR_out runs (the first
    row's own count not checked with ``first_given``).  Also returns the
    segments and the prefix masks (K, S)."""
    lo, hi = _segments(rs, re)
    mem = _member(rs, re, lo)
    pu = torch.cummax(mem.to(torch.int8), 0).values.bool()
    cnt, ok = _runs(pu[1:] if first_given else pu, lo, hi, WR_out,
                    rows=False)
    u_rs, u_re, u_cnt, _ = _runs(pu[-1], lo, hi, WR_out)
    return (u_rs, u_re, u_cnt.reshape(1), ok.all().reshape(1)), \
        (lo, hi, mem, pu)


def missing_at_row(p, X, WR_out: int):
    """Union of missation runs at or above X (at most P_MAX branches) as one
    run row (host _is_site_missing_at / native miss_at_or_above).  Returns
    (rs, re, cnt, ok)."""
    rows = _walk(p, X)
    rs, re = _rows_of(p, rows)
    if rs.shape[1] > WR_out:
        rs, re = rs[:, :WR_out], re[:, :WR_out]
    return _prefix_union(rs, re, WR_out)[0]


def lam_over_miss_dev(rs, re, cnt, fsite_row, fstate_row, in_set_mask,
                      mu, nu, qatab, part, ref_cum_Q, ref_seq):
    """graft.py _lam_over_miss over a run row + from-state row: the lambda
    contribution of a sliding missation set just above its position.
    ``in_set_mask`` restricts the fs row to sites in the set."""
    WR = rs.shape[0]
    dev = rs.device
    rsel = _ar(WR, dev) < cnt
    top = ref_cum_Q.shape[0] - 1
    out = torch.where(rsel, ref_cum_Q[re.clamp(0, top)]
                      - ref_cum_Q[rs.clamp(0, top)], 0.0).sum()
    fsel = (fsite_row >= 0) & in_set_mask
    fsi = fsite_row.clamp(min=0)
    corr = mu * nu[fsi] * (_qa_at(qatab, part, fsi, fstate_row)
                           - _qa_at(qatab, part, fsi, ref_seq[fsi].long()))
    return (out + torch.where(fsel, corr, 0.0).sum()).reshape(1)


# ---------------------------------------------------------------------------
# Graft analysis: the sliding-set walk (host twin: graft.py _start_inner,
# can_change_root=False; reference spr_move.cpp:582-740)
# ---------------------------------------------------------------------------

def _widen_row(row, WRB: int):
    """Pad a node-width run row (..., WR) to the analysis width WRB."""
    WRn = row.shape[-1]
    if WRB < WRn:
        raise ValueError(f"analysis width {WRB} below the row width {WRn}")
    if WRB == WRn:
        return row
    return torch.cat([row, torch.full(row.shape[:-1] + (WRB - WRn,), BIG,
                                      dtype=row.dtype, device=row.device)],
                     -1)


def _sibling_dev(p, parent, child):
    return _sibling(p["children"], _node(parent, p["t"].device),
                    _node(child, p["t"].device))


def _mut_dlam(p, node, mu, nu, qatab, part, sign=+1):
    """Sum over node's mutations of mu*nu*(qa(to)-qa(from)) (sign=+1) or
    the reverse (sign=-1)."""
    node = _node(node, p["t"].device)
    W = p["msite"].shape[1]
    sel = _ar(W, node.device) < _g(p["mcount"], node)
    s = _row(p["msite"], node).clamp(min=0)
    d = mu * nu[s] * (_qa_at(qatab, part, s, _row(p["mto"], node))
                      - _qa_at(qatab, part, s, _row(p["mfrom"], node)))
    return sign * torch.where(sel, d, 0.0).sum().reshape(1)


def _first_occurrence_per_site(msite, mask):
    """mask restricted to the first (earliest: rows are time-sorted) masked
    occurrence of each site, on the last axis."""
    W = msite.shape[-1]
    ar = _ar(W, msite.device)
    same_before = ((msite[..., None, :] == msite[..., :, None])
                   & mask[..., None, :] & (ar[None, :] < ar[:, None]))
    return mask & ~same_before.any(-1)


def start_inner_dev(p, X, c, WRB: int, WH_: int = WH):
    """Device _start_inner (graft.py:300-397), can_change_root=False.

    Returns (G, ok) where G holds per-branch-info tensors over BI_MAX
    slots: A, B, T, active; hot/warm as run rows (BI_MAX, WRB) + counts
    (slot 0's sets are complements, flagged by compl_: the row stores the
    excluded sites, none for warm, miss_S for hot); plA, plX; the hot
    mutations hm_* (BI_MAX, WH_) + hm_cnt; the hot deltas hd_* (BI_MAX,
    WH_) + hd_cnt (site-sorted); n_bi, t_P, S, X (one element each)."""
    mu, nu, qatab, part = c["mu"], c["nu"], c["qatab"], c["part"]
    ref_cum_Q, ref_seq, lambda_ref = c["ref_cum_Q"], c["ref_seq"], \
        c["lambda_ref"]
    parent, children, t = p["parent"], p["children"], p["t"]
    N, W = p["msite"].shape
    dev = t.device
    root = p["root"]
    X = _node(X, dev)
    anc = _ancestors(parent, X)[0]
    P = anc[1:2].clamp(0, N - 1)
    S = _sibling_dev(p, P, X)
    t_X, t_P = _g(t, X), _g(t, P)
    nl = BI_MAX - 1
    cur = anc[1:BI_MAX]                   # level k = 1..7: cur, par
    par = anc[2:BI_MAX + 1]
    sib = _children_of(children, par, cur)

    # the sliding sets: S_0 = miss_S, S_k = S_{k-1} & miss(sib_k); the
    # hot set of level k is S_{k-1} - S_k (S_{k-1} at the part root)
    rows_rs, rows_re = _rows_of(p, torch.cat([S, sib]))
    lo, hi = _segments(rows_rs, rows_re)
    mem = _member(rows_rs, rows_re, lo)
    slid = torch.cummin(mem.to(torch.int8), 0).values.bool()   # (8, S)
    rs_sl, re_sl, cnt_sl, ok_sl = _runs(slid, lo, hi, WRB)
    rs_h, re_h, cnt_h, ok_h = _runs(slid[:-1] & ~slid[1:], lo, hi, WRB)
    s_rs = _widen_row(_row(p["rs"], S), WRB)
    s_re = _widen_row(_row(p["re"], S), WRB)
    s_cnt = _g(p["rcnt"], S)
    # level 1 slides S's own row (as the JAX walk does)
    rs_sl = torch.cat([s_rs[None], rs_sl[1:]])
    re_sl = torch.cat([s_re[None], re_sl[1:]])
    cnt_sl = torch.cat([s_cnt, cnt_sl[1:]])
    at_root = par == root
    step = ~at_root & (cnt_sl[1:] > 0)
    do = (s_cnt > 0) & torch.cat([
        torch.ones(1, dtype=torch.bool, device=dev),
        torch.cummin(step.to(torch.int8), 0).values.bool()[:-1]])
    walking = do[-1] & step[-1]

    # --- slots ---
    one = torch.ones(1, dtype=torch.bool, device=dev)
    A_arr = torch.cat([P, torch.where(do, par, -1)])
    B_arr = torch.cat([X, torch.where(do, cur, -1)])
    T_arr = torch.cat([t_X - t_P, torch.where(do, t_X - t[par.clamp(min=0)],
                                              0.0)])
    active = torch.cat([one, do])
    compl_ = torch.cat([one, torch.zeros(nl, dtype=torch.bool, device=dev)])
    big = torch.full((1, WRB), BIG, dtype=torch.int64, device=dev)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    warm_rs = torch.cat([big, torch.where(do[:, None], rs_sl[:-1], BIG)])
    warm_re = torch.cat([big, torch.where(do[:, None], re_sl[:-1], BIG)])
    warm_cnt = torch.cat([zero, torch.where(do, cnt_sl[:-1], 0)])
    h_rs = torch.where(at_root[:, None], rs_sl[:-1], rs_h)
    h_re = torch.where(at_root[:, None], re_sl[:-1], re_h)
    h_cnt = torch.where(at_root, cnt_sl[:-1], cnt_h)
    hot_rs = torch.cat([s_rs[None], torch.where(do[:, None], h_rs, BIG)])
    hot_re = torch.cat([s_re[None], torch.where(do[:, None], h_re, BIG)])
    hot_cnt = torch.cat([s_cnt, torch.where(do, h_cnt, 0)])

    # --- partial lambdas, sliding the from-states level by level ---
    lam_X_node = lambda_at_dev_miss(p, X, lambda_ref, mu, nu, qatab, part,
                                    ref_cum_Q, ref_seq)
    sfsite = _g(p["fsite"], S)                 # (1, WF): one working row
    sfstate = _g(p["fstate"], S)
    in_s0 = rsn.contains_many(s_rs, s_re, sfsite[0].clamp(min=0))
    partial = lam_over_miss_dev(s_rs, s_re, s_cnt, sfsite[0], sfstate[0],
                                in_s0, mu, nu, qatab, part, ref_cum_Q,
                                ref_seq)
    plA = [lam_X_node + _mut_dlam(p, X, mu, nu, qatab, part, sign=-1)
           - partial]
    ok_fs = one
    lane = _ar(W, dev)
    for k in range(1, BI_MAX):
        i = k - 1
        ck = cur[i:i + 1].clamp(0, N - 1)
        ms = _row(p["msite"], ck)
        mf = _row(p["mfrom"], ck)
        msk = (lane < _g(p["mcount"], ck)) & rsn.contains_many(
            rs_sl[i], re_sl[i], ms.clamp(min=0))
        s_ = ms.clamp(min=0)
        dl = mu * nu[s_] * (_qa_at(qatab, part, s_, mf)
                            - _qa_at(qatab, part, s_, _row(p["mto"], ck)))
        partial_new = partial + torch.where(msk, dl, 0.0).sum()
        first = _first_occurrence_per_site(ms, msk)
        fs_n, fv_n, okk = _fs_rows_seq(sfsite, sfstate, ref_seq, ms, mf,
                                       first[:, None])
        keep = rsn.contains_many(rs_sl[k], re_sl[k], fs_n[0].clamp(min=0)) \
            & (fs_n[0] >= 0)
        fs_p = torch.where(keep, fs_n[0], -1)
        nplB = lam_over_miss_dev(rs_sl[k], re_sl[k], cnt_sl[k:k + 1], fs_p,
                                 fv_n[0], keep, mu, nu, qatab, part,
                                 ref_cum_Q, ref_seq)
        plA.append(torch.where(at_root[i], partial_new, partial_new - nplB))
        d = do[i:i + 1]
        ok_fs = ok_fs & (~d | okk)
        sfsite = torch.where(d & ~at_root[i], fs_p,
                             torch.where(d, -1, sfsite[0]))[None]
        sfstate = fv_n
        partial = torch.where(d, nplB, partial)
    plA = torch.cat(plA)
    plA = torch.cat([plA[:1], torch.where(do, plA[1:], 0.0)])
    ok = (ok_fs & ~walking
          & (~do | (ok_h & ok_sl[1:])).all().reshape(1))

    # --- distribute hot mutations along the hot path (graft.py:373-386) ---
    Bc = B_arr.clamp(0, N - 1)
    cand_site, cand_from = p["msite"][Bc], p["mfrom"][Bc]
    cand_to, cand_t = p["mto"][Bc], p["mt"][Bc]
    cand_valid = (lane[None, :] < p["mcount"][Bc][:, None]) & active[:, None]
    in_warm = _member(warm_rs, warm_re, cand_site.clamp(min=0))
    in_warm = torch.where(compl_[:, None], True, in_warm)
    flat_site = cand_site.reshape(-1)
    flat_from = cand_from.reshape(-1)
    flat_to = cand_to.reshape(-1)
    flat_t = cand_t.reshape(-1)
    flat_src = _ar(BI_MAX, dev).repeat_interleave(W)
    flat_ok = (cand_valid & in_warm).reshape(-1)
    in_hot = _member(hot_rs, hot_re, flat_site.clamp(min=0))
    in_hot = torch.where(compl_[:, None], ~in_hot, in_hot)
    kk = _ar(BI_MAX, dev)
    sel = (flat_ok[None, :] & (flat_src[None, :] <= kk[:, None])
           & active[:, None] & in_hot)
    nsel = sel.sum(1)
    ok = ok & (nsel <= WH_).all()
    # time-ascending order = the host's final hot_muts order
    order = torch.argsort(torch.where(sel, flat_t[None, :], INF), dim=1,
                          stable=True)[:, :WH_]
    good = _ar(WH_, dev)[None, :] < nsel[:, None]
    hm_s = torch.where(good, flat_site[order], -1)
    hm_f = torch.where(good, flat_from[order], 0)
    hm_t2 = torch.where(good, flat_to[order], 0)
    hm_tt = torch.where(good, flat_t[order], INF)
    hm_cnt = nsel

    # --- hot deltas (composition in time order) + plX ---
    hact = _ar(WH_, dev)[None, :] < hm_cnt[:, None]
    hd_s, hd_f, hd_t, hd_cnt = compose_events(hm_s, hm_f, hm_t2, hact)
    s_ = hm_s.clamp(min=0)
    dlam = mu * nu[s_] * (_qa_at(qatab, part, s_, hm_t2)
                          - _qa_at(qatab, part, s_, hm_f))
    plX = plA + torch.where(hact, dlam, 0.0).sum(1)
    plX = torch.where(active, plX, 0.0)

    G = dict(A=A_arr, B=B_arr, T=T_arr, active=active, compl_=compl_,
             warm_rs=warm_rs, warm_re=warm_re, warm_cnt=warm_cnt,
             hot_rs=hot_rs, hot_re=hot_re, hot_cnt=hot_cnt,
             plA=plA, plX=plX,
             hm_s=hm_s, hm_f=hm_f, hm_t2=hm_t2, hm_tt=hm_tt, hm_cnt=hm_cnt,
             hd_s=hd_s, hd_f=hd_f, hd_t=hd_t, hd_cnt=hd_cnt,
             n_bi=active.sum().reshape(1), t_P=t_P, S=S, X=X)
    return G, ok


# ---------------------------------------------------------------------------
# Finish: delta_log_G + log_alpha_mut (host graft.py _finish_graft_analysis;
# reference spr_move.cpp:246-316, 799-866).  Inner, all-closed variant.
# ---------------------------------------------------------------------------

def _row_sizes(rs, re, cnt):
    lane = _ar(rs.shape[-1], rs.device)
    return torch.where(lane < cnt[..., None], re - rs, 0).sum(-1)


def finish_dev(p, G, c, mu_prop, L: int):
    mu, nu, qatab, qtab, part = c["mu"], c["nu"], c["qatab"], c["qtab"], \
        c["part"]
    dt = p["t"].dtype
    t_X = _g(p["t"], G["X"])
    WH_ = G["hm_s"].shape[1]
    dev = t_X.device
    # branch_log_G of each branch info's row
    site, frm, to, tmid = G["hm_s"], G["hm_f"], G["hm_t2"], G["hm_tt"]
    t_top = t_X - G["T"]
    s = site.clamp(min=0)
    ps = part[s] * 4
    qrate = qtab[ps * 4 + frm * 4 + to]
    term = (-mu * nu[s] * (qatab[ps + frm] - qatab[ps + to])
            * (tmid - t_top[:, None])
            + torch.log(torch.clamp(mu * nu[s] * qrate, min=1e-300)))
    act_h = _ar(WH_, dev)[None, :] < G["hm_cnt"][:, None]
    dG = (-G["plX"] * (t_X - t_top)
          + torch.where(act_h, term, 0.0).sum(1))
    # hot-site count; B == X (slot 0) uses the adjusted count
    # (graft.py:489-492)
    size_h = _row_sizes(G["hot_rs"], G["hot_re"], G["hot_cnt"])
    size_w = _row_sizes(G["warm_rs"], G["warm_re"], G["warm_cnt"])
    Lh = torch.where(G["compl_"], L - size_h, size_h)
    Lw = torch.where(G["compl_"], L - size_w, size_w)
    n_miss_X = num_missing_at_dev(p, G["X"])
    first = _ar(BI_MAX, dev) == 0
    Lh = torch.where(first, (L - n_miss_X) - (Lw - Lh), Lh).to(dt)
    T = G["T"]
    M = G["hm_cnt"].to(dt)
    d = G["hd_cnt"].to(dt)
    al = -mu_prop * Lh * T + M * torch.log(mu_prop / 3.0)
    P_AC = torch.clamp(-0.25 * torch.expm1(-4.0 / 3.0 * mu_prop * T),
                       min=1e-300)
    al = al - ((Lh - d) * torch.log1p(-3.0 * P_AC) + d * torch.log(P_AC))
    act = G["active"]
    return (torch.where(act, dG, 0.0).sum().reshape(1),
            torch.where(act, al, 0.0).sum().reshape(1))


# ---------------------------------------------------------------------------
# Peel (host graft.py _peel_inner, closed-final variant;
# reference spr_move.cpp:868-975)
# ---------------------------------------------------------------------------

def _path_and_sibs(p, X, B):
    """Junction path X -> B (exclusive): the sibling of each node on it,
    bottom-up (P_MAX slots, -1 past the path), and its length."""
    dev = p["t"].device
    anc = _ancestors(p["parent"], _node(X, dev))[0]
    cur, up = anc[:P_MAX], anc[1:P_MAX + 1]
    go = (cur != _node(B, dev)) & (cur >= 0) & (up >= 0)
    n = torch.cummin(go.to(torch.int8), 0).values.sum().reshape(1)
    sibs = _children_of(p["children"], up, cur)
    return torch.where(_ar(P_MAX, dev) < n, sibs, -1), n


def peel_inner_dev(p, G, c):
    """Remove the graft's warm mutations: warm muts of each bi's branch
    slide down to the P->X level (from-state updates on every junction
    sibling along the way), X's branch becomes the composed nexus deltas at
    t_mid.  Host: graft.py _peel_inner (final closed)."""
    ref_seq = c["ref_seq"]
    X = G["X"]
    N, W = p["msite"].shape
    WH_ = G["hm_s"].shape[1]
    dev = p["t"].device
    t_P = G["t_P"]
    t_X = _g(p["t"], X)
    nl = BI_MAX - 1
    anc = _ancestors(p["parent"], X)[0]
    sibs = _path_and_sibs(p, X, -1)[0][:nl]   # the junctions to the root

    B = G["B"]
    Bc = B.clamp(0, N - 1)
    act = G["active"] & (B != X)
    # junctions between X and B_k: B_k's place on X's root path
    hitB = anc[None, :BI_MAX] == B[:, None]
    n_lev = torch.where(hitB.any(1),
                        torch.argmax(hitB.to(torch.int8), 1), 0)
    lane = _ar(W, dev)
    ms, mf = p["msite"][Bc], p["mfrom"][Bc]
    in_warm = _member(G["warm_rs"], G["warm_re"], ms.clamp(min=0))
    in_warm = torch.where(G["compl_"][:, None], True, in_warm)
    valid = lane[None, :] < p["mcount"][Bc][:, None]
    sel = valid & in_warm & act[:, None]

    # slide from-states: each bi in turn, its selected muts in reverse
    # order (the earliest mutation's from_state sticks), onto each junction
    # sibling between X and its branch
    op_lev = n_lev[:, None].expand(BI_MAX, W).flip(1).reshape(-1)
    app = (sel.flip(1).reshape(-1)[:, None]
           & (_ar(nl, dev)[None, :] < op_lev[:, None]))
    fsite, fstate, ok = _fs_set_seq(p["fsite"], p["fstate"], ref_seq, sibs,
                                    ms.flip(1).reshape(-1),
                                    mf.flip(1).reshape(-1), app)

    # keep = non-warm muts, order preserved
    keep = valid & ~in_warm
    nkeep = keep.sum(1)
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    take = lane[None, :] < nkeep[:, None]

    def rows(a, pad):
        return torch.where(take, a[Bc].gather(1, order), pad)
    msite = _put_rows(p["msite"], B, rows(p["msite"], -1), act)
    mfrom = _put_rows(p["mfrom"], B, rows(p["mfrom"], 0), act)
    mto = _put_rows(p["mto"], B, rows(p["mto"], 0), act)
    mt = _put_rows(p["mt"], B, rows(p["mt"], INF), act)
    mcount = _put_rows(p["mcount"], B, nkeep, act)

    # X's row := all hot deltas at t_mid (disjoint sites), site-sorted
    t_mid = 0.5 * (t_P + t_X)
    all_s = torch.where(
        (_ar(WH_, dev)[None, :] < G["hd_cnt"][:, None])
        & G["active"][:, None], G["hd_s"], _SITE_SENTINEL).reshape(-1)
    all_f = G["hd_f"].reshape(-1)
    all_t2 = G["hd_t"].reshape(-1)
    o = torch.argsort(all_s, stable=True)[:W]
    n_del = (all_s < _SITE_SENTINEL).sum().reshape(1)
    ok = ok & (n_del <= W)
    use = lane < n_del
    msite = _set(msite, X, torch.where(use, all_s[o], -1))
    mfrom = _set(mfrom, X, torch.where(use, all_f[o], 0))
    mto = _set(mto, X, torch.where(use, all_t2[o], 0))
    mt = _set(mt, X, torch.where(use, t_mid, INF))
    mcount = _set(mcount, X, n_del)
    p2 = dict(p, msite=msite, mfrom=mfrom, mto=mto, mt=mt, mcount=mcount,
              fsite=fsite, fstate=fstate)
    return p2, ok


# ---------------------------------------------------------------------------
# The prune-regraft surgery with missation factoring (host graft.py move();
# native topo_native.cpp SprContext::move; reference spr_move.cpp:1101-1160)
# Operates on the PEELED tree; inner moves (P != root, SS != root branch).
# ---------------------------------------------------------------------------

def _node_runs(p, n):
    return _row(p["rs"], n), _row(p["re"], n), _g(p["rcnt"], n)


def _set_node_runs(p_rs, p_re, p_rcnt, n, rs, re, cnt):
    return _set(p_rs, n, rs), _set(p_re, n, re), _set(p_rcnt, n, cnt)


def _inherit(p, X, P, WR):
    """Step 2a: X inherits every missation at or above its old position
    (the union walked up from P), and the non-ref from-states of the sites
    it newly gains (each from the lowest ancestor missing the site).
    Returns (rs, re, cnt, fsite, fstate, ok) of X's rows."""
    ancP = _ancestors(p["parent"], P)[0]
    up = ancP[:P_MAX]
    nodes = torch.cat([X, up])
    rs, re = _rows_of(p, nodes)
    (u_rs, u_re, u_cnt, ok), (lo, hi, mem, pu) = _prefix_union(
        rs, re, WR, first_given=True)
    ok = ok & (ancP[P_MAX:P_MAX + 1] < 0)     # the port's cap: P_MAX nodes
    fs = p["fsite"][up.clamp(min=0)]
    fv = p["fstate"][up.clamp(min=0)]
    seg, inside = _seg_of(lo, hi, fs.clamp(min=0))          # (K, WF)
    own = mem[1:].gather(1, seg) & inside
    below = pu[:-1].gather(1, seg)
    add = (fs >= 0) & (up >= 0)[:, None] & own & ~below
    fsX, fvX, okb = fs_bulk_add(_row(p["fsite"], X), _row(p["fstate"], X),
                                fs.reshape(-1), fv.reshape(-1),
                                add.reshape(-1))
    return u_rs, u_re, u_cnt, fsX, fvX, ok & okb


def _fs_moves(fsite, fstate, holders, final, valid_h, WFn):
    """Rebuild the fs rows of ``holders`` (H,) after their entries
    (H * WF, in row order) moved: entry e ends in holder ``final[e]``
    (-1: dropped).  Entries that stay keep their lanes; each row's
    arrivals, in entry order, take its free lanes in order
    (``fs_bulk_add``'s rule, for many rows at once without an (H, E)
    mask; the caller checks the rows' room).  Rows written where
    ``valid_h``."""
    H = holders.shape[0]
    dev = fsite.device
    hc = holders.clamp(0, fsite.shape[0] - 1)
    rs_, rv_ = fsite[hc], fstate[hc]
    E = H * WFn
    origin = _ar(H, dev).repeat_interleave(WFn)
    rows_s = torch.where((final == origin).reshape(H, WFn), rs_, -1)
    add = (final >= 0) & (final != origin)
    # each arrival's rank among its holder's arrivals
    key = torch.where(add, final, H)
    o = torch.argsort(key, stable=True)
    ks = key[o]
    rank = torch.empty_like(o).scatter(
        0, o, _ar(E, dev) - torch.searchsorted(ks, ks))
    free = rows_s < 0
    lane_of_rank = torch.full((H, WFn + 1), WFn, dtype=torch.int64,
                              device=dev).scatter(
        1, torch.where(free, torch.cumsum(free.long(), 1) - 1, WFn),
        _ar(WFn, dev).expand(H, WFn))
    tc = final.clamp(0, H - 1)
    lane = torch.where(add & (rank < free.sum(1)[tc]),
                       lane_of_rank[tc, rank.clamp(0, WFn)], WFn)
    pad = torch.zeros((H, 1), dtype=rs_.dtype, device=dev)
    rows_s = torch.cat([rows_s, pad], 1).index_put(
        (tc, lane), rs_.reshape(-1))[:, :WFn]
    rows_v = torch.cat([rv_, pad], 1).index_put(
        (tc, lane), rv_.reshape(-1))[:, :WFn]
    return (_put_rows(fsite, holders, rows_s, valid_h),
            _put_rows(fstate, holders, rows_v, valid_h))


def _cascade(pd, G_node, S, WR):
    """Step 2d: the normalisation cascade up from the old junction G: at
    each node, the missations common to both children move up onto it (the
    from-states of the first child with them, the second child's dropped),
    while some are common.  With a_k the on-path child of the path's k-th
    node n_k and b_k the other, C_0 = miss(S) & miss(b_0) and
    C_k = (miss(n_{k-1}) | C_{k-1}) & miss(b_k); the cascade runs while
    C_k is not empty.  Returns (rs, re, rcnt, fsite, fstate, ok)."""
    dev = pd["t"].device
    WFn = pd["fsite"].shape[1]
    K = P_MAX
    path = _ancestors(pd["parent"], G_node)[0]
    n = path[:K]
    vn = n >= 0
    a = torch.cat([S, n[:-1]])               # on-path child of n_k
    ch = pd["children"][n.clamp(min=0)]
    slot0 = ch[:, 0] == a
    b = torch.where(slot0, ch[:, 1], ch[:, 0])
    nodes = torch.cat([S, n, b])
    valid = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), vn, vn])
    rs, re = _rows_of(pd, nodes, valid)
    lo, hi = _segments(rs, re)
    mem = _member(rs, re, lo)
    a0, en, bm = mem[0], mem[1:K + 1], mem[K + 1:]
    kk = _ar(K, dev)[:, None]
    start = torch.cat([a0[None], en[:-1]])
    lastfalse = torch.cummax(torch.where(bm, -1, kk), 0).values
    laststart = torch.cummax(torch.where(start, kk, -1), 0).values
    cm = laststart > lastfalse                # C_k, were level k reached
    c_cnt, ok1 = _runs(cm, lo, hi, WR, rows=False)
    applied = torch.cummin((vn & (c_cnt > 0)).to(torch.int8),
                           0).values.bool()
    apc = applied[:, None] & cm
    a_set = torch.cat([a0[None], en[:-1] | cm[:-1]])
    nxt = torch.cat([apc[1:], torch.zeros_like(apc[:1])])
    new = torch.cat([(a0 & ~apc[0])[None], (en | apc) & ~nxt, bm & ~apc])
    n_rs, n_re, n_cnt, _ = _runs(new, lo, hi, WR)
    _, ok_a = _runs(a_set & ~cm, lo, hi, WR, rows=False)
    _, ok_b = _runs(bm & ~cm, lo, hi, WR, rows=False)
    _, ok_n = _runs(en | cm, lo, hi, WR, rows=False)
    ok = (~applied | (ok1 & ok_a & ok_b & ok_n)).all().reshape(1)
    # the port's cap: a cascade still running after P_MAX nodes rejects
    ok = ok & ~(applied[-1:] & (path[K:K + 1] >= 0))
    write = torch.cat([applied[:1], applied, applied])
    p_rs = _put_rows(pd["rs"], nodes, n_rs, write)
    p_re = _put_rows(pd["re"], nodes, n_re, write)
    p_rcnt = _put_rows(pd["rcnt"], nodes, n_cnt, write)

    # from-states: an entry on the on-path child at a level where its site
    # is common moves up (slot 0) or is dropped (slot 1), and goes on up
    # the path while that holds; an entry on b_k moves into n_k (b_k in
    # slot 0) or drops.  Per segment and level: the first level at or
    # above where an entry there stops moving.
    mvT = apc & slot0[:, None]
    drT = apc & ~slot0[:, None]
    nstop = torch.cummin(torch.where(mvT, K, kk).flip(0), 0).values.flip(0)
    S_ = lo.shape[0]
    nstop = torch.cat([nstop, torch.full((1, S_), K, dtype=torch.int64,
                                         device=dev)])
    drT = torch.cat([drT, torch.zeros((1, S_), dtype=torch.bool,
                                      device=dev)])
    hf = torch.where(valid[:, None], pd["fsite"][nodes.clamp(min=0)],
                     -1).reshape(-1)                        # (E,)
    seg, inside = _seg_of(lo, hi, hf.clamp(min=0))
    live = inside & (hf >= 0)
    h_of = _ar(1 + 2 * K, dev).repeat_interleave(WFn)
    # S's entries start on the path at level 0, n_k's at level k + 1; b_k's
    # enter it at level k + 1 where they move up at level k
    is_b = h_of > K
    kb = (h_of - K - 1).clamp(0, K - 1)
    b_mv = is_b & live & drT[kb, seg]
    b_dr = is_b & live & mvT[kb, seg]
    k0 = torch.where(is_b, kb + 1, h_of)
    on_path = ~is_b | b_mv
    kf = torch.where(live, nstop[k0, seg], k0)
    dropped = live & drT[kf, seg]
    # an entry on the path ends on a_kf (holder index kf)
    final = torch.where(on_path, torch.where(dropped, -1, kf),
                        torch.where(b_dr, -1, h_of))
    # arrivals at n_k at level k (entries moving at levels [first, kf)),
    # against its free lanes
    first = torch.where(is_b, kb, k0)
    movers = on_path & (kf > first)
    steps = torch.zeros(K + 1, dtype=torch.int64, device=dev)
    steps = steps.index_add(0, torch.where(movers, first, K),
                            movers.long())
    steps = steps.index_add(0, torch.where(movers, kf, K), -movers.long())
    arrive = torch.cumsum(steps, 0)[:K]
    free = WFn - (pd["fsite"][n.clamp(min=0)] >= 0).sum(1)
    ok = ok & (~applied | (arrive <= free)).all()
    fsite, fstate = _fs_moves(pd["fsite"], pd["fstate"], nodes, final,
                              valid, WFn)
    return p_rs, p_re, p_rcnt, fsite, fstate, ok


def _unfactor(pd, X, SS, WR):
    """Step 4a: un-factor missations above the attach point that X's data
    invalidates: one pass down the path root..GG..SS carrying the
    accumulated need-set (need_W = miss(W) - miss(X)) and the pending
    from-states; the off-path sibling below each W gains both, as does SS
    at the end.  Returns (rs, re, rcnt, fsite, fstate, ok)."""
    dev = pd["t"].device
    WFn = pd["fsite"].shape[1]
    path = _ancestors(pd["parent"], SS)[0][:P_MAX]
    K = P_MAX - 1
    Wn, below = path[1:], path[:-1]
    lv = Wn >= 0                              # levels the walk runs
    other = _children_of(pd["children"], Wn, below)
    nodes = torch.cat([X, Wn, other, SS])
    valid = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), lv, lv,
                       torch.ones(1, dtype=torch.bool, device=dev)])
    rs, re = _rows_of(pd, nodes, valid)
    lo, hi = _segments(rs, re)
    mem = _member(rs, re, lo)
    xm, wm, om, ssm = mem[0], mem[1:K + 1], mem[K + 1:2 * K + 1], mem[-1]
    need = wm & ~xm[None, :] & lv[:, None]
    # acc at level i: the needs of W_i and every W above it
    acc = torch.cummax(need.flip(0).to(torch.int8), 0).values.flip(0).bool()
    n_cnt, ok1 = _runs(need, lo, hi, WR, rows=False)
    has = n_cnt > 0
    w_new = wm & ~need
    acc_cnt, ok3 = _runs(acc, lo, hi, WR, rows=False)
    apply_j = acc_cnt > 0
    o_new = om | acc
    _, ok2 = _runs(w_new, lo, hi, WR, rows=False)
    _, ok4 = _runs(o_new, lo, hi, WR, rows=False)
    ok = (~lv | (ok1 & ok2 & ok3 & (~apply_j | ok4))).all().reshape(1)
    acc_all = acc[0]
    apply_ss = acc_cnt[:1] > 0
    ss_new = ssm | acc_all
    new = torch.cat([w_new, o_new, ss_new[None]])
    n_rs, n_re, n_cnt2, n_ok = _runs(new, lo, hi, WR)
    ok = ok & (~apply_ss | n_ok[-1:])
    write = torch.cat([lv & has, lv & apply_j, apply_ss])
    wnodes = nodes[1:]
    p_rs = _put_rows(pd["rs"], wnodes, n_rs, write)
    p_re = _put_rows(pd["re"], wnodes, n_re, write)
    p_rcnt = _put_rows(pd["rcnt"], wnodes, n_cnt2, write)

    # from-states: W's entries in its need move to the pending list (top
    # down, lane order); each sibling below gains every pending entry from
    # its W and above, SS all of them
    fs = pd["fsite"][Wn.clamp(min=0)]
    fv = pd["fstate"][Wn.clamp(min=0)]
    seg, inside = _seg_of(lo, hi, fs.clamp(min=0))
    mvm = (need.gather(1, seg) & inside & (fs >= 0) & has[:, None]
           & lv[:, None])
    ok = ok & (mvm.sum() <= WFn)
    fsite = _put_rows(pd["fsite"], Wn, torch.where(mvm, -1, fs), lv & has)
    fstate = pd["fstate"]
    # the pending list, top down: a sibling at level i gains its first
    # n_i entries, those of W_i and above
    pend = mvm.flip(0).reshape(-1)
    pos = torch.cumsum(pend.long(), 0) - 1
    at = torch.where(pend & (pos < WFn), pos, WFn)
    zero = torch.zeros(WFn + 1, dtype=torch.int64, device=dev)
    pend_s = zero.scatter(0, at, fs.flip(0).reshape(-1))[:WFn]
    pend_v = zero.scatter(0, at, fv.flip(0).reshape(-1))[:WFn]
    n_lv = torch.cumsum(mvm.sum(1).flip(0), 0).flip(0)     # (K,)
    tgt = torch.cat([other, SS])
    n_get = torch.cat([torch.where(lv & apply_j, n_lv, 0),
                       torch.where(apply_ss, n_lv[:1], 0)])
    get = _ar(WFn, dev)[None, :] < n_get[:, None]
    tc = tgt.clamp(min=0)
    rows_s, rows_v, okb = fs_bulk_add(fsite[tc], fstate[tc], pend_s, pend_v,
                                      get)
    wr = torch.cat([lv & apply_j, apply_ss])
    ok = ok & (~wr | okb).all()
    fsite = _put_rows(fsite, tgt, rows_s, wr)
    fstate = _put_rows(fstate, tgt, rows_v, wr)
    return p_rs, p_re, p_rcnt, fsite, fstate, ok


def move_dev(p, X, SS, t_new, c):
    """detach X, regraft on branch SS at t_new.  Returns (p2, ok)."""
    ref_seq = c["ref_seq"]
    N, W = p["msite"].shape
    WR = p["rs"].shape[1]
    WFn = p["fsite"].shape[1]
    dev = p["t"].device
    X = _node(X, dev)
    SS = _node(SS, dev)
    t_new = _scalar(t_new, p["t"])
    P = _g(p["parent"], X)
    S = _sibling_dev(p, P, X)
    SS = torch.where(SS == P, S, SS)
    old_t_P = _g(p["t"], P)

    # 1. X's (peeled) row holds the nexus->X deltas (site-sorted, disjoint,
    # at t_mid)
    dnx_s, dnx_f, dnx_t = (_row(p[k], X) for k in ("msite", "mfrom", "mto"))
    dnx_c = _g(p["mcount"], X)

    # 2a. X inherits every missation at or above its old position
    rsX, reX, cntX, fsX, fvX, ok = _inherit(p, X, P, WR)
    p1 = dict(p, rs=_set(p["rs"], X, rsX), re=_set(p["re"], X, reX),
              rcnt=_set(p["rcnt"], X, cntX), fsite=_set(p["fsite"], X, fsX),
              fstate=_set(p["fstate"], X, fvX))

    # 2b. structural detach (muts merge G->P->S, wiring)
    pd, S_det, Pf = detach(p1, X)
    G_node = _g(p["parent"], P)

    # 2c. merge missations P -> S (disjoint), clear P
    rsS, reS, cntS, okm = rsn.combine(*_node_runs(p1, P),
                                      *_node_runs(p1, S), op="union",
                                      WR_out=WR)
    p_rs, p_re, p_rcnt = _set_node_runs(p1["rs"], p1["re"], p1["rcnt"], S,
                                        rsS, reS, cntS)
    p_rs, p_re, p_rcnt = _set_node_runs(p_rs, p_re, p_rcnt, P, BIG, BIG, 0)
    fsP = _row(p1["fsite"], P)
    nsS, nvS, okb = fs_bulk_add(_row(p1["fsite"], S), _row(p1["fstate"], S),
                                fsP, _row(p1["fstate"], P), fsP >= 0)
    p_fs = _set(_set(p1["fsite"], S, nsS), P, -1)
    p_fv = _set(p1["fstate"], S, nvS)
    ok = ok & okm & okb
    pd = dict(pd, rs=p_rs, re=p_re, rcnt=p_rcnt, fsite=p_fs, fstate=p_fv)

    # 2d. normalization cascade up from the old junction G
    p_rs, p_re, p_rcnt, p_fs, p_fv, okc = _cascade(pd, G_node, S, WR)
    ok = ok & okc
    pd = dict(pd, rs=p_rs, re=p_re, rcnt=p_rcnt, fsite=p_fs, fstate=p_fv)

    # 3. recompose nexus deltas through the pruned tree; crossings at sites
    # missing at X become from-state updates on X
    bs, bf, bt, bc, okd = deltas_between_dev(pd, SS, t_new, S_det, old_t_P)
    ok = ok & okd
    in_missX = rsn.contains_many(_row(pd["rs"], X), _row(pd["re"], X),
                                 bs.clamp(min=0))
    lane_ok = _ar(bs.shape[0], dev) < bc
    cross = lane_ok & in_missX
    p_fs, p_fv, okx = _fs_set_seq(pd["fsite"], pd["fstate"], ref_seq, X, bs,
                                  bf, cross[:, None])
    ok = ok & okx
    pd = dict(pd, fsite=p_fs, fstate=p_fv)
    keep = lane_ok & ~in_missX
    cat_s = torch.cat([torch.where(keep, bs, -1),
                       torch.where(_ar(W, dev) < dnx_c, dnx_s, -1)])
    nds, ndf, ndt, ndc = compose_events(cat_s, torch.cat([bf, dnx_f]),
                                        torch.cat([bt, dnx_t]), cat_s >= 0)
    ok = ok & (ndc <= W)

    # 4a. un-factor missations above the attach point that X's data
    # invalidates
    p_rs, p_re, p_rcnt, p_fs, p_fv, oku = _unfactor(pd, X, SS, WR)
    ok = ok & oku
    pd = dict(pd, rs=p_rs, re=p_re, rcnt=p_rcnt, fsite=p_fs, fstate=p_fv)

    # 4b. drop miss(X) entries covered above the new position
    GG = _g(pd["parent"], SS)
    cov_rs, cov_re, cov_cnt, ok6 = missing_at_row(pd, GG.clamp(min=0), WR)
    cov_cnt = torch.where(GG >= 0, cov_cnt, 0)
    ok = ok & ok6
    x_rs, x_re, x_cnt = _node_runs(pd, X)
    ovl_rs, ovl_re, ovl_cnt, ok7 = rsn.combine(cov_rs, cov_re, cov_cnt, x_rs,
                                               x_re, x_cnt, op="intersect",
                                               WR_out=WR)
    has_ovl = ovl_cnt > 0
    xrs, xre, xcnt, ok8 = rsn.combine(x_rs, x_re, x_cnt, ovl_rs, ovl_re,
                                      ovl_cnt, op="minus", WR_out=WR)
    p_rs, p_re, p_rcnt = _set_node_runs(
        pd["rs"], pd["re"], pd["rcnt"], X, torch.where(has_ovl, xrs, x_rs),
        torch.where(has_ovl, xre, x_re), torch.where(has_ovl, xcnt, x_cnt))
    fs_X = _row(pd["fsite"], X)
    drop = (rsn.contains_many(ovl_rs, ovl_re, fs_X.clamp(min=0))
            & (fs_X >= 0) & has_ovl)
    p_fs = _set(pd["fsite"], X, torch.where(drop, -1, fs_X))
    ok = ok & ok7 & (~has_ovl | ok8)
    pd = dict(pd, rs=p_rs, re=p_re, rcnt=p_rcnt, fsite=p_fs)

    # 4c. structural attach + synthesized mid-branch row on X
    t_X = _g(pd["t"], X)
    t_mid = 0.5 * (t_new + t_X)
    lane = _ar(W, dev)
    use = lane < ndc
    p2 = attach(pd, X, Pf, SS, t_new, torch.where(use, nds[:W], -1),
                torch.where(use, ndf[:W], 0), torch.where(use, ndt[:W], 0),
                torch.where(use, t_mid, INF), ndc.clamp(max=W))
    p2 = dict(p2, rs=pd["rs"], re=pd["re"], rcnt=pd["rcnt"],
              fsite=pd["fsite"], fstate=pd["fstate"])

    # 4d. factor missations common to the new siblings up onto P
    x_rs, x_re, x_cnt = _node_runs(p2, X)
    s_rs, s_re, s_cnt = _node_runs(p2, SS)
    crs, cre, ccnt, ok9 = rsn.combine(x_rs, x_re, x_cnt, s_rs, s_re, s_cnt,
                                      op="intersect", WR_out=WR)
    hasc = ccnt > 0
    ok = ok & ok9
    p_fs, p_fv = p2["fsite"], p2["fstate"]
    fs_X, fv_X = _row(p_fs, X), _row(p_fv, X)
    mX = hasc & (fs_X >= 0) & rsn.contains_many(crs, cre, fs_X.clamp(min=0))
    nsp, nvp, okb3 = fs_bulk_add(_row(p_fs, Pf), _row(p_fv, Pf), fs_X, fv_X,
                                 mX)
    p_fs = _set(_set(p_fs, Pf, nsp), X, torch.where(mX, -1, fs_X))
    p_fv = _set(p_fv, Pf, nvp)
    fs_S = _row(p_fs, SS)
    mS = hasc & (fs_S >= 0) & rsn.contains_many(crs, cre, fs_S.clamp(min=0))
    p_fs = _set(p_fs, SS, torch.where(mS, -1, fs_S))
    ok = ok & okb3
    xr, xe, xc, okA = rsn.combine(x_rs, x_re, x_cnt, crs, cre, ccnt,
                                  op="minus", WR_out=WR)
    sr, se, sc, okB = rsn.combine(s_rs, s_re, s_cnt, crs, cre, ccnt,
                                  op="minus", WR_out=WR)
    pr, pe, pc, okC = rsn.combine(*_node_runs(p2, Pf), crs, cre, ccnt,
                                  op="union", WR_out=WR)
    p_rs, p_re, p_rcnt = p2["rs"], p2["re"], p2["rcnt"]
    for n, (r_, e_, c_) in ((X, (xr, xe, xc)), (SS, (sr, se, sc)),
                            (Pf, (pr, pe, pc))):
        o_rs, o_re, o_cnt = _row(p_rs, n), _row(p_re, n), _g(p_rcnt, n)
        p_rs, p_re, p_rcnt = _set_node_runs(
            p_rs, p_re, p_rcnt, n, torch.where(hasc, r_, o_rs),
            torch.where(hasc, e_, o_re), torch.where(hasc, c_, o_cnt))
    ok = ok & (~hasc | (okA & okB & okC))
    return dict(p2, rs=p_rs, re=p_re, rcnt=p_rcnt, fsite=p_fs,
                fstate=p_fv), ok


# ---------------------------------------------------------------------------
# Apply (host graft.py _apply_inner, closed-final; spr_move.cpp:977-1070)
# ---------------------------------------------------------------------------

def apply_inner_dev(p, G, c):
    """Write the graft's hot mutations back: X's row becomes slot 0's list;
    every other bi's mutations land on the path branch containing their
    time, updating junction-sibling from-states below the landing.  Rows
    are then time-sorted and clamped into their branches."""
    ref_seq = c["ref_seq"]
    X = G["X"]
    N, W = p["msite"].shape
    WH_ = G["hm_s"].shape[1]
    parent, t = p["parent"], p["t"]
    dev = t.device
    lane = _ar(W, dev)
    ok = torch.ones(1, dtype=torch.bool, device=dev)

    # X's row = slot 0 hot muts
    n0 = torch.clamp(G["hm_cnt"][:1], max=W)
    ok = ok & (G["hm_cnt"][:1] <= W)
    use = lane < n0
    msite = _set(p["msite"], X, torch.where(use, G["hm_s"][0, :W], -1))
    mfrom = _set(p["mfrom"], X, torch.where(use, G["hm_f"][0, :W], 0))
    mto = _set(p["mto"], X, torch.where(use, G["hm_t2"][0, :W], 0))
    mt = _set(p["mt"], X, torch.where(use, G["hm_tt"][0, :W], INF))
    mcount = _set(p["mcount"], X, n0)

    # each hot mut of bis 1.. walks up from X to the branch holding its time
    anc = _ancestors(parent, X)[0]
    cur, up = anc[:BI_MAX], anc[1:BI_MAX + 1]
    sibs = _children_of(p["children"], up, cur)
    kk = _ar(BI_MAX, dev)
    op_ok = ((kk[:, None] >= 1) & (kk[:, None] < G["n_bi"])
             & (_ar(WH_, dev)[None, :] < G["hm_cnt"][:, None])).reshape(-1)
    tm = G["hm_tt"].reshape(-1)
    A_op = G["A"].repeat_interleave(WH_)
    t_up = t[up.clamp(min=0)]
    t_cur = t[cur.clamp(min=0)]
    here = (t_up[None, :] <= tm[:, None]) & (tm[:, None] < t_cur[None, :])
    go = ((cur[None, :] != A_op[:, None]) & (cur >= 0)[None, :]
          & (up >= 0)[None, :])
    reach = torch.cummin(go.to(torch.int8), 1).values.bool()
    hit = reach & here
    placed = hit.any(1) & op_ok
    land = torch.argmax(hit.to(torch.int8), 1)
    passed = reach & op_ok[:, None] & (
        ~placed[:, None] | (kk[None, :] < land[:, None]))
    fsite, fstate, okf = _fs_set_seq(p["fsite"], p["fstate"], ref_seq, sibs,
                                     G["hm_s"].reshape(-1),
                                     G["hm_t2"].reshape(-1), passed)
    ok = ok & okf

    # append each landed mut to its branch's row, in op order
    onto = placed[:, None] & (land[:, None] == kk[None, :])  # (O, BI)
    rank = (torch.cumsum(onto.long(), 0) - 1).gather(1, land[:, None])[:, 0]
    tgt = cur[land].clamp(0, N - 1)
    pos = mcount[tgt] + rank
    wr = placed & (pos < W)
    ok = ok & (wr | ~op_ok).all()
    flat = torch.where(wr, tgt * W + pos.clamp(0, W - 1), N * W)

    def app(a, v):
        ext = torch.cat([a.reshape(-1), a.reshape(-1)[:1]])
        return ext.index_put((flat,), v.to(a.dtype))[:N * W].reshape(N, W)
    msite = app(msite, G["hm_s"].reshape(-1))
    mfrom = app(mfrom, G["hm_f"].reshape(-1))
    mto = app(mto, G["hm_t2"].reshape(-1))
    mt = app(mt, tm)
    gained = (onto & wr[:, None]).sum(0)
    mcount = _put_rows(mcount, cur, mcount[cur.clamp(min=0)] + gained,
                       (cur >= 0) & (gained > 0))

    # sort by (t, site) and clamp every bi branch row (graft.py
    # _clamp_times)
    act = G["active"]
    B = G["B"].clamp(0, N - 1)
    A = G["A"].clamp(0, N - 1)
    t_A, t_B = t[A], t[B]
    valid = lane[None, :] < mcount[B][:, None]
    o_site = torch.argsort(torch.where(valid, msite[B], _SITE_SENTINEL),
                           dim=1, stable=True)
    o_t = torch.argsort(torch.where(valid.gather(1, o_site),
                                    mt[B].gather(1, o_site), INF), dim=1,
                        stable=True)
    order = o_site.gather(1, o_t)
    rtt = mt[B].gather(1, order)
    span = t_B - t_A
    eps = 1e-12 * torch.clamp(torch.maximum(t_A.abs(), t_B.abs()), min=1.0)
    lo = (t_A + torch.minimum(eps, 0.5 * span))[:, None]
    rtt = torch.where(valid, torch.where(rtt <= t_A[:, None], lo,
                                         torch.where(rtt > t_B[:, None],
                                                     t_B[:, None], rtt)),
                      rtt)
    msite = _put_rows(msite, G["B"], msite[B].gather(1, order), act)
    mfrom = _put_rows(mfrom, G["B"], mfrom[B].gather(1, order), act)
    mto = _put_rows(mto, G["B"], mto[B].gather(1, order), act)
    mt = _put_rows(mt, G["B"], rtt, act)
    p2 = dict(p, msite=msite, mfrom=mfrom, mto=mto, mt=mt, mcount=mcount,
              fsite=fsite, fstate=fstate)
    return p2, ok


# ---------------------------------------------------------------------------
# Proposal of new graft mutations (host graft.py _propose_new_graft_mutations;
# reference spr_move.cpp:207-245, 742-797).  Closed bis only.
# ---------------------------------------------------------------------------

def propose_dev(draws, p_moved, G, miss_rs, miss_re, mu_prop, c, L: int,
                H_RT_: int = H_RT_MISS):
    """Replace G's hot-mutation rows with histories sampled from ``draws``
    (a ``Spr1MissDraws``: its d, u_rt and r): per closed bi, delta-site
    histories (min 1 event realizing the composed delta) + round-trip
    histories (min 2 events, start = end = the state at X) over the bi's
    hot sites; slot 0 additionally excludes sites missing at X unless they
    are delta sites (host graft.py:419-424).  Returns (G', ok, short):
    ``short`` says that some active slot accepted none of its attempts."""
    ref_seq = c["ref_seq"]
    X = G["X"]
    t_X = _g(p_moved["t"], X)
    WH_ = G["hm_s"].shape[1]
    KM = _hist.KMAX
    dev = t_X.device
    kk = _ar(BI_MAX, dev)

    T = G["T"]
    size_h = _row_sizes(G["hot_rs"], G["hot_re"], G["hot_cnt"])
    Lh = torch.where(G["compl_"], L - size_h, size_h)
    act = G["active"] & (Lh > 0)

    # delta-site histories
    d_act = _ar(WH_, dev)[None, :] < G["hd_cnt"][:, None]
    frm_d = torch.where(d_act, G["hd_f"], 0)
    A = draws.d.u_k.shape[-1]
    k_d, st_d, tm_d, found_d = _hist.site_history_core(
        frm_d.reshape(-1), torch.where(d_act, G["hd_t"], 1).reshape(-1),
        T.repeat_interleave(WH_)[:, None], mu_prop,
        draws.d.u_k.reshape(-1, A), draws.d.steps.reshape(-1, A, KM),
        draws.d.u_t.reshape(-1, KM), min_k=1)

    # round-trip sites: hot, non-delta; slot 0 drops missing-at-X sites
    rt_mask = _hist.roundtrip_mask_core(draws.u_rt, T[:, None], mu_prop)
    sit = _ar(L, dev)
    in_hot = _member(G["hot_rs"], G["hot_re"], sit)
    in_hot = torch.where(G["compl_"][:, None], ~in_hot, in_hot)
    hd_pad = torch.where(d_act, G["hd_s"], _SITE_SENTINEL).contiguous()
    pos = torch.searchsorted(hd_pad, sit.expand(BI_MAX, L).contiguous())
    is_delta = ((pos < G["hd_cnt"][:, None])
                & (hd_pad.gather(1, pos.clamp(max=WH_ - 1)) == sit))
    in_missX = rsn.contains_many(miss_rs, miss_re, sit)
    rt_mask = (rt_mask & in_hot & ~is_delta
               & ~((kk == 0)[:, None] & in_missX[None, :]))
    n_rt = rt_mask.sum(1)
    ok_k = n_rt <= H_RT_
    # the first H_RT_ round-trip sites in site order (the stable argsort of
    # the mask, as the k-th True of a running count)
    kth = torch.searchsorted(torch.cumsum(rt_mask.long(), 1),
                             (_ar(H_RT_, dev) + 1).expand(BI_MAX, H_RT_)
                             .contiguous()).clamp(max=L - 1)
    rt_active = _ar(H_RT_, dev)[None, :] < n_rt[:, None]
    rt_sites = torch.where(rt_active, kth, -1)
    rt_state = _state_at_miss(p_moved, ref_seq, X, t_X,
                              rt_sites.clamp(min=0).reshape(-1)).reshape(
        BI_MAX, H_RT_)
    rt_from = torch.where(rt_active, rt_state, 0)
    k_r, st_r, tm_r, found_r = _hist.site_history_core(
        rt_from.reshape(-1), rt_from.reshape(-1),
        T.repeat_interleave(H_RT_)[:, None], mu_prop,
        draws.r.u_k.reshape(-1, A), draws.r.steps.reshape(-1, A, KM),
        draws.r.u_t.reshape(-1, KM), min_k=2)
    short = (act[:, None] & (
        (d_act & ~found_d.reshape(BI_MAX, WH_)).any(1, keepdim=True)
        | (rt_active & ~found_r.reshape(BI_MAX, H_RT_)).any(
            1, keepdim=True))).any().reshape(1)

    # assemble each bi's new history (global time order)
    km = _ar(KM, dev)
    st_d = st_d.reshape(BI_MAX, WH_, KM)
    st_r = st_r.reshape(BI_MAX, H_RT_, KM)
    ev_site = torch.cat([
        torch.where(d_act, G["hd_s"], -1).repeat_interleave(KM, 1),
        rt_sites.repeat_interleave(KM, 1)], 1)
    ev_in_k = torch.cat([
        (km < k_d.reshape(BI_MAX, WH_, 1)).reshape(BI_MAX, -1),
        (km < k_r.reshape(BI_MAX, H_RT_, 1)).reshape(BI_MAX, -1)], 1)
    ev_act = (torch.cat([d_act.repeat_interleave(KM, 1),
                         rt_active.repeat_interleave(KM, 1)], 1)
              & ev_in_k & (ev_site >= 0))
    ev_to = torch.cat([st_d.reshape(BI_MAX, -1), st_r.reshape(BI_MAX, -1)],
                      1)
    prev_d = torch.cat([frm_d[..., None], st_d[..., :-1]], 2)
    prev_r = torch.cat([rt_from[..., None], st_r[..., :-1]], 2)
    ev_from = torch.cat([prev_d.reshape(BI_MAX, -1),
                         prev_r.reshape(BI_MAX, -1)], 1)
    ev_t = torch.cat([tm_d.reshape(BI_MAX, -1), tm_r.reshape(BI_MAX, -1)],
                     1) + t_X
    M_new = ev_act.sum(1)
    ok_k = ok_k & (M_new <= WH_)
    o = torch.argsort(torch.where(ev_act, ev_t, INF), dim=1,
                      stable=True)[:, :WH_]
    take = (_ar(WH_, dev)[None, :] < M_new[:, None]) & act[:, None]
    G2 = dict(G,
              hm_s=torch.where(take, ev_site.gather(1, o), -1),
              hm_f=torch.where(take, ev_from.gather(1, o), 0),
              hm_t2=torch.where(take, ev_to.gather(1, o), 0),
              hm_tt=torch.where(take, ev_t.gather(1, o), INF),
              hm_cnt=torch.where(act, M_new, 0))
    return G2, (~act | ok_k).all().reshape(1), short


def _state_at_miss(p, ref_seq, branch, t0, site):
    """State of each of ``site`` at (branch, t0): latest mutation at/above
    wins (site_deltas.state_at); missation rows do not enter."""
    return _state_at_dev(p, ref_seq, branch, t0, site)


def _summarize_closed_dev(G):
    """Union of all closed bis' hot deltas, site-sorted (host mixer
    _summarize_closed; disjoint across bis since hot sets are disjoint)."""
    WH_ = G["hd_s"].shape[1]
    dev = G["hd_s"].device
    act = ((_ar(WH_, dev)[None, :] < G["hd_cnt"][:, None])
           & G["active"][:, None])
    s = torch.where(act, G["hd_s"], _SITE_SENTINEL).reshape(-1)
    o = torch.argsort(s, stable=True)
    n = (s < _SITE_SENTINEL).sum().reshape(1)
    lane = _ar(s.shape[0], dev)
    return (torch.where(lane < n, s[o], -1), G["hd_f"].reshape(-1)[o],
            G["hd_t"].reshape(-1)[o], n)


# ---------------------------------------------------------------------------
# The SPR1 move with missations (inner, can_change_root=False), the device
# twin of mixer._spr1 (subrun.cpp:492-675), and its sweeps
# ---------------------------------------------------------------------------

class Spr1MissDraws(NamedTuple):
    """One move's draws, laid out as the JAX ``spr1_step_miss`` splits its
    key: X, the region and time picks, per branch info the delta-site
    history slots (A attempts each), an L-site round-trip mask and the
    round-trip slots, and the acceptance uniform.  ``steps`` are int8."""
    X: torch.Tensor       # (1,) node in [0, N)
    u_reg: torch.Tensor   # (1,)
    u_t: torch.Tensor     # (1,)
    d: HistDraws          # [BI_MAX, WH_, A], [.., A, KMAX], [.., KMAX]
    u_rt: torch.Tensor    # (BI_MAX, L)
    r: HistDraws          # [BI_MAX, H_RT_, ...]
    u_mh: torch.Tensor    # (1,)


def _draw_hist_miss(gen, S: int, A: int, dtype, device) -> HistDraws:
    u_k = torch.rand((BI_MAX, S, A), generator=gen, dtype=dtype,
                     device=device)
    steps = torch.randint(1, 4, (BI_MAX, S, A, _hist.KMAX), generator=gen,
                          dtype=torch.int8, device=device)
    u_t = torch.rand((BI_MAX, S, _hist.KMAX), generator=gen, dtype=dtype,
                     device=device)
    return HistDraws(u_k, steps, u_t)


def draw_spr1_miss(gen, N: int, L: int, WH_: int, dtype, device,
                   H_RT_: int = H_RT_MISS,
                   attempts: int | None = None) -> Spr1MissDraws:
    """A move's draws, ``attempts`` (None: ``history.ATTEMPTS``, read at
    the call) candidate attempts per history slot."""
    attempts = _hist.ATTEMPTS if attempts is None else attempts

    def u(n=1):
        return torch.rand((n,), generator=gen, dtype=dtype, device=device)
    return Spr1MissDraws(
        X=torch.randint(0, N, (1,), generator=gen, device=device),
        u_reg=u(), u_t=u(),
        d=_draw_hist_miss(gen, WH_, attempts, dtype, device),
        u_rt=torch.rand((BI_MAX, L), generator=gen, dtype=dtype,
                        device=device),
        r=_draw_hist_miss(gen, H_RT_, attempts, dtype, device), u_mh=u())


def more_attempts_miss(gen, draws: Spr1MissDraws,
                       attempts: int | None = None) -> Spr1MissDraws:
    """``draws`` with ``attempts`` (None: ``history.ATTEMPTS``) more
    candidate attempts per history slot appended (the earlier attempts keep
    their places)."""
    attempts = _hist.ATTEMPTS if attempts is None else attempts

    def ext(h: HistDraws) -> HistDraws:
        more = _draw_hist_miss(gen, h.u_k.shape[1], attempts, h.u_k.dtype,
                               h.u_k.device)
        return h._replace(u_k=torch.cat([h.u_k, more.u_k], 2),
                          steps=torch.cat([h.steps, more.steps], 2))
    return draws._replace(d=ext(draws.d), r=ext(draws.r))


def draw_bytes(draws) -> int:
    """Bytes held by a move's draws (or a list of them)."""
    if isinstance(draws, (list, tuple)) and not hasattr(draws, "_fields"):
        return sum(draw_bytes(d) for d in draws)
    out = 0
    for x in draws:
        out += draw_bytes(x) if isinstance(x, tuple) else \
            x.numel() * x.element_size()
    return out


def spr1_miss_core(p, L: int, c, t_max_tip, draws: Spr1MissDraws, WRB: int,
                   H_RT_: int = H_RT_MISS, f: float = 0.8):
    """One SPR1 move on a missation-laden tree from given draws (the JAX
    ``spr1_step_miss``; WH_ is the draws' slot count).  Pipeline (host
    mixer._spr1): analyze old graft -> peel -> bounded pre-study (crossings
    at sites missing at X not counted) -> pick (branch, time) -> move (full
    missation surgery) -> analyze + propose new graft -> post-study -> MH
    -> apply/revert.  Returns (p_out, accept, delta_log_G, performable,
    diag); diag's ``exhausted`` says the draws held too few history
    attempts.  The coalescent prior term is left to the caller (flat
    here)."""
    parent, t = p["parent"], p["t"]
    N, W = p["msite"].shape
    WR = p["rs"].shape[1]
    WH_ = draws.d.u_k.shape[1]
    dt = t.dtype
    root = p["root"]
    lam_args = (c["lambda_ref"], c["mu"], c["nu"], c["qatab"], c["part"],
                c["ref_cum_Q"], c["ref_seq"])

    X = draws.X.reshape(1)
    P0 = _g(parent, X.clamp(0, N - 1))
    eligible = (X != root) & (P0 >= 0) & (P0 != root)
    Xc = torch.where(eligible, X, 0)
    pX = _g(parent, Xc)
    P = pX.clamp(0, N - 1)
    eligible = eligible & (pX >= 0) & (pX != root)
    S = _sibling_dev(p, P, Xc)
    t_X = _g(t, Xc)
    t_P_old = _g(t, P)

    lam_X = lambda_at_dev_miss(p, Xc, *lam_args)
    eligible = eligible & (lam_X > 0.0)
    mrs, mre, mcnt_m, ok = missing_at_row(p, Xc, WR)
    L_X = (L - rsn.row_size(mrs, mre, mcnt_m)).to(dt)
    eligible = eligible & (L_X > 0)
    mu_study = lam_X / torch.clamp(L_X, min=1.0)
    # begin_move (subrun.cpp:502): JC proposal rate from the root
    lam_root = lambda_at_dev_miss(p, root, *lam_args)
    n_miss_root = num_missing_at_dev(p, root)
    mu_prop = lam_root / torch.clamp((L - n_miss_root).to(dt), min=1.0)

    # old graft: analyze + finish + peel
    G_old, ok_a = start_inner_dev(p, Xc, c, WRB=WRB, WH_=WH_)
    ok = ok & ok_a
    dG_old, al_old = finish_dev(p, G_old, c, mu_prop, L)
    p_peel, ok_p = peel_inner_dev(p, G_old, c)
    ok = ok & ok_p

    # pre-study on the peeled tree
    d0s, d0f, d0t, d0c = _summarize_closed_dev(G_old)
    reg = study_regions(p_peel, Xc, t_X, d0s, d0t, d0c, S, miss_rs=mrs,
                        miss_re=mre)
    lw = _study.study_log_weights(reg, lam_X, f, t_X, t_max_tip, mu_study,
                                  above_root=False)
    lw = torch.where(reg["alive"], lw, -INF)
    eligible = eligible & torch.isfinite(lw).any()
    i_fwd = _study.pick_nexus_region(draws.u_reg, lw)
    new_S = _g(reg["branch"], i_fwd)
    t_new = _study.pick_time_in_region(draws.u_t, i_fwd, reg, lam_X, f, t_X,
                                       t_max_tip, above_root=False)
    eligible = eligible & (t_new < t_X) & (t_new > _g(reg["t_min"], i_fwd))
    new_G = torch.where(new_S != root, _g(parent, new_S.clamp(0, N - 1)), -1)
    new_G = torch.where(new_G == P, _g(parent, P), new_G)
    t_new_G = torch.where(new_G >= 0, _g(t, new_G.clamp(min=0)), -INF)
    eligible = (eligible & (t_new != _g(t, new_S.clamp(0, N - 1)))
                & (t_new != t_new_G))
    alpha_fwd = _study.log_alpha_in_region(i_fwd, t_new, lw, reg, lam_X, f,
                                           t_X, t_max_tip, above_root=False)

    # move + new graft
    p_move, ok_m = move_dev(p_peel, Xc, new_S, t_new, c)
    ok = ok & ok_m
    G_new, ok_a2 = start_inner_dev(p_move, Xc, c, WRB=WRB, WH_=WH_)
    ok = ok & ok_a2
    G_new, ok_pr, short = propose_dev(draws, p_move, G_new, mrs, mre,
                                      mu_prop, c, L, H_RT_=H_RT_)
    # an eligible move whose active slot accepted none of its attempts is
    # not a sample yet: its sweep reruns it with more attempts (nothing
    # the flag reads depends on the attempts)
    exhausted = eligible & ok & short
    ok = ok & ok_pr
    dG_new, al_new = finish_dev(p_move, G_new, c, mu_prop, L)

    # post-study on the moved (still-peeled) tree; find the reverse region
    d1s, d1f, d1t, d1c = _summarize_closed_dev(G_new)
    reg_r = study_regions(p_move, Xc, t_X, d1s, d1t, d1c, new_S,
                          miss_rs=mrs, miss_re=mre)
    lw_r = _study.study_log_weights(reg_r, lam_X, f, t_X, t_max_tip,
                                    mu_study, above_root=False)
    lw_r = torch.where(reg_r["alive"], lw_r, -INF)
    hit_old = (reg_r["alive"] & (reg_r["branch"] == S)
               & (reg_r["t_min"] < t_P_old) & (t_P_old <= reg_r["t_max"]))
    i_rev = torch.argmax(hit_old.to(torch.int8)).reshape(1)
    found_rev = hit_old.any()
    alpha_rev = _study.log_alpha_in_region(i_rev, t_P_old, lw_r, reg_r,
                                           lam_X, f, t_X, t_max_tip,
                                           above_root=False)

    log_mh = ((dG_new - al_new) - (dG_old - al_old) + alpha_rev - alpha_fwd)
    p_acc, ok_app = apply_inner_dev(p_move, G_new, c)
    ok = ok & ok_app
    accept = (eligible & ok & found_rev
              & ((log_mh >= 0.0) | (torch.log(draws.u_mh) < log_mh)))
    p_out = _select(accept, p_acc, p)
    dlg = torch.where(accept, dG_new - dG_old, 0.0)
    diag = dict(eligible=eligible, ok=ok, found_rev=found_rev,
                log_mh=log_mh, n_bi_old=G_old["n_bi"],
                n_bi_new=G_new["n_bi"], lam_X=lam_X, t_new=t_new,
                new_S=new_S, X=Xc, exhausted=exhausted)
    return p_out, accept, dlg, eligible & ok, diag


def spr1_sweep_miss_core(p, L: int, c, t_max_tip, draws_seq, WRB: int,
                         H_RT_: int = H_RT_MISS,
                         f: float = 0.8) -> SweepResult:
    """SPR1 moves in sequence on given draws (the JAX ``spr1_sweep_miss``
    on its keys' draws), enqueued without a host sync; ``n_eligible``
    counts the performable moves."""
    return _run_moves(lambda pp, d: spr1_miss_core(
        pp, L, c, t_max_tip, d, WRB, H_RT_, f), p, draws_seq)


def _miss_move(p, draws, L, c, t_max_tip, WRB, H_RT_, f):
    return spr1_miss_core(p, L, c, t_max_tip, draws, WRB, H_RT_, f)


def spr1_sweep_miss(gen, p, L: int, n_moves: int, c, t_max_tip, WRB: int,
                    WH_: int, H_RT_: int = H_RT_MISS, f: float = 0.8,
                    record=None, _eager: bool = False) -> SweepResult:
    """n_moves sequential missation-aware SPR1 moves on draws from ``gen``,
    one host sync.  ``record`` (a list) receives the list of the draws the
    moves used, which ``spr1_sweep_miss_core`` replays.  On CUDA the moves
    replay one move's CUDA graph (``spr_move._sweeps``: ``_eager`` as
    there)."""
    return spr1_sweep_miss_lanes(gen, [p], L, n_moves, c, t_max_tip, WRB,
                                 WH_, H_RT_, f, record, _eager)[0]


def spr1_sweep_miss_lanes(gen, ps, L: int, n_moves: int, c, t_max_tip,
                          WRB: int, WH_: int, H_RT_: int = H_RT_MISS,
                          f: float = 0.8, record=None,
                          _eager: bool = False) -> list:
    """spr1_sweep_miss on each packed tree of ``ps`` (lanes of one shape,
    the counterpart of the JAX bench's vmap over lanes): the lanes' moves
    interleaved and their flags read together, one host sync for all the
    lanes.  Each lane equals spr1_sweep_miss_core on its own draws
    (``record`` receives one list per lane); on CUDA the lanes replay one
    move's graph, each lane's tree copied in for its move."""
    dtype, dev = ps[0]["t"].dtype, ps[0]["t"].device
    N = ps[0]["parent"].shape[0]
    return _sweeps(
        _miss_move, (L, c, t_max_tip, WRB, H_RT_, f),
        lambda: draw_spr1_miss(gen, N, L, WH_, dtype, dev, H_RT_), gen, ps,
        n_moves, record, more=more_attempts_miss, _eager=_eager)
