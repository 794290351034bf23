"""Fixed-shape interval-run set algebra (port of ``delphy_tpu/ops/runset.py``).

A site set is a padded row of sorted, disjoint, non-adjacent half-open runs
[rs, re): tensors of static width WR with ``cnt`` real runs; pad slots hold
rs = re = BIG.  This is the device twin of the native kernel's interval-run
``Sites`` (topo_native.cpp) and the reference's Interval_set
(core/interval_set.h:14-29): membership is a WR-lane compare, and
union/minus/intersect run one generic boundary sweep (all set boundaries
partition the line into segments on which membership in each operand is
constant).

Row convention everywhere: (rs, re, cnt) with rs/re int64 (WR,), cnt a
one-element int64 tensor.  Ops that can overflow the output width return an
``ok`` flag; the caller rejects the MCMC proposal on overflow.  The device
is the inputs'.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = 2 ** 30


def make_row(intervals, WR: int, device="cpu"):
    """Host: interval list [(s, e), ...] (canonical: sorted disjoint
    non-adjacent) -> padded row triple of tensors on ``device``."""
    if len(intervals) > WR:
        raise ValueError(f"{len(intervals)} runs do not fit a row of {WR}")
    rs = np.full(WR, BIG, np.int64)
    re = np.full(WR, BIG, np.int64)
    for i, (s, e) in enumerate(intervals):
        rs[i], re[i] = s, e
    dev = torch.device(device)
    return (torch.from_numpy(rs).to(dev), torch.from_numpy(re).to(dev),
            torch.tensor([len(intervals)], dtype=torch.int64, device=dev))


def row_to_intervals(rs, re, cnt):
    """Host: padded row -> interval list."""
    rs = torch.as_tensor(rs).cpu().numpy()
    re = torch.as_tensor(re).cpu().numpy()
    n = int(torch.as_tensor(cnt).reshape(-1)[0])
    return [(int(rs[i]), int(re[i])) for i in range(n)]


def contains(rs, re, site):
    """Membership of one site (pad slots never match: BIG <= site is false
    for real sites)."""
    return torch.any((rs <= site) & (site < re))


def contains_many(rs, re, sites):
    """Membership mask for a vector of sites: (S,) bool."""
    return torch.any((rs[None, :] <= sites[:, None])
                     & (sites[:, None] < re[None, :]), dim=1)


def row_size(rs, re, cnt):
    idx = torch.arange(rs.shape[0], device=rs.device)
    return torch.where(idx < cnt, re - rs, 0).sum().reshape(1)


def combine(ars, are, acnt, brs, bre, bcnt, op: str, WR_out: int):
    """Generic boundary sweep: returns (rs, re, cnt, ok) of op(a, b) where
    op is "union" | "minus" | "intersect".  ok=False iff the result needs
    more than WR_out runs (the row then holds the first WR_out runs'
    starts; the JAX function's overflowing row differs there, and neither
    is read)."""
    dev = ars.device
    pts = torch.sort(torch.cat([ars, are, brs, bre])).values
    lo = pts[:-1]
    hi = pts[1:]
    in_a = contains_many(ars, are, lo)
    in_b = contains_many(brs, bre, lo)
    if op == "union":
        keep = in_a | in_b
    elif op == "minus":
        keep = in_a & ~in_b
    elif op == "intersect":
        keep = in_a & in_b
    else:
        raise ValueError(op)
    keep = keep & (lo < hi) & (lo < BIG)
    # merge adjacent kept segments: a new output run starts at a kept
    # segment whose nearest earlier non-empty or kept segment is not a kept
    # one ending where it starts (the JAX scan's carry, as a running max of
    # that segment's index: zero-length segments carry continuity)
    S = lo.shape[0]
    seg = torch.arange(S, device=dev)
    marked = torch.where(keep | (lo < hi), seg, -1)
    last = torch.cummax(marked, 0).values
    prev = torch.cat([torch.full((1,), -1, dtype=last.dtype, device=dev),
                      last[:-1]])
    prev_c = prev.clamp(min=0)
    prev_end = torch.where((prev >= 0) & keep[prev_c], hi[prev_c], -1)
    is_start = keep & (lo != prev_end)
    gid = torch.cumsum(is_start.long(), 0) - 1
    n_out = is_start.sum().reshape(1)
    ok = n_out <= WR_out
    sink = WR_out
    # each output slot is written once; the sink takes the rest
    idx_s = torch.where(is_start & (gid < WR_out), gid, sink)
    rs_out = torch.full((WR_out + 1,), BIG, dtype=torch.int64, device=dev)
    rs_out = rs_out.index_put((idx_s,), lo)[:WR_out]
    idx_e = torch.where(keep & (gid < WR_out), gid, sink)
    re_out = torch.zeros(WR_out + 1, dtype=torch.int64, device=dev)
    re_out = re_out.scatter_reduce(0, idx_e, hi, "amax")[:WR_out]
    # (a clamp, not a tensor of WR_out: a host-to-device copy would
    # synchronise the stream)
    re_out = torch.where(torch.arange(WR_out, device=dev)
                         < n_out.clamp(max=WR_out), re_out, BIG)
    return rs_out, re_out, n_out, ok


def row_union(a, b, WR_out: int):
    return combine(*a, *b, op="union", WR_out=WR_out)


def row_minus(a, b, WR_out: int):
    return combine(*a, *b, op="minus", WR_out=WR_out)


def row_intersect(a, b, WR_out: int):
    return combine(*a, *b, op="intersect", WR_out=WR_out)


def empty_row(WR: int, device="cpu"):
    dev = torch.device(device)
    return (torch.full((WR,), BIG, dtype=torch.int64, device=dev),
            torch.full((WR,), BIG, dtype=torch.int64, device=dev),
            torch.zeros(1, dtype=torch.int64, device=dev))
