"""Bounded SPR-study region enumeration (port of
``delphy_tpu/ops/spr_study.py``).

Device twin of the host SPR-study DFS for the bounded case
(max_muts_from_start = 1, which the reference uses for 99% of SPR moves —
subrun.cpp:495-499; host twin: ``topo/study.py``, reference
core/spr_study.{h,cpp}).

The inter-mutation regions of a phylogenetic tree form a TREE themselves,
with two edge kinds — junction edges (zero cost) and mutation edges (cost 1,
or 0 when the site is missing at X, which the DFS neither counts nor
composes).  The bounded study is then a 0-1 BFS:

 * distance-0 regions: the zero-cost component of the seed;
 * distance-1 regions: for every counted mutation with exactly one side at
   distance 0, the far side's zero-cost component.  Region paths are unique
   (tree!), so these components are disjoint and each inherits a single
   min_muts = |seed deltas composed with its one counted crossing| —
   crossing down composes pop_front, crossing up push_front
   (site_deltas.h:82-128), which changes the delta-set size by +1 (site
   absent), -1 (crossing cancels the stored delta), or 0.

X's own branch regions are excluded (the DFS never visits or expands them,
spr_study.h:150), which also blocks propagation through X.

The JAX package floods to a fixpoint in a data-dependent loop.  Here each
region points to its parent region in the region tree when the edge between
them is zero-cost and neither end is excluded, and pointer doubling
(ceil(log2 R) + 1 gathers) takes every region to the top of its zero-cost
component: two regions share a component iff they share a top.  Same sets,
no host synchronisation.

The weights, the region and time picks and the proposal densities
(spr_study.cpp:226-547) are elementwise tensor code over the region arrays;
their dtype and device are the inputs'.  ``above_root=False`` skips the
above-root terms where a caller's regions are all inner (the device SPR1 of
``spr_move.py`` filters them out), leaving every result the same.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import DEFAULT_DEVICE, resolve_device, resolve_dtype
from ..phylo import FlatTree, NO_NODE
from ..topo.study import CandidateRegion, NEG_BIG
from .likelihood import cumsum0


def pack_study_tree(tree: FlatTree):
    """Flat arrays for the region graph: per-branch mutation CSR (time
    order), region id bases (rid(b, i) = moff[b] + b + i), junction pairs."""
    N = tree.num_nodes
    nb = np.array([len(tree.mutations[b]) for b in range(N)], dtype=np.int64)
    moff = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(nb, out=moff[1:])
    M = int(moff[N])
    m_branch = np.zeros(M, dtype=np.int64)
    m_site = np.zeros(M, dtype=np.int64)
    m_from = np.zeros(M, dtype=np.int8)
    m_to = np.zeros(M, dtype=np.int8)
    m_t = np.zeros(M, dtype=np.float64)
    for b in range(N):
        for i, m in enumerate(tree.mutations[b]):
            j = moff[b] + i
            m_branch[j] = b
            m_site[j] = m.site
            m_from[j] = m.from_
            m_to[j] = m.to
            m_t[j] = m.t
    rid_base = moff[:N] + np.arange(N, dtype=np.int64)
    R = M + N
    root = int(tree.root)
    nonroot = np.array([b for b in range(N) if b != root], dtype=np.int64)
    parents = np.asarray(tree.parent, dtype=np.int64)[nonroot]
    jr_parent = rid_base[parents] + nb[parents]  # (parent, last) region
    jr_child = rid_base[nonroot]                 # (child, 0) region
    return dict(N=N, M=M, R=R, nb=nb, moff=moff, rid_base=rid_base,
                m_branch=m_branch, m_site=m_site, m_from=m_from, m_to=m_to,
                m_t=m_t, jr_parent=jr_parent, jr_child=jr_child, root=root)


def _doubling_iters(n: int) -> int:
    return max(1, math.ceil(math.log2(n + 1))) + 1


def _component_tops(R: int, excluded, r_above, zero_cost, jr_parent,
                    jr_child):
    """Top of each region's zero-cost component.  Slot R is a sink for
    mutation edges whose lower region lies outside [0, R) (the padded slots
    of ``spr_move.study_regions``); it is no region's parent."""
    dev = r_above.device
    up = torch.arange(R + 1, device=dev)
    rb = r_above + 1
    # each region has one parent edge: a mutation edge above it (i > 0) or
    # the junction to its parent branch (i == 0); only the sink and the
    # study's own sink slot take duplicate writes, all of equal value
    up = up.index_put((rb.clamp(max=R),),
                      torch.where(zero_cost & (rb < R), r_above,
                                  rb.clamp(max=R)))
    up = up.index_put((jr_child,), jr_parent)
    ex = torch.cat([excluded, torch.zeros(1, dtype=torch.bool, device=dev)])
    idx = torch.arange(R + 1, device=dev)
    up = torch.where(ex | ex[up], idx, up)
    for _ in range(_doubling_iters(R)):
        up = up[up]
    return up


def _bounded_flood(R: int, seed_rid, excl_lo, excl_hi, r_above, counted,
                   jr_parent, jr_child, mm0, d_down, d_up):
    """reach0/reach1 masks + per-region min_muts for the 0-1 BFS (R,).

    r_above[m] is the region above mutation m (the one below is
    r_above[m] + 1); seed_rid, excl_lo, excl_hi and mm0 are one-element
    tensors (or ints)."""
    dev = r_above.device
    rid = torch.arange(R, device=dev)
    excluded = (rid >= excl_lo) & (rid <= excl_hi)
    tops = _component_tops(R, excluded, r_above, ~counted, jr_parent,
                           jr_child)
    seed = torch.as_tensor(seed_rid, device=dev).reshape(1)
    reach0 = (tops[:R] == tops[seed]) & ~excluded

    # distance-1 entries across counted mutations with one side reached
    r0 = torch.cat([reach0, torch.zeros(1, dtype=torch.bool, device=dev)])
    ra, rb = r_above, (r_above + 1).clamp(max=R)
    down_entry = counted & r0[ra] & ~r0[rb]   # crossing above->below
    up_entry = counted & r0[rb] & ~r0[ra]     # crossing below->above
    # the entry region of each distance-1 component, with its min_muts:
    # scattered onto the component's top (one entry per component)
    sink = R
    ex = torch.cat([excluded, torch.ones(1, dtype=torch.bool, device=dev)])
    e_down = down_entry & ~ex[rb]
    e_up = up_entry & ~ex[ra]
    mm0 = torch.as_tensor(mm0, device=dev).reshape(1).to(d_down.dtype)
    val = torch.full((R + 1,), -1, dtype=d_down.dtype, device=dev)
    val = val.scatter_reduce(0, torch.where(e_down, tops[rb], sink),
                             torch.where(e_down, mm0 + d_down, -1), "amax")
    val = val.scatter_reduce(0, torch.where(e_up, tops[ra], sink),
                             torch.where(e_up, mm0 + d_up, -1), "amax")
    # a real region's top is a real region, so the sink is never read
    vtop = val[tops[:R]]
    reach1 = (vtop >= 0) & ~reach0 & ~excluded
    vmm1 = torch.where(reach1, vtop, -1)
    return reach0, reach1, vmm1


def bounded_spr_study(tree: FlatTree, X: int, t_X: float, missing_at_X: set,
                      seed_branch: int, seed_mut_idx: int, init_deltas: dict,
                      can_change_root: bool, packed=None,
                      device=DEFAULT_DEVICE):
    """All candidate regions reachable with <= 1 counted mutation crossing —
    the flood on ``device`` + host region-list rewrites.  Equals the host
    SprStudyBuilder with max_muts_from_start=1 as a set."""
    p = packed or pack_study_tree(tree)
    N, M, R = p["N"], p["M"], p["R"]
    root = p["root"]
    dev = resolve_device(device)

    def _member(sorted_arr, values):
        if len(sorted_arr) == 0:
            return np.zeros(len(values), dtype=bool)
        i = np.searchsorted(sorted_arr, values)
        i_c = np.clip(i, 0, len(sorted_arr) - 1)
        return (i < len(sorted_arr)) & (sorted_arr[i_c] == values)

    miss = (np.sort(np.fromiter(missing_at_X, dtype=np.int64,
                                count=len(missing_at_X)))
            if missing_at_X else np.zeros(0, dtype=np.int64))
    counted = ~_member(miss, p["m_site"])

    # size effect of composing the one counted crossing with init_deltas:
    # +1 site absent, -1 crossing cancels the stored delta, else 0
    d_down = np.ones(M, dtype=np.int64)
    d_up = np.ones(M, dtype=np.int64)
    if init_deltas:
        d_sites = np.sort(np.fromiter(init_deltas, dtype=np.int64,
                                      count=len(init_deltas)))
        d_t0 = np.array([init_deltas[int(s)][1] for s in d_sites],
                        dtype=np.int64)
        hit = _member(d_sites, p["m_site"])
        pos = np.clip(np.searchsorted(d_sites, p["m_site"]), 0,
                      len(d_sites) - 1)
        t0 = d_t0[pos]
        d_down = np.where(hit, np.where(p["m_to"] == t0, -1, 0), 1) \
            .astype(np.int64)
        d_up = np.where(hit, np.where(p["m_from"] == t0, -1, 0), 1) \
            .astype(np.int64)

    rid_base = p["rid_base"]
    seed_rid = int(rid_base[seed_branch] + seed_mut_idx)
    excl_lo = int(rid_base[X])
    excl_hi = int(rid_base[X] + p["nb"][X])

    def T(a):
        return torch.as_tensor(np.asarray(a)).to(dev)

    reach0, reach1, vmm1 = _bounded_flood(
        R, seed_rid, excl_lo, excl_hi,
        T(p["m_branch"] + np.arange(M, dtype=np.int64)), T(counted),
        T(p["jr_parent"]), T(p["jr_child"]), len(init_deltas), T(d_down),
        T(d_up))
    reach0 = reach0.cpu().numpy()
    reach1 = reach1.cpu().numpy()
    vmm1 = vmm1.cpu().numpy()

    # region list with t bounds (host-side rewrites as in the host builder)
    t = np.asarray(tree.t, dtype=np.float64)
    parent = np.asarray(tree.parent)
    result = []
    mm_base = len(init_deltas)
    for rid in np.nonzero(reach0 | reach1)[0]:
        # invert rid -> (branch, idx)
        b = int(np.searchsorted(rid_base, rid, side="right") - 1)
        i = int(rid - rid_base[b])
        muts = tree.mutations[b]
        if b == root:
            t_min, t_max = NEG_BIG, float(t[b])
        else:
            t_min = float(t[parent[b]]) if i == 0 else muts[i - 1].t
            t_max = float(t[b]) if i == len(muts) else muts[i].t
        mm = mm_base if reach0[rid] else int(vmm1[rid])
        result.append(CandidateRegion(branch=b, mut_idx=i, t_min=t_min,
                                      t_max=t_max, min_muts=mm))

    # detachment accounting (spr_study.cpp:130-208) + t_X future trim
    if X != NO_NODE:
        P = int(parent[X])
        a, b2 = tree.children[P]
        S = int(b2) if int(a) == X else int(a)
        nmGP = len(tree.mutations[P])
        kept = []
        for r in result:
            if not can_change_root and r.branch == root:
                continue
            if r.branch in (S, P):
                if P != root:
                    if r.branch == S:
                        if r.mut_idx == 0:
                            r.t_min = (NEG_BIG if P == root else
                                       (float(t[parent[P]]) if nmGP == 0
                                        else tree.mutations[P][nmGP - 1].t))
                        r.mut_idx += nmGP
                    else:
                        if r.mut_idx == nmGP:
                            continue
                        r.branch = S
                else:
                    if not can_change_root:
                        if r.branch == P:
                            continue
                    else:
                        if (r.branch == S
                                and r.mut_idx == len(tree.mutations[S])):
                            r.mut_idx += nmGP
                            r.t_min = NEG_BIG
                        else:
                            continue
            kept.append(r)
        result = kept
    elif not can_change_root:
        result = [r for r in result if r.branch != root]

    out = []
    for r in result:
        if r.t_min >= t_X:
            continue
        if r.t_max > t_X:
            r.t_max = t_X
        out.append(r)
    return out


# ---------------------------------------------------------------------------
# Region weights, sampling, and proposal densities (spr_study.cpp:226-547)
# over the enumerated region arrays.
# ---------------------------------------------------------------------------

def pack_regions(tree: FlatTree, regions, device=DEFAULT_DEVICE,
                 dtype=None):
    """Region list -> flat tensors (branch, above_root, t_min, t_max,
    min_muts, t_S) on ``device``, in ``dtype`` (``resolve_dtype``)."""
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)
    t = np.asarray(tree.t, dtype=np.float64)
    br = np.array([r.branch for r in regions], dtype=np.int64)

    def F(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(
            dev, dtype)
    return dict(
        branch=torch.as_tensor(br).to(dev),
        above=torch.as_tensor(np.array([r.t_min == NEG_BIG
                                        for r in regions])).to(dev),
        t_min=F([r.t_min for r in regions]),
        t_max=F([r.t_max for r in regions]),
        mm=F([r.min_muts for r in regions]),
        t_S=F(t[br]),
    )


def _root_s_bounds(t_S, t_X, t_max_tip):
    s_min = torch.abs(t_X - t_S)
    s_max = s_min + 20.0 * torch.clamp(t_max_tip - torch.minimum(
        torch.as_tensor(t_X, dtype=t_S.dtype, device=t_S.device), t_S),
        min=0.0)
    return s_min, s_max


def _log_gamma_integral(a, x_min, x_max):
    """log(Q(a, x_min) - Q(a, x_max)), -inf when empty
    (safe_gamma_math.h:82-90)."""
    diff = torch.clamp(torch.special.gammaincc(a, x_min)
                       - torch.special.gammaincc(a, x_max), min=0.0)
    return torch.where(diff > 0.0, torch.log(torch.clamp(diff, min=1e-300)),
                       -torch.inf)


def study_log_weights(reg, lambda_X, f, t_X, t_max_tip, mu,
                      above_root: bool = True):
    """log W per region up to the common normalization
    (spr_study.cpp:260-330; host twin topo/study.py SprStudy.__init__)."""
    m = reg["mm"]
    # inner regions
    t_prime = 0.5 * (reg["t_min"] + reg["t_max"])
    arg1 = f * lambda_X * (reg["t_max"] - reg["t_min"])
    arg2 = mu * (t_X - t_prime) / 3.0
    inner_bad = (arg1 <= 0.0) | ((m > 0) & (arg2 <= 0.0))
    safe1 = torch.where(arg1 > 0, arg1, 1.0)
    safe2 = torch.where(arg2 > 0, arg2, 1.0)
    lw_inner = torch.where(
        inner_bad, -torch.inf,
        torch.log(safe1) + f * (-lambda_X * (t_X - t_prime)
                                + m * torch.log(safe2)))
    if not above_root:
        return lw_inner
    # above-root region
    s_min, s_max = _root_s_bounds(reg["t_S"], t_X, t_max_tip)
    x_min = lambda_X * f * s_min
    x_max = lambda_X * f * s_max
    alpha = f * m + 1.0
    ratio = torch.where(s_max > 0,
                        s_min / torch.where(s_max > 0, s_max, 1.0), 0.0)
    lw_root_small = (-math.log(2.0) + torch.log(f * lambda_X)
                     + f * m * torch.log(mu / 3.0)
                     + alpha * torch.log(torch.clamp(s_max, min=1e-300))
                     + torch.log1p(-ratio ** alpha) - torch.log(alpha))
    lw_root_big = (-math.log(2.0)
                   + f * m * torch.log(mu / (3.0 * lambda_X * f))
                   + torch.special.gammaln(alpha)
                   + _log_gamma_integral(alpha, x_min, x_max))
    lw_root = torch.where(x_max < 0.01, lw_root_small, lw_root_big)
    return torch.where(reg["above"], lw_root, lw_inner)


def pick_nexus_region(u01, log_w):
    """Region index (one element) from one uniform, exactly the host's scan
    over W/W_max (same u -> same index a.e.)."""
    log_wmax = log_w.max().reshape(1)
    log_wmax = torch.where(torch.isfinite(log_wmax), log_wmax, 0.0)
    w = torch.exp(log_w - log_wmax)
    c = cumsum0(w).contiguous()     # a fixed order on the card
    u = (u01 * c[-1:]).reshape(1)
    return torch.clamp(torch.searchsorted(c, u, right=False),
                       max=log_w.shape[0] - 1)


def _gammainccinv(a, q, x_hi):
    """Inverse of Q(a, x) in x by 100 bisection steps over [0, x_hi] (the
    JAX package's, which has no gammainccinv; callers clip the result into
    [x_lo, x_hi]/rate anyway, so q below Q(a, x_hi) — including
    underflowed-to-0 deep tails — correctly saturates at x_hi)."""
    lo = torch.zeros_like(q)
    hi = x_hi * torch.ones_like(q)
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        too_low_x = torch.special.gammaincc(a, mid) < q
        hi = torch.where(too_low_x, mid, hi)
        lo = torch.where(too_low_x, lo, mid)
    return 0.5 * (lo + hi)


def _at(x, idx):
    return x.index_select(0, idx.reshape(-1))


def pick_time_in_region(u01, idx, reg, lambda_X, f, t_X, t_max_tip,
                        above_root: bool = True):
    """Proposal time within region ``idx`` (one element) from one uniform
    (spr_study.cpp pick_time; host twin pick_time_in_region)."""
    t_min = _at(reg["t_min"], idx)
    t_max = _at(reg["t_max"], idx)
    t_inner = t_max - u01 * (t_max - t_min)
    if not above_root:
        return t_inner
    m = _at(reg["mm"], idx)
    t_S = _at(reg["t_S"], idx)
    above = _at(reg["above"], idx)

    s_min, s_max = _root_s_bounds(t_S, t_X, t_max_tip)
    x_max = lambda_X * f * s_max
    alpha = f * m + 1.0
    U = 1e-16 + u01 * (1.0 - 1e-16)
    s_small = (s_min ** alpha + U * (s_max ** alpha - s_min ** alpha)) \
        ** (1.0 / alpha)
    Q_hi = torch.special.gammaincc(alpha, lambda_X * f * s_min)
    Q_lo = torch.special.gammaincc(alpha, lambda_X * f * s_max)
    Q = Q_lo + U * (Q_hi - Q_lo)
    y = _gammainccinv(alpha, Q, lambda_X * f * s_max + 1.0)
    s_big = torch.clamp(y / (lambda_X * f), s_min, s_max)
    s = torch.where(x_max < 0.01, s_small, s_big)
    t_root = torch.clamp(0.5 * (t_X + t_S - s), t_min, t_max)
    return torch.where(above, t_root, t_inner)


def log_alpha_in_region(idx, t, log_w, reg, lambda_X, f, t_X, t_max_tip,
                        above_root: bool = True):
    """Proposal log-density of (region idx, time t) given the study weights
    (spr_study.cpp log_alpha; host twin log_alpha_in_region)."""
    log_p_region = _at(log_w, idx) - torch.logsumexp(log_w, 0)
    t_min = _at(reg["t_min"], idx)
    t_max = _at(reg["t_max"], idx)
    la_inner = log_p_region - torch.log(t_max - t_min)
    if not above_root:
        return la_inner
    m = _at(reg["mm"], idx)
    t_S = _at(reg["t_S"], idx)
    above = _at(reg["above"], idx)

    s_min, s_max = _root_s_bounds(t_S, t_X, t_max_tip)
    x_min = lambda_X * f * s_min
    x_max = lambda_X * f * s_max
    s = (t_X - t) + (t_S - t)
    alpha = f * m + 1.0
    ratio = torch.where(s_max > 0,
                        s_min / torch.where(s_max > 0, s_max, 1.0), 0.0)
    la_small = (log_p_region + math.log(2.0) + torch.log(alpha)
                + (alpha - 1.0) * torch.log(torch.clamp(s, min=1e-300))
                - alpha * torch.log(torch.clamp(s_max, min=1e-300))
                - torch.log1p(-ratio ** alpha))
    la_big = (log_p_region + math.log(2.0) + torch.log(lambda_X * f)
              + f * m * torch.log(lambda_X * f * torch.clamp(s, min=1e-300))
              - lambda_X * f * s - torch.special.gammaln(alpha)
              - _log_gamma_integral(alpha, x_min, x_max))
    la_root = torch.where(s > s_max + 1e-6, -torch.inf,
                          torch.where(x_max < 0.01, la_small, la_big))
    return torch.where(above, la_root, la_inner)


def find_region(branch, t, reg):
    """Index (one element) of the region containing (branch, t), -1 if none
    (the reverse-proposal lookup, spr_study.cpp find_region; host twin
    find_region)."""
    hit = ((reg["branch"] == branch) & (reg["t_min"] < t)
           & (t <= reg["t_max"]))
    idx = torch.argmax(hit.to(torch.int8)).reshape(1)
    return torch.where(hit.any(), idx, -1)
