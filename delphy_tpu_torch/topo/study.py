"""SPR study: enumeration and weighting of candidate regraft regions.

Host port of core/spr_study.{h,cpp}: a restricted DFS outward from the detach
point, one candidate region per inter-mutation segment of each branch,
tracking site deltas to X and minimum mutation counts; regions weighted by a
JC-like insertion likelihood softened by an annealing factor (SURVEY.md §A.5).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
from scipy.special import gammaincc, gammainccinv, gammaln

from ..phylo import FlatTree, NO_NODE
from . import site_deltas as sd

NEG_BIG = -1.7976931348623157e308  # reference uses -DBL_MAX for "above root"


@dataclass
class CandidateRegion:
    branch: int
    mut_idx: int
    t_min: float
    t_max: float
    min_muts: int
    log_W_over_Wmax: float = 0.0
    W_over_Wmax: float = 0.0

    def is_above_root(self) -> bool:
        return self.t_min == NEG_BIG


def _pop_front(deltas: dict, m):
    """Drop a leading from->to delta at m's site: the path previously
    started just above m, now it starts just below (site_deltas.h:100-128).
    Exact inverse of sd.push_front for the same mutation."""
    if m.site in deltas:
        f0, t0 = deltas[m.site]
        assert f0 == m.from_
        if m.to == t0:
            del deltas[m.site]
        else:
            deltas[m.site] = (m.to, t0)
    else:
        deltas[m.site] = (m.to, m.from_)


class SprStudyBuilder:
    """Candidate-region enumeration: DFS-with-undo over the segment graph.

    One vertex per inter-mutation segment of a branch ((b, i) = the stretch
    of branch b between mutation i-1 and mutation i, or the adjacent node
    ends); edges cross either a mutation within a branch or a node between
    branches.  Crossing a non-missing mutation prepends/pops its site delta
    on the running X-deltas map and counts toward the path-mutation bound;
    node crossings are free.  Each DFS frame carries an undo record (the
    crossing's inverse map operation), applied when the frame pops — no
    walker state machine, no paired backtrack work items.

    spr_study.cpp:26-120 is the spec for WHAT to enumerate (region set,
    min-mut counts, bound semantics); the segment-frame traversal here is
    this repo's own decomposition.  Exploration order matches the move-for-
    move pin tests: children high-to-low / down-mutation first, then up."""

    def __init__(self, tree: FlatTree, X: int, t_X: float, missing_at_X: set,
                 max_muts_from_start: int = 2 ** 31):
        self.tree = tree
        self.X = X
        self.t_X = t_X
        self.missing_at_X = missing_at_X
        self.max_muts_from_start = max_muts_from_start
        self.result: list = []

    def region_t_min(self, branch, mut_idx):
        t = self.tree
        if branch == t.root:
            return NEG_BIG
        muts = t.mutations[branch]
        if mut_idx == 0:
            return float(t.t[int(t.parent[branch])])
        return muts[mut_idx - 1].t

    def seed_fill_from(self, init_branch, init_mut_idx, init_to_X_deltas,
                       can_change_root):
        self._raw_fill(init_branch, init_mut_idx, init_to_X_deltas)
        self._account_for_Xs_detachment(can_change_root)
        self._remove_regions_in_Xs_future()

    def _raw_fill(self, init_branch, init_mut_idx, init_to_X_deltas):
        """DFS visit set before the detachment rewrites (also pinned directly
        by the device-flood equivalence test, test_jit_spr_study.py)."""
        tree = self.tree
        muts_of = tree.mutations
        parent = tree.parent
        children = tree.children
        root = tree.root
        miss = self.missing_at_X
        X = self.X
        limit = self.max_muts_from_start
        deltas = dict(init_to_X_deltas)
        count = 0          # path mutations from the seed (the bound)
        res = []           # (b, i, t_min, t_max, |deltas|) in visit order

        def record(b, i):
            muts = muts_of[b]
            if b == root:
                tmin, tmax = NEG_BIG, float(tree.t[b])
            else:
                tmin = float(tree.t[int(parent[b])]) if i == 0 \
                    else muts[i - 1].t
                tmax = float(tree.t[b]) if i == len(muts) else muts[i].t
            res.append((b, i, tmin, tmax, len(deltas)))

        if init_branch != X and count <= limit:
            record(init_branch, init_mut_idx)
            # frame: [b, i, came_b, came_i, cursor, undo_kind, undo_mut]
            # undo_kind: 0 none, 1 re-push (entry popped), 2 re-pop (entry
            # pushed); cursor: 0 first down neighbor, 1 second (low child),
            # 2 up, 3 exhausted
            stack = [[init_branch, init_mut_idx, -2, -2, 0, 0, None]]
            while stack:
                fr = stack[-1]
                b, i = fr[0], fr[1]
                muts = muts_of[b]
                nb = m = None
                up = False
                cur = fr[4]
                if cur == 0:
                    fr[4] = 1
                    if i == len(muts):
                        c1 = int(children[b][1])
                        if c1 != NO_NODE:
                            nb = (c1, 0)
                    else:
                        nb, m = (b, i + 1), muts[i]
                elif cur == 1:
                    fr[4] = 2
                    if i == len(muts):
                        c0 = int(children[b][0])
                        if c0 != NO_NODE:
                            nb = (c0, 0)
                elif cur == 2:
                    fr[4] = 3
                    if b != root:
                        if i > 0:
                            nb, m, up = (b, i - 1), muts[i - 1], True
                        else:
                            pb = int(parent[b])
                            nb = (pb, len(muts_of[pb]))
                else:  # exhausted: undo the entry crossing, pop the frame
                    if fr[5] == 1:
                        sd.push_front(deltas, fr[6].site, fr[6].from_,
                                      fr[6].to)
                        count -= 1
                    elif fr[5] == 2:
                        _pop_front(deltas, fr[6])
                        count -= 1
                    stack.pop()
                    continue
                if nb is None or (nb[0] == fr[2] and nb[1] == fr[3]):
                    continue  # no neighbor there / came from there
                undo, undo_m = 0, None
                if m is not None and m.site not in miss:
                    if up:
                        sd.push_front(deltas, m.site, m.from_, m.to)
                        undo = 2
                    else:
                        _pop_front(deltas, m)
                        undo = 1
                    undo_m = m
                    count += 1
                tb, ti = nb
                if tb != X and count <= limit:
                    record(tb, ti)
                    stack.append([tb, ti, b, i, 0, undo, undo_m])
                elif undo == 1:  # out of scope: revert immediately
                    sd.push_front(deltas, undo_m.site, undo_m.from_, undo_m.to)
                    count -= 1
                elif undo == 2:
                    _pop_front(deltas, undo_m)
                    count -= 1
        self.result = [CandidateRegion(branch=b, mut_idx=mi, t_min=tmin,
                                       t_max=tmax, min_muts=mm)
                       for (b, mi, tmin, tmax, mm) in res]

    def _account_for_Xs_detachment(self, can_change_root):
        """spr_study.cpp:130-208."""
        t = self.tree
        X = self.X
        if X == NO_NODE:
            if not can_change_root:
                self.result = [r for r in self.result if r.branch != t.root]
            return
        P = int(t.parent[X])
        a, b = t.children[P]
        S = int(b) if int(a) == X else int(a)
        num_muts_G_to_P = len(t.mutations[P])

        for region in self.result:
            if not can_change_root and region.branch == t.root:
                region.branch = -1
                continue
            if region.branch != S and region.branch != P:
                continue
            if P != t.root:
                if region.branch == S:
                    if region.mut_idx == 0:
                        region.t_min = self.region_t_min(P, num_muts_G_to_P)
                    region.mut_idx += num_muts_G_to_P
                else:  # region.branch == P
                    if region.mut_idx == num_muts_G_to_P:
                        region.branch = -1
                    else:
                        region.branch = S
            else:
                if not can_change_root:
                    if region.branch == P:
                        region.branch = -1
                else:
                    if (region.branch == S
                            and region.mut_idx == len(t.mutations[S])):
                        region.mut_idx += num_muts_G_to_P
                        region.t_min = NEG_BIG
                    else:
                        region.branch = -1
        self.result = [r for r in self.result if r.branch != -1]

    def _remove_regions_in_Xs_future(self):
        out = []
        for r in self.result:
            if r.t_min >= self.t_X:
                continue
            if r.t_max > self.t_X:
                r.t_max = self.t_X
            out.append(r)
        self.result = out


class SprStudy:
    """Weights + sampling over candidate regions (spr_study.cpp:226-547)."""

    def __init__(self, builder: SprStudyBuilder, lambda_X: float,
                 annealing_factor: float, t_X: float, t_max_tip: float):
        self.tree = builder.tree
        self.lambda_X = lambda_X
        self.f = annealing_factor
        self.t_X = t_X
        self.t_max_tip = t_max_tip
        self.regions = builder.result
        self.mu = lambda_X / (self.tree.num_sites - len(builder.missing_at_X))
        assert self.regions, "SPR study found no candidate regions"

        f, mu, lamX = self.f, self.mu, self.lambda_X
        for r in self.regions:
            m = r.min_muts
            if not r.is_above_root():
                t_prime = 0.5 * (r.t_min + r.t_max)
                arg1 = f * lamX * (r.t_max - r.t_min)
                arg2 = mu * (t_X - t_prime) / 3.0
                if arg1 <= 0.0 or (m > 0 and arg2 <= 0.0):
                    r.log_W_over_Wmax = -math.inf
                else:
                    r.log_W_over_Wmax = (math.log(arg1)
                                         + f * (-lamX * (t_X - t_prime)
                                                + m * math.log(arg2)))
            else:
                t_S = float(self.tree.t[r.branch])
                s_min = abs(t_X - t_S)
                t_early = min(t_X, t_S)
                s_max = s_min + 20.0 * max(self.t_max_tip - t_early, 0.0)
                x_min = lamX * f * s_min
                x_max = lamX * f * s_max
                if x_max < 0.01:
                    alpha = f * m + 1
                    r.log_W_over_Wmax = (
                        -math.log(2.0) + math.log(f * lamX)
                        + f * m * math.log(mu / 3.0)
                        + alpha * math.log(s_max)
                        + math.log1p(-((s_min / s_max) ** alpha))
                        - math.log(alpha))
                else:
                    r.log_W_over_Wmax = (
                        -math.log(2.0)
                        + f * m * math.log(mu / (3.0 * lamX * f))
                        + float(gammaln(f * m + 1))
                        + _safe_log_gamma_integral(f * m + 1, x_min, x_max))

        self.log_Wmax = max(r.log_W_over_Wmax for r in self.regions)
        if not math.isfinite(self.log_Wmax):
            self.log_Wmax = 0.0
        self.sum_W = 0.0
        for r in self.regions:
            r.log_W_over_Wmax -= self.log_Wmax
            r.W_over_Wmax = math.exp(r.log_W_over_Wmax)
            self.sum_W += r.W_over_Wmax

    def pick_nexus_region(self, rng: np.random.Generator) -> int:
        u = rng.uniform(0.0, self.sum_W)
        for i, r in enumerate(self.regions):
            if r.W_over_Wmax >= u:
                return i
            u -= r.W_over_Wmax
        return 0

    def _root_s_bounds(self, region):
        t_S = float(self.tree.t[region.branch])
        s_min = abs(self.t_X - t_S)
        s_max = s_min + 20.0 * max(self.t_max_tip - min(self.t_X, t_S), 0.0)
        return t_S, s_min, s_max

    def pick_time_in_region(self, idx: int, rng: np.random.Generator) -> float:
        r = self.regions[idx]
        if not r.is_above_root():
            u = rng.uniform(0.0, 1.0)
            return r.t_max - u * (r.t_max - r.t_min)  # in (t_min, t_max]
        f, m, lamX = self.f, r.min_muts, self.lambda_X
        t_S, s_min, s_max = self._root_s_bounds(r)
        x_max = lamX * f * s_max
        if x_max < 0.01:
            alpha = f * m + 1
            U = rng.uniform(1e-16, 1.0)
            s = (s_min ** alpha + U * (s_max ** alpha - s_min ** alpha)) ** (1.0 / alpha)
        else:
            alpha = f * m + 1
            Q_hi = float(gammaincc(alpha, lamX * f * s_min))
            Q_lo = float(gammaincc(alpha, lamX * f * s_max))
            Q = Q_lo + rng.uniform(1e-16, 1.0) * (Q_hi - Q_lo)
            y = float(gammainccinv(alpha, Q))
            s = min(max(y / (lamX * f), s_min), s_max)
        t = 0.5 * (self.t_X + t_S - s)
        return min(max(t, r.t_min), r.t_max)

    def find_region(self, branch: int, t: float) -> int:
        for i, r in enumerate(self.regions):
            if r.branch == branch and r.t_min < t <= r.t_max:
                return i
        return -1

    def log_alpha_in_region(self, idx: int, t: float) -> float:
        r = self.regions[idx]
        # std::log's values where math.log raises (all weights 0, a region
        # of no length): the move's ratio is then NaN and it is rejected,
        # as in the native kernel (topo_native.cpp log_alpha_in_region)
        log_p_region = r.log_W_over_Wmax - _ieee_log(self.sum_W)
        if not r.is_above_root():
            return log_p_region - _ieee_log(r.t_max - r.t_min)
        f, m, lamX = self.f, r.min_muts, self.lambda_X
        t_S, s_min, s_max = self._root_s_bounds(r)
        x_min, x_max = lamX * f * s_min, lamX * f * s_max
        s = (self.t_X - t) + (t_S - t)
        if s > s_max + 1e-6:
            return -math.inf
        if x_max < 0.01:
            alpha = f * m + 1
            return (log_p_region + math.log(2.0) + math.log(alpha)
                    + (alpha - 1) * math.log(s) - alpha * math.log(s_max)
                    - math.log1p(-((s_min / s_max) ** alpha)))
        return (log_p_region + math.log(2.0) + math.log(lamX * f)
                + f * m * math.log(lamX * f * s) - lamX * f * s
                - float(gammaln(f * m + 1))
                - _safe_log_gamma_integral(f * m + 1, x_min, x_max))


def _ieee_log(x: float) -> float:
    """math.log with C's values at 0 (-inf) and below (NaN)."""
    if x > 0.0:
        return math.log(x)
    return -math.inf if x == 0.0 else math.nan


def _safe_log_gamma_integral(a: float, x_min: float, x_max: float) -> float:
    """log(Q(a, x_min) - Q(a, x_max)) (safe_gamma_math.h:82-90)."""
    Q_hi = float(gammaincc(a, x_min))
    Q_lo = float(gammaincc(a, x_max))
    diff = max(Q_hi - Q_lo, 0.0)
    return math.log(diff) if diff > 0 else -math.inf
