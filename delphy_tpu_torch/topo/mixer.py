"""Topology-move driver: subtree-slide, Wilson-Balding and SPR1 moves on the
host FlatTree, mirroring core/subrun.cpp:352-742, with coalescent-prior deltas
against a host copy of the cell grid (core/scalable_coalescent.cpp)."""

from __future__ import annotations

import math

import numpy as np

from ..phylo import FlatTree, NO_NODE
from .graft import SprContext, _sibling, _miss_sites
from .study import SprStudyBuilder, SprStudy


class HostExpPop:
    """Host exp-pop model with min_pop floor (core/pop_model.cpp:22-145)."""

    def __init__(self, t0, n0, g, min_pop):
        self.t0, self.n0, self.g, self.min_pop = (
            float(t0), float(n0), float(g), float(min_pop))

    def pop_at(self, t):
        return max(self.min_pop, self.n0 * math.exp((t - self.t0) * self.g))

    def pop_integral(self, a, b):
        g, n0, mp = self.g, self.n0, self.min_pop
        if mp == 0.0:
            if g == 0.0:
                return (b - a) * n0
            return n0 / g * math.exp(g * (a - self.t0)) * math.expm1(g * (b - a))
        if g == 0.0:
            return (b - a) * max(mp, n0)
        t_c = self.t0 + math.log(mp / n0) / g
        if g > 0.0:
            lo_c = min(max(t_c, a), b)
            unc = n0 / g * math.exp(g * (lo_c - self.t0)) * math.expm1(g * (b - lo_c))
            return (lo_c - a) * mp + unc
        lo_c = min(max(t_c, a), b)
        unc = n0 / g * math.exp(g * (a - self.t0)) * math.expm1(g * (lo_c - a))
        return unc + (b - lo_c) * mp


class HostSkygridPop:
    """Host skygrid model (staircase / log-linear; core/pop_model.cpp:147-560)."""

    def __init__(self, x, gamma, type_):
        self.x = np.asarray(x, dtype=np.float64)
        self.gamma = np.asarray(gamma, dtype=np.float64)
        self.type = int(type_)

    def log_N(self, t):
        x, g = self.x, self.gamma
        M = len(x) - 1
        k = int(np.searchsorted(x, t, side="left"))
        if k == 0:
            return g[0]
        if k > M:
            return g[M]
        if self.type == 1:  # staircase
            return g[k]
        c = (t - x[k - 1]) / (x[k] - x[k - 1])
        return (1 - c) * g[k - 1] + c * g[k]

    def pop_at(self, t):
        return math.exp(self.log_N(t))

    def pop_integral(self, a, b):
        # piecewise integration over intervals intersecting [a, b]
        x, g = self.x, self.gamma
        M = len(x) - 1
        edges = np.concatenate([[-np.inf], x, [np.inf]])
        total = 0.0
        for k in range(M + 2):
            lo = max(a, edges[k])
            hi = min(b, edges[k + 1])
            if hi <= lo:
                continue
            if k == 0:
                total += math.exp(g[0]) * (hi - lo)
            elif k == M + 1:
                total += math.exp(g[M]) * (hi - lo)
            elif self.type == 1:
                total += math.exp(g[k]) * (hi - lo)
            else:
                c_lo = (lo - x[k - 1]) / (x[k] - x[k - 1])
                c_hi = (hi - x[k - 1]) / (x[k] - x[k - 1])
                G_lo = (1 - c_lo) * g[k - 1] + c_lo * g[k]
                G_hi = (1 - c_hi) * g[k - 1] + c_hi * g[k]
                D = G_hi - G_lo
                if D == 0.0:
                    total += math.exp(G_lo) * (hi - lo)
                else:
                    total += math.exp(G_lo) * (hi - lo) * math.expm1(D) / D
        return total


class HostCoalGrid:
    """Host mirror of ops/coalescent.py over any host pop model."""

    def __init__(self, tree: FlatTree, pop, num_cells: int, t_max_tip: float):
        self.pop = pop
        t_root = float(tree.t[tree.root])
        span = max(t_max_tip - t_root, 1.0)
        self.t_lo = t_root - 0.35 * span - 1.0
        self.t_step = (t_max_tip - self.t_lo) / num_cells
        self.C = num_cells
        self.lbs = self.t_lo + self.t_step * np.arange(num_cells)
        is_tip = tree.children[:, 0] == NO_NODE
        self._is_tip = is_tip
        sign = np.where(is_tip, 1.0, -1.0)
        rel = (tree.t - self.t_lo) / self.t_step
        # O(N + C) scatter + exclusive suffix sum (ops/coalescent.calc_k_bar)
        cell = np.floor(rel).astype(np.int64)
        in_grid = (cell >= 0) & (cell < num_cells)
        cc = np.clip(cell, 0, num_cells - 1)
        k_frac = np.bincount(cc, weights=np.where(in_grid, sign * (rel - cell), 0.0),
                             minlength=num_cells)
        counts = np.bincount(cc, weights=np.where(in_grid, sign, 0.0),
                             minlength=num_cells)
        above = np.sum(np.where(cell >= num_cells, sign, 0.0))
        rev_cum = np.cumsum(counts[::-1])[::-1]
        self.k_bar = above + rev_cum - counts + k_frac
        self.popsize_bar = np.maximum(
            np.array([self.pop.pop_integral(lb, lb + self.t_step) for lb in self.lbs])
            / self.t_step, 1e-100)

    def log_prior(self, t: np.ndarray) -> float:
        """Full scalable-coalescent log prior from the current k_bar grid
        (scalable_coalescent.cpp:163-187; ops/coalescent.calc_log_prior)."""
        quad = -float(np.sum(self.t_step * self.k_bar * (self.k_bar - 1.0)
                             / (2.0 * self.popsize_bar)))
        logN = sum(math.log(self.pop.pop_at(float(ti)))
                   for ti, tip in zip(t, self._is_tip) if not tip)
        return quad - logN

    def _pop_at(self, t):
        return self.pop.pop_at(t)

    def displace_delta(self, old_t, new_t, is_tip: bool) -> float:
        sign = 1.0 if is_tip else -1.0
        frac_old = np.clip((old_t - self.lbs) / self.t_step, 0.0, 1.0)
        frac_new = np.clip((new_t - self.lbs) / self.t_step, 0.0, 1.0)
        dk = sign * (frac_new - frac_old)
        k = self.k_bar
        delta = -np.sum(self.t_step * ((k + dk) * (k + dk - 1.0) - k * (k - 1.0))
                        / (2.0 * self.popsize_bar))
        if not is_tip:
            delta -= math.log(self._pop_at(new_t)) - math.log(self._pop_at(old_t))
        return float(delta), dk

    def commit(self, dk):
        self.k_bar += dk


def _enumerate_straddling(tree: FlatTree, P: int, t: float, X: int, out: list):
    """Branches at/below P (excluding X's subtree) straddling time t
    (subrun.cpp:325-350)."""
    if P == X:
        return
    if t <= tree.t[P]:
        out.append(P)
    elif tree.children[P, 0] != NO_NODE:
        _enumerate_straddling(tree, int(tree.children[P, 0]), t, X, out)
        _enumerate_straddling(tree, int(tree.children[P, 1]), t, X, out)


class TopologyMixer:
    """Runs bursts of topology moves between jitted sweeps.

    Move mix per topology step: subtree-slide and SPR1 with equal weight
    (reference weights 1.0 / 1.0 of 32; subrun.cpp:108-117)."""

    def __init__(self, tree: FlatTree, rng: np.random.Generator,
                 num_cells: int = 400, can_change_root: bool = True):
        self.tree = tree
        self.rng = rng
        self.num_cells = num_cells
        self.can_change_root = can_change_root
        self.n_accepted = 0
        self.n_proposed = 0
        # accumulated ledger deltas of accepted moves (host->device handoff)
        self.delta_log_G = 0.0
        self.delta_log_coal = 0.0

    def run_burst(self, n_moves: int, mu, nu, q, pi, pop_params, t_max_tip: float,
                  coal=None, part=None, q_tab=None):
        tree = self.tree
        ctx = SprContext(tree, mu, nu, q, pi,
                         can_change_root=self.can_change_root,
                         part=part, q_tab=q_tab)
        if coal is not None:
            grid = coal
        else:
            if hasattr(pop_params, "pop_integral"):
                host_pop = pop_params
            else:
                host_pop = HostExpPop(pop_params.t0, pop_params.n0, pop_params.g,
                                      pop_params.min_pop)
            grid = HostCoalGrid(tree, host_pop, self.num_cells, t_max_tip)
        self.t_max_tip = t_max_tip
        for _ in range(n_moves):
            self.n_proposed += 1
            if self.rng.random() < 0.5:
                self._subtree_slide(ctx, grid)
            else:
                self._spr1(ctx, grid)
        return tree

    # -- core accept/reject wrapper (subrun.cpp spr_move_core, 683-742) -----

    def _spr_move_core(self, ctx: SprContext, grid: HostCoalGrid, X: int,
                       SS: int, new_t_P: float, alpha_ratio: float):
        tree = self.tree
        if X == tree.root:
            return
        t_X = float(tree.t[X])
        P = int(tree.parent[X])
        if not self.can_change_root and (P == tree.root or SS == tree.root):
            # this move could change the part root (subrun.cpp:690-695)
            return
        old_t_P = float(tree.t[P])
        old_S = _sibling(tree, P, X)
        G = int(tree.parent[P])
        if (new_t_P == t_X or new_t_P == tree.t[SS]
                or (P != tree.root and new_t_P == tree.t[G])):
            return

        ctx.begin_move()
        old_graft = ctx.analyze_graft(X)
        ctx.peel_graft(old_graft)
        ctx.move(X, SS, new_t_P)
        new_graft = ctx.propose_new_graft(X, self.rng)

        delta_coal, dk = grid.displace_delta(old_t_P, new_t_P, is_tip=False)
        log_mh = ((new_graft.delta_log_G - new_graft.log_alpha_mut)
                  - (old_graft.delta_log_G - old_graft.log_alpha_mut)
                  + math.log(alpha_ratio) + delta_coal)
        if log_mh >= 0.0 or self.rng.random() < math.exp(min(log_mh, 0.0)):
            ctx.apply_graft(new_graft)
            grid.commit(dk)
            self.n_accepted += 1
            self.delta_log_G += new_graft.delta_log_G - old_graft.delta_log_G
            self.delta_log_coal += delta_coal
        else:
            ctx.move(X, old_S, old_t_P)
            ctx.apply_graft(old_graft)

    # -- subtree slide (subrun.cpp:352-448) ---------------------------------

    def _subtree_slide(self, ctx: SprContext, grid: HostCoalGrid):
        tree = self.tree
        rng = self.rng
        N = tree.num_nodes
        X = int(rng.integers(0, N))
        if X == tree.root:
            return
        P = int(tree.parent[X])
        S = _sibling(tree, P, X)

        t_early = (min(float(tree.t[X]), float(tree.t[S])) if P == tree.root
                   else float(tree.t[tree.root]))
        tree_span = max(self.t_max_tip - t_early, 0.0)
        lam_X = ctx.lambda_at(X)
        if lam_X <= 0.0:
            return
        delta_scale = min(0.5 / lam_X, tree_span)
        delta_t = rng.normal(0.0, delta_scale)
        old_P_t = float(tree.t[P])
        new_P_t = old_P_t + delta_t

        if delta_t < 0.0:
            if P != tree.root and new_P_t < tree.t[int(tree.parent[P])]:
                GG = int(tree.parent[P])
                SS = P
                while GG != NO_NODE and new_P_t < tree.t[GG]:
                    SS = GG
                    GG = int(tree.parent[GG])
                branches: list = []
                _enumerate_straddling(tree, SS, old_P_t, X, branches)
                alpha_ratio = (1.0 / len(branches)) / 1.0
                self._spr_move_core(ctx, grid, X, SS, new_P_t, alpha_ratio)
            else:
                self._spr_move_core(ctx, grid, X, S, new_P_t, 1.0)
        else:
            if new_P_t > tree.t[X]:
                return
            if new_P_t > tree.t[S]:
                branches = []
                _enumerate_straddling(tree, P, new_P_t, X, branches)
                if not branches:
                    return
                SS = branches[int(rng.integers(0, len(branches)))]
                alpha_ratio = 1.0 / (1.0 / len(branches))
                self._spr_move_core(ctx, grid, X, SS, new_P_t, alpha_ratio)
            else:
                self._spr_move_core(ctx, grid, X, S, new_P_t, 1.0)

    # -- wilson-balding (subrun.cpp:450-490; unused by default, like ref) ---

    def _wilson_balding(self, ctx: SprContext, grid: HostCoalGrid):
        tree = self.tree
        rng = self.rng
        N = tree.num_nodes
        X = int(rng.integers(0, N))
        if X == tree.root:
            return
        P = int(tree.parent[X])
        SS = int(rng.integers(0, N))
        GG = int(tree.parent[SS]) if SS != tree.root else NO_NODE
        tries = 0
        while ((GG != NO_NODE and tree.t[GG] >= tree.t[X]) or X == SS):
            SS = int(rng.integers(0, N))
            GG = int(tree.parent[SS]) if SS != tree.root else NO_NODE
            tries += 1
            if tries > 10 * N:
                return
        if SS == tree.root or P == tree.root:
            return
        if GG == P or SS == P or GG == X:
            return
        S = _sibling(tree, P, X)
        G = int(tree.parent[P])
        new_max_age = min(float(tree.t[X]), float(tree.t[SS]))
        new_range = new_max_age - float(tree.t[GG])
        new_t_P = rng.uniform(new_max_age - new_range, new_max_age)
        old_max_age = min(float(tree.t[X]), float(tree.t[S]))
        old_range = old_max_age - float(tree.t[G])
        if old_range <= 0 or new_range <= 0:
            return
        self._spr_move_core(ctx, grid, X, SS, new_t_P, new_range / old_range)

    # -- SPR1 with likelihood-informed study (subrun.cpp:492-675) -----------

    def _spr1(self, ctx: SprContext, grid: HostCoalGrid):
        tree = self.tree
        rng = self.rng
        N = tree.num_nodes
        limit = 2 ** 31 if rng.random() < 0.01 else 1
        annealing_factor = 0.8

        X = int(rng.integers(0, N))
        if X == tree.root:
            return
        if int(tree.parent[X]) == tree.root and not self.can_change_root:
            # pruning would change the part root (subrun.cpp:527-530)
            return
        lam_X = ctx.lambda_at(X)
        if lam_X == 0.0:
            return
        t_X = float(tree.t[X])
        P = int(tree.parent[X])
        old_t_P = float(tree.t[P])
        old_S = _sibling(tree, P, X)

        ctx.begin_move()
        old_graft = ctx.analyze_graft(X)
        ctx.peel_graft(old_graft)

        old_deltas_P_to_X = self._summarize_closed(ctx, old_graft)
        missing_at_X = set()
        cur = X
        while cur != NO_NODE:
            missing_at_X |= _miss_sites(tree, cur)
            cur = int(tree.parent[cur])

        pre_builder = SprStudyBuilder(tree, X, t_X, missing_at_X,
                                      max_muts_from_start=limit)
        pre_builder.seed_fill_from(old_S, 0, old_deltas_P_to_X,
                                   self.can_change_root)
        pre_study = SprStudy(pre_builder, lam_X, annealing_factor, t_X,
                             self.t_max_tip)

        new_region = pre_study.pick_nexus_region(rng)
        new_S = pre_study.regions[new_region].branch
        new_t_P = pre_study.pick_time_in_region(new_region, rng)
        log_alpha_old_to_new = pre_study.log_alpha_in_region(new_region, new_t_P)

        t_new_S = float(tree.t[new_S])
        new_G = int(tree.parent[new_S]) if new_S != tree.root else NO_NODE
        if new_G == P:
            new_G = int(tree.parent[P])
        t_new_G = float(tree.t[new_G]) if new_G != NO_NODE else -1e308
        if new_t_P == t_X or new_t_P == t_new_S or new_t_P == t_new_G:
            ctx.apply_graft(old_graft)
            return

        ctx.move(X, new_S, new_t_P)
        new_graft = ctx.propose_new_graft(X, rng)

        new_deltas_P_to_X = self._summarize_closed(ctx, new_graft)
        post_builder = SprStudyBuilder(tree, X, t_X, missing_at_X,
                                       max_muts_from_start=limit)
        post_builder.seed_fill_from(new_S, 0, new_deltas_P_to_X,
                                     self.can_change_root)
        post_study = SprStudy(post_builder, lam_X, annealing_factor, t_X,
                              self.t_max_tip)
        old_region = post_study.find_region(old_S, old_t_P)
        if old_region == -1:
            # reverse proposal can't produce the old state -> reject
            ctx.move(X, old_S, old_t_P)
            ctx.apply_graft(old_graft)
            return
        log_alpha_new_to_old = post_study.log_alpha_in_region(old_region, old_t_P)

        delta_coal, dk = grid.displace_delta(old_t_P, new_t_P, is_tip=False)
        log_mh = ((new_graft.delta_log_G - new_graft.log_alpha_mut)
                  - (old_graft.delta_log_G - old_graft.log_alpha_mut)
                  + log_alpha_new_to_old - log_alpha_old_to_new
                  + delta_coal)
        if log_mh >= 0.0 or rng.random() < math.exp(min(log_mh, 0.0)):
            ctx.apply_graft(new_graft)
            grid.commit(dk)
            self.n_accepted += 1
            self.delta_log_G += new_graft.delta_log_G - old_graft.delta_log_G
            self.delta_log_coal += delta_coal
        else:
            ctx.move(X, old_S, old_t_P)
            ctx.apply_graft(old_graft)

    @staticmethod
    def _summarize_closed(ctx: SprContext, graft) -> dict:
        """summarize_closed_mutations (spr_move.cpp:82-89, 652-658)."""
        out: dict = {}
        for bi in graft.branch_infos:
            if not bi.is_open:
                out.update(bi.hot_deltas_to_X)
        return out
