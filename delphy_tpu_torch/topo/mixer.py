"""Host coalescent-prior helpers of the topology phase: the exp-pop model
with min_pop floor, the skygrid model and a host copy of the cell grid
(core/pop_model.cpp, core/scalable_coalescent.cpp).  The topology moves themselves run in the
native kernel (``native/``); the reference package's pure-Python mixer is not
part of the port."""

from __future__ import annotations

import math

import numpy as np

from ..phylo import FlatTree, NO_NODE


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
