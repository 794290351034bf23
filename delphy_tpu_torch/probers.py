"""Tree probers: coalescence probabilities of a probe lineage.

Reference: core/tree_prober.h (cell recursion p_ub = p_coal*frac +
(1-p_coal)*p_lb), core/ancestral_tree_prober.cpp (categories = closest marked
ancestor), core/site_states_tree_prober.cpp (categories = site state, with
trapezoid weighting across the mutation's branch).  Used by the web UI for
ancestry / per-site state distributions over time (core/api.h:25-44)."""

from __future__ import annotations

import math

import numpy as np

from .phylo import FlatTree, NO_NODE


def _add_boxcar(t_start: float, t_step: float,
                row: np.ndarray, a: float, b: float, h: float):
    """Add h over [a, b) to a staircase (core/staircase.h add_boxcar)."""
    C = len(row)
    rel_a = (a - t_start) / t_step
    rel_b = (b - t_start) / t_step
    for c in range(max(0, int(math.floor(rel_a))), min(C, int(math.ceil(rel_b)))):
        lo = max(rel_a, c)
        hi = min(rel_b, c + 1)
        if hi > lo:
            row[c] += h * (hi - lo)


def _add_trapezoid(t_start: float, t_step: float, row: np.ndarray,
                   a: float, b: float, h_a: float, h_b: float):
    """Add a linear ramp from h_a at a to h_b at b (staircase.h add_trapezoid),
    cell-averaged."""
    if b <= a:
        return
    C = len(row)
    rel_a = (a - t_start) / t_step
    rel_b = (b - t_start) / t_step
    for c in range(max(0, int(math.floor(rel_a))), min(C, int(math.ceil(rel_b)))):
        lo = max(rel_a, c)
        hi = min(rel_b, c + 1)
        if hi > lo:
            mid = 0.5 * (lo + hi)
            frac = (mid - rel_a) / (rel_b - rel_a)
            row[c] += (h_a + (h_b - h_a) * frac) * (hi - lo)


def tree_prober(branch_counts: np.ndarray, cells_to_skip: int, pop_params,
                t_start: float, t_step: float, p_initial: np.ndarray) -> np.ndarray:
    """p[cat, cell]: probability a probe sampled at the cell's upper bound has
    already coalesced into a category-cat branch (tree_prober.h:56-95).
    ``pop_params`` has host leaves (``Run.host_view().pop``)."""
    from . import pop as popm
    K, C = branch_counts.shape
    out = np.zeros((K, C - cells_to_skip))
    p_before = np.array(p_initial, dtype=np.float64)
    for c in range(C):
        a = t_start + c * t_step
        b = a + t_step
        intensity = float(popm.host_eval(popm.intensity_integral, pop_params,
                                         a, b))
        total = float(branch_counts[:, c].sum())
        p_coal = 1.0 - math.exp(-total * intensity)
        if total == 0.0:
            frac = np.zeros(K)
        else:
            frac = branch_counts[:, c] / total
        p_ub = p_coal * frac + (1.0 - p_coal) * p_before
        if c >= cells_to_skip:
            out[:, c - cells_to_skip] = p_ub
        p_before = p_ub
    return out


def _extend_past_root(tree: FlatTree, t_start: float, t_end: float,
                      num_t_cells: int):
    cell = (t_end - t_start) / num_t_cells
    real_start, skip = t_start, 0
    t_root = float(tree.t[tree.root])
    while real_start > t_root:
        real_start -= cell
        num_t_cells += 1
        skip += 1
    return real_start, cell, num_t_cells, skip


def probe_ancestors_on_tree(tree: FlatTree, pop_params, marked_ancestors,
                            t_start: float, t_end: float, num_t_cells: int):
    """p[k, cell] that a probe's lineage passes through marked ancestor k
    (k = len(marked) -> "none of them"); ancestral_tree_prober.cpp:29-77."""
    k = len(marked_ancestors)
    real_start, cell, C, skip = _extend_past_root(tree, t_start, t_end, num_t_cells)
    counts = np.zeros((k + 1, C))
    mark_of = {int(n): i for i, n in enumerate(marked_ancestors) if n != NO_NODE}

    stack = [(int(tree.root), k)]
    while stack:
        node, cma = stack.pop()
        if node != tree.root and cma >= 0:
            _add_boxcar(real_start, cell, counts[cma],
                        float(tree.t[int(tree.parent[node])]), float(tree.t[node]), 1.0)
        if node in mark_of:
            cma = mark_of[node]
        if not tree.is_tip(node):
            stack.append((int(tree.children[node, 0]), cma))
            stack.append((int(tree.children[node, 1]), cma))

    p_init = np.zeros(k + 1)
    p_init[k] = 1.0
    return tree_prober(counts, skip, pop_params, real_start, cell, p_init)


def probe_site_states_on_tree(tree: FlatTree, pop_params, site: int,
                              t_start: float, t_end: float, num_t_cells: int):
    """p[state, cell] that a probe's lineage carries each state at `site`
    (site_states_tree_prober.cpp)."""
    real_start, cell, C, skip = _extend_past_root(tree, t_start, t_end, num_t_cells)
    counts = np.zeros((4, C))
    root_state = int(tree.sequence_at(tree.root)[site])

    stack = [(int(tree.root), root_state)]
    while stack:
        node, state = stack.pop()
        if node != tree.root:
            p = int(tree.parent[node])
            t_p, t_n = float(tree.t[p]), float(tree.t[node])
            muts = [m for m in tree.mutations[node] if m.site == site]
            if muts:
                m = muts[0]
                _add_trapezoid(real_start, cell, counts[state], t_p, t_n, 1.0, 0.0)
                state = muts[-1].to
                _add_trapezoid(real_start, cell, counts[state], t_p, t_n, 0.0, 1.0)
            else:
                _add_boxcar(real_start, cell, counts[state], t_p, t_n, 1.0)
        if not tree.is_tip(node):
            stack.append((int(tree.children[node, 0]), state))
            stack.append((int(tree.children[node, 1]), state))

    p_init = np.zeros(4)
    p_init[root_state] = 1.0
    return tree_prober(counts, skip, pop_params, real_start, cell, p_init)
