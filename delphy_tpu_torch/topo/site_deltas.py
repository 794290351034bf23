"""Site-delta composition algebra on plain dicts.

Reference: core/site_deltas.{h,cpp} — a map site -> (from, to) describing the
sequence difference between two tree points, composable from either end."""

from __future__ import annotations

from ..phylo import FlatTree, NO_NODE


def push_back(deltas: dict, site: int, frm: int, to: int):
    """Append a mutation at the END of the path (site_deltas.h:42-80)."""
    if site in deltas:
        f0, t0 = deltas[site]
        assert t0 == frm, f"delta chain broken at site {site}: {t0} != {frm}"
        if f0 == to:
            del deltas[site]
        else:
            deltas[site] = (f0, to)
    else:
        if frm != to:
            deltas[site] = (frm, to)


def push_front(deltas: dict, site: int, frm: int, to: int):
    """Prepend a mutation at the START of the path (site_deltas.h:82-128)."""
    if site in deltas:
        f0, t0 = deltas[site]
        assert f0 == to, f"delta chain broken at site {site}: {f0} != {to}"
        if frm == t0:
            del deltas[site]
        else:
            deltas[site] = (frm, t0)
    else:
        if frm != to:
            deltas[site] = (frm, to)


def compose(d1: dict, d2: dict) -> dict:
    """Deltas of path1 followed by path2."""
    out = dict(d1)
    for site, (f2, t2) in d2.items():
        push_back(out, site, f2, t2)
    return out


def inverse(d: dict) -> dict:
    return {site: (t, f) for site, (f, t) in d.items()}


def state_at(tree: FlatTree, branch: int, t: float, site: int) -> int:
    """State of `site` at point (branch, t) — first mutation at the site at or
    above the point wins (reference calc_site_state_at,
    phylo_tree_calc.cpp:108-118)."""
    cur = branch
    first = True
    while cur != NO_NODE:
        for m in reversed(tree.mutations[cur]):
            if first and m.t > t:
                continue
            if m.site == site:
                return m.to
        first = False
        cur = int(tree.parent[cur])
    return int(tree.ref_seq[site])


def deltas_between(tree: FlatTree, loc_a, loc_b) -> dict:
    """Site deltas between two tree points (branch, t) — composition through
    the root (reference calc_site_deltas_between, site_deltas.h:156)."""
    (ba, ta), (bb, tb) = loc_a, loc_b
    out: dict = {}
    # a -> root: push inverse mutations (walking up = inverting path root->a)
    cur = ba
    first = True
    while cur != NO_NODE:
        for m in reversed(tree.mutations[cur]):
            if first and m.t > ta:
                continue
            push_back(out, m.site, m.to, m.from_)
        first = False
        cur = int(tree.parent[cur])
    # root -> b: push forward mutations from the top down
    path = []
    cur = bb
    while cur != NO_NODE:
        path.append(cur)
        cur = int(tree.parent[cur])
    for i, cur in enumerate(reversed(path)):
        last = (i == len(path) - 1)
        for m in tree.mutations[cur]:
            if last and m.t > tb:
                break
            push_back(out, m.site, m.from_, m.to)
    return out
