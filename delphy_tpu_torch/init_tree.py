"""Initial-tree pipeline: parsimony factoring + OLS root-to-tip rooting.

The TPU-era counterpart of the reference's utree pipeline
(core/utree.h:235-317 build_initial_phylo_tree): build a guide topology by
greedy insertion, factor the tip differences into internal branch mutations
by Fitch parsimony, choose the root by scanning edge midpoints for the
best root-to-tip date-regression R^2 (which also yields estimates of the
clock rate and t_MRCA), and time internal nodes from that regression.

Everything here runs on light host structures (adjacency lists + per-site
state tables); the FlatTree is emitted once at the end.
"""

from __future__ import annotations

import numpy as np

from .phylo import FlatTree, Mutation, NO_NODE, fix_up_missations

ROOT_DELTA_T = -1.0e30

_FULL = 0b1111


def _fitch_states(T, N, root, children_ro, post, tip_state, tip_missing):
    """Per-site Fitch parsimony on the rooted guide tree.

    tip_state[i]: state of tip i at this site (or -1 if missing);
    returns state[n] for every node (int array length N)."""
    mask = np.zeros(N, dtype=np.uint8)
    for i in range(T):
        mask[i] = _FULL if tip_missing[i] else (1 << tip_state[i])
    for n in post:  # post-order: children before parents
        c0, c1 = children_ro[n]
        if c0 == NO_NODE:
            continue
        inter = mask[c0] & mask[c1]
        mask[n] = inter if inter else (mask[c0] | mask[c1])
    state = np.zeros(N, dtype=np.int8)
    # top-down: parent's state if compatible, else lowest bit
    for n in post[::-1]:  # pre-order
        c0, c1 = children_ro[n]
        if n == root:
            m = int(mask[n])
            state[n] = (m & -m).bit_length() - 1
        if c0 == NO_NODE:
            continue
        for c in (c0, c1):
            if int(mask[c]) & (1 << int(state[n])):
                state[c] = state[n]
            else:
                m = int(mask[c])
                state[c] = (m & -m).bit_length() - 1
    return state


def gls_regression_root(edges, adj, N: int, T: int, dates: np.ndarray,
                        rng: np.random.Generator, exclude_node: int):
    """GLS root-to-tip regression rooting over an unrooted mutation-annotated
    edge graph (reference: utree.cpp:1466-1760 gls_regression_root_utree).

    Unlike OLS, tips are weighted by the phylogenetic covariance of their
    root-to-tip distances: sharing a branch of z mutations adds variance
    sigma^2 = z + epsilon to all tips below it, folded in via Sherman-Morrison
    rank-1 updates on six sufficient statistics per directed arc
    (1/dt/m inner products under the precision matrix W).

    Returns (edge_id, k, lambda_muts_per_day, t_mrca) where k is the number
    of the edge's mutations on the edge's `a`-endpoint side of the new root,
    or None when the regression is inapplicable (<=2 tips, no date variance)
    and the caller should fall back (the reference falls back to midpoint).
    """
    if T <= 2:
        return None
    dates = np.asarray(dates, dtype=np.float64)
    mean_t = dates.mean()
    var_t = dates.var()
    if var_t <= 0.0:
        return None
    dt = dates - mean_t
    total_deltas = sum(len(d) for (_, _, d) in edges)
    eps = 0.05 * total_deltas / T

    # stats vector: [1W1, dtW1, mW1, dtWdt, mWdt, mWm]; 1W1 == -1 flags an
    # unshifted tip (its centered date stashed in dtW1)
    def tip_stats(i):
        return np.array([-1.0, dt[i], 0.0, 0.0, 0.0, 0.0])

    def shift(s, z):
        zd = float(z)
        sig = zd + eps
        a11, adt1, am1, adtdt, amdt, amm = s
        if a11 >= 0.0:
            g = 1.0 / (1.0 + sig * a11)
            sm1 = am1 + zd * a11
            return np.array([
                a11 * g,
                adt1 * g,
                sm1 * g,
                adtdt - sig * adt1 * adt1 * g,
                (amdt + zd * adt1) - sig * adt1 * sm1 * g,
                (amm + 2.0 * zd * am1 + zd * zd * a11) - sig * sm1 * sm1 * g,
            ])
        dt_x = adt1
        inv = 1.0 / sig
        return np.array([inv, dt_x * inv, zd * inv, dt_x * dt_x * inv,
                         zd * dt_x * inv, zd * zd * inv])

    E = len(edges)
    # gstats[2e] = Sub(a->b) measured from b; gstats[2e+1] = Sub(b->a) from a
    gstats = [None] * (2 * E)

    # orient the unrooted graph at tip 0 (excluding the suppressed guide root)
    up_edge = np.full(N, -1, dtype=np.int64)
    order = []
    seen = np.zeros(N, dtype=bool)
    seen[0] = True
    if 0 <= exclude_node < N:
        seen[exclude_node] = True
    stack = [0]
    while stack:
        u = stack.pop()
        order.append(u)
        for (v, eid) in adj[u]:
            if not seen[v]:
                seen[v] = True
                up_edge[v] = eid
                stack.append(v)

    def arc_into(eid, node):
        """gstats index for the arc whose Sub is measured from `node`."""
        a, b, _ = edges[eid]
        return 2 * eid if node == b else 2 * eid + 1

    # pass 1 (post-order): subtree stats measured from each node
    for u in order[::-1]:
        if up_edge[u] < 0:
            continue
        if u < T:
            gstats[arc_into(up_edge[u], u)] = tip_stats(u)
        else:
            acc = np.zeros(6)
            for (v, eid) in adj[u]:
                if eid == up_edge[u]:
                    continue
                acc = acc + shift(gstats[arc_into(eid, v)],
                                  len(edges[eid][2]))
            gstats[arc_into(up_edge[u], u)] = acc
    # pass 2 (pre-order): outside-subtree stats, measured from the parent
    for p in order:
        for (x, eid) in adj[p]:
            if eid == up_edge[p] or up_edge[x] != eid:
                continue
            if p < T:
                gstats[arc_into(eid, p)] = tip_stats(p)
            else:
                acc = np.zeros(6)
                for (y, eid2) in adj[p]:
                    if eid2 == eid:
                        continue
                    acc = acc + shift(gstats[arc_into(eid2, y)],
                                      len(edges[eid2][2]))
                gstats[arc_into(eid, p)] = acc

    # pass 3: minimize chi^2 over (edge, split position)
    best = None  # (chi2, candidates)
    best_chi2 = np.inf
    cands = []
    for eid, (a, b, d) in enumerate(edges):
        sa = gstats[2 * eid + 1]  # a's side, measured from a
        sb = gstats[2 * eid]      # b's side, measured from b
        if sa is None or sb is None:
            continue
        D = len(d)
        for k in range(D + 1):
            s = shift(sa, k) + shift(sb, D - k)
            a11, adt1, am1, adtdt, amdt, amm = s
            den = adtdt * a11 - adt1 * adt1
            if den <= 0.0:
                continue
            alpha = (amdt * a11 - am1 * adt1) / den
            if alpha <= 0.0:
                continue
            beta = (am1 - alpha * adt1) / a11
            chi2 = amm - alpha * amdt - beta * am1
            if chi2 < best_chi2 - 1e-12:
                best_chi2 = chi2
                cands = [(eid, k, alpha, beta)]
            elif chi2 <= best_chi2 + 1e-12:
                cands.append((eid, k, alpha, beta))
    if not cands:
        return None
    eid, k, alpha, beta = cands[rng.integers(len(cands))]
    t_mrca = mean_t - beta / alpha
    return eid, k, alpha, t_mrca


def build_initial_tree(ref_seq: np.ndarray, tip_deltas: list,
                       tip_miss_intervals: list, tip_dates: list,
                       names: list | None = None,
                       rng: np.random.Generator | None = None,
                       native: bool | None = None,
                       rooting: str | None = None) -> FlatTree:
    """Guide topology -> refinement -> OLS/GLS rooting -> timed FlatTree.

    Two engines produce the rooted mutation-annotated topology:
    - the native C++ pipeline (native/init_native.cpp): guide tree by
      best-first parsimony placement, nearest-first rebuild, SPR refinement,
      O(N) rerooting DP — the scalable default (reference utree.h:235-317);
    - the Python fallback below: O(T^2) greedy guide + Fitch factoring.

    rooting: "ols" (default; what the reference's production pipeline uses,
    utree.cpp:1921) or "gls" (covariance-weighted regression rooting,
    utree.cpp:1466-1760; Python path only).
    """
    import os
    from .phylo import build_greedy_tree

    rng = rng or np.random.default_rng(0)
    T = len(tip_deltas)
    if rooting is None:
        rooting = os.environ.get("DELPHY_TPU_INIT_ROOTING", "ols")
    if rooting == "gls" and native is None:
        native = False  # GLS rooting lives in the Python pipeline
    if native is None:
        native = T >= 12 or os.environ.get("DELPHY_TPU_NATIVE_INIT") == "1"
    if native and T >= 4:
        out = _build_initial_tree_native(
            np.asarray(ref_seq, dtype=np.int8), tip_deltas,
            tip_miss_intervals, tip_dates, names, rng)
        if out is not None:
            return out
    ref_seq = np.asarray(ref_seq, dtype=np.int8)
    T = len(tip_deltas)
    L = len(ref_seq)
    if T < 3:
        return build_greedy_tree(ref_seq, tip_deltas, tip_miss_intervals,
                                 tip_dates, names=names, rng=rng)

    # ---- phase 1: guide topology (greedy nearest-neighbour insertion) -----
    guide = build_greedy_tree(ref_seq, tip_deltas, tip_miss_intervals,
                              tip_dates, names=names, rng=rng)
    N = guide.num_nodes
    R = guide.root
    post = guide.post_order()
    children_ro = np.asarray(guide.children)

    # ---- phase 2: Fitch parsimony over the variable sites -----------------
    site_to_tips: dict = {}
    for i, dl in enumerate(tip_deltas):
        for (l, to) in dl:
            site_to_tips.setdefault(int(l), []).append((i, int(to)))
    var_sites = sorted(site_to_tips)

    # which tips are missing at each variable site (interval stabbing)
    miss_at = {l: set() for l in var_sites}
    vs = np.array(var_sites, dtype=np.int64)
    for i, ivs in enumerate(tip_miss_intervals):
        for (s, e) in ivs:
            lo = np.searchsorted(vs, s, side="left")
            hi = np.searchsorted(vs, e, side="left")
            for k in range(lo, hi):
                miss_at[int(vs[k])].add(i)

    V = len(var_sites)
    S = np.zeros((V, N), dtype=np.int8)   # Fitch state of node n at var site k
    tip_state = np.empty(T, dtype=np.int64)
    tip_missing = np.zeros(T, dtype=bool)
    for k, l in enumerate(var_sites):
        tip_state[:] = ref_seq[l]
        for (i, to) in site_to_tips[l]:
            tip_state[i] = to
        tip_missing[:] = False
        for i in miss_at[l]:
            tip_missing[i] = True
        S[k] = _fitch_states(T, N, R, children_ro, post,
                             tip_state, tip_missing)
    site_idx = {l: k for k, l in enumerate(var_sites)}

    def state_of(node, l):
        return int(S[site_idx[l], node])

    # ---- unrooted edge list (suppress the guide root, degree 2) -----------
    parent_ro = np.asarray(guide.parent)
    edges = []        # (a, b, [sites]) with sites where Fitch states differ
    adj = [[] for _ in range(N)]

    vs_arr = np.array(var_sites, dtype=np.int64)

    def add_edge(a, b):
        diff = [int(l) for l in vs_arr[np.nonzero(S[:, a] != S[:, b])[0]]]
        eid = len(edges)
        edges.append((a, b, diff))
        adj[a].append((b, eid))
        adj[b].append((a, eid))

    for n in range(N):
        p = int(parent_ro[n])
        if p == NO_NODE or p == R:
            continue
        add_edge(n, p)
    rc0, rc1 = (int(x) for x in children_ro[R])
    add_edge(rc0, rc1)   # suppressed-root bridge

    # ---- phase 3: root-to-tip date regression over edge positions ---------
    # OLS (default): maximize R^2 over edge midpoints (utree.h:289-306);
    # GLS: minimize covariance-weighted chi^2 over per-mutation positions
    # (utree.cpp:1466-1760).  The slope estimates the clock rate, the
    # intercept t_MRCA.
    w = np.array([len(d) for (_, _, d) in edges], dtype=np.float64)

    # mutation distance from every node to every tip: one DFS per tip
    dist = np.zeros((N, T), dtype=np.float64)
    for i in range(T):
        d = dist[:, i]
        seen = np.zeros(N, dtype=bool)
        stack = [(i, 0.0)]
        seen[i] = True
        while stack:
            u, du = stack.pop()
            d[u] = du
            for (v, eid) in adj[u]:
                if not seen[v] and v != R:
                    seen[v] = True
                    stack.append((v, du + w[eid]))

    dates = np.array([guide.t[i] for i in range(T)], dtype=np.float64)
    gls_split = None
    if rooting == "gls":
        g = gls_regression_root(edges, adj, N, T, dates, rng, R)
        if g is not None:
            root_eid, gls_split, slope, t_mrca = g
            slope = max(slope, 1.0 / 26.0)
    if gls_split is None:  # "ols", or GLS inapplicable (reference falls back)
        t_var = dates.var()
        best = None  # (r2, eid, slope, intercept)
        for eid, (a, b, _) in enumerate(edges):
            d_mid = np.minimum(dist[a], dist[b]) + 0.5 * w[eid]
            dv = d_mid.var()
            cov = np.mean((d_mid - d_mid.mean()) * (dates - dates.mean()))
            if dv <= 0 or t_var <= 0:
                r2, slope = -1.0, 0.0
            else:
                slope = cov / t_var           # muts per day
                r2 = cov * cov / (dv * t_var)
                if slope <= 0:
                    r2 = -r2                  # prefer positive-clock rootings
            if best is None or r2 > best[0]:
                icept = d_mid.mean() - slope * dates.mean()
                best = (r2, eid, slope, icept)
        _, root_eid, slope, icept = best
        slope = max(slope, 1.0 / 26.0)    # floor ~ 13 days/mutation heuristic
        # t where expected root-to-tip distance hits 0 => t_MRCA estimate
        t_mrca = -icept / slope

    # ---- phase 4: orient at the chosen edge and emit the FlatTree ---------
    ra, rb, rdiff = edges[root_eid]
    parent = np.full(N, NO_NODE, dtype=np.int32)
    children = np.full((N, 2), NO_NODE, dtype=np.int32)
    parent[ra] = parent[rb] = R
    children[R] = (min(ra, rb), max(ra, rb))
    depth = np.zeros(N, dtype=np.float64)  # mutation distance from root
    order = [R]
    mut_sites = [[] for _ in range(N)]     # sites mutating on branch above n
    # split the root edge's mutations between its two half-branches; the GLS
    # rooting prescribes the split position k (utree.cpp:1691-1696), OLS
    # splits randomly
    if gls_split is not None:
        mut_sites[ra] = list(rdiff[:gls_split])
        mut_sites[rb] = list(rdiff[gls_split:])
    else:
        for l in rdiff:
            (mut_sites[ra] if rng.random() < 0.5 else mut_sites[rb]).append(l)
    depth[ra] = len(mut_sites[ra])
    depth[rb] = len(mut_sites[rb])
    stack = [ra, rb]
    order += [ra, rb]
    seen = np.zeros(N, dtype=bool)
    seen[[R, ra, rb]] = True
    while stack:
        u = stack.pop()
        for (v, eid) in adj[u]:
            if eid == root_eid or v == R or seen[v]:
                continue
            seen[v] = True
            parent[v] = u
            a, b = children[u]
            children[u] = ((v, b) if a == NO_NODE else
                           (min(a, v), max(a, v)))
            mut_sites[v] = edges[eid][2]
            depth[v] = depth[u] + len(mut_sites[v])
            stack.append(v)
            order.append(v)
    for u in range(N):
        if u != R and not guide.is_tip(u):
            a, b = children[u]
            assert a != NO_NODE and b != NO_NODE, "orientation failed"

    # root sequence state (Fitch) anchored at R's side of the root edge
    ra_half = set(mut_sites[ra])
    root_state = {}
    for l in var_sites:
        # sites mutating on the R->ra half-branch: the root carries rb's
        # state; everywhere else the root state equals ra's side
        s = state_of(rb, l) if l in ra_half else state_of(ra, l)
        if s != int(ref_seq[l]):
            root_state[l] = s

    # times: regression positions for inner nodes, then monotonic clamping
    t = np.zeros(N, dtype=np.float64)
    t_min = np.full(N, -np.inf)
    t_max = np.full(N, np.inf)
    for i in range(T):
        lo, hi = tip_dates[i]
        t_min[i], t_max[i] = lo, hi
        t[i] = float(guide.t[i])
    for n in order:
        if not guide.is_tip(n):
            t[n] = t_mrca + depth[n] / slope
    # clamp in reversed pre-order of the NEW orientation: every node is
    # visited after all its descendants, so one pass suffices
    for n in order[::-1]:
        p = int(parent[n])
        if p != NO_NODE and t[p] >= t[n]:
            t[p] = t[n] - rng.uniform(0.5, 1.5)

    mutations = [[] for _ in range(N)]
    miss_intervals = [[] for _ in range(N)]
    miss_from_states = [{} for _ in range(N)]
    for n in range(N):
        if n == R:
            mutations[n] = [Mutation(site=l, from_=int(ref_seq[l]), to=s,
                                     t=ROOT_DELTA_T)
                            for l, s in sorted(root_state.items())]
            continue
        p = int(parent[n])
        branch = []
        for l in mut_sites[n]:
            # from/to resolved from the oriented Fitch states
            if p == R:
                frm = root_state.get(l, int(ref_seq[l]))
            else:
                frm = state_of(p, l)
            to = state_of(n, l)
            if frm == to:
                continue
            branch.append(Mutation(site=l, from_=frm, to=to,
                                   t=float(rng.uniform(t[p], t[n]))))
        branch.sort(key=lambda m: m.key())
        mutations[n] = branch
    for i in range(T):
        miss_intervals[i] = sorted(tip_miss_intervals[i])

    # missation from-states: with Fitch-factored internal mutations the state
    # just above a missing tip need not be the reference state any more (the
    # old all-on-tip-branch builders could rely on that); record the true
    # above-tip state so fix_up_missations' factoring keeps the delta chains
    # consistent
    for l in var_sites:
        for i in miss_at[l]:
            p = int(parent[i])
            if p == R:
                s = root_state.get(l, int(ref_seq[l]))
            else:
                s = state_of(p, l)
            if s != int(ref_seq[l]):
                miss_from_states[i][l] = s

    tree = FlatTree(parent=parent, children=children, t=t, t_min=t_min,
                    t_max=t_max, root=R, ref_seq=ref_seq,
                    mutations=mutations, miss_intervals=miss_intervals,
                    miss_from_states=miss_from_states,
                    name=list(guide.name))
    fix_up_missations(tree)
    return tree


def _build_initial_tree_native(ref_seq, tip_deltas, tip_miss_intervals,
                               tip_dates, names, rng) -> FlatTree | None:
    """Timing + missation phases on top of the native topology pipeline."""
    from .native.init_loader import build_initial_topology_native

    out = build_initial_topology_native(
        ref_seq, tip_deltas, tip_miss_intervals, tip_dates,
        seed=int(rng.integers(2 ** 63)), refine_passes=10)
    if out is None:
        return None
    (parent, children, R, mut_off, mut_site, mut_from, mut_to,
     root_deltas, mu_per_day, t_mrca, _r2) = out
    T = len(tip_deltas)
    N = 2 * T - 1
    L = len(ref_seq)

    # per-node mutation-count depth from the root (for regression timing)
    n_muts = (mut_off[1:] - mut_off[:-1]).astype(np.float64)
    order = []           # pre-order
    depth = np.zeros(N)
    stack = [R]
    while stack:
        n = stack.pop()
        order.append(n)
        for c in children[n]:
            if c != NO_NODE:
                depth[c] = depth[n] + n_muts[c]
                stack.append(int(c))

    t = np.zeros(N)
    t_min = np.full(N, -np.inf)
    t_max = np.full(N, np.inf)
    slope = max(mu_per_day, 1.0 / 26.0)
    for i in range(T):
        lo, hi = tip_dates[i]
        t_min[i], t_max[i] = lo, hi
        t[i] = rng.uniform(lo, hi) if hi > lo else lo
    for n in order:
        if children[n, 0] != NO_NODE:
            t[n] = t_mrca + depth[n] / slope
    # reversed pre-order: children before parents => one clamping pass
    for n in order[::-1]:
        p = int(parent[n])
        if p != NO_NODE and t[p] >= t[n]:
            t[p] = t[n] - rng.uniform(0.5, 1.5)

    mutations = [[] for _ in range(N)]
    for n in range(N):
        if n == R:
            continue
        p = int(parent[n])
        lo, hi = mut_off[n], mut_off[n + 1]
        if hi == lo:
            continue
        times = np.sort(rng.uniform(t[p], t[n], size=hi - lo))
        branch = [Mutation(site=int(mut_site[k]), from_=int(mut_from[k]),
                           to=int(mut_to[k]), t=float(times[k - lo]))
                  for k in range(lo, hi)]
        branch.sort(key=lambda m: m.key())
        mutations[n] = branch
    mutations[R] = [Mutation(site=l, from_=int(ref_seq[l]), to=s,
                             t=ROOT_DELTA_T)
                    for l, s in sorted(root_deltas.items())]

    miss_intervals = [[] for _ in range(N)]
    miss_from_states = [{} for _ in range(N)]
    for i in range(T):
        miss_intervals[i] = sorted(tip_miss_intervals[i])

    # missation from-states: DFS with a running ref->here diff; at each tip,
    # record diff states at its missing sites (state just above the tip)
    diff = dict(root_deltas)
    # iterative DFS with undo stacks
    stack = [(int(R), False)]
    undo = []
    while stack:
        n, leaving = stack.pop()
        if leaving:
            for (l, old) in undo.pop():
                if old is None:
                    diff.pop(l, None)
                else:
                    diff[l] = old
            continue
        if n != R:
            changes = []
            for m in mutations[n]:
                changes.append((m.site, diff.get(m.site)))
                if m.to == int(ref_seq[m.site]):
                    diff.pop(m.site, None)
                else:
                    diff[m.site] = m.to
            undo.append(changes)
            stack.append((n, True))
        if children[n, 0] != NO_NODE:
            stack.append((int(children[n, 0]), False))
            stack.append((int(children[n, 1]), False))
        elif n < T and miss_intervals[n]:
            ivs = miss_intervals[n]
            if len(diff) <= 64 * len(ivs):
                for l, s in diff.items():
                    for (a, b) in ivs:
                        if a <= l < b:
                            miss_from_states[n][l] = s
                            break
            else:
                for (a, b) in ivs:
                    for l in range(a, b):
                        if l in diff:
                            miss_from_states[n][l] = diff[l]

    tree = FlatTree(parent=parent.astype(np.int32),
                    children=children.astype(np.int32),
                    t=t, t_min=t_min, t_max=t_max, root=int(R),
                    ref_seq=ref_seq,
                    mutations=mutations, miss_intervals=miss_intervals,
                    miss_from_states=miss_from_states,
                    name=list(names) if names
                    else [f"t{i}" for i in range(T)])
    fix_up_missations(tree)
    return tree
