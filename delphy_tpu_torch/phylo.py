"""Host-side flat phylogenetic tree (EMAT) and builders.

This is the mutable, numpy/python representation used for input parsing, tree
initialization, output and tests.  The device-side MCMC state (state.py) is
packed from / unpacked to this structure.

Semantics mirror the reference's Phylo_tree (core/phylo_tree.h):
  - binary tree over 2*T-1 nodes as flat index arrays (core/tree.h:191-226);
  - each node carries timed mutations on the branch *above* it, sorted by
    (t, site) (core/mutations.h:39-47);
  - "mutations" on the root pseudo-branch encode deltas of the root sequence
    from ref_seq and carry t = -inf (core/phylo_tree_calc.cpp:577-585);
  - missations on a branch mark sites missing in the whole subtree below,
    stored as [start, end) intervals plus from-state exceptions where the
    state at the branch start differs from ref (core/mutations.h:87-123);
  - tips have date-uncertainty bounds [t_min, t_max] (core/phylo_tree.h:14-23).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

NO_NODE = -1


@dataclass
class Mutation:
    site: int
    from_: int
    to: int
    t: float

    def key(self):
        return (self.t, self.site)


@dataclass
class FlatTree:
    parent: np.ndarray          # i32[N], NO_NODE at root
    children: np.ndarray        # i32[N,2], NO_NODE for tips
    t: np.ndarray               # f64[N]
    t_min: np.ndarray           # f64[N] (tips; -inf for inner)
    t_max: np.ndarray           # f64[N] (tips; +inf for inner)
    root: int
    ref_seq: np.ndarray         # i8[L]
    mutations: list             # per node: list[Mutation], sorted by (t, site)
    miss_intervals: list        # per node: list[(start, end)]
    miss_from_states: list      # per node: dict{site: from_state}
    name: list = field(default_factory=list)

    def copy(self) -> "FlatTree":
        """Deep copy (arrays, per-node mutation/missation containers)."""
        return FlatTree(
            parent=self.parent.copy(), children=self.children.copy(),
            t=self.t.copy(), t_min=self.t_min.copy(),
            t_max=self.t_max.copy(), root=self.root,
            ref_seq=self.ref_seq.copy(),
            mutations=[[Mutation(m.site, m.from_, m.to, m.t) for m in ms]
                       for ms in self.mutations],
            miss_intervals=[list(iv) for iv in self.miss_intervals],
            miss_from_states=[dict(fs) for fs in self.miss_from_states],
            name=list(self.name))

    @property
    def num_nodes(self) -> int:
        return len(self.parent)

    @property
    def num_tips(self) -> int:
        return int(np.sum(self.children[:, 0] == NO_NODE))

    @property
    def num_sites(self) -> int:
        return len(self.ref_seq)

    def is_tip(self, i: int) -> bool:
        return self.children[i, 0] == NO_NODE

    def num_mutations(self) -> int:
        """Real mutations (root deltas excluded), cf. calc_num_muts (phylo_tree_calc.cpp:577)."""
        return sum(len(self.mutations[i]) for i in range(self.num_nodes) if i != self.root)

    # ---- traversals -------------------------------------------------------

    def post_order(self) -> np.ndarray:
        order = np.empty(self.num_nodes, dtype=np.int32)
        visited = np.zeros(self.num_nodes, dtype=bool)
        stack = [self.root]
        k = 0
        while stack:
            n = stack.pop()
            if self.is_tip(n) or visited[n]:
                order[k] = n
                k += 1
            else:
                visited[n] = True
                stack.append(n)
                stack.append(int(self.children[n, 1]))
                stack.append(int(self.children[n, 0]))
        assert k == self.num_nodes
        return order

    def euler_positions(self):
        """DFS entry/exit positions (tin, tout) for Euler-tour subtree prefix sums.

        Place a per-branch value v[d] at position tin[d]; then
        sum_{d strictly below n} v[d] == pref[tout[n]] - pref[tin[n]]
        where pref is the inclusive prefix sum of the position array.
        """
        N = self.num_nodes
        tin = np.empty(N, dtype=np.int32)
        tout = np.empty(N, dtype=np.int32)
        timer = 0
        stack = [(self.root, False)]
        while stack:
            n, exiting = stack.pop()
            if exiting:
                tout[n] = timer
            else:
                tin[n] = timer
                timer += 1
                stack.append((n, True))
                if not self.is_tip(n):
                    stack.append((int(self.children[n, 1]), False))
                    stack.append((int(self.children[n, 0]), False))
        return tin, tout

    # ---- sequence reconstruction (tests/IO; mirrors view_of_sequence_at) --

    def sequence_at(self, node: int) -> np.ndarray:
        """Materialized sequence at a node (core/phylo_tree_calc.cpp:19-39)."""
        seq = self.ref_seq.copy()
        path = []
        cur = node
        while cur != NO_NODE:
            path.append(cur)
            cur = int(self.parent[cur])
        for cur in reversed(path):
            for m in self.mutations[cur]:
                seq[m.site] = m.to
        return seq

    def missing_sites_at(self, node: int) -> set:
        """Union of missation intervals on the path to the root (cpp:41-56)."""
        out = set()
        cur = node
        while cur != NO_NODE:
            for (s, e) in self.miss_intervals[cur]:
                out.update(range(s, e))
            cur = int(self.parent[cur])
        return out

    # ---- integrity (mirrors assert_phylo_tree_integrity + mutation checks) -

    def check_integrity(self):
        N = self.num_nodes
        assert self.parent[self.root] == NO_NODE
        seen = np.zeros(N, dtype=bool)
        for i in range(N):
            if i == self.root:
                continue
            p = int(self.parent[i])
            assert 0 <= p < N and i in self.children[p], f"node {i} not child of its parent"
            assert self.t[p] < self.t[i] or (self.t[p] <= self.t[i]), \
                f"branch ({p},{i}) has negative length"
        for i in range(N):
            if not self.is_tip(i):
                l, r = self.children[i]
                assert self.parent[l] == i and self.parent[r] == i
                seen[l] = seen[r] = True
        # mutation chain consistency along each branch
        for i in range(N):
            muts = self.mutations[i]
            assert muts == sorted(muts, key=lambda m: m.key()), f"mutations on {i} unsorted"
            if i == self.root:
                continue
            t_p, t_i = self.t[int(self.parent[i])], self.t[i]
            state_above = self.sequence_at(int(self.parent[i]))
            per_site_state = {}
            for m in muts:
                assert t_p < m.t <= t_i, f"mutation time {m.t} outside ({t_p},{t_i}] on {i}"
                prev = per_site_state.get(m.site, int(state_above[m.site]))
                assert m.from_ == prev, f"broken from-state chain at site {m.site} on branch {i}"
                assert m.from_ != m.to
                per_site_state[m.site] = m.to
        # missation intervals sorted, non-overlapping, not nested across path
        for i in range(N):
            iv = self.miss_intervals[i]
            for (s, e) in iv:
                assert 0 <= s < e <= self.num_sites
            for a, b in zip(iv, iv[1:]):
                assert a[1] <= b[0], f"overlapping missation intervals on {i}"
        # canonical missation form (fix_up_missations invariant): siblings
        # never share a missing site; no missation nested below another
        def sites_of(n):
            out = set()
            for (s, e) in self.miss_intervals[n]:
                out.update(range(s, e))
            return out
        for p in range(N):
            if self.is_tip(p):
                continue
            c1, c2 = int(self.children[p, 0]), int(self.children[p, 1])
            shared = sites_of(c1) & sites_of(c2)
            assert not shared, f"non-canonical missations at junction {p}: {sorted(shared)[:5]}"
        for i in range(N):
            if i == self.root:
                continue
            above = set()
            cur = int(self.parent[i])
            while cur != NO_NODE:
                above |= sites_of(cur)
                cur = int(self.parent[cur])
            nested = sites_of(i) & above
            assert not nested, f"nested missation at node {i}: {sorted(nested)[:5]}"


def rereference_to_root_sequence(tree: FlatTree):
    """Make ref_seq equal the root sequence, clearing root deltas and
    re-keying missation from-states (reference rereference_to_root_sequence,
    phylo_tree.cpp:299-312).  log_G is invariant under this change."""
    root_muts = tree.mutations[tree.root]
    if not root_muts:
        return
    changes = {}
    for m in root_muts:
        assert int(tree.ref_seq[m.site]) == m.from_
        changes[m.site] = (m.from_, m.to)
        tree.ref_seq[m.site] = m.to
    for node in range(tree.num_nodes):
        fs = tree.miss_from_states[node]
        own = None
        for site, (old_ref, new_ref) in changes.items():
            covered = any(s <= site < e for (s, e) in tree.miss_intervals[node])
            if not covered:
                continue
            explicit = fs.get(site, old_ref)
            if explicit == new_ref:
                fs.pop(site, None)
            else:
                fs[site] = explicit
    tree.mutations[tree.root] = []


def build_greedy_tree(ref_seq: np.ndarray, tip_deltas: list,
                      tip_miss_intervals: list, tip_dates: list,
                      names: list | None = None,
                      rng: np.random.Generator | None = None) -> FlatTree:
    """Greedy parsimony-flavoured starting tree: each tip attaches as the
    sibling of the already-placed tip with the smallest sparse Hamming
    distance (symmetric difference of delta sets).

    A simplified stand-in for the reference's utree guide-tree pipeline
    (build_guide_tree + nearest-first refinement + OLS rooting,
    core/utree.h:235-317); MCMC topology moves polish the rest.  O(T^2) in
    the number of tips over sparse deltas.
    """
    rng = rng or np.random.default_rng(0)
    T = len(tip_deltas)
    assert T >= 2
    delta_sets = [frozenset(d) for d in tip_deltas]

    N = 2 * T - 1
    parent = np.full(N, NO_NODE, dtype=np.int32)
    children = np.full((N, 2), NO_NODE, dtype=np.int32)
    t = np.zeros(N)
    t_min = np.full(N, -np.inf)
    t_max = np.full(N, np.inf)
    for i in range(T):
        lo, hi = tip_dates[i]
        t_min[i], t_max[i] = lo, hi
        t[i] = rng.uniform(lo, hi) if hi > lo else lo

    # greedy nearest-neighbour attachment in input order (stand-in for the
    # reference guide tree's min-new-deltas insertion)
    placed = [0, 1]
    inner = T
    parent[0] = parent[1] = inner
    children[inner] = (0, 1)
    root = inner
    inner += 1
    for idx in range(2, T):
        best_j, best_d = placed[0], None
        for j in placed:
            d = len(delta_sets[idx] ^ delta_sets[j])
            if best_d is None or d < best_d:
                best_j, best_d = j, d
        P = inner
        inner += 1
        old_parent = int(parent[best_j])
        gc = list(children[old_parent])
        gc[gc.index(best_j)] = P
        children[old_parent] = gc
        parent[P] = old_parent
        children[P] = (min(idx, best_j), max(idx, best_j))
        parent[idx] = P
        parent[best_j] = P
        placed.append(idx)

    mutations = [[] for _ in range(N)]
    miss_intervals = [[] for _ in range(N)]
    miss_from_states = [{} for _ in range(N)]
    for i in range(T):
        miss_intervals[i] = sorted(tip_miss_intervals[i])

    tree = FlatTree(parent=parent, children=children, t=t, t_min=t_min,
                    t_max=t_max, root=root,
                    ref_seq=np.asarray(ref_seq, dtype=np.int8),
                    mutations=mutations, miss_intervals=miss_intervals,
                    miss_from_states=miss_from_states,
                    name=list(names) if names else [f"tip_{i}" for i in range(T)])

    # time inner nodes with the ~13 days/mutation heuristic
    # (core/dates.cpp pseudo_date:64-84)
    est = {}
    for n in tree.post_order():
        n = int(n)
        if tree.is_tip(n):
            est[n] = t[n] - 13.0 * len(tip_deltas[n])
        else:
            l, r = int(children[n, 0]), int(children[n, 1])
            t[n] = min(est[l], est[r]) - rng.uniform(0.5, 1.5)
            est[n] = t[n]

    # all deltas as tip-branch mutations at uniform times
    for i in range(T):
        t_p = t[int(parent[i])]
        for (site, to) in tip_deltas[i]:
            frm = int(ref_seq[site])
            if frm == to:
                continue
            mutations[i].append(Mutation(site=site, from_=frm, to=to,
                                         t=rng.uniform(t_p, t[i])))
        mutations[i].sort(key=lambda m: m.key())

    fix_up_missations(tree)
    return tree


def fix_up_missations(tree: FlatTree):
    """Normalize missations (reference fix_up_missations, phylo_tree.h:102):
    a site missing on both sibling branches is recorded on the parent branch
    instead, recursively (bottom-up).  Mutations on the parent branch at a
    factored site are absorbed into the missation's from-state (they carry no
    information once the site is missing below the branch start)."""
    order = tree.post_order()
    for p in order:
        if tree.is_tip(p):
            continue
        c1, c2 = (int(tree.children[p, 0]), int(tree.children[p, 1]))
        s1 = set()
        for (s, e) in tree.miss_intervals[c1]:
            s1.update(range(s, e))
        s2 = set()
        for (s, e) in tree.miss_intervals[c2]:
            s2.update(range(s, e))
        common = s1 & s2
        if not common:
            continue
        for l in common:
            frm = tree.miss_from_states[c1].get(l, int(tree.ref_seq[l]))
            tree.miss_from_states[c1].pop(l, None)
            tree.miss_from_states[c2].pop(l, None)
            # absorb p-branch mutations at l: the missation's from-state
            # becomes the state before the earliest of them
            muts_at_l = [m for m in tree.mutations[p] if m.site == l]
            if muts_at_l:
                frm = muts_at_l[0].from_
                tree.mutations[p] = [m for m in tree.mutations[p] if m.site != l]
            if frm == int(tree.ref_seq[l]):
                tree.miss_from_states[p].pop(l, None)
            else:
                tree.miss_from_states[p][l] = frm
        def to_iv(sites):
            if not sites:
                return []
            arr = sorted(sites)
            out = []
            start = prev = arr[0]
            for x in arr[1:]:
                if x == prev + 1:
                    prev = x
                else:
                    out.append((start, prev + 1))
                    start = prev = x
            out.append((start, prev + 1))
            return out
        tree.miss_intervals[c1] = to_iv(s1 - common)
        tree.miss_intervals[c2] = to_iv(s2 - common)
        pm = set()
        for (s, e) in tree.miss_intervals[p]:
            pm.update(range(s, e))
        tree.miss_intervals[p] = to_iv(pm | common)


def build_random_tree(ref_seq: np.ndarray,
                      tip_deltas: list,
                      tip_miss_intervals: list,
                      tip_dates: list,
                      names: list | None = None,
                      rng: np.random.Generator | None = None) -> FlatTree:
    """Random starting EMAT: random coalescent join order, all mutations on tip
    branches, inner times from the ~13 days/mutation heuristic
    (reference: build_random_tree, core/phylo_tree.h:156-161 + core/dates.cpp
    pseudo_date:64-84).

    tip_deltas[i]:  list[(site, to_state)] differences of tip i vs ref_seq
    tip_miss_intervals[i]: list[(start, end)] missing-site intervals of tip i
    tip_dates[i]: (t_min, t_max) in days since 2020-01-01
    """
    rng = rng or np.random.default_rng(0)
    T = len(tip_deltas)
    assert T >= 2
    N = 2 * T - 1
    parent = np.full(N, NO_NODE, dtype=np.int32)
    children = np.full((N, 2), NO_NODE, dtype=np.int32)
    t = np.zeros(N, dtype=np.float64)
    t_min = np.full(N, -np.inf)
    t_max = np.full(N, np.inf)
    mutations = [[] for _ in range(N)]
    miss_intervals = [[] for _ in range(N)]
    miss_from_states = [{} for _ in range(N)]

    for i in range(T):
        lo, hi = tip_dates[i]
        t_min[i], t_max[i] = lo, hi
        t[i] = rng.uniform(lo, hi) if hi > lo else lo
        miss_intervals[i] = sorted(tip_miss_intervals[i])

    # number of mutations per tip (for the inner-time heuristic)
    n_mut = np.zeros(N, dtype=np.int64)
    for i in range(T):
        n_mut[i] = len(tip_deltas[i])

    # random sequential coalescent: join two random active lineages
    active = list(range(T))
    est = {i: t[i] - 13.0 * n_mut[i] for i in range(T)}
    nxt = T
    while len(active) > 1:
        ia, ib = rng.choice(len(active), size=2, replace=False)
        a, b = active[ia], active[ib]
        inner = nxt
        nxt += 1
        children[inner] = (a, b)
        parent[a] = parent[b] = inner
        t[inner] = min(est[a], est[b]) - rng.uniform(0.5, 1.5)
        est[inner] = t[inner]
        active = [x for x in active if x not in (a, b)] + [inner]
    root = active[0]

    tree = FlatTree(parent=parent, children=children, t=t, t_min=t_min, t_max=t_max,
                    root=root, ref_seq=np.asarray(ref_seq, dtype=np.int8),
                    mutations=mutations, miss_intervals=miss_intervals,
                    miss_from_states=miss_from_states,
                    name=list(names) if names else [f"tip_{i}" for i in range(T)])

    # place each tip's deltas as mutations on its branch, at uniform times
    for i in range(T):
        t_p = t[int(parent[i])]
        for (site, to) in tip_deltas[i]:
            frm = int(ref_seq[site])
            if frm == to:
                continue
            mt = rng.uniform(t_p, t[i])
            mutations[i].append(Mutation(site=site, from_=frm, to=to, t=mt))
        mutations[i].sort(key=lambda m: m.key())

    fix_up_missations(tree)
    return tree
