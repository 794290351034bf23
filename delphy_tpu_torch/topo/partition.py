"""Tree partitioning for parallel local/topology moves.

Reference: core/tree_partitioning.{h,cpp} + Run::repartition/reassemble
(core/run.cpp:110-275): cut the tree at stencil cut-points into subtrees; a
cut-point is the root of its own part and appears as a *frozen tip* in the
parent part (t_min = t_max = t); each part is self-contained because the
subroot carries root-deltas vs ref and the full missing-site set at the cut
point, while the cut-point's sequence is pinned as tip data in the parent
part (tip data is invariant under all moves)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..phylo import FlatTree, Mutation, NO_NODE

ROOT_DELTA_T = -1.0e30


def randomized_post_order(tree: FlatTree, rng: np.random.Generator):
    order = np.empty(tree.num_nodes, dtype=np.int32)
    visited = np.zeros(tree.num_nodes, dtype=bool)
    stack = [int(tree.root)]
    k = 0
    while stack:
        n = stack.pop()
        if tree.is_tip(n) or visited[n]:
            order[k] = n
            k += 1
        else:
            visited[n] = True
            stack.append(n)
            kids = [int(tree.children[n, 0]), int(tree.children[n, 1])]
            if rng.random() < 0.5:
                kids.reverse()
            stack.extend(kids)
    return order


def generate_random_partition_stencil(tree: FlatTree, num_parts: int,
                                      rng: np.random.Generator,
                                      return_sizes: bool = False,
                                      tries: int = 1):
    """Randomized greedy equal-size cuts (tree_partitioning.h:139-194).

    With return_sizes, also returns the per-part node counts (cut parts in
    cut order, then the residual root part) at no extra cost.  With
    tries > 1, generates that many independent stencils and keeps the one
    with the smallest WORST part (the reference keeps a cache of 10
    stencils, run.cpp:87-108; n_cap — and the Pallas kernel's O(n_cap^2)
    VMEM masks — are set by the worst part).  Dispatches to the native
    kernel when available (~40x the Python loop at 100k tips, which made
    best-of-6 a 5 s/burst fixed cost); the Python loop below is the
    fallback and the validation twin."""
    if num_parts > 1:
        from ..native import best_stencil_native
        res = best_stencil_native(tree, num_parts, rng, tries=tries)
        if res is not None:
            cuts, sizes = res
            return (cuts, sizes) if return_sizes else cuts
    best_cuts, best_sizes = None, None
    for _ in range(max(1, int(tries))):
        cuts, sizes = _py_partition_stencil(tree, num_parts, rng)
        if best_sizes is None or max(sizes) < max(best_sizes):
            best_cuts, best_sizes = cuts, sizes
    return (best_cuts, best_sizes) if return_sizes else best_cuts


def _py_partition_stencil(tree: FlatTree, num_parts: int,
                          rng: np.random.Generator):
    N = tree.num_nodes
    descendants = np.zeros(N, dtype=np.int64)
    cut_points = []
    sizes = []
    num_branches_left = N
    num_parts_left = num_parts
    for n in randomized_post_order(tree, rng):
        n = int(n)
        if n == tree.root or len(cut_points) == num_parts - 1:
            break
        descendants[n] = 1
        for c in tree.children[n]:
            if c != NO_NODE:
                descendants[n] += descendants[c]
        min_size = max(10, num_branches_left // (num_parts_left + 1))
        if descendants[n] >= min_size:
            if (num_branches_left - (descendants[n] - 1)) < min_size:
                continue
            if rng.random() < 0.5:
                continue
            cut_points.append(n)
            sizes.append(int(descendants[n]))
            num_branches_left -= descendants[n] - 1
            descendants[n] = 1
            num_parts_left -= 1
    return cut_points, sizes + [num_branches_left]


def split_oversized_cuts(tree: FlatTree, cut_points: list, cap: int) -> list:
    """Add cut points until every part has <= cap nodes (frozen-tip copies
    of cut children count toward the parent part, matching partition_tree's
    node collection).

    The greedy stencil generator's parts routinely overshoot the mean 3-8x
    (the residual root part, and subtrees that jump past min_size at a
    binary join), and the Pallas sweep kernel's VMEM masks are O(n_cap^2)
    with n_cap set by the WORST part — at 100k tips the overshoot alone
    pushes the run off the fused kernel.  One post-order pass: wherever the
    running within-part size exceeds cap, cut the larger child until it
    fits.  Every resulting part is <= cap because a node's children are
    finalized (each <= cap) before the node itself is examined."""
    N = tree.num_nodes
    is_cut = np.zeros(N, dtype=bool)
    for c in cut_points:
        is_cut[int(c)] = True
    is_cut[int(tree.root)] = True
    size = np.ones(N, dtype=np.int64)
    extra: list = []
    # deterministic post-order (children before parents)
    order = []
    stack = [(int(tree.root), False)]
    while stack:
        n, emitted = stack.pop()
        if emitted or tree.is_tip(n):
            order.append(n)
            continue
        stack.append((n, True))
        stack.append((int(tree.children[n, 0]), False))
        stack.append((int(tree.children[n, 1]), False))
    for n in order:
        if tree.is_tip(n):
            continue
        c0, c1 = int(tree.children[n, 0]), int(tree.children[n, 1])

        def part_size():
            return (1 + (1 if is_cut[c0] else int(size[c0]))
                    + (1 if is_cut[c1] else int(size[c1])))

        s = part_size()
        while s > cap:
            cands = [c for c in (c0, c1) if not is_cut[c] and size[c] > 1]
            if not cands:
                break
            big = max(cands, key=lambda c: int(size[c]))
            is_cut[big] = True
            extra.append(big)
            s = part_size()
        size[n] = s
    return list(cut_points) + extra


@dataclass
class PartitionPart:
    tree: FlatTree            # tips-first relabeled part
    orig_index: np.ndarray    # part node -> original tree node
    cut_point: int
    includes_root: bool


def partition_tree(tree: FlatTree, cut_points: list) -> list:
    """Build self-contained part FlatTrees (Run::repartition, run.cpp:110-190).

    The caller must have normalized the root first (no root from_states)."""
    assert not tree.miss_from_states[tree.root], "normalize the root first"
    cut_set = set(int(c) for c in cut_points)
    cut_set.add(int(tree.root))

    parts = []
    for cut in sorted(cut_set, key=lambda c: (c != tree.root, c)):
        # collect part nodes: cut + descendants, stopping at other cut points
        nodes = []
        stack = [cut]
        while stack:
            n = stack.pop()
            nodes.append(n)
            if not tree.is_tip(n):
                for c in tree.children[n]:
                    c = int(c)
                    if c in cut_set:
                        nodes.append(c)  # frozen tip boundary
                    else:
                        stack.append(c)
        # tips-first relabeling: part-leaves = orig tips or cut boundaries
        def is_part_leaf(n):
            return tree.is_tip(n) or (n in cut_set and n != cut)
        leaves = [n for n in nodes if is_part_leaf(n)]
        inners = [n for n in nodes if not is_part_leaf(n)]
        ordered = leaves + inners
        new_of = {n: i for i, n in enumerate(ordered)}
        Np, Tp = len(ordered), len(leaves)

        parent = np.full(Np, NO_NODE, dtype=np.int32)
        children = np.full((Np, 2), NO_NODE, dtype=np.int32)
        t = np.zeros(Np)
        t_min = np.full(Np, -np.inf)
        t_max = np.full(Np, np.inf)
        mutations = [[] for _ in range(Np)]
        miss_intervals = [[] for _ in range(Np)]
        miss_from_states = [{} for _ in range(Np)]
        names = [""] * Tp

        subroot_missing = sorted(tree.missing_sites_at(cut))
        subroot_seq_deltas = {}
        seq = tree.sequence_at(cut)
        diff = np.nonzero(seq != tree.ref_seq)[0]
        miss_set = set(subroot_missing)
        for l in diff:
            if int(l) not in miss_set:
                subroot_seq_deltas[int(l)] = int(seq[l])

        for n in nodes:
            i = new_of[n]
            t[i] = tree.t[n]
            if n == cut:
                # part root: deltas vs ref + full missing set, from_states empty
                mutations[i] = [Mutation(site=l, from_=int(tree.ref_seq[l]),
                                         to=s, t=ROOT_DELTA_T)
                                for l, s in sorted(subroot_seq_deltas.items())]
                miss_intervals[i] = _to_intervals(subroot_missing)
            else:
                p = int(tree.parent[n])
                parent[i] = new_of[p]
                mutations[i] = [Mutation(site=m.site, from_=m.from_, to=m.to,
                                         t=m.t) for m in tree.mutations[n]]
                miss_intervals[i] = list(tree.miss_intervals[n])
                miss_from_states[i] = dict(tree.miss_from_states[n])
            if is_part_leaf(n):
                if tree.is_tip(n):
                    t_min[i], t_max[i] = tree.t_min[n], tree.t_max[n]
                    names[i] = tree.name[n]
                else:
                    # frozen inner node: pin its time (run.cpp:166-169)
                    t_min[i] = t_max[i] = tree.t[n]
                    names[i] = f"__frozen_{n}"
            elif n != cut:
                pass
        for n in nodes:
            i = new_of[n]
            if not is_part_leaf(n) or n == cut:
                if not tree.is_tip(n):
                    a = new_of[int(tree.children[n, 0])]
                    b = new_of[int(tree.children[n, 1])]
                    children[i] = (min(a, b), max(a, b))

        part_tree = FlatTree(parent=parent, children=children, t=t,
                             t_min=t_min, t_max=t_max, root=new_of[cut],
                             ref_seq=tree.ref_seq, mutations=mutations,
                             miss_intervals=miss_intervals,
                             miss_from_states=miss_from_states, name=names)
        parts.append(PartitionPart(
            tree=part_tree,
            orig_index=np.array([n for n in ordered], dtype=np.int64),
            cut_point=cut, includes_root=(cut == tree.root)))
    return parts


def reassemble(tree: FlatTree, parts: list):
    """Copy part states back onto the main tree (Run::reassemble,
    run.cpp:195-252)."""
    for part in parts:
        sub = part.tree
        oi = part.orig_index
        for sn in range(sub.num_nodes):
            n = int(oi[sn])
            tree.t[n] = sub.t[sn]
            if sn != sub.root:
                tree.mutations[n] = sub.mutations[sn]
                tree.miss_intervals[n] = sub.miss_intervals[sn]
                tree.miss_from_states[n] = sub.miss_from_states[sn]
            if not sub.is_tip(sn):
                sl, sr = int(sub.children[sn, 0]), int(sub.children[sn, 1])
                l, r = int(oi[sl]), int(oi[sr])
                tree.children[n] = (min(l, r), max(l, r))
                tree.parent[l] = n
                tree.parent[r] = n
        if part.includes_root:
            new_root = int(oi[sub.root])
            tree.root = new_root
            tree.parent[new_root] = NO_NODE
            tree.mutations[new_root] = sub.mutations[sub.root]
            tree.miss_intervals[new_root] = sub.miss_intervals[sub.root]
            tree.miss_from_states[new_root] = sub.miss_from_states[sub.root]


def _to_intervals(sites):
    if not sites:
        return []
    out = []
    start = prev = sites[0]
    for x in sites[1:]:
        if x == prev + 1:
            prev = x
        else:
            out.append((start, prev + 1))
            start = prev = x
    out.append((start, prev + 1))
    return out
