"""Maximum-clade-credibility tree summarization.

Reference: core/mcc_tree.{h,cpp} — random 64-bit XOR clade fingerprints per
tip propagated up each sampled tree; clade occurrence counts across the M base
trees; the base tree maximizing sum(log(count/M)) becomes the MCC topology;
each MCC node is annotated with posterior support, mean time over monophyletic
matches, and mean MRCA time over all base trees.  Here fingerprint propagation
and counting are vectorized with numpy over the node axis."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .phylo import FlatTree, NO_NODE


def _clade_fingerprints(tree: FlatTree, tip_fp: np.ndarray,
                        post: np.ndarray) -> np.ndarray:
    fp = np.zeros(tree.num_nodes, dtype=np.uint64)
    T = tree.num_tips
    fp[:T] = tip_fp
    for n in post:
        if not tree.is_tip(int(n)):
            l, r = tree.children[n]
            fp[n] = fp[l] ^ fp[r]
    return fp


def _mrca(tree: FlatTree, depth: np.ndarray, a: int, b: int) -> int:
    while a != b:
        if depth[a] >= depth[b]:
            a = int(tree.parent[a])
        else:
            b = int(tree.parent[b])
    return a


def _depths(tree: FlatTree) -> np.ndarray:
    depth = np.zeros(tree.num_nodes, dtype=np.int32)
    for n in reversed(tree.post_order()):  # pre-order
        if n != tree.root:
            depth[n] = depth[int(tree.parent[n])] + 1
    return depth


@dataclass
class MccTree:
    tree: FlatTree                 # topology copied from the master base tree
    master_index: int
    posterior_support: np.ndarray  # f64[N]
    t: np.ndarray                  # mean over monophyletic matches
    t_mrca: np.ndarray             # mean over all base trees


def derive_mcc_tree(base_trees: list, seed: int = 0) -> MccTree:
    M = len(base_trees)
    assert M > 0
    num_nodes = base_trees[0].num_nodes
    T = base_trees[0].num_tips
    rng = np.random.default_rng(seed)
    tip_fp = rng.integers(0, 2 ** 64, size=T, dtype=np.uint64)

    posts = [bt.post_order() for bt in base_trees]
    fps = [_clade_fingerprints(bt, tip_fp, posts[i])
           for i, bt in enumerate(base_trees)]

    counts: dict = {}
    for fp in fps:
        for v in fp:
            counts[int(v)] = counts.get(int(v), 0) + 1

    log_cc = np.zeros(M)
    logM = np.log(M)
    for i, bt in enumerate(base_trees):
        for n in range(num_nodes):
            if not bt.is_tip(n):
                log_cc[i] += np.log(counts[int(fps[i][n])]) - logM

    master = int(np.argmax(log_cc))
    mcc = base_trees[master]
    mcc_fp = fps[master]

    support = np.zeros(num_nodes)
    sum_t = np.zeros(num_nodes)
    n_exact = np.zeros(num_nodes, dtype=np.int64)
    sum_t_mrca = np.zeros(num_nodes)

    mcc_post = posts[master]
    for i, bt in enumerate(base_trees):
        depth = _depths(bt)
        corr = np.full(num_nodes, NO_NODE, dtype=np.int64)
        corr[:T] = np.arange(T)
        for n in mcc_post:
            n = int(n)
            if not mcc.is_tip(n):
                l, r = mcc.children[n]
                corr[n] = _mrca(bt, depth, int(corr[l]), int(corr[r]))
            c = int(corr[n])
            mono = fps[i][c] == mcc_fp[n]
            sum_t_mrca[n] += bt.t[c]
            if mono:
                sum_t[n] += bt.t[c]
                n_exact[n] += 1

    assert (n_exact > 0).all()
    return MccTree(tree=mcc, master_index=master,
                   posterior_support=n_exact / M,
                   t=sum_t / np.maximum(n_exact, 1),
                   t_mrca=sum_t_mrca / M)


def mcc_to_nexus(mcc: MccTree, fh):
    """NEXUS export with posterior/height annotations (cf. api.h:54 and
    tools/delphy_mcc.cpp)."""
    tree = mcc.tree
    T = tree.num_tips
    fh.write("#NEXUS\n\nBegin taxa;\n")
    fh.write(f"\tDimensions ntax={T};\n\t\tTaxlabels\n")
    for i in range(T):
        fh.write(f"\t\t\t{tree.name[i]}\n")
    fh.write("\t\t\t;\nEnd;\nBegin trees;\n\tTranslate\n")
    for i in range(T):
        sep = "," if i < T - 1 else ""
        fh.write(f"\t\t\t{i + 1} {tree.name[i]}{sep}\n")
    fh.write(";\n")

    frag = {}
    stack = [(int(tree.root), False)]
    while stack:
        n, done = stack.pop()
        if not done:
            stack.append((n, True))
            if not tree.is_tip(n):
                stack.append((int(tree.children[n, 1]), False))
                stack.append((int(tree.children[n, 0]), False))
        else:
            ann = (f"[&posterior={mcc.posterior_support[n]:.4f},"
                   f"t={mcc.t[n]:.4f},t_mrca={mcc.t_mrca[n]:.4f}]")
            if tree.is_tip(n):
                label = f"{n + 1}{ann}"
            else:
                l, r = int(tree.children[n, 0]), int(tree.children[n, 1])
                label = f"({frag.pop(l)},{frag.pop(r)}){ann}"
            if n == tree.root:
                frag[n] = label
            else:
                blen = mcc.t[n] - mcc.t[int(tree.parent[n])]
                frag[n] = f"{label}:{max(blen, 0.0):.8g}"
    fh.write(f"tree MCC = {frag[int(tree.root)]};\nEnd;\n")
