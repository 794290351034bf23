"""Standalone tool entry points beyond the main CLI (port of
``delphy_tpu/tools.py``).

mcc_from_trees mirrors tools/delphy_mcc.cpp: read a BEAST-style .trees file,
derive the MCC tree, write annotated NEXUS."""

from __future__ import annotations

import sys

import numpy as np

from . import DEFAULT_DEVICE
from .io.newick import read_beast_trees
from .mcc import derive_mcc_tree, mcc_to_nexus
from .phylo import FlatTree, NO_NODE


def _reindex_tips_by_name(trees: list) -> list:
    """Permute tip indices so every tree shares the first tree's name order
    (clade fingerprints must align across base trees)."""
    ref_names = trees[0].name
    order = {n: i for i, n in enumerate(ref_names)}
    out = []
    for tr in trees:
        T = tr.num_tips
        perm = np.empty(T, dtype=np.int64)  # old tip index -> new tip index
        for i in range(T):
            perm[i] = order[tr.name[i]]
        full = np.concatenate([perm, np.arange(T, tr.num_nodes)])
        # rebuild arrays with explicit relabeling
        N = tr.num_nodes
        parent = np.full(N, NO_NODE, dtype=np.int32)
        children = np.full((N, 2), NO_NODE, dtype=np.int32)
        t = np.zeros(N)
        names = [""] * T
        for old in range(N):
            new_i = int(full[old])
            t[new_i] = tr.t[old]
            if old < T:
                names[new_i] = tr.name[old]
            p = int(tr.parent[old])
            if p != NO_NODE:
                parent[new_i] = full[p]
            c0, c1 = tr.children[old]
            if c0 != NO_NODE:
                a, b = int(full[c0]), int(full[c1])
                children[new_i] = (min(a, b), max(a, b))
        out.append(FlatTree(
            parent=parent, children=children, t=t,
            t_min=np.where(np.arange(N) < T, t, -np.inf),
            t_max=np.where(np.arange(N) < T, t, np.inf),
            root=int(full[tr.root]), ref_seq=tr.ref_seq,
            mutations=[[] for _ in range(N)],
            miss_intervals=[[] for _ in range(N)],
            miss_from_states=[{} for _ in range(N)],
            name=names))
    return out


def mcc_from_trees(trees_path, out_path, ref_len: int = 1, burn_in: float = 0.3,
                   seed: int = 0, warn=lambda m: print(m, file=sys.stderr)):
    ref = np.zeros(ref_len, dtype=np.int8)
    labeled = read_beast_trees(trees_path, ref, warn=warn)
    if len(labeled) < 2:
        raise ValueError(f"need >= 2 trees, got {len(labeled)}")
    skip = int(len(labeled) * burn_in)
    trees = [t for (_, t) in labeled[skip:]]
    trees = _reindex_tips_by_name(trees)
    mcc = derive_mcc_tree(trees, seed=seed)
    with open(out_path, "w") as f:
        mcc_to_nexus(mcc, f)
    return mcc


def _read_tip_data(in_maple=None, in_fasta=None, warn=lambda m: None):
    if in_maple:
        from .io.maple import read_maple
        mf = read_maple(in_maple, warn=warn)
        return mf.ref_seq, mf.tips
    from .io.fasta import read_fasta, deduce_consensus, fasta_to_tips
    records = read_fasta(in_fasta)
    length = max(len(r.bits) for r in records)
    ref_seq = deduce_consensus(records, length)
    return ref_seq, fasta_to_tips(records, ref_seq, warn=warn)


def annotate_tree_with_tip_data(tree: FlatTree, ref_seq, tips, rng) -> None:
    """Attach sequence data to a bare (topology+times) FlatTree: every tip's
    deltas become mutations on its pendant branch, missations normalize into
    canonical form (the converter's mutation/missation inference,
    tools/beast_trees_to_dphy.cpp — same initial-EMAT convention as
    build_random_tree)."""
    from .phylo import Mutation, fix_up_missations
    by_name = {t.name: t for t in tips}
    T = tree.num_tips
    for i in range(T):
        td = by_name.get(tree.name[i])
        if td is None:
            raise ValueError(f"tip {tree.name[i]!r} not in sequence data")
        tree.miss_intervals[i] = sorted(td.miss_intervals)
        t_p = float(tree.t[int(tree.parent[i])])
        t_i = float(tree.t[i])
        muts = []
        for (site, to) in td.deltas:
            frm = int(ref_seq[site])
            if frm == to:
                continue
            muts.append(Mutation(site=site, from_=frm, to=to,
                                 t=float(rng.uniform(t_p, t_i))))
        muts.sort(key=lambda m: m.key())
        tree.mutations[i] = muts
        tree.t_min[i] = tree.t_max[i] = t_i
    fix_up_missations(tree)


def beast_trees_to_snapshot(trees_path, out_path, in_maple=None, in_fasta=None,
                            seed: int = 0, device=DEFAULT_DEVICE,
                            warn=lambda m: print(m, file=sys.stderr)):
    """Convert a BEAST .trees posterior sample + sequence data into a run
    snapshot of the LAST sampled tree (resumable / viewable) on ``device``,
    mirroring tools/beast_trees_to_dphy.cpp (renumber nodes, place mutations,
    infer missations)."""
    from .run import Run
    from .io.snapshot import save_run

    ref_seq, tips = _read_tip_data(in_maple, in_fasta, warn=warn)
    labeled = read_beast_trees(trees_path, np.asarray(ref_seq), warn=warn)
    if not labeled:
        raise ValueError("no trees in input")
    label, tree = labeled[-1]
    rng = np.random.default_rng(seed)
    annotate_tree_with_tip_data(tree, ref_seq, tips, rng)
    tree.check_integrity()
    run = Run(tree, seed=seed, device=device)
    run.ledger = run.calc_cur_ledger()
    if str(out_path).endswith(".dphy"):
        # reference-compatible binary stream (tools/beast_trees_to_dphy.cpp)
        from .io.dphy import DphyOutput
        with open(out_path, "wb") as f:
            out = DphyOutput(f)
            out.output_preamble(run, steps_per_sample=1)
            out.output_state(run)
            out.output_epilog()
    else:
        save_run(run, out_path)
    return label, tree


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m delphy_tpu_torch.tools",
        description="Post-processing tools (MCC derivation, BEAST .trees "
                    "conversion)")
    sub = p.add_subparsers(dest="cmd")

    mcc_p = sub.add_parser("mcc", help="Derive an MCC tree from a .trees file")
    mcc_p.add_argument("trees")
    mcc_p.add_argument("out")
    mcc_p.add_argument("--burn-in", type=float, default=0.3)
    mcc_p.add_argument("--seed", type=int, default=0)

    cvt = sub.add_parser("beast-to-snapshot",
                         help="BEAST .trees + sequences -> run snapshot "
                              "(tools/beast_trees_to_dphy.cpp)")
    cvt.add_argument("trees")
    cvt.add_argument("out")
    cvt.add_argument("--in-maple")
    cvt.add_argument("--in-fasta")
    cvt.add_argument("--seed", type=int, default=0)
    cvt.add_argument("--device", default=DEFAULT_DEVICE,
                     help="torch device that builds the run: 'cuda' "
                          "(default) or 'cpu'; a snapshot resumes on the "
                          "device type that wrote it")

    # back-compat: bare `trees out` == mcc
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] not in ("mcc", "beast-to-snapshot", "-h", "--help"):
        argv = ["mcc"] + argv
    args = p.parse_args(argv)

    if args.cmd == "beast-to-snapshot":
        label, tree = beast_trees_to_snapshot(
            args.trees, args.out, in_maple=args.in_maple,
            in_fasta=args.in_fasta, seed=args.seed, device=args.device)
        print(f"Converted tree {label} ({tree.num_tips} tips) -> {args.out}",
              file=sys.stderr)
        return 0

    mcc = mcc_from_trees(args.trees, args.out, burn_in=args.burn_in,
                         seed=args.seed)
    print(f"MCC from master tree {mcc.master_index}; wrote {args.out}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
