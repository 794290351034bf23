"""Partitioned topology phase.

The statistical decoupling (partition.py + vsc.py) makes per-part topology
bursts independent, so they run on the native kernel's threads — the
host-side counterpart of the reference's ctpl thread pool fan-out
(run.cpp:682-693).  Only the native path of the reference package's module is
kept: without the native kernel these functions raise."""

from __future__ import annotations

import os

import numpy as np


def run_partitioned_bursts(tree, n_moves: int, num_parts: int, host_pop,
                           mu, nu, q, pi, host_rng, num_cells: int = 400,
                           parallel: bool = True, part=None, q_tab=None):
    """Partition -> per-part bursts (optionally on parallel threads) ->
    reassemble.  Returns (delta_log_G, n_accepted, n_proposed)."""
    from ..phylo import rereference_to_root_sequence
    from .partition import generate_random_partition_stencil, partition_tree

    rereference_to_root_sequence(tree)
    stencil = generate_random_partition_stencil(tree, num_parts, host_rng)
    parts = partition_tree(tree, stencil)
    return run_bursts_on_parts(tree, parts, n_moves, host_pop, mu, nu, q, pi,
                               host_rng, num_cells=num_cells,
                               parallel=parallel, part=part, q_tab=q_tab)


def run_bursts_on_parts(tree, parts, n_moves: int, host_pop,
                        mu, nu, q, pi, host_rng, num_cells: int = 400,
                        parallel: bool = True, part=None, q_tab=None,
                        do_reassemble: bool = True, burst_idx=None):
    """Per-part bursts on EXPLICIT pre-built parts (the overlapped driver
    hands the device-stencil's parts here), then reassemble into `tree`.
    Returns (delta_log_G, n_accepted, n_proposed).

    burst_idx: optional indices of the parts that actually receive moves.
    The augmented priors are ALWAYS built over the full `parts` list (the
    auxiliary fields condition on the total lineage staircase; unburst
    parts' contributions stay frozen, very_scalable_coalescent.cpp:85-232).

    do_reassemble=False leaves the mutated part trees un-merged: the
    overlapped driver reassembles them into the POST-device-phase tree
    instead of the snapshot the parts were cut from (disjoint supports make
    that exact)."""
    from .partition import reassemble
    from .vsc import make_vsc_parts

    rngs = [np.random.default_rng(host_rng.integers(2 ** 63)) for _ in parts]

    t_root = float(tree.t[tree.root])
    t_max = float(np.max(tree.t_max[:tree.num_tips]))
    t_step = max((t_max - t_root), 1.0) * 1.35 / num_cells
    vscs = make_vsc_parts(parts, host_pop, rngs, t_step)

    if burst_idx is None:
        burst_idx = range(len(parts))
    chosen = [(parts[i], vscs[i], rngs[i]) for i in burst_idx]
    sizes = np.array([p.tree.num_nodes for p, _, _ in chosen],
                     dtype=np.float64)
    alloc = host_rng.multinomial(n_moves, sizes / sizes.sum())

    payloads = []
    for (p, vsc, prng), k in zip(chosen, alloc):
        if k == 0 or p.tree.num_nodes < 5:
            continue
        payloads.append((p, vsc, int(k), int(prng.integers(2 ** 63))))

    delta_log_G, n_acc, n_prop = 0.0, 0, 0

    # the native kernel releases the GIL, so per-part bursts run on a plain
    # thread pool (the reference's ctpl thread-pool architecture,
    # run.cpp:682-693)
    from ..native import native_available, run_burst_native
    if not native_available():
        raise RuntimeError("partitioned topology bursts need the native "
                           "topology kernel (g++), which failed to build")

    def _native_one(args):
        p, vsc, k, seed = args
        tmx = float(np.max(p.tree.t_max[:p.tree.num_tips]))
        return run_burst_native(p.tree, k, mu, nu, q, pi, host_pop,
                                seed=seed, can_change_root=p.includes_root,
                                t_max_tip=tmx, vsc=vsc,
                                part=part, q_tab=q_tab)

    from concurrent.futures import ThreadPoolExecutor
    if parallel and len(payloads) > 1:
        with ThreadPoolExecutor(min(len(payloads),
                                    os.cpu_count() or 4)) as ex:
            results = list(ex.map(_native_one, payloads))
    else:
        results = [_native_one(pl) for pl in payloads]
    # a failed part leaves its tree untouched (the kernel mutates only on
    # success), so partial failures just mean fewer moves this burst
    for r in results:
        if r is not None:
            dlg, _dlc, acc, prop = r
            delta_log_G += dlg
            n_acc += acc
            n_prop += prop
    if do_reassemble:
        reassemble(tree, parts)
    return delta_log_G, n_acc, n_prop
