"""Device time by section of a boundary, shared by the readers of the
program's section counts (``global_moves_device_ms``,
``model_moves_device_ms``, ``sweep_prep_device_ms``).

The program counts, at a boundary graph's capture, the device operations
of each section of the boundary (``delphy_tpu_torch/tracing.py``): each
replay adds them to ``_cuda.launch_counts["ops.<section>"]``, so a traced
dispatch's launch difference (``rec["dispatches"][i]["launches"]``) holds
them times its boundaries.  The slice's device events run in the order of
their stream: a dispatch's boundaries are replays of one graph, a fixed
series of events each, with the generator's prologue fills, the copy-in,
the hand-off and the harness's own copies between them.  Each launch of
the sweep kernel anchors one boundary: it is the last event of
``sweep.kernel`` (its wrapper packs before the launch and returns views),
so the per-boundary counts of the sections before it, in their order,
label the events before it, and ``sweep.update``'s the events after it.

The trace checks the counts: two replays of one graph lie apart by the
graph's events and the replay's prologue, so in each dispatch the most
common distance between neighbouring anchors has to be the boundary's
counted operations plus ``PROLOGUE``.  A count that misses or adds a
node shifts every window and reads nothing.
"""

from __future__ import annotations

import sys
from collections import Counter

SECTIONS = ("global.stats", "global.evo_moves", "global.pop_moves",
            "global.ledger", "sweep.prep", "sweep.kernel", "sweep.update")
ANCHOR = "sweep_chain_kernel"
# the device events a replay enqueues before its graph's own: the two
# fills of the graph's generator seed and offset (CUDAGraph.replay)
PROLOGUE = 2


def per_boundary(dispatch: dict):
    """A dispatch's device operations a boundary, section by section
    (None: the dispatch counted none, or counts that its boundaries do not
    divide)."""
    b = dispatch["boundaries"]
    counts = {s: dispatch["launches"].get("ops." + s, 0) for s in SECTIONS}
    if b <= 0 or not any(counts.values()):
        return None
    if any(n % b for n in counts.values()):
        return None
    return {s: n // b for s, n in counts.items()}


def section_us(rec: dict):
    """{"us": device us of each section summed over the labelled
    boundaries, "boundaries": their number, "left_out": the boundaries of
    each dispatch left out, "unlabelled_us": the device us of every other
    event (the slice's total less the labelled, so no check)}, or None
    unless every boundary's window lies inside the slice and no two
    overlap, each dispatch of two boundaries or more spaces its anchors
    by its counted operations plus ``PROLOGUE`` (at least one such
    dispatch), and at least 19 in 20 of each dispatch's boundaries show
    its most common event names at each section edge.  The profiler's
    device clock lets neighbouring events overlap by a few us (up to
    2.4 us between 1.2M-2M events of a skygrid call), so a rare boundary
    shows two neighbours swapped at an edge: such a boundary is left out,
    its events unlabelled."""
    events = sorted(rec["device"], key=lambda e: e[1])
    anchors = [i for i, e in enumerate(events) if ANCHOR in e[0]]
    if not rec["dispatches"] or len(anchors) != sum(
            d["boundaries"] for d in rec["dispatches"]):
        return None
    us = dict.fromkeys(SECTIONS, 0.0)
    k, free, labelled = 0, 0, 0    # next anchor, first free event, kept
    left_out, spaced = [], 0
    for d in rec["dispatches"]:
        c = per_boundary(d)
        if c is None or c["sweep.kernel"] < 1:
            return None
        mine = anchors[k:k + d["boundaries"]]
        if len(mine) > 1:
            gap = Counter(b - a for a, b in zip(mine, mine[1:]))
            if gap.most_common(1)[0][0] != sum(c.values()) + PROLOGUE:
                return None
            spaced += 1
        kernel = SECTIONS.index("sweep.kernel")
        before = sum(c[s] for s in SECTIONS[:kernel + 1]) - 1
        windows = []
        for a in mine:
            i = a - before
            if i < free or a + 1 + c["sweep.update"] > len(events):
                return None
            edges, sums = [], {}
            for s in SECTIONS:
                n = c[s]
                if n:
                    edges.append((events[i][0], events[i + n - 1][0]))
                    sums[s] = sum(e[2] for e in events[i:i + n])
                i += n
            free = i
            windows.append((tuple(edges), sums))
        common, n_common = Counter(w[0] for w in windows).most_common(1)[0]
        if 20 * n_common < 19 * len(windows):
            return None
        for edges, sums in windows:
            if edges == common:
                for s, v in sums.items():
                    us[s] += v
        labelled += n_common
        left_out.append(len(windows) - n_common)
        k += d["boundaries"]
    if not spaced:
        return None
    total = sum(e[2] for e in events)
    return {"us": us, "boundaries": labelled, "left_out": left_out,
            "unlabelled_us": total - sum(us.values())}


def device_ms(rec: dict, sections, log: bool = False) -> float | None:
    """Device ms a boundary in ``sections``, or None where the slice's
    events cannot be labelled; with ``log``, the boundaries left out of
    each dispatch go to stderr."""
    got = section_us(rec)
    if got is None:
        if log:
            print("sections: the slice's events cannot be labelled",
                  file=sys.stderr, flush=True)
        return None
    if log:
        print(f"sections: {got['boundaries']} boundaries labelled, left "
              f"out of each dispatch {got['left_out']}", file=sys.stderr,
              flush=True)
    return sum(got["us"][s] for s in sections) * 1e-3 / got["boundaries"]
