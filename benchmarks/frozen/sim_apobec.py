"""Generator of APOBEC3-shaped genomes, for cells of Delphy's mpox model.

The tree, the tip dates and the missing intervals are drawn as
``sim.simulate_dataset`` draws them (the same draws in the same order, so
the same seed gives the same tree).  The root, which is also the
reference, is drawn from ``pi``; its APOBEC3 contexts give each site's
partition (``reference.ledger.apobec_partition``), fixed along the tree.
Sites evolve under ``mu Q_part`` with ``reference.ledger.mpox_q_tab(rho)``:
Jukes-Cantor everywhere, and 2 rho mu more on C->T and G->A at the sites of
partition 1.  Along a branch the changes are drawn by uniformisation: a
Poisson number of candidate events at the fastest rate of any site and
state, each at a uniform site, which jumps by its own rates and otherwise
stays.

The first tip has no missing interval (its draws are made and not used):
Delphy reads the partition table off the first tip, and where that tip is
missing the base comes from the program's initial tree, which the plain
reference does not rebuild.
"""

from __future__ import annotations

import numpy as np

from ..reference.ledger import apobec_partition, mpox_q_tab


def coalescent_tree(rng, num_tips: int, sample_window_days: float,
                    coalescent_n0: float):
    """(tip times, node times, merge events (node, a, b), root): the draws
    of ``sim.simulate_dataset`` after its reference sequence."""
    tip_t = rng.uniform(0.0, sample_window_days, size=num_tips)
    times = {i: tip_t[i] for i in range(num_tips)}
    nxt = num_tips
    lineages = []
    t_cur = max(tip_t)
    events = []
    pending = sorted([(i, tip_t[i]) for i in range(num_tips)],
                     key=lambda x: -x[1])
    while len(lineages) + len(pending) > 1:
        k = len(lineages)
        rate = k * (k - 1) / (2.0 * coalescent_n0) if k >= 2 else 0.0
        t_coal = t_cur - rng.exponential(1.0 / rate) if rate > 0 else -np.inf
        t_tip = pending[0][1] if pending else -np.inf
        if t_tip >= t_coal:
            lineages.append(pending.pop(0)[0])
            t_cur = t_tip
        else:
            ia, ib = rng.choice(len(lineages), size=2, replace=False)
            a, b = lineages[ia], lineages[ib]
            node = nxt
            nxt += 1
            times[node] = t_coal
            lineages = [x for x in lineages if x not in (a, b)] + [node]
            t_cur = t_coal
            events.append((node, a, b))
    return tip_t, times, events, lineages[0]


def simulate_apobec_dataset(num_tips: int, num_sites: int, mu: float,
                            rho: float, pi=(0.25, 0.25, 0.25, 0.25),
                            sample_window_days: float = 180.0,
                            coalescent_n0: float = 200.0,
                            missing_fraction: float = 0.05, seed: int = 0):
    """(ref, tip deltas, tip missing intervals, tip dates, names); ``mu``
    per site and day, ``rho`` = mu* / mu."""
    rng = np.random.default_rng(seed)
    pi = np.asarray(pi, dtype=np.float64)
    ref = rng.choice(4, size=num_sites, p=pi).astype(np.int8)
    tip_t, times, events, root = coalescent_tree(
        rng, num_tips, sample_window_days, coalescent_n0)

    part = apobec_partition(ref)
    q_tab = mpox_q_tab(rho)
    qa_tab = -np.diagonal(q_tab, axis1=1, axis2=2)
    top = float(qa_tab.max())
    # per partition and state: the chance of each target for a candidate
    # event (the diagonal entry is the chance of staying)
    jump = q_tab / top
    jump[:, np.arange(4), np.arange(4)] = 1.0 - qa_tab / top
    cum = np.cumsum(jump, axis=2)

    def evolve(diff: dict, dt: float) -> dict:
        out = dict(diff)
        n = rng.poisson(mu * top * num_sites * dt)
        sites = rng.integers(0, num_sites, size=n)
        u = rng.random(n)
        for l, x in zip(sites.tolist(), u.tolist()):
            s = out.get(l, int(ref[l]))
            to = min(int(np.searchsorted(cum[part[l], s], x, side="right")),
                     3)
            if to == ref[l]:
                out.pop(l, None)
            else:
                out[l] = to
        return out

    children = {n: (a, b) for (n, a, b) in events}
    diffs = {root: {}}
    order = [root]
    i = 0
    while i < len(order):
        n = order[i]
        i += 1
        if n in children:
            for c in children[n]:
                diffs[c] = evolve(diffs[n], times[c] - times[n])
                order.append(c)

    tip_deltas, tip_miss, tip_dates, names = [], [], [], []
    for i in range(num_tips):
        miss = []
        if missing_fraction > 0 and rng.random() < 0.7:
            span = int(missing_fraction * num_sites * rng.uniform(0.2, 2.0))
            if span >= 1:
                s = int(rng.integers(0, max(num_sites - span, 1)))
                miss = [(s, min(s + span, num_sites))]
        if i == 0:
            miss = []
        deltas = [(l, to) for l, to in sorted(diffs[i].items())
                  if not any(s <= l < e for (s, e) in miss)]
        tip_deltas.append(deltas)
        tip_miss.append(miss)
        tip_dates.append((float(tip_t[i]), float(tip_t[i])))
        names.append(f"sim_{i}")
    return ref, tip_deltas, tip_miss, tip_dates, names
