"""Synthetic-data simulator (host-side, numpy).

Generates a dated coalescent tree and evolves sequences along it under
HKY + optional site-rate heterogeneity, producing the (ref_seq, tip deltas,
missing intervals, dates) inputs the engine consumes.  Used by tests and
benchmarks (no bundled datasets; the reference's benchmark datasets are
downloads, delphywp.pdf §5)."""

from __future__ import annotations

import numpy as np

from .evo import hky_q


def simulate_dataset(num_tips: int, num_sites: int, mu: float,
                     kappa: float = 2.0, pi=(0.25, 0.25, 0.25, 0.25),
                     sample_window_days: float = 180.0,
                     coalescent_n0: float = 200.0,
                     missing_fraction: float = 0.05,
                     seed: int = 0):
    rng = np.random.default_rng(seed)
    pi = np.asarray(pi, dtype=np.float64)
    q = hky_q(kappa, pi).numpy()
    q_off = q.copy()
    np.fill_diagonal(q_off, 0.0)

    ref = rng.choice(4, size=num_sites, p=pi).astype(np.int8)

    # dated coalescent topology: tips sampled uniformly in the window,
    # pairwise merges at exponential waiting times
    tip_t = rng.uniform(0.0, sample_window_days, size=num_tips)
    nodes = [(i, tip_t[i]) for i in range(num_tips)]
    parent = {}
    times = {i: tip_t[i] for i in range(num_tips)}
    nxt = num_tips
    # process by going back in time
    active = sorted(nodes, key=lambda x: -x[1])
    lineages = []
    t_cur = max(tip_t)
    events = []
    pending = active[:]
    while len(lineages) + len(pending) > 1:
        k = len(lineages)
        rate = k * (k - 1) / (2.0 * coalescent_n0) if k >= 2 else 0.0
        t_next_coal = t_cur - rng.exponential(1.0 / rate) if rate > 0 else -np.inf
        t_next_tip = pending[0][1] if pending else -np.inf
        if t_next_tip >= t_next_coal:
            lineages.append(pending.pop(0)[0])
            t_cur = t_next_tip
        else:
            ia, ib = rng.choice(len(lineages), size=2, replace=False)
            a, b = lineages[ia], lineages[ib]
            node = nxt
            nxt += 1
            times[node] = t_next_coal
            parent[a] = node
            parent[b] = node
            lineages = [x for x in lineages if x not in (a, b)] + [node]
            t_cur = t_next_coal
            events.append((node, a, b))
    root = lineages[0]

    # evolve sequences: the root sequence IS the reference (matching the
    # realistic regime where the reference is close to the data, as with
    # MAPLE/consensus references; an independent random root would make ~75%
    # of sites differ from ref at every tip)
    seqs = {root: ref.copy()}
    children = {n: (a, b) for (n, a, b) in events}

    def evolve(seq, dt):
        out = seq.copy()
        # per-site Poisson thinning: expected mutations mu*q_a(state)*dt
        qa = -np.diagonal(q)
        n_events = rng.poisson(mu * qa[out] * dt)
        hot = np.nonzero(n_events > 0)[0]
        for l in hot:
            s = out[l]
            for _ in range(n_events[l]):
                p = q_off[s] / q_off[s].sum()
                s = rng.choice(4, p=p)
            out[l] = s
        return out

    order = [root]
    i = 0
    while i < len(order):
        n = order[i]
        i += 1
        if n in children:
            a, b = children[n]
            for c in (a, b):
                seqs[c] = evolve(seqs[n], times[c] - times[n])
                order.append(c)

    tip_deltas, tip_miss, tip_dates, names = [], [], [], []
    for i in range(num_tips):
        deltas = [(int(l), int(seqs[i][l])) for l in np.nonzero(seqs[i] != ref)[0]]
        miss = []
        if missing_fraction > 0 and rng.random() < 0.7:
            span = int(missing_fraction * num_sites * rng.uniform(0.2, 2.0))
            if span >= 1:
                s = int(rng.integers(0, max(num_sites - span, 1)))
                miss = [(s, min(s + span, num_sites))]
        missing = set()
        for (s, e) in miss:
            missing.update(range(s, e))
        deltas = [(l, to) for (l, to) in deltas if l not in missing]
        tip_deltas.append(deltas)
        tip_miss.append(miss)
        tip_dates.append((float(tip_t[i]), float(tip_t[i])))
        names.append(f"sim_{i}")

    truth = {"root_time": times[root], "mu": mu, "kappa": kappa, "pi": pi}
    return ref, tip_deltas, tip_miss, tip_dates, names, truth
