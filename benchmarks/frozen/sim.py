"""Dataset simulator, frozen for the benchmark.

A copy of ``delphy_tpu_torch/sim.py`` ``simulate_dataset`` with its HKY rate
matrix in NumPy: the same draws in the same order, so the same seed gives
the same dataset.  A dated coalescent tree with tips sampled uniformly over
a window, sequences evolved along it under HKY from a random root that is
also the reference, and one missing interval on about 70% of the tips.
"""

from __future__ import annotations

import numpy as np


def hky_q(kappa: float, pi) -> np.ndarray:
    """HKY85 rate matrix: q[a, b] = r[a, b] pi[b] / R for a != b, with r 1
    for a transversion and kappa for a transition (A<->G, C<->T), R =
    pi^T r pi, and rows that sum to zero."""
    pi = np.asarray(pi, dtype=np.float64)
    a = np.arange(4)
    apart = np.abs(a[:, None] - a[None, :])
    r = (apart % 2 == 1).astype(np.float64) + kappa * (apart == 2)
    R = pi @ r @ pi
    q = r * pi[None, :] / R
    return q - np.diag(np.sum(q, axis=1))


def simulate_dataset(num_tips: int, num_sites: int, mu: float,
                     kappa: float = 2.0, pi=(0.25, 0.25, 0.25, 0.25),
                     sample_window_days: float = 180.0,
                     coalescent_n0: float = 200.0,
                     missing_fraction: float = 0.05, seed: int = 0):
    """(ref, tip deltas, tip missing intervals, tip dates, names)."""
    rng = np.random.default_rng(seed)
    pi = np.asarray(pi, dtype=np.float64)
    q = hky_q(kappa, pi)
    q_off = q.copy()
    np.fill_diagonal(q_off, 0.0)
    ref = rng.choice(4, size=num_sites, p=pi).astype(np.int8)

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
    root = lineages[0]

    seqs = {root: ref.copy()}
    children = {n: (a, b) for (n, a, b) in events}
    qa = -np.diagonal(q)

    def evolve(seq, dt):
        out = seq.copy()
        n_events = rng.poisson(mu * qa[out] * dt)
        for l in np.nonzero(n_events > 0)[0]:
            s = out[l]
            for _ in range(n_events[l]):
                s = rng.choice(4, p=q_off[s] / q_off[s].sum())
            out[l] = s
        return out

    order = [root]
    i = 0
    while i < len(order):
        n = order[i]
        i += 1
        if n in children:
            for c in children[n]:
                seqs[c] = evolve(seqs[n], times[c] - times[n])
                order.append(c)

    tip_deltas, tip_miss, tip_dates, names = [], [], [], []
    for i in range(num_tips):
        deltas = [(int(l), int(seqs[i][l]))
                  for l in np.nonzero(seqs[i] != ref)[0]]
        miss = []
        if missing_fraction > 0 and rng.random() < 0.7:
            span = int(missing_fraction * num_sites * rng.uniform(0.2, 2.0))
            if span >= 1:
                s = int(rng.integers(0, max(num_sites - span, 1)))
                miss = [(s, min(s + span, num_sites))]
        lo_hi = [(s, e) for (s, e) in miss]
        deltas = [(l, to) for (l, to) in deltas
                  if not any(s <= l < e for (s, e) in lo_hi)]
        tip_deltas.append(deltas)
        tip_miss.append(miss)
        tip_dates.append((float(tip_t[i]), float(tip_t[i])))
        names.append(f"sim_{i}")
    return ref, tip_deltas, tip_miss, tip_dates, names
