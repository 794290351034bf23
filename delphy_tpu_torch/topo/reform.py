"""Host-side joint redraw of same-site mutation-time chains.

The device sweep's batched reform (parallel/sweep.py:_batched_reform)
resamples mutation times only at slots that are the UNIQUE occurrence of
their (branch, site) pair — the independent-uniform proposal is exact there.
Branches carrying >=2 mutations of the SAME site need the reference's joint
redraw-and-sort proposal (core/phylo_tree.cpp:579-645): k i.i.d. uniforms on
(t_P, t_X), sorted, assigned to the chain in order (the from->to state chain
along the branch is fixed, only the crossing times move).  Such branches are
rare (a site mutating twice on one branch), so this runs on host once per
topology burst, completing ergodicity over all mutation times.
"""

from __future__ import annotations

import numpy as np

from ..phylo import FlatTree


def resample_multi_site_chains(tree: FlatTree, rng: np.random.Generator,
                               mu: float, nu: np.ndarray, part: np.ndarray,
                               qa_tab: np.ndarray, rounds: int = 1,
                               nodes=None) -> float:
    """MH joint redraw of every same-site chain's crossing times.

    For each branch P->X and site l with chain m_1..m_k (k>=2, ordered by
    time; states s_0 -> s_1 -> ... -> s_k), propose t'_1..t'_k = sorted i.i.d.
    U(t_P, t_X).  The proposal is symmetric (order statistics of i.i.d.
    uniforms), and the log_G change is linear in each crossing time:

        d log_G / d t_i = -mu * nu_l * (qa[s_{i-1}] - qa[s_i])

    (the segment before m_i sits in state s_{i-1}, after in s_i; only the
    lambda integral depends on times, the rate factors don't — same slope the
    device reform uses for single slots).  Chains at different sites on the
    same branch are independent, but are accepted per-branch to mirror the
    reference's whole-branch redraw.

    rounds: number of independent MH redraw sweeps.  The caller scales this
    with the burst's local-move window so the per-move reform intensity is
    cadence-invariant (larger, rarer bursts apply proportionally more
    rounds — otherwise amortizing bursts would slow these coordinates' mixing
    relative to everything else).

    nodes: optional iterable restricting the scan to these branches (the
    overlapped driver passes only the host-owned half — the device may be
    concurrently displacing the other half's branch endpoints, which these
    proposals' windows read).

    Returns total accepted delta log_G; updates tree.mutations in place.
    """
    mu = float(mu)
    nu = np.asarray(nu, dtype=np.float64)
    qa_tab = np.asarray(qa_tab, dtype=np.float64)
    part = np.asarray(part)
    total = 0.0
    for x in (range(tree.num_nodes) if nodes is None else nodes):
        x = int(x)
        if x == tree.root:
            continue
        muts = tree.mutations[x]
        if len(muts) < 2:
            continue
        sites = {}
        for i, m in enumerate(muts):
            sites.setdefault(m.site, []).append(i)
        chains = [idxs for idxs in sites.values() if len(idxs) >= 2]
        if not chains:
            continue
        t_p = float(tree.t[tree.parent[x]])
        t_x = float(tree.t[x])
        if not (t_x > t_p):
            continue
        changed = False
        for _ in range(max(1, rounds)):
            delta = 0.0
            proposals = []  # (slot index, new time)
            for idxs in chains:
                # list order is (t, site)-sorted: idxs is chain order (and
                # stays chain order after accepted rounds, which assign
                # sorted times in index order before the final list re-sort)
                k = len(idxs)
                new_t = np.sort(rng.uniform(t_p, t_x, k))
                l = muts[idxs[0]].site
                scale = mu * nu[l]
                qa = qa_tab[part[l]]
                for j, i in enumerate(idxs):
                    m = muts[i]
                    slope = scale * (qa[m.from_] - qa[m.to])
                    delta += -slope * (new_t[j] - m.t)
                    proposals.append((i, new_t[j]))
            if delta >= 0.0 or np.log(rng.uniform(1e-300, 1.0)) < delta:
                for i, nt in proposals:
                    muts[i].t = nt
                total += delta
                changed = True
        if changed:
            muts.sort(key=lambda m: (m.t, m.site))
    return total
