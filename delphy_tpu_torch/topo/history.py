"""JC mutational-history proposal samplers.

Reference: core/spr_move.cpp:1164-1407 (Nielsen rejection sampling +
Lartillot-style uniformization; see SURVEY.md §A.6) and the K-truncated
Poisson of core/distributions.h:77-175."""

from __future__ import annotations

import math

import numpy as np

from ..phylo import Mutation, FlatTree
from .site_deltas import state_at


def sample_k_truncated_poisson(rng: np.random.Generator, lam: float, min_k: int) -> int:
    """k ~ Poisson(lam) conditioned on k >= min_k (distributions.h:77-175)."""
    assert lam > 0 and min_k >= 0
    if min_k <= lam:
        while True:
            k = rng.poisson(lam)
            if k >= min_k:
                return int(k)
    # inverse transform over k >= min_k
    max_k = max(10.0 * min_k, 10.0 * lam)
    last_term = 1.0  # lam^{k-1}/(k-1)! as k advances
    normalization = math.expm1(lam)
    for k in range(1, min_k):
        last_term *= lam / k
        normalization -= last_term
    term_before_min_k = last_term
    if normalization <= 0.0 or abs(normalization) < 1e-10 * math.expm1(lam):
        normalization = 0.0
        t = term_before_min_k
        k = min_k
        while k < max_k:
            t *= lam / k
            normalization += t
            k += 1
    u = rng.uniform(0.0, normalization)
    cum = 0.0
    k = min_k
    term_k = term_before_min_k
    while k < max_k:
        term_k *= lam / k
        cum += term_k
        if cum > u:
            break
        k += 1
    return int(k)


def _choose_different_state(rng, s: int) -> int:
    return (s + rng.integers(1, 4)) % 4


def sample_mutational_history(rng, L: int, T: float, mu: float, deltas: dict) -> list:
    """JC trajectory over L sites on [-T, 0] with endpoint constraints `deltas`
    (site -> (from, to), from != to); unconstrained sites start AND end at A
    (adjusted later).  Reference spr_move.cpp:1164-1370."""
    result = []

    # Sites with deltas: >= 1 mutations, rejected until endpoint matches
    for l, (frm, to) in deltas.items():
        while True:
            n = sample_k_truncated_poisson(rng, mu * T, 1)
            s = frm
            to_states = []
            for _ in range(n):
                s = _choose_different_state(rng, s)
                to_states.append(s)
            if s == to:
                break
        times = sorted(rng.uniform(-T, 0.0, size=n))
        prev = frm
        for i in range(n):
            result.append(Mutation(site=l, from_=prev, to=to_states[i], t=times[i]))
            prev = to_states[i]

    # Sites without deltas: geometric skip over sites for >= 2-mutation
    # round trips (rare); Taylor-guarded log(1-p*) per spr_move.cpp:1258-1297
    muT = mu * T
    p1 = muT * math.exp(-muT)
    log_one_minus_p_tricky = (-0.5 * muT * muT if muT < 1e-4
                              else -muT - math.log1p(-p1))
    l = 0
    if L * muT * muT < 2e-6:
        l = L
    while l < L:
        rate = -log_one_minus_p_tricky
        u = rng.exponential(1.0 / rate) if rate > 0 else math.inf
        if not (0 <= u < L):
            break
        l += int(math.floor(u))
        if l >= L:
            break
        if l in deltas:
            l += 1
            continue
        n = sample_k_truncated_poisson(rng, muT, 2)
        s = 0  # A
        to_states = []
        for _ in range(n):
            s = _choose_different_state(rng, s)
            to_states.append(s)
        if s == 0:
            times = sorted(rng.uniform(-T, 0.0, size=n))
            prev = 0
            for i in range(n):
                result.append(Mutation(site=l, from_=prev, to=to_states[i], t=times[i]))
                prev = to_states[i]
            l += 1
        # else: reject, retry same site

    result.sort(key=lambda m: (m.t, m.site))
    return result


def sample_unconstrained_mutational_history(rng, L: int, T: float, mu: float) -> list:
    """Gillespie backwards from t=0 with per-site end state A
    (spr_move.cpp:1372-1407)."""
    cur_state = {}
    trajectory = []
    t = 0.0
    while True:
        t -= rng.exponential(1.0 / (mu * L))
        if t <= -T:
            break
        l = int(rng.integers(0, L))
        s = cur_state.get(l, 0)
        next_s = _choose_different_state(rng, s)
        trajectory.append(Mutation(site=l, from_=next_s, to=s, t=t))
        cur_state[l] = next_s
    trajectory.reverse()
    return trajectory


def adjust_mutational_history(history: list, site_deltas: dict, tree: FlatTree,
                              end_loc) -> None:
    """Shift times to absolute (ending at end_loc.t) and rotate states of
    non-delta sites so the trajectory ends at the true state at end_loc
    (spr_move.cpp:1409-1441)."""
    end_branch, end_t = end_loc
    end_states = {}
    for m in reversed(history):
        m.t += end_t
        if m.site not in site_deltas:
            if m.site in end_states:
                end_state = end_states[m.site]
            else:
                end_state = state_at(tree, end_branch, end_t, m.site)
                end_states[m.site] = end_state
            delta = end_state  # index_of(A) == 0
            m.from_ = (m.from_ + delta) % 4
            m.to = (m.to + delta) % 4
