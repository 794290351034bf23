"""Plain PyTorch reference of Delphy's mpox model (``--v0-mpox-hack``;
run.h:134-178, run.cpp:359-433 and 823-952; O'Toole et al. 2023, Science
382:595), written from the model and not from the port: float64, loops
over branches, mutations and sites, no kernel, no flat pools, no prefix
sums.  It imports torch alone, so it runs wherever the port does, on the
device its inputs are on.

A tree is given as plain tensors (``PlainTree``): each node's parent (-1
at the root) and time, every branch's mutations (node, site, from, to,
time; the branch above the node), the first tip's sequence, the per-site
``nu`` and, optionally, which sites each tip is missing.  Tips are nodes
0..T-1 and the first tip is node 0.  A site is present on a branch iff some
tip below it has it; a branch's rates and times count its present sites
only.

- ``apobec_partition``: a site is in partition 1 (an APOBEC3 context) iff
  the base before it is T and it is C or T, or the base after it is A and
  it is G or A.
- ``mpox_q_tab``: ``Q_0`` is Jukes-Cantor (1/3 off the diagonal, -1 on it),
  ``Q_1`` is ``Q_0`` with ``2 rho`` more on C->T and on G->A, its diagonal
  balanced (the factor 2 is O'Toole et al.'s convention).
- ``statistics``: the mutations on every branch but the root's counted by
  partition, from and to (``M_beta_ab``), and ``Ttwiddle_beta_a[p, a]``,
  the time the present sites of partition p spend in state a, weighted by
  nu, summed over the branches; each branch is walked from the state its
  parent ends in, one mutation at a time.
- ``log_G``: the root's prior (JC's uniform pi over the sites present
  below the root), and for each branch, log(mu nu_l Q_p[a, b]) for each
  mutation less the integral of the branch's total rate, mu times the sum
  over partitions and states of q_p(a) Ttwiddle.
- ``mpox_round``: one pseudo-Gibbs round of (mu, rho) from given variates.

Where this departs from Delphy:
- The partition table is worked out from the sequence it is given.  Delphy
  reads it off the first tip as the initial tree carries it, so at a site
  that tip is missing the base is the one the initial tree chose; a caller
  that wants Delphy's table passes the initial tree's first tip.
- ``mpox_round`` takes its variates.  The port draws ``g_mu`` from
  Gamma(M + a - 1, 1): mu's conditional under a prior one power of mu below
  the Gamma(a, b) that the ledger counts, as ``benchmarks/reference/
  ledger.py`` records; Delphy's source is not at hand to settle which is
  meant.  The truncated draw of 1 + 6 rho takes the first of a fixed row
  of scaled Gamma(M* + 1, 1) variates that is >= 1, and 1 where none is,
  where a rejection sampler would draw until one is.
- The root sequence is the first tip's with the mutations on its path to
  the root undone; mutations above the root (the reference sequence's
  deltas) do not enter.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

A, C, G, T = 0, 1, 2, 3
F64 = torch.float64


class PlainTree(NamedTuple):
    parent: torch.Tensor     # long[N], -1 at the root
    t: torch.Tensor          # f64[N]
    mut_node: torch.Tensor   # long[M]: the branch above this node
    mut_site: torch.Tensor   # long[M]
    mut_from: torch.Tensor   # long[M]
    mut_to: torch.Tensor     # long[M]
    mut_t: torch.Tensor      # f64[M]
    seq0: torch.Tensor       # long[L]: the first tip's sequence, A C G T 0-3
    nu: torch.Tensor         # f64[L]
    missing: torch.Tensor | None = None   # bool[T, L]: a tip's missing sites


def apobec_partition(seq) -> torch.Tensor:
    """Each site's partition (long[L]) by its APOBEC3 context in ``seq``."""
    s = [int(b) for b in torch.as_tensor(seq).tolist()]
    part = [0] * len(s)
    for i, b in enumerate(s):
        before_t = i > 0 and s[i - 1] == T and b in (C, T)
        after_a = i + 1 < len(s) and s[i + 1] == A and b in (G, A)
        part[i] = int(before_t or after_a)
    return torch.tensor(part, dtype=torch.long)


def mpox_q_tab(rho) -> torch.Tensor:
    """[Q_0, Q_1], f64[2, 4, 4]."""
    rho = float(rho)
    q0 = torch.full((4, 4), 1.0 / 3.0, dtype=F64)
    q0.fill_diagonal_(-1.0)
    q1 = q0.clone()
    for a, b in ((C, T), (G, A)):
        q1[a, b] += 2.0 * rho
        q1[a, a] -= 2.0 * rho
    return torch.stack([q0, q1])


def _pre_order(parent: torch.Tensor) -> list:
    """Nodes with every parent before its children."""
    par = parent.tolist()
    depth = []
    for n in range(len(par)):
        d, p = 0, par[n]
        while p >= 0:
            d, p = d + 1, par[p]
        depth.append(d)
    return sorted(range(len(par)), key=lambda n: depth[n])


def _present(tree: PlainTree, order: list) -> list:
    """present[n]: bool[L], the sites some tip below node n has."""
    par = tree.parent.tolist()
    N, L = len(par), tree.seq0.shape[0]
    T_ = (N + 1) // 2
    present = [None] * N
    for n in range(T_):
        present[n] = (torch.ones(L, dtype=torch.bool, device=tree.t.device)
                      if tree.missing is None else ~tree.missing[n])
    for n in reversed(order):
        if n < T_:
            continue
        kids = [present[c] for c in range(N) if par[c] == n]
        if len(kids) != 2:
            raise ValueError(f"inner node {n} has {len(kids)} children")
        present[n] = kids[0] | kids[1]
    return present


def _branch_mutations(tree: PlainTree) -> dict:
    """node -> [(t, site, from, to)] in time order."""
    out = {}
    cols = zip(tree.mut_node.tolist(), tree.mut_t.tolist(),
               tree.mut_site.tolist(), tree.mut_from.tolist(),
               tree.mut_to.tolist())
    for n, t, l, a, b in cols:
        out.setdefault(n, []).append((t, l, a, b))
    for ms in out.values():
        ms.sort()
    return out


def _walk(tree: PlainTree, part: torch.Tensor, rho):
    """Walk every branch from the root down: (M_beta_ab, Ttwiddle_beta_a,
    the sum over the mutations of log(nu_l Q_p[a, b]), the number of sites
    present below the root)."""
    par = tree.parent.tolist()
    root = par.index(-1)
    order = _pre_order(tree.parent)
    present = _present(tree, order)
    muts = _branch_mutations(tree)
    dev = tree.t.device
    part = part.long().to(dev)
    nu = tree.nu.to(F64)
    q_tab = mpox_q_tab(rho).to(dev)

    seq = tree.seq0.long().clone()
    n = 0
    while par[n] >= 0:
        for _t, l, a, b in reversed(muts.get(n, [])):
            if int(seq[l]) != b:
                raise ValueError(f"mutation at site {l} on node {n} does "
                                 f"not end in the state below it")
            seq[l] = a
        n = par[n]
    bottom = {root: seq}

    M_beta_ab = torch.zeros((2, 4, 4), dtype=torch.long, device=dev)
    Tt = torch.zeros((2, 4), dtype=F64, device=dev)
    log_rates = torch.zeros((), dtype=F64, device=dev)
    for n in order:
        if n == root:
            continue
        state = bottom[par[n]].clone()
        w = torch.where(present[n], nu, torch.zeros_like(nu))
        S = torch.zeros((2, 4), dtype=F64, device=dev)  # w by (part, state)
        for p in range(2):
            for a in range(4):
                S[p, a] = torch.sum(w[(part == p) & (state == a)])
        t_prev = float(tree.t[par[n]])
        for t_m, l, a, b in muts.get(n, []):
            if int(state[l]) != a:
                raise ValueError(f"mutation at site {l} on node {n} does "
                                 f"not start in the state above it")
            if not bool(present[n][l]):
                raise ValueError(f"mutation at site {l} on node {n}, "
                                 f"absent below it")
            Tt += S * (t_m - t_prev)
            p = int(part[l])
            M_beta_ab[p, a, b] += 1
            log_rates = log_rates + torch.log(nu[l] * q_tab[p, a, b])
            S[p, a] -= w[l]
            S[p, b] += w[l]
            state[l] = b
            t_prev = t_m
        Tt += S * (float(tree.t[n]) - t_prev)
        bottom[n] = state
    return M_beta_ab, Tt, log_rates, int(present[root].sum())


def statistics(tree: PlainTree, part: torch.Tensor) -> dict:
    """{"M_beta_ab": long[2, 4, 4], "Ttwiddle_beta_a": f64[2, 4], "M",
    "M_star" (M^1_CT + M^1_GA), "Tt" (the sum of Ttwiddle), "Tt_star"
    (Ttwiddle^1_C + Ttwiddle^1_G)} of the tree under partition table
    ``part``."""
    M_beta_ab, Tt, _, _ = _walk(tree, part, 0.0)
    return {"M_beta_ab": M_beta_ab, "Ttwiddle_beta_a": Tt,
            "M": int(M_beta_ab.sum()),
            "M_star": int(M_beta_ab[1, C, T] + M_beta_ab[1, G, A]),
            "Tt": float(Tt.sum()), "Tt_star": float(Tt[1, C] + Tt[1, G])}


def log_G(tree: PlainTree, part: torch.Tensor, mu, rho) -> float:
    """The explicit-mutation log-likelihood under the two partitions."""
    M_beta_ab, Tt, log_rates, n_root = _walk(tree, part, rho)
    mu = float(mu)
    qa = -torch.diagonal(mpox_q_tab(rho), dim1=1, dim2=2).to(Tt.device)
    log_root = n_root * torch.log(torch.tensor(0.25, dtype=F64))
    log_mu = torch.log(torch.tensor(mu, dtype=F64))
    return float(log_root + float(log_rates) + int(M_beta_ab.sum()) * log_mu
                 - mu * float(torch.sum(qa * Tt)))


def mpox_round(stats: dict, mu, rho, g_mu, g_rho_row,
               mu_prior_beta: float = 0.0):
    """One pseudo-Gibbs round: (mu, rho) after it.  mu = g_mu / (Tt + 2 rho
    Tt* + b); 1 + 6 rho is the first of ``g_rho_row`` / (mu Tt* / 3) that is
    >= 1, else 1; rho stays where Tt* is 0."""
    mu = float(g_mu) / (stats["Tt"] + 2.0 * float(rho) * stats["Tt_star"]
                        + mu_prior_beta)
    if stats["Tt_star"] <= 0.0:
        return mu, float(rho)
    k = 1.0
    for g in torch.as_tensor(g_rho_row, dtype=F64).tolist():
        scaled = g / (mu * stats["Tt_star"] / 3.0)
        if scaled >= 1.0:
            k = scaled
            break
    return mu, (k - 1.0) / 6.0
