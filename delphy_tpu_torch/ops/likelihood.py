"""EMAT likelihood over the flat pools (port of
``delphy_tpu/ops/likelihood.py``; sites may fall into several partitions,
each with its rate matrix, ``evo.part`` and ``evo.q_tab``).

Per-branch quantities are scatter-adds over the mutation and missation pools
keyed by branch, root-to-node sums are pointer-jumping path sums and subtree
sums are Euler-tour prefix sums, exactly as in the reference package.  Every
scatter routes free (``-1``) slots to index 0 with a zero weight, so no index
is ever out of range.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..evo import EvoParams
from ..state import TreeState


def _num_doubling_iters(n: int) -> int:
    return max(1, math.ceil(math.log2(max(n, 2))))


def _c0(idx):
    """Index clamped at 0 (free slots point at entry 0 with zero weight)."""
    return idx.clamp(min=0).long()


def add_at(x, idx, vals):
    """x with vals added at the entries idx of its first axis.  On the card
    the accumulating index_put, which sorts the indices and sums each
    entry's values in a fixed order; index_add's float atomics sum them in
    whatever order the threads arrive, so a run would not repeat itself
    bit for bit (nor resume from a snapshot exactly).  index_add on the
    CPU."""
    if x.is_cuda:
        return x.index_put((idx,), vals, accumulate=True)
    return x.index_add(0, idx, vals)


def cumsum0(x):
    """torch.cumsum(x, 0) of a 1-D x, in a fixed order on the card: CUDA
    scans a 1-D tensor in tiles combined in whatever order they finish, so
    a long float scan does not repeat itself bit for bit.  Taken along the
    first axis of an (n, 2) tensor it is a sequential scan per column, the
    CPU's order."""
    if not x.is_cuda:
        return torch.cumsum(x, 0)
    return torch.cumsum(torch.stack([x, x], 1), 0)[:, 0]


def _scatter_add(n: int, idx, vals):
    return add_at(torch.zeros(n, dtype=vals.dtype, device=vals.device),
                  _c0(idx), vals)


def path_sums(parent, delta):
    """result[i] = sum of delta over the path root..i, both ends included."""
    acc = delta
    p = parent.long()
    for _ in range(_num_doubling_iters(parent.shape[0])):
        has = p >= 0
        safe_p = p.clamp(min=0)
        acc = acc + torch.where(has, acc[safe_p], torch.zeros_like(acc))
        p = torch.where(has, p[safe_p], torch.full_like(p, -1))
    return acc


def calc_ref_cum_Q(ts: TreeState, evo: EvoParams):
    """cum_Q[k] = sum_{l<k} mu nu_l q_a(ref_l); length L+1."""
    site_Q = evo.mu * evo.nu * evo.qa_tab[evo.part.long(), ts.ref_seq.long()]
    return torch.cat([torch.zeros(1, dtype=site_Q.dtype, device=site_Q.device),
                      cumsum0(site_Q)])


def calc_ref_state_prefix(ts: TreeState, evo: EvoParams):
    """cnt[a, k] = #{l < k : ref_l == a}; nucum[a, k] = sum of nu_l over the
    same sites.  Both float[4, L+1] in the dtype of ``evo.nu``."""
    onehot = F.one_hot(ts.ref_seq.long(), 4).to(evo.nu.dtype).T
    zeros = torch.zeros((4, 1), dtype=onehot.dtype, device=onehot.device)
    cnt = torch.cat([zeros, torch.cumsum(onehot, 1)], 1)
    nucum = torch.cat([zeros, torch.cumsum(onehot * evo.nu[None, :], 1)], 1)
    return cnt, nucum


def calc_branch_delta_lambda(ts: TreeState, evo: EvoParams, ref_cum_Q):
    """(dlam_total[n], dlam_miss[n]): change of the mutation intensity
    across each branch (phylo_tree_calc.h:140-155)."""
    N = ts.num_nodes
    qa_tab = evo.qa_tab
    zero = torch.zeros((), dtype=ref_cum_Q.dtype, device=ref_cum_Q.device)

    mpart = evo.part[_c0(ts.mut_site)].long()
    contrib = evo.mu * evo.nu[_c0(ts.mut_site)] * (
        qa_tab[mpart, _c0(ts.mut_to)] - qa_tab[mpart, _c0(ts.mut_from)])
    dlam_mut = _scatter_add(N, ts.mut_node,
                            torch.where(ts.mut_node >= 0, contrib, zero))

    iv_contrib = -(ref_cum_Q[_c0(ts.miss_end)] - ref_cum_Q[_c0(ts.miss_start)])
    dlam_miss = _scatter_add(N, ts.miss_node,
                             torch.where(ts.miss_node >= 0, iv_contrib, zero))

    fsite = _c0(ts.fs_site)
    ref_at = ts.ref_seq[fsite].long()
    fpart = evo.part[fsite].long()
    fs_contrib = -evo.mu * evo.nu[fsite] * (
        qa_tab[fpart, _c0(ts.fs_from)] - qa_tab[fpart, ref_at])
    dlam_miss = add_at(dlam_miss, _c0(ts.fs_node),
                       torch.where(ts.fs_node >= 0, fs_contrib, zero))
    return dlam_mut + dlam_miss, dlam_miss


def calc_lambda_i(ts: TreeState, evo: EvoParams, ref_cum_Q):
    """(lambda_i, dlam_miss): mutation intensity of the sequence just above
    each node (phylo_tree_calc.cpp:420-436)."""
    dlam, dlam_miss = calc_branch_delta_lambda(ts, evo, ref_cum_Q)
    return ref_cum_Q[-1] + path_sums(ts.parent, dlam), dlam_miss


def calc_root_state_frequencies(ts: TreeState, evo: EvoParams, cnt_prefix):
    """State counts of the root sequence over its non-missing sites."""
    freq = cnt_prefix[:, -1]
    zero = torch.zeros((), dtype=freq.dtype, device=freq.device)
    one = torch.ones((), dtype=freq.dtype, device=freq.device)
    is_root_mut = ts.mut_node == ts.root
    d = _scatter_add(4, ts.mut_from, torch.where(is_root_mut, -one, zero))
    d = add_at(d, _c0(ts.mut_to), torch.where(is_root_mut, one, zero))

    is_root_iv = ts.miss_node == ts.root
    iv_counts = (cnt_prefix[:, _c0(ts.miss_end)]
                 - cnt_prefix[:, _c0(ts.miss_start)])          # [4, K]
    d = d - torch.sum(torch.where(is_root_iv[None, :], iv_counts, zero), 1)

    is_root_fs = ts.fs_node == ts.root
    ref_at = ts.ref_seq[_c0(ts.fs_site)].long()
    d = add_at(d, ref_at, torch.where(is_root_fs, one, zero))
    d = add_at(d, _c0(ts.fs_from), torch.where(is_root_fs, -one, zero))
    return freq + d


def calc_log_root_prior(root_freq, evo: EvoParams):
    pos = evo.pi > 0.0
    log_pi = torch.where(pos, torch.log(torch.where(pos, evo.pi,
                                                    torch.ones_like(evo.pi))),
                         torch.full_like(evo.pi, -math.inf))
    terms = torch.where(root_freq != 0.0, root_freq * log_pi,
                        torch.zeros_like(root_freq))
    return torch.sum(terms)


def calc_log_G(ts: TreeState, evo: EvoParams, lambda_i, root_freq):
    """Augmented genetic log-likelihood: root prior + branch terms
    (phylo_tree_calc.cpp:506-558)."""
    N = ts.num_nodes
    n = torch.arange(N, device=lambda_i.device)
    safe_parent = _c0(ts.parent)
    zero = torch.zeros((), dtype=lambda_i.dtype, device=lambda_i.device)
    branch_terms = torch.where(n != ts.root,
                               -lambda_i * (ts.t - ts.t[safe_parent]), zero)

    real = (ts.mut_node >= 0) & (ts.mut_node != ts.root)
    site = _c0(ts.mut_site)
    mpart = evo.part[site].long()
    munu = evo.mu * evo.nu[site]
    mfrom, mto = _c0(ts.mut_from), _c0(ts.mut_to)
    rate_ab = evo.q_tab[mpart, mfrom, mto]
    t_P = ts.t[safe_parent[_c0(ts.mut_node)]]
    qa_tab = evo.qa_tab
    slope = munu * (qa_tab[mpart, mfrom] - qa_tab[mpart, mto])
    per_mut = torch.log(torch.where(real, munu * rate_ab, zero + 1.0)) \
        - slope * (ts.mut_t - t_P)
    mut_terms = torch.where(real, per_mut, zero)
    return (calc_log_root_prior(root_freq, evo) + torch.sum(branch_terms)
            + torch.sum(mut_terms))


def calc_num_muts(ts: TreeState):
    real = (ts.mut_node >= 0) & (ts.mut_node != ts.root)
    return torch.sum(real.to(torch.int64))


def calc_num_muts_ab(ts: TreeState):
    real = (ts.mut_node >= 0) & (ts.mut_node != ts.root)
    idx = _c0(ts.mut_from) * 4 + _c0(ts.mut_to)
    return _scatter_add(16, idx, real.to(torch.int64)).reshape(4, 4)


def calc_num_muts_beta_ab(ts: TreeState, evo: EvoParams):
    """Mutation counts per (partition, from, to), i64[P, 4, 4] (reference
    calc_num_muts_beta_ab; the mpox hack's mu/rho moves read it)."""
    P = evo.q_tab.shape[0]
    real = (ts.mut_node >= 0) & (ts.mut_node != ts.root)
    mpart = evo.part[_c0(ts.mut_site)].long()
    idx = mpart * 16 + _c0(ts.mut_from) * 4 + _c0(ts.mut_to)
    return _scatter_add(P * 16, idx, real.to(torch.int64)).reshape(P, 4, 4)


def calc_num_muts_l(ts: TreeState):
    """Mutation count per site, i64[L]."""
    real = (ts.mut_node >= 0) & (ts.mut_node != ts.root)
    return _scatter_add(ts.num_sites, ts.mut_site, real.to(torch.int64))


def _at_root(x, ts: TreeState):
    """x[root] as a one-element tensor, broadcast like a scalar: a 0-d
    index tensor would read the index back to the host."""
    return x[ts.root.long().reshape(1)]


def calc_T_below(ts: TreeState, tin, tout):
    """Total branch length strictly below each node (Euler-tour prefix
    sums)."""
    N = ts.num_nodes
    n = torch.arange(N, device=ts.t.device)
    blen = torch.where(n != ts.root, ts.t - ts.t[_c0(ts.parent)],
                       torch.zeros_like(ts.t))
    tin = tin.long()
    vals = torch.zeros(N, dtype=ts.t.dtype, device=ts.t.device)
    vals[tin] = blen
    pref = cumsum0(vals)
    return pref[(tout.long() - 1).clamp(min=0)] - pref[tin]


def _mut_T_below(ts: TreeState, T_below):
    node = _c0(ts.mut_node)
    is_root = ts.mut_node == ts.root
    return T_below[node] + torch.where(is_root, torch.zeros_like(ts.mut_t),
                                       ts.t[node] - ts.mut_t)


def _miss_T_below(ts: TreeState, T_below, node_arr):
    node = _c0(node_arr)
    is_root = node_arr == ts.root
    safe_parent = _c0(ts.parent[node])
    br = ts.t[node] - ts.t[safe_parent]
    return T_below[node] + torch.where(is_root, torch.zeros_like(br), br)


def calc_Ttwiddle_a(ts: TreeState, evo: EvoParams, tin, tout, nu_prefix):
    """Ttwiddle_a[a] = sum_l nu_l T^(l)_a (phylo_tree_calc.cpp:224-369):
    start from every site spending the whole tree length in its reference
    state, then correct per mutation and missation.  ``nu_prefix`` is
    calc_ref_state_prefix()[1]."""
    T_below = calc_T_below(ts, tin, tout)
    tw = nu_prefix[:, -1] * _at_root(T_below, ts)
    zero = torch.zeros((), dtype=tw.dtype, device=tw.device)

    Tb_mut = _mut_T_below(ts, T_below)
    w = torch.where(ts.mut_node >= 0, evo.nu[_c0(ts.mut_site)] * Tb_mut, zero)
    tw = add_at(tw, _c0(ts.mut_from), -w)
    tw = add_at(tw, _c0(ts.mut_to), w)

    Tb_iv = _miss_T_below(ts, T_below, ts.miss_node)
    nu_in_iv = (nu_prefix[:, _c0(ts.miss_end)]
                - nu_prefix[:, _c0(ts.miss_start)])             # [4, K]
    tw = tw - torch.sum(torch.where((ts.miss_node >= 0)[None, :],
                                    nu_in_iv * Tb_iv[None, :], zero), 1)

    Tb_fs = _miss_T_below(ts, T_below, ts.fs_node)
    site = _c0(ts.fs_site)
    wf = torch.where(ts.fs_node >= 0, evo.nu[site] * Tb_fs, zero)
    tw = add_at(tw, ts.ref_seq[site].long(), wf)
    tw = add_at(tw, _c0(ts.fs_from), -wf)
    return tw


def calc_Ttwiddle_l(ts: TreeState, evo: EvoParams, tin, tout):
    """Ttwiddle^(l) = sum_a q_a T^(l)_a per site (phylo_tree_calc.cpp:
    176-222).  Missation intervals go through a difference array: +-T_below
    at the interval ends, a prefix sum over sites, times q_a(ref_l)."""
    L = ts.num_sites
    qa_tab = evo.qa_tab
    qa_ref = qa_tab[evo.part.long(), ts.ref_seq.long()]            # [L]
    T_below = calc_T_below(ts, tin, tout)
    tl = qa_ref * _at_root(T_below, ts)
    zero = torch.zeros((), dtype=tl.dtype, device=tl.device)

    Tb_mut = _mut_T_below(ts, T_below)
    site = _c0(ts.mut_site)
    mpart = evo.part[site].long()
    corr = torch.where(ts.mut_node >= 0,
                       (qa_tab[mpart, _c0(ts.mut_to)]
                        - qa_tab[mpart, _c0(ts.mut_from)]) * Tb_mut, zero)
    tl = add_at(tl, site, corr)

    ivalid = ts.miss_node >= 0
    Tb_iv = _miss_T_below(ts, T_below, ts.miss_node)
    diff = _scatter_add(L + 1, ts.miss_start, torch.where(ivalid, Tb_iv, zero))
    diff = add_at(diff, _c0(ts.miss_end),
                          torch.where(ivalid, -Tb_iv, zero))
    W = cumsum0(diff)[:L]   # total T_below of the intervals over l
    tl = tl - qa_ref * W

    Tb_fs = _miss_T_below(ts, T_below, ts.fs_node)
    fsite = _c0(ts.fs_site)
    fpart = evo.part[fsite].long()
    wf = torch.where(ts.fs_node >= 0, Tb_fs, zero)
    tl = add_at(tl, fsite, wf * qa_tab[fpart, ts.ref_seq[fsite].long()])
    return add_at(tl, fsite, -wf * qa_tab[fpart, _c0(ts.fs_from)])


def calc_ref_state_prefix_beta(ts: TreeState, evo: EvoParams):
    """nu-weighted prefix sums of reference states per partition:
    nucum_pa[p, a, k] = sum of nu_l over l < k with part_l == p and
    ref_l == a; float[P, 4, L+1]."""
    P = evo.q_tab.shape[0]
    comb = evo.part.long() * 4 + ts.ref_seq.long()
    onehot = F.one_hot(comb, P * 4).to(evo.nu.dtype).T             # [P*4, L]
    zeros = torch.zeros((P * 4, 1), dtype=onehot.dtype,
                        device=onehot.device)
    nucum = torch.cat([zeros, torch.cumsum(onehot * evo.nu[None, :], 1)], 1)
    return nucum.reshape(P, 4, -1)


def calc_Ttwiddle_beta_a(ts: TreeState, evo: EvoParams, tin, tout,
                         nu_prefix_pa):
    """Ttwiddle^beta_a[p, a] = sum over sites l of partition p of
    nu_l T^(l)_a (phylo_tree_calc.cpp:224-369); with one partition this is
    calc_Ttwiddle_a.  ``nu_prefix_pa`` is calc_ref_state_prefix_beta()."""
    P = evo.q_tab.shape[0]
    T_below = calc_T_below(ts, tin, tout)
    tw = (nu_prefix_pa[:, :, -1] * _at_root(T_below, ts)).reshape(-1)
    zero = torch.zeros((), dtype=tw.dtype, device=tw.device)

    Tb_mut = _mut_T_below(ts, T_below)
    site = _c0(ts.mut_site)
    mpart = evo.part[site].long()
    w = torch.where(ts.mut_node >= 0, evo.nu[site] * Tb_mut, zero)
    tw = add_at(tw, mpart * 4 + _c0(ts.mut_from), -w)
    tw = add_at(tw, mpart * 4 + _c0(ts.mut_to), w)

    Tb_iv = _miss_T_below(ts, T_below, ts.miss_node)
    flat = nu_prefix_pa.reshape(P * 4, -1)
    nu_in_iv = flat[:, _c0(ts.miss_end)] - flat[:, _c0(ts.miss_start)]
    tw = tw - torch.sum(torch.where((ts.miss_node >= 0)[None, :],
                                    nu_in_iv * Tb_iv[None, :], zero), 1)

    Tb_fs = _miss_T_below(ts, T_below, ts.fs_node)
    fsite = _c0(ts.fs_site)
    fpart = evo.part[fsite].long()
    wf = torch.where(ts.fs_node >= 0, evo.nu[fsite] * Tb_fs, zero)
    tw = add_at(tw, fpart * 4 + ts.ref_seq[fsite].long(), wf)
    tw = add_at(tw, fpart * 4 + _c0(ts.fs_from), -wf)
    return tw.reshape(P, 4)
