"""Faults planted under the timed path, for the check that the comparison
fails each one: on the CPU in ``test_bench_control.py``, and on the card at
a cell's own size in ``chip_faults.py``.

Each fault is a function of the original that returns its stand-in;
``FAULTS`` names each with the module attribute of the program it replaces,
and ``MPOX_FAULTS`` those of the mpox model, which only a cell that runs it
can have.
"""

from __future__ import annotations

import functools
import importlib
from contextlib import contextmanager

import torch


def unchanged(orig):
    """The dispatch does its work and reports it, but hands back the state
    it was given."""
    @functools.wraps(orig)
    def f(*a, **k):
        out = orig(*a, **k)
        return (a[0], a[1], a[2], out[3], out[4], None)
    return f


def root_moved(orig):
    """The dispatch's answer altered where it is produced: the root one day
    earlier than the state the ledger describes."""
    @functools.wraps(orig)
    def f(*a, **k):
        ts, evo, pop, led, stats, _fused = orig(*a, **k)
        t = ts.t.clone()
        t[ts.root.long()] -= 1.0
        return (ts._replace(t=t), evo, pop, led, stats, None)
    return f


def mutation_altered(orig):
    """The dispatch's answer altered where it is produced: one mutation's
    time moved to the middle of its branch."""
    @functools.wraps(orig)
    def f(*a, **k):
        ts, evo, pop, led, stats, _fused = orig(*a, **k)
        real = ((ts.mut_node >= 0) & (ts.mut_node != ts.root)).nonzero()
        if real.numel() == 0:
            return ts, evo, pop, led, stats, None
        j = int(real[0, 0])
        n = int(ts.mut_node[j])
        mid = 0.5 * (ts.t[n] + ts.t[int(ts.parent[n])])
        mut_t = ts.mut_t.clone()
        mut_t[j] = mid
        return (ts._replace(mut_t=mut_t), evo, pop, led, stats, None)
    return f


def half_log_G(orig):
    """Half of the batch left out: the likelihood over the first half of
    the branches, doubled, as the mean over the rest."""
    from delphy_tpu_torch.ops import likelihood as lk

    @functools.wraps(orig)
    def f(ts, evo, lambda_i, root_freq):
        N = ts.num_nodes
        n = torch.arange(N, device=lambda_i.device)
        keep = (n < N // 2) & (n != ts.root)
        zero = torch.zeros((), dtype=lambda_i.dtype, device=lambda_i.device)
        parent = ts.parent.clamp(min=0).long()
        branch = torch.where(keep, -lambda_i * (ts.t - ts.t[parent]), zero)
        node = ts.mut_node.clamp(min=0).long()
        real = (ts.mut_node >= 0) & keep[node]
        site = ts.mut_site.clamp(min=0).long()
        munu = evo.mu * evo.nu[site]
        mf, mt = ts.mut_from.clamp(min=0).long(), ts.mut_to.clamp(min=0).long()
        qa = evo.qa_tab[0]
        per = torch.log(torch.where(real, munu * evo.q_tab[0, mf, mt],
                                    zero + 1.0)) \
            - munu * (qa[mf] - qa[mt]) * (ts.mut_t - ts.t[parent[node]])
        muts = torch.where(real, per, zero)
        return (lk.calc_log_root_prior(root_freq, evo)
                + 2.0 * (torch.sum(branch) + torch.sum(muts)))
    return f


def _sweep_rows_left(orig, first_left):
    """The sweep kernel leaves part rows ``first_left(P)``.. as it found
    them and reports no change of log_G or log_coal for them, but counts
    their moves: the ledger stays true to the tree, and the step count to
    the work asked for."""
    @functools.wraps(orig)
    def f(stat, n_blocks, ctx_arrs, shared, u):
        t, mut_t, k_p, dG, dC, cnt = orig(stat, n_blocks, ctx_arrs, shared, u)
        P = t.shape[0]
        left = torch.arange(P, device=t.device) >= first_left(P)
        rows = left.view(P, 1, 1)
        t = torch.where(rows, ctx_arrs["t"].reshape(t.shape).to(t.dtype), t)
        mut_t = torch.where(rows, ctx_arrs["mut_t"].reshape(
            mut_t.shape).to(mut_t.dtype), mut_t)
        zero = torch.zeros_like(dG)
        return (t, mut_t, k_p, torch.where(left, zero, dG),
                torch.where(left, zero, dC), cnt)
    return f


def sweep_skipped(orig):
    """The local sweep moves nothing: every part left as it was."""
    return _sweep_rows_left(orig, lambda P: 0)


def sweep_half_parts(orig):
    """Half of the batch left out: the sweep moves the first half of the
    parts only."""
    return _sweep_rows_left(orig, lambda P: P // 2)


def partition_flipped(orig):
    """The program's partition table with its first APOBEC3-context site
    put in partition 0."""
    @functools.wraps(orig)
    def f(seq):
        part = orig(seq).copy()
        part[int(part.argmax())] = 0
        return part
    return f


def rho_off(orig):
    """The dispatch reports rho one part in 10^6 above the rho its ledger
    was worked out with."""
    @functools.wraps(orig)
    def f(*a, **k):
        ts, evo, pop, led, stats, _fused = orig(*a, **k)
        evo = evo._replace(mpox_rho=evo.mpox_rho * (1.0 + 1e-6))
        return (ts, evo, pop, led, stats, None)
    return f


def rho_unmoved(orig):
    """The mpox rounds move mu and leave rho where they found it."""
    @functools.wraps(orig)
    def f(gen, evo, *a, **k):
        return orig(gen, evo, *a, **k).with_mpox_rho(rho=evo.mpox_rho)
    return f


FAULTS = {
    "unchanged": (unchanged, "run.parts_multi_super_step"),
    "root_moved": (root_moved, "run.parts_multi_super_step"),
    "mutation_altered": (mutation_altered, "run.parts_multi_super_step"),
    "half_log_G": (half_log_G, "ops.likelihood.calc_log_G"),
    "sweep_skipped": (sweep_skipped, "parallel.block_cuda.sweep_chain_kernel"),
    "sweep_half_parts": (sweep_half_parts,
                         "parallel.block_cuda.sweep_chain_kernel"),
}

MPOX_FAULTS = {
    "partition_flipped": (partition_flipped, "run.apobec_context_partition"),
    "rho_off": (rho_off, "run.parts_multi_super_step"),
    "rho_unmoved": (rho_unmoved, "mcmc.global_moves.mpox_hack_moves"),
}
ALL_FAULTS = {**FAULTS, **MPOX_FAULTS}


@contextmanager
def planted(name: str):
    """The program with fault ``name`` in place of its target."""
    fault, target = ALL_FAULTS[name]
    mod_name, attr = target.rsplit(".", 1)
    mod = importlib.import_module("delphy_tpu_torch." + mod_name)
    orig = getattr(mod, attr)
    setattr(mod, attr, fault(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)
