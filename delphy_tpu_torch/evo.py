"""HKY85 substitution model, the evolution parameters and the mpox hack's
two-partition JC + APOBEC model (port of ``delphy_tpu/evo.py``).

Conventions as in the reference: q[a, b] (a != b) is the a->b rate, rows sum
to zero, q_a(a) = -q[a, a], and rates are normalised so that
sum_a pi_a q_a(a) = 1.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import DEFAULT_DEVICE, ITYPE, float_dtype, resolve_device, resolve_dtype

# Rate matrices are made on the device from index comparisons, not copied
# from host tables: a copy from the host synchronises the stream, and an
# mpox boundary, which makes its matrices, runs inside a CUDA graph's
# capture.


def hky_q(kappa, pi):
    """HKY85 rate matrix normalised as in the reference (evo_hky.cpp:7-50):
    q[a,b] = r[a,b] pi[b] / R with R = pi^T r pi, diagonal = -row sum;
    in the float dtype of ``pi`` (else of ``kappa``)."""
    dt = float_dtype(pi, kappa)
    pi = torch.as_tensor(pi, dtype=dt)
    kappa = torch.as_tensor(kappa, dtype=dt, device=pi.device)
    # transitions (A<->G, C<->T) are two states apart, transversions an odd
    # number of states
    a = torch.arange(4, device=pi.device)
    apart = (a[:, None] - a[None, :]).abs()
    r = (apart % 2 == 1).to(dt) + kappa * (apart == 2).to(dt)
    R = pi @ r @ pi
    q = r * pi[None, :] / R
    return q - torch.diag(torch.sum(q, dim=1))


class EvoParams(NamedTuple):
    """Evolution-model parameters (field layout of the reference's
    EvoParams): ``part`` [L] is each site's partition and ``q_tab`` [P, 4, 4]
    the partitions' rate matrices (P = 1 unless the mpox hack's two-partition
    APOBEC model is on); ``mpox_rho`` is mu_star / mu (0 when it is off)."""
    mu: torch.Tensor
    kappa: torch.Tensor
    pi: torch.Tensor
    q: torch.Tensor
    alpha: torch.Tensor
    nu: torch.Tensor
    part: torch.Tensor
    q_tab: torch.Tensor
    mpox_rho: torch.Tensor

    @property
    def q_a(self):
        """Escape rates q_a(a) = -q[a,a], shape [4]."""
        return -torch.diagonal(self.q)

    @property
    def qa_tab(self):
        """Per-partition escape rates, shape [P, 4]."""
        return -torch.diagonal(self.q_tab, dim1=1, dim2=2)

    @property
    def num_partitions(self) -> int:
        return self.q_tab.shape[0]

    def with_mpox_rho(self, mu=None, rho=None) -> "EvoParams":
        """Refresh the two-partition APOBEC rate tables (reference
        derive_evo, run.cpp:400-433)."""
        dev, dt = self.q_tab.device, self.q_tab.dtype
        mu = self.mu if mu is None else torch.as_tensor(mu, dtype=dt,
                                                        device=dev)
        rho = self.mpox_rho if rho is None else torch.as_tensor(
            rho, dtype=dt, device=dev)
        return self._replace(mu=mu, mpox_rho=rho, q_tab=mpox_q_tab(rho))


def make_evo_params(num_sites: int, mu=1e-3 / 365.0, kappa=1.0,
                    pi=(0.25, 0.25, 0.25, 0.25), alpha=10.0, part=None,
                    device=DEFAULT_DEVICE, dtype=None) -> EvoParams:
    """Parameters of a run's start, floats in ``resolve_dtype(dtype)``;
    ``part`` (per-site partition indices) defaults to one partition."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)

    def f(x):
        return torch.as_tensor(x, dtype=dtype, device=device)
    pi = f(pi)
    q = hky_q(f(kappa), pi)
    return EvoParams(
        mu=f(mu), kappa=f(kappa), pi=pi, q=q, alpha=f(alpha),
        nu=torch.ones(num_sites, dtype=dtype, device=device),
        part=(torch.zeros(num_sites, dtype=ITYPE, device=device)
              if part is None else torch.as_tensor(
                  np.asarray(part), dtype=ITYPE, device=device)),
        q_tab=q[None], mpox_rho=f(0.0))


# ---------------------------------------------------------------------------
# Mpox hack: two-partition JC + APOBEC model (reference run.h:134-178,
# run.cpp:359-433)
# ---------------------------------------------------------------------------


def jc_q(device=None, dtype=None):
    """Jukes-Cantor rate matrix (diagonal -1, off-diagonal 1/3): the bits of
    hky_q(1, uniform), whose R is 3/4 exactly."""
    eye = torch.eye(4, dtype=resolve_dtype(dtype), device=device)
    return (1.0 - eye) / 3.0 - eye


def mpox_q_tab(rho):
    """[Q_0, Q_1] with Q_0 = JC and Q_1 = Q_0 + APOBEC terms: C->T += 2 rho,
    G->A += 2 rho, diagonals balanced; rho = mu_star / mu.  The factors of 2
    follow the O'Toole et al convention (run.h:169-172)."""
    rho = torch.as_tensor(rho, dtype=float_dtype(rho))
    q0 = jc_q(rho.device, rho.dtype)
    A, C, G, T = 0, 1, 2, 3
    a = torch.arange(4, device=rho.device)
    src, dst = a[:, None], a[None, :]
    hit = ((src == C) & (dst == T)) | ((src == G) & (dst == A))
    apo = 2.0 * (hit.to(rho.dtype) - torch.diag(hit.any(1).to(rho.dtype)))
    return torch.stack([q0, q0 + rho * apo])


def apobec_context_partition(seq) -> np.ndarray:
    """Site partitions (int32 [L]) from APOBEC context in a tip sequence:
    partition 1 iff (seq[l-1] == T and seq[l] in {C, T}) or
    (seq[l+1] == A and seq[l] in {G, A}) (reference run.cpp:366-383)."""
    seq = np.asarray(seq)
    A, C, G, T = 0, 1, 2, 3
    ctx = np.zeros(len(seq), dtype=bool)
    ctx[1:] |= (seq[:-1] == T) & ((seq[1:] == C) | (seq[1:] == T))
    ctx[:-1] |= (seq[1:] == A) & ((seq[:-1] == G) | (seq[:-1] == A))
    return ctx.astype(np.int32)
