"""HKY85 substitution model and the evolution parameters (port of
``delphy_tpu/evo.py``, single-partition HKY only).

Conventions as in the reference: q[a, b] (a != b) is the a->b rate, rows sum
to zero, q_a(a) = -q[a, a], and rates are normalised so that
sum_a pi_a q_a(a) = 1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import DEFAULT_DEVICE, DTYPE, ITYPE, resolve_device

# transition (A<->G, C<->T) and transversion indicator matrices
_TRANSITION = [[0.0, 0.0, 1.0, 0.0],
               [0.0, 0.0, 0.0, 1.0],
               [1.0, 0.0, 0.0, 0.0],
               [0.0, 1.0, 0.0, 0.0]]
_TRANSVERSION = [[0.0, 1.0, 0.0, 1.0],
                 [1.0, 0.0, 1.0, 0.0],
                 [0.0, 1.0, 0.0, 1.0],
                 [1.0, 0.0, 1.0, 0.0]]


def hky_q(kappa, pi):
    """HKY85 rate matrix normalised as in the reference (evo_hky.cpp:7-50):
    q[a,b] = r[a,b] pi[b] / R with R = pi^T r pi, diagonal = -row sum."""
    pi = torch.as_tensor(pi, dtype=DTYPE)
    kappa = torch.as_tensor(kappa, dtype=DTYPE, device=pi.device)
    r = (torch.tensor(_TRANSVERSION, dtype=DTYPE, device=pi.device)
         + kappa * torch.tensor(_TRANSITION, dtype=DTYPE, device=pi.device))
    R = pi @ r @ pi
    q = r * pi[None, :] / R
    return q - torch.diag(torch.sum(q, dim=1))


class EvoParams(NamedTuple):
    """Evolution-model parameters (field layout of the reference's
    EvoParams; ``part``/``q_tab`` keep one partition)."""
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


def make_evo_params(num_sites: int, mu=1e-3 / 365.0, kappa=1.0,
                    pi=(0.25, 0.25, 0.25, 0.25), alpha=10.0,
                    device=DEFAULT_DEVICE) -> EvoParams:
    device = resolve_device(device)

    def f(x):
        return torch.as_tensor(x, dtype=DTYPE, device=device)
    pi = f(pi)
    q = hky_q(f(kappa), pi)
    return EvoParams(
        mu=f(mu), kappa=f(kappa), pi=pi, q=q, alpha=f(alpha),
        nu=torch.ones(num_sites, dtype=DTYPE, device=device),
        part=torch.zeros(num_sites, dtype=ITYPE, device=device),
        q_tab=q[None], mpox_rho=f(0.0))
