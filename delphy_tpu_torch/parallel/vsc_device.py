"""Partition-decoupled (augmented) coalescent prior (port of
``delphy_tpu/parallel/vsc_device.py``; reference
core/very_scalable_coalescent.{h,cpp}).

Auxiliary Gaussian per-part cell fields, sampled at each boundary, break the
k_bar (k_bar - 1) coupling between parts, so each part's partial prior
depends only on its own lineage staircase k_p plus frozen field totals:

    partial_p = -sum_c (dt / Nbar_c) (0.5 kp_c^2 A_c - b_pc kp_c)
    b_pc      = ktp_pc A_c - kt_c + 0.5          (frozen during a sweep)

All arrays are [P, C] stacked per part.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.coalescent import k_bar_from_signs


class VscFields(NamedTuple):
    A: torch.Tensor    # float[C] number of active parts per cell (>= 1)
    b: torch.Tensor    # float[P, C] ktp A - kt + 0.5 (0 at inactive cells)
    k_p: torch.Tensor  # float[P, C] per-part lineage-count staircases


def calc_k_bar_signed(t, sign, t_lo, t_step, num_cells: int):
    """Per-part time-averaged lineage counts from node times and the
    partition signs of PartMaps.sign (part leaves +1, inner non-root -1,
    part root -2, or -1 for the run-root part, pads 0).  ``t`` and ``sign``
    may carry a leading part axis."""
    return k_bar_from_signs(t, sign.to(t.dtype), t_lo, t_step, num_cells)


def active_cells(part_t_lo, part_t_hi, t_lo, t_step, num_cells: int):
    """bool[P, C]: cells overlapping each part's reachable time range."""
    lb = t_lo + t_step * torch.arange(num_cells, dtype=t_lo.dtype,
                                      device=part_t_lo.device)
    return ((lb[None, :] <= part_t_hi[:, None])
            & (lb[None, :] + t_step > part_t_lo[:, None]))


def fields_from_normals(z, k_p, active, popsize_bar, t_step) -> VscFields:
    """Freeze the linear coefficients from standard normals ``z`` [P, C]:
    ktp ~ N(k_p - k/A, sqrt(Nbar / (A dt))) at active cells, 0 elsewhere."""
    A = torch.clamp(torch.sum(active, 0).to(k_p.dtype), min=1.0)
    k = torch.sum(k_p, 0)
    mu = k_p - (k / A)[None, :]
    sigma = torch.sqrt(popsize_bar / (A * t_step))[None, :]
    zero = torch.zeros((), dtype=k_p.dtype, device=k_p.device)
    ktp = torch.where(active, mu + sigma * z, zero)
    kt = torch.sum(ktp, 0)
    b = torch.where(active, ktp * A[None, :] - kt[None, :] + 0.5, zero)
    return VscFields(A=A, b=b, k_p=k_p)


def sample_fields(gen: torch.Generator, k_p, active, popsize_bar,
                  t_step) -> VscFields:
    """Sample the auxiliary Gaussians (very_scalable_coalescent.cpp:198-219)
    from the run's generator and freeze the linear coefficients."""
    z = torch.randn(k_p.shape, generator=gen, dtype=k_p.dtype,
                    device=k_p.device)
    return fields_from_normals(z, k_p, active, popsize_bar, t_step)


def partial_quad(k_p, b_p, A, popsize_bar, t_step):
    """One part's quadratic partial log prior, without the per-coalescence
    -log N point terms."""
    return -torch.sum((t_step / popsize_bar)
                      * (0.5 * k_p * k_p * A - b_p * k_p))
