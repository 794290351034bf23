"""Time-discretised Kingman coalescent prior on a dense cell grid (port of
``delphy_tpu/ops/coalescent.py``; reference
core/scalable_coalescent.{h,cpp}).

C cells cover [t_lo, t_lo + C t_step); k_bar is the time-averaged lineage
count per cell, rebuilt from scratch in O(N + C) by one scatter-add and a
reverse cumulative sum."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import pop as popm
from .likelihood import add_at


class CoalGrid(NamedTuple):
    t_lo: torch.Tensor         # float scalar: lower bound of cell 0
    t_step: torch.Tensor       # float scalar
    k_bar: torch.Tensor        # float[C] (the run's float dtype)
    popsize_bar: torch.Tensor  # float[C]

    @property
    def num_cells(self) -> int:
        return self.k_bar.shape[0]

    def cell_lbounds(self):
        return self.t_lo + self.t_step * torch.arange(
            self.num_cells, dtype=self.k_bar.dtype, device=self.k_bar.device)


def calc_popsize_bars(pop_params, t_lo, t_step, num_cells: int):
    """popsize_bar[c] = (1/dt) int_cell N dt, floored at 1e-100."""
    lb = t_lo + t_step * torch.arange(num_cells, dtype=t_lo.dtype,
                                      device=t_lo.device)
    vals = popm.pop_integral(pop_params, lb, lb + t_step) / t_step
    return torch.clamp(vals, min=1e-100)


def calc_k_bar(t, is_tip, t_lo, t_step, num_cells: int):
    """Time-averaged lineage counts per cell, from scratch."""
    sign = torch.where(is_tip, 1.0, -1.0).to(t.dtype)
    return k_bar_from_signs(t, sign, t_lo, t_step, num_cells)


def k_bar_from_signs(t, sign, t_lo, t_step, num_cells: int):
    """k_bar for nodes with lineage signs ``sign`` (the last axis is the node
    axis; leading axes are batched).  Node i adds sign_i to every cell wholly
    before t_i and sign_i * frac to its own cell."""
    rel = (t - t_lo) / t_step
    cell = torch.floor(rel)
    in_grid = (cell >= 0) & (cell < num_cells)
    frac = rel - cell
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    cl = cell.clamp(0, num_cells - 1).long()
    shape = t.shape[:-1] + (num_cells,)
    # cells of the flattened (..., num_cells) rows; add_at sums in a fixed
    # order on the card (scatter_add_'s atomics do not)
    row = torch.arange(cl.numel() // cl.shape[-1], device=t.device)
    flat = (row.reshape(cl.shape[:-1] + (1,)) * num_cells + cl).reshape(-1)
    zeros = torch.zeros(math.prod(shape), dtype=t.dtype, device=t.device)
    k_frac = add_at(zeros, flat, torch.where(in_grid, sign * frac, zero)
                    .reshape(-1)).reshape(shape)
    counts = add_at(zeros, flat, torch.where(in_grid, sign, zero)
                    .reshape(-1)).reshape(shape)
    above = torch.sum(torch.where(cell >= num_cells, sign, zero), -1,
                      keepdim=True)
    rev_cum = torch.flip(torch.cumsum(torch.flip(counts, [-1]), -1), [-1])
    return above + rev_cum - counts + k_frac


def make_grid(pop_params, t, is_tip, t_lo, t_step, num_cells: int) -> CoalGrid:
    return CoalGrid(t_lo=t_lo, t_step=t_step,
                    k_bar=calc_k_bar(t, is_tip, t_lo, t_step, num_cells),
                    popsize_bar=calc_popsize_bars(pop_params, t_lo, t_step,
                                                  num_cells))


def calc_log_prior(grid: CoalGrid, pop_params, t, is_tip):
    """-sum_c dt k_bar (k_bar - 1) / (2 N_bar) - sum_coal log N(t_i)."""
    quad = -torch.sum(grid.t_step * grid.k_bar * (grid.k_bar - 1.0)
                      / (2.0 * grid.popsize_bar))
    logN = torch.log(popm.pop_at_time(pop_params, t))
    return quad - torch.sum(torch.where(is_tip, torch.zeros_like(logN), logN))


def displace_delta(grid: CoalGrid, pop_params, old_t, new_t, node_is_tip):
    """(delta_log_prior, new_k_bar) for one node displacement, O(C).

    ``old_t`` and ``new_t`` hold one time each (0-d or shape [1]).  A tip
    (``node_is_tip``, a bool or a bool tensor of one element) moves lineage
    mass with sign +1, a coalescence with sign -1, and only a coalescence
    carries the -log N(t) point term (scalable_coalescent.cpp:118-138,
    189-251)."""
    lb = grid.cell_lbounds()
    frac_old = torch.clamp((old_t - lb) / grid.t_step, 0.0, 1.0)
    frac_new = torch.clamp((new_t - lb) / grid.t_step, 0.0, 1.0)
    dlogN = -(torch.log(popm.pop_at_time(pop_params, new_t))
              - torch.log(popm.pop_at_time(pop_params, old_t)))
    if isinstance(node_is_tip, torch.Tensor):
        sign = torch.where(node_is_tip, 1.0, -1.0).to(lb.dtype)
        delta_logN = torch.where(node_is_tip, torch.zeros_like(dlogN), dlogN)
    else:
        sign = 1.0 if node_is_tip else -1.0
        delta_logN = torch.zeros_like(dlogN) if node_is_tip else dlogN
    dk = sign * (frac_new - frac_old)
    k = grid.k_bar
    delta_quad = -torch.sum(grid.t_step * ((k + dk) * (k + dk - 1.0)
                                           - k * (k - 1.0))
                            / (2.0 * grid.popsize_bar))
    return delta_quad + delta_logN, k + dk
