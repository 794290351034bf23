"""Exponential effective-population-size model with the min_pop floor
(port of the exponential half of ``delphy_tpu/pop.py``; reference
core/pop_model.cpp:22-145).  All functions broadcast over their time
arguments."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class ExpPopParams(NamedTuple):
    t0: torch.Tensor
    n0: torch.Tensor        # pop at t0 (> 0)
    g: torch.Tensor         # growth rate [1/day]
    min_pop: torch.Tensor   # floor (>= 0); reference default 1.0

    @property
    def t_c(self):
        """Crossover time where n0*exp(g*(t-t0)) == min_pop; -inf (g > 0) or
        +inf (g <= 0) when there is no crossing."""
        safe_g = torch.where(self.g == 0.0, torch.ones_like(self.g), self.g)
        tc = self.t0 + torch.log(self.min_pop / self.n0) / safe_g
        no_cross = (self.min_pop <= 0.0) | (self.g == 0.0)
        inf = torch.full_like(tc, math.inf)
        return torch.where(no_cross, torch.where(self.g > 0.0, -inf, inf), tc)


def exp_pop_at_time(p: ExpPopParams, t):
    return torch.maximum(p.min_pop, p.n0 * torch.exp((t - p.t0) * p.g))


def _exp_unclamped_pop_integral(p: ExpPopParams, a, b):
    # int_a^b n0 exp(g (t - t0)) dt, stable for g -> 0
    g = p.g
    safe_g = torch.where(g == 0.0, torch.ones_like(g), g)
    val = p.n0 / safe_g * torch.exp(safe_g * (a - p.t0)) \
        * torch.expm1(safe_g * (b - a))
    return torch.where(g == 0.0, (b - a) * p.n0, val)


def exp_pop_integral(p: ExpPopParams, a, b):
    """int_a^b N dt with the min_pop floor (pop_model.cpp:43-91)."""
    tc = p.t_c
    lo_c = torch.minimum(torch.maximum(tc, a), b)   # split point
    pos = p.g > 0.0
    clamped = torch.where(pos, lo_c - a, b - lo_c)
    un_a = torch.where(pos, lo_c, a)
    un_b = torch.where(pos, b, lo_c)
    base = clamped * p.min_pop + _exp_unclamped_pop_integral(p, un_a, un_b)
    const_val = (b - a) * torch.maximum(p.min_pop, p.n0)
    return torch.where((p.g == 0.0) & (p.min_pop > 0.0), const_val, base)


def pop_at_time(p, t):
    if not isinstance(p, ExpPopParams):
        raise TypeError(f"unsupported population model {type(p).__name__}")
    return exp_pop_at_time(p, t)


def pop_integral(p, a, b):
    if not isinstance(p, ExpPopParams):
        raise TypeError(f"unsupported population model {type(p).__name__}")
    return exp_pop_integral(p, a, b)
