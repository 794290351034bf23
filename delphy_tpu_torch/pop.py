"""Effective-population-size models of the coalescent prior (port of
``delphy_tpu/pop.py``; reference core/pop_model.{h,cpp}): the exponential
model with the min_pop floor (pop_model.cpp:22-145) and the skygrid,
staircase or log-linear (pop_model.cpp:147-560).  Each model provides
pop_at_time(t), pop_integral(a, b) = int_a^b N dt and
intensity_integral(a, b) = int_a^b 1/N dt, broadcasting over their time
arguments; the skygrid functions put the knot axis last.

Host code (log writers, probers, the server) evaluates the same functions
on the CPU through ``host_eval``, from the numpy leaves of
``Run.host_view().pop``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from . import DTYPE

STAIRCASE = 1
LOG_LINEAR = 2


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


def _exp_unclamped_intensity_integral(p: ExpPopParams, a, b):
    g = p.g
    safe_g = torch.where(g == 0.0, torch.ones_like(g), g)
    val = -1.0 / (p.n0 * safe_g) * torch.exp(-safe_g * (a - p.t0)) \
        * torch.expm1(-safe_g * (b - a))
    return torch.where(g == 0.0, (b - a) / p.n0, val)


def exp_intensity_integral(p: ExpPopParams, a, b):
    """int_a^b 1/N dt with the min_pop floor (pop_model.cpp:93-145)."""
    tc = p.t_c
    lo_c = torch.minimum(torch.maximum(tc, a), b)
    pos = p.g > 0.0
    clamped = torch.where(pos, lo_c - a, b - lo_c)
    un_a = torch.where(pos, lo_c, a)
    un_b = torch.where(pos, b, lo_c)
    floor = p.min_pop > 0.0
    inv_min = torch.where(
        floor, 1.0 / torch.where(floor, p.min_pop,
                                 torch.ones_like(p.min_pop)),
        torch.zeros_like(p.min_pop))
    base = clamped * inv_min + _exp_unclamped_intensity_integral(p, un_a, un_b)
    const_val = (b - a) / torch.maximum(p.min_pop, p.n0)
    return torch.where((p.g == 0.0) & floor, const_val, base)


@dataclasses.dataclass(frozen=True)
class SkygridPopParams:
    """Skygrid knots and log-population values; ``type`` is static (it picks
    the code path), the three tensors are the record's leaves."""
    x: torch.Tensor       # knot times, shape [M+1], strictly increasing
    gamma: torch.Tensor   # log N at knots, shape [M+1]
    type: int             # STAIRCASE or LOG_LINEAR
    tau: torch.Tensor = 1.0  # GMRF precision

    def tree_flatten(self):
        return (self.x, self.gamma, self.tau), self.type

    @classmethod
    def tree_unflatten(cls, aux, children):
        x, gamma, tau = children
        return cls(x=x, gamma=gamma, type=int(aux), tau=tau)

    def _replace(self, **kw):
        return dataclasses.replace(self, **kw)


def skygrid_log_N(p: SkygridPopParams, t):
    """log N(t) (pop_model.cpp:181-200): k = searchsorted(x, t, left) picks
    the interval; gamma[0] before x_0 and gamma[M] after x_M."""
    x, gamma = p.x, p.gamma
    t = torch.as_tensor(t, dtype=DTYPE, device=x.device)
    M = x.shape[0] - 1
    k = torch.searchsorted(x, t.reshape(-1), right=False).reshape(t.shape)
    if p.type == STAIRCASE:
        return gamma[k.clamp(max=M)]
    km1 = (k - 1).clamp(0, M - 1)
    x_lo, x_hi = x[km1], x[km1 + 1]
    c = (t - x_lo) / (x_hi - x_lo)
    mid = (1 - c) * gamma[km1] + c * gamma[km1 + 1]
    return torch.where(k == 0, gamma[0], torch.where(k > M, gamma[M], mid))


def skygrid_pop_at_time(p: SkygridPopParams, t):
    return torch.exp(skygrid_log_N(p, t))


def _skygrid_log_int_core(x, gamma_eff, type_, a, b):
    """log(int_a^b exp(gamma(t)) dt), bias-compensated (pop_model.cpp
    log_int_N_core, 247-330): each of the M+2 intervals contributes the
    integral over its intersection with [a, b], combined with logsumexp.
    ``a`` and ``b`` broadcast; the interval axis is appended last."""
    dev = x.device
    a = torch.as_tensor(a, dtype=DTYPE, device=dev)[..., None]
    b = torch.as_tensor(b, dtype=DTYPE, device=dev)[..., None]
    M = x.shape[0] - 1
    inf = torch.full((1,), math.inf, dtype=DTYPE, device=dev)
    # interval k spans (edge_lo[k], edge_hi[k]], k = 0..M+1
    edge_lo = torch.cat([-inf, x])
    edge_hi = torch.cat([x, inf])
    lo = torch.minimum(torch.maximum(edge_lo, a), b)
    hi = torch.minimum(torch.maximum(edge_hi, a), b)
    dt = torch.clamp(hi - lo, min=0.0)
    pos = dt > 0.0
    one = torch.ones_like(dt)
    ninf = torch.full_like(dt, -math.inf)
    if type_ == STAIRCASE:
        g_k = torch.cat([gamma_eff, gamma_eff[-1:]])
        log_contrib = torch.where(pos, g_k + torch.log(torch.where(pos, dt,
                                                                   one)),
                                  ninf)
    else:
        x_lo, x_hi = x[:M], x[1:]
        g_lo_k, g_hi_k = gamma_eff[:M], gamma_eff[1:]
        lo_i, hi_i = lo[..., 1:M + 1], hi[..., 1:M + 1]
        dt_i = torch.clamp(hi_i - lo_i, min=0.0)
        c_lo = (lo_i - x_lo) / (x_hi - x_lo)
        c_hi = (hi_i - x_lo) / (x_hi - x_lo)
        G_lo = (1 - c_lo) * g_lo_k + c_lo * g_hi_k
        G_hi = (1 - c_hi) * g_lo_k + c_hi * g_hi_k
        D = G_hi - G_lo
        zD = D == 0.0
        safe_D = torch.where(zD, torch.ones_like(D), D)
        fac = torch.where(zD, torch.ones_like(D), torch.expm1(safe_D) / safe_D)
        pos_i = dt_i > 0.0
        log_inner = torch.where(
            pos_i, G_lo + torch.log(torch.where(pos_i, dt_i * fac,
                                                torch.ones_like(dt_i))),
            torch.full_like(dt_i, -math.inf))
        log_first = torch.where(pos[..., :1], gamma_eff[0] + torch.log(
            torch.where(pos[..., :1], dt[..., :1], one[..., :1])),
            ninf[..., :1])
        log_last = torch.where(pos[..., M + 1:], gamma_eff[M] + torch.log(
            torch.where(pos[..., M + 1:], dt[..., M + 1:], one[..., :1])),
            ninf[..., :1])
        log_contrib = torch.cat([log_first, log_inner, log_last], -1)
    m = torch.amax(log_contrib, -1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return (m + torch.log(torch.sum(torch.exp(log_contrib - m), -1,
                                    keepdim=True)))[..., 0]


def skygrid_pop_integral(p: SkygridPopParams, a, b):
    return torch.exp(_skygrid_log_int_core(p.x, p.gamma, p.type, a, b))


def skygrid_intensity_integral(p: SkygridPopParams, a, b):
    return torch.exp(_skygrid_log_int_core(p.x, -p.gamma, p.type, a, b))


def host_eval(fn, p, *times) -> np.ndarray:
    """``fn(p, *times)`` evaluated on the CPU for host code: ``fn`` is one of
    this module's functions, ``p`` has numpy or float leaves (a
    ``Run.host_view().pop``), the times are floats or numpy arrays, and the
    result is numpy."""
    def cpu(v):
        return torch.as_tensor(np.array(v, np.float64))
    if isinstance(p, SkygridPopParams):
        p = SkygridPopParams(x=cpu(p.x), gamma=cpu(p.gamma), type=int(p.type),
                             tau=cpu(p.tau))
    else:
        p = ExpPopParams(*[cpu(v) for v in p])
    return fn(p, *[cpu(t) for t in times]).numpy()


# dispatch is static (isinstance), as in the reference package

def pop_at_time(p, t):
    if isinstance(p, ExpPopParams):
        return exp_pop_at_time(p, t)
    return skygrid_pop_at_time(p, t)


def pop_integral(p, a, b):
    if isinstance(p, ExpPopParams):
        return exp_pop_integral(p, a, b)
    return skygrid_pop_integral(p, a, b)


def intensity_integral(p, a, b):
    if isinstance(p, ExpPopParams):
        return exp_intensity_integral(p, a, b)
    return skygrid_intensity_integral(p, a, b)


def render_population_curve(p, t_start: float, t_end: float,
                            num_t_cells: int) -> np.ndarray:
    """Cell-averaged N(t) staircase over [t_start, t_end]
    (pop_model.cpp:562-573; the WASM surface's pop-curve entry point).
    ``p`` has host leaves, as for ``host_eval``."""
    cell = (t_end - t_start) / num_t_cells
    lo = t_start + cell * np.arange(num_t_cells)
    return host_eval(pop_integral, p, lo, lo + cell) / cell
