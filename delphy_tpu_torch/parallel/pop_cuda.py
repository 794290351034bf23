"""Exponential-population pseudo-Gibbs chain: n_rounds x (n0 scale move, g
random-walk move) with k_bar fixed, as one CUDA kernel
(``csrc/exp_pop_chain.cu``) and its plain PyTorch version (port of
``delphy_tpu/parallel/pop_pallas.py``).

Randomness comes in as a (n_rounds, S >= 4) tensor of uniforms with the lane
layout of the JAX chain (``_U_*``).  Rows are 1 x C cells and 1 x N nodes,
unpadded; the kernel and the plain version also accept the JAX package's
128-lane padded rows, whose padding is inert (k2 = 0, inner = False).  The
chain runs in the dtype of ``u``: float64, or float32 (the kernel's
``_f32`` build).
"""

from __future__ import annotations

import math

import torch

from . import _cuda

_TINY = 1e-30
# uniform lane assignment per round
_U_SCALE, _U_ACC_N0, _U_DELTA, _U_ACC_G = 0, 1, 2, 3
N_LANES = 4


def hyp_floats(hyp):
    """(alpha, beta, g_min, g_max, g_mu, g_scale, size_on, growth_on)."""
    return (float(hyp.pop_inv_n0_prior_alpha), float(hyp.pop_inv_n0_prior_beta),
            float(hyp.pop_g_min), float(hyp.pop_g_max),
            float(hyp.pop_g_prior_mu), float(hyp.pop_g_prior_scale),
            bool(hyp.pop_size_move_enabled),
            bool(hyp.pop_growth_rate_move_enabled))


def lp_rows(lbs, k2, t_row, inner, t_step, t0, min_pop, n0, g):
    """Coalescent log prior for fixed k_bar (exp-pop integral with the
    min_pop floor per cell, plus -log N(t) at inner nodes)."""
    a = lbs
    b = lbs + t_step
    zero = torch.zeros((), dtype=lbs.dtype, device=lbs.device)
    one = zero + 1.0
    log_min_pop = torch.where(min_pop > 0.0,
                              torch.log(torch.clamp(min_pop, min=_TINY)),
                              zero - math.inf)
    safe_g = torch.where(g == 0.0, one, g)
    tc = t0 + torch.log(torch.clamp(min_pop, min=_TINY) / n0) / safe_g
    no_cross = (min_pop <= 0.0) | (g == 0.0)
    tc = torch.where(no_cross, torch.where(g > 0.0, zero - math.inf,
                                           zero + math.inf), tc)
    lo_c = torch.minimum(torch.maximum(tc, a), b)
    pos = g > 0.0
    clamped = torch.where(pos, lo_c - a, b - lo_c)
    un_a = torch.where(pos, lo_c, a)
    un_b = torch.where(pos, b, lo_c)
    unclamped = (n0 / safe_g) * torch.exp(safe_g * (un_a - t0)) \
        * torch.expm1(safe_g * (un_b - un_a))
    unclamped = torch.where(g == 0.0, t_step * n0, unclamped)
    integral = clamped * min_pop + unclamped
    integral = torch.where((g == 0.0) & (min_pop > 0.0),
                           t_step * torch.maximum(min_pop, n0), integral)
    nbar = torch.clamp(integral / t_step, min=_TINY)
    quad = -torch.sum(0.5 * t_step * k2 / nbar)
    logN = torch.maximum(log_min_pop, torch.log(n0) + g * (t_row - t0))
    return quad - torch.sum(torch.where(inner, logN, zero))


def exp_pop_chain_torch(u, lbs, k2, t_row, inner, t_step, t0, min_pop,
                        n0_0, g_0, hypf, n_rounds: int):
    """Plain PyTorch chain.  Returns (n0, g) as 0-d tensors."""
    (alpha, beta, g_min, g_max, g_mu, g_scale,
     size_enabled, growth_enabled) = hypf
    dev, dt = u.device, u.dtype
    rows = (lbs.reshape(-1).to(dt), k2.reshape(-1).to(dt),
            t_row.reshape(-1).to(dt), inner.reshape(-1).bool())
    f = lambda x: torch.as_tensor(x, dtype=dt, device=dev)  # noqa: E731
    t_step, t0, min_pop, n0, g = map(f, (t_step, t0, min_pop, n0_0, g_0))

    def lp_of(n0_, g_):
        return lp_rows(*rows, t_step, t0, min_pop, n0_, g_)

    lp = lp_of(n0, g)
    for i in range(n_rounds):
        ur = u[i]
        if size_enabled:
            scale = 0.75 + ur[_U_SCALE] * (1.0 / 0.75 - 0.75)
            new_n0 = n0 * scale
            lpr = (-(alpha + 1.0) * torch.log(scale)
                   - beta * (1.0 / new_n0 - 1.0 / n0))
            new_lp = lp_of(new_n0, g)
            log_mh = (new_lp - lp) + lpr - torch.log(scale)
            acc = (log_mh > 0.0) | (
                torch.log(torch.clamp(ur[_U_ACC_N0], min=_TINY)) < log_mh)
            n0 = torch.where(acc, new_n0, n0)
            lp = torch.where(acc, new_lp, lp)
        if growth_enabled:
            delta = (2.0 * ur[_U_DELTA] - 1.0) * (1.0 / 365.0)
            new_g = g + delta
            ok = (new_g >= g_min) & (new_g <= g_max)
            lpr = (torch.abs(g - g_mu) - torch.abs(new_g - g_mu)) / g_scale
            new_lp = lp_of(n0, new_g)
            log_mh = (new_lp - lp) + lpr
            acc = ok & ((log_mh > 0.0) | (
                torch.log(torch.clamp(ur[_U_ACC_G], min=_TINY)) < log_mh))
            g = torch.where(acc, new_g, g)
            lp = torch.where(acc, new_lp, lp)
    return n0, g


def exp_pop_chain_kernel(u, lbs, k2, t_row, inner, t_step, t0, min_pop,
                         n0_0, g_0, hypf, n_rounds: int):
    """The chain on ``u``'s device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Scalars are 0-d tensors (read on the
    device)."""
    if u.device.type == "cpu":
        return exp_pop_chain_torch(u, lbs, k2, t_row, inner, t_step, t0,
                                   min_pop, n0_0, g_0, hypf, n_rounds)
    return _launch(u, lbs, k2, t_row, inner, t_step, t0, min_pop, n0_0, g_0,
                   hypf, n_rounds)


def pack_launch(u, lbs, k2, t_row, inner, t_step, t0, min_pop, n0_0, g_0,
                hypf, n_rounds: int) -> _cuda.Packed:
    """Check and pack the chain's inputs for ``delphy_exp_pop_chain``
    (float64 ``u``) or ``delphy_exp_pop_chain_f32`` (float32): every float
    input must be of ``u``'s dtype; outs is (out,), with out = [n0, g, n0
    proposals evaluated per cell (the others were folded to scalars), g
    proposals evaluated]."""
    (alpha, beta, g_min, g_max, g_mu, g_scale,
     size_enabled, growth_enabled) = hypf
    dev, dt = u.device, u.dtype
    _cuda.suffix(dt)
    _cuda.require(u, "u", dt, (None, None), dev)
    if u.shape[0] < n_rounds or u.shape[1] < N_LANES:
        raise ValueError(f"u: shape {tuple(u.shape)} too small for "
                         f"{n_rounds} rounds x {N_LANES} lanes")
    lbs_, k2_, t_ = (x.reshape(-1).contiguous() for x in (lbs, k2, t_row))
    inner_ = inner.reshape(-1).to(torch.int32).contiguous()
    C, N = lbs_.shape[0], t_.shape[0]
    _cuda.require(lbs_, "lbs", dt, (C,), dev)
    _cuda.require(k2_, "k2", dt, (C,), dev)
    _cuda.require(t_, "t_row", dt, (N,), dev)
    _cuda.require(inner_, "inner", torch.int32, (N,), dev)
    scalars = (t_step, t0, min_pop, n0_0, g_0)
    for name, x in zip(("t_step", "t0", "min_pop", "n0", "g"), scalars):
        _cuda.require(torch.as_tensor(x).reshape(-1).contiguous(), name, dt,
                      (1,), dev)
    fsc = torch.stack([torch.as_tensor(x).reshape(()) for x in scalars])
    out = torch.empty(4, dtype=dt, device=dev)
    P = _cuda.ptr
    args = (P(u), u.shape[1], n_rounds, P(lbs_), P(k2_), C, P(t_), P(inner_),
            N, P(fsc), alpha, beta, g_min, g_max, g_mu, g_scale,
            int(size_enabled), int(growth_enabled), P(out),
            _cuda.stream_ptr(out.device))
    return _cuda.Packed(args, (out,), (u, lbs_, k2_, t_, inner_, fsc))


def _launch(u, lbs, k2, t_row, inner, t_step, t0, min_pop, n0_0, g_0, hypf,
            n_rounds: int):
    pk = pack_launch(u, lbs, k2, t_row, inner, t_step, t0, min_pop, n0_0,
                     g_0, hypf, n_rounds)
    name = "exp_pop_chain" + _cuda.suffix(u.dtype)
    _cuda.check(getattr(_cuda.lib(), "delphy_" + name)(*pk.args), name)
    _cuda.count_launch(name)
    out = pk.outs[0]
    return out[0], out[1]


def pack_rows(grid, t, is_tip):
    """(1, C) cell rows (lower bounds, k_bar (k_bar - 1)) and (1, N) node rows
    (times, inner-node mask) of the chain."""
    lbs = grid.cell_lbounds().reshape(1, -1)
    k2 = (grid.k_bar * (grid.k_bar - 1.0)).reshape(1, -1)
    return lbs, k2, t.reshape(1, -1), (~is_tip).reshape(1, -1)


def exp_pop_chain(gen: torch.Generator, pop_params, grid, t, is_tip, hyp,
                  n_rounds: int = 50):
    """The 50 exp-pop rounds of a global boundary: pop_params with updated
    (n0, g)."""
    u = torch.rand((n_rounds, N_LANES), generator=gen, dtype=t.dtype,
                   device=t.device)
    lbs, k2, t_row, inner = pack_rows(grid, t, is_tip)
    n0, g = exp_pop_chain_kernel(
        u, lbs, k2, t_row, inner, grid.t_step, pop_params.t0,
        pop_params.min_pop, pop_params.n0, pop_params.g, hyp_floats(hyp),
        n_rounds)
    return pop_params._replace(n0=n0, g=g)
