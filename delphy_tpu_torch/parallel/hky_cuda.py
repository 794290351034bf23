"""HKY pseudo-Gibbs chain: n_rounds x (frequency delta-exchange, kappa scale
move), as one CUDA kernel (``csrc/hky_chain.cu``) and its plain PyTorch
version (port of ``delphy_tpu/parallel/hky_pallas.py``).

Randomness comes in as a (n_rounds, S >= 6) tensor of uniforms with the
lane layout of the JAX chain (``_U_*``), so the kernel, the plain version
and the JAX twin ``hky_chain_jnp`` can be fed the same numbers.  The chain
runs in the dtype of ``u``: float64, or float32 (the kernel's ``_f32``
build).
"""

from __future__ import annotations

import torch

from ..evo import hky_q
from . import _cuda

_TINY = 1e-30
# uniform lane assignment per round
_U_D, _U_IA, _U_IB, _U_ACC_F, _U_SCALE, _U_ACC_K = 0, 1, 2, 3, 4, 5
N_LANES = 6


def hky_chain_torch(u, mu, kappa0, pi0, Ttwiddle_a, M_ab, root_freq, hypf,
                    n_rounds: int):
    """Plain PyTorch chain; ``hypf`` is the kappa prior (mean, sigma) of
    log kappa.  Returns (kappa, pi (1, 4), q (4, 4))."""
    kappa_m, kappa_s = hypf
    dev, dt = u.device, u.dtype
    pi = pi0.reshape(4).to(dt)
    tt = Ttwiddle_a.reshape(4).to(dt)
    M = M_ab.reshape(4, 4).to(dt)
    rf = root_freq.reshape(4).to(dt)
    kappa = torch.as_tensor(kappa0, dtype=dt, device=dev)
    mu = torch.as_tensor(mu, dtype=dt, device=dev)
    lane4 = torch.arange(4, device=dev)
    eye = torch.eye(4, dtype=torch.bool, device=dev)
    Mpos = ~eye & (M > 0.0)
    zero = torch.zeros((), dtype=dt, device=dev)
    one = zero + 1.0

    def delta_of(new_q, q):
        d = -mu * torch.sum((-torch.diagonal(new_q) + torch.diagonal(q)) * tt)
        ratio = torch.where(q > 0.0, new_q / torch.where(q > 0.0, q, one), one)
        return d + torch.sum(torch.where(Mpos, M * torch.log(ratio), zero))

    q = hky_q(kappa, pi)
    for i in range(n_rounds):
        ur = u[i]
        # frequency delta-exchange
        d = ur[_U_D] * 0.01
        ia = torch.floor(ur[_U_IA] * 4.0).long()
        ib = (ia + 1 + torch.floor(ur[_U_IB] * 3.0).long()) % 4
        new_pi = pi + torch.where(lane4 == ia, d, zero) \
            - torch.where(lane4 == ib, d, zero)
        pia = torch.sum(torch.where(lane4 == ia, new_pi, zero))
        pib = torch.sum(torch.where(lane4 == ib, new_pi, zero))
        ok = (pia > 0.0) & (pia < 1.0) & (pib > 0.0) & (pib < 1.0)
        safe_pi = torch.where(new_pi > 0.0, new_pi, one)
        new_q = hky_q(kappa, safe_pi)
        delta = delta_of(new_q, q) + torch.sum(torch.where(
            rf > 0.0, rf * torch.log(safe_pi / pi), zero))
        acc = ok & ((delta > 0.0)
                    | (torch.log(torch.clamp(ur[_U_ACC_F], min=_TINY))
                       < delta))
        pi = torch.where(acc, new_pi, pi)
        q = torch.where(acc, new_q, q)
        # kappa scale move, log-normal prior
        scale = 0.75 + ur[_U_SCALE] * (1.0 / 0.75 - 0.75)
        new_kappa = kappa * scale
        new_q = hky_q(new_kappa, pi)
        lpr = ((-(torch.log(new_kappa) - kappa_m) ** 2
                + (torch.log(kappa) - kappa_m) ** 2)
               / (2.0 * kappa_s * kappa_s)) + torch.log(kappa / new_kappa)
        log_mh = delta_of(new_q, q) + lpr + torch.log(kappa / new_kappa)
        acc = (log_mh > 0.0) | (
            torch.log(torch.clamp(ur[_U_ACC_K], min=_TINY)) < log_mh)
        kappa = torch.where(acc, new_kappa, kappa)
        q = torch.where(acc, new_q, q)
    return kappa, pi.reshape(1, 4), q


def hky_chain_kernel(u, mu, kappa0, pi0, Ttwiddle_a, M_ab, root_freq, hypf,
                     n_rounds: int):
    """The chain on ``u``'s device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Same arguments and results as
    hky_chain_torch; mu and kappa0 are 0-d tensors (read on the device)."""
    if u.device.type == "cpu":
        return hky_chain_torch(u, mu, kappa0, pi0, Ttwiddle_a, M_ab,
                               root_freq, hypf, n_rounds)
    return _launch(u, mu, kappa0, pi0, Ttwiddle_a, M_ab, root_freq, hypf,
                   n_rounds)


def kernel_path(kappa0, pi0) -> str:
    """Which chain the kernel runs for these starting values: "folded"
    (a few logs per MH step; exact while kappa and every pi_b are positive)
    or "per-entry" (the plain version's 4x4 formula), by the kernel's own
    rule (csrc/hky_chain.cu)."""
    f64 = torch.float64   # exact for either precision's values
    start = torch.cat([torch.as_tensor(kappa0).to(f64).reshape(1).cpu(),
                       torch.as_tensor(pi0).to(f64).reshape(4).cpu()])
    ok = bool((torch.isfinite(start) & (start > 0.0)).all())
    return "folded" if ok else "per-entry"


def pack_launch(u, mu, kappa0, pi0, Ttwiddle_a, M_ab, root_freq, hypf,
                n_rounds: int) -> _cuda.Packed:
    """Check and pack the chain's inputs for ``delphy_hky_chain`` (float64
    ``u``) or ``delphy_hky_chain_f32`` (float32): every float input must be
    of ``u``'s dtype; outs are (kappa, pi (1, 4), q (4, 4))."""
    kappa_m, kappa_s = hypf
    dev, dt = u.device, u.dtype
    _cuda.suffix(dt)
    _cuda.require(u, "u", dt, (None, None), dev)
    if u.shape[0] < n_rounds or u.shape[1] < N_LANES:
        raise ValueError(f"u: shape {tuple(u.shape)} too small for "
                         f"{n_rounds} rounds x {N_LANES} lanes")
    for name, x in (("mu", mu), ("kappa0", kappa0)):
        _cuda.require(torch.as_tensor(x).reshape(-1).contiguous(), name, dt,
                      (1,), dev)
    fsc = torch.stack([torch.as_tensor(mu).reshape(()),
                       torch.as_tensor(kappa0).reshape(())])
    ins = [x.reshape(-1).contiguous() for x in (pi0, Ttwiddle_a, root_freq)]
    M = M_ab.reshape(16).contiguous()
    for name, x, n in (("pi0", ins[0], 4), ("Ttwiddle_a", ins[1], 4),
                       ("root_freq", ins[2], 4), ("M_ab", M, 16)):
        _cuda.require(x, name, dt, (n,), dev)
    kappa = torch.empty((), dtype=dt, device=dev)
    pi = torch.empty((1, 4), dtype=dt, device=dev)
    q = torch.empty((4, 4), dtype=dt, device=dev)
    P = _cuda.ptr
    args = (P(u), u.shape[1], n_rounds, P(fsc), P(ins[0]), P(ins[1]), P(M),
            P(ins[2]), float(kappa_m), float(kappa_s), P(kappa), P(pi), P(q),
            _cuda.stream_ptr(q.device))
    return _cuda.Packed(args, (kappa, pi, q), (u, fsc, *ins, M))


def _launch(u, mu, kappa0, pi0, Ttwiddle_a, M_ab, root_freq, hypf,
            n_rounds: int):
    pk = pack_launch(u, mu, kappa0, pi0, Ttwiddle_a, M_ab, root_freq, hypf,
                     n_rounds)
    name = "hky_chain" + _cuda.suffix(u.dtype)
    _cuda.check(getattr(_cuda.lib(), "delphy_" + name)(*pk.args), name)
    _cuda.count_launch(name)
    return pk.outs


def hky_chain(gen: torch.Generator, evo, Ttwiddle_a, M_ab, root_freq, hyp,
              n_rounds: int = 10):
    """The 10x HKY moves of a global boundary: evo with updated
    (kappa, pi, q, q_tab)."""
    dev, dt = evo.pi.device, evo.pi.dtype
    u = torch.rand((n_rounds, N_LANES), generator=gen, dtype=dt, device=dev)
    hypf = (float(hyp.kappa_prior_mean_log), float(hyp.kappa_prior_sigma_log))
    kappa, pi, q = hky_chain_kernel(
        u, evo.mu, evo.kappa, evo.pi.reshape(1, 4), Ttwiddle_a.to(dt),
        M_ab.to(dt).reshape(4, 4), root_freq.reshape(1, 4), hypf,
        n_rounds)
    return evo._replace(kappa=kappa, pi=pi.reshape(4), q=q, q_tab=q[None])
