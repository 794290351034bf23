"""JC mutational-history proposal sampler (port of
``delphy_tpu/ops/history.py``).

Device twin of the host sampler (``topo/history.py``; reference
core/spr_move.cpp:1164-1370): K-truncated Poisson event counts, Nielsen
rejection to the endpoint constraint, uniformized event times, as
fixed-shape batched tensor programs.

Each sampler is a deterministic ``*_core`` fed its random numbers (the
uniform of an event count, the chain's steps in {1, 2, 3}, the time
uniforms) and a wrapper that draws them from a ``torch.Generator``.  The
Nielsen rejection loop becomes a batch of candidate attempts: the core takes
A attempts per site and keeps the first one that ends at ``to``; the
wrapper draws attempts in batches until every site has one (one host sync
per batch).  Distributionally identical to the host sampler, not
stream-identical.  The dtype and device are the inputs'.
"""

from __future__ import annotations

import torch

# static cap on events per site: P(k > 32 | mu*T <~ 1) is astronomically
# small in this engine's regime (branch-length mutation intensities << 1);
# the samplers renormalize within [min_k, KMAX) exactly like the host
# sampler's max_k cutoff (topo/history.py:26)
KMAX = 32
# candidate attempts a wrapper draws per site and batch: an attempt of a
# site whose endpoints differ is accepted with probability ~1/3, so 32 of
# them all fail with probability ~2e-6
ATTEMPTS = 32


def k_truncated_poisson_weights(lam, min_k: int):
    """Unnormalized Poisson(lam) weights over k in [0, KMAX) along a new last
    axis, zeroed below min_k (distributions.h:77-165 analogue, log-space for
    stability)."""
    lam = torch.as_tensor(lam)
    k = torch.arange(KMAX, dtype=lam.dtype, device=lam.device)
    logw = k * torch.log(lam)[..., None] - torch.lgamma(k + 1.0)
    logw = torch.where(k >= min_k, logw, -torch.inf)
    m = logw.max(-1, keepdim=True).values
    return torch.exp(logw - m)


def k_from_uniform(u, lam, min_k: int):
    """Core of ``sample_k_truncated_poisson``: k ~ Poisson(lam) | k >= min_k
    by inverse CDF over [min_k, KMAX) from a uniform ``u`` on [0, 1) (any
    shape broadcasting against ``lam``)."""
    w = k_truncated_poisson_weights(lam, min_k)
    c = torch.cumsum(w, -1)
    shape = torch.broadcast_shapes(u.shape, c.shape[:-1])
    c = c.expand(shape + (KMAX,)).contiguous()
    q = (u * c[..., -1]).expand(shape).contiguous()
    return torch.searchsorted(c, q[..., None], right=True)[..., 0]


def sample_k_truncated_poisson(gen: torch.Generator, lam, min_k: int):
    lam = torch.as_tensor(lam)
    u = torch.rand(lam.shape, generator=gen, dtype=lam.dtype,
                   device=lam.device)
    return k_from_uniform(u, lam, min_k)


def chain_states(frm, steps, k_mask):
    """JC 'choose a different state' chain (topo/history.py:54): each active
    step (``k_mask``, a prefix) jumps by ``steps`` in {1, 2, 3} mod 4.
    Returns (end state, states after each step) along the last axis."""
    states = (frm[..., None] + torch.cumsum(
        torch.where(k_mask, steps, 0), -1)) % 4
    return states[..., -1], states


def site_history_core(frm, to, T, mu, u_k, steps, u_t, min_k: int = 1):
    """Constrained site histories from given draws (sample_site_history's
    core): for each of B sites, A candidate attempts, each an event-count
    uniform ``u_k`` [B, A] and KMAX chain steps ``steps`` [B, A, KMAX]; the
    first attempt whose chain ends at ``to`` is kept (Nielsen rejection,
    spr_move.cpp:1164-1240); times from ``u_t`` [B, KMAX] uniform on
    [-T, 0], sorted (uniformization).

    Returns (k[B], states[B, KMAX], times[B, KMAX], found[B]), entries
    beyond k padded (state -1, time +inf); ``found`` is False where no
    attempt was accepted (those rows are not a sample)."""
    # T and mu: 0-d or one-element, shared by the sites
    k_all = k_from_uniform(u_k, mu * T, min_k)
    kmax = torch.arange(KMAX, device=u_k.device)
    mask_all = kmax < k_all[..., None]
    end, states_all = chain_states(frm[:, None].expand(k_all.shape), steps,
                                   mask_all)
    acc = end == to[:, None]
    found = acc.any(-1)
    first = torch.argmax(acc.to(torch.int8), -1)[:, None]
    k = k_all.gather(1, first)[:, 0]
    states = states_all.gather(
        1, first[:, :, None].expand(-1, 1, KMAX))[:, 0]
    mask = kmax < k[:, None]
    # jax.random.uniform(minval=-T, maxval=0): floats*(max-min)+min, then
    # max(min, .)
    lo = -torch.as_tensor(T, dtype=u_t.dtype, device=u_t.device)
    times = torch.maximum(lo, u_t * (0.0 - lo) + lo)
    times = torch.where(mask, times, torch.inf)
    times = torch.sort(times, -1).values
    states = torch.where(mask, states, -1)
    return k, states, times, found


def draw_attempts(gen: torch.Generator, B: int, A: int, dtype, device):
    """A candidate attempts for each of B sites: (u_k [B, A], steps
    [B, A, KMAX])."""
    u_k = torch.rand((B, A), generator=gen, dtype=dtype, device=device)
    steps = torch.randint(1, 4, (B, A, KMAX), generator=gen, device=device)
    return u_k, steps


def sample_site_history(gen: torch.Generator, frm, to, T, mu,
                        min_k: int = 1, attempts: int = ATTEMPTS):
    """Constrained site histories for B sites (frm, to int [B]): draws
    attempts in batches until every site accepted one.  Returns (k, states,
    times) as ``site_history_core``."""
    T = torch.as_tensor(T)
    dtype, device = T.dtype, frm.device
    B = frm.shape[0]
    u_t = torch.rand((B, KMAX), generator=gen, dtype=dtype, device=device)
    u_k, steps = draw_attempts(gen, B, attempts, dtype, device)
    while True:
        k, states, times, found = site_history_core(
            frm, to, T, mu, u_k, steps, u_t, min_k)
        if bool(found.all()):
            return k, states, times
        more_u, more_s = draw_attempts(gen, B, attempts, dtype, device)
        u_k = torch.cat([u_k, more_u], 1)
        steps = torch.cat([steps, more_s], 1)


def sample_constrained_histories(gen: torch.Generator, frm, to, T, mu):
    """Batched constrained site histories: frm/to int [B] (frm != to).
    Returns (k[B], to_states[B, KMAX], times[B, KMAX])."""
    return sample_site_history(gen, frm, to, T, mu, min_k=1)


def roundtrip_mask_core(u, T, mu):
    """Which sites get a >=2-event round trip, from one uniform per site.

    The host samples these with a geometric skip whose per-site hit
    probability is 1 - exp(log(1 - p*)) with p* the tricky-site probability
    (topo/history.py:83-99, spr_move.cpp:1258-1297); per-site independent
    Bernoulli is the same distribution, vectorized."""
    muT = mu * T
    p1 = muT * torch.exp(-muT)
    log_one_minus_p = torch.where(muT < 1e-4, -0.5 * muT * muT,
                                  -muT - torch.log1p(-p1))
    q = -torch.expm1(log_one_minus_p)  # per-site tricky probability
    return u < q


def sample_roundtrip_mask(gen: torch.Generator, L: int, T, mu):
    T = torch.as_tensor(T)
    u = torch.rand((L,), generator=gen, dtype=T.dtype, device=T.device)
    return roundtrip_mask_core(u, T, mu)


def unconstrained_history_core(L: int, T, mu, u_k, u_t, sites, steps):
    """Backward-Gillespie JC trajectories over L sites on [-T, 0] with every
    site's end state A (spr_move.cpp:1372-1407; host twin
    topo/history.py:120-136), for B histories from given draws: the event
    counts' uniforms ``u_k`` [B], KMAX time uniforms, KMAX sites in [0, L)
    and KMAX steps in {1, 2, 3} each ([B, KMAX]).  Event count ~
    Poisson(mu*L*T), event times uniform, per-site state chains built
    BACKWARD from the end state (each event's `to` is the site's state just
    after it, `from` a uniformly different state).

    Returns (k[B], site, frm, to, t [B, KMAX]) in forward time order,
    padded with site -1 / time +inf past k.  States are relative to end
    state A."""
    lam = mu * L * T
    dev = u_t.device
    B = u_t.shape[0]
    k = k_from_uniform(u_k, torch.as_tensor(lam), 0)
    mask = torch.arange(KMAX, device=dev) < k[:, None]
    lo = -torch.as_tensor(T, dtype=u_t.dtype, device=dev)
    times = torch.where(mask, torch.maximum(lo, u_t * (0.0 - lo) + lo),
                        -torch.inf)
    order = torch.argsort(-times, dim=-1, stable=True)  # backward: latest first
    sites = torch.where(mask, sites, 0)
    # walk events backward; cur[b, l] = state of site l at the current time
    sites_b = sites.gather(1, order)
    steps_b = steps.gather(1, order)
    active_b = mask.gather(1, order)
    cur = torch.zeros((B, L), dtype=torch.int64, device=dev)
    frm_b, to_b = [], []
    for i in range(KMAX):
        s = sites_b[:, i:i + 1]
        s_now = cur.gather(1, s)
        s_prev = (s_now + steps_b[:, i:i + 1]) % 4
        act = active_b[:, i:i + 1]
        cur = cur.scatter(1, s, torch.where(act, s_prev, s_now))
        frm_b.append(torch.where(act, s_prev, -1))
        to_b.append(torch.where(act, s_now, -1))
    # back to original slot order, then emit in forward time order
    inv = torch.argsort(order, dim=-1, stable=True)
    frm = torch.cat(frm_b, 1).gather(1, inv)
    to = torch.cat(to_b, 1).gather(1, inv)
    out_t = torch.where(mask, times, torch.inf)
    srt = torch.argsort(out_t, dim=-1, stable=True)
    out_sites = torch.where(mask, sites, -1)
    return (k, out_sites.gather(1, srt), frm.gather(1, srt),
            to.gather(1, srt), out_t.gather(1, srt))


def sample_unconstrained_history(gen: torch.Generator, L: int, T, mu,
                                 batch: int = 1):
    """``batch`` unconstrained histories (``unconstrained_history_core``)
    on draws from ``gen``."""
    T = torch.as_tensor(T)
    dtype, dev = T.dtype, T.device
    u_k = torch.rand((batch,), generator=gen, dtype=dtype, device=dev)
    u_t = torch.rand((batch, KMAX), generator=gen, dtype=dtype, device=dev)
    sites = torch.randint(0, L, (batch, KMAX), generator=gen, device=dev)
    steps = torch.randint(1, 4, (batch, KMAX), generator=gen, device=dev)
    return unconstrained_history_core(L, T, mu, u_k, u_t, sites, steps)
