"""The reference's one-partition formulas for ``log_G`` and ``log_other``
as they stood before the mpox model was added, verbatim, so that a test can
hold the one-partition path of ``reference/ledger.py`` to the same bits."""

from __future__ import annotations

import math

import numpy as np

from benchmarks.reference.ledger import DEFAULT_PRIORS, hky_q, inside


def log_G(state: dict, params: dict, walked) -> float:
    """``walked`` is what ``walk`` returns for this state."""
    root_seq, diffs, miss = walked
    mu = float(params["mu"])
    nu = np.asarray(params["nu"], dtype=np.float64)
    pi = np.asarray(params["pi"], dtype=np.float64)
    q = hky_q(float(params["kappa"]), pi)
    qa = -np.diagonal(q)
    W = np.concatenate([[0.0], np.cumsum(nu * qa[root_seq])])
    root, parent, t = state["root"], state["parent"], state["t"]

    # the root sequence's prior over the sites present in some tip
    present = np.ones(len(root_seq), dtype=bool)
    for s, e in miss[root]:
        present[s:e] = False
    counts = np.bincount(root_seq[present], minlength=4)
    total = sum(float(c) * math.log(pi[a]) for a, c in enumerate(counts)
                if c > 0)

    for n in range(len(parent)):
        if n == root:
            continue
        ivs = miss[n]
        starts = [s for s, _ in ivs]
        # total rate at the bottom of the branch, over the present sites
        lam = W[-1] - sum(W[e] - W[s] for s, e in ivs)
        for site, st in diffs[n].items():
            if not inside(ivs, starts, site):
                lam += nu[site] * (qa[st] - qa[root_seq[site]])
        t_p = t[parent[n]]
        integral = mu * lam * (t[n] - t_p)
        for site, frm, to, tm in state["mutations"][n]:
            integral -= mu * nu[site] * (qa[to] - qa[frm]) * (tm - t_p)
            total += math.log(mu * nu[site] * q[frm, to])
        total -= integral
    return total


def log_other(params: dict, priors: dict) -> float:
    h = dict(DEFAULT_PRIORS, **priors)
    mu, alpha, kappa = (float(params[k]) for k in ("mu", "alpha", "kappa"))
    nu = np.asarray(params["nu"], dtype=np.float64)
    L = len(nu)
    lp = (h["mu_prior_alpha"] - 1.0) * math.log(mu) - h["mu_prior_beta"] * mu
    m = h["alpha_prior_mean"]
    lp += -alpha / m - math.log(m)
    lp += L * (alpha * math.log(alpha) - math.lgamma(alpha))
    lp += (alpha - 1.0) * float(np.sum(np.log(nu))) - alpha * float(np.sum(nu))
    s = h["kappa_prior_sigma_log"]
    lk = math.log(kappa)
    lp += (-(lk - h["kappa_prior_mean_log"]) ** 2 / (2 * s * s)
           - 0.5 * math.log(2 * math.pi * s * s) - lk)
    pop = params["pop"]
    if pop["model"] == "exp":
        n0, g = pop["n0"], pop["g"]
        lp += (-(h["pop_inv_n0_prior_alpha"] + 1.0) * math.log(n0)
               - h["pop_inv_n0_prior_beta"] / n0)
        lp += (-abs(g - h["pop_g_prior_mu"]) / h["pop_g_prior_scale"]
               - math.log(2.0 * h["pop_g_prior_scale"]))
        return lp
    tau = float(pop["tau"])
    gamma = np.asarray(pop["gamma"], dtype=np.float64)
    if h["skygrid_tau_move_enabled"]:
        lp += ((h["skygrid_tau_prior_alpha"] - 1.0) * math.log(tau)
               - h["skygrid_tau_prior_beta"] * tau)
    gbar = float(np.mean(gamma))
    lp += (-h["skygrid_inv_nbar_prior_alpha"] * gbar
           - h["skygrid_inv_nbar_prior_beta"] * math.exp(-gbar))
    dg = np.diff(gamma)
    lp += float(np.sum(0.5 * (math.log(tau) - math.log(2.0 * math.pi))
                       - 0.5 * dg ** 2 * tau))
    if h["skygrid_low_gamma_barrier_enabled"]:
        excess = np.clip(h["skygrid_low_gamma_barrier_loc"] - gamma, 0.0, None)
        lp -= float(np.sum((excess / h["skygrid_low_gamma_barrier_scale"]) ** 2))
    return lp
