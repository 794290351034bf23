"""Plain NumPy reference for the final state of a Delphy MCMC run.

From a state (the tree, node times and the mutations on every branch), its
parameters and the benchmark's own copy of the tips, this module works out
the three terms of the run's posterior again, and checks the state against
the tips.  It follows the EMAT model of Delphy (Varilly et al.) and imports
nothing of the program it judges.

- ``log_G``, the explicit-mutation genetic likelihood under HKY with
  per-site rates nu_l: the root sequence's prior, sum of log pi over the
  sites present in some tip, and for every branch the log density of its
  mutations, log(mu nu_l Q[a, b]) each, less the integral over the branch of
  the total mutation rate mu sum_l nu_l q_a(state_l(t)) over the sites
  present in some tip below it.  Sequences are reconstructed from the root
  down, mutation by mutation.
- ``log_coal``, the coalescent prior on Delphy's grid of C cells reaching
  from 0.35 of the tree's span (and one day) before the root to the last
  tip: minus the sum over cells of dt kbar (kbar - 1) / (2 Nbar), kbar the
  cell's time-averaged lineage count and Nbar its mean population, and
  minus log N(t) at every coalescence.
- ``log_other``, the priors of the parameters: mu (Gamma), alpha
  (Exponential), nu_l (Gamma(alpha, alpha)), kappa (log-normal), and the
  population model's (exponential: 1/n0 inverse-gamma and g Laplace;
  skygrid: tau Gamma, the GMRF on gamma, the 1/Nbar prior and the
  low-population barrier).

Under Delphy's mpox model (``--v0-mpox-hack``, run.h:134-178,
run.cpp:359-433 and 823-952; O'Toole et al. 2023, Science 382:595) the
sites fall into two partitions, and ``log_G`` takes each site's rates from
its own:

- The partition table is read off the first tip of the input, which the
  program's initial tree holds as node 0: site l is in partition 1 (an
  APOBEC3 context) iff the base before it is T and it is C or T, or the base
  after it is A and it is G or A (``apobec_partition``).  Delphy reads that
  tip's sequence as the initial tree carries it, so at a site the tip is
  missing the base is the one its ancestors carry in that tree, which the
  seed's tree builder chose.  ``mpox_partition`` works the table out from
  the tip's observed bases and says which sites it cannot decide: those
  whose label turns on a missing base (inside or next to the first tip's
  missing intervals).  The benchmark's generator (``frozen/sim_apobec.py``)
  gives the first tip no missing interval, so there it decides every site.
- ``Q_0`` is Jukes-Cantor (1/3 off the diagonal, -1 on it) and ``Q_1`` is
  ``Q_0`` with ``2 rho`` more on C->T and on G->A, its diagonal balanced
  (rho = mu* / mu; the 2 is O'Toole et al.'s convention, run.h:169-172).
  The root's prior takes JC's uniform pi, whatever ``pi`` the program holds.
- ``log_other`` counts the one-partition terms, with kappa at the 1 that
  the model fixes it at and pi not a parameter; rho's prior is flat on
  [0, inf) (the move's truncated draw of 1 + 6 rho is that conditional), so
  it adds 0 there and -inf below.  These are the terms the port's ledger
  counts.  Delphy's C++ source is not at hand, so where the port departs
  from it shows only against the port's citations of it.  One place: the
  port's mu move under the model (run.cpp:823-952 by its citation) draws
  from Gamma(M + a - 1, b + ...), mu's conditional under a prior one power
  of mu below the Gamma(a, b) that the ledger counts.
"""

from __future__ import annotations

import bisect
import math

import numpy as np

STAIRCASE, LOG_LINEAR = 1, 2
A, C, G, T = 0, 1, 2, 3

# Delphy's default hyperparameters (core/run.cpp), the ones the program runs
# unless the traffic sets others
DEFAULT_PRIORS = {
    "mu_prior_alpha": 1.0, "mu_prior_beta": 0.0,
    "alpha_prior_mean": 1.0,
    "kappa_prior_mean_log": 1.0, "kappa_prior_sigma_log": 1.25,
    "pop_inv_n0_prior_alpha": 0.0, "pop_inv_n0_prior_beta": 0.0,
    "pop_g_prior_mu": 0.001 / 365.0, "pop_g_prior_scale": 30.701135 / 365.0,
    "skygrid_tau_prior_alpha": 0.001, "skygrid_tau_prior_beta": 0.001,
    "skygrid_low_gamma_barrier_enabled": True,
    "skygrid_low_gamma_barrier_loc": 0.0,
    "skygrid_low_gamma_barrier_scale": 0.35667494393873245,
    "skygrid_inv_nbar_prior_alpha": 0.0, "skygrid_inv_nbar_prior_beta": 0.0,
    "skygrid_tau_move_enabled": True,
}


def hky_q(kappa: float, pi) -> np.ndarray:
    """HKY rate matrix, q[a, b] = r[a, b] pi_b / R off the diagonal, r = 1
    for a transversion and kappa for a transition, R = sum_ab pi_a r_ab
    pi_b (so the mean rate is 1), rows summing to zero."""
    pi = np.asarray(pi, dtype=np.float64)
    q = np.zeros((4, 4))
    for a in range(4):
        for b in range(4):
            if a != b:
                transition = {a, b} in ({0, 2}, {1, 3})
                q[a, b] = (kappa if transition else 1.0) * pi[b]
    q /= float(np.sum(pi[:, None] * q))
    for a in range(4):
        q[a, a] = -(q[a].sum() - q[a, a])
    return q


def mpox_q_tab(rho: float) -> np.ndarray:
    """[Q_0, Q_1] of the mpox model: Jukes-Cantor, and Jukes-Cantor with
    2 rho more on C->T and G->A, rows summing to zero."""
    q0 = np.full((4, 4), 1.0 / 3.0)
    np.fill_diagonal(q0, -1.0)
    q1 = q0.copy()
    for a, b in ((C, T), (G, A)):
        q1[a, b] += 2.0 * rho
        q1[a, a] -= 2.0 * rho
    return np.stack([q0, q1])


def apobec_partition(seq) -> np.ndarray:
    """Each site's partition by its APOBEC3 context in ``seq`` (A C G T as
    0-3, -1 where the base is not known): 1 iff the base before is T and
    this one C or T, or the base after is A and this one G or A."""
    seq = np.asarray(seq)
    ctx = np.zeros(len(seq), dtype=bool)
    ctx[1:] |= (seq[:-1] == T) & ((seq[1:] == C) | (seq[1:] == T))
    ctx[:-1] |= (seq[1:] == A) & ((seq[:-1] == G) | (seq[:-1] == A))
    return ctx.astype(np.int8)


def mpox_partition(ds) -> tuple:
    """(part, decided): the partition table from the first tip's observed
    bases, and which sites those bases decide (a site is undecided where it
    is missing in the tip, or where its label turns on a missing
    neighbour)."""
    seq = np.asarray(ds.ref_seq, dtype=np.int8).copy()
    for site, b in ds.deltas[0]:
        seq[site] = b
    known = np.ones(len(seq), dtype=bool)
    for s, e in ds.miss[0]:
        known[s:e] = False
    seq[~known] = -1
    before = np.zeros(len(seq), dtype=bool)
    before[1:] = ~known[:-1]
    after = np.zeros(len(seq), dtype=bool)
    after[:-1] = ~known[1:]
    ct = (seq == C) | (seq == T)
    ga = (seq == G) | (seq == A)
    decided = known & ~(ct & before) & ~(ga & after)
    return apobec_partition(seq), decided


# -- intervals -----------------------------------------------------------------

def intersect(a: list, b: list) -> list:
    """Intersection of two sorted lists of disjoint [start, end) intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def inside(ivs: list, starts: list, site: int) -> bool:
    k = bisect.bisect_right(starts, site) - 1
    return k >= 0 and site < ivs[k][1]


# -- the tree ------------------------------------------------------------------

def preorder(state: dict) -> list:
    children, order, stack = state["children"], [], [state["root"]]
    while stack:
        n = stack.pop()
        order.append(n)
        for c in children[n]:
            if c >= 0:
                stack.append(int(c))
    return order


def tip_maps(state: dict, ds) -> dict:
    """node -> the dataset's tip index, by name."""
    by_name = {name: i for i, name in enumerate(ds.names)}
    return {n: by_name.get(state["names"][n])
            for n in range(len(state["parent"])) if state["children"][n][0] < 0}


def missing_below(state: dict, ds, tips: dict) -> list:
    """Per node, the sites missing in every tip of its subtree."""
    order = preorder(state)
    miss = [None] * len(order)
    for n in reversed(order):
        c0, c1 = state["children"][n]
        if c0 < 0:
            k = tips[n]
            miss[n] = list(ds.miss[k]) if k is not None else []
        else:
            miss[n] = intersect(miss[c0], miss[c1])
    return miss


def root_sequence(state: dict, bad: dict) -> np.ndarray:
    seq = np.asarray(state["ref_seq"], dtype=np.int8).copy()
    for site, frm, to, _t in state["mutations"][state["root"]]:
        if frm != seq[site] or frm == to:
            bad["mutation_state"] += 1
        seq[site] = to
    return seq


def walk(state: dict, ds, bad: dict):
    """Reconstruct every node's sequence as its differences from the root
    sequence (a dict site -> state) while checking each mutation against
    the state it finds: its from-state, its time on the branch and its
    site's presence below it.  Returns (root_seq, diffs, miss)."""
    tips = tip_maps(state, ds)
    miss = missing_below(state, ds, tips)
    root, parent, t = state["root"], state["parent"], state["t"]
    root_seq = root_sequence(state, bad)
    diffs = {root: {}}
    for n in preorder(state):
        if n == root:
            continue
        d = dict(diffs[int(parent[n])])
        ivs = miss[n]
        starts = [s for s, _ in ivs]
        t_p, t_n = t[parent[n]], t[n]
        prev_t = -math.inf
        for site, frm, to, tm in state["mutations"][n]:
            cur = d.get(site, int(root_seq[site]))
            if frm != cur or frm == to:
                bad["mutation_state"] += 1
            if not (t_p <= tm <= t_n) or tm < prev_t:
                bad["mutation_time"] += 1
            if inside(ivs, starts, site):
                bad["mutation_at_missing_site"] += 1
            prev_t = tm
            if to == root_seq[site]:
                d.pop(site, None)
            else:
                d[site] = to
        diffs[n] = d
    return root_seq, diffs, miss


def tip_mismatches(state: dict, ds, root_seq, diffs) -> int:
    """Sites, outside each tip's missing intervals, where the sequence the
    mutations carry to the tip differs from the tip's observed one."""
    tips = tip_maps(state, ds)
    ref = np.asarray(ds.ref_seq, dtype=np.int8)
    base = set(np.nonzero(root_seq != ref)[0].tolist())
    bad = 0
    for n, k in tips.items():
        if k is None:
            continue
        obs = dict(ds.deltas[k])
        ivs = ds.miss[k]
        starts = [s for s, _ in ivs]
        for site in base | set(diffs[n]) | set(obs):
            if inside(ivs, starts, site):
                continue
            got = diffs[n].get(site, int(root_seq[site]))
            want = obs.get(site, int(ref[site]))
            bad += got != want
    return bad


# -- log_G ---------------------------------------------------------------------

def log_G(state: dict, params: dict, walked, part=None) -> float:
    """``walked`` is what ``walk`` returns for this state.  With ``part``,
    each site's partition, the mpox model at ``params["rho"]``; without,
    one HKY partition at ``params``' kappa and pi."""
    root_seq, diffs, miss = walked
    mu = float(params["mu"])
    nu = np.asarray(params["nu"], dtype=np.float64)
    if part is None:
        pi = np.asarray(params["pi"], dtype=np.float64)
        q_tab = hky_q(float(params["kappa"]), pi)[None]
        part = np.zeros(len(root_seq), dtype=np.int8)
    else:
        pi = np.full(4, 0.25)
        q_tab = mpox_q_tab(float(params["rho"]))
    qa_tab = -np.diagonal(q_tab, axis1=1, axis2=2)
    W = np.concatenate([[0.0], np.cumsum(nu * qa_tab[part, root_seq])])
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
                qa = qa_tab[part[site]]
                lam += nu[site] * (qa[st] - qa[root_seq[site]])
        t_p = t[parent[n]]
        integral = mu * lam * (t[n] - t_p)
        for site, frm, to, tm in state["mutations"][n]:
            qa = qa_tab[part[site]]
            integral -= mu * nu[site] * (qa[to] - qa[frm]) * (tm - t_p)
            total += math.log(mu * nu[site] * q_tab[part[site], frm, to])
        total -= integral
    return total


# -- log_coal ------------------------------------------------------------------

def pop_at(pop: dict, t):
    t = np.asarray(t, dtype=np.float64)
    if pop["model"] == "exp":
        return np.maximum(pop["min_pop"],
                          pop["n0"] * np.exp(pop["g"] * (t - pop["t0"])))
    return np.exp(skygrid_log_N(pop, t))


def skygrid_log_N(pop: dict, t):
    """log N(t): gamma_0 up to x_0 and gamma_M after x_M; between knots the
    value of the interval's upper knot (staircase) or the linear
    interpolation of the two (log-linear)."""
    x = np.asarray(pop["x"], dtype=np.float64)
    g = np.asarray(pop["gamma"], dtype=np.float64)
    M = len(x) - 1
    k = np.searchsorted(x, t, side="left")      # x[k-1] < t <= x[k]
    if pop["type"] == STAIRCASE:
        return g[np.minimum(k, M)]
    km1 = np.clip(k - 1, 0, M - 1)
    c = (t - x[km1]) / (x[km1 + 1] - x[km1])
    mid = (1.0 - c) * g[km1] + c * g[km1 + 1]
    return np.where(k == 0, g[0], np.where(k > M, g[M], mid))


def _exp_integral(pop: dict, a, b):
    """int_a^b max(min_pop, n0 exp(g (t - t0))) dt, per pair (a, b)."""
    n0, g, t0, floor = pop["n0"], pop["g"], pop["t0"], pop["min_pop"]

    def curve(x, y):   # int_x^y n0 exp(g (t - t0)) dt, for y >= x
        if g == 0.0:
            return n0 * (y - x)
        return n0 / g * np.exp(g * (x - t0)) * np.expm1(g * (y - x))

    if g == 0.0 or floor <= 0.0:
        if g == 0.0 and floor > 0.0:
            return (b - a) * max(floor, n0)
        return curve(a, b)
    tc = t0 + math.log(floor / n0) / g      # where the curve meets the floor
    cut = np.clip(tc, a, b)
    if g > 0.0:      # below the floor before tc
        return floor * (cut - a) + curve(cut, b)
    return curve(a, cut) + floor * (b - cut)


def _skygrid_integral(pop: dict, a, b):
    """int_a^b N(t) dt, per pair (a, b), piece by piece between the knots."""
    x = np.asarray(pop["x"], dtype=np.float64)
    g = np.asarray(pop["gamma"], dtype=np.float64)
    M = len(x) - 1
    a, b = np.asarray(a)[:, None], np.asarray(b)[:, None]
    out = np.zeros(a.shape[0])
    # the flat ends
    out += np.exp(g[0]) * np.clip(np.minimum(b, x[0]) - a, 0.0, None)[:, 0]
    out += np.exp(g[M]) * np.clip(b - np.maximum(a, x[M]), 0.0, None)[:, 0]
    lo = np.maximum(a, x[None, :M])
    hi = np.minimum(b, x[None, 1:])
    dt = np.clip(hi - lo, 0.0, None)
    if pop["type"] == STAIRCASE:
        out += np.sum(np.exp(g[None, 1:]) * dt, axis=1)
        return out
    width = x[None, 1:] - x[None, :M]
    c_lo = (lo - x[None, :M]) / width
    c_hi = (np.maximum(hi, lo) - x[None, :M]) / width
    G_lo = (1 - c_lo) * g[None, :M] + c_lo * g[None, 1:]
    G_hi = (1 - c_hi) * g[None, :M] + c_hi * g[None, 1:]
    D = G_hi - G_lo
    with np.errstate(divide="ignore", invalid="ignore"):
        fac = np.where(D == 0.0, 1.0, np.expm1(D) / np.where(D == 0, 1, D))
    out += np.sum(np.where(dt > 0, np.exp(G_lo) * dt * fac, 0.0), axis=1)
    return out


def log_coal(state: dict, pop: dict, t_max_tip: float, num_cells: int) -> float:
    t = np.asarray(state["t"], dtype=np.float64)
    is_tip = np.asarray(state["children"])[:, 0] < 0
    t_root = float(t[state["root"]])
    span = max(t_max_tip - t_root, 1.0)
    t_lo = t_root - 0.35 * span - 1.0
    C = min(num_cells, 400)
    dt = (t_max_tip - t_lo) / C
    lb = t_lo + dt * np.arange(C)
    # lineages alive at time s: tips after s less coalescences after s; the
    # cell's mean counts each node by the share of the cell before it
    sign = np.where(is_tip, 1.0, -1.0)
    share = np.clip((t[None, :] - lb[:, None]) / dt, 0.0, 1.0)
    kbar = share @ sign
    integral = (_exp_integral(pop, lb, lb + dt) if pop["model"] == "exp"
                else _skygrid_integral(pop, lb, lb + dt))
    nbar = np.maximum(integral / dt, 1e-100)
    quad = -np.sum(dt * kbar * (kbar - 1.0) / (2.0 * nbar))
    return float(quad - np.sum(np.log(pop_at(pop, t[~is_tip]))))


# -- log_other -----------------------------------------------------------------

def log_other(params: dict, priors: dict, mpox: bool = False) -> float:
    """With ``mpox``, kappa is the model's 1 and rho's flat prior on
    [0, inf) is counted."""
    h = dict(DEFAULT_PRIORS, **priors)
    mu, alpha, kappa = (float(params[k]) for k in ("mu", "alpha", "kappa"))
    nu = np.asarray(params["nu"], dtype=np.float64)
    L = len(nu)
    lp = (h["mu_prior_alpha"] - 1.0) * math.log(mu) - h["mu_prior_beta"] * mu
    if mpox:
        kappa = 1.0
        lp += 0.0 if float(params["rho"]) >= 0.0 else -math.inf
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
