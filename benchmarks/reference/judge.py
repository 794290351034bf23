"""The comparison that decides a run's ``correct``.

The program's final state is judged against the plain reference of
``ledger.py`` and the benchmark's own copy of the tips:

- ``log_G_gap``, ``log_coal_gap``, ``log_other_gap``: the distance between
  the run's incremental ledger term and the reference's recompute from the
  same state, over max(1, |reference|);
- ``tip_mismatches``: sites, outside a tip's missing intervals, where the
  mutations do not carry the root sequence to the tip's observed sequence;
- ``mutation_faults``: mutations whose from-state is not the state they
  find, whose time lies outside their branch or out of order, or whose site
  is missing in every tip below them;
- ``tree_faults``: a tree that is not one binary tree over the dataset's
  tips, each tip once, with parents before children;
- ``tip_date_faults``: tips whose time lies outside their sampling dates;
- ``partition_faults``: sites whose partition in the program's table is
  not the reference's: every site in partition 0 under the one-partition
  model, and under the mpox model (the traffic's ``run.mpox_hack``) the
  table that ``ledger.mpox_partition`` reads off the first tip, at every
  site that the tip's observed bases decide;
- ``params_unmoved``: parameters (mu, kappa and the population model's;
  under the mpox model mu and rho in place of kappa) that the window left
  exactly as it found them;
- ``nodes_unmoved``: the most inner nodes that one dispatch of the judged
  calls after the window left bit for bit at the time it found them.  A
  dispatch runs on one partition of the tree, whose cut nodes the local
  sweep holds still; every other inner node moves in a sound dispatch.

Every count but ``nodes_unmoved`` has the limit 0; it and the three gaps
have the limits of the cell.
"""

from __future__ import annotations

import math

import numpy as np

from . import ledger as ref

COUNTS = ("tip_mismatches", "mutation_faults", "tree_faults",
          "tip_date_faults", "partition_faults", "params_unmoved")
GAPS = ("log_G_gap", "log_coal_gap", "log_other_gap")
LIMITED = GAPS + ("nodes_unmoved",)


def tree_faults(state: dict, ds) -> int:
    parent = np.asarray(state["parent"])
    children = np.asarray(state["children"])
    t = np.asarray(state["t"], dtype=np.float64)
    N, T = len(parent), ds.num_tips
    bad = int(N != 2 * T - 1)
    root = state["root"]
    bad += int(parent[root] != -1)
    seen = ref.preorder(state)
    bad += N - len(set(seen))
    for n in range(N):
        c0, c1 = children[n]
        if (c0 < 0) != (c1 < 0):
            bad += 1
        for c in (c0, c1):
            if c >= 0 and (parent[c] != n or t[c] < t[n]):
                bad += 1
        if n != root and not math.isfinite(t[n]):
            bad += 1
    tips = ref.tip_maps(state, ds)
    named = [k for k in tips.values() if k is not None]
    return bad + (len(tips) - len(named)) + (T - len(set(named)))


def tip_date_faults(state: dict, ds) -> int:
    """Tips whose time lies outside their sampling dates."""
    t = np.asarray(state["t"], dtype=np.float64)
    return sum(int(not ds.dates[k][0] <= t[n] <= ds.dates[k][1])
               for n, k in ref.tip_maps(state, ds).items() if k is not None)


def partition(params: dict, ds, mpox: bool) -> tuple:
    """(faults, part): the sites where the program's table differs from the
    reference's, and the table that ``log_G`` applies under the mpox model
    (None under one partition): the reference's where the first tip decides
    a site, else the program's."""
    got = np.asarray(params["part"])
    L = ds.num_sites
    if not mpox:
        return (L if got.shape != (L,) else int(np.count_nonzero(got))), None
    want, decided = ref.mpox_partition(ds)
    if got.shape != (L,):
        return L, want
    faults = int(np.count_nonzero((got != want) & decided))
    return faults, np.where(decided, want, got).astype(np.int8)


def unmoved(start: dict, end: dict, priors: dict, mpox: bool = False) -> int:
    """Parameters that the analysis moves, equal bit for bit at the
    window's start and end."""
    h = dict(ref.DEFAULT_PRIORS, **priors)
    keys = [("mu",), ("rho",)] if mpox else [("mu",), ("kappa",)]
    if h.get("alpha_move_enabled"):
        keys += [("alpha",), ("nu",)]
    if end["pop"]["model"] == "exp":
        keys += [("pop", "n0"), ("pop", "g")]
    else:
        keys += [("pop", "gamma")]
        if h["skygrid_tau_move_enabled"]:
            keys += [("pop", "tau")]

    def get(p, k):
        for part in k:
            p = p[part]
        return np.asarray(p, dtype=np.float64)
    return sum(int(np.array_equal(get(start, k), get(end, k))) for k in keys)


def gap(got: float, want: float) -> float:
    if not math.isfinite(got) or not math.isfinite(want):
        return math.inf
    return abs(got - want) / max(1.0, abs(want))


def numbers(state: dict, params: dict, ledger: dict, ds, settings: dict,
            params_at_start: dict, nodes_unmoved: list) -> dict:
    """The compared numbers of one run's final state; ``nodes_unmoved``
    holds each judged dispatch's count of inner nodes it left unmoved;
    ``settings["mpox"]`` says whether the cell runs the mpox model."""
    mpox = bool(settings.get("mpox"))
    faults, part = partition(params, ds, mpox)
    out = {"tree_faults": tree_faults(state, ds),
           "tip_date_faults": tip_date_faults(state, ds),
           "partition_faults": faults,
           "params_unmoved": unmoved(params_at_start, params,
                                     settings["priors"], mpox),
           "nodes_unmoved": max(nodes_unmoved, default=math.inf)}
    if out["tree_faults"]:
        # a broken tree has no sequences to walk
        return dict(out, tip_mismatches=-1, mutation_faults=-1,
                    log_G_gap=math.inf, log_coal_gap=math.inf,
                    log_other_gap=math.inf)
    bad = {"mutation_state": 0, "mutation_time": 0,
           "mutation_at_missing_site": 0}
    walked = ref.walk(state, ds, bad)
    out["mutation_faults"] = sum(bad.values())
    out["tip_mismatches"] = ref.tip_mismatches(state, ds, walked[0], walked[1])
    out["log_G_gap"] = gap(ledger["log_G"],
                           ref.log_G(state, params, walked, part))
    out["log_coal_gap"] = gap(ledger["log_coal"], ref.log_coal(
        state, params["pop"], settings["t_max_tip"], settings["num_cells"]))
    out["log_other_gap"] = gap(ledger["log_other"],
                               ref.log_other(params, settings["priors"],
                                             mpox))
    return out


def verdict(nums: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) with every count held to 0 and
    every other number to the cell's limit; a number with no limit
    fails."""
    rows = []
    for k in COUNTS:
        rows.append((k, nums[k], 0))
    for k in LIMITED:
        rows.append((k, nums[k], limits.get(k)))
    correct = all(lim is not None and v == v and 0 <= v <= lim
                  for _, v, lim in rows)
    return correct, rows
