#!/usr/bin/env python3
"""f32-vs-f64 statistical comparison of the port (delphy_tpu_torch): the
counterpart of scripts/f32_study.py, whose data, starting tree, chain
layout and comparison it repeats.

    python3 scripts/torch_f32_study.py [--steps 200000] [--tips 40]
        [--sites 1200] [--seed 3] [--device cuda]

Three chains on the same simulated dataset and starting tree, in one
process (the port's precision is a Run argument, not an import-time
switch): float32 and float64 at --seed, and float64 at --seed + 1000, the
empirical null.  Each chain burns in a fifth of --steps, then records the
log-posterior, mu, the root time and the mutation count every
max(local moves per boundary, 2000) steps, and the worst within-window
|log_G incremental - recompute|.  Prints one JSON report: each summary's
distance in joint Monte-Carlo standard errors, f32 against f64 and the
null (f64 against f64), and both drifts; exits 1 where f32's largest
distance exceeds max(8, 3 x the null's), the rule of tests/test_f32.py.

``ess_mean_se`` and ``compare`` are the port's one comparison of two
chains' summaries: scripts/torch_validate_recovery.py and the tests import
them from here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def run_chain(dtype, cfg: dict, device="cpu") -> dict:
    """One chain of scripts/f32_study.py's layout on the port, in
    ``dtype`` on ``device``."""
    from delphy_tpu_torch.init_tree import build_initial_tree
    from delphy_tpu_torch.run import Run
    from delphy_tpu_torch.sim import simulate_dataset

    ref, deltas, miss, dates, names, _ = simulate_dataset(
        cfg["tips"], cfg["sites"], mu=1e-3, sample_window_days=400.0,
        missing_fraction=0.01, seed=7)
    tree = build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(7), native=False)
    t0 = time.perf_counter()
    run = Run(tree, seed=cfg["seed"], num_cells=200, device=device,
              dtype=dtype)
    steps = cfg["steps"]
    chunk = max(run.local_moves_per_global_move, 2000)
    run.do_mcmc_steps(steps // 5)
    trace = {"log_post": [], "mu": [], "t_root": [], "muts": []}
    drift, done = 0.0, steps // 5
    while done < steps:
        run.do_mcmc_steps(chunk)
        done += chunk
        drift = max(drift, abs(float(run.ledger.log_G)
                               - float(run.calc_cur_ledger().log_G)))
        trace["log_post"].append(float(run.ledger.log_posterior))
        trace["mu"].append(float(run.evo.mu) * 365.0)
        trace["t_root"].append(float(run.ts.t[run.ts.root.long()]))
        trace["muts"].append(int(run.last_stats["num_muts"]))
    return {"trace": trace, "max_drift": drift,
            "log_G_mag": abs(float(run.ledger.log_G)),
            "seconds": time.perf_counter() - t0}


def ess_mean_se(x):
    """Mean and MC standard error with a crude autocorrelation-time factor
    (scripts/f32_study.py)."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    m = x.mean()
    v = x.var(ddof=1) if n > 1 else 0.0
    if v == 0.0 or n < 8:
        return m, max(np.sqrt(v / max(n, 1)), 1e-12)
    xc = x - m
    tau = 1.0
    for k in range(1, min(n // 4, 100)):
        rho = np.dot(xc[:-k], xc[k:]) / ((n - k) * v)
        if rho < 0.05:
            break
        tau += 2.0 * rho
    return m, np.sqrt(v / max(n / tau, 2.0))


def compare(a: dict, b: dict) -> dict:
    """scripts/f32_study.py's comparison of two chains' summaries: for each
    trace of ``a`` (``b`` has the same keys), the means, their standard
    errors and the distance in joint standard errors."""
    report = {"summaries": {}, "max_sigma": 0.0,
              "a_max_within_window_drift": a["max_drift"],
              "b_max_within_window_drift": b["max_drift"],
              "log_G_magnitude": a["log_G_mag"]}
    for k in a["trace"]:
        m1, se1 = ess_mean_se(a["trace"][k])
        m2, se2 = ess_mean_se(b["trace"][k])
        sigma = abs(m1 - m2) / max((se1 ** 2 + se2 ** 2) ** 0.5, 1e-12)
        report["summaries"][k] = {"a_mean": m1, "a_se": se1, "b_mean": m2,
                                  "b_se": se2, "sigma": sigma}
        report["max_sigma"] = max(report["max_sigma"], sigma)
    return report


def study(cfg: dict, device="cpu") -> dict:
    """The three chains and tests/test_f32.py's verdict: ``ok`` where the
    f64 drift is rounding (< 1e-8), the f32 drift is under the scaled bench
    bound, and f32's largest distance is under max(8, 3 x the null's)."""
    f32 = run_chain(torch.float32, cfg, device)
    f64 = run_chain(torch.float64, cfg, device)
    f64b = run_chain(torch.float64, dict(cfg, seed=cfg["seed"] + 1000),
                     device)
    report = compare(f32, f64)
    null = compare(f64b, f64)
    drift_bound = max(0.05 * report["log_G_magnitude"] / 4.5e4, 1e-3)
    sigma_bound = max(8.0, 3.0 * null["max_sigma"])
    return {
        "config": cfg, "device": str(device),
        "f32_vs_f64": report, "null_f64_vs_f64": null,
        "f32_drift": f32["max_drift"], "f64_drift": f64["max_drift"],
        "drift_bound": drift_bound, "sigma_bound": sigma_bound,
        "seconds": {"f32": f32["seconds"], "f64": f64["seconds"],
                    "f64_null": f64b["seconds"]},
        "ok": bool(f64["max_drift"] < 1e-8
                   and f32["max_drift"] < drift_bound
                   and report["max_sigma"] < sigma_bound)}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200_000)
    p.add_argument("--tips", type=int, default=40)
    p.add_argument("--sites", type=int, default=1200)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    cfg = {"tips": args.tips, "sites": args.sites, "steps": args.steps,
           "seed": args.seed}
    res = study(cfg, args.device)
    print(json.dumps(res, indent=1))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
