#!/usr/bin/env python3
"""The JAX package's posterior at two fixed recipes, kept as the reference
that the PyTorch port's posterior is held to (tests/test_torch_posterior.py,
scripts/torch_validate_recovery.py --against, chip_smoke.py phase 15).

    DELPHY_TPU_FORCE_CPU=1 python3 scripts/jax_posterior_reference.py
        [--out data/jax_posterior_reference.json]

Every chain runs in its own process on the CPU in float64, all chains at
once.  Two configurations, two chains each (the pair is the empirical
null: how far apart two correct chains land at this length):

  S  tests/test_f32.py's recipe at twice its length, through
     scripts/f32_study.py's own ``run_chain("f64", cfg)``: 20 tips x 400
     sites, 60,000 steps (24 samples; a port chain takes ~8 s), dataset
     seed 7, pinned start (``native=False``); chains at seeds 5 and 1005;
     traces log_post, mu (per year), t_root, muts.
  R  VALIDATION.md's recovery configuration with the dataset recipe of
     scripts/validate_recovery.py: 48 tips x 6,000 sites, mu 1e-2/365,
     kappa 3, a 400-day window, n0 150, 5% missing, dataset seed 101;
     ``Run(num_cells=256)``, 400,000 steps of burn-in, then 100 samples
     every 8,000 steps; chains at seeds 101 and 1101, both from
     one initial tree (``native=False``, ``rng=default_rng(101)``); traces
     log_post, mu (per year), kappa, t_root, num_muts.

Each chain records its recipe, the truth where simulated, the largest
|log_G incremental - recompute| seen at a sample (max_drift), |log_G| at
the end (log_G_mag), its seconds and the repo's commit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

os.environ.setdefault("DELPHY_TPU_FORCE_CPU", "1")
SCRIPTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(SCRIPTS)
sys.path[:0] = [REPO, SCRIPTS]

S_CFG = {"tips": 20, "sites": 400, "steps": 60_000}
# scripts/f32_study.py's dataset
S_DATA = {"mu": 1e-3, "sample_window_days": 400.0, "missing_fraction": 0.01,
          "seed": 7}
S_SEEDS = (5, 1005)
R_DATA = {"tips": 48, "sites": 6000, "mu": 1e-2 / 365.0, "kappa": 3.0,
          "sample_window_days": 400.0, "coalescent_n0": 150.0,
          "missing_fraction": 0.05, "seed": 101}
R_RUN = {"num_cells": 256, "burn": 400_000, "samples": 100, "thin": 8000,
         "tree_rng": 101, "native": False}
R_SEEDS = (101, 1101)


def r_chain(data: dict, run_cfg: dict, seed: int) -> dict:
    """One JAX chain of configuration R in this process."""
    os.environ["DELPHY_TPU_FORCE_CPU"] = "1"
    os.environ.pop("DELPHY_TPU_F32", None)
    import numpy as np

    from delphy_tpu.init_tree import build_initial_tree
    from delphy_tpu.run import Run
    from delphy_tpu.sim import simulate_dataset

    ref, deltas, miss, dates, names, truth = simulate_dataset(
        data["tips"], data["sites"], mu=data["mu"], kappa=data["kappa"],
        sample_window_days=data["sample_window_days"],
        coalescent_n0=data["coalescent_n0"],
        missing_fraction=data["missing_fraction"], seed=data["seed"])
    tree = build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(run_cfg["tree_rng"]),
                              native=run_cfg["native"])
    t0 = time.perf_counter()
    run = Run(tree, seed=seed, num_cells=run_cfg["num_cells"])
    run.do_mcmc_steps(run_cfg["burn"])
    trace = {"log_post": [], "mu": [], "kappa": [], "t_root": [],
             "num_muts": []}
    drift = 0.0
    for _ in range(run_cfg["samples"]):
        run.do_mcmc_steps(run_cfg["thin"])
        drift = max(drift, abs(float(run.ledger.log_G)
                               - float(run.calc_cur_ledger().log_G)))
        trace["log_post"].append(float(run.ledger.log_posterior))
        trace["mu"].append(float(run.evo.mu) * 365.0)
        trace["kappa"].append(float(run.evo.kappa))
        trace["t_root"].append(float(run.ts.t[run.ts.root]))
        trace["num_muts"].append(int(run.last_stats["num_muts"]))
    run.check_derived_quantities(1e-6)
    run.tree().check_integrity()
    return {"trace": trace, "max_drift": drift,
            "log_G_mag": abs(float(run.ledger.log_G)),
            "seconds": time.perf_counter() - t0,
            "truth": {"mu_per_year": data["mu"] * 365.0,
                      "kappa": float(truth["kappa"]),
                      "root_time": float(truth["root_time"])},
            "tip_deltas": int(sum(len(d) for d in deltas)),
            "topology": [int(run.topology_accepted),
                         int(run.topology_proposed)]}


def s_chain(seed: int) -> dict:
    """One JAX chain of configuration S: scripts/f32_study.py's run_chain,
    which runs it in a child process."""
    from f32_study import run_chain

    from delphy_tpu.sim import simulate_dataset
    t0 = time.perf_counter()
    out = run_chain("f64", dict(S_CFG, seed=seed))
    out["seconds"] = time.perf_counter() - t0
    _, deltas, _, _, _, truth = simulate_dataset(
        S_CFG["tips"], S_CFG["sites"], mu=S_DATA["mu"],
        sample_window_days=S_DATA["sample_window_days"],
        missing_fraction=S_DATA["missing_fraction"], seed=S_DATA["seed"])
    out["truth"] = {"mu_per_year": S_DATA["mu"] * 365.0,
                    "kappa": float(truth["kappa"]),
                    "root_time": float(truth["root_time"])}
    out["tip_deltas"] = int(sum(len(d) for d in deltas))
    return out


def r_chain_child(data: dict, run_cfg: dict, seed: int) -> dict:
    """r_chain in a child process (each chain its own JAX runtime)."""
    env = dict(os.environ, DELPHY_TPU_FORCE_CPU="1", JAX_PLATFORMS="cpu")
    arg = json.dumps({"data": data, "run": run_cfg, "seed": seed})
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--r-child", arg], env=env, capture_output=True,
                         text=True, timeout=4 * 3600)
    if out.returncode != 0:
        raise RuntimeError(f"R chain {seed} failed:\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def commit() -> str:
    out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                         capture_output=True, text=True)
    return out.stdout.strip() or "unknown"


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(
        REPO, "data", "jax_posterior_reference.json"))
    p.add_argument("--r-child", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.r_child:
        a = json.loads(args.r_child)
        print(json.dumps(r_chain(a["data"], a["run"], a["seed"])))
        return 0
    with ThreadPoolExecutor(max_workers=4) as pool:
        jobs = {("R", s): pool.submit(r_chain_child, R_DATA, R_RUN, s)
                for s in R_SEEDS}
        jobs.update({("S", s): pool.submit(s_chain, s) for s in S_SEEDS})
        done = {k: f.result() for k, f in jobs.items()}
    rev = commit()
    res = {"what": ("the JAX package's float64 posterior on the CPU "
                    "(scripts/jax_posterior_reference.py)"),
           "S": {"recipe": dict(S_CFG, data=S_DATA,
                                tree="native=False, rng=default_rng(7)",
                                num_cells=200, burn="steps // 5",
                                chunk="max(local moves per boundary, 2000)"),
                 "chains": {str(s): dict(done["S", s], seed=s, commit=rev)
                            for s in S_SEEDS}},
           "R": {"recipe": {"data": R_DATA, "run": R_RUN},
                 "chains": {str(s): dict(done["R", s], seed=s, commit=rev)
                            for s in R_SEEDS}}}
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
        f.write("\n")
    for (c, s), v in done.items():
        print(f"{c} seed {s}: {len(v['trace']['log_post'])} samples in "
              f"{v['seconds']:.1f} s, max drift {v['max_drift']:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
