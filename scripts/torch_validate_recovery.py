#!/usr/bin/env python3
"""Statistical validation of the port (delphy_tpu_torch): posterior recovery
of simulated truth, the counterpart of scripts/validate_recovery.py, whose
knobs, dataset, Run recipe, printed lines and RECOVERY rule it keeps.

    VAL_T=48 VAL_L=6000 VAL_BURN=400000 VAL_SAMPLES=100 VAL_THIN=8000 \\
        python3 scripts/torch_validate_recovery.py [--device cuda]
        [--dtype float64|float32] [--pinned] [--json OUT]
        [--against data/jax_posterior_reference.json]

Knobs (environment, the JAX script's defaults): VAL_T tips (24), VAL_L
sites (3000), VAL_SEED dataset, tree and chain seed (101), VAL_BURN
burn-in steps (40000), VAL_SAMPLES (60), VAL_THIN steps between samples
(4000).  The run is on the card unless ``--device cpu`` is given, and in
float64 unless ``--dtype float32`` or DELPHY_TPU_F32 says float32.
``--pinned`` builds the initial tree with the Python pipeline
(``native=False``), the start the JAX reference's chains share.
``--against REF`` holds the traces to configuration R of REF (made by
scripts/jax_posterior_reference.py; the run must have R's dataset and a
pinned start): each summary's distance in joint Monte-Carlo standard errors
from each JAX chain, beside the JAX null (its two chains against each
other); the run fails where the largest exceeds max(5, 3 x the null).
Exit code 0 where RECOVERY is OK and every check holds, else 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

SCRIPTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(SCRIPTS))
sys.path.insert(0, SCRIPTS)

MU_TRUE = 1e-2 / 365.0  # 1e-2 subs/site/year (informative regime)
TRACES = ("log_post", "mu", "kappa", "t_root", "num_muts")


def knobs() -> dict:
    """The VAL_* knobs with scripts/validate_recovery.py's defaults."""
    env = os.environ.get
    return {"T": int(env("VAL_T", "24")), "L": int(env("VAL_L", "3000")),
            "seed": int(env("VAL_SEED", "101")),
            "burn": int(env("VAL_BURN", "40000")),
            "samples": int(env("VAL_SAMPLES", "60")),
            "thin": int(env("VAL_THIN", "4000"))}


def dataset(T: int, L: int, seed: int):
    """scripts/validate_recovery.py's simulated dataset."""
    from delphy_tpu_torch.sim import simulate_dataset
    return simulate_dataset(T, L, mu=MU_TRUE, kappa=3.0,
                            sample_window_days=400.0, coalescent_n0=150.0,
                            missing_fraction=0.05, seed=seed)


def ledger_tol(dtype, log_G) -> float:
    """The JAX script's 1e-4 in float64; in float32 bench.py's 0.05 at
    Ebola's |log_G| (~4.5e4), scaled by |log_G| / 4.5e4, at least 1e-3."""
    if dtype == torch.float32:
        return max(0.05 * abs(float(log_G)) / 4.5e4, 1e-3)
    return 1e-4


def recovery_chain(k: dict, device="cuda", dtype=None, pinned=False,
                   on_line=print):
    """The JAX script's chain on the port: returns (result, run).  Each
    line it prints goes through ``on_line``."""
    from delphy_tpu_torch import resolve_device
    from delphy_tpu_torch.init_tree import build_initial_tree
    from delphy_tpu_torch.run import Run

    device = resolve_device(device)
    ref, deltas, miss, dates, names, truth = dataset(k["T"], k["L"],
                                                     k["seed"])
    n_deltas = sum(len(d) for d in deltas)
    on_line(f"dataset: {k['T']} tips x {k['L']} sites, {n_deltas} tip "
            f"deltas, seed {k['seed']}")
    tree = build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(k["seed"]),
                              **({"native": False} if pinned else {}))
    run = Run(tree, seed=k["seed"], num_cells=256, device=device,
              dtype=dtype)
    t0 = time.time()
    run.do_mcmc_steps(k["burn"])
    trace = {key: [] for key in TRACES}
    drift = 0.0
    for _ in range(k["samples"]):
        run.do_mcmc_steps(k["thin"])
        drift = max(drift, abs(float(run.ledger.log_G)
                               - float(run.calc_cur_ledger().log_G)))
        trace["log_post"].append(float(run.ledger.log_posterior))
        trace["mu"].append(float(run.evo.mu) * 365.0)
        trace["kappa"].append(float(run.evo.kappa))
        # a one-element index: a 0-d one would sync the card
        trace["t_root"].append(float(run.ts.t[run.ts.root.long()]))
        trace["num_muts"].append(int(run.last_stats["num_muts"]))
    tol = ledger_tol(run.dtype, run.ledger.log_G)
    run.check_derived_quantities(tol)
    dt = time.time() - t0
    res = {"knobs": k, "device": str(device), "dtype": str(run.dtype),
           "pinned": pinned, "tip_deltas": n_deltas,
           "truth": {"mu_per_year": MU_TRUE * 365.0,
                     "kappa": float(truth["kappa"]),
                     "root_time": float(truth["root_time"])},
           "trace": trace, "max_drift": drift, "ledger_tol": tol,
           "log_G_mag": abs(float(run.ledger.log_G)), "seconds": dt,
           "topology": [int(run.topology_accepted),
                        int(run.topology_proposed)]}
    res.update(summarize(res, on_line))
    return res, run


def summarize(res: dict, on_line=print) -> dict:
    """The JAX script's summary lines and its RECOVERY rule."""
    from delphy_tpu_torch.ess import ess
    k, tr, truth = res["knobs"], res["trace"], res["truth"]
    mus = np.asarray(tr["mu"]) / 365.0
    kappas, troots = np.asarray(tr["kappa"]), np.asarray(tr["t_root"])
    muts, dt = tr["num_muts"], res["seconds"]
    acc, prop = res["topology"]
    e = {"mu": ess(mus), "kappa": ess(kappas), "t_root": ess(troots),
         "log_post": ess(np.asarray(tr["log_post"]))}
    on_line(f"samples: {k['samples']} (thin {k['thin']}) in {dt:.0f}s; "
            f"topo acc {acc}/{prop}")
    on_line(f"ESS: mu {e['mu']:.0f}, kappa {e['kappa']:.0f}, "
            f"t_root {e['t_root']:.0f} (of {k['samples']}); "
            f"ESS/hour(t_root) ~ {e['t_root'] / (dt / 3600.0):.0f}")
    on_line(f"clock rate: true {MU_TRUE * 365:.4f}/yr | "
            f"posterior {mus.mean() * 365:.4f} +- {mus.std() * 365:.4f}")
    on_line(f"kappa:      true {truth['kappa']:.2f}   | "
            f"posterior {kappas.mean():.2f} +- {kappas.std():.2f}")
    on_line(f"root time:  true {truth['root_time']:.1f} | "
            f"posterior {troots.mean():.1f} +- {troots.std():.1f}")
    on_line(f"num_muts:   {np.mean(muts):.0f} +- {np.std(muts):.0f}")
    ok = bool(abs(mus.mean() - MU_TRUE) < 4 * max(mus.std(), 0.1 * MU_TRUE)
              and abs(troots.mean() - truth["root_time"])
              < 5 * max(troots.std(), 10.0))
    on_line(f"RECOVERY: {'OK' if ok else 'OFF'}")
    return {"ess": e, "ess_per_hour_t_root": e["t_root"] / (dt / 3600.0),
            "posterior": {"mu_per_year": [mus.mean() * 365, mus.std() * 365],
                          "kappa": [kappas.mean(), kappas.std()],
                          "t_root": [troots.mean(), troots.std()]},
            "recovery_ok": ok}


def check_recipe(k: dict, pinned: bool, ref: dict) -> None:
    """Raises unless knobs ``k`` and ``pinned`` give configuration R's
    dataset and start."""
    data = ref["R"]["recipe"]["data"]
    if ((k["T"], k["L"], k["seed"]) != (data["tips"], data["sites"],
                                        data["seed"]) or not pinned):
        raise ValueError(f"--against needs R's dataset (VAL_T={data['tips']}"
                         f" VAL_L={data['sites']} VAL_SEED={data['seed']}) "
                         f"and --pinned")


def against(res: dict, ref: dict, on_line=print) -> dict:
    """``res``'s traces against configuration R of the JAX reference
    ``ref``: each summary's distance in joint MC standard errors from each
    JAX chain (scripts/torch_f32_study.py's compare) beside each chain's
    ESS, the JAX null, and whether the largest distance is under
    max(5, 3 x the null)."""
    from torch_f32_study import compare

    from delphy_tpu_torch.ess import ess
    R = ref["R"]
    rrun, k = R["recipe"]["run"], res["knobs"]
    check_recipe(k, res["pinned"], ref)
    chains = R["chains"]
    port = {"trace": res["trace"], "max_drift": res["max_drift"],
            "log_G_mag": res["log_G_mag"]}
    seeds = sorted(chains, key=int)
    cmp = {s: compare(port, chains[s]) for s in seeds}
    null = compare(chains[seeds[0]], chains[seeds[1]])
    bound = max(5.0, 3.0 * null["max_sigma"])
    worst = max(c["max_sigma"] for c in cmp.values())
    n_ess = {name: {key: ess(np.asarray(v)) for key, v in c["trace"].items()}
             for name, c in [("port", port)] + [(s, chains[s])
                                                for s in seeds]}
    on_line(f"against the JAX reference (R: burn {rrun['burn']}, "
            f"{rrun['samples']} samples x {rrun['thin']}; this run: burn "
            f"{k['burn']}, {k['samples']} x {k['thin']}):")
    for key in res["trace"]:
        sig = " | ".join(f"JAX {s} {cmp[s]['summaries'][key]['b_mean']:.6g} "
                         f"(ESS {n_ess[s][key]:.1f}) sigma "
                         f"{cmp[s]['summaries'][key]['sigma']:.2f}"
                         for s in seeds)
        port_mean = cmp[seeds[0]]["summaries"][key]["a_mean"]
        on_line(f"  {key:9s} port {port_mean:.6g} (ESS "
                f"{n_ess['port'][key]:.1f}) | {sig} | null sigma "
                f"{null['summaries'][key]['sigma']:.2f}")
    ok = worst < bound
    on_line(f"AGAINST JAX: largest sigma {worst:.2f}, null "
            f"{null['max_sigma']:.2f}, bound {bound:.2f}: "
            f"{'AGREE' if ok else 'DISAGREE'}")
    return {"sigma": {s: {key: v["sigma"] for key, v in c["summaries"].items()}
                      for s, c in cmp.items()},
            "null_sigma": {key: v["sigma"]
                           for key, v in null["summaries"].items()},
            "ess": n_ess, "max_sigma": worst,
            "null_max_sigma": null["max_sigma"], "bound": bound, "ok": ok}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", choices=("float64", "float32"),
                   help="default: float32 where DELPHY_TPU_F32 is set and "
                        "non-empty, else float64")
    p.add_argument("--pinned", action="store_true",
                   help="initial tree from the Python pipeline "
                        "(native=False), as the JAX reference's")
    p.add_argument("--json", metavar="OUT", help="write traces and summaries")
    p.add_argument("--against", metavar="REF",
                   help="data/jax_posterior_reference.json")
    args = p.parse_args(argv)
    dtype = getattr(torch, args.dtype) if args.dtype else None
    ref = None
    if args.against:
        with open(args.against) as f:
            ref = json.load(f)
        check_recipe(knobs(), args.pinned, ref)
    res, _ = recovery_chain(knobs(), args.device, dtype, args.pinned)
    ok = res["recovery_ok"]
    if ref is not None:
        res["against"] = against(res, ref)
        ok = ok and res["against"]["ok"]
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
