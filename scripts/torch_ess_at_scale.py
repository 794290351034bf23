#!/usr/bin/env python3
"""ESS per hour of the port (delphy_tpu_torch), the counterpart of
scripts/ess_at_scale.py, whose knobs, dataset, Run recipe and JSON keys it
keeps.

    python3 scripts/torch_ess_at_scale.py [--device cuda]
        [--dtype float32|float64]

Runs the blocking driver on a simulated dataset of ESS_T tips for
ESS_WINDOW seconds, sampling the posterior every ESS_SAMPLE_MOVES moves,
and prints one JSON line: ESS and ESS per hour of the log-posterior, mu
and the root time (initial-positive-sequence estimator,
delphy_tpu_torch/ess.py), their Monte-Carlo standard errors, moves/s, and
beside the JAX script's keys the card (``nvidia-smi --query-gpu=name,
power.limit``), the float dtype and the kernels' launch counts over the
window.

Env knobs (scripts/ess_at_scale.py's):
  ESS_T        tips (default 1000)
  ESS_L        sites (default 29903)
  ESS_WINDOW   seconds of sampling (default 1800)
  ESS_CHUNKS   override topology_burst_chunks (0 = the Run's default)
  ESS_SAMPLE_MOVES  moves between posterior samples (0 = one dispatch
               cycle, local moves per boundary x topology_burst_chunks)
  ESS_BURN_MOVES  local moves to burn before the sampling window
  ESS_STATE_NPZ  resume the run from a snapshot (io/snapshot.py) instead
               of building it from the tree
  ESS_SAVE_NPZ  save a snapshot after burn (before the window)
  ESS_TREE_PKL  start from a pickled initial tree (the port's FlatTree)
The run is on the card unless ``--device cpu`` is given, and in float32
(the JAX script sets DELPHY_TPU_F32=1) unless ``--dtype float64`` or an
empty DELPHY_TPU_F32 says float64.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def printer(t0: float):
    """A progress line printer, seconds counted from ``t0``."""
    return lambda msg: print(f"[ess +{time.time() - t0:.0f}s] {msg}",
                             flush=True)


def card_line(device) -> str | None:
    """The card's name and power limit as nvidia-smi gives them; None off
    the card."""
    if torch.device(device).type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else None


def make_run(T: int, L: int, device, dtype=None, tree_pkl: str = "",
             state_npz: str = "", say=None):
    """The JAX script's run: a snapshot, a pickled tree, or its simulated
    dataset (seed 42), each with Run(seed=1, num_cells=400).  Progress
    lines go to ``say``."""
    from delphy_tpu_torch import resolve_device
    from delphy_tpu_torch.run import Run

    device = resolve_device(device)
    say = say or printer(time.time())
    if state_npz:  # resume a burned state (cadence A/B from the same point)
        from delphy_tpu_torch.io.snapshot import load_run
        run = load_run(state_npz, device=device)
        say(f"state loaded ({run.ts.num_tips}x{run.ts.num_sites})")
        return run
    if tree_pkl:
        import pickle
        with open(tree_pkl, "rb") as f:
            tree = pickle.load(f)
        say(f"tree loaded ({tree.num_tips}x{tree.num_sites})")
    else:
        from delphy_tpu_torch.init_tree import build_initial_tree
        from delphy_tpu_torch.sim import simulate_dataset
        ref, deltas, miss, dates, names, _ = simulate_dataset(
            T, L, mu=1.0e-3 / 365, sample_window_days=700.0,
            missing_fraction=0.02, seed=42)
        tree = build_initial_tree(ref, deltas, miss, dates, names=names,
                                  rng=np.random.default_rng(42))
        say(f"tree built ({T}x{L})")
    return Run(tree, seed=1, num_cells=400, device=device, dtype=dtype)


def measure(run, window: float, sample_moves: int = 0, burn: int = 0,
            chunks: int = 0, save_npz: str = "", say=None) -> dict:
    """The JAX script's window on ``run``: a warm-up call, ``burn`` moves,
    then samples every ``sample_moves`` moves for ``window`` seconds.
    Returns the JAX script's keys plus dtype and the launch counts over the
    window (``kernels``).  Progress lines go to ``say``."""
    from delphy_tpu_torch.ess import ess, mcse
    from delphy_tpu_torch.parallel import _cuda

    say = say or printer(time.time())
    if chunks > 0:
        run.topology_burst_chunks = chunks
    n = sample_moves or \
        run.local_moves_per_global_move * run.topology_burst_chunks
    run.do_mcmc_steps(n)  # warm
    say(f"warm (chunks={run.topology_burst_chunks}, "
            f"P={run.device_partitions})")
    if burn > 0:
        run.do_mcmc_steps(burn)
        say(f"burn {burn} done (log_post {run.log_posterior:.1f})")
    if save_npz:
        from delphy_tpu_torch.io.snapshot import save_run
        save_run(run, save_npz)
        say(f"snapshot -> {save_npz}")

    lp, mus, troots = [], [], []
    _cuda.reset_launch_counts()
    t_start = time.time()
    base = run.local_moves_attempted
    while time.time() - t_start < window:
        run.do_mcmc_steps(n)
        lp.append(run.log_posterior)
        mus.append(float(run.evo.mu))
        # a one-element index: a 0-d one would sync the card
        troots.append(float(run.ts.t[run.ts.root.long()]))
    dt = time.time() - t_start
    moves = run.local_moves_attempted - base
    kernels = {k: v for k, v in _cuda.launch_counts.items() if v}
    # f32 drift scales with the window; hold RELATIVE drift to 5e-7,
    # floored at the small-problem absolute tol
    run.check_derived_quantities(
        max(5e-2, 5e-7 * abs(float(run.ledger.log_G))))
    hours = dt / 3600.0
    lp, mus, troots = map(np.array, (lp, mus, troots))
    out = {
        "T": run.ts.num_tips, "L": run.ts.num_sites,
        "window_s": round(dt, 1),
        "samples": len(lp),
        "moves": int(moves),
        "moves_per_s": round(moves / dt, 1),
        "topology_burst_chunks": run.topology_burst_chunks,
        "topology_proposed": int(run.topology_proposed),
        "ess_log_post": round(ess(lp), 1),
        "ess_mu": round(ess(mus), 1),
        "ess_t_root": round(ess(troots), 1),
        "ess_per_hour_log_post": round(ess(lp) / hours, 1),
        "ess_per_hour_mu": round(ess(mus) / hours, 1),
        "ess_per_hour_t_root": round(ess(troots) / hours, 1),
        "sd_log_post": round(float(np.std(lp, ddof=1)), 3),
        "mcse_log_post": round(mcse(lp), 3),
        "mcse_mu_rel": round(mcse(mus) / max(abs(np.mean(mus)), 1e-300), 4),
        "mcse_t_root": round(mcse(troots), 2),
        "sample_moves": n,
        "dtype": str(run.dtype).replace("torch.", ""),
        "kernels": kernels,
    }
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", choices=("float32", "float64"),
                   help="default: float32, as the JAX script sets "
                        "DELPHY_TPU_F32=1 (an empty DELPHY_TPU_F32 keeps "
                        "float64)")
    args = p.parse_args(argv)
    from delphy_tpu_torch import resolve_device
    resolve_device(args.device)
    os.environ.setdefault("DELPHY_TPU_F32", "1")
    dtype = getattr(torch, args.dtype) if args.dtype else None
    env = os.environ.get
    say = printer(time.time())
    card = card_line(args.device)
    run = make_run(int(env("ESS_T", "1000")), int(env("ESS_L", "29903")),
                   args.device, dtype, tree_pkl=env("ESS_TREE_PKL", ""),
                   state_npz=env("ESS_STATE_NPZ", ""), say=say)
    out = measure(run, float(env("ESS_WINDOW", "1800")),
                  sample_moves=int(env("ESS_SAMPLE_MOVES", "0")),
                  burn=int(env("ESS_BURN_MOVES", "0")),
                  chunks=int(env("ESS_CHUNKS", "0")),
                  save_npz=env("ESS_SAVE_NPZ", ""), say=say)
    out["card"] = card
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
