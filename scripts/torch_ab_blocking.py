#!/usr/bin/env python3
"""Times the port's blocking driver (delphy_tpu_torch) in two trees on one
CUDA card, in turns: OTHER, this tree, this tree, OTHER.

    python3 scripts/torch_ab_blocking.py OTHER_ROOT [--windows N]

OTHER_ROOT is another checkout of the repo (for example a ``git archive``
of a parent commit unpacked under an ignored directory).  Each turn is a
fresh process that imports the package and ``chip_smoke.py`` of its own
tree, builds that tree's kernels, then times:

  * the Ebola main path of chip_smoke phase 4 (Run(seed=1, num_cells=400),
    a short call, then windows of one burst's boundaries): moves/s of each
    window, and the end state after the first window (phase 4's);
  * the 10,000-tip tree of chip_smoke phase 9c through the blocking driver
    (DELPHY_TPU_OVERLAP=0): after a warm-up, windows of three bursts'
    boundaries, moves/s of each.

Prints one JSON line per turn and writes all of them, with the card's
name and power limit, to chiprun_out/ab_blocking.json.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_turn(root: str, windows: int) -> dict:
    """The readings of one tree, in this process."""
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    from delphy_tpu_torch import run as run_mod
    from delphy_tpu_torch.parallel import _cuda
    assert os.path.realpath(run_mod.__file__).startswith(
        os.path.realpath(root)), run_mod.__file__
    device = torch.device("cuda", 0)
    _cuda.build()
    _cuda.lib()

    def drive(run, n):
        torch.cuda.synchronize(device)
        base = run.local_moves_attempted
        t0 = time.perf_counter()
        run.do_mcmc_steps(n)
        torch.cuda.synchronize(device)
        return (run.local_moves_attempted - base) / (time.perf_counter() - t0)

    out = {"root": root}
    os.environ["DELPHY_TPU_OVERLAP"] = "0"
    run = run_mod.Run(cs.load_tree(), seed=cs.SEED, num_cells=cs.NUM_CELLS,
                      device=device)
    lm, nb = run.local_moves_per_global_move, run.topology_burst_chunks
    run.do_mcmc_steps(2 * lm)
    rates = [drive(run, lm * nb)]
    out["ebola_end_state"] = {"step": run.step,
                              "log_post": run.log_posterior}
    rates += [drive(run, lm * nb) for _ in range(windows - 1)]
    out["ebola_moves_per_s"] = rates
    del run

    run = run_mod.Run(cs.sim_tree(cs.LARGE_TIPS, cache=True), seed=cs.SEED,
                      num_cells=cs.NUM_CELLS, device=device)
    lm = run.local_moves_per_global_move
    B = max(1, min(run.topology_burst_chunks, run_mod.RESTENCIL_INTERVAL,
                   run_mod.OVERLAP_DISPATCH_MOVES // lm))
    drive(run, B * lm)                                   # warm-up
    out["tips10k_moves_per_s"] = [drive(run, 3 * B * lm)
                                  for _ in range(windows)]
    run.check_derived_quantities(1e-6)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the other tree")
    ap.add_argument("--windows", type=int, default=4)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.one:
        print("TURN " + json.dumps(one_turn(opts.other, opts.windows)),
              flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    other = os.path.abspath(opts.other)
    turns = []
    for root in (other, HERE, HERE, other):
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), root, "--one",
             "--windows", str(opts.windows)], capture_output=True, text=True)
        if r.returncode:
            print(r.stdout[-4000:], r.stderr[-8000:], file=sys.stderr)
            return r.returncode
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("TURN ")]
        turns.append(dict(json.loads(line[-1][5:]),
                          tree="other" if root == other else "this"))
        print(json.dumps(turns[-1]), flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "ab_blocking.json"),
              "w") as f:
        json.dump({"card": card, "turns": turns}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
