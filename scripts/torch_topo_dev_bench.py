#!/usr/bin/env python3
"""The missation-aware SPR1 sweep of the port (delphy_tpu_torch
ops/spr_miss.py) at production part shapes: the counterpart of
scripts/topo_dev_bench.py, on its dataset and with its knobs.

    python3 scripts/torch_topo_dev_bench.py [--device cuda|cpu]

Environment (as scripts/topo_dev_bench.py reads it): TOPO_BENCH_T (tips,
54), TOPO_BENCH_L (sites, 29903), TOPO_BENCH_LANES (8), TOPO_BENCH_MOVES
(moves a sweep, 64), DELPHY_TPU_F32 (set and non-empty: float32).  The part
is a simulated dataset (700 sampling days, 2% of sites missing, seed 3) on
a greedy tree rereferenced to its root sequence, mu 1e-3/365, kappa 2, the
rows' widths the packing's own, WRB = 2 WR + 8 and WH_ = 2 W.  Prints the
shapes, then the time per move of a sweep on one lane (after a warm-up
sweep, 3 sweeps timed) and per lane-move on TOPO_BENCH_LANES lanes, with
the accepted and performable counts, and one JSON line of it all.
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

MU = 1.0e-3 / 365
SEED = 3


def config() -> dict:
    env = os.environ.get
    return dict(T=int(env("TOPO_BENCH_T", "54")),
                L=int(env("TOPO_BENCH_L", "29903")),
                lanes=int(env("TOPO_BENCH_LANES", "8")),
                moves=int(env("TOPO_BENCH_MOVES", "64")),
                f32=bool(env("DELPHY_TPU_F32")))


def bench_tree(T: int, L: int):
    """The bench's part: scripts/topo_dev_bench.py's dataset and tree."""
    from delphy_tpu_torch.phylo import (build_greedy_tree,
                                        rereference_to_root_sequence)
    from delphy_tpu_torch.sim import simulate_dataset
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        T, L, mu=MU, sample_window_days=700.0, missing_fraction=0.02,
        seed=SEED)
    tree = build_greedy_tree(ref, deltas, miss, dates, names=names,
                             rng=np.random.default_rng(SEED))
    rereference_to_root_sequence(tree)
    return tree


def move_args(tree, device, dtype):
    """(packed tree, move arguments ``c``, t_max_tip, WRB, WH_) of the
    bench on ``device`` in ``dtype``."""
    from delphy_tpu_torch.evo import make_evo_params
    from delphy_tpu_torch.ops import spr_miss as sm
    evo = make_evo_params(tree.num_sites, mu=MU, kappa=2.0, device="cpu")
    q3 = evo.q_tab.numpy().reshape(-1, 4, 4)
    qa = np.stack([-np.diag(q) for q in q3])
    nu, part = evo.nu.numpy(), evo.part.numpy()
    rates = MU * nu * qa[part, tree.ref_seq]
    ref_cum = np.concatenate([[0.0], np.cumsum(rates)])

    def F(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(device, dtype)

    def I(a):
        return torch.as_tensor(np.asarray(a, np.int64)).to(device)
    c = dict(mu=F([MU]), nu=F(nu), qatab=F(qa.reshape(-1)),
             qtab=F(q3.reshape(-1)), part=I(part), ref_cum_Q=F(ref_cum),
             ref_seq=I(tree.ref_seq), lambda_ref=F([float(np.sum(rates))]))
    p = sm.pack_tree_miss(tree, device=device, dtype=dtype)
    t_max_tip = float(np.max(np.asarray(tree.t_max)[:tree.num_tips]))
    return p, c, t_max_tip, 2 * p["rs"].shape[1] + 8, \
        2 * p["msite"].shape[1]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args(argv)
    from delphy_tpu_torch import resolve_device
    from delphy_tpu_torch.ops import spr_miss as sm
    cfg = config()
    device = resolve_device(opts.device)
    dtype = torch.float32 if cfg["f32"] else torch.float64
    tree = bench_tree(cfg["T"], cfg["L"])
    p, c, t_max_tip, WRB, WH_ = move_args(tree, device, dtype)
    L, n, reps = cfg["L"], cfg["moves"], 3
    out = dict(cfg, N=tree.num_nodes, W=int(p["msite"].shape[1]),
               WR=int(p["rs"].shape[1]), WF=int(p["fsite"].shape[1]),
               WRB=WRB, WH=WH_, device=str(device), dtype=str(dtype))
    print(f"N={out['N']} W={out['W']} WR={out['WR']} WF={out['WF']} "
          f"WRB={WRB} WH={WH_} L={L} device={device} dtype={dtype}",
          flush=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    t0 = time.perf_counter()
    res = sm.spr1_sweep_miss(gen, p, L, n, c, t_max_tip, WRB, WH_)
    sync(device)
    print(f"single-lane warm-up: {time.perf_counter() - t0:.1f}s",
          flush=True)
    t0 = time.perf_counter()
    acc = perf = 0
    for _ in range(reps):
        res = sm.spr1_sweep_miss(gen, res.p, L, n, c, t_max_tip, WRB, WH_)
        acc += int(res.n_accepted)
        perf += int(res.n_eligible)
    sync(device)
    us = (time.perf_counter() - t0) * 1e6 / (reps * n)
    out.update(us_per_move=us, accepted=acc, performable=perf,
               moves_timed=reps * n)
    print(f"single-lane: {us:.1f} us/move (acc {acc}/{reps * n} perf "
          f"{perf})", flush=True)

    P = cfg["lanes"]
    lanes = sm.spr1_sweep_miss_lanes(gen, [p] * P, L, n, c, t_max_tip, WRB,
                                     WH_)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        lanes = sm.spr1_sweep_miss_lanes(gen, [r.p for r in lanes], L, n, c,
                                         t_max_tip, WRB, WH_)
    sync(device)
    us_l = (time.perf_counter() - t0) * 1e6 / (reps * n * P)
    acc_l = sum(int(r.n_accepted) for r in lanes)
    out.update(us_per_lane_move=us_l, lanes_accepted_last=acc_l)
    print(f"{P} lanes: {us_l:.1f} us/move amortized (acc {acc_l}/{n * P} "
          f"in the last sweep)", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
