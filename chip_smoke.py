#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (delphy_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--baseline CSRC_DIR]

Phases, each of which raises (exit code != 0) on failure:
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from delphy_tpu_torch/csrc with nvcc (one
     process per source, all in parallel), with them the empty kernel of
     launch_floor.cu in a library of its own, and with --baseline DIR the
     kernel sources in DIR (another tree's delphy_tpu_torch/csrc with the
     same C interface);
  3. on a real boundary of the Ebola main path, hold each kernel against
     its plain PyTorch version on the card (same inputs, same uniforms), and
     time the kernel alone (CUDA events around the bare C entry point on
     pre-packed arguments), the Python wrapper (packing included) and the
     plain version; print one empty kernel's launch time as the floor, and
     each kernel's bound (bytes over HBM rate, operations over the FP64
     rate, the larger, operations counted from this run's work); with
     --baseline, time DIR's kernels on the same arguments in turns:
     baseline, this tree, this tree, baseline;
  4. drive the main path: read data/ebola2014_like_81x18959.maple, build the
     initial tree, Run(tree, seed=1, num_cells=400) on the card, several
     dispatches of do_mcmc_steps with topology bursts; then the ledger check
     at 1e-6 in f64, the tree's integrity and the kernels' launch counts;
  5. with --profile only: where a boundary's time goes (profile_path).
The last three lines are the kernels' JSON record, the card line and
{"ok": true, "device": {...}}.  Needs a CUDA device; imports no jax.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

MAPLE = os.path.join(REPO, "data", "ebola2014_like_81x18959.maple")
SEED = 1
NUM_CELLS = 400
REPS = 5            # plain versions and wrappers
KERNEL_REPS = 50    # bare kernel launches
# NVIDIA H100 SXM data sheet: HBM3 rate, FP64 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
# one f64 exp, expm1, log or log1p counted as this many operations
TRANSCENDENTAL_OPS = 20


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, reps: int = REPS) -> float:
    """Mean time of fn() in ms over reps runs after one warm-up; CUDA
    events on the card."""
    fn()
    sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def load_tree():
    from delphy_tpu_torch.init_tree import build_initial_tree
    from delphy_tpu_torch.io.maple import read_maple
    mf = read_maple(MAPLE)
    tips = mf.tips
    return build_initial_tree(mf.ref_seq, [t.deltas for t in tips],
                              [t.miss_intervals for t in tips],
                              [(t.t_min, t.t_max) for t in tips],
                              names=[t.name for t in tips],
                              rng=np.random.default_rng(42))


def assert_close(name, got, want, rtol=0.0, atol=0.0) -> float:
    got = torch.as_tensor(got, dtype=torch.float64).reshape(-1)
    want = torch.as_tensor(want, dtype=torch.float64).reshape(-1)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: max |err| {float(err.max()):.3e} "
                             f"beyond rtol {rtol} atol {atol}")
    return float(err.max()) if err.numel() else 0.0


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the FP64 rate."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP64_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def kernel_ms(lib, entry: str, args, reps: int = KERNEL_REPS) -> float:
    """ms per launch of the bare C entry point on pre-packed arguments."""
    from delphy_tpu_torch.parallel import _cuda
    fn = getattr(lib, entry)
    _cuda.check(fn(*args), entry)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def launch_floor_ms(path: str, reps: int = 200) -> float:
    """ms per launch of launch_floor.cu's empty kernel (built at ``path``),
    back to back on the stream."""
    import ctypes

    from delphy_tpu_torch.parallel import _cuda
    handle = ctypes.CDLL(path)
    handle.delphy_empty_launch.argtypes = [ctypes.c_void_p]
    handle.delphy_empty_launch.restype = ctypes.c_int
    return kernel_ms(handle, "delphy_empty_launch", (_cuda.stream_ptr(),),
                     reps)


def build_all(baseline):
    """Build, all at once, the package's kernels (with the compiler's
    report), the empty kernel, and with ``baseline`` that directory's kernel
    sources.  Returns (empty kernel's library path, baseline library or
    None)."""
    from concurrent.futures import ThreadPoolExecutor

    from delphy_tpu_torch.parallel import _cuda
    builds = [dict(verbose=True), dict(sources=("launch_floor.cu",))]
    if baseline:
        builds.append(dict(csrc_dir=baseline, sources=[
            s for s in _cuda.SOURCES
            if os.path.exists(os.path.join(baseline, s))]))
    with ThreadPoolExecutor(len(builds)) as ex:
        paths = list(ex.map(lambda kw: _cuda.build(**kw), builds))
    _cuda.lib()
    log(f"kernels built: {os.path.relpath(paths[0], REPO)}")
    return paths[1], (_cuda.load(paths[2]) if baseline else None)


def compare_baseline(name, entry, pk, outs_ref, base, tols) -> dict:
    """The baseline library's kernel on the same packed arguments: checked
    against this tree's outputs, then timed in turns with this tree
    (baseline, this tree, this tree, baseline)."""
    from delphy_tpu_torch.parallel import _cuda
    if base is None:
        return {}
    _cuda.check(getattr(base, entry)(*pk.args), f"baseline {entry}")
    for o, r, (rtol, atol) in zip(pk.outs, outs_ref, tols):
        assert_close(f"{name} baseline", o, r, rtol=rtol, atol=atol)
    own = _cuda.lib()
    t = [kernel_ms(base, entry, pk.args), kernel_ms(own, entry, pk.args),
         kernel_ms(own, entry, pk.args), kernel_ms(base, entry, pk.args)]
    res = {"ab_ms": {"baseline": [t[0], t[3]], "this": [t[1], t[2]]}}
    log(f"{name} ab_ms: {res['ab_ms']}")
    return res


def measure(name, entry, pk, wrapper, plain, ops, base, tols, device):
    """The record of one kernel: kernel-only, wrapper and plain times, the
    bound (``ops`` may be a function of the packed outputs after the timed
    launches), and the baseline's times."""
    from delphy_tpu_torch.parallel import _cuda
    ms = kernel_ms(_cuda.lib(), entry, pk.args)
    outs_ref = [o.clone() for o in pk.outs]
    if callable(ops):
        ops = ops(outs_ref)
    n_bytes = nbytes(pk.keep) + nbytes(pk.outs)
    bound_ms, bound_by = bound(n_bytes, ops)
    rec = dict(
        ms=ms, wrapper_ms=time_ms(wrapper, device),
        plain_ms=time_ms(plain, device),
        bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes, ops=ops,
        library_ms=None)   # no single PyTorch call computes an MH chain
    rec.update(compare_baseline(name, entry, pk, outs_ref, base, tols))
    log(f"{name}: kernel {rec['ms']:.4f} ms, wrapper "
        f"{rec['wrapper_ms']:.4f} ms, plain PyTorch {rec['plain_ms']:.4f} "
        f"ms, bound {bound_ms:.6f} ms ({bound_by}: {n_bytes} B, "
        f"{ops:.0f} ops)")
    return rec


def compare_kernels(run, device, base, floor_so):
    """Phase 3: each kernel against its plain version on one boundary."""
    from delphy_tpu_torch import DTYPE
    from delphy_tpu_torch.mcmc.kernel import run_global_moves
    from delphy_tpu_torch.parallel import block_cuda as bc
    from delphy_tpu_torch.parallel import hky_cuda, pop_cuda
    from delphy_tpu_torch.parallel.sweep import NB_MAX, prepare_sweep

    gen = run.gen
    ts, evo, pop, grid, caches, _ledger, stats = run_global_moves(
        run.ts, run.evo, run.pop, gen, run.tin, run.tout, run.t_max_tip,
        run.hyp, run.num_cells)
    records = []
    X = TRANSCENDENTAL_OPS

    # K1: HKY chain.  Operations per round, as the folded chain needs them:
    # four logs on the state (log1p of +-d / pi and R'/R for the frequency
    # move, R'/R for the kappa move), three on the uniforms (log scale and
    # the two accept tests) and ~60 other operations; then one HKY rate
    # matrix (~60).
    hyp = run.hyp
    n_rounds = 10
    u = torch.rand((n_rounds, hky_cuda.N_LANES), generator=gen, dtype=DTYPE,
                   device=device)
    args = (u, evo.mu, evo.kappa, evo.pi.reshape(1, 4),
            stats["Ttwiddle_a"], stats["M_ab"].to(DTYPE),
            caches.root_freq.reshape(1, 4),
            (hyp.kappa_prior_mean_log, hyp.kappa_prior_sigma_log), n_rounds)
    got = hky_cuda.hky_chain_kernel(*args)
    want = hky_cuda.hky_chain_torch(*args)
    err = max(assert_close(f"hky_chain {n}", g, w, rtol=1e-12, atol=1e-15)
              for n, g, w in zip(("kappa", "pi", "q"), got, want))
    path = hky_cuda.kernel_path(evo.kappa, evo.pi)
    log(f"hky_chain path: {path}")
    rec = dict(name="hky_chain", route="cuda",
               source="delphy_tpu_torch/csrc/hky_chain.cu",
               replaces="delphy_tpu/parallel/hky_pallas.py:135",
               max_abs_err=err, path=path)
    rec.update(measure(
        "hky_chain", "delphy_hky_chain", hky_cuda.pack_launch(*args),
        lambda: hky_cuda.hky_chain_kernel(*args),
        lambda: hky_cuda.hky_chain_torch(*args),
        n_rounds * (7 * X + 60) + 60, base, [(1e-12, 1e-15)] * 3, device))
    records.append(rec)

    # K2: exp-pop chain.  Operations, from the work the kernel reports in
    # out[2:4]: per full evaluation (the start and each g proposal inside
    # [g_min, g_max]) an exp and an expm1 and ~15 more per cell, ~4 per inner
    # node and two logs; per n0 proposal its scalars (four logs and ~26
    # more: the fold H / n0 + n_inner log n0 + X), and ~12 per cell more
    # where it was not folded; per g proposal a log and ~12 more.
    n_rounds = 50
    u = torch.rand((n_rounds, pop_cuda.N_LANES), generator=gen, dtype=DTYPE,
                   device=device)
    lbs, k2, t_row, inner = pop_cuda.pack_rows(grid, ts.t, ts.is_tip)
    hypf = pop_cuda.hyp_floats(hyp)
    args = (u, lbs, k2, t_row, inner, grid.t_step, pop.t0, pop.min_pop,
            pop.n0, pop.g, hypf, n_rounds)
    got = pop_cuda.exp_pop_chain_kernel(*args)
    want = pop_cuda.exp_pop_chain_torch(*args)
    err = max(assert_close(f"exp_pop_chain {n}", g, w, rtol=1e-12,
                           atol=1e-15)
              for n, g, w in zip(("n0", "g"), got, want))
    C, n_inner = lbs.numel(), int(inner.sum())

    def ops(outs):
        n0_per_cell, g_evaluated = (int(v) for v in outs[0][2:4].tolist())
        log(f"exp_pop_chain work: {n0_per_cell} of {n_rounds} n0 proposals "
            f"per cell, {g_evaluated} g proposals evaluated")
        full = (1 + g_evaluated) * (C * (2 * X + 15) + 4 * n_inner + 2 * X)
        n0 = (n_rounds * (4 * X + 26) if hypf[6] else 0) \
            + n0_per_cell * 12 * C
        return full + n0 + (n_rounds * (X + 12) if hypf[7] else 0)
    rec = dict(name="exp_pop_chain", route="cuda",
               source="delphy_tpu_torch/csrc/exp_pop_chain.cu",
               replaces="delphy_tpu/parallel/pop_pallas.py:171",
               max_abs_err=err)
    rec.update(measure(
        "exp_pop_chain", "delphy_exp_pop_chain", pop_cuda.pack_launch(*args),
        lambda: pop_cuda.exp_pop_chain_kernel(*args),
        lambda: pop_cuda.exp_pop_chain_torch(*args), ops, base,
        [(1e-12, 1e-15)], device))
    records.append(rec)

    # K3: sweep chain, at the block count Run.do_mcmc_steps would use.
    # Operations: per block step and part ~300 (the single move's scalars),
    # ~30 per node (windows, reform) and ~8 per slot; per move made ~150
    # (its proposal's two transcendentals and dq over a few cells).
    stat, ctx_arrs, shared, t_p, _mut = prepare_sweep(
        ts, evo, pop, grid, caches, run.pm, gen, run.t_max_tip, run.num_cells)
    nb = max(1, min(NB_MAX, round(run.local_moves_per_global_move
                                  / run._per_block_rate)))
    P = t_p.shape[0]
    u = bc.gen_block_uniforms(gen, P, nb, stat.NC, stat.MC, device)
    got = bc.sweep_chain_kernel(stat, nb, ctx_arrs, shared, u)
    want = bc.sweep_chain_torch(stat, nb, ctx_arrs, shared, u)
    tol = {"t": (0.0, 1e-9), "mut_t": (0.0, 1e-9), "k_p": (0.0, 1e-9),
           "dG": (1e-10, 1e-12), "dC": (1e-10, 1e-12), "cnt": (0.0, 0.0)}
    err = 0.0
    for n, g, w in zip(tol, got, want):
        rtol, atol = tol[n]
        e = assert_close(f"sweep_chain {n}", g, w, rtol=rtol, atol=atol)
        if n in ("t", "mut_t", "k_p"):
            err = max(err, e)
    moved = float((got[0].reshape(t_p.shape) - t_p).abs().max())
    moves = float(got[5].sum())
    if not moved > 0.0 or not moves > 0.0:
        raise AssertionError("sweep_chain moved nothing")
    log(f"sweep_chain at P={P} NC={stat.NC} MC={stat.MC} C={stat.C} "
        f"n_blocks={nb}: {int(moves)} moves")
    ops = nb * P * (300 + 30 * stat.NC + 8 * stat.MC) + 150 * moves
    rec = dict(name="sweep_chain", route="cuda",
               source="delphy_tpu_torch/csrc/sweep_chain.cu",
               replaces="delphy_tpu/parallel/block_pallas.py:465",
               max_abs_err=err)
    rec.update(measure(
        "sweep_chain", "delphy_sweep_chain",
        bc.pack_launch(stat, nb, ctx_arrs, shared, u),
        lambda: bc.sweep_chain_kernel(stat, nb, ctx_arrs, shared, u),
        lambda: bc.sweep_chain_torch(stat, nb, ctx_arrs, shared, u), ops,
        base, [(0.0, 1e-9)] * 3 + [(1e-10, 1e-12)], device))
    records.append(rec)
    floor = launch_floor_ms(floor_so)
    log(f"launch floor: {floor:.5f} ms per empty kernel launch")
    return records, floor


def main_path(device, card: str):
    """Phase 4: the main path through the user-facing entry points."""
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.run import Run

    tree = load_tree()
    run = Run(tree, seed=SEED, num_cells=NUM_CELLS, device=device)
    lm = run.local_moves_per_global_move
    log(f"Run: P={run.device_partitions} parts, n_cap={run.pm.n_cap}, "
        f"m_cap={run.pm.m_cap}, {lm} local moves per boundary, "
        f"{run.topology_burst_chunks} boundaries per burst")
    _cuda.reset_launch_counts()
    run.do_mcmc_steps(2 * lm)            # short call: 1 dispatch + burst
    sync(device)
    base = run.local_moves_attempted
    t0 = time.perf_counter()
    run.do_mcmc_steps(lm * run.topology_burst_chunks)
    total = run.local_moves_attempted - base
    sync(device)
    dt = time.perf_counter() - t0
    counts = dict(_cuda.launch_counts)
    log(f"dispatches {run.dispatch_count}, bursts {run.burst_count}, "
        f"topology moves {run.topology_proposed} proposed / "
        f"{run.topology_accepted} accepted")
    if run.dispatch_count < 2 or run.burst_count < 1:
        raise AssertionError("main path needs >= 2 dispatches and a burst")
    run.check_derived_quantities(1e-6)
    tree_out = run.tree()
    tree_out.check_integrity()
    if not (np.all(np.isfinite(tree_out.t))
            and math.isfinite(run.log_posterior)):
        raise AssertionError("non-finite state after the main path")
    for k, v in counts.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} never launched on the main path")
    log(run.stats_line())
    log(f"launch counts on the main path: {counts}")
    log(f"main path: {total} local moves in {dt:.3f} s = "
        f"{total / dt:.1f} moves/s (f64, {card})")
    return counts


def _union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def profile_path(device, n: int = 40) -> dict:
    """--profile: where a boundary's time goes on the main path.

    A Run without topology moves dispatches n boundaries untraced (host
    enqueue and wall time per boundary), then n more under torch.profiler:
    device time per kernel and the device's busy share, both from that one
    traced window (the trace is kept in delphy_tpu_torch/_build/).  Then
    run_global_moves alone, and two topology bursts of the main path's size
    on a second Run."""
    from torch.profiler import ProfilerActivity, profile

    from delphy_tpu_torch.mcmc.kernel import run_global_moves
    from delphy_tpu_torch.parallel._cuda import BUILD_DIR
    from delphy_tpu_torch.run import Run

    run = Run(load_tree(), seed=SEED, num_cells=NUM_CELLS, device=device,
              topology_moves_enabled=False)
    lm = run.local_moves_per_global_move
    run.do_mcmc_steps(lm * n)                       # warm-up
    sync(device)
    base = run.local_moves_attempted
    t0 = time.perf_counter()
    run.do_mcmc_steps(lm * n)
    enq = time.perf_counter() - t0
    sync(device)
    wall = time.perf_counter() - t0
    moves = run.local_moves_attempted - base
    rec = {"boundaries": n, "wall_ms_per_boundary": wall * 1e3 / n,
           "enqueue_ms_per_boundary": enq * 1e3 / n,
           "moves_per_s_no_bursts": moves / wall}

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run.do_mcmc_steps(lm * n)
        sync(device)
        traced = time.perf_counter() - t0
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, "profile_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        raise AssertionError("the profiler traced no device activity")
    groups = {"sweep_chain": 0.0, "exp_pop_chain": 0.0, "hky_chain": 0.0,
              "torch ops": 0.0}
    n_torch = 0
    for e in dev:
        key = next((k for k in groups if f"{k}_kernel" in e["name"]),
                   "torch ops")
        groups[key] += float(e["dur"])
        n_torch += key == "torch ops"
    busy_us = _union_us((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                        for e in dev)
    rec.update({
        "traced_wall_ms_per_boundary": traced * 1e3 / n,
        "device_ms_per_boundary": {k: v * 1e-3 / n for k, v in groups.items()},
        "torch_device_ops_per_boundary": n_torch / n,
        "traced_busy_share": busy_us * 1e-6 / traced})

    args = (run.ts, run.evo, run.pop, run.gen, run.tin, run.tout,
            run.t_max_tip, run.hyp, run.num_cells)
    run_global_moves(*args)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        run_global_moves(*args)
    enq = time.perf_counter() - t0
    sync(device)
    rec["global_moves_ms"] = {"enqueue": enq * 1e3 / n,
                              "wall": (time.perf_counter() - t0) * 1e3 / n}
    del run

    run = Run(load_tree(), seed=SEED, num_cells=NUM_CELLS, device=device)
    lm = run.local_moves_per_global_move
    n_moves = run.topology_burst_chunks * int(lm * 2.0 / 30.0)
    run.do_mcmc_steps(lm)
    secs = []
    for _ in range(2):
        sync(device)
        t0 = time.perf_counter()
        run._topology_burst(n_moves)
        sync(device)
        secs.append(time.perf_counter() - t0)
    run.check_derived_quantities(1e-6)
    rec["burst"] = {"moves": n_moves, "s": secs}
    log(f"profile: {json.dumps(rec)}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the main path, profile a boundary (phase 5)")
    ap.add_argument("--baseline", metavar="CSRC_DIR",
                    help="also time another tree's kernel sources (phase 3)")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    from delphy_tpu_torch.run import Run

    card = card_line()
    print(card, flush=True)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    floor_so, base = build_all(opts.baseline)
    log(f"built in {time.perf_counter() - t0:.1f} s")

    run = Run(load_tree(), seed=SEED, num_cells=NUM_CELLS, device=device)
    run.do_mcmc_steps(run.local_moves_per_global_move)
    records, floor = compare_kernels(run, device, base, floor_so)
    del run

    counts = main_path(device, card)
    for r in records:
        r["launches"] = counts[r["name"]]
    if opts.profile:
        profile_path(device)
    print(json.dumps({"kernels": records, "launch_floor_ms": floor}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
