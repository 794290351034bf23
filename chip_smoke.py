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
  5. with --profile only: where a boundary's time goes (profile_path);
  6. the command line at the same width: delphy_tpu_torch.cli.main in this
     process on the Ebola file with --v0-paranoid, writing .log, .trees, MCC
     and an npz snapshot; the .log's header and rows, the .trees read back,
     the snapshot loaded on the card and stepped beside the CLI's own run
     that never stopped (log_posterior compared with ==), the launch counts,
     and the three BEAST XML exports;
  7. the engine server: serve_in_thread on the card and, over the socket,
     create_run, run_steps twice with a get_state in between, set_params,
     get_tree_newick, both probers, get_mcc_nexus, save_snapshot +
     load_snapshot + both runs stepped at once and compared, list_runs,
     close_run and an unknown run_id (an RPC error); each request's wall
     time is printed; then the ledger check at 1e-6, the tree's integrity
     and the worker threads' launch counts.
Phases 6 and 7 also write a .dphy stream and read it back where the
flatbuffers package imports, and say so in one line where it does not.
The last three lines are the kernels' JSON record, the card line and
{"ok": true, "device": {...}}.  Needs a CUDA device; imports no jax.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
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
    counts = check_counts("on the main path")
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
    log(run.stats_line())
    log(f"main path: {total} local moves in {dt:.3f} s = "
        f"{total / dt:.1f} moves/s (f64, {card})")
    return counts


def have_flatbuffers() -> bool:
    """Whether the .dphy legs can run: the writer needs the flatbuffers
    package, which a GPU host may lack."""
    try:
        import flatbuffers  # noqa: F401
    except ImportError:
        log("no flatbuffers package on this host: the .dphy leg of phases 6 "
            "and 7 did NOT run (every other output path did)")
        return False
    return True


def check_counts(what: str) -> dict:
    from delphy_tpu_torch.parallel import _cuda
    counts = dict(_cuda.launch_counts)
    for k, v in counts.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} never launched {what}")
    log(f"launch counts {what}: {counts}")
    return counts


LOG_HEADER = ["Sample", "posterior", "likelihood_really_logG",
              "prior_for_Delphy", "treeLikelihood_really_logG", "TreeHeight",
              "clockRate", "kappa", "Coalescent", "ePopSize", "growthRate",
              "freqParameter.1", "freqParameter.2", "freqParameter.3",
              "freqParameter.4"]


def cli_path(device, card: str, dphy_leg: bool) -> dict:
    """Phase 6: the command line at full width, and exact resume."""
    from delphy_tpu_torch import cli
    from delphy_tpu_torch import run as run_mod
    from delphy_tpu_torch.io.dphy import read_dphy
    from delphy_tpu_torch.io.newick import read_beast_trees
    from delphy_tpu_torch.io.snapshot import load_run
    from delphy_tpu_torch.parallel import _cuda

    built = []

    class KeptRun(run_mod.Run):     # a handle on the Run the CLI builds
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    lm = 8050                       # 50 x 161 nodes: one boundary
    chunk = 62 * lm                 # four chunks: phase 4's 248 boundaries
    with tempfile.TemporaryDirectory() as tmp:
        out = {k: os.path.join(tmp, f"ebola.{k}")
               for k in ("log", "trees", "mcc", "npz", "dphy")}
        argv = ["--v0-in-maple", MAPLE, "--v0-seed", str(SEED),
                "--v0-target-coal-prior-cells", str(NUM_CELLS),
                "--v0-paranoid", "--v0-steps", str(4 * chunk),
                "--v0-log-every", str(chunk), "--v0-tree-every", str(chunk),
                "--v0-delphy-snapshot-every", str(2 * chunk),
                "--v0-out-log-file", out["log"],
                "--v0-out-trees-file", out["trees"],
                "--v0-out-mcc-file", out["mcc"],
                "--v0-out-delphy-file", out["npz"]]
        _cuda.reset_launch_counts()
        err = io.StringIO()
        plain_run, run_mod.Run = run_mod.Run, KeptRun
        try:
            with contextlib.redirect_stderr(err):
                t0 = time.perf_counter()
                code = cli.main(argv)
                sync(device)
                wall = time.perf_counter() - t0
        finally:
            run_mod.Run = plain_run
        for line in err.getvalue().splitlines():
            log(f"cli: {line}")
        if code != 0:
            raise AssertionError(f"cli.main returned {code}")
        counts = check_counts("on the CLI path")
        (run,) = built
        if run.device.type != "cuda" or run.local_moves_per_global_move != lm:
            raise AssertionError("the CLI's run is not the Ebola run on CUDA")
        if run.dispatch_count < 2 or run.burst_count < 1:
            raise AssertionError("CLI path needs >= 2 dispatches and a burst")
        rates = re.findall(r"\[([0-9.]+) Mmoves/s\]", err.getvalue())
        log(f"CLI loop: {run.dispatch_count} dispatches, {run.burst_count} "
            f"bursts, {run.local_moves_attempted} moves; its own last "
            f"reading {rates[-1]} Mmoves/s; cli.main as a whole (file read, "
            f"tree build and outputs included) {wall:.3f} s = "
            f"{run.local_moves_attempted / wall:.1f} moves/s (f64, {card})")

        with open(out["log"]) as f:
            rows = [ln.rstrip("\n").split("\t") for ln in f]
        if rows[0] != LOG_HEADER:
            raise AssertionError(f".log header {rows[0]}")
        if [r[0] for r in rows[1:]] != [str(chunk * i) for i in (1, 2, 3, 4)]:
            raise AssertionError(f".log samples {[r[0] for r in rows[1:]]}")
        vals = np.array([[float(v) for v in r] for r in rows[1:]])
        if vals.shape != (4, len(LOG_HEADER)) or not np.all(np.isfinite(vals)):
            raise AssertionError(".log rows are not finite")
        trees = read_beast_trees(out["trees"], np.zeros(18959, np.int8))
        if len(trees) != 4 or any(t.num_tips != 81 for _, t in trees):
            raise AssertionError(".trees did not read back with 81 tips")
        with open(out["mcc"]) as f:
            if "tree MCC =" not in f.read():
                raise AssertionError("no MCC tree written")

        # the snapshot of the last step against the run that never stopped
        loaded = load_run(out["npz"])
        if loaded.device.type != "cuda" or loaded.step != run.step:
            raise AssertionError("snapshot did not load on the card")
        for r in (run, loaded):
            r.do_mcmc_steps(12 * lm)
        a, b = run.log_posterior, loaded.log_posterior
        log(f"resume: never stopped {a!r}, from snapshot {b!r} at step "
            f"{run.step}")
        if a != b or not torch.equal(run.ts.t, loaded.ts.t):
            raise AssertionError(f"resume is not bit-equal: {a!r} != {b!r}")
        loaded.check_derived_quantities(1e-6)
        loaded.tree().check_integrity()

        # the CLI's BEAST XML exports read the run's parameters on the card
        for version in ("2.6.2", "2.7.7", "X-10.5.0"):
            path = os.path.join(tmp, f"beast_{version}.xml")
            code = cli.main(["--v0-in-maple", MAPLE, "--v0-seed", str(SEED),
                             "--v0-out-beast-version", version,
                             "--v0-out-beast-xml", path])
            with open(path) as f:
                xml = f.read()
            if code != 0 or not xml.rstrip().endswith("</beast>") \
                    or xml.count("<sequence") != 81:
                raise AssertionError(f"BEAST {version} XML export failed")
        log("cli: BEAST 2.6.2, 2.7.7 and X-10.5.0 XML exports written")

        if dphy_leg:
            code = cli.main(["--v0-in-maple", MAPLE, "--v0-seed", str(SEED),
                             "--v0-target-coal-prior-cells", str(NUM_CELLS),
                             "--v0-steps", str(4 * lm),
                             "--v0-log-every", str(2 * lm),
                             "--v0-tree-every", str(2 * lm),
                             "--v0-delphy-snapshot-every", str(2 * lm),
                             "--v0-out-delphy-file", out["dphy"]])
            df = read_dphy(out["dphy"])
            if code != 0 or len(df.samples) != 2 or len(df.names) != 161 \
                    or df.samples[1][1]["step"] != 4 * lm:
                raise AssertionError("the CLI's .dphy did not read back")
            log(f"cli .dphy: {os.path.getsize(out['dphy'])} bytes, 2 samples "
                f"read back")
    return counts


def server_path(device, card: str, dphy_leg: bool) -> dict:
    """Phase 7: the engine server answers a few requests on the card."""
    from delphy_tpu_torch.io.dphy import parse_params_fb, read_dphy
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.server import Client, serve_in_thread

    srv, engine, _th = serve_in_thread()     # the default device: CUDA
    if engine.device.type != "cuda":
        raise AssertionError("the server did not default to CUDA")
    client = Client(*srv.server_address)
    times = []

    def call(method, label=None, **params):
        t0 = time.perf_counter()
        res = client.call(method, **params)
        ms = (time.perf_counter() - t0) * 1e3
        times.append((label or method, ms))
        log(f"server request {label or method}: {ms:.3f} ms ({card})")
        return res

    def job(method, **params):
        """Submit a job: (job id, the time it was submitted)."""
        t0 = time.perf_counter()
        return client.call(method, **params)["job_id"], t0

    def wait(jid, t0, what):
        res = client.wait_job(jid, poll_s=0.005)
        ms = (time.perf_counter() - t0) * 1e3
        times.append((what, ms))
        log(f"server job {what}: {ms:.3f} ms to done ({card})")
        return res

    lm = 8050
    _cuda.reset_launch_counts()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            res = wait(*job("create_run", maple=MAPLE, seed=SEED,
                            num_cells=NUM_CELLS), "create_run")
            rid = res["run_id"]
            if (res["num_tips"], res["num_sites"]) != (81, 18959):
                raise AssertionError(f"create_run: {res}")
            res = wait(*job("run_steps", run_id=rid, n=10 * lm),
                       "run_steps (10 boundaries + burst)")
            if res["step"] != 10 * lm or not math.isfinite(
                    res["log_posterior"]):
                raise AssertionError(f"run_steps: {res}")
            jid, t0 = job("run_steps", run_id=rid, n=10 * lm)
            # waits for the step job's lock, held for a chunk of boundaries
            st = call("get_state", "get_state (beside a step job)",
                      run_id=rid)
            wait(jid, t0, "run_steps (second)")
            if st["num_nodes"] != 161 or not st["kappa"] > 0:
                raise AssertionError(f"get_state: {st}")
            call("set_params", run_id=rid, mu=1.1e-3 / 365.0)
            st = call("get_state", run_id=rid)
            if abs(st["mu"] - 1.1e-3 / 365.0) > 1e-15 \
                    or st["step"] != 20 * lm \
                    or not math.isfinite(st["log_posterior"]):
                raise AssertionError(f"get_state after set_params: {st}")
            nwk = call("get_tree_newick", run_id=rid)["newick"]
            if nwk.count("(") != 80 or not nwk.endswith(";"):
                raise AssertionError("get_tree_newick: not an 81-tip tree")
            t_lo, t_hi = st["t_root"], st["t_root"] + 400.0
            pa = np.asarray(call("probe_ancestors", run_id=rid,
                                 marked_ancestors=[81, 82], t_start=t_lo,
                                 t_end=t_hi, num_t_cells=32)["p"])
            ps = np.asarray(call("probe_site_states", run_id=rid, site=100,
                                 t_start=t_lo, t_end=t_hi,
                                 num_t_cells=32)["p"])
            for name, p, shape in (("probe_ancestors", pa, (3, 32)),
                                   ("probe_site_states", ps, (4, 32))):
                if p.shape != shape or not (np.all(p >= -1e-9)
                                            and np.all(p <= 1 + 1e-9)):
                    raise AssertionError(f"{name}: bad probabilities")
            mcc = call("get_mcc_nexus", run_id=rid)
            if "begin trees;" not in mcc["nexus"].lower() \
                    or mcc["num_base_trees"] < 2:
                raise AssertionError("get_mcc_nexus: no MCC tree")
            snap = os.path.join(tmp, "served.npz")
            call("save_snapshot", run_id=rid, path=snap)
            rid2 = call("load_snapshot", path=snap)["run_id"]
            j1, j2 = (job("run_steps", run_id=r, n=12 * lm)
                      for r in (rid, rid2))
            r1 = wait(*j1, "run_steps (served run, beside its twin)")
            r2 = wait(*j2, "run_steps (loaded twin)")
            log(f"two runs stepped at once: {r1['log_posterior']!r} and "
                f"{r2['log_posterior']!r}")
            if r1 != r2:
                raise AssertionError(f"the twin diverged: {r1} != {r2}")
            if dphy_leg:
                path = os.path.join(tmp, "served.dphy")
                res = call("export_dphy", run_id=rid, path=path)
                df = read_dphy(path)
                pfb = call("get_params_fb", run_id=rid)["params_fb"]
                import base64
                if res["bytes"] < 100 or len(df.samples) != 1 \
                        or parse_params_fb(base64.b64decode(pfb))["step"] \
                        != 32 * lm:
                    raise AssertionError("export_dphy did not read back")
            runs = {r["run_id"] for r in call("list_runs")["runs"]}
            if not runs >= {rid, rid2}:
                raise AssertionError(f"list_runs: {runs}")
            call("close_run", run_id=rid2)
            try:
                client.call("get_state", run_id=99999)
            except RuntimeError as e:
                log(f"unknown run_id came back as an RPC error: {e}")
            else:
                raise AssertionError("unknown run_id did not fail")
            if call("list_runs")["runs"] != [{"run_id": rid,
                                              "step": 32 * lm}]:
                raise AssertionError("the connection or the run list broke")
            run = engine._runs[rid].run
            if run.ts.t.device.type != "cuda":
                raise AssertionError("the served run is not on the card")
            run.check_derived_quantities(1e-6)
            run.tree().check_integrity()
    finally:
        client.close()
        srv.shutdown()
        srv.server_close()
    log("server request times, ms: " + json.dumps(
        {k: round(v, 3) for k, v in times}) + f" ({card})")
    return check_counts("from the server's worker threads")


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
    dphy_leg = have_flatbuffers()
    cli_path(device, card, dphy_leg)
    server_path(device, card, dphy_leg)
    print(json.dumps({"kernels": records, "launch_floor_ms": floor}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
