#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (delphy_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--baseline CSRC_DIR] [--large-tips N]
        [--ess-windows EBOLA_S TIPS1K_S]

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
     rate, the larger, operations counted from this run's work); the same
     for the skygrid build of the sweep kernel on a real skygrid boundary of
     each type; with --baseline, time DIR's kernels on the same arguments in
     turns: baseline, this tree, this tree, baseline (and give the largest
     difference of their outputs from this tree's);
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
     and the three BEAST XML exports; then the CLI with --v0-pop-model
     skygrid --v0-site-rate-heterogeneity and with --v0-mpox-hack (both
     --v0-paranoid, each path's launch counts and graph replays > 0);
  7. the engine server: serve_in_thread on the card and, over the socket,
     create_run, run_steps twice with a get_state in between, set_params,
     get_tree_newick, both probers, get_mcc_nexus, save_snapshot +
     load_snapshot + both runs stepped at once and compared, list_runs,
     close_run and an unknown run_id (an RPC error); each request's wall
     time is printed; then the ledger check at 1e-6, the tree's integrity
     and the worker threads' launch counts; then create_run with pop_model
     "skygrid", stepped, its ledger, launch counts and graph replays > 0;
  8. the model options at the same width, each through CUDA graphs: four
     Runs (skygrid staircase and log-linear with the defaults, 50
     parameters and tau 1; the exponential model with alpha/nu moves; the
     mpox hack), each two dispatches with a burst after each, then the
     ledger check at 1e-6, the tree's integrity, the kernels each path
     must launch (and no other), graph replays > 0, the captures (ms, pool
     bytes, block counts), ms per boundary beside phase 4's; (ii) graph
     and eager in turns, MODEL_PAIRS pairs of fresh Runs dispatching
     MODEL_PROFILE_BOUNDARIES boundaries (phase 16(b)'s method): ms a
     boundary, moves/s, no host sync inside a dispatch, busy share, launch
     calls and device operations a boundary; the share of an eager
     boundary that the path's own move takes (the skygrid's HMC, the
     alpha/nu moves, the mpox mu/rho moves) and that move's device time
     inside a CUDA graph beside a graph boundary; a snapshot that resumes
     bit-equal; (i) a graph Run and an eager Run of one seed (phase
     16(a)'s recipe with a long call of MODEL_AB_BOUNDARIES) bit-equal in
     float64 and float32.  Record under "options" in
     chiprun_out/dispatch_graph.json;
  9. large trees: (a) Run(device_partitions=1) on 1,000 simulated tips
     (the reference scale bench's settings) with each population model,
     whose one part needs the sweep kernel's global build: two boundaries
     and a burst, the ledger at 1e-6, the tree's integrity, only the global
     build launched, and that build against the plain version on the run's
     own boundary; (b) the global build against the plain version at
     NC=1152, MC=3200, C=400 (8 parts of a boundary of each model padded
     to those widths), timed as in phase 3; (c) a 10,000-tip tree through
     the blocking driver, then the overlapped driver (forced on with
     DELPHY_TPU_OVERLAP=1; its gate is at ~60k tips), both through CUDA
     graphs (phase 16): moves/s of each,
     each cycle's stage times, the parts each L-dispatch swept, the host
     syncs in an L-dispatch's enqueue, the device's busy share over one
     traced cycle of each driver, the sweep kernel's build, shared bytes,
     ms per launch and uniform bytes at that shape, an overlapped cycle
     bit-equal to the same cycle forced sequential, and a snapshot after
     an overlapped cycle that resumes bit-equal; (d) with --large-tips N,
     the same at N tips (the scale bench's 100,000 x 29,903) with the
     reference's default gate instead of the forced switch;
 10. more than one GPU (one process per device, parallel/distributed.py):
     (a) two ranks sharing the card over gloo on the main path's Run
     (seed=1, num_cells=400; two dispatches, each ending in a burst), each
     rank bit-equal (t, mut_t, generator state, ledger, counters) to the
     same run in this process (through CUDA graphs), the ranks through the
     eager loop (no graph replay: a staged mesh's all-reduce goes through
     the host, and the line says so), its ledger at 1e-6 (with the ranks'
     replica check), the tree's integrity, every kernel of the path
     launched and each sweep launch covering P/D parts, and the
     reassembly all-reduce timed at that shape; (b) the counterpart of
     the JAX package's dryrun_multichip on the same two ranks: 512 tips x
     1024 sites with DELPHY_TPU_PART_CAP forcing the oversized-part
     splitter, at least 2 bursts, a repartition and an overlapped mesh
     cycle, the ledger at 1e-5 and integrity; (c) where at least two
     cards are visible, one rank per card over NCCL (D = min(4, cards)),
     every dispatch through CUDA graphs with the all-reduce inside (graph
     replays > 0 on every rank): (a)'s bit-equality with the one-process
     graph run, then the 10,000-tip tree of phase 9c through the blocking
     driver on one card in this process and on D cards, moves/s of each,
     and the all-reduce's ms per boundary, bytes (8 (N + M + 3P)) and
     share of the wall; on one card, (c) says in a line that it did not
     run.  The ranks' records go to
     chiprun_out/mesh.json;
 11. the unpartitioned step (mcmc/kernel.py super_step and
     multi_super_step, mcmc/moves.py; on the card replays of one
     boundary's CUDA graph, parallel/dispatch_graph.py): (a) the JAX
     package's __graft_entry__.entry problem (8 x 64 simulated,
     Run(seed=0, num_cells=64)), one super_step of 32 local moves, its
     ledger equal to a from-scratch recompute; (b) the main path's Run
     (seed=1, num_cells=400, 8,050 local moves a boundary): multi_super_step
     over 10 boundaries through graphs and through the eager loop (its
     private _eager) in turns (graph, eager, eager, graph) from one
     generator state, all bit-equal (state, ledger, move count, generator)
     and equal to 10 super_step calls, the ledger against the recompute,
     check_derived_quantities(1e-6) and the tree's integrity, hky_chain and
     exp_pop_chain launched 10 times each and no sweep kernel on each path,
     10 graph replays on the graph path only, ms per boundary (wall and
     enqueue) of each turn, local moves attempted per second, the busy
     share of each path over 2 boundaries under torch.profiler, the
     captures (ms, pool bytes), no host sync inside a graph dispatch and
     the host syncs in one sweep's eager enqueue; (c) one sweep's draws
     made on the card and the same cores run on the CPU and on the card,
     agreeing to 1e-10.  Record in chiprun_out/unpartitioned.json;
 12. the f32 engine (DELPHY_TPU_F32=1, the JAX package's production
     precision and bench.py's): (a) each kernel's float32 build (C entries
     *_f32) against its float32 plain version on the card, at phase 3's
     shapes (exponential and both skygrid types, exp_pop, hky), at phase
     9b's shape NC=1152, MC=3200, C=400 (the global build in float64, a
     shared one in float32) and at NC=2304, MC=6400 (global in both), and
     exp_pop's node rows at N=19,999 and N=40,000: max abs err, counts
     equal, kernel, wrapper and plain ms, the bound at 4 bytes a float and
     the FP32 rate, beside the float64 kernel's ms of this call; the
     float32 global builds launched by one-part Runs on 1,000 tips; no
     float64 instruction in any float32 kernel's SASS (cuobjdump); (b)
     bench.py's recipe on the port: the frozen Ebola MAPLE,
     build_initial_tree(rng=42), Run(seed=1, num_cells=400) under
     DELPHY_TPU_F32=1, bench.py's warm-up, then calls of lm x
     topology_burst_chunks moves in turns with the same recipe in float64
     (f64, f32, f32, f64): moves/s of each, check_derived_quantities(0.05),
     the tree's integrity, only *_f32 entries launched, the end log_post;
     (e) that run saved and resumed bit-equal; (c) phase 9c's 10,000-tip
     tree through the blocking driver in float32, moves/s beside phase 9c's
     float64 figure, with the sweep build, shared bytes per part and
     uniform MB a boundary of each precision; (d)
     scripts/torch_f32_study.py at 200,000 steps (f32, f64 and a second
     f64 seed, 40 tips x 1,200 sites).  The f32 records join the kernels'
     JSON line;
 13. the Python topology mixer fallback and the device SPR (no kernel of
     its own: the kernels' line is unchanged): (a) in a child process
     started with DELPHY_TPU_NATIVE=0 on this process's trees, the main
     path's Run (phase 4's tree) for a dispatch and the Python burst that
     follows (P=8 parts on the spawn pool): the ledger at 1e-6, the tree's
     integrity, the three kernels launched, the burst's seconds and ms per
     topology move beside phase 4's native burst; (a2) in the same child,
     run_partitioned_bursts on phase 9a's 1,000-tip tree (P=4, 2,000
     moves) through the pool, log_G recomputed on the card equal to the
     start plus the returned delta to 1e-6; no pool worker initialised
     CUDA; (b) ops/spr_move.py at scripts/topo_dev_bench.py's part size
     without missing data (54 tips x 29,903 sites, greedy tree, seed 3)
     and at 300 tips: 64 spr1_sweep moves on one lane, 16 on each of 8
     lanes and 64 slide moves on the card, each through graphs (one move's
     CUDA graph, which the lanes share, replayed) and through the eager
     loop in turns from one generator state, bit-equal, and replayed on the CPU from the
     card's draws (trees equal, times and delta_log_G 1e-12), log_G
     recomputed from each final tree equal to the start plus the summed
     deltas (1e-9 of |log_G|), integrity, moves accepted; ms per move
     through graphs, eager and on the CPU, host syncs a sweep on each
     path, reruns, the captures (move, ms, pool bytes); a forced case of
     2 lanes x 4 moves with 4 history attempts a slot (32 by default), whose
     moves run out of attempts: graph and eager bit-equal, the graph path
     rerunning lanes (reruns and eager moves > 0), no lane left exhausted,
     each lane's ledger; one float32 single-lane sweep through graphs held
     to the float32 ledger scale.
     Record in chiprun_out/device_spr.json;
 14. the missation-aware device SPR (ops/spr_miss.py; no kernel of its
     own) at scripts/topo_dev_bench.py's part (54 tips x 29,903 sites, 2%
     missing, greedy tree, seed 3; scripts/torch_topo_dev_bench.py builds
     it), through graphs (one move's CUDA graph, which the lanes share)
     and through the eager loop in turns from one generator state, bit-equal: (a) 64
     spr1_sweep_miss moves on one lane on the card, replayed move by move
     on the CPU from the card's draws (packed trees equal, times and
     delta_log_G 1e-12), log_G recomputed from the final tree equal to the
     start plus the summed deltas (1e-9 of |log_G|), the tree's integrity,
     the accepted, performable and multi-branch-info counts, ms per move
     on each path and the CPU, host syncs a sweep, reruns and the draws'
     bytes per lane; (b) SPR_LANES lanes of 16 moves each, each lane's
     ledger; (b2) phase 13(b)'s forced case on this part, each lane's
     ledger; (c) one float32 lane of 64 moves through graphs held to the
     float32 ledger scale; the captures (move, ms, pool bytes).  Record in
     chiprun_out/device_spr_miss.json;
 15. the posterior against the JAX package's (no kernel of its own): (a)
     configuration R of data/jax_posterior_reference.json (VALIDATION.md's
     48 tips x 6,000 sites, the JAX chains' pinned start, burn-in and
     samples) through scripts/torch_validate_recovery.py on the card, one
     chain in float64 and one in float32 (seed 101): the script's lines and
     RECOVERY, each summary's distance in joint Monte-Carlo standard errors
     from both committed JAX chains beside the JAX null (the run fails above
     max(5, 3 x the null) or on RECOVERY: OFF), the ledger (float64 1e-6,
     float32 the scaled bench bound), the tree's integrity and the three
     kernels' launch counts; (b) scripts/torch_ess_at_scale.py in float32
     on the Ebola main path's tree and on phase 9a's 1,000-tip tree: after
     a burn-in, a 45 s and a 60 s window (--ess-windows for longer) of
     samples, ESS and ESS per hour of the log-posterior, mu and the root
     time, their MCSE and moves/s, the float32 kernels launched in each
     window.  Record in chiprun_out/posterior.json;
 16. the compiled dispatch (parallel/dispatch_graph.py: every dispatch of
     both drivers as replays of one boundary's CUDA graph, on every model
     option and on a mesh over NCCL, which phases 4-10, 12(b) and 15 now
     run; a mesh of ranks sharing one card stays eager;
     check_counts reads the launch counts that graph replays add to and
     prints the replays beside them):
     (a) phase 4's recipe from one tree and seed through graphs and
     through the eager loop (parts_multi_super_step's private _eager), in
     float64 and float32: the state, the ledger, local_moves_attempted and
     the generator's state bit-equal, the three kernels' launch counts
     equal, graph replays > 0 on the graph path only, the ledger (1e-6,
     float32 the scaled bench bound), each path's moves/s; (b) graph and
     eager in turns, three pairs, a fresh Run without topology moves each
     dispatching 24 boundaries at the main path's block count: ms a
     boundary (wall, enqueue), moves/s, no host sync inside the dispatch
     (syncs_in), the device's busy share, the host's launch calls and the
     device operations a boundary under torch.profiler (phase 5's method),
     the captures (ms, pool bytes) and none for a size already captured;
     (c) phase 9c's 10,000-tip tree through the blocking driver on a
     graph Run and an eager Run of one seed: six warm-up calls each, then
     three pairs of calls in turns, moves/s and captures of every call,
     one traced call of each (busy share), the runs bit-equal, the ledger
     at 1e-6, the dispatches by block count, the graphs held and their
     pools' bytes (graph_large(device, card, tips, warm, pairs) for other
     sizes); (d) the same tree through the overlapped driver
     (DELPHY_TPU_OVERLAP=1) on a graph Run and an eager Run of one seed,
     ten cycles each in turns in float64 (L's block count settles),
     four in float32: the runs
     bit-equal (state, ledger, move count, both generators, each cycle's
     counts and launch counts), G's and L's replays, the ledger and
     integrity, each cycle's stage times, L block count and captures (ms,
     blocks, pool bytes); in float64 the G and L dispatches alone on each
     path (ms a boundary, no host sync inside through graphs, busy share,
     launch calls and device operations a boundary) and one traced cycle
     of each (graph_overlap(device, card, tips, cycles) for other sizes).
     Record in chiprun_out/dispatch_graph.json.
Phases 1-11, 13 and 14 run in float64 whatever DELPHY_TPU_F32 says (the
script clears it and sets it only for phase 12, as bench.py sets it; phase
15 names each run's dtype), so
`python3 chip_smoke.py` and `DELPHY_TPU_F32=1 python3 chip_smoke.py` run
the same checks.
Phases 6 and 7 also write a .dphy stream and read it back where the
flatbuffers package imports, and say so in one line where it does not.
The last three lines are the kernels' JSON record, the card line and
{"ok": true, "device": {...}}.  Needs a CUDA device; imports no jax.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
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
# phase 9: the reference scale bench's dataset (scripts/make_tree100k.py)
SCALE_SITES = 29903
SCALE_SEED = 77
ONE_PART_TIPS = 1000
LARGE_TIPS = 10_000
REPS = 5            # plain versions and wrappers
KERNEL_REPS = 50    # bare kernel launches
# NVIDIA H100 SXM data sheet: HBM3 rate, FP64 and FP32 rates outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
FP32_OPS_PER_S = 67e12
F32_ENV = "DELPHY_TPU_F32"
# one f64 exp, expm1, log or log1p counted as this many operations
TRANSCENDENTAL_OPS = 20


T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[chip_smoke {time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


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


def bound(n_bytes: float, ops: float, dtype=torch.float64):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the FP64 (or, for float32 work, FP32) rate."""
    rate = FP32_OPS_PER_S if dtype == torch.float32 else FP64_OPS_PER_S
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / rate * 1e3
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
    check_f32_sass(paths[0])
    return paths[1], (_cuda.load(paths[2]) if baseline else None)


# SASS opcodes of float64 work: arithmetic, compares, min/max, and any
# conversion to or from float64
F64_OPCODE = re.compile(r"^(DADD|DMUL|DFMA|DSETP|DMNMX|DMMA|DRCP)|\.F64")
# the float32 instantiations of the three kernel templates (hky 1, exp_pop
# 2, sweep 3 models x 2 builds): mangled names with the float argument
N_F32_KERNELS = 9


def check_f32_sass(lib_path: str) -> None:
    """Phase 12: no float64 instruction in the SASS of any float32 kernel
    (cuobjdump -sass of the built library; mangled kernel names with the
    float template argument, ``kernelIf``).  Where the toolkit has no
    cuobjdump this prints that the check did not run."""
    exe = "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        log("no cuobjdump: the float32 kernels' SASS was NOT checked")
        return
    sass = subprocess.run([exe, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    f64, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if "kernelIf" in m.group(1) else None
            if fn:
                f64.setdefault(fn, set())
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", line)
        if fn and m and F64_OPCODE.search(m.group(1)):
            f64[fn].add(m.group(1))
    bad = {k: sorted(v) for k, v in f64.items() if v}
    if len(f64) != N_F32_KERNELS or bad:
        raise AssertionError(f"float32 kernels in the SASS: {len(f64)} of "
                             f"{N_F32_KERNELS}; float64 instructions: {bad}")
    log(f"SASS of the {len(f64)} float32 kernels: no float64 instruction")


def compare_baseline(name, entry, pk, outs_ref, base, tols) -> dict:
    """The baseline library's kernel on the same packed arguments: checked
    against this tree's outputs, then timed in turns with this tree
    (baseline, this tree, this tree, baseline)."""
    from delphy_tpu_torch.parallel import _cuda
    if base is None or not hasattr(base, entry):
        return {}
    _cuda.check(getattr(base, entry)(*pk.args), f"baseline {entry}")
    diff = max(assert_close(f"{name} baseline", o, r, rtol=rtol, atol=atol)
               for o, r, (rtol, atol) in zip(pk.outs, outs_ref, tols))
    own = _cuda.lib()
    t = [kernel_ms(base, entry, pk.args), kernel_ms(own, entry, pk.args),
         kernel_ms(own, entry, pk.args), kernel_ms(base, entry, pk.args)]
    res = {"ab_ms": {"baseline": [t[0], t[3]], "this": [t[1], t[2]]},
           "baseline_max_abs_err": diff}
    log(f"{name} ab_ms: {res['ab_ms']}, outputs differ from the baseline's "
        f"by at most {diff!r}")
    return res


def measure(name, entry, pk, wrapper, plain, ops, base, tols, device):
    """The record of one kernel: kernel-only, wrapper and plain times, the
    bound (``ops`` may be a function of the packed outputs after the timed
    launches; the rate is that of the outputs' dtype), and the baseline's
    times."""
    from delphy_tpu_torch.parallel import _cuda
    ms = kernel_ms(_cuda.lib(), entry, pk.args)
    outs_ref = [o.clone() for o in pk.outs]
    if callable(ops):
        ops = ops(outs_ref)
    n_bytes = nbytes(pk.keep) + nbytes(pk.outs)
    bound_ms, bound_by = bound(n_bytes, ops, pk.outs[0].dtype)
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


# kernel-vs-plain tolerances (rtol, atol) by dtype.  float64: the kernels
# repeat the plain arithmetic (sums in another order).  float32: the JAX
# package's own f32 tolerances (tests/test_block_pallas.py,
# test_pop_pallas.py, test_hky_pallas.py), t and mut_t with a relative
# term of 4 float32 ulps beside the JAX atol of 5e-5 (Ebola times lie near
# -2,000 days, where one ulp is 1.2e-4)
CHAIN_TOL = {torch.float64: (1e-12, 1e-15), torch.float32: (1e-4, 1e-7)}
SWEEP_TOL = {"t": (0.0, 1e-9), "mut_t": (0.0, 1e-9), "k_p": (0.0, 1e-9),
             "dG": (1e-10, 1e-12), "dC": (1e-10, 1e-12), "cnt": (0.0, 0.0)}
SWEEP_TOL_F32 = {"t": (5e-7, 5e-5), "mut_t": (5e-7, 5e-5),
                 "k_p": (0.0, 1e-3), "dG": (1e-3, 1e-3), "dC": (1e-3, 1e-3),
                 "cnt": (0.0, 0.0)}


def sweep_tol(dtype) -> dict:
    return SWEEP_TOL_F32 if dtype == torch.float32 else SWEEP_TOL


def check_sweep(name, got, want, dtype) -> float:
    """The sweep kernel's outputs against the plain chain's at the dtype's
    tolerances (counts equal); the largest error of t, mut_t and k_p."""
    err = 0.0
    for n, g, w in zip(SWEEP_TOL, got, want):
        e = assert_close(f"{name} {n}", g, w, *sweep_tol(dtype)[n])
        if n in ("t", "mut_t", "k_p"):
            err = max(err, e)
    return err


def compare_kernels(run, device, base, floor_so, dtype=torch.float64):
    """Phase 3 (and, in float32, phase 12a): each kernel against its plain
    version on one boundary of ``run`` (whose dtype is ``dtype``).  Records
    are named by C entry without ``delphy_`` (``hky_chain_f32``, ...)."""
    from delphy_tpu_torch.mcmc.kernel import run_global_moves
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.parallel import block_cuda as bc
    from delphy_tpu_torch.parallel import hky_cuda, pop_cuda
    from delphy_tpu_torch.parallel.sweep import NB_MAX, prepare_sweep

    if run.dtype != dtype:
        raise AssertionError(f"a {run.dtype} run for {dtype} kernels")
    sfx = _cuda.suffix(dtype)
    chain_tol = CHAIN_TOL[dtype]
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
    u = torch.rand((n_rounds, hky_cuda.N_LANES), generator=gen, dtype=dtype,
                   device=device)
    args = (u, evo.mu, evo.kappa, evo.pi.reshape(1, 4),
            stats["Ttwiddle_a"], stats["M_ab"].to(dtype),
            caches.root_freq.reshape(1, 4),
            (hyp.kappa_prior_mean_log, hyp.kappa_prior_sigma_log), n_rounds)
    got = hky_cuda.hky_chain_kernel(*args)
    want = hky_cuda.hky_chain_torch(*args)
    err = max(assert_close(f"hky_chain{sfx} {n}", g, w, *chain_tol)
              for n, g, w in zip(("kappa", "pi", "q"), got, want))
    path = hky_cuda.kernel_path(evo.kappa, evo.pi)
    log(f"hky_chain{sfx} path: {path}")
    rec = dict(name="hky_chain" + sfx, route="cuda",
               source="delphy_tpu_torch/csrc/hky_chain.cu",
               replaces="delphy_tpu/parallel/hky_pallas.py:135",
               max_abs_err=err, path=path)
    rec.update(measure(
        "hky_chain" + sfx, "delphy_hky_chain" + sfx,
        hky_cuda.pack_launch(*args),
        lambda: hky_cuda.hky_chain_kernel(*args),
        lambda: hky_cuda.hky_chain_torch(*args),
        n_rounds * (7 * X + 60) + 60, base, [chain_tol] * 3, device))
    records.append(rec)

    # K2: exp-pop chain.  Operations, from the work the kernel reports in
    # out[2:4]: per full evaluation (the start and each g proposal inside
    # [g_min, g_max]) an exp and an expm1 and ~15 more per cell, ~4 per inner
    # node and two logs; per n0 proposal its scalars (four logs and ~26
    # more: the fold H / n0 + n_inner log n0 + X), and ~12 per cell more
    # where it was not folded; per g proposal a log and ~12 more.
    n_rounds = 50
    u = torch.rand((n_rounds, pop_cuda.N_LANES), generator=gen, dtype=dtype,
                   device=device)
    lbs, k2, t_row, inner = pop_cuda.pack_rows(grid, ts.t, ts.is_tip)
    hypf = pop_cuda.hyp_floats(hyp)
    args = (u, lbs, k2, t_row, inner, grid.t_step, pop.t0, pop.min_pop,
            pop.n0, pop.g, hypf, n_rounds)
    got = pop_cuda.exp_pop_chain_kernel(*args)
    want = pop_cuda.exp_pop_chain_torch(*args)
    err = max(assert_close(f"exp_pop_chain{sfx} {n}", g, w, *chain_tol)
              for n, g, w in zip(("n0", "g"), got, want))
    C, n_inner = lbs.numel(), int(inner.sum())

    def ops(outs):
        n0_per_cell, g_evaluated = (int(v) for v in outs[0][2:4].tolist())
        log(f"exp_pop_chain{sfx} work: {n0_per_cell} of {n_rounds} n0 "
            f"proposals per cell, {g_evaluated} g proposals evaluated")
        full = (1 + g_evaluated) * (C * (2 * X + 15) + 4 * n_inner + 2 * X)
        n0 = (n_rounds * (4 * X + 26) if hypf[6] else 0) \
            + n0_per_cell * 12 * C
        return full + n0 + (n_rounds * (X + 12) if hypf[7] else 0)
    rec = dict(name="exp_pop_chain" + sfx, route="cuda",
               source="delphy_tpu_torch/csrc/exp_pop_chain.cu",
               replaces="delphy_tpu/parallel/pop_pallas.py:171",
               max_abs_err=err)
    rec.update(measure(
        "exp_pop_chain" + sfx, "delphy_exp_pop_chain" + sfx,
        pop_cuda.pack_launch(*args),
        lambda: pop_cuda.exp_pop_chain_kernel(*args),
        lambda: pop_cuda.exp_pop_chain_torch(*args), ops, base,
        [chain_tol], device))
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
    u = bc.gen_block_uniforms(gen, P, nb, stat.NC, stat.MC, device, dtype)
    got = bc.sweep_chain_kernel(stat, nb, ctx_arrs, shared, u)
    want = bc.sweep_chain_torch(stat, nb, ctx_arrs, shared, u)
    err = check_sweep("sweep_chain" + sfx, got, want, dtype)
    moved = float((got[0].reshape(t_p.shape) - t_p).abs().max())
    moves = float(got[5].sum())
    if not moved > 0.0 or not moves > 0.0:
        raise AssertionError("sweep_chain moved nothing")
    log(f"sweep_chain{sfx} at P={P} NC={stat.NC} MC={stat.MC} C={stat.C} "
        f"n_blocks={nb}: {int(moves)} moves")
    ops = nb * P * (300 + 30 * stat.NC + 8 * stat.MC) + 150 * moves
    rec = dict(name="sweep_chain" + sfx, route="cuda",
               source="delphy_tpu_torch/csrc/sweep_chain.cu",
               replaces="delphy_tpu/parallel/block_pallas.py:465",
               max_abs_err=err)
    rec.update(measure(
        "sweep_chain" + sfx, bc.entry(stat, 0, dtype),
        bc.pack_launch(stat, nb, ctx_arrs, shared, u),
        lambda: bc.sweep_chain_kernel(stat, nb, ctx_arrs, shared, u),
        lambda: bc.sweep_chain_torch(stat, nb, ctx_arrs, shared, u), ops,
        base, [sweep_tol(dtype)[k] for k in ("t", "mut_t", "k_p", "dG")],
        device))
    records.append(rec)
    records.append(compare_skygrid_sweep(device, base, dtype))
    if floor_so is None:
        return records, None
    floor = launch_floor_ms(floor_so)
    log(f"launch floor: {floor:.5f} ms per empty kernel launch")
    return records, floor


def compare_skygrid_sweep(device, base, dtype=torch.float64) -> dict:
    """K3's skygrid build against its plain version on a real skygrid
    boundary of each type (a skygrid Run of the Ebola file after one
    boundary, in ``dtype``), with phase 3's tolerances (or the float32
    ones); the record times the staircase (the default type) and gives the
    log-linear type's times beside it, and the skygrid build's launches in
    those Runs' boundaries.  Operations: K3's count, plus two log N(t) per
    move made (a binary search over the knots and the staircase pick or
    interpolation, ~20)."""
    from delphy_tpu_torch import pop as popm
    from delphy_tpu_torch.mcmc.kernel import run_global_moves
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.parallel import block_cuda as bc
    from delphy_tpu_torch.parallel.sweep import NB_MAX, prepare_sweep
    from delphy_tpu_torch.run import Run

    sfx = _cuda.suffix(dtype)
    rec = dict(name="sweep_chain_skygrid" + sfx, route="cuda",
               source="delphy_tpu_torch/csrc/sweep_chain.cu",
               replaces="delphy_tpu/parallel/block_pallas.py:465",
               jax_skygrid_route="delphy_tpu/parallel/sweep.py:328 "
                                 "(XLA part_sweep)")
    err = 0.0
    for type_, label in ((popm.LOG_LINEAR, "log_linear"),
                         (popm.STAIRCASE, "staircase")):
        run = Run(load_tree(), seed=SEED, num_cells=NUM_CELLS, device=device,
                  pop_model="skygrid", skygrid_type=type_, dtype=dtype)
        _cuda.reset_launch_counts()
        run.do_mcmc_steps(run.local_moves_per_global_move)
        sky_counts = check_counts(f"on a {label} skygrid boundary{sfx}",
                                  tuple(k + sfx for k in SKYGRID_PATH))
        gen = run.gen
        ts, evo, pop, grid, caches, _ledger, _stats = run_global_moves(
            run.ts, run.evo, run.pop, gen, run.tin, run.tout, run.t_max_tip,
            run.hyp, run.num_cells)
        stat, ctx_arrs, shared, t_p, _mut = prepare_sweep(
            ts, evo, pop, grid, caches, run.pm, gen, run.t_max_tip,
            run.num_cells)
        if stat.pop != type_:
            raise AssertionError("the skygrid boundary packed another model")
        nb = max(1, min(NB_MAX, round(run.local_moves_per_global_move
                                      / run._per_block_rate)))
        P = t_p.shape[0]
        u = bc.gen_block_uniforms(gen, P, nb, stat.NC, stat.MC, device,
                                  dtype)
        got = bc.sweep_chain_kernel(stat, nb, ctx_arrs, shared, u)
        want = bc.sweep_chain_torch(stat, nb, ctx_arrs, shared, u)
        err = max(err, check_sweep(f"sweep_chain_skygrid{sfx} ({label})",
                                   got, want, dtype))
        moves = float(got[5].sum())
        if not moves > 0.0 or not float(
                (got[0].reshape(t_p.shape) - t_p).abs().max()) > 0.0:
            raise AssertionError("sweep_chain_skygrid moved nothing")
        K = shared['x'].numel()
        log(f"sweep_chain_skygrid{sfx} ({label}) at P={P} NC={stat.NC} "
            f"MC={stat.MC} C={stat.C} K={K} n_blocks={nb}: {int(moves)} "
            f"moves")
        ops = nb * P * (300 + 30 * stat.NC + 8 * stat.MC) + 190 * moves
        m = measure(f"sweep_chain_skygrid{sfx} ({label})",
                    bc.entry(stat, K, dtype),
                    bc.pack_launch(stat, nb, ctx_arrs, shared, u),
                    lambda: bc.sweep_chain_kernel(stat, nb, ctx_arrs, shared,
                                                  u),
                    lambda: bc.sweep_chain_torch(stat, nb, ctx_arrs, shared,
                                                 u),
                    ops, base, [sweep_tol(dtype)[k] for k in
                                ("t", "mut_t", "k_p", "dG")], device)
        m["launches_one_boundary"] = sky_counts["sweep_chain_skygrid" + sfx]
        if type_ == popm.STAIRCASE:
            rec.update(m)
        else:
            rec["log_linear"] = {k: m[k] for k in (
                "ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by",
                "launches_one_boundary")}
        del run
    rec["max_abs_err"] = err
    return rec


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
    bursts = timed_bursts(run)
    _cuda.reset_launch_counts()
    run.do_mcmc_steps(2 * lm)            # short call: 1 dispatch + burst
    sync(device)
    base = run.local_moves_attempted
    t0 = time.perf_counter()
    run.do_mcmc_steps(lm * run.topology_burst_chunks)
    total = run.local_moves_attempted - base
    sync(device)
    dt = time.perf_counter() - t0
    counts = check_counts("on the main path", graphs=True)
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
    log(f"main path's graphs: {graph_summary(run)}")
    n_b = run.topology_burst_chunks
    log(f"main path: {total} local moves in {dt:.3f} s = "
        f"{total / dt:.1f} moves/s, {dt * 1e3 / n_b:.3f} ms per boundary "
        f"({n_b} boundaries and a burst; f64, {card})")
    b = bursts[0]
    native_burst = {"s": b["s"], "moves": b["moves"],
                    "ms_per_topology_move": b["s"] * 1e3 / b["moves"],
                    "all_s": [x["s"] for x in bursts]}
    log(f"native topology bursts: {json.dumps(native_burst)}")
    return counts, dt * 1e3 / n_b, native_burst


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


# the kernels each path launches every boundary (and no other)
EXP_PATH = ("hky_chain", "exp_pop_chain", "sweep_chain")
SKYGRID_PATH = ("hky_chain", "sweep_chain_skygrid")
MPOX_PATH = ("exp_pop_chain", "sweep_chain")


def check_counts(what: str, path=EXP_PATH, graphs=None) -> dict:
    """The kernels' launch counts since the last reset, graph replays
    included (each replay adds its capture's launches): every kernel of
    ``path`` launched, no other.  ``graphs`` True: the launches came
    through CUDA graphs (replays > 0); False: through the eager loop (no
    replay); None: either."""
    from delphy_tpu_torch.parallel import _cuda
    counts = dict(_cuda.launch_counts)
    replays = _cuda.graph_replays
    for k, v in counts.items():
        if k in path and v <= 0:
            raise AssertionError(f"kernel {k} never launched {what}")
        if k not in path and v != 0:
            raise AssertionError(f"kernel {k} launched {v} times {what}, "
                                 f"off its path")
    if graphs is not None and (replays > 0) != graphs:
        raise AssertionError(f"{replays} graph replays {what}, expected "
                             f"{'some' if graphs else 'none'}")
    log(f"launch counts {what}: "
        f"{ {k: v for k, v in counts.items() if v} }, "
        f"graph replays {replays}")
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


MODEL_BOUNDARIES = 24     # boundaries of a path's timed dispatch
MODEL_AB_BOUNDARIES = 8   # (i): the long call of graph = eager
MODEL_PAIRS = 2           # (ii): graph and eager in turns, this many pairs
MODEL_PROFILE_BOUNDARIES = 4   # (ii): boundaries a reading


def model_options():
    """(name, Run arguments, kernels of the path) of phase 8's options."""
    from delphy_tpu_torch import pop as popm
    from delphy_tpu_torch.mcmc.global_moves import PriorConfig
    return [
        ("skygrid staircase", dict(pop_model="skygrid"), SKYGRID_PATH),
        ("skygrid log-linear", dict(pop_model="skygrid",
                                    skygrid_type=popm.LOG_LINEAR),
         SKYGRID_PATH),
        ("alpha/nu", dict(hyp=PriorConfig(alpha_move_enabled=True)),
         EXP_PATH),
        ("mpox", dict(mpox_hack=True), MPOX_PATH)]


def model_paths(device, card: str, exp_ms: float):
    """Phase 8: the model options at full Ebola width, each through CUDA
    graphs.  Returns the skygrid kernel's launches per skygrid path and
    the phase's record (phase 16 writes it into
    chiprun_out/dispatch_graph.json under "options", and so does this
    phase)."""
    from delphy_tpu_torch.io.snapshot import load_run, save_run
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.run import Run

    sky_launches, times = {}, {"exp (phase 4)": exp_ms}
    out = {"card": card}
    B = MODEL_BOUNDARIES
    with tempfile.TemporaryDirectory() as tmp:
        for name, kw, path in model_options():
            t_opt = time.perf_counter()
            rec = out[name] = {}
            run = Run(load_tree(), seed=SEED, num_cells=NUM_CELLS,
                      device=device, **kw)
            lm = run.local_moves_per_global_move
            _cuda.reset_launch_counts()
            run.do_mcmc_steps(2 * lm)          # dispatch + flush burst
            sync(device)
            t0 = time.perf_counter()
            run.do_mcmc_steps(B * lm)          # dispatch + flush burst
            sync(device)
            dt = time.perf_counter() - t0
            # every model option's boundaries are graph replays
            counts = check_counts(f"on the {name} path", path, graphs=True)
            if run.dispatch_count < 2 or run.burst_count < 2:
                raise AssertionError(f"{name}: needs 2 dispatches and bursts")
            run.check_derived_quantities(1e-6)
            run.tree().check_integrity()
            if not (np.all(np.isfinite(run.ts.t.cpu().numpy()))
                    and math.isfinite(run.log_posterior)):
                raise AssertionError(f"{name}: non-finite state")
            times[name] = dt * 1e3 / B
            rec.update(ms_per_boundary_graph_run=times[name],
                       launch_counts={k: v for k, v in counts.items() if v},
                       graphs=graph_summary(run))
            log(f"{name}: {run.stats_line()}")
            log(f"{name}: {times[name]:.3f} ms per boundary ({B} boundaries "
                f"and a burst, through graphs) beside the exponential "
                f"path's {exp_ms:.3f} in phase 4; graphs "
                f"{json.dumps(rec['graphs'])} ({card})")
            if name.startswith("skygrid"):
                sky_launches[name.split()[1]] = counts["sweep_chain_skygrid"]
            rec["b"] = graph_profile(device, card, kw, MODEL_PAIRS,
                                     MODEL_PROFILE_BOUNDARIES, f"8(ii) {name}")
            rec["move"] = move_share(run, name, {
                p: float(np.mean([r["wall_ms_per_boundary"]
                                  for r in rec["b"][p]]))
                for p in ("graph", "eager")}, device, card)
            # a snapshot written on the card resumes bit-equal there
            snap = os.path.join(tmp, "model.npz")
            save_run(run, snap)
            loaded = load_run(snap)
            for r in (run, loaded):
                r.do_mcmc_steps(3 * lm)
            if run.log_posterior != loaded.log_posterior \
                    or not torch.equal(run.ts.t, loaded.ts.t):
                raise AssertionError(f"{name}: resume is not bit-equal")
            log(f"{name}: resume bit-equal at step {run.step}: "
                f"{run.log_posterior!r}")
            del run, loaded
            rec["a"] = graph_against_eager(
                device, card, kw, MODEL_AB_BOUNDARIES, f"8(i) {name}")
            rec["seconds"] = time.perf_counter() - t_opt
        out["ms_per_boundary"] = times
        keys = ("wall_ms_per_boundary", "moves_per_s_no_bursts",
                "busy_share", "launch_calls_per_boundary",
                "device_ops_per_boundary")
        out["summary"] = {
            name: {p: {k: [r[k] for r in out[name]["b"][p]] for k in keys}
                   for p in ("graph", "eager")}
            for name, _kw, _p in model_options()}
        log("ms per boundary by path: " + json.dumps(
            {k: round(v, 3) for k, v in times.items()}) + f" ({card})")
        log(f"phase 8 summary: {json.dumps(out['summary'])} ({card})")
    write_dispatch_graph({"card": card, "options": out})
    return sky_launches, out


def graph_ms_of(fn, gen, device, what: str, n: int = 20,
                traced: int = 4) -> dict:
    """fn()'s device time inside a CUDA graph: warmed up once on a side
    stream (autograd's first run there), captured with ``gen`` registered,
    replayed ``n`` times: ms a replay by CUDA events; then ``traced``
    replays under torch.profiler: the device's busy ms and operations a
    replay."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.stream(side):
        fn()
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(side)
    ms = time_ms(graph.replay, device, reps=n)
    tr = busy_share(lambda: [graph.replay() for _ in range(traced)],
                    f"{what} as a graph, {traced} replays")
    return {"event_ms": ms, "busy_ms": tr["device_busy_s"] * 1e3 / traced,
            "device_ops": tr["device_events"] / traced}


def move_share(run, name, boundary_ms: dict, device, card: str,
               n: int = 10):
    """Host time of a boundary's global moves, and of the move this path
    adds, alone, on the eager loop: the skygrid's HMC, the alpha/nu moves
    (with the per-site statistics they read) or the mpox hack's mu/rho
    moves (with theirs), and its share of an eager boundary
    (``boundary_ms["eager"]``).  Eager, a move's device work waits on the
    host; the same move's device time inside a CUDA graph (graph_ms_of, on
    a copy of the run's generator), as the graph boundary runs it, stands
    beside it with its share of a graph boundary
    (``boundary_ms["graph"]``)."""
    from delphy_tpu_torch.mcmc import global_moves as gm
    from delphy_tpu_torch.mcmc.kernel import run_global_moves
    from delphy_tpu_torch.ops import likelihood as lk

    args = (run.ts, run.evo, run.pop, run.gen, run.tin, run.tout,
            run.t_max_tip, run.hyp, run.num_cells)
    ts, evo, pop, grid, *_ = run_global_moves(*args)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        run_global_moves(*args)
    sync(device)
    glob = (time.perf_counter() - t0) * 1e3 / n
    hyp, tin, tout = run.hyp, run.tin, run.tout
    gen = torch.Generator(device)
    gen.set_state(run.gen.get_state())
    if name.startswith("skygrid"):
        what = "the HMC move"

        def move(gen=run.gen):
            gm.skygrid_hmc_move(gen, pop, grid, ts.t, ts.is_tip, hyp)
    elif name == "alpha/nu":
        what = "Ttwiddle_l, M_l and the alpha/nu moves"

        def move(gen=run.gen):
            gm.alpha_and_nu_moves(gen, evo,
                                  lk.calc_Ttwiddle_l(ts, evo, tin, tout),
                                  lk.calc_num_muts_l(ts), hyp)
    else:
        what = "the per-partition statistics and the mu/rho moves"

        def move(gen=run.gen):
            pa = lk.calc_ref_state_prefix_beta(ts, evo)
            gm.mpox_hack_moves(gen, evo, lk.calc_num_muts_beta_ab(ts, evo),
                               lk.calc_num_muts(ts),
                               lk.calc_Ttwiddle_beta_a(ts, evo, tin, tout, pa),
                               hyp)
    move()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        move()
    sync(device)
    ms = (time.perf_counter() - t0) * 1e3 / n
    in_graph = graph_ms_of(lambda: move(gen), gen, device, f"{name}: {what}")
    eager_ms, graph_ms = boundary_ms["eager"], boundary_ms["graph"]
    log(f"{name}: eager, run_global_moves {glob:.3f} ms, of it {what} "
        f"{ms:.3f} ms = {ms / eager_ms:.1%} of an eager boundary's "
        f"{eager_ms:.3f} ms; inside a CUDA graph {what} takes "
        f"{in_graph['busy_ms']:.3f} ms of device time "
        f"({in_graph['device_ops']:.0f} device operations, "
        f"{in_graph['event_ms']:.3f} ms a replay by events) = "
        f"{in_graph['busy_ms'] / graph_ms:.1%} of a graph boundary's "
        f"{graph_ms:.3f} ms ({card})")
    return {"what": what, "global_moves_eager_ms": glob, "eager_ms": ms,
            "eager_share": ms / eager_ms, "in_graph": in_graph,
            "graph_share": in_graph["busy_ms"] / graph_ms,
            "boundary_ms": boundary_ms}


def model_cli(device, card: str) -> None:
    """The CLI with the skygrid and site-rate heterogeneity, and with the
    mpox hack, each --v0-paranoid, on the Ebola file (end of phase 6)."""
    from delphy_tpu_torch import cli
    from delphy_tpu_torch.parallel import _cuda

    lm = 8050
    for flags, path, col in (
            (["--v0-pop-model", "skygrid", "--v0-site-rate-heterogeneity"],
             SKYGRID_PATH, "gammaShape"),
            (["--v0-mpox-hack"], MPOX_PATH, "clockRate")):
        what = " ".join(flags)
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "model.log")
            argv = ["--v0-in-maple", MAPLE, "--v0-seed", str(SEED),
                    "--v0-target-coal-prior-cells", str(NUM_CELLS),
                    "--v0-paranoid", "--v0-steps", str(8 * lm),
                    "--v0-log-every", str(4 * lm),
                    "--v0-tree-every", str(4 * lm),
                    "--v0-delphy-snapshot-every", str(8 * lm),
                    "--v0-out-log-file", out] + flags
            _cuda.reset_launch_counts()
            err = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                code = cli.main(argv)
            sync(device)
            wall = time.perf_counter() - t0
            for line in err.getvalue().splitlines()[-2:]:
                log(f"cli {what}: {line}")
            if code != 0:
                raise AssertionError(f"cli.main {what} returned {code}")
            check_counts(f"on the CLI path {what}", path, graphs=True)
            with open(out) as f:
                rows = [ln.rstrip("\n").split("\t") for ln in f]
        if col not in rows[0] or len(rows) != 3 or not all(
                math.isfinite(float(v)) for r in rows[1:] for v in r):
            raise AssertionError(f"cli {what}: .log {rows}")
        log(f"cli {what}: 8 boundaries in {wall:.3f} s, paranoid checks "
            f"green ({card})")


def model_server(device, card: str) -> None:
    """The server's create_run with pop_model "skygrid", stepped (end of
    phase 7)."""
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.server import Client, serve_in_thread

    srv, engine, _th = serve_in_thread()
    client = Client(*srv.server_address)
    lm = 8050
    _cuda.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        rid = client.wait_job(client.call(
            "create_run", maple=MAPLE, seed=SEED, num_cells=NUM_CELLS,
            pop_model="skygrid")["job_id"], poll_s=0.005)["run_id"]
        t1 = time.perf_counter()
        res = client.wait_job(client.call("run_steps", run_id=rid,
                                          n=6 * lm)["job_id"], poll_s=0.005)
        t2 = time.perf_counter()
        st = client.call("get_state", run_id=rid)
        if res["step"] != 6 * lm or st["pop"]["model"] != "skygrid" \
                or len(st["pop"]["gamma"]) != 50:
            raise AssertionError(f"skygrid create_run: {res} {st['pop']}")
        run = engine._runs[rid].run
        run.check_derived_quantities(1e-6)
        run.tree().check_integrity()
        log(f"server skygrid: create_run {(t1 - t0) * 1e3:.3f} ms, "
            f"run_steps of 6 boundaries and a burst {(t2 - t1) * 1e3:.3f} ms "
            f"({card})")
    finally:
        client.close()
        srv.shutdown()
        srv.server_close()
    check_counts("from the server's skygrid run", SKYGRID_PATH,
                 graphs=True)


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



def sim_tree_path(n_tips: int) -> str:
    """Where ``sim_tree(n_tips, cache=True)`` keeps its pickle."""
    return os.path.join(tempfile.gettempdir(), f"delphy_tpu_torch_tree_"
                        f"{n_tips}_{SCALE_SITES}_{SCALE_SEED}.pkl")


def sim_tree(n_tips: int, cache: bool = False):
    """The reference scale bench's simulated dataset at ``n_tips`` tips
    (29,903 sites, mu 1e-3/365, 1200 sampling days, 2% missing, seed 77)
    and its initial tree; with ``cache`` kept as a pickle in the temporary
    directory, keyed by (tips, sites, seed)."""
    import pickle

    from delphy_tpu_torch.init_tree import build_initial_tree
    from delphy_tpu_torch.sim import simulate_dataset
    path = sim_tree_path(n_tips)
    if cache and os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    t0 = time.perf_counter()
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        n_tips, SCALE_SITES, mu=1e-3 / 365, sample_window_days=1200.0,
        missing_fraction=0.02, seed=SCALE_SEED)
    t1 = time.perf_counter()
    tree = build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(SCALE_SEED))
    log(f"{n_tips} tips x {SCALE_SITES} sites: simulated in {t1 - t0:.1f} "
        f"s, initial tree in {time.perf_counter() - t1:.1f} s, "
        f"{tree.num_mutations()} mutations")
    if cache:
        with open(path, "wb") as f:
            pickle.dump(tree, f)
    return tree


def sweep_shapes(run) -> dict:
    """The sweep kernel's build and memory at a run's shapes, in the run's
    dtype."""
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.parallel import block_cuda as bc
    NC, MC = run.pm.node_map.shape[1], run.pm.mut_map.shape[1]
    K = run.pop.x.numel() if hasattr(run.pop, "x") else 0
    pop = run.pop.type if K else bc.POP_EXP
    stat = bc.ChainStatics(NC=NC, MC=MC, C=run.num_cells,
                           C_real=run.num_cells, cpb=16, pop=pop)
    ws = getattr(_cuda.lib(), "delphy_sweep_chain_workspace_bytes"
                 + _cuda.suffix(run.dtype))
    return {"P": run.pm.node_map.shape[0], "NC": NC, "MC": MC,
            "dtype": str(run.dtype),
            "build": bc.build(stat, K, run.dtype),
            "entry": bc.entry(stat, K, run.dtype),
            "smem_bytes_per_part": bc.smem_bytes(stat, K, run.dtype),
            "workspace_bytes_per_part": ws(NC, MC, run.num_cells, 16, K)}


def one_part_paths(device, card: str, tree) -> dict:
    """Phase 9a: a Run with one device part on ``tree`` (1,000 tips) with
    each population model: its part needs the global build.  Returns the
    global builds' launches and the largest kernel-vs-plain error."""
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.parallel import block_cuda as bc
    from delphy_tpu_torch.run import Run
    out = {"max_abs_err": 0.0}
    for name, kw, path in (
            ("exponential", {}, ("hky_chain", "exp_pop_chain",
                                 "sweep_chain_global")),
            ("skygrid", dict(pop_model="skygrid"),
             ("hky_chain", "sweep_chain_skygrid_global"))):
        run = Run(tree, seed=SEED, num_cells=NUM_CELLS, device_partitions=1,
                  device=device, **kw)
        shapes = sweep_shapes(run)
        if shapes["build"] != 0:
            raise AssertionError(f"one-part {name} run fits shared memory: "
                                 f"{shapes}")
        lm = run.local_moves_per_global_move
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        run.do_mcmc_steps(2 * lm)          # one dispatch and its burst
        sync(device)
        dt = time.perf_counter() - t0
        counts = check_counts(f"on the one-part {name} path", path)
        out[path[-1]] = counts[path[-1]]
        if run.burst_count < 1 or run.topology_proposed <= 0:
            raise AssertionError(f"one-part {name}: no topology burst")
        run.check_derived_quantities(1e-6)
        run.tree().check_integrity()
        log(f"one-part {name} run: {shapes}, 2 boundaries and a burst in "
            f"{dt:.3f} s, {run.local_moves_attempted} moves; "
            f"{run.stats_line()} ({card})")
        # the global build against the plain version on this boundary
        stat, ctx, shared, nb = boundary_chain(run)
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED)
        u = bc.gen_block_uniforms(gen, 1, nb, stat.NC, stat.MC, device)
        got = bc.sweep_chain_kernel(stat, nb, ctx, shared, u)
        want = bc.sweep_chain_torch(stat, nb, ctx, shared, u)
        for n, g, w in zip(GLOBAL_TOL, got, want):
            e = assert_close(f"one-part {name} {n}", g, w, *GLOBAL_TOL[n])
            if n in ("t", "mut_t", "k_p"):
                out["max_abs_err"] = max(out["max_abs_err"], e)
        log(f"one-part {name}: global build = plain at NC={stat.NC} "
            f"MC={stat.MC}, {nb} blocks, {int(got[5].sum())} moves")
        del run
    return out


def boundary_chain(run):
    """(stat, ctx_arrs, shared, n_blocks) of one boundary of ``run``'s sweep,
    at the blocks Run.do_mcmc_steps would give it."""
    from delphy_tpu_torch.mcmc.kernel import run_global_moves
    from delphy_tpu_torch.parallel.sweep import prepare_sweep
    ts, evo, pop, grid, caches, _ledger, _stats = run_global_moves(
        run.ts, run.evo, run.pop, run.gen, run.tin, run.tout, run.t_max_tip,
        run.hyp, run.num_cells)
    stat, ctx, shared, _t_p, _mut = prepare_sweep(
        ts, evo, pop, grid, caches, run.pm, run.gen, run.t_max_tip,
        run.num_cells)
    nb = max(1, min(run._nb_cap(), round(run.local_moves_per_global_move
                                         / run._per_block_rate)))
    return stat, ctx, shared, nb


# t, mut_t and k_p of the global build against the plain version: the
# build's arithmetic is the shared build's, so the ISSUE's 1e-12
GLOBAL_TOL = {"t": (0.0, 1e-12), "mut_t": (0.0, 1e-12), "k_p": (0.0, 1e-12),
              "dG": (1e-10, 1e-12), "dC": (1e-10, 1e-12), "cnt": (0.0, 0.0)}


def global_build_records(device, base, tree, launches, err0) -> list:
    """Phase 9b: the global build of each model against the plain version
    at NC=1152, MC=3200, C=400 (a boundary of 8 parts of ``tree`` padded to
    those widths), timed as phase 3 times the shared builds.  Operations:
    phase 3's count at these widths."""
    from delphy_tpu_torch import pop as popm
    from delphy_tpu_torch.parallel import block_cuda as bc
    from delphy_tpu_torch.run import Run
    records = []
    for name, kw, per_move in (
            ("sweep_chain_global", {}, 150),
            ("sweep_chain_skygrid_global", dict(pop_model="skygrid"), 190),
            ("sweep_chain_skygrid_global (log_linear)",
             dict(pop_model="skygrid", skygrid_type=popm.LOG_LINEAR), 190)):
        run = Run(tree, seed=SEED, num_cells=NUM_CELLS, device_partitions=8,
                  device=device, **kw)
        run.do_mcmc_steps(run.local_moves_per_global_move)
        stat, ctx, shared, nb = boundary_chain(run)
        stat, ctx, shared = bc.pad_chain(stat, ctx, shared, NC=1152, MC=3200)
        K = shared["x"].numel() if "x" in shared else 0
        entry = bc.entry(stat, K)
        if bc.build(stat, K) != 0 or not entry.endswith("_global"):
            raise AssertionError(f"{name}: NC=1152 MC=3200 is not the global "
                                 f"build")
        P = ctx["t"].shape[0]
        u = bc.gen_block_uniforms(run.gen, P, nb, stat.NC, stat.MC, device)
        got = bc.sweep_chain_kernel(stat, nb, ctx, shared, u)
        want = bc.sweep_chain_torch(stat, nb, ctx, shared, u)
        err = err0
        for n, g, w in zip(GLOBAL_TOL, got, want):
            e = assert_close(f"{name} {n}", g, w, *GLOBAL_TOL[n])
            if n in ("t", "mut_t", "k_p"):
                err = max(err, e)
        moves = float(got[5].sum())
        if not moves > 0.0:
            raise AssertionError(f"{name} moved nothing")
        log(f"{name} at P={P} NC={stat.NC} MC={stat.MC} C={stat.C} "
            f"n_blocks={nb}: {int(moves)} moves")
        ops = nb * P * (300 + 30 * stat.NC + 8 * stat.MC) + per_move * moves
        m = measure(name, entry, bc.pack_launch(stat, nb, ctx, shared, u),
                    lambda: bc.sweep_chain_kernel(stat, nb, ctx, shared, u),
                    lambda: bc.sweep_chain_torch(stat, nb, ctx, shared, u),
                    ops, base, [(0.0, 1e-12)] * 3 + [(1e-10, 1e-12)], device)
        if "log_linear" in name:
            records[-1]["log_linear"] = {k: m[k] for k in (
                "ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by")}
            records[-1]["max_abs_err"] = max(records[-1]["max_abs_err"], err)
            continue
        rec = dict(name=name, route="cuda",
                   source="delphy_tpu_torch/csrc/sweep_chain.cu",
                   replaces="delphy_tpu/parallel/block_pallas.py:465",
                   max_abs_err=err, launches=launches[name],
                   shape={"P": P, "NC": stat.NC, "MC": stat.MC, "C": stat.C,
                          "n_blocks": nb})
        rec.update(m)
        records.append(rec)
        del run
    return records


def busy_share(fn, what: str) -> dict:
    """fn() under torch.profiler: wall time, the device's busy share (the
    union of kernel and copy intervals over the wall) and the sweep
    kernel's device time, from the exported trace (as phase 5 reads it)."""
    from torch.profiler import ProfilerActivity, profile

    from delphy_tpu_torch.parallel._cuda import BUILD_DIR
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, "large_tree_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        raise AssertionError(f"the profiler traced no device activity "
                             f"({what})")
    busy = _union_us((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in dev) * 1e-6
    sweep = sum(float(e["dur"]) for e in dev
                if "sweep_chain_kernel" in e["name"]) * 1e-6
    # the host's launches: kernel and graph launches, async copies and sets
    launches = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                   and ("Launch" in e.get("name", "")
                        or "MemcpyAsync" in e.get("name", "")
                        or "MemsetAsync" in e.get("name", "")))
    res = {"wall_s": wall, "device_busy_s": busy, "busy_share": busy / wall,
           "sweep_kernel_s": sweep, "device_events": len(dev),
           "launch_calls": launches}
    log(f"traced {what}: {json.dumps(res)}")
    return res


def syncs_in(fn) -> dict:
    """Host synchronisations of the stream that fn() makes (PyTorch's sync
    debug mode warns at each), counted by the source line that made them.
    The notice that the mode is a prototype, which PyTorch gives once a
    process when the mode is first set, is not a synchronisation."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = {}
    for w in caught:
        if "called a synchronizing CUDA operation" in str(w.message):
            k = f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
            where[k] = where.get(k, 0) + 1
    return where


def kernel_at_shape(run, device, half: bool) -> dict:
    """The sweep kernel at a run's shape: a boundary over the run's parts
    (half: the first half of the rows, as an L-dispatch sweeps), at the
    blocks the driver would give it; kernel-only ms per launch, build,
    shared bytes per part and uniform bytes."""
    from delphy_tpu_torch.mcmc.kernel import run_global_moves
    from delphy_tpu_torch.parallel import block_cuda as bc
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.parallel.sweep import prepare_sweep
    ts, evo, pop, grid, caches, _ledger, _stats = run_global_moves(
        run.ts, run.evo, run.pop, run.gen, run.tin, run.tout, run.t_max_tip,
        run.hyp, run.num_cells, param_moves=False)
    P = run.pm.node_map.shape[0]
    sel = torch.arange(P // 2 if half else P, device=device)
    stat, ctx, shared, t_p, _mut = prepare_sweep(
        ts, evo, pop, grid, caches, run.pm, run.gen, run.t_max_tip,
        run.num_cells, part_sel=sel)
    n_real = len(run._last_cuts) + 1
    rate = run._per_block_rate * (min(P // 2, n_real - 1) / n_real
                                  if half else 1.0)
    nb = max(1, min(run._nb_cap(overlapped=half),
                    round(run.local_moves_per_global_move / max(1.0, rate))))
    u = bc.gen_block_uniforms(run.gen, len(sel), nb, stat.NC, stat.MC,
                              device, run.dtype)
    K = shared["x"].numel() if "x" in shared else 0
    pk = bc.pack_launch(stat, nb, ctx, shared, u)
    entry = bc.entry(stat, K, run.dtype)
    ms = kernel_ms(_cuda.lib(), entry, pk.args, reps=5)
    moves = float(pk.outs[3][:, 2].sum())
    res = {"parts": len(sel), "NC": stat.NC, "MC": stat.MC,
           "n_blocks": nb, "entry": entry,
           "build": bc.build(stat, K, run.dtype),
           "smem_bytes_per_part": bc.smem_bytes(stat, K, run.dtype),
           "uniform_bytes": nbytes(u), "kernel_ms": ms,
           "moves_per_launch": moves}
    return res


def exp_pop_at_shape(run, device, pad_to: int = 0) -> dict:
    """The exp-pop kernel on a boundary of a large run, in the run's dtype,
    whose node rows are read in place where they do not fit in shared
    memory (beyond ~18k nodes in float64, ~27.7k in float32), against the
    plain version (phase 3's tolerances, or the float32 ones), and its
    times.  ``pad_to``: pad the node rows with inert nodes (not inner, so
    they add no term) to that many."""
    from delphy_tpu_torch.mcmc.kernel import run_global_moves
    from delphy_tpu_torch.parallel import _cuda, pop_cuda
    ts, evo, pop, grid, caches, _ledger, _stats = run_global_moves(
        run.ts, run.evo, run.pop, run.gen, run.tin, run.tout, run.t_max_tip,
        run.hyp, run.num_cells, param_moves=False)
    dtype, sfx = run.dtype, _cuda.suffix(run.dtype)
    u = torch.rand((50, pop_cuda.N_LANES), generator=run.gen, dtype=dtype,
                   device=device)
    lbs, k2, t_row, inner = pop_cuda.pack_rows(grid, ts.t, ts.is_tip)
    if pad_to > t_row.numel():
        n_pad = pad_to - t_row.numel()
        t_row = torch.cat([t_row, t_row[:, -1:].expand(1, n_pad)], 1)
        inner = torch.cat([inner, inner.new_zeros(1, n_pad)], 1)
    args = (u, lbs, k2, t_row, inner, grid.t_step, pop.t0, pop.min_pop,
            pop.n0, pop.g, pop_cuda.hyp_floats(run.hyp), 50)
    got = pop_cuda.exp_pop_chain_kernel(*args)
    want = pop_cuda.exp_pop_chain_torch(*args)
    err = max(assert_close(f"exp_pop_chain{sfx} at N={t_row.numel()} {n}",
                           g, w, *CHAIN_TOL[dtype])
              for n, g, w in zip(("n0", "g"), got, want))
    return {"N": t_row.numel(), "C": lbs.numel(), "dtype": str(dtype),
            "nodes_in_shared_memory": getattr(
                _cuda.lib(), "delphy_exp_pop_chain_nodes_shared" + sfx)(
                    lbs.numel(), 50, t_row.numel()),
            "max_abs_err": err,
            "ms": kernel_ms(_cuda.lib(), "delphy_exp_pop_chain" + sfx,
                            pop_cuda.pack_launch(*args).args, reps=10),
            "plain_ms": time_ms(lambda: pop_cuda.exp_pop_chain_torch(*args),
                                device, reps=2)}


def large_tree_path(device, card: str, n_tips: int, gate: str,
                    cycles: int = 3) -> dict:
    """Phases 9c and 9d: a tree of ``n_tips`` simulated tips through the
    blocking driver, then the overlapped one (``gate``: the
    DELPHY_TPU_OVERLAP value its Run gets), with the checks and readings of
    the module docstring."""
    from delphy_tpu_torch import run as run_mod
    from delphy_tpu_torch.io.snapshot import load_run, save_run
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.parallel.sweep import parts_multi_super_step

    tree = sim_tree(n_tips, cache=True)
    out = {"tips": n_tips, "torch_threads": torch.get_num_threads(),
           "cpu_count": os.cpu_count(), "card": card}
    prev = os.environ.get("DELPHY_TPU_OVERLAP")

    def drive(run, n):
        """(moves attempted, wall s) of do_mcmc_steps(n), synced."""
        sync(device)
        base = run.local_moves_attempted
        t0 = time.perf_counter()
        run.do_mcmc_steps(n)
        sync(device)
        dt = time.perf_counter() - t0
        return run.local_moves_attempted - base, dt

    try:
        # -- blocking --
        os.environ["DELPHY_TPU_OVERLAP"] = "0"
        t0 = time.perf_counter()
        run = run_mod.Run(tree, seed=SEED, num_cells=NUM_CELLS, device=device)
        lm = run.local_moves_per_global_move
        # an overlapped cycle's boundaries: a blocking call of as many
        # boundaries runs the same local moves and flushes its burst
        B = max(1, min(run.topology_burst_chunks, run_mod.RESTENCIL_INTERVAL,
                       run_mod.OVERLAP_DISPATCH_MOVES // lm))
        out.update(lm=lm, boundaries_per_cycle=B,
                   run_init_s=time.perf_counter() - t0,
                   shapes=sweep_shapes(run))
        log(f"{n_tips} tips: Run built in {out['run_init_s']:.1f} s, "
            f"{lm} local moves per boundary, {B} boundaries per cycle, "
            f"{out['shapes']}")
        drive(run, B * lm)                               # warm-up
        _cuda.reset_launch_counts()
        moves, dt = drive(run, cycles * B * lm)
        counts = dict(_cuda.launch_counts)
        if run.burst_count < 2 or counts["hky_chain"] != cycles * B:
            raise AssertionError(f"blocking {n_tips}: bursts "
                                 f"{run.burst_count}, counts {counts}")
        run.check_derived_quantities(1e-6)
        run.tree().check_integrity()
        out["blocking"] = {"moves": moves, "s": dt, "moves_per_s": moves / dt,
                           "bursts": run.burst_count,
                           "dispatches": run.dispatch_count,
                           "launch_counts": counts,
                           "parts_swept": dict(_cuda.launch_blocks)}
        log(f"{n_tips} tips, blocking: {moves} moves in {dt:.3f} s = "
            f"{moves / dt:.1f} moves/s ({cycles} x {B} boundaries and "
            f"bursts; {card})")
        out["blocking"]["traced"] = busy_share(
            lambda: run.do_mcmc_steps(B * lm), f"{n_tips} tips, blocking, "
            f"{B} boundaries and a burst")
        out["kernel_full_width"] = kernel_at_shape(run, device, half=False)
        log(f"{n_tips} tips, sweep kernel over all parts: "
            f"{json.dumps(out['kernel_full_width'])}")
        out["exp_pop_chain"] = exp_pop_at_shape(run, device)
        log(f"{n_tips} tips, exp_pop_chain: {json.dumps(out['exp_pop_chain'])}"
            f" ({card})")
        del run

        # -- overlapped --
        os.environ["DELPHY_TPU_OVERLAP"] = gate
        run = run_mod.Run(tree, seed=SEED, num_cells=NUM_CELLS, device=device)
        if not run._overlap_active():
            raise AssertionError(f"overlap off at {n_tips} tips with "
                                 f"DELPHY_TPU_OVERLAP={gate}")
        drive(run, B * lm)                               # warm-up cycle
        cyc_recs, tot_moves, tot_s = [], 0, 0.0
        for _ in range(cycles):
            _cuda.reset_launch_counts()
            caps = len(run._graphs.captures)
            moves, dt = drive(run, B * lm)
            new = run._graphs.captures[caps:]
            cyc = dict(run.last_cycle, wall_s=dt, moves=moves,
                       graph_replays=_cuda.graph_replays,
                       captures=[(c["blocks"], c["ms"], c["pool_bytes"])
                                 for c in new])
            counts, blocks = dict(_cuda.launch_counts), dict(
                _cuda.launch_blocks)
            sweep = [k for k in counts if k.startswith("sweep_chain")
                     and counts[k]]
            if (len(sweep) != 1 or counts[sweep[0]] != cyc["boundaries"]
                    or blocks[sweep[0]] != cyc["boundaries"]
                    * cyc["selection_width"]
                    or counts["hky_chain"] != 1
                    or cyc["graph_replays"] != cyc["boundaries"] + 1):
                raise AssertionError(f"overlapped cycle launched {counts}, "
                                     f"blocks {blocks}, cycle {cyc}")
            cyc.update(sweep_entry=sweep[0], sweep_parts=blocks[sweep[0]])
            cyc_recs.append(cyc)
            tot_moves += moves
            tot_s += dt
            log(f"{n_tips} tips, overlapped cycle: {json.dumps(cyc)}")
        run.check_derived_quantities(1e-6)
        run.tree().check_integrity()
        if run.topology_proposed <= 0:
            raise AssertionError("the overlapped cycles proposed no "
                                 "topology move")
        out["overlapped"] = {"moves": tot_moves, "s": tot_s,
                             "moves_per_s": tot_moves / tot_s,
                             "cycles": cyc_recs}
        log(f"{n_tips} tips, overlapped: {tot_moves} moves in {tot_s:.3f} s "
            f"= {tot_moves / tot_s:.1f} moves/s against blocking "
            f"{out['blocking']['moves_per_s']:.1f} ({card}; torch threads "
            f"{out['torch_threads']}, cpu_count {out['cpu_count']})")

        # an L-dispatch's enqueue makes no host synchronisation
        sel = overlap_selection(run, device)
        sync(device)
        out["syncs_in_L_enqueue"] = syncs_in(lambda: parts_multi_super_step(
            run.ts, run.evo, run.pop, torch.Generator(device=device),
            run.tin, run.tout, run.pm, 4, run.t_max_tip, run.hyp,
            run.num_cells, 2, param_moves=False, part_sel=sel,
            nb_max=run._nb_cap(overlapped=True)))
        sync(device)
        log(f"{n_tips} tips: host synchronisations while enqueuing a "
            f"2-boundary L-dispatch, by source line: "
            f"{out['syncs_in_L_enqueue']}")
        out["kernel_half_width"] = kernel_at_shape(run, device, half=True)
        log(f"{n_tips} tips, sweep kernel over the selected half: "
            f"{json.dumps(out['kernel_half_width'])}")

        # exact: a snapshot resumes bit-equal, and a cycle forced
        # sequential equals the overlapped one
        with tempfile.TemporaryDirectory() as tmp:
            snap = os.path.join(tmp, "large.npz")
            save_run(run, snap)
            twins = [load_run(snap, device=device) for _ in range(2)]
        run.do_mcmc_steps(B * lm)
        twins[0].do_mcmc_steps(B * lm)
        orig = run_mod.parts_multi_super_step

        def sequential(*a, **kw):
            res = orig(*a, **kw)
            torch.cuda.synchronize()
            return res
        run_mod.parts_multi_super_step = sequential
        try:
            twins[1].do_mcmc_steps(B * lm)
        finally:
            run_mod.parts_multi_super_step = orig
        for what, twin in (("snapshot resume", twins[0]),
                           ("forced sequential", twins[1])):
            if twin.log_posterior != run.log_posterior or not (
                    torch.equal(twin.ts.t, run.ts.t)
                    and torch.equal(twin.ts.mut_t, run.ts.mut_t)):
                raise AssertionError(f"{n_tips} tips: {what} is not "
                                     f"bit-equal: {twin.log_posterior!r} != "
                                     f"{run.log_posterior!r}")
        log(f"{n_tips} tips: after a snapshot, resumed and forced-sequential "
            f"cycles bit-equal to the overlapped one: {run.log_posterior!r}")
        del twins
        out["overlapped"]["traced"] = busy_share(
            lambda: run.do_mcmc_steps(B * lm),
            f"{n_tips} tips, one overlapped cycle")
        run.check_derived_quantities(1e-6)
        log(f"{n_tips} tips: {run.stats_line()}")
    finally:
        if prev is None:
            os.environ.pop("DELPHY_TPU_OVERLAP", None)
        else:
            os.environ["DELPHY_TPU_OVERLAP"] = prev
    return out


def large_trees(device, card: str, base, large_tips):
    """Phase 9: large trees.  Returns the global builds' kernel records,
    the exp-pop kernel's readings at the large trees' node counts and the
    10,000-tip record (phase 12 sets its float32 run beside it)."""
    tree = sim_tree(ONE_PART_TIPS, cache=True)    # phase 12 reads it again
    p1 = one_part_paths(device, card, tree)
    records = global_build_records(device, base, tree, p1, p1["max_abs_err"])
    del tree
    res = [large_tree_path(device, card, LARGE_TIPS, gate="1")]
    if large_tips:
        res.append(large_tree_path(device, card, large_tips, gate="auto"))
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "large_trees.json"),
              "w") as f:
        json.dump(res, f, indent=1, default=str)
    return records, {r["tips"]: r["exp_pop_chain"] for r in res}, res[0]


# phase 10: the JAX package's dryrun_multichip size (__graft_entry__.py)
DRYRUN_TIPS = 512
DRYRUN_SITES = 1024


def allreduce_ms(mesh, n: int, reps: int = 20) -> float:
    """ms of one reassembly all-reduce of n f64 on the rank's device: host
    clock around ``reps`` calls ending in a synchronise, every rank in
    step."""
    buf = torch.zeros(n, dtype=torch.float64, device=mesh.device)
    for _ in range(3):
        buf = mesh.all_reduce_sum(buf)
    sync(mesh.device)
    mesh.disagreeing({"barrier": 0.0})
    t0 = time.perf_counter()
    for _ in range(reps):
        buf = mesh.all_reduce_sum(buf)
    sync(mesh.device)
    return (time.perf_counter() - t0) * 1e3 / reps


def ebola_mesh_case(mesh, device, out_dir: str, tag: str) -> dict:
    """Phase 10(a)'s run (and (c)'s), under ``mesh`` or, with None, in
    this process: Run(seed=1, num_cells=400) on the Ebola file, two calls
    of two boundaries each ending in a burst, the ledger at 1e-6 and the
    tree's integrity; t, mut_t and the generator state saved under
    ``out_dir``; the graph replays and captures of its dispatches (none
    where ``dispatch_graph.graph_rule`` sends them to the eager loop)."""
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.run import Run

    run = Run(load_tree(), seed=SEED, num_cells=NUM_CELLS, device=device,
              mesh=mesh)
    lm = run.local_moves_per_global_move
    _cuda.reset_launch_counts()
    for _ in range(2):
        run.do_mcmc_steps(2 * lm)
    sync(run.device)
    counts, blocks = dict(_cuda.launch_counts), dict(_cuda.launch_blocks)
    run.check_derived_quantities(1e-6)
    run.tree().check_integrity()
    for k in EXP_PATH:
        if counts[k] <= 0:
            raise AssertionError(f"{tag}: kernel {k} never launched")
    P = int(run.pm.node_map.shape[0])
    per_launch = blocks["sweep_chain"] / counts["sweep_chain"]
    if per_launch != P / (mesh.size if mesh else 1):
        raise AssertionError(f"{tag}: sweep launches cover {per_launch} "
                             f"parts of {P}")
    torch.save({"t": run.ts.t.cpu(), "mut_t": run.ts.mut_t.cpu(),
                "gen": run.gen.get_state().cpu()},
               os.path.join(out_dir, f"{tag}.pt"))
    return {"log_G": float(run.ledger.log_G),
            "log_posterior": run.log_posterior,
            "topology_proposed": run.topology_proposed,
            "moves": run.local_moves_attempted,
            "dispatches": run.dispatch_count, "bursts": run.burst_count,
            "parts": P, "sweep_parts_per_launch": per_launch,
            "launch_counts": counts, "graph_replays": _cuda.graph_replays,
            "graph_captures": [c["blocks"] for c in run._graphs.captures],
            "N": run.ts.num_nodes, "M": int(run.ts.mut_t.shape[0])}


def dryrun_mesh_case(mesh, part_cap: int) -> dict:
    """Phase 10(b), the counterpart of ``__graft_entry__.dryrun_multichip``:
    512 tips x 1024 sites, a part cap that makes the splitter raise the part
    count above the mesh's size, bursts, repartitions and an overlapped
    mesh cycle; the ledger at 1e-5 and the tree's integrity."""
    from delphy_tpu_torch.phylo import build_random_tree
    from delphy_tpu_torch.run import Run
    from delphy_tpu_torch.sim import simulate_dataset

    os.environ["DELPHY_TPU_PART_CAP"] = str(part_cap)
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        DRYRUN_TIPS, DRYRUN_SITES, mu=2e-3, missing_fraction=0.03, seed=0)
    tree = build_random_tree(ref, deltas, miss, dates, names=names,
                             rng=np.random.default_rng(0))
    run = Run(tree, seed=0, num_cells=64, local_moves_per_global_move=512,
              device_partitions=mesh.size, topology_moves_enabled=True,
              mesh=mesh, device=mesh.device)
    P = int(run.pm.node_map.shape[0])
    if P % mesh.size or P <= mesh.size:
        raise AssertionError(f"dryrun: part axis {P} on {mesh.size} ranks "
                             f"(the splitter did not engage)")
    run.topology_burst_chunks = 2
    reparts = []
    repartition = run._repartition

    def counting(sync_times=False):
        reparts.append(sync_times)
        repartition(sync_times=sync_times)
    run._repartition = counting
    lm = run.local_moves_per_global_move
    for _ in range(3):
        run.do_mcmc_steps(2 * lm)
    if run.burst_count < 2 or not reparts or run.topology_proposed <= 0:
        raise AssertionError(f"dryrun: {run.burst_count} bursts, "
                             f"{len(reparts)} repartitions")
    run.check_derived_quantities(1e-5)
    run.tree().check_integrity()
    os.environ["DELPHY_TPU_OVERLAP"] = "1"
    if not run._overlap_active():
        raise AssertionError("dryrun: the overlapped driver is off")
    run.do_mcmc_steps(2 * lm)
    if run.last_cycle is None:
        raise AssertionError("dryrun: no overlapped mesh cycle ran")
    run.check_derived_quantities(1e-5)
    run.tree().check_integrity()
    return {"P": run.device_partitions, "P_padded": P,
            "n_cap": run._n_cap_sticky, "part_cap": part_cap,
            "bursts": run.burst_count, "repartitions": len(reparts),
            "topology_proposed": run.topology_proposed,
            "moves": run.local_moves_attempted,
            "cycle": run.last_cycle, "log_posterior": run.log_posterior}


def large_mesh_case(mesh, device, cycles: int = 3) -> dict:
    """Phase 10(c): the 10,000-tip tree of phase 9c through the blocking
    driver (its gate is off at this size; a warm-up cycle, then ``cycles``
    timed), under ``mesh`` or, with None, on one card; moves/s, the
    boundaries and graph replays of the timed calls, the ledger at 1e-6
    and integrity."""
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.run import Run

    run = Run(sim_tree(LARGE_TIPS, cache=True), seed=SEED,
              num_cells=NUM_CELLS, device=device, mesh=mesh)
    step = run.topology_burst_chunks * run.local_moves_per_global_move
    run.do_mcmc_steps(step)
    sync(run.device)
    _cuda.reset_launch_counts()
    base = run.local_moves_attempted
    t0 = time.perf_counter()
    run.do_mcmc_steps(cycles * step)
    moves = run.local_moves_attempted - base
    sync(run.device)
    dt = time.perf_counter() - t0
    run.check_derived_quantities(1e-6)
    run.tree().check_integrity()
    return {"moves": moves, "s": dt, "moves_per_s": moves / dt,
            # hky_chain runs once a boundary
            "boundaries": _cuda.launch_counts["hky_chain"],
            "graph_replays": _cuda.graph_replays,
            "bursts": run.burst_count, "parts": int(run.pm.node_map.shape[0]),
            "N": run.ts.num_nodes, "M": int(run.ts.mut_t.shape[0]),
            "log_posterior": run.log_posterior}


def mesh_rank(out_dir: str, device: str, part_cap: int, large: bool) -> int:
    """One rank of phase 10, started by ``distributed.spawn``: (a) or (c)'s
    Ebola run and the all-reduce at its shape, then (b) (``part_cap`` > 0)
    or (c)'s 10k tree (``large``); its record goes to ``out_dir``."""
    from delphy_tpu_torch.parallel import distributed
    distributed.initialize_from_env()
    mesh = distributed.global_part_mesh(device=device)
    from delphy_tpu_torch.parallel.dispatch_graph import graph_rule
    res = {"rank": mesh.rank, "size": mesh.size, "device": str(mesh.device),
           "staged": mesh.staged,
           "backend": str(torch.distributed.get_backend()),
           "graph_rule": graph_rule(mesh.device, None, None, 1, None, mesh)}
    res["ebola"] = e = ebola_mesh_case(mesh, mesh.device, out_dir,
                                       f"ebola_{mesh.size}_r{mesh.rank}")
    n = e["N"] + e["M"] + 3 * e["parts"]
    res["allreduce_ebola"] = {"ms": allreduce_ms(mesh, n), "bytes": 8 * n}
    if part_cap:
        res["dryrun"] = dryrun_mesh_case(mesh, part_cap)
    if large:
        res["large"] = g = large_mesh_case(mesh, mesh.device)
        n = g["N"] + g["M"] + 3 * g["parts"]
        res["allreduce_large"] = {"ms": allreduce_ms(mesh, n),
                                  "bytes": 8 * n}
    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(res, f, default=str)
    distributed.shutdown()
    return 0


def same_run(tag: str, ref: dict, got: dict, out_dir: str, ref_tag: str):
    """Raise unless a rank's Ebola run is the single-process run's."""
    a = torch.load(os.path.join(out_dir, f"{tag}.pt"))
    b = torch.load(os.path.join(out_dir, f"{ref_tag}.pt"))
    keys = ("log_G", "log_posterior", "topology_proposed", "moves",
            "dispatches", "bursts", "parts")
    if not (all(torch.equal(a[k], b[k]) for k in a)
            and all(got[k] == ref[k] for k in keys)):
        raise AssertionError(f"{tag} is not the single-process run: "
                             f"{[(k, got[k], ref[k]) for k in keys]}")


def run_ranks(D: int, device: str, part_cap: int, large: bool,
              out_dir: str) -> list:
    from delphy_tpu_torch.parallel import distributed
    t0 = time.perf_counter()
    distributed.spawn(mesh_rank, D, args=(out_dir, device, part_cap, large))
    log(f"{D} ranks on {device} ended after {time.perf_counter() - t0:.1f} s")
    recs = []
    for r in range(D):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs


def mesh_paths(device, card: str) -> dict:
    """Phase 10: more than one GPU (see the module docstring)."""
    out = {"card": card}
    with tempfile.TemporaryDirectory() as out_dir:
        ref = ebola_mesh_case(None, device, out_dir, "ebola_1")
        if ref["graph_replays"] <= 0:
            raise AssertionError("phase 10: the one-process run made no "
                                 "graph replay")
        log(f"phase 10: one process, through CUDA graphs: "
            f"{json.dumps(ref)}")
        D = 2
        # the cap dryrun_multichip sets on 8 devices: at D=2 it is far
        # below the mean part (~511 nodes), so the splitter always engages
        part_cap = (2 * DRYRUN_TIPS - 1) // 8 * 9 // 8 // 16 * 16 + 16
        ranks = run_ranks(D, f"cuda:{device.index or 0}", part_cap, False,
                          out_dir)
        for r in ranks:
            same_run(f"ebola_{D}_r{r['rank']}", ref, r["ebola"], out_dir,
                     "ebola_1")
            if not r["staged"] or r["graph_rule"] or \
                    r["ebola"]["graph_replays"]:
                raise AssertionError(f"phase 10(a) rank {r['rank']}: "
                                     f"staged {r['staged']}, graph rule "
                                     f"{r['graph_rule']}, replays "
                                     f"{r['ebola']['graph_replays']}")
        out["shared_card"] = ranks
        log(f"phase 10(a): {D} ranks sharing {device} ({ranks[0]['backend']}"
            f", staged {ranks[0]['staged']}) bit-equal to one process: "
            f"log_post {ref['log_posterior']!r}, each sweep launch over "
            f"{ranks[0]['ebola']['sweep_parts_per_launch']} of "
            f"{ref['parts']} parts; all-reduce "
            f"{ranks[0]['allreduce_ebola']} ({card})")
        log(f"phase 10(a): the {D} ranks ran the eager loop (0 graph "
            f"replays), as dispatch_graph.graph_rule says for a staged "
            f"mesh: ranks sharing one card reduce over gloo through the "
            f"host (PartMesh.all_reduce_sum copies the buffer to the host "
            f"and back), which a CUDA graph capture cannot hold")
        log(f"phase 10(b): dryrun on {D} ranks: "
            f"{json.dumps(ranks[0]['dryrun'])}")
        cards = torch.cuda.device_count()
        if cards < 2:
            log(f"phase 10(c) did NOT run: {cards} card visible, it needs "
                f"two or more")
        else:
            D = min(4, cards)
            one = large_mesh_case(None, device)
            ranks = run_ranks(D, "cuda", 0, True, out_dir)
            for r in ranks:
                same_run(f"ebola_{D}_r{r['rank']}", ref, r["ebola"], out_dir,
                         "ebola_1")
                if r["staged"] or not r["graph_rule"] or min(
                        r["ebola"]["graph_replays"],
                        r["large"]["graph_replays"]) <= 0:
                    raise AssertionError(
                        f"phase 10(c) rank {r['rank']}: staged "
                        f"{r['staged']}, graph rule {r['graph_rule']}, "
                        f"replays {r['ebola']['graph_replays']} (Ebola), "
                        f"{r['large']['graph_replays']} (10k)")
            g = ranks[0]
            share = (g["allreduce_large"]["ms"] * g["large"]["boundaries"]
                     / (g["large"]["s"] * 1e3))
            out["cards"] = {"D": D, "one_card": one, "ranks": ranks,
                            "allreduce_share_of_wall": share}
            log(f"phase 10(c): {D} ranks on {D} cards ({g['backend']}), "
                f"every dispatch through CUDA graphs with the all-reduce "
                f"captured ({g['ebola']['graph_replays']} replays on "
                f"Ebola, {g['large']['graph_replays']} at 10k tips), "
                f"bit-equal to the one-process graph run on Ebola; 10k "
                f"tips blocking: one card {one['moves_per_s']:.1f} moves/s "
                f"({one['graph_replays']} replays), {D} cards "
                f"{g['large']['moves_per_s']:.1f} moves/s; all-reduce "
                f"{g['allreduce_large']['ms']:.4f} ms per boundary, "
                f"{g['allreduce_large']['bytes']} bytes, "
                f"{g['large']['boundaries']} boundaries in "
                f"{g['large']['s']:.3f} s: {100 * share:.2f}% of the wall "
                f"(Ebola: {g['allreduce_ebola']['ms']:.4f} ms, "
                f"{g['allreduce_ebola']['bytes']} bytes; {card})")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "mesh.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    return out


# phase 11: __graft_entry__.entry's tiny problem
ENTRY_TIPS, ENTRY_SITES, ENTRY_CELLS, ENTRY_MOVES = 8, 64, 64, 32
UNPART_BOUNDARIES = 10


def step_ledger(ts_in, ts, evo, pop, t_max_tip, num_cells, hyp):
    """From-scratch ledger of a super_step's output: the grid it swept on
    (bounds from the input state's root, popsize_bar from the output's
    population), the output's times and parameters."""
    from delphy_tpu_torch.mcmc import global_moves as gm
    from delphy_tpu_torch.mcmc.kernel import boundary_grid_bounds
    from delphy_tpu_torch.mcmc.moves import Ledger
    from delphy_tpu_torch.ops import coalescent as coal
    from delphy_tpu_torch.ops import likelihood as lk
    t_lo, t_step = boundary_grid_bounds(ts_in, t_max_tip, num_cells)
    grid = coal.make_grid(pop, ts.t, ts.is_tip, t_lo, t_step, num_cells)
    caches = gm.compute_caches(ts, evo)
    return Ledger(lk.calc_log_G(ts, evo, caches.lambda_i, caches.root_freq),
                  coal.calc_log_prior(grid, pop, ts.t, ts.is_tip),
                  gm.calc_log_other_priors(evo, pop, hyp))


def check_step_ledger(what, ledger, want, tol=1e-6) -> float:
    err = max(abs(float(getattr(ledger, f)) - float(getattr(want, f)))
              for f in ledger._fields)
    if not (math.isfinite(float(ledger.log_posterior)) and err < tol):
        raise AssertionError(f"{what}: ledger {ledger} != recompute {want}")
    return err


def same_tuple(what, got, want) -> None:
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(a, torch.Tensor) and not torch.equal(a, b):
            raise AssertionError(f"{what}: {f} differs")


def to_cpu(nt):
    return nt._replace(**{f: v.cpu() for f, v in nt._asdict().items()
                          if isinstance(v, torch.Tensor)})


def unpartitioned_path(device, card: str) -> dict:
    """Phase 11: the unpartitioned step (``mcmc/kernel.py`` super_step,
    multi_super_step, run_local_sweep; ``mcmc/moves.py``) on the card."""
    from delphy_tpu_torch.mcmc import kernel as mk
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.parallel import dispatch_graph as dg
    from delphy_tpu_torch.phylo import build_random_tree
    from delphy_tpu_torch.run import Run
    from delphy_tpu_torch.sim import simulate_dataset

    # (a) __graft_entry__.entry: one super_step of 32 local moves
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        ENTRY_TIPS, ENTRY_SITES, mu=2e-3, seed=0)
    tree = build_random_tree(ref, deltas, miss, dates, names=names,
                             rng=np.random.default_rng(0))
    run = Run(tree, seed=0, num_cells=ENTRY_CELLS,
              local_moves_per_global_move=64, device=device)
    ts, evo, pop, ledger, stats = mk.super_step(
        run.ts, run.evo, run.pop, run.gen, run.tin, run.tout, ENTRY_MOVES,
        run.t_max_tip, run.hyp, run.num_cells)
    err = check_step_ledger("phase 11(a)", ledger, step_ledger(
        run.ts, ts, evo, pop, run.t_max_tip, run.num_cells, run.hyp))
    out = {"entry": {"log_posterior": float(ledger.log_posterior),
                     "ledger_err": err, "local_moves_attempted": int(
                         stats["local_moves_attempted"])}}
    log(f"phase 11(a): entry's step: {json.dumps(out['entry'])}")

    # (b) the Ebola main path's Run at full width, 10 boundaries, through
    # graphs and through the eager loop in turns
    run = Run(load_tree(), seed=SEED, num_cells=NUM_CELLS, device=device)
    lm, K = run.local_moves_per_global_move, UNPART_BOUNDARIES
    args = (run.tin, run.tout, lm, run.t_max_tip, run.hyp, run.num_cells)
    inputs = (run.ts, run.evo, run.pop)
    # this thread's boundary graphs from here on: (b)'s alone
    dg.clear()
    cache = dg.thread_cache(dg.DispatchGraphs)
    gen_state = run.gen.get_state()
    # warm-up: the graph's capture (keyed on run.gen) and an eager boundary
    mk.super_step(*inputs, run.gen, *args)
    mk.super_step(*inputs, run.gen, *args, _eager=True)
    sync(device)
    warm_captures = list(cache.captures)

    def turn(eager: bool, n: int = K):
        run.gen.set_state(gen_state)
        sync(device)
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        res = mk.multi_super_step(*inputs, run.gen, *args, n, _eager=eager)
        enq = time.perf_counter() - t0
        sync(device)
        wall = time.perf_counter() - t0
        return res, run.gen.get_state(), {
            "path": "eager" if eager else "graph",
            "ms_per_boundary": wall * 1e3 / n,
            "enqueue_ms_per_boundary": enq * 1e3 / n,
            "local_moves_attempted": int(res[4]["local_moves_attempted"]),
            "moves_per_s": int(res[4]["local_moves_attempted"]) / wall,
            "launch_counts": dict(_cuda.launch_counts),
            "graph_replays": _cuda.graph_replays}

    turns = [turn(eager) for eager in (False, True, True, False)]
    (ts, evo, pop, ledger, stats), gen_end, _ = turns[0]
    for res, end, rec in turns:
        counts = rec["launch_counts"]
        want = {k: (K if k in ("hky_chain", "exp_pop_chain") else 0)
                for k in counts}
        if counts != want:
            raise AssertionError(f"phase 11(b) {rec['path']}: launch counts "
                                 f"{counts}, expected {want}")
        if rec["graph_replays"] != (K if rec["path"] == "graph" else 0):
            raise AssertionError(f"phase 11(b) {rec['path']}: "
                                 f"{rec['graph_replays']} graph replays")
        for name, a, b in (("ts", res[0], ts), ("evo", res[1], evo),
                           ("pop", res[2], pop), ("ledger", res[3], ledger)):
            same_tuple(f"phase 11(b) {rec['path']} {name}", a, b)
        if not (torch.equal(res[4]["local_moves_attempted"],
                            stats["local_moves_attempted"])
                and torch.equal(end, gen_end)):
            raise AssertionError(f"phase 11(b) {rec['path']}: move count or "
                                 f"generator state differs")
    attempted = int(stats["local_moves_attempted"])
    # the same boundaries as K super_step calls (through the graph) from
    # the same generator state
    run.gen.set_state(gen_state)
    state, total = inputs, 0
    for _ in range(K):
        ts_last = state[0]
        *state, led1, st1 = mk.super_step(*state, run.gen, *args)
        total += int(st1["local_moves_attempted"])
    for name, a, b in (("ts", ts, state[0]), ("evo", evo, state[1]),
                       ("pop", pop, state[2]), ("ledger", ledger, led1)):
        same_tuple(f"phase 11(b) {name}", a, b)
    if total != attempted:
        raise AssertionError(f"phase 11(b): {attempted} moves attempted, "
                             f"{total} over single steps")
    err = check_step_ledger("phase 11(b)", ledger, step_ledger(
        ts_last, ts, evo, pop, run.t_max_tip, run.num_cells, run.hyp))
    # host syncs inside a graph dispatch, and each path's busy share over
    # 2 boundaries
    graph_syncs = syncs_in(lambda: mk.multi_super_step(
        *inputs, run.gen, *args, 1))
    sync(device)
    if graph_syncs:
        raise AssertionError(f"phase 11(b): host syncs inside a graph "
                             f"dispatch: {graph_syncs}")
    busy = {path: busy_share(lambda: mk.multi_super_step(
        *inputs, run.gen, *args, 2, _eager=path == "eager"),
        f"11(b) {path}, 2 boundaries") for path in ("graph", "eager")}
    run.ts, run.evo, run.pop, run.ledger = ts, evo, pop, ledger
    run._fused_bundle = None
    run.check_derived_quantities(1e-6)
    run.tree().check_integrity()
    # host syncs in one sweep's enqueue
    ts_b, evo_b, pop_b, grid, caches, ledger_b, _ = mk.run_global_moves(
        ts, evo, pop, run.gen, run.tin, run.tout, run.t_max_tip, run.hyp,
        run.num_cells)
    sync(device)
    syncs = syncs_in(lambda: mk.run_local_sweep(
        ts_b, caches, grid, ledger_b, evo_b, pop_b, run.gen, lm,
        run.t_max_tip))
    sync(device)
    n_blocks, k_max = mk.sweep_shape(lm, run.num_cells)
    by_path = {p: [rec for _, _, rec in turns if rec["path"] == p]
               for p in ("graph", "eager")}
    out["ebola"] = {
        "boundaries": K, "local_moves_per_boundary": lm,
        "n_blocks": n_blocks, "k_max": k_max,
        "turns": [rec for _, _, rec in turns],
        "ms_per_boundary": {p: [r["ms_per_boundary"] for r in v]
                            for p, v in by_path.items()},
        "enqueue_ms_per_boundary": {
            p: [r["enqueue_ms_per_boundary"] for r in v]
            for p, v in by_path.items()},
        "busy": busy, "captures_in_warm_up": warm_captures,
        "captures": cache.captures, "replays": cache.replays,
        "local_moves_attempted": attempted,
        "launch_counts": turns[0][2]["launch_counts"],
        "ledger_err": err, "log_posterior": float(ledger.log_posterior),
        "syncs_in_graph_dispatch": graph_syncs,
        "syncs_in_sweep_enqueue": syncs}
    log(f"phase 11(b): {K} boundaries of {lm} local moves ({n_blocks} "
        f"blocks, k_max {k_max}), graph / eager in turns: ms per boundary "
        f"{json.dumps(out['ebola']['ms_per_boundary'])}, enqueue "
        f"{json.dumps(out['ebola']['enqueue_ms_per_boundary'])}, busy share "
        f"graph {busy['graph']['busy_share']:.3f} / eager "
        f"{busy['eager']['busy_share']:.3f}; graph = eager bit for bit "
        f"(state, ledger, {attempted} moves, generator) and = {K} super_step "
        f"calls; ledger err {err:.3e}; launch counts "
        f"{ {k: v for k, v in turns[0][2]['launch_counts'].items() if v} } "
        f"on each path, {K} replays on the graph path only; captures "
        f"{json.dumps(cache.captures)}; host syncs in a graph dispatch: "
        f"none; in a sweep's eager enqueue: {syncs or 'none'} ({card})")

    # (c) one sweep's draws made on the card, the cores on both devices
    draws = mk.draw_sweep(run.gen, ts_b, n_blocks, k_max)
    outs = [mk.local_sweep_core(*[to_cpu(x) if cpu else x for x in (
        ts_b, caches, grid, ledger_b, evo_b, pop_b, draws)], run.t_max_tip)
        for cpu in (False, True)]
    err = 0.0
    for name, g, c in (("t", outs[0][0].t, outs[1][0].t),
                       ("mut_t", outs[0][0].mut_t, outs[1][0].mut_t),
                       ("k_bar", outs[0][1].k_bar, outs[1][1].k_bar)) + tuple(
            (f, getattr(outs[0][2], f), getattr(outs[1][2], f))
            for f in ("log_G", "log_coal")):
        err = max(err, assert_close(f"phase 11(c) {name}", g.cpu(), c,
                                    rtol=1e-10, atol=1e-10))
    if int(outs[0][3]) != int(outs[1][3]):
        raise AssertionError("phase 11(c): attempted counts differ")
    if torch.equal(outs[1][0].t, ts_b.t.cpu()):
        raise AssertionError("phase 11(c): the sweep moved nothing")
    out["cpu_vs_card"] = {"max_abs_err": err, "n_blocks": n_blocks}
    log(f"phase 11(c): one sweep's draws on the card, the cores on the CPU "
        f"and the card agree: max abs err {err:.3e} (t, mut_t, k_bar, "
        f"ledger; tolerance 1e-10)")
    dg.clear()          # the boundary graphs' pools back to the allocator
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "unpartitioned.json"),
              "w") as f:
        json.dump(dict(out, card=card), f, indent=1, default=str)
    return out



# ---------------------------------------------------------------------------
# Phase 12: the f32 engine
# ---------------------------------------------------------------------------

F32 = torch.float32
F32_EXP_PATH = tuple(k + "_f32" for k in EXP_PATH)
# the f32 study's configuration: scripts/f32_study.py's defaults, the
# length VALIDATION.md uses
STUDY_CFG = {"tips": 40, "sites": 1200, "steps": 200_000, "seed": 3}


@contextlib.contextmanager
def f32_switch():
    """DELPHY_TPU_F32=1 inside the block, as bench.py sets it."""
    prev = os.environ.get(F32_ENV)
    os.environ[F32_ENV] = "1"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(F32_ENV, None)
        else:
            os.environ[F32_ENV] = prev


def f32_tol(log_G) -> float:
    """The float32 ledger tolerance: bench.py's 0.05 at Ebola's |log_G|
    (~4.5e4), scaled by |log_G| / 4.5e4, at least 1e-3 (tests/test_f32.py)."""
    return max(0.05 * abs(float(log_G)) / 4.5e4, 1e-3)


def padded_sweep(device, tree, kw, dtype, NC, MC):
    """(stat, ctx, shared, u, nb) of one boundary of an 8-part Run of
    ``tree`` (model ``kw``) in ``dtype``, its rows padded to NC x MC."""
    from delphy_tpu_torch.parallel import block_cuda as bc
    from delphy_tpu_torch.run import Run
    run = Run(tree, seed=SEED, num_cells=NUM_CELLS, device_partitions=8,
              device=device, dtype=dtype, **kw)
    run.do_mcmc_steps(run.local_moves_per_global_move)
    stat, ctx, shared, nb = boundary_chain(run)
    stat, ctx, shared = bc.pad_chain(stat, ctx, shared, NC=NC, MC=MC)
    u = bc.gen_block_uniforms(run.gen, ctx["t"].shape[0], nb, stat.NC,
                              stat.MC, device, dtype)
    return stat, ctx, shared, u, nb


def sweep_record(name, device, stat, ctx, shared, u, nb, per_move) -> dict:
    """The sweep kernel (the build ``stat`` selects in ``u``'s dtype)
    against the plain chain and timed, as phase 3 does."""
    from delphy_tpu_torch.parallel import block_cuda as bc
    dtype = u.pri.dtype
    K = shared["x"].numel() if "x" in shared else 0
    got = bc.sweep_chain_kernel(stat, nb, ctx, shared, u)
    want = bc.sweep_chain_torch(stat, nb, ctx, shared, u)
    err = check_sweep(name, got, want, dtype)
    moves = float(got[5].sum())
    if not moves > 0.0:
        raise AssertionError(f"{name} moved nothing")
    P = ctx["t"].shape[0]
    ops = nb * P * (300 + 30 * stat.NC + 8 * stat.MC) + per_move * moves
    rec = dict(max_abs_err=err, entry=bc.entry(stat, K, dtype),
               build=bc.build(stat, K, dtype),
               smem_bytes_per_part=bc.smem_bytes(stat, K, dtype),
               shape={"P": P, "NC": stat.NC, "MC": stat.MC, "C": stat.C,
                      "n_blocks": nb})
    rec.update(measure(name, rec["entry"],
                       bc.pack_launch(stat, nb, ctx, shared, u),
                       lambda: bc.sweep_chain_kernel(stat, nb, ctx, shared,
                                                     u),
                       lambda: bc.sweep_chain_torch(stat, nb, ctx, shared,
                                                    u),
                       ops, None, None, device))
    log(f"{name}: {rec['entry']} (build {rec['build']}, "
        f"{rec['smem_bytes_per_part']} shared bytes a part) at {rec['shape']}"
        f", {int(moves)} moves, max |err| {err:.3e}")
    return rec


def f32_kernels(device, card, f64_records) -> list:
    """Phase 12(a): each kernel's float32 build against its float32 plain
    version on the card (see the module docstring)."""
    from delphy_tpu_torch import pop as popm
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.parallel import block_cuda as bc
    from delphy_tpu_torch.run import Run

    run = Run(load_tree(), seed=SEED, num_cells=NUM_CELLS, device=device,
              dtype=F32)
    run.do_mcmc_steps(run.local_moves_per_global_move)
    records, _ = compare_kernels(run, device, None, None, F32)
    del run
    f64_ms = {r["name"]: r["ms"] for r in f64_records}
    by_name = {r["name"]: r for r in records}

    # the build selection at phase 9b's shape: the global build in float64,
    # a shared one in float32; then a shape that needs the global build in
    # float32 too, for each model
    tree = sim_tree(ONE_PART_TIPS, cache=True)
    stat, ctx, shared, u, nb = padded_sweep(device, tree, {}, F32, 1152,
                                            3200)
    builds = {str(dt): bc.build(stat, 0, dt)
              for dt in (torch.float64, F32)}
    if builds != {"torch.float64": 0, "torch.float32": 2}:
        raise AssertionError(f"NC=1152 MC=3200 builds: {builds}")
    rec = sweep_record("sweep_chain_f32 at NC=1152 MC=3200", device, stat,
                       ctx, shared, u, nb, 150)
    rec["builds"] = builds
    by_name["sweep_chain_f32"]["at_phase_9b_shape"] = rec
    by_name["sweep_chain_f32"]["max_abs_err"] = max(
        by_name["sweep_chain_f32"]["max_abs_err"], rec["max_abs_err"])
    for name, kw, per_move in (
            ("sweep_chain_global_f32", {}, 150),
            ("sweep_chain_skygrid_global_f32", dict(pop_model="skygrid"),
             190),
            ("sweep_chain_skygrid_global_f32 (log_linear)",
             dict(pop_model="skygrid", skygrid_type=popm.LOG_LINEAR), 190)):
        stat, ctx, shared, u, nb = padded_sweep(device, tree, kw, F32, 2304,
                                                6400)
        m = sweep_record(name, device, stat, ctx, shared, u, nb, per_move)
        if m["build"] != 0 or m["entry"] != "delphy_" + name.split()[0]:
            raise AssertionError(f"{name}: {m['entry']}, build {m['build']}")
        # the float64 global build's kernel ms at the same shape
        st64, c64, sh64, u64, nb64 = padded_sweep(device, tree, kw,
                                                  torch.float64, 2304, 6400)
        m["f64_ms_same_shape"] = kernel_ms(
            _cuda.lib(), bc.entry(st64, 0 if "x" not in sh64
                                  else sh64["x"].numel(), torch.float64),
            bc.pack_launch(st64, nb64, c64, sh64, u64).args, reps=10)
        del st64, c64, sh64, u64
        if "log_linear" in name:
            records[-1]["log_linear"] = {k: m[k] for k in (
                "ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by",
                "f64_ms_same_shape")}
            records[-1]["max_abs_err"] = max(records[-1]["max_abs_err"],
                                             m["max_abs_err"])
            continue
        records.append(dict(name=name, route="cuda",
                            source="delphy_tpu_torch/csrc/sweep_chain.cu",
                            replaces="delphy_tpu/parallel/block_pallas.py:465",
                            **m))

    # the float32 global builds on a path: one-part Runs of the 1,000 tips
    global_launches = {}
    for name, kw, path in (
            ("exponential", {}, F32_EXP_PATH[:2] + ("sweep_chain_global_f32",)),
            ("skygrid", dict(pop_model="skygrid"),
             ("hky_chain_f32", "sweep_chain_skygrid_global_f32"))):
        run = Run(tree, seed=SEED, num_cells=NUM_CELLS, device_partitions=1,
                  device=device, dtype=F32, **kw)
        shapes = sweep_shapes(run)
        if shapes["build"] != 0:
            raise AssertionError(f"one-part {name} f32 run fits shared "
                                 f"memory: {shapes}")
        _cuda.reset_launch_counts()
        run.do_mcmc_steps(2 * run.local_moves_per_global_move)
        sync(device)
        counts = check_counts(f"on the one-part {name} f32 path", path)
        run.check_derived_quantities(f32_tol(run.ledger.log_G))
        run.tree().check_integrity()
        global_launches[path[-1]] = counts[path[-1]]
        stat, ctx, shared, nb = boundary_chain(run)
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED)
        u = bc.gen_block_uniforms(gen, 1, nb, stat.NC, stat.MC, device, F32)
        got = bc.sweep_chain_kernel(stat, nb, ctx, shared, u)
        want = bc.sweep_chain_torch(stat, nb, ctx, shared, u)
        check_sweep(f"one-part {name} f32", got, want, F32)
        log(f"one-part {name} f32 run: {shapes}, {counts[path[-1]]} "
            f"launches of {path[-1]}; {run.stats_line()} ({card})")
        del run
    for r in records:
        if r["name"] in global_launches:
            r["launches"] = global_launches[r["name"]]
    del tree
    for r in records:
        base = r["name"].split()[0][:-len("_f32")]
        r["f64_ms"] = f64_ms.get(base)
        if r["f64_ms"]:
            log(f"{r['name']}: f32 {r['ms']:.4f} ms, f64 {r['f64_ms']:.4f} "
                f"ms (this call): f32/f64 {r['ms'] / r['f64_ms']:.3f} "
                f"({card})")
    return records


def bench_recipe(device, card) -> dict:
    """Phase 12(b) and (e): bench.py's recipe on the port in float32,
    beside the same recipe in float64 (calls in turns f64, f32, f32,
    f64), then the float32 run saved and resumed bit-equal."""
    from delphy_tpu_torch.io.snapshot import load_run, save_run
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.run import Run

    tree = load_tree()
    with f32_switch():
        run32 = Run(tree, seed=SEED, num_cells=NUM_CELLS, device=device)
    if run32.dtype != F32:
        raise AssertionError(f"{F32_ENV}=1 made a {run32.dtype} run")
    run64 = Run(tree, seed=SEED, num_cells=NUM_CELLS, device=device,
                dtype=torch.float64)
    n = run32.local_moves_per_global_move * run32.topology_burst_chunks
    for run in (run64, run32):      # bench.py's warm-up
        run.do_mcmc_steps(10)
        run.do_mcmc_steps(n)
    tot = {"f64": [0, 0.0], "f32": [0, 0.0]}
    launches = dict.fromkeys(F32_EXP_PATH, 0)
    for tag in ("f64", "f32", "f32", "f64"):
        run = run32 if tag == "f32" else run64
        _cuda.reset_launch_counts()
        sync(device)
        base = run.local_moves_attempted
        t0 = time.perf_counter()
        run.do_mcmc_steps(n)
        sync(device)
        dt = time.perf_counter() - t0
        counts = check_counts(f"on bench.py's recipe in {tag}",
                              F32_EXP_PATH if tag == "f32" else EXP_PATH,
                              graphs=True)
        if tag == "f32":
            for k in launches:
                launches[k] += counts[k]
        moves = run.local_moves_attempted - base
        tot[tag][0] += moves
        tot[tag][1] += dt
        log(f"bench recipe, {tag} call: {moves} moves in {dt:.3f} s = "
            f"{moves / dt:.1f} moves/s ({card})")
    run32.check_derived_quantities(0.05)
    run64.check_derived_quantities(1e-6)
    for run in (run32, run64):
        t = run.tree()
        t.check_integrity()
        if not (np.all(np.isfinite(t.t)) and math.isfinite(run.log_posterior)):
            raise AssertionError("non-finite state after bench.py's recipe")
    drift32 = abs(float(run32.ledger.log_G)
                  - float(run32.calc_cur_ledger().log_G))
    out = {"moves_per_s": {k: v[0] / v[1] for k, v in tot.items()},
           "end": {"f32": {"step": run32.step,
                           "log_post": run32.log_posterior,
                           "log_G_drift": drift32},
                   "f64": {"step": run64.step,
                           "log_post": run64.log_posterior}},
           "launches": launches}
    log(f"bench.py's recipe: f32 {out['moves_per_s']['f32']:.1f} moves/s, "
        f"f64 {out['moves_per_s']['f64']:.1f} moves/s (same call, in turns); "
        f"f32 end: step {run32.step}, log_post {run32.log_posterior:.4f}, "
        f"log_G drift {drift32:.3e} (bound 0.05); {run32.stats_line()} "
        f"({card})")
    # (e) the float32 run saved and resumed: bit-equal through a burst
    with tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "f32.npz")
        save_run(run32, snap)
        twin = load_run(snap, device=device)
    if twin.dtype != F32:
        raise AssertionError(f"the f32 snapshot resumed as {twin.dtype}")
    bursts = run32.burst_count
    for run in (run32, twin):
        run.do_mcmc_steps(n)
    if not (twin.log_posterior == run32.log_posterior
            and torch.equal(twin.ts.t, run32.ts.t)
            and torch.equal(twin.ts.mut_t, run32.ts.mut_t)
            and run32.burst_count > bursts):
        raise AssertionError(f"the f32 snapshot did not resume bit-equal: "
                             f"{twin.log_posterior!r} != "
                             f"{run32.log_posterior!r}")
    out["snapshot_resume"] = {"bit_equal": True,
                              "log_post": run32.log_posterior}
    log(f"f32 snapshot resumed bit-equal through a burst: log_post "
        f"{run32.log_posterior!r}")
    return out


def large_f32(device, card, tips10k: dict) -> dict:
    """Phase 12(c): phase 9c's 10,000-tip tree through the blocking driver
    in float32, beside phase 9c's float64 figures."""
    from delphy_tpu_torch import run as run_mod
    from delphy_tpu_torch.parallel import _cuda

    tree = sim_tree(LARGE_TIPS, cache=True)
    prev = os.environ.get("DELPHY_TPU_OVERLAP")
    os.environ["DELPHY_TPU_OVERLAP"] = "0"
    try:
        run = run_mod.Run(tree, seed=SEED, num_cells=NUM_CELLS,
                          device=device, dtype=F32)
        lm = run.local_moves_per_global_move
        B = tips10k["boundaries_per_cycle"]
        cycles = 3
        run.do_mcmc_steps(B * lm)                      # warm-up
        _cuda.reset_launch_counts()
        sync(device)
        base = run.local_moves_attempted
        t0 = time.perf_counter()
        run.do_mcmc_steps(cycles * B * lm)
        sync(device)
        dt = time.perf_counter() - t0
        counts = check_counts("on the 10,000-tip f32 path", F32_EXP_PATH)
        if counts["hky_chain_f32"] != cycles * B:
            raise AssertionError(f"10k f32: counts {counts}")
        run.check_derived_quantities(f32_tol(run.ledger.log_G))
        run.tree().check_integrity()
        moves = run.local_moves_attempted - base
        out = {"moves": moves, "s": dt, "moves_per_s": moves / dt,
               "f64_moves_per_s": tips10k["blocking"]["moves_per_s"],
               "shapes": {"f32": sweep_shapes(run),
                          "f64": tips10k["shapes"]},
               "kernel_full_width": {
                   "f32": kernel_at_shape(run, device, half=False),
                   "f64": tips10k["kernel_full_width"]},
               "exp_pop_chain": {
                   "f32": exp_pop_at_shape(run, device),
                   "f32_padded": exp_pop_at_shape(run, device,
                                                  pad_to=40_000),
                   "f64": tips10k["exp_pop_chain"]},
               "launch_counts": counts}
        k32, k64 = (out["kernel_full_width"][k] for k in ("f32", "f64"))
        log(f"10,000 tips, blocking, f32: {moves} moves in {dt:.3f} s = "
            f"{moves / dt:.1f} moves/s against f64 "
            f"{out['f64_moves_per_s']:.1f} (phase 9c, this call); sweep "
            f"{k32['entry']} build {k32['build']}, {k32['smem_bytes_per_part']}"
            f" shared bytes a part, uniforms {k32['uniform_bytes'] / 1e6:.1f}"
            f" MB a boundary, {k32['kernel_ms']:.3f} ms a launch (f64: "
            f"{k64['entry']} build {k64['build']}, "
            f"{k64['smem_bytes_per_part']} B, "
            f"{k64['uniform_bytes'] / 1e6:.1f} MB, {k64['kernel_ms']:.3f} ms)"
            f"; {run.stats_line()} ({card})")
        log(f"10,000 tips, exp_pop_chain f32: "
            f"{json.dumps(out['exp_pop_chain']['f32'])}; padded to 40,000 "
            f"nodes: {json.dumps(out['exp_pop_chain']['f32_padded'])}")
        if out["exp_pop_chain"]["f32_padded"]["nodes_in_shared_memory"]:
            raise AssertionError("exp_pop at N=40,000 kept its node rows in "
                                 "shared memory in f32")
        del run
    finally:
        if prev is None:
            os.environ.pop("DELPHY_TPU_OVERLAP", None)
        else:
            os.environ["DELPHY_TPU_OVERLAP"] = prev
    return out


def f32_study(device, card) -> dict:
    """Phase 12(d): scripts/torch_f32_study.py on the card at 200,000
    steps.  Its drifts are checked (float64 rounding, float32 under the
    scaled bound); the distances in standard errors are reported."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_f32_study
    res = torch_f32_study.study(STUDY_CFG, device)
    if not (res["f64_drift"] < 1e-8 and res["f32_drift"] < res["drift_bound"]):
        raise AssertionError(f"f32 study drifts: f64 {res['f64_drift']}, "
                             f"f32 {res['f32_drift']} (bound "
                             f"{res['drift_bound']})")
    sig = {k: v["sigma"] for k, v in res["f32_vs_f64"]["summaries"].items()}
    null = {k: v["sigma"]
            for k, v in res["null_f64_vs_f64"]["summaries"].items()}
    log(f"f32 study {STUDY_CFG}: f32 vs f64 sigma {json.dumps(sig)}, null "
        f"f64 vs f64 {json.dumps(null)}, bound {res['sigma_bound']:.2f}: "
        f"{'agree' if res['ok'] else 'DISAGREE'}; drifts f32 "
        f"{res['f32_drift']:.3e} (bound {res['drift_bound']:.3e}), f64 "
        f"{res['f64_drift']:.3e}; seconds {json.dumps(res['seconds'])} "
        f"({card})")
    return res


def f32_engine(device, card, f64_records, tips10k) -> list:
    """Phase 12: the f32 engine.  Returns the float32 kernels' records;
    writes the whole phase to chiprun_out/f32_engine.json."""
    log("phase 12: the f32 engine")
    records = f32_kernels(device, card, f64_records)
    bench = bench_recipe(device, card)
    for r in records:
        if r["name"] in bench["launches"]:
            r["launches"] = bench["launches"][r["name"]]
        elif r["name"] == "sweep_chain_skygrid_f32":
            # the skygrid Runs' boundaries of (a) are its path
            r["launches"] = r["launches_one_boundary"]
    large = large_f32(device, card, tips10k)
    by_name = {r["name"]: r for r in records}
    by_name["exp_pop_chain_f32"]["at_large_trees"] = {
        k: large["exp_pop_chain"][k] for k in ("f32", "f32_padded")}
    by_name["exp_pop_chain_f32"]["max_abs_err"] = max(
        [by_name["exp_pop_chain_f32"]["max_abs_err"]]
        + [large["exp_pop_chain"][k]["max_abs_err"]
           for k in ("f32", "f32_padded")])
    study = f32_study(device, card)
    missing = [r["name"] for r in records if not r.get("launches")]
    if missing:
        raise AssertionError(f"float32 kernels never launched on a path: "
                             f"{missing}")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "f32_engine.json"),
              "w") as f:
        json.dump({"card": card, "kernels": records, "bench_recipe": bench,
                   "tips_10k": large, "study": study}, f, indent=1,
                  default=str)
    return records


# ---------------------------------------------------------------------------
# Phase 13: the Python topology mixer fallback and the device SPR
# ---------------------------------------------------------------------------

SCALE_MU = 1e-3 / 365
# (b): scripts/topo_dev_bench.py's simulated part without its missing data
# (54 tips, 700 sampling days, seed 3, greedy tree), and 300 tips, the
# ~600-node end of the production part sizes that script names
SPR_TIPS = (54, 300)
SPR_SEED = 3
SPR_MOVES = 64
SPR_LANES = 8
SPR_LANE_MOVES = 16     # moves a lane of the 8-lane sweeps
# the forced reruns: lanes, moves a lane and history attempts a slot (32 by
# default), so that moves run out of attempts
SPR_FORCED_LANES = 2
SPR_FORCED_MOVES = 4
SPR_FORCED_ATTEMPTS = 4
# (a2): phase 9a's tree, P=4 parts, 2,000 moves
FALLBACK_PARTS = 4
FALLBACK_MOVES = 2000
CHILD_TIMEOUT = 900


def timed_bursts(run) -> list:
    """Record each topology burst of ``run`` (seconds with the device
    synchronised first, topology moves proposed)."""
    rec = []
    burst = run._topology_burst

    def timed(n_moves):
        sync(run.device)
        p0 = run.topology_proposed
        t0 = time.perf_counter()
        burst(n_moves)
        rec.append({"s": time.perf_counter() - t0,
                    "moves": run.topology_proposed - p0})
    run._topology_burst = timed
    return rec


def card_log_G(tree, device, dtype=torch.float64) -> float:
    """log_G of a host tree recomputed on the card (the port's likelihood,
    exp model at SCALE_MU, kappa 2)."""
    from delphy_tpu_torch.evo import make_evo_params
    from delphy_tpu_torch.mcmc.global_moves import compute_caches
    from delphy_tpu_torch.ops.likelihood import calc_log_G
    from delphy_tpu_torch.state import pack_state
    evo = make_evo_params(tree.num_sites, mu=SCALE_MU, kappa=2.0,
                          device=device, dtype=dtype)
    ts = pack_state(tree, device=device, dtype=dtype)
    c = compute_caches(ts, evo)
    return float(calc_log_G(ts, evo, c.lambda_i, c.root_freq))


def _worker_state(_):
    """In a pool worker: its pid and whether it initialised CUDA."""
    time.sleep(0.2)
    return os.getpid(), torch.cuda.is_initialized()


def pool_workers_cuda(pool) -> dict:
    """{pid: torch.cuda.is_initialized()} of every worker of ``pool``."""
    want = {p.pid for p in pool._pool}
    seen = {}
    for _ in range(10):
        for pid, ini in pool.map(_worker_state, range(4 * len(want)),
                                 chunksize=1):
            seen[pid] = ini
        if want <= set(seen):
            return {pid: seen[pid] for pid in want}
    raise AssertionError(f"phase 13(a): reached {sorted(seen)} of the pool's "
                         f"workers {sorted(want)}")


def mixer_child(trees_path: str, out_path: str,
                device=torch.device("cuda", 0)) -> int:
    """Phase 13(a) and (a2), in a process started with DELPHY_TPU_NATIVE=0
    on the parent's trees: the main path's Run for a dispatch and the
    Python burst that follows, then run_partitioned_bursts through the
    spawn pool; no pool worker may initialise CUDA."""
    import pickle

    from delphy_tpu_torch.native import native_available
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.run import Run
    from delphy_tpu_torch.topo import parallel as tpar
    from delphy_tpu_torch.topo.mixer import HostExpPop
    if native_available():
        raise AssertionError("phase 13(a): the native topology kernel is on "
                             "with DELPHY_TPU_NATIVE=0")
    with open(trees_path, "rb") as f:
        trees = pickle.load(f)
    out = {}

    run = Run(trees["ebola"], seed=SEED, num_cells=NUM_CELLS, device=device)
    bursts = timed_bursts(run)
    _cuda.reset_launch_counts()
    run.do_mcmc_steps(2 * run.local_moves_per_global_move)
    sync(device)
    counts = check_counts("on the Python-mixer path")
    if run.burst_count < 1 or not bursts or run.topology_proposed <= 0:
        raise AssertionError("phase 13(a): no Python topology burst ran")
    run.check_derived_quantities(1e-6)
    run.tree().check_integrity()
    b = bursts[0]
    out["a"] = {"topology_parts": run._topology_num_parts(),
                "device_partitions": run.device_partitions,
                "dispatches": run.dispatch_count, "bursts": run.burst_count,
                "proposed": run.topology_proposed,
                "accepted": run.topology_accepted, "burst_s": b["s"],
                "burst_moves": b["moves"],
                "ms_per_topology_move": b["s"] * 1e3 / b["moves"],
                "launch_counts": counts, "log_post": run.log_posterior}
    log(f"phase 13(a): {json.dumps(out['a'])}")

    tree = trees["sim1000"]
    from delphy_tpu_torch.evo import make_evo_params
    evo = make_evo_params(tree.num_sites, mu=SCALE_MU, kappa=2.0,
                          device="cpu")
    mu, nu, q, pi, part, q_tab = (float(evo.mu), evo.nu.numpy(),
                                  evo.q.numpy(), evo.pi.numpy(),
                                  evo.part.numpy(), evo.q_tab.numpy())
    t_max_tip = float(np.max(tree.t_max[:tree.num_tips]))
    start = card_log_G(tree, device)
    t0 = time.perf_counter()
    dlg, acc, prop = tpar.run_partitioned_bursts(
        tree, FALLBACK_MOVES, FALLBACK_PARTS,
        HostExpPop(t_max_tip, 1000.0, 0.002, 1.0), mu, nu, q, pi,
        np.random.default_rng(SEED), num_cells=NUM_CELLS, parallel=True,
        part=part, q_tab=q_tab)
    dt = time.perf_counter() - t0
    tree.check_integrity()
    end = card_log_G(tree, device)
    if tpar._POOL is None:
        raise AssertionError("phase 13(a2): the burst did not use the pool")
    if abs(end - (start + dlg)) > 1e-6:
        raise AssertionError(f"phase 13(a2): log_G {end!r} != start "
                             f"{start!r} + delta {dlg!r}")
    out["a2"] = {"tips": tree.num_tips, "parts": FALLBACK_PARTS,
                 "moves": FALLBACK_MOVES, "proposed": prop, "accepted": acc,
                 "s": dt, "ms_per_move": dt * 1e3 / max(prop, 1),
                 "log_G_start": start, "delta_log_G": dlg,
                 "log_G_end": end, "err": abs(end - (start + dlg))}
    log(f"phase 13(a2): {json.dumps(out['a2'])}")
    workers = pool_workers_cuda(tpar._POOL)
    out["workers_cuda_initialized"] = {str(k): v for k, v in workers.items()}
    if any(workers.values()):
        raise AssertionError(f"phase 13(a): a pool worker initialised CUDA: "
                             f"{workers}")
    log(f"phase 13(a): {len(workers)} pool workers, none initialised CUDA")
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1, default=str)
    return 0


def spr_tree(n_tips: int):
    """(b)'s tree: the simulated part, missation-free, greedy, rereferenced
    to its root sequence."""
    from delphy_tpu_torch.phylo import (build_greedy_tree,
                                        rereference_to_root_sequence)
    from delphy_tpu_torch.sim import simulate_dataset
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        n_tips, SCALE_SITES, mu=SCALE_MU, sample_window_days=700.0,
        missing_fraction=0.0, seed=SPR_SEED)
    tree = build_greedy_tree(ref, deltas, miss, dates, names=names,
                             rng=np.random.default_rng(SPR_SEED))
    rereference_to_root_sequence(tree)
    return tree


def spr_args(tree, device, dtype):
    """The move arguments (ref_seq, L, mu, nu, qtab, qatab, part,
    lambda_ref, t_max_tip) at SCALE_MU, kappa 2, on ``device``."""
    from delphy_tpu_torch.evo import make_evo_params
    evo = make_evo_params(tree.num_sites, mu=SCALE_MU, kappa=2.0,
                          device="cpu")
    q3 = evo.q_tab.numpy().reshape(-1, 4, 4)
    qa = np.stack([-np.diag(q) for q in q3])
    nu, part = evo.nu.numpy(), evo.part.numpy()
    lam_ref = float(np.sum(SCALE_MU * nu * qa[part, tree.ref_seq]))

    def F(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(device, dtype)

    def I(a):
        return torch.as_tensor(np.asarray(a, np.int64)).to(device)
    return (I(tree.ref_seq), tree.num_sites, F([SCALE_MU]), F(nu),
            F(q3.reshape(-1)), F(qa.reshape(-1)), I(part), F([lam_ref]),
            float(np.max(tree.t_max[:tree.num_tips])))


def to_device(x, device):
    """Tensors of nested tuples, lists and dicts moved to ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, list):
        return [to_device(v, device) for v in x]
    if isinstance(x, tuple):
        return type(x)(*[to_device(v, device) for v in x]) \
            if hasattr(x, "_fields") else tuple(to_device(v, device)
                                                for v in x)
    return x


def same_spr_result(what, got, want) -> float:
    """Card result == CPU result: tree ints equal, times and delta_log_G
    within 1e-12; returns the largest float difference."""
    from delphy_tpu_torch.ops import spr_move as sm
    err = 0.0
    for k in sm.TREE_KEYS:
        g, w = got.p[k].cpu(), want.p[k]
        if g.is_floating_point():
            err = max(err, assert_close(f"{what} {k}", g.masked_fill(
                torch.isinf(g), 0), w.masked_fill(torch.isinf(w), 0),
                1e-12, 1e-12))
            if not torch.equal(torch.isinf(g), torch.isinf(w)):
                raise AssertionError(f"{what} {k}: padding differs")
        elif not torch.equal(g, w):
            raise AssertionError(f"{what} {k}: card and CPU trees differ")
    for k in ("n_accepted", "n_eligible"):
        if int(getattr(got, k)) != int(getattr(want, k)):
            raise AssertionError(f"{what}: {k} differs")
    return max(err, assert_close(f"{what} delta_log_G",
                                 got.delta_log_G.cpu(), want.delta_log_G,
                                 1e-12, 1e-12))


def spr_ledger(what, tree, res, device, rtol=1e-9, dtype=torch.float64,
               start_tree=None) -> float:
    """log_G of the final tree recomputed on the card == start + the summed
    accepted delta_log_G, to ``rtol`` of |log_G| (or the float32 ledger
    scale); the tree's integrity.  Returns the difference."""
    from delphy_tpu_torch.ops import spr_move as sm
    out = sm.unpack_tree(res.p, tree)
    out.check_integrity()
    start = card_log_G(start_tree or tree, device)
    end = card_log_G(out, device)
    err = abs(end - (start + float(res.delta_log_G)))
    tol = f32_tol(start) if dtype == F32 else rtol * abs(start)
    if err > tol:
        raise AssertionError(f"{what}: log_G {end!r} != start {start!r} + "
                             f"{float(res.delta_log_G)!r} (tol {tol})")
    if int(res.n_accepted) < 1:
        raise AssertionError(f"{what}: no move accepted")
    return err


def same_sweeps(what, got, want) -> None:
    """Two sweeps' lane results bit for bit: every packed array, the
    counts, delta_log_G and the exhaustion flag."""
    for i, (a, b) in enumerate(zip(got, want)):
        for k in a.p:
            if not torch.equal(a.p[k], b.p[k]):
                raise AssertionError(f"{what} lane {i}: {k} differs")
        for f in ("n_accepted", "delta_log_G", "n_eligible", "exhausted"):
            if not torch.equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"{what} lane {i}: {f} differs")
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} lanes against "
                             f"{len(want)}")


def sweep_turns(what, gen, graphs, card_fn, on_card) -> tuple:
    """``card_fn(record, eager)`` through graphs, then through the eager
    loop from the same generator state: both bit-equal, the generator
    left alike.  Returns (lane results, record, {graph ms, eager ms, host
    syncs of each, reruns, eager moves and replays of the graph path})."""
    state = gen.get_state()
    before = (graphs.reruns, graphs.eager_moves, graphs.replays)
    rec = []
    res, dt_g, sync_g = on_card(lambda: card_fn(rec, False))
    end = gen.get_state()
    gen.set_state(state)
    res_e, dt_e, sync_e = on_card(lambda: card_fn(None, True))
    res = res if isinstance(res, list) else [res]
    same_sweeps(f"{what} graph against eager", res,
                res_e if isinstance(res_e, list) else [res_e])
    if not torch.equal(gen.get_state(), end):
        raise AssertionError(f"{what}: the paths left the generator apart")
    return res, rec, {
        "graph_s": dt_g, "eager_s": dt_e, "host_syncs_graph": sync_g,
        "host_syncs_eager": sync_e,
        "reruns": graphs.reruns - before[0],
        "eager_moves_on_graph_path": graphs.eager_moves - before[1],
        "replays": graphs.replays - before[2]}


def forced_record(what, res, ab, moves) -> dict:
    """The record of a sweep with exhaustion forced: the graph path reran
    lanes and ran widened moves eagerly, and no lane is left exhausted."""
    if not (ab["reruns"] and ab["eager_moves_on_graph_path"]):
        raise AssertionError(f"{what} forced: no rerun on the graph path "
                             f"({ab})")
    if any(bool(r.exhausted) for r in res):
        raise AssertionError(f"{what} forced: a lane is left exhausted")
    return {"lanes": len(res), "moves": moves,
            "attempts": SPR_FORCED_ATTEMPTS,
            "accepted": sum(int(r.n_accepted) for r in res),
            "graph_ms_per_move": ab["graph_s"] * 1e3 / moves,
            "eager_ms_per_move": ab["eager_s"] * 1e3 / moves,
            "graph_equals_eager": True,
            "host_syncs_graph": ab["host_syncs_graph"],
            "host_syncs_eager": ab["host_syncs_eager"],
            "reruns": ab["reruns"],
            "eager_moves_on_graph_path": ab["eager_moves_on_graph_path"],
            "replays": ab["replays"]}


def spr_sweeps(tree, device, card: str) -> dict:
    """Phase 13(b) at one shape: SPR1 sweeps on one lane and on 8 lanes,
    a slide sweep, each on the card through graphs and through the eager
    loop in turns (bit-equal) and replayed on the CPU from the same draws;
    then the single lane in float32."""
    from delphy_tpu_torch.ops import history as hh
    from delphy_tpu_torch.ops import spr_move as sm
    from delphy_tpu_torch.parallel import dispatch_graph as dg
    cpu = torch.device("cpu")
    p = sm.pack_tree(tree, device=device)
    p_cpu = sm.pack_tree(tree, device=cpu)
    args = spr_args(tree, device, torch.float64)
    args_cpu = spr_args(tree, cpu, torch.float64)
    out = {"tips": tree.num_tips, "nodes": tree.num_nodes,
           "sites": tree.num_sites, "W": int(p["msite"].shape[1]),
           "regions": int(p["msite"].numel() + tree.num_nodes + 1),
           "mutations": tree.num_mutations()}
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    dg.clear()          # this thread's move graphs from here on: this tree's
    graphs = dg.thread_cache(sm.MoveGraphs)
    # warm-up: the graphs captured (one a move, which the lanes share), and
    # the eager path's first run
    sm.spr1_sweep_lanes(gen, [p] * SPR_LANES, args[0], args[1], 1,
                        *args[2:])
    sm.slide_sweep(gen, p, args[0], args[1], 1, *args[2:])
    sm.spr1_sweep(gen, p, args[0], args[1], 4, *args[2:], _eager=True)
    sync(device)
    out["captures_in_warm_up"] = list(graphs.captures)

    sources = {}

    def on_card(fn):
        box = []
        t0 = time.perf_counter()
        where = syncs_in(lambda: box.append(fn()))
        sync(device)
        for k, v in where.items():
            sources[k] = sources.get(k, 0) + v
        return box[0], time.perf_counter() - t0, sum(where.values())

    def on_cpu(fn):
        t0 = time.perf_counter()
        r = fn()
        return r, time.perf_counter() - t0

    cases = (
        ("spr1", 1, SPR_MOVES, lambda rec, eager: sm.spr1_sweep(
            gen, p, args[0], args[1], SPR_MOVES, *args[2:], record=rec,
            _eager=eager),
         lambda d: sm.spr1_sweep_core(p_cpu, *args_cpu, d)),
        ("spr1_lanes", SPR_LANES, SPR_LANE_MOVES,
         lambda rec, eager: sm.spr1_sweep_lanes(
             gen, [p] * SPR_LANES, args[0], args[1], SPR_LANE_MOVES,
             *args[2:], record=rec, _eager=eager),
         lambda d: sm.spr1_sweep_core(p_cpu, *args_cpu, d)),
        ("slide", 1, SPR_MOVES, lambda rec, eager: sm.slide_sweep(
            gen, p, args[0], args[1], SPR_MOVES, *args[2:], record=rec,
            _eager=eager),
         lambda d: sm.slide_sweep_core(p_cpu, *args_cpu, d)))
    err = 0.0
    for name, lanes, n, card_fn, cpu_fn in cases:
        res, rec, ab = sweep_turns(f"phase 13(b) {name}", gen, graphs,
                                   card_fn, on_card)
        got_cpu, dt_cpu = [], 0.0
        for lane, draws in zip(res, rec):
            r, t = on_cpu(lambda: cpu_fn(to_device(draws, cpu)))
            got_cpu.append(r)
            dt_cpu += t
            err = max(err, same_spr_result(f"phase 13(b) {name}", lane, r))
            spr_ledger(f"phase 13(b) {name}", tree, lane, device)
        moves = n * lanes
        out[name] = {
            "lanes": lanes, "moves": moves,
            "accepted": sum(int(r.n_accepted) for r in res),
            "eligible": sum(int(r.n_eligible) for r in res),
            "graph_ms_per_move": ab["graph_s"] * 1e3 / moves,
            "eager_ms_per_move": ab["eager_s"] * 1e3 / moves,
            "cpu_ms_per_move": dt_cpu * 1e3 / moves,
            "graph_equals_eager": True,
            "host_syncs_graph": ab["host_syncs_graph"],
            "host_syncs_eager": ab["host_syncs_eager"],
            "reruns": ab["reruns"],
            "eager_moves_on_graph_path": ab["eager_moves_on_graph_path"],
            "replays": ab["replays"]}
        log(f"phase 13(b) {tree.num_tips} tips {name}: "
            f"{json.dumps(out[name])} ({card})")
    out["max_card_cpu_err"] = err

    # (forced) SPR_FORCED_ATTEMPTS history attempts a slot: moves run out
    # of attempts, and the graph path reruns lanes from their first trees,
    # the widened moves run eagerly on the graph's buffers between replays
    attempts, hh.ATTEMPTS = hh.ATTEMPTS, SPR_FORCED_ATTEMPTS
    try:
        res, _, ab = sweep_turns(
            "phase 13(b) spr1_lanes forced", gen, graphs,
            lambda rec, eager: sm.spr1_sweep_lanes(
                gen, [p] * SPR_FORCED_LANES, args[0], args[1],
                SPR_FORCED_MOVES, *args[2:], record=rec, _eager=eager),
            on_card)
    finally:
        hh.ATTEMPTS = attempts
    for lane in res:
        spr_ledger("phase 13(b) spr1_lanes forced", tree, lane, device)
    out["spr1_lanes_forced"] = forced_record(
        "phase 13(b)", res, ab, SPR_FORCED_LANES * SPR_FORCED_MOVES)
    log(f"phase 13(b) {tree.num_tips} tips spr1_lanes forced: "
        f"{json.dumps(out['spr1_lanes_forced'])} ({card})")
    out["host_sync_sources"] = dict(sources)

    p32 = sm.pack_tree(tree, device=device, dtype=F32)
    args32 = spr_args(tree, device, F32)
    sm.spr1_sweep(gen, p32, args32[0], args32[1], 4, *args32[2:])
    res, dt, n_sync = on_card(lambda: sm.spr1_sweep(
        gen, p32, args32[0], args32[1], SPR_MOVES, *args32[2:]))
    start = sm.unpack_tree(p32, tree)
    e32 = spr_ledger("phase 13(b) spr1 float32", tree, res, device,
                     dtype=F32, start_tree=start)
    out["spr1_f32"] = {"moves": SPR_MOVES,
                       "accepted": int(res.n_accepted),
                       "eligible": int(res.n_eligible),
                       "graph_ms_per_move": dt * 1e3 / SPR_MOVES,
                       "host_syncs_per_move": n_sync / SPR_MOVES,
                       "ledger_err": e32,
                       "ledger_tol": f32_tol(card_log_G(start, device))}
    log(f"phase 13(b) {tree.num_tips} tips spr1 float32: "
        f"{json.dumps(out['spr1_f32'])} ({card})")
    out["captures"] = graphs.captures
    out["graphs_held"] = len(graphs.graphs)
    log(f"phase 13(b) {tree.num_tips} tips: captures (move, ms, pool bytes) "
        f"{json.dumps(graphs.captures)}")
    dg.clear()
    return out


def fallback_and_device_spr(device, card: str, native_burst: dict) -> dict:
    """Phase 13: (a)-(a2) in a child process with DELPHY_TPU_NATIVE=0 on
    this process's trees, (b) the device SPR here.  Writes
    chiprun_out/device_spr.json."""
    import pickle
    log("phase 13: the Python topology mixer fallback and the device SPR")
    out = {"card": card, "native_burst_phase4": native_burst}
    with tempfile.TemporaryDirectory() as tmp:
        trees = os.path.join(tmp, "trees.pkl")
        res = os.path.join(tmp, "child.json")
        with open(trees, "wb") as f:
            pickle.dump({"ebola": load_tree(),
                         "sim1000": sim_tree(ONE_PART_TIPS, cache=True)}, f)
        env = {k: v for k, v in os.environ.items() if k != F32_ENV}
        env["DELPHY_TPU_NATIVE"] = "0"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--mixer-child",
             trees, res], env=env, capture_output=True, text=True,
            timeout=CHILD_TIMEOUT)
        for line in proc.stdout.splitlines():
            print(f"  [child] {line}", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-6000:], file=sys.stderr, flush=True)
            raise AssertionError(f"phase 13(a): the DELPHY_TPU_NATIVE=0 child "
                                 f"exited {proc.returncode}")
        with open(res) as f:
            out.update(json.load(f))
    a = out["a"]
    log(f"phase 13(a): Python burst {a['burst_s']:.3f} s for "
        f"{a['burst_moves']} moves ({a['ms_per_topology_move']:.4f} ms a "
        f"move) against phase 4's native burst "
        f"{native_burst['ms_per_topology_move']:.4f} ms a move "
        f"({native_burst['moves']} moves in {native_burst['s']:.3f} s), "
        f"child {time.perf_counter() - t0:.1f} s ({card})")
    out["b"] = {}
    for n in SPR_TIPS:
        t0 = time.perf_counter()
        tree = spr_tree(n)
        log(f"phase 13(b): {n} tips x {SCALE_SITES} sites, greedy tree, "
            f"{tree.num_mutations()} mutations in "
            f"{time.perf_counter() - t0:.1f} s")
        out["b"][str(n)] = spr_sweeps(tree, device, card)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "device_spr.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    return out


# ---------------------------------------------------------------------------
# Phase 14: the missation-aware device SPR
# ---------------------------------------------------------------------------

# scripts/topo_dev_bench.py's part (scripts/torch_topo_dev_bench.py): 54
# tips x 29,903 sites, 2% missing, greedy tree, seed 3
SPR_MISS_TIPS = 54
SPR_MISS_MOVES = 64
SPR_MISS_LANE_MOVES = 16


def same_miss_result(what, got, want) -> float:
    """Card result == CPU result of the missation-aware move: every packed
    array (fs lanes too: the same program on both) equal, times and
    delta_log_G within 1e-12; returns the largest float difference."""
    from delphy_tpu_torch.ops import spr_miss as sm
    err = 0.0
    for k in sm.MISS_KEYS:
        g, w = got.p[k].cpu(), want.p[k]
        if g.is_floating_point():
            err = max(err, assert_close(f"{what} {k}", g.masked_fill(
                torch.isinf(g), 0), w.masked_fill(torch.isinf(w), 0),
                1e-12, 1e-12))
            if not torch.equal(torch.isinf(g), torch.isinf(w)):
                raise AssertionError(f"{what} {k}: padding differs")
        elif not torch.equal(g, w):
            raise AssertionError(f"{what} {k}: card and CPU trees differ")
    for k in ("n_accepted", "n_eligible"):
        if int(getattr(got, k)) != int(getattr(want, k)):
            raise AssertionError(f"{what}: {k} differs")
    return max(err, assert_close(f"{what} delta_log_G",
                                 got.delta_log_G.cpu(), want.delta_log_G,
                                 1e-12, 1e-12))


def miss_ledger(what, tree, p, dlg, device, dtype=torch.float64,
                start_tree=None) -> float:
    """log_G of the final packed tree recomputed on the card == start +
    the summed accepted delta_log_G (1e-9 of |log_G|, or the float32 ledger
    scale); the tree's integrity.  Returns the difference."""
    from delphy_tpu_torch.ops import spr_miss as sm
    out = sm.unpack_tree_miss(p, tree)
    out.check_integrity()
    start = card_log_G(start_tree or tree, device)
    end = card_log_G(out, device)
    err = abs(end - (start + float(dlg)))
    tol = f32_tol(start) if dtype == F32 else 1e-9 * abs(start)
    if err > tol:
        raise AssertionError(f"{what}: log_G {end!r} != start {start!r} + "
                             f"{float(dlg)!r} (tol {tol})")
    return err


def replay_on_cpu(sm, p, L, c, t_max_tip, draws, WRB):
    """The recorded moves replayed move by move on the CPU: the sweep's
    result, its time, and the moves whose analyses walked more than one
    branch info."""
    n_acc = n_el = 0
    dlg = torch.zeros(1, dtype=p["t"].dtype)
    multi = 0
    t0 = time.perf_counter()
    for d in draws:
        p, acc, g, el, diag = sm.spr1_miss_core(p, L, c, t_max_tip, d, WRB)
        if bool(diag["exhausted"]):
            raise AssertionError("phase 14: a replayed move lacked attempts")
        n_acc += int(acc)
        n_el += int(el)
        dlg = dlg + g
        multi += bool(el) and max(int(diag["n_bi_old"]),
                                  int(diag["n_bi_new"])) > 1
    dt = time.perf_counter() - t0
    one = torch.ones(1, dtype=torch.int64)
    return (sm.SweepResult(p, one * n_acc, dlg, one * n_el,
                           torch.zeros(1, dtype=torch.bool)), dt, multi)


def spr_miss_phase(device, card: str) -> dict:
    """Phase 14: ops/spr_miss.py at scripts/topo_dev_bench.py's part: 64
    spr1_sweep_miss moves on one lane and SPR_LANES lanes of
    SPR_MISS_LANE_MOVES on the card; the single lane replayed on the CPU
    from the card's draws; log_G recomputed from each final tree; one
    float32 sweep.  Writes chiprun_out/device_spr_miss.json."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_topo_dev_bench as tdb

    from delphy_tpu_torch.ops import history as hh
    from delphy_tpu_torch.ops import spr_miss as sm
    from delphy_tpu_torch.ops.spr_move import MoveGraphs
    from delphy_tpu_torch.parallel import dispatch_graph as dg
    log("phase 14: the missation-aware device SPR")
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    tree = tdb.bench_tree(SPR_MISS_TIPS, SCALE_SITES)
    L = tree.num_sites
    p, c, t_max_tip, WRB, WH_ = tdb.move_args(tree, device, torch.float64)
    p_cpu, c_cpu, _, _, _ = tdb.move_args(tree, cpu, torch.float64)
    out = {"card": card, "tips": tree.num_tips, "nodes": tree.num_nodes,
           "sites": L, "W": int(p["msite"].shape[1]),
           "WR": int(p["rs"].shape[1]), "WF": int(p["fsite"].shape[1]),
           "WRB": WRB, "WH": WH_, "mutations": tree.num_mutations(),
           "missing_runs": sum(len(iv) for iv in tree.miss_intervals),
           "setup_s": time.perf_counter() - t0}
    log(f"phase 14: {json.dumps(out)}")
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    dg.clear()          # this thread's move graphs from here on: phase 14's
    graphs = dg.thread_cache(MoveGraphs)
    # warm-up: the graph captured (one a move, which the lanes share), and
    # the eager path's first run
    sm.spr1_sweep_miss_lanes(gen, [p] * SPR_LANES, L, 1, c, t_max_tip, WRB,
                             WH_)
    sm.spr1_sweep_miss(gen, p, L, 2, c, t_max_tip, WRB, WH_, _eager=True)
    sync(device)
    out["captures_in_warm_up"] = list(graphs.captures)
    log(f"phase 14: captures (move, ms, pool bytes) "
        f"{json.dumps(graphs.captures)}")
    sources = {}

    def on_card(fn):
        box = []
        t0 = time.perf_counter()
        where = syncs_in(lambda: box.append(fn()))
        sync(device)
        for k, v in where.items():
            sources[k] = sources.get(k, 0) + v
        return box[0], time.perf_counter() - t0, sum(where.values())

    def ab_record(ab, moves) -> dict:
        return {"graph_ms_per_move": ab["graph_s"] * 1e3 / moves,
                "eager_ms_per_move": ab["eager_s"] * 1e3 / moves,
                "graph_equals_eager": True,
                "host_syncs_graph": ab["host_syncs_graph"],
                "host_syncs_eager": ab["host_syncs_eager"],
                "reruns": ab["reruns"],
                "eager_moves_on_graph_path": ab["eager_moves_on_graph_path"],
                "replays": ab["replays"]}

    # (a) one lane, 64 moves through graphs and eager in turns, replayed on
    # the CPU from the card's draws
    res, rec, ab = sweep_turns(
        "phase 14(a)", gen, graphs, lambda rec, eager: sm.spr1_sweep_miss(
            gen, p, L, SPR_MISS_MOVES, c, t_max_tip, WRB, WH_, record=rec,
            _eager=eager), on_card)
    res = res[0]
    got_cpu, dt_cpu, multi = replay_on_cpu(
        sm, p_cpu, L, c_cpu, t_max_tip, to_device(rec[0], cpu), WRB)
    err = same_miss_result("phase 14(a)", res, got_cpu)
    led = miss_ledger("phase 14(a)", tree, res.p, res.delta_log_G, device)
    if int(res.n_accepted) < 1 or multi < 1:
        raise AssertionError(f"phase 14(a): {int(res.n_accepted)} accepted, "
                             f"{multi} multi-branch-info moves")
    out["a"] = dict({"moves": SPR_MISS_MOVES,
                     "accepted": int(res.n_accepted),
                     "performable": int(res.n_eligible),
                     "multi_branch_info": multi,
                     "cpu_ms_per_move": dt_cpu * 1e3 / SPR_MISS_MOVES,
                     "max_card_cpu_err": err, "ledger_err": led,
                     "draw_bytes_per_lane": sm.draw_bytes(rec[0]),
                     "draw_bytes_per_move": sm.draw_bytes(rec[0][0])},
                    **ab_record(ab, SPR_MISS_MOVES))
    log(f"phase 14(a) one lane: {json.dumps(out['a'])} ({card})")
    del rec

    # (b) SPR_LANES lanes interleaved through graphs and eager in turns,
    # each lane's ledger
    res_l, _, ab = sweep_turns(
        "phase 14(b)", gen, graphs,
        lambda rec, eager: sm.spr1_sweep_miss_lanes(
            gen, [p] * SPR_LANES, L, SPR_MISS_LANE_MOVES, c, t_max_tip, WRB,
            WH_, _eager=eager), on_card)
    led = max(miss_ledger(f"phase 14(b) lane {i}", tree, r.p,
                          r.delta_log_G, device)
              for i, r in enumerate(res_l))
    moves = SPR_LANES * SPR_MISS_LANE_MOVES
    out["b"] = dict({"lanes": SPR_LANES, "moves": moves,
                     "accepted": sum(int(r.n_accepted) for r in res_l),
                     "performable": sum(int(r.n_eligible) for r in res_l),
                     "ledger_err": led}, **ab_record(ab, moves))
    log(f"phase 14(b) {SPR_LANES} lanes: {json.dumps(out['b'])} ({card})")

    # (b2) SPR_FORCED_ATTEMPTS history attempts a slot: moves run out of
    # attempts, and the graph path reruns lanes as in phase 13(b)'s forced
    # case
    attempts, hh.ATTEMPTS = hh.ATTEMPTS, SPR_FORCED_ATTEMPTS
    try:
        res_f, _, ab = sweep_turns(
            "phase 14(b2) forced", gen, graphs,
            lambda rec, eager: sm.spr1_sweep_miss_lanes(
                gen, [p] * SPR_FORCED_LANES, L, SPR_FORCED_MOVES, c,
                t_max_tip, WRB, WH_, _eager=eager), on_card)
    finally:
        hh.ATTEMPTS = attempts
    out["b2_forced"] = dict(forced_record(
        "phase 14(b2)", res_f, ab, SPR_FORCED_LANES * SPR_FORCED_MOVES),
        ledger_err=max(miss_ledger(f"phase 14(b2) lane {i}", tree, r.p,
                                   r.delta_log_G, device)
                       for i, r in enumerate(res_f)))
    log(f"phase 14(b2) forced: {json.dumps(out['b2_forced'])} ({card})")

    # (c) one float32 lane, held to the float32 ledger scale
    p32, c32, _, _, _ = tdb.move_args(tree, device, F32)
    sm.spr1_sweep_miss(gen, p32, L, 2, c32, t_max_tip, WRB, WH_)
    res, dt, n_sync = on_card(lambda: sm.spr1_sweep_miss(
        gen, p32, L, SPR_MISS_MOVES, c32, t_max_tip, WRB, WH_))
    start = sm.unpack_tree_miss(p32, tree)
    e32 = miss_ledger("phase 14(c) float32", tree, res.p, res.delta_log_G,
                      device, dtype=F32, start_tree=start)
    out["c_f32"] = {"moves": SPR_MISS_MOVES,
                    "accepted": int(res.n_accepted),
                    "performable": int(res.n_eligible),
                    "graph_ms_per_move": dt * 1e3 / SPR_MISS_MOVES,
                    "host_syncs_per_move": n_sync / SPR_MISS_MOVES,
                    "ledger_err": e32,
                    "ledger_tol": f32_tol(card_log_G(start, device))}
    log(f"phase 14(c) float32: {json.dumps(out['c_f32'])} ({card})")
    out["host_sync_sources"] = sources
    out["captures"] = graphs.captures
    out["graphs_held"] = len(graphs.graphs)
    dg.clear()
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "device_spr_miss.json"),
              "w") as f:
        json.dump(out, f, indent=1, default=str)
    return out


# ---------------------------------------------------------------------------
# Phase 15: the posterior against the JAX package's, and ESS per hour
# ---------------------------------------------------------------------------

# scripts/jax_posterior_reference.py's output: the JAX package's float64
# posterior on the CPU at configurations S and R, two chains each
POSTERIOR_REF = os.path.join(REPO, "data", "jax_posterior_reference.json")
# (b): sampling windows in seconds (Ebola, 1,000 tips), --ess-windows for
# longer ones; moves burned before a window (the Run's 2M-move topology
# cadence cap); moves between samples in boundaries (one dispatch cycle,
# the JAX script's default, is ~2M moves: a handful of samples in a window
# this short)
ESS_WINDOWS = (45.0, 60.0)
ESS_BURN_MOVES = 2_000_000
ESS_SAMPLE_BOUNDARIES = {"ebola": 4, "tips_1000": 1}


def recovery_on_card(device, card: str, ref: dict, dtype) -> dict:
    """Phase 15(a): configuration R (VALIDATION.md's 48 tips x 6,000 sites,
    the JAX chains' pinned start and length) through
    scripts/torch_validate_recovery.py on the card in ``dtype``, chain seed
    101: the script's lines, RECOVERY, every summary against both JAX
    chains and the JAX null, the ledger (float64 1e-6, float32 the scaled
    bench bound), the tree's integrity and the kernels' launch counts."""
    import torch_validate_recovery as tvr

    from delphy_tpu_torch.parallel import _cuda
    tag = "f32" if dtype == F32 else "f64"
    R = ref["R"]
    data, rrun = R["recipe"]["data"], R["recipe"]["run"]
    k = {"T": data["tips"], "L": data["sites"], "seed": data["seed"],
         "burn": rrun["burn"], "samples": rrun["samples"],
         "thin": rrun["thin"]}

    def say(line):
        log(f"phase 15(a) {tag}: {line}")

    _cuda.reset_launch_counts()
    res, run = tvr.recovery_chain(k, device, dtype, pinned=True,
                                  on_line=say)
    sync(device)
    counts = check_counts(f"on recovery R in {tag}",
                          F32_EXP_PATH if dtype == F32 else EXP_PATH,
                          graphs=True)
    tol = f32_tol(run.ledger.log_G) if dtype == F32 else 1e-6
    run.check_derived_quantities(tol)
    run.tree().check_integrity()
    drift = abs(float(run.ledger.log_G) - float(run.calc_cur_ledger().log_G))
    res["against"] = tvr.against(res, ref, on_line=say)
    rec = {key: res[key] for key in ("knobs", "dtype", "tip_deltas",
                                     "truth", "posterior", "ess",
                                     "ess_per_hour_t_root", "recovery_ok",
                                     "against", "max_drift", "seconds",
                                     "topology")}
    rec.update(ledger={"tol": tol, "end_drift": drift},
               integrity=True, launch_counts=counts, card=card,
               log_post_end=run.log_posterior, step=run.step,
               trace=res["trace"])
    say(f"ledger {drift:.3e} (tol {tol:.3e}), integrity OK, "
        f"{res['seconds']:.1f} s ({card})")
    if not res["recovery_ok"]:
        raise AssertionError(f"phase 15(a) {tag}: RECOVERY: OFF")
    if not res["against"]["ok"]:
        raise AssertionError(
            f"phase 15(a) {tag}: largest sigma "
            f"{res['against']['max_sigma']:.2f} against the JAX chains, "
            f"bound {res['against']['bound']:.2f}")
    return rec


def ess_on_card(device, card: str, name: str, tree_pkl: str,
                window: float) -> dict:
    """Phase 15(b): scripts/torch_ess_at_scale.py's run from the pickled
    tree in float32 (bench.py's precision), ESS_BURN_MOVES of burn-in, then
    ``window`` seconds of samples; its JSON record, with the float32
    kernels launched in the window."""
    import torch_ess_at_scale as tes

    def say(msg):
        log(f"phase 15(b) {name}: {msg}")

    run = tes.make_run(0, 0, device, F32, tree_pkl=tree_pkl, say=say)
    lm = run.local_moves_per_global_move
    out = tes.measure(run, window,
                      sample_moves=ESS_SAMPLE_BOUNDARIES[name] * lm,
                      burn=ESS_BURN_MOVES, say=say)
    for k in F32_EXP_PATH:
        if out["kernels"].get(k, 0) <= 0:
            raise AssertionError(f"phase 15(b) {name}: {k} never launched "
                                 f"in the window: {out['kernels']}")
    if out["graph_replays"] <= 0:
        raise AssertionError(f"phase 15(b) {name}: no graph replay in the "
                             f"window")
    out.update(card=card, burn_moves=ESS_BURN_MOVES)
    log(f"phase 15(b) {name}: {json.dumps(out)}")
    return out


def posterior_phase(device, card: str, windows) -> dict:
    """Phase 15: (a) configuration R on the card in float64 and float32
    against the committed JAX chains; (b) ESS per hour in float32 on the
    Ebola main path and on phase 9a's 1,000-tip tree.  Writes
    chiprun_out/posterior.json."""
    import pickle
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    log("phase 15: the posterior against the JAX package's, ESS per hour")
    with open(POSTERIOR_REF) as f:
        ref = json.load(f)
    out = {"card": card, "reference": ref["what"],
           "recovery": {"f64": recovery_on_card(device, card, ref,
                                                torch.float64),
                        "f32": recovery_on_card(device, card, ref, F32)}}
    with tempfile.TemporaryDirectory() as tmp:
        ebola = os.path.join(tmp, "ebola.pkl")
        with open(ebola, "wb") as f:
            pickle.dump(load_tree(), f)
        out["ess"] = {"ebola": ess_on_card(device, card, "ebola", ebola,
                                           windows[0])}
    sim_tree(ONE_PART_TIPS, cache=True)        # phase 9a's cached tree
    out["ess"]["tips_1000"] = ess_on_card(
        device, card, "tips_1000", sim_tree_path(ONE_PART_TIPS), windows[1])
    for name, e in out["ess"].items():
        log(f"phase 15(b) {name} float32: ESS log_post / mu / t_root "
            f"{e['ess_log_post']} / {e['ess_mu']} / {e['ess_t_root']} of "
            f"{e['samples']} samples in {e['window_s']} s; ESS per hour "
            f"{e['ess_per_hour_log_post']} / {e['ess_per_hour_mu']} / "
            f"{e['ess_per_hour_t_root']}; MCSE log_post "
            f"{e['mcse_log_post']}, mu (relative) {e['mcse_mu_rel']}, "
            f"t_root {e['mcse_t_root']}; {e['moves_per_s']} moves/s "
            f"({card})")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "posterior.json"),
              "w") as f:
        json.dump(out, f, indent=1, default=str)
    return out


# ---------------------------------------------------------------------------
# Phase 16: the compiled dispatch (a CUDA graph of one boundary)
# ---------------------------------------------------------------------------

GRAPH_PAIRS = 3          # (b): graph and eager in turns, this many pairs
GRAPH_BOUNDARIES = 24    # (b): boundaries a reading
GRAPH_LARGE_WARM = 6     # (c): warm-up calls of a cycle's boundaries
GRAPH_LARGE_PAIRS = 3    # (c): then graph and eager calls in turns
# (d): overlapped cycles of each Run, in turns: in float64 enough for L's
# block count to settle (it climbs 51, 60, 67, 75 over the first four
# cycles at 10,000 tips), in float32 four
OVERLAP_CYCLES = 10
OVERLAP_CYCLES_F32 = 4


def graph_summary(run) -> dict:
    """A run's graph cache: its captures (ms, pool bytes, blocks), its
    dispatches by block count, the block counts of the graphs it holds
    and their pools' bytes, and its replays."""
    cache = run._graphs
    caps = cache.captures
    return {"captures": len(caps), "replays": cache.replays,
            "capture_ms": [c["ms"] for c in caps],
            "pool_bytes": [c["pool_bytes"] for c in caps],
            "blocks": [c["blocks"] for c in caps],
            "dispatches_by_blocks": dict(sorted(cache.dispatches.items())),
            "graphs_held": [k[1] for k in cache.graphs],
            "pool_bytes_held": sum(g.pool_bytes
                                   for g in cache.graphs.values())}


@contextlib.contextmanager
def eager_dispatch():
    """Run's dispatches through the eager loop (parts_multi_super_step's
    private ``_eager``): the other side of phase 16's A/B."""
    from delphy_tpu_torch import run as run_mod
    orig = run_mod.parts_multi_super_step
    run_mod.parts_multi_super_step = functools.partial(orig, _eager=True)
    try:
        yield
    finally:
        run_mod.parts_multi_super_step = orig


def dispatch_path(eager: bool):
    return eager_dispatch() if eager else contextlib.nullcontext()


def run_leaves(run) -> dict:
    """What 16(a) and 8 compare: the state, the ledger, the move count and
    the generator's state."""
    pop = (run.pop._asdict() if hasattr(run.pop, "_asdict")
           else {"x": run.pop.x, "gamma": run.pop.gamma, "tau": run.pop.tau})
    return {"ts.t": run.ts.t, "ts.mut_t": run.ts.mut_t,
            **{f"evo.{k}": v for k, v in run.evo._asdict().items()},
            **{f"pop.{k}": v for k, v in pop.items()},
            **{f"ledger.{k}": v for k, v in run.ledger._asdict().items()},
            "local_moves_attempted": torch.tensor(run.local_moves_attempted),
            "generator": run.gen.get_state()}


def main_recipe(device, dtype, eager: bool, kw=None, boundaries=None):
    """Phase 4's recipe (a 2-boundary call, then one of lm x
    topology_burst_chunks, or of lm x ``boundaries``) in ``dtype`` through
    graphs or the eager loop, on a Run with the extra arguments ``kw`` (a
    model option): (run, record) with the launch counts and replays of
    both calls and the long call's moves/s; the ledger (float64 1e-6,
    float32 the scaled bench bound) and the tree's integrity checked."""
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.run import Run
    with dispatch_path(eager):
        run = Run(load_tree(), seed=SEED, num_cells=NUM_CELLS, device=device,
                  dtype=dtype, **(kw or {}))
        lm = run.local_moves_per_global_move
        _cuda.reset_launch_counts()
        run.do_mcmc_steps(2 * lm)
        first = graph_summary(run)
        sync(device)
        base = run.local_moves_attempted
        t0 = time.perf_counter()
        run.do_mcmc_steps(lm * (boundaries or run.topology_burst_chunks))
        sync(device)
        dt = time.perf_counter() - t0
    tol = 1e-6 if dtype == torch.float64 else f32_tol(run.ledger.log_G)
    run.check_derived_quantities(tol)
    run.tree().check_integrity()
    return run, {
        "path": "eager" if eager else "graph",
        "moves_per_s": (run.local_moves_attempted - base) / dt, "s": dt,
        "launch_counts": {k: v for k, v in _cuda.launch_counts.items() if v},
        "graph_replays": _cuda.graph_replays, "step": run.step,
        "log_post": run.log_posterior, "ledger_tol": tol,
        "graphs_after_first_call": first, "graphs": graph_summary(run)}


def graph_against_eager(device, card: str, kw=None, boundaries=None,
                        what: str = "16(a)") -> dict:
    """16(a) (and 8(i) with a model option's Run arguments ``kw`` and a
    long call of ``boundaries``): phase 4's recipe from one tree and seed
    through graphs and through the eager loop, float64 and float32: the
    state, the ledger, local_moves_attempted and the generator's state
    equal, the kernels' launch counts equal, graph replays only on the
    graph path."""
    out = {}
    for dtype in (torch.float64, F32):
        tag = "f64" if dtype == torch.float64 else "f32"
        g_run, g = main_recipe(device, dtype, False, kw, boundaries)
        e_run, e = main_recipe(device, dtype, True, kw, boundaries)
        a, b = run_leaves(g_run), run_leaves(e_run)
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        if differ:
            raise AssertionError(f"phase {what} {tag}: graph and eager "
                                 f"differ in {differ}")
        if g["launch_counts"] != e["launch_counts"]:
            raise AssertionError(f"phase {what} {tag}: launch counts "
                                 f"{g['launch_counts']} (graph) != "
                                 f"{e['launch_counts']} (eager)")
        if g["graph_replays"] <= 0 or e["graph_replays"] != 0:
            raise AssertionError(f"phase {what} {tag}: replays "
                                 f"{g['graph_replays']} (graph), "
                                 f"{e['graph_replays']} (eager)")
        out[tag] = {"bit_equal": sorted(a), "graph": g, "eager": e}
        log(f"phase {what} {tag}: graph = eager bit for bit ({len(a)} "
            f"tensors, generator included) at step {g['step']}, log_post "
            f"{g['log_post']:.4f}; launches {g['launch_counts']} each, "
            f"graph replays {g['graph_replays']}; captures "
            f"{json.dumps(g['graphs'])}; {g['moves_per_s']:.1f} "
            f"moves/s through graphs, {e['moves_per_s']:.1f} eager ({card})")
        del g_run, e_run
    return out


def graph_profile(device, card: str, kw=None, pairs: int = GRAPH_PAIRS,
                  n: int = GRAPH_BOUNDARIES, what: str = "16(b)") -> dict:
    """16(b) (and 8(ii) with a model option's Run arguments ``kw``): where
    a boundary's time goes through graphs and through the eager loop,
    ``pairs`` pairs in turns, each on a fresh Run without topology moves
    dispatching ``n`` boundaries at the path's block count: ms a boundary
    (wall and enqueue), moves/s, host syncs in a dispatch, the device's
    busy share and the host's launch calls and device operations a
    boundary under torch.profiler (phase 5's method), and the graph's
    captures."""
    from delphy_tpu_torch.parallel.sweep import parts_multi_super_step
    from delphy_tpu_torch.run import Run
    recs = {"graph": [], "eager": []}
    for path in ("graph", "eager") * pairs:
        run = Run(load_tree(), seed=SEED, num_cells=NUM_CELLS, device=device,
                  topology_moves_enabled=False, **(kw or {}))
        lm = run.local_moves_per_global_move
        with dispatch_path(path == "eager"):
            run.do_mcmc_steps(2 * lm)
        nb = max(1, min(run._nb_cap(), round(lm / run._per_block_rate)))
        path_kw = ({"_eager": True} if path == "eager"
                   else {"graphs": run._graphs})

        def dispatch():
            return parts_multi_super_step(
                run.ts, run.evo, run.pop, run.gen, run.tin, run.tout,
                run.pm, nb, run.t_max_tip, run.hyp, run.num_cells, n,
                nb_max=run._nb_cap(), **path_kw)
        caps0 = len(run._graphs.captures)
        dispatch()                                   # warm-up, captures
        sync(device)
        caps = run._graphs.captures
        rec = {"blocks": nb, "captures_in_warm_up": caps[caps0:]}
        t0 = time.perf_counter()
        out = dispatch()
        enq = time.perf_counter() - t0
        moves = int(out[4]["local_moves_attempted"])
        wall = time.perf_counter() - t0
        rec.update(wall_ms_per_boundary=wall * 1e3 / n,
                   enqueue_ms_per_boundary=enq * 1e3 / n,
                   moves_per_s_no_bursts=moves / wall,
                   syncs_in_dispatch=syncs_in(dispatch))
        sync(device)
        tr = busy_share(lambda: dispatch(), f"{what} {path}, {n} boundaries")
        rec.update(busy_share=tr["busy_share"],
                   launch_calls_per_boundary=tr["launch_calls"] / n,
                   device_ops_per_boundary=tr["device_events"] / n,
                   traced_wall_ms_per_boundary=tr["wall_s"] * 1e3 / n)
        if rec["syncs_in_dispatch"]:
            raise AssertionError(f"phase {what} {path}: host syncs inside a "
                                 f"dispatch: {rec['syncs_in_dispatch']}")
        if len(caps) != caps0 + len(rec["captures_in_warm_up"]):
            raise AssertionError(f"phase {what}: a dispatch of a size "
                                 f"already captured captured again")
        recs[path].append(rec)
        log(f"phase {what} {path}: {json.dumps(rec)} ({card})")
        del run
    return recs


def graph_large(device, card: str, tips: int = LARGE_TIPS,
                warm: int = GRAPH_LARGE_WARM,
                pairs: int = GRAPH_LARGE_PAIRS) -> dict:
    """16(c): phase 9c's ``tips``-tip tree through the blocking driver on
    two Runs of one seed, one through graphs and one through the eager
    loop: ``warm`` calls of a cycle's boundaries and their burst each (the
    block count settles), then ``pairs`` pairs of such calls in turns
    graph, eager, eager, graph, ...: moves/s and captures of every call,
    the dispatches by block count, the graphs held and their pools' bytes;
    one traced call of each (busy share, launch calls); then the two runs
    bit-equal, the ledger at 1e-6 and the tree's integrity."""
    from delphy_tpu_torch import run as run_mod
    from delphy_tpu_torch.parallel import _cuda
    tree = sim_tree(tips, cache=True)
    prev = os.environ.get("DELPHY_TPU_OVERLAP")
    os.environ["DELPHY_TPU_OVERLAP"] = "0"
    runs = {}
    out = {"tips": tips, "graph": {"warm": [], "calls": []},
           "eager": {"warm": [], "calls": []}}

    def call(path, run, kind):
        caps = len(run._graphs.captures)
        with dispatch_path(path == "eager"):
            _cuda.reset_launch_counts()
            sync(device)
            base = run.local_moves_attempted
            t0 = time.perf_counter()
            run.do_mcmc_steps(B * lm)
            sync(device)
            dt = time.perf_counter() - t0
        if kind == "calls":
            check_counts(f"on 16(c)'s {path} path", EXP_PATH,
                         graphs=path == "graph")
        moves = run.local_moves_attempted - base
        out[path][kind].append({
            "moves": moves, "s": dt, "moves_per_s": moves / dt,
            "captures": len(run._graphs.captures) - caps})
    try:
        for path in ("graph", "eager"):
            with dispatch_path(path == "eager"):
                run = run_mod.Run(tree, seed=SEED, num_cells=NUM_CELLS,
                                  device=device)
            lm = run.local_moves_per_global_move
            B = max(1, min(run.topology_burst_chunks,
                           run_mod.RESTENCIL_INTERVAL,
                           run_mod.OVERLAP_DISPATCH_MOVES // lm))
            for _ in range(warm):
                call(path, run, "warm")
            runs[path] = run
        for path in ("graph", "eager", "eager", "graph") * (pairs // 2) + (
                ("graph", "eager") if pairs % 2 else ()):
            call(path, runs[path], "calls")
        for path, run in runs.items():
            with dispatch_path(path == "eager"):
                tr = busy_share(lambda: run.do_mcmc_steps(B * lm),
                                f"16(c) {tips:,} tips, {path}, {B} "
                                f"boundaries and a burst")
            out[path].update(traced=tr, graphs=graph_summary(run))
            run.check_derived_quantities(1e-6)
            run.tree().check_integrity()
            out[path]["ledger_drift"] = abs(
                float(run.ledger.log_G) - float(run.calc_cur_ledger().log_G))
        a, b = (run_leaves(runs[p]) for p in ("graph", "eager"))
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        if differ:
            raise AssertionError(f"phase 16(c): graph and eager differ in "
                                 f"{differ}")
        for path in ("graph", "eager"):
            r = out[path]
            log(f"phase 16(c) {tips:,} tips, blocking, {path}: captures a "
                f"warm-up call {[c['captures'] for c in r['warm']]}, then "
                f"{[c['moves_per_s'] for c in r['calls']]} moves/s and "
                f"{[c['captures'] for c in r['calls']]} captures a call "
                f"({B} boundaries and a burst), busy share "
                f"{r['traced']['busy_share']:.4f}, ledger drift "
                f"{r['ledger_drift']:.3e} (1e-6), graphs "
                f"{json.dumps(r['graphs'])} ({card})")
        log(f"phase 16(c): the two runs bit-equal at step "
            f"{runs['graph'].step}")
        out["boundaries_per_call"] = B
        del runs, run
    finally:
        if prev is None:
            os.environ.pop("DELPHY_TPU_OVERLAP", None)
        else:
            os.environ["DELPHY_TPU_OVERLAP"] = prev
    return out


def overlap_selection(run, device) -> torch.Tensor:
    """A selection as the overlapped driver makes it (the first parts, pad
    rows after them where the part axis has them)."""
    W = run.pm.node_map.shape[0] // 2
    n_real = len(run._last_cuts) + 1
    n_dev = min(W, max(1, n_real - 1))
    sel = torch.full((W,), n_real, dtype=torch.long, device=device)
    sel[:n_dev] = torch.arange(n_dev, device=device)
    return sel


def overlap_dispatch_readings(run, device, path: str, B: int, nb: int,
                              what: str) -> dict:
    """The overlapped driver's G (one globals-only boundary) and L (``B``
    boundaries of ``nb`` blocks over half the parts) dispatched alone on
    ``run``'s state, through its graphs or the eager loop, each after a
    warm-up call (a capture where the last merge changed a shape): ms a
    boundary (enqueue, wall), host syncs inside the dispatch, and under
    torch.profiler the busy share, launch calls and device operations a
    boundary; through graphs, no sync and no capture after the warm-up."""
    from delphy_tpu_torch.parallel.sweep import parts_multi_super_step
    sel = overlap_selection(run, device)
    kw = {"_eager": True} if path == "eager" else {"graphs": run._graphs}

    def G():
        return parts_multi_super_step(
            run.ts, run.evo, run.pop, run.gen, run.tin, run.tout, run.pm, 0,
            run.t_max_tip, run.hyp, run.num_cells, 1, param_moves=True, **kw)

    def L():
        return parts_multi_super_step(
            run.ts, run.evo, run.pop, run.gen, run.tin, run.tout, run.pm,
            nb, run.t_max_tip, run.hyp, run.num_cells, B, param_moves=False,
            part_sel=sel, nb_max=run._nb_cap(overlapped=True), **kw)
    res = {}
    for name, fn, n in (("G", G, 1), ("L", L, B)):
        # a warm-up: the cycle's merge may have grown a capacity, and a
        # new shape is a new key
        fn()
        sync(device)
        caps = len(run._graphs.captures)
        t0 = time.perf_counter()
        fn()
        enq = time.perf_counter() - t0
        sync(device)
        wall = time.perf_counter() - t0
        syncs = syncs_in(fn)
        sync(device)
        tr = busy_share(fn, f"{what} {path} {name}, {n} boundaries")
        res[name] = {"boundaries": n, "enqueue_ms_per_boundary":
                     enq * 1e3 / n, "wall_ms_per_boundary": wall * 1e3 / n,
                     "syncs_in_dispatch": syncs,
                     "busy_share": tr["busy_share"],
                     "launch_calls_per_boundary": tr["launch_calls"] / n,
                     "device_ops_per_boundary": tr["device_events"] / n}
        if path == "graph" and (syncs or len(run._graphs.captures) != caps):
            raise AssertionError(f"phase {what} {name}: host syncs {syncs}, "
                                 f"captures {run._graphs.captures[caps:]} "
                                 f"at a key captured by the warm-up")
    return res


def graph_overlap(device, card: str, tips: int = LARGE_TIPS,
                  cycles: int = OVERLAP_CYCLES,
                  cycles_f32: int = OVERLAP_CYCLES_F32,
                  dtypes=(torch.float64, F32)) -> dict:
    """16(d): phase 9c's ``tips``-tip tree through the overlapped driver
    (DELPHY_TPU_OVERLAP=1) on two Runs of one seed, one through graphs and
    one through the eager loop, ``cycles`` cycles each in turns in float64
    and ``cycles_f32`` in float32 (``dtypes``: the precisions run): each
    cycle's stage times, L block count, launch counts, replays and
    captures (count, ms, blocks, pool bytes); the runs bit-equal (state,
    ledger, move count, both generators, the cycles' counts), the same
    launch counts, replays on the graph path only, the ledger (float64
    1e-6, float32 the scaled bench bound) and integrity; in float64 the G
    and L dispatches alone on each path (overlap_dispatch_readings) and
    one traced cycle of each."""
    from delphy_tpu_torch import run as run_mod
    from delphy_tpu_torch.parallel import _cuda
    tree = sim_tree(tips, cache=True)
    prev = os.environ.get("DELPHY_TPU_OVERLAP")
    os.environ["DELPHY_TPU_OVERLAP"] = "1"
    out = {"tips": tips}
    counts_keys = ("boundaries", "n_blocks", "parts_swept",
                   "selection_width", "parts_real", "burst_moves",
                   "local_moves")
    try:
        for dtype in dtypes:
            tag = "f64" if dtype == torch.float64 else "f32"
            runs, recs = {}, {"graph": [], "eager": []}
            for path in ("graph", "eager"):
                with dispatch_path(path == "eager"):
                    runs[path] = run_mod.Run(tree, seed=SEED,
                                             num_cells=NUM_CELLS,
                                             device=device, dtype=dtype)
                if not runs[path]._overlap_active():
                    raise AssertionError("phase 16(d): overlap is off")
            lm = runs["graph"].local_moves_per_global_move
            B = max(1, min(runs["graph"].topology_burst_chunks,
                           run_mod.RESTENCIL_INTERVAL,
                           run_mod.OVERLAP_DISPATCH_MOVES // lm))
            n = cycles if dtype == torch.float64 else cycles_f32
            for path in ("graph", "eager", "eager", "graph") * (n // 2):
                run = runs[path]
                caps = len(run._graphs.captures)
                with dispatch_path(path == "eager"):
                    _cuda.reset_launch_counts()
                    sync(device)
                    t0 = time.perf_counter()
                    run.do_mcmc_steps(B * lm)
                    sync(device)
                    dt = time.perf_counter() - t0
                new = run._graphs.captures[caps:]
                recs[path].append(dict(
                    run.last_cycle, wall_s=dt,
                    moves_per_s=(run.last_cycle["local_moves"]
                                 + run.last_cycle["burst_moves"]) / dt,
                    launch_counts={k: v for k, v in
                                   _cuda.launch_counts.items() if v},
                    graph_replays=_cuda.graph_replays,
                    captures=len(new),
                    capture_ms=sum(c["ms"] for c in new),
                    capture_blocks=[c["blocks"] for c in new],
                    capture_pool_bytes=[c["pool_bytes"] for c in new]))
                c = recs[path][-1]
                log(f"16(d) {tag} {path} cycle: {c['wall_s']:.3f} s, L "
                    f"blocks {c['n_blocks']}, captures {c['capture_blocks']}"
                    f" in {c['capture_ms']:.1f} ms")
            g_run, e_run = runs["graph"], runs["eager"]
            a, b = run_leaves(g_run), run_leaves(e_run)
            differ = [k for k in a if not torch.equal(a[k], b[k])]
            if g_run.host_rng.bit_generator.state != \
                    e_run.host_rng.bit_generator.state:
                differ.append("host_rng")
            for i, (cg, ce) in enumerate(zip(recs["graph"],
                                             recs["eager"])):
                if [cg[k] for k in counts_keys + ("launch_counts",)] != \
                        [ce[k] for k in counts_keys + ("launch_counts",)]:
                    differ.append(f"cycle {i}")
                if cg["graph_replays"] != cg["boundaries"] + 1 or \
                        ce["graph_replays"] != 0:
                    differ.append(f"cycle {i} replays")
            if differ:
                raise AssertionError(f"phase 16(d) {tag}: graph and eager "
                                     f"differ in {differ}")
            tol = 1e-6 if dtype == torch.float64 else f32_tol(
                g_run.ledger.log_G)
            for run in (g_run, e_run):
                run.check_derived_quantities(tol)
                run.tree().check_integrity()
            rec = {"boundaries_per_cycle": B, "bit_equal": sorted(a),
                   "ledger_tol": tol, "step": g_run.step,
                   "log_post": g_run.log_posterior,
                   "graphs": graph_summary(g_run), **recs}
            if dtype == torch.float64:
                nb = recs["graph"][-1]["n_blocks"]
                for path, run in runs.items():
                    rec[f"{path}_dispatches"] = overlap_dispatch_readings(
                        run, device, path, B, nb, "16(d)")
                    with dispatch_path(path == "eager"):
                        rec[f"{path}_traced_cycle"] = busy_share(
                            lambda: run.do_mcmc_steps(B * lm),
                            f"16(d) {tips:,} tips, {path}, one overlapped "
                            f"cycle")
                    log(f"phase 16(d) {tag} {path}: G and L alone "
                        f"{json.dumps(rec[f'{path}_dispatches'])} ({card})")
            out[tag] = rec
            for path in ("graph", "eager"):
                log(f"phase 16(d) {tips:,} tips overlapped {tag} {path}: "
                    f"L blocks {[c['n_blocks'] for c in recs[path]]}, "
                    f"wall s {[c['wall_s'] for c in recs[path]]}, enqueue "
                    f"G+L s {[c['enqueue_GL_s'] for c in recs[path]]}, "
                    f"wait G {[c['wait_G_s'] for c in recs[path]]}, burst "
                    f"{[c['burst_s'] for c in recs[path]]}, join L "
                    f"{[c['join_L_s'] for c in recs[path]]}, merge "
                    f"{[c['merge_s'] for c in recs[path]]}, captures "
                    f"{[c['captures'] for c in recs[path]]} "
                    f"({[c['capture_ms'] for c in recs[path]]} ms, blocks "
                    f"{[c['capture_blocks'] for c in recs[path]]}, pools "
                    f"{[c['capture_pool_bytes'] for c in recs[path]]}) "
                    f"({card})")
            log(f"phase 16(d) {tag}: graph = eager bit for bit after "
                f"{n} overlapped cycles each ({len(a)} tensors, both "
                f"generators, each cycle's counts and launches) at step "
                f"{g_run.step}, log_post {g_run.log_posterior:.4f}; "
                f"graphs {json.dumps(rec['graphs'])}")
            del runs, g_run, e_run, run
    finally:
        if prev is None:
            os.environ.pop("DELPHY_TPU_OVERLAP", None)
        else:
            os.environ["DELPHY_TPU_OVERLAP"] = prev
    return out


def write_dispatch_graph(out: dict) -> None:
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "dispatch_graph.json"),
              "w") as f:
        json.dump(out, f, indent=1, default=str)


def dispatch_graph_phase(device, card: str, options: dict) -> dict:
    """Phase 16: the compiled dispatch.  Writes
    chiprun_out/dispatch_graph.json, with phase 8's record of the model
    options (``options``) under "options"."""
    log("phase 16: the compiled dispatch (CUDA graphs of one boundary)")
    t0 = time.perf_counter()
    out = {"card": card, "torch": torch.__version__, "options": options,
           "a": graph_against_eager(device, card),
           "b": graph_profile(device, card),
           "c": graph_large(device, card),
           "d": graph_overlap(device, card)}
    out["seconds"] = time.perf_counter() - t0
    summary = {
        "ms_per_boundary": {p: [r["wall_ms_per_boundary"] for r in rs]
                            for p, rs in out["b"].items()},
        "enqueue_ms_per_boundary": {
            p: [r["enqueue_ms_per_boundary"] for r in rs]
            for p, rs in out["b"].items()},
        "busy_share": {p: [r["busy_share"] for r in rs]
                       for p, rs in out["b"].items()},
        "launch_calls_per_boundary": {
            p: [r["launch_calls_per_boundary"] for r in rs]
            for p, rs in out["b"].items()},
        "main_path_moves_per_s": {
            tag: {p: out["a"][tag][p]["moves_per_s"]
                  for p in ("graph", "eager")} for tag in out["a"]},
        "tips_10k_moves_per_s": {p: [c["moves_per_s"]
                                     for c in out["c"][p]["calls"]]
                                 for p in ("graph", "eager")},
        "tips_10k_graph_captures_a_call": [
            c["captures"] for c in out["c"]["graph"]["warm"]
            + out["c"]["graph"]["calls"]],
        "tips_10k_graph_pool_bytes_held": out["c"]["graph"]["graphs"][
            "pool_bytes_held"],
        "overlapped_10k": {
            p: {"wall_s": [c["wall_s"] for c in out["d"]["f64"][p]],
                "enqueue_GL_s": [c["enqueue_GL_s"]
                                 for c in out["d"]["f64"][p]],
                "L_blocks": [c["n_blocks"] for c in out["d"]["f64"][p]],
                "captures": [c["captures"] for c in out["d"]["f64"][p]],
                "L_launch_calls_per_boundary": out["d"]["f64"][
                    f"{p}_dispatches"]["L"]["launch_calls_per_boundary"],
                "busy_share_cycle": out["d"]["f64"][f"{p}_traced_cycle"][
                    "busy_share"]}
            for p in ("graph", "eager")}}
    out["summary"] = summary
    log(f"phase 16: {json.dumps(summary)} in {out['seconds']:.1f} s "
        f"({card})")
    write_dispatch_graph(out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the main path, profile a boundary (phase 5)")
    ap.add_argument("--baseline", metavar="CSRC_DIR",
                    help="also time another tree's kernel sources (phase 3)")
    ap.add_argument("--large-tips", type=int, default=0, metavar="N",
                    help="phase 9d: also run a simulated tree of N tips "
                         "(the scale bench's is 100000)")
    ap.add_argument("--ess-windows", nargs=2, type=float,
                    default=ESS_WINDOWS, metavar=("EBOLA_S", "TIPS1K_S"),
                    help="phase 15(b)'s sampling windows in seconds")
    ap.add_argument("--mixer-child", nargs=2, metavar=("TREES", "OUT"),
                    help=argparse.SUPPRESS)
    opts = ap.parse_args(argv)
    if opts.mixer_child:
        return mixer_child(*opts.mixer_child)
    # phases 1-11, 13 and 14 are the float64 engine; phase 12 sets the switch
    f32_given = os.environ.pop(F32_ENV, None)
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
    if f32_given is not None:
        log(f"{F32_ENV}={f32_given!r} given: phases 1-11 run in float64 "
            f"all the same, phase 12 in float32")

    t0 = time.perf_counter()
    floor_so, base = build_all(opts.baseline)
    log(f"built in {time.perf_counter() - t0:.1f} s")

    run = Run(load_tree(), seed=SEED, num_cells=NUM_CELLS, device=device)
    run.do_mcmc_steps(run.local_moves_per_global_move)
    records, floor = compare_kernels(run, device, base, floor_so)
    del run

    counts, exp_ms, native_burst = main_path(device, card)
    for r in records:
        if r["name"] in counts and counts[r["name"]] > 0:
            r["launches"] = counts[r["name"]]
    if opts.profile:
        profile_path(device)
    dphy_leg = have_flatbuffers()
    cli_path(device, card, dphy_leg)
    model_cli(device, card)
    server_path(device, card, dphy_leg)
    model_server(device, card)
    sky, options = model_paths(device, card, exp_ms)
    for r in records:
        if r["name"] == "sweep_chain_skygrid":
            r["launches"] = sky["staircase"]
            r["launches_log_linear"] = sky["log-linear"]
    large, exp_pop_large, tips10k = large_trees(device, card, base,
                                                opts.large_tips)
    for r in records:
        if r["name"] == "exp_pop_chain":
            r["at_large_trees"] = exp_pop_large
            r["max_abs_err"] = max([r["max_abs_err"]] + [
                v["max_abs_err"] for v in exp_pop_large.values()])
    records += large
    mesh_paths(device, card)
    unpart = unpartitioned_path(device, card)
    for r in records:
        if r["name"] in ("hky_chain", "exp_pop_chain"):
            r["launches_unpartitioned"] = \
                unpart["ebola"]["launch_counts"][r["name"]]
    records += f32_engine(device, card, records, tips10k)
    fallback_and_device_spr(device, card, native_burst)
    spr_miss_phase(device, card)
    post = posterior_phase(device, card, opts.ess_windows)
    for r in records:
        for tag, rec in post["recovery"].items():
            n = rec["launch_counts"].get(r["name"], 0)
            if n:
                r[f"launches_recovery_{tag}"] = n
    dispatch_graph_phase(device, card, options)
    print(json.dumps({"kernels": records, "launch_floor_ms": floor}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
