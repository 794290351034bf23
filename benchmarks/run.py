"""The benchmark of ``delphy_tpu_torch``: one run of one cell.

    python3 -m benchmarks.run --workload CELL --seed N --seconds S --trace 0|1
        [--control]

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``
under this folder: the dataset, its precision and its sizes) and a traffic
mix (``traffic/<name>.json``: the ``Run``'s analysis, the call size, the
warm-up and the traced slice); its limits are ``limits/<cell>.json`` and
each per-layer metric is read by ``metrics/<metric>.py``.  A new cell,
mix or metric is new files and entries; this file does not change.

Set-up reads or makes the dataset, builds the initial tree from the seed,
makes the ``Run`` on the card and warms it up with whole calls until a call
captures no new CUDA graph.  The window then drives ``Run.do_mcmc_steps``
in calls of the cell's size for ``--seconds`` seconds and ends with a
synchronise.  After the window, ``trace_calls`` more whole calls are
judged: the node times before and after each of their dispatches are kept,
and with ``--trace 1`` the calls run under ``torch.profiler``.  ``--trace
0`` reports the end-to-end metrics (``steps_per_s`` over the window,
``setup_s``), ``--trace 1`` the per-layer metrics.  Either way the final
state is then judged against the plain NumPy reference (``reference/``),
and the last line of standard output is one JSON object.  ``--control`` runs the program in float32, the precision
below the configuration's, for the check that the comparison fails it.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import inspect  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402

from . import datasets  # noqa: E402
from .frozen import trace as tr  # noqa: E402
from .reference import judge  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "delphy_tpu")


def log(msg: str) -> None:
    print(f"[bench {time.perf_counter() - T_PROCESS:8.2f}s] {msg}",
          file=sys.stderr, flush=True)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: str, workload: str) -> dict:
    """The cell, its configuration, traffic, limits and metrics, found by
    name from ``root``'s ``BENCHMARK.json``."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    here = os.path.join(root, os.path.relpath(HERE, ROOT))
    end = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload])]
    return {
        "root": root, "cell": cell,
        "config": _json(os.path.join(root, configs[cell["config"]]["file"])),
        "traffic": _json(os.path.join(here, "traffic",
                                      cell["traffic"] + ".json")),
        "limits": _json(os.path.join(here, "limits", workload + ".json")),
        "end_to_end": end, "per_layer": layer,
        "metrics_dir": os.path.join(here, "metrics"),
    }


def reader(metrics_dir: str, name: str):
    """``read(rec)`` of ``metrics/<name>.py``; a metric split by cells
    (``<name>.<cells>``) is read by its base quantity's reader."""
    name = name.split(".")[0]
    path = os.path.join(metrics_dir, name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmarks_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def isolate_environment() -> None:
    """Run the program as the configuration states, whatever the caller's
    environment asks of it, and keep every compiler cache in the
    checkout."""
    for k in [k for k in os.environ if k.startswith("DELPHY_TPU_")]:
        del os.environ[k]
    cache = os.path.join(HERE, "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


# -- the program's outputs, as plain data -----------------------------------------

def state_of(tree) -> dict:
    names = list(tree.name)
    return {
        "parent": np.asarray(tree.parent), "children": np.asarray(tree.children),
        "t": np.asarray(tree.t, dtype=np.float64), "root": int(tree.root),
        "ref_seq": np.asarray(tree.ref_seq, dtype=np.int8),
        "names": [names[n] if n < len(names) else None
                  for n in range(len(tree.parent))],
        "mutations": [[(m.site, m.from_, m.to, m.t) for m in ms]
                      for ms in tree.mutations],
    }


def params_of(hv) -> dict:
    evo, pop = hv.evo, hv.pop
    part = np.asarray(evo.part)
    if part.size and part.max() > 0:
        raise ValueError("the reference holds one partition of sites")
    if hasattr(pop, "gamma"):
        p = {"model": "skygrid", "type": int(pop.type),
             "x": np.asarray(pop.x, dtype=np.float64),
             "gamma": np.asarray(pop.gamma, dtype=np.float64),
             "tau": float(pop.tau)}
    else:
        p = {"model": "exp", "t0": float(pop.t0), "n0": float(pop.n0),
             "g": float(pop.g), "min_pop": float(pop.min_pop)}
    return {"mu": float(evo.mu), "kappa": float(evo.kappa),
            "pi": np.asarray(evo.pi, dtype=np.float64).reshape(4),
            "alpha": float(evo.alpha),
            "nu": np.asarray(evo.nu, dtype=np.float64), "pop": p}


def ledger_of(hv) -> dict:
    led = hv.ledger
    if led is None:
        return {k: math.nan for k in ("log_G", "log_coal", "log_other")}
    return {"log_G": float(led.log_G), "log_coal": float(led.log_coal),
            "log_other": float(led.log_other)}


# -- one run ------------------------------------------------------------------

def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def call_steps(run, traffic: dict) -> int:
    b = traffic["call_boundaries"]
    boundaries = run.topology_burst_chunks if b == "burst" else int(b)
    return run.local_moves_per_global_move * boundaries


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: bool = False,
             t_start: float = T_PROCESS) -> dict:
    """One run: set-up, window, optional traced slice, judgement.  Returns
    the result line as a dict."""
    import torch

    from delphy_tpu_torch import run as run_mod
    from delphy_tpu_torch.init_tree import build_initial_tree
    from delphy_tpu_torch.mcmc.global_moves import PriorConfig

    cfg, traffic = spec["config"], spec["traffic"]
    ds = datasets.load(cfg, spec["root"])
    dtype = torch.float32 if control else getattr(torch, cfg["precision"])
    log(f"{spec['cell']['name']}: {ds.num_tips} tips x {ds.num_sites} "
        f"sites, seed {seed}, {dtype}")
    tree = build_initial_tree(ds.ref_seq, ds.deltas, ds.miss, ds.dates,
                              names=ds.names,
                              rng=np.random.default_rng(seed))
    run = run_mod.Run(tree, seed=seed, num_cells=cfg["num_cells"],
                      device=device, dtype=dtype,
                      hyp=PriorConfig(**traffic.get("priors", {})),
                      **traffic.get("run", {}))
    del tree
    steps = call_steps(run, traffic)
    captures = run._graphs.captures
    warm_calls = quiet = 0
    while (warm_calls < traffic["warmup_max_calls"]
           and quiet < traffic["warmup_quiet_calls"]):
        before = len(captures)
        run.do_mcmc_steps(steps)
        warm_calls += 1
        quiet = quiet + 1 if len(captures) == before else 0
    sync(device)
    capture_ms = [c["ms"] for c in captures]
    start = run.host_view()
    params_at_start = params_of(start)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: {warm_calls} warm-up calls of {steps} "
        f"steps, {len(capture_ms)} graph captures (blocks "
        f"{[c.get('blocks') for c in captures]})")

    # the window
    captured = len(captures)
    steps0 = run.local_moves_attempted
    ends = []
    t0 = time.perf_counter()
    while not ends or ends[-1] - t0 < seconds:
        run.do_mcmc_steps(steps)
        ends.append(time.perf_counter())
    sync(device)
    wall = time.perf_counter() - t0
    calls = len(ends)
    log(f"calls end at {[round(e - t0, 3) for e in ends]} s")
    done = run.local_moves_attempted - steps0
    in_window = len(captures) - captured
    log(f"window {wall:.3f} s: {calls} calls, {done} steps, "
        f"{done / wall:.1f} steps/s, {in_window} captures in the window "
        f"{[(c.get('blocks'), c['ms']) for c in captures[captured:]]}")

    metrics, device_rec, breakdown = {}, {}, None
    rec = after_window(run, run_mod, traffic, device, trace)
    if trace:
        rec["capture_ms"] = capture_ms
        for m in spec["per_layer"]:
            v = reader(spec["metrics_dir"], m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_rec = {"busy_s": rec["busy_s"], "window_s": rec["window_s"]}
        breakdown = rec["breakdown"]
    else:
        # a metric split by cells (``steps_per_s.<cells>``) is its base
        # quantity
        values = {"steps_per_s": done / wall, "setup_s": setup_s}
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"].split(".")[0]],
                                  "unit": m["unit"]}

    peak = (torch.cuda.max_memory_allocated() if device == "cuda"
            else None)
    hv = run.host_view()
    state, params, led = state_of(run.tree()), params_of(hv), ledger_of(hv)
    del run, hv, start
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    settings = {"num_cells": cfg["num_cells"],
                "t_max_tip": max(hi for _, hi in ds.dates),
                "priors": traffic.get("priors", {})}
    nums = judge.numbers(state, params, led, ds, settings, params_at_start,
                         rec["unmoved"])
    correct, rows = judge.verdict(nums, spec["limits"])
    log(f"reference {time.perf_counter() - t_ref:.3f} s")

    if device == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": spec["cell"]["chips"], "memory_peak_bytes": peak}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    dev.update(device_rec)
    out = {"correct": correct, "attempted": calls,
           "failed": 0 if correct else calls, "metrics": metrics,
           "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": float(v), "limit": lim}
                     for k, v, lim in rows}
    out["_window"] = {"captures_in_window": in_window, "steps": done,
                      "wall_s": wall, "warmup_calls": warm_calls}
    return out


def after_window(run, run_mod, traffic: dict, device: str,
                 trace: bool) -> dict:
    """``trace_calls`` whole calls after the window, each dispatch wrapped:
    its inner nodes whose time it left bit for bit as it found them are
    counted (``unmoved``), and with ``trace`` the calls run under
    torch.profiler with spans around each dispatch and each topology burst,
    for the per-layer readers."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from delphy_tpu_torch.parallel import _cuda

    steps = call_steps(run, traffic)
    dispatches, kept = [], []
    orig_dispatch = run_mod.parts_multi_super_step
    orig_burst = run._topology_burst
    sig = inspect.signature(orig_dispatch)

    def dispatch(*a, **k):
        arg = sig.bind(*a, **k).arguments
        ts = arg["ts"]
        before = dict(_cuda.launch_counts)
        t0 = ts.t.clone()
        with record_function("bench.dispatch"):
            out = orig_dispatch(*a, **k)
        kept.append((ts.parent.clone(), t0, out[0].t.clone()))
        pm, pop = arg["pm"], arg["pop_params"]
        dispatches.append({
            "boundaries": int(arg["n_boundaries"]),
            "launches": {e: n - before[e] for e, n in
                         _cuda.launch_counts.items() if n != before[e]},
            "shapes": {"P": int(pm.node_map.shape[0]),
                       "NC": int(pm.node_map.shape[1]),
                       "MC": int(pm.mut_map.shape[1]),
                       "C": int(arg["num_cells"]),
                       "N": int(ts.num_nodes),
                       "n_inner": int(ts.num_nodes) // 2,
                       "n_blocks": int(arg["n_blocks"]),
                       "fsize": ts.t.element_size(),
                       "knots": int(pop.x.shape[0]) if hasattr(pop, "x")
                       else 0}})
        return out

    def burst(n_moves):
        with record_function("bench.topology_burst"):
            return orig_burst(n_moves)

    def calls():
        for _ in range(traffic["trace_calls"]):
            run.do_mcmc_steps(steps)
        sync(device)

    run_mod.parts_multi_super_step = dispatch
    run._topology_burst = burst
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    try:
        if trace:
            with profile(activities=acts) as prof:
                with record_function("bench.slice"):
                    calls()
        else:
            calls()
    finally:
        run_mod.parts_multi_super_step = orig_dispatch
        del run._topology_burst
    unmoved = [unmoved_inner(parent, t0, t1) for parent, t0, t1 in kept]
    log(f"inner nodes unmoved by each judged dispatch: {unmoved}")
    if not trace:
        return {"unmoved": unmoved}
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    got = tr.read_chrome_trace(prof, path)
    del prof
    spans = got["spans"]
    lo, hi = next((s, e) for n, s, e in spans if n == "bench.slice")
    dev = [(n, s, d) for n, s, d in got["device"] if s < hi and s + d > lo]
    busy = tr.merged((max(s, lo), min(s + d, hi)) for _, s, d in dev)
    busy_us = sum(e - s for s, e in busy)
    return {"unmoved": unmoved, "device": dev, "spans": spans,
            "slice": (lo, hi),
            "window_s": (hi - lo) * 1e-6, "busy_s": busy_us * 1e-6,
            "dispatches": dispatches, "calls": traffic["trace_calls"],
            "breakdown": slice_breakdown(dev, spans, busy, lo, hi)}


def unmoved_inner(parent, t0, t1) -> int:
    """Inner nodes (those that some node names as its parent) whose time
    is bit for bit the same in ``t0`` and ``t1``."""
    parent = parent.cpu().numpy()
    inner = np.unique(parent[parent >= 0])
    same = t0.cpu().numpy()[inner] == t1.cpu().numpy()[inner]
    return int(np.count_nonzero(same))


def slice_breakdown(dev, spans, busy, lo, hi) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the benchmark's span under their midpoint."""
    by_name = {}
    for n, _s, d in dev:
        by_name[n] = by_name.get(n, 0.0) + d * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    named = [(n, s, e) for n, s, e in spans
             if n in ("bench.dispatch", "bench.topology_burst")]
    gaps = []
    for s, e in tr.idle_gaps(busy, lo, hi):
        mid = 0.5 * (s + e)
        host = next((n for n, a, b in named if a <= mid <= b), "bench.other")
        gaps.append([host, (e - s) * 1e-6])
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n[:160], v] for n, v in ops],
            "idle_gaps": gaps[:10]}


def report(res: dict) -> None:
    """The compared numbers as the last lines on standard error, then the
    result as the last line on standard output ("checks" last in it)."""
    for k, c in res["checks"].items():
        print(f"check {k} = {float(c['value'])!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    line = {k: v for k, v in res.items() if not k.startswith("_")}
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="run in float32, the precision below the "
                         "configuration's (the comparison must fail it)")
    args = ap.parse_args(argv)
    isolate_environment()
    spec = load_spec(ROOT, args.workload)
    import torch
    need = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"no result: the cell needs {need} CUDA device(s), "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    res = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                   control=args.control)
    bad = loaded_forbidden()
    if bad:
        print(f"no result: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    log(f"window: {json.dumps(res['_window'])}")
    report(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
