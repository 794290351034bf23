"""Tiny cells for the benchmark's CPU tests: a cell's traffic and limits on
a small simulated dataset, calls of a few boundaries, on the CPU."""

from __future__ import annotations

from benchmarks import run as br

TINY_DATA = {"kind": "simulated", "num_tips": 30, "num_sites": 600,
             "mu": 2e-3, "sample_window_days": 180.0,
             "missing_fraction": 0.05, "seed": 11}


# inner nodes a dispatch leaves unmoved at this size (P = 3 parts): 2 in
# sound runs, 17-20 with half of the parts unswept, 29 with none swept
TINY_NODES_UNMOVED = 7


def tiny_spec(cell: str, root: str = br.ROOT, boundaries: int = 4) -> dict:
    """The cell's spec on the tiny dataset, its limits but the one on
    ``nodes_unmoved``, which follows the number of parts."""
    spec = br.load_spec(root, cell)
    spec["config"] = dict(spec["config"], name="tiny-sim-30x600",
                          dataset=TINY_DATA)
    spec["limits"] = dict(spec["limits"], nodes_unmoved=TINY_NODES_UNMOVED)
    spec["traffic"] = dict(spec["traffic"], call_boundaries=boundaries)
    return spec


def tiny_run(cell: str, seed: int = 2 ** 31 + 7, trace: bool = False,
             control: bool = False, root: str = br.ROOT,
             seconds: float = 0.5) -> dict:
    br.isolate_environment()
    return br.run_cell(tiny_spec(cell, root), seed, seconds, trace,
                       device="cpu", control=control)
