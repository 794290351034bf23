"""Tiny cells for the benchmark's CPU tests: a cell's traffic and limits on
a small simulated dataset, calls of a few boundaries, on the CPU.  The cell
``MPOX`` is ``ebola81-exp``'s traffic and limits with the mpox model on,
on a small APOBEC3-shaped dataset."""

from __future__ import annotations

from benchmarks import run as br

TINY_DATA = {"kind": "simulated", "num_tips": 30, "num_sites": 600,
             "mu": 2e-3, "sample_window_days": 180.0,
             "missing_fraction": 0.05, "seed": 11}

# about 19 differences a tip from the root, 89% of them C->T or G->A in an
# APOBEC3 context
TINY_MPOX_DATA = {"kind": "simulated_apobec", "num_tips": 30,
                  "num_sites": 600, "mu": 1e-5, "rho": 40.0,
                  "pi": [0.33, 0.17, 0.17, 0.33], "sample_window_days": 180.0,
                  "coalescent_n0": 200.0, "missing_fraction": 0.05,
                  "seed": 11}
MPOX = "tiny-mpox"


# inner nodes a dispatch leaves unmoved at this size (P = 3 parts): 2 in
# sound runs, 17-20 with half of the parts unswept, 29 with none swept
TINY_NODES_UNMOVED = 7


def tiny_spec(cell: str, root: str = br.ROOT, boundaries: int = 4) -> dict:
    """The cell's spec on the tiny dataset, its limits but the one on
    ``nodes_unmoved``, which follows the number of parts."""
    mpox = cell == MPOX
    spec = br.load_spec(root, "ebola81-exp" if mpox else cell)
    spec["config"] = dict(spec["config"], name="tiny-sim-30x600",
                          dataset=TINY_MPOX_DATA if mpox else TINY_DATA)
    spec["limits"] = dict(spec["limits"], nodes_unmoved=TINY_NODES_UNMOVED)
    spec["traffic"] = dict(spec["traffic"], call_boundaries=boundaries)
    if mpox:
        spec["traffic"]["run"] = dict(spec["traffic"]["run"], mpox_hack=True)
    return spec


def tiny_run(cell: str, seed: int = 2 ** 31 + 7, trace: bool = False,
             control: bool = False, root: str = br.ROOT,
             seconds: float = 0.5) -> dict:
    br.isolate_environment()
    return br.run_cell(tiny_spec(cell, root), seed, seconds, trace,
                       device="cpu", control=control)
