"""delphy_tpu_torch — the EMAT engine of ``delphy_tpu`` on PyTorch and CUDA.

A port of the JAX package's device layer to PyTorch, with its three Pallas
TPU kernels rewritten as hand-written CUDA kernels for Hopper (``csrc/``).
Module names mirror ``delphy_tpu`` so each counterpart is easy to find.  The
host layer (tree construction, MAPLE I/O, partition maps, native topology
bursts) is reused from ``delphy_tpu`` by import, without jax
(see ``_host.py``).

Policy: every float is float64 (the H100 has native f64, so the reference's
ledger tolerance of 1e-6 holds), randomness comes from an explicit
``torch.Generator`` on the run's device, and a CUDA device is used only when
asked for, never silently swapped for the CPU.
"""

from __future__ import annotations

from . import _host  # noqa: F401  (must run before any delphy_tpu import)

import torch

DTYPE = torch.float64
ITYPE = torch.int32


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available")
    return dev
