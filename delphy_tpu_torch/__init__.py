"""delphy_tpu_torch — the EMAT engine of ``delphy_tpu`` on PyTorch and CUDA.

A port of the JAX package's device layer to PyTorch, with its three Pallas
TPU kernels rewritten as hand-written CUDA kernels for Hopper (``csrc/``).
Module names mirror ``delphy_tpu`` so each counterpart is easy to find.  The
host layer (tree construction, MAPLE I/O, partition maps, native topology
bursts: ``phylo``, ``seq``, ``dates``, ``init_tree``, ``io/``,
``parallel/partmaps``, ``topo/``, ``native/``) is the port's own copy of the
reference package's numpy and ctypes modules, so the port imports nothing of
``delphy_tpu``.

Policy: every float is float64 (the H100 has native f64, so the reference's
ledger tolerance of 1e-6 holds), randomness comes from an explicit
``torch.Generator`` on the run's device, and the entry points run on the CUDA
device unless the caller asks for the CPU; without CUDA they raise rather
than fall back.
"""

from __future__ import annotations

import torch

DTYPE = torch.float64
ITYPE = torch.int32
# device of the entry points when the caller names none
DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available")
    return dev
