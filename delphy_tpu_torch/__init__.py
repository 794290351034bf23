"""delphy_tpu_torch — the EMAT engine of ``delphy_tpu`` on PyTorch and CUDA.

A port of the JAX package's device layer to PyTorch, with its three Pallas
TPU kernels rewritten as hand-written CUDA kernels for Hopper (``csrc/``).
Module names mirror ``delphy_tpu`` so each counterpart is easy to find.  The
host layer (tree construction, MAPLE I/O, partition maps, the topology
bursts on the native kernel or on the Python ``TopologyMixer`` without it:
``phylo``, ``seq``, ``dates``, ``init_tree``, ``io/``, ``parallel/partmaps``,
``topo/``, ``native/``) is the port's own copy of the reference package's
numpy and ctypes modules, so the port imports nothing of ``delphy_tpu``.
``ops/{runset,history,spr_study,spr_move}`` are the JAX package's device SPR
for missation-free trees as PyTorch on tensors (a counterpart for tests and
measurement: ``Run`` does not use it, as the JAX ``Run`` does not).

Policy: a run's floats are float64 by default, and float32 where the
``DELPHY_TPU_F32`` environment variable is set and non-empty, the JAX
package's switch (``delphy_tpu/__init__.py``) and its production TPU
configuration (``bench.py`` sets it).  The variable is read where a run is
made (``Run(dtype=None)`` resolves it through ``resolve_dtype``), and an
explicit ``dtype=torch.float32`` or ``torch.float64`` overrides it, so one
process can hold runs of both precisions.  Every other function takes its
float dtype from its input tensors; integers are int32 (``ITYPE``).  In
float64 the reference's ledger tolerance of 1e-6 holds; in float32 the
JAX package's: 0.05 at Ebola scale (|log_G| ~ 4.5e4, ``bench.py``), scaled
by |log_G| / 4.5e4 for other sizes (``tests/test_f32.py``).  Each CUDA
kernel has a float32 build of its own (C entries ``*_f32``).  The CLI and
the engine server choose float32 through the variable
(``DELPHY_TPU_F32=1 python -m delphy_tpu_torch.cli ...``); on the CPU,
``tests/test_torch_f32.py`` holds the float32 engine to the JAX package's,
and on the card ``python3 chip_smoke.py`` runs it in its phase 12 (which
sets the variable itself, as ``bench.py`` does).

Randomness comes from an explicit ``torch.Generator`` on the run's device,
and the entry points run on the CUDA device unless the caller asks for the
CPU; without CUDA they raise rather than fall back.
"""

from __future__ import annotations

import os

import numpy as np
import torch

ITYPE = torch.int32
# device of the entry points when the caller names none
DEFAULT_DEVICE = "cuda"
# the JAX package's precision switch
F32_ENV = "DELPHY_TPU_F32"
FLOAT_DTYPES = (torch.float32, torch.float64)


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; raises when CUDA is asked for and
    absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available")
    return dev


def resolve_dtype(dtype=None) -> torch.dtype:
    """A run's float dtype: ``dtype`` where given (torch.float32 or
    torch.float64), else float32 where ``DELPHY_TPU_F32`` is set and
    non-empty (the JAX package's test) and float64 otherwise."""
    if dtype is None:
        return torch.float32 if os.environ.get(F32_ENV) else torch.float64
    if dtype not in FLOAT_DTYPES:
        raise ValueError(f"dtype {dtype}: a run is float32 or float64")
    return dtype


def float_dtype(*xs) -> torch.dtype:
    """The float dtype of the first float32 or float64 tensor or numpy
    array among ``xs`` (a Python number takes the dtype of the arrays it
    meets, as a weakly typed JAX scalar does); ``resolve_dtype()`` where
    there is none."""
    for x in xs:
        if isinstance(x, torch.Tensor) and x.dtype in FLOAT_DTYPES:
            return x.dtype
        if isinstance(x, np.ndarray) and x.dtype in (np.float32, np.float64):
            return torch.float32 if x.dtype == np.float32 else torch.float64
    return resolve_dtype()
