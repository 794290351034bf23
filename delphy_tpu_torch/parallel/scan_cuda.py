"""Inclusive prefix sum of a 1-D tensor in an order fixed by the index
alone: one CUDA kernel (``csrc/prefix_scan.cu``) for CUDA tensors, and
``torch.cumsum`` for CPU tensors (its plain version, the CPU's sequential
order).

The kernel's order is not the sequential one, so on the card the result
differs from ``torch.cumsum`` in the last bits; it is the same in every
launch and under a CUDA graph.  Float64 or float32 (the kernel's ``_f32``
build); the result has the input's dtype.
"""

from __future__ import annotations

import torch

from . import _cuda

# the kernel's block and tile (csrc/prefix_scan.cu): an output's additions
# nest at most ITEMS + 12 + (its index // TILE) deep
THREADS = 1024
TILE_BYTES = 32 * 1024


def items(dtype) -> int:
    """Elements a thread adds in order in each tile."""
    return TILE_BYTES // (THREADS * torch.finfo(dtype).bits // 8)


def prefix_scan_torch(x):
    """The plain version: torch.cumsum(x, 0)."""
    return torch.cumsum(x, 0)


def pack_launch(x) -> _cuda.Packed:
    """Check and pack ``x`` (a contiguous 1-D float64 or float32 CUDA
    tensor) for ``delphy_prefix_scan`` or ``delphy_prefix_scan_f32``; outs
    is (y,), a new tensor of x's shape and dtype."""
    _cuda.suffix(x.dtype)
    _cuda.require(x, "x", x.dtype, (None,))
    n = x.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"x: {n} elements, at most 2**31 - 1")
    y = torch.empty((n,), dtype=x.dtype, device=x.device)
    args = (_cuda.ptr(x), _cuda.ptr(y), n, _cuda.stream_ptr(x.device))
    return _cuda.Packed(args, (y,), (x,))


def prefix_scan(x):
    """y[i] = x[0] + ... + x[i] on ``x``'s device: the kernel for a CUDA
    tensor (launched on the current stream, no synchronisation), the plain
    version for a CPU tensor."""
    if x.device.type == "cpu":
        return prefix_scan_torch(x)
    pk = pack_launch(x)
    name = "prefix_scan" + _cuda.suffix(x.dtype)
    _cuda.check(getattr(_cuda.lib(), "delphy_" + name)(*pk.args), name)
    _cuda.count_launch(name)
    return pk.outs[0]
