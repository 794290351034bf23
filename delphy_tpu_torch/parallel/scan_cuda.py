"""Prefix sums in an order fixed by the index alone, one CUDA kernel each
for CUDA tensors and their plain versions (``torch.cumsum``, the CPU's
sequential order) for CPU tensors:

- ``prefix_scan``: the inclusive prefix sum of a 1-D tensor
  (``csrc/prefix_scan.cu``);
- ``ref_state_prefix``: the reference-state prefix tables, per key (a
  site's reference state, or partition * 4 + state) the count of the
  sites before each column and the sum of their nu
  (``csrc/ref_state_prefix.cu``).

The kernels' order is not the sequential one, so on the card a float sum
differs from ``torch.cumsum`` in the last bits (sums of integers do not);
it is the same in every launch and under a CUDA graph.  Float64 or float32
(the kernels' ``_f32`` builds); the results have the input's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


# the reference-state kernel's tile and largest chunk
# (csrc/ref_state_prefix.cu): an output's additions nest at most
# REF_CHUNK + 12 + (its site // REF_TILE) deep; it takes 4 keys (one
# partition) with or without the counts, or 8 (two) without; its workspace
# holds REF_WS values a tile
REF_TILE = 2048
REF_CHUNK = 32
REF_WS = 8 * 8


def ref_state_prefix_torch(ref_seq, nu, part=None, num_parts: int = 1,
                           counts: bool = True):
    """The plain version: the one-hot of each site's key (``ref_seq``, or
    ``part * 4 + ref_seq``) over 4 * num_parts keys, its rows scanned by
    torch.cumsum after a zero column: (cnt, nucum), each [K, L + 1] in
    ``nu``'s dtype; cnt None unless ``counts``."""
    keys = ref_seq.long()
    if part is not None:
        keys = part.long() * 4 + keys
    onehot = F.one_hot(keys, 4 * num_parts).to(nu.dtype).T
    zeros = torch.zeros((onehot.shape[0], 1), dtype=onehot.dtype,
                        device=onehot.device)
    cnt = torch.cat([zeros, torch.cumsum(onehot, 1)], 1) if counts else None
    nucum = torch.cat([zeros, torch.cumsum(onehot * nu[None, :], 1)], 1)
    return cnt, nucum


def pack_ref_launch(ref_seq, nu, part=None, num_parts: int = 1,
                    counts: bool = True) -> _cuda.Packed:
    """Check and pack the arguments of ``delphy_ref_state_prefix`` (or its
    ``_f32`` build): ``nu`` a contiguous 1-D float64 or float32 CUDA
    tensor of L sites, ``ref_seq`` and ``part`` (None: keys 0..3)
    contiguous int32 of L on its device, one partition or two without the
    counts; outs is (cnt or None, nucum), new [4 * num_parts, L + 1]
    tensors of nu's dtype, scratch the tile totals' workspace."""
    _cuda.suffix(nu.dtype)
    _cuda.require(nu, "nu", nu.dtype, (None,))
    n = nu.shape[0]
    if n >= 2 ** 31 - 1:
        raise ValueError(f"nu: {n} sites, at most 2**31 - 2")
    _cuda.require(ref_seq, "ref_seq", torch.int32, (n,), nu.device)
    if num_parts not in (1, 2) or (num_parts == 2 and counts):
        raise ValueError(f"{num_parts} partitions with counts={counts}: the "
                         f"kernel takes one partition, or two without the "
                         f"counts")
    if part is not None:
        _cuda.require(part, "part", torch.int32, (n,), nu.device)
    k = 4 * num_parts

    def table():
        return torch.empty((k, n + 1), dtype=nu.dtype, device=nu.device)

    cnt = table() if counts else None
    nucum = table()
    n_tiles = -(-n // REF_TILE)
    ws = torch.empty((max(1, REF_WS * n_tiles),), dtype=nu.dtype,
                     device=nu.device)
    args = (_cuda.ptr(ref_seq), None if part is None else _cuda.ptr(part),
            _cuda.ptr(nu), None if cnt is None else _cuda.ptr(cnt),
            _cuda.ptr(nucum), _cuda.ptr(ws), n, k,
            _cuda.stream_ptr(nu.device))
    keep = (ref_seq, nu) + (() if part is None else (part,))
    return _cuda.Packed(args, (cnt, nucum), keep, (ws,))


def ref_state_prefix(ref_seq, nu, part=None, num_parts: int = 1,
                     counts: bool = True):
    """(cnt, nucum): per key k (``ref_seq``, or ``part * 4 + ref_seq`` over
    num_parts partitions), cnt[k, c] the number of sites l < c with that
    key and nucum[k, c] the sum of their nu; [4 * num_parts, L + 1] in
    ``nu``'s dtype, cnt None unless ``counts``.  On ``nu``'s device: the
    kernel for CUDA tensors (one launch on the current stream, no
    synchronisation), the plain version for CPU tensors."""
    if nu.device.type == "cpu":
        return ref_state_prefix_torch(ref_seq, nu, part, num_parts, counts)
    pk = pack_ref_launch(ref_seq, nu, part, num_parts, counts)
    name = "ref_state_prefix" + _cuda.suffix(nu.dtype)
    _cuda.check(getattr(_cuda.lib(), "delphy_" + name)(*pk.args), name)
    _cuda.count_launch(name)
    return pk.outs
