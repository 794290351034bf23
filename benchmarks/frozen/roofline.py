"""Peaks of one NVIDIA H100 and the bytes and operations of each launch of
the port's three CUDA kernels, counted from the launch's shapes.

Peaks are NVIDIA's published figures for the SXM part at its full power
limit (700 W): 3.35 TB/s of HBM3, 34 TFLOP/s of FP64 and 67 TFLOP/s of
FP32 outside the tensor cores.  A launch's bound is the larger of its bytes
over the HBM rate and its operations over the FP rate of its precision.

Bytes count each input byte read once and each output byte written once, as
the kernels' C interfaces lay them out (``delphy_tpu_torch/parallel/
{block,pop,hky}_cuda.py`` ``pack_launch``): at the main path's Ebola shapes
(P=8, NC=64, MC=80, C=400, 24 blocks) the sweep reads and writes 664,184
bytes, the exp_pop chain 10,004 and the hky chain 888.  Operations follow
the counts the port's kernel table uses, with a transcendental function
counted as 20; where they depend on the data, the count is what the run's
prior needs (every n0 and g proposal evaluated, as under the default
unbounded g prior): 1,147,260 for the Ebola exp_pop chain.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP_OPS_PER_S = {8: 34e12, 4: 67e12}     # by the float's size in bytes
TRANSCENDENTAL = 20
SC_LANES = 6          # the sweep's single-move uniforms per block
HKY_LANES = 6
HKY_ROUNDS = 10
POP_LANES = 4
POP_ROUNDS = 50


def sweep_bytes(P: int, NC: int, MC: int, C: int, n_blocks: int, fsize: int,
                knots: int = 0) -> int:
    """One sweep launch over P parts of NC node and MC mutation slots, C
    grid cells and n_blocks blocks; ``knots`` the skygrid's (x and gamma
    are read)."""
    ints = P * (3 * NC + 3 * MC) * 4 + P * 4 * 4
    rows = P * (5 * NC + 2 * MC + 2 * C) * fsize
    scalars = 7 * fsize + 2 * C * fsize + 2 * knots * fsize
    uniforms = P * n_blocks * (4 * NC + MC + SC_LANES + 1) * fsize
    outs = (P * (NC + MC + C) + 3 * P) * fsize
    return ints + rows + scalars + uniforms + outs


def sweep_ops(P: int, NC: int, MC: int, n_blocks: int) -> int:
    return n_blocks * P * (300 + 30 * NC + 8 * MC)


def exp_pop_bytes(C: int, N: int, fsize: int) -> int:
    return ((POP_ROUNDS * POP_LANES + 2 * C + N + 5 + 4) * fsize + N * 4)


def exp_pop_ops(C: int, n_inner: int) -> int:
    X = TRANSCENDENTAL
    full = (1 + POP_ROUNDS) * (C * (2 * X + 15) + 4 * n_inner + 2 * X)
    return full + POP_ROUNDS * (4 * X + 26) + POP_ROUNDS * (X + 12)


def hky_bytes(fsize: int) -> int:
    return (HKY_ROUNDS * HKY_LANES + 2 + 12 + 16 + 1 + 4 + 16) * fsize


def hky_ops() -> int:
    return HKY_ROUNDS * (7 * TRANSCENDENTAL + 60) + 60


def bound_s(n_bytes: float, ops: float, fsize: int) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, ops / FP_OPS_PER_S[fsize])


def launch_bound_s(kernel: str, shapes: dict) -> float:
    """Bound of one launch of ``kernel`` (``sweep``, ``exp_pop`` or
    ``hky``) at a dispatch's ``shapes`` (P, NC, MC, C, N, n_inner,
    n_blocks, fsize, knots)."""
    s, f = shapes, shapes["fsize"]
    if kernel == "sweep":
        return bound_s(sweep_bytes(s["P"], s["NC"], s["MC"], s["C"],
                                   s["n_blocks"], f, s.get("knots", 0)),
                       sweep_ops(s["P"], s["NC"], s["MC"], s["n_blocks"]), f)
    if kernel == "exp_pop":
        return bound_s(exp_pop_bytes(s["C"], s["N"], f),
                       exp_pop_ops(s["C"], s["n_inner"]), f)
    if kernel == "hky":
        return bound_s(hky_bytes(f), hky_ops(), f)
    raise ValueError(f"no counts for kernel {kernel!r}")
