"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

The sources are compiled on first use with ``nvcc`` into one shared library
with a plain C interface (``-gencode arch=compute_90a,code=sm_90a``), cached
in ``delphy_tpu_torch/_build/`` under a hash of the sources and flags, and
loaded with ctypes.  Each C entry point launches on the stream it is given
and returns ``cudaGetLastError()``; ``check`` raises on a non-zero code.
Nothing here is touched when a module is imported, so the CPU tests never
need ``nvcc``.

``launch_counts`` holds one plain integer per kernel; each wrapper adds one
where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("hky_chain.cu", "exp_pop_chain.cu", "sweep_chain.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

launch_counts = {"hky_chain": 0, "exp_pop_chain": 0, "sweep_chain": 0}

_LIB = None
_LOCK = threading.Lock()
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_ARGTYPES = {
    "delphy_hky_chain": [_P, _I, _I, _P, _P, _P, _P, _P, _D, _D,
                         _P, _P, _P, _P],
    "delphy_exp_pop_chain": [_P, _I, _I, _P, _P, _I, _P, _P, _I, _P,
                             _D, _D, _D, _D, _D, _D, _I, _I, _P, _P],
    "delphy_sweep_chain": [_I, _I, _I, _I, _I, _I, _I,
                           _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                           _P, _P, _P, _P, _P],
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into the cached shared library; returns its path.
    verbose=True adds ``-Xptxas -v`` and prints the compiler's report."""
    flags = list(NVCC_FLAGS) + (["-Xptxas", "-v"] if verbose else [])
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"libdelphy_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(so) and not verbose:
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = [_nvcc(), *flags, "-o", tmp,
           *[os.path.join(CSRC_DIR, s) for s in SOURCES]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    if verbose:
        print(res.stdout + res.stderr, flush=True)
    os.replace(tmp, so)
    return so


def lib():
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                handle = ctypes.CDLL(build())
                for name, argtypes in _ARGTYPES.items():
                    fn = getattr(handle, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                handle.delphy_cuda_error_string.argtypes = [ctypes.c_int]
                handle.delphy_cuda_error_string.restype = ctypes.c_char_p
                handle.delphy_sweep_chain_smem_bytes.argtypes = [_I] * 4
                handle.delphy_sweep_chain_smem_bytes.restype = \
                    ctypes.c_ulonglong
                _LIB = handle
    return _LIB


def check(code: int, what: str) -> None:
    if code != 0:
        msg = lib().delphy_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def require(t: torch.Tensor, name: str, dtype, shape=None,
            device: torch.device | None = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given dtype,
    shape (None entries are free) and device."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None:
        if t.dim() != len(shape) or any(
                s is not None and s != d for s, d in zip(shape, t.shape)):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                             f"expected {shape}")
