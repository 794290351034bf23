"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

The sources are compiled on first use with ``nvcc`` (one process per
source, in parallel) and linked into one shared library with a plain C
interface (``-gencode arch=compute_90a,code=sm_90a``), cached
in ``delphy_tpu_torch/_build/`` under a hash of the sources and flags, and
loaded with ctypes.  Each C entry point launches on the stream it is given
and returns ``cudaGetLastError()``; ``check`` raises on a non-zero code.
Nothing here is touched when a module is imported, so the CPU tests never
need ``nvcc``.

Every kernel has a float64 build (C entry ``delphy_<name>``) and a float32
build (``delphy_<name>_f32``), the same templated source (``csrc/real.cuh``);
a wrapper picks the build by the dtype of its tensors (``suffix``) and
never casts one precision to the other.

``launch_counts`` holds one plain integer per C entry (without ``delphy_``:
``sweep_chain``, ``sweep_chain_f32``, ...); each wrapper adds one
(``count_launch``) where it launches its kernel and nowhere else.  The counts
are per process, over every run and thread: the engine server steps runs on
worker threads, so the increment takes a lock.  ``launch_blocks`` sums the
thread blocks (parts, for the sweep) of those launches, so a run can show
which share of its parts a dispatch swept.

Under a CUDA graph (``dispatch_graph.py``) a wrapper runs once, at the
capture, and launches nothing then: inside ``recording()`` its count goes
to the capture's record instead, and each replay of the graph adds that
record (``tally``), so the counts mean launches on the card either way.
``graph_replays`` counts the replays.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import NamedTuple

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("hky_chain.cu", "exp_pop_chain.cu", "sweep_chain.cu")
# headers the sources include (hashed with them)
HEADERS = ("real.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_KERNELS = ("hky_chain", "exp_pop_chain", "sweep_chain",
            "sweep_chain_skygrid", "sweep_chain_global",
            "sweep_chain_skygrid_global")
launch_counts = dict.fromkeys(
    list(_KERNELS) + [k + "_f32" for k in _KERNELS], 0)
launch_blocks = dict.fromkeys(launch_counts, 0)
graph_replays = 0

_LIB = None
_LOCK = threading.Lock()          # building and loading the library
_COUNT_LOCK = threading.Lock()    # launch_counts
_RECORD = threading.local()       # the capture under way in this thread
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SWEEP = [_I, _I, _I, _I, _I, _I, _I,
          _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
          _P, _P, _P, _P, _P, _P, _P, _P, _P,
          _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
          _P, _P, _P, _P]
# the float32 builds take the same arguments (pointers to float; the
# double scalars are rounded to float inside)
_ARGTYPES = {
    "delphy_hky_chain": [_P, _I, _I, _P, _P, _P, _P, _P, _D, _D,
                         _P, _P, _P, _P],
    "delphy_exp_pop_chain": [_P, _I, _I, _P, _P, _I, _P, _P, _I, _P,
                             _D, _D, _D, _D, _D, _D, _I, _I, _P, _P],
    "delphy_sweep_chain": _SWEEP + [_P],
    "delphy_sweep_chain_skygrid": _SWEEP + [_I, _I, _P, _P, _P],
    "delphy_sweep_chain_global": _SWEEP + [_P, _P],
    "delphy_sweep_chain_skygrid_global": _SWEEP + [_I, _I, _P, _P, _P, _P],
}
_ARGTYPES.update({k + "_f32": v for k, v in _ARGTYPES.items()})
# the shape queries: (argument count, result type)
_QUERIES = {
    "delphy_sweep_chain_smem_bytes": (4, ctypes.c_ulonglong),
    "delphy_sweep_chain_skygrid_smem_bytes": (5, ctypes.c_ulonglong),
    "delphy_exp_pop_chain_nodes_shared": (3, ctypes.c_int),
    "delphy_sweep_chain_stages": (5, ctypes.c_int),
    "delphy_sweep_chain_workspace_bytes": (5, ctypes.c_ulonglong),
}
_QUERIES.update({k + "_f32": v for k, v in _QUERIES.items()})
# entry points a library may lack: another tree's kernel sources, built for
# a kernel-only A/B, predate them
_OPTIONAL = tuple(k for k in list(_ARGTYPES) + list(_QUERIES)
                  if k not in ("delphy_hky_chain", "delphy_exp_pop_chain",
                               "delphy_sweep_chain",
                               "delphy_sweep_chain_smem_bytes"))


class Packed(NamedTuple):
    """A C entry point's arguments, checked and packed by a wrapper: ``args``
    (ints, floats and device pointers), the output tensors ``outs``,
    ``keep``, the packed input tensors the pointers refer to, and
    ``scratch``, the kernel's workspace (neither input nor output)."""
    args: tuple
    outs: tuple
    keep: tuple
    scratch: tuple = ()


def reset_launch_counts() -> None:
    global graph_replays
    with _COUNT_LOCK:
        for k in launch_counts:
            launch_counts[k] = 0
            launch_blocks[k] = 0
        graph_replays = 0


def suffix(dtype) -> str:
    """The C entry suffix of a kernel's build for ``dtype``: "" (float64)
    or "_f32" (float32)."""
    if dtype == torch.float64:
        return ""
    if dtype == torch.float32:
        return "_f32"
    raise ValueError(f"no kernel build for {dtype}")


def count_launch(name: str, blocks: int = 1) -> None:
    record = getattr(_RECORD, "launches", None)
    if record is not None:
        record.append((name, blocks))
        return
    with _COUNT_LOCK:
        launch_counts[name] += 1
        launch_blocks[name] += blocks


@contextlib.contextmanager
def recording():
    """Within the block, this thread's ``count_launch`` calls append
    (name, blocks) to the list it yields instead of counting: a graph's
    capture, whose launches happen at its replays."""
    prev = getattr(_RECORD, "launches", None)
    _RECORD.launches = record = []
    try:
        yield record
    finally:
        _RECORD.launches = prev


def tally(record, replays: int = 1) -> None:
    """Count ``replays`` replays of a graph whose capture recorded
    ``record``: each of its launches, that many times."""
    global graph_replays
    with _COUNT_LOCK:
        for name, blocks in record:
            launch_counts[name] += replays
            launch_blocks[name] += replays * blocks
        graph_replays += replays


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(verbose: bool = False, csrc_dir: str = CSRC_DIR,
          sources=SOURCES) -> str:
    """Compile the CUDA sources into a cached shared library; returns its
    path.  One nvcc per source, all started together, then one link.
    verbose=True adds ``-Xptxas -v`` and prints the compiler's report.
    ``csrc_dir`` and ``sources`` let chip_smoke.py build another tree's
    kernels, or the empty kernel of ``launch_floor.cu``, into a library of
    their own."""
    flags = list(NVCC_FLAGS)
    h = hashlib.sha256(" ".join(flags).encode())
    for name in tuple(sources) + HEADERS:
        path = os.path.join(csrc_dir, name)
        if name in HEADERS and not os.path.exists(path):
            continue   # another tree's sources, from before the header
        with open(path, "rb") as f:
            h.update(f.read())
    tag = h.hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libdelphy_kernels_{tag}.so")
    if os.path.exists(so) and not verbose:
        return so
    obj_dir = os.path.join(BUILD_DIR, f"obj_{tag}_{os.getpid()}")
    os.makedirs(obj_dir, exist_ok=True)
    nvcc = _nvcc()
    objs, procs = [], []
    for name in sources:
        obj = os.path.join(obj_dir, name + ".o")
        objs.append(obj)
        procs.append((name, subprocess.Popen(
            [nvcc, *flags, *(["-Xptxas", "-v"] if verbose else []), "-c",
             os.path.join(csrc_dir, name), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    report = []
    for name, proc in procs:
        out, _ = proc.communicate()
        report.append(out)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} "
                               f"({proc.returncode}):\n{out}")
    tmp = f"{so}.tmp{os.getpid()}"
    res = subprocess.run([nvcc, *LINK_FLAGS, "-o", tmp, *objs],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    if verbose:
        print("".join(report), flush=True)
    os.replace(tmp, so)
    shutil.rmtree(obj_dir, ignore_errors=True)
    return so


def load(path: str):
    """ctypes handle of a built library with the entry points' signatures."""
    handle = ctypes.CDLL(path)
    for name, argtypes in _ARGTYPES.items():
        if name in _OPTIONAL and not hasattr(handle, name):
            continue
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    handle.delphy_cuda_error_string.argtypes = [ctypes.c_int]
    handle.delphy_cuda_error_string.restype = ctypes.c_char_p
    for name, (n_args, restype) in _QUERIES.items():
        if name in _OPTIONAL and not hasattr(handle, name):
            continue
        fn = getattr(handle, name)
        fn.argtypes = [_I] * n_args
        fn.restype = restype
    return handle


def lib():
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                _LIB = load(build())
    return _LIB


def check(code: int, what: str) -> None:
    if code != 0:
        msg = lib().delphy_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr(device=None) -> int:
    """The calling thread's current stream on ``device`` (None: the thread's
    current device).  A thread that has made no stream current gets the
    device's default stream."""
    return torch.cuda.current_stream(device).cuda_stream


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
