"""Host spans and device sections: where a run's host time and a
boundary's device work go, for a traced run (``torch.profiler``) and for
the launch counts (``parallel/_cuda.py``).

``span(name)`` marks a stretch of host code.  Under an active profiler it
is a ``record_function`` range: a ``user_annotation`` event in the
profiler's trace, on the clock of its device events.  With no profiler it
is one shared no-op context: a flag is read and no ``RecordFunction`` is
made.  The spans (``run.py``, ``parallel/dispatch_graph.py``,
``parallel/sweep.py``):

- ``delphy.dispatch``: the blocking driver's enqueue of one dispatch
  (``parts_multi_super_step``), with ``.copy_in``, ``.capture`` (warm-up
  and capture, where one happens), ``.replay`` (the replays and their
  generator prologues) and ``.hand_off`` (the clone-out, then the host
  bundle ``fuse_for_host``: two ranges) inside it on the graph path;
- ``delphy.wait``: the blocking driver's one wait for the card a dispatch
  (``Run._absorb``'s read of the move count);
- ``delphy.burst``: a topology burst, with ``.fetch`` (the state to the
  host), ``.unpack`` (the host tree and parameters), ``.moves`` (the
  burst and the coalescent refresh), ``.chains`` (the same-site chain
  redraw and the re-reference) and ``.adopt`` (repack and repartition);
- ``delphy.repartition``: ``Run._repartition``, wherever it runs.

The overlapped driver's stages have no spans: ``Run.last_cycle`` times
them.

``section(name)`` marks where a section of a boundary's device work
starts; ``SECTIONS`` lists them in the order a boundary runs them
(``mcmc/kernel.py`` ``run_global_moves``, ``parallel/sweep.py``
``_boundary_body``).  It counts only inside ``counting``, which a CUDA
graph's capture enters (``dispatch_graph._Graph``): there it reads how
many device nodes (kernels, memcpys and memsets: what the profiler lists
as device events) the graph under capture holds so far, through the CUDA
driver, and the section before it gets the nodes added since its own
mark.  The capture's record keeps them, and each replay adds them to
``_cuda.launch_counts["ops.<section>"]``.  Anywhere else (a replay,
which runs no Python; the eager loop; the CPU) it does nothing, so it
costs the replay path nothing and puts nothing into a graph.

``subcount(name)`` is a block inside a section whose device nodes are
counted on their own, under ``SUBCOUNTS``: the mpox model's partitioned
statistics (``mpox.stats``) and its (mu, rho) rounds (``mpox.rounds``),
both inside ``global.evo_moves``.  Like ``section`` it counts only inside
``counting``, into the capture record's ``subcounts``, which each replay
adds to ``_cuda.launch_counts["ops.<subcount>"]``.  It leaves the
sections as they are: their counts still partition the graph's nodes,
and a subcount's nodes are counted in its section as well.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import torch
from torch.autograd import profiler as _profiler

SECTIONS = ("global.stats", "global.evo_moves", "global.pop_moves",
            "global.ledger", "sweep.prep", "sweep.kernel", "sweep.update")
SUBCOUNTS = ("mpox.stats", "mpox.rounds")

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else a
    shared no-op context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """A decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


# -- device sections, counted at capture --------------------------------------

# CUgraphNodeType: CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY, _MEMSET
_DEVICE_NODES = (0, 1, 2)
_CAPTURE_ACTIVE = 1      # CU_STREAM_CAPTURE_STATUS_ACTIVE
_DRIVER = None
_STATE = threading.local()


def _driver():
    """The CUDA driver library, its three graph queries typed."""
    global _DRIVER
    if _DRIVER is None:
        lib = ctypes.CDLL("libcuda.so.1")
        P = ctypes.c_void_p
        lib.cuStreamGetCaptureInfo_v2.argtypes = [
            P, ctypes.POINTER(ctypes.c_int), P, ctypes.POINTER(P), P, P]
        lib.cuGraphGetNodes.argtypes = [P, P, ctypes.POINTER(ctypes.c_size_t)]
        lib.cuGraphNodeGetType.argtypes = [P, ctypes.POINTER(ctypes.c_int)]
        for fn in (lib.cuStreamGetCaptureInfo_v2, lib.cuGraphGetNodes,
                   lib.cuGraphNodeGetType):
            fn.restype = ctypes.c_int
        _DRIVER = lib
    return _DRIVER


def _check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA driver error {code}")


class DeviceNodes:
    """The device nodes of the graph that ``stream`` (a ``torch.cuda.Stream``)
    is capturing into, counted as they come: each call returns how many
    the graph holds so far, asking the type of only the nodes it has not
    seen.  Nothing is asked of the driver before the first call, so a
    capture that marks no section never asks."""

    def __init__(self, stream):
        self.stream = stream
        self.graph = None       # asked for at the first count
        self.seen = set()
        self.device = 0

    def __call__(self) -> int:
        lib = _driver()
        if self.graph is None:
            status = ctypes.c_int(0)
            self.graph = ctypes.c_void_p()
            _check(lib.cuStreamGetCaptureInfo_v2(
                ctypes.c_void_p(self.stream.cuda_stream),
                ctypes.byref(status), None, ctypes.byref(self.graph), None,
                None), "cuStreamGetCaptureInfo")
            if status.value != _CAPTURE_ACTIVE:
                raise RuntimeError("the stream is not capturing a graph")
        n = ctypes.c_size_t(0)
        _check(lib.cuGraphGetNodes(self.graph, None, ctypes.byref(n)),
               "cuGraphGetNodes")
        if n.value == len(self.seen):
            return self.device
        nodes = (ctypes.c_void_p * n.value)()
        _check(lib.cuGraphGetNodes(self.graph, nodes, ctypes.byref(n)),
               "cuGraphGetNodes")
        kind = ctypes.c_int(0)
        for node in nodes[:n.value]:
            if node in self.seen:
                continue
            self.seen.add(node)
            _check(lib.cuGraphNodeGetType(ctypes.c_void_p(node),
                                          ctypes.byref(kind)),
                   "cuGraphNodeGetType")
            self.device += kind.value in _DEVICE_NODES
        return self.device


@contextlib.contextmanager
def counting(sections: dict, nodes, subcounts: dict):
    """Within the block (a capture), each ``section`` call of this thread
    closes the section marked before it: the nodes ``nodes()`` (a
    ``DeviceNodes``) counted since that mark are added to
    ``sections["ops." + name]``.  The last section closes at the block's
    end; nodes before the first mark belong to no section.  Each
    ``subcount`` block adds its nodes to ``subcounts["ops." + name]``."""
    _STATE.open = state = {"nodes": nodes, "name": None, "at": 0,
                           "sections": sections, "subcounts": subcounts}
    try:
        yield
        if state["name"] is not None:
            _close(state)
    finally:
        _STATE.open = None


def _close(state) -> int:
    n = state["nodes"]()
    if state["name"] is not None:
        key = "ops." + state["name"]
        state["sections"][key] = (state["sections"].get(key, 0)
                                  + n - state["at"])
    return n


def section(name: str) -> None:
    """Mark the start of section ``name`` (one of ``SECTIONS``) of the
    device work being captured; nothing outside ``counting``."""
    state = getattr(_STATE, "open", None)
    if state is None:
        return
    if name not in SECTIONS:
        raise ValueError(f"unknown section {name!r}")
    state["at"] = _close(state)
    state["name"] = name


def subcount(name: str):
    """A block whose device nodes under capture are added to
    ``subcounts["ops." + name]`` of the ``counting`` around it (``name``
    one of ``SUBCOUNTS``); outside ``counting`` a shared no-op context."""
    state = getattr(_STATE, "open", None)
    if state is None:
        return _OFF
    if name not in SUBCOUNTS:
        raise ValueError(f"unknown subcount {name!r}")
    return _subcounted(state, "ops." + name)


@contextlib.contextmanager
def _subcounted(state, key: str):
    at = state["nodes"]()
    yield
    counts = state["subcounts"]
    counts[key] = counts.get(key, 0) + state["nodes"]() - at
