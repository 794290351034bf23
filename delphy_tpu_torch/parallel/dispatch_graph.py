"""The compiled dispatch: one step of a loop captured as a CUDA graph over
static buffers and replayed once per step (port-only, like ``convert.py``
and the ``*_cuda.py`` wrappers).

The JAX package runs each of its loops of like steps as one program, a
``jax.jit`` of a ``lax.scan``, compiled again only when a static argument
or an array shape changes.  Three have a counterpart here:

- a dispatch of ``Run`` (``delphy_tpu/parallel/sweep.py:594-650``:
  ``_boundary_body`` scanned over the boundaries, with ``mesh``,
  ``part_sel`` and ``param_moves`` among its arguments):
  ``sweep.graph_dispatch``;
- the unpartitioned ``multi_super_step`` (``delphy_tpu/mcmc/kernel.py``
  ``:215-240``, its ``super_step`` scanned over the boundaries):
  ``kernel.multi_super_step``, through ``DispatchGraphs`` as well;
- the device SPR sweeps (``delphy_tpu/ops/spr_move.py:732`` ``spr1_sweep``
  and ``delphy_tpu/ops/spr_miss.py:1517`` ``spr1_sweep_miss``: one move
  scanned over its keys): ``spr_move._sweeps``, one move a replay, through
  ``spr_move.MoveGraphs``, a ``GraphCache`` of its own.

Each step is a body over static buffers (``_Graph``):

- static buffers: every tensor the body reads (``ts``, ``evo``,
  ``pop_params``, ``tin``, ``tout``, ``pm`` and the overlapped driver's
  part selection ``part_sel``; an SPR move's packed tree, its draws and
  its constants) gets a fixed address.  A dispatch copies all its inputs
  in, so no write to an input can go unseen; an SPR sweep copies its
  constants in once, a lane's tree in when that lane's move comes, and
  each move's draws before that move's replay;
- the capture: one step, ``body(*inputs)`` -> (carry, out), then in-graph
  copies of the carry back into its buffers, so a replay is one step and
  n replays are the scan.  ``out`` (the step's other results) stays where
  the capture put it: a dispatch adds its move count to an accumulator in
  the graph and clones out the last ledger and stats after the replays; an
  SPR sweep clones out each move's accept, delta and flags after its
  replay;
- the cache key: what the jit recompiles on (``hyp``, ``num_cells``,
  ``nb_max``, ``param_moves``, a mesh's size and this rank; an SPR core's
  ``L``, ``f`` and widths), the values the capture bakes in (``t_max_tip``,
  the cells per colour block, the sweep's blocks, whose uniforms' shape
  depends on them: drawing at ``nb_max`` instead would change the stream;
  the generator a free function's graph draws from), the inputs' pytree
  structure with its static parts (a skygrid's type, which picks the code
  of ``skygrid_log_N`` and of the sweep's build; a packed tree's keys), the
  dtype, device and shape of every tensor input (a selection's width among
  them) and the value of every other input.  A burst or a restencil that
  keeps every shape replays the same graphs; one that changes a shape
  captures again;
- the generator: a graph that draws has its generator registered: a replay
  draws from the generator's offset of the moment and advances it by the
  capture's draws, as the eager step does.  A ``Run``'s graphs draw from
  its own generator; a free function's key holds the generator object
  itself (a reference, whose ``id`` cannot be reused while the graph
  lives), so a call on another generator captures its own graph.  An SPR
  move draws nothing (its draws are made up front): its graph registers
  no generator;
- the warm-up, run on the capture stream just before a capture: a skygrid
  boundary with parameter moves takes its HMC's forces from autograd,
  whose backward runs on the autograd engine's device thread on the
  stream of its forward ops, here the capture stream.  PyTorch asks for
  autograd to have run on that stream before a capture, so the force on
  the buffers' gamma (which draws nothing and writes nothing back) runs
  first.  A mesh boundary's all-reduce goes over NCCL inside the graph,
  whose communicator must exist before the capture: an eager all-reduce
  of the boundary's buffer size runs first, on every rank at the same
  dispatch (dispatch sizes follow a rule, so the ranks capture alike);
- the hand-off: the carry's buffers and the outputs are cloned out (one
  concatenation per dtype), so nothing returned aliases memory that a
  later replay overwrites.  Every step of a call (copy-in, replays,
  hand-off) runs on the current stream, so a copy the caller starts after
  it (``state.fetch_later``) follows it.  ``Run`` makes its host bundle
  (``fuse_for_host``) from what the hand-off returns;
- the record: a capture runs inside ``_cuda.recording()``, so the
  launches of the port's kernels go to the graph's ``record``, and inside
  ``tracing.counting``, so the boundary's section marks
  (``tracing.section``: global statistics, evolutionary and population
  moves, ledger, sweep preparation, kernel and update) count the graph's
  device nodes into ``record.sections`` (and the mpox model's blocks,
  ``tracing.subcount``, into ``record.subcounts``).  Each replay adds the
  record to ``_cuda.launch_counts`` (``_cuda.tally``): the kernels'
  launches and ``ops.<section>``, a boundary's device operations section
  by section, and ``ops.<subcount>``;
- the spans: a dispatch's copy-in, capture, replays and hand-off are
  ``tracing.span`` ranges (``delphy.dispatch.*``), seen by a profiler
  and nothing else.

``captures_on`` says where a loop runs this way: on a CUDA device.  There
``graph_rule`` sends every dispatch of both drivers, on every model
option (the exponential model, the skygrid of either type, alpha/nu,
mpox), to the graph: the blocking driver's, the overlapped driver's
globals-only G (``n_blocks`` 0: the global moves alone) and
part-selected L boundaries, and a mesh rank's whose all-reduce stays on
the card (NCCL).  A mesh whose ranks share one card (``staged``: its
all-reduce copies the buffer to the host and back over gloo, which a
capture cannot hold) and the CPU run the eager loop of
``sweep.parts_multi_super_step``.  ``kernel.super_step``,
``multi_super_step`` and the SPR sweeps replay graphs on CUDA by the same
rule and run their eager loops on the CPU or with ``_eager=True``.  A
capture that fails raises (on a mesh, on the rank it fails on:
``distributed.spawn`` then stops the others).  Captures run in
thread-local mode on a side stream of the cache's own, so the engine
server's other run can work on its thread meanwhile.

The free functions keep their graphs in caches of the calling thread
(``thread_cache``), as the JAX jit cache is the process's: two threads
never share buffers.  What such a cache holds stays held after the call:
its graphs' private memory pools, its buffers and the generators its keys
name, up to its bound (``MAX_GRAPHS`` boundary graphs, up to ~0.6 GB of
pool each at 59,000 tips; ``spr_move.MAX_MOVE_GRAPHS`` move graphs, ~0.13
GB each for a missation-aware move at 54 tips x 29,903 sites, chip_smoke
phase 14).  ``clear`` drops this thread's caches: a caller done with these
functions calls it to give that memory back.
"""

from __future__ import annotations

import threading
import time
from collections import Counter, OrderedDict

import torch

from .. import tracing
from . import _cuda

# graphs a dispatch cache keeps (a Run's own, or a thread's for
# kernel.multi_super_step, which also holds the generator of each key),
# the least recently used dropped first.  A
# blocking run's block count settles on two or three values once its rate
# estimate does (10,000 and 59,000 tips, chip_smoke phase 16(c)).  An
# overlapped run's L count follows its own rate average and changed on
# every one of 12 cycles at 10,000 tips (phase 16(d); PERF.md section 6):
# the cache then holds its G graph and the last three L counts and
# captures again at each new count (29-314 ms a capture).  At 59,000 tips,
# the largest the blocking driver takes, a graph's pool holds up to
# ~0.6 GB, an L graph's at 100,000 tips up to ~0.77 GB
MAX_GRAPHS = 4


def captures_on(device) -> bool:
    """Whether a loop on ``device`` replays CUDA graphs: on a CUDA device.
    Elsewhere it runs its eager loop (the CPU)."""
    return torch.device(device).type == "cuda"


def graph_rule(device, pop_params, hyp, n_blocks: int, part_sel,
               mesh) -> bool:
    """Whether a dispatch runs as graph replays: on a CUDA device, unless
    its mesh is ``staged`` (ranks sharing one card reduce through the
    host), whatever the population model (``pop_params``), the moves
    ``hyp`` turns on, the blocks (``n_blocks`` 0: the overlapped driver's
    globals-only boundary) and the part selection.  A staged mesh and the
    CPU run the eager loop."""
    del pop_params, hyp, n_blocks, part_sel      # every dispatch is captured
    return captures_on(device) and not (mesh is not None and mesh.staged)


def _children(tree):
    """A pytree node's (children, rebuild), or None at a leaf."""
    if hasattr(tree, "tree_flatten"):
        children, aux = tree.tree_flatten()
        return children, lambda xs: type(tree).tree_unflatten(aux, xs)
    if isinstance(tree, dict):
        return list(tree.values()), lambda xs: dict(zip(tree, xs))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(tree), lambda xs: type(tree)(*xs)
    if isinstance(tree, (tuple, list)):
        return list(tree), lambda xs: type(tree)(xs)
    return None


def leaves(tree) -> list:
    """A pytree's leaves (pytree nodes, NamedTuples, tuples, lists and
    dicts), in order."""
    node = _children(tree)
    if node is None:
        return [tree]
    return [leaf for child in node[0] for leaf in leaves(child)]


def rebuild(template, it):
    """``template``'s structure with its leaves taken from ``it``."""
    node = _children(template)
    if node is None:
        return next(it)
    return node[1]([rebuild(child, it) for child in node[0]])


def structure(tree):
    """A pytree's structure: each node's type and static parts (a
    skygrid's type, a dict's keys), with None at the leaves."""
    if hasattr(tree, "tree_flatten"):
        children, aux = tree.tree_flatten()
        return (type(tree).__name__, aux, structure(tuple(children)))
    if isinstance(tree, dict):
        return ("dict", tuple(tree), structure(tuple(tree.values())))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(structure(x) for x in tree))
    return None


def _leaf_signature(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, str(x.device))
    return (type(x).__name__, x)     # a Python value the capture bakes in


def signature(inputs) -> tuple:
    """Structure, and the shape, dtype and device of each tensor (the value
    of each other leaf), of a call's inputs."""
    return (structure(tuple(inputs)),
            tuple(_leaf_signature(x) for x in leaves(inputs)))


def clone_out(tensors) -> list:
    """Copies of ``tensors``, one concatenation per dtype: views of a new
    buffer in the tensors' shapes."""
    out = [None] * len(tensors)
    by_dtype = {}
    for i, x in enumerate(tensors):
        by_dtype.setdefault(x.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def copy_back(outs: list, bufs: list) -> list:
    """The carry ``outs`` copied into its buffers ``bufs``; an output that
    is its buffer itself (a step that kept it) is not copied.  Returns
    which were written.  The copy-back is a scan's carry only for new
    tensors of the buffers' shapes and dtypes, none a view of a buffer it
    rewrites: anything else raises."""
    written = [o is not b for o, b in zip(outs, bufs)]
    targets = {b.untyped_storage().data_ptr()
               for b, w in zip(bufs, written) if w}
    for o, b, w in zip(outs, bufs, written):
        if w and (o.shape != b.shape or o.dtype != b.dtype
                  or o.untyped_storage().data_ptr() in targets):
            raise ValueError(f"the step's {o.dtype} {tuple(o.shape)} "
                             f"output cannot be copied back into its "
                             f"{b.dtype} {tuple(b.shape)} buffer")
    for o, b, w in zip(outs, bufs, written):
        if w:
            b.copy_(o)
    return written


def _end_failed_capture(graph) -> None:
    try:
        graph.capture_end()
    except RuntimeError:
        pass   # the capture's own error is the one raised


class _Buffers:
    """Fixed-address copies of a call's tensor inputs (its other leaves,
    Python values in the key, as they are)."""

    def __init__(self, inputs):
        self.leaves = [torch.empty(x.shape, dtype=x.dtype, device=x.device)
                       if isinstance(x, torch.Tensor) else x
                       for x in leaves(inputs)]
        self.inputs = rebuild(inputs, iter(self.leaves))
        self.device = next(x.device for x in self.leaves
                           if isinstance(x, torch.Tensor))

    def copy_in(self, inputs, at=None) -> None:
        """``inputs`` copied into the buffers; with ``at``, ``inputs`` is
        the call's input ``at`` alone."""
        bufs = self.leaves if at is None else leaves(self.inputs[at])
        for buf, x in zip(bufs, leaves(inputs)):
            if isinstance(buf, torch.Tensor):
                buf.copy_(x)


class _StepBuffers(_Buffers):
    """A dispatch's buffers and its move-count accumulator."""

    def __init__(self, inputs):
        super().__init__(inputs)
        self.acc = torch.zeros((), dtype=torch.int64, device=self.device)


class _Graph:
    """One step over ``bufs``: ``body(*bufs.inputs)`` -> (carry, out), the
    carry a pytree like ``bufs.inputs[:n_carry]`` copied back into its
    buffers (``copy_back``), captured on ``stream`` (CUDA), else (``stream``
    None) run as it is at each replay.  After a replay ``written`` says
    which carry buffers the step writes and ``out`` holds its other
    results (the capture's tensors, rewritten by every replay).  ``gen``
    (None: the step draws nothing) is registered with the graph.
    ``warm_up`` (None: none), called on the buffers' inputs, runs once
    before, on ``stream``.  The CUDA kernels are built and loaded before
    a capture."""

    def __init__(self, bufs: _Buffers, body, n_carry: int, gen, stream,
                 warm_up=None):
        self.bufs = bufs
        carry = leaves(bufs.inputs[:n_carry])

        def step():
            new, out = body(*bufs.inputs)
            return copy_back(leaves(new), carry), out

        self.record = []
        self.capture_ms = 0.0
        self.pool_bytes = 0
        if stream is None:
            if warm_up is not None:
                warm_up(*bufs.inputs)
            self.graph = None
            self._step = step
            return
        dev = bufs.device
        _cuda.lib()     # built and loaded before the capture
        self.graph = torch.cuda.CUDAGraph()
        if gen is not None:
            self.graph.register_generator_state(gen)
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        # the capture's prologue rewrites the generator's seed and offset
        # tensors, which every graph registered with it reads, on the side
        # stream: after the replays already enqueued, and before the next
        main = torch.cuda.current_stream(dev)
        stream.wait_stream(main)
        if warm_up is not None:
            with torch.cuda.stream(stream):
                warm_up(*bufs.inputs)
        with torch.cuda.stream(stream), _cuda.recording() as self.record:
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                with tracing.counting(self.record.sections,
                                      tracing.DeviceNodes(stream),
                                      self.record.subcounts):
                    self.written, self.out = step()
            except BaseException:
                _end_failed_capture(self.graph)
                raise
            self.graph.capture_end()
        main.wait_stream(stream)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved

    def replay(self, n: int = 1) -> None:
        if self.graph is None:
            for _ in range(n):
                self.written, self.out = self._step()
            return
        for _ in range(n):
            self.graph.replay()
        _cuda.tally(self.record, n)


class GraphCache:
    """Graphs by key, the least recently used dropped first beyond
    ``limit``, over buffers that the graphs of one buffer key share.
    ``captures`` lists each capture's ms and pool bytes (the reserved
    memory it added) in order, with ``info``; ``replays`` counts the
    replays.  A subclass gives ``limit``, read at each capture
    (``DispatchGraphs``; ``spr_move.MoveGraphs``)."""

    def __init__(self):
        self.graphs = OrderedDict()    # key -> _Graph
        self.buffers = {}              # buffer key -> _Buffers
        self.captures = []
        self.replays = 0
        self._stream = None

    def _buffers(self, bkey, inputs, kind=_Buffers) -> _Buffers:
        bufs = self.buffers.get(bkey)
        if bufs is None:
            bufs = self.buffers[bkey] = kind(inputs)
        return bufs

    def _graph(self, key, bufs: _Buffers, body, n_carry: int, gen,
               warm_up=None, **info) -> _Graph:
        graph = self.graphs.get(key)
        if graph is not None:
            self.graphs.move_to_end(key)
            return graph
        stream = None
        if bufs.device.type == "cuda":
            if self._stream is None:
                self._stream = torch.cuda.Stream(bufs.device)
            stream = self._stream
        with tracing.span("delphy.dispatch.capture"):
            graph = self.graphs[key] = _Graph(bufs, body, n_carry, gen,
                                              stream, warm_up)
        self.captures.append(dict(info, ms=graph.capture_ms,
                                  pool_bytes=graph.pool_bytes))
        self._evict()
        return graph

    def _evict(self) -> None:
        while len(self.graphs) > self.limit:
            _key, old = self.graphs.popitem(last=False)
            if all(g.bufs is not old.bufs for g in self.graphs.values()):
                self.buffers = {k: b for k, b in self.buffers.items()
                                if b is not old.bufs}


class DispatchGraphs(GraphCache):
    """A cache of boundary graphs: each ``Run`` owns one
    (``Run._graphs``), and each thread one for ``kernel.multi_super_step``
    (``thread_cache``).  It keeps ``MAX_GRAPHS`` graphs over buffers shared
    by the graphs of one input signature.  ``captures`` lists each
    capture's block count, ms and pool bytes; ``dispatches`` counts
    dispatches by block count and ``replays`` the replays."""

    def __init__(self):
        super().__init__()
        self.dispatches = Counter()

    @property
    def limit(self) -> int:
        return MAX_GRAPHS

    def dispatch(self, body, inputs, gen: torch.Generator, statics: tuple,
                 n_blocks: int, n_boundaries: int, warm_up=None):
        """``n_boundaries`` replays of ``body``'s graph on ``inputs`` =
        (ts, evo, pop_params, ...), ``body(*inputs)`` -> (ts, evo,
        pop_params, ledger, stats) with the boundary's move count in
        ``stats["local_moves_attempted"]``, at ``n_blocks`` blocks, keyed
        by ``statics``, ``n_blocks`` and the inputs' signature; on CPU
        tensors the body runs as it is, through the same buffers.
        ``warm_up`` (optional) runs on the buffers' inputs before a
        capture.  Returns (ts, evo, pop_params, ledger, stats) as the
        eager loop does, the move count summed over the boundaries."""
        sig = signature(inputs)
        bufs = self._buffers(sig, inputs, _StepBuffers)
        with tracing.span("delphy.dispatch.copy_in"):
            bufs.copy_in(inputs)

        def boundary(*inputs):
            ts, evo, pop_params, ledger, stats = body(*inputs)
            stats = dict(stats)
            tracing.section("sweep.update")
            bufs.acc.add_(stats.pop("local_moves_attempted"))
            return (ts, evo, pop_params), (ledger, stats)

        graph = self._graph((statics, n_blocks, sig), bufs, boundary, 3, gen,
                            warm_up, blocks=n_blocks)
        with tracing.span("delphy.dispatch.replay"):
            bufs.acc.zero_()
            graph.replay(n_boundaries)
        self.dispatches[n_blocks] += 1
        self.replays += n_boundaries
        with tracing.span("delphy.dispatch.hand_off"):
            return self._hand_off(graph, bufs, inputs)

    @staticmethod
    def _hand_off(graph: _Graph, bufs: _StepBuffers, inputs):
        carry_in = leaves(inputs[:3])
        idx = [i for i, w in enumerate(graph.written) if w]
        ledger, stats = graph.out
        led = leaves(ledger)
        names = list(stats)
        cloned = clone_out([bufs.leaves[i] for i in idx] + led
                           + [stats[k] for k in names] + [bufs.acc])
        carry = list(carry_in)
        for j, i in enumerate(idx):
            carry[i] = cloned[j]
        ts, evo, pop_params = rebuild(inputs[:3], iter(carry))
        k = len(idx)
        ledger = rebuild(ledger, iter(cloned[k:k + len(led)]))
        stats = dict(zip(names, cloned[k + len(led):-1]),
                     local_moves_attempted=cloned[-1])
        return ts, evo, pop_params, ledger, stats


_THREAD = threading.local()


def thread_cache(kind):
    """This thread's cache of type ``kind`` (``DispatchGraphs`` or
    ``spr_move.MoveGraphs``), made at its first use: the free functions'
    default, as the JAX jit cache is the process's.  One a thread: the
    engine server steps runs on worker threads, and two threads must not
    copy into one set of buffers."""
    caches = getattr(_THREAD, "caches", None)
    if caches is None:
        caches = _THREAD.caches = {}
    if kind not in caches:
        caches[kind] = kind()
    return caches[kind]


def clear() -> None:
    """Drops this thread's caches (``thread_cache``): their graphs, whose
    pools go back to PyTorch's allocator, their buffers and the generators
    their keys held.  The next call of a free function captures again."""
    _THREAD.caches = {}
