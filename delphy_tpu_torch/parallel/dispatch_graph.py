"""The compiled dispatch: one boundary of a dispatch captured as a CUDA
graph and replayed once per boundary (port-only, like ``convert.py`` and
the ``*_cuda.py`` wrappers).

The JAX package runs a dispatch as one program
(``delphy_tpu/parallel/sweep.py:594-650``): a ``jax.jit`` of a ``lax.scan``
of ``_boundary_body`` over the boundaries, with ``mesh``, ``part_sel`` and
``param_moves`` among its arguments, compiled again only when a static
argument or an array shape changes.  Its counterpart here:

- static buffers: every tensor the boundary reads (``ts``, ``evo``,
  ``pop_params``, ``tin``, ``tout``, ``pm`` and, for the overlapped
  driver's L boundaries, the part selection ``part_sel``) gets a fixed
  address, and the dispatch's move count an accumulator beside them.
  Every dispatch copies all its inputs in, so no write to an input can go
  unseen, and a new selection of the same width replays the same graph;
- the capture: one boundary, then in-graph copies of the state it wrote
  back into its buffers and its move count added to the accumulator, so a
  replay is one boundary and n replays are the scan;
- the cache key: what the jit recompiles on (``hyp``, ``num_cells``,
  ``nb_max``, ``param_moves``, a mesh's size and this rank), the values
  the capture bakes in (``t_max_tip``, the cells per colour block, and the
  sweep's blocks, whose uniforms' shape depends on them: drawing at
  ``nb_max`` instead would change the stream), the inputs' pytree
  structure with its static parts (a skygrid's type, which picks the code
  of ``skygrid_log_N`` and of the sweep's build), and the dtype, device
  and shape of every input (a selection's width among them).  A burst or
  a restencil that keeps every shape replays the same graphs; one that
  changes a shape captures again;
- the bound: a run's block count climbs over its first dispatches, as
  ``Run._absorb``'s rate estimate converges (the overlapped driver's L
  count follows its own 0.7/0.3 average of the same rate), and then stays
  on two or three values, so ``MAX_GRAPHS`` graphs, the least recently
  used dropped first, hold every count a run keeps using beside its
  globals-only G graph.  Each graph has its own memory pool, released
  with it;
- the run's generator is registered with each graph: a replay draws from
  the generator's offset of the moment and advances it by the capture's
  draws, as the eager boundary does;
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
- the hand-off: at the dispatch's end the state the graph writes, the last
  boundary's ledger and stats and the move count are cloned out (one
  concatenation per dtype), and the host bundle (``fuse_for_host``) is
  made from them, as the JAX program returns it.  The run's state never
  aliases memory that a later replay overwrites.  Every step of a
  dispatch (copy-in, replays, hand-off) runs on the current stream, so a
  copy the caller starts after it (``state.fetch_later``) follows it.

``graph_rule`` says which dispatches run this way: on CUDA, every one of
both drivers, on every model option (the exponential model, the skygrid
of either type, alpha/nu, mpox): the blocking driver's, the overlapped
driver's globals-only G (``n_blocks`` 0: the global moves alone) and
part-selected L boundaries, and a mesh rank's whose all-reduce stays on
the card (NCCL).  A mesh whose ranks share one card (``staged``: its
all-reduce copies the buffer to the host and back over gloo, which a
capture cannot hold) and the CPU run the eager loop of
``sweep.parts_multi_super_step``.  A capture that fails raises on the
rank it fails on (``distributed.spawn`` then stops the others).
Captures run in thread-local mode on a side stream of the cache's own, so
the engine server's other run can work on its thread meanwhile.
"""

from __future__ import annotations

import time
from collections import Counter, OrderedDict

import torch

from ..state import _leaves, _rebuild, fuse_for_host
from . import _cuda

# graphs a cache keeps: once its rate estimate settles a blocking run
# dispatches at two or three block counts (10,000 and 59,000 tips,
# chip_smoke phase 16(c)), an overlapped run at its G graph and one or two
# L counts (10,000 tips, phase 16(d)); at 59,000 tips, the largest the
# blocking driver takes, a graph's pool holds up to ~0.6 GB (PERF.md
# section 6)
MAX_GRAPHS = 4


def graph_rule(device, pop_params, hyp, n_blocks: int, part_sel,
               mesh) -> bool:
    """Whether a dispatch runs as graph replays: on a CUDA device, unless
    its mesh is ``staged`` (ranks sharing one card reduce through the
    host), whatever the population model (``pop_params``), the moves
    ``hyp`` turns on, the blocks (``n_blocks`` 0: the overlapped driver's
    globals-only boundary) and the part selection.  A staged mesh and the
    CPU run the eager loop."""
    del pop_params, hyp, n_blocks, part_sel      # every dispatch is captured
    return (torch.device(device).type == "cuda"
            and not (mesh is not None and mesh.staged))


def structure(tree):
    """A pytree's structure: each node's type and static parts (a
    skygrid's type), with None at the leaves."""
    if hasattr(tree, "tree_flatten"):
        children, aux = tree.tree_flatten()
        return (type(tree).__name__, aux, structure(tuple(children)))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(structure(x) for x in tree))
    return None


def signature(inputs) -> tuple:
    """Structure, shape, dtype and device of a dispatch's inputs."""
    return (structure(tuple(inputs)),
            tuple((tuple(x.shape), x.dtype, str(x.device))
                  for x in _leaves(inputs)))


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


def _end_failed_capture(graph) -> None:
    try:
        graph.capture_end()
    except RuntimeError:
        pass   # the capture's own error is the one raised


class _Buffers:
    """Fixed-address copies of a dispatch's inputs and the move-count
    accumulator."""

    def __init__(self, inputs):
        leaves = _leaves(inputs)
        self.leaves = [torch.empty(x.shape, dtype=x.dtype, device=x.device)
                       for x in leaves]
        self.inputs = _rebuild(inputs, iter(self.leaves))
        self.acc = torch.zeros((), dtype=torch.int64,
                               device=leaves[0].device)

    def copy_in(self, inputs) -> None:
        for buf, x in zip(self.leaves, _leaves(inputs)):
            buf.copy_(x)


class _Graph:
    """One boundary over ``bufs``: ``body(ts, evo, pop, tin, tout, pm,
    *rest)`` -> (ts, evo, pop, ledger, stats) (``rest``: the inputs after
    ``pm``, the part selection where there is one) and its copy-back,
    captured on ``stream`` (CUDA), else (``stream`` None) run as it is at
    each replay.  ``warm_up`` (None: none), called on the buffers' inputs,
    runs once before, on ``stream``."""

    def __init__(self, bufs: _Buffers, body, gen, stream, warm_up=None):
        self.bufs = bufs
        ts, evo, pop = bufs.inputs[:3]
        carry = bufs.leaves[:len(_leaves((ts, evo, pop)))]

        def step():
            ts2, evo2, pop2, ledger, stats = body(*bufs.inputs)
            stats = dict(stats)
            bufs.acc.add_(stats.pop("local_moves_attempted"))
            outs = _leaves((ts2, evo2, pop2))
            written = [o is not b for o, b in zip(outs, carry)]
            # the copy-back is a scan's carry only for new tensors of the
            # buffers' shapes, none a view of a buffer it rewrites
            targets = {b.untyped_storage().data_ptr()
                       for b, w in zip(carry, written) if w}
            for o, b, w in zip(outs, carry, written):
                if w and (o.shape != b.shape or o.dtype != b.dtype
                          or o.untyped_storage().data_ptr() in targets):
                    raise ValueError(f"the boundary's {o.dtype} "
                                     f"{tuple(o.shape)} output cannot be "
                                     f"copied back into its {b.dtype} "
                                     f"{tuple(b.shape)} buffer")
            for o, b, w in zip(outs, carry, written):
                if w:
                    b.copy_(o)
            return written, ledger, stats

        self.record = []
        self.capture_ms = 0.0
        self.pool_bytes = 0
        if stream is None:
            if warm_up is not None:
                warm_up(*bufs.inputs)
            self.graph = None
            self._step = step
            return
        dev = carry[0].device
        _cuda.lib()     # built and loaded before the capture
        self.graph = torch.cuda.CUDAGraph()
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
                self.written, self.ledger, self.stats = step()
            except BaseException:
                _end_failed_capture(self.graph)
                raise
            self.graph.capture_end()
        main.wait_stream(stream)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved

    def replay(self, n: int) -> None:
        if self.graph is None:
            for _ in range(n):
                self.written, self.ledger, self.stats = self._step()
            return
        for _ in range(n):
            self.graph.replay()
        _cuda.tally(self.record, n)


class DispatchGraphs:
    """A graph cache: each ``Run`` owns one (``Run._graphs``).  It keeps
    ``MAX_GRAPHS`` graphs, the least recently used dropped first, over
    buffers shared by the graphs of one input signature.  ``captures``
    lists each capture's block count, ms and pool bytes (the reserved
    memory it added) in order; ``dispatches`` counts dispatches by block
    count and ``replays`` the replays."""

    def __init__(self):
        self.graphs = OrderedDict()    # key -> _Graph
        self.buffers = {}              # signature -> _Buffers
        self.captures = []
        self.dispatches = Counter()
        self.replays = 0
        self._stream = None

    def dispatch(self, body, inputs, gen: torch.Generator, statics: tuple,
                 n_blocks: int, n_boundaries: int, warm_up=None):
        """``n_boundaries`` replays of ``body``'s graph on ``inputs`` =
        (ts, evo, pop_params, tin, tout, pm[, part_sel]) at ``n_blocks``
        blocks, keyed by ``statics``, ``n_blocks`` and the inputs'
        signature; on CPU tensors the body runs as it is, through the same
        buffers.  ``warm_up`` (optional) runs on the buffers' inputs
        before a capture.  Returns (ts, evo, pop_params, ledger, stats,
        fused) as the eager loop does."""
        sig = signature(inputs)
        bufs = self.buffers.get(sig)
        if bufs is None:
            bufs = self.buffers[sig] = _Buffers(inputs)
        bufs.copy_in(inputs)
        key = (statics, n_blocks, sig)
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = self._capture(bufs, body, gen,
                                                     warm_up)
            self.captures.append({"blocks": n_blocks, "ms": graph.capture_ms,
                                  "pool_bytes": graph.pool_bytes})
            self._evict()
        else:
            self.graphs.move_to_end(key)
        bufs.acc.zero_()
        graph.replay(n_boundaries)
        self.dispatches[n_blocks] += 1
        self.replays += n_boundaries
        return self._hand_off(graph, bufs, inputs)

    def _capture(self, bufs: _Buffers, body, gen, warm_up) -> _Graph:
        dev = bufs.acc.device
        if dev.type != "cuda":
            return _Graph(bufs, body, gen, None, warm_up)
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        return _Graph(bufs, body, gen, self._stream, warm_up)

    def _evict(self) -> None:
        while len(self.graphs) > MAX_GRAPHS:
            _key, old = self.graphs.popitem(last=False)
            if all(g.bufs is not old.bufs for g in self.graphs.values()):
                self.buffers = {s: b for s, b in self.buffers.items()
                                if b is not old.bufs}

    def _hand_off(self, graph: _Graph, bufs: _Buffers, inputs):
        carry_in = _leaves(inputs[:3])
        idx = [i for i, w in enumerate(graph.written) if w]
        led = _leaves(graph.ledger)
        names = list(graph.stats)
        cloned = clone_out([bufs.leaves[i] for i in idx] + led
                           + [graph.stats[k] for k in names] + [bufs.acc])
        carry = list(carry_in)
        for j, i in enumerate(idx):
            carry[i] = cloned[j]
        ts, evo, pop_params = _rebuild(inputs[:3], iter(carry))
        k = len(idx)
        ledger = _rebuild(graph.ledger, iter(cloned[k:k + len(led)]))
        stats = dict(zip(names, cloned[k + len(led):-1]),
                     local_moves_attempted=cloned[-1])
        return (ts, evo, pop_params, ledger, stats,
                fuse_for_host((ts, evo, pop_params)))
