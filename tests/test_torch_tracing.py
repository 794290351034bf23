"""The port's tracing (``delphy_tpu_torch/tracing.py``): host spans in a
profiler's trace, nested as documented, and nothing entered without a
profiler; device sections counted at a capture and added at each replay
under ``ops.<section>``; on the card, a boundary graph's section counts
against the graph's own device nodes.  This file imports no jax, so its
CUDA test runs on a host that has none:

    python -m pytest tests/test_torch_tracing.py -m cuda --noconftest
"""

import ctypes
import json
import os
import tempfile

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from delphy_tpu_torch import tracing
from delphy_tpu_torch.init_tree import build_initial_tree
from delphy_tpu_torch.parallel import _cuda
from delphy_tpu_torch.parallel import dispatch_graph as dg
from delphy_tpu_torch.run import Run
from delphy_tpu_torch.sim import simulate_dataset

# each span and the span it runs inside
PARENT = {
    "delphy.dispatch.copy_in": "delphy.dispatch",
    "delphy.dispatch.capture": "delphy.dispatch",
    "delphy.dispatch.replay": "delphy.dispatch",
    "delphy.dispatch.hand_off": "delphy.dispatch",
    "delphy.burst.fetch": "delphy.burst",
    "delphy.burst.unpack": "delphy.burst",
    "delphy.burst.moves": "delphy.burst",
    "delphy.burst.chains": "delphy.burst",
    "delphy.burst.adopt": "delphy.burst",
    "delphy.repartition": "delphy.burst.adopt",
}
CYCLE = ("enqueue_GL", "wait_G", "burst", "join_L", "merge")


def _run(seed=5, tips=20, parts=4, **kw):
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        tips, 300, mu=1e-3, sample_window_days=300.0, missing_fraction=0.02,
        seed=seed)
    tree = build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(seed))
    return Run(tree, seed=seed, num_cells=64, device_partitions=parts,
               device="cpu", **kw)


def _spans(prof):
    """(name, start, end) of the profiler's user annotations, in us."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events
            if e.get("cat") == "user_annotation" and "dur" in e]


def _inside(span, spans, parent):
    _n, s, e = span
    return any(n == parent and a <= s and e <= b for n, a, b in spans)


def test_run_call_exports_every_span_nested(monkeypatch):
    """One call of a blocking Run (its dispatches through the graph
    plumbing, which runs the body as it is on CPU tensors), ending in a
    burst, under a profiler: every span of the driver, the dispatch and
    the burst is in the trace, each inside the span the module docstring
    puts it in."""
    monkeypatch.setattr(dg, "graph_rule", lambda *a: True)
    run = _run()
    lm = run.local_moves_per_global_move
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run.do_mcmc_steps(2 * lm)
    assert run.burst_count == 1
    spans = _spans(prof)
    names = {n for n, _s, _e in spans}
    assert names >= {"delphy.dispatch", "delphy.wait", "delphy.burst",
                     *PARENT}, names
    for sp in spans:
        if sp[0] in PARENT:
            assert _inside(sp, spans, PARENT[sp[0]]), sp
    # the wait follows its dispatch's enqueue
    enq = sorted(s for s in spans if s[0] == "delphy.dispatch")
    wait = sorted(s for s in spans if s[0] == "delphy.wait")
    assert len(enq) == len(wait) == run.dispatch_count
    assert all(e[2] <= w[1] for e, w in zip(enq, wait))


def test_overlapped_cycle_times_its_stages_in_last_cycle(monkeypatch):
    """An overlapped cycle's five stages are timed in ``last_cycle`` alone:
    under a profiler the cycle adds no span of its own, and its merge's
    repartition is the one span it shows."""
    monkeypatch.setenv("DELPHY_TPU_OVERLAP", "1")
    run = _run(seed=9, tips=48, parts=8, local_moves_per_global_move=200)
    run.topology_burst_chunks = 2
    assert run._overlap_active()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run.do_mcmc_steps(400)
    assert all(run.last_cycle[n + "_s"] > 0.0 for n in CYCLE)
    names = {n for n, _s, _e in _spans(prof) if n.startswith("delphy.")}
    assert names == {"delphy.repartition"}, names


def test_span_enters_no_record_function_without_a_profiler(monkeypatch):
    """Without a profiler a span makes no ``RecordFunction``: with
    ``record_function`` made to raise, a span and a whole Run call go
    through; under a profiler the same span reaches it."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with tracing.span("delphy.dispatch"):
        pass
    assert tracing.span("a") is tracing.span("b")
    assert tracing.spanned("a")(lambda x: x + 1)(1) == 2
    run = _run(seed=7)
    run.do_mcmc_steps(2 * run.local_moves_per_global_move)
    assert run.burst_count == 1
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="record_function"):
            tracing.span("delphy.dispatch")


class _FakeNodes:
    """A graph's device-node count that the test advances by hand."""

    def __init__(self):
        self.n = 0

    def __call__(self):
        return self.n


def test_tally_counts_sections_once_per_replay():
    """Section counts under a fake capture: each mark closes the section
    before it, nodes before the first mark belong to none, a section
    marked twice adds up, the last closes at the end; each replay adds the
    record's sections to ``ops.<section>`` as it adds the launches."""
    _cuda.reset_launch_counts()
    nodes = _FakeNodes()
    with _cuda.recording() as rec:
        with tracing.counting(rec.sections, nodes, rec.subcounts):
            nodes.n = 2                       # before any mark
            tracing.section("global.stats")
            nodes.n = 7
            tracing.section("sweep.kernel")
            _cuda.count_launch("sweep_chain", 8)
            nodes.n = 8
            tracing.section("sweep.update")
            nodes.n = 11
            tracing.section("sweep.update")
            nodes.n = 12
            with pytest.raises(ValueError, match="unknown section"):
                tracing.section("nowhere")
    assert rec == [("sweep_chain", 8)]
    assert rec.sections == {"ops.global.stats": 5, "ops.sweep.kernel": 1,
                            "ops.sweep.update": 4}
    tracing.section("global.stats")           # no capture: nothing
    assert rec.sections["ops.global.stats"] == 5
    _cuda.tally(rec, 3)
    _cuda.tally(rec)
    assert _cuda.launch_counts["ops.global.stats"] == 20
    assert _cuda.launch_counts["ops.sweep.update"] == 16
    assert _cuda.launch_counts["sweep_chain"] == 4
    assert _cuda.launch_blocks["sweep_chain"] == 32
    assert _cuda.graph_replays == 4
    _cuda.reset_launch_counts()
    assert not any(_cuda.launch_counts.values())


def test_section_keys_are_registered_at_import():
    """Every section and subcount has its key in the launch counts before
    any capture, so a per-dispatch difference of the counts carries it;
    no subcount key is one that a reader of the sections or of the global
    moves' counts sums, nor a kernel's."""
    assert tracing.SUBCOUNTS == ("mpox.stats", "mpox.rounds")
    assert [k for k in _cuda.launch_counts if k.startswith("ops.")] == [
        "ops." + s for s in tracing.SECTIONS + tracing.SUBCOUNTS]
    assert all(k in _cuda.launch_blocks for k in _cuda.launch_counts)
    for s in tracing.SUBCOUNTS:
        assert s not in tracing.SECTIONS and not s.startswith("global.")
        assert "ops." + s not in _cuda.kernel_counts()


def test_subcounts_count_their_block_apart_from_the_sections():
    """A subcount block under a fake capture adds its nodes to the
    record's ``subcounts`` and leaves the sections as they were; each
    replay adds them to ``ops.<subcount>``; outside a capture it is the
    shared no-op context, and an unknown name raises."""
    _cuda.reset_launch_counts()
    nodes = _FakeNodes()
    with _cuda.recording() as rec:
        with tracing.counting(rec.sections, nodes, rec.subcounts):
            tracing.section("global.evo_moves")
            with tracing.subcount("mpox.stats"):
                nodes.n = 9
            with tracing.subcount("mpox.rounds"):
                nodes.n = 30
            tracing.section("global.pop_moves")
            nodes.n = 32
            with pytest.raises(ValueError, match="unknown subcount"):
                tracing.subcount("global.stats")
    assert rec.sections == {"ops.global.evo_moves": 30,
                            "ops.global.pop_moves": 2}
    assert rec.subcounts == {"ops.mpox.stats": 9, "ops.mpox.rounds": 21}
    assert tracing.subcount("mpox.stats") is tracing.subcount("mpox.rounds")
    _cuda.tally(rec, 4)
    assert _cuda.launch_counts["ops.mpox.stats"] == 36
    assert _cuda.launch_counts["ops.mpox.rounds"] == 84
    assert _cuda.launch_counts["ops.global.evo_moves"] == 120
    _cuda.reset_launch_counts()


@pytest.mark.parametrize("mpox", [False, True])
def test_eager_and_cpu_dispatches_count_no_sections(mpox):
    """Outside a capture the marks do nothing: a CPU Run's dispatches,
    through the eager loop or the graph plumbing, count no section, and
    under the mpox model no subcount."""
    _cuda.reset_launch_counts()
    run = _run(seed=3, mpox_hack=mpox)
    run.do_mcmc_steps(2 * run.local_moves_per_global_move)
    assert run.hyp.mpox_enabled == mpox
    assert not any(_cuda.launch_counts.values())


# -- on the card -----------------------------------------------------------

@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _graph_device_nodes(graph) -> int:
    """Kernel, memcpy and memset nodes of a captured ``cudaGraph_t``."""
    lib = tracing._driver()
    n = ctypes.c_size_t(0)
    assert lib.cuGraphGetNodes(ctypes.c_void_p(graph), None,
                               ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert lib.cuGraphGetNodes(ctypes.c_void_p(graph), nodes,
                               ctypes.byref(n)) == 0
    kind, count = ctypes.c_int(0), 0
    for node in nodes:
        assert lib.cuGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(kind)) == 0
        count += kind.value in (0, 1, 2)
    return count


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["exp", "skygrid", "mpox"])
def test_sections_sum_to_the_graph_device_nodes(device, model,
                                                 monkeypatch):
    """On the card, the sections a boundary graph's capture counted add up
    to the device nodes the captured graph holds (kept for the check), and
    each replay adds them to ``ops.<section>``.  Under the mpox model (alpha
    off) the two subcounts split ``global.evo_moves`` exactly; elsewhere
    nothing is subcounted."""
    orig = torch.cuda.CUDAGraph
    monkeypatch.setattr(torch.cuda, "CUDAGraph",
                        lambda: orig(keep_graph=True))
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        40, 2000, mu=1e-3, sample_window_days=300.0, missing_fraction=0.02,
        seed=11)
    tree = build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(11))
    kw = ({"pop_model": "exp", "mpox_hack": True} if model == "mpox"
          else {"pop_model": model})
    run = Run(tree, seed=11, num_cells=128, device=device, **kw)
    _cuda.reset_launch_counts()
    run.do_mcmc_steps(3 * run.local_moves_per_global_move)
    torch.cuda.synchronize()
    graphs = list(run._graphs.graphs.values())
    assert graphs
    for g in graphs:
        sec = g.record.sections
        assert set(sec) == {"ops." + s for s in tracing.SECTIONS}, sec
        assert sum(sec.values()) == _graph_device_nodes(
            g.graph.raw_cuda_graph())
        sub = g.record.subcounts
        if model == "mpox":
            assert set(sub) == {"ops." + s for s in tracing.SUBCOUNTS}
            assert min(sub.values()) > 0
            assert sum(sub.values()) == sec["ops.global.evo_moves"]
        else:
            assert sub == {}
    replays = _cuda.graph_replays
    assert replays == run._graphs.replays
    if len(graphs) == 1:
        rec = graphs[0].record
        for k, n in {**rec.sections, **rec.subcounts}.items():
            assert _cuda.launch_counts[k] == replays * n
    if model == "mpox":
        assert (_cuda.launch_counts["ops.mpox.stats"]
                + _cuda.launch_counts["ops.mpox.rounds"]
                == _cuda.launch_counts["ops.global.evo_moves"])
