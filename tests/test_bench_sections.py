"""The benchmark's readers of the program's section counts and spans
(``benchmarks/metrics/``) on hand-built records of a traced slice: each
boundary's events labelled by its section counts around the sweep
kernel's launch, None where they do not line up or where the program
(a parent without the counts or spans) gives nothing to read; and the
readers that time the same layers from outside read what they read
before, with the section counts among the launch counts."""

import pytest

from benchmarks import run as br
from benchmarks.metrics import _sections

KERNEL = "void (anonymous namespace)::sweep_chain_kernel<double, 0, false>"
# a boundary's events, section by section (the kernel closes its section)
BOUNDARY = {
    "global.stats": ["scan", "gather"],
    "global.evo_moves": ["hky_chain_kernel"],
    "global.pop_moves": ["grid", "exp_pop_chain_kernel"],
    "global.ledger": ["ledger"],
    "sweep.prep": ["fields"],
    "sweep.kernel": ["pack", KERNEL],
    "sweep.update": ["index_put"],
}
# device us of each event, by section
US = {"global.stats": 3.0, "global.evo_moves": 5.0,
      "global.pop_moves": 7.0, "global.ledger": 11.0, "sweep.prep": 13.0,
      "sweep.kernel": 17.0, "sweep.update": 19.0}


# an mpox boundary: no hky kernel; global.evo_moves is the partitioned
# statistics (two events) and the rounds (three), each counted apart too
BOUNDARY_MPOX = dict(BOUNDARY, **{
    "global.evo_moves": ["prefix_beta", "Ttwiddle_beta", "gamma", "where",
                         "argmax"]})
SUBCOUNTS_MPOX = {"ops.mpox.stats": 2, "ops.mpox.rounds": 3}


def _dispatch(boundaries, ops=True, boundary=BOUNDARY, subcounts=None):
    launches = {"sweep_chain": boundaries, "exp_pop_chain": boundaries}
    if boundary is BOUNDARY:
        launches["hky_chain"] = boundaries
    if ops:
        launches.update({"ops." + s: boundaries * len(ev)
                         for s, ev in boundary.items()})
        launches.update({k: boundaries * n
                         for k, n in (subcounts or {}).items()})
    return {"boundaries": boundaries, "launches": launches,
            "shapes": {"P": 8, "NC": 64, "MC": 80, "C": 400, "N": 161,
                       "n_inner": 80, "n_blocks": 24, "fsize": 8,
                       "knots": 0}}


def _rec(dispatches=(2, 1), ops=True, spans=(), boundary=BOUNDARY,
         subcounts=None):
    """A slice of dispatches of these many boundaries: the copy-in, the
    boundaries with the replay's prologue fills before each, the
    hand-off."""
    device, t = [], 0.0

    def event(name, us):
        nonlocal t
        device.append((name, t, us))
        t += us + 1.0

    for b in dispatches:
        event("Memcpy DtoD", 0.5)
        for _ in range(b):
            for _ in range(_sections.PROLOGUE):
                event("fill", 0.25)
            for s, names in boundary.items():
                for n in names:
                    event(n, US[s])
        event("cat", 0.75)
    return {"device": device,
            "dispatches": [_dispatch(b, ops, boundary, subcounts)
                           for b in dispatches],
            "spans": list(spans), "slice": (0.0, 1000.0),
            "window_s": 1e-3, "busy_s": sum(e[2] for e in device) * 1e-6,
            "capture_ms": [], "calls": 1}


def _read(name, rec):
    return br.reader(br.os.path.join(br.HERE, "metrics"), name)(rec)


def test_sections_label_each_boundary():
    rec = _rec()
    got = _sections.section_us(rec)
    assert got["boundaries"] == 3
    assert got["left_out"] == [0, 0]
    assert got["us"] == {s: 3 * US[s] * len(BOUNDARY[s]) for s in US}
    assert got["unlabelled_us"] == pytest.approx(
        2 * 0.5 + 3 * _sections.PROLOGUE * 0.25 + 2 * 0.75)
    total = sum(e[2] for e in rec["device"])
    assert sum(got["us"].values()) + got["unlabelled_us"] == pytest.approx(
        total)
    per = {s: US[s] * len(BOUNDARY[s]) * 1e-3 for s in US}
    assert _read("global_moves_device_ms.exp", rec) == pytest.approx(
        sum(v for s, v in per.items() if s.startswith("global.")))
    assert _read("model_moves_device_ms.skygrid-alphanu",
                 rec) == pytest.approx(per["global.evo_moves"]
                                       + per["global.pop_moves"])
    assert _read("sweep_prep_device_ms.exp", rec) == pytest.approx(
        per["sweep.prep"] + per["sweep.update"])
    assert _read("global_moves_ops_per_boundary.exp", rec) == 6.0


@pytest.mark.parametrize("fault", ["extra_event", "moved_event",
                                   "missing_anchor", "counts_indivisible",
                                   "one_node_too_many", "no_spaced_dispatch"])
def test_misaligned_slices_read_none(fault):
    rec = _rec()
    dev = rec["device"]
    anchors = [i for i, e in enumerate(dev) if e[0] == KERNEL]
    if fault == "extra_event":
        # an event inside the second boundary shifts its edges
        dev.insert(anchors[1] - 4, ("stray", dev[anchors[1] - 4][1] - 0.1,
                                    1.0))
    elif fault == "moved_event":
        i = anchors[1] - 7
        dev[i], dev[i + 1] = ((dev[i + 1][0], dev[i][1], dev[i + 1][2]),
                              (dev[i][0], dev[i + 1][1], dev[i][2]))
    elif fault == "missing_anchor":
        del dev[anchors[2]]
    elif fault == "counts_indivisible":
        rec["dispatches"][0]["launches"]["ops.sweep.prep"] += 1
    elif fault == "one_node_too_many":
        # every boundary counts one node more than its graph holds: the
        # windows shift alike and tile, and only the anchors' spacing
        # tells
        for d in rec["dispatches"]:
            d["launches"]["ops.sweep.prep"] += d["boundaries"]
    else:
        # no dispatch of two boundaries whose anchors check the counts
        rec = _rec(dispatches=(1, 1))
    assert _sections.section_us(rec) is None
    for name in ("global_moves_device_ms", "model_moves_device_ms",
                 "sweep_prep_device_ms"):
        assert _read(name + ".exp", rec) is None


def test_a_rare_swap_at_an_edge_leaves_its_boundary_out():
    """Neighbouring events a few us apart may swap on the profiler's device
    clock: a boundary that shows them swapped at a section edge is left
    out, and the others read as before; one in twenty may be left out."""
    clean = _rec(dispatches=(40,))
    rec = _rec(dispatches=(40,))
    dev = rec["device"]
    anchors = [i for i, e in enumerate(dev) if e[0] == KERNEL]
    i = anchors[3] - 2                       # "fields" | "pack"
    dev[i], dev[i + 1] = ((dev[i + 1][0], dev[i][1], dev[i + 1][2]),
                          (dev[i][0], dev[i + 1][1], dev[i][2]))
    got = _sections.section_us(rec)
    assert got["boundaries"] == 39
    assert got["left_out"] == [1]
    want = _sections.section_us(clean)
    assert {s: v / 39 for s, v in got["us"].items()} == pytest.approx(
        {s: v / 40 for s, v in want["us"].items()})
    total = sum(e[2] for e in dev)
    assert sum(got["us"].values()) + got["unlabelled_us"] == pytest.approx(
        total)
    for name in ("global_moves_device_ms", "sweep_prep_device_ms"):
        assert _read(name + ".exp", rec) == pytest.approx(
            _read(name + ".exp", clean))
    for b in (5, 7):                          # three of forty: too many
        j = anchors[b] - 2
        dev[j], dev[j + 1] = ((dev[j + 1][0], dev[j][1], dev[j + 1][2]),
                              (dev[j][0], dev[j + 1][1], dev[j][2]))
    assert _sections.section_us(rec) is None


def test_new_readers_read_none_on_the_parent():
    """A program without the section counts and spans: nothing to read."""
    rec = _rec(ops=False, spans=[("bench.dispatch", 10.0, 400.0),
                                 ("bench.topology_burst", 500.0, 900.0)])
    for name in ("global_moves_ops_per_boundary", "global_moves_device_ms",
                 "model_moves_device_ms", "sweep_prep_device_ms",
                 "dispatch_enqueue_pct", "burst_moves_pct"):
        assert _read(name + ".exp", rec) is None, name


def test_span_readers_share_of_the_slice():
    spans = [("delphy.dispatch", 100.0, 300.0),
             ("delphy.dispatch", 900.0, 1100.0),      # cut at the slice
             ("delphy.burst", 400.0, 800.0),
             ("delphy.burst.moves", 450.0, 700.0),
             ("bench.slice", 0.0, 1000.0)]
    rec = _rec(spans=spans)
    assert _read("dispatch_enqueue_pct.exp", rec) == pytest.approx(30.0)
    assert _read("burst_moves_pct.skygrid-alphanu", rec) == pytest.approx(
        25.0)


@pytest.mark.parametrize("name", ["device_ops_per_boundary.exp",
                                  "kernels_roofline_pct.exp",
                                  "device_idle_pct.exp",
                                  "burst_wall_pct.exp"])
def test_existing_readers_unmoved_by_the_section_counts(name):
    spans = [("bench.topology_burst", 400.0, 800.0)]
    with_ops, without = _rec(spans=spans), _rec(ops=False, spans=spans)
    a, b = _read(name, with_ops), _read(name, without)
    assert a is not None and a == b


def test_mpox_readers_on_an_mpox_record():
    """An mpox slice: ``mpox_moves_device_ms`` reads ``global.evo_moves``,
    ``mpox_rounds_ops_per_boundary`` the rounds' count a boundary, and the
    subcounts move none of the section readers nor the global moves'
    count."""
    rec = _rec(boundary=BOUNDARY_MPOX, subcounts=SUBCOUNTS_MPOX)
    plain = _rec(boundary=BOUNDARY_MPOX)
    evo = len(BOUNDARY_MPOX["global.evo_moves"]) * US["global.evo_moves"]
    assert _read("mpox_moves_device_ms.skygrid-alphanu",
                 rec) == pytest.approx(evo * 1e-3)
    assert _read("mpox_rounds_ops_per_boundary.skygrid-alphanu", rec) == 3.0
    assert _read("global_moves_ops_per_boundary.skygrid-alphanu", rec) == 10.0
    assert _sections.section_us(rec) == _sections.section_us(plain)
    for name in ("global_moves_device_ms", "model_moves_device_ms",
                 "sweep_prep_device_ms", "kernels_roofline_pct",
                 "device_ops_per_boundary"):
        got = _read(name + ".skygrid-alphanu", rec)
        assert got is not None and got == _read(
            name + ".skygrid-alphanu", plain), name


def test_mpox_rounds_reader_reads_none_on_the_parent():
    """A program that counts sections but no subcounts (the parent) gives
    the rounds' count nothing to read; the section reader still reads its
    section."""
    rec = _rec(boundary=BOUNDARY_MPOX)
    assert _read("mpox_rounds_ops_per_boundary.skygrid-alphanu", rec) is None
    assert _read("mpox_moves_device_ms.skygrid-alphanu", rec) is not None
    assert _read("mpox_moves_device_ms.skygrid-alphanu",
                 _rec(ops=False)) is None
