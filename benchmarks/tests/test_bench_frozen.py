"""The benchmark's frozen copies give what the port's originals give today:
the simulator the same dataset, the MAPLE reader the same tips, the trace
arithmetic the same busy time, and the roofline counts the bytes and
operations of the port's kernel table."""

from __future__ import annotations

import os
import random

import numpy as np
import pytest

from benchmarks import run as br
from benchmarks.frozen import maple, roofline, sim, trace

EBOLA = os.path.join(br.HERE, "data", "ebola2014_like_81x18959.maple")


@pytest.mark.parametrize("kw", [
    dict(num_tips=12, num_sites=300, mu=2e-3, seed=5),
    dict(num_tips=40, num_sites=900, mu=1e-3, kappa=3.0,
         pi=(0.3, 0.2, 0.2, 0.3), sample_window_days=1200.0,
         missing_fraction=0.02, seed=77),
])
def test_simulator_matches_the_ports(kw):
    from delphy_tpu_torch.sim import simulate_dataset
    got = sim.simulate_dataset(**kw)
    want = simulate_dataset(**kw)
    assert np.array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:5]):
        assert g == w


def test_maple_reader_matches_the_ports_on_ebola():
    from delphy_tpu_torch.io.maple import read_maple
    got, want = maple.read_maple(EBOLA), read_maple(EBOLA)
    assert np.array_equal(got.ref_seq, want.ref_seq)
    assert got.names == [t.name for t in want.tips]
    assert got.dates == [(t.t_min, t.t_max) for t in want.tips]
    assert got.deltas == [t.deltas for t in want.tips]
    assert got.miss == [t.miss_intervals for t in want.tips]


def test_maple_reader_matches_the_ports_on_odd_entries(tmp_path):
    from delphy_tpu_torch.io.maple import read_maple
    path = tmp_path / "odd.maple"
    path.write_text(
        ">ref\nACGTNACGTR\nACGT\n"
        ">a|2021-03-04\nc\t1\nn\t3\t2\na\t4\n-\t9\n"       # interval merge
        ">b|2020-02\nt\t2\nt\t2\n"                          # month, spurious
        ">c|2019\ng\t5\n"                                   # blacklisted site
        ">d-2021-01-01/2021-02-01\nn\t13\t2\nq\t3\n"       # unknown entry
        ">e|2021-01-01/2021-02-01\nn\t12\t3\nx 1\n"        # range
        ">f|nodate\nc\t1\n"
        ">g|2021-12\nu\t7\nn\t6\n")
    got, want = maple.read_maple(path), read_maple(path)
    assert np.array_equal(got.ref_seq, want.ref_seq)
    assert got.names == [t.name for t in want.tips]
    assert got.dates == [(t.t_min, t.t_max) for t in want.tips]
    assert got.deltas == [t.deltas for t in want.tips]
    assert got.miss == [t.miss_intervals for t in want.tips]


def test_union_matches_the_smoke_scripts():
    import chip_smoke
    rng = random.Random(4)
    for _ in range(20):
        spans = []
        for _ in range(rng.randint(0, 30)):
            s = rng.uniform(0, 100)
            spans.append((s, s + rng.uniform(0, 10)))
        assert trace.union_us(spans) == pytest.approx(
            chip_smoke._union_us(spans), rel=1e-12, abs=1e-12)
        busy = trace.merged(spans)
        assert sum(e - s for s, e in busy) == pytest.approx(
            trace.union_us(spans), rel=1e-12, abs=1e-12)
        gaps = trace.idle_gaps(busy, 0.0, 120.0)
        covered = trace.union_us([(max(0.0, s), min(120.0, e))
                                  for s, e in spans if s < 120.0])
        assert sum(e - s for s, e in gaps) == pytest.approx(
            120.0 - covered, rel=1e-9, abs=1e-9)


def test_roofline_counts_match_the_kernel_table():
    """PERF.md's kernel table (chip_smoke phase 3 at the Ebola main path's
    shapes: P=8, NC=64, MC=80, C=400, 24 blocks, N=161 in float64)."""
    assert roofline.sweep_bytes(8, 64, 80, 400, 24, 8) == 664_184
    assert roofline.exp_pop_bytes(400, 161, 8) == 10_004
    assert roofline.exp_pop_ops(400, 80) == 1_147_260
    assert roofline.hky_bytes(8) == 888
    assert roofline.hky_ops() == 2_060
    assert roofline.hky_bytes(4) == 444
    shapes = dict(P=8, NC=64, MC=80, C=400, N=161, n_inner=80, n_blocks=24,
                  fsize=8)
    assert roofline.launch_bound_s("sweep", shapes) == pytest.approx(
        0.000198e-3, rel=0.01)
    assert roofline.launch_bound_s("exp_pop", shapes) == pytest.approx(
        0.0000337e-3, rel=0.01)
