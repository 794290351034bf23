"""The mpox model's pieces of the benchmark alone: the generator of
APOBEC3-shaped genomes, the partition table the reference reads off the
first tip, the count of sites where the program's table departs from it,
and the parameters the model holds to moving."""

from __future__ import annotations

import numpy as np
import pytest

from benchmarks import datasets
from benchmarks import run as br
from benchmarks.frozen import maple, sim, sim_apobec
from benchmarks.reference import judge
from benchmarks.reference import ledger as ref
from benchmarks.tests.tiny import TINY_MPOX_DATA

HMPXV = dict(num_tips=60, num_sites=30000, mu=2e-7, rho=40.0,
             pi=(0.33, 0.17, 0.17, 0.33), sample_window_days=180.0,
             coalescent_n0=200.0, missing_fraction=0.02)


def apobec_share(ref_seq, deltas) -> tuple:
    """(differences, the share of them that are C->T or G->A at a site of
    partition 1 of the root)."""
    part = ref.apobec_partition(ref_seq)
    n = apo = 0
    for tip in deltas:
        for site, b in tip:
            n += 1
            a = ref_seq[site]
            apo += bool(part[site]) and (a, b) in ((ref.C, ref.T),
                                                   (ref.G, ref.A))
    return n, apo / n


@pytest.mark.parametrize("seed", [1, 2, 2 ** 31 + 3])
def test_generator_repeats_itself_and_has_the_mpox_shape(seed):
    got = sim_apobec.simulate_apobec_dataset(**HMPXV, seed=seed)
    again = sim_apobec.simulate_apobec_dataset(**HMPXV, seed=seed)
    assert np.array_equal(got[0], again[0]) and got[1:] == again[1:]
    ref_seq, deltas, miss = got[0], got[1], got[2]
    # partition 1: P(T before) P(C or T) + P(A after) P(G or A) = 0.33
    assert 0.32 < ref.apobec_partition(ref_seq).mean() < 0.34
    # 2 rho on ~11% of the sites against 1 on all: ~90% APOBEC3-type
    n, share = apobec_share(ref_seq, deltas)
    assert n > 300 and 0.8 < share < 0.98
    assert miss[0] == [] and sum(bool(m) for m in miss) > 20
    for tip, ivs in zip(deltas, miss):
        assert not any(s <= site < e for site, _ in tip for s, e in ivs)


def test_generator_draws_the_tree_as_the_hky_simulator():
    """Same seed, same root and tip dates as ``sim.simulate_dataset``."""
    kw = dict(num_tips=25, num_sites=400, pi=(0.3, 0.2, 0.2, 0.3),
              sample_window_days=90.0, coalescent_n0=50.0, seed=9)
    got = sim_apobec.simulate_apobec_dataset(mu=1e-4, rho=5.0, **kw)
    want = sim.simulate_dataset(mu=1e-4, **kw)
    assert np.array_equal(got[0], want[0]) and got[3] == want[3]


def test_the_first_tip_decides_the_sites_it_observes():
    # ref T C A G A T T C; the first tip has site 3 missing and site 6
    # changed from T to G
    ds = maple.Dataset(ref_seq=np.array([3, 1, 0, 2, 0, 3, 3, 1], np.int8),
                       names=["a", "b"], dates=[(0.0, 0.0)] * 2,
                       deltas=[[(6, 2)], []], miss=[[(3, 4)], []])
    part, decided = ref.mpox_partition(ds)
    # the tip reads T C A ? A T G C: C after T (1); A before ? and ?
    # (undecided); the rest decided 0
    assert part.tolist() == [0, 1, 0, 0, 0, 0, 0, 0]
    assert decided.tolist() == [1, 1, 0, 0, 1, 1, 1, 1]
    assert ref.apobec_partition(ds.ref_seq).tolist() == [0, 1, 0, 1, 0, 0,
                                                         1, 1]
    params = {"part": part.copy()}
    assert judge.partition(params, ds, True)[0] == 0
    params["part"][2:4] = 1           # undecided sites: the program's stand
    faults, used = judge.partition(params, ds, True)
    assert faults == 0 and used.tolist() == [0, 1, 1, 1, 0, 0, 0, 0]
    params["part"][1] = 0
    assert judge.partition(params, ds, True)[0] == 1
    assert judge.partition(params, ds, False)[0] == 2
    assert judge.partition({"part": part[:5]}, ds, True)[0] == 8


def test_mpox_holds_mu_and_rho_to_moving():
    start = {"mu": 1e-6, "kappa": 1.0, "rho": 3.0, "alpha": 10.0,
             "nu": np.ones(4), "pop": {"model": "exp", "n0": 5.0, "g": 0.1}}
    end = dict(start, mu=2e-6, rho=4.0, pop={"model": "exp", "n0": 6.0,
                                              "g": 0.2})
    assert judge.unmoved(start, end, {}, mpox=True) == 0
    # without the mpox model kappa is a key, and it has not moved
    assert judge.unmoved(start, end, {}) == 1
    assert judge.unmoved(start, dict(end, rho=3.0), {}, mpox=True) == 1
    assert judge.unmoved(start, dict(end, mu=1e-6, rho=3.0), {},
                         mpox=True) == 2
    assert judge.unmoved(start, dict(end, nu=np.ones(4)),
                         {"alpha_move_enabled": True}, mpox=True) == 2


def test_the_dataset_kind_is_cached_and_read_back():
    cfg = {"name": "tiny-apobec-30x600", "dataset": TINY_MPOX_DATA}
    made = datasets.load(cfg, br.ROOT)
    again = datasets.load(cfg, br.ROOT)
    direct = sim_apobec.simulate_apobec_dataset(
        **{k: v for k, v in TINY_MPOX_DATA.items() if k != "kind"})
    for ds in (made, again):
        assert np.array_equal(ds.ref_seq, direct[0])
        assert ds.deltas == direct[1] and ds.miss == direct[2]
        assert ds.dates == direct[3] and ds.names == direct[4]
