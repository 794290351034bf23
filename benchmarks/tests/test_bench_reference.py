"""The NumPy reference against the port's own from-scratch ledger, and its
refusal of tampered states.  These tests import the port; the reference
does not."""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import pytest

from benchmarks import datasets
from benchmarks import run as br
from benchmarks.reference import judge
from benchmarks.reference import ledger as ref
from benchmarks.tests.tiny import TINY_DATA

VARIANTS = {
    "exp": ({"pop_model": "exp"}, {}),
    "staircase": ({"pop_model": "skygrid", "skygrid_type": 1,
                   "skygrid_num_parameters": 12}, {}),
    "log-linear": ({"pop_model": "skygrid", "skygrid_type": 2,
                    "skygrid_num_parameters": 12},
                   {"skygrid_tau_move_enabled": True}),
    "alpha-nu": ({"pop_model": "exp"}, {"alpha_move_enabled": True}),
}


def limits() -> dict:
    with open(os.path.join(br.HERE, "limits", "ebola81-exp.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def finished(request):
    """A small run on the CPU after four calls: the dataset, the state and
    parameters as the harness reads them, the run's ledger and the port's
    own from-scratch recompute."""
    import torch

    from delphy_tpu_torch.init_tree import build_initial_tree
    from delphy_tpu_torch.mcmc.global_moves import PriorConfig
    from delphy_tpu_torch.run import Run

    kw, priors = VARIANTS[request.param]
    ds = datasets.load({"name": "tiny-sim-30x600", "dataset": TINY_DATA},
                       br.ROOT)
    tree = build_initial_tree(ds.ref_seq, ds.deltas, ds.miss, ds.dates,
                              names=ds.names, rng=np.random.default_rng(3))
    run = Run(tree, seed=3, num_cells=400, device="cpu",
              dtype=torch.float64, hyp=PriorConfig(**priors), **kw)
    start = br.params_of(run.host_view())
    for _ in range(4):
        run.do_mcmc_steps(4 * run.local_moves_per_global_move)
    hv = run.host_view()
    mine = run.calc_cur_ledger()
    port = {k: float(getattr(mine, k))
            for k in ("log_G", "log_coal", "log_other")}
    settings = {"num_cells": 400, "t_max_tip": max(h for _, h in ds.dates),
                "priors": priors}
    return {"ds": ds, "state": br.state_of(run.tree()),
            "params": br.params_of(hv), "ledger": br.ledger_of(hv),
            "port": port, "settings": settings, "start": start}


def ref_terms(f) -> dict:
    bad = {"mutation_state": 0, "mutation_time": 0,
           "mutation_at_missing_site": 0}
    walked = ref.walk(f["state"], f["ds"], bad)
    assert bad == dict.fromkeys(bad, 0)
    s = f["settings"]
    return {"log_G": ref.log_G(f["state"], f["params"], walked),
            "log_coal": ref.log_coal(f["state"], f["params"]["pop"],
                                     s["t_max_tip"], s["num_cells"]),
            "log_other": ref.log_other(f["params"], s["priors"])}


def test_ledger_agrees_with_the_ports_recompute(finished):
    got = ref_terms(finished)
    for k, want in finished["port"].items():
        assert got[k] == pytest.approx(want, rel=1e-11, abs=1e-9), k


def test_sound_state_is_correct(finished):
    f = finished
    nums = judge.numbers(f["state"], f["params"], f["ledger"], f["ds"],
                         f["settings"], f["start"], [0])
    correct, rows = judge.verdict(nums, limits())
    assert correct, rows


def judged(f, state=None, ledger=None, unmoved=(0,)) -> dict:
    nums = judge.numbers(state or f["state"], f["params"],
                         ledger or f["ledger"], f["ds"], f["settings"],
                         f["start"], list(unmoved))
    assert not judge.verdict(nums, limits())[0]
    return nums


def test_rejects_a_moved_mutation(finished):
    st = copy.deepcopy(finished["state"])
    n = next(n for n, ms in enumerate(st["mutations"])
             if ms and n != st["root"])
    site, frm, to, t = st["mutations"][n][0]
    st["mutations"][n][0] = ((site + 1) % len(st["ref_seq"]), frm, to, t)
    nums = judged(finished, state=st)
    assert nums["mutation_faults"] + nums["tip_mismatches"] > 0


def test_rejects_a_changed_node_time(finished):
    st = copy.deepcopy(finished["state"])
    st["t"] = st["t"].copy()
    st["t"][st["root"]] -= 1.0
    nums = judged(finished, state=st)
    assert nums["log_G_gap"] > limits()["log_G_gap"]
    assert nums["log_coal_gap"] > limits()["log_coal_gap"]


@pytest.mark.parametrize("term", ["log_G", "log_coal", "log_other"])
def test_rejects_a_perturbed_ledger(finished, term):
    led = dict(finished["ledger"])
    led[term] += 1e-6 * max(1.0, abs(led[term]))
    nums = judged(finished, ledger=led)
    assert nums[term + "_gap"] > limits()[term + "_gap"]


@pytest.mark.parametrize("unmoved", [[], [0, 10 ** 6]])
def test_rejects_a_dispatch_that_left_the_tree(finished, unmoved):
    """No judged dispatch, or one that left more inner nodes unmoved than
    the cell's limit."""
    nums = judged(finished, unmoved=unmoved)
    assert nums["nodes_unmoved"] > limits()["nodes_unmoved"]


def test_hky_matches_the_simulators_matrix():
    from benchmarks.frozen import sim
    pi = np.array([0.1, 0.2, 0.3, 0.4])
    assert np.allclose(ref.hky_q(2.5, pi), sim.hky_q(2.5, pi), rtol=1e-14,
                       atol=0)
