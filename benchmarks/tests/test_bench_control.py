"""The comparison fails what it must: the control (the program in float32,
the precision below the configuration's float64) and each fault a cell can
have (``faults.py``), planted under the timed path of a CPU dry run with
everything else of a run as the benchmark drives it; the mpox model's
faults in a tiny cell that runs it.  The exchange between chips is no fault
of these cells: each runs on one chip."""

from __future__ import annotations

import pytest

from benchmarks.tests.faults import FAULTS, MPOX_FAULTS, planted
from benchmarks.tests.tiny import MPOX, tiny_run

CELLS = ("ebola81-exp", "ebola81-skygrid", "ebola81-alphanu", MPOX)


def gaps_over(res) -> list:
    c = res["checks"]
    return [k for k in ("log_G_gap", "log_coal_gap", "log_other_gap")
            if c[k]["value"] > c[k]["limit"]]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = tiny_run(cell, seed=2 ** 32 + 11)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    res = tiny_run(cell, seed=2 ** 32 + 12, control=True)
    assert not res["correct"]
    assert gaps_over(res), res["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault):
    with planted(fault):
        res = tiny_run("ebola81-exp", seed=2 ** 32 + 13)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(MPOX_FAULTS))
def test_mpox_fault_is_not_correct(fault):
    with planted(fault):
        res = tiny_run(MPOX, seed=2 ** 32 + 14)
    assert not res["correct"], res["checks"]
    c = {k: v["value"] for k, v in res["checks"].items()}
    caught = {"partition_flipped": c["partition_faults"] == 1,
              "rho_off": c["log_G_gap"] > res["checks"]["log_G_gap"]["limit"],
              "rho_unmoved": c["params_unmoved"] == 1}
    assert caught[fault], c
