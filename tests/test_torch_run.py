"""The port's blocking Run against the JAX package's: identical partition
maps for the same tree and seed (the host draws are shared), and after
dispatches and a topology burst a green ledger whose from-scratch recompute
equals the JAX recompute on the same state."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from delphy_tpu import evo as jevo
from delphy_tpu import pop as jpop
from delphy_tpu import state as jstate
from delphy_tpu.init_tree import build_initial_tree
from delphy_tpu.io.maple import read_maple
from delphy_tpu.run import Run as JRun, _calc_ledger_jit
from delphy_tpu.sim import simulate_dataset

from delphy_tpu_torch import convert
from delphy_tpu_torch.parallel import _cuda
from delphy_tpu_torch.run import Run

MAPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "ebola2014_like_81x18959.maple")


def _sim_tree(seed):
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        20, 300, mu=1e-3, sample_window_days=300.0, missing_fraction=0.02,
        seed=seed)
    return build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(seed))


def _ebola_tree():
    mf = read_maple(MAPLE)
    tips = mf.tips
    return build_initial_tree(mf.ref_seq, [t.deltas for t in tips],
                              [t.miss_intervals for t in tips],
                              [(t.t_min, t.t_max) for t in tips],
                              names=[t.name for t in tips],
                              rng=np.random.default_rng(42))


@pytest.mark.parametrize("case", ["sim", "ebola"])
def test_initial_part_maps_match_jax(case):
    if case == "sim":
        tree, kw = _sim_tree(41), dict(seed=41, num_cells=200,
                                       device_partitions=4)
    else:
        tree, kw = _ebola_tree(), dict(seed=1, num_cells=400)
    jrun = JRun(tree, **kw)
    run = Run(tree, **kw, device="cpu")
    assert run.device_partitions == jrun.device_partitions
    pm_j = jax.device_get(jrun.pm)
    for f in pm_j._fields:
        w = np.asarray(getattr(pm_j, f))
        g = getattr(run.pm, f).numpy()
        assert g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    for f in jstate.TreeState._fields:
        np.testing.assert_array_equal(getattr(run.ts, f).numpy(),
                                      np.asarray(getattr(jrun.ts, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(run.evo.pi.numpy(), np.asarray(jrun.evo.pi))
    assert run.local_moves_per_global_move == jrun.local_moves_per_global_move
    assert run.topology_burst_chunks == jrun.topology_burst_chunks
    # the host generator is in the same state after construction
    assert run.host_rng.integers(2 ** 62) == jrun.host_rng.integers(2 ** 62)


@pytest.fixture(scope="module")
def stepped_run():
    _cuda.reset_launch_counts()
    run = Run(_sim_tree(23), seed=23, num_cells=200, device_partitions=4,
              device="cpu")
    lm = run.local_moves_per_global_move
    run.do_mcmc_steps(3 * lm)
    run.do_mcmc_steps(2 * lm)
    return run


def test_run_dispatches_bursts_and_ledger(stepped_run):
    run = stepped_run
    assert run.dispatch_count >= 2
    assert run.burst_count >= 1 and run.topology_proposed > 0
    assert run.local_moves_attempted > 0
    run.check_derived_quantities(1e-6)
    tree = run.tree()
    tree.check_integrity()
    assert np.all(np.isfinite(tree.t))
    assert np.isfinite(run.log_posterior)
    assert "log_post" in run.stats_line()
    # on CPU tensors the wrappers ran the plain versions: no kernel launch
    assert all(v == 0 for v in _cuda.launch_counts.values())


def test_run_ledger_recompute_matches_jax(stepped_run):
    run = stepped_run
    ts = jstate.TreeState(**{k: jnp.asarray(v) for k, v in
                             convert.to_numpy(run.ts).items()})
    evo = jevo.EvoParams(**{k: jnp.asarray(v) for k, v in
                            convert.to_numpy(run.evo).items()})
    pop = jpop.ExpPopParams(**{k: jnp.asarray(v) for k, v in
                               convert.to_numpy(run.pop).items()})
    from delphy_tpu.mcmc.global_moves import PriorConfig as JPriorConfig
    want = _calc_ledger_jit(ts, evo, pop, jnp.float64(run.t_max_tip),
                            run.num_cells, JPriorConfig())
    got = run.calc_cur_ledger()
    for f in got._fields:
        assert float(getattr(got, f)) == pytest.approx(
            float(getattr(want, f)), rel=1e-10), f


def test_run_requires_cuda_when_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Run(_sim_tree(23), seed=1, num_cells=64, device="cuda")
