"""The JAX ``Run``'s remaining switches in the port's ``Run``, each against
the JAX ``Run``'s own choice on the same tree and seed:

- ``Run(topology_parallel_processes=False)``: partitioned Python-mixer
  bursts in this process, bit-equal to the same run on the worker pool;
  kept by the port's snapshot and read from a JAX snapshot;
- ``DELPHY_TPU_TOPO_PARTS`` and ``DELPHY_TPU_TOPO_SINGLE`` (the topology
  parts and the burst's path), ``DELPHY_TPU_MAX_DISPATCH_MOVES`` (both
  drivers' dispatch sizes) and ``DELPHY_TPU_RESTENCIL`` (the restencil
  cadence): the dispatches are stand-ins that return their inputs, so the
  drivers' choices are compared without running a sweep;
- ``DELPHY_TPU_CPB`` (cells per colour block), read at import: a child
  process imports both packages under it; a value below 6 takes the sweep
  kernel's per-cell scatter on the card, and a boundary on the CPU keeps
  its ledger.
"""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import delphy_tpu.run as jrun_mod
from delphy_tpu.io import snapshot as jsnapshot
from delphy_tpu.parallel import sweep as jsweep

import delphy_tpu_torch.native as native
from delphy_tpu_torch import convert
from delphy_tpu_torch import run as run_mod
from delphy_tpu_torch.init_tree import build_initial_tree
from delphy_tpu_torch.io import snapshot
from delphy_tpu_torch.sim import simulate_dataset
from delphy_tpu_torch.topo import parallel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = ("DELPHY_TPU_RESTENCIL", "DELPHY_TPU_MAX_DISPATCH_MOVES",
       "DELPHY_TPU_TOPO_PARTS", "DELPHY_TPU_TOPO_SINGLE",
       "DELPHY_TPU_OVERLAP")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)


def _tree(seed=23, tips=20):
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        tips, 300, mu=1e-3, sample_window_days=300.0, missing_fraction=0.02,
        seed=seed)
    return build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(seed))


def _pair(tips=20, **kw):
    tree = _tree(tips=tips)
    kw = dict(seed=23, num_cells=128, **kw)
    return jrun_mod.Run(tree, **kw), run_mod.Run(tree, device="cpu", **kw)


# ---------------------------------------------------------------------------
# topology_parallel_processes
# ---------------------------------------------------------------------------

@pytest.fixture
def python_mixer(monkeypatch):
    """The native topology kernel forced off and the port's worker pool
    usable; the pool is shut afterwards."""
    monkeypatch.setattr(native, "native_available", lambda: False)
    monkeypatch.setattr(run_mod, "run_burst_native", lambda *a, **kw: None)
    monkeypatch.setattr(parallel, "_pool_usable", lambda: True)
    yield
    if parallel._POOL is not None:
        parallel._POOL.terminate()
        parallel._POOL.join()
        parallel._POOL = None


def test_topology_parallel_processes_false_runs_the_bursts_in_process(
        python_mixer):
    """False: the partitioned Python-mixer burst runs in this process (no
    pool), and the run equals the same run with the pool, bit for bit."""
    tree = _tree()
    runs = []
    for flag in (False, True):
        run = run_mod.Run(tree, seed=23, num_cells=128, device="cpu",
                          topology_partitions=4,
                          topology_parallel_processes=flag)
        assert run.topology_parallel_processes is flag
        run.do_mcmc_steps(2 * run.local_moves_per_global_move)
        assert run.burst_count >= 1 and run.topology_accepted > 0
        assert (parallel._POOL is not None) == flag
        run.check_derived_quantities(1e-6)
        runs.append(run)
    a, b = runs
    for f in a.ts._fields:
        assert torch.equal(getattr(a.ts, f), getattr(b.ts, f)), f
    assert (a.topology_accepted, a.topology_proposed) == \
        (b.topology_accepted, b.topology_proposed)
    assert float(a.ledger.log_G) == float(b.ledger.log_G)
    assert a.host_rng.integers(2 ** 62) == b.host_rng.integers(2 ** 62)


@pytest.mark.parametrize("flag", [False, True])
def test_snapshots_keep_topology_parallel_processes(tmp_path, flag):
    """The port's snapshot round trip keeps the flag, and a JAX snapshot
    saved with it loads with it."""
    jrun, run = _pair(topology_parallel_processes=flag)
    path = tmp_path / "port.npz"
    snapshot.save_run(run, path)
    assert snapshot.load_run(path, device="cpu") \
        .topology_parallel_processes is flag
    jpath = tmp_path / "jax.npz"
    jsnapshot.save_run(jrun, jpath)
    assert convert.load_jax_snapshot(jpath, device="cpu") \
        .topology_parallel_processes is flag


# ---------------------------------------------------------------------------
# environment overrides
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env,parts", [(None, 0), ("5", 0), ("5", 3),
                                       ("1", 0)])
def test_topo_parts_override(monkeypatch, env, parts):
    if env is not None:
        monkeypatch.setenv("DELPHY_TPU_TOPO_PARTS", env)
    jrun, run = _pair(topology_partitions=parts)
    assert run._topology_num_parts() == jrun._topology_num_parts()
    want = parts or (int(env) if env else None)
    if want:
        assert run._topology_num_parts() == want


class _Stop(Exception):
    pass


@pytest.mark.parametrize("single", [None, "1", "0"])
def test_topo_single_override(monkeypatch, single):
    """The burst's path: partitioned on TOPO_PARTS parts, or one native
    burst under DELPHY_TPU_TOPO_SINGLE=1, as the JAX Run chooses."""
    import delphy_tpu.native as jnative
    import delphy_tpu.topo.parallel as jparallel
    monkeypatch.setenv("DELPHY_TPU_TOPO_PARTS", "4")
    if single is not None:
        monkeypatch.setenv("DELPHY_TPU_TOPO_SINGLE", single)
    jrun, run = _pair()
    taken = []

    def rec(name):
        def f(*a, **kw):
            taken.append(name)
            raise _Stop
        return f
    monkeypatch.setattr(jparallel, "run_partitioned_bursts", rec("parts"))
    monkeypatch.setattr(jnative, "run_burst_native", rec("single"))
    monkeypatch.setattr(run_mod, "run_partitioned_bursts", rec("parts"))
    monkeypatch.setattr(run_mod, "run_burst_native", rec("single"))
    for r in (jrun, run):
        with pytest.raises(_Stop):
            r._topology_burst(400)
    assert taken[0] == taken[1] == ("single" if single == "1" else "parts")


def _fake_dispatches(monkeypatch, jrun, run, record):
    """Stand-ins for both packages' parts_multi_super_step that record each
    dispatch's boundaries and return the state unchanged (the overlapped
    driver's L-dispatch stops the call after it is recorded)."""
    def fake(jax_side):
        def f(ts, evo, pop, key_or_gen, tin, tout, pm, n_blocks, t_max_tip,
              hyp, num_cells, boundaries, *a, **kw):
            if kw.get("param_moves") is False:
                record[jax_side].append(("L", boundaries))
                raise _Stop
            record[jax_side].append(("B", boundaries))
            att = boundaries * max(1, n_blocks) * 10
            if jax_side:
                return (ts, evo, pop, key_or_gen, None,
                        {"local_moves_attempted": jnp.asarray(att)}, None)
            return (ts, evo, pop, None,
                    {"local_moves_attempted": torch.tensor(att)}, None)
        return f
    monkeypatch.setattr(jrun_mod, "parts_multi_super_step", fake(True))
    monkeypatch.setattr(jsweep, "parts_multi_super_step", fake(True))
    monkeypatch.setattr(run_mod, "parts_multi_super_step", fake(False))
    for r, side in ((jrun, True), (run, False)):
        orig = r._repartition

        def counted(*a, _o=orig, _s=side, **kw):
            record[_s].append(("R", 0))
            return _o(*a, **kw)
        r._repartition = counted


@pytest.mark.parametrize("restencil,max_moves", [
    (None, None), ("3", None), (None, "2"), ("2", "5")])
def test_dispatch_sizes_and_restencil_cadence(monkeypatch, restencil,
                                              max_moves):
    """The blocking driver's dispatch sizes and restencils under
    DELPHY_TPU_RESTENCIL and DELPHY_TPU_MAX_DISPATCH_MOVES (in units of a
    boundary's moves) equal the JAX Run's, as do the partition maps after."""
    if restencil:
        monkeypatch.setenv("DELPHY_TPU_RESTENCIL", restencil)
    jrun, run = _pair(device_partitions=4, topology_moves_enabled=False)
    lm = run.local_moves_per_global_move
    if max_moves:
        monkeypatch.setenv("DELPHY_TPU_MAX_DISPATCH_MOVES",
                           str(int(max_moves) * lm))
    assert run.restencil_interval == jrun.restencil_interval \
        == int(restencil or 200)
    record = {True: [], False: []}
    _fake_dispatches(monkeypatch, jrun, run, record)
    for r in (jrun, run):
        r.do_mcmc_steps(11 * lm)
        r.do_mcmc_steps(4 * lm)
    assert record[False] == record[True]
    sizes = [b for k, b in record[False] if k == "B"]
    assert sum(sizes) == 15
    if restencil or max_moves:
        cap = min(int(x) for x in (restencil, max_moves) if x)
        assert max(sizes) == cap
        if restencil:
            assert ("R", 0) in record[False]
    for f in run.pm._fields:
        np.testing.assert_array_equal(getattr(run.pm, f).numpy(),
                                      np.asarray(getattr(jrun.pm, f)), f)


@pytest.mark.parametrize("restencil,max_moves", [(None, None), ("3", None),
                                                 (None, "2")])
def test_overlapped_dispatch_size(monkeypatch, restencil, max_moves):
    """The overlapped driver's L-dispatch size under the same variables
    (default cap 96M local moves) equals the JAX Run's."""
    monkeypatch.setenv("DELPHY_TPU_OVERLAP", "1")
    if restencil:
        monkeypatch.setenv("DELPHY_TPU_RESTENCIL", restencil)
    jrun, run = _pair(tips=48, device_partitions=8)
    lm = run.local_moves_per_global_move
    if max_moves:
        monkeypatch.setenv("DELPHY_TPU_MAX_DISPATCH_MOVES",
                           str(int(max_moves) * lm))
    assert run._overlap_active() and jrun._overlap_active()
    record = {True: [], False: []}
    _fake_dispatches(monkeypatch, jrun, run, record)
    for r in (jrun, run):
        with pytest.raises(_Stop):
            r.do_mcmc_steps(40 * lm)
    want = min(run.topology_burst_chunks, int(restencil or 200),
               int(max_moves or 10 ** 9), 40)
    assert record[False] == record[True]
    assert [b for k, b in record[False] if k == "L"] == [want]


_CPB_CHILD = r"""
import inspect, sys
import numpy as np
sys.path.insert(0, {repo!r})
from delphy_tpu.parallel import sweep as jsweep
from delphy_tpu_torch.parallel import block_cuda as bc, sweep
from delphy_tpu_torch.init_tree import build_initial_tree
from delphy_tpu_torch.run import Run
from delphy_tpu_torch.sim import simulate_dataset
jax_cpb = inspect.signature(jsweep._batched_displace) \
    .parameters["cells_per_block"].default
seen = []
orig = bc.pack_chain_inputs
def rec(*a, **kw):
    seen.append(kw["cpb"])
    return orig(*a, **kw)
sweep.bc.pack_chain_inputs = rec
ref, deltas, miss, dates, names, _ = simulate_dataset(
    12, 200, mu=1e-3, sample_window_days=300.0, missing_fraction=0.02,
    seed=5)
tree = build_initial_tree(ref, deltas, miss, dates, names=names,
                          rng=np.random.default_rng(5))
run = Run(tree, seed=5, num_cells=64, device="cpu",
          topology_moves_enabled=False)
run.do_mcmc_steps(2 * run.local_moves_per_global_move)
run.check_derived_quantities(1e-6)
print(jax_cpb, sweep.CELLS_PER_BLOCK, sorted(set(seen)),
      run.local_moves_attempted > 0)
"""


@pytest.mark.parametrize("cpb", [None, "4", "24"])
def test_cells_per_block_override(monkeypatch, cpb):
    """DELPHY_TPU_CPB read at import in both packages (the JAX sweep's
    default argument, the port's CELLS_PER_BLOCK), and the port's
    boundaries pack the chain with it and keep the ledger; 4 is below the
    kernel's 6, where it scatters k_p cell by cell."""
    if cpb is None:
        monkeypatch.delenv("DELPHY_TPU_CPB", raising=False)
    else:
        monkeypatch.setenv("DELPHY_TPU_CPB", cpb)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c",
                          _CPB_CHILD.format(repo=REPO)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    want = int(cpb or 16)
    assert out.stdout.split("\n")[-2] == f"{want} {want} [{want}] True"
    # this process imported both before the variable was set
    assert inspect.signature(jsweep._batched_displace).parameters[
        "cells_per_block"].default == 16
