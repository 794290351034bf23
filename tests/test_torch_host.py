"""The port's own host layer against the JAX package's: the same MAPLE read,
the same initial tree, the same native topology burst from the same tree and
seed, and the same partitioned burst.  Also: the port's entry points default
to the CUDA device and raise without one."""

import os

import numpy as np
import pytest
import torch

from delphy_tpu.init_tree import build_initial_tree as j_build_initial_tree
from delphy_tpu.io.maple import read_maple as j_read_maple
from delphy_tpu.native import run_burst_native as j_run_burst_native
from delphy_tpu.topo.mixer import HostExpPop as JHostExpPop
from delphy_tpu.topo.parallel import (run_partitioned_bursts as
                                      j_run_partitioned_bursts)

from delphy_tpu_torch import convert, evo, state
from delphy_tpu_torch.init_tree import build_initial_tree
from delphy_tpu_torch.io.maple import read_maple
from delphy_tpu_torch.native import run_burst_native
from delphy_tpu_torch.run import Run
from delphy_tpu_torch.topo.mixer import HostExpPop
from delphy_tpu_torch.topo.parallel import run_partitioned_bursts

MAPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "ebola2014_like_81x18959.maple")


def _build(read, build, n_tips=None):
    mf = read(MAPLE)
    tips = mf.tips[:n_tips] if n_tips else mf.tips
    tree = build(mf.ref_seq, [t.deltas for t in tips],
                 [t.miss_intervals for t in tips],
                 [(t.t_min, t.t_max) for t in tips],
                 names=[t.name for t in tips], rng=np.random.default_rng(42))
    return mf, tree


def _assert_same_tree(got, want):
    for f in ("parent", "children", "t", "t_min", "t_max", "ref_seq"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.root == want.root
    assert got.name == want.name
    for n in range(want.num_nodes):
        assert [(m.site, m.from_, m.to, m.t) for m in got.mutations[n]] == \
            [(m.site, m.from_, m.to, m.t) for m in want.mutations[n]], n
        assert got.miss_intervals[n] == want.miss_intervals[n], n
        assert got.miss_from_states[n] == want.miss_from_states[n], n


@pytest.fixture(scope="module")
def ebola():
    mf_j, tree_j = _build(j_read_maple, j_build_initial_tree)
    mf, tree = _build(read_maple, build_initial_tree)
    return mf_j, tree_j, mf, tree


def test_read_maple_matches_jax(ebola):
    mf_j, _, mf, _ = ebola
    assert mf.ref_id == mf_j.ref_id
    np.testing.assert_array_equal(mf.ref_seq, mf_j.ref_seq)
    assert len(mf.tips) == len(mf_j.tips) == 81
    for a, b in zip(mf.tips, mf_j.tips):
        assert (a.name, a.t_min, a.t_max, a.deltas, a.miss_intervals) == \
            (b.name, b.t_min, b.t_max, b.deltas, b.miss_intervals)


def test_initial_tree_matches_jax(ebola):
    _, tree_j, _, tree = ebola
    tree.check_integrity()
    _assert_same_tree(tree, tree_j)


def _burst_args(tree):
    L = tree.num_sites
    q = np.array([[-1.0, 0.2, 0.6, 0.2], [0.2, -1.0, 0.2, 0.6],
                  [0.6, 0.2, -1.0, 0.2], [0.2, 0.6, 0.2, -1.0]])
    return dict(mu=1e-3 / 365.0, nu=np.ones(L), q=q, pi=np.full(4, 0.25),
                part=np.zeros(L, np.int32), q_tab=q[None])


def test_native_burst_matches_jax(ebola):
    _, tree_j, _, tree = ebola
    a, b = tree.copy(), tree_j.copy()
    kw = _burst_args(a)
    t_max_tip = float(np.max(a.t_max[:a.num_tips]))
    pop = (t_max_tip, 1000.0, 0.002, 1.0)
    got = run_burst_native(a, 2000, kw["mu"], kw["nu"], kw["q"], kw["pi"],
                           HostExpPop(*pop), seed=1234, can_change_root=True,
                           num_cells=400, t_max_tip=t_max_tip,
                           part=kw["part"], q_tab=kw["q_tab"])
    want = j_run_burst_native(b, 2000, kw["mu"], kw["nu"], kw["q"],
                              kw["pi"], JHostExpPop(*pop), seed=1234,
                              can_change_root=True, num_cells=400,
                              t_max_tip=t_max_tip, part=kw["part"],
                              q_tab=kw["q_tab"])
    assert got is not None and got == want
    assert got[2] > 0                      # some moves were accepted
    a.check_integrity()
    _assert_same_tree(a, b)


def test_partitioned_burst_matches_jax(ebola):
    _, tree_j, _, tree = ebola
    a, b = tree.copy(), tree_j.copy()
    kw = _burst_args(a)
    pop = (float(np.max(a.t_max[:a.num_tips])), 1000.0, 0.002, 1.0)
    got = run_partitioned_bursts(a, 3000, 4, HostExpPop(*pop), kw["mu"],
                                 kw["nu"], kw["q"], kw["pi"],
                                 np.random.default_rng(9), part=kw["part"],
                                 q_tab=kw["q_tab"])
    want = j_run_partitioned_bursts(b, 3000, 4, JHostExpPop(*pop), kw["mu"],
                                    kw["nu"], kw["q"], kw["pi"],
                                    np.random.default_rng(9),
                                    part=kw["part"], q_tab=kw["q_tab"])
    assert got == want and got[2] > 0
    _assert_same_tree(a, b)


@pytest.mark.parametrize("entry", ["Run", "pack_state", "make_evo_params",
                                   "tree_state_to_torch"])
def test_entry_points_default_to_cuda(ebola, entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, _, tree = ebola
    call = {
        "Run": lambda: Run(tree, seed=1, num_cells=64),
        "pack_state": lambda: state.pack_state(tree),
        "make_evo_params": lambda: evo.make_evo_params(tree.num_sites),
        "tree_state_to_torch": lambda: convert.tree_state_to_torch(
            state.pack_state(tree, device="cpu")),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
