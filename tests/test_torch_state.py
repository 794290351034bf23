"""Port (delphy_tpu_torch) state layout against the JAX package: pack_state,
unpack_state, fuse_for_host/split_for_host and the converters, all exact."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from delphy_tpu import evo as jevo
from delphy_tpu import pop as jpop
from delphy_tpu import state as jstate
from delphy_tpu.init_tree import build_initial_tree
from delphy_tpu.sim import simulate_dataset

from delphy_tpu_torch import convert, evo, pop, state


@pytest.fixture(scope="module")
def tree():
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        20, 300, mu=1e-3, sample_window_days=300.0, missing_fraction=0.05,
        seed=7)
    return build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(7))


def _params():
    pi = np.array([0.3, 0.2, 0.24, 0.26])
    e_j = jevo.make_evo_params(300, mu=2e-3, kappa=1.7, pi=pi, alpha=10.0)
    e_t = evo.make_evo_params(300, mu=2e-3, kappa=1.7, pi=pi, alpha=10.0,
                              device="cpu")
    p_j = jpop.ExpPopParams(t0=jnp.float64(3.0), n0=jnp.float64(700.0),
                            g=jnp.float64(0.002), min_pop=jnp.float64(1.0))
    f = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731
    p_t = pop.ExpPopParams(t0=f(3.0), n0=f(700.0), g=f(0.002), min_pop=f(1.0))
    return e_j, e_t, p_j, p_t


@pytest.mark.parametrize("caps", [None, (4096, 512, 256)])
def test_pack_state_matches_jax(tree, caps):
    kw = {} if caps is None else dict(zip(
        ("mut_capacity", "miss_capacity", "fs_capacity"), caps))
    want = jstate.pack_state(tree, **kw)
    got = state.pack_state(tree, **kw, device="cpu")
    for f in jstate.TreeState._fields:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_unpack_state_round_trip(tree):
    ts = state.pack_state(tree, device="cpu")
    back = state.unpack_state(ts, names=tree.name)
    back.check_integrity()
    again = state.pack_state(back, ts.mut_node.shape[0],
                             ts.miss_node.shape[0], ts.fs_node.shape[0],
                             device="cpu")
    for f in state.TreeState._fields:
        np.testing.assert_array_equal(getattr(again, f).numpy(),
                                      getattr(ts, f).numpy(), err_msg=f)
    # same content as the JAX unpack of the JAX pack (the port's Mutation is
    # its own class, so compare fields)
    jb = jstate.unpack_state(jstate.pack_state(tree), names=tree.name)
    for n in range(tree.num_nodes):
        assert [dataclasses.astuple(m) for m in back.mutations[n]] == \
            [dataclasses.astuple(m) for m in jb.mutations[n]]
        assert back.miss_intervals[n] == jb.miss_intervals[n]
        assert back.miss_from_states[n] == jb.miss_from_states[n]


def test_fuse_split_matches_jax(tree):
    e_j, e_t, p_j, p_t = _params()
    ts_j = jstate.pack_state(tree)
    ts_t = state.pack_state(tree, device="cpu")
    ints_j, flts_j = jstate.fuse_for_host((ts_j, e_j, p_j))
    ints_t, flts_t = state.fuse_for_host((ts_t, e_t, p_t))
    assert ints_t.dtype == torch.int32 and flts_t.dtype == torch.float64
    np.testing.assert_array_equal(ints_t.numpy(), np.asarray(ints_j))
    np.testing.assert_array_equal(flts_t.numpy(), np.asarray(flts_j))
    # exact round trip into numpy leaves of the original shapes and dtypes
    ts_h, e_h, p_h = state.split_for_host((ts_t, e_t, p_t), ints_t, flts_t)
    assert isinstance(ts_h, state.TreeState)
    for got, want in ((ts_h, ts_t), (e_h, e_t), (p_h, p_t)):
        for f in want._fields:
            w = getattr(want, f).numpy()
            g = np.asarray(getattr(got, f))
            assert g.shape == w.shape and g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
    # fetch_fused gives the same bundle in one go
    ts_f, _, _ = state.fetch_fused((ts_t, e_t, p_t))
    np.testing.assert_array_equal(ts_f.mut_t, ts_t.mut_t.numpy())


def test_convert_round_trip(tree):
    e_j, _, p_j, _ = _params()
    ts_j = jstate.pack_state(tree)
    for obj, to_t, cls in (
            (ts_j, convert.tree_state_to_torch, jstate.TreeState),
            (e_j, convert.evo_params_to_torch, jevo.EvoParams),
            (p_j, convert.exp_pop_to_torch, jpop.ExpPopParams)):
        t = to_t(obj, device="cpu")
        back = cls(**{k: jnp.asarray(v)
                      for k, v in convert.to_numpy(t).items()})
        for f in cls._fields:
            w = np.asarray(getattr(obj, f))
            g = np.asarray(getattr(back, f))
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
