"""The port's boundary pieces against the JAX package on the same state:
the salted single-slot hash and build_part_ctx (bit-equal), the vsc field
algebra, scatter_deltas, and the deterministic global boundary
run_global_moves(param_moves=False) (rtol 1e-10)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from delphy_tpu.init_tree import build_initial_tree
from delphy_tpu.mcmc.kernel import run_global_moves as j_run_global_moves
from delphy_tpu.parallel import sweep as jsweep
from delphy_tpu.parallel import vsc_device as jvsc
from delphy_tpu.run import Run as JRun
from delphy_tpu.sim import simulate_dataset

from delphy_tpu_torch import convert
from delphy_tpu_torch.mcmc.global_moves import PriorConfig
from delphy_tpu_torch.mcmc.kernel import run_global_moves
from delphy_tpu_torch.mcmc import global_moves as gm
from delphy_tpu_torch.parallel import sweep, vsc_device as vsc


@pytest.fixture(scope="module")
def both():
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        20, 300, mu=1e-3, sample_window_days=300.0, missing_fraction=0.02,
        seed=29)
    tree = build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(29))
    jrun = JRun(tree, seed=29, num_cells=200, device_partitions=4,
                topology_moves_enabled=False)
    hyp = jrun.hyp
    out_j = jax.jit(j_run_global_moves,
                    static_argnames=("hyp", "num_cells", "param_moves"))(
        jrun.ts, jrun.evo, jrun.pop, jrun.key, jrun.tin, jrun.tout,
        jrun.t_max_tip, hyp, jrun.num_cells, param_moves=False)
    ts = convert.tree_state_to_torch(jrun.ts, device="cpu")
    evo = convert.evo_params_to_torch(jrun.evo, device="cpu")
    pop = convert.exp_pop_to_torch(jrun.pop, device="cpu")
    pm = convert.part_maps_to_torch(jax.device_get(jrun.pm), device="cpu")
    out_t = run_global_moves(ts, evo, pop, torch.Generator(),
                             torch.as_tensor(np.array(jrun.tin)),
                             torch.as_tensor(np.array(jrun.tout)),
                             jrun.t_max_tip, PriorConfig(), jrun.num_cells,
                             param_moves=False)
    return dict(jrun=jrun, out_j=out_j, out_t=out_t, pm=pm)


def test_prior_config_fields_match_jax():
    from delphy_tpu.mcmc.global_moves import PriorConfig as JPriorConfig
    import dataclasses
    assert dataclasses.asdict(PriorConfig()) == \
        dataclasses.asdict(JPriorConfig())


@pytest.mark.parametrize("what", ["grid", "caches", "ledger", "stats"])
def test_global_boundary_matches_jax(both, what):
    ts_j, evo_j, pop_j, grid_j, caches_j, ledger_j, _key, stats_j = \
        both["out_j"]
    ts, evo, pop, grid, caches, ledger, stats = both["out_t"]
    pairs = {"grid": (grid, grid_j), "caches": (caches, caches_j),
             "ledger": (ledger, ledger_j)}
    if what == "stats":
        for k in ("num_muts", "M_ab"):
            np.testing.assert_array_equal(stats[k].numpy(),
                                          np.asarray(stats_j[k]))
        np.testing.assert_allclose(stats["Ttwiddle_a"].numpy(),
                                   np.asarray(stats_j["Ttwiddle_a"]),
                                   rtol=1e-10)
        return
    got, want = pairs[what]
    for f in got._fields:
        np.testing.assert_allclose(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)),
            rtol=1e-10, atol=1e-12 if what != "ledger" else 0.0, err_msg=f)


@pytest.mark.parametrize("salt", [0, 1, 12345, 2 ** 31 - 2])
def test_salted_bucket_bit_equal(salt):
    rng = np.random.default_rng(salt % 97)
    key64 = rng.integers(-5000, 2 ** 40, (6, 300)).astype(np.int64)
    part_id = np.arange(6, dtype=np.int32)
    B = 32 * 300 + 1
    key_u = (jnp.asarray(key64).astype(jnp.uint32)
             + jnp.asarray(part_id)[:, None].astype(jnp.uint32)
             * jnp.uint32(0x9E3779B9))
    x = key_u ^ jnp.asarray(salt, jnp.int32).astype(jnp.uint32)
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> jnp.uint32(13))
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> jnp.uint32(16))
    want = np.asarray((x % jnp.uint32(B - 1)).astype(jnp.int32))
    got = sweep.salted_bucket(torch.as_tensor(key64),
                              torch.as_tensor(part_id)[:, None],
                              torch.tensor(salt), B - 1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("salt", [None, 7, 2 ** 30 + 3])
def test_build_part_ctx_bit_equal(both, salt):
    jrun = both["jrun"]
    ts_j, evo_j, _, grid_j, caches_j, _, _, _ = both["out_j"]
    _, evo, _, grid, caches, _, _ = both["out_t"]
    P, C = jrun.pm.node_map.shape[0], grid_j.num_cells
    b = np.random.default_rng(1).normal(size=(P, C))
    want = jsweep.build_part_ctx(
        jrun.pm, ts_j, caches_j, evo_j, jnp.asarray(b),
        salt=None if salt is None else jnp.int32(salt))
    got = sweep.build_part_ctx(
        both["pm"], both["out_t"][0], caches, evo, torch.as_tensor(b),
        salt=None if salt is None else torch.tensor(salt))
    for f in jsweep.PartCtx._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-15,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.mut_single.any()


def test_vsc_fields_and_scatter_match_jax(both):
    jrun = both["jrun"]
    _, _, _, grid_j, _, _, _, _ = both["out_j"]
    ts, _, _, grid, _, _, _ = both["out_t"]
    pm_j, pm = jrun.pm, both["pm"]
    t_p_j = both["out_j"][0].t[jnp.maximum(pm_j.node_map, 0)]
    k_p_j = jax.vmap(jvsc.calc_k_bar_signed, in_axes=(0, 0, None, None, None))(
        t_p_j, pm_j.sign, grid_j.t_lo, grid_j.t_step, jrun.num_cells)
    t_p = ts.t[pm.node_map.clamp(min=0).long()]
    k_p = vsc.calc_k_bar_signed(t_p, pm.sign, grid.t_lo, grid.t_step,
                                jrun.num_cells)
    np.testing.assert_allclose(k_p.numpy(), np.asarray(k_p_j), atol=1e-12)
    act_j = jvsc.active_cells(pm_j.part_t_lo, pm_j.part_t_hi, grid_j.t_lo,
                              grid_j.t_step, jrun.num_cells)
    act = vsc.active_cells(pm.part_t_lo, pm.part_t_hi, grid.t_lo,
                           grid.t_step, jrun.num_cells)
    np.testing.assert_array_equal(act.numpy(), np.asarray(act_j))
    # with z = 0 the fields sit at their conditional mean
    f_j = jvsc.fields_at_mean(k_p_j, act_j, grid_j.popsize_bar, grid_j.t_step)
    f_t = vsc.fields_from_normals(torch.zeros_like(k_p), k_p, act,
                                  grid.popsize_bar, grid.t_step)
    for name in ("A", "b"):
        np.testing.assert_allclose(getattr(f_t, name).numpy(),
                                   np.asarray(getattr(f_j, name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    pq_j = jvsc.partial_quad(k_p_j[0], f_j.b[0], f_j.A, grid_j.popsize_bar,
                             grid_j.t_step)
    pq = vsc.partial_quad(k_p[0], f_t.b[0], f_t.A, grid.popsize_bar,
                          grid.t_step)
    assert float(pq) == pytest.approx(float(pq_j), rel=1e-12)
    # sampled fields: finite, zero off the active cells
    f_s = vsc.sample_fields(torch.Generator().manual_seed(3), k_p, act,
                            grid.popsize_bar, grid.t_step)
    assert bool(torch.isfinite(f_s.b).all())
    assert bool((f_s.b[~act] == 0).all())
    # scatter_deltas routes padding to the trash slot exactly as JAX does
    rng = np.random.default_rng(4)
    dt_p = rng.normal(size=pm.node_map.shape)
    dm_p = rng.normal(size=pm.mut_map.shape)
    N, M = ts.num_nodes, ts.mut_t.shape[0]
    want = jsweep.scatter_deltas(pm_j, N, M, jnp.asarray(dt_p),
                                 jnp.asarray(dm_p))
    got = sweep.scatter_deltas(pm, N, M, torch.as_tensor(dt_p),
                               torch.as_tensor(dm_p))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)


def test_mu_gibbs_draw_is_a_gamma():
    """The Marsaglia-Tsang draw on the run's generator has the Gamma
    moments (shape 7 and 0.5)."""
    gen = torch.Generator().manual_seed(0)
    for shape in (7.0, 0.5):
        draws = torch.stack([gm.sample_gamma(gen, torch.tensor(shape,
                                                                dtype=torch.float64))
                             for _ in range(4000)])
        assert abs(float(draws.mean()) - shape) < 4 * (shape / 4000) ** 0.5
        assert float(draws.var()) == pytest.approx(shape, rel=0.15)
