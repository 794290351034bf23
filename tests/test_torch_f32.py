"""The port in float32, the JAX package's production precision
(``DELPHY_TPU_F32=1``, ``bench.py``), against the JAX package in float32.

The JAX side runs under ``jax.enable_x64(False)``, as its own f32 tests do
(``tests/test_block_pallas.py``, ``test_pop_pallas.py``,
``test_hky_pallas.py``), on inputs made from numpy seeds and rounded to
float32 once, so both packages see the same numbers:

- the plain float32 chains (``sweep_chain_torch``, ``exp_pop_chain_torch``,
  ``hky_chain_torch``) against the JAX float32 twins, and the sweep also
  against ``sweep_chain_pallas(interpret=True)``, at the JAX tests' own
  float32 tolerances: move counts equal, t and mut_t atol 5e-5, k_p atol
  1e-3, dG rtol and atol 1e-3, n0, g and kappa rel 1e-4.  Every accept
  decision must agree (a differing one fails the test and prints the
  entries that differ);
- the likelihood, the coalescent prior and the ledger of one float32
  state, at float32 rounding (rtol 1e-5; the ledger at the scaled f32
  tolerance below);
- a float32 ``Run`` on the CPU through bursts, with no float64 tensor
  operation anywhere in it; one step each of the skygrid (both types),
  alpha/nu, mpox and the unpartitioned ``super_step``; a snapshot that
  resumes bit-equal; a JAX float32 snapshot through ``convert``; the CLI
  under ``DELPHY_TPU_F32=1``; two gloo ranks bit-equal to one process;
- the port's counterpart of ``tests/test_f32.py``: float32 and float64
  chains against a second float64 chain's null.

The float32 ledger tolerance is ``bench.py``'s 0.05 at Ebola scale (|log_G|
~ 4.5e4), scaled by |log_G| / 4.5e4 and floored at 1e-3, as in
``tests/test_f32.py``.  The CUDA kernels' float32 builds are held to these
plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 12)."""

import json
import os
import socket
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from delphy_tpu import evo as jevo
from delphy_tpu import pop as jpop
from delphy_tpu import state as jstate
from delphy_tpu.init_tree import build_initial_tree as j_build_initial_tree
from delphy_tpu.io import snapshot as jsnapshot
from delphy_tpu.mcmc.global_moves import PriorConfig as JPriorConfig
from delphy_tpu.mcmc.kernel import run_global_moves as j_run_global_moves
from delphy_tpu.ops import coalescent as jcoal
from delphy_tpu.ops import likelihood as jlk
from delphy_tpu.parallel import block_pallas as jbp
from delphy_tpu.parallel import hky_pallas as jhp
from delphy_tpu.parallel import pop_pallas as jpp
from delphy_tpu.parallel import vsc_device as jvsc
from delphy_tpu.parallel.sweep import (SweepShared as JSweepShared,
                                       build_part_ctx as j_build_part_ctx)
from delphy_tpu.phylo import build_random_tree as j_build_random_tree
from delphy_tpu.run import Run as JRun
from delphy_tpu.sim import simulate_dataset as j_simulate

from delphy_tpu_torch import cli, convert, resolve_dtype
from delphy_tpu_torch.dates import to_iso_date
from delphy_tpu_torch.evo import EvoParams
from delphy_tpu_torch.init_tree import build_initial_tree
from delphy_tpu_torch.io import snapshot
from delphy_tpu_torch.io.fasta import TipData
from delphy_tpu_torch.io.maple import write_maple
from delphy_tpu_torch.mcmc import kernel
from delphy_tpu_torch.mcmc.global_moves import PriorConfig
from delphy_tpu_torch.ops import coalescent as coal
from delphy_tpu_torch.ops import likelihood as lk
from delphy_tpu_torch.parallel import block_cuda as bc
from delphy_tpu_torch.parallel import hky_cuda, pop_cuda
from delphy_tpu_torch.run import Run
from delphy_tpu_torch.sim import simulate_dataset
from delphy_tpu_torch.state import TreeState

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import torch_f32_study  # noqa: E402

F32 = torch.float32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240


def f32_tol(log_G) -> float:
    """The float32 ledger tolerance at |log_G| (tests/test_f32.py)."""
    return max(0.05 * abs(float(log_G)) / 4.5e4, 1e-3)


def np32(a):
    """numpy/jax array -> numpy, floats rounded to float32."""
    a = np.asarray(a)
    return a.astype(np.float32) if np.issubdtype(a.dtype, np.floating) else a


def T32(a) -> torch.Tensor:
    return torch.as_tensor(np32(a).copy())


def jax32(tree):
    """A pytree of numpy float32 arrays as jnp arrays: call inside
    ``jax.enable_x64(False)``."""
    return jax.tree.map(lambda a: jnp.asarray(np32(a)), tree)


class Float64Ops(TorchDispatchMode):
    """Records every tensor operation whose result is float64."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else [out]
        if any(isinstance(o, torch.Tensor) and o.dtype == torch.float64
               for o in outs):
            self.seen.append(str(func))
        return out


def assert_all_f32(*structs):
    """Every float tensor in the (nested) NamedTuples is float32."""
    for s in structs:
        leaves = s.tree_flatten()[0] if hasattr(s, "tree_flatten") else s
        for leaf in leaves:
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
                assert leaf.dtype == F32, (type(s).__name__, leaf.dtype)


# ---------------------------------------------------------------------------
# The precision switch
# ---------------------------------------------------------------------------

def test_precision_follows_the_environment_and_an_explicit_dtype(
        monkeypatch):
    monkeypatch.delenv("DELPHY_TPU_F32", raising=False)
    assert resolve_dtype() == torch.float64
    monkeypatch.setenv("DELPHY_TPU_F32", "")
    assert resolve_dtype() == torch.float64      # set but empty: f64
    monkeypatch.setenv("DELPHY_TPU_F32", "1")
    assert resolve_dtype() == F32
    assert resolve_dtype(torch.float64) == torch.float64
    monkeypatch.delenv("DELPHY_TPU_F32")
    assert resolve_dtype(F32) == F32
    with pytest.raises(ValueError):
        resolve_dtype(torch.float16)


# ---------------------------------------------------------------------------
# The three chains: plain float32 versions against the JAX float32 twins
# ---------------------------------------------------------------------------

def _sim_tree(seed):
    ref, deltas, miss, dates, names, _ = j_simulate(
        20, 300, mu=1e-3, sample_window_days=300.0, missing_fraction=0.02,
        seed=seed)
    return j_build_initial_tree(ref, deltas, miss, dates, names=names,
                                rng=np.random.default_rng(seed))


@pytest.fixture(scope="module")
def jax_boundary():
    """A JAX boundary context up to the sweep (as tests/test_block_pallas.py
    builds it), packed as the JAX chain's rows: float64 numpy, rounded to
    float32 by the tests."""
    run = JRun(_sim_tree(31), seed=31, num_cells=200, device_partitions=4,
               topology_moves_enabled=False)
    ts, evo, pop_params, grid, caches, ledger, key, stats = jax.jit(
        j_run_global_moves, static_argnames=("hyp", "num_cells"))(
        run.ts, run.evo, run.pop, run.key, run.tin, run.tout,
        run.t_max_tip, run.hyp, run.num_cells)
    pm = run.pm
    t_p = ts.t[jnp.maximum(pm.node_map, 0)]
    k_p = jax.vmap(jvsc.calc_k_bar_signed, in_axes=(0, 0, None, None, None))(
        t_p, pm.sign, grid.t_lo, grid.t_step, run.num_cells)
    active = jvsc.active_cells(pm.part_t_lo, pm.part_t_hi, grid.t_lo,
                               grid.t_step, run.num_cells)
    fields = jvsc.sample_fields(jax.random.PRNGKey(5), k_p, active,
                                grid.popsize_bar, grid.t_step)
    ctx = j_build_part_ctx(pm, ts, caches, evo, fields.b,
                           salt=jnp.int32(987654321))
    mut_t_p = ts.mut_t[jnp.maximum(pm.mut_map, 0)]
    sh = JSweepShared(A=fields.A, popsize_bar=grid.popsize_bar,
                      t_lo=grid.t_lo, t_step=grid.t_step,
                      t_max_tip=jnp.asarray(run.t_max_tip, t_p.dtype))
    stat, ctx_arrs, shared = jbp.pack_chain_inputs(
        ctx, sh, pop_params, k_p, t_p, mut_t_p, cpb=16)
    return (stat, {k: np32(v) for k, v in ctx_arrs.items()},
            {k: np32(v) for k, v in shared.items()})


@pytest.fixture(scope="module")
def sweep32(jax_boundary):
    """(port plain chain, JAX twin, Pallas kernel in interpret mode) in
    float32 on the same rows and uniforms (numpy seed 17)."""
    stat, ctx32, sh32 = jax_boundary
    P, NB = ctx32["t"].shape[0], 16
    rng = np.random.default_rng(17)
    u32 = jbp.BlockUniforms(*[np32(a) for a in (
        rng.uniform(size=(P, NB, stat.NC)), rng.uniform(size=(P, NB, stat.NC)),
        rng.uniform(size=(P, NB, stat.NC)), rng.uniform(size=(P, NB, stat.MC)),
        rng.uniform(size=(P, NB, stat.NC)), rng.uniform(size=(P, NB, 128)),
        rng.normal(size=(P, NB, 128)))])
    with jax.enable_x64(False):
        ca, sa = jax32(ctx32), jax32(sh32)
        ua = jbp.BlockUniforms(*jax32(tuple(u32)))
        twin = jax.jit(jbp.sweep_chain_jnp, static_argnames=("stat",))(
            stat, NB, ca, sa, ua)
        pallas = jbp.sweep_chain_pallas(stat, NB, ca, sa, ua, interpret=True)
        twin = [np.asarray(x) for x in twin]
        pallas = [np.asarray(x) for x in pallas]
    assert all(x.dtype == np.float32 for x in twin + pallas)
    got = bc.sweep_chain_kernel(
        bc.ChainStatics(NC=stat.NC, MC=stat.MC, C=stat.C, C_real=stat.C_real,
                        cpb=stat.cpb), NB,
        {k: T32(v) for k, v in ctx32.items()},
        {k: T32(v) for k, v in sh32.items()},
        bc.BlockUniforms(*map(T32, u32)))
    return [g.numpy() for g in got], {"jnp": twin, "pallas": pallas}, ctx32


@pytest.mark.parametrize("ref", ["jnp", "pallas"])
def test_f32_sweep_chain_matches_jax_twin_and_pallas(sweep32, ref):
    got, refs, ctx32 = sweep32
    want = refs[ref]
    assert all(g.dtype == np.float32 for g in got)
    names = ("t", "mut_t", "k_p", "dG", "dC", "cnt")
    tol = {"t": dict(atol=5e-5, rtol=0), "mut_t": dict(atol=5e-5, rtol=0),
           "k_p": dict(atol=1e-3, rtol=0), "dG": dict(atol=1e-3, rtol=1e-3),
           "dC": dict(atol=1e-3, rtol=1e-3)}
    for n, g, w in zip(names, got, want):
        g, w = g.reshape(-1), w.reshape(-1)
        if n == "cnt":
            np.testing.assert_array_equal(g, w, err_msg=n)
            continue
        bad = ~np.isclose(g, w, **tol[n])
        if bad.any():   # a differing decision: say where
            print(n, "differs at", np.nonzero(bad)[0][:20], g[bad][:20],
                  w[bad][:20])
        np.testing.assert_allclose(g, w, err_msg=n, **tol[n])
    assert got[5].sum() > 50
    assert not np.allclose(got[0].reshape(-1), ctx32["t"].reshape(-1))


def _hky_inputs(seed, state=None):
    """(u, evo, tt, M, rf) from ``seed`` (tests/test_torch_kernels.py's
    cases: the guards at the simplex edge, a zero column of M, extreme
    kappa)."""
    rng = np.random.default_rng(seed)
    pi = np.array([0.004, 0.332, 0.332, 0.332]) if state == "pi_edge" \
        else np.array([0.3, 0.2, 0.25, 0.25])
    kappa = {"kappa_0.05": 0.05, "kappa_200": 200.0}.get(state, 1.7)
    evo = jevo.make_evo_params(100, mu=1e-3, kappa=kappa, pi=pi, alpha=10.0)
    tt = rng.uniform(1e4, 1e5, 4)
    M = np.where(~np.eye(4, dtype=bool), rng.integers(0, 200, (4, 4)), 0.0)
    rf = rng.integers(0, 40, 4).astype(np.float64)
    if state == "M_zero_column":
        M[:, 2] = 0.0
        rf[[0, 3]] = 0.0
    u = rng.uniform(size=(10, 128))
    return u, evo, tt, M, rf


@pytest.mark.parametrize("seed,state", [
    (0, None), (4, None), (9, None), (1, "pi_edge"), (2, "M_zero_column"),
    (3, "kappa_0.05"), (5, "kappa_200")],
    ids=["0", "4", "9", "pi_edge", "M_zero_column", "kappa_0.05",
         "kappa_200"])
def test_f32_hky_chain_matches_jax_twin(seed, state):
    u, evo, tt, M, rf = _hky_inputs(seed, state)
    hyp = JPriorConfig()
    hypf = (float(hyp.kappa_prior_mean_log), float(hyp.kappa_prior_sigma_log))
    ins = [np32(x) for x in (u, evo.mu, evo.kappa,
                             np.asarray(evo.pi).reshape(1, 4),
                             np.asarray(tt).reshape(1, 4), M,
                             np.asarray(rf).reshape(1, 4))]
    with jax.enable_x64(False):
        want = [np.asarray(x) for x in jhp.hky_chain_jnp(
            *[jnp.asarray(a) for a in ins], hypf + (True, True), 10)]
    got = [g.numpy() for g in hky_cuda.hky_chain_kernel(
        *[T32(a) for a in ins], hypf, 10)]
    assert all(g.dtype == np.float32 for g in got + want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.reshape(-1), w.reshape(-1), rtol=1e-4,
                                   atol=1e-7)
    assert float(got[0]) != pytest.approx(float(evo.kappa))


@pytest.mark.parametrize("seed", [0, 3])
def test_f32_exp_pop_chain_matches_jax_twin(seed):
    rng = np.random.default_rng(seed)
    N = 40
    t = np.sort(rng.uniform(-300.0, 0.0, N))
    is_tip = np.zeros(N, bool)
    is_tip[rng.permutation(N)[: N // 2 + 1]] = True
    p = jpop.ExpPopParams(t0=jnp.float64(0.0), n0=jnp.float64(500.0),
                          g=jnp.float64(0.002), min_pop=jnp.float64(1.0))
    grid = jcoal.make_grid(p, jnp.asarray(t), jnp.asarray(is_tip),
                           jnp.float64(-400.0), jnp.float64(5.0), 96)
    u = np.random.default_rng(100 + seed).uniform(size=(50, 128))
    hypf = jpp._hyp_floats(JPriorConfig())
    rows = jpp.pack_rows(grid, jnp.asarray(t), jnp.asarray(is_tip),
                         jnp.float64)
    ins = [np32(x) for x in (u, *rows, grid.t_step, p.t0, p.min_pop, p.n0,
                             p.g)]
    with jax.enable_x64(False):
        want = [np.asarray(x) for x in jpp.exp_pop_chain_jnp(
            *[jnp.asarray(a) for a in ins], hypf, 50)]
    got = [g.numpy() for g in pop_cuda.exp_pop_chain_kernel(
        *[T32(a) for a in ins], hypf, 50)]
    assert all(g.dtype == np.float32 for g in got + want)
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=1e-4)
    assert float(got[0]) != pytest.approx(500.0)


# ---------------------------------------------------------------------------
# One float32 state: likelihood, coalescent prior, ledger
# ---------------------------------------------------------------------------

def _lk_values(ts, e, tin, tout, lkm):
    rq = lkm.calc_ref_cum_Q(ts, e)
    cnt, nucum = lkm.calc_ref_state_prefix(ts, e)
    lam = lkm.calc_lambda_i(ts, e, rq)[0]
    rf = lkm.calc_root_state_frequencies(ts, e, cnt)
    return {"ref_cum_Q": rq, "cnt_prefix": cnt, "lambda_i": lam,
            "root_freq": rf, "log_G": lkm.calc_log_G(ts, e, lam, rf),
            "T_below": lkm.calc_T_below(ts, tin, tout),
            "Ttwiddle_a": lkm.calc_Ttwiddle_a(ts, e, tin, tout, nucum),
            "Ttwiddle_l": lkm.calc_Ttwiddle_l(ts, e, tin, tout)}


@pytest.fixture(scope="module")
def lk32():
    ref, deltas, miss, dates, names, _ = j_simulate(
        20, 300, mu=1e-3, sample_window_days=300.0, missing_fraction=0.05,
        seed=11)
    tree = j_build_initial_tree(ref, deltas, miss, dates, names=names,
                                rng=np.random.default_rng(11))
    ts_j = jstate.pack_state(tree)
    nu = np.random.default_rng(3).gamma(10.0, 0.1, 300)
    e_j = jevo.make_evo_params(300, mu=2e-3, kappa=1.7,
                               pi=np.array([0.3, 0.2, 0.24, 0.26]),
                               alpha=10.0, nu=nu)
    tin, tout = tree.euler_positions()
    ts32 = {f: np32(getattr(ts_j, f)) for f in ts_j._fields}
    e32 = {f: np32(getattr(e_j, f)) for f in e_j._fields}
    with jax.enable_x64(False):
        want = jax.jit(lambda ts, e, tin, tout: _lk_values(
            ts, e, tin, tout, jlk))(
            type(ts_j)(**jax32(ts32)), type(e_j)(**jax32(e32)),
            jnp.asarray(tin), jnp.asarray(tout))
        want = {k: np.asarray(v) for k, v in want.items()}
    ts = convert.from_dict(TreeState, ts32, "cpu")
    e = convert.from_dict(EvoParams, e32, "cpu")
    assert ts.t.dtype == e.mu.dtype == F32
    got = _lk_values(ts, e, torch.as_tensor(np.asarray(tin)),
                     torch.as_tensor(np.asarray(tout)), lk)
    return got, want, ts, ts32


@pytest.mark.parametrize("name", ["ref_cum_Q", "cnt_prefix", "lambda_i",
                                  "root_freq", "log_G", "T_below",
                                  "Ttwiddle_a", "Ttwiddle_l"])
def test_f32_likelihood_matches_jax(lk32, name):
    got, want = lk32[0][name], lk32[1][name]
    assert got.dtype == F32 and want.dtype == np.float32
    scale = float(np.max(np.abs(want)))
    # float32 rounding of sums taken in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("n0,g,mp", [(500.0, 0.002, 1.0), (500.0, 0.0, 1.0),
                                     (0.5, 0.01, 1.0)])
def test_f32_coalescent_prior_matches_jax(lk32, n0, g, mp):
    _, _, ts, ts32 = lk32
    is_tip = ts32["children"][:, 0] < 0
    t_lo, t_step, C = -420.0, 2.5, 200
    with jax.enable_x64(False):
        p_j = jpop.ExpPopParams(t0=jnp.float32(0.0), n0=jnp.float32(n0),
                                g=jnp.float32(g), min_pop=jnp.float32(mp))
        t_j = jnp.asarray(ts32["t"])
        grid_j = jcoal.make_grid(p_j, t_j, jnp.asarray(is_tip),
                                 jnp.float32(t_lo), jnp.float32(t_step), C)
        lp_j = float(jcoal.calc_log_prior(grid_j, p_j, t_j,
                                          jnp.asarray(is_tip)))
        kbar_j = np.asarray(grid_j.k_bar)
    p = convert.exp_pop_to_torch(
        jpop.ExpPopParams(*map(np.float32, (0.0, n0, g, mp))), device="cpu")
    assert p.n0.dtype == F32
    grid = coal.make_grid(p, ts.t, ts.is_tip, torch.tensor(t_lo, dtype=F32),
                          torch.tensor(t_step, dtype=F32), C)
    lp = coal.calc_log_prior(grid, p, ts.t, ts.is_tip)
    assert lp.dtype == grid.k_bar.dtype == F32
    np.testing.assert_allclose(grid.k_bar.numpy(), kbar_j, atol=1e-4)
    assert float(lp) == pytest.approx(lp_j, rel=1e-5, abs=1e-3)


# ---------------------------------------------------------------------------
# A JAX float32 run's snapshot, and float32 runs of the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_f32_snapshot(tmp_path_factory):
    """A JAX run made and stepped in float32 (a burst included), saved by
    the JAX package's save_run; returns (path, its ledger recomputed in
    float32)."""
    ref, deltas, miss, dates, names, _ = j_simulate(8, 100, mu=2e-4,
                                                    seed=59)
    tree = j_build_random_tree(ref, deltas, miss, dates, names=names,
                               rng=np.random.default_rng(59))
    path = tmp_path_factory.mktemp("f32") / "jax_f32.npz"
    with jax.enable_x64(False), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jrun = JRun(tree, seed=59, num_cells=64,
                    local_moves_per_global_move=200)
        jrun.do_mcmc_steps(600)
        assert jrun.ts.t.dtype == jnp.float32
        jsnapshot.save_run(jrun, path)
        led = [float(v) for v in jrun.calc_cur_ledger()]
    return path, led


def test_jax_f32_snapshot_loads_as_an_f32_run(jax_f32_snapshot):
    path, led_j = jax_f32_snapshot
    run = convert.load_jax_snapshot(path, gen_seed=7, device="cpu")
    assert run.dtype == F32
    assert_all_f32(run.ts, run.evo, run.pop, run.pm)
    with np.load(path) as z:
        np.testing.assert_array_equal(run.ts.t.numpy(), z["ts_t"])
        np.testing.assert_array_equal(run.ts.mut_t.numpy(), z["ts_mut_t"])
    got = [float(v) for v in run.calc_cur_ledger()]
    for g, w in zip(got, led_j):
        assert abs(g - w) < f32_tol(led_j[0]), (got, led_j)
    run.do_mcmc_steps(600)
    run.check_derived_quantities(f32_tol(run.ledger.log_G))
    run.tree().check_integrity()
    assert_all_f32(run.ts, run.evo, run.pop)


def _small_tree(seed=11, n_tips=30, n_sites=600):
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        n_tips, n_sites, mu=2e-3, seed=seed)
    return build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(1))


@pytest.fixture(scope="module")
def tree30():
    return _small_tree()


def test_f32_run_keeps_its_ledger_and_runs_nothing_in_f64(tree30):
    """A float32 Run on the CPU through boundaries and bursts (the native
    burst's float64 host round trip included): the ledger at the scaled
    f32 tolerance, integrity, every float leaf float32, and not one tensor
    operation with a float64 result."""
    run = Run(tree30, seed=42, num_cells=128, device="cpu", dtype=F32)
    run.topology_burst_chunks = 4
    rec = Float64Ops()
    with rec:
        for _ in range(3):
            run.do_mcmc_steps(4 * run.local_moves_per_global_move)
            run.check_derived_quantities(f32_tol(run.ledger.log_G))
    assert run.burst_count >= 2
    assert rec.seen == []
    assert_all_f32(run.ts, run.evo, run.pop, run.pm, run.ledger)
    run.tree().check_integrity()
    assert float(run.ledger.log_G) < 0.0


@pytest.mark.parametrize("option", ["skygrid staircase", "skygrid log-linear",
                                    "alpha", "mpox"])
def test_f32_model_option_steps_keep_the_ledger(tree30, option):
    """One dispatch of each model option in float32: its state stays
    float32 and its ledger matches the recompute at the f32 tolerance."""
    kw = {"skygrid staircase": dict(pop_model="skygrid", skygrid_type=1),
          "skygrid log-linear": dict(pop_model="skygrid", skygrid_type=2),
          "alpha": dict(hyp=PriorConfig(alpha_move_enabled=True)),
          "mpox": dict(mpox_hack=True)}[option]
    run = Run(tree30, seed=5, num_cells=128, device="cpu", dtype=F32,
              topology_moves_enabled=False, **kw)
    run.do_mcmc_steps(2 * run.local_moves_per_global_move)
    assert_all_f32(run.ts, run.evo, run.pop, run.ledger)
    got, want = run.ledger, run.calc_cur_ledger()
    assert abs(float(got.log_G) - float(want.log_G)) < f32_tol(got.log_G)
    assert abs(float(got.log_other) - float(want.log_other)) \
        < f32_tol(got.log_G)
    assert np.isfinite(float(got.log_posterior))


def test_f32_super_step_keeps_its_ledger(tree30):
    """One unpartitioned boundary (super_step) in float32: float32 out, and
    its ledger's log_G against the recompute at the f32 tolerance."""
    run = Run(tree30, seed=9, num_cells=128, device="cpu", dtype=F32,
              topology_moves_enabled=False)
    ts, evo, pop, ledger, stats = kernel.super_step(
        run.ts, run.evo, run.pop, run.gen, run.tin, run.tout, 400,
        run.t_max_tip, run.hyp, run.num_cells)
    assert_all_f32(ts, evo, pop, ledger)
    assert not torch.equal(ts.t, run.ts.t)
    run.ts, run.evo, run.pop = ts, evo, pop
    want = run.calc_cur_ledger()
    assert abs(float(ledger.log_G) - float(want.log_G)) < f32_tol(want.log_G)


def test_f32_snapshot_resumes_bit_equal(tree30, tmp_path, monkeypatch):
    """A float32 run saved and resumed (under the float64 default: the
    snapshot's dtype wins) continues the trajectory bit for bit, through
    a burst."""
    run = Run(tree30, seed=3, num_cells=128, device="cpu", dtype=F32)
    run.topology_burst_chunks = 2
    run.do_mcmc_steps(2 * run.local_moves_per_global_move)
    path = tmp_path / "f32.npz"
    snapshot.save_run(run, path)
    monkeypatch.delenv("DELPHY_TPU_F32", raising=False)
    twin = snapshot.load_run(path, device="cpu")
    assert twin.dtype == F32
    assert_all_f32(twin.ts, twin.evo, twin.pop, twin.pm)
    for r in (run, twin):
        r.do_mcmc_steps(3 * run.local_moves_per_global_move)
    assert twin.burst_count == run.burst_count > 1
    assert torch.equal(twin.ts.t, run.ts.t)
    assert torch.equal(twin.ts.mut_t, run.ts.mut_t)
    assert twin.log_posterior == run.log_posterior


@pytest.fixture(scope="module")
def maple(tmp_path_factory):
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        12, 150, mu=2e-3, missing_fraction=0.02, seed=11)
    tips = [TipData(name=f"s{i}|{to_iso_date(dates[i][0])}",
                    t_min=dates[i][0], t_max=dates[i][1], deltas=deltas[i],
                    miss_intervals=miss[i]) for i in range(12)]
    path = tmp_path_factory.mktemp("cli32") / "in.maple"
    write_maple(str(path), "ref", ref, tips)
    return str(path)


def test_cli_under_the_f32_switch_writes_an_f32_run(maple, tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv("DELPHY_TPU_F32", "1")
    argv = ["--v0-in-maple", maple, "--device", "cpu", "--v0-seed", "7",
            "--v0-steps", "3000", "--v0-log-every", "1000",
            "--v0-tree-every", "1000", "--v0-delphy-snapshot-every", "3000",
            "--v0-target-coal-prior-cells", "64",
            "--v0-out-log-file", str(tmp_path / "o.log"),
            "--v0-out-trees-file", str(tmp_path / "o.trees"),
            "--v0-out-delphy-file", str(tmp_path / "o.npz")]
    assert cli.main(argv) == 0
    lines = (tmp_path / "o.log").read_text().splitlines()
    vals = np.array([[float(v) for v in ln.split("\t")] for ln in lines[1:]])
    assert vals.shape[0] == 3 and np.all(np.isfinite(vals))
    monkeypatch.delenv("DELPHY_TPU_F32")
    loaded = snapshot.load_run(tmp_path / "o.npz", device="cpu")
    assert loaded.dtype == F32 and loaded.step == 3000
    assert_all_f32(loaded.ts, loaded.evo, loaded.pop)
    # --v0-paranoid's fixed 1e-4 is the JAX CLI's too, and float32 drifts
    # past it at this |log_G|: hold the run to the float32 tolerance
    loaded.do_mcmc_steps(1000)
    loaded.check_derived_quantities(f32_tol(loaded.ledger.log_G))


def test_server_under_the_f32_switch_makes_f32_runs(maple, monkeypatch):
    """The engine server reads DELPHY_TPU_F32 where create_run makes a run,
    as the JAX server's process-wide switch does."""
    from delphy_tpu_torch.server import Client, serve_in_thread
    monkeypatch.setenv("DELPHY_TPU_F32", "1")
    srv, engine, _thread = serve_in_thread(device="cpu")
    c = Client(*srv.server_address)
    try:
        job = c.call("create_run", maple=maple, seed=5, num_cells=64,
                     local_moves_per_global_move=200)
        rid = c.wait_job(job["job_id"])["run_id"]
        res = c.wait_job(c.call("run_steps", run_id=rid, n=1000)["job_id"])
        assert res["step"] >= 1000
        run = engine._runs[rid].run
        assert run.dtype == F32
        assert_all_f32(run.ts, run.evo, run.pop, run.ledger)
    finally:
        c.close()
        srv.shutdown()
        srv.server_close()


# ---------------------------------------------------------------------------
# Two gloo ranks in float32
# ---------------------------------------------------------------------------

def _drive32(mesh, out):
    """A 48-tip float32 run (DELPHY_TPU_F32 in the environment) through
    bursts, P = 8, under ``mesh`` (None: one process); t and mut_t go to
    ``out``."""
    import numpy as np
    import torch

    from delphy_tpu_torch.phylo import build_random_tree
    from delphy_tpu_torch.run import Run
    from delphy_tpu_torch.sim import simulate_dataset

    ref, deltas, miss, dates, names, _ = simulate_dataset(
        48, 400, mu=2e-3, missing_fraction=0.02, seed=21)
    tree = build_random_tree(ref, deltas, miss, dates, names=names,
                             rng=np.random.default_rng(21))
    run = Run(tree, seed=23, num_cells=64, local_moves_per_global_move=200,
              device_partitions=8, device="cpu", mesh=mesh)
    assert run.dtype == torch.float32
    run.topology_burst_chunks = 2
    for _ in range(3):
        run.do_mcmc_steps(400)
    np.savez(out, t=run.ts.t.numpy(), mut_t=run.ts.mut_t.numpy())
    return {"log_G": float(run.ledger.log_G), "bursts": run.burst_count,
            "moves": run.local_moves_attempted}


RANK_MAIN = """
import json, os, sys
sys.modules["jax"] = None            # the ranks import no jax
from delphy_tpu_torch.parallel import distributed
assert distributed.initialize_from_env()
mesh = distributed.global_part_mesh(device="cpu")
out = os.environ["MESH_TEST_OUT"]
res = _drive32(mesh, f"{out}/f32_r{mesh.rank}.npz")
print("RESULT " + json.dumps(res), flush=True)
distributed.shutdown()
"""


def test_two_gloo_ranks_in_f32_match_one_process(tmp_path, monkeypatch):
    import inspect
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    src = textwrap.dedent(inspect.getsource(_drive32)) + RANK_MAIN
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, MESH_TEST_OUT=str(tmp_path),
                   OMP_NUM_THREADS="1", DELPHY_TPU_F32="1",
                   DELPHY_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   DELPHY_TPU_NUM_PROCESSES="2", DELPHY_TPU_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", src], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    monkeypatch.setenv("DELPHY_TPU_F32", "1")
    try:
        ref = _drive32(None, str(tmp_path / "f32_single.npz"))
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    b = np.load(tmp_path / "f32_single.npz")
    assert b["t"].dtype == np.float32 and ref["bursts"] >= 1
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{so[-2000:]}\n{se[-4000:]}"
        line = [ln for ln in so.splitlines() if ln.startswith("RESULT ")]
        assert json.loads(line[0][len("RESULT "):]) == ref, r
        a = np.load(tmp_path / f"f32_r{r}.npz")
        assert np.array_equal(a["t"], b["t"]) and \
            np.array_equal(a["mut_t"], b["mut_t"]), r


# ---------------------------------------------------------------------------
# The counterpart of tests/test_f32.py
# ---------------------------------------------------------------------------

def test_f32_matches_f64_statistically():
    """tests/test_f32.py's configuration and rule on the port
    (scripts/torch_f32_study.py): float32 and float64 chains from the same
    data and seed, judged against the null of a second float64 chain
    (another seed); the f64 within-window drift is rounding, the f32 one
    stays under the scaled bench bound."""
    cfg = {"tips": 20, "sites": 400, "steps": 30_000, "seed": 5}
    res = torch_f32_study.study(cfg, "cpu")
    report, null = res["f32_vs_f64"], res["null_f64_vs_f64"]
    assert res["f64_drift"] < 1e-8
    scaled_bound = 0.05 * report["log_G_magnitude"] / 4.5e4
    assert res["f32_drift"] < max(scaled_bound, 1e-3)
    bound = max(8.0, 3.0 * null["max_sigma"])
    assert report["max_sigma"] < bound, (report["summaries"],
                                         null["summaries"])
    assert res["ok"]
