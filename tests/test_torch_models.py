"""The port's site-rate heterogeneity (alpha/nu) and mpox APOBEC model, and
CPU Runs of every model option, against the JAX package on the same
numpy-seeded inputs:

- the per-site and per-partition likelihood functions (rtol 1e-12) on a
  random two-partition state and on the reference's hand-built fixture;
  jc_q, mpox_q_tab and apobec_context_partition exactly;
- alpha_and_nu_moves and mpox_hack_moves fed the JAX moves' own draws
  (1e-10);
- Runs of the skygrid (both types), alpha/nu and mpox options: the same
  initial parameters as the JAX Run (==), a few boundaries and a topology
  burst with the ledger green (1e-6), the ledger recompute equal to the JAX
  package's on the same state (1e-8);
- the .log, .trees, BEAST XML and .dphy flatbuffer bytes of a skygrid and
  of an alpha run equal to the JAX writers' from the same state, and exact
  snapshot resume (==) of each option.
"""

import dataclasses
import functools
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from delphy_tpu import evo as jevo
from delphy_tpu import pop as jpop
from delphy_tpu import state as jstate
from delphy_tpu.init_tree import build_initial_tree
from delphy_tpu.io import beast_out as jbeast_out
from delphy_tpu.io import beast_xml as jbeast_xml
from delphy_tpu.io import dphy as jdphy
from delphy_tpu.mcmc import global_moves as jgm
from delphy_tpu.mcmc.global_moves import PriorConfig as JPriorConfig
from delphy_tpu.mcmc.moves import Ledger as JLedger
from delphy_tpu.ops import likelihood as jlk
from delphy_tpu.phylo import FlatTree, Mutation, NO_NODE
from delphy_tpu.run import Run as JRun, _calc_ledger_jit
from delphy_tpu.sim import simulate_dataset

from delphy_tpu_torch import convert, evo, pop
from delphy_tpu_torch.io import beast_out, beast_xml, dphy, snapshot
from delphy_tpu_torch.mcmc import global_moves as gm
from delphy_tpu_torch.mcmc.global_moves import PriorConfig
from delphy_tpu_torch.ops import likelihood as lk
from delphy_tpu_torch.run import Run


def T(x):
    a = np.asarray(x)
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(a.astype(np.float64))
    return torch.as_tensor(a.copy())


def _close(got, want, rtol=1e-12, atol=0.0, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _sim_tree(seed=21, n_tips=16, n_sites=240):
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        n_tips, n_sites, mu=2e-3, sample_window_days=200.0,
        missing_fraction=0.03, seed=seed)
    return build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(seed))


# ---------------------------------------------------------------------------
# likelihood and evo functions
# ---------------------------------------------------------------------------

def _random_state():
    """A simulated tree with the mpox hack's partitions, random nu and
    rho = 0.4."""
    tree = _sim_tree()
    part = jevo.apobec_context_partition(tree.sequence_at(0))
    nu = np.random.default_rng(4).gamma(3.0, 1.0 / 3.0, tree.num_sites)
    e_j = jevo.make_evo_params(tree.num_sites, mu=1.5e-3, pi=np.full(4, 0.25),
                               nu=nu, part=part).with_mpox_rho(rho=0.4)
    return tree, jstate.pack_state(tree), e_j


def _fixture_state():
    """The reference's 5-node, two-partition fixture
    (phylo_tree_calc_tests.cpp:14-116; tests/test_torch_likelihood.py)."""
    A, C, G, T_ = 0, 1, 2, 3
    a, b, c, x, r = 0, 1, 2, 3, 4
    parent = np.array([x, x, r, r, NO_NODE], dtype=np.int32)
    children = np.full((5, 2), NO_NODE, dtype=np.int32)
    children[x] = [a, b]
    children[r] = [x, c]
    mutations = [[] for _ in range(5)]
    mutations[r] = [Mutation(site=2, from_=C, to=A, t=-1e30)]
    mutations[x] = [Mutation(site=0, from_=A, to=T_, t=-0.5)]
    mutations[a] = [Mutation(site=0, from_=T_, to=C, t=0.5)]
    mutations[b] = [Mutation(site=1, from_=A, to=G, t=1.0)]
    mutations[c] = [Mutation(site=0, from_=A, to=T_, t=0.0),
                    Mutation(site=0, from_=T_, to=G, t=1.0)]
    miss = [[] for _ in range(5)]
    miss[r], miss[x], miss[c] = [(3, 4)], [(2, 3)], [(1, 2)]
    fs = [{} for _ in range(5)]
    fs[x] = {2: A}
    tree = FlatTree(parent=parent, children=children,
                    t=np.array([1.0, 2.0, 3.0, 0.0, -1.0]),
                    t_min=np.array([1.0, 2.0, 3.0, -np.inf, -np.inf]),
                    t_max=np.array([1.0, 2.0, 3.0, np.inf, np.inf]),
                    root=r, ref_seq=np.array([A, A, C, A], dtype=np.int8),
                    mutations=mutations, miss_intervals=miss,
                    miss_from_states=fs, name=["a", "b", "c", "x", "r"])
    tree.check_integrity()
    q = np.array([[[0.0, 0.6, 0.7, 0.8], [0.9, 0.0, 1.0, 1.1],
                   [1.2, 1.3, 0.0, 1.4], [1.5, 1.6, 1.7, 0.0]],
                  [[0.0, 2.6, 2.7, 2.8], [2.9, 0.0, 3.0, 3.1],
                   [3.2, 3.3, 0.0, 3.4], [3.5, 3.6, 3.7, 0.0]]])
    for qp in q:
        np.fill_diagonal(qp, -qp.sum(axis=1))
    e_j = jevo.make_evo_params(4, mu=1.0, nu=np.array([0.2, 0.3, 0.4, 0.5]),
                               part=np.array([0, 1, 0, 1]))
    e_j = e_j._replace(q_tab=jnp.asarray(q * np.array([0.1, 1.1])[:, None,
                                                                  None]))
    return tree, jstate.pack_state(tree, 16, 8, 8), e_j


def _lk_values(mod, ts, e, tin, tout):
    pa = mod.calc_ref_state_prefix_beta(ts, e)
    return {"num_muts_l": mod.calc_num_muts_l(ts),
            "num_muts_beta_ab": mod.calc_num_muts_beta_ab(ts, e),
            "ref_state_prefix_beta": pa,
            "Ttwiddle_beta_a": mod.calc_Ttwiddle_beta_a(ts, e, tin, tout, pa),
            "Ttwiddle_l": mod.calc_Ttwiddle_l(ts, e, tin, tout)}


@pytest.fixture(scope="module", params=["random", "fixture"])
def lk_pair(request):
    tree, ts_j, e_j = (_random_state() if request.param == "random"
                       else _fixture_state())
    tin, tout = tree.euler_positions()
    want = jax.jit(lambda ts, e, i, o: _lk_values(jlk, ts, e, i, o))(
        ts_j, e_j, jnp.asarray(tin), jnp.asarray(tout))
    got = _lk_values(lk, convert.tree_state_to_torch(ts_j, device="cpu"),
                     convert.evo_params_to_torch(e_j, device="cpu"),
                     T(tin), T(tout))
    return got, want


@pytest.mark.parametrize("name", ["num_muts_l", "num_muts_beta_ab",
                                  "ref_state_prefix_beta", "Ttwiddle_beta_a",
                                  "Ttwiddle_l"])
def test_partition_likelihood_matches_jax(lk_pair, name):
    got, want = lk_pair[0][name], lk_pair[1][name]
    if name.startswith("num_muts"):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(got.sum()) > 0
    else:
        _close(got, want, atol=1e-14)


def test_one_partition_Ttwiddle_beta_is_Ttwiddle_a():
    tree = _sim_tree(seed=22)
    ts = convert.tree_state_to_torch(jstate.pack_state(tree), device="cpu")
    e = evo.make_evo_params(tree.num_sites, mu=1e-3, kappa=2.0,
                            pi=(0.3, 0.2, 0.2, 0.3), device="cpu")
    tin, tout = (T(a) for a in tree.euler_positions())
    _, nucum = lk.calc_ref_state_prefix(ts, e)
    beta = lk.calc_Ttwiddle_beta_a(ts, e, tin, tout,
                                   lk.calc_ref_state_prefix_beta(ts, e))
    _close(beta[0], lk.calc_Ttwiddle_a(ts, e, tin, tout, nucum))


def test_mpox_evo_functions_equal_jax():
    assert np.array_equal(evo.jc_q().numpy(), np.asarray(jevo.jc_q()))
    for rho in (0.0, 0.37, 2.5):
        got = evo.mpox_q_tab(torch.tensor(rho, dtype=torch.float64))
        assert np.array_equal(got.numpy(), np.asarray(jevo.mpox_q_tab(rho)))
    rng = np.random.default_rng(3)
    for seq in (rng.integers(0, 4, 5000), _sim_tree().sequence_at(0)):
        got = evo.apobec_context_partition(seq)
        want = np.asarray(jevo.apobec_context_partition(seq))
        assert got.dtype == np.int32 and np.array_equal(got, want)
        assert 0 < got.sum() < len(seq)
    e_j = jevo.make_evo_params(30, part=np.arange(30) % 2).with_mpox_rho(
        mu=2e-3, rho=0.8)
    e = evo.make_evo_params(30, part=np.arange(30) % 2,
                            device="cpu").with_mpox_rho(mu=2e-3, rho=0.8)
    for f in e._fields:
        assert np.array_equal(getattr(e, f).numpy(),
                              np.asarray(getattr(e_j, f))), f


# ---------------------------------------------------------------------------
# moves from replayed JAX draws
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def move_inputs():
    tree, ts_j, e_j = _random_state()
    tin, tout = (jnp.asarray(a) for a in tree.euler_positions())
    pa = jlk.calc_ref_state_prefix_beta(ts_j, e_j)
    return dict(
        e_j=e_j, e=convert.evo_params_to_torch(e_j, device="cpu"),
        Tl=jlk.calc_Ttwiddle_l(ts_j, e_j, tin, tout),
        Ml=jlk.calc_num_muts_l(ts_j),
        Mb=jlk.calc_num_muts_beta_ab(ts_j, e_j),
        M=jlk.calc_num_muts(ts_j),
        Tb=jlk.calc_Ttwiddle_beta_a(ts_j, e_j, tin, tout, pa))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_alpha_and_nu_moves_from_replayed_draws(move_inputs, seed):
    m = move_inputs
    e_j = m["e_j"]._replace(alpha=jnp.float64(0.5 + seed))
    e = m["e"]._replace(alpha=torch.tensor(0.5 + seed, dtype=torch.float64))
    hyp_j = JPriorConfig(alpha_move_enabled=True)
    key = jax.random.PRNGKey(seed)
    want = jax.jit(jgm.alpha_and_nu_moves, static_argnames=("hyp",))(
        key, e_j, m["Tl"], m["Ml"], hyp=hyp_j)
    k, k_nu = jax.random.split(key)
    scale, u = [], []
    for _ in range(10):
        k, k_s, k_acc = jax.random.split(k, 3)
        scale.append(jax.random.uniform(k_s, (), jnp.float64, 0.90,
                                        1.0 / 0.90))
        u.append(jax.random.uniform(k_acc, (), jnp.float64, 1e-300, 1.0))
    hyp = PriorConfig(alpha_move_enabled=True)
    alpha = gm.alpha_core(e, T(m["Tl"]), T(m["Ml"]), hyp, T(scale), T(u))
    _close(alpha, want.alpha, rtol=1e-10)
    assert float(want.alpha) != 0.5 + seed
    g = jax.random.gamma(k_nu, m["Ml"].astype(jnp.float64) + want.alpha,
                         dtype=jnp.float64)
    got = gm.nu_core(e, alpha, T(m["Tl"]), T(m["Ml"]), T(g))
    _close(got.nu, want.nu, rtol=1e-10)
    _close(got.alpha, want.alpha, rtol=1e-10)


@pytest.mark.parametrize("mu_move", [True, False])
def test_mpox_hack_moves_from_replayed_draws(move_inputs, mu_move):
    m = move_inputs
    hyp = dict(mpox_enabled=True, mu_move_enabled=mu_move)
    M_star = int(m["Mb"][1, 1, 3] + m["Mb"][1, 2, 0])
    assert M_star > 0
    for seed in range(3):
        key = jax.random.PRNGKey(50 + seed)
        want = jax.jit(jgm.mpox_hack_moves, static_argnames=("hyp",))(
            key, m["e_j"], m["Mb"], m["M"], m["Tb"],
            hyp=JPriorConfig(**hyp))
        k, g_mu, g_rho = key, [], []
        for _ in range(10):
            k, k_mu, k_rho = jax.random.split(k, 3)
            g_mu.append(jax.random.gamma(
                k_mu, m["M"].astype(jnp.float64), dtype=jnp.float64))
            g_rho.append(jax.random.gamma(k_rho, M_star + 1.0, (64,),
                                          jnp.float64))
        got = gm.mpox_hack_core(m["e"], T(m["Mb"]), T(m["M"]), T(m["Tb"]),
                                PriorConfig(**hyp), T(g_mu), T(g_rho))
        for f in ("mu", "mpox_rho", "q_tab"):
            _close(getattr(got, f), getattr(want, f), rtol=1e-10, msg=f)
        assert float(want.mpox_rho) != 0.4


# ---------------------------------------------------------------------------
# CPU Runs of each model option
# ---------------------------------------------------------------------------

OPTIONS = {
    "skygrid-staircase": dict(pop_model="skygrid", skygrid_num_parameters=8),
    "skygrid-log-linear": dict(pop_model="skygrid", skygrid_num_parameters=8,
                               skygrid_type=pop.LOG_LINEAR),
    "alpha": dict(alpha=True),
    "mpox": dict(mpox_hack=True),
}
RUN_KW = dict(num_cells=64, local_moves_per_global_move=300,
              device_partitions=3)


def _kw(option, hyp_cls):
    kw = dict(OPTIONS[option])
    if kw.pop("alpha", False):
        kw["hyp"] = hyp_cls(alpha_move_enabled=True)
    return kw


def _jax_twin(run, jrun):
    """``jrun`` put into ``run``'s state: tree, parameters, ledger, step."""
    jrun.ts = jstate.TreeState(**{f: jnp.asarray(v.numpy()) for f, v in
                                  run.ts._asdict().items()})
    jrun.evo = jevo.EvoParams(**{f: jnp.asarray(v.numpy()) for f, v in
                                 run.evo._asdict().items()})
    if isinstance(run.pop, pop.SkygridPopParams):
        jrun.pop = jpop.SkygridPopParams(
            x=jnp.asarray(run.pop.x.numpy()),
            gamma=jnp.asarray(run.pop.gamma.numpy()), type=run.pop.type,
            tau=jnp.asarray(run.pop.tau.numpy()))
    else:
        jrun.pop = jpop.ExpPopParams(**{f: jnp.asarray(v.numpy()) for f, v
                                        in run.pop._asdict().items()})
    jrun.ledger = JLedger(*[jnp.float64(float(v)) for v in run.ledger])
    jrun.step = run.step
    return jrun


@functools.lru_cache(maxsize=None)
def _stepped(option):
    """(option, port Run after 4 boundaries and 2 bursts, a JAX Run of the
    same construction, the port Run's initial evo and pop)."""
    tree = _sim_tree()
    run = Run(tree, seed=5, device="cpu", **RUN_KW,
              **_kw(option, PriorConfig))
    jrun = JRun(tree, seed=5, **RUN_KW, **_kw(option, JPriorConfig))
    init = (run.evo, run.pop)
    for _ in range(2):
        run.do_mcmc_steps(2 * run.local_moves_per_global_move)
    return option, run, jrun, init


@pytest.fixture(scope="module", params=list(OPTIONS))
def runs(request):
    return _stepped(request.param)


def test_run_starts_where_the_jax_run_starts(runs):
    option, run, jrun, (e, p) = runs
    assert dataclasses.asdict(run.hyp) == dataclasses.asdict(jrun.hyp)
    for f in e._fields:
        assert np.array_equal(getattr(e, f).numpy(),
                              np.asarray(getattr(jrun.evo, f))), f
    if option.startswith("skygrid"):
        assert p.type == jrun.pop.type
        for f in ("x", "gamma", "tau"):      # host_rng's draws included
            assert np.array_equal(getattr(p, f).numpy(),
                                  np.asarray(getattr(jrun.pop, f))), f
    else:
        for f in p._fields:
            assert float(getattr(p, f)) == float(getattr(jrun.pop, f)), f


def test_run_keeps_its_ledger_and_matches_jax_recompute(runs):
    option, run, jrun, _init = runs
    assert run.burst_count >= 2 and run.dispatch_count >= 2
    run.check_derived_quantities(1e-6)
    run.tree().check_integrity()
    twin = _jax_twin(run, jrun)
    want = _calc_ledger_jit(twin.ts, twin.evo, twin.pop,
                            jnp.float64(run.t_max_tip), run.num_cells,
                            twin.hyp)
    got = run.calc_cur_ledger()
    for f in got._fields:
        assert float(getattr(got, f)) == pytest.approx(
            float(getattr(want, f)), abs=1e-8), f
    if option == "mpox":
        assert float(run.evo.mpox_rho) > 0.0
        assert float(run.evo.kappa) == 1.0       # no HKY moves
    if option == "alpha":
        assert float(run.evo.alpha) != 10.0
        assert float(run.evo.nu.std()) > 0.0


def test_snapshot_resumes_each_option_exactly(runs, tmp_path):
    option, run, _jrun, _init = runs
    path = tmp_path / f"{option}.npz"
    snapshot.save_run(run, path)
    run2 = snapshot.load_run(path, device="cpu")
    assert run2.mpox_hack == run.mpox_hack and run2.hyp == run.hyp
    assert type(run2.pop) is type(run.pop)
    for a, b in zip(convert.to_numpy(run2.evo).values(),
                    convert.to_numpy(run.evo).values()):
        assert np.array_equal(a, b)
    lm = run.local_moves_per_global_move
    run.do_mcmc_steps(3 * lm)
    run2.do_mcmc_steps(3 * lm)
    assert run.log_posterior == run2.log_posterior
    assert torch.equal(run.ts.t, run2.ts.t)


@pytest.mark.parametrize("option", ["skygrid-log-linear", "alpha"])
def test_writers_equal_jax_from_the_same_state(option):
    """.log line, .trees, BEAST XML and the .dphy flatbuffers of a skygrid
    and of an alpha run, written by both packages from the same state."""
    _o, run, jrun, _init = _stepped(option)
    twin = _jax_twin(run, jrun)
    sky = option.startswith("skygrid")
    # the JAX writer reads a growth rate that a skygrid lacks: without that
    # column both write the same line
    flags = dict(alpha_move_enabled=not sky,
                 pop_growth_rate_move_enabled=not sky)
    got, want = io.StringIO(), io.StringIO()
    for mod, r, fh in ((beast_out, run, got), (jbeast_out, twin, want)):
        out = mod.BeastLogOutput(fh, **flags)
        out.write_headers(r.tree())
        out.write_line(r)
        t = mod.BeastTreesOutput(fh)
        t.write_preamble(r.tree())
        t.write_tree(r.tree(), r.step)
        t.write_epilog()
    assert got.getvalue() == want.getvalue()
    exports = (["export_beast_x_xml"] if sky else
               ["export_beast2_xml", "export_beast2_7_xml",
                "export_beast_x_xml"])
    for fn in exports:
        a, b = io.StringIO(), io.StringIO()
        getattr(beast_xml, fn)(a, run.tree(), run)
        getattr(jbeast_xml, fn)(b, twin.tree(), twin)
        assert a.getvalue() == b.getvalue() and "<beast" in a.getvalue(), fn
    if sky:     # as in the JAX package
        with pytest.raises(ValueError, match="Skygrid"):
            beast_xml.export_beast2_7_xml(io.StringIO(), run.tree(), run)
    assert dphy.build_params_fb(run) == jdphy.build_params_fb(twin)
    assert dphy.build_tree_fb(run.tree()) == jdphy.build_tree_fb(twin.tree())
    parsed = jdphy.parse_params_fb(dphy.build_params_fb(run))
    assert parsed["pop_model"]["kind"] == ("skygrid" if sky else "exp")


@pytest.mark.parametrize("option", ["skygrid-staircase",
                                    "skygrid-log-linear"])
def test_skygrid_log_line_has_a_growth_rate(option):
    """With the default columns the port's .log line carries a skygrid's
    growth rate: the slope of log N at the last tip (0 on a staircase)."""
    _o, run, _jrun, _init = _stepped(option)
    fh = io.StringIO()
    out = beast_out.BeastLogOutput(fh)
    out.write_headers(run.tree())
    out.write_line(run)
    header, line = fh.getvalue().splitlines()
    vals = dict(zip(header.split("\t"), line.split("\t")))
    hv = run.host_view()
    t0 = float(hv.t[:run.ts.num_tips].max())
    x, g = hv.pop.x, hv.pop.gamma
    k = int(np.searchsorted(x, t0, side="left"))
    slope = 0.0 if option.endswith("staircase") else \
        (g[k] - g[k - 1]) / (x[k] - x[k - 1]) * 365.0
    assert float(vals["growthRate"]) == pytest.approx(slope, rel=1e-5,
                                                      abs=1e-12)
    assert float(vals["ePopSize"]) == pytest.approx(
        float(np.exp(pop.host_eval(pop.skygrid_log_N, hv.pop, t0))) / 365.0,
        rel=1e-5)
