"""The port's unpartitioned MCMC step (``delphy_tpu_torch/mcmc/moves.py``,
``run_local_sweep``, ``super_step`` and ``multi_super_step`` of
``mcmc/kernel.py``, ``displace_delta`` and the exact coalescent prior)
against the JAX package on the same numpy-seeded inputs, in f64 on the CPU:

- ``bounded_exp_core`` against JAX's sampler from identical uniforms
  (rtol 1e-12), and the port's generator-driven sampler's statistics (the
  JAX package's ``test_bounded_exp_*`` checks);
- ``displace_delta`` against JAX's and a full recompute (1e-9); the exact
  prior against JAX's (1e-12) and the grid prior converging to it;
- every move fed JAX's own draws (replayed from the keys as ``moves.py``
  splits them): t, mut_t, k_bar, the ledger and n_attempted (1e-12); each
  move's generator-driven wrapper keeping the ledger (1e-9);
- ``super_step`` with the parameter moves off, its sweep's draws replayed
  from JAX's key chain (1e-10);
- a 2,000-move sweep whose ledger and k_bar equal their recomputes (1e-9),
  ``multi_super_step`` bit-equal to single steps, the JAX function's
  filler-slot writes onto node 0 (a reference behaviour), and the
  ``__graft_entry__.entry`` problem through the port's ``super_step``.
"""

import math
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from delphy_tpu import pop as jpop
from delphy_tpu.evo import make_evo_params as j_make_evo_params
from delphy_tpu.mcmc import global_moves as jgm
from delphy_tpu.mcmc import kernel as jkernel
from delphy_tpu.mcmc import moves as jmoves
from delphy_tpu.mcmc.global_moves import PriorConfig as JPriorConfig
from delphy_tpu.mcmc.moves import Ledger as JLedger
from delphy_tpu.ops import coalescent as jcoal
from delphy_tpu.ops import likelihood as jlk
from delphy_tpu.ops.exact_coalescent import \
    exact_coalescent_log_prior as j_exact_prior
from delphy_tpu.phylo import Mutation, build_random_tree as j_random_tree
from delphy_tpu.run import Run as JRun
from delphy_tpu.sim import simulate_dataset as j_simulate
from delphy_tpu.state import pack_state as j_pack_state

from delphy_tpu_torch import convert
from delphy_tpu_torch.mcmc import global_moves as gm
from delphy_tpu_torch.mcmc import kernel, moves
from delphy_tpu_torch.mcmc.global_moves import PriorConfig
from delphy_tpu_torch.ops import coalescent as coal
from delphy_tpu_torch.ops import likelihood as lk
from delphy_tpu_torch.ops.exact_coalescent import exact_coalescent_log_prior
from delphy_tpu_torch.phylo import build_random_tree
from delphy_tpu_torch.run import Run
from delphy_tpu_torch.sim import simulate_dataset

# these tests run in float64, the port's default precision
DTYPE = torch.float64

C = 128
K_MAX = max(8, C // 2)
B = kernel.REFORM_BATCH
F64 = jnp.float64


def T(x):
    a = np.asarray(x)
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(a.astype(np.float64))
    if a.dtype == bool:
        return torch.as_tensor(a.copy())
    return torch.as_tensor(a.astype(np.int64))


def _close(got, want, rtol=1e-12, atol=1e-12, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# a state on both sides
# ---------------------------------------------------------------------------

def _sim_tree(windows: bool, tip0_window: bool = False):
    """The tree of tests/test_batched_moves.py (14 x 150, seed 91).  With
    ``windows``, tips 1.. get 3-day date windows (tip 0 too with
    ``tip0_window``) and three tip branches carry a site mutated twice
    (a -> c -> b), so reforms must keep a site's order."""
    ref, deltas, miss, dates, names, _ = j_simulate(14, 150, mu=2e-4,
                                                    seed=91)
    if windows:
        dates = [(d[0] - 1.5, d[0] + 1.5) if (i or tip0_window) else d
                 for i, d in enumerate(dates)]
    tree = j_random_tree(ref, deltas, miss, dates, names=names,
                         rng=np.random.default_rng(91))
    if windows:
        done = 0
        for i in range(1, tree.num_tips):
            if done == 3 or not tree.mutations[i]:
                continue
            m = tree.mutations[i][0]
            c = next(s for s in range(4) if s not in (m.from_, m.to))
            t_p = tree.t[tree.parent[i]]
            t1 = t_p + 0.3 * (m.t - t_p)
            tree.mutations[i][0] = Mutation(m.site, m.from_, c, t1)
            tree.mutations[i].append(Mutation(m.site, c, m.to, m.t))
            tree.mutations[i].sort(key=lambda mu: mu.key())
            done += 1
        assert done == 3
    tree.check_integrity()
    return tree


def _jax_state(tree, g=0.002):
    ts = j_pack_state(tree)
    evo = j_make_evo_params(tree.num_sites, mu=2e-4, kappa=2.0)
    pop_j = jpop.ExpPopParams(t0=F64(200.0), n0=F64(500.0), g=F64(g),
                              min_pop=F64(1.0))
    t_max_tip = float(np.max(tree.t_max[:tree.num_tips]))
    caches = jgm.compute_caches(ts, evo)
    t_root = float(ts.t[ts.root])
    span = max(t_max_tip - t_root, 1.0)
    t_lo = t_root - 0.35 * span - 1.0
    grid = jcoal.make_grid(pop_j, ts.t, ts.is_tip, t_lo,
                           (t_max_tip - t_lo) / C, C)
    ledger = JLedger(
        log_G=jlk.calc_log_G(ts, evo, caches.lambda_i, caches.root_freq),
        log_coal=jcoal.calc_log_prior(grid, pop_j, ts.t, ts.is_tip),
        log_other=F64(0.0))
    return dict(ts=ts, evo=evo, pop=pop_j, caches=caches, grid=grid,
                ledger=ledger, t_max_tip=t_max_tip)


def _to_port(j):
    return dict(
        ts=convert.tree_state_to_torch(j["ts"], device="cpu"),
        evo=convert.evo_params_to_torch(j["evo"], device="cpu"),
        pop=convert.exp_pop_to_torch(j["pop"], device="cpu"),
        caches=moves.Caches(*[T(x) for x in j["caches"]]),
        grid=coal.CoalGrid(*[T(x) for x in j["grid"]]),
        ledger=moves.Ledger(*[T(x) for x in j["ledger"]]),
        t_max_tip=j["t_max_tip"])


@pytest.fixture(scope="module")
def pair():
    j = _jax_state(_sim_tree(windows=True))
    return j, _to_port(j)


def _carry(s):
    return (s["ts"], s["caches"], s["grid"], s["ledger"])


def _same_state(got, want, fields=("t", "mut_t"), tol=1e-12):
    ts, grid, ledger = got
    ts_j, grid_j, ledger_j = want
    for f in fields:
        _close(getattr(ts, f), getattr(ts_j, f), rtol=tol, atol=tol, msg=f)
    _close(grid.k_bar, grid_j.k_bar, rtol=tol, atol=tol, msg="k_bar")
    for f in ("log_G", "log_coal", "log_other"):
        _close(getattr(ledger, f), getattr(ledger_j, f), rtol=tol, atol=tol,
               msg=f)


def _recompute(ts, evo, pop_params, grid):
    """(log_G, log_coal, k_bar) from scratch on the same grid spec."""
    caches = gm.compute_caches(ts, evo)
    log_G = lk.calc_log_G(ts, evo, caches.lambda_i, caches.root_freq)
    k_bar = coal.calc_k_bar(ts.t, ts.is_tip, grid.t_lo, grid.t_step,
                            grid.num_cells)
    log_coal = coal.calc_log_prior(grid._replace(k_bar=k_bar), pop_params,
                                   ts.t, ts.is_tip)
    return float(log_G), float(log_coal), k_bar


# ---------------------------------------------------------------------------
# JAX's draws, split as moves.py and kernel.py split them
# ---------------------------------------------------------------------------

def _u(key, shape=(), lo=1e-300):
    return jax.random.uniform(key, shape, F64, minval=lo, maxval=1.0)


def j_seq_draws(keys, inner: bool, T_, N):
    """(node, u, z, u_acc) of inner_node_displace / tip_displace."""
    k_node, k_prop, k_acc = keys
    node = (T_ + jax.random.randint(k_node, (), 0, N - T_) if inner
            else jax.random.randint(k_node, (), 0, T_))
    return (int(node), float(_u(k_prop)),
            float(jax.random.normal(k_prop, (), F64)), float(_u(k_acc)))


def j_batched_draws(key, N):
    """(offset, pri, u, u_acc) of batched_node_displace."""
    k_off, k_pri, k_prop, k_acc = jax.random.split(key, 4)
    return (int(jax.random.randint(k_off, (), 0, 4)),
            np.asarray(jax.random.uniform(k_pri, (N,), F64, 0.0, 1.0)),
            np.asarray(_u(k_prop, (K_MAX,))), np.asarray(_u(k_acc, (K_MAX,))))


def j_reform_draws(key, N, M):
    """(chosen, u, u_acc) of batched_branch_reform."""
    k_sel, k_t, k_acc = jax.random.split(key, 3)
    return (np.asarray(jax.random.permutation(k_sel, N)[:B]),
            np.asarray(_u(k_t, (M,), lo=1e-16)), np.asarray(_u(k_acc, (N,))))


def j_sweep_draws(key, ts, n_blocks):
    """A port SweepDraws replaying run_local_sweep's key chain
    (delphy_tpu/mcmc/kernel.py:166-189)."""
    T_, N, M = ts.num_tips, ts.num_nodes, ts.mut_t.shape[0]
    rows = {f: [] for f in kernel.SweepDraws._fields}
    for _ in range(n_blocks):
        seq = []
        for _ in range(kernel.SEQ_DISP_PER_BLOCK):
            key, k_sel, k_node, k_prop, k_acc = jax.random.split(key, 5)
            inner = bool(jax.random.uniform(k_sel, (), F64, 0.0, 1.0) < 0.5)
            seq.append((not inner,) + j_seq_draws((k_node, k_prop, k_acc),
                                                  inner, T_, N))
        for f, col in zip(("seq_tip", "seq_node", "seq_u", "seq_z",
                           "seq_u_acc"), zip(*seq)):
            rows[f].append(col)
        key, k_disp, k_reform = jax.random.split(key, 3)
        for f, v in zip(("offset", "pri", "disp_u", "disp_u_acc"),
                        j_batched_draws(k_disp, N)):
            rows[f].append(v)
        for f, v in zip(("chosen", "reform_u", "reform_u_acc"),
                        j_reform_draws(k_reform, N, M)):
            rows[f].append(v)
    return kernel.SweepDraws(**{f: T(np.array(v)) for f, v in rows.items()})


# ---------------------------------------------------------------------------
# bounded exponential
# ---------------------------------------------------------------------------

BEXP_CASES = [(2.3, 2.0, 5.0), (-2.3, 2.0, 5.0), (0.0, -1.0, 3.0),
              (40.0, 0.0, 1.0), (-0.01, -100.0, 100.0), (100.0, 0.0, 1.0),
              (-90.0, 2.0, 3.0)]


@pytest.mark.parametrize("lam,a,b", BEXP_CASES)
def test_bounded_exp_core_matches_jax(lam, a, b):
    keys = jax.random.split(jax.random.PRNGKey(3), 256)
    want = np.asarray(jax.vmap(lambda k: jmoves.bounded_exp_sample(
        k, F64(lam), F64(a), F64(b)))(keys))
    u = np.asarray(jax.vmap(lambda k: _u(k))(keys))
    got = moves.bounded_exp_core(T(u), torch.tensor(lam, dtype=DTYPE),
                                 torch.tensor(a, dtype=DTYPE),
                                 torch.tensor(b, dtype=DTYPE))
    _close(got, want, rtol=1e-12, atol=0.0)
    assert np.all(want >= a) and np.all(want <= b)


def _bexp_samples(lam, a, b, n, seed):
    gen = torch.Generator().manual_seed(seed)
    full = torch.full((n,), 0.0, dtype=DTYPE)
    return moves.bounded_exp_sample(gen, full + lam, full + a,
                                    full + b).numpy()


@pytest.mark.parametrize("check", [
    ("mean", 2.3, 2.0, 5.0), ("mean", -2.3, 2.0, 5.0),
    ("mean", 0.0, -1.0, 3.0), ("mean", 40.0, 0.0, 1.0),
    ("mean", -0.01, -100.0, 100.0), ("quantiles", 1.7, -1.0, 2.0),
    ("semi_infinite", 2.3, -1e6, 5.0), ("semi_infinite", -2.3, 3.0, 1e6)])
def test_bounded_exp_sampler_statistics(check):
    """The JAX package's test_bounded_exp_* checks on the port's sampler
    (tests/test_distributions.py:36-90): samples in [a, b]; the mean within
    5 sigma; the quartiles' empirical CDF within 5 binomial sigma; a
    semi-infinite window's distance from its finite end Expo(|lam|)."""
    kind, lam, a, b = check
    n = 40_000 if kind != "semi_infinite" else 20_000
    xs = _bexp_samples(lam, a, b, n, seed=zlib.crc32(repr(check).encode()))
    assert np.all(xs >= a) and np.all(xs <= b)
    if kind == "mean":
        if lam == 0.0:
            mean, var = (a + b) / 2.0, (b - a) ** 2 / 12.0
        else:
            ew = math.expm1(lam * (b - a))
            mean = a + ((b - a) * (ew + 1.0)) / ew - 1.0 / lam
            var = np.var(xs)
        assert abs(xs.mean() - mean) / math.sqrt(max(var, 1e-30) / n) < 5.0
    elif kind == "quantiles":
        for q in (0.1, 0.25, 0.5, 0.75, 0.9):
            x_q = a + math.log1p(q * math.expm1(lam * (b - a))) / lam
            sd = math.sqrt(q * (1 - q) / n)
            assert abs(np.mean(xs <= x_q) - q) < 5 * sd, q
    else:
        d = b - xs if lam > 0 else xs - a
        assert abs(d.mean() - 1 / abs(lam)) < 5 * d.std() / math.sqrt(n)


# ---------------------------------------------------------------------------
# coalescent: displace_delta and the exact prior
# ---------------------------------------------------------------------------

def _small_tree(rng, n_tips=10):
    L = 20
    ref = rng.integers(0, 4, size=L).astype(np.int8)
    dates = [(float(rng.uniform(0, 50)),) * 2 for _ in range(n_tips)]
    return build_random_tree(ref, [[] for _ in range(n_tips)],
                             [[] for _ in range(n_tips)], dates, rng=rng)


@pytest.mark.parametrize("model", ["exp", "skygrid"])
def test_displace_delta_matches_jax_and_recompute(model):
    rng = np.random.default_rng(12345)
    tree = _small_tree(rng)
    is_tip = tree.children[:, 0] == -1
    t_lo, t_step = float(tree.t.min() - 20.0), 2.1
    if model == "exp":
        p_j = jpop.ExpPopParams(t0=F64(50.0), n0=F64(100.0), g=F64(0.01),
                                min_pop=F64(0.0))
        p = convert.exp_pop_to_torch(p_j, device="cpu")
    else:
        x = np.linspace(t_lo, float(tree.t.max()), 6)
        gamma = np.log(np.linspace(40.0, 90.0, 6))
        p_j = jpop.SkygridPopParams(x=jnp.asarray(x), gamma=jnp.asarray(gamma),
                                    type=jpop.LOG_LINEAR, tau=F64(1.0))
        p = convert.skygrid_pop_to_torch(p_j, device="cpu")
    t = torch.as_tensor(tree.t)
    tip_t = torch.as_tensor(is_tip)
    grid = coal.make_grid(p, t, tip_t, torch.tensor(t_lo, dtype=DTYPE),
                          torch.tensor(t_step, dtype=DTYPE), 64)
    grid_j = jcoal.make_grid(p_j, jnp.asarray(tree.t), jnp.asarray(is_tip),
                             t_lo, t_step, 64)
    base = float(coal.calc_log_prior(grid, p, t, tip_t))
    kinds = set()
    for node in range(tree.num_nodes):
        old_t = float(tree.t[node])
        new_t = old_t + float(rng.uniform(-8.0, 8.0))
        tip = bool(is_tip[node])
        kinds.add(tip)
        delta, new_k = coal.displace_delta(
            grid, p, torch.tensor([old_t], dtype=DTYPE),
            torch.tensor([new_t], dtype=DTYPE), torch.tensor([tip]))
        delta_j, new_k_j = jcoal.displace_delta(grid_j, p_j, old_t, new_t,
                                                jnp.bool_(tip))
        _close(delta, [float(delta_j)], rtol=1e-12, atol=1e-12)
        _close(new_k, new_k_j, rtol=1e-12, atol=1e-12)
        t2 = t.clone()
        t2[node] = new_t
        grid2 = coal.make_grid(p, t2, tip_t, grid.t_lo, grid.t_step, 64)
        full = float(coal.calc_log_prior(grid2, p, t2, tip_t))
        _close(delta, [full - base], rtol=0.0, atol=1e-9, msg=f"node {node}")
        _close(new_k, grid2.k_bar, rtol=0.0, atol=1e-9)
    assert kinds == {True, False}


def test_exact_coalescent_prior_matches_jax_and_grid_converges():
    rng = np.random.default_rng(12345)
    tree = _small_tree(rng)
    is_tip = tree.children[:, 0] == -1
    p_j = jpop.ExpPopParams(t0=F64(50.0), n0=F64(80.0), g=F64(0.01),
                            min_pop=F64(1.0))
    p = convert.exp_pop_to_torch(p_j, device="cpu")
    exact = exact_coalescent_log_prior(tree.t, is_tip, p)
    _close(exact, j_exact_prior(tree.t, is_tip, p_j), rtol=1e-12, atol=0.0)
    t_lo = float(tree.t.min() - 3.0)
    span = float(tree.t.max() + 1.0 - t_lo)
    errs = []
    for n_cells in (64, 256, 1024):
        t = torch.as_tensor(tree.t)
        grid = coal.make_grid(p, t, torch.as_tensor(is_tip),
                              torch.tensor(t_lo, dtype=DTYPE),
                              torch.tensor(span / n_cells, dtype=DTYPE),
                              n_cells)
        errs.append(abs(float(coal.calc_log_prior(
            grid, p, t, torch.as_tensor(is_tip))) - exact))
    assert errs[2] < errs[0]
    assert errs[2] < 0.05 * max(abs(exact), 1.0)


# ---------------------------------------------------------------------------
# single moves from replayed JAX draws
# ---------------------------------------------------------------------------

SEEDS = range(40)


@pytest.mark.parametrize("kind", ["inner", "tip"])
def test_single_displace_replays_jax(pair, kind):
    """Inner moves until 24 drew the root and 24 another node (the root's
    Gaussian proposal and window differ), tip moves over 40 keys."""
    j, s = pair
    T_, N = j["ts"].num_tips, j["ts"].num_nodes
    jfn = jax.jit(jmoves.inner_node_displace if kind == "inner"
                  else jmoves.tip_displace)
    root = int(j["ts"].root)
    want = 24 if kind == "inner" else 0
    seen = {"root": 0, "other": 0}
    accepted = {"root": 0, "other": 0}
    for seed in range(800):
        if seed >= 40 and min(seen.values()) >= want:
            break
        keys = tuple(jax.random.split(jax.random.PRNGKey(seed), 3))
        node, u, z, u_acc = j_seq_draws(keys, kind == "inner", T_, N)
        which = "root" if node == root else "other"
        if seed >= 40 and seen[which] >= want:
            continue
        ts_j, _, grid_j, led_j = jfn(_carry(j), keys, j["pop"],
                                     F64(j["t_max_tip"]))
        one = lambda v: torch.tensor([v], dtype=DTYPE)   # noqa: E731
        idx = torch.tensor([node])
        if kind == "inner":
            out = moves.inner_node_displace_core(
                _carry(s), idx, one(u), one(z), one(u_acc), s["pop"],
                s["t_max_tip"])
        else:
            out = moves.tip_displace_core(_carry(s), idx, one(u), one(u_acc),
                                          s["pop"], s["t_max_tip"])
        ts, _, grid, led = out
        _same_state((ts, grid, led), (ts_j, grid_j, led_j))
        seen[which] += 1
        accepted[which] += int(not torch.equal(ts.t, s["ts"].t))
    assert accepted["other"] and seen["other"] > accepted["other"]
    if kind == "inner":
        assert seen["root"] >= want, "too few keys drew the root"
        assert 0 < accepted["root"] < seen["root"]


def test_branch_reform_replays_jax(pair):
    j, s = pair
    N, M = j["ts"].num_nodes, j["ts"].mut_t.shape[0]
    jfn = jax.jit(jmoves.branch_reform)
    accepted = 0
    for seed in SEEDS:
        keys = tuple(jax.random.split(jax.random.PRNGKey(seed), 3))
        k_node, k_prop, k_acc = keys
        X = int(jax.random.randint(k_node, (), 0, N))
        u = np.asarray(_u(k_prop, (M,), lo=1e-16))
        ts_j, _, grid_j, led_j = jfn(_carry(j), keys, j["evo"], j["pop"],
                                     F64(j["t_max_tip"]))
        ts, _, grid, led = moves.branch_reform_core(
            _carry(s), torch.tensor([X]), T(u),
            torch.tensor([float(_u(k_acc))], dtype=DTYPE), s["evo"])
        _same_state((ts, grid, led), (ts_j, grid_j, led_j))
        accepted += int(not torch.equal(ts.mut_t, s["ts"].mut_t))
    assert accepted


# ---------------------------------------------------------------------------
# batched moves from replayed JAX draws
# ---------------------------------------------------------------------------

def test_batched_node_displace_replays_jax(pair):
    j, s = pair
    N = j["ts"].num_nodes
    jfn = jax.jit(jmoves.batched_node_displace, static_argnames=("k_max",))
    n_moved = 0
    for seed in SEEDS[:12]:
        key = jax.random.PRNGKey(seed)
        off, pri, u, u_acc = j_batched_draws(key, N)
        ts_j, grid_j, led_j, n_j = jfn(j["ts"], j["caches"], j["grid"],
                                       j["ledger"], j["pop"], key,
                                       j["t_max_tip"], K_MAX)
        ts, grid, led, n = moves.batched_node_displace_core(
            s["ts"], s["caches"], s["grid"], s["ledger"], s["pop"],
            torch.tensor([off]), T(pri), T(u), T(u_acc), K_MAX)
        # tip 0 has no date window, so no filler write touches a move
        assert float(ts.t[0]) == float(s["ts"].t[0])
        _same_state((ts, grid, led), (ts_j, grid_j, led_j))
        assert int(n) == int(n_j)
        n_moved += int((ts.t != s["ts"].t).sum())
    assert n_moved > 0


def test_batched_branch_reform_replays_jax(pair):
    j, s = pair
    N, M = j["ts"].num_nodes, j["ts"].mut_t.shape[0]
    jfn = jax.jit(jmoves.batched_branch_reform,
                  static_argnames=("batch_size",))
    n_moved = 0
    for seed in SEEDS[:12]:
        key = jax.random.PRNGKey(seed)
        chosen, u, u_acc = j_reform_draws(key, N, M)
        ts_j, led_j = jfn(j["ts"], j["ledger"], j["evo"], key, B)
        ts, led = moves.batched_branch_reform_core(
            s["ts"], s["ledger"], s["evo"], T(chosen), T(u), T(u_acc))
        _same_state((ts, s["grid"], led), (ts_j, j["grid"], led_j))
        n_moved += int((ts.mut_t != s["ts"].mut_t).sum())
    assert n_moved > 0


WRAPPERS = {
    "inner_node_displace": lambda c, g, s: moves.inner_node_displace(
        c, g, s["pop"], s["t_max_tip"]),
    "tip_displace": lambda c, g, s: moves.tip_displace(
        c, g, s["pop"], s["t_max_tip"]),
    "branch_reform": lambda c, g, s: moves.branch_reform(
        c, g, s["evo"], s["pop"], s["t_max_tip"]),
    "batched_node_displace": lambda c, g, s: _batched_displace(c, g, s),
    "batched_branch_reform": lambda c, g, s: _batched_reform(c, g, s),
}


def _batched_displace(carry, gen, s):
    ts, caches, grid, ledger = carry
    ts, grid, ledger, _ = moves.batched_node_displace(
        ts, caches, grid, ledger, s["pop"], gen, s["t_max_tip"], K_MAX)
    return (ts, caches, grid, ledger)


def _batched_reform(carry, gen, s):
    ts, caches, grid, ledger = carry
    ts, ledger = moves.batched_branch_reform(ts, ledger, s["evo"], gen, B)
    return (ts, caches, grid, ledger)


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_generator_wrappers_keep_the_ledger(pair, name):
    """Each move's wrapper, on draws from a torch.Generator, 30 times: the
    state moves and the incremental ledger and k_bar equal the recomputes
    (1e-9)."""
    _, s = pair
    gen = torch.Generator().manual_seed(23)
    carry = _carry(s)
    for _ in range(30):
        carry = WRAPPERS[name](carry, gen, s)
    ts, _, grid, led = carry
    assert not (torch.equal(ts.t, s["ts"].t)
                and torch.equal(ts.mut_t, s["ts"].mut_t))
    log_G, log_coal, k_bar = _recompute(ts, s["evo"], s["pop"], s["grid"])
    assert abs(float(led.log_G) - log_G) < 1e-9
    assert abs(float(led.log_coal) - log_coal) < 1e-9
    _close(grid.k_bar, k_bar, rtol=0.0, atol=1e-9)


# ---------------------------------------------------------------------------
# the slice: super_step, sweeps, multi_super_step
# ---------------------------------------------------------------------------

NO_PARAM_MOVES = dict(mu_move_enabled=False, hky_moves_enabled=False,
                      pop_size_move_enabled=False,
                      pop_growth_rate_move_enabled=False)


def test_super_step_replays_jax_without_parameter_moves(monkeypatch):
    """JAX's super_step and the port's on the same state, the parameter
    moves off (so the boundary is deterministic), the port's sweep fed the
    draws of JAX's key chain: two blocks."""
    tree = _sim_tree(windows=True)
    hyp_j = JPriorConfig(**NO_PARAM_MOVES)
    jrun = JRun(tree, seed=5, hyp=hyp_j, num_cells=C,
                topology_moves_enabled=False)
    n_blocks = 2
    n_moves = n_blocks * (kernel.SEQ_DISP_PER_BLOCK + K_MAX // 2 + B)
    assert kernel.sweep_shape(n_moves, C) == (n_blocks, K_MAX)
    key = jax.random.PRNGKey(17)
    out_j = jkernel.super_step(jrun.ts, jrun.evo, jrun.pop, key, jrun.tin,
                               jrun.tout, n_moves, jrun.t_max_tip, hyp_j, C)
    ts_j, evo_j, pop_j, _key, led_j, stats_j = out_j

    sweep_key = jax.random.split(key, 5)[0]    # kernel.py:47
    draws = j_sweep_draws(sweep_key, jrun.ts, n_blocks)
    monkeypatch.setattr(kernel, "draw_sweep", lambda *a, **k: draws)
    ts0 = convert.tree_state_to_torch(jrun.ts, device="cpu")
    ts, evo, pop_t, led, stats = kernel.super_step(
        ts0, convert.evo_params_to_torch(jrun.evo, device="cpu"),
        convert.exp_pop_to_torch(jrun.pop, device="cpu"), torch.Generator(),
        T(jrun.tin), T(jrun.tout), n_moves, jrun.t_max_tip,
        PriorConfig(**NO_PARAM_MOVES), C)
    for f in ("t", "mut_t"):
        _close(getattr(ts, f), getattr(ts_j, f), rtol=1e-10, atol=1e-10,
               msg=f)
    for f in led._fields:
        _close(getattr(led, f), getattr(led_j, f), rtol=1e-10, atol=1e-10,
               msg=f)
    assert int(stats["local_moves_attempted"]) \
        == int(stats_j["local_moves_attempted"])
    assert not torch.equal(ts.t, ts0.t) and not torch.equal(ts.mut_t,
                                                            ts0.mut_t)


@pytest.mark.parametrize("windows", [False, True])
def test_sweep_ledger_and_kbar_exact(windows):
    """tests/test_batched_moves.py's check on the port's sweep: 2,000
    moves at C=128; the incremental log_G, log_coal and k_bar equal their
    recomputes on the same grid, and mutation times stay on their
    branches.  ``windows`` adds date windows (tip 0's too)."""
    tree = _sim_tree(windows, tip0_window=True)
    j = _jax_state(tree, g=0.0)
    s = _to_port(j)
    gen = torch.Generator().manual_seed(7)
    ts2, grid2, led2, count = kernel.run_local_sweep(
        s["ts"], s["caches"], s["grid"], s["ledger"], s["evo"], s["pop"],
        gen, 2000, s["t_max_tip"])
    assert int(count) > 500, "the sweep attempted too few moves"
    assert not torch.equal(ts2.t, s["ts"].t)
    log_G, log_coal, k_bar = _recompute(ts2, s["evo"], s["pop"], s["grid"])
    assert abs(float(led2.log_G) - log_G) < 1e-9
    assert abs(float(led2.log_coal) - log_coal) < 1e-9
    _close(grid2.k_bar, k_bar, rtol=0.0, atol=1e-9)
    parent, mut_node = ts2.parent.numpy(), ts2.mut_node.numpy()
    mut_t, t = ts2.mut_t.numpy(), ts2.t.numpy()
    for k in np.nonzero((mut_node >= 0) & (mut_node != int(ts2.root)))[0]:
        n = mut_node[k]
        assert t[parent[n]] < mut_t[k] <= t[n] + 1e-12
    if windows:
        assert not np.array_equal(t[:tree.num_tips],
                                  s["ts"].t.numpy()[:tree.num_tips])


def _port_run(seed=3):
    ref, deltas, miss, dates, names, _ = simulate_dataset(12, 200, mu=2e-3,
                                                          seed=seed)
    tree = build_random_tree(ref, deltas, miss, dates, names=names,
                             rng=np.random.default_rng(seed))
    return Run(tree, seed=seed, num_cells=64, device="cpu",
               topology_moves_enabled=False)


def test_multi_super_step_equals_single_steps():
    run = _port_run()
    args = (run.tin, run.tout, 300, run.t_max_tip, run.hyp, run.num_cells)
    gen = torch.Generator().manual_seed(11)
    out_m = kernel.multi_super_step(run.ts, run.evo, run.pop, gen, *args, 3)
    gen = torch.Generator().manual_seed(11)
    state, total = (run.ts, run.evo, run.pop), 0
    for _ in range(3):
        *state, led, stats = kernel.super_step(*state, gen, *args)
        total += int(stats["local_moves_attempted"])
    ts, evo, pop_t, led_m, stats_m = out_m
    for a, b in ((ts, state[0]), (evo, state[1]), (pop_t, state[2]),
                 (led_m, led)):
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert int(stats_m["local_moves_attempted"]) == total
    for k in ("num_muts", "M_ab", "Ttwiddle_a"):
        assert torch.equal(stats_m[k], stats[k]), k
    assert not torch.equal(evo.mu, run.evo.mu)     # the moves ran


def test_filler_slots_do_not_undo_a_move_of_node_0():
    """Tip 0 has a date window.  For the first key whose batched
    displacement moves tip 0, the JAX function writes node 0's old time
    from each unfilled slot after the move (the last write wins on the
    CPU), so its t[0] stays while the move's delta enters its ledger; the
    port writes only its real slots, and its ledger equals the
    recompute."""
    tree = _sim_tree(windows=True, tip0_window=True)
    j = _jax_state(tree)
    s = _to_port(j)
    N = j["ts"].num_nodes
    jfn = jax.jit(jmoves.batched_node_displace, static_argnames=("k_max",))
    for seed in range(300):
        key = jax.random.PRNGKey(seed)
        off, pri, u, u_acc = j_batched_draws(key, N)
        ts, grid, led, n = moves.batched_node_displace_core(
            s["ts"], s["caches"], s["grid"], s["ledger"], s["pop"],
            torch.tensor([off]), T(pri), T(u), T(u_acc), K_MAX)
        if float(ts.t[0]) != float(s["ts"].t[0]):
            break
    else:
        pytest.fail("no key moved tip 0")
    assert int(n) < K_MAX            # unfilled slots exist
    log_G, log_coal, k_bar = _recompute(ts, s["evo"], s["pop"], s["grid"])
    assert abs(float(led.log_G) - log_G) < 1e-9
    assert abs(float(led.log_coal) - log_coal) < 1e-9
    _close(grid.k_bar, k_bar, rtol=0.0, atol=1e-9)
    # the reference: every other node as the port, tip 0 not moved, and a
    # ledger that no longer matches its own state
    ts_j, grid_j, led_j, _ = jfn(j["ts"], j["caches"], j["grid"],
                                 j["ledger"], j["pop"], key, j["t_max_tip"],
                                 K_MAX)
    t_j = np.asarray(ts_j.t)
    assert t_j[0] == float(s["ts"].t[0])
    _close(ts.t[1:], t_j[1:], rtol=1e-12, atol=1e-12)
    _close(led.log_coal, led_j.log_coal, rtol=1e-12, atol=1e-12)
    ts_jt = s["ts"]._replace(t=T(t_j))
    _, log_coal_j, _ = _recompute(ts_jt, s["evo"], s["pop"], s["grid"])
    assert abs(float(led_j.log_coal) - log_coal_j) > 1e-9


def test_graft_entry_problem_through_port_super_step():
    """__graft_entry__.entry's tiny problem (8 x 64, Run(seed=0,
    num_cells=64, local_moves_per_global_move=64), one super_step of 32
    local moves) on the port, on the CPU."""
    ref, deltas, miss, dates, names, _ = simulate_dataset(8, 64, mu=2e-3,
                                                          seed=0)
    tree = build_random_tree(ref, deltas, miss, dates, names=names,
                             rng=np.random.default_rng(0))
    run = Run(tree, seed=0, num_cells=64, local_moves_per_global_move=64,
              device="cpu")
    ts_in = run.ts
    ts, evo, pop_t, led, stats = kernel.super_step(
        run.ts, run.evo, run.pop, run.gen, run.tin, run.tout, 32,
        run.t_max_tip, run.hyp, run.num_cells)
    assert math.isfinite(float(led.log_posterior))
    t_lo, t_step = kernel.boundary_grid_bounds(ts_in, run.t_max_tip,
                                               run.num_cells)
    grid = coal.make_grid(pop_t, ts.t, ts.is_tip, t_lo, t_step,
                          run.num_cells)
    log_G, log_coal, _ = _recompute(ts, evo, pop_t, grid)
    assert abs(float(led.log_G) - log_G) < 1e-9
    assert abs(float(led.log_coal) - log_coal) < 1e-9
    assert abs(float(led.log_other)
               - float(gm.calc_log_other_priors(evo, pop_t, run.hyp))) \
        < 1e-12
    assert int(stats["local_moves_attempted"]) > 32
