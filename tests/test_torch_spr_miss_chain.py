"""The port's missation-aware SPR1 move and its sweeps
(``delphy_tpu_torch/ops/spr_miss.py`` ``spr1_miss_core``,
``spr1_sweep_miss{,_core,_lanes}``) against the JAX package's
``spr1_step_miss`` and ``spr1_sweep_miss``, in float64 on the CPU, at the
JAX tests' chain size (10 tips x 200 sites, 10% missing, seed 41):

- ``spr1_miss_core`` fed the draws rebuilt from each JAX key (laid out as
  ``spr1_step_miss`` splits it; A history attempts a slot) equals the JAX
  step move for move: accept, performable, delta_log_G (1e-12) and the
  tree (fs rows as maps); accepted moves keep the oracle ledger (1e-9);
- ``spr1_sweep_miss_core`` on the draws of JAX's sweep key schedule equals
  ``spr1_sweep_miss``, and a generator-driven sweep replays through
  ``spr1_sweep_miss_core`` exactly;
- the lanes form equals each lane run alone;
- a generator-driven chain keeps the oracle ledger, the tree's integrity,
  the tips' observed data and their missing sites.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import oracles
from delphy_tpu.ops import spr_miss as jm
from test_torch_spr import j_hist_block
from test_torch_spr_miss import T, _close, maps_equal, move_args, trees

from delphy_tpu_torch.ops import spr_miss as pm
from delphy_tpu_torch.ops import spr_move as sm

F64 = jnp.float64
A_REPLAY = 64      # history attempts replayed a slot
MU, TIPS, L = 4e-4, 10, 200


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.partial(jax.jit, static_argnames=("N", "L", "WH_", "H_RT_"))
def j_miss_draws(key, N, L, WH_, H_RT_):
    """A move's draws as spr1_step_miss splits its key: (kx, kreg, ktime,
    kprop, kmh), propose_dev's 3 * BI_MAX keys, each slot's key as
    sample_site_history splits it."""
    kx, kreg, ktime, kprop, kmh = jax.random.split(key, 5)
    keys = jax.random.split(kprop, 3 * jm.BI_MAX).reshape(jm.BI_MAX, 3, 2)
    d = jax.vmap(lambda k: j_hist_block(k, WH_, A_REPLAY))(keys[:, 0])
    u_rt = jax.vmap(lambda k: jax.random.uniform(k, (L,), F64))(keys[:, 1])
    r = jax.vmap(lambda k: j_hist_block(k, H_RT_, A_REPLAY))(keys[:, 2])
    return (jax.random.randint(kx, (), 0, N, dtype=jnp.int32),
            jax.random.uniform(kreg, (), F64),
            jax.random.uniform(ktime, (), F64), d, u_rt, r,
            jax.random.uniform(kmh, (), F64))


def port_draws(key, N, WH_):
    X, u_reg, u_t, d, u_rt, r, u_mh = j_miss_draws(key, N, L, WH_,
                                                   jm.H_RT_MISS)

    def hist(h):
        return sm.HistDraws(T(h[0]), T(h[1]).to(torch.int8), T(h[2]))
    return pm.Spr1MissDraws(T(X).reshape(1), T(u_reg).reshape(1),
                            T(u_t).reshape(1), hist(d), T(u_rt), hist(r),
                            T(u_mh).reshape(1))


@pytest.fixture(scope="module")
def chain():
    jt, pt = trees(TIPS, L, 41, 0.1, mu=MU)
    ctx, ja, pa = move_args(jt, MU)
    # fs width generous, as tests/test_spr_miss.py packs it
    WF_ = 4 * max(len(ms) for ms in jt.mutations) + 32
    jp = jm.pack_tree_miss(jt, WF_=WF_)
    p = pm.pack_tree_miss(pt, WF_=WF_, device="cpu")
    t_max_tip = float(np.max(np.asarray(pt.t_max)[:pt.num_tips]))
    return dict(jt=jt, pt=pt, ctx=ctx, ja=ja, pa=pa, jp=jp, p=p,
                t_max_tip=t_max_tip, WRB=2 * p["rs"].shape[1] + 8,
                WH_=2 * p["msite"].shape[1])


def _logG(tree, c):
    return oracles.log_G(tree, MU, np.asarray(c["ja"]["nu"]),
                         np.asarray(c["ctx"].q), np.asarray(c["ctx"].pi))


def test_spr1_miss_core_matches_jax_steps(chain):
    """16 moves of spr1_miss_core fed each JAX step's draws: the JAX step's
    accept, performable, delta_log_G, log_mh and tree; some moves accept,
    some analyses walk more than one branch info."""
    c = chain
    jp, p, N = c["jp"], c["p"], c["pt"].num_nodes
    key = jax.random.PRNGKey(4)
    lg = _logG(c["pt"], c)
    n_acc = n_perf = n_multi = 0
    for it in range(16):
        key, k = jax.random.split(key)
        want = jm.spr1_step_miss(k, jp, L, c["ja"], F64(c["t_max_tip"]),
                                 WRB=c["WRB"], WH_=c["WH_"])
        got = pm.spr1_miss_core(p, L, c["pa"], c["t_max_tip"],
                                port_draws(k, N, c["WH_"]), c["WRB"])
        assert not bool(got[4]["exhausted"])
        assert bool(got[1]) == bool(want[1]), it
        assert bool(got[3]) == bool(want[3]), it
        _close(got[2], np.reshape(want[2], 1), msg=str(it))
        maps_equal(got[0], want[0], c["pt"], str(it))
        if bool(got[3]):
            _close(got[4]["log_mh"], np.reshape(want[4]["log_mh"], 1))
            n_multi += max(int(got[4]["n_bi_old"]),
                           int(got[4]["n_bi_new"])) > 1
        if bool(got[1]):
            back = pm.unpack_tree_miss(got[0], c["pt"])
            back.check_integrity()
            lg2 = _logG(back, c)
            _close(float(got[2]), lg2 - lg, 1e-9)
            lg = lg2
        n_acc += bool(got[1])
        n_perf += bool(got[3])
        jp, p = want[0], got[0]
    assert n_acc >= 3 and n_perf >= 8 and n_multi >= 1, \
        (n_acc, n_perf, n_multi)


def test_sweep_core_matches_jax_sweep_and_replays_a_generator_sweep(chain):
    """spr1_sweep_miss_core on the draws of JAX's spr1_sweep_miss key
    schedule equals it (tree, counts, delta_log_G 1e-12); the port's
    generator-driven spr1_sweep_miss equals spr1_sweep_miss_core on its
    recorded draws exactly."""
    c = chain
    n = 8
    key = jax.random.PRNGKey(11)
    want = jm.spr1_sweep_miss(key, c["jp"], L, n, c["ja"],
                              F64(c["t_max_tip"]), WRB=c["WRB"],
                              WH_=c["WH_"])
    draws = [port_draws(k, c["pt"].num_nodes, c["WH_"])
             for k in jax.random.split(key, n)]
    got = pm.spr1_sweep_miss_core(c["p"], L, c["pa"], c["t_max_tip"], draws,
                                  c["WRB"])
    assert not bool(got.exhausted)
    assert int(got.n_accepted) == int(want[1]) >= 1
    assert int(got.n_eligible) == int(want[3])
    _close(got.delta_log_G, np.reshape(want[2], 1))
    maps_equal(got.p, want[0], c["pt"])

    gen = torch.Generator().manual_seed(5)
    rec = []
    a = pm.spr1_sweep_miss(gen, c["p"], L, n, c["pa"], c["t_max_tip"],
                           c["WRB"], c["WH_"], record=rec)
    assert int(a.n_accepted) >= 1
    b = pm.spr1_sweep_miss_core(c["p"], L, c["pa"], c["t_max_tip"], rec[0],
                                c["WRB"])
    assert int(a.n_accepted) == int(b.n_accepted)
    assert int(a.n_eligible) == int(b.n_eligible)
    assert torch.equal(a.delta_log_G, b.delta_log_G)
    for k in pm.MISS_KEYS:
        assert torch.equal(a.p[k], b.p[k]), k
    assert rec[0][0].d.steps.dtype == torch.int8
    assert pm.draw_bytes(rec[0]) == n * pm.draw_bytes(rec[0][0])


def test_lanes_equal_lanes_run_one_by_one(chain):
    """spr1_sweep_miss_lanes over 2 lanes: each lane equal (exactly) to
    spr1_sweep_miss_core on that lane's own draws."""
    c = chain
    gen = torch.Generator().manual_seed(31)
    rec = []
    lanes = pm.spr1_sweep_miss_lanes(gen, [c["p"]] * 2, L, 6, c["pa"],
                                     c["t_max_tip"], c["WRB"], c["WH_"],
                                     record=rec)
    assert len(rec) == 2
    for lane, draws in zip(lanes, rec):
        one = pm.spr1_sweep_miss_core(c["p"], L, c["pa"], c["t_max_tip"],
                                      draws, c["WRB"])
        assert int(one.n_accepted) == int(lane.n_accepted)
        assert torch.equal(one.delta_log_G, lane.delta_log_G)
        for k in pm.MISS_KEYS:
            assert torch.equal(one.p[k], lane.p[k]), k
    assert sum(int(x.n_accepted) for x in lanes) >= 1


def test_generator_chain_keeps_the_oracle_ledger(chain):
    """Three generator-driven sweeps of 10 moves: the summed delta_log_G
    equals the oracle log_G difference (1e-9), the tree stays valid, every
    tip keeps its observed sequence and its missing sites."""
    c = chain
    pt = c["pt"]
    gen = torch.Generator().manual_seed(6)
    p = c["p"]
    lg0 = _logG(pt, c)
    obs = []
    for i in range(pt.num_tips):
        miss = np.zeros(L, bool)
        miss[list(pt.missing_sites_at(i))] = True
        obs.append((pt.sequence_at(i).copy(), miss))
    total, n_acc = 0.0, 0
    for _ in range(3):
        res = pm.spr1_sweep_miss(gen, p, L, 10, c["pa"], c["t_max_tip"],
                                 c["WRB"], c["WH_"])
        p = res.p
        total += float(res.delta_log_G)
        n_acc += int(res.n_accepted)
    back = pm.unpack_tree_miss(p, pt)
    back.check_integrity()
    _close(_logG(back, c) - lg0, total, 1e-9)
    for i, (seq, miss) in enumerate(obs):
        got = back.sequence_at(i)
        assert (got[~miss] == seq[~miss]).all(), i
        now = np.zeros(L, bool)
        now[list(back.missing_sites_at(i))] = True
        assert (now == miss).all(), i
    assert n_acc >= 3, n_acc
