"""The port's mpox model (``Run(mpox_hack=True)``) against the plain
PyTorch reference ``plain_mpox_torch.py``, on the CPU at a small size: a
CPU Run's final state after a few boundaries on APOBEC3-shaped genomes,
its statistics worked out by the port and by the reference.  A float32
copy of the state fails the tolerances.  This file imports no jax, so its
card test, the same comparison on the committed mpox cell's dataset,
runs on a host that has none:

    python -m pytest tests/test_plain_mpox.py -m cuda --noconftest -s
"""

import ast
import os

import numpy as np
import pytest
import torch

import plain_mpox_torch as plain
from benchmarks.frozen.sim_apobec import simulate_apobec_dataset
from delphy_tpu_torch import evo as evom
from delphy_tpu_torch.init_tree import build_initial_tree
from delphy_tpu_torch.mcmc import global_moves as gm
from delphy_tpu_torch.mcmc.global_moves import PriorConfig
from delphy_tpu_torch.ops import likelihood as lk
from delphy_tpu_torch.phylo import NO_NODE
from delphy_tpu_torch.run import Run
from delphy_tpu_torch.state import pack_state

F64 = torch.float64
# The port sums Ttwiddle by prefix sums over sites and scatter-adds over
# the flat pools, the reference branch by branch and mutation by mutation:
# the same float64 terms in another order, a relative difference of a few
# 1e-16 times the terms' count.  1e-12 leaves that a thousandfold room,
# and float32 (6e-8 a rounding) misses it by four orders.
RTOL = 1e-12


def plain_tree(tree, nu, missing) -> plain.PlainTree:
    """The reference's view of a port's host tree: parents, times, the
    mutations of every branch (not those above the root), the first tip's
    sequence, nu and the tips' missing sites, on ``nu``'s device."""
    dev = nu.device
    rows = [(n, m.site, m.from_, m.to, m.t)
            for n in range(tree.num_nodes) if n != tree.root
            for m in tree.mutations[n]]
    node, site, frm, to, t = (zip(*rows) if rows else ((),) * 5)

    def long(x):
        return torch.tensor(list(x), dtype=torch.long, device=dev)
    parent = np.where(np.asarray(tree.parent) == NO_NODE, -1,
                      np.asarray(tree.parent))
    return plain.PlainTree(
        parent=long(parent), t=torch.tensor(np.asarray(tree.t), dtype=F64,
                                            device=dev),
        mut_node=long(node), mut_site=long(site), mut_from=long(frm),
        mut_to=long(to), mut_t=torch.tensor(list(t), dtype=F64, device=dev),
        seq0=torch.as_tensor(tree.sequence_at(0), device=dev).long(),
        nu=nu.to(F64), missing=torch.as_tensor(missing, device=dev))


def missing_sites(miss, num_sites: int) -> np.ndarray:
    out = np.zeros((len(miss), num_sites), dtype=bool)
    for i, ivs in enumerate(miss):
        for s, e in ivs:
            out[i, s:e] = True
    return out


def port_stats(tree, evo, device, dtype=F64) -> dict:
    """The port's statistics and log_G of a host tree under ``evo``."""
    ts = pack_state(tree, device=device, dtype=dtype)
    evo = evom.EvoParams(*[x.to(device=device, dtype=dtype)
                           if x.is_floating_point() else x.to(device)
                           for x in evo])
    tin, tout = (torch.as_tensor(a, device=device)
                 for a in tree.euler_positions())
    Mb = lk.calc_num_muts_beta_ab(ts, evo)
    Tb = lk.calc_Ttwiddle_beta_a(ts, evo, tin, tout,
                                 lk.calc_ref_state_prefix_beta(ts, evo))
    caches = gm.compute_caches(ts, evo)
    return {"M_beta_ab": Mb, "Ttwiddle_beta_a": Tb,
            "num_muts": lk.calc_num_muts(ts),
            "log_G": float(lk.calc_log_G(ts, evo, caches.lambda_i,
                                         caches.root_freq))}


def rel(got, want) -> float:
    got = torch.as_tensor(got, dtype=F64).cpu()
    want = torch.as_tensor(want, dtype=F64).cpu()
    return float(torch.max(torch.abs(got - want)
                           / torch.clamp(torch.abs(want), min=1e-300)))


@pytest.fixture(scope="module")
def state():
    L = 1500
    ref, deltas, miss, dates, names = simulate_apobec_dataset(
        40, L, mu=1e-5, rho=40.0, pi=(0.33, 0.17, 0.17, 0.33),
        missing_fraction=0.05, seed=5)
    tree = build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(5))
    seq0 = tree.sequence_at(0)
    run = Run(tree, seed=5, num_cells=128, device="cpu", mpox_hack=True,
              pop_model="exp")
    run.do_mcmc_steps(6 * run.local_moves_per_global_move)
    final = run.tree()
    assert list(final.name[:40]) == list(names)
    hv = run.host_view()
    pt = plain_tree(final, run.evo.nu, missing_sites(miss, L))
    part = plain.apobec_partition(seq0)
    return {"seq0": seq0, "run": run, "tree": final, "hv": hv, "plain": pt,
            "part": part, "want": plain.statistics(pt, part),
            "got": port_stats(final, run.evo, "cpu")}


def test_the_reference_imports_torch_alone():
    """No jax, nothing of either package and no kernel: the reference
    imports torch and the standard library's typing alone."""
    path = os.path.join(os.path.dirname(__file__), "plain_mpox_torch.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    assert names == {"__future__", "typing", "torch"}


def test_partition_table_equals_the_reference(state):
    seq0 = state["seq0"]
    assert torch.equal(state["part"],
                       torch.as_tensor(evom.apobec_context_partition(seq0),
                                       dtype=torch.long))
    assert torch.equal(state["part"], state["run"].evo.part.long())
    assert 0 < int(state["part"].sum()) < len(seq0)
    rng = np.random.default_rng(3)
    for _ in range(3):
        seq = rng.integers(0, 4, 2000)
        assert torch.equal(
            plain.apobec_partition(seq),
            torch.as_tensor(evom.apobec_context_partition(seq),
                            dtype=torch.long))


@pytest.mark.parametrize("rho", [0.0, 0.37, 2.5, 40.0])
def test_q_tab_equals_the_reference(rho):
    got = evom.mpox_q_tab(torch.tensor(rho, dtype=F64))
    assert torch.equal(got, plain.mpox_q_tab(rho))


def test_mutation_counts_equal_the_reference(state):
    got, want = state["got"], state["want"]
    assert torch.equal(got["M_beta_ab"], want["M_beta_ab"])
    assert int(got["num_muts"]) == want["M"]
    assert want["M_star"] > 0 and want["M"] > want["M_star"]


def test_Ttwiddle_beta_a_matches_the_reference(state):
    got, want = state["got"], state["want"]
    assert rel(got["Ttwiddle_beta_a"], want["Ttwiddle_beta_a"]) < RTOL
    assert want["Tt_star"] > 0.0


def test_mpox_rounds_match_the_reference(state):
    """Ten rounds of the port's core and of the reference's round from the
    same variates, each from its own statistics: mu, rho and Q_1 agree
    within RTOL (the statistics' own difference, carried through the
    divisions)."""
    got, want, evo = state["got"], state["want"], state["run"].evo
    gen = torch.Generator().manual_seed(11)
    g_mu = torch._standard_gamma(
        torch.full((10,), float(want["M"]), dtype=F64), generator=gen)
    g_rho = torch._standard_gamma(
        torch.full((10, gm.N_TRUNC_GAMMA), want["M_star"] + 1.0,
                   dtype=F64), generator=gen)
    out = gm.mpox_hack_core(evo, got["M_beta_ab"], got["num_muts"],
                            got["Ttwiddle_beta_a"],
                            PriorConfig(mpox_enabled=True), g_mu, g_rho)
    mu, rho = float(evo.mu), float(evo.mpox_rho)
    for i in range(10):
        mu, rho = plain.mpox_round(want, mu, rho, g_mu[i], g_rho[i])
    assert rho != float(evo.mpox_rho)
    assert rel(out.mu, mu) < RTOL and rel(out.mpox_rho, rho) < RTOL
    assert rel(out.q_tab, plain.mpox_q_tab(rho)) < RTOL


def test_ledger_log_G_matches_the_reference(state):
    """The ledger's log_G after the Run's steps (its last boundary's
    recompute, then each local move's update) and the port's recompute
    against the reference's walk: |log_G| is ~1e4 here and each of its
    ~1e5 float64 terms rounds to 1e-16 of itself, so RTOL holds a
    thousandfold room."""
    hv, pt, part = state["hv"], state["plain"], state["part"]
    want = plain.log_G(pt, part, hv.evo.mu, hv.evo.mpox_rho)
    assert rel(hv.ledger.log_G, want) < RTOL
    assert rel(state["got"]["log_G"], want) < RTOL


def test_a_float32_state_fails_the_tolerances(state):
    """The same statistics and log_G from a float32 copy of the state:
    at least one misses RTOL, so the tolerances tell the precisions
    apart."""
    hv, want = state["hv"], state["want"]
    f32 = port_stats(state["tree"], state["run"].evo, "cpu",
                     dtype=torch.float32)
    lg = plain.log_G(state["plain"], state["part"], hv.evo.mu,
                     hv.evo.mpox_rho)
    misses = [rel(f32["Ttwiddle_beta_a"], want["Ttwiddle_beta_a"]),
              rel(f32["log_G"], lg)]
    assert max(misses) > RTOL, misses


# -- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_the_mpox_cell_agrees_with_the_reference_on_the_card():
    """The committed mpox cell's dataset (``benchmarks/configs/``), a Run
    on the card through its graph dispatch for ten calls of a burst, and
    its final state worked out by the port and by the reference on the
    card: M* equal, Ttwiddle* and log_G within RTOL.  The relative
    differences are printed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmarks import datasets
    from benchmarks import run as br
    spec = br.load_spec(br.ROOT, "mpox200x197k-exp")
    ds = datasets.load(spec["config"], br.ROOT)
    tree = build_initial_tree(ds.ref_seq, ds.deltas, ds.miss, ds.dates,
                              names=ds.names,
                              rng=np.random.default_rng(2 ** 31 + 17))
    seq0 = tree.sequence_at(0)
    run = Run(tree, seed=2 ** 31 + 17, num_cells=spec["config"]["num_cells"],
              device="cuda", **spec["traffic"]["run"])
    run.do_mcmc_steps(10 * br.call_steps(run, spec["traffic"]))
    final, hv = run.tree(), run.host_view()
    dev = torch.device("cuda")
    pt = plain_tree(final, run.evo.nu, missing_sites(ds.miss,
                                                     len(ds.ref_seq)))
    part = plain.apobec_partition(seq0).to(dev)
    assert torch.equal(part, run.evo.part.long())
    want = plain.statistics(pt, part)
    got = port_stats(final, run.evo, dev)
    lg = plain.log_G(pt, part, hv.evo.mu, hv.evo.mpox_rho)
    Tb = got["Ttwiddle_beta_a"]
    M_star = int(got["M_beta_ab"][1, 1, 3] + got["M_beta_ab"][1, 2, 0])
    diffs = {"M": (int(got["num_muts"]), want["M"]),
             "M_star": (M_star, want["M_star"]),
             "Ttwiddle_beta_a": rel(Tb, want["Ttwiddle_beta_a"]),
             "Tt_star": rel(Tb[1, 1] + Tb[1, 2], want["Tt_star"]),
             "log_G_ledger": rel(hv.ledger.log_G, lg),
             "log_G_recomputed": rel(got["log_G"], lg),
             "log_G": lg, "mu": float(hv.evo.mu),
             "rho": float(hv.evo.mpox_rho)}
    print(f"plain mpox reference on {torch.cuda.get_device_name(0)}, "
          f"{len(ds.ref_seq)} sites: {diffs}")
    assert torch.equal(got["M_beta_ab"].cpu(), want["M_beta_ab"].cpu())
    assert M_star == want["M_star"] > 0
    for k in ("Ttwiddle_beta_a", "Tt_star", "log_G_ledger",
              "log_G_recomputed"):
        assert diffs[k] < RTOL, (k, diffs[k])
