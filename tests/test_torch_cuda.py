"""The CUDA kernels on the card against their plain PyTorch versions, and a
short Run through them.  Needs an NVIDIA GPU and nvcc: every test here skips
on a host without one.  This file imports no jax, so it also runs on a host
that has none:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Beside the main path's shapes, the sweep and exp-pop kernels are held to
their plain versions where the main path does not go: rows that are not a
multiple of a warp, padded nodes, slots and cells, a part with no valid
mutation slot, a part near the 227 KB shared-memory bound, many accepted
nodes in one batched move, tied priorities, colour blocks too narrow for
the k_p scatter, the exp-pop chain with one move off, g = 0 and the
min_pop clamp inside the grid, and the HKY chain at the simplex edge, with
a zero column of M, at extreme kappa, on its per-entry path (pi0 with a
zero entry), over 1 and 64 rounds and from 256 random states.
"""

import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAPLE = os.path.join(REPO, "data", "ebola2014_like_81x18959.maple")
F64 = torch.float64

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def ebola_tree(n_tips=None):
    from delphy_tpu_torch.init_tree import build_initial_tree
    from delphy_tpu_torch.io.maple import read_maple
    mf = read_maple(MAPLE)
    tips = mf.tips[:n_tips] if n_tips else mf.tips
    return build_initial_tree(mf.ref_seq, [t.deltas for t in tips],
                              [t.miss_intervals for t in tips],
                              [(t.t_min, t.t_max) for t in tips],
                              names=[t.name for t in tips],
                              rng=np.random.default_rng(42))


def make_run(device, n_tips=None, seed=3, num_cells=256, **kw):
    from delphy_tpu_torch.run import Run
    r = Run(ebola_tree(n_tips), seed=seed, num_cells=num_cells,
            device=device, **kw)
    r.do_mcmc_steps(r.local_moves_per_global_move)
    return r


def sweep_boundary(run):
    """(stat, ctx_arrs, shared) of the sweep of one boundary of ``run``."""
    from delphy_tpu_torch.mcmc.kernel import run_global_moves
    from delphy_tpu_torch.parallel.sweep import prepare_sweep
    ts, evo, pop, grid, caches, _ledger, _stats = run_global_moves(
        run.ts, run.evo, run.pop, run.gen, run.tin, run.tout, run.t_max_tip,
        run.hyp, run.num_cells)
    stat, ctx, shared, _t_p, _ = prepare_sweep(
        ts, evo, pop, grid, caches, run.pm, run.gen, run.t_max_tip,
        run.num_cells)
    return stat, ctx, shared


def pad_chain(stat, ctx, shared, NC=None, MC=None, C=None):
    """The same chain on rows padded to (NC, MC, C) with the JAX package's
    inert padding (block_pallas.pack_chain_inputs): padded nodes have no
    parent or children, padded slots are invalid, cells beyond C_real have
    k_p = b = 0 and A = nbar = 1."""
    from delphy_tpu_torch.parallel.block_cuda import _WIDTH, ChainStatics
    width = {"NC": NC or stat.NC, "MC": MC or stat.MC, "C": C or stat.C}
    fill = {"par": -1, "c0": -1, "c1": -1, "mnode": -1}
    out = dict(ctx)
    for k, w in _WIDTH.items():
        out[k] = torch.nn.functional.pad(
            ctx[k], (0, width[w] - ctx[k].shape[-1]), value=fill.get(k, 0))
    sh = dict(shared)
    for k in ("A", "nbar"):
        sh[k] = torch.nn.functional.pad(shared[k], (0, width["C"] - stat.C),
                                        value=1.0)
    return ChainStatics(NC=width["NC"], MC=width["MC"], C=width["C"],
                        C_real=stat.C_real, cpb=stat.cpb), out, sh


def sweep_cases(device):
    """(name, stat, ctx_arrs, shared, uniforms, n_blocks) away from the main
    path's shapes (see the module docstring)."""
    from delphy_tpu_torch.parallel import block_cuda as bc
    gen = torch.Generator(device=device)
    gen.manual_seed(11)

    def uni(stat, P, nb=24):
        return bc.gen_block_uniforms(gen, P, nb, stat.NC, stat.MC, device)

    cases = []
    stat, ctx, shared = sweep_boundary(make_run(device, n_tips=40))
    P = ctx["t"].shape[0]
    s, c, h = pad_chain(stat, ctx, shared, NC=stat.NC + 13, MC=stat.MC + 5,
                        C=stat.C + 37)
    c["mvalid"] = c["mvalid"].clone()
    c["mvalid"][0] = 0                       # part 0: no valid slot
    cases.append(("ragged", s, c, h, uni(s, P), 24))
    u = uni(stat, P)
    cases.append(("tied priorities", stat, ctx, shared,
                  u._replace(pri=torch.full_like(u.pri, 0.5)), 24))
    s = stat._replace(cpb=4)
    cases.append(("narrow colour blocks", s, ctx, shared, uni(s, P), 24))
    # the whole Ebola tree as one part: many nodes accepted per move
    stat, ctx, shared = sweep_boundary(
        make_run(device, num_cells=400, device_partitions=1))
    s = stat._replace(cpb=8)
    cases.append(("one part, many accepted", s, ctx, shared, uni(s, 1, 32),
                  32))
    for MC in (1600, 2400):     # two uniform stages fit, then only one
        s, c, h = pad_chain(stat, ctx, shared, NC=768, MC=MC)
        cases.append((f"NC=768 MC={MC}", s, c, h, uni(s, 1), 8))
    return cases


def pop_cases(run, boundary):
    """(name, args of exp_pop_chain_kernel) off the main path."""
    from delphy_tpu_torch.parallel import pop_cuda
    ts, evo, pop, grid, caches, ledger, stats = boundary
    dev = ts.t.device
    u = torch.rand((50, 4), generator=run.gen, dtype=F64, device=dev)
    rows = pop_cuda.pack_rows(grid, ts.t, ts.is_tip)

    def f(x, default):
        return default if x is None else torch.tensor(x, dtype=F64,
                                                      device=dev)

    def args(n0=None, g=None, min_pop=None, size=True, growth=True):
        hypf = pop_cuda.hyp_floats(run.hyp)[:6] + (size, growth)
        return (u, *rows, grid.t_step, pop.t0, f(min_pop, pop.min_pop),
                f(n0, pop.n0), f(g, pop.g), hypf, 50)

    return [("size move off", args(size=False)),
            ("growth move off", args(growth=False)),
            ("g = 0", args(g=0.0)),
            ("clamp crosses the grid, g > 0", args(n0=3.0, g=0.01)),
            ("clamp crosses the grid, g < 0", args(n0=3.0, g=-0.01)),
            ("no min_pop floor", args(min_pop=0.0, g=0.003))]


def hky_cases(run, boundary):
    """(name, kernel path, [args of hky_chain_kernel, ...]) off the main
    path: the states where the folded chain's guards matter, the per-entry
    path, 1 and 64 rounds, and 256 random states (numpy seed 7)."""
    ts, evo, pop, grid, caches, ledger, stats = boundary
    dev = ts.t.device

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev)

    def args(n_rounds=10, kappa=None, pi=None, M=None, rf=None):
        u = torch.rand((n_rounds, 6), generator=run.gen, dtype=F64,
                       device=dev)
        return (u, evo.mu, evo.kappa if kappa is None else t(kappa),
                (evo.pi if pi is None else t(pi)).reshape(1, 4),
                stats["Ttwiddle_a"],
                stats["M_ab"].double() if M is None else t(M),
                (caches.root_freq if rf is None else t(rf)).reshape(1, 4),
                (1.0, 1.25), n_rounds)

    M0 = stats["M_ab"].double().cpu().numpy().reshape(4, 4).copy()
    rf0 = caches.root_freq.double().cpu().numpy().reshape(4).copy()
    M0[:, 2] = 0.0
    rf0[[0, 3]] = 0.0
    rng = np.random.default_rng(7)
    rand = []
    for _ in range(256):
        M = np.where(~np.eye(4, dtype=bool), rng.integers(0, 200, (4, 4)),
                     0.0)
        rand.append((t(rng.uniform(size=(10, 6))),
                     t(10 ** rng.uniform(-4, -2)),
                     t(np.exp(rng.normal(1.0, 1.25))),
                     t(rng.dirichlet(np.ones(4))).reshape(1, 4),
                     t(rng.uniform(1e3, 1e5, 4)), t(M),
                     t(rng.integers(0, 40, 4)).reshape(1, 4), (1.0, 1.25),
                     10))
    edge = (0.004, 0.332, 0.332, 0.332)
    return [("pi at the simplex edge", "folded", [args(pi=edge)]),
            ("pi at the simplex edge, 64 rounds", "folded",
             [args(64, pi=edge)]),
            ("zero column of M, zero root frequencies", "folded",
             [args(M=M0, rf=rf0)]),
            ("kappa 0.05", "folded", [args(kappa=0.05)]),
            ("kappa 200", "folded", [args(kappa=200.0)]),
            ("pi0 with a zero entry", "per-entry",
             [args(pi=(0.0, 0.4, 0.3, 0.3))]),
            ("n_rounds 1", "folded", [args(1)]),
            ("n_rounds 64", "folded", [args(64)]),
            ("256 random states", "folded", rand)]


@pytest.fixture(scope="module")
def run(device):
    return make_run(device, n_tips=40)


@pytest.fixture(scope="module")
def boundary(run):
    from delphy_tpu_torch.mcmc.kernel import run_global_moves
    return run_global_moves(run.ts, run.evo, run.pop, run.gen, run.tin,
                            run.tout, run.t_max_tip, run.hyp, run.num_cells)


def _close(got, want, rtol, atol, msg=None):
    for g, w in zip(got, want):
        torch.testing.assert_close(g.reshape(-1), w.reshape(-1), rtol=rtol,
                                   atol=atol, msg=msg)


def test_hky_kernel_matches_plain(run, boundary, device):
    from delphy_tpu_torch.parallel import hky_cuda
    ts, evo, pop, grid, caches, ledger, stats = boundary
    u = torch.rand((10, 6), generator=run.gen, dtype=torch.float64,
                   device=device)
    args = (u, evo.mu, evo.kappa, evo.pi.reshape(1, 4), stats["Ttwiddle_a"],
            stats["M_ab"].double(), caches.root_freq.reshape(1, 4),
            (1.0, 1.25), 10)
    _close(hky_cuda.hky_chain_kernel(*args), hky_cuda.hky_chain_torch(*args),
           rtol=1e-12, atol=1e-15)


@pytest.fixture(scope="module")
def off_path_hky(run, boundary):
    return hky_cases(run, boundary)


@pytest.mark.parametrize("case", range(9))
def test_hky_kernel_off_main_path(off_path_hky, case):
    from delphy_tpu_torch.parallel import hky_cuda
    name, path, chains = off_path_hky[case]
    for args in chains:
        assert hky_cuda.kernel_path(args[2], args[3]) == path, name
        _close(hky_cuda.hky_chain_kernel(*args),
               hky_cuda.hky_chain_torch(*args), rtol=1e-12, atol=1e-15,
               msg=name)


def test_exp_pop_kernel_matches_plain(run, boundary, device):
    from delphy_tpu_torch.parallel import pop_cuda
    ts, evo, pop, grid, caches, ledger, stats = boundary
    u = torch.rand((50, 4), generator=run.gen, dtype=torch.float64,
                   device=device)
    args = (u, *pop_cuda.pack_rows(grid, ts.t, ts.is_tip), grid.t_step,
            pop.t0, pop.min_pop, pop.n0, pop.g,
            pop_cuda.hyp_floats(run.hyp), 50)
    _close(pop_cuda.exp_pop_chain_kernel(*args),
           pop_cuda.exp_pop_chain_torch(*args), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("case", range(6))
def test_exp_pop_kernel_off_main_path(run, boundary, case):
    from delphy_tpu_torch.parallel import pop_cuda
    name, args = pop_cases(run, boundary)[case]
    _close(pop_cuda.exp_pop_chain_kernel(*args),
           pop_cuda.exp_pop_chain_torch(*args), rtol=1e-12, atol=1e-15,
           msg=name)


def test_sweep_kernel_matches_plain(run, boundary, device):
    from delphy_tpu_torch.parallel import block_cuda as bc
    from delphy_tpu_torch.parallel.sweep import prepare_sweep
    ts, evo, pop, grid, caches, ledger, stats = boundary
    stat, ctx_arrs, shared, t_p, _ = prepare_sweep(
        ts, evo, pop, grid, caches, run.pm, run.gen, run.t_max_tip,
        run.num_cells)
    u = bc.gen_block_uniforms(run.gen, t_p.shape[0], 32, stat.NC, stat.MC,
                              device)
    got = bc.sweep_chain_kernel(stat, 32, ctx_arrs, shared, u)
    want = bc.sweep_chain_torch(stat, 32, ctx_arrs, shared, u)
    _close(got[:3], want[:3], rtol=0.0, atol=1e-9)
    _close(got[3:5], want[3:5], rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(got[5], want[5], rtol=0.0, atol=0.0)
    assert float(got[5].sum()) > 0


@pytest.fixture(scope="module")
def off_path_sweeps(device):
    return sweep_cases(device)


@pytest.mark.parametrize("case", range(6))
def test_sweep_kernel_off_main_path(off_path_sweeps, case):
    from delphy_tpu_torch.parallel import block_cuda as bc
    name, stat, ctx, shared, u, nb = off_path_sweeps[case]
    got = bc.sweep_chain_kernel(stat, nb, ctx, shared, u)
    want = bc.sweep_chain_torch(stat, nb, ctx, shared, u)
    _close(got[:3], want[:3], rtol=0.0, atol=1e-9, msg=name)
    _close(got[3:5], want[3:5], rtol=1e-10, atol=1e-12, msg=name)
    torch.testing.assert_close(got[5], want[5], rtol=0.0, atol=0.0, msg=name)
    moved = (got[0] - ctx["t"].reshape(got[0].shape)).abs().max()
    assert float(moved) > 0.0, name


def test_wrappers_reject_bad_inputs(run, device):
    from delphy_tpu_torch.parallel import hky_cuda
    u = torch.rand((10, 6), dtype=torch.float32, device=device)
    z = torch.zeros((), dtype=torch.float64, device=device)
    with pytest.raises(ValueError):
        hky_cuda.hky_chain_kernel(u, z, z + 1.0, torch.full(
            (1, 4), 0.25, dtype=torch.float64, device=device), z.repeat(4),
            z.repeat(16), z.repeat(4), (1.0, 1.25), 10)


def test_run_on_card_keeps_ledger(run):
    from delphy_tpu_torch.parallel import _cuda
    _cuda.reset_launch_counts()
    run.do_mcmc_steps(3 * run.local_moves_per_global_move)
    run.check_derived_quantities(1e-6)
    run.tree().check_integrity()
    assert all(v > 0 for v in _cuda.launch_counts.values())


def test_snapshot_resumes_exactly_on_card(device, tmp_path):
    """A run saved and loaded on the card and the run that never stopped
    reach the same state after the same further steps, a burst included
    (compared with ``==``)."""
    from delphy_tpu_torch.io.snapshot import load_run, save_run
    r = make_run(device, n_tips=40)
    lm = r.local_moves_per_global_move
    r.do_mcmc_steps(3 * lm)
    path = tmp_path / "card.npz"
    save_run(r, path)
    r2 = load_run(path)                       # the default device is CUDA
    assert r2.device.type == "cuda" and r2.step == r.step
    assert torch.equal(r2.gen.get_state(), r.gen.get_state())
    bursts = r.burst_count
    n = lm * r.topology_burst_chunks + 3 * lm
    r.do_mcmc_steps(n)
    r2.do_mcmc_steps(n)
    assert r.burst_count > bursts
    assert r.log_posterior == r2.log_posterior
    assert torch.equal(r.ts.t, r2.ts.t) and torch.equal(r.ts.mut_t,
                                                        r2.ts.mut_t)
    r2.check_derived_quantities(1e-6)


def test_snapshot_does_not_cross_device_types(device, tmp_path):
    from delphy_tpu_torch.io.snapshot import load_run, save_run
    from delphy_tpu_torch.run import Run
    r = Run(ebola_tree(20), seed=3, num_cells=128, device="cpu")
    path = tmp_path / "cpu.npz"
    save_run(r, path)
    with pytest.raises(ValueError, match="written on a cpu device cannot "
                                         "resume on cuda"):
        load_run(path)
    r_card = make_run(device, n_tips=20, num_cells=128)
    save_run(r_card, tmp_path / "card.npz")
    with pytest.raises(ValueError, match="written on a cuda device cannot "
                                         "resume on cpu"):
        load_run(tmp_path / "card.npz", device="cpu")


def test_io_reads_a_card_run_through_the_host_view(run, tmp_path):
    """Every writer of the I/O layer on a run whose tensors are on the card
    (a missing host copy raises there, and only there)."""
    import io

    from delphy_tpu_torch import probers
    from delphy_tpu_torch.io import beast_out, beast_xml, dphy
    hv = run.host_view()
    assert isinstance(hv.evo.pi, np.ndarray) and hv.ledger is not None
    assert float(hv.ledger.log_G) == float(run.ledger.log_G)
    fh = io.StringIO()
    out = beast_out.BeastLogOutput(fh)
    out.write_headers(run.tree())
    out.write_line(run)
    assert all(np.isfinite(float(v))
               for v in fh.getvalue().splitlines()[1].split("\t"))
    for fn in (beast_xml.export_beast2_xml, beast_xml.export_beast2_7_xml,
               beast_xml.export_beast_x_xml):
        fh = io.StringIO()
        fn(fh, run.tree(), run)
        assert fh.getvalue().rstrip().endswith("</beast>")
    tree = run.tree()
    p = probers.probe_site_states_on_tree(
        tree, hv.pop, 0, float(tree.t[tree.root]) - 5.0, run.t_max_tip, 12)
    assert p.shape == (4, 12) and np.all(np.isfinite(p))
    assert "log_post" in run.stats_line()
    try:
        import flatbuffers  # noqa: F401
    except ImportError:     # the .dphy writer's only missing leg
        return
    params = dphy.parse_params_fb(dphy.build_params_fb(run))
    assert params["mu"] == float(hv.evo.mu)


def test_two_server_runs_step_at_once_on_card(device, tmp_path):
    """Two runs stepped by two worker threads at once: each thread's kernels
    land on the run's device and stream (the runs stay ledger-green and the
    resumed twin stays bit-equal), and both threads' launches are counted."""
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.server import Client, serve_in_thread
    srv, engine, _th = serve_in_thread()      # the default device is CUDA
    assert engine.device.type == "cuda"
    c = Client(*srv.server_address)
    try:
        job = c.call("create_run", maple=MAPLE, seed=1, num_cells=400)
        rid = c.wait_job(job["job_id"])["run_id"]
        lm = engine._runs[rid].run.local_moves_per_global_move
        c.wait_job(c.call("run_steps", run_id=rid, n=3 * lm)["job_id"])
        snap = str(tmp_path / "s.npz")
        c.call("save_snapshot", run_id=rid, path=snap)
        rid2 = c.call("load_snapshot", path=snap)["run_id"]
        _cuda.reset_launch_counts()
        j1 = c.call("run_steps", run_id=rid, n=20 * lm)
        j2 = c.call("run_steps", run_id=rid2, n=20 * lm)
        r1, r2 = c.wait_job(j1["job_id"]), c.wait_job(j2["job_id"])
        assert r1["log_posterior"] == r2["log_posterior"]
        # 20 boundaries each, one launch of every kernel per boundary
        assert all(v == 40 for v in _cuda.launch_counts.values()), \
            _cuda.launch_counts
        for r in (rid, rid2):
            run = engine._runs[r].run
            assert run.ts.t.device.type == "cuda"
            run.check_derived_quantities(1e-6)
            run.tree().check_integrity()
    finally:
        c.close()
        srv.shutdown()
        srv.server_close()
