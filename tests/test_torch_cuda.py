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
zero entry), over 1 and 64 rounds and from 256 random states.  The sweep
kernel's skygrid build is held to the plain chain on a real boundary of
each skygrid type, and short skygrid, alpha/nu and mpox Runs keep their
ledger and launch the kernels their paths must launch.  At large-tree
shapes: the build the sweep kernel picks on either side of the 227 KB
shared-memory line, its global build against the plain chain at NC = 1152,
MC = 3200 for the three population models, a one-part Run on 1,000
simulated tips (global build only, ledger green), and an overlapped cycle
bit-equal to the same cycle forced sequential.  The unpartitioned step
(``mcmc/kernel.py`` super_step) repeats itself bit for bit and enqueues a
sweep without a host synchronisation.  A Run bursts on the Python mixer
with the native kernel forced off, and the device SPR's sweeps on the card
equal their CPU replay with one host synchronisation a sweep.  The port's
float64 chain at configuration S of data/jax_posterior_reference.json
samples the JAX package's posterior on the card.
"""

import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAPLE = os.path.join(REPO, "data", "ebola2014_like_81x18959.maple")
F64 = torch.float64

pytestmark = pytest.mark.cuda
# the kernels an exponential-model run launches every boundary
EXP_KERNELS = ("hky_chain", "exp_pop_chain", "sweep_chain")


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
    from delphy_tpu_torch.parallel.block_cuda import pad_chain as pad
    return pad(stat, ctx, shared, NC=NC, MC=MC, C=C)


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
    assert all(_cuda.launch_counts[k] > 0 for k in EXP_KERNELS)
    assert _cuda.launch_counts["sweep_chain_skygrid"] == 0


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
        assert all(_cuda.launch_counts[k] == 40 for k in EXP_KERNELS), \
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


@pytest.fixture(scope="module", params=["staircase", "log-linear"])
def skygrid_run(device, request):
    from delphy_tpu_torch import pop as popm
    typ = popm.STAIRCASE if request.param == "staircase" else popm.LOG_LINEAR
    return make_run(device, n_tips=40, pop_model="skygrid", skygrid_type=typ)


def test_sweep_kernel_skygrid_matches_plain(skygrid_run, device):
    """The skygrid build of the sweep kernel against the plain chain's
    skygrid log N(t), on a real boundary of each skygrid type."""
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.parallel import block_cuda as bc
    run = skygrid_run
    stat, ctx, shared = sweep_boundary(run)
    assert stat.pop == run.pop.type
    u = bc.gen_block_uniforms(run.gen, ctx["t"].shape[0], 32, stat.NC,
                              stat.MC, device)
    _cuda.reset_launch_counts()
    got = bc.sweep_chain_kernel(stat, 32, ctx, shared, u)
    assert _cuda.launch_counts["sweep_chain_skygrid"] == 1
    assert _cuda.launch_counts["sweep_chain"] == 0
    want = bc.sweep_chain_torch(stat, 32, ctx, shared, u)
    _close(got[:3], want[:3], rtol=0.0, atol=1e-9)
    _close(got[3:5], want[3:5], rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(got[5], want[5], rtol=0.0, atol=0.0)
    assert float(got[5].sum()) > 0


def test_skygrid_run_on_card_keeps_ledger(skygrid_run):
    from delphy_tpu_torch.parallel import _cuda
    run = skygrid_run
    _cuda.reset_launch_counts()
    run.do_mcmc_steps(3 * run.local_moves_per_global_move)
    run.check_derived_quantities(1e-6)
    run.tree().check_integrity()
    counts = _cuda.launch_counts
    assert counts["sweep_chain_skygrid"] >= 3 and counts["hky_chain"] >= 3
    assert counts["sweep_chain"] == counts["exp_pop_chain"] == 0


@pytest.mark.parametrize("option", ["alpha", "mpox"])
def test_model_option_runs_on_card(device, option):
    from delphy_tpu_torch.mcmc.global_moves import PriorConfig
    from delphy_tpu_torch.parallel import _cuda
    kw = ({"hyp": PriorConfig(alpha_move_enabled=True)} if option == "alpha"
          else {"mpox_hack": True})
    run = make_run(device, n_tips=40, **kw)
    _cuda.reset_launch_counts()
    run.do_mcmc_steps(3 * run.local_moves_per_global_move)
    run.check_derived_quantities(1e-6)
    run.tree().check_integrity()
    counts = _cuda.launch_counts
    assert counts["sweep_chain"] >= 3 and counts["exp_pop_chain"] >= 3
    assert counts["hky_chain"] == (0 if option == "mpox" else
                                   counts["sweep_chain"])
    assert counts["sweep_chain_skygrid"] == 0


# ---------------------------------------------------------------------------
# Large trees: the sweep kernel's global build, a P = 1 Run beyond the
# shared-memory bound, and the overlapped driver on the card
# ---------------------------------------------------------------------------

def sim_tree(n_tips, seed=77, num_sites=29903):
    """A simulated tree with the reference's scale-bench settings
    (scripts/make_tree100k.py) at ``n_tips`` tips."""
    from delphy_tpu_torch.init_tree import build_initial_tree
    from delphy_tpu_torch.sim import simulate_dataset
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        n_tips, num_sites, mu=1e-3 / 365, sample_window_days=1200.0,
        missing_fraction=0.02, seed=seed)
    return build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(seed))


@pytest.fixture(scope="module")
def global_cases(device):
    """(name, stat, ctx, shared) at NC = 1152, MC = 3200, C = 400: a real
    boundary of each population model (8 parts of a 1,000-tip tree) padded
    to those widths."""
    from delphy_tpu_torch import pop as popm
    from delphy_tpu_torch.run import Run
    tree = sim_tree(1000)
    cases = []
    for name, kw in (("exp", {}),
                     ("staircase", dict(pop_model="skygrid")),
                     ("log-linear", dict(pop_model="skygrid",
                                         skygrid_type=popm.LOG_LINEAR))):
        run = Run(tree, seed=5, num_cells=400, device_partitions=8,
                  device=device, **kw)
        run.do_mcmc_steps(run.local_moves_per_global_move)
        stat, ctx, shared = sweep_boundary(run)
        cases.append((name, *pad_chain(stat, ctx, shared, NC=1152, MC=3200)))
    return cases


def test_sweep_build_selection_by_shape(device):
    """Two uniform stages in shared memory where they fit, one where only
    that fits, the global build beyond 227 KB, for both models."""
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.parallel import block_cuda as bc
    lib = _cuda.lib()
    for pop, K in ((bc.POP_EXP, 0), (1, 50)):
        builds = []
        for NC, MC in ((768, 1600), (768, 2400), (1152, 3200), (2816, 2000)):
            stat = bc.ChainStatics(NC=NC, MC=MC, C=400, C_real=400, cpb=16,
                                   pop=pop)
            builds.append(bc.build(stat, K))
            smem = lib.delphy_sweep_chain_skygrid_smem_bytes(NC, MC, 400,
                                                             16, K)
            assert smem <= 227 * 1024
            assert bc.entry(stat, K).endswith("_global") == (builds[-1] == 0)
        assert builds == [2, 1, 0, 0], builds
    # either side of the line: MC where one stage stops fitting at NC=768
    stat = bc.ChainStatics(NC=768, MC=2400, C=400, C_real=400, cpb=16)
    mc = 2400
    while bc.build(stat._replace(MC=mc)) == 1:
        mc += 16
    assert bc.build(stat._replace(MC=mc - 16)) == 1
    assert bc.build(stat._replace(MC=mc)) == 0


@pytest.mark.parametrize("case", range(3))
def test_sweep_global_build_matches_plain(global_cases, device, case):
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.parallel import block_cuda as bc
    name, stat, ctx, shared = global_cases[case]
    K = shared["x"].numel() if "x" in shared else 0
    assert bc.build(stat, K) == 0, name
    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    P = ctx["t"].shape[0]
    u = bc.gen_block_uniforms(gen, P, 24, stat.NC, stat.MC, device)
    _cuda.reset_launch_counts()
    got = bc.sweep_chain_kernel(stat, 24, ctx, shared, u)
    entry = bc.entry(stat, K)[len("delphy_"):]
    assert _cuda.launch_counts[entry] == 1, (name, _cuda.launch_counts)
    assert sum(_cuda.launch_counts.values()) == 1
    want = bc.sweep_chain_torch(stat, 24, ctx, shared, u)
    _close(got[:3], want[:3], rtol=0.0, atol=1e-12, msg=name)
    _close(got[3:5], want[3:5], rtol=1e-10, atol=1e-12, msg=name)
    torch.testing.assert_close(got[5], want[5], rtol=0.0, atol=0.0, msg=name)
    assert float(got[5].sum()) > 0


def test_one_part_run_beyond_shared_memory_keeps_ledger(device):
    """A Run with one device part on 1,000 simulated tips: its part needs
    the global build, which every boundary launches (and no shared build);
    the ledger stays green at 1e-6."""
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.parallel import block_cuda as bc
    from delphy_tpu_torch.run import Run
    run = Run(sim_tree(1000), seed=2, num_cells=400, device_partitions=1,
              device=device)
    stat, ctx, shared = sweep_boundary(run)
    assert bc.build(stat) == 0
    _cuda.reset_launch_counts()
    run.do_mcmc_steps(2 * run.local_moves_per_global_move)
    run.check_derived_quantities(1e-6)
    run.tree().check_integrity()
    counts = _cuda.launch_counts
    assert counts["sweep_chain_global"] >= 2 and counts["sweep_chain"] == 0
    assert run.burst_count >= 1 and run.topology_proposed > 0


def test_overlapped_cycle_on_card_equals_sequential(device, monkeypatch,
                                                    tmp_path):
    """An overlapped cycle on the card equals the same cycle with a
    torch.cuda.synchronize() after each dispatch, before the burst, bit for
    bit; the L-dispatch sweeps the selected half of the parts; a snapshot
    after an overlapped cycle resumes bit-equal."""
    from delphy_tpu_torch import run as run_mod
    from delphy_tpu_torch.io.snapshot import load_run, save_run
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.phylo import build_random_tree
    from delphy_tpu_torch.sim import simulate_dataset
    monkeypatch.setenv("DELPHY_TPU_OVERLAP", "1")
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        48, 400, mu=2e-3, missing_fraction=0.02, seed=13)
    tree = build_random_tree(ref, deltas, miss, dates, names=names,
                             rng=np.random.default_rng(13))
    run = run_mod.Run(tree, seed=15, num_cells=64, device_partitions=8,
                      local_moves_per_global_move=200, device=device)
    run.topology_burst_chunks = 2
    assert run._overlap_active()
    run.do_mcmc_steps(800)
    save_run(run, tmp_path / "ov.npz")
    twins = [load_run(tmp_path / "ov.npz") for _ in range(2)]
    _cuda.reset_launch_counts()
    run.do_mcmc_steps(400)                       # one cycle of 2 boundaries
    cyc = run.last_cycle
    assert _cuda.launch_counts["sweep_chain"] == cyc["boundaries"] == 2
    assert _cuda.launch_blocks["sweep_chain"] == 2 * cyc["selection_width"]
    assert _cuda.launch_counts["hky_chain"] == 1     # G alone
    twins[0].do_mcmc_steps(400)
    orig = run_mod.parts_multi_super_step

    def sequential(*a, **kw):
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        return out
    monkeypatch.setattr(run_mod, "parts_multi_super_step", sequential)
    twins[1].do_mcmc_steps(400)
    for r in twins:
        assert r.log_posterior == run.log_posterior
        assert torch.equal(r.ts.t, run.ts.t)
        assert torch.equal(r.ts.mut_t, run.ts.mut_t)
        assert torch.equal(r.gen.get_state(), run.gen.get_state())
    run.check_derived_quantities(1e-6)
    run.tree().check_integrity()


def test_exp_pop_kernel_node_rows_in_place(run, boundary, device):
    """Beyond ~18k nodes the exp-pop kernel reads the node rows in place
    (their shared copy no longer fits): the real boundary's node rows
    tiled 400 times, against the plain version."""
    from delphy_tpu_torch.parallel import _cuda, pop_cuda
    ts, evo, pop, grid, caches, ledger, stats = boundary
    lbs, k2, t_row, inner = pop_cuda.pack_rows(grid, ts.t, ts.is_tip)
    t_big, inner_big = t_row.repeat(1, 400), inner.repeat(1, 400)
    assert _cuda.lib().delphy_exp_pop_chain_nodes_shared(
        lbs.numel(), 50, t_big.numel()) == 0
    u = torch.rand((50, 4), generator=run.gen, dtype=F64, device=device)
    args = (u, lbs, k2, t_big, inner_big, grid.t_step, pop.t0, pop.min_pop,
            pop.n0, pop.g, pop_cuda.hyp_floats(run.hyp), 50)
    _close(pop_cuda.exp_pop_chain_kernel(*args),
           pop_cuda.exp_pop_chain_torch(*args), rtol=1e-12, atol=1e-15)


def test_dispatch_repeats_itself_bit_for_bit(device):
    """A 2-boundary dispatch on 1,000 tips x 29,903 sites from the same
    state and generator state gives the same bits every time: the device
    sums (scatter-adds, 1-D scans over sites and nodes) run in a fixed
    order."""
    from delphy_tpu_torch.parallel.sweep import parts_multi_super_step
    from delphy_tpu_torch.run import Run
    run = Run(sim_tree(1000), seed=4, num_cells=400, device=device)
    run.do_mcmc_steps(run.local_moves_per_global_move)
    state = run.gen.get_state()
    outs = []
    for _ in range(6):
        run.gen.set_state(state)
        ts, evo, pop, led, _stats, _fused = parts_multi_super_step(
            run.ts, run.evo, run.pop, run.gen, run.tin, run.tout, run.pm, 24,
            run.t_max_tip, run.hyp, run.num_cells, 2)
        outs.append((ts.t.clone(), ts.mut_t.clone(), evo.kappa.clone(),
                     pop.n0.clone(), led.log_G.clone()))
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))


def _mesh_run_on_card(mesh, device, out: str) -> dict:
    """48 tips, P=8, topology moves: three dispatch calls, each ending in a
    burst, under ``mesh`` (None: this process); the ledger at 1e-6, and t,
    mut_t and the generator state saved to ``out``."""
    import numpy as np
    import torch

    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.phylo import build_random_tree
    from delphy_tpu_torch.run import Run
    from delphy_tpu_torch.sim import simulate_dataset

    ref, deltas, miss, dates, names, _ = simulate_dataset(
        48, 400, mu=2e-3, missing_fraction=0.02, seed=13)
    tree = build_random_tree(ref, deltas, miss, dates, names=names,
                             rng=np.random.default_rng(13))
    run = Run(tree, seed=15, num_cells=64, device_partitions=8,
              local_moves_per_global_move=200, device=device, mesh=mesh)
    run.topology_burst_chunks = 2
    _cuda.reset_launch_counts()
    for _ in range(3):
        run.do_mcmc_steps(400)
    run.check_derived_quantities(1e-6)
    run.tree().check_integrity()
    torch.save({"t": run.ts.t.cpu(), "mut_t": run.ts.mut_t.cpu(),
                "gen": run.gen.get_state().cpu()}, out)
    return {"log_G": float(run.ledger.log_G),
            "topology_proposed": run.topology_proposed,
            "bursts": run.burst_count, "moves": run.local_moves_attempted,
            "parts_per_sweep": _cuda.launch_blocks["sweep_chain"]
            / _cuda.launch_counts["sweep_chain"]}


_MESH_RANK = """
import json, os
from delphy_tpu_torch.parallel import distributed
assert distributed.initialize_from_env()
mesh = distributed.global_part_mesh(device="cuda:0")
res = _mesh_run_on_card(mesh, mesh.device,
                        os.path.join(os.environ["OUT"], f"r{mesh.rank}.pt"))
print("RESULT " + json.dumps(res), flush=True)
distributed.shutdown()
"""


def test_two_ranks_on_one_card_match_one_process(device, tmp_path):
    """Two ranks sharing the card (gloo, the reassembly staged through the
    host) each sweep 4 of the 8 parts, and each ends bit-equal to the same
    run in one process."""
    import inspect
    import json
    import socket
    import subprocess
    import sys
    import textwrap

    want = _mesh_run_on_card(None, device, str(tmp_path / "one.pt"))
    assert want["parts_per_sweep"] == 8 and want["bursts"] >= 1
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    src = textwrap.dedent(inspect.getsource(_mesh_run_on_card)) + _MESH_RANK
    procs = [subprocess.Popen(
        [sys.executable, "-c", src], cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=dict(os.environ, PYTHONPATH=REPO, OUT=str(tmp_path),
                 DELPHY_TPU_COORDINATOR=f"127.0.0.1:{port}",
                 DELPHY_TPU_NUM_PROCESSES="2", DELPHY_TPU_PROCESS_ID=str(r)))
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    one = torch.load(tmp_path / "one.pt")
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, se[-4000:]
        got = json.loads([ln for ln in so.splitlines()
                          if ln.startswith("RESULT ")][0][len("RESULT "):])
        assert got == dict(want, parts_per_sweep=4.0), (r, got, want)
        saved = torch.load(tmp_path / f"r{r}.pt")
        assert all(torch.equal(saved[k], one[k]) for k in one), r


def test_dispatch_feedback_does_not_depend_on_timing(device, monkeypatch):
    """The moves-per-block feedback sizes the next dispatch by a rule, not
    by whether the card has finished the last one: a run whose card is
    still busy after each dispatch (a ~50 ms sleep kernel queued behind
    it) ends in the same state as one whose every dispatch is waited for
    (three dispatches of 200 boundaries in one call)."""
    from delphy_tpu_torch import run as run_mod
    from delphy_tpu_torch.phylo import build_random_tree
    from delphy_tpu_torch.sim import simulate_dataset
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        48, 400, mu=2e-3, seed=17)
    runs = [run_mod.Run(build_random_tree(ref, deltas, miss, dates,
                                          names=names,
                                          rng=np.random.default_rng(17)),
                        seed=19, num_cells=64, device_partitions=8,
                        local_moves_per_global_move=200,
                        topology_moves_enabled=False, device=device)
            for _ in range(2)]
    orig = run_mod.parts_multi_super_step

    def busy(*a, **kw):
        out = orig(*a, **kw)
        torch.cuda._sleep(100_000_000)
        return out

    def waited(*a, **kw):
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        return out
    for run, wrap in zip(runs, (busy, waited)):
        monkeypatch.setattr(run_mod, "parts_multi_super_step", wrap)
        run.do_mcmc_steps(450 * 200)
    assert runs[0].dispatch_count == runs[1].dispatch_count == 3
    assert runs[0]._per_block_rate == runs[1]._per_block_rate
    assert torch.equal(runs[0].ts.t, runs[1].ts.t)
    assert runs[0].log_posterior == runs[1].log_posterior


def test_unpartitioned_step_on_card(device):
    """The unpartitioned step on 30 Ebola tips: multi_super_step over 3
    boundaries bit-equal to 3 super_step calls from the same generator
    state, hky_chain and exp_pop_chain launched once a boundary and no
    sweep kernel, the incremental log_G equal to the recompute, and no host
    synchronisation while a sweep is enqueued."""
    import warnings

    from delphy_tpu_torch.mcmc import kernel as mk
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.run import Run
    run = Run(ebola_tree(30), seed=3, num_cells=128, device=device,
              topology_moves_enabled=False)
    args = (run.tin, run.tout, 1000, run.t_max_tip, run.hyp, run.num_cells)
    state = run.gen.get_state()
    _cuda.reset_launch_counts()
    ts, evo, pop, led, stats = mk.multi_super_step(
        run.ts, run.evo, run.pop, run.gen, *args, 3)
    counts = dict(_cuda.launch_counts)
    assert counts == {k: (3 if k in ("hky_chain", "exp_pop_chain") else 0)
                      for k in counts}
    run.gen.set_state(state)
    one = (run.ts, run.evo, run.pop)
    for _ in range(3):
        *one, led1, _ = mk.super_step(*one, run.gen, *args)
    for a, b in zip((ts, evo, pop, led), one + [led1]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    run.ts, run.evo, run.pop, run.ledger = ts, evo, pop, led
    run._fused_bundle = None
    run.check_derived_quantities(1e-9)
    ts_b, evo_b, pop_b, grid, caches, led_b, _ = mk.run_global_moves(
        ts, evo, pop, run.gen, run.tin, run.tout, run.t_max_tip, run.hyp,
        run.num_cells)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            mk.run_local_sweep(ts_b, caches, grid, led_b, evo_b, pop_b,
                               run.gen, 1000, run.t_max_tip)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert not [w for w in caught if "called a synchronizing CUDA operation"
                in str(w.message)]


# ---------------------------------------------------------------------------
# The float32 builds (the f32 engine: DELPHY_TPU_F32=1, Run(dtype=...))
# ---------------------------------------------------------------------------

F32 = torch.float32
# the JAX package's own f32 tolerances (tests/test_block_pallas.py,
# test_pop_pallas.py, test_hky_pallas.py); t and mut_t with a relative
# term of 4 float32 ulps (Ebola times lie near -2,000 days)
F32_CHAIN = dict(rtol=1e-4, atol=1e-7)
F32_SWEEP = {"t": (5e-7, 5e-5), "mut_t": (5e-7, 5e-5), "k_p": (0.0, 1e-3),
             "dG": (1e-3, 1e-3), "dC": (1e-3, 1e-3), "cnt": (0.0, 0.0)}


def _close_sweep32(got, want, msg=None):
    for (n, (rtol, atol)), g, w in zip(F32_SWEEP.items(), got, want):
        assert g.dtype == w.dtype == F32, n
        torch.testing.assert_close(g.reshape(-1), w.reshape(-1), rtol=rtol,
                                   atol=atol, msg=f"{msg} {n}")


@pytest.fixture(scope="module")
def run32(device):
    return make_run(device, n_tips=40, dtype=F32)


@pytest.fixture(scope="module")
def boundary32(run32):
    from delphy_tpu_torch.mcmc.kernel import run_global_moves
    return run_global_moves(run32.ts, run32.evo, run32.pop, run32.gen,
                            run32.tin, run32.tout, run32.t_max_tip,
                            run32.hyp, run32.num_cells)


def test_f32_kernels_match_plain(run32, boundary32, device):
    """Each kernel's float32 build against its float32 plain version on a
    float32 boundary; only the *_f32 entries launch."""
    from delphy_tpu_torch.parallel import _cuda, hky_cuda, pop_cuda
    from delphy_tpu_torch.parallel import block_cuda as bc
    from delphy_tpu_torch.parallel.sweep import prepare_sweep
    ts, evo, pop, grid, caches, ledger, stats = boundary32
    assert ts.t.dtype == evo.mu.dtype == pop.n0.dtype == F32
    _cuda.reset_launch_counts()
    u = torch.rand((10, 6), generator=run32.gen, dtype=F32, device=device)
    args = (u, evo.mu, evo.kappa, evo.pi.reshape(1, 4), stats["Ttwiddle_a"],
            stats["M_ab"].to(F32), caches.root_freq.reshape(1, 4),
            (1.0, 1.25), 10)
    _close(hky_cuda.hky_chain_kernel(*args), hky_cuda.hky_chain_torch(*args),
           **F32_CHAIN)
    u = torch.rand((50, 4), generator=run32.gen, dtype=F32, device=device)
    args = (u, *pop_cuda.pack_rows(grid, ts.t, ts.is_tip), grid.t_step,
            pop.t0, pop.min_pop, pop.n0, pop.g,
            pop_cuda.hyp_floats(run32.hyp), 50)
    _close(pop_cuda.exp_pop_chain_kernel(*args),
           pop_cuda.exp_pop_chain_torch(*args), **F32_CHAIN)
    stat, ctx, shared, t_p, _ = prepare_sweep(
        ts, evo, pop, grid, caches, run32.pm, run32.gen, run32.t_max_tip,
        run32.num_cells)
    u = bc.gen_block_uniforms(run32.gen, t_p.shape[0], 32, stat.NC, stat.MC,
                              device, F32)
    got = bc.sweep_chain_kernel(stat, 32, ctx, shared, u)
    _close_sweep32(got, bc.sweep_chain_torch(stat, 32, ctx, shared, u))
    assert float(got[5].sum()) > 0
    launched = {k for k, v in _cuda.launch_counts.items() if v}
    assert launched == {"hky_chain_f32", "exp_pop_chain_f32",
                        "sweep_chain_f32"}, launched


def test_f32_build_selection_by_shape(device):
    """Shared memory counted in float32's bytes: the sweep kernel keeps a
    part in shared memory up to about twice the rows (NC=1152, MC=3200 is
    the global build in float64, two shared stages in float32), and the
    exp-pop kernel its node rows up to ~27.7k nodes (~18k in float64)."""
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.parallel import block_cuda as bc
    f64 = torch.float64
    for pop, K in ((bc.POP_EXP, 0), (1, 50)):
        for NC, MC, b64, b32 in ((768, 1600, 2, 2), (768, 2400, 1, 2),
                                 (1152, 3200, 0, 2), (2304, 6400, 0, 0)):
            stat = bc.ChainStatics(NC=NC, MC=MC, C=400, C_real=400, cpb=16,
                                   pop=pop)
            assert (bc.build(stat, K, f64), bc.build(stat, K, F32)) \
                == (b64, b32), (NC, MC, pop)
            assert bc.entry(stat, K, F32).endswith("_f32")
            assert bc.entry(stat, K, F32).endswith("_global_f32") == (b32 == 0)
            assert bc.smem_bytes(stat, K, F32) <= 227 * 1024
    lib = _cuda.lib()
    for N, s64, s32 in ((19_999, 0, 1), (27_000, 0, 1), (40_000, 0, 0)):
        assert (lib.delphy_exp_pop_chain_nodes_shared(400, 50, N),
                lib.delphy_exp_pop_chain_nodes_shared_f32(400, 50, N)) \
            == (s64, s32), N


def test_f32_global_build_and_node_rows_in_place_match_plain(run32,
                                                            boundary32,
                                                            device):
    """The float32 global build (rows padded to NC=2304, MC=6400) and the
    float32 exp-pop kernel with its node rows read in place (padded to
    40,000 inert nodes) against their plain versions."""
    from delphy_tpu_torch.parallel import block_cuda as bc
    from delphy_tpu_torch.parallel import pop_cuda
    from delphy_tpu_torch.parallel.sweep import prepare_sweep
    ts, evo, pop, grid, caches, ledger, stats = boundary32
    stat, ctx, shared, t_p, _ = prepare_sweep(
        ts, evo, pop, grid, caches, run32.pm, run32.gen, run32.t_max_tip,
        run32.num_cells)
    stat, ctx, shared = pad_chain(stat, ctx, shared, NC=2304, MC=6400)
    assert bc.entry(stat, 0, F32) == "delphy_sweep_chain_global_f32"
    u = bc.gen_block_uniforms(run32.gen, ctx["t"].shape[0], 16, stat.NC,
                              stat.MC, device, F32)
    got = bc.sweep_chain_kernel(stat, 16, ctx, shared, u)
    _close_sweep32(got, bc.sweep_chain_torch(stat, 16, ctx, shared, u))
    lbs, k2, t_row, inner = pop_cuda.pack_rows(grid, ts.t, ts.is_tip)
    n_pad = 40_000 - t_row.numel()
    t_row = torch.cat([t_row, t_row[:, -1:].expand(1, n_pad)], 1)
    inner = torch.cat([inner, inner.new_zeros(1, n_pad)], 1)
    u = torch.rand((50, 4), generator=run32.gen, dtype=F32, device=device)
    args = (u, lbs, k2, t_row, inner, grid.t_step, pop.t0, pop.min_pop,
            pop.n0, pop.g, pop_cuda.hyp_floats(run32.hyp), 50)
    _close(pop_cuda.exp_pop_chain_kernel(*args),
           pop_cuda.exp_pop_chain_torch(*args), **F32_CHAIN)


def test_f32_wrappers_refuse_mixed_precision(run32, boundary32, device):
    """A float32 launch takes float32 inputs only: no cast, no fallback."""
    from delphy_tpu_torch.parallel import block_cuda as bc
    from delphy_tpu_torch.parallel import pop_cuda
    from delphy_tpu_torch.parallel.sweep import prepare_sweep
    ts, evo, pop, grid, caches, ledger, stats = boundary32
    u = torch.rand((50, 4), dtype=F32, device=device)
    rows = pop_cuda.pack_rows(grid, ts.t.double(), ts.is_tip)
    with pytest.raises(ValueError):
        pop_cuda.exp_pop_chain_kernel(
            u, *rows, grid.t_step, pop.t0, pop.min_pop, pop.n0, pop.g,
            pop_cuda.hyp_floats(run32.hyp), 50)
    stat, ctx, shared, t_p, _ = prepare_sweep(
        ts, evo, pop, grid, caches, run32.pm, run32.gen, run32.t_max_tip,
        run32.num_cells)
    u = bc.gen_block_uniforms(run32.gen, t_p.shape[0], 4, stat.NC, stat.MC,
                              device, torch.float64)
    with pytest.raises(ValueError):
        bc.sweep_chain_kernel(stat, 4, ctx, shared, u)


def test_f32_run_repeats_itself_bit_for_bit(device):
    """A float32 2-boundary dispatch on 1,000 tips x 29,903 sites from the
    same state and generator state gives the same bits every time, and a
    float32 Run keeps its ledger at the scaled f32 tolerance launching only
    the *_f32 entries."""
    from delphy_tpu_torch.parallel import _cuda
    from delphy_tpu_torch.parallel.sweep import parts_multi_super_step
    from delphy_tpu_torch.run import Run
    run = Run(sim_tree(1000), seed=4, num_cells=400, device=device,
              dtype=F32)
    _cuda.reset_launch_counts()
    run.do_mcmc_steps(2 * run.local_moves_per_global_move)
    launched = {k for k, v in _cuda.launch_counts.items() if v}
    assert launched and all(k.endswith("_f32") for k in launched), launched
    run.check_derived_quantities(
        max(0.05 * abs(float(run.ledger.log_G)) / 4.5e4, 1e-3))
    run.tree().check_integrity()
    state = run.gen.get_state()
    outs = []
    for _ in range(4):
        run.gen.set_state(state)
        ts, evo, pop, led, _stats, _fused = parts_multi_super_step(
            run.ts, run.evo, run.pop, run.gen, run.tin, run.tout, run.pm, 24,
            run.t_max_tip, run.hyp, run.num_cells, 2)
        outs.append((ts.t.clone(), ts.mut_t.clone(), evo.kappa.clone(),
                     pop.n0.clone(), led.log_G.clone()))
    assert outs[0][0].dtype == F32
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))


# ---------------------------------------------------------------------------
# The Python topology mixer fallback and the device SPR
# ---------------------------------------------------------------------------

def test_python_mixer_run_on_card(device, monkeypatch):
    """A Run on the card with the native burst forced off bursts on the
    Python mixer (in process, one part), keeps its ledger at 1e-6 and
    launches the exponential path's kernels."""
    from delphy_tpu_torch import run as run_mod
    from delphy_tpu_torch.parallel import _cuda
    monkeypatch.setattr(run_mod, "run_burst_native", lambda *a, **kw: None)
    run = run_mod.Run(ebola_tree(30), seed=3, num_cells=128, device=device,
                      topology_partitions=1)
    _cuda.reset_launch_counts()
    run.do_mcmc_steps(2 * run.local_moves_per_global_move)
    assert run.burst_count >= 1 and run.topology_accepted > 0
    assert all(_cuda.launch_counts[k] > 0 for k in EXP_KERNELS)
    run.check_derived_quantities(1e-6)
    run.tree().check_integrity()


def test_device_spr_on_card_equals_cpu(device):
    """spr1_sweep and slide_sweep on the card from a card generator, replayed
    on the CPU from the same draws: the same trees (times and delta_log_G
    1e-12), moves accepted, and one host synchronisation a sweep."""
    import warnings

    from delphy_tpu_torch.evo import make_evo_params
    from delphy_tpu_torch.ops import spr_move as sm
    from delphy_tpu_torch.phylo import (build_greedy_tree,
                                        rereference_to_root_sequence)
    from delphy_tpu_torch.sim import simulate_dataset
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        24, 3000, mu=1e-3 / 365, sample_window_days=700.0,
        missing_fraction=0.0, seed=3)
    tree = build_greedy_tree(ref, deltas, miss, dates, names=names,
                             rng=np.random.default_rng(3))
    rereference_to_root_sequence(tree)
    evo = make_evo_params(tree.num_sites, mu=1e-3 / 365, kappa=2.0,
                          device="cpu")
    q3 = evo.q_tab.numpy().reshape(-1, 4, 4)
    qa = np.stack([-np.diag(q) for q in q3])
    nu, part = evo.nu.numpy(), evo.part.numpy()
    lam_ref = float(np.sum(1e-3 / 365 * nu * qa[part, tree.ref_seq]))

    def args(dev):
        def F(a):
            return torch.as_tensor(np.asarray(a, np.float64)).to(dev)
        return (torch.as_tensor(tree.ref_seq.astype(np.int64)).to(dev),
                tree.num_sites, F([1e-3 / 365]), F(nu), F(q3.reshape(-1)),
                F(qa.reshape(-1)), torch.as_tensor(part.astype(np.int64)).to(
                    dev), F([lam_ref]), float(np.max(tree.t_max[:24])))
    a_dev, a_cpu = args(device), args(torch.device("cpu"))
    p = sm.pack_tree(tree, device=device)
    p_cpu = sm.pack_tree(tree, device="cpu")
    gen = torch.Generator(device=device).manual_seed(7)
    for sweep, core in ((sm.spr1_sweep, sm.spr1_sweep_core),
                        (sm.slide_sweep, sm.slide_sweep_core)):
        rec = []
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                got = sweep(gen, p, a_dev[0], a_dev[1], 32, *a_dev[2:],
                            record=rec)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        n_sync = len([w for w in caught if "called a synchronizing CUDA "
                      "operation" in str(w.message)])
        assert n_sync == 1, n_sync
        to_cpu = [type(d)(*[type(x)(*[y.cpu() for y in x])
                            if isinstance(x, tuple) else x.cpu()
                            for x in d]) for d in rec[0]]
        want = core(p_cpu, *a_cpu, to_cpu)
        assert int(got.n_accepted) == int(want.n_accepted) > 0
        for k in sm.TREE_KEYS:
            g, w = got.p[k].cpu(), want.p[k]
            if g.is_floating_point():
                torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
            else:
                assert torch.equal(g, w), k
        torch.testing.assert_close(got.delta_log_G.cpu(), want.delta_log_G,
                                   rtol=1e-12, atol=1e-12)


def test_posterior_on_card_matches_jax_reference(device):
    """Configuration S of data/jax_posterior_reference.json on the card:
    the port's float64 chain against both committed JAX chains under
    tests/test_f32.py's rule (tests/test_torch_posterior.py runs it on the
    CPU): every summary under max(8, 3 x the JAX null) joint Monte-Carlo
    standard errors, the within-window drift under 1e-8, and the chain on
    the kernels."""
    import json
    import sys

    from delphy_tpu_torch.parallel import _cuda
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_f32_study
    with open(os.path.join(REPO, "data", "jax_posterior_reference.json")) as f:
        S = json.load(f)["S"]
    cfg = {k: S["recipe"][k] for k in ("tips", "sites", "steps")}
    _cuda.reset_launch_counts()
    port = torch_f32_study.run_chain(F64, dict(cfg, seed=5), device)
    assert all(_cuda.launch_counts[k] > 0 for k in EXP_KERNELS)
    chains = S["chains"]
    null = torch_f32_study.compare(chains["5"], chains["1005"])
    bound = max(8.0, 3.0 * null["max_sigma"])
    assert port["max_drift"] < 1e-8
    for seed, chain in chains.items():
        report = torch_f32_study.compare(port, chain)
        assert report["max_sigma"] < bound, (seed, report["summaries"],
                                             null["summaries"])
