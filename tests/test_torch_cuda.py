"""The CUDA kernels on the card against their plain PyTorch versions, and a
short Run through them.  Needs an NVIDIA GPU and nvcc: every test here skips
on a host without one.  This file imports no jax, so it also runs on a host
that has none:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAPLE = os.path.join(REPO, "data", "ebola2014_like_81x18959.maple")

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def run(device):
    from delphy_tpu.init_tree import build_initial_tree
    from delphy_tpu.io.maple import read_maple
    from delphy_tpu_torch.run import Run
    mf = read_maple(MAPLE)
    tips = mf.tips[:40]
    tree = build_initial_tree(mf.ref_seq, [t.deltas for t in tips],
                              [t.miss_intervals for t in tips],
                              [(t.t_min, t.t_max) for t in tips],
                              names=[t.name for t in tips],
                              rng=np.random.default_rng(42))
    r = Run(tree, seed=3, num_cells=256, device=device)
    r.do_mcmc_steps(r.local_moves_per_global_move)
    return r


@pytest.fixture(scope="module")
def boundary(run):
    from delphy_tpu_torch.mcmc.kernel import run_global_moves
    return run_global_moves(run.ts, run.evo, run.pop, run.gen, run.tin,
                            run.tout, run.t_max_tip, run.hyp, run.num_cells)


def _close(got, want, rtol, atol):
    for g, w in zip(got, want):
        torch.testing.assert_close(g.reshape(-1), w.reshape(-1), rtol=rtol,
                                   atol=atol)


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
