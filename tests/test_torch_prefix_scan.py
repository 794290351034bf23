"""The fixed-order prefix-scan kernel (``csrc/prefix_scan.cu`` through
``parallel/scan_cuda.py``, behind ``ops/likelihood.py`` cumsum0) on the
card: its values against the exact prefix sums at lengths on both sides of
a warp, a block and a tile and at the datasets' site counts, in float64 and
float32; the same bits over repeated launches and from a CUDA graph's
replay; the wrapper's checks.  The card's tests need an NVIDIA GPU and nvcc
and skip without one; the CPU's take the plain torch.cumsum.  This file
imports no jax:

    python -m pytest tests/test_torch_prefix_scan.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from delphy_tpu_torch.ops.likelihood import cumsum0
from delphy_tpu_torch.parallel import _cuda, scan_cuda

# both sides of a warp (32), a block (1,024) and a float64 tile (4,096
# elements: 1,024 threads x 4); Ebola's L and L + 1, SARS-CoV-2's L + 1,
# mpox's L + 1
LENGTHS = [1, 2, 31, 32, 33, 1023, 1024, 1025, 18_959, 18_960, 29_904,
           197_210]
DTYPES = [torch.float64, torch.float32]


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def values(n: int, dtype, seed: int = 0) -> torch.Tensor:
    """n values of both signs over six orders of magnitude, as a
    difference array's +-T_below beside the sites' positive rates."""
    rng = np.random.default_rng(seed * 1_000_003 + n)
    x = rng.standard_normal(n) * np.exp(rng.uniform(-7.0, 7.0, n))
    return torch.as_tensor(x).to(dtype)


def exact_prefix(x: torch.Tensor) -> np.ndarray:
    """The exact prefix sums of ``x``, each rounded once to float64: every
    float is an integer multiple of 2**-1074, so a running sum of Python
    integers is exact, and int / int division rounds correctly."""
    one = 1 << 1074
    acc, out = 0, np.empty(x.shape[0])
    for i, v in enumerate(x.double().tolist()):
        num, den = v.as_integer_ratio()
        acc += num * (one // den)
        out[i] = acc / one
    return out


def bound(x: torch.Tensor) -> np.ndarray:
    """What the kernel may differ from the exact prefix sum at each output:
    its additions nest at most ITEMS + 12 + i // TILE deep
    (csrc/prefix_scan.cu), so the error is at most that depth x the unit
    roundoff of x's precision x the sum of |x| up to i; one more unit of
    it for the float64 rounding of the exact sum, and a factor 2 for the
    first-order bound's higher terms and the float64 sum of |x|."""
    n, items = x.shape[0], scan_cuda.items(x.dtype)
    i = np.arange(n)
    depth = items + 12 + i // (scan_cuda.THREADS * items)
    unit = torch.finfo(x.dtype).eps / 2
    return 2.0 * (depth + 1) * unit * np.cumsum(np.abs(x.double().numpy()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", LENGTHS)
def test_values_match_the_exact_prefix_sums(device, n, dtype):
    x = values(n, dtype)
    got = scan_cuda.prefix_scan(x.to(device))
    assert got.dtype == dtype and got.shape == (n,)
    err = np.abs(got.double().cpu().numpy() - exact_prefix(x))
    assert np.all(err <= bound(x)), (float(err.max()), int(err.argmax()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [18_960, 197_210])
def test_launches_repeat_bit_for_bit(device, n, dtype):
    x = values(n, dtype, seed=1).to(device)
    first = scan_cuda.prefix_scan(x)
    for _ in range(20):
        assert torch.equal(scan_cuda.prefix_scan(x), first)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_graph_replay_equals_eager(device, dtype):
    """A captured scan replayed on new contents of its input buffer gives
    the eager call's bits; the capture counts one launch."""
    n = 18_960
    buf = values(n, dtype, seed=2).to(device)
    scan_cuda.prefix_scan(buf)          # the kernels built and loaded
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    name = "prefix_scan" + _cuda.suffix(dtype)
    before = _cuda.launch_counts[name]
    with torch.cuda.graph(graph):
        out = scan_cuda.prefix_scan(buf)
    assert _cuda.launch_counts[name] == before + 1
    for seed in (3, 4):
        buf.copy_(values(n, dtype, seed=seed).to(device))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, scan_cuda.prefix_scan(buf))


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(device):
    x = values(64, torch.float64).to(device)
    with pytest.raises(ValueError, match="contiguous"):
        scan_cuda.prefix_scan(x[::2])
    with pytest.raises(ValueError, match="shape"):
        scan_cuda.prefix_scan(x.reshape(8, 8))
    with pytest.raises(ValueError, match="no kernel build"):
        scan_cuda.prefix_scan(x.to(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cumsum0_on_the_card_launches_the_kernel(device, dtype):
    x = values(1000, dtype, seed=5).to(device)
    name = "prefix_scan" + _cuda.suffix(dtype)
    before = _cuda.launch_counts[name]
    got = cumsum0(x)
    assert _cuda.launch_counts[name] == before + 1
    assert torch.equal(got, scan_cuda.prefix_scan(x))


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_tensors_take_the_plain_cumsum(dtype):
    x = values(5000, dtype, seed=6)
    before = dict(_cuda.launch_counts)
    assert torch.equal(scan_cuda.prefix_scan(x), torch.cumsum(x, 0))
    assert torch.equal(cumsum0(x), torch.cumsum(x, 0))
    assert _cuda.launch_counts == before
