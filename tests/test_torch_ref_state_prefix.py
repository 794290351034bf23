"""The reference-state prefix kernel (``csrc/ref_state_prefix.cu`` through
``parallel/scan_cuda.py``, behind ``ops/likelihood.py``
calc_ref_state_prefix and calc_ref_state_prefix_beta) on the card: its
tables against the plain one-hot torch.cumsum at lengths on both sides of
a warp and a tile and at the datasets' site counts, with 4 keys and with 8
(two partitions, without the counts), in float64 and float32: the counts
and the sums of unit weights bit for bit, gamma-distributed weights within
the depth of their additions x the unit roundoff of the exact sums; the
same bits over
repeated launches and from a CUDA graph's replay; the wrapper's refusals.
The card's tests need an NVIDIA GPU and nvcc and skip without one; the
CPU's take the plain version.  This file imports no jax:

    python -m pytest tests/test_torch_ref_state_prefix.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from delphy_tpu_torch.evo import make_evo_params
from delphy_tpu_torch.ops import likelihood as lk
from delphy_tpu_torch.parallel import _cuda, scan_cuda

TILE = scan_cuda.REF_TILE
# both sides of a warp (32) and a tile (2,048 sites); Ebola's L (one
# cluster), two clusters, mpox's L (four), and many tiles a block
LENGTHS = [1, 31, 32, 33, TILE - 1, TILE, TILE + 1, 18_959, 40_000,
           197_209, 1_000_003]
PARTS = [1, 2]
DTYPES = [torch.float64, torch.float32]


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def sites(n: int, parts: int, dtype, seed: int = 0, unit: bool = False):
    """(ref_seq, part or None, nu) of n sites on the CPU: states 0..3,
    partitions 0..parts-1 (None for one), nu all ones or gamma(alpha 0.5)
    draws as the alpha/nu model's."""
    rng = np.random.default_rng(seed * 1_000_003 + n * 7 + parts)
    ref = torch.as_tensor(rng.integers(0, 4, n), dtype=torch.int32)
    part = (torch.as_tensor(rng.integers(0, parts, n), dtype=torch.int32)
            if parts > 1 else None)
    nu = (np.ones(n) if unit else rng.gamma(0.5, 2.0, n))
    return ref, part, torch.as_tensor(nu).to(dtype)


def on(device, *ts):
    return [None if t is None else t.to(device) for t in ts]


def tables(ref, nu, part, parts: int, kernel: bool = True):
    """The kernel's (or the plain version's) tables, with the counts on
    one partition."""
    fn = (scan_cuda.ref_state_prefix if kernel
          else scan_cuda.ref_state_prefix_torch)
    return fn(ref, nu, part, parts, counts=parts == 1)


def exact_table(ref, part, nu, parts: int) -> np.ndarray:
    """The exact nu-weighted prefix table [4 * parts, L + 1], each entry
    rounded once to float64: every float is an integer multiple of
    2**-1074, so running sums of Python integers are exact and int / int
    division rounds correctly."""
    keys = ref.long() if part is None else part.long() * 4 + ref.long()
    keys, w = keys.numpy(), nu.double().tolist()
    n, one = keys.shape[0], 1 << 1074
    out = np.zeros((4 * parts, n + 1))
    for k in range(4 * parts):
        idx = np.flatnonzero(keys == k)
        acc, vals = 0, np.empty(idx.shape[0])
        for j, i in enumerate(idx):
            num, den = w[i].as_integer_ratio()
            acc += num * (one // den)
            vals[j] = acc / one
        # column c holds the sum over the key's sites below c
        upto = np.searchsorted(idx, np.arange(n + 1), side="left")
        out[k] = np.where(upto > 0, vals[np.maximum(upto - 1, 0)]
                          if idx.shape[0] else 0.0, 0.0)
    return out


def bound(ref, part, nu, parts: int) -> np.ndarray:
    """What the kernel may differ from the exact table: an output at
    column c (site c - 1) nests at most REF_CHUNK + 12 + (c - 1) // TILE
    additions deep (csrc/ref_state_prefix.cu), so its error is at most that
    depth x the unit roundoff of nu's precision x the sum of the row's nu
    below c; one more unit for the float64 rounding of the exact sum, and
    a factor 2 for the first-order bound's higher terms."""
    _, tab = scan_cuda.ref_state_prefix_torch(ref, nu.double(), part, parts,
                                              counts=False)
    c = np.arange(ref.shape[0] + 1)
    depth = scan_cuda.REF_CHUNK + 12 + np.maximum(c - 1, 0) // TILE
    unit = torch.finfo(nu.dtype).eps / 2
    return 2.0 * (depth + 1) * unit * tab.numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("n", LENGTHS)
def test_counts_and_unit_weights_equal_the_plain_version(device, n, parts,
                                                         dtype):
    ref, part, nu = sites(n, parts, dtype, unit=True)
    cnt, nucum = tables(*on(device, ref, nu, part), parts)
    want_cnt, want_nucum = tables(ref, nu, part, parts, kernel=False)
    assert nucum.dtype == dtype and nucum.shape == (4 * parts, n + 1)
    assert torch.equal(nucum.cpu(), want_nucum)
    if parts == 1:
        assert cnt.dtype == dtype and torch.equal(cnt.cpu(), want_cnt)
    else:
        assert cnt is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("n", LENGTHS)
def test_weighted_table_within_its_bound(device, n, parts, dtype):
    ref, part, nu = sites(n, parts, dtype, seed=1)
    cnt, nucum = tables(*on(device, ref, nu, part), parts)
    if parts == 1:
        assert torch.equal(cnt.cpu(), tables(ref, nu, part, parts,
                                             kernel=False)[0])
    err = np.abs(nucum.double().cpu().numpy()
                 - exact_table(ref, part, nu, parts))
    over = err > bound(ref, part, nu, parts)
    assert not over.any(), (float(err.max()), np.argwhere(over)[:3])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("parts", PARTS)
def test_launches_repeat_bit_for_bit(device, parts, dtype):
    ref, part, nu = on(device, *sites(197_209, parts, dtype, seed=2))
    first = tables(ref, nu, part, parts)
    for _ in range(20):
        again = tables(ref, nu, part, parts)
        assert all(a is b is None or torch.equal(a, b)
                   for a, b in zip(again, first))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("parts", PARTS)
def test_graph_replay_equals_eager(device, parts, dtype):
    """A captured launch replayed on new weights in its input buffer gives
    the eager call's bits; the capture counts one launch."""
    n = 197_209
    ref, part, nu = on(device, *sites(n, parts, dtype, seed=3))
    tables(ref, nu, part, parts)           # the kernels built and loaded
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    name = "ref_state_prefix" + _cuda.suffix(dtype)
    before = _cuda.launch_counts[name]
    with torch.cuda.graph(graph):
        out = tables(ref, nu, part, parts)
    assert _cuda.launch_counts[name] == before + 1
    for seed in (4, 5):
        nu.copy_(sites(n, parts, dtype, seed=seed)[2].to(device))
        graph.replay()
        torch.cuda.synchronize()
        want = tables(ref, nu, part, parts)
        assert all(a is b is None or torch.equal(a, b)
                   for a, b in zip(out, want))


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(device):
    ref, part, nu = on(device, *sites(64, 2, torch.float64))

    def call(ref=ref, nu=nu, part=part, parts=2, counts=False):
        return scan_cuda.ref_state_prefix(ref, nu, part, parts, counts)
    with pytest.raises(ValueError, match="contiguous"):
        call(ref[::2], nu[::2], part[::2])
    with pytest.raises(ValueError, match="shape"):
        call(ref=ref[:32])
    with pytest.raises(ValueError, match="shape"):
        call(part=part[:32])
    with pytest.raises(ValueError, match="shape"):
        call(nu=nu.reshape(8, 8))
    with pytest.raises(ValueError, match="no kernel build"):
        call(nu=nu.to(torch.int64))
    with pytest.raises(ValueError, match="dtype"):
        call(ref=ref.long())
    with pytest.raises(ValueError, match="dtype"):
        call(part=part.long())
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(ref=ref.cpu())
    with pytest.raises(ValueError, match="partitions"):
        call(parts=3)
    with pytest.raises(ValueError, match="partitions"):
        call(counts=True)


def model(n: int, parts: int, dtype, device):
    """A TreeState stand-in with the reference sequence, and EvoParams with
    gamma nu and a partition table of ``parts`` partitions."""
    from types import SimpleNamespace
    ref, part, nu = sites(n, parts, dtype, seed=6)
    evo = make_evo_params(n, device=device, dtype=dtype)
    evo = evo._replace(nu=nu.to(device),
                       part=(part if part is not None
                             else torch.zeros(n, dtype=torch.int32)).to(
                                 device),
                       q_tab=evo.q_tab[:1].expand(parts, 4, 4).contiguous())
    return SimpleNamespace(ref_seq=ref.to(device)), evo


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_likelihood_tables_launch_the_kernel_and_no_scan(device, dtype,
                                                         monkeypatch):
    """calc_ref_state_prefix and calc_ref_state_prefix_beta on the card:
    one launch each, no torch.cumsum and no F.one_hot, the kernel's own
    tables."""
    ts, evo = model(18_959, 2, dtype, device)
    want = (scan_cuda.ref_state_prefix(ts.ref_seq, evo.nu),
            scan_cuda.ref_state_prefix(ts.ref_seq, evo.nu, evo.part, 2,
                                       counts=False)[1])

    def refused(*a, **k):
        raise AssertionError("a plain-version op on the card")
    monkeypatch.setattr(torch, "cumsum", refused)
    monkeypatch.setattr(F, "one_hot", refused)
    name = "ref_state_prefix" + _cuda.suffix(dtype)
    before = _cuda.launch_counts[name]
    cnt, nucum = lk.calc_ref_state_prefix(ts, evo)
    pa = lk.calc_ref_state_prefix_beta(ts, evo)
    assert _cuda.launch_counts[name] == before + 2
    assert torch.equal(cnt, want[0][0]) and torch.equal(nucum, want[0][1])
    assert pa.shape == (2, 4, 18_960) and torch.equal(
        pa, want[1].reshape(2, 4, -1))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("parts", PARTS)
def test_cpu_tensors_take_the_plain_version(dtype, parts):
    """On the CPU the tables are the one-hot's torch.cumsum, unchanged,
    and nothing is launched."""
    n = 5000
    ts, evo = model(n, parts, dtype, torch.device("cpu"))
    before = dict(_cuda.launch_counts)
    keys = evo.part.long() * 4 + ts.ref_seq.long()
    onehot = F.one_hot(keys, 4 * parts).to(dtype).T
    zeros = torch.zeros((4 * parts, 1), dtype=dtype)
    want = torch.cat([zeros, torch.cumsum(onehot * evo.nu[None, :], 1)], 1)
    pa = lk.calc_ref_state_prefix_beta(ts, evo)
    assert torch.equal(pa, want.reshape(parts, 4, -1))
    onehot = F.one_hot(ts.ref_seq.long(), 4).to(dtype).T
    cnt, nucum = lk.calc_ref_state_prefix(ts, evo)
    assert torch.equal(cnt, torch.cat([zeros[:4], torch.cumsum(onehot, 1)],
                                      1))
    assert torch.equal(nucum, torch.cat(
        [zeros[:4], torch.cumsum(onehot * evo.nu[None, :], 1)], 1))
    assert _cuda.launch_counts == before
