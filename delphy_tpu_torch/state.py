"""Device-side MCMC state: fixed-capacity flat tensors (port of
``delphy_tpu/state.py``).

Same layout and conventions as the reference: tips at nodes 0..T-1,
``mut_node == -1`` marks a free mutation slot, root-sequence deltas sit on
the root with time ``ROOT_MUT_T``, and missation intervals and from-state
exceptions are flat tables with ``-1`` marking free slots.  Integer leaves
are int32 and float leaves float64, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import DEFAULT_DEVICE, DTYPE, ITYPE, resolve_device
from .phylo import FlatTree, Mutation, NO_NODE

ROOT_MUT_T = -1.0e30  # sentinel time for root-sequence deltas


class TreeState(NamedTuple):
    parent: torch.Tensor     # i32[N]
    children: torch.Tensor   # i32[N,2]
    t: torch.Tensor          # f64[N]
    t_min: torch.Tensor      # f64[N]
    t_max: torch.Tensor      # f64[N]
    root: torch.Tensor       # i32 scalar
    ref_seq: torch.Tensor    # i32[L]
    mut_node: torch.Tensor   # i32[M]
    mut_site: torch.Tensor   # i32[M]
    mut_from: torch.Tensor   # i32[M]
    mut_to: torch.Tensor     # i32[M]
    mut_t: torch.Tensor      # f64[M]
    miss_node: torch.Tensor  # i32[K]
    miss_start: torch.Tensor  # i32[K]
    miss_end: torch.Tensor   # i32[K]
    fs_node: torch.Tensor    # i32[F]
    fs_site: torch.Tensor    # i32[F]
    fs_from: torch.Tensor    # i32[F]

    @property
    def num_nodes(self) -> int:
        return self.parent.shape[0]

    @property
    def num_tips(self) -> int:
        return (self.parent.shape[0] + 1) // 2

    @property
    def num_sites(self) -> int:
        return self.ref_seq.shape[0]

    @property
    def is_tip(self):
        return self.children[:, 0] == NO_NODE


def _round_capacity(n: int, minimum: int = 64) -> int:
    cap = max(minimum, int(1.5 * n) + 16)
    return (cap + 127) // 128 * 128


def _pad(rows, cap: int, dtypes):
    out = []
    for c, dt in enumerate(dtypes):
        a = np.full(cap, -1 if np.issubdtype(dt, np.integer) else 0.0, dtype=dt)
        if rows:
            a[:len(rows)] = [r[c] for r in rows]
        out.append(a)
    return out


def pack_state(tree: FlatTree, mut_capacity: int | None = None,
               miss_capacity: int | None = None,
               fs_capacity: int | None = None,
               device=DEFAULT_DEVICE) -> TreeState:
    device = resolve_device(device)
    N = tree.num_nodes
    T = tree.num_tips
    for i in range(T):
        assert tree.is_tip(i), "pack_state requires tips at indices 0..T-1"

    muts = [(node, m.site, m.from_, m.to,
             ROOT_MUT_T if node == tree.root else m.t)
            for node in range(N) for m in tree.mutations[node]]
    M = mut_capacity or _round_capacity(len(muts))
    assert len(muts) <= M
    ivs = [(node, s, e) for node in range(N)
           for (s, e) in tree.miss_intervals[node]]
    K = miss_capacity or _round_capacity(len(ivs))
    assert len(ivs) <= K
    fss = [(node, site, frm) for node in range(N)
           for site, frm in tree.miss_from_states[node].items()]
    F = fs_capacity or _round_capacity(len(fss))
    assert len(fss) <= F

    i32 = np.int32
    mn, ms, mf, mt_, mtime = _pad(muts, M, [i32, i32, i32, i32, np.float64])
    vn, vs, ve = _pad(ivs, K, [i32, i32, i32])
    fn, fsi, ffr = _pad(fss, F, [i32, i32, i32])

    def ti(a):
        return torch.as_tensor(np.asarray(a, np.int32), dtype=ITYPE,
                               device=device)

    def tf(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=DTYPE,
                               device=device)

    return TreeState(
        parent=ti(tree.parent), children=ti(tree.children), t=tf(tree.t),
        t_min=tf(tree.t_min), t_max=tf(tree.t_max), root=ti(tree.root),
        ref_seq=ti(tree.ref_seq),
        mut_node=ti(mn), mut_site=ti(ms), mut_from=ti(mf), mut_to=ti(mt_),
        mut_t=tf(mtime),
        miss_node=ti(vn), miss_start=ti(vs), miss_end=ti(ve),
        fs_node=ti(fn), fs_site=ti(fsi), fs_from=ti(ffr))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def unpack_state(ts: TreeState, names=None) -> FlatTree:
    """Host FlatTree from a TreeState of tensors or numpy arrays (the
    tensors are copied to the host first, leaf by leaf)."""
    h = TreeState(*[_np(x) for x in ts])
    N = len(h.parent)
    mutations = [[] for _ in range(N)]
    for j in np.nonzero(h.mut_node >= 0)[0]:
        mutations[int(h.mut_node[j])].append(Mutation(
            site=int(h.mut_site[j]), from_=int(h.mut_from[j]),
            to=int(h.mut_to[j]), t=float(h.mut_t[j])))
    for node in range(N):
        mutations[node].sort(key=lambda m: (m.t, m.site))
    miss_intervals = [[] for _ in range(N)]
    for j in np.nonzero(h.miss_node >= 0)[0]:
        miss_intervals[int(h.miss_node[j])].append(
            (int(h.miss_start[j]), int(h.miss_end[j])))
    for node in range(N):
        miss_intervals[node].sort()
    miss_from_states = [{} for _ in range(N)]
    for j in np.nonzero(h.fs_node >= 0)[0]:
        miss_from_states[int(h.fs_node[j])][int(h.fs_site[j])] = \
            int(h.fs_from[j])
    return FlatTree(
        parent=np.asarray(h.parent).copy(),
        children=np.asarray(h.children).copy(),
        t=np.asarray(h.t, dtype=np.float64).copy(),
        t_min=np.asarray(h.t_min, dtype=np.float64).copy(),
        t_max=np.asarray(h.t_max, dtype=np.float64).copy(),
        root=int(h.root),
        ref_seq=np.asarray(h.ref_seq, dtype=np.int8).copy(),
        mutations=mutations, miss_intervals=miss_intervals,
        miss_from_states=miss_from_states,
        name=list(names) if names else [f"tip_{i}" for i in range((N + 1) // 2)],
    )


# ---------------------------------------------------------------------------
# Fused device->host transfer
# ---------------------------------------------------------------------------
#
# A topology burst needs the whole (TreeState, EvoParams, pop) bundle on the
# host.  fuse_for_host concatenates every integer leaf into one int32 vector
# and every float leaf into one vector ON THE DEVICE, so the host fetch is two
# copies instead of one per leaf; split_for_host slices the fetched buffers
# back into the original structure with numpy leaves.  Leaf order is the
# NamedTuple field order, depth first (jax.tree_util's order); a record with
# ``tree_flatten``/``tree_unflatten`` (pop.SkygridPopParams) contributes the
# children it flattens to and keeps its static part.

def _leaves(tree) -> list:
    if hasattr(tree, "tree_flatten"):
        tree = tree.tree_flatten()[0]
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    return [tree]


def _rebuild(template, it):
    if hasattr(template, "tree_flatten"):
        children, aux = template.tree_flatten()
        return type(template).tree_unflatten(
            aux, [_rebuild(s, it) for s in children])
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*[_rebuild(s, it) for s in template])
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(s, it) for s in template)
    return next(it)


def _is_int(x) -> bool:
    if isinstance(x, torch.Tensor):
        return not x.dtype.is_floating_point and x.dtype != torch.bool
    return np.issubdtype(np.asarray(x).dtype, np.integer)


def fuse_for_host(pytree):
    """(ints_i32, floats_f64) concatenated over the leaves, on the leaves'
    device."""
    leaves = [torch.as_tensor(leaf) for leaf in _leaves(pytree)]
    dev = leaves[0].device if leaves else torch.device("cpu")
    ints = [leaf.reshape(-1).to(torch.int32) for leaf in leaves
            if _is_int(leaf)]
    flts = [leaf.reshape(-1).to(DTYPE) for leaf in leaves if not _is_int(leaf)]
    return (torch.cat(ints) if ints else torch.zeros(0, dtype=torch.int32,
                                                     device=dev),
            torch.cat(flts) if flts else torch.zeros(0, dtype=DTYPE,
                                                     device=dev))


_NP_DTYPE = {torch.float64: np.float64, torch.float32: np.float32,
             torch.int32: np.int32, torch.int64: np.int64,
             torch.int8: np.int8, torch.uint8: np.uint8, torch.bool: np.bool_}


def split_for_host(template, ints_h, flts_h):
    """Host-side inverse of fuse_for_host: ``template``'s structure with
    numpy leaves (original shapes and dtypes; 0-d leaves as numpy scalars)."""
    ints_h = _np(ints_h)
    flts_h = _np(flts_h)
    oi = of = 0
    out = []
    for leaf in _leaves(template):
        if isinstance(leaf, torch.Tensor):
            shape, dtype = tuple(leaf.shape), _NP_DTYPE[leaf.dtype]
        else:
            a = np.asarray(leaf)
            shape, dtype = a.shape, a.dtype
        n = int(np.prod(shape)) if shape else 1
        if _is_int(leaf):
            v = ints_h[oi:oi + n].reshape(shape).astype(dtype)
            oi += n
        else:
            v = flts_h[of:of + n].reshape(shape).astype(dtype)
            of += n
        out.append(v if shape else v[()])
    return _rebuild(template, iter(out))


def fetch_fused(pytree):
    """The whole structure on the host in two copies (see fuse_for_host)."""
    ints, flts = fuse_for_host(pytree)
    return split_for_host(pytree, ints.cpu(), flts.cpu())


def fetch_one(pytree):
    """The whole structure on the host in ONE copy, for small structures
    read by host code between dispatches: every leaf rides in one float64
    vector (exact for the int32 leaves) and gets its dtype back on the
    host."""
    leaves = [torch.as_tensor(leaf) for leaf in _leaves(pytree)]
    flat = _np(torch.cat([leaf.reshape(-1).to(DTYPE) for leaf in leaves]))
    return _unflatten(pytree, leaves, flat)


def fetch_later(pytree):
    """``fetch_one``'s copy, started now on the current stream into pinned
    host memory; returns a function that waits for that copy alone and
    gives the host structure, so work enqueued after this call does not
    delay it (the overlapped driver reads a boundary's parameters while the
    next dispatch runs)."""
    leaves = [torch.as_tensor(leaf) for leaf in _leaves(pytree)]
    flat = torch.cat([leaf.reshape(-1).to(DTYPE) for leaf in leaves])
    done = None
    if flat.is_cuda:
        host = torch.empty(flat.shape, dtype=DTYPE, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(flat.device))
    else:
        host = flat

    def result():
        if done is not None:
            done.synchronize()
        return _unflatten(pytree, leaves, host.numpy())
    return result


def _unflatten(pytree, leaves, flat: np.ndarray):
    out, o = [], 0
    for leaf in leaves:
        n = leaf.numel()
        v = flat[o:o + n].reshape(tuple(leaf.shape)).astype(
            _NP_DTYPE[leaf.dtype])
        o += n
        out.append(v if leaf.dim() else v[()])
    return _rebuild(pytree, iter(out))
