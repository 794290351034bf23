"""Fused sweep-block chain of the partitioned local sweep, as one CUDA kernel
(``csrc/sweep_chain.cu``, one thread block per part) and its plain PyTorch
version (port of ``delphy_tpu/parallel/block_pallas.py``).

Per part, n_blocks x (single node or tip displacement, cell-block-coloured
batched displacement, batched branch reform), carrying t, mut_t and k_p and
summing dG, dC and the move count; semantics of the reference's move mix
(core/subrun.cpp:98-320).  Randomness comes in as ``BlockUniforms`` with the
JAX layout, and the per-part context as (P, 1, X) rows, so the kernel, the
plain version and the JAX twin ``sweep_chain_jnp`` can be fed the same
arrays.  The population model of the inner-node point terms -log N(t) is
static (``ChainStatics.pop``): the exponential model with its min_pop floor
(entry ``delphy_sweep_chain``), or a skygrid of either type, whose knots
ride in ``shared`` (entry ``delphy_sweep_chain_skygrid``).  Each model has
two builds, chosen by a rule on the shapes (``build``): the rows in shared
memory where they fit in the 227 KB a block can use, else the rows in a
device-memory workspace (entries ``*_global``, launch counts
``sweep_chain_global`` and ``sweep_chain_skygrid_global``).  The port packs
rows unpadded (NC = n_cap, MC = m_cap, C = cells); both versions also
accept the JAX package's 128-lane padded rows, whose padding is inert.
The chain runs in the dtype of its uniforms: float64, or float32 (every
entry's ``_f32`` build, e.g. ``delphy_sweep_chain_f32``), and every float
row must be of that dtype.  The move counts are summed in it as well: at
most n_blocks (1 + 2 NC) a part, exact in float32 below 2^24.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import resolve_dtype
from .. import pop as popm
from . import _cuda


class BlockUniforms(NamedTuple):
    """Pre-generated randomness for NB blocks (leading [P, NB] axes)."""
    pri: torch.Tensor      # [P, NB, NC] batched-displace priorities
    prop: torch.Tensor     # [P, NB, NC] batched-displace proposal u
    acc: torch.Tensor      # [P, NB, NC] batched-displace acceptance u
    ref_u: torch.Tensor    # [P, NB, MC] reform time u
    ref_acc: torch.Tensor  # [P, NB, NC] reform acceptance u
    sc: torch.Tensor       # [P, NB, S >= 6] single-move scalars
    norm: torch.Tensor     # [P, NB, Z >= 1] standard normals (lane 0 used)


# sc lane assignments
_SC_SEL, _SC_NODE_I, _SC_NODE_T, _SC_PROP, _SC_ACC, _SC_OFF = 0, 1, 2, 3, 4, 5
SC_LANES = 6


POP_EXP = 0   # else popm.STAIRCASE or popm.LOG_LINEAR: a skygrid


class ChainStatics(NamedTuple):
    NC: int
    MC: int
    C: int            # cell count of the k_p / b / A / nbar rows
    C_real: int       # live cells (grid formulas use this)
    cpb: int          # cells per colour block
    pop: int = POP_EXP   # population model of the -log N(t) terms


def gen_block_uniforms(gen: torch.Generator, P: int, NB: int, NC: int,
                       MC: int, device, dtype=None) -> BlockUniforms:
    """The uniforms of NB blocks of P parts in ``resolve_dtype(dtype)``, the
    run's float dtype (the JAX ``gen_block_uniforms(dtype=)``)."""
    dtype = resolve_dtype(dtype)

    def u(*shape):
        return torch.rand((P, NB) + shape, generator=gen, dtype=dtype,
                          device=device)
    return BlockUniforms(
        pri=u(NC), prop=u(NC), acc=u(NC), ref_u=u(MC), ref_acc=u(NC),
        sc=u(SC_LANES),
        norm=torch.randn((P, NB, 1), generator=gen, dtype=dtype,
                         device=device))


def bounded_exp_u(u, lam, a, b):
    """x ~ exp(lam x) on [a, b] from uniform u (distributions.h:38-68, by
    inverse CDF; asymptotic branches beyond |lam (b - a)| = 80)."""
    u = torch.clamp(u, min=1e-30)
    ltr = lam * (b - a)
    one = torch.ones_like(lam)
    safe_lam = torch.where(lam == 0.0, one, lam)
    ltr_c = torch.clamp(ltr, -80.0, 80.0)
    mid = a + torch.log1p(u * torch.expm1(ltr_c)) / safe_lam
    hi = b + torch.log(u) / safe_lam
    lo = a + torch.log(u) / safe_lam
    x = torch.where(lam == 0.0, a + u * (b - a),
                    torch.where((lam > 0.0) & (ltr > 80.0), hi,
                                torch.where((lam < 0.0) & (ltr < -80.0),
                                            lo, mid)))
    return torch.minimum(torch.maximum(x, a), b)


def _rows(ctx_arrs, key):
    a = ctx_arrs[key]
    return a.reshape(a.shape[0], -1)


def sweep_chain_torch(stat: ChainStatics, n_blocks: int, ctx_arrs, shared,
                      u: BlockUniforms):
    """Plain PyTorch chain over all P parts at once (index gathers, dense
    (P, NC, C) dk).  Returns (t (P,1,NC), mut_t (P,1,MC), k_p (P,1,C),
    dG (P,), dC (P,), cnt (P,)), the last three the columns of one (P, 3)
    tensor.  In the dtype of the uniforms ``u``."""
    NC, MC, C = stat.NC, stat.MC, stat.C
    dt = u.pri.dtype
    t = _rows(ctx_arrs, "t").to(dt)
    mut_t = _rows(ctx_arrs, "mut_t").to(dt)
    k_p = _rows(ctx_arrs, "k_p").to(dt)
    P = t.shape[0]
    dev = t.device
    par = _rows(ctx_arrs, "par").long()
    c0 = _rows(ctx_arrs, "c0").long()
    c1 = _rows(ctx_arrs, "c1").long()
    t_min, t_max = _rows(ctx_arrs, "t_min"), _rows(ctx_arrs, "t_max")
    lam, dlam = _rows(ctx_arrs, "lam"), _rows(ctx_arrs, "dlam")
    mnode = _rows(ctx_arrs, "mnode").long()
    mvalid = _rows(ctx_arrs, "mvalid") != 0
    msingle = _rows(ctx_arrs, "msingle") != 0
    slope, b = _rows(ctx_arrs, "slope"), _rows(ctx_arrs, "b")
    part_root = ctx_arrs["part_root"].reshape(P, 1).long()
    is_run_root = ctx_arrs["is_run_root"].reshape(P) != 0
    n_leaves = ctx_arrs["n_leaves"].reshape(P).long()
    n_nodes = ctx_arrs["n_nodes"].reshape(P).long()
    A = shared["A"].reshape(1, C)
    nbar = shared["nbar"].reshape(1, C)
    t_lo_g, t_step, t_max_tip = (shared["t_lo"], shared["t_step"],
                                 shared["t_max_tip"])
    if stat.pop == POP_EXP:
        log_n0, g_pop, t0_pop, log_min_pop = (
            shared["log_n0"], shared["g"], shared["t0"],
            shared["log_min_pop"])

        def log_pop(tt):
            return torch.maximum(log_min_pop, log_n0 + g_pop * (tt - t0_pop))
    else:
        sky = popm.SkygridPopParams(x=shared["x"], gamma=shared["gamma"],
                                    type=stat.pop)

        def log_pop(tt):
            return popm.skygrid_log_N(sky, tt)

    zero = torch.zeros((), dtype=dt, device=dev)
    inf = zero + math.inf
    iota_n = torch.arange(NC, device=dev)[None, :]
    valid_node = iota_n < n_nodes[:, None]
    in_batch = valid_node & (iota_n != part_root)
    is_leaf = c0 < 0
    slot_ok = mvalid & (mnode >= 0) & (mnode < NC)
    mnode_c = mnode.clamp(0, NC - 1)
    par_ok = par >= 0
    par_c = par.clamp(min=0)
    c0_c, c1_c = c0.clamp(min=0), c1.clamp(min=0)
    grid_lo = t_lo_g + t_step
    cells = torch.arange(C, device=dev)
    lb = torch.where(cells < stat.C_real, t_lo_g + t_step * cells.to(dt),
                     inf)[None, :]                                # (1, C)
    inv_nbar_dt = t_step / nbar                                   # (1, C)
    n_seg = stat.C_real // stat.cpb + 1

    def gather(a, idx):
        return torch.gather(a, 1, idx)

    def frac(tt):
        return torch.clamp((tt - lb) / t_step, 0.0, 1.0)

    def dquad_of(kp, dk, bb):
        return -torch.sum(inv_nbar_dt * (0.5 * ((kp + dk) ** 2 - kp ** 2) * A
                                         - bb * dk), -1)

    def slot_minmax(mt):
        own_max = torch.full((P, NC), -math.inf, dtype=dt, device=dev)
        own_max = own_max.scatter_reduce(
            1, mnode_c, torch.where(slot_ok, mt, -inf), "amax")
        child_min = torch.full((P, NC), math.inf, dtype=dt, device=dev)
        child_min = child_min.scatter_reduce(
            1, mnode_c, torch.where(slot_ok, mt, inf), "amin")
        return own_max, child_min

    dG = torch.zeros(P, dtype=dt, device=dev)
    dC = torch.zeros(P, dtype=dt, device=dev)
    cnt = torch.zeros(P, dtype=dt, device=dev)

    for i in range(n_blocks):
        sc = u.sc[:, i, :]
        # ---- single node / tip displacement ----
        u_sel, u_ni, u_nt = sc[:, _SC_SEL], sc[:, _SC_NODE_I], \
            sc[:, _SC_NODE_T]
        u_p, u_a = sc[:, _SC_PROP], sc[:, _SC_ACC]
        z = u.norm[:, i, 0]
        inner = u_sel < 0.5
        n_inner = n_nodes - n_leaves
        node_i = n_leaves + torch.floor(
            u_ni * n_inner.clamp(min=1).to(dt)).long()
        node_t = torch.floor(u_nt * n_leaves.clamp(min=1).to(dt)).long()
        node = torch.where(inner, node_i, node_t)
        node_ok = (node >= 0) & (node < NC)
        nd = node.clamp(0, NC - 1)[:, None]

        def at(a, idx=nd):
            v = gather(a, idx)[:, 0]
            return torch.where(node_ok, v, torch.zeros_like(v))

        is_root_move = inner & (node == part_root[:, 0])
        tmin_n, tmax_n = at(t_min), at(t_max)
        valid = torch.where(inner, (~is_root_move) | is_run_root,
                            tmin_n < tmax_n)
        own_max = torch.where((mnode == node[:, None]) & mvalid, mut_t,
                              -inf).amax(1)
        safe_par = at(par).clamp(min=0)
        t_par = torch.where(is_root_move, grid_lo,
                            gather(t, safe_par[:, None])[:, 0])
        t_lo_b = torch.maximum(t_par, own_max)
        t_lo_b = torch.where(inner, t_lo_b, torch.maximum(t_lo_b, tmin_n))
        c0_n, c1_n = at(c0), at(c1)

        def child_bound(cn):
            cs = cn.clamp(min=0)
            mut_min = torch.where((mnode == cs[:, None]) & mvalid, mut_t,
                                  inf).amin(1)
            t_c = gather(t, cs[:, None])[:, 0]
            return torch.where(cn >= 0, torch.minimum(t_c, mut_min), inf)

        t_hi = torch.where(inner, torch.minimum(child_bound(c0_n),
                                                child_bound(c1_n)), tmax_n)
        lam_n = at(lam)
        dl0 = gather(dlam, c0_n.clamp(min=0)[:, None])[:, 0]
        dl1 = gather(dlam, c1_n.clamp(min=0)[:, None])[:, 0]
        lam_b0 = torch.where(c0_n >= 0, lam_n + dl0, zero)
        lam_b1 = torch.where(c1_n >= 0, lam_n + dl1, zero)
        d = torch.where(inner, torch.where(is_root_move, zero, -lam_n)
                        + lam_b0 + lam_b1, -lam_n)
        old_t = at(t)
        tree_span = torch.clamp(t_max_tip - t_hi, min=0.0)
        delta_scale = torch.minimum(0.5 / torch.clamp(lam_n, min=1e-30),
                                    tree_span)
        root_t = old_t + delta_scale * z
        a = torch.where(t_lo_b > -math.inf, t_lo_b, old_t - 1.0)
        bnd = torch.where(t_hi < math.inf, t_hi, old_t + 1.0)
        bexp_t = bounded_exp_u(u_p, d, torch.minimum(a, bnd), bnd)
        new_t = torch.where(is_root_move, root_t, bexp_t)
        in_bounds = valid & (new_t > t_lo_b) & (new_t < t_hi) \
            & (t_lo_b < t_hi)
        delta_log_G = d * (new_t - old_t)
        log_alpha = torch.where(is_root_move, zero, delta_log_G)
        sign = torch.where(inner, -1.0, 1.0).to(dt)
        dk = sign[:, None] * (frac(new_t[:, None]) - frac(old_t[:, None]))
        dquad = dquad_of(k_p, dk, b)
        dlogN = torch.where(inner, -(log_pop(new_t) - log_pop(old_t)),
                            zero)
        dcoal = dquad + dlogN
        log_mh = delta_log_G + dcoal - log_alpha
        accept = in_bounds & ((log_mh >= 0.0) | (
            torch.log(torch.clamp(u_a, min=1e-30)) < log_mh))
        oh = iota_n == node[:, None]
        t = torch.where(oh & accept[:, None], new_t[:, None], t)
        k_p = torch.where(accept[:, None], k_p + dk, k_p)
        dG = dG + torch.where(accept, delta_log_G, zero)
        dC = dC + torch.where(accept, dcoal, zero)
        cnt = cnt + torch.where(n_nodes > 1, 1.0, 0.0).to(dt)

        # ---- batched cell-block-coloured displacement ----
        offset = torch.floor(sc[:, _SC_OFF] * stat.cpb)[:, None]   # (P, 1)
        own_max, child_min = slot_minmax(mut_t)
        t_par = torch.where(par_ok, gather(t, par_c), zero)
        cb_val = torch.minimum(t, child_min)
        cb0 = torch.where(c0 >= 0, gather(cb_val, c0_c), inf)
        cb1 = torch.where(c1 >= 0, gather(cb_val, c1_c), inf)
        t_lo = torch.maximum(t_par, own_max)
        t_lo = torch.where(is_leaf, torch.maximum(t_lo, t_min), t_lo)
        t_hi = torch.where(is_leaf, t_max, torch.minimum(cb0, cb1))
        movable = in_batch & (t_lo < t_hi)
        cell_now = torch.floor((t - t_lo_g) / t_step)
        in_grid = (cell_now >= 0) & (cell_now < stat.C_real)
        cell_i = cell_now.clamp(-1.0, float(stat.C_real))
        blk = torch.floor((cell_i + offset) / stat.cpb).clamp(0, n_seg - 1)
        blk_t_lo = t_lo_g + (blk * stat.cpb - offset) * t_step
        blk_t_hi = blk_t_lo + stat.cpb * t_step
        blk = blk.long()
        win_lo = torch.maximum(t_lo, blk_t_lo)
        win_hi = torch.minimum(t_hi, blk_t_hi)
        fits = movable & in_grid & (win_lo < win_hi)
        pri = torch.where(fits, u.pri[:, i, :NC], zero - 1.0)
        best = torch.full((P, n_seg), -1.0, dtype=dt, device=dev)
        best = best.scatter_reduce(1, blk, pri, "amax")
        selected = fits & (pri >= 0.0) & (pri == gather(best, blk))
        selected = selected & ~(par_ok & gather(selected, par_c))

        lam_b0 = torch.where(c0 >= 0, lam + gather(dlam, c0_c), zero)
        lam_b1 = torch.where(c1 >= 0, lam + gather(dlam, c1_c), zero)
        d = -lam + (lam_b0 + lam_b1)
        old_t = t
        new_t = bounded_exp_u(u.prop[:, i, :NC], d, win_lo,
                              torch.where(win_hi > win_lo, win_hi,
                                          win_lo + 1.0))
        new_t = torch.minimum(torch.maximum(new_t, win_lo), win_hi)
        in_bounds = selected & (new_t > win_lo) & (new_t < win_hi)
        sign = torch.where(is_leaf, 1.0, -1.0).to(dt)
        t_eff = torch.where(in_bounds, new_t, old_t)
        dk = sign[..., None] * (frac(t_eff[..., None]) - frac(old_t[..., None]))
        dquad = -torch.sum(inv_nbar_dt[:, None, :] * (
            0.5 * ((k_p[:, None, :] + dk) ** 2 - k_p[:, None, :] ** 2)
            * A[:, None, :] - b[:, None, :] * dk), -1)             # (P, NC)
        dcoal = dquad + torch.where(is_leaf, zero,
                                    -(log_pop(new_t) - log_pop(old_t)))
        delta_log_G = d * (new_t - old_t)
        lu = torch.log(torch.clamp(u.acc[:, i, :NC], min=1e-30))
        accept = in_bounds & ((dcoal >= 0.0) | (lu < dcoal))
        t = torch.where(accept, new_t, old_t)
        k_p = k_p + torch.sum(torch.where(accept[..., None], dk, zero), 1)
        dG = dG + torch.sum(torch.where(accept, delta_log_G, zero), 1)
        dC = dC + torch.sum(torch.where(accept, dcoal, zero), 1)
        cnt = cnt + torch.sum(selected.to(dt), 1)

        # ---- batched branch reform ----
        t_par = torch.where(par_ok, gather(t, par_c), zero)
        t_X = torch.where(slot_ok, gather(t, mnode_c), zero)
        t_P = torch.where(slot_ok, gather(t_par, mnode_c), zero)
        mut_in = slot_ok & gather(in_batch, mnode_c) & msingle
        uu = torch.clamp(u.ref_u[:, i, :MC], min=1e-16)
        new_mut_t = torch.where(mut_in, t_P + uu * (t_X - t_P), mut_t)
        per_slot = torch.where(mut_in, -slope * (new_mut_t - mut_t), zero)
        delta_n = torch.zeros((P, NC), dtype=dt, device=dev)
        delta_n = delta_n.scatter_add(
            1, mnode_c, torch.where(slot_ok, per_slot, zero))
        lu = torch.log(torch.clamp(u.ref_acc[:, i, :NC], min=1e-30))
        accept_n = in_batch & ((delta_n >= 0.0) | (lu < delta_n))
        accept_slot = slot_ok & gather(accept_n, mnode_c) & mut_in
        mut_t = torch.where(accept_slot, new_mut_t, mut_t)
        dG = dG + torch.sum(torch.where(accept_n, delta_n, zero), 1)
        cnt = cnt + torch.sum(in_batch.to(dt), 1)

    # the kernel's layout: the columns of one (P, 3) tensor, so that a sum
    # over P rounds alike on either
    acc = torch.stack([dG, dC, cnt], 1)
    return (t.reshape(P, 1, NC), mut_t.reshape(P, 1, MC),
            k_p.reshape(P, 1, C), acc[:, 0], acc[:, 1], acc[:, 2])


_INT_ROWS = ("par", "c0", "c1", "mnode", "mvalid", "msingle")
_F_ROWS = ("t", "mut_t", "k_p", "t_min", "t_max", "lam", "dlam", "slope", "b")
_WIDTH = {"t": "NC", "par": "NC", "c0": "NC", "c1": "NC", "t_min": "NC",
          "t_max": "NC", "lam": "NC", "dlam": "NC", "mut_t": "MC",
          "mnode": "MC", "mvalid": "MC", "msingle": "MC", "slope": "MC",
          "k_p": "C", "b": "C"}


def pad_chain(stat: ChainStatics, ctx_arrs, shared, NC=None, MC=None,
              C=None):
    """The same chain on rows padded to (NC, MC, C) with the JAX package's
    inert padding (block_pallas.pack_chain_inputs): padded nodes have no
    parent or children, padded slots are invalid, cells beyond C_real have
    k_p = b = 0 and A = nbar = 1.  Holds the kernel at shapes a run has not
    reached."""
    width = {"NC": NC or stat.NC, "MC": MC or stat.MC, "C": C or stat.C}
    fill = {"par": -1, "c0": -1, "c1": -1, "mnode": -1}
    out = dict(ctx_arrs)
    for k, w in _WIDTH.items():
        out[k] = torch.nn.functional.pad(
            ctx_arrs[k], (0, width[w] - ctx_arrs[k].shape[-1]),
            value=fill.get(k, 0))
    sh = dict(shared)
    for k in ("A", "nbar"):
        sh[k] = torch.nn.functional.pad(shared[k], (0, width["C"] - stat.C),
                                        value=1.0)
    return stat._replace(NC=width["NC"], MC=width["MC"], C=width["C"]), \
        out, sh


def sweep_chain_kernel(stat: ChainStatics, n_blocks: int, ctx_arrs, shared,
                       u: BlockUniforms):
    """The chain on the rows' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Same arguments and results as
    sweep_chain_torch."""
    dev = ctx_arrs["t"].device
    if dev.type == "cpu":
        return sweep_chain_torch(stat, n_blocks, ctx_arrs, shared, u)
    return _launch(stat, n_blocks, ctx_arrs, shared, u)


def build(stat: ChainStatics, n_knots: int = 0, dtype=None) -> int:
    """The kernel's build for ``stat``'s shapes (``n_knots``: the skygrid's
    knots, 0 for the exponential model) in ``resolve_dtype(dtype)``: 2 or
    1 uniform stages in shared memory, or 0 for the rows in a device-memory
    workspace.  Shared memory is counted in the dtype's bytes, so a float32
    part stays in shared memory up to about twice the rows."""
    fn = "delphy_sweep_chain_stages" + _cuda.suffix(resolve_dtype(dtype))
    return int(getattr(_cuda.lib(), fn)(stat.NC, stat.MC, stat.C_real,
                                        stat.cpb, n_knots))


def smem_bytes(stat: ChainStatics, n_knots: int = 0, dtype=None) -> int:
    """Shared-memory bytes a part of ``build(stat, n_knots, dtype)``."""
    sfx = _cuda.suffix(resolve_dtype(dtype))
    lib = _cuda.lib()
    if stat.pop == POP_EXP:
        return int(getattr(lib, "delphy_sweep_chain_smem_bytes" + sfx)(
            stat.NC, stat.MC, stat.C_real, stat.cpb))
    return int(getattr(lib, "delphy_sweep_chain_skygrid_smem_bytes" + sfx)(
        stat.NC, stat.MC, stat.C_real, stat.cpb, n_knots))


def entry(stat: ChainStatics, n_knots: int = 0, dtype=None) -> str:
    """The C entry point (and, without ``delphy_``, the launch-count name)
    of ``stat``'s model and build in ``resolve_dtype(dtype)``."""
    dtype = resolve_dtype(dtype)
    name = ("delphy_sweep_chain" if stat.pop == POP_EXP
            else "delphy_sweep_chain_skygrid")
    return (name + ("_global" if build(stat, n_knots, dtype) == 0 else "")
            + _cuda.suffix(dtype))


def pack_launch(stat: ChainStatics, n_blocks: int, ctx_arrs, shared,
                u: BlockUniforms) -> _cuda.Packed:
    """Check and pack the chain's inputs for ``entry(stat, K, dtype)`` (K:
    the skygrid's knots, else 0; dtype: the uniforms', which every float
    input must share); outs are (t (P,1,NC), mut_t (P,1,MC), k_p (P,1,C),
    acc (P,3)), and the global build's workspace is the scratch."""
    dev = ctx_arrs["t"].device
    dt = u.pri.dtype
    _cuda.suffix(dt)
    P = ctx_arrs["t"].shape[0]
    NC, MC, C = stat.NC, stat.MC, stat.C
    width = {"NC": NC, "MC": MC, "C": C}
    rows = {}
    for k in _INT_ROWS + _F_ROWS:
        a = ctx_arrs[k].reshape(P, -1)
        a = a.to(torch.int32) if k in _INT_ROWS else a
        rows[k] = a.contiguous()
        _cuda.require(rows[k], k, torch.int32 if k in _INT_ROWS else dt,
                      (P, width[_WIDTH[k]]), dev)
    isc = torch.stack([ctx_arrs[k].reshape(P).to(torch.int32) for k in
                       ("part_root", "is_run_root", "n_leaves", "n_nodes")],
                      1).contiguous()
    sky = stat.pop != POP_EXP
    scalars = ("t_lo", "t_step", "t_max_tip") + (
        () if sky else ("log_n0", "g", "t0", "log_min_pop"))
    fsc = torch.stack([shared[k].reshape(()) for k in scalars])
    if sky:   # the exponential model's four entries are unused
        fsc = torch.cat([fsc, fsc.new_zeros(4)])
    fsc = fsc.contiguous()
    _cuda.require(fsc, "scalars", dt, (fsc.shape[0],), dev)
    A = shared["A"].reshape(C).contiguous()
    nbar = shared["nbar"].reshape(C).contiguous()
    _cuda.require(A, "A", dt, (C,), dev)
    _cuda.require(nbar, "nbar", dt, (C,), dev)
    NB = u.pri.shape[1]
    if not 0 <= n_blocks <= NB:
        raise ValueError(f"n_blocks {n_blocks} outside the {NB} pre-generated")
    for name, X in (("pri", NC), ("prop", NC), ("acc", NC), ("ref_u", MC),
                    ("ref_acc", NC)):
        _cuda.require(getattr(u, name), name, dt, (P, NB, X), dev)
    for name, X in (("sc", SC_LANES), ("norm", 1)):
        a = getattr(u, name)
        _cuda.require(a, name, dt, (P, NB, None), dev)
        if a.shape[2] < X:
            raise ValueError(f"{name}: last axis {a.shape[2]} < {X}")
    knots = ()
    if sky:
        knots = (shared["x"].reshape(-1).contiguous(),
                 shared["gamma"].reshape(-1).contiguous())
        K = knots[0].shape[0]
        for name, a in zip(("x", "gamma"), knots):
            _cuda.require(a, name, dt, (K,), dev)
        if K < 2:
            raise ValueError(f"a skygrid needs at least 2 knots, got {K}")
    scratch = ()
    n_knots = knots[0].shape[0] if sky else 0
    if build(stat, n_knots, dt) == 0:
        stride = getattr(_cuda.lib(), "delphy_sweep_chain_workspace_bytes"
                         + _cuda.suffix(dt))(NC, MC, stat.C_real, stat.cpb,
                                             n_knots)
        scratch = (torch.empty(P * stride // dt.itemsize, dtype=dt,
                               device=dev),)
    t_o = torch.empty((P, 1, NC), dtype=dt, device=dev)
    mut_o = torch.empty((P, 1, MC), dtype=dt, device=dev)
    kp_o = torch.empty((P, 1, C), dtype=dt, device=dev)
    acc_o = torch.empty((P, 3), dtype=dt, device=dev)
    R = {k: _cuda.ptr(v) for k, v in rows.items()}
    P_ = _cuda.ptr
    args = (
        P, NC, MC, C, stat.C_real, stat.cpb, int(n_blocks),
        R["t"], R["mut_t"], R["k_p"], R["par"], R["c0"], R["c1"],
        R["t_min"], R["t_max"], R["lam"], R["dlam"], R["mnode"], R["mvalid"],
        R["msingle"], R["slope"], R["b"], P_(A), P_(nbar), P_(isc), P_(fsc),
        NB, P_(u.pri), P_(u.prop), P_(u.acc), P_(u.ref_u), P_(u.ref_acc),
        P_(u.sc), P_(u.norm), u.sc.shape[2], u.norm.shape[2],
        P_(t_o), P_(mut_o), P_(kp_o), P_(acc_o))
    if sky:
        args += (stat.pop, knots[0].shape[0], P_(knots[0]), P_(knots[1]))
    args += tuple(P_(w) for w in scratch) + (_cuda.stream_ptr(t_o.device),)
    return _cuda.Packed(args, (t_o, mut_o, kp_o, acc_o),
                        (*rows.values(), isc, fsc, A, nbar, *u, *knots),
                        scratch)


def _launch(stat: ChainStatics, n_blocks: int, ctx_arrs, shared,
            u: BlockUniforms):
    pk = pack_launch(stat, n_blocks, ctx_arrs, shared, u)
    name = entry(stat, shared["x"].numel() if stat.pop != POP_EXP else 0,
                 u.pri.dtype)
    _cuda.check(getattr(_cuda.lib(), name)(*pk.args), name)
    _cuda.count_launch(name[len("delphy_"):], pk.outs[0].shape[0])
    t_o, mut_o, kp_o, acc_o = pk.outs
    return t_o, mut_o, kp_o, acc_o[:, 0], acc_o[:, 1], acc_o[:, 2]


def pack_chain_inputs(ctx, sh, pop_params, k_p, t_p, mut_t_p, cpb: int):
    """(stat, ctx_arrs, shared) of the chain from sweep.py's per-part context
    and shared inputs, as unpadded (P, 1, X) rows; ``pop_params`` is an
    ExpPopParams or a SkygridPopParams."""
    P, n_cap = ctx.parent.shape
    m_cap = ctx.mut_node_loc.shape[1]
    C = k_p.shape[1]
    dt = t_p.dtype

    def r3(a, dtype=None):
        a = a if dtype is None else a.to(dtype)
        return a.reshape(P, 1, a.shape[-1]).contiguous()

    i32 = torch.int32
    ctx_arrs = {
        "t": r3(t_p), "mut_t": r3(mut_t_p), "k_p": r3(k_p),
        "par": r3(ctx.parent, i32),
        "c0": r3(ctx.children[:, :, 0], i32),
        "c1": r3(ctx.children[:, :, 1], i32),
        "t_min": r3(ctx.t_min, dt), "t_max": r3(ctx.t_max, dt),
        "lam": r3(ctx.lam), "dlam": r3(ctx.dlam_miss),
        "mnode": r3(ctx.mut_node_loc, i32),
        "mvalid": r3(ctx.mut_valid, i32),
        "msingle": r3(ctx.mut_single, i32),
        "slope": r3(ctx.slope), "b": r3(ctx.b),
        "part_root": ctx.part_root.to(i32),
        "is_run_root": ctx.is_run_root.to(i32),
        "n_leaves": ctx.n_leaves.to(i32),
        "n_nodes": ctx.n_nodes.to(i32),
    }
    shared = {
        "A": sh.A.reshape(1, C), "nbar": sh.popsize_bar.reshape(1, C),
        "t_lo": sh.t_lo, "t_step": sh.t_step, "t_max_tip": sh.t_max_tip}
    if isinstance(pop_params, popm.SkygridPopParams):
        model = pop_params.type
        shared.update(x=pop_params.x.contiguous(),
                      gamma=pop_params.gamma.contiguous())
    else:
        model = POP_EXP
        min_pop = pop_params.min_pop
        shared.update(
            log_n0=torch.log(pop_params.n0), g=pop_params.g,
            t0=pop_params.t0,
            log_min_pop=torch.where(
                min_pop > 0.0, torch.log(torch.clamp(min_pop, min=1e-30)),
                torch.full_like(min_pop, -math.inf)))
    stat = ChainStatics(NC=n_cap, MC=m_cap, C=C, C_real=C, cpb=cpb,
                        pop=model)
    return stat, ctx_arrs, shared
