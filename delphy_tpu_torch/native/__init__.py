"""ctypes loader + FlatTree<->CSR marshalling for the native topology kernel.

The C++ kernel (topo_native.cpp) is a port of this repo's validated Python
topology machinery (delphy_tpu/topo/).  It is compiled on first use with the
system g++ into the package's ``_build/`` directory and cached by source hash;
if the toolchain is unavailable (or DELPHY_TPU_NATIVE=0) the callers fall
back to the Python mixer (``topo/mixer.py`` ``TopologyMixer``).  One call
runs a whole burst and releases the GIL, so per-partition bursts run on a
plain thread pool."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "topo_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
_LIB = None
_LIB_LOCK = threading.Lock()
_BUILD_FAILED = False

i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
i8p = np.ctypeslib.ndpointer(np.int8, flags="C")
u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
f64p = np.ctypeslib.ndpointer(np.float64, flags="C")


def _build() -> str | None:
    flags = ["-O3", "-g", "-march=native", "-std=c++17", "-shared", "-fPIC"]
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"_topo_native_{tag}.so")
    if os.path.exists(so):
        return so
    tmp = so + f".tmp{os.getpid()}"
    cmd = ["g++", *flags, _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
        return so
    except subprocess.CalledProcessError as e:
        # loud: silently losing the native kernel reroutes topology bursts
        # to the much slower Python mixer
        import sys
        sys.stderr.write(
            "[delphy_tpu_torch] WARNING: native topology kernel failed to "
            "compile; falling back to the Python mixer.\n"
            + e.stderr.decode(errors="replace")[-2000:] + "\n")
        return None
    except Exception:
        return None


def _load():
    global _LIB, _BUILD_FAILED
    if _LIB is not None or _BUILD_FAILED:
        return _LIB
    with _LIB_LOCK:
        if _LIB is not None or _BUILD_FAILED:
            return _LIB
        if os.environ.get("DELPHY_TPU_NATIVE", "1") == "0":
            _BUILD_FAILED = True
            return None
        so = _build()
        if so is None:
            _BUILD_FAILED = True
            return None
        lib = ctypes.CDLL(so)
        fn = lib.delphy_run_topo_burst
        fn.restype = ctypes.c_int32
        fn.argtypes = [
            # tree in
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            i32p, i32p, f64p, f64p, f64p, u8p,
            i64p, i32p, i8p, i8p, f64p,
            i64p, i32p, i32p,
            i64p, i32p, i8p,
            # evo
            ctypes.c_double, f64p, ctypes.c_int32, f64p, i32p, f64p,
            # pop
            ctypes.c_int32, f64p,
            # coal
            ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
            f64p, f64p, f64p, f64p, i32p,
            # burst
            ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64,
            # tree out
            i32p, i32p, f64p, i32p,
            i64p, i32p, i8p, i8p, f64p, ctypes.c_int64,
            i64p, i32p, i32p, ctypes.c_int64,
            i64p, i32p, i8p, ctypes.c_int64,
            f64p,
        ]
        # incomplete-gamma test exports (safe_gamma_math analogue)
        lib.delphy_gamma_q.restype = ctypes.c_double
        lib.delphy_gamma_q.argtypes = [ctypes.c_double, ctypes.c_double]
        lib.delphy_gamma_q_inv.restype = ctypes.c_double
        lib.delphy_gamma_q_inv.argtypes = [ctypes.c_double, ctypes.c_double]
        # best-of-K partition stencil (twin of topo/partition.py:42-77)
        lib.delphy_best_stencil.restype = ctypes.c_int32
        lib.delphy_best_stencil.argtypes = [
            ctypes.c_int32, ctypes.c_int32, i32p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
            i32p, i64p, i32p,
        ]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return _load() is not None


def best_stencil_native(tree, num_parts: int, rng: np.random.Generator,
                        tries: int = 1):
    """Best-of-`tries` randomized greedy partition stencil from the native
    kernel (twin of topo/partition.py's generator; selection as in
    parallel/partmaps.py).  Returns (cut_points, sizes) where sizes lists
    cut parts in cut order then the residual root part, or None when the
    native kernel is unavailable.  Consumes one draw from `rng` (the seed),
    so same rng state => same stencil.  Note: the native and Python
    generators produce different (equally valid) stencil streams from the
    same rng state, and a kernel-level failure (r != 0, never observed)
    would hand the Python fallback a post-draw rng — environments with and
    without the native kernel are not stencil-for-stencil reproducible,
    by design (determinism holds within an environment)."""
    lib = _load()
    if lib is None or num_parts <= 1:
        return None
    children = np.ascontiguousarray(tree.children, dtype=np.int32)
    out_cuts = np.empty(num_parts, np.int32)
    out_sizes = np.empty(num_parts, np.int64)
    n_cuts = np.zeros(1, np.int32)
    r = lib.delphy_best_stencil(
        np.int32(tree.num_nodes), np.int32(tree.root), children,
        np.int32(num_parts), np.int32(max(1, tries)),
        np.uint64(rng.integers(2 ** 63)), out_cuts, out_sizes, n_cuts)
    if r != 0:
        return None
    k = int(n_cuts[0])
    return [int(x) for x in out_cuts[:k]], [int(s) for s in out_sizes[:k + 1]]


def native_gamma_q(a: float, x: float) -> float:
    """Regularized upper incomplete gamma Q(a,x) from the native kernel
    (test surface; core/safe_gamma_math.h:19-44 analogue)."""
    lib = _load()
    return float(lib.delphy_gamma_q(a, x))


def native_gamma_q_inv(a: float, q: float) -> float:
    lib = _load()
    return float(lib.delphy_gamma_q_inv(a, q))


def _tree_to_csr(tree):
    N = tree.num_nodes
    parent = np.ascontiguousarray(tree.parent, dtype=np.int32)
    children = np.ascontiguousarray(tree.children, dtype=np.int32).reshape(-1)
    t = np.ascontiguousarray(tree.t, dtype=np.float64)
    t_min = np.ascontiguousarray(tree.t_min, dtype=np.float64)
    t_max = np.ascontiguousarray(tree.t_max, dtype=np.float64)

    mut_off = np.zeros(N + 1, dtype=np.int64)
    for n in range(N):
        mut_off[n + 1] = mut_off[n] + len(tree.mutations[n])
    M = int(mut_off[-1])
    mut_site = np.empty(M, dtype=np.int32)
    mut_from = np.empty(M, dtype=np.int8)
    mut_to = np.empty(M, dtype=np.int8)
    mut_t = np.empty(M, dtype=np.float64)
    i = 0
    for n in range(N):
        for m in tree.mutations[n]:
            mut_site[i] = m.site
            mut_from[i] = m.from_
            mut_to[i] = m.to
            mut_t[i] = m.t
            i += 1

    miss_off = np.zeros(N + 1, dtype=np.int64)
    for n in range(N):
        miss_off[n + 1] = miss_off[n] + len(tree.miss_intervals[n])
    I = int(miss_off[-1])
    miss_s = np.empty(I, dtype=np.int32)
    miss_e = np.empty(I, dtype=np.int32)
    i = 0
    for n in range(N):
        for (s, e) in tree.miss_intervals[n]:
            miss_s[i] = s
            miss_e[i] = e
            i += 1

    fs_off = np.zeros(N + 1, dtype=np.int64)
    for n in range(N):
        fs_off[n + 1] = fs_off[n] + len(tree.miss_from_states[n])
    F = int(fs_off[-1])
    fs_site = np.empty(F, dtype=np.int32)
    fs_state = np.empty(F, dtype=np.int8)
    i = 0
    for n in range(N):
        for l, s in sorted(tree.miss_from_states[n].items()):
            fs_site[i] = l
            fs_state[i] = s
            i += 1

    return (parent, children, t, t_min, t_max, mut_off, mut_site, mut_from,
            mut_to, mut_t, miss_off, miss_s, miss_e, fs_off, fs_site, fs_state)


def _csr_to_tree(tree, out_parent, out_children, out_t, out_root,
                 mut_off, mut_site, mut_from, mut_to, mut_t,
                 miss_off, miss_s, miss_e, fs_off, fs_site, fs_state):
    """Write the kernel's outputs back into the host FlatTree in place."""
    from ..phylo import Mutation
    N = tree.num_nodes
    tree.parent[:] = out_parent
    tree.children[:] = out_children.reshape(N, 2)
    tree.t[:] = out_t
    tree.root = int(out_root[0])
    for n in range(N):
        tree.mutations[n] = [
            Mutation(site=int(mut_site[i]), from_=int(mut_from[i]),
                     to=int(mut_to[i]), t=float(mut_t[i]))
            for i in range(int(mut_off[n]), int(mut_off[n + 1]))]
        tree.miss_intervals[n] = [
            (int(miss_s[i]), int(miss_e[i]))
            for i in range(int(miss_off[n]), int(miss_off[n + 1]))]
        tree.miss_from_states[n] = {
            int(fs_site[i]): int(fs_state[i])
            for i in range(int(fs_off[n]), int(fs_off[n + 1]))}


def _pop_spec(host_pop):
    """Pack a host pop adapter (mixer.py HostExpPop / HostSkygridPop)."""
    if hasattr(host_pop, "n0"):
        return 0, np.array([host_pop.t0, host_pop.n0, host_pop.g,
                            host_pop.min_pop], dtype=np.float64)
    x = np.asarray(host_pop.x, dtype=np.float64)
    g = np.asarray(host_pop.gamma, dtype=np.float64)
    par = np.concatenate([[float(host_pop.type), float(len(x))], x, g])
    return 1, np.ascontiguousarray(par)


def run_burst_native(tree, n_moves: int, mu, nu, q, pi, host_pop,
                     seed: int, can_change_root: bool,
                     num_cells: int = 400, t_max_tip: float = 0.0,
                     vsc=None, part=None, q_tab=None):
    """Run a topology burst in the native kernel, mutating `tree` in place.

    Returns (delta_log_G, delta_log_coal, n_accepted, n_proposed) or None if
    the native path is unavailable/failed (caller falls back to Python)."""
    lib = _load()
    if lib is None:
        return None
    N = tree.num_nodes
    L = tree.num_sites
    (parent, children, t, t_min, t_max, mut_off, mut_site, mut_from, mut_to,
     mut_t, miss_off, miss_s, miss_e, fs_off, fs_site, fs_state) = \
        _tree_to_csr(tree)
    ref_seq = np.ascontiguousarray(tree.ref_seq, dtype=np.uint8)
    nu = np.ascontiguousarray(nu, dtype=np.float64)
    if q_tab is None:
        q_tab = np.asarray(q, dtype=np.float64)[None]
    q_tab = np.ascontiguousarray(np.asarray(q_tab, dtype=np.float64))
    P = q_tab.shape[0]
    q_flat = np.ascontiguousarray(q_tab.reshape(-1))
    if part is None:
        part = np.zeros(L, dtype=np.int32)
    part = np.ascontiguousarray(part, dtype=np.int32)
    pi = np.ascontiguousarray(pi, dtype=np.float64)
    pop_kind, pop_par = _pop_spec(host_pop)

    if vsc is not None:
        coal_mode = 1
        v_t_ref, v_t_step = float(vsc.t_ref), float(vsc.t_step)
        v_kbp = np.ascontiguousarray(vsc.k_bar_p, dtype=np.float64)
        v_ktbp = np.ascontiguousarray(vsc.k_twiddle_bar_p, dtype=np.float64)
        v_ktb = np.ascontiguousarray(vsc.k_twiddle_bar, dtype=np.float64)
        v_psb = np.ascontiguousarray(vsc.popsize_bar, dtype=np.float64)
        v_na = np.ascontiguousarray(vsc.num_active_parts, dtype=np.int32)
        v_C, v_kp_C = len(v_ktb), len(v_kbp)
    else:
        coal_mode = 0
        v_t_ref = v_t_step = 0.0
        v_kbp = v_ktbp = v_ktb = v_psb = np.zeros(1, dtype=np.float64)
        v_na = np.zeros(1, dtype=np.int32)
        v_C = v_kp_C = 1

    n_mut_in = int(mut_off[-1])
    mut_cap = max(2 * n_mut_in + 4096, 8192)
    miss_cap = max(4 * int(miss_off[-1]) + 4096, 8192)
    fs_cap = max(4 * int(fs_off[-1]) + 4096, 8192)
    stats = np.zeros(4, dtype=np.float64)

    for _attempt in range(3):
        out_parent = np.empty(N, dtype=np.int32)
        out_children = np.empty(2 * N, dtype=np.int32)
        out_t = np.empty(N, dtype=np.float64)
        out_root = np.zeros(1, dtype=np.int32)
        out_mut_off = np.zeros(N + 1, dtype=np.int64)
        out_mut_site = np.empty(mut_cap, dtype=np.int32)
        out_mut_from = np.empty(mut_cap, dtype=np.int8)
        out_mut_to = np.empty(mut_cap, dtype=np.int8)
        out_mut_t = np.empty(mut_cap, dtype=np.float64)
        out_miss_off = np.zeros(N + 1, dtype=np.int64)
        out_miss_s = np.empty(miss_cap, dtype=np.int32)
        out_miss_e = np.empty(miss_cap, dtype=np.int32)
        out_fs_off = np.zeros(N + 1, dtype=np.int64)
        out_fs_site = np.empty(fs_cap, dtype=np.int32)
        out_fs_state = np.empty(fs_cap, dtype=np.int8)

        rc = lib.delphy_run_topo_burst(
            N, tree.num_tips, L, tree.root,
            parent, children, t, t_min, t_max, ref_seq,
            mut_off, mut_site, mut_from, mut_to, mut_t,
            miss_off, miss_s, miss_e, fs_off, fs_site, fs_state,
            float(mu), nu, P, q_flat, part, pi,
            pop_kind, pop_par,
            coal_mode, num_cells, float(t_max_tip),
            v_t_ref, v_t_step, v_C, v_kp_C, v_kbp, v_ktbp, v_ktb, v_psb, v_na,
            1 if can_change_root else 0, int(n_moves), int(seed) & (2**64 - 1),
            out_parent, out_children, out_t, out_root,
            out_mut_off, out_mut_site, out_mut_from, out_mut_to, out_mut_t,
            mut_cap,
            out_miss_off, out_miss_s, out_miss_e, miss_cap,
            out_fs_off, out_fs_site, out_fs_state, fs_cap,
            stats)
        if rc == 0:
            _csr_to_tree(tree, out_parent, out_children, out_t, out_root,
                         out_mut_off, out_mut_site, out_mut_from, out_mut_to,
                         out_mut_t, out_miss_off, out_miss_s, out_miss_e,
                         out_fs_off, out_fs_site, out_fs_state)
            return (float(stats[0]), float(stats[1]), int(stats[2]),
                    int(stats[3]))
        if rc == -2:
            mut_cap *= 4
            miss_cap *= 4
            fs_cap *= 4
            continue
        return None
    return None
