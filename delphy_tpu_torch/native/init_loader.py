"""ctypes loader for the native initial-tree pipeline (init_native.cpp).

Same compile-on-first-use convention as the topology kernel: the .so is
built into the package's ``_build/`` directory and cached by source hash; if
the toolchain is missing the caller falls back to the Python pipeline
(DELPHY_TPU_NATIVE=0 forces that)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "init_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
_LIB = None
_LOCK = threading.Lock()
_FAILED = False

i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
i8p = np.ctypeslib.ndpointer(np.int8, flags="C")
f64p = np.ctypeslib.ndpointer(np.float64, flags="C")


def _build() -> str | None:
    flags = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"_init_native_{tag}.so")
    if os.path.exists(so):
        return so
    tmp = so + f".tmp{os.getpid()}"
    cmd = ["g++", *flags, _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
        return so
    except subprocess.CalledProcessError as e:
        # loud: a silent fallback here means the O(T^2) Python guide tree
        # takes over and 10k+-tip init quietly becomes ~100x slower
        import sys
        sys.stderr.write(
            "[delphy_tpu_torch] WARNING: native init kernel failed to compile; "
            "falling back to the Python pipeline.\n"
            + e.stderr.decode(errors="replace")[-2000:] + "\n")
        return None
    except Exception:
        return None


def _load():
    global _LIB, _FAILED
    if _LIB is not None or _FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _FAILED:
            return _LIB
        if os.environ.get("DELPHY_TPU_NATIVE", "1") == "0":
            _FAILED = True
            return None
        so = _build()
        if so is None:
            _FAILED = True
            return None
        lib = ctypes.CDLL(so)
        fn = lib.delphy_build_initial_topology
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.c_int32, ctypes.c_int32, i8p,
            i64p, i32p, i8p,
            i64p, i32p, i32p,
            f64p,
            ctypes.c_uint64, ctypes.c_int32,
            i32p, i32p,
            ctypes.c_int64, i64p, i32p, i8p, i8p,
            ctypes.c_int64, i64p, i32p, i8p,
            f64p, f64p, f64p,
        ]
        _LIB = lib
        return _LIB


def native_init_available() -> bool:
    return _load() is not None


def build_initial_topology_native(ref_seq, tip_deltas, tip_miss_intervals,
                                  tip_dates, seed: int = 0,
                                  refine_passes: int = 10):
    """Run the native guide-tree + nearest-first rebuild + spr_refine + OLS
    rooting pipeline.  Returns (parent, children[N,2], root, mut_off,
    mut_site, mut_from, mut_to, root_deltas{site: state}, mu_per_day,
    t_mrca, r2) or None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    T = len(tip_deltas)
    L = len(ref_seq)
    ref = np.ascontiguousarray(ref_seq, dtype=np.int8)

    d_off = np.zeros(T + 1, np.int64)
    for i, d in enumerate(tip_deltas):
        d_off[i + 1] = d_off[i] + len(d)
    nd = int(d_off[-1])
    d_site = np.empty(nd, np.int32)
    d_state = np.empty(nd, np.int8)
    k = 0
    for d in tip_deltas:
        for (s, to) in sorted(d):
            d_site[k] = s
            d_state[k] = to
            k += 1

    m_off = np.zeros(T + 1, np.int64)
    for i, m in enumerate(tip_miss_intervals):
        m_off[i + 1] = m_off[i] + len(m)
    nm = int(m_off[-1])
    m_start = np.empty(max(nm, 1), np.int32)
    m_end = np.empty(max(nm, 1), np.int32)
    k = 0
    for m in tip_miss_intervals:
        for (s, e) in sorted(m):
            m_start[k] = s
            m_end[k] = e
            k += 1

    date_mid = np.array([(lo + hi) / 2.0 for (lo, hi) in tip_dates],
                        np.float64)

    N = 2 * T - 1
    parent = np.empty(N, np.int32)
    children = np.empty(N * 2, np.int32)
    mut_cap = max(int(2.5 * nd) + 4 * T + 1024, 4096)
    rd_cap = max(4 * L // 8, 1024)
    mu = np.zeros(1)
    t_mrca = np.zeros(1)
    r2 = np.zeros(1)
    while True:
        mut_off = np.zeros(N + 1, np.int64)
        mut_site = np.empty(mut_cap, np.int32)
        mut_from = np.empty(mut_cap, np.int8)
        mut_to = np.empty(mut_cap, np.int8)
        rd_n = np.zeros(1, np.int64)
        rd_site = np.empty(rd_cap, np.int32)
        rd_state = np.empty(rd_cap, np.int8)
        rc = lib.delphy_build_initial_topology(
            T, L, ref, d_off, d_site, d_state, m_off, m_start, m_end,
            date_mid, np.uint64(seed), refine_passes,
            parent, children, mut_cap, mut_off, mut_site, mut_from, mut_to,
            rd_cap, rd_n, rd_site, rd_state, mu, t_mrca, r2)
        if rc >= 0:
            total = int(rc)
            break
        if rc <= -1000:
            mut_cap = int(-rc - 1000) + 1024
            continue
        if rc == -3:
            rd_cap *= 4
            continue
        return None
    nrd = int(rd_n[0])
    root_deltas = {int(rd_site[i]): int(rd_state[i]) for i in range(nrd)}
    return (parent, children.reshape(N, 2), N - 1, mut_off,
            mut_site[:total], mut_from[:total], mut_to[:total],
            root_deltas, float(mu[0]), float(t_mrca[0]), float(r2[0]))
