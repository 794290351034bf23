"""A configuration's dataset, made or read by the benchmark's own frozen
code: a MAPLE file under the benchmark's folder, or a simulation at the
configuration's parameters (``simulated``: HKY, ``frozen/sim.py``;
``simulated_apobec``: the mpox model's two partitions,
``frozen/sim_apobec.py``), made once per checkout and then read back from
``benchmarks/_cache/`` (named after the configuration and a hash of its
parameters)."""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from .frozen import maple, sim, sim_apobec

CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_cache")


def load(cfg: dict, root: str) -> maple.Dataset:
    spec = cfg["dataset"]
    if spec["kind"] == "maple":
        return maple.read_maple(os.path.join(root, spec["file"]))
    if spec["kind"] in ("simulated", "simulated_apobec"):
        return _simulated(cfg["name"], spec)
    raise ValueError(f"unknown dataset kind {spec['kind']!r}")


def _simulated(name: str, spec: dict) -> maple.Dataset:
    key = hashlib.sha256(json.dumps(spec, sort_keys=True).encode())
    path = os.path.join(CACHE_DIR, f"{name}-{key.hexdigest()[:12]}.npz")
    if os.path.exists(path):
        return _read(path)
    if spec["kind"] == "simulated":
        ref, deltas, miss, dates, names = sim.simulate_dataset(
            spec["num_tips"], spec["num_sites"], mu=spec["mu"],
            kappa=spec.get("kappa", 2.0), pi=spec.get("pi", (0.25,) * 4),
            sample_window_days=spec["sample_window_days"],
            coalescent_n0=spec.get("coalescent_n0", 200.0),
            missing_fraction=spec["missing_fraction"], seed=spec["seed"])
    else:
        ref, deltas, miss, dates, names = sim_apobec.simulate_apobec_dataset(
            spec["num_tips"], spec["num_sites"], mu=spec["mu"],
            rho=spec["rho"], pi=spec["pi"],
            sample_window_days=spec["sample_window_days"],
            coalescent_n0=spec["coalescent_n0"],
            missing_fraction=spec["missing_fraction"], seed=spec["seed"])
    ds = maple.Dataset(ref_seq=np.asarray(ref, dtype=np.int8), names=names,
                       dates=dates, deltas=deltas, miss=miss)
    os.makedirs(CACHE_DIR, exist_ok=True)
    part = path + ".part"
    with open(part, "wb") as f:
        _write(f, ds)
    os.replace(part, path)
    return ds


def _flat(per_tip: list, width: int) -> np.ndarray:
    rows = [(i,) + tuple(x) for i, xs in enumerate(per_tip) for x in xs]
    return np.asarray(rows, dtype=np.int64).reshape(-1, width + 1)


def _write(f, ds: maple.Dataset) -> None:
    np.savez(f, ref=ds.ref_seq, names=np.asarray(ds.names),
             dates=np.asarray(ds.dates, dtype=np.float64),
             deltas=_flat(ds.deltas, 2), miss=_flat(ds.miss, 2))


def _unflat(rows: np.ndarray, T: int) -> list:
    out = [[] for _ in range(T)]
    for i, a, b in rows.tolist():
        out[i].append((a, b))
    return out


def _read(path: str) -> maple.Dataset:
    with np.load(path) as z:
        names = [str(n) for n in z["names"]]
        T = len(names)
        return maple.Dataset(
            ref_seq=z["ref"].astype(np.int8), names=names,
            dates=[tuple(d) for d in z["dates"].tolist()],
            deltas=_unflat(z["deltas"], T), miss=_unflat(z["miss"], T))
