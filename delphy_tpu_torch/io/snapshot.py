"""Run snapshots: save/resume of the complete MCMC state (port of
``delphy_tpu/io/snapshot.py``).

Functional counterpart of the reference's .dphy stream (core/delphy_output.
{h,cpp}, doc/dphy_file_format.md): the full EMAT (ref seq, node arrays,
mutation pool, missation tables), every model parameter and prior
hyperparameter, the run's adaptive state and both random generators:
enough to reconstruct a Run exactly, so a resumed run continues the
trajectory of the one that was saved.  Serialization is an .npz container
plus a JSON metadata blob.

The ``torch.Generator``'s state is a byte tensor whose layout differs
between the CPU and the CUDA generator, so the snapshot records which device
type wrote it, and ``load_run`` refuses to load one into the other.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .. import DEFAULT_DEVICE, resolve_device
from .. import pop as popm
from ..convert import from_dict, to_numpy
from ..evo import EvoParams
from ..mcmc.global_moves import PriorConfig
from ..parallel.partmaps import PartMaps
from ..run import Run
from ..state import TreeState, unpack_state

MAGIC = "delphy-tpu-torch-snapshot"
VERSION = 1


def save_run(run, path):
    # settle in-flight dispatches so the adaptive feedback state
    # (_per_block_rate, attempted counts) is final before serialization
    run._drain_inflight(block=True)
    arrays = {}
    if isinstance(run.pop, popm.SkygridPopParams):
        pop_meta = {"model": "skygrid", "type": int(run.pop.type)}
        pop = {k: getattr(run.pop, k).detach().cpu().numpy()
               for k in ("x", "gamma", "tau")}
    else:
        pop_meta = {"model": "exp"}
        pop = to_numpy(run.pop)
    # pm was built with host RNG draws that cannot be replayed, so it is
    # serialized outright
    for prefix, fields in (("ts", to_numpy(run.ts)), ("pm", to_numpy(run.pm)),
                           ("evo", to_numpy(run.evo)), ("pop", pop)):
        for k, v in fields.items():
            arrays[f"{prefix}_{k}"] = v
    arrays["gen_state"] = run.gen.get_state().cpu().numpy()

    meta = {
        "magic": MAGIC,
        "version": VERSION,
        "step": run.step,
        "names": run.names,
        "pop": pop_meta,
        "hyp": dataclasses.asdict(run.hyp),
        "num_cells": run.num_cells,
        "local_moves_per_global_move": run.local_moves_per_global_move,
        "topology_moves_enabled": run.topology_moves_enabled,
        "t_max_tip": run.t_max_tip,
        "host_rng_state": _rng_state_to_json(run.host_rng),
        "gen_device_type": run.device.type,
        "driver": {
            "device_partitions": run.device_partitions,
            "topology_partitions": run.topology_partitions,
            "topology_burst_chunks": run.topology_burst_chunks,
            "mpox_hack": run.mpox_hack,
            "mut_capacity": run.mut_capacity,
            "miss_capacity": run.miss_capacity,
            "fs_capacity": run.fs_capacity,
            "n_cap_sticky": run._n_cap_sticky,
            "m_cap_sticky": run._m_cap_sticky,
            "P_sticky": run._P_sticky,
            "per_block_rate": run._per_block_rate,
            "topo_debt": run._topo_debt,
            "boundaries_since_repart": run._boundaries_since_repart,
            # the stencil of pm: the overlapped driver cuts the host tree
            # with it
            "last_cuts": [int(c) for c in run._last_cuts],
            "local_moves_attempted": run.local_moves_attempted,
            "topology_accepted": run.topology_accepted,
            "topology_proposed": run.topology_proposed,
            "dispatch_count": run.dispatch_count,
            "burst_count": run.burst_count,
        },
    }
    arrays["_meta_json"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def read_snapshot(path, magic: str, max_version: int):
    """(meta, {name: array}) of an .npz snapshot with the given magic."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["_meta_json"]).decode("utf-8"))
        if meta.get("magic") != magic:
            raise ValueError(f"{path}: not a {magic} file "
                             f"(magic {meta.get('magic')!r})")
        if meta["version"] > max_version:
            raise ValueError(f"{path}: snapshot version {meta['version']} is "
                             f"newer than this reader ({max_version})")
        data = {k: z[k] for k in z.files if k != "_meta_json"}
    return meta, data


def _group(data: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in data.items()
            if k.startswith(prefix)}


def restore_run(meta: dict, data: dict, device, gen_seed: int = 0):
    """A Run in the state of a parsed snapshot, generators apart: tree,
    partition maps, parameters, adaptive scalars and the host generator.  The
    run's ``torch.Generator`` is seeded with ``gen_seed``."""
    hyp = PriorConfig(**meta["hyp"])
    drv = meta["driver"]
    model = meta["pop"]["model"]
    sky = ({"skygrid_num_parameters": len(data["pop_gamma"]),
            "skygrid_type": meta["pop"]["type"]} if model == "skygrid"
           else {})
    tree = unpack_state(TreeState(**_group(data, "ts_")), names=meta["names"])
    run = Run(tree, seed=gen_seed, hyp=hyp, num_cells=meta["num_cells"],
              local_moves_per_global_move=meta["local_moves_per_global_move"],
              topology_moves_enabled=meta["topology_moves_enabled"],
              topology_partitions=drv["topology_partitions"],
              device_partitions=drv["device_partitions"], device=device,
              pop_model=model, mpox_hack=drv.get("mpox_hack", False), **sky)
    # the exact adaptive state: the packed arrays, partition maps and
    # feedback scalars as of the save; bit-identical resume depends on every
    # one of these (they steer n_blocks, kernel shapes and the repartition
    # cadence)
    run.mut_capacity = drv["mut_capacity"]
    run.miss_capacity = drv["miss_capacity"]
    run.fs_capacity = drv["fs_capacity"]
    dev = run.device
    run.ts = from_dict(TreeState, _group(data, "ts_"), dev)
    run.pm = from_dict(PartMaps, _group(data, "pm_"), dev)
    run.evo = from_dict(EvoParams, _group(data, "evo_"), dev)
    if model == "skygrid":
        p = {k: torch.as_tensor(np.asarray(v, np.float64), device=dev)
             for k, v in _group(data, "pop_").items()}
        run.pop = popm.SkygridPopParams(x=p["x"], gamma=p["gamma"],
                                        type=meta["pop"]["type"],
                                        tau=p["tau"])
    else:
        run.pop = from_dict(popm.ExpPopParams, _group(data, "pop_"), dev)
    run._fused_bundle = None   # ts/evo/pop replaced above
    run.topology_burst_chunks = drv["topology_burst_chunks"]
    run._n_cap_sticky = drv["n_cap_sticky"]
    run._m_cap_sticky = drv["m_cap_sticky"]
    # the JAX package's snapshot has no P_sticky: its width is pm's part axis
    run._P_sticky = drv.get("P_sticky", int(run.pm.node_map.shape[0]))
    run._per_block_rate = drv["per_block_rate"]
    run._topo_debt = drv["topo_debt"]
    run._boundaries_since_repart = drv["boundaries_since_repart"]
    if "last_cuts" in drv:
        run._last_cuts = list(drv["last_cuts"])
    run.local_moves_attempted = drv["local_moves_attempted"]
    run.topology_accepted = drv["topology_accepted"]
    run.topology_proposed = drv["topology_proposed"]
    run.dispatch_count = drv.get("dispatch_count", 0)
    run.burst_count = drv.get("burst_count", 0)
    run.step = meta["step"]
    _rng_state_from_json(run.host_rng, meta["host_rng_state"])
    return run


def load_run(path, device=DEFAULT_DEVICE):
    """The Run saved at ``path``, on ``device`` (CUDA unless the caller asks
    for the CPU).  The device type must be the one that wrote the snapshot:
    a generator's state cannot cross between the CPU and CUDA."""
    device = resolve_device(device)
    meta, data = read_snapshot(path, MAGIC, VERSION)
    if meta["gen_device_type"] != device.type:
        raise ValueError(
            f"{path}: snapshot written on a {meta['gen_device_type']} device "
            f"cannot resume on {device.type}: the torch.Generator state does "
            f"not carry between device types")
    run = restore_run(meta, data, device)
    run.gen.set_state(torch.from_numpy(data["gen_state"].copy()))
    return run


def _rng_state_to_json(rng: np.random.Generator):
    return json.loads(json.dumps(rng.bit_generator.state, default=int))


def _rng_state_from_json(rng: np.random.Generator, st):
    if rng.bit_generator.state["bit_generator"] != st["bit_generator"]:
        raise ValueError(f"snapshot's host generator is a "
                         f"{st['bit_generator']}, not a "
                         f"{rng.bit_generator.state['bit_generator']}")

    def fix(d):   # numpy expects exact ints
        return {k: (fix(v) if isinstance(v, dict) else
                    int(v) if isinstance(v, (int, float))
                    and not isinstance(v, bool) else v)
                for k, v in d.items()}
    rng.bit_generator.state = fix(st)
