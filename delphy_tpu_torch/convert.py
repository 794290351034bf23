"""Convert state and parameters between the JAX package and the port.

The JAX side is handed over as NamedTuples whose leaves are numpy (or any
array ``np.asarray`` accepts); fields are matched by name, so a
``delphy_tpu`` ``TreeState``, ``EvoParams`` (one partition or the mpox
hack's two), ``ExpPopParams`` or ``PartMaps`` converts into the port's class
of the same name, and ``skygrid_pop_to_torch`` converts a
``SkygridPopParams`` (a record with a static ``type``).  ``to_numpy`` goes
back: it returns a ``{field: numpy array}`` dict from which the JAX class is
rebuilt with ``Cls(**d)``.  ``load_jax_snapshot`` carries a whole run across: it
reads a snapshot file written by the JAX package's ``io.snapshot.save_run``
into a port ``Run``; ``packed_tree_to_torch`` carries a packed tree of the
device SPR modules (a dict).  Float leaves keep their precision (float32
from a JAX run under ``DELPHY_TPU_F32``, float64 otherwise) unless a
``dtype`` is given.  This module imports no jax.
"""

from __future__ import annotations

import numpy as np
import torch

from . import DEFAULT_DEVICE, resolve_device
from .evo import EvoParams
from .parallel.partmaps import PartMaps
from .pop import ExpPopParams, SkygridPopParams
from .state import TreeState


def float_dtype_of(a) -> torch.dtype:
    """The port's float dtype for a floating numpy array: float32 stays
    float32, any other float becomes float64."""
    return torch.float32 if np.asarray(a).dtype == np.float32 \
        else torch.float64


def leaf_to_torch(x, device, dtype=None) -> torch.Tensor:
    a = np.asarray(x)
    if np.issubdtype(a.dtype, np.floating):
        dtype = dtype or float_dtype_of(a)
        # rounded on the host: no float64 copy reaches a float32 run
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        return torch.as_tensor(a.astype(np.float64).astype(np_dtype),
                               device=device)
    return torch.as_tensor(a.copy(), device=device)


def from_dict(cls, fields: dict, device=DEFAULT_DEVICE, dtype=None):
    """Instance of the port's NamedTuple ``cls`` from ``{field: array}``;
    float leaves in ``dtype``, by default their own precision."""
    device = resolve_device(device)
    return cls(**{f: leaf_to_torch(fields[f], device, dtype)
                  for f in cls._fields})


def from_numpy(cls, obj, device=DEFAULT_DEVICE, dtype=None):
    """Instance of the port's NamedTuple ``cls`` from an object with the
    same field names (numpy or jax leaves)."""
    return from_dict(cls, {f: getattr(obj, f) for f in cls._fields}, device,
                     dtype)


def tree_state_to_torch(ts, device=DEFAULT_DEVICE, dtype=None) -> TreeState:
    return from_numpy(TreeState, ts, device, dtype)


def evo_params_to_torch(evo, device=DEFAULT_DEVICE, dtype=None) -> EvoParams:
    return from_numpy(EvoParams, evo, device, dtype)


def exp_pop_to_torch(pop, device=DEFAULT_DEVICE, dtype=None) -> ExpPopParams:
    return from_numpy(ExpPopParams, pop, device, dtype)


def skygrid_pop_to_torch(pop, device=DEFAULT_DEVICE,
                         dtype=None) -> SkygridPopParams:
    device = resolve_device(device)
    return SkygridPopParams(
        x=leaf_to_torch(pop.x, device, dtype),
        gamma=leaf_to_torch(pop.gamma, device, dtype), type=int(pop.type),
        tau=leaf_to_torch(pop.tau, device, dtype))


def part_maps_to_torch(pm, device=DEFAULT_DEVICE, dtype=None) -> PartMaps:
    return from_numpy(PartMaps, pm, device, dtype)


def packed_tree_to_torch(p_np: dict, device=DEFAULT_DEVICE,
                         dtype=None) -> dict:
    """The port's packed tree (``ops/spr_move.pack_tree``,
    ``ops/spr_miss.pack_tree_miss``) from a JAX packed dict of the same
    keys (numpy or jax leaves): integers as int64, floats in ``dtype`` (by
    default their own precision), the root a one-element tensor."""
    device = resolve_device(device)
    out = {k: leaf_to_torch(v, device, dtype) for k, v in p_np.items()}
    out = {k: v if v.is_floating_point() else v.long()
           for k, v in out.items()}
    out["root"] = out["root"].reshape(1)
    return out


def to_numpy(obj) -> dict:
    """``{field: numpy array}`` of a port NamedTuple of tensors."""
    return {f: getattr(obj, f).detach().cpu().numpy()
            if isinstance(getattr(obj, f), torch.Tensor)
            else np.asarray(getattr(obj, f)) for f in obj._fields}


# the JAX package's snapshot format (its io/snapshot.py MAGIC and VERSION)
JAX_SNAPSHOT_MAGIC = "delphy-tpu-snapshot"
JAX_SNAPSHOT_VERSION = 3


def load_jax_snapshot(path, gen_seed: int = 0, device=DEFAULT_DEVICE):
    """A port ``Run`` in the state of a snapshot written by the JAX package:
    tree state, partition maps, ``evo``, ``pop`` (exponential or skygrid),
    the host generator and the run's scalars, with the snapshot's prior
    configuration (site-rate heterogeneity included) and mpox flag, in the
    snapshot's precision (a run saved under ``DELPHY_TPU_F32`` holds float32
    arrays and loads as a float32 run).  The JAX PRNG key has no
    counterpart in a ``torch.Generator``, so the run's generator is seeded
    with ``gen_seed``: the run continues from the same state on a
    trajectory of its own."""
    from .io.snapshot import read_snapshot, restore_run   # it imports us
    meta, data = read_snapshot(path, JAX_SNAPSHOT_MAGIC, JAX_SNAPSHOT_VERSION)
    if "driver" not in meta:
        raise ValueError(f"{path}: snapshot predates version 3 and lacks the "
                         f"run's adaptive state")
    return restore_run(meta, data, resolve_device(device), gen_seed=gen_seed)
