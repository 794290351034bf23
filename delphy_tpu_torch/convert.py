"""Convert state and parameters between the JAX package and the port.

The JAX side is handed over as NamedTuples whose leaves are numpy (or any
array ``np.asarray`` accepts); fields are matched by name, so a
``delphy_tpu`` ``TreeState``, ``EvoParams``, ``ExpPopParams`` or ``PartMaps``
converts into the port's class of the same name.  ``to_numpy`` goes back: it
returns a ``{field: numpy array}`` dict from which the JAX class is rebuilt
with ``Cls(**d)``.  ``load_jax_snapshot`` carries a whole run across: it
reads a snapshot file written by the JAX package's ``io.snapshot.save_run``
into a port ``Run``.  This module imports no jax.
"""

from __future__ import annotations

import numpy as np
import torch

from . import DEFAULT_DEVICE, DTYPE, resolve_device
from .evo import EvoParams
from .parallel.partmaps import PartMaps
from .pop import ExpPopParams
from .state import TreeState


def _leaf_to_torch(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(a.astype(np.float64), dtype=DTYPE,
                               device=device)
    return torch.as_tensor(a.copy(), device=device)


def from_dict(cls, fields: dict, device=DEFAULT_DEVICE):
    """Instance of the port's NamedTuple ``cls`` from ``{field: array}``."""
    device = resolve_device(device)
    return cls(**{f: _leaf_to_torch(fields[f], device) for f in cls._fields})


def from_numpy(cls, obj, device=DEFAULT_DEVICE):
    """Instance of the port's NamedTuple ``cls`` from an object with the
    same field names (numpy or jax leaves)."""
    return from_dict(cls, {f: getattr(obj, f) for f in cls._fields}, device)


def tree_state_to_torch(ts, device=DEFAULT_DEVICE) -> TreeState:
    return from_numpy(TreeState, ts, device)


def evo_params_to_torch(evo, device=DEFAULT_DEVICE) -> EvoParams:
    return from_numpy(EvoParams, evo, device)


def exp_pop_to_torch(pop, device=DEFAULT_DEVICE) -> ExpPopParams:
    return from_numpy(ExpPopParams, pop, device)


def part_maps_to_torch(pm, device=DEFAULT_DEVICE) -> PartMaps:
    return from_numpy(PartMaps, pm, device)


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
    tree state, partition maps, ``evo``, the exponential ``pop``, the host
    generator and the run's scalars.  The JAX PRNG key has no counterpart
    in a ``torch.Generator``, so the run's generator is seeded with
    ``gen_seed``: the run continues from the same state on a trajectory of
    its own.  Raises for a skygrid, alpha-move or mpox snapshot."""
    from .io.snapshot import read_snapshot, restore_run   # it imports us
    meta, data = read_snapshot(path, JAX_SNAPSHOT_MAGIC, JAX_SNAPSHOT_VERSION)
    if "driver" not in meta:
        raise ValueError(f"{path}: snapshot predates version 3 and lacks the "
                         f"run's adaptive state")
    return restore_run(meta, data, resolve_device(device), gen_seed=gen_seed)
