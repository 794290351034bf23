"""Convert state and parameters between the JAX package and the port.

The JAX side is handed over as NamedTuples whose leaves are numpy (or any
array ``np.asarray`` accepts); fields are matched by name, so a
``delphy_tpu`` ``TreeState``, ``EvoParams``, ``ExpPopParams`` or ``PartMaps``
converts into the port's class of the same name.  ``to_numpy`` goes back: it
returns a ``{field: numpy array}`` dict from which the JAX class is rebuilt
with ``Cls(**d)``.  This module imports no jax.
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


def from_numpy(cls, obj, device=DEFAULT_DEVICE):
    """Instance of the port's NamedTuple ``cls`` from an object with the
    same field names (numpy or jax leaves)."""
    device = resolve_device(device)
    return cls(**{f: _leaf_to_torch(getattr(obj, f), device)
                  for f in cls._fields})


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
