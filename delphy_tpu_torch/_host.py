"""Load the reference package's host layer without running its ``__init__``.

The port reuses ``delphy_tpu``'s numpy and ctypes modules (``phylo``, ``seq``,
``dates``, ``init_tree``, ``io/maple``, ``io/fasta``, ``parallel/partmaps``,
``topo/*``, ``native``) by import.  Importing any of them runs
``delphy_tpu/__init__.py``, which imports jax.  On a host without jax (the
CUDA machine) a bare ``delphy_tpu`` package module, holding only
``__path__``, is registered instead so that the host submodules import and
the jax-only ``__init__`` never runs.

Where jax is importable the package is imported normally: its ``__init__``
turns on jax's x64 mode, which every JAX test in the same process relies on.
"""

from __future__ import annotations

import importlib
import importlib.machinery
import importlib.util
import os
import sys
import types

_PKG = "delphy_tpu"


def _package_dir() -> str:
    spec = importlib.util.find_spec(_PKG)
    if spec is not None and spec.submodule_search_locations:
        return list(spec.submodule_search_locations)[0]
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), _PKG)


def install() -> None:
    if _PKG in sys.modules:
        return
    if importlib.util.find_spec("jax") is not None:
        importlib.import_module(_PKG)
        return
    pkg_dir = _package_dir()
    mod = types.ModuleType(_PKG)
    mod.__path__ = [pkg_dir]
    mod.__file__ = os.path.join(pkg_dir, "__init__.py")
    mod.__spec__ = importlib.machinery.ModuleSpec(_PKG, None, is_package=True)
    mod.__spec__.submodule_search_locations = [pkg_dir]
    sys.modules[_PKG] = mod


install()
