"""sweep_prep_device_ms: device ms a boundary around the sweep kernel, in
``sweep.prep`` and ``sweep.update`` (``_sections.py``)."""

from benchmarks.metrics import _sections


def read(rec):
    return _sections.device_ms(rec, ("sweep.prep", "sweep.update"))
