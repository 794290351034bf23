"""model_moves_device_ms: device ms a boundary in the model moves'
sections, ``global.evo_moves`` and ``global.pop_moves`` (``_sections.py``)."""

from benchmarks.metrics import _sections


def read(rec):
    return _sections.device_ms(rec, ("global.evo_moves", "global.pop_moves"))
