"""global_moves_device_ms: device ms a boundary in the global moves'
sections (statistics, evolutionary and population moves, ledger:
``_sections.py``).  It logs the boundaries that the labelling left out.
"""

from benchmarks.metrics import _sections


def read(rec):
    return _sections.device_ms(rec, [s for s in _sections.SECTIONS
                                     if s.startswith("global.")],
                              log=True)
