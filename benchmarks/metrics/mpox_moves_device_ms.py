"""mpox_moves_device_ms: device ms a boundary in ``global.evo_moves``
(``_sections.py``).  Under the mpox model with alpha off that section is
the model's partitioned statistics and its (mu, rho) rounds alone."""

from benchmarks.metrics import _sections


def read(rec):
    return _sections.device_ms(rec, ("global.evo_moves",))
