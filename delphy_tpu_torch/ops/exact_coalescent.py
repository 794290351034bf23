"""Exact (not discretised) Kingman coalescent prior (port of
``delphy_tpu/ops/exact_coalescent.py``; reference core/coalescent.{h,cpp}
calc_log_prior, 50-92): walk the merged event list forward in time; each
inter-event interval contributes -k(k-1)/2 int 1/N, each coalescence
-log N(t).  A test oracle for the grid prior, evaluated on the CPU."""

from __future__ import annotations

import math

import numpy as np

from .. import pop as popm


def exact_coalescent_log_prior(t, is_tip, pop_params) -> float:
    """``pop_params`` has numpy, float or CPU tensor leaves (as for
    ``pop.host_eval``)."""
    t = np.asarray(t, dtype=np.float64)
    is_tip = np.asarray(is_tip, dtype=bool)
    # sort events by time; at equal times, coalescences first (the
    # reference uses *coal_it <= *tip_it)
    order = np.lexsort((is_tip.astype(np.int8), t))
    result = 0.0
    k = 1
    prev_t = None
    for i in order:
        next_t = float(t[i])
        if k >= 2:
            result -= (k * (k - 1)) / 2 * float(popm.host_eval(
                popm.intensity_integral, pop_params, prev_t, next_t))
        prev_t = next_t
        if not is_tip[i]:
            k += 1
            result -= math.log(float(popm.host_eval(
                popm.pop_at_time, pop_params, next_t)))
        else:
            k -= 1
    return result
