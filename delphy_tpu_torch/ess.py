"""Effective sample size estimation for MCMC traces.

Standard initial-monotone-sequence estimator (Geweke/Geyer style, as used by
BEAST's Tracer for the ESS figures the reference benchmarks against,
delphywp.pdf §5)."""

from __future__ import annotations

import numpy as np


def autocorr(x: np.ndarray, max_lag: int | None = None) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    if max_lag is None:
        max_lag = n // 3
    x = x - x.mean()
    var = np.dot(x, x) / n
    if var == 0:
        return np.zeros(max_lag + 1)
    # FFT-based autocovariance
    m = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, m)
    acov = np.fft.irfft(f * np.conjugate(f))[:max_lag + 1] / n
    return acov / var


def ess(x: np.ndarray) -> float:
    """Effective sample size via the initial positive sequence estimator."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    if n < 4 or np.std(x) == 0:
        return float(n)
    rho = autocorr(x)
    # sum rho over pairs until a pair sum goes non-positive
    s = 0.0
    for k in range(1, len(rho) - 1, 2):
        pair = rho[k] + rho[k + 1]
        if pair <= 0:
            break
        s += pair
    tau = 1.0 + 2.0 * s
    return float(min(n, n / max(tau, 1.0)))


def mcse(x: np.ndarray) -> float:
    """ESS-aware Monte-Carlo standard error of the mean: s / sqrt(ESS).
    The iid s/sqrt(n) formula understates the error ~tau-fold on
    autocorrelated chains (measured ~3x small in the round-4 cadence
    study; tests/test_mcmc.py cadence statistics)."""
    x = np.asarray(x, dtype=np.float64)
    if len(x) < 4:
        return float("inf")
    return float(np.std(x, ddof=1) / np.sqrt(max(ess(x), 1.0)))
