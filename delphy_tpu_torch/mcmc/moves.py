"""Ledger and per-boundary caches (port of the record types of
``delphy_tpu/mcmc/moves.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Ledger(NamedTuple):
    log_G: torch.Tensor
    log_coal: torch.Tensor
    log_other: torch.Tensor

    @property
    def log_posterior(self):
        return self.log_G + self.log_coal + self.log_other


class Caches(NamedTuple):
    """Derived quantities that stay constant through a local sweep (only
    times move, so lambda_i is invariant; cf. subrun.h:42-65)."""
    lambda_i: torch.Tensor    # f64[N]
    dlam_miss: torch.Tensor   # f64[N]
    ref_cum_Q: torch.Tensor   # f64[L+1]
    root_freq: torch.Tensor   # f64[4]
