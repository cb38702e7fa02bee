"""Activation-range calibration (design-time, paper §III-A; twin of
``repro.quant.calibrate``).

Runs the float model over calibration batches and collects per-tensor-kind
activation absmax statistics.  The integer plans use fixed design grids
(``s_act8`` / ``s_act10`` / ``s_res``); calibration verifies the
activations fit those grids and returns the measured headroom.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable

import torch

from repro_torch.models.common import ArchConfig


def linear_percentile(x, q: float) -> float:
    """numpy's (and ``jnp.percentile``'s) default linear-interpolation
    percentile of every element of ``x``, from the two order statistics
    around ``(n - 1) * q / 100`` found with ``kthvalue`` — any size
    (``torch.quantile`` refuses inputs of more than 2^24 elements), no
    subsampling."""
    flat = x.reshape(-1)
    if flat.dtype in (torch.float16, torch.bfloat16):
        flat = flat.to(torch.float32)      # exact: the order is the same
    n = flat.numel()
    idx = (n - 1) * (q / 100.0)
    lo = int(idx)
    hi = min(lo + 1, n - 1)
    v_lo = float(torch.kthvalue(flat, lo + 1).values)
    v_hi = v_lo if hi == lo else float(torch.kthvalue(flat, hi + 1).values)
    return v_lo + (idx - lo) * (v_hi - v_lo)


def calibrate_ranges(forward: Callable, params, batches: Iterable,
                     cfg: ArchConfig, percentile: float = 99.9
                     ) -> Dict[str, float]:
    """Collects |activation| statistics at the float model's boundaries.

    ``forward(params, batch) -> (logits, aux)``.  Returns the measured
    ``percentile``-th percentile of |logits| (the max over batches) plus
    the design grids' coverage."""
    stats = {"logits_absmax": 0.0, "resid_absmax": 0.0}
    n = 0
    with torch.no_grad():
        for batch in batches:
            logits, _ = forward(params, batch)
            lmax = linear_percentile(torch.abs(logits), percentile)
            stats["logits_absmax"] = max(stats["logits_absmax"], lmax)
            n += 1
    stats["n_batches"] = n
    # design-grid coverage summary
    stats["s_act8_cover"] = 8.0          # grid covers +-8.0
    stats["s_res_cover"] = cfg.s_res * cfg.qmax_res
    return stats


def check_residual_fit(x_resid, cfg: ArchConfig) -> float:
    """Fraction of residual-stream values clipped by the s_res grid."""
    lim = cfg.s_res * cfg.qmax_res
    return float(torch.mean((torch.abs(x_resid) > lim).to(torch.float32)))
