"""Mamba-2 (SSD) float init (twin of the init half of
``repro.models.mamba``): the random float block the integer path
quantizes.  The float forward (``mamba_fwd``) is not ported yet (ROADMAP
§1 item 12); the integer step and prefill are in ``models.intlayers``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import _init


def proj_width(cfg: ArchConfig) -> int:
    """in_proj's output: z, x (d_inner each), B, C (groups x state each),
    then one Δt a head."""
    di = cfg.ssm_d_inner
    return 2 * di + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads


def init_mamba(gen: torch.Generator, cfg: ArchConfig, dtype):
    """One Mamba block's float params, drawn from ``gen`` in the order
    in_proj, conv_w, dt_bias, out_proj.  A_log, D and dt_bias are float32
    whatever ``dtype`` is, as in the reference: A = 1..16 over the heads,
    D = 1, and dt_bias the inverse softplus of a Δt log-uniform in
    [0.001, 0.1]."""
    d, di, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_heads
    dev = gen.device
    conv_ch = di + 2 * cfg.ssm_groups * cfg.ssm_state
    in_proj = _init(gen, (d, proj_width(cfg)), dtype)
    conv_w = _init(gen, (cfg.ssm_conv, conv_ch), dtype, scale=3.0)
    u = torch.rand((h,), generator=gen, dtype=torch.float32, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    out_proj = _init(gen, (di, d), dtype)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                          device=dev)),
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.log(torch.expm1(dt)),
        "norm_gamma": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": out_proj,
    }
