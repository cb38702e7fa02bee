"""Float-parameter init helpers (twin of the init half of
``repro.models.layers``, MoE included): the random float model the
serving driver quantizes.  Draws come from an explicit ``torch.Generator``; they are not
the JAX package's draws (tests carry JAX's float params across instead).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.common import ArchConfig


def _init(gen: torch.Generator, shape, dtype, scale: float = 1.0):
    """Normal(0, scale / sqrt(fan_in)) with fan_in = shape[0]."""
    fan_in = shape[0] if len(shape) > 1 else 1
    std = scale / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * std).to(dtype)


def init_norm(cfg: ArchConfig, dtype, device):
    p = {"gamma": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["beta"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return p


def init_attn(gen, cfg: ArchConfig, dtype):
    d, hd = cfg.d_model, cfg.hd
    p = {
        "wq": _init(gen, (d, cfg.n_heads, hd), dtype),
        "wk": _init(gen, (d, cfg.n_kv_heads, hd), dtype),
        "wv": _init(gen, (d, cfg.n_kv_heads, hd), dtype),
        "wo": _init(gen, (cfg.n_heads, hd, d), dtype),
    }
    if cfg.attn_bias:
        dev = gen.device
        p["bq"] = torch.zeros((cfg.n_heads, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((cfg.n_kv_heads, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((cfg.n_kv_heads, hd), dtype=dtype, device=dev)
    return p


def init_ffn(gen, cfg: ArchConfig, dtype, d_ff: Optional[int] = None):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    p = {"w1": _init(gen, (d, f), dtype),
         "w2": _init(gen, (f, d), dtype)}
    if cfg.activation == "swiglu":
        p["w3"] = _init(gen, (d, f), dtype)
    else:
        p["b1"] = torch.zeros((f,), dtype=dtype, device=gen.device)
        p["b2"] = torch.zeros((d,), dtype=dtype, device=gen.device)
    return p


def init_moe(gen, cfg: ArchConfig, dtype):
    """The router (D, E), the experts' w1 / w3 (E, D, F) and w2 (E, F, D)
    over the padded expert count E, and the shared experts' FFN, drawn
    in the reference's order."""
    d = cfg.d_model
    e = cfg.padded_experts()
    f = cfg.moe_d_ff or cfg.d_ff
    p = {"router": _init(gen, (d, e), dtype),
         "w1": _init(gen, (e, d, f), dtype),
         "w2": _init(gen, (e, f, d), dtype)}
    if cfg.activation == "swiglu":
        p["w3"] = _init(gen, (e, d, f), dtype)
    if cfg.n_shared_experts:
        p["shared"] = init_ffn(gen, cfg, dtype,
                               d_ff=f * cfg.n_shared_experts)
    return p
