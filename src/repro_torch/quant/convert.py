"""Float params -> SwiftTron integer parameters (the dense-decoder and
encoder subset of ``repro.quant.convert``).

Every weight becomes int8 with per-out-channel scales folded into int32
dyadic multiplier vectors; norm gammas become the i-norm unit's integer
constants.  All scale arithmetic is float64 with round-half-to-even, as
in the reference, so the integers are identical on the CPU and the card.
The result is ``(qparams, plans)``: a dict of int tensors (layer-stacked
leaves, leading layer axis) and the frozen plan set.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core import norms
from repro_torch.device import resolve_device
from repro_torch.models import layers as fl
from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import (_stack, init_layer,
                                            layer_group_spec, require_dense)
from repro_torch.ops.spec import QuantLinearParams
from repro_torch.quant import plans as qplans

Pytree = Any


def _q_linear(w, plan: qplans.LinearPlan, bias=None) -> QuantLinearParams:
    """w (..., K, N) float -> per-channel int8 along the last axis."""
    w = w.to(torch.float64)
    s = torch.clamp(w.abs().amax(dim=-2), min=1e-8) / 127.0     # (..., N)
    w8 = torch.clamp(torch.round(w / s[..., None, :]), -127, 127
                     ).to(torch.int8)
    b_mult = bias32 = None
    if plan.s_out != 0.0:
        ratios = plan.s_in * s / plan.s_out
        b = torch.round(ratios * (1 << plan.c))
        if not bool((b.abs() < 2 ** 31).all()):
            raise ValueError("per-channel multiplier overflow")
        b_mult = b.to(torch.int32)
    if bias is not None:
        bias32 = torch.round(bias.to(torch.float64) / (plan.s_in * s)
                             ).to(torch.int32)
    return QuantLinearParams(w8, b_mult, bias32)


def _q_norm(p, plan: norms.INormPlan):
    g, b = norms.quantize_norm_weights(p["gamma"], p.get("beta"), plan)
    out = {"gamma_q": g}
    if b is not None:
        out["beta_q"] = b
    return out


def _q_attn(p, plans: qplans.AttnPlan):
    out = {name: _q_linear(p[name].flatten(-2), plans.qkv,
                           bias=p["b" + name[1]].flatten(-2)
                           if "b" + name[1] in p else None)
           for name in ("wq", "wk", "wv")}
    wo = p["wo"]
    out["wo"] = _q_linear(wo.reshape(*wo.shape[:-3], -1, wo.shape[-1]),
                          plans.out)
    return out


def _q_ffn(p, plans: qplans.FfnPlan):
    out = {"w1": _q_linear(p["w1"], plans.up, bias=p.get("b1"))}
    if "w3" in p:                                   # SwiGLU gate
        out["w3"] = _q_linear(p["w3"], plans.up)
    out["w2"] = _q_linear(p["w2"], plans.down, bias=p.get("b2"))
    return out


def _q_sublayer(p, plans: qplans.LayerPlans):
    return {"norm1": _q_norm(p["norm1"], plans.norm),
            "attn": _q_attn(p["attn"], plans.attn),
            "norm2": _q_norm(p["norm2"], plans.norm),
            "ffn": _q_ffn(p["ffn"], plans.ffn)}


def _q_embed(emb, cfg: ArchConfig):
    """-> (embed_w8, plans): the dense plans need only the embedding's
    measured scale."""
    emb = emb.to(torch.float64)
    s_emb = float(emb.abs().max()) / 127.0
    plans = qplans.build_layer_plans(cfg, {"s_emb": s_emb})
    w8 = torch.clamp(torch.round(emb / plans.embed.s_emb), -127, 127
                     ).to(torch.int8)
    return w8, plans


def _head_weight(params, cfg: ArchConfig):
    """The logits head's float (D, V): ``embed.T`` when tied.  An encoder
    has no ``lm_head`` (the reference's ``quantize_params`` fails on one
    with ``KeyError: 'lm_head'``); it runs with ``tie_embeddings=True``."""
    if cfg.tie_embeddings:
        return params["embed"].T
    if "lm_head" not in params:
        raise ValueError(f"arch {cfg.name!r} has no lm_head; quantize it "
                         "with tie_embeddings=True (the head shares the "
                         "word embedding)")
    return params["lm_head"]


def _q_head(head_w):
    """Per-vocab-column int8 head + its float32 dequant scales (a tied
    head gets its own scales over ``embed.T``'s columns)."""
    head_w = head_w.to(torch.float64)
    s_head = torch.clamp(head_w.abs().amax(dim=0), min=1e-8) / 127.0
    # a tied head is embed.T: store it (K, N)-contiguous for the kernel
    w8 = torch.clamp(torch.round(head_w / s_head[None, :]), -127, 127
                     ).to(torch.int8).contiguous()
    return QuantLinearParams(w8), s_head.to(torch.float32)


def quantize_params(params: Pytree, cfg: ArchConfig
                    ) -> Tuple[Pytree, qplans.LayerPlans]:
    """Float params (the reference layout, any device) -> (qparams,
    plans), integer-identical to ``repro.quant.convert.quantize_params``
    on the same floats."""
    require_dense(cfg)
    embed_w8, plans = _q_embed(params["embed"], cfg)
    head, head_scale = _q_head(_head_weight(params, cfg))
    qparams = {
        "embed_w8": embed_w8,
        "final_norm": _q_norm(params["final_norm"], plans.final_norm),
        "head": head,
        "head_scale": head_scale,
        "layers": [_q_sublayer(params["layers"][0], plans)],
    }
    return qparams, plans


def unit_embed_scale(cfg: ArchConfig) -> float:
    """The ``embed_scale`` of :func:`init_quantized` that draws the
    embedding at unit std (the reference init's std is ``1/sqrt(V)``)."""
    return cfg.padded_vocab() ** 0.5


def init_quantized(cfg: ArchConfig, seed: int = 0, device="cuda",
                   embed_scale: float = 1.0
                   ) -> Tuple[Pytree, qplans.LayerPlans]:
    """Draw a random float model and quantize it **layer by layer**,
    so the float copy of the whole model never exists at once (llama3-8b:
    ~32 GB in float32) — only one layer's floats and one weight's float64
    temporaries at a time.  Per-channel scales are per layer either way,
    so the integers equal ``quantize_params`` of the same draws.

    ``embed_scale`` multiplies the embedding's init std (the reference
    init's ``1/sqrt(V)``).  At full width that std puts the int32 residual
    stream at a few LSBs, below the integer RMSNorm's pre-shift, so every
    normalised row is zero; :func:`unit_embed_scale` draws a unit-std
    embedding whose integer datapath carries signal."""
    require_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)
    v = cfg.padded_vocab()
    embed = fl._init(gen, (v, cfg.d_model), dtype, scale=embed_scale)
    embed_w8, plans = _q_embed(embed, cfg)
    final_norm = _q_norm(fl.init_norm(cfg, dtype, dev), plans.final_norm)
    if not cfg.tie_embeddings and cfg.family != "encoder":
        head_w = fl._init(gen, (cfg.d_model, v), dtype)
    else:
        head_w = _head_weight({"embed": embed}, cfg)
    del embed
    head, head_scale = _q_head(head_w)
    del head_w
    _, ng, _ = layer_group_spec(cfg)
    layers = [_q_sublayer(init_layer(gen, cfg, dtype), plans)
              for _ in range(ng)]
    qparams = {
        "embed_w8": embed_w8,
        "final_norm": final_norm,
        "head": head,
        "head_scale": head_scale,
        "layers": [_stack_q(layers)],
    }
    return qparams, plans


def _stack_q(trees):
    first = trees[0]
    if isinstance(first, QuantLinearParams):
        return QuantLinearParams(*[
            None if getattr(first, f) is None
            else torch.stack([getattr(t, f) for t in trees])
            for f in QuantLinearParams._fields])
    if isinstance(first, dict):
        return {k: _stack_q([t[k] for t in trees]) for k in first}
    return _stack(trees)
