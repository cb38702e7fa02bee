"""Float params -> SwiftTron integer parameters (twin of
``repro.quant.convert``, every family).

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
from repro_torch.models.transformer import (ENCODER_KIND, _stack,
                                            init_layer, layer_group_spec,
                                            require_ported)
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


#: experts quantized at a time (their scales are per expert, so slicing
#: changes no integer): bounds the float64 temporaries of a wide layer
#: (qwen3-moe's w1: 128 x 4096 x 1536)
EXPERT_SLICE = 16


def _q_experts(w, plan: qplans.LinearPlan) -> QuantLinearParams:
    """(..., E, K, N) float -> per-expert per-channel int8 (b_mult (...,
    E, N)), ``EXPERT_SLICE`` experts at a time."""
    parts = [_q_linear(w[..., i:i + EXPERT_SLICE, :, :], plan)
             for i in range(0, w.shape[-3], EXPERT_SLICE)]
    b_mult = None if parts[0].b_mult is None \
        else torch.cat([q.b_mult for q in parts], dim=-2)
    return QuantLinearParams(torch.cat([q.w8 for q in parts], dim=-3),
                             b_mult)


def _tensor_scale(w) -> float:
    """A per-tensor scale: max |w| / 127 in float64 over ``w`` (one
    layer's tensor, or the whole stack of a position)."""
    return float(w.to(torch.float64).abs().max()) / 127.0


def _q_per_tensor(w, s: float):
    """int8 of ``w`` at the one scale ``s``."""
    return torch.clamp(torch.round(w.to(torch.float64) / s), -127, 127
                       ).to(torch.int8)


def _q_router(w, s_router: float) -> QuantLinearParams:
    """Router weights at one per-tensor scale, no multiplier (the plan is
    raw: the logits stay int32)."""
    return QuantLinearParams(_q_per_tensor(w, s_router))


def _q_moe(p, plans: qplans.MoePlan, s_router=None):
    """The MoE sublayer: experts per expert (w8 (E, K, N), b_mult (E,
    N)), the shared experts' FFN, and the router at ``s_router`` (the
    reference's: the maximum over the whole layer stack), left out where
    None (:func:`init_quantized` quantizes the routers last)."""
    out = {"w1": _q_experts(p["w1"], plans.expert.up)}
    if "w3" in p:
        out["w3"] = _q_experts(p["w3"], plans.expert.up)
    out["w2"] = _q_experts(p["w2"], plans.expert.down)
    if "shared" in p:
        out["shared"] = _q_ffn(p["shared"], plans.shared)
    if s_router is not None:
        out["router"] = _q_router(p["router"], s_router)
    return out


def _dt_weight(in_proj, cfg: ArchConfig):
    """The Δt columns of a Mamba block's in_proj (its last ``ssm_heads``)."""
    return in_proj[..., in_proj.shape[-1] - cfg.ssm_heads:]


def _q_mamba(p, mp: qplans.MambaPlan, cfg: ArchConfig, scales=None):
    """A Mamba block: in_proj's z / x / B / C columns and out_proj per
    channel, A on ``s_A``, D on the 2^-16 state grid, the norm's gamma.
    ``scales``: ``(s_dtw, s_conv)``, the per-tensor scales of the Δt
    projection and the conv (the reference's: the maximum over the whole
    stack of the position, :func:`_stack_scales`), which also set
    ``dt_bias_q``'s grid; where None those three leaves are left out
    (:func:`init_quantized` adds them last)."""
    w = p["in_proj"]
    out = {"in_proj": _q_linear(w[..., :w.shape[-1] - cfg.ssm_heads],
                                mp.in_proj),
           "A_q": torch.round(torch.exp(p["A_log"].to(torch.float64))
                              / mp.s_A).to(torch.int32),
           # D on the 2^-16 state grid (D*x enters y in h units)
           "D_q": torch.round(p["D"].to(torch.float64) / mp.s_h
                              ).to(torch.int32),
           "norm_gamma_q": norms.quantize_norm_weights(
               p["norm_gamma"], None, mp.norm)[0],
           "out_proj": _q_linear(p["out_proj"], mp.out_proj)}
    if scales is not None:
        out.update(_q_mamba_scaled(p, mp, cfg, *scales))
    return out


def _q_mamba_scaled(p, mp: qplans.MambaPlan, cfg: ArchConfig, s_dtw: float,
                    s_conv: float):
    """The leaves of a Mamba block at the per-tensor scales: ``dt_proj``
    (w8 only: its plan is raw), ``conv_w8`` and ``dt_bias_q`` (int32 at
    the Δt accumulator's scale ``s_in * s_dtw``)."""
    return {"dt_proj": QuantLinearParams(_q_per_tensor(
                _dt_weight(p["in_proj"], cfg), s_dtw)),
            "conv_w8": _q_per_tensor(p["conv_w"], s_conv),
            "dt_bias_q": torch.round(p["dt_bias"].to(torch.float64)
                                     / (mp.in_proj.s_in * s_dtw)
                                     ).to(torch.int32)}


def _stack_scales(p, kind, cfg: ArchConfig) -> dict:
    """The per-tensor scales the reference's second pass quantizes a
    position with: the maximum over that position's whole stack (``p``'s
    leaves carry the group axis) of its Δt projection and conv
    (``"ssm"``) and of its router (``"router"``)."""
    mix, ff, _ = kind
    out = {}
    if mix == "ssm":
        out["ssm"] = (_tensor_scale(_dt_weight(p["ssm"]["in_proj"], cfg)),
                      _tensor_scale(p["ssm"]["conv_w"]))
    if ff == "moe":
        out["router"] = _tensor_scale(p["moe"]["router"])
    return out


def _probe_calib(first, kinds, cfg: ArchConfig) -> dict:
    """The reference's first pass (``quantize_params``'s probe of each
    position's group 0, ``t[:1]``, into one shared dict): ``first[j]`` is
    position j's group-0 sublayer.  Later positions overwrite earlier
    ones, so ``s_dtw`` / ``s_conv`` are the last Mamba position's and
    ``s_router`` the last MoE position's (jamba: position 7 for both)."""
    sink = {}
    for p, kind in zip(first, kinds):
        group0 = _stack_scales(p, kind, cfg)
        if "ssm" in group0:
            sink["s_dtw"], sink["s_conv"] = group0["ssm"]
        if "router" in group0:
            sink["s_router"] = group0["router"]
    return sink


def _q_sublayer(p, plans: qplans.LayerPlans, cfg: ArchConfig, kind,
                scales=None):
    """One sublayer of ``kind``; ``scales`` (:func:`_stack_scales`) where
    its per-tensor leaves are quantized now, None where they come last.
    A cross-attention mixer's ``attn`` and a decoder sublayer's ``cross``
    take ``plans.cross``, its ``norm_cross`` ``plans.norm``."""
    mix, ff, has_cross = kind
    scales = scales or {}
    out = {"norm1": _q_norm(p["norm1"], plans.norm)}
    if mix in ("attn", "cross"):
        out["attn"] = _q_attn(p["attn"], plans.attn if mix == "attn"
                              else plans.cross)
    else:
        out["ssm"] = _q_mamba(p["ssm"], plans.mamba, cfg, scales.get("ssm"))
    if has_cross:
        out["cross"] = _q_attn(p["cross"], plans.cross)
        out["norm_cross"] = _q_norm(p["norm_cross"], plans.norm)
    if ff is not None:
        out["norm2"] = _q_norm(p["norm2"], plans.norm)
        if ff == "moe":
            out["moe"] = _q_moe(p["moe"], plans.moe, scales.get("router"))
        else:
            out["ffn"] = _q_ffn(p["ffn"], plans.ffn)
    return out


def _q_encoder(params, plans: qplans.LayerPlans, cfg: ArchConfig) -> dict:
    """An encoder-decoder's encoder: ``enc_layers`` (a list of one stack)
    and ``enc_final_norm``, which takes ``plans.norm`` (the reference's,
    not ``final_norm``; the two are one plan)."""
    return {"enc_layers": [_q_sublayer(params["enc_layers"][0], plans, cfg,
                                       ENCODER_KIND)],
            "enc_final_norm": _q_norm(params["enc_final_norm"], plans.norm)}


def _embed_scale(emb) -> float:
    return float(emb.to(torch.float64).abs().max()) / 127.0


def _q_embed(emb, plans: qplans.LayerPlans):
    emb = emb.to(torch.float64)
    return torch.clamp(torch.round(emb / plans.embed.s_emb), -127, 127
                       ).to(torch.int8)


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
    on the same floats.

    The per-tensor scales take the reference's two passes (ROADMAP §3):
    the plans' ``s_router`` (the gate softmax's input scale) and ``s_dtw``
    / ``s_conv`` (the Mamba Δt and conv requants) come from a probe of
    group 0 of each position in turn, so from the last MoE and the last
    Mamba position (:func:`_probe_calib`), while every router, Δt
    projection, conv and ``dt_bias`` is quantized at the scale of its
    position's whole stack (:func:`_stack_scales`)."""
    require_ported(cfg)
    _, _, kinds = layer_group_spec(cfg)
    calib = {"s_emb": _embed_scale(params["embed"])}
    layers = params["layers"]
    calib.update(_probe_calib([_group(p, 0) for p in layers], kinds, cfg))
    plans = qplans.build_layer_plans(cfg, calib)
    head, head_scale = _q_head(_head_weight(params, cfg))
    qparams = {
        "embed_w8": _q_embed(params["embed"], plans),
        "final_norm": _q_norm(params["final_norm"], plans.final_norm),
        "head": head,
        "head_scale": head_scale,
        "layers": [_q_sublayer(p, plans, cfg, kind,
                               _stack_scales(p, kind, cfg))
                   for p, kind in zip(layers, kinds)],
    }
    if cfg.family == "encdec":
        qparams.update(_q_encoder(params, plans, cfg))
    return qparams, plans


def _group(tree, g: int):
    """Group ``g``'s slice ``t[g:g+1]`` of a position's stacked floats
    (the leading axis kept, as the reference's ``t[:1]``)."""
    if isinstance(tree, dict):
        return {k: _group(v, g) for k, v in tree.items()}
    return tree[g:g + 1]


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
    embedding whose integer datapath carries signal.

    The draws are ``transformer.init_params``'s, in its order: the
    embedding, ``lm_head``, the decoder's sublayers group after group,
    an encoder-decoder's encoder sublayers.

    The per-tensor scales (ROADMAP §3): every router (an MoE, qwen3-moe:
    94 x 4096 x 128) and every Mamba block's Δt columns, conv and
    ``dt_bias`` are kept as floats until the last group is drawn, then
    quantized at the scale of their position's whole stack; the plans
    take the probe's (:func:`_probe_calib`: the last MoE and the last
    Mamba position of group 0), as :func:`quantize_params` does.  The
    experts are quantized ``EXPERT_SLICE`` at a time."""
    require_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)
    v = cfg.padded_vocab()
    embed = fl._init(gen, (v, cfg.d_model), dtype, scale=embed_scale)
    calib = {"s_emb": _embed_scale(embed)}
    # the layers' other leaves read neither s_router nor s_dtw / s_conv:
    # they are quantized with these plans, the plans returned carry the
    # probe's scales
    plans = qplans.build_layer_plans(cfg, calib)
    embed_w8 = _q_embed(embed, plans)
    final_norm = _q_norm(fl.init_norm(cfg, dtype, dev), plans.final_norm)
    if not cfg.tie_embeddings and cfg.family != "encoder":
        head_w = fl._init(gen, (cfg.d_model, v), dtype)
    else:
        head_w = _head_weight({"embed": embed}, cfg)
    del embed
    head, head_scale = _q_head(head_w)
    del head_w
    _, ng, kinds = layer_group_spec(cfg)
    layers = [[] for _ in kinds]
    kept = [[] for _ in kinds]       # each layer's per-tensor floats
    for _ in range(ng):
        for j, kind in enumerate(kinds):
            p = init_layer(gen, cfg, dtype, kind)
            kept[j].append(_per_tensor_floats(p, kind, cfg))
            layers[j].append(_q_sublayer(p, plans, cfg, kind))
            del p
    calib.update(_probe_calib([f[0] for f in kept], kinds, cfg))
    plans = qplans.build_layer_plans(cfg, calib)
    for j, kind in enumerate(kinds):
        scales = _stack_scales(_stack(kept[j]), kind, cfg)
        for q, f in zip(layers[j], kept[j]):
            if "router" in scales:
                q["moe"]["router"] = _q_router(f["moe"]["router"],
                                               scales["router"])
            if "ssm" in scales:
                q["ssm"].update(_q_mamba_scaled(f["ssm"], plans.mamba, cfg,
                                                *scales["ssm"]))
    del kept
    qparams = {
        "embed_w8": embed_w8,
        "final_norm": final_norm,
        "head": head,
        "head_scale": head_scale,
        "layers": [_stack_q(q) for q in layers],
    }
    if cfg.family == "encdec":
        qparams["enc_layers"] = [_stack_q([
            _q_sublayer(init_layer(gen, cfg, dtype, ENCODER_KIND), plans,
                        cfg, ENCODER_KIND)
            for _ in range(cfg.enc_layers)])]
        qparams["enc_final_norm"] = _q_norm(fl.init_norm(cfg, dtype, dev),
                                            plans.norm)
    return qparams, plans


def _per_tensor_floats(p, kind, cfg: ArchConfig):
    """The floats of one sublayer that wait for their stack's scale, in
    the layout :func:`_stack_scales` and :func:`_q_mamba_scaled` read: a
    router, a Mamba block's Δt columns (as ``in_proj``, copied out so the
    rest of in_proj is freed), conv and ``dt_bias``."""
    mix, ff, _ = kind
    out = {}
    if mix == "ssm":
        out["ssm"] = {"in_proj": _dt_weight(p["ssm"]["in_proj"], cfg).clone(),
                      "conv_w": p["ssm"]["conv_w"],
                      "dt_bias": p["ssm"]["dt_bias"]}
    if ff == "moe":
        out["moe"] = {"router": p["moe"]["router"]}
    return out


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
