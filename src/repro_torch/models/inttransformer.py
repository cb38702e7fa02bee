"""Integer datapath of every family (twin of
``repro.models.inttransformer``): embedding, the full-sequence forward
(``int_prefill``, which can also build the decode cache), chunked
prefill, decode over a contiguous or paged cache, the speculative verify
step (``Sq = spec_k + 1`` rows a lane), logits; an encoder-decoder's
encoder and the int8 memory a cross attention sublayer reads.

Everything from the embedding lookup to the last requant is SwiftTron
integer arithmetic; only the final logits are dequantized (the host-side
sampling boundary).  Where the reference scans over the stacked layers
with ``lax.scan``, this is a Python loop over views of the stacks, each
group's positions in architectural order.  The KV caches and the Mamba
state (the int32 SSD state ``h`` and the int8 conv tail, one a lane) are
written in place.  A cross attention position's K/V of the memory
(``ck8`` / ``cv8``, one a lane) are computed once, when the cache is
built (:func:`init_decode_cache`), and only read by decode.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.core.dyadic import fit_dyadic
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import intlayers as il
from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import (ENCODER_KIND, PORTED_KINDS,
                                            layer_group_spec)
from repro_torch.ops import QuantLinearParams, resolve_ops
from repro_torch.ops.packed import KV_SHIFT
from repro_torch.quant import plans as qplans

Pytree = Any


def _residual_add(x32, delta32, cfg: ArchConfig):
    return torch.clamp(x32 + delta32, -cfg.qmax_res, cfg.qmax_res)


def _layer(tree, g: int):
    """Layer ``g``'s views of layer-stacked params (no copies)."""
    if isinstance(tree, QuantLinearParams):
        return tree.map(lambda t: t[g])
    if isinstance(tree, dict):
        return {k: _layer(v, g) for k, v in tree.items()}
    return tree[g]


def chunked_prefill_supported(cfg: ArchConfig) -> bool:
    """Full (non-windowed) causal attention + dense FFN sublayers only
    (the reference's rule): an MoE's capacity routing drops tokens per
    group, so a chunked grouping would route otherwise than token
    streaming, and a Mamba state advances token by token."""
    _, _, kinds = layer_group_spec(cfg)
    return cfg.is_causal and cfg.window == 0 and all(
        kind == ("attn", "ffn", False) for kind in kinds)


def _ffn_sublayer(qp, x32, plans: qplans.LayerPlans, cfg: ArchConfig, ops,
                  group_size: int):
    """The second half of a sublayer: norm, then the dense FFN or the MoE
    (routing groups of ``group_size`` tokens), then the residual add."""
    h8 = il.int_norm(qp["norm2"], x32, plans.norm, ops)
    if "moe" in qp:
        f32 = il.int_moe_fwd(qp["moe"], h8, plans.moe, cfg, ops,
                             group_size=group_size)
    else:
        f32 = il.int_ffn_fwd(qp["ffn"], h8, plans.ffn, cfg, ops)
    return _residual_add(x32, f32, cfg)


def _int_sublayer_fwd(qp, x32, plans: qplans.LayerPlans, cfg: ArchConfig,
                      kind, rope_tab, positions, causal, ops, memory8=None):
    """Pre-norm integer sublayer of ``kind``: self attention, cross
    attention over ``memory8`` (the ``cross`` mixer: unmasked, no RoPE,
    ``plans.cross``) or a Mamba block (``int_mamba_prefill`` from a zero
    state); for a decoder sublayer (``has_cross``) then its own norm and
    cross attention; then a dense FFN, an MoE (routing groups of 512
    tokens, as the reference's prefill) or nothing (``ff`` None).  x32:
    (B,S,D) int32 at s_res.  The reference's integer path is pre-norm
    whatever ``cfg.post_norm`` says, and so is this."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"sublayer {kind} is no kind of the "
                                  "reference's")
    mix, ff, has_cross = kind
    h8 = il.int_norm(qp["norm1"], x32, plans.norm, ops)
    if mix == "attn":
        a32 = il.int_attn_fwd(qp["attn"], h8, plans.attn, cfg, rope_tab,
                              positions, causal=causal, window=cfg.window,
                              ops=ops)
    elif mix == "cross":
        a32 = il.int_attn_fwd(qp["attn"], h8, plans.cross, cfg, None,
                              positions, causal=False, memory8=memory8,
                              ops=ops)
    else:
        a32, _ = il.int_mamba_prefill(qp["ssm"], h8, plans.mamba, cfg,
                                      ops=ops)
    x32 = _residual_add(x32, a32, cfg)
    if has_cross:
        h8 = il.int_norm(qp["norm_cross"], x32, plans.norm, ops)
        c32 = il.int_attn_fwd(qp["cross"], h8, plans.cross, cfg, None,
                              positions, causal=False, memory8=memory8,
                              ops=ops)
        x32 = _residual_add(x32, c32, cfg)
    if ff is None:
        return x32
    return _ffn_sublayer(qp, x32, plans, cfg, ops, group_size=512)


def embed_int(qparams, tokens, plans: qplans.LayerPlans, cfg: ArchConfig):
    e8 = qparams["embed_w8"][tokens.to(torch.long)].to(torch.int32)
    return plans.embed.dn_res(e8)


def quantize_memory(mem_f, cfg: ArchConfig):
    """The float boundary of the stubbed frontends: frame / image
    embeddings (B, Sm, D) -> int8 at ``s_act8``, ``round(mem / s_act8)``
    in float32 (half to even, as ``jnp.round``), clipped to ±127.  The
    scale is a float32 tensor on the operand's device, so the division
    is the IEEE one on the card too (a CPU scalar divisor would become a
    multiply by its reciprocal there)."""
    s = torch.tensor(cfg.s_act8, dtype=torch.float32, device=mem_f.device)
    q = torch.round(mem_f.to(torch.float32) / s)
    return torch.clamp(q, -127, 127).to(torch.int8)


def _int_encoder(qparams, src_embeds, plans: qplans.LayerPlans,
                 cfg: ArchConfig, ops):
    """An encoder-decoder's encoder over the frame embeddings: the int8
    memory brought onto the residual bus (``fit_dyadic(s_act8 / s_res,
    127)``), the ``enc_layers`` stack non-causal without RoPE, then
    ``enc_final_norm`` on ``plans.norm``.  Returns the (B, Sm, D) int8
    memory the decoder's cross attention reads."""
    mem8 = quantize_memory(src_embeds, cfg)
    x32 = fit_dyadic(cfg.s_act8 / cfg.s_res, 127)(mem8.to(torch.int32))
    positions = torch.arange(mem8.shape[1], device=mem8.device)
    enc = qparams["enc_layers"]
    stack = enc[0] if isinstance(enc, (list, tuple)) else enc
    for g in range(stack["norm1"]["gamma_q"].shape[0]):
        x32 = _int_sublayer_fwd(_layer(stack, g), x32, plans, cfg,
                                ENCODER_KIND, None, positions, False, ops)
    return il.int_norm(qparams["enc_final_norm"], x32, plans.norm, ops)


def _memory(qparams, batch, plans: qplans.LayerPlans, cfg: ArchConfig, ops):
    """The int8 memory the cross attention reads, on the params' device:
    the encoder's output over ``batch["src_embeds"]`` (``encdec``), the
    quantized ``batch["img_embeds"]`` (``vlm``); None for the families
    without one."""
    dev = qparams["embed_w8"].device
    if cfg.family == "encdec":
        return _int_encoder(qparams, torch.as_tensor(batch["src_embeds"],
                                                     device=dev),
                            plans, cfg, ops)
    if cfg.family == "vlm":
        return quantize_memory(torch.as_tensor(batch["img_embeds"],
                                               device=dev), cfg)
    return None


def logits_int(qparams, x32, plans: qplans.LayerPlans, cfg: ArchConfig,
               ops=None):
    """Final norm + the raw int32 head (K1, raw epilogue) + the float
    dequant ``(acc * head_scale) * s_act8`` in float32, in the reference's
    order, so argmax ties break identically."""
    ops = resolve_ops(ops)
    h8 = il.int_norm(qparams["final_norm"], x32, plans.final_norm, ops)
    head_plan = qplans.LinearPlan(cfg.s_act8, 0.0, 32, 0, 0, cfg.d_model)
    acc = il.int_linear(h8, qparams["head"], head_plan, ops)
    return acc.to(torch.float32) * qparams["head_scale"][None] * cfg.s_act8


def int_prefill(qparams, batch, plans: qplans.LayerPlans, cfg: ArchConfig,
                ops=None, return_cache=False, cache_len: int = 0,
                rope_tab=None):
    """Full-sequence integer forward of ``batch["tokens"]`` (B, S);
    returns the last position's float32 logits (B, V), and with
    ``return_cache`` also the contiguous decode caches of the prompt
    (:func:`build_cache_from_prefill`, ``cache_len`` positions, default
    S).

    ``rope_tab``: the int32 (cos, sin) tables (built here for ``pos ==
    "rope"`` when not given).  Causal per ``cfg.is_causal``, windowed per
    ``cfg.window``; the integer path adds no position embedding for
    ``pos`` "learned" or "sinusoidal", as the reference's does not.  An
    encoder-decoder runs its encoder over ``batch["src_embeds"]`` (B, Sm,
    D) float, a VLM quantizes ``batch["img_embeds"]``; the cross
    attention sublayers read that int8 memory (:func:`_memory`)."""
    ops = resolve_ops(ops, cfg)
    _, ng, kinds = layer_group_spec(cfg)
    dev = qparams["embed_w8"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    s = tokens.shape[1]
    if rope_tab is None and cfg.pos == "rope":
        rope_tab = il.build_rope_table(max(s, cache_len) + 1, cfg.hd,
                                       cfg.rope_theta, device=dev)
    memory8 = _memory(qparams, batch, plans, cfg, ops)
    positions = torch.arange(s, device=dev)
    x32 = embed_int(qparams, tokens, plans, cfg)
    for g in range(ng):
        for j, kind in enumerate(kinds):
            x32 = _int_sublayer_fwd(_layer(qparams["layers"][j], g), x32,
                                    plans, cfg, kind, rope_tab, positions,
                                    cfg.is_causal, ops, memory8)
    # the kernels take contiguous operands: copy out the last position
    last = x32[:, -1:, :].contiguous()
    logits = logits_int(qparams, last, plans, cfg, ops)[:, 0]
    if not return_cache:
        return logits
    return logits, build_cache_from_prefill(qparams, batch, plans, cfg, ops,
                                            cache_len or s)


def init_decode_cache(cfg: ArchConfig, layout=None, device=DEFAULT_DEVICE, *,
                      batch: int = 0, cache_len: int = 0, memory8=None,
                      qparams=None, plans=None, ops=None) -> List[Dict]:
    """Per-sublayer-position caches.  A self attention position holds
    int8 K/V, zeroed: paged pools ``(ng, num_pages, page_size, Hkv, hd)``
    for ``layout`` (a ``serving.kvcache.CacheLayout``), else contiguous
    ``(ng, batch, L, Hkv, hd)`` with ``L = min(cache_len, cfg.window)``
    for a sliding window (the rolling buffer), ``cache_len`` otherwise.
    With ``layout.kv_dtype == "int4"`` the pools pack two head-dim nibbles
    a byte (last dim ``hd // 2``) and carry per-page shifts ``k_shift`` /
    ``v_shift`` ``(ng, num_pages)`` int32, all ``ops.packed.KV_SHIFT``.
    A Mamba position holds lane-indexed state in either layout (``batch``
    lanes, or the layout's ``num_slots``): ``h`` ``(ng, B, H, N, P)``
    int32 and ``conv`` ``(ng, B, K-1, C)`` int8.

    A cross attention position (the ``cross`` mixer, or a decoder
    sublayer's ``has_cross``) holds, given ``memory8`` (B, Sm, D) int8
    with ``qparams`` / ``plans`` / ``ops``, the K/V of the memory, lane
    indexed in either layout: ``ck8`` / ``cv8`` ``(ng, B, Sm, Hkv, hd)``
    int8, computed here once for every group (``plans.cross.qkv``), as
    the reference's does; a ``cross`` mixer holds no self K/V.  On
    ``device``: the card unless the caller passes ``device="cpu"``."""
    _, ng, kinds = layer_group_spec(cfg)
    packed = layout is not None and layout.kv_dtype == "int4"
    if packed and cfg.hd % 2:
        raise ValueError("int4 KV pages pair head-dim nibbles: hd must "
                         f"be even, got {cfg.hd}")
    device = resolve_device(device)
    if layout is not None:
        shape = (ng, layout.num_pages, layout.page_size, cfg.n_kv_heads,
                 cfg.hd // 2 if packed else cfg.hd)
        batch = layout.num_slots
    else:
        L = min(cache_len, cfg.window) if cfg.window > 0 else cache_len
        shape = (ng, batch, L, cfg.n_kv_heads, cfg.hd)
    if memory8 is not None and memory8.shape[0] != batch:
        raise ValueError(f"the memory has {memory8.shape[0]} lanes, the "
                         f"cache {batch}")
    caches = []
    for j, (mix, _, has_cross) in enumerate(kinds):
        c = {}
        if mix == "ssm":
            st = il.init_int_mamba_state(cfg, batch, device)
            c = {"h": st.h.expand(ng, *st.h.shape).clone(),
                 "conv": st.conv.expand(ng, *st.conv.shape).clone()}
        elif mix == "attn":
            c = {"k8": torch.zeros(shape, dtype=torch.int8, device=device),
                 "v8": torch.zeros(shape, dtype=torch.int8, device=device)}
            if packed:
                for key in ("k_shift", "v_shift"):
                    c[key] = torch.full((ng, layout.num_pages), KV_SHIFT,
                                        dtype=torch.int32, device=device)
        if (mix == "cross" or has_cross) and memory8 is not None:
            c.update(_cross_kv(qparams["layers"][j], memory8, plans, cfg,
                               resolve_ops(ops, cfg), ng, has_cross))
        caches.append(c)
    return caches


def _cross_kv(stack, memory8, plans: qplans.LayerPlans, cfg: ArchConfig,
              ops, ng: int, has_cross: bool) -> Dict:
    """``ck8`` / ``cv8`` ``(ng, B, Sm, Hkv, hd)`` of one position: each
    group's K/V projections of the memory (the ``cross`` leaves of a
    decoder sublayer, a ``cross`` mixer's ``attn``)."""
    b, sm = memory8.shape[:2]
    k, v = [], []
    for g in range(ng):
        qp = _layer(stack, g)
        src = qp["cross"] if has_cross else qp["attn"]
        k.append(il.int_linear(memory8, src["wk"], plans.cross.qkv, ops)
                 .reshape(b, sm, cfg.n_kv_heads, cfg.hd))
        v.append(il.int_linear(memory8, src["wv"], plans.cross.qkv, ops)
                 .reshape(b, sm, cfg.n_kv_heads, cfg.hd))
    return {"ck8": torch.stack(k), "cv8": torch.stack(v)}


def _sublayers(qparams, caches, cfg: ArchConfig):
    """(layer params, layer cache, kind) views in architectural order."""
    _, ng, kinds = layer_group_spec(cfg)
    for g in range(ng):
        for j, kind in enumerate(kinds):
            yield (_layer(qparams["layers"][j], g),
                   {key: leaf[g] for key, leaf in caches[j].items()}, kind)


def _cache_len(caches, pages, page_size: int, max_len: int) -> int:
    """L of :func:`intlayers.int_attn_decode`: the paged occupancy bound
    (``max_len``, else the page-table span) or the contiguous length of
    the first attention position's cache."""
    if pages is not None:
        return max_len or pages.shape[1] * page_size
    return next(c["k8"].shape[2] for c in caches if "k8" in c)


def _has_attention(cfg: ArchConfig) -> bool:
    return any(mix == "attn" for mix, _, _ in layer_group_spec(cfg)[2])


def _int_sublayer_decode(qp, cache, x32, pos, plans: qplans.LayerPlans,
                         cfg: ArchConfig, kind, ops, **attn_kw):
    """One token through a sublayer of ``kind``: self attention over the
    KV cache (``attn_kw``: the layout's operands, the step's rows and
    RoPE), cross attention over the memory's ``ck8`` / ``cv8``, or one
    Mamba step whose new state is written over the lane-indexed ``h`` /
    ``conv`` in place; a decoder sublayer's cross attention; then the FFN
    / MoE (one-token routing groups) where the sublayer has one."""
    mix, ff, has_cross = kind
    h8 = il.int_norm(qp["norm1"], x32, plans.norm, ops)
    if mix == "attn":
        a32, _ = il.int_attn_decode(qp["attn"], h8, cache, pos, plans.attn,
                                    cfg, window=cfg.window, ops=ops,
                                    **attn_kw)
    elif mix == "cross":
        a32 = _cross_decode(qp["attn"], h8, cache, plans, cfg, ops)
    else:
        a32, st = il.int_mamba_step(qp["ssm"], h8[:, 0], il.IntMambaState(
            cache["h"], cache["conv"]), plans.mamba, cfg, ops)
        cache["h"].copy_(st.h)
        cache["conv"].copy_(st.conv)
        a32 = a32[:, None]
    x32 = _residual_add(x32, a32, cfg)
    if has_cross:
        h8 = il.int_norm(qp["norm_cross"], x32, plans.norm, ops)
        x32 = _residual_add(x32, _cross_decode(qp["cross"], h8, cache,
                                               plans, cfg, ops), cfg)
    if ff is None:
        return x32
    return _ffn_sublayer(qp, x32, plans, cfg, ops, group_size=1)


def _cross_decode(qp, h8, cache, plans: qplans.LayerPlans, cfg: ArchConfig,
                  ops):
    """One token's cross attention over the whole memory: decode attention
    (K3 on ``cuda``) with ``valid_len`` the memory's length Sm, over the
    contiguous ``ck8`` / ``cv8`` (B, Sm, Hkv, hd), equal to unmasked
    full-sequence attention over the same K/V.  h8 (B, 1, D) -> int32 (B,
    1, D) at s_res."""
    b = h8.shape[0]
    sm = cache["ck8"].shape[1]
    q8 = il.int_linear(h8, qp["wq"], plans.cross.qkv, ops) \
        .reshape(b, 1, cfg.n_heads, cfg.hd)
    valid = torch.full((b,), sm, dtype=torch.int32, device=h8.device)
    o8 = ops.int_decode_attention(q8, cache["ck8"], cache["cv8"],
                                  plans.cross.attn, valid)
    return il.int_linear(o8.to(torch.int8).reshape(b, 1, -1), qp["wo"],
                         plans.cross.out, ops)


def int_decode_step(qparams, caches, tokens, pos, plans, cfg: ArchConfig,
                    rope_tab=None, ops=None, pages=None, page_size: int = 0,
                    max_len: int = 0, fold_wo: bool = False, pos_span=None,
                    tp_group=None):
    """tokens (B,) int, pos (B,) int32 -> (logits (B, V) float32, caches).

    ``caches``: contiguous (:func:`init_decode_cache` without a layout),
    or paged pools with ``pages``/``page_size``/``max_len`` (page table
    int32 (B, max_pages)); a sliding window writes its rolling slot ``pos
    % cfg.window``.  A Mamba position advances every lane's state by its
    token (an idle lane's by token 0, as in the reference), in place; a
    cross attention position reads the memory's ``ck8`` / ``cv8`` the
    caches were built with (:func:`init_decode_cache`).
    ``fold_wo`` folds each o-projection into the attention call
    (bit-exact either way).  ``pos_span``: the least and greatest of
    ``pos``, known on the host (:func:`intlayers.rope_gather`: the RoPE
    range check then reads nothing from the card).  ``tp_group``:
    tensor-parallel serving over that process group (``cfg`` the rank's
    local heads, ``qparams`` its shard; :func:`intlayers.int_attn_decode`)."""
    ops = resolve_ops(ops)
    x32 = embed_int(qparams, tokens[:, None], plans, cfg)
    attn_kw = {}
    if _has_attention(cfg):
        writes = il.step_rows(pos, _cache_len(caches, pages, page_size,
                                              max_len),
                              pages=pages, page_size=page_size,
                              window=cfg.window)
        rope = il.rope_gather(rope_tab, writes.positions, pos_span) \
            if rope_tab is not None else None
        attn_kw = dict(pages=pages, page_size=page_size, max_len=max_len,
                       fold_wo=fold_wo, rope=rope, writes=writes,
                       tp_group=tp_group)
    for qp, cache, kind in _sublayers(qparams, caches, cfg):
        x32 = _int_sublayer_decode(qp, cache, x32, pos, plans, cfg, kind,
                                   ops, **attn_kw)
    logits = logits_int(qparams, x32, plans, cfg, ops)[:, 0]
    return logits, caches


def speculative_decode_supported(cfg: ArchConfig) -> bool:
    """Whether :func:`int_verify_step` serves this arch: full
    (non-windowed) causal attention and no cross attention.  A sliding
    window interleaves rolling-buffer writes and reads token by token,
    which a batched multi-position write would break, and a Mamba state
    advances destructively token by token, so a rejected draft could not
    be rolled back.  Dense FFN and MoE sublayers both verify: the MoE
    routes each verify row alone (``group_size=1``), as a decode step
    does."""
    _, _, kinds = layer_group_spec(cfg)
    return cfg.is_causal and cfg.window == 0 and all(
        mix == "attn" and not has_cross for (mix, _, has_cross) in kinds)


def int_verify_step(qparams, caches, tokens, pos, n_new, plans,
                    cfg: ArchConfig, rope_tab=None, ops=None, pages=None,
                    page_size: int = 0, max_len: int = 0,
                    fold_wo: bool = False, pos_span=None, write_rows=None,
                    tp_group=None):
    """One speculative verify step: score S = spec_k + 1 candidate
    positions per lane in a single stepped-mask decode-attention call a
    layer (K3 at Sq = S on the ``cuda`` backend).

    ``tokens``: (B, S) int, each lane's real tokens (its last committed
    token and its drafts) right-aligned; ``pos``: (B,) the lane's current
    position (its first real row writes there); ``n_new``: (B,) real rows,
    ``1 <= n_new <= S`` with ``pos + n_new <= L`` (idle lanes pass 1 and
    token 0, the discarded row a plain decode step gives them).  Row ``i``
    of lane ``b`` covers position ``pos[b] + n_new[b] - S + i`` and sees
    the positions up to it, as a sequential :func:`int_decode_step` of the
    same tokens would, so each real row's logits equal that step's.
    ``pos_span``: the least and greatest row position, known on the host
    (pad rows clamp to 0); ``write_rows``: the real rows' flat indices
    (``intlayers.real_rows``, built on the host), which the contiguous
    layout writes alone and so needs (``ValueError`` without).  The rows'
    positions and write index are built once a step
    (:func:`intlayers.step_rows`).  ``tp_group``: as in
    :func:`int_decode_step`.  Returns ``(logits (B, S, V) float32,
    caches)``."""
    if not speculative_decode_supported(cfg):
        raise ValueError("speculative verify unsupported for arch "
                         f"{cfg.name!r} (needs window == 0 and "
                         "attention+ffn/moe sublayers only)")
    ops = resolve_ops(ops)
    x32 = embed_int(qparams, tokens, plans, cfg)
    writes = il.step_rows(pos, _cache_len(caches, pages, page_size,
                                          max_len),
                          tokens.shape[1], n_new, write_rows, pages,
                          page_size)
    rope = il.rope_gather(rope_tab, writes.positions, pos_span) \
        if rope_tab is not None else None
    for qp, cache, _ in _sublayers(qparams, caches, cfg):
        h8 = il.int_norm(qp["norm1"], x32, plans.norm, ops)
        a32, _ = il.int_attn_decode(qp["attn"], h8, cache, pos, plans.attn,
                                    cfg, ops=ops, pages=pages,
                                    page_size=page_size, max_len=max_len,
                                    fold_wo=fold_wo, rope=rope, n_new=n_new,
                                    writes=writes, tp_group=tp_group)
        x32 = _residual_add(x32, a32, cfg)
        x32 = _ffn_sublayer(qp, x32, plans, cfg, ops, group_size=1)
    return logits_int(qparams, x32, plans, cfg, ops), caches


def build_cache_from_prefill(qparams, batch, plans, cfg: ArchConfig, ops,
                             cache_len: int):
    """The contiguous decode caches of ``batch["tokens"]`` (B, S), built
    token by token through :func:`int_decode_step` at positions ``0 ..
    S-1`` (as the reference's helper does; a sliding window rolls).  A
    cross attention arch's memory is made again from the batch (the
    encoder rerun, as in the reference) and its ``ck8`` / ``cv8`` put in
    the caches (:func:`init_decode_cache`)."""
    ops = resolve_ops(ops, cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = qparams["embed_w8"].device
    tokens = torch.as_tensor(tokens, device=dev)
    caches = init_decode_cache(cfg, device=dev, batch=b,
                               cache_len=cache_len,
                               memory8=_memory(qparams, batch, plans, cfg,
                                               ops),
                               qparams=qparams, plans=plans, ops=ops)
    rope_tab = il.build_rope_table(cache_len + 1, cfg.hd, cfg.rope_theta,
                                   device=dev) if cfg.pos == "rope" else None
    for t in range(s):
        pos = torch.full((b,), t, dtype=torch.int32, device=dev)
        _, caches = int_decode_step(qparams, caches, tokens[:, t], pos,
                                    plans, cfg, rope_tab, ops)
    return caches


def int_prefill_chunk_step(qparams, caches, tokens, base_pos, plans,
                           cfg: ArchConfig, rope_tab=None, ops=None,
                           pages=None, page_size: int = 0,
                           fold_wo: bool = False, pos_span=None,
                           tp_group=None):
    """Advance every prefilling lane by one C-token prompt chunk, writing
    K/V straight into the paged pools (in place).

    ``tokens``: (B, C) chunk tokens (pads are 0); ``base_pos``: (B,)
    first logical position of each lane's chunk; ``pages``: the *prefill
    view* of the page table — rows of lanes not being prefilled must be
    nulled, so their discarded writes land on the null page.  Returns the
    caches; the chunk's hidden states are discarded (the engine feeds the
    prompt's last token through the decode step).  ``pos_span``: the
    least and greatest position the chunk covers, known on the host.
    ``tp_group``: as in :func:`int_decode_step`."""
    ops = resolve_ops(ops)
    if not chunked_prefill_supported(cfg):
        raise ValueError("chunked prefill unsupported for arch "
                         f"{cfg.name!r} (needs window == 0 and "
                         "attention+ffn sublayers only)")
    c = tokens.shape[1]
    x32 = embed_int(qparams, tokens, plans, cfg)
    rope = None
    if rope_tab is not None:
        positions = base_pos[:, None] + torch.arange(
            c, dtype=base_pos.dtype, device=base_pos.device)
        rope = il.rope_gather(rope_tab, positions, pos_span)
    for qp, cache, _ in _sublayers(qparams, caches, cfg):
        h8 = il.int_norm(qp["norm1"], x32, plans.norm, ops)
        a32, _ = il.int_attn_prefill_chunk(
            qp["attn"], h8, cache, base_pos, plans.attn, cfg, ops=ops,
            pages=pages, page_size=page_size, fold_wo=fold_wo, rope=rope,
            tp_group=tp_group)
        x32 = _residual_add(x32, a32, cfg)
        h8 = il.int_norm(qp["norm2"], x32, plans.norm, ops)
        x32 = _residual_add(x32, il.int_ffn_fwd(qp["ffn"], h8, plans.ffn,
                                                cfg, ops), cfg)
    return caches
