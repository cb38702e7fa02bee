"""Integer datapath of dense decoders, encoders, mixtures of experts and
state-space models (the ported subset of ``repro.models.inttransformer``):
embedding, the full-sequence forward
(``int_prefill``, which can also build the decode cache), chunked
prefill, decode over a contiguous or paged cache, the speculative verify
step (``Sq = spec_k + 1`` rows a lane), logits.

Everything from the embedding lookup to the last requant is SwiftTron
integer arithmetic; only the final logits are dequantized (the host-side
sampling boundary).  Where the reference scans over the stacked layers
with ``lax.scan``, this is a Python loop over views of the stacks, each
group's positions in architectural order.  The KV caches and the Mamba
state (the int32 SSD state ``h`` and the int8 conv tail, one a lane) are
written in place.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import intlayers as il
from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import PORTED_KINDS, layer_group_spec
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
                      kind, rope_tab, positions, causal, ops):
    """Pre-norm integer sublayer of ``kind``: attention or a Mamba block
    (``int_mamba_prefill`` from a zero state), then a dense FFN, an MoE
    (routing groups of 512 tokens, as the reference's prefill) or nothing
    (``ff`` None).  x32: (B,S,D) int32 at s_res.  The reference's integer
    path is pre-norm whatever ``cfg.post_norm`` says, and so is this."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"sublayer {kind} is not ported yet "
                                  "(ROADMAP §1 item 8)")
    h8 = il.int_norm(qp["norm1"], x32, plans.norm, ops)
    if kind[0] == "attn":
        a32 = il.int_attn_fwd(qp["attn"], h8, plans.attn, cfg, rope_tab,
                              positions, causal=causal, window=cfg.window,
                              ops=ops)
    else:
        a32, _ = il.int_mamba_prefill(qp["ssm"], h8, plans.mamba, cfg,
                                      ops=ops)
    x32 = _residual_add(x32, a32, cfg)
    if kind[1] is None:
        return x32
    return _ffn_sublayer(qp, x32, plans, cfg, ops, group_size=512)


def embed_int(qparams, tokens, plans: qplans.LayerPlans, cfg: ArchConfig):
    e8 = qparams["embed_w8"][tokens.to(torch.long)].to(torch.int32)
    return plans.embed.dn_res(e8)


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
    ``cfg.window``; an encoder adds no position embedding, as in the
    reference's integer path.  The encoder-decoder / VLM memory is not
    ported yet."""
    if cfg.family in ("encdec", "vlm"):
        raise NotImplementedError(f"the {cfg.family} memory (encoder / "
                                  "image tokens) is not ported yet "
                                  "(ROADMAP §1 item 8)")
    ops = resolve_ops(ops, cfg)
    _, ng, kinds = layer_group_spec(cfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    dev = qparams["embed_w8"].device
    if rope_tab is None and cfg.pos == "rope":
        rope_tab = il.build_rope_table(max(s, cache_len) + 1, cfg.hd,
                                       cfg.rope_theta, device=dev)
    positions = torch.arange(s, device=dev)
    x32 = embed_int(qparams, tokens, plans, cfg)
    for g in range(ng):
        for j, kind in enumerate(kinds):
            x32 = _int_sublayer_fwd(_layer(qparams["layers"][j], g), x32,
                                    plans, cfg, kind, rope_tab, positions,
                                    cfg.is_causal, ops)
    # the kernels take contiguous operands: copy out the last position
    last = x32[:, -1:, :].contiguous()
    logits = logits_int(qparams, last, plans, cfg, ops)[:, 0]
    if not return_cache:
        return logits
    return logits, build_cache_from_prefill(qparams, batch, plans, cfg, ops,
                                            cache_len or s)


def init_decode_cache(cfg: ArchConfig, layout=None, device=DEFAULT_DEVICE, *,
                      batch: int = 0, cache_len: int = 0) -> List[Dict]:
    """Per-sublayer-position caches, zeroed.  An attention position holds
    int8 K/V: paged pools ``(ng, num_pages, page_size, Hkv, hd)`` for
    ``layout`` (a ``serving.kvcache.CacheLayout``), else contiguous ``(ng,
    batch, L, Hkv, hd)`` with ``L = min(cache_len, cfg.window)`` for a
    sliding window (the rolling buffer), ``cache_len`` otherwise.  With
    ``layout.kv_dtype == "int4"`` the pools pack two head-dim nibbles a
    byte (last dim ``hd // 2``) and carry per-page shifts ``k_shift`` /
    ``v_shift`` ``(ng, num_pages)`` int32, all ``ops.packed.KV_SHIFT``.
    A Mamba position holds lane-indexed state in either layout (``batch``
    lanes, or the layout's ``num_slots``): ``h`` ``(ng, B, H, N, P)``
    int32 and ``conv`` ``(ng, B, K-1, C)`` int8.  On ``device``: the card
    unless the caller passes ``device="cpu"``."""
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
    caches = []
    for mix, _, _ in kinds:
        if mix == "ssm":
            st = il.init_int_mamba_state(cfg, batch, device)
            caches.append({"h": st.h.expand(ng, *st.h.shape).clone(),
                           "conv": st.conv.expand(ng, *st.conv.shape
                                                  ).clone()})
            continue
        c = {"k8": torch.zeros(shape, dtype=torch.int8, device=device),
             "v8": torch.zeros(shape, dtype=torch.int8, device=device)}
        if packed:
            for key in ("k_shift", "v_shift"):
                c[key] = torch.full((ng, layout.num_pages), KV_SHIFT,
                                    dtype=torch.int32, device=device)
        caches.append(c)
    return caches


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
    """One token through a sublayer of ``kind``: attention over the KV
    cache (``attn_kw``: the layout's operands, the step's rows and RoPE),
    or one Mamba step whose new state is written over the lane-indexed
    ``h`` / ``conv`` in place, then the FFN / MoE (one-token routing
    groups) where the sublayer has one."""
    h8 = il.int_norm(qp["norm1"], x32, plans.norm, ops)
    if kind[0] == "attn":
        a32, _ = il.int_attn_decode(qp["attn"], h8, cache, pos, plans.attn,
                                    cfg, window=cfg.window, ops=ops,
                                    **attn_kw)
    else:
        a32, st = il.int_mamba_step(qp["ssm"], h8[:, 0], il.IntMambaState(
            cache["h"], cache["conv"]), plans.mamba, cfg, ops)
        cache["h"].copy_(st.h)
        cache["conv"].copy_(st.conv)
        a32 = a32[:, None]
    x32 = _residual_add(x32, a32, cfg)
    if kind[1] is None:
        return x32
    return _ffn_sublayer(qp, x32, plans, cfg, ops, group_size=1)


def int_decode_step(qparams, caches, tokens, pos, plans, cfg: ArchConfig,
                    rope_tab=None, ops=None, pages=None, page_size: int = 0,
                    max_len: int = 0, fold_wo: bool = False, pos_span=None):
    """tokens (B,) int, pos (B,) int32 -> (logits (B, V) float32, caches).

    ``caches``: contiguous (:func:`init_decode_cache` without a layout),
    or paged pools with ``pages``/``page_size``/``max_len`` (page table
    int32 (B, max_pages)); a sliding window writes its rolling slot ``pos
    % cfg.window``.  A Mamba position advances every lane's state by its
    token (an idle lane's by token 0, as in the reference), in place.
    ``fold_wo`` folds each o-projection into the attention call
    (bit-exact either way).  ``pos_span``: the least and greatest of
    ``pos``, known on the host (:func:`intlayers.rope_gather`: the RoPE
    range check then reads nothing from the card)."""
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
                       fold_wo=fold_wo, rope=rope, writes=writes)
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
                    fold_wo: bool = False, pos_span=None, write_rows=None):
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
    (:func:`intlayers.step_rows`).  Returns ``(logits (B, S, V) float32,
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
                                    writes=writes)
        x32 = _residual_add(x32, a32, cfg)
        x32 = _ffn_sublayer(qp, x32, plans, cfg, ops, group_size=1)
    return logits_int(qparams, x32, plans, cfg, ops), caches


def build_cache_from_prefill(qparams, batch, plans, cfg: ArchConfig, ops,
                             cache_len: int):
    """The contiguous decode caches of ``batch["tokens"]`` (B, S), built
    token by token through :func:`int_decode_step` at positions ``0 ..
    S-1`` (as the reference's helper does; a sliding window rolls)."""
    ops = resolve_ops(ops, cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = qparams["embed_w8"].device
    tokens = torch.as_tensor(tokens, device=dev)
    caches = init_decode_cache(cfg, device=dev, batch=b,
                               cache_len=cache_len)
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
                           fold_wo: bool = False, pos_span=None):
    """Advance every prefilling lane by one C-token prompt chunk, writing
    K/V straight into the paged pools (in place).

    ``tokens``: (B, C) chunk tokens (pads are 0); ``base_pos``: (B,)
    first logical position of each lane's chunk; ``pages``: the *prefill
    view* of the page table — rows of lanes not being prefilled must be
    nulled, so their discarded writes land on the null page.  Returns the
    caches; the chunk's hidden states are discarded (the engine feeds the
    prompt's last token through the decode step).  ``pos_span``: the
    least and greatest position the chunk covers, known on the host."""
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
            pages=pages, page_size=page_size, fold_wo=fold_wo, rope=rope)
        x32 = _residual_add(x32, a32, cfg)
        h8 = il.int_norm(qp["norm2"], x32, plans.norm, ops)
        x32 = _residual_add(x32, il.int_ffn_fwd(qp["ffn"], h8, plans.ffn,
                                                cfg, ops), cfg)
    return caches
