"""Plain PyTorch oracles for the ported kernels (twin of ``repro.kernels.ref``).

Each ``ref_*`` mirrors the exact integer semantics of its kernel by
delegating to ``repro_torch.core``: the ``torch_ref`` backend runs them,
the CPU tests hold them against the JAX oracles, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import attention as iattn
from repro_torch.core import norms as inorms
from repro_torch.core import softmax as ism
from repro_torch.core.dyadic import (apply_dyadic, apply_dyadic_perchannel,
                                     clip_to_bits)
from repro_torch.core.intmath import i_gelu, int_einsum
from repro_torch.ops.paged import gather_pages, scatter_chunk
from repro_torch.ops.spec import PER_TENSOR, QuantLinearParams


def _int8_dot(x8, w8, bias32):
    acc = int_einsum("mk,kn->mn", x8, w8)
    if bias32 is not None:
        acc = acc + bias32.to(torch.int32)[None, :]
    return acc


def ref_int8_matmul_raw(x8, w8, bias32=None):
    """int8 (M,K) x int8 (K,N) -> int32 accumulator (+ bias)."""
    return _int8_dot(x8, w8, bias32)


def ref_int8_matmul(x8, w8, bias32, dn, out_bits: int = 8):
    """int8 (M,K) x int8 (K,N) -> int32, +bias, per-tensor dyadic, clip."""
    return clip_to_bits(apply_dyadic(_int8_dot(x8, w8, bias32), dn),
                        out_bits)


def ref_int8_matmul_perchannel(x8, w8, bias32, b_vec, c: int, pre: int,
                               out_bits: int = 8):
    out = apply_dyadic_perchannel(_int8_dot(x8, w8, bias32), b_vec, c, pre,
                                  axis=-1)
    return clip_to_bits(out, out_bits)


def ref_int_layernorm(q, q_gamma, q_beta, plan: inorms.INormPlan,
                      out_bits: int = 8):
    return inorms.i_norm(q, q_gamma, q_beta, plan, out_bits)


def ref_int_decode_attention(q8, k8_cache, v8_cache, plan: iattn.IAttnPlan,
                             valid_len, out_bits: int = 8, requant=None,
                             b_vec=None):
    """Full-matrix attention of ``Sq`` query rows against a ragged
    contiguous int8 KV cache ``(B, L, Hkv, D)``.  Row ``i`` attends to
    positions ``< valid_len - (Sq - 1 - i)`` (the stepped mask)."""
    b, sq, h, d = q8.shape
    L, hkv = k8_cache.shape[1], k8_cache.shape[2]
    if hkv != h:
        rep = h // hkv
        k8_cache = k8_cache.repeat_interleave(rep, dim=2)
        v8_cache = v8_cache.repeat_interleave(rep, dim=2)
    dev = q8.device
    valid_len = torch.as_tensor(valid_len, dtype=torch.int32, device=dev)
    pos = torch.arange(L, device=dev)[None, None, None, :]
    limit = valid_len[:, None, None, None] \
        - (sq - 1 - torch.arange(sq, device=dev))[None, None, :, None]
    mask = pos < limit                                    # (B,1,Sq,L)
    if requant is None:
        return iattn.i_attention_full(q8, k8_cache, v8_cache, plan,
                                      mask=mask, out_bits=out_bits)
    acc = iattn.i_attention_acc(q8, k8_cache, v8_cache, plan, mask=mask)
    return apply_attn_requant(acc, requant, b_vec)


def ref_int_paged_decode_attention(q8, k_pool, v_pool, plan, valid_len,
                                   pages, page_size: int, out_bits: int = 8,
                                   requant=None, b_vec=None, wo=None,
                                   wo_spec=None):
    """Paged decode is *defined* as gather-then-contiguous decode; with
    ``wo`` (:class:`~repro_torch.ops.spec.QuantLinearParams`) and
    ``wo_spec`` the unfolded o-projection follows -> ``(B, Sq, N)``."""
    k8 = gather_pages(k_pool, pages, page_size)
    v8 = gather_pages(v_pool, pages, page_size)
    o = ref_int_decode_attention(q8, k8, v8, plan, valid_len, out_bits,
                                 requant=requant, b_vec=b_vec)
    if wo is None:
        return o
    return ref_apply_wo(o, wo.w8, wo.bias32, wo.b_mult, wo_spec)


def ref_int_paged_prefill(q8, k8_new, v8_new, k_pool, v_pool, plan,
                          base_pos, pages, page_size: int,
                          out_bits: int = 8, requant=None, b_vec=None,
                          wo_w8=None, wo_bias32=None, wo_b_vec=None,
                          wo_spec=None):
    """Chunked paged prefill: scatter the chunk's K/V into the pools (in
    place), then the paged stepped-mask decode oracle with ``valid_len =
    base_pos + C`` — chunk row ``i`` then sees exactly the positions
    ``<= base_pos + i``.  Returns ``(o, k_pool, v_pool)``."""
    k_pool = scatter_chunk(k_pool, k8_new, base_pos, pages, page_size)
    v_pool = scatter_chunk(v_pool, v8_new, base_pos, pages, page_size)
    vl = torch.as_tensor(base_pos, dtype=torch.int32,
                         device=q8.device) + q8.shape[1]
    wo = None if wo_w8 is None else QuantLinearParams(wo_w8, wo_b_vec,
                                                      wo_bias32)
    o = ref_int_paged_decode_attention(q8, k_pool, v_pool, plan, vl, pages,
                                       page_size, out_bits, requant=requant,
                                       b_vec=b_vec, wo=wo, wo_spec=wo_spec)
    return o, k_pool, v_pool


def ref_apply_wo(o8, wo_w8, wo_bias32, wo_b_vec, wo_spec):
    """The unfolded o-projection a folded launch must match: int8
    ``(B, Sq, H, D)`` x ``wo_w8 (H·D, N)`` + bias + the wo epilogue ->
    ``(B, Sq, N)``."""
    b, sq = o8.shape[0], o8.shape[1]
    x8 = o8.to(torch.int8).reshape(b * sq, -1)
    acc = _int8_dot(x8, wo_w8, wo_bias32)
    if wo_spec.is_raw:
        return acc.reshape(b, sq, -1)
    if wo_spec.kind == PER_TENSOR:
        out = apply_dyadic(acc, wo_spec.dn)
    else:
        if wo_b_vec is None:
            raise ValueError("per-channel wo_spec needs the wo_b_vec "
                             "multiplier vector")
        out = apply_dyadic_perchannel(acc, wo_b_vec, wo_spec.c, wo_spec.pre,
                                      axis=-1)
    out = clip_to_bits(out, wo_spec.out_bits)
    out = out.to(torch.int8) if wo_spec.out_bits <= 8 else out
    return out.reshape(b, sq, -1)


def apply_attn_requant(acc, requant, b_vec=None):
    """A RequantSpec epilogue on the (B, Sq, H, D) int32 P·V accumulator;
    the per-channel axis is the flattened (head, head_dim) channel."""
    if requant.is_raw:
        return acc
    if requant.kind == PER_TENSOR:
        out = apply_dyadic(acc, requant.dn)
    else:
        if b_vec is None:
            raise ValueError("per-channel RequantSpec needs the b_vec "
                             "multiplier vector")
        b, sq, h, d = acc.shape
        out = apply_dyadic_perchannel(
            acc.reshape(b, sq, h * d), b_vec.reshape(h * d),
            requant.c, requant.pre, axis=-1).reshape(b, sq, h, d)
    out = clip_to_bits(out, requant.out_bits)
    return out.to(torch.int8) if requant.out_bits <= 8 else out


def ref_int_gelu(q, plan, dn_out, out_bits: int = 8):
    """i-GELU of int32 ``q`` (any shape), the output dyadic, clip."""
    return clip_to_bits(apply_dyadic(i_gelu(q.to(torch.int32), plan),
                                     dn_out), out_bits)


def ref_int_attention(q8, k8, v8, plan: iattn.IAttnPlan, causal: bool = True,
                      window: int = 0, out_bits: int = 8, requant=None,
                      b_vec=None):
    """Full-matrix integer attention of ``(B, Sq, H, D)`` queries against
    ``(B, Skv, Hkv, D)`` keys/values (GQA: ``Hkv | H``), causal and
    sliding-window masks as ``core.attention.causal_mask`` with offset 0.
    ``requant``: a RequantSpec epilogue on the int32 P·V accumulator
    (``None``: the plan's per-tensor ``dn_out`` clipped to ``out_bits``,
    int32 as in the reference)."""
    sq, sk = q8.shape[1], k8.shape[1]
    mask = iattn.causal_mask(sq, sk, window=window, device=q8.device
                             )[None, None] if (causal or window > 0) else None
    h, hkv = q8.shape[2], k8.shape[2]
    if hkv != h:
        rep = h // hkv
        k8 = k8.repeat_interleave(rep, dim=2)
        v8 = v8.repeat_interleave(rep, dim=2)
    if requant is None:
        return iattn.i_attention_full(q8, k8, v8, plan, mask=mask,
                                      out_bits=out_bits)
    acc = iattn.i_attention_acc(q8, k8, v8, plan, mask=mask)
    return apply_attn_requant(acc, requant, b_vec)


def ref_int_softmax(q_scores, plan, where=None):
    """Shiftmax of int32 scores along the last axis -> int8 probabilities
    at 2^-7; ``where`` (True = attend) masks as ``core.softmax.i_softmax``."""
    return ism.i_softmax(q_scores, plan, where=where)
