"""Integer attention (SwiftTron §III-D/E; twin of ``repro.core.attention``).

int8 Q·Kᵀ -> int32 scores (1/sqrt(head_dim) folded into the softmax input
dyadic) -> Shiftmax int8 probabilities -> int8 P·V -> int32, requantized.

Variants, as in the reference:

  * ``i_attention_full``    — materialises the score matrix (the oracle);
  * ``i_attention_chunked`` — two passes over KV chunks with a running
    (max, rescaled sum) per row; the reference's choice above its
    full-matrix threshold on a backend without a fused kernel, and past
    ``MAX_ROWSUM_LEN`` keys.  ``exp16(0)`` is 32755, not 2^15, so each
    chunk's rescale moves the sum and its integers are not the oracle's;
  * ``i_attention_decode``  — one query row against an int8 KV cache.

The contractions are :func:`~repro_torch.core.intmath.int_einsum` (exact
float64), on whichever device the operands live.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import softmax as ism
from repro_torch.core.dyadic import Dyadic, clip_to_bits, fit_dyadic
from repro_torch.core.intmath import int_einsum


class IAttnPlan(NamedTuple):
    head_dim: int
    sm: ism.ISoftmaxPlan
    dn_out: Dyadic          # (2^-7 * s_v) -> s_out
    s_q: float
    s_k: float
    s_v: float
    s_out: float


def make_iattention(head_dim: int, s_q: float, s_k: float, s_v: float,
                    s_out: float) -> IAttnPlan:
    s_score = s_q * s_k / math.sqrt(head_dim)
    qmax_score = head_dim * 127 * 127
    sm = ism.make_isoftmax(s_score, qmax_score)
    # P*V accumulator: sum_t p8 * v8, p8 normalised -> |acc| <= 127 * 2^7
    dn_out = fit_dyadic(ism.S_PROB * s_v / s_out, 127 * (1 << 7) * 2)
    return IAttnPlan(head_dim, sm, dn_out, s_q, s_k, s_v, s_out)


def _scores(q8, k8):
    """int8 (B,Sq,H,D) x int8 (B,Sk,H,D) -> int32 (B,H,Sq,Sk)."""
    return int_einsum("bqhd,bkhd->bhqk", q8, k8)


def i_attention_acc(q8, k8, v8, plan: IAttnPlan, mask=None):
    """Full-matrix attention stopping at the int32 P·V accumulator (scale
    ``2^-7 * s_v``).  q8 (B,Sq,H,D), k8/v8 (B,Sk,H,D) int8; ``mask``
    broadcastable to (B,H,Sq,Sk), True = attend."""
    scores = _scores(q8, k8)
    p8 = ism.i_softmax(scores, plan.sm, where=mask)
    return int_einsum("bhqk,bkhd->bqhd", p8, v8)


def i_attention_full(q8, k8, v8, plan: IAttnPlan, mask=None,
                     out_bits: int = 8):
    out = i_attention_acc(q8, k8, v8, plan, mask=mask)
    return clip_to_bits(plan.dn_out(out), out_bits)


def causal_mask(sq: int, sk: int, q_offset: int = 0, window: int = 0,
                device="cpu"):
    """(Sq, Sk) bool, True = attend: ``ki <= qi`` with ``qi = i +
    q_offset``; ``window`` > 0 adds sliding-window banding ``ki > qi -
    window``."""
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    ki = torch.arange(sk, device=device)[None, :]
    m = ki <= qi
    if window > 0:
        m = m & (ki > qi - window)
    return m


def i_attention_chunked(q8, k8, v8, plan: IAttnPlan, chunk: int,
                        causal: bool = True, window: int = 0,
                        out_bits: int = 8):
    """Two-pass streaming attention over KV chunks (int8 in, int32 clipped
    to ``out_bits`` out), the reference's algorithm step for step.

    Pass 1 keeps a running ``(max, rescaled sum)`` per row: each chunk's
    stats and the running sum are rescaled to the new max with
    :func:`~repro_torch.core.softmax.combine_correction` /
    :func:`~repro_torch.core.softmax.rescale_sum`.  Pass 2 recomputes each
    chunk's e16 against the global max, normalises it by the global sum
    (:func:`~repro_torch.core.softmax.finalize_probs`: ``r = 2^RECIP_BITS
    // sum``) and accumulates int8 P x int8 V.  q8 (B,Sq,H,D), k8/v8
    (B,Sk,H,D) (heads already repeated for GQA); the mask (causal, and
    banded by ``window``) aligns query ``i`` with key ``i``."""
    b, sq, h, d = q8.shape
    sk = k8.shape[1]
    assert sk % chunk == 0, (sk, chunk)
    dev = q8.device
    neg_inf = ism.NEG

    def chunk_mask(ci):
        if not causal and window <= 0:
            return None
        qi = torch.arange(sq, device=dev)[:, None]
        ki = torch.arange(chunk, device=dev)[None, :] + ci * chunk
        m = ki <= qi
        if window > 0:
            m = m & (ki > qi - window)
        return m[None, None]

    def chunk_kv(x, ci):
        return x[:, ci * chunk:(ci + 1) * chunk]

    n_chunks = sk // chunk
    m_run = torch.full((b, h, sq, 1), neg_inf, dtype=torch.int32,
                       device=dev)
    s_run = torch.zeros((b, h, sq, 1), dtype=torch.int32, device=dev)
    for ci in range(n_chunks):
        scores = _scores(q8, chunk_kv(k8, ci))
        _, m_c, s_c = ism.i_softmax_stats(scores, plan.sm,
                                          where=chunk_mask(ci))
        m_new = torch.maximum(m_run, m_c)
        s_run = ism.rescale_sum(
            s_run, ism.combine_correction(m_run, m_new, plan.sm))
        s_c = ism.rescale_sum(s_c, ism.combine_correction(m_c, m_new,
                                                          plan.sm))
        m_run, s_run = m_new, s_run + s_c

    acc = torch.zeros((b, sq, h, d), dtype=torch.int32, device=dev)
    for ci in range(n_chunks):
        scores = _scores(q8, chunk_kv(k8, ci))
        mask = chunk_mask(ci)
        q = scores if mask is None else torch.where(
            mask, scores, torch.full_like(scores, neg_inf))
        e16 = ism._exp16(q - m_run, plan.sm)
        if mask is not None:
            e16 = torch.where(mask, e16, torch.zeros_like(e16))
        p8 = ism.finalize_probs(e16, s_run)
        acc = acc + int_einsum("bhqk,bkhd->bqhd", p8, chunk_kv(v8, ci))
    return clip_to_bits(plan.dn_out(acc), out_bits)


def i_attention_decode(q8, k8_cache, v8_cache, plan: IAttnPlan, valid_len,
                       out_bits: int = 8):
    """One new token per sequence against an int8 KV cache.

    q8: (B, 1, H, D); caches: (B, L, H, D), heads already repeated or
    grouped by the caller; valid_len: (B,) int32 number of live
    positions."""
    scores = _scores(q8, k8_cache)                       # (B,H,1,L)
    pos = torch.arange(k8_cache.shape[1], device=q8.device)[
        None, None, None, :]
    mask = pos < valid_len.to(q8.device)[:, None, None, None]
    p8 = ism.i_softmax(scores, plan.sm, where=mask)
    out = int_einsum("bhqk,bkhd->bqhd", p8, v8_cache)
    return clip_to_bits(plan.dn_out(out), out_bits)
