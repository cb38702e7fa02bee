"""Integer attention (SwiftTron §III-D/E; twin of ``repro.core.attention``).

int8 Q·Kᵀ -> int32 scores (1/sqrt(head_dim) folded into the softmax input
dyadic) -> Shiftmax int8 probabilities -> int8 P·V -> int32, requantized.
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


def i_attention_acc(q8, k8, v8, plan: IAttnPlan, mask=None):
    """Full-matrix attention stopping at the int32 P·V accumulator (scale
    ``2^-7 * s_v``).  q8 (B,Sq,H,D), k8/v8 (B,Sk,H,D) int8; ``mask``
    broadcastable to (B,H,Sq,Sk), True = attend."""
    scores = int_einsum("bqhd,bkhd->bhqk", q8, k8)
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
