"""K3: paged integer decode attention (Sq <= 8 query rows per lane).

The port of ``repro/kernels/int_decode_attention.py::
int_decode_attention_fused``; the CUDA kernel is
``csrc/int_decode_attention.cu``.  :func:`int_decode_attention_plain` is
the plain PyTorch version.
"""
from __future__ import annotations

from repro_torch.analysis.budgets import MAX_SQ
from repro_torch.kernels.int_attention_fused import (apply_wo_cuda,
                                                     epilogue_setup,
                                                     int_paged_prefill_plain,
                                                     launch_attention)


def int_decode_attention_plain(q8, k_pool, v_pool, plan, valid_len, pages,
                               page_size: int, requant=None, b_vec=None,
                               wo=None, wo_spec=None):
    return int_paged_prefill_plain(q8, k_pool, v_pool, plan, valid_len,
                                   pages, page_size, requant, b_vec, wo,
                                   wo_spec)


def int_decode_attention_fused(q8, k_pool, v_pool, plan, valid_len, pages,
                               page_size: int, requant=None, b_vec=None,
                               wo=None, wo_spec=None):
    """q8 (B, Sq, H, D) int8, Sq <= 8; pools ``(num_pages, page_size, Hkv,
    D)`` int8; ``valid_len`` (B,) live positions per slot; ``pages`` (B,
    max_pages) int32.  Query row ``i`` attends to positions ``<
    valid_len - (Sq - 1 - i)`` (Sq = 1: ``pos < valid_len``).

    ``requant``/``b_vec``: the attention epilogue (default: the plan's
    per-tensor ``dn_out``).  ``wo``/``wo_spec``: fold the o-projection in;
    the return becomes ``(B, Sq, N)``.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (and, folded, one K1 launch)
    or raise."""
    if not q8.is_cuda:
        return int_decode_attention_plain(q8, k_pool, v_pool, plan,
                                          valid_len, pages, page_size,
                                          requant, b_vec, wo, wo_spec)
    if q8.shape[1] > MAX_SQ:
        raise ValueError(f"decode attention takes at most {MAX_SQ} query "
                         f"rows, got {q8.shape[1]}")
    requant, wo = epilogue_setup(requant, plan, wo, wo_spec)
    o = launch_attention("r8_int_decode_attention", "int_decode_attention",
                         q8, k_pool, v_pool, plan, valid_len, pages,
                         page_size, requant, b_vec)
    if wo is None:
        return o
    return apply_wo_cuda(o, wo, wo_spec)
