"""K3: paged integer decode attention (Sq <= 8 query rows per lane).

The port of ``repro/kernels/int_decode_attention.py::
int_decode_attention_fused``; the CUDA kernel is
``csrc/int_decode_attention.cu`` over the three-sweep ``__dp4a`` body
``csrc/int_attention.cuh``.  :func:`int_decode_attention_plain` is the
plain PyTorch version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis.budgets import MAX_SQ
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.int_attention_fused import (_epilogue_operands,
                                                     apply_wo_cuda,
                                                     epilogue_setup,
                                                     int_paged_prefill_plain,
                                                     paged_operands)


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
    o = _launch(q8, k_pool, v_pool, plan, valid_len, pages, page_size,
                requant, b_vec)
    if wo is None:
        return o
    return apply_wo_cuda(o, wo, wo_spec)


def _launch(q8, k_pool, v_pool, plan, valid_len, pages, page_size: int,
            requant, b_vec):
    """Pack :class:`~repro_torch.kernels._abi.AttnArgs`, launch K3 and
    count it; returns ``(B, Sq, H, D)``."""
    from repro_torch.kernels import _abi
    from repro_torch.kernels._build import library
    pages, vlen = paged_operands(q8, k_pool, v_pool, valid_len, pages,
                                 page_size)
    b, s, h, d = q8.shape
    bvec, out = _epilogue_operands(q8, requant, b_vec)
    if b == 0 or s == 0:
        return out
    args = _abi.AttnArgs(
        q8.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        pages.data_ptr(), vlen.data_ptr(), _abi.ptr(bvec), out.data_ptr(), b,
        s, h, k_pool.shape[2], d, page_size, pages.shape[1],
        int(out.dtype == torch.int8),
        _abi.softmax_consts(plan.sm), _abi.requant_struct(requant))
    lib = library()
    rc = lib.r8_int_decode_attention(ctypes.byref(args), _abi.stream_of(q8))
    LAUNCHES["int_decode_attention"] += 1
    _abi.check(lib, rc, "int_decode_attention")
    return out
