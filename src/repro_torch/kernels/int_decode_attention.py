"""K3: integer decode attention (Sq <= 8 query rows per lane) over a paged
or a contiguous KV cache.

The port of ``repro/kernels/int_decode_attention.py::
int_decode_attention_fused``; the CUDA kernel is
``csrc/int_decode_attention.cu`` over the three-sweep ``__dp4a`` body
``csrc/int_attention.cuh``, instantiated once more for packed int4 pools
(``kv_shifts``).  :func:`int_decode_attention_plain` is the plain PyTorch
version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis.budgets import MAX_ROWSUM_LEN, MAX_SQ
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.int_attention_fused import (_check_int8,
                                                     _epilogue_operands,
                                                     apply_wo_cuda,
                                                     epilogue_setup,
                                                     int_paged_prefill_plain,
                                                     paged_operands,
                                                     require_head_dim)


def _require_paged(pages, kv_shifts) -> None:
    if kv_shifts is not None and pages is None:
        raise ValueError("kv_shifts (packed int4 KV) needs the paged cache "
                         "layout")


def int_decode_attention_plain(q8, k8, v8, plan, valid_len, pages=None,
                               page_size: int = 0, requant=None, b_vec=None,
                               wo=None, wo_spec=None, kv_shifts=None):
    """The plain version of K3: paged, a gather through the table then
    the contiguous oracle (``kernels.ref``); contiguous, the oracle.
    Packed int4 pools (``kv_shifts``) are dequantized first
    (``ops.packed.unpack_kv_pool``)."""
    _require_paged(pages, kv_shifts)
    if pages is not None:
        return int_paged_prefill_plain(q8, k8, v8, plan, valid_len, pages,
                                       page_size, requant, b_vec, wo,
                                       wo_spec, kv_shifts)
    requant, wo = epilogue_setup(requant, plan, wo, wo_spec)
    o = _ref.ref_int_decode_attention(q8, k8, v8, plan, valid_len,
                                      requant=requant, b_vec=b_vec)
    if wo is None:
        return o
    return _ref.ref_apply_wo(o, wo.w8, wo.bias32, wo.b_mult, wo_spec)


def contiguous_operands(q8, k8, v8, valid_len):
    """Check the operands of a contiguous K3 launch on the card: K/V ``(B,
    L, Hkv, D)``; returns ``valid_len`` as a contiguous int32 tensor on
    the card (converted there: nothing is read back to the host)."""
    b, _, h, d = q8.shape
    if k8.shape != v8.shape or k8.dim() != 4 or k8.shape[0] != b \
            or k8.shape[3] != d or h % k8.shape[2]:
        raise ValueError(f"decode attention: k/v {tuple(k8.shape)} vs "
                         f"q {tuple(q8.shape)}: the contiguous cache is "
                         "(B, L, Hkv, D)")
    if k8.shape[1] > MAX_ROWSUM_LEN:
        raise ValueError(f"decode attention: a cache of {k8.shape[1]} "
                         f"positions is longer than the {MAX_ROWSUM_LEN} an "
                         "exact int32 row sum allows")
    _check_int8(q8.device, q8=q8, k8=k8, v8=v8)
    vlen = torch.as_tensor(valid_len, dtype=torch.int32,
                           device=q8.device).contiguous()
    if tuple(vlen.shape) != (b,):
        raise ValueError("decode attention: valid_len must be (B,)")
    return vlen


def int_decode_attention_fused(q8, k8, v8, plan, valid_len, pages=None,
                               page_size: int = 0, requant=None, b_vec=None,
                               wo=None, wo_spec=None, kv_shifts=None):
    """q8 (B, Sq, H, D) int8, Sq <= 8; ``valid_len`` (B,) live positions
    per lane.  Caches, either layout: contiguous ``(B, L, Hkv, D)`` int8
    (``pages=None``), or pools ``(num_pages, page_size, Hkv, D)`` with
    ``pages`` (B, max_pages) int32.  Query row ``i`` attends to positions
    ``< valid_len - (Sq - 1 - i)`` (Sq = 1: ``pos < valid_len``).

    ``kv_shifts``: a ``(k_shift, v_shift)`` pair of int32 ``(num_pages,)``
    per-page shifts switches the pools to the packed int4 layout
    ``(num_pages, page_size, Hkv, D // 2)`` (``ops.packed``), expanded
    inside the kernel.  Paged layout only.

    ``requant``/``b_vec``: the attention epilogue (default: the plan's
    per-tensor ``dn_out``).  ``wo``/``wo_spec``: fold the o-projection in;
    the return becomes ``(B, Sq, N)``.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (and, folded, one K1 launch)
    or raise."""
    _require_paged(pages, kv_shifts)
    if not q8.is_cuda:
        return int_decode_attention_plain(q8, k8, v8, plan, valid_len,
                                          pages, page_size, requant, b_vec,
                                          wo, wo_spec, kv_shifts)
    if q8.shape[1] > MAX_SQ:
        raise ValueError(f"decode attention takes at most {MAX_SQ} query "
                         f"rows, got {q8.shape[1]}")
    require_head_dim("int_decode_attention", q8.shape[3])
    requant, wo = epilogue_setup(requant, plan, wo, wo_spec)
    o = _launch(q8, k8, v8, plan, valid_len, pages, page_size, requant,
                b_vec, kv_shifts)
    if wo is None:
        return o
    return apply_wo_cuda(o, wo, wo_spec)


def _launch(q8, k8, v8, plan, valid_len, pages, page_size: int, requant,
            b_vec, kv_shifts=None):
    """Pack :class:`~repro_torch.kernels._abi.AttnArgs`, launch K3 and
    count it (packed int4 pools under ``int_decode_attention_kv4``);
    returns ``(B, Sq, H, D)``.  A contiguous cache of ``L`` positions
    travels as one page of ``L`` rows a lane and no table: the kernel
    reads position ``t`` of lane ``b`` at row ``b * L + t``."""
    from repro_torch.kernels import _abi
    from repro_torch.kernels._build import library
    shifts = None
    if pages is not None:
        pages, vlen, shifts = paged_operands(q8, k8, v8, valid_len, pages,
                                             page_size, kv_shifts)
        table, rows, max_pages = pages.data_ptr(), page_size, pages.shape[1]
    else:
        vlen = contiguous_operands(q8, k8, v8, valid_len)
        table, rows, max_pages = None, k8.shape[1], 1
    b, s, h, d = q8.shape
    bvec, out = _epilogue_operands(q8, requant, b_vec)
    if b == 0 or s == 0:
        return out
    k_shift, v_shift = shifts if shifts is not None else (None, None)
    args = _abi.AttnArgs(
        q8.data_ptr(), k8.data_ptr(), v8.data_ptr(), table, vlen.data_ptr(),
        _abi.ptr(bvec), out.data_ptr(), b, s, h, k8.shape[2], d, rows,
        max_pages, int(out.dtype == torch.int8),
        _abi.softmax_consts(plan.sm), _abi.requant_struct(requant),
        _abi.ptr(k_shift), _abi.ptr(v_shift))
    lib = library()
    rc = lib.r8_int_decode_attention(ctypes.byref(args), _abi.stream_of(q8))
    LAUNCHES["int_decode_attention" if shifts is None
             else "int_decode_attention_kv4"] += 1
    _abi.check(lib, rc, "int_decode_attention")
    return out
