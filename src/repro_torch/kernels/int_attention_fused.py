"""K5 full-sequence and K4 paged chunked-prefill integer attention (+ the
launch path they share with K3).

The ports of ``repro/kernels/int_attention_fused.py``'s
``int_attention_fused`` (CUDA kernel ``csrc/int_attention_fused.cu``) and
``int_paged_prefill_fused`` (``csrc/int_paged_prefill.cu``); their
three-sweep body, ``csrc/int_attention.cuh``, is shared with K3.
:func:`int_attention_fused_plain` and :func:`int_paged_prefill_plain` are
the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis.budgets import MAX_ROWSUM_LEN
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import ref as _ref
from repro_torch.ops.spec import PER_CHANNEL, QuantLinearParams, RequantSpec

HEAD_DIMS = (32, 64, 128)     # the head dims compiled into the kernels


def epilogue_setup(requant, plan, wo, wo_spec):
    """Default epilogue (the plan's per-tensor ``dn_out``) and the fold's
    precondition: the attention tile feeding an int8 o-projection must
    clip to <= 8 bits."""
    if requant is None:
        requant = RequantSpec.per_tensor(plan.dn_out)
    if wo is not None:
        if wo_spec is None:
            raise ValueError("folded wo projection needs wo_spec")
        if requant.is_raw or requant.out_bits > 8:
            raise ValueError("wo folding needs an int8 attention "
                             f"epilogue, got {requant}")
        wo = QuantLinearParams.of(wo)
    return requant, wo


def apply_wo_cuda(o8, wo, wo_spec):
    """The folded o-projection on the card: one K1 launch over the int8
    ``(B, S, H, D)`` attention tile -> ``(B, S, N)``."""
    from repro_torch.kernels.int8_matmul import int8_matmul
    b, s = o8.shape[0], o8.shape[1]
    out = int8_matmul(o8.reshape(b * s, -1), wo.w8, wo_spec,
                      bias32=wo.bias32, b_vec=wo.b_mult)
    return out.reshape(b, s, -1)


def _check_int8(dev, **tensors):
    for name, t in tensors.items():
        if t.device != dev or t.dtype != torch.int8 \
                or not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError(f"attention: {name} must be a contiguous, "
                             f"4-byte aligned int8 tensor on {dev}")


def _launch(entry: str, counter: str, q8, k, v, plan, requant, b_vec,
            pages=None, vlen=None, page_size: int = 0, skv: int = 0,
            mask: int = 0, window: int = 0):
    """Pack :class:`~repro_torch.kernels._abi.AttnArgs`, launch one
    attention entry point of the kernel library and count it under
    ``LAUNCHES[counter]``; returns ``(B, S, H, D)``."""
    from repro_torch.kernels import _abi
    from repro_torch.kernels._build import library
    b, s, h, d = q8.shape
    dev = q8.device
    if d not in HEAD_DIMS:
        raise ValueError(f"attention kernels support head dims "
                         f"{HEAD_DIMS}, got {d}")
    bvec = None
    if requant.kind == PER_CHANNEL:
        if b_vec is None:
            raise ValueError("per-channel RequantSpec needs the b_vec "
                             "multiplier vector")
        bvec = torch.as_tensor(b_vec, dtype=torch.int32,
                               device=dev).reshape(h * d).contiguous()
    out_dtype = torch.int8 if (not requant.is_raw
                               and requant.out_bits <= 8) else torch.int32
    out = torch.empty((b, s, h, d), dtype=out_dtype, device=dev)
    if b == 0 or s == 0:
        return out
    args = _abi.AttnArgs(
        q8.data_ptr(), k.data_ptr(), v.data_ptr(), _abi.ptr(pages),
        _abi.ptr(vlen), _abi.ptr(bvec), out.data_ptr(), b, s, h,
        k.shape[2], d, page_size,
        0 if pages is None else pages.shape[1], skv, mask, window,
        int(out_dtype == torch.int8), _abi.softmax_consts(plan.sm),
        _abi.requant_struct(requant))
    lib = library()
    rc = getattr(lib, entry)(ctypes.byref(args), _abi.stream_of(q8))
    LAUNCHES[counter] += 1
    _abi.check(lib, rc, entry)
    return out


def launch_attention(entry: str, counter: str, q8, k_pool, v_pool, plan,
                     vlen, pages, page_size: int, requant, b_vec):
    """Validate the operands and launch one of the two paged attention
    entry points (K3, K4: stepped mask over a page table); returns
    ``(B, S, H, D)``."""
    from repro_torch.kernels import _abi
    b, s, h, d = q8.shape
    dev = q8.device
    if k_pool.shape != v_pool.shape or k_pool.dim() != 4:
        raise ValueError("paged attention: k/v pools must both be "
                         "(num_pages, page_size, Hkv, D)")
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    if ps != page_size or k_pool.shape[3] != d or h % hkv:
        raise ValueError(f"paged attention: pool {tuple(k_pool.shape)} vs "
                         f"q {tuple(q8.shape)}, page_size={page_size}")
    _check_int8(dev, q8=q8, k_pool=k_pool, v_pool=v_pool)
    pages = torch.as_tensor(pages, dtype=torch.int32,
                            device=dev).contiguous()
    vlen = torch.as_tensor(vlen, dtype=torch.int32, device=dev).contiguous()
    if pages.dim() != 2 or pages.shape[0] != b or tuple(vlen.shape) != (b,):
        raise ValueError("paged attention: pages must be (B, max_pages) "
                         "and valid_len (B,)")
    if pages.shape[1] * page_size > MAX_ROWSUM_LEN:
        raise ValueError(f"paged attention: a {pages.shape[1]} x "
                         f"{page_size} page table spans more than the "
                         f"{MAX_ROWSUM_LEN} positions an exact int32 row "
                         "sum allows")
    return _launch(entry, counter, q8, k_pool, v_pool, plan, requant, b_vec,
                   pages=pages, vlen=vlen, page_size=page_size,
                   mask=_abi.MASK_STEPPED)


# ------------------------------------------------------------------ K5 ----

def int_attention_fused_plain(q8, k8, v8, plan, requant=None, b_vec=None,
                              causal: bool = True, window: int = 0,
                              out_bits: int = 8):
    """The plain version of K5: the full-matrix oracle with the kernel's
    default epilogue (the plan's per-tensor ``dn_out`` at ``out_bits``)
    and output dtype."""
    if requant is None:
        requant = RequantSpec.per_tensor(plan.dn_out, out_bits)
    return _ref.ref_int_attention(q8, k8, v8, plan, causal, window,
                                  out_bits, requant=requant, b_vec=b_vec)


def int_attention_fused(q8, k8, v8, plan, requant=None, b_vec=None,
                        causal: bool = True, window: int = 0,
                        out_bits: int = 8):
    """q8 (B, Sq, H, D) int8; k8/v8 (B, Skv, Hkv, D) int8 (GQA: Hkv | H).

    Mask: none, or causal (``ki <= qi``) and, with ``window`` > 0,
    ``ki > qi - window`` (a window implies causality, as in
    ``core.attention.causal_mask``).  ``requant``/``b_vec``: the epilogue
    (default: the plan's per-tensor ``dn_out`` at ``out_bits``).  Returns
    (B, Sq, H, D): int8 when the epilogue clips to <= 8 bits, int32
    otherwise.  Any Sq and Skv up to ``MAX_ROWSUM_LEN``; Sq != Skv is a
    cross-shaped launch.  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if not q8.is_cuda:
        return int_attention_fused_plain(q8, k8, v8, plan, requant, b_vec,
                                         causal, window, out_bits)
    from repro_torch.kernels import _abi
    if requant is None:
        requant = RequantSpec.per_tensor(plan.dn_out, out_bits)
    b, sq, h, d = q8.shape
    if k8.shape != v8.shape or k8.dim() != 4 or k8.shape[0] != b \
            or k8.shape[3] != d or h % k8.shape[2]:
        raise ValueError(f"int_attention_fused: k/v {tuple(k8.shape)} vs "
                         f"q {tuple(q8.shape)}")
    skv = k8.shape[1]
    if skv > MAX_ROWSUM_LEN:
        raise ValueError(f"int_attention_fused: Skv={skv} exceeds the "
                         f"{MAX_ROWSUM_LEN} positions an exact int32 row "
                         "sum allows")
    _check_int8(q8.device, q8=q8, k8=k8, v8=v8)
    if causal or window > 0:
        mask = _abi.MASK_CAUSAL
    else:
        mask = _abi.MASK_NONE
    return _launch("r8_int_attention_fused", "int_attention_fused", q8, k8,
                   v8, plan, requant, b_vec, skv=skv, mask=mask,
                   window=max(window, 0))


# ------------------------------------------------------------------ K4 ----

def int_paged_prefill_plain(q8, k_pool, v_pool, plan, pos_end, pages,
                            page_size: int, requant=None, b_vec=None,
                            wo=None, wo_spec=None):
    """The plain version of K4, and of K3: a chunk over pools that hold
    its K/V is stepped-mask decode with ``valid_len = pos_end``."""
    requant, wo = epilogue_setup(requant, plan, wo, wo_spec)
    return _ref.ref_int_paged_decode_attention(
        q8, k_pool, v_pool, plan, pos_end, pages, page_size,
        requant=requant, b_vec=b_vec, wo=wo, wo_spec=wo_spec)


def int_paged_prefill_fused(q8, k_pool, v_pool, plan, pos_end, pages,
                            page_size: int, requant=None, b_vec=None,
                            wo=None, wo_spec=None):
    """q8 (B, C, H, D) int8 chunk queries; pools ``(num_pages, page_size,
    Hkv, D)`` int8 *already holding the chunk's K/V*
    (``ops.paged.scatter_chunk``); ``pos_end`` (B,) = base_pos + C;
    ``pages`` (B, max_pages) int32.  Chunk row ``i`` attends to logical
    positions ``<= pos_end - C + i``.

    ``requant``/``b_vec``: the attention epilogue (default: the plan's
    per-tensor ``dn_out``).  ``wo``/``wo_spec``: fold the o-projection in;
    the return becomes ``(B, C, N)``.  Returns (B, C, H, D) otherwise.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (and, folded, one K1 launch) or raise."""
    if not q8.is_cuda:
        return int_paged_prefill_plain(q8, k_pool, v_pool, plan, pos_end,
                                       pages, page_size, requant, b_vec, wo,
                                       wo_spec)
    requant, wo = epilogue_setup(requant, plan, wo, wo_spec)
    o = launch_attention("r8_int_paged_prefill", "int_paged_prefill", q8,
                         k_pool, v_pool, plan, pos_end, pages, page_size,
                         requant, b_vec)
    if wo is None:
        return o
    return apply_wo_cuda(o, wo, wo_spec)
