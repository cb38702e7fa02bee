"""K3: integer decode attention (Sq <= 8 query rows per lane) over a paged
or a contiguous KV cache.

The port of ``repro/kernels/int_decode_attention.py::
int_decode_attention_fused``; the CUDA kernel is
``csrc/int_decode_attention.cu`` (one group of blocks per (lane, KV head)
holding the rows of all its query heads, the key range split across a
thread block cluster, Q·Kᵀ and P·V on the int8 tensor cores), launched as
:func:`k3_launch_plan` says, over int8 pools, packed int4 pools
(``kv_shifts``) or the contiguous cache.  :func:`int_decode_attention_plain`
is the plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.analysis.budgets import MAX_SQ
from repro_torch.analysis.contracts import decode_report, require_launch
from repro_torch.kernels import LAUNCHES, RECORDERS, note_launch
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.int_attention_fused import (K5_SMEM_LIMIT,
                                                     _check_int8,
                                                     _epilogue_operands,
                                                     apply_wo_cuda,
                                                     epilogue_setup,
                                                     exp16_args,
                                                     int_paged_prefill_plain,
                                                     paged_operands,
                                                     require_head_dim,
                                                     sk_words, v_cols)

#: K3's block (csrc/int_decode_attention.cu): query rows (two m16 tiles),
#: keys of a chunk (ranks split the keys in chunks) and of a streaming
#: tile, the most blocks a cluster, the fewest keys a rank holds; threads
K3_ROWS, K3_CHUNK, K3_TILE, K3_CMAX, K3_MIN_KEYS = 32, 32, 128, 8, 64
K3_THREADS = 128


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
    the card (converted there: nothing is read back to the host).  GQA
    and the cache's length are the contract's clauses."""
    b, _, h, d = q8.shape
    if k8.shape != v8.shape or k8.dim() != 4 or k8.shape[0] != b \
            or k8.shape[3] != d:
        raise ValueError(f"decode attention: k/v {tuple(k8.shape)} vs "
                         f"q {tuple(q8.shape)}: the contiguous cache is "
                         "(B, L, Hkv, D)")
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
    or raise (a shape outside the contract, ``analysis.contracts.
    decode_report``: ``KernelContractError``, before any launch)."""
    _require_paged(pages, kv_shifts)
    if not q8.is_cuda:
        return int_decode_attention_plain(q8, k8, v8, plan, valid_len,
                                          pages, page_size, requant, b_vec,
                                          wo, wo_spec, kv_shifts)
    requant, wo = epilogue_setup(requant, plan, wo, wo_spec)
    o = _launch(q8, k8, v8, plan, valid_len, pages, page_size, requant,
                b_vec, kv_shifts)
    if wo is None:
        return o
    return apply_wo_cuda(o, wo, wo_spec)


class K3Plan(NamedTuple):
    """One K3 launch: the grid ``(cluster, row blocks, B * Hkv)`` (a row
    block is 32 of the group's ``G * Sq`` query rows), the cluster size
    C, the keys a rank can hold (``ceil(L / C)`` rounded up to 64), the
    m16 tiles a block (1, or 2 past 16 rows), whether every key of a rank
    stays in shared memory (``resident``) or streams through tiles of
    128, the dynamic shared memory in bytes, and the granule of the K / V
    copies (16, 8 or 4 bytes)."""
    grid: tuple
    cluster: int
    rank_keys: int
    mtb: int
    resident: bool
    smem: int
    copy_bytes: int

    def describe(self) -> str:
        return (f"cluster={self.cluster} grid={list(self.grid)} "
                f"rank_keys={self.rank_keys} mtb={self.mtb} "
                f"{'resident' if self.resident else 'streaming'} "
                f"smem={self.smem} copies={self.copy_bytes}B")


def _al16(x: int) -> int:
    return -(-x // 16) * 16


def _svp(keys: int) -> int:
    """Words of a Vᵀ row of ``keys`` keys (``k3::svp``): 16 mod 32."""
    return keys // 4 + (16 if (keys // 4) % 32 == 0 else 0)


def k3_smem_bytes(d: int, rank_keys: int, mtb: int, paged: bool,
                  packed: bool, resident: bool) -> int:
    """A K3 block's dynamic shared memory, as ``r8_k3_smem_bytes``
    (``k3::smem_layout``).  Resident: the int8 K tile of every rank key
    (later Vᵀ, if larger), the packed K rows as copied, the V rows as
    copied, the scores (64 bytes a key and m16 tile).  Streaming: two K
    tiles of 128 keys (packed: two of packed rows and one int8), two of V
    rows, one Vᵀ and the tile's A fragments.  Both: a pool row a rank key
    (paged; packed: and its K and V shifts), the block and cluster slots
    of the row max and sum, rank 0's (16 mtb x D) int32 P·V sums."""
    skw, vc = sk_words(d), v_cols(d)
    rb = d // 2 if packed else d
    if resident:
        kb = max(4 * rank_keys * skw, 4 * vc * _svp(rank_keys))
        krb = rank_keys * rb if packed else 0
        vrb, vtb, fb = rank_keys * rb, 0, mtb * rank_keys * 64
    else:
        kb = 4 * K3_TILE * skw * (1 if packed else 2)
        krb = 2 * K3_TILE * rb if packed else 0
        vrb, vtb = 2 * K3_TILE * rb, 4 * vc * _svp(K3_TILE)
        fb = mtb * (K3_TILE // K3_CHUNK) * 512
    rows = 4 * rank_keys * (3 if packed else 1) if paged else 0
    red = 4 * (2 * K3_ROWS + 2 * K3_CMAX * K3_ROWS)
    return sum(_al16(x) for x in (kb, krb, vrb, vtb, fb, rows, red,
                                  4 * 16 * mtb * d))


def k3_copy_bytes(d: int, packed: bool, k_addr: int, v_addr: int) -> int:
    """The granule of K3's K / V row copies: the widest of 16, 8 and 4
    bytes that divides a stored row (D bytes, D / 2 packed: 60 at D = 120
    packed takes 4) and both K's and V's addresses; every row of every
    head then starts on one."""
    rb = d // 2 if packed else d
    wide = 16 if rb % 16 == 0 else 8 if rb % 8 == 0 else 4
    return wide if k_addr % wide == 0 and v_addr % wide == 0 else 4


def _pow2_at_most(x: int) -> int:
    return 1 << max(0, x.bit_length() - 1)


@functools.lru_cache(maxsize=1024)
def k3_launch_plan(b: int, sq: int, h: int, hkv: int, d: int, length: int,
                   paged: bool, packed: bool = False, k_addr: int = 0,
                   v_addr: int = 0, sms: int = 132) -> K3Plan:
    """The K3 launch of ``(B, Sq, H, D)`` queries over ``length``
    positions a lane (paged: ``max_pages * page_size``) of ``Hkv`` KV heads
    on a card of ``sms`` SMs, K / V at ``k_addr`` / ``v_addr``: from shapes
    only, never from ``valid_len``, which lives on the card (the kernel
    reads it and splits the lane's live keys evenly over the ranks).

    The cluster C (1, 2, 4 or 8) is the largest power of two whose blocks
    still fit one wave, ``B * Hkv * row blocks * C <= sms`` (at least 1),
    but no more ranks than the span has 32-key chunks; the route is
    resident at the first C from there up to 8 whose block fits the
    shared memory, else streaming at 8 (or the span's chunks).  At the
    serving row (B 4, 32 / 8 heads, D 128, 512 positions): C 4, 128 keys
    a rank, resident, 128 blocks; h2o-danube-3-4b's full 4096-position
    window (D 120): C 8, 512 keys a rank, resident; a 32 768-position
    table: streaming."""
    require_head_dim("int_decode_attention", d)
    if hkv <= 0 or h % hkv:
        raise ValueError(f"int_decode_attention: H={h} is not a multiple "
                         f"of Hkv={hkv}")
    if not 1 <= sq <= MAX_SQ:
        raise ValueError(f"decode attention takes 1 to {MAX_SQ} query "
                         f"rows, got {sq}")
    if packed and not paged:
        raise ValueError("kv_shifts (packed int4 KV) needs the paged "
                         "cache layout")
    rows = h // hkv * sq
    mtb = 2 if rows > 16 else 1
    grid_y = -(-rows // K3_ROWS)
    groups = b * hkv * grid_y
    chunks = max(1, -(-length // K3_CHUNK))
    most = min(K3_CMAX, 1 << (chunks.bit_length() - 1))
    c = max(1, min(_pow2_at_most(sms // max(groups, 1)), most))

    def keys(cc):
        return max(K3_MIN_KEYS, -(-(-(-length // cc)) // K3_MIN_KEYS)
                   * K3_MIN_KEYS)

    resident, cc = False, c
    while cc <= K3_CMAX:
        if k3_smem_bytes(d, keys(cc), mtb, paged, packed,
                         True) <= K5_SMEM_LIMIT:
            resident, c = True, cc
            break
        cc *= 2
    if not resident:
        c = max(c, most)
    smem = k3_smem_bytes(d, keys(c), mtb, paged, packed, resident)
    if smem > K5_SMEM_LIMIT:
        raise ValueError(f"int_decode_attention: {length} positions need "
                         f"{smem} bytes of shared memory a block")
    return K3Plan((c, grid_y, b * hkv), c, keys(c), mtb, resident, smem,
                  k3_copy_bytes(d, packed, k_addr, v_addr))


def k3_args(q8, k8, v8, plan, valid_len, pages, page_size: int, requant,
            b_vec, kv_shifts=None, sms: int = 132):
    """Check the operands and the contract (``analysis.contracts.
    decode_report``: :func:`k3_launch_plan`) and pack one K3 launch on a
    card of ``sms`` SMs, on the host alone: ``(args, out, K3Plan)``.
    ``valid_len``, the page table and the shifts of packed pools
    (``kv_shifts``) travel as device pointers and are never read here."""
    from repro_torch.kernels import _abi
    shifts = None
    if pages is not None:
        pages, vlen, shifts = paged_operands(q8, k8, v8, valid_len, pages,
                                             page_size, kv_shifts)
        maxp = pages.shape[1]
        length = maxp * page_size
    else:
        vlen = contiguous_operands(q8, k8, v8, valid_len)
        length, maxp, page_size = k8.shape[1], 0, 0
    b, s, h, d = q8.shape
    kp = require_launch(decode_report(
        b, max(s, 1), h, k8.shape[2], d, length, maxp, shifts is not None,
        k8.shape[0] if maxp else 0, k8.data_ptr() % 16, v8.data_ptr() % 16,
        sms)).plan
    bvec, out = _epilogue_operands(q8, requant, b_vec)
    k_shift, v_shift = shifts if shifts is not None else (None, None)
    args = _abi.K3Args(
        q8.data_ptr(), k8.data_ptr(), v8.data_ptr(), _abi.ptr(pages),
        vlen.data_ptr(), _abi.ptr(bvec), out.data_ptr(), _abi.ptr(k_shift),
        _abi.ptr(v_shift), b, s, h, k8.shape[2], d, length, page_size, maxp,
        int(out.dtype == torch.int8), kp.cluster, kp.rank_keys, kp.mtb,
        int(kp.resident), int(kp.copy_bytes > 4), kp.smem,
        exp16_args(plan.sm), _abi.requant_struct(requant))
    # the pointers must outlive the launch
    args._keep = (pages, vlen, bvec, shifts)
    return args, out, kp


def _launch(q8, k8, v8, plan, valid_len, pages, page_size: int, requant,
            b_vec, kv_shifts=None):
    """One K3 launch on the card (:func:`k3_args`), counted in
    ``LAUNCHES`` (packed int4 pools under ``int_decode_attention_kv4``);
    returns ``(B, Sq, H, D)``."""
    from repro_torch.kernels import _abi
    from repro_torch.kernels._build import library
    sms = torch.cuda.get_device_properties(q8.device).multi_processor_count
    args, out, kp = k3_args(q8, k8, v8, plan, valid_len, pages, page_size,
                            requant, b_vec, kv_shifts, sms)
    if out.numel() == 0:
        return out
    if RECORDERS:
        geom = dict(max_pages=args.max_pages, page_size=page_size,
                    kv_pack=kv_shifts is not None,
                    num_pages=k8.shape[0]) if pages is not None \
            else dict(L=args.L)
        note_launch("int_decode_attention", dict(
            b=args.B, sq=args.S, h=args.H, hkv=args.Hkv, d=args.D,
            k_addr=k8.data_ptr(), v_addr=v8.data_ptr(), sms=sms, **geom),
            "resident" if args.resident else "streaming", kp.grid,
            args.cluster, args.smem)
    lib = library()
    rc = lib.r8_int_decode_attention(ctypes.byref(args), _abi.stream_of(q8))
    LAUNCHES["int_decode_attention" if kv_shifts is None
             else "int_decode_attention_kv4"] += 1
    _abi.check(lib, rc, "int_decode_attention")
    return out
