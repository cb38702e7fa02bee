"""K5 full-sequence and K4 paged chunked-prefill integer attention (+ the
operand checks and head dims of the attention kernels K3, K4, K5, K8).

The ports of ``repro/kernels/int_attention_fused.py``'s
``int_attention_fused`` (CUDA kernel ``csrc/int_attention_fused.cu``) and
``int_paged_prefill_fused`` (``csrc/int_paged_prefill.cu``): one
tensor-core body, ``csrc/int_attention_mma.cuh``, launched as
:func:`k5_launch_plan` and :func:`k4_launch_plan` say.
:func:`int_attention_fused_plain` and :func:`int_paged_prefill_plain` are
the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.analysis.contracts import (attention_report,
                                            prefill_report, require_launch)
from repro_torch.core.softmax import _exp16
from repro_torch.kernels import LAUNCHES, RECORDERS, note_launch
from repro_torch.kernels import ref as _ref
from repro_torch.ops.packed import unpack_kv_pool
from repro_torch.ops.spec import PER_CHANNEL, QuantLinearParams, RequantSpec

#: the head dims each attention kernel is compiled for.  Every one (all on
#: the int8 tensor cores) takes any multiple of 8 in its body, a D that is
#: not a multiple of 32 padded to the next one inside the kernel.  The reference takes every even D (ROADMAP
#: §2 item 4 lists the rest).
HEAD_DIMS = {"int_decode_attention": (32, 64, 120, 128),
             "int_attention_fused": (32, 64, 120, 128),
             "int_paged_prefill": (32, 64, 120, 128),
             "int_attention_online": (32, 64, 120, 128)}


def require_head_dim(kernel: str, d: int) -> None:
    """Raise ``ValueError`` for a head dim ``kernel`` is not compiled
    for."""
    if d not in HEAD_DIMS[kernel]:
        raise ValueError(f"{kernel}: head dim {d} is not one the kernel is "
                         f"compiled for {HEAD_DIMS[kernel]} (ROADMAP §2 "
                         "item 4)")


def k_copy_bytes(d: int, k_addr: int) -> int:
    """The granule of the tensor-core kernels' K tile copies (K4, K5, K8):
    16 bytes where D is a multiple of 16, else 8 (D = 120: a head's row
    starts 8-byte aligned, ``h * 120`` bytes in), when K's address is
    aligned to it; else 4.  Every key row of every head then starts on a
    granule: its offset is a multiple of D."""
    wide = 16 if d % 16 == 0 else 8
    return wide if k_addr % wide == 0 else 4


def v_cols(d: int) -> int:
    """D padded to a multiple of 32 (``tc::v_cols``): the bytes of a K row
    the k-steps of Q·Kᵀ read, and the rows of the staged Vᵀ tile."""
    return -(-d // 32) * 32


def sk_words(d: int) -> int:
    """The K tile's row stride in words (``tc::sk_words``): the padded row
    (:func:`v_cols`), then 8 mod 16 words so a half-warp's 8-byte fragment
    loads hit 32 distinct banks."""
    dp = v_cols(d) // 4
    return dp if dp % 16 == 8 else dp + 8


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
        wo = _dense_wo(wo)
    return requant, wo


def _dense_wo(wo):
    """A folded o-projection must be dense int8: a packed wo never folds
    (the dispatch layer composes it through ``int8_matmul_packed``)."""
    wo = QuantLinearParams.of(wo)
    if wo.is_packed:
        raise ValueError("a packed (int4 / MSR-4) wo never folds into an "
                         "attention launch; use ops.int8_matmul_packed")
    return wo


def apply_wo_cuda(o8, wo, wo_spec):
    """The folded o-projection on the card: one K1 launch over the int8
    ``(B, S, H, D)`` attention tile -> ``(B, S, N)``.  Raises for a
    packed wo."""
    from repro_torch.kernels.int8_matmul import int8_matmul
    wo = _dense_wo(wo)
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


def _epilogue_operands(q8, requant, b_vec):
    """The per-channel multiplier vector (or None) and the output tensor
    ``(B, S, H, D)`` of an attention launch: int8 when the epilogue clips
    to <= 8 bits, int32 otherwise."""
    b, s, h, d = q8.shape
    dev = q8.device
    bvec = None
    if requant.kind == PER_CHANNEL:
        if b_vec is None:
            raise ValueError("per-channel RequantSpec needs the b_vec "
                             "multiplier vector")
        bvec = torch.as_tensor(b_vec, dtype=torch.int32,
                               device=dev).reshape(h * d).contiguous()
    out_dtype = torch.int8 if (not requant.is_raw
                               and requant.out_bits <= 8) else torch.int32
    return bvec, torch.empty((b, s, h, d), dtype=out_dtype, device=dev)


def paged_operands(q8, k_pool, v_pool, pos_end, pages, page_size: int,
                   kv_shifts=None):
    """Check the operands of a paged attention launch (K3, K4) on the
    card; returns ``(pages, pos_end, shifts)`` as contiguous int32 tensors
    on the card (converted there: nothing is read back to the host).
    ``kv_shifts``: the ``(k_shift, v_shift)`` pair of ``(num_pages,)``
    per-page shifts of packed int4 pools ``(num_pages, page_size, Hkv, D
    // 2)``; ``shifts`` is then that pair, else None.  The kernels' own
    clauses (GQA, head dim, the table's span) are the contract's, which
    the caller checks next."""
    b, s, h, d = q8.shape
    dev = q8.device
    if k_pool.shape != v_pool.shape or k_pool.dim() != 4:
        raise ValueError("paged attention: k/v pools must both be "
                         "(num_pages, page_size, Hkv, D)")
    ps = k_pool.shape[1]
    width = d if kv_shifts is None else d // 2
    if ps != page_size or k_pool.shape[3] != width:
        raise ValueError(f"paged attention: pool {tuple(k_pool.shape)} vs "
                         f"q {tuple(q8.shape)}, page_size={page_size}"
                         f"{'' if kv_shifts is None else ' (int4 packed)'}")
    _check_int8(dev, q8=q8, k_pool=k_pool, v_pool=v_pool)
    pages = torch.as_tensor(pages, dtype=torch.int32,
                            device=dev).contiguous()
    pos_end = torch.as_tensor(pos_end, dtype=torch.int32,
                              device=dev).contiguous()
    if pages.dim() != 2 or pages.shape[0] != b \
            or tuple(pos_end.shape) != (b,):
        raise ValueError("paged attention: pages must be (B, max_pages) "
                         "and valid_len (B,)")
    shifts = None
    if kv_shifts is not None:
        shifts = tuple(torch.as_tensor(x, dtype=torch.int32,
                                       device=dev).contiguous()
                       for x in kv_shifts)
        if any(tuple(x.shape) != (k_pool.shape[0],) for x in shifts):
            raise ValueError("paged attention: kv_shifts must be two "
                             f"({k_pool.shape[0]},) per-page shift "
                             "vectors")
    return pages, pos_end, shifts


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


#: K5's block (csrc/int_attention_mma.cuh): query rows, keys a tile,
#: threads; and the dynamic shared memory a block may have on the H100
K5_ROWS, K5_KEYS, K5_THREADS = 64, 64, 128
K5_SMEM_LIMIT = 232448


class K5Plan(NamedTuple):
    """One K5 or K4 launch: the grid ``(query blocks, H, B)`` of 64-row
    blocks, the key tiles of the widest block's range, the dynamic shared memory in bytes, whether
    sweep 1 keeps e16 in shared memory (sweep 2 then skips Q·Kᵀ and
    exp16), and whether K is copied in wide granules (16 bytes, or 8 at a
    D that is not a multiple of 16: :func:`k_copy_bytes`), else 4."""
    grid: tuple
    tiles: int
    smem: int
    store_e16: bool
    vec_k: bool


def _row_range(sq: int, skv: int, causal: bool, window: int, i: int):
    """[lo, hi) of query row ``i`` (empty past ``sq``), as the kernel's
    ``k5::row_range``."""
    lo, hi = 0, skv
    if i >= sq:
        hi = 0
    elif causal:
        hi = i + 1
        if window > 0:
            lo = i - window + 1
    hi = min(max(hi, 0), skv)
    return min(max(lo, 0), hi), hi


@functools.lru_cache(maxsize=256)
def k5_tiles(sq: int, skv: int, causal: bool, window: int) -> int:
    """Key tiles of the widest block's key range (the union of its rows'
    live ranges), as the kernel library's ``k5::max_tiles``."""
    most = 0
    for q0 in range(0, sq, K5_ROWS):
        lo, _ = _row_range(sq, skv, causal, window, q0)
        _, hi = _row_range(sq, skv, causal, window, min(q0 + K5_ROWS, sq) - 1)
        most = max(most, -(-(hi - lo) // K5_KEYS) if hi > lo else 0)
    return most


def k5_smem_bytes(d: int, tiles: int, store_e16: bool) -> int:
    """A K5 block's dynamic shared memory, as ``r8_k5_smem_bytes``: two K
    tiles (row stride :func:`sk_words`), one Vᵀ tile (:func:`v_cols` rows)
    and, with the e16 store, 2 KB a warp a key tile."""
    store = 4 * (K5_THREADS // 32) * tiles * (K5_KEYS // 8) * 2 * 32
    return 4 * (2 * K5_KEYS * sk_words(d) + v_cols(d) * (K5_KEYS // 4)) + (
        store if store_e16 else 0)


def k5_launch_plan(b: int, sq: int, skv: int, h: int, hkv: int, d: int,
                   causal: bool, window: int, k_addr: int,
                   e16_fits: bool = True) -> K5Plan:
    """The K5 launch of a (B, Sq, H, D) x (B, Skv, Hkv, D) attention with
    the wrapper's mask (a window implies causality), K at address
    ``k_addr``: wide copies of K iff it is aligned to them
    (:func:`k_copy_bytes`); the e16 store iff e16 fits 16 bits
    (``e16_fits``) and the widest block's range fits the shared memory a
    block may have.  Raises for a head dim the
    kernel is not compiled for."""
    require_head_dim("int_attention_fused", d)
    if hkv <= 0 or h % hkv:
        raise ValueError(f"int_attention_fused: H={h} is not a multiple of "
                         f"Hkv={hkv}")
    causal = bool(causal) or window > 0
    tiles = k5_tiles(sq, skv, causal, max(window, 0))
    store = e16_fits and k5_smem_bytes(d, tiles, True) <= K5_SMEM_LIMIT
    return K5Plan((-(-sq // K5_ROWS), h, b), tiles,
                  k5_smem_bytes(d, tiles, store), store,
                  k_copy_bytes(d, k_addr) > 4)


@functools.lru_cache(maxsize=16)
def exp16_divisor(q_ln2: int, n_max: int) -> tuple[int, int]:
    """``(magic, shift)`` with ``(n * magic) >> (32 + shift) == n //
    q_ln2`` for every ``0 <= n <= n_max`` (K3's, K4's, K5's and K8's exp16 division
    as a multiply-high), checked on all of them.  The rounded-up reciprocal
    ``magic = ceil(2^k / q_ln2)`` is exact there when ``n_max * (magic *
    q_ln2 - 2^k) < 2^k``; the largest ``k`` whose magic fits 32 bits is
    taken."""
    if q_ln2 < 2 or not 0 <= n_max < 1 << 31:
        raise ValueError(f"exp16 division: q_ln2={q_ln2}, n_max={n_max} "
                         "outside what the attention kernels take")
    for shift in range(31, -1, -1):
        k = 32 + shift
        magic = -(-(1 << k) // q_ln2)
        if magic < 1 << 32 and n_max * (magic * q_ln2 - (1 << k)) < 1 << k:
            n = np.arange(n_max + 1, dtype=np.uint64)
            if np.array_equal((n * np.uint64(magic)) >> np.uint64(k),
                              n // np.uint64(q_ln2)):
                return magic, shift
    raise ValueError(f"exp16 division: no exact multiply-high for "
                     f"q_ln2={q_ln2} on [0, {n_max}]")


@functools.lru_cache(maxsize=16)
def exp16_args(sm):
    """The plan ``sm``'s constants for the attention kernels' branch-free exp16
    (``_abi.exp16_consts`` with its multiply-high division), packed once
    per plan."""
    from repro_torch.kernels import _abi
    ie = sm.iexp
    return _abi.exp16_consts(sm, *exp16_divisor(ie.q_ln2,
                                                 ie.z_max * ie.q_ln2))


@functools.lru_cache(maxsize=16)
def e16_fits_16_bits(sm) -> bool:
    """Whether every e16 of the plan (exp16 over its whole clipped domain
    [-q_band, 0]) lies in [0, 2^16), so K5 may keep it as 16 bits."""
    e16 = _exp16(torch.arange(-sm.q_band, 1, dtype=torch.int32), sm)
    return int(e16.min()) >= 0 and int(e16.max()) < 1 << 16


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
    launch the tensor-core kernel (:func:`k5_launch_plan`, through the
    contract ``analysis.contracts.attention_report``) or raise."""
    if not q8.is_cuda:
        return int_attention_fused_plain(q8, k8, v8, plan, requant, b_vec,
                                         causal, window, out_bits)
    from repro_torch.kernels import _abi
    from repro_torch.kernels._build import library
    if requant is None:
        requant = RequantSpec.per_tensor(plan.dn_out, out_bits)
    b, sq, h, d = q8.shape
    if k8.shape != v8.shape or k8.dim() != 4 or k8.shape[0] != b \
            or k8.shape[3] != d:
        raise ValueError(f"int_attention_fused: k/v {tuple(k8.shape)} vs "
                         f"q {tuple(q8.shape)}")
    skv, hkv = k8.shape[1], k8.shape[2]
    _check_int8(q8.device, q8=q8, k8=k8, v8=v8)
    sm = plan.sm
    causal, window = bool(causal) or window > 0, max(window, 0)
    e16_fits = e16_fits_16_bits(sm)
    kp = require_launch(attention_report(
        b, max(sq, 1), skv, h, hkv, d, causal, window, k8.data_ptr() % 16,
        e16_fits)).plan
    bvec, out = _epilogue_operands(q8, requant, b_vec)
    if b == 0 or sq == 0:
        return out
    if RECORDERS:
        note_launch("int_attention", dict(
            b=b, sq=sq, skv=skv, h=h, hkv=hkv, d=d, causal=causal,
            window=window, k_addr=k8.data_ptr(), e16_fits=e16_fits),
            "store" if kp.store_e16 else "recompute", kp.grid, 1, kp.smem)
    args = _abi.MmaAttnArgs(
        q8.data_ptr(), k8.data_ptr(), v8.data_ptr(), _abi.ptr(bvec),
        out.data_ptr(), b, sq, skv, h, hkv, d, int(causal), window,
        int(out.dtype == torch.int8), kp.tiles, int(kp.store_e16),
        int(kp.vec_k), kp.smem, exp16_args(sm), _abi.requant_struct(requant),
        None, None, 0, 0)
    lib = library()
    rc = lib.r8_int_attention_fused(ctypes.byref(args), _abi.stream_of(q8))
    LAUNCHES["int_attention_fused"] += 1
    _abi.check(lib, rc, "int_attention_fused")
    return out


def exp16_division_mismatches(ie, device="cuda") -> int:
    """On the card: how many n of exp16's whole division domain [0,
    z_max * q_ln2] (of the i-exp plan ``ie``) the multiply-high of K5 and
    K8 divides differently from ``/``."""
    from repro_torch.kernels import _abi
    from repro_torch.kernels._build import library
    n_max = ie.z_max * ie.q_ln2
    magic, shift = exp16_divisor(ie.q_ln2, n_max)
    bad = torch.zeros(1, dtype=torch.int32, device=device)
    lib = library()
    rc = lib.r8_exp16_div_check(n_max, ie.q_ln2, magic, shift,
                                bad.data_ptr(), _abi.stream_of(bad))
    _abi.check(lib, rc, "exp16 division check")
    return int(bad.item())


# ------------------------------------------------------------------ K4 ----

def int_paged_prefill_plain(q8, k_pool, v_pool, plan, pos_end, pages,
                            page_size: int, requant=None, b_vec=None,
                            wo=None, wo_spec=None, kv_shifts=None):
    """The plain version of K4, and of K3: a chunk over pools that hold
    its K/V is stepped-mask decode with ``valid_len = pos_end``.  Packed
    int4 pools (``kv_shifts``) are dequantized first
    (``ops.packed.unpack_kv_pool``, the reference's declared dequant
    reference)."""
    requant, wo = epilogue_setup(requant, plan, wo, wo_spec)
    if kv_shifts is not None:
        k_pool = unpack_kv_pool(k_pool, kv_shifts[0])
        v_pool = unpack_kv_pool(v_pool, kv_shifts[1])
    return _ref.ref_int_paged_decode_attention(
        q8, k_pool, v_pool, plan, pos_end, pages, page_size,
        requant=requant, b_vec=b_vec, wo=wo, wo_spec=wo_spec)


def k4_launch_plan(b: int, c: int, h: int, hkv: int, d: int,
                   max_pages: int, page_size: int, k_addr: int,
                   e16_fits: bool = True, packed: bool = False) -> K5Plan:
    """The K4 launch (K5's blocks) of a ``(B, C, H, D)`` chunk over pools of ``Hkv`` KV
    heads and a ``(B, max_pages)`` table of ``page_size``-row pages, K at
    address ``k_addr``: from shapes only, never from ``pos_end``, which
    lives on the card (the kernel reads it and walks only its rows' live
    tiles).  Tiles and the e16 store are sized for the table's whole span
    ``max_pages * page_size``; the store iff e16 fits 16 bits
    (``e16_fits``) and the span fits a block's shared memory; wide copies
    of K iff it is aligned to them (:func:`k_copy_bytes`); never for
    ``packed`` int4 pools, whose K rows go through registers (4 packed
    bytes a load) to be expanded.  Raises for a head dim the kernel is not
    compiled for or a ragged GQA group."""
    require_head_dim("int_paged_prefill", d)
    if hkv <= 0 or h % hkv:
        raise ValueError(f"int_paged_prefill: H={h} is not a multiple of "
                         f"Hkv={hkv}")
    tiles = -(-(max_pages * page_size) // K5_KEYS)
    store = e16_fits and k5_smem_bytes(d, tiles, True) <= K5_SMEM_LIMIT
    return K5Plan((-(-c // K5_ROWS), h, b), tiles,
                  k5_smem_bytes(d, tiles, store), store,
                  not packed and k_copy_bytes(d, k_addr) > 4)


def k4_args(q8, k_pool, v_pool, plan, pos_end, pages, page_size: int,
            requant, b_vec, kv_shifts=None):
    """Check the operands and the contract (``analysis.contracts.
    prefill_report``: :func:`k4_launch_plan`) and pack one K4 launch, on
    the host alone: ``(args, out, K5Plan)``.  ``pos_end``, ``pages`` and
    the shifts of packed pools (``kv_shifts``) travel as device pointers
    and are never read here."""
    from repro_torch.kernels import _abi
    pages, pos_end, shifts = paged_operands(q8, k_pool, v_pool, pos_end,
                                            pages, page_size, kv_shifts)
    b, c, h, d = q8.shape
    hkv, maxp = k_pool.shape[2], pages.shape[1]
    sm = plan.sm
    kp = require_launch(prefill_report(
        b, max(c, 1), h, hkv, d, maxp, page_size, shifts is not None,
        k_pool.shape[0], k_pool.data_ptr() % 16, e16_fits_16_bits(sm))).plan
    bvec, out = _epilogue_operands(q8, requant, b_vec)
    k_shift, v_shift = shifts if shifts is not None else (None, None)
    args = _abi.MmaAttnArgs(
        q8.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), _abi.ptr(bvec),
        out.data_ptr(), b, c, maxp * page_size, h, hkv, d, 0, 0,
        int(out.dtype == torch.int8), kp.tiles, int(kp.store_e16),
        int(kp.vec_k), kp.smem, exp16_args(sm), _abi.requant_struct(requant),
        pages.data_ptr(), pos_end.data_ptr(), page_size, maxp,
        _abi.ptr(k_shift), _abi.ptr(v_shift))
    # the pointers must outlive the launch
    args._keep = (pages, pos_end, bvec, shifts)
    return args, out, kp


def k4_launch(q8, k_pool, v_pool, plan, pos_end, pages, page_size: int,
              requant, b_vec, kv_shifts=None):
    """One K4 launch on the card (counted in ``LAUNCHES``: packed int4
    pools under ``int_paged_prefill_kv4``); returns the ``(B, C, H, D)``
    attention tile."""
    from repro_torch.kernels import _abi
    from repro_torch.kernels._build import library
    args, out, kp = k4_args(q8, k_pool, v_pool, plan, pos_end, pages,
                            page_size, requant, b_vec, kv_shifts)
    if out.numel() == 0:
        return out
    if RECORDERS:
        note_launch("int_paged_prefill", dict(
            b=args.B, c=args.Sq, h=args.H, hkv=args.Hkv, d=args.D,
            max_pages=args.max_pages, page_size=page_size,
            kv_pack=kv_shifts is not None, num_pages=k_pool.shape[0],
            k_addr=k_pool.data_ptr(), e16_fits=e16_fits_16_bits(plan.sm)),
            "store" if args.store_e16 else "recompute", kp.grid, 1,
            args.smem)
    lib = library()
    rc = lib.r8_int_paged_prefill(ctypes.byref(args), _abi.stream_of(q8))
    LAUNCHES["int_paged_prefill" if kv_shifts is None
             else "int_paged_prefill_kv4"] += 1
    _abi.check(lib, rc, "int_paged_prefill")
    return out


def int_paged_prefill_fused(q8, k_pool, v_pool, plan, pos_end, pages,
                            page_size: int, requant=None, b_vec=None,
                            wo=None, wo_spec=None, kv_shifts=None):
    """q8 (B, C, H, D) int8 chunk queries; pools ``(num_pages, page_size,
    Hkv, D)`` int8 *already holding the chunk's K/V*
    (``ops.paged.scatter_chunk``); ``pos_end`` (B,) = base_pos + C;
    ``pages`` (B, max_pages) int32.  Chunk row ``i`` attends to logical
    positions ``<= pos_end - C + i``.

    ``kv_shifts``: a ``(k_shift, v_shift)`` pair of int32 ``(num_pages,)``
    per-page shifts switches the pools to the packed int4 layout
    ``(num_pages, page_size, Hkv, D // 2)`` (``ops.packed``), expanded
    inside the kernel; packed pages never exist as int8 in device memory.

    ``requant``/``b_vec``: the attention epilogue (default: the plan's
    per-tensor ``dn_out``).  ``wo``/``wo_spec``: fold the o-projection in;
    the return becomes ``(B, C, N)``.  Returns (B, C, H, D) otherwise.
    CPU tensors take the plain version; CUDA tensors launch the
    tensor-core kernel (:func:`k4_launch_plan`; and, folded, one K1
    launch) or raise."""
    if not q8.is_cuda:
        return int_paged_prefill_plain(q8, k_pool, v_pool, plan, pos_end,
                                       pages, page_size, requant, b_vec, wo,
                                       wo_spec, kv_shifts)
    requant, wo = epilogue_setup(requant, plan, wo, wo_spec)
    o = k4_launch(q8, k_pool, v_pool, plan, pos_end, pages, page_size,
                  requant, b_vec, kv_shifts)
    if wo is None:
        return o
    return apply_wo_cuda(o, wo, wo_spec)
