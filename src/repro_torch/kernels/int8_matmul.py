"""K1: int8 x int8 -> int32 matmul with the fused requant epilogue, over
dense int8 or packed int4 / MSR-4 weights.

The port of ``repro/kernels/int8_matmul.py::int8_matmul_pallas`` (both its
dense and its ``packed=True`` variant); the CUDA kernels are
``csrc/int8_matmul_decode.cu`` for M <= 16 (decode: a TMA-fed ring, the
int8 tensor cores, K split across a thread block cluster with no
workspace) and ``csrc/int8_matmul.cu`` beyond, the nibble layout a
template argument of both (:func:`launch_plan` chooses).  MSR-4
weights take a raw packed launch plus the outlier-correction kernel of
``csrc/int8_matmul_msr4.cu``, which also runs the staged epilogue (the
split of ``repro/ops/backends/pallas_fused.py:118-134``).  The expert
products of a mixture of experts (the reference's
``repro/models/intlayers.py::int_expert_linear``, an einsum outside any
Pallas kernel) are K1's grouped instantiation, ``csrc/int8_matmul_grouped.cu``
(:func:`int8_matmul_grouped`: every expert in one launch).  Beside each
wrapper its plain PyTorch version with the same arithmetic:
:func:`int8_matmul_plain`, :func:`int8_matmul_nibbles_plain`,
:func:`msr4_correct_plain`, :func:`int8_matmul_packed_plain` and
:func:`int8_matmul_grouped_plain`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.analysis.contracts import (grouped_report, matmul_report,
                                            msr4_report, require_launch)
from repro_torch.core.dyadic import (apply_dyadic, apply_dyadic_perchannel,
                                     clip_to_bits, rshift_round)
from repro_torch.core.intmath import int_einsum
from repro_torch.kernels import LAUNCHES, RECORDERS, note_launch
from repro_torch.kernels import ref as _ref
from repro_torch.ops.packed import (msr4_correction, nibble_unpack,
                                    unpack_weights)
from repro_torch.ops.spec import PER_TENSOR, RequantSpec

#: (BM, BN, BK) of the tensor-core tiles compiled into csrc/int8_matmul.cu
#: by id (M > SMALL_M_MAX); id 0 is the decode tile of
#: csrc/int8_matmul_decode.cu (M <= SMALL_M_MAX, :func:`decode_plan`)
TILES = {1: (64, 128, 64), 2: (128, 128, 64)}
SMALL_M_MAX = 16
#: threads a CTA of the tensor-core tiles (csrc/int8_matmul.cu's
#: ``THREADS``) and of the decode tile
#: (four consumer warps and a producer warp)
MMA_THREADS = 256
DECODE_THREADS = 160

#: the decode tile: rows a block (all of M); the weight tile rows a ring
#: stage (K rows, or byte rows of packed nibbles); the bytes of an x box
#: (16 rows x 128 K); cluster sizes (blocks splitting K)
DECODE_BM = 16
DECODE_ROWS = 128
DECODE_XBOX = DECODE_BM * 128
DECODE_CLUSTERS = (1, 2, 4, 8)
#: the rows of a k32 step that lane t reads for its b0 (b1: ^ 1), plus 8 r
DECODE_ROW_BASE = (0, 4, 3, 7)


def _out_dtype(spec) -> torch.dtype:
    return torch.int32 if spec.is_raw else spec.out_dtype


def _epilogue_plain(acc, spec, b_vec):
    """The RequantSpec epilogue on an int32 accumulator (bias included)."""
    if spec.is_raw:
        return acc
    if spec.kind == PER_TENSOR:
        out = apply_dyadic(acc, spec.dn)
    else:
        out = apply_dyadic_perchannel(acc, b_vec, spec.c, spec.pre)
    return clip_to_bits(out, spec.out_bits).to(spec.out_dtype)


def int8_matmul_plain(x8, w8, spec, bias32=None, b_vec=None):
    """The plain version: exact contraction + the spec's epilogue."""
    return _epilogue_plain(_ref.ref_int8_matmul_raw(x8, w8, bias32), spec,
                           b_vec)


def decode_stages(bn: int) -> int:
    """Stages of the decode tile's ring: 64 KB of weights either way."""
    return 4 if bn == 128 else 8


def decode_k_step(packed: bool) -> int:
    """K a ring stage covers: 128 rows, or 256 for packed nibbles (128
    byte rows)."""
    return 2 * DECODE_ROWS if packed else DECODE_ROWS


def decode_smem(bn: int, packed: bool) -> int:
    """Dynamic shared memory of the decode tile: the ring's weight tiles
    and x boxes, plus 1 KB to align it to 1024 bytes."""
    return (decode_stages(bn) * (DECODE_ROWS * bn
                                 + DECODE_BM * decode_k_step(packed)) + 1024)


def _split_k(tiles: int, k: int, bk: int, sms: int):
    """Split K across blocks until the grid covers the SMs about twice;
    every split keeps at least 4 K-steps.  Returns (splits, k_per_split)."""
    want = max(1, -(-2 * sms // tiles))
    most = max(1, k // (4 * bk))
    splits = min(want, most)
    k_per = -(-k // splits)
    k_per = -(-k_per // bk) * bk
    return -(-k // k_per), k_per


class LaunchPlan(NamedTuple):
    """One K1 launch: the tile (0 the decode tile, else a key of
    :data:`TILES`), the grid ``(N tiles, M tiles, splits)`` (decode: the
    splits are a cluster), the K range of each split, and the alignment
    (bytes) that K or N and the operand's address need for the vector
    copies of x and w (decode: for the TMA route).  Decode only: the
    route (``"tma"``, or ``"copy"`` where a tensor map cannot describe an
    operand), BN, the cluster size and the dynamic shared memory; the
    tensor-core tiles have route ``"mma"``."""
    tile: int
    grid: tuple
    k_per_split: int
    x_align: int
    w_align: int
    route: str = "mma"
    bn: int = 128
    cluster: int = 1
    smem: int = 0


def decode_plan(m: int, n: int, k: int, sms: int, packed: bool = False,
                x_addr: int = 0, w_addr: int = 0) -> LaunchPlan:
    """The decode tile's launch (m <= SMALL_M_MAX) from the shape and the
    operands' addresses alone.

    BN (128 or 64 columns a block) and the cluster size C (1, 2, 4 or 8
    blocks splitting K) give ceil(n / BN) x C blocks: the pair with the
    most blocks that still fit one wave of ``sms`` (one block an SM),
    then the larger BN, then the smaller C; where ceil(n / 128) alone
    fills the wave, BN 128 and C 1.  C never exceeds the K stages.
    Each rank's K range is a whole number of stages (:func:`decode_k_step`
    K); the last rank's may run past K (zero-filled), a rank past K has
    none.  The route is ``"tma"`` where N and K are multiples of 16 and w
    and x are 16-byte aligned (what a tensor map needs), else ``"copy"``
    (the producer warp's masked loads into the same ring).  No route or
    size is chosen from a build or a launch.

    On the H100 (132 SMs): llama3-8b wq / wo (K 4096, N 4096): BN 128, C
    4, 128 blocks; wk / wv (N 1024): BN 64, C 8, 128; w1 / w3 (N 14336):
    BN 128, C 1, 112; w2 (K 14336, N 4096): BN 128, C 4, 128; the head (N
    128256): BN 128, C 1, 1002.  h2o-danube-3-4b (d 3840): wq / wo (N
    3840): BN 128, C 4, 120; wk / wv (N 960, a ragged last tile): BN 64,
    C 8, 120; w1 / w3 (N 10240): BN 128, C 1, 80; w2 (K 10240, N 3840):
    BN 128, C 4, 120; the head (N 32000): BN 128, C 1, 250.  Packed
    weights take the same BN and C (the K stages halve)."""
    bn, c, k_per = _decode_shape(n, k, sms, packed)
    tma = (n % 16 == 0 and k % 16 == 0 and x_addr % 16 == 0
           and w_addr % 16 == 0)
    return LaunchPlan(0, (-(-n // bn), 1, c), k_per, 16, 16,
                      "tma" if tma else "copy", bn, c,
                      decode_smem(bn, packed))


@functools.lru_cache(maxsize=None)
def sm_count(dev) -> int:
    """The SMs of device ``dev`` (a tensor's), cached per device: every
    launch asks, and reading the properties costs the host microseconds."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=4096)
def _decode_shape(n: int, k: int, sms: int, packed: bool):
    """(BN, cluster, K a rank) of :func:`decode_plan`, cached: a decode
    step asks for the same few shapes 225 times."""
    ks = decode_k_step(packed)
    stages = -(-k // ks)
    best = (0, 128, -1)
    if -(-n // 128) < sms:
        for bn in (128, 64):
            for c in DECODE_CLUSTERS:
                blocks = -(-n // bn) * c
                if c <= stages and blocks <= sms:
                    best = max(best, (blocks, bn, -c))
    _, bn, neg_c = best
    return bn, -neg_c, -(-stages // -neg_c) * ks


def launch_plan(m: int, n: int, k: int, sms: int, packed: bool = False,
                x_addr: int = 0, w_addr: int = 0) -> LaunchPlan:
    """The launch of an (m, k) x (k, n) product on a card of ``sms`` SMs:
    the decode tile for m <= SMALL_M_MAX (:func:`decode_plan`; ``packed``
    and the operands' addresses choose its K stages and route), else the
    tensor cores, in 128 x 128 tiles where m > 64 and they fill the card,
    else 64 x 128, K split into a workspace (:func:`_split_k`)."""
    if m <= SMALL_M_MAX:
        return decode_plan(m, n, k, sms, packed, x_addr, w_addr)
    full = -(-m // 128) * -(-n // 128)
    tile = 2 if m > 64 and full >= sms else 1
    bm, bn, bk = TILES[tile]
    gx, gy = -(-n // bn), -(-m // bm)
    splits, k_per = _split_k(gx * gy, k, bk, sms)
    return LaunchPlan(tile, (gx, gy, splits), k_per, 16, 8, "mma", bn)


#: tensor maps by (address, dims, box, swizzle), at most TMAP_CACHE of
#: them: a decode step encodes none twice
TMAP_CACHE = 4096
_TMAPS: dict = {}


def _tensor_map(lib, t, dims: tuple, box: tuple, swizzle: int):
    """The 128-byte TMA descriptor of ``t`` as a 2-D or 3-D int8 array of
    ``dims`` (innermost first) in boxes of ``box`` (the inner two; 1 along
    a third), from the cache or encoded (``cuTensorMapEncodeTiled``)."""
    key = (t.data_ptr(), dims, box, swizzle)
    buf = _TMAPS.get(key)
    if buf is None:
        buf = ctypes.create_string_buffer(128)
        if len(dims) == 2:
            rc = lib.r8_tensor_map_2d(buf, t.data_ptr(), *dims, *box,
                                      swizzle)
        else:
            rc = lib.r8_tensor_map_3d(buf, t.data_ptr(), *dims, *box,
                                      swizzle)
        if rc:
            raise RuntimeError(f"cuTensorMapEncodeTiled failed ({rc}) for "
                               f"dims {dims}, box {box}")
        if len(_TMAPS) >= TMAP_CACHE:
            _TMAPS.pop(next(iter(_TMAPS)))
        _TMAPS[key] = buf
    return buf


def _check(what, dev, **tensors) -> None:
    """Device, dtype, contiguity and shape of a launch's operands: ``name:
    (tensor or None, dtype, shape or None)``."""
    for name, (t, dt, shape) in tensors.items():
        if t is None:
            continue
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dt} "
                             f"tensor on {dev}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != "
                             f"{shape}")


def _launch(what, x8, w, spec, bias32, b_vec, packed: bool):
    """One K1 launch of x8 (M, K) against ``w``: int8 (K, N), or with
    ``packed`` its (K / 2, N) nibble pairs."""
    from repro_torch.kernels import _abi
    from repro_torch.kernels._build import library
    m, k = x8.shape
    if w.dim() != 2 or k != (2 if packed else 1) * w.shape[0]:
        raise ValueError(f"{what}: x {tuple(x8.shape)} vs w "
                         f"{tuple(w.shape)}{' (packed)' if packed else ''}")
    n = w.shape[1]
    _check(what, x8.device, x8=(x8, torch.int8, None),
           w=(w, torch.int8, None),
           bias32=(bias32, torch.int32, (n,)), b_vec=(b_vec, torch.int32,
                                                     (n,)))
    if not spec.is_raw and spec.kind != PER_TENSOR and b_vec is None:
        raise ValueError("per-channel RequantSpec needs the b_vec "
                         "multiplier vector")
    dt = _out_dtype(spec)
    out = torch.empty((m, n), dtype=dt, device=x8.device)
    if m == 0 or n == 0:
        return out
    sms = sm_count(x8.device)
    plan = require_launch(matmul_report(m, n, k, packed, sms,
                                        x8.data_ptr() % 16,
                                        w.data_ptr() % 16)).plan
    rq = _abi.requant_struct(spec)
    lib = library()
    bvec = b_vec if spec.kind != PER_TENSOR else None
    if RECORDERS:
        note_launch(what, dict(m=m, n=n, k=k, sms=sms, x_addr=x8.data_ptr(),
                               w_addr=w.data_ptr()),
                    plan.route if plan.tile == 0
                    else f"mma{TILES[plan.tile][0]}", plan.grid,
                    plan.cluster, plan.smem)
    if plan.tile == 0:
        _decode_launch(what, lib, plan, x8, w, bias32, bvec, rq, out, dt,
                       packed)
        return out
    gx, gy, splits = plan.grid
    ws = cnt = None
    if splits > 1:
        ws = torch.zeros((m, n), dtype=torch.int32, device=x8.device)
        cnt = torch.zeros((gx * gy,), dtype=torch.int32, device=x8.device)
    vec_x = int(k % plan.x_align == 0 and x8.data_ptr() % plan.x_align == 0)
    vec_w = int(n % plan.w_align == 0 and w.data_ptr() % plan.w_align == 0)
    rc = lib.r8_int8_matmul(
        x8.data_ptr(), w.data_ptr(), _abi.ptr(bias32), _abi.ptr(bvec),
        ctypes.byref(rq),
        out.data_ptr(), int(dt == torch.int8), m, n, k, plan.tile, splits,
        plan.k_per_split, _abi.ptr(ws), _abi.ptr(cnt), vec_x, vec_w,
        int(packed), _abi.stream_of(x8))
    LAUNCHES[what] += 1
    _abi.check(lib, rc, what)
    return out


def _decode_launch(what, lib, plan, x8, w, bias32, bvec, rq, out, dt,
                   packed) -> None:
    """One launch of the decode tile by ``plan``: no workspace, one
    kernel.  The TMA route passes the (cached) tensor maps of w (its rows
    in boxes of 128 x BN bytes) and x (16 x 128 bytes); the copy route
    none."""
    from repro_torch.kernels import _abi
    m, k = x8.shape
    n = w.shape[1]
    wmap = xmap = None
    if plan.route == "tma":
        wmap = _tensor_map(lib, w, (n, w.shape[0]), (plan.bn, DECODE_ROWS),
                           plan.bn)
        xmap = _tensor_map(lib, x8, (k, m), (128, DECODE_BM), 128)
    args = _abi.DecodeArgs(
        x8.data_ptr(), w.data_ptr(), _abi.ptr(bias32), _abi.ptr(bvec),
        out.data_ptr(), rq, int(dt == torch.int8), m, n, k,
        plan.k_per_split, int(plan.route == "tma"),
        int(k % 4 == 0 and x8.data_ptr() % 4 == 0),
        int(n % 4 == 0 and w.data_ptr() % 4 == 0))
    rc = lib.r8_int8_matmul_decode(ctypes.byref(args), wmap, xmap, plan.bn,
                                   plan.cluster, int(packed),
                                   _abi.stream_of(x8))
    LAUNCHES[what] += 1
    _abi.check(lib, rc, what)


def int8_matmul(x8, w8, spec, bias32=None, b_vec=None):
    """x8 (M, K) int8 @ w8 (K, N) int8 -> (M, N) with the ``spec``
    epilogue: int32 for raw, else clipped to ``spec.out_bits`` in
    ``spec.out_dtype``.  ``b_vec`` (N,) int32 is required iff per-channel.

    CPU tensors take :func:`int8_matmul_plain`; CUDA tensors launch the
    kernel (ragged M, N, K masked in-kernel; :func:`launch_plan` through
    the contract ``analysis.contracts.matmul_report``) or raise."""
    if not x8.is_cuda:
        return int8_matmul_plain(x8, w8, spec, bias32, b_vec)
    return _launch("int8_matmul", x8, w8, spec, bias32, b_vec, packed=False)


# ------------------------------------------------------ packed weights --

def int8_matmul_nibbles_plain(x8, w_packed, spec, bias32=None, b_vec=None):
    """The plain version of K1's packed launch: the nibbles expanded
    (``ops.packed.nibble_unpack``), then :func:`int8_matmul_plain`."""
    w = nibble_unpack(w_packed, axis=-2).to(torch.int8)
    return int8_matmul_plain(x8, w, spec, bias32, b_vec)


def int8_matmul_nibbles(x8, w_packed, spec, bias32=None, b_vec=None):
    """K1 over int4 nibble pairs ``w_packed`` (K / 2, N) (two's
    complement, K row 2i in the low nibble of byte row i), expanded in
    the kernel's weight loads; otherwise :func:`int8_matmul`.  Outlier
    lanes are not applied here (:func:`msr4_correct`)."""
    if not x8.is_cuda:
        return int8_matmul_nibbles_plain(x8, w_packed, spec, bias32, b_vec)
    return _launch("int8_matmul_packed", x8, w_packed, spec, bias32, b_vec,
                   packed=True)


#: the gather route: columns a block of the correction kernel; rows a
#: block (MT) by the size of the product; bytes of x a block stages at a
#: time, as whole groups; the shared memory a block may take (H100)
MSR4_THREADS = 128
MSR4_MMA_THREADS = 256
MSR4_CHUNK = 16384
MSR4_MAX_SMEM = 232448

#: the tensor-core route (``MSR4_MMA_THREADS`` a CTA): columns a block; K
#: rows a step takes at least
#: (whole groups: max(1, 64 // g) of them); lane rows a staged chunk at
#: most; bytes a staged lane row (int16 index + int8 delta, 128 columns);
#: slots of the copy ring (lane chunks and x tiles)
MSR4_BN = 128
MSR4_STEP = 64
MSR4_LANE_CHUNK = 64
MSR4_LANE_ROW = 3 * MSR4_BN
MSR4_STAGES = 2


class Msr4Plan(NamedTuple):
    """One correction launch: the route (``"mma"``, the tensor cores over
    a dense delta tile, or ``"gather"``), rows a block (``mt``), the grid
    ``(M tiles, N tiles, splits)``, the K groups of a split, the K rows of
    a staged chunk of x (gather) or of a step (mma), whole groups either
    way, the shared-memory bytes, and (mma) the lane rows of a staged
    chunk and the rows of the step's delta tile (``kc`` up to 32)."""
    route: str
    mt: int
    grid: tuple
    groups_per_split: int
    kc: int
    smem: int
    lc: int = 0
    sp: int = 0


def msr4_gather_plan(m: int, n: int, k: int, g: int, n_out: int,
                     sms: int) -> Msr4Plan:
    """The gather route's launch for an (m, k) product with groups of
    ``g`` rows and ``n_out`` lanes: 4 rows a block for decode (M <= 4),
    else 16 (where 16 rows of a group fit the shared memory); the K groups
    split across blocks until the grid covers the SMs about eight blocks
    deep (each split keeps at least 4 groups)."""
    ngrp = k // g
    mt = 4 if m <= 4 or 16 * g > MSR4_MAX_SMEM else 16
    gx, gy = -(-m // mt), -(-n // MSR4_THREADS)
    want = max(1, -(-8 * sms // (gx * gy)))
    splits = min(want, max(1, ngrp // 4)) if n_out else 1
    gps = -(-ngrp // splits)
    splits = -(-ngrp // gps)
    gpc = max(1, min(gps, MSR4_CHUNK // (g * mt)))
    kc = gpc * g
    return Msr4Plan("gather", mt, (gx, gy, splits), gps, kc,
                    -(-kc * mt // 16) * 16)


def msr4_mma_smem(bm: int, sp: int, lc: int) -> int:
    """Shared-memory bytes of the tensor-core route: a ring of
    ``MSR4_STAGES`` lane chunks and as many x tiles (rows of sp + 16
    bytes), and 2 delta tiles."""
    return (MSR4_STAGES * (MSR4_LANE_ROW * lc + bm * (sp + 16))
            + 2 * sp * MSR4_BN)


def msr4_lane_chunk(bm: int, sp: int, lanes: int) -> int:
    """Lane rows a staged chunk: ``MSR4_LANE_CHUNK`` (no more than a
    step's ``lanes``), halved down to 16 while the step does not fit the
    shared memory."""
    lc = MSR4_LANE_CHUNK
    while lc > 16 and msr4_mma_smem(bm, sp, lc) > MSR4_MAX_SMEM:
        lc //= 2
    return max(1, min(lanes, lc))


def msr4_plan(m: int, n: int, k: int, g: int, n_out: int,
              sms: int) -> Msr4Plan:
    """The correction's launch for an (m, k) product with groups of ``g``
    rows and ``n_out`` lanes on a card of ``sms`` SMs, from the shape
    alone.

    The rule: the tensor-core route wherever a step fits the shared
    memory (:func:`msr4_mma_smem` <= ``MSR4_MAX_SMEM``), else the gather
    route (:func:`msr4_gather_plan`).  A step is max(1, 64 // g) whole
    groups (kc rows, its delta tile sp = kc rounded up to 32 rows), its
    lanes staged in chunks of :func:`msr4_lane_chunk` rows.  Rows
    a block: 16 for m <= 16, 64 for m <= 64, else 128 (the lanes, 3 bytes
    a weight, are read once per row tile, so the fewest row tiles), or
    the next smaller tile where that one does not fit.  K splits across
    blocks until the grid covers the SMs about 8 blocks deep with 16-row
    tiles (decode), or up to one wave of 2 blocks an SM with larger tiles
    (there a split's atomics cost more than the blocks it adds), each
    split keeping at least 2 steps; no lanes (n_out 0): one split, no
    steps."""
    ngrp = k // g
    gps = max(1, MSR4_STEP // g)
    kc = gps * g
    sp = -(-kc // 32) * 32
    first = 16 if m <= 16 else 64 if m <= 64 else 128
    for bm in (b for b in (128, 64, 16) if b <= first):
        lc = msr4_lane_chunk(bm, sp, gps * n_out)
        smem = msr4_mma_smem(bm, sp, lc)
        if smem <= MSR4_MAX_SMEM:
            break
    else:
        return msr4_gather_plan(m, n, k, g, n_out, sms)
    gx, gy = -(-m // bm), -(-n // MSR4_BN)
    steps = -(-ngrp // gps)
    if bm == 16:
        want = -(-8 * sms // (gx * gy))
    else:                          # 2 blocks an SM (128 registers a thread)
        want = max(1, 2 * sms // (gx * gy))
    splits = min(want, max(1, steps // 2)) if n_out else 1
    sps = -(-steps // splits)
    splits = -(-steps // sps)
    return Msr4Plan("mma", bm, (gx, gy, splits), sps * gps, kc, smem, lc, sp)


def msr4_correct_plain(acc, x8, qw, spec):
    """The plain version of the correction kernel: ``acc`` (the raw
    nibble accumulator, no bias) + ``ops.packed.msr4_correction`` + the
    bias, then the spec's epilogue."""
    acc = acc + msr4_correction(x8.to(torch.int32), qw)
    if qw.bias32 is not None:
        acc = acc + qw.bias32.to(torch.int32)[None, :]
    return _epilogue_plain(acc, spec, qw.b_mult)


def msr4_correct(acc, x8, qw, spec):
    """The MSR-4 outlier correction and the staged epilogue: ``acc`` (M,
    N) int32, the raw nibble accumulator of :func:`int8_matmul_nibbles`
    (no bias), plus ``x8 @ scatter(out_val)`` over the lanes of the 2-D
    packed ``qw``, plus its bias, then the spec's epilogue (a new
    tensor; ``acc`` is only read).  A lane index outside [0, g) adds
    nothing.

    Precondition: within a group, a column's lanes whose index lies in
    [0, g) name distinct rows (the tensor-core route builds a dense delta
    tile with one delta per row and column).  ``quant.pack.pack_msr4``
    and the reference's guarantee it (a stable-sort prefix), and
    ``interop.qparams_from_reference`` checks it once per leaf; no call
    checks it.  The route is :func:`msr4_plan`'s, from the shape, through
    the contract (``analysis.contracts.msr4_report``)."""
    if not x8.is_cuda:
        return msr4_correct_plain(acc, x8, qw, spec)
    meta = qw.pack_meta
    m, k = x8.shape
    n = qw.n_dim
    if meta is None or meta.scheme != "msr4" or meta.k != k \
            or tuple(acc.shape) != (m, n) or qw.w_packed.dim() != 2:
        raise ValueError(f"msr4_correct: acc {tuple(acc.shape)}, x "
                         f"{tuple(x8.shape)} vs a 2-D msr4 weight of k="
                         f"{getattr(meta, 'k', None)}, n={n}")
    sms = sm_count(x8.device)
    plan = require_launch(msr4_report(m, n, k, meta.group, meta.n_outliers,
                                      sms)).plan
    if RECORDERS:
        note_launch("int8_matmul_msr4", dict(
            m=m, n=n, k=k, group=meta.group, n_out=meta.n_outliers,
            sms=sms), plan.route, plan.grid, 1, plan.smem)
    return _msr4_launch(acc, x8, qw, spec, plan)


def _msr4_launch(acc, x8, qw, spec, plan: Msr4Plan):
    """One correction launch by ``plan`` (either route), counted in
    ``LAUNCHES["int8_matmul_msr4"]``.  :func:`msr4_correct` passes
    :func:`msr4_plan`'s; a measurement may pass
    :func:`msr4_gather_plan`'s to time the gather route at the same
    shape."""
    from repro_torch.kernels import _abi
    from repro_torch.kernels._build import library
    meta = qw.pack_meta
    m, k = x8.shape
    n = qw.n_dim
    g, n_out = meta.group, meta.n_outliers
    lanes = (k // g, n_out, n)
    _check("msr4_correct", x8.device, acc=(acc, torch.int32, (m, n)),
           x8=(x8, torch.int8, None),
           out_idx=(qw.out_idx, torch.int16, lanes),
           out_val=(qw.out_val, torch.int8, lanes),
           bias32=(qw.bias32, torch.int32, (n,)),
           b_vec=(qw.b_mult, torch.int32, (n,)))
    if not spec.is_raw and spec.kind != PER_TENSOR and qw.b_mult is None:
        raise ValueError("per-channel RequantSpec needs the b_vec "
                         "multiplier vector")
    dt = _out_dtype(spec)
    out = torch.empty((m, n), dtype=dt, device=x8.device)
    if m == 0 or n == 0:
        return out
    gx, gy, splits = plan.grid
    ws = cnt = None
    if splits > 1:
        ws = torch.zeros((m, n), dtype=torch.int32, device=x8.device)
        cnt = torch.zeros((gx * gy,), dtype=torch.int32, device=x8.device)
    args = (acc.data_ptr(), x8.data_ptr(), _abi.ptr(qw.out_idx),
            _abi.ptr(qw.out_val), _abi.ptr(qw.bias32),
            _abi.ptr(qw.b_mult if spec.kind != PER_TENSOR else None),
            out.data_ptr(), _abi.ptr(ws), _abi.ptr(cnt), m, n, k, g, n_out,
            int(dt == torch.int8), plan.groups_per_split, plan.kc,
            _abi.requant_struct(spec))
    lib = library()
    if plan.route == "mma":
        args = _abi.Msr4MmaArgs(
            *args, plan.lc, plan.sp,
            int(k % 16 == 0 and plan.kc % 16 == 0
                and x8.data_ptr() % 16 == 0),
            int(n % 8 == 0 and qw.out_idx.data_ptr() % 16 == 0),
            int(n % 16 == 0 and qw.out_val.data_ptr() % 16 == 0))
        launch = lib.r8_int8_matmul_msr4_mma
    else:
        args = _abi.Msr4Args(*args)
        launch = lib.r8_int8_matmul_msr4
    rc = launch(ctypes.byref(args), plan.mt, splits, plan.smem,
                _abi.stream_of(x8))
    LAUNCHES["int8_matmul_msr4"] += 1
    _abi.check(lib, rc, "int8_matmul_msr4")
    return out


def int8_matmul_packed_plain(x8, qw, spec):
    """The plain version of :func:`int8_matmul_packed`: the dense weights
    reconstructed (``ops.packed.unpack_weights``), then
    :func:`int8_matmul_plain`."""
    return int8_matmul_plain(x8, unpack_weights(qw), spec, qw.bias32,
                             qw.b_mult)


def int8_matmul_packed(x8, qw, spec):
    """x8 (M, K) int8 @ a 2-D packed ``QuantLinearParams`` -> (M, N) with
    the ``spec`` epilogue (its ``bias32`` / ``b_mult`` as on the dense
    path); the dense weights never exist on the card.

    Plain int4 (or msr4 without lanes): one K1 launch over the nibbles
    with the fused epilogue.  MSR-4: a raw K1 launch over the nibbles,
    then the correction kernel adds the lanes, the bias and the epilogue;
    integer addition mod 2^32 is associative, so the result equals the
    dense product's bit for bit.  CPU tensors take
    :func:`int8_matmul_packed_plain`."""
    if not x8.is_cuda:
        return int8_matmul_packed_plain(x8, qw, spec)
    meta = qw.pack_meta
    if meta.scheme != "msr4" or not meta.n_outliers:
        return int8_matmul_nibbles(x8, qw.w_packed, spec, qw.bias32,
                                   qw.b_mult)
    acc = int8_matmul_nibbles(x8, qw.w_packed, RequantSpec.raw())
    return msr4_correct(acc, x8, qw, spec)


# -------------------------------------------------- grouped (experts) --

#: the grouped instantiation (csrc/int8_matmul_grouped.cu): columns an
#: item; K rows a ring stage and the ring's stages; rows of the decode
#: path (R <= 16, K split across a cluster) and its cluster sizes; the row
#: tiles of R > 16 (six consumer warps, 1, 2 or 4 m16 tiles a warp);
#: experts a call of the plain version
GROUPED_BN = 128
GROUPED_KS = 128
GROUPED_STAGES = 5
GROUPED_DECODE_R = 16
GROUPED_CLUSTERS = (1, 2)
GROUPED_ROW_TILES = (48, 96, 192)
GROUPED_PLAIN_SLICE = 16
#: the decode path's exchange buffers (two of 8 lane pairs x 8 rows x 8
#: int4)
GROUPED_XCHG = 2 * 8 * 8 * 8 * 16


class GroupedPlan(NamedTuple):
    """One launch of K1's grouped instantiation, from the shape alone
    (never from ``rows``: each block reads the counts on the card, finds
    the live items and strides over them): the route (``"tma"``, or
    ``"copy"`` where a tensor map cannot describe an operand), the row
    tile ``rt`` (16: decode, else a :data:`GROUPED_ROW_TILES`), the
    cluster, the grid ``(blocks, 1, 1)``, the threads and the dynamic
    shared memory of a block."""
    route: str
    rt: int
    cluster: int
    grid: tuple
    threads: int
    smem: int


def grouped_row_tile(r: int) -> int:
    """Rows a chunk: 16 for r <= 16, else the smallest row tile that holds
    r rows (192 beyond: longer R loops over chunks)."""
    if r <= GROUPED_DECODE_R:
        return GROUPED_DECODE_R
    return next((t for t in GROUPED_ROW_TILES if t >= r),
                GROUPED_ROW_TILES[-1])


def grouped_threads(rt: int) -> int:
    """Consumer warps (1 or 3 along M x 2 along N) and the producer."""
    return 32 * (2 * (1 if rt == GROUPED_DECODE_R else 3) + 1)


def grouped_smem(rt: int, e: int) -> int:
    """Dynamic shared memory: the ring (a 128 x 128 weight tile and an rt x
    128 x box a stage), decode's exchange buffers, each consumer warp's 64
    epilogue columns of bias and multipliers (512 bytes), two ints an
    expert (its count and the live list), plus 1 KB to align the ring."""
    ring = GROUPED_STAGES * (GROUPED_KS * GROUPED_BN + rt * 128)
    consumers = grouped_threads(rt) // 32 - 1
    return (1024 + ring + (GROUPED_XCHG if rt == GROUPED_DECODE_R else 0)
            + 512 * consumers + 8 * e)


def _split_ok(c: int, stages: int) -> bool:
    """c ranks may split ``stages`` ring stages: two a rank on average,
    none left empty."""
    return 2 * c <= stages and (c - 1) * -(-stages // c) < stages


def grouped_plan(e: int, r: int, n: int, k: int, sms: int,
                 x_addr: int = 0, w_addr: int = 0) -> GroupedPlan:
    """The grouped launch of ``e`` experts of ``r`` rows each against (K,
    ``n``) weights on a card of ``sms`` SMs.

    The work is (live expert, 128-column tile) items, which the kernel
    finds on the card; the grid is one wave of blocks (one an SM), no
    more than the items there would be if every expert got rows.  R <= 16: clusters of C ranks, the largest of
    :data:`GROUPED_CLUSTERS` that could split K (:func:`_split_ok`); the
    card's own choice of the split (:func:`grouped_split`) spreads the
    live items over no more than the grid's blocks.  Every qwen2-moe,
    qwen3-moe and jamba expert product takes C 2 on 66 clusters (clusters
    of 4 leave SMs idle: the card cannot place 33 of them one block an
    SM).  R > 16:
    no cluster, the row tile of :func:`grouped_row_tile`.  The route is
    ``"tma"`` where N and K are multiples of 16 and x and w 16-byte
    aligned, else ``"copy"``."""
    rt = grouped_row_tile(r)
    stages = -(-k // GROUPED_KS)
    c = 1
    if rt == GROUPED_DECODE_R:
        c = max(cl for cl in GROUPED_CLUSTERS
                if cl == 1 or _split_ok(cl, stages))
    clusters = max(1, min(sms // c, e * -(-n // GROUPED_BN)))
    tma = (n % 16 == 0 and k % 16 == 0 and x_addr % 16 == 0
           and w_addr % 16 == 0)
    return GroupedPlan("tma" if tma else "copy", rt, c,
                       (clusters * c, 1, 1), grouped_threads(rt),
                       grouped_smem(rt, e))


def grouped_items(n: int, rows) -> int:
    """The (live expert, N tile) items for expert counts ``rows`` (host
    ints): the work the launch's blocks stride over."""
    return -(-n // GROUPED_BN) * sum(int(c) > 0 for c in rows)


def grouped_split(plan: GroupedPlan, k: int, items: int) -> tuple:
    """What each block of ``plan``'s launch chooses on the card for
    ``items`` live items (the kernel's own rule, for the tests and the
    chip's rows): the ranks S that split an item's K, the largest power of
    two up to the cluster with items x S no more than the grid's blocks
    that :func:`_split_ok` allows (1 on the row tiles); each rank's K range;
    and the rounds of items a cluster takes.  Returns (S, K a rank,
    rounds)."""
    stages = -(-k // GROUPED_KS)
    split, c2 = 1, 2
    while plan.rt == GROUPED_DECODE_R and c2 <= plan.cluster:
        if items * c2 <= plan.grid[0] and _split_ok(c2, stages):
            split = c2
        c2 *= 2
    workers = plan.grid[0] // split
    return split, -(-stages // split) * GROUPED_KS, -(-items // workers)


def int8_matmul_grouped_plain(x8, w8, rows, spec, bias32=None, b_vec=None):
    """The plain version of :func:`int8_matmul_grouped`, as the
    reference's ``int_expert_linear`` computes it: each expert's exact
    contraction (``core.intmath.int_einsum``: float64 holds every partial
    sum exactly; the int32 accumulator wraps as the reference's),
    ``GROUPED_PLAIN_SLICE`` experts a call, plus expert e's bias row, then
    ``rshift_round(rshift_round(acc, pre) * b_vec[e], c - pre)`` clipped
    (a per-tensor or raw spec as K1's).  Every row is computed, also past
    ``rows[e]``."""
    e = x8.shape[0]
    out = torch.empty((e, x8.shape[1], w8.shape[2]), dtype=_out_dtype(spec),
                      device=x8.device)
    for i in range(0, e, GROUPED_PLAIN_SLICE):
        sl = slice(i, i + GROUPED_PLAIN_SLICE)
        acc = int_einsum("erk,ekn->ern", x8[sl], w8[sl])
        if bias32 is not None:
            acc = acc + bias32[sl, None, :]
        if spec.is_raw or spec.kind == PER_TENSOR:
            out[sl] = _epilogue_plain(acc, spec, None)
        else:
            acc = rshift_round(rshift_round(acc, spec.pre)
                               * b_vec[sl, None, :], spec.c - spec.pre)
            out[sl] = clip_to_bits(acc, spec.out_bits)
    return out


def int8_matmul_grouped(x8, w8, rows, spec, bias32=None, b_vec=None):
    """Every expert's product in one launch: x8 (E, R, K) int8 @ w8 (E,
    K, N) int8 -> (E, R, N) with the ``spec`` epilogue, expert e's
    ``bias32[e]`` / ``b_vec[e]`` rows ((E, N) int32; ``b_vec`` iff
    per-channel).  ``rows`` (E,) int32 on the operands' device: expert
    e's first ``rows[e]`` rows are its tokens; the kernel writes only
    those (the rest of ``out`` is left as allocated).  ``rows`` is read
    on the card, never on the host.

    CPU tensors take :func:`int8_matmul_grouped_plain`; CUDA tensors
    launch ``csrc/int8_matmul_grouped.cu`` once, with no workspace
    (:func:`grouped_plan`, through the contract
    ``analysis.contracts.grouped_report``; the TMA route passes the cached
    3-D tensor maps of w and x) or raise."""
    if not x8.is_cuda:
        return int8_matmul_grouped_plain(x8, w8, rows, spec, bias32, b_vec)
    return _grouped_launch(x8, w8, rows, spec, bias32, b_vec)


def _grouped_launch(x8, w8, rows, spec, bias32, b_vec):
    """The checks and the one launch of :func:`int8_matmul_grouped`."""
    from repro_torch.kernels import _abi
    from repro_torch.kernels._build import library
    what = "int8_matmul_grouped"
    if x8.dim() != 3 or w8.dim() != 3 or x8.shape[0] != w8.shape[0] \
            or x8.shape[2] != w8.shape[1]:
        raise ValueError(f"{what}: x {tuple(x8.shape)} vs w "
                         f"{tuple(w8.shape)}: need (E, R, K) and (E, K, N)")
    e, r, k = x8.shape
    n = w8.shape[2]
    _check(what, x8.device, x8=(x8, torch.int8, None),
           w8=(w8, torch.int8, None), rows=(rows, torch.int32, (e,)),
           bias32=(bias32, torch.int32, (e, n)),
           b_vec=(b_vec, torch.int32, (e, n)))
    if not spec.is_raw and spec.kind != PER_TENSOR and b_vec is None:
        raise ValueError("per-channel RequantSpec needs the b_vec "
                         "multiplier rows")
    dt = _out_dtype(spec)
    out = torch.empty((e, r, n), dtype=dt, device=x8.device)
    if e == 0 or r == 0 or n == 0:
        return out
    sms = sm_count(x8.device)
    plan = require_launch(grouped_report(e, r, n, k, sms,
                                         x8.data_ptr() % 16,
                                         w8.data_ptr() % 16)).plan
    if RECORDERS:
        note_launch(what, dict(e=e, r=r, n=n, k=k, sms=sms,
                               x_addr=x8.data_ptr(), w_addr=w8.data_ptr()),
                    plan.route, plan.grid, plan.cluster, plan.smem)
    lib = library()
    wmap = xmap = None
    if plan.route == "tma":
        wmap = _tensor_map(lib, w8, (n, k, e), (GROUPED_BN, GROUPED_KS), 128)
        xmap = _tensor_map(lib, x8, (k, r, e), (128, plan.rt), 128)
    bvec = b_vec if spec.kind != PER_TENSOR else None
    args = _abi.GroupedArgs(
        x8.data_ptr(), w8.data_ptr(), rows.data_ptr(), _abi.ptr(bias32),
        _abi.ptr(bvec), out.data_ptr(), _abi.requant_struct(spec),
        int(dt == torch.int8), e, r, n, k, plan.cluster,
        int(plan.route == "tma"),
        int(k % 4 == 0 and x8.data_ptr() % 4 == 0),
        int(n % 4 == 0 and w8.data_ptr() % 4 == 0))
    rc = lib.r8_int8_matmul_grouped(ctypes.byref(args), wmap, xmap, plan.rt,
                                    plan.grid[0], plan.smem,
                                    _abi.stream_of(x8))
    LAUNCHES[what] += 1
    _abi.check(lib, rc, what)
    return out
