"""K1: int8 x int8 -> int32 matmul with the fused requant epilogue.

The port of ``repro/kernels/int8_matmul.py::int8_matmul_pallas``; the CUDA
kernel is ``csrc/int8_matmul.cu``.  :func:`int8_matmul_plain` beside it is
the plain PyTorch version with the same arithmetic.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import ref as _ref
from repro_torch.ops.spec import PER_TENSOR

#: (BM, BN, BK) of the tiles compiled into csrc/int8_matmul.cu, by id:
#: 0 the __dp4a tile of M <= SMALL_M_MAX, 1 and 2 the tensor-core tiles
TILES = {0: (4, 256, 64), 1: (64, 128, 64), 2: (128, 128, 64)}
SMALL_M_MAX = 16


def _out_dtype(spec) -> torch.dtype:
    return torch.int32 if spec.is_raw else spec.out_dtype


def int8_matmul_plain(x8, w8, spec, bias32=None, b_vec=None):
    """The plain version: exact contraction + the spec's epilogue."""
    if spec.is_raw:
        return _ref.ref_int8_matmul_raw(x8, w8, bias32)
    if spec.kind == PER_TENSOR:
        out = _ref.ref_int8_matmul(x8, w8, bias32, spec.dn, spec.out_bits)
    else:
        out = _ref.ref_int8_matmul_perchannel(x8, w8, bias32, b_vec, spec.c,
                                              spec.pre, spec.out_bits)
    return out.to(spec.out_dtype)


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
    """One K1 launch: the tile (a key of :data:`TILES`), the grid
    ``(N tiles, M tiles, splits)``, the K range of each split, and the
    alignment (bytes) that K or N and the operand's address need for the
    kernel's vector copies of x and w (else it takes scalar masked
    loads)."""
    tile: int
    grid: tuple
    k_per_split: int
    x_align: int
    w_align: int


def launch_plan(m: int, n: int, k: int, sms: int) -> LaunchPlan:
    """The launch of an (m, k) x (k, n) product on a card of ``sms`` SMs:
    the __dp4a tile for m <= SMALL_M_MAX, else the tensor cores, in
    128 x 128 tiles where m > 64 and they fill the card, else 64 x 128."""
    if m <= SMALL_M_MAX:
        tile = 0
    else:
        full = -(-m // 128) * -(-n // 128)
        tile = 2 if m > 64 and full >= sms else 1
    bm, bn, bk = TILES[tile]
    gx, gy = -(-n // bn), -(-m // bm)
    splits, k_per = _split_k(gx * gy, k, bk, sms)
    x_align, w_align = (4, 4) if tile == 0 else (16, 8)
    return LaunchPlan(tile, (gx, gy, splits), k_per, x_align, w_align)


def int8_matmul(x8, w8, spec, bias32=None, b_vec=None):
    """x8 (M, K) int8 @ w8 (K, N) int8 -> (M, N) with the ``spec``
    epilogue: int32 for raw, else clipped to ``spec.out_bits`` in
    ``spec.out_dtype``.  ``b_vec`` (N,) int32 is required iff per-channel.

    CPU tensors take :func:`int8_matmul_plain`; CUDA tensors launch the
    kernel (ragged M, N, K masked in-kernel) or raise."""
    if not x8.is_cuda:
        return int8_matmul_plain(x8, w8, spec, bias32, b_vec)
    from repro_torch.kernels import _abi
    from repro_torch.kernels._build import library
    m, k = x8.shape
    k2, n = w8.shape
    if k != k2:
        raise ValueError(f"int8_matmul: x {tuple(x8.shape)} vs w "
                         f"{tuple(w8.shape)}")
    for name, t, dt, shape in (("x8", x8, torch.int8, None),
                               ("w8", w8, torch.int8, None),
                               ("bias32", bias32, torch.int32, (n,)),
                               ("b_vec", b_vec, torch.int32, (n,))):
        if t is None:
            continue
        if t.device != x8.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"int8_matmul: {name} must be a contiguous "
                             f"{dt} tensor on {x8.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"int8_matmul: {name} shape {tuple(t.shape)}"
                             f" != {shape}")
    if not spec.is_raw and spec.kind != PER_TENSOR and b_vec is None:
        raise ValueError("per-channel RequantSpec needs the b_vec "
                         "multiplier vector")
    dt = _out_dtype(spec)
    out = torch.empty((m, n), dtype=dt, device=x8.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        raise ValueError("int8_matmul: empty contraction (K == 0)")
    sms = torch.cuda.get_device_properties(x8.device).multi_processor_count
    plan = launch_plan(m, n, k, sms)
    gx, gy, splits = plan.grid
    ws = cnt = None
    if splits > 1:
        ws = torch.zeros((m, n), dtype=torch.int32, device=x8.device)
        cnt = torch.zeros((gx * gy,), dtype=torch.int32, device=x8.device)
    rq = _abi.requant_struct(spec)
    lib = library()
    vec_x = int(k % plan.x_align == 0 and x8.data_ptr() % plan.x_align == 0)
    vec_w = int(n % plan.w_align == 0 and w8.data_ptr() % plan.w_align == 0)
    rc = lib.r8_int8_matmul(
        x8.data_ptr(), w8.data_ptr(), _abi.ptr(bias32),
        _abi.ptr(b_vec if spec.kind != PER_TENSOR else None),
        ctypes.byref(rq),
        out.data_ptr(), int(dt == torch.int8), m, n, k, plan.tile, splits,
        plan.k_per_split, _abi.ptr(ws), _abi.ptr(cnt), vec_x, vec_w,
        _abi.stream_of(x8))
    LAUNCHES["int8_matmul"] += 1
    _abi.check(lib, rc, "int8_matmul")
    return out
