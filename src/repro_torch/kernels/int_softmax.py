"""K7: row-wise integer softmax (Shiftmax) with a static padding mask.

The port of ``repro/kernels/int_softmax.py::int_softmax_pallas``; the CUDA
kernel is ``csrc/int_softmax.cu``.  :func:`int_softmax_plain` is the plain
PyTorch version; :func:`launch_plan` the launch the wrapper picks for a
shape.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.analysis.budgets import MAX_ROWSUM_LEN
from repro_torch.analysis.contracts import require_launch, softmax_report
from repro_torch.kernels import LAUNCHES, RECORDERS, note_launch
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.int_attention_fused import exp16_args

# mirrored by csrc/int_softmax.cu (namespace k7)
MAX_L = 1 << 15
WARP_MAX_L = 1024
MAX_BLOCK_ROWS = 16                 # rows of a CTA on the warp route
BLOCK_MAX_THREADS = 1024
WARP_VPT = (1, 2, 4, 8, 16, 32)     # the warp route's instantiations
BLOCK_VPT = (8, 16, 32)             # the block route's
BLOCK_FULL_VPT = 32                 # always on BLOCK_MAX_THREADS threads


class K7Plan(NamedTuple):
    """One K7 launch: ``route`` "warp" (a warp a row, ``rows_per_block``
    rows a CTA) or "block" (a CTA a row); ``vec`` 4 (16-byte loads,
    4-byte stores) or 1; ``vpt`` the values a thread holds of a row (the
    template's VPT); ``valid`` the live positions of a row (``valid_len``
    clipped to ``[0, L]``, L without a mask)."""
    route: str
    vec: int
    vpt: int
    threads: int
    rows_per_block: int
    grid: int
    valid: int

    def describe(self) -> str:
        return (f"{self.route} vec={self.vec} vpt={self.vpt} "
                f"threads={self.threads} rows/cta={self.rows_per_block} "
                f"grid={self.grid} valid={self.valid}")


@functools.lru_cache(maxsize=1024)
def launch_plan(rows: int, L: int, valid_len: int, aligned: bool,
                block_rows: int = 8) -> K7Plan:
    """The K7 launch for ``rows`` rows of ``L`` scores, positions ``>=
    valid_len`` masked (``valid_len < 0``: none); ``aligned``: scores and
    probabilities 16-byte aligned.  Vectors of 4 need that and L % 4 ==
    0.  L <= 1024 takes the warp route with the smallest instantiated VPT
    that holds ceil(L / vec / 32) vectors a lane, ``block_rows`` (at most
    16) rows a CTA; longer rows the block route, the smallest VPT whose
    threads (rounded up to whole warps) fit a CTA of 1024: 544 threads of
    8 at L = 4100; VPT 32 always runs 1024 threads (its stride is a
    constant of the kernel).  ``block_rows`` never changes the
    integers."""
    if not 1 <= L <= MAX_L:
        raise ValueError(f"int_softmax: rows of {L} outside the kernel's "
                         f"1..{MAX_L}")
    if not 1 <= rows < 2 ** 31:
        raise ValueError(f"int_softmax: {rows} rows outside 1..2^31-1")
    if block_rows < 1:
        raise ValueError(f"int_softmax: block_rows must be >= 1, got "
                         f"{block_rows}")
    valid = L if valid_len < 0 else min(valid_len, L)
    vec = 4 if aligned and L % 4 == 0 else 1
    nvec = L // vec
    if L <= WARP_MAX_L:
        need = -(-nvec // 32) * vec
        vpt = next(v for v in WARP_VPT if v >= need and v % vec == 0)
        rpb = min(block_rows, MAX_BLOCK_ROWS)
        return K7Plan("warp", vec, vpt, 32 * rpb, rpb, -(-rows // rpb),
                      valid)
    for vpt in BLOCK_VPT:
        threads = -(-nvec // (vpt // vec))
        threads = -(-threads // 32) * 32
        if threads <= BLOCK_MAX_THREADS:
            if vpt == BLOCK_FULL_VPT:
                threads = BLOCK_MAX_THREADS
            return K7Plan("block", vec, vpt, threads, 1, rows, valid)
    raise AssertionError("unreachable: 1024 threads of 32 hold 2^15")


def int_softmax_plain(scores, plan, valid_len: int = -1, where=None):
    """``core.softmax.i_softmax`` with positions ``>= valid_len`` masked
    (``valid_len < 0``: none) and, with ``where`` (True = attend), the
    oracle's mask as well."""
    if valid_len >= 0:
        live = torch.arange(scores.shape[-1],
                            device=scores.device) < valid_len
        where = live if where is None else where & live
    return _ref.ref_int_softmax(scores, plan, where=where)


def int_softmax(scores, plan, valid_len: int = -1, block_rows: int = 8):
    """scores (..., rows, L) int32 at the plan's score scale -> int8
    probabilities at 2^-7, same shape.  ``valid_len`` >= 0 masks trailing
    positions (a static padding mask).  ``block_rows`` sets the rows of a
    CUDA block (at most 16) and never the integers.  CPU tensors take the
    plain version; CUDA tensors launch the kernel (:func:`launch_plan`
    through the contract ``analysis.contracts.softmax_report``,
    exp16's division a multiply-high: ``exp16_args``, which refuses a plan
    without one, as K3, K4, K5 and K8 do) or raise."""
    if block_rows < 1:
        raise ValueError(f"int_softmax: block_rows must be >= 1, got "
                         f"{block_rows}")
    L = scores.shape[-1]
    if L > MAX_ROWSUM_LEN:
        raise ValueError(f"int_softmax: rows of {L} exceed the "
                         f"{MAX_ROWSUM_LEN} positions an exact int32 row "
                         "sum allows")
    if not scores.is_cuda:
        return int_softmax_plain(scores, plan, valid_len)
    if scores.dtype != torch.int32 or not scores.is_contiguous():
        raise ValueError(f"int_softmax: scores must be a contiguous int32 "
                         f"tensor, got {scores.dtype}")
    out = torch.empty(scores.shape, dtype=torch.int8, device=scores.device)
    rows = scores.numel() // L if L else 0
    if rows == 0:
        return out
    aligned = scores.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    kp = require_launch(softmax_report(rows, L, int(valid_len), aligned,
                                       block_rows)).plan
    if RECORDERS:
        note_launch("int_softmax", dict(
            rows=rows, L=L, valid_len=int(valid_len), aligned=aligned,
            block_rows=block_rows), kp.route, (kp.grid,), 1, 0)
    return _launch(scores, out, kp, exp16_args(plan))


def _launch(scores, out, kp: K7Plan, consts):
    """One K7 launch of plan ``kp`` with exp16's constants ``consts``."""
    from repro_torch.kernels import _abi
    from repro_torch.kernels._build import library
    L = scores.shape[-1]
    lib = library()
    rc = lib.r8_int_softmax(scores.data_ptr(), out.data_ptr(),
                            scores.numel() // L, L, kp.valid,
                            int(kp.route == "warp"), kp.vec, kp.vpt,
                            kp.threads, kp.grid, ctypes.byref(consts),
                            _abi.stream_of(scores))
    LAUNCHES["int_softmax"] += 1
    _abi.check(lib, rc, "int_softmax")
    return out
