"""K7: row-wise integer softmax (Shiftmax) with a static padding mask.

The port of ``repro/kernels/int_softmax.py::int_softmax_pallas``; the CUDA
kernel is ``csrc/int_softmax.cu``.  :func:`int_softmax_plain` is the plain
PyTorch version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis.budgets import MAX_ROWSUM_LEN
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import ref as _ref

MAX_BLOCK_ROWS = 16      # rows of a CUDA block on the kernel's warp path


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
    plain version; CUDA tensors launch the kernel or raise."""
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
    from repro_torch.kernels import _abi
    from repro_torch.kernels._build import library
    if scores.dtype != torch.int32 or not scores.is_contiguous():
        raise ValueError(f"int_softmax: scores must be a contiguous int32 "
                         f"tensor, got {scores.dtype}")
    out = torch.empty(scores.shape, dtype=torch.int8, device=scores.device)
    rows = scores.numel() // L if L else 0
    if rows == 0:
        return out
    consts = _abi.softmax_consts(plan)
    lib = library()
    rc = lib.r8_int_softmax(scores.data_ptr(), out.data_ptr(), rows, L,
                            int(valid_len), min(block_rows, MAX_BLOCK_ROWS),
                            ctypes.byref(consts), _abi.stream_of(scores))
    LAUNCHES["int_softmax"] += 1
    _abi.check(lib, rc, "int_softmax")
    return out
