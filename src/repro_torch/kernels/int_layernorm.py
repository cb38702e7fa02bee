"""K2: integer LayerNorm / RMSNorm.

The port of ``repro/kernels/int_layernorm.py::int_layernorm_pallas``; the
CUDA kernel is ``csrc/int_layernorm.cu``.  :func:`int_layernorm_plain` is
the plain PyTorch version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import ref as _ref

MAX_D = 256 * 32        # LN_THREADS * LN_MAX_PER_THREAD in the kernel


def int_layernorm_plain(q, q_gamma, q_beta, plan, out_bits: int = 8):
    return _ref.ref_int_layernorm(q, q_gamma, q_beta, plan, out_bits)


def int_layernorm(q, q_gamma, q_beta, plan, out_bits: int = 8):
    """q (..., d) int32 at plan.s_in -> int32 (..., d) clipped to
    ``out_bits``.  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if not q.is_cuda:
        return int_layernorm_plain(q, q_gamma, q_beta, plan, out_bits)
    from repro_torch.kernels import _abi
    from repro_torch.kernels._build import library
    d = q.shape[-1]
    if d != plan.d or d > MAX_D:
        raise ValueError(f"int_layernorm: row length {d} (plan d={plan.d},"
                         f" kernel max {MAX_D})")
    for name, t in (("q", q), ("q_gamma", q_gamma), ("q_beta", q_beta)):
        if t is None:
            continue
        if t.device != q.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"int_layernorm: {name} must be a contiguous "
                             f"int32 tensor on {q.device}")
    if tuple(q_gamma.shape) != (d,) or \
            (q_beta is not None and tuple(q_beta.shape) != (d,)):
        raise ValueError("int_layernorm: gamma/beta must be (d,)")
    out = torch.empty_like(q)
    rows = q.numel() // d
    if rows == 0:
        return out
    consts = _abi.norm_consts(plan, out_bits)
    lib = library()
    rc = lib.r8_int_layernorm(q.data_ptr(), q_gamma.data_ptr(),
                              _abi.ptr(q_beta), ctypes.byref(consts),
                              out.data_ptr(), rows, _abi.stream_of(q))
    LAUNCHES["int_layernorm"] += 1
    _abi.check(lib, rc, "int_layernorm")
    return out
