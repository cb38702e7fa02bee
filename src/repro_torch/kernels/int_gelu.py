"""K6: elementwise integer i-GELU with its output requant.

The port of ``repro/kernels/int_gelu.py::int_gelu_pallas``; the CUDA
kernel is ``csrc/int_gelu.cu``.  :func:`int_gelu_plain` is the plain
PyTorch version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import ref as _ref

BLOCKS_PER_SM = 8       # grid-stride launch: resident blocks of 256 threads


def int_gelu_plain(q, plan, dn_out, out_bits: int = 8):
    return _ref.ref_int_gelu(q, plan, dn_out, out_bits)


def int_gelu(q, plan, dn_out, out_bits: int = 8):
    """q int32 (any shape) -> int32 of the same shape, clipped to
    ``out_bits``.  ``plan``: an ``IGeluPlan``; ``dn_out``: the output
    Dyadic.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    if not q.is_cuda:
        return int_gelu_plain(q, plan, dn_out, out_bits)
    from repro_torch.kernels import _abi
    from repro_torch.kernels._build import library
    if q.dtype != torch.int32 or not q.is_contiguous():
        raise ValueError(f"int_gelu: q must be a contiguous int32 tensor, "
                         f"got {q.dtype}")
    out = torch.empty_like(q)
    n = q.numel()
    if n == 0:
        return out
    consts = _abi.gelu_consts(plan, dn_out, out_bits)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    blocks = min(-(-n // 256), BLOCKS_PER_SM * sms)
    lib = library()
    rc = lib.r8_int_gelu(q.data_ptr(), out.data_ptr(), n,
                         ctypes.byref(consts), blocks, _abi.stream_of(q))
    LAUNCHES["int_gelu"] += 1
    _abi.check(lib, rc, "int_gelu")
    return out
