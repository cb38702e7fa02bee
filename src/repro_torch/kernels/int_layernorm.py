"""K2: integer LayerNorm / RMSNorm.

The port of ``repro/kernels/int_layernorm.py::int_layernorm_pallas``; the
CUDA kernel is ``csrc/int_layernorm.cu``.  :func:`int_layernorm_plain` is
the plain PyTorch version; :func:`launch_plan` the launch the wrapper
picks for a shape.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.analysis.contracts import layernorm_report, require_launch
from repro_torch.kernels import LAUNCHES, RECORDERS, note_launch
from repro_torch.kernels import ref as _ref

# mirrored by csrc/int_layernorm.cu (namespace k2)
MAX_D = 8192
WARP_MAX_D = 1024
WARP_THREADS = 256                 # 8 rows a CTA on the warp route
WARP_VPL = (4, 8, 12, 16, 24, 32)  # the warp route's instantiations
BLOCK_VPL = 8
WARP_CTAS_PER_SM = {4: 4, 8: 4, 12: 3, 16: 2, 24: 2, 32: 1}


class K2Plan(NamedTuple):
    """One K2 launch: ``route`` "warp" (a warp a row, ``rows_per_cta``
    rows a CTA, a persistent grid) or "block" (a CTA a row); ``vec`` 4
    (int4 loads and stores) or 1; ``values_per_lane`` the values a thread
    holds of a row (the template's VPL)."""
    route: str
    vec: int
    values_per_lane: int
    threads: int
    rows_per_cta: int
    grid: int

    def describe(self) -> str:
        return (f"{self.route} vec={self.vec} vpl={self.values_per_lane} "
                f"threads={self.threads} rows/cta={self.rows_per_cta} "
                f"grid={self.grid}")


@functools.lru_cache(maxsize=1024)
def launch_plan(rows: int, d: int, n_sm: int, aligned: bool) -> K2Plan:
    """The K2 launch for ``rows`` rows of ``d`` on a card of ``n_sm`` SMs;
    ``aligned``: every operand 16-byte aligned.  Vectors of 4 need that
    and d % 4 == 0.  d <= 1024 takes the warp route with the smallest
    instantiated VPL that holds ceil(d / vec / 32) vectors a lane, and
    about one wave of CTAs (``WARP_CTAS_PER_SM`` a SM, the kernel's
    ``__launch_bounds__``); d > 1024 the block route, 8 values a thread
    and the threads rounded up to whole warps (512 at d = 4096, 480 at
    3840)."""
    if not 1 <= d <= MAX_D:
        raise ValueError(f"int_layernorm: row length {d} outside the "
                         f"kernel's 1..{MAX_D}")
    if not 1 <= rows < 2 ** 31:
        raise ValueError(f"int_layernorm: {rows} rows outside 1..2^31-1")
    vec = 4 if aligned and d % 4 == 0 else 1
    nvec = d // vec
    if d <= WARP_MAX_D:
        need = -(-nvec // 32) * vec
        vpl = next(v for v in WARP_VPL if v >= need)
        rpc = WARP_THREADS // 32
        grid = min(-(-rows // rpc), n_sm * WARP_CTAS_PER_SM[vpl])
        return K2Plan("warp", vec, vpl, WARP_THREADS, rpc, grid)
    threads = -(-nvec // (BLOCK_VPL // vec))
    threads = -(-threads // 32) * 32
    return K2Plan("block", vec, BLOCK_VPL, threads, 1, rows)


def int_layernorm_plain(q, q_gamma, q_beta, plan, out_bits: int = 8):
    return _ref.ref_int_layernorm(q, q_gamma, q_beta, plan, out_bits)


def int_layernorm(q, q_gamma, q_beta, plan, out_bits: int = 8):
    """q (..., d) int32 at plan.s_in -> int32 (..., d) clipped to
    ``out_bits``.  CPU tensors take the plain version; CUDA tensors launch
    the kernel (:func:`launch_plan`, through the contract
    ``analysis.contracts.layernorm_report``: ``KernelContractError`` past
    ``MAX_D``) or raise."""
    if not q.is_cuda:
        return int_layernorm_plain(q, q_gamma, q_beta, plan, out_bits)
    from repro_torch.kernels import _abi
    from repro_torch.kernels._build import library
    d = q.shape[-1]
    if d != plan.d:
        raise ValueError(f"int_layernorm: row length {d} != plan d="
                         f"{plan.d}")
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
    ops = (q, q_gamma, out) if q_beta is None else (q, q_gamma, q_beta, out)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    aligned = all(t.data_ptr() % 16 == 0 for t in ops)
    kp = require_launch(layernorm_report(rows, d, aligned,
                                         plan.subtract_mean,
                                         q_beta is not None, sms)).plan
    if RECORDERS:
        note_launch("int_layernorm", dict(
            rows=rows, d=d, aligned=aligned, sms=sms,
            subtract_mean=plan.subtract_mean, beta=q_beta is not None),
            kp.route, (kp.grid,), 1, 0)
    consts = _abi.norm_consts(plan, out_bits)
    lib = library()
    rc = lib.r8_int_layernorm(q.data_ptr(), q_gamma.data_ptr(),
                              _abi.ptr(q_beta), ctypes.byref(consts),
                              out.data_ptr(), rows, int(kp.route == "warp"),
                              kp.vec, kp.values_per_lane, kp.threads,
                              kp.grid, _abi.stream_of(q))
    LAUNCHES["int_layernorm"] += 1
    _abi.check(lib, rc, "int_layernorm")
    return out


def isqrt_mismatches(device="cuda") -> int:
    """On the card: how many n in [-1, 2^31) the kernel's O(1) integer
    sqrt (``isqrt_fast``) gives otherwise than the reference's 16 Newton
    steps (``isqrt16``)."""
    from repro_torch.kernels import _abi
    from repro_torch.kernels._build import library
    bad = torch.zeros(1, dtype=torch.int32, device=device)
    sms = torch.cuda.get_device_properties(bad.device).multi_processor_count
    lib = library()
    rc = lib.r8_isqrt_check(bad.data_ptr(), 8 * sms, _abi.stream_of(bad))
    _abi.check(lib, rc, "isqrt check")
    return int(bad.item())
