"""The C interface of the kernel library: ``ctypes`` mirrors of the
structs in ``csrc/*.cu*``, every entry point's ``argtypes``/``restype``,
and the host-side packing of plans and RequantSpecs into those structs."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.ops.spec import PER_CHANNEL, PER_TENSOR

_I = ctypes.c_int
_P = ctypes.c_void_p

RQ_RAW, RQ_PER_TENSOR, RQ_PER_CHANNEL = 0, 1, 2


class Requant(ctypes.Structure):
    _fields_ = [(n, _I) for n in ("kind", "b", "c", "pre", "lo", "hi")]


class NormConsts(ctypes.Structure):
    _fields_ = [(n, _I) for n in ("d", "subtract_mean", "mean_b", "mean_c",
                                  "mean_pre", "var_b", "var_c", "var_pre",
                                  "pre_shift", "recip_bits", "out_b",
                                  "out_c", "out_pre", "lo", "hi")]


class GeluConsts(ctypes.Structure):
    _fields_ = [(n, _I) for n in ("q_clip", "q_bneg", "q_c", "q_one",
                                  "out_b", "out_c", "out_pre", "lo", "hi")]


class Shift(ctypes.Structure):
    """``tc::Shift``: core.dyadic.rshift_round by a fixed s as
    ``(x * mul + half) >> rs`` in wrapping uint32."""
    _fields_ = [("mul", ctypes.c_uint), ("half", ctypes.c_uint), ("rs", _I)]


class Exp16(ctypes.Structure):
    """``tc::Exp16`` (``csrc/int_common.cuh``; K3, K4, K5, K7, K8): the
    Shiftmax constants with every shift resolved."""
    _fields_ = ([(n, _I) for n in ("q_band", "in_b", "neg_zq", "q_ln2",
                                   "q_b", "q_c", "e_b")]
                + [(n, Shift) for n in ("in_pre", "in_post", "e_pre",
                                        "e_post")]
                + [("magic", ctypes.c_uint), ("z_shift", _I)])


class MmaAttnArgs(ctypes.Structure):
    """``csrc/int_attention_mma.cuh``'s ``k5::Args`` (K5 and K4).
    ``k_shift`` / ``v_shift``: K4's per-page shifts of packed int4 pools,
    null for int8 pools (and for K5)."""
    _fields_ = ([(n, _P) for n in ("q", "k", "v", "bvec", "out")]
                + [(n, _I) for n in ("B", "Sq", "Skv", "H", "Hkv", "D",
                                     "causal", "window", "out_is_int8",
                                     "tiles", "store_e16", "vec_k", "smem")]
                + [("ex", Exp16), ("rq", Requant)]
                + [(n, _P) for n in ("pages", "pos_end")]
                + [(n, _I) for n in ("page_size", "max_pages")]
                + [(n, _P) for n in ("k_shift", "v_shift")])


class K3Args(ctypes.Structure):
    """``csrc/int_decode_attention.cu``'s ``k3::Args`` (K3).  ``k_shift``
    / ``v_shift``: the per-page shifts of packed int4 pools, null for
    int8 pools; ``pages`` null: the contiguous cache."""
    _fields_ = ([(n, _P) for n in ("q", "k", "v", "pages", "vlen", "bvec",
                                   "out", "k_shift", "v_shift")]
                + [(n, _I) for n in ("B", "S", "H", "Hkv", "D", "L",
                                     "page_size", "max_pages", "out_is_int8",
                                     "cluster", "rank_keys", "mtb",
                                     "resident", "vec", "smem")]
                + [("ex", Exp16), ("rq", Requant)])


class OnlineArgs(ctypes.Structure):
    """``csrc/int_attention_online.cu``'s ``k8::Args`` (K8)."""
    _fields_ = ([(n, _P) for n in ("q", "k", "v", "out")]
                + [(n, _I) for n in ("B", "Sq", "Skv", "H", "Hkv", "D", "bq",
                                     "bkv", "causal", "window", "tiles",
                                     "smem", "dn_b", "dn_c", "dn_pre", "lo",
                                     "hi")]
                + [("ex", Exp16)])


class Msr4Args(ctypes.Structure):
    """``csrc/int8_matmul_msr4.cu``'s ``msr4::Args`` (the MSR-4
    correction)."""
    _fields_ = ([(n, _P) for n in ("acc", "x", "idx", "val", "bias", "bvec",
                                   "out", "ws", "tile_count")]
                + [(n, _I) for n in ("M", "N", "K", "g", "n_out",
                                     "out_is_int8", "groups_per_split",
                                     "kc")]
                + [("rq", Requant)])


class Msr4MmaArgs(ctypes.Structure):
    """``msr4::MmaArgs``: :class:`Msr4Args`, then the tensor-core route's
    own fields."""
    _fields_ = Msr4Args._fields_ + [(n, _I) for n in (
        "lc", "sp", "x_vec", "idx_vec", "val_vec")]


class DecodeArgs(ctypes.Structure):
    """``csrc/int8_matmul_decode.cu``'s ``dec::Args`` (K1's M <= 16
    tile)."""
    _fields_ = ([(n, _P) for n in ("x", "w", "bias", "bvec", "out")]
                + [("rq", Requant)]
                + [(n, _I) for n in ("out_is_int8", "M", "N", "K",
                                     "k_per_split", "use_tma", "vec_x",
                                     "vec_w")])


class GroupedArgs(ctypes.Structure):
    """``csrc/int8_matmul_grouped.cu``'s ``grp::Args`` (K1's grouped
    instantiation: the expert products)."""
    _fields_ = ([(n, _P) for n in ("x", "w", "rows", "bias", "bvec", "out")]
                + [("rq", Requant)]
                + [(n, _I) for n in ("out_is_int8", "E", "R", "N", "K",
                                     "cluster", "use_tma", "vec_x",
                                     "vec_w")])


#: the kernel files' attribute entries (``r8_attrs_<name>``,
#: ``csrc/int_attrs.cuh``), each picking an instantiation by its template
#: selectors; ``analysis.contracts.LaunchReport.kernel`` names one
ATTR_ENTRIES = ("int8_matmul", "int8_matmul_decode", "int8_matmul_grouped",
                "int8_matmul_msr4", "int_layernorm", "int_softmax",
                "int_decode_attention", "int_paged_prefill",
                "int_attention_fused", "int_attention_online", "int_gelu")
ATTR_FIELDS = ("registers", "spill_bytes", "max_threads", "static_smem",
               "occupancy", "max_dynamic_smem")


def declare(lib: ctypes.CDLL) -> None:
    lib.r8_int8_matmul.argtypes = [
        _P, _P, _P, _P, ctypes.POINTER(Requant), _P, _I, _I, _I, _I, _I,
        _I, _I, _P, _P, _I, _I, _I, _P]
    lib.r8_int8_matmul.restype = _I
    lib.r8_int8_matmul_grouped.argtypes = [ctypes.POINTER(GroupedArgs),
                                           _P, _P, _I, _I, _I, _P]
    lib.r8_int8_matmul_grouped.restype = _I
    lib.r8_int8_matmul_decode.argtypes = [ctypes.POINTER(DecodeArgs), _P,
                                          _P, _I, _I, _I, _P]
    lib.r8_int8_matmul_decode.restype = _I
    lib.r8_tensor_map_2d.argtypes = [_P, _P, ctypes.c_ulonglong,
                                     ctypes.c_ulonglong, ctypes.c_uint,
                                     ctypes.c_uint, _I]
    lib.r8_tensor_map_2d.restype = _I
    lib.r8_tensor_map_3d.argtypes = [_P, _P, ctypes.c_ulonglong,
                                     ctypes.c_ulonglong, ctypes.c_ulonglong,
                                     ctypes.c_uint, ctypes.c_uint, _I]
    lib.r8_tensor_map_3d.restype = _I
    lib.r8_int8_matmul_msr4.argtypes = [ctypes.POINTER(Msr4Args), _I, _I,
                                        _I, _P]
    lib.r8_int8_matmul_msr4.restype = _I
    lib.r8_int8_matmul_msr4_mma.argtypes = [ctypes.POINTER(Msr4MmaArgs),
                                            _I, _I, _I, _P]
    lib.r8_int8_matmul_msr4_mma.restype = _I
    lib.r8_int_layernorm.argtypes = [_P, _P, _P, ctypes.POINTER(NormConsts),
                                     _P, _I, _I, _I, _I, _I, _I, _P]
    lib.r8_int_layernorm.restype = _I
    lib.r8_isqrt_check.argtypes = [_P, _I, _P]
    lib.r8_isqrt_check.restype = _I
    lib.r8_empty_kernel.argtypes = [_P]
    lib.r8_empty_kernel.restype = _I
    lib.r8_int_decode_attention.argtypes = [ctypes.POINTER(K3Args), _P]
    lib.r8_int_decode_attention.restype = _I
    lib.r8_k3_smem_bytes.argtypes = [_I, _I, _I, _I, _I, _I]
    lib.r8_k3_smem_bytes.restype = ctypes.c_longlong
    lib.r8_int_paged_prefill.argtypes = [ctypes.POINTER(MmaAttnArgs), _P]
    lib.r8_int_paged_prefill.restype = _I
    lib.r8_int_attention_fused.argtypes = [ctypes.POINTER(MmaAttnArgs),
                                           _P]
    lib.r8_int_attention_fused.restype = _I
    lib.r8_k5_smem_bytes.argtypes = [_I, _I, _I]
    lib.r8_k5_smem_bytes.restype = ctypes.c_longlong
    lib.r8_exp16_div_check.argtypes = [_I, _I, ctypes.c_uint, _I, _P, _P]
    lib.r8_exp16_div_check.restype = _I
    lib.r8_int_gelu.argtypes = [_P, _P, ctypes.c_longlong,
                                ctypes.POINTER(GeluConsts), _I, _P]
    lib.r8_int_gelu.restype = _I
    lib.r8_int_softmax.argtypes = [_P, _P, ctypes.c_longlong, _I, _I, _I,
                                   _I, _I, _I, ctypes.c_longlong,
                                   ctypes.POINTER(Exp16), _P]
    lib.r8_int_softmax.restype = _I
    lib.r8_int_attention_online.argtypes = [ctypes.POINTER(OnlineArgs), _P]
    lib.r8_int_attention_online.restype = _I
    lib.r8_online_smem_bytes.argtypes = [_I]
    lib.r8_online_smem_bytes.restype = ctypes.c_longlong
    lib.r8_error_string.argtypes = [_I]
    lib.r8_error_string.restype = ctypes.c_char_p
    for name in ATTR_ENTRIES:
        fn = getattr(lib, f"r8_attrs_{name}")
        fn.argtypes = [ctypes.POINTER(_I), _I, _I, _I, ctypes.POINTER(_I)]
        fn.restype = _I


def check(lib, rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if rc != 0:
        msg = lib.r8_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _shifts_ok(b: int, c: int, pre: int) -> None:
    if not (0 <= pre <= 31 and -31 <= c - pre <= 31 and -2**31 <= b < 2**31):
        raise ValueError(f"dyadic (b={b}, c={c}, pre={pre}) outside the "
                         "kernels' int32 shift range")


def requant_struct(spec) -> Requant:
    """Pack a RequantSpec (per-channel multipliers travel separately)."""
    if spec.is_raw:
        return Requant(RQ_RAW, 0, 0, 0, 0, 0)
    lo, hi = -(1 << (spec.out_bits - 1)), (1 << (spec.out_bits - 1)) - 1
    if spec.kind == PER_TENSOR:
        dn = spec.dn
        _shifts_ok(dn.b, dn.c, dn.pre)
        return Requant(RQ_PER_TENSOR, dn.b, dn.c, dn.pre, lo, hi)
    assert spec.kind == PER_CHANNEL
    _shifts_ok(0, spec.c, spec.pre)
    return Requant(RQ_PER_CHANNEL, 0, spec.c, spec.pre, lo, hi)


def shift_struct(s: int) -> Shift:
    """rshift_round by ``s`` (-31..31) without a branch: a left shift as a
    multiply, then the rounding half and the right shift."""
    return Shift(1, 1 << (s - 1), s) if s > 0 else Shift(1 << -s, 0, 0)


def exp16_consts(sm, magic: int, z_shift: int) -> Exp16:
    """Pack an ISoftmaxPlan for the kernels' branch-free exp16, with
    ``(magic, z_shift)`` its division by q_ln2 as a multiply-high."""
    for dn in (sm.dn_in, sm.dn_e16):
        _shifts_ok(dn.b, dn.c, dn.pre)
    ie, din, de = sm.iexp, sm.dn_in, sm.dn_e16
    return Exp16(sm.q_band, din.b, -ie.z_max * ie.q_ln2, ie.q_ln2, ie.q_b,
                 ie.q_c, de.b, shift_struct(din.pre),
                 shift_struct(din.c - din.pre), shift_struct(de.pre),
                 shift_struct(de.c - de.pre), magic, z_shift)


@functools.lru_cache(maxsize=256)
def norm_consts(plan, out_bits: int) -> NormConsts:
    """Pack an INormPlan (a hashable NamedTuple) once per ``(plan,
    out_bits)``: a llama3-8b decode step normalises 65 times.  The struct
    is shared between calls and never written after."""
    for dn in (plan.dn_mean, plan.dn_var, plan.dn_out):
        _shifts_ok(dn.b, dn.c, dn.pre)
    if not 0 <= 2 * plan.pre_shift <= 31 or \
            plan.recip_bits + plan.pre_shift > 30:
        raise ValueError("norm shifts outside the kernel's int32 range")
    lo, hi = -(1 << (out_bits - 1)), (1 << (out_bits - 1)) - 1
    return NormConsts(plan.d, int(plan.subtract_mean), plan.dn_mean.b,
                      plan.dn_mean.c, plan.dn_mean.pre, plan.dn_var.b,
                      plan.dn_var.c, plan.dn_var.pre, plan.pre_shift,
                      plan.recip_bits, plan.dn_out.b, plan.dn_out.c,
                      plan.dn_out.pre, lo, hi)


def gelu_consts(plan, dn_out, out_bits: int) -> GeluConsts:
    """Pack an IGeluPlan (its IErfPlan) and the output Dyadic."""
    _shifts_ok(dn_out.b, dn_out.c, dn_out.pre)
    erf = plan.erf
    for v in (erf.q_clip, erf.q_bneg, erf.q_c, plan.q_one):
        if not -2**31 <= v < 2**31:
            raise ValueError(f"i-GELU constant {v} outside int32")
    lo, hi = -(1 << (out_bits - 1)), (1 << (out_bits - 1)) - 1
    return GeluConsts(erf.q_clip, erf.q_bneg, erf.q_c, plan.q_one, dn_out.b,
                      dn_out.c, dn_out.pre, lo, hi)


def kernel_attributes(kernel: tuple, threads: int, smem: int,
                      cluster: int = 1) -> dict:
    """On the card: what CUDA says of the instantiation ``kernel`` (an
    entry of :data:`ATTR_ENTRIES` and its template selectors, as
    ``LaunchReport.kernel``) at CTAs of ``threads`` threads with ``smem``
    bytes of dynamic shared memory in clusters of ``cluster``: registers
    a thread, spill (local) bytes a thread, the kernel's
    ``maxThreadsPerBlock``, its static shared bytes, the occupancy (CTAs
    an SM, or, for a cluster of more than one CTA, clusters on the card)
    and the dynamic shared memory it may now take.  Launches nothing."""
    from repro_torch.kernels._build import library
    entry, *sel = kernel
    lib = library()
    out = (_I * len(ATTR_FIELDS))()
    rc = getattr(lib, f"r8_attrs_{entry}")(
        (_I * max(1, len(sel)))(*sel), threads, smem, cluster, out)
    check(lib, rc, f"attributes of {kernel}")
    return dict(zip(ATTR_FIELDS, out))
