"""Typed operator-API datatypes (twin of ``repro.ops.spec``).

Each integer op carries one of three requant epilogues — per-tensor
:class:`~repro_torch.core.dyadic.Dyadic`, per-channel multiplier vector
with shared ``(c, pre)``, or raw int32 — as a frozen
:class:`RequantSpec`; :class:`QuantLinearParams` holds a quantized linear
layer's tensors, dense int8 or packed (int4 / MSR-4 nibbles, described by
a static :class:`PackMeta`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.dyadic import Dyadic

PER_TENSOR = "per_tensor"
PER_CHANNEL = "per_channel"
RAW = "raw"

_KINDS = (PER_TENSOR, PER_CHANNEL, RAW)


@dataclasses.dataclass(frozen=True)
class RequantSpec:
    """Frozen description of an op's requantization epilogue; build it
    with ``per_tensor`` / ``per_channel`` / ``raw`` / ``for_linear``."""

    kind: str
    out_bits: int = 8
    dn: Optional[Dyadic] = None   # per-tensor dyadic pair
    c: int = 0                    # per-channel shared total shift
    pre: int = 0                  # per-channel shared pre-shift

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"RequantSpec kind must be one of {_KINDS}, "
                             f"got {self.kind!r}")
        if not 2 <= self.out_bits <= 32:
            raise ValueError("out_bits must be in [2, 32], got "
                             f"{self.out_bits}")
        if self.kind == PER_TENSOR:
            if not isinstance(self.dn, Dyadic):
                raise ValueError("per-tensor RequantSpec needs a Dyadic "
                                 f"(got dn={self.dn!r})")
        elif self.kind == PER_CHANNEL:
            if self.dn is not None:
                raise ValueError("per-channel RequantSpec takes (c, pre), "
                                 "not a Dyadic")
            if not 0 <= self.pre <= self.c:
                raise ValueError(f"need 0 <= pre <= c, got c={self.c} "
                                 f"pre={self.pre}")
        else:  # RAW
            if self.dn is not None or self.c or self.pre:
                raise ValueError("raw RequantSpec carries no requant "
                                 "constants")
            if self.out_bits != 32:
                raise ValueError("raw accumulators are int32 "
                                 f"(out_bits=32), got {self.out_bits}")

    @classmethod
    def per_tensor(cls, dn: Dyadic, out_bits: int = 8) -> "RequantSpec":
        return cls(PER_TENSOR, out_bits, dn=dn)

    @classmethod
    def per_channel(cls, c: int, pre: int, out_bits: int = 8
                    ) -> "RequantSpec":
        return cls(PER_CHANNEL, out_bits, c=c, pre=pre)

    @classmethod
    def raw(cls) -> "RequantSpec":
        return cls(RAW, 32)

    @classmethod
    def for_linear(cls, plan) -> "RequantSpec":
        """The epilogue a ``quant.plans.LinearPlan`` describes."""
        if plan.s_out == 0.0:
            return cls.raw()
        return cls.per_channel(plan.c, plan.pre, plan.out_bits)

    @property
    def is_raw(self) -> bool:
        return self.kind == RAW

    @property
    def out_dtype(self) -> torch.dtype:
        """Narrowest container for the clipped output."""
        return torch.int8 if self.out_bits <= 8 else torch.int32


PACK_SCHEMES = ("int4", "msr4")


@dataclasses.dataclass(frozen=True)
class PackMeta:
    """Static description of a packed weight tensor.

    ``scheme``     — ``"int4"`` (two nibbles a byte, weights already in
                     [-7, 7]) or ``"msr4"`` (nibbles of ``clip(w, -7, 7)``
                     plus per-group outlier lanes; lossless for all int8);
    ``group``      — K-group size of the msr4 outlier lanes (divides k);
    ``n_outliers`` — outlier lanes per (group, out-channel) column (0 for
                     plain int4);
    ``k``          — the unpacked contraction length (``w_packed`` stores
                     ``k // 2`` bytes along that axis).

    One PackMeta describes a whole layer-stacked leaf: it is not a tensor
    and passes unsliced through per-layer views (:meth:`QuantLinearParams.
    map`)."""

    scheme: str
    group: int
    n_outliers: int
    k: int

    def __post_init__(self):
        if self.scheme not in PACK_SCHEMES:
            raise ValueError(f"pack scheme must be one of {PACK_SCHEMES}, "
                             f"got {self.scheme!r}")
        if self.k % 2:
            raise ValueError(f"packed k must be even, got {self.k}")
        if self.scheme == "msr4":
            if self.group <= 0 or self.k % self.group:
                raise ValueError(f"msr4 group {self.group} must divide "
                                 f"k={self.k}")
            if self.n_outliers < 0:
                raise ValueError("n_outliers must be >= 0")
        elif self.n_outliers:
            raise ValueError("plain int4 packing carries no outlier lanes")


class QuantLinearParams(NamedTuple):
    """Quantized linear-layer tensors.

    Dense: ``w8`` int8 ``(..., K, N)``; ``b_mult`` int32 per-out-channel
    requant multipliers ``(..., N)`` (present iff the layer's plan
    requantizes); ``bias32`` int32 bias at the accumulator scale ``(...,
    N)``.  The leading axes are the layer stack and, for an MoE's experts,
    the expert: ``w8`` ``(E, K, N)`` with ``b_mult`` ``(E, N)`` a layer,
    each expert with its own per-channel scales (dense only).

    Packed (``quant.pack.pack_linear``; ``w8`` is None): ``w_packed`` int8
    nibble pairs ``(..., K // 2, N)`` (value ``2i`` in the low nibble of
    byte ``i``, ``2i + 1`` in the high); ``pack_meta`` the static
    :class:`PackMeta`; msr4 only, ``out_idx`` int16 within-group row
    indices and ``out_val`` int8 deltas of the outlier lanes, both ``(...,
    K // group, n_outliers, N)``, so that scatter-adding the deltas into
    the nibbles gives ``w8`` back exactly.  Consumers dispatch packed
    params through ``ops.int8_matmul_packed``."""

    w8: Any
    b_mult: Optional[Any] = None
    bias32: Optional[Any] = None
    w_packed: Optional[Any] = None
    pack_meta: Optional[PackMeta] = None
    out_idx: Optional[Any] = None
    out_val: Optional[Any] = None

    @classmethod
    def of(cls, obj) -> "QuantLinearParams":
        """Pass a QuantLinearParams through; reject anything else."""
        if isinstance(obj, cls):
            return obj
        raise TypeError(f"cannot interpret {type(obj).__name__} as "
                        "QuantLinearParams")

    def map(self, fn) -> "QuantLinearParams":
        """``fn`` applied to every tensor field (a layer's view, a move to
        a device); None and the static ``pack_meta`` pass through."""
        return QuantLinearParams(*[
            t if t is None or isinstance(t, PackMeta) else fn(t)
            for t in self])

    @property
    def is_packed(self) -> bool:
        return self.w_packed is not None

    @property
    def k_dim(self) -> int:
        """Unpacked contraction length K."""
        if self.is_packed:
            return self.pack_meta.k
        return self.w8.shape[-2]

    @property
    def n_dim(self) -> int:
        """Output width N (dense and packed storage)."""
        w = self.w_packed if self.is_packed else self.w8
        return w.shape[-1]
