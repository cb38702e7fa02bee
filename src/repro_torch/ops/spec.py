"""Typed operator-API datatypes (twin of ``repro.ops.spec``, dense tier).

Each integer op carries one of three requant epilogues — per-tensor
:class:`~repro_torch.core.dyadic.Dyadic`, per-channel multiplier vector
with shared ``(c, pre)``, or raw int32 — as a frozen
:class:`RequantSpec`; :class:`QuantLinearParams` holds a quantized linear
layer's tensors.  The packed (int4/MSR-4) storage tier is not ported yet.
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


class QuantLinearParams(NamedTuple):
    """Quantized linear-layer tensors: ``w8`` int8 ``(..., K, N)``;
    ``b_mult`` int32 per-out-channel requant multipliers ``(..., N)``
    (present iff the layer's plan requantizes); ``bias32`` int32 bias at
    the accumulator scale ``(..., N)``."""

    w8: Any
    b_mult: Optional[Any] = None
    bias32: Optional[Any] = None

    @classmethod
    def of(cls, obj) -> "QuantLinearParams":
        """Pass a QuantLinearParams through; reject anything else."""
        if isinstance(obj, cls):
            return obj
        raise TypeError(f"cannot interpret {type(obj).__name__} as "
                        "QuantLinearParams")

    @property
    def n_dim(self) -> int:
        return self.w8.shape[-1]
