"""Float<->integer boundary (SwiftTron §III-A; twin of ``repro.core.quant``):
symmetric quantization, calibration statistics and the straight-through
fake-quant of QAT.

The integer datapath never touches a float; this is the design-time side,
turning calibrated float ranges into frozen scales.  Every function takes
a tensor (or an array, made a tensor) and returns its result on the
tensor's device, or on ``device`` where one is given.
"""
from __future__ import annotations

import dataclasses

import torch


def qrange(bits: int):
    return -(1 << (bits - 1)), (1 << (bits - 1)) - 1


def scale_from_absmax(absmax: float, bits: int = 8) -> float:
    """Symmetric scale so that +-absmax maps onto the int range."""
    _, hi = qrange(bits)
    absmax = max(float(absmax), 1e-8)
    return absmax / hi


def _on(x, device):
    return torch.as_tensor(x, device=device) if device is not None \
        or not isinstance(x, torch.Tensor) else x


def quantize(x, scale: float, bits: int = 8, device=None):
    """Float -> int32 values on the int``bits`` grid (round half to even,
    as ``jnp.round``)."""
    lo, hi = qrange(bits)
    x = _on(x, device)
    return torch.clamp(torch.round(x / scale), lo, hi).to(torch.int32)


def dequantize(q, scale: float, device=None):
    return _on(q, device).to(torch.float32) * scale


def fake_quant(x, scale, bits: int = 8, device=None):
    """Straight-through-estimator fake quantization for QAT: forward
    ``dequantize(quantize(x))``, backward the identity inside the clip
    range.  ``scale``: a float or a tensor (per-channel QAT)."""
    lo, hi = qrange(bits)
    x = _on(x, device)
    xc = torch.clamp(x / scale, lo, hi)
    q = torch.round(xc)
    return (x + ((q - xc) * scale + (xc * scale - x)).detach()).to(x.dtype)


def per_channel_absmax(x, axis: int, device=None):
    """Max-abs along all axes except ``axis`` (weight out-channel scales)."""
    x = _on(x, device)
    axes = tuple(i for i in range(x.dim()) if i != (axis % x.dim()))
    return torch.abs(x).amax(dim=axes)


@dataclasses.dataclass
class CalibStats:
    """Running activation-range statistics collected by calibration."""
    absmax: float = 0.0
    n: int = 0

    def update(self, x) -> "CalibStats":
        m = float(torch.abs(torch.as_tensor(x)).max())
        return CalibStats(absmax=max(self.absmax, m), n=self.n + 1)

    def scale(self, bits: int = 8, headroom: float = 1.0) -> float:
        return scale_from_absmax(self.absmax * headroom, bits)


def ema_absmax(prev: float, x, decay: float = 0.95) -> float:
    """EMA max-abs update (per-tensor activation calibration)."""
    m = float(torch.abs(torch.as_tensor(x)).max())
    return decay * prev + (1.0 - decay) * m if prev > 0 else m
