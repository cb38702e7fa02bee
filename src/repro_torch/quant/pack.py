"""Design-time weight packing: int8 weights -> the sub-8-bit storage tier
(twin of ``repro.quant.pack``).

Two schemes, both stored as two's-complement nibble pairs along the
contraction axis (byte ``i`` = values ``2i`` low / ``2i + 1`` high):

  * ``"int4"`` — plain nibbles; only for weights already in ``[-7, 7]``
    (refused otherwise);
  * ``"msr4"`` — nibbles of ``clip(w, -7, 7)`` plus, per ``group``-sized
    K-slice and out-channel, a static number of outlier lanes ``(out_idx,
    out_val)`` with ``out_val = w - clip(w, -7, 7)`` (in [-121, 120]):
    exact for every int8 value, -128 included.

The bytes equal the reference's: the same stable lane order (outlier rows
first, filler lanes on the first delta-0 rows), int16 indices, the ``g =
K`` fallback where ``group`` does not divide K, one ``n_outliers`` for a
whole layer-stacked ``(ng, K, N)`` leaf (the max over its layers), and
``pack_tree``'s skip rules.  The code is torch on the weight's device, so
a full-width model packs on the card; a stack is packed layer by layer
(one pass to count, one to fill), so the temporaries are one layer's.
"""
from __future__ import annotations

import torch

from repro_torch.ops.packed import nibble_pack
from repro_torch.ops.spec import PackMeta, QuantLinearParams

__all__ = ["pack_int4", "pack_msr4", "pack_linear", "pack_tree"]


def _layers(w):
    """``w (..., K, N)`` as a ``(L, K, N)`` view of its layers."""
    return w.reshape(-1, *w.shape[-2:])


def _even_k(w) -> None:
    if w.shape[-2] % 2:
        raise ValueError(f"K must be even to nibble-pack, got "
                         f"{tuple(w.shape)}")


def _nibbles(w):
    """int4-range ``(K, N)`` -> contiguous ``(K // 2, N)`` int8 nibbles."""
    return nibble_pack(w, axis=-2).contiguous()


def pack_int4(w8):
    """Pack int4-range int8 weights ``(..., K, N)`` -> ``(..., K // 2,
    N)``; raises if any ``|w| > 7`` (use :func:`pack_msr4`)."""
    w = torch.as_tensor(w8)
    _even_k(w)
    if w.numel() and int(w.to(torch.int32).abs().max()) > 7:
        raise ValueError("int4 packing needs all |w| <= 7; use msr4 for "
                         "full int8 weights")
    return _nibbles(w)


def _delta(w):
    """``(w, w - clip(w, -7, 7))`` of one layer, int32."""
    w = w.to(torch.int32)
    return w, w - torch.clamp(w, -7, 7)


def pack_msr4(w8, group: int = 256):
    """MSR-4 pack: nibbles plus static-count outlier lanes.  Lossless.

    Returns ``(packed, meta, out_idx, out_val)``: ``packed`` ``(..., K //
    2, N)`` int8 nibbles of ``clip(w, -7, 7)``; per K-group of ``group``
    rows and out-channel, ``n_outliers`` lanes of within-group row indices
    ``out_idx`` (int16) and deltas ``out_val`` (int8), both ``(..., K //
    g, n_outliers, N)``.  ``n_outliers`` is the most outliers of any
    (group, channel) column over all layers; the first lanes of a column
    are its outlier rows in order, the rest filler lanes on its first
    delta-0 rows (a stable sort of the inverted outlier mask), so the
    indices of a column are distinct."""
    w = torch.as_tensor(w8)
    _even_k(w)
    *lead, k, n = w.shape
    g = group if (group > 0 and k % group == 0) else k
    if g > 32767:
        raise ValueError(f"group {g} overflows the int16 outlier index")
    ngrp = k // g if g else 0
    layers = _layers(w)
    n_out = 0
    if w.numel():
        for layer in layers:                      # pass 1: count
            _, d = _delta(layer)
            cnt = (d != 0).reshape(ngrp, g, n).sum(dim=-2)
            n_out = max(n_out, int(cnt.max()))
    packed = torch.empty((layers.shape[0], k // 2, n), dtype=torch.int8,
                         device=w.device)
    out_idx = torch.empty((layers.shape[0], ngrp, n_out, n),
                          dtype=torch.int16, device=w.device)
    out_val = torch.empty_like(out_idx, dtype=torch.int8)
    for i, layer in enumerate(layers):            # pass 2: fill
        w32, d = _delta(layer)
        packed[i] = _nibbles(w32 - d)
        if not n_out:
            continue
        d_g = d.reshape(ngrp, g, n)
        inlier = (d_g == 0).to(torch.uint8)
        order = torch.sort(inlier, dim=-2, stable=True).indices
        lanes = order[:, :n_out, :]
        out_idx[i] = lanes.to(torch.int16)
        out_val[i] = torch.take_along_dim(d_g, lanes, dim=-2
                                          ).to(torch.int8)
    meta = PackMeta(scheme="msr4", group=g, n_outliers=n_out, k=k)
    return (packed.reshape(*lead, k // 2, n), meta,
            out_idx.reshape(*lead, ngrp, n_out, n),
            out_val.reshape(*lead, ngrp, n_out, n))


def pack_linear(qw, scheme: str = "msr4", group: int = 256
                ) -> QuantLinearParams:
    """Pack one dense ``QuantLinearParams``; ``b_mult`` / ``bias32`` ride
    along unchanged (the packed matmul's epilogue is the dense one, on the
    identical accumulator).  Packed params pass through."""
    qw = QuantLinearParams.of(qw)
    if qw.is_packed:
        return qw
    if qw.w8 is None:
        raise ValueError("cannot pack a QuantLinearParams without w8")
    w = qw.w8
    if scheme == "int4":
        packed = pack_int4(w)
        meta = PackMeta(scheme="int4", group=0, n_outliers=0,
                        k=w.shape[-2])
        out_idx = out_val = None
    elif scheme == "msr4":
        packed, meta, out_idx, out_val = pack_msr4(w, group=group)
    else:
        raise ValueError(f"unknown pack scheme {scheme!r}")
    return QuantLinearParams(w8=None, b_mult=qw.b_mult, bias32=qw.bias32,
                             w_packed=packed, pack_meta=meta,
                             out_idx=out_idx, out_val=out_val)


def _packable(qw: QuantLinearParams) -> bool:
    """2-D weights or ``(ng, K, N)`` layer stacks with an even K (the
    reference's rule: 4-D expert stacks stay dense)."""
    if qw.is_packed or qw.w8 is None:
        return False
    return qw.w8.dim() in (2, 3) and qw.w8.shape[-2] % 2 == 0


def pack_tree(qparams, scheme: str = "msr4", group: int = 256):
    """Pack every packable ``QuantLinearParams`` of a params tree (dicts
    and lists); every other leaf (embeddings, norm tables, head scales)
    and every unpackable linear passes through unchanged."""
    if isinstance(qparams, QuantLinearParams):
        return (pack_linear(qparams, scheme=scheme, group=group)
                if _packable(qparams) else qparams)
    if isinstance(qparams, dict):
        return {k: pack_tree(v, scheme, group) for k, v in qparams.items()}
    if isinstance(qparams, (list, tuple)):
        return type(qparams)(pack_tree(v, scheme, group) for v in qparams)
    return qparams
