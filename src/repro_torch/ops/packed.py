"""Pack/unpack of the sub-8-bit storage tier (twin of ``repro.ops.packed``).

Two packed families share one byte layout (two's-complement nibbles,
value ``2i`` in the low nibble of byte ``i``, ``2i + 1`` in the high):

  * **packed weights** (``QuantLinearParams.w_packed``): nibbles along the
    contraction axis (``-2``), plus the msr4 outlier lanes (``out_idx`` /
    ``out_val``) that make the reconstruction exact for every int8 value;
  * **packed KV pages**: nibbles along the head dim (``-1``) with a
    per-page requant shift: a pool element stores ``clip(rshift_round(v,
    shift), -7, 7)`` and dequantizes to ``q4 << shift``, wrapped to int8.

All nibble arithmetic is done in int32 with explicit sign extension —
``((x & 15) ^ 8) - 8`` — as the reference does.  :func:`unpack_weights`,
:func:`msr4_correction` and :func:`unpack_kv_pool` are the declared
references the kernels are bit-exact against: K1's in-register nibble
expansion (``packed=True``), the MSR-4 correction kernel, and K3 / K4
with ``kv_shifts``.  Where the reference broadcasts one-hot lane masks,
these use PyTorch's own idiom (``scatter_add_``, a dense delta matrix):
the integers are equal because a column's lanes name distinct rows and
filler lanes carry delta 0.
"""
from __future__ import annotations

import torch

from repro_torch.core.intmath import int_einsum

#: static per-page requant shift of the int4 KV tier: pages store
#: clip(rshift_round(v, KV_SHIFT), -7, 7); dequant is q4 << shift (<= 112)
KV_SHIFT = 4

__all__ = ["KV_SHIFT", "nibble_pack", "nibble_unpack", "unpack_weights",
           "msr4_correction", "msr4_lanes_distinct", "quantize_kv",
           "pack_kv", "unpack_kv_pool"]


def _rshift_round(x, s: int):
    """Round-half-up arithmetic right shift (the requant unit's
    primitive)."""
    if s == 0:
        return x
    return (x + (1 << (s - 1))) >> s


def _wrap8(x):
    """int32 -> int8 keeping the low byte (two's complement), as JAX's
    ``.astype(jnp.int8)`` does."""
    return (((x & 255) ^ 128) - 128).to(torch.int8)


def nibble_pack(a, axis: int = -2):
    """Pack int4-range values pairwise into bytes along ``axis``.

    ``a`` must have an even extent along ``axis`` and values in ``[-8,
    7]``; returns int8 of half the extent, low nibble = even index, high
    nibble = odd index."""
    a = torch.as_tensor(a).to(torch.int32).movedim(axis, -1)
    byte = (a[..., 0::2] & 15) | ((a[..., 1::2] & 15) << 4)
    return _wrap8(byte).movedim(-1, axis)


def nibble_unpack(p, axis: int = -2):
    """Inverse of :func:`nibble_pack`: int8 bytes -> int32 nibble
    values."""
    p = torch.as_tensor(p)
    ax = axis % p.dim()
    p32 = p.to(torch.int32)
    lo = ((p32 & 15) ^ 8) - 8
    hi = (((p32 >> 4) & 15) ^ 8) - 8
    pair = torch.stack([lo, hi], dim=ax + 1)
    shape = p.shape[:ax] + (2 * p.shape[ax],) + p.shape[ax + 1:]
    return pair.reshape(shape)


def _lane_deltas(qw):
    """The msr4 outlier deltas scattered into their rows: ``(..., K // g,
    g, N)`` int32, zero where no lane points.  A lane index outside [0,
    g) adds nothing, as in the reference's one-hot ``unpack_weights``."""
    meta = qw.pack_meta
    idx = qw.out_idx.to(torch.int64)                # (..., ngrp, n_out, N)
    *lead, ngrp, _, n = idx.shape
    hit = (idx >= 0) & (idx < meta.group)
    d = torch.zeros((*lead, ngrp, meta.group, n), dtype=torch.int32,
                    device=idx.device)
    return d.scatter_add_(-2, torch.where(hit, idx, 0),
                          torch.where(hit, qw.out_val.to(torch.int32), 0))


def msr4_lanes_distinct(out_idx, group: int) -> bool:
    """Whether, in every (group, column) of ``out_idx`` (..., K // g,
    n_out, N), the lanes whose index lies in [0, ``group``) name distinct
    rows: the precondition of the correction kernel's dense delta tile
    (one delta per row and column).  ``pack_msr4`` guarantees it."""
    idx = torch.as_tensor(out_idx).to(torch.int32)
    n_out = idx.shape[-2]
    if n_out < 2 or idx.numel() == 0:
        return True
    spare = group + torch.arange(n_out, dtype=torch.int32,
                                 device=idx.device).view(n_out, 1)
    key = torch.where((idx >= 0) & (idx < group), idx, spare)
    key = key.sort(dim=-2).values
    return not bool((key[..., 1:, :] == key[..., :-1, :]).any())


def unpack_weights(qw):
    """Reconstruct the dense int8 weights of a packed ``QuantLinearParams``
    (leading layer dims allowed): the nibble expansion, plus for msr4 the
    outlier deltas added into their within-group rows.  Exact for every
    int8 weight."""
    meta = qw.pack_meta
    w = nibble_unpack(qw.w_packed, axis=-2)         # (..., K, N) int32
    if meta.scheme == "msr4" and meta.n_outliers:
        *lead, k, n = w.shape
        g = meta.group
        w = (w.reshape(*lead, k // g, g, n) + _lane_deltas(qw)
             ).reshape(*lead, k, n)
    return _wrap8(w)


def msr4_correction(x32, qw):
    """The outlier lanes' contribution ``x @ scatter(out_val)`` as (M, N)
    int32, for ``x32`` (M, K) int32 holding int8 values and a 2-D packed
    ``qw``.  With ``acc_nib = x @ nibbles``, ``acc_nib +
    msr4_correction(x, qw) == x @ unpack_weights(qw)`` exactly (integer
    distributivity): the identity the two-launch msr4 matmul rests on."""
    meta = qw.pack_meta
    n = qw.n_dim
    if meta.scheme != "msr4" or not meta.n_outliers:
        return torch.zeros((x32.shape[0], n), dtype=torch.int32,
                           device=x32.device)
    delta = _lane_deltas(qw).reshape(meta.k, n)
    return int_einsum("mk,kn->mn", x32, delta)


def quantize_kv(v8, shift: int = KV_SHIFT):
    """int8 KV value -> int4 code: ``clip(rshift_round(v, shift), -7,
    7)``."""
    v = torch.as_tensor(v8).to(torch.int32)
    return torch.clamp(_rshift_round(v, shift), -7, 7)


def pack_kv(v8, shift: int = KV_SHIFT):
    """Quantize + nibble-pack int8 K/V along the head dim (``-1``)."""
    return nibble_pack(quantize_kv(v8, shift), axis=-1)


def unpack_kv_pool(pool, shift_per_page):
    """Dequantize a packed KV page pool back to an int8 pool.

    ``pool`` is ``(num_pages, page_size, Hkv, d // 2)`` int8 nibbles;
    ``shift_per_page`` is ``(num_pages,)`` int32.  Returns the int8
    ``(num_pages, page_size, Hkv, d)`` pool ``q4 << shift``, wrapped to
    int8 as the reference's ``.astype(jnp.int8)`` wraps it (shifts 5-7
    can carry a nibble past int8)."""
    q4 = nibble_unpack(pool, axis=-1)
    shift = torch.as_tensor(shift_per_page).to(device=q4.device,
                                                dtype=torch.int32)
    return _wrap8(q4 << shift[:, None, None, None])
