"""Pack/unpack of the int4 KV page tier (twin of ``repro.ops.packed``,
its KV half).

A packed KV page stores two head-dim nibbles per byte (two's-complement,
value ``2i`` in the low nibble of byte ``i``, ``2i + 1`` in the high) and
carries a per-page requant shift: a pool element stores
``clip(rshift_round(v, shift), -7, 7)`` and dequantizes to ``q4 << shift``,
wrapped to int8.

All nibble arithmetic is done in int32 with explicit sign extension —
``((x & 15) ^ 8) - 8`` — as the reference does.  :func:`unpack_kv_pool` is
the declared dequant reference the kernels' in-register unpack (K3 and
K4 with ``kv_shifts``) is bit-exact against.  The packed weights of the
reference (``unpack_weights``, ``msr4_correction``) are not ported yet
(ROADMAP §1 item 4, its weight half).
"""
from __future__ import annotations

import torch

#: static per-page requant shift of the int4 KV tier: pages store
#: clip(rshift_round(v, KV_SHIFT), -7, 7); dequant is q4 << shift (<= 112)
KV_SHIFT = 4

__all__ = ["KV_SHIFT", "nibble_pack", "nibble_unpack", "quantize_kv",
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
