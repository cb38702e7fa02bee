"""repro_torch — the SwiftTron integer datapath on PyTorch + Hopper kernels.

A port of the JAX package ``repro`` (which stays the reference).  The
layout mirrors ``repro`` module for module; public functions keep the
JAX layouts — ``(B, S, H, hd)`` activations, ``(num_pages, page_size,
Hkv, hd)`` KV pools, ``(K, N)`` weights, layer-stacked parameters with a
leading group axis — so the two packages compare like with like.

The port never imports ``jax`` or ``repro``.  Entry points take
``device=`` and default to ``"cuda"``; without a GPU they raise unless
the caller asks for ``device="cpu"``.
"""
from __future__ import annotations

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
