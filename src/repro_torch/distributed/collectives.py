"""Quantized collectives over a ``torch.distributed`` process group (the
port of ``repro.distributed.collectives``).

**INT8 gradient compression with error feedback**: gradients are
quantized to int8 with a per-tensor scale before the data-parallel
all-reduce; the quantization error is carried to the next step.
**psum_int32**: the exact all-reduce of int32 partial accumulators that
the tensor-parallel serving path sums before its single requant.

Where the reference names a ``shard_map`` axis, these take a process
``group`` (None: the default group).  The reference's ``pmax`` is an
all-reduce ``MAX``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

Pytree = Any


class CompressionState(NamedTuple):
    error: Pytree          # error-feedback residual, same shapes as grads


def init_compression(grads_like: Pytree) -> CompressionState:
    return CompressionState(error=pytree.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def _int8_scale(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x.abs().max(), min=1e-12) / 127.0


def compress_decompress(g: torch.Tensor, err: torch.Tensor):
    """Int8 quantization of one gradient tensor with its carried error.
    Returns ``(g_hat, new_err)``: ``g_hat`` is what the receiving side
    reconstructs."""
    gf = g.to(torch.float32) + err
    scale = _int8_scale(gf)
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    g_hat = (q * scale).to(torch.float32)
    return g_hat.to(g.dtype), gf - g_hat


def compressed_grads(grads: Pytree, state: CompressionState
                     ) -> Tuple[Pytree, CompressionState]:
    leaves, spec = pytree.tree_flatten(grads)
    errs = spec.flatten_up_to(state.error)
    out = [compress_decompress(g, e) for g, e in zip(leaves, errs)]
    return (pytree.tree_unflatten([g for g, _ in out], spec),
            CompressionState(error=pytree.tree_unflatten(
                [e for _, e in out], spec)))


def psum_int8(x: torch.Tensor, group=None) -> torch.Tensor:
    """Int8-quantize at the group's largest scale, all-reduce the int8
    values as int32 (exact, order-independent), dequantize."""
    scale = _int8_scale(x)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.to(torch.float32) * scale


def psum_int32(x: torch.Tensor, group=None) -> torch.Tensor:
    """Exact all-reduce (sum) of int32 partial accumulators over
    ``group``, in place; returns ``x``.

    Each rank contributes the int32 partial dot over its head slice; the
    integer sum is exact and order-independent, so a requant applied
    after it rounds once, on the accumulator a single device would have
    produced.  Any other dtype raises."""
    if x.dtype != torch.int32:
        raise TypeError(f"psum_int32 takes int32, got {x.dtype}")
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x
