"""Logical-axis sharding over a mesh of ``torch.distributed`` ranks (twin
of ``repro.distributed.sharding``).

The reference annotates activations with *logical* axes and lets the
partitioner move data; here every rank holds its own block and the
model code moves data itself, with the collectives below.  The rules
are the reference's: ``LOGICAL_RULES`` maps a logical axis onto the
mesh axes in scope, :func:`pspec` builds a spec (a tuple: one entry a
dim, None, an axis name or a tuple of names), and outside a mesh
everything is the identity.

The collectives are ``torch.autograd.Function`` s whose backward is the
exact transpose of their forward (an all-gather's is a reduce-scatter,
a reduce-scatter's an all-gather, an all-reduce's an all-reduce).  Each
rank's loss is its share of the world's (the shares sum to it), so the
gradient of a tensor a rank holds is the sum, over the ranks that hold
the same block, of their local gradients (``launch.steps`` sums them).

* :func:`comm_quant_gather` — the int8 transport of the sequence-parallel
  gather at the attention / FFN inputs: the rank's sequence block is
  quantized to int8 with the reference's ``clip(round(x / s), -127,
  127)``, the int8 tensor is all-gathered over ``model``, then
  dequantized; the backward is straight-through, a reduce-scatter of the
  cotangent back to the rank's block (``_cq_bwd``).  On a mesh whose
  sequence is not sharded it only quantizes; without a mesh it is the
  identity.
* :func:`constrain_like_params` — the per-layer gather of sharded
  weights (FSDP's ``data`` blocks, and the ``model`` blocks of every
  leaf the layers do not consume sharded), inside the layer loop.
"""
from __future__ import annotations

import fnmatch
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import current_mesh

# logical axis -> tuple of physical mesh axes (filtered by availability)
LOGICAL_RULES = {
    "batch": ("pod", "data"),
    "seq": (),                  # sequence kept replicated (SP is a §Perf knob)
    "seq_sharded": ("model",),  # long-context sequence sharding
    "heads": ("model",),
    "kv_heads": ("model",),     # only applied when kv_heads divides
    "ffn": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "embed": (),                # d_model replicated
    "state": (),
    None: (),
}

#: the layer leaves whose ``model`` blocks the layers consume as they
#: are: column-parallel q / k / v, w1 / w3 (and their biases) and
#: row-parallel wo / w2 of self and cross attention and the dense FFN
#: (paths within one sublayer's params)
TP_LEAVES = ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "attn/bq",
             "attn/bk", "attn/bv", "cross/wq", "cross/wk", "cross/wv",
             "cross/wo", "cross/bq", "cross/bk", "cross/bv", "ffn/w1",
             "ffn/w3", "ffn/w2", "ffn/b1")


def current_axes() -> Tuple[str, ...]:
    mesh = current_mesh()
    return () if mesh is None else tuple(mesh.axis_names)


def pspec(*logical) -> tuple:
    """A spec from logical axis names for the current mesh."""
    avail = current_axes()
    out = []
    for name in logical:
        phys = tuple(a for a in LOGICAL_RULES.get(name, ()) if a in avail)
        if len(phys) == 0:
            out.append(None)
        elif len(phys) == 1:
            out.append(phys[0])
        else:
            out.append(phys)
    return tuple(out)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def block(x: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    """The rank's block of ``x`` along ``dim`` split over ``axes`` (the
    first major); ``x`` itself where they have size 1."""
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {axes} ({n})")
    k = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axes) * k, k)


def shard(x, *logical):
    """The rank's block of ``x`` (which holds the whole of every dim) by
    logical axes; a slice, never a collective.  No mesh: ``x``."""
    mesh = current_mesh()
    if mesh is None:
        return x
    for dim, entry in enumerate(pspec(*logical)):
        x = block(x, dim, spec_axes(entry), mesh)
    return x


def residual_seq_sharded(seq_len: int) -> bool:
    """The reference's rule for the residual stream: its sequence dim
    shards over ``model`` when it divides and holds at least 16
    positions a rank."""
    mesh = current_mesh()
    m = 1 if mesh is None else mesh.axis_size("model")
    return m > 1 and seq_len % m == 0 and seq_len >= m * 16


def shard_residual(x):
    """The residual stream ``x`` (B, S, D), whole along S: the rank's
    sequence block over ``model`` where :func:`residual_seq_sharded`
    holds, else ``x`` (the batch dim is the rank's already)."""
    if x.dim() >= 2 and residual_seq_sharded(x.shape[1]):
        return block(x, 1, "model", current_mesh())
    return x


# ------------------------------------------------------ the collectives ---

#: collective calls and their wire bytes since :func:`reset_traffic`, by
#: kind (``comm_quant`` counts the int8 payload of :func:`comm_quant_gather`)
TRAFFIC = {}
#: where a list, every collective on CUDA tensors appends ``(kind, start,
#: end)`` CUDA events around itself (``chip_smoke.py`` reads them)
EVENTS = None


def reset_traffic() -> None:
    TRAFFIC.clear()


def _collective(kind: str, t: torch.Tensor, fn):
    """Run ``fn()`` (a collective on ``t``), counting its bytes under
    ``kind`` and timing it where :data:`EVENTS` is a list."""
    c = TRAFFIC.setdefault(kind, {"calls": 0, "bytes": 0})
    c["calls"] += 1
    c["bytes"] += t.numel() * t.element_size()
    if EVENTS is None or not t.is_cuda:
        return fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    out = fn()
    ev[1].record()
    EVENTS.append((kind, ev[0], ev[1]))
    return out


# torch >= 2.13 names them ``*_single`` (the ``*_tensor`` names warn)
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _gather(x: torch.Tensor, dim: int, group, n: int,
            kind: str = "all_gather") -> torch.Tensor:
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _collective(kind, xt, lambda: _ALL_GATHER(out, xt, group=group))
    return out.movedim(0, dim)


def _scatter(x: torch.Tensor, dim: int, group, n: int,
             kind: str = "reduce_scatter") -> torch.Tensor:
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _collective(kind, xt, lambda: _REDUCE_SCATTER(
        out, xt, op=dist.ReduceOp.SUM, group=group))
    return out.movedim(0, dim)


def _all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM,
                 kind: str = "all_reduce") -> torch.Tensor:
    """In-place all-reduce of a contiguous ``x``; returns ``x``."""
    _collective(kind, x, lambda: dist.all_reduce(x, op=op, group=group))
    return x


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over a group; backward reduce-scatter."""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.args = (dim, group, n)
        return _gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        dim, group, n = ctx.args
        return _scatter(g, dim, group, n), None, None, None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter (sum) along ``dim`` over a group; backward
    all-gather."""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.args = (dim, group, n)
        return _scatter(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        dim, group, n = ctx.args
        return _gather(g, dim, group, n), None, None, None


class _AllReduce(torch.autograd.Function):
    """All-reduce (sum) over a group; backward all-reduce (sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), ctx.group), None


def gather(x, dim: int, axes, mesh=None):
    """All-gather ``x`` along ``dim`` over the mesh ``axes`` (autograd:
    the backward reduce-scatters); ``x`` where they have size 1."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.axis_size(axes) == 1:
        return x
    return _Gather.apply(x, dim, mesh.group(axes), mesh.axis_size(axes))


def reduce_scatter(x, dim: int, axes, mesh=None):
    """Reduce-scatter (sum) ``x`` along ``dim`` over ``axes`` (autograd:
    the backward all-gathers)."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.axis_size(axes) == 1:
        return x
    return _Scatter.apply(x, dim, mesh.group(axes), mesh.axis_size(axes))


def all_reduce(x, axes, mesh=None):
    """All-reduce (sum) ``x`` over ``axes`` (autograd: the backward
    all-reduces the cotangents)."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.axis_size(axes) == 1:
        return x
    return _AllReduce.apply(x, mesh.group(axes))


def all_reduce_max_(x, axes, mesh=None):
    """In-place all-reduce MAX of ``x`` (no gradient) over ``axes``."""
    mesh = mesh or current_mesh()
    if mesh is not None and mesh.axis_size(axes) > 1:
        _all_reduce_(x, mesh.group(axes), dist.ReduceOp.MAX)
    return x


def gather_seq(x, seq_len: Optional[int]):
    """The whole sequence of a residual block ``x`` (B, S / m, D):
    all-gathered over ``model`` (autograd) when ``seq_len`` is given (the
    residual is sequence-sharded), else ``x``."""
    return x if seq_len is None else gather(x, 1, "model")


def scatter_seq(x, seq_len: Optional[int], partial: bool, dtype=None):
    """A layer's (B, S, D) output back into the residual's layout: with
    ``partial`` (each model rank holds a partial sum) reduce-scattered
    over ``model`` along the sequence, or all-reduced where the residual
    holds the whole sequence, in float32, then cast to ``dtype`` (default
    ``x``'s); else (each rank holds the whole sum) the rank's sequence
    block, or ``x``."""
    if partial:
        y = x.to(torch.float32)
        y = all_reduce(y, "model") if seq_len is None \
            else reduce_scatter(y, 1, "model")
        return y.to(dtype or x.dtype)
    return x if seq_len is None else block(x, 1, "model", current_mesh())


def partial_matmul(x, w):
    """``x @ w`` of a row-parallel weight: a partial sum, in float32 (a
    bfloat16 model's output is then rounded once, after the sum over
    the ranks, as a whole-weight matmul's is)."""
    if x.dtype == torch.float32:
        return x @ w
    return x.to(torch.float32) @ w.to(torch.float32)


# ------------------------------------------------------ comm-quant ---------

def _quantize8(x, scale: float):
    s = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8), s


class _CQGather(torch.autograd.Function):
    """int8 quantize, all-gather the int8 block along the sequence over
    ``model`` (``n`` ranks, or no gather where ``n`` is 1), dequantize;
    straight-through backward (a reduce-scatter where it gathered)."""

    @staticmethod
    def forward(ctx, x, scale, group, n):
        ctx.args = (group, n)
        q8, s = _quantize8(x, scale)
        if n > 1:
            q8 = _gather(q8, 1, group, n, kind="comm_quant")
        return q8.to(x.dtype) * s

    @staticmethod
    def backward(ctx, g):
        group, n = ctx.args
        if n > 1:
            g = _scatter(g, 1, group, n)
        return g, None, None, None


def comm_quant_gather(x, scale: float, enabled: bool = True,
                      seq_len: Optional[int] = None):
    """INT8 transport for the sequence-parallel gather boundary.

    ``x`` (B, S / m, D) is the rank's sequence block when ``seq_len``
    (the whole length) is given, else the whole sequence.  Under a mesh
    the result is ``clip(round(x / s), -127, 127) * s`` of the whole
    sequence, the int8 values all-gathered over ``model``; gradients pass
    straight through (reduce-scattered back to the block).  Not
    ``enabled`` or without a mesh: ``x``, as the reference's."""
    mesh = current_mesh()
    if not enabled or mesh is None:
        return x
    if seq_len is None:
        return _CQGather.apply(x, scale, None, 1)
    return _CQGather.apply(x, scale, mesh.group("model"),
                           mesh.axis_size("model"))


# -------------------------------------------------- per-layer gathers ----

def gather_leaf(x, spec, keep=(), mesh=None):
    """The tensor of a leaf held as the rank's block of ``spec``,
    all-gathered (autograd) along every sharded dim over its axes, except
    the axes in ``keep``, which stay the rank's block."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return x
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        kept = tuple(a for a in axes if a in keep)
        if kept and kept != axes[:len(kept)]:
            raise NotImplementedError(f"spec entry {entry}: kept axes "
                                      "must lead")
        for a in reversed(axes[len(kept):]):
            x = gather(x, dim, a, mesh)
    return x


def _is_tp(path: str) -> bool:
    return any(fnmatch.fnmatch(path, "*" + p) for p in TP_LEAVES)


def constrain_like_params(tree, specs):
    """One layer group's params (the rank's blocks, ``specs`` their
    specs) -> the tensors the layers compute with: every leaf gathered
    over every axis it is sharded on (FSDP's ``data``; ``model`` for the
    embedding-like leaves, the MoE's and Mamba's), except the ``model``
    blocks of the tensor-parallel leaves (``TP_LEAVES``).  Called inside
    the layer loop, and recomputed in the backward under remat, so no
    more than one group's gathered weights live at a time.  No mesh:
    ``tree``."""
    if current_mesh() is None or specs is None:
        return tree
    from repro_torch.core.treepath import (path_parts,
                                           tree_flatten_with_path,
                                           tree_unflatten_like)
    flat = {tuple(path_parts(p)): s for p, s in tree_flatten_with_path(
        specs, is_leaf=_is_spec)}

    def leaf(path, x):
        key = tuple(path_parts(path))
        keep = ("model",) if _is_tp("/".join(key)) else ()
        return gather_leaf(x, flat[key], keep)

    return tree_unflatten_like(tree, leaf)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, str) or (
            isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)
