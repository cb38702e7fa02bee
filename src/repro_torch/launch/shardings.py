"""Parameter / input / cache sharding rules (twin of
``repro.launch.shardings``).

Rules are path-pattern based over the param tree: TP on the ``model``
axis for heads / d_ff / vocab / experts, replication for norms and small
tensors, with divisibility guards (e.g. GQA kv heads replicate when
kv < model-axis size; mamba2-130m's fused in_proj width 3352 replicates
while jamba's 16544 shards).  A spec is a tuple with one entry a dim:
None, a mesh axis name, or a tuple of names (the first major).

Where the reference hands its specs to the partitioner (``as_shardings``
/ ``named``), the port moves the numbers itself: :func:`local_shard`
slices a whole tensor to the rank's block of a spec, :func:`gather_full`
all-gathers a block back into the whole tensor.  The rule functions read
only ``axis_names`` / ``axis_sizes`` of the mesh they are given and the
``shape`` of each leaf, so they take any tree whose leaves have a shape.
"""
from __future__ import annotations

import fnmatch
import math
from typing import Any

import torch

from repro_torch.core.treepath import (path_parts, tree_map,
                                       tree_unflatten_like)
from repro_torch.distributed.sharding import (_gather, _is_spec, block,
                                              spec_axes)

Pytree = Any


def _path_str(path) -> str:
    return "/".join(path_parts(path))


# (pattern, spec-template) — template entries: "model" | None | "div:<dim>"
# means: shard dim on model only when divisible.  Matched against the
# flattened path; first match wins.  Shapes are handled by _fit().
PARAM_RULES = [
    # ---- quantized params ----
    ("embed_w8", ("model", None)),
    ("head/w8", (None, "model")),
    ("head_scale", ("model",)),
    ("*attn/wq/w8", (..., None, "model")),
    ("*attn/wq/b_mult", (..., "model")),
    ("*attn/wq/bias32", (..., "model")),
    ("*attn/wk/*", (..., None, "model")),
    ("*attn/wv/*", (..., None, "model")),
    ("*cross/wq/w8", (..., None, "model")),
    ("*cross/wq/b_mult", (..., "model")),
    ("*cross/wk/*", (..., None, "model")),
    ("*cross/wv/*", (..., None, "model")),
    ("*attn/wo/w8", (..., "model", None)),
    ("*cross/wo/w8", (..., "model", None)),
    ("*attn/wo/b_mult", (..., None)),
    ("*moe/router/w8", (..., None, "model")),
    ("*moe/w1/w8", (..., "model", None, "data")),
    ("*moe/w1/b_mult", (..., "model", "data")),
    ("*moe/w3/w8", (..., "model", None, "data")),
    ("*moe/w3/b_mult", (..., "model", "data")),
    ("*moe/w2/w8", (..., "model", "data", None)),
    ("*moe/w2/b_mult", (..., "model", None)),
    ("*moe/shared/w1/*", (..., None, "model")),
    ("*moe/shared/w3/*", (..., None, "model")),
    ("*moe/shared/w2/w8", (..., "model", None)),
    ("*moe/shared/w2/b_mult", (..., None)),
    ("*ffn/w1/*", (..., None, "model")),
    ("*ffn/w3/*", (..., None, "model")),
    ("*ffn/w2/w8", (..., "model", None)),
    ("*ffn/w2/b_mult", (..., None)),
    ("*ssm/in_proj/w8", (..., None, "model")),
    ("*ssm/in_proj/b_mult", (..., "model")),
    ("*ssm/out_proj/w8", (..., "model", None)),
    ("*ssm/out_proj/b_mult", (..., None)),
    ("*ssm/norm_gamma_q", (..., "model")),
    # ---- float params (same geometry, head dims unflattened) ----
    ("embed", ("model", None)),
    ("lm_head", (None, "model")),
    ("pos_embed", (None, None)),
    ("*attn/wq", (..., None, "model", None)),
    ("*attn/wk", (..., None, "model", None)),
    ("*attn/wv", (..., None, "model", None)),
    ("*attn/wo", (..., "model", None, None)),
    ("*attn/bq", (..., "model", None)),
    ("*attn/bk", (..., "model", None)),
    ("*attn/bv", (..., "model", None)),
    ("*cross/wq", (..., None, "model", None)),
    ("*cross/wk", (..., None, "model", None)),
    ("*cross/wv", (..., None, "model", None)),
    ("*cross/wo", (..., "model", None, None)),
    ("*moe/router", (..., None, "model")),
    ("*moe/w1", (..., "model", None, "data")),
    ("*moe/w2", (..., "model", "data", None)),
    ("*moe/w3", (..., "model", None, "data")),
    ("*moe/shared/w1", (..., None, "model")),
    ("*moe/shared/w3", (..., None, "model")),
    ("*moe/shared/w2", (..., "model", None)),
    ("*ffn/w1", (..., None, "model")),
    ("*ffn/w3", (..., None, "model")),
    ("*ffn/w2", (..., "model", None)),
    ("*ffn/b1", (..., "model")),
    ("*ssm/in_proj", (..., None, "model")),
    ("*ssm/out_proj", (..., "model", None)),
    ("*ssm/norm_gamma", (..., "model")),
]


def _sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.axis_sizes))


def _fit(template, shape, sizes: dict) -> tuple:
    """Expand a template against a concrete shape with divisibility guards."""
    tpl = list(template)
    if tpl and tpl[0] is Ellipsis:
        tpl = [None] * (len(shape) - (len(tpl) - 1)) + tpl[1:]
    if len(tpl) != len(shape):        # rank mismatch -> replicate
        return (None,) * len(shape)
    out = []
    for dim, t in zip(shape, tpl):
        sz = sizes.get(t, 1) if isinstance(t, str) else 1
        if isinstance(t, str) and sz > 1 and dim % sz == 0 and dim >= sz:
            out.append(t)
        else:
            out.append(None)
    return tuple(out)


def _numel(leaf) -> int:
    return math.prod(int(s) for s in leaf.shape)


def param_pspecs(tree: Pytree, mesh, fsdp: bool = False) -> Pytree:
    """Spec tree for a (float or quantized) param tree of whole (global)
    shapes.

    ``fsdp``: additionally spread every large weight over the ``data``
    axis (first unsharded divisible dim) — per-layer all-gather in
    exchange for /DP-degree parameter memory (used for >20B models)."""
    sizes = _sizes(mesh)
    dsize = sizes.get("data", 1)

    def spec_for(path, leaf):
        ps = _path_str(path)
        spec = (None,) * len(leaf.shape)
        for pat, tpl in PARAM_RULES:
            if fnmatch.fnmatch(ps, pat) or fnmatch.fnmatch(ps, "*" + pat):
                spec = _fit(tpl, leaf.shape, sizes)
                break
        if fsdp and _numel(leaf) >= (1 << 24) and dsize > 1:
            flat = [a for s in spec for a in spec_axes(s)]
            if "data" not in flat:
                out = list(spec)
                best, best_dim = None, 0
                for i, (s, dim) in enumerate(zip(out, leaf.shape)):
                    if s is None and dim % dsize == 0 and dim > best_dim:
                        best, best_dim = i, dim
                if best is not None:
                    out[best] = "data"
                    spec = tuple(out)
        return spec

    return tree_unflatten_like(tree, spec_for)


def batch_pspecs(batch: Pytree, mesh) -> Pytree:
    """Inputs: batch dim over (pod, data); everything else replicated.
    Batch-1 (long-context) inputs replicate."""
    daxes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    sizes = _sizes(mesh)
    dsize = 1
    for a in daxes:
        dsize *= sizes[a]

    def spec_for(path, leaf):
        if not leaf.shape:
            return ()
        b = leaf.shape[0]
        first = daxes if (b % dsize == 0 and b >= dsize) else None
        if isinstance(first, tuple) and len(first) == 1:
            first = first[0]
        if first == ():
            first = None
        return (first,) + (None,) * (len(leaf.shape) - 1)

    return tree_unflatten_like(batch, spec_for)


def cache_pspecs(cache: Pytree, mesh, cfg) -> Pytree:
    """Decode caches: (ng, B, L, Hkv, hd) — batch over data axes when
    divisible, kv-heads / mamba-heads / conv channels over model when
    divisible."""
    sizes = _sizes(mesh)
    msize = sizes.get("model", 1)
    daxes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    dsize = 1
    for a in daxes:
        dsize *= sizes[a]
    dax = daxes[0] if len(daxes) == 1 else daxes

    def spec_for(path, leaf):
        ps = _path_str(path)
        shape = leaf.shape
        spec = [None] * len(shape)
        if len(shape) >= 2 and shape[1] % dsize == 0 and shape[1] >= dsize:
            spec[1] = dax
        # shard the "heads"-like dim on model when divisible
        name = ps.rsplit("/", 1)[-1]
        head_dim_idx = {"k8": 3, "v8": 3, "ck8": 3, "cv8": 3, "h": 2,
                        "conv": 3}.get(name)
        if head_dim_idx is not None and head_dim_idx < len(shape):
            if shape[head_dim_idx] % msize == 0 \
                    and shape[head_dim_idx] >= msize and msize > 1:
                spec[head_dim_idx] = "model"
            elif name in ("k8", "v8") and len(shape) >= 3 \
                    and shape[2] % msize == 0 and msize > 1:
                # GQA kv heads too few to shard -> shard the sequence dim
                # of the cache instead (long-context decode)
                spec[2] = "model"
        return tuple(spec)

    return tree_unflatten_like(cache, spec_for)


# ------------------------------------------------ blocks <-> whole ------

def local_shard(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The rank's block of the whole tensor ``x`` under ``spec`` (a
    view: slices only)."""
    for dim, entry in enumerate(spec):
        x = block(x, dim, spec_axes(entry), mesh)
    return x


def gather_full(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor of the rank's block ``x`` under ``spec``:
    all-gathered along every sharded dim (the inverse of
    :func:`local_shard`; every rank of the mesh must call it)."""
    for dim, entry in enumerate(spec):
        for a in reversed(spec_axes(entry)):
            n = mesh.axis_size(a)
            if n > 1:
                x = _gather(x.detach(), dim, mesh.group(a), n)
    return x.contiguous()


def global_shape(local_shape, spec, mesh) -> tuple:
    """The whole shape of a block of ``local_shape`` under ``spec``."""
    return tuple(int(s) * mesh.axis_size(spec_axes(e))
                 for s, e in zip(local_shape, spec))


def shard_tree(tree: Pytree, specs: Pytree, mesh) -> Pytree:
    """:func:`local_shard` of every leaf, each a contiguous copy."""
    return tree_map(lambda x, s: local_shard(x, s, mesh).contiguous(),
                    tree, specs, is_leaf=_leaf_or_spec)


def gather_tree(tree: Pytree, specs: Pytree, mesh) -> Pytree:
    """:func:`gather_full` of every leaf."""
    return tree_map(lambda x, s: gather_full(x, s, mesh), tree, specs,
                    is_leaf=_leaf_or_spec)


def _leaf_or_spec(x) -> bool:
    return isinstance(x, torch.Tensor) or _is_spec(x)
