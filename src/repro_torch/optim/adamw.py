"""AdamW over the port's param trees (twin of ``repro.optim.adamw``).

Decoupled weight decay (on every leaf, norms and the embedding
included, as the reference), global-norm gradient clipping, and bf16 or
f32 moments (``moment_dtype``).

Over a mesh (``specs`` / ``mesh`` given: each param the rank's block of
its spec), ``zero1=True`` holds each moment as the rank's slice over
``data`` of its param's block, on the first dim of the block that
divides (the reference's ``_zero1_shard``): the step reduce-scatters the
gradients over ``data`` onto that slice (``launch.steps``), the update
runs on the slice and the params are all-gathered back over ``data``.
The clip's global norm is a sum of squares all-reduced over the world,
each element counted once (a block held by several ranks is counted by
the one whose index along every axis it is replicated over is 0).
Without a mesh ``zero1`` changes nothing, as in the reference on one
device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core.treepath import tree_leaves, tree_map
from repro_torch.distributed.sharding import (_all_reduce_, _gather,
                                              _is_spec, spec_axes)

Pytree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor           # 0-d int32
    m: Pytree
    v: Pytree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"
    zero1: bool = False


def zero1_dim(spec, local_shape, mesh):
    """The dim of a param block (``local_shape``, ``spec``) that ZeRO-1
    slices over ``data``: the first whose size divides by the data axis's
    (and is at least it); None where the block is sharded over ``data``
    already, the data axis has size 1, or no dim divides."""
    d = mesh.axis_size("data")
    if d == 1 or any("data" in spec_axes(e) for e in spec):
        return None
    for i, n in enumerate(local_shape):
        if n % d == 0 and n >= d:
            return i
    return None


def moment_spec(spec, local_shape, mesh, zero1: bool) -> tuple:
    """The spec of a moment of a param block: the param's, with ``data``
    appended on :func:`zero1_dim` under ZeRO-1."""
    i = zero1_dim(spec, local_shape, mesh) if zero1 else None
    if i is None:
        return tuple(spec)
    out = list(spec)
    out[i] = spec_axes(out[i]) + ("data",) if out[i] is not None else "data"
    return tuple(out)


def moment_specs(params: Pytree, specs: Pytree, mesh, zero1: bool):
    """:func:`moment_spec` of every leaf of ``params`` (the rank's
    blocks of ``specs``)."""
    return tree_map(lambda p, s: moment_spec(s, tuple(p.shape), mesh, zero1),
                    params, specs, is_leaf=_is_leaf)


def _is_leaf(x) -> bool:
    return isinstance(x, torch.Tensor) or _is_spec(x)


def _zero1_block(x, spec, mesh, zero1: bool):
    """The rank's ZeRO-1 slice of a param block ``x`` (``x`` itself where
    it has none)."""
    i = zero1_dim(spec, tuple(x.shape), mesh) if zero1 else None
    if i is None:
        return x
    k = x.shape[i] // mesh.axis_size("data")
    return x.narrow(i, mesh.index("data") * k, k)


def adamw_init(params: Pytree, cfg: AdamWConfig, specs=None,
               mesh=None) -> AdamWState:
    """Zero moments of ``moment_dtype`` beside each leaf, step 0 (int32,
    on the first leaf's device).  With ``specs`` / ``mesh`` and
    ``cfg.zero1``: each moment the rank's ZeRO-1 slice of its param's
    block."""
    dt = getattr(torch, cfg.moment_dtype)
    dev = tree_leaves(params)[0].device

    def zeros(p, s=None):
        if s is not None:
            p = _zero1_block(p, s, mesh, cfg.zero1)
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    if specs is None:
        m = tree_map(zeros, params)
        v = tree_map(zeros, params)
    else:
        m = tree_map(zeros, params, specs, is_leaf=_is_leaf)
        v = tree_map(zeros, params, specs, is_leaf=_is_leaf)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=m, v=v)


def global_norm(tree: Pytree):
    """sqrt of the sum of every leaf's squares, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def _owned(spec, mesh) -> bool:
    """Whether this rank counts a block of ``spec`` in a world sum: its
    index is 0 along every mesh axis the block is replicated over."""
    held = {a for e in spec for a in spec_axes(e)}
    return all(mesh.coords[a] == 0 for a in mesh.axis_names
               if a not in held)


def sharded_global_norm(grads: Pytree, mspecs: Pytree, mesh):
    """The global norm of gradients held as the rank's blocks of
    ``mspecs``: each leaf's sum of squares over the blocks this rank
    owns (:func:`_owned`), all-reduced over the world as one vector, then
    summed leaf after leaf, as :func:`global_norm` sums them."""
    pairs = list(zip(tree_leaves(grads),
                     tree_leaves(mspecs, is_leaf=_is_spec)))
    dev = pairs[0][0].device
    sq = torch.stack([
        torch.sum(torch.square(g.to(torch.float32))) if _owned(s, mesh)
        else torch.zeros((), dtype=torch.float32, device=dev)
        for g, s in pairs])
    if mesh.size > 1:
        _all_reduce_(sq, None, kind="norm_all_reduce")
    return torch.sqrt(sum(sq[i] for i in range(len(pairs))))


@torch.no_grad()
def adamw_update(grads: Pytree, state: AdamWState, params: Pytree,
                 cfg: AdamWConfig, lr_scale=1.0, specs=None, mesh=None):
    """Returns (new_params, new_state, metrics).  The update runs in
    float32 whatever the leaves' dtypes; the params keep theirs, the
    moments take ``moment_dtype``.  ``lr_scale``: a float or a 0-d
    tensor (a schedule's value; never read on the host).

    With ``specs`` / ``mesh``: ``params`` are the rank's blocks of
    ``specs``, ``grads`` and the moments the rank's blocks of their
    :func:`moment_specs` (the whole gradient of those elements, summed
    over the ranks); the update of each element is the unsharded one,
    bit for bit, given the same clip scale."""
    dt = getattr(torch, cfg.moment_dtype)
    sharded = specs is not None and mesh is not None
    if sharded:
        mspecs = moment_specs(params, specs, mesh, cfg.zero1)
        gnorm = sharded_global_norm(grads, mspecs, mesh)
    else:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0) \
        if cfg.clip_norm > 0 else 1.0
    step = state.step + 1
    bc1 = 1.0 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1.0 - cfg.b2 ** step.to(torch.float32)
    lr = cfg.lr * lr_scale

    def upd(g, m, v, p):
        g = g.to(torch.float32) * scale
        m_new = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
        v_new = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g * g
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.to(torch.float32)
        p_new = (p.to(torch.float32) - lr * delta).to(p.dtype)
        return p_new, m_new.to(dt), v_new.to(dt)

    if not sharded:
        out = tree_map(upd, grads, state.m, state.v, params)
    else:
        def upd_block(g, m, v, p, s):
            i = zero1_dim(s, tuple(p.shape), mesh) if cfg.zero1 else None
            p_new, m_new, v_new = upd(g, m, v,
                                      _zero1_block(p, s, mesh, cfg.zero1))
            if i is not None:
                p_new = _gather(p_new, i, mesh.group("data"),
                                mesh.axis_size("data"),
                                kind="param_all_gather")
            return p_new, m_new, v_new

        out = tree_map(upd_block, grads, state.m, state.v, params, specs,
                       is_leaf=_is_leaf)
    pick = [tree_map(lambda t, i=i: t[i], out, is_leaf=_is_triple)
            for i in range(3)]
    return pick[0], AdamWState(step, pick[1], pick[2]), {"grad_norm": gnorm}


def _is_triple(t) -> bool:
    return isinstance(t, tuple) and len(t) == 3 \
        and all(isinstance(x, torch.Tensor) for x in t)
