"""AdamW over the port's param trees (twin of ``repro.optim.adamw``).

Decoupled weight decay (on every leaf, norms and the embedding
included, as the reference), global-norm gradient clipping, and bf16 or
f32 moments (``moment_dtype``).  ``zero1`` is kept in the config and is a
no-op here, as it is in the reference without a mesh: sharding the
moments over data-parallel ranks is the multi-card half of training.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core.treepath import tree_leaves, tree_map

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


def adamw_init(params: Pytree, cfg: AdamWConfig) -> AdamWState:
    """Zero moments of ``moment_dtype`` beside each leaf, step 0 (int32,
    on the first leaf's device)."""
    dt = getattr(torch, cfg.moment_dtype)
    dev = tree_leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree: Pytree):
    """sqrt of the sum of every leaf's squares, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads: Pytree, state: AdamWState, params: Pytree,
                 cfg: AdamWConfig, lr_scale=1.0):
    """Returns (new_params, new_state, metrics).  The update runs in
    float32 whatever the leaves' dtypes; the params keep theirs, the
    moments take ``moment_dtype``.  ``lr_scale``: a float or a 0-d
    tensor (a schedule's value; never read on the host)."""
    dt = getattr(torch, cfg.moment_dtype)
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

    out = tree_map(upd, grads, state.m, state.v, params)
    pick = [tree_map(lambda t, i=i: t[i], out, is_leaf=_is_triple)
            for i in range(3)]
    return pick[0], AdamWState(step, pick[1], pick[2]), {"grad_norm": gnorm}


def _is_triple(t) -> bool:
    return isinstance(t, tuple) and len(t) == 3 \
        and all(isinstance(x, torch.Tensor) for x in t)
