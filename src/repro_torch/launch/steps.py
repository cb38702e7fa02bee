"""Step builders (twin of ``repro.launch.steps``).

``make_train_step`` returns the QAT train step: the loss and its
gradients (``torch.autograd``), optionally accumulated over
microbatches, then one AdamW update.
``make_prefill_step`` closes over the config, the plans and the op set
and returns the full-sequence integer forward: the paper's encoder path
(RoBERTa-base) and the full-sequence prefill of every decoder, over an
encoder's or an image memory too.
``make_decode_step`` returns one decode step over contiguous caches
(``inttransformer.init_decode_cache`` without a layout).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.treepath import (tree_flatten_with_path, tree_map,
                                       tree_unflatten_like)
from repro_torch.device import resolve_device
from repro_torch.models import inttransformer as it
from repro_torch.models.common import ArchConfig
from repro_torch.ops import resolve_ops
from repro_torch.optim import adamw_update
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.quant import plans as qplans
from repro_torch.quant import qat


#: the batch's float memory inputs: the frame embeddings of an
#: encoder-decoder, the image embeddings of a VLM
MEMORY_KEYS = ("src_embeds", "img_embeds")


def _value_and_grad(params, batch, cfg: ArchConfig, qat_enabled: bool):
    """((loss, (ce, aux)), grads): ``qat.loss_fn`` differentiated with
    respect to every leaf of ``params`` (each taken as a fresh
    ``requires_grad`` leaf), the grads in the leaves' dtypes."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, (ce, aux) = qat.loss_fn(leaves, batch, cfg, qat=qat_enabled)
    paths, flat = zip(*tree_flatten_with_path(leaves))
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_path = {path: torch.zeros_like(p) if g is None else g
               for path, p, g in zip(paths, flat, grads)}
    return ((loss.detach(), (ce.detach(), aux.detach())),
            tree_unflatten_like(leaves, lambda path, _: by_path[path]))


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig,
                    lr_fn: Optional[Callable] = None,
                    qat_enabled: bool = True, accum_steps: int = 1,
                    device="cuda"):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``: QAT loss and gradients, then ``adamw_update``
    at ``lr_fn(opt_state.step)`` (the step before the update's increment,
    as the reference: ``linear_warmup_cosine`` makes the first update a
    zero step that moves only the moments and the count).  ``batch``'s
    arrays (tokens, labels and a memory family's embeddings) are moved
    to ``device`` (default the card; raises without one unless given
    ``device="cpu"``).

    ``accum_steps`` > 1 splits the batch into that many microbatches and
    averages their float32 gradients (activation memory / accum_steps);
    the ``loss`` it reports is then the mean ce without the aux term,
    as the reference's.  Without a mesh there is nothing to pin, so the
    reference's ``param_specs`` has no counterpart here."""
    lr_fn = lr_fn or (lambda step: 1.0)
    dev = resolve_device(device)

    def train_step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if accum_steps == 1:
            (loss, (ce, aux)), grads = _value_and_grad(
                params, batch, cfg, qat_enabled)
        else:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            ce = torch.zeros((), dtype=torch.float32, device=dev)
            aux = torch.zeros((), dtype=torch.float32, device=dev)
            micro = {k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            for i in range(accum_steps):
                (_, (ce_i, a)), g = _value_and_grad(
                    params, {k: v[i] for k, v in micro.items()}, cfg,
                    qat_enabled)
                grads = tree_map(lambda ga, gi: ga + gi.to(torch.float32),
                                 grads, g)
                ce, aux = ce + ce_i, aux + a
            grads = tree_map(lambda g: g / accum_steps, grads)
            ce, aux = ce / accum_steps, aux / accum_steps
            loss = ce
        params, opt_state, metrics = adamw_update(
            grads, opt_state, params, opt_cfg,
            lr_scale=lr_fn(opt_state.step))
        metrics.update({"loss": loss, "ce": ce, "aux": aux})
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, plans: qplans.LayerPlans, ops=None,
                      device="cuda"):
    """Returns ``prefill(qparams, batch[, rope_tab]) -> (B, V)`` float32
    last-position logits.  ``batch["tokens"]``: (B, S) token ids, and an
    encoder-decoder's ``src_embeds`` / a VLM's ``img_embeds`` (B, Sm, D)
    as float32, moved to ``device`` (default the card; raises without one
    unless given ``device="cpu"``).  With ``cfg.pos == "rope"`` the
    integer RoPE tables are an argument, as in the reference.  ``ops``: as
    ``ops.resolve_ops(ops, cfg)`` (e.g. ``"cuda_online"`` for the online
    attention)."""
    ops = resolve_ops(ops, cfg)
    dev = resolve_device(device)

    def _batch(batch):
        out = {**batch, "tokens": torch.as_tensor(batch["tokens"],
                                                  device=dev)}
        for key in MEMORY_KEYS:
            if key in batch:
                out[key] = torch.as_tensor(batch[key], dtype=torch.float32,
                                           device=dev)
        return out

    if cfg.pos == "rope":
        def prefill(qparams, batch, rope_tab):
            return it.int_prefill(qparams, _batch(batch), plans, cfg,
                                  ops=ops, rope_tab=rope_tab)
    else:
        def prefill(qparams, batch):
            return it.int_prefill(qparams, _batch(batch), plans, cfg,
                                  ops=ops)
    return prefill


def make_decode_step(cfg: ArchConfig, plans: qplans.LayerPlans,
                     cache_len: int, ops=None, device="cuda"):
    """Returns ``decode(qparams, caches, tokens, pos[, rope_tab]) ->
    (logits (B, V) float32, caches)``: one token a lane over contiguous
    caches of ``cache_len`` positions (a sliding window rolls within
    ``min(cache_len, cfg.window)``), written in place.  ``tokens`` and
    ``pos`` (B,) are moved to ``device`` (default the card; raises
    without one unless given ``device="cpu"``).  With ``cfg.pos ==
    "rope"`` the integer RoPE tables are an argument, as in the
    reference."""
    ops = resolve_ops(ops, cfg)
    dev = resolve_device(device)

    def _on(tokens, pos):
        return (torch.as_tensor(tokens, device=dev),
                torch.as_tensor(pos, dtype=torch.int32, device=dev))

    if cfg.pos == "rope":
        def decode(qparams, caches, tokens, pos, rope_tab):
            return it.int_decode_step(qparams, caches, *_on(tokens, pos),
                                      plans, cfg, rope_tab, ops=ops)
    else:
        def decode(qparams, caches, tokens, pos):
            return it.int_decode_step(qparams, caches, *_on(tokens, pos),
                                      plans, cfg, None, ops=ops)
    return decode
