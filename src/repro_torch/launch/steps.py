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
from repro_torch.distributed.sharding import (_all_reduce_, _scatter,
                                              all_reduce, spec_axes)
from repro_torch.launch.mesh import set_mesh
from repro_torch.launch.shardings import batch_pspecs, local_shard
from repro_torch.models import inttransformer as it
from repro_torch.models.common import ArchConfig
from repro_torch.ops import resolve_ops
from repro_torch.optim import adamw_update
from repro_torch.optim.adamw import AdamWConfig, _is_leaf, zero1_dim
from repro_torch.quant import plans as qplans
from repro_torch.quant import qat


#: the batch's float memory inputs: the frame embeddings of an
#: encoder-decoder, the image embeddings of a VLM
MEMORY_KEYS = ("src_embeds", "img_embeds")


def _value_and_grad(params, batch, cfg: ArchConfig, qat_enabled: bool,
                    specs=None):
    """((loss, (ce, aux)), grads): ``qat.loss_fn`` differentiated with
    respect to every leaf of ``params`` (each taken as a fresh
    ``requires_grad`` leaf), the grads in the leaves' dtypes.  Under a
    mesh the loss is the rank's share and the grads the rank's parts."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, (ce, aux) = qat.loss_fn(leaves, batch, cfg, qat=qat_enabled,
                                  specs=specs)
    paths, flat = zip(*tree_flatten_with_path(leaves))
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_path = {path: torch.zeros_like(p) if g is None else g
               for path, p, g in zip(paths, flat, grads)}
    return ((loss.detach(), (ce.detach(), aux.detach())),
            tree_unflatten_like(leaves, lambda path, _: by_path[path]))


def sync_grads(grads, params, specs, mesh, zero1: bool):
    """The ranks' gradient parts -> the whole gradient of each element a
    rank holds, in the gradient's dtype (as the reference sums them):
    each leaf summed over the ranks that hold the same block (the mesh
    axes its spec does not shard), reduce-scattered over ``data`` onto
    its ZeRO-1 slice where it has one (``optim.adamw.zero1_dim``) and
    all-reduced over the other axes."""
    def one(g, p, s):
        held = {a for e in s for a in spec_axes(e)}
        rep = [a for a in mesh.axis_names
               if a not in held and mesh.axis_size(a) > 1]
        i = zero1_dim(s, tuple(p.shape), mesh) if zero1 else None
        if i is not None:
            g = _scatter(g, i, mesh.group("data"), mesh.axis_size("data"),
                         kind="grad_reduce_scatter")
            rep.remove("data")
        if rep:
            g = _all_reduce_(g.contiguous(), mesh.group(tuple(rep)),
                             kind="grad_all_reduce")
        return g

    return tree_map(one, grads, params, specs, is_leaf=_is_leaf)


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig,
                    lr_fn: Optional[Callable] = None,
                    qat_enabled: bool = True, accum_steps: int = 1,
                    device="cuda", param_specs=None, mesh=None):
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
    as the reference's.

    ``mesh`` (``launch.mesh.make_mesh``): the step runs under it (on a
    ``(1, 1)`` mesh that switches the reference's comm-quant on), with
    ``params`` the rank's blocks of ``param_specs``
    (``launch.shardings.param_pspecs`` of the whole tree) and the
    moments ``adamw_init(params, opt_cfg, param_specs, mesh)``'s.
    ``batch`` is the *global* batch, the same on every rank (the
    reference's single controller builds one); the rank takes its
    ``batch_pspecs`` rows (its microbatches split those), and the
    gradients are summed over the ranks (``sync_grads``) before the
    update.  The metrics are the world's."""
    lr_fn = lr_fn or (lambda step: 1.0)
    dev = resolve_device(device)
    specs = param_specs
    if mesh is not None and specs is None:
        raise ValueError("a mesh needs the param_specs of the whole tree")

    def local_batch(batch):
        out = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if mesh is None:
            return out
        bspecs = batch_pspecs(out, mesh)
        return {k: local_shard(v, bspecs[k], mesh) for k, v in out.items()}

    def grads_of(params, batch):
        if accum_steps == 1:
            return _value_and_grad(params, batch, cfg, qat_enabled, specs)
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
                qat_enabled, specs)
            grads = tree_map(lambda ga, gi: ga + gi.to(torch.float32),
                             grads, g)
            ce, aux = ce + ce_i, aux + a
        grads = tree_map(lambda g: g / accum_steps, grads)
        ce, aux = ce / accum_steps, aux / accum_steps
        return (ce, (ce, aux)), grads

    def train_step(params, opt_state, batch):
        batch = local_batch(batch)
        with set_mesh(mesh):
            (loss, (ce, aux)), grads = grads_of(params, batch)
        if mesh is not None and mesh.size > 1:
            grads = sync_grads(grads, params, specs, mesh, opt_cfg.zero1)
            if accum_steps == 1:
                loss = all_reduce(loss, mesh.axis_names, mesh)
            params, opt_state, metrics = adamw_update(
                grads, opt_state, params, opt_cfg,
                lr_scale=lr_fn(opt_state.step), specs=specs, mesh=mesh)
        else:
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
