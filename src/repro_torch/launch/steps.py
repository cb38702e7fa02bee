"""Step builders (twin of the inference half of ``repro.launch.steps``).

``make_prefill_step`` closes over the config, the plans and the op set
and returns the full-sequence integer forward: the paper's encoder path
(RoBERTa-base) and the full-sequence prefill of every decoder, over an
encoder's or an image memory too.
``make_decode_step`` returns one decode step over contiguous caches
(``inttransformer.init_decode_cache`` without a layout).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import inttransformer as it
from repro_torch.models.common import ArchConfig
from repro_torch.ops import resolve_ops
from repro_torch.quant import plans as qplans


#: the batch's float memory inputs: the frame embeddings of an
#: encoder-decoder, the image embeddings of a VLM
MEMORY_KEYS = ("src_embeds", "img_embeds")


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
