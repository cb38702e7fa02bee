"""Quantization-aware training: the producer of SwiftTron checkpoints
(twin of ``repro.quant.qat``).

``loss_fn`` runs the float model with straight-through fake quantization
on every tensor the accelerator sees in INT8 / INT10 (weights
per-channel, activations per-tensor on the design grids), so the trained
weights land on the integer grid that ``quant.convert`` freezes.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as fl
from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import forward_float


def _ce_terms(logits, labels, z_loss: float):
    """(sum of the masked NLL and z-loss, the count of labels >= 0).
    The gold logit is a gather, which equals the reference's one-hot
    contraction exactly (every other term of that sum is 0)."""
    lf = logits.to(torch.float32)
    m = torch.amax(lf, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    gold = torch.gather(lf, -1, torch.clamp(labels, min=0)[..., None]
                        .to(torch.int64))[..., 0]
    mask = (labels >= 0).to(torch.float32)
    nll = (lse - gold) * mask
    zl = z_loss * torch.square(lse) * mask
    return torch.sum(nll) + torch.sum(zl), torch.sum(mask)


def cross_entropy(logits, labels, vocab: int, z_loss: float = 1e-4):
    """Token CE with padding mask (label < 0 ignored) and z-loss."""
    tot, cnt = _ce_terms(logits, labels, z_loss)
    return tot / torch.clamp(cnt, min=1.0)


def chunked_ce(x, w, labels, cfg: ArchConfig, chunk: int = 512,
               z_loss: float = 1e-4):
    """Sequence-chunked CE: the logits of a chunk of at most ``chunk``
    positions (the largest divisor of S not above it) are made inside
    ``torch.utils.checkpoint`` and recomputed in the backward, so no more
    than one chunk's (B, chunk, V) logits exist at a time."""
    b, s, d = x.shape
    ck = min(chunk, s)
    while s % ck:
        ck -= 1

    def piece(xc, lc):
        return _ce_terms(xc @ w, lc, z_loss)

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, ck):
        t, k = checkpoint(piece, x[:, i:i + ck], labels[:, i:i + ck],
                          use_reentrant=False)
        tot, cnt = tot + t, cnt + k
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(params, batch, cfg: ArchConfig, qat: bool = True,
            aux_weight: float = 0.01):
    """Returns (ce + aux_weight * aux, (ce, aux)) of ``batch``'s tokens
    against its ``labels``."""
    x, aux = forward_float(params, batch, cfg, qat=qat, return_hidden=True)
    x = fl.norm_fwd(params["final_norm"], x, cfg)
    x = fl.maybe_fq(x, cfg.s_act8, enabled=qat)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    w = fl.fq_weight(w, 1, qat)
    loss = chunked_ce(x, w, batch["labels"], cfg)
    return loss + aux_weight * aux, (loss, aux)
