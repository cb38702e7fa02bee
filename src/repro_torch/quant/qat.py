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

from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import current_mesh
from repro_torch.models import layers as fl
from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import forward_float, gather_top


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


def _chunked_terms(x, w, labels, chunk: int, z_loss: float):
    """(sum of the masked NLL and z-loss, the label count) over chunks
    of at most ``chunk`` positions (the largest divisor of S not above
    it), each chunk's logits made inside ``torch.utils.checkpoint`` and
    recomputed in the backward."""
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
    return tot, cnt


def chunked_ce(x, w, labels, cfg: ArchConfig, chunk: int = 512,
               z_loss: float = 1e-4):
    """Sequence-chunked CE: the logits of a chunk of at most ``chunk``
    positions (the largest divisor of S not above it) are made inside
    ``torch.utils.checkpoint`` and recomputed in the backward, so no more
    than one chunk's (B, chunk, V) logits exist at a time."""
    tot, cnt = _chunked_terms(x, w, labels, chunk, z_loss)
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(params, batch, cfg: ArchConfig, qat: bool = True,
            aux_weight: float = 0.01, specs=None):
    """Returns (ce + aux_weight * aux, (ce, aux)) of ``batch``'s tokens
    against its ``labels``.

    Under a mesh (``launch.mesh.set_mesh``; ``params`` the rank's blocks
    of ``specs``, ``batch`` the rank's rows) the first value is this
    rank's share of that loss, the shares of the world summing to it: the
    rank's CE terms over its own positions (with the gathered head) over
    the world's label count, plus ``aux_weight * aux`` over the world's
    size (every rank holds the same ``aux``).  ``ce`` and ``aux`` are the
    world's.  Autograd of the share gives the rank's part of each
    gradient (``launch.steps`` sums the parts)."""
    mesh = current_mesh()
    params, specs = gather_top(params, specs)
    x, aux = forward_float(params, batch, cfg, qat=qat, return_hidden=True,
                           specs=specs)
    x = fl.norm_fwd(params["final_norm"], x, cfg)
    x = fl.maybe_fq(x, cfg.s_act8, enabled=qat)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    w = fl.fq_weight(w, 1, qat)
    labels = batch["labels"]
    if mesh is None:
        loss = chunked_ce(x, w, labels, cfg)
        return loss + aux_weight * aux, (loss, aux)
    tot, cnt = _chunked_terms(x, w, sh.shard_residual(labels), 512, 1e-4)
    world = mesh.axis_names
    cnt_all = torch.clamp(sh.all_reduce(cnt.detach(), world), min=1.0)
    ce = sh.all_reduce(tot.detach(), world) / cnt_all
    share = tot / cnt_all + aux_weight * aux / mesh.size
    return share, (ce, aux.detach())
