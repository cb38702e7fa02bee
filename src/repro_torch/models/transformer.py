"""Layer grouping and the float init of dense decoders, encoders and
mixtures of experts (twin of the matching parts of
``repro.models.transformer``)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as fl
from repro_torch.models.common import ArchConfig

Pytree = Any


def layer_group_spec(cfg: ArchConfig):
    """(group_len, n_groups, kinds); kinds[j] = (mixer, ffn_kind, cross?)."""
    if cfg.family == "vlm" and cfg.cross_every > 0:
        gl = cfg.cross_every
        kinds = [("attn", "ffn", False)] * (gl - 1) + [("cross", "ffn",
                                                        False)]
    elif cfg.family == "hybrid" and cfg.attn_every > 0:
        gl = cfg.attn_every
        kinds = []
        for j in range(gl):
            mix = "attn" if j == cfg.attn_offset else "ssm"
            ff = "moe" if (cfg.n_experts and j % cfg.moe_every
                           == cfg.moe_offset) else "ffn"
            kinds.append((mix, ff, False))
    elif cfg.family == "ssm":
        gl, kinds = 1, [("ssm", None, False)]
    elif cfg.family == "encdec":
        gl, kinds = 1, [("attn", "ffn", True)]     # decoder sublayer
    else:
        gl = 1
        ff = "moe" if (cfg.n_experts and cfg.moe_every == 1) else "ffn"
        kinds = [("attn", ff, False)]
    n = cfg.dec_layers if cfg.family == "encdec" else cfg.num_layers
    assert n % gl == 0, (n, gl)
    return gl, n // gl, kinds


PORTED_FAMILIES = ("dense", "encoder", "moe")
#: the sublayer kinds the port runs: attention + a dense FFN or an MoE
PORTED_KINDS = (("attn", "ffn", False), ("attn", "moe", False))


def require_dense(cfg: ArchConfig) -> None:
    """The port runs stacks of one attention sublayer kind so far: dense
    decoders and encoders (attention + FFN) and mixtures of experts
    (attention + MoE)."""
    _, _, kinds = layer_group_spec(cfg)
    if cfg.family not in PORTED_FAMILIES or len(kinds) != 1 \
            or kinds[0] not in PORTED_KINDS:
        raise NotImplementedError(
            f"arch {cfg.name!r} ({cfg.family}) is not ported yet: the port "
            "runs attention + FFN / MoE decoders and encoders (SSM and "
            "hybrid: ROADMAP §1 item 7; cross attention: item 8)")


def init_layer(gen: torch.Generator, cfg: ArchConfig, dtype) -> Pytree:
    """One attention + FFN (or MoE) sublayer's float params (unstacked),
    drawn in the reference's order: attention, then the FFN / MoE."""
    dev = gen.device
    _, _, kinds = layer_group_spec(cfg)
    ff = kinds[0][1]
    p = {"norm1": fl.init_norm(cfg, dtype, dev),
         "attn": fl.init_attn(gen, cfg, dtype),
         "norm2": fl.init_norm(cfg, dtype, dev)}
    p[ff] = fl.init_moe(gen, cfg, dtype) if ff == "moe" \
        else fl.init_ffn(gen, cfg, dtype)
    return p


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def init_params(cfg: ArchConfig, seed: int = 0,
                device="cuda") -> Pytree:
    """Random float params in the reference layout: ``embed`` (V, D),
    ``final_norm``, ``lm_head`` (D, V; absent for an encoder or tied
    embeddings), ``layers`` — one dict whose leaves carry a leading layer
    axis — and, for ``pos="learned"``, ``pos_embed`` (65536, D), which the
    integer path does not read (drawn last, so the other draws equal
    ``quant.convert.init_quantized``'s).  Holds the whole float model at
    once; ``init_quantized`` draws and quantizes layer by layer instead."""
    require_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)
    v = cfg.padded_vocab()
    params: Dict[str, Pytree] = {
        "embed": fl._init(gen, (v, cfg.d_model), dtype, scale=1.0),
        "final_norm": fl.init_norm(cfg, dtype, dev),
    }
    if not cfg.tie_embeddings and cfg.family != "encoder":
        params["lm_head"] = fl._init(gen, (cfg.d_model, v), dtype)
    _, ng, _ = layer_group_spec(cfg)
    params["layers"] = [_stack([init_layer(gen, cfg, dtype)
                                for _ in range(ng)])]
    if cfg.pos == "learned":
        params["pos_embed"] = fl._init(gen, (65536, cfg.d_model), dtype)
    return params
