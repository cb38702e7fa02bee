"""Layer grouping and the float init of dense decoders, encoders,
mixtures of experts and state-space models (twin of the matching parts
of ``repro.models.transformer``)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as fl
from repro_torch.models import mamba as mb
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


PORTED_FAMILIES = ("dense", "encoder", "moe", "ssm", "hybrid")
#: the sublayer kinds the port runs: attention or Mamba, then a dense
#: FFN, an MoE or (attention-free Mamba) nothing
PORTED_KINDS = (("attn", "ffn", False), ("attn", "moe", False),
                ("ssm", None, False), ("ssm", "ffn", False),
                ("ssm", "moe", False))


def require_ported(cfg: ArchConfig) -> None:
    """The port runs every family but the cross-attention ones: dense
    decoders and encoders, mixtures of experts, and the state-space
    models (attention-free Mamba-2 and the attention / Mamba hybrid)."""
    _, _, kinds = layer_group_spec(cfg)
    if cfg.family not in PORTED_FAMILIES \
            or any(kind not in PORTED_KINDS for kind in kinds):
        raise NotImplementedError(
            f"arch {cfg.name!r} ({cfg.family}) is not ported yet: cross "
            "attention over an encoder / image memory is ROADMAP §1 item 8")


def init_layer(gen: torch.Generator, cfg: ArchConfig, dtype,
               kind=None) -> Pytree:
    """One sublayer's float params (unstacked) of ``kind`` (default the
    first of the group), drawn in the reference's order: the mixer
    (attention or Mamba), then the FFN / MoE.  A Mamba sublayer without
    an FFN has no ``norm2``."""
    dev = gen.device
    mix, ff, _ = kind or layer_group_spec(cfg)[2][0]
    p = {"norm1": fl.init_norm(cfg, dtype, dev)}
    if mix == "attn":
        p["attn"] = fl.init_attn(gen, cfg, dtype)
    else:
        p["ssm"] = mb.init_mamba(gen, cfg, dtype)
    if ff is not None:
        p["norm2"] = fl.init_norm(cfg, dtype, dev)
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
    embeddings), ``layers`` — one dict a position of the layer group, whose
    leaves carry a leading group axis — and, for ``pos="learned"``,
    ``pos_embed`` (65536, D), which the integer path does not read (drawn
    last, so the other draws equal ``quant.convert.init_quantized``'s).
    Sublayers are drawn in architectural order: group after group, each
    group's positions in turn.  Holds the whole float model at once;
    ``init_quantized`` draws and quantizes layer by layer instead."""
    require_ported(cfg)
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
    _, ng, kinds = layer_group_spec(cfg)
    drawn = [[init_layer(gen, cfg, dtype, kind) for kind in kinds]
             for _ in range(ng)]
    params["layers"] = [_stack([group[j] for group in drawn])
                        for j in range(len(kinds))]
    if cfg.pos == "learned":
        params["pos_embed"] = fl._init(gen, (65536, cfg.d_model), dtype)
    return params
