"""Layer grouping, the float init and the float / QAT forward of every
family: dense decoders, encoders, mixtures of experts, state-space
models, the encoder-decoder and the VLM (twin of
``repro.models.transformer``'s init and float halves)."""
from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import current_mesh
from repro_torch.models import layers as fl
from repro_torch.models import mamba as mb
from repro_torch.models.common import ArchConfig, sinusoidal_pos

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


PORTED_FAMILIES = ("dense", "encoder", "moe", "ssm", "hybrid", "encdec",
                   "vlm")
#: the sublayer kinds the port runs: self attention (with cross attention
#: over a memory after it, an encoder-decoder's decoder sublayer), cross
#: attention over a memory, or Mamba, then a dense FFN, an MoE or
#: (attention-free Mamba) nothing
PORTED_KINDS = (("attn", "ffn", False), ("attn", "moe", False),
                ("attn", "ffn", True), ("cross", "ffn", False),
                ("ssm", None, False), ("ssm", "ffn", False),
                ("ssm", "moe", False))


def require_ported(cfg: ArchConfig) -> None:
    """The port runs every family of the reference: dense decoders and
    encoders, mixtures of experts, the state-space models (attention-free
    Mamba-2 and the attention / Mamba hybrid), the encoder-decoder and
    the VLM; a config whose family or sublayer kind is none of these
    raises."""
    _, _, kinds = layer_group_spec(cfg)
    if cfg.family not in PORTED_FAMILIES \
            or any(kind not in PORTED_KINDS for kind in kinds):
        raise NotImplementedError(
            f"arch {cfg.name!r} ({cfg.family}, sublayers {kinds}) is no "
            "family of the reference's")


#: an encoder-decoder's encoder sublayer: self attention, then the FFN
ENCODER_KIND = ("attn", "ffn", False)


def init_layer(gen: torch.Generator, cfg: ArchConfig, dtype,
               kind=None) -> Pytree:
    """One sublayer's float params (unstacked) of ``kind`` (default the
    first of the group), drawn in the reference's order: the mixer
    (attention, cross attention over a memory, whose leaves are self
    attention's, or Mamba), then a decoder sublayer's cross attention
    (``cross`` and ``norm_cross``), then the FFN / MoE.  A Mamba sublayer
    without an FFN has no ``norm2``."""
    dev = gen.device
    mix, ff, has_cross = kind or layer_group_spec(cfg)[2][0]
    p = {"norm1": fl.init_norm(cfg, dtype, dev)}
    if mix in ("attn", "cross"):
        p["attn"] = fl.init_attn(gen, cfg, dtype)
    else:
        p["ssm"] = mb.init_mamba(gen, cfg, dtype)
    if has_cross:
        p["cross"] = fl.init_attn(gen, cfg, dtype)
        p["norm_cross"] = fl.init_norm(cfg, dtype, dev)
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
    leaves carry a leading group axis — and, for an encoder-decoder,
    ``enc_layers`` (a list of one stack of ``enc_layers`` encoder
    sublayers) and ``enc_final_norm``; for ``pos="learned"``,
    ``pos_embed`` (65536, D), which the integer path does not read.

    The draw order (``quant.convert.init_quantized`` draws in the same
    order, so that it equals ``quantize_params`` of these floats for the
    same seed): the embedding, ``lm_head``, the decoder's sublayers in
    architectural order (group after group, each group's positions in
    turn), the encoder's sublayers in order, ``pos_embed``.  Holds the
    whole float model at once; ``init_quantized`` draws and quantizes
    layer by layer instead."""
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
    if cfg.family == "encdec":
        params["enc_layers"] = [_stack([
            init_layer(gen, cfg, dtype, ENCODER_KIND)
            for _ in range(cfg.enc_layers)])]
        params["enc_final_norm"] = fl.init_norm(cfg, dtype, dev)
    if cfg.pos == "learned":
        params["pos_embed"] = fl._init(gen, (65536, cfg.d_model), dtype)
    return params


# ===================================================== float forward ======

def _sublayer_fwd_float(p, x, cfg: ArchConfig, kind, positions, qat,
                        causal=True, memory=None, seq_len=None):
    """One sublayer, pre-norm (or post-norm for ``cfg.post_norm``);
    returns (x, the MoE's aux loss or 0).  ``seq_len``: the whole
    sequence's length where ``x`` is the rank's sequence block."""
    mix, ff, has_cross = kind
    window = cfg.window if mix == "attn" else 0
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def mixer(h):
        if mix in ("attn", "cross"):
            return fl.attn_fwd(p["attn"], h, cfg, positions, causal=causal,
                               window=window,
                               memory=memory if mix == "cross" else None,
                               qat=qat, seq_len=seq_len)
        return mb.mamba_fwd(p["ssm"], h, cfg, qat=qat, seq_len=seq_len)

    def ffn(h):
        if ff == "moe":
            return fl.moe_fwd(p["moe"], h, cfg, qat=qat, seq_len=seq_len)
        return fl.ffn_fwd(p["ffn"], h, cfg, qat=qat, seq_len=seq_len), None

    def cross(h):
        return fl.attn_fwd(p["cross"], h, cfg, positions, causal=False,
                           memory=memory, qat=qat, seq_len=seq_len)

    if cfg.post_norm:
        x = fl.norm_fwd(p["norm1"], x + mixer(x), cfg)
        if has_cross:
            x = fl.norm_fwd(p["norm_cross"], x + cross(x), cfg)
        if ff is not None:
            f, a = ffn(x)
            x = fl.norm_fwd(p["norm2"], x + f, cfg)
            if a is not None:
                aux = aux + a
        return x, aux
    x = x + mixer(fl.norm_fwd(p["norm1"], x, cfg))
    if has_cross:
        x = x + cross(fl.norm_fwd(p["norm_cross"], x, cfg))
    if ff is not None:
        f, a = ffn(fl.norm_fwd(p["norm2"], x, cfg))
        x = x + f
        if a is not None:
            aux = aux + a
    return x, aux


def _group_params(tree, i: int):
    """Group ``i``'s slice of a position's stacked params."""
    if isinstance(tree, dict):
        return {k: _group_params(v, i) for k, v in tree.items()}
    return tree[i]


def _group_specs(tree):
    """One group's specs from the stacked leaves' (the group dim must not
    be sharded)."""
    if isinstance(tree, dict):
        return {k: _group_specs(v) for k, v in tree.items()}
    if tree[0] is not None:
        raise NotImplementedError(f"the layer-group dim is sharded ({tree})")
    return tuple(tree[1:])


def _run_stack_float(layer_params: List, x, cfg: ArchConfig, kinds,
                     positions, qat, causal=True, memory=None, specs=None,
                     seq_len=None):
    """The layer groups in order (the reference's ``lax.scan``); with
    ``cfg.remat`` each group is recomputed in the backward
    (``torch.utils.checkpoint``, as ``jax.remat`` over the scan body).
    Returns (x, the summed aux loss).

    Under a mesh, ``layer_params`` are the rank's blocks of ``specs``
    (the stacked leaves' specs): each group's are gathered inside the
    body (``sharding.constrain_like_params``), so with remat no more than
    one group's gathered weights live at a time; ``seq_len``: as
    ``_sublayer_fwd_float``."""
    gspecs = None if specs is None else [_group_specs(s) for s in specs]

    def body(x, aux, xs):
        xs = sh.constrain_like_params(xs, gspecs)
        for j, kind in enumerate(kinds):
            x, a = _sublayer_fwd_float(xs[j], x, cfg, kind, positions, qat,
                                       causal=causal, memory=memory,
                                       seq_len=seq_len)
            aux = aux + a
        return x, aux

    ng = _first_leaf(layer_params[0]).shape[0]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(ng):
        xs = [_group_params(lp, i) for lp in layer_params]
        if cfg.remat:
            x, aux = checkpoint(body, x, aux, xs, use_reentrant=False)
        else:
            x, aux = body(x, aux, xs)
    return x, aux


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def embed_tokens(params, tokens, cfg: ArchConfig):
    """The embedding rows of ``tokens`` (B, S), plus the learned or
    sinusoidal positions."""
    x = params["embed"][tokens]
    if cfg.pos == "learned":
        s = tokens.shape[1]
        x = x + params["pos_embed"][:s][None]
    elif cfg.pos == "sinusoidal":
        x = x + sinusoidal_pos(tokens.shape[1], cfg.d_model, x.dtype,
                               device=x.device)[None]
    return x


def logits_fwd(params, x, cfg: ArchConfig, qat=False):
    """Final norm, then the (tied or separate) head: (B, S, V)."""
    x = fl.norm_fwd(params["final_norm"], x, cfg)
    x = fl.maybe_fq(x, cfg.s_act8, enabled=qat)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ fl.fq_weight(w, 1, qat)


#: the param tree's entries outside the layer stacks
STACKS = ("layers", "enc_layers")


def gather_top(params, specs):
    """Under a mesh: ``params`` with every leaf outside the layer stacks
    (the embedding, the head, the final norms, the learned positions)
    all-gathered whole (autograd), and ``specs`` with theirs replicated;
    the layer stacks stay the rank's blocks.  No mesh or no specs: both
    as they are."""
    if specs is None or current_mesh() is None:
        return params, specs
    from repro_torch.core.treepath import tree_map
    out_p, out_s = dict(params), dict(specs)
    for key in params:
        if key in STACKS:
            continue
        out_p[key] = tree_map(sh.gather_leaf, params[key], specs[key],
                              is_leaf=lambda t: isinstance(t,
                                                           torch.Tensor))
        out_s[key] = tree_map(lambda s: (None,) * len(s), specs[key],
                              is_leaf=sh._is_spec)
    return out_p, out_s


def forward_float(params, batch, cfg: ArchConfig, qat: bool = False,
                  return_hidden: bool = False, specs=None):
    """Returns (logits | final hidden, aux_loss) for every family.

    batch: tokens (B,S) [+ img_embeds (B,Ni,D) | src_embeds (B,Sf,D)],
    tensors on the params' device.

    Under a mesh (``launch.mesh.set_mesh``): ``params`` are the rank's
    blocks of ``specs`` and ``batch`` the rank's rows; the residual
    stream is the rank's sequence block over ``model`` where the
    reference's rule shards it (``sharding.residual_seq_sharded``), and
    the logits / hidden are then those of the rank's positions."""
    _, _, kinds = layer_group_spec(cfg)
    dtype = getattr(torch, cfg.dtype)
    params, specs = gather_top(params, specs)
    tokens = batch["tokens"]
    memory = None
    if cfg.family == "encdec":
        src = batch["src_embeds"].to(dtype)
        epos = torch.arange(src.shape[1], device=src.device)[None]
        enc_len = src.shape[1] if sh.residual_seq_sharded(src.shape[1]) \
            else None
        enc_x, _ = _run_stack_float(
            params["enc_layers"], sh.shard_residual(src), cfg,
            [ENCODER_KIND], epos, qat, causal=False,
            specs=None if specs is None else specs["enc_layers"],
            seq_len=enc_len)
        memory = sh.gather_seq(
            fl.norm_fwd(params["enc_final_norm"], enc_x, cfg), enc_len)
    elif cfg.family == "vlm":
        memory = batch["img_embeds"].to(dtype)
    x = embed_tokens(params, tokens, cfg)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None]
    x, aux = _run_stack_float(
        params["layers"], sh.shard_residual(x), cfg, kinds, positions, qat,
        causal=cfg.is_causal, memory=memory,
        specs=None if specs is None else specs["layers"],
        seq_len=s if sh.residual_seq_sharded(s) else None)
    if return_hidden:
        return x, aux
    return logits_fwd(params, x, cfg, qat), aux


def encoder_fwd_float(params, embeds, cfg: ArchConfig, qat: bool = False):
    """Encoder-only forward from pre-embedded inputs (RoBERTa / DeiT):
    the stack without a causal mask, then the final norm."""
    _, _, kinds = layer_group_spec(cfg)
    positions = torch.arange(embeds.shape[1], device=embeds.device)[None]
    x, _ = _run_stack_float(params["layers"], embeds, cfg, kinds,
                            positions, qat, causal=False)
    return fl.norm_fwd(params["final_norm"], x, cfg)
