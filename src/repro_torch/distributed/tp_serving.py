"""Tensor-parallel sharding of the serving engine over a process group
(the port of ``repro.distributed.tp_serving``).

The engine partitions its attention datapath along the **head axis**
across the ``tp`` ranks of a ``torch.distributed`` group (SPMD: one
process a rank, the counterpart of the reference's ``shard_map`` over a
``("tp",)`` mesh).  Rank ``r`` owns ``Hkv/tp`` KV heads of *every*
physical page, and the matching ``H/tp`` query heads:

  * ``wq`` / ``wk`` / ``wv`` shard by output column (head-major layout
    from ``quant.convert._q_attn``: columns ``[r·N/tp, (r+1)·N/tp)`` are
    exactly rank ``r``'s heads), together with their per-channel
    ``b_mult`` / ``bias32``;
  * ``wo`` shards by *row* (its K dim is the flattened head axis); each
    rank computes a raw int32 partial o-projection, which
    :func:`~repro_torch.distributed.collectives.psum_int32` sums exactly,
    and ``wo``'s bias and per-channel requant apply **once, after** the
    sum (``models.intlayers._tp_wo_project``);
  * each rank's K/V pools hold its ``Hkv/tp`` heads (the engine builds
    them from :func:`local_cfg`); page *ids* are rank-agnostic, so the
    allocator, page table, prefix index and scheduler stay replicated and
    every rank makes the same decisions, and so issues the same
    collectives in the same order.

Everything that is not attention (embedding, norms, FFN / MoE, logits)
runs replicated: its inputs are identical on every rank after the exact
sum, so its outputs are too.  GQA stays aligned: ``H/tp = q_group ·
Hkv/tp``, so local query head ``j`` maps to local KV head ``j //
q_group`` exactly as in the global layout.  Speculative verify composes:
``Sq = spec_k + 1`` is replicated like the batch.
"""
from __future__ import annotations

import dataclasses

import torch.distributed as dist

from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import layer_group_spec
from repro_torch.ops import OP_NAMES, QuantLinearParams

#: the serving tensor-parallel axis (``describe()["tp"]["mesh"]["axis"]``)
TP_AXIS = "tp"


def tp_arch_supported(cfg: ArchConfig) -> bool:
    """Whether the head-sharded serving step serves this arch: every
    sublayer must be plain self-attention (+ dense FFN or MoE, both
    replicated).  SSM state and cross-attention memory are lane-indexed,
    not head-shaped, so those archs keep single-device serving."""
    _, _, kinds = layer_group_spec(cfg)
    return all(mix == "attn" and not has_cross
               for (mix, ff, has_cross) in kinds)


def validate_tp(cfg: ArchConfig, tp: int) -> None:
    """Typed validation of a tensor-parallel degree (the engine / CLI
    boundary), with the reference's checks, order and messages.  Whether
    a process group exists is negotiated separately (the gathered mode
    needs none)."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if tp == 1:
        return
    hkv = cfg.n_kv_heads
    if hkv == 0 or hkv % tp:
        raise ValueError(
            f"tp={tp} must divide the KV head count (n_kv_heads={hkv}): "
            "each device owns Hkv/tp heads of every page")
    if not tp_arch_supported(cfg):
        raise ValueError(
            f"tp={tp} is unsupported for arch {cfg.name!r}: tensor-"
            "parallel serving shards attention heads, but SSM / cross-"
            "attention sublayers carry lane-indexed state that has no "
            "head axis; serve this arch with tp=1")


def backends_support_tp(ops) -> bool:
    """Every backend in the OpSet must advertise ``tp_serving`` for the
    engine to shard; a single non-advertising backend drops it to the
    exact single-device (gathered) lowering."""
    return all(getattr(ops.backend_for(op), "tp_serving", False)
               for op in OP_NAMES)


def tp_group_size(group) -> int:
    """The ranks of ``group`` (None: the default group), 0 when
    ``torch.distributed`` has no initialized process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_world_size(group)


def local_cfg(cfg: ArchConfig, tp: int) -> ArchConfig:
    """The per-rank view of the arch: ``H/tp`` query heads and ``Hkv/tp``
    KV heads, with ``head_dim`` pinned so the derived ``hd`` cannot drift
    when ``n_heads`` shrinks."""
    if tp == 1:
        return cfg
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=cfg.n_kv_heads // tp,
                               head_dim=cfg.hd)


def _shard(t, axis: int, rank: int, tp: int):
    n = t.shape[axis] // tp
    return t.narrow(axis, rank * n, n).contiguous()


def _shard_attn(attn: dict, rank: int, tp: int) -> dict:
    out = {}
    for name, qw in attn.items():
        qw = QuantLinearParams.of(qw)
        if qw.is_packed:
            raise ValueError(
                f"attention weight {name!r} is packed "
                f"({qw.pack_meta.scheme}): packed weights cannot shard "
                "over tensor-parallel ranks, as in the reference, whose "
                "qparam_pspecs reads the dense w8 a packed weight lacks "
                "(ROADMAP §3); serve them with tp=1 or without a process "
                "group (the gathered mode)")
        if name == "wo":
            # rows (the flattened head axis); the per-channel multipliers
            # and the bias stay whole: they apply once, after the sum
            out[name] = qw._replace(w8=_shard(qw.w8, -2, rank, tp))
        else:
            # head-major output columns, with their epilogue vectors
            out[name] = QuantLinearParams(*[
                None if t is None else _shard(t, -1, rank, tp)
                for t in (qw.w8, qw.b_mult, qw.bias32)])
    return out


def shard_qparams(qparams: dict, rank: int, tp: int) -> dict:
    """Rank ``rank``'s shard of the quantized parameters (the counterpart
    of the reference's ``qparam_pspecs`` + ``shard_put``): every
    attention's ``wq`` / ``wk`` / ``wv`` ``w8``, ``b_mult`` and
    ``bias32`` sliced on their last axis and ``wo.w8`` on axis -2, each a
    contiguous copy; every other leaf whole.  Packed attention weights
    raise ``ValueError``."""
    if tp == 1:
        return qparams
    out = {k: v for k, v in qparams.items() if k != "layers"}
    out["layers"] = [
        {k: _shard_attn(v, rank, tp) if k == "attn" else v
         for k, v in group.items()}
        for group in qparams["layers"]]
    return out
