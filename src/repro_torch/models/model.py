"""Config helpers (twin of ``repro.models.model.reduce_config``)."""
from __future__ import annotations

import dataclasses

from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import layer_group_spec


def reduce_config(cfg: ArchConfig, **over) -> ArchConfig:
    """Smoke-test-sized config of the same family (structure preserved)."""
    gl, ng, kinds = layer_group_spec(cfg)
    upd = dict(
        num_layers=gl * min(ng, 2),
        d_model=128,
        n_heads=min(cfg.n_heads, 4) if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=32 if cfg.n_heads else 0,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        window=min(cfg.window, 64) if cfg.window else 0,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        n_shared_experts=min(cfg.n_shared_experts, 2),
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        n_img_tokens=min(cfg.n_img_tokens, 16) if cfg.n_img_tokens else 0,
        enc_layers=min(cfg.enc_layers, 2) if cfg.enc_layers else 0,
        dec_layers=min(cfg.dec_layers, 2) if cfg.dec_layers else 0,
    )
    upd.update(over)
    return dataclasses.replace(cfg, **upd)
