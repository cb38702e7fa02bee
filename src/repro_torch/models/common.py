"""Architecture configuration (twin of ``repro.models.common.ArchConfig``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture (``repro_torch/configs/<id>.py`` instantiates)."""

    name: str
    family: str                  # dense | encdec | vlm | moe | ssm | hybrid | encoder
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads

    # attention
    window: int = 0              # sliding-window attention (0 = full)
    attn_bias: bool = False
    rope_theta: float = 10000.0
    pos: str = "rope"            # rope | learned | sinusoidal | none

    # ffn / activation / norm
    activation: str = "swiglu"   # swiglu | gelu
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    post_norm: bool = False
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1
    moe_offset: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_groups: int = 1

    # hybrid: attention on layers where idx % attn_every == attn_offset
    attn_every: int = 0
    attn_offset: int = 0

    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0

    # vlm / audio frontends
    cross_every: int = 0
    n_img_tokens: int = 0
    n_audio_frames: int = 0

    # numerics / execution
    dtype: str = "bfloat16"
    kernel_backend: str = "ref"
    remat: bool = True
    scan_layers: bool = True
    # quantization design scales (shared across layers)
    s_act8: float = 8.0 / 127.0        # int8 activation grid
    s_res: float = 2.0 ** -9           # residual stream (int, ~14 bit)
    qmax_res: int = 1 << 13
    s_act10: float = 16.0 / 1024.0     # 10-bit activation (SiLU inputs)

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_causal(self) -> bool:
        return self.family != "encoder"

    @property
    def q_group(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def padded_vocab(self, multiple: int = 16) -> int:
        return ((self.vocab + multiple - 1) // multiple) * multiple
