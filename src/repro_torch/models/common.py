"""Architecture configuration (twin of ``repro.models.common``):
``ArchConfig`` with its derived fields (padded sizes, the SSM widths,
the analytic parameter counts), the assigned input shapes
``ShapeConfig`` / ``SHAPES``, and the float path's positions (RoPE and
the sinusoidal table)."""
from __future__ import annotations

import dataclasses
import math

import torch


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

    def padded_experts(self, multiple: int = 16) -> int:
        if self.n_experts == 0:
            return 0
        return ((self.n_experts + multiple - 1) // multiple) * multiple

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers)."""
        d, v = self.d_model, self.padded_vocab()
        total = v * d * (1 if self.tie_embeddings else 2)
        for i in range(self.num_layers):
            total += self.layer_param_count(i)
        if self.family == "encdec":
            total += sum(self.layer_param_count(i, cross=True)
                         for i in range(self.dec_layers))
        return total

    def layer_param_count(self, idx: int, cross: bool = False) -> int:
        d, hd = self.d_model, self.hd
        n = 0
        if self._layer_kind(idx) in ("attn", "cross") or cross:
            n += d * (self.n_heads + 2 * self.n_kv_heads) * hd
            n += self.n_heads * hd * d
        if self._layer_kind(idx) == "ssm":
            di = self.ssm_d_inner
            n += d * (2 * di + 2 * self.ssm_groups * self.ssm_state
                      + self.ssm_heads)
            n += di * d + di * self.ssm_conv
        if self._is_moe_layer(idx):
            e = self.n_experts
            fe = self.moe_d_ff or self.d_ff
            per = d * fe * (3 if self.activation == "swiglu" else 2)
            n += e * per + d * e
            n += self.n_shared_experts * per
        elif self._layer_kind(idx) != "ssm":
            n += d * self.d_ff * (3 if self.activation == "swiglu" else 2)
        n += 2 * d
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        fe = self.moe_d_ff or self.d_ff
        per = d * fe * (3 if self.activation == "swiglu" else 2)
        inactive = sum((self.n_experts - self.top_k) * per
                       for i in range(self.num_layers)
                       if self._is_moe_layer(i))
        return self.param_count() - inactive

    def _layer_kind(self, idx: int) -> str:
        if self.family == "hybrid" and self.attn_every > 0:
            return ("attn" if idx % self.attn_every == self.attn_offset
                    else "ssm")
        if self.family == "ssm":
            return "ssm"
        if self.family == "vlm" and self.cross_every > 0 \
                and idx % self.cross_every == self.cross_every - 1:
            return "cross"
        return "attn"

    def _is_moe_layer(self, idx: int) -> bool:
        return (self.n_experts > 0
                and idx % self.moe_every == self.moe_offset)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the assigned input shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str       # train | prefill | decode

    @property
    def is_serve(self) -> bool:
        return self.kind in ("prefill", "decode")


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def rope_freqs(hd: int, theta: float, device=None):
    """The (hd / 2,) float32 RoPE frequencies ``theta ** (-2i / hd)``."""
    i = torch.arange(0, hd, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / hd))


def apply_rope(x, positions, theta: float = 10000.0):
    """Rotate halves of ``x`` (..., S, H, hd) by ``positions``
    (broadcastable to (..., S)); computed in float32, returned in
    ``x``'s dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(seq: int, d: int, dtype=torch.float32, device=None):
    """The (seq, d) sinusoidal position table: sin on even columns, cos
    on odd ones."""
    pos = torch.arange(seq, device=device)[:, None].to(torch.float32)
    div = torch.exp(torch.arange(0, d, 2, device=device).to(torch.float32)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)
