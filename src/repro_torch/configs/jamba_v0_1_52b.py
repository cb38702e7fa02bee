"""jamba-v0.1-52b [hybrid]: Mamba + attention 1:7 interleave, MoE 16
experts top-2 every other layer [arXiv:2403.19887].  Each group of 8
layers holds one attention sublayer (position 4: GQA 32 / 8, head dim
128, no RoPE) and seven Mamba sublayers (the SSD form, state 16); the
odd positions carry the MoE, the even ones a dense SwiGLU FFN."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid", num_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=65536, head_dim=128,
    attn_every=8, attn_offset=4, n_experts=16, top_k=2, moe_every=2,
    moe_offset=1, moe_d_ff=14336, ssm_state=16, ssm_expand=2,
    ssm_head_dim=64, ssm_conv=4, ssm_groups=1, activation="swiglu",
    norm="rmsnorm", pos="none",
)
