"""qwen2-moe-a2.7b [moe]: 60 routed experts top-4 + 4 shared experts,
MHA with QKV bias [hf:Qwen/Qwen1.5-MoE-A2.7B].  The 60 experts pad to 64
(``ArchConfig.padded_experts``); the router masks the padding experts."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe", num_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=151936, head_dim=128,
    attn_bias=True, n_experts=60, top_k=4, n_shared_experts=4,
    moe_d_ff=1408, moe_every=1, activation="swiglu", norm="rmsnorm",
)
