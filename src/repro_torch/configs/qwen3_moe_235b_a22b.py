"""qwen3-moe-235b-a22b [moe]: 128 experts top-8, per-expert d_ff 1536,
GQA 64 / 4 [hf:Qwen/Qwen3-30B-A3B family]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe", num_layers=94, d_model=4096,
    n_heads=64, n_kv_heads=4, d_ff=1536, vocab=151936, head_dim=128,
    n_experts=128, top_k=8, moe_d_ff=1536, moe_every=1,
    activation="swiglu", norm="rmsnorm", rope_theta=1000000.0,
)
