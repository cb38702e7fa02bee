"""codeqwen1.5-7b [dense]: qwen1.5 arch, MHA (kv=32), QKV bias
[hf:Qwen/CodeQwen1.5-7B]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b", family="dense", num_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=32, d_ff=13440, vocab=92416, head_dim=128,
    attn_bias=True, activation="swiglu", norm="rmsnorm",
    rope_theta=1000000.0,
)
