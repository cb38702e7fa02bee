"""llama-3.2-vision-90b [vlm]: 100 layers, 80 self attention and 20
cross attention (every 5th) [hf:meta-llama/Llama-3.2-11B-Vision,
scaled].  d 8192, GQA 64 / 8 with head dim 128, SwiGLU FFN 28672,
RMSNorm, RoPE on the self positions only.  The vision tower is a stub:
the batch carries precomputed patch embeddings ``img_embeds`` (B, 1600,
d_model) as floats."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm", num_layers=100,
    d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672, vocab=128256,
    head_dim=128, cross_every=5, n_img_tokens=1600, activation="swiglu",
    norm="rmsnorm", rope_theta=500000.0,
)
