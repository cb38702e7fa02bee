"""h2o-danube-3-4b [dense]: llama+mistral mix with sliding-window attention
[arXiv:2401.16818]; the reference serve driver's default arch."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="dense", num_layers=24, d_model=3840,
    n_heads=32, n_kv_heads=8, d_ff=10240, vocab=32000, head_dim=120,
    window=4096, activation="swiglu", norm="rmsnorm", rope_theta=10000.0,
)
