"""mamba2-130m [ssm]: SSD (state-space duality) [arXiv:2405.21060].
Attention-free: no softmax or attention unit runs; the projections are
int8 matmuls and the SSD recurrence runs in int32 fixed point.  vocab
50280 padded to 50288, the head tied to the embedding."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm", num_layers=24, d_model=768,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280, ssm_state=128,
    ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_groups=1,
    tie_embeddings=True, norm="rmsnorm", pos="none",
)
