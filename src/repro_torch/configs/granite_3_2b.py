"""granite-3-2b [dense]: GQA, tied embeddings
[hf:ibm-granite/granite-3.0-2b-base].  vocab 49155, padded to 49168 rows
of the embedding (``ArchConfig.padded_vocab``), so the tied head has
49168 columns."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b", family="dense", num_layers=40, d_model=2048,
    n_heads=32, n_kv_heads=8, d_ff=8192, vocab=49155, head_dim=64,
    tie_embeddings=True, activation="swiglu", norm="rmsnorm",
    rope_theta=10000.0,
)
