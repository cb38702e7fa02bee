"""DeiT-S — the paper's vision model (Table II): 12-layer pre-LN ViT,
196+1 patch tokens at 224x224 (patch embeddings stubbed).

The reference's integer path runs it as a token encoder over
``n_img_tokens`` = 197 positions, with no position embedding, and an
encoder has no ``lm_head``: the port runs it with ``tie_embeddings=True``
(its 1000-class head shares the token embedding), as the reference must
to quantize it."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="deit-s", family="encoder", num_layers=12, d_model=384,
    n_heads=6, n_kv_heads=6, d_ff=1536, vocab=1000, head_dim=64,
    activation="gelu", norm="layernorm", post_norm=False, pos="learned",
    n_img_tokens=197,
)
