"""RoBERTa-large — the paper's Table II row 2: 24-layer post-LN encoder,
GELU, learned positions, d=1024/16H/4096.

The integer path, like the reference's, is pre-norm and adds no position
embedding (``post_norm`` and ``pos`` are float-path settings), and an
encoder has no ``lm_head``: the port runs it with ``tie_embeddings=True``
(RoBERTa's LM head shares the word embedding)."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="roberta-large", family="encoder", num_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=50265, head_dim=64,
    activation="gelu", norm="layernorm", post_norm=True, pos="learned",
)
