"""RoBERTa-base — the paper's own evaluation model (Table II):
12-layer post-LN encoder, GELU, learned positions, d=768/12H/3072.

The integer path, like the reference's, is pre-norm and adds no position
embedding (``post_norm`` and ``pos`` are float-path settings), and an
encoder has no ``lm_head``: the port runs it with ``tie_embeddings=True``
(RoBERTa's LM head shares the word embedding)."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="roberta-base", family="encoder", num_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab=50265, head_dim=64,
    activation="gelu", norm="layernorm", post_norm=True, pos="learned",
)
