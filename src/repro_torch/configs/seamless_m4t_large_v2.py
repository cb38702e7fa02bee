"""seamless-m4t-large-v2 [encdec]: the speech-to-text backbone
[arXiv:2308.11596].  24 encoder and 24 decoder layers, d 1024, MHA 16 x
64, GELU FFN 8192, LayerNorm with beta, vocab 256206 padded to 256208.
The speech frontend is a stub: the batch carries precomputed frame
embeddings ``src_embeds`` (B, n_frames, d_model) as floats.  Each
decoder sublayer is self attention, cross attention over the encoder's
memory, then the FFN.  The integer path adds no position for
``pos="sinusoidal"``, as the reference's does not."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec", num_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192, vocab=256206,
    head_dim=64, enc_layers=24, dec_layers=24, activation="gelu",
    norm="layernorm", pos="sinusoidal",
)
