"""--arch <id> registry: all 13 architectures of the JAX package's.

The port runs the dense decoders, full-causal (llama3-8b,
codeqwen1.5-7b: MHA with QKV bias, granite-3-2b: a tied head) and
sliding-window (h2o-danube-3-4b, the reference serve driver's default),
in serving and full-sequence prefill; the encoders (roberta-base,
roberta-large, deit-s: full-sequence forward); the mixtures of experts
(qwen2-moe-a2.7b: 60 experts top-4 and 4 shared ones;
qwen3-moe-235b-a22b: 128 experts top-8, GQA 64 / 4) and the state-space
models (mamba2-130m: attention-free Mamba-2; jamba-v0.1-52b: groups of 8
sublayers, one attention and seven Mamba, MoE on the odd positions),
served with token-streaming prefill; and the two that attend over a
memory (seamless-m4t-large-v2: an encoder-decoder over frame
embeddings; llama-3.2-vision-90b: groups of four self attention and one
cross attention sublayer over image embeddings), through ``int_prefill``
and ``int_decode_step`` only (the serving engine refuses them, as the
reference's cannot serve them: ROADMAP §3).  ``ASSIGNED`` and
``LONG_OK`` are the reference's.
"""
from repro_torch.configs import (codeqwen1_5_7b, deit_s, granite_3_2b,
                                 h2o_danube_3_4b, jamba_v0_1_52b,
                                 llama3_2_vision_90b, llama3_8b,
                                 mamba2_130m, qwen2_moe_a2_7b,
                                 qwen3_moe_235b_a22b, roberta_base,
                                 roberta_large, seamless_m4t_large_v2)

ARCHS = {m.CONFIG.name: m.CONFIG
         for m in (llama3_8b, h2o_danube_3_4b, codeqwen1_5_7b, granite_3_2b,
                   seamless_m4t_large_v2, llama3_2_vision_90b,
                   qwen3_moe_235b_a22b, qwen2_moe_a2_7b, mamba2_130m,
                   jamba_v0_1_52b, roberta_base, roberta_large, deit_s)}

ASSIGNED = [
    "h2o-danube-3-4b", "llama3-8b", "codeqwen1.5-7b", "granite-3-2b",
    "seamless-m4t-large-v2", "llama-3.2-vision-90b", "qwen3-moe-235b-a22b",
    "qwen2-moe-a2.7b", "mamba2-130m", "jamba-v0.1-52b",
]

# long_500k applicability: sub-quadratic archs only
LONG_OK = {"h2o-danube-3-4b", "mamba2-130m", "jamba-v0.1-52b"}


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; known: "
                       f"{sorted(ARCHS)}")
    return ARCHS[name]
