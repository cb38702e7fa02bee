"""--arch <id> registry of the configs the port runs so far.

The JAX package's registry holds 13 architectures; the port runs the
dense GQA decoders, full-causal (llama3-8b) and sliding-window
(h2o-danube-3-4b, the reference serve driver's default), in serving and
full-sequence prefill, and the encoder (full-sequence forward); ROADMAP §1
lists the rest.
"""
from repro_torch.configs import h2o_danube_3_4b, llama3_8b, roberta_base

ARCHS = {m.CONFIG.name: m.CONFIG
         for m in (llama3_8b, h2o_danube_3_4b, roberta_base)}


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; the port serves "
                       f"{sorted(ARCHS)}")
    return ARCHS[name]
