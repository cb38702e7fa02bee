"""--arch <id> registry of the configs the port runs so far.

The JAX package's registry holds 13 architectures; the port runs the
dense GQA decoder (serving and full-sequence prefill) and the encoder
(full-sequence forward); ROADMAP §1 lists the rest.
"""
from repro_torch.configs import llama3_8b, roberta_base

ARCHS = {m.CONFIG.name: m.CONFIG for m in (llama3_8b, roberta_base)}


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; the port serves "
                       f"{sorted(ARCHS)}")
    return ARCHS[name]
