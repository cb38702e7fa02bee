"""--arch <id> registry of the configs the port serves so far.

The JAX package's registry holds 13 architectures; the port's first
slice serves the dense GQA decoder only (ROADMAP §1 lists the rest).
"""
from repro_torch.configs import llama3_8b

ARCHS = {m.CONFIG.name: m.CONFIG for m in (llama3_8b,)}


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; the port serves "
                       f"{sorted(ARCHS)}")
    return ARCHS[name]
