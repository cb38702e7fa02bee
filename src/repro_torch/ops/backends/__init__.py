"""Built-in backends (registered on first lookup by ``ops.registry``)."""
from __future__ import annotations


def register_builtin() -> None:
    from repro_torch.ops.backends.cuda import CudaBackend
    from repro_torch.ops.backends.torch_ref import TorchRefBackend
    from repro_torch.ops.registry import register_backend
    register_backend("torch_ref", TorchRefBackend())
    register_backend("cuda", CudaBackend())
