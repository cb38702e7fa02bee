"""Built-in backends (registered on first lookup by ``ops.registry``)."""
from __future__ import annotations


def register_builtin() -> None:
    from repro_torch.ops.backends.cuda import CudaBackend
    from repro_torch.ops.backends.cuda_online import CudaOnlineBackend
    from repro_torch.ops.backends.torch_ref import TorchRefBackend
    from repro_torch.ops.registry import register_backend
    register_backend("torch_ref", TorchRefBackend())
    register_backend("cuda", CudaBackend())
    register_backend("cuda_online", CudaOnlineBackend())
    # the reference's pallas_tuned profile: its online-attention and
    # softmax blocks (the matmul / norm / GELU blocks change no integer)
    register_backend("cuda_online_tuned", CudaOnlineBackend(
        name="cuda_online_tuned", blocks={
            "int_attention": dict(bq=256, bkv=256),
            "int_softmax": dict(block_rows=16)}))
