"""Built-in backends, registered before the first lookup or registration
(``ops.registry``): registering them when ``repro_torch.ops`` is
imported, as the reference does, would import the kernel wrappers from
inside their own imports."""
from __future__ import annotations


def register_builtin() -> None:
    from repro_torch.ops.backends.cuda import CudaBackend, CudaRefBackend
    from repro_torch.ops.backends.cuda_online import CudaOnlineBackend
    from repro_torch.ops.backends.torch_ref import TorchRefBackend
    from repro_torch.ops.registry import register_backend
    for name, backend in (
            ("torch_ref", TorchRefBackend()), ("cuda", CudaBackend()),
            ("cuda_ref", CudaRefBackend()),
            ("cuda_online", CudaOnlineBackend()),
            # the reference's pallas_tuned profile: its online-attention
            # and softmax blocks (the matmul / norm / GELU blocks change no
            # integer)
            ("cuda_online_tuned", CudaOnlineBackend(
                name="cuda_online_tuned", blocks={
                    "int_attention": dict(bq=256, bkv=256),
                    "int_softmax": dict(block_rows=16)}))):
        register_backend(name, backend)


def build_kernels() -> float:
    """Build (or load) the CUDA kernel library the card backends launch,
    before a timed run; returns the seconds it took
    (``kernels._build.timed_build``)."""
    from repro_torch.kernels._build import timed_build
    return timed_build()
