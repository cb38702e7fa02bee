"""Hand-written Hopper kernels of the serving, encoder and ``pallas``-backend
paths, and their oracles.

  * K1 ``int8_matmul.int8_matmul``                     (csrc/int8_matmul.cu;
                               M <= 16: csrc/int8_matmul_decode.cu)

    (K1 over packed int4 / MSR-4 weights, ``int8_matmul.int8_matmul_packed``,
    launches its nibble instantiation, counted as ``int8_matmul_packed``,
    and for MSR-4 the outlier-correction kernel of
    csrc/int8_matmul_msr4.cu, counted as ``int8_matmul_msr4``; the
    expert products of an MoE, ``int8_matmul.int8_matmul_grouped``, launch
    its grouped instantiation, csrc/int8_matmul_grouped.cu, counted as
    ``int8_matmul_grouped``)
  * K2 ``int_layernorm.int_layernorm``                 (csrc/int_layernorm.cu)
  * K3 ``int_decode_attention.int_decode_attention_fused``
                                                 (csrc/int_decode_attention.cu)
  * K4 ``int_attention_fused.int_paged_prefill_fused``
                     (csrc/int_paged_prefill.cu over int_attention_mma.cuh)

    (K3 and K4 over packed int4 pools, ``kv_shifts=``, launch one more
    instantiation of their kernel each, counted as
    ``int_decode_attention_kv4`` and ``int_paged_prefill_kv4``)
  * K5 ``int_attention_fused.int_attention_fused``
                     (csrc/int_attention_fused.cu over int_attention_mma.cuh)
  * K6 ``int_gelu.int_gelu``                           (csrc/int_gelu.cu)
  * K7 ``int_softmax.int_softmax``                     (csrc/int_softmax.cu)
  * K8 ``int_attention.int_attention_online``
                                              (csrc/int_attention_online.cu)

Each wrapper takes its plain PyTorch version (beside it, in the same
module) for a tensor on the CPU, and launches its CUDA kernel — or raises
— for a tensor on the card.  On the card it first holds the launch to
its contract (``analysis.contracts``: one cached report a shape, whose
plan it launches with) and raises ``KernelContractError`` for a shape the
kernel does not take, before launching.  ``LAUNCHES`` counts kernel
launches per wrapper: a wrapper adds one exactly where it launches its
kernel, so a run can show that the main path went through the kernels.
Inside :func:`record_launches`, each wrapper that has a contract also
notes what it launched.
"""
from __future__ import annotations

import contextlib

KERNELS = ("int8_matmul", "int_layernorm", "int_decode_attention",
           "int_paged_prefill", "int_attention_fused", "int_gelu",
           "int_softmax", "int_attention_online",
           "int_decode_attention_kv4", "int_paged_prefill_kv4",
           "int8_matmul_packed", "int8_matmul_msr4", "int8_matmul_grouped")

LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


#: the lists of the active :func:`record_launches` blocks, innermost last;
#: empty outside one, which is all a wrapper tests
RECORDERS: list = []


@contextlib.contextmanager
def record_launches():
    """Collect the launches made inside the block: a list of ``(op,
    params, launched)``, where ``op`` and the keyword ``params`` are the
    ``analysis.contracts.check_launch`` call that describes the launch and
    ``launched`` holds the route, grid, cluster and dynamic shared memory
    the wrapper passed to the kernel (keys as ``LaunchReport``'s)."""
    rec = []
    RECORDERS.append(rec)
    try:
        yield rec
    finally:
        RECORDERS.remove(rec)


def note_launch(op: str, params: dict, route: str, grid, cluster: int,
                smem: int) -> None:
    """Add one launch to the innermost :func:`record_launches` list (the
    wrappers call this only while one is active)."""
    RECORDERS[-1].append((op, params, dict(
        route=route, grid=tuple(grid), cluster=int(cluster),
        smem_bytes=int(smem))))
