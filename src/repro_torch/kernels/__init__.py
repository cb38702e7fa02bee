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
— for a tensor on the card.  ``LAUNCHES`` counts kernel launches per
wrapper: a wrapper adds one exactly where it launches its kernel, so a
run can show that the main path went through the kernels.
"""
from __future__ import annotations

KERNELS = ("int8_matmul", "int_layernorm", "int_decode_attention",
           "int_paged_prefill", "int_attention_fused", "int_gelu",
           "int_softmax", "int_attention_online",
           "int_decode_attention_kv4", "int_paged_prefill_kv4",
           "int8_matmul_packed", "int8_matmul_msr4", "int8_matmul_grouped")

LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
