"""``cuda`` backend: the hand-written Hopper kernels (the counterpart of
the JAX package's ``pallas_fused`` backend, and the port's default).

A thin shim over the kernel wrappers of ``repro_torch.kernels``: K1 for
all matmuls (the raw logits head included; over packed int4 / MSR-4
weights its nibble instantiation, MSR-4 with the outlier-correction
kernel; an MoE's experts its grouped instantiation), K2 for the norms, K3 for
decode attention over paged pools or a contiguous cache, K4 for paged
chunked prefill, the last two with the o-projection folded in and over
int8 or packed int4 pools (``kv_shifts``), K5 for full-sequence attention, K6 for
i-GELU and K7 for the row softmax (as the reference's ``pallas_fused``
inherits ``pallas``'s softmax kernel).  There is no fallback and no tiling predicate: on CPU tensors each
wrapper runs its plain version; on CUDA tensors it launches its kernel
or raises for a shape the kernel cannot take (K3: a cache above
``MAX_ROWSUM_LEN``; every attention kernel: a head dim it is not compiled
for).  Full-sequence attention over more than ``MAX_ROWSUM_LEN`` keys,
whose exact row sum would leave int32, takes the reference's chunked
two-pass path there, as its ``pallas_fused`` does
(``PallasFusedBackend._two_pass_fallback``): per-tensor epilogues only.

``cuda_ref`` (:class:`CudaRefBackend`) is the same kernels as the twin
of the reference's ``ref``: it declares ``fused_attention = False`` as
``ref`` does, so the model layer streams the chunked attention above the
reference's full-matrix threshold (``models.intlayers.int_attn_fwd``).
"""
from __future__ import annotations

import torch

from repro_torch.analysis.contracts import (fit_block,
                                            fused_attention_takes)
from repro_torch.core.attention import i_attention_chunked
from repro_torch.kernels.int8_matmul import (int8_matmul,
                                             int8_matmul_grouped,
                                             int8_matmul_packed)
from repro_torch.kernels.int_attention_fused import (int_attention_fused,
                                                     int_paged_prefill_fused)
from repro_torch.kernels.int_decode_attention import \
    int_decode_attention_fused
from repro_torch.kernels.int_gelu import int_gelu
from repro_torch.kernels.int_layernorm import int_layernorm
from repro_torch.kernels.int_softmax import int_softmax
from repro_torch.ops.paged import scatter_chunk
from repro_torch.ops.spec import PER_TENSOR, RequantSpec


def _chunked_attention(q8, k8, v8, plan, causal: bool, window: int,
                      requant):
    """Full-sequence attention past ``MAX_ROWSUM_LEN`` keys: the
    reference's chunked two-pass path (``core.attention.
    i_attention_chunked`` over chunks of ``fit_block(1024, Skv)``, the KV
    heads repeated for GQA), per-tensor epilogue only, as in
    ``PallasFusedBackend._two_pass_fallback``."""
    if requant.kind != PER_TENSOR:
        raise NotImplementedError(
            f"Skv={k8.shape[1]} needs the chunked streaming path, which "
            "supports per-tensor requant only")
    rep = q8.shape[2] // k8.shape[2]
    if rep > 1:
        k8 = k8.repeat_interleave(rep, dim=2)
        v8 = v8.repeat_interleave(rep, dim=2)
    out = i_attention_chunked(q8, k8, v8, plan._replace(dn_out=requant.dn),
                              chunk=fit_block(1024, k8.shape[1]),
                              causal=causal, window=window,
                              out_bits=requant.out_bits)
    return out.to(torch.int8) if requant.out_bits <= 8 else out


class CudaBackend:
    name = "cuda"
    fused_attention = True    # K5 at any length (chunked past 2^15 keys)
    paged_decode = True       # consumes page-table KV pools directly
    decode_wo_fold = True     # the o-projection rides in the decode call
    paged_prefill = True      # chunked prefill straight over the page table
    prefill_wo_fold = True    # ... with the o-projection folded in too
    packed_kv = True          # int4 KV pages expanded inside K3 and K4
    packed_matmul = True      # int4 / MSR-4 weights expanded inside K1
    tp_serving = True         # kernels launch per shard at local heads

    def int8_matmul(self, x8, w8, spec, *, bias32=None, b_vec=None):
        return int8_matmul(x8, w8, spec, bias32=bias32, b_vec=b_vec)

    def int8_matmul_packed(self, x8, qw, spec):
        """K1 over the nibbles (one launch; MSR-4: a raw launch and the
        outlier-correction kernel)."""
        return int8_matmul_packed(x8, qw, spec)

    def int8_matmul_grouped(self, x8, w8, rows, spec, *, bias32=None,
                            b_vec=None):
        """K1's grouped instantiation: every expert's product in one
        launch (the MoE experts)."""
        return int8_matmul_grouped(x8, w8, rows, spec, bias32=bias32,
                                   b_vec=b_vec)

    def int_softmax(self, scores, plan, valid_len: int = -1,
                    block_rows: int = 8, where=None):
        """K7.  The kernel masks a static ``valid_len`` only: ``where``
        (an arbitrary mask, oracle only) raises instead of being dropped
        as the reference's kernel backends drop it."""
        if where is not None:
            raise ValueError(f"{self.name!r} int_softmax takes a static "
                             "valid_len mask only, not where=; use the "
                             "'torch_ref' backend for an arbitrary mask")
        return int_softmax(scores, plan, valid_len, block_rows)

    def int_layernorm(self, q, q_gamma, q_beta, plan, out_bits: int = 8):
        return int_layernorm(q, q_gamma, q_beta, plan, out_bits)

    def int_gelu(self, q, plan, dn_out, out_bits: int = 8):
        return int_gelu(q, plan, dn_out, out_bits)

    def int_attention(self, q8, k8, v8, plan, causal: bool = True,
                      window: int = 0, out_bits: int = 8, requant=None,
                      b_vec=None):
        if requant is None:
            requant = RequantSpec.per_tensor(plan.dn_out, out_bits)
        if not fused_attention_takes(k8.shape[1]):
            return _chunked_attention(q8, k8, v8, plan, causal, window,
                                     requant)
        return int_attention_fused(q8, k8, v8, plan, requant=requant,
                                   b_vec=b_vec, causal=causal,
                                   window=window, out_bits=out_bits)

    def int_decode_attention(self, q8, k8_cache, v8_cache, plan, valid_len,
                             requant=None, b_vec=None, pages=None,
                             page_size: int = 0, wo=None, wo_spec=None,
                             kv_shifts=None):
        return int_decode_attention_fused(
            q8, k8_cache, v8_cache, plan, valid_len, pages, page_size,
            requant=requant, b_vec=b_vec, wo=wo, wo_spec=wo_spec,
            kv_shifts=kv_shifts)

    def int_paged_prefill(self, q8, k8_new, v8_new, k_pool, v_pool, plan,
                          base_pos, pages, page_size: int, requant=None,
                          b_vec=None, wo=None, wo_spec=None, kv_shifts=None):
        """Scatter the chunk's K/V into the pools (in place), then the
        paged prefill kernel over the page table.  Packed int4 pools
        (``kv_shifts``) take the chunk already packed (the OpSet packs
        it for every backend)."""
        k_pool = scatter_chunk(k_pool, k8_new, base_pos, pages, page_size)
        v_pool = scatter_chunk(v_pool, v8_new, base_pos, pages, page_size)
        o = int_paged_prefill_fused(q8, k_pool, v_pool, plan,
                                    base_pos + q8.shape[1], pages, page_size,
                                    requant=requant, b_vec=b_vec, wo=wo,
                                    wo_spec=wo_spec, kv_shifts=kv_shifts)
        return o, k_pool, v_pool


class CudaRefBackend(CudaBackend):
    """The twin of the reference's ``ref``: the kernels of ``cuda`` in
    every op, with ``fused_attention = False`` as ``ref`` declares, so the
    model layer takes the reference's branch for ``ref`` (the chunked
    two-pass above its full-matrix threshold, K5 at or below it, whose
    integers are the oracle's there)."""
    name = "cuda_ref"
    fused_attention = False
