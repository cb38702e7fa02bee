"""``torch_ref`` backend: the plain oracles of ``repro_torch.kernels.ref``
(the counterpart of the JAX package's ``ref`` backend).

It advertises no paged, folded or packed capability, so the OpSet lowers
the page table, the chunk scatter, the o-projection and packed weights
(``ops.packed.unpack_weights``) exactly before dispatching here — the same
lowering the reference's ``ref`` backend takes.
"""
from __future__ import annotations

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.int8_matmul import int8_matmul_grouped_plain
from repro_torch.kernels.int_softmax import int_softmax_plain
from repro_torch.ops.spec import PER_TENSOR


class TorchRefBackend:
    name = "torch_ref"
    fused_attention = False   # the full-matrix oracle
    paged_decode = False
    decode_wo_fold = False
    paged_prefill = False
    prefill_wo_fold = False
    tp_serving = True

    def int8_matmul(self, x8, w8, spec, *, bias32=None, b_vec=None):
        if spec.is_raw:
            return _ref.ref_int8_matmul_raw(x8, w8, bias32)
        if spec.kind == PER_TENSOR:
            return _ref.ref_int8_matmul(x8, w8, bias32, spec.dn,
                                        spec.out_bits)
        if b_vec is None:
            raise ValueError("per-channel RequantSpec needs the b_vec "
                             "multiplier vector (QuantLinearParams.b_mult)")
        return _ref.ref_int8_matmul_perchannel(x8, w8, bias32, b_vec,
                                               spec.c, spec.pre,
                                               spec.out_bits)

    def int8_matmul_grouped(self, x8, w8, rows, spec, *, bias32=None,
                            b_vec=None):
        """The expert products, expert by expert (the grouped kernel's
        plain version)."""
        return int8_matmul_grouped_plain(x8, w8, rows, spec, bias32, b_vec)

    def int_softmax(self, scores, plan, valid_len: int = -1,
                    block_rows: int = 8, where=None):
        """K7's plain version: honours ``valid_len`` (which the
        reference's ``ref`` backend ignores) and ``where`` (which its
        ``pallas`` backend drops)."""
        return int_softmax_plain(scores, plan, valid_len, where=where)

    def int_layernorm(self, q, q_gamma, q_beta, plan, out_bits: int = 8):
        return _ref.ref_int_layernorm(q, q_gamma, q_beta, plan, out_bits)

    def int_gelu(self, q, plan, dn_out, out_bits: int = 8):
        return _ref.ref_int_gelu(q, plan, dn_out, out_bits)

    def int_attention(self, q8, k8, v8, plan, causal: bool = True,
                      window: int = 0, out_bits: int = 8, requant=None,
                      b_vec=None):
        return _ref.ref_int_attention(q8, k8, v8, plan, causal, window,
                                      out_bits, requant=requant, b_vec=b_vec)

    def int_decode_attention(self, q8, k8_cache, v8_cache, plan, valid_len,
                             requant=None, b_vec=None):
        return _ref.ref_int_decode_attention(q8, k8_cache, v8_cache, plan,
                                             valid_len, requant=requant,
                                             b_vec=b_vec)
