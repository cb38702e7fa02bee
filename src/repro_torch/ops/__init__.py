"""repro_torch.ops — the operator API of the integer datapath.

:class:`RequantSpec` / :class:`QuantLinearParams` / :class:`PackMeta`
(``ops.spec``), the
paged-pool utilities (``ops.paged``), the :class:`OpSet` dispatch handle
with its backends ``"cuda"``, ``"cuda_ref"``, ``"cuda_online"``,
``"cuda_online_tuned"`` and ``"torch_ref"``, the :class:`Backend` protocol
with :func:`register_backend` / :func:`unregister_backend`, the
:func:`use_backend` context and the ``REPRO_BACKEND`` override
(``ops.registry``, ``ops.backends``), and the
module-level entry points below, which dispatch through
``resolve_ops(ops)``: an explicit ``ops=``, else the ambient
``use_backend`` / ``REPRO_BACKEND`` choice, else ``"cuda"``.
:func:`build_kernels` builds the card backends' kernel library ahead of a
timed run.
"""
from __future__ import annotations

from repro_torch.ops.backends import build_kernels
from repro_torch.ops.registry import (DEFAULT_BACKEND, ENV_VAR, OP_NAMES,
                                      REQUIRED_OPS, TWINS, Backend, OpSet,
                                      available_backends, current_opset,
                                      get_backend, register_backend,
                                      resolve_ops, twin_backend,
                                      unregister_backend, use_backend)
from repro_torch.ops.spec import (PER_CHANNEL, PER_TENSOR, RAW, PackMeta,
                                  QuantLinearParams, RequantSpec)

__all__ = ["Backend", "DEFAULT_BACKEND", "ENV_VAR", "OP_NAMES", "OpSet",
           "PER_CHANNEL", "PER_TENSOR", "PackMeta", "QuantLinearParams", "RAW",
           "REQUIRED_OPS", "RequantSpec", "TWINS",
           "available_backends", "build_kernels", "current_opset",
           "get_backend",
           "register_backend", "resolve_ops", "twin_backend",
           "unregister_backend", "use_backend",
           "int8_matmul", "int8_matmul_packed", "int_softmax", "int_gelu",
           "int_layernorm",
           "int_attention", "int_decode_attention", "int_paged_prefill"]


def int8_matmul(x8, w8, spec, *, bias32=None, b_vec=None, ops=None):
    return resolve_ops(ops).int8_matmul(x8, w8, spec, bias32=bias32,
                                        b_vec=b_vec)


def int8_matmul_packed(x8, qw, spec, *, ops=None):
    return resolve_ops(ops).int8_matmul_packed(x8, qw, spec)


def int_softmax(scores, plan, *, ops=None, **opts):
    return resolve_ops(ops).int_softmax(scores, plan, **opts)


def int_gelu(q, plan, dn_out, out_bits: int = 8, *, ops=None):
    return resolve_ops(ops).int_gelu(q, plan, dn_out, out_bits=out_bits)


def int_layernorm(q, q_gamma, q_beta, plan, out_bits: int = 8, *,
                  ops=None):
    return resolve_ops(ops).int_layernorm(q, q_gamma, q_beta, plan,
                                          out_bits=out_bits)


def int_attention(q8, k8, v8, plan, causal: bool = True, window: int = 0,
                  out_bits: int = 8, *, ops=None, **opts):
    return resolve_ops(ops).int_attention(q8, k8, v8, plan, causal=causal,
                                          window=window, out_bits=out_bits,
                                          **opts)


def int_decode_attention(q8, k8_cache, v8_cache, plan, valid_len, *,
                         ops=None, **opts):
    return resolve_ops(ops).int_decode_attention(q8, k8_cache, v8_cache,
                                                 plan, valid_len, **opts)


def int_paged_prefill(q8, k8_new, v8_new, k_pool, v_pool, plan, base_pos,
                      pages, page_size: int, *, ops=None, **opts):
    return resolve_ops(ops).int_paged_prefill(
        q8, k8_new, v8_new, k_pool, v_pool, plan, base_pos, pages,
        page_size, **opts)
