"""Backends and the OpSet dispatch handle (twin of ``repro.ops.registry``,
trimmed to the serving main path).

Models receive one resolved :class:`OpSet` and every integer op dispatches
through it.  Two backends exist:

  * ``"cuda"`` (the default) — the counterpart of the JAX package's
    ``pallas_fused``: the hand-written kernels K1–K6;
  * ``"torch_ref"`` — the counterpart of ``ref``: the plain oracles.

``fused_attention`` says whether a backend's ``int_attention`` is one
streaming kernel (the model layer then calls it at any length) or the
full-matrix oracle (which the layer calls only up to the reference's
chunking threshold).  Optional capabilities are negotiated exactly as in
the reference: a backend advertising ``paged_decode`` / ``decode_wo_fold`` /
``paged_prefill`` / ``prefill_wo_fold`` gets the page table and the
folded o-projection verbatim; for the rest this layer lowers them exactly
(gather pages, decode-then-matmul, scatter + stepped-mask paged decode),
so every backend returns identical integers.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.ops.paged import gather_pages, scatter_chunk
from repro_torch.ops.spec import QuantLinearParams

DEFAULT_BACKEND = "cuda"

OP_NAMES = ("int8_matmul", "int_layernorm", "int_gelu", "int_attention",
            "int_decode_attention", "int_paged_prefill")

_REGISTRY: Dict[str, object] = {}


def register_backend(name: str, backend) -> None:
    _REGISTRY[name] = backend


def get_backend(name: str):
    if not _REGISTRY:
        from repro_torch.ops.backends import register_builtin
        register_builtin()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown backend {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def available_backends():
    get_backend(DEFAULT_BACKEND)
    return sorted(_REGISTRY)


def _as_backend(spec):
    return get_backend(spec) if isinstance(spec, str) else spec


class OpSet:
    """A resolved operator bundle: every integer op dispatches to one
    backend (the reference's per-op overrides are not ported)."""

    __slots__ = ("default",)

    def __init__(self, default):
        self.default = _as_backend(default)

    @property
    def name(self) -> str:
        return self.default.name

    def backend_for(self, op: str):
        if op not in OP_NAMES:
            raise KeyError(f"unknown op {op!r}; valid ops: {OP_NAMES}")
        return self.default

    def __repr__(self):
        return f"OpSet({self.name})"

    # ------------------------------------------------------------ ops --

    def int8_matmul(self, x8, w8, spec, *, bias32=None, b_vec=None):
        return self.backend_for("int8_matmul").int8_matmul(
            x8, w8, spec, bias32=bias32, b_vec=b_vec)

    def int_layernorm(self, q, q_gamma, q_beta, plan, out_bits: int = 8):
        return self.backend_for("int_layernorm").int_layernorm(
            q, q_gamma, q_beta, plan, out_bits=out_bits)

    def int_gelu(self, q, plan, dn_out, out_bits: int = 8):
        return self.backend_for("int_gelu").int_gelu(q, plan, dn_out,
                                                     out_bits=out_bits)

    def int_attention(self, q8, k8, v8, plan, causal: bool = True,
                      window: int = 0, out_bits: int = 8, requant=None,
                      b_vec=None):
        """Full-sequence attention, (B, Sq, H, D) queries against (B, Skv,
        Hkv, D) keys/values; ``requant``/``b_vec`` as the decode op."""
        return self.backend_for("int_attention").int_attention(
            q8, k8, v8, plan, causal=causal, window=window,
            out_bits=out_bits, requant=requant, b_vec=b_vec)

    def _compose_wo(self, be, o8, wo, wo_spec):
        """Exact unfolded composition: attention output -> o-projection."""
        b, sq = o8.shape[0], o8.shape[1]
        x8 = o8.to(torch.int8).reshape(b * sq, -1)
        acc = be.int8_matmul(x8, wo.w8, wo_spec, bias32=wo.bias32,
                             b_vec=wo.b_mult)
        if not wo_spec.is_raw and wo_spec.out_bits <= 8:
            acc = acc.to(torch.int8)       # the folded kernel's dtype
        return acc.reshape(b, sq, -1)

    def int_decode_attention(self, q8, k8_cache, v8_cache, plan, valid_len,
                             pages=None, page_size: int = 0, wo=None,
                             wo_spec=None, requant=None):
        """Decode attention with capability negotiation (``pages`` selects
        the paged layout; ``wo``/``wo_spec`` ask for the folded
        o-projection)."""
        be = self.backend_for("int_decode_attention")
        kw = {}
        if pages is not None:
            if getattr(be, "paged_decode", False):
                kw.update(pages=pages, page_size=page_size)
            else:
                k8_cache = gather_pages(k8_cache, pages, page_size)
                v8_cache = gather_pages(v8_cache, pages, page_size)
        if wo is None:
            return be.int_decode_attention(q8, k8_cache, v8_cache, plan,
                                           valid_len, requant=requant, **kw)
        wo = _validate_wo(wo, wo_spec, requant)
        if getattr(be, "decode_wo_fold", False):
            return be.int_decode_attention(q8, k8_cache, v8_cache, plan,
                                           valid_len, requant=requant,
                                           wo=wo, wo_spec=wo_spec, **kw)
        o8 = be.int_decode_attention(q8, k8_cache, v8_cache, plan,
                                     valid_len, requant=requant, **kw)
        return self._compose_wo(be, o8, wo, wo_spec)

    def int_paged_prefill(self, q8, k8_new, v8_new, k_pool, v_pool, plan,
                          base_pos, pages, page_size: int, wo=None,
                          wo_spec=None, requant=None):
        """Chunked paged prefill: scatter the chunk's K/V into the pools
        (in place) and attend causally over history + chunk.  Returns
        ``(o, k_pool, v_pool)``."""
        be = self.backend_for("int_paged_prefill")
        if wo is not None:
            wo = _validate_wo(wo, wo_spec, requant)
        if getattr(be, "paged_prefill", False):
            kw = {}
            if wo is not None and getattr(be, "prefill_wo_fold", False):
                kw.update(wo=wo, wo_spec=wo_spec)
                wo = None
            o, k_pool, v_pool = be.int_paged_prefill(
                q8, k8_new, v8_new, k_pool, v_pool, plan, base_pos, pages,
                page_size, requant=requant, **kw)
            if wo is None:
                return o, k_pool, v_pool
            return self._compose_wo(be, o, wo, wo_spec), k_pool, v_pool
        # exact lowering: a chunk over pools that hold its K/V is paged
        # stepped-mask decode with valid_len = base_pos + C
        k_pool = scatter_chunk(k_pool, k8_new, base_pos, pages, page_size)
        v_pool = scatter_chunk(v_pool, v8_new, base_pos, pages, page_size)
        vl = base_pos.to(torch.int32) + q8.shape[1]
        o = self.int_decode_attention(q8, k_pool, v_pool, plan, vl,
                                      pages=pages, page_size=page_size,
                                      wo=wo, wo_spec=wo_spec, requant=requant)
        return o, k_pool, v_pool


def _validate_wo(wo, wo_spec, requant):
    """The fold feeds an int8 contraction: it needs the wo epilogue and an
    attention epilogue that clips to int8."""
    wo = QuantLinearParams.of(wo)
    if wo_spec is None:
        raise ValueError("folded wo projection needs wo_spec (the "
                         "o-projection's RequantSpec)")
    if requant is not None and (requant.is_raw or requant.out_bits > 8):
        raise ValueError("wo folding needs an int8 attention "
                         f"epilogue, got {requant}")
    return wo


def resolve_ops(spec=None) -> OpSet:
    """Resolve ``spec`` (OpSet / backend / name / None -> ``"cuda"``)."""
    if isinstance(spec, OpSet):
        return spec
    return OpSet(_as_backend(spec if spec is not None else DEFAULT_BACKEND))
