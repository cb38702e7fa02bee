"""``cuda_online`` backend: the one-pass online attention K8 at the
reference's logical blocks (the counterpart of the JAX package's
``pallas`` backend; ``cuda_online_tuned`` is that of ``pallas_tuned``).

Block shapes are a per-op configuration of the instance, as in the
reference: ``CudaOnlineBackend(blocks={"int_attention": dict(bq=16,
bkv=8)})``.  For K8 they are not a tiling choice: the online softmax
rescales at every logical KV block boundary, so ``(bq, bkv)`` decide the
integers, and ``_fit_block`` is the reference's, copied literally (the
largest divisor of the length not above the request, default 128), so
both packages run the same blocks on the same shapes.

Routing, op by op:

  * ``int_attention`` — K8 for ``Sq >= 16`` and ``Skv >= 16``
    (``analysis.contracts.online_takes``); below that K5, which gives the
    integers of the exact oracle the reference calls there, so no plain
    version runs on the card.  Per-tensor requant only
    (the plan's ``dn_out`` replaced by ``requant.dn``, ``out_bits`` from
    the spec); per-channel and raw raise ``NotImplementedError``, as on
    the reference;
  * ``int_softmax`` — K7 (``block_rows`` from the blocks);
  * ``int8_matmul``, ``int_layernorm``, ``int_gelu`` — K1, K2, K6 (the
    reference's Pallas kernels here are exact, so the blocks it gives
    them change no integer and the port's kernels choose their own);
  * ``int8_matmul_packed`` — K1 over the nibbles, inherited from ``cuda``
    with its ``packed_matmul``.  The reference's ``pallas`` backend does
    not advertise it, and the dispatch layer unpacks the weights densely
    for it; a dense copy of MSR-4 weights would not fit the card.  The
    flag differs, the integers do not;
  * decode and paged prefill — K3 and K4, inherited from ``cuda``.  The
    reference's ``pallas`` backend advertises no paged or folded
    capability and the dispatch layer lowers those calls exactly onto its
    oracle; this backend advertises them, like ``cuda``.  The flags
    differ, the integers do not.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.analysis.contracts import fit_block as _fit_block
from repro_torch.analysis.contracts import online_takes
from repro_torch.kernels.int_attention import (int_attention_online,
                                               int_attention_online_plain)
from repro_torch.kernels.int_attention_fused import (
    int_attention_fused, int_attention_fused_plain)
from repro_torch.ops.backends.cuda import CudaBackend
from repro_torch.ops.spec import PER_TENSOR


class CudaOnlineBackend(CudaBackend):
    fused_attention = True    # one streaming kernel at any length
    # not inherited from ``cuda``: the reference's ``pallas`` does not
    # advertise it, so a tp > 1 engine over it takes the gathered mode
    tp_serving = False
    #: the two attention functions the routing below calls
    #: (:class:`PlainOnlineBackend` names their plain versions)
    online_attention = staticmethod(int_attention_online)
    exact_attention = staticmethod(int_attention_fused)

    def __init__(self, name: str = "cuda_online",
                 blocks: Optional[Dict[str, Dict[str, int]]] = None):
        self.name = name
        self.blocks = {op: dict(kw) for op, kw in (blocks or {}).items()}

    def _opts(self, op: str, call_opts: dict) -> dict:
        merged = dict(self.blocks.get(op, {}))
        merged.update(call_opts)
        return merged

    def int_softmax(self, scores, plan, where=None, **opts):
        return super().int_softmax(scores, plan, where=where,
                                   **self._opts("int_softmax", opts))

    def int_attention(self, q8, k8, v8, plan, causal: bool = True,
                      window: int = 0, out_bits: int = 8, requant=None,
                      b_vec=None, **opts):
        opts = self._opts("int_attention", opts)
        if requant is not None:
            # the online kernel's epilogue is per-tensor: fold the spec's
            # dyadic into the plan, as the reference does
            if requant.kind != PER_TENSOR:
                raise NotImplementedError(
                    f"{self.name!r} attention supports per-tensor requant "
                    "only; use the 'cuda' backend for "
                    f"{requant.kind!r}")
            plan = plan._replace(dn_out=requant.dn)
            out_bits = requant.out_bits
        sq, skv = q8.shape[1], k8.shape[1]
        if not online_takes(sq, skv):
            return self.exact_attention(q8, k8, v8, plan, causal=causal,
                                        window=window, out_bits=out_bits)
        bq = _fit_block(opts.pop("bq", 128), sq)
        bkv = _fit_block(opts.pop("bkv", 128), skv)
        if opts:
            raise TypeError(f"{self.name!r} int_attention: unexpected "
                            f"options {sorted(opts)}")
        return self.online_attention(q8, k8, v8, plan, causal=causal,
                                     window=window, bq=bq, bkv=bkv,
                                     out_bits=out_bits)


class PlainOnlineBackend(CudaOnlineBackend):
    """``cuda_online``'s attention routing on K8's and K5's plain versions:
    the same block fitting and ``Sq``/``Skv < 16`` switch."""
    online_attention = staticmethod(int_attention_online_plain)
    exact_attention = staticmethod(int_attention_fused_plain)


def plain_online_opset(blocks: Optional[Dict[str, Dict[str, int]]] = None):
    """The ``cuda_online`` path in plain PyTorch: :class:`PlainOnlineBackend`
    for ``int_attention`` and ``torch_ref`` for every other op.  On CUDA
    tensors it gives the integers ``cuda_online`` must give at the same
    ``blocks``."""
    from repro_torch.ops.registry import OpSet
    return OpSet("torch_ref", {"int_attention": PlainOnlineBackend(
        name="plain_online", blocks=blocks)})
