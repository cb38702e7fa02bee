"""The reference's chunked two-pass attention in the port, and the choice
between it and the exact path, == the JAX package, bit for bit.

  * ``core.attention.i_attention_chunked`` against JAX's: causal, windowed
    and unmasked, chunks 64 and 1024, GQA heads repeated;
    ``i_attention_decode`` against JAX's;
  * above the reference's full-matrix threshold (S = 3072 > 2048): the
    port's ``int_attn_fwd`` (with ``fuse_attention`` True and False) and
    ``int_prefill`` on reduced llama3-8b under ``ref``, ``pallas_fused``
    and ``torch_ref`` against JAX under the same names (``torch_ref``
    against ``ref``).  There ``ref`` streams the chunked path and
    ``pallas_fused`` runs its exact kernel: the two give different
    integers, in both packages;
  * past ``MAX_ROWSUM_LEN`` keys (Skv = 2^15 + 1024): the ``cuda``
    backend's ``int_attention`` (its plain version on the CPU) against JAX
    ``pallas_fused``'s chunked fallback.

Inputs are numpy draws from fixed seeds.  Tolerance: 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as j_get_config
from repro.core import attention as j_attn
from repro.models import intlayers as jil
from repro.models import inttransformer as jit_
from repro.models import model as JM
from repro.models import transformer as jtf
from repro.ops import RequantSpec as JSpec
from repro.ops.backends.pallas_fused import PallasFusedBackend
from repro.quant import convert as j_convert
from repro_torch import kernels
from repro_torch import ops as tops
from repro_torch.analysis.budgets import MAX_ROWSUM_LEN
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.core import attention as t_attn
from repro_torch.interop import from_reference, plan_from_reference
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import intlayers as til
from repro_torch.models import inttransformer as tit
from repro_torch.models import model as TM
from repro_torch.ops.spec import RequantSpec as TSpec

T = torch.as_tensor

#: above the threshold (3072^2 > 4096^2 / 4) and a multiple of 1024
S_LONG = 3072
#: the JAX names each port name is held against
J_NAME = {"ref": "ref", "pallas_fused": "pallas_fused", "torch_ref": "ref"}


def _i8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _plans():
    jp = j_attn.make_iattention(32, 0.05, 0.05, 0.05, 0.04)
    tp = t_attn.make_iattention(32, 0.05, 0.05, 0.05, 0.04)
    assert plan_from_reference(jp) == tp
    return jp, tp


# ------------------------------------------------------------- core -------

@pytest.mark.parametrize("mask", ["causal", "window", "none"])
@pytest.mark.parametrize("s,chunk,b", [(256, 64, 2), (2048, 1024, 1)])
def test_i_attention_chunked_matches_reference(mask, s, chunk, b):
    jp, tp = _plans()
    rng = np.random.default_rng(s + len(mask))
    q = _i8(rng, (b, s, 4, 32))
    k, v = _i8(rng, (b, s, 2, 32)), _i8(rng, (b, s, 2, 32))
    causal, window = mask != "none", (s // 3 if mask == "window" else 0)
    want = np.asarray(j_attn.i_attention_chunked(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), 2, 2),
        jnp.repeat(jnp.asarray(v), 2, 2), jp, chunk, causal, window))
    got = t_attn.i_attention_chunked(
        T(q), T(k).repeat_interleave(2, 2), T(v).repeat_interleave(2, 2),
        tp, chunk, causal, window)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # the rescales move the integers off the oracle's (exp16(0) = 32755)
    full = t_attn.i_attention_full(
        T(q), T(k).repeat_interleave(2, 2), T(v).repeat_interleave(2, 2),
        tp, mask=(t_attn.causal_mask(s, s, window=window) if causal
                  else None))
    assert not torch.equal(got, full)


def test_i_attention_chunked_asserts_whole_chunks():
    _, tp = _plans()
    x = T(np.zeros((1, 100, 2, 32), np.int8))
    with pytest.raises(AssertionError):
        t_attn.i_attention_chunked(x, x, x, tp, chunk=64)


def test_i_attention_decode_matches_reference():
    jp, tp = _plans()
    rng = np.random.default_rng(5)
    q = _i8(rng, (3, 1, 4, 32))
    k, v = _i8(rng, (3, 200, 4, 32)), _i8(rng, (3, 200, 4, 32))
    vl = np.array([1, 77, 200], np.int32)
    for out_bits in (8, 16):
        want = np.asarray(j_attn.i_attention_decode(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jp,
            jnp.asarray(vl), out_bits))
        got = t_attn.i_attention_decode(T(q), T(k), T(v), tp, T(vl),
                                        out_bits)
        assert np.array_equal(got.numpy(), want)


# ------------------------------------------------------------ model -------

@pytest.fixture(scope="module")
def llama():
    jc = JM.reduce_config(j_get_config("llama3-8b"), dtype="float32")
    tc = TM.reduce_config(t_get_config("llama3-8b"), dtype="float32")
    params = jtf.init_params(jax.random.key(1), jc)
    jq, jp = j_convert.quantize_params(params, jc)
    tq, tp = from_reference(jax.tree.map(np.array, jq), jp, device="cpu")
    x8 = _i8(np.random.default_rng(7), (1, S_LONG, jc.d_model))
    return dict(jc=jc, tc=tc, jq=jq, jp=jp, tq=tq, tp=tp, x8=x8,
                jqp=jax.tree.map(lambda a: a[0], jq["layers"][0]["attn"]),
                tqp=tit._layer(tq["layers"][0], 0)["attn"], attn={})


def _j_attn_fwd(m, jname, fuse):
    """JAX ``int_attn_fwd`` at S_LONG, computed once per (name, fuse)."""
    key = (jname, fuse)
    if key not in m["attn"]:
        jc = m["jc"]
        rope = jil.build_rope_table(S_LONG + 1, jc.hd, jc.rope_theta)
        m["attn"][key] = np.asarray(jil.int_attn_fwd(
            m["jqp"], jnp.asarray(m["x8"]), m["jp"].attn, jc, rope,
            ops=jname, fuse_attention=fuse))
    return m["attn"][key]


def _t_attn_fwd(m, name, fuse):
    tc = m["tc"]
    rope = til.build_rope_table(S_LONG + 1, tc.hd, tc.rope_theta,
                                device="cpu")
    return til.int_attn_fwd(m["tqp"], T(m["x8"]), m["tp"].attn, tc, rope,
                            ops=name, fuse_attention=fuse)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("name", ["ref", "pallas_fused", "torch_ref"])
def test_int_attn_fwd_above_the_threshold(llama, name, fuse):
    """Each name takes the reference's branch: ``ref`` / ``torch_ref``
    (and any name with ``fuse_attention=False``) the chunked path,
    ``pallas_fused`` its exact kernel (K5 on ``cuda``)."""
    want = _j_attn_fwd(llama, J_NAME[name], fuse)
    kernels.reset_launches()
    got = _t_attn_fwd(llama, name, fuse)
    assert np.array_equal(got.numpy(), want)
    assert sum(kernels.LAUNCHES.values()) == 0       # the CPU: plain only


def test_ref_and_pallas_fused_differ_above_the_threshold(llama):
    """The reference's own ``ref`` and ``pallas_fused`` give different
    integers at S = 3072 (chunk rescales against the exact sums); the port
    keeps the difference, each name as its twin."""
    j_ref = _j_attn_fwd(llama, "ref", True)
    j_fused = _j_attn_fwd(llama, "pallas_fused", True)
    assert not np.array_equal(j_ref, j_fused)
    t_ref = _t_attn_fwd(llama, "ref", True)
    t_fused = _t_attn_fwd(llama, "pallas_fused", True)
    assert not torch.equal(t_ref, t_fused)
    assert tops.get_backend("ref").name == "cuda_ref"
    assert tops.get_backend("pallas_fused").name == "cuda"
    assert not tops.get_backend("ref").fused_attention


@pytest.mark.parametrize("name", ["ref", "pallas_fused", "torch_ref"])
def test_int_prefill_above_the_threshold(llama, name):
    jc, tc = llama["jc"], llama["tc"]
    toks = np.random.default_rng(3).integers(0, jc.vocab, (1, S_LONG)
                                              ).astype(np.int32)
    want = np.asarray(jit_.int_prefill(llama["jq"],
                                       {"tokens": jnp.asarray(toks)},
                                       llama["jp"], jc, ops=J_NAME[name]))
    got = tit.int_prefill(llama["tq"], {"tokens": T(toks)}, llama["tp"], tc,
                          ops=name)
    assert np.array_equal(got.numpy(), want)
    if name == "ref":
        # the step builder, on the config's default ("ref"), chooses the same
        assert tc.kernel_backend == "ref"
        step = make_prefill_step(tc, llama["tp"], device="cpu")
        rope = til.build_rope_table(S_LONG + 1, tc.hd, tc.rope_theta,
                                    device="cpu")
        assert torch.equal(step(llama["tq"], {"tokens": toks}, rope), got)


# ------------------------------------------------- past the row sum -------

@pytest.mark.parametrize("causal,out_bits", [(False, 8), (True, 16)])
def test_cuda_attention_past_the_rowsum_budget(causal, out_bits):
    """Skv = 2^15 + 1024 > MAX_ROWSUM_LEN: ``cuda``'s ``int_attention``
    streams the chunked path (chunks of ``fit_block(1024, Skv)``), as the
    reference's ``pallas_fused`` falls back; per-tensor epilogues only."""
    jp, tp = _plans()
    skv = MAX_ROWSUM_LEN + 1024
    rng = np.random.default_rng(11)
    q, k, v = (_i8(rng, (1, 64, 2, 32)), _i8(rng, (1, skv, 1, 32)),
               _i8(rng, (1, skv, 1, 32)))
    want = np.asarray(PallasFusedBackend(interpret=True).int_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jp, causal=causal,
        requant=JSpec.per_tensor(jp.dn_out, out_bits)))
    got = tops.get_backend("cuda").int_attention(
        T(q), T(k), T(v), tp, causal=causal,
        requant=TSpec.per_tensor(tp.dn_out, out_bits))
    assert got.dtype == (torch.int8 if out_bits == 8 else torch.int32)
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(NotImplementedError, match="per-tensor"):
        tops.get_backend("cuda").int_attention(
            T(q), T(k), T(v), tp, requant=TSpec.per_channel(22, 8),
            b_vec=T(np.ones(64, np.int32)))


def test_cuda_ref_is_cuda_but_for_the_attention_flag():
    """``ref``'s twin shares every kernel and capability of ``cuda``; only
    ``fused_attention`` differs (the resolution order is held in
    ``tests/test_torch_online.py``)."""
    cuda, ref = tops.get_backend("cuda"), tops.get_backend("cuda_ref")
    assert isinstance(ref, type(cuda)) and ref is not cuda
    assert cuda.fused_attention and not ref.fused_attention
    for flag in ("paged_decode", "decode_wo_fold", "paged_prefill",
                 "prefill_wo_fold", "packed_kv", "packed_matmul"):
        assert getattr(ref, flag) is getattr(cuda, flag) is True
