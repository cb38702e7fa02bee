"""The ported encoder path (full-sequence ``int_prefill``) == the JAX
package, bit for bit.

  * K6 (i-GELU): the plain version against the Pallas kernel in interpret
    mode and the JAX oracle on the whole 11-bit input domain of the FFN,
    plus seeded int32 over the whole range (int32 wrap-around);
  * K5 (full-sequence attention): the plain version against the Pallas
    kernel in interpret mode — H = Hkv and GQA, D 32/64, no mask, causal
    and window 8, the three epilogues, Sq != Skv — and a ragged S = 37
    against the JAX oracle;
  * quantization of reduced roberta-base (tied embeddings: the encoder
    has no ``lm_head``): plans and integer params equal JAX's, beta_q,
    the GELU plan and the tied head included;
  * the slice: ``int_prefill`` / ``make_prefill_step`` logits equal JAX
    ``int_prefill`` for reduced roberta-base and reduced llama3-8b (causal,
    RoPE) at S = 32 and 40, against JAX's ``ref`` and ``pallas_fused``
    (interpret mode) backends, on both port backends.

Inputs are numpy draws from fixed seeds.  Tolerance: 0.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as j_get_config
from repro.core import activations as j_act
from repro.core import attention as j_attn
from repro.kernels.int_attention_fused import int_attention_fused as j_k5
from repro.kernels.int_gelu import int_gelu_pallas
from repro.kernels.ref import ref_int_attention as j_ref_attention
from repro.kernels.ref import ref_int_gelu as j_ref_gelu
from repro.models import intlayers as jil
from repro.models import inttransformer as jit_
from repro.models import model as JM
from repro.models import transformer as jtf
from repro.ops import RequantSpec as JSpec
from repro.quant import convert as j_convert
from repro.quant import plans as j_plans
from repro_torch import kernels
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.core import activations as t_act
from repro_torch.interop import from_reference, plan_from_reference
from repro_torch.kernels.int_attention_fused import (
    int_attention_fused, int_attention_fused_plain)
from repro_torch.kernels.int_gelu import int_gelu, int_gelu_plain
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import intlayers as til
from repro_torch.models import inttransformer as tit
from repro_torch.models import model as TM
from repro_torch.models import transformer as ttf
from repro_torch.ops import resolve_ops
from repro_torch.ops.spec import RequantSpec as TSpec
from repro_torch.quant import convert as t_convert
from repro_torch.quant import plans as t_plans

T = torch.as_tensor


def _i8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


# ------------------------------------------------------------------ K6 ----

@pytest.fixture(scope="module")
def gelu_plans():
    """The FFN's i-GELU plan (the same at every width: s_act10 in, s_act8
    out, 1024 = the 11-bit w1 output range)."""
    jp = j_act.make_igelu_act(16.0 / 1024.0, 1024, 8.0 / 127.0)
    tp = t_act.make_igelu_act(16.0 / 1024.0, 1024, 8.0 / 127.0)
    assert plan_from_reference(jp) == tp
    return jp, tp


def _gelu_inputs():
    rng = np.random.default_rng(6)
    domain = np.arange(-1024, 1024, dtype=np.int32)       # every 11-bit q
    wide = rng.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
    edges = np.array([-2**31, -2**31 + 1, 2**31 - 1, -2**15, 2**15, 0, 1,
                      -1, 160, -160, 161, -161], np.int32)
    return {"domain": domain.reshape(64, 32),
            "int32": np.concatenate([wide, edges])}


@pytest.mark.parametrize("which", ["domain", "int32"])
@pytest.mark.parametrize("out_bits", [8, 16])
def test_int_gelu_plain_matches_pallas(gelu_plans, which, out_bits):
    jp, tp = gelu_plans
    q = _gelu_inputs()[which]
    want = int_gelu_pallas(jnp.asarray(q), jp.gelu, jp.dn_out, out_bits,
                           block=512, interpret=True)
    want_ref = j_ref_gelu(jnp.asarray(q), jp.gelu, jp.dn_out, out_bits)
    assert np.array_equal(np.asarray(want), np.asarray(want_ref))
    got = int_gelu_plain(T(q), tp.gelu, tp.dn_out, out_bits)
    assert got.dtype == torch.int32 and got.shape == q.shape
    assert np.array_equal(got.numpy(), np.asarray(want))
    kernels.reset_launches()
    for out in (int_gelu(T(q), tp.gelu, tp.dn_out, out_bits),
                resolve_ops("cuda").int_gelu(T(q), tp.gelu, tp.dn_out,
                                             out_bits),
                resolve_ops("torch_ref").int_gelu(T(q), tp.gelu,
                                                  tp.dn_out, out_bits)):
        assert torch.equal(out, got)
    assert kernels.LAUNCHES["int_gelu"] == 0       # CPU: no launch
    if out_bits == 8:
        assert torch.equal(t_act.i_gelu_act(T(q), tp), got)


# ------------------------------------------------------------------ K5 ----

def _attn_specs(form, jplan, tplan):
    if form == "per_tensor":
        return JSpec.per_tensor(jplan.dn_out), TSpec.per_tensor(tplan.dn_out)
    if form == "per_channel":
        return JSpec.per_channel(22, 8), TSpec.per_channel(22, 8)
    if form == "per_channel16":
        return (JSpec.per_channel(20, 6, out_bits=16),
                TSpec.per_channel(20, 6, out_bits=16))
    return JSpec.raw(), TSpec.raw()


K5_CASES = [
    # (b, sq, skv, h, hkv, d, causal, window, form)
    (2, 32, 32, 4, 4, 32, False, 0, "per_tensor"),
    (2, 32, 32, 4, 2, 64, False, 0, "per_channel"),
    (1, 32, 32, 4, 2, 32, True, 0, "per_tensor"),
    (2, 32, 32, 4, 1, 64, True, 0, "raw"),
    (1, 32, 32, 2, 2, 64, True, 8, "per_tensor"),
    (2, 32, 32, 4, 2, 32, True, 8, "per_channel16"),
    (2, 16, 48, 4, 2, 64, False, 0, "per_tensor"),     # cross-shaped
    (1, 48, 16, 2, 1, 32, False, 0, "raw"),
]


@pytest.mark.parametrize(
    "b,sq,skv,h,hkv,d,causal,window,form", K5_CASES,
    ids=["-".join(map(str, c)) for c in K5_CASES])
def test_int_attention_plain_matches_pallas(b, sq, skv, h, hkv, d, causal,
                                            window, form):
    rng = np.random.default_rng(sq * 7 + skv + h + hkv + d + window)
    jplan = j_attn.make_iattention(d, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    tplan = plan_from_reference(jplan)
    q8, k8, v8 = (_i8(rng, (b, sq, h, d)), _i8(rng, (b, skv, hkv, d)),
                  _i8(rng, (b, skv, hkv, d)))
    bvec = rng.integers(1000, 20000, (h * d,)).astype(np.int32)
    js, ts = _attn_specs(form, jplan, tplan)
    want = j_k5(jnp.asarray(q8), jnp.asarray(k8), jnp.asarray(v8), jplan,
                requant=js, b_vec=jnp.asarray(bvec), causal=causal,
                window=window, bq=16, bkv=16, interpret=True)
    got = int_attention_fused_plain(T(q8), T(k8), T(v8), tplan, requant=ts,
                                    b_vec=T(bvec), causal=causal,
                                    window=window)
    assert got.dtype == (torch.int8 if str(want.dtype) == "int8"
                         else torch.int32)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # the wrapper and the op set on CPU tensors: the same integers
    for out in (int_attention_fused(T(q8), T(k8), T(v8), tplan, ts,
                                    T(bvec), causal, window),
                resolve_ops("cuda").int_attention(
                    T(q8), T(k8), T(v8), tplan, causal=causal,
                    window=window, requant=ts, b_vec=T(bvec))):
        assert torch.equal(out, got)


@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0),
                                           (True, 8), (False, 5)])
def test_int_attention_ragged_matches_oracle(causal, window):
    """S = 37 (no block divides it; the Pallas kernel cannot take it):
    the plain version and the ``torch_ref`` op equal JAX's oracle, the
    default epilogue included."""
    rng = np.random.default_rng(37 + window)
    b, s, h, hkv, d = 2, 37, 4, 2, 32
    jplan = j_attn.make_iattention(d, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    tplan = plan_from_reference(jplan)
    q8, k8, v8 = (_i8(rng, (b, s, h, d)), _i8(rng, (b, s, hkv, d)),
                  _i8(rng, (b, s, hkv, d)))
    want = j_ref_attention(jnp.asarray(q8), jnp.asarray(k8), jnp.asarray(v8),
                           jplan, causal, window,
                           requant=JSpec.per_tensor(jplan.dn_out))
    got = int_attention_fused_plain(T(q8), T(k8), T(v8), tplan,
                                    causal=causal, window=window)
    assert np.array_equal(got.numpy(), np.asarray(want))
    want32 = j_ref_attention(jnp.asarray(q8), jnp.asarray(k8),
                             jnp.asarray(v8), jplan, causal, window)
    got32 = resolve_ops("torch_ref").int_attention(
        T(q8), T(k8), T(v8), tplan, causal=causal, window=window)
    assert np.array_equal(got32.numpy(), np.asarray(want32))


# ------------------------------------------------------- quantization -----

def _encoder_cfgs(**over):
    jc = JM.reduce_config(j_get_config("roberta-base"), **over)
    tc = TM.reduce_config(t_get_config("roberta-base"), **over)
    return (dataclasses.replace(jc, tie_embeddings=True),
            dataclasses.replace(tc, tie_embeddings=True))


def _same_tree(a, b, path="root"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}[{i}]")
    elif a is None or b is None:
        assert a is None and b is None, path
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path


def test_encoder_config_and_plans_match_reference():
    jc, tc = j_get_config("roberta-base"), t_get_config("roberta-base")
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert not tc.is_causal and jc.is_causal == tc.is_causal
    for jcfg, tcfg in ((jc, tc), _encoder_cfgs(dtype="float32")):
        for calib in (None, {"s_emb": 0.0123}):
            want = plan_from_reference(j_plans.build_layer_plans(jcfg, calib))
            got = t_plans.build_layer_plans(tcfg, calib)
            assert got == want
            assert got.ffn.act_gelu is not None and got.ffn.act_silu is None
            assert got.norm.subtract_mean


@pytest.fixture(scope="module")
def encoder_setup():
    jc, tc = _encoder_cfgs(dtype="float32")
    params = jtf.init_params(jax.random.key(0), jc)
    jq, jp = j_convert.quantize_params(params, jc)
    tq, tp = from_reference(jax.tree.map(np.array, jq), jp, device="cpu")
    return jc, tc, params, jq, jp, tq, tp


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def test_encoder_quantize_params_match(encoder_setup):
    """The port's converter on JAX's float draws: every integer equal —
    beta_q, the GELU FFN's w1/w2 biases, the tied head and its scales —
    and every tensor contiguous, as the kernels take them (the tied head
    is ``embed.T``)."""
    jc, tc, params, jq, jp, tq, tp = encoder_setup
    tparams = jax.tree.map(lambda a: torch.as_tensor(np.array(a)), params)
    got_q, got_p = t_convert.quantize_params(tparams, tc)
    assert got_p == tp
    _same_tree(got_q, tq)
    assert all(t.is_contiguous() for t in _leaves(got_q))
    layer = got_q["layers"][0]
    assert "beta_q" in layer["norm1"] and "w3" not in layer["ffn"]
    emb = np.asarray(params["embed"], np.float64)
    s_head = np.maximum(np.abs(emb.T).max(axis=0), 1e-8) / 127.0
    assert np.array_equal(got_q["head_scale"].numpy(),
                           s_head.astype(np.float32))


def test_encoder_needs_tied_embeddings():
    tc = TM.reduce_config(t_get_config("roberta-base"), dtype="float32")
    params = ttf.init_params(tc, seed=0, device="cpu")
    assert "lm_head" not in params and params["pos_embed"].shape == (
        65536, tc.d_model)
    with pytest.raises(ValueError, match="tie_embeddings"):
        t_convert.quantize_params(params, tc)
    with pytest.raises(ValueError, match="tie_embeddings"):
        t_convert.init_quantized(tc, device="cpu")


def test_encoder_layer_by_layer_init_equals_whole_model_quantization():
    _, tc = _encoder_cfgs(dtype="float32")
    qa, pa = t_convert.init_quantized(tc, seed=3, device="cpu")
    qb, pb = t_convert.quantize_params(
        ttf.init_params(tc, seed=3, device="cpu"), tc)
    assert pa == pb
    _same_tree(qa, qb)
    assert all(t.is_contiguous() for t in _leaves(qa))


# -------------------------------------------------------------- slice -----

@pytest.fixture(scope="module")
def decoder_setup():
    jc = JM.reduce_config(j_get_config("llama3-8b"), dtype="float32")
    tc = TM.reduce_config(t_get_config("llama3-8b"), dtype="float32")
    params = jtf.init_params(jax.random.key(1), jc)
    jq, jp = j_convert.quantize_params(params, jc)
    tq, tp = from_reference(jax.tree.map(np.array, jq), jp, device="cpu")
    return jc, tc, jq, jp, tq, tp


@pytest.mark.parametrize("j_ops", ["ref", "pallas_fused"])
@pytest.mark.parametrize("s", [32, 40])
@pytest.mark.parametrize("arch", ["roberta-base", "llama3-8b"])
def test_int_prefill_matches_reference(request, arch, s, j_ops):
    """Last-position logits of the full-sequence forward: the port's
    ``int_prefill`` on both backends and ``make_prefill_step`` equal JAX
    ``int_prefill`` (the encoder non-causal, the decoder causal with
    RoPE tables built inside and passed in)."""
    setup = request.getfixturevalue(
        "encoder_setup" if arch == "roberta-base" else "decoder_setup")
    jc, tc, jq, jp, tq, tp = (setup[0], setup[1], *setup[-4:])
    toks = np.random.default_rng(s).integers(
        0, jc.vocab, (2, s)).astype(np.int32)
    want = np.asarray(jit_.int_prefill(jq, {"tokens": jnp.asarray(toks)},
                                       jp, jc, ops=j_ops))
    for backend in ("torch_ref", "cuda"):
        got = tit.int_prefill(tq, {"tokens": T(toks)}, tp, tc, ops=backend)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want), backend
    step = make_prefill_step(tc, tp, ops="cuda", device="cpu")
    args = (tq, {"tokens": toks})
    if tc.pos == "rope":
        args += (til.build_rope_table(s + 1, tc.hd, tc.rope_theta,
                                        device="cpu"),)
    assert np.array_equal(step(*args).numpy(), want)


def test_int_prefill_unported_options_raise(encoder_setup):
    """The options this test saw refused, a memory for ``int_prefill`` and
    ``memory8=`` for ``int_attn_fwd``, now run and equal JAX: a reduced
    VLM of one group of five (JAX's own init) over 8 image embeddings,
    and one roberta layer's attention over an int8 memory."""
    over = dict(dtype="float32", num_layers=5, n_img_tokens=8)
    jc = JM.reduce_config(j_get_config("llama-3.2-vision-90b"), **over)
    tc = TM.reduce_config(t_get_config("llama-3.2-vision-90b"), **over)
    jq, jp = j_convert.quantize_params(jtf.init_params(jax.random.key(2),
                                                       jc), jc)
    tq, tp = from_reference(jax.tree.map(np.array, jq), jp, device="cpu")
    rng = np.random.default_rng(8)
    batch = {"tokens": rng.integers(0, jc.vocab, (2, 6)).astype(np.int32),
             "img_embeds": rng.standard_normal((2, 8, jc.d_model)
                                               ).astype(np.float32)}
    want = np.asarray(jit_.int_prefill(jq, {k: jnp.asarray(v) for k, v
                                            in batch.items()}, jp, jc,
                                       ops="ref"))
    for backend in ("torch_ref", "cuda"):
        got = tit.int_prefill(tq, {k: T(v) for k, v in batch.items()}, tp,
                              tc, ops=backend)
        assert np.array_equal(got.numpy(), want), backend
    jc, tc, jq, jp, tq, tp = (encoder_setup[0], encoder_setup[1],
                              *encoder_setup[-4:])
    x8, mem8 = _i8(rng, (1, 8, tc.d_model)), _i8(rng, (1, 5, tc.d_model))
    want = np.asarray(jil.int_attn_fwd(
        jax.tree.map(lambda a: a[0], jq["layers"][0]["attn"]),
        jnp.asarray(x8), jp.attn, jc, memory8=jnp.asarray(mem8), ops="ref"))
    got = til.int_attn_fwd(tit._layer(tq["layers"][0], 0)["attn"], T(x8),
                           tp.attn, tc, memory8=T(mem8), ops="torch_ref")
    assert np.array_equal(got.numpy(), want)


def test_non_fused_backend_refuses_the_chunked_length(encoder_setup):
    """Above the reference's full-matrix threshold a non-fused backend
    streams ``i_attention_chunked``: at S = 3072 the port's ``torch_ref``
    equals JAX ``ref`` (the encoder, unmasked); at S = 2049 the port
    refuses as the reference asserts (the chunk, ``min(1024, S)``, must
    divide S)."""
    jc, tc = encoder_setup[0], encoder_setup[1]
    jq, jp, tq, tp = encoder_setup[-4:]
    jqp = jax.tree.map(lambda a: a[0], jq["layers"][0]["attn"])
    qp = tit._layer(tq["layers"][0], 0)["attn"]
    x8 = _i8(np.random.default_rng(9), (1, 3072, tc.d_model))
    want = np.asarray(jil.int_attn_fwd(jqp, jnp.asarray(x8), jp.attn, jc,
                                       causal=False, ops="ref"))
    got = til.int_attn_fwd(qp, T(x8), tp.attn, tc, causal=False,
                           ops="torch_ref")
    assert np.array_equal(got.numpy(), want)
    s = 2049                                  # s * s > 4096 * 4096 / 4
    x8 = np.zeros((1, s, tc.d_model), np.int8)
    with pytest.raises(AssertionError):
        jil.int_attn_fwd(jqp, jnp.asarray(x8), jp.attn, jc, causal=False,
                         ops="ref")
    with pytest.raises(AssertionError):
        til.int_attn_fwd(qp, T(x8), tp.attn, tc, causal=False,
                         ops="torch_ref")


def test_engine_refuses_an_encoder(encoder_setup):
    from repro_torch.serving import ServingEngine
    tc, tq, tp = encoder_setup[1], encoder_setup[-2], encoder_setup[-1]
    with pytest.raises(ValueError, match="encoder"):
        ServingEngine(tq, tp, tc, device="cpu", batch_size=1, cache_len=16)


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")


def test_encoder_entry_points_default_to_the_card(no_gpu, encoder_setup):
    tc, tp = encoder_setup[1], encoder_setup[-1]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_prefill_step(tc, tp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_convert.init_quantized(tc)
