"""Cross attention over a memory in the port == the JAX package, bit for
bit: reduced seamless-m4t-large-v2 (an encoder-decoder: 2 encoder and 2
decoder layers, d 128, MHA 4 x 32, GELU, LayerNorm with beta, no integer
position) and reduced llama-3.2-vision-90b (a VLM: 2 groups of 4 self
attention sublayers with RoPE and 1 cross attention sublayer, d 128, GQA
4 / 2, SwiGLU, RMSNorm; 16 image tokens).

  * the configs' fields, ``build_layer_plans`` field by field (``cross ==
    attn``), ``quantize_params`` on the same floats (the encoder stack,
    ``enc_final_norm``, the ``cross`` / ``norm_cross`` leaves carried
    across), ``init_quantized`` == ``quantize_params(init_params(...))``;
  * ``quantize_memory`` on half steps that divide exactly, their
    neighbours, and values past ±127 steps; ``_int_encoder``;
    ``int_attn_fwd(memory8=)`` (a RoPE table given is not applied);
  * ``int_prefill`` under ``ref`` and ``pallas_fused`` (JAX runs its
    Pallas kernels in interpret mode) against the port's twins of those
    names and ``torch_ref``; ``make_prefill_step`` with the float memory;
  * ``init_decode_cache`` with a memory (``ck8`` / ``cv8``) key for key;
    ``int_prefill(return_cache=True)`` then greedy ``int_decode_step``
    (JAX's jitted once), logits every step and every cache leaf; a
    prefill of S tokens == S - 1 with the cache and one decode step;
  * the branch above S·Skv = 2^22 (S = Skv = 3072) under ``torch_ref``:
    the encoder's self attention streams the chunked two-pass, cross
    attention at the same S·Skv the exact full matrix, each == JAX ``ref``;
  * ``ServingEngine`` and the serve CLI refuse both archs (the
    reference's engine fails with ``KeyError: 'ck8'``).

Inputs are numpy draws from fixed seeds.  Tolerance: 0.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import registry as j_registry
from repro.models import intlayers as jil
from repro.models import inttransformer as jit_
from repro.models import model as JM
from repro.quant import convert as j_convert
from repro.quant import plans as j_plans
from repro_torch.configs import registry as t_registry
from repro_torch.interop import from_reference, plan_from_reference
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import intlayers as til
from repro_torch.models import inttransformer as tit
from repro_torch.models import model as TM
from repro_torch.models import transformer as ttf
from repro_torch.quant import convert as t_convert
from repro_torch.quant import plans as t_plans
from repro_torch.serving import ServingEngine as TEngine

T = torch.as_tensor
ENCDEC, VLM = "seamless-m4t-large-v2", "llama-3.2-vision-90b"
ARCHS = (ENCDEC, VLM)
#: the reduced sizes: the encoder's frames, the prompt, the decode steps
FRAMES, PROMPT, STEPS = 24, 9, 4


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


def _reduced(arch):
    over = dict(dtype="float32")
    if arch == VLM:
        over.update(num_layers=10)           # two groups of five
    return (JM.reduce_config(j_registry.get_config(arch), **over),
            TM.reduce_config(t_registry.get_config(arch), **over))


def _memory(cfg, rng, b):
    """The batch's float memory: unit-std frame / image embeddings."""
    n = FRAMES if cfg.family == "encdec" else cfg.n_img_tokens
    key = "src_embeds" if cfg.family == "encdec" else "img_embeds"
    return key, rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)


_MODELS = {}


def _build(arch):
    """Each arch once per module: the port's seeded float draws (unit-std
    embedding) as numpy, quantized by the JAX package and carried across;
    a batch of two prompts with its memory."""
    if arch not in _MODELS:
        jc, tc = _reduced(arch)
        params = _numpy(ttf.init_params(tc, seed=0, device="cpu"))
        params["embed"] *= np.float32(tc.padded_vocab() ** 0.5)
        jq, jp = j_convert.quantize_params(params, jc)
        tq, tp = from_reference(jax.tree.map(np.array, jq), jp, device="cpu")
        rng = np.random.default_rng(11)
        key, mem = _memory(tc, rng, 2)
        toks = rng.integers(0, tc.vocab, (2, PROMPT)).astype(np.int32)
        _MODELS[arch] = dict(arch=arch, jc=jc, tc=tc, params=params, jq=jq,
                             jp=jp, tq=tq, tp=tp, key=key, mem=mem,
                             toks=toks)
    return _MODELS[arch]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _build(request.param)


def _jax_prefill(m, ops, s=PROMPT):
    """JAX ``int_prefill``'s logits of the model's first ``s`` tokens
    under ``ops``, computed once per module."""
    key = ("prefill", ops, s)
    if key not in m:
        m[key] = np.asarray(jit_.int_prefill(m["jq"], _jbatch(m, s),
                                             m["jp"], m["jc"], ops=ops))
    return m[key]


def _jbatch(m, s=PROMPT):
    return {"tokens": jnp.asarray(m["toks"][:, :s]),
            m["key"]: jnp.asarray(m["mem"])}


def _tbatch(m, s=PROMPT):
    return {"tokens": T(m["toks"][:, :s]), m["key"]: T(m["mem"])}


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


# ------------------------------------------------- configs and quant ------

def test_configs_and_plans_match_reference(model):
    """The port's own copies of the configs are the reference's; the
    plans equal JAX's field by field, the cross plans the self attention's
    own."""
    arch, jc, tc = model["arch"], model["jc"], model["tc"]
    assert dataclasses.asdict(t_registry.get_config(arch)) == \
        dataclasses.asdict(j_registry.get_config(arch))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    gl, ng, kinds = ttf.layer_group_spec(tc)
    if arch == VLM:
        assert (gl, ng, tc.n_img_tokens) == (5, 2, 16)
        assert kinds == [("attn", "ffn", False)] * 4 + [("cross", "ffn",
                                                          False)]
    else:
        assert (gl, ng, tc.enc_layers) == (1, 2, 2)
        assert kinds == [("attn", "ffn", True)]
    want = j_plans.build_layer_plans(jc, {"s_emb": 0.01})
    got = t_plans.build_layer_plans(tc, {"s_emb": 0.01})
    assert got == plan_from_reference(want)
    for field in t_plans.LayerPlans._fields:
        assert getattr(got, field) == plan_from_reference(
            getattr(want, field)), field
    assert got.cross == got.attn is not None
    assert model["tp"] == plan_from_reference(model["jp"])


def test_quantize_params_matches_reference(model):
    """The same floats quantized by the port == JAX's integers carried
    across: the decoder's ``cross`` / ``norm_cross`` (or the cross
    mixer's ``attn``), the encoder stack as a list of one stack and
    ``enc_final_norm``."""
    tc, tq = model["tc"], model["tq"]
    got_q, got_p = t_convert.quantize_params(
        jax.tree.map(T, model["params"]), tc)
    assert got_p == model["tp"]
    _same_tree(got_q, tq)
    if tc.family == "encdec":
        assert len(tq["enc_layers"]) == 1
        assert tq["enc_layers"][0]["norm1"]["gamma_q"].shape[0] == \
            tc.enc_layers
        assert {"cross", "norm_cross", "attn"} <= set(tq["layers"][0])
        assert "beta_q" in tq["enc_final_norm"]
    else:
        assert "enc_layers" not in tq and "cross" not in tq["layers"][4]


def test_layer_by_layer_init_equals_whole_model_quantization(model):
    """``init_quantized`` (draw + quantize a layer at a time, the encoder
    after the decoder) == ``quantize_params`` of ``init_params``'s draws
    from the same seed."""
    tc = model["tc"]
    qa, pa = t_convert.init_quantized(tc, seed=3, device="cpu",
                                      embed_scale=4.0)
    params = ttf.init_params(tc, seed=3, device="cpu")
    params["embed"] = params["embed"] * 4.0
    qb, pb = t_convert.quantize_params(params, tc)
    assert pa == pb
    _same_tree(qa, qb)


# ---------------------------------------------------- memory and layers --

def test_quantize_memory_ties_and_clipping():
    """Half steps whose float32 division is exact (round half to even),
    their float32 neighbours, and values past ±127 steps: the port's
    int8 == JAX's."""
    jc, tc = _reduced(VLM)
    s = np.float32(tc.s_act8)
    halves = np.arange(-140, 140, dtype=np.float32) + np.float32(0.5)
    cand = halves * s
    ties = cand[cand / s == halves]
    assert len(ties) > 100
    vals = np.concatenate([
        ties, np.nextafter(ties, np.float32(np.inf)),
        np.nextafter(ties, np.float32(-np.inf)),
        np.float32([127.4, 127.5, 200.0, 1e6, -1e6, np.inf, -np.inf, 0.0,
                    -0.0]) * s,
        np.random.default_rng(0).standard_normal(4096).astype(np.float32)
        * np.float32(12.0)]).astype(np.float32)
    want = np.asarray(jit_.quantize_memory(jnp.asarray(vals), jc))
    got = tit.quantize_memory(T(vals), tc)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)
    assert {-127, 127} <= set(want.tolist())
    even = np.rint(ties / s)
    assert np.array_equal(got.numpy()[:len(ties)],
                          np.clip(even, -127, 127).astype(np.int8))
    # bf16 input goes through float32 as in the reference
    b16 = T(vals[:512]).to(torch.bfloat16)
    want16 = np.asarray(jit_.quantize_memory(
        jnp.asarray(b16.to(torch.float32).numpy()).astype(jnp.bfloat16),
        jc))
    assert np.array_equal(tit.quantize_memory(b16, tc).numpy(), want16)


def test_int_encoder_matches_reference():
    m = _build(ENCDEC)
    want = np.asarray(jit_._int_encoder(m["jq"], jnp.asarray(m["mem"]),
                                        m["jp"], m["jc"], "ref"))
    for ops in ("torch_ref", "cuda"):
        got = tit._int_encoder(m["tq"], T(m["mem"]), m["tp"], m["tc"],
                               tit.resolve_ops(ops))
        assert got.dtype == torch.int8 and got.shape == want.shape
        assert np.array_equal(got.numpy(), want), ops
    assert len(np.unique(want)) > 16


@pytest.mark.parametrize("j_ops", ["ref", "pallas_fused"])
def test_int_attn_fwd_over_a_memory_matches_reference(model, j_ops):
    """One cross attention (Sq 10, Skv the memory's) with a RoPE table
    given, which a cross attention does not apply, and ``causal=True``,
    which it ignores."""
    jc, tc = model["jc"], model["tc"]
    layer = 0 if tc.family == "encdec" else 4
    name = "cross" if tc.family == "encdec" else "attn"
    jqp = jax.tree.map(lambda a: a[0], model["jq"]["layers"][layer][name])
    qp = tit._layer(model["tq"]["layers"][layer], 0)[name]
    rng = np.random.default_rng(4)
    x8 = rng.integers(-127, 128, (2, 10, tc.d_model)).astype(np.int8)
    mem8 = rng.integers(-127, 128, (2, model["mem"].shape[1], tc.d_model)
                        ).astype(np.int8)
    jrope = jil.build_rope_table(64, jc.hd, jc.rope_theta)
    trope = til.build_rope_table(64, tc.hd, tc.rope_theta, device="cpu")
    want = np.asarray(jil.int_attn_fwd(
        jqp, jnp.asarray(x8), model["jp"].cross, jc, jrope, causal=True,
        memory8=jnp.asarray(mem8), ops=j_ops))
    for ops in ({"ref": ("ref", "torch_ref")}.get(j_ops, ("pallas_fused",))):
        got = til.int_attn_fwd(qp, T(x8), model["tp"].cross, tc, trope,
                               causal=True, memory8=T(mem8), ops=ops)
        assert np.array_equal(got.numpy(), want), ops
    plain = til.int_attn_fwd(qp, T(x8), model["tp"].cross, tc, None,
                             causal=False, memory8=T(mem8), ops="torch_ref")
    assert np.array_equal(plain.numpy(), want)


# ---------------------------------------------------------- the slice -----

@pytest.mark.parametrize("j_ops", ["ref", "pallas_fused"])
def test_int_prefill_matches_reference(model, j_ops):
    """Last-position logits: JAX under ``j_ops`` against the port's twin
    of that name (``ref``: also ``torch_ref``), and ``make_prefill_step``
    with the memory given as float32 numpy; the memory moves the
    logits."""
    tc = model["tc"]
    want = _jax_prefill(model, j_ops)
    backends = ("ref", "torch_ref") if j_ops == "ref" else (j_ops,)
    for ops in backends:
        got = tit.int_prefill(model["tq"], _tbatch(model), model["tp"], tc,
                              ops=ops)
        assert np.array_equal(got.numpy(), want), ops
    assert len(np.unique(want.argmax(-1))) > 1
    if j_ops == "ref":
        step = make_prefill_step(tc, model["tp"], ops="cuda", device="cpu")
        batch = {"tokens": model["toks"], model["key"]: model["mem"]}
        args = (model["tq"], batch)
        if tc.pos == "rope":
            args += (til.build_rope_table(PROMPT + 1, tc.hd, tc.rope_theta,
                                          device="cpu"),)
        assert np.array_equal(step(*args).numpy(), want)
        other = dict(batch, **{model["key"]: -model["mem"]})
        assert not np.array_equal(step(model["tq"], other,
                                       *args[2:]).numpy(), want)


def test_init_decode_cache_with_a_memory_matches_reference(model):
    """``ck8`` / ``cv8`` at every cross position (each group's K/V of the
    memory), the self K/V zeroed; a ``cross`` mixer holds no self K/V."""
    jc, tc = model["jc"], model["tc"]
    mem8 = np.array(jit_.quantize_memory(jnp.asarray(model["mem"]), jc))
    want = jit_.init_decode_cache(jc, 2, 16, jnp.asarray(mem8), model["jq"],
                                  model["jp"], "ref")
    got = tit.init_decode_cache(tc, device="cpu", batch=2, cache_len=16,
                                memory8=T(mem8), qparams=model["tq"],
                                plans=model["tp"], ops="torch_ref")
    assert len(got) == len(want)
    for j, (w, g) in enumerate(zip(want, got)):
        assert set(w) == set(g), j
        for key in w:
            assert np.array_equal(g[key].numpy(), np.asarray(w[key])), \
                (j, key)
    cross = [j for j, c in enumerate(got) if "ck8" in c]
    assert cross == ([0] if tc.family == "encdec" else [4])
    assert got[cross[0]]["ck8"].shape == (
        2, 2, mem8.shape[1], tc.n_kv_heads, tc.hd)
    assert ("k8" in got[cross[0]]) == (tc.family == "encdec")
    with pytest.raises(ValueError, match="lanes"):
        tit.init_decode_cache(tc, device="cpu", batch=3, cache_len=16,
                              memory8=T(mem8), qparams=model["tq"],
                              plans=model["tp"])


def test_decode_stream_matches_reference(model):
    """``int_prefill(return_cache=True)`` of the first S - 1 tokens, then
    one ``make_decode_step`` of token S - 1 == the S-token prefill's
    logits; then greedy decode steps: logits every step == JAX's jitted
    ``int_decode_step`` (after JAX's own ``return_cache`` prefill), every
    cache leaf at the end; on ``cuda`` and ``torch_ref``."""
    jc, tc, jq, jp = model["jc"], model["tc"], model["jq"], model["jp"]
    s, L = PROMPT - 1, PROMPT + STEPS
    full = _jax_prefill(model, "ref")
    _, jcache = jit_.int_prefill(jq, _jbatch(model, s), jp, jc, ops="ref",
                                 return_cache=True, cache_len=L)
    jrope = jil.build_rope_table(L + 1, jc.hd, jc.rope_theta) \
        if jc.pos == "rope" else None
    jstep = jax.jit(lambda q, c, t, p, r: jit_.int_decode_step(
        q, c, t, p, jp, jc, r, ops="ref"))
    trope = til.build_rope_table(L + 1, tc.hd, tc.rope_theta,
                                 device="cpu") if tc.pos == "rope" else None
    want, tok = [], model["toks"][:, s]
    for t in range(STEPS + 1):
        pos = np.full((2,), s + t, np.int32)
        jlog, jcache = jstep(jq, jcache, jnp.asarray(tok), jnp.asarray(pos),
                             jrope)
        want.append(np.asarray(jlog))
        tok = want[-1].argmax(-1).astype(np.int32)
    assert np.array_equal(want[0], full)
    assert len({int(x) for w in want for x in w.argmax(-1)}) > 1
    for backend in ("cuda", "torch_ref"):
        _, tcache = tit.int_prefill(model["tq"], _tbatch(model, s),
                                    model["tp"], tc, ops=backend,
                                    return_cache=True, cache_len=L)
        step = make_decode_step(tc, model["tp"], L, ops=backend,
                                device="cpu")
        tok = model["toks"][:, s]
        for t in range(STEPS + 1):
            pos = np.full((2,), s + t, np.int32)
            args = (model["tq"], tcache, tok, pos) + (
                (trope,) if trope is not None else ())
            got, tcache = step(*args)
            assert np.array_equal(got.numpy(), want[t]), (backend, t)
            tok = got.numpy().argmax(-1).astype(np.int32)
        for j, (w, g) in enumerate(zip(jcache, tcache)):
            assert set(w) == set(g), j
            for key in w:
                assert np.array_equal(g[key].numpy(), np.asarray(w[key])), \
                    (backend, j, key)


def test_branch_above_the_full_matrix_threshold(monkeypatch):
    """S = Skv = 3072 (S·Skv > 2^22) under ``torch_ref``: the encoder's
    self attention streams ``i_attention_chunked`` and cross attention
    over a memory of the same length takes the exact full matrix
    (``memory8`` keeps it off the chunked path), each == JAX ``ref``."""
    m = _build(ENCDEC)
    jc, tc = m["jc"], m["tc"]
    jqp = jax.tree.map(lambda a: a[0], m["jq"]["enc_layers"][0]["attn"])
    qp = tit._layer(m["tq"]["enc_layers"][0], 0)["attn"]
    calls = []
    chunked = til.i_attention_chunked
    monkeypatch.setattr(til, "i_attention_chunked",
                        lambda *a, **k: calls.append(1) or chunked(*a, **k))
    rng = np.random.default_rng(9)
    x8 = rng.integers(-127, 128, (1, 3072, tc.d_model)).astype(np.int8)
    mem8 = rng.integers(-127, 128, (1, 3072, tc.d_model)).astype(np.int8)
    assert 3072 * 3072 > til.FULL_MATRIX_MAX
    want = np.asarray(jil.int_attn_fwd(jqp, jnp.asarray(x8), m["jp"].attn,
                                       jc, causal=False, ops="ref"))
    got = til.int_attn_fwd(qp, T(x8), m["tp"].attn, tc, causal=False,
                           ops="torch_ref")
    assert np.array_equal(got.numpy(), want) and calls == [1]
    want = np.asarray(jil.int_attn_fwd(jqp, jnp.asarray(x8), m["jp"].cross,
                                       jc, causal=False,
                                       memory8=jnp.asarray(mem8), ops="ref"))
    got = til.int_attn_fwd(qp, T(x8), m["tp"].cross, tc, causal=False,
                           memory8=T(mem8), ops="torch_ref")
    assert np.array_equal(got.numpy(), want) and calls == [1]


def test_engine_and_serve_cli_refuse(model, capsys):
    """The reference's engine builds its caches without the memory and
    fails at its first step (``KeyError: 'ck8'``); the port's refuses at
    construction, and so does the serve CLI; speculation and chunked
    prefill stay unsupported."""
    arch, tc = model["arch"], model["tc"]
    with pytest.raises(ValueError, match="KeyError: 'ck8'"):
        TEngine(model["tq"], model["tp"], tc, batch_size=2, cache_len=16,
                device="cpu")
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--arch", arch, "--reduced", "--device", "cpu"])
    assert "ck8" in capsys.readouterr().err
    assert not tit.speculative_decode_supported(tc)
    assert not tit.chunked_prefill_supported(tc)
