"""Four more configs of the reference's registry in the port == the JAX
package, bit for bit, and the derived config fields for all 13 archs.

  * codeqwen1.5-7b (MHA with QKV bias), granite-3-2b (a tied head over an
    odd vocabulary, 49155, padded to 49168), roberta-large (LayerNorm at
    d = 1024) and deit-s (a 197-token encoder): fields equal at full
    size, plans and ``quantize_params`` equal at reduced size (each
    reduced config keeps the feature it is here for), and ``int_prefill``
    logits equal JAX's under ``ref`` and ``pallas_fused`` (interpret
    mode) on the port's twins and on ``torch_ref``;
  * ``ServingEngine`` streams of the two decoders equal the JAX engine's
    (paged, chunked prefill), on ``cuda`` and ``torch_ref``, and so do
    their ``make_decode_step`` logits and caches after
    ``int_prefill(return_cache=True)``;
  * ``param_count``, ``layer_param_count``, ``active_param_count``,
    ``padded_experts``, ``ssm_d_inner``, ``ssm_heads``, the layer kinds and
    ``SHAPES`` equal JAX's for every one of the reference's 13 archs (the
    port's ``ArchConfig`` built from each JAX config's fields); the
    registry's ``ASSIGNED`` / ``LONG_OK`` are the reference's.

Inputs are numpy draws from fixed seeds.  Tolerance: 0.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import registry as j_registry
from repro.launch.steps import make_decode_step as j_make_decode_step
from repro.models import common as j_common
from repro.models import intlayers as jil
from repro.models import inttransformer as jit_
from repro.models import model as JM
from repro.models import transformer as jtf
from repro.quant import convert as j_convert
from repro.quant import plans as j_plans
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import registry as t_registry
from repro_torch.interop import from_reference, plan_from_reference
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import common as t_common
from repro_torch.models import intlayers as til
from repro_torch.models import inttransformer as tit
from repro_torch.models import model as TM
from repro_torch.quant import convert as t_convert
from repro_torch.quant import plans as t_plans
from repro_torch.serving import Request as TRequest
from repro_torch.serving import ServingEngine as TEngine

T = torch.as_tensor

#: each new config, cut to the reduced size, keeping its feature
REDUCE = {"codeqwen1.5-7b": dict(n_kv_heads=4),      # MHA 4 / 4, QKV bias
          "granite-3-2b": dict(vocab=49155),        # odd vocab, tied head
          "roberta-large": dict(d_model=1024),      # LayerNorm at d 1024
          "deit-s": {}}                             # S = 197 below
ENCODERS = ("roberta-large", "deit-s")
DECODERS = ("codeqwen1.5-7b", "granite-3-2b")
#: (batch, sequence) of the int_prefill parity
SHAPE = {"codeqwen1.5-7b": (2, 40), "granite-3-2b": (2, 40),
         "roberta-large": (2, 64), "deit-s": (2, 197)}


def _cfgs(arch):
    over = dict(dtype="float32", **REDUCE[arch])
    jc = JM.reduce_config(j_registry.get_config(arch), **over)
    tc = TM.reduce_config(t_registry.get_config(arch), **over)
    if arch in ENCODERS:           # an encoder has no lm_head (ROADMAP §3)
        jc = dataclasses.replace(jc, tie_embeddings=True)
        tc = dataclasses.replace(tc, tie_embeddings=True)
    return jc, tc


_MODELS = {}


@pytest.fixture
def model(request):
    arch = request.param
    if arch not in _MODELS:
        jc, tc = _cfgs(arch)
        params = jtf.init_params(jax.random.key(2), jc)
        # the embedding at unit std, as ``launch/serve.py`` draws it: the
        # reference init's 1/sqrt(V) std quantizes below the norm's
        # pre-shift at granite's vocabulary, and every token comes out 0
        # (ROADMAP §3)
        params = {**params, "embed": params["embed"]
                  * np.float32(jc.padded_vocab() ** 0.5)}
        jq, jp = j_convert.quantize_params(params, jc)
        tq, tp = from_reference(jax.tree.map(np.array, jq), jp,
                                device="cpu")
        _MODELS[arch] = dict(arch=arch, jc=jc, tc=tc, params=params, jq=jq,
                             jp=jp, tq=tq, tp=tp)
    return _MODELS[arch]


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


# ----------------------------------------------------------- configs -----

@pytest.mark.parametrize("arch", list(REDUCE))
def test_config_fields_match_reference(arch):
    jfull, tfull = (j_registry.get_config(arch),
                    t_registry.get_config(arch))
    assert dataclasses.asdict(jfull) == dataclasses.asdict(tfull)
    jc, tc = _cfgs(arch)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    if arch == "codeqwen1.5-7b":
        assert tfull.q_group == tc.q_group == 1 and tc.attn_bias
        assert tfull.d_ff == 13440
    elif arch == "granite-3-2b":
        assert tc.vocab == 49155 and tc.tie_embeddings
        assert tc.padded_vocab() == 49168
    elif arch == "roberta-large":
        assert tc.d_model == tfull.d_model == 1024 and not tc.is_causal
    else:
        assert tfull.n_img_tokens == 197 and tfull.d_model == 384
    assert t_registry.ASSIGNED == j_registry.ASSIGNED
    assert t_registry.LONG_OK == j_registry.LONG_OK
    assert set(t_registry.ARCHS) <= set(j_registry.ARCHS)


def test_serve_cli_takes_the_new_decoders():
    from repro_torch.launch import serve
    choices = next(a.choices for a in serve.build_parser()._actions
                   if a.dest == "arch")
    assert set(DECODERS) <= set(choices)
    assert not set(ENCODERS) & set(choices)


@pytest.mark.parametrize("model", list(REDUCE), indirect=True)
def test_plans_and_quantize_params_match(model):
    """The port's converter on JAX's float draws: plans and every integer
    equal (codeqwen's QKV biases, granite's tied head and its scales,
    the encoders' LayerNorm betas), every tensor contiguous."""
    jc, tc, tq, tp = model["jc"], model["tc"], model["tq"], model["tp"]
    assert t_plans.build_layer_plans(tc) == plan_from_reference(
        j_plans.build_layer_plans(jc))
    tparams = jax.tree.map(lambda a: torch.as_tensor(np.array(a)),
                           model["params"])
    got_q, got_p = t_convert.quantize_params(tparams, tc)
    assert got_p == tp
    _same_tree(got_q, tq)
    attn = got_q["layers"][0]["attn"]
    assert (attn["wq"].bias32 is not None) == (
        model["arch"] == "codeqwen1.5-7b")
    if model["arch"] == "granite-3-2b":
        assert tuple(got_q["head"].w8.shape) == (tc.d_model, 49168)
        assert got_q["head"].w8.is_contiguous()


@pytest.mark.parametrize("j_ops", ["ref", "pallas_fused"])
@pytest.mark.parametrize("model", list(REDUCE), indirect=True)
def test_int_prefill_matches_reference(model, j_ops):
    """Last-position logits: the port's twin of ``j_ops`` and
    ``torch_ref`` equal JAX ``int_prefill`` under ``j_ops``; an encoder
    also through ``make_prefill_step``."""
    jc, tc = model["jc"], model["tc"]
    b, s = SHAPE[model["arch"]]
    toks = np.random.default_rng(s).integers(0, jc.vocab, (b, s)
                                             ).astype(np.int32)
    want = np.asarray(jit_.int_prefill(model["jq"],
                                       {"tokens": jnp.asarray(toks)},
                                       model["jp"], jc, ops=j_ops))
    assert want.shape == (b, tc.padded_vocab())
    for backend in (j_ops, "torch_ref"):
        got = tit.int_prefill(model["tq"], {"tokens": T(toks)}, model["tp"],
                              tc, ops=backend)
        assert np.array_equal(got.numpy(), want), backend
    if not tc.is_causal:
        step = make_prefill_step(tc, model["tp"], ops=j_ops, device="cpu")
        assert np.array_equal(step(model["tq"], {"tokens": toks}).numpy(),
                              want)


def _streams(eng, Request, prompts, max_new):
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    return [r.out_tokens for r in reqs]


@pytest.mark.parametrize("model", list(DECODERS), indirect=True)
def test_engine_streams_match_reference(model):
    """Paged, chunked prefill of 8, wo folded where the backend folds: the
    port's engine on ``cuda`` and ``torch_ref`` gives the JAX engine's
    streams."""
    jc, tc = model["jc"], model["tc"]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, jc.vocab, n).tolist() for n in (5, 19, 12)]
    kw = dict(batch_size=2, cache_len=64, prefill_chunk=8)
    want = _streams(JEngine(model["jq"], model["jp"], jc, ops="ref", **kw),
                    JRequest, prompts, 6)
    assert len({t for s in want for t in s}) > 1
    for backend in ("cuda", "torch_ref"):
        got = _streams(TEngine(model["tq"], model["tp"], tc, ops=backend,
                               device="cpu", **kw), TRequest, prompts, 6)
        assert got == want, backend


@pytest.mark.parametrize("model", list(DECODERS), indirect=True)
def test_make_decode_step_matches_reference(model):
    """Prefill contiguous caches, then three decode steps through each
    package's ``make_decode_step``: logits and caches equal."""
    jc, tc = model["jc"], model["tc"]
    cache_len, b, s = 24, 2, 10
    toks = np.random.default_rng(6).integers(1, jc.vocab, (b, s)
                                             ).astype(np.int32)
    _, jcache = jit_.int_prefill(model["jq"], {"tokens": jnp.asarray(toks)},
                                 model["jp"], jc, ops="ref",
                                 return_cache=True, cache_len=cache_len)
    _, tcache = tit.int_prefill(model["tq"], {"tokens": T(toks)},
                                model["tp"], tc, ops="cuda",
                                return_cache=True, cache_len=cache_len)
    jstep = j_make_decode_step(jc, model["jp"], cache_len, ops="ref")
    tstep = make_decode_step(tc, model["tp"], cache_len, ops="cuda",
                             device="cpu")
    jrope = jil.build_rope_table(cache_len + 1, jc.hd, jc.rope_theta)
    trope = til.build_rope_table(cache_len + 1, tc.hd, tc.rope_theta,
                                 device="cpu")
    pos = np.full((b,), s, np.int32)
    for t in range(3):
        jlog, jcache = jstep(model["jq"], jcache, jnp.asarray(toks[:, t]),
                             jnp.asarray(pos), jrope)
        tlog, tcache = tstep(model["tq"], tcache, toks[:, t], pos, trope)
        assert np.array_equal(tlog.numpy(), np.asarray(jlog)), t
        for tcc, jcc in zip(tcache, jcache):
            for key in ("k8", "v8"):
                assert np.array_equal(tcc[key].numpy(), np.asarray(jcc[key]))
        pos = pos + 1


# ---------------------------------------------------- derived fields -----

@pytest.mark.parametrize("arch", sorted(j_registry.ARCHS))
def test_derived_fields_match_reference(arch):
    jc = j_registry.get_config(arch)
    tc = t_common.ArchConfig(**dataclasses.asdict(jc))
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert [tc.layer_param_count(i) for i in range(tc.num_layers)] == \
        [jc.layer_param_count(i) for i in range(jc.num_layers)]
    assert [tc.layer_param_count(i, cross=True) for i in range(2)] == \
        [jc.layer_param_count(i, cross=True) for i in range(2)]
    assert [(tc._layer_kind(i), tc._is_moe_layer(i))
            for i in range(tc.num_layers)] == \
        [(jc._layer_kind(i), jc._is_moe_layer(i))
         for i in range(jc.num_layers)]
    assert (tc.padded_experts(), tc.ssm_d_inner, tc.ssm_heads,
            tc.padded_vocab(), tc.hd, tc.q_group, tc.is_causal) == \
        (jc.padded_experts(), jc.ssm_d_inner, jc.ssm_heads,
         jc.padded_vocab(), jc.hd, jc.q_group, jc.is_causal)
    if arch in t_registry.ARCHS:
        assert dataclasses.asdict(t_registry.get_config(arch)) == \
            dataclasses.asdict(jc)


def test_shapes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in t_common.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in j_common.SHAPES.items()}
    assert [v.is_serve for v in t_common.SHAPES.values()] == \
        [v.is_serve for v in j_common.SHAPES.values()]
