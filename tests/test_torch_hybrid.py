"""The attention / Mamba hybrid in the port == the JAX package, bit for
bit: reduced jamba-v0.1-52b (2 groups of 8 sublayers = 16 layers; d 128,
GQA 4 / 2 with head dim 32 and no RoPE at position 4, Mamba elsewhere
(d_inner 256, 16 heads of 16, state 16), 8 experts top-2 on the odd
positions, a dense SwiGLU FFN on the even ones).

  * ``quantize_params`` with the positions made to differ: the plans'
    ``s_dtw`` / ``s_conv`` and ``s_router`` are group 0's of the *last*
    Mamba and the *last* MoE position (7 for both: the reference's probe
    writes one shared dict, position after position), while each
    position's Δt projection, conv, ``dt_bias`` and router are quantized
    at the maximum over that position's two groups; the rules the port
    could have taken instead (position 0's probe, group 0's scale) give
    other plans or integers;
  * ``int_prefill`` under the twins of ``ref`` and ``pallas_fused`` (JAX
    runs its Pallas kernels in interpret mode) and ``torch_ref``;
  * ``int_decode_step`` through ``make_decode_step`` over contiguous
    caches (K/V at position 4, the Mamba state elsewhere) against JAX's,
    and the prefill's last logits == the streamed decode's;
  * ``ServingEngine`` streams against the JAX engine in both cache modes
    with more requests than lanes, and the refusals (``preempt``,
    ``spec_k > 0``, chunked prefill); the serve CLI with ``--arch
    jamba-v0.1-52b``.

Inputs are numpy draws from fixed seeds.  Tolerance: 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import registry as j_registry
from repro.models import inttransformer as jit_
from repro.models import model as JM
from repro.quant import convert as j_convert
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import registry as t_registry
from repro_torch.interop import from_reference
from repro_torch.models import inttransformer as tit
from repro_torch.models import model as TM
from repro_torch.models import transformer as ttf
from repro_torch.quant import convert as t_convert
from repro_torch.quant import plans as t_plans
from repro_torch.serving import Request as TRequest
from repro_torch.serving import ServingEngine as TEngine
from repro_torch.serving.speculate import SpeculationUnsupported

T = torch.as_tensor
ARCH = "jamba-v0.1-52b"
# the positions the scaling marks: the last Mamba / MoE position (the
# probe's), a Mamba and an MoE position whose group 1 sets the stack scale
LAST, SSM_POS, MOE_POS = 7, 0, 1


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


def _float_params(tc, seed=0):
    """Float params in the reference layout as numpy arrays (the port's
    seeded draws), the embedding at unit std; position 7's group 0 Δt
    columns, conv and router twice their draw; position 0's group 1 Δt
    columns and position 1's group 1 router three times theirs."""
    params = _numpy(ttf.init_params(tc, seed=seed, device="cpu"))
    params["embed"] *= np.float32(tc.padded_vocab() ** 0.5)
    layers, dt = params["layers"], slice(-tc.ssm_heads, None)
    layers[LAST]["ssm"]["in_proj"][0, :, dt] *= 2.0
    layers[LAST]["ssm"]["conv_w"][0] *= 2.0
    layers[LAST]["moe"]["router"][0] *= 2.0
    layers[SSM_POS]["ssm"]["in_proj"][1, :, dt] *= 3.0
    layers[MOE_POS]["moe"]["router"][1] *= 3.0
    return params


_MODEL = {}


def _model():
    if not _MODEL:
        over = dict(dtype="float32")
        jc = JM.reduce_config(j_registry.get_config(ARCH), **over)
        tc = TM.reduce_config(t_registry.get_config(ARCH), **over)
        params = _float_params(tc)
        jq, jp = j_convert.quantize_params(params, jc)
        tq, tp = from_reference(jax.tree.map(np.array, jq), jp,
                                device="cpu")
        _MODEL.update(jc=jc, tc=tc, params=params, jq=jq, jp=jp, tq=tq,
                      tp=tp)
    return _MODEL


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


def _scale(a, g=None) -> float:
    a = np.asarray(a, np.float64)
    return float(np.abs(a if g is None else a[g]).max()) / 127.0


def test_layer_kinds():
    tc = _model()["tc"]
    gl, ng, kinds = tit.layer_group_spec(tc)
    assert (gl, ng) == (8, 2)
    assert [k[0] for k in kinds] == ["ssm"] * 4 + ["attn"] + ["ssm"] * 3
    assert [k[1] for k in kinds] == ["ffn", "moe"] * 4


def test_quantize_params_positional_probe():
    m = _model()
    jc, tc, tq, tp, params = m["jc"], m["tc"], m["tq"], m["tp"], m["params"]
    got_q, got_p = t_convert.quantize_params(jax.tree.map(T, params), tc)
    assert got_p == tp
    _same_tree(got_q, tq)
    layers = params["layers"]

    def dt(j):
        return np.asarray(layers[j]["ssm"]["in_proj"])[..., -jc.ssm_heads:]

    # the plans: group 0 of the last Mamba / MoE position
    probe = {"s_emb": _scale(params["embed"]), "s_dtw": _scale(dt(LAST), 0),
             "s_conv": _scale(layers[LAST]["ssm"]["conv_w"], 0),
             "s_router": _scale(layers[LAST]["moe"]["router"], 0)}
    assert t_plans.build_layer_plans(tc, probe) == tp
    first = {**probe, "s_dtw": _scale(dt(SSM_POS), 0),
             "s_conv": _scale(layers[SSM_POS]["ssm"]["conv_w"], 0),
             "s_router": _scale(layers[MOE_POS]["moe"]["router"], 0)}
    wrong = t_plans.build_layer_plans(tc, first)
    assert wrong.mamba.dn_dt_in != tp.mamba.dn_dt_in
    assert wrong.mamba.dn_conv != tp.mamba.dn_conv
    assert wrong.moe.gate_sm != tp.moe.gate_sm
    # each position's stack: group 1 carries position 0's Δt and position
    # 1's router maximum
    q0 = got_q["layers"][SSM_POS]["ssm"]
    assert int(q0["dt_proj"].w8[1].abs().max()) == 127
    assert int(q0["dt_proj"].w8[0].abs().max()) < 64
    want_bias = np.round(np.asarray(layers[SSM_POS]["ssm"]["dt_bias"],
                                    np.float64)
                         / (jc.s_act8 * _scale(dt(SSM_POS)))).astype(np.int32)
    assert np.array_equal(q0["dt_bias_q"].numpy(), want_bias)
    r1 = got_q["layers"][MOE_POS]["moe"]["router"].w8
    assert int(r1[1].abs().max()) == 127 and int(r1[0].abs().max()) < 64


@pytest.mark.parametrize("ops", ["ref", "pallas_fused"])
def test_int_prefill_matches_reference(ops):
    """JAX under ``ops`` (``pallas_fused``: K1, K2 and K5 in interpret
    mode) against the port's twin of that name and ``torch_ref``."""
    m = _model()
    toks = np.random.default_rng(5).integers(0, m["jc"].vocab, (2, 10))
    want = np.asarray(jit_.int_prefill(m["jq"], {"tokens": jnp.asarray(
        toks)}, m["jp"], m["jc"], ops=ops))
    for backend in (ops, "torch_ref"):
        got = tit.int_prefill(m["tq"], {"tokens": T(toks)}, m["tp"],
                              m["tc"], ops=backend)
        assert np.array_equal(got.numpy(), want), backend
    assert len(np.unique(want.argmax(-1))) > 1


#: the engine geometry; the decode-stream test runs the JAX contiguous
#: engine's own jitted step (``_shared_decode_step``, cached by geometry),
#: so the engine test reuses that compilation
GEOM = dict(batch_size=2, cache_len=24, page_size=8)


def test_decode_stream_matches_reference_and_prefill():
    """Eight tokens a lane through ``make_decode_step`` (contiguous K/V at
    position 4, the Mamba state at the others; no RoPE table) == JAX's
    ``int_decode_step``, logits every step and every cache leaf at the
    end; the last logits == ``int_prefill``'s at a capacity where no
    prefill group drops a token (decode routes one token a group and
    never drops)."""
    import dataclasses
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    m = _model()
    jc, tc = m["jc"], m["tc"]
    b, s, L = GEOM["batch_size"], 8, GEOM["cache_len"]
    toks = np.random.default_rng(6).integers(0, jc.vocab, (b, s))
    jcache = jit_.init_decode_cache(jc, b, L)
    tcache = tit.init_decode_cache(tc, device="cpu", batch=b, cache_len=L)
    assert set(tcache[4]) == {"k8", "v8"} and set(tcache[0]) == {"h",
                                                                   "conv"}
    jstep = JEngine(m["jq"], m["jp"], jc, ops="ref", cache_mode="contiguous",
                    **GEOM)._shared_decode_step()
    tstep = make_decode_step(tc, m["tp"], L, ops="cuda", device="cpu")
    for t in range(s):
        pos = np.full((b,), t, np.int32)
        want, jcache = jstep(m["jq"], jcache, jnp.asarray(toks[:, t]),
                             jnp.asarray(pos))
        got, tcache = tstep(m["tq"], tcache, toks[:, t], pos)
        assert np.array_equal(got.numpy(), np.asarray(want)), t
    for j, (jc_, tc_) in enumerate(zip(jcache, tcache)):
        assert set(jc_) == set(tc_), j
        for key in tc_:
            assert np.array_equal(tc_[key].numpy(), np.asarray(jc_[key])), \
                (j, key)
    roomy = dataclasses.replace(tc, capacity_factor=8.0)
    pre = make_prefill_step(roomy, m["tp"], ops="cuda", device="cpu")(
        m["tq"], {"tokens": toks})
    assert torch.equal(pre, got)


def _streams(eng, Request, prompts, max_new):
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done for r in reqs)
    return [list(r.out_tokens) for r in reqs]


@pytest.mark.parametrize("cache_mode", ["paged", "contiguous"])
def test_engine_streams_match_reference(cache_mode):
    """Four prompts on two lanes (every lane recycled): the port's streams
    on ``cuda`` and ``torch_ref`` equal the JAX engine's, token-streaming
    prefill, no prefix index; the engine has no RoPE table (``pos`` is
    "none")."""
    m = _model()
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, m["jc"].vocab, int(k)).tolist()
               for k in (4, 7, 3, 6)]
    geom = dict(GEOM, cache_mode=cache_mode)
    want = _streams(JEngine(m["jq"], m["jp"], m["jc"], ops="ref", **geom),
                    JRequest, prompts, 4)
    assert len({t for s in want for t in s}) > 2
    for backend in ("cuda", "torch_ref"):
        eng = TEngine(m["tq"], m["tp"], m["tc"], ops=backend, device="cpu",
                      **geom)
        assert eng.rope_tab is None
        assert eng.describe()["prefill"]["mode"] == "streaming"
        assert _streams(eng, TRequest, prompts, 4) == want, backend


def test_refusals_and_serve_cli(capsys):
    m = _model()
    eng = TEngine(m["tq"], m["tp"], m["tc"], batch_size=2, cache_len=24,
                  device="cpu")
    sess = eng.submit(TRequest(uid=0, prompt=[1, 2, 3], max_new_tokens=3))
    eng.step()
    with pytest.raises(ValueError, match="lane-indexed"):
        eng.preempt(sess)
    with pytest.raises(SpeculationUnsupported, match="SSM"):
        TEngine(m["tq"], m["tp"], m["tc"], batch_size=2, cache_len=24,
                spec_k=3, device="cpu")
    with pytest.raises(ValueError, match="Mamba"):
        TEngine(m["tq"], m["tp"], m["tc"], batch_size=2, cache_len=24,
                prefill_chunk=8, device="cpu")
    with pytest.raises(ValueError, match="speculative verify"):
        tit.int_verify_step(m["tq"], [], T(np.zeros((2, 2), np.int32)),
                            T(np.zeros(2, np.int32)),
                            T(np.ones(2, np.int32)), m["tp"], m["tc"])
    from repro_torch.launch import serve
    reqs = serve.main(["--arch", ARCH, "--reduced", "--requests", "3",
                       "--max-new", "3", "--batch", "2", "--cache-len",
                       "24", "--device", "cpu", "--cache-mode",
                       "contiguous"])
    assert len(reqs) == 3 and all(len(r.out_tokens) == 3 for r in reqs)
    with pytest.raises(SystemExit):
        serve.main(["--arch", ARCH, "--reduced", "--spec-k", "3",
                    "--device", "cpu"])
    assert "SSM" in capsys.readouterr().err
