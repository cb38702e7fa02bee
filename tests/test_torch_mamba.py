"""Integer Mamba-2 in the port == the JAX package, bit for bit: reduced
mamba2-130m (2 layers, d 128, d_inner 256, 16 heads of 16, state 16),
attention-free, and the two SSM configs' fields.

  * the configs' fields (full and reduced) and ``MambaPlan`` field for
    field, for both SSM configs, at nominal and at measured scales;
  * ``quantize_params`` on the same float draws with group 1's Δt columns
    and conv scaled up: the plans take group 0's scales (the reference's
    probe, ``t[:1]``), the Δt projection, the conv and ``dt_bias`` the
    whole stack's; ``init_quantized`` == ``quantize_params`` of the same
    draws;
  * ``int_mamba_step`` and ``int_mamba_prefill`` with a carried-in state
    (the output, ``h`` and the conv tail equal JAX's), including a state
    past ±``qmax_h`` that the update's clip saturates and heads whose Δt
    sits at i-softplus's clip; the prefill equals the same tokens
    stepped;
  * ``int_prefill`` under the twins of ``ref`` and ``pallas_fused`` (JAX
    runs its Pallas kernels in interpret mode) and ``torch_ref``;
    ``int_decode_step`` over the lane-indexed state against JAX's, and
    the prefill's last logits == the streamed decode's;
  * ``ServingEngine`` streams against the JAX engine in both cache modes
    with more requests than lanes (recycled lanes start from a zeroed
    state), and the refusals: ``preempt``, ``spec_k > 0`` (engine and
    serve CLI), chunked prefill; the serve CLI with ``--arch mamba2-130m``.

Inputs are numpy draws from fixed seeds.  Tolerance: 0.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import registry as j_registry
from repro.core.dyadic import fit_dyadic as j_fit_dyadic
from repro.models import intlayers as jil
from repro.models import inttransformer as jit_
from repro.models import model as JM
from repro.quant import convert as j_convert
from repro.quant import plans as j_plans
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import registry as t_registry
from repro_torch.interop import from_reference, plan_from_reference
from repro_torch.models import intlayers as til
from repro_torch.models import inttransformer as tit
from repro_torch.models import model as TM
from repro_torch.models import transformer as ttf
from repro_torch.quant import convert as t_convert
from repro_torch.quant import plans as t_plans
from repro_torch.serving import Request as TRequest
from repro_torch.serving import ServingEngine as TEngine
from repro_torch.serving.speculate import SpeculationUnsupported

T = torch.as_tensor
ARCH = "mamba2-130m"
SSM_ARCHS = ("mamba2-130m", "jamba-v0.1-52b")


def _cfgs(arch=ARCH, **over):
    over = dict(dtype="float32", **over)
    return (JM.reduce_config(j_registry.get_config(arch), **over),
            TM.reduce_config(t_registry.get_config(arch), **over))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


def _float_params(tc, seed=0):
    """Float params in the reference layout as numpy arrays (the port's
    seeded draws), the embedding at unit std (as ``launch/serve.py``
    draws it), group 1's Δt columns three times and its conv twice group 0's
    scale."""
    params = _numpy(ttf.init_params(tc, seed=seed, device="cpu"))
    params["embed"] *= np.float32(tc.padded_vocab() ** 0.5)
    ssm = params["layers"][0]["ssm"]
    ssm["in_proj"][1, :, -tc.ssm_heads:] *= 3.0
    ssm["conv_w"][1] *= 2.0
    return params


_MODEL = {}


def _model():
    if not _MODEL:
        jc, tc = _cfgs()
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


# ------------------------------------------------- configs and plans -----

@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_config_fields_and_mamba_plan_match_reference(arch):
    """Fields at full size and reduced, the derived SSM widths, and
    ``MambaPlan`` field for field (nominal scales, then measured ones)."""
    jfull, tfull = j_registry.get_config(arch), t_registry.get_config(arch)
    assert dataclasses.asdict(jfull) == dataclasses.asdict(tfull)
    jc, tc = _cfgs(arch)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (tfull.ssm_d_inner, tfull.ssm_heads) == (
        jfull.ssm_d_inner, jfull.ssm_heads)
    calib = {"s_emb": 0.011, "s_dtw": 0.0037, "s_conv": 0.029,
             "s_router": 0.013}
    for c in (None, calib):
        want = plan_from_reference(j_plans.build_layer_plans(jc, c))
        got = t_plans.build_layer_plans(tc, c)
        assert got == want
        for field in t_plans.MambaPlan._fields:
            assert getattr(got.mamba, field) == getattr(want.mamba, field), \
                field
    assert (got.attn is None) == (arch == ARCH)
    assert got.ffn is None if arch == ARCH else got.ffn is not None


def test_quantize_params_probe_and_stack_scales():
    """The port's converter on the floats JAX quantized: plans and every
    integer equal.  The plans' Δt and conv requants take group 0's scales (the
    probe); group 1's Δt projection and conv are quantized at the stack's
    maximum (three and two times group 0's), and so is ``dt_bias``."""
    m = _model()
    jc, tc, tq, tp = m["jc"], m["tc"], m["tq"], m["tp"]
    got_q, got_p = t_convert.quantize_params(
        jax.tree.map(T, m["params"]), tc)
    assert got_p == tp
    _same_tree(got_q, tq)
    ssm = m["params"]["layers"][0]["ssm"]
    wdt = np.asarray(ssm["in_proj"], np.float64)[..., -jc.ssm_heads:]
    s0 = np.abs(wdt[:1]).max() / 127.0
    s_all = np.abs(wdt).max() / 127.0
    assert s_all > 2.5 * s0
    assert tp.mamba.dn_dt_in == plan_from_reference(j_fit_dyadic(
        jc.s_act8 * s0 / tp.mamba.s_dt_in, tp.mamba.in_proj.acc_qmax))
    q = got_q["layers"][0]["ssm"]
    assert int(q["dt_proj"].w8[1].abs().max()) == 127
    assert int(q["dt_proj"].w8[0].abs().max()) < 64
    assert int(q["conv_w8"][1].abs().max()) == 127
    assert int(q["conv_w8"][0].abs().max()) < 80
    want_bias = np.round(np.asarray(ssm["dt_bias"], np.float64)
                         / (jc.s_act8 * s_all)).astype(np.int32)
    assert np.array_equal(q["dt_bias_q"].numpy(), want_bias)
    assert q["A_q"].dtype == q["D_q"].dtype == torch.int32


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_init_quantized_equals_quantize_params(arch):
    """Drawing and quantizing layer by layer (the per-tensor floats kept
    to the last group) equals ``quantize_params`` of the whole float
    model from the same seed."""
    _, tc = _cfgs(arch)
    qa, pa = t_convert.init_quantized(tc, seed=3, device="cpu")
    qb, pb = t_convert.quantize_params(
        ttf.init_params(tc, seed=3, device="cpu"), tc)
    assert pa == pb
    _same_tree(qa, qb)
    assert len(qa["layers"]) == len(ttf.layer_group_spec(tc)[2])


# ------------------------------------------------- step and prefill ------

def test_block_floating_point_helpers_match_reference():
    """The exponents of the state's and the gate's block-floating-point
    shifts: ``int_bit_length`` (one comparison against 2^0 .. 2^30) ==
    the reference's five halving steps at 0, every power of two and its
    neighbours, negatives (0, as the reference gives) and random int32;
    the rounding half ``(1 << sd) >> 1`` == ``where(sd > 0, 1 << (sd - 1),
    0)`` at every exponent 0 .. 30."""
    from repro.core import intmath as j_im
    from repro_torch.core import intmath as t_im
    edges = [0, -1, -5, -(2 ** 31), 2 ** 31 - 1]
    for k in range(31):
        edges += [2 ** k - 1, 2 ** k, min(2 ** k + 1, 2 ** 31 - 1)]
    rng = np.random.default_rng(3)
    a = np.concatenate([np.array(edges, np.int64), rng.integers(
        -(2 ** 31), 2 ** 31, 20000)]).astype(np.int32)
    got = t_im.int_bit_length(T(a))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(),
                          np.asarray(j_im.int_bit_length(jnp.asarray(a))))
    sd = np.arange(31, dtype=np.int32)[:, None]
    x = rng.integers(-(2 ** 30), 2 ** 30, (31, 64)).astype(np.int32)
    half = np.where(sd > 0, np.left_shift(1, np.maximum(sd - 1, 0)), 0)
    want = np.asarray(jax.lax.shift_right_arithmetic(
        jnp.asarray(x + half), jnp.asarray(np.broadcast_to(sd, x.shape))))
    assert np.array_equal(til._round_shift(T(x), T(sd)).numpy(), want)


def _layer(m, g):
    return (jax.tree.map(lambda t: t[g], m["jq"]["layers"][0]["ssm"]),
            tit._layer(m["tq"]["layers"][0]["ssm"], g))


def _state(m, b, case, seed):
    """A carried-in state: ``h`` within ±2^20 and a random conv tail, or
    ``h`` past ±qmax_h by up to 2^28, which the update's clip brings back
    (from a state within the bound, the contributions alone cannot reach
    it: they are ~2^24 / A at the most)."""
    jc, mp = m["jc"], m["tp"].mamba
    rng = np.random.default_rng(seed)
    shape = (b, jc.ssm_heads, jc.ssm_state, jc.ssm_head_dim)
    if case == "saturating":
        h = (rng.integers(0, 2, shape) * 2 - 1) * (
            mp.qmax_h + rng.integers(0, 1 << 28, shape))
    else:
        h = rng.integers(-(1 << 20), 1 << 20, shape)
    conv_ch = jc.ssm_d_inner + 2 * jc.ssm_groups * jc.ssm_state
    conv = rng.integers(-127, 128, (b, jc.ssm_conv - 1, conv_ch))
    return h.astype(np.int32), conv.astype(np.int8)


def _params_for(m, case):
    """Layer 1's params; ``saturating`` moves half the heads' dt_bias far
    past i-softplus's clip (Δt saturates there)."""
    jqp, tqp = _layer(m, 1)
    if case == "saturating":
        bias = np.array(jqp["dt_bias_q"])
        bias[: bias.shape[0] // 2] = 1 << 20
        jqp = {**jqp, "dt_bias_q": jnp.asarray(bias)}
        tqp = {**tqp, "dt_bias_q": T(bias)}
    return jqp, tqp


_JAX_FNS = {}


def _jax_fn(kind, m):
    """JAX's ``int_mamba_step`` / ``int_mamba_prefill`` (``ref``) under
    one ``jax.jit`` each: (params, u8, h, conv) -> (out, state)."""
    if kind not in _JAX_FNS:
        fn = jil.int_mamba_step if kind == "step" else jil.int_mamba_prefill

        def call(qp, u8, h, conv):
            st = jil.IntMambaState(h, conv)
            if kind == "step":
                return fn(qp, u8, st, m["jp"].mamba, m["jc"], ops="ref")
            return fn(qp, u8, m["jp"].mamba, m["jc"], st, ops="ref")
        _JAX_FNS[kind] = jax.jit(call)
    return _JAX_FNS[kind]


def _saturation(m, tqp, u8, h_new):
    """(Δt at its clip anywhere, h at ±qmax_h anywhere)."""
    mp = m["tp"].mamba
    dt_acc = til.int_linear(u8, tqp["dt_proj"], til._INT32_PLAN(mp),
                            "torch_ref")
    dt, _ = til._dt_decay(dt_acc, tqp, mp)
    return bool((dt == 4095).any()), bool(
        (h_new.abs() == mp.qmax_h).any())


@pytest.mark.parametrize("case", ["carried", "saturating"])
def test_int_mamba_step_matches_reference(case):
    m = _model()
    jqp, tqp = _params_for(m, case)
    h, conv = _state(m, 3, case, seed=11)
    u8 = np.random.default_rng(12).integers(
        -127, 128, (3, m["jc"].d_model)).astype(np.int8)
    want, wst = _jax_fn("step", m)(jqp, jnp.asarray(u8), jnp.asarray(h),
                                   jnp.asarray(conv))
    got, st = til.int_mamba_step(tqp, T(u8), til.IntMambaState(T(h),
                                                                T(conv)),
                                 m["tp"].mamba, m["tc"], ops="cuda")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(st.h.numpy(), np.asarray(wst.h))
    assert np.array_equal(st.conv.numpy(), np.asarray(wst.conv))
    assert len(np.unique(np.asarray(want))) > 20
    if case == "saturating":
        assert _saturation(m, tqp, T(u8), st.h) == (True, True)


@pytest.mark.parametrize("case", ["carried", "saturating"])
@pytest.mark.parametrize("length", [1, 9])
def test_int_mamba_prefill_matches_reference_and_steps(length, case):
    """The hoisted prefill from a carried-in state == JAX's (output, h,
    conv tail), and == the same tokens through ``int_mamba_step``."""
    m = _model()
    jqp, tqp = _params_for(m, case)
    h, conv = _state(m, 2, case, seed=21 + length)
    u8 = np.random.default_rng(22).integers(
        -127, 128, (2, length, m["jc"].d_model)).astype(np.int8)
    want, wst = _jax_fn("prefill", m)(jqp, jnp.asarray(u8), jnp.asarray(h),
                                      jnp.asarray(conv))
    got, st = til.int_mamba_prefill(tqp, T(u8), m["tp"].mamba, m["tc"],
                                    til.IntMambaState(T(h), T(conv)),
                                    ops="cuda")
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(st.h.numpy(), np.asarray(wst.h))
    assert np.array_equal(st.conv.numpy(), np.asarray(wst.conv))
    state, outs, clipped = til.IntMambaState(T(h), T(conv)), [], False
    for t in range(length):
        out, state = til.int_mamba_step(tqp, T(u8[:, t]), state,
                                        m["tp"].mamba, m["tc"],
                                        ops="torch_ref")
        outs.append(out)
        clipped |= _saturation(m, tqp, T(u8[:, t]), state.h) == (True, True)
    assert torch.equal(torch.stack(outs, dim=1), got)
    assert torch.equal(state.h, st.h) and torch.equal(state.conv, st.conv)
    assert clipped == (case == "saturating")


# ----------------------------------------------- the model's entry points -

@pytest.mark.parametrize("ops", ["ref", "pallas_fused"])
def test_int_prefill_matches_reference(ops):
    """JAX under ``ops`` (``pallas_fused``: K1 and K2 in interpret mode)
    against the port's twin of that name and ``torch_ref``."""
    m = _model()
    toks = np.random.default_rng(5).integers(0, m["jc"].vocab, (2, 12))
    want = np.asarray(jit_.int_prefill(m["jq"], {"tokens": jnp.asarray(
        toks)}, m["jp"], m["jc"], ops=ops))
    for backend in (ops, "torch_ref"):
        got = tit.int_prefill(m["tq"], {"tokens": T(toks)}, m["tp"],
                              m["tc"], ops=backend)
        assert np.array_equal(got.numpy(), want), backend
    assert len(np.unique(want.argmax(-1))) > 1


def test_decode_stream_matches_reference_and_prefill():
    """Ten tokens a lane through ``make_decode_step`` over the
    lane-indexed state == JAX's ``int_decode_step`` (logits every step,
    ``h`` and ``conv`` at the end); the last logits == ``int_prefill``'s
    (the reference's own check)."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    m = _model()
    jc, tc = m["jc"], m["tc"]
    b, s = 2, 10
    toks = np.random.default_rng(6).integers(0, jc.vocab, (b, s))
    jcache = jit_.init_decode_cache(jc, b, 16)
    tcache = tit.init_decode_cache(tc, device="cpu", batch=b, cache_len=16)
    assert set(tcache[0]) == {"h", "conv"}
    jstep = jax.jit(lambda c, t, p: jit_.int_decode_step(
        m["jq"], c, t, p, m["jp"], jc, None, ops="ref"))
    tstep = make_decode_step(tc, m["tp"], 16, ops="cuda", device="cpu")
    for t in range(s):
        pos = np.full((b,), t, np.int32)
        want, jcache = jstep(jcache, jnp.asarray(toks[:, t]),
                             jnp.asarray(pos))
        got, tcache = tstep(m["tq"], tcache, toks[:, t], pos)
        assert np.array_equal(got.numpy(), np.asarray(want)), t
    for key in ("h", "conv"):
        assert np.array_equal(tcache[0][key].numpy(),
                              np.asarray(jcache[0][key])), key
    pre = make_prefill_step(tc, m["tp"], ops="cuda", device="cpu")(
        m["tq"], {"tokens": toks})
    assert torch.equal(pre, got)


# --------------------------------------------------------------- serving --

def _prompts(seed, n, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, int(k)).tolist()
            for k in rng.integers(3, 10, n)]


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
    """Five prompts on two lanes (every lane recycled, its state zeroed at
    admission; an idle lane steps token 0, as the reference's does): the
    port's streams on ``cuda`` and ``torch_ref`` equal the JAX engine's;
    the engine streams its prompts and keeps no prefix index."""
    m = _model()
    prompts = _prompts(8, 5, m["jc"].vocab)
    geom = dict(batch_size=2, cache_len=32, page_size=8,
                cache_mode=cache_mode)
    want = _streams(JEngine(m["jq"], m["jp"], m["jc"], ops="ref", **geom),
                    JRequest, prompts, 5)
    assert len({t for s in want for t in s}) > 2
    for backend in ("cuda", "torch_ref"):
        eng = TEngine(m["tq"], m["tp"], m["tc"], ops=backend, device="cpu",
                      **geom)
        d = eng.describe()
        assert d["prefill"]["mode"] == "streaming"
        assert d["cache"].get("prefix") is None
        assert _streams(eng, TRequest, prompts, 5) == want, backend


def test_engine_refusals():
    """``preempt`` (the state is lane-indexed), ``spec_k > 0`` (a rejected
    draft cannot roll the state back) and chunked prefill, each with the
    reference's reason."""
    m = _model()
    eng = TEngine(m["tq"], m["tp"], m["tc"], batch_size=2, cache_len=32,
                  device="cpu")
    sess = eng.submit(TRequest(uid=0, prompt=[1, 2, 3], max_new_tokens=4))
    eng.step()
    with pytest.raises(ValueError, match="lane-indexed"):
        eng.preempt(sess)
    with pytest.raises(SpeculationUnsupported, match="SSM"):
        TEngine(m["tq"], m["tp"], m["tc"], batch_size=2, cache_len=32,
                spec_k=2, device="cpu")
    with pytest.raises(ValueError, match="Mamba"):
        TEngine(m["tq"], m["tp"], m["tc"], batch_size=2, cache_len=32,
                prefill_chunk=8, device="cpu")
    assert not tit.chunked_prefill_supported(m["tc"])
    assert not tit.speculative_decode_supported(m["tc"])


def test_serve_cli_runs_mamba2_on_the_cpu(capsys):
    from repro_torch.launch import serve
    reqs = serve.main(["--arch", ARCH, "--reduced", "--requests", "3",
                       "--max-new", "3", "--batch", "2", "--cache-len",
                       "32", "--device", "cpu"])
    assert len(reqs) == 3 and all(len(r.out_tokens) == 3 for r in reqs)
    with pytest.raises(SystemExit):
        serve.main(["--arch", ARCH, "--reduced", "--spec-k", "2",
                    "--device", "cpu"])
    assert "SSM" in capsys.readouterr().err
