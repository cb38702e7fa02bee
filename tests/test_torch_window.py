"""The sliding-window slice and the contiguous KV cache == the JAX package,
bit for bit.

Reduced h2o-danube-3-4b (window 64, head dim 32; one configuration at the
arch's own head dim 120), quantized by the JAX package and carried across
with ``repro_torch.interop``:

  * K3 over a contiguous cache: the plain version against the Pallas
    kernel in interpret mode, D 32 and 120, Sq 1 and 8, valid_len 0 / 1 /
    L, folded wo; K5 at D = 120 against its Pallas kernel, causal and
    windowed;
  * ``int_decode_step`` over a contiguous cache and over paged pools,
    through the rolling window's wrap: logits and caches after every
    step; ``int_prefill(return_cache=True)`` and
    ``launch.steps.make_decode_step``;
  * ``ServingEngine``: token streams equal to the JAX engine's in both
    cache modes past the wrap (the schedule of
    ``tests/test_paged_decode.py``'s wrap test).

The ``cuda`` backend runs its kernels' plain versions here (CPU tensors);
its dispatch — contiguous caches, paged pools, folded wo — is the code
under test.  Tolerance: 0.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as j_get_config
from repro.core import attention as j_attn
from repro.kernels.int_attention_fused import int_attention_fused as j_k5
from repro.kernels.int_decode_attention import int_decode_attention_fused
from repro.launch.steps import make_decode_step as j_make_decode_step
from repro.models import intlayers as jil
from repro.models import inttransformer as jit_
from repro.models import model as JM
from repro.models import transformer as jtf
from repro.ops import RequantSpec as JSpec
from repro.quant import convert as j_convert
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving.kvcache import CacheLayout as JLayout
from repro_torch import kernels
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.interop import from_reference, plan_from_reference
from repro_torch.kernels.int_attention_fused import (
    int_attention_fused, int_attention_fused_plain)
from repro_torch.kernels.int_decode_attention import (
    int_decode_attention_fused as t_decode, int_decode_attention_plain)
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import intlayers as til
from repro_torch.models import inttransformer as tit
from repro_torch.models import model as TM
from repro_torch.ops import resolve_ops
from repro_torch.ops.spec import QuantLinearParams
from repro_torch.ops.spec import RequantSpec as TSpec
from repro_torch.serving import Request as TRequest
from repro_torch.serving import ServingEngine as TEngine
from repro_torch.serving.kvcache import CacheLayout as TLayout

T = torch.as_tensor
BACKENDS = ("torch_ref", "cuda")
ARCH = "h2o-danube-3-4b"


def _i8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _quantized(**over):
    """Reduced h2o-danube-3-4b in both packages (``over`` on top of
    ``reduce_config``), the JAX package's quantization carried across."""
    over = {"dtype": "float32", **over}
    jcfg = JM.reduce_config(j_get_config(ARCH), **over)
    tcfg = TM.reduce_config(t_get_config(ARCH), **over)
    params = jtf.init_params(jax.random.key(0), jcfg)
    jq, jp = j_convert.quantize_params(params, jcfg)
    tq, tp = from_reference(jax.tree.map(np.array, jq), jp, device="cpu")
    return jcfg, tcfg, jq, jp, tq, tp


@pytest.fixture(scope="module")
def setup():
    return _quantized()


@pytest.fixture(scope="module")
def setup120():
    return _quantized(head_dim=120)


def test_config_matches_reference():
    """The port's own copy of the config is the reference's, field by
    field, and the serve driver offers it (as its default)."""
    from repro_torch.launch.serve import build_parser
    jc, tc = j_get_config(ARCH), t_get_config(ARCH)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert (tc.hd, tc.window, tc.n_heads, tc.n_kv_heads) == (120, 4096, 32, 8)
    assert build_parser().parse_args([]).arch == ARCH


# ------------------------------------------------ K3 contiguous, K5 D=120 --

def _wo(rng, h, d, n_out):
    """One folded o-projection in both packages' forms."""
    w = _i8(rng, (h * d, n_out))
    bias = rng.integers(-500, 500, (n_out,)).astype(np.int32)
    bv = rng.integers(1000, 30000, (n_out,)).astype(np.int32)
    jw = dict(wo_w8=jnp.asarray(w), wo_bias32=jnp.asarray(bias),
              wo_b_vec=jnp.asarray(bv),
              wo_spec=JSpec.per_channel(c=28, pre=7, out_bits=14))
    tw = dict(wo=QuantLinearParams(T(w), T(bv), T(bias)),
              wo_spec=TSpec.per_channel(c=28, pre=7, out_bits=14))
    return jw, tw


@pytest.mark.parametrize("d", [32, 120])
@pytest.mark.parametrize("sq", [1, 8])
@pytest.mark.parametrize("fold", [False, True])
def test_k3_contiguous_plain_matches_pallas(d, sq, fold):
    """Lanes at valid_len 0, 1 and L (and one between), GQA 4 / 2."""
    rng = np.random.default_rng(d + sq + fold)
    b, L, h, hkv = 4, 48, 4, 2
    jplan = j_attn.make_iattention(d, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    tplan = plan_from_reference(jplan)
    q8, k8, v8 = (_i8(rng, (b, sq, h, d)), _i8(rng, (b, L, hkv, d)),
                  _i8(rng, (b, L, hkv, d)))
    vl = np.array([0, 1, 29, L], np.int32)
    jw, tw = _wo(rng, h, d, 40) if fold else ({}, {})
    want = int_decode_attention_fused(
        jnp.asarray(q8), jnp.asarray(k8), jnp.asarray(v8), jplan,
        jnp.asarray(vl), requant=JSpec.per_tensor(jplan.dn_out), bkv=16,
        interpret=True, **jw)
    args = (T(q8), T(k8), T(v8), tplan, T(vl))
    got = int_decode_attention_plain(*args, **tw)
    assert np.array_equal(got.numpy(), np.asarray(want))
    kernels.reset_launches()
    ops_kw = dict(tw, requant=TSpec.per_tensor(tplan.dn_out))
    for out in (t_decode(*args, **tw),
                resolve_ops("cuda").int_decode_attention(*args, **ops_kw),
                resolve_ops("torch_ref").int_decode_attention(*args,
                                                              **ops_kw)):
        assert torch.equal(out, got)
    assert kernels.LAUNCHES["int_decode_attention"] == 0    # CPU: no launch


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8), (True, 48),
                                           (False, 0)])
def test_k5_head_dim_120_plain_matches_pallas(causal, window):
    rng = np.random.default_rng(120 + window)
    b, s, h, hkv, d = 2, 32, 4, 2, 120
    jplan = j_attn.make_iattention(d, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    tplan = plan_from_reference(jplan)
    q8, k8, v8 = (_i8(rng, (b, s, h, d)), _i8(rng, (b, s, hkv, d)),
                  _i8(rng, (b, s, hkv, d)))
    want = j_k5(jnp.asarray(q8), jnp.asarray(k8), jnp.asarray(v8), jplan,
                causal=causal, window=window, bq=16, bkv=16, interpret=True)
    got = int_attention_fused_plain(T(q8), T(k8), T(v8), tplan,
                                    causal=causal, window=window)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(int_attention_fused(T(q8), T(k8), T(v8), tplan,
                                           causal=causal, window=window),
                       got)


def test_head_dims_per_kernel_and_their_refusal():
    """The head dims each kernel takes, and the refusal that names the
    ROADMAP item of the rest."""
    from repro_torch.kernels.int_attention_fused import (HEAD_DIMS,
                                                         require_head_dim)
    for kernel in ("int_decode_attention", "int_attention_fused",
                   "int_paged_prefill", "int_attention_online"):
        assert 120 in HEAD_DIMS[kernel]
        require_head_dim(kernel, 120)
        with pytest.raises(ValueError, match="ROADMAP §2 item 4"):
            require_head_dim(kernel, 96)


# ------------------------------------------------------------ step level --

def _caches_equal(tcaches, jcaches, paged):
    """Contiguous caches identical; paged pools identical from page 1 on
    (the null page 0 absorbs the discarded writes of idle lanes)."""
    for tc, jc in zip(tcaches, jcaches):
        for key in ("k8", "v8"):
            t, j = tc[key].numpy(), np.asarray(jc[key])
            if paged:
                t, j = t[:, 1:], j[:, 1:]
            assert np.array_equal(t, j), key


#: lanes at positions 0, 30 and 59 of a 64-position window (cache_len 80)
DECODE_POS, DECODE_LANES = (0, 30, 59), 3
DECODE_CACHE_LEN, DECODE_PAGE = 80, 16

#: the JAX package's logits and caches after every step of
#: :func:`_decode_steps`, by (setup, layout, fold_wo, steps): computed once
#: and held against each backend of the port
_JAX_STEPS = {}


def _decode_inputs(steps, vocab):
    """The tokens of every step (seeded) and the lanes' first positions."""
    rng = np.random.default_rng(3)
    return ([rng.integers(1, vocab, (DECODE_LANES,)).astype(np.int32)
             for _ in range(steps)], np.array(DECODE_POS, np.int32))


def _decode_layout(cfg, layout):
    L = min(DECODE_CACHE_LEN, cfg.window)
    if layout != "paged":
        return L, None
    pages = np.arange(1, 1 + DECODE_LANES * (L // DECODE_PAGE),
                      dtype=np.int32).reshape(DECODE_LANES, -1)
    return L, pages


def _jax_decode_steps(setup, layout, fold_wo, steps):
    """JAX ``int_decode_step`` under ``ref`` through the steps, one jitted
    step (the same function the eager call runs, compiled once)."""
    key = (id(setup), layout, fold_wo, steps)
    if key in _JAX_STEPS:
        return _JAX_STEPS[key]
    jcfg, _, jq, jp = setup[:4]
    b, cache_len = DECODE_LANES, DECODE_CACHE_LEN
    L, pages = _decode_layout(jcfg, layout)
    if layout == "paged":
        jl = JLayout.fit(b, L, DECODE_PAGE)
        jc = jit_.init_decode_cache(jcfg, b, cache_len, layout=jl)
        kw = dict(page_size=DECODE_PAGE, max_len=L)
    else:
        jc = jit_.init_decode_cache(jcfg, b, cache_len)
        kw = {}
    jrope = jil.build_rope_table(cache_len + 1, jcfg.hd, jcfg.rope_theta)

    @jax.jit
    def step(q, caches, toks, pos, rope, pages):
        return jit_.int_decode_step(q, caches, toks, pos, jp, jcfg, rope,
                                    ops="ref", pages=pages, fold_wo=fold_wo,
                                    **kw)

    toks_all, pos = _decode_inputs(steps, jcfg.vocab)
    jpages = None if pages is None else jnp.asarray(pages)
    out = []
    for toks in toks_all:
        jlog, jc = step(jq, jc, jnp.asarray(toks), jnp.asarray(pos), jrope,
                        jpages)
        out.append((np.asarray(jlog), jax.tree.map(np.asarray, jc)))
        pos = pos + 1
    _JAX_STEPS[key] = out
    return out


def _decode_steps(setup, layout, backend, fold_wo, steps=8):
    """Lanes at positions 0, 30 and 59 of a 64-position window (cache_len
    80): lane 2 wraps on its sixth step (slot = pos % 64 returns to 0).
    Logits and caches after every step equal JAX's."""
    _, tcfg, _, _, tq, tp = setup
    want = _jax_decode_steps(setup, layout, fold_wo, steps)
    b, cache_len = DECODE_LANES, DECODE_CACHE_LEN
    L, pages = _decode_layout(tcfg, layout)
    kw = dict(fold_wo=fold_wo)
    if layout == "paged":
        tc = tit.init_decode_cache(tcfg, TLayout.fit(b, L, DECODE_PAGE),
                                   device="cpu")
        kw.update(pages=T(pages), page_size=DECODE_PAGE, max_len=L)
    else:
        tc = tit.init_decode_cache(tcfg, device="cpu", batch=b,
                                   cache_len=cache_len)
    assert tc[0]["k8"].shape == want[0][1][0]["k8"].shape
    trope = til.build_rope_table(cache_len + 1, tcfg.hd, tcfg.rope_theta,
                                 device="cpu")
    toks_all, pos = _decode_inputs(steps, tcfg.vocab)
    for toks, (jlog, jc) in zip(toks_all, want):
        tlog, tc = tit.int_decode_step(
            tq, tc, T(toks), T(pos), tp, tcfg, trope, ops=backend, **kw)
        assert np.array_equal(tlog.numpy(), jlog)
        _caches_equal(tc, jc, layout == "paged")
        pos = pos + 1
    assert pos[2] > L                                # the window wrapped


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("layout,fold_wo", [("contiguous", False),
                                            ("contiguous", True),
                                            ("paged", False),
                                            ("paged", True)])
def test_decode_steps_match_reference(setup, layout, backend, fold_wo):
    _decode_steps(setup, layout, backend, fold_wo)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_decode_steps_at_head_dim_120_match_reference(setup120, layout):
    _decode_steps(setup120, layout, "cuda", layout == "paged", steps=7)


@pytest.mark.parametrize("s,cache_len", [(24, 0), (70, 80)])
@pytest.mark.parametrize("which", ["setup", "setup120"])
def test_int_prefill_return_cache_matches_reference(request, which, s,
                                                    cache_len):
    """Logits and the contiguous caches built token by token (70 tokens
    into an 80-position cache roll through the 64-position window)."""
    jcfg, tcfg, jq, jp, tq, tp = request.getfixturevalue(which)
    toks = np.random.default_rng(s).integers(1, tcfg.vocab, (2, s)) \
        .astype(np.int32)
    jlog, jc = jit_.int_prefill(jq, {"tokens": jnp.asarray(toks)}, jp, jcfg,
                                ops="ref", return_cache=True,
                                cache_len=cache_len)
    for backend in BACKENDS:
        tlog, tc = tit.int_prefill(tq, {"tokens": T(toks)}, tp, tcfg,
                                   ops=backend, return_cache=True,
                                   cache_len=cache_len)
        assert np.array_equal(tlog.numpy(), np.asarray(jlog)), backend
        _caches_equal(tc, jc, paged=False)


#: the JAX side of :func:`test_make_decode_step_matches_reference` (the
#: logits and caches after each step), computed once for both backends
_JAX_MAKE_DECODE = []


def _jax_make_decode_steps(setup, toks, cache_len, s, pos):
    if not _JAX_MAKE_DECODE:
        jcfg, _, jq, jp = setup[:4]
        _, jc = jit_.int_prefill(jq, {"tokens": jnp.asarray(toks)}, jp,
                                 jcfg, ops="ref", return_cache=True,
                                 cache_len=cache_len)
        jstep = j_make_decode_step(jcfg, jp, cache_len, ops="ref")
        jrope = jil.build_rope_table(cache_len + 1, jcfg.hd,
                                     jcfg.rope_theta)
        for t in range(3):
            jlog, jc = jstep(jq, jc, jnp.asarray(toks[:, t]),
                             jnp.asarray(pos + t), jrope)
            _JAX_MAKE_DECODE.append((np.asarray(jlog),
                                     jax.tree.map(np.asarray, jc)))
    return _JAX_MAKE_DECODE


@pytest.mark.parametrize("backend", BACKENDS)
def test_make_decode_step_matches_reference(setup, backend):
    """Prefill a cache, then three decode steps through each package's
    ``make_decode_step``."""
    _, tcfg, _, _, tq, tp = setup
    cache_len, b, s = 40, 2, 12
    toks = np.random.default_rng(9).integers(1, tcfg.vocab, (b, s)) \
        .astype(np.int32)
    pos = np.full((b,), s, np.int32)
    want = _jax_make_decode_steps(setup, toks, cache_len, s, pos)
    _, tc = tit.int_prefill(tq, {"tokens": T(toks)}, tp, tcfg, ops=backend,
                            return_cache=True, cache_len=cache_len)
    tstep = make_decode_step(tcfg, tp, cache_len, ops=backend, device="cpu")
    trope = til.build_rope_table(cache_len + 1, tcfg.hd, tcfg.rope_theta,
                                 device="cpu")
    for t, (jlog, jc) in enumerate(want):
        tlog, tc = tstep(tq, tc, toks[:, t], pos + t, trope)
        assert np.array_equal(tlog.numpy(), jlog)
        _caches_equal(tc, jc, paged=False)


def test_make_decode_step_defaults_to_the_card(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_decode_step(setup[1], setup[-1], 16)


# ---------------------------------------------------------- engine level --

@pytest.fixture(scope="module")
def wrap_setup():
    """tests/test_paged_decode.py's wrap test: one layer, vocab 128."""
    return _quantized(vocab=128, num_layers=1)


def _wrap_streams(eng, Request):
    reqs = [Request(uid=i, prompt=[1 + i, 7, 3], max_new_tokens=70)
            for i in range(2)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done(max_steps=300)
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs]


def test_engine_window_wrap_streams_match_reference(wrap_setup):
    """Window 64, cache_len 80, 70 new tokens a lane: decode positions
    wrap (slot = pos % 64).  The port's streams equal the JAX engine's
    in both cache modes, folded and not, on both backends."""
    jcfg, tcfg, jq, jp, tq, tp = wrap_setup
    assert jcfg.window == 64
    kw = dict(batch_size=2, cache_len=80)
    want = _wrap_streams(JEngine(jq, jp, jcfg, ops="ref",
                                 cache_mode="contiguous", fold_wo=False,
                                 **kw), JRequest)
    assert want == _wrap_streams(JEngine(jq, jp, jcfg, ops="ref",
                                         cache_mode="paged", fold_wo=True,
                                         **kw), JRequest)
    assert len(want[0]) == 70
    for backend in BACKENDS:
        for mode, fold in (("contiguous", False), ("paged", True)):
            eng = TEngine(tq, tp, tcfg, ops=backend, device="cpu",
                          cache_mode=mode, fold_wo=fold, **kw)
            assert _wrap_streams(eng, TRequest) == want, (backend, mode)


PROMPTS = [list(map(int, np.random.default_rng(7).integers(1, 500, n)))
           for n in (40, 3, 25, 1, 33)]


@pytest.mark.parametrize("mode", ["paged", "contiguous"])
def test_engine_streams_and_description_match_reference(setup, mode):
    """Five prompts through two recycled lanes, token-streaming prefill:
    streams, the prefill mode (no prefix index for a windowed arch), the
    cache's description and its bytes equal the JAX engine's; a
    contiguous engine zeroes a recycled lane and refuses to preempt."""
    jcfg, tcfg, jq, jp, tq, tp = setup
    kw = dict(batch_size=2, cache_len=64, cache_mode=mode)

    def drain(eng, Request):
        reqs = [Request(uid=i, prompt=list(p), max_new_tokens=4)
                for i, p in enumerate(PROMPTS)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        return reqs

    jeng = JEngine(jq, jp, jcfg, ops="ref", **kw)
    want = [r.out_tokens for r in drain(jeng, JRequest)]
    jd = jeng.describe()
    for backend in BACKENDS:
        teng = TEngine(tq, tp, tcfg, ops=backend, device="cpu", **kw)
        assert [r.out_tokens for r in drain(teng, TRequest)] == want
        td = teng.describe()
        assert td["prefill"]["mode"] == jd["prefill"]["mode"] == "streaming"
        assert teng.prefix is None and jeng.prefix is None
        assert td["cache"]["mode"] == jd["cache"]["mode"] == mode
        assert td["cache"]["kv_bytes"] == jd["cache"]["kv_bytes"]
        if mode == "paged":
            assert np.array_equal(teng.kv.allocator.refcount,
                                  jeng.kv.allocator.refcount)
            assert "paged[" in teng.describe_str()
        else:
            assert "cache=contiguous" in teng.describe_str()
            _caches_equal(teng.caches, jeng.caches, paged=False)
            sess = teng.submit(TRequest(uid=9, prompt=[5, 6], max_new_tokens=3))
            teng.step()
            with pytest.raises(ValueError, match="contiguous"):
                teng.preempt(sess)


def test_engine_refuses_what_it_cannot_take(setup):
    """Windowed archs cannot chunk; the contiguous layout has no page
    table to chunk through; an unknown cache mode is a typo."""
    _, tcfg, _, _, tq, tp = setup
    with pytest.raises(ValueError, match="window"):
        TEngine(tq, tp, tcfg, device="cpu", prefill_chunk=16)
    full = dataclasses.replace(tcfg, window=0)
    with pytest.raises(ValueError, match="paged"):
        TEngine(tq, tp, full, device="cpu", cache_mode="contiguous",
                prefill_chunk=16)
    with pytest.raises(ValueError, match="cache_mode"):
        TEngine(tq, tp, tcfg, device="cpu", cache_mode="ragged")
