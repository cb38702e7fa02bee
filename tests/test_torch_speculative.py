"""Self-speculative decoding in the port == the JAX package, bit for bit.

Reduced llama3-8b (2 layers, d = 128, vocab 1024), quantized by the JAX
package and carried across with ``repro_torch.interop``:

  * ``serving.speculate``: the n-gram proposer's drafts equal the
    reference proposer's (the JAX test's cases and random contexts), the
    registry's and ``validate_spec``'s typed errors (``spec_k`` past
    ``MAX_SQ - 1``, a sliding-window arch, an unknown mode);
  * ``int_verify_step``: logits equal the JAX ``int_verify_step``'s and
    the pools after it equal the reference's, paged (int8 and int4) and
    contiguous, folded and not, on both port backends; each real row's
    logits equal a sequential ``int_decode_step`` of the same tokens;
    RoPE refuses a position outside its table;
  * ``ServingEngine(spec_k=...)``: streams equal ``spec_k = 0``'s and the
    JAX spec engine's in paged (chunked and streaming prefill), int4 and
    contiguous caches; drafts land on repetitive traffic; rollback keeps
    the allocator's refcounts exact; the cache end and the token budget
    clamp drafts; preemption composes; ``temperature > 0`` is refused.

The ``cuda`` backend runs its kernels' plain versions here (CPU tensors);
its dispatch at Sq = spec_k + 1 is the code under test.  Tolerance: 0.
"""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as j_get_config
from repro.models import intlayers as jil
from repro.models import inttransformer as jit_
from repro.models import model as JM
from repro.models import transformer as jtf
from repro.quant import convert as j_convert
from repro.serving import NgramProposer as JNgram
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving.kvcache import CacheLayout as JLayout
from repro_torch.analysis.budgets import MAX_SQ
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.interop import from_reference
from repro_torch.models import intlayers as til
from repro_torch.models import inttransformer as tit
from repro_torch.models import model as TM
from repro_torch.serving import (NgramProposer, Request, ServingEngine,
                                 SpeculationError, SpeculationUnsupported,
                                 get_proposer, validate_spec)
from repro_torch.serving.kvcache import CacheLayout as TLayout

T = torch.as_tensor


@pytest.fixture(scope="module")
def setup():
    over = dict(dtype="float32", vocab=1024)
    jcfg = JM.reduce_config(j_get_config("llama3-8b"), **over)
    tcfg = TM.reduce_config(t_get_config("llama3-8b"), **over)
    params = jtf.init_params(jax.random.key(0), jcfg)
    jq, jp = j_convert.quantize_params(params, jcfg)
    tq, tp = from_reference(jax.tree.map(np.array, jq), jp, device="cpu")
    return jcfg, tcfg, jq, jp, tq, tp


# ------------------------------------------------------------ proposer --

def test_ngram_proposer_cases():
    """The reference test's cases, and the reference proposer's answers."""
    cases = [([7, 8, 9, 1, 2, 7, 8, 9], 2, [1, 2]),
             ([5, 6, 5, 6, 5, 6], 3, [5, 6]),
             ([5, 6, 5, 6, 5, 6, 5], 3, [6, 5, 6]),
             ([1, 2, 3, 4], 2, []), ([9, 9, 9, 9, 9], 1, [9]),
             ([1, 2, 3], 0, []), ([], 4, []),
             ([2, 7, 3, 1, 2, 8, 1, 2], 1, [8])]
    p, j = NgramProposer(max_n=3), JNgram(max_n=3)
    for ctx, k, want in cases:
        assert p.propose(ctx, k) == j.propose(ctx, k) == want, ctx


@pytest.mark.parametrize("max_n,min_n", [(3, 1), (2, 2), (4, 1)])
def test_ngram_proposer_matches_reference_on_random_contexts(max_n, min_n):
    rng = np.random.default_rng(max_n * 10 + min_n)
    p, j = NgramProposer(max_n, min_n), JNgram(max_n, min_n)
    for _ in range(300):
        ctx = [int(t) for t in rng.integers(0, 4, rng.integers(0, 24))]
        k = int(rng.integers(0, 8))
        assert p.propose(ctx, k) == j.propose(ctx, k), (ctx, k)


def test_proposer_registry_typed_errors():
    assert get_proposer("ngram").name == "ngram"
    with pytest.raises(SpeculationError, match="unknown spec_mode"):
        get_proposer("draft-model")
    with pytest.raises(SpeculationError, match="min_n"):
        NgramProposer(max_n=2, min_n=3)


def test_validate_spec_gating(setup):
    """spec_k past MAX_SQ - 1, a sliding-window arch and a typo'd mode
    raise typed, in ``validate_spec`` and in the engine's constructor."""
    _, tcfg, _, _, tq, tp = setup
    validate_spec(tcfg, 0, "ngram")
    validate_spec(tcfg, MAX_SQ - 1, "ngram")
    validate_spec(tcfg, 0, "medusa")       # spec off never reads the mode
    with pytest.raises(SpeculationError, match="spec_k must be >= 0"):
        validate_spec(tcfg, -1, "ngram")
    with pytest.raises(SpeculationError, match="MAX_SQ"):
        validate_spec(tcfg, MAX_SQ, "ngram")
    with pytest.raises(SpeculationError, match="unknown spec_mode"):
        validate_spec(tcfg, 2, "medusa")
    h2o = t_get_config("h2o-danube-3-4b")
    assert not tit.speculative_decode_supported(h2o)
    assert tit.speculative_decode_supported(tcfg)
    with pytest.raises(SpeculationUnsupported, match="window"):
        validate_spec(h2o, 2, "ngram")
    for kw, err in ((dict(spec_k=MAX_SQ), "MAX_SQ"),
                    (dict(spec_k=2, spec_mode="medusa"), "unknown")):
        with pytest.raises(SpeculationError, match=err):
            ServingEngine(tq, tp, tcfg, batch_size=2, cache_len=64,
                          device="cpu", **kw)
    hq, hp = _h2o_params()
    with pytest.raises(SpeculationUnsupported):
        ServingEngine(hq, hp, TM.reduce_config(h2o, dtype="float32"),
                      batch_size=2, cache_len=64, device="cpu", spec_k=2)


def _h2o_params():
    from repro_torch.quant import convert
    cfg = TM.reduce_config(t_get_config("h2o-danube-3-4b"), dtype="float32")
    return convert.init_quantized(cfg, seed=0, device="cpu")


# ----------------------------------------------------------- verify step --

def test_rope_gather_refuses_positions_outside_the_table():
    tab = til.build_rope_table(16, 32, 10000.0, device="cpu")
    cos, _ = til.rope_gather(tab, T([[0, 15]]))
    assert cos.shape == (1, 2, 1, 16)
    for bad in ([[0, 16]], [[-1, 3]]):
        with pytest.raises(IndexError, match="outside the table"):
            til.rope_gather(tab, T(bad))
    # a host-side span is checked instead of the positions themselves
    with pytest.raises(IndexError, match="outside the table"):
        til.rope_gather(tab, T([[0, 1]]), pos_span=(0, 16))
    til.rope_gather(tab, T([[0, 1]]), pos_span=(0, 15))


def test_real_rows_and_verify_positions():
    n_new = np.array([1, 4, 2], np.int32)
    assert til.real_rows(n_new, 4).tolist() == [3, 4, 5, 6, 7, 10, 11]
    pos, real = til.verify_positions(T([0, 5, 9]), T(n_new), 4)
    assert pos.tolist() == [[0, 0, 0, 0], [5, 6, 7, 8], [7, 8, 9, 10]]
    assert real.tolist() == [[False] * 3 + [True], [True] * 4,
                             [False, False, True, True]]


def _pools_equal(tcaches, jcaches, paged):
    """Paged: every allocatable page (the null page 0 takes the discarded
    writes of pad rows and idle lanes); contiguous: whole."""
    for tc, jc in zip(tcaches, jcaches):
        for key in tc:
            t, j = tc[key].numpy(), np.asarray(jc[key])
            if paged and key in ("k8", "v8"):
                t, j = t[:, 1:], j[:, 1:]
            assert np.array_equal(t, j), key


VERIFY_CASES = [("paged", "int8"), ("paged", "int4"), ("contiguous", "int8")]
VB, VLEN, VPS, VS = 4, 48, 8, 4          # lanes, cache_len, page size, rows
START = np.array([0, 5, 11, 0], np.int32)    # lane 3 idle
N_NEW = np.array([3, 4, 2, 1], np.int32)


def _verify_inputs(tcfg, mode, kv):
    """The fill schedule (decode tokens and positions per step), the page
    table and the verify step's tokens, from a seed."""
    rng = np.random.default_rng(3)
    pages = None
    if mode == "paged":
        tl = TLayout.fit(VB, VLEN, VPS, kv_dtype=kv)
        pages = np.zeros((VB, tl.max_pages), np.int32)
        perm = rng.permutation(np.arange(1, tl.num_pages))
        pages[:3] = perm[:3 * tl.max_pages].reshape(3, -1)
    fill = []
    for t in range(int(START.max())):
        toks = rng.integers(1, tcfg.vocab, VB).astype(np.int32)
        toks[START <= t] = 0
        fill.append((toks, np.minimum(START - 1, t).clip(0)
                     .astype(np.int32)))
    vtoks = rng.integers(1, tcfg.vocab, (VB, VS)).astype(np.int32)
    for i, n in enumerate(N_NEW):
        vtoks[i, :VS - n] = 0
    vtoks[3] = 0
    return fill, pages, vtoks


@pytest.fixture(scope="module")
def verify_reference(setup):
    """The JAX package's caches after the fill and its ``int_verify_step``
    logits and caches, per (layout, kv dtype), jitted and computed once."""
    jcfg, tcfg, jq, jp, _, _ = setup
    jrope = jil.build_rope_table(VLEN + 1, jcfg.hd, jcfg.rope_theta)
    out = {}
    for mode, kv in VERIFY_CASES:
        fill, pages, vtoks = _verify_inputs(tcfg, mode, kv)
        if pages is not None:
            jl = JLayout.fit(VB, VLEN, VPS, kv_dtype=kv)
            jc = jit_.init_decode_cache(jcfg, VB, VLEN, layout=jl)
            kw = dict(pages=jnp.asarray(pages), page_size=VPS, max_len=VLEN)
        else:
            jc = jit_.init_decode_cache(jcfg, VB, VLEN)
            kw = {}
        dec = jax.jit(lambda c, t, p, kw=kw: jit_.int_decode_step(
            jq, c, t, p, jp, jcfg, jrope, ops="ref", **kw))
        for toks, pos in fill:
            _, jc = dec(jc, jnp.asarray(toks), jnp.asarray(pos))
        filled = jax.tree.map(np.asarray, jc)
        logits, jc = jit_.int_verify_step(
            jq, jc, jnp.asarray(vtoks), jnp.asarray(START),
            jnp.asarray(N_NEW), jp, jcfg, jrope, ops="ref", **kw)
        out[mode, kv] = (filled, np.asarray(logits),
                         jax.tree.map(np.asarray, jc))
    return out


@pytest.mark.parametrize("backend", ["torch_ref", "cuda"])
@pytest.mark.parametrize("fold_wo", [False, True])
@pytest.mark.parametrize("mode,kv", VERIFY_CASES,
                         ids=lambda x: x if isinstance(x, str) else None)
def test_verify_step_matches_reference(setup, verify_reference, backend,
                                       fold_wo, mode, kv):
    """Decode steps fill the caches, then one verify step at S = 4 with
    n_new 3 / 4 / 2 / 1 (lane 0 at position 0, lane 3 idle): the filled
    caches, the logits and the caches after it equal the JAX package's
    (``fold_wo`` off; folding is exact); each real row's logits equal a
    sequential ``int_decode_step`` of that lane's tokens."""
    _, tcfg, _, _, tq, tp = setup
    paged = mode == "paged"
    fill, pages, vtoks = _verify_inputs(tcfg, mode, kv)
    if paged:
        tc = tit.init_decode_cache(
            tcfg, TLayout.fit(VB, VLEN, VPS, kv_dtype=kv), device="cpu")
        kw = dict(pages=T(pages), page_size=VPS, max_len=VLEN)
    else:
        tc = tit.init_decode_cache(tcfg, device="cpu", batch=VB,
                                   cache_len=VLEN)
        kw = {}
    trope = til.build_rope_table(VLEN + 1, tcfg.hd, tcfg.rope_theta,
                                 device="cpu")
    run = dict(ops=backend, fold_wo=fold_wo)
    for toks, pos in fill:
        _, tc = tit.int_decode_step(tq, tc, T(toks), T(pos), tp, tcfg,
                                    trope, **run, **kw)
    filled, jlog, jafter = verify_reference[mode, kv]
    _pools_equal(tc, filled, paged)
    before = [{k: v.clone() for k, v in c.items()} for c in tc]
    write_rows = None if paged else T(til.real_rows(N_NEW, VS))
    tlog, tc = tit.int_verify_step(
        tq, tc, T(vtoks), T(START), T(N_NEW), tp, tcfg, trope,
        write_rows=write_rows, **run, **kw)
    assert tlog.shape == (VB, VS, tcfg.vocab)
    assert np.array_equal(tlog.numpy(), jlog)
    _pools_equal(tc, jafter, paged)
    # each real row == a one-token decode of the same token, lane by lane
    for lane in range(3):
        caches = [{k: v.clone() for k, v in c.items()} for c in before]
        n = int(N_NEW[lane])
        one = dict(kw)
        if paged:
            view = np.zeros_like(pages)
            view[lane] = pages[lane]
            one["pages"] = T(view)
        for j in range(n):
            p = np.zeros(VB, np.int32)
            p[lane] = START[lane] + j
            tk = np.zeros(VB, np.int32)
            tk[lane] = vtoks[lane, VS - n + j]
            logit, caches = tit.int_decode_step(
                tq, caches, T(tk), T(p), tp, tcfg, trope, **run, **one)
            assert np.array_equal(logit[lane].numpy(),
                                  tlog[lane, VS - n + j].numpy()), (lane, j)


def test_contiguous_verify_requires_write_rows(setup):
    """The contiguous layout writes only the rows ``write_rows`` names
    (built on the host): without them it refuses rather than find the
    real rows on the device; with them a pad row writes nothing."""
    _, tcfg, _, _, tq, tp = setup
    b, s, cache_len = 2, 3, 16
    trope = til.build_rope_table(cache_len + 1, tcfg.hd, tcfg.rope_theta,
                                 device="cpu")
    toks = T(np.array([[0, 5, 6], [7, 8, 9]], np.int32))
    pos, n_new = T([0, 3]), T([2, 3])
    tc = tit.init_decode_cache(tcfg, device="cpu", batch=b,
                               cache_len=cache_len)
    with pytest.raises(ValueError, match="write_rows"):
        tit.int_verify_step(tq, tc, toks, pos, n_new, tp, tcfg, trope,
                            ops="torch_ref")
    _, tc = tit.int_verify_step(tq, tc, toks, pos, n_new, tp, tcfg, trope,
                                ops="torch_ref",
                                write_rows=T(til.real_rows([2, 3], s)))
    # lane 0's two real rows wrote slots 0 and 1; its pad row nothing
    assert tc[0]["k8"][:, 0, :2].any()
    assert not tc[0]["k8"][:, 0, 2:].any()
    # lane 1's three real rows wrote slots 3..5 and nothing else
    assert tc[0]["k8"][:, 1, 3:6].any()
    assert not tc[0]["k8"][:, 1, :3].any() and not tc[0]["k8"][:, 1, 6:].any()


# ------------------------------------------------------------- engines --

REP = [3, 5, 7, 3, 5, 7, 3, 5]
PROMPTS = [REP * 2, [11, 2, 11, 2, 11], [40, 41, 42], list(range(60, 81))]


def _drive(eng, Req, prompts=PROMPTS, max_new=12):
    reqs = [Req(uid=i, prompt=list(p), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done for r in reqs)
    return [list(r.out_tokens) for r in reqs]


ENGINE_CASES = [dict(cache_mode="paged"),
                dict(cache_mode="paged", prefill_chunk=0),
                dict(cache_mode="paged", kv_dtype="int4"),
                dict(cache_mode="contiguous")]


@pytest.mark.parametrize("kw", ENGINE_CASES,
                         ids=lambda kw: ",".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_spec_streams_match_spec_off_and_reference(setup, kw):
    """spec_k 2 and MAX_SQ - 1 give spec_k = 0's streams, on both port
    backends, and the JAX spec engine's (spec_k 2); drafts land."""
    jcfg, tcfg, jq, jp, tq, tp = setup
    geom = dict(batch_size=2, cache_len=64, page_size=8, **kw)
    base = _drive(ServingEngine(tq, tp, tcfg, ops="torch_ref",
                                device="cpu", **geom), Request)
    jeng = JEngine(jq, jp, jcfg, ops="ref", spec_k=2, **geom)
    assert _drive(jeng, JRequest) == base
    for backend in ("torch_ref", "cuda"):
        for k in (2, MAX_SQ - 1):
            eng = ServingEngine(tq, tp, tcfg, ops=backend, device="cpu",
                                spec_k=k, **geom)
            assert _drive(eng, Request) == base, (backend, k)
            spec = eng.describe()["spec"]
            assert spec["drafted"] > 0
            assert spec["wasted"] == spec["drafted"] - spec["accepted"]
            if k == 2:
                assert spec == jeng.describe()["spec"], backend


def test_spec_accepts_drafts_on_repeated_structure(setup):
    _, tcfg, _, _, tq, tp = setup
    eng = ServingEngine(tq, tp, tcfg, batch_size=2, cache_len=64,
                        device="cpu", spec_k=3)
    out = _drive(eng, Request, prompts=[REP * 2], max_new=24)
    spec = eng.describe()["spec"]
    assert spec["drafted"] > 0 and spec["accepted"] > 0
    assert spec["accept_rate"] > 0
    assert "spec=ngram:k3" in eng.describe_str()
    eng0 = ServingEngine(tq, tp, tcfg, batch_size=2, cache_len=64,
                         device="cpu")
    assert out == _drive(eng0, Request, prompts=[REP * 2], max_new=24)


def test_spec_stats_zero_before_any_draft(setup):
    _, tcfg, _, _, tq, tp = setup
    eng = ServingEngine(tq, tp, tcfg, batch_size=2, cache_len=64,
                        device="cpu", spec_k=2)
    assert eng.describe()["spec"] == {"k": 2, "mode": "ngram",
                                      "drafted": 0, "accepted": 0,
                                      "accept_rate": None, "wasted": 0}
    off = ServingEngine(tq, tp, tcfg, batch_size=2, cache_len=64,
                        device="cpu")
    assert off.describe()["spec"]["mode"] == "off"


def test_spec_rollback_keeps_exact_refcounts(setup):
    """After every step the allocator's refcounts equal the live holders
    (sessions and prefix entries) exactly, through ``truncate``."""
    _, tcfg, _, _, tq, tp = setup
    eng = ServingEngine(tq, tp, tcfg, batch_size=2, cache_len=64,
                        device="cpu", spec_k=3, page_size=8)
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=16)
            for i, p in enumerate(PROMPTS)]
    sessions = [eng.submit(r) for r in reqs]
    truncated = 0
    real = eng.kv.truncate

    def counting(sess, keep):
        nonlocal truncated
        truncated += 1
        return real(sess, keep)
    eng.kv.truncate = counting
    while eng.queue or any(s is not None for s in eng.slots):
        eng.step()
        eng.kv.allocator.check()
        held = collections.Counter()
        for sess in sessions:
            held.update(sess.pages)
        for entry in eng.prefix.entries.values():
            held.update(entry.pages)
        for page in range(1, eng.layout.num_pages):
            assert eng.kv.allocator.refcount[page] == held.get(page, 0)
    assert truncated > 0 and eng.describe()["spec"]["drafted"] > 0


@pytest.mark.parametrize("mode", ["paged", "contiguous"])
def test_spec_never_overruns_cache_or_token_budget(setup, mode):
    """Near the cache end the draft shrinks: a prompt + continuation that
    exactly fills the cache emits every token, spec on and off."""
    _, tcfg, _, _, tq, tp = setup
    outs = []
    for k in (0, MAX_SQ - 1):
        eng = ServingEngine(tq, tp, tcfg, batch_size=2, cache_len=16,
                            device="cpu", spec_k=k, cache_mode=mode)
        outs.append(_drive(eng, Request, prompts=[REP, REP[:5]],
                           max_new=9))
    assert [len(o) for o in outs[0]] == [9, 9]
    assert outs[0] == outs[1]


def test_spec_composes_with_preempt(setup):
    _, tcfg, _, _, tq, tp = setup
    eng = ServingEngine(tq, tp, tcfg, batch_size=1, cache_len=64,
                        device="cpu", spec_k=3)
    r0 = Request(uid=0, prompt=REP * 2, max_new_tokens=24)
    r1 = Request(uid=1, prompt=[11, 2, 11, 2, 11], max_new_tokens=8)
    s0 = eng.submit(r0)
    eng.submit(r1)
    for _ in range(4):
        eng.step()
    assert s0.state == "active"
    eng.preempt(s0)
    eng.run_until_done()
    want = _drive(ServingEngine(tq, tp, tcfg, batch_size=2, cache_len=64,
                                device="cpu"), Request,
                  prompts=[REP * 2, [11, 2, 11, 2, 11]], max_new=24)
    assert r0.out_tokens == want[0]
    assert r1.out_tokens == want[1][:8]


def test_temperature_refused_under_spec(setup):
    _, tcfg, _, _, tq, tp = setup
    eng = ServingEngine(tq, tp, tcfg, batch_size=2, cache_len=64,
                        device="cpu", spec_k=2)
    with pytest.raises(SpeculationUnsupported, match="greedy"):
        eng.submit(Request(uid=0, prompt=[1, 2], max_new_tokens=4,
                           temperature=0.7))
    eng.submit(Request(uid=1, prompt=[1, 2], max_new_tokens=4))
    eng.run_until_done()
