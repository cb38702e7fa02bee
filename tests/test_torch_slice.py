"""The ported serving slice == the JAX engine, bit for bit.

Reduced llama3-8b (the config ``tests/test_serving.py`` uses), quantized
by the JAX package and carried across with ``repro_torch.interop``:

  * ``int_prefill_chunk_step`` / ``int_decode_step``: logits and page
    pools equal to the reference after every step, ``fold_wo`` on and off,
    on both port backends;
  * ``ServingEngine``: token streams equal to the JAX engine's for the
    request schedules of ``tests/test_serving.py`` and
    ``tests/test_chunked_prefill.py`` (prefill_chunk 0/8/16/32/64, a
    prefill budget, shared prefixes with copy-on-write, evict and
    preempt, temperature sampling), with identical allocator refcounts
    and page-pool statistics.

The ``cuda`` backend runs its kernels' plain versions here (CPU tensors);
its dispatch — paged pools, folded wo — is the code under test.
Tolerance: 0.
"""

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
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving.kvcache import CacheLayout as JLayout
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.interop import from_reference
from repro_torch.models import intlayers as til
from repro_torch.models import inttransformer as tit
from repro_torch.models import model as TM
from repro_torch.serving import Request as TRequest
from repro_torch.serving import ServingEngine as TEngine
from repro_torch.serving.kvcache import CacheLayout as TLayout

BACKENDS = ("torch_ref", "cuda")


@pytest.fixture(scope="module")
def setup():
    over = dict(dtype="float32", capacity_factor=8.0)
    jcfg = JM.reduce_config(j_get_config("llama3-8b"), **over)
    tcfg = TM.reduce_config(t_get_config("llama3-8b"), **over)
    params = jtf.init_params(jax.random.key(0), jcfg)
    jq, jp = j_convert.quantize_params(params, jcfg)
    tq, tp = from_reference(jax.tree.map(np.array, jq), jp, device="cpu")
    return jcfg, tcfg, jq, jp, tq, tp


# --------------------------------------------------------- step level ----

def _pools_equal(tcaches, jcaches):
    """Every allocatable page identical.  The null page 0 is left out: it
    absorbs the discarded writes of idle lanes and padded chunk tails,
    several per position, and which duplicate a scatter keeps is
    unspecified in both frameworks — its contents are never valid."""
    for tc, jc in zip(tcaches, jcaches):
        for key in ("k8", "v8"):
            t, j = tc[key].numpy(), np.asarray(jc[key])
            assert np.array_equal(t[:, 1:], j[:, 1:]), key


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("fold_wo", [False, True])
def test_chunk_and_decode_steps_match_reference(setup, backend, fold_wo):
    """Two chunked-prefill steps (one lane idle -> null-page writes, one
    with an unaligned base, a chunk running past the table span), then
    three decode steps: every step's logits and both pools identical."""
    jcfg, tcfg, jq, jp, tq, tp = setup
    b, cache_len, ps, C = 3, 64, 16, 32
    jl = JLayout.fit(b, cache_len, ps)
    tl = TLayout.fit(b, cache_len, ps)
    jc = jit_.init_decode_cache(jcfg, b, cache_len, layout=jl)
    tc = tit.init_decode_cache(tcfg, tl, device="cpu")
    rope_rows = cache_len + C + 8
    jrope = jil.build_rope_table(rope_rows, jcfg.hd, jcfg.rope_theta)
    trope = til.build_rope_table(rope_rows, tcfg.hd, tcfg.rope_theta,
                                 device="cpu")
    pages = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]],
                     np.int32)
    rng = np.random.default_rng(5)
    common = dict(page_size=ps, fold_wo=fold_wo)
    for base in ([0, 5, 0], [32, 37, 0]):
        toks = rng.integers(1, tcfg.vocab, (b, C)).astype(np.int32)
        view = pages.copy()
        view[2] = 0                                   # lane 2 not prefilling
        base = np.array(base, np.int32)
        jc = jit_.int_prefill_chunk_step(
            jq, jc, jnp.asarray(toks), jnp.asarray(base), jp, jcfg, jrope,
            ops="ref", pages=jnp.asarray(view), **common)
        tc = tit.int_prefill_chunk_step(
            tq, tc, torch.as_tensor(toks), torch.as_tensor(base), tp, tcfg,
            trope, ops=backend, pages=torch.as_tensor(view), **common)
        _pools_equal(tc, jc)
    pos = np.array([40, 50, 3], np.int32)
    for _ in range(3):
        toks = rng.integers(1, tcfg.vocab, (b,)).astype(np.int32)
        jlog, jc = jit_.int_decode_step(
            jq, jc, jnp.asarray(toks), jnp.asarray(pos), jp, jcfg, jrope,
            ops="ref", pages=jnp.asarray(pages), max_len=cache_len,
            **common)
        tlog, tc = tit.int_decode_step(
            tq, tc, torch.as_tensor(toks), torch.as_tensor(pos), tp, tcfg,
            trope, ops=backend, pages=torch.as_tensor(pages),
            max_len=cache_len, **common)
        assert np.array_equal(tlog.numpy(), np.asarray(jlog))
        _pools_equal(tc, jc)
        pos = pos + 1


# ------------------------------------------------------- engine level ----

RNG = np.random.default_rng(7)
PROMPTS = [list(map(int, RNG.integers(1, 64, n))) for n in
           (40, 3, 25, 1, 33)]
SERVING_PROMPTS = [[1, 7, 42], [9, 3], [17, 2, 5, 11], [4], [23, 8, 31]]


def _both(setup, schedule, **kw):
    """Drive the JAX engine (ref ops) and the port's engine on each
    backend through the same ``schedule(eng, Request)``; assert equal
    token streams, allocator refcounts and pool statistics."""
    jcfg, tcfg, jq, jp, tq, tp = setup
    kw = {"batch_size": 2, "cache_len": 64, **kw}
    jeng = JEngine(jq, jp, jcfg, ops="ref", **kw)
    jreqs = schedule(jeng, JRequest)
    for backend in BACKENDS:
        teng = TEngine(tq, tp, tcfg, ops=backend, device="cpu", **kw)
        treqs = schedule(teng, TRequest)
        assert [r.out_tokens for r in treqs] == \
            [r.out_tokens for r in jreqs], (backend, kw)
        assert [r.done for r in treqs] == [r.done for r in jreqs]
        assert np.array_equal(teng.kv.allocator.refcount,
                              jeng.kv.allocator.refcount)
        jd, td = jeng.describe()["cache"], teng.describe()["cache"]
        for key in ("page_size", "num_pages", "pages_used", "pages_free",
                    "live_tokens", "shared_pages", "cow_copies", "prefix",
                    "kv_bytes"):
            assert td[key] == jd[key], (backend, key)
        assert teng.describe()["prefill"]["chunk"] == \
            jeng.describe()["prefill"]["chunk"]
    return jreqs


def _drain(prompts, max_new=4, temperature=0.0):
    def schedule(eng, Request):
        reqs = [Request(uid=i, prompt=list(p), max_new_tokens=max_new,
                        temperature=temperature)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        return reqs
    return schedule


def test_engine_serving_schedule(setup):
    """tests/test_serving.py: 5 requests through 2 recycled lanes."""
    reqs = _both(setup, _drain(SERVING_PROMPTS, max_new=5))
    assert all(len(r.out_tokens) == 5 for r in reqs)


@pytest.mark.parametrize("kw", [
    dict(), dict(prefill_chunk=16), dict(prefill_chunk=8),
    dict(prefill_chunk=64), dict(prefill_chunk=0),
    dict(prefill_budget=8), dict(prefill_chunk=16, prefill_budget=4),
    dict(fold_wo=False), dict(prefix_cache=False),
    dict(page_size=8, prefill_chunk=8)],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_engine_chunked_prefill_matrix(setup, kw):
    """tests/test_chunked_prefill.py's acceptance matrix."""
    _both(setup, _drain(PROMPTS), **kw)


def test_engine_temperature_sampling(setup):
    _both(setup, _drain(SERVING_PROMPTS[:3], max_new=6, temperature=0.8),
          seed=3)


def test_engine_shared_prefix_and_cow(setup):
    """Staggered same-prompt sessions share pages; a diverging last token
    copy-on-writes the shared page."""
    p1 = list(PROMPTS[0])
    p2 = p1[:-1] + [int(p1[-1]) % 60 + 1]

    def schedule(eng, Request):
        a = Request(uid=0, prompt=list(p1), max_new_tokens=4)
        eng.submit(a)
        eng.step()
        b = Request(uid=1, prompt=list(p1), max_new_tokens=4)
        eng.submit(b)
        eng.step()
        c = Request(uid=2, prompt=p2, max_new_tokens=4)
        eng.submit(c)
        eng.run_until_done()
        return [a, b, c]
    reqs = _both(setup, schedule)
    assert reqs[0].out_tokens == reqs[1].out_tokens


def test_engine_evict_and_preempt(setup):
    """Evict mid-generation then re-admit (prefix hit), and preempt a
    session mid-prefill; both resume bit-exactly."""
    def schedule(eng, Request):
        a = Request(uid=0, prompt=list(PROMPTS[0]), max_new_tokens=4)
        sa = eng.submit(a)
        eng.step()
        eng.evict(sa)
        b = Request(uid=1, prompt=list(PROMPTS[0]), max_new_tokens=4)
        eng.submit(b)
        c = Request(uid=2, prompt=list(PROMPTS[2]), max_new_tokens=3)
        sc = eng.submit(c)
        eng.step()
        if sc.state == "prefilling" or sc.state == "active":
            eng.preempt(sc)
        eng.run_until_done()
        return [a, b, c]
    _both(setup, schedule, batch_size=2, prefill_chunk=8, prefill_budget=8)


def test_engine_unported_options_raise(setup):
    """Every option of the reference's engine is served (the contiguous
    cache and sliding windows: tests/test_torch_window.py; int4 KV pages:
    tests/test_torch_kv4.py; speculative decoding:
    tests/test_torch_speculative.py; tensor parallelism:
    tests/test_torch_tp.py).  Without a process group ``tp=2`` takes the
    gathered mode, as the reference does without the devices; a tp that
    does not divide the KV heads raises the reference's ValueError."""
    _, tcfg, _, _, tq, tp = setup
    eng = TEngine(tq, tp, tcfg, device="cpu", tp=2)
    assert eng.describe()["tp"] == {"tp": 2, "mode": "gathered",
                                    "mesh": None, "per_device_kv_bytes":
                                    eng.describe()["cache"]["kv_bytes"]}
    with pytest.raises(ValueError, match="tp=3 must divide"):
        TEngine(tq, tp, tcfg, device="cpu", tp=3)
    assert TEngine(tq, tp, tcfg, device="cpu", spec_k=2).spec_k == 2
