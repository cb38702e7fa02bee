"""The port's dispatch / commit split and asyncio front end == the JAX
package, bit for bit.

Reduced llama3-8b (2 layers, d = 128, vocab 1024), quantized by the JAX
package and carried across with ``repro_torch.interop``:

  * ``dispatch_step`` then ``commit_step`` gives ``step()``'s streams and
    the JAX engine's, paged, contiguous and over int4 pages, spec off and
    on; ``StepInFlight`` guards evict, preempt, a second dispatch and a
    stale commit;
  * ``ServingFrontend``: 16 concurrent streams equal the JAX front end's
    (paged and contiguous, spec_k 0 and 2), and streaming is incremental;
    cancel mid-decode, mid-prefill and while queued, and a deadline on an
    injected clock, each with the allocator's refcounts exact;
    ``QueueFull``, ``RequestInfeasible`` (the cache and a prompt that can
    never fit the pool), stall detection and the ``describe()`` keys;
  * a dropped engine is freed without the cyclic collector (the
    allocator's reclaim hook holds it weakly).

The ``cuda`` backend runs its kernels' plain versions here (CPU tensors).
Tolerance: 0.
"""
import asyncio
import collections
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs.registry import get_config as j_get_config
from repro.models import model as JM
from repro.models import transformer as jtf
from repro.quant import convert as j_convert
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving import ServingFrontend as JFrontend
from repro_torch.analysis.contracts import RequestInfeasible
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.interop import from_reference
from repro_torch.models import model as TM
from repro_torch.serving import (TERMINAL_STATES, EngineStalled, PendingStep,
                                 QueueFull, Request, ServingEngine,
                                 ServingFrontend, StepInFlight)

MAX_NEW = 4


@pytest.fixture(scope="module")
def setup():
    over = dict(dtype="float32", vocab=1024)
    jcfg = JM.reduce_config(j_get_config("llama3-8b"), **over)
    tcfg = TM.reduce_config(t_get_config("llama3-8b"), **over)
    params = jtf.init_params(jax.random.key(0), jcfg)
    jq, jp = j_convert.quantize_params(params, jcfg)
    tq, tp = from_reference(jax.tree.map(np.array, jq), jp, device="cpu")
    return jcfg, tcfg, jq, jp, tq, tp


def _prompts(n=16):
    rng = np.random.default_rng(7)
    stem = [int(t) for t in rng.integers(1, 100, 12)]
    out = []
    for i in range(n):
        if i % 3 == 0:
            out.append(stem[: 4 + (i % 8)] + [101 + i])   # shared prefix
        else:
            out.append([int(t) for t in rng.integers(1, 100, 3 + (i % 9))])
    return out


def _engine(setup, batch_size=4, cache_len=64, ops="cuda", **kw):
    _, tcfg, _, _, tq, tp = setup
    return ServingEngine(tq, tp, tcfg, batch_size=batch_size,
                         cache_len=cache_len, ops=ops, device="cpu", **kw)


def _frontend(setup, batch_size=4, cache_len=64, **kw):
    fe_kw = {k: kw.pop(k) for k in ("max_pending", "clock", "stall_steps")
             if k in kw}
    return ServingFrontend(_engine(setup, batch_size, cache_len, **kw),
                           **fe_kw)


def _solo(setup, prompt, max_new=MAX_NEW):
    """The synchronous greedy stream of one prompt alone."""
    eng = _engine(setup, batch_size=2, ops="torch_ref",
                  cache_mode="contiguous")
    req = Request(uid=0, prompt=list(prompt), max_new_tokens=max_new)
    eng.submit(req)
    eng.run_until_done()
    return list(req.out_tokens)


def _check_refcounts(eng, sessions):
    eng.kv.allocator.check()
    held = collections.Counter()
    for sess in sessions:
        held.update(sess.pages)
    if eng.prefix is not None:
        for entry in eng.prefix.entries.values():
            held.update(entry.pages)
    for page in range(1, eng.layout.num_pages):
        assert eng.kv.allocator.refcount[page] == held.get(page, 0), page


# ------------------------------------------------ dispatch / commit -----

SPLIT_CASES = [dict(cache_mode="paged"), dict(cache_mode="contiguous"),
               dict(cache_mode="paged", kv_dtype="int4"),
               dict(cache_mode="paged", spec_k=2),
               dict(cache_mode="contiguous", spec_k=2)]


@pytest.mark.parametrize("kw", SPLIT_CASES,
                         ids=lambda kw: ",".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_dispatch_commit_matches_step_and_reference(setup, kw):
    """Driving the halves explicitly == ``step()`` == the JAX engine."""
    jcfg, _, jq, jp, _, _ = setup
    prompts = _prompts(5)

    def run(eng, Req, split):
        reqs = [Req(uid=i, prompt=list(p), max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        kinds = collections.Counter()
        for _ in range(400):
            if not eng.queue and all(s is None for s in eng.slots):
                break
            if split:
                pending = eng.dispatch_step()
                assert isinstance(pending, PendingStep)
                kinds[pending.kind] += 1
                eng.commit_step(pending)
            else:
                eng.step()
        return [r.out_tokens for r in reqs], kinds

    geom = dict(batch_size=2, cache_len=64, page_size=8, **kw)
    want, _ = run(JEngine(jq, jp, jcfg, ops="ref", **geom), JRequest, False)
    got, kinds = run(_engine(setup, **geom), Request, True)
    assert got == want
    assert kinds["verify" if kw.get("spec_k") else "decode"] > 0
    assert got == run(_engine(setup, **geom), Request, False)[0]


def test_step_in_flight_guards_lifecycle_ops(setup):
    eng = _engine(setup, batch_size=2)
    sess = eng.submit(Request(uid=0, prompt=[3, 1, 4], max_new_tokens=8))
    other = eng.submit(Request(uid=1, prompt=[5, 9, 2], max_new_tokens=8))
    eng.step()                                  # both prefilled, decoding
    pending = eng.dispatch_step()
    assert pending.kind == "decode" and pending.live == [0, 1]
    with pytest.raises(StepInFlight):
        eng.evict(sess)
    with pytest.raises(StepInFlight):
        eng.preempt(other)
    with pytest.raises(StepInFlight):
        eng.dispatch_step()
    eng.commit_step(pending)
    eng.evict(sess)                             # legal again after commit
    eng.preempt(other)
    with pytest.raises(StepInFlight):           # a stale pending step
        eng.commit_step(pending)
    idle = _engine(setup, batch_size=2).dispatch_step()
    assert idle.kind == "idle" and idle.occupied == 0


def test_dispatch_leaves_its_inputs_in_fixed_buffers(setup):
    """Every step's host inputs land in the device buffers allocated at
    construction: the same tensors (addresses) step after step."""
    eng = _engine(setup, batch_size=2, spec_k=2, prefill_chunk=8,
                  page_size=8)
    ptrs = {k: v.data_ptr() for k, v in eng._bufs.items()}
    assert set(ptrs) == {"toks", "pos", "pages", "chunk_toks",
                         "chunk_base", "chunk_pages", "verify_toks",
                         "n_new", "rows"}
    for i, p in enumerate(_prompts(3)):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=5))
    pending = eng.dispatch_step()
    assert pending.kind == "verify"
    assert eng._bufs["pos"].tolist() == [int(x) for x in eng.pos]
    eng.commit_step(pending)
    eng.run_until_done()
    assert {k: v.data_ptr() for k, v in eng._bufs.items()} == ptrs


def test_dropped_engine_is_freed_without_the_cycle_collector(setup):
    gc.collect()
    gc.disable()
    try:
        eng = _engine(setup, batch_size=2)
        assert eng.prefix is not None
        ref = weakref.ref(eng)
        eng.submit(Request(uid=0, prompt=[3, 1, 4], max_new_tokens=2))
        eng.run_until_done()
        del eng
        assert ref() is None
    finally:
        gc.enable()


def test_reclaim_hook_still_evicts_prefix_pages(setup):
    """The weak hook still reclaims: a pool too small for two prompts
    evicts the first prompt's cached prefix to admit the second."""
    eng = _engine(setup, batch_size=1, page_size=8, num_pages=4)
    a = Request(uid=0, prompt=[1] * 17, max_new_tokens=1)
    b = Request(uid=1, prompt=[2] * 17, max_new_tokens=1)
    eng.submit(a)
    eng.run_until_done()
    assert eng.prefix.stats()["entries"] > 0
    eng.submit(b)
    eng.run_until_done()
    assert b.done and eng.prefix.stats()["evictions"] > 0


# ------------------------------------------------------- front end ------

@pytest.mark.parametrize("mode", ["paged", "contiguous"])
@pytest.mark.parametrize("spec_k", [0, 2])
def test_16_concurrent_streams_match_reference_frontend(setup, mode,
                                                        spec_k):
    """16 requests streamed at once through the port's front end == the
    JAX front end's streams, request by request."""
    jcfg, _, jq, jp, _, _ = setup
    prompts = _prompts(16)

    async def serve(fe):
        runner = asyncio.create_task(fe.run())
        handles = [fe.submit(p, MAX_NEW) for p in prompts]
        streams = await asyncio.gather(*[h.result() for h in handles])
        fe.close()
        await runner
        return handles, streams

    kw = dict(cache_mode=mode, spec_k=spec_k)
    jfe = JFrontend(JEngine(jq, jp, jcfg, batch_size=4, cache_len=64,
                            ops="ref", **kw), max_pending=32)
    _, want = asyncio.run(serve(jfe))
    fe = _frontend(setup, max_pending=32, **kw)
    handles, got = asyncio.run(serve(fe))
    assert got == want
    assert all(h.terminal == "completed" for h in handles)
    d = fe.describe()
    assert d["terminal"]["completed"] == 16
    assert d["pending"] == 0 and d["submitted"] == 16
    assert d["tokens"] == jfe.describe()["tokens"] == 16 * MAX_NEW
    if fe.engine.paged:
        _check_refcounts(fe.engine, [h.session for h in handles])


def test_streaming_is_incremental(setup):
    async def main():
        fe = _frontend(setup, batch_size=2)
        h = fe.submit([3, 1, 4], max_new_tokens=6)
        runner = asyncio.create_task(fe.run())
        states = []
        async for _ in h.stream():
            states.append(h.state)
        fe.close()
        await runner
        return states

    states = asyncio.run(main())
    assert len(states) == 6 and states[0] == "active"


def test_cancel_mid_decode_releases_pages_exactly(setup):
    async def main():
        fe = _frontend(setup, batch_size=2, page_size=8)
        victim = fe.submit([9, 9, 2], max_new_tokens=32)
        keeper = fe.submit([3, 1, 4], max_new_tokens=6)
        while victim.metrics.n_tokens < 2:
            await fe.step()
        assert victim.state == "active"
        victim.cancel()
        await fe.step()
        assert victim.terminal == "cancelled"
        while await fe.step():
            pass
        return fe, victim, keeper, await keeper.result()

    fe, victim, keeper, keep = asyncio.run(main())
    assert 2 <= len(victim.tokens) < 32
    assert victim.tokens == _solo(setup, [9, 9, 2], 32)[:len(victim.tokens)]
    assert keep == _solo(setup, [3, 1, 4], 6)
    assert keeper.terminal == "completed"
    _check_refcounts(fe.engine, [victim.session, keeper.session])


def test_cancel_mid_prefill_releases_pages_exactly(setup):
    prompt = [int(t) for t in np.random.default_rng(11).integers(1, 100, 40)]

    async def main():
        fe = _frontend(setup, batch_size=2, page_size=8, prefill_chunk=8,
                       prefill_budget=4, prefix_cache=False)
        h = fe.submit(prompt, max_new_tokens=4)
        await fe.step()
        assert h.state == "prefilling"
        assert fe.engine.kv.allocator.used_pages > 0
        h.cancel()
        await fe.step()
        return fe, h

    fe, h = asyncio.run(main())
    assert h.terminal == "cancelled" and h.tokens == []
    assert fe.engine.kv.allocator.used_pages == 0
    _check_refcounts(fe.engine, [h.session])


def test_cancel_queued_request_never_admitted(setup):
    async def main():
        fe = _frontend(setup, batch_size=2)
        hogs = [fe.submit([7 + i, 5], max_new_tokens=8) for i in range(2)]
        queued = fe.submit([1, 2, 3], max_new_tokens=4)
        await fe.step()
        assert queued.state == "queued"
        queued.cancel()
        await fe.step()
        assert queued.terminal == "cancelled"
        while await fe.step():
            pass
        return fe, hogs, queued

    fe, hogs, queued = asyncio.run(main())
    assert queued.tokens == [] and queued.metrics.admit_t is None
    assert all(h.terminal == "completed" for h in hogs)
    _check_refcounts(fe.engine,
                     [h.session for h in hogs] + [queued.session])


def test_deadline_expiry_times_out(setup):
    """A deadline on an injected clock: no real waiting."""
    t = [0.0]

    async def main():
        fe = _frontend(setup, batch_size=2, clock=lambda: t[0])
        slow = fe.submit([9, 9, 2], max_new_tokens=48, deadline_s=5.0)
        fast = fe.submit([3, 1, 4], max_new_tokens=6)
        while slow.metrics.n_tokens < 1:
            await fe.step()
        t[0] = 4.9
        await fe.step()
        assert slow.terminal is None
        t[0] = 5.0
        await fe.step()
        assert slow.terminal == "timeout"
        while await fe.step():
            pass
        return fe, slow, fast

    fe, slow, fast = asyncio.run(main())
    assert 1 <= len(slow.tokens) < 48
    assert fast.terminal == "completed"
    assert fast.tokens == _solo(setup, [3, 1, 4], 6)
    _check_refcounts(fe.engine, [slow.session, fast.session])
    assert fe.describe()["terminal"]["timeout"] == 1
    with pytest.raises(ValueError, match="deadline_s"):
        fe.submit([1, 2], 2, deadline_s=0)


def test_queue_full_backpressure(setup):
    async def main():
        fe = _frontend(setup, batch_size=2, max_pending=3)
        handles = [fe.submit([5 + i, 9], max_new_tokens=2)
                   for i in range(3)]
        with pytest.raises(QueueFull) as exc:
            fe.submit([1, 2], max_new_tokens=2)
        assert exc.value.max_pending == 3 and exc.value.pending == 3
        while await fe.step():
            pass
        late = fe.submit([1, 2], max_new_tokens=2)
        while await fe.step():
            pass
        return fe, handles, late

    fe, handles, late = asyncio.run(main())
    assert all(h.terminal == "completed" for h in handles + [late])
    d = fe.describe()
    assert d["terminal"]["rejected"] == 1 and d["submitted"] == 5
    assert sum(d["terminal"].values()) == d["submitted"]
    with pytest.raises(ValueError, match="max_pending"):
        ServingFrontend(fe.engine, max_pending=0)


def test_infeasible_request_rejected_at_submit(setup):
    fe = _frontend(setup, batch_size=2, cache_len=32)
    with pytest.raises(RequestInfeasible, match="exceeds the"):
        fe.submit([1] * 8, max_new_tokens=64)
    assert fe.describe()["terminal"]["rejected"] == 1
    eng = _engine(setup, batch_size=2, cache_len=32)
    with pytest.raises(RequestInfeasible):
        eng.submit(Request(uid=0, prompt=[1] * 8, max_new_tokens=64))
    h = fe.submit([1] * 8, max_new_tokens=32 - 8 + 1)
    assert h.state == "queued"
    with pytest.raises(RequestInfeasible):
        fe.submit([1] * 8, max_new_tokens=32 - 8 + 2)
    with pytest.raises(RequestInfeasible, match="empty prompt"):
        fe.submit([], max_new_tokens=4)


def test_never_fits_pool_rejected_at_frontend_submit(setup):
    fe = _frontend(setup, batch_size=2, cache_len=64, page_size=8,
                   num_pages=4)                 # 3 usable pages
    with pytest.raises(RequestInfeasible, match="pages but the pool"):
        fe.submit([1] * 30, max_new_tokens=2)
    h = fe.submit([1] * 20, max_new_tokens=2)
    assert h.state == "queued"


def test_frontend_stall_detection_raises_typed(setup):
    fe = _frontend(setup, batch_size=2, stall_steps=2)
    fe.submit([3, 1, 4], max_new_tokens=2)
    stamp = fe._progress_stamp()
    fe._check_stall(stamp)
    with pytest.raises(EngineStalled) as exc:
        fe._check_stall(stamp)
    assert exc.value.max_steps == 2 and exc.value.queue_depth == 1


def test_describe_keys_and_metrics(setup):
    async def main():
        fe = _frontend(setup, batch_size=2, max_pending=4, spec_k=2)
        handles = [fe.submit(p, MAX_NEW) for p in _prompts(4)]
        runner = asyncio.create_task(fe.run())
        await asyncio.gather(*[h.result() for h in handles])
        fe.close()
        await runner
        return fe, handles

    fe, handles = asyncio.run(main())
    d = fe.describe()
    assert set(d) == {"max_pending", "pending", "submitted", "accepted",
                      "terminal", "steps", "tokens", "occupancy",
                      "queue_depth", "latency"}
    assert tuple(d["terminal"]) == TERMINAL_STATES
    for metric in ("ttft_s", "inter_token_s", "queue_wait_s"):
        p = d["latency"][metric]
        assert set(p) == {"n", "mean", "p50", "p99"}
        assert p["n"] > 0 and p["p50"] <= p["p99"] and p["mean"] >= 0
    assert d["occupancy"]["max"] <= fe.engine.batch
    assert d["queue_depth"]["max"] >= 2
    assert sum(d["terminal"].values()) + d["pending"] == d["submitted"]
    for h in handles:
        m = h.metrics
        assert m.ttft_s is not None and m.queue_wait_s <= m.ttft_s
        assert m.tbt_s is not None and m.n_tokens == MAX_NEW
    e = fe.engine.describe()
    assert {"ops", "backends", "device", "spec", "prefill", "fold_wo",
            "batch", "cache_len", "cache"} <= set(e)
    assert set(e["spec"]) == {"k", "mode", "drafted", "accepted",
                              "accept_rate", "wasted"}
