"""The int4 KV page tier (``kv_dtype="int4"``) == the JAX package, bit for
bit.

  * ``ops.packed``'s KV functions against ``repro.ops.packed`` on every
    int8 value and on random bytes, and a numpy model of the kernels'
    in-register unpack (``csrc/int_common.cuh``: one byte permute, a
    bytewise sign extension, a masked word shift) against
    ``unpack_kv_pool`` on every 16-bit pattern;
  * K3's and K4's plain versions with ``kv_shifts`` against the Pallas
    kernels in interpret mode: D 32 and 120, folded and not, 1 and 4
    query rows, pool bytes drawn from all 256 values, per-page shifts
    0..7 that differ between K and V, a lane mapped to the null page;
  * ``init_decode_cache``, ``CacheLayout.fit``'s doubled page count and
    the engine's ``kv_bytes`` against the JAX engine's, and the
    refusals (int4 needs the paged layout and an even head dim);
  * ``ServingEngine(kv_dtype="int4")`` token streams equal to the JAX
    engine's: reduced llama3-8b with chunked prefill, prefix sharing and
    preemption on ``torch_ref`` and ``cuda``, reduced h2o-danube-3-4b
    (paged) past the window's wrap, and ``cuda_online`` against JAX
    ``ops="pallas"``.

The ``cuda`` backend runs its kernels' plain versions here (CPU tensors);
its dispatch of packed pools is the code under test.  Tolerance: 0.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as j_get_config
from repro.core import attention as j_attn
from repro.kernels.int_attention_fused import \
    int_paged_prefill_fused as j_k4
from repro.kernels.int_decode_attention import \
    int_decode_attention_fused as j_k3
from repro.models import inttransformer as jit_
from repro.models import model as JM
from repro.models import transformer as jtf
from repro.ops import RequantSpec as JSpec
from repro.ops import packed as jpk
from repro.quant import convert as j_convert
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving.kvcache import CacheLayout as JLayout
from repro_torch import kernels
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.interop import from_reference, plan_from_reference
from repro_torch.kernels.int_attention_fused import (
    int_paged_prefill_fused, int_paged_prefill_plain)
from repro_torch.kernels.int_decode_attention import (
    int_decode_attention_fused, int_decode_attention_plain)
from repro_torch.models import intlayers as til
from repro_torch.models import inttransformer as tit
from repro_torch.models import model as TM
from repro_torch.ops import packed as tpk
from repro_torch.ops import resolve_ops
from repro_torch.ops.spec import QuantLinearParams
from repro_torch.ops.spec import RequantSpec as TSpec
from repro_torch.serving import Request as TRequest
from repro_torch.serving import ServingEngine as TEngine
from repro_torch.serving.kvcache import CacheLayout as TLayout

T = torch.as_tensor


def _j(x):
    return np.asarray(x)


# ------------------------------------------------------------ ops.packed --

@pytest.mark.parametrize("shift", range(8))
def test_pack_kv_on_every_int8_value(shift):
    v8 = np.arange(-128, 128, dtype=np.int8).reshape(4, 64)
    assert np.array_equal(tpk.quantize_kv(T(v8), shift).numpy(),
                          _j(jpk.quantize_kv(jnp.asarray(v8), shift)))
    assert np.array_equal(tpk.pack_kv(T(v8), shift).numpy(),
                          _j(jpk.pack_kv(jnp.asarray(v8), shift)))


def test_nibbles_and_unpack_kv_pool_on_random_bytes():
    rng = np.random.default_rng(0)
    for axis in (-1, -2, 0):
        a = rng.integers(-8, 8, (4, 6, 8)).astype(np.int32)
        assert np.array_equal(tpk.nibble_pack(T(a), axis).numpy(),
                              _j(jpk.nibble_pack(jnp.asarray(a), axis)))
        p = rng.integers(-128, 128, (4, 6, 8)).astype(np.int8)
        assert np.array_equal(tpk.nibble_unpack(T(p), axis).numpy(),
                              _j(jpk.nibble_unpack(jnp.asarray(p), axis)))
    pool = rng.integers(-128, 128, (9, 4, 2, 16)).astype(np.int8)
    shifts = np.array([0, 1, 2, 3, 4, 5, 6, 7, 4], np.int32)
    got = tpk.unpack_kv_pool(T(pool), T(shifts))
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), _j(jpk.unpack_kv_pool(
        jnp.asarray(pool), jnp.asarray(shifts))))


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint64 arrays holding 32-bit words."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
          [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def _kv4_shift(n, s):
    v = n | (((n & 0x08080808) * 0x1E) & 0xFFFFFFFF)
    su = min(s, 8) if s >= 0 else 8
    mask = ((0xFF << su) & 0xFF) * 0x01010101
    return ((v << su) & 0xFFFFFFFF) & mask


def test_kernel_unpack_model_matches_unpack_kv_pool():
    """``unpack_kv4`` / ``unpack_kv4x2`` (csrc/int_common.cuh) modelled in
    numpy on every 16-bit pattern and every shift the tier can hold
    (and 8, 9, 31, where the low byte of ``q4 << s`` is 0)."""
    p = np.arange(1 << 16, dtype=np.uint64)
    bytes2 = np.stack([p & 0xFF, p >> 8], -1).astype(np.uint8)
    pool = bytes2.view(np.int8).reshape(-1, 1, 1, 2)
    w = (p | (p[::-1] << 16)).astype(np.uint64)        # 4-byte units
    pool4 = np.stack([(w >> (8 * i)) & 0xFF for i in range(4)],
                     -1).astype(np.uint8).view(np.int8).reshape(-1, 1, 1, 4)
    for s in (*range(8), 8, 9, 31):
        shift = T(np.full(pool.shape[0], s, np.int32))
        want = tpk.unpack_kv_pool(T(pool), shift).numpy().reshape(-1, 4)
        lo, hi = p & 0x0F0F, (p >> 4) & 0x0F0F
        word = _kv4_shift(_byte_perm(lo, hi, 0x5140), s)
        got = np.stack([(word >> (8 * i)) & 0xFF for i in range(4)],
                       -1).astype(np.uint8).view(np.int8)
        assert np.array_equal(got, want), s
        want8 = tpk.unpack_kv_pool(T(pool4), shift).numpy().reshape(-1, 8)
        lo, hi = w & 0x0F0F0F0F, (w >> 4) & 0x0F0F0F0F
        words = [_kv4_shift(_byte_perm(lo, hi, sel), s)
                 for sel in (0x5140, 0x7362)]
        got8 = np.stack([(wd >> (8 * i)) & 0xFF for wd in words
                         for i in range(4)], -1).astype(np.uint8).view(np.int8)
        assert np.array_equal(got8, want8), s


# ------------------------------------------------------- K3 / K4 plain ----

def _wo(rng, h, d, n_out):
    w = rng.integers(-127, 128, (h * d, n_out)).astype(np.int8)
    bias = rng.integers(-500, 500, (n_out,)).astype(np.int32)
    bv = rng.integers(1000, 30000, (n_out,)).astype(np.int32)
    jw = dict(wo_w8=jnp.asarray(w), wo_bias32=jnp.asarray(bias),
              wo_b_vec=jnp.asarray(bv),
              wo_spec=JSpec.per_channel(c=28, pre=7, out_bits=14))
    tw = dict(wo=QuantLinearParams(T(w), T(bv), T(bias)),
              wo_spec=TSpec.per_channel(c=28, pre=7, out_bits=14))
    return jw, tw


def _packed_case(d, sq, seed):
    """Four lanes over packed pools of 16-row pages: lane 1 mapped to the
    null page, K and V shifts drawn per page from 0..7 (independently),
    pool bytes from all 256 values."""
    rng = np.random.default_rng(seed)
    b, h, hkv, ps, maxp = 4, 4, 2, 16, 3
    num_pages = b * maxp + 1
    jplan = j_attn.make_iattention(d, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    q8 = rng.integers(-127, 128, (b, sq, h, d)).astype(np.int8)
    kp, vp = (rng.integers(-128, 128, (num_pages, ps, hkv, d // 2))
              .astype(np.int8) for _ in range(2))
    ks, vs = (rng.integers(0, 8, num_pages).astype(np.int32)
              for _ in range(2))
    pages = (rng.permutation(num_pages - 1) + 1).astype(np.int32) \
        .reshape(b, maxp)
    pages[1] = 0
    vl = np.array([sq, 29, 40, 48], np.int32)
    return rng, jplan, plan_from_reference(jplan), (q8, kp, vp, vl, pages,
                                                    ks, vs, ps)


@pytest.mark.parametrize("d", [32, 120])
@pytest.mark.parametrize("sq", [1, 4])
@pytest.mark.parametrize("fold", [False, True])
def test_k3_packed_plain_matches_pallas(d, sq, fold):
    rng, jplan, tplan, (q8, kp, vp, vl, pages, ks, vs, ps) = \
        _packed_case(d, sq, 3 * d + sq + fold)
    jw, tw = _wo(rng, 4, d, 40) if fold else ({}, {})
    want = j_k3(jnp.asarray(q8), jnp.asarray(kp), jnp.asarray(vp), jplan,
                jnp.asarray(vl), requant=JSpec.per_tensor(jplan.dn_out),
                bkv=16, interpret=True, pages=jnp.asarray(pages),
                page_size=ps, kv_shifts=(jnp.asarray(ks), jnp.asarray(vs)),
                **jw)
    args = (T(q8), T(kp), T(vp), tplan, T(vl))
    kw = dict(pages=T(pages), page_size=ps, kv_shifts=(T(ks), T(vs)), **tw)
    got = int_decode_attention_plain(*args, **kw)
    assert np.array_equal(got.numpy(), _j(want))
    kernels.reset_launches()
    ops_kw = dict(kw, requant=TSpec.per_tensor(tplan.dn_out))
    for out in (int_decode_attention_fused(*args, **kw),
                resolve_ops("cuda").int_decode_attention(*args, **ops_kw),
                resolve_ops("torch_ref").int_decode_attention(*args,
                                                              **ops_kw)):
        assert torch.equal(out, got)
    assert kernels.LAUNCHES["int_decode_attention_kv4"] == 0  # CPU
    with pytest.raises(ValueError, match="paged"):
        int_decode_attention_plain(*args, kv_shifts=(T(ks), T(vs)))


@pytest.mark.parametrize("d", [32, 120])
@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("fold", [False, True])
def test_k4_packed_plain_matches_pallas(d, c, fold):
    rng, jplan, tplan, (q8, kp, vp, vl, pages, ks, vs, ps) = \
        _packed_case(d, c, 5 * d + c + fold)
    jw, tw = _wo(rng, 4, d, 40) if fold else ({}, {})
    want = j_k4(jnp.asarray(q8), jnp.asarray(kp), jnp.asarray(vp), jplan,
                jnp.asarray(vl), jnp.asarray(pages), ps,
                requant=JSpec.per_tensor(jplan.dn_out), bq=c, bkv=16,
                interpret=True, kv_shifts=(jnp.asarray(ks), jnp.asarray(vs)),
                **jw)
    args = (T(q8), T(kp), T(vp), tplan, T(vl), T(pages), ps)
    kw = dict(kv_shifts=(T(ks), T(vs)), **tw)
    got = int_paged_prefill_plain(*args, **kw)
    assert np.array_equal(got.numpy(), _j(want))
    assert torch.equal(int_paged_prefill_fused(*args, **kw), got)


# ----------------------------------------------------- caches and engine --

def _quantized(arch, **over):
    over = {"dtype": "float32", **over}
    jcfg = JM.reduce_config(j_get_config(arch), **over)
    tcfg = TM.reduce_config(t_get_config(arch), **over)
    params = jtf.init_params(jax.random.key(0), jcfg)
    jq, jp = j_convert.quantize_params(params, jcfg)
    tq, tp = from_reference(jax.tree.map(np.array, jq), jp, device="cpu")
    return jcfg, tcfg, jq, jp, tq, tp


@pytest.fixture(scope="module")
def llama():
    return _quantized("llama3-8b", capacity_factor=8.0)


def test_init_decode_cache_and_layout_match_reference(llama):
    jcfg, tcfg, *_ = llama
    for args in ((3, 64, 16), (2, 40, 8, 11)):
        jl = JLayout.fit(*args, kv_dtype="int4")
        tl = TLayout.fit(*args, kv_dtype="int4")
        assert (tl.num_pages, tl.bytes_per_element, tl.capacity_tokens) == \
            (jl.num_pages, jl.bytes_per_element, jl.capacity_tokens)
        if len(args) == 3:
            assert tl.num_pages - 1 == \
                2 * (TLayout.fit(*args).num_pages - 1)
        jc = jit_.init_decode_cache(jcfg, args[0], args[1], layout=jl)
        tc = tit.init_decode_cache(tcfg, tl, device="cpu")
        assert len(tc) == len(jc)
        for t, j in zip(tc, jc):
            assert sorted(t) == sorted(k for k in j if j[k] is not None)
            for key in t:
                assert tuple(t[key].shape) == j[key].shape, key
                assert np.array_equal(t[key].numpy(), _j(j[key])), key
            assert t["k8"].dtype == torch.int8
            assert t["k_shift"].dtype == torch.int32
    odd = dataclasses.replace(tcfg, head_dim=9)
    with pytest.raises(ValueError, match="even"):
        tit.init_decode_cache(odd, TLayout.fit(2, 32, 16, kv_dtype="int4"),
                              device="cpu")


def test_int4_needs_the_paged_layout(llama):
    _, tcfg, _, _, tq, tp = llama
    with pytest.raises(ValueError, match="paged"):
        TEngine(tq, tp, tcfg, device="cpu", cache_mode="contiguous",
                kv_dtype="int4")
    cache = tit.init_decode_cache(tcfg, TLayout.fit(2, 32, 16,
                                                    kv_dtype="int4"),
                                  device="cpu")[0]
    view = {k: v[0] for k, v in cache.items()}
    x8 = torch.zeros((2, 1, tcfg.d_model), dtype=torch.int8)
    layer = tq["layers"][0]["attn"]
    one = {k: (v[0] if not isinstance(v, QuantLinearParams) else
               QuantLinearParams(*[None if t is None else t[0] for t in v]))
           for k, v in layer.items()}
    with pytest.raises(ValueError, match="paged"):
        til.int_attn_decode(one, x8, view, torch.zeros(2, dtype=torch.int32),
                            tp.attn, tcfg, ops="torch_ref")


RNG = np.random.default_rng(7)
PROMPTS = [list(map(int, RNG.integers(1, 64, n))) for n in (40, 3, 25, 33)]


def _streams(eng, Request):
    """Staggered shared-prefix sessions, a preemption mid-prefill, then
    the rest of the prompts through two recycled lanes."""
    a = Request(uid=0, prompt=list(PROMPTS[0]), max_new_tokens=4)
    eng.submit(a)
    eng.step()
    b = Request(uid=1, prompt=list(PROMPTS[0]), max_new_tokens=4)
    eng.submit(b)
    c = Request(uid=2, prompt=list(PROMPTS[2]), max_new_tokens=3)
    sc = eng.submit(c)
    eng.step()
    if sc.state in ("prefilling", "active"):
        eng.preempt(sc)
    rest = [Request(uid=3 + i, prompt=list(p), max_new_tokens=4)
            for i, p in enumerate(PROMPTS[1:4:2])]
    for r in rest:
        eng.submit(r)
    eng.run_until_done()
    return [r.out_tokens for r in (a, b, c, *rest)]


def _cache_stats(eng):
    c = eng.describe()["cache"]
    return {k: c[k] for k in ("kv_pack", "num_pages", "pages_used",
                              "shared_pages", "cow_copies", "kv_bytes")}


@pytest.mark.parametrize("backend", ["torch_ref", "cuda"])
def test_engine_int4_streams_match_reference(llama, backend):
    """Chunked prefill (chunk 8, budget 8), prefix sharing with
    copy-on-write, preemption: streams, allocator refcounts and the
    cache's statistics (its packed bytes) equal the JAX engine's."""
    jcfg, tcfg, jq, jp, tq, tp = llama
    kw = dict(batch_size=2, cache_len=64, prefill_chunk=8, prefill_budget=8,
              kv_dtype="int4")
    jeng = JEngine(jq, jp, jcfg, ops="ref", **kw)
    want = _streams(jeng, JRequest)
    teng = TEngine(tq, tp, tcfg, ops=backend, device="cpu", **kw)
    assert _streams(teng, TRequest) == want
    assert np.array_equal(teng.kv.allocator.refcount,
                          jeng.kv.allocator.refcount)
    assert _cache_stats(teng) == _cache_stats(jeng)
    assert _cache_stats(teng)["kv_pack"] == "int4"
    assert _cache_stats(teng)["cow_copies"] > 0
    assert teng.caches[0]["k8"].shape[-1] == tcfg.hd // 2
    assert _cache_stats(teng)["kv_bytes"] == sum(
        c[k].numel() for c in teng.caches for k in ("k8", "v8"))
    assert ", int4, " in teng.describe_str()
    for tc, jc in zip(teng.caches, jeng.caches):
        for key in ("k8", "v8", "k_shift", "v_shift"):
            t, j = tc[key].numpy(), _j(jc[key])
            assert np.array_equal(t[:, 1:], j[:, 1:]), key


def test_engine_int4_window_wrap_matches_reference():
    """Reduced h2o-danube-3-4b (window 64, one layer), paged int4 pools,
    token-streaming prefill, 70 new tokens a lane: decode positions wrap
    (slot = pos % 64), folded and not."""
    jcfg, tcfg, jq, jp, tq, tp = _quantized("h2o-danube-3-4b", vocab=128,
                                            num_layers=1)
    assert jcfg.window == 64

    def streams(eng, Request):
        reqs = [Request(uid=i, prompt=[1 + i, 7, 3], max_new_tokens=70)
                for i in range(2)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done(max_steps=300)
        assert all(r.done for r in reqs)
        return [r.out_tokens for r in reqs]

    kw = dict(batch_size=2, cache_len=80, kv_dtype="int4")
    want = streams(JEngine(jq, jp, jcfg, ops="ref", **kw), JRequest)
    assert len(want[0]) == 70
    for fold in (True, False):
        eng = TEngine(tq, tp, tcfg, ops="cuda", device="cpu", fold_wo=fold,
                      **kw)
        assert streams(eng, TRequest) == want, fold


def test_engine_int4_cuda_online_matches_reference_pallas(llama):
    """``cuda_online`` (K3 / K4 over the packed pools) against the JAX
    ``pallas`` backend, which has no packed capability and reads the
    pools dequantized."""
    jcfg, tcfg, jq, jp, tq, tp = llama
    prompts = [list(PROMPTS[0][:20]), [5, 9, 11]]

    def streams(eng, Request):
        reqs = [Request(uid=i, prompt=list(p), max_new_tokens=3)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        return [r.out_tokens for r in reqs]

    kw = dict(batch_size=2, cache_len=32, prefill_chunk=16, kv_dtype="int4")
    want = streams(JEngine(jq, jp, jcfg, ops="pallas", **kw), JRequest)
    eng = TEngine(tq, tp, tcfg, ops="cuda_online", device="cpu", **kw)
    assert eng.ops.backend_for("int_paged_prefill").packed_kv
    assert streams(eng, TRequest) == want
