"""The four ported kernels' plain versions == the JAX Pallas kernels.

Each plain PyTorch version (what the ``cuda`` wrappers run on CPU
tensors, and what ``chip_smoke.py`` holds the CUDA kernels against on
the card) is compared with its Pallas kernel run in interpret mode, the
way the JAX suite runs it on the CPU: K1 in all three epilogue forms, K2
for RMSNorm and LayerNorm, K3/K4 paged with ragged valid_len, fold on
and off.  Tolerance: 0.  The CUDA launches themselves are exercised by
the ``gpu``-marked tests of ``test_torch_gpu.py``, which skip without a
card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import attention as j_attn
from repro.core import norms as j_norms
from repro.core.dyadic import fit_dyadic as j_fit
from repro.kernels.int8_matmul import int8_matmul_pallas
from repro.kernels.int_attention_fused import int_paged_prefill_fused
from repro.kernels.int_decode_attention import int_decode_attention_fused
from repro.kernels.int_layernorm import int_layernorm_pallas
from repro.kernels.ref import ref_int_paged_prefill as j_ref_prefill
from repro.ops import RequantSpec as JSpec
from repro_torch import kernels
from repro_torch.core.dyadic import fit_dyadic as t_fit
from repro_torch.interop import plan_from_reference
from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_plain
from repro_torch.kernels.int_attention_fused import (
    int_paged_prefill_fused as t_prefill, int_paged_prefill_plain)
from repro_torch.kernels.int_decode_attention import (
    int_decode_attention_fused as t_decode, int_decode_attention_plain)
from repro_torch.kernels.int_layernorm import (int_layernorm,
                                               int_layernorm_plain)
from repro_torch.kernels.ref import ref_int_paged_prefill as t_ref_prefill
from repro_torch.ops import resolve_ops
from repro_torch.ops.spec import QuantLinearParams
from repro_torch.ops.spec import RequantSpec as TSpec

T = torch.as_tensor


def _i8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _specs(form, out_bits):
    """The same epilogue as a JAX and a port RequantSpec."""
    if form == "raw":
        return JSpec.raw(), TSpec.raw()
    if form == "per_tensor":
        args = (1 / 3000.0, 64 * 127 * 127)
        return (JSpec.per_tensor(j_fit(*args), out_bits),
                TSpec.per_tensor(t_fit(*args), out_bits))
    return (JSpec.per_channel(24, 10, out_bits),
            TSpec.per_channel(24, 10, out_bits))


# ------------------------------------------------------------------ K1 ----

@pytest.mark.parametrize("form,out_bits,bias", [
    ("per_channel", 8, False), ("per_channel", 11, True),
    ("per_channel", 14, False), ("per_tensor", 8, True),
    ("per_tensor", 14, False), ("raw", 32, True)])
def test_int8_matmul_plain_matches_pallas(form, out_bits, bias):
    rng = np.random.default_rng(1)
    m, k, n = 8, 64, 48
    x8, w8 = _i8(rng, (m, k)), _i8(rng, (k, n))
    b32 = rng.integers(-5000, 5000, (n,)).astype(np.int32) if bias else None
    bvec = rng.integers(256, 4096, (n,)).astype(np.int32)
    js, ts = _specs(form, out_bits)
    kw = {}
    if form == "per_tensor":
        kw = dict(dn=js.dn)
    elif form == "per_channel":
        kw = dict(b_vec=jnp.asarray(bvec), c=js.c, pre=js.pre)
    want = int8_matmul_pallas(
        jnp.asarray(x8), jnp.asarray(w8),
        None if b32 is None else jnp.asarray(b32), out_bits=out_bits,
        out_dtype=jnp.int32 if js.is_raw else js.out_dtype,
        bm=8, bn=16, bk=32, interpret=True, **kw)
    got = int8_matmul_plain(T(x8), T(w8), ts,
                            None if b32 is None else T(b32), T(bvec))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == (torch.int32 if ts.is_raw else ts.out_dtype)


# ------------------------------------------------------------------ K2 ----

@pytest.mark.parametrize("layernorm", [False, True])
def test_int_layernorm_plain_matches_pallas(layernorm):
    rng = np.random.default_rng(2)
    d, qmax = 128, 1 << 13
    jp = j_norms.make_inorm(d, 2.0 ** -9, qmax, 2 / 127, 8 / 127,
                            subtract_mean=layernorm)
    tp = plan_from_reference(jp)
    q = rng.integers(-qmax, qmax + 1, (6, d)).astype(np.int32)
    q[0] = 77                                     # sigma == 0 row
    g = rng.integers(-127, 128, (d,)).astype(np.int32)
    b = rng.integers(-9000, 9000, (d,)).astype(np.int32) \
        if layernorm else None
    want = int_layernorm_pallas(jnp.asarray(q), jnp.asarray(g),
                                None if b is None else jnp.asarray(b), jp,
                                interpret=True)
    got = int_layernorm_plain(T(q), T(g), None if b is None else T(b), tp)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["roberta-base", "h2o-danube-3-4b",
                                  "llama3-8b"])
def test_int_layernorm_plain_matches_pallas_full_width(arch):
    """K2 at the full widths the paths run, with the plans the configs
    build: roberta-base's LayerNorm + beta at d = 768, h2o-danube-3-4b's
    and llama3-8b's RMSNorm at 3840 and 4096; a random row, +-qmax_res,
    a constant row (sigma 0) and alternating +-qmax_res."""
    from repro.configs.registry import get_config
    from repro.quant.plans import build_layer_plans
    cfg = get_config(arch)
    jp = build_layer_plans(cfg).norm
    assert jp.subtract_mean == (arch == "roberta-base")
    d, qmax = cfg.d_model, cfg.qmax_res
    rng = np.random.default_rng(d)
    q = rng.integers(-qmax, qmax + 1, (5, d)).astype(np.int32)
    q[1], q[2], q[3] = qmax, -qmax, 77
    q[4] = np.where(np.arange(d) % 2 == 0, qmax, -qmax)
    g = rng.integers(-127, 128, (d,)).astype(np.int32)
    b = rng.integers(-9000, 9000, (d,)).astype(np.int32) \
        if jp.subtract_mean else None
    want = int_layernorm_pallas(jnp.asarray(q), jnp.asarray(g),
                                None if b is None else jnp.asarray(b), jp,
                                interpret=True)
    got = int_layernorm_plain(T(q), T(g), None if b is None else T(b),
                              plan_from_reference(jp))
    assert np.array_equal(got.numpy(), np.asarray(want))


# -------------------------------------------------------------- K3 / K4 ---

def _attn_setup(seed, b=3, h=4, hkv=2, d=32, ps=16, num_pages=13):
    rng = np.random.default_rng(seed)
    jp = j_attn.make_iattention(d, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    kp, vp = _i8(rng, (num_pages, ps, hkv, d)), _i8(rng, (num_pages, ps,
                                                           hkv, d))
    pages = np.array([[3, 7, 1, 0], [2, 4, 5, 6], [8, 9, 10, 12]][:b],
                     np.int32)
    return rng, jp, plan_from_reference(jp), kp, vp, pages


def _wo(rng, h, d, n_out):
    w = _i8(rng, (h * d, n_out))
    bias = rng.integers(-500, 500, (n_out,)).astype(np.int32)
    bv = rng.integers(1000, 30000, (n_out,)).astype(np.int32)
    js = JSpec.per_channel(c=28, pre=7, out_bits=14)
    ts = TSpec.per_channel(c=28, pre=7, out_bits=14)
    return (dict(wo_w8=jnp.asarray(w), wo_bias32=jnp.asarray(bias),
                 wo_b_vec=jnp.asarray(bv), wo_spec=js),
            dict(wo=QuantLinearParams(T(w), T(bv), T(bias)), wo_spec=ts))


@pytest.mark.parametrize("sq,fold,form", [(1, False, "per_tensor"),
                                          (1, True, "per_tensor"),
                                          (3, False, "per_channel"),
                                          (3, True, "per_tensor"),
                                          (1, False, "raw")])
def test_decode_attention_plain_matches_pallas(sq, fold, form):
    rng, jp, tp, kp, vp, pages = _attn_setup(3 + sq)
    b, h, d, ps = 3, 4, 32, 16
    q8 = _i8(rng, (b, sq, h, d))
    vl = np.array([5, 37, 64], np.int32)               # ragged, one full
    bvec = rng.integers(1000, 20000, (h * d,)).astype(np.int32)
    if form == "per_tensor":
        js = JSpec.per_tensor(jp.dn_out)
        ts = TSpec.per_tensor(tp.dn_out)
    elif form == "per_channel":
        js, ts = JSpec.per_channel(22, 8), TSpec.per_channel(22, 8)
    else:
        js, ts = JSpec.raw(), TSpec.raw()
    jw, tw = _wo(rng, h, d, 40) if fold else ({}, {})
    want = int_decode_attention_fused(
        jnp.asarray(q8), jnp.asarray(kp), jnp.asarray(vp), jp,
        jnp.asarray(vl), requant=js, b_vec=jnp.asarray(bvec), bkv=16,
        interpret=True, pages=jnp.asarray(pages), page_size=ps, **jw)
    got = int_decode_attention_plain(T(q8), T(kp), T(vp), tp, T(vl),
                                     T(pages), ps, requant=ts,
                                     b_vec=T(bvec), **tw)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fold", [False, True])
def test_paged_prefill_plain_matches_pallas(fold):
    rng, jp, tp, kp, vp, pages = _attn_setup(9)
    b, c, h, d, ps = 3, 32, 4, 32, 16
    q8 = _i8(rng, (b, c, h, d))
    base = np.array([0, 16, 23], np.int32)             # 23: unaligned
    pos_end = base + c
    jw, tw = _wo(rng, h, d, 40) if fold else ({}, {})
    want = int_paged_prefill_fused(
        jnp.asarray(q8), jnp.asarray(kp), jnp.asarray(vp), jp,
        jnp.asarray(pos_end), jnp.asarray(pages), ps, bkv=16,
        interpret=True, **jw)
    got = int_paged_prefill_plain(T(q8), T(kp), T(vp), tp, T(pos_end),
                                  T(pages), ps, **tw)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fold", [False, True])
def test_paged_prefill_oracle_matches_reference(fold):
    """The scatter-then-attend oracle: output and both pools (the null
    page aside) equal the reference's, page size 8, unaligned bases."""
    rng, jp, tp, kp, vp, _ = _attn_setup(13, ps=8, num_pages=25)
    b, c, h, hkv, d, ps = 3, 8, 4, 2, 32, 8
    pages = np.arange(1, 25, dtype=np.int32).reshape(b, 8)[:, ::-1].copy()
    q8 = _i8(rng, (b, c, h, d))
    kn, vn = _i8(rng, (b, c, hkv, d)), _i8(rng, (b, c, hkv, d))
    base = np.array([0, 11, 29], np.int32)
    jw, tw = _wo(rng, h, d, 40) if fold else ({}, {})
    if fold:
        tw = dict(wo_w8=tw["wo"].w8, wo_bias32=tw["wo"].bias32,
                  wo_b_vec=tw["wo"].b_mult, wo_spec=tw["wo_spec"])
    jo, jk, jv = j_ref_prefill(
        jnp.asarray(q8), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kp),
        jnp.asarray(vp), jp, jnp.asarray(base), jnp.asarray(pages), ps, **jw)
    to, tk, tv = t_ref_prefill(
        T(q8), T(kn), T(vn), T(kp.copy()), T(vp.copy()), tp, T(base),
        T(pages), ps, **tw)
    assert np.array_equal(to.numpy(), np.asarray(jo))
    assert np.array_equal(tk.numpy()[1:], np.asarray(jk)[1:])
    assert np.array_equal(tv.numpy()[1:], np.asarray(jv)[1:])


@pytest.mark.parametrize("fold", [False, True])
def test_cuda_backend_reads_contiguous_caches(fold):
    """The ``cuda`` backend takes a contiguous ``(B, L, Hkv, D)`` cache
    (``pages=None``, K3's contiguous launch): its plain version equals the
    Pallas kernel in interpret mode, folded wo included."""
    rng, jp, tp, kp, vp, pages = _attn_setup(17)
    b, L, h, hkv, d = 3, 32, 4, 2, 32
    q8, k8, v8 = (_i8(rng, (b, 1, h, d)), _i8(rng, (b, L, hkv, d)),
                  _i8(rng, (b, L, hkv, d)))
    vl = np.array([1, 20, 32], np.int32)
    jw, tw = _wo(rng, h, d, 40) if fold else ({}, {})
    want = int_decode_attention_fused(
        jnp.asarray(q8), jnp.asarray(k8), jnp.asarray(v8), jp,
        jnp.asarray(vl), requant=JSpec.per_tensor(jp.dn_out), bkv=16,
        interpret=True, **jw)
    got = resolve_ops("cuda").int_decode_attention(
        T(q8), T(k8), T(v8), tp, T(vl), requant=TSpec.per_tensor(tp.dn_out),
        **tw)
    assert np.array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------ wrappers on the CPU -----

def test_cuda_wrappers_take_the_plain_path_on_cpu_tensors():
    """On CPU tensors every wrapper returns its plain version's result
    and launches nothing."""
    rng, jp, tp, kp, vp, pages = _attn_setup(11)
    kernels.reset_launches()
    x8, w8 = T(_i8(rng, (4, 64))), T(_i8(rng, (64, 32)))
    spec = TSpec.raw()
    assert torch.equal(int8_matmul(x8, w8, spec),
                       int8_matmul_plain(x8, w8, spec))
    q = T(rng.integers(-8192, 8192, (4, 128)).astype(np.int32))
    g = T(rng.integers(1, 127, (128,)).astype(np.int32))
    npl = plan_from_reference(j_norms.make_inorm(128, 2.0 ** -9, 8192,
                                                 2 / 127, 8 / 127, False))
    assert torch.equal(int_layernorm(q, g, None, npl),
                       int_layernorm_plain(q, g, None, npl))
    q8 = T(_i8(rng, (3, 1, 4, 32)))
    vl = T(np.array([1, 20, 64], np.int32))
    assert torch.equal(
        t_decode(q8, T(kp), T(vp), tp, vl, T(pages), 16),
        int_decode_attention_plain(q8, T(kp), T(vp), tp, vl, T(pages), 16))
    q8 = T(_i8(rng, (3, 16, 4, 32)))
    assert torch.equal(
        t_prefill(q8, T(kp), T(vp), tp, vl + 16, T(pages), 16),
        int_paged_prefill_plain(q8, T(kp), T(vp), tp, vl + 16, T(pages),
                                16))
    assert all(n == 0 for n in kernels.LAUNCHES.values())


@pytest.mark.parametrize("k", [7, 64, 200, 4096, 14336])
def test_int8_matmul_split_k_covers_k_exactly(k):
    """The K1 launch geometry: every split is non-empty, a whole number
    of K-steps, and together they cover K once (the kernel's split-K
    reduction assumes both)."""
    from repro_torch.kernels.int8_matmul import _split_k
    for tiles in (1, 4, 16, 64, 501, 4008):
        for bk in (64,):
            splits, k_per = _split_k(tiles, k, bk, 132)
            assert k_per % bk == 0 and splits >= 1
            assert (splits - 1) * k_per < k <= splits * k_per


@pytest.mark.parametrize("m,n,k", [
    (1, 7, 7), (4, 14336, 4096), (16, 128256, 4096), (17, 96, 200),
    (32, 50272, 768), (64, 3072, 300), (65, 96, 4096), (128, 14336, 4096),
    (128, 1024, 4096), (128, 4096, 14336), (128, 128256, 4096),
    (129, 260, 768), (1000, 2100, 300), (16384, 768, 768),
    (16384, 3072, 768), (16384, 768, 3072)])
def test_int8_matmul_launch_plan(m, n, k):
    """K1's launch plan from the shape alone: the decode tile up to
    SMALL_M_MAX rows (all of them in one 16-row block, K split across a
    cluster of whole ring stages, no workspace) and the tensor cores
    beyond; every split non-empty (decode: every rank but those past K),
    a whole number of K-steps, together covering K; the grid covering M
    and N; vector alignment as each kernel's copies need."""
    from repro_torch.kernels.int8_matmul import (DECODE_BM, SMALL_M_MAX,
                                                 TILES, decode_k_step,
                                                 launch_plan)
    for sms in (132, 114):
        for packed in (False, True):
            p = launch_plan(m, n, k, sms, packed)
            assert (p.tile == 0) == (m <= SMALL_M_MAX)
            if p.tile == 0:
                bm, bn, bk = DECODE_BM, p.bn, decode_k_step(packed)
                assert p.grid[1] == 1 and p.grid[2] == p.cluster
                assert p.grid[0] * p.cluster <= max(sms, p.grid[0])
            else:
                bm, bn, bk = TILES[p.tile]
                assert p.route == "mma"
            gx, gy, splits = p.grid
            if p.tile == 2:
                assert m > 64 and gx * gy >= sms
            assert gx * bn >= n > (gx - 1) * bn
            assert gy * bm >= m > (gy - 1) * bm
            assert splits >= 1 and p.k_per_split % bk == 0
            assert splits * p.k_per_split >= k
            if p.tile:
                assert k > (splits - 1) * p.k_per_split
            want = (16, 16) if p.tile == 0 else (16, 8)
            assert (p.x_align, p.w_align) == want