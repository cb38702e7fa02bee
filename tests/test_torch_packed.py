"""Packed int4 / MSR-4 weights == the JAX package, bit for bit.

  * ``ops.spec.PackMeta``'s validation against the reference's;
  * ``quant.pack`` (``pack_int4``, ``pack_msr4``, ``pack_linear``,
    ``pack_tree``) against ``repro.quant.pack``: equal bytes on every int8
    value and on random draws, 2-D and layer-stacked, groups 4 / 16 / 64
    and the ``g = K`` fallback, and the skip rules;
  * ``ops.packed.unpack_weights`` / ``msr4_correction`` against
    ``repro.ops.packed``;
  * a numpy model of K1's in-register nibble expansion
    (``csrc/int8_matmul.cu``: two byte rows -> "4 K values of one column"
    words) on every 16-bit pattern, and a numpy emulation of the MSR-4
    correction's gather route (``csrc/int8_matmul_msr4.cu``, from
    ``msr4_gather_plan``: row tiles, staged chunks of whole groups, split
    K) against its plain version (the tensor-core route's emulation is
    ``tests/test_torch_msr4_plan.py``);
  * ``int8_matmul_packed`` on ``torch_ref``, ``cuda`` and ``cuda_online``
    (their plain versions here) against JAX ``pallas_fused`` (interpret)
    and ``ref``, every epilogue form, both schemes;
  * ``interop.qparams_from_reference`` on packed trees; ``int_prefill``
    logits of reduced llama3-8b on msr4 and on int4 (a derived model with
    every linear weight clamped to [-7, 7]) against JAX's;
  * ``ServingEngine`` streams on msr4 ``group=64`` against the JAX
    engine's and the port's dense streams (chunked prefill, prefix
    sharing, preemption; with ``kv_dtype="int4"``; ``cuda_online`` against
    JAX ``ops="pallas"``), and a packed wo never folded.

Tolerance: 0.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as j_get_config
from repro.core.dyadic import fit_dyadic as j_fit_dyadic
from repro.models import inttransformer as jit_
from repro.models import model as JM
from repro.models import transformer as jtf
from repro.ops import QuantLinearParams as JQLP
from repro.ops import RequantSpec as JSpec
from repro.ops import packed as jpk
from repro.ops import resolve_ops as j_resolve
from repro.ops import spec as jspec
from repro.quant import convert as j_convert
from repro.quant import pack as jpack
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch import ops as tops
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.interop import from_reference, plan_from_reference
from repro_torch.kernels import int8_matmul as k1
from repro_torch.kernels.int_attention_fused import (apply_wo_cuda,
                                                     epilogue_setup)
from repro_torch.models import inttransformer as tit
from repro_torch.models import model as TM
from repro_torch.ops import packed as tpk
from repro_torch.ops import resolve_ops
from repro_torch.ops.backends.cuda import CudaBackend
from repro_torch.ops.spec import PackMeta, QuantLinearParams
from repro_torch.ops.spec import RequantSpec as TSpec
from repro_torch.quant import pack as tpack
from repro_torch.serving import Request as TRequest
from repro_torch.serving import ServingEngine as TEngine

T = torch.as_tensor


def _j(x):
    return np.asarray(x)


def _same_packed(t, j):
    """A port QuantLinearParams equal to a reference one, byte for byte."""
    assert t.is_packed and j.is_packed
    assert dataclasses.asdict(t.pack_meta) == dataclasses.asdict(j.pack_meta)
    for f in ("w_packed", "out_idx", "out_val", "b_mult", "bias32"):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.numpy().dtype == _j(b).dtype, f
            assert np.array_equal(a.numpy(), _j(b)), f


# --------------------------------------------------------------- spec ----

@pytest.mark.parametrize("args", [
    ("int4", 0, 0, 64), ("msr4", 16, 3, 64), ("msr4", 64, 0, 64),
    ("int8", 0, 0, 64), ("int4", 0, 0, 63), ("msr4", 0, 1, 64),
    ("msr4", 48, 1, 64), ("msr4", 16, -1, 64), ("int4", 16, 2, 64)])
def test_pack_meta_validation_matches_reference(args):
    def outcome(cls):
        try:
            return dataclasses.asdict(cls(*args))
        except ValueError as e:
            return type(e)
    assert outcome(PackMeta) == outcome(jspec.PackMeta)


# --------------------------------------------------------------- pack ----

_ALL = np.arange(-128, 128, dtype=np.int8)


@pytest.mark.parametrize("group", [0, 4, 16, 64, 256, 100])
def test_pack_msr4_bytes_on_every_int8_value(group):
    w = np.stack([_ALL, _ALL[::-1], np.roll(_ALL, 7)], axis=1)
    jb = jpack.pack_msr4(w, group)
    tb = tpack.pack_msr4(T(w), group)
    assert dataclasses.asdict(tb[1]) == dataclasses.asdict(jb[1])
    for t, j in zip((tb[0], tb[2], tb[3]), (jb[0], jb[2], jb[3])):
        assert t.numpy().dtype == j.dtype and np.array_equal(t.numpy(), j)
    q = QuantLinearParams(None, w_packed=tb[0], pack_meta=tb[1],
                          out_idx=tb[2], out_val=tb[3])
    assert np.array_equal(tpk.unpack_weights(q).numpy(), w)


@pytest.mark.parametrize("shape", [(64, 24), (3, 64, 24), (2, 256, 40),
                                   (2, 6, 5)])
@pytest.mark.parametrize("group", [4, 16, 64, 48])
@pytest.mark.parametrize("spread", [7, 20, 128])
def test_pack_msr4_bytes_on_random_draws(shape, group, spread):
    """Layer stacks share one n_outliers (the max over their layers);
    ``spread`` 7 gives no outlier, 20 a few, 128 most weights."""
    rng = np.random.default_rng(sum(shape) + group + spread)
    w = rng.integers(-spread, spread, shape).astype(np.int8)
    if len(shape) == 3 and spread == 20:
        w[0] = np.clip(w[0], -7, 7)            # a layer without outliers
    jb = jpack.pack_msr4(w, group)
    tb = tpack.pack_msr4(T(w), group)
    assert dataclasses.asdict(tb[1]) == dataclasses.asdict(jb[1])
    for t, j in zip((tb[0], tb[2], tb[3]), (jb[0], jb[2], jb[3])):
        assert t.shape == j.shape and np.array_equal(t.numpy(), j)
    q = QuantLinearParams(None, w_packed=tb[0], pack_meta=tb[1],
                          out_idx=tb[2], out_val=tb[3])
    jq = JQLP(None, w_packed=jnp.asarray(jb[0]), pack_meta=jb[1],
              out_idx=jnp.asarray(jb[2]), out_val=jnp.asarray(jb[3]))
    assert np.array_equal(tpk.unpack_weights(q).numpy(),
                          _j(jpk.unpack_weights(jq)))
    assert np.array_equal(tpk.unpack_weights(q).numpy(), w)


def test_pack_int4_and_refusals_match_reference():
    rng = np.random.default_rng(1)
    for shape in ((16, 8), (3, 32, 5)):
        w = rng.integers(-7, 8, shape).astype(np.int8)
        assert np.array_equal(tpack.pack_int4(T(w)).numpy(),
                              jpack.pack_int4(w))
    w = np.full((16, 4), 8, np.int8)
    for fn in (jpack.pack_int4, lambda a: tpack.pack_int4(T(a))):
        with pytest.raises(ValueError, match="msr4"):
            fn(w)
    odd = np.zeros((15, 4), np.int8)
    for fn in (jpack.pack_int4, jpack.pack_msr4,
               lambda a: tpack.pack_int4(T(a)),
               lambda a: tpack.pack_msr4(T(a))):
        with pytest.raises(ValueError, match="even"):
            fn(odd)


@pytest.mark.parametrize("scheme", ["int4", "msr4"])
def test_pack_linear_and_tree_match_reference(scheme):
    """Bias and multipliers ride along; the skip rules: odd K, 4-D expert
    stacks, non-linear leaves, already-packed params."""
    rng = np.random.default_rng(2)
    lo = -7 if scheme == "int4" else -128

    def lin(shape):
        n = shape[-1]
        return (rng.integers(lo, -lo if scheme == "int4" else 128, shape)
                .astype(np.int8),
                rng.integers(1000, 30000, shape[:-2] + (n,)).astype(np.int32),
                rng.integers(-500, 500, shape[:-2] + (n,)).astype(np.int32))

    leaves = {"a": lin((32, 12)), "b": lin((2, 64, 8)), "odd": lin((15, 4)),
              "moe": lin((2, 2, 16, 4))}
    emb = rng.integers(-127, 128, (9, 4)).astype(np.int8)
    jtree = {"layers": [{k: JQLP(*map(jnp.asarray, v))
                         for k, v in leaves.items()}], "emb": jnp.asarray(emb)}
    ttree = {"layers": [{k: QuantLinearParams(*map(T, v))
                         for k, v in leaves.items()}], "emb": T(emb)}
    jout = jpack.pack_tree(jtree, scheme=scheme, group=16)
    tout = tpack.pack_tree(ttree, scheme=scheme, group=16)
    for k in ("a", "b"):
        _same_packed(tout["layers"][0][k], jout["layers"][0][k])
        assert tout["layers"][0][k].k_dim == jout["layers"][0][k].k_dim
        assert tout["layers"][0][k].n_dim == jout["layers"][0][k].n_dim
    for k in ("odd", "moe"):
        assert not tout["layers"][0][k].is_packed
        assert tout["layers"][0][k] is ttree["layers"][0][k]
    assert tout["emb"] is ttree["emb"]
    again = tpack.pack_linear(tout["layers"][0]["a"], scheme=scheme)
    assert again is tout["layers"][0]["a"]
    with pytest.raises(ValueError, match="scheme"):
        tpack.pack_linear(ttree["layers"][0]["a"], scheme="int2")
    # the reference's tree converted, packed, equals the port's own pack
    conv = from_reference(jax.tree.map(np.asarray, jout), None,
                          device="cpu")[0]
    for k in ("a", "b"):
        got = conv["layers"][0][k]
        assert isinstance(got.pack_meta, PackMeta)
        for f in ("w_packed", "out_idx", "out_val", "b_mult", "bias32"):
            a, b = getattr(got, f), getattr(tout["layers"][0][k], f)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b), f


@pytest.mark.parametrize("group", [4, 16, 32])
def test_msr4_correction_matches_reference(group):
    rng = np.random.default_rng(group)
    w = rng.integers(-128, 128, (32, 24)).astype(np.int8)
    x = rng.integers(-128, 128, (5, 32)).astype(np.int32)
    jq = jpack.pack_linear(JQLP(jnp.asarray(w)), "msr4", group)
    tq = tpack.pack_linear(QuantLinearParams(T(w)), "msr4", group)
    got = tpk.msr4_correction(T(x), tq)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(),
                          _j(jpk.msr4_correction(jnp.asarray(x), jq)))
    nib = tpk.nibble_unpack(tq.w_packed).numpy().astype(np.int64)
    assert np.array_equal(x @ nib + got.numpy(), x @ w.astype(np.int64))
    i4 = tpack.pack_linear(QuantLinearParams(T(np.clip(w, -7, 7))), "int4")
    assert not tpk.msr4_correction(T(x), i4).any()


# ------------------------------------------------- kernel models (numpy) --

def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint64 arrays holding 32-bit words."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
          [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def _unpack_kv4x2(p):
    """``unpack_kv4x2(p, 0)`` (csrc/int_common.cuh) at shift 0."""
    lo, hi = p & 0x0F0F0F0F, (p >> 4) & 0x0F0F0F0F

    def sext(n):
        return n | (((n & 0x08080808) * 0x1E) & 0xFFFFFFFF)
    return sext(_byte_perm(lo, hi, 0x5140)), sext(_byte_perm(lo, hi, 0x7362))


def _expand_w4(p0, p1):
    """``expand_w4`` (csrc/int8_matmul.cu): words of byte rows 2kk and
    2kk + 1 (4 columns) -> the four columns' "4 K values" words."""
    c0, c1 = _unpack_kv4x2(_byte_perm(p0, p1, 0x5140))
    c2, c3 = _unpack_kv4x2(_byte_perm(p0, p1, 0x7362))
    return [c0, c1, c2, c3]


def _words_to_bytes(words):
    """(n,) uint64 words -> (n, 4) int8, byte j of each word."""
    return np.stack([(words >> (8 * j)) & 0xFF for j in range(4)],
                    -1).astype(np.uint8).view(np.int8)


def test_k1_nibble_expansion_model_on_every_16_bit_pattern():
    """Column j of two byte rows (b0 = row 2kk, b1 = row 2kk + 1): every
    (b0, b1) pair expands to K rows 4kk..4kk+3 exactly as
    ``nibble_unpack`` gives them; the four columns of a word pair
    independently."""
    p = np.arange(1 << 16, dtype=np.uint64)
    b0, b1 = p & 0xFF, p >> 8
    packed = np.stack([b0, b1], 0).astype(np.uint8).view(np.int8)  # (2, n)
    want = tpk.nibble_unpack(T(packed), axis=-2).numpy().astype(np.int8)
    for j in range(4):          # the pattern in column j of the words
        p0, p1 = b0 << (8 * j), b1 << (8 * j)
        got = _words_to_bytes(_expand_w4(p0, p1)[j])
        assert np.array_equal(got, want.T), j
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 1 << 32, (2, 4096), dtype=np.uint64)
    packed = np.stack([_words_to_bytes(r) for r in rows], 0)  # (2, n, 4)
    want = tpk.nibble_unpack(T(packed), axis=0).numpy()       # (4, n, 4)
    cols = _expand_w4(rows[0], rows[1])
    for j in range(4):
        assert np.array_equal(_words_to_bytes(cols[j]),
                              want[:, :, j].T.astype(np.int8)), j


def _emulate_msr4_kernel(acc, x8, qw, spec, plan):
    """``msr4_correct_kernel`` (the gather route) block by block in numpy: each block stages
    its rows of x for a chunk of whole groups ([row][MT] bytes, zero past
    M), walks its columns' lanes, and with split K adds into acc, the
    last split running the epilogue (here: after every split)."""
    m, k = x8.shape
    meta = qw.pack_meta
    g, n_out, n = meta.group, meta.n_outliers, qw.n_dim
    idx, val = qw.out_idx.numpy(), qw.out_val.numpy().astype(np.int64)
    acc = acc.numpy().astype(np.int64).copy()
    gx, gy, splits = plan.grid
    ngrp = k // g
    gpc = plan.kc // g
    assert plan.kc * plan.mt <= plan.smem and plan.smem % 16 == 0
    for bx in range(gx):
        m0 = bx * plan.mt
        for by in range(gy):
            cols = np.arange(by * k1.MSR4_THREADS,
                             min(n, (by + 1) * k1.MSR4_THREADS))
            for bz in range(splits):
                gbeg = bz * plan.groups_per_split
                gend = min(ngrp, gbeg + plan.groups_per_split)
                assert gbeg < gend
                corr = np.zeros((plan.mt, len(cols)), np.int64)
                for c0 in range(gbeg, gend, gpc):
                    c1 = min(gend, c0 + gpc)
                    xs = np.zeros(((c1 - c0) * g, plan.mt), np.int64)
                    rows = x8.numpy()[m0:m0 + plan.mt, c0 * g:c1 * g]
                    xs[:, :rows.shape[0]] = rows.T
                    for grp in range(c0, c1):
                        for lane in range(n_out):
                            r = idx[grp, lane, cols].astype(np.int64)
                            xr = xs[(grp - c0) * g + r]        # (cols, MT)
                            corr += (xr * val[grp, lane, cols][:, None]).T
                mm = slice(m0, min(m, m0 + plan.mt))
                acc[mm, cols] += corr[:acc[mm].shape[0]]
    acc = ((acc + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
    if qw.bias32 is not None:
        acc = acc + qw.bias32.numpy()[None, :]
    return k1._epilogue_plain(T(acc), spec, qw.b_mult)


@pytest.mark.parametrize("m,k,n,group,spread", [
    (1, 64, 130, 16, 128), (4, 128, 300, 4, 128), (5, 256, 64, 64, 20),
    (16, 96, 40, 96, 128), (33, 64, 260, 16, 9), (17, 512, 16, 256, 128),
    (4, 64, 64, 64, 8)])
@pytest.mark.parametrize("sms", [1, 132])
def test_msr4_plan_and_kernel_schedule_match_plain(m, k, n, group, spread,
                                                  sms):
    """``msr4_gather_plan`` (rows a block, staged chunks of whole groups,
    split K, shared-memory bytes) and the gather kernel's schedule in
    numpy equal :func:`msr4_correct_plain`: n_out 0 (spread 8), a few, and
    g."""
    rng = np.random.default_rng(m + k + n + group)
    w = rng.integers(-spread, spread, (k, n)).astype(np.int8)
    qw = tpack.pack_linear(QuantLinearParams(
        T(w), T(rng.integers(1000, 30000, n).astype(np.int32)),
        T(rng.integers(-500, 500, n).astype(np.int32))), "msr4", group)
    x8 = T(rng.integers(-128, 128, (m, k)).astype(np.int8))
    spec = TSpec.per_channel(c=28, pre=7, out_bits=14)
    plan = k1.msr4_gather_plan(m, n, k, qw.pack_meta.group,
                               qw.pack_meta.n_outliers, sms)
    assert plan.route == "gather" and plan.mt == (4 if m <= 4 else 16)
    assert plan.kc % qw.pack_meta.group == 0 and plan.kc <= k
    assert plan.smem <= k1.MSR4_MAX_SMEM
    if not qw.pack_meta.n_outliers:
        assert plan.grid[2] == 1
    acc = k1.int8_matmul_nibbles_plain(x8, qw.w_packed, TSpec.raw())
    want = k1.msr4_correct_plain(acc, x8, qw, spec)
    assert torch.equal(_emulate_msr4_kernel(acc, x8, qw, spec, plan), want)
    assert torch.equal(want, k1.int8_matmul_plain(x8, T(w), spec,
                                                  qw.bias32, qw.b_mult))


def test_msr4_plan_at_full_width():
    """The llama3-8b launches on 132 SMs (group 64, n_out 64: w1, w2, qkv,
    wo and the head at M = 4 and 128) take the tensor-core route, decode
    in 16-row tiles with K split, the 128-row chunk in one 128-row tile; a
    whole-K group (the ``g = K`` fallback) takes the gather route, 16 rows
    where they fit the shared memory, else 4."""
    d, f, v, kv = 4096, 14336, 128256, 1024
    for k, n in ((d, f), (f, d), (d, d + 2 * kv), (d, d), (d, v)):
        for m in (4, 128):
            p = k1.msr4_plan(m, n, k, 64, 64, 132)
            assert p.route == "mma" and p.kc == 64 and p.sp == 64
            assert p.lc == 64 and p.smem <= k1.MSR4_MAX_SMEM
            assert p.mt == (16 if m == 4 else 128)
            assert p.grid[:2] == (1, -(-n // 128))
            assert p.groups_per_split * p.grid[2] >= k // 64
    assert k1.msr4_plan(4, f, d, 64, 64, 132).grid == (1, 112, 10)
    assert k1.msr4_plan(128, f, d, 64, 64, 132).grid == (1, 112, 2)
    p = k1.msr4_plan(128, 4096, 14336, 14336, 140, 132)
    assert p.route == "gather"
    assert p.mt == 16 and p.kc == 14336 and p.grid[2] == 1
    assert p.smem == 16 * 14336 <= k1.MSR4_MAX_SMEM
    assert p == k1.msr4_gather_plan(128, 4096, 14336, 14336, 140, 132)
    p = k1.msr4_plan(128, 4096, 16384, 16384, 140, 132)
    assert p.route == "gather"
    assert p.mt == 4 and p.kc == 16384 and p.smem == 4 * 16384


# ------------------------------------------------------ packed matmul ----

_SHAPES = ((8, 32, 16), (5, 64, 8), (16, 128, 128), (1, 16, 4))


@pytest.mark.parametrize("form", ["per_tensor", "per_channel", "raw"])
@pytest.mark.parametrize("scheme", ["int4", "msr4"])
def test_packed_matmul_matches_reference_backends(form, scheme):
    """The shapes of the reference's own property test, group 16: the
    port's backends == JAX ``pallas_fused`` (interpret) == JAX ``ref`` ==
    the dense product; the wrapper's parts (the nibble launch, the
    correction) equal their plain versions."""
    rng = np.random.default_rng(len(form) + len(scheme))
    for m, k, n in _SHAPES:
        lo, hi = (-7, 8) if scheme == "int4" else (-128, 128)
        w = rng.integers(lo, hi, (k, n)).astype(np.int8)
        x = rng.integers(-127, 128, (m, k)).astype(np.int8)
        bias = rng.integers(-2 ** 14, 2 ** 14, (n,)).astype(np.int32)
        b_vec = None
        if form == "per_tensor":
            jd = j_fit_dyadic(1 / 4000.0, k * 127 * 127 + 2 ** 14)
            jspec_ = JSpec.per_tensor(jd)
            tspec = TSpec.per_tensor(plan_from_reference(jd))
        elif form == "per_channel":
            jspec_ = JSpec.per_channel(c=28, pre=7)
            tspec = TSpec.per_channel(c=28, pre=7)
            b_vec = rng.integers(1000, 30000, (n,)).astype(np.int32)
        else:
            jspec_, tspec = JSpec.raw(), TSpec.raw()
        jbv = None if b_vec is None else jnp.asarray(b_vec)
        jq = jpack.pack_linear(JQLP(jnp.asarray(w), jbv, jnp.asarray(bias)),
                               scheme=scheme, group=16)
        tq = tpack.pack_linear(QuantLinearParams(
            T(w), None if b_vec is None else T(b_vec), T(bias)),
            scheme=scheme, group=16)
        _same_packed(tq, jq)
        jx = jnp.asarray(x)
        want = _j(j_resolve("ref").int8_matmul(jx, jnp.asarray(w), jspec_,
                                               bias32=jnp.asarray(bias),
                                               b_vec=jbv))
        assert np.array_equal(_j(j_resolve("pallas_fused").int8_matmul_packed(
            jx, jq, jspec_)), want)
        assert np.array_equal(_j(j_resolve("ref").int8_matmul_packed(
            jx, jq, jspec_)), want)
        for name in ("torch_ref", "cuda", "cuda_online"):
            got = resolve_ops(name).int8_matmul_packed(T(x), tq, tspec)
            assert np.array_equal(got.numpy(), want), (name, (m, k, n))
        got = tops.int8_matmul_packed(T(x), tq, tspec, ops="cuda")
        assert np.array_equal(got.numpy(), want)
        assert torch.equal(k1.int8_matmul_packed(T(x), tq, tspec), got)
        acc = k1.int8_matmul_nibbles(T(x), tq.w_packed, TSpec.raw())
        nib = tpk.nibble_unpack(tq.w_packed).to(torch.int8)
        assert torch.equal(acc, k1.int8_matmul_plain(T(x), nib, TSpec.raw()))
        if scheme == "msr4":
            assert torch.equal(k1.msr4_correct(acc, T(x), tq, tspec), got)


def test_dense_params_fall_through_int8_matmul_packed():
    rng = np.random.default_rng(3)
    w = rng.integers(-127, 128, (32, 8)).astype(np.int8)
    x = rng.integers(-127, 128, (3, 32)).astype(np.int8)
    qw = QuantLinearParams(T(w))
    got = resolve_ops("cuda").int8_matmul_packed(T(x), qw, TSpec.raw())
    assert torch.equal(got, k1.int8_matmul_plain(T(x), T(w), TSpec.raw()))


# --------------------------------------------------- model and engine ----

def _clamped(jq):
    """A derived model: every linear weight of the tree clamped to [-7,
    7] (plain int4 packs only such weights)."""
    return jax.tree.map(
        lambda q: q._replace(w8=jnp.clip(q.w8, -7, 7))
        if isinstance(q, JQLP) else q, jq,
        is_leaf=lambda q: isinstance(q, JQLP))


@pytest.fixture(scope="module")
def llama():
    over = dict(dtype="float32", capacity_factor=8.0)
    jcfg = JM.reduce_config(j_get_config("llama3-8b"), **over)
    tcfg = TM.reduce_config(t_get_config("llama3-8b"), **over)
    params = jtf.init_params(jax.random.key(0), jcfg)
    jq, jp = j_convert.quantize_params(params, jcfg)
    tq, tp = from_reference(jax.tree.map(np.array, jq), jp, device="cpu")
    return jcfg, tcfg, jq, jp, tq, tp


def _leaves(tree):
    if isinstance(tree, QuantLinearParams):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)


@pytest.mark.parametrize("scheme", ["msr4", "int4"])
def test_packed_model_bytes_and_prefill_logits(llama, scheme):
    """The reference's ``pack_tree`` output carried across equals the
    port's own pack of the same model; ``int_prefill`` logits equal
    JAX's (and the dense model's: both tiers are lossless)."""
    jcfg, tcfg, jq, jp, tq, tp = llama
    if scheme == "int4":
        jq = _clamped(jq)
        tq = from_reference(jax.tree.map(np.array, jq), None,
                            device="cpu")[0]
    jpk_tree = jpack.pack_tree(jq, scheme=scheme, group=64)
    tpk_tree = tpack.pack_tree(tq, scheme=scheme, group=64)
    conv = from_reference(jax.tree.map(np.array, jpk_tree), None,
                          device="cpu")[0]
    leaves = list(_leaves(tpk_tree))
    assert len(leaves) == 8 and all(q.is_packed for q in leaves)
    for a, b in zip(leaves, _leaves(conv)):
        assert a.pack_meta == b.pack_meta
        for f in ("w_packed", "out_idx", "out_val", "b_mult", "bias32"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None) and (
                x is None or torch.equal(x, y)), f
    if scheme == "msr4":
        # per-channel abs-max weights: most of a group are outliers
        assert leaves[0].pack_meta.n_outliers > 32
    toks = np.array([[3, 17, 9, 44, 2, 8, 31, 5]], np.int32)
    want = _j(jit_.int_prefill(jpk_tree, {"tokens": jnp.asarray(toks)}, jp,
                               jcfg, ops="ref"))
    dense = tit.int_prefill(tq, {"tokens": T(toks)}, tp, tcfg,
                            ops="torch_ref")
    assert np.array_equal(dense.numpy(), want)
    for ops in ("cuda", "torch_ref"):
        got = tit.int_prefill(conv, {"tokens": T(toks)}, tp, tcfg, ops=ops)
        assert np.array_equal(got.numpy(), want), ops


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


@pytest.fixture(scope="module")
def msr4(llama):
    jcfg, tcfg, jq, jp, tq, tp = llama
    return (jpack.pack_tree(jq, scheme="msr4", group=64),
            tpack.pack_tree(tq, scheme="msr4", group=64))


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_engine_msr4_streams_match_reference_and_dense(llama, msr4,
                                                       kv_dtype):
    """Chunked prefill (chunk 8), prefix sharing, preemption, wo folded:
    the port's msr4 engine on ``cuda`` == the JAX msr4 engine == the
    port's dense engine (msr4 is lossless), over int8 or int4 pages."""
    jcfg, tcfg, jq, jp, tq, tp = llama
    jpk_tree, tpk_tree = msr4
    kw = dict(batch_size=2, cache_len=64, prefill_chunk=8, prefill_budget=8,
              kv_dtype=kv_dtype)
    want = _streams(JEngine(jpk_tree, jp, jcfg, ops="ref", **kw), JRequest)
    dense = _streams(TEngine(tq, tp, tcfg, ops="torch_ref", device="cpu",
                             **kw), TRequest)
    assert dense == want
    got = _streams(TEngine(tpk_tree, tp, tcfg, ops="cuda", device="cpu",
                           fold_wo=True, **kw), TRequest)
    assert got == want


def test_engine_msr4_cuda_online_matches_reference_pallas(llama, msr4):
    """``cuda_online`` (packed K1 inherited from ``cuda``) against the JAX
    ``pallas`` backend, which unpacks the weights densely."""
    jcfg, tcfg, jq, jp, tq, tp = llama
    jpk_tree, tpk_tree = msr4
    prompts = [list(PROMPTS[0][:20]), [5, 9, 11]]

    def streams(eng, Request):
        reqs = [Request(uid=i, prompt=list(p), max_new_tokens=3)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        return [r.out_tokens for r in reqs]

    kw = dict(batch_size=2, cache_len=32, prefill_chunk=16)
    want = streams(JEngine(jpk_tree, jp, jcfg, ops="pallas", **kw), JRequest)
    eng = TEngine(tpk_tree, tp, tcfg, ops="cuda_online", device="cpu", **kw)
    assert eng.ops.backend_for("int8_matmul_packed").packed_matmul
    assert not resolve_ops("torch_ref").backend_for(
        "int8_matmul_packed").__class__.__dict__.get("packed_matmul", False)
    assert streams(eng, TRequest) == want


def test_packed_wo_never_folds(llama, msr4, monkeypatch):
    """With ``fold_wo`` the engine hands a packed wo to the dispatch
    layer, which composes it through ``int8_matmul_packed`` and never
    passes it to the attention launch; the kernels refuse it."""
    jcfg, tcfg, jq, jp, tq, tp = llama
    _, tpk_tree = msr4
    seen = {"fold": 0, "packed": 0}
    dec, pre = CudaBackend.int_decode_attention, CudaBackend.int_paged_prefill
    packed_mm = CudaBackend.int8_matmul_packed

    def spy(orig):
        def wrapper(self, *a, **k):
            seen["fold"] += k.get("wo") is not None
            return orig(self, *a, **k)
        return wrapper

    def count(self, *a, **k):
        seen["packed"] += 1
        return packed_mm(self, *a, **k)

    monkeypatch.setattr(CudaBackend, "int_decode_attention", spy(dec))
    monkeypatch.setattr(CudaBackend, "int_paged_prefill", spy(pre))
    monkeypatch.setattr(CudaBackend, "int8_matmul_packed", count)
    eng = TEngine(tpk_tree, tp, tcfg, ops="cuda", device="cpu",
                  batch_size=2, cache_len=32, prefill_chunk=8, fold_wo=True)
    eng.submit(TRequest(uid=0, prompt=list(PROMPTS[0][:12]),
                        max_new_tokens=2))
    eng.run_until_done()
    assert seen["fold"] == 0 and seen["packed"] > 0
    wo = tpk_tree["layers"][0]["attn"]["wo"].map(lambda t: t[0])
    spec = TSpec.per_channel(c=28, pre=7)
    with pytest.raises(ValueError, match="never folds"):
        epilogue_setup(TSpec.per_tensor(tp.attn.attn.dn_out), tp.attn.attn,
                       wo, spec)
    with pytest.raises(ValueError, match="never folds"):
        apply_wo_cuda(torch.zeros((1, 1, 4, 32), dtype=torch.int8), wo,
                      spec)
