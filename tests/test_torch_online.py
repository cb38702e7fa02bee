"""The ported ``pallas`` backend's path (``cuda_online``) == the JAX
package, bit for bit.

  * K7 (row Shiftmax): the plain version against ``int_softmax_pallas`` in
    interpret mode over several row lengths, with and without a
    ``valid_len`` mask (0 included), and the oracle's ``where=`` mask;
  * K8 (one-pass online attention): the plain version against
    ``int_attention_pallas`` in interpret mode at four logical block
    pairs and every mask kind (causal, causal + window, GQA, none,
    cross-shaped) — K8's integers depend on the blocks, so it is held at
    the reference's own blocks;
  * ``cuda_online`` against ``PallasBackend``: the oracle below 16 rows or
    keys, ``_fit_block``, the per-tensor requant fold and its refusals;
  * the slice: ``int_prefill`` logits on ``cuda_online`` equal JAX
    ``int_prefill(ops="pallas")`` for reduced roberta-base and llama3-8b,
    and at multi-block logical blocks (bq=16, bkv=8) on both sides;
  * the registry: per-op overrides, ``use_backend``, ``REPRO_BACKEND``,
    ``cfg.kernel_backend`` through the twin table (``ref`` never selects
    the plain backend), and serving on ``cuda_online``.

Inputs are numpy draws from fixed seeds.  Tolerance: 0.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import ops as jops
from repro.configs.registry import get_config as j_get_config
from repro.core import attention as j_attn
from repro.core import softmax as j_sm
from repro.core.dyadic import fit_dyadic as j_fit_dyadic
from repro.kernels.int_attention import int_attention_pallas
from repro.kernels.int_softmax import int_softmax_pallas
from repro.kernels.ref import ref_int_attention as j_ref_attention
from repro.kernels.ref import ref_int_softmax as j_ref_softmax
from repro.models import intlayers as jil
from repro.models import inttransformer as jit_
from repro.models import model as JM
from repro.models import transformer as jtf
from repro.ops import RequantSpec as JSpec
from repro.ops.backends import pallas as j_pallas
from repro.quant import convert as j_convert
from repro_torch import kernels
from repro_torch import ops as tops
from repro_torch.analysis.budgets import MAX_SKV_ONLINE
from repro_torch.analysis.contracts import (KernelContractError,
                                            check_online_launch)
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.core import softmax as t_sm
from repro_torch.interop import from_reference, plan_from_reference
from repro_torch.kernels.int_attention import (int_attention_online,
                                               int_attention_online_plain)
from repro_torch.kernels.int_softmax import int_softmax, int_softmax_plain
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import intlayers as til
from repro_torch.models import inttransformer as tit
from repro_torch.models import model as TM
from repro_torch.ops.backends import cuda_online as t_online
from repro_torch.ops.spec import RequantSpec as TSpec

T = torch.as_tensor


def _i8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _attn_plans(d):
    jp = j_attn.make_iattention(d, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    return jp, plan_from_reference(jp)


# ------------------------------------------------------------------ K7 ----

@pytest.mark.parametrize("L", [40, 128, 512, 1000])
@pytest.mark.parametrize("valid_len", [-1, 0, 7, "half", "over"])
def test_int_softmax_plain_matches_pallas(L, valid_len):
    vl = {"half": L // 2, "over": L + 5}.get(valid_len, valid_len)
    rng = np.random.default_rng(L + vl)
    jp, tp = _attn_plans(64)
    x = rng.integers(-60000, 60000, (2, 3, 4, L)).astype(np.int32)
    want = np.asarray(int_softmax_pallas(jnp.asarray(x), jp.sm,
                                         valid_len=vl, interpret=True))
    got = int_softmax_plain(T(x), tp.sm, vl)
    assert got.dtype == torch.int8 and got.shape == x.shape
    assert np.array_equal(got.numpy(), want)
    if vl == 0:
        assert not got.any()
    # the wrapper, both backends, the twin of the JAX entry point and the
    # module-level entry point under use_backend: the same integers
    kernels.reset_launches()
    outs = [int_softmax(T(x), tp.sm, vl, block_rows=3),
            tops.resolve_ops("cuda").int_softmax(T(x), tp.sm, valid_len=vl),
            tops.resolve_ops("torch_ref").int_softmax(T(x), tp.sm,
                                                      valid_len=vl),
            tops.int_softmax(T(x), tp.sm, ops="pallas_tuned", valid_len=vl)]
    with tops.use_backend("cuda_online"):
        outs.append(tops.int_softmax(T(x), tp.sm, valid_len=vl))
    for out in outs:
        assert torch.equal(out, got)
    assert kernels.LAUNCHES["int_softmax"] == 0       # CPU: no launch


def test_int_softmax_where_mask():
    """``where=`` is the oracle's mask: ``torch_ref`` honours it (and
    ``valid_len`` with it, which the JAX ``ref`` backend ignores); the
    kernel backends raise instead of dropping it as JAX ``pallas`` does."""
    rng = np.random.default_rng(3)
    jp, tp = _attn_plans(32)
    x = rng.integers(-30000, 30000, (3, 5, 48)).astype(np.int32)
    where = rng.random((3, 5, 48)) < 0.7
    where[0, 0] = False                                # an all-masked row
    want = np.asarray(j_ref_softmax(jnp.asarray(x), jp.sm,
                                    where=jnp.asarray(where)))
    ref_be = tops.get_backend("torch_ref")
    got = ref_be.int_softmax(T(x), tp.sm, where=T(where))
    assert np.array_equal(got.numpy(), want)
    both = np.asarray(j_ref_softmax(
        jnp.asarray(x), jp.sm,
        where=jnp.asarray(where & (np.arange(48) < 20))))
    assert np.array_equal(ref_be.int_softmax(T(x), tp.sm, valid_len=20,
                                             where=T(where)).numpy(), both)
    for name in ("cuda", "cuda_online"):
        with pytest.raises(ValueError, match="where"):
            tops.resolve_ops(name).int_softmax(T(x), tp.sm, where=T(where))


def test_int_softmax_refuses_overlong_rows():
    _, tp = _attn_plans(32)
    with pytest.raises(ValueError, match="row sum"):
        int_softmax(torch.zeros((1, (1 << 15) + 1), dtype=torch.int32),
                    tp.sm)


def test_softmax_streaming_stats_match_reference():
    rng = np.random.default_rng(11)
    jp, tp = _attn_plans(64)
    q = rng.integers(-80000, 80000, (4, 6, 33)).astype(np.int32)
    where = rng.random(q.shape) < 0.8
    je, jm, js = j_sm.i_softmax_stats(jnp.asarray(q), jp.sm,
                                      where=jnp.asarray(where))
    te, tm, ts = t_sm.i_softmax_stats(T(q), tp.sm, where=T(where))
    for a, b in ((je, te), (jm, tm), (js, ts)):
        assert np.array_equal(np.asarray(a), b.numpy())
    m_new = np.maximum(np.asarray(jm), rng.integers(-500, 90000, jm.shape)
                       .astype(np.int32))
    jc = j_sm.combine_correction(jm, jnp.asarray(m_new), jp.sm)
    tc = t_sm.combine_correction(tm, T(m_new), tp.sm)
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert int(t_sm.combine_correction(T(np.zeros(1, np.int32)),
                                       T(np.zeros(1, np.int32)),
                                       tp.sm)) == 32755   # exp16(0) < 2^15
    # rescale_sum on negative accumulators too (K8's acc)
    x = rng.integers(-(1 << 30), 1 << 30, 4096).astype(np.int32)
    c = rng.integers(0, 32768, 4096).astype(np.int32)
    assert np.array_equal(np.asarray(j_sm.rescale_sum(jnp.asarray(x),
                                                      jnp.asarray(c))),
                          t_sm.rescale_sum(T(x), T(c)).numpy())
    assert np.array_equal(np.asarray(j_sm.finalize_probs(je, js)),
                          t_sm.finalize_probs(te, ts).numpy())


# ------------------------------------------------------------------ K8 ----

MASKS = {
    # kind: (sq, skv, h, hkv, causal, window)
    "causal": (64, 64, 2, 2, True, 0),
    "window": (64, 64, 2, 2, True, 16),
    "gqa": (64, 64, 4, 1, True, 0),
    "none": (64, 64, 2, 2, False, 0),
    "cross": (32, 64, 2, 2, False, 0),
}
BLOCKS = [(16, 16), (32, 16), (16, 32), (64, 64)]


@pytest.mark.parametrize("bq,bkv", BLOCKS, ids=lambda v: str(v))
@pytest.mark.parametrize("kind", sorted(MASKS))
def test_int_attention_online_plain_matches_pallas(kind, bq, bkv):
    sq, skv, h, hkv, causal, window = MASKS[kind]
    rng = np.random.default_rng(sq + skv + h + bq * 3 + bkv)
    jp, tp = _attn_plans(32)
    q8, k8, v8 = (_i8(rng, (1, sq, h, 32)), _i8(rng, (1, skv, hkv, 32)),
                  _i8(rng, (1, skv, hkv, 32)))
    want = np.asarray(int_attention_pallas(
        jnp.asarray(q8), jnp.asarray(k8), jnp.asarray(v8), jp, causal=causal,
        window=window, bq=bq, bkv=bkv, interpret=True))
    got = int_attention_online_plain(T(q8), T(k8), T(v8), tp, causal,
                                     window, bq, bkv)
    assert got.dtype == torch.int8 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    kernels.reset_launches()
    assert torch.equal(int_attention_online(T(q8), T(k8), T(v8), tp, causal,
                                            window, bq, bkv), got)
    be = t_online.CudaOnlineBackend(
        blocks={"int_attention": dict(bq=bq, bkv=bkv)})
    assert torch.equal(be.int_attention(T(q8), T(k8), T(v8), tp,
                                        causal=causal, window=window), got)
    assert kernels.LAUNCHES["int_attention_online"] == 0


def test_int_attention_online_block_dependence_and_oracle_spread():
    """K8's integers move with the blocks and sit within a few LSB of the
    exact oracle: the reason the port is held at the reference's blocks."""
    rng = np.random.default_rng(5)
    jp, tp = _attn_plans(32)
    q8, k8, v8 = (T(_i8(rng, (1, 64, 2, 32))) for _ in range(3))
    outs = {bl: int_attention_online_plain(q8, k8, v8, tp, True, 0, *bl)
            for bl in ((16, 16), (32, 16), (16, 32))}
    exact = np.asarray(j_ref_attention(
        jnp.asarray(q8.numpy()), jnp.asarray(k8.numpy()),
        jnp.asarray(v8.numpy()), jp, True, 0))
    assert not torch.equal(outs[(16, 16)], outs[(16, 32)])
    assert not torch.equal(outs[(16, 16)], outs[(32, 16)])
    for out in outs.values():
        diff = np.abs(out.numpy().astype(np.int64) - exact)
        assert 0 < diff.max() <= 4


def test_int_attention_online_window_without_causal_and_wide_clip():
    """A window without causality bands only from below (the reference
    kernel's mask, unlike the oracle's), and a 16-bit clip is stored as
    int8, wrapping as the reference's int8 store does."""
    rng = np.random.default_rng(9)
    jp, tp = _attn_plans(32)
    q8, k8, v8 = (_i8(rng, (2, 32, 2, 32)) for _ in range(3))
    plan16 = jp._replace(dn_out=j_fit_dyadic(0.5, 1 << 16))
    for jplan, out_bits, window in ((jp, 8, 8), (plan16, 16, 0)):
        want = np.asarray(int_attention_pallas(
            jnp.asarray(q8), jnp.asarray(k8), jnp.asarray(v8), jplan,
            causal=False, window=window, bq=16, bkv=16, out_bits=out_bits,
            interpret=True))
        got = int_attention_online_plain(
            T(q8), T(k8), T(v8), plan_from_reference(jplan), False, window,
            16, 16, out_bits)
        assert np.array_equal(got.numpy(), want)


def test_int_attention_online_contract():
    _, tp = _attn_plans(32)
    q = torch.zeros((1, 48, 2, 32), dtype=torch.int8)
    with pytest.raises(KernelContractError, match="divide"):
        int_attention_online(q, q, q, tp, bq=32, bkv=32)
    kv = torch.zeros((1, MAX_SKV_ONLINE + 16, 1, 32), dtype=torch.int8)
    with pytest.raises(KernelContractError, match="Skv"):
        int_attention_online(q[:, :16], kv, kv, tp, bq=16, bkv=16)
    kv3 = torch.zeros((1, 48, 3, 32), dtype=torch.int8)
    with pytest.raises(KernelContractError, match="Hkv"):
        int_attention_online(q, kv3, kv3, tp, bq=16, bkv=16)
    # the head dim and shared memory are the card's limits
    # (test_torch_gpu.py), not the plain version's
    assert check_online_launch(64, 64, 2, 2, 64, 64) == ()
    assert check_online_launch(512, 512, 32, 8, 256, 256) == ()
    assert len(check_online_launch(48, MAX_SKV_ONLINE + 3, 4, 3, 32,
                                   MAX_SKV_ONLINE + 3)) == 3
    q48 = torch.zeros((1, 64, 2, 48), dtype=torch.int8)
    assert int_attention_online(q48, q48, q48, _attn_plans(48)[1], bq=64,
                                bkv=64).shape == q48.shape


# ------------------------------------------------- cuda_online backend ---

def test_fit_block_is_the_references():
    for blk in (1, 8, 16, 100, 128, 256):
        for dim in (1, 15, 16, 40, 64, 131, 136, 512, 1000):
            assert t_online._fit_block(blk, dim) == \
                j_pallas._fit_block(blk, dim)
    assert t_online._fit_block(128, 131) == 1
    assert t_online._fit_block(128, 136) == 68


@pytest.mark.parametrize("sq,skv", [(8, 40), (40, 8), (40, 40)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 8)])
def test_cuda_online_dispatch_matches_pallas_backend(sq, skv, causal,
                                                     window):
    """Below 16 rows or keys both backends take the exact path (the JAX
    oracle, the port's K5); at 40 both fit blocks of 10 from a request of
    16; the requant spec's dyadic replaces the plan's."""
    rng = np.random.default_rng(sq * 3 + skv + window)
    jp, tp = _attn_plans(32)
    q8, k8, v8 = (_i8(rng, (2, sq, 4, 32)), _i8(rng, (2, skv, 2, 32)),
                  _i8(rng, (2, skv, 2, 32)))
    blocks = {"int_attention": dict(bq=16, bkv=16)}
    jbe = j_pallas.PallasBackend(blocks=blocks, interpret=True)
    tbe = t_online.CudaOnlineBackend(blocks=blocks)
    dn = j_fit_dyadic(jp.dn_out.value * 0.8, jp.dn_out.qmax_in)
    for js, ts in ((None, None),
                   (JSpec.per_tensor(dn), TSpec.per_tensor(
                       plan_from_reference(dn)))):
        want = np.asarray(jbe.int_attention(
            jnp.asarray(q8), jnp.asarray(k8), jnp.asarray(v8), jp,
            causal=causal, window=window, requant=js))
        got = tbe.int_attention(T(q8), T(k8), T(v8), tp, causal=causal,
                                window=window, requant=ts)
        assert np.array_equal(got.numpy(), want), (js, sq, skv)
    if min(sq, skv) < 16:
        exact = np.asarray(j_ref_attention(
            jnp.asarray(q8), jnp.asarray(k8), jnp.asarray(v8), jp, causal,
            window))
        assert np.array_equal(tbe.int_attention(
            T(q8), T(k8), T(v8), tp, causal=causal,
            window=window).numpy(), exact)


def test_cuda_online_refuses_other_epilogues():
    jp, tp = _attn_plans(32)
    q = np.zeros((1, 32, 2, 32), np.int8)
    for js, ts in ((JSpec.per_channel(22, 8), TSpec.per_channel(22, 8)),
                   (JSpec.raw(), TSpec.raw())):
        with pytest.raises(NotImplementedError):
            j_pallas.PallasBackend().int_attention(
                jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), jp,
                requant=js)
        for name in ("cuda_online", "pallas", "cuda_online_tuned"):
            with pytest.raises(NotImplementedError, match="per-tensor"):
                tops.resolve_ops(name).int_attention(T(q), T(q), T(q), tp,
                                                     requant=ts)


# -------------------------------------------------------------- slice -----

@pytest.fixture(scope="module")
def models():
    out = {}
    for arch, key in (("roberta-base", 0), ("llama3-8b", 1)):
        jc = JM.reduce_config(j_get_config(arch), dtype="float32")
        tc = TM.reduce_config(t_get_config(arch), dtype="float32")
        if arch == "roberta-base":
            jc = dataclasses.replace(jc, tie_embeddings=True)
            tc = dataclasses.replace(tc, tie_embeddings=True)
        params = jtf.init_params(jax.random.key(key), jc)
        jq, jp = j_convert.quantize_params(params, jc)
        tq, tp = from_reference(jax.tree.map(np.array, jq), jp, device="cpu")
        out[arch] = (jc, tc, jq, jp, tq, tp)
    return out


@pytest.mark.parametrize("blocks", [None, (16, 8)],
                         ids=["default-blocks", "bq16-bkv8"])
@pytest.mark.parametrize("arch", ["roberta-base", "llama3-8b"])
def test_int_prefill_online_matches_reference(models, arch, blocks):
    """Last-position logits of ``int_prefill`` on ``cuda_online`` equal JAX
    ``int_prefill`` on ``pallas`` (one 32 x 32 block), and with a JAX
    ``PallasBackend(blocks=...)`` instance against the port's twin at the
    same blocks (2 x 4 logical blocks per head)."""
    jc, tc, jq, jp, tq, tp = models[arch]
    s = 32
    toks = np.random.default_rng(s + len(arch)).integers(
        0, jc.vocab, (2, s)).astype(np.int32)
    if blocks is None:
        j_ops, t_ops = "pallas", "cuda_online"
    else:
        bl = {"int_attention": dict(bq=blocks[0], bkv=blocks[1])}
        j_ops = j_pallas.PallasBackend(blocks=bl, interpret=True)
        t_ops = t_online.CudaOnlineBackend(blocks=bl)
    want = np.asarray(jit_.int_prefill(jq, {"tokens": jnp.asarray(toks)},
                                       jp, jc, ops=j_ops))
    kernels.reset_launches()
    got = tit.int_prefill(tq, {"tokens": T(toks)}, tp, tc, ops=t_ops)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    if blocks is None:
        # the same path chosen by the config and by the step builder
        cfg_p = dataclasses.replace(tc, kernel_backend="pallas")
        assert torch.equal(tit.int_prefill(tq, {"tokens": T(toks)}, tp,
                                           cfg_p), got)
        step = make_prefill_step(tc, tp, ops="cuda_online", device="cpu")
        args = (tq, {"tokens": toks})
        if tc.pos == "rope":
            args += (til.build_rope_table(s + 1, tc.hd, tc.rope_theta,
                                            device="cpu"),)
        assert torch.equal(step(*args), got)
    assert sum(kernels.LAUNCHES.values()) == 0


def test_fuse_attention_false_takes_the_exact_path(models):
    """``fuse_attention=False`` never re-enters the online kernel: the
    exact integers, as JAX ``int_attn_fwd(ops="pallas",
    fuse_attention=False)``."""
    jc, tc, jq, jp, tq, tp = models["roberta-base"]
    x8 = _i8(np.random.default_rng(2), (2, 32, jc.d_model))
    jqp = jax.tree.map(lambda a: a[0], jq["layers"][0]["attn"])
    tqp = tit._layer(tq["layers"][0], 0)["attn"]
    for fuse in (True, False):
        want = np.asarray(jil.int_attn_fwd(jqp, jnp.asarray(x8), jp.attn,
                                           jc, causal=False, ops="pallas",
                                           fuse_attention=fuse))
        got = til.int_attn_fwd(tqp, T(x8), tp.attn, tc, causal=False,
                               ops="cuda_online", fuse_attention=fuse)
        assert np.array_equal(got.numpy(), want), fuse
    exact = til.int_attn_fwd(tqp, T(x8), tp.attn, tc, causal=False,
                             ops="torch_ref")
    assert torch.equal(got, exact)


# ------------------------------------------------------------ registry ----

def test_twin_table_covers_the_reference_backends():
    assert set(tops.TWINS) == {"ref", "pallas", "pallas_fused",
                               "pallas_tuned"}
    assert set(tops.TWINS) <= set(jops.available_backends())
    for jname, tname in tops.TWINS.items():
        assert tops.get_backend(jname) is tops.get_backend(tname)
    assert tops.get_backend("ref").name == "cuda_ref"
    assert tops.get_backend("pallas_fused").name == "cuda"
    assert tops.get_backend("pallas").name == "cuda_online"
    tuned = tops.get_backend("pallas_tuned")
    assert tuned.blocks["int_attention"] == \
        jops.get_backend("pallas_tuned").blocks["int_attention"]


def test_overrides_and_use_backend():
    ops = tops.OpSet("cuda", {"int_attention": "pallas"})
    assert ops.name == "cuda[int_attention=cuda_online]"
    assert ops.backend_for("int_attention").name == "cuda_online"
    assert ops.backend_for("int_softmax").name == "cuda"
    assert ops.with_overrides(int_softmax="torch_ref").name == \
        "cuda[int_attention=cuda_online,int_softmax=torch_ref]"
    with pytest.raises(KeyError, match="unknown op"):
        tops.OpSet("cuda", {"int_softmaxx": "cuda"})
    with pytest.raises(KeyError, match="unknown backend"):
        tops.resolve_ops("nope")
    assert tops.current_opset() is None
    with tops.use_backend("torch_ref", int_attention="cuda_online") as o1:
        assert tops.resolve_ops() is o1
        with tops.use_backend(o1, int_gelu="cuda") as o2:
            assert tops.resolve_ops().name == \
                "torch_ref[int_attention=cuda_online,int_gelu=cuda]"
            assert tops.current_opset() is o2
        assert tops.resolve_ops() is o1
        assert tops.resolve_ops("cuda").name == "cuda"   # explicit wins
    assert tops.current_opset() is None


def test_resolution_order_and_the_config_twin(monkeypatch):
    tc = TM.reduce_config(t_get_config("llama3-8b"), dtype="float32")
    assert tc.kernel_backend == "ref"
    monkeypatch.delenv(tops.ENV_VAR, raising=False)
    # the config's default "ref" is the kernels (with ref's chunked
    # attention above the threshold), never torch_ref
    assert tops.resolve_ops(None, tc).name == "cuda_ref"
    for jname, tname in (("ref", "cuda_ref"), ("pallas_fused", "cuda"),
                         ("pallas", "cuda_online"),
                         ("pallas_tuned", "cuda_online_tuned")):
        cfg = dataclasses.replace(tc, kernel_backend=jname)
        assert tops.resolve_ops(None, cfg).name == tname
    cfg_p = dataclasses.replace(tc, kernel_backend="pallas")
    monkeypatch.setenv(tops.ENV_VAR, "ref")
    assert tops.resolve_ops(None, cfg_p).name == "cuda_ref"  # env > cfg
    monkeypatch.setenv(tops.ENV_VAR, "pallas")
    assert tops.resolve_ops().name == "cuda_online"
    with tops.use_backend("torch_ref"):
        assert tops.resolve_ops(None, cfg_p).name == "torch_ref"
    assert tops.resolve_ops("cuda", cfg_p).name == "cuda"


def test_serving_on_cuda_online_matches_torch_ref(models):
    """The serving path on ``cuda_online`` (K3/K4 inherited from ``cuda``)
    gives the plain backend's streams, and the CLI takes the new names."""
    from repro_torch.launch import serve
    from repro_torch.serving import Request, ServingEngine
    _, tc, _, _, tq, tp = models["llama3-8b"]
    streams = {}
    for backend in ("cuda_online", "torch_ref", "pallas"):
        eng = ServingEngine(tq, tp, tc, batch_size=2, cache_len=48,
                            ops=backend, device="cpu", prefill_chunk=8)
        reqs = [Request(uid=i, prompt=[3 + i] * (5 + 7 * i),
                        max_new_tokens=4) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        streams[backend] = [r.out_tokens for r in reqs]
    assert streams["cuda_online"] == streams["torch_ref"] == \
        streams["pallas"]
    args = serve.build_parser().parse_args(["--backend", "cuda_online"])
    assert tops.resolve_ops(args.backend).name == "cuda_online"
