"""The port's analysis layer (``repro_torch.analysis``) against the JAX
package's and against the port's own kernel plans.

  * budgets: ``BitBudgetError`` / ``static_check`` carry ``op`` /
    ``layer`` with the reference's message;
  * certification: for every registry config at (4096, 32768) and (512,
    2048), the port's ``certify_config`` equals the reference's on ``(op,
    layer, worst, bits, note)``, ``n_dyadics`` and ``assumptions``, and
    its paths are the reference's but for the matmuls' backend name;
    deliberately unsafe constants (a requant spec, a hand-edited plan
    dyadic) raise ``BitBudgetError`` with the same ``what`` / ``op`` /
    ``layer`` in both packages;
  * launch contracts: ``check_launch`` equals each plan function at the
    main paths' shapes (route, grid, cluster, shared memory), reports
    every refusal with a reason, states the backends' route choice;
    ``check_tp_launch`` refuses ragged head counts; the engine's
    construction-time checks raise through them; the launch recorder;
  * the repo-rule linter RR001–RR004 and the two CLIs, and the committed
    ``docs/CERTIFY_TORCH.json``.

All of it is integer arithmetic in Python: the card is not needed.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import interpret as j_interpret
from repro.analysis import ranges as j_ranges
from repro.analysis.budgets import BitBudgetError as JBitBudgetError
from repro.configs.registry import ARCHS as J_ARCHS
from repro.core.dyadic import Dyadic as JDyadic
from repro.ops.spec import RequantSpec as JRequantSpec
from repro.quant import plans as j_plans

from repro_torch import kernels
from repro_torch.analysis import (INT32_MAX, BitBudgetError, IntRange,
                                  KernelContractError, check_launch,
                                  check_tp_launch, require_launch,
                                  static_check)
from repro_torch.analysis import certify, contracts, interpret, lint, ranges
from repro_torch.analysis.budgets import MAX_ROWSUM_LEN, MAX_SQ
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.core.dyadic import Dyadic, fit_dyadic
from repro_torch.kernels import int8_matmul as K1
from repro_torch.kernels import int_attention as K8
from repro_torch.kernels import int_attention_fused as K5
from repro_torch.kernels import int_decode_attention as K3
from repro_torch.kernels import int_layernorm as K2
from repro_torch.kernels import int_softmax as K7
from repro_torch.ops.spec import RequantSpec
from repro_torch.quant import plans as t_plans

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
LLAMA = get_config("llama3-8b")


# ---------------------------------------------------------------- budgets --

def test_bit_budget_error_is_typed_located_and_the_references():
    kw = dict(op="int8_matmul", layer="ffn.down")
    with pytest.raises(BitBudgetError) as ei:
        static_check(INT32_MAX + 1, "ffn accumulator", **kw)
    e = ei.value
    assert isinstance(e, ValueError)
    assert (e.what, e.value, e.budget, e.op, e.layer) == (
        "ffn accumulator", INT32_MAX + 1, INT32_MAX, "int8_matmul",
        "ffn.down")
    assert str(e) == str(JBitBudgetError("ffn accumulator", INT32_MAX + 1,
                                         **kw))
    # callers that pass neither keep the old message
    assert str(BitBudgetError("x", 5, 4)) == "budget exceeded in x: 5 > 4"
    assert static_check(INT32_MAX, "x") == INT32_MAX


def test_kv4_shift_is_the_packed_tier_s():
    from repro_torch.ops.packed import KV_SHIFT
    assert ranges.KV4_SHIFT == KV_SHIFT == j_ranges.KV4_SHIFT
    assert ranges.INT4_KV == IntRange.symmetric(112)


# ---------------------------------------------------------- certification --

def _rows(rep):
    return [(o.op, o.layer, o.worst, o.bits, o.note) for o in rep.ops]


@pytest.mark.parametrize("geometry", [(4096, 32768), (512, 2048)],
                         ids=["4096x32768", "512x2048"])
@pytest.mark.parametrize("name", sorted(J_ARCHS))
def test_certify_config_equals_the_reference(name, geometry):
    """Both plan trees come from the same config fields: every op's worst
    case, bits and note, the audited dyadics and the assumptions agree;
    the paths too, but for a matmul's backend name (``cuda`` for
    ``pallas``)."""
    seq, cache = geometry
    j = j_interpret.certify_config(J_ARCHS[name], seq, cache)
    t = interpret.certify_config(ARCHS[name], seq, cache)
    assert _rows(t) == _rows(j)
    assert (t.n_dyadics, t.assumptions) == (j.n_dyadics, j.assumptions)
    assert (t.worst_bits, t.min_headroom_bits) == (j.worst_bits,
                                                  j.min_headroom_bits)
    for jo, to in zip(j.ops, t.ops):
        assert to.path == ("cuda" if jo.path == "pallas" else jo.path), (
            to.layer, jo.path, to.path)
        assert to.route, to.layer


def test_certified_routes_are_the_contracts():
    """Each op's route and shared memory at the serving geometry are the
    launch contract's (llama3-8b: the decode tile over TMA, K3 streaming
    a 32 768-position table, K4 / K5 without the e16 store)."""
    rep = {o.layer: o for o in interpret.certify_config(LLAMA).ops}
    q = check_launch("int8_matmul", m=interpret.SERVE_BATCH, n=4096, k=4096)
    assert (rep["attn.qkv"].route, rep["attn.qkv"].smem_bytes) == (
        q.route, q.smem_bytes) == ("tma", K1.decode_smem(128, False))
    dec = check_launch("int_decode_attention", b=interpret.SERVE_BATCH,
                       sq=1, h=32, hkv=8, d=128, max_pages=2048,
                       page_size=interpret.SERVE_PAGE)
    assert rep["attn.decode"].route == dec.route == "streaming"
    assert rep["attn.decode"].smem_bytes == dec.smem_bytes
    assert rep["attn.prefill"].route == "recompute"
    assert rep["ffn.act"].route == "plain"
    assert rep["norm"].route == "block"


def test_unsafe_requant_spec_refused_alike():
    """A raw multiplier with no pre-shift against a wide accumulator, and a
    per-channel spec past its staging budget: both packages refuse with
    the same typed fields."""
    r = 1 << 30
    cases = [
        (RequantSpec.per_tensor(Dyadic((1 << 15) - 1, 20, 0, r)),
         JRequantSpec.per_tensor(JDyadic((1 << 15) - 1, 20, 0, r)), r,
         "attn.qkv"),
        (RequantSpec.per_channel(c=16, pre=0, out_bits=8),
         JRequantSpec.per_channel(c=16, pre=0, out_bits=8), 1 << 20,
         "ffn.up"),
    ]
    for spec, jspec, qmax, layer in cases:
        with pytest.raises(BitBudgetError) as te:
            interpret.check_requant_spec(spec, IntRange.symmetric(qmax),
                                         op="int8_matmul", layer=layer)
        with pytest.raises(JBitBudgetError) as je:
            j_interpret.check_requant_spec(
                jspec, j_ranges.IntRange.symmetric(qmax), op="int8_matmul",
                layer=layer)
        t, j = te.value, je.value
        assert (t.what, t.op, t.layer, t.value, t.budget) == (
            j.what, j.op, j.layer, j.value, j.budget)
        assert str(t) == str(j) and t.value > INT32_MAX


def test_hand_edited_plan_dyadic_refused_alike():
    """The attention epilogue's dyadic edited past its fit contract (the
    largest multiplier, the pre-shift dropped, a 2^20 input range): the
    plan-tree audit refuses it in both packages at the same path."""
    tp = t_plans.build_layer_plans(LLAMA)
    jp = j_plans.build_layer_plans(J_ARCHS["llama3-8b"])
    dn = tp.attn.attn.dn_out
    bad_t = Dyadic(b=(1 << 15) - 1, c=dn.c, pre=0, qmax_in=1 << 20)
    bad_j = JDyadic(b=(1 << 15) - 1, c=dn.c, pre=0, qmax_in=1 << 20)
    tp = tp._replace(attn=tp.attn._replace(
        attn=tp.attn.attn._replace(dn_out=bad_t)))
    jp = jp._replace(attn=jp.attn._replace(
        attn=jp.attn.attn._replace(dn_out=bad_j)))
    with pytest.raises(BitBudgetError) as te:
        ranges.audit_dyadics(tp, prefix="llama3-8b", op="audit")
    with pytest.raises(JBitBudgetError) as je:
        j_ranges.audit_dyadics(jp, prefix="llama3-8b", op="audit")
    t, j = te.value, je.value
    assert (t.what, t.op, t.layer, t.value) == (j.what, j.op, j.layer,
                                                j.value)
    assert t.layer == "llama3-8b.attn.attn.dn_out"


def test_every_plan_dyadic_is_audited():
    """The audit finds as many dyadics in the port's plan tree as in the
    reference's, Mamba's included (a renamed plan class would drop some)."""
    for name in ("mamba2-130m", "jamba-v0.1-52b", "qwen2-moe-a2.7b"):
        t = list(ranges.iter_dyadics(
            t_plans.build_layer_plans(ARCHS[name]), name))
        j = list(j_ranges.iter_dyadics(
            j_plans.build_layer_plans(J_ARCHS[name]), name))
        assert [p for p, _ in t] == [p for p, _ in j]
        assert [(d.b, d.c, d.pre, d.qmax_in) for _, d in t] == \
            [(d.b, d.c, d.pre, d.qmax_in) for _, d in j]


def test_interval_endpoints_are_exact():
    dn = fit_dyadic(0.003, 10_000)
    r = ranges.t_dyadic(IntRange.symmetric(10_000), dn)

    def f(v):
        return ranges.rshift_round_int(
            ranges.rshift_round_int(v, dn.pre) * dn.b, dn.c - dn.pre)

    assert (r.lo, r.hi) == (f(-10_000), f(10_000))
    assert ranges.t_clip(IntRange.symmetric(1 << 20), 8) == IntRange(-127,
                                                                     127)


# -------------------------------------------------------- launch contracts --

def _same(rep, route, grid, cluster, smem):
    assert rep.ok and rep.fused, rep.reasons
    assert (rep.route, rep.grid, rep.cluster, rep.smem_bytes) == (
        route, tuple(grid), cluster, smem)


@pytest.mark.parametrize("m", [4, 16, 128])
def test_check_launch_is_k1s_plans(m):
    """K1 at every llama3-8b projection and the head, dense and packed,
    and the MSR-4 correction at group 64: the plans' route, grid, cluster
    and shared memory on the default 132 SMs, addresses aligned."""
    d, f, v = 4096, 14336, LLAMA.padded_vocab()
    for k, n in ((d, d), (d, 1024), (d, f), (f, d), (d, v)):
        for packed in (False, True):
            p = K1.launch_plan(m, n, k, 132, packed)
            route = p.route if p.tile == 0 else f"mma{K1.TILES[p.tile][0]}"
            rep = check_launch("int8_matmul", m=m, n=n, k=k, packed=packed)
            _same(rep, route, p.grid, p.cluster, p.smem)
            assert rep.threads == (K1.DECODE_THREADS if p.tile == 0
                                   else K1.MMA_THREADS)
            assert rep == check_launch("int8_matmul_packed" if packed
                                       else "int8_matmul", m=m, n=n, k=k)
        c = K1.msr4_plan(m, n, k, 64, 64, 132)
        _same(check_launch("int8_matmul_msr4", m=m, n=n, k=k, group=64,
                           n_out=64), c.route, c.grid, 1, c.smem)
    # a misaligned operand takes the decode tile's copy route
    if m <= K1.SMALL_M_MAX:
        assert check_launch("int8_matmul", m=m, n=d, k=d,
                            x_addr=4).route == "copy"


def test_check_launch_is_the_attention_plans():
    """K3 at the serve row and the verify step over int8 / int4 pages, K4
    at a 32-token chunk, K5 at roberta-base's pass, K8 at its 128 x 128
    blocks (addresses aligned, 132 SMs)."""
    heads = dict(h=32, hkv=8, d=128)
    for packed in (False, True):
        for sq in (1, 4):
            p = K3.k3_launch_plan(4, sq, 32, 8, 128, 512, True, packed)
            rep = check_launch("int_decode_attention", b=4, sq=sq,
                               max_pages=32, page_size=16, kv_pack=packed,
                               num_pages=129, **heads)
            _same(rep, "resident" if p.resident else "streaming", p.grid,
                  p.cluster, p.smem)
            assert rep.threads == K3.K3_THREADS and rep.plan == p
            assert dict(rep.args)["pages"] == (4, 32)
        p = K5.k4_launch_plan(4, 32, 32, 8, 128, 32, 16, 0, packed=packed)
        _same(check_launch("int_paged_prefill", b=4, c=32, max_pages=32,
                           page_size=16, kv_pack=packed, **heads),
              "store" if p.store_e16 else "recompute", p.grid, 1, p.smem)
    p = K3.k3_launch_plan(4, 1, 32, 8, 120, 512, False)
    _same(check_launch("int_decode_attention", b=4, sq=1, h=32, hkv=8,
                       d=120, L=512), "resident", p.grid, p.cluster, p.smem)
    p = K5.k5_launch_plan(32, 512, 512, 12, 12, 64, False, 0, 0)
    _same(check_launch("int_attention", b=32, sq=512, skv=512, h=12, hkv=12,
                       d=64, causal=False),
          "store" if p.store_e16 else "recompute", p.grid, 1, p.smem)
    p = K8.k8_launch_plan(32, 512, 12, 64, 128)
    _same(check_launch("int_attention", b=32, sq=512, skv=512, h=12,
                       hkv=12, d=64, online=True), "online", p.grid, 1,
          p.smem)


def test_check_launch_is_the_norm_softmax_and_grouped_plans():
    for rows, d, mean in ((4, 4096, False), (128, 4096, False),
                          (16384, 768, True)):
        p = K2.launch_plan(rows, d, 132, True)
        rep = check_launch("int_layernorm", rows=rows, d=d,
                           subtract_mean=mean, beta=mean)
        _same(rep, p.route, (p.grid,), 1, 0)
        assert rep.threads == p.threads and rep.kernel[4:] == (mean, mean)
    for vl in (-1, 300):
        p = K7.launch_plan(196608, 512, vl, True)
        _same(check_launch("int_softmax", rows=196608, L=512, valid_len=vl),
              p.route, (p.grid,), 1, 0)
    for r in (16, 160):
        p = K1.grouped_plan(64, r, 1408, 2048, 132)
        rep = check_launch("int8_matmul_grouped", e=64, r=r, n=1408, k=2048)
        _same(rep, p.route, p.grid, p.cluster, p.smem)
        assert rep.args == (("rows", (64,)),)
        assert rep.threads == p.threads and rep.kernel[1] == p.rt


@pytest.mark.parametrize("op, params, match", [
    ("int_attention", dict(b=1, sq=64, skv=64, h=2, hkv=2, d=96), "head dim"),
    ("int_attention", dict(b=1, sq=64, skv=64, h=2, hkv=2, d=96,
                           online=True), "head dim"),
    ("int_decode_attention", dict(b=1, sq=1, h=2, hkv=2, d=96, L=64),
     "head dim"),
    ("int_paged_prefill", dict(b=1, c=16, h=2, hkv=2, d=96, max_pages=2,
                               page_size=16), "head dim"),
    ("int_layernorm", dict(rows=2, d=8200), "8200"),
    ("int_decode_attention", dict(b=1, sq=MAX_SQ + 1, h=32, hkv=8, d=128,
                                  L=64), "query rows"),
    ("int_decode_attention", dict(b=1, sq=1, h=30, hkv=8, d=128, L=64),
     "Hkv | H"),
    ("int_attention", dict(b=1, sq=64, skv=64, h=30, hkv=8, d=128),
     "Hkv | H"),
    ("int_paged_prefill", dict(b=1, c=16, h=30, hkv=8, d=128, max_pages=2,
                               page_size=16), "Hkv | H"),
    ("int_decode_attention", dict(b=1, sq=1, h=4, hkv=2, d=32, max_pages=
                                  MAX_ROWSUM_LEN // 16 + 1, page_size=16),
     "row sum"),
    ("int_attention", dict(b=1, sq=1, skv=MAX_ROWSUM_LEN + 1, h=1, hkv=1,
                           d=32), "row sum"),
    ("int_decode_attention", dict(b=1, sq=1, h=4, hkv=2, d=32, L=64,
                                  kv_pack=True), "paged cache layout"),
    ("int_decode_attention", dict(b=1, sq=1, h=4, hkv=2, d=32, L=64,
                                  fold=True), "n_out"),
    ("int8_matmul", dict(m=4, n=8, k=0), "K == 0"),
    ("int8_matmul_packed", dict(m=4, n=8, k=7), "even"),
    ("int8_matmul_msr4", dict(m=4, n=8, k=100, group=64, n_out=4), "tile K"),
    ("int_softmax", dict(rows=4, L=MAX_ROWSUM_LEN + 1), "row sum"),
])
def test_refusals_are_typed_reports(op, params, match):
    """Every shape a kernel does not take is a failed report with its
    reason, and ``require_launch`` raises ``KernelContractError`` (a
    ``ValueError``) naming it."""
    rep = check_launch(op, **params)
    assert not rep.ok and not rep.fused
    assert any(match in r for r in rep.reasons), rep.reasons
    with pytest.raises(KernelContractError, match=match) as ei:
        require_launch(rep)
    assert isinstance(ei.value, ValueError)


def test_backend_route_choice():
    """``fused=False`` with ``ok`` predicts the exact fallback: the chunked
    two-pass above S·Skv = 2^22 for ``cuda_ref`` (not for cross attention,
    not for ``cuda``), above Skv = 2^15 for both; K5 under ``cuda_online``
    below 16 rows."""
    shape = dict(b=1, h=32, hkv=8, d=128)
    long = dict(sq=4096, skv=4096, **shape)
    assert check_launch("int_attention", **long).fused
    rep = check_launch("int_attention", backend="cuda_ref", **long)
    assert rep.ok and not rep.fused and "chunked" in rep.reasons[0]
    assert check_launch("int_attention", backend="cuda_ref", cross=True,
                        **long).fused
    assert check_launch("int_attention", backend="cuda_ref", sq=2048,
                        skv=2048, **shape).fused
    rep = check_launch("int_attention", sq=1, skv=MAX_ROWSUM_LEN + 1,
                       **shape)
    assert not rep.fused and any("chunked" in r for r in rep.reasons)
    rep = check_launch("int_attention", sq=8, skv=8, online=True, **shape)
    assert rep.ok and not rep.fused
    assert contracts.FULL_MATRIX_MAX == (4096 * 4096) // 4
    assert contracts.fused_attention_takes(MAX_ROWSUM_LEN)
    assert not contracts.ref_streams_chunked(4096, 1024)
    assert contracts.online_takes(16, 16) and not contracts.online_takes(
        15, 64)


def test_check_tp_launch():
    base = dict(b=4, sq=1, d=128, max_pages=32, page_size=16)
    rep = check_tp_launch("int_decode_attention", tp=3, h=32, hkv=8, **base)
    assert not rep.ok and len(rep.reasons) == 2
    rep = check_tp_launch("int_decode_attention", tp=4, h=30, hkv=8, **base)
    assert not rep.ok and rep.reasons == (
        "tp=4 must divide the query head count (h=30)",)
    assert check_tp_launch("int_decode_attention", tp=2, h=32, hkv=8,
                           **base) == check_launch(
        "int_decode_attention", h=16, hkv=4, **base)
    assert check_tp_launch("int_paged_prefill", tp=2, b=4, c=32, h=32,
                           hkv=8, d=128, max_pages=32, page_size=16).ok
    with pytest.raises(KeyError):
        check_tp_launch("int8_matmul", tp=2, m=4, n=4, k=4)
    with pytest.raises(KeyError, match="unknown kernel op"):
        check_launch("int_conv", x=1)


def test_reports_are_cached_per_shape():
    """A wrapper pays one dict lookup a launch: the same shape (addresses
    by their alignment) gives the same report object."""
    a = check_launch("int8_matmul", m=4, n=4096, k=4096, x_addr=4096,
                     w_addr=16)
    assert a is check_launch("int8_matmul", m=4, n=4096, k=4096, x_addr=32,
                             w_addr=48)
    assert a is contracts.matmul_report(4, 4096, 4096, False, 132, 0, 0)


def _cpu_engine(cfg, **kw):
    from repro_torch.quant import convert
    from repro_torch.serving import ServingEngine
    qp, plans = convert.init_quantized(cfg, seed=0, device="cpu")
    return ServingEngine(qp, plans, cfg, batch_size=2, cache_len=64,
                         page_size=16, prefill_chunk=16, ops="cuda",
                         device="cpu", **kw)


def test_engine_launch_checks_go_through_the_contracts(monkeypatch):
    """The engine's construction-time checks (run where the device is the
    card) refuse a verify step past MAX_SQ rows and a head dim no kernel
    is compiled for, with ``KernelContractError``; a spec_k past
    ``MAX_SQ - 1`` is refused before, as the reference refuses it."""
    from repro_torch.models.model import reduce_config
    from repro_torch.serving.speculate import SpeculationError
    cfg = reduce_config(LLAMA)
    eng = _cpu_engine(cfg, spec_k=MAX_SQ - 1)
    monkeypatch.setattr(eng, "device", torch.device("cuda"))
    eng._check_launches()
    eng.spec_k = MAX_SQ
    with pytest.raises(KernelContractError, match="query rows"):
        eng._check_launches()
    with pytest.raises(SpeculationError, match="MAX_SQ"):
        _cpu_engine(cfg, spec_k=MAX_SQ)
    eng = _cpu_engine(reduce_config(LLAMA, head_dim=48), spec_k=2)
    monkeypatch.setattr(eng, "device", torch.device("cuda"))
    with pytest.raises(KernelContractError, match="ROADMAP §2 item 4"):
        eng._check_launches()


def test_launch_recorder_only_inside_its_block():
    assert kernels.RECORDERS == []
    with kernels.record_launches() as outer:
        with kernels.record_launches() as inner:
            kernels.note_launch("int_softmax", dict(rows=1, L=4), "warp",
                                [1], 1, 0)
        kernels.note_launch("int_layernorm", dict(rows=1, d=4), "warp",
                            (1,), 1, 0)
    assert kernels.RECORDERS == []
    assert inner == [("int_softmax", dict(rows=1, L=4), dict(
        route="warp", grid=(1,), cluster=1, smem_bytes=0))]
    assert [op for op, _, _ in outer] == ["int_layernorm"]


# ------------------------------------------------------------------ lint --

def test_lint_rr001_kernel_import_scoping():
    src = "from repro_torch.kernels.int8_matmul import launch_plan\n"
    bad = lint.lint_source(src, "src/repro_torch/serving/engine.py")
    assert [f.code for f in bad] == ["RR001"]
    assert "backend registry" in bad[0].message
    assert lint.lint_source("import repro_torch.kernels._build\n",
                            "src/repro_torch/launch/serve.py")[0].code \
        == "RR001"
    for ok in ("src/repro_torch/ops/backends/cuda.py",
               "src/repro_torch/kernels/ref.py",
               "src/repro_torch/analysis/contracts.py",
               "tests/test_torch_kernels.py", "chip_smoke.py"):
        assert lint.lint_source(src, ok) == [], ok
    # the contract file is the one exception, not its package
    assert lint.lint_source(src, "src/repro_torch/analysis/interpret.py")


def test_lint_rr002_aliasing_engine_state():
    for call in ("torch.from_numpy(self.pos)", "torch.as_tensor(eng.table)"):
        bad = lint.lint_source(f"x = {call}\n",
                               "src/repro_torch/serving/engine.py")
        assert [f.code for f in bad] == ["RR002"], call
        assert "snapshot" in bad[0].message
    ok = ("a = torch.from_numpy(self.pos.copy())\n"
          "b = torch.as_tensor(np.ascontiguousarray(self.pos))\n"
          "c = torch.as_tensor(pages)\n")
    assert lint.lint_source(ok, "src/repro_torch/serving/engine.py") == []
    assert lint.lint_source("x = torch.from_numpy(self.pos)\n",
                            "src/repro_torch/models/intlayers.py") == []


def test_lint_rr003_float_dtypes_and_the_named_exemptions():
    src = "def f(q):\n    return q.to(torch.float32)\n"
    bad = lint.lint_source(src, "src/repro_torch/core/norms.py")
    assert [f.code for f in bad] == ["RR003"]
    assert lint.lint_source(src, "src/repro_torch/core/quant.py") == []
    assert lint.lint_source(src, "src/repro_torch/models/layers.py") == []
    exempt = ("def int_einsum(eq, a, b):\n"
              "    return a.to(torch.float64)\n")
    assert lint.lint_source(exempt, "src/repro_torch/core/intmath.py") == []
    # by (path, function) only: the same name elsewhere still fires
    assert lint.lint_source(exempt, "src/repro_torch/core/softmax.py")
    assert lint.lint_source("def quantize_norm_weights(g):\n"
                            "    return g.to(torch.float32)\n",
                            "src/repro_torch/core/norms.py") == []
    assert lint.lint_source("def i_norm(g):\n    return torch.float16\n",
                            "src/repro_torch/core/norms.py")


def test_lint_rr004_unpack_above_the_backend_boundary():
    src = ("from repro_torch.ops import packed\n"
           "w = packed.unpack_weights(qw)\n"
           "p = unpack_kv_pool(pool, shifts)\n")
    for scope in ("models/intlayers.py", "serving/engine.py"):
        bad = lint.lint_source(src, f"src/repro_torch/{scope}")
        assert [f.code for f in bad] == ["RR004", "RR004"]
    for ok in ("kernels/int8_matmul.py", "ops/packed.py",
               "ops/backends/torch_ref.py"):
        assert lint.lint_source(src, f"src/repro_torch/{ok}") == []
    assert lint.lint_source("k = pack_kv(v8)\n",
                            "src/repro_torch/models/intlayers.py") == []


def test_the_port_lints_clean():
    findings = lint.lint_paths([os.path.join(ROOT, "src", "repro_torch")])
    assert findings == [], [str(f) for f in findings]
    f = lint.lint_source("import repro_torch.kernels.ref\n",
                         "src/repro_torch/serving/engine.py")[0]
    assert str(f).startswith("src/repro_torch/serving/engine.py:1:0 RR001")


def _cli(module, *args):
    return subprocess.run(
        [sys.executable, "-m", module, *args], capture_output=True,
        text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})


def test_lint_cli_exit_status(tmp_path):
    bad = tmp_path / "src" / "repro_torch" / "core" / "z.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import torch\ny = torch.float32\n")
    out = _cli("repro_torch.analysis.lint", str(bad))
    assert out.returncode == 1 and "RR003" in out.stdout
    out = _cli("repro_torch.analysis.lint")
    assert out.returncode == 0, out.stdout + out.stderr


def test_certify_cli_one_arch(tmp_path):
    path = tmp_path / "cert.json"
    assert certify.main(["--arch", "granite-3-2b", "--seq-len", "512",
                         "--cache-len", "2048", "--out", str(path)]) == 0
    data = json.loads(path.read_text())
    assert data["schema"] == "repro_torch/certify-v1"
    assert data["n_failed"] == 0 and list(data["configs"]) == [
        "granite-3-2b"]
    entry = data["configs"]["granite-3-2b"]
    assert {"route", "smem_bytes", "path", "bits"} <= set(entry["ops"][0])
    assert data["budgets"]["MAX_ROWSUM_LEN"] == MAX_ROWSUM_LEN


def test_committed_certificate_is_current(tmp_path):
    """``docs/CERTIFY_TORCH.json`` is what the CLI writes now, byte for
    byte (``python -m repro_torch.analysis.certify``), and every config in
    it certified."""
    out = tmp_path / "CERTIFY_TORCH.json"
    assert certify.main(["--out", str(out)]) == 0
    committed = os.path.join(ROOT, certify.DEFAULT_JSON)
    with open(committed, encoding="utf-8") as fh:
        text = fh.read()
    assert text == out.read_text()
    data = json.loads(text)
    assert data["n_configs"] == 13 and data["n_failed"] == 0
    assert (data["seq_len"], data["cache_len"]) == (4096, 32768)
