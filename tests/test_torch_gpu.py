"""The CUDA kernels on the card (K1-K8, and K3 / K4 over packed int4
pools): each wrapper launches (its counter moves) and returns its plain
version's integers exactly.

Marked ``gpu``: a CUDA kernel has no CPU mode, so these skip without a
card (the decision is made inside a fixture, never at import).  The file
imports only torch, numpy and the port, so it also runs on a machine
without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels
from repro_torch.core import activations as iact
from repro_torch.core import attention as iattn
from repro_torch.core import norms as inorms
from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_plain
from repro_torch.kernels.int_attention_fused import (
    int_attention_fused, int_attention_fused_plain, int_paged_prefill_fused,
    int_paged_prefill_plain)
from repro_torch.kernels.int_decode_attention import (
    int_decode_attention_fused, int_decode_attention_plain)
from repro_torch.kernels.int_attention import (int_attention_online,
                                               int_attention_online_plain)
from repro_torch.kernels.int_gelu import int_gelu, int_gelu_plain
from repro_torch.kernels.int_layernorm import (int_layernorm,
                                               int_layernorm_plain)
from repro_torch.kernels.int_softmax import int_softmax, int_softmax_plain
from repro_torch.ops.spec import QuantLinearParams, RequantSpec

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _i8(rng, shape, dev):
    return torch.as_tensor(rng.integers(-127, 128, shape).astype(np.int8),
                           device=dev)


def _i32(rng, lo, hi, shape, dev):
    return torch.as_tensor(rng.integers(lo, hi, shape).astype(np.int32),
                           device=dev)


# the tensor-core path (M > 16): ragged M around both tiles, K not a
# multiple of 16 (scalar x loads), N not a multiple of 8 (scalar w loads)
_MMA_SHAPES = [(m, k, n) for m in (17, 32, 64, 127, 128, 129, 1000)
               for n in (96, 260, 3072) for k in (200, 300, 768, 4096)]


@pytest.mark.parametrize("m,k,n,operands", [
    (4, 200, 48, "random"), (12, 300, 260, "random"),
    (33, 200, 100, "random"), (1, 7, 7, "random"),
    (130, 4096, 96, "random")]
    + [(m, k, n, "random") for m, k, n in _MMA_SHAPES]
    + [(1000, 300, 2100, "random"),            # 128-row tile, ragged N
       (128, 4096, 512, "random"),             # split-K
       (33, 301, 96, "misaligned"), (200, 301, 3072, "misaligned"),
       (4, 14336, 96, "min"), (4, 14336, 96, "max"),
       (130, 14336, 300, "min"), (130, 14336, 300, "max")])
def test_int8_matmul_kernel(dev, m, k, n, operands):
    """Ragged M, N and K (masked in-kernel), every tile, split-K, all
    three epilogue forms; ``misaligned``: x8 a view one row (of odd K)
    into its storage; ``min`` / ``max``: every operand -128 / +127, the
    largest sums at the FFN-down depth."""
    from repro_torch.kernels.int8_matmul import launch_plan
    rng = np.random.default_rng(m + k + n)
    if operands in ("min", "max"):
        fill = -128 if operands == "min" else 127
        x8 = torch.full((m, k), fill, dtype=torch.int8, device=dev)
        w8 = torch.full((k, n), fill, dtype=torch.int8, device=dev)
    else:
        x8, w8 = _i8(rng, (m, k), dev), _i8(rng, (k, n), dev)
    if operands == "misaligned":
        x8 = torch.cat([_i8(rng, (1, k), dev), x8])[1:]
        assert x8.is_contiguous() and x8.data_ptr() % 2 == 1
    bvec = _i32(rng, 256, 4096, (n,), dev)
    bias = _i32(rng, -5000, 5000, (n,), dev)
    from repro_torch.core.dyadic import fit_dyadic
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (launch_plan(m, n, k, sms).tile == 0) == (m <= 16)
    for spec in (RequantSpec.raw(), RequantSpec.per_channel(24, 10, 11),
                 RequantSpec.per_tensor(fit_dyadic(1 / 3000.0, 1 << 26))):
        before = kernels.LAUNCHES["int8_matmul"]
        got = int8_matmul(x8, w8, spec, bias32=bias, b_vec=bvec)
        assert kernels.LAUNCHES["int8_matmul"] == before + 1
        assert torch.equal(got, int8_matmul_plain(x8, w8, spec, bias, bvec))


# K1's decode tile (M <= 16): (K, N) whose plan on 132 SMs takes each
# cluster size (1, 2, 4, 8; BN 64 for the last)
_DECODE_CLUSTER_SHAPES = ((1024, 14336, 1), (512, 5120, 2), (1024, 4096, 4),
                          (1024, 1024, 8))


def _decode_specs():
    from repro_torch.core.dyadic import fit_dyadic
    return (RequantSpec.raw(), RequantSpec.per_channel(24, 10, 11),
            RequantSpec.per_tensor(fit_dyadic(1 / 3000.0, 1 << 26)))


@pytest.mark.parametrize("m", range(1, 17))
def test_int8_matmul_decode_kernel(dev, m):
    """The decode tile at every M from 1 to 16 on the TMA route, each
    cluster size in turn (the plan's, checked on a 132-SM card), all
    three epilogues with a bias."""
    from repro_torch.kernels.int8_matmul import launch_plan
    k, n, cluster = _DECODE_CLUSTER_SHAPES[m % 4]
    rng = np.random.default_rng(100 + m)
    x8, w8 = _i8(rng, (m, k), dev), _i8(rng, (k, n), dev)
    x8[0, :5] = -128
    bvec = _i32(rng, 256, 4096, (n,), dev)
    bias = _i32(rng, -5000, 5000, (n,), dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p = launch_plan(m, n, k, sms, False, x8.data_ptr(), w8.data_ptr())
    assert (p.tile, p.route) == (0, "tma")
    assert sms != 132 or p.cluster == cluster
    for spec in _decode_specs():
        before = kernels.LAUNCHES["int8_matmul"]
        got = int8_matmul(x8, w8, spec, bias32=bias, b_vec=bvec)
        assert kernels.LAUNCHES["int8_matmul"] == before + 1
        assert torch.equal(got, int8_matmul_plain(x8, w8, spec, bias, bvec))


@pytest.mark.parametrize("m,k,n,case", [
    (4, 4096, 100, "n%16"), (16, 4096, 100, "n%16"), (5, 300, 96, "k%16"),
    (16, 4096, 96, "w off 16"), (4, 4096, 96, "x off 16"),
    (1, 3840, 960, "ragged tile"), (16, 3840, 960, "ragged tile"),
    (16, 14336, 96, "min"), (16, 14336, 96, "max"),
    (1, 14336, 4096, "min"), (16, 14336, 4096, "max")])
def test_int8_matmul_decode_kernel_edges(dev, m, k, n, case):
    """The decode tile where a tensor map cannot describe an operand (N
    or K not a multiple of 16, w 8 or x 4 bytes off a 16-byte boundary:
    the copy route), a ragged last tile of BN 64 (N 960), and every
    operand -128 / +127 at the FFN-down depth (the largest sums), in all
    three epilogues."""
    from repro_torch.kernels.int8_matmul import launch_plan
    rng = np.random.default_rng(m + k + n)
    if case in ("min", "max"):
        fill = -128 if case == "min" else 127
        x8 = torch.full((m, k), fill, dtype=torch.int8, device=dev)
        w8 = torch.full((k, n), fill, dtype=torch.int8, device=dev)
    else:
        x8, w8 = _i8(rng, (m, k), dev), _i8(rng, (k, n), dev)
    if case == "w off 16":
        w8 = _offset_view(w8, 8)
    if case == "x off 16":
        x8 = _offset_view(x8, 4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p = launch_plan(m, n, k, sms, False, x8.data_ptr(), w8.data_ptr())
    copy = case in ("n%16", "k%16", "w off 16", "x off 16")
    assert (p.tile, p.route) == (0, "copy" if copy else "tma")
    bvec = _i32(rng, 256, 4096, (n,), dev)
    bias = _i32(rng, -5000, 5000, (n,), dev)
    for spec in _decode_specs():
        got = int8_matmul(x8, w8, spec, bias32=bias, b_vec=bvec)
        assert torch.equal(got, int8_matmul_plain(x8, w8, spec, bias, bvec))


def test_decode_launch_allocates_no_workspace(dev, monkeypatch):
    """A split decode launch (cluster 4, dense and packed) allocates no
    workspace (``torch.zeros`` raises) and runs one device kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.int8_matmul import (int8_matmul_nibbles,
                                                 int8_matmul_nibbles_plain)
    rng = np.random.default_rng(7)
    x8, w8 = _i8(rng, (4, 4096), dev), _i8(rng, (4096, 4096), dev)
    raw = RequantSpec.raw()
    want = int8_matmul_plain(x8, w8, raw)
    want_p = int8_matmul_nibbles_plain(x8, w8[:2048], raw)
    int8_matmul(x8, w8, raw)
    int8_matmul_nibbles(x8, w8[:2048], raw)
    torch.cuda.synchronize()

    def refuse(*a, **kw):
        raise AssertionError("torch.zeros in a decode launch")

    monkeypatch.setattr(torch, "zeros", refuse)
    for fn, w, ref in ((int8_matmul, w8, want),
                       (int8_matmul_nibbles, w8[:2048], want_p)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = fn(x8, w, raw)
            torch.cuda.synchronize()
        calls = sum(ev.count for ev in prof.key_averages()
                    if ev.device_type == DeviceType.CUDA)
        assert calls == 1
        assert torch.equal(got, ref)


@pytest.mark.parametrize("subtract_mean", [False, True])
def test_int_layernorm_kernel(dev, subtract_mean):
    rng = np.random.default_rng(40)
    d = 384
    plan = inorms.make_inorm(d, 2.0 ** -9, 8192, 2 / 127, 8 / 127,
                             subtract_mean)
    q = _i32(rng, -8192, 8193, (5, d), dev)
    q[0] = 17                                      # sigma == 0 row
    g = _i32(rng, -127, 128, (d,), dev)
    b = _i32(rng, -9000, 9000, (d,), dev) if subtract_mean else None
    before = kernels.LAUNCHES["int_layernorm"]
    got = int_layernorm(q, g, b, plan)
    assert kernels.LAUNCHES["int_layernorm"] == before + 1
    assert torch.equal(got, int_layernorm_plain(q, g, b, plan))


def _k2_operands(rng, rows, d, mean, beta, dev):
    """A K2 plan and operands: random rows, a constant row (sigma 0) and,
    past two rows, one just under qmax_in (a large mean) and one
    alternating +-qmax_in."""
    plan = inorms.make_inorm(d, 2.0 ** -9, 8192, 2 / 127, 8 / 127, mean)
    q = _i32(rng, -8192, 8193, (rows, d), dev)
    q[0] = 17
    if rows > 2:
        q[1] = 8192 - _i32(rng, 0, 200, (d,), dev)
        q[2] = torch.where(torch.arange(d, device=dev) % 2 == 0, 8192,
                           -8192).to(torch.int32)
    g = _i32(rng, -127, 128, (d,), dev)
    b = _i32(rng, -9000, 9000, (d,), dev) if beta else None
    return plan, q, g, b


@pytest.mark.parametrize("d", [64, 384, 768, 1002, 1024, 3840, 4096, 8191])
@pytest.mark.parametrize("rows", [1, 4, 5, 128, 1031])
@pytest.mark.parametrize("mean,beta", [(True, True), (True, False),
                                       (False, False), (False, True)])
def test_int_layernorm_kernel_shapes(dev, d, rows, mean, beta):
    """Both routes (a warp a row up to d = 1024, a CTA a row past it), int4
    and one-int vectors (d % 4 != 0 at 1002 and 8191), a persistent grid
    that wraps (1031 rows), LayerNorm and RMSNorm with and without beta:
    one launch, the plain version's integers."""
    rng = np.random.default_rng(d * 8 + rows)
    plan, q, g, b = _k2_operands(rng, rows, d, mean, beta, dev)
    before = kernels.LAUNCHES["int_layernorm"]
    got = int_layernorm(q, g, b, plan)
    assert kernels.LAUNCHES["int_layernorm"] == before + 1
    assert torch.equal(got, int_layernorm_plain(q, g, b, plan))


@pytest.mark.parametrize("d", [768, 1024, 3840, 4096])
@pytest.mark.parametrize("off", [1, 2])
@pytest.mark.parametrize("which", ["q", "gamma", "beta"])
def test_int_layernorm_kernel_off_alignment(dev, d, off, which):
    """An operand 4 or 8 bytes off 16-byte alignment takes the one-int
    vectors, and stays exact."""
    from repro_torch.kernels.int_layernorm import launch_plan
    rng = np.random.default_rng(d + off)
    plan, q, g, b = _k2_operands(rng, 37, d, True, True, dev)
    ops = {"q": q, "gamma": g, "beta": b}
    t = ops[which]
    flat = torch.empty(t.numel() + 4, dtype=torch.int32, device=dev)
    view = flat[off:off + t.numel()].view(t.shape)
    view.copy_(t)
    ops[which] = view
    assert view.data_ptr() % 16 == 4 * off
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert launch_plan(37, d, sms, False).vec == 1
    got = int_layernorm(ops["q"], ops["gamma"], ops["beta"], plan)
    assert torch.equal(got, int_layernorm_plain(q, g, b, plan))


def test_int_layernorm_one_launch_no_workspace(dev, monkeypatch):
    """A K2 call on either route runs one device kernel and allocates no
    workspace (``torch.zeros`` raises)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(9)
    cases = [_k2_operands(rng, 128, d, d == 768, d == 768, dev)
             for d in (768, 4096)]
    wants = [int_layernorm_plain(q, g, b, p) for p, q, g, b in cases]
    for p, q, g, b in cases:
        int_layernorm(q, g, b, p)
    torch.cuda.synchronize()

    def refuse(*a, **kw):
        raise AssertionError("torch.zeros in a K2 launch")

    monkeypatch.setattr(torch, "zeros", refuse)
    for (p, q, g, b), want in zip(cases, wants):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = int_layernorm(q, g, b, p)
            torch.cuda.synchronize()
        calls = sum(ev.count for ev in prof.key_averages()
                    if ev.device_type == DeviceType.CUDA)
        assert calls == 1
        assert torch.equal(got, want)


def test_int_layernorm_refuses_what_it_cannot_take(dev):
    """A row longer than the kernel's 8192 raises a ValueError naming it."""
    plan = inorms.make_inorm(8200, 2.0 ** -9, 4096, 2 / 127, 8 / 127)
    q = torch.zeros((2, 8200), dtype=torch.int32, device=dev)
    g = torch.ones(8200, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="8200"):
        int_layernorm(q, g, None, plan)


def test_isqrt_fast_matches_isqrt16_on_every_int32(dev):
    """The kernel's O(1) sqrt == the reference's 16 Newton steps on every
    n in [-1, 2^31)."""
    from repro_torch.kernels.int_layernorm import isqrt_mismatches
    assert isqrt_mismatches() == 0


@pytest.mark.parametrize("hd", [32, 64, 120, 128])
@pytest.mark.parametrize("fold", [False, True])
def test_attention_kernels(dev, hd, fold):
    """K3 (Sq 1 and 3) and K4 (chunks of 1, 7, 32 and 64 rows) over a
    permuted page table of 8-, 16- and 64-row pages with ragged lengths,
    per-tensor, per-channel and raw epilogues, wo fold on/off."""
    rng = np.random.default_rng(hd + fold)
    b, h, hkv = 3, 4, 2
    plan = iattn.make_iattention(hd, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    kw = {}
    if fold:
        kw = dict(wo=QuantLinearParams(_i8(rng, (h * hd, 40), dev),
                                       _i32(rng, 1000, 30000, (40,), dev),
                                       _i32(rng, -500, 500, (40,), dev)),
                  wo_spec=RequantSpec.per_channel(28, 7, 14))
    bvec = _i32(rng, 1000, 20000, (h * hd,), dev)
    vl = torch.tensor([1, 37, 64], dtype=torch.int32, device=dev)
    requants = [RequantSpec.per_tensor(plan.dn_out)]
    if not fold:
        requants += [RequantSpec.per_channel(22, 8), RequantSpec.raw()]
    for ps in (16, 8, 64):
        maxp = -(-160 // ps)                  # spans >= vl + 64 positions
        num_pages = b * maxp + 1
        kp = _i8(rng, (num_pages, ps, hkv, hd), dev)
        vp = _i8(rng, (num_pages, ps, hkv, hd), dev)
        pages = torch.as_tensor(rng.permutation(np.arange(1, num_pages))
                                .reshape(b, maxp).astype(np.int32),
                                device=dev)
        launches = [(sq, int_decode_attention_fused,
                     int_decode_attention_plain, "int_decode_attention",
                     vl + sq - 1) for sq in (1, 3)]
        launches += [(c, int_paged_prefill_fused, int_paged_prefill_plain,
                      "int_paged_prefill", vl + c) for c in (1, 7, 32, 64)]
        for rq in requants:
            for sq, fused, plain, name, lens in launches:
                q8 = _i8(rng, (b, sq, h, hd), dev)
                before = kernels.LAUNCHES[name]
                got = fused(q8, kp, vp, plan, lens, pages, ps, requant=rq,
                            b_vec=bvec, **kw)
                assert kernels.LAUNCHES[name] == before + 1
                want = plain(q8, kp, vp, plan, lens, pages, ps, requant=rq,
                             b_vec=bvec, **kw)
                assert torch.equal(got, want), (name, sq, ps, rq.kind)


@pytest.mark.parametrize("d", [32, 64, 120, 128])
@pytest.mark.parametrize("sq", [1, 3, 8])
@pytest.mark.parametrize("operands", ["random", "misaligned"])
def test_contiguous_decode_attention_kernel(dev, d, sq, operands):
    """K3 over a contiguous (B, L, Hkv, D) cache (no page table): lanes at
    valid_len 0, 1, 37 and L = 100 (no tile divides it), the stepped mask
    at Sq 3 and 8, every epilogue, wo folded; ``misaligned``: q and the
    caches 4 bytes off 16-byte alignment."""
    rng = np.random.default_rng(d + sq)
    b, L, h, hkv = 4, 100, 4, 2
    plan = iattn.make_iattention(d, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    q8 = _i8(rng, (b, sq, h, d), dev)
    k8 = _i8(rng, (b, L, hkv, d), dev)
    v8 = _i8(rng, (b, L, hkv, d), dev)
    if operands == "misaligned":
        q8, k8, v8 = (_offset_view(x, 4) for x in (q8, k8, v8))
    vl = torch.tensor([0, 1, 37, L], dtype=torch.int32, device=dev)
    bvec = _i32(rng, 1000, 20000, (h * d,), dev)
    wo = dict(wo=QuantLinearParams(_i8(rng, (h * d, 40), dev),
                                   _i32(rng, 1000, 30000, (40,), dev),
                                   _i32(rng, -500, 500, (40,), dev)),
              wo_spec=RequantSpec.per_channel(28, 7, 14))
    for kw in (dict(requant=RequantSpec.per_tensor(plan.dn_out)),
               dict(requant=RequantSpec.per_channel(22, 8), b_vec=bvec),
               dict(requant=RequantSpec.raw()),
               dict(requant=RequantSpec.per_tensor(plan.dn_out), **wo)):
        before = kernels.LAUNCHES["int_decode_attention"]
        got = int_decode_attention_fused(q8, k8, v8, plan, vl, **kw)
        assert kernels.LAUNCHES["int_decode_attention"] == before + 1
        want = int_decode_attention_plain(q8, k8, v8, plan, vl, **kw)
        assert torch.equal(got, want), kw["requant"].kind


def test_decode_attention_refuses_what_it_cannot_take(dev):
    """A head dim K3 is not compiled for names its ROADMAP item; a
    contiguous cache whose shape does not match q raises; nothing
    launches."""
    plan = iattn.make_iattention(48, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    q8 = torch.zeros((2, 1, 4, 48), dtype=torch.int8, device=dev)
    kv = torch.zeros((2, 16, 2, 48), dtype=torch.int8, device=dev)
    vl = torch.tensor([3, 16], dtype=torch.int32, device=dev)
    before = kernels.LAUNCHES["int_decode_attention"]
    with pytest.raises(ValueError, match="ROADMAP §2 item 4"):
        int_decode_attention_fused(q8, kv, kv, plan, vl)
    plan = iattn.make_iattention(32, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    q8 = torch.zeros((2, 1, 4, 32), dtype=torch.int8, device=dev)
    kv = torch.zeros((3, 16, 2, 32), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="contiguous cache"):
        int_decode_attention_fused(q8, kv, kv, plan, vl)
    assert kernels.LAUNCHES["int_decode_attention"] == before


@pytest.mark.parametrize("mode", ["paged", "contiguous"])
@pytest.mark.parametrize("new", [6, 70])
def test_window_engine_cuda_matches_torch_ref(dev, mode, new):
    """Reduced h2o-danube-3-4b at its own head dim 120 on the card: the
    kernels' token streams equal the plain backend's in both cache modes,
    before and through the rolling window's wrap (window 64, cache_len
    80, 70 new tokens a lane); K1, K2 and K3 launch, K4 never
    (token-streaming prefill)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.quant import convert
    from repro_torch.serving import Request, ServingEngine
    cfg = M.reduce_config(get_config("h2o-danube-3-4b"), dtype="float32",
                          head_dim=120, num_layers=1)
    assert cfg.window == 64 and cfg.hd == 120
    qp, plans = convert.init_quantized(cfg, seed=0, device=dev)
    streams = {}
    for backend in ("cuda", "torch_ref"):
        eng = ServingEngine(qp, plans, cfg, batch_size=2, cache_len=80,
                            ops=backend, device=dev, cache_mode=mode,
                            fold_wo=mode == "paged")
        reqs = [Request(uid=i, prompt=[1 + i, 7, 3, 9, 4, 2, 8][:3 + 4 * i],
                        max_new_tokens=new) for i in range(2)]
        for r in reqs:
            eng.submit(r)
        kernels.reset_launches()
        eng.run_until_done(max_steps=400)
        if backend == "cuda":
            for name in ("int8_matmul", "int_layernorm",
                         "int_decode_attention"):
                assert kernels.LAUNCHES[name] > 0, name
            assert kernels.LAUNCHES["int_paged_prefill"] == 0
        streams[backend] = [r.out_tokens for r in reqs]
    assert streams["cuda"] == streams["torch_ref"]
    assert all(len(st) == new for st in streams["cuda"])


def test_window_prefill_return_cache_cuda_matches_torch_ref(dev):
    """``int_prefill(return_cache=True)`` of reduced h2o-danube-3-4b at
    head dim 120 (K5 windowed, then K3 over the contiguous cache token by
    token, past the window): logits and caches equal the plain
    backend's."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import inttransformer as it
    from repro_torch.models import model as M
    from repro_torch.quant import convert
    cfg = M.reduce_config(get_config("h2o-danube-3-4b"), dtype="float32",
                          head_dim=120)
    qp, plans = convert.init_quantized(cfg, seed=0, device=dev)
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        1, cfg.vocab, (2, 90)), device=dev)
    out = {}
    for backend in ("cuda", "torch_ref"):
        kernels.reset_launches()
        out[backend] = it.int_prefill(qp, {"tokens": toks}, plans, cfg,
                                      ops=backend, return_cache=True,
                                      cache_len=100)
        if backend == "cuda":
            assert kernels.LAUNCHES["int_attention_fused"] == cfg.num_layers
            assert kernels.LAUNCHES["int_decode_attention"] \
                == 90 * cfg.num_layers
    (lc, cc), (lr, cr) = out["cuda"], out["torch_ref"]
    assert torch.equal(lc, lr)
    assert cc[0]["k8"].shape[2] == 64                 # the rolling window
    for a, c in zip(cc, cr):
        assert torch.equal(a["k8"], c["k8"]) and torch.equal(a["v8"], c["v8"])


def _k4_setup(rng, dev, b, ps, maxp, hkv, d):
    num_pages = b * maxp + 1
    kp = _i8(rng, (num_pages, ps, hkv, d), dev)
    vp = _i8(rng, (num_pages, ps, hkv, d), dev)
    pages = rng.permutation(np.arange(1, num_pages)).reshape(b, maxp)
    return kp, vp, pages.astype(np.int32)


@pytest.mark.parametrize("c", [1, 7, 32, 96])
def test_paged_prefill_empty_rows_and_null_page(dev, c):
    """K4 where a lane's pos_end < C (its first C - pos_end rows see no
    key and write requant(0)), a lane whose table is all the null page
    (as the engine gives lanes outside a prefill round), a lane with no
    live key at all, at a KV group of 4: the plain version's integers,
    in one launch."""
    rng = np.random.default_rng(c)
    b, h, hkv, d, ps, maxp = 4, 8, 2, 64, 16, 8
    plan = iattn.make_iattention(d, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    kp, vp, pages = _k4_setup(rng, dev, b, ps, maxp, hkv, d)
    pages[1] = 0                                       # the null page
    pages = torch.as_tensor(pages, device=dev)
    pos_end = torch.tensor([max(c // 2, 1), c, 0, 100 + c],
                           dtype=torch.int32, device=dev)
    q8 = _i8(rng, (b, c, h, d), dev)
    rq = RequantSpec.per_tensor(plan.dn_out)
    want = int_paged_prefill_plain(q8, kp, vp, plan, pos_end, pages, ps,
                                   requant=rq)
    before = kernels.LAUNCHES["int_paged_prefill"]
    got = int_paged_prefill_fused(q8, kp, vp, plan, pos_end, pages, ps,
                                  requant=rq)
    assert kernels.LAUNCHES["int_paged_prefill"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("ps,maxp,d", [(16, 8, 128), (1, 300, 32),
                                       (64, 40, 64)])
def test_paged_prefill_pools_off_alignment(dev, ps, maxp, d):
    """K4 with q8 and both pools 4 or 8 bytes past a 16-byte boundary (K
    then travels in 4-byte copies), one-row pages, and a span too long
    for the e16 store (2560 positions: sweep 2 recomputes)."""
    from repro_torch.kernels.int_attention_fused import k4_launch_plan
    rng = np.random.default_rng(ps + maxp)
    b, c, h, hkv = 2, 32, 4, 1
    plan = iattn.make_iattention(d, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    kp, vp, pages = _k4_setup(rng, dev, b, ps, maxp, hkv, d)
    pages = torch.as_tensor(pages, device=dev)
    q8 = _offset_view(_i8(rng, (b, c, h, d), dev), 4)
    kp, vp = _offset_view(kp, 4), _offset_view(vp, 8)
    kplan = k4_launch_plan(b, c, h, hkv, d, maxp, ps, kp.data_ptr())
    assert not kplan.vec_k
    assert kplan.store_e16 == (maxp * ps <= 1536)
    pos_end = torch.tensor([c + 5, maxp * ps], dtype=torch.int32,
                           device=dev)
    bvec = _i32(rng, 1000, 20000, (h * d,), dev)
    for rq in (RequantSpec.per_channel(22, 8), RequantSpec.raw()):
        before = kernels.LAUNCHES["int_paged_prefill"]
        got = int_paged_prefill_fused(q8, kp, vp, plan, pos_end, pages, ps,
                                      requant=rq, b_vec=bvec)
        assert kernels.LAUNCHES["int_paged_prefill"] == before + 1
        want = int_paged_prefill_plain(q8, kp, vp, plan, pos_end, pages,
                                       ps, requant=rq, b_vec=bvec)
        assert torch.equal(got, want), rq.kind


def test_attention_kernels_refuse_overlong_page_tables(dev):
    """A page table spanning more than MAX_ROWSUM_LEN positions would
    leave the exact int32 row sum: the wrappers raise before launching."""
    from repro_torch.analysis.budgets import MAX_ROWSUM_LEN
    rng = np.random.default_rng(7)
    plan = iattn.make_iattention(32, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    kp = _i8(rng, (3, 16, 2, 32), dev)
    pages = torch.ones((1, MAX_ROWSUM_LEN // 16 + 1), dtype=torch.int32,
                       device=dev)
    vl = torch.tensor([5], dtype=torch.int32, device=dev)
    for fused, sq in ((int_decode_attention_fused, 1),
                      (int_paged_prefill_fused, 16)):
        q8 = _i8(rng, (1, sq, 4, 32), dev)
        with pytest.raises(ValueError, match="row sum"):
            fused(q8, kp, kp, plan, vl + sq, pages, 16)


@pytest.mark.parametrize("geometry", [dict(), dict(page_size=8,
                                                   prefill_chunk=8)],
                         ids=["ps16", "ps8-chunk8"])
def test_engine_cuda_matches_torch_ref(dev, geometry):
    """A reduced engine on the card: the kernels' token streams (on
    ``cuda`` and on ``cuda_online``, which serves through the same K3/K4)
    equal the plain backend's, and every kernel of the path launched —
    small pages and chunks included (the kernels take any page size or
    chunk)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.quant import convert
    from repro_torch.serving import Request, ServingEngine
    cfg = M.reduce_config(get_config("llama3-8b"), dtype="float32")
    qp, plans = convert.init_quantized(cfg, seed=0, device=dev)
    streams = {}
    for backend in ("cuda", "cuda_online", "torch_ref"):
        eng = ServingEngine(qp, plans, cfg, batch_size=2, cache_len=64,
                            ops=backend, device=dev, **geometry)
        reqs = [Request(uid=i, prompt=[1 + i] * (5 + 9 * i),
                        max_new_tokens=4) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        kernels.reset_launches()
        eng.run_until_done()
        if backend == "cuda":
            for name in ("int8_matmul", "int_layernorm",
                         "int_decode_attention", "int_paged_prefill"):
                assert kernels.LAUNCHES[name] > 0, name
        streams[backend] = [r.out_tokens for r in reqs]
    assert streams["cuda"] == streams["cuda_online"] == streams["torch_ref"]


def _packed_pools(rng, dev, num_pages, ps, hkv, d):
    """Packed int4 pools (bytes from all 256 values) and per-page K and V
    shifts drawn independently from 0..7."""
    kp, vp = (torch.as_tensor(rng.integers(-128, 128, (num_pages, ps, hkv,
                                                       d // 2))
                              .astype(np.int8), device=dev)
              for _ in range(2))
    ks, vs = (_i32(rng, 0, 8, (num_pages,), dev) for _ in range(2))
    return kp, vp, (ks, vs)


@pytest.mark.parametrize("d", [32, 64, 120, 128])
@pytest.mark.parametrize("ps", [1, 8, 16, 64])
@pytest.mark.parametrize("operands", ["random", "misaligned"])
def test_packed_attention_kernels(dev, d, ps, operands):
    """K3 (Sq 1 and 4) and K4 (chunks of 1, 7 and 32 rows) over packed int4
    pools through a permuted page table: a lane mapped to the null page,
    ragged lengths, per-page shifts 0..7 differing between K and V, wo
    folded and not, q and the pools 4 bytes off 16-byte alignment.  Each
    launch counts under its packed name (``*_kv4``), never under the int8
    one, and equals the plain version (unpack_kv_pool, then the int8
    plain version)."""
    rng = np.random.default_rng(d * ps + (operands == "misaligned"))
    b, h, hkv = 4, 8, 2
    plan = iattn.make_iattention(d, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    maxp = -(-160 // ps)
    num_pages = b * maxp + 1
    kp, vp, shifts = _packed_pools(rng, dev, num_pages, ps, hkv, d)
    pages = rng.permutation(np.arange(1, num_pages)).reshape(b, maxp)
    pages[1] = 0
    pages = torch.as_tensor(pages.astype(np.int32), device=dev)
    if operands == "misaligned":
        kp, vp = _offset_view(kp, 4), _offset_view(vp, 4)
    vl = torch.tensor([1, 37, 64, 96], dtype=torch.int32, device=dev)
    wo = dict(wo=QuantLinearParams(_i8(rng, (h * d, 40), dev),
                                   _i32(rng, 1000, 30000, (40,), dev),
                                   _i32(rng, -500, 500, (40,), dev)),
              wo_spec=RequantSpec.per_channel(28, 7, 14))
    launches = [(sq, int_decode_attention_fused, int_decode_attention_plain,
                 "int_decode_attention", vl + sq - 1) for sq in (1, 4)]
    launches += [(c, int_paged_prefill_fused, int_paged_prefill_plain,
                  "int_paged_prefill", vl + c) for c in (1, 7, 32)]
    for sq, fused, plain, name, lens in launches:
        for kw in ({}, wo):
            q8 = _i8(rng, (b, sq, h, d), dev)
            if operands == "misaligned":
                q8 = _offset_view(q8, 4)
            before = dict(kernels.LAUNCHES)
            got = fused(q8, kp, vp, plan, lens, pages, ps, kv_shifts=shifts,
                        **kw)
            assert kernels.LAUNCHES[name + "_kv4"] == before[name + "_kv4"] + 1
            assert kernels.LAUNCHES[name] == before[name]
            want = plain(q8, kp, vp, plan, lens, pages, ps, kv_shifts=shifts,
                         **kw)
            assert torch.equal(got, want), (name, sq, bool(kw))


def test_packed_attention_epilogues_and_shift_range(dev):
    """K3 and K4 over packed pools with per-channel and raw epilogues, and
    every page at each shift 0..7 in turn (5..7 wrap q4 << s in int8)."""
    rng = np.random.default_rng(11)
    b, h, hkv, d, ps, maxp = 2, 4, 1, 128, 16, 6
    plan = iattn.make_iattention(d, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    kp, vp, _ = _packed_pools(rng, dev, b * maxp + 1, ps, hkv, d)
    pages = torch.as_tensor(np.arange(1, b * maxp + 1, dtype=np.int32)
                            .reshape(b, maxp), device=dev)
    vl = torch.tensor([50, 96], dtype=torch.int32, device=dev)
    bvec = _i32(rng, 1000, 20000, (h * d,), dev)
    for s in range(8):
        full = torch.full((b * maxp + 1,), s, dtype=torch.int32, device=dev)
        shifts = (full, torch.full_like(full, 7 - s))
        for rq in (RequantSpec.per_channel(22, 8), RequantSpec.raw()):
            for fused, plain, sq in ((int_decode_attention_fused,
                                      int_decode_attention_plain, 1),
                                     (int_paged_prefill_fused,
                                      int_paged_prefill_plain, 16)):
                q8 = _i8(rng, (b, sq, h, d), dev)
                args = (q8, kp, vp, plan, vl, pages, ps)
                kw = dict(requant=rq, b_vec=bvec, kv_shifts=shifts)
                assert torch.equal(fused(*args, **kw), plain(*args, **kw)), \
                    (s, rq.kind, sq)


def test_packed_attention_refuses_what_it_cannot_take(dev):
    """Packed pools need the paged layout, pools of D / 2 bytes a row and
    two (num_pages,) shift vectors: the wrappers raise before launching."""
    rng = np.random.default_rng(3)
    plan = iattn.make_iattention(64, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    kp, vp, shifts = _packed_pools(rng, dev, 5, 16, 2, 64)
    pages = torch.ones((1, 2), dtype=torch.int32, device=dev)
    vl = torch.tensor([5], dtype=torch.int32, device=dev)
    q8 = _i8(rng, (1, 1, 4, 64), dev)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="paged"):
        int_decode_attention_fused(q8, kp, vp, plan, vl, kv_shifts=shifts)
    wide = _i8(rng, (5, 16, 2, 64), dev)
    for fused in (int_decode_attention_fused, int_paged_prefill_fused):
        with pytest.raises(ValueError, match="int4"):
            fused(q8, wide, wide, plan, vl, pages, 16, kv_shifts=shifts)
        with pytest.raises(ValueError, match="kv_shifts"):
            fused(q8, kp, vp, plan, vl, pages, 16,
                  kv_shifts=(shifts[0][:4], shifts[1]))
    assert dict(kernels.LAUNCHES) == before


def test_engine_int4_cuda_matches_torch_ref(dev):
    """A reduced engine over int4 pages on the card: ``cuda`` and
    ``cuda_online`` streams equal ``torch_ref``'s, and the packed K3 and
    K4 launched while the int8 ones did not."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.quant import convert
    from repro_torch.serving import Request, ServingEngine
    cfg = M.reduce_config(get_config("llama3-8b"), dtype="float32")
    qp, plans = convert.init_quantized(cfg, seed=0, device=dev)
    streams = {}
    for backend in ("cuda", "cuda_online", "torch_ref"):
        eng = ServingEngine(qp, plans, cfg, batch_size=2, cache_len=64,
                            ops=backend, device=dev, kv_dtype="int4",
                            page_size=8, prefill_chunk=8)
        reqs = [Request(uid=i, prompt=[1 + i] * (5 + 9 * i),
                        max_new_tokens=4) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        kernels.reset_launches()
        eng.run_until_done()
        if backend == "cuda":
            for name in ("int8_matmul", "int_layernorm",
                         "int_decode_attention_kv4", "int_paged_prefill_kv4"):
                assert kernels.LAUNCHES[name] > 0, name
            for name in ("int_decode_attention", "int_paged_prefill"):
                assert kernels.LAUNCHES[name] == 0, name
        streams[backend] = [r.out_tokens for r in reqs]
    assert streams["cuda"] == streams["cuda_online"] == streams["torch_ref"]


# K3 (csrc/int_decode_attention.cu): one group of blocks per (lane, KV
# head), the key range split across a cluster.  A case runs each layout
# (the contiguous cache, int8 pools, packed int4 pools) on lanes at
# valid_len 0, 1, the span and a ragged length, a lane on the null page


def _k3_operands(rng, dev, layout, b, sq, h, hkv, d, length, ps=16,
                 off=0):
    """q8 and the K / V operands of one K3 case and its keyword arguments;
    ``off``: q and K / V that many bytes off 16-byte alignment."""
    q8 = _i8(rng, (b, sq, h, d), dev)
    kw = {}
    if layout == "contiguous":
        k8, v8 = _i8(rng, (b, length, hkv, d), dev), _i8(rng, (b, length,
                                                               hkv, d), dev)
        span = length
    else:
        maxp = -(-length // ps)
        span, num = maxp * ps, b * maxp + 1
        pages = rng.permutation(np.arange(1, num)).reshape(b, maxp)
        pages[min(2, b - 1)] = 0
        kw = dict(pages=torch.as_tensor(pages.astype(np.int32), device=dev),
                  page_size=ps)
        if layout == "kv4":
            k8, v8, kw["kv_shifts"] = _packed_pools(rng, dev, num, ps, hkv, d)
        else:
            k8, v8 = (_i8(rng, (num, ps, hkv, d), dev) for _ in range(2))
    if off:
        q8, k8, v8 = (_offset_view(x, off) for x in (q8, k8, v8))
    lens = [0, 1, span, span // 2 + 3][:b] if b > 1 else [span]
    vl = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q8, k8, v8, vl, kw, span


def _k3_check(q8, k8, v8, plan, vl, kw):
    """One K3 call: exactly one launch under its counter, the plain
    version's integers."""
    name = ("int_decode_attention_kv4" if "kv_shifts" in kw
            else "int_decode_attention")
    before = dict(kernels.LAUNCHES)
    got = int_decode_attention_fused(q8, k8, v8, plan, vl, **kw)
    assert kernels.LAUNCHES[name] == before[name] + 1
    assert sum(kernels.LAUNCHES.values()) == sum(before.values()) + 1
    want = int_decode_attention_plain(q8, k8, v8, plan, vl, **kw)
    assert torch.equal(got, want), (name, {k: v for k, v in kw.items()
                                           if k == "requant"})


def _k3_plan(dev, q8, k8, v8, kw, span):
    from repro_torch.kernels.int_decode_attention import k3_launch_plan
    b, sq, h, d = q8.shape
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return k3_launch_plan(b, sq, h, k8.shape[2], d, span, "pages" in kw,
                          "kv_shifts" in kw, k8.data_ptr(), v8.data_ptr(),
                          sms)


def _k3_requants(plan, rng, h, d, dev):
    bvec = _i32(rng, 1000, 20000, (h * d,), dev)
    return [dict(requant=RequantSpec.per_tensor(plan.dn_out)),
            dict(requant=RequantSpec.per_channel(22, 8), b_vec=bvec),
            dict(requant=RequantSpec.raw()),
            dict(requant=RequantSpec.per_channel(20, 6, out_bits=16),
                 b_vec=bvec)]


@pytest.mark.parametrize("d", [32, 64, 120, 128])
@pytest.mark.parametrize("sq", range(1, 9))
@pytest.mark.parametrize("group", [1, 4, 8])
def test_decode_attention_kernel_shapes(dev, d, sq, group):
    """K3 at every Sq 1..8, head dim and GQA group 1 / 4 / 8 (G Sq up to
    64 rows: one or two m16 tiles a block, one or two row blocks), each
    layout, the four epilogue forms in turn."""
    rng = np.random.default_rng(1000 * d + 10 * sq + group)
    plan = iattn.make_iattention(d, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    hkv = 2
    h = group * hkv
    rqs = _k3_requants(plan, rng, h, d, dev)
    for i, layout in enumerate(("contiguous", "paged", "kv4")):
        q8, k8, v8, vl, kw, span = _k3_operands(rng, dev, layout, 4, sq, h,
                                                hkv, d, 300)
        p = _k3_plan(dev, q8, k8, v8, kw, span)
        assert p.mtb == (2 if group * sq > 16 else 1)
        assert p.grid[1] == -(-group * sq // 32)
        _k3_check(q8, k8, v8, plan, vl, dict(kw, **rqs[(sq + i) % 4]))


# (span, cluster the plan takes on a 132-SM card for 3 lanes x 2 KV heads)
_K3_CLUSTERS = [(30, 1), (80, 2), (200, 4), (1000, 8)]


@pytest.mark.parametrize("span,cluster", _K3_CLUSTERS)
@pytest.mark.parametrize("layout", ["contiguous", "paged", "kv4"])
def test_decode_attention_kernel_clusters(dev, span, cluster, layout):
    """K3 at each cluster size the plan chooses (1, 2, 4, 8 ranks), each
    layout, Sq 1 and 5, GQA 4."""
    rng = np.random.default_rng(span + len(layout))
    plan = iattn.make_iattention(64, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    for sq in (1, 5):
        q8, k8, v8, vl, kw, L = _k3_operands(rng, dev, layout, 3, sq, 8, 2,
                                             64, span, ps=8)
        p = _k3_plan(dev, q8, k8, v8, kw, L)
        if torch.cuda.get_device_properties(dev).multi_processor_count \
                == 132:
            assert p.cluster == cluster
        assert p.resident
        _k3_check(q8, k8, v8, plan, vl,
                  dict(kw, requant=RequantSpec.per_tensor(plan.dn_out)))


@pytest.mark.parametrize("layout", ["contiguous", "paged", "kv4"])
@pytest.mark.parametrize("d,sq,group", [(128, 1, 4), (120, 8, 4),
                                        (64, 3, 8), (32, 2, 1)])
def test_decode_attention_kernel_streaming(dev, layout, d, sq, group):
    """K3's streaming route: a 32 768-position span (MAX_ROWSUM_LEN: the
    longest exact row sum), 8 ranks of 4096 keys streaming through tiles
    of 128, lanes at the full span and a ragged length; and the resident
    route at the full 4096-position window beside it (but for packed
    pools at D 120 with 32 rows, whose resident block needs 232 704
    bytes, 256 more than a block may have: they stream there too)."""
    rng = np.random.default_rng(d + sq + group)
    plan = iattn.make_iattention(d, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    hkv = 2
    too_big = layout == "kv4" and d == 120 and group * sq > 16
    for span, resident in ((32768, False), (4096, not too_big)):
        q8, k8, v8, vl, kw, L = _k3_operands(rng, dev, layout, 2, sq,
                                             group * hkv, hkv, d, span)
        vl = torch.tensor([L, L // 3 + 5], dtype=torch.int32, device=dev)
        p = _k3_plan(dev, q8, k8, v8, kw, L)
        assert p.resident == resident and p.cluster == 8
        _k3_check(q8, k8, v8, plan, vl,
                  dict(kw, requant=RequantSpec.per_tensor(plan.dn_out)))


@pytest.mark.parametrize("layout", ["contiguous", "paged", "kv4"])
@pytest.mark.parametrize("d", [32, 64, 120, 128])
@pytest.mark.parametrize("off", [4, 8])
def test_decode_attention_kernel_off_alignment(dev, layout, d, off):
    """q and K / V 4 or 8 bytes off 16-byte alignment: the plan copies in
    4-byte granules (8-byte where the rows take them), and every lane,
    valid_len 0 included, stays exact; then a launch with every lane at
    valid_len 0 writes requant(0) everywhere."""
    rng = np.random.default_rng(d + off)
    plan = iattn.make_iattention(d, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    q8, k8, v8, vl, kw, L = _k3_operands(rng, dev, layout, 4, 2, 8, 2, d,
                                         200, ps=8, off=off)
    p = _k3_plan(dev, q8, k8, v8, kw, L)
    rb = d // 2 if layout == "kv4" else d
    wide = 16 if rb % 16 == 0 else 8 if rb % 8 == 0 else 4
    assert p.copy_bytes == (wide if wide <= off and off % wide == 0 else 4)
    rq = dict(requant=RequantSpec.per_tensor(plan.dn_out))
    _k3_check(q8, k8, v8, plan, vl, dict(kw, **rq))
    _k3_check(q8, k8, v8, plan, torch.zeros_like(vl), dict(kw, **rq))


def test_decode_attention_plan_matches_the_library(dev):
    """The plan's shared memory is the kernel library's own layout
    (``r8_k3_smem_bytes``) on both routes, every head dim, layout and
    number of m16 tiles, at the key counts the plan gives a rank."""
    from repro_torch.kernels._build import library
    from repro_torch.kernels.int_decode_attention import k3_smem_bytes
    lib = library()
    for d in (32, 64, 120, 128):
        for keys in (64, 128, 512, 1024, 4096):
            for mtb in (1, 2):
                for paged, packed in ((False, False), (True, False),
                                      (True, True)):
                    for resident in (False, True):
                        assert k3_smem_bytes(d, keys, mtb, paged, packed,
                                             resident) == \
                            lib.r8_k3_smem_bytes(d, keys, mtb, int(paged),
                                                 int(packed), int(resident))


# K5's edge cases: D = 32 / 64 / 128 at S = 1, 37, 100 and 1000, one key,
# every operand -128 or +127, q/k/v 4 bytes off 16-byte alignment, a
# window wider than S, Sq > Skv with rows that see no key, and key ranges
# too long for the e16 store (causal 4096, a 3000-key cross launch)
_K5_EDGES = [(1, s, s, 4, 2, d, causal, window, "random")
             for d in (32, 64, 128)
             for s, causal, window in ((1, False, 0), (37, True, 0),
                                       (100, True, 16), (1000, d != 32,
                                                         100 if d == 128
                                                         else 0))] + [
    (2, 37, 1, 4, 2, 64, False, 0, "random"),
    (2, 37, 1, 4, 2, 64, True, 0, "random"),
    (2, 100, 100, 4, 2, 64, False, 0, "min"),
    (2, 100, 100, 4, 2, 128, True, 0, "max"),
    (2, 100, 100, 4, 2, 32, False, 0, "misaligned"),
    (2, 100, 70, 4, 1, 128, True, 8, "misaligned"),
    (1, 100, 100, 4, 4, 64, True, 300, "random"),
    (2, 200, 60, 4, 2, 32, True, 16, "random"),
    (1, 4096, 4096, 2, 1, 128, True, 0, "random"),
    (1, 64, 3000, 2, 2, 128, False, 0, "random")]
# ... and at D = 120 (rows padded to 128 bytes in the k-steps, 8-byte K
# copies): S 1 to 1000, windows, cross, -128 / +127, 4 and 8 bytes off
# alignment (word copies, 8-byte copies), causal 4096 (recompute)
_K5_EDGES += [(1, s, s, 4, 2, 120, causal, window, "random")
              for s, causal, window in ((1, False, 0), (37, True, 0),
                                        (100, True, 16), (1000, True, 100))]
_K5_EDGES += [(2, 24, 80, 4, 2, 120, False, 0, "random"),
              (2, 100, 100, 4, 2, 120, False, 0, "min"),
              (2, 100, 100, 4, 2, 120, True, 0, "max"),
              (2, 100, 70, 4, 1, 120, True, 8, "misaligned"),
              (2, 100, 100, 4, 2, 120, True, 16, "misaligned8"),
              (1, 4096, 4096, 2, 1, 120, True, 0, "random")]


def _offset_view(x, off):
    """A contiguous copy of ``x`` whose data starts ``off`` bytes past a
    16-byte boundary."""
    flat = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
    y = flat[off:off + x.numel()].view(x.shape)
    y.copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16 == off
    return y


@pytest.mark.parametrize("b,sq,skv,h,hkv,d,causal,window,operands", [
    (2, 64, 64, 4, 4, 64, False, 0, "random"),
    (2, 37, 37, 4, 2, 32, True, 0, "random"),
    (1, 100, 100, 4, 1, 128, True, 16, "random"),
    (2, 24, 80, 4, 2, 64, False, 0, "random"),
    (1, 80, 24, 2, 2, 32, True, 8, "random")] + _K5_EDGES)
def test_full_sequence_attention_kernel(dev, b, sq, skv, h, hkv, d, causal,
                                        window, operands):
    """K5: ragged lengths (no block divides 37 or 100), GQA, the three
    masks, Sq != Skv both ways (Sq > Skv with a window leaves rows with no
    live key), the e16 store and its recompute, all four epilogues."""
    rng = np.random.default_rng(sq + skv + d + window)
    plan = iattn.make_iattention(d, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    if operands in ("min", "max"):
        fill = -128 if operands == "min" else 127
        q8 = torch.full((b, sq, h, d), fill, dtype=torch.int8, device=dev)
        k8 = torch.full((b, skv, hkv, d), fill, dtype=torch.int8, device=dev)
        v8 = torch.full((b, skv, hkv, d), fill, dtype=torch.int8, device=dev)
    else:
        q8 = _i8(rng, (b, sq, h, d), dev)
        k8 = _i8(rng, (b, skv, hkv, d), dev)
        v8 = _i8(rng, (b, skv, hkv, d), dev)
    if operands in ("misaligned", "misaligned8"):
        off = 8 if operands == "misaligned8" else 4
        q8, k8, v8 = (_offset_view(x, off) for x in (q8, k8, v8))
    bvec = _i32(rng, 1000, 20000, (h * d,), dev)
    for rq in (None, RequantSpec.per_channel(22, 8),
               RequantSpec.per_channel(20, 6, out_bits=16),
               RequantSpec.raw()):
        before = kernels.LAUNCHES["int_attention_fused"]
        got = int_attention_fused(q8, k8, v8, plan, rq, bvec, causal, window)
        assert kernels.LAUNCHES["int_attention_fused"] == before + 1
        want = int_attention_fused_plain(q8, k8, v8, plan, rq, bvec, causal,
                                         window)
        assert torch.equal(got, want), (rq, causal, window)


def test_full_sequence_attention_plan_matches_the_library(dev):
    """The wrapper's shared-memory formula is the kernel library's, and
    exp16's multiply-high division equals ``/`` on its whole domain on
    the card."""
    from repro_torch.kernels._build import library
    from repro_torch.kernels.int_attention_fused import (
        exp16_division_mismatches, k5_smem_bytes)
    lib = library()
    for d in (32, 64, 120, 128):
        for tiles in (0, 1, 8, 27):
            for store in (False, True):
                assert lib.r8_k5_smem_bytes(d, tiles, int(store)) \
                    == k5_smem_bytes(d, tiles, store)
    assert lib.r8_k5_smem_bytes(48, 1, 1) == -1
    for d in (32, 64, 120, 128):
        ie = iattn.make_iattention(d, 8 / 127, 8 / 127, 4 / 127,
                                   4 / 127).sm.iexp
        assert exp16_division_mismatches(ie) == 0


def test_full_sequence_attention_refuses_other_head_dims(dev):
    plan = iattn.make_iattention(48, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    q8 = torch.zeros((1, 8, 2, 48), dtype=torch.int8, device=dev)
    before = kernels.LAUNCHES["int_attention_fused"]
    with pytest.raises(ValueError, match="head dim"):
        int_attention_fused(q8, q8, q8, plan, causal=False)
    assert kernels.LAUNCHES["int_attention_fused"] == before


def test_full_sequence_attention_refuses_overlong_keys(dev):
    from repro_torch.analysis.budgets import MAX_ROWSUM_LEN
    plan = iattn.make_iattention(32, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    q8 = torch.zeros((1, 1, 1, 32), dtype=torch.int8, device=dev)
    kv = torch.zeros((1, MAX_ROWSUM_LEN + 1, 1, 32), dtype=torch.int8,
                     device=dev)
    with pytest.raises(ValueError, match="row sum"):
        int_attention_fused(q8, kv, kv, plan, causal=False)


def test_int_gelu_kernel(dev):
    """K6 on the whole 16-bit range, seeded int32 over the full range
    (int32 wrap-around) and a ragged tail."""
    rng = np.random.default_rng(8)
    plan = iact.make_igelu_act(16 / 1024, 1024, 8 / 127)
    qs = [torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32, device=dev),
          torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, 100_003)
                          .astype(np.int32), device=dev)]
    for q in qs:
        for out_bits in (8, 16):
            before = kernels.LAUNCHES["int_gelu"]
            got = int_gelu(q, plan.gelu, plan.dn_out, out_bits)
            assert kernels.LAUNCHES["int_gelu"] == before + 1
            assert torch.equal(got, int_gelu_plain(q, plan.gelu,
                                                   plan.dn_out, out_bits))


def test_encoder_prefill_cuda_matches_torch_ref(dev):
    """Reduced roberta-base (tied) through make_prefill_step on the card:
    the kernels' logits equal the plain backend's, and K1, K2, K5 and K6
    all launched."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as M
    from repro_torch.quant import convert
    cfg = dataclasses.replace(M.reduce_config(get_config("roberta-base"),
                                              dtype="float32"),
                              tie_embeddings=True)
    qp, plans = convert.init_quantized(cfg, seed=0, device=dev,
                                       embed_scale=convert.unit_embed_scale(
                                           cfg))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (3, 45))
    logits = {}
    for backend in ("cuda", "torch_ref"):
        kernels.reset_launches()
        logits[backend] = make_prefill_step(cfg, plans, ops=backend,
                                            device=dev)(qp, {"tokens": toks})
        if backend == "cuda":
            for name in ("int8_matmul", "int_layernorm",
                         "int_attention_fused", "int_gelu"):
                assert kernels.LAUNCHES[name] > 0, name
    assert torch.equal(logits["cuda"], logits["torch_ref"])


@pytest.mark.parametrize("L", [1, 4, 40, 512, 1000, 1023, 1024, 1025, 4096,
                               4100, 1 << 15])
def test_int_softmax_kernel(dev, L):
    """K7 on both of its routes (a warp a row up to 1024, a CTA a row
    beyond, the row in registers; int4 loads where L % 4 == 0, one int
    where not), with and without the padding mask (0 and past the end
    included); block_rows never changes the integers; one launch a
    call."""
    rng = np.random.default_rng(L)
    plan = iattn.make_iattention(64, 8 / 127, 8 / 127, 4 / 127, 4 / 127).sm
    rows = 3 if L == 1 << 15 else 37
    x = _i32(rng, -90000, 90000, (rows, L), dev)
    for vl in (-1, 0, L // 3, L + 2):
        want = int_softmax_plain(x, plan, vl)
        for br in (1, 8, 16):
            before = kernels.LAUNCHES["int_softmax"]
            got = int_softmax(x, plan, vl, block_rows=br)
            assert kernels.LAUNCHES["int_softmax"] == before + 1
            assert torch.equal(got, want), (vl, br)


@pytest.mark.parametrize("L", [4, 37, 512, 1024, 4100, 1 << 15])
def test_int_softmax_kernel_off_alignment(dev, L):
    """Scores 4 bytes off 16-byte alignment take one int a load and give
    the same integers; each call counts one launch."""
    from repro_torch.kernels import int_softmax as K7
    rng = np.random.default_rng(L + 7)
    plan = iattn.make_iattention(64, 8 / 127, 8 / 127, 4 / 127, 4 / 127).sm
    rows = 3 if L == 1 << 15 else 37
    x = _i32(rng, -90000, 90000, (rows, L), dev)
    flat = torch.empty(x.numel() + 4, dtype=torch.int32, device=dev)
    off = flat[1:1 + x.numel()].view(rows, L)
    off.copy_(x)
    assert off.data_ptr() % 16 == 4
    for vl in (-1, 0, 1, L // 3):
        want = int_softmax_plain(x, plan, vl)
        assert K7.launch_plan(rows, L, vl, False).vec == 1
        before = kernels.LAUNCHES["int_softmax"]
        assert torch.equal(int_softmax(off, plan, vl), want), vl
        assert kernels.LAUNCHES["int_softmax"] == before + 1


# K8's edge cases, at the blocks the cuda_online backend would fit
# (_fit_block(128, S)): D = 32 / 64 / 128 at S = 1, 37 and 1000, one key,
# every operand -128 or +127, Sq > Skv with a window and no causal mask
# (rows with no live key), bq = 4 under bkv = 128, causal 4096, the bit
# budget's edge (Skv = 65 536, also as one logical block of +127 keys,
# the largest row sum), and 1024 x 1024 blocks
_K8_EDGES = [(1, s, s, 4, 2, d, causal, window, bl, bl, 8, "random")
             for d in (32, 64, 128)
             for s, bl, causal, window in ((1, 1, False, 0),
                                           (37, 37, True, 0),
                                           (1000, 125, d != 32,
                                            100 if d == 128 else 0))] + [
    (2, 37, 1, 4, 2, 64, False, 0, 37, 1, 8, "random"),
    (2, 37, 1, 4, 2, 64, True, 0, 37, 1, 8, "random"),
    (2, 100, 100, 4, 2, 64, False, 0, 100, 100, 8, "min"),
    (2, 100, 100, 4, 2, 128, True, 0, 100, 100, 8, "max"),
    (2, 200, 60, 4, 2, 32, False, 16, 100, 60, 8, "random"),
    (1, 512, 512, 4, 2, 64, True, 0, 4, 128, 8, "random"),
    (1, 4096, 4096, 2, 1, 128, True, 0, 128, 128, 8, "random"),
    (1, 64, 65536, 2, 1, 32, False, 0, 64, 128, 8, "random"),
    (1, 64, 65536, 1, 1, 64, False, 0, 64, 65536, 8, "max"),
    (1, 1024, 1024, 1, 1, 128, False, 0, 1024, 1024, 8, "random"),
    # D = 120: K5's padded k-steps and 8-byte K copies
    (1, 37, 37, 4, 2, 120, True, 0, 37, 37, 8, "random"),
    (1, 1000, 1000, 4, 2, 120, True, 100, 125, 125, 8, "random"),
    (2, 100, 100, 4, 2, 120, False, 0, 100, 100, 8, "max")]


@pytest.mark.parametrize(
    "b,sq,skv,h,hkv,d,causal,window,bq,bkv,bits,operands", [
        (2, 64, 64, 4, 4, 64, False, 0, 16, 16, 8, "random"),
        (1, 64, 64, 4, 2, 32, True, 0, 32, 16, 8, "random"),
        (1, 64, 64, 2, 1, 128, True, 16, 16, 32, 8, "random"),
        (2, 48, 80, 4, 2, 64, False, 0, 16, 16, 8, "random"),
        (1, 80, 48, 2, 2, 32, True, 8, 16, 16, 8, "random"),
        (1, 64, 64, 2, 2, 32, False, 8, 32, 16, 16, "random"),
        (1, 131, 131, 2, 2, 64, True, 0, 1, 1, 8, "random"),
        (1, 136, 136, 2, 2, 64, True, 0, 68, 68, 8, "random"),
        (1, 256, 256, 2, 1, 128, False, 0, 256, 256, 8, "random"),
        (1, 512, 512, 2, 2, 64, True, 0, 128, 128, 8, "random")]
    + _K8_EDGES)
def test_online_attention_kernel(dev, b, sq, skv, h, hkv, d, causal, window,
                                 bq, bkv, bits, operands):
    """K8 at the reference's logical blocks: several logical query blocks
    in one warp (bq < 16), blocks of 1 and 68, the tuned 256 x 256, GQA,
    Sq != Skv both ways, a window with and without causality, a 16-bit
    clip stored as int8, and the edge cases above."""
    rng = np.random.default_rng(sq + skv + d + bq + bkv)
    plan = iattn.make_iattention(d, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    if operands in ("min", "max"):
        fill = -128 if operands == "min" else 127
        q8 = torch.full((b, sq, h, d), fill, dtype=torch.int8, device=dev)
        k8 = torch.full((b, skv, hkv, d), fill, dtype=torch.int8, device=dev)
        v8 = torch.full((b, skv, hkv, d), fill, dtype=torch.int8, device=dev)
    else:
        q8 = _i8(rng, (b, sq, h, d), dev)
        k8 = _i8(rng, (b, skv, hkv, d), dev)
        v8 = _i8(rng, (b, skv, hkv, d), dev)
    before = kernels.LAUNCHES["int_attention_online"]
    got = int_attention_online(q8, k8, v8, plan, causal, window, bq, bkv,
                               bits)
    assert kernels.LAUNCHES["int_attention_online"] == before + 1
    want = int_attention_online_plain(q8, k8, v8, plan, causal, window, bq,
                                      bkv, bits)
    assert torch.equal(got, want)


def test_online_attention_plan_matches_the_library(dev):
    """The wrapper's shared-memory formula is the kernel library's."""
    from repro_torch.kernels._build import library
    from repro_torch.kernels.int_attention import k8_smem_bytes
    lib = library()
    for d in (32, 64, 120, 128):
        assert lib.r8_online_smem_bytes(d) == k8_smem_bytes(d)
    assert lib.r8_online_smem_bytes(48) == -1


def test_online_attention_refuses_what_it_cannot_take(dev):
    """A head dim the kernel is not compiled for, and keys past the row
    sum's int32 budget.  (Logical blocks of any length are taken: the
    kernel's shared memory no longer grows with bkv.)"""
    from repro_torch.analysis.contracts import KernelContractError
    plan = iattn.make_iattention(48, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    q = torch.zeros((1, 32, 2, 48), dtype=torch.int8, device=dev)
    before = kernels.LAUNCHES["int_attention_online"]
    with pytest.raises(KernelContractError, match="head dim"):
        int_attention_online(q, q, q, plan, bq=32, bkv=32)
    plan = iattn.make_iattention(32, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    q = torch.zeros((1, 16, 1, 32), dtype=torch.int8, device=dev)
    kv = torch.zeros((1, 2 ** 16 + 16, 1, 32), dtype=torch.int8, device=dev)
    with pytest.raises(KernelContractError, match="row-sum"):
        int_attention_online(q, kv, kv, plan, bq=16, bkv=16)
    assert kernels.LAUNCHES["int_attention_online"] == before


def test_encoder_prefill_cuda_online_matches_plain(dev):
    """Reduced roberta-base through make_prefill_step(ops="cuda_online") on
    the card equals the same routing in plain PyTorch (K8's and K5's plain
    versions, ``torch_ref`` for the rest); K8 launched, K5 did not."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as M
    from repro_torch.ops.backends.cuda_online import plain_online_opset
    from repro_torch.quant import convert

    cfg = dataclasses.replace(M.reduce_config(get_config("roberta-base"),
                                              dtype="float32"),
                              tie_embeddings=True)
    qp, plans = convert.init_quantized(cfg, seed=0, device=dev,
                                       embed_scale=convert.unit_embed_scale(
                                           cfg))
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (3, 48))
    kernels.reset_launches()
    got = make_prefill_step(cfg, plans, ops="cuda_online",
                            device=dev)(qp, {"tokens": toks})
    assert kernels.LAUNCHES["int_attention_online"] == cfg.num_layers
    assert kernels.LAUNCHES["int_attention_fused"] == 0
    want = make_prefill_step(cfg, plans, ops=plain_online_opset(),
                             device=dev)(qp, {"tokens": toks})
    assert torch.equal(got, want)


# ---------------------------------------- packed K1 and the MSR-4 kernel --

def _packed_weights(rng, k, n, kind, dev, group=64):
    """Dense int8 weights (K, N) of ``kind`` and their pack on the card:
    ``int4`` in [-7, 7]; ``msr4-0`` the same packed msr4 (no lanes);
    ``msr4-1`` one outlier (-128 or 127) on row ``grp % g`` of every
    group in the even columns; ``msr4-g`` every weight an outlier (|w| >=
    8, -128 included); ``msr4`` any int8."""
    from repro_torch.quant.pack import pack_linear
    if kind in ("int4", "msr4-0", "msr4-1"):
        w = rng.integers(-7, 8, (k, n))
    elif kind == "msr4-g":
        w = rng.integers(8, 129, (k, n)) * rng.choice([-1, 1], (k, n))
    else:
        w = rng.integers(-128, 128, (k, n))
    w = np.clip(w, -128, 127).astype(np.int8)
    if kind == "msr4-1":
        g = group if k % group == 0 else k
        for grp in range(k // g):
            w[grp * g + grp % g, ::2] = -128 if grp % 2 else 127
    qw = QuantLinearParams(torch.as_tensor(w, device=dev),
                           _i32(rng, 256, 4096, (n,), dev),
                           _i32(rng, -5000, 5000, (n,), dev))
    packed = pack_linear(qw, "int4" if kind == "int4" else "msr4", group)
    return qw, packed


def _specs():
    from repro_torch.core.dyadic import fit_dyadic
    return (RequantSpec.raw(), RequantSpec.per_channel(24, 10, 11),
            RequantSpec.per_tensor(fit_dyadic(1 / 3000.0, 1 << 26)))


# M around the __dp4a tile's edge (16) and the tensor cores', K = 2 mod 4
# (an odd number of byte rows), ragged N, split K (one N tile, deep K)
_PACKED_SHAPES = ([(m, k, n) for m in (1, 5, 16, 17, 33)
                   for k, n in ((130, 260), (4096, 96), (256, 3072))]
                  + [(128, 4096, 512), (4, 8192, 256), (1000, 302, 2100),
                     (64, 14336, 200)])


@pytest.mark.parametrize("m,k,n", _PACKED_SHAPES)
@pytest.mark.parametrize("operands", ["random", "misaligned"])
def test_packed_int8_matmul_kernel(dev, m, k, n, operands):
    """K1's nibble instantiation on both tiles against its plain version,
    every epilogue, and ``int8_matmul_packed`` (int4: one launch; msr4:
    the raw launch and the correction) against the dense product;
    ``misaligned``: x and the nibbles 1 byte past a 16-byte boundary."""
    from repro_torch.kernels.int8_matmul import (
        int8_matmul_nibbles, int8_matmul_nibbles_plain, int8_matmul_packed,
        launch_plan)
    rng = np.random.default_rng(m * 7 + k + n)
    x8 = _i8(rng, (m, k), dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (launch_plan(m, n, k, sms).tile == 0) == (m <= 16)
    for kind in ("int4", "msr4"):
        dense, qw = _packed_weights(rng, k, n, kind, dev)
        wp = qw.w_packed
        if operands == "misaligned":
            x8, wp = _offset_view(x8, 1), _offset_view(wp, 1)
            qw = qw._replace(w_packed=wp)
        for spec in _specs():
            before = dict(kernels.LAUNCHES)
            got = int8_matmul_nibbles(x8, wp, spec, qw.bias32, qw.b_mult)
            assert kernels.LAUNCHES["int8_matmul_packed"] == \
                before["int8_matmul_packed"] + 1
            assert torch.equal(got, int8_matmul_nibbles_plain(
                x8, wp, spec, qw.bias32, qw.b_mult))
            before = dict(kernels.LAUNCHES)
            got = int8_matmul_packed(x8, qw, spec)
            msr = kind == "msr4"
            assert kernels.LAUNCHES["int8_matmul_packed"] == \
                before["int8_matmul_packed"] + 1
            assert kernels.LAUNCHES["int8_matmul_msr4"] == \
                before["int8_matmul_msr4"] + msr
            assert kernels.LAUNCHES["int8_matmul"] == before["int8_matmul"]
            assert torch.equal(got, int8_matmul_plain(
                x8, dense.w8, spec, dense.bias32, dense.b_mult)), (kind, spec)


@pytest.mark.parametrize("m", [4, 16])
@pytest.mark.parametrize("k,n,cluster", [(4096, 14336, 1), (512, 5120, 2),
                                         (14336, 4096, 4), (4096, 1024, 8),
                                         (3840, 960, 8)])
def test_packed_decode_kernel(dev, m, k, n, cluster):
    """The decode tile's nibble instantiation at M 4 and 16 against its
    plain version, each cluster size (the plan's on a 132-SM card), every
    epilogue; and every nibble -8 (byte 0x88) or +7 (0x77) with x -128 /
    +127 at the FFN-down depth."""
    from repro_torch.kernels.int8_matmul import (
        int8_matmul_nibbles, int8_matmul_nibbles_plain, launch_plan)
    rng = np.random.default_rng(m * 3 + k + n)
    x8, wp = _i8(rng, (m, k), dev), _i8(rng, (k // 2, n), dev)
    wp[0, :3] = -128
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p = launch_plan(m, n, k, sms, True, x8.data_ptr(), wp.data_ptr())
    assert (p.tile, p.route) == (0, "tma")
    assert sms != 132 or p.cluster == cluster
    bvec = _i32(rng, 256, 4096, (n,), dev)
    bias = _i32(rng, -5000, 5000, (n,), dev)
    for spec in _specs():
        before = kernels.LAUNCHES["int8_matmul_packed"]
        got = int8_matmul_nibbles(x8, wp, spec, bias, bvec)
        assert kernels.LAUNCHES["int8_matmul_packed"] == before + 1
        assert torch.equal(got, int8_matmul_nibbles_plain(x8, wp, spec,
                                                          bias, bvec))
    if k == 14336:
        for xv, wv in ((-128, 0x88 - 256), (127, 0x77), (-128, 0x77)):
            x = torch.full((m, k), xv, dtype=torch.int8, device=dev)
            w = torch.full((k // 2, n), wv, dtype=torch.int8, device=dev)
            raw = RequantSpec.raw()
            assert torch.equal(int8_matmul_nibbles(x, w, raw),
                               int8_matmul_nibbles_plain(x, w, raw))


@pytest.mark.parametrize("m", [1, 4, 5, 16, 17, 33, 128])
@pytest.mark.parametrize("group,kind,k,route", [
    (4, "msr4", 512, "mma"), (16, "msr4-g", 512, "mma"),
    (64, "msr4-1", 512, "mma"), (64, "msr4-0", 512, "mma"),
    (256, "msr4", 512, "mma"), (100, "msr4-1", 512, "mma"),
    (100, "msr4-g", 512, "mma"), (100, "msr4-1", 2048, "gather"),
    (100, "msr4-g", 2048, "gather"), (100, "msr4", 2048, "gather")])
def test_msr4_correction_kernel(dev, m, group, kind, k, route):
    """The correction kernel alone, on a raw nibble accumulator, against
    its plain version: groups 4 / 16 / 64 / 256 and g = K (100 does not
    divide K) on the tensor cores at K = 512, g = K on the gather route at
    K = 2048, n_out 0, 1, g and random, -128 weights, every epilogue; the
    two-launch product against the dense one."""
    from repro_torch.kernels.int8_matmul import (
        int8_matmul_nibbles, int8_matmul_packed, msr4_correct,
        msr4_correct_plain, msr4_plan)
    rng = np.random.default_rng(m + group + len(kind) + k)
    n = 300
    x8 = _i8(rng, (m, k), dev)
    x8[0, :3] = -128
    dense, qw = _packed_weights(rng, k, n, kind, dev, group)
    meta = qw.pack_meta
    assert meta.group == (group if k % group == 0 else k)
    want_out = {"msr4-0": 0, "msr4-1": 1, "msr4-g": meta.group}.get(kind)
    assert want_out is None or meta.n_outliers == want_out
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert msr4_plan(m, n, k, meta.group, meta.n_outliers,
                     sms).route == route
    acc = int8_matmul_nibbles(x8, qw.w_packed, RequantSpec.raw())
    keep = acc.clone()
    for spec in _specs():
        before = kernels.LAUNCHES["int8_matmul_msr4"]
        got = msr4_correct(acc, x8, qw, spec)
        assert kernels.LAUNCHES["int8_matmul_msr4"] == before + 1
        assert torch.equal(acc, keep)                 # acc is only read
        assert torch.equal(got, msr4_correct_plain(acc, x8, qw, spec))
        assert torch.equal(int8_matmul_packed(x8, qw, spec),
                           int8_matmul_plain(x8, dense.w8, spec,
                                             dense.bias32, dense.b_mult))


def _offset_bytes(x, nbytes):
    """A contiguous copy of ``x`` whose data starts ``nbytes`` bytes past
    a 16-byte boundary (a multiple of its element size)."""
    off = nbytes // x.element_size()
    flat = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
    y = flat[off:off + x.numel()].view(x.shape)
    y.copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16 == nbytes
    return y


@pytest.mark.parametrize("m", [1, 4, 5, 16, 17, 33, 128])
@pytest.mark.parametrize("k,group,route", [(512, 64, "mma"),
                                           (2048, 100, "gather")])
@pytest.mark.parametrize("operands", ["aligned", "1 byte off"])
def test_msr4_correction_kernel_filler_lanes(dev, m, k, group, route,
                                             operands):
    """Both routes with filler lanes outside [0, g) (index g, -1 and
    32767: they add nothing), N = 320 (16-byte lane copies where
    aligned); ``1 byte off``: x and the deltas 1 byte past a 16-byte
    boundary, the indices 2 bytes and acc 4 (scalar copies)."""
    from repro_torch.kernels.int8_matmul import (
        int8_matmul_nibbles, int8_matmul_packed, int8_matmul_packed_plain,
        msr4_correct, msr4_correct_plain, msr4_plan)
    rng = np.random.default_rng(m + k + len(operands))
    n = 320
    _, qw = _packed_weights(rng, k, n, "msr4", dev, group)
    meta = qw.pack_meta
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert msr4_plan(m, n, k, meta.group, meta.n_outliers,
                     sms).route == route
    idx = qw.out_idx.clone()
    idx[0, 0, 3], idx[-1, -1, 5], idx[0, 1, 200] = meta.group, -1, 32767
    qw = qw._replace(out_idx=idx)
    x8 = _i8(rng, (m, k), dev)
    acc = int8_matmul_nibbles(x8, qw.w_packed, RequantSpec.raw())
    if operands == "1 byte off":
        x8, acc = _offset_bytes(x8, 1), _offset_bytes(acc, 4)
        qw = qw._replace(out_idx=_offset_bytes(qw.out_idx, 2),
                         out_val=_offset_bytes(qw.out_val, 1))
    for spec in _specs():
        got = msr4_correct(acc, x8, qw, spec)
        assert torch.equal(got, msr4_correct_plain(acc, x8, qw, spec))
        assert torch.equal(int8_matmul_packed(x8, qw, spec),
                           int8_matmul_packed_plain(x8, qw, spec))


def test_packed_matmul_refuses_what_it_cannot_take(dev):
    from repro_torch.kernels.int_attention_fused import apply_wo_cuda
    from repro_torch.kernels.int8_matmul import (int8_matmul_nibbles,
                                                 msr4_correct)
    rng = np.random.default_rng(5)
    _, qw = _packed_weights(rng, 64, 32, "msr4", dev, 16)
    _, q4 = _packed_weights(rng, 64, 32, "int4", dev)
    x8 = _i8(rng, (4, 64), dev)
    raw = RequantSpec.raw()
    with pytest.raises(ValueError):
        int8_matmul_nibbles(_i8(rng, (4, 66), dev), qw.w_packed, raw)
    with pytest.raises(ValueError):
        int8_matmul_nibbles(x8, qw.w_packed.t(), raw)
    with pytest.raises(ValueError):
        int8_matmul_nibbles(x8, qw.w_packed.to(torch.int32), raw)
    acc = int8_matmul_nibbles(x8, qw.w_packed, raw)
    with pytest.raises(ValueError):
        msr4_correct(acc, x8, q4, raw)                # not msr4
    with pytest.raises(ValueError):
        msr4_correct(acc[:2], x8, qw, raw)
    with pytest.raises(ValueError):
        msr4_correct(acc, x8, qw._replace(out_idx=qw.out_idx.to(
            torch.int32)), raw)
    with pytest.raises(ValueError, match="b_vec"):
        msr4_correct(acc, x8, qw._replace(b_mult=None),
                     RequantSpec.per_channel(24, 10, 11))
    with pytest.raises(ValueError, match="never folds"):
        apply_wo_cuda(torch.zeros((1, 1, 2, 32), dtype=torch.int8,
                                  device=dev), q4, raw)


def test_engine_msr4_cuda_matches_torch_ref(dev):
    """A reduced engine on msr4 weights (group 64) packed on the card:
    ``cuda`` and ``cuda_online`` streams equal ``torch_ref``'s and the
    dense model's; every matmul took the packed K1 and the correction,
    the dense K1 never (a packed wo never folds)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.quant import convert
    from repro_torch.quant.pack import pack_tree
    from repro_torch.serving import Request, ServingEngine
    cfg = M.reduce_config(get_config("llama3-8b"), dtype="float32")
    qp, plans = convert.init_quantized(cfg, seed=0, device=dev)
    packed = pack_tree(qp, "msr4", 64)
    streams = {}
    for name, tree, backend in (("cuda", packed, "cuda"),
                                ("cuda_online", packed, "cuda_online"),
                                ("torch_ref", packed, "torch_ref"),
                                ("dense", qp, "cuda")):
        eng = ServingEngine(tree, plans, cfg, batch_size=2, cache_len=64,
                            ops=backend, device=dev, page_size=8,
                            prefill_chunk=8, fold_wo=True)
        reqs = [Request(uid=i, prompt=[1 + i] * (5 + 9 * i),
                        max_new_tokens=4) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        kernels.reset_launches()
        eng.run_until_done()
        if name == "cuda":
            assert kernels.LAUNCHES["int8_matmul_packed"] > 0
            assert kernels.LAUNCHES["int8_matmul_msr4"] > 0
            assert kernels.LAUNCHES["int8_matmul"] == 0
        streams[name] = [r.out_tokens for r in reqs]
    assert streams["cuda"] == streams["cuda_online"] == \
        streams["torch_ref"] == streams["dense"]


# ------------------------------------ front end, dispatch / commit, spec --

def _reduced_llama(dev):
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.quant import convert
    cfg = M.reduce_config(get_config("llama3-8b"), dtype="float32")
    qp, plans = convert.init_quantized(
        cfg, seed=0, device=dev, embed_scale=convert.unit_embed_scale(cfg))
    return cfg, qp, plans


_SERVE_PROMPTS = [[1 + i] * (5 + 9 * i) for i in range(3)] \
    + [[3, 5, 7, 9, 11, 13] * 4]


@pytest.mark.parametrize("mode", ["paged", "contiguous"])
def test_frontend_and_spec_serve_cuda_match_torch_ref(dev, mode):
    """A 2-layer engine on the card: streams through ``ServingFrontend``
    on ``cuda``, and of a ``spec_k = 3`` engine on ``cuda`` (K3 at Sq = 4)
    and on ``torch_ref``, equal the ``torch_ref`` drain's."""
    import asyncio
    from repro_torch.serving import Request, ServingEngine, ServingFrontend
    cfg, qp, plans = _reduced_llama(dev)

    def engine(backend, **kw):
        return ServingEngine(qp, plans, cfg, batch_size=2, cache_len=64,
                             ops=backend, device=dev, cache_mode=mode, **kw)

    def drain(eng):
        reqs = [Request(uid=i, prompt=list(p), max_new_tokens=8)
                for i, p in enumerate(_SERVE_PROMPTS)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        return [r.out_tokens for r in reqs]

    async def serve(fe):
        runner = asyncio.create_task(fe.run())
        handles = [fe.submit(list(p), 8) for p in _SERVE_PROMPTS]
        streams = await asyncio.gather(*[h.result() for h in handles])
        fe.close()
        await runner
        return streams

    want = drain(engine("torch_ref"))
    kernels.reset_launches()
    assert asyncio.run(serve(ServingFrontend(engine("cuda")))) == want
    assert kernels.LAUNCHES["int_decode_attention"] > 0
    for backend in ("cuda", "torch_ref"):
        kernels.reset_launches()
        eng = engine(backend, spec_k=3)
        assert drain(eng) == want, backend
        assert eng.describe()["spec"]["drafted"] > 0
        assert (kernels.LAUNCHES["int_decode_attention"] > 0) \
            == (backend == "cuda")


@pytest.mark.parametrize("kw", [dict(), dict(spec_k=3),
                                dict(kv_dtype="int4", spec_k=3),
                                dict(cache_mode="contiguous"),
                                dict(cache_mode="contiguous", spec_k=3)],
                         ids=lambda kw: ",".join(f"{k}={v}"
                                                 for k, v in kw.items())
                         or "default")
def test_dispatch_step_makes_no_synchronizing_copy(dev, kw):
    """``dispatch_step`` (admission, a prompt's prefill, the decode or
    verify step) queues its work without waiting on the card: under
    ``torch.cuda.set_sync_debug_mode("error")`` any synchronizing copy or
    read of the device raises.  The first step warms the kernels up."""
    from repro_torch.serving import Request, ServingEngine
    cfg, qp, plans = _reduced_llama(dev)
    eng = ServingEngine(qp, plans, cfg, batch_size=4, cache_len=64,
                        ops="cuda", device=dev, **kw)
    for i, p in enumerate(_SERVE_PROMPTS[:2]):
        eng.submit(Request(uid=i, prompt=list(p), max_new_tokens=6))
    eng.step()
    for i, p in enumerate(_SERVE_PROMPTS[2:]):     # prefilled in dispatch
        eng.submit(Request(uid=2 + i, prompt=list(p), max_new_tokens=6))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = eng.dispatch_step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert pending.kind == ("verify" if kw.get("spec_k") else "decode")
    assert len(pending.live) == 4
    eng.commit_step(pending)
    eng.run_until_done()


# ------------------------------------------------ the new configs' shapes --

@pytest.mark.parametrize("case,m,k,n", [
    ("codeqwen wq+bias", 4, 4096, 4096), ("codeqwen wq+bias", 16, 4096, 4096),
    ("codeqwen wq+bias", 128, 4096, 4096), ("codeqwen w2", 4, 13440, 4096),
    ("codeqwen w2", 16, 13440, 4096), ("granite head", 4, 2048, 49155),
    ("granite head", 128, 2048, 49155), ("granite head", 4, 2048, 49168)])
def test_zoo_matmul_shapes(dev, case, m, k, n):
    """K1 at codeqwen1.5-7b's QKV (per-channel + bias) and w2 (K = 13440)
    and granite-3-2b's raw tied head (odd N = 49155, and its padded
    49168), decode tile and tensor-core tiles."""
    rng = np.random.default_rng(m + k + n)
    x8, w8 = _i8(rng, (m, k), dev), _i8(rng, (k, n), dev)
    if case == "granite head":
        spec, bias, bvec = RequantSpec.raw(), None, None
    else:
        spec = RequantSpec.per_channel(24, 10, 8)
        bvec = _i32(rng, 256, 4096, (n,), dev)
        bias = _i32(rng, -5000, 5000, (n,), dev) if "bias" in case else None
    before = kernels.LAUNCHES["int8_matmul"]
    got = int8_matmul(x8, w8, spec, bias32=bias, b_vec=bvec)
    assert kernels.LAUNCHES["int8_matmul"] == before + 1
    assert torch.equal(got, int8_matmul_plain(x8, w8, spec, bias, bvec))


@pytest.mark.parametrize("rows,d", [(16384, 1024), (32 * 197, 384)])
def test_zoo_layernorm_shapes(dev, rows, d):
    """K2 (LayerNorm + beta) at roberta-large's and deit-s's passes."""
    rng = np.random.default_rng(rows + d)
    plan, q, g, b = _k2_operands(rng, rows, d, True, True, dev)
    before = kernels.LAUNCHES["int_layernorm"]
    got = int_layernorm(q, g, b, plan)
    assert kernels.LAUNCHES["int_layernorm"] == before + 1
    assert torch.equal(got, int_layernorm_plain(q, g, b, plan))


@pytest.mark.parametrize("h,hkv,hd", [(32, 32, 128), (32, 8, 64)])
@pytest.mark.parametrize("fold", [False, True])
def test_zoo_serve_attention_rows(dev, h, hkv, hd, fold):
    """K3 and K4 at the serve row of codeqwen1.5-7b (MHA, one query head a
    KV head) and granite-3-2b (D = 64): B 4, pages of 16, valid 1 / 137 /
    300 / 512 (K3) and chunks of 32 ending at 32 / 132 / 282 / 512
    (K4), wo folded and not."""
    rng = np.random.default_rng(h + hkv + hd + fold)
    b, ps, maxp, d = 4, 16, 32, 4096
    plan = iattn.make_iattention(hd, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    kp = _i8(rng, (b * maxp + 1, ps, hkv, hd), dev)
    vp = _i8(rng, (b * maxp + 1, ps, hkv, hd), dev)
    pages = torch.as_tensor(rng.permutation(np.arange(1, b * maxp + 1))
                            .reshape(b, maxp).astype(np.int32), device=dev)
    kw = {}
    if fold:
        kw = dict(wo=QuantLinearParams(_i8(rng, (h * hd, d), dev),
                                       _i32(rng, 256, 4096, (d,), dev)),
                  wo_spec=RequantSpec.per_channel(24, 10, 14))
    rq = RequantSpec.per_tensor(plan.dn_out)
    for sq, fused, plain, name, lens in (
            (1, int_decode_attention_fused, int_decode_attention_plain,
             "int_decode_attention", [1, 137, 300, 512]),
            (32, int_paged_prefill_fused, int_paged_prefill_plain,
             "int_paged_prefill", [32, 132, 282, 512])):
        q8 = _i8(rng, (b, sq, h, hd), dev)
        vl = torch.tensor(lens, dtype=torch.int32, device=dev)
        before = kernels.LAUNCHES[name]
        got = fused(q8, kp, vp, plan, vl, pages, ps, requant=rq, **kw)
        assert kernels.LAUNCHES[name] == before + 1
        assert torch.equal(got, plain(q8, kp, vp, plan, vl, pages, ps,
                                      requant=rq, **kw)), name


@pytest.mark.parametrize("b,s,h", [(32, 512, 16), (32, 197, 6)])
def test_zoo_full_sequence_attention(dev, b, s, h):
    """K5 at roberta-large's (H 16) and deit-s's (S 197: ragged last
    tiles both ways) encoder passes, unmasked, D = 64."""
    rng = np.random.default_rng(b + s + h)
    plan = iattn.make_iattention(64, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    q8, k8, v8 = (_i8(rng, (b, s, h, 64), dev) for _ in range(3))
    before = kernels.LAUNCHES["int_attention_fused"]
    got = int_attention_fused(q8, k8, v8, plan, causal=False)
    assert kernels.LAUNCHES["int_attention_fused"] == before + 1
    assert torch.equal(got, int_attention_fused_plain(q8, k8, v8, plan,
                                                      causal=False))


def test_zoo_gelu_shape(dev):
    """K6 at roberta-large's FFN, 16 384 x 4096 11-bit inputs."""
    gp = iact.make_igelu_act(16.0 / 1024.0, 1024, 8.0 / 127.0)
    q = _i32(np.random.default_rng(8), -1024, 1024, (16384, 4096), dev)
    before = kernels.LAUNCHES["int_gelu"]
    got = int_gelu(q, gp.gelu, gp.dn_out)
    assert kernels.LAUNCHES["int_gelu"] == before + 1
    assert torch.equal(got, int_gelu_plain(q, gp.gelu, gp.dn_out))


# --------------------------------------------- the chunked two-pass path --

@pytest.mark.parametrize("causal,window", [(True, 0), (True, 700),
                                           (False, 0)])
def test_chunked_attention_on_the_card_equals_the_cpu(dev, causal, window):
    """``core.attention.i_attention_chunked`` (plain PyTorch, float64
    contractions) gives the same integers on the card as on the CPU."""
    rng = np.random.default_rng(window + causal)
    plan = iattn.make_iattention(128, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    q8 = _i8(rng, (1, 2048, 8, 128), dev)
    k8, v8 = _i8(rng, (1, 2048, 8, 128), dev), _i8(rng, (1, 2048, 8, 128),
                                                    dev)
    got = iattn.i_attention_chunked(q8, k8, v8, plan, 1024, causal, window)
    want = iattn.i_attention_chunked(q8.cpu(), k8.cpu(), v8.cpu(), plan,
                                     1024, causal, window)
    assert got.is_cuda and torch.equal(got.cpu(), want)


def test_cuda_attention_past_the_rowsum_budget_on_the_card(dev):
    """Past MAX_ROWSUM_LEN keys ``cuda``'s ``int_attention`` streams the
    chunked path on the card (K5 does not launch): the CPU's integers."""
    from repro_torch.analysis.budgets import MAX_ROWSUM_LEN
    from repro_torch.ops import get_backend
    rng = np.random.default_rng(12)
    plan = iattn.make_iattention(32, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    skv = MAX_ROWSUM_LEN + 1024
    q8 = _i8(rng, (1, 64, 2, 32), dev)
    k8, v8 = _i8(rng, (1, skv, 1, 32), dev), _i8(rng, (1, skv, 1, 32), dev)
    be = get_backend("cuda")
    kernels.reset_launches()
    got = be.int_attention(q8, k8, v8, plan, causal=False)
    assert kernels.LAUNCHES["int_attention_fused"] == 0
    want = be.int_attention(q8.cpu(), k8.cpu(), v8.cpu(), plan, causal=False)
    assert got.is_cuda and torch.equal(got.cpu(), want)


def test_long_prefill_ref_takes_the_chunked_path_on_the_card(dev):
    """Reduced llama3-8b at S = 3072 (above the full-matrix threshold)
    through make_prefill_step: ``ref`` (``cuda_ref``) launches K1 and K2
    but never K5, and equals ``torch_ref`` on the card; ``cuda``
    (``pallas_fused``'s twin) launches K5."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import intlayers as il
    cfg, qp, plans = _reduced_llama(dev)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (1, 3072))
    rope = il.build_rope_table(3073, cfg.hd, cfg.rope_theta, device=dev)
    logits = {}
    for backend in ("ref", "torch_ref", "cuda"):
        kernels.reset_launches()
        logits[backend] = make_prefill_step(cfg, plans, ops=backend,
                                            device=dev)(qp, {"tokens": toks},
                                                        rope)
        fused = kernels.LAUNCHES["int_attention_fused"]
        if backend == "ref":
            assert fused == 0 and kernels.LAUNCHES["int8_matmul"] > 0
        assert (fused == cfg.num_layers) == (backend == "cuda")
    assert torch.equal(logits["ref"], logits["torch_ref"])


# ------------------------------------------ the grouped K1 (MoE experts) --

def _grouped_rows(case, e, r):
    """Expert row counts: 'spread' one to a few rows an expert, 'empty' an
    expert with none, 'one' every row in expert 0, 'full' every expert
    full, 'zero' every expert empty, 'over' counts past R (the kernel
    clamps them to R) beside a few of at most R."""
    if case == "one":
        return [r] + [0] * (e - 1)
    if case == "full":
        return [r] * e
    if case == "zero":
        return [0] * e
    if case == "over":
        return [r + 1 + 7 * i if i % 2 == 0 else min(r, i)
                for i in range(e)]
    rows = [min(r, 1 + (3 * i) % (r + 1)) for i in range(e)]
    if case == "empty":
        rows[1] = 0
    return rows


@pytest.mark.parametrize("r", [1, 16, 17, 160, 300])
@pytest.mark.parametrize("k,n", [(2048, 1408), (512, 2048), (200, 1410),
                                 (301, 96)])
@pytest.mark.parametrize("case", ["spread", "empty", "one", "full", "zero",
                                  "over"])
def test_int8_matmul_grouped_kernel(dev, r, k, n, case):
    """K1's grouped instantiation against its plain version on every
    packed row: R 1 and 16 (the decode path in clusters of 2 at K 2048
    and 512, split where few items are live; none at K 200 / 301), 17 and
    160 (48- and
    192-row tiles) and 300 (two chunks of the largest, 192); N 1408, 2048
    and two not multiples of 16 (the copy route, 1410 with no vector
    stores), K not a multiple of 16 (200 is; 301: the copy route with
    byte loads of x); an empty expert, all rows in one expert, every
    expert empty, counts past R; raw int32, int32 at 14 bits and int8
    outputs, with a bias; one launch each, and the rows past ``rows[e]``
    stay unwritten."""
    from repro_torch.kernels.int8_matmul import (int8_matmul_grouped,
                                                 int8_matmul_grouped_plain)
    e = 6
    rng = np.random.default_rng(r + k + n)
    x8, w8 = _i8(rng, (e, r, k), dev), _i8(rng, (e, k, n), dev)
    rows = torch.tensor(_grouped_rows(case, e, r), dtype=torch.int32,
                        device=dev)
    bvec = _i32(rng, 256, 4096, (e, n), dev)
    bias = _i32(rng, -5000, 5000, (e, n), dev)
    for spec in (RequantSpec.raw(), RequantSpec.per_channel(24, 10, 14),
                 RequantSpec.per_channel(26, 10, 8)):
        before = kernels.LAUNCHES["int8_matmul_grouped"]
        got = int8_matmul_grouped(x8, w8, rows, spec, bias32=bias,
                                  b_vec=bvec)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["int8_matmul_grouped"] == before + 1
        want = int8_matmul_grouped_plain(x8, w8, rows, spec, bias, bvec)
        assert got.dtype == want.dtype
        for ex, c in enumerate(rows.tolist()):
            assert torch.equal(got[ex, :c], want[ex, :c]), (spec, ex)


@pytest.mark.parametrize("r,k,counts", [
    (160, 256, [0, 64, 65, 3]), (16, 2048, [0, 16, 5, 1]),
    (300, 256, [193, 0, 299, 2])])
def test_int8_matmul_grouped_skips_empty_tiles(dev, r, k, counts):
    """Rows past ``rows[e]`` (and every row of an empty expert) keep what
    the output buffer held, on the row tiles (one chunk and two) and on
    the decode path split across a cluster: no item of an empty expert,
    no store past its count."""
    from repro_torch.kernels.int8_matmul import int8_matmul_grouped
    rng = np.random.default_rng(11)
    e, n = 4, 300
    x8, w8 = _i8(rng, (e, r, k), dev), _i8(rng, (e, k, n), dev)
    rows = torch.tensor(counts, dtype=torch.int32, device=dev)
    spec = RequantSpec.raw()
    orig = torch.empty
    sentinel = []

    def filled(*a, **kw):
        t = orig(*a, **kw)
        t.fill_(-7)
        sentinel.append(t)
        return t

    torch.empty = filled
    try:
        got = int8_matmul_grouped(x8, w8, rows, spec)
    finally:
        torch.empty = orig
    assert got is sentinel[-1]
    for ex, c in enumerate(rows.tolist()):
        assert bool((got[ex, c:] == -7).all())
        if c:
            assert not bool((got[ex, :c] == -7).all())


@pytest.mark.parametrize("e,r,k,n", [(64, 16, 2048, 1408),
                                     (16, 160, 1408, 4096)])
def test_int8_matmul_grouped_more_items_than_clusters(dev, e, r, k, n):
    """Every expert full, so the live items (704 decode items over 132
    blocks; 512 row-tile items over 132 blocks) outnumber the
    grid's clusters and each cluster strides over several, its ring
    streaming from one item into the next: equal to the plain version."""
    from repro_torch.kernels.int8_matmul import (grouped_items,
                                                 grouped_plan,
                                                 int8_matmul_grouped,
                                                 int8_matmul_grouped_plain)
    rng = np.random.default_rng(e + r)
    x8, w8 = _i8(rng, (e, r, k), dev), _i8(rng, (e, k, n), dev)
    rows = torch.full((e,), r, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = grouped_plan(e, r, n, k, sms, x8.data_ptr(), w8.data_ptr())
    assert grouped_items(n, [r] * e) > plan.grid[0] // plan.cluster
    bvec = _i32(rng, 256, 4096, (e, n), dev)
    spec = RequantSpec.per_channel(24, 10, 11)
    got = int8_matmul_grouped(x8, w8, rows, spec, b_vec=bvec)
    assert torch.equal(got, int8_matmul_grouped_plain(x8, w8, rows, spec,
                                                      None, bvec))


@pytest.mark.parametrize("r", [4, 160])
@pytest.mark.parametrize("x_off,w_off", [(1, 0), (0, 8), (4, 4)])
def test_int8_matmul_grouped_misaligned(dev, r, x_off, w_off):
    """x or w a few bytes off 16-byte alignment (views into a larger
    buffer): no tensor map, the copy route (word loads where 4-byte
    aligned, byte loads where not), equal to the plain version."""
    from repro_torch.kernels.int8_matmul import (grouped_plan,
                                                 int8_matmul_grouped,
                                                 int8_matmul_grouped_plain)
    rng = np.random.default_rng(r + x_off + w_off)
    e, k, n = 5, 1024, 512
    xb = _i8(rng, (e * r * k + 16,), dev)
    wb = _i8(rng, (e * k * n + 16,), dev)
    x8 = xb[x_off:x_off + e * r * k].view(e, r, k)
    w8 = wb[w_off:w_off + e * k * n].view(e, k, n)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert grouped_plan(e, r, n, k, sms, x8.data_ptr(),
                        w8.data_ptr()).route == "copy"
    rows = torch.tensor(_grouped_rows("spread", e, r), dtype=torch.int32,
                        device=dev)
    bias = _i32(rng, -5000, 5000, (e, n), dev)
    bvec = _i32(rng, 256, 4096, (e, n), dev)
    spec = RequantSpec.per_channel(26, 10, 8)
    got = int8_matmul_grouped(x8, w8, rows, spec, bias32=bias, b_vec=bvec)
    want = int8_matmul_grouped_plain(x8, w8, rows, spec, bias, bvec)
    for ex, c in enumerate(rows.tolist()):
        assert torch.equal(got[ex, :c], want[ex, :c]), ex


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("s,group_size", [(1, 1), (4, 1), (64, 512),
                                          (600, 512)])
def test_int_moe_fwd_card_equals_cpu(dev, arch, s, group_size):
    """``int_moe_fwd`` of reduced qwen2-moe / qwen3-moe on the card
    (``cuda``: K1 for the router and the shared experts, the grouped K1
    for the experts) equals the same call on the CPU, and
    reads nothing back to the host (``set_sync_debug_mode("error")``);
    the routing keeps the same (token, slot) pairs on both."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import intlayers as il
    from repro_torch.models import inttransformer as it
    from repro_torch.models import model as M
    from repro_torch.quant import convert
    cfg = M.reduce_config(get_config(arch), dtype="float32")
    qp, plans = convert.init_quantized(cfg, seed=1, device="cpu")
    moe_cpu = it._layer(qp["layers"][0]["moe"], 0)
    moe_dev = it._layer(_to(qp["layers"][0]["moe"], dev), 0)
    x = np.random.default_rng(s).integers(-127, 128, (2, s, cfg.d_model))
    x8 = torch.as_tensor(x.astype(np.int8))
    x8_dev = x8.to(dev)
    routes, route = [], il.moe_route

    def spy(*a, **k):
        routes.append(route(*a, **k))
        return routes[-1]

    il.moe_route = spy
    try:
        want = il.int_moe_fwd(moe_cpu, x8, plans.moe, cfg, ops="cuda",
                              group_size=group_size)
        il.int_moe_fwd(moe_dev, x8_dev, plans.moe, cfg, ops="cuda",
                       group_size=group_size)           # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = il.int_moe_fwd(moe_dev, x8_dev, plans.moe, cfg,
                                 ops="cuda", group_size=group_size)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    finally:
        il.moe_route = route
    assert kernels.LAUNCHES["int8_matmul_grouped"] == 3
    assert kernels.LAUNCHES["int8_matmul"] >= 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(routes[2].keep.cpu(), routes[0].keep)


def _to(tree, dev):
    if isinstance(tree, QuantLinearParams):
        return tree.map(lambda t: t.to(dev))
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def test_moe_engine_cuda_matches_torch_ref(dev):
    """Reduced qwen2-moe-a2.7b served on the card: ``cuda`` streams (paged
    and with ``spec_k = 3``) equal ``torch_ref``'s, and every step
    launched the grouped K1."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.quant import convert
    from repro_torch.serving import Request, ServingEngine
    cfg = M.reduce_config(get_config("qwen2-moe-a2.7b"), dtype="float32")
    qp, plans = convert.init_quantized(
        cfg, seed=0, device=dev, embed_scale=convert.unit_embed_scale(cfg))
    streams = {}
    for backend, kw in (("torch_ref", {}), ("cuda", {}),
                        ("cuda", dict(spec_k=3))):
        eng = ServingEngine(qp, plans, cfg, batch_size=4, cache_len=64,
                            ops=backend, device=dev, **kw)
        reqs = [Request(uid=i, prompt=list(p), max_new_tokens=6)
                for i, p in enumerate(_SERVE_PROMPTS)]
        for q in reqs:
            eng.submit(q)
        kernels.reset_launches()
        eng.run_until_done()
        streams[backend, bool(kw)] = [q.out_tokens for q in reqs]
        if backend == "cuda":
            assert kernels.LAUNCHES["int8_matmul_grouped"] > 0
    assert streams["cuda", False] == streams["torch_ref", False]
    assert streams["cuda", True] == streams["torch_ref", False]


# --------------------------------------- the state-space models' shapes --

def _i8_on(seed, shape, dev):
    """int8 in [-127, 127] drawn on the card (the experts' 940 MB would
    take seconds on the host)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=gen, device=dev,
                         dtype=torch.int8)


@pytest.mark.parametrize("m", [4, 2048])
@pytest.mark.parametrize("case,k,n", [
    ("mamba2 in_proj", 768, 3328), ("mamba2 dt_proj", 768, 24),
    ("mamba2 out_proj", 1536, 768), ("jamba in_proj", 4096, 16416),
    ("jamba dt_proj", 4096, 128), ("jamba out_proj", 8192, 4096)])
def test_ssm_matmul_shapes(dev, case, m, k, n):
    """K1 at the Mamba blocks' linears of mamba2-130m and jamba-v0.1-52b,
    a decode step (M 4) and a 4 x 512 prefill (M 2048): in_proj to int8,
    out_proj to 14 bits (per channel), and the Δt projection's raw int32
    (N 24: the decode tile's copy route)."""
    rng = np.random.default_rng(m + k + n)
    x8, w8 = _i8_on(m + k, (m, k), dev), _i8_on(k + n, (k, n), dev)
    bvec = None
    if "dt_proj" in case:
        spec = RequantSpec.raw()
    else:
        spec = RequantSpec.per_channel(
            24, 10, 8 if "in_proj" in case else 14)
        bvec = _i32(rng, 256, 4096, (n,), dev)
    before = kernels.LAUNCHES["int8_matmul"]
    got = int8_matmul(x8, w8, spec, b_vec=bvec)
    assert kernels.LAUNCHES["int8_matmul"] == before + 1
    assert torch.equal(got, int8_matmul_plain(x8, w8, spec, None, bvec))


@pytest.mark.parametrize("d", [1536, 8192])
@pytest.mark.parametrize("rows", [4, 2048])
def test_ssm_gated_norm_shapes(dev, d, rows):
    """K2 at the Mamba blocks' RMSNorm over d_inner (1536; 8192, the
    kernel's longest row) with its plan: s_in 1.0, qmax_in 2^11 (the
    block-floating-point input), no mean; rows at the edges of the
    12-bit input range included."""
    plan = inorms.make_inorm(d, 1.0, 1 << 11, 2 / 127, 8 / 127, False)
    rng = np.random.default_rng(d + rows)
    q = _i32(rng, -2048, 2049, (rows, d), dev)
    q[0] = 2048
    q[1] = torch.where(torch.arange(d, device=dev) % 3 == 0, -2048,
                       2047).to(torch.int32)
    q[2] = 0
    g = _i32(rng, -127, 128, (d,), dev)
    before = kernels.LAUNCHES["int_layernorm"]
    got = int_layernorm(q, g, None, plan)
    assert kernels.LAUNCHES["int_layernorm"] == before + 1
    assert torch.equal(got, int_layernorm_plain(q, g, None, plan))


@pytest.mark.parametrize("lin,k,n", [("w1", 4096, 14336),
                                     ("w2", 14336, 4096)])
@pytest.mark.parametrize("counts", [[1, 0, 1, 0, 1, 1, 0, 0, 1, 0, 0, 1,
                                     0, 1, 0, 1], [4] * 2 + [0] * 14])
def test_jamba_expert_shapes(dev, lin, k, n, counts):
    """K1's grouped instantiation at jamba-v0.1-52b's experts (16 of 4096
    x 14336 and 14336 x 4096) for a decode step of 4 tokens, top-2: eight
    (token, expert) pairs in eight experts, then all four tokens in the
    same two."""
    from repro_torch.kernels.int8_matmul import (int8_matmul_grouped,
                                                 int8_matmul_grouped_plain)
    rng = np.random.default_rng(k + sum(counts))
    e, r = len(counts), 16
    x8, w8 = _i8_on(k, (e, r, k), dev), _i8_on(n, (e, k, n), dev)
    rows = torch.tensor(counts, dtype=torch.int32, device=dev)
    bvec = _i32(rng, 256, 4096, (e, n), dev)
    spec = RequantSpec.per_channel(24, 10, 11 if lin == "w1" else 14)
    before = kernels.LAUNCHES["int8_matmul_grouped"]
    got = int8_matmul_grouped(x8, w8, rows, spec, b_vec=bvec)
    assert kernels.LAUNCHES["int8_matmul_grouped"] == before + 1
    want = int8_matmul_grouped_plain(x8, w8, rows, spec, None, bvec)
    for ex, c in enumerate(counts):
        assert torch.equal(got[ex, :c], want[ex, :c]), ex


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-v0.1-52b"])
def test_int_mamba_card_equals_cpu(dev, arch):
    """Reduced configs' Mamba block on the card (``cuda``: K1 for the
    projections, K2 for the gated norm) equals the same calls on the CPU,
    a step from a carried-in state and a 9-token prefill, and the step
    reads nothing back to the host (``set_sync_debug_mode("error")``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import intlayers as il
    from repro_torch.models import inttransformer as it
    from repro_torch.models import model as M
    from repro_torch.quant import convert
    cfg = M.reduce_config(get_config(arch), dtype="float32")
    qp, plans = convert.init_quantized(cfg, seed=1, device="cpu")
    mp = plans.mamba
    ssm_cpu = it._layer(qp["layers"][0]["ssm"], 1)
    ssm_dev = it._layer(_to(qp["layers"][0]["ssm"], dev), 1)
    rng = np.random.default_rng(3)
    st = il.init_int_mamba_state(cfg, 3, "cpu")
    h = torch.as_tensor(rng.integers(-(1 << 22), 1 << 22, st.h.shape
                                     ).astype(np.int32))
    conv = torch.as_tensor(rng.integers(-127, 128, st.conv.shape
                                        ).astype(np.int8))
    u = torch.as_tensor(rng.integers(-127, 128, (3, 9, cfg.d_model)
                                     ).astype(np.int8))
    want, wst = il.int_mamba_step(ssm_cpu, u[:, 0], il.IntMambaState(
        h, conv), mp, cfg, ops="cuda")
    args = (u[:, 0].to(dev), il.IntMambaState(h.to(dev), conv.to(dev)))
    il.int_mamba_step(ssm_dev, *args, mp, cfg, ops="cuda")   # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, gst = il.int_mamba_step(ssm_dev, *args, mp, cfg, ops="cuda")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kernels.LAUNCHES["int8_matmul"] == 3
    assert kernels.LAUNCHES["int_layernorm"] == 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(gst.h.cpu(), wst.h)
    assert torch.equal(gst.conv.cpu(), wst.conv)
    want, wst = il.int_mamba_prefill(ssm_cpu, u, mp, cfg, il.IntMambaState(
        h, conv), ops="cuda")
    got, gst = il.int_mamba_prefill(ssm_dev, u.to(dev), mp, cfg,
                                    il.IntMambaState(h.to(dev),
                                                     conv.to(dev)),
                                    ops="cuda")
    assert torch.equal(got.cpu(), want) and torch.equal(gst.h.cpu(), wst.h)


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-v0.1-52b"])
@pytest.mark.parametrize("mode", ["paged", "contiguous"])
def test_ssm_engine_cuda_matches_torch_ref(dev, arch, mode):
    """Reduced mamba2-130m and jamba-v0.1-52b served on the card, six
    requests on four lanes (recycled lanes start from a zeroed state):
    ``cuda`` streams equal ``torch_ref``'s, and the path launched K1 and
    K2 (jamba also K3 and the grouped K1)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.quant import convert
    from repro_torch.serving import Request, ServingEngine
    cfg = M.reduce_config(get_config(arch), dtype="float32")
    qp, plans = convert.init_quantized(
        cfg, seed=0, device=dev, embed_scale=convert.unit_embed_scale(cfg))
    prompts = _SERVE_PROMPTS + [[7, 1, 7, 2], [9] * 11]
    streams = {}
    for backend in ("torch_ref", "cuda"):
        eng = ServingEngine(qp, plans, cfg, batch_size=4, cache_len=48,
                            ops=backend, cache_mode=mode, device=dev)
        reqs = [Request(uid=i, prompt=list(p), max_new_tokens=5)
                for i, p in enumerate(prompts)]
        for q in reqs:
            eng.submit(q)
        kernels.reset_launches()
        eng.run_until_done()
        streams[backend] = [q.out_tokens for q in reqs]
    launched = {n for n, c in kernels.LAUNCHES.items() if c}
    want = {"int8_matmul", "int_layernorm"}
    if arch.startswith("jamba"):
        want |= {"int_decode_attention", "int8_matmul_grouped"}
    assert want <= launched
    assert streams["cuda"] == streams["torch_ref"]


# ------------------------------------------ cross attention over a memory --

@pytest.mark.parametrize("b,sq,skv,h,hkv,d", [
    (4, 64, 512, 16, 16, 64),          # seamless's decoder over its frames
    (4, 64, 1600, 64, 8, 128),         # the VLM over 1600 image tokens
    (2, 37, 1600, 8, 1, 128),          # ragged queries, one KV head
    (4, 512, 512, 16, 16, 64)])        # seamless's encoder (no mask)
def test_cross_attention_kernel(dev, b, sq, skv, h, hkv, d):
    """K5 at the cross attention paths' shapes, unmasked: Skv 1600 is no
    multiple of the key tile (its last tile is partial), GQA 64 / 8."""
    rng = np.random.default_rng(sq + skv + h)
    plan = iattn.make_iattention(d, 8 / 127, 8 / 127, 8 / 127, 8 / 127)
    q8 = _i8(rng, (b, sq, h, d), dev)
    k8 = _i8(rng, (b, skv, hkv, d), dev)
    v8 = _i8(rng, (b, skv, hkv, d), dev)
    rq = RequantSpec.per_tensor(plan.dn_out)
    before = kernels.LAUNCHES["int_attention_fused"]
    got = int_attention_fused(q8, k8, v8, plan, rq, None, False, 0)
    assert kernels.LAUNCHES["int_attention_fused"] == before + 1
    assert torch.equal(got, int_attention_fused_plain(q8, k8, v8, plan, rq,
                                                      None, False, 0))


@pytest.mark.parametrize("b,skv,h,hkv,d", [(4, 512, 16, 16, 64),
                                           (4, 1600, 64, 8, 128),
                                           (3, 1601, 64, 8, 128)])
def test_cross_decode_attention_kernel(dev, b, skv, h, hkv, d):
    """K3 as ``_cross_decode`` runs it: one query over a contiguous (B,
    Skv, Hkv, D) memory with every position valid (``valid = Skv``),
    across the cluster ``k3_launch_plan`` picks (a tail rank holds fewer
    keys at 1600 and 1601)."""
    from repro_torch.kernels.int_decode_attention import k3_launch_plan
    rng = np.random.default_rng(skv + h)
    plan = iattn.make_iattention(d, 8 / 127, 8 / 127, 8 / 127, 8 / 127)
    q8 = _i8(rng, (b, 1, h, d), dev)
    k8 = _i8(rng, (b, skv, hkv, d), dev)
    v8 = _i8(rng, (b, skv, hkv, d), dev)
    vl = torch.full((b,), skv, dtype=torch.int32, device=dev)
    k3_launch_plan(b, 1, h, hkv, d, skv, False, False, k8.data_ptr(),
                   v8.data_ptr(),
                   torch.cuda.get_device_properties(0).multi_processor_count)
    rq = RequantSpec.per_tensor(plan.dn_out)
    before = kernels.LAUNCHES["int_decode_attention"]
    got = int_decode_attention_fused(q8, k8, v8, plan, vl, requant=rq)
    assert kernels.LAUNCHES["int_decode_attention"] == before + 1
    assert torch.equal(got, int_decode_attention_plain(q8, k8, v8, plan, vl,
                                                       requant=rq))


@pytest.mark.parametrize("d,rows,mean,beta", [(1024, 4, True, True),
                                              (1024, 2048, True, True),
                                              (8192, 4, False, False),
                                              (8192, 2048, False, False)])
def test_residual_norm_at_the_cross_configs(dev, d, rows, mean, beta):
    """K2 with the residual ``norm`` plan (s_gamma 2/127, input up to
    qmax_res): seamless's LayerNorm with beta at d 1024, the VLM's
    RMSNorm at d 8192 (``MAX_D``)."""
    rng = np.random.default_rng(d + rows)
    plan, q, g, b = _k2_operands(rng, rows, d, mean, beta, dev)
    before = kernels.LAUNCHES["int_layernorm"]
    got = int_layernorm(q, g, b, plan)
    assert kernels.LAUNCHES["int_layernorm"] == before + 1
    assert torch.equal(got, int_layernorm_plain(q, g, b, plan))


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2",
                                  "llama-3.2-vision-90b"])
def test_cross_model_cuda_matches_torch_ref(dev, arch):
    """Reduced seamless-m4t-large-v2 (2 + 2 layers) and
    llama-3.2-vision-90b (one group of five, 16 image tokens) on the card:
    ``int_prefill`` logits, the caches of ``return_cache`` (``ck8`` /
    ``cv8`` included) and four greedy decode steps on ``cuda`` equal
    ``torch_ref``'s; the path launched K1, K2, K3 and K5 (and K6 for the
    GELU FFN)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import intlayers as il
    from repro_torch.models import inttransformer as it
    from repro_torch.models import model as M
    from repro_torch.quant import convert
    cfg = M.reduce_config(get_config(arch), dtype="float32", num_layers=5)
    qp, plans = convert.init_quantized(
        cfg, seed=0, device=dev, embed_scale=convert.unit_embed_scale(cfg))
    rng = np.random.default_rng(12)
    key = "src_embeds" if cfg.family == "encdec" else "img_embeds"
    sm = 40 if cfg.family == "encdec" else cfg.n_img_tokens
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (3, 11)),
                                       device=dev),
             key: torch.as_tensor(rng.standard_normal(
                 (3, sm, cfg.d_model)).astype(np.float32), device=dev)}
    out = {}
    for backend in ("torch_ref", "cuda"):
        kernels.reset_launches()
        logits, caches = it.int_prefill(qp, batch, plans, cfg, ops=backend,
                                        return_cache=True, cache_len=16)
        rope = il.build_rope_table(17, cfg.hd, cfg.rope_theta, device=dev) \
            if cfg.pos == "rope" else None
        toks, steps = logits.argmax(-1), [logits]
        for t in range(4):
            pos = torch.full((3,), 11 + t, dtype=torch.int32, device=dev)
            lg, caches = it.int_decode_step(qp, caches, toks, pos, plans,
                                            cfg, rope, ops=backend)
            steps.append(lg)
            toks = lg.argmax(-1)
        out[backend] = (steps, caches)
    want = {"int8_matmul", "int_layernorm", "int_decode_attention",
            "int_attention_fused"} | (
        {"int_gelu"} if cfg.activation == "gelu" else set())
    assert want <= {n for n, c in kernels.LAUNCHES.items() if c}
    for a, b in zip(out["cuda"][0], out["torch_ref"][0]):
        assert torch.equal(a, b)
    for ca, cb in zip(out["cuda"][1], out["torch_ref"][1]):
        assert set(ca) == set(cb)
        for k in ca:
            assert torch.equal(ca[k], cb[k]), k


# ------------------------------------------- tensor-parallel shards -----

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("pool", ["int8", "int4", "contiguous"])
def test_tp_shard_attention_rows(dev, tp, pool):
    """K3 (Sq 1, and the verify step's 4) and K4 (chunks of 32) at the
    heads one tensor-parallel rank of llama3-8b holds (H 32 / Hkv 8 over
    tp: 16 / 4, 8 / 2), D 128, B 4, over int8 pages, int4 pages (shifts
    0..7) or a contiguous cache (K3 only), unfolded as a sharded engine
    runs them: each launches once and equals its plain version."""
    rng = np.random.default_rng(tp * 10 + len(pool))
    b, ps, maxp, hd = 4, 16, 32, 128
    h, hkv = 32 // tp, 8 // tp
    plan = iattn.make_iattention(hd, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    rq = RequantSpec.per_tensor(plan.dn_out)
    kv, suffix = {}, ""
    if pool == "contiguous":
        kp = _i8(rng, (b, ps * maxp, hkv, hd), dev)
        vp = _i8(rng, (b, ps * maxp, hkv, hd), dev)
    elif pool == "int8":
        kp = _i8(rng, (b * maxp + 1, ps, hkv, hd), dev)
        vp = _i8(rng, (b * maxp + 1, ps, hkv, hd), dev)
    else:
        kp, vp, shifts = _packed_pools(rng, dev, b * maxp + 1, ps, hkv, hd)
        kv, suffix = dict(kv_shifts=shifts), "_kv4"
    if pool != "contiguous":
        kv.update(pages=torch.as_tensor(
            rng.permutation(np.arange(1, b * maxp + 1)).reshape(b, maxp)
            .astype(np.int32), device=dev), page_size=ps)
    launches = [(sq, int_decode_attention_fused, int_decode_attention_plain,
                 "int_decode_attention", [1, 137, 300, 512])
                for sq in (1, 4)]
    if pool != "contiguous":
        launches.append((32, int_paged_prefill_fused,
                         int_paged_prefill_plain, "int_paged_prefill",
                         [32, 132, 282, 512]))
    for sq, fused, plain, name, lens in launches:
        q8 = _i8(rng, (b, sq, h, hd), dev)
        vl = torch.tensor(lens, dtype=torch.int32, device=dev)
        before = kernels.LAUNCHES[name + suffix]
        got = fused(q8, kp, vp, plan, vl, requant=rq, **kv)
        assert kernels.LAUNCHES[name + suffix] == before + 1
        assert torch.equal(got, plain(q8, kp, vp, plan, vl, requant=rq,
                                      **kv)), (name, sq)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("m", [4, 16, 128])
def test_tp_shard_projections(dev, tp, m):
    """K1 at a llama3-8b rank's projections: wq's and wk's column slices
    (N 4096 / tp, 1024 / tp) with their per-channel epilogue, and wo's
    row slice (K 4096 / tp) raw, at M 4 and 16 (the decode tile) and 128
    (a 4 x 32 chunk): each equals its plain version, and the tp raw
    partials summed, plus the bias, requantized once, equal the unsharded
    per-channel product."""
    from repro_torch.core.dyadic import apply_dyadic_perchannel, clip_to_bits
    rng = np.random.default_rng(tp * 1000 + m)
    d = 4096
    spec = RequantSpec.per_channel(24, 10, 8)
    x8 = _i8(rng, (m, d), dev)
    for n in (d // tp, 1024 // tp):
        w8 = _i8(rng, (d, n), dev)
        bvec = _i32(rng, 256, 4096, (n,), dev)
        before = kernels.LAUNCHES["int8_matmul"]
        got = int8_matmul(x8, w8, spec, b_vec=bvec)
        assert kernels.LAUNCHES["int8_matmul"] == before + 1
        assert torch.equal(got, int8_matmul_plain(x8, w8, spec, None, bvec))
    wo = _i8(rng, (d, d), dev)
    bvec = _i32(rng, 256, 4096, (d,), dev)
    bias = _i32(rng, -5000, 5000, (d,), dev)
    k = d // tp
    total = torch.zeros(m, d, dtype=torch.int32, device=dev)
    for r in range(tp):
        xs, ws = x8[:, r * k:(r + 1) * k].contiguous(), \
            wo[r * k:(r + 1) * k].contiguous()
        part = int8_matmul(xs, ws, RequantSpec.raw())
        assert part.dtype == torch.int32
        assert torch.equal(part, int8_matmul_plain(xs, ws, RequantSpec.raw(),
                                                   None, None))
        total += part
    once = clip_to_bits(apply_dyadic_perchannel(total + bias, bvec, spec.c,
                                                spec.pre), spec.out_bits)
    assert torch.equal(once.to(torch.int8),
                       int8_matmul(x8, wo, spec, bias32=bias,
                                   b_vec=bvec).to(torch.int8))
