"""Integer MoE in the port == the JAX package, bit for bit: reduced
qwen2-moe-a2.7b (8 experts padded to 16, top-2, 2 shared experts, QKV
bias) and qwen3-moe-235b-a22b (8 experts padded to 16, top-2, GQA).

  * the configs' fields equal the reference's at full size;
  * plans and ``quantize_params``, with layer 1's router scaled up so the
    stack's router maximum is not layer 0's: the plans take layer 0's
    scale, every router the stack's (the reference's two passes);
  * ``int_moe_fwd`` against JAX ``il.int_moe_fwd`` at S 1, 16, 64, 1100
    and group sizes 512 and 1, at the default capacity (tokens drop) and
    at capacity factor 8 (none do), a GELU variant, forced ties
    (duplicated router columns: the port's expert ids equal
    ``jax.lax.top_k``'s), and S = 1025, which both refuse;
  * ``int8_matmul_grouped_plain`` against JAX ``int_expert_linear`` (bias,
    out_bits 11 and 14, empty experts), and the grouped kernel's launch
    plan and a numpy emulation of its work (live items, row chunks, K
    ranks; ``tests/test_torch_grouped_plan.py`` models its fragments);
  * ``int_prefill`` logits under ``ref`` and ``pallas_fused`` (their twins
    and ``torch_ref``), ``int_decode_step`` and ``int_verify_step``
    equal JAX's.

Inputs are numpy draws from fixed seeds.  Tolerance: 0.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import registry as j_registry
from repro.models import intlayers as jil
from repro.models import inttransformer as jit_
from repro.models import model as JM
from repro.models import transformer as jtf
from repro.ops import QuantLinearParams as JQLP
from repro.quant import convert as j_convert
from repro.quant import plans as j_plans
from repro_torch.configs import registry as t_registry
from repro_torch.interop import from_reference, plan_from_reference
from repro_torch.kernels.int8_matmul import (GROUPED_BN, _epilogue_plain,
                                             grouped_items, grouped_plan,
                                             grouped_split,
                                             int8_matmul_grouped_plain)
from repro_torch.models import intlayers as til
from repro_torch.models import inttransformer as tit
from repro_torch.models import model as TM
from repro_torch.ops import RequantSpec, resolve_ops
from repro_torch.quant import convert as t_convert
from repro_torch.quant import plans as t_plans

T = torch.as_tensor
ARCHS = ("qwen2-moe-a2.7b", "qwen3-moe-235b-a22b")


def _cfgs(arch, **over):
    over = dict(dtype="float32", vocab=512, **over)
    return (JM.reduce_config(j_registry.get_config(arch), **over),
            TM.reduce_config(t_registry.get_config(arch), **over))


def _float_params(jc, seed=2):
    """JAX's float draws, the embedding at unit std (as the port's serve
    driver draws it) and layer 1's router three times layer 0's scale."""
    params = jtf.init_params(jax.random.key(seed), jc)
    params = {**params, "embed": params["embed"]
              * np.float32(jc.padded_vocab() ** 0.5)}
    layers = params["layers"][0]
    router = np.array(layers["moe"]["router"])
    router[1] *= 3.0
    moe = {**layers["moe"], "router": jnp.asarray(router)}
    return {**params, "layers": [{**layers, "moe": moe}]}


_MODELS = {}


def _model(arch, **over):
    key = (arch, tuple(sorted(over.items())))
    if key not in _MODELS:
        jc, tc = _cfgs(arch, **over)
        params = _float_params(jc)
        jq, jp = j_convert.quantize_params(params, jc)
        tq, tp = from_reference(jax.tree.map(np.array, jq), jp,
                                device="cpu")
        _MODELS[key] = dict(jc=jc, tc=tc, params=params, jq=jq, jp=jp,
                            tq=tq, tp=tp)
    return _MODELS[key]


def _layer0_moe(m):
    jmoe = jax.tree.map(lambda t: t[0], m["jq"]["layers"][0]["moe"])
    tmoe = tit._layer(m["tq"]["layers"][0]["moe"], 0)
    return jmoe, tmoe


def _same_tree(a, b, path="root"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}[{i}]")
    elif a is None or b is None:
        assert a is None and b is None, path
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path


# ----------------------------------------------------------- configs -----

@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_reference(arch):
    jfull, tfull = j_registry.get_config(arch), t_registry.get_config(arch)
    assert dataclasses.asdict(jfull) == dataclasses.asdict(tfull)
    jc, tc = _cfgs(arch)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tc.padded_experts() == 16 and tc.n_experts == 8
    assert tfull.padded_experts() == (64 if arch.startswith("qwen2")
                                      else 128)


@pytest.mark.parametrize("arch", ARCHS)
def test_plans_and_quantize_params_match(arch):
    """The port's converter on JAX's float draws: plans and every integer
    equal; the gate softmax takes layer 0's router scale, the routers the
    stack's (layer 1's maximum is three times layer 0's)."""
    m = _model(arch)
    jc, tc, tq, tp = m["jc"], m["tc"], m["tq"], m["tp"]
    assert t_plans.build_layer_plans(tc) == plan_from_reference(
        j_plans.build_layer_plans(jc))
    tparams = jax.tree.map(lambda a: T(np.array(a)), m["params"])
    got_q, got_p = t_convert.quantize_params(tparams, tc)
    assert got_p == tp
    _same_tree(got_q, tq)
    router = np.asarray(m["params"]["layers"][0]["moe"]["router"],
                        np.float64)
    s0 = np.abs(router[:1]).max() / 127.0
    assert tp.moe.gate_sm.s_in == tc.s_act8 * s0
    r8 = got_q["layers"][0]["moe"]["router"].w8
    assert int(r8[1].abs().max()) == 127 and int(r8[0].abs().max()) < 64
    experts = got_q["layers"][0]["moe"]["w1"]
    assert tuple(experts.w8.shape) == (2, 16, tc.d_model, tc.moe_d_ff)
    assert tuple(experts.b_mult.shape) == (2, 16, tc.moe_d_ff)
    assert tp.ffn is None and tp.moe.shared is not None \
        if arch.startswith("qwen2") else tp.moe.shared is None


def test_init_quantized_routers_take_the_stacks_scale():
    """``init_quantized`` (layer by layer, experts in slices) equals
    ``quantize_params`` of the whole float model from the same seed,
    router scales included."""
    _, tc = _cfgs("qwen2-moe-a2.7b")
    from repro_torch.models import transformer as ttf
    qa, pa = t_convert.init_quantized(tc, seed=3, device="cpu")
    qb, pb = t_convert.quantize_params(
        ttf.init_params(tc, seed=3, device="cpu"), tc)
    assert pa == pb
    _same_tree(qa, qb)


# -------------------------------------------------------- int_moe_fwd ----

#: (S, group_size, capacity factor): one token, a group under 512, a
#: full group, two groups of 550, and one-token groups (decode /
#: verify), at the default capacity; the groups of 512 again at factor 8
#: (a one-token group has cap 4 at either factor)
MOE_CASES = [(s, g, 1.25) for s, g in ((1, 1), (16, 512), (64, 512),
                                       (1100, 512), (16, 1), (64, 1))] \
    + [(s, 512, 8.0) for s in (16, 64, 1100)]


def _moe_both(m, x, group_size):
    """JAX's and the port's ``int_moe_fwd``, and the port's dropped
    (token, slot) pairs (its routing's ``~keep``)."""
    jmoe, tmoe = _layer0_moe(m)
    want = np.asarray(jil.int_moe_fwd(jmoe, jnp.asarray(x), m["jp"].moe,
                                      m["jc"], ops="ref",
                                      group_size=group_size))
    routes, route = [], til.moe_route

    def spy(*a, **k):
        routes.append(route(*a, **k))
        return routes[-1]

    til.moe_route = spy
    try:
        got = til.int_moe_fwd(tmoe, T(x), m["tp"].moe, m["tc"], ops="cuda",
                              group_size=group_size)
    finally:
        til.moe_route = route
    return got.numpy(), want, int((~routes[0].keep).sum())


@pytest.mark.parametrize("s,group_size,capacity", MOE_CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_int_moe_fwd_matches_reference(arch, s, group_size, capacity):
    """Default capacity (prefill groups drop tokens) and factor 8 (none
    drop); one-token groups never drop."""
    m = _model(arch, capacity_factor=capacity)
    x = np.random.default_rng(s).integers(
        -127, 128, (2, s, m["tc"].d_model)).astype(np.int8)
    got, want, drops = _moe_both(m, x, group_size)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert len(np.unique(want)) > 10
    if group_size == 1 or capacity == 8.0:
        assert drops == 0
    elif s >= 64:
        assert drops > 0


def test_int_moe_fwd_gelu_variant():
    """A GELU expert FFN (w1 / w2 with the i-GELU between, shared experts'
    biases): the ``gelu`` branch, i-GELU through ``ops.int_gelu``."""
    m = _model("qwen2-moe-a2.7b", activation="gelu")
    assert "w3" not in m["tq"]["layers"][0]["moe"]
    x = np.random.default_rng(7).integers(
        -127, 128, (2, 64, m["tc"].d_model)).astype(np.int8)
    got, want, drops = _moe_both(m, x, 512)
    assert np.array_equal(got, want) and drops > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_forced_ties_route_like_top_k(arch):
    """Router columns 1, 2, 4 and 7 copied from column 0: every token's
    logits tie there.  The port's expert ids are ``jax.lax.top_k``'s
    (lower index first), where ``torch.topk`` may differ; the outputs
    equal."""
    jc, tc = _cfgs(arch)
    params = _float_params(jc, seed=5)
    layers = params["layers"][0]
    router = np.array(layers["moe"]["router"])
    router[..., [1, 2, 4, 7]] = router[..., [0]]
    params = {**params, "layers": [{**layers, "moe": {
        **layers["moe"], "router": jnp.asarray(router)}}]}
    jq, jp = j_convert.quantize_params(params, jc)
    tq, tp = from_reference(jax.tree.map(np.array, jq), jp, device="cpu")
    m = dict(jc=jc, tc=tc, jq=jq, jp=jp, tq=tq, tp=tp)
    jmoe, tmoe = _layer0_moe(m)
    x = np.random.default_rng(9).integers(-127, 128, (2, 32, tc.d_model)
                                          ).astype(np.int8)
    jlog = jil.int_linear(jnp.asarray(x), jmoe["router"], jp.moe.router,
                          ops="ref")
    jlog = jnp.where(jnp.arange(16) >= 8, jnp.int32(-(2 ** 30)), jlog)
    _, want_ids = jax.lax.top_k(jlog, tc.top_k)
    tlog = til.int_linear(T(x), tmoe["router"], tp.moe.router,
                          ops="torch_ref")
    assert np.array_equal(tlog.numpy(), np.asarray(
        jil.int_linear(jnp.asarray(x), jmoe["router"], jp.moe.router,
                       ops="ref")))
    route = til.moe_route(tlog, tp.moe, tc, 64)
    assert np.array_equal(route.expert_ids.numpy(), np.asarray(want_ids))
    tied = np.asarray(jlog)[..., [0, 1, 2, 4, 7]]
    assert (tied == tied[..., :1]).all()
    got, want, _ = _moe_both(m, x, 512)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_s_1025_refuses_in_both(arch):
    """S = 1025: two groups of 512 do not tile the sequence; the
    reference's reshape fails, and so does the port's."""
    m = _model(arch)
    jmoe, tmoe = _layer0_moe(m)
    x = np.zeros((1, 1025, m["tc"].d_model), np.int8)
    with pytest.raises(TypeError):
        jil.int_moe_fwd(jmoe, jnp.asarray(x), m["jp"].moe, m["jc"],
                        ops="ref")
    with pytest.raises(RuntimeError, match="shape"):
        til.int_moe_fwd(tmoe, T(x), m["tp"].moe, m["tc"], ops="cuda")


def test_missing_grouped_op_raises_clearly():
    """A backend registered without ``int8_matmul_grouped`` runs dense
    archs and refuses an MoE with a clear error."""
    from repro_torch.ops import get_backend, register_backend, \
        unregister_backend

    class NoGrouped:
        name = "no_grouped"
        fused_attention = False

        def __getattr__(self, op):
            if op == "int8_matmul_grouped":
                raise AttributeError(op)
            return getattr(get_backend("torch_ref"), op)

    be = NoGrouped()
    for op in ("int8_matmul", "int_softmax", "int_gelu", "int_layernorm",
               "int_attention", "int_decode_attention"):
        setattr(be, op, getattr(get_backend("torch_ref"), op))
    register_backend("no_grouped", be, overwrite=True)
    try:
        m = _model("qwen2-moe-a2.7b")
        _, tmoe = _layer0_moe(m)
        x = T(np.ones((1, 4, m["tc"].d_model), np.int8))
        with pytest.raises(NotImplementedError, match="int8_matmul_grouped"):
            til.int_moe_fwd(tmoe, x, m["tp"].moe, m["tc"],
                            ops=resolve_ops("no_grouped"))
    finally:
        unregister_backend("no_grouped")


def test_packed_experts_refused():
    from repro_torch.interop import qparams_from_reference
    from repro_torch.quant.pack import pack_linear
    from repro_torch.ops import QuantLinearParams
    w = QuantLinearParams(T(np.ones((2, 8, 4), np.int8)))
    tree = {"moe": {"w1": pack_linear(w, scheme="msr4", group=8)}}
    with pytest.raises(ValueError, match="packed expert"):
        qparams_from_reference(tree, device="cpu")
    m = _model("qwen2-moe-a2.7b")
    _, tmoe = _layer0_moe(m)
    tmoe = {**tmoe, "w2": pack_linear(tmoe["w2"], scheme="msr4", group=8)}
    with pytest.raises(ValueError, match="packed expert"):
        til.int_moe_fwd(tmoe, T(np.ones((1, 4, m["tc"].d_model), np.int8)),
                        m["tp"].moe, m["tc"], ops="cuda")


# ------------------------------------------------ the grouped kernel -----

def _grouped_operands(seed, e, r, k, n, rows):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (e, r, k)).astype(np.int8)
    w = rng.integers(-127, 128, (e, k, n)).astype(np.int8)
    bias = rng.integers(-4000, 4000, (e, n)).astype(np.int32)
    bmul = rng.integers(1, 3000, (e, n)).astype(np.int32)
    return x, w, bias, bmul, np.asarray(rows, np.int32)


@pytest.mark.parametrize("out_bits", [11, 14])
@pytest.mark.parametrize("with_bias", [False, True])
def test_grouped_plain_matches_int_expert_linear(out_bits, with_bias):
    """Every row of the plain version == JAX ``int_expert_linear`` on the
    same operands (one routing group), empty experts included; the
    ``cuda`` op on CPU tensors is the plain version."""
    e, r, k, n = 5, 24, 96, 40
    x, w, bias, bmul, rows = _grouped_operands(out_bits, e, r, k, n,
                                               [24, 0, 7, 1, 0])
    jplan = j_plans.make_linear_plan(8 / 127, 2 / 127, 16 / 1024, k,
                                     out_bits=out_bits)
    tplan = plan_from_reference(jplan)
    jq = JQLP(jnp.asarray(w), jnp.asarray(bmul),
              jnp.asarray(bias) if with_bias else None)
    want = np.asarray(jil.int_expert_linear(jnp.asarray(x[None]), jq,
                                            jplan))[0]
    spec = RequantSpec.for_linear(tplan)
    b32 = T(bias) if with_bias else None
    got = int8_matmul_grouped_plain(T(x), T(w), T(rows), spec, b32,
                                    T(bmul))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    via_op = resolve_ops("cuda").int8_matmul_grouped(
        T(x), T(w), T(rows), spec, bias32=b32, b_vec=T(bmul))
    assert torch.equal(via_op, got)


def _emulate_grouped(x, w, rows, spec, bias, bmul, plan):
    """The kernel's work in numpy: the live experts' (expert, 128-column
    tile) items, split across ``grouped_split``'s S ranks, worker w taking
    items w, w + workers, ...; each rank's K range summed (mod 2^32), row
    chunks of ``plan.rt``, rows below rows[e] only, expert e's epilogue
    rows.  Unwritten rows keep the sentinel.  Returns (out, items done)."""
    e, r, k = x.shape
    n = w.shape[2]
    out = np.full((e, r, n), -99999, np.int64)
    live = [i for i in range(e) if min(int(rows[i]), r) > 0]
    ntiles = -(-n // GROUPED_BN)
    split, kper, _ = grouped_split(plan, k, len(live) * ntiles)
    workers = plan.grid[0] // split
    done = 0
    for worker in range(workers):
        for item in range(worker, len(live) * ntiles, workers):
            ex, nt = live[item // ntiles], item % ntiles
            m = min(int(rows[ex]), r)
            n0, n1 = nt * GROUPED_BN, min(n, (nt + 1) * GROUPED_BN)
            done += 1
            for m0 in range(0, m, plan.rt):
                m1 = min(m, m0 + plan.rt)
                acc = np.zeros((m1 - m0, n1 - n0), np.int64)
                for rank in range(split):
                    k0, k1 = rank * kper, min(k, (rank + 1) * kper)
                    acc += (x[ex, m0:m1, k0:k1].astype(np.int64)
                            @ w[ex, k0:k1, n0:n1].astype(np.int64))
                acc = T(acc).to(torch.int32)
                if bias is not None:
                    acc = acc + T(bias[ex, n0:n1])
                out[ex, m0:m1, n0:n1] = _epilogue_plain(
                    acc, spec, T(bmul[ex, n0:n1])).numpy()
    return out, done


@pytest.mark.parametrize("e,r,k,n,rows", [
    (4, 16, 1024, 300, [16, 0, 3, 1]),        # decode: 9 items split 2 ways
    (3, 17, 40, 128, [17, 16, 0]),            # one row past it: 48 rows
    (2, 160, 96, 136, [160, 65]),             # prefill: a 192-row tile
    (3, 64, 32, 20, [0, 0, 0]),               # every expert empty
    (2, 300, 64, 40, [300, 193]),             # two row chunks of 192
])
def test_grouped_launch_plan_and_schedule(e, r, k, n, rows):
    """The plan from the shape alone (16-row decode tiles in clusters that
    may split K for R <= 16, else the smallest row tile that holds R, up to
    192; one wave of blocks, no more than the items of every expert); the
    emulated work gives the plain version's integers on every packed row,
    writes no other row, and does ``grouped_items`` items."""
    plan = grouped_plan(e, r, n, k, 132)
    assert plan.rt == (16 if r <= 16 else
                       next(t for t in (48, 96, 192) if t >= min(r, 192)))
    assert plan.cluster == (2 if r <= 16 and k >= 512 else 1)
    assert plan.grid[0] % plan.cluster == 0
    assert plan.grid[0] // plan.cluster <= e * -(-n // 128)
    x, w, bias, bmul, rows = _grouped_operands(e + r, e, r, k, n, rows)
    spec = RequantSpec.per_channel(20, 6, 14)
    out, done = _emulate_grouped(x, w, rows, spec, bias, bmul, plan)
    assert done == grouped_items(n, rows)
    want = int8_matmul_grouped_plain(T(x), T(w), T(rows), spec, T(bias),
                                     T(bmul)).numpy()
    for ex, c in enumerate(rows):
        assert np.array_equal(out[ex, :c], want[ex, :c])
        assert (out[ex, c:] == -99999).all()


# ----------------------------------------------------- the model path ----

@pytest.mark.parametrize("j_ops", ["ref", "pallas_fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_int_prefill_matches_reference(arch, j_ops):
    """Last-position logits at B 2, S 24 (one routing group): the port's
    twin of ``j_ops`` and ``torch_ref`` equal JAX ``int_prefill``."""
    m = _model(arch)
    toks = np.random.default_rng(4).integers(0, m["jc"].vocab, (2, 24)
                                             ).astype(np.int32)
    want = np.asarray(jit_.int_prefill(m["jq"], {"tokens": jnp.asarray(toks)},
                                       m["jp"], m["jc"], ops=j_ops))
    for backend in (j_ops, "torch_ref"):
        got = tit.int_prefill(m["tq"], {"tokens": T(toks)}, m["tp"],
                              m["tc"], ops=backend)
        assert np.array_equal(got.numpy(), want), backend


VB, VLEN, VS = 3, 24, 4
START = np.array([8, 10, 9], np.int32)
N_NEW = np.array([3, 4, 1], np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_and_verify_steps_match_reference(arch):
    """Contiguous caches from ``int_prefill(return_cache=True)`` of 8
    tokens, two decode steps, then one verify step at S = 4 (n_new 3 / 4 /
    1): logits and caches equal the JAX package's at every step."""
    m = _model(arch)
    jc, tc = m["jc"], m["tc"]
    rng = np.random.default_rng(6)
    toks = rng.integers(1, jc.vocab, (VB, 8)).astype(np.int32)
    _, jcache = jit_.int_prefill(m["jq"], {"tokens": jnp.asarray(toks)},
                                 m["jp"], jc, ops="ref", return_cache=True,
                                 cache_len=VLEN)
    _, tcache = tit.int_prefill(m["tq"], {"tokens": T(toks)}, m["tp"], tc,
                                ops="cuda", return_cache=True,
                                cache_len=VLEN)
    jrope = jil.build_rope_table(VLEN + 1, jc.hd, jc.rope_theta)
    trope = til.build_rope_table(VLEN + 1, tc.hd, tc.rope_theta,
                                 device="cpu")

    def same_caches():
        for a, b in zip(tcache, jcache):
            for key in ("k8", "v8"):
                assert np.array_equal(a[key].numpy(), np.asarray(b[key]))

    pos = np.full((VB,), 8, np.int32)
    for t in range(2):
        step = rng.integers(1, jc.vocab, VB).astype(np.int32)
        jlog, jcache = jit_.int_decode_step(
            m["jq"], jcache, jnp.asarray(step), jnp.asarray(pos + t),
            m["jp"], jc, jrope, ops="ref")
        tlog, tcache = tit.int_decode_step(
            m["tq"], tcache, T(step), T(pos + t), m["tp"], tc, trope,
            ops="cuda")
        assert np.array_equal(tlog.numpy(), np.asarray(jlog)), t
        same_caches()
    vt = rng.integers(1, jc.vocab, (VB, VS)).astype(np.int32)
    for i, n in enumerate(N_NEW):
        vt[i, :VS - n] = 0
    jlog, jcache = jit_.int_verify_step(
        m["jq"], jcache, jnp.asarray(vt), jnp.asarray(START),
        jnp.asarray(N_NEW), m["jp"], jc, jrope, ops="ref")
    tlog, tcache = tit.int_verify_step(
        m["tq"], tcache, T(vt), T(START), T(N_NEW), m["tp"], tc, trope,
        ops="cuda", write_rows=T(til.real_rows(N_NEW, VS)))
    assert np.array_equal(tlog.numpy(), np.asarray(jlog))
    same_caches()
