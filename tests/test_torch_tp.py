"""Tensor-parallel serving in the port (``tp > 1`` over a
``torch.distributed`` group) == the JAX package, bit for bit.

  * ``validate_tp`` / ``tp_arch_supported`` / ``local_cfg`` /
    ``backends_support_tp`` against ``repro.distributed.tp_serving`` for
    all 13 configs at tp 1, 2, 3, 4, 8 and every backend twin;
  * ``shard_qparams`` against the numpy slices that the reference's
    ``qparam_pspecs`` names, leaf by leaf (reduced llama3-8b, and
    codeqwen1.5-7b for the QKV bias);
  * ``_tp_wo_project``: the partials of tp ranks, summed (emulated in one
    process), give the port's and the JAX package's ``int_linear`` with
    bias and per-channel requant;
  * the quantized collectives: ``compress_decompress`` /
    ``compressed_grads`` against JAX's, ``psum_int32`` / ``psum_int8``
    over a gloo world against JAX's under ``jax.vmap(axis_name=)``;
  * token streams: one gloo world of 2 processes (reduced llama3-8b, H 4
    / Hkv 2, and reduced qwen2-moe-a2.7b) and one of 4 (the reference's
    4 / 4 lift, ``tests/test_serving_sharded.py``), every rank sharded,
    on ``torch_ref`` and ``cuda`` (the plain versions on CPU tensors):
    paged chunked, paged streaming (a sampled request among them),
    contiguous, int4 pages, ``spec_k = 3``, and prefix sharing with a
    mid-prefill preempt (the same prefix hits and copy-on-write copies)
    equal the JAX engine's ``tp = 1`` streams (the reference's sharded
    path does not run on jax 0.9.0: ROADMAP §3); the world of 4 split
    into two groups of 2, an engine on each (``group=``); the serve CLI
    in the world, and refused in a world of another size; without a
    group ``tp = 2`` is the gathered mode, as in the reference, and a
    ``group=`` of another size raises;
  * the refusals: tp 3, the SSM and cross attention archs, ``fold_wo``
    with a group, packed weights when sharding.

Inputs are numpy draws from fixed seeds.  Tolerance: 0.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import registry as j_registry
from repro.distributed import collectives as jcoll
from repro.distributed import tp_serving as jtp
from repro.models import intlayers as jil
from repro.models import model as JM
from repro.models import transformer as jtf
from repro.ops import QuantLinearParams as JQLP
from repro.ops import resolve_ops as j_resolve_ops
from repro.quant import convert as j_convert
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import registry as t_registry
from repro_torch.distributed import collectives as tcoll
from repro_torch.distributed import tp_serving as ttp
from repro_torch.distributed.world import run_world, serve_replay
from repro_torch.interop import from_reference
from repro_torch.launch import serve as tserve
from repro_torch.models import intlayers as til
from repro_torch.models import model as TM
from repro_torch.ops import TWINS, QuantLinearParams, resolve_ops
from repro_torch.quant.pack import pack_tree
from repro_torch.serving import Request as TRequest
from repro_torch.serving import ServingEngine as TEngine

BACKENDS = ("torch_ref", "cuda")
TPS = (1, 2, 3, 4, 8)
_MODELS = {}


def _model(arch, **over):
    """JAX and port configs, the JAX package's quantized params and their
    port copy (CPU), for a reduced ``arch``."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _MODELS:
        over = dict(dtype="float32", vocab=512, **over)
        jc = JM.reduce_config(j_registry.get_config(arch), **over)
        tc = TM.reduce_config(t_registry.get_config(arch), **over)
        params = jtf.init_params(jax.random.key(3), jc)
        if jc.n_experts:        # signal through the integer path
            params = {**params, "embed": params["embed"]
                      * np.float32(jc.padded_vocab() ** 0.5)}
        jq, jp = j_convert.quantize_params(params, jc)
        tq, tp = from_reference(jax.tree.map(np.array, jq), jp,
                                device="cpu")
        _MODELS[key] = (jc, tc, jq, jp, tq, tp)
    return _MODELS[key]


# ---------------------------------------------------------- helpers -----

def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:          # the type and message are compared
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("name", sorted(j_registry.ARCHS))
def test_validate_tp_and_local_cfg_match_reference(name):
    jc, tc = j_registry.get_config(name), t_registry.get_config(name)
    assert ttp.tp_arch_supported(tc) == jtp.tp_arch_supported(jc)
    for tp in TPS:
        got = _outcome(ttp.validate_tp, tc, tp)
        assert got == _outcome(jtp.validate_tp, jc, tp), (name, tp)
        if got[0] == "ok":
            tl, jl = ttp.local_cfg(tc, tp), jtp.local_cfg(jc, tp)
            assert (tl.n_heads, tl.n_kv_heads, tl.head_dim, tl.hd) \
                == (jl.n_heads, jl.n_kv_heads, jl.head_dim, jl.hd)
            assert dataclasses.replace(tl, n_heads=tc.n_heads,
                                       n_kv_heads=tc.n_kv_heads,
                                       head_dim=tc.head_dim) == tc
    assert _outcome(ttp.validate_tp, tc, 0) == _outcome(jtp.validate_tp,
                                                        jc, 0)


def test_backends_support_tp_matches_reference():
    for jname, tname in TWINS.items():
        assert ttp.backends_support_tp(resolve_ops(tname)) \
            == jtp.backends_support_tp(j_resolve_ops(jname)), jname
    assert ttp.backends_support_tp(resolve_ops("torch_ref"))
    assert not ttp.backends_support_tp(
        resolve_ops("cuda").with_overrides(int_attention="cuda_online"))


# --------------------------------------------------------- sharding -----

def _spec_slice(a, spec, rank, tp):
    """The numpy slice of ``a`` that rank ``rank`` holds under ``spec``."""
    a = np.asarray(a)
    if spec is None or jtp.TP_AXIS not in tuple(spec):
        return a
    axis = tuple(spec).index(jtp.TP_AXIS)
    n = a.shape[axis] // tp
    return np.take(a, np.arange(rank * n, (rank + 1) * n), axis=axis)


@pytest.mark.parametrize("arch", ["llama3-8b", "codeqwen1.5-7b"])
@pytest.mark.parametrize("tp", [2])
def test_shard_qparams_match_reference_pspecs(arch, tp):
    """Every attention leaf of every rank's shard equals the slice the
    reference's PartitionSpec names (codeqwen: the QKV ``bias32`` with
    its columns); every other leaf is the full tensor, unsliced, as its
    replicated spec says."""
    _, _, jq, _, tq, _ = _model(arch)
    specs = jtp.qparam_pspecs(jq)
    P = jax.sharding.PartitionSpec
    replicated = [s for k, v in specs.items() if k != "layers"
                  for s in jax.tree.leaves(
                      v, is_leaf=lambda x: isinstance(x, P))]
    assert replicated and all(s == P() for s in replicated)
    biased = 0
    for rank in range(tp):
        shard = ttp.shard_qparams(tq, rank, tp)
        assert all(shard[k] is tq[k] for k in tq if k != "layers")
        for jg, sg, tg, g in zip(jq["layers"], specs["layers"],
                                 tq["layers"], shard["layers"]):
            assert all(g[k] is tg[k] for k in tg if k != "attn")
            for name, jw in jg["attn"].items():
                js, tw = sg["attn"][name], g["attn"][name]
                for field in ("w8", "b_mult", "bias32"):
                    want, got = getattr(jw, field), getattr(tw, field)
                    assert (want is None) == (got is None), (name, field)
                    if want is None:
                        continue
                    assert got.is_contiguous()
                    assert np.array_equal(
                        got.numpy(), _spec_slice(want, getattr(js, field),
                                                 rank, tp)), (name, field)
                    biased += field == "bias32"
    assert (biased > 0) == (arch == "codeqwen1.5-7b")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_wo_project_sums_partials_then_requants_once(monkeypatch,
                                                        backend, tp):
    """``_tp_wo_project`` in each of ``tp`` emulated ranks (the psum
    patched to the partials' sum): every rank's output equals the port's
    and the JAX package's unsharded ``int_linear`` of the same wo with a
    bias and its per-channel requant."""
    _, tc, _, jp, tq, tplans = _model("llama3-8b", n_heads=4, n_kv_heads=4)
    wo = tq["layers"][0]["attn"]["wo"].map(lambda t: t[0])
    rng = np.random.default_rng(11)
    bias = rng.integers(-2 ** 12, 2 ** 12, wo.n_dim).astype(np.int32)
    wo = wo._replace(bias32=torch.as_tensor(bias))
    o8 = rng.integers(-128, 128, (3, 2, wo.k_dim)).astype(np.int8)
    want = til.int_linear(torch.as_tensor(o8), wo, tplans.attn.out,
                          backend)
    jwo = JQLP(jnp.asarray(wo.w8.numpy()), jnp.asarray(wo.b_mult.numpy()),
               jnp.asarray(bias))
    jwant = jil.int_linear(jnp.asarray(o8), jwo, jp.attn.out, "ref")
    assert np.array_equal(want.numpy(), np.asarray(jwant))
    n = wo.k_dim // tp
    shards = [(torch.as_tensor(o8[..., r * n:(r + 1) * n]),
               wo._replace(w8=wo.w8[r * n:(r + 1) * n].contiguous()))
              for r in range(tp)]
    partials = []
    monkeypatch.setattr(tcoll, "psum_int32",
                        lambda x, group: partials.append(x.clone()) or x)
    for x, w in shards:
        til._tp_wo_project(x, w, tplans.attn.out, "group", backend)
    assert all(p.dtype == torch.int32 for p in partials)
    total = sum(partials)
    monkeypatch.setattr(tcoll, "psum_int32", lambda x, group: total.clone())
    for x, w in shards:
        got = til._tp_wo_project(x, w, tplans.attn.out, "group", backend)
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


# ------------------------------------------------------ collectives -----

def test_compression_matches_reference():
    rng = np.random.default_rng(2)
    grads = {"a": rng.standard_normal((7, 5)).astype(np.float32),
             "b": [rng.standard_normal(9).astype(np.float32) * 1e-3,
                   np.zeros(4, np.float32)]}
    jg = jax.tree.map(jnp.asarray, grads)
    tg = jax.tree.map(torch.as_tensor, grads)
    jstate, tstate = jcoll.init_compression(jg), tcoll.init_compression(tg)
    for _ in range(3):                       # the error carries over
        jg_hat, jstate = jcoll.compressed_grads(jg, jstate)
        tg_hat, tstate = tcoll.compressed_grads(tg, tstate)
        for a, b in zip(jax.tree.leaves((jg_hat, jstate.error)),
                        jax.tree.leaves((tg_hat, tstate.error))):
            assert np.array_equal(np.asarray(a), b.numpy())
    g, e = grads["a"], rng.standard_normal((7, 5)).astype(np.float32)
    for a, b in zip(jcoll.compress_decompress(jnp.asarray(g),
                                              jnp.asarray(e)),
                    tcoll.compress_decompress(torch.as_tensor(g),
                                              torch.as_tensor(e))):
        assert np.array_equal(np.asarray(a), b.numpy())
    with pytest.raises(TypeError, match="int32"):
        tcoll.psum_int32(torch.zeros(2, dtype=torch.int64))


# ----------------------------------------------------------- worlds -----

PROMPTS = [[1, 7, 42, 9, 3], [2, 7, 42], [11] * 18, [5], [9, 3, 77, 4] * 4]
GEOM = dict(batch_size=2, cache_len=64, page_size=16)
MODES = {
    "chunked": dict(prefill_chunk=16),
    "streaming": dict(prefill_chunk=0),
    "contiguous": dict(cache_mode="contiguous"),
    "int4": dict(prefill_chunk=16, kv_dtype="int4"),
    "spec": dict(prefill_chunk=16, spec_k=3),
    "prefix_preempt": dict(prefill_chunk=16, prefill_budget=16),
}
MOE_GEOM = dict(batch_size=2, cache_len=40, page_size=8)


def _drain(prompts, max_new, temps=()):
    temps = list(temps) + [0.0] * (len(prompts) - len(temps))
    return [("submit", p, max_new, t) for p, t in zip(prompts, temps)] \
        + [("run",)]


def _actions(mode):
    if mode == "streaming":          # a sampled stream: the ranks' rngs
        return _drain(PROMPTS, 6, temps=[0.0, 0.9])
    if mode != "prefix_preempt":
        return _drain(PROMPTS, 6)
    # the reference's scenario (tests/test_serving_sharded.py): a shared
    # 19-token prefix with copy-on-write, then a 40-token prompt preempted
    # after its first budgeted chunk round, resumed
    rng = np.random.default_rng(3)
    stem = list(map(int, rng.integers(1, 100, 20)))
    long = list(map(int, rng.integers(1, 100, 40)))
    return [("submit", stem, 4), ("run",), ("submit", stem[:-1] + [101], 4),
            ("run",), ("mark",), ("submit", long, 4), ("step",),
            ("preempt", 2), ("submit", [7, 8], 2), ("run",), ("mark",)]


def _j_replay(jq, jp, jc, geom, actions):
    """The JAX engine (``ops="ref"``, tp = 1) through the same actions."""
    eng = JEngine(jq, jp, jc, ops="ref", **geom)
    reqs, sessions, marks = [], [], []
    for op, *arg in actions:
        if op == "submit":
            reqs.append(JRequest(uid=len(reqs), prompt=list(arg[0]),
                                 max_new_tokens=arg[1],
                                 temperature=arg[2] if len(arg) > 2
                                 else 0.0))
            sessions.append(eng.submit(reqs[-1]))
        elif op == "step":
            eng.step()
        elif op == "run":
            eng.run_until_done()
        elif op == "preempt":
            assert sessions[arg[0]].state == "prefilling"
            eng.preempt(sessions[arg[0]])
        elif op == "mark":
            c = eng.describe()["cache"]
            marks.append((c["prefix"]["hits"], c["cow_copies"]))
    assert all(r.done for r in reqs)
    return [list(r.out_tokens) for r in reqs], marks


def _world_cases(model, modes, geom):
    """(JAX baseline by mode, the port's runs by (backend, mode))."""
    jc, tc, jq, jp, tq, tp = model
    want = {m: _j_replay(jq, jp, jc, {**geom, **MODES.get(m, {})},
                         _actions(m)) for m in modes}
    runs = {(b, m): dict(engine={**geom, **MODES.get(m, {}), "ops": b},
                         actions=_actions(m))
            for b in BACKENDS for m in modes}
    return want, runs


SUBGROUPS = [[0, 1], [2, 3]]
CLI_ARGV = ["--arch", "llama3-8b", "--reduced", "--device", "cpu",
            "--requests", "3", "--max-new", "4", "--batch", "2",
            "--cache-len", "32", "--tp", "2"]


@pytest.fixture(scope="module")
def worlds():
    """One gloo world of 2 ranks and one of 4, each running its whole
    matrix once; the JAX package's tp = 1 streams beside them."""
    l2 = _model("llama3-8b")
    l4 = _model("llama3-8b", n_heads=4, n_kv_heads=4)
    moe = _model("qwen2-moe-a2.7b")
    want2, runs2 = _world_cases(l2, MODES, GEOM)
    want4, runs4 = _world_cases(l4, MODES, GEOM)
    wmoe, rmoe = _world_cases(moe, ["moe"], MOE_GEOM)
    rng = np.random.default_rng(4)
    x32 = [rng.integers(-2 ** 20, 2 ** 20, (3, 5)).astype(np.int32)
           for _ in range(2)]
    xf = [rng.standard_normal((3, 5)).astype(np.float32) for _ in range(2)]
    # the world of 4 also split into two groups of 2 (``group=``)
    split = [dict(run, groups=SUBGROUPS) for (b, m), run in runs4.items()
             if m == "chunked"]
    out2 = run_world(2, [
        (tcoll.psum_int32, [(torch.as_tensor(x),) for x in x32]),
        (tcoll.psum_int8, [(torch.as_tensor(x),) for x in xf]),
        (serve_replay, ((l2[4], l2[5], l2[1]), list(runs2.values()), "cpu")),
        (serve_replay, ((moe[4], moe[5], moe[1]), list(rmoe.values()),
                        "cpu")),
        (tserve.main, (CLI_ARGV,))], backend="gloo", timeout_s=300)
    out4 = run_world(4, [
        (serve_replay, ((l4[4], l4[5], l4[1]), list(runs4.values()), "cpu")),
        (serve_replay, ((l4[4], l4[5], l4[1]), split, "cpu"))],
        backend="gloo", timeout_s=300)
    return {
        "psum": (x32, xf, [r[0] for r in out2], [r[1] for r in out2]),
        "serve": {2: (want2, dict(zip(runs2, zip(*[r[2] for r in out2])))),
                  4: (want4, dict(zip(runs4, zip(*[r[0] for r in out4]))))},
        "moe": (wmoe, dict(zip(rmoe, zip(*[r[3] for r in out2])))),
        "split": (want4["chunked"], [r[1] for r in out4]),
        "cli": [r[4] for r in out2]}


def test_psum_over_a_gloo_world_matches_reference(worlds):
    """``psum_int32`` / ``psum_int8`` of 2 ranks == JAX's under
    ``jax.vmap(..., axis_name=)``, on every rank."""
    x32, xf, got32, got8 = worlds["psum"]
    w32 = jax.vmap(lambda x: jcoll.psum_int32(x, "i"), axis_name="i")(
        jnp.stack(x32))
    w8 = jax.vmap(lambda x: jcoll.psum_int8(x, "i"), axis_name="i")(
        jnp.stack(xf))
    for r in range(2):
        assert got32[r].dtype == torch.int32
        assert np.array_equal(got32[r].numpy(), np.asarray(w32[r]))
        assert np.array_equal(got8[r].numpy(), np.asarray(w8[r]))


def _check_ranks(want, ranks, tp, groups=None):
    streams, marks = want
    assert len({t for s in streams for t in s}) > 1
    for r, got in enumerate(ranks):
        assert got["streams"] == streams, (r, got["streams"], streams)
        assert got["marks"] == marks, r
        assert got["tp"]["mode"] == "sharded", got["tp"]
        mine = next(g for g in groups if r in g) if groups \
            else list(range(tp))
        assert got["tp"]["mesh"] == {"axis": "tp", "shape": [tp],
                                     "ranks": mine, "backend": "gloo"}
        assert got["fold_wo"] is False              # requant rounds once
        assert f"tp={tp}:sharded" in got["describe"]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_streams_match_reference(worlds, tp, backend, mode):
    """Every rank of the world, sharded, gives the JAX engine's tp = 1
    streams (and, with prefix sharing, its hits and CoW copies)."""
    want, got = worlds["serve"][tp]
    _check_ranks(want[mode], got[(backend, mode)], tp)
    if mode == "prefix_preempt":
        hits, cow = want[mode][1][0]
        assert hits >= 1 and cow > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_moe_streams_match_reference(worlds, backend):
    """Reduced qwen2-moe-a2.7b: attention sharded, the experts
    replicated."""
    want, got = worlds["moe"]
    _check_ranks(want["moe"], got[(backend, "moe")], 2)


@pytest.mark.parametrize("backend", BACKENDS)
def test_engines_on_subgroups_shard(worlds, backend):
    """A world of 4 split into two groups of 2, an engine on each
    (``group=``, tp 2): every rank sharded over its own group's ranks,
    with the JAX engine's tp = 1 streams."""
    want, got = worlds["split"]
    ranks = [runs[BACKENDS.index(backend)] for runs in got]
    _check_ranks(want, ranks, 2, groups=SUBGROUPS)


def test_engine_refuses_a_group_of_another_size(tmp_path):
    """``group=`` with another size than ``tp`` raises; the default group
    of another size is the gathered mode."""
    _, tc, _, _, tq, tp = _model("llama3-8b")
    dist = torch.distributed
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="tp=2 but the process group "
                           "passed has 1 ranks"):
            TEngine(tq, tp, tc, device="cpu", tp=2, group=dist.group.WORLD,
                    **GEOM)
        eng = TEngine(tq, tp, tc, device="cpu", tp=2, **GEOM)
        assert eng.describe()["tp"]["mode"] == "gathered"
    finally:
        dist.destroy_process_group()


def test_serve_cli_in_a_world_shards(worlds, capsys):
    """``launch.serve --tp 2`` in a world of 2 serves sharded on every
    rank, with the streams it serves gathered in one process (which says
    so).  The gathered mode is the single-device path, which the engine
    tests hold to the JAX engine; the CLI draws its own model, which the
    JAX package has no way to take."""
    reqs = tserve.main(CLI_ARGV)
    out = capsys.readouterr().out
    assert "tp=2:gathered" in out and "single-device" in out
    for ranked in worlds["cli"]:
        assert [r.out_tokens for r in ranked] == [r.out_tokens for r in reqs]


@pytest.mark.parametrize("world,tp", [("4", 2), ("2", 1), ("3", 2)])
def test_serve_cli_refuses_a_world_of_another_size(monkeypatch, capsys,
                                                   world, tp):
    """Started by a launcher as one of a world of another size than
    ``--tp``, the CLI refuses before it makes a group (every process
    would serve alone and print the same output)."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", world)
    argv = CLI_ARGV[:-1] + [str(tp)]
    with pytest.raises(SystemExit):
        tserve.main(argv)
    assert f"in a world of {world} processes" in capsys.readouterr().err
    assert not torch.distributed.is_initialized()


def test_gathered_mode_matches_reference_describe_and_streams():
    """Without a process group ``tp = 2`` is the gathered mode: the JAX
    engine's ``describe()["tp"]`` fields (it lacks the devices too) and
    the tp = 1 streams."""
    jc, tc, jq, jp, tq, tp = _model("llama3-8b")
    geom = {**GEOM, **MODES["chunked"]}
    want, _ = _j_replay(jq, jp, jc, geom, _actions("chunked"))
    jeng = JEngine(jq, jp, jc, ops="ref", tp=2, **geom)
    for backend in BACKENDS:
        eng = TEngine(tq, tp, tc, ops=backend, device="cpu", tp=2, **geom)
        assert eng.describe()["tp"] == jeng.describe()["tp"]
        assert eng.describe()["tp"]["mode"] == "gathered"
        assert eng.fold_wo and "tp=2:gathered" in eng.describe_str()
        reqs = [TRequest(uid=i, prompt=list(p), max_new_tokens=6)
                for i, p in enumerate(PROMPTS)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        assert [r.out_tokens for r in reqs] == want


# --------------------------------------------------------- refusals -----

@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-v0.1-52b",
                                  "seamless-m4t-large-v2",
                                  "llama-3.2-vision-90b"])
def test_unshardable_archs_refused(arch):
    cfg = TM.reduce_config(t_registry.get_config(arch), dtype="float32")
    with pytest.raises(ValueError) as e:
        TEngine(None, None, cfg, device="cpu", tp=2)
    with pytest.raises(ValueError) as je:
        jtp.validate_tp(JM.reduce_config(j_registry.get_config(arch),
                                         dtype="float32"), 2)
    assert str(e.value) == str(je.value)


def test_tp_refusals():
    """tp 3 (does not divide Hkv), ``fold_wo`` with a group (the
    reference's message, before any work), packed attention weights when
    sharding (the reference cannot shard them either)."""
    _, tc, _, _, tq, tp = _model("llama3-8b")
    with pytest.raises(ValueError, match="tp=3 must divide"):
        TEngine(tq, tp, tc, device="cpu", tp=3)
    for fn in (til.int_attn_decode, til.int_attn_prefill_chunk):
        with pytest.raises(ValueError, match="fold_wo cannot cross"):
            fn(None, None, None, None, tp.attn, tc, fold_wo=True,
               tp_group="group")
    packed = pack_tree(tq, "msr4", 32)
    with pytest.raises(ValueError, match="packed.*ROADMAP §3"):
        ttp.shard_qparams(packed, 0, 2)
    with pytest.raises(ValueError, match="packed"):
        til._tp_wo_project(torch.zeros(1, 128, dtype=torch.int8),
                           packed["layers"][0]["attn"]["wo"].map(
                               lambda t: t[0]), tp.attn.out, "group")
