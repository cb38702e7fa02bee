"""The port's float / QAT training path against the JAX package on the CPU.

Every family in ``ASSIGNED``, reduced (``reduce_config(..., dtype=
"float32")``; jamba at one group of its eight sublayers):
``forward_float``'s logits and ``loss_fn`` with its gradients at
``qat=False`` and ``qat=True``; ``encoder_fwd_float`` (roberta-base,
deit-s); ``mamba_step`` from ``init_mamba_state``; ``apply_rope`` /
``sinusoidal_pos``; ``chunked_ce`` (S not a multiple of the chunk,
labels < 0, the z-loss, never all the logits at once).  The train step,
the optimizer and the substrates are in
``test_torch_train_substrates.py``.

The weights are the port's seeded draws as numpy, carried into the port
by ``interop.params_from_reference`` and into JAX by ``jnp.asarray``;
the batches are numpy from a seed.  Each JAX function is jitted once per
module and compiled without XLA's backend (LLVM) optimisation
(``JIT_OPTS``): its float arithmetic is then the op-by-op arithmetic of
the un-jitted JAX package, which the port follows.  The families'
functions are traced one after another and compiled on a few threads
while the next is traced (the compiles release the interpreter lock).  With the backend
optimisation the reference's own jitted QAT forward differs from its
un-jitted one (reduced llama-3.2-vision-90b: 0.11 in logits of max
3.79), because a fake-quant rounding step flips.

Tolerances (float32): at ``qat=False`` the logits and every gradient
leaf max |Δ| <= 1e-4 max |ref|; at ``qat=True`` the loss |Δ| <= 1e-4
|ref|, the logits and every gradient leaf ||Δ||₂ <= 1e-3 ||ref||₂ (a
rounding tie of a fake quant may flip one grid step).
"""
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import ASSIGNED  # noqa: E402
from repro.configs.registry import get_config as jget  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import mamba as jmb  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.quant import qat as jqat  # noqa: E402

from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.core.treepath import (path_parts,  # noqa: E402
                                       tree_flatten_with_path, tree_map)
from repro_torch.interop import params_from_reference  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import mamba as tmb  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.quant import qat as tqat  # noqa: E402

JIT_OPTS = {"xla_backend_optimization_level": 0}
#: the reduced config's overrides beyond ``reduce_config``'s own
OVERRIDES = {"jamba-v0.1-52b": dict(num_layers=8)}
#: threads compiling the families' JAX functions
COMPILE_THREADS = 3
B, S = 2, 16


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=JIT_OPTS)


def _configs(name, **over):
    over = {**OVERRIDES.get(name, {}), **over}
    return (TM.reduce_config(tget(name), dtype="float32", **over),
            JM.reduce_config(jget(name), dtype="float32", **over))


def _numpy_params(tcfg, seed=1):
    """The port's seeded float draws of ``tcfg``, as numpy."""
    return tree_map(lambda t: t.numpy(),
                    ttf.init_params(tcfg, seed=seed, device="cpu"))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        b["src_embeds"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["img_embeds"] = rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return b


def _key(path):
    return "|".join(path_parts(path))


def _j_flat(tree):
    return {"|".join(str(getattr(e, "key", getattr(e, "idx", getattr(
        e, "name", e)))) for e in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _t_flat(tree):
    return {_key(path): leaf.detach().numpy()
            for path, leaf in tree_flatten_with_path(tree)}


def _max_rel(got, want):
    return float(np.abs(got - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


def _l2_rel(got, want):
    return float(np.linalg.norm((got - want).ravel())) / max(
        float(np.linalg.norm(want.ravel())), 1e-30)


def _reference_runs():
    """Per family: the numpy params and batch, and at qat False and True
    JAX's loss, ce, aux, logits and gradients (numpy) — every family
    traced in turn, compiled on ``COMPILE_THREADS`` threads."""
    inputs, futures = {}, {}
    with ThreadPoolExecutor(COMPILE_THREADS) as pool:
        for name in ASSIGNED:
            tcfg, jcfg = _configs(name)
            npp, b = _numpy_params(tcfg), _batch(tcfg)
            inputs[name] = (npp, b)
            jp = jax.tree.map(jnp.asarray, npp)
            jb = {k: jnp.asarray(v) for k, v in b.items()}
            for q in (False, True):
                def fn(p, bb, q=q, jcfg=jcfg):
                    logits, _ = jtf.forward_float(p, bb, jcfg, qat=q)
                    loss, (ce, aux) = jqat.loss_fn(p, bb, jcfg, qat=q)
                    return loss, (ce, aux, logits)
                lowered = jax.jit(jax.value_and_grad(fn, has_aux=True)) \
                    .lower(jp, jb)

                def run(lowered=lowered, jp=jp, jb=jb):
                    (l, (ce, aux, logits)), g = lowered.compile(
                        compiler_options=JIT_OPTS)(jp, jb)
                    return (float(l), float(ce), float(aux),
                            np.asarray(logits), _j_flat(g))
                futures[name, q] = pool.submit(run)
    return {name: (inputs[name], {q: futures[name, q].result()
                                  for q in (False, True)})
            for name in ASSIGNED}


_RUNS = {}


def _family_run(name):
    """JAX's and the port's logits, loss terms and gradients of reduced
    ``name`` at qat False and True, computed once per module."""
    if "reference" not in _RUNS:
        _RUNS["reference"] = _reference_runs()
    if name in _RUNS:
        return _RUNS[name]
    (npp, b), ref = _RUNS["reference"][name]
    tcfg, _ = _configs(name)
    tp = params_from_reference(npp, device="cpu")
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    out = {}
    for q in (False, True):
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), tp)
        with torch.no_grad():
            tlog, _ = ttf.forward_float(leaves, tb, tcfg, qat=q)
        tl, (tce, taux) = tqat.loss_fn(leaves, tb, tcfg, qat=q)
        paths, flat = zip(*tree_flatten_with_path(leaves))
        grads = torch.autograd.grad(tl, flat)
        out[q] = {"j": ref[q],
                  "t": (tl.item(), tce.item(), taux.item(), tlog.numpy(),
                        {_key(p): g.numpy() for p, g in zip(paths, grads)})}
    _RUNS[name] = out
    return out


@pytest.mark.parametrize("qat", [False, True], ids=["float", "qat"])
@pytest.mark.parametrize("name", ASSIGNED)
def test_forward_float_logits(name, qat):
    r = _family_run(name)[qat]
    want, got = r["j"][3], r["t"][3]
    assert got.shape == want.shape and np.isfinite(got).all()
    if qat:
        assert _l2_rel(got, want) <= 1e-3
    else:
        assert _max_rel(got, want) <= 1e-4


@pytest.mark.parametrize("qat", [False, True], ids=["float", "qat"])
@pytest.mark.parametrize("name", ASSIGNED)
def test_loss_and_gradients(name, qat):
    r = _family_run(name)[qat]
    (jl, jce, jaux, _, jg), (tl, tce, taux, _, tg) = r["j"], r["t"]
    assert abs(tl - jl) <= 1e-4 * abs(jl)
    assert abs(tce - jce) <= 1e-4 * abs(jce)
    assert abs(taux - jaux) <= 1e-4 * max(abs(jaux), 1.0)
    assert sorted(tg) == sorted(jg)
    for key, want in jg.items():
        got = tg[key]
        assert got.shape == want.shape and np.isfinite(got).all(), key
        err = _l2_rel(got, want) if qat else _max_rel(got, want)
        assert err <= (1e-3 if qat else 1e-4), (key, err)


@pytest.mark.parametrize("qat", [False, True], ids=["float", "qat"])
@pytest.mark.parametrize("name", ["roberta-base", "deit-s"])
def test_encoder_fwd_float(name, qat):
    tcfg, jcfg = _configs(name)
    npp = _numpy_params(tcfg)
    emb = np.random.default_rng(3).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    want = np.asarray(_compile(
        lambda p, e: jtf.encoder_fwd_float(p, e, jcfg, qat=qat),
        jax.tree.map(jnp.asarray, npp), jnp.asarray(emb))(
            jax.tree.map(jnp.asarray, npp), jnp.asarray(emb)))
    got = ttf.encoder_fwd_float(params_from_reference(npp, device="cpu"),
                                torch.as_tensor(emb), tcfg, qat=qat)
    assert tcfg.post_norm == (name == "roberta-base")   # post- / pre-LN
    err = _l2_rel(got.numpy(), want) if qat else _max_rel(got.numpy(),
                                                          want)
    assert err <= (1e-3 if qat else 1e-4)


def test_mamba_step_from_init_state():
    """Three float decode steps of a reduced mamba2-130m block from the
    zero state, outputs and states against the reference's."""
    tcfg, jcfg = _configs("mamba2-130m")
    npp = {k: v[0] for k, v in _numpy_params(tcfg)["layers"][0]["ssm"]
           .items()}
    jp = jax.tree.map(jnp.asarray, npp)
    tp = params_from_reference(npp, device="cpu")
    us = np.random.default_rng(4).standard_normal(
        (3, B, tcfg.d_model)).astype(np.float32)
    jstate = jmb.init_mamba_state(jcfg, B)
    tstate = tmb.init_mamba_state(tcfg, B, device="cpu")
    for js, ts in zip(jstate, tstate):
        assert tuple(ts.shape) == js.shape and not ts.any()
    step = _compile(lambda p, u, s: jmb.mamba_step(p, u, s, jcfg), jp,
                    jnp.asarray(us[0]), jstate)
    for u in us:
        jo, jstate = step(jp, jnp.asarray(u), jstate)
        to, tstate = tmb.mamba_step(tp, torch.as_tensor(u), tstate, tcfg)
        assert _max_rel(to.numpy(), np.asarray(jo)) <= 1e-4
        for js, ts in zip(jstate, tstate):
            assert _max_rel(ts.numpy(), np.asarray(js)) <= 1e-4


def test_rope_and_positions():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    for theta in (10000.0, 500000.0):
        want = np.asarray(jcommon.apply_rope(jnp.asarray(x),
                                             jnp.asarray(pos), theta))
        got = tcommon.apply_rope(torch.as_tensor(x), torch.as_tensor(pos),
                                 theta).numpy()
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
        assert np.allclose(tcommon.rope_freqs(32, theta).numpy(),
                           np.asarray(jcommon.rope_freqs(32, theta)),
                           rtol=1e-6, atol=0)
    for seq, d in ((9, 16), (197, 384)):
        want = np.asarray(jcommon.sinusoidal_pos(seq, d))
        got = tcommon.sinusoidal_pos(seq, d).numpy()
        assert got.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-4


def _largest_tensor(fn):
    """The most elements of any tensor an aten op makes while ``fn``
    runs (forward and backward)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        most = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else [out]):
                if isinstance(t, torch.Tensor):
                    Largest.most = max(Largest.most, t.numel())
            return out

    with Largest():
        fn()
    return Largest.most


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_chunked_ce(z_loss):
    """S = 96 over chunks of 64 (so 48), labels < 0 masked: the value and
    the gradients of x and w, and ``cross_entropy`` on whole logits;
    no tensor of B * S * V elements is ever made."""
    tcfg, jcfg = _configs("llama3-8b")
    rng = np.random.default_rng(6)
    b, s, d, v = 2, 96, 32, 64
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = rng.standard_normal((d, v)).astype(np.float32)
    lab = rng.integers(-1, v, (b, s)).astype(np.int32)
    lab[0, :5] = -7
    jfn = jax.value_and_grad(lambda x, w: jqat.chunked_ce(
        x, w, jnp.asarray(lab), jcfg, chunk=64, z_loss=z_loss),
        argnums=(0, 1))
    jv, (jgx, jgw) = _compile(jfn, jnp.asarray(x), jnp.asarray(w))(
        jnp.asarray(x), jnp.asarray(w))
    tx = torch.as_tensor(x).requires_grad_(True)
    tw = torch.as_tensor(w).requires_grad_(True)
    tv = tqat.chunked_ce(tx, tw, torch.as_tensor(lab), tcfg, chunk=64,
                         z_loss=z_loss)
    tgx, tgw = torch.autograd.grad(tv, (tx, tw))
    assert abs(tv.item() - float(jv)) <= 1e-5 * abs(float(jv))
    assert _max_rel(tgx.numpy(), np.asarray(jgx)) <= 1e-4
    assert _max_rel(tgw.numpy(), np.asarray(jgw)) <= 1e-4
    logits = x @ w
    want = float(jqat.cross_entropy(jnp.asarray(logits), jnp.asarray(lab),
                                    v, z_loss=z_loss))
    got = float(tqat.cross_entropy(torch.as_tensor(logits),
                                   torch.as_tensor(lab), v, z_loss=z_loss))
    assert abs(got - want) <= 1e-5 * abs(want)

    def run():
        xx = torch.as_tensor(x).requires_grad_(True)
        loss = tqat.chunked_ce(xx, torch.as_tensor(w),
                               torch.as_tensor(lab), tcfg, chunk=64,
                               z_loss=z_loss)
        loss.backward()
    assert _largest_tensor(run) == b * 48 * v < b * s * v


def test_top_k_ties_take_the_lower_index():
    """The MoE router's top-k orders equal probabilities by index, lower
    first, as ``jax.lax.top_k``."""
    from repro_torch.models.layers import top_k_lowest_index
    rng = np.random.default_rng(8)
    probs = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4
    for k in (1, 2, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = top_k_lowest_index(torch.as_tensor(probs), k)
        assert np.array_equal(ti.numpy(), np.asarray(ji))
        assert np.array_equal(tv.numpy(), np.asarray(jv))
