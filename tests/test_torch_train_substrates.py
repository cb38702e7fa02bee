"""The port's training substrates against the JAX package on the CPU.

``make_train_step`` (3 QAT steps of reduced llama3-8b, ``accum_steps`` 1
and 2), ``adamw_update`` on identical grads (f32 / bf16 moments, the clip
on / off), the three schedules, the data pipeline (bit-identical
batches, ``state_dict`` resume, host sharding, ``TokenFileDataset``),
key paths, checkpoints written by either package and read by the other
(retention, a shape mismatch, a missing leaf, bfloat16 leaves),
``FaultTolerantLoop`` / ``StragglerDetector`` / ``ElasticMesh``,
``calibrate_ranges`` on more than 2^24 elements, and
``launch.train.main`` on the CPU (a run, its resume, the refusal).

Tolerances: train steps the loss (and ce, aux, grad norm) within 1e-4
relative at every step, params and moments ||Δ||₂ <= 1e-3 ||ref||₂ per
leaf; ``adamw_update`` max |Δ| <= 1e-6 max |ref| per leaf; schedules
1e-6; data and checkpoints exact.  The JAX train step is jitted without
XLA's backend optimisation, as in ``test_torch_train.py``.
"""
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs.registry import get_config as jget  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.distributed import fault as jfault  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro.quant import calibrate as jcal  # noqa: E402

from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.core.treepath import (path_parts,  # noqa: E402
                                       tree_flatten_with_path, tree_map)
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.distributed import fault as tfault  # noqa: E402
from repro_torch.interop import params_from_reference  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedule as tsched  # noqa: E402
from repro_torch.quant import calibrate as tcal  # noqa: E402

JIT_OPTS = {"xla_backend_optimization_level": 0}


def _configs(name):
    return (TM.reduce_config(tget(name), dtype="float32"),
            JM.reduce_config(jget(name), dtype="float32"))


def _j_flat(tree):
    return {"|".join(str(getattr(e, "key", getattr(e, "idx", getattr(
        e, "name", e)))) for e in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _t_flat(tree):
    return {"|".join(path_parts(path)): leaf.detach().float().numpy()
            if leaf.dtype == torch.bfloat16 else leaf.detach().numpy()
            for path, leaf in tree_flatten_with_path(tree)}


def _l2_rel(got, want):
    return float(np.linalg.norm((got - want).ravel())) / max(
        float(np.linalg.norm(want.ravel())), 1e-30)


def _max_rel(got, want):
    return float(np.abs(got - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


# ----------------------------------------------------------- train step ---

@pytest.mark.parametrize("accum", [1, 2])
def test_make_train_step(accum):
    """Three QAT steps of reduced llama3-8b under
    ``linear_warmup_cosine(1, 3)`` (the first update is zero) at the
    driver's lr 1e-3 on the synthetic language, B 4 x S 16.  (Adam's
    first steps normalise each gradient element, so a float rounding
    difference in a near-zero gradient becomes up to a whole ``lr``
    step: the loss difference after a step scales with the lr.)"""
    tcfg, jcfg = _configs("llama3-8b")
    npp = tree_map(lambda t: t.numpy(),
                   ttf.init_params(tcfg, seed=2, device="cpu"))
    jp = jax.tree.map(jnp.asarray, npp)
    tp = params_from_reference(npp, device="cpu")
    jcfg_o, tcfg_o = jadamw.AdamWConfig(lr=1e-3), tadamw.AdamWConfig(lr=1e-3)
    jopt, topt = jadamw.adamw_init(jp, jcfg_o), tadamw.adamw_init(tp, tcfg_o)
    jstep = jsteps.make_train_step(jcfg, jcfg_o,
                                   jsched.linear_warmup_cosine(1, 3),
                                   accum_steps=accum)
    tstep = tsteps.make_train_step(tcfg, tcfg_o,
                                   tsched.linear_warmup_cosine(1, 3),
                                   accum_steps=accum, device="cpu")
    data = tdata.SyntheticLMDataset(tcfg.vocab, 16, 4, seed=3)
    batches = [next(data) for _ in range(3)]
    jfn = jax.jit(jstep).lower(
        jp, jopt, jax.tree.map(jnp.asarray, batches[0])).compile(
            compiler_options=JIT_OPTS)
    for i, batch in enumerate(batches):
        jp, jopt, jm = jfn(jp, jopt, jax.tree.map(jnp.asarray, batch))
        tp, topt, tm = tstep(tp, topt, batch)
        for k in ("loss", "ce", "aux", "grad_norm"):
            want = float(jm[k])
            assert abs(float(tm[k]) - want) <= 1e-4 * max(abs(want),
                                                          1e-3), (i, k)
        assert topt.step.dtype == torch.int32
        assert int(topt.step) == int(jopt.step) == i + 1
        if i == 0:      # the warm-up's zero step moves no param
            for key, v in _t_flat(tp).items():
                assert np.array_equal(v, _j_flat(npp)[key]), key
    jflat, tflat = _j_flat(jp), _t_flat(tp)
    assert sorted(jflat) == sorted(tflat)
    for key, want in jflat.items():
        assert _l2_rel(tflat[key], want) <= 1e-3, key
    for jt, tt in ((jopt.m, topt.m), (jopt.v, topt.v)):
        assert sorted(_j_flat(jt)) == sorted(_t_flat(tt))


# ---------------------------------------------------------------- optim ---

def _tree(rng, scale=1.0):
    return {"embed": rng.standard_normal((16, 8)).astype(np.float32) * scale,
            "layers": [{"w": rng.standard_normal((3, 8, 4)).astype(
                np.float32) * scale,
                "gamma": rng.standard_normal((3, 8)).astype(np.float32)
                * scale}]}


@pytest.mark.parametrize("clip", [0.0, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update(moments, clip):
    """Four updates of identical grads (the clip active at 0.5: the grad
    norm is ~10), lr scales from a schedule, every leaf and the grad
    norm."""
    rng = np.random.default_rng(7)
    params, grads = _tree(rng), [_tree(rng, 0.7) for _ in range(4)]
    jc = jadamw.AdamWConfig(lr=3e-2, clip_norm=clip, moment_dtype=moments)
    tc = tadamw.AdamWConfig(lr=3e-2, clip_norm=clip, moment_dtype=moments)
    jp, tp = jax.tree.map(jnp.asarray, params), params_from_reference(
        params, device="cpu")
    js, ts = jadamw.adamw_init(jp, jc), tadamw.adamw_init(tp, tc)
    assert ts.step.shape == () and ts.step.dtype == torch.int32
    jfn, tfn = jsched.cosine_schedule(4), tsched.cosine_schedule(4)
    for g in grads:
        jp, js, jm = jadamw.adamw_update(
            jax.tree.map(jnp.asarray, g), js, jp, jc, lr_scale=jfn(js.step))
        tp, ts, tm = tadamw.adamw_update(
            params_from_reference(g, device="cpu"), ts, tp, tc,
            lr_scale=tfn(ts.step))
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
        for jt, tt in ((jp, tp), (js.m, ts.m), (js.v, ts.v)):
            jflat, tflat = _j_flat(jt), _t_flat(tt)
            for key, want in jflat.items():
                want = want.astype(np.float32)
                assert _max_rel(tflat[key], want) <= 1e-6, key
    assert int(ts.step) == 4
    assert all(leaf.dtype == getattr(torch, moments)
               for _, leaf in tree_flatten_with_path(ts.m))
    want = float(jadamw.global_norm(jax.tree.map(jnp.asarray, grads[0])))
    got = float(tadamw.global_norm(params_from_reference(grads[0],
                                                         device="cpu")))
    assert abs(got - want) <= 1e-6 * want


def test_schedules():
    steps = np.arange(0, 40, dtype=np.int32)
    pairs = [(jsched.constant_schedule(0.3), tsched.constant_schedule(0.3)),
             (jsched.cosine_schedule(25, 0.2), tsched.cosine_schedule(25,
                                                                      0.2)),
             (jsched.linear_warmup_cosine(5, 30),
              tsched.linear_warmup_cosine(5, 30))]
    for jfn, tfn in pairs:
        for s in steps:
            want = float(jfn(jnp.asarray(s)))
            got = tfn(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32 and got.shape == ()
            assert abs(float(got) - want) <= 1e-6, (s, want)
    warm = tsched.linear_warmup_cosine(1, 8)
    assert float(warm(torch.tensor(0))) == 0.0
    assert float(warm(torch.tensor(1))) == 1.0


# ----------------------------------------------------------------- data ---

def test_synthetic_batches_bit_identical_and_resumable():
    for host in (0, 1):
        j = jdata.SyntheticLMDataset(512, 24, 3, seed=11, host_id=host,
                                     n_hosts=2)
        t = tdata.SyntheticLMDataset(512, 24, 3, seed=11, host_id=host,
                                     n_hosts=2)
        for _ in range(3):
            a, b = next(j), next(t)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype == np.int32
                assert np.array_equal(a[k], b[k])
        assert t.state_dict() == j.state_dict()
    h0 = next(tdata.SyntheticLMDataset(512, 24, 3, seed=11, host_id=0))
    h1 = next(tdata.SyntheticLMDataset(512, 24, 3, seed=11, host_id=1))
    assert not np.array_equal(h0["tokens"], h1["tokens"])
    t = tdata.SyntheticLMDataset(512, 24, 3, seed=11)
    next(t)
    st = t.state_dict()
    want = next(t)
    r = tdata.SyntheticLMDataset(512, 24, 3, seed=11)
    r.load_state_dict(st)
    assert np.array_equal(next(r)["tokens"], want["tokens"])
    assert (want["labels"][:, :-1] == want["tokens"][:, 1:]).all()


def test_token_file_dataset_and_iterator(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(5).integers(0, 60000, 3000).astype(
        np.uint16).tofile(path)
    for host in (0, 1):
        j = jdata.TokenFileDataset(path, 17, 4, host_id=host, n_hosts=2)
        t = tdata.TokenFileDataset(path, 17, 4, host_id=host, n_hosts=2)
        for _ in range(25):                 # wraps around the file
            a, b = next(j), next(t)
            assert np.array_equal(a["tokens"], b["tokens"])
            assert np.array_equal(a["labels"], b["labels"])
        assert t.state_dict() == j.state_dict()
    tcfg, jcfg = _configs("llama3-8b")
    for kw in ({"path": path}, {"seed": 4}):
        a = next(jdata.make_train_iterator(jcfg, 16, 2, **kw))
        b = next(tdata.make_train_iterator(tcfg, 16, 2, **kw))
        assert np.array_equal(a["tokens"], b["tokens"])


# ------------------------------------------------------- key paths / ckpt -

def _state(seed=0, bf16=False):
    """A train state ``(params, AdamWState)`` as the reference holds it
    (numpy leaves; ``bf16``: the params in bfloat16)."""
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    if bf16:
        params = jax.tree.map(
            lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), params)
    opt = jadamw.adamw_init(jax.tree.map(jnp.asarray, params),
                            jadamw.AdamWConfig())
    opt = jadamw.AdamWState(np.asarray(3, np.int32),
                            jax.tree.map(lambda a: np.asarray(a) + 1, opt.m),
                            jax.tree.map(np.asarray, opt.v))
    return (params, opt)


def test_path_parts_equal_the_reference():
    state = _state()
    jpaths = sorted(_j_flat(state))
    tpaths = sorted("|".join(path_parts(p)) for p, _ in
                    tree_flatten_with_path(params_from_reference(
                        state, device="cpu")))
    assert jpaths == tpaths
    assert "1|step" in tpaths and "0|layers|0|w" in tpaths


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_checkpoints_cross_packages(tmp_path, bf16):
    state = _state(bf16=bf16)
    tstate = params_from_reference(state, device="cpu")
    assert isinstance(tstate[1], tadamw.AdamWState)
    assert tstate[1].step.dtype == torch.int32 and tstate[1].step.dim() == 0
    # JAX writes, the port reads (a port template of zeros)
    jckpt.save_checkpoint(str(tmp_path / "j"), 7, state, extra={"k": 1})
    tmpl = tree_map(torch.zeros_like, tstate)
    got, meta = tckpt.load_checkpoint(str(tmp_path / "j"), tmpl)
    assert meta["step"] == 7 and meta["extra"] == {"k": 1}
    for (p, a), (_, b) in zip(tree_flatten_with_path(got),
                              tree_flatten_with_path(tstate)):
        assert a.dtype == b.dtype and torch.equal(a, b), path_parts(p)
    # the port writes, JAX reads
    tckpt.save_checkpoint(str(tmp_path / "t"), 9, tstate, extra={"k": 2})
    back, meta = jckpt.load_checkpoint(str(tmp_path / "t"), state)
    assert meta["step"] == 9 and meta["n_leaves"] == len(_j_flat(state))
    for key, want in _j_flat(state).items():
        have = _j_flat(back)[key]
        assert have.dtype.itemsize == want.dtype.itemsize
        assert have.tobytes() == want.tobytes(), key
    with np.load(str(tmp_path / "t" / "step_000000000009" /
                     "arrays.npz")) as tz, \
            np.load(str(tmp_path / "j" / "step_000000000007" /
                         "arrays.npz")) as jz:
        assert sorted(tz.files) == sorted(jz.files)
        assert all(tz[k].dtype == jz[k].dtype for k in tz.files)


def test_checkpoint_manager_retention_and_refusals(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.ones(4), "layers": [{"b": torch.arange(3)}]}
    for s in (1, 2, 3):
        mgr.save(s, tree, extra={"s": s})
    mgr.wait()
    assert mgr.latest_step() == tckpt.latest_step(str(tmp_path)) == 3
    assert sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("step_")) == ["step_000000000002",
                                                "step_000000000003"]
    got, meta = mgr.restore(tree)
    assert meta["extra"] == {"s": 3} and torch.equal(got["w"], tree["w"])
    with pytest.raises(ValueError, match="shape mismatch for w"):
        tckpt.load_checkpoint(str(tmp_path), {**tree, "w": torch.ones(5)})
    with pytest.raises(KeyError, match="missing leaf extra"):
        tckpt.load_checkpoint(str(tmp_path), {**tree,
                                              "extra": torch.ones(1)})
    with pytest.raises(FileNotFoundError):
        tckpt.load_checkpoint(str(tmp_path / "none"), tree)


# ---------------------------------------------------------------- fault ---

def _run_loop(pkg, ckpt_pkg, tmp, fail_at, n_steps=8):
    """The reference's test loop in either package: ``w += 1`` a step,
    the loss the batch's mean token; the injector fails once at step
    ``fail_at`` (None: never)."""
    data = (jdata if pkg is jfault else tdata).SyntheticLMDataset(
        64, 8, 2, seed=0)
    failed = []

    def injector(step):
        if step == fail_at and not failed:
            failed.append(step)
            raise RuntimeError("simulated preemption")

    if pkg is jfault:
        def step_fn(state, batch):
            return ({"w": state["w"] + 1},
                    {"loss": jnp.asarray(batch["tokens"].mean(),
                                         jnp.float32)})
        state = {"w": jnp.zeros(())}
    else:
        def step_fn(state, batch):
            return ({"w": state["w"] + 1},
                    {"loss": torch.as_tensor(batch["tokens"].mean(),
                                             dtype=torch.float32)})
        state = {"w": torch.zeros(())}
    loop = pkg.FaultTolerantLoop(step_fn, ckpt_pkg.CheckpointManager(tmp),
                                 data, ckpt_every=2, fail_injector=injector)
    state, log = loop.run(state, n_steps=n_steps)
    return float(state["w"]), log, loop.restarts


def test_fault_tolerant_loop_recovers_as_the_reference(tmp_path):
    """A failure at step 5 (checkpoints every 2, saved asynchronously:
    step 4's save waited for step 2's, so a checkpoint is on disk when
    the loop looks; both loops look before waiting for the save in
    flight, so a failure right after the first save may find none)."""
    want = _run_loop(jfault, jckpt, str(tmp_path / "j"), fail_at=5)
    got = _run_loop(tfault, tckpt, str(tmp_path / "t"), fail_at=5)
    clean = _run_loop(tfault, tckpt, str(tmp_path / "c"), fail_at=None)
    assert got == want
    assert got[0] == 8.0 and got[2] == 1 and clean[2] == 0
    # restored at step 4, the loop replays step 4's batch: the log is
    # the uninterrupted run's with step 4 twice
    assert got[1][:5] + got[1][6:] == clean[1] and got[1][5] == clean[1][4]


def test_straggler_and_elastic_as_the_reference():
    rng = np.random.default_rng(2)
    times = list(rng.uniform(0.09, 0.11, 30)) + [0.5, 0.1, 0.3, 0.1]
    j, t = jfault.StragglerDetector(20, 2.0), tfault.StragglerDetector(20,
                                                                      2.0)
    assert [j.observe(x) for x in times] == [t.observe(x) for x in times]
    assert t.flagged == j.flagged == 2
    for healthy in (256, 255, 200, 16):
        a = jfault.ElasticMesh(16, 16, 256).replan(healthy)
        b = tfault.ElasticMesh(16, 16, 256).replan(healthy)
        assert (a.data_size, a.dropped_hosts, a.global_batch) == \
            (b.data_size, b.dropped_hosts, b.global_batch)
    with pytest.raises(RuntimeError):
        tfault.ElasticMesh(16, 16, 256).replan(15)


# ------------------------------------------------------------ calibrate ---

def test_calibrate_ranges_past_two_to_the_24():
    """Over |logits| of 2^24 + 4097 elements (``torch.quantile`` refuses
    them) the 99.9th percentile is numpy's linear interpolation, to
    float32 rounding; over batches of 2^20 and 4096 elements it equals
    the reference's ``calibrate_ranges`` (``jnp.percentile``: its sort
    takes ~10 s a batch past 2^24 here, and its index is float32 there,
    a neighbouring order statistic away)."""
    tcfg, jcfg = _configs("llama3-8b")
    rng = np.random.default_rng(9)
    big = [rng.standard_normal((1 << 24) + 4097).astype(np.float32) * 3]
    got = tcal.calibrate_ranges(
        lambda p, b: (torch.as_tensor(b), None), None, big, tcfg)
    exact = float(np.percentile(np.abs(big[0]), 99.9))
    assert abs(got["logits_absmax"] - exact) <= 1e-6 * exact
    small = [rng.standard_normal(k).astype(np.float32) * s
             for k, s in ((4096, 3.0), (1 << 20, 1.0))]
    got = tcal.calibrate_ranges(
        lambda p, b: (torch.as_tensor(b), None), None, small, tcfg)
    want = jcal.calibrate_ranges(
        lambda p, b: (jnp.asarray(b), None), None, small, jcfg)
    assert got.keys() == want.keys() and got["n_batches"] == 2
    assert abs(got["logits_absmax"] - want["logits_absmax"]) <= \
        1e-6 * want["logits_absmax"]
    for k in ("resid_absmax", "s_act8_cover", "s_res_cover"):
        assert got[k] == want[k]
    x = big[0][:4096] * 2
    assert tcal.check_residual_fit(torch.as_tensor(x), tcfg) == \
        jcal.check_residual_fit(jnp.asarray(x), jcfg)


# ---------------------------------------------------------------- driver --

def test_train_main_runs_and_resumes(tmp_path, capsys):
    """6 steps with a checkpoint every 2 and ``--int-eval``; with step 6's
    checkpoint removed, the same command resumes at step 4 and its two
    steps equal the first run's last two; a checkpoint at ``--steps`` is
    refused (the reference's driver fails there printing an empty
    log's first loss)."""
    import shutil
    argv = ["--reduced", "--batch", "2", "--seq", "16", "--ckpt-every",
            "2", "--device", "cpu", "--steps", "6", "--ckpt-dir",
            str(tmp_path)]
    whole = ttrain.main(argv + ["--int-eval"])
    assert len(whole) == 6 and all(np.isfinite(m["loss"]) for m in whole)
    assert "int-eval (cuda_ref): logits (2, 1024)" in capsys.readouterr().out
    assert tckpt.latest_step(str(tmp_path)) == 6
    shutil.rmtree(tmp_path / "step_000000000006")
    resumed = ttrain.main(argv)
    assert "resuming from step 4" in capsys.readouterr().out
    assert resumed == whole[4:]
    with pytest.raises(SystemExit):
        ttrain.main(argv)
    assert "nothing left to train" in capsys.readouterr().err


def test_train_then_serve_from_the_checkpoint(tmp_path, capsys):
    """The serve driver quantizes a training checkpoint's float params
    (``--ckpt-dir``), as the reference's does: train 2 steps of reduced
    llama3-8b, then serve it; the served weights are the checkpoint's."""
    from repro_torch.launch import serve
    from repro_torch.quant import convert
    ttrain.main(["--reduced", "--batch", "2", "--seq", "16", "--steps", "2",
                 "--ckpt-every", "1", "--device", "cpu", "--ckpt-dir",
                 str(tmp_path)])
    reqs = serve.main(["--arch", "llama3-8b", "--reduced", "--requests",
                       "2", "--max-new", "3", "--device", "cpu",
                       "--cache-len", "32", "--ckpt-dir", str(tmp_path)])
    assert "restored step 2 from" in capsys.readouterr().out
    assert all(len(r.out_tokens) == 3 for r in reqs)
    cfg = TM.reduce_config(tget("llama3-8b"), dtype="float32", vocab=1024)
    params = ttf.init_params(cfg, seed=0, device="cpu")
    (trained, _), _ = tckpt.load_checkpoint(str(tmp_path), (params, None))
    assert not torch.equal(trained["lm_head"], params["lm_head"])
    qp, _ = convert.quantize_params(trained, cfg)
    assert qp["head"].w8.dtype == torch.int8
