"""Serving a mixture of experts in the port == the JAX engine, bit for bit:
reduced qwen2-moe-a2.7b and qwen3-moe-235b-a22b through ``ServingEngine``
(token-streaming prefill, as the reference serves MoE) in the paged and
contiguous layouts and with ``spec_k = 3`` (the verify step routes each
row alone), on ``cuda`` (the plain versions on CPU tensors) and
``torch_ref``; and the serve driver with ``--arch qwen2-moe-a2.7b``.

Inputs are numpy draws from fixed seeds.  Tolerance: 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs import registry as j_registry
from repro.models import model as JM
from repro.models import transformer as jtf
from repro.quant import convert as j_convert
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import registry as t_registry
from repro_torch.interop import from_reference
from repro_torch.models import model as TM
from repro_torch.serving import Request as TRequest
from repro_torch.serving import ServingEngine as TEngine

ARCHS = ("qwen2-moe-a2.7b", "qwen3-moe-235b-a22b")
_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        over = dict(dtype="float32", vocab=512)
        jc = JM.reduce_config(j_registry.get_config(arch), **over)
        tc = TM.reduce_config(t_registry.get_config(arch), **over)
        params = jtf.init_params(jax.random.key(3), jc)
        params = {**params, "embed": params["embed"]
                  * np.float32(jc.padded_vocab() ** 0.5)}
        jq, jp = j_convert.quantize_params(params, jc)
        tq, tp = from_reference(jax.tree.map(np.array, jq), jp,
                                device="cpu")
        _MODELS[arch] = (jc, tc, jq, jp, tq, tp)
    return _MODELS[arch]


def _streams(eng, Request, prompts, max_new):
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done for r in reqs)
    return [list(r.out_tokens) for r in reqs]


CASES = [dict(cache_mode="paged"), dict(cache_mode="contiguous"),
         dict(cache_mode="paged", spec_k=3)]


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_reference(arch, kw):
    """Three prompts (one repeating a segment, so the n-gram proposer
    drafts) on two lanes: the port's streams on ``cuda`` and
    ``torch_ref`` equal the JAX engine's; the engine streams its prompts
    and keeps no prefix index."""
    jc, tc, jq, jp, tq, tp = _model(arch)
    rng = np.random.default_rng(8)
    seg = rng.integers(1, jc.vocab, 4).tolist()
    prompts = [rng.integers(1, jc.vocab, 5).tolist(), seg * 3,
               rng.integers(1, jc.vocab, 9).tolist()]
    geom = dict(batch_size=2, cache_len=40, page_size=8, **kw)
    want = _streams(JEngine(jq, jp, jc, ops="ref", **geom), JRequest,
                    prompts, 6)
    assert len({t for s in want for t in s}) > 1
    for backend in ("cuda", "torch_ref"):
        eng = TEngine(tq, tp, tc, ops=backend, device="cpu", **geom)
        d = eng.describe()
        assert d["prefill"]["mode"] == "streaming"
        assert d["cache"].get("prefix") is None
        got = _streams(eng, TRequest, prompts, 6)
        assert got == want, backend
        if kw.get("spec_k"):
            assert eng.describe()["spec"]["drafted"] > 0


def test_moe_engine_refuses_chunked_prefill():
    _, tc, _, _, tq, tp = _model("qwen2-moe-a2.7b")
    with pytest.raises(ValueError, match="MoE"):
        TEngine(tq, tp, tc, batch_size=2, cache_len=32, prefill_chunk=8,
                device="cpu")


def test_serve_cli_runs_qwen2_moe_on_the_cpu():
    from repro_torch.launch import serve
    choices = next(a.choices for a in serve.build_parser()._actions
                   if a.dest == "arch")
    assert set(ARCHS) <= set(choices)
    reqs = serve.main(["--arch", "qwen2-moe-a2.7b", "--reduced",
                       "--requests", "2", "--max-new", "3", "--batch", "2",
                       "--cache-len", "32", "--device", "cpu",
                       "--spec-k", "2"])
    assert len(reqs) == 2 and all(len(r.out_tokens) == 3 for r in reqs)
