"""Port configs, plans and quantization == the JAX reference.

``build_layer_plans`` and ``quantize_params`` of ``repro_torch.quant``
against ``repro.quant`` on the same float params (JAX's init carried
across as numpy), at the serving tests' reduced llama3-8b size; the plans
also at full width (pure Python, no tensors).  Tolerance: 0.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs.registry import get_config as j_get_config
from repro.models import model as JM
from repro.models import transformer as jtf
from repro.quant import convert as j_convert
from repro.quant import plans as j_plans
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.interop import from_reference, plan_from_reference
from repro_torch.models import model as TM
from repro_torch.models import transformer as ttf
from repro_torch.quant import convert as t_convert
from repro_torch.quant import plans as t_plans


def _cfgs(**over):
    return (JM.reduce_config(j_get_config("llama3-8b"), **over),
            TM.reduce_config(t_get_config("llama3-8b"), **over))


def _same_tree(a, b, path="root"):
    """Port tree ``a`` (tensors) equals converted reference tree ``b``."""
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


def test_configs_match_reference():
    jc, tc = j_get_config("llama3-8b"), t_get_config("llama3-8b")
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    jr, tr = _cfgs(dtype="float32", capacity_factor=8.0)
    assert dataclasses.asdict(jr) == dataclasses.asdict(tr)
    assert jtf.layer_group_spec(jr) == ttf.layer_group_spec(tr)


@pytest.mark.parametrize("reduced", [True, False])
def test_build_layer_plans_match(reduced):
    if reduced:
        jc, tc = _cfgs(dtype="float32")
    else:
        jc, tc = j_get_config("llama3-8b"), t_get_config("llama3-8b")
    for calib in (None, {"s_emb": 0.0123}):
        want = plan_from_reference(j_plans.build_layer_plans(jc, calib))
        assert t_plans.build_layer_plans(tc, calib) == want


@pytest.fixture(scope="module")
def float_params():
    jc, tc = _cfgs(dtype="float32", capacity_factor=8.0)
    params = jtf.init_params(jax.random.key(0), jc)
    return jc, tc, params


def test_quantize_params_match(float_params):
    jc, tc, params = float_params
    jq, jp = j_convert.quantize_params(params, jc)
    want_q, want_p = from_reference(jax.tree.map(np.asarray, jq), jp,
                                    device="cpu")
    tparams = jax.tree.map(lambda a: torch.as_tensor(np.array(a)),
                           params)
    got_q, got_p = t_convert.quantize_params(tparams, tc)
    assert got_p == want_p
    _same_tree(got_q, want_q)


def test_layer_by_layer_init_equals_whole_model_quantization():
    """``init_quantized`` (draw + quantize one layer at a time) equals
    ``quantize_params`` of the whole float model from the same seed."""
    _, tc = _cfgs(dtype="float32")
    qa, pa = t_convert.init_quantized(tc, seed=3, device="cpu")
    qb, pb = t_convert.quantize_params(
        ttf.init_params(tc, seed=3, device="cpu"), tc)
    assert pa == pb
    _same_tree(qa, qb)


def test_unported_families_raise():
    """Every family of the reference is ported now: the cross attention
    ones take the self attention's plans as their ``cross`` (the
    reference's ``cross = attn``), the state-space one has no attention,
    and a family the reference does not know raises."""
    for fam, over in (("encdec", dict(enc_layers=2, dec_layers=2)),
                      ("vlm", dict(cross_every=4, n_img_tokens=16))):
        cfg = dataclasses.replace(t_get_config("llama3-8b"), family=fam,
                                  **over)
        got = t_plans.build_layer_plans(cfg)
        assert got.cross == got.attn is not None
        assert got == plan_from_reference(j_plans.build_layer_plans(
            dataclasses.replace(j_get_config("llama3-8b"), family=fam,
                                **over)))
    assert t_plans.build_layer_plans(dataclasses.replace(
        t_get_config("llama3-8b"), family="ssm", ssm_state=16)).attn is None
    with pytest.raises(NotImplementedError, match="no family"):
        t_plans.build_layer_plans(dataclasses.replace(
            t_get_config("llama3-8b"), family="rnn"))