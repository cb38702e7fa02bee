"""Carry weights, optimizer state and plans from the JAX package into the
port.

:func:`params_from_reference` turns the reference's float params (and
its ``AdamWState``) into the port's trees; :func:`from_reference` turns
the reference's ``(qparams, plans)`` into the port's: arrays (already numpy, e.g. after ``jax.tree.map(np.asarray,
qparams)``) become torch tensors on ``device`` (the card unless the
caller passes ``device="cpu"``, as at every entry point of the port),
and plan objects are read by field name (``_fields`` /
``dataclasses.fields``) into the port's own types of the same name — so
this module, like the rest of the port, imports nothing of the JAX
package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.activations import (IGeluActPlan, ISiluPlan,
                                          ISoftplusPlan)
from repro_torch.core.attention import IAttnPlan
from repro_torch.core.dyadic import Dyadic
from repro_torch.core.intmath import (IErfPlan, IExpPlan, IGeluPlan,
                                      ILn1pPlan, IPoly2Plan)
from repro_torch.core.norms import INormPlan
from repro_torch.core.softmax import ISoftmaxPlan
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.ops.packed import msr4_lanes_distinct
from repro_torch.optim.adamw import AdamWState
from repro_torch.ops.spec import PackMeta, QuantLinearParams
from repro_torch.quant.plans import (AttnPlan, EmbedPlan, FfnPlan, HeadPlan,
                                     LayerPlans, LinearPlan, MambaPlan,
                                     MoePlan)

PLAN_TYPES = {t.__name__: t for t in (
    Dyadic, IExpPlan, IErfPlan, IGeluPlan, IGeluActPlan, ISoftmaxPlan,
    IAttnPlan, INormPlan, ISiluPlan, IPoly2Plan, ILn1pPlan, ISoftplusPlan,
    LinearPlan, AttnPlan, FfnPlan, MoePlan, MambaPlan, EmbedPlan, HeadPlan,
    LayerPlans)}

#: the expert leaves of an MoE subtree: dense int8 only (the reference's
#: ``int_expert_linear`` reads ``w8``)
EXPERT_LEAVES = ("w1", "w2", "w3")


def plan_from_reference(obj):
    """A reference plan (NamedTuple / frozen dataclass / scalar) as the
    port's type of the same class name, field by field."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    name = type(obj).__name__
    if name not in PLAN_TYPES:
        raise NotImplementedError(f"plan type {name} is not ported yet")
    if dataclasses.is_dataclass(obj):
        fields = [f.name for f in dataclasses.fields(obj)]
    else:
        fields = list(obj._fields)
    return PLAN_TYPES[name](**{f: plan_from_reference(getattr(obj, f))
                               for f in fields})


def _tensor(a, device):
    return torch.as_tensor(np.array(a), device=device)


def _pack_meta(meta):
    """The reference's ``PackMeta`` (or None), read by field name."""
    if meta is None:
        return None
    return PackMeta(**{f.name: getattr(meta, f.name)
                       for f in dataclasses.fields(PackMeta)})


def qparams_from_reference(tree, device=DEFAULT_DEVICE):
    """numpy leaves -> tensors on ``device`` (default the card; raises
    without one) of the same dtypes; the reference's ``QuantLinearParams``
    (by name and fields), dense or packed, -> the port's, its
    ``PackMeta`` read field by field.  A packed msr4 leaf whose in-range
    lanes repeat a row within a group of a column raises ``ValueError``
    (``ops.packed.msr4_lanes_distinct``: the correction kernel's
    precondition), checked once per leaf.  Expert leaves (``w1`` / ``w2``
    / ``w3`` of a ``"moe"`` subtree: w8 (..., E, K, N), b_mult (..., E,
    N)) must be dense: a packed one raises ``ValueError``."""
    device = resolve_device(device)
    if tree is None:
        return None
    if type(tree).__name__ == "QuantLinearParams":
        qw = QuantLinearParams(*[
            _pack_meta(getattr(tree, f)) if f == "pack_meta"
            else qparams_from_reference(getattr(tree, f), device)
            for f in QuantLinearParams._fields])
        meta = qw.pack_meta
        if meta is not None and meta.scheme == "msr4" and meta.n_outliers \
                and not msr4_lanes_distinct(qw.out_idx, meta.group):
            raise ValueError(
                "msr4 leaf: within a group, a column's in-range outlier "
                "lanes repeat a row; the correction kernel's dense delta "
                "tile needs distinct rows (pack_msr4 writes them so)")
        return qw
    if isinstance(tree, dict):
        out = {k: qparams_from_reference(v, device)
               for k, v in tree.items()}
        moe = out.get("moe")
        if isinstance(moe, dict) and any(
                isinstance(moe.get(k), QuantLinearParams)
                and moe[k].is_packed for k in EXPERT_LEAVES):
            raise ValueError("packed expert weights are out of scope: the "
                             "reference's int_expert_linear reads dense "
                             "w8 (E, K, N)")
        return out
    if isinstance(tree, (list, tuple)):
        return [qparams_from_reference(v, device) for v in tree]
    return _tensor(tree, device)


def from_reference(qparams, plans, device=DEFAULT_DEVICE):
    """``(qparams, plans)`` of the JAX package -> the port's."""
    return (qparams_from_reference(qparams, device),
            plan_from_reference(plans))


#: the reference's NamedTuples of float training state, by class name
STATE_TYPES = {"AdamWState": AdamWState}


def _float_leaf(a, device):
    """A numpy array (a bfloat16 one too: ``ml_dtypes``' or the
    checkpoint's ``|V2`` bytes) as a tensor of the same dtype, bit for
    bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a), device=device)


def params_from_reference(tree, device=DEFAULT_DEVICE):
    """The reference's float params or training state (numpy leaves,
    e.g. after ``jax.tree.map(np.asarray, params)``) -> the port's tree
    of tensors on ``device`` (default the card; raises without one), of
    the same dtypes.  Dicts and lists keep their structure, a tuple stays
    a tuple, and the reference's ``AdamWState`` becomes the port's
    (``optim.AdamWState``: ``step`` a 0-d int32, ``m`` and ``v`` trees of
    the params' structure); ``None`` stays ``None``."""
    device = resolve_device(device)

    def carry(t):
        if t is None:
            return None
        name = type(t).__name__
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            if name not in STATE_TYPES:
                raise NotImplementedError(
                    f"state type {name} has no counterpart in the port")
            return STATE_TYPES[name](*(carry(getattr(t, f))
                                       for f in t._fields))
        if isinstance(t, dict):
            return {k: carry(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(carry(v) for v in t)
        return _float_leaf(t, device)

    return carry(tree)
