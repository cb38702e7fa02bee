"""The port's sharding rules and int8 gather against the JAX package's,
without a world.

* ``launch.shardings.param_pspecs`` (the float and the quantized param
  trees, ``fsdp`` off and on), ``batch_pspecs`` and ``cache_pspecs``
  equal ``repro.launch.shardings``'s, spec for spec, for all 13 configs
  at full size on the meshes (2, 2), (1, 4), (4, 1), (16, 16) and
  (2, 16, 16).  Both run on the reference's ``jax.eval_shape`` trees (no
  arrays) with a stand-in mesh that carries only ``axis_names`` /
  ``axis_sizes``; the port's own float trees have the reference's paths
  and shapes (reduced configs), so the rules apply to them alike.
* ``distributed.sharding.comm_quant_gather`` under a ``(1, 1)`` mesh:
  its values and straight-through gradients equal
  ``repro.distributed.sharding._cq_gather`` on ``tests/test_comm_quant.py``'s
  cases, and it is the identity without a mesh.
* ``launch.mesh``: coordinates, indices and the refusals; ``shard`` /
  ``shard_residual`` / ``local_shard``: the rank's blocks.

The rules and the comm-quant values are exact; the gradients (a sine's
cosine in each library) within 1e-6 relative.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import ARCHS  # noqa: E402
from repro.configs.registry import get_config as jget  # noqa: E402
from repro.distributed.sharding import _cq_gather  # noqa: E402
from repro.launch import shardings as jshd  # noqa: E402
from repro.models import inttransformer as jit_  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.quant import plans as jplans  # noqa: E402

from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.core.treepath import (path_parts,  # noqa: E402
                                       tree_flatten_with_path)
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import shardings as tshd  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

NAMES = sorted(ARCHS)
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True)
class StandIn:
    """What the rule functions read of a mesh."""
    axis_names: tuple
    axis_sizes: tuple


def _mesh(key):
    shape, axes = MESHES[key]
    return StandIn(tuple(axes), tuple(shape))


def _decode_cache_spec(cfg, batch, cache_len, with_mem):
    """The reference's decode caches of ``cfg`` as shapes, the cross
    caches over a memory with ``with_mem`` (as ``repro.launch.dryrun``
    builds them; that module is not imported: it sets ``XLA_FLAGS`` to
    512 host devices for every later test of the process)."""
    plans = jplans.build_layer_plans(cfg)

    def build():
        mem8 = qs = None
        if with_mem:
            n = cfg.n_img_tokens if cfg.family == "vlm" else 4096
            mem8 = jnp.zeros((batch, n, cfg.d_model), jnp.int8)
            qs = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                              JM.qparams_spec(cfg, plans))
        return jit_.init_decode_cache(cfg, batch, cache_len, mem8, qs,
                                      plans)
    return jax.eval_shape(build)


@functools.lru_cache(maxsize=None)
def _trees(name):
    """The reference's float and quantized param trees and its decode
    cache tree (with the memory for the cross-attention families) of
    ``name`` at full size, as shapes."""
    cfg = jget(name)
    plans = jplans.build_layer_plans(cfg)
    with_mem = cfg.family in ("vlm", "encdec")
    return (JM.params_spec(cfg), JM.qparams_spec(cfg, plans),
            _decode_cache_spec(cfg, 8, 1024, with_mem))


def _norm(entry):
    """A reference spec entry as the port writes it."""
    if isinstance(entry, tuple) and len(entry) == 0:
        return None
    return entry


def _j_specs(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(e, "key", getattr(e, "idx", getattr(
        e, "name", e)))) for e in p): tuple(_norm(x) for x in s)
        for p, s in leaves}


def _t_specs(tree):
    return {"/".join(path_parts(p)): s for p, s in tree_flatten_with_path(
        tree, is_leaf=tsh._is_spec)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_param_pspecs_equal_the_reference(name, mesh):
    fp, qp, _ = _trees(name)
    m = _mesh(mesh)
    for tree in (fp, qp):
        for fsdp in (False, True):
            want = _j_specs(jshd.param_pspecs(tree, m, fsdp=fsdp))
            got = _t_specs(tshd.param_pspecs(tree, m, fsdp=fsdp))
            assert got == want, (name, mesh, fsdp)
    # FSDP moves some leaf of every config above 2e10 params onto data;
    # no rule or FSDP choice shards a stack's layer-group dim, which the
    # layer loop indexes (``transformer._group_specs``)
    got = _t_specs(tshd.param_pspecs(fp, m, fsdp=True))
    if tget(name).param_count() > 2e10 and m.axis_sizes[-2] > 1:
        assert any("data" in str(s) for s in got.values())
    assert all(s[0] is None for k, s in got.items()
               if k.split("/")[0] in ("layers", "enc_layers"))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_batch_and_cache_pspecs_equal_the_reference(name, mesh):
    cfg, m = jget(name), _mesh(mesh)
    _, _, cache = _trees(name)
    assert _t_specs(tshd.cache_pspecs(cache, m, tget(name))) \
        == _j_specs(jshd.cache_pspecs(cache, m, cfg))
    for b in (1, 4, 64, 512):
        batch = {"tokens": jax.ShapeDtypeStruct((b, 256), jnp.int32),
                 "labels": jax.ShapeDtypeStruct((b, 256), jnp.int32),
                 "pos": jax.ShapeDtypeStruct((b,), jnp.int32),
                 "scalar": jax.ShapeDtypeStruct((), jnp.int32)}
        if cfg.family == "vlm":
            batch["img_embeds"] = jax.ShapeDtypeStruct(
                (b, cfg.n_img_tokens, cfg.d_model), jnp.float32)
        assert _t_specs(tshd.batch_pspecs(batch, m)) \
            == _j_specs(jshd.batch_pspecs(batch, m)), b


@pytest.mark.parametrize("name", NAMES)
def test_port_float_tree_has_the_reference_paths(name):
    """The port's float params (reduced) have the reference's paths and
    shapes, so the rules above apply to the port's own trees."""
    tcfg = TM.reduce_config(tget(name), dtype="float32")
    jcfg = JM.reduce_config(jget(name), dtype="float32")
    port = {"/".join(path_parts(p)): tuple(x.shape) for p, x in
            tree_flatten_with_path(ttf.init_params(tcfg, device="cpu"))}
    ref = {"/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                    for e in p): tuple(x.shape)
           for p, x in jax.tree_util.tree_flatten_with_path(
               JM.params_spec(jcfg))[0]}
    assert port == ref


# ------------------------------------------------------------ comm quant --

CQ_CASES = {
    "forward": np.asarray([0.03, -0.51, 7.99, -8.2], np.float32),
    "linspace": np.linspace(-4.0, 4.0, 16).astype(np.float32),
    "ties": (np.arange(-20, 21, dtype=np.float32) + 0.5) * (8.0 / 127.0),
    "clip": np.asarray([-9.0, -8.0, 8.0, 9.0, 0.0], np.float32),
}


def _cq(x, scale):
    """The port's comm_quant_gather of ``x`` on a (1, 1) mesh."""
    with tmesh.set_mesh(tmesh.make_mesh((1, 1), ("data", "model"))):
        return tsh.comm_quant_gather(x, scale, enabled=True)


@pytest.mark.parametrize("case", sorted(CQ_CASES))
def test_comm_quant_values_equal_the_reference(case):
    x, s = CQ_CASES[case], 8.0 / 127.0
    want = np.asarray(_cq_gather(jnp.asarray(x), s))
    got = _cq(torch.as_tensor(x), s).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(CQ_CASES))
def test_comm_quant_gradient_is_straight_through(case):
    x, s = CQ_CASES[case], 8.0 / 127.0
    want = np.asarray(jax.grad(
        lambda v: jnp.sum(jnp.sin(_cq_gather(v, s))))(jnp.asarray(x)))
    t = torch.as_tensor(x).requires_grad_(True)
    torch.sum(torch.sin(_cq(t, s))).backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-6, atol=1e-7)


def test_comm_quant_is_the_identity_without_a_mesh():
    x = torch.ones((4, 8)) * 0.013
    assert tsh.comm_quant_gather(x, 0.1, enabled=True) is x
    with tmesh.set_mesh(tmesh.make_mesh((1, 1), ("data", "model"))):
        assert tsh.comm_quant_gather(x, 0.1, enabled=False) is x
        assert float(tsh.comm_quant_gather(x, 0.1).max()) == 0.0


# ------------------------------------------------------------------ mesh --

def test_mesh_coordinates_and_indices():
    m = tmesh.Mesh((2, 16, 16), ("pod", "data", "model"), rank=300)
    assert m.coords == {"pod": 1, "data": 2, "model": 12}
    assert m.index(("data", "model")) == 2 * 16 + 12
    assert m.index(("model", "data")) == 12 * 16 + 2
    assert tmesh.data_axes(m) == ("pod", "data") and tmesh.model_size(m) == 16


def test_mesh_refusals_and_scope():
    with pytest.raises(ValueError, match="needs a world of 4"):
        tmesh.make_mesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="needs a world of 256"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="needs a world of 512"):
        tmesh.make_production_mesh(multi_pod=True)
    one = tmesh.make_mesh((1, 1), ("data", "model"))
    assert tsh.current_axes() == ()
    with tmesh.set_mesh(one):
        assert tsh.current_axes() == ("data", "model")
        assert tsh.pspec("batch", "seq_sharded", "embed") == (
            "data", "model", None)
        with tmesh.set_mesh(None):
            assert tsh.current_axes() == ()
    assert tmesh.current_mesh() is None


def test_local_shard_inverts_the_block_layout():
    """``local_shard`` of every rank of a (2, 2) mesh tiles the whole
    tensor (a tuple entry: the first axis major), as ``gather_full``
    reassembles it."""
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    spec = (("model", "data"), None)
    blocks = [tshd.local_shard(x, spec, tmesh.Mesh((2, 2), ("data", "model"),
                                                    rank=r))
              for r in range(4)]
    # rank r = data * 2 + model; block index = model * 2 + data
    order = [blocks[0], blocks[2], blocks[1], blocks[3]]
    assert torch.equal(torch.cat(order, dim=0), x)
    spec = ("data", "model")
    assert tshd.local_shard(x, spec, tmesh.Mesh(
        (2, 2), ("data", "model"), rank=1)).tolist() == x[:4, 6:].tolist()
    assert tshd.global_shape((4, 6), spec, tmesh.Mesh(
        (2, 2), ("data", "model"))) == (8, 12)


def test_shard_and_shard_residual_take_the_rank_block():
    """``shard`` / ``shard_residual`` slice (never a collective): rank 3
    of a (2, 2) mesh holds data 1, model 1; the residual's sequence
    shards only where it divides and holds 16 positions a rank."""
    x = torch.arange(4 * 64 * 8, dtype=torch.float32).reshape(4, 64, 8)
    with tmesh.set_mesh(tmesh.Mesh((2, 2), ("data", "model"), rank=3)):
        assert torch.equal(tsh.shard(x, "batch", "seq_sharded", "embed"),
                           x[2:, 32:])
        assert torch.equal(tsh.shard_residual(x), x[:, 32:])
        assert tsh.shard_residual(x[:, :30]).shape[1] == 30
        assert tsh.shard_residual(x[:, :32]).shape[1] == 16
        assert not tsh.residual_seq_sharded(30)
        assert not tsh.residual_seq_sharded(16)
    assert tsh.shard(x, "batch") is x and tsh.shard_residual(x) is x
