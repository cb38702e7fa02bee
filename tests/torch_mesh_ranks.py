"""Rank bodies of ``test_torch_train_mesh.py``'s gloo worlds (a module
without jax, so each spawned rank imports only torch and the port)."""
import torch

from repro_torch.checkpoint.ckpt import ShardedCheckpointManager
from repro_torch.core.treepath import tree_map
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.world import train_replay
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import make_mesh, set_mesh
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.optim.adamw import AdamWState, moment_specs

AXES = ("data", "model")


def step_case(cfg, params, batch, mesh_shape, opt_cfg, fsdp):
    """One sharded QAT step; the world's metrics and the whole params,
    m and v after it."""
    return train_replay(cfg, params, [batch], mesh_shape=mesh_shape,
                        opt_cfg=opt_cfg, fsdp=fsdp, device="cpu")


def accum_case(cfg, params, batch, mesh_shape, opt_cfg):
    """One float (qat off) step with two microbatches of the rank's
    rows."""
    return train_replay(cfg, params, [batch], mesh_shape=mesh_shape,
                        opt_cfg=opt_cfg, accum_steps=2, qat=False,
                        device="cpu")


def zero1_case(params, grads, opt_cfg, fsdp):
    """``adamw_update`` over a (2, 2) mesh of the rank's blocks of
    ``params`` and of the whole ``grads`` (cut to each moment's ZeRO-1
    slice); the whole params, m, v after it, the grad norm, and each
    leaf's local moment size against its param's whole size."""
    mesh = make_mesh((2, 2), AXES)
    specs = shd.param_pspecs(params, mesh, fsdp=fsdp)
    local = shd.shard_tree(params, specs, mesh)
    mspecs = moment_specs(local, specs, mesh, opt_cfg.zero1)
    g = shd.shard_tree(grads, mspecs, mesh)
    state = adamw_init(local, opt_cfg, specs, mesh)
    sizes = tree_map(lambda m, p: (m.numel(), p.numel()), state.m, params)
    p2, s2, metrics = adamw_update(g, state, local, opt_cfg, specs=specs,
                                   mesh=mesh)
    whole = shd.gather_tree((p2, s2.m, s2.v), (specs, mspecs, mspecs), mesh)
    return {"state": whole, "grad_norm": metrics["grad_norm"],
            "sizes": sizes}


def comm_quant_case(x, cot, scale):
    """``comm_quant_gather`` of the rank's sequence block of ``x`` (B, S,
    D) over a (2, 2) mesh's model lines, and its gradient for the
    cotangent ``cot``: (the gathered value, the block's gradient, the
    dtypes the all-gather put on the wire, the traffic)."""
    mesh = make_mesh((2, 2), AXES)
    seen = []
    orig = sh._ALL_GATHER

    def spy(out, inp, group=None):
        seen.append(str(inp.dtype))
        return orig(out, inp, group=group)

    sh._ALL_GATHER = spy
    sh.reset_traffic()
    try:
        with set_mesh(mesh):
            xb = sh.block(x, 1, "model", mesh).clone().requires_grad_(True)
            out = sh.comm_quant_gather(xb, scale, seq_len=x.shape[1])
            (out * cot).sum().backward()
    finally:
        sh._ALL_GATHER = orig
    return (out.detach(), xb.grad, seen,
            {k: dict(v) for k, v in sh.TRAFFIC.items()})


def checkpoint_case(cfg, params, batch, opt_cfg, directory):
    """One step on a (2, 2) mesh, then a checkpoint of the state at step
    1 through ``ShardedCheckpointManager``; returns the whole state."""
    from repro_torch.launch import steps as steps_mod
    mesh = make_mesh((2, 2), AXES)
    specs = shd.param_pspecs(params, mesh)
    local = shd.shard_tree(params, specs, mesh)
    opt = adamw_init(local, opt_cfg, specs, mesh)
    step = steps_mod.make_train_step(cfg, opt_cfg, device="cpu",
                                     param_specs=specs, mesh=mesh)
    local, opt, _ = step(local, opt, batch)
    mspecs = moment_specs(local, specs, mesh, opt_cfg.zero1)
    state_specs = (specs, AdamWState((), mspecs, mspecs))
    mgr = ShardedCheckpointManager(directory, state_specs, mesh)
    mgr.save(1, (local, opt), extra={"data": {"step": 1}})
    mgr.wait()
    restored, meta = mgr.restore((local, opt))
    same = all(torch.equal(a, b) for a, b in zip(
        _leaves((local, opt)), _leaves(restored)))
    return {"state": shd.gather_tree((local, opt), state_specs, mesh),
            "restored_equal": same, "meta_step": meta["step"]}


def fault_case(cfg, opt_cfg, directory, fail_at):
    """Four QAT steps of ``FaultTolerantLoop`` on a (2, 2) mesh with a
    ``ShardedCheckpointManager`` checkpoint every step, every rank
    raising once before step ``fail_at`` (None: never); the losses and
    the restarts."""
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.distributed.fault import FaultTolerantLoop
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import transformer as tf
    mesh = make_mesh((2, 2), AXES)
    params = tf.init_params(cfg, seed=0, device="cpu")
    specs = shd.param_pspecs(params, mesh)
    local = shd.shard_tree(params, specs, mesh)
    opt = adamw_init(local, opt_cfg, specs, mesh)
    mspecs = moment_specs(local, specs, mesh, opt_cfg.zero1)
    step = steps_mod.make_train_step(cfg, opt_cfg, device="cpu",
                                     param_specs=specs, mesh=mesh)
    failed = []

    def injector(s):
        if s == fail_at and not failed:
            failed.append(s)
            raise RuntimeError("injected failure")

    def step_fn(state, batch):
        p, o, m = step(*state, batch)
        return (p, o), m

    loop = FaultTolerantLoop(
        step_fn, ShardedCheckpointManager(
            directory, (specs, AdamWState((), mspecs, mspecs)), mesh),
        SyntheticLMDataset(cfg.vocab, 64, 4, seed=0), ckpt_every=1,
        fail_injector=injector)
    _, log = loop.run((local, opt), 4)
    return [m["loss"] for m in log], loop.restarts


def _leaves(tree):
    from repro_torch.core.treepath import tree_leaves
    return tree_leaves(tree)
