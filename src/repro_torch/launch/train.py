"""Training driver (twin of ``repro.launch.train``).

Wires the substrates together: config registry -> a ``(data, model)``
mesh over the world (``choose_mesh``; one process: ``(1, 1)``) -> the
sharded QAT train step (``launch.steps.make_train_step``: the
reference's parameter rules, FSDP above 2e10 params, ZeRO-1 moments,
sequence / tensor parallelism; loss and gradients by ``torch.autograd``)
-> fault-tolerant loop (async checkpoints, straggler detection, restart)
-> data pipeline.  With ``--int-eval`` the trained weights are then
gathered on rank 0, quantized (``quant.convert.quantize_params``) and one
integer prefill runs through the configured op backend
(``ops.resolve_ops``: the config's ``kernel_backend``, on the card the
kernels K1, K2 and K5).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --reduced --steps 100 --batch 8 --seq 256 [--ckpt-dir DIR] \\
      [--int-eval] [--device cuda]
  # a world of ranks, one a process:
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 2 -m repro_torch.launch.train --dist-backend gloo \\
      --arch llama3-8b --reduced ...

``--device`` defaults to ``cuda`` and fails without a GPU unless
``--device cpu`` is given.  A world (``torchrun``'s ``WORLD_SIZE`` > 1,
or a default group already initialised, as ``distributed.world.run_world``
makes) needs ``--dist-backend``: ``nccl`` where each rank has a card of
its own (rank ``LOCAL_RANK`` on ``cuda:LOCAL_RANK``), ``gloo`` where the
ranks share one (NCCL refuses two ranks on one device); the driver never
guesses it.  Every rank builds the same global batch (the reference's
single controller sees one) and takes its rows.  The mesh is in scope
even on one process, so the reference's ``comm_quant_gather`` puts the
attention / FFN inputs on the int8 grid, as the reference's driver does.
The params are drawn from seed 0 by the port's own init (not the
reference's draws).

Checkpoints keep the single-process format (the whole arrays, written by
rank 0; every rank restores its blocks), so a world's checkpoint resumes
in one process, on another mesh or in the JAX package.  The
fault-tolerant loop runs on every rank: a failure raised on every rank
at the same step restores the last checkpoint on every rank; a lone
rank's failure is out of scope (ROADMAP §1 item 12.1b).

A restart from a checkpoint at or past ``--steps`` is refused with an
argparse error (the reference's driver raises ``IndexError`` there,
printing the first loss of an empty log).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch import kernels
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.ckpt import ShardedCheckpointManager
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.data.pipeline import make_train_iterator
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import FaultTolerantLoop, StragglerDetector
from repro_torch.launch import shardings as shd
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import AdamWConfig, AdamWState, moment_specs
from repro_torch.optim.schedule import linear_warmup_cosine


def choose_mesh(n=None):
    """``(n // m, m)`` over ``("data", "model")`` for a world of ``n``
    ranks (default the default group's size; 1 without one), ``m`` the
    largest of 16, 8, 4, 2, 1 that divides ``n``."""
    if n is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
    model = 1
    for m in (16, 8, 4, 2, 1):
        if n % m == 0 and m <= n:
            model = m
            break
    return make_mesh((n // model, model), ("data", "model"))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="llama3-8b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", default=None,
                    help="token file (memory-mapped); default synthetic")
    ap.add_argument("--int-eval", action="store_true",
                    help="after training, quantize and run one integer "
                         "prefill through the configured op backend")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    default=None,
                    help="the backend of a world of ranks (required with "
                         "more than one)")
    return ap


def _join_world(ap, args):
    """(whether this call made the default group, the rank's device)."""
    made = False
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE",
                                                        "1")) > 1:
        if args.dist_backend is None:
            ap.error("a world of ranks needs --dist-backend nccl|gloo")
        dist.init_process_group(args.dist_backend)
        made = True
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world > 1 and args.dist_backend is None:
        ap.error("a world of ranks needs --dist-backend nccl|gloo")
    if world > 1 and args.dist_backend != dist.get_backend():
        ap.error(f"--dist-backend {args.dist_backend}: the default group "
                 f"runs {dist.get_backend()}")
    device = args.device
    if args.dist_backend == "nccl" and device == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    return made, resolve_device(device)


def main(argv=None):
    """Train ``--steps`` steps (resuming from ``--ckpt-dir``'s latest
    checkpoint) on the world's mesh; returns the metrics log of the
    steps run here (one dict of floats a step: loss, ce, aux,
    grad_norm; every rank returns the world's)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    made, dev = _join_world(ap, args)
    try:
        return _train(ap, args, dev)
    finally:
        if made:
            dist.destroy_process_group()


def _train(ap, args, dev):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = M.reduce_config(cfg, dtype="float32", vocab=1024)
    mesh = choose_mesh()
    lead = mesh.rank == 0
    if lead:
        print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
              f"mesh={mesh.shape} device={dev}")

    data = make_train_iterator(cfg, args.seq, args.batch, path=args.data)
    opt_cfg = AdamWConfig(lr=args.lr, zero1=True)
    lr_fn = linear_warmup_cosine(max(args.steps // 10, 1), args.steps)

    params = tf.init_params(cfg, seed=0, device=dev)
    specs = shd.param_pspecs(params, mesh,
                             fsdp=cfg.param_count() > 2e10)
    params = shd.shard_tree(params, specs, mesh)
    train_step = steps_mod.make_train_step(cfg, opt_cfg, lr_fn, device=dev,
                                           param_specs=specs, mesh=mesh)
    opt = adamw_init(params, opt_cfg, specs, mesh)

    def step_fn(state, batch):
        params, opt = state
        params, opt, metrics = train_step(params, opt, batch)
        return (params, opt), metrics

    mspecs = moment_specs(params, specs, mesh, opt_cfg.zero1)
    state_specs = (specs, AdamWState((), mspecs, mspecs))
    mgr = ShardedCheckpointManager(args.ckpt_dir, state_specs, mesh) \
        if mesh.size > 1 else CheckpointManager(args.ckpt_dir)
    start = mgr.latest_step() or 0
    if start >= args.steps:
        ap.error(f"--ckpt-dir {args.ckpt_dir} holds step {start}, at or "
                 f"past --steps {args.steps}: nothing left to train")
    state = (params, opt)
    if start:
        if lead:
            print(f"resuming from step {start}")
        state, meta = mgr.restore(state)
        data.load_state_dict(meta["extra"]["data"])
    loop = FaultTolerantLoop(step_fn, mgr, data,
                             ckpt_every=args.ckpt_every,
                             straggler=StragglerDetector())
    t0 = time.time()
    state, log = loop.run(state, args.steps, start_step=start)
    dt = time.time() - t0
    tok_s = args.batch * args.seq * (args.steps - start) / max(dt, 1e-9)
    if lead:
        print(f"steps {start} -> {args.steps}: loss {log[0]['loss']:.3f} "
              f"-> {log[-1]['loss']:.3f}  ({tok_s:,.0f} tok/s, "
              f"restarts={loop.restarts}, "
              f"stragglers={loop.straggler.flagged})")
    if args.int_eval:
        whole = shd.gather_tree(state[0], specs, mesh)
        if lead:
            int_eval(whole, cfg, next(data), dev)
    return log


def int_eval(params, cfg, batch, dev):
    """Quantize the trained weights and run one integer prefill of
    ``batch``'s tokens through the config's op backend; prints the
    logits' shape and the kernel launches of the prefill (a JSON object
    of the kernels that launched); returns the (B, V) logits."""
    from repro_torch import ops as rops
    from repro_torch.models import inttransformer as it
    from repro_torch.quant import convert
    with torch.no_grad():
        qp, plans = convert.quantize_params(params, cfg)
    ops = rops.resolve_ops(None, cfg)
    if dev.type == "cuda":
        rops.build_kernels()
    kernels.reset_launches()
    logits = it.int_prefill(
        qp, {"tokens": torch.as_tensor(batch["tokens"], device=dev)},
        plans, cfg, ops=ops)
    print(f"int-eval ({ops.name}): logits {tuple(logits.shape)} "
          f"max|.|={float(logits.abs().max()):.2f}")
    print("int-eval launches: " + json.dumps(
        {k: c for k, c in kernels.LAUNCHES.items() if c}))
    return logits


if __name__ == "__main__":
    main()
