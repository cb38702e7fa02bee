"""Training driver on one process (twin of ``repro.launch.train``).

Wires the substrates together: config registry -> QAT train step
(``launch.steps.make_train_step``: loss and gradients by
``torch.autograd``, AdamW) -> fault-tolerant loop (async checkpoints,
straggler detection, restart) -> data pipeline.  With ``--int-eval`` the
trained weights are then quantized (``quant.convert.quantize_params``)
and one integer prefill runs through the configured op backend
(``ops.resolve_ops``: the config's ``kernel_backend``, on the card the
kernels K1, K2 and K5).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --reduced --steps 100 --batch 8 --seq 256 [--ckpt-dir DIR] \\
      [--int-eval] [--device cuda]

``--device`` defaults to ``cuda`` and fails without a GPU unless
``--device cpu`` is given.  There is no mesh: the data / model axes, the
parameter sharding rules and ZeRO-1 placement are the multi-card half of
training (ROADMAP §1 item 12), so ``AdamWConfig(zero1=True)`` is a no-op
here, as it is in the reference on one device.  The params are drawn
from seed 0 by the port's own init (not the reference's draws).

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

from repro_torch import kernels
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.data.pipeline import make_train_iterator
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import FaultTolerantLoop, StragglerDetector
from repro_torch.launch import steps as steps_mod
from repro_torch.models import model as M
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedule import linear_warmup_cosine


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
    return ap


def main(argv=None):
    """Train ``--steps`` steps (resuming from ``--ckpt-dir``'s latest
    checkpoint); returns the metrics log of the steps run here (one dict
    of floats a step: loss, ce, aux, grad_norm)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = M.reduce_config(cfg, dtype="float32", vocab=1024)
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"device={dev}")

    data = make_train_iterator(cfg, args.seq, args.batch, path=args.data)
    opt_cfg = AdamWConfig(lr=args.lr, zero1=True)
    lr_fn = linear_warmup_cosine(max(args.steps // 10, 1), args.steps)

    params = tf.init_params(cfg, seed=0, device=dev)
    train_step = steps_mod.make_train_step(cfg, opt_cfg, lr_fn, device=dev)
    opt = adamw_init(params, opt_cfg)

    def step_fn(state, batch):
        params, opt = state
        params, opt, metrics = train_step(params, opt, batch)
        return (params, opt), metrics

    mgr = CheckpointManager(args.ckpt_dir)
    start = mgr.latest_step() or 0
    if start >= args.steps:
        ap.error(f"--ckpt-dir {args.ckpt_dir} holds step {start}, at or "
                 f"past --steps {args.steps}: nothing left to train")
    state = (params, opt)
    if start:
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
    print(f"steps {start} -> {args.steps}: loss {log[0]['loss']:.3f} -> "
          f"{log[-1]['loss']:.3f}  ({tok_s:,.0f} tok/s, "
          f"restarts={loop.restarts}, stragglers={loop.straggler.flagged})")
    if args.int_eval:
        int_eval(state[0], cfg, next(data), dev)
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
