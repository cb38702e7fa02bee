"""Serving driver: random float init -> SwiftTron integer parameters ->
batched INT8 engine on the card, drained with ``run_until_done``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve \
      [--arch h2o-danube-3-4b] [--reduced] [--cache-mode contiguous] \
      --requests 8 --max-new 16 [--device cuda]

The default arch is the reference driver's, sliding-window
h2o-danube-3-4b, which prefills by token streaming in either cache mode.

The model is drawn from a seed and quantized layer by layer on the
device (no weights are downloaded), with the embedding at unit std: the
reference init's ``1/sqrt(V)`` std leaves the full-width integer residual
stream below the RMSNorm pre-shift, so every token would come out 0.
The kernels are built (or loaded) before the timed drain.
``--device`` defaults to ``cuda``
and fails without a GPU unless ``--device cpu`` is given (the plain
versions of every kernel run there).  The asyncio front end of the
reference driver is not ported yet (ROADMAP §1 item 3).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.analysis import contracts
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.ops import available_backends, resolve_ops
from repro_torch.quant import convert
from repro_torch.serving import Request, ServingEngine


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="h2o-danube-3-4b",
                    choices=sorted(n for n, c in ARCHS.items()
                                   if c.is_causal))
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-test size (2 layers, d=128, vocab 1024)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--cache-mode", default="paged",
                    choices=["paged", "contiguous"],
                    help="KV layout: paged pool (memory O(live tokens)) "
                         "or one contiguous slab per lane")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per physical KV page (paged mode)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt tokens per batched prefill step (paged "
                         "mode, full-causal archs; must divide or be a "
                         "multiple of --page-size; 0 = token-streaming "
                         "prefill; default: ~32 where the engine can "
                         "chunk, else streaming)")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="max prompt tokens prefilled per engine step "
                         "(default: unbounded)")
    ap.add_argument("--no-fold-wo", action="store_true",
                    help="keep the o-projection outside the attention "
                         "calls (numerics identical)")
    ap.add_argument("--backend", default=None,
                    help=f"op backend, one of {available_backends()} "
                         "or a JAX backend name (ref, pallas_fused, "
                         "pallas, pallas_tuned: their twins here); "
                         "default: REPRO_BACKEND, else cuda")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    ops = resolve_ops(args.backend, cfg)
    if args.prefill_chunk is not None and args.prefill_chunk > 0 \
            and args.prefill_chunk % args.page_size \
            and args.page_size % args.prefill_chunk:
        ap.error(f"--prefill-chunk {args.prefill_chunk} must divide or be "
                 f"a multiple of --page-size {args.page_size}")
    if args.prefill_budget is not None and args.prefill_budget < 1:
        ap.error("--prefill-budget must be >= 1 token/step")
    prompt_len = 4
    try:
        contracts.require_request(prompt_len, args.max_new,
                                  args.cache_len, window=cfg.window)
    except contracts.RequestInfeasible as e:
        ap.error(str(e))
    dev = resolve_device(args.device)
    if args.reduced:
        cfg = M.reduce_config(cfg, dtype="float32", vocab=1024)
    print(f"quantizing {cfg.name} ({cfg.num_layers} layers, d={cfg.d_model})"
          f" on {dev} ...")
    qp, plans = convert.init_quantized(
        cfg, seed=0, device=dev,
        embed_scale=convert.unit_embed_scale(cfg))
    eng = ServingEngine(qp, plans, cfg, batch_size=args.batch,
                        cache_len=args.cache_len, ops=ops,
                        cache_mode=args.cache_mode, page_size=args.page_size,
                        fold_wo=not args.no_fold_wo,
                        prefill_chunk=args.prefill_chunk,
                        prefill_budget=args.prefill_budget, device=dev)
    print(f"engine: {eng.describe_str()}")
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=[int(t) for t in rng.integers(
        1, cfg.vocab, prompt_len)], max_new_tokens=args.max_new)
        for i in range(args.requests)]
    for r in reqs:
        eng.submit(r)
    if dev.type == "cuda":
        from repro_torch.kernels._build import timed_build
        print(f"kernels ready in {timed_build():.1f}s")
        torch.cuda.synchronize(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    eng.run_until_done()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.out_tokens) for r in reqs)
    distinct = len({t for r in reqs for t in r.out_tokens})
    print(f"served {len(reqs)} requests / {n_tok} tokens ({distinct} "
          f"distinct) in {dt:.2f}s ({n_tok / dt:.1f} tok/s on {dev})")
    print(f"kernel launches: {dict(kernels.LAUNCHES)}")
    for r in reqs[:4]:
        print(f"  req {r.uid}: {r.prompt} -> {r.out_tokens[:10]}...")
    return reqs


if __name__ == "__main__":
    main()
