"""Serving driver: random float init -> SwiftTron integer parameters ->
batched INT8 engine on the card behind the asyncio front end.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve \
      [--arch h2o-danube-3-4b] [--reduced] [--cache-mode contiguous] \
      --requests 8 --max-new 16 [--device cuda] [--spec-k 3] \
      [--max-pending 16] [--timeout-s 30] [--arrival-rate 4] [--tp 2] \
      [--ckpt-dir DIR]

Tensor-parallel serving (``--tp N``) shards the attention heads over a
world of N processes, one a rank, each started with this same command
line (``python -m torch.distributed.run --standalone --nproc-per-node N
-m repro_torch.launch.serve --tp N ...``: its ``RANK`` / ``WORLD_SIZE``
environment makes the ``gloo`` group, which takes CUDA tensors and lets
the N ranks share one card).  Every rank draws the same weights and the
same prompts, and rank 0 prints.  The ranks step in lock step, so the
wall-clock options that would make them diverge (``--arrival-rate``,
``--timeout-s``) are refused there.  Started as one process, ``--tp N``
serves through the exact single-device lowering and says so, as the
reference's CLI does without the devices.

Requests flow through :class:`repro_torch.serving.ServingFrontend`: an
open-loop client submits them at ``--arrival-rate`` requests/s (Poisson;
0 = all at once), with backpressure (``--max-pending``) and per-request
deadlines (``--timeout-s``); the summary prints terminal counts, TTFT,
inter-token gap and queue-wait p50 / p99, lane occupancy, the
speculative accept rate and prefix-cache hits.

The default arch is the reference driver's, sliding-window
h2o-danube-3-4b, which prefills by token streaming in either cache mode.

The model is drawn from a seed and quantized layer by layer on the
device (no weights are downloaded), with the embedding at unit std: the
reference init's ``1/sqrt(V)`` std leaves the full-width integer residual
stream below the RMSNorm pre-shift, so every token would come out 0.
The kernels are built (or loaded) before the timed serve.
``--device`` defaults to ``cuda`` and fails without a GPU unless
``--device cpu`` is given (the plain versions of every kernel run
there).  ``--ckpt-dir`` serves the float params of the latest
checkpoint there (as ``repro_torch.launch.train`` or the reference's
driver writes them) instead of a random draw: the whole float model is
drawn, its leaves replaced by the checkpoint's, then quantized with
``quant.convert.quantize_params``.  The cross attention archs
(seamless-m4t-large-v2, llama-3.2-vision-90b) are refused, as the engine
refuses them (``serving.engine.refuse_cross_attention``).
"""
from __future__ import annotations

import argparse
import asyncio
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import kernels
from repro_torch.analysis import contracts
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.device import resolve_device
from repro_torch.distributed import tp_serving
from repro_torch.models import model as M
from repro_torch.models import transformer as tf
from repro_torch.ops import available_backends, build_kernels, resolve_ops
from repro_torch.quant import convert
from repro_torch.serving import QueueFull, ServingEngine, ServingFrontend
from repro_torch.serving.engine import refuse_cross_attention
from repro_torch.serving.speculate import validate_spec


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
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--cache-mode", default="paged",
                    choices=["paged", "contiguous"],
                    help="KV layout: paged pool (memory O(live tokens)) "
                         "or one contiguous slab per lane")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per physical KV page (paged mode)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="physical pool size incl. the null page "
                         "(default: fully provisioned; smaller values "
                         "undersubscribe the pool)")
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
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable cross-session prompt-prefix sharing "
                         "(shared prefixes otherwise map the same "
                         "physical KV pages)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: shard attention heads "
                         "over a world of --tp processes (must divide "
                         "the arch's KV head count); one process serves "
                         "through the exact single-device lowering")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft up to K tokens a "
                         "live lane and verify all K+1 positions in one "
                         "decode-attention call a layer (greedy "
                         "acceptance; streams equal --spec-k 0's); at "
                         "most MAX_SQ - 1; 0 = off")
    ap.add_argument("--spec-mode", default="ngram",
                    help="draft proposer (self-speculative, no draft "
                         "model); 'ngram' = prompt lookup over the "
                         "session's own context")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="admission bound: requests in flight before "
                         "submit() raises QueueFull (default: 4x batch)")
    ap.add_argument("--timeout-s", type=float, default=None,
                    help="per-request deadline in seconds; an expired "
                         "request is evicted (pages reclaimed) and its "
                         "stream ends with terminal state 'timeout'")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="open-loop Poisson arrival rate in requests/s "
                         "(exp-distributed gaps); 0 = submit every "
                         "request up front")
    ap.add_argument("--backend", default=None,
                    help=f"op backend, one of {available_backends()} "
                         "or a JAX backend name (ref, pallas_fused, "
                         "pallas, pallas_tuned: their twins here); "
                         "default: REPRO_BACKEND, else cuda")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the float params of this training "
                         "checkpoint folder's latest step")
    return ap


def _fmt_pct(p) -> str:
    if p is None:
        return "n/a"
    return (f"p50 {p['p50'] * 1e3:.1f}ms / p99 {p['p99'] * 1e3:.1f}ms "
            f"(n={p['n']})")


async def _serve(fe: ServingFrontend, prompts, args) -> list:
    """Open-loop client: submit ``prompts`` at ``--arrival-rate`` req/s
    (exponential gaps; 0 = all at once), drain every stream, return the
    handles (None where admission was refused)."""
    rng = np.random.default_rng(1)
    runner = asyncio.create_task(fe.run())
    handles, drains = [], []
    for prompt in prompts:
        if args.arrival_rate > 0:
            await asyncio.sleep(rng.exponential(1.0 / args.arrival_rate))
        try:
            h = fe.submit(prompt, args.max_new,
                          temperature=args.temperature,
                          deadline_s=args.timeout_s)
        except QueueFull as e:
            print(f"  rejected (queue full, {e.pending} in flight)")
            handles.append(None)
            continue
        handles.append(h)
        drains.append(asyncio.create_task(h.result()))
    await asyncio.gather(*drains)
    fe.close()
    await runner
    return handles


def _check_args(ap, args, cfg) -> None:
    """The flags' coherence, checked before the (slow) quantization, as
    argparse errors; the engine's refusal of the cross attention archs
    too."""
    try:
        refuse_cross_attention(cfg)
    except ValueError as e:
        ap.error(f"--arch {args.arch}: {e}")
    if args.prefill_chunk is not None and args.prefill_chunk > 0:
        if args.cache_mode != "paged":
            ap.error("--prefill-chunk needs --cache-mode paged (chunked "
                     "prefill writes K/V through the page table)")
        if args.prefill_chunk % args.page_size \
                and args.page_size % args.prefill_chunk:
            ap.error(f"--prefill-chunk {args.prefill_chunk} must divide "
                     f"or be a multiple of --page-size {args.page_size}")
    if args.prefill_budget is not None and args.prefill_budget < 1:
        ap.error("--prefill-budget must be >= 1 token/step")
    if args.num_pages is not None and args.num_pages < 2:
        ap.error("--num-pages must be >= 2 (page 0 is the null page)")
    if args.max_pending is not None and args.max_pending < 1:
        ap.error("--max-pending must be >= 1 request")
    if args.timeout_s is not None and args.timeout_s <= 0:
        ap.error("--timeout-s must be > 0 seconds")
    if args.arrival_rate < 0:
        ap.error("--arrival-rate must be >= 0 requests/s")
    if args.spec_k:
        if args.temperature > 0:
            ap.error("--spec-k needs --temperature 0: greedy longest-"
                     "prefix acceptance is exact only against the argmax "
                     "stream; a sampled stream would silently diverge")
        try:
            validate_spec(cfg, args.spec_k, args.spec_mode)
        except ValueError as e:
            ap.error(f"--spec-k {args.spec_k}: {e}")


#: the length of every random prompt this command serves
PROMPT_LEN = 4


def _tp_world(ap, args):
    """``(sharded, made)``: whether this process is a rank of a world of
    ``--tp`` processes (an initialized default group of that size, or
    the ``RANK`` / ``WORLD_SIZE`` environment a launcher such as
    ``torchrun`` sets, from which the ``gloo`` group is made here), and
    whether the group was made here (``main`` then destroys it).  A world
    of more than one process and another size than ``--tp`` is refused:
    each process would serve alone and print the same output.  In a
    world the wall-clock options are refused: the ranks must admit and
    step alike."""
    world = tp_serving.tp_group_size(None)
    made = False
    if not world and "RANK" in os.environ:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        made = world > 1
    if world > 1 and world != args.tp:
        ap.error(f"--tp {args.tp} in a world of {world} processes: start "
                 f"{args.tp} processes for --tp {args.tp}, or one")
    if world != args.tp or args.tp == 1:
        return False, False
    if args.arrival_rate > 0 or args.timeout_s is not None:
        ap.error("--tp across processes needs --arrival-rate 0 and no "
                 "--timeout-s: the ranks admit and step in lock step, and "
                 "wall-clock arrivals or deadlines would differ between "
                 "them")
    if made:
        dist.init_process_group("gloo")
    return True, made


def main(argv=None):
    """Serve ``--requests`` random prompts through the front end; returns
    the requests that were admitted."""
    ap = build_parser()
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    ops = resolve_ops(args.backend, cfg)
    try:
        contracts.require_request(PROMPT_LEN, args.max_new,
                                  args.cache_len, window=cfg.window)
    except contracts.RequestInfeasible as e:
        ap.error(f"--max-new {args.max_new} with --cache-len "
                 f"{args.cache_len}: {e}")
    if args.reduced:
        cfg = M.reduce_config(cfg, dtype="float32", vocab=1024)
    # --tp validates against the final config (--reduced shrinks heads)
    try:
        tp_serving.validate_tp(cfg, args.tp)
    except ValueError as e:
        ap.error(f"--tp {args.tp}: {e}")
    _check_args(ap, args, cfg)
    sharded, made = _tp_world(ap, args)
    try:
        return _serve_main(args, cfg, ops, sharded)
    finally:
        if made:
            dist.destroy_process_group()


def _serve_main(args, cfg, ops, sharded: bool):
    """``main`` past its checks: quantize, build the engine, serve."""
    # in a world, rank 0 prints alone
    say = print if not sharded or dist.get_rank() == 0 \
        else (lambda *a, **k: None)
    if args.tp > 1 and not sharded:
        say(f"--tp {args.tp}: this process is not one of a world of "
            f"{args.tp} ranks; serving through the exact single-device "
            "lowering (gathered mode)")
    dev = resolve_device(args.device)
    say(f"quantizing {cfg.name} ({cfg.num_layers} layers, d={cfg.d_model})"
        f" on {dev} ...")
    if args.ckpt_dir:
        params = tf.init_params(cfg, seed=0, device=dev)
        (params, _), meta = load_checkpoint(args.ckpt_dir, (params, None))
        say(f"restored step {meta['step']} from {args.ckpt_dir}")
        with torch.no_grad():
            qp, plans = convert.quantize_params(params, cfg)
        del params
    else:
        qp, plans = convert.init_quantized(
            cfg, seed=0, device=dev,
            embed_scale=convert.unit_embed_scale(cfg))
    eng = ServingEngine(qp, plans, cfg, batch_size=args.batch,
                        cache_len=args.cache_len, ops=ops,
                        cache_mode=args.cache_mode, page_size=args.page_size,
                        num_pages=args.num_pages,
                        fold_wo=not args.no_fold_wo,
                        prefill_chunk=args.prefill_chunk,
                        prefill_budget=args.prefill_budget,
                        prefix_cache=not args.no_prefix_cache,
                        spec_k=args.spec_k, spec_mode=args.spec_mode,
                        tp=args.tp, device=dev)
    say(f"engine: {eng.describe_str()}")
    if args.tp > 1:
        t = eng.describe()["tp"]
        say(f"tensor parallel: tp={t['tp']} mode={t['mode']}"
            + (f" over {t['mesh']['backend']} ranks {t['mesh']['ranks']}"
               if t["mesh"] else ""))
    fe = ServingFrontend(eng, max_pending=args.max_pending)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab, PROMPT_LEN)]
               for _ in range(args.requests)]
    if dev.type == "cuda":
        say(f"kernels ready in {build_kernels():.1f}s")
        torch.cuda.synchronize(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    handles = asyncio.run(_serve(fe, prompts, args))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    d = fe.describe()
    n_tok = d["tokens"]
    say(f"served {d['submitted']} requests / {n_tok} tokens in "
        f"{d['steps']} steps, {dt:.2f}s ({n_tok / dt:.1f} tok/s on {dev})")
    say("  terminal: " + ", ".join(f"{k}={v}"
                                   for k, v in d["terminal"].items()))
    lat = d["latency"]
    say(f"  ttft: {_fmt_pct(lat['ttft_s'])}   inter-token: "
        f"{_fmt_pct(lat['inter_token_s'])}   queue-wait: "
        f"{_fmt_pct(lat['queue_wait_s'])}")
    say(f"  occupancy: mean {d['occupancy']['mean']:.2f}/{args.batch} "
        f"lanes, queue depth: mean {d['queue_depth']['mean']:.2f} max "
        f"{d['queue_depth']['max']}")
    ed = eng.describe()
    sp = ed["spec"]
    if sp["k"]:
        rate = f"{sp['accept_rate']:.0%}" \
            if sp["accept_rate"] is not None else "n/a"
        say(f"speculation ({sp['mode']}, k={sp['k']}): "
            f"{sp['accepted']}/{sp['drafted']} drafts accepted ({rate}), "
            f"{sp['wasted']} wasted verify rows")
    px = ed["cache"].get("prefix")
    if px:
        say(f"prefix cache: {px['hits']} hits / {px['misses']} misses, "
            f"{px['tokens_reused']} prompt tokens reused")
    say(f"kernel launches: {dict(kernels.LAUNCHES)}")
    live = [h for h in handles if h is not None]
    for h in live[:4]:
        r = h.request
        say(f"  req {h.uid} [{h.terminal}]: {r.prompt} -> "
            f"{r.out_tokens[:10]}...")
    return [h.request for h in live]


if __name__ == "__main__":
    main()
