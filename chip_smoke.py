#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py                 # every phase, one card

Phases (each prints one JSON line; any mismatch or error exits non-zero
before the last line):

  build    compile ``src/repro_torch/csrc/*.cu`` with nvcc (sm_90a);
  kernels  each kernel K1-K4 against its plain PyTorch version on seeded
           inputs at the serving main path's full-width llama3-8b shapes
           (max |diff| must be 0), with kernel / plain / library times and
           the roofline bound;
  parity   full-width llama3-8b cut to 2 layers: ServingEngine token
           streams on the ``cuda`` backend must equal ``torch_ref``'s;
  serve    full llama3-8b (32 layers) on the ``cuda`` backend: throughput,
           step times, peak memory and per-kernel launch counts (each must
           be > 0).

Then one ``{"kernels": [...]}`` line, the card's name and power limit,
and the final ``{"ok": true, "device": {...}}`` line.  The script imports
only torch, numpy and the port; it needs the repository's ``src/``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of every kernel
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

TPU_KERNELS = {
    "int8_matmul": "src/repro/kernels/int8_matmul.py:90",
    "int_layernorm": "src/repro/kernels/int_layernorm.py:73",
    "int_decode_attention": "src/repro/kernels/int_decode_attention.py:183",
    "int_paged_prefill": "src/repro/kernels/int_attention_fused.py:398",
}
SOURCES = {
    "int8_matmul": "src/repro_torch/csrc/int8_matmul.cu",
    "int_layernorm": "src/repro_torch/csrc/int_layernorm.cu",
    "int_decode_attention": "src/repro_torch/csrc/int_decode_attention.cu",
    "int_paged_prefill": "src/repro_torch/csrc/int_paged_prefill.cu",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, ops: float):
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = ops / INT8_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int):
    """Device time per call of everything ``fn`` launches, from
    ``torch.profiler`` (kernel execution only: no host issue gaps); None
    where the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(ev, "self_device_time_total", 0.0)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA)
    return total_us / 1e3 / iters if total_us > 0 else None


def max_abs_diff(a, b) -> int:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype mismatch {tuple(a.shape)} "
                             f"{a.dtype} vs {tuple(b.shape)} {b.dtype}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


# ------------------------------------------------------------ kernels ----

def _randint(gen, lo, hi, shape, dtype):
    import torch
    return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                         dtype=dtype)


def check_kernels(cfg, plans):
    """K1-K4 vs their plain versions at the main path's shapes.  Returns
    the representative measurement of each kernel (the main path's
    dominant call) for the summary line."""
    import torch
    from repro_torch.core.dyadic import fit_dyadic
    from repro_torch.kernels.int8_matmul import (int8_matmul,
                                                 int8_matmul_plain)
    from repro_torch.kernels.int_attention_fused import (
        int_paged_prefill_fused, int_paged_prefill_plain)
    from repro_torch.kernels.int_decode_attention import (
        int_decode_attention_fused, int_decode_attention_plain)
    from repro_torch.kernels.int_layernorm import (int_layernorm,
                                                   int_layernorm_plain)
    from repro_torch.ops.spec import QuantLinearParams, RequantSpec

    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = {}
    d, f, v = cfg.d_model, cfg.d_ff, cfg.padded_vocab()
    hd, h, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads

    def record(name, case, got, want, kernel, plain, nbytes, ops,
               lib_ms=None, rep=False, iters=20):
        """Exactness first, then times: ``ms`` / ``plain_ms`` are device
        time per call (profiler), ``call_ms`` the kernel wrapper's wall
        time per call on the device timeline (CUDA events, host issue
        gaps included)."""
        err = max_abs_diff(got, want)
        b_ms, b_by = bound_ms(nbytes, ops)
        call = time_ms(kernel, iters)
        row = {"name": name, "case": case, "max_abs_err": err,
               "ms": device_ms(kernel, iters) or call,
               "plain_ms": device_ms(plain, 3) or time_ms(plain, 3),
               "call_ms": call,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        emit({"phase": "kernels", **row})
        if err != 0:
            raise AssertionError(f"{name} {case}: kernel != plain "
                                 f"(max |diff| {err})")
        if rep:
            rows[name] = row

    def int_mm_ms(x8, w8):
        """torch._int_mm (cuBLAS) on the same operands, where it accepts
        them: the library yardstick of a raw int8 product."""
        try:
            torch._int_mm(x8, w8)
        except RuntimeError:
            return None
        return device_ms(lambda: torch._int_mm(x8, w8), 20)

    # K1: every projection of a layer, at decode (M=4) and chunk (M=128)
    mm_cases = [("wq", d, h * hd, plans.attn.qkv),
                ("wk", d, hkv * hd, plans.attn.qkv),
                ("w1", d, f, plans.ffn.up),
                ("w2", f, d, plans.ffn.down),
                ("wo", h * hd, d, plans.attn.out)]
    for m in (4, 128):
        x_cache = {}
        for tag, k, n, lp in mm_cases:
            x8 = x_cache.setdefault(k, _randint(gen, -127, 128, (m, k),
                                                torch.int8))
            w8 = _randint(gen, -127, 128, (k, n), torch.int8)
            b_vec = _randint(gen, 256, 4096, (n,), torch.int32)
            spec = RequantSpec.for_linear(lp)
            got = int8_matmul(x8, w8, spec, b_vec=b_vec)
            want = int8_matmul_plain(x8, w8, spec, b_vec=b_vec)
            out_b = 1 if spec.out_bits <= 8 else 4
            record("int8_matmul", f"{tag} M={m} K={k} N={n} per-channel "
                   f"out_bits={spec.out_bits}", got, want,
                   lambda: int8_matmul(x8, w8, spec, b_vec=b_vec),
                   lambda: int8_matmul_plain(x8, w8, spec, b_vec=b_vec),
                   m * k + k * n + 4 * n + out_b * m * n, 2 * m * k * n)
        # per-tensor epilogue with a bias (not on the llama path; the
        # epilogue form the kernel must still get exactly right)
        x8 = x_cache[d]
        w8 = _randint(gen, -127, 128, (d, d), torch.int8)
        bias = _randint(gen, -5000, 5000, (d,), torch.int32)
        spec = RequantSpec.per_tensor(fit_dyadic(1 / 3000.0, d * 127 * 127),
                                      out_bits=8)
        got = int8_matmul(x8, w8, spec, bias32=bias)
        want = int8_matmul_plain(x8, w8, spec, bias32=bias)
        record("int8_matmul", f"per-tensor+bias M={m} K={d} N={d}", got,
               want, lambda: int8_matmul(x8, w8, spec, bias32=bias),
               lambda: int8_matmul_plain(x8, w8, spec, bias32=bias),
               m * d + d * d + 4 * d + m * d, 2 * m * d * d)
        # the raw logits head
        w8 = _randint(gen, -127, 128, (d, v), torch.int8)
        raw = RequantSpec.raw()
        got = int8_matmul(x8, w8, raw)
        want = int8_matmul_plain(x8, w8, raw)
        record("int8_matmul", f"head raw M={m} K={d} N={v}", got, want,
               lambda: int8_matmul(x8, w8, raw),
               lambda: int8_matmul_plain(x8, w8, raw),
               m * d + d * v + 4 * m * v, 2 * m * d * v,
               lib_ms=int_mm_ms(x8, w8), rep=(m == 4), iters=10)
        del w8

    # K2: RMSNorm rows of the residual stream
    npl = plans.norm
    gamma = _randint(gen, 40, 128, (d,), torch.int32)
    for r in (4, 128):
        q = _randint(gen, -cfg.qmax_res, cfg.qmax_res + 1, (r, d),
                     torch.int32)
        got = int_layernorm(q, gamma, None, npl)
        want = int_layernorm_plain(q, gamma, None, npl)
        # per element ~40 int32 ops, far below the bytes at any rate
        record("int_layernorm", f"rmsnorm rows={r} d={d}", got, want,
               lambda: int_layernorm(q, gamma, None, npl),
               lambda: int_layernorm_plain(q, gamma, None, npl),
               8 * r * d + 4 * d, 0, rep=(r == 4), iters=50)

    # K3/K4: paged attention over a permuted page table, ragged lengths
    b, ps, maxp = 4, 16, 32
    num_pages = b * maxp + 1
    k_pool = _randint(gen, -127, 128, (num_pages, ps, hkv, hd), torch.int8)
    v_pool = _randint(gen, -127, 128, (num_pages, ps, hkv, hd), torch.int8)
    pages = (torch.randperm(num_pages - 1, generator=gen, device="cuda")
             + 1).to(torch.int32).reshape(b, maxp)
    wo = QuantLinearParams(_randint(gen, -127, 128, (h * hd, d), torch.int8),
                           _randint(gen, 256, 4096, (d,), torch.int32))
    wo_spec = RequantSpec.for_linear(plans.attn.out)
    aplan = plans.attn.attn
    requant = RequantSpec.per_tensor(aplan.dn_out)
    kv_row = hkv * hd * 2                       # K + V bytes per position
    fold_bytes = h * hd * d + 4 * d
    for name, fused, plain, sq, lens in (
            ("int_decode_attention", int_decode_attention_fused,
             int_decode_attention_plain, 1, [1, 137, 300, 512]),
            ("int_paged_prefill", int_paged_prefill_fused,
             int_paged_prefill_plain, 32, [32, 100 + 32, 250 + 32, 512])):
        q8 = _randint(gen, -127, 128, (b, sq, h, hd), torch.int8)
        vl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        live = sum(lens)
        # causal work: row i of lane b sees lens[b] - (sq - 1 - i) keys
        pairs = sum(max(n - (sq - 1 - i), 0) for n in lens
                    for i in range(sq))
        for fold in (False, True):
            kw = dict(wo=wo, wo_spec=wo_spec) if fold else {}
            got = fused(q8, k_pool, v_pool, aplan, vl, pages, ps,
                        requant=requant, **kw)
            want = plain(q8, k_pool, v_pool, aplan, vl, pages, ps,
                         requant=requant, **kw)
            io = 2 * b * sq * h * hd + live * kv_row + 4 * b * (maxp + 1)
            ops = 4 * pairs * h * hd
            if fold:
                io += fold_bytes + 4 * b * sq * d - b * sq * h * hd
                ops += 2 * b * sq * h * hd * d
            record(name, f"B={b} S={sq} H={h} Hkv={hkv} D={hd} ps={ps} "
                   f"pages/lane={maxp} valid={lens} fold_wo={fold}", got,
                   want,
                   lambda: fused(q8, k_pool, v_pool, aplan, vl, pages, ps,
                                 requant=requant, **kw),
                   lambda: plain(q8, k_pool, v_pool, aplan, vl, pages, ps,
                                 requant=requant, **kw),
                   io, ops, rep=fold)
    return rows


# --------------------------------------------------------- engine runs ---

def _prompts(seed: int, n: int, lo: int, hi: int, vocab: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, int(rng.integers(
        lo, hi + 1)))] for _ in range(n)]


def run_engine(qp, plans, cfg, prompts, max_new, backend, **kw):
    from repro_torch.serving import Request, ServingEngine
    eng = ServingEngine(qp, plans, cfg, ops=backend, device="cuda", **kw)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    return eng, reqs


def phase_parity(cfg_full):
    import dataclasses
    import torch
    from repro_torch.quant import convert
    cfg = dataclasses.replace(cfg_full, num_layers=2)
    qp, plans = convert.init_quantized(
        cfg, seed=0, device="cuda",
        embed_scale=convert.unit_embed_scale(cfg))
    prompts = _prompts(11, 6, 20, 150, cfg.vocab)
    streams, secs = {}, {}
    for backend in ("cuda", "torch_ref"):
        eng, reqs = run_engine(qp, plans, cfg, prompts, 16, backend,
                               batch_size=4, cache_len=512, page_size=16,
                               prefill_chunk=32, fold_wo=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_until_done()
        torch.cuda.synchronize()
        secs[backend] = time.perf_counter() - t0
        streams[backend] = [r.out_tokens for r in reqs]
    same = streams["cuda"] == streams["torch_ref"]
    distinct = len({t for s in streams["cuda"] for t in s})
    emit({"phase": "parity", "layers": cfg.num_layers, "requests":
          len(prompts), "prompt_lens": [len(p) for p in prompts],
          "identical": same, "distinct_tokens": distinct,
          "cuda_s": secs["cuda"], "torch_ref_s": secs["torch_ref"],
          "first_stream": streams["cuda"][0]})
    if not same:
        raise AssertionError("cuda and torch_ref token streams differ")
    if distinct < 2:
        raise AssertionError("degenerate streams: one token everywhere")
    del qp


def phase_serve(cfg):
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.models import inttransformer as it
    from repro_torch.quant import convert
    t0 = time.perf_counter()
    qp, plans = convert.init_quantized(
        cfg, seed=0, device="cuda",
        embed_scale=convert.unit_embed_scale(cfg))
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(qp))
    prompts = _prompts(5, 8, 32, 200, cfg.vocab)
    eng, reqs = run_engine(qp, plans, cfg, prompts, 32, "cuda",
                           batch_size=4, cache_len=512, page_size=16,
                           prefill_chunk=32, fold_wo=True)
    # time every prefill chunk and decode step with CUDA events, and
    # count the kernel launches each one makes
    events = {"decode": [], "prefill": []}
    per_step = {"decode": [], "prefill": []}

    def timed(fn, tag):
        def wrapper(*a, **k):
            before = dict(kernels.LAUNCHES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **k)
            e.record()
            events[tag].append((s, e))
            per_step[tag].append({n: kernels.LAUNCHES[n] - before[n]
                                  for n in before})
            return out
        return wrapper

    orig = (it.int_decode_step, it.int_prefill_chunk_step)
    it.int_decode_step = timed(orig[0], "decode")
    it.int_prefill_chunk_step = timed(orig[1], "prefill")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    finally:
        it.int_decode_step, it.int_prefill_chunk_step = orig
    n_tok = sum(len(r.out_tokens) for r in reqs)
    distinct = len({t for r in reqs for t in r.out_tokens})
    step_ms = {k: [s.elapsed_time(e) for s, e in v]
               for k, v in events.items()}
    emit({"phase": "serve", "arch": cfg.name, "layers": cfg.num_layers,
          "requests": len(reqs), "prompt_lens": [len(p) for p in prompts],
          "max_new": 32, "batch": 4, "cache_len": 512, "prefill_chunk": 32,
          "tokens": n_tok, "distinct_tokens": distinct, "wall_s": wall,
          "tokens_per_s": n_tok / wall,
          "decode_steps": len(step_ms["decode"]),
          "decode_step_ms_mean": float(np.mean(step_ms["decode"])),
          "prefill_chunks": len(step_ms["prefill"]),
          "prefill_chunk_ms_mean": float(np.mean(step_ms["prefill"])),
          "launches_per_decode_step": _mean_counts(per_step["decode"]),
          "launches_per_prefill_chunk": _mean_counts(per_step["prefill"]),
          "quantize_s": quant_s, "weight_bytes": weight_bytes,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches})
    profile_decode(eng, cfg)
    if not all(len(r.out_tokens) == 32 for r in reqs):
        raise AssertionError("a request came back short")
    vocab_ok = all(0 <= t < cfg.vocab for r in reqs for t in r.out_tokens)
    if not vocab_ok:
        raise AssertionError("token outside the vocabulary")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    return launches


def _mean_counts(deltas):
    return {n: float(sum(d[n] for d in deltas)) / max(len(deltas), 1)
            for n in (deltas[0] if deltas else {})}


def profile_decode(eng, cfg):
    """torch.profiler over a short decode-heavy window of the serve
    engine: the device's busy share and the device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import Request
    prompts = _prompts(9, 4, 8, 8, cfg.vocab)
    reqs = [Request(uid=100 + i, prompt=p, max_new_tokens=8)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.step()                       # admit + prefill + first decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.run_until_done()
    from torch.autograd import DeviceType
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue                 # host ops; their kernels are listed
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us and dev_us > 0:
            rows.append((ev.key, dev_us, ev.count))
    busy_ms = sum(r[1] for r in rows) / 1e3
    rows.sort(key=lambda r: -r[1])
    emit({"phase": "profile", "window": "4 decode steps, batch 4",
          "wall_ms": wall_ms,
          "device_busy_ms": busy_ms if rows else None,
          "device_busy_share": busy_ms / wall_ms if rows else None,
          "top": [{"kernel": k[:90], "device_ms": us / 1e3, "calls": n}
                  for k, us, n in rows[:12]]})


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,kernels,parity,serve")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc -Xptxas -v (registers, spills)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.configs.registry import get_config
        from repro_torch.kernels import _build
        from repro_torch.quant import plans as qplans
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the "
              "repository root", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    so = _build.build(verbose=args.verbose_build)
    nvcc_s = time.perf_counter() - t0
    _build.library()
    emit({"phase": "build", "nvcc_s": nvcc_s, "library": os.path.relpath(
        so, ROOT)})

    cfg = get_config("llama3-8b")
    plans = qplans.build_layer_plans(cfg)
    rows, launches = {}, {}
    if "kernels" in phases:
        rows = check_kernels(cfg, plans)
    if "parity" in phases:
        phase_parity(cfg)
    if "serve" in phases:
        launches = phase_serve(cfg)
    if rows:
        emit({"kernels": [
            {"name": name, "route": "cuda", "source": SOURCES[name],
             "replaces": TPU_KERNELS[name],
             "launches": launches.get(name, 0),
             "max_abs_err": r["max_abs_err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "call_ms": r["call_ms"],
             "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": r["library_ms"],
             "case": r["case"]}
            for name, r in rows.items()]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
