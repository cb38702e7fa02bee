#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py                 # every phase, one card

Phases (each prints one JSON line per case; any mismatch or error exits
non-zero before the last line):

  build    compile ``src/repro_torch/csrc/*.cu`` with nvcc (sm_90a), one
           nvcc per source, all started together;
  kernels  each kernel K1-K8 against its plain PyTorch version on seeded
           inputs (max |diff| must be 0), with kernel / plain / library
           times and the roofline bound: K1-K4 at the serving path's
           full-width llama3-8b shapes (K1 at M = 4 and 16, the decode
           tile, each row with its plan: route, BN, cluster; and 128;
           K3 at Sq 1 and at the verify step's Sq = spec_k + 1, over
           int8 and int4 pages),
           K2 at 4 and 128 rows, its d % 4 != 0 and misaligned rows, an
           empty launch and K2's sqrt against the 16-step one on every
           int32, K1, K2 (LayerNorm) at 16 384 and 128 rows, K5 and K6 at
           the encoder path's full-width roberta-base shapes, K7 and K8
           at the ``pallas`` backend's (the full score matrix, the
           encoder's attention at the reference's logical blocks), then
           the edge cases of the tensor-core K4, K5 and K8 and exp16's
           division on its whole domain, then K1, K2, K3 (contiguous and
           paged) and K5 at h2o-danube-3-4b's shapes, head dim 120 (and
           one K4 and two K8 rows there; K2 at 4 and 1024 rows), then
           the rows of ``zoo-kernels``;
  zoo-kernels  (not in the default list; part of ``kernels``) K1-K6 at the
           shapes the four configs of ROADMAP §1 item 1 give them: K1 at
           codeqwen1.5-7b's QKV with bias (M 4, 16) and w2 (K 13440, M 4)
           and granite-3-2b's raw tied head (N 49155 at M 4 and 128, and
           the padded 49168 at M 4), K2's LayerNorm + beta at
           roberta-large's 16 384 x 1024 and deit-s's 32 x 197 x 384, K3
           and K4 at codeqwen's MHA serve row (D 128) and granite's (D 64),
           K5 at roberta-large's B 32 S 512 H 16, deit-s's B 32 S 197 H 6
           and llama3-8b's long prefill (S 4096, H 32 / 8, causal), K6 at
           16 384 x 4096, each exact against its plain version;
  k1-decode  (not in the default list) K1's decode rows alone: every
           llama3-8b and h2o-danube-3-4b decode projection at M = 4 and
           16, dense and over nibbles, exact against the plain version,
           device, call and host ms; it calls only the wrappers, so
           the same script times another commit's tree (copy it there
           and run ``--phases build,k1-decode``) on the same operands;
  k1-grouped  (not in the default list) the grouped K1's rows alone: the
           MoE expert products of PERF.md's table (qwen2-moe-a2.7b w1 / w2
           at a decode step and a 4 x 512 pass, qwen3-moe-235b-a22b w1,
           jamba-v0.1-52b w1 / w2 at a decode step), exact against the
           plain version, device, call and host ms, each with its launch;
           then its yardsticks: an empty launch, the launch with no
           expert given rows at the decode shapes, and K1's dense tile
           on the 4 x 512 pass's rows as one product;
  k2-norm  (not in the default list) K2's rows alone: every shape a path
           runs (llama3-8b's RMSNorm at 4 and 128 rows of 4096,
           h2o-danube-3-4b's at 4 and 1024 of 3840, roberta-base's
           LayerNorm + beta at 128 and 16 384 of 768), d % 4 != 0 and
           misaligned rows, exact against the plain version, device, call
           and host ms, after an empty launch (the latency floor) and the
           sqrt check; like ``k1-decode`` it calls only the wrappers, so
           the same script times another tree's K2;
  k3-decode  (not in the default list) K3's rows alone: llama3-8b's serve
           row over int8 and int4 pools (folded and not), the serve
           traffic's decode lengths and the profiled decode window's short
           lanes, Sq 8, a 32 768-position table (the streaming
           route), and h2o-danube-3-4b's contiguous L 512 and full
           4096-position window (folded and not), Sq 8 and pools, exact
           against the plain version, device, call and host ms, each with
           its plan; like ``k1-decode`` it calls only the wrappers, so the
           same script times another commit's tree;
  k7-softmax  (not in the default list) K7's rows alone: RoBERTa-base's
           full score matrix (32 x 12 x 512 rows of 512) unmasked and
           with valid_len 300, 256 x 1024, 4 x 2^15, and the edges
           (L % 4 != 0, scores 4 bytes off 16-byte alignment, valid_len
           0 and 1, L = 1, 1024 and 1025, all-equal rows), exact against
           the plain version, device, call and host ms, each with its
           plan, after an empty launch and exp16's division on its whole
           domain; like ``k1-decode`` it calls only the wrappers, so the
           same script times another commit's tree;
  parity   full-width llama3-8b cut to 2 layers: ServingEngine token
           streams on the ``cuda`` backend must equal ``torch_ref``'s;
  serve    full llama3-8b (32 layers) on the ``cuda`` backend: throughput,
           step times, peak memory and per-kernel launch counts (each
           serving kernel must be > 0), then a profiled decode window
           and a profiled window of prefill chunks (device ms, device
           kernel calls and ``FillFunctor`` calls a step or chunk, K3's
           device ms a decode step, K4's share of a chunk);
  encode   full-width roberta-base (12 layers, tied embeddings) through
           ``launch.steps.make_prefill_step``: logits of ``cuda`` and
           ``torch_ref`` identical on 8 x 512 tokens, then timed passes
           at 32 x 512 with launches per pass (K1, K2, K5, K6 must be
           > 0) and one profiled pass;
  encode-online  the same model through ``make_prefill_step(ops=
           "cuda_online")`` (K8, the one-pass online attention, at the
           reference's 128 x 128 logical blocks): logits identical to the
           same routing in plain PyTorch on the card at 8 x 512 (and, for
           information, how many differ from the exact ``cuda`` path),
           timed passes at 32 x 512 with launches per pass (K8 12, K5 0)
           and one profiled pass;
  ops      ``repro_torch.ops.int_softmax``, the module-level entry point,
           under ``use_backend("cuda_online")`` on the full score matrix of
           a roberta-base batch (K7 must launch);
  analysis ``repro_torch.analysis`` on the card: ``certify_config`` of all
           13 configs at (4096, 32768); ``check_launch`` of every
           main-path launch (:func:`main_path_reports`: ``serve``,
           ``tp-serve`` at tp 2, ``encode`` / ``encode-online``, ``ops``,
           qwen2-moe's grouped K1), each ``ok``, and for every distinct
           kernel instantiation the card's registers, spills,
           ``maxThreadsPerBlock`` and occupancy at the report's threads,
           shared memory and cluster (``analysis-kernel`` rows; the
           shared memory within ``shared_memory_per_block_optin``,
           occupancy >= 1); llama3-8b's decode, chunk and verify steps (2
           layers), a roberta-base pass on ``cuda`` and
           ``cuda_online`` and the grouped K1 at qwen2-moe's decode and
           pass shapes under ``kernels.record_launches``, every
           recorded launch equal to its ``ok`` report's route, grid,
           cluster and shared memory; and the refused shapes (D 96, K2 d
           8200, decode Sq 9, H 30 over Hkv 8) raising
           ``KernelContractError`` with ``kernels.LAUNCHES`` unchanged;
  window-parity  h2o-danube-3-4b (the reference serve driver's default:
           sliding window 4096, head dim 120) at full widths cut to 2
           layers: ServingEngine streams on ``cuda`` equal ``torch_ref``'s
           in both cache modes (paged folded, contiguous unfolded), then
           through the rolling window's wrap (window cut to 64, cache_len
           160, 150 new tokens a lane);
  window-serve   h2o-danube-3-4b at full width cut to 4 of its 24 layers
           on ``cuda``, once per
           cache mode, token-streaming prefill: throughput, step times,
           peak memory, launches per decode step (K1, K2, K3; no K4) and a
           profiled decode window;
  window-prefill the same 4 layers through ``make_prefill_step`` at 4
           x 256 tokens and ``int_prefill(return_cache=True)`` over their
           first 64: logits and the built contiguous caches of ``cuda``
           equal ``torch_ref``'s;
           the pass time and its launches (K5 at D = 120, windowed);
  kv4-parity     ``parity`` over int4 KV pages (``kv_dtype="int4"``):
           llama3-8b at full width cut to 2 layers, ``cuda`` streams equal
           ``torch_ref``'s;
  kv4-serve      ``serve`` over int4 KV pages: llama3-8b at full width
           cut to 8 of its 32 layers, the same
           traffic, K3 and K4 launching their packed instantiations
           (``*_kv4``) in every decode step and prefill chunk, and the
           pool's pages and bytes;
  packed-parity  llama3-8b at full width cut to 2 layers, its weights
           packed on the card with ``quant.pack.pack_tree`` (group 64):
           msr4 streams of ``cuda`` equal ``torch_ref``'s and the dense
           int8 engine's (the tier is lossless); then a derived model,
           every linear weight clamped to [-7, 7], packed int4: ``cuda``
           equals ``torch_ref`` and the clamped dense model;
  msr4-serve     ``serve`` on msr4 weights (group 64, the reference serving
           benchmark's tier): llama3-8b cut to 8 layers, the same
           traffic, every
           matmul through K1's nibble instantiation and the MSR-4
           correction kernel (the dense K1 never: a packed wo never
           folds), the packed weight bytes, a profiled decode window and
           prefill chunks;
  zoo-parity     codeqwen1.5-7b (MHA, QKV bias), granite-3-2b (tied head,
           vocab 49155), roberta-large and deit-s at full width cut to 2
           layers: the decoders' ServingEngine streams on ``cuda`` equal
           ``torch_ref``'s (paged, chunked prefill, wo folded), the
           encoders' ``make_prefill_step`` logits on ``cuda`` equal
           ``torch_ref``'s at 8 x 512 and 8 x 197;
  zoo-serve      ``serve`` for codeqwen1.5-7b and granite-3-2b at full width
           cut to 4 layers (of 32 and 40) on the same traffic (phases
           ``zoo-serve-<arch>``, with their decode and prefill profiles);
  zoo-encode     full roberta-large (24 layers) at 32 x 512 and deit-s (12
           layers) at 32 x 197 through ``make_prefill_step`` on ``cuda``:
           ms a pass, launches per pass (K1, K2, K5, K6), one profiled
           pass (phases ``zoo-encode-<arch>``);
  long-prefill   llama3-8b at full width cut to 2 layers, B 1, S 4096,
           above the reference's full-matrix threshold: under
           ``ops="ref"`` (``cuda_ref``) the attention streams the
           reference's chunked two-pass path, K5 never launches, and the
           logits equal ``torch_ref``'s; under ``"cuda"`` K5 launches and
           the logits differing from ``ref``'s are counted; the chunked
           attention at the full head shape on the card equals the same
           call on the CPU, and its ms stand beside K5's;
  moe-kernels  (not in the default list; part of ``kernels``) the kernels
           at the MoE configs' shapes: K1's grouped instantiation (rows
           ``int8_matmul_grouped``: the experts of qwen2-moe-a2.7b's w1 /
           w2 at a decode step of 4 tokens, spread over 16 experts and
           all in 4, and at a 4 x 512 pass on its routing, beside a loop
           of torch._int_mm over the experts that got rows; qwen3-moe's
           w1 at E 128; jamba-v0.1-52b's w1 / w2 at a decode step, over 8
           experts and all in 2; each with its launch and host ms), K1
           for the raw routers and qwen2's QKV + bias,
           K3 at qwen2's MHA 16 / 16 and qwen3's GQA 64 / 4 (serve row,
           verify Sq 4);
  moe-parity     qwen2-moe-a2.7b and qwen3-moe-235b-a22b at full width cut
           to 2 layers: ServingEngine streams on ``cuda`` equal
           ``torch_ref``'s (paged, token-streaming prefill, wo folded,
           spec_k 0 and 3), and ``make_prefill_step`` logits at 4 x 512,
           with the dropped (token, slot) pairs of each layer;
  moe-serve      qwen2-moe-a2.7b at full width cut to 4 of its 24 layers
           on the ``serve`` traffic:
           tokens/s, device ms a step, peak memory, weight bytes, launches
           by kernel (K1, K2, K3 and the grouped K1 > 0) and a profiled
           window (device ms by kernel, the port's kernels against the
           glue);
  moe-prefill    the same 4 layers through ``make_prefill_step`` at 4 x
           512 (K5): ms a pass, launches, drops per layer, a profiled
           pass;
  ssm-kernels  (not in the default list; part of ``kernels``) the kernels
           at the state-space configs' shapes: K1 at mamba2-130m's and
           jamba-v0.1-52b's in_proj, raw Δt projection (N 24: the decode
           tile's copy route) and out_proj at M 4 and 2048, K2's RMSNorm
           over d_inner (1536, 8192) with the Mamba plan (the grouped K1
           at jamba's experts is among ``moe-kernels``' rows);
  ssm-parity     mamba2-130m at full width cut to 4 of its 24 layers
           (attention-free): ServingEngine
           streams on ``cuda`` equal ``torch_ref``'s in both cache modes
           (6 prompts on 4 lanes, token-streaming prefill),
           ``make_prefill_step`` logits at 4 x 512 equal, and the prefill's
           last logits at 4 x 64 equal the token-streamed decode's; the
           ``cuda`` pass at 4 x 512 is the timed ``ssm-prefill`` path (ms,
           launches, peak memory);
  ssm-serve      the same 4 layers on the ``serve`` traffic: tokens/s, device
           and wall ms a step, launches a step (K1 three a layer and the
           head, K2 two a layer and the final norm), a profiled decode
           window (the busy share, the port's kernels against the
           recurrence glue), then ``ssm-prefill-profile``: a profiled 4 x
           16 pass;
  hybrid-parity, hybrid-serve  the same for jamba-v0.1-52b at full width
           cut to one layer group (8 sublayers: attention without RoPE at
           position 4 through K3 / K5, seven Mamba, MoE at the odd
           positions through the grouped K1), ``hybrid-prefill`` its pass.
  Each of the four ends with a ``<ssm|hybrid>-seconds`` line.
  cross-kernels  (not in the default list; part of ``kernels``) the
           kernels at the cross attention configs' shapes: K1 at
           seamless's raw head (N 256 208), the VLM's wq / w1 / w2 at M 4
           and its cross K/V projection over 4 x 1600 image tokens (beside
           ``torch._int_mm``), K2's residual norm at d 1024 (LayerNorm +
           beta) and 8192 (RMSNorm), K5 over seamless's encoder and cross
           at 4 x 64 x 512 and 4 x 64 x 1600 (GQA 64 / 8), K6 at 256 x
           8192, K3 over the whole memory (valid = Skv 512 / 1600);
  encdec-parity  seamless-m4t-large-v2 at full width cut to 4 encoder and
           4 decoder layers (of 24 and 24) over 4 x 512 source frames
           (float32 embeddings of unit std): ``make_prefill_step``
           logits at 4 x 64 on ``cuda`` equal ``torch_ref``'s;
           ``int_prefill(return_cache=True)`` of 63 tokens and one decode
           step equal the 64-token prefill on both; the caches (``ck8``
           / ``cv8`` included) equal;
  encdec-decode  the same model: 4 prompts of 64 tokens (seed 5), 32
           greedy tokens through ``make_decode_step``, the streams of
           ``cuda`` equal ``torch_ref``'s; tokens/s, device and wall ms a
           step, launches a step (K1, K2, K3, K6), the memory's and the
           cross K/V set-up's device ms, a profiled decode window;
  vlm-parity, vlm-decode  the same for llama-3.2-vision-90b at full width
           cut to one group of five sublayers (4 self attention with RoPE,
           1 cross attention) over 4 x 1600 image tokens (K1, K2, K3, K5).
  Each model ends with an ``<encdec|vlm>-seconds`` line.
  tp-kernels  (not in the default list; part of ``kernels``) the kernels
           at the shapes one tensor-parallel rank of llama3-8b gives them
           (tp 2 and 4: 16 / 4 and 8 / 2 heads): K1's decode tile at wq's
           and wk's column slices and wo's row slice (raw, the partial the
           group sums; and at M 128), K3 (serve row, verify Sq 4) and K4
           at the local heads;
  tp-parity  llama3-8b at full width cut to 1 layer: chunked, streaming,
           contiguous, int4 pages and ``spec_k = 3`` at tp = 1 on ``cuda``
           here, then ``ServingEngine(tp=N)`` in gloo worlds of 2 and 4
           processes on the one card (``distributed.world.run_world``;
           NCCL refuses two ranks on one device), and qwen2-moe-a2.7b at 1
           layer in the 2-rank world: every rank ``sharded``, its streams
           equal to tp = 1's, K3 / K4 at the local heads;
  tp-serve  full llama3-8b (32 layers) at tp 2 on the ``serve`` traffic
           (run with ``serve``): every rank's streams equal ``serve``'s;
           per rank step and chunk device ms, the collective's ms a step
           (CUDA events around each ``psum_int32``), launches a step by
           kernel and the wo partials, weight and KV bytes, peak memory
           and whether ``dispatch_step`` returned before the device
           finished.  The ranks time-share the card: their times are a
           record, not a tensor-parallel speed.  Both phases end with a
           ``<phase>-seconds`` line.
  train-parity  the float / QAT training path (no kernel: the reference's
           float path reaches no Pallas kernel) on the card against the
           CPU, from the same params and batch: one reduced float32
           config a family (llama3-8b, roberta-base with its tied head,
           qwen2-moe-a2.7b, mamba2-130m, jamba-v0.1-52b,
           seamless-m4t-large-v2, llama-3.2-vision-90b) at B 2 x S 16,
           TF32 off: ``forward_float``'s logits and ``loss_fn`` with its
           gradients at qat False and True, and one ``adamw_update``,
           within the CPU tests' tolerances; at qat=True the card replays
           the CPU's fake-quant codes (``FakeQuantTape``: each code that
           differs must be a rounding tie), and the line gives the tie
           flips and the errors without the replay;
  train    llama3-8b at full width cut to 2 of its 32 layers (bfloat16
           params, float32 moments: 1.49 B params, ~15 GB of params and
           moments), 8 QAT steps of ``launch.steps.make_train_step`` at
           B 4 x S 256 of the synthetic language under
           ``linear_warmup_cosine(1, 8)``, lr 1e-3: each step's loss and
           CUDA-event ms, tokens/s, peak memory; then ``quantize_params``
           of the trained weights and one ``int_prefill`` through ``cuda``
           and ``torch_ref`` on the card (logits identical; K1, K2, K5
           launched: the ``launches_by_path`` entry ``train``);
  train-mesh  the ``train`` model (llama3-8b full width, 2 of 32
           layers, bfloat16 params, float32 moments) on a gloo world of
           4 ranks sharing the card, mesh (2, 2), ZeRO-1: 2 QAT steps of
           ``make_train_step(param_specs=, mesh=)`` at B 4 x S 256 of the
           synthetic language (each rank its rows and sequence block;
           tensor-parallel attention / FFN behind the int8 sequence
           gather); per rank the step ms and the collective ms a step
           (CUDA events around each collective, by kind), the int8 bytes
           of ``comm_quant_gather``, its param / moment bytes and peak
           memory (below ``train``'s single-rank peak); the losses
           against a (1, 1)-mesh run of the same params and batches in
           this process (within 1e-4 relative at the first step, 1e-3
           after); then rank 0 gathers the weights, quantizes them and
           runs one ``int_prefill`` through ``cuda`` and ``torch_ref``
           (identical; K1, K2, K5 launched: ``launches_by_path``
           ``train-mesh``);
  train-entry  ``python -m torch.distributed.run --standalone
           --nproc-per-node 2 -m repro_torch.launch.train --dist-backend
           gloo --arch llama3-8b --reduced --steps 6 --batch 4 --seq 64
           --ckpt-every 2 --int-eval`` (a world of 2 ranks on the card,
           ``choose_mesh``: (1, 2); started in the background before
           ``train-parity``), then one process with ``--steps 8``, which
           resumes at step 6 from the world's checkpoint; each int-eval
           prefill launches K1, K2 and K5 (the driver prints its
           launches); then
           a ``FaultTolerantLoop`` of reduced llama3-8b failing once at
           step 3 restarts once, its losses those of an uninterrupted
           run (within 1e-4; whether bit-equal is printed).

The ``kernels`` phase also holds K3's and K4's packed instantiations
(rows ``int_decode_attention_kv4`` / ``int_paged_prefill_kv4``) against
their plain version (``ops.packed.unpack_kv_pool``, then the int8 plain
version) at the serve shapes, folded and not, and at D = 120; and K1 over
packed weights (rows ``int8_matmul_packed``: the nibble launch, int4 fused
or msr4 raw) and the MSR-4 correction kernel (rows ``int8_matmul_msr4``,
each with its route: the tensor cores or the gather) against their plain
versions at llama3-8b's shapes and at their edges; at the five full-width
shapes the gather route runs beside the route ``msr4_plan`` chose, exact
too, as the yardstick (``gather_ms``), and at M = 128 ``torch._int_mm``
over the dense delta matrix, a layout the port does not store
(``library_ms``).

``--verbose-build`` also prints ptxas's registers and spills and a
``sass`` line (per kernel ``IMMA`` / ``IDP`` / ``LDL`` / ``STL``), and
fails unless every K1 decode-tile, K3, K4, K5, K8 and tensor-core MSR-4
correction instantiation shows ``IMMA`` and none of the other three, every K1
tensor-core instantiation ``IMMA``, and no K1, gather-route correction or
K2 instantiation ``LDL`` / ``STL``.

Every phase line carries the card's name and power limit (``card``) and
the seconds since the script started (``t_s``).  Then one ``{"kernels":
[...]}`` line, the card's name and power limit,
and the final ``{"ok": true, "device": {...}}`` line.  The script imports
only torch, numpy and the port; it needs the repository's ``src/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of every kernel
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

# the speculative engines' draft length: their verify step runs K3 at
# Sq = spec_k + 1
SPEC_K = 3
VERIFY_SQ = SPEC_K + 1

TPU_KERNELS = {
    "int8_matmul": "src/repro/kernels/int8_matmul.py:90",
    "int_layernorm": "src/repro/kernels/int_layernorm.py:73",
    "int_decode_attention": "src/repro/kernels/int_decode_attention.py:183",
    "int_paged_prefill": "src/repro/kernels/int_attention_fused.py:398",
    "int_attention_fused": "src/repro/kernels/int_attention_fused.py:215",
    "int_gelu": "src/repro/kernels/int_gelu.py:41",
    "int_softmax": "src/repro/kernels/int_softmax.py:66",
    "int_attention_online": "src/repro/kernels/int_attention.py:107",
    "int_decode_attention_kv4":
        "src/repro/kernels/int_decode_attention.py:183",
    "int_paged_prefill_kv4": "src/repro/kernels/int_attention_fused.py:398",
    "int8_matmul_packed": "src/repro/kernels/int8_matmul.py:90",
    "int8_matmul_msr4": "src/repro/kernels/int8_matmul.py:90",
    # K1's grouped instantiation: the reference runs the expert products
    # outside any kernel (intlayers.py:101, int_expert_linear)
    "int8_matmul_grouped": "src/repro/kernels/int8_matmul.py:90",
}
# the summary rows of K1 (the raw head, and packed int4 w1, at M = 4) run
# its decode tile; its M > 16 tiles are in csrc/int8_matmul.cu
SOURCES = {
    "int8_matmul": "src/repro_torch/csrc/int8_matmul_decode.cu",
    "int_layernorm": "src/repro_torch/csrc/int_layernorm.cu",
    "int_decode_attention": "src/repro_torch/csrc/int_decode_attention.cu",
    "int_paged_prefill": "src/repro_torch/csrc/int_paged_prefill.cu",
    "int_attention_fused": "src/repro_torch/csrc/int_attention_fused.cu",
    "int_gelu": "src/repro_torch/csrc/int_gelu.cu",
    "int_softmax": "src/repro_torch/csrc/int_softmax.cu",
    "int_attention_online": "src/repro_torch/csrc/int_attention_online.cu",
    "int_decode_attention_kv4": "src/repro_torch/csrc/int_decode_attention.cu",
    "int_paged_prefill_kv4": "src/repro_torch/csrc/int_paged_prefill.cu",
    "int8_matmul_packed": "src/repro_torch/csrc/int8_matmul_decode.cu",
    "int8_matmul_msr4": "src/repro_torch/csrc/int8_matmul_msr4.cu",
    "int8_matmul_grouped": "src/repro_torch/csrc/int8_matmul_grouped.cu",
}
# the kernels each driven path must launch
PATH_KERNELS = {
    "serve": ("int8_matmul", "int_layernorm", "int_decode_attention",
              "int_paged_prefill"),
    "frontend-serve": ("int8_matmul", "int_layernorm",
                       "int_decode_attention", "int_paged_prefill"),
    "spec-serve": ("int8_matmul", "int_layernorm", "int_decode_attention",
                   "int_paged_prefill"),
    "encode": ("int8_matmul", "int_layernorm", "int_attention_fused",
               "int_gelu"),
    "encode-online": ("int8_matmul", "int_layernorm",
                      "int_attention_online", "int_gelu"),
    "ops": ("int_softmax",),
    "analysis": ("int8_matmul", "int_layernorm", "int_decode_attention",
                 "int_paged_prefill", "int_attention_fused",
                 "int_attention_online", "int_gelu", "int8_matmul_grouped"),
    "window-serve-paged": ("int8_matmul", "int_layernorm",
                           "int_decode_attention"),
    "window-serve-contiguous": ("int8_matmul", "int_layernorm",
                                "int_decode_attention"),
    "window-prefill": ("int8_matmul", "int_layernorm",
                       "int_attention_fused"),
    "kv4-serve": ("int8_matmul", "int_layernorm", "int_decode_attention_kv4",
                  "int_paged_prefill_kv4"),
    "msr4-serve": ("int8_matmul_packed", "int8_matmul_msr4", "int_layernorm",
                   "int_decode_attention", "int_paged_prefill"),
    "zoo-serve-codeqwen1.5-7b": ("int8_matmul", "int_layernorm",
                                 "int_decode_attention", "int_paged_prefill"),
    "zoo-serve-granite-3-2b": ("int8_matmul", "int_layernorm",
                               "int_decode_attention", "int_paged_prefill"),
    "zoo-encode-roberta-large": ("int8_matmul", "int_layernorm",
                                 "int_attention_fused", "int_gelu"),
    "zoo-encode-deit-s": ("int8_matmul", "int_layernorm",
                          "int_attention_fused", "int_gelu"),
    "long-prefill-ref": ("int8_matmul", "int_layernorm"),
    "long-prefill-cuda": ("int8_matmul", "int_layernorm",
                          "int_attention_fused"),
    "moe-serve": ("int8_matmul", "int_layernorm", "int_decode_attention",
                  "int8_matmul_grouped"),
    "moe-prefill": ("int8_matmul", "int_layernorm", "int_attention_fused",
                    "int8_matmul_grouped"),
    "ssm-serve": ("int8_matmul", "int_layernorm"),
    "ssm-prefill": ("int8_matmul", "int_layernorm"),
    "hybrid-serve": ("int8_matmul", "int_layernorm", "int_decode_attention",
                     "int8_matmul_grouped"),
    "hybrid-prefill": ("int8_matmul", "int_layernorm", "int_attention_fused",
                       "int8_matmul_grouped"),
    "encdec-parity": ("int8_matmul", "int_layernorm", "int_attention_fused",
                      "int_gelu", "int_decode_attention"),
    "encdec-decode": ("int8_matmul", "int_layernorm", "int_attention_fused",
                      "int_gelu", "int_decode_attention"),
    "vlm-parity": ("int8_matmul", "int_layernorm", "int_attention_fused",
                   "int_decode_attention"),
    "vlm-decode": ("int8_matmul", "int_layernorm", "int_attention_fused",
                   "int_decode_attention"),
    "tp-parity": ("int8_matmul", "int_layernorm", "int_decode_attention",
                  "int_paged_prefill", "int_decode_attention_kv4",
                  "int_paged_prefill_kv4", "int8_matmul_grouped"),
    "tp-serve": ("int8_matmul", "int_layernorm", "int_decode_attention",
                 "int_paged_prefill"),
    # the int-eval prefill of the trained weights (K5: full-sequence
    # attention), in this process and in the driver's
    "train": ("int8_matmul", "int_layernorm", "int_attention_fused"),
    "train-entry": ("int8_matmul", "int_layernorm", "int_attention_fused"),
    "train-mesh": ("int8_matmul", "int_layernorm", "int_attention_fused"),
}
# the reference serving benchmark's weight tier (pack_tree(qp, "msr4",
# group=64), benchmarks/bench_serving.py)
PACK_GROUP = 64
# the window-serve traffic (token-streaming prefill): prompts of 16-64
# tokens from seed 5, 16 new tokens each, batch 4, cache_len 512
WINDOW_SERVE = dict(requests=8, lo=16, hi=64, max_new=16, batch=4,
                    cache_len=512)
# window-serve / window-prefill: h2o-danube-3-4b at full width cut to 4
# of its 24 layers, and kv4-serve / msr4-serve: llama3-8b cut to 8 of its
# 32 (``serve`` and ``tp-serve`` keep all 32; to keep the whole script
# within its time)
WINDOW_LAYERS, SERVE_VARIANT_LAYERS = 4, 8
# the encode path's traffic: RoBERTa's longest sequence at a GLUE
# inference batch; the cuda == torch_ref parity batch
ENCODE_BATCH, ENCODE_SEQ, PARITY_BATCH = 32, 512, 8


def encode_launches_per_pass(layers: int,
                             attention: str = "int_attention_fused") -> dict:
    """K1: q, k, v, o, w1, w2 per layer + the head; K2: two norms per
    layer + the final norm; the attention kernel (K5, or K8 online) and
    K6: one per layer; every other kernel: none."""
    per = dict.fromkeys(TPU_KERNELS, 0)
    per.update({"int8_matmul": 6 * layers + 1,
                "int_layernorm": 2 * layers + 1, attention: layers,
                "int_gelu": layers})
    return per


# the card's name and power limit (nvidia-smi), set once the card is found;
# every phase line carries it
CARD = {}


# the script's start: every phase line carries its seconds since then
T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj and CARD:
        obj = {**obj, "card": CARD["card"],
               "t_s": round(time.perf_counter() - T0, 1)}
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip()


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


def host_ms(fn, iters: int) -> float:
    """The host's time to issue one call of ``fn`` (its wrapper's Python,
    allocations and launches; the card may still be busy), after a
    warm-up: ``perf_counter`` around ``iters`` calls, then a
    synchronize outside the timing."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return t


def device_profile(fn, iters: int):
    """``(ms, events)``: the device time per call of everything ``fn``
    launches, from ``torch.profiler`` (kernel execution only: no host
    issue gaps), None where the profiler records no device time; and the
    device events it recorded over the ``iters`` calls.  The profiler
    can drop an event: a kernel recorded ``n`` times counts ``ceil(n /
    iters)`` launches a call at its mean time, so a dropped event does
    not lower the time (with none dropped, the total over ``iters``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us, events = 0.0, 0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", 0.0)
        if ev.device_type == DeviceType.CUDA and ev.count and t > 0:
            us += t / ev.count * -(-ev.count // iters)
            events += ev.count
    return (us / 1e3 if us > 0 else None), events


def device_ms(fn, iters: int):
    """Device time per call of everything ``fn`` launches
    (:func:`device_profile`); None where the profiler records none."""
    return device_profile(fn, iters)[0]


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


def record(rows, name, case, got, want, kernel, plain, nbytes, ops,
           lib_ms=None, rep=False, iters=20, plain_iters=3, plan=None,
           extra=None):
    """Exactness first, then times: ``ms`` / ``plain_ms`` are device time
    per call (profiler; ``device_events`` the kernel events it recorded
    over ``iters`` calls), ``call_ms`` the kernel wrapper's wall time per
    call on the device timeline (CUDA events, host issue gaps included).
    ``rep``: this case is the kernel's row in the summary line; ``plan``:
    the launch the wrapper chose, printed with the case; ``extra``: more
    keys for the printed row."""
    err = max_abs_diff(got, want)
    b_ms, b_by = bound_ms(nbytes, ops)
    call = time_ms(kernel, iters)
    ms, events = device_profile(kernel, iters)
    row = {"name": name, "case": case, "max_abs_err": err,
           "ms": ms or call,
           "plain_ms": (device_ms(plain, plain_iters)
                        or time_ms(plain, plain_iters)),
           "call_ms": call,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
           "device_events": events, "iters": iters}
    emit({"phase": "kernels", **row, **({"plan": plan} if plan else {}),
          **(extra or {})})
    if err != 0:
        raise AssertionError(f"{name} {case}: kernel != plain "
                             f"(max |diff| {err})")
    if rep:
        rows[name] = dict(row, **({"plan": plan} if plan else {}))


def k1_plan(m: int, n: int, k: int, packed: bool = False, x8=None,
            w=None) -> str:
    """K1's launch for an (m, k) x (k, n) product on this card (with the
    operands, their alignment picks the decode tile's route)."""
    import torch
    from repro_torch.kernels.int8_matmul import TILES, launch_plan
    p = launch_plan(m, n, k,
                    torch.cuda.get_device_properties(0).multi_processor_count,
                    packed, 0 if x8 is None else x8.data_ptr(),
                    0 if w is None else w.data_ptr())
    if p.tile == 0:
        return (f"decode {p.route} 16x{p.bn} cluster={p.cluster} "
                f"k_per_rank={p.k_per_split} blocks={p.grid[0] * p.cluster}")
    bm, bn, _ = TILES[p.tile]
    return f"mma {bm}x{bn} splits={p.grid[2]}"


def k5_plan(q8, k8, causal: bool, window: int, plan) -> str:
    """K5's launch for these operands (kernels/int_attention_fused.py::
    k5_launch_plan)."""
    from repro_torch.kernels.int_attention_fused import (
        e16_fits_16_bits, k5_launch_plan, k_copy_bytes)
    b, sq, h, d = q8.shape
    p = k5_launch_plan(b, sq, k8.shape[1], h, k8.shape[2], d, causal,
                       window, k8.data_ptr(), e16_fits_16_bits(plan.sm))
    return (f"mma grid={list(p.grid)} tiles={p.tiles} smem={p.smem} "
            f"e16_store={p.store_e16} "
            f"k_copies={k_copy_bytes(d, k8.data_ptr())}B")


def k4_plan(q8, k_pool, pages, page_size: int, plan,
            packed: bool = False) -> str:
    """K4's launch for these operands (kernels/int_attention_fused.py::
    k4_launch_plan); ``packed``: over int4 pools (K through registers)."""
    from repro_torch.kernels.int_attention_fused import (
        e16_fits_16_bits, k4_launch_plan, k_copy_bytes)
    b, c, h, d = q8.shape
    p = k4_launch_plan(b, c, h, k_pool.shape[2], d, pages.shape[1],
                       page_size, k_pool.data_ptr(),
                       e16_fits_16_bits(plan.sm), packed=packed)
    copies = ("registers, 4 packed bytes a load" if packed
              else f"{k_copy_bytes(d, k_pool.data_ptr())}B")
    return (f"mma grid={list(p.grid)} tiles={p.tiles} smem={p.smem} "
            f"e16_store={p.store_e16} k_copies={copies}")


def k3_plan(q8, k8, v8, kw) -> str:
    """K3's launch for these operands (kernels/int_decode_attention.py::
    k3_launch_plan), or None in a tree that has no such plan (the
    ``k3-decode`` phase also times older trees)."""
    import torch
    try:
        from repro_torch.kernels.int_decode_attention import k3_launch_plan
    except ImportError:
        return None
    b, sq, h, d = q8.shape
    pages = kw.get("pages")
    length = (pages.shape[1] * kw["page_size"] if pages is not None
              else k8.shape[1])
    return k3_launch_plan(
        b, sq, h, k8.shape[2], d, length, pages is not None,
        kw.get("kv_shifts") is not None, k8.data_ptr(), v8.data_ptr(),
        torch.cuda.get_device_properties(0).multi_processor_count
    ).describe()


def k8_plan(q8, bkv: int) -> str:
    """K8's launch for these operands (kernels/int_attention.py::
    k8_launch_plan)."""
    from repro_torch.kernels.int_attention import k8_launch_plan
    b, sq, h, d = q8.shape
    p = k8_launch_plan(b, sq, h, d, bkv)
    return f"mma grid={list(p.grid)} tiles={p.tiles} smem={p.smem}"


def division_check(name: str, aplan) -> None:
    """exp16's multiply-high division (K3's, K4's, K5's, K7's and K8's)
    against `/` on its whole domain for the plan ``aplan`` the kernel
    ``name`` launches with."""
    from repro_torch.kernels.int_attention_fused import (
        exp16_division_mismatches)
    ie = aplan.sm.iexp
    bad = exp16_division_mismatches(ie)
    emit({"phase": "kernels", "name": name,
          "case": f"exp16 division, every n in [0, {ie.z_max * ie.q_ln2}]"
          f", q_ln2={ie.q_ln2}", "mismatches": bad})
    if bad:
        raise AssertionError(f"{name}: exp16's division differs from / on "
                             f"{bad} values")


def _offset_view(x, off: int):
    """A contiguous copy of ``x`` starting ``off`` elements past a 16-byte
    boundary (``off`` bytes for int8)."""
    import torch
    flat = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
    y = flat[off:off + x.numel()].view(x.shape)
    y.copy_(x)
    if y.data_ptr() % 16 != off * x.element_size():
        raise AssertionError("offset view is not where it was asked")
    return y


def _qkv(gen, operands: str, b, sq, skv, hq, hkv, dd):
    """Attention operands q8 (B, Sq, H, D), k8 and v8 (B, Skv, Hkv, D) on
    the card: seeded (``random``), every value -128 (``min``) or +127
    (``max``), or seeded and 4 (``misaligned``) or 8 (``misaligned8``)
    bytes off 16-byte alignment."""
    import torch
    shapes = ((b, sq, hq, dd), (b, skv, hkv, dd), (b, skv, hkv, dd))
    if operands in ("min", "max"):
        fill = -128 if operands == "min" else 127
        return tuple(torch.full(s, fill, dtype=torch.int8, device="cuda")
                     for s in shapes)
    qkv = tuple(_randint(gen, -127, 128, s, torch.int8) for s in shapes)
    if operands in ("misaligned", "misaligned8"):
        off = 8 if operands == "misaligned8" else 4
        qkv = tuple(_offset_view(x, off) for x in qkv)
    return qkv


def int_mm_ms(x8, w8):
    """torch._int_mm (cuBLAS) on the same operands, where it accepts
    them: the library yardstick of a raw int8 product."""
    import torch
    try:
        torch._int_mm(x8, w8)
    except RuntimeError:
        return None
    return device_ms(lambda: torch._int_mm(x8, w8), 20)


def paged_attention_rows(gen, rows, cfg, plans, cases, tag="",
                         rep=False, maxp: int = 32):
    """K3 and K4 against their plain versions over paged pools at the
    serve geometry of ``cfg`` (B 4, pages of 16, ``maxp`` pages a lane, a
    permuted page table), each case ``(kernel, Sq, valid lengths, prefix)``
    unfolded and with wo folded: ``int_decode_attention`` is K3 (valid =
    the live positions), ``int_paged_prefill`` K4 with chunk Sq (valid =
    pos_end).  ``tag`` prefixes each case;
    ``rep``: the first folded K3 and K4 rows of an unprefixed case are the
    kernels' summary rows.  Returns ``(wo, wo_spec)``."""
    import torch
    from repro_torch.kernels.int_attention_fused import (
        int_paged_prefill_fused, int_paged_prefill_plain)
    from repro_torch.kernels.int_decode_attention import (
        int_decode_attention_fused, int_decode_attention_plain)
    from repro_torch.ops.spec import QuantLinearParams, RequantSpec
    d, hd, h, hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    b, ps = 4, 16
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
    for name, sq, lens, pre in cases:
        k4 = name == "int_paged_prefill"
        fused, plain = ((int_paged_prefill_fused, int_paged_prefill_plain)
                        if k4 else (int_decode_attention_fused,
                                    int_decode_attention_plain))
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
            record(rows, name, f"{tag}{pre}B={b} S={sq} H={h} Hkv={hkv} "
                   f"D={hd} ps={ps} pages/lane={maxp} valid={lens} "
                   f"fold_wo={fold}", got, want,
                   lambda: fused(q8, k_pool, v_pool, aplan, vl, pages, ps,
                                 requant=requant, **kw),
                   lambda: plain(q8, k_pool, v_pool, aplan, vl, pages, ps,
                                 requant=requant, **kw),
                   io, ops, rep=rep and fold and not pre,
                   plan=(k4_plan(q8, k_pool, pages, ps, aplan) if k4 else
                         k3_plan(q8, k_pool, v_pool,
                                 dict(pages=pages, page_size=ps))))
    return wo, wo_spec


def check_kernels(cfg, plans):
    """K1-K4 vs their plain versions at the serving path's shapes.
    Returns the representative measurement of each kernel (the main
    path's dominant call) for the summary line."""
    import torch
    from repro_torch.core.dyadic import fit_dyadic
    from repro_torch.kernels.int8_matmul import (int8_matmul,
                                                 int8_matmul_plain)
    from repro_torch.ops.spec import RequantSpec

    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = {}
    d, f, v = cfg.d_model, cfg.d_ff, cfg.padded_vocab()
    hd, h, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads

    # K1: every projection of a layer, at decode (M = 4 and 16: the
    # decode tile) and chunk (M = 128: the tensor-core tiles)
    mm_cases = [("wq", d, h * hd, plans.attn.qkv),
                ("wk", d, hkv * hd, plans.attn.qkv),
                ("w1", d, f, plans.ffn.up),
                ("w2", f, d, plans.ffn.down),
                ("wo", h * hd, d, plans.attn.out)]
    for m in (4, 16, 128):
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
            record(rows, "int8_matmul", f"{tag} M={m} K={k} N={n} "
                   f"per-channel out_bits={spec.out_bits}", got, want,
                   lambda: int8_matmul(x8, w8, spec, b_vec=b_vec),
                   lambda: int8_matmul_plain(x8, w8, spec, b_vec=b_vec),
                   m * k + k * n + 4 * n + out_b * m * n, 2 * m * k * n,
                   lib_ms=int_mm_ms(x8, w8) if m > 16 else None,
                   plan=k1_plan(m, n, k, x8=x8, w=w8))
        # per-tensor epilogue with a bias (not on the llama path; the
        # epilogue form the kernel must still get exactly right)
        x8 = x_cache[d]
        w8 = _randint(gen, -127, 128, (d, d), torch.int8)
        bias = _randint(gen, -5000, 5000, (d,), torch.int32)
        spec = RequantSpec.per_tensor(fit_dyadic(1 / 3000.0, d * 127 * 127),
                                      out_bits=8)
        got = int8_matmul(x8, w8, spec, bias32=bias)
        want = int8_matmul_plain(x8, w8, spec, bias32=bias)
        record(rows, "int8_matmul", f"per-tensor+bias M={m} K={d} N={d}",
               got, want, lambda: int8_matmul(x8, w8, spec, bias32=bias),
               lambda: int8_matmul_plain(x8, w8, spec, bias32=bias),
               m * d + d * d + 4 * d + m * d, 2 * m * d * d,
               plan=k1_plan(m, d, d, x8=x8, w=w8))
        # the raw logits head
        w8 = _randint(gen, -127, 128, (d, v), torch.int8)
        raw = RequantSpec.raw()
        got = int8_matmul(x8, w8, raw)
        want = int8_matmul_plain(x8, w8, raw)
        record(rows, "int8_matmul", f"head raw M={m} K={d} N={v}", got,
               want, lambda: int8_matmul(x8, w8, raw),
               lambda: int8_matmul_plain(x8, w8, raw),
               m * d + d * v + 4 * m * v, 2 * m * d * v,
               lib_ms=int_mm_ms(x8, w8), rep=(m == 4), iters=10,
               plan=k1_plan(m, v, d, x8=x8, w=w8))
        del w8

    # K2: RMSNorm rows of the residual stream (a decode step, a prefill
    # chunk), its edges, the empty launch it is judged against at 4 rows
    # and its sqrt on every int32
    gamma = _randint(gen, 40, 128, (d,), torch.int32)
    for r in (4, 128):
        q = _randint(gen, -cfg.qmax_res, cfg.qmax_res + 1, (r, d),
                     torch.int32)
        k2_row(rows, "rmsnorm", q, gamma, None, plans.norm, rep=(r == 4))
    check_k2_edges(gen, cfg, rows)
    empty_kernel_row()
    isqrt_check()

    # K3/K4: paged attention over a permuted page table, ragged lengths:
    # the decode step, the verify step of a spec_k = 3 engine (Sq = 4,
    # valid = pos + n_new: stepped lanes, and a lane at valid 1, as an idle
    # lane or a first token gives it, whose rows 0..2 see no key), the
    # prefill chunk
    aplan = plans.attn.attn
    requant = RequantSpec.per_tensor(aplan.dn_out)
    wo, wo_spec = paged_attention_rows(
        gen, rows, cfg, plans, (
            ("int_decode_attention", 1, [1, 137, 300, 512], ""),
            ("int_decode_attention", VERIFY_SQ, [4, 137, 300, 512],
             "verify "),
            ("int_decode_attention", VERIFY_SQ, [1, 137, 300, 512],
             "verify "),
            ("int_paged_prefill", 32, [32, 100 + 32, 250 + 32, 512], "")),
        rep=True)
    # K3's and K4's exp16 division on its whole domain for llama's plan
    division_check("int_decode_attention", aplan)
    check_packed_kernels(gen, rows, aplan, requant, wo, wo_spec, h, hkv, hd,
                         d, "", verify=True)
    check_k4_edges(gen, plans, rows)
    return rows


def kv4_bound(lens, sq: int, h: int, hkv: int, d: int, ps: int, maxp: int,
              fold_n: int = 0):
    """:func:`k4_bound` over packed int4 pools (an int8 tile written):
    each live K / V row read at D / 2 bytes, plus 8 bytes of K and V
    shifts a page touched.  ``fold_n``: the folded o-projection's N (wo
    and its multipliers read, (B, sq, N) int32 written in place of the
    tile, 2 x H x D x N operations a row)."""
    b = len(lens)
    nbytes, ops = k4_bound(lens, sq, h, hkv, d, b * maxp, 1)
    nbytes += 8 * sum(-(-n // ps) for n in lens) - sum(lens) * hkv * d
    if fold_n:
        nbytes += h * d * fold_n + 4 * fold_n + 4 * b * sq * fold_n \
            - b * sq * h * d
        ops += 2 * b * sq * h * d * fold_n
    return nbytes, ops


def check_packed_kernels(gen, rows, aplan, requant, wo, wo_spec, h: int,
                         hkv: int, hd: int, d: int, tag: str,
                         verify: bool = False,
                         folds=(False, True)) -> None:
    """K3 and K4 over packed int4 pools (``kv_shifts``) at the serve
    shapes: the lanes, lengths and 16-row pages of the int8 rows, pool
    bytes from all 256 values, per-page K and V shifts drawn apart from
    0..7, wo folded and not (``folds``); ``verify``: K3 also at the verify
    step's Sq and lengths (:func:`check_kernels`).  The folded rows (``tag``
    empty) of Sq 1 and of the prefill chunk are the summary rows of
    ``int_decode_attention_kv4`` and ``int_paged_prefill_kv4``."""
    import torch
    from repro_torch.kernels.int_attention_fused import (
        int_paged_prefill_fused, int_paged_prefill_plain)
    from repro_torch.kernels.int_decode_attention import (
        int_decode_attention_fused, int_decode_attention_plain)
    b, ps, maxp = 4, 16, 32
    num_pages = b * maxp + 1
    kp = _randint(gen, -128, 128, (num_pages, ps, hkv, hd // 2), torch.int8)
    vp = _randint(gen, -128, 128, (num_pages, ps, hkv, hd // 2), torch.int8)
    shifts = tuple(_randint(gen, 0, 8, (num_pages,), torch.int32)
                   for _ in range(2))
    pages = (torch.randperm(num_pages - 1, generator=gen, device="cuda")
             + 1).to(torch.int32).reshape(b, maxp)
    k3_cases = [(1, [1, 137, 300, 512], "")]
    if verify:
        k3_cases += [(VERIFY_SQ, [4, 137, 300, 512], "verify "),
                     (VERIFY_SQ, [1, 137, 300, 512], "verify ")]
    cases = [("int_decode_attention_kv4", int_decode_attention_fused,
              int_decode_attention_plain, sq, lens, pre)
             for sq, lens, pre in k3_cases]
    cases.append(("int_paged_prefill_kv4", int_paged_prefill_fused,
                  int_paged_prefill_plain, 32, [32, 100 + 32, 250 + 32, 512],
                  ""))
    for name, fused, plain, sq, lens, pre in cases:
        k4 = name == "int_paged_prefill_kv4"
        q8 = _randint(gen, -127, 128, (b, sq, h, hd), torch.int8)
        vl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        for fold in folds:
            kw = dict(requant=requant, kv_shifts=shifts)
            if fold:
                kw.update(wo=wo, wo_spec=wo_spec)
            args = (q8, kp, vp, aplan, vl, pages, ps)
            nbytes, ops = kv4_bound(lens, sq, h, hkv, hd, ps, maxp,
                                    d if fold else 0)
            record(rows, name, f"{tag}{pre}B={b} S={sq} H={h} Hkv={hkv} "
                   f"D={hd} ps={ps} pages/lane={maxp} valid={lens} "
                   f"fold_wo={fold} int4 shifts 0..7", fused(*args, **kw),
                   plain(*args, **kw), lambda: fused(*args, **kw),
                   lambda: plain(*args, **kw), nbytes, ops,
                   rep=fold and not tag and not pre, iters=10,
                   plain_iters=2,
                   plan=(k4_plan(q8, kp, pages, ps, aplan, packed=True)
                         if k4 else
                         k3_plan(q8, kp, vp, dict(kw, pages=pages,
                                                  page_size=ps))))
        del q8


def msr4_plan_str(m: int, n: int, k: int, qw, gather: bool = False) -> str:
    """The correction's launch on this card: ``msr4_plan``'s route, or
    with ``gather`` the gather route's plan at the same shape."""
    import torch
    from repro_torch.kernels.int8_matmul import msr4_gather_plan, msr4_plan
    meta = qw.pack_meta
    p = (msr4_gather_plan if gather else msr4_plan)(
        m, n, k, meta.group, meta.n_outliers,
        torch.cuda.get_device_properties(0).multi_processor_count)
    return (f"{p.route} {p.mt}x128 splits={p.grid[2]} kc={p.kc} "
            f"smem={p.smem}")


def msr4_gather_yardstick(acc, x8, qw, spec, want, dense, iters):
    """The gather route at a shape where ``msr4_plan`` chose the tensor
    cores: held exact against the plain version, then timed (device ms a
    call); and, where M > 16, ``torch._int_mm`` over the dense (K, N)
    delta matrix (a layout the port does not store).  Returns the extra
    keys of the row and the library time."""
    import torch
    from repro_torch.kernels.int8_matmul import _msr4_launch, msr4_gather_plan
    m, k = x8.shape
    n = qw.n_dim
    meta = qw.pack_meta
    plan = msr4_gather_plan(
        m, n, k, meta.group, meta.n_outliers,
        torch.cuda.get_device_properties(0).multi_processor_count)
    err = max_abs_diff(_msr4_launch(acc, x8, qw, spec, plan), want)
    if err:
        raise AssertionError(f"int8_matmul_msr4 gather route M={m} K={k} "
                             f"N={n}: != plain (max |diff| {err})")
    gather = lambda: _msr4_launch(acc, x8, qw, spec, plan)
    lib_ms = None
    if m > 16:
        delta = (dense.to(torch.int16) - dense.clamp(-7, 7)).to(torch.int8)
        lib_ms = int_mm_ms(x8, delta)
        del delta
    return {"gather_ms": device_ms(gather, iters) or time_ms(gather, iters),
            "gather_plan": msr4_plan_str(m, n, k, qw, gather=True),
            "mma_ops_bound_ms": 2 * m * k * n / INT8_OPS_PER_S * 1e3}, lib_ms


def _q_weights(gen, k: int, n: int):
    """int8 (k, n) weights as the port quantizes a Gaussian layer
    (per-channel abs-max to +-127, ``quant/convert.py::_q_linear``): most
    of them outside [-7, 7], so msr4 takes n_outliers = group."""
    import torch
    w = torch.randn((k, n), generator=gen, device="cuda")
    s = w.abs().amax(dim=0).clamp(min=1e-8) / 127.0
    return torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)


def _packed(w8, scheme: str, group: int = PACK_GROUP, b_vec=None,
            bias=None):
    from repro_torch.ops.spec import QuantLinearParams
    from repro_torch.quant.pack import pack_linear
    return pack_linear(QuantLinearParams(w8, b_vec, bias), scheme, group)


def packed_bounds(m: int, k: int, n: int, spec, qw, corr: bool):
    """Bytes and operations of K1's nibble launch (``corr`` False: x, the
    K / 2 x N nibbles, bias / multipliers read, the output written; 2 x M
    x K x N operations) or of the correction (the raw accumulator, x, the
    lanes, bias / multipliers read, the output written; 2 operations a
    row and lane that carries a delta)."""
    import torch
    out_b = 4 if spec.is_raw or spec.out_bits > 8 else 1
    vecs = 4 * n * ((qw.bias32 is not None) + (spec.kind == "per_channel"))
    if not corr:
        return m * k + k // 2 * n + vecs + out_b * m * n, 2 * m * k * n
    lanes = qw.out_val.numel()
    nnz = int(torch.count_nonzero(qw.out_val))
    return (4 * m * n + m * k + 3 * lanes + vecs + out_b * m * n,
            2 * m * nnz)


def check_packed_matmul_kernels(cfg, plans, rows) -> None:
    """K1 over packed weights and the MSR-4 correction against their
    plain versions.  llama3-8b's shapes with Gaussian-quantized weights
    packed msr4 at group 64 (the raw nibble launch, then the correction:
    w1 and w2 at M = 4, w1 at M = 128, the raw head at M = 4 and 128) and
    int4 weights drawn in [-7, 7] (one fused launch: w1 at M = 4, the
    summary row of ``int8_matmul_packed``; msr4 w1 at M = 4 is that of
    ``int8_matmul_msr4``); then the edges: M 1 / 5 / 16 / 17 / 33, K = 2
    mod 4, ragged N, operands 1 byte off alignment, split K, per-tensor +
    bias, msr4 groups 4 / 16 / 64 / 256 / K with n_outliers 0, 1 and g on
    the tensor cores and g = K = 2048 on the gather route, and on both
    routes filler lanes outside [0, g) with the operands aligned and 1
    byte off.  At the five full-width shapes the gather route runs too
    (:func:`msr4_gather_yardstick`)."""
    import torch
    from repro_torch.core.dyadic import fit_dyadic
    from repro_torch.kernels.int8_matmul import (
        int8_matmul_nibbles, int8_matmul_nibbles_plain, int8_matmul_packed,
        int8_matmul_plain, msr4_correct, msr4_correct_plain)
    from repro_torch.ops.spec import RequantSpec
    gen = torch.Generator(device="cuda").manual_seed(4321)
    d, f, v = cfg.d_model, cfg.d_ff, cfg.padded_vocab()
    raw = RequantSpec.raw()

    def both(tag, x8, qw, spec, rep_nib=False, rep_corr=False, dense=None,
             iters=20, yardstick=False):
        m, k = x8.shape
        n = qw.n_dim
        meta = qw.pack_meta
        two = meta.scheme == "msr4" and meta.n_outliers > 0
        nspec = raw if two else spec
        bias, bvec = (None, None) if two else (qw.bias32, qw.b_mult)
        got = int8_matmul_nibbles(x8, qw.w_packed, nspec, bias, bvec)
        want = int8_matmul_nibbles_plain(x8, qw.w_packed, nspec, bias, bvec)
        nb, no = packed_bounds(m, k, n, nspec, qw._replace(bias32=bias),
                               False)
        record(rows, "int8_matmul_packed",
               f"{tag} {'raw nibbles' if two else 'nibbles'} M={m} K={k} "
               f"N={n} {meta.scheme} g={meta.group} "
               f"n_out={meta.n_outliers} {nspec.kind}", got, want,
               lambda: int8_matmul_nibbles(x8, qw.w_packed, nspec, bias,
                                           bvec),
               lambda: int8_matmul_nibbles_plain(x8, qw.w_packed, nspec,
                                                 bias, bvec),
               nb, no, rep=rep_nib, iters=iters, plain_iters=2,
               plan=k1_plan(m, n, k, True, x8, qw.w_packed))
        if meta.scheme == "msr4":
            acc = got
            got = msr4_correct(acc, x8, qw, spec)
            want = msr4_correct_plain(acc, x8, qw, spec)
            nb, no = packed_bounds(m, k, n, spec, qw, True)
            extra, lib_ms = (msr4_gather_yardstick(acc, x8, qw, spec, want,
                                                   dense, iters)
                             if yardstick else (None, None))
            record(rows, "int8_matmul_msr4",
                   f"{tag} correction M={m} K={k} N={n} g={meta.group} "
                   f"n_out={meta.n_outliers} {spec.kind}", got, want,
                   lambda: msr4_correct(acc, x8, qw, spec),
                   lambda: msr4_correct_plain(acc, x8, qw, spec), nb, no,
                   lib_ms=lib_ms, rep=rep_corr, iters=iters, plain_iters=2,
                   plan=msr4_plan_str(m, n, k, qw), extra=extra)
        if dense is not None:
            whole = int8_matmul_packed(x8, qw, spec)
            err = max_abs_diff(whole, int8_matmul_plain(
                x8, dense, spec, qw.bias32, qw.b_mult))
            if err:
                raise AssertionError(f"int8_matmul_packed {tag}: != the "
                                     f"dense product (max |diff| {err})")

    # llama3-8b's shapes (M = 4 and 16: the decode tile)
    for tag, k, n, lp, ms in (("w1", d, f, plans.ffn.up, (4, 16, 128)),
                              ("w2", f, d, plans.ffn.down, (4, 16)),
                              ("head raw", d, v, None, (4, 16, 128))):
        w8 = _q_weights(gen, k, n)
        spec = raw if lp is None else RequantSpec.for_linear(lp)
        b_vec = None if lp is None else _randint(gen, 256, 4096, (n,),
                                                 torch.int32)
        qw = _packed(w8, "msr4", b_vec=b_vec)
        for m in ms:
            x8 = _randint(gen, -127, 128, (m, k), torch.int8)
            both(tag, x8, qw, spec, rep_corr=(tag == "w1" and m == 4),
                 dense=w8, iters=10 if tag.startswith("head") else 20,
                 yardstick=m != 16)
        del w8, qw
        if tag == "w1":
            w4 = _randint(gen, -7, 8, (k, n), torch.int8)
            q4 = _packed(w4, "int4", b_vec=b_vec)
            for m in (4, 16):
                x8 = _randint(gen, -127, 128, (m, k), torch.int8)
                both("w1", x8, q4, spec, rep_nib=m == 4, dense=w4)
            del w4, q4
    # the edges
    pt = RequantSpec.per_tensor(fit_dyadic(1 / 3000.0, 1 << 26))
    pc = RequantSpec.per_channel(24, 10, 11)
    for m in (1, 5, 16, 17, 33):
        for k, n in ((130, 260), (4096, 96)):
            w8 = _randint(gen, -128, 128, (k, n), torch.int8)
            bias = _randint(gen, -5000, 5000, (n,), torch.int32)
            b_vec = _randint(gen, 256, 4096, (n,), torch.int32)
            x8 = _randint(gen, -128, 128, (m, k), torch.int8)
            for scheme, w in (("msr4", w8), ("int4", w8.clamp(-7, 7))):
                qw = _packed(w, scheme, 16, b_vec, bias)
                for spec in (pt, pc):
                    both(f"edge {spec.kind}+bias", x8, qw, spec, dense=w,
                         iters=5)
    for tag, m, k, n in (("1 byte off", 17, 302, 100),
                         ("1 byte off", 4, 302, 100),
                         ("split K", 4, 8192, 256),
                         ("split K", 128, 4096, 128)):
        w8 = _randint(gen, -128, 128, (k, n), torch.int8)
        qw = _packed(w8, "msr4", 64 if k % 64 == 0 else 302)
        x8 = _randint(gen, -128, 128, (m, k), torch.int8)
        if tag == "1 byte off":
            x8 = _offset_view(x8, 1)
            qw = qw._replace(w_packed=_offset_view(qw.w_packed, 1))
        both(tag, x8, qw, raw, dense=w8, iters=5)
    k, n = 512, 300
    x8 = _randint(gen, -128, 128, (5, k), torch.int8)
    for g in (4, 16, 64, 256, 100):             # 100: g = K
        gg = g if k % g == 0 else k
        lo = _randint(gen, -7, 8, (k, n), torch.int8)
        one = lo.clone()
        rows_ = torch.arange(0, k, gg, device="cuda")
        one[rows_ + (rows_ // gg) % gg, ::2] = -128
        full = (_randint(gen, 8, 128, (k, n), torch.int32)
                * (2 * _randint(gen, 0, 2, (k, n), torch.int32) - 1)
                ).clamp(-128, 127).to(torch.int8)
        b_vec = _randint(gen, 256, 4096, (n,), torch.int32)
        for w, want_out in ((lo, 0), (one, 1), (full, gg)):
            qw = _packed(w, "msr4", g, b_vec)
            if qw.pack_meta.n_outliers != want_out:
                raise AssertionError(f"msr4 g={g}: n_outliers "
                                     f"{qw.pack_meta.n_outliers} != "
                                     f"{want_out}")
            acc = int8_matmul_nibbles(x8, qw.w_packed, raw)
            got = msr4_correct(acc, x8, qw, pc)
            want = msr4_correct_plain(acc, x8, qw, pc)
            nb, no = packed_bounds(5, k, n, pc, qw, True)
            record(rows, "int8_matmul_msr4",
                   f"edge correction M=5 K={k} N={n} g={gg} "
                   f"n_out={want_out} per_channel", got, want,
                   lambda: msr4_correct(acc, x8, qw, pc),
                   lambda: msr4_correct_plain(acc, x8, qw, pc), nb, no,
                   iters=5, plain_iters=1, plan=msr4_plan_str(5, n, k, qw))
            err = max_abs_diff(int8_matmul_packed(x8, qw, pc),
                               int8_matmul_plain(x8, w, pc, None, b_vec))
            if err:
                raise AssertionError(f"msr4 g={g} n_out={want_out}: packed "
                                     f"!= dense (max |diff| {err})")
    check_msr4_route_edges(gen, rows, pc)


def check_k1_decode(cfg, wcfg, plans, wplans) -> None:
    """The ``k1-decode`` phase: K1's decode rows alone, every llama3-8b
    and h2o-danube-3-4b decode projection at M = 4 and 16 (dense with its
    epilogue; llama's per-tensor + bias and raw heads; the nibble launch
    of int4 w1, fused, and of msr4 w1 / w2 / head, raw), each held exact
    against its plain version, then its device ms (profiler), call ms
    (CUDA events) and host ms (the wrapper's issue time a call).  It
    calls only the wrappers and their plain versions, so the same script
    times another tree's kernels on the same seeded operands (an A/B of
    two commits in one call)."""
    import torch
    from repro_torch.core.dyadic import fit_dyadic
    from repro_torch.kernels.int8_matmul import (
        int8_matmul, int8_matmul_nibbles, int8_matmul_nibbles_plain,
        int8_matmul_plain)
    from repro_torch.ops.spec import RequantSpec
    gen = torch.Generator(device="cuda").manual_seed(2468)
    raw = RequantSpec.raw()
    rows = {}
    for arch, c, pl in (("llama3-8b", cfg, plans), ("h2o", wcfg, wplans)):
        d, f, v = c.d_model, c.d_ff, c.padded_vocab()
        hd, h, hkv = c.hd, c.n_heads, c.n_kv_heads
        cases = [("wq", d, h * hd, RequantSpec.for_linear(pl.attn.qkv)),
                 ("wk", d, hkv * hd, RequantSpec.for_linear(pl.attn.qkv)),
                 ("w1", d, f, RequantSpec.for_linear(pl.ffn.up)),
                 ("w2", f, d, RequantSpec.for_linear(pl.ffn.down)),
                 ("wo", h * hd, d, RequantSpec.for_linear(pl.attn.out)),
                 ("head raw", d, v, raw)]
        if arch == "llama3-8b":
            cases.insert(5, ("per-tensor+bias", d, d, RequantSpec.per_tensor(
                fit_dyadic(1 / 3000.0, d * 127 * 127), out_bits=8)))
            cases += [("int4 w1 nibbles", d, f,
                       RequantSpec.for_linear(pl.ffn.up)),
                      ("msr4 w1 raw nibbles", d, f, raw),
                      ("msr4 w2 raw nibbles", f, d, raw),
                      ("msr4 head raw nibbles", d, v, raw)]
        for tag, k, n, spec in cases:
            nib = "nibbles" in tag
            w = _randint(gen, -128, 128, (k // 2 if nib else k, n),
                         torch.int8)
            b_vec = (_randint(gen, 256, 4096, (n,), torch.int32)
                     if spec.kind == "per_channel" else None)
            bias = (_randint(gen, -5000, 5000, (n,), torch.int32)
                    if "bias" in tag else None)
            fn, plain = ((int8_matmul_nibbles, int8_matmul_nibbles_plain)
                         if nib else (int8_matmul, int8_matmul_plain))
            out_b = 4 if spec.is_raw or spec.out_bits > 8 else 1
            vecs = 4 * n * ((b_vec is not None) + (bias is not None))
            for m in (4, 16):
                x8 = _randint(gen, -127, 128, (m, k), torch.int8)
                args = (x8, w, spec, bias, b_vec)
                record(rows, "int8_matmul_packed" if nib else "int8_matmul",
                       f"k1-decode {arch} {tag} M={m} K={k} N={n} "
                       f"{spec.kind}", fn(*args), plain(*args),
                       lambda: fn(*args), lambda: plain(*args),
                       m * k + w.numel() + vecs + out_b * m * n,
                       2 * m * k * n, iters=50, plain_iters=2,
                       extra={"host_ms": host_ms(lambda: fn(*args), 50)})
            del w


def check_k3_decode(cfg, wcfg, plans, wplans) -> None:
    """The ``k3-decode`` phase: K3's rows alone, each held exact against
    its plain version, then its device ms (profiler), call ms (CUDA
    events) and host ms (the wrapper's issue time a call): llama3-8b's
    serve row (4 lanes over 32 pages of 16, valid 1 / 137 / 300 / 512),
    unfolded and with wo folded, over int8 and packed int4 pools, the
    serve traffic's decode lengths (<= 232 positions) and the profiled
    decode window's (9-15, int8 and int4), Sq 8; h2o-danube-3-4b
    (D 120) on the contiguous cache at L 512 and the full 4096-position
    window, folded and not, Sq 8, and over pools; a 32 768-position table
    (the streaming route).  It calls only the wrappers and their plain
    versions, so the same script times another tree's kernels on the
    same seeded operands (an A/B of two commits in one call)."""
    import torch
    from repro_torch.kernels.int_decode_attention import (
        int_decode_attention_fused, int_decode_attention_plain)
    from repro_torch.ops.spec import QuantLinearParams, RequantSpec
    gen = torch.Generator(device="cuda").manual_seed(3579)
    rows = {}
    serve = [1, 137, 300, 512]
    # (arch, tag, Sq, layout, L, valid, fold)
    cases = [("llama3-8b", "serve", 1, "paged", 512, serve, False),
             ("llama3-8b", "serve", 1, "paged", 512, serve, True),
             ("llama3-8b", "kv4 serve", 1, "kv4", 512, serve, False),
             ("llama3-8b", "kv4 serve", 1, "kv4", 512, serve, True),
             ("llama3-8b", "step lengths", 1, "paged", 512,
              [40, 120, 200, 232], False),
             ("llama3-8b", "short lanes", 1, "paged", 512,
              [9, 11, 13, 15], False),
             ("llama3-8b", "kv4 short lanes", 1, "kv4", 512,
              [9, 11, 13, 15], False),
             ("llama3-8b", "Sq=8", 8, "paged", 512, [8, 137, 300, 512],
              False),
             ("llama3-8b", "long table", 1, "paged", 32768,
              [32768, 20000, 5000, 1], False),
             ("h2o", "L=512", 1, "contiguous", 512, serve, False),
             ("h2o", "L=512", 1, "contiguous", 512, serve, True),
             ("h2o", "full window", 1, "contiguous", 4096, [4096] * 4,
              False),
             ("h2o", "full window", 1, "contiguous", 4096, [4096] * 4,
              True),
             ("h2o", "Sq=8", 8, "contiguous", 512, [8, 137, 300, 512],
              False),
             ("h2o", "paged L=512", 1, "paged", 512, serve, False)]
    b, ps = 4, 16
    for arch, tag, sq, layout, L, lens, fold in cases:
        c, pl = (cfg, plans) if arch == "llama3-8b" else (wcfg, wplans)
        d, hd, h, hkv = c.d_model, c.hd, c.n_heads, c.n_kv_heads
        aplan = pl.attn.attn
        kw = dict(requant=RequantSpec.per_tensor(aplan.dn_out))
        q8 = _randint(gen, -127, 128, (b, sq, h, hd), torch.int8)
        if layout == "contiguous":
            k8, v8 = (_randint(gen, -127, 128, (b, L, hkv, hd), torch.int8)
                      for _ in range(2))
            nbytes, ops = k4_bound(lens, sq, h, hkv, hd, 0, 1)
        else:
            maxp = L // ps
            num = b * maxp + 1
            w = hd // 2 if layout == "kv4" else hd
            k8, v8 = (_randint(gen, -128, 128, (num, ps, hkv, w), torch.int8)
                      for _ in range(2))
            kw.update(pages=(torch.randperm(num - 1, generator=gen,
                                            device="cuda") + 1)
                      .to(torch.int32).reshape(b, maxp), page_size=ps)
            if layout == "kv4":
                kw["kv_shifts"] = tuple(
                    _randint(gen, 0, 8, (num,), torch.int32)
                    for _ in range(2))
                nbytes, ops = kv4_bound(lens, sq, h, hkv, hd, ps, maxp)
            else:
                nbytes, ops = k4_bound(lens, sq, h, hkv, hd, b * maxp, 1)
        if fold:
            kw.update(wo=QuantLinearParams(
                _randint(gen, -127, 128, (h * hd, d), torch.int8),
                _randint(gen, 256, 4096, (d,), torch.int32)),
                wo_spec=RequantSpec.for_linear(pl.attn.out))
            nbytes += h * hd * d + 4 * d + 4 * b * sq * d - b * sq * h * hd
            ops += 2 * b * sq * h * hd * d
        vl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        args = (q8, k8, v8, aplan, vl)
        name = ("int_decode_attention_kv4" if layout == "kv4"
                else "int_decode_attention")
        fn = lambda: int_decode_attention_fused(*args, **kw)
        record(rows, name, f"k3-decode {arch} {tag} B={b} Sq={sq} H={h} "
               f"Hkv={hkv} D={hd} {layout} L={L} valid={lens} "
               f"fold_wo={fold}", fn(),
               int_decode_attention_plain(*args, **kw), fn,
               lambda: int_decode_attention_plain(*args, **kw), nbytes, ops,
               iters=50, plain_iters=2, plan=k3_plan(q8, k8, v8, kw),
               extra={"host_ms": host_ms(fn, 50)})
        del q8, k8, v8, args, kw


def k2_plan(q, gamma, beta):
    """K2's launch for these operands (kernels/int_layernorm.py::
    launch_plan), or None in a tree that has no such plan (the ``k2-norm``
    phase also times older trees)."""
    import torch
    try:
        from repro_torch.kernels.int_layernorm import launch_plan
    except ImportError:
        return None
    d = q.shape[-1]
    ops = [t for t in (q, gamma, beta) if t is not None]
    return launch_plan(
        q.numel() // d, d,
        torch.cuda.get_device_properties(0).multi_processor_count,
        all(t.data_ptr() % 16 == 0 for t in ops)).describe()


def k2_row(rows, tag, q, gamma, beta, npl, rep=False, host=False):
    """One K2 row: exact against its plain version, then timed; the byte
    bound reads the rows and writes them once and reads gamma (and beta)
    once.  Per element ~16 int32 operations, far below the bytes at any
    rate.  ``host``: also the host ms a call (``host_ms``)."""
    from repro_torch.kernels.int_layernorm import (int_layernorm,
                                                   int_layernorm_plain)
    r, d = q.numel() // q.shape[-1], q.shape[-1]

    def fn():
        return int_layernorm(q, gamma, beta, npl)

    def plain():
        return int_layernorm_plain(q, gamma, beta, npl)

    record(rows, "int_layernorm", f"{tag} rows={r} d={d}", fn(), plain(),
           fn, plain, 8 * r * d + 4 * d * (1 + (beta is not None)), 0,
           rep=rep, iters=50, plan=k2_plan(q, gamma, beta),
           extra={"host_ms": host_ms(fn, 50)} if host else None)


def check_k2_edges(gen, cfg, rows, host=False) -> None:
    """K2 where its vectors narrow to one int: d % 4 != 0 on the warp
    route (128 x 1002, LayerNorm + beta) and the block route (4 x 4095,
    RMSNorm), and rows 4 bytes off 16-byte alignment at the decode and
    encode shapes (4 x 4096 RMSNorm, 16 384 x 768 LayerNorm + beta)."""
    import torch
    from repro_torch.core.norms import make_inorm
    for r, d, mean, off in ((128, 1002, True, 0), (4, 4095, False, 0),
                            (4, 4096, False, 1),
                            (ENCODE_BATCH * ENCODE_SEQ, 768, True, 1)):
        npl = make_inorm(d, cfg.s_res, cfg.qmax_res, 2.0 / 127.0,
                         cfg.s_act8, subtract_mean=mean)
        q = _randint(gen, -cfg.qmax_res, cfg.qmax_res + 1, (r, d),
                     torch.int32)
        if off:
            q = _offset_view(q, off)
        gamma = _randint(gen, 40, 128, (d,), torch.int32)
        beta = _randint(gen, -9000, 9000, (d,), torch.int32) if mean else None
        tag = (f"misaligned {4 * off} B" if off else "d % 4 != 0") + (
            " layernorm+beta" if mean else " rmsnorm")
        k2_row(rows, tag, q, gamma, beta, npl, host=host)


def empty_kernel_row() -> None:
    """An empty launch (one CTA of 32 threads, no work: ``r8_empty_kernel``)
    timed like a kernel row: the floor of a latency-bound launch from the
    port's wrappers, against which K2's 4-row rows are read.  A tree
    without it prints nothing."""
    import torch
    from repro_torch.kernels._build import library
    lib = library()
    if not hasattr(lib, "r8_empty_kernel"):
        return
    stream = torch.cuda.current_stream().cuda_stream

    def fn():
        return lib.r8_empty_kernel(stream)

    emit({"phase": "kernels", "name": "empty_kernel",
          "case": "one CTA of 32 threads, no work", "ms": device_ms(fn, 50),
          "call_ms": time_ms(fn, 50), "host_ms": host_ms(fn, 50)})


def isqrt_check() -> None:
    """K2's O(1) integer sqrt against the reference's 16 Newton steps on
    every n in [-1, 2^31), on the card.  A tree without it prints
    nothing."""
    try:
        from repro_torch.kernels.int_layernorm import isqrt_mismatches
    except ImportError:
        return
    bad = isqrt_mismatches()
    emit({"phase": "kernels", "name": "int_layernorm",
          "case": "isqrt_fast == isqrt16 on every n in [-1, 2^31)",
          "mismatches": bad})
    if bad:
        raise AssertionError(f"int_layernorm: isqrt_fast differs from the "
                             f"16-step sqrt on {bad} values")


def check_k2_norm(cfg, ecfg, wcfg) -> None:
    """The ``k2-norm`` phase: K2's rows alone, at every shape a path runs
    (llama3-8b's RMSNorm at 4 and 128 rows of 4096, h2o-danube-3-4b's at
    4 and 1024 of 3840, roberta-base's LayerNorm + beta at 128 and
    16 384 of 768) and its edges, each exact against its plain version,
    with device, call and host ms, after the empty launch and the sqrt
    check.  It calls only the wrappers and their plain versions, so the
    same script times another tree's kernel on the same seeded operands
    (an A/B of two commits in one call)."""
    import torch
    from repro_torch.quant import plans as qplans
    gen = torch.Generator(device="cuda").manual_seed(2580)
    rows = {}
    empty_kernel_row()
    isqrt_check()
    for tag, c, shapes in (("llama3-8b rmsnorm", cfg, (4, 128)),
                           ("h2o rmsnorm", wcfg, (4, 1024)),
                           ("roberta-base layernorm+beta", ecfg,
                            (128, ENCODE_BATCH * ENCODE_SEQ))):
        npl = qplans.build_layer_plans(c).norm
        d = c.d_model
        gamma = _randint(gen, 40, 128, (d,), torch.int32)
        beta = (_randint(gen, -9000, 9000, (d,), torch.int32)
                if npl.subtract_mean else None)
        for r in shapes:
            q = _randint(gen, -c.qmax_res, c.qmax_res + 1, (r, d),
                         torch.int32)
            k2_row(rows, f"k2-norm {tag}", q, gamma, beta, npl, host=True)
    check_k2_edges(gen, cfg, rows, host=True)


def k7_plan(x, valid_len: int):
    """K7's launch for these scores (kernels/int_softmax.py::launch_plan),
    or None in a tree that has no such plan (the ``k7-softmax`` phase also
    times older trees)."""
    try:
        from repro_torch.kernels.int_softmax import launch_plan
    except ImportError:
        return None
    L = x.shape[-1]
    return launch_plan(x.numel() // L, L, valid_len,
                       x.data_ptr() % 16 == 0).describe()


def check_k7_softmax(ecfg) -> None:
    """The ``k7-softmax`` phase: K7's rows alone, each exact against its
    plain version, with device, call and host ms and its plan, after the
    empty launch and exp16's division for the plan every row launches
    with (roberta-base's attention plan, the ``ops`` phase's).  The byte
    bound reads a row's live scores once and writes every probability
    once; ~30 int32 operations an element are not counted.  It calls only
    the wrappers and their plain versions, so the same script times
    another tree's kernel on the same seeded scores (an A/B of two
    commits in one call)."""
    import torch
    from repro_torch.kernels.int_softmax import (int_softmax,
                                                 int_softmax_plain)
    from repro_torch.quant import plans as qplans
    aplan = qplans.build_layer_plans(ecfg).attn.attn
    sm = aplan.sm
    gen = torch.Generator(device="cuda").manual_seed(2471)
    rows = {}
    empty_kernel_row()
    division_check("int_softmax", aplan)
    full = (ENCODE_BATCH, ecfg.n_heads, ENCODE_SEQ, ENCODE_SEQ)
    cases = [
        # (tag, shape, valid_len, fill: None (random), "equal", or an
        # element offset off 16-byte alignment)
        ("roberta-base scores", full, -1, None),
        ("roberta-base scores, padded", full, 300, None),
        ("bench_kernels", (256, 1024), -1, None),
        ("2^15-long rows", (4, 1 << 15), -1, None),
        ("L % 4 != 0", (1000, 37), -1, None),
        ("L % 4 != 0", (37, 1023), 500, None),
        ("misaligned 4 B", (4096, 512), -1, 1),
        ("misaligned 4 B", (4, 1 << 15), 30000, 1),
        ("valid_len 0", (256, 512), 0, None),
        ("valid_len 1", (256, 512), 1, None),
        ("L = 1", (1024, 1), -1, None),
        ("L = 1024", (256, 1024), 700, None),
        ("L = 1025", (64, 1025), -1, None),
        ("all-equal rows", (256, 512), -1, "equal"),
    ]
    for tag, shape, vl, fill in cases:
        if fill == "equal":
            x = torch.full(shape, 777, dtype=torch.int32, device="cuda")
        else:
            x = _randint(gen, -100000, 100000, shape, torch.int32)
            if fill:
                x = _offset_view(x, fill)
        n, length = x.numel(), shape[-1]
        read = n if vl < 0 else n // length * min(vl, length)

        def fn():
            return int_softmax(x, sm, vl)

        def plain():
            return int_softmax_plain(x, sm, vl)

        record(rows, "int_softmax", f"k7-softmax {tag} "
               f"{'x'.join(map(str, shape))} valid_len={vl}", fn(), plain(),
               fn, plain, 4 * read + n, 0, iters=20, plain_iters=2,
               plan=k7_plan(x, vl), extra={"host_ms": host_ms(fn, 20)})
        del x


def check_msr4_route_edges(gen, rows, pc) -> None:
    """The correction on both routes at their edges: the gather route
    (g = K = 2048) with n_outliers 0, 1 and g at M = 5 and 17; then on
    each route (g = 64 and g = K = 2048, N = 320) filler lanes outside [0,
    g) (index g, -1, 32767: they add nothing) at M = 4 and 17, with every
    operand aligned for the 16-byte copies or 1 byte off (x and the
    deltas 1 byte, the indices 2, acc 4)."""
    import torch
    from repro_torch.kernels.int8_matmul import (
        int8_matmul_nibbles, int8_matmul_packed, int8_matmul_packed_plain,
        msr4_correct, msr4_correct_plain)
    from repro_torch.ops.spec import RequantSpec
    raw = RequantSpec.raw()

    def one(tag, x8, qw, acc, route):
        m, k = x8.shape
        n = qw.n_dim
        plan = msr4_plan_str(m, n, k, qw)
        if not plan.startswith(route):
            raise AssertionError(f"msr4 {tag}: route {plan}, not {route}")
        got = msr4_correct(acc, x8, qw, pc)
        want = msr4_correct_plain(acc, x8, qw, pc)
        nb, no = packed_bounds(m, k, n, pc, qw, True)
        meta = qw.pack_meta
        record(rows, "int8_matmul_msr4",
               f"edge {tag} M={m} K={k} N={n} g={meta.group} "
               f"n_out={meta.n_outliers} per_channel", got, want,
               lambda: msr4_correct(acc, x8, qw, pc),
               lambda: msr4_correct_plain(acc, x8, qw, pc), nb, no,
               iters=5, plain_iters=1, plan=plan)
        err = max_abs_diff(int8_matmul_packed(x8, qw, pc),
                           int8_matmul_packed_plain(x8, qw, pc))
        if err:
            raise AssertionError(f"msr4 {tag}: packed != its plain version "
                                 f"(max |diff| {err})")

    k, n = 2048, 300
    b_vec = _randint(gen, 256, 4096, (n,), torch.int32)
    lo = _randint(gen, -7, 8, (k, n), torch.int8)
    one_ = lo.clone()
    one_[5, ::2] = -128
    full = (_randint(gen, 8, 128, (k, n), torch.int32)
            * (2 * _randint(gen, 0, 2, (k, n), torch.int32) - 1)
            ).clamp(-128, 127).to(torch.int8)
    for w, want_out in ((lo, 0), (one_, 1), (full, k)):
        qw = _packed(w, "msr4", 100, b_vec)     # 100 does not divide K
        if qw.pack_meta.n_outliers != want_out:
            raise AssertionError(f"msr4 g=K: n_outliers "
                                 f"{qw.pack_meta.n_outliers} != {want_out}")
        for m in (5, 17):
            x8 = _randint(gen, -128, 128, (m, k), torch.int8)
            acc = int8_matmul_nibbles(x8, qw.w_packed, raw)
            one("gather", x8, qw, acc, "gather")
    n = 320
    b_vec = _randint(gen, 256, 4096, (n,), torch.int32)
    for k, group, route in ((512, 64, "mma"), (2048, 100, "gather")):
        w8 = _randint(gen, -128, 128, (k, n), torch.int8)
        qw = _packed(w8, "msr4", group, b_vec)
        g = qw.pack_meta.group
        idx = qw.out_idx.clone()
        idx[0, 0, 3], idx[-1, -1, 5], idx[0, 1, 200] = g, -1, 32767
        qw = qw._replace(out_idx=idx)
        for m in (4, 17):
            x8 = _randint(gen, -128, 128, (m, k), torch.int8)
            acc = int8_matmul_nibbles(x8, qw.w_packed, raw)
            one("filler lanes aligned", x8, qw, acc, route)
            one("filler lanes 1 byte off", _offset_view(x8, 1),
                qw._replace(out_idx=_offset_view(qw.out_idx, 1),
                            out_val=_offset_view(qw.out_val, 1)),
                _offset_view(acc, 1), route)


def k4_bound(lens, c: int, h: int, hkv: int, d: int, table_ints: int,
             out_b: int):
    """K4's bytes and operations for chunk ``c`` at these pos_end (and
    K3's for ``c`` query rows at these valid lengths: the same stepped
    mask): q read and the tile written once (``out_b`` bytes an element),
    each live K / V row and the table read once; 4 x D operations a live
    (row, key) pair and head (Q·Kᵀ and P·V)."""
    pairs = sum(max(n - (c - 1 - i), 0) for n in lens for i in range(c))
    nbytes = (len(lens) * c * h * d * (1 + out_b) + sum(lens) * hkv * d * 2
              + 4 * (table_ints + len(lens)))
    return nbytes, 4 * pairs * h * d


def check_k4_edges(gen, plans, rows) -> None:
    """The tensor-core K4 against its plain version at its edges: head
    dims 32 / 64 / 128, chunks of 1, 7, 64 and 96 rows, 1-, 8- and
    64-row pages, lanes whose pos_end is below the chunk, a lane whose
    table is all the null page, every operand -128 / +127, pools and q 4
    bytes off 16-byte alignment, and a table spanning MAX_ROWSUM_LEN
    positions (sweep 2 recomputes), the epilogues taken in turn."""
    import torch
    from repro_torch.analysis.budgets import MAX_ROWSUM_LEN
    from repro_torch.kernels.int_attention_fused import (
        int_paged_prefill_fused, int_paged_prefill_plain)
    from repro_torch.ops.spec import RequantSpec
    aplan = plans.attn.attn
    epilogues = [RequantSpec.per_tensor(aplan.dn_out),
                 RequantSpec.per_channel(22, 8),
                 RequantSpec.per_channel(20, 6, out_bits=16),
                 RequantSpec.raw()]
    # (B, C, H, Hkv, D, page_size, max_pages, pos_end, operands)
    cases = [(4, 32, 8, 2, dd, 16, 32, [32, 132, 282, 512], "random")
             for dd in (32, 64, 128)]
    cases += [(4, c, 32, 8, 128, 16, 32, [c, 100 + c, 250 + c, 512],
               "random") for c in (1, 7, 64, 96)]
    cases += [(4, 32, 32, 8, 128, p, 512 // p, [32, 132, 282, 512],
               "random") for p in (1, 8, 64)]
    cases += [(4, 32, 32, 8, 128, 16, 32, [5, 32, 0, 300], "null_lane"),
              (2, 32, 8, 2, 128, 16, 8, [20, 128], "min"),
              (2, 32, 8, 2, 64, 16, 8, [20, 128], "max"),
              (4, 32, 32, 8, 128, 16, 32, [32, 132, 282, 512], "misaligned"),
              (2, 32, 4, 1, 128, 16, MAX_ROWSUM_LEN // 16,
               [MAX_ROWSUM_LEN, 20000], "random")]
    for i, (b, c, h, hkv, d, ps, maxp, lens, operands) in enumerate(cases):
        rq = epilogues[i % 4]
        num_pages = b * maxp + 1
        shape = (num_pages, ps, hkv, d)
        if operands in ("min", "max"):
            fill = -128 if operands == "min" else 127
            q8 = torch.full((b, c, h, d), fill, dtype=torch.int8,
                            device="cuda")
            kp = torch.full(shape, fill, dtype=torch.int8, device="cuda")
            vp = torch.full(shape, fill, dtype=torch.int8, device="cuda")
        else:
            q8 = _randint(gen, -127, 128, (b, c, h, d), torch.int8)
            kp = _randint(gen, -127, 128, shape, torch.int8)
            vp = _randint(gen, -127, 128, shape, torch.int8)
        if operands == "misaligned":
            q8, kp, vp = (_offset_view(x, 4) for x in (q8, kp, vp))
        pages = (torch.randperm(num_pages - 1, generator=gen, device="cuda")
                 + 1).to(torch.int32).reshape(b, maxp)
        if operands == "null_lane":
            pages[1] = 0
        vl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        bvec = _randint(gen, 1000, 20000, (h * d,), torch.int32)
        out_b = 1 if (not rq.is_raw and rq.out_bits <= 8) else 4
        nbytes, ops = k4_bound(lens, c, h, hkv, d, b * maxp, out_b)
        args = (q8, kp, vp, aplan, vl, pages, ps)
        kw = dict(requant=rq, b_vec=bvec)
        record(rows, "int_paged_prefill",
               f"B={b} C={c} H={h} Hkv={hkv} D={d} ps={ps} "
               f"pages/lane={maxp} pos_end={lens} {rq.kind}"
               f"{'' if rq.is_raw else f' {rq.out_bits}b'} {operands}",
               int_paged_prefill_fused(*args, **kw),
               int_paged_prefill_plain(*args, **kw),
               lambda: int_paged_prefill_fused(*args, **kw),
               lambda: int_paged_prefill_plain(*args, **kw),
               nbytes, ops, iters=5, plain_iters=2,
               plan=k4_plan(q8, kp, pages, ps, aplan))
        del q8, kp, vp, args


def _live_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs a full-sequence mask leaves live, per (b, h)."""
    if not causal and window <= 0:
        return sq * skv
    return sum(max((min(i + 1, skv) if causal else skv)
                   - max(i - window + 1 if window > 0 else 0, 0), 0)
               for i in range(sq))


def k5_row(gen, rows, aplan, b, sq, skv, hq, hkv, dd, causal, window, rq,
           operands, rep, tag=""):
    """One K5 row: (B, Sq, H, D) queries over (B, Skv, Hkv, D) keys drawn
    by :func:`_qkv` (``operands``), the mask and the epilogue ``rq``, exact
    against its plain version, then timed; the bound reads q, k and v once
    and writes the output once, and counts the live (query, key) pairs'
    Q·Kᵀ and P·V operations.  ``tag`` prefixes the case."""
    import torch
    from repro_torch.kernels.int_attention_fused import (
        int_attention_fused, int_attention_fused_plain)
    q8, k8, v8 = _qkv(gen, operands, b, sq, skv, hq, hkv, dd)
    bvec = _randint(gen, 1000, 20000, (hq * dd,), torch.int32)
    out_b = 1 if (not rq.is_raw and rq.out_bits <= 8) else 4
    nbytes = (b * sq * hq * dd + 2 * b * skv * hkv * dd
              + out_b * b * sq * hq * dd)
    ops = 4 * b * hq * dd * _live_pairs(sq, skv, causal, window)
    record(rows, "int_attention_fused",
           f"{tag}B={b} Sq={sq} Skv={skv} H={hq} Hkv={hkv} D={dd} "
           f"causal={causal} window={window} {rq.kind}"
           f"{'' if rq.is_raw else f' {rq.out_bits}b'} {operands}",
           int_attention_fused(q8, k8, v8, aplan, rq, bvec, causal, window),
           int_attention_fused_plain(q8, k8, v8, aplan, rq, bvec, causal,
                                     window),
           lambda: int_attention_fused(q8, k8, v8, aplan, rq, bvec, causal,
                                       window),
           lambda: int_attention_fused_plain(q8, k8, v8, aplan, rq, bvec,
                                             causal, window),
           nbytes, ops, rep=rep, iters=5, plain_iters=2,
           plan=k5_plan(q8, k8, causal, window, aplan))


def check_encoder_kernels(cfg, plans, rows) -> None:
    """K1 and K2 (LayerNorm) at the encoder path's shapes, K5 and K6 vs
    their plain versions.  Adds K5's and K6's representative rows (the
    encode pass's own launches) to ``rows``."""
    import torch
    from repro_torch.kernels.int8_matmul import (int8_matmul,
                                                 int8_matmul_plain)
    from repro_torch.kernels.int_gelu import int_gelu, int_gelu_plain
    from repro_torch.ops.spec import RequantSpec

    gen = torch.Generator(device="cuda").manual_seed(4321)
    d, f, v = cfg.d_model, cfg.d_ff, cfg.padded_vocab()
    tokens = ENCODE_BATCH * ENCODE_SEQ

    # K1: the encoder's projections over every token of a 32 x 512 pass,
    # and the raw tied head over the last positions
    x_cache = {}
    for tag, k, n, lp in (("wq", d, d, plans.attn.qkv),
                          ("w1", d, f, plans.ffn.up),
                          ("w2", f, d, plans.ffn.down)):
        x8 = x_cache.setdefault(k, _randint(gen, -127, 128, (tokens, k),
                                            torch.int8))
        w8 = _randint(gen, -127, 128, (k, n), torch.int8)
        b_vec = _randint(gen, 256, 4096, (n,), torch.int32)
        bias = _randint(gen, -5000, 5000, (n,), torch.int32)
        spec = RequantSpec.for_linear(lp)
        got = int8_matmul(x8, w8, spec, bias32=bias, b_vec=b_vec)
        want = int8_matmul_plain(x8, w8, spec, bias32=bias, b_vec=b_vec)
        out_b = 1 if spec.out_bits <= 8 else 4
        record(rows, "int8_matmul", f"encoder {tag} M={tokens} K={k} N={n} "
               f"per-channel+bias out_bits={spec.out_bits}", got, want,
               lambda: int8_matmul(x8, w8, spec, bias32=bias, b_vec=b_vec),
               lambda: int8_matmul_plain(x8, w8, spec, bias32=bias,
                                         b_vec=b_vec),
               tokens * k + k * n + 8 * n + out_b * tokens * n,
               2 * tokens * k * n, lib_ms=int_mm_ms(x8, w8), iters=10,
               plan=k1_plan(tokens, n, k))
    del x_cache
    x8 = _randint(gen, -127, 128, (ENCODE_BATCH, d), torch.int8)
    w8 = _randint(gen, -127, 128, (d, v), torch.int8)
    raw = RequantSpec.raw()
    record(rows, "int8_matmul", f"encoder tied head raw M={ENCODE_BATCH} "
           f"K={d} N={v}", int8_matmul(x8, w8, raw),
           int8_matmul_plain(x8, w8, raw),
           lambda: int8_matmul(x8, w8, raw),
           lambda: int8_matmul_plain(x8, w8, raw),
           ENCODE_BATCH * d + d * v + 4 * ENCODE_BATCH * v,
           2 * ENCODE_BATCH * d * v, lib_ms=int_mm_ms(x8, w8), iters=10,
           plan=k1_plan(ENCODE_BATCH, v, d))
    del w8

    # K2 in LayerNorm mode (mean subtracted, beta added): an encode pass's
    # rows and 128
    gamma = _randint(gen, 40, 128, (d,), torch.int32)
    beta = _randint(gen, -9000, 9000, (d,), torch.int32)
    for r in (tokens, 128):
        q = _randint(gen, -cfg.qmax_res, cfg.qmax_res + 1, (r, d),
                     torch.int32)
        k2_row(rows, "layernorm+beta", q, gamma, beta, plans.norm)

    # K5: the encoder's launch, then GQA causal / windowed, the other
    # epilogues and a cross-shaped launch; then the edge cases of the
    # tensor-core kernel (head dims 32 / 64 / 128 at ragged lengths, one
    # key, -128 / +127 operands, operands 4 bytes off 16-byte alignment, a
    # window wider than S, rows with no live key, key ranges too long for
    # the e16 store), the epilogues taken in turn
    aplan = plans.attn.attn
    per_tensor = RequantSpec.per_tensor(aplan.dn_out)
    epilogues = [per_tensor, RequantSpec.per_channel(22, 8),
                 RequantSpec.per_channel(20, 6, out_bits=16),
                 RequantSpec.raw()]
    h, hd = cfg.n_heads, cfg.hd
    k5_cases = [
        # (B, Sq, Skv, H, Hkv, D, causal, window, requant, operands, rep)
        (ENCODE_BATCH, ENCODE_SEQ, ENCODE_SEQ, h, h, hd, False, 0,
         per_tensor, "random", True),
        (4, 512, 512, 32, 8, 128, True, 0, per_tensor, "random", False),
        (4, 512, 512, 32, 8, 128, True, 128, per_tensor, "random", False),
        (8, ENCODE_SEQ, ENCODE_SEQ, h, h, hd, False, 0,
         RequantSpec.per_channel(22, 8), "random", False),
        (8, ENCODE_SEQ, ENCODE_SEQ, h, h, hd, False, 0, RequantSpec.raw(),
         "random", False),
        (ENCODE_BATCH, 64, ENCODE_SEQ, h, h, hd, False, 0, per_tensor,
         "random", False),
    ]
    edges = [(1, s_, s_, 4, 2, dd, causal, window, "random")
             for dd in (32, 64, 128)
             for s_, causal, window in ((1, False, 0), (37, True, 0),
                                        (100, True, 16), (1000, dd != 32,
                                                          100 if dd == 128
                                                          else 0))]
    edges += [(2, 37, 1, 4, 2, 64, True, 0, "random"),
              (2, 100, 100, 4, 2, 64, False, 0, "min"),
              (2, 100, 100, 4, 2, 128, True, 0, "max"),
              (2, 100, 70, 4, 1, 128, True, 8, "misaligned"),
              (1, 100, 100, 4, 4, 64, True, 300, "random"),
              (2, 200, 60, 4, 2, 32, True, 16, "random"),
              (1, 4096, 4096, 2, 1, 128, True, 0, "random"),
              (1, 64, 3000, 2, 2, 128, False, 0, "random")]
    k5_cases += [(*e[:8], epilogues[i % 4], e[8], False)
                 for i, e in enumerate(edges)]
    for case in k5_cases:
        k5_row(gen, rows, aplan, *case)

    # K5's exp16 division (a multiply-high) against `/` on its whole
    # domain (every K5 case above runs the encoder's plan)
    division_check("int_attention_fused", aplan)

    # K6: every 16-bit input, seeded int32 over the whole range (wrap),
    # then the FFN's 11-bit activations at the path shape (timed)
    gp = plans.ffn.act_gelu
    cases = [("all q in [-2^15, 2^15)",
              torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32,
                           device="cuda"), False),
             ("1e6 seeded int32", _randint(gen, -2 ** 31, 2 ** 31 - 1,
                                           (10 ** 6,), torch.int32), False),
             (f"FFN {tokens}x{f} 11-bit", _randint(gen, -1024, 1024,
                                                    (tokens, f),
                                                    torch.int32), True)]
    for case, q, rep in cases:
        record(rows, "int_gelu", case,
               int_gelu(q, gp.gelu, gp.dn_out), int_gelu_plain(
                   q, gp.gelu, gp.dn_out),
               lambda: int_gelu(q, gp.gelu, gp.dn_out),
               lambda: int_gelu_plain(q, gp.gelu, gp.dn_out),
               8 * q.numel(), 0, rep=rep, iters=20)


def online_spread(q8, k8, v8, aplan) -> None:
    """K8 is not exact attention: how far its integers sit from the exact
    kernel's (K5, the reference oracle's integers) on the encoder's
    inputs, unmasked and causal, and how much they move with the logical
    blocks (``bq`` matters only through the causal block skip)."""
    import torch
    from repro_torch.kernels.int_attention import int_attention_online
    from repro_torch.kernels.int_attention_fused import int_attention_fused

    def cmp(a, b):
        d = (a.to(torch.int32) - b.to(torch.int32)).abs()
        return {"differ": int((d > 0).sum()), "max_abs": int(d.max())}

    for causal in (False, True):
        exact = int_attention_fused(q8, k8, v8, aplan, causal=causal)
        out = {f"{bq}x{bkv}": int_attention_online(q8, k8, v8, aplan,
                                                   causal, 0, bq, bkv)
               for bq, bkv in ((128, 128), (128, 64), (64, 64), (256, 256))}
        emit({"phase": "online-spread", "shape": list(q8.shape),
              "causal": causal, "outputs": q8.numel(),
              "vs_exact": {k: cmp(o, exact) for k, o in out.items()},
              "between_blocks": {f"{x} vs {y}": cmp(out[x], out[y])
                                 for x, y in (("128x128", "128x64"),
                                              ("128x64", "64x64"),
                                              ("128x128", "256x256"))}})


def check_online_kernels(cfg, plans, rows) -> None:
    """K8 (one-pass online attention) and K7 (row softmax) against their
    plain versions at the ``pallas`` backend's shapes; adds their
    representative rows (the encoder's attention at 128 x 128 logical
    blocks, the full score matrix) to ``rows``."""
    import torch
    from repro_torch.kernels.int_attention import (
        int_attention_online, int_attention_online_plain)
    from repro_torch.kernels.int_softmax import (int_softmax,
                                                 int_softmax_plain)

    gen = torch.Generator(device="cuda").manual_seed(2468)
    aplan = plans.attn.attn
    h, hd = cfg.n_heads, cfg.hd
    eb, es = ENCODE_BATCH, ENCODE_SEQ
    k8_cases = [
        # (B, Sq, Skv, H, Hkv, D, causal, window, bq, bkv, operands, rep)
        (eb, es, es, h, h, hd, False, 0, 128, 128, "random", True),
        (4, 512, 512, 32, 8, 128, True, 0, 128, 128, "random", False),
        (4, 512, 512, 32, 8, 128, True, 128, 128, 128, "random", False),
        (eb, es, es, h, h, hd, False, 0, 256, 256, "random",
         False),                                             # pallas_tuned
        (4, 136, 136, h, h, hd, True, 0, 68, 68, "random", False),
        (1, 131, 131, 4, 4, hd, True, 0, 1, 1, "random", False),
        (eb, 64, es, h, h, hd, False, 0, 64, 128, "random", False),  # cross
    ]
    # the edge cases of the tensor-core kernel, at the blocks cuda_online
    # would fit: D 32 / 64 / 128 at S 1, 37 and 1000, one key, -128 /
    # +127 operands, Sq > Skv with a window and no causal mask (rows with
    # no live key), bq 4 under bkv 128, causal 4096, Skv = 2^16 (the bit
    # budget's edge; as one block of +127 keys, the largest row sum)
    k8_cases += [(1, s_, s_, 4, 2, dd, causal, window, bl, bl, "random",
                  False)
                 for dd in (32, 64, 128)
                 for s_, bl, causal, window in ((1, 1, False, 0),
                                                (37, 37, True, 0),
                                                (1000, 125, dd != 32,
                                                 100 if dd == 128 else 0))]
    k8_cases += [(2, 37, 1, 4, 2, 64, True, 0, 37, 1, "random", False),
                 (2, 100, 100, 4, 2, 64, False, 0, 100, 100, "min", False),
                 (2, 100, 100, 4, 2, 128, True, 0, 100, 100, "max", False),
                 (2, 200, 60, 4, 2, 32, False, 16, 100, 60, "random", False),
                 (1, 512, 512, 4, 2, 64, True, 0, 4, 128, "random", False),
                 (1, 4096, 4096, 2, 1, 128, True, 0, 128, 128, "random",
                  False),
                 (1, 64, 65536, 2, 1, 32, False, 0, 64, 128, "random",
                  False),
                 (1, 64, 65536, 1, 1, 64, False, 0, 64, 65536, "max",
                  False)]
    for (b, sq, skv, hq, hkv, dd, causal, window, bq, bkv, operands,
         rep) in k8_cases:
        q8, k8, v8 = _qkv(gen, operands, b, sq, skv, hq, hkv, dd)
        if rep:
            online_spread(q8, k8, v8, aplan)
        nbytes = 2 * b * sq * hq * dd + 2 * b * skv * hkv * dd
        ops = 4 * b * hq * dd * _live_pairs(sq, skv, causal, window)
        args = (q8, k8, v8, aplan, causal, window, bq, bkv)
        record(rows, "int_attention_online",
               f"B={b} Sq={sq} Skv={skv} H={hq} Hkv={hkv} D={dd} "
               f"causal={causal} window={window} bq={bq} bkv={bkv} "
               f"{operands}",
               int_attention_online(*args), int_attention_online_plain(*args),
               lambda: int_attention_online(*args),
               lambda: int_attention_online_plain(*args),
               nbytes, ops, rep=rep, iters=5, plain_iters=2,
               plan=k8_plan(q8, min(bkv, skv)))
        del q8, k8, v8, args
    # K8's exp16 division on its whole domain, for the plan every K8 case
    # above launches with
    division_check("int_attention_online", aplan)

    # K7: the encoder's whole score matrix (B x H x S rows of S), padded
    # and not, bench_kernels.py's 256 x 1024, and 2^15-long rows
    sm = aplan.sm
    k7_cases = [((eb, h, es, es), -1, True), ((eb, h, es, es), 300, False),
                ((256, 1024), -1, False), ((4, 1 << 15), -1, False)]
    for shape, vl, rep in k7_cases:
        x = _randint(gen, -100000, 100000, shape, torch.int32)
        n, length = x.numel(), shape[-1]
        # the kernel reads only the first valid_len scores of a row and
        # writes every probability
        read = n if vl < 0 else n // length * min(vl, length)
        record(rows, "int_softmax", f"{'x'.join(map(str, shape))} "
               f"valid_len={vl}", int_softmax(x, sm, vl),
               int_softmax_plain(x, sm, vl),
               lambda: int_softmax(x, sm, vl),
               lambda: int_softmax_plain(x, sm, vl),
               4 * read + n, 0, rep=rep, iters=10, plain_iters=2)
        del x


def window_config():
    """Full-width h2o-danube-3-4b, the reference serve driver's default:
    sliding window 4096, head dim 120, GQA 32 / 8, no bias."""
    from repro_torch.configs.registry import get_config
    return get_config("h2o-danube-3-4b")


def check_window_kernels(cfg, plans, rows) -> None:
    """The window path's kernels against their plain versions at
    h2o-danube-3-4b's full widths: K1 at every projection's shape (M = 4
    and 128) and the raw head, K2's RMSNorm over d = 3840, K3 at D = 120
    on the contiguous cache (L 512 and the full 4096-position window,
    folded and not, Sq = 8, 4 bytes off alignment) and on pools, K5 at
    D = 120 (windowed causal, window 128, no mask, cross, S = 1, -128 /
    +127, operands 4 and 8 bytes off 16-byte alignment), and K4 and K8 at
    D = 120 (one row each: their bodies share K5's D = 120 pieces)."""
    import torch
    from repro_torch.kernels.int8_matmul import (int8_matmul,
                                                 int8_matmul_plain)
    from repro_torch.kernels.int_attention import (
        int_attention_online, int_attention_online_plain)
    from repro_torch.kernels.int_attention_fused import (
        int_attention_fused, int_attention_fused_plain,
        int_paged_prefill_fused, int_paged_prefill_plain)
    from repro_torch.kernels.int_decode_attention import (
        int_decode_attention_fused, int_decode_attention_plain)
    from repro_torch.ops.spec import QuantLinearParams, RequantSpec

    gen = torch.Generator(device="cuda").manual_seed(5678)
    d, f, v = cfg.d_model, cfg.d_ff, cfg.padded_vocab()
    hd, h, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads

    # K1: every projection of a layer at decode (M = 4 and 16) and M = 128
    mm_cases = [("wq", d, h * hd, plans.attn.qkv),
                ("wk", d, hkv * hd, plans.attn.qkv),
                ("w1", d, f, plans.ffn.up),
                ("w2", f, d, plans.ffn.down),
                ("wo", h * hd, d, plans.attn.out)]
    raw = RequantSpec.raw()
    for m in (4, 16, 128):
        x_cache = {}
        for tag, k, n, lp in mm_cases:
            x8 = x_cache.setdefault(k, _randint(gen, -127, 128, (m, k),
                                                torch.int8))
            w8 = _randint(gen, -127, 128, (k, n), torch.int8)
            b_vec = _randint(gen, 256, 4096, (n,), torch.int32)
            spec = RequantSpec.for_linear(lp)
            out_b = 1 if spec.out_bits <= 8 else 4
            record(rows, "int8_matmul", f"h2o {tag} M={m} K={k} N={n} "
                   f"per-channel out_bits={spec.out_bits}",
                   int8_matmul(x8, w8, spec, b_vec=b_vec),
                   int8_matmul_plain(x8, w8, spec, b_vec=b_vec),
                   lambda: int8_matmul(x8, w8, spec, b_vec=b_vec),
                   lambda: int8_matmul_plain(x8, w8, spec, b_vec=b_vec),
                   m * k + k * n + 4 * n + out_b * m * n, 2 * m * k * n,
                   plan=k1_plan(m, n, k, x8=x8, w=w8))
        x8 = x_cache[d]
        w8 = _randint(gen, -127, 128, (d, v), torch.int8)
        record(rows, "int8_matmul", f"h2o head raw M={m} K={d} N={v}",
               int8_matmul(x8, w8, raw), int8_matmul_plain(x8, w8, raw),
               lambda: int8_matmul(x8, w8, raw),
               lambda: int8_matmul_plain(x8, w8, raw),
               m * d + d * v + 4 * m * v, 2 * m * d * v,
               lib_ms=int_mm_ms(x8, w8), iters=10,
               plan=k1_plan(m, v, d, x8=x8, w=w8))
        del w8, x_cache

    # K2: RMSNorm rows of the residual stream (a decode step, a 4 x 256
    # windowed prefill pass)
    gamma = _randint(gen, 40, 128, (d,), torch.int32)
    for r in (4, 1024):
        q = _randint(gen, -cfg.qmax_res, cfg.qmax_res + 1, (r, d),
                     torch.int32)
        k2_row(rows, "h2o rmsnorm", q, gamma, None, plans.norm)

    # K3 at D = 120: contiguous caches and pools
    aplan = plans.attn.attn
    requant = RequantSpec.per_tensor(aplan.dn_out)
    wo = QuantLinearParams(_randint(gen, -127, 128, (h * hd, d), torch.int8),
                           _randint(gen, 256, 4096, (d,), torch.int32))
    wo_spec = RequantSpec.for_linear(plans.attn.out)
    b = 4
    # (Sq, L, valid lengths, fold, layout, operands)
    k3_cases = [(1, 512, [1, 137, 300, 512], False, "contiguous", "random"),
                (1, 512, [1, 137, 300, 512], True, "contiguous", "random"),
                (1, 4096, [4096] * 4, False, "contiguous", "random"),
                (1, 4096, [4096] * 4, True, "contiguous", "random"),
                (1, 512, [1, 137, 300, 512], True, "paged", "random"),
                (1, 512, [0, 137, 300, 512], False, "contiguous",
                 "misaligned"),
                (8, 512, [8, 137, 300, 512], False, "contiguous", "random")]
    for sq, L, lens, fold, layout, operands in k3_cases:
        q8 = _randint(gen, -127, 128, (b, sq, h, hd), torch.int8)
        table = {}
        if layout == "paged":
            ps, maxp = 16, L // 16
            num_pages = b * maxp + 1
            k8 = _randint(gen, -127, 128, (num_pages, ps, hkv, hd),
                          torch.int8)
            v8 = _randint(gen, -127, 128, (num_pages, ps, hkv, hd),
                          torch.int8)
            pages = (torch.randperm(num_pages - 1, generator=gen,
                                    device="cuda") + 1).to(
                torch.int32).reshape(b, maxp)
            table = dict(pages=pages, page_size=ps)
        else:
            k8 = _randint(gen, -127, 128, (b, L, hkv, hd), torch.int8)
            v8 = _randint(gen, -127, 128, (b, L, hkv, hd), torch.int8)
        if operands == "misaligned":
            q8, k8, v8 = (_offset_view(x, 4) for x in (q8, k8, v8))
        vl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        kw = dict(requant=requant, **table)
        if fold:
            kw.update(wo=wo, wo_spec=wo_spec)
        nbytes, ops = k4_bound(lens, sq, h, hkv, hd,
                               b * L // 16 if table else 0, 1)
        if fold:
            nbytes += h * hd * d + 4 * d + 4 * b * sq * d - b * sq * h * hd
            ops += 2 * b * sq * h * hd * d
        args = (q8, k8, v8, aplan, vl)
        record(rows, "int_decode_attention",
               f"h2o B={b} Sq={sq} H={h} Hkv={hkv} D={hd} {layout} L={L}"
               f"{' ps=16' if table else ''} valid={lens} fold_wo={fold} "
               f"{operands}",
               int_decode_attention_fused(*args, **kw),
               int_decode_attention_plain(*args, **kw),
               lambda: int_decode_attention_fused(*args, **kw),
               lambda: int_decode_attention_plain(*args, **kw),
               nbytes, ops, iters=10, plain_iters=2,
               plan=k3_plan(q8, k8, v8, kw))
        del q8, k8, v8, args

    # K5 at D = 120: the window-prefill launch (causal, window 4096), a
    # window that bites, no mask, cross, S = 1, -128 / +127, and operands
    # 4 bytes (word copies) and 8 bytes (8-byte copies) off alignment
    epilogues = [requant, RequantSpec.per_channel(22, 8),
                 RequantSpec.per_channel(20, 6, out_bits=16),
                 RequantSpec.raw()]
    k5_cases = [(4, 512, 512, True, cfg.window, "random"),
                (4, 512, 512, True, 128, "random"),
                (4, 512, 512, False, 0, "random"),
                (4, 64, 512, False, 0, "random"),
                (4, 1, 1, True, cfg.window, "random"),
                (2, 100, 100, True, 0, "min"),
                (2, 100, 100, False, 0, "max"),
                (2, 100, 70, True, 8, "misaligned"),
                (2, 100, 100, True, 16, "misaligned8")]
    for i, (bb, sq, skv, causal, window, operands) in enumerate(k5_cases):
        rq = epilogues[i % 4] if i >= 2 else requant
        q8, k8, v8 = _qkv(gen, operands, bb, sq, skv, h, hkv, hd)
        bvec = _randint(gen, 1000, 20000, (h * hd,), torch.int32)
        out_b = 1 if (not rq.is_raw and rq.out_bits <= 8) else 4
        nbytes = (bb * sq * h * hd + 2 * bb * skv * hkv * hd
                  + out_b * bb * sq * h * hd)
        ops = 4 * bb * h * hd * _live_pairs(sq, skv, causal, window)
        args = (q8, k8, v8, aplan, rq, bvec, causal, window)
        record(rows, "int_attention_fused",
               f"h2o B={bb} Sq={sq} Skv={skv} H={h} Hkv={hkv} D={hd} "
               f"causal={causal} window={window} {rq.kind}"
               f"{'' if rq.is_raw else f' {rq.out_bits}b'} {operands}",
               int_attention_fused(*args), int_attention_fused_plain(*args),
               lambda: int_attention_fused(*args),
               lambda: int_attention_fused_plain(*args),
               nbytes, ops, iters=5, plain_iters=2,
               plan=k5_plan(q8, k8, causal, window, aplan))
        del q8, k8, v8, args

    # K4 at D = 120 (K5's body, keys through the page table)
    lens, c, ps, maxp = [32, 132, 282, 512], 32, 16, 32
    num_pages = b * maxp + 1
    q8 = _randint(gen, -127, 128, (b, c, h, hd), torch.int8)
    kp = _randint(gen, -127, 128, (num_pages, ps, hkv, hd), torch.int8)
    vp = _randint(gen, -127, 128, (num_pages, ps, hkv, hd), torch.int8)
    pages = (torch.randperm(num_pages - 1, generator=gen, device="cuda")
             + 1).to(torch.int32).reshape(b, maxp)
    vl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    nbytes, ops = k4_bound(lens, c, h, hkv, hd, b * maxp, 1)
    args = (q8, kp, vp, aplan, vl, pages, ps)
    record(rows, "int_paged_prefill",
           f"h2o B={b} C={c} H={h} Hkv={hkv} D={hd} ps={ps} "
           f"pages/lane={maxp} pos_end={lens}",
           int_paged_prefill_fused(*args, requant=requant),
           int_paged_prefill_plain(*args, requant=requant),
           lambda: int_paged_prefill_fused(*args, requant=requant),
           lambda: int_paged_prefill_plain(*args, requant=requant),
           nbytes, ops, iters=5, plain_iters=2,
           plan=k4_plan(q8, kp, pages, ps, aplan))
    del q8, kp, vp, args

    # K3 and K4 over packed int4 pools at D = 120 (60-byte packed rows)
    check_packed_kernels(gen, rows, aplan, requant, wo, wo_spec, h, hkv, hd,
                         d, "h2o ")

    # K8 at D = 120 (K5's pieces, the online schedule), at the reference's
    # 128 x 128 blocks and at blocks of 125 with a window
    for bb, s_, causal, window, blk in ((4, 512, True, 0, 128),
                                        (1, 1000, True, 100, 125)):
        q8, k8, v8 = _qkv(gen, "random", bb, s_, s_, h, hkv, hd)
        args = (q8, k8, v8, aplan, causal, window, blk, blk)
        record(rows, "int_attention_online",
               f"h2o B={bb} Sq={s_} Skv={s_} H={h} Hkv={hkv} D={hd} "
               f"causal={causal} window={window} bq={blk} bkv={blk}",
               int_attention_online(*args), int_attention_online_plain(*args),
               lambda: int_attention_online(*args),
               lambda: int_attention_online_plain(*args),
               2 * bb * s_ * h * hd + 2 * bb * s_ * hkv * hd,
               4 * bb * h * hd * _live_pairs(s_, s_, causal, window),
               iters=5, plain_iters=2, plan=k8_plan(q8, blk))
        del q8, k8, v8, args


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


def _repeat_prompt(seed: int, vocab: int, seg: int = 16, times: int = 4):
    """A prompt that repeats one ``seg``-token segment ``times`` times, so
    the n-gram proposer drafts from its first verify step."""
    return _prompts(seed, 1, seg, seg, vocab)[0] * times


def drain_streams(eng, reqs):
    """``run_until_done`` on the card; returns (streams, seconds)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_until_done()
    torch.cuda.synchronize()
    return [r.out_tokens for r in reqs], time.perf_counter() - t0


def frontend_streams(eng, prompts, max_new):
    """Every prompt submitted at once through ``ServingFrontend`` over
    ``eng``, each stream drained by its own consumer; returns (streams,
    the front end's ``describe()``, seconds)."""
    import asyncio

    import torch
    from repro_torch.serving import ServingFrontend
    fe = ServingFrontend(eng, max_pending=len(prompts))

    async def serve():
        runner = asyncio.create_task(fe.run())
        handles = [fe.submit(p, max_new) for p in prompts]
        streams = await asyncio.gather(*[h.result() for h in handles])
        fe.close()
        await runner
        if any(h.terminal != "completed" for h in handles):
            raise AssertionError("frontend: a request did not complete: "
                                 f"{[h.terminal for h in handles]}")
        return streams

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = asyncio.run(serve())
    torch.cuda.synchronize()
    return streams, fe.describe(), time.perf_counter() - t0


class StepTimer:
    """While active, every call of the named ``inttransformer`` steps
    (``tag=function name``) is timed with CUDA events and its kernel
    launches counted.  ``ms(tag)``: device ms a call; ``launches(tag)``:
    the launches of each call."""

    def __init__(self, **steps):
        self.steps = steps
        self.events = {tag: [] for tag in steps}
        self.counts = {tag: [] for tag in steps}
        self.orig = {}

    def __enter__(self):
        from repro_torch.models import inttransformer as it
        for tag, name in self.steps.items():
            self.orig[name] = getattr(it, name)
            setattr(it, name, self._timed(self.orig[name], tag))
        return self

    def __exit__(self, *exc):
        from repro_torch.models import inttransformer as it
        for name, fn in self.orig.items():
            setattr(it, name, fn)

    def _timed(self, fn, tag):
        import torch
        from repro_torch import kernels

        def wrapper(*a, **k):
            before = dict(kernels.LAUNCHES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **k)
            e.record()
            self.events[tag].append((s, e))
            self.counts[tag].append({n: kernels.LAUNCHES[n] - before[n]
                                     for n in before})
            return out
        return wrapper

    def ms(self, tag):
        return [s.elapsed_time(e) for s, e in self.events[tag]]

    def launches(self, tag):
        return self.counts[tag]


def _in_ms(pct):
    """A front end's percentile dict of seconds, in ms."""
    return {k: v if k == "n" else v * 1e3 for k, v in pct.items()}


def _pct_ms(samples):
    """p50 / p99 / mean of seconds, in ms."""
    import numpy as np
    if not samples:
        return None
    a = np.asarray(samples, dtype=np.float64) * 1e3
    return {"n": int(a.size), "mean": float(a.mean()),
            "p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99))}


def phase_parity(cfg_full, kv_dtype: str = "int8"):
    """llama3-8b at full width cut to 2 layers: ``cuda`` token streams
    equal ``torch_ref``'s, over int8 or packed int4 KV pages.  The prompts
    end with one that repeats a 16-token segment (the n-gram proposer
    drafts on it).  Over int8 pages the same prompts through
    ``ServingFrontend`` on ``cuda``, and a ``spec_k = 3`` engine on
    ``cuda`` and on ``torch_ref``, must give the drain's streams; over
    int4 pages a ``spec_k = 3`` engine on ``cuda`` must."""
    import dataclasses
    import torch
    from repro_torch.quant import convert
    phase = "parity" if kv_dtype == "int8" else "kv4-parity"
    cfg = dataclasses.replace(cfg_full, num_layers=2)
    qp, plans = convert.init_quantized(
        cfg, seed=0, device="cuda",
        embed_scale=convert.unit_embed_scale(cfg))
    prompts = _prompts(11, 6, 20, 150, cfg.vocab) \
        + [_repeat_prompt(17, cfg.vocab)]
    geom = dict(batch_size=4, cache_len=512, page_size=16, prefill_chunk=32,
                fold_wo=True, kv_dtype=kv_dtype)
    streams, secs, spec = {}, {}, {}
    for backend in ("cuda", "torch_ref"):
        eng, reqs = run_engine(qp, plans, cfg, prompts, 16, backend, **geom)
        streams[backend], secs[backend] = drain_streams(eng, reqs)
    if kv_dtype == "int8":
        eng, _ = run_engine(qp, plans, cfg, [], 16, "cuda", **geom)
        streams["frontend"], _, secs["frontend"] = frontend_streams(
            eng, prompts, 16)
    spec_backends = ("cuda", "torch_ref") if kv_dtype == "int8" \
        else ("cuda",)
    for backend in spec_backends:
        eng, reqs = run_engine(qp, plans, cfg, prompts, 16, backend,
                               spec_k=SPEC_K, **geom)
        tag = f"spec_{backend}"
        streams[tag], secs[tag] = drain_streams(eng, reqs)
        spec[tag] = eng.describe()["spec"]
    del eng
    same = streams["cuda"] == streams["torch_ref"]
    others = {k: v == streams["cuda"] for k, v in streams.items()
              if k not in ("cuda", "torch_ref")}
    distinct = len({t for s in streams["cuda"] for t in s})
    emit({"phase": phase, "layers": cfg.num_layers, "kv_dtype": kv_dtype,
          "requests": len(prompts), "prompt_lens": [len(p) for p in prompts],
          "identical": same, "identical_to_the_drain": others,
          "distinct_tokens": distinct, "spec": spec,
          "cuda_s": secs["cuda"], "torch_ref_s": secs["torch_ref"],
          "seconds": secs, "first_stream": streams["cuda"][0]})
    if not same:
        raise AssertionError(f"{phase}: cuda and torch_ref token streams "
                             "differ")
    if not all(others.values()):
        raise AssertionError(f"{phase}: streams differ from the cuda "
                             f"drain's: {others}")
    if distinct < 2:
        raise AssertionError("degenerate streams: one token everywhere")
    if not all(s["drafted"] > 0 for s in spec.values()):
        raise AssertionError(f"{phase}: the spec engines drafted nothing")
    del qp


def _clamp_linears(tree):
    """A derived model: every linear weight clamped to [-7, 7] (plain int4
    packs only such weights)."""
    import torch
    from repro_torch.ops.spec import QuantLinearParams
    if isinstance(tree, QuantLinearParams):
        return tree._replace(w8=torch.clamp(tree.w8, -7, 7))
    if isinstance(tree, dict):
        return {k: _clamp_linears(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clamp_linears(v) for v in tree]
    return tree


def phase_packed_parity(cfg_full):
    """llama3-8b at full width cut to 2 layers on packed weights, packed on
    the card with the port's ``pack_tree``: msr4 at group 64, ``cuda``
    streams equal ``torch_ref``'s and the dense int8 engine's; int4 on the
    derived model with every linear weight clamped to [-7, 7], ``cuda``
    equal ``torch_ref`` and the clamped dense model.  The ``cuda`` runs
    must launch K1's nibble instantiation (msr4: and the correction) and
    never the dense K1."""
    import dataclasses
    import gc

    import torch
    from repro_torch import kernels
    from repro_torch.quant import convert
    from repro_torch.quant.pack import pack_tree
    cfg = dataclasses.replace(cfg_full, num_layers=2)
    qp, plans = convert.init_quantized(
        cfg, seed=0, device="cuda",
        embed_scale=convert.unit_embed_scale(cfg))
    prompts = _prompts(11, 6, 20, 150, cfg.vocab)

    def drain(tree, backend):
        eng, reqs = run_engine(tree, plans, cfg, prompts, 16, backend,
                               batch_size=4, cache_len=512, page_size=16,
                               prefill_chunk=32, fold_wo=True)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        eng.run_until_done()
        torch.cuda.synchronize()
        return ([r.out_tokens for r in reqs], time.perf_counter() - t0,
                dict(kernels.LAUNCHES))

    for scheme in ("msr4", "int4"):
        dense = qp if scheme == "msr4" else _clamp_linears(qp)
        t0 = time.perf_counter()
        packed = pack_tree(dense, scheme, PACK_GROUP)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        runs = {"dense": drain(dense, "cuda"), "cuda": drain(packed, "cuda"),
                "torch_ref": drain(packed, "torch_ref")}
        streams = {k: r[0] for k, r in runs.items()}
        same = streams["cuda"] == streams["torch_ref"] == streams["dense"]
        distinct = len({t for st in streams["cuda"] for t in st})
        launches = runs["cuda"][2]
        meta = packed["head"].pack_meta
        emit({"phase": "packed-parity", "scheme": scheme,
              "derived": "linear weights clamped to [-7, 7]"
              if scheme == "int4" else None,
              "group": meta.group, "head_n_outliers": meta.n_outliers,
              "layers": cfg.num_layers, "requests": len(prompts),
              "identical": same, "distinct_tokens": distinct,
              "pack_s": pack_s, "dense_s": runs["dense"][1],
              "cuda_s": runs["cuda"][1], "torch_ref_s": runs["torch_ref"][1],
              "cuda_launches": {k: c for k, c in launches.items() if c},
              "first_stream": streams["cuda"][0]})
        if not same:
            raise AssertionError(f"packed-parity {scheme}: cuda, torch_ref "
                                 "and the dense engine's streams differ")
        if distinct < 2:
            raise AssertionError("degenerate streams: one token everywhere")
        if launches["int8_matmul"] or not launches["int8_matmul_packed"] \
                or bool(launches["int8_matmul_msr4"]) != (scheme == "msr4"):
            raise AssertionError(f"packed-parity {scheme}: launches "
                                 f"{launches}")
        del dense, packed
        gc.collect()
    del qp


def phase_serve(cfg, kv_dtype: str = "int8", weights: str = "int8",
                label=None):
    """llama3-8b (``cfg``: all 32 layers for ``serve``, 8 for the others)
    on ``cuda`` over int8 (``serve``) or packed int4
    (``kv4-serve``) KV pages, or on msr4 weights (``msr4-serve``, group 64,
    packed on the card and the dense model freed before serving):
    throughput, step times, peak memory, the pool's pages and bytes, the
    weight bytes and the launches of each decode step and prefill chunk,
    then a profiled decode window and a profiled window of prefill chunks.
    Over int4 pages every step and chunk must launch the packed K3 / K4
    once a layer and the int8 ones never; on msr4 weights every step and
    chunk K1's nibble instantiation and the correction and never the
    dense K1 (so wo never folded).  ``serve`` then runs
    :func:`serve_frontend_and_spec` on the same weights.  ``label``: the
    phase's name for another config on int8 pages and weights
    (``zoo-serve-<arch>``; its profiles are ``<label>-profile`` and
    ``<label>-prefill-profile``).  Returns the launches of each path it
    drove, by path."""
    import gc

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.quant import convert
    from repro_torch.quant.pack import pack_tree
    packed = kv_dtype == "int4"
    msr4 = weights == "msr4"
    phase = label or ("kv4-serve" if packed else "msr4-serve" if msr4
                      else "serve")
    k3, k4 = (("int_decode_attention_kv4", "int_paged_prefill_kv4")
              if packed else ("int_decode_attention", "int_paged_prefill"))
    # the earlier phases' engines are dropped: with the allocator's
    # reclaim hook held weakly they are freed before any collection
    before_gc = torch.cuda.memory_allocated()
    gc.collect()
    emit({"phase": phase, "memory_allocated_before_gc": before_gc,
          "memory_allocated_after_gc": torch.cuda.memory_allocated()})
    t0 = time.perf_counter()
    qp, plans = convert.init_quantized(
        cfg, seed=0, device="cuda",
        embed_scale=convert.unit_embed_scale(cfg))
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    pack_s = None
    if msr4:
        t0 = time.perf_counter()
        dense, qp = qp, pack_tree(qp, "msr4", PACK_GROUP)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        del dense
        gc.collect()
        torch.cuda.empty_cache()
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(qp))
    prompts = _prompts(5, 8, 32, 200, cfg.vocab)
    eng, reqs = run_engine(qp, plans, cfg, prompts, 32, "cuda",
                           batch_size=4, cache_len=512, page_size=16,
                           prefill_chunk=32, fold_wo=True, kv_dtype=kv_dtype)
    # time every prefill chunk and decode step with CUDA events, and
    # count the kernel launches each one makes
    with StepTimer(decode="int_decode_step",
                   prefill="int_prefill_chunk_step") as timer:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    per_step = {k: timer.launches(k) for k in ("decode", "prefill")}
    n_tok = sum(len(r.out_tokens) for r in reqs)
    distinct = len({t for r in reqs for t in r.out_tokens})
    step_ms = {k: timer.ms(k) for k in ("decode", "prefill")}
    cache = eng.describe()["cache"]
    emit({"phase": phase, "arch": cfg.name, "layers": cfg.num_layers,
          "kv_dtype": kv_dtype, "describe": eng.describe_str(),
          "num_pages": cache["num_pages"], "kv_bytes": cache["kv_bytes"],
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
          "weights": weights, "pack_s": pack_s,
          "quantize_s": quant_s, "weight_bytes": weight_bytes,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches})
    profile_decode(eng, cfg, f"{label}-profile" if label else
                   "kv4-profile" if packed else
                   "msr4-profile" if msr4 else "profile", k3)
    profile_prefill(eng, cfg, k4, f"{label}-prefill-profile" if label
                    else "msr4-prefill-profile" if msr4 else None)
    if not all(len(r.out_tokens) == 32 for r in reqs):
        raise AssertionError("a request came back short")
    vocab_ok = all(0 <= t < cfg.vocab for r in reqs for t in r.out_tokens)
    if not vocab_ok:
        raise AssertionError("token outside the vocabulary")
    missing = [k for k in PATH_KERNELS[phase] if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{phase} path never launched {missing}")
    other = ("int_decode_attention", "int_paged_prefill") if packed \
        else ("int_decode_attention_kv4", "int_paged_prefill_kv4")
    off = [(tag, i) for tag, name in (("decode", k3), ("prefill", k4))
           for i, c in enumerate(per_step[tag])
           if c[name] != cfg.num_layers or any(c[o] for o in other)]
    if off:
        raise AssertionError(f"{phase}: steps without one {k3} / {k4} a "
                             f"layer, or with {other}: {off[:5]}")
    if msr4:
        dense_k1 = [(tag, i) for tag in ("decode", "prefill")
                    for i, c in enumerate(per_step[tag])
                    if c["int8_matmul"] or not c["int8_matmul_packed"]
                    or not c["int8_matmul_msr4"]]
        if dense_k1:
            raise AssertionError(f"{phase}: steps with the dense K1 or "
                                 f"without the packed one: {dense_k1[:5]}")
    out = {phase: launches}
    if phase == "serve":
        drained = [r.out_tokens for r in reqs]
        SERVE_STREAMS["serve"] = drained
        del eng
        out.update(serve_frontend_and_spec(qp, plans, cfg, prompts,
                                           drained))
    return out


def _serve_engine(qp, plans, cfg, **kw):
    from repro_torch.serving import ServingEngine
    return ServingEngine(qp, plans, cfg, ops="cuda", device="cuda",
                         batch_size=4, cache_len=512, page_size=16,
                         prefill_chunk=32, fold_wo=True, **kw)


def serve_frontend_and_spec(qp, plans, cfg, prompts, drained):
    """``frontend-serve`` and ``spec-serve`` on the ``serve`` phase's
    weights: its 8 prompts and one that repeats a 16-token segment.
    ``frontend-serve`` serves them through ``ServingFrontend`` (all
    submitted at once): the 8 streams equal the timed drain's; tokens/s,
    TTFT and inter-token p50 / p99, the host ms of each ``dispatch_step``
    and ``commit_step`` beside each decode step's device ms (CUDA events).
    ``spec-serve`` drains a ``spec_k = 3`` engine (verify M = 16): all 9
    streams equal the front end's, drafts > 0, K3 once a layer in every
    verify step; accepted / drafted, tokens a verify step, a verify
    step's device ms.  Returns their launches."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.serving import Request
    prompts = prompts + [_repeat_prompt(21, cfg.vocab)]
    max_new = 32

    # --- frontend-serve
    eng = _serve_engine(qp, plans, cfg)
    host = {"dispatch_step": [], "commit_step": []}
    lanes = []

    def host_timed(name):
        fn = getattr(eng, name)

        def wrapper(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            host[name].append(time.perf_counter() - t0)
            if name == "dispatch_step":
                lanes.append(len(out.live))
            return out
        return wrapper
    for name in host:
        setattr(eng, name, host_timed(name))
    with StepTimer(decode="int_decode_step",
                   prefill="int_prefill_chunk_step") as timer:
        kernels.reset_launches()
        fe_streams, fe_d, fe_s = frontend_streams(eng, prompts, max_new)
        fe_launches = dict(kernels.LAUNCHES)
    decode_ms = timer.ms("decode")
    same = fe_streams[:len(drained)] == drained
    lat = fe_d["latency"]
    emit({"phase": "frontend-serve", "arch": cfg.name,
          "layers": cfg.num_layers, "requests": len(prompts),
          "max_new": max_new, "identical_to_the_drain": same,
          "tokens": fe_d["tokens"], "wall_s": fe_s,
          "tokens_per_s": fe_d["tokens"] / fe_s, "steps": fe_d["steps"],
          "terminal": fe_d["terminal"],
          "ttft_ms": _in_ms(lat["ttft_s"]),
          "inter_token_ms": _in_ms(lat["inter_token_s"]),
          "queue_wait_ms": _in_ms(lat["queue_wait_s"]),
          "dispatch_host_ms": _pct_ms(host["dispatch_step"]),
          "commit_host_ms": _pct_ms(host["commit_step"]),
          "decode_device_ms": {"n": len(decode_ms),
                               "mean": float(np.mean(decode_ms)),
                               "p50": float(np.percentile(decode_ms, 50))},
          "prefill_chunks": len(timer.ms("prefill")),
          "occupancy": fe_d["occupancy"], "launches": fe_launches})
    if not same:
        raise AssertionError("frontend-serve: streams differ from the "
                             "drain's")
    missing = [k for k in PATH_KERNELS["frontend-serve"]
               if fe_launches[k] <= 0]
    if missing:
        raise AssertionError(f"frontend-serve path never launched {missing}")
    del eng

    # --- spec-serve
    eng = _serve_engine(qp, plans, cfg, spec_k=SPEC_K)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    with StepTimer(verify="int_verify_step",
                   prefill="int_prefill_chunk_step") as timer:
        kernels.reset_launches()
        spec_streams, spec_s = drain_streams(eng, reqs)
        spec_launches = dict(kernels.LAUNCHES)
    verify_ms = timer.ms("verify")
    per_verify = timer.launches("verify")
    spec = eng.describe()["spec"]
    n_tok = sum(len(st) for st in spec_streams)
    same = spec_streams == fe_streams
    emit({"phase": "spec-serve", "arch": cfg.name, "layers": cfg.num_layers,
          "spec_k": 3, "verify_rows": 4 * 4, "requests": len(prompts),
          "identical_to_the_frontend": same,
          "identical_to_the_drain": spec_streams[:len(drained)] == drained,
          "drafted": spec["drafted"], "accepted": spec["accepted"],
          "accept_rate": spec["accept_rate"], "tokens": n_tok,
          "wall_s": spec_s, "tokens_per_s": n_tok / spec_s,
          "verify_steps": len(verify_ms),
          "tokens_per_verify_step": n_tok / max(len(verify_ms), 1),
          "verify_step_device_ms_mean": float(np.mean(verify_ms)),
          "verify_step_device_ms_p50": float(np.percentile(verify_ms, 50)),
          "launches_per_verify_step": _mean_counts(per_verify),
          "launches": spec_launches,
          "repeat_prompt_stream": spec_streams[-1]})
    if not same:
        raise AssertionError("spec-serve: streams differ from the front "
                             "end's (and so from the drain's)")
    if spec["drafted"] <= 0:
        raise AssertionError("spec-serve: the proposer drafted nothing")
    off = [i for i, c in enumerate(per_verify)
           if c["int_decode_attention"] != cfg.num_layers]
    if off or not per_verify:
        raise AssertionError(f"spec-serve: verify steps without one K3 a "
                             f"layer: {off[:5]}")
    missing = [k for k in PATH_KERNELS["spec-serve"]
               if spec_launches[k] <= 0]
    if missing:
        raise AssertionError(f"spec-serve path never launched {missing}")
    profile_verify(eng, cfg)
    return {"frontend-serve": fe_launches, "spec-serve": spec_launches}


def profile_verify(eng, cfg):
    """torch.profiler over verify steps of a ``spec_k`` engine (four
    8-token prompts admitted, then up to four steps): the device ms and
    busy share a verify step, K3's device ms a step.  The CUDA events
    around a step span the host's issue time as well, where the step is
    host-bound; this is the device's own time."""
    from repro_torch import kernels
    from repro_torch.serving import Request
    prompts = _prompts(9, 4, 8, 8, cfg.vocab)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=300 + i, prompt=p, max_new_tokens=16))
    eng.step()                       # admit + prefill + first verify
    before = kernels.LAUNCHES["int_decode_attention"]

    def steps():
        return (kernels.LAUNCHES["int_decode_attention"] - before) \
            // cfg.num_layers

    def window():
        for _ in range(4):
            eng.step()
    profile_window("spec-profile", "4 verify steps, batch 4, spec_k 3",
                   window, steps,
                   (K3_KERNEL_NAMES, lambda: steps() * cfg.num_layers))
    eng.run_until_done()


def window_decode_launches(layers: int) -> dict:
    """Launches of one h2o-danube-3-4b decode step: K1 q, k, v, the
    folded wo, w1, w3, w2 a layer + the head; K2 two norms a layer + the
    final norm; K3 one a layer; nothing else."""
    per = dict.fromkeys(TPU_KERNELS, 0)
    per.update({"int8_matmul": 7 * layers + 1,
                "int_layernorm": 2 * layers + 1,
                "int_decode_attention": layers})
    return per


def _window_streams(qp, plans, cfg, prompts, max_new, backend, **kw):
    """Drain one engine; returns (token streams, seconds)."""
    import torch
    eng, reqs = run_engine(qp, plans, cfg, prompts, max_new, backend, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_until_done()
    torch.cuda.synchronize()
    return [r.out_tokens for r in reqs], time.perf_counter() - t0


def phase_window_parity(cfg_full):
    """h2o-danube-3-4b at full widths cut to 2 layers: ServingEngine
    streams on ``cuda`` equal ``torch_ref``'s in both cache modes (paged
    with wo folded, contiguous without), then through the rolling
    window's wrap: the window cut to 64 positions, cache_len 160, two
    lanes decoding 150 tokens each (slot = pos % 64 wraps twice)."""
    import dataclasses
    from repro_torch.quant import convert
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(cfg_full, num_layers=2)
    qp, plans = convert.init_quantized(
        cfg, seed=0, device="cuda",
        embed_scale=convert.unit_embed_scale(cfg))
    cases = [("full window", cfg, _prompts(11, 4, 20, 80, cfg.vocab), 16,
              dict(batch_size=4, cache_len=512)),
             ("wrap", dataclasses.replace(cfg, window=64),
              _prompts(12, 2, 3, 3, cfg.vocab), 150,
              dict(batch_size=2, cache_len=160))]
    for what, c, prompts, max_new, kw in cases:
        for mode, fold in (("paged", True), ("contiguous", False)):
            streams, secs = {}, {}
            for backend in ("cuda", "torch_ref"):
                streams[backend], secs[backend] = _window_streams(
                    qp, plans, c, prompts, max_new, backend,
                    cache_mode=mode, fold_wo=fold, **kw)
            same = streams["cuda"] == streams["torch_ref"]
            distinct = len({t for st in streams["cuda"] for t in st})
            emit({"phase": "window-parity", "case": what,
                  "layers": c.num_layers, "window": c.window,
                  "reduced": ([] if c.window == cfg_full.window else
                              [f"window {cfg_full.window} -> {c.window}"])
                  + [f"layers {cfg_full.num_layers} -> {c.num_layers}"],
                  "cache_mode": mode, "fold_wo": fold,
                  "cache_len": kw["cache_len"], "batch": kw["batch_size"],
                  "prompt_lens": [len(p) for p in prompts],
                  "max_new": max_new, "identical": same,
                  "distinct_tokens": distinct,
                  "wrapped": max(len(p) for p in prompts) + max_new - 1
                  > c.window,
                  "cuda_s": secs["cuda"], "torch_ref_s": secs["torch_ref"],
                  "first_stream": streams["cuda"][0][:24]})
            if not same:
                raise AssertionError(f"window-parity {what} {mode}: cuda "
                                     "and torch_ref token streams differ")
            if distinct < 2:
                raise AssertionError("window-parity: degenerate streams")
    del qp
    emit({"phase": "window-parity", "seconds":
          time.perf_counter() - t_phase})


def phase_window_serve(cfg):
    """h2o-danube-3-4b (``WINDOW_LAYERS``) on ``cuda``, once per cache mode,
    token-streaming prefill: throughput, step times, peak memory and the
    launches of each decode step (K1, K2, K3 and nothing else), then a
    profiled decode window.  Returns the launches of each mode's run."""
    import gc

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.models import inttransformer as it
    from repro_torch.quant import convert
    t_phase = time.perf_counter()
    gc.collect()
    t0 = time.perf_counter()
    qp, plans = convert.init_quantized(
        cfg, seed=0, device="cuda",
        embed_scale=convert.unit_embed_scale(cfg))
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(qp))
    w = WINDOW_SERVE
    prompts = _prompts(5, w["requests"], w["lo"], w["hi"], cfg.vocab)
    expect = window_decode_launches(cfg.num_layers)
    out = {}
    for mode in ("paged", "contiguous"):
        eng, reqs = run_engine(qp, plans, cfg, prompts, w["max_new"], "cuda",
                               batch_size=w["batch"],
                               cache_len=w["cache_len"], cache_mode=mode,
                               prefill_chunk=0, fold_wo=True)
        events, per_step = [], []
        orig = it.int_decode_step

        def timed(*a, **k):
            before = dict(kernels.LAUNCHES)
            s_ev = torch.cuda.Event(enable_timing=True)
            e_ev = torch.cuda.Event(enable_timing=True)
            s_ev.record()
            res = orig(*a, **k)
            e_ev.record()
            events.append((s_ev, e_ev))
            per_step.append({n: kernels.LAUNCHES[n] - before[n]
                             for n in before})
            return res

        it.int_decode_step = timed
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
            it.int_decode_step = orig
        n_tok = sum(len(r.out_tokens) for r in reqs)
        step_ms = [s_ev.elapsed_time(e_ev) for s_ev, e_ev in events]
        per = _mean_counts(per_step)
        emit({"phase": "window-serve", "arch": cfg.name,
              "layers": cfg.num_layers, "cache_mode": mode,
              "describe": eng.describe_str(), "requests": len(reqs),
              "prompt_lens": [len(p) for p in prompts],
              "max_new": w["max_new"], "batch": w["batch"],
              "cache_len": w["cache_len"], "window": cfg.window,
              "prefill": "streaming", "tokens": n_tok,
              "distinct_tokens": len({t for r in reqs
                                      for t in r.out_tokens}),
              "wall_s": wall, "tokens_per_s": n_tok / wall,
              "steps": len(step_ms),
              "step_ms_mean": float(np.mean(step_ms)),
              "launches_per_decode_step": per,
              "expected_per_decode_step": expect,
              "launches_as_expected": all(per.get(n, 0) == c
                                          for n, c in expect.items()),
              "quantize_s": quant_s, "weight_bytes": weight_bytes,
              "kv_bytes": eng.describe()["cache"]["kv_bytes"],
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "launches": launches})
        profile_decode(eng, cfg, f"window-serve-profile-{mode}")
        if not all(len(r.out_tokens) == w["max_new"] for r in reqs):
            raise AssertionError("window-serve: a request came back short")
        if not all(0 <= t < cfg.vocab for r in reqs for t in r.out_tokens):
            raise AssertionError("window-serve: token outside the "
                                 "vocabulary")
        path = f"window-serve-{mode}"
        missing = [k for k in PATH_KERNELS[path] if launches[k] <= 0]
        if missing or launches["int_paged_prefill"]:
            raise AssertionError(f"{path}: never launched {missing}, or "
                                 "launched K4")
        out[path] = launches
        del eng
    del qp
    emit({"phase": "window-serve", "seconds": time.perf_counter() - t_phase})
    return out


# the prompt prefix whose decode caches ``window-prefill`` builds
RETURN_CACHE_SEQ = 64


def phase_window_prefill(cfg):
    """h2o-danube-3-4b (``WINDOW_LAYERS``) through
    ``launch.steps.make_prefill_step`` at
    4 x 256 tokens (seed 23) and ``int_prefill(return_cache=True)`` over
    their first ``RETURN_CACHE_SEQ`` (its caches are built token by token
    through the decode step: 256 would be ~75 s of the run): the logits of
    both and the contiguous caches ``cuda`` builds equal ``torch_ref``'s;
    the timed pass's launches (K5 one a layer), then one profiled pass.
    Returns the launches of the timed passes."""
    import gc

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import intlayers as il
    from repro_torch.models import inttransformer as it
    from repro_torch.quant import convert
    t_phase = time.perf_counter()
    gc.collect()
    qp, plans = convert.init_quantized(
        cfg, seed=0, device="cuda",
        embed_scale=convert.unit_embed_scale(cfg))
    b, s = 4, 256
    toks = torch.as_tensor(np.random.default_rng(23).integers(
        0, cfg.vocab, (b, s)), device="cuda")
    rope = il.build_rope_table(s + 1, cfg.hd, cfg.rope_theta, device="cuda")
    logits, caches, secs = {}, {}, {}
    prefix = toks[:, :RETURN_CACHE_SEQ]
    for backend in ("cuda", "torch_ref"):
        step = make_prefill_step(cfg, plans, ops=backend, device="cuda")
        logits[backend] = step(qp, {"tokens": toks}, rope)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, caches[backend] = it.int_prefill(qp, {"tokens": prefix}, plans,
                                             cfg, ops=backend,
                                             return_cache=True)
        torch.cuda.synchronize()
        secs[backend] = time.perf_counter() - t0
        if not torch.equal(lg, step(qp, {"tokens": prefix}, rope)):
            raise AssertionError(f"window-prefill {backend}: int_prefill "
                                 "and make_prefill_step logits differ")
    same_logits = torch.equal(logits["cuda"], logits["torch_ref"])
    same_cache = all(torch.equal(a[k], c[k])
                     for a, c in zip(caches["cuda"], caches["torch_ref"])
                     for k in ("k8", "v8"))
    step = make_prefill_step(cfg, plans, ops="cuda", device="cuda")
    n_pass = 3
    step(qp, {"tokens": toks}, rope)
    torch.cuda.synchronize()
    kernels.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_pass):
        out = step(qp, {"tokens": toks}, rope)
    end.record()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    per_pass = {n: c / n_pass for n, c in launches.items()}
    emit({"phase": "window-prefill", "arch": cfg.name,
          "layers": cfg.num_layers, "batch": b, "seq": s,
          "window": cfg.window, "logits_identical": same_logits,
          "caches_identical": same_cache,
          "cache_shape": list(caches["cuda"][0]["k8"].shape),
          "distinct_argmax": len(set(logits["cuda"].argmax(-1).tolist())),
          "finite": bool(torch.isfinite(out).all()),
          "pass_ms": start.elapsed_time(end) / n_pass,
          "launches_per_pass": per_pass,
          "return_cache_seq": RETURN_CACHE_SEQ, "return_cache_s": secs,
          "seconds": time.perf_counter() - t_phase})
    profile_window("window-prefill-profile", f"1 pass, {b} x {s}",
                   lambda: step(qp, {"tokens": toks}, rope))
    if not (same_logits and same_cache):
        raise AssertionError("window-prefill: cuda and torch_ref logits or "
                             "caches differ")
    if tuple(out.shape) != (b, cfg.padded_vocab()) \
            or not bool(torch.isfinite(out).all()):
        raise AssertionError("window-prefill: logits not finite (B, V)")
    missing = [k for k in PATH_KERNELS["window-prefill"] if launches[k] <= 0]
    if missing:
        raise AssertionError(f"window-prefill never launched {missing}")
    del qp
    return launches


def encoder_config():
    """Full-width roberta-base with the tied head its integer path needs
    (an encoder has no lm_head)."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config("roberta-base"),
                               tie_embeddings=True)


def random_model(cfg):
    """``cfg`` quantized on the card (random weights from seed 0, the
    embedding at unit std), once an earlier phase's model is collected;
    the encoder phases share one.  Returns ``(qparams, plans, seconds to
    quantize)``."""
    import gc

    import torch
    from repro_torch.quant import convert
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    qp, plans = convert.init_quantized(
        cfg, seed=0, device="cuda",
        embed_scale=convert.unit_embed_scale(cfg))
    torch.cuda.synchronize()
    return qp, plans, time.perf_counter() - t0


def _prefill(cfg, plans, ops, qp, toks, finals=None):
    """One ``make_prefill_step`` pass; returns (logits, seconds).
    ``finals``: a list that receives the final LayerNorm's input rows."""
    import torch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import inttransformer as it
    orig = it.logits_int

    def spy(qparams, x32, *a, **k):
        finals.append(x32)
        return orig(qparams, x32, *a, **k)

    if finals is not None:
        it.logits_int = spy
    try:
        step = make_prefill_step(cfg, plans, ops=ops, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(qp, {"tokens": toks})
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    finally:
        it.logits_int = orig


def _encode_timed(phase, cfg, plans, qp, ops, attention, rng,
                  seq=ENCODE_SEQ):
    """Timed passes at the full batch of ``seq`` tokens (launches per pass
    must be exactly ``encode_launches_per_pass``), then one profiled pass.
    Returns the launches of the timed run."""
    import torch
    from repro_torch import kernels
    from repro_torch.launch.steps import make_prefill_step
    step = make_prefill_step(cfg, plans, ops=ops, device="cuda")
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (ENCODE_BATCH, seq)),
        device="cuda")}
    for _ in range(2):
        step(qp, batch)
    n_pass = 5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t1 = time.perf_counter()
    start.record()
    for _ in range(n_pass):
        out = step(qp, batch)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(kernels.LAUNCHES)
    pass_ms = start.elapsed_time(end) / n_pass
    per_pass = {n: c / n_pass for n, c in launches.items()}
    expect = encode_launches_per_pass(cfg.num_layers, attention)
    emit({"phase": phase, "arch": cfg.name, "layers": cfg.num_layers,
          "ops": ops, "batch": ENCODE_BATCH,
          "seq": seq, "passes": n_pass, "ms_per_pass": pass_ms,
          "wall_s": wall,
          "tokens_per_s": ENCODE_BATCH * seq / (pass_ms / 1e3),
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches_per_pass": per_pass, "expected_per_pass": expect,
          "logits_shape": list(out.shape),
          "finite": bool(torch.isfinite(out).all())})
    if tuple(out.shape) != (ENCODE_BATCH, cfg.padded_vocab()) \
            or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{phase}: logits not finite (B, V)")
    missing = [k for k in PATH_KERNELS[phase] if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{phase} path never launched {missing}")
    if any(per_pass.get(n, 0) != c for n, c in expect.items()):
        raise AssertionError(f"{phase}: launches per pass {per_pass} != "
                             f"{expect}")
    profile_window(f"{phase}-profile",
                   f"1 pass, {ENCODE_BATCH} x {seq}",
                   lambda: step(qp, batch))
    return launches


def phase_encode(cfg, model):
    """The encoder path through ``make_prefill_step`` at full width:
    cuda == torch_ref, then timed passes with launch counts, then one
    profiled pass.  Returns the launches of the timed run."""
    import numpy as np
    import torch
    from repro_torch.models import intlayers as il
    qp, plans, quant_s = model
    rng = np.random.default_rng(21)

    # parity at full width, and the final LayerNorm rows of the cuda run
    toks = rng.integers(0, cfg.vocab, (PARITY_BATCH, ENCODE_SEQ))
    finals = []
    logits, secs = {}, {}
    for backend in ("cuda", "torch_ref"):
        logits[backend], secs[backend] = _prefill(cfg, plans, backend, qp,
                                                  toks, finals)
    h8 = il.int_norm(qp["final_norm"], finals[0], plans.final_norm,
                     ops="torch_ref")
    same = torch.equal(logits["cuda"], logits["torch_ref"])
    argmax = logits["cuda"].argmax(dim=-1)
    emit({"phase": "encode-parity", "arch": cfg.name,
          "layers": cfg.num_layers, "batch": PARITY_BATCH,
          "seq": ENCODE_SEQ, "identical": same,
          "distinct_argmax": len(set(argmax.tolist())),
          "final_norm_nonzero_rows": int((h8 != 0).any(dim=-1).sum()),
          "cuda_s": secs["cuda"], "torch_ref_s": secs["torch_ref"],
          "quantize_s": quant_s})
    if not same:
        raise AssertionError("encode: cuda and torch_ref logits differ")
    if not bool((h8 != 0).any()):
        raise AssertionError("encode: every final LayerNorm row is 0")
    return _encode_timed("encode", cfg, plans, qp, "cuda",
                         "int_attention_fused", rng)


def phase_encode_online(cfg, model):
    """The ``pallas`` backend's path at full width: ``cuda_online`` logits
    identical to the same routing in plain PyTorch; how many differ from
    the exact ``cuda`` path (information only: K8 is not exact); timed
    passes and one profiled pass.  Returns the launches of the timed
    run."""
    import numpy as np
    import torch
    from repro_torch.ops.backends.cuda_online import (_fit_block,
                                                      plain_online_opset)
    qp, plans, _ = model
    rng = np.random.default_rng(22)
    toks = rng.integers(0, cfg.vocab, (PARITY_BATCH, ENCODE_SEQ))
    logits, secs = {}, {}
    for name, ops in (("cuda_online", "cuda_online"),
                      ("plain", plain_online_opset()), ("cuda", "cuda")):
        logits[name], secs[name] = _prefill(cfg, plans, ops, qp, toks)
    same = torch.equal(logits["cuda_online"], logits["plain"])
    vs_exact = logits["cuda_online"] != logits["cuda"]
    emit({"phase": "encode-online-parity", "arch": cfg.name,
          "layers": cfg.num_layers, "batch": PARITY_BATCH,
          "seq": ENCODE_SEQ, "blocks": [_fit_block(128, ENCODE_SEQ)] * 2,
          "identical": same,
          "distinct_argmax": len(set(
              logits["cuda_online"].argmax(dim=-1).tolist())),
          "logits_differing_from_exact": int(vs_exact.sum()),
          "logits": vs_exact.numel(),
          "argmax_differing_from_exact": int(
              (logits["cuda_online"].argmax(dim=-1)
               != logits["cuda"].argmax(dim=-1)).sum()),
          "cuda_online_s": secs["cuda_online"], "plain_s": secs["plain"],
          "cuda_s": secs["cuda"]})
    if not same:
        raise AssertionError("encode-online: cuda_online and its plain "
                             "routing give different logits")
    return _encode_timed("encode-online", cfg, plans, qp, "cuda_online",
                         "int_attention_online", rng)


def phase_ops(cfg, plans):
    """K7 through the operator API's module-level entry point, under
    ``use_backend("cuda_online")``: the softmax of a roberta-base batch's
    full Q·Kᵀ score matrix, padded to 300 keys.  Returns the launches."""
    import torch
    from repro_torch import kernels
    from repro_torch import ops as rops
    from repro_torch.core.intmath import int_einsum
    from repro_torch.kernels.int_softmax import int_softmax_plain
    gen = torch.Generator(device="cuda").manual_seed(99)
    shape = (ENCODE_BATCH, ENCODE_SEQ, cfg.n_heads, cfg.hd)
    q8 = _randint(gen, -127, 128, shape, torch.int8)
    k8 = _randint(gen, -127, 128, shape, torch.int8)
    scores = int_einsum("bqhd,bkhd->bhqk", q8, k8)
    del q8, k8
    sm = plans.attn.attn.sm
    torch.cuda.synchronize()
    kernels.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with rops.use_backend("cuda_online") as ops:
        start.record()
        p8 = rops.int_softmax(scores, sm, valid_len=300)
        end.record()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = int_softmax_plain(scores, sm, 300)
    err = max_abs_diff(p8, want)
    row_sums = p8.to(torch.int32).sum(dim=-1)
    emit({"phase": "ops", "op": "int_softmax", "ops": ops.name,
          "shape": list(scores.shape), "valid_len": 300,
          "call_ms": start.elapsed_time(end), "launches": launches,
          "max_abs_err": err,
          "row_sum_min": int(row_sums.min()),
          "row_sum_max": int(row_sums.max()),
          "masked_nonzero": int(p8[..., 300:].ne(0).sum())})
    if err != 0 or p8[..., 300:].any():
        raise AssertionError("ops: int_softmax differs from its plain "
                             "version or leaks past valid_len")
    if launches["int_softmax"] != 1:
        raise AssertionError(f"ops: int_softmax launched K7 "
                             f"{launches['int_softmax']} times, not once")
    return launches


# ------------------------------------------------------- analysis ----

def main_path_reports(cfg, ecfg, sms: int):
    """``analysis.contracts.check_launch`` of every launch the main paths
    make, at their shapes: llama3-8b ``serve`` (K1 at every projection
    and the head at M 4 / 16 / 128, dense, int4 nibbles and the MSR-4
    correction at group 64; K2 at 4 and 128 rows; K3 at Sq 1 and
    ``VERIFY_SQ``, unfolded and folded, over int8 and int4 pages; K4 at a
    32-token chunk over both), a ``tp-serve`` rank at tp 2
    (``check_tp_launch`` for K3 / K4, K1 at the rank's slices),
    roberta-base ``encode`` / ``encode-online`` (K1 at 32 x 512 tokens
    and the tied head, K2 LayerNorm + beta, K5, K8 at 128 x 128), the
    ``ops`` phase's K7, and the grouped K1 at qwen2-moe-a2.7b's,
    qwen3-moe-235b-a22b's and jamba-v0.1-52b's decode steps and qwen2's
    4 x 512 pass.  Returns ``[(label, LaunchReport)]``."""
    from repro_torch.analysis import contracts as C
    from repro_torch.configs.registry import get_config
    from repro_torch.models.intlayers import moe_capacity
    d, f, v = cfg.d_model, cfg.d_ff, cfg.padded_vocab()
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out = []

    def add(label, rep):
        out.append((label, rep))

    proj = (("wq", d, h * hd), ("wk", d, hkv * hd), ("wo", h * hd, d),
            ("w1", d, f), ("w2", f, d), ("head", d, v))
    for m in (4, 16, 128):
        for tag, k, n in proj:
            add(f"serve {tag} M={m}", C.check_launch(
                "int8_matmul", m=m, n=n, k=k, sms=sms))
            add(f"msr4 {tag} M={m} nibbles", C.check_launch(
                "int8_matmul_packed", m=m, n=n, k=k, sms=sms))
            add(f"msr4 {tag} M={m} correction", C.check_launch(
                "int8_matmul_msr4", m=m, n=n, k=k, group=PACK_GROUP,
                n_out=PACK_GROUP, sms=sms))
        for tag, k, n in (("wq", d, h * hd // 2), ("wk", d, hkv * hd // 2),
                          ("wo", h * hd // 2, d)):
            add(f"tp-serve {tag} slice M={m}", C.check_launch(
                "int8_matmul", m=m, n=n, k=k, sms=sms))
    for rows_ in (4, 128):
        add(f"serve rmsnorm {rows_} rows", C.check_launch(
            "int_layernorm", rows=rows_, d=d, sms=sms))
    batch, maxp, ps = 4, 512 // 16, 16
    heads = dict(h=h, hkv=hkv, d=hd)
    for kv4 in (False, True):
        pool = dict(max_pages=maxp, page_size=ps, kv_pack=kv4,
                    num_pages=batch * maxp + 1)
        tier = "int4" if kv4 else "int8"
        for sq in (1, VERIFY_SQ):
            for fold in (False, True):
                add(f"serve K3 {tier} Sq={sq}{' folded' if fold else ''}",
                    C.check_launch("int_decode_attention", b=batch, sq=sq,
                                   fold=fold, n_out=d, sms=sms, **heads,
                                   **pool))
            add(f"tp-serve K3 {tier} Sq={sq} tp=2", C.check_tp_launch(
                "int_decode_attention", tp=2, b=batch, sq=sq, sms=sms,
                **heads, **pool))
        add(f"serve K4 {tier} C=32", C.check_launch(
            "int_paged_prefill", b=batch, c=32, **heads, **pool))
        add(f"tp-serve K4 {tier} C=32 tp=2", C.check_tp_launch(
            "int_paged_prefill", tp=2, b=batch, c=32, **heads, **pool))
    ed, ef, ev = ecfg.d_model, ecfg.d_ff, ecfg.padded_vocab()
    tokens = ENCODE_BATCH * ENCODE_SEQ
    for tag, k, n in (("wq", ed, ed), ("w1", ed, ef), ("w2", ef, ed)):
        add(f"encode {tag} M={tokens}", C.check_launch(
            "int8_matmul", m=tokens, n=n, k=k, sms=sms))
    add(f"encode tied head M={ENCODE_BATCH}", C.check_launch(
        "int8_matmul", m=ENCODE_BATCH, n=ev, k=ed, sms=sms))
    add(f"encode layernorm {tokens} rows", C.check_launch(
        "int_layernorm", rows=tokens, d=ed, subtract_mean=True, beta=True,
        sms=sms))
    enc = dict(b=ENCODE_BATCH, sq=ENCODE_SEQ, skv=ENCODE_SEQ,
               h=ecfg.n_heads, hkv=ecfg.n_kv_heads, d=ecfg.hd)
    add("encode K5", C.check_launch("int_attention", causal=False, **enc))
    add("encode-online K8 128x128", C.check_launch(
        "int_attention", online=True, bq=128, bkv=128, causal=False, **enc))
    score_rows = ENCODE_BATCH * ecfg.n_heads * ENCODE_SEQ
    for vl in (-1, 300):
        add(f"ops K7 valid_len={vl}", C.check_launch(
            "int_softmax", rows=score_rows, L=ENCODE_SEQ, valid_len=vl))
    for arch in ("qwen2-moe-a2.7b", "qwen3-moe-235b-a22b",
                 "jamba-v0.1-52b"):
        mcfg = get_config(arch)
        e, mf = mcfg.padded_experts(), mcfg.moe_d_ff or mcfg.d_ff
        tags = [("decode", 4 * moe_capacity(mcfg, 1))]
        if arch == "qwen2-moe-a2.7b":
            tags.append(("4x512 pass", MOE_BATCH
                         * moe_capacity(mcfg, MOE_SEQ)))
        for tag, r in tags:
            for w, k, n in (("w1", mcfg.d_model, mf),
                            ("w2", mf, mcfg.d_model)):
                add(f"{arch} grouped {w} {tag} R={r}", C.check_launch(
                    "int8_matmul_grouped", e=e, r=r, n=n, k=k, sms=sms))
    return out


def _drive_recorded(cfg, ecfg):
    """Inside ``kernels.record_launches``: llama3-8b at full width cut to
    2 layers through ``ServingEngine`` on ``cuda`` (one 40-token prompt:
    two prefill chunks of 32, then decode steps), a ``spec_k = 3`` engine
    on a repeating prompt (verify steps), one roberta-base pass (2
    layers, 4 x 512) on ``cuda`` and on ``cuda_online``, and the grouped
    K1 (:func:`_grouped_recorded`).  Returns ``(records, launches)``."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.quant import convert
    lcfg = dataclasses.replace(cfg, num_layers=2)
    qp, plans = convert.init_quantized(
        lcfg, seed=0, device="cuda",
        embed_scale=convert.unit_embed_scale(lcfg))
    geom = dict(batch_size=4, cache_len=512, page_size=16, prefill_chunk=32,
                fold_wo=True)
    e2 = dataclasses.replace(ecfg, num_layers=2)
    eqp, eplans = convert.init_quantized(
        e2, seed=0, device="cuda", embed_scale=convert.unit_embed_scale(e2))
    toks = np.random.default_rng(23).integers(0, e2.vocab, (4, ENCODE_SEQ))
    torch.cuda.synchronize()
    kernels.reset_launches()
    with kernels.record_launches() as rec:
        eng, reqs = run_engine(qp, plans, lcfg,
                               _prompts(31, 1, 40, 40, lcfg.vocab), 3,
                               "cuda", **geom)
        drain_streams(eng, reqs)
        eng, reqs = run_engine(qp, plans, lcfg,
                               [_repeat_prompt(17, lcfg.vocab)], 8, "cuda",
                               spec_k=SPEC_K, **geom)
        drain_streams(eng, reqs)
        for ops in ("cuda", "cuda_online"):
            _prefill(e2, eplans, ops, eqp, toks)
        _grouped_recorded()
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    del eng, qp, eqp
    return rec, launches


def _grouped_recorded() -> None:
    """The grouped K1 through its wrapper at qwen2-moe-a2.7b's w1 and w2
    for a decode step (R 16, 16 experts with a row) and a 4 x 512 pass (R
    160, 60 experts), for the ``analysis`` phase's recorded launches."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.int8_matmul import int8_matmul_grouped
    from repro_torch.models.intlayers import moe_capacity
    from repro_torch.ops.spec import RequantSpec
    cfg = get_config("qwen2-moe-a2.7b")
    e, f, d = cfg.padded_experts(), cfg.moe_d_ff, cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(77)
    for r, live in ((4 * moe_capacity(cfg, 1), 16),
                    (MOE_BATCH * moe_capacity(cfg, MOE_SEQ), 60)):
        rows = torch.tensor([r // 2] * live + [0] * (e - live),
                            dtype=torch.int32, device="cuda")
        for k, n in ((d, f), (f, d)):
            x8 = _randint(gen, -127, 128, (e, r, k), torch.int8)
            w8 = _randint(gen, -127, 128, (e, k, n), torch.int8)
            int8_matmul_grouped(x8, w8, rows, RequantSpec.raw())


def _refusals():
    """Shapes the contract refuses, launched on the card: each wrapper must
    raise ``KernelContractError`` before launching (``kernels.LAUNCHES``
    unchanged).  Returns the number of cases."""
    import torch
    from repro_torch import kernels
    from repro_torch.analysis.contracts import KernelContractError
    from repro_torch.core import attention as iattn
    from repro_torch.core import norms as inorms
    from repro_torch.kernels.int_attention import int_attention_online
    from repro_torch.kernels.int_attention_fused import (
        int_attention_fused, int_paged_prefill_fused)
    from repro_torch.kernels.int_decode_attention import \
        int_decode_attention_fused
    from repro_torch.kernels.int_layernorm import int_layernorm

    def i8(*shape):
        return torch.zeros(shape, dtype=torch.int8, device="cuda")

    def i32(*vals):
        return torch.tensor(vals, dtype=torch.int32, device="cuda")

    def attn_plan(dd):
        return iattn.make_iattention(dd, 8 / 127, 8 / 127, 4 / 127, 4 / 127)

    p96, p128 = attn_plan(96), attn_plan(128)
    norm = inorms.make_inorm(8200, 2.0 ** -9, 4096, 2 / 127, 8 / 127)
    pages = i32(1, 2)[None, :]
    cases = {
        "D 96 K5": lambda: int_attention_fused(i8(1, 64, 2, 96),
                                               i8(1, 64, 2, 96),
                                               i8(1, 64, 2, 96), p96),
        "D 96 K3": lambda: int_decode_attention_fused(
            i8(1, 1, 2, 96), i8(1, 64, 2, 96), i8(1, 64, 2, 96), p96,
            i32(5)),
        "D 96 K4": lambda: int_paged_prefill_fused(
            i8(1, 16, 2, 96), i8(3, 16, 2, 96), i8(3, 16, 2, 96), p96,
            i32(16), pages, 16),
        "D 96 K8": lambda: int_attention_online(
            i8(1, 64, 2, 96), i8(1, 64, 2, 96), i8(1, 64, 2, 96), p96,
            bq=64, bkv=64),
        "K2 d 8200": lambda: int_layernorm(
            torch.zeros((2, 8200), dtype=torch.int32, device="cuda"),
            torch.ones(8200, dtype=torch.int32, device="cuda"), None, norm),
        "decode Sq 9": lambda: int_decode_attention_fused(
            i8(1, 9, 32, 128), i8(1, 64, 8, 128), i8(1, 64, 8, 128), p128,
            i32(64)),
        "H 30 / Hkv 8 K3": lambda: int_decode_attention_fused(
            i8(1, 1, 30, 128), i8(1, 64, 8, 128), i8(1, 64, 8, 128), p128,
            i32(64)),
        "H 30 / Hkv 8 K5": lambda: int_attention_fused(
            i8(1, 64, 30, 128), i8(1, 64, 8, 128), i8(1, 64, 8, 128), p128),
    }
    for name, call in cases.items():
        before = dict(kernels.LAUNCHES)
        try:
            call()
        except KernelContractError as e:
            reason = "; ".join(e.reasons)
        else:
            raise AssertionError(f"analysis: {name} launched; the contract "
                                 "refuses it")
        torch.cuda.synchronize()
        if kernels.LAUNCHES != before:
            raise AssertionError(f"analysis: {name} counted a launch")
        emit({"phase": "analysis-refusal", "case": name, "raised":
              "KernelContractError", "reason": reason})
    return len(cases)


def phase_analysis(cfg, ecfg) -> dict:
    """The analysis layer on the card: ``certify_config`` of all 13
    configs at (4096, 32768); the ``check_launch`` report of every
    main-path launch (:func:`main_path_reports`), each ``ok``, and for
    every distinct instantiation they name the card's registers, spills,
    ``maxThreadsPerBlock`` and occupancy at the report's threads, shared
    memory and cluster (``kernels._abi.kernel_attributes``): the shared
    memory within ``shared_memory_per_block_optin``, the threads within
    ``maxThreadsPerBlock``, occupancy >= 1 (K6, which has no contract, at
    its 256 threads too); the launches of llama3-8b's decode, chunk and
    verify steps and a roberta-base pass recorded and each equal to an
    ``ok`` report's route, grid, cluster and shared memory; and the
    refused shapes (:func:`_refusals`).  Returns the driven launches."""
    import torch
    from repro_torch.analysis import contracts
    from repro_torch.analysis.interpret import certify_config
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels._abi import kernel_attributes
    t0 = time.perf_counter()
    for name in sorted(ARCHS):
        r = certify_config(ARCHS[name], seq_len=4096, cache_len=32768)
        emit({"phase": "analysis-certify", "arch": name,
              "worst_bits": r.worst_bits,
              "min_headroom_bits": r.min_headroom_bits,
              "n_ops": len(r.ops), "n_dyadics": r.n_dyadics})
    props = torch.cuda.get_device_properties(0)
    sms, optin = props.multi_processor_count, \
        props.shared_memory_per_block_optin
    reports = main_path_reports(cfg, ecfg, sms)
    bad = [(label, rep.reasons) for label, rep in reports if not rep.ok]
    if bad:
        raise AssertionError(f"analysis: main-path launches refused: {bad}")
    users = {}
    for label, rep in reports:
        key = (rep.kernel, rep.threads, rep.smem_bytes, rep.cluster)
        users.setdefault(key, []).append(label)
    users[(("int_gelu",), 256, 0, 1)] = ["encode K6 (no contract)"]
    for (kernel, threads, smem, cluster), labels in sorted(
            users.items(), key=str):
        a = kernel_attributes(kernel, threads, smem, cluster)
        row = {"phase": "analysis-kernel", "kernel": list(kernel),
               "threads": threads, "smem_bytes": smem, "cluster": cluster,
               **a, "optin_smem": optin, "reports": len(labels),
               "first": labels[0]}
        emit(row)
        if smem + a["static_smem"] > optin or threads > a["max_threads"] \
                or a["occupancy"] < 1:
            raise AssertionError(f"analysis: {kernel} does not fit the card "
                                 f"at {threads} threads, {smem} B: {row}")
    records, launches = _drive_recorded(cfg, ecfg)
    missing = [k for k in PATH_KERNELS["analysis"] if launches[k] <= 0]
    if missing:
        raise AssertionError(
            f"analysis: the driven steps launched no {missing}")
    seen = {}
    for op, params, launched in records:
        rep = contracts.check_launch(op, **params)
        got = {k: getattr(rep, k) for k in launched}
        if not rep.ok or got != launched:
            raise AssertionError(f"analysis: {op} {params} launched "
                                 f"{launched}, the contract says {got} "
                                 f"(ok={rep.ok})")
        tag = op if op != "int_decode_attention" else f"{op} Sq={params['sq']}"
        tag = f"{tag} online" if params.get("online") else tag
        seen[tag] = seen.get(tag, 0) + 1
    want = {"int8_matmul", "int_layernorm", "int_decode_attention Sq=1",
            f"int_decode_attention Sq={VERIFY_SQ}", "int_paged_prefill",
            "int_attention", "int_attention online", "int8_matmul_grouped"}
    if not want <= set(seen):
        raise AssertionError(f"analysis: no recorded launch of "
                             f"{sorted(want - set(seen))}")
    refused = _refusals()
    emit({"phase": "analysis", "configs": len(ARCHS),
          "reports": len(reports), "instantiations": len(users),
          "recorded": len(records), "recorded_by_op": seen,
          "refusals": refused, "launches": launches,
          "seconds": time.perf_counter() - t0})
    return launches


# ------------------------------------------------------------- the zoo ----

# the configs of the reference's registry ROADMAP §1 item 1 added: the
# decoders serve (``zoo-parity``, ``zoo-serve``), the encoders run a pass
# of this many tokens a sequence (roberta-large its longest, deit-s its
# 196 patches + 1)
ZOO_DECODERS = ("codeqwen1.5-7b", "granite-3-2b")
# zoo-serve: the decoders at full width cut to 4 layers (to
# keep the whole script within its time)
ZOO_SERVE_LAYERS = 4
ZOO_ENCODERS = {"roberta-large": 512, "deit-s": 197}
# llama3-8b's long prefill: above the reference's full-matrix threshold
# (S * S > 4096^2 / 4), where ``ref`` streams the chunked two-pass path
LONG_SEQ = 4096


def zoo_config(name: str):
    """Full-width ``name``; an encoder with the tied head its integer path
    needs (it has no lm_head)."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    cfg = get_config(name)
    return cfg if cfg.is_causal else dataclasses.replace(
        cfg, tie_embeddings=True)


def check_zoo_kernels(rows) -> None:
    """K1-K6 at the shapes the four new configs give them, each exact
    against its plain version: K1 at codeqwen1.5-7b's QKV with its bias
    (M 4, 16: the decode tile) and its w2 (K = 13440), granite-3-2b's raw
    tied head at the odd N = 49155 (M 4: the copy route; 128: a ragged N
    tile) and at the 49168 columns the padded vocabulary gives it; K2's
    LayerNorm + beta at roberta-large's (16 384 x 1024, the warp route's
    widest row) and deit-s's (32 x 197 x 384) passes; K3 and K4 at the
    serve rows of codeqwen (MHA: one query head a KV head, D 128) and
    granite (D 64); K5 at roberta-large's (B 32, S 512, H 16) and deit-s's
    (S 197: ragged last tiles) passes and at llama3-8b's long prefill (S
    4096, H 32 / 8, causal); K6 at roberta-large's FFN (16 384 x 4096)."""
    import torch
    from repro_torch.kernels.int8_matmul import (int8_matmul,
                                                 int8_matmul_plain)
    from repro_torch.kernels.int_gelu import int_gelu, int_gelu_plain
    from repro_torch.ops.spec import RequantSpec
    from repro_torch.quant import plans as qplans
    gen = torch.Generator(device="cuda").manual_seed(2718)
    cfgs = {n: zoo_config(n) for n in (*ZOO_DECODERS, *ZOO_ENCODERS)}
    plans = {n: qplans.build_layer_plans(c) for n, c in cfgs.items()}

    # K1
    cq, cqp = cfgs["codeqwen1.5-7b"], plans["codeqwen1.5-7b"]
    gr = cfgs["granite-3-2b"]
    mm = [(f"codeqwen wq+bias M={m}", m, cq.d_model, cq.d_model,
           cqp.attn.qkv, True) for m in (4, 16)]
    mm += [("codeqwen w2 M=4", 4, cq.d_ff, cq.d_model, cqp.ffn.down, False)]
    mm += [(f"granite head raw M={m}", m, gr.d_model, n, None, False)
           for m, n in ((4, gr.vocab), (128, gr.vocab),
                        (4, gr.padded_vocab()))]
    for tag, m, k, n, lp, with_bias in mm:
        x8 = _randint(gen, -127, 128, (m, k), torch.int8)
        w8 = _randint(gen, -127, 128, (k, n), torch.int8)
        if lp is None:
            spec, b_vec, bias, lib = RequantSpec.raw(), None, None, (
                int_mm_ms(x8, w8) if m > 16 else None)
        else:
            spec, lib = RequantSpec.for_linear(lp), None
            b_vec = _randint(gen, 256, 4096, (n,), torch.int32)
            bias = _randint(gen, -5000, 5000, (n,), torch.int32) \
                if with_bias else None
        out_b = 4 if spec.is_raw or spec.out_bits > 8 else 1
        epi = 4 * n * ((b_vec is not None) + (bias is not None))
        record(rows, "int8_matmul", f"{tag} K={k} N={n} {spec.kind}"
               f"{'+bias' if bias is not None else ''}",
               int8_matmul(x8, w8, spec, bias32=bias, b_vec=b_vec),
               int8_matmul_plain(x8, w8, spec, bias32=bias, b_vec=b_vec),
               lambda: int8_matmul(x8, w8, spec, bias32=bias, b_vec=b_vec),
               lambda: int8_matmul_plain(x8, w8, spec, bias32=bias,
                                         b_vec=b_vec),
               m * k + k * n + epi + out_b * m * n, 2 * m * k * n,
               lib_ms=lib, iters=10, plan=k1_plan(m, n, k, x8=x8, w=w8))
        del x8, w8

    # K2: LayerNorm + beta over an encode pass's rows
    for name, seq in ZOO_ENCODERS.items():
        c = cfgs[name]
        gamma = _randint(gen, 40, 128, (c.d_model,), torch.int32)
        beta = _randint(gen, -9000, 9000, (c.d_model,), torch.int32)
        q = _randint(gen, -c.qmax_res, c.qmax_res + 1,
                     (ENCODE_BATCH * seq, c.d_model), torch.int32)
        k2_row(rows, f"{name} layernorm+beta", q, gamma, beta,
               plans[name].norm)
        del q

    # K3 / K4 at the serve rows
    for name in ZOO_DECODERS:
        paged_attention_rows(
            gen, rows, cfgs[name], plans[name],
            (("int_decode_attention", 1, [1, 137, 300, 512], ""),
             ("int_paged_prefill", 32, [32, 132, 282, 512], "")),
            tag=f"{name} ")

    # K5: the encoders' passes, and llama3-8b's long prefill (the shape
    # ``cuda`` runs where ``ref`` streams the chunked path)
    for name, seq in ZOO_ENCODERS.items():
        c, ap = cfgs[name], plans[name].attn.attn
        k5_row(gen, rows, ap, ENCODE_BATCH, seq, seq, c.n_heads,
               c.n_kv_heads, c.hd, False, 0, RequantSpec.per_tensor(
                   ap.dn_out), "random", False, tag=f"{name} ")
    llama = zoo_config("llama3-8b")
    ap = qplans.build_layer_plans(llama).attn.attn
    k5_row(gen, rows, ap, 1, LONG_SEQ, LONG_SEQ, llama.n_heads,
           llama.n_kv_heads, llama.hd, True, 0,
           RequantSpec.per_tensor(ap.dn_out), "random", False,
           tag="llama3-8b long prefill ")

    # K6: roberta-large's FFN
    rl = cfgs["roberta-large"]
    gp = plans["roberta-large"].ffn.act_gelu
    q = _randint(gen, -1024, 1024, (ENCODE_BATCH * 512, rl.d_ff),
                 torch.int32)
    record(rows, "int_gelu", f"roberta-large FFN {q.shape[0]}x{rl.d_ff} "
           "11-bit", int_gelu(q, gp.gelu, gp.dn_out),
           int_gelu_plain(q, gp.gelu, gp.dn_out),
           lambda: int_gelu(q, gp.gelu, gp.dn_out),
           lambda: int_gelu_plain(q, gp.gelu, gp.dn_out),
           8 * q.numel(), 0, iters=20)


def phase_zoo_parity() -> None:
    """The four new configs at full width cut to 2 layers.  The decoders:
    ``ServingEngine`` streams on ``cuda`` equal ``torch_ref``'s (paged,
    chunked prefill 32, wo folded; 6 prompts of 20-150 tokens, 16 new
    each), and the ``cuda`` run launches K1-K4.  The encoders:
    ``make_prefill_step`` logits on ``cuda`` equal ``torch_ref``'s at 8 x
    512 (roberta-large) and 8 x 197 (deit-s)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import kernels
    for name in ZOO_DECODERS:
        cfg = dataclasses.replace(zoo_config(name), num_layers=2)
        qp, plans, quant_s = random_model(cfg)
        prompts = _prompts(11, 6, 20, 150, cfg.vocab)
        streams, secs, launches = {}, {}, {}
        for backend in ("cuda", "torch_ref"):
            eng, reqs = run_engine(qp, plans, cfg, prompts, 16, backend,
                                   batch_size=4, cache_len=512,
                                   page_size=16, prefill_chunk=32,
                                   fold_wo=True)
            kernels.reset_launches()
            streams[backend], secs[backend] = drain_streams(eng, reqs)
            launches[backend] = dict(kernels.LAUNCHES)
            del eng
        same = streams["cuda"] == streams["torch_ref"]
        distinct = len({t for s in streams["cuda"] for t in s})
        missing = [k for k in PATH_KERNELS["serve"]
                   if launches["cuda"][k] <= 0]
        emit({"phase": "zoo-parity", "arch": name, "layers": 2,
              "requests": len(prompts),
              "prompt_lens": [len(p) for p in prompts], "identical": same,
              "distinct_tokens": distinct, "quantize_s": quant_s,
              "cuda_s": secs["cuda"], "torch_ref_s": secs["torch_ref"],
              "cuda_launches": {k: c for k, c in launches["cuda"].items()
                                if c},
              "first_stream": streams["cuda"][0]})
        if not same:
            raise AssertionError(f"zoo-parity {name}: cuda and torch_ref "
                                 "token streams differ")
        if distinct < 2:
            raise AssertionError(f"zoo-parity {name}: degenerate streams")
        if missing:
            raise AssertionError(f"zoo-parity {name}: cuda never launched "
                                 f"{missing}")
        del qp
    rng = np.random.default_rng(23)
    for name, seq in ZOO_ENCODERS.items():
        cfg = dataclasses.replace(zoo_config(name), num_layers=2)
        qp, plans, quant_s = random_model(cfg)
        toks = rng.integers(0, cfg.vocab, (PARITY_BATCH, seq))
        logits, secs = {}, {}
        for backend in ("cuda", "torch_ref"):
            logits[backend], secs[backend] = _prefill(cfg, plans, backend,
                                                      qp, toks)
        same = torch.equal(logits["cuda"], logits["torch_ref"])
        argmax = logits["cuda"].argmax(dim=-1)
        emit({"phase": "zoo-parity", "arch": name, "layers": 2,
              "batch": PARITY_BATCH, "seq": seq, "identical": same,
              "distinct_argmax": len(set(argmax.tolist())),
              "finite": bool(torch.isfinite(logits["cuda"]).all()),
              "quantize_s": quant_s, "cuda_s": secs["cuda"],
              "torch_ref_s": secs["torch_ref"]})
        if not same:
            raise AssertionError(f"zoo-parity {name}: cuda and torch_ref "
                                 "logits differ")
        if len(set(argmax.tolist())) < 2:
            raise AssertionError(f"zoo-parity {name}: one argmax "
                                 "everywhere")
        del qp


def phase_zoo_encode(name: str, seq: int):
    """An encoder of the zoo at full depth through ``make_prefill_step``
    on ``cuda``: timed passes at 32 x ``seq`` with launches per pass (K1,
    K2, K5, K6), then one profiled pass.  Returns the launches of the
    timed run."""
    import numpy as np
    cfg = zoo_config(name)
    qp, plans, quant_s = random_model(cfg)
    emit({"phase": f"zoo-encode-{name}", "quantize_s": quant_s})
    return _encode_timed(f"zoo-encode-{name}", cfg, plans, qp, "cuda",
                         "int_attention_fused", np.random.default_rng(24),
                         seq=seq)


def phase_long_prefill(cfg_full):
    """llama3-8b at full width cut to 2 layers, B 1, S = ``LONG_SEQ``,
    through ``make_prefill_step``: under ``ops="ref"`` (``cuda_ref``) the
    attention streams the reference's chunked two-pass path (K5 never
    launches) and the logits equal ``torch_ref``'s; under ``"cuda"`` (the
    twin of ``pallas_fused``) K5 launches once a layer, and how many
    logits differ from ``ref``'s is printed.  Then one layer's attention at
    the head shape (H 32 / 8, D 128, S 4096, causal): the chunked path on
    the card equals the same call on the CPU, and its ms (CUDA events and
    the profiler's device time) stand beside K5's on the same operands.
    Returns the launches of the ``ref`` and ``cuda`` passes."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.attention import i_attention_chunked
    from repro_torch.kernels.int_attention_fused import int_attention_fused
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import intlayers as il
    cfg = dataclasses.replace(cfg_full, num_layers=2)
    qp, plans, _ = random_model(cfg)
    toks = np.random.default_rng(25).integers(0, cfg.vocab, (1, LONG_SEQ))
    rope = il.build_rope_table(LONG_SEQ + 1, cfg.hd, cfg.rope_theta,
                               device="cuda")
    logits, secs, launches = {}, {}, {}
    for backend in ("ref", "torch_ref", "cuda"):
        step = make_prefill_step(cfg, plans, ops=backend, device="cuda")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        logits[backend] = step(qp, {"tokens": toks}, rope)
        torch.cuda.synchronize()
        secs[backend] = time.perf_counter() - t0
        launches[backend] = dict(kernels.LAUNCHES)
    same = torch.equal(logits["ref"], logits["torch_ref"])
    k5 = {b: launches[b]["int_attention_fused"] for b in launches}
    del qp

    # one layer's attention at the head shape: card against CPU, then times
    aplan = plans.attn.attn
    gen = torch.Generator(device="cuda").manual_seed(26)
    q8, k8, v8 = _qkv(gen, "random", 1, LONG_SEQ, LONG_SEQ, cfg.n_heads,
                      cfg.n_kv_heads, cfg.hd)
    rep = cfg.q_group
    kr, vr = k8.repeat_interleave(rep, 2), v8.repeat_interleave(rep, 2)

    def chunked(q, k, v):
        return i_attention_chunked(q, k, v, aplan, chunk=1024, causal=True)

    got = chunked(q8, kr, vr)
    t0 = time.perf_counter()
    cpu = chunked(q8.cpu(), kr.cpu(), vr.cpu())
    cpu_s = time.perf_counter() - t0
    card_equals_cpu = torch.equal(got.cpu(), cpu)
    del cpu
    k5_out = int_attention_fused(q8, k8, v8, aplan, causal=True)
    vs_k5 = got.to(torch.int8) != k5_out
    chunk_ms = time_ms(lambda: chunked(q8, kr, vr), 3, warmup=1)
    chunk_dev = device_ms(lambda: chunked(q8, kr, vr), 2)
    k5_ms = time_ms(lambda: int_attention_fused(q8, k8, v8, aplan,
                                                causal=True), 10)
    k5_dev = device_ms(lambda: int_attention_fused(q8, k8, v8, aplan,
                                                   causal=True), 10)
    emit({"phase": "long-prefill", "arch": cfg.name, "layers": 2,
          "batch": 1, "seq": LONG_SEQ,
          "ref_identical_to_torch_ref": same,
          "k5_launches": k5,
          "logits_cuda_differing_from_ref": int(
              (logits["cuda"] != logits["ref"]).sum()),
          "logits": logits["ref"].numel(),
          "argmax": {b: int(x.argmax()) for b, x in logits.items()},
          "seconds": secs,
          "attention": {"shape": f"B=1 S={LONG_SEQ} H={cfg.n_heads}/"
                        f"{cfg.n_kv_heads} D={cfg.hd} causal",
                        "chunk": 1024, "card_equals_cpu": card_equals_cpu,
                        "cpu_s": cpu_s,
                        "outputs_differing_from_k5": int(vs_k5.sum()),
                        "outputs": vs_k5.numel(),
                        "chunked_ms": chunk_ms,
                        "chunked_device_ms": chunk_dev,
                        "k5_ms": k5_ms, "k5_device_ms": k5_dev}})
    if not same:
        raise AssertionError("long-prefill: ref and torch_ref logits "
                             "differ")
    if k5["ref"] or k5["torch_ref"] or k5["cuda"] != cfg.num_layers:
        raise AssertionError(f"long-prefill: K5 launches {k5}: ref must "
                             "stream the chunked path, cuda run K5")
    if not card_equals_cpu:
        raise AssertionError("long-prefill: the chunked path on the card "
                             "differs from the CPU's")
    for b in ("ref", "cuda"):
        missing = [k for k in PATH_KERNELS[f"long-prefill-{b}"]
                   if launches[b][k] <= 0]
        if missing:
            raise AssertionError(f"long-prefill {b} never launched "
                                 f"{missing}")
    return {"long-prefill-ref": launches["ref"],
            "long-prefill-cuda": launches["cuda"]}


# ------------------------------------------------ mixtures of experts ----

# ROADMAP §1 item 6: the two MoE configs of the reference's registry, served
# by token streaming (as the reference serves MoE); their full-sequence
# pass at 4 x 512 (one routing group of 512 tokens a sequence)
MOE_ARCHS = ("qwen2-moe-a2.7b", "qwen3-moe-235b-a22b")
MOE_BATCH, MOE_SEQ = 4, 512
# moe-serve / moe-prefill: qwen2-moe-a2.7b at full width cut to 4 of its
# 24 layers (to keep the whole script within its time)
MOE_SERVE_LAYERS = 4


def moe_config(name: str, layers: int = 0):
    """Full-width ``name``, cut to ``layers`` layers where given."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    cfg = get_config(name)
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def _valid_rows(out, counts):
    """Expert e's first counts[e] rows of an (E, R, N) result, stacked:
    the rows the grouped kernel writes."""
    import torch
    return torch.cat([out[e, :c] for e, c in enumerate(counts)])


def grouped_plan_text(x8, w8, counts) -> str:
    """The grouped K1's launch for these operands and expert counts: the
    route, row tile, cluster, the split the card chooses and K a rank,
    blocks, the live items and the rounds of them."""
    from repro_torch.kernels import int8_matmul as K1
    e, r, k = x8.shape
    n = w8.shape[2]
    p = K1.grouped_plan(e, r, n, k, K1.sm_count(x8.device), x8.data_ptr(),
                        w8.data_ptr())
    items = K1.grouped_items(n, counts)
    split, k_per, rounds = K1.grouped_split(p, k, items)
    return (f"{p.route} rt={p.rt} cluster={p.cluster} split={split} "
            f"k_per_rank={k_per} blocks={p.grid[0]} items={items} "
            f"rounds={rounds}")


def grouped_row(gen, rows, tag, r, k, n, lp, counts, library=False,
                rep=False):
    """K1's grouped instantiation at (E, R, K) x (E, K, N) with expert
    row counts ``counts`` (host ints), against its plain version on the
    rows it writes, then its device, call and host ms.  The bound counts
    the packed x rows, the weights and multiplier rows of the experts that
    got rows, ``rows`` and the output rows.  ``library``: a loop of
    ``torch._int_mm`` (raw, cuBLAS) over the experts that got rows (each
    at least 17 rows, its minimum), a yardstick the port does not call.
    It calls only the wrapper and the plain version."""
    import torch
    from repro_torch.kernels.int8_matmul import (int8_matmul_grouped,
                                                 int8_matmul_grouped_plain)
    from repro_torch.ops.spec import RequantSpec
    e = len(counts)
    x8 = _randint(gen, -127, 128, (e, r, k), torch.int8)
    w8 = _randint(gen, -127, 128, (e, k, n), torch.int8)
    b_vec = _randint(gen, 256, 4096, (e, n), torch.int32)
    rws = torch.tensor(counts, dtype=torch.int32, device="cuda")
    spec = RequantSpec.for_linear(lp)
    got = int8_matmul_grouped(x8, w8, rws, spec, b_vec=b_vec)
    want = int8_matmul_grouped_plain(x8, w8, rws, spec, b_vec=b_vec)
    live = [i for i, c in enumerate(counts) if c]
    m = sum(min(c, r) for c in counts)
    out_b = 1 if spec.out_bits <= 8 else 4
    nbytes = m * k + len(live) * (k * n + 4 * n) + 4 * e + out_b * m * n
    lib = None
    if library:
        xs = [x8[i, :max(counts[i], 17)] for i in live]

        def int_mm_loop():
            for xi, i in zip(xs, live):
                torch._int_mm(xi, w8[i])
        lib = device_ms(int_mm_loop, 5) or time_ms(int_mm_loop, 5)

    def call():
        return int8_matmul_grouped(x8, w8, rws, spec, b_vec=b_vec)
    record(rows, "int8_matmul_grouped",
           f"{tag} E={e} R={r} K={k} N={n} out_bits={spec.out_bits} "
           f"rows={m} experts_with_rows={len(live)}",
           _valid_rows(got, counts), _valid_rows(want, counts), call,
           lambda: int8_matmul_grouped_plain(x8, w8, rws, spec,
                                             b_vec=b_vec),
           nbytes, 2 * m * k * n, lib_ms=lib, rep=rep, iters=10,
           plain_iters=2, plan=grouped_plan_text(x8, w8, counts),
           extra={"host_ms": host_ms(call, 10)})
    del x8, w8


def grouped_table_rows(rows, seed: int, prefix: str = "") -> None:
    """Every grouped K1 row of PERF.md's table, each exact against its
    plain version: qwen2-moe-a2.7b's w1 (K 2048, N 1408) and w2 (K 1408,
    N 2048) for a decode step of 4 tokens (R = 16: 16 (token, expert)
    pairs in 16 distinct experts, then all four tokens in the same 4
    experts) and for a 4 x 512 pass on its routing (R = 160, beside a
    loop of torch._int_mm over the experts that got rows), qwen3-moe-
    235b-a22b's w1 (K 4096, N 1536, E 128; 32 pairs in 32 experts), and
    jamba-v0.1-52b's w1 (4096 x 14336) and w2 (14336 x 4096) for a decode
    step of 4 tokens, top-2 (8 pairs in 8 experts, then all four in the
    same 2)."""
    import torch
    from repro_torch.quant import plans as qplans
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q2, q3 = moe_config("qwen2-moe-a2.7b"), moe_config("qwen3-moe-235b-a22b")
    jb = ssm_config("jamba-v0.1-52b")
    p2, p3, pj = (qplans.build_layer_plans(c) for c in (q2, q3, jb))

    def spread(c, pairs):
        """One row in each of ``pairs`` distinct real experts."""
        ids = torch.randperm(c.n_experts, generator=gen,
                             device="cuda")[:pairs].tolist()
        return [int(i in ids) for i in range(c.padded_experts())]

    e2, f2, d2 = q2.padded_experts(), q2.moe_d_ff, q2.d_model
    dec = {"16 pairs in 16 experts": spread(q2, 16),
           "4 tokens in the same 4 experts": [4] * 4 + [0] * (e2 - 4)}
    r_pre, pre_counts = prefill_routing_counts(gen, q2, p2)
    for lin, k, n, lp in (("w1", d2, f2, p2.moe.expert.up),
                          ("w2", f2, d2, p2.moe.expert.down)):
        for pattern, counts in dec.items():
            grouped_row(gen, rows, f"{prefix}qwen2-moe {lin} decode B=4 "
                        f"k=4 {pattern}", 16, k, n, lp, counts,
                        rep=(lin == "w1" and pattern.startswith("16")))
        grouped_row(gen, rows, f"{prefix}qwen2-moe {lin} prefill "
                    f"{MOE_BATCH}x{MOE_SEQ} routed", r_pre, k, n, lp,
                    pre_counts, library=True)
    grouped_row(gen, rows, f"{prefix}qwen3-moe w1 decode B=4 k=8 32 pairs "
                "in 32 experts", 16, q3.d_model, q3.moe_d_ff,
                p3.moe.expert.up, spread(q3, 32))
    ej = jb.padded_experts()
    for lin, k, n, lp in (("w1", jb.d_model, jb.moe_d_ff, pj.moe.expert.up),
                          ("w2", jb.moe_d_ff, jb.d_model,
                           pj.moe.expert.down)):
        for pattern, counts in (("8 pairs in 8 experts", spread(jb, 8)),
                                ("4 tokens in the same 2 experts",
                                 [4, 4] + [0] * (ej - 2))):
            grouped_row(gen, rows, f"{prefix}jamba {lin} decode B=4 k=2 "
                        f"{pattern}", 16, k, n, lp, counts)


def check_k1_grouped() -> None:
    """The ``k1-grouped`` phase: every grouped K1 row of PERF.md's table
    alone (:func:`grouped_table_rows`), exact against its plain version,
    device, call and host ms, each with its launch, then the yardsticks
    the rows that miss their targets are read against
    (:func:`grouped_yardsticks`)."""
    grouped_table_rows({}, 9797, "k1-grouped ")
    grouped_yardsticks(9898)


def grouped_yardsticks(seed: int) -> None:
    """What the grouped rows are read against: an empty launch; the
    grouped K1 at each decode shape where no expert got rows (its fixed
    cost: the blocks start, read ``rows``, find no item and exit; qwen2-
    moe-a2.7b's w1 / w2 and jamba-v0.1-52b's w2, E padded, R 16); and
    K1's dense tile on the rows of a 4 x 512 pass of qwen2-moe-a2.7b as
    one (M, K) x (K, N) product, exact against its plain version: the
    same mma.sync on the same work without the experts, each weight read
    once."""
    import torch
    from repro_torch.kernels.int8_matmul import (int8_matmul,
                                                 int8_matmul_grouped,
                                                 int8_matmul_plain)
    from repro_torch.ops.spec import RequantSpec
    from repro_torch.quant import plans as qplans
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q2, jb = moe_config("qwen2-moe-a2.7b"), ssm_config("jamba-v0.1-52b")
    p2 = qplans.build_layer_plans(q2)
    empty_kernel_row()
    raw = RequantSpec.raw()
    for tag, e, k, n in (
            ("qwen2-moe w1", q2.padded_experts(), q2.d_model, q2.moe_d_ff),
            ("qwen2-moe w2", q2.padded_experts(), q2.moe_d_ff, q2.d_model),
            ("jamba w2", jb.padded_experts(), jb.moe_d_ff, jb.d_model)):
        x8 = _randint(gen, -127, 128, (e, 16, k), torch.int8)
        w8 = _randint(gen, -127, 128, (e, k, n), torch.int8)
        rws = torch.zeros(e, dtype=torch.int32, device="cuda")

        def call():
            return int8_matmul_grouped(x8, w8, rws, raw)
        emit({"phase": "k1-grouped-floor", "name": "int8_matmul_grouped",
              "case": f"{tag} decode E={e} R=16 K={k} N={n}, no expert "
                      f"got rows", "ms": device_ms(call, 20),
              "call_ms": time_ms(call, 20), "host_ms": host_ms(call, 20),
              "plan": grouped_plan_text(x8, w8, [0] * e)})
        del x8, w8
    r_pre, counts = prefill_routing_counts(gen, q2, p2)
    m = sum(min(c, r_pre) for c in counts)
    d, f = q2.d_model, q2.moe_d_ff
    for lin, k, n, lp in (("w1", d, f, p2.moe.expert.up),
                          ("w2", f, d, p2.moe.expert.down)):
        x8 = _randint(gen, -127, 128, (m, k), torch.int8)
        w8 = _randint(gen, -127, 128, (k, n), torch.int8)
        b_vec = _randint(gen, 256, 4096, (n,), torch.int32)
        spec = RequantSpec.for_linear(lp)
        out_b = 1 if spec.out_bits <= 8 else 4
        record({}, "int8_matmul",
               f"k1-grouped yardstick qwen2-moe {lin}: K1 dense on the "
               f"{MOE_BATCH}x{MOE_SEQ} pass's rows M={m} K={k} N={n}",
               int8_matmul(x8, w8, spec, b_vec=b_vec),
               int8_matmul_plain(x8, w8, spec, b_vec=b_vec),
               lambda: int8_matmul(x8, w8, spec, b_vec=b_vec),
               lambda: int8_matmul_plain(x8, w8, spec, b_vec=b_vec),
               m * k + k * n + 4 * n + out_b * m * n, 2 * m * k * n,
               iters=10, plain_iters=2, plan=k1_plan(m, n, k, x8=x8, w=w8))
        del x8, w8


def prefill_routing_counts(gen, cfg, plans):
    """Expert row counts of a 4 x 512 pass's routing (``moe_route`` of K1's
    raw router logits over random activations and router weights; one
    group a sequence, capacity counted over the padded experts): the R
    = 4 * cap rows an expert has, and the kept rows of each."""
    import torch
    from repro_torch.kernels.int8_matmul import int8_matmul
    from repro_torch.models import intlayers as il
    from repro_torch.ops.spec import RequantSpec
    e = cfg.padded_experts()
    cap = il.moe_capacity(cfg, MOE_SEQ)
    x8 = _randint(gen, -127, 128, (MOE_BATCH * MOE_SEQ, cfg.d_model),
                  torch.int8)
    w8 = _randint(gen, -127, 128, (cfg.d_model, e), torch.int8)
    logits = int8_matmul(x8, w8, RequantSpec.raw()).reshape(
        MOE_BATCH, MOE_SEQ, e)
    route = il.moe_route(logits, plans.moe, cfg, cap)
    return MOE_BATCH * cap, route.kept.sum(dim=0).tolist()


def check_moe_kernels(rows) -> None:
    """The kernels at the MoE configs' shapes, each exact against its
    plain version: every grouped K1 row of PERF.md's table
    (:func:`grouped_table_rows`: qwen2-moe-a2.7b's w1 / w2 at a decode
    step, spread and concentrated, and on a 4 x 512 pass's routing beside
    a loop of torch._int_mm; qwen3-moe-235b-a22b's w1; jamba-v0.1-52b's
    w1 / w2 at a decode step); K1 for the raw routers at M 4 (N 64 / 128)
    and qwen2's QKV with its bias; K3 at qwen2's MHA 16 / 16 serve row and
    at qwen3's GQA 64 / 4 serve row and verify step (Sq 4: 64 rows a KV
    head)."""
    import torch
    from repro_torch.kernels.int8_matmul import (int8_matmul,
                                                 int8_matmul_plain)
    from repro_torch.ops.spec import RequantSpec
    from repro_torch.quant import plans as qplans
    # the seed and the order the grouped rows were drawn in when this
    # function drew them first from its own generator: their operands
    # stay what they were, so earlier trees' rows compare
    grouped_table_rows(rows, 4242)
    gen = torch.Generator(device="cuda").manual_seed(4242)
    cfgs = {n: moe_config(n) for n in MOE_ARCHS}
    plans = {n: qplans.build_layer_plans(c) for n, c in cfgs.items()}
    q2, q3 = cfgs["qwen2-moe-a2.7b"], cfgs["qwen3-moe-235b-a22b"]
    p2, p3 = plans["qwen2-moe-a2.7b"], plans["qwen3-moe-235b-a22b"]
    d2 = q2.d_model

    # K1: the raw routers, qwen2's QKV with its bias
    for name, c in cfgs.items():
        x8 = _randint(gen, -127, 128, (4, c.d_model), torch.int8)
        w8 = _randint(gen, -127, 128, (c.d_model, c.padded_experts()),
                      torch.int8)
        raw = RequantSpec.raw()
        record(rows, "int8_matmul", f"{name} router raw M=4 K={c.d_model} "
               f"N={c.padded_experts()}", int8_matmul(x8, w8, raw),
               int8_matmul_plain(x8, w8, raw),
               lambda: int8_matmul(x8, w8, raw),
               lambda: int8_matmul_plain(x8, w8, raw),
               4 * c.d_model + c.d_model * c.padded_experts()
               + 16 * c.padded_experts(), 8 * c.d_model * c.padded_experts(),
               plan=k1_plan(4, c.padded_experts(), c.d_model, x8=x8, w=w8))
    x8 = _randint(gen, -127, 128, (4, d2), torch.int8)
    w8 = _randint(gen, -127, 128, (d2, q2.n_heads * q2.hd), torch.int8)
    n = q2.n_heads * q2.hd
    b_vec = _randint(gen, 256, 4096, (n,), torch.int32)
    bias = _randint(gen, -5000, 5000, (n,), torch.int32)
    spec = RequantSpec.for_linear(p2.attn.qkv)
    record(rows, "int8_matmul", f"qwen2-moe wq+bias M=4 K={d2} N={n}",
           int8_matmul(x8, w8, spec, bias32=bias, b_vec=b_vec),
           int8_matmul_plain(x8, w8, spec, bias32=bias, b_vec=b_vec),
           lambda: int8_matmul(x8, w8, spec, bias32=bias, b_vec=b_vec),
           lambda: int8_matmul_plain(x8, w8, spec, bias32=bias,
                                     b_vec=b_vec),
           4 * d2 + d2 * n + 8 * n + 4 * n, 8 * d2 * n,
           plan=k1_plan(4, n, d2, x8=x8, w=w8))

    # K3 at the serve rows (and qwen3's verify step)
    paged_attention_rows(gen, rows, q2, p2, (
        ("int_decode_attention", 1, [1, 137, 300, 512], ""),),
        tag="qwen2-moe ")
    paged_attention_rows(gen, rows, q3, p3, (
        ("int_decode_attention", 1, [1, 137, 300, 512], ""),
        ("int_decode_attention", VERIFY_SQ, [4, 137, 300, 512],
         "verify ")), tag="qwen3-moe ")


class MoeDrops:
    """While active, the dropped (token, slot) pairs of every
    ``intlayers.moe_route`` call (one a MoE layer) are kept as 0-d
    tensors on the card; ``per_layer(n)`` reads the last ``n``."""

    def __enter__(self):
        from repro_torch.models import intlayers as il
        self.orig, self.counts = il.moe_route, []

        def spy(*a, **k):
            route = self.orig(*a, **k)
            self.counts.append((~route.keep).sum())
            return route
        il.moe_route = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import intlayers as il
        il.moe_route = self.orig

    def per_layer(self, layers: int):
        return [int(t) for t in self.counts[-layers:]]


def phase_moe_parity() -> None:
    """Both MoE configs at full width cut to 2 layers: ``ServingEngine``
    streams on ``cuda`` equal ``torch_ref``'s (paged, token-streaming
    prefill, wo folded), with ``spec_k`` 0 and 3 on each; then
    ``make_prefill_step`` logits at 4 x 512 on ``cuda`` equal
    ``torch_ref``'s, and the dropped (token, slot) pairs of each layer
    (equal on both)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import intlayers as il
    for name in MOE_ARCHS:
        cfg = moe_config(name, 2)
        qp, plans, quant_s = random_model(cfg)
        # every prompt token is a step (token streaming): short prompts
        prompts = _prompts(31, 5, 12, 30, cfg.vocab) \
            + [_repeat_prompt(37, cfg.vocab, seg=8, times=3)]
        geom = dict(batch_size=4, cache_len=256, page_size=16, fold_wo=True)
        streams, secs, launches, spec = {}, {}, {}, {}
        for backend in ("cuda", "torch_ref"):
            for k in (0, SPEC_K):
                eng, reqs = run_engine(qp, plans, cfg, prompts, 8, backend,
                                       spec_k=k, **geom)
                tag = f"{backend}_spec{k}"
                kernels.reset_launches()
                streams[tag], secs[tag] = drain_streams(eng, reqs)
                launches[tag] = dict(kernels.LAUNCHES)
                spec[tag] = eng.describe()["spec"]
                mode = eng.describe()["prefill"]["mode"]
                del eng
        same = {t: s == streams["cuda_spec0"] for t, s in streams.items()}
        distinct = len({t for s in streams["cuda_spec0"] for t in s})
        missing = [k for k in PATH_KERNELS["moe-serve"]
                   if launches["cuda_spec0"][k] <= 0]
        emit({"phase": "moe-parity", "arch": name, "layers": 2,
              "prefill": mode, "requests": len(prompts),
              "prompt_lens": [len(p) for p in prompts],
              "identical": same, "distinct_tokens": distinct,
              "quantize_s": quant_s, "seconds": secs,
              "spec": {t: s for t, s in spec.items() if s["k"]},
              "cuda_launches": {k: c for k, c in
                                launches["cuda_spec0"].items() if c},
              "first_stream": streams["cuda_spec0"][0]})
        if not all(same.values()) or distinct < 2 or missing \
                or mode != "streaming":
            raise AssertionError(f"moe-parity {name}: streams {same}, "
                                 f"{distinct} distinct tokens, prefill "
                                 f"{mode}, never launched {missing}")
        toks = np.random.default_rng(41).integers(
            0, cfg.vocab, (MOE_BATCH, MOE_SEQ))
        rope = il.build_rope_table(MOE_SEQ + 1, cfg.hd, cfg.rope_theta)
        logits, drops, secs = {}, {}, {}
        for backend in ("cuda", "torch_ref"):
            step = make_prefill_step(cfg, plans, ops=backend, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with MoeDrops() as rec:
                logits[backend] = step(qp, {"tokens": toks}, rope)
            torch.cuda.synchronize()
            secs[backend] = time.perf_counter() - t0
            drops[backend] = rec.per_layer(cfg.num_layers)
        same = torch.equal(logits["cuda"], logits["torch_ref"])
        argmax = logits["cuda"].argmax(dim=-1)
        emit({"phase": "moe-parity", "arch": name, "layers": 2,
              "batch": MOE_BATCH, "seq": MOE_SEQ, "identical": same,
              "dropped_pairs_per_layer": drops["cuda"],
              "of_pairs": MOE_BATCH * MOE_SEQ * cfg.top_k,
              "distinct_argmax": len(set(argmax.tolist())),
              "finite": bool(torch.isfinite(logits["cuda"]).all()),
              "cuda_s": secs["cuda"], "torch_ref_s": secs["torch_ref"]})
        if not same or drops["cuda"] != drops["torch_ref"]:
            raise AssertionError(f"moe-parity {name}: prefill logits or "
                                 "drops differ between cuda and torch_ref")
        del qp


def phase_moe_serve(cfg, model):
    """qwen2-moe-a2.7b (``MOE_SERVE_LAYERS``) on ``cuda`` on the ``serve``
    phase's traffic
    (8 requests, prompts of 32-200 tokens from seed 5, 32 new tokens,
    batch 4), token-streaming prefill: tokens/s, device ms a step (CUDA
    events), peak memory, weight bytes, launches by kernel (K1, K2, K3
    and the grouped K1 > 0; every step K3 once and the grouped K1 three
    times a layer), then one profiled window of decode steps (device ms
    by kernel, the port's kernels against the glue, the grouped K1's
    share).  Returns the launches."""
    import numpy as np
    import torch
    from repro_torch import kernels
    qp, plans, quant_s = model
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(qp))
    prompts = _prompts(5, 8, 32, 200, cfg.vocab)
    eng, reqs = run_engine(qp, plans, cfg, prompts, 32, "cuda",
                           batch_size=4, cache_len=512, page_size=16,
                           fold_wo=True)
    with StepTimer(decode="int_decode_step") as timer:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    per_step = timer.launches("decode")
    step_ms = timer.ms("decode")
    n_tok = sum(len(r.out_tokens) for r in reqs)
    emit({"phase": "moe-serve", "arch": cfg.name, "layers": cfg.num_layers,
          "describe": eng.describe_str(), "requests": len(reqs),
          "prompt_lens": [len(p) for p in prompts], "max_new": 32,
          "batch": 4, "cache_len": 512, "tokens": n_tok,
          "distinct_tokens": len({t for r in reqs for t in r.out_tokens}),
          "wall_s": wall, "tokens_per_s": n_tok / wall,
          "decode_steps": len(step_ms),
          "decode_step_ms_mean": float(np.mean(step_ms)),
          "decode_step_ms_p50": float(np.median(step_ms)),
          "launches_per_decode_step": _mean_counts(per_step),
          "quantize_s": quant_s, "weight_bytes": weight_bytes,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches})
    if not all(len(r.out_tokens) == 32 for r in reqs):
        raise AssertionError("moe-serve: a request came back short")
    if not all(0 <= t < cfg.vocab for r in reqs for t in r.out_tokens):
        raise AssertionError("moe-serve: token outside the vocabulary")
    missing = [k for k in PATH_KERNELS["moe-serve"] if launches[k] <= 0]
    off = [i for i, c in enumerate(per_step)
           if c["int_decode_attention"] != cfg.num_layers
           or c["int8_matmul_grouped"] != 3 * cfg.num_layers]
    if missing or off:
        raise AssertionError(f"moe-serve never launched {missing}; steps "
                             f"without K3 once and the grouped K1 three "
                             f"times a layer: {off[:5]}")
    before = kernels.LAUNCHES["int8_matmul_grouped"]
    profile_decode(eng, cfg, "moe-serve-profile")
    emit({"phase": "moe-serve-profile", "grouped_launches":
          kernels.LAUNCHES["int8_matmul_grouped"] - before})
    return launches


def phase_moe_prefill(cfg, model):
    """qwen2-moe-a2.7b (``MOE_SERVE_LAYERS``) through
    ``make_prefill_step`` on ``cuda`` at 4 x 512 (K5: S * Skv <= 2^22):
    ms a pass (CUDA events), launches a pass, the dropped (token, slot)
    pairs of each layer, then one profiled pass.  Returns the launches of
    the timed passes."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import intlayers as il
    qp, plans, _ = model
    step = make_prefill_step(cfg, plans, ops="cuda", device="cuda")
    rope = il.build_rope_table(MOE_SEQ + 1, cfg.hd, cfg.rope_theta)
    batch = {"tokens": torch.as_tensor(np.random.default_rng(43).integers(
        0, cfg.vocab, (MOE_BATCH, MOE_SEQ)), device="cuda")}
    with MoeDrops() as rec:
        out = step(qp, batch, rope)
    drops = rec.per_layer(cfg.num_layers)
    n_pass = 3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_pass):
        out = step(qp, batch, rope)
    end.record()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    pass_ms = start.elapsed_time(end) / n_pass
    emit({"phase": "moe-prefill", "arch": cfg.name,
          "layers": cfg.num_layers, "batch": MOE_BATCH, "seq": MOE_SEQ,
          "passes": n_pass, "ms_per_pass": pass_ms,
          "tokens_per_s": MOE_BATCH * MOE_SEQ / (pass_ms / 1e3),
          "dropped_pairs_per_layer": drops,
          "of_pairs": MOE_BATCH * MOE_SEQ * cfg.top_k,
          "launches_per_pass": {n: c / n_pass for n, c in launches.items()
                                if c},
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "logits_shape": list(out.shape),
          "finite": bool(torch.isfinite(out).all())})
    if tuple(out.shape) != (MOE_BATCH, cfg.padded_vocab()) \
            or not bool(torch.isfinite(out).all()):
        raise AssertionError("moe-prefill: logits not finite (B, V)")
    missing = [k for k in PATH_KERNELS["moe-prefill"] if launches[k] <= 0]
    if missing:
        raise AssertionError(f"moe-prefill never launched {missing}")
    profile_window("moe-prefill-profile", f"1 pass, {MOE_BATCH} x "
                   f"{MOE_SEQ}", lambda: step(qp, batch, rope), lambda: 1,
                   (("int8_matmul_grouped_kernel",),
                    lambda: cfg.num_layers * 3))
    return launches


# ------------------------------------------------ state-space models -----

SSM_ARCHS = ("mamba2-130m", "jamba-v0.1-52b")
# mamba2-130m cut to 4 of its 24 layers (every layer is the same Mamba
# sublayer; to keep the whole script within its time); jamba runs one
# layer group (8 sublayers: every kind of the model); all 32 layers would
# be ~51.5 GB of int8 and their set-up in every run
SSM_LAYERS = {"mamba2-130m": 4, "jamba-v0.1-52b": 8}
SSM_PHASES = {"mamba2-130m": "ssm", "jamba-v0.1-52b": "hybrid"}
SSM_BATCH, SSM_SEQ, SSM_STREAM_SEQ, SSM_PROFILE_SEQ = 4, 512, 64, 16


def ssm_config(name: str):
    """Full-width ``name`` cut to ``SSM_LAYERS``; jamba to one layer
    group."""
    return moe_config(name, SSM_LAYERS[name])


def ssm_decode_launches(cfg) -> dict:
    """A decode step's launches: K1 three a Mamba sublayer (in_proj, the
    raw Δt projection, out_proj), four an attention one (q, k, v, and wo
    after K3), three a SwiGLU FFN, the router an MoE, and the head; K2
    norm1 a layer, norm2 a layer with an FFN or MoE, the gated norm a
    Mamba sublayer, and the final norm; K3 one an attention sublayer;
    the grouped K1 three an MoE."""
    from repro_torch.models.transformer import layer_group_spec
    _, ng, kinds = layer_group_spec(cfg)
    n = {k: ng * sum(kind[i] == k for kind in kinds)
         for i, k in ((0, "ssm"), (0, "attn"), (1, "ffn"), (1, "moe"))}
    return {"int8_matmul": 3 * n["ssm"] + 4 * n["attn"] + 3 * n["ffn"]
            + n["moe"] + 1,
            "int_layernorm": cfg.num_layers + n["ffn"] + n["moe"]
            + n["ssm"] + 1,
            "int_decode_attention": n["attn"],
            "int8_matmul_grouped": 3 * n["moe"]}


def check_ssm_kernels(rows) -> None:
    """The kernels at the state-space configs' shapes, each exact against
    its plain version: K1 at both configs' in_proj (to int8), Δt
    projection (raw int32; mamba2's N = 24 takes the decode tile's copy
    route) and out_proj (14 bits) for a decode step (M 4) and a 4 x 512
    prefill (M 2048, beside ``torch._int_mm``); K2's RMSNorm over d_inner
    with the Mamba plan (s_in 1, qmax_in 2^11, no mean) at 1536 and at
    8192 (its longest row), 4 and 2048 rows (the grouped K1 at jamba's
    experts is among ``moe-kernels``' rows)."""
    import torch
    from repro_torch.kernels.int8_matmul import (int8_matmul,
                                                 int8_matmul_plain)
    from repro_torch.models.mamba import proj_width
    from repro_torch.ops.spec import RequantSpec
    from repro_torch.quant import plans as qplans
    gen = torch.Generator(device="cuda").manual_seed(5151)
    for name in SSM_ARCHS:
        cfg = ssm_config(name)
        mp = qplans.build_layer_plans(cfg).mamba
        d, di, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_heads
        linears = (("in_proj", d, proj_width(cfg) - h, mp.in_proj),
                   ("dt_proj", d, h, qplans.LinearPlan(
                       mp.in_proj.s_in, 0.0, 32, 0, 0, d)),
                   ("out_proj", di, d, mp.out_proj))
        for m in (4, SSM_BATCH * SSM_SEQ):
            for lin, k, n, lp in linears:
                x8 = _randint(gen, -127, 128, (m, k), torch.int8)
                w8 = _randint(gen, -127, 128, (k, n), torch.int8)
                spec = RequantSpec.for_linear(lp)
                bv = None if spec.is_raw else _randint(gen, 256, 4096, (n,),
                                                       torch.int32)
                out_b = 4 if spec.is_raw or spec.out_bits > 8 else 1
                record(rows, "int8_matmul",
                       f"{name} {lin} M={m} K={k} N={n} "
                       f"{'raw' if spec.is_raw else spec.out_bits}",
                       int8_matmul(x8, w8, spec, b_vec=bv),
                       int8_matmul_plain(x8, w8, spec, b_vec=bv),
                       lambda: int8_matmul(x8, w8, spec, b_vec=bv),
                       lambda: int8_matmul_plain(x8, w8, spec, b_vec=bv),
                       m * k + k * n + (0 if bv is None else 4 * n)
                       + out_b * m * n, 2 * m * k * n,
                       lib_ms=int_mm_ms(x8, w8) if m > 16 else None,
                       plain_iters=2, plan=k1_plan(m, n, k, x8=x8, w=w8))
                del x8, w8
        for r in (4, SSM_BATCH * SSM_SEQ):
            q = _randint(gen, -2048, 2049, (r, di), torch.int32)
            q[0] = 2048
            g = _randint(gen, -127, 128, (di,), torch.int32)
            k2_row(rows, f"{name} gated RMSNorm (s_in 1, qmax 2^11)", q, g,
                   None, mp.norm)


def _ssm_streams(qp, plans, cfg, prompts, backend, cache_mode):
    """A ServingEngine run (batch 4, token-streaming prefill): streams,
    seconds, launches, the engine's description."""
    from repro_torch import kernels
    eng, reqs = run_engine(qp, plans, cfg, prompts, 8, backend,
                           batch_size=SSM_BATCH, cache_len=256,
                           page_size=16, fold_wo=True,
                           cache_mode=cache_mode)
    kernels.reset_launches()
    streams, secs = drain_streams(eng, reqs)
    return streams, secs, dict(kernels.LAUNCHES), eng.describe()


def phase_ssm_parity(name, model):
    """``<ssm|hybrid>-parity``: mamba2-130m (4 of 24 layers) or jamba-v0.1-52b
    (one group of 8) at full width.  ``ServingEngine`` streams (6 prompts of
    8-24 tokens on 4 lanes: two lanes recycled, their state zeroed) on ``cuda``
    equal ``torch_ref``'s, in the paged and the contiguous layout;
    ``make_prefill_step`` logits at 4 x 512 on ``cuda`` equal ``torch_ref``'s;
    ``int_prefill``'s last logits at 4 x 64 equal the token-streamed decode's
    (``make_decode_step``; jamba at capacity factor 8, where no prefill group
    drops a token, as the reference's own check runs).  The ``cuda`` pass at 4
    x 512 is also the timed ``<ssm|hybrid>-prefill`` path (CUDA events,
    launches, peak memory): its launches are returned."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import inttransformer as it
    phase = f"{SSM_PHASES[name]}-parity"
    qp, plans, quant_s = model
    cfg = ssm_config(name)
    prompts = _prompts(47, 6, 4, 12, cfg.vocab)
    streams, secs, launches = {}, {}, {}
    for mode in ("paged", "contiguous"):
        for backend in ("cuda", "torch_ref"):
            tag = f"{backend}_{mode}"
            streams[tag], secs[tag], launches[tag], d = _ssm_streams(
                qp, plans, cfg, prompts, backend, mode)
            if d["prefill"]["mode"] != "streaming":
                raise AssertionError(f"{phase}: prefill {d['prefill']}")
    same = {t: s == streams["cuda_paged"] for t, s in streams.items()}
    distinct = len({t for s in streams["cuda_paged"] for t in s})
    missing = [k for k in PATH_KERNELS[f"{SSM_PHASES[name]}-serve"]
               if launches["cuda_paged"][k] <= 0]
    emit({"phase": phase, "arch": name, "layers": cfg.num_layers,
          "requests": len(prompts), "lanes": SSM_BATCH,
          "prompt_lens": [len(p) for p in prompts], "identical": same,
          "distinct_tokens": distinct, "quantize_s": quant_s,
          "seconds": secs,
          "cuda_launches": {k: c for k, c in launches["cuda_paged"].items()
                            if c},
          "first_stream": streams["cuda_paged"][0]})
    if not all(same.values()) or distinct < 2 or missing:
        raise AssertionError(f"{phase}: streams {same}, {distinct} distinct "
                             f"tokens, never launched {missing}")
    toks = np.random.default_rng(53).integers(0, cfg.vocab,
                                              (SSM_BATCH, SSM_SEQ))
    logits, secs = {}, {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for backend in ("torch_ref", "cuda"):
        step = make_prefill_step(cfg, plans, ops=backend, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        start.record()
        logits[backend] = step(qp, {"tokens": toks})
        end.record()
        torch.cuda.synchronize()
        secs[backend] = time.perf_counter() - t0
    pre_launches = dict(kernels.LAUNCHES)
    pass_ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated()
    same = torch.equal(logits["cuda"], logits["torch_ref"])
    # the reference's own check: prefill == the same tokens streamed
    roomy = dataclasses.replace(cfg, capacity_factor=8.0)
    short = toks[:, :SSM_STREAM_SEQ]
    pre = make_prefill_step(roomy, plans, ops="cuda", device="cuda")(
        qp, {"tokens": short})
    caches = it.init_decode_cache(cfg, device="cuda", batch=SSM_BATCH,
                                  cache_len=SSM_STREAM_SEQ)
    decode = make_decode_step(cfg, plans, SSM_STREAM_SEQ, ops="cuda",
                              device="cuda")
    kernels.reset_launches()
    for t in range(SSM_STREAM_SEQ):
        last, caches = decode(qp, caches, short[:, t],
                              np.full(SSM_BATCH, t, np.int32))
    streamed = torch.equal(pre, last)
    argmax = logits["cuda"].argmax(dim=-1)
    emit({"phase": phase, "arch": name, "layers": cfg.num_layers,
          "batch": SSM_BATCH, "seq": SSM_SEQ, "identical": same,
          "prefill_equals_streamed_decode": streamed,
          "streamed_seq": SSM_STREAM_SEQ,
          "decode_launches": {k: c / SSM_STREAM_SEQ
                              for k, c in kernels.LAUNCHES.items() if c},
          "distinct_argmax": len(set(argmax.tolist())),
          "finite": bool(torch.isfinite(logits["cuda"]).all()),
          "cuda_s": secs["cuda"], "torch_ref_s": secs["torch_ref"]})
    if not same or not streamed:
        raise AssertionError(f"{phase}: prefill logits differ between "
                             f"cuda and torch_ref ({same}) or from the "
                             f"streamed decode ({streamed})")
    prefill = f"{SSM_PHASES[name]}-prefill"
    emit({"phase": prefill, "arch": name, "layers": cfg.num_layers,
          "batch": SSM_BATCH, "seq": SSM_SEQ, "ms_per_pass": pass_ms,
          "wall_s": secs["cuda"],
          "tokens_per_s": SSM_BATCH * SSM_SEQ / (pass_ms / 1e3),
          "launches_per_pass": {n: c for n, c in pre_launches.items() if c},
          "max_memory_allocated": peak})
    missing = [k for k in PATH_KERNELS[prefill] if pre_launches[k] <= 0]
    if missing:
        raise AssertionError(f"{prefill} never launched {missing}")
    return {prefill: pre_launches}


def phase_ssm_serve(name, model):
    """``<ssm|hybrid>-serve``: mamba2-130m (4 of 24 layers) or
    jamba-v0.1-52b (one group) on ``cuda`` on the ``serve`` phase's
    traffic (8 requests, prompts of 32-200 tokens from seed 5, 32 new
    tokens, batch 4, cache_len 512), token-streaming prefill: tokens/s,
    device ms a step (CUDA events), wall ms a step, peak memory, weight
    bytes, launches a step (each as :func:`ssm_decode_launches` counts),
    then a profiled decode window (the busy share, the port's kernels
    against the glue: the recurrence, conv, Δt and gate code, and for
    jamba the MoE routing) and a profiled 4 x 16 prefill pass (its
    sequential state updates, one a token and a Mamba sublayer).  Returns
    the launches of the serve run, by path."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.launch.steps import make_prefill_step
    phase = f"{SSM_PHASES[name]}-serve"
    qp, plans, quant_s = model
    cfg = ssm_config(name)
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(qp))
    prompts = _prompts(5, 8, 32, 200, cfg.vocab)
    eng, reqs = run_engine(qp, plans, cfg, prompts, 32, "cuda",
                           batch_size=4, cache_len=512, page_size=16,
                           fold_wo=True)
    state_bytes = sum(c[k].numel() * c[k].element_size()
                      for c in eng.caches for k in ("h", "conv") if k in c)
    with StepTimer(decode="int_decode_step") as timer:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    per_step = timer.launches("decode")
    step_ms = timer.ms("decode")
    n_tok = sum(len(r.out_tokens) for r in reqs)
    want = ssm_decode_launches(cfg)
    emit({"phase": phase, "arch": cfg.name, "layers": cfg.num_layers,
          "describe": eng.describe_str(), "requests": len(reqs),
          "prompt_lens": [len(p) for p in prompts], "max_new": 32,
          "batch": 4, "cache_len": 512, "tokens": n_tok,
          "distinct_tokens": len({t for r in reqs for t in r.out_tokens}),
          "wall_s": wall, "tokens_per_s": n_tok / wall,
          "decode_steps": len(step_ms),
          "wall_ms_per_step": wall * 1e3 / max(len(step_ms), 1),
          "decode_step_ms_mean": float(np.mean(step_ms)),
          "decode_step_ms_p50": float(np.median(step_ms)),
          "launches_per_decode_step": _mean_counts(per_step),
          "expected_launches_per_step": want,
          "quantize_s": quant_s, "weight_bytes": weight_bytes,
          "mamba_state_bytes": state_bytes,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches})
    if not all(len(r.out_tokens) == 32 for r in reqs):
        raise AssertionError(f"{phase}: a request came back short")
    if not all(0 <= t < cfg.vocab for r in reqs for t in r.out_tokens):
        raise AssertionError(f"{phase}: token outside the vocabulary")
    missing = [k for k in PATH_KERNELS[phase] if launches[k] <= 0]
    off = [i for i, c in enumerate(per_step)
           if any(c[k] != v for k, v in want.items())]
    if missing or off:
        raise AssertionError(f"{phase} never launched {missing}; steps "
                             f"off {want}: {off[:5]} "
                             f"{per_step[off[0]] if off else ''}")
    profile_decode(eng, cfg, f"{phase}-profile", "int_decode_attention")
    del eng
    # a profiled prefill pass (the profiler's post-processing takes ~0.5
    # ms an event: 4 x 512 is ~780 000 kernel calls for mamba2-130m, so a
    # short pass stands in for it; its sequential part is ~45 launches a
    # token and a Mamba sublayer either way)
    step = make_prefill_step(cfg, plans, ops="cuda", device="cuda")
    batch = {"tokens": torch.as_tensor(np.random.default_rng(59).integers(
        0, cfg.vocab, (SSM_BATCH, SSM_PROFILE_SEQ)), device="cuda")}
    step(qp, batch)
    profile_window(f"{SSM_PHASES[name]}-prefill-profile", f"1 pass, "
                   f"{SSM_BATCH} x {SSM_PROFILE_SEQ}", lambda: step(qp, batch),
                   lambda: 1)
    return {phase: launches}


# ---------------------------------------- cross attention over a memory --

CROSS_ARCHS = ("seamless-m4t-large-v2", "llama-3.2-vision-90b")
CROSS_PHASES = {"seamless-m4t-large-v2": "encdec",
                "llama-3.2-vision-90b": "vlm"}
# seamless at full width cut to 4 encoder + 4 decoder layers of its 24 +
# 24 (to keep the whole script within its time); the VLM at full width
# cut to one group of five sublayers (4 self, 1 cross): 100 layers would
# be ~86 GB of int8 linears, more than the card holds
CROSS_LAYERS = {"seamless-m4t-large-v2": 4, "llama-3.2-vision-90b": 5}
# the memory: seamless's source frames, the VLM's image tokens
CROSS_MEMORY = {"seamless-m4t-large-v2": 512, "llama-3.2-vision-90b": 1600}
CROSS_BATCH, CROSS_SEQ, CROSS_NEW, CROSS_PROFILE_STEPS = 4, 64, 32, 4


def cross_config(name: str):
    """Full-width ``name`` cut to ``CROSS_LAYERS`` (an encoder-decoder's
    encoder and decoder stacks both); the VLM to one group of five."""
    import dataclasses
    cfg = moe_config(name, CROSS_LAYERS[name])
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, enc_layers=CROSS_LAYERS[name],
                                  dec_layers=CROSS_LAYERS[name])
    return cfg


def cross_batch(cfg, seed: int):
    """``CROSS_BATCH`` prompts of ``CROSS_SEQ`` tokens (from ``seed``) and the
    float32 memory (unit std, drawn on the card from ``seed``):
    ``src_embeds`` (B, 512, D) or ``img_embeds`` (B, 1600, D)."""
    import numpy as np
    import torch
    key = "src_embeds" if cfg.family == "encdec" else "img_embeds"
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mem = torch.randn((CROSS_BATCH, CROSS_MEMORY[cfg.name], cfg.d_model),
                      generator=gen, device="cuda", dtype=torch.float32)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab,
                                                (CROSS_BATCH, CROSS_SEQ))
    return {"tokens": torch.as_tensor(toks, device="cuda"), key: mem}


def cross_decode_launches(cfg) -> dict:
    """A decode step's launches: K1 four a self attention (q, k, v, and wo
    after K3), two a cross attention (q and wo: its K/V are the cache's),
    two a GELU FFN (w1, w2; K6 between) or three a SwiGLU one, and the
    head; K2 a norm each (norm1, norm_cross, norm2) and the final norm;
    K3 one an attention; K6 one a GELU FFN."""
    from repro_torch.models.transformer import layer_group_spec
    _, ng, kinds = layer_group_spec(cfg)
    self_ = ng * sum(mix == "attn" for mix, _, _ in kinds)
    cross = ng * sum(mix == "cross" or c for mix, _, c in kinds)
    ffn = ng * len(kinds)
    gelu = cfg.activation == "gelu"
    return {"int8_matmul": 4 * self_ + 2 * cross + (2 if gelu else 3) * ffn
            + 1,
            "int_layernorm": ng * sum(1 + c + (ff is not None)
                                      for _, ff, c in kinds) + 1,
            "int_decode_attention": self_ + cross,
            "int_gelu": ffn if gelu else 0}


def check_cross_kernels(rows) -> None:
    """The kernels at the cross attention paths' full-width shapes, each
    exact against its plain version: K1 at seamless's raw head (1024 x
    256 208, the widest N of any path) and the VLM's wq, w1 and w2 at M 4,
    and the VLM's cross K/V projection over its memory (M 4 x 1600, K
    8192, N 1024) beside ``torch._int_mm``; K2's residual norm: seamless's
    LayerNorm + beta at d 1024 and the VLM's RMSNorm at d 8192 (``MAX_D``),
    4 and 2048 rows; K5 over seamless's encoder (B 4, S 512, H 16, D 64,
    no mask) and cross at seamless's 4 x 64 x 512 and the VLM's 4 x 64 x
    1600 (GQA 64 / 8, D 128: a partial last key tile); K6 over seamless's
    decoder FFN at a 4 x 64 prefill (256 x 8192); K3 as ``_cross_decode``
    runs it, one query over the whole contiguous memory (``valid = Skv``)
    at seamless's 512 (MHA 16 / 16, D 64) and the VLM's 1600 (GQA 64 /
    8, D 128)."""
    import torch
    from repro_torch.kernels.int8_matmul import (int8_matmul,
                                                 int8_matmul_plain)
    from repro_torch.kernels.int_decode_attention import (
        int_decode_attention_fused, int_decode_attention_plain)
    from repro_torch.kernels.int_gelu import int_gelu, int_gelu_plain
    from repro_torch.ops.spec import RequantSpec
    from repro_torch.quant import plans as qplans
    gen = torch.Generator(device="cuda").manual_seed(8080)
    sm, vl = (cross_config(n) for n in CROSS_ARCHS)
    smp, vlp = (qplans.build_layer_plans(c) for c in (sm, vl))
    raw = RequantSpec.raw()

    # K1
    mm = [("seamless head", 4, sm.d_model, sm.padded_vocab(), None),
          ("vlm wq", 4, vl.d_model, vl.n_heads * vl.hd, vlp.attn.qkv),
          ("vlm w1", 4, vl.d_model, vl.d_ff, vlp.ffn.up),
          ("vlm w2", 4, vl.d_ff, vl.d_model, vlp.ffn.down),
          ("vlm cross wk over the memory",
           CROSS_BATCH * CROSS_MEMORY[vl.name], vl.d_model,
           vl.n_kv_heads * vl.hd, vlp.cross.qkv)]
    for tag, m, k, n, lp in mm:
        x8 = _randint(gen, -127, 128, (m, k), torch.int8)
        w8 = _randint(gen, -127, 128, (k, n), torch.int8)
        spec = raw if lp is None else RequantSpec.for_linear(lp)
        b_vec = None if lp is None else _randint(gen, 256, 4096, (n,),
                                                 torch.int32)
        out_b = 4 if spec.is_raw or spec.out_bits > 8 else 1
        record(rows, "int8_matmul", f"{tag} M={m} K={k} N={n} "
               f"{'raw' if spec.is_raw else spec.out_bits}",
               int8_matmul(x8, w8, spec, b_vec=b_vec),
               int8_matmul_plain(x8, w8, spec, b_vec=b_vec),
               lambda: int8_matmul(x8, w8, spec, b_vec=b_vec),
               lambda: int8_matmul_plain(x8, w8, spec, b_vec=b_vec),
               m * k + k * n + (0 if b_vec is None else 4 * n)
               + out_b * m * n, 2 * m * k * n,
               lib_ms=int_mm_ms(x8, w8) if m > 16 else None, iters=10,
               plain_iters=2, plan=k1_plan(m, n, k, x8=x8, w=w8))
        del x8, w8

    # K2: the residual norm (norm1 / norm_cross / norm2 / the final norm)
    for c, p, beta in ((sm, smp, True), (vl, vlp, False)):
        gamma = _randint(gen, 40, 128, (c.d_model,), torch.int32)
        bvec = _randint(gen, -9000, 9000, (c.d_model,), torch.int32) \
            if beta else None
        for r in (CROSS_BATCH, 2048):
            q = _randint(gen, -c.qmax_res, c.qmax_res + 1, (r, c.d_model),
                         torch.int32)
            k2_row(rows, f"{CROSS_PHASES[c.name]} "
                   f"{'layernorm+beta' if beta else 'rmsnorm'}", q, gamma,
                   bvec, p.norm)
            del q

    # K5: seamless's encoder, then cross attention over both memories
    m_sm, m_vl = CROSS_MEMORY[sm.name], CROSS_MEMORY[vl.name]
    for tag, c, p, sq, skv in (("seamless encoder ", sm, smp, m_sm, m_sm),
                               ("seamless cross ", sm, smp, CROSS_SEQ, m_sm),
                               ("vlm cross ", vl, vlp, CROSS_SEQ, m_vl)):
        ap = p.cross.attn
        k5_row(gen, rows, ap, CROSS_BATCH, sq, skv, c.n_heads, c.n_kv_heads,
               c.hd, False, 0, RequantSpec.per_tensor(ap.dn_out), "random",
               False, tag=tag)

    # K6: seamless's decoder FFN at a 4 x 64 prefill
    gp = smp.ffn.act_gelu
    q = _randint(gen, -1024, 1024, (CROSS_BATCH * CROSS_SEQ, sm.d_ff),
                 torch.int32)
    record(rows, "int_gelu", f"seamless FFN {q.shape[0]}x{sm.d_ff} 11-bit",
           int_gelu(q, gp.gelu, gp.dn_out),
           int_gelu_plain(q, gp.gelu, gp.dn_out),
           lambda: int_gelu(q, gp.gelu, gp.dn_out),
           lambda: int_gelu_plain(q, gp.gelu, gp.dn_out),
           8 * q.numel(), 0, iters=20)

    # K3: one query over the whole memory
    for c, p in ((sm, smp), (vl, vlp)):
        skv, b = CROSS_MEMORY[c.name], CROSS_BATCH
        ap = p.cross.attn
        q8 = _randint(gen, -127, 128, (b, 1, c.n_heads, c.hd), torch.int8)
        k8 = _randint(gen, -127, 128, (b, skv, c.n_kv_heads, c.hd),
                      torch.int8)
        v8 = _randint(gen, -127, 128, (b, skv, c.n_kv_heads, c.hd),
                      torch.int8)
        lens = [skv] * b
        valid = torch.tensor(lens, dtype=torch.int32, device="cuda")
        kw = dict(requant=RequantSpec.per_tensor(ap.dn_out))
        nbytes, ops = k4_bound(lens, 1, c.n_heads, c.n_kv_heads, c.hd, 0, 1)
        args = (q8, k8, v8, ap, valid)
        record(rows, "int_decode_attention",
               f"{CROSS_PHASES[c.name]} cross decode B={b} Sq=1 "
               f"H={c.n_heads} Hkv={c.n_kv_heads} D={c.hd} contiguous "
               f"L={skv} valid={skv}",
               int_decode_attention_fused(*args, **kw),
               int_decode_attention_plain(*args, **kw),
               lambda: int_decode_attention_fused(*args, **kw),
               lambda: int_decode_attention_plain(*args, **kw),
               nbytes, ops, iters=10, plain_iters=2,
               plan=k3_plan(q8, k8, v8, kw))
        del q8, k8, v8, args


def _rope(cfg, length: int):
    """The integer RoPE tables of ``cfg`` on the card (None without)."""
    from repro_torch.models import intlayers as il
    return (il.build_rope_table(length + 1, cfg.hd, cfg.rope_theta,
                                device="cuda"),) if cfg.pos == "rope" else ()


def _caches_same(a, b):
    """Whether two cache lists hold the same keys and equal tensors."""
    import torch
    return len(a) == len(b) and all(
        set(x) == set(y) and all(torch.equal(x[k], y[k]) for k in x)
        for x, y in zip(a, b))


def phase_cross_parity(name, model):
    """``<encdec|vlm>-parity``: seamless-m4t-large-v2 (4 + 4 of 24 + 24
    layers) or llama-3.2-vision-90b (one group of five) at full width
    over a memory of 4 x 512 frames / 4 x 1600 image tokens.
    ``make_prefill_step`` logits at 4 x 64 on ``cuda`` equal ``torch_ref``'s;
    ``int_prefill(return_cache=True)`` of the first 63 tokens, then one
    ``make_decode_step`` of token 63, equals the 64-token prefill on both
    backends (the reference's own check); the caches built (self K/V and
    the memory's ``ck8`` / ``cv8``) are equal on both.  The path's
    launches on ``cuda`` (prefill, cache build, decode step) are
    returned."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import inttransformer as it
    phase = f"{CROSS_PHASES[name]}-parity"
    qp, plans, quant_s = model
    cfg = cross_config(name)
    batch = cross_batch(cfg, 61)
    s = CROSS_SEQ
    logits, stepped, caches, secs = {}, {}, {}, {}
    launches = {}
    for backend in ("cuda", "torch_ref"):
        prefill = make_prefill_step(cfg, plans, ops=backend, device="cuda")
        decode = make_decode_step(cfg, plans, s, ops=backend, device="cuda")
        short = dict(batch, tokens=batch["tokens"][:, :s - 1])
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        logits[backend] = prefill(qp, batch, *_rope(cfg, s))
        _, cache = it.int_prefill(qp, short, plans, cfg, ops=backend,
                                  return_cache=True, cache_len=s)
        stepped[backend], caches[backend] = decode(
            qp, cache, batch["tokens"][:, s - 1],
            np.full(CROSS_BATCH, s - 1, np.int32), *_rope(cfg, s))
        torch.cuda.synchronize()
        secs[backend] = time.perf_counter() - t0
        launches[backend] = dict(kernels.LAUNCHES)
    same = torch.equal(logits["cuda"], logits["torch_ref"])
    consistent = {b: torch.equal(stepped[b], logits[b]) for b in stepped}
    same_caches = _caches_same(caches["cuda"], caches["torch_ref"])
    keys = sorted({k for c in caches["cuda"] for k in c})
    argmax = logits["cuda"].argmax(dim=-1)
    missing = [k for k in PATH_KERNELS[phase] if launches["cuda"][k] <= 0]
    emit({"phase": phase, "arch": name, "layers": cfg.num_layers,
          "enc_layers": cfg.enc_layers, "batch": CROSS_BATCH, "seq": s,
          "memory": CROSS_MEMORY[name], "identical": same,
          "prefill_63_plus_decode_equals_64": consistent,
          "caches_identical": same_caches, "cache_keys": keys,
          "distinct_argmax": len(set(argmax.tolist())),
          "finite": bool(torch.isfinite(logits["cuda"]).all()),
          "quantize_s": quant_s, "seconds": secs,
          "cuda_launches": {k: c for k, c in launches["cuda"].items()
                            if c}})
    if not same or not all(consistent.values()) or not same_caches \
            or "ck8" not in keys or missing:
        raise AssertionError(f"{phase}: logits {same}, 63 + 1 == 64 "
                             f"{consistent}, caches {same_caches} {keys}, "
                             f"never launched {missing}")
    return {phase: launches["cuda"]}


def phase_cross_decode(name, model):
    """``<encdec|vlm>-decode``: 4 requests with 64-token prompts (seed 5)
    over their memory, ``int_prefill(return_cache=True)``, then 32 greedy
    tokens through ``make_decode_step``: the streams of ``cuda`` equal
    ``torch_ref``'s.  Reports tokens/s, device (CUDA events) and wall ms a
    decode step, launches a step (as :func:`cross_decode_launches`
    counts), the device ms of the memory (the encoder, or the image
    embeddings' quantization) and of the cross K/V set-up a request
    (``init_decode_cache(memory8=)``), then a profiled window of decode
    steps (the busy share).  Returns the path's launches on ``cuda``."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import inttransformer as it
    from repro_torch.ops import resolve_ops
    phase = f"{CROSS_PHASES[name]}-decode"
    qp, plans, _ = model
    cfg = cross_config(name)
    batch = cross_batch(cfg, 5)
    L = CROSS_SEQ + CROSS_NEW
    rope = _rope(cfg, L)
    streams, walls, out = {}, {}, {}
    for backend in ("cuda", "torch_ref"):
        decode = make_decode_step(cfg, plans, L, ops=backend, device="cuda")
        torch.cuda.synchronize()
        kernels.reset_launches()
        logits, caches = it.int_prefill(qp, batch, plans, cfg, ops=backend,
                                        return_cache=True, cache_len=L)
        tok, toks = logits.argmax(-1), []
        with StepTimer(decode="int_decode_step") as timer:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(CROSS_NEW):
                toks.append(tok)
                logits, caches = decode(
                    qp, caches, tok,
                    np.full(CROSS_BATCH, CROSS_SEQ + t, np.int32), *rope)
                tok = logits.argmax(-1)
            torch.cuda.synchronize()
            walls[backend] = time.perf_counter() - t0
        streams[backend] = torch.stack(toks, 1).tolist()
        out[backend] = (timer, dict(kernels.LAUNCHES), caches)
    timer, launches, caches = out["cuda"]
    same = streams["cuda"] == streams["torch_ref"]
    per_step, step_ms = timer.launches("decode"), timer.ms("decode")
    want = cross_decode_launches(cfg)
    off = [i for i, c in enumerate(per_step)
           if any(c[k] != v for k, v in want.items())]
    missing = [k for k in PATH_KERNELS[phase] if launches[k] <= 0]
    # the memory and the cross K/V set-up, timed alone on the card
    ops = resolve_ops("cuda", cfg)
    start = torch.cuda.Event(enable_timing=True)
    mid = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    mem8 = it._memory(qp, batch, plans, cfg, ops)
    mid.record()
    it.init_decode_cache(cfg, device="cuda", batch=CROSS_BATCH,
                         cache_len=L, memory8=mem8, qparams=qp, plans=plans,
                         ops=ops)
    end.record()
    torch.cuda.synchronize()
    n_tok = CROSS_BATCH * CROSS_NEW
    emit({"phase": phase, "arch": name, "layers": cfg.num_layers,
          "enc_layers": cfg.enc_layers, "requests": CROSS_BATCH,
          "prompt_len": CROSS_SEQ, "memory": CROSS_MEMORY[name],
          "new_tokens": CROSS_NEW, "identical": same,
          "distinct_tokens": len({t for s in streams["cuda"] for t in s}),
          "tokens_per_s": n_tok / walls["cuda"],
          "wall_ms_per_step": walls["cuda"] * 1e3 / CROSS_NEW,
          "decode_step_ms_mean": float(np.mean(step_ms)),
          "decode_step_ms_p50": float(np.median(step_ms)),
          "torch_ref_wall_s": walls["torch_ref"],
          "launches_per_decode_step": _mean_counts(per_step),
          "expected_launches_per_step": want,
          "memory_ms": start.elapsed_time(mid),
          "cross_kv_ms_per_request": mid.elapsed_time(end) / CROSS_BATCH,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "first_stream": streams["cuda"][0]})
    if not same or missing or off:
        raise AssertionError(f"{phase}: streams identical {same}, never "
                             f"launched {missing}, steps off {want}: "
                             f"{off[:5]} {per_step[off[0]] if off else ''}")
    decode = make_decode_step(cfg, plans, L, ops="cuda", device="cuda")
    tok = torch.as_tensor(streams["cuda"], device="cuda")[:, -1]

    def window():
        for t in range(CROSS_PROFILE_STEPS):
            decode(qp, caches, tok, np.full(CROSS_BATCH, CROSS_SEQ + t,
                                            np.int32), *rope)
    profile_window(f"{phase}-profile", f"{CROSS_PROFILE_STEPS} decode steps,"
                   f" batch {CROSS_BATCH}", window,
                   lambda: CROSS_PROFILE_STEPS)
    return {phase: launches}


# ------------------------------------------------- tensor parallelism ----

# tp-parity: llama3-8b at full width cut to 1 layer (and qwen2-moe-a2.7b
# in the 2-rank world), each mode at tp = 1 in this process and sharded in
# worlds of 2 and 4 ranks on the one card (1 layer holds the whole script
# within its time; the ranks' time is mostly gloo's, a layer at a time)
TP_LAYERS = 1
TP_MODES = {"chunked": dict(prefill_chunk=32),
            "streaming": dict(prefill_chunk=0),
            "contiguous": dict(cache_mode="contiguous"),
            "int4": dict(prefill_chunk=32, kv_dtype="int4"),
            "spec": dict(prefill_chunk=32, spec_k=SPEC_K)}
TP_GEOM = dict(batch_size=4, cache_len=512, page_size=16, fold_wo=True)
TP_MOE_GEOM = dict(batch_size=4, cache_len=256, page_size=16, fold_wo=True)
# the ranks' process group: NCCL refuses two ranks on one card, gloo
# takes CUDA tensors (through host memory)
TP_BACKEND = "gloo"
TP_WORLD_TIMEOUT_S = 420
# the stream and launch tags each tp-parity run must show: K3 in every
# mode (its int4 instantiation over int4 pages), K4 wherever the prefill
# is chunked, the grouped K1 for the MoE
TP_RUN_KERNELS = {
    "chunked": ("int_decode_attention", "int_paged_prefill"),
    "streaming": ("int_decode_attention",),
    "contiguous": ("int_decode_attention",),
    "int4": ("int_decode_attention_kv4", "int_paged_prefill_kv4"),
    "spec": ("int_decode_attention", "int_paged_prefill"),
    "moe": ("int_decode_attention", "int8_matmul_grouped")}
# the serve phase's streams, which tp-serve must give
SERVE_STREAMS = {}


def check_tp_kernels(rows) -> None:
    """The kernels at every shape a tensor-parallel rank of ``tp-parity``
    and ``tp-serve`` gives them, each exact against its plain version.
    llama3-8b at tp 2 and 4 (16 / 4 and 8 / 2 heads): K1 at wq's and
    wk's (= wv's) column slices (N 4096 / tp, 1024 / tp, per-channel) and
    wo's row slice (K 4096 / tp, raw: the partial the group sums), each at
    M 4 (a decode step), 16 (a verify step of 4 x 4 rows) and 128 (a 4 x
    32 chunk, beside ``torch._int_mm``); K3 at the local heads over pages
    (serve row, verify Sq 4) and over the contiguous cache (L 512), K4 (C
    32), over int8 pages unfolded as a sharded engine runs them (and
    folded, for the record), and over int4 pages unfolded.
    qwen2-moe-a2.7b at tp 2 (8 / 8 heads, M 4: its prompts stream): K1
    at wq's / wk's / wv's column slice with the QKV bias (K 2048, N 1024)
    and wo's raw row slice (K 1024, N 2048), K3 over its 16 pages a
    lane."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.tp_serving import local_cfg
    from repro_torch.kernels.int8_matmul import (int8_matmul,
                                                 int8_matmul_plain)
    from repro_torch.kernels.int_decode_attention import (
        int_decode_attention_fused, int_decode_attention_plain)
    from repro_torch.ops.spec import RequantSpec
    from repro_torch.quant import plans as qplans
    gen = torch.Generator(device="cuda").manual_seed(3232)
    raw = RequantSpec.raw()

    def k1_row(case, m, k, n, spec, bias=False):
        x8 = _randint(gen, -127, 128, (m, k), torch.int8)
        w8 = _randint(gen, -127, 128, (k, n), torch.int8)
        kw = {}
        if not spec.is_raw:
            kw["b_vec"] = _randint(gen, 256, 4096, (n,), torch.int32)
        if bias:
            kw["bias32"] = _randint(gen, -5000, 5000, (n,), torch.int32)
        out_bytes = (4 if spec.is_raw else 1) * m * n
        record(rows, "int8_matmul", f"{case} M={m} K={k} N={n}",
               int8_matmul(x8, w8, spec, **kw),
               int8_matmul_plain(x8, w8, spec, **kw),
               lambda: int8_matmul(x8, w8, spec, **kw),
               lambda: int8_matmul_plain(x8, w8, spec, **kw),
               m * k + k * n + 4 * n * len(kw) + out_bytes, 2 * m * k * n,
               lib_ms=int_mm_ms(x8, w8) if m > 16 else None,
               plan=k1_plan(m, n, k, x8=x8, w=w8))

    cfg = get_config("llama3-8b")
    plans = qplans.build_layer_plans(cfg)
    d = cfg.d_model
    qkv_spec = RequantSpec.for_linear(plans.attn.qkv)
    aplan = plans.attn.attn
    requant = RequantSpec.per_tensor(aplan.dn_out)
    for tp in (2, 4):
        lc = local_cfg(cfg, tp)
        h, hkv, hd = lc.n_heads, lc.n_kv_heads, lc.hd
        for m in (4, 16, 128):
            k1_row(f"tp={tp} wq cols per-ch", m, d, h * hd, qkv_spec)
            k1_row(f"tp={tp} wk/wv cols per-ch", m, d, hkv * hd, qkv_spec)
            k1_row(f"tp={tp} wo rows raw", m, h * hd, d, raw)
        tag = f"tp={tp} local heads "
        wo, wo_spec = paged_attention_rows(gen, rows, lc, plans, (
            ("int_decode_attention", 1, [1, 137, 300, 512], ""),
            ("int_decode_attention", VERIFY_SQ, [4, 137, 300, 512],
             "verify "),
            ("int_paged_prefill", 32, [32, 132, 282, 512], "")), tag=tag)
        check_packed_kernels(gen, rows, aplan, requant, wo, wo_spec, h, hkv,
                             hd, d, tag, verify=True, folds=(False,))
        # the contiguous cache (B 4, L = cache_len 512)
        b, L, lens = 4, 512, [1, 137, 300, 512]
        q8 = _randint(gen, -127, 128, (b, 1, h, hd), torch.int8)
        k8 = _randint(gen, -127, 128, (b, L, hkv, hd), torch.int8)
        v8 = _randint(gen, -127, 128, (b, L, hkv, hd), torch.int8)
        vl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        args, kw = (q8, k8, v8, aplan, vl), dict(requant=requant)
        nbytes, ops = k4_bound(lens, 1, h, hkv, hd, 0, 1)
        record(rows, "int_decode_attention",
               f"{tag}B={b} Sq=1 H={h} Hkv={hkv} D={hd} contiguous L={L} "
               f"valid={lens} fold_wo=False",
               int_decode_attention_fused(*args, **kw),
               int_decode_attention_plain(*args, **kw),
               lambda: int_decode_attention_fused(*args, **kw),
               lambda: int_decode_attention_plain(*args, **kw),
               nbytes, ops, iters=10, plain_iters=2,
               plan=k3_plan(q8, k8, v8, kw))
        del q8, k8, v8, args, wo

    q2 = get_config("qwen2-moe-a2.7b")
    p2 = qplans.build_layer_plans(q2)
    lc = local_cfg(q2, 2)
    d2, n2 = q2.d_model, lc.n_heads * lc.hd
    spec = RequantSpec.for_linear(p2.attn.qkv)
    k1_row("tp=2 qwen2-moe wq/wk/wv cols per-ch+bias", 4, d2, n2, spec,
           bias=True)
    k1_row("tp=2 qwen2-moe wo rows raw", 4, n2, d2, raw)
    paged_attention_rows(gen, rows, lc, p2, (
        ("int_decode_attention", 1, [1, 37, 130, 256], ""),),
        tag="tp=2 qwen2-moe local heads ",
        maxp=TP_MOE_GEOM["cache_len"] // TP_MOE_GEOM["page_size"])


def _rank_model(cfg):
    """The model a rank draws: the parent's (seed 0, on the card, the
    unit-std embedding)."""
    from repro_torch.quant import convert
    return convert.init_quantized(cfg, seed=0, device="cuda",
                                  embed_scale=convert.unit_embed_scale(cfg))


def tp_rank_streams(cfg, prompts, max_new, geom, runs):
    """A rank of ``tp-parity``: each run (engine arguments over ``geom``)
    served on ``cuda`` with tp = the world's size over its default group;
    per run the streams, ``describe()["tp"]``, ``fold_wo``, seconds and
    the launches of its drain."""
    import torch.distributed as dist
    from repro_torch import kernels
    qp, plans = _rank_model(cfg)
    out = {}
    for tag, kw in runs.items():
        eng, reqs = run_engine(qp, plans, cfg, prompts, max_new, "cuda",
                               tp=dist.get_world_size(), **geom, **kw)
        kernels.reset_launches()
        streams, secs = drain_streams(eng, reqs)
        out[tag] = {"streams": streams, "tp": eng.describe()["tp"],
                    "fold_wo": eng.fold_wo, "seconds": secs,
                    "launches": dict(kernels.LAUNCHES)}
        del eng
    return out


def phase_tp_parity(cfg_full):
    """llama3-8b at full width cut to ``TP_LAYERS`` layers: each of
    ``TP_MODES`` at tp = 1 on ``cuda`` here, then sharded over gloo worlds
    of 2 and 4 ranks on the one card (and qwen2-moe-a2.7b as deep in the
    2-rank world): every rank's streams must equal tp = 1's, with ``mode
    == "sharded"``, ``fold_wo`` off and the path's kernels launched.
    Returns the launches of the 2-rank world's rank 0 over its runs."""
    import dataclasses
    import gc

    import torch
    from repro_torch.distributed.world import run_world
    cfg = dataclasses.replace(cfg_full, num_layers=TP_LAYERS)
    mcfg = moe_config("qwen2-moe-a2.7b", TP_LAYERS)
    prompts = _prompts(11, 6, 20, 150, cfg.vocab) \
        + [_repeat_prompt(17, cfg.vocab)]
    mprompts = _prompts(31, 5, 12, 30, mcfg.vocab) \
        + [_repeat_prompt(37, mcfg.vocab, seg=8, times=3)]
    want = {}
    qp, plans, _ = random_model(cfg)
    for tag, kw in TP_MODES.items():
        eng, reqs = run_engine(qp, plans, cfg, prompts, 16, "cuda",
                               **TP_GEOM, **kw)
        want[tag], _ = drain_streams(eng, reqs)
        del eng
    qp, plans, _ = random_model(mcfg)
    eng, reqs = run_engine(qp, plans, mcfg, mprompts, 8, "cuda",
                           **TP_MOE_GEOM)
    want["moe"], _ = drain_streams(eng, reqs)
    del eng, qp
    gc.collect()
    torch.cuda.empty_cache()
    distinct = {tag: len({t for s in w for t in s}) for tag, w in want.items()}
    if min(distinct.values()) < 2:
        raise AssertionError(f"tp-parity: degenerate streams {distinct}")
    launches = None
    for world in (2, 4):
        calls = [(tp_rank_streams, (cfg, prompts, 16, TP_GEOM, TP_MODES))]
        if world == 2:
            calls.append((tp_rank_streams, (mcfg, mprompts, 8, TP_MOE_GEOM,
                                            {"moe": {}})))
        t0 = time.perf_counter()
        ranks = run_world(world, calls, backend=TP_BACKEND,
                          timeout_s=TP_WORLD_TIMEOUT_S)
        secs = time.perf_counter() - t0
        for rank, res in enumerate(ranks):
            got = {tag: run for call in res for tag, run in call.items()}
            same = {tag: run["streams"] == want[tag]
                    for tag, run in got.items()}
            modes = {tag: run["tp"]["mode"] for tag, run in got.items()}
            missing = {tag: [k for k in TP_RUN_KERNELS[tag]
                             if run["launches"][k] <= 0]
                       for tag, run in got.items()}
            emit({"phase": "tp-parity", "world": world, "rank": rank,
                  "backend": TP_BACKEND, "layers": TP_LAYERS,
                  "identical": same, "modes": modes,
                  "mesh": got["chunked"]["tp"]["mesh"],
                  "per_device_kv_bytes": {tag: run["tp"][
                      "per_device_kv_bytes"] for tag, run in got.items()},
                  "fold_wo": {tag: run["fold_wo"] for tag, run in
                              got.items()},
                  "seconds": {tag: run["seconds"] for tag, run in
                              got.items()},
                  "world_s": secs, "distinct_tokens": distinct,
                  "launches_chunked": {k: c for k, c in got["chunked"][
                      "launches"].items() if c}})
            if not all(same.values()) or set(modes.values()) != {"sharded"} \
                    or any(run["fold_wo"] for run in got.values()) \
                    or any(missing.values()):
                raise AssertionError(
                    f"tp-parity world {world} rank {rank}: identical "
                    f"{same}, modes {modes}, never launched {missing}")
            if world == 2 and rank == 0:
                launches = {k: sum(run["launches"][k] for run in got.values())
                            for k in got["chunked"]["launches"]}
    return {"tp-parity": launches}


def tp_rank_serve(cfg, prompts, max_new, geom):
    """A rank of ``tp-serve``: full ``cfg`` drawn, served sharded through
    ``dispatch_step`` / ``commit_step`` until drained, every decode step
    and prefill chunk timed with CUDA events (``StepTimer``), every
    ``psum_int32`` too (the collective on the device timeline: from the
    stream reaching it to the summed partials back), the partial
    o-projections counted, and after each dispatch whether the device was
    still busy (dispatch returned before the step's work ended)."""
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.distributed import collectives
    from repro_torch.models import intlayers as il
    t0 = time.perf_counter()
    qp, plans = _rank_model(cfg)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    eng, reqs = run_engine(qp, plans, cfg, prompts, max_new, "cuda",
                           tp=dist.get_world_size(), **geom)
    del qp                       # the engine keeps this rank's shard
    gc.collect()
    torch.cuda.empty_cache()
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in _leaves(eng.qparams))
    colls, wo_calls, busy = [], [0], []
    psum, wo = collectives.psum_int32, il._tp_wo_project

    def timed_psum(x, group=None):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = psum(x, group)
        e.record()
        colls.append((x.shape[0], s, e))
        return out

    def counted_wo(*a, **k):
        wo_calls[0] += 1
        return wo(*a, **k)
    collectives.psum_int32, il._tp_wo_project = timed_psum, counted_wo
    try:
        with StepTimer(decode="int_decode_step",
                       prefill="int_prefill_chunk_step") as timer:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            t0 = time.perf_counter()
            while eng.queue or any(s is not None for s in eng.slots):
                pending = eng.dispatch_step()
                ev = torch.cuda.Event()
                ev.record()
                if pending.kind != "idle":
                    busy.append(not ev.query())
                eng.commit_step(pending)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
    finally:
        collectives.psum_int32, il._tp_wo_project = psum, wo
    step_ms = {k: timer.ms(k) for k in ("decode", "prefill")}
    per_step = {k: timer.launches(k) for k in ("decode", "prefill")}
    decode_rows = geom["batch_size"]
    coll = {"decode": [s.elapsed_time(e) for r, s, e in colls
                       if r == decode_rows],
            "prefill": [s.elapsed_time(e) for r, s, e in colls
                        if r != decode_rows]}
    n_tok = sum(len(r.out_tokens) for r in reqs)
    d = eng.describe()
    return {"streams": [r.out_tokens for r in reqs], "tp": d["tp"],
            "describe": eng.describe_str(), "quantize_s": quant_s,
            "wall_s": wall, "tokens": n_tok, "tokens_per_s": n_tok / wall,
            "decode_steps": len(step_ms["decode"]),
            "decode_step_ms_mean": float(np.mean(step_ms["decode"])),
            "prefill_chunks": len(step_ms["prefill"]),
            "prefill_chunk_ms_mean": float(np.mean(step_ms["prefill"])),
            "collective_calls": len(colls),
            "collective_ms_per_decode_step":
                float(np.sum(coll["decode"])) / len(step_ms["decode"]),
            "collective_ms_per_prefill_chunk":
                float(np.sum(coll["prefill"])) / len(step_ms["prefill"]),
            "collective_ms_per_call_mean": float(np.mean(
                coll["decode"] + coll["prefill"])),
            "wo_partials": wo_calls[0],
            "launches_per_decode_step": _mean_counts(per_step["decode"]),
            "launches_per_prefill_chunk": _mean_counts(per_step["prefill"]),
            "dispatch_returned_before_device_done": float(np.mean(busy)),
            "weight_bytes": weight_bytes,
            "per_device_kv_bytes": d["tp"]["per_device_kv_bytes"],
            "kv_bytes": d["cache"]["kv_bytes"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": launches}


def phase_tp_serve(cfg):
    """Full llama3-8b at tp 2 (a gloo world of 2 ranks on the one card) on
    the ``serve`` phase's traffic: every rank sharded, its streams equal to
    the ``serve`` phase's (tp = 1), each layer's wo through one partial
    product and one psum in every step and chunk, K3 / K4 once a layer at
    the local heads; a line a rank with its step, chunk and collective
    device ms, launches a step, weight and KV bytes and peak memory (the
    ranks time-share the card: a record, not a tensor-parallel speed).
    Returns rank 0's launches."""
    import gc

    import torch
    from repro_torch.distributed.world import run_world
    if "serve" not in SERVE_STREAMS:
        raise AssertionError("tp-serve holds its streams against the serve "
                             "phase's: run it with serve")
    prompts = _prompts(5, 8, 32, 200, cfg.vocab)
    geom = dict(batch_size=4, cache_len=512, page_size=16, prefill_chunk=32,
                fold_wo=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_world(2, [(tp_rank_serve, (cfg, prompts, 32, geom))],
                      backend=TP_BACKEND, timeout_s=TP_WORLD_TIMEOUT_S)
    secs = time.perf_counter() - t0
    layers = cfg.num_layers
    for rank, (res,) in enumerate(ranks):
        same = res["streams"] == SERVE_STREAMS["serve"]
        per = {"decode": res["launches_per_decode_step"],
               "prefill": res["launches_per_prefill_chunk"]}
        missing = [k for k in PATH_KERNELS["tp-serve"]
                   if res["launches"][k] <= 0]
        emit({"phase": "tp-serve", "rank": rank, "backend": TP_BACKEND,
              "layers": layers, "identical_to_serve": same, "world_s": secs,
              **{k: v for k, v in res.items()
                 if k not in ("streams", "launches")},
              "launches": {k: c for k, c in res["launches"].items() if c}})
        steps = res["decode_steps"] + res["prefill_chunks"]
        if not same or res["tp"]["mode"] != "sharded" or missing \
                or res["wo_partials"] != layers * steps \
                or res["collective_calls"] != layers * steps \
                or per["decode"]["int_decode_attention"] != layers \
                or per["prefill"]["int_paged_prefill"] != layers:
            raise AssertionError(
                f"tp-serve rank {rank}: identical {same}, mode "
                f"{res['tp']['mode']}, never launched {missing}, wo "
                f"partials {res['wo_partials']} / collectives "
                f"{res['collective_calls']} for {layers} x {steps}, K3 / K4 "
                f"a step {per['decode']['int_decode_attention']} / "
                f"{per['prefill']['int_paged_prefill']}")
    return {"tp-serve": ranks[0][0]["launches"]}


# ============================================================ training ====

#: ``train-parity``: every family's reduced config, one arch a family
#: (the encoder's with its tied head: an encoder has no ``lm_head``),
#: B 2 x S 16
TRAIN_PARITY_ARCHS = ("llama3-8b", "roberta-base", "qwen2-moe-a2.7b",
                      "mamba2-130m", "jamba-v0.1-52b",
                      "seamless-m4t-large-v2", "llama-3.2-vision-90b")
TRAIN_PARITY_SHAPE = (2, 16)
#: how far (in grid steps) from the rounding midpoint a fake-quant code
#: that differs between the card and the CPU may be: a rounding tie
TIE_TOLERANCE = 1e-3
#: ``train``: llama3-8b at full width cut to 2 of its 32 layers (the
#: params, grads and float32 moments of 32 would not fit one card),
#: B 4 x S 256 of the synthetic language, 8 steps at lr 1e-3
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 4, 256, 8
TRAIN_LR = 1e-3
#: ``train-entry``: the driver's command line (``--steps`` 6, then 8)
TRAIN_ENTRY_ARGS = ("--arch", "llama3-8b", "--reduced", "--batch", "4",
                    "--seq", "64", "--ckpt-every", "2", "--int-eval")
#: the step at which ``train-entry``'s fault-tolerant loop fails once
TRAIN_FAIL_STEP = 3
#: ``train-entry``'s first run: a world of this many gloo ranks on the
#: card (``torchrun``); the second run, one process, resumes its
#: checkpoint
TRAIN_ENTRY_WORLD = 2
#: ``train-mesh``: ``train``'s model and batches on a gloo world of 4
#: ranks sharing the card, mesh (2, 2), ZeRO-1, 2 steps (the first
#: before any update, the second after one)
TRAIN_MESH_SHAPE, TRAIN_MESH_STEPS = (2, 2), 2
TRAIN_MESH_TIMEOUT_S = 600


class FakeQuantTape:
    """The integer codes of every QAT fake quant, recorded on one device
    and replayed on another.

    Under QAT a value within float rounding of a code's midpoint rounds
    to either neighbour, and the card and the CPU sum in different
    orders: one such tie (an MoE router's input, a Mamba x / B / C) flips
    a routing choice or a whole grid step downstream.  ``record`` keeps
    each call's codes and its ``x / scale``; ``replay`` computes its own,
    counts the codes that differ, requires each to be a tie (one step
    apart, both sides within ``TIE_TOLERANCE`` of the midpoint) and then
    takes the recorded code, so both devices make the same quantization
    decisions.  Inside ``with`` it stands in for
    ``models.layers.fake_quant``, which every ``maybe_fq`` / ``fq_weight``
    calls; leaving the first ``with`` turns recording into replay."""

    def __init__(self):
        self.codes, self.mode, self.i = [], "record", 0
        self.flips, self.worst = 0, 0.0

    def __call__(self, x, scale, bits=8, device=None):
        import torch
        from repro_torch.core.quant import qrange
        lo, hi = qrange(bits)
        xc = torch.clamp(x / scale, lo, hi)
        q = torch.round(xc)
        if self.mode == "record":
            self.codes.append((q.detach(), xc.detach()))
        else:
            q_ref, xc_ref = (t.to(x.device) for t in self.codes[self.i])
            self.i += 1
            if q_ref.shape != q.shape:
                raise AssertionError("the fake-quant calls differ between "
                                     "the devices")
            q = q.detach()
            diff = q_ref != q
            if bool(diff.any()):
                mid = (q_ref[diff] + q[diff]) / 2
                dist = torch.maximum((xc.detach()[diff] - mid).abs(),
                                     (xc_ref[diff] - mid).abs())
                self.flips += int(diff.sum())
                self.worst = max(self.worst, float(dist.max()))
                if bool(((q_ref[diff] - q[diff]).abs() != 1).any()) \
                        or self.worst > TIE_TOLERANCE:
                    raise AssertionError(
                        f"a fake-quant code differs by more than a "
                        f"rounding tie ({self.worst} grid steps)")
            q = q_ref
        return (x + ((q - xc) * scale + (xc * scale - x)).detach()
                ).to(x.dtype)

    def __enter__(self):
        from repro_torch.models import layers
        self._orig, layers.fake_quant = layers.fake_quant, self
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers
        layers.fake_quant = self._orig
        self.mode, self.i = "replay", 0


def _train_flat(tree) -> dict:
    from repro_torch.core.treepath import path_parts, tree_flatten_with_path
    return {"|".join(path_parts(p)): leaf
            for p, leaf in tree_flatten_with_path(tree)}


def _train_err(got, want, l2: bool) -> float:
    """max |Δ| / max |want|, or ||Δ||₂ / ||want||₂, in float64."""
    got, want = got.double().cpu(), want.double().cpu()
    if l2:
        return float((got - want).norm()) / max(float(want.norm()), 1e-30)
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def _train_grads(params, batch, cfg, qat: bool, dev, tape=None):
    """(logits, loss, {path: grad}) of ``qat.loss_fn`` on ``dev``, under
    ``tape`` (a :class:`FakeQuantTape`) where one is given."""
    import contextlib

    import torch
    from repro_torch.core.treepath import tree_map
    from repro_torch.models import transformer as tf
    from repro_torch.quant import qat as qat_mod
    leaves = tree_map(lambda t: t.detach().to(dev).requires_grad_(True),
                      params)
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    with tape or contextlib.nullcontext():
        with torch.no_grad():
            logits, _ = tf.forward_float(leaves, b, cfg, qat=qat)
        loss, _ = qat_mod.loss_fn(leaves, b, cfg, qat=qat)
        flat = _train_flat(leaves)
        grads = torch.autograd.grad(loss, list(flat.values()))
    return logits, loss.detach(), dict(zip(flat, grads))


def phase_train_parity() -> None:
    """Every family's reduced float32 config from the same params and
    batch on the card and on the CPU (TF32 off): ``forward_float``'s
    logits and ``loss_fn`` with its gradients at qat False and True, then
    one ``adamw_update`` of the CPU's qat gradients on both, within the
    CPU tests' tolerances (qat=False: max |Δ| <= 1e-4 max |ref|; qat=True:
    the loss 1e-4 relative, the logits and gradients ||Δ||₂ <= 1e-3
    ||ref||₂; AdamW 1e-6 a leaf).  At qat=True the card replays the CPU's
    fake-quant codes (:class:`FakeQuantTape`: every code that differs
    must be a rounding tie); the line also gives the tie flips and the
    errors without the replay."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.treepath import tree_map
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.optim.adamw import AdamWConfig
    assert not torch.backends.cuda.matmul.allow_tf32
    b, s = TRAIN_PARITY_SHAPE
    failures = []
    for name in TRAIN_PARITY_ARCHS:
        t_arch = time.perf_counter()
        cfg = M.reduce_config(get_config(name), dtype="float32")
        if cfg.family == "encoder":
            cfg = dataclasses.replace(cfg, tie_embeddings=True)
        host = tf.init_params(cfg, seed=1, device="cpu")
        rng = np.random.default_rng(0)
        batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)),
                 "labels": rng.integers(0, cfg.vocab, (b, s))}
        if cfg.family == "encdec":
            batch["src_embeds"] = rng.standard_normal(
                (b, s, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            batch["img_embeds"] = rng.standard_normal(
                (b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
        errs, host_grads = {}, None
        for qat in (False, True):
            tape = FakeQuantTape() if qat else None
            lc, loss_c, gc_ = _train_grads(host, batch, cfg, qat, "cpu",
                                           tape)
            lg, loss_g, gg = _train_grads(host, batch, cfg, qat, "cuda",
                                          tape)
            tag = "qat" if qat else "float"
            errs[f"{tag}_loss"] = abs(float(loss_g) - float(loss_c)) / \
                abs(float(loss_c))
            errs[f"{tag}_logits"] = _train_err(lg, lc, l2=qat)
            errs[f"{tag}_grads"] = max(_train_err(gg[k], gc_[k], l2=qat)
                                       for k in gc_)
            limit = 1e-3 if qat else 1e-4
            if errs[f"{tag}_loss"] > 1e-4 or errs[f"{tag}_logits"] > limit \
                    or errs[f"{tag}_grads"] > limit \
                    or not bool(torch.isfinite(lg).all()):
                failures.append(f"{name} {tag}")
            if qat:
                errs["qat_tie_flips"] = tape.flips
                errs["qat_tie_worst_steps"] = tape.worst
                # the same comparison without the replayed codes, for the
                # record (a tie flip cascades: no tolerance applies)
                lr_, loss_r, _ = _train_grads(host, batch, cfg, qat, "cuda")
                errs["qat_unreplayed_loss"] = abs(
                    float(loss_r) - float(loss_c)) / abs(float(loss_c))
                errs["qat_unreplayed_logits"] = _train_err(lr_, lc, l2=True)
            host_grads = gc_
        opt_cfg = AdamWConfig(lr=1e-3)
        grads = _tree_like(host, host_grads)
        outs = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev), host)
            outs[dev] = adamw_update(tree_map(lambda t: t.to(dev), grads),
                                     adamw_init(p, opt_cfg), p, opt_cfg)
        pairs = [(_train_flat(g), _train_flat(c)) for g, c in (
            (outs["cuda"][0], outs["cpu"][0]),
            (outs["cuda"][1].m, outs["cpu"][1].m),
            (outs["cuda"][1].v, outs["cpu"][1].v))]
        errs["adamw"] = max(_train_err(g[k], c[k], l2=False)
                            for g, c in pairs for k in c)
        if errs["adamw"] > 1e-6:
            failures.append(f"{name} adamw")
        emit({"phase": "train-parity", "arch": name, "family": cfg.family,
              "batch": b, "seq": s, "max_err": errs,
              "seconds": time.perf_counter() - t_arch})
    if failures:
        raise AssertionError(f"train-parity: the card and the CPU differ "
                             f"past the tolerance: {failures}")


def _tree_like(tree, by_path: dict):
    """``tree``'s structure with the leaf at each path from ``by_path``."""
    from repro_torch.core.treepath import path_parts, tree_unflatten_like
    return tree_unflatten_like(
        tree, lambda path, _: by_path["|".join(path_parts(path))])


def phase_train(cfg_full) -> dict:
    """llama3-8b at full width (d 4096, 32 / 8 heads, d_ff 14 336, vocab
    128 256) cut to ``TRAIN_LAYERS`` layers, bfloat16 params and float32
    moments: ``TRAIN_STEPS`` QAT steps of ``make_train_step`` under
    ``linear_warmup_cosine(1, TRAIN_STEPS)`` on the synthetic language,
    each step's loss and CUDA-event ms, tokens/s and peak memory; then
    ``quantize_params`` of the trained weights and one ``int_prefill`` of
    a batch through ``cuda`` and ``torch_ref`` on the card: the logits
    identical, K1, K2 and K5 launched.  The embedding is drawn at unit
    std (the reference init's 1/sqrt(V) quantizes to zero at full
    width).  Returns the ``cuda`` prefill's launches."""
    import gc

    import torch
    from repro_torch import kernels
    from repro_torch.core.treepath import tree_leaves
    from repro_torch.data.pipeline import make_train_iterator
    from repro_torch.launch import steps
    from repro_torch.models import inttransformer as it
    from repro_torch.models import transformer as tf
    from repro_torch.ops import resolve_ops
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import linear_warmup_cosine
    from repro_torch.quant import convert
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(cfg_full, num_layers=TRAIN_LAYERS)
    params = tf.init_params(cfg, seed=0, device="cuda")
    params["embed"].mul_(convert.unit_embed_scale(cfg))
    n_params = sum(p.numel() for p in tree_leaves(params))
    opt_cfg = AdamWConfig(lr=TRAIN_LR)
    opt = adamw_init(params, opt_cfg)
    step = steps.make_train_step(cfg, opt_cfg,
                                 linear_warmup_cosine(1, TRAIN_STEPS),
                                 device="cuda")
    data = make_train_iterator(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_phase
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        batch = next(data)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        params, opt, metrics = step(params, opt, batch)
        ev[1].record()
        torch.cuda.synchronize()
        step_ms.append(ev[0].elapsed_time(ev[1]))
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated()
    steady = sum(step_ms[1:]) / (len(step_ms) - 1)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves((params, opt.m, opt.v)))
    del opt
    gc.collect()
    torch.cuda.empty_cache()
    t_q = time.perf_counter()
    with torch.no_grad():
        qp, plans = convert.quantize_params(params, cfg)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t_q
    del params
    toks = torch.as_tensor(next(data)["tokens"], device="cuda")
    logits, counts = {}, {}
    for backend in ("cuda", "torch_ref"):
        kernels.reset_launches()
        logits[backend] = it.int_prefill(qp, {"tokens": toks}, plans, cfg,
                                         ops=resolve_ops(backend, cfg))
        torch.cuda.synchronize()
        counts[backend] = dict(kernels.LAUNCHES)
    same = torch.equal(logits["cuda"], logits["torch_ref"])
    argmax = logits["cuda"].argmax(dim=-1).tolist()
    missing = [k for k in PATH_KERNELS["train"] if counts["cuda"][k] <= 0]
    finite = all(x == x and abs(x) != float("inf") for x in losses)
    emit({"phase": "train", "arch": cfg.name, "layers": TRAIN_LAYERS,
          "of_layers": cfg_full.num_layers, "dtype": cfg.dtype,
          "moments": opt_cfg.moment_dtype, "params": n_params,
          "state_bytes": state_bytes, "batch": TRAIN_BATCH,
          "seq": TRAIN_SEQ, "lr": TRAIN_LR, "losses": losses,
          "step_ms": step_ms, "steady_step_ms": steady,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * 1e3 / steady,
          "max_memory_allocated": peak, "init_s": init_s,
          "quantize_s": quantize_s, "int_eval_identical": same,
          "int_eval_argmax": argmax,
          "int_eval_launches": {k: c for k, c in counts["cuda"].items()
                                if c},
          "torch_ref_launches": sum(counts["torch_ref"].values()),
          "seconds": time.perf_counter() - t_phase})
    if not finite:
        raise AssertionError(f"train: a loss is not finite: {losses}")
    if not same:
        raise AssertionError("train: the int-eval logits of cuda and "
                             "torch_ref differ")
    if missing or sum(counts["torch_ref"].values()):
        raise AssertionError(f"train: cuda never launched {missing}, or "
                             "torch_ref launched a kernel")
    return counts["cuda"]


def _train_state(cfg, mesh):
    """``train``'s model drawn from seed 0 on the card (the embedding at
    unit std), this rank's blocks of ``param_pspecs`` over ``mesh``,
    ZeRO-1 moments, the step and ``train``'s batches: (params, moments,
    specs, step, data)."""
    import gc

    import torch
    from repro_torch.data.pipeline import make_train_iterator
    from repro_torch.launch import shardings as shd
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import linear_warmup_cosine
    from repro_torch.quant import convert
    params = tf.init_params(cfg, seed=0, device="cuda")
    params["embed"].mul_(convert.unit_embed_scale(cfg))
    specs = shd.param_pspecs(params, mesh)
    local = shd.shard_tree(params, specs, mesh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    opt_cfg = AdamWConfig(lr=TRAIN_LR, zero1=True)
    step = steps_mod.make_train_step(cfg, opt_cfg,
                                     linear_warmup_cosine(1, TRAIN_STEPS),
                                     device="cuda", param_specs=specs,
                                     mesh=mesh)
    return (local, adamw_init(local, opt_cfg, specs, mesh), specs, step,
            make_train_iterator(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0))


def train_mesh_rank(cfg, mesh_shape, steps):
    """A rank of ``train-mesh``: :func:`_train_state` over a mesh of
    ``mesh_shape``; ``steps`` QAT steps, each timed with CUDA events and
    every collective too (``sharding.EVENTS``); then the whole params
    gathered and, on rank 0, quantized and one ``int_prefill`` through
    ``cuda`` and ``torch_ref``."""
    import gc

    import torch
    from repro_torch import kernels
    from repro_torch.core.treepath import tree_leaves
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import _build
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import inttransformer as it
    from repro_torch.ops import resolve_ops
    from repro_torch.quant import convert
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    mesh = make_mesh(mesh_shape, ("data", "model"))
    local, opt, specs, step, data = _train_state(cfg, mesh)
    state_bytes = {
        "params": sum(t.numel() * t.element_size()
                      for t in tree_leaves(local)),
        "moments": sum(t.numel() * t.element_size()
                       for t in tree_leaves((opt.m, opt.v)))}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, coll_ms, comm_bytes = [], [], [], []
    sh.EVENTS = []
    try:
        for _ in range(steps):
            batch = next(data)
            sh.EVENTS.clear()
            sh.reset_traffic()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            local, opt, metrics = step(local, opt, batch)
            ev[1].record()
            torch.cuda.synchronize()
            step_ms.append(ev[0].elapsed_time(ev[1]))
            by_kind = {}
            for kind, a, b in sh.EVENTS:
                by_kind[kind] = by_kind.get(kind, 0.0) + a.elapsed_time(b)
            coll_ms.append(by_kind)
            comm_bytes.append({k: v["bytes"] for k, v in sh.TRAFFIC.items()})
            losses.append(float(metrics["loss"]))
    finally:
        sh.EVENTS = None
    traffic = {k: dict(v) for k, v in sh.TRAFFIC.items()}
    peak = torch.cuda.max_memory_allocated()
    del opt
    gc.collect()
    torch.cuda.empty_cache()
    whole = shd.gather_tree(local, specs, mesh)
    del local
    out = {"rank": mesh.rank, "coords": mesh.coords, "losses": losses,
           "step_ms": step_ms, "collective_ms": coll_ms,
           "collective_ms_per_step": [sum(c.values()) for c in coll_ms],
           "bytes_per_step": comm_bytes, "last_step_traffic": traffic,
           "state_bytes": state_bytes, "max_memory_allocated": peak,
           "init_s": init_s}
    if mesh.rank == 0:
        _build.library()
        with torch.no_grad():
            qp, plans = convert.quantize_params(whole, cfg)
        del whole
        toks = torch.as_tensor(next(data)["tokens"], device="cuda")
        logits, counts = {}, {}
        for backend in ("cuda", "torch_ref"):
            kernels.reset_launches()
            logits[backend] = it.int_prefill(
                qp, {"tokens": toks}, plans, cfg,
                ops=resolve_ops(backend, cfg))
            torch.cuda.synchronize()
            counts[backend] = dict(kernels.LAUNCHES)
        out.update({
            "int_eval_identical": torch.equal(logits["cuda"],
                                              logits["torch_ref"]),
            "int_eval_argmax": logits["cuda"].argmax(dim=-1).tolist(),
            "launches": counts["cuda"],
            "torch_ref_launches": sum(counts["torch_ref"].values())})
    return out


def _train_reference_losses(cfg, steps):
    """``steps`` QAT steps of :func:`_train_state` on a (1, 1) mesh in
    this process (the single-rank run the world is held against): the
    losses."""
    import gc

    import torch
    from repro_torch.launch.mesh import make_mesh
    params, opt, _, step, data = _train_state(
        cfg, make_mesh((1, 1), ("data", "model")))
    losses = []
    for _ in range(steps):
        params, opt, metrics = step(params, opt, next(data))
        losses.append(float(metrics["loss"]))
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def phase_train_mesh(cfg_full) -> dict:
    """``train``'s model (llama3-8b full width, ``TRAIN_LAYERS`` layers,
    bfloat16 params, float32 moments) on a gloo world of 4 ranks sharing
    the card (``TRAIN_MESH_SHAPE``, ZeRO-1), ``TRAIN_MESH_STEPS`` steps of
    ``train``'s batches: a line a rank (step and collective ms, the int8
    bytes of the sequence gather, param / moment bytes, peak memory),
    then the losses against a (1, 1) run of the same params and batches
    in this process (the first step's, before any update, within 1e-4
    relative; the later ones within 1e-3: Adam's first steps normalise
    each gradient element, so a rounding difference of a near-zero
    gradient moves its weight by a whole lr step) and rank 0's int-eval
    (``cuda`` == ``torch_ref``, K1 / K2 / K5 launched).  The ranks
    time-share the card: their times are a record, not a data / tensor
    parallel speed.  Returns rank 0's launches."""
    import gc
    import math

    import torch
    from repro_torch.distributed.world import run_world
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(cfg_full, num_layers=TRAIN_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    world = TRAIN_MESH_SHAPE[0] * TRAIN_MESH_SHAPE[1]
    held = torch.cuda.memory_reserved()
    # the four ranks share the card: segments that grow in place keep a
    # rank's reserved-but-free memory from fragmenting (set for the
    # ranks only: they read it when they start)
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = run_world(world, [(train_mesh_rank, (cfg, TRAIN_MESH_SHAPE,
                                                     TRAIN_MESH_STEPS))],
                          backend=TP_BACKEND,
                          timeout_s=TRAIN_MESH_TIMEOUT_S)
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    world_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    ref = _train_reference_losses(cfg, TRAIN_MESH_STEPS)
    ref_s = time.perf_counter() - t0
    res = [r[0] for r in ranks]
    for r in res:
        emit({"phase": "train-mesh", "backend": TP_BACKEND,
              "mesh": dict(zip(("data", "model"), TRAIN_MESH_SHAPE)),
              "layers": TRAIN_LAYERS, "batch": TRAIN_BATCH,
              "seq": TRAIN_SEQ,
              **{k: v for k, v in r.items() if k not in (
                  "launches", "int_eval_argmax")},
              **({"launches": {k: c for k, c in r["launches"].items()
                               if c}} if "launches" in r else {})})
    lead = res[0]
    losses = lead["losses"]
    errs = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    missing = [k for k in PATH_KERNELS["train-mesh"]
               if lead["launches"].get(k, 0) <= 0]
    emit({"phase": "train-mesh-summary", "losses": losses,
          "one_rank_losses": ref, "loss_rel_err": errs,
          "ranks_agree": all(r["losses"] == losses for r in res),
          "max_rank_peak_memory": max(r["max_memory_allocated"]
                                      for r in res),
          "int_eval_identical": lead["int_eval_identical"],
          "int_eval_argmax": lead["int_eval_argmax"],
          "one_rank_s": ref_s, "world_s": world_s,
          "parent_reserved_before_world": held,
          "seconds": time.perf_counter() - t_phase})
    if not all(r["losses"] == losses for r in res) \
            or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train-mesh: the ranks' losses differ or are "
                             f"not finite: {[r['losses'] for r in res]}")
    if errs[0] > 1e-4 or max(errs) > 1e-3:
        raise AssertionError(f"train-mesh: losses {losses} against the "
                             f"(1, 1) run's {ref}")
    if not lead["int_eval_identical"] or missing \
            or lead["torch_ref_launches"]:
        raise AssertionError(f"train-mesh: int-eval identical "
                             f"{lead['int_eval_identical']}, cuda never "
                             f"launched {missing}, or torch_ref launched")
    if not all(r["last_step_traffic"].get("comm_quant", {}).get("bytes")
               for r in res):
        raise AssertionError("train-mesh: a rank ran no int8 sequence "
                             "gather")
    return lead["launches"]


def _fault_run(cfg, fail: bool):
    """Six QAT steps of reduced ``cfg`` on the card through a
    ``FaultTolerantLoop`` (a checkpoint every step, so one is on disk
    when the loop looks for it); ``fail``: the step function fails once
    at ``TRAIN_FAIL_STEP``.  Returns (losses, restarts)."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import make_train_iterator
    from repro_torch.distributed.fault import FaultTolerantLoop
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import linear_warmup_cosine
    params = tf.init_params(cfg, seed=0, device="cuda")
    opt_cfg = AdamWConfig(lr=TRAIN_LR)
    step = steps.make_train_step(cfg, opt_cfg, linear_warmup_cosine(1, 6),
                                 device="cuda")
    failed = []

    def injector(s):
        if fail and s == TRAIN_FAIL_STEP and not failed:
            failed.append(s)
            raise RuntimeError("injected failure")

    def step_fn(state, batch):
        p, o, m = step(*state, batch)
        return (p, o), m

    with tempfile.TemporaryDirectory() as d:
        loop = FaultTolerantLoop(step_fn, CheckpointManager(d),
                                 make_train_iterator(cfg, 64, 4, seed=0),
                                 ckpt_every=1, fail_injector=injector)
        _, log = loop.run((params, adamw_init(params, opt_cfg)), 6)
    return [m["loss"] for m in log], loop.restarts


class TrainEntry:
    """The driver's two runs into one checkpoint folder: ``--steps 6``
    starts in the background when this is made (it overlaps
    ``train-parity``: each process pays the card's start-up again);
    :meth:`first` waits for it, :meth:`second` runs ``--steps 8``, which
    resumes at step 6.  :meth:`close` stops a run still going and removes
    the folder."""

    def __init__(self):
        import tempfile
        self.ckpt = tempfile.mkdtemp(prefix="train_entry_")
        self.env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
        self.runs = []
        self.proc = self._start(6, world=TRAIN_ENTRY_WORLD)
        self.t0 = time.perf_counter()

    def _start(self, steps: int, world: int = 1):
        head = [sys.executable, "-m", "repro_torch.launch.train"]
        if world > 1:
            head = [sys.executable, "-m", "torch.distributed.run",
                    "--standalone", "--nproc-per-node", str(world), "-m",
                    "repro_torch.launch.train", "--dist-backend", "gloo"]
        return subprocess.Popen(
            [*head, *TRAIN_ENTRY_ARGS, "--steps", str(steps),
             "--ckpt-dir", self.ckpt], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=self.env, cwd=ROOT,
            start_new_session=True)

    def _finish(self, steps: int) -> None:
        stdout, stderr = self.proc.communicate(timeout=300)
        lines = stdout.splitlines()

        def first(prefix):
            return next((x for x in lines if x.startswith(prefix)), None)
        launches = first("int-eval launches:")
        resumed = first("resuming from step")
        mesh = first("arch=")
        self.runs.append({
            "steps": steps, "rc": self.proc.returncode,
            "mesh": mesh.split("mesh=", 1)[1].split(" device=")[0]
            if mesh else None,
            "seconds": time.perf_counter() - self.t0,
            "resumed_from": int(resumed.rsplit(" ", 1)[1]) if resumed else 0,
            "summary": first("steps "), "int_eval": first("int-eval ("),
            "int_eval_launches": json.loads(launches.split(":", 1)[1])
            if launches else {},
            "stderr_tail": stderr[-2000:] if self.proc.returncode else ""})
        self.proc = None

    def first(self) -> None:
        self._finish(6)
        self.runs[-1]["world"] = TRAIN_ENTRY_WORLD

    def second(self) -> None:
        self.proc, self.t0 = self._start(8), time.perf_counter()
        self._finish(8)
        self.runs[-1]["world"] = 1

    def close(self) -> None:
        import shutil
        if self.proc is not None:
            # the run's session: torchrun and the ranks it started
            os.killpg(self.proc.pid, 9)
            self.proc.communicate()
        shutil.rmtree(self.ckpt, ignore_errors=True)


def phase_train_entry(entry: TrainEntry) -> None:
    """``python -m repro_torch.launch.train`` on the card (its default
    device): ``TRAIN_ENTRY_ARGS`` with ``--steps 6`` in a world of
    ``TRAIN_ENTRY_WORLD`` gloo ranks (``entry``'s first run, mesh (1, 2)),
    then ``--steps 8`` in one process (mesh (1, 1)) into the same
    checkpoint folder, which resumes at step 6 from the world's
    checkpoint; each ``--int-eval`` prefill launches K1, K2 and K5.  Then a ``FaultTolerantLoop`` failing once at step
    ``TRAIN_FAIL_STEP`` restarts once and its losses equal an
    uninterrupted run's (within 1e-4: the card's embedding backward adds
    with atomics, so two runs need not be bit-equal; whether they are is
    printed)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    t_phase = time.perf_counter()
    entry.second()
    runs = entry.runs
    cfg = M.reduce_config(get_config("llama3-8b"), dtype="float32",
                          vocab=1024)
    clean, r_clean = _fault_run(cfg, fail=False)
    faulted, r_fault = _fault_run(cfg, fail=True)
    diff = max(abs(a - b) / abs(b) for a, b in zip(faulted, clean))
    emit({"phase": "train-entry", "runs": runs,
          "fault": {"fail_at": TRAIN_FAIL_STEP, "restarts": r_fault,
                    "losses": faulted, "uninterrupted": clean,
                    "max_rel_diff": diff, "bit_equal": faulted == clean},
          "seconds": time.perf_counter() - t_phase})
    meshes = ({"data": 1, "model": TRAIN_ENTRY_WORLD},
              {"data": 1, "model": 1})
    for r, start, mesh in zip(runs, (0, 6), meshes):
        missing = [k for k in PATH_KERNELS["train-entry"]
                   if r["int_eval_launches"].get(k, 0) <= 0]
        if r["rc"] != 0 or r["resumed_from"] != start or missing \
                or r["mesh"] != str(mesh) \
                or not (r["summary"] or "").startswith(
                    f"steps {start} -> {r['steps']}:"):
            raise AssertionError(f"train-entry: --steps {r['steps']} "
                                 f"failed, did not resume at {start} or "
                                 f"never launched {missing}")
    if r_fault != 1 or r_clean != 0 or len(faulted) != len(clean) \
            or diff > 1e-4:
        raise AssertionError("train-entry: the fault-tolerant loop did not "
                             "restart once to the uninterrupted losses")


def _mean_counts(deltas):
    return {n: float(sum(d[n] for d in deltas)) / max(len(deltas), 1)
            for n in (deltas[0] if deltas else {})}


def profile_decode(eng, cfg, phase="profile",
                   k3="int_decode_attention"):
    """torch.profiler over a short decode-heavy window of the serve
    engine: the device's busy share, the device time by kernel, and K3's
    device ms a step (``k3``: its counter, ``int_decode_attention_kv4``
    over int4 pages)."""
    from repro_torch import kernels
    from repro_torch.serving import Request
    prompts = _prompts(9, 4, 8, 8, cfg.vocab)
    reqs = [Request(uid=100 + i, prompt=p, max_new_tokens=8)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.step()                       # admit + prefill + first decode
    before = kernels.LAUNCHES[k3]

    def window():
        for _ in range(4):
            eng.step()
    profile_window(phase, "4 decode steps, batch 4", window, lambda: 4,
                   (K3_KERNEL_NAMES, lambda: kernels.LAUNCHES[k3] - before))
    eng.run_until_done()


# every kernel name K3 has had on the card: the Hopper kernel, and before
# it the __dp4a body's 1- and 8-row instantiations (int8 and packed pools
# alike)
K3_KERNEL_NAMES = ("int_decode_attention_kernel",
                   "int_attention_kernel<1, 128,",
                   "int_attention_kernel<8, 128,")


# every kernel name K4 has had on the card: the tensor-core kernel, and
# before it the __dp4a body's 16-row instantiation (K3's were its 1- and
# 8-row ones); over packed int4 pools its kv4 instantiation
K4_KERNEL_NAMES = {"int_paged_prefill": ("int_paged_prefill_mma_kernel",
                                         "int_attention_kernel<16, 64,"),
                   "int_paged_prefill_kv4": ("int_paged_prefill_kv4_kernel",)}


def profile_prefill(eng, cfg, k4: str = "int_paged_prefill", phase=None):
    """torch.profiler over the prefill chunks of four 256-token prompts
    admitted together (8 chunk rounds of 32 tokens, pos_end 32 .. 256, in
    every lane): the device ms a chunk and K4's share of it.  The window
    is the engine's admission and prefill alone, without the decode step
    that ``step()`` would add, so its device time is the chunks'.  Chunks
    are K4's launches in the window over the layers (one a layer).
    ``k4``: K4's counter, ``int_paged_prefill_kv4`` over int4 pages (the
    phase is then ``kv4-prefill-profile``); ``phase``: the phase's name
    where it is neither."""
    from repro_torch import kernels
    from repro_torch.serving import Request
    prompts = _prompts(13, 4, 256, 256, cfg.vocab)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=200 + i, prompt=p, max_new_tokens=2))
    before = kernels.LAUNCHES[k4]

    def k4_launches():
        return kernels.LAUNCHES[k4] - before

    def window():
        eng._admit()
        eng._advance_prefill()

    profile_window(phase or ("prefill-profile" if k4 == "int_paged_prefill"
                             else "kv4-prefill-profile"),
                   "prefill chunks of 4 x 256 "
                   "tokens, chunk 32", window,
                   lambda: k4_launches() // cfg.num_layers,
                   (K4_KERNEL_NAMES[k4], k4_launches))
    eng.run_until_done()


def profile_window(phase, what, fn, units=None, focus=None):
    """torch.profiler over ``fn``: the device's busy share of the wall
    time and the device time by kernel.  ``units``: a callable giving the
    count of steps the window ran (device and wall ms a step, device
    kernel calls a step and the ``FillFunctor`` calls among them, i.e.
    ``torch.zeros`` / ``fill_``, are added);
    ``focus``: ``(names, launches)``, the kernel-name fragments of one
    kernel and a callable giving its launches in the window; its device
    ms, its calls as the profiler saw them and its launches are added,
    and the window fails if it launched but no call matched the names."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
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
    # the port's kernels (namespace r8) against everything else: PyTorch's
    # own kernels, the glue between them
    port_ms = sum(r[1] for r in rows if "r8::" in r[0]) / 1e3
    extra = {"port_kernels_ms": port_ms if rows else None,
             "glue_ms": busy_ms - port_ms if rows else None}
    if units is not None:
        n = units()
        calls = sum(r[2] for r in rows)
        fills = sum(r[2] for r in rows if "FillFunctor" in r[0])
        extra.update({
            "steps": n, "wall_ms_per_step": wall_ms / max(n, 1),
            "device_ms_per_step": busy_ms / max(n, 1) if rows else None,
            "kernel_calls_per_step": calls / max(n, 1) if rows else None,
            "fill_calls_per_step": fills / max(n, 1) if rows else None})
    mismatch = None
    if focus is not None and rows:
        names, launched = focus
        mine = [r for r in rows if any(f in r[0] for f in names)]
        f_ms = sum(r[1] for r in mine) / 1e3
        calls, n_launch = sum(r[2] for r in mine), launched()
        extra.update({"focus": [r[0][:90] for r in mine],
                      "focus_device_ms": f_ms, "focus_share": f_ms / busy_ms,
                      "focus_calls": calls, "focus_launches": n_launch})
        if units is not None:
            extra["focus_device_ms_per_step"] = f_ms / max(units(), 1)
        if n_launch and not calls:
            mismatch = (f"{phase}: no kernel named like {names} among the "
                        f"profiler's rows, {n_launch} launches")
    emit({"phase": phase, "window": what, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms if rows else None,
          "device_busy_share": busy_ms / wall_ms if rows else None, **extra,
          "top": [{"kernel": k[:90], "device_ms": us / 1e3, "calls": n}
                  for k, us, n in rows[:12]]})
    if mismatch:
        raise AssertionError(mismatch)


# the kernels that must run on the int8 tensor cores with no spill: every
# instantiation of K1's decode tile, K3's, K5's, K4's, K8's, the MSR-4
# correction's tensor-core route and K1's grouped instantiation
TENSOR_CORE_KERNELS = ("int8_matmul_decode_kernel",
                       "int_decode_attention_kernel",
                       "int_attention_mma_kernel",
                       "int_paged_prefill_mma_kernel",
                       "int_paged_prefill_kv4_kernel",
                       "int_attention_online_kernel",
                       "msr4_correct_mma_kernel",
                       "int8_matmul_grouped_kernel")


# K1's instantiations (dense and packed, both paths), the MSR-4
# correction's gather route and every K2 and K7 instantiation (their rows
# live in registers): no spill, and K1's tensor-core tiles on the tensor
# cores
NO_SPILL_KERNELS = ("int8_matmul_decode_kernel", "int8_matmul_mma_kernel",
                    "msr4_correct_kernel", "int_layernorm_kernel",
                    "int_softmax_kernel")


def sass_summary(so: str) -> None:
    """Per kernel of the built library, the count of the SASS
    instructions that say how it computes: ``IMMA`` (int8 tensor cores),
    ``IDP`` (__dp4a), ``LDL`` / ``STL`` (local-memory spills).  Every
    instantiation of ``TENSOR_CORE_KERNELS`` must show ``IMMA`` and none
    of the other three."""
    import re
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", so], capture_output=True,
                         text=True, timeout=300).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = dict.fromkeys(("IMMA", "IDP", "LDL", "STL"), 0)
        elif name is not None:
            for op in counts[name]:
                if re.search(rf"\b{op}\b", line):
                    counts[name][op] += 1
    emit({"phase": "sass", "kernels": counts})
    tc = {n: c for n, c in counts.items()
          if any(k in n for k in TENSOR_CORE_KERNELS)}
    missing = [k for k in TENSOR_CORE_KERNELS + NO_SPILL_KERNELS
               if not any(k in n for n in counts)]
    bad = [n for n, c in tc.items()
           if c["IMMA"] == 0 or c["IDP"] or c["LDL"] or c["STL"]]
    bad += [n for n, c in counts.items()
            if any(k in n for k in NO_SPILL_KERNELS)
            and (c["LDL"] or c["STL"]
                 or ("int8_matmul_mma_kernel" in n and not c["IMMA"]))]
    if missing or bad:
        raise AssertionError(f"sass: no instantiation of {missing}; without "
                             f"IMMA or with IDP / LDL / STL: {bad}")


def _leaves(tree):
    """The tensors of a params tree (a packed weight's static PackMeta is
    not one)."""
    import torch
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,kernels,parity,serve,encode,"
                    "encode-online,ops,analysis,window-parity,window-serve,"
                    "window-prefill,kv4-parity,kv4-serve,packed-parity,"
                    "msr4-serve,zoo-parity,zoo-serve,zoo-encode,"
                    "long-prefill,moe-parity,moe-serve,moe-prefill,"
                    "ssm-parity,ssm-serve,hybrid-parity,hybrid-serve,"
                    "encdec-parity,encdec-decode,vlm-parity,vlm-decode,"
                    "tp-parity,tp-serve,train-parity,train,train-mesh,"
                    "train-entry")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc -Xptxas -v (registers, spills) and "
                    "each kernel's IMMA / IDP / LDL / STL count")
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
    CARD["card"] = card_line()

    t0 = time.perf_counter()
    so = _build.build(verbose=args.verbose_build)
    nvcc_s = time.perf_counter() - t0
    _build.library()
    emit({"phase": "build", "nvcc_s": nvcc_s, "library": os.path.relpath(
        so, ROOT)})
    if args.verbose_build:
        sass_summary(str(so))

    cfg = get_config("llama3-8b")
    plans = qplans.build_layer_plans(cfg)
    ecfg = encoder_config()
    rows, launches = {}, {}
    if "kernels" in phases:
        rows = check_kernels(cfg, plans)
        eplans = qplans.build_layer_plans(ecfg)
        check_encoder_kernels(ecfg, eplans, rows)
        check_online_kernels(ecfg, eplans, rows)
        wcfg = window_config()
        check_window_kernels(wcfg, qplans.build_layer_plans(wcfg), rows)
        check_packed_matmul_kernels(cfg, plans, rows)
        check_zoo_kernels(rows)
        check_moe_kernels(rows)
        check_ssm_kernels(rows)
        check_cross_kernels(rows)
        check_tp_kernels(rows)
    else:
        if "zoo-kernels" in phases:
            check_zoo_kernels(rows)
        if "moe-kernels" in phases:
            check_moe_kernels(rows)
        if "ssm-kernels" in phases:
            check_ssm_kernels(rows)
        if "cross-kernels" in phases:
            check_cross_kernels(rows)
        if "tp-kernels" in phases:
            check_tp_kernels(rows)
    if "k1-decode" in phases:
        wcfg = window_config()
        check_k1_decode(cfg, wcfg, plans, qplans.build_layer_plans(wcfg))
    if "k3-decode" in phases:
        wcfg = window_config()
        check_k3_decode(cfg, wcfg, plans, qplans.build_layer_plans(wcfg))
    if "k1-grouped" in phases:
        check_k1_grouped()
    if "k2-norm" in phases:
        check_k2_norm(cfg, ecfg, window_config())
    if "k7-softmax" in phases:
        check_k7_softmax(ecfg)
    if "parity" in phases:
        phase_parity(cfg)
    if "serve" in phases:
        launches.update(phase_serve(cfg))
    if phases & {"encode", "encode-online"}:
        model = random_model(ecfg)
        if "encode" in phases:
            launches["encode"] = phase_encode(ecfg, model)
        if "encode-online" in phases:
            launches["encode-online"] = phase_encode_online(ecfg, model)
        del model
    if "ops" in phases:
        launches["ops"] = phase_ops(ecfg, qplans.build_layer_plans(ecfg))
    if "analysis" in phases:
        launches["analysis"] = phase_analysis(cfg, ecfg)
    if "window-parity" in phases:
        phase_window_parity(window_config())
    wcut = dataclasses.replace(window_config(), num_layers=WINDOW_LAYERS)
    if "window-serve" in phases:
        launches.update(phase_window_serve(wcut))
    if "window-prefill" in phases:
        launches["window-prefill"] = phase_window_prefill(wcut)
    if "kv4-parity" in phases:
        phase_parity(cfg, kv_dtype="int4")
    vcut = dataclasses.replace(cfg, num_layers=SERVE_VARIANT_LAYERS)
    if "kv4-serve" in phases:
        launches.update(phase_serve(vcut, kv_dtype="int4"))
    if "packed-parity" in phases:
        phase_packed_parity(cfg)
    if "msr4-serve" in phases:
        launches.update(phase_serve(vcut, weights="msr4"))
    if "zoo-parity" in phases:
        phase_zoo_parity()
    if "zoo-serve" in phases:
        for name in ZOO_DECODERS:
            launches.update(phase_serve(
                dataclasses.replace(zoo_config(name),
                                    num_layers=ZOO_SERVE_LAYERS),
                label=f"zoo-serve-{name}"))
    if "zoo-encode" in phases:
        for name, seq in ZOO_ENCODERS.items():
            launches[f"zoo-encode-{name}"] = phase_zoo_encode(name, seq)
    if "long-prefill" in phases:
        launches.update(phase_long_prefill(cfg))
    if "moe-parity" in phases:
        phase_moe_parity()
    if phases & {"moe-serve", "moe-prefill"}:
        mcfg = moe_config("qwen2-moe-a2.7b", MOE_SERVE_LAYERS)
        model = random_model(mcfg)
        if "moe-serve" in phases:
            launches["moe-serve"] = phase_moe_serve(mcfg, model)
        if "moe-prefill" in phases:
            launches["moe-prefill"] = phase_moe_prefill(mcfg, model)
        del model
    for name in SSM_ARCHS:
        kind = SSM_PHASES[name]
        if not phases & {f"{kind}-parity", f"{kind}-serve"}:
            continue
        t_phase = time.perf_counter()
        model = random_model(ssm_config(name))
        if f"{kind}-parity" in phases:
            launches.update(phase_ssm_parity(name, model))
        if f"{kind}-serve" in phases:
            launches.update(phase_ssm_serve(name, model))
        del model
        emit({"phase": f"{kind}-seconds", "arch": name,
              "seconds": time.perf_counter() - t_phase})
    for name in CROSS_ARCHS:
        kind = CROSS_PHASES[name]
        if not phases & {f"{kind}-parity", f"{kind}-decode"}:
            continue
        t_phase = time.perf_counter()
        model = random_model(cross_config(name))
        quantize_s = model[2]
        if f"{kind}-parity" in phases:
            launches.update(phase_cross_parity(name, model))
        if f"{kind}-decode" in phases:
            launches.update(phase_cross_decode(name, model))
        del model
        emit({"phase": f"{kind}-seconds", "arch": name,
              "quantize_s": quantize_s,
              "seconds": time.perf_counter() - t_phase})
    if "tp-parity" in phases:
        t_phase = time.perf_counter()
        launches.update(phase_tp_parity(cfg))
        emit({"phase": "tp-parity-seconds",
              "seconds": time.perf_counter() - t_phase})
    if "tp-serve" in phases:
        t_phase = time.perf_counter()
        launches.update(phase_tp_serve(cfg))
        emit({"phase": "tp-serve-seconds",
              "seconds": time.perf_counter() - t_phase})
    entry = TrainEntry() if "train-entry" in phases else None
    try:
        if "train-parity" in phases:
            phase_train_parity()
        if entry is not None:
            entry.first()
        if "train" in phases:
            launches["train"] = phase_train(cfg)
        if "train-mesh" in phases:
            launches["train-mesh"] = phase_train_mesh(cfg)
        if entry is not None:
            phase_train_entry(entry)
    finally:
        if entry is not None:
            entry.close()
    if rows:
        # each kernel's launches come from the first path of this run
        # that drives it (K1/K2: serve, the first path); every path's
        # counts are listed
        home = {n: next((p for p in PATH_KERNELS
                         if n in PATH_KERNELS[p] and p in launches),
                        None) for n in rows}
        emit({"kernels": [
            {"name": name, "route": "cuda", "source": SOURCES[name],
             "replaces": TPU_KERNELS[name],
             "launches": launches.get(home[name], {}).get(name, 0),
             "launches_by_path": {p: c.get(name, 0)
                                  for p, c in launches.items()},
             "max_abs_err": r["max_abs_err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "call_ms": r["call_ms"],
             "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": r["library_ms"],
             "case": r["case"], **({"plan": r["plan"]} if "plan" in r
                                   else {})}
            for name, r in rows.items()]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
