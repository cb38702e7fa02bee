"""K8: one-pass online integer-softmax attention (the ``pallas`` backend's
attention).

The port of ``repro/kernels/int_attention.py::int_attention_pallas``; the
CUDA kernel is ``csrc/int_attention_online.cu``
(``r8::k8::int_attention_online_kernel<D>``, on the int8 tensor cores),
launched as :func:`k8_launch_plan` says.
:func:`int_attention_online_plain` is the plain PyTorch version, new here:
the reference's only form of this function is the Pallas kernel itself.

Unlike K5, this is *not* the exact three-sweep attention.  Per logical KV
block the running max, the running sum of e16 and the int32 accumulator
are rescaled by ``exp16(m_old - m_new)``, and ``exp16(0)`` is 32755, not
2^15, so every processed block shrinks them a little even when the max
does not move.  The integers therefore depend on the logical blocks
``(bq, bkv)`` -- ``bkv`` sets where the rescales happen and ``bq`` the
causal block skip -- and the port reproduces the reference's integers
only at the same blocks, which is why they are arguments of both the
kernel and its plain version.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.analysis.contracts import (KernelContractError,
                                            online_report, require_launch,
                                            require_online_launch)
from repro_torch.core.dyadic import apply_dyadic, clip_to_bits
from repro_torch.core.intmath import int_einsum
from repro_torch.core.softmax import (NEG, _exp16, combine_correction,
                                      rescale_sum)
from repro_torch.kernels import LAUNCHES, RECORDERS, note_launch
from repro_torch.kernels.int_attention_fused import (HEAD_DIMS, exp16_args,
                                                     sk_words, v_cols)


def _blocks(q8, k8, bq: int, bkv: int):
    b, sq, h, d = q8.shape
    if k8.dim() != 4 or k8.shape[0] != b or k8.shape[3] != d:
        raise ValueError(f"int_attention_online: k/v {tuple(k8.shape)} vs "
                         f"q {tuple(q8.shape)}")
    skv, hkv = k8.shape[1], k8.shape[2]
    bq, bkv = min(bq, sq), min(bkv, skv)     # the reference's clamping
    require_online_launch(sq, skv, h, hkv, bq, bkv)
    return bq, bkv


#: K8's block (csrc/int_attention_online.cu): query rows, keys a tile,
#: threads
K8_ROWS, K8_KEYS, K8_THREADS = 64, 64, 128


class K8Plan(NamedTuple):
    """One K8 launch: the grid ``(query blocks, H, B)``, the key tiles of
    one logical KV block (each starts at the block's first key; a block
    of one tile takes one pipeline step, a longer one a max pass and an
    e16 pass over its tiles), and the dynamic shared memory in bytes."""
    grid: tuple
    tiles: int
    smem: int


def k8_smem_bytes(d: int) -> int:
    """A K8 block's dynamic shared memory, as ``r8_online_smem_bytes``:
    two K tiles (row stride ``sk_words(d)``) and one Vᵀ tile (``v_cols(d)``
    rows), whatever the logical blocks."""
    return 4 * (2 * K8_KEYS * sk_words(d) + v_cols(d) * (K8_KEYS // 4))


def k8_launch_plan(b: int, sq: int, h: int, d: int, bkv: int) -> K8Plan:
    """The K8 launch of a (B, Sq, H, D) query at logical KV blocks of
    ``bkv`` keys (after the wrapper's clamping).  Raises for a head dim
    the kernel is not compiled for."""
    dims = HEAD_DIMS["int_attention_online"]
    if d not in dims:
        raise KernelContractError("int_attention_online", [
            f"head dim {d} is not one the kernel is compiled for {dims} "
            "(ROADMAP §2 item 4)"])
    return K8Plan((-(-sq // K8_ROWS), h, b), -(-bkv // K8_KEYS),
                  k8_smem_bytes(d))


def int_attention_online_plain(q8, k8, v8, plan, causal: bool = True,
                               window: int = 0, bq: int = 128,
                               bkv: int = 128, out_bits: int = 8):
    """The TPU kernel's ``_attn_kernel`` step for step, as a loop over the
    logical KV blocks vectorised over batch, heads and query rows; rows
    skip a block exactly where the kernel's grid step would."""
    bq, bkv = _blocks(q8, k8, bq, bkv)
    b, sq, h, d = q8.shape
    skv, hkv = k8.shape[1], k8.shape[2]
    if hkv != h:
        k8 = k8.repeat_interleave(h // hkv, dim=2)
        v8 = v8.repeat_interleave(h // hkv, dim=2)
    dev = q8.device
    sm = plan.sm
    qi = torch.arange(sq, device=dev)[:, None]
    q_last = (qi // bq) * bq + bq - 1                   # (Sq, 1)
    m = torch.full((b, h, sq, 1), NEG, dtype=torch.int32, device=dev)
    s = torch.zeros((b, h, sq, 1), dtype=torch.int32, device=dev)
    acc = torch.zeros((b, h, sq, d), dtype=torch.int32, device=dev)
    for j in range(skv // bkv):
        t0 = j * bkv
        act = torch.ones((sq, 1), dtype=torch.bool, device=dev)
        if causal:
            act = t0 <= q_last
            if not bool(act.any()):
                break          # later blocks start later still
        ki = t0 + torch.arange(bkv, device=dev)[None, :]
        live = torch.ones((sq, bkv), dtype=torch.bool, device=dev)
        if causal:
            live = live & (ki <= qi)
        if window > 0:
            live = live & (ki > qi - window)
        kb, vb = k8[:, t0:t0 + bkv], v8[:, t0:t0 + bkv]
        scores = int_einsum("bqhd,bkhd->bhqk", q8, kb)
        scores = torch.where(live, scores, torch.full_like(scores, NEG))
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        corr16 = combine_correction(m, m_new, sm)
        e16 = torch.where(live, _exp16(scores - m_new, sm),
                          torch.zeros_like(scores))
        u8 = (e16 >> 8).to(torch.int8)
        s_new = rescale_sum(s, corr16) + e16.sum(dim=-1, keepdim=True,
                                                 dtype=torch.int32)
        acc_new = rescale_sum(acc, corr16) \
            + int_einsum("bhqk,bkhd->bhqd", u8, vb)
        m = torch.where(act, m_new, m)
        s = torch.where(act, s_new, s)
        acc = torch.where(act, acc_new, acc)
    s8 = torch.clamp(s >> 8, min=1)
    whole = torch.div(acc, s8, rounding_mode="floor")
    rem = acc - whole * s8
    frac7 = torch.div(rem << 7, s8, rounding_mode="floor")
    out7 = whole * 128 + frac7
    out = clip_to_bits(apply_dyadic(out7, plan.dn_out), out_bits)
    return out.to(torch.int8).permute(0, 2, 1, 3).contiguous()


def int_attention_online(q8, k8, v8, plan, causal: bool = True,
                         window: int = 0, bq: int = 128, bkv: int = 128,
                         out_bits: int = 8):
    """q8 (B, Sq, H, D) int8; k8/v8 (B, Skv, Hkv, D) int8 (GQA: Hkv | H).

    Mask: ``ki <= qi`` when ``causal`` and ``ki > qi - window`` when
    ``window`` > 0 (each on its own, as in the reference kernel).
    ``bq``/``bkv``: the logical blocks (clamped to the lengths, and then
    required to divide them).  The epilogue is the plan's per-tensor
    ``dn_out`` clipped to ``out_bits``; the result is int8 (B, Sq, H, D)
    as in the reference, whose int8 store wraps a wider clip.  CPU
    tensors take the plain version; CUDA tensors launch the tensor-core
    kernel (:func:`k8_launch_plan`, through the contract
    ``analysis.contracts.online_report``) or raise (Skv > 2^16, a head
    dim outside ``HEAD_DIMS``)."""
    if not q8.is_cuda:
        return int_attention_online_plain(q8, k8, v8, plan, causal, window,
                                          bq, bkv, out_bits)
    from repro_torch.kernels import _abi
    from repro_torch.kernels._build import library
    bq, bkv = _blocks(q8, k8, bq, bkv)
    if k8.shape != v8.shape:
        raise ValueError("int_attention_online: k and v shapes differ")
    for name, t in (("q8", q8), ("k8", k8), ("v8", v8)):
        if t.device != q8.device or t.dtype != torch.int8 \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int_attention_online: {name} must be a "
                             "contiguous, 16-byte aligned int8 tensor on "
                             f"{q8.device}")
    b, sq, h, d = q8.shape
    skv, hkv = k8.shape[1], k8.shape[2]
    kp = require_launch(online_report(b, sq, skv, h, hkv, d, bq, bkv)).plan
    out = torch.empty((b, sq, h, d), dtype=torch.int8, device=q8.device)
    if b == 0 or sq == 0:
        return out
    if RECORDERS:
        note_launch("int_attention", dict(
            b=b, sq=sq, skv=skv, h=h, hkv=hkv, d=d, bq=bq, bkv=bkv,
            online=True), "online", kp.grid, 1, kp.smem)
    dn = plan.dn_out
    _abi._shifts_ok(dn.b, dn.c, dn.pre)
    args = _abi.OnlineArgs(
        q8.data_ptr(), k8.data_ptr(), v8.data_ptr(), out.data_ptr(), b, sq,
        k8.shape[1], h, k8.shape[2], d, bq, bkv, int(bool(causal)),
        max(window, 0), kp.tiles, kp.smem, dn.b, dn.c, dn.pre,
        -(1 << (out_bits - 1)), (1 << (out_bits - 1)) - 1,
        exp16_args(plan.sm))
    lib = library()
    rc = lib.r8_int_attention_online(ctypes.byref(args), _abi.stream_of(q8))
    LAUNCHES["int_attention_online"] += 1
    _abi.check(lib, rc, "int_attention_online")
    return out
