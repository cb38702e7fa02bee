"""Launch and request contracts of the port's kernels (the Hopper twin of
``repro.analysis.contracts``), and the reference's block fitting.

:func:`check_launch` states, without launching anything, what one kernel
launch would look like on the H100 and whether the kernel takes it: a
:class:`LaunchReport` with the plan's route, CUDA grid, cluster, dynamic
shared memory and CTA size, the kernel instantiation it runs
(``kernel``, which ``chip_smoke.py`` queries on the card for registers,
spills and occupancy) and, in ``reasons``, every clause a refused shape
violates.  ``ok=False`` predicts the :class:`KernelContractError` the
kernel's wrapper raises on the card before launching; ``fused=False``
with ``ok=True`` predicts the backend's exact fallback (the chunked
two-pass attention, or K5 under the online backend's length floor), as
in the reference.

The clauses and the geometry are not restated here: they come from the
port's own plan functions, which stay beside their kernels and are what
the wrappers launch with (``kernels/int8_matmul.py``: ``launch_plan``,
``msr4_plan``, ``grouped_plan``; ``kernels/int_layernorm.py`` and
``kernels/int_softmax.py``: ``launch_plan``;
``kernels/int_decode_attention.py``: ``k3_launch_plan``;
``kernels/int_attention_fused.py``: ``k4_launch_plan`` /
``k5_launch_plan``; ``kernels/int_attention.py``: ``k8_launch_plan``).
They are imported inside the functions, so this module imports without a
card, and a plan that raises becomes a report with its message among the
reasons.  Each op has a report function of positional integers under a
``functools.lru_cache`` (``matmul_report``, ``decode_report``, ...): the
wrappers call those, so a launch pays one dict lookup for its contract.
Addresses enter only through their alignment (the address mod 16, which
is all a plan reads).

The reference's Pallas block parameters (``bm`` / ``bn`` / ``bk``, the
exact kernels' ``bq`` / ``bkv``, ``min_block``) and its epilogue flags
are accepted by :func:`check_launch`, so a reference call site works
unchanged; they change no Hopper launch, whose tiles the plans choose.
The online attention's ``bq`` / ``bkv`` are its logical blocks and do.

Also here: the serving request contract (``check_request`` /
``require_request``, copied from the reference), the online attention's
own contract (``check_online_launch``) and ``fit_block``.
"""
from __future__ import annotations

import dataclasses
import functools
import types

from repro_torch.analysis.budgets import MAX_ROWSUM_LEN, MAX_SKV_ONLINE

#: the reference's threshold (``intlayers.int_attn_fwd``) above which a
#: backend without a fused attention kernel (``cuda_ref``, ``torch_ref``:
#: the twins of ``ref``) streams the chunked two-pass attention
FULL_MATRIX_MAX = (4096 * 4096) // 4

#: below these query / key lengths the online backend takes the exact
#: attention, as the reference's ``pallas`` takes its oracle
MIN_BLOCK = 16

#: SMs of the card a report assumes unless told (H100 SXM)
SMS = 132


def fit_block(blk: int, dim: int) -> int:
    """Largest block <= blk that divides dim (the reference's
    ``_fit_block``: its kernels assert ``dim % blk == 0``, and the online
    attention's and the chunked attention's integers depend on it)."""
    blk = min(blk, dim)
    while dim % blk:
        blk -= 1
    return blk


class KernelContractError(ValueError):
    """A kernel launch precondition is violated.  Fields: ``op`` (kernel
    name), ``reasons`` (every violated clause)."""

    def __init__(self, op: str, reasons):
        self.op = op
        self.reasons = tuple(reasons)
        super().__init__(
            f"{op} launch contract violated: " + "; ".join(self.reasons))


@dataclasses.dataclass(frozen=True)
class LaunchReport:
    """What one launch would look like on the card, statically.

    ``ok``      — the kernel takes the shape (False: its wrapper raises
                  :class:`KernelContractError` before launching);
    ``fused``   — the backend launches this kernel (False with ``ok``:
                  it takes its exact fallback instead);
    ``reasons`` — every violated or declining clause;
    ``grid``    — the CUDA grid ``(x, y, z)`` (K2 / K7: ``(blocks,)``);
    ``blocks``  — the plan's tile sizes (read-only);
    ``smem_bytes`` — the dynamic shared memory a CTA (static shared
                  memory is the compiled kernel's own);
    ``threads`` — a CTA's threads; ``cluster`` — CTAs a cluster;
    ``route``   — the plan's route (K1 ``tma`` / ``copy`` / ``mma64`` /
                  ``mma128``, K3 ``resident`` / ``streaming``, K4 / K5
                  ``store`` / ``recompute``, K2 / K7 ``warp`` / ``block``,
                  the correction ``mma`` / ``gather``, K8 ``online``);
    ``args``    — ``(name, shape)`` of each operand that rode as scalar
                  prefetch on the TPU and is a plain kernel argument here;
    ``backend`` — the backend whose route choice ``fused`` states;
    ``kernel``  — the instantiation: the kernel library's attribute entry
                  (``r8_attrs_<kernel[0]>``) and its template selectors;
    ``plan``    — the plan function's own result, which the wrapper
                  launches with (not compared)."""

    op: str
    ok: bool
    fused: bool
    reasons: tuple = ()
    grid: tuple = ()
    blocks: types.MappingProxyType = types.MappingProxyType({})
    smem_bytes: int = 0
    threads: int = 0
    cluster: int = 1
    route: str = ""
    args: tuple = ()
    backend: str = "cuda"
    kernel: tuple = ()
    plan: object = dataclasses.field(default=None, compare=False,
                                     repr=False)


def _report(op, reasons, policy=(), plan=None, blocks=None, **kw):
    return LaunchReport(op=op, ok=not reasons,
                        fused=not (reasons or policy),
                        reasons=tuple(reasons) + tuple(policy),
                        blocks=types.MappingProxyType(dict(blocks or {})),
                        plan=plan, **kw)


def _plan(reasons, fn, *args):
    """``fn(*args)``, or None with its ``ValueError`` among ``reasons``."""
    try:
        return fn(*args)
    except KernelContractError as e:
        reasons.extend(e.reasons)
    except ValueError as e:
        reasons.append(str(e))
    return None


def _row_sum(length: int, what: str) -> list:
    if length > MAX_ROWSUM_LEN:
        return [f"row-sum int32 budget: {what} of {length} positions is "
                f"longer than the {MAX_ROWSUM_LEN} an exact int32 row sum "
                "allows"]
    return []


# ------------------------------------------------------- the matmuls --

@functools.lru_cache(maxsize=4096)
def matmul_report(m: int, n: int, k: int, packed: bool, sms: int,
                  x_align: int, w_align: int) -> LaunchReport:
    """K1 (``int8_matmul``, or ``int8_matmul_packed`` over int4 nibble
    pairs) for an (m, k) x (k, n) product; ``x_align`` / ``w_align``:
    the operands' addresses mod 16.  An empty product launches nothing
    (route ``none``)."""
    from repro_torch.kernels import int8_matmul as K1
    op = "int8_matmul_packed" if packed else "int8_matmul"
    if m < 1 or n < 1:
        return _report(op, [], route="none")
    reasons = []
    if k < 1:
        reasons.append(f"{op}: empty contraction (K == 0)")
    if packed and k % 2:
        reasons.append("packed weights pair nibbles along K: K must be "
                       f"even (got K={k})")
    if reasons:
        return _report(op, reasons)
    p = K1.launch_plan(m, n, k, sms, packed, x_align, w_align)
    if p.tile == 0:
        bm, bn, bk = K1.DECODE_BM, p.bn, K1.decode_k_step(packed)
        route, threads, entry = p.route, K1.DECODE_THREADS, \
            "int8_matmul_decode"
        sel = p.bn
    else:
        bm, bn, bk = K1.TILES[p.tile]
        route, threads, entry, sel = f"mma{bm}", K1.MMA_THREADS, \
            "int8_matmul", bm
    return _report(op, [], plan=p, grid=p.grid,
                   blocks=dict(bm=bm, bn=bn, bk=bk,
                               k_per_split=p.k_per_split),
                   smem_bytes=p.smem, threads=threads, cluster=p.cluster,
                   route=route, kernel=(entry, sel, int(packed)))


@functools.lru_cache(maxsize=1024)
def msr4_report(m: int, n: int, k: int, group: int, n_out: int,
                sms: int) -> LaunchReport:
    """The MSR-4 outlier correction (``int8_matmul_msr4``), the second
    launch of ``int8_matmul_packed`` over MSR-4 weights with lanes."""
    from repro_torch.kernels import int8_matmul as K1
    op = "int8_matmul_msr4"
    if m < 1 or n < 1:
        return _report(op, [], route="none")
    reasons = []
    if group < 1 or k < 1 or k % group:
        reasons.append(f"msr4 groups must tile K: K={k}, group={group}")
        return _report(op, reasons)
    p = K1.msr4_plan(m, n, k, group, n_out, sms)
    mma = p.route == "mma"
    return _report(op, [], plan=p, grid=p.grid,
                   blocks=dict(mt=p.mt, kc=p.kc, lc=p.lc, sp=p.sp,
                               groups_per_split=p.groups_per_split),
                   smem_bytes=p.smem,
                   threads=K1.MSR4_MMA_THREADS if mma else K1.MSR4_THREADS,
                   route=p.route, kernel=("int8_matmul_msr4", int(mma),
                                          p.mt))


@functools.lru_cache(maxsize=1024)
def grouped_report(e: int, r: int, n: int, k: int, sms: int, x_align: int,
                   w_align: int) -> LaunchReport:
    """K1's grouped instantiation (``int8_matmul_grouped``): ``e``
    experts of ``r`` rows against (k, n) weights each; ``x_align`` /
    ``w_align``: the operands' addresses mod 16.  Refused where the live
    list of ``e`` experts does not fit a block's shared memory."""
    from repro_torch.kernels import int8_matmul as K1
    op = "int8_matmul_grouped"
    if e < 1 or r < 1 or n < 1:
        return _report(op, [], route="none")
    if k < 1:
        return _report(op, [f"{op}: empty contraction (K == 0)"])
    p = K1.grouped_plan(e, r, n, k, sms, x_align, w_align)
    if p.smem > K1.MSR4_MAX_SMEM:
        return _report(op, [f"{op}: {e} experts' live list does not fit "
                            f"the shared memory ({p.smem} > "
                            f"{K1.MSR4_MAX_SMEM} B)"])
    return _report(op, [], plan=p, grid=p.grid,
                   blocks=dict(bm=p.rt, bn=K1.GROUPED_BN,
                               bk=K1.GROUPED_KS),
                   smem_bytes=p.smem, threads=p.threads, cluster=p.cluster,
                   route=p.route, args=(("rows", (e,)),),
                   kernel=("int8_matmul_grouped", p.rt))


# ------------------------------------------------ norms and softmax ----

@functools.lru_cache(maxsize=1024)
def layernorm_report(rows: int, d: int, aligned: bool, subtract_mean: bool,
                     beta: bool, sms: int) -> LaunchReport:
    """K2 (``int_layernorm``) over ``rows`` rows of ``d``."""
    from repro_torch.kernels import int_layernorm as K2
    reasons = []
    p = _plan(reasons, K2.launch_plan, rows, d, sms, aligned)
    if p is None:
        return _report("int_layernorm", reasons)
    return _report("int_layernorm", [], plan=p, grid=(p.grid,),
                   blocks=dict(rows_per_cta=p.rows_per_cta, vec=p.vec,
                               values_per_lane=p.values_per_lane),
                   threads=p.threads, route=p.route,
                   kernel=("int_layernorm", int(p.route == "warp"), p.vec,
                           p.values_per_lane, int(subtract_mean),
                           int(beta)))


@functools.lru_cache(maxsize=1024)
def softmax_report(rows: int, L: int, valid_len: int, aligned: bool,
                   block_rows: int) -> LaunchReport:
    """K7 (``int_softmax``) over ``rows`` rows of ``L`` scores."""
    from repro_torch.kernels import int_softmax as K7
    reasons = _row_sum(L, "a softmax row")
    p = None if reasons else _plan(reasons, K7.launch_plan, rows, L,
                                   valid_len, aligned, block_rows)
    if p is None:
        return _report("int_softmax", reasons)
    return _report("int_softmax", [], plan=p, grid=(p.grid,),
                   blocks=dict(rows_per_block=p.rows_per_block, vec=p.vec,
                               vpt=p.vpt, valid=p.valid),
                   threads=p.threads, route=p.route,
                   kernel=("int_softmax", int(p.route == "warp"), p.vec,
                           p.vpt))


# -------------------------------------------------------- attention ----

def _gqa(h: int, hkv: int) -> list:
    if hkv < 1 or h % hkv:
        return [f"GQA requires Hkv | H: got H={h}, Hkv={hkv}"]
    return []


def _page_args(b, max_pages, kv_pack, num_pages, first):
    args = [first, ("pages", (b, max_pages))]
    if kv_pack:
        args += [("k_shift", (num_pages,)), ("v_shift", (num_pages,))]
    return tuple(args)


@functools.lru_cache(maxsize=1024)
def decode_report(b: int, sq: int, h: int, hkv: int, d: int, length: int,
                  max_pages: int, kv_pack: bool, num_pages: int,
                  k_align: int, v_align: int, sms: int) -> LaunchReport:
    """K3 (``int_decode_attention``): ``(b, sq, h, d)`` queries over
    ``length`` positions a lane, through a ``(b, max_pages)`` page table
    (``max_pages`` 0: the contiguous cache), over int4 pools with
    ``kv_pack``."""
    from repro_torch.kernels import int_decode_attention as K3
    op = "int_decode_attention"
    paged = max_pages > 0
    reasons = _gqa(h, hkv) + _row_sum(length, "a lane's cache")
    if kv_pack and d % 2:
        reasons.append("int4 KV pages pair nibbles along the head dim: d "
                       f"must be even (got {d})")
    p = None if reasons else _plan(reasons, K3.k3_launch_plan, b, sq, h,
                                   hkv, d, length, paged, kv_pack, k_align,
                                   v_align, sms)
    args = _page_args(b, max_pages, kv_pack, num_pages,
                      ("valid_len", (b,))) if paged else \
        (("valid_len", (b,)),)
    if p is None:
        return _report(op, reasons, args=args)
    return _report(op, [], plan=p, grid=p.grid,
                   blocks=dict(rank_keys=p.rank_keys, mtb=p.mtb,
                               copy_bytes=p.copy_bytes),
                   smem_bytes=p.smem, threads=K3.K3_THREADS,
                   cluster=p.cluster,
                   route="resident" if p.resident else "streaming",
                   args=args, kernel=("int_decode_attention", d, int(paged),
                                      int(kv_pack), int(p.resident)))


@functools.lru_cache(maxsize=1024)
def prefill_report(b: int, c: int, h: int, hkv: int, d: int,
                   max_pages: int, page_size: int, kv_pack: bool,
                   num_pages: int, k_align: int,
                   e16_fits: bool) -> LaunchReport:
    """K4 (``int_paged_prefill``): a ``(b, c, h, d)`` chunk through a
    ``(b, max_pages)`` table of ``page_size``-row pages."""
    from repro_torch.kernels import int_attention_fused as K5
    op = "int_paged_prefill"
    reasons = _gqa(h, hkv) + _row_sum(max_pages * page_size,
                                      "a page table's span")
    if kv_pack and d % 2:
        reasons.append("int4 KV pages pair nibbles along the head dim: d "
                       f"must be even (got {d})")
    p = None if reasons else _plan(reasons, K5.k4_launch_plan, b, c, h,
                                   hkv, d, max_pages, page_size, k_align,
                                   e16_fits, kv_pack)
    args = _page_args(b, max_pages, kv_pack, num_pages, ("pos_end", (b,)))
    if p is None:
        return _report(op, reasons, args=args)
    return _report(op, [], plan=p, grid=p.grid,
                   blocks=dict(bq=K5.K5_ROWS, bkv=K5.K5_KEYS,
                               tiles=p.tiles),
                   smem_bytes=p.smem, threads=K5.K5_THREADS,
                   route="store" if p.store_e16 else "recompute",
                   args=args, kernel=("int_paged_prefill", d,
                                      int(p.store_e16), int(kv_pack)))


def fused_attention_takes(skv: int) -> bool:
    """The ``cuda`` backend's full-sequence attention policy: K5 wherever
    its exact int32 row sum holds, the chunked two-pass above (the
    reference's ``pallas_fused`` falls back there too)."""
    return skv <= MAX_ROWSUM_LEN


def ref_streams_chunked(sq: int, skv: int, cross: bool = False) -> bool:
    """The policy of a backend without a fused attention kernel
    (``cuda_ref`` / ``torch_ref``, the twins of the reference's ``ref``):
    self attention above ``S * Skv = FULL_MATRIX_MAX`` streams the chunked
    two-pass; cross attention never does."""
    return sq * skv > FULL_MATRIX_MAX and not cross


def online_takes(sq: int, skv: int) -> bool:
    """The ``cuda_online`` backend's policy: the online kernel K8 from
    ``MIN_BLOCK`` query and key rows on, the exact K5 below."""
    return sq >= MIN_BLOCK and skv >= MIN_BLOCK


@functools.lru_cache(maxsize=1024)
def attention_report(b: int, sq: int, skv: int, h: int, hkv: int, d: int,
                     causal: bool, window: int, k_align: int,
                     e16_fits: bool, backend: str = "cuda",
                     cross: bool = False) -> LaunchReport:
    """K5 (``int_attention``, exact), and whether ``backend`` launches it
    for this shape (``fused``) or streams the chunked two-pass."""
    from repro_torch.kernels import int_attention_fused as K5
    op = "int_attention"
    reasons = _gqa(h, hkv) + _row_sum(skv, "a key row")
    policy = []
    if not fused_attention_takes(skv):
        policy.append(f"the {backend} backend streams the chunked two-pass "
                      f"attention above Skv = {MAX_ROWSUM_LEN}")
    elif backend != "cuda" and ref_streams_chunked(sq, skv, cross):
        policy.append(f"the {backend} backend streams the chunked two-pass "
                      f"attention above S*Skv = {FULL_MATRIX_MAX}")
    causal = bool(causal) or window > 0
    p = None if reasons else _plan(reasons, K5.k5_launch_plan, b, sq, skv,
                                   h, hkv, d, causal, max(window, 0),
                                   k_align, e16_fits)
    if p is None:
        return _report(op, reasons, policy, backend=backend)
    return _report(op, [], policy, plan=p, grid=p.grid,
                   blocks=dict(bq=K5.K5_ROWS, bkv=K5.K5_KEYS,
                               tiles=p.tiles),
                   smem_bytes=p.smem, threads=K5.K5_THREADS,
                   route="store" if p.store_e16 else "recompute",
                   backend=backend,
                   kernel=("int_attention_fused", d,
                           int(causal and window > 0), int(p.store_e16)))


@functools.lru_cache(maxsize=1024)
def online_report(b: int, sq: int, skv: int, h: int, hkv: int, d: int,
                  bq: int, bkv: int) -> LaunchReport:
    """K8 (``int_attention`` with ``online=True``) at the logical blocks
    ``(bq, bkv)`` after the reference's clamping to ``(Sq, Skv)``;
    ``fused`` is ``cuda_online``'s choice of K8 over the exact K5."""
    from repro_torch.kernels import int_attention as K8
    op = "int_attention_online"
    bq, bkv = min(bq, sq), min(bkv, skv)
    reasons = list(check_online_launch(sq, skv, h, hkv, bq, bkv))
    policy = [] if online_takes(sq, skv) else [
        f"cuda_online takes the exact attention below {MIN_BLOCK} query "
        f"or key rows (Sq={sq}, Skv={skv})"]
    p = None if reasons else _plan(reasons, K8.k8_launch_plan, b, sq, h, d,
                                   bkv)
    if p is None:
        return _report(op, reasons, policy, backend="cuda_online",
                       blocks=dict(bq=bq, bkv=bkv))
    return _report(op, [], policy, plan=p, grid=p.grid,
                   blocks=dict(bq=bq, bkv=bkv, tiles=p.tiles),
                   smem_bytes=p.smem, threads=K8.K8_THREADS, route="online",
                   backend="cuda_online",
                   kernel=("int_attention_online", d))


# ----------------------------------------- check_launch, by keyword ----

def _al(addr: int) -> int:
    return int(addr) % 16


def _check_int8_matmul(m, n, k, bm=None, bn=None, bk=None, out_bits=8,
                       has_bias=False, per_channel=False, packed=False,
                       sms=SMS, x_addr=0, w_addr=0):
    return matmul_report(m, n, k, bool(packed), sms, _al(x_addr),
                         _al(w_addr))


def _check_int8_matmul_packed(m, n, k, bm=None, bn=None, bk=None,
                              out_bits=8, has_bias=False, per_channel=False,
                              sms=SMS, x_addr=0, w_addr=0):
    return matmul_report(m, n, k, True, sms, _al(x_addr), _al(w_addr))


def _check_int8_matmul_msr4(m, n, k, group, n_out, sms=SMS):
    """The correction of MSR-4 weights (port only: the reference's caller
    adds it outside its kernel, ``ops/backends/pallas_fused.py``)."""
    return msr4_report(m, n, k, group, n_out, sms)


def _check_int8_matmul_grouped(e, r, n, k, out_bits=8, has_bias=False,
                               per_channel=False, sms=SMS, x_addr=0,
                               w_addr=0):
    """Port only: the reference runs its expert products outside any
    kernel (``models/intlayers.py::int_expert_linear``), so it has no
    contract to mirror."""
    return grouped_report(e, r, n, k, sms, _al(x_addr), _al(w_addr))


def _check_int_layernorm(rows, d, aligned=True, subtract_mean=False,
                         beta=False, out_bits=8, sms=SMS):
    return layernorm_report(rows, d, bool(aligned), bool(subtract_mean),
                            bool(beta), sms)


def _check_int_softmax(rows, L, valid_len=-1, aligned=True, block_rows=8):
    return softmax_report(rows, L, valid_len, bool(aligned), block_rows)


def _check_int_attention(b, sq, skv, h, hkv, d, bq=128, bkv=128,
                         out_bits=8, per_channel=False, min_block=None,
                         online=False, causal=True, window=0, k_addr=0,
                         e16_fits=True, backend="cuda", cross=False):
    if online:
        return online_report(b, sq, skv, h, hkv, d, bq, bkv)
    return attention_report(b, sq, skv, h, hkv, d, bool(causal), window,
                            _al(k_addr), bool(e16_fits), backend,
                            bool(cross))


def _fold(rep, fold, n_out):
    if fold and not n_out:
        return dataclasses.replace(
            rep, ok=False, fused=False, reasons=rep.reasons + (
                "folded wo projection needs n_out (= wo_w8 output "
                "channels)",))
    return rep


def _check_int_decode_attention(b, sq, h, hkv, d, L=None, bkv=None,
                                max_pages=0, page_size=0, out_bits=8,
                                per_channel=False, fold=False, n_out=0,
                                kv_pack=False, num_pages=0, min_block=None,
                                k_addr=0, v_addr=0, sms=SMS):
    if page_size > 0:
        L = max_pages * page_size
    else:
        max_pages = 0
    if L is None:
        raise TypeError("need L (contiguous) or max_pages and page_size")
    rep = decode_report(b, sq, h, hkv, d, L, max_pages, bool(kv_pack),
                        num_pages, _al(k_addr), _al(v_addr), sms)
    return _fold(rep, fold, n_out)


def _check_int_paged_prefill(b, c, h, hkv, d, max_pages, page_size,
                             bq=None, bkv=None, out_bits=8,
                             per_channel=False, fold=False, n_out=0,
                             kv_pack=False, num_pages=0, min_block=None,
                             k_addr=0, e16_fits=True):
    rep = prefill_report(b, c, h, hkv, d, max_pages, page_size,
                         bool(kv_pack), num_pages, _al(k_addr),
                         bool(e16_fits))
    return _fold(rep, fold, n_out)


_CHECKS = {
    "int8_matmul": _check_int8_matmul,
    "int8_matmul_packed": _check_int8_matmul_packed,
    "int8_matmul_msr4": _check_int8_matmul_msr4,
    "int8_matmul_grouped": _check_int8_matmul_grouped,
    "int_layernorm": _check_int_layernorm,
    "int_softmax": _check_int_softmax,
    "int_attention": _check_int_attention,
    "int_decode_attention": _check_int_decode_attention,
    "int_paged_prefill": _check_int_paged_prefill,
}


def check_launch(op: str, **params) -> LaunchReport:
    """Statically check one kernel launch on the card.  ``op``: the
    reference's ``int8_matmul`` / ``int8_matmul_packed`` /
    ``int_attention`` (``online=True``: the one-pass K8) /
    ``int_decode_attention`` / ``int_paged_prefill``, and the port's
    ``int_layernorm`` (K2), ``int_softmax`` (K7), ``int8_matmul_msr4``
    (the MSR-4 correction) and ``int8_matmul_grouped`` (the experts);
    ``params``: the launch's shapes by the reference's names, plus the
    port's ``sms``, operand addresses (``x_addr`` / ``w_addr`` /
    ``k_addr`` / ``v_addr``), ``causal`` / ``window`` / ``e16_fits`` /
    ``backend`` / ``cross`` for K5, ``subtract_mean`` / ``beta`` /
    ``aligned`` for K2, ``group`` / ``n_out`` for the correction."""
    if op not in _CHECKS:
        raise KeyError(f"unknown kernel op {op!r}; known: "
                       f"{sorted(_CHECKS)}")
    return _CHECKS[op](**params)


def check_tp_launch(op: str, tp: int = 1, **params) -> LaunchReport:
    """The per-rank launch of a tensor-parallel serving step: a rank of
    ``tp`` launches the attention kernels with ``h / tp`` query heads and
    ``hkv / tp`` KV heads of the global problem (``h`` / ``hkv`` in
    ``params``), every other shape unchanged.  Shard-divisibility
    violations come back as a failed report, as in the reference."""
    if op not in ("int_attention", "int_decode_attention",
                  "int_paged_prefill"):
        raise KeyError(f"check_tp_launch covers the attention launches "
                       f"of the tp serving path, not {op!r}")
    reasons = []
    if tp < 1:
        reasons.append(f"tp must be >= 1 (got {tp})")
    h, hkv = params.get("h"), params.get("hkv")
    if h is None or hkv is None:
        reasons.append("per-shard check needs the global h and hkv")
    elif tp >= 1:
        if hkv % tp:
            reasons.append(f"tp={tp} must divide the KV head count "
                           f"(hkv={hkv}): each shard owns hkv/tp heads")
        if h % tp:
            reasons.append(f"tp={tp} must divide the query head count "
                           f"(h={h})")
    if reasons:
        return LaunchReport(op=op, ok=False, fused=False,
                            reasons=tuple(reasons))
    return check_launch(op, **{**params, "h": h // tp, "hkv": hkv // tp})


def require_launch(report: LaunchReport) -> LaunchReport:
    """Raise :class:`KernelContractError` unless the kernel takes the
    launch (``report.ok``).  A backend's decline (``fused=False`` with
    ``ok``) passes: the backend takes its exact fallback."""
    if not report.ok:
        raise KernelContractError(report.op, report.reasons)
    return report


def check_online_launch(sq: int, skv: int, h: int, hkv: int, bq: int,
                        bkv: int) -> tuple:
    """Violated clauses of one online-attention launch (empty = ok), as
    far as its plain version shares them: the logical blocks must divide
    the sequence lengths (they *are* the integers, see
    ``kernels/int_attention.py``) and keys are bounded by
    ``MAX_SKV_ONLINE``.  ``bq``/``bkv`` are the logical blocks after the
    wrapper's clamping to ``(Sq, Skv)``."""
    reasons = _gqa(h, hkv)
    if skv > MAX_SKV_ONLINE:
        reasons.append(f"row-sum int32 budget: Skv <= {MAX_SKV_ONLINE} "
                       f"(got {skv})")
    if bq < 1 or bkv < 1 or sq % bq or skv % bkv:
        reasons.append(f"blocks must divide (Sq,Skv)=({sq},{skv}): "
                       f"(bq,bkv)=({bq},{bkv})")
    return tuple(reasons)


def require_online_launch(sq: int, skv: int, h: int, hkv: int, bq: int,
                          bkv: int) -> None:
    """Raise :class:`KernelContractError` if :func:`check_online_launch`
    finds any violated clause."""
    reasons = check_online_launch(sq, skv, h, hkv, bq, bkv)
    if reasons:
        raise KernelContractError("int_attention_online", reasons)


# ------------------------------------------------- request feasibility --

class RequestInfeasible(ValueError):
    """A serving request that can never complete on this cache geometry.
    Fields: ``prompt_len``, ``max_new_tokens``, ``cache_len``,
    ``reasons`` (every violated clause)."""

    def __init__(self, prompt_len: int, max_new_tokens: int,
                 cache_len: int, reasons):
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.cache_len = cache_len
        self.reasons = tuple(reasons)
        super().__init__(
            f"infeasible request (prompt_len={prompt_len}, "
            f"max_new_tokens={max_new_tokens}, cache_len={cache_len}): "
            + "; ".join(self.reasons))


def check_request(prompt_len: int, max_new_tokens: int, cache_len: int,
                  window: int = 0, page_size: int = 0,
                  num_pages: int = 0) -> tuple:
    """Violated clauses of one request against a cache geometry (empty =
    feasible).  Full-causal archs need ``prompt_len - 1 + max_new_tokens
    <= cache_len``; a paged pool must be able to hold the prompt."""
    reasons = []
    if prompt_len < 1:
        reasons.append("empty prompt: a request needs at least one token")
    if max_new_tokens < 1:
        reasons.append(f"max_new_tokens must be >= 1 (got "
                       f"{max_new_tokens})")
    L = min(cache_len, window) if window > 0 else cache_len
    if window == 0 and prompt_len > L:
        reasons.append(
            f"prompt of {prompt_len} tokens exceeds the cache_len={L} "
            "logical cache: prefill would write past the page table and "
            "silently corrupt live positions")
    elif window == 0 and prompt_len - 1 + max_new_tokens > cache_len:
        reasons.append(
            f"prompt_len + max_new_tokens exceeds the cache: the stream "
            f"needs {prompt_len - 1 + max_new_tokens} K/V positions but "
            f"cache_len={cache_len} — the request would silently retire "
            f"after {cache_len - prompt_len + 1} token(s); shrink "
            "max_new_tokens or raise cache_len")
    if window == 0 and page_size > 0 and num_pages > 0:
        span = min(max(prompt_len - 1, 0), L)
        blocks = -(-span // page_size)
        if blocks > num_pages - 1:
            reasons.append(
                f"prompt prefill needs {blocks} pages but the pool only "
                f"has {num_pages - 1} allocatable (page 0 is the null "
                "page): the admission can never succeed")
    return tuple(reasons)


def require_request(prompt_len: int, max_new_tokens: int, cache_len: int,
                    window: int = 0, page_size: int = 0,
                    num_pages: int = 0) -> None:
    """Raise :class:`RequestInfeasible` if :func:`check_request` finds
    any violated clause."""
    reasons = check_request(prompt_len, max_new_tokens, cache_len,
                            window=window, page_size=page_size,
                            num_pages=num_pages)
    if reasons:
        raise RequestInfeasible(prompt_len, max_new_tokens, cache_len,
                                reasons)
