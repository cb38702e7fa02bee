"""Whole-model integer-range certification (the abstract interpreter; twin
of ``repro.analysis.interpret``).

:func:`certify_config` walks one architecture's design-time plans
(``quant.plans.build_layer_plans``) layer-kind by layer-kind, pushing
worst-case :class:`~repro_torch.analysis.ranges.IntRange` intervals
through the transfer functions of every op of the ``repro_torch.ops`` API
— ``int8_matmul``, ``int8_matmul_packed``, ``int_softmax``, ``int_gelu``,
``int_layernorm``, ``int_attention``, ``int_decode_attention`` /
``int_paged_prefill`` (both also at their int4-KV-page operand ranges) —
at a given ``(seq_len, cache_len)``, and raises a typed, location-bearing
:class:`~repro_torch.analysis.budgets.BitBudgetError` if *any*
intermediate of the exact integer computation could leave int32.  The
walk covers every family the port serves: dense (full-causal and
windowed), encoder, MoE, Mamba-2 / hybrid and cross attention.  On
success it returns a :class:`ConfigReport` with per-op worst-case bits
and headroom; ``worst``, ``bits``, ``note``, ``n_dyadics`` and
``assumptions`` are the reference's for every config (the tests hold
them equal).

Where the reference predicts its Pallas path, ``OpReport.path`` names the
one the port's default ``cuda`` backend takes, from
:func:`~repro_torch.analysis.contracts.check_launch`: ``cuda`` for a
matmul (the reference's ``pallas``), ``fused`` or
``fallback:two-pass-streaming`` for attention, ``exact`` where no launch
contract applies.  ``route`` and ``smem_bytes`` are that launch's on the
H100 at the serving geometry of ``launch/serve.py``'s defaults (a batch of
``SERVE_BATCH`` lanes, pages of ``SERVE_PAGE`` rows, chunks of
``SERVE_CHUNK``): a matmul at M = the batch (a decode step, an MoE's
experts at its decode rows), K3 at Sq = 1 over ``cache_len`` positions,
K4 at one chunk, K5 over ``seq_len``, K2 at the batch's rows.  Ops the
port runs outside any kernel (the SwiGLU gate, the SSD state path, the
MoE gate's softmax over its top-k) have route ``plain``.

On top of the op walk, :func:`~repro_torch.analysis.ranges.audit_dyadics`
re-proves the ``fit_dyadic`` staging invariant of **every** dyadic in the
plan tree (including the ~20 Mamba-branch constants) at its declared
``qmax_in``.  What is *assumed* rather than proven is returned in
``ConfigReport.assumptions`` (docs/ANALYSIS.md).
"""
from __future__ import annotations

import dataclasses

from repro_torch.analysis import contracts
from repro_torch.analysis.budgets import (MAX_ROWSUM_LEN, bits_for,
                                          static_check)
from repro_torch.analysis.ranges import (INT4, INT4_KV, INT8, MSR4_DELTA_MAX,
                                         IntRange, audit_dyadics,
                                         t_attention_acc, t_clip, t_dyadic,
                                         t_dyadic_perchannel, t_gelu,
                                         t_layernorm, t_matmul_acc,
                                         t_requant_spec, t_silu, t_softmax)

#: nominal folded-bias bound at accumulator scale: |B| <= 4 real units
#: over s_act8 * S_W8 ~ 1e-3 -> ~4e3; listed as an assumption per config
BIAS_QMAX = 1 << 12

#: the serving geometry of ``launch/serve.py``'s defaults (``--batch``,
#: ``--page-size``, and the engine's ~32-token prefill chunks) at which
#: each op's Hopper route is reported
SERVE_BATCH, SERVE_PAGE, SERVE_CHUNK = 4, 16, 32


@dataclasses.dataclass(frozen=True)
class OpReport:
    """One certified op instance at one model-walk location."""

    op: str                 # the repro_torch.ops API name
    layer: str              # model-walk location, e.g. "attn.qkv"
    worst: int              # worst-case |q| across the op's intermediates
    path: str = "exact"     # the cuda backend's path (see module docstring)
    note: str = ""
    route: str = ""         # the Hopper launch's route at SERVE_* geometry
    smem_bytes: int = 0     # ... and its dynamic shared memory a CTA

    @property
    def bits(self) -> int:
        return bits_for(self.worst) + 1     # sign bit included

    @property
    def headroom_bits(self) -> int:
        return 32 - self.bits


@dataclasses.dataclass
class ConfigReport:
    """Certification result for one registry config."""

    name: str
    seq_len: int
    cache_len: int
    ops: list
    n_dyadics: int          # plan-tree dyadics whose staging was re-proved
    assumptions: list

    @property
    def worst_bits(self) -> int:
        return max(o.bits for o in self.ops)

    @property
    def min_headroom_bits(self) -> int:
        return min(o.headroom_bits for o in self.ops)


class _Track:
    """Collect named intermediates; ``worst`` is the certified maximum."""

    def __init__(self):
        self.vals = []

    def __call__(self, name: str, r):
        q = r.qmax if isinstance(r, IntRange) else int(r)
        self.vals.append((name, q))
        return r

    @property
    def worst(self) -> int:
        return max(q for _, q in self.vals) if self.vals else 0


def _launch(rep, path=None) -> dict:
    """OpReport fields of a :class:`~repro_torch.analysis.contracts.
    LaunchReport`: its route and shared memory, and the path (``path`` for
    a fused launch, the chunked fallback or a refusal otherwise)."""
    if rep is None:
        return {}
    if not rep.ok:
        taken = "refused"
    elif rep.fused:
        taken = path or "fused"
    else:
        taken = "fallback:two-pass-streaming"
    return dict(path=taken, route=rep.route, smem_bytes=rep.smem_bytes)


_PLAIN = dict(route="plain")


# ======================================================================
# the seven per-op checkers
# ======================================================================

def plan_b_max(plan) -> int:
    """The sound per-channel multiplier bound for a ``LinearPlan``.

    The plan's shared ``(c, pre)`` come from ``fit_dyadic`` at the
    worst-case channel ratio (``s_w <= S_W8``, the design's nominal
    weight-scale bound — listed as an assumption), so every channel's
    multiplier is bounded by that fit's own ``b`` — typically in
    [2^14, 2^15), far tighter than the generic 2^15-1."""
    from repro_torch.core.dyadic import fit_dyadic
    from repro_torch.quant.plans import S_W8
    dn = fit_dyadic(plan.s_in * S_W8 / plan.s_out, plan.acc_qmax)
    assert (dn.c, dn.pre) == (plan.c, plan.pre), (dn, plan)
    return dn.b


def check_int8_matmul(plan, layer: str, x: IntRange = INT8,
                      bias_qmax: int = BIAS_QMAX, op: str = "int8_matmul",
                      launch=None):
    """A ``quant.plans.LinearPlan`` matmul: int8·int8 → int32 acc (+bias)
    → per-channel dyadic requant (or raw when ``s_out == 0``).
    ``launch``: its :class:`~repro_torch.analysis.contracts.LaunchReport`
    (route and path; None: none reported)."""
    t = _Track()
    acc = t("accumulator", t_matmul_acc(
        plan.k_dim, x, bias=IntRange.symmetric(bias_qmax),
        op=op, layer=layer))
    if plan.s_out == 0.0:                      # raw int32 logits
        out = acc
    else:
        out = t_clip(t("requant staging", t_dyadic_perchannel(
            acc, plan.c, plan.pre, b_max=plan_b_max(plan),
            op=op, layer=layer)), plan.out_bits)
    return out, OpReport(op, layer, t.worst,
                         **{"path": "cuda", **_launch(launch, "cuda")})


def check_int8_matmul_packed(plan, layer: str, x: IntRange = INT8,
                             bias_qmax: int = BIAS_QMAX,
                             op: str = "int8_matmul_packed", launch=None):
    """The sub-8-bit weight tier: the packed matmul accumulates the
    nibble operand (``|w| <= 7``) and — for msr4 — the outlier-lane
    correction (``|delta| <= 120``, distinct rows per group) as separate
    int32 partials whose sum is the dense accumulator.  Element-wise
    ``|nib| + |delta| == |w| <= 127``, so the combined range is exactly
    the dense ``k·|x|·127`` budget; the split pieces are certified
    individually because the kernels materialize them (K1's nibble
    launch, then the correction kernel)."""
    t = _Track()
    t("nibble accumulator", t_matmul_acc(
        plan.k_dim, x, w_qmax=INT4.qmax,
        what="packed nibble accumulator", op=op, layer=layer))
    t("outlier correction", t_matmul_acc(
        plan.k_dim, x, w_qmax=MSR4_DELTA_MAX,
        what="msr4 outlier correction", op=op, layer=layer))
    acc = t("accumulator", t_matmul_acc(
        plan.k_dim, x, bias=IntRange.symmetric(bias_qmax),
        op=op, layer=layer))
    if plan.s_out == 0.0:
        out = acc
    else:
        out = t_clip(t("requant staging", t_dyadic_perchannel(
            acc, plan.c, plan.pre, b_max=plan_b_max(plan),
            op=op, layer=layer)), plan.out_bits)
    return out, OpReport(op, layer, t.worst, note="msr4",
                         **{"path": "cuda", **_launch(launch, "cuda")})


def check_int_softmax(sm, score: IntRange, rowlen: int, layer: str,
                      exact: bool = True, op: str = "int_softmax",
                      launch=None):
    t = _Track()
    t("scores", score)
    out = t_softmax(sm, score, rowlen, exact_rowsum=exact,
                    op=op, layer=layer)
    if exact:
        t("row sum", rowlen * (1 << 15))
    extra = _launch(launch) if launch is not None else _PLAIN
    return out, OpReport(op, layer, t.worst,
                         **{**extra, "path": "exact" if exact
                            else "streaming"})


def check_int_gelu(ffn, x: IntRange, layer: str, op: str = "int_gelu"):
    """The FFN activation stage (i-GELU, K6's grid-stride launch; or
    i-SiLU + gate for SwiGLU, plain PyTorch)."""
    t = _Track()
    if ffn.act_gelu is not None:
        t("i-gelu product", x.qmax * 2 * ffn.act_gelu.gelu.q_one)
        out = t_gelu(ffn.act_gelu, x, op=op, layer=layer)
        note, route = "i-gelu", "grid-stride"
    else:
        t("i-silu product", x.qmax << 15)
        gate8 = t_silu(ffn.act_silu, x, op=op, layer=layer)
        prod = IntRange.symmetric(
            static_check(gate8.qmax * x.qmax, "swiglu gate product",
                         op=op, layer=layer))
        t("swiglu gate product", prod)
        out = t_clip(t_dyadic(prod, ffn.dn_gate, what="swiglu gate dyadic",
                              op=op, layer=layer), 8)
        note, route = "i-silu + swiglu gate", "plain"
    return out, OpReport(op, layer, t.worst, note=note, route=route)


def check_int_layernorm(plan, layer: str, x: IntRange = None,
                        op: str = "int_layernorm", launch=None):
    t = _Track()
    x = IntRange.symmetric(plan.qmax_in) if x is None else x
    y_max = x.qmax * 2 if plan.subtract_mean else x.qmax
    t("normalisation product",
      y_max << (plan.recip_bits + plan.pre_shift))
    out = t_layernorm(plan, x, op=op, layer=layer)
    return out, OpReport(op, layer, t.worst,
                         note="layernorm" if plan.subtract_mean
                         else "rmsnorm", **_launch(launch, "exact"))


def _attention_core(ia, rowlen: int, layer: str, op: str, t: _Track,
                    kv_qmax: int = 127):
    """Shared Q·Kᵀ → Shiftmax → P·V → dn_out epilogue range walk.

    ``kv_qmax`` is the K/V operand magnitude: 127 on the int8 grid, or
    ``INT4_KV.qmax`` (7 << KV4_SHIFT = 112) when the pages store packed
    nibbles that the kernel dequantizes in-launch — strictly inside the
    int8 grid, so the packed tier certifies wherever the dense one does."""
    score = t("scores", t_matmul_acc(
        ia.head_dim, w_qmax=kv_qmax,
        what="attention score accumulator", op=op, layer=layer))
    exact = rowlen <= MAX_ROWSUM_LEN
    t_softmax(ia.sm, score, rowlen, exact_rowsum=exact, op=op, layer=layer)
    acc = t("P*V accumulator", t_attention_acc(rowlen, v_qmax=kv_qmax,
                                               op=op, layer=layer))
    out = t_clip(t("epilogue staging", t_dyadic(
        acc, ia.dn_out, what="attention epilogue dyadic",
        op=op, layer=layer)), 8)
    return out, exact


def check_int_attention(ia, seq_len: int, layer: str,
                        op: str = "int_attention", launch=None):
    t = _Track()
    out, _ = _attention_core(ia, seq_len, layer, op, t)
    return out, OpReport(op, layer, t.worst, **_launch(launch))


def check_int_decode_attention(ia, cache_len: int, layer: str,
                               kv_pack: bool = False,
                               op: str = "int_decode_attention",
                               launch=None):
    t = _Track()
    kv_qmax = INT4_KV.qmax if kv_pack else 127
    out, _ = _attention_core(ia, cache_len, layer, op, t, kv_qmax=kv_qmax)
    return out, OpReport(op, layer, t.worst,
                         note="int4 kv pages" if kv_pack else "",
                         **_launch(launch))


def check_int_paged_prefill(ia, cache_len: int, layer: str, wo=None,
                            kv_pack: bool = False,
                            op: str = "int_paged_prefill", launch=None):
    """``wo``: the o-projection ``LinearPlan`` when certifying the
    folded-wo epilogue (int8 attention tile → int8 matmul → per-channel
    requant; the port runs it as a second K1 launch)."""
    t = _Track()
    kv_qmax = INT4_KV.qmax if kv_pack else 127
    out, _ = _attention_core(ia, cache_len, layer, op, t, kv_qmax=kv_qmax)
    if wo is not None:
        t("folded wo accumulator", t_matmul_acc(
            wo.k_dim, out, bias=IntRange.symmetric(BIAS_QMAX),
            what="folded wo accumulator", op=op, layer=layer))
        t("folded wo staging", t_dyadic_perchannel(
            IntRange.symmetric(t.vals[-1][1]), wo.c, wo.pre,
            b_max=plan_b_max(wo), what="folded wo requant",
            op=op, layer=layer))
    return out, OpReport(op, layer, t.worst,
                         note="int4 kv pages" if kv_pack else "",
                         **_launch(launch))


def check_requant_spec(spec, r: IntRange, op: str, layer: str,
                       b_max: int = None) -> IntRange:
    """Certify one :class:`repro_torch.ops.RequantSpec` epilogue against
    an incoming range — the entry point the regression tests drive with
    deliberately-unsafe specs."""
    kw = {} if b_max is None else {"b_max": b_max}
    return t_requant_spec(r, spec, op=op, layer=layer, **kw)


# ======================================================================
# the model walk
# ======================================================================

class _Geometry:
    """The launch reports of one config at the serving geometry."""

    def __init__(self, cfg, seq_len: int, cache_len: int):
        self.cfg = cfg
        self.seq_len = seq_len
        self.cache_len = cache_len

    def matmul(self, k: int, n: int, packed: bool = False):
        return contracts.check_launch(
            "int8_matmul_packed" if packed else "int8_matmul",
            m=SERVE_BATCH, n=n, k=k)

    def experts(self, k: int, n: int):
        from repro_torch.models.intlayers import moe_capacity
        cfg = self.cfg
        return contracts.check_launch(
            "int8_matmul_grouped", e=cfg.padded_experts(),
            r=SERVE_BATCH * moe_capacity(cfg, 1), n=n, k=k)

    def norm(self, plan):
        return contracts.check_launch(
            "int_layernorm", rows=SERVE_BATCH, d=plan.d,
            subtract_mean=plan.subtract_mean, beta=plan.subtract_mean)

    def attention(self, cross: bool = False):
        cfg = self.cfg
        return contracts.check_launch(
            "int_attention", b=SERVE_BATCH, sq=self.seq_len,
            skv=self.seq_len, h=cfg.n_heads, hkv=cfg.n_kv_heads, d=cfg.hd,
            causal=cfg.is_causal and not cross,
            window=0 if cross else cfg.window, cross=cross)

    def _pages(self, kv_pack: bool):
        return dict(max_pages=-(-self.cache_len // SERVE_PAGE),
                    page_size=SERVE_PAGE, kv_pack=kv_pack,
                    num_pages=SERVE_BATCH * -(-self.cache_len // SERVE_PAGE)
                    + 1)

    def decode(self, kv_pack: bool = False):
        cfg = self.cfg
        return contracts.check_launch(
            "int_decode_attention", b=SERVE_BATCH, sq=1, h=cfg.n_heads,
            hkv=cfg.n_kv_heads, d=cfg.hd, **self._pages(kv_pack))

    def prefill(self, kv_pack: bool = False):
        cfg = self.cfg
        return contracts.check_launch(
            "int_paged_prefill", b=SERVE_BATCH, c=SERVE_CHUNK,
            h=cfg.n_heads, hkv=cfg.n_kv_heads, d=cfg.hd,
            **self._pages(kv_pack))


def _check_ffn(ffn, prefix: str, ops, geo: _Geometry, d_ff: int,
               experts: bool = False):
    d = geo.cfg.d_model
    launch = geo.experts if experts else geo.matmul
    h10, rep = check_int8_matmul(ffn.up, f"{prefix}.up",
                                 launch=launch(d, d_ff))
    ops.append(rep)
    a8, rep = check_int_gelu(ffn, h10, f"{prefix}.act")
    ops.append(rep)
    y, rep = check_int8_matmul(ffn.down, f"{prefix}.down",
                               launch=launch(d_ff, d))
    ops.append(rep)
    return y


def _check_mamba(m, cfg, ops, assumptions, geo: _Geometry):
    """Targeted checks on the Mamba2/SSD integer path; the plan-tree
    audit covers the remaining dyadics at their declared ranges."""
    from repro_torch.models.mamba import proj_width
    _, rep = check_int8_matmul(m.in_proj, "mamba.in_proj", launch=geo.matmul(
        cfg.d_model, proj_width(cfg) - cfg.ssm_heads))
    ops.append(rep)
    t = _Track()
    lyr = "mamba.ssd"
    opn = "int8_matmul"
    conv_acc = t("conv accumulator", t_matmul_acc(
        cfg.ssm_conv, what="conv accumulator", op=opn, layer=lyr))
    conv10 = t_clip(t_dyadic(conv_acc, m.dn_conv, what="conv dyadic",
                             op=opn, layer=lyr), 11)
    t_silu(m.silu_conv, conv10, op="int_gelu", layer=f"{lyr}.conv_silu")
    # dt path: accumulator -> 10-bit dt_in -> softplus -> 13-bit dt
    t_dyadic(IntRange.symmetric(m.in_proj.acc_qmax), m.dn_dt_in,
             what="dt dyadic", op=opn, layer=f"{lyr}.dt")
    dt = IntRange(0, (1 << 13) - 1)           # softplus clip at out_bits=13
    # decay: dt*A on the 2^-14 grid -> i-exp -> 2^-15 fraction
    t_dyadic(IntRange.symmetric(dt.hi * 1024), m.dn_dtA,
             what="dt*A dyadic", op=opn, layer=f"{lyr}.decay")
    # state update: dt * B * x contribution and the h8/y readout
    xbc = 127                                  # s_xbc int8 grid
    contrib = t("dt*B*x product", static_check(
        dt.hi * xbc * xbc, "dt*B*x product", op=opn, layer=lyr))
    t_dyadic(IntRange.symmetric(contrib), m.dn_h, what="state dyadic",
             op=opn, layer=f"{lyr}.state")
    t_dyadic(IntRange.symmetric(m.qmax_h), m.dn_h8, what="h8 dyadic",
             op=opn, layer=f"{lyr}.h8")
    y_acc = t("C*h8 accumulator", t_matmul_acc(
        cfg.ssm_state, what="C*h8 accumulator", op=opn, layer=lyr))
    t_dyadic(y_acc, m.dn_y, what="y dyadic", op=opn, layer=f"{lyr}.y")
    ops.append(OpReport(opn, lyr, t.worst, note="ssd state path", **_PLAIN))
    _, rep = check_int_layernorm(m.norm, "mamba.norm",
                                 launch=geo.norm(m.norm))
    ops.append(rep)
    _, rep = check_int8_matmul(m.out_proj, "mamba.out_proj",
                               launch=geo.matmul(cfg.ssm_d_inner,
                                                 cfg.d_model))
    ops.append(rep)
    assumptions.append(
        f"mamba head state saturates at qmax_h={m.qmax_h} "
        "(runtime clip in the SSD scan)")


def certify_config(cfg, seq_len: int = 4096, cache_len: int = 32768,
                   calib: dict = None) -> ConfigReport:
    """Statically certify one :class:`repro_torch.models.common.ArchConfig`:
    every op of the integer datapath at worst case, at ``(seq_len,
    cache_len)``.  Raises :class:`BitBudgetError` (typed: op + layer +
    worst value) on any int32 overflow; returns the report otherwise."""
    from repro_torch.quant.plans import LinearPlan, build_layer_plans
    plans = build_layer_plans(cfg, calib)
    geo = _Geometry(cfg, seq_len, cache_len)
    d = cfg.d_model
    ops, assumptions = [], [
        f"residual stream bounded by qmax_res={cfg.qmax_res} "
        "(calibration contract — residual adds carry no runtime clip)",
        f"folded biases bounded by {BIAS_QMAX} at accumulator scale "
        "(|B| <= 4 real units over the nominal weight/act scales)",
        "int8 operands certified on the +-127 design grid "
        "(docs/ANALYSIS.md: 'The -128 corner')",
        "per-channel weight scales bounded by S_W8 (the nominal "
        "worst-case channel ratio every LinearPlan's (c, pre) is "
        "fitted at)",
        "i-norm output stage certified at the |n| <= sqrt(d) design "
        "bound (sigma^2 >= y_i^2/d; make_inorm's declared n_q_max)",
        "packed weight tier: nibbles on the +-7 grid, msr4 outlier "
        "deltas <= 120, element-wise |nib| + |delta| == |w| <= 127 "
        "(quant.pack contract)",
        "int4 KV pages dequantize to q4 << 4 (|kv| <= 112, inside the "
        "int8 grid; repro.ops.packed.KV_SHIFT)",
    ]
    # embedding -> residual stream
    t_dyadic(INT8, plans.embed.dn_res, what="embed residual dyadic",
             op="int8_matmul", layer="embed")
    # pre-attention / final norm (the same plan; certified once per site)
    _, rep = check_int_layernorm(plans.norm, "norm",
                                 launch=geo.norm(plans.norm))
    ops.append(rep)
    if plans.attn is not None:
        q_n = cfg.n_heads * cfg.hd
        _, rep = check_int8_matmul(plans.attn.qkv, "attn.qkv",
                                   launch=geo.matmul(d, q_n))
        ops.append(rep)
        _, rep = check_int8_matmul_packed(plans.attn.qkv, "attn.qkv[msr4]",
                                          launch=geo.matmul(d, q_n, True))
        ops.append(rep)
        _, rep = check_int_attention(plans.attn.attn, seq_len, "attn.core",
                                     launch=geo.attention())
        ops.append(rep)
        out8 = IntRange.symmetric(127)
        y, rep = check_int8_matmul(plans.attn.out, "attn.out", x=out8,
                                   launch=geo.matmul(q_n, d))
        ops.append(rep)
        static_check(y.qmax, "attention residual write",
                     budget=cfg.qmax_res, op="int8_matmul",
                     layer="attn.out")
        if cfg.is_causal:
            for kv4, tag in ((False, ""), (True, "[kv4]")):
                _, rep = check_int_decode_attention(
                    plans.attn.attn, cache_len, f"attn.decode{tag}",
                    kv_pack=kv4, launch=geo.decode(kv4))
                ops.append(rep)
            for kv4, tag in ((False, ""), (True, "[kv4]")):
                _, rep = check_int_paged_prefill(
                    plans.attn.attn, cache_len, f"attn.prefill{tag}",
                    wo=plans.attn.out, kv_pack=kv4,
                    launch=geo.prefill(kv4))
                ops.append(rep)
    elif plans.ffn is not None:
        # no attention projections: certify the packed weight tier on
        # the FFN up-projection so every config proves the sub-8-bit
        # matmul path
        _, rep = check_int8_matmul_packed(
            plans.ffn.up, "ffn.up[msr4]", launch=geo.matmul(d, cfg.d_ff,
                                                            True))
        ops.append(rep)
    elif plans.mamba is not None:
        from repro_torch.models.mamba import proj_width
        _, rep = check_int8_matmul_packed(
            plans.mamba.in_proj, "mamba.in_proj[msr4]",
            launch=geo.matmul(d, proj_width(cfg) - cfg.ssm_heads, True))
        ops.append(rep)
    if plans.cross is not None and plans.cross is not plans.attn:
        _, rep = check_int_attention(plans.cross.attn, seq_len,
                                     "cross.core",
                                     launch=geo.attention(cross=True))
        ops.append(rep)
    if plans.ffn is not None:
        y = _check_ffn(plans.ffn, "ffn", ops, geo, cfg.d_ff)
        static_check(y.qmax, "ffn residual write", budget=cfg.qmax_res,
                     op="int8_matmul", layer="ffn.down")
    if plans.moe is not None:
        f = cfg.moe_d_ff or cfg.d_ff
        logits, rep = check_int8_matmul(
            plans.moe.router, "moe.router",
            launch=geo.matmul(d, cfg.padded_experts()))
        ops.append(rep)
        _, rep = check_int_softmax(plans.moe.gate_sm, logits,
                                   cfg.n_experts, "moe.gate")
        ops.append(rep)
        _check_ffn(plans.moe.expert, "moe.expert", ops, geo, f,
                   experts=True)
        if plans.moe.shared is not None:
            _check_ffn(plans.moe.shared, "moe.shared", ops, geo,
                       f * cfg.n_shared_experts)
        combine = IntRange.symmetric(
            static_check(cfg.top_k * 127 * 127, "moe combine sum",
                         op="int8_matmul", layer="moe.combine"))
        t_dyadic(combine, plans.moe.dn_combine, what="moe combine dyadic",
                 op="int8_matmul", layer="moe.combine")
    if plans.mamba is not None:
        _check_mamba(plans.mamba, cfg, ops, assumptions, geo)
    _, rep = check_int8_matmul(
        LinearPlan(cfg.s_act8, 0.0, 32, 0, 0, cfg.d_model), "head",
        launch=geo.matmul(d, cfg.padded_vocab()))
    ops.append(rep)
    n_dyadics = audit_dyadics(plans, prefix=cfg.name)
    return ConfigReport(cfg.name, seq_len, cache_len, ops, n_dyadics,
                        assumptions)


__all__ = [
    "BIAS_QMAX", "ConfigReport", "OpReport", "SERVE_BATCH", "SERVE_CHUNK",
    "SERVE_PAGE", "certify_config", "check_int8_matmul",
    "check_int8_matmul_packed", "check_int_attention",
    "check_int_decode_attention", "check_int_gelu",
    "check_int_layernorm", "check_int_paged_prefill",
    "check_int_softmax", "check_requant_spec",
]
