"""The serving request contract, the online attention's launch contract
and the reference's block fitting (``fit_block``).

``check_request`` / ``require_request`` copy ``repro.analysis.contracts``.
The reference's tiling predicates (``can_tile*``) are not copied: they
state Pallas block constraints, and the port's exact kernels translate
every position through the page table, so they take any page size or
chunk length; each kernel wrapper raises for what its kernel cannot do
instead.

``check_online_launch`` is the online (one-pass) attention kernel's
contract (K8; the reference's ``check_launch("int_attention", ...,
online=True)``) as far as its plain version shares it: the logical blocks
must divide the sequence lengths (they *are* the integers, see
``kernels/int_attention.py``) and keys are bounded by ``MAX_SKV_ONLINE``.
The card's own limits (compiled head dims, shared memory per block) are
the CUDA library's: the kernel wrapper asks it and raises
:class:`KernelContractError` with its answer.
"""
from __future__ import annotations

from repro_torch.analysis.budgets import MAX_SKV_ONLINE


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


def check_online_launch(sq: int, skv: int, h: int, hkv: int, bq: int,
                        bkv: int) -> tuple:
    """Violated clauses of one online-attention launch (empty = ok).
    ``bq``/``bkv`` are the logical blocks after the wrapper's clamping to
    ``(Sq, Skv)``."""
    reasons = []
    if hkv < 1 or h % hkv:
        reasons.append(f"GQA requires Hkv | H: got H={h}, Hkv={hkv}")
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
