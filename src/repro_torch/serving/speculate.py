"""Self-speculative draft proposers for the serving engine (the port of
``repro.serving.speculate``).

A cheap *proposer* drafts ``K`` next tokens per live lane, and the engine
verifies all ``K + 1`` positions in ONE decode-attention call with the
``Sq = K + 1`` stepped mask (K3 on the ``cuda`` backend).  Greedy
acceptance keeps the longest prefix of the draft that matches the
model's own argmax stream, so speculation changes *when* tokens are
computed, never *which*: the committed stream equals ``spec_k = 0``'s.

:class:`NgramProposer` is prompt-lookup decoding: match the context's
trailing n-gram against its own earlier occurrences (prompt + generated
tokens) and propose the continuation.  No draft model, no extra weights.

Rejected drafts roll back as a position decrement plus
``PagedKVCache.truncate``; ``valid_len`` masking hides the stale K/V.

Typed errors: :class:`SpeculationError` (a ``ValueError``) for
configuration mistakes, :class:`SpeculationUnsupported` for archs and
sampling modes the verify step cannot serve.  :func:`validate_spec` is
the one check the engine constructor and the serve CLI share.
"""
from __future__ import annotations

from typing import Dict, List, Protocol, Sequence, Type

from repro_torch.analysis.budgets import MAX_SQ
from repro_torch.models.common import ArchConfig
from repro_torch.models.inttransformer import speculative_decode_supported


class SpeculationError(ValueError):
    """Invalid speculative-decoding configuration (bad ``spec_k``,
    unknown proposer mode)."""


class SpeculationUnsupported(SpeculationError):
    """Speculative decoding cannot serve this request or arch: sliding-
    window archs (a batched multi-position write would clobber rolling
    slots earlier verify rows still read), archs with Mamba sublayers
    (their lane-indexed state cannot roll back a rejected draft) and
    ``temperature > 0`` requests (greedy acceptance is exact only against
    the argmax stream)."""


class Proposer(Protocol):
    """Drafts up to ``k`` next tokens from the decoded context."""

    name: str

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        """``<= k`` draft tokens continuing ``context`` (the session's
        ``prompt + out_tokens``).  An empty list is always legal: the
        verify step then scores the bonus token alone."""
        ...


class NgramProposer:
    """Prompt-lookup decoding: propose the continuation of the most
    recent earlier occurrence of the context's trailing n-gram.

    Tries suffix lengths ``max_n`` down to ``min_n``; for the first
    suffix that re-occurs earlier, proposes the ``k`` tokens that
    followed its latest occurrence with a full ``k``-token continuation
    (else the latest partial one).  No match: an empty draft."""

    name = "ngram"

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise SpeculationError(
                f"need 1 <= min_n <= max_n, got min_n={min_n}, "
                f"max_n={max_n}")
        self.max_n = max_n
        self.min_n = min_n

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        ctx = list(context)
        n_ctx = len(ctx)
        if k <= 0 or n_ctx < self.min_n + 1:
            return []
        for n in range(min(self.max_n, n_ctx - 1), self.min_n - 1, -1):
            suffix = ctx[n_ctx - n:]
            best: List[int] = []
            for start in range(n_ctx - n - 1, -1, -1):
                if ctx[start:start + n] == suffix:
                    cont = ctx[start + n:start + n + k]
                    if len(cont) == k:
                        return [int(t) for t in cont]
                    if cont and not best:
                        best = cont
            if best:
                return [int(t) for t in best]
        return []


PROPOSERS: Dict[str, Type] = {NgramProposer.name: NgramProposer}


def get_proposer(mode: str, **kwargs) -> Proposer:
    """A registered proposer by name; :class:`SpeculationError` on an
    unknown mode."""
    cls = PROPOSERS.get(mode)
    if cls is None:
        raise SpeculationError(
            f"unknown spec_mode {mode!r}; registered proposers: "
            f"{sorted(PROPOSERS)}")
    return cls(**kwargs)


def validate_spec(cfg: ArchConfig, spec_k: int, spec_mode: str) -> None:
    """Typed validation of a speculative-decoding configuration, shared
    by the engine constructor and the serve CLI."""
    if spec_k < 0:
        raise SpeculationError(f"spec_k must be >= 0, got {spec_k}")
    if spec_k == 0:
        return
    if spec_k > MAX_SQ - 1:
        raise SpeculationError(
            f"spec_k={spec_k} exceeds the decode kernel's speculative "
            f"query budget: the Sq = spec_k + 1 verify launch holds at "
            f"most MAX_SQ={MAX_SQ} rows (analysis.budgets), so spec_k <= "
            f"{MAX_SQ - 1}")
    if not speculative_decode_supported(cfg):
        raise SpeculationUnsupported(
            f"speculative decoding is unsupported for arch "
            f"{cfg.name!r}: the batched verify step needs full "
            "(window == 0) causal attention and attention+ffn/moe "
            "sublayers only — sliding-window caches interleave rolling-"
            "buffer writes and reads token-by-token, and SSM / cross-"
            "attention archs carry lane-indexed state a rejected draft "
            "cannot roll back; serve with spec_k=0")
    get_proposer(spec_mode)


__all__ = [
    "NgramProposer", "PROPOSERS", "Proposer", "SpeculationError",
    "SpeculationUnsupported", "get_proposer", "validate_spec",
]
