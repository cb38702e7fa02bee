"""Typed paged KV-cache layer: layouts, page tables, block allocator.

A copy of ``repro/serving/kvcache.py`` (numpy only, no framework code):
the port keeps its own so it imports nothing of the JAX package.  The
``int4`` storage tier and tensor-parallel pools are described here as in
the reference; the port's engine serves both tiers, and a tensor-parallel
rank builds its pools at its ``Hkv/tp`` heads.

The serving engine's cache abstraction (the "block-sparse paged KV
cache" the ROADMAP queued on top of PR 3's valid_len machinery).  A
contiguous per-slot cache spends ``num_slots × max_len`` tokens of HBM
whether slots are full or empty; a *paged* cache keeps one physical pool
of fixed-size pages and gives each live session only the pages its
tokens occupy — memory scales with **live tokens**, not provisioned
capacity.  The pieces:

  * :class:`CacheLayout`   — the frozen geometry: batch lanes, logical
    per-session length, page size, physical pool size;
  * :class:`BlockAllocator`— ref-counted free-list over physical pages
    (alloc / retain / release); exhaustion raises the typed
    :class:`PagePoolExhausted`;
  * :class:`PageTable`     — the ``int32[num_slots, max_pages]`` logical
    block → physical page map that rides into the decode kernel as a
    scalar-prefetch operand (next to ``valid_len``);
  * :class:`Session`       — a request's cache identity: the page list
    it *owns* (survives lane preemption) plus its decode position;
  * :class:`PagedKVCache`  — the host-side controller tying the three
    together for the engine (bind / ensure / unbind / release).

Invariants (normative — the kernel and the allocator both rely on them):

  * **Page 0 is the null page.**  It is never allocated.  Page-table
    entries for unmapped logical blocks stay 0, so dead lanes write
    their (masked, discarded) K/V into page 0 and the kernel's
    dead-block DMA clamp always lands on a resident page.
  * Pages are written append-only per session and are **never zeroed on
    reuse**: ``valid_len`` masking makes stale contents unobservable, so
    an evict → re-admit cycle reuses freed pages bit-exactly.
  * A page's refcount is the number of holders — sessions *plus*
    :class:`PrefixIndex` entries; it returns to the free list exactly
    when the count reaches zero.  Live lanes never share a page **they
    write**: read-only prompt-prefix pages may be mapped by several
    sessions at once (that is the whole point of prefix sharing), and
    the engine copy-on-writes any page with refcount > 1 before the
    first write lands on it.
  * **Page ids are device-agnostic.**  Under tensor-parallel serving
    the physical K/V pools shard on their *head* axis — every device
    holds ``Hkv/tp`` heads of every page — so this entire host-side layer (allocator, page table, prefix
    index, sessions) stays replicated untouched: one allocation maps
    the same page id into every device's pool slice, and CoW /
    preempt / evict need no distributed bookkeeping.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

NULL_PAGE = 0

# page-element storage tiers (CacheLayout.kv_dtype)
KV_DTYPES = ("int8", "int4")


class PagePoolExhausted(RuntimeError):
    """No free physical pages: the pool is smaller than the live token
    working set.  Evict or preempt a session, or provision more pages
    (``CacheLayout.num_pages``)."""


@dataclasses.dataclass(frozen=True)
class CacheLayout:
    """Frozen geometry of a paged KV pool.

    ``num_slots`` — batch lanes the engine decodes in lock-step;
    ``max_len``   — logical cache length per session (the engine's
                    ``cache_len``, or the attention window when smaller);
    ``page_size`` — tokens per physical page;
    ``num_pages`` — physical pool size *including* the reserved null
                    page 0 (so ``num_pages - 1`` pages are allocatable);
    ``kv_dtype``  — page-element storage: ``"int8"`` (one byte per
                    element) or ``"int4"`` (two head-dim nibbles per
                    byte plus a per-page requant shift; every page byte
                    holds two elements, so an equal-HBM pool admits 2×
                    the sessions).  This is the *storage* tier only —
                    kernels dequantize in-register
                    (``q4 << shift``), the
                    attention datapath stays int8.
    """

    num_slots: int
    max_len: int
    page_size: int
    num_pages: int
    kv_dtype: str = "int8"

    def __post_init__(self):
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {self.num_slots}")
        if self.max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {self.max_len}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is the "
                             f"reserved null page), got {self.num_pages}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, "
                             f"got {self.kv_dtype!r}")

    @property
    def max_pages(self) -> int:
        """Pages needed to map one full-length session (page-table width)."""
        return -(-self.max_len // self.page_size)

    @property
    def logical_len(self) -> int:
        """The kernel-visible logical cache length, ``max_pages ×
        page_size`` (≥ ``max_len``; the tail past ``max_len`` is never
        valid)."""
        return self.max_pages * self.page_size

    @property
    def capacity_tokens(self) -> int:
        """Tokens the allocatable pool can hold (null page excluded)."""
        return (self.num_pages - 1) * self.page_size

    @property
    def bytes_per_element(self) -> float:
        """HBM bytes per stored KV element (0.5 under int4 packing)."""
        return 0.5 if self.kv_dtype == "int4" else 1.0

    @classmethod
    def fit(cls, num_slots: int, max_len: int, page_size: int = 16,
            num_pages: Optional[int] = None,
            kv_dtype: str = "int8") -> "CacheLayout":
        """Layout for ``num_slots`` lanes of ``max_len`` tokens.  Without
        an explicit ``num_pages`` the pool is fully provisioned (every
        lane can reach ``max_len`` simultaneously) — undersubscribe it to
        make memory O(live tokens).  Under ``kv_dtype="int4"`` each page
        costs half the HBM, so the auto-provisioned pool doubles its
        page count at equal byte budget (2× admissible sessions)."""
        max_pages = -(-max_len // page_size)
        if num_pages is None:
            num_pages = num_slots * max_pages + 1
            if kv_dtype == "int4":
                num_pages = 2 * (num_pages - 1) + 1
        return cls(num_slots, max_len, page_size, num_pages, kv_dtype)


class BlockAllocator:
    """Ref-counted free-list over the physical pages of a pool.

    LIFO free list: the page freed last is handed out first, so an
    evict → re-admit cycle touches the smallest possible page set (and
    the bit-exact-reuse property is exercised constantly, not rarely).
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self.refcount = np.zeros(num_pages, np.int32)
        self.refcount[NULL_PAGE] = 1          # pinned forever
        self._free: List[int] = list(range(num_pages - 1, NULL_PAGE, -1))
        # optional pressure hook: invoked once when alloc() finds the
        # free list empty, *before* raising — the engine points it at
        # the prefix-index LRU eviction so cached-but-unreferenced
        # prefix pages are reclaimed instead of failing the allocation
        self.reclaim: Optional[Callable[[], None]] = None

    # ------------------------------------------------------------ alloc --

    def alloc(self) -> int:
        """Hand out a free page at refcount 1, or raise
        :class:`PagePoolExhausted`."""
        if not self._free and self.reclaim is not None:
            self.reclaim()
        if not self._free:
            raise PagePoolExhausted(
                f"page pool exhausted: all {self.num_pages - 1} "
                "allocatable pages are held by live or preempted "
                "sessions (evict one, or provision a larger "
                "CacheLayout.num_pages)")
        page = self._free.pop()
        self.refcount[page] = 1
        return page

    def retain(self, page: int):
        """Add a reference to an allocated page."""
        if page == NULL_PAGE or not 0 <= page < self.num_pages:
            raise ValueError(f"cannot retain page {page}")
        if self.refcount[page] <= 0:
            raise ValueError(f"retain of unallocated page {page}")
        self.refcount[page] += 1

    def release(self, page: int):
        """Drop a reference; the page returns to the free list at zero."""
        if page == NULL_PAGE or not 0 <= page < self.num_pages:
            raise ValueError(f"cannot release page {page}")
        if self.refcount[page] <= 0:
            raise ValueError(f"release of unallocated page {page}")
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self._free.append(page)

    # ------------------------------------------------------------- stats --

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - 1 - len(self._free)

    def check(self):
        """Invariant sweep (tests call this after every schedule step):
        free list and refcounts partition the allocatable pages."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate page on free list"
        assert NULL_PAGE not in free, "null page leaked onto the free list"
        for p in range(1, self.num_pages):
            held = self.refcount[p] > 0
            assert held != (p in free), \
                f"page {p}: refcount {self.refcount[p]} vs free-list " \
                f"membership {p in free}"
        assert self.refcount[NULL_PAGE] == 1, "null page refcount moved"


class PageTable:
    """The device-facing logical-block → physical-page map.

    One int32 row per batch lane, ``max_pages`` wide, default-filled
    with the null page.  ``snapshot()`` hands the decode step a *copy*
    (same aliasing rule as the engine's ``pos`` snapshot: jnp.asarray
    may zero-copy a numpy buffer while dispatch is still async)."""

    def __init__(self, layout: CacheLayout):
        self.layout = layout
        self.table = np.full((layout.num_slots, layout.max_pages),
                             NULL_PAGE, np.int32)

    def set_row(self, slot: int, pages: List[int]):
        if len(pages) > self.layout.max_pages:
            raise ValueError(f"{len(pages)} pages > max_pages="
                             f"{self.layout.max_pages}")
        self.table[slot] = NULL_PAGE
        self.table[slot, :len(pages)] = pages

    def clear_row(self, slot: int):
        self.table[slot] = NULL_PAGE

    def snapshot(self) -> np.ndarray:
        return self.table.copy()


@dataclasses.dataclass
class Session:
    """A request's cache identity: the pages it owns and where it is.

    Sessions — not lanes — own pages: a preempted session keeps its
    ``pages`` (and ``pos``/``prefill_pos``/``last_token``) while
    freeing its lane, so a later resume continues bit-exactly from the
    same physical cache — mid-prefill preemption included (the chunked
    scheduler resumes the prompt at ``prefill_pos``)."""

    uid: int
    request: object = None
    # queued | prefilling | active | preempted | done
    state: str = "queued"
    slot: Optional[int] = None     # lane while on one, else None
    pages: List[int] = dataclasses.field(default_factory=list)
    pos: int = 0
    prefill_pos: int = 0      # prompt tokens whose K/V are in pages
    last_token: Optional[int] = None

    @property
    def live_tokens(self) -> int:
        return self.pos


@dataclasses.dataclass
class PrefixEntry:
    """One cached prompt prefix: the physical pages holding the K/V of
    ``tokens`` (positions ``[0, count)``; the last page may be partial —
    a sharer's first write into it copy-on-writes)."""

    tokens: Tuple[int, ...]
    pages: Tuple[int, ...]
    count: int
    stamp: int = 0                 # LRU clock tick of the last touch


class PrefixIndex:
    """Per-engine cross-session prompt-prefix table.

    Maps token prefixes to the physical pages already holding their K/V,
    so a session whose prompt starts with a previously-prefilled prefix
    maps the *same* pages instead of recomputing them.  Correctness rests
    on full causal attention: K/V at position ``i`` depend only on tokens
    ``0..i``, so any two prompts sharing their first ``c`` tokens share
    the first ``c`` positions of K/V bit-for-bit (the engine gates the
    index to ``window == 0`` attention-only archs accordingly).

    The index holds its **own** refcount on every page an entry maps —
    entries outlive the sessions that created them, and the pages stay
    immutable because the engine copy-on-writes any page with
    refcount > 1 before writing it.  Under pool pressure the allocator's
    ``reclaim`` hook evicts entries LRU-first, so cached prefixes cost
    only otherwise-idle pages.
    """

    def __init__(self, allocator: BlockAllocator, page_size: int):
        self.allocator = allocator
        self.page_size = page_size
        self.entries: Dict[Tuple[int, ...], PrefixEntry] = {}
        self.clock = 0
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        self.evictions = 0

    # ----------------------------------------------------------- lookup --

    def lookup(self, prompt, n_pre: int) -> Optional[PrefixEntry]:
        """Longest registered prefix of ``prompt[:n_pre]``; retains the
        entry's pages *for the caller* (who must release them if it
        abandons the admission)."""
        self.clock += 1
        lengths = sorted({e.count for e in self.entries.values()
                          if e.count <= n_pre}, reverse=True)
        for ln in lengths:
            entry = self.entries.get(tuple(prompt[:ln]))
            if entry is not None:
                entry.stamp = self.clock
                for page in entry.pages:
                    self.allocator.retain(page)
                self.hits += 1
                self.tokens_reused += entry.count
                return entry
        self.misses += 1
        return None

    def register(self, prompt, n_pre: int, pages: List[int]):
        """Register a freshly prefilled prompt's prefixes: one entry per
        full-page boundary plus the (possibly page-unaligned) full
        ``n_pre`` length, each retaining its pages.  Existing entries are
        kept (their pages are already immutable)."""
        ps = self.page_size
        marks = list(range(ps, n_pre + 1, ps))
        if n_pre > 0 and (not marks or marks[-1] != n_pre):
            marks.append(n_pre)
        for count in marks:
            key = tuple(prompt[:count])
            if key in self.entries:
                self.entries[key].stamp = self.clock
                continue
            held = tuple(pages[:-(-count // ps)])
            for page in held:
                self.allocator.retain(page)
            self.clock += 1
            self.entries[key] = PrefixEntry(key, held, count, self.clock)

    # --------------------------------------------------------- eviction --

    def evict_lru(self) -> bool:
        """Drop the least-recently-used entry (its pages return to the
        free list once no session holds them).  Returns False on an
        empty index."""
        if not self.entries:
            return False
        key = min(self.entries, key=lambda k: self.entries[k].stamp)
        for page in self.entries[key].pages:
            self.allocator.release(page)
        del self.entries[key]
        self.evictions += 1
        return True

    def clear(self):
        while self.evict_lru():
            pass

    # ------------------------------------------------------------- stats --

    def stats(self) -> dict:
        return {
            "entries": len(self.entries),
            "hits": self.hits,
            "misses": self.misses,
            "tokens_reused": self.tokens_reused,
            "evictions": self.evictions,
        }


class PagedKVCache:
    """Host-side paged-cache controller for the serving engine.

    Owns the allocator and the page table; the engine owns the device
    pools (they live in the model cache pytree) and the lane scheduling.
    """

    def __init__(self, layout: CacheLayout):
        self.layout = layout
        self.allocator = BlockAllocator(layout.num_pages)
        self.page_table = PageTable(layout)

    # ---------------------------------------------------------- binding --

    def bind(self, session: Session, slot: int):
        """Attach a session to a lane, restoring its page-table row
        (empty for new sessions, its owned pages for resumed ones)."""
        session.slot = slot
        session.state = "active"
        self.page_table.set_row(slot, session.pages)

    def unbind(self, session: Session):
        """Free the lane but keep the pages (preemption)."""
        if session.slot is not None:
            self.page_table.clear_row(session.slot)
        session.slot = None
        session.state = "preempted"

    def release(self, session: Session):
        """Drop every page the session owns (retire / cancel)."""
        if session.slot is not None:
            self.page_table.clear_row(session.slot)
        for page in session.pages:
            self.allocator.release(page)
        session.pages = []
        session.slot = None
        session.state = "done"

    def truncate(self, session: Session, keep_tokens: int) -> int:
        """Speculative-rollback helper: drop the session's trailing
        pages beyond the ones backing its first ``keep_tokens`` logical
        positions, releasing each through the allocator (pages the
        prefix index also holds stay cached — the release only drops
        *this session's* reference).  The stale K/V a rejected draft
        wrote into the kept tail page needs no cleanup: ``valid_len``
        masking hides it, and the next decode write overwrites it —
        rollback is a position decrement plus this table truncation, no
        data movement.  Returns the number of pages released."""
        if keep_tokens < 0:
            raise ValueError(f"keep_tokens must be >= 0, got "
                             f"{keep_tokens}")
        keep_blocks = -(-keep_tokens // self.layout.page_size)
        released = 0
        while len(session.pages) > keep_blocks:
            page = session.pages.pop()
            if session.slot is not None:
                self.page_table.table[session.slot,
                                      len(session.pages)] = NULL_PAGE
            self.allocator.release(page)
            released += 1
        return released

    def ensure(self, session: Session, write_pos: int):
        """Make the page backing logical position ``write_pos`` resident
        before the decode step writes there.  Pages map append-only, so
        this allocates at most the next sequential block; raises
        :class:`PagePoolExhausted` when the pool is out."""
        blk = write_pos // self.layout.page_size
        if blk >= self.layout.max_pages:
            raise ValueError(f"write_pos {write_pos} past max_len "
                             f"{self.layout.max_len}")
        while len(session.pages) <= blk:
            page = self.allocator.alloc()
            session.pages.append(page)
            if session.slot is not None:
                self.page_table.table[session.slot,
                                      len(session.pages) - 1] = page
        return session.pages[blk]

    # ------------------------------------------------------------- stats --

    def stats(self) -> dict:
        a = self.allocator
        return {
            "page_size": self.layout.page_size,
            "num_pages": self.layout.num_pages,
            "pages_used": a.used_pages,
            "pages_free": a.free_pages,
            "capacity_tokens": self.layout.capacity_tokens,
        }
