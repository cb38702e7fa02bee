"""Async serving front end: admission, streaming, lifecycle, metrics (the
port of ``repro.serving.frontend``).

:class:`ServingFrontend` puts an asyncio surface over one
:class:`~repro_torch.serving.engine.ServingEngine`:

  * **Admission with backpressure**: ``submit()`` queues into the engine,
    at most ``max_pending`` requests in flight; past that it raises
    :class:`QueueFull`.  A request that can never complete on the
    engine's cache geometry (prompt + continuation past the cache, a
    prompt that can never fit the page pool) raises
    :class:`~repro_torch.analysis.contracts.RequestInfeasible` here.
  * **Token streaming**: ``submit()`` returns a :class:`StreamHandle`;
    ``async for tok in handle.stream()`` yields tokens as engine steps
    commit them.  The front end never touches the datapath, so streams
    equal the synchronous engine's.
  * **Cancellation and deadlines**: ``handle.cancel()`` and a per-request
    ``deadline_s`` resolve through the engine's ``evict`` (the lane
    frees, the session's pages return to the allocator), applied only
    between a commit and the next dispatch (the engine's
    :class:`~repro_torch.serving.engine.StepInFlight` guard).
  * **Host / device overlap**: each round dispatches a step
    (``dispatch_step``, which queues it on the card without waiting),
    yields to the consumers, then commits (``commit_step``, where the
    host waits on the logits).
  * **Metrics**: per-request TTFT, queue wait and inter-token gap;
    per-step occupancy and queue depth; terminal counts (``completed |
    cancelled | timeout | rejected``), in ``describe()`` with p50 / p99.

Everything runs on one event loop; the engine is not thread-safe.  A
schedule that makes no progress for ``stall_steps`` consecutive steps
with work still queued raises the engine's
:class:`~repro_torch.serving.engine.EngineStalled`.  ``clock`` is
injectable, for deadline tests without waiting.
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.analysis import contracts
from repro_torch.serving.engine import (EngineStalled, PendingStep, Request,
                                        ServingEngine)

#: terminal states a request can reach, in ``describe()["terminal"]``
#: order; ``rejected`` counts submit() attempts that never got a handle
TERMINAL_STATES = ("completed", "cancelled", "timeout", "rejected")

_EOS = object()                    # stream sentinel: handle is terminal


class QueueFull(RuntimeError):
    """Backpressure: the front end already has ``max_pending`` requests
    in flight (queued + prefilling + decoding).  The typed rejection an
    open-loop load source needs — shed the request (or retry later)
    instead of growing an unbounded queue.  Fields: ``max_pending``,
    ``pending``."""

    def __init__(self, max_pending: int, pending: int):
        self.max_pending = max_pending
        self.pending = pending
        super().__init__(
            f"admission queue full: {pending} requests in flight >= "
            f"max_pending={max_pending}; retry later or raise "
            "max_pending")


@dataclasses.dataclass
class RequestMetrics:
    """Per-request lifecycle timestamps (front-end ``clock`` domain —
    ``time.monotonic`` unless the front end was built with a test
    clock).  Durations derive: ``queue_wait_s`` (submit → first lane),
    ``ttft_s`` (submit → first token), ``tbt_s`` (mean gap between
    token commits; a speculative multi-token commit legitimately lands
    several tokens at one timestamp)."""

    submit_t: float
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    last_token_t: Optional[float] = None
    end_t: Optional[float] = None
    n_tokens: int = 0

    @property
    def queue_wait_s(self) -> Optional[float]:
        return None if self.admit_t is None \
            else self.admit_t - self.submit_t

    @property
    def ttft_s(self) -> Optional[float]:
        return None if self.first_token_t is None \
            else self.first_token_t - self.submit_t

    @property
    def tbt_s(self) -> Optional[float]:
        if self.first_token_t is None or self.n_tokens < 2:
            return None
        return (self.last_token_t - self.first_token_t) \
            / (self.n_tokens - 1)


class StreamHandle:
    """One submitted request's streaming surface.

    ``async for tok in handle.stream()`` yields tokens as the engine
    commits them and ends when the request reaches a terminal state
    (inspect :attr:`terminal` afterwards — ``completed``, ``cancelled``
    or ``timeout``).  Single consumer.  ``cancel()`` is synchronous and
    idempotent; the run loop applies it at the next commit boundary, so
    already-committed tokens still arrive before the stream ends."""

    def __init__(self, uid: int, request: Request, session,
                 deadline_s: Optional[float], submit_t: float):
        self.uid = uid
        self.request = request
        self.session = session
        self.deadline_s = deadline_s
        self.metrics = RequestMetrics(submit_t=submit_t)
        self.terminal: Optional[str] = None
        self.cancel_requested = False
        self._q: asyncio.Queue = asyncio.Queue()
        self._wake = None          # set by the owning frontend

    @property
    def state(self) -> str:
        """Live engine state, or the terminal state once reached."""
        return self.terminal if self.terminal is not None \
            else self.session.state

    @property
    def tokens(self) -> List[int]:
        """Tokens committed so far (the full output once terminal)."""
        return list(self.request.out_tokens)

    def cancel(self):
        """Request cancellation; applied by the run loop between steps.
        No-op once terminal."""
        if self.terminal is None:
            self.cancel_requested = True
            if self._wake is not None:
                self._wake.set()

    async def stream(self):
        """Async-iterate the token stream until terminal."""
        while True:
            tok = await self._q.get()
            if tok is _EOS:
                return
            yield tok

    async def result(self) -> List[int]:
        """Drain the stream; returns the full token list."""
        async for _ in self.stream():
            pass
        return self.tokens


def _pct(samples: Sequence[float]) -> Optional[dict]:
    if not samples:
        return None
    arr = np.asarray(samples, dtype=np.float64)
    return {
        "n": int(arr.size),
        "mean": float(arr.mean()),
        "p50": float(np.percentile(arr, 50)),
        "p99": float(np.percentile(arr, 99)),
    }


class ServingFrontend:
    """Asyncio front end over one :class:`ServingEngine` (see the module
    docstring for the full contract).

    ``max_pending`` bounds in-flight requests (default ``4 × batch``);
    ``clock`` injects a time source for deterministic deadline tests;
    ``stall_steps`` bounds consecutive no-progress steps before the run
    loop raises :class:`EngineStalled`."""

    def __init__(self, engine: ServingEngine,
                 max_pending: Optional[int] = None,
                 clock=time.monotonic, stall_steps: int = 1000):
        if max_pending is None:
            max_pending = 4 * engine.batch
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got "
                             f"{max_pending}")
        if stall_steps < 1:
            raise ValueError(f"stall_steps must be >= 1, got "
                             f"{stall_steps}")
        self.engine = engine
        self.max_pending = max_pending
        self.clock = clock
        self.stall_steps = stall_steps
        self._live: Dict[int, StreamHandle] = {}
        self._uid = 0
        self._wake = asyncio.Event()
        self._closed = False
        self._running = False
        # aggregates ------------------------------------------------------
        self._counts = {t: 0 for t in TERMINAL_STATES}
        self._submitted = 0
        self._steps = 0
        self._occupancy: List[int] = []
        self._queue_depth: List[int] = []
        self._ttfts: List[float] = []
        self._queue_waits: List[float] = []
        self._itls: List[float] = []
        self._total_tokens = 0
        self._no_progress = 0

    # ------------------------------------------------------- admission --

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               *, temperature: float = 0.0,
               deadline_s: Optional[float] = None) -> StreamHandle:
        """Validate + admit one request; returns its
        :class:`StreamHandle`.

        Typed rejections (also counted in the ``rejected`` terminal
        bucket): :class:`~repro_torch.analysis.contracts.RequestInfeasible`
        for a request that can never complete on this engine's cache
        geometry — including a prompt whose prefill can never fit the
        page pool, which the bare engine only discovers as a
        ``PagePoolExhausted`` deep inside a step — and
        :class:`QueueFull` past the ``max_pending`` bound."""
        self._submitted += 1
        try:
            if deadline_s is not None and deadline_s <= 0:
                raise ValueError(f"deadline_s must be > 0, got "
                                 f"{deadline_s}")
            eng = self.engine
            pool = (dict(page_size=eng.layout.page_size,
                         num_pages=eng.layout.num_pages)
                    if eng.paged else {})
            contracts.require_request(len(prompt), max_new_tokens,
                                      eng.cache_len,
                                      window=eng.cfg.window, **pool)
            if len(self._live) >= self.max_pending:
                raise QueueFull(self.max_pending, len(self._live))
            req = Request(uid=self._uid, prompt=list(prompt),
                          max_new_tokens=max_new_tokens,
                          temperature=temperature)
            session = eng.submit(req)
        except Exception:
            self._counts["rejected"] += 1
            raise
        handle = StreamHandle(self._uid, req, session, deadline_s,
                              self.clock())
        handle._wake = self._wake
        self._live[self._uid] = handle
        self._uid += 1
        self._wake.set()
        return handle

    # ------------------------------------------------------- lifecycle --

    def _finish(self, handle: StreamHandle, terminal: str, now: float):
        """Move a handle to a terminal state: evict its session if it
        still holds engine resources, record metrics, end the stream."""
        sess = handle.session
        if sess.state != "done":
            self.engine.evict(sess)
        handle.terminal = terminal
        handle.metrics.end_t = now
        self._counts[terminal] += 1
        self._live.pop(handle.uid, None)
        handle._q.put_nowait(_EOS)

    def _apply_lifecycle(self, now: float):
        """Cancellations and deadline expiries, applied at the commit
        boundary (never between dispatch and commit — ``StepInFlight``
        would fire)."""
        for handle in list(self._live.values()):
            if handle.cancel_requested:
                self._finish(handle, "cancelled", now)
            elif handle.deadline_s is not None \
                    and now - handle.metrics.submit_t >= handle.deadline_s:
                self._finish(handle, "timeout", now)

    def _collect(self, now: float):
        """After a commit: push newly committed tokens into each
        handle's stream queue, stamp metrics, finish completed
        requests."""
        for handle in list(self._live.values()):
            sess = handle.session
            m = handle.metrics
            if m.admit_t is None and sess.state != "queued":
                m.admit_t = now
                self._queue_waits.append(m.queue_wait_s)
            new = handle.request.out_tokens[m.n_tokens:]
            if new:
                if m.first_token_t is None:
                    m.first_token_t = now
                    self._ttfts.append(now - m.submit_t)
                    gaps = len(new) - 1
                else:
                    gaps = len(new)
                # a multi-token (speculative) commit lands several
                # tokens at one timestamp: the first gap spans from the
                # previous commit, the rest are genuinely ~0
                if gaps:
                    self._itls.append((now - m.last_token_t
                                       if m.last_token_t is not None
                                       else 0.0))
                    self._itls.extend([0.0] * (gaps - 1))
                m.last_token_t = now
                m.n_tokens += len(new)
                self._total_tokens += len(new)
                for tok in new:
                    handle._q.put_nowait(tok)
            if handle.request.done:
                self._finish(handle, "completed", now)

    # -------------------------------------------------------- run loop --

    def _engine_idle(self) -> bool:
        eng = self.engine
        return not eng.queue and all(s is None for s in eng.slots)

    def _progress_stamp(self) -> tuple:
        eng = self.engine
        prefill = sum(s.prefill_pos for s in eng.queue)
        prefill += sum(s.prefill_pos for s in eng.slots if s is not None)
        return (self._total_tokens, prefill,
                sum(s is not None for s in eng.slots), len(eng.queue))

    def _check_stall(self, before: tuple):
        if self._engine_idle() or self._progress_stamp() != before:
            self._no_progress = 0
            return
        self._no_progress += 1
        if self._no_progress >= self.stall_steps:
            eng = self.engine
            slots = [
                None if s is None else {
                    "uid": s.request.uid, "state": s.state,
                    "pos": int(eng.pos[i]), "prefill_pos": s.prefill_pos,
                }
                for i, s in enumerate(eng.slots)
            ]
            raise EngineStalled(self.stall_steps, slots, len(eng.queue))

    def _next_deadline_s(self) -> Optional[float]:
        now = self.clock()
        deltas = [h.metrics.submit_t + h.deadline_s - now
                  for h in self._live.values() if h.deadline_s is not None]
        return max(0.0, min(deltas)) if deltas else None

    async def _sleep_until_work(self):
        """Idle: wait for a submit/cancel/close wake, or the nearest
        deadline (deadline deltas are computed in the injected clock's
        domain — under a test clock, advance it and ``poke()``)."""
        self._wake.clear()
        if self._live and any(h.cancel_requested
                              for h in self._live.values()):
            return                  # raced: apply before sleeping
        try:
            await asyncio.wait_for(self._wake.wait(),
                                   self._next_deadline_s())
        except asyncio.TimeoutError:
            pass

    def poke(self):
        """Wake the run loop (e.g. after advancing an injected test
        clock so a deadline check runs)."""
        self._wake.set()

    def close(self):
        """Ask the run loop to exit once the engine drains; safe to call
        from any coroutine on the loop.  Pending requests keep running
        to completion — cancel them first for a fast shutdown."""
        self._closed = True
        self._wake.set()

    async def step(self) -> int:
        """One front-end scheduling round: apply lifecycle ops, then
        dispatch → (yield to consumers) → commit → distribute.  Returns
        the engine's occupied-lane count.  ``run()`` is this in a loop;
        tests drive it directly for deterministic schedules."""
        now = self.clock()
        self._apply_lifecycle(now)
        if self._engine_idle():
            return 0
        before = self._progress_stamp()
        pending: PendingStep = self.engine.dispatch_step()
        self._steps += 1
        self._occupancy.append(pending.occupied)
        self._queue_depth.append(len(self.engine.queue))
        # overlap window: the launch is on the device; consumers drain
        # the queues the PREVIOUS commit filled while it executes
        await asyncio.sleep(0)
        self.engine.commit_step(pending)
        self._collect(self.clock())
        self._check_stall(before)
        # let consumers react to this commit before the next dispatch
        await asyncio.sleep(0)
        return pending.occupied

    async def run(self):
        """Serve until :meth:`close` (then drain).  Exactly one runner
        at a time; submit/cancel freely from other coroutines on the
        same loop."""
        if self._running:
            raise RuntimeError("ServingFrontend.run() is already active")
        self._running = True
        try:
            while True:
                await self.step()
                if self._engine_idle():
                    # lifecycle ops may still be queued (cancel/timeout
                    # of queued-but-never-admitted handles)
                    self._apply_lifecycle(self.clock())
                    if self._closed and not self._live:
                        return
                    await self._sleep_until_work()
        finally:
            self._running = False

    # ----------------------------------------------------- introspection --

    def describe(self) -> dict:
        """Structured front-end signature + live metrics: admission
        bound and in-flight count, terminal-state counts, per-step
        occupancy / queue-depth aggregates, and the latency section
        (p50/p99 TTFT, inter-token gap, queue wait)."""
        occ = np.asarray(self._occupancy or [0])
        qd = np.asarray(self._queue_depth or [0])
        return {
            "max_pending": self.max_pending,
            "pending": len(self._live),
            "submitted": self._submitted,
            "accepted": self._submitted - self._counts["rejected"],
            "terminal": dict(self._counts),
            "steps": self._steps,
            "tokens": self._total_tokens,
            "occupancy": {"mean": float(occ.mean()),
                          "max": int(occ.max())},
            "queue_depth": {"mean": float(qd.mean()),
                            "max": int(qd.max())},
            "latency": {
                "ttft_s": _pct(self._ttfts),
                "inter_token_s": _pct(self._itls),
                "queue_wait_s": _pct(self._queue_waits),
            },
        }
