"""Thread-safe admission queue (the JAX package's ``serve/queue.py``).

Submitters on any thread push requests; the engine pops waves at shard-0
boundaries, first in, first out, or through an attached sweep scheduler
(``serve/sched/scheduler.py``). The contracts:

- **Backpressure**: a submit to a full queue resolves the request as
  ``QueueFull`` naming the capacity and depth, never a silent drop.
- **Size cap**: with ``max_request_tokens`` set, a request whose estimated
  prompt tokens and budget exceed it resolves as ``RequestTooLarge``,
  before it takes a slot.
- **Deadline eviction**: a request whose admission deadline passes while it
  waits resolves as EXPIRED (``DeadlineExceeded``), lazily at the next
  submit or pop (no timer thread). Expired waiters free their slots before
  the capacity check.
- **Scheduling**: with a scheduler, ``pop_wave`` picks by SLO class and
  tenant, ``submit`` first applies the tenant's rate limit (``RateLimited``)
  and gives the token back when a later check refuses the request, and
  ``requeue``/``has_waiting`` carry the preemption protocol.
- **Write-ahead**: with a request WAL (``serve/wal.py``), a submit that
  passed the rate and size checks writes its admission record before it
  can join the queue; a later refusal (capacity, closed) terminates the id
  through the request's terminal hook, so the WAL never replays a request
  its client was told was refused.
- **Shutdown**: ``close(drain=True)`` refuses new submits and leaves the
  queued requests for the engine; ``drain=False`` cancels them
  (``ServeClosed``), or, with ``persist=True`` and a WAL (a graceful
  restart), parks them as ``RestartPending``, open in the WAL for the next
  start's replay. Either way a request already past its deadline resolves
  as EXPIRED.

Terminal transitions run outside the lock: callbacks may be slow.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from flexible_llm_sharding_tpu_torch.serve.request import (
    DeadlineExceeded,
    QueueFull,
    Request,
    RequestStatus,
    RequestTooLarge,
    RestartPending,
    ServeClosed,
)


class AdmissionQueue:
    def __init__(self, capacity: int, metrics=None, max_request_tokens: int = 0, size_fn=None,
                 scheduler=None, wal=None):
        """``metrics``: a ``ServingMetrics`` or None. ``size_fn(request)``
        estimates a request's prompt tokens plus budget for the
        ``max_request_tokens`` cap (0 = off). ``scheduler``: a
        ``SweepScheduler`` or None (first in, first out). ``wal``: a
        ``RequestWAL`` or None."""
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._metrics = metrics
        self._max_request_tokens = max_request_tokens
        self._size_fn = size_fn
        self._scheduler = scheduler
        self._wal = wal
        self._lock = threading.Lock()
        self._items: deque[Request] = deque()  # guarded by: _lock
        self._closed = False  # guarded by: _lock

    def _reject(self, request: Request, error: BaseException, status: RequestStatus) -> Request:
        request.fail(error, status)
        if self._metrics is not None:
            self._metrics.count("rejected" if status is RequestStatus.REJECTED else "cancelled")
        return request

    def submit(self, request: Request) -> Request:
        """Enqueue, or resolve the request as a typed rejection
        (RequestTooLarge over the size cap, QueueFull at capacity,
        ServeClosed after shutdown; RateLimited first, with a
        scheduler)."""
        if self._scheduler is not None:
            limited = self._scheduler.admit_check(request)
            if limited is not None:
                return self._reject(request, limited, RequestStatus.REJECTED)
        if self._max_request_tokens > 0 and self._size_fn is not None:
            # Before the capacity check, outside the lock (it tokenizes).
            try:
                est = self._size_fn(request)
            except Exception:  # a tokenizer edge case: the wave's typed rejection still applies
                est = None
            if est is not None and est > self._max_request_tokens:
                self._refund_rate_token(request)
                return self._reject(request, RequestTooLarge(
                    f"request {request.request_id}: ~{est} tokens (prompt + max_new_tokens) "
                    f"exceeds the admission cap of {self._max_request_tokens}; split the prompt "
                    "or lower max_new_tokens"), RequestStatus.REJECTED)
        if self._wal is not None:
            self._wal.admit(request)
        evicted: list[Request] = []
        reject = None
        with self._lock:
            if self._closed:
                reject = (ServeClosed("serve queue is closed"), RequestStatus.CANCELLED)
            else:
                evicted = self._evict_expired_locked()
                if len(self._items) >= self.capacity:
                    reject = (QueueFull(
                        f"admission queue full (capacity {self.capacity}, depth "
                        f"{len(self._items)}); retry with backoff or raise queue_capacity"),
                        RequestStatus.REJECTED)
                else:
                    self._items.append(request)
                    depth = len(self._items)
        self._finish_expired(evicted)
        if reject is not None:
            self._refund_rate_token(request)
            return self._reject(request, *reject)
        if self._metrics is not None:
            self._metrics.gauge("queue_depth", depth)
        return request

    def _refund_rate_token(self, request: Request) -> None:
        """A submit the rate gate passed but a later check refused gets its
        token back."""
        if self._scheduler is not None:
            self._scheduler.refund(request)

    def pop_wave(self, max_requests: int) -> list[Request]:
        """Up to ``max_requests`` live requests, in arrival order or by the
        scheduler's pick (pure computation, under the lock); expired ones
        met on the way are evicted."""
        with self._lock:
            evicted = self._evict_expired_locked()
            if self._scheduler is not None:
                out = self._scheduler.select(self._items, max_requests)
            else:
                out = []
                while self._items and len(out) < max_requests:
                    out.append(self._items.popleft())
            depth = len(self._items)
        self._finish_expired(evicted)
        if self._metrics is not None:
            self._metrics.gauge("queue_depth", depth)
        return out

    def requeue(self, requests: list[Request]) -> None:
        """Put preempted requests back at the front, in order, with no
        capacity check (they held active slots a moment ago), also while
        closed for a drain (the drain serves them out)."""
        if not requests:
            return
        with self._lock:
            self._items.extendleft(reversed(requests))
            depth = len(self._items)
        if self._metrics is not None:
            self._metrics.gauge("queue_depth", depth)

    def has_waiting(self, slo_class: str) -> bool:
        """Whether a live (unexpired) queued request carries ``slo_class``:
        the preemption trigger, so a request about to expire never costs a
        best-effort wave its progress."""
        now = time.monotonic()
        with self._lock:
            return any(r.slo_class == slo_class and not r.expired(now) for r in self._items)

    def _evict_expired_locked(self) -> list[Request]:
        now = time.monotonic()
        live: deque[Request] = deque()
        evicted: list[Request] = []
        while self._items:
            r = self._items.popleft()
            (evicted if r.expired(now) else live).append(r)
        self._items = live
        return evicted

    def _finish_expired(self, evicted: list[Request]) -> None:
        for r in evicted:
            waited = time.monotonic() - r.arrival
            won = r.fail(DeadlineExceeded(
                f"request {r.request_id} waited {waited:.3f}s in the admission queue, past its "
                "deadline"), RequestStatus.EXPIRED)
            if won and self._metrics is not None:
                self._metrics.count("expired")

    def reclaim(self) -> list[Request]:
        """Close the queue and hand back everything queued, unresolved: the
        caller owns their terminal transition. Requests past their deadline
        resolve as EXPIRED here."""
        with self._lock:
            self._closed = True
            evicted = self._evict_expired_locked()
            items = list(self._items)
            self._items.clear()
        self._finish_expired(evicted)
        if self._metrics is not None:
            self._metrics.gauge("queue_depth", 0)
        return items

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def close(self, drain: bool = True, persist: bool = False) -> list[Request]:
        """Refuse further submits; ``drain=False`` also cancels the queued
        requests (as ``RestartPending`` with ``persist`` and a WAL). Returns
        the cancelled ones. Idempotent."""
        with self._lock:
            self._closed = True
            evicted = self._evict_expired_locked()
            cancelled = [] if drain else list(self._items)
            if not drain:
                self._items.clear()
        self._finish_expired(evicted)
        park = persist and self._wal is not None
        for r in cancelled:
            won = r.fail(RestartPending("serve process restarting; request journaled for replay")
                         if park else ServeClosed("serve queue shut down before admission"),
                         RequestStatus.CANCELLED)
            if won and self._metrics is not None:
                self._metrics.count("cancelled")
        if self._metrics is not None:
            self._metrics.gauge("queue_depth", len(self))
        return cancelled


__all__ = ["AdmissionQueue"]
