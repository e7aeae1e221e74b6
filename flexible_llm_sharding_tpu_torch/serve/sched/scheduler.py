"""The sweep scheduler (the JAX package's ``serve/sched/scheduler.py``):
class priority, tenant fairness, rate limits and the sweep-boundary
preemption decision.

With a scheduler attached, ``AdmissionQueue.pop_wave`` picks through
:meth:`SweepScheduler.select` instead of first in, first out:

- **Strict priority across SLO classes**: at every shard-0 boundary the
  highest class with queued work takes the whole admission budget, so a
  deep best-effort backlog never delays interactive TTFT.
- **Deficit round robin across tenants within a class** (Shreedhar and
  Varghese, 1995, with request-count quanta): each visit credits a tenant
  its weight and pops ``floor(deficit)`` requests; a tenant whose queue
  empties forfeits its credit. A tenant of weight w gets about w shares of
  the budget while it has work queued.
- **Per-tenant token buckets** at submit: an over-limit submit resolves as
  ``RateLimited`` with ``retry_after_s``; a submit refused downstream of
  the gate gets its token back (:meth:`SweepScheduler.refund`).
- **Preemption** (:meth:`SweepScheduler.pick_preempt`): an interactive
  request waiting while every active-request slot is held and a purely
  best-effort wave is in flight names the youngest such wave; the engine
  retires it at the shard-0 boundary and requeues its requests, which
  resume token for token. This object decides and counts only.

A replica fleet shares one scheduler across its engines, so tenant rate
limits and fairness are fleet-wide; its re-dispatches (``shed_exempt``)
pass the rate gate. The JAX scheduler's trace instants are not ported (the
port has no tracer yet).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

from flexible_llm_sharding_tpu_torch.obs import trace as obs_trace

from flexible_llm_sharding_tpu_torch.serve.sched.classes import (
    BEST_EFFORT,
    CLASS_RANK,
    INTERACTIVE,
    RateLimited,
)

# Cap on per-tenant state (buckets and the served/rate_limited tables): the
# least recently active tenant's state is evicted past it (its bucket comes
# back full: one extra burst), and the evictions are counted.
_MAX_TENANT_STATE = 4096


class _TokenBucket:
    """Requests-per-second token bucket of capacity ``burst`` (at least 1).
    Callers hold the scheduler's lock; time is monotonic."""

    def __init__(self, rate: float, burst: float):
        self.rate = rate
        self.capacity = max(burst, 1.0)
        self.tokens = self.capacity
        self.last = time.monotonic()

    def try_take(self, now: float) -> float | None:
        """None when a token was taken, else the seconds until the bucket
        next holds a whole one. The refill clamps at 0: a ``now`` read just
        before the bucket was made must not debit time."""
        self.tokens = min(self.capacity, self.tokens + max(now - self.last, 0.0) * self.rate)
        self.last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return None
        return (1.0 - self.tokens) / self.rate


class SweepScheduler:
    """The scheduling policy and its counters for one engine; thread-safe
    (submitters call :meth:`admit_check`, the engine thread :meth:`select`
    and :meth:`pick_preempt`, any thread :meth:`stats`)."""

    def __init__(self, cfg):
        self.cfg = cfg  # config.SchedConfig
        self._weights = cfg.tenant_weight_map()
        self._limits = cfg.tenant_limit_map()
        self._lock = threading.Lock()
        self._buckets: OrderedDict[str, _TokenBucket] = OrderedDict()  # guarded by: _lock
        self._tenants: OrderedDict[str, dict[str, int]] = OrderedDict()  # guarded by: _lock
        # Round-robin state: each class's last visited tenant (rotation
        # continuity) and the (class, tenant) deficits, pruned to the queued
        # tenants at every select.
        self._last_visited: dict[str, str] = {}  # guarded by: _lock
        self._deficit: dict[tuple[str, str], float] = {}  # guarded by: _lock
        self.preemptions = 0
        self.preempted_requests = 0
        self.rate_limited = 0
        self.coalesced_requests = 0
        self.prefill_kv_bytes_saved = 0
        self.tenants_evicted = 0

    # -- submit side (any thread) ------------------------------------------

    def admit_check(self, request) -> RateLimited | None:
        """The rate gate ``AdmissionQueue.submit`` calls first: the
        rejection to resolve the request with, or None to admit. A fleet
        re-dispatch (``shed_exempt``) always passes: it was admitted once."""
        if request.shed_exempt:
            return None
        rate = self._limits.get(request.tenant_id)
        if rate is None:
            return None
        now = time.monotonic()
        with self._lock:
            bucket = self._buckets.get(request.tenant_id)
            if bucket is None:
                if len(self._buckets) >= _MAX_TENANT_STATE:
                    self._buckets.popitem(last=False)
                bucket = _TokenBucket(rate, self.cfg.tenant_burst)
                self._buckets[request.tenant_id] = bucket
            else:
                self._buckets.move_to_end(request.tenant_id)
            retry = bucket.try_take(now)
            if retry is None:
                return None
            self.rate_limited += 1
            self._tenant_locked(request.tenant_id)["rate_limited"] += 1
        obs_trace.instant("tenant_throttle", cat="sched", tenant=request.tenant_id,
                          request_id=request.request_id, retry_after_s=round(retry, 4))
        return RateLimited(
            f"tenant {request.tenant_id!r} over its rate limit ({rate:g} req/s, burst "
            f"{self.cfg.tenant_burst:g}); retry after ~{retry:.2f}s",
            retry_after_s=retry, tenant=request.tenant_id,
        )

    def refund(self, request) -> None:
        """Give back the token :meth:`admit_check` took from a submit that
        was refused downstream (size cap, capacity, closed queue), so a
        tenant's backpressure retries do not spend its rate budget. A no-op
        for unlimited tenants and for re-dispatches (neither took one)."""
        if request.shed_exempt or request.tenant_id not in self._limits:
            return
        with self._lock:
            bucket = self._buckets.get(request.tenant_id)
            if bucket is not None:
                bucket.tokens = min(bucket.capacity, bucket.tokens + 1.0)

    # -- pop side (engine thread, under the queue's lock) -------------------

    def select(self, items, budget: int) -> list:
        """Up to ``budget`` requests out of ``items`` (the queue's deque,
        locked by the caller; the picked ones are removed in place). Strict
        priority across classes and the round robin over the winning class's
        tenants, so one boundary's wave holds one class. Pure computation."""
        if budget <= 0 or not items:
            return []
        with self._lock:
            best = min((r.slo_class for r in items),
                       key=lambda c: CLASS_RANK.get(c, CLASS_RANK["standard"]))
            by_tenant: dict[str, list] = {}
            for r in items:
                if r.slo_class == best:
                    by_tenant.setdefault(r.tenant_id, []).append(r)
            # Visit the queued tenants in arrival order, rotated to start
            # after the one this class's last boundary visited last; credit
            # of tenants with nothing queued drops.
            order = list(by_tenant)
            last = self._last_visited.get(best)
            if last in by_tenant:
                i = order.index(last) + 1
                order = order[i:] + order[:i]
            for key in [k for k in self._deficit if k[0] == best and k[1] not in by_tenant]:
                del self._deficit[key]
            picked: list = []
            pos = 0
            # Each visit credits at least the 0.01 weight floor, so a whole
            # token accrues within 100 visits; the bound is a backstop.
            for _ in range(max(1, (budget + len(order)) * 128)):
                if len(picked) >= budget or not any(by_tenant.values()):
                    break
                tenant = order[pos % len(order)]
                pos += 1
                self._last_visited[best] = tenant
                q = by_tenant[tenant]
                if not q:
                    # An emptied tenant forfeits its credit: idle time must
                    # not bank a burst.
                    self._deficit.pop((best, tenant), None)
                    continue
                credit = self._deficit.get((best, tenant), 0.0) + self._weights.get(tenant, 1.0)
                take = min(int(credit), len(q), budget - len(picked))
                if take:
                    picked.extend(q[:take])
                    del q[:take]
                self._deficit[(best, tenant)] = credit - take
            for r in picked:
                self._tenant_locked(r.tenant_id)["served"] += 1
        if picked:
            chosen = {id(r) for r in picked}
            remaining = [r for r in items if id(r) not in chosen]
            items.clear()
            items.extend(remaining)
        return picked

    # -- preemption (engine thread, at a shard-0 boundary) ------------------

    def pick_preempt(self, waves, queue, free_slots: int):
        """The wave to retire at this boundary, or None: only when
        preemption is on, no active-request slot is free, an interactive
        request waits and a purely best-effort wave is in flight (the
        youngest, highest ``wave_id``). One wave per boundary at most."""
        if not self.cfg.preempt or free_slots > 0:
            return None
        if not queue.has_waiting(INTERACTIVE):
            return None
        victims = [w for w in waves if w.slo_class == BEST_EFFORT]
        if not victims:
            return None
        return max(victims, key=lambda w: w.wave_id)

    def note_preempted(self, n_requests: int) -> None:
        with self._lock:
            self.preemptions += 1
            self.preempted_requests += n_requests

    def note_coalesced(self, n_requests: int, kv_bytes_saved: float) -> None:
        """One shared-prefix entry of ``n_requests`` requests formed;
        ``kv_bytes_saved`` is the prefix KV the other n - 1 prefills would
        have made."""
        with self._lock:
            self.coalesced_requests += n_requests
            self.prefill_kv_bytes_saved += int(kv_bytes_saved)

    # -- export --------------------------------------------------------------

    def _tenant_locked(self, tenant: str) -> dict[str, int]:
        tc = self._tenants.get(tenant)
        if tc is None:
            if len(self._tenants) >= _MAX_TENANT_STATE:
                self._tenants.popitem(last=False)
                self.tenants_evicted += 1
            tc = {"served": 0, "rate_limited": 0}
            self._tenants[tenant] = tc
        else:
            self._tenants.move_to_end(tenant)
        return tc

    def stats(self) -> dict:
        """The engine's ``sched`` stats source: the counters and the
        per-tenant served/rate_limited tables of the most recently active
        tenants."""
        with self._lock:
            return {
                "preemptions": self.preemptions,
                "preempted_requests": self.preempted_requests,
                "rate_limited": self.rate_limited,
                "coalesced_requests": self.coalesced_requests,
                "prefill_kv_bytes_saved": self.prefill_kv_bytes_saved,
                "tenants_evicted": self.tenants_evicted,
                "tenants": {t: dict(c) for t, c in sorted(self._tenants.items())},
            }


__all__ = ["SweepScheduler"]
