"""Shard-aware continuous batching: waves admitted at shard-0 boundaries
(the JAX package's ``serve/batcher.py``).

Iteration-level scheduling (Orca, OSDI '22) admits new requests between
decode iterations. Here the iteration boundary is the shard-0 boundary of
the weight sweep: every decode step walks (or streams) the model's shards
in order, and just before the sweep re-enters shard 0 no activation is in
flight anywhere. A wave admitted there runs its prefill on the same sweep
whose shards serve the earlier waves' decode steps, so a join never
prefills an in-flight request again, and a late request waits at most one
sweep for its first token.

The batcher owns wave formation and the active-request budget; the engine
calls :meth:`ShardAwareBatcher.admit_at_boundary` at each shard-0 boundary
and drives the waves it tracks.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any

from flexible_llm_sharding_tpu_torch.runtime.schedcore import SchedCore
from flexible_llm_sharding_tpu_torch.serve.queue import AdmissionQueue
from flexible_llm_sharding_tpu_torch.serve.request import Request, RequestStatus

_WAVE_IDS = itertools.count()


# Strict SLO-class priority order, mirrored from serve/sched/classes.py
# (the base batcher does not import the scheduler's package).
_CLASS_RANK = {"interactive": 0, "standard": 1, "best_effort": 2}


@dataclass
class WaveEntry:
    """One prefill unit of a wave: one request's (prefix, suffixes) prompt,
    or a prefix-coalesced group's (``serve/sched/coalesce.py``), whose
    ``suffixes`` are the members' in order. ``slices`` holds each member's
    (suffix offset, count)."""

    requests: list[Request]
    prefix: str
    suffixes: tuple[str, ...]
    slices: list[tuple[int, int]]


@dataclass
class Wave:
    """Requests admitted together at a shard-0 boundary. Its first sweep
    runs the prefill (the KV and the first token); every later sweep one
    decode step. The engine owns ``state``; the batcher owns membership
    and retirement."""

    requests: list[Request]
    wave_id: int = field(default_factory=lambda: next(_WAVE_IDS))
    # Sweeps this wave has run (1 after prefill): each suffix's token count
    # and the decode slot clock.
    steps: int = 0
    state: Any = None
    entries: list[WaveEntry] | None = None

    def ensure_entries(self) -> list[WaveEntry]:
        if self.entries is None:
            self.entries = [
                WaveEntry(requests=[r], prefix=r.prefix, suffixes=r.suffixes,
                          slices=[(0, len(r.suffixes))])
                for r in self.requests
            ]
        return self.entries

    def locate(self, r: Request) -> tuple[int, int, int]:
        """(entry index, suffix offset, suffix count) of one member."""
        for e_idx, e in enumerate(self.ensure_entries()):
            for (off, cnt), member in zip(e.slices, e.requests):
                if member is r:
                    return e_idx, off, cnt
        raise ValueError(f"request {r.request_id} is not in wave {self.wave_id}")

    @property
    def max_steps(self) -> int:
        """The budget left: a resumed request's served tokens ride in its
        extended suffixes."""
        return max(r.max_new_tokens - r.resume_len for r in self.requests)

    @property
    def slo_class(self) -> str:
        """The best class among the members: a wave holding one interactive
        request is never a best-effort preemption victim."""
        return min((r.slo_class for r in self.requests),
                   key=lambda c: _CLASS_RANK.get(c, _CLASS_RANK["standard"]))

    @property
    def done(self) -> bool:
        return all(r.status.terminal for r in self.requests)


class ShardAwareBatcher:
    def __init__(self, queue: AdmissionQueue, max_wave_requests: int, max_active_requests: int,
                 metrics=None, sched_core: SchedCore | None = None, entry_builder=None):
        """``entry_builder(requests) -> [WaveEntry]``: the prefix-coalescing
        hook (None: one entry per request)."""
        self.queue = queue
        self.max_wave_requests = max_wave_requests
        self.max_active_requests = max_active_requests
        self._metrics = metrics
        self._sched_core = sched_core or SchedCore(None)
        self._entry_builder = entry_builder
        self.waves: list[Wave] = []

    @property
    def active_requests(self) -> int:
        return sum(1 for w in self.waves for r in w.requests if not r.status.terminal)

    def admit_at_boundary(self) -> Wave | None:
        """Form at most one new wave from the queue, within the
        active-request budget; returns it (already tracked) or None."""
        budget = self._sched_core.admission_quota(self.max_active_requests, self.active_requests)
        if budget <= 0:
            # No admission, but a saturated active set must not stall
            # deadline eviction: a zero-size pop still evicts.
            self.queue.pop_wave(0)
            return None
        reqs = self.queue.pop_wave(min(self.max_wave_requests, budget))
        if not reqs:
            return None
        now = time.monotonic()
        for r in reqs:
            r.status = RequestStatus.ACTIVE
            r.admitted_at = now
        entries = self._entry_builder(reqs) if self._entry_builder is not None else None
        wave = Wave(requests=reqs, entries=entries)
        self.waves.append(wave)
        if self._metrics is not None:
            self._metrics.count("admitted", len(reqs))
            self._update_gauges()
        return wave

    def retire_done(self) -> list[Wave]:
        """Drop the waves whose every request is terminal; returns them
        (the engine releases their KV)."""
        done = [w for w in self.waves if w.done]
        if done:
            self.waves = [w for w in self.waves if not w.done]
        if self._metrics is not None:
            self._update_gauges()
        return done

    def fail_all_active(self, error: BaseException) -> None:
        """Every in-flight request fails with ``error``; all waves drop."""
        for w in self.waves:
            for r in w.requests:
                if not r.status.terminal and r.fail(error, RequestStatus.FAILED):
                    if self._metrics is not None:
                        self._metrics.count("failed")
        self.waves = []
        if self._metrics is not None:
            self._update_gauges()

    def _update_gauges(self) -> None:
        self._metrics.gauge("active_requests", self.active_requests)
        self._metrics.gauge("active_waves", len(self.waves))


__all__ = ["ShardAwareBatcher", "Wave", "WaveEntry"]
