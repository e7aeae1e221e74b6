"""Sweep-timeline span tracer: a thread-safe bounded ring of timed spans
(the JAX package's ``obs/trace.py``).

The questions that matter for a layer-streaming runtime are timeline
questions: is compute hidden under the host->device stream, where does a
sweep's wall time go, when did a wave join and when did its first token
land. The executor's producer and consumer, the host shard cache, the
residency tier, the retry and heal layer and the serve wave lifecycle emit
spans here, correlated by ``sweep_id`` / ``shard_idx`` / ``wave_id`` /
``request_id`` / ``replica``.

A span measures host time. On a card, ``compute`` closes after the
executor's device synchronization (where ``compute_wall_s`` is measured)
and ``device_put`` covers the enqueue of the upload on its stream, not the
copy: no span synchronizes the device for the tracer's sake. A span or
instant inside a region captured into a CUDA graph would run at capture
only, so every emit stays outside captured regions.

1. **Zero-cost when disabled.** Every emit reads one bool and returns a
   shared no-op: no allocation, no lock, no timestamp.
2. **Bounded.** Spans land in a ring of ``capacity`` records; overflow
   drops the oldest and counts them (``trace_drops``).
3. **Machine-readable.** ``write()`` exports Chrome trace-event JSON
   (Perfetto-loadable) or JSONL (one span per line), by file extension.

The process-wide singleton is ``TRACER``; the CLIs enable it from
``--trace`` via ``ensure_configured(cfg)`` and export it with
``write_configured()``. Library users call ``TRACER.enable()``.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque

# Correlation-id wells. A sweep id is unique per process (offline: one
# executor call's full pass over the shards; serving: one engine sweep),
# so spans from interleaved subsystems stitch back into one timeline.
_SWEEP_IDS = itertools.count(1)


def new_sweep_id() -> int:
    return next(_SWEEP_IDS)


class _NullSpan:
    """Shared no-op context manager returned by every emit while tracing
    is disabled — the whole disabled-path cost is one attribute read and
    one bool test in ``span()``."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live timed span; records itself into the tracer ring on exit."""

    __slots__ = ("_tracer", "name", "cat", "attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        self._tracer._append(
            (self.name, self.cat, self._t0, t1 - self._t0,
             threading.get_ident(), self.attrs)
        )
        return False


class Tracer:
    """Thread-safe bounded-ring span recorder (see module docstring).

    Records are ``(name, cat, t_start_perf, dur_s | None, tid, attrs)``
    tuples; ``dur_s is None`` marks an instant event. Timestamps are
    ``time.perf_counter()`` values; ``epoch_offset`` maps them back to
    wall-clock for the exports.
    """

    DEFAULT_CAPACITY = 200_000

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self.capacity = int(capacity)
        self._ring: deque = deque()  # guarded by: _lock
        self.drops = 0  # oldest spans dropped on ring overflow  # guarded by: _lock
        self.enabled = False
        self.default_out: str = ""
        # perf_counter -> wall-clock epoch mapping, captured once so every
        # exported timestamp shares one base.
        self._perf0 = time.perf_counter()
        self._epoch0 = time.time()

    # -- recording ---------------------------------------------------------

    def _append(self, rec: tuple) -> None:
        with self._lock:
            if len(self._ring) >= self.capacity:
                self._ring.popleft()
                self.drops += 1
            self._ring.append(rec)

    def span(self, name: str, cat: str = "runtime", **attrs):
        """Timed span context manager; no-op (shared object) when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, attrs)

    def instant(self, name: str, cat: str = "runtime", **attrs) -> None:
        """Zero-duration structured event (heals, stalls, wave admits)."""
        if not self.enabled:
            return
        self._append(
            (name, cat, time.perf_counter(), None, threading.get_ident(),
             attrs)
        )

    def complete(
        self, name: str, cat: str, t0_perf: float, dur_s: float, **attrs
    ) -> None:
        """Record an already-measured span (perf_counter start + duration)
        — for call sites that only know AFTER the fact whether the timed
        region should appear in the trace (e.g. a source wait that turned
        out to belong to a resume-skipped shard)."""
        if not self.enabled:
            return
        self._append(
            (name, cat, t0_perf, dur_s, threading.get_ident(), attrs)
        )

    # -- lifecycle ---------------------------------------------------------

    def enable(self, capacity: int | None = None) -> "Tracer":
        with self._lock:
            if capacity is not None:
                self.capacity = int(capacity)
            self.enabled = True
        # The tracer's own counters are registry citizens like every other
        # subsystem's (lazy import: registry must stay importable first).
        from flexible_llm_sharding_tpu_torch.obs.registry import REGISTRY

        REGISTRY.register("trace", self.stats)
        return self

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.drops = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- observability -----------------------------------------------------

    def stats(self) -> dict[str, float]:
        with self._lock:
            out = {
                "trace_enabled": int(self.enabled),
                "trace_spans": len(self._ring),
                "trace_drops": self.drops,
            }
            if self.enabled:
                # Capacity only while recording: an all-zero snapshot keeps
                # the serve stats line free of a dead "trace" block.
                out["trace_capacity"] = self.capacity
            return out

    def snapshot(self) -> list[dict]:
        """The ring as a list of span dicts (oldest first), timestamps in
        epoch seconds. ``dur_s`` absent marks an instant event."""
        with self._lock:
            ring = list(self._ring)
            epoch0, perf0 = self._epoch0, self._perf0
        out = []
        for name, cat, t0, dur, tid, attrs in ring:
            d = {
                "name": name,
                "cat": cat,
                "ts_s": round(epoch0 + (t0 - perf0), 6),
                "tid": tid,
            }
            if dur is not None:
                d["dur_s"] = round(dur, 6)
            if attrs:
                d.update(attrs)
            out.append(d)
        return out

    # -- exports -----------------------------------------------------------

    def chrome_events(self) -> list[dict]:
        """Chrome trace-event list (Perfetto-loadable): complete ("X")
        events for spans, instant ("i") events for point events, plus one
        metadata record carrying the drop count."""
        with self._lock:
            ring = list(self._ring)
            perf0 = self._perf0
            drops = self.drops
        pid = os.getpid()
        events: list[dict] = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": "flexible-llm-sharding-tpu-torch"},
            },
            {
                "name": "trace_meta",
                "ph": "i",
                "s": "g",
                "ts": 0,
                "pid": pid,
                "tid": 0,
                "args": {"trace_drops": drops},
            },
        ]
        for name, cat, t0, dur, tid, attrs in ring:
            ev = {
                "name": name,
                "cat": cat,
                "ts": round((t0 - perf0) * 1e6, 1),  # microseconds
                "pid": pid,
                "tid": tid,
                "args": attrs or {},
            }
            if dur is None:
                ev["ph"] = "i"
                ev["s"] = "t"
            else:
                ev["ph"] = "X"
                ev["dur"] = round(dur * 1e6, 1)
            events.append(ev)
        return events

    def write(self, path: str) -> str:
        """Export the ring: ``*.jsonl`` -> one span dict per line plus a
        trailing ``trace_meta`` record carrying the ring drop count (the
        Chrome export embeds the same record), so an overflowed —
        truncated — timeline is detectable in either format; anything
        else -> Chrome trace-event JSON."""
        if path.endswith(".jsonl"):
            spans = self.snapshot()
            with self._lock:
                drops = self.drops
            meta = {
                "name": "trace_meta",
                "cat": "meta",
                "ts_s": spans[0]["ts_s"] if spans else round(self._epoch0, 6),
                "trace_drops": drops,
            }
            with open(path, "w") as f:
                for s in spans:
                    f.write(json.dumps(s) + "\n")
                f.write(json.dumps(meta) + "\n")
        else:
            payload = {
                "traceEvents": self.chrome_events(),
                "displayTimeUnit": "ms",
            }
            with open(path, "w") as f:
                json.dump(payload, f)
        return path


TRACER = Tracer()


def span(name: str, cat: str = "runtime", **attrs):
    """Module-level emit against the process tracer (the hot-path form)."""
    if not TRACER.enabled:
        return _NULL_SPAN
    return _Span(TRACER, name, cat, attrs)


def instant(name: str, cat: str = "runtime", **attrs) -> None:
    if TRACER.enabled:
        TRACER.instant(name, cat, **attrs)


def enabled() -> bool:
    return TRACER.enabled


def ensure_configured(cfg) -> None:
    """Enable the process tracer when the config asks for it
    (``cfg.trace``); never disables — tracing is process-scoped and a
    second executor with trace off must not cut a live recording short.
    Remembers ``cfg.trace_out`` as the default export path."""
    if getattr(cfg, "trace", False):
        out = getattr(cfg, "trace_out", "") or ""
        if out:
            TRACER.default_out = out
        if not TRACER.enabled:
            TRACER.enable()


def write_configured(default: str = "fls_trace.json") -> str | None:
    """Export the process tracer to its configured path (or ``default``);
    None when tracing never enabled. The CLIs call this at run end."""
    if not TRACER.enabled and not len(TRACER):
        return None
    return TRACER.write(TRACER.default_out or default)


__all__ = [
    "TRACER",
    "Tracer",
    "enabled",
    "ensure_configured",
    "instant",
    "new_sweep_id",
    "span",
    "write_configured",
]
