"""The flight recorder's durable event journal (the JAX package's
``obs/events.py``).

The trace ring and the metrics registry answer live questions, but both
die with the process (or the ring has already evicted the window). This
is the durable third leg: a process-wide, thread-safe, append-only JSONL
journal that every failure-path site writes through: engine recoveries and
wave aborts, replica death, drain and re-dispatch, quarantines and re-read
heals, pressure ladder steps and hard resource events, watchdog stalls,
preemptions, SLO budget exhaustion. Each event carries a monotonic
``seq``, a wall-clock ``ts``, its ``kind`` and ``severity``, and the
tracer's correlation ids (``sweep_id`` / ``wave_id`` / ``request_id`` /
``replica``).

1. **Zero-cost when disabled.** ``emit()`` reads one bool and returns.
2. **Never an engine error.** A write failure (ENOSPC, an unwritable
   directory, an injected ``disk_full`` fault) is a counted drop
   (``events_dropped``, scraped as ``fls_journal_events_dropped``), never
   an exception into the failure path being recorded.
3. **Bounded.** The file rotates atomically (``os.replace`` to
   ``journal.jsonl.1``) past its byte budget; one previous generation is
   kept. A bounded in-memory ring of the newest events backs the incident
   recorder's tail even while disk writes fail.
4. **One vocabulary.** Every ``kind`` emitted is declared in
   :data:`EVENT_KINDS` with its severity; an unknown kind is a drop.

The process-wide singleton is :data:`JOURNAL`; the CLIs and engines enable
it from ``FrameworkConfig.journal_dir`` / ``incidents_dir`` via
:func:`ensure_configured`. Its health and the incident recorder's bundle
counters are the ``journal`` registry source.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

# The central kinds table: kind -> severity (the JAX package's, kind for
# kind). Severities order info < warning < error < critical; the incident
# recorder triggers at FrameworkConfig.incident_trigger and above.
EVENT_KINDS = {
    # serving engine (serve/engine.py)
    "engine_recovery": "error",      # degrade-don't-die: source restarted
    "engine_fatal": "critical",      # the loop died; every future failed
    "wave_abort": "error",           # one in-flight wave failed mid-sweep
    "wave_reject": "warning",        # a wave failed at tokenization/init
    "watchdog_stall": "error",       # sweep made no progress; source aborted
    "wave_preempt": "info",          # scheduler retired a best-effort wave
    "adapter_reject": "warning",     # unknown/corrupt LoRA adapter: that
                                     # tenant's requests failed typed at
                                     # wave assembly (base unaffected)
    # replica fleet (serve/fleet.py)
    "replica_dead": "critical",      # hard-fail: engine-fatal or stalled
    "replica_drain": "warning",      # graceful drain started
    "replica_recycled": "info",      # fresh engine seated in the slot
    "redispatch": "warning",         # orphan re-dispatched to a survivor
    # integrity (runtime/executor.py, runtime/activations.py)
    "reread_heal": "warning",        # checksum mismatch healed by re-read
    "quarantine": "critical",        # on-disk corruption; path quarantined
    "spill_recompute": "warning",    # spill corrupt; block recomputed
    # resource pressure (runtime/pressure.py)
    "pressure_step": "warning",      # brownout ladder moved up or down
    "pressure_event": "error",       # hard resource event (OOM / ENOSPC)
    # SLO error budgets (obs/slo.py)
    "slo_budget_exhausted": "error",  # a class burned its error budget
    # adaptive speculation controller (serve/spec.py)
    "spec_k_raise": "info",          # windowed acceptance earned a class +1 k
    "spec_k_backoff": "info",        # k shrank: low acceptance or pressure
    # fleet autoscaler (serve/autoscale.py)
    "autoscale_grow": "info",        # controller added a replica
    "autoscale_shrink": "info",      # controller started a graceful drain
    "autoscale_blocked": "warning",  # a wanted action hit an interlock
    # the incident recorder itself (obs/incident.py)
    "incident_capture": "info",      # a bundle landed on disk
    # crash-safe serving (serve/wal.py, serve/recovery.py, serve/engine.py)
    "wal_torn_tail": "warning",      # partial tail record truncated at scan
    "wal_replay": "warning",         # warm restart re-admitted open requests
    "shutdown_drain": "info",        # graceful restart drained at boundary
}

# Severity lattice (index = rank). severity_rank("critical") == 3.
SEVERITY_LEVELS = ("info", "warning", "error", "critical")


def severity_rank(severity: str) -> int:
    """Rank of a severity name. Unknown names rank ABOVE 'critical' —
    the fail-safe direction for a TRIGGER THRESHOLD (a typo'd trigger
    captures nothing rather than everything; config validation rejects
    typos on the CLI path anyway). Callers comparing an EVENT's
    severity against a threshold must reject unknown event severities
    explicitly (``severity in SEVERITY_LEVELS``) instead of leaning on
    this rank — the recorder's ``observe`` does."""
    try:
        return SEVERITY_LEVELS.index(severity)
    except ValueError:
        return len(SEVERITY_LEVELS)


JOURNAL_FILE = "journal.jsonl"


class EventJournal:
    """Process-wide append-only JSONL event journal (module docstring).

    ``record()`` serializes one event under the journal lock (seq order
    and rotation atomicity both require it; the write is one short line
    on a rare failure path), appends it to the bounded in-memory ring,
    and — outside the lock — hands it to the attached incident recorder.
    """

    DEFAULT_TAIL_EVENTS = 1024

    def __init__(self, tail_events: int = DEFAULT_TAIL_EVENTS):
        self._lock = threading.Lock()
        self.enabled = False
        self.path = ""  # journal file ("" = ring-only, no durability)
        self._max_bytes = 0
        self._file = None  # guarded by: _lock
        self._bytes_current = 0  # guarded by: _lock
        self._seq = 0  # guarded by: _lock
        self._ring: deque = deque(maxlen=tail_events)  # guarded by: _lock
        self._injector = None  # chaos: fires the disk_full site per write
        self._recorder = None  # obs/incident.py IncidentRecorder
        # Counters, all exported via stats().
        self.events_written = 0  # guarded by: _lock
        self.events_dropped = 0  # guarded by: _lock
        self.rotations = 0  # guarded by: _lock

    # -- lifecycle ---------------------------------------------------------

    def configure(
        self,
        journal_dir: str,
        max_bytes: int = 16_000_000,
        injector=None,
    ) -> "EventJournal":
        """Enable the journal writing ``<journal_dir>/journal.jsonl``.
        Idempotent for the same directory; a second configure with a
        different directory keeps the first (process-singleton
        precedent: first config wins). Registers the ``journal`` source
        in the process metrics registry."""
        with self._lock:
            if self._file is None and journal_dir:
                os.makedirs(journal_dir, exist_ok=True)
                self.path = os.path.join(journal_dir, JOURNAL_FILE)
                self._max_bytes = int(max_bytes)
                try:
                    self._file = open(self.path, "a")
                    self._bytes_current = self._file.tell()
                except OSError:
                    # An unwritable journal dir degrades to ring-only —
                    # pillar 2: never an engine error.
                    self._file = None
                    self.events_dropped += 1
            if injector is not None and self._injector is None:
                self._injector = injector
            self.enabled = True
        # Registry citizenship, the tracer's lazy-import precedent.
        from flexible_llm_sharding_tpu_torch.obs.registry import REGISTRY

        REGISTRY.register("journal", self.stats)
        return self

    def attach_recorder(self, recorder) -> None:
        """Attach the incident recorder (first wins — one recorder per
        process, the controller_for precedent)."""
        with self._lock:
            if self._recorder is None:
                self._recorder = recorder

    @property
    def recorder(self):
        return self._recorder

    def close(self) -> None:
        """Disable and drop state (tests; a real process keeps its
        journal for life). Leaves the file on disk."""
        with self._lock:
            self.enabled = False
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
            self._file = None
            self.path = ""
            self._ring.clear()
            self._seq = 0
            self._bytes_current = 0
            self._injector = None
            self._recorder = None
            self.events_written = 0
            self.events_dropped = 0
            self.rotations = 0
        from flexible_llm_sharding_tpu_torch.obs.registry import REGISTRY

        REGISTRY.unregister("journal")

    # -- recording ---------------------------------------------------------

    def record(self, kind: str, fields: dict) -> None:
        """Append one event. Unknown kinds count as drops (the failure path
        must not raise). Write failures count as drops; the ring still holds
        the event so an incident bundle's tail survives a full disk."""
        severity = EVENT_KINDS.get(kind)
        rec = None
        with self._lock:
            if severity is None:
                self.events_dropped += 1
                return
            self._seq += 1
            ev = {
                "seq": self._seq,
                "ts": round(time.time(), 6),
                "kind": kind,
                "severity": severity,
            }
            for k, v in fields.items():
                ev.setdefault(k, v)
            self._ring.append(ev)
            if self._file is not None:
                try:
                    if self._injector is not None:
                        # Chaos: the journal's own durability is a disk
                        # write like any spill — the existing disk_full
                        # site proves a full disk degrades to counted
                        # drops, never an engine error.
                        self._injector.fire("disk_full", detail=f"journal:{kind}")
                    line = json.dumps(ev, default=str) + "\n"
                    self._file.write(line)
                    self._file.flush()
                    self._bytes_current += len(line)
                    self.events_written += 1
                    if self._bytes_current >= self._max_bytes:
                        self._rotate_locked()
                except OSError:
                    self.events_dropped += 1
            else:
                self.events_dropped += 1
            rec = self._recorder
        if rec is not None:
            # Outside the journal lock: a capture walks the registry and
            # writes files; it must never stall concurrent emits.
            rec.observe(ev)

    def _rotate_locked(self) -> None:
        """Atomic size rotation (caller holds the lock): the live file
        becomes ``journal.jsonl.1`` via ``os.replace`` (atomic on POSIX)
        and a fresh generation opens. One previous generation is kept —
        the tail window an incident needs, bounded at 2x max_bytes."""
        try:
            self._file.close()
            os.replace(self.path, self.path + ".1")
            self._file = open(self.path, "a")
            self._bytes_current = 0
            self.rotations += 1
        except OSError:
            # Rotation failed (e.g. ENOSPC renaming): keep appending to
            # the oversized file rather than losing events.
            self.events_dropped += 1
            if self._file is None or self._file.closed:
                try:
                    self._file = open(self.path, "a")
                except OSError:
                    self._file = None

    # -- reads -------------------------------------------------------------

    def tail(self, n: int | None = None) -> list[dict]:
        """The newest ``n`` events (default: the whole ring), oldest
        first — served from the in-memory ring so it works even while
        disk writes are failing (the incident recorder's tail source)."""
        with self._lock:
            events = list(self._ring)
        return events if n is None else events[-n:]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """The ``journal`` registry source (-> ``fls_journal_*``):
        journal health plus the incident recorder's bundle counters,
        pre-seeded to 0 so "no incidents" is scrapeable."""
        with self._lock:
            out = {
                "enabled": int(self.enabled),
                "seq": self._seq,
                "events_written": self.events_written,
                "events_dropped": self.events_dropped,
                "rotations": self.rotations,
                "bytes_current": self._bytes_current,
            }
            rec = self._recorder
        if rec is not None:
            out.update(rec.stats())
        else:
            out.update(
                {
                    "bundles": 0,
                    "debounces": 0,
                    "bundle_evictions": 0,
                    "bundle_errors": 0,
                }
            )
        return out


JOURNAL = EventJournal()


def emit(kind: str, **fields) -> None:
    """Module-level journal emit (the failure-path form): one bool check
    and a return while the journal is disabled — the whole disabled-path
    cost, mirroring ``obs.trace.instant``."""
    if JOURNAL.enabled:
        JOURNAL.record(kind, fields)


def enabled() -> bool:
    return JOURNAL.enabled


def ensure_configured(cfg) -> None:
    """Enable the process journal when the config asks for it
    (``cfg.journal_dir``, or ``cfg.incidents_dir`` — a flight recorder
    without a journal dir keeps its journal beside the bundles). Never
    disables — the journal is process-scoped, and a second engine with
    journaling off must not cut a live recording short. Under fault
    injection the journal carries its own injector instance so the
    ``disk_full`` site exercises the counted-drop degrade path with an
    independent deterministic schedule."""
    journal_dir = getattr(cfg, "journal_dir", "") or ""
    if not journal_dir:
        journal_dir = getattr(cfg, "incidents_dir", "") or ""
    if not journal_dir or JOURNAL.enabled:
        return
    injector = None
    faults = getattr(cfg, "faults", None)
    if faults is not None and getattr(faults, "enabled", False):
        from flexible_llm_sharding_tpu_torch.faults.inject import FaultInjector

        injector = FaultInjector.from_config(faults)
    JOURNAL.configure(
        journal_dir,
        max_bytes=int(getattr(cfg, "journal_max_mb", 16.0) * 1e6),
        injector=injector,
    )


def reset_journal() -> None:
    """Close and reset the process journal (tests)."""
    JOURNAL.close()


__all__ = [
    "EVENT_KINDS",
    "EventJournal",
    "JOURNAL",
    "JOURNAL_FILE",
    "SEVERITY_LEVELS",
    "emit",
    "enabled",
    "ensure_configured",
    "reset_journal",
    "severity_rank",
]
