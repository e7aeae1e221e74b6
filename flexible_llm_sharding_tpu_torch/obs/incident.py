"""The flight recorder's incident bundles (the JAX package's
``obs/incident.py``).

When a journal event crosses the configured severity
(``incident_trigger``), a self-contained bundle directory is captured:

- ``journal_tail.jsonl``  the newest journal events (from the in-memory
  ring, so a full disk that drops journal writes still yields a tail)
- ``metrics.json``        the process ``MetricsRegistry.collect()``
  snapshot (a raising source keeps its ``collect_error`` marker)
- ``trace.json``          the trace ring as Chrome trace-event JSON
  (empty when tracing is off)
- ``config.json``         the resolved FrameworkConfig/ServeConfig
- ``manifest.json``       the trigger event, capture time, file list,
  journal health and the KV pools' summary

Bundles land under a disk-budgeted directory (``incidents_max_mb``),
oldest evicted first. Two storm controls: **settle** (the capture waits
``incident_settle_s`` after the trigger, each further trigger pushing the
deadline out, bounded) and **debounce** (triggers within
``incident_debounce_s`` of a capture only count). Capture is best-effort:
a failure counts (``bundle_errors``) and never raises into the failure
path that triggered it. The capture runs on its own thread and reads only
host state: registry sources make no CUDA call. Render a bundle with
``incidents analyze <dir>`` (``obs/report.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time

from flexible_llm_sharding_tpu_torch.obs import events as obs_events

BUNDLE_FORMAT = "fls-incident-bundle"
BUNDLE_VERSION = 1
MANIFEST_NAME = "manifest.json"
# How far a storm can push the settle deadline past the first trigger.
MAX_SETTLE_EXTENSION = 10.0


class IncidentRecorder:
    """Severity-triggered bundle capture over the process journal
    (module docstring). Attached to :data:`obs.events.JOURNAL`; its
    counters ride the ``fls_journal_*`` family."""

    def __init__(
        self,
        out_dir: str,
        max_bytes: int = 256_000_000,
        trigger: str = "error",
        debounce_s: float = 60.0,
        settle_s: float = 1.0,
        config_snapshot: dict | None = None,
    ):
        self.out_dir = out_dir
        self.max_bytes = int(max_bytes)
        self.trigger_rank = obs_events.severity_rank(trigger)
        self.debounce_s = float(debounce_s)
        self.settle_s = float(settle_s)
        self.config_snapshot = config_snapshot or {}
        self._lock = threading.Lock()
        self._pending = False  # guarded by: _lock
        self._deadline = 0.0  # guarded by: _lock
        self._pending_t0 = 0.0  # guarded by: _lock
        self._last_capture: float | None = None  # guarded by: _lock
        # Counters, exported via stats().
        self.bundles = 0
        self.debounces = 0
        self.bundle_evictions = 0
        self.bundle_errors = 0

    # -- journal hook ------------------------------------------------------

    def observe(self, event: dict) -> None:
        """Journal-side hook, called for EVERY recorded event (off the
        journal lock). Sub-trigger severities return on one comparison;
        the recorder's own ``incident_capture`` marker is ignored so a
        capture can never re-trigger itself."""
        if event.get("kind") == "incident_capture":
            return
        severity = event.get("severity", "")
        if severity not in obs_events.SEVERITY_LEVELS:
            # An unknown event severity must never trigger: the rank
            # helper deliberately ranks unknowns ABOVE critical (the
            # fail-safe direction for thresholds), which is exactly the
            # wrong direction for an event-side comparison.
            return
        if obs_events.severity_rank(severity) < self.trigger_rank:
            return
        now = time.monotonic()
        with self._lock:
            if self._pending:
                # Storm extension: each further trigger event pushes the
                # capture out so the whole storm lands in the bundle's
                # journal tail — bounded, so a sustained storm still
                # yields a bundle rather than deferring forever.
                self._deadline = min(
                    now + self.settle_s,
                    self._pending_t0 + self.settle_s + MAX_SETTLE_EXTENSION,
                )
                return
            if (
                self._last_capture is not None
                and now - self._last_capture < self.debounce_s
            ):
                self.debounces += 1
                return
            self._pending = True
            self._pending_t0 = now
            self._deadline = now + self.settle_s
        if self.settle_s <= 0:
            self._settle_and_capture(event)
        else:
            threading.Thread(
                target=self._settle_and_capture,
                args=(event,),
                name="incident-capture",
                daemon=True,
            ).start()

    def _settle_and_capture(self, trigger_event: dict) -> None:
        while True:
            with self._lock:
                remaining = self._deadline - time.monotonic()
            if remaining <= 0:
                break
            time.sleep(min(remaining, 0.05))
        path = None
        try:
            path = self.capture(trigger_event)
        finally:
            with self._lock:
                self._pending = False
                self._last_capture = time.monotonic()
        if path is not None:
            obs_events.emit(
                "incident_capture",
                bundle=os.path.basename(path),
                trigger=trigger_event.get("kind"),
                trigger_seq=trigger_event.get("seq"),
            )

    # -- capture -----------------------------------------------------------

    def capture(self, trigger_event: dict | None = None) -> str | None:
        """Write one bundle now (also the manual/CLI form). Returns the
        bundle path, or None on failure (counted, never raised)."""
        trigger_event = trigger_event or {"kind": "manual", "seq": 0}
        name = (
            f"incident-{int(trigger_event.get('seq') or 0):08d}-"
            f"{trigger_event.get('kind', 'manual')}"
        )
        final = os.path.join(self.out_dir, name)
        tmp = final + ".tmp"
        try:
            files = self._write_bundle(tmp, trigger_event)
            self._write_manifest(tmp, trigger_event, files)
            if os.path.isdir(final):
                shutil.rmtree(final)
            # Atomic publish: a bundle directory either carries its
            # manifest or does not exist under its final name.
            os.replace(tmp, final)
            self.bundles += 1
        except Exception:  # noqa: BLE001 — flight-recorder pillar 2
            # Best-effort: a capture failure (disk full, a source torn
            # down mid-walk) never raises into the failure path that
            # triggered it; it is counted (fls_journal_bundle_errors).
            self.bundle_errors += 1
            shutil.rmtree(tmp, ignore_errors=True)
            return None
        self._enforce_budget(keep=name)
        return final

    def _write_bundle(self, bundle_dir: str, trigger_event: dict) -> list[str]:
        from flexible_llm_sharding_tpu_torch.obs.registry import REGISTRY
        from flexible_llm_sharding_tpu_torch.obs.trace import TRACER

        os.makedirs(bundle_dir, exist_ok=True)
        files: list[str] = []

        def write(fname: str, payload) -> None:
            with open(os.path.join(bundle_dir, fname), "w") as f:
                if fname.endswith(".jsonl"):
                    for item in payload:
                        f.write(json.dumps(item, default=str) + "\n")
                else:
                    json.dump(payload, f, indent=1, default=str)
            files.append(fname)

        write("journal_tail.jsonl", obs_events.JOURNAL.tail())
        # collect() keeps a raising source as {"collect_error": 1}: a
        # broken source at capture time is evidence.
        write("metrics.json", REGISTRY.collect())
        write(
            "trace.json",
            {"traceEvents": TRACER.chrome_events(), "displayTimeUnit": "ms"},
        )
        write("config.json", self.config_snapshot)
        return files

    def _write_manifest(
        self, bundle_dir: str, trigger_event: dict, files: list[str]
    ) -> None:
        manifest = {
            "format": BUNDLE_FORMAT,
            "version": BUNDLE_VERSION,
            "captured_at": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
            ),
            "pid": os.getpid(),
            "trigger": trigger_event,
            "files": sorted(files),
            "journal": obs_events.JOURNAL.stats(),
        }
        try:
            # The paged prefix-KV pools' counters and a bounded page-table
            # summary (runtime/kvpool.py), best-effort like every part.
            from flexible_llm_sharding_tpu_torch.runtime import kvpool

            if kvpool.process_pools():
                manifest["kvpool"] = kvpool.process_summary()
        except Exception:  # noqa: BLE001 — flight-recorder pillar 2
            manifest["kvpool"] = {"collect_error": 1}
        with open(os.path.join(bundle_dir, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f, indent=1, default=str)

    # -- disk budget -------------------------------------------------------

    def _bundle_dirs(self) -> list[str]:
        try:
            names = sorted(os.listdir(self.out_dir))
        except OSError:
            return []
        return [
            n
            for n in names
            if n.startswith("incident-")
            and not n.endswith(".tmp")
            and os.path.isdir(os.path.join(self.out_dir, n))
        ]

    @staticmethod
    def _dir_bytes(path: str) -> int:
        total = 0
        for root, _dirs, fnames in os.walk(path):
            for fname in fnames:
                try:
                    total += os.path.getsize(os.path.join(root, fname))
                except OSError:
                    pass
        return total

    def _enforce_budget(self, keep: str) -> None:
        """Evict oldest-first (bundle names sort by trigger seq) until
        the incidents dir fits the byte budget; the newest bundle is
        never evicted, whatever its size."""
        try:
            names = self._bundle_dirs()
            sizes = {
                n: self._dir_bytes(os.path.join(self.out_dir, n))
                for n in names
            }
            total = sum(sizes.values())
            for n in names:
                if total <= self.max_bytes or n == keep:
                    continue
                shutil.rmtree(
                    os.path.join(self.out_dir, n), ignore_errors=True
                )
                total -= sizes[n]
                self.bundle_evictions += 1
        except OSError:
            self.bundle_errors += 1

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """Bundle counters, merged into the ``journal`` registry source
        by :meth:`obs.events.EventJournal.stats`."""
        return {
            "bundles": self.bundles,
            "debounces": self.debounces,
            "bundle_evictions": self.bundle_evictions,
            "bundle_errors": self.bundle_errors,
        }


def config_snapshot(cfg, serve_cfg=None) -> dict:
    """JSON-ready resolved-config dict for the bundle's config.json."""
    out: dict = {}
    if cfg is not None:
        out["framework"] = dataclasses.asdict(cfg)
    if serve_cfg is not None:
        out["serve"] = dataclasses.asdict(serve_cfg)
    return out


def ensure_configured(cfg, serve_cfg=None) -> IncidentRecorder | None:
    """Arm the incident recorder when ``cfg.incidents_dir`` is set
    (first caller wins; later engines share it — the process-singleton
    precedent). Also ensures the journal is enabled — bundles without a
    journal tail would be snapshots, not a flight recording."""
    # Journal first, unconditionally: a journal-only config (journal_dir
    # set, incidents_dir empty) must still arm the journal through this
    # one entry point — the kv_cache batch path reaches no other
    # ensure_configured call.
    obs_events.ensure_configured(cfg)
    incidents_dir = getattr(cfg, "incidents_dir", "") or ""
    if not incidents_dir:
        return obs_events.JOURNAL.recorder
    if obs_events.JOURNAL.recorder is None:
        os.makedirs(incidents_dir, exist_ok=True)
        recorder = IncidentRecorder(
            incidents_dir,
            max_bytes=int(getattr(cfg, "incidents_max_mb", 256.0) * 1e6),
            trigger=getattr(cfg, "incident_trigger", "error"),
            debounce_s=getattr(cfg, "incident_debounce_s", 60.0),
            settle_s=getattr(cfg, "incident_settle_s", 1.0),
            config_snapshot=config_snapshot(cfg, serve_cfg),
        )
        obs_events.JOURNAL.attach_recorder(recorder)
    return obs_events.JOURNAL.recorder


__all__ = [
    "BUNDLE_FORMAT",
    "IncidentRecorder",
    "MANIFEST_NAME",
    "config_snapshot",
    "ensure_configured",
]
