"""Warm restart from the request WAL: crash-safe serving, part 2 (the JAX
package's ``serve/recovery.py``).

``replay(engine, wal)`` runs once at startup, before the frontend takes new
traffic: it folds every WAL segment per request id (``serve/wal.
fold_records``: terminal ids are skipped, so a completed request is never
served twice) and submits every open request again through the normal
admission path (``engine.submit_request``), so replayed work meets the
queue, the scheduler and adapter resolution as any request does. The
``engine`` may be a ``ReplicaFleet``, which has the same surface: the
replay then dispatches through its router, whatever the number of replicas
the log was written by.

Serving is greedy, so decoding the original prompt under its original
budget again gives the same tokens: progress records are accounting, not
resume state. What a warm restart saves is time: a graceful shutdown
exported each live request's prefix-KV pages
(``KVPagePool.export_entry``) and the replay restores them
(``restore_entry``), so the request's prefill reuses them. A page that
fails its check is counted and the request prefills again.

Deadlines: the WAL keeps the seconds left at admission, and the replay
counts them from now (``SchedCore.replay_deadline``), so downtime is not
charged. A request with any progress record was already admitted before the
restart and replays with no deadline.

The terminal record is written after the client's callback, so a crash
between the two emits that request's output again after the restart:
clients merge by ``client_id``.
"""

from __future__ import annotations

import time

from flexible_llm_sharding_tpu_torch.obs import events as obs_events
from flexible_llm_sharding_tpu_torch.runtime.schedcore import SchedCore
from flexible_llm_sharding_tpu_torch.serve.request import Request
from flexible_llm_sharding_tpu_torch.serve.wal import RequestWAL, WalEntry


def build_request(entry: WalEntry, callback=None, now=None) -> Request:
    """A request to submit again from a folded WAL entry: the original
    prompt and whole budget, the ``wal_id`` (its admission opens the same
    id again) and ``client_id``, and the deadline re-armed from the seconds
    left (none once admitted)."""
    admit = entry.admit
    deadline = (None if entry.emitted > 0
                else SchedCore().replay_deadline(admit.get("deadline_left_s"), now=now))
    return Request(
        prefix=admit["prefix"],
        suffixes=tuple(admit["suffixes"]),
        max_new_tokens=int(admit["max_new_tokens"]),
        deadline=deadline,
        callback=callback,
        slo_class=admit.get("slo") or "standard",
        tenant_id=admit.get("tenant") or "default",
        adapter_id=admit.get("adapter"),
        wal_id=entry.wal_id,
        client_id=admit.get("client_id"),
    )


def replay(engine, wal: RequestWAL, callback=None) -> dict:
    """Submit every open WAL request to ``engine`` (an engine or a fleet)
    again, oldest admission first, restoring exported prefix KV into the
    process pool first.
    ``callback`` is attached to each (the JSONL frontend's reply emitter).
    Returns the summary (``replayed``, ``skipped_terminal``, ``kv_restored``,
    ``kv_failed``, ``scan_s``) and the submitted ``requests``."""
    t0 = time.monotonic()
    entries = wal.scan()
    open_entries = sorted((e for e in entries.values() if e.open),
                          key=lambda e: e.admit.get("ts") or 0.0)
    # In a fleet, any replica's: the pool is process-wide per config, so
    # one restore serves every replica.
    pool = engine.kv_pool
    kv_restored = kv_failed = 0
    requests = []
    for entry in open_entries:
        if entry.kv is not None and pool is not None:
            if pool.restore_entry(entry.kv):
                kv_restored += 1
            else:
                kv_failed += 1
        req = build_request(entry, callback=callback)
        engine.submit_request(req)
        requests.append(req)
    summary = {
        "replayed": len(requests),
        "skipped_terminal": len(entries) - len(open_entries),
        "kv_restored": kv_restored,
        "kv_failed": kv_failed,
        "scan_s": round(time.monotonic() - t0, 6),
    }
    obs_events.emit("wal_replay", **summary,
                    wal_ids=[r.wal_id for r in requests][:32])  # bounded: lines stay scannable
    # Segments whose every id is terminal again can go.
    wal.maybe_compact()
    summary["requests"] = requests
    return summary


__all__ = ["build_request", "replay"]
