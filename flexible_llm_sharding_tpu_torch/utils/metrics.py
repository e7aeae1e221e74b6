"""Counters of the weight stream's fault handling (the JAX package's
``utils/metrics.py`` ``RetryRecorder`` and ``IntegrityRecorder``), and the
host's resident memory."""

from __future__ import annotations

import threading


class RetryRecorder:
    """Thread-safe retry accounting fed by ``faults.retry.retry_call``, per
    call-site label: ``retries`` (backoff sleeps), ``recovered`` (calls that
    succeeded after a retry), ``exhausted`` (calls that gave up) and
    ``backoff_s`` (total sleep)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_label: dict[str, dict[str, float]] = {}

    def record(self, label: str, *, retries: int = 0, recovered: int = 0, exhausted: int = 0,
               backoff_s: float = 0.0) -> None:
        with self._lock:
            d = self._by_label.setdefault(
                label or "call", {"retries": 0, "recovered": 0, "exhausted": 0, "backoff_s": 0.0})
            d["retries"] += retries
            d["recovered"] += recovered
            d["exhausted"] += exhausted
            d["backoff_s"] += backoff_s

    def total(self, key: str = "retries") -> float:
        with self._lock:
            return sum(d[key] for d in self._by_label.values())

    def snapshot(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {k: {kk: round(vv, 4) if kk == "backoff_s" else int(vv) for kk, vv in d.items()}
                    for k, d in sorted(self._by_label.items())}


class IntegrityRecorder:
    """Thread-safe corruption counters: ``integrity_failures`` (mismatches
    and unreadable spills detected), ``reread_heals`` (loads clean on a
    re-read), ``recomputes`` (kept for the JAX key set; the recompute path
    comes with resume, ROADMAP 3.6) and ``quarantined_shards``."""

    KEYS = ("integrity_failures", "reread_heals", "recomputes", "quarantined_shards")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: dict[str, int] = dict.fromkeys(self.KEYS, 0)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def total(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)


def host_rss_gib() -> dict[str, float]:
    """This process's resident memory in GiB: ``rss`` (VmRSS of
    ``/proc/self/status``, now) where the kernel reports it, and ``peak``
    (VmHWM there, else ``getrusage``'s maximum). Page-locked buffers
    count."""
    import resource

    out = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                for key, name in (("VmRSS:", "rss"), ("VmHWM:", "peak")):
                    if line.startswith(key):
                        out[name] = int(line.split()[1]) / 2**20
    except (OSError, ValueError, IndexError):
        pass
    out.setdefault("peak", resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20)
    return out


__all__ = ["IntegrityRecorder", "RetryRecorder", "host_rss_gib"]
