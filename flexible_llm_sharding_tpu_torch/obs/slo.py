"""SLO targets and error budgets of the serving engine (the JAX package's
``obs/slo.py``).

``SLOConfig`` declares per-class p95 TTFT targets, an aggregate per-token
latency p95 target and an availability target; :class:`SLOTracker` turns
the ``ServingMetrics`` windows into error-budget accounting:

- A p95 target allows 5% of samples over the line. The **burn rate** is
  ``violating_fraction / 0.05`` over the recent-sample window (1.0 burns
  the budget exactly at the allowed rate); **budget remaining** is
  ``max(0, 1 - burn_rate)``.
- Availability compares the failed-request fraction with the allowed
  ``1 - availability_target`` the same way.

A budget is **exhausted** when its burn rate reaches 1 with at least
``min_samples`` samples; ``budget_exhausted_events`` counts each such
crossing once, and the latch re-arms when the burn rate falls below 0.5.
Each crossing is an ``slo_budget_exhausted`` journal event (severity error:
with the incident recorder armed, a bundle). The tracker is pull-based: it
reads the windows when its stats are taken, plus a rate-limited per-sweep
check.
"""

from __future__ import annotations

import collections
import threading
import time

from flexible_llm_sharding_tpu_torch.obs import events as obs_events
from flexible_llm_sharding_tpu_torch.utils.metrics import SLO_CLASS_NAMES

# A p95 target tolerates this fraction of samples over the line; the
# error budget is measured against it.
P95_ALLOWED_VIOLATION = 0.05
# Exhaustion latch re-arms below this burn rate (hysteresis).
REARM_BURN_RATE = 0.5
# Worst-burn observations kept for burn_rate_trend() (one per stats()
# evaluation — stats line or rate-limited sweep probe).
TREND_HISTORY = 32
# A windowed burn delta inside +/- this band reads as flat — jitter must
# not register as a direction.
TREND_FLAT_BAND = 0.05


def _p95(samples: list[float]) -> float:
    if not samples:
        return 0.0
    xs = sorted(samples)
    i = min(len(xs) - 1, max(0, round(0.95 * (len(xs) - 1))))
    return round(xs[i], 4)


def _budget(samples: list[float], target: float) -> dict:
    """Burn rate + remaining budget of one p95 stream vs its target."""
    n = len(samples)
    if not target or not n:
        return {
            "target_s": target,
            "samples": n,
            "p95_s": _p95(samples),
            "burn_rate": 0.0,
            "budget_remaining": 1.0,
        }
    violations = sum(1 for s in samples if s > target)
    burn = (violations / n) / P95_ALLOWED_VIOLATION
    return {
        "target_s": target,
        "samples": n,
        "p95_s": _p95(samples),
        "burn_rate": round(burn, 4),
        "budget_remaining": round(max(0.0, 1.0 - burn), 4),
    }


class SLOTracker:
    """Compliance tracker over a ``ServingMetrics`` (module docstring),
    registered as the ``slo`` stats source of every serving engine: per
    class burn rate, remaining budget and p95, plus the aggregate
    token-latency and availability budgets, all pre-seeded."""

    def __init__(self, slo_cfg, metrics):
        self.cfg = slo_cfg
        self.metrics = metrics
        self._ttft_targets = (
            slo_cfg.ttft_target_map() if slo_cfg.enabled else {}
        )
        self._lock = threading.Lock()
        self._latched: set = set()  # guarded by: _lock
        self._last_check = 0.0  # guarded by: _lock
        self.budget_exhausted_events = 0  # guarded by: _lock
        # Worst burn rate per stats() evaluation, newest last — the
        # burn_rate_trend() window. guarded by: _lock
        self._burn_history: collections.deque = collections.deque(
            maxlen=TREND_HISTORY
        )

    # -- accounting --------------------------------------------------------

    def stats(self) -> dict:
        """The ``slo`` stats source. Computing the budgets is the
        exhaustion check: the stats line and the engine's rate-limited
        per-sweep probe share this one path."""
        out: dict = {"enabled": int(self.cfg.enabled)}
        exhausted: list[tuple[str, dict]] = []
        ttft: dict = {}
        for cls in SLO_CLASS_NAMES:
            entry = _budget(
                self.metrics.ttft_class_samples(cls),
                self._ttft_targets.get(cls, 0.0),
            )
            ttft[cls] = entry
            self._judge(f"ttft:{cls}", entry, exhausted)
        out["ttft"] = ttft
        tok = _budget(
            self.metrics.token_latency_samples(),
            self.cfg.token_latency_p95_s if self.cfg.enabled else 0.0,
        )
        out["token_latency"] = tok
        self._judge("token_latency", tok, exhausted)
        out["availability"] = self._availability(exhausted)
        worst = max(
            [e["burn_rate"] for e in ttft.values()]
            + [tok["burn_rate"], out["availability"]["burn_rate"]]
        )
        out["worst_burn_rate"] = worst
        with self._lock:
            out["budget_exhausted_events"] = self.budget_exhausted_events
            self._burn_history.append(worst)
        out["trend"] = self.burn_rate_trend()
        for key, entry in exhausted:  # outside the tracker's lock
            metric, _, cls = key.partition(":")
            obs_events.emit("slo_budget_exhausted", metric=metric, slo_class=cls or None,
                            burn_rate=entry.get("burn_rate"),
                            target=entry.get("target_s", entry.get("target")),
                            samples=entry.get("samples", entry.get("requests")))
        return out

    def _availability(self, exhausted: list) -> dict:
        target = self.cfg.availability_target if self.cfg.enabled else 0.0
        completed = self.metrics.counter("completed")
        failed = self.metrics.counter("failed")
        total = completed + failed
        entry: dict = {
            "target": target,
            "requests": total,
            "observed": round(completed / total, 4) if total else 1.0,
            "burn_rate": 0.0,
            "budget_remaining": 1.0,
        }
        if target and total:
            allowed = max(1.0 - target, 1e-9)
            burn = (failed / total) / allowed
            entry["burn_rate"] = round(burn, 4)
            entry["budget_remaining"] = round(max(0.0, 1.0 - burn), 4)
        self._judge("availability", entry, exhausted)
        return entry

    def _judge(self, key: str, entry: dict, exhausted: list) -> None:
        """Latch-guarded exhaustion decision for one budget entry: the
        latch keeps a sustained burn from counting once per evaluation."""
        n = entry.get("samples", entry.get("requests", 0))
        burning = (
            entry["burn_rate"] >= 1.0 and n >= self.cfg.min_samples
        )
        with self._lock:
            if burning and key not in self._latched:
                self._latched.add(key)
                self.budget_exhausted_events += 1
                exhausted.append((key, entry))
            elif not burning and entry["burn_rate"] < REARM_BURN_RATE:
                self._latched.discard(key)

    def burn_rate_trend(self, k: int = 8) -> dict:
        """Windowed burn direction over the last ``k`` worst-burn
        observations (one per :meth:`stats` evaluation): a single hot
        reading stays flat until the burn sustains across the window.
        Numeric (rising / falling flags + signed delta) from the first
        evaluation on. ``delta`` is newest - oldest inside the window; a
        magnitude inside ``TREND_FLAT_BAND`` is flat."""
        with self._lock:
            window = list(self._burn_history)[-max(2, k):]
        delta = window[-1] - window[0] if len(window) >= 2 else 0.0
        return {
            "window": len(window),
            "burn_delta": round(delta, 4),
            "rising": int(delta > TREND_FLAT_BAND),
            "falling": int(delta < -TREND_FLAT_BAND),
        }

    # -- hot-path probe ----------------------------------------------------

    def maybe_check(self, interval_s: float = 1.0) -> None:
        """Per-sweep probe (engine ``_post_sweep``): evaluate budgets at
        most once per ``interval_s``. Disabled SLOs return on one bool
        check."""
        if not self.cfg.enabled:
            return
        now = time.monotonic()
        with self._lock:
            if now - self._last_check < interval_s:
                return
            self._last_check = now
        self.stats()


__all__ = [
    "P95_ALLOWED_VIOLATION",
    "REARM_BURN_RATE",
    "SLOTracker",
    "TREND_FLAT_BAND",
    "TREND_HISTORY",
]
