"""Shard-phase-aware routing for the replica fleet (the JAX package's
``serve/router.py``).

Every replica runs the same endless weight sweep, and a request joins only
at a shard-0 boundary (``serve/batcher.py``): handed to a replica about to
re-enter shard 0, it starts its prefill a whole sweep sooner than on one
that just left it. The score combines the two signals an engine exports
without a lock (``ServeEngine.sweep_position`` and its queue and batcher
depths)::

    score = phase_weight * phase_bias * (boundary_frac + hold_frac)
            + depth_weight * (queued + active) / max_active

``boundary_frac`` is the fraction of a sweep left until the replica's next
admission (0 for an idle replica), ``hold_frac`` a stagger hold pending at
its next boundary (``serve/autoscale.py``), ``phase_bias`` the interactive
boost (``SchedConfig.interactive_phase_boost``). The lowest score wins,
ties to the lowest replica index. The fleet says which replicas serve; the
router also skips one whose engine already set a fatal ``error`` (its queue
is closed: a dispatch there can only fail).
"""

from __future__ import annotations

from typing import Any


class Router:
    """Stateless ranking over replica snapshots."""

    def __init__(self, phase_weight: float = 1.0, depth_weight: float = 1.0) -> None:
        if phase_weight < 0 or depth_weight < 0:
            raise ValueError("router weights must be >= 0")
        self.phase_weight = phase_weight
        self.depth_weight = depth_weight

    def score(self, snapshot: dict, phase_bias: float = 1.0) -> float:
        """Dispatch cost of one snapshot (``boundary_frac``, ``queue_depth``,
        ``active``, ``max_active``, optionally ``hold_frac``); lower is
        better."""
        load = (snapshot["queue_depth"] + snapshot["active"]) / max(
            snapshot.get("max_active", 1), 1)
        boundary = snapshot["boundary_frac"] + snapshot.get("hold_frac", 0.0)
        return self.phase_weight * phase_bias * boundary + self.depth_weight * load

    def pick(self, replicas: list[Any], exclude: Any = None, phase_bias: float = 1.0):
        """The serving replica for the next request, or None when none can
        take it (the fleet parks the request). ``exclude``, the replica a
        re-dispatched request just failed on, is skipped while another
        candidate exists."""
        candidates = [r for r in replicas
                      if r.serving and getattr(getattr(r, "engine", None), "error", None) is None]
        if exclude is not None and len(candidates) > 1:
            candidates = [r for r in candidates if r is not exclude] or candidates
        if not candidates:
            return None
        return min(candidates, key=lambda r: (self.score(r.snapshot(), phase_bias), r.idx))


__all__ = ["Router"]
