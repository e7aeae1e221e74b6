"""Fleet elasticity and sweep-phase stagger (the JAX package's
``serve/autoscale.py``).

A request waits at most one sweep for its shard-0 admission point. Two
controllers act on the replica fleet (``serve/fleet.py``):

:class:`FleetAutoscaler`, the fleet's size. A daemon poll (clock and
samplers injectable, so tests drive it step by step) reads the worst
per-class SLO burn rate and its trend (``obs/slo.py``) and the fleet's
queued fraction, and calls ``add_replica`` or ``remove_replica(drain=True)``
between ``AutoscaleConfig.min`` and ``max``:

- a signal must hold ``confirm_polls`` consecutive polls, and a burn that
  is already falling buys no replica;
- the shrink thresholds sit under the grow ones (hysteresis), and each
  direction has its own cooldown after any action;
- interlocks: no growth at ``max`` (reported, not silent) or while the
  brownout controller sheds, no shrink below ``min`` or while a drain is in
  flight, and no decision at all until the WAL replay is done;
- ``dry_run`` decides and counts without acting.

The brownout interlock reads ``fleet._pressure``, the process controller
of ``runtime/pressure.py`` (None with pressure off: the interlock never
blocks). Every decision is counted in :meth:`FleetAutoscaler.stats`
(``grows``, ``shrinks``, ``blocked``, ``dry_run_decisions``) and, as in the
JAX controller, is an ``autoscale_grow``, ``autoscale_shrink`` or
``autoscale_blocked`` journal event and trace instant; a failed poll is an
``autoscale_poll_error`` instant (and the port's ``poll_errors``).

:class:`StaggerController`, the fleet's phase. N replicas bound the wait to
a sweep over N only if their sweeps sit at offsets i/N. The fleet measures
each busy replica's phase at its health poll; the controller computes the
stagger error (:func:`stagger_error`: 0 a perfect spread, 1 all in phase)
and, above tolerance, assigns bounded holds, at most
``stagger_hold_max_frac`` of a replica's measured sweep wall, which the
replica sleeps at its next shard-0 boundary. One round at a time: no new
holds while any is pending, and a membership change drops them.
"""

from __future__ import annotations

import threading
import time

from flexible_llm_sharding_tpu_torch.obs import events as obs_events
from flexible_llm_sharding_tpu_torch.obs import trace as obs_trace


def stagger_targets(n: int) -> tuple[float, ...]:
    """The ideal sweep-phase offsets of ``n`` replicas, i/n."""
    if n < 1:
        return ()
    return tuple(i / n for i in range(n))


def stagger_error(phases) -> float:
    """Distance of a phase set from the ideal i/N spread: the N circular
    gaps' total deviation from 1/N over the worst case's ``2 (1 - 1/N)``
    (all replicas in phase), in [0, 1]. Fewer than two phases: 0."""
    ps = sorted(p % 1.0 for p in phases)
    n = len(ps)
    if n < 2:
        return 0.0
    gaps = [ps[i + 1] - ps[i] for i in range(n - 1)]
    gaps.append(ps[0] + 1.0 - ps[-1])
    ideal = 1.0 / n
    dev = sum(abs(g - ideal) for g in gaps)
    return min(1.0, dev / (2.0 * (1.0 - ideal)))


class StaggerController:
    """The phase-offset bookkeeping: the fleet's health poll calls
    :meth:`observe`, each replica's shard-0 step :meth:`on_boundary`. Its
    :meth:`stats` is the fleet's ``fleet`` stats source."""

    # Weight of the newest sweep wall in its moving average.
    WALL_ALPHA = 0.5

    def __init__(self, auto_cfg):
        self.cfg = auto_cfg
        self._lock = threading.Lock()
        self.restaggers = 0  # guarded by: _lock
        self.holds_applied = 0  # guarded by: _lock
        self.hold_wall_s = 0.0  # guarded by: _lock
        self.last_error = 0.0  # guarded by: _lock
        self.converged = True  # guarded by: _lock
        self._holds: dict[int, float] = {}  # guarded by: _lock
        self._walls: dict[int, float] = {}  # guarded by: _lock
        self._last_boundary: dict[int, float] = {}  # guarded by: _lock

    def note_membership_change(self) -> None:
        """A replica joined, left or was recycled: the pending holds were
        computed for another fleet."""
        with self._lock:
            self.restaggers += 1
            self._holds.clear()

    def forget(self, idx: int) -> None:
        """Drop a dead or removed replica's state."""
        with self._lock:
            self._holds.pop(idx, None)
            self._walls.pop(idx, None)
            self._last_boundary.pop(idx, None)

    def on_boundary(self, idx: int, now: float) -> float:
        """Replica ``idx`` at a shard-0 step: update its sweep-wall average
        and pop its pending hold, returned in seconds (0.0 for none)."""
        with self._lock:
            prev = self._last_boundary.get(idx)
            self._last_boundary[idx] = now
            if prev is not None and now > prev:
                wall = now - prev
                ema = self._walls.get(idx)
                self._walls[idx] = (wall if ema is None
                                    else (1 - self.WALL_ALPHA) * ema + self.WALL_ALPHA * wall)
            hold = self._holds.pop(idx, 0.0)
            if hold > 0.0:
                self.holds_applied += 1
                self.hold_wall_s += hold
        return hold

    def hold_frac(self, idx: int) -> float:
        """Replica ``idx``'s pending hold as a fraction of its sweep wall
        (the router's ``hold_frac``)."""
        with self._lock:
            hold = self._holds.get(idx, 0.0)
            wall = self._walls.get(idx, 0.0)
        if hold <= 0.0 or wall <= 0.0:
            return 0.0
        return min(1.0, hold / wall)

    def observe(self, phases: dict[int, float]) -> float:
        """One measurement round: ``phases`` maps each busy serving
        replica's index to its sweep phase in [0, 1). Updates the error and,
        above tolerance and with no hold pending, assigns one round of
        holds: anchored on the most advanced replica (no hold), replica j of
        the descending order is held back to ``anchor - j / N``."""
        err = stagger_error(phases.values())
        with self._lock:
            self.last_error = err
            self.converged = err <= self.cfg.stagger_tolerance
            if self.converged or len(phases) < 2:
                self._holds.clear()
                return err
            if self._holds:
                return err  # the previous round is still pending
            items = sorted(phases.items(), key=lambda kv: -(kv[1] % 1.0))
            n = len(items)
            anchor = items[0][1] % 1.0
            for j, (idx, p) in enumerate(items):
                target = (anchor - j / n) % 1.0
                need = ((p % 1.0) - target) % 1.0
                wall = self._walls.get(idx, 0.0)
                if need <= 1e-6 or wall <= 0.0:
                    continue
                hold = min(need, self.cfg.stagger_hold_max_frac) * wall
                if hold > 0.0:
                    self._holds[idx] = hold
        return err

    def stats(self) -> dict:
        with self._lock:
            return {
                "stagger_error": round(self.last_error, 4),
                "stagger_converged": int(self.converged),
                "restaggers": self.restaggers,
                "holds_applied": self.holds_applied,
                "hold_wall_s": round(self.hold_wall_s, 4),
                "holds_pending": len(self._holds),
            }


class FleetAutoscaler:
    """The elasticity control loop (module doc). The fleet builds and
    starts it when ``AutoscaleConfig.enabled``; tests build it on a fake
    fleet with an injected clock and samplers and call :meth:`poll_once`.
    Its :meth:`stats` is the fleet's ``autoscale`` stats source."""

    def __init__(self, fleet, auto_cfg, *, clock=time.monotonic, burn_sampler=None,
                 queue_sampler=None, pressure_sampler=None, replay_pending: bool = False):
        self.fleet = fleet
        self.cfg = auto_cfg
        self._clock = clock
        self._burn_sampler = burn_sampler or self._default_burn
        self._queue_sampler = queue_sampler or self._default_queue_frac
        self._pressure_sampler = pressure_sampler or self._default_pressure
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self.polls = 0  # guarded by: _lock
        self.grows = 0  # guarded by: _lock
        self.shrinks = 0  # guarded by: _lock
        self.blocked = 0  # guarded by: _lock
        self.poll_errors = 0  # guarded by: _lock
        self.dry_run_decisions = 0  # guarded by: _lock
        # The population the controller steers toward.
        self.target = fleet.population()  # guarded by: _lock
        self._grow_streak = 0  # guarded by: _lock
        self._shrink_streak = 0  # guarded by: _lock
        self._cooldown_grow_until = -1.0  # guarded by: _lock
        self._cooldown_shrink_until = -1.0  # guarded by: _lock
        self._blocked_latched: set[str] = set()  # guarded by: _lock
        self._replay_pending = replay_pending  # guarded by: _lock
        self._last_burn = 0.0  # guarded by: _lock
        self._last_queue_frac = 0.0  # guarded by: _lock

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, name="fleet-autoscale", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.poll_s):
            try:
                self.poll_once()
            # flscheck: disable=EXC-TAXONOMY: autoscaler daemon: a sampler or decision bug must not kill elasticity control; it is counted and the next poll retries
            except Exception:  # a sampler's bug must not end the control loop: counted, next poll retries
                with self._lock:
                    self.poll_errors += 1
                obs_trace.instant("autoscale_poll_error", cat="autoscale")

    def mark_replay_complete(self) -> None:
        """Open the WAL-replay interlock (idempotent)."""
        with self._lock:
            self._replay_pending = False

    # -- default samplers ---------------------------------------------------

    def _default_burn(self) -> tuple[float, bool]:
        """(the worst per-class burn rate over the serving engines, whether
        that engine's burn trend is falling)."""
        worst, falling = 0.0, False
        for eng in self.fleet.serving_engines():
            s = eng.slo_tracker.stats()
            burn = s.get("worst_burn_rate", 0.0)
            if burn >= worst:
                worst = burn
                falling = bool(s.get("trend", {}).get("falling", 0))
        return worst, falling

    def _default_queue_frac(self) -> float:
        return self.fleet.queue_frac()

    def _default_pressure(self) -> bool:
        # The fleet's process brownout controller (None when pressure is off).
        ctrl = getattr(self.fleet, "_pressure", None)
        return ctrl is not None and ctrl.at_or_above("shed")

    # -- the control loop ------------------------------------------------------

    def poll_once(self) -> dict:
        """One decision: returns ``{"action": "grow" | "shrink" |
        "blocked:<reasons>" | "hold", ...the sampled fields}``."""
        now = self._clock()
        sampled = self._burn_sampler()
        burn, falling = sampled if isinstance(sampled, tuple) else (sampled, False)
        queue_frac = self._queue_sampler()
        population = self.fleet.population()
        grow_signal = ((burn >= self.cfg.grow_burn_rate and not falling)
                       or queue_frac >= self.cfg.grow_queue_frac)
        shrink_signal = (burn < self.cfg.shrink_burn_rate
                         and queue_frac < self.cfg.shrink_queue_frac)
        with self._lock:
            self.polls += 1
            self._last_burn = burn
            self._last_queue_frac = queue_frac
            self._grow_streak = self._grow_streak + 1 if grow_signal else 0
            self._shrink_streak = self._shrink_streak + 1 if shrink_signal else 0
            grow_confirmed = self._grow_streak >= self.cfg.confirm_polls
            shrink_confirmed = self._shrink_streak >= self.cfg.confirm_polls
            replay_pending = self._replay_pending
            grow_cooling = now < self._cooldown_grow_until
            shrink_cooling = now < self._cooldown_shrink_until
        fields = {"population": population, "burn_rate": round(burn, 4),
                  "queue_frac": round(queue_frac, 4), "dry_run": self.cfg.dry_run}
        action = "hold"
        blocked_now: set[str] = set()
        if grow_confirmed and population < self.cfg.max:
            if replay_pending:
                blocked_now.add("replay_pending")
            elif self._pressure_sampler():
                blocked_now.add("pressure_shed")
            elif grow_cooling:
                blocked_now.add("grow_cooldown")
            else:
                action = self._act("grow", now, fields)
        elif grow_confirmed and population >= self.cfg.max:
            blocked_now.add("at_max")
        elif shrink_confirmed and population > self.cfg.min:
            if replay_pending:
                blocked_now.add("replay_pending")
            elif self.fleet.drains_in_flight() > 0:
                blocked_now.add("drain_in_flight")
            elif shrink_cooling:
                blocked_now.add("shrink_cooldown")
            else:
                action = self._act("shrink", now, fields)
        # Shrink-confirmed at min is an idle fleet's resting state.
        if blocked_now:
            action = "blocked:" + ",".join(sorted(blocked_now))
            self._latch_blocked(blocked_now, fields)
        else:
            with self._lock:
                self._blocked_latched.clear()
        return {"action": action, **fields}

    def _act(self, direction: str, now: float, fields: dict) -> str:
        """One confirmed scale action (counted only, in a dry run): both
        cooldowns restart from it and both streaks reset."""
        dry = self.cfg.dry_run
        if not dry:
            try:
                if direction == "grow":
                    self.fleet.add_replica()
                else:
                    # Non-blocking: the fleet's monitor completes the drain.
                    self.fleet.remove_replica(drain=True, timeout=0.0)
            except (ValueError, RuntimeError):
                # Lost a race with another topology change: the next poll
                # measures again.
                return "hold"
        # Lock order: never hold this lock across the fleet's.
        population = self.fleet.population()
        with self._lock:
            self._grow_streak = 0
            self._shrink_streak = 0
            self._cooldown_grow_until = now + self.cfg.grow_cooldown_s
            self._cooldown_shrink_until = now + self.cfg.shrink_cooldown_s
            self._blocked_latched.clear()
            if dry:
                self.dry_run_decisions += 1
            elif direction == "grow":
                self.grows += 1
                self.target = population
            else:
                self.shrinks += 1
                self.target = max(self.cfg.min, population)
            target = self.target
        # Literal kinds, so the journal's registry check sees both.
        if direction == "grow":
            obs_events.emit("autoscale_grow", target=target, **fields)
            obs_trace.instant("autoscale_grow", cat="autoscale", target=target, **fields)
        else:
            obs_events.emit("autoscale_shrink", target=target, **fields)
            obs_trace.instant("autoscale_shrink", cat="autoscale", target=target, **fields)
        return direction

    def _latch_blocked(self, reasons: set, fields: dict) -> None:
        """A standing interlock counts and journals once per reason, again
        only after a poll where it did not block."""
        with self._lock:
            fresh = reasons - self._blocked_latched
            self._blocked_latched = set(reasons)
            self.blocked += len(fresh)
        for reason in sorted(fresh):
            obs_events.emit("autoscale_blocked", reason=reason, **fields)
            obs_trace.instant("autoscale_blocked", cat="autoscale", reason=reason, **fields)

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": 1,
                "dry_run": int(self.cfg.dry_run),
                "polls": self.polls,
                "grows": self.grows,
                "shrinks": self.shrinks,
                "blocked": self.blocked,
                "poll_errors": self.poll_errors,
                "dry_run_decisions": self.dry_run_decisions,
                "target_replicas": self.target,
                "min_replicas": self.cfg.min,
                "max_replicas": self.cfg.max,
                "grow_streak": self._grow_streak,
                "shrink_streak": self._shrink_streak,
                "replay_pending": int(self._replay_pending),
                "last_burn_rate": round(self._last_burn, 4),
                "last_queue_frac": round(self._last_queue_frac, 4),
            }


__all__ = ["FleetAutoscaler", "StaggerController", "stagger_error", "stagger_targets"]
