"""Resource-pressure resilience: a brownout ladder that degrades instead of
dying (the JAX package's ``runtime/pressure.py``).

The port runs models larger than the card by leaning on host RAM, the
spill disk and the host-to-device link, so those are where a deployment
runs out first. Three parts keep an exhaustion from being fatal:

- :class:`PressureMonitor` samples host MemAvailable, the spill disk's free
  bytes (``disk_folder``'s filesystem), the card's headroom (the CUDA
  caching allocator's in-use bytes against the device's total memory) and
  the link rate (the delta of the executor's process streamed-bytes
  counter). Thresholds are ``config.PressureConfig``'s; a threshold of 0
  turns its signal off, and an unknown sample never trips.
- The hard failures the monitor cannot see coming, a ``MemoryError`` while
  a shard is built or ``ENOSPC`` in a spill write (real or injected), are
  reported through :func:`note_event` by the paths that absorb them
  (``runtime/executor.py``, ``runtime/activations.py``) and count as
  pressure for the poll they land in.
- :class:`BrownoutController` walks the ordered, reversible ladder
  ``LADDER``: one level per pressured poll, straight to ``shed`` on a hard
  event, and one level back down per ``step_down_polls`` consecutive clean
  polls, releasing in reverse order. A level with nothing to act on (no
  cache, no pins, no fleet) still counts as a position on the ladder.

:class:`HostOOMError` and :class:`DiskFullError` are ``OSError`` subclasses
on purpose: the retry policy's transient family, so one backoff ladder and
one way to degrade (fail the wave, keep the engine) cover an allocation
failure as they cover an I/O blip.

Each ladder move is a ``pressure_step`` trace instant and journal event,
each hard event a ``pressure_event`` instant (the controller's) and journal
event (:func:`note_event`'s, with or without a controller), and the process
controller is the ``pressure`` registry source (``fls_pressure_*``), as in
the JAX package.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field

import torch

from flexible_llm_sharding_tpu_torch.config import indexed_device
from flexible_llm_sharding_tpu_torch.obs import events as obs_events
from flexible_llm_sharding_tpu_torch.obs import trace as obs_trace
from flexible_llm_sharding_tpu_torch.obs.registry import REGISTRY


class HostOOMError(OSError):
    """A host allocation failed while a shard was built (a ``MemoryError``
    typed into the transient family): retried under the usual policy, and
    on exhaustion it degrades as any failed shard load does."""


class DiskFullError(OSError):
    """``ENOSPC`` on an activation spill write, typed: retried, and on
    exhaustion raised naming the file, with no partial file left."""


# The monitored resources (the tripped-set vocabulary).
SIGNALS = ("host", "disk", "hbm", "link")


@dataclass(frozen=True)
class PressureSnapshot:
    """One poll's readings; None is unknown (never trips)."""

    host_available_bytes: int | None = None
    disk_free_bytes: int | None = None
    hbm_free_frac: float | None = None
    link_gbps: float | None = None
    tripped: frozenset = field(default_factory=frozenset)


def hbm_free_frac(device: torch.device) -> float | None:
    """The card's free share, ``1 - memory_allocated / total_memory``: the
    caching allocator's in-use bytes, which fall as soon as a tensor is
    dropped (its reserved pool does not shrink, so a free-bytes reading of
    ``mem_get_info`` would not rise after a lever frees memory). None on a
    CPU device. The device is bound first: the monitor samples from a
    thread of its own, where no CUDA context is current yet."""
    if device.type != "cuda":
        return None
    device = indexed_device(device)
    torch.cuda.set_device(device)
    total = torch.cuda.get_device_properties(device).total_memory
    return max(0.0, (total - torch.cuda.memory_allocated(device)) / total)


class PressureMonitor:
    """Samples the four signals and drives the controller.

    The samplers are injectable (tests); by default they read
    /proc/meminfo, ``os.statvfs(disk_folder)``, :func:`hbm_free_frac` on
    ``device`` (default ``cfg.device``) and the executor's process
    streamed-bytes counter. A sampler that fails (other than on a CPU
    device, which reads as unknown) reads as unknown and is counted in the
    controller's ``sample_errors``. ``start()`` runs a daemon thread that
    calls ``controller.on_sample(self.sample())`` every ``poll_s``;
    ``close()`` stops it."""

    def __init__(self, cfg, controller: "BrownoutController", host_bytes_fn=None,
                 disk_free_fn=None, hbm_free_frac_fn=None, link_bytes_fn=None, device=None):
        self.pcfg = cfg.pressure
        self._controller = controller
        self._disk_folder = cfg.disk_folder
        self._device = torch.device(device if device is not None else cfg.device)
        self._host_fn = host_bytes_fn or self._default_host_bytes
        self._disk_fn = disk_free_fn or self._default_disk_free
        self._hbm_fn = hbm_free_frac_fn or self._default_hbm_free_frac
        self._link_fn = link_bytes_fn or self._default_link_bytes
        self._link_prev: tuple[float, int] | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @staticmethod
    def _default_host_bytes() -> int | None:
        from flexible_llm_sharding_tpu_torch.runtime.hostcache import available_host_bytes

        avail = available_host_bytes()
        return avail if avail > 0 else None  # 0 = unknown

    def _default_disk_free(self) -> int | None:
        try:
            st = os.statvfs(self._disk_folder)
        except OSError:
            return None  # no such folder yet: unknown
        return int(st.f_bavail) * int(st.f_frsize)

    def _default_hbm_free_frac(self) -> float | None:
        try:
            return hbm_free_frac(self._device)
        except Exception:  # noqa: BLE001 — a failed probe reads as unknown, and is counted
            self._controller.note_sample_error()
            return None

    @staticmethod
    def _default_link_bytes() -> int:
        from flexible_llm_sharding_tpu_torch.runtime.executor import process_streamed_bytes

        return process_streamed_bytes()

    def sample(self) -> PressureSnapshot:
        p = self.pcfg
        host = self._host_fn()
        disk = self._disk_fn()
        hbm = self._hbm_fn()
        # The link rate over the window since the previous sample, only
        # while bytes flow (an idle stream is not a slow link).
        now = time.monotonic()
        total = self._link_fn()
        link = None
        if self._link_prev is not None:
            dt = now - self._link_prev[0]
            delta = total - self._link_prev[1]
            if dt > 0 and delta > 0:
                link = delta / dt / 1e9
        self._link_prev = (now, total)
        tripped = set()
        if p.host_min_gb > 0 and host is not None and host < p.host_min_gb * 1e9:
            tripped.add("host")
        if p.disk_min_gb > 0 and disk is not None and disk < p.disk_min_gb * 1e9:
            tripped.add("disk")
        if p.hbm_headroom_frac > 0 and hbm is not None and hbm < p.hbm_headroom_frac:
            tripped.add("hbm")
        if p.link_min_gbps > 0 and link is not None and link < p.link_min_gbps:
            tripped.add("link")
        return PressureSnapshot(host_available_bytes=host, disk_free_bytes=disk,
                                hbm_free_frac=hbm, link_gbps=link, tripped=frozenset(tripped))

    def _run(self) -> None:
        while not self._stop.wait(self.pcfg.poll_s):
            try:
                self._controller.on_sample(self.sample())
            except Exception:  # noqa: BLE001 — one failed poll must not end monitoring
                self._controller.note_sample_error()

    def start(self) -> "PressureMonitor":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name="pressure-monitor",
                                            daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


class BrownoutController:
    """The ordered, reversible degradation ladder.

    ``on_sample`` walks the level up one per pressured poll (a threshold
    tripped, or a hard event was noted since the last poll; a hard event
    goes straight to ``shed``, engaging every level on the way in order)
    and down one per ``step_down_polls`` consecutive clean polls. The
    levers run off the controller's lock (they take the cache's, the
    tier's, the queues' and the fleet's); the lock guards the ladder state
    and the counters.

    Components register themselves: serving engines attach their admission
    queues and speculation controllers (one attached at or above its level
    is engaged at once), the fleet attaches itself, and the host cache, the
    adapter store, the KV pools and the residency tier are found through
    their process accessors when a level engages.
    """

    # spec_backoff leads: draft compute is optional spend. adapter_evict
    # follows the cache shrink (an evicted delta reloads in one read),
    # kv_evict comes before the pins (pooled pages spill to disk or
    # re-prefill, dearer than a clean cache entry, cheaper than weights).
    LADDER = ("spec_backoff", "cache_shrink", "adapter_evict", "kv_evict", "pin_evict", "shed",
              "replica_drain")

    def __init__(self, cfg):
        self.cfg = cfg
        self.pcfg = cfg.pressure
        self._lock = threading.RLock()
        self.level = 0  # guarded by: _lock
        self._clean_polls = 0  # guarded by: _lock
        self._events_pending = 0  # guarded by: _lock
        self._queues: list = []  # guarded by: _lock
        self._fleet = None  # guarded by: _lock
        self._spec_ctrls: list = []  # guarded by: _lock
        self._saved_cache_budget: int | None = None
        self._saved_adapter_budget: int | None = None
        self._last: PressureSnapshot = PressureSnapshot()
        self.steps_up = 0
        self.steps_down = 0
        self.sheds = 0
        self.cache_shrinks = 0
        self.adapter_evictions = 0
        self.kv_evictions = 0
        self.pin_evictions = 0
        self.replica_drains = 0
        self.replica_restores = 0
        self.spec_backoffs = 0
        self.spec_restores = 0
        self.host_oom_events = 0
        self.disk_full_events = 0
        self.link_events = 0
        self.polls = 0
        # Port-only: failed samples and polls, and failed levers.
        self.sample_errors = 0
        self.lever_errors = 0

    # -- registration ---------------------------------------------------------

    def attach_queue(self, queue) -> None:
        """Register an admission queue as a shed target; one attached at or
        above the shed level sheds at once (a recycled replica must not
        bypass the brownout)."""
        with self._lock:
            if queue not in self._queues:
                self._queues.append(queue)
            shedding = self.level >= self._level_of("shed")
        if shedding:
            queue.set_shedding(self.pcfg.shed_retry_after_s, on_shed=self.note_shed)

    def detach_queue(self, queue) -> None:
        with self._lock:
            if queue in self._queues:
                self._queues.remove(queue)
        queue.clear_shedding()

    def attach_fleet(self, fleet) -> None:
        with self._lock:
            self._fleet = fleet

    def detach_fleet(self, fleet) -> None:
        with self._lock:
            if self._fleet is fleet:
                self._fleet = None

    def attach_spec(self, ctrl) -> None:
        """Register a speculation controller (``serve/spec.py``) as the
        ``spec_backoff`` target; one attached at or above that level backs
        off at once."""
        with self._lock:
            if ctrl not in self._spec_ctrls:
                self._spec_ctrls.append(ctrl)
            backed_off = self.level >= self._level_of("spec_backoff")
        if backed_off:
            ctrl.pressure_backoff()

    def detach_spec(self, ctrl) -> None:
        with self._lock:
            if ctrl in self._spec_ctrls:
                self._spec_ctrls.remove(ctrl)
        ctrl.pressure_restore()

    # -- intake ---------------------------------------------------------------

    def note_event(self, kind: str) -> None:
        """A hard resource failure (a real or injected host OOM or
        ENOSPC), pressure for the poll it lands in. Unknown kinds are
        dropped (a misspelt kind must not inflate a real counter; the link
        never fails hard, ``link_events`` counts its tripped polls)."""
        with self._lock:
            if kind == "host_oom":
                self.host_oom_events += 1
            elif kind == "disk_full":
                self.disk_full_events += 1
            else:
                return
            self._events_pending += 1
        obs_trace.instant("pressure_event", cat="pressure", kind=kind)

    def note_shed(self) -> None:
        """One admission rejected ``Overloaded`` (the queue's callback)."""
        with self._lock:
            self.sheds += 1

    def note_sample_error(self) -> None:
        """A sampler or a poll failed (the sample read as unknown)."""
        with self._lock:
            self.sample_errors += 1

    # -- the ladder -----------------------------------------------------------

    def _level_of(self, name: str) -> int:
        return self.LADDER.index(name) + 1

    def at_or_above(self, name: str) -> bool:
        """True while the ladder is engaged at ``name``'s level or higher
        (the autoscaler's interlock). An unknown name raises."""
        level = self._level_of(name)
        with self._lock:
            return self.level >= level

    def on_sample(self, snap: PressureSnapshot) -> None:
        """One poll: decide under the lock, engage or release outside it.
        A tripped threshold walks up one level; a hard event walks to
        ``shed`` (only more pressure reaches ``replica_drain``); a release
        takes ``step_down_polls`` consecutive clean polls per level."""
        engage_idxs: list[int] = []
        release_idx = None
        with self._lock:
            self.polls += 1
            self._last = snap
            if "link" in snap.tripped:
                self.link_events += 1
            pending, self._events_pending = self._events_pending, 0
            if snap.tripped or pending > 0:
                self._clean_polls = 0
                target = min(len(self.LADDER), self.level + 1)
                if pending:
                    target = max(target, self._level_of("shed"))
                engage_idxs = list(range(self.level, target))
                self.steps_up += target - self.level
                self.level = target
            else:
                self._clean_polls += 1
                if self.level > 0 and self._clean_polls >= self.pcfg.step_down_polls:
                    self._clean_polls = 0
                    release_idx = self.level - 1
                    self.level -= 1
                    self.steps_down += 1
            level = self.level
        for idx in engage_idxs:
            obs_trace.instant("pressure_step", cat="pressure", direction="up", level=level,
                              stage=self.LADDER[idx], tripped=sorted(snap.tripped),
                              events=pending)
            obs_events.emit("pressure_step", direction="up", level=level,
                            stage=self.LADDER[idx], tripped=sorted(snap.tripped), events=pending)
            self._engage(idx)
        if release_idx is not None:
            obs_trace.instant("pressure_step", cat="pressure", direction="down", level=level,
                              stage=self.LADDER[release_idx])
            obs_events.emit("pressure_step", direction="down", level=level,
                            stage=self.LADDER[release_idx])
            self._release(release_idx)

    def _engage(self, idx: int) -> None:
        stage = self.LADDER[idx]
        try:
            if stage == "spec_backoff":
                with self._lock:
                    ctrls = list(self._spec_ctrls)
                for c in ctrls:
                    c.pressure_backoff()
                if ctrls:
                    with self._lock:
                        self.spec_backoffs += len(ctrls)
            elif stage == "cache_shrink":
                from flexible_llm_sharding_tpu_torch.runtime import hostcache

                prev = hostcache.apply_pressure_cap(self.pcfg.cache_shrink_frac)
                if prev is not None:
                    with self._lock:
                        self._saved_cache_budget = prev
                        self.cache_shrinks += 1
            elif stage == "adapter_evict":
                from flexible_llm_sharding_tpu_torch.adapters import loader

                prev = loader.apply_pressure_cap(self.pcfg.cache_shrink_frac)
                if prev is not None:
                    with self._lock:
                        self._saved_adapter_budget = prev
                        self.adapter_evictions += 1
            elif stage == "kv_evict":
                from flexible_llm_sharding_tpu_torch.runtime import kvpool

                n = kvpool.process_pressure_evict()
                if n:
                    with self._lock:
                        self.kv_evictions += n
            elif stage == "pin_evict":
                from flexible_llm_sharding_tpu_torch.runtime import residency

                tier = residency.process_tier()
                if tier is not None:
                    n = tier.pressure_unpin()
                    if n:
                        with self._lock:
                            self.pin_evictions += n
            elif stage == "shed":
                with self._lock:
                    queues = list(self._queues)
                for q in queues:
                    q.set_shedding(self.pcfg.shed_retry_after_s, on_shed=self.note_shed)
            else:  # replica_drain
                with self._lock:
                    fleet = self._fleet
                if fleet is not None:
                    n = fleet.pressure_drain(keep=1)
                    if n:
                        with self._lock:
                            self.replica_drains += n
        except Exception:  # noqa: BLE001 — a lever on a component in teardown: the level holds
            with self._lock:
                self.lever_errors += 1

    def _release(self, idx: int) -> None:
        stage = self.LADDER[idx]
        try:
            if stage == "spec_backoff":
                with self._lock:
                    ctrls = list(self._spec_ctrls)
                for c in ctrls:
                    c.pressure_restore()
                if ctrls:
                    with self._lock:
                        self.spec_restores += len(ctrls)
            elif stage == "cache_shrink":
                from flexible_llm_sharding_tpu_torch.runtime import hostcache

                with self._lock:
                    restore, self._saved_cache_budget = self._saved_cache_budget, None
                hostcache.lift_pressure_cap(restore)
            elif stage == "adapter_evict":
                from flexible_llm_sharding_tpu_torch.adapters import loader

                with self._lock:
                    restore, self._saved_adapter_budget = self._saved_adapter_budget, None
                loader.lift_pressure_cap(restore)
            elif stage == "kv_evict":
                from flexible_llm_sharding_tpu_torch.runtime import kvpool

                kvpool.process_pressure_restore()
            elif stage == "pin_evict":
                from flexible_llm_sharding_tpu_torch.runtime import residency

                tier = residency.process_tier()
                if tier is not None:
                    tier.pressure_restore()
            elif stage == "shed":
                with self._lock:
                    queues = list(self._queues)
                for q in queues:
                    q.clear_shedding()
            else:  # replica_drain
                with self._lock:
                    fleet = self._fleet
                if fleet is not None:
                    n = fleet.pressure_restore()
                    if n:
                        with self._lock:
                            self.replica_restores += n
        except Exception:  # noqa: BLE001 — a failed restore must not wedge the lower levels
            with self._lock:
                self.lever_errors += 1

    def stats(self) -> dict:
        """The JAX controller's counters and last readings, plus the
        port's ``sample_errors`` and ``lever_errors``."""
        with self._lock:
            snap = self._last
            out = {
                "level": self.level,
                "steps_up": self.steps_up,
                "steps_down": self.steps_down,
                "sheds": self.sheds,
                "spec_backoffs": self.spec_backoffs,
                "spec_restores": self.spec_restores,
                "cache_shrinks": self.cache_shrinks,
                "adapter_evictions": self.adapter_evictions,
                "kv_evictions": self.kv_evictions,
                "pin_evictions": self.pin_evictions,
                "replica_drains": self.replica_drains,
                "replica_restores": self.replica_restores,
                "host_oom_events": self.host_oom_events,
                "disk_full_events": self.disk_full_events,
                "link_events": self.link_events,
                "polls": self.polls,
                "sample_errors": self.sample_errors,
                "lever_errors": self.lever_errors,
            }
        if snap.host_available_bytes is not None:
            out["host_available_bytes"] = snap.host_available_bytes
        if snap.disk_free_bytes is not None:
            out["disk_free_bytes"] = snap.disk_free_bytes
        if snap.hbm_free_frac is not None:
            out["hbm_free_frac"] = round(snap.hbm_free_frac, 4)
        if snap.link_gbps is not None:
            out["link_gbps"] = round(snap.link_gbps, 4)
        return out


# -- the process controller ---------------------------------------------------
# One per process: the engines, the fleet and every executor report into one
# ladder (two private ladders would shrink one cache twice).

_PROCESS_CONTROLLER: BrownoutController | None = None
_PROCESS_MONITOR: PressureMonitor | None = None
_PROCESS_LOCK = threading.Lock()
# Hard events noted in this process, with or without a controller.
_PROCESS_EVENTS = {"host_oom": 0, "disk_full": 0}


def controller_for(cfg, device=None) -> BrownoutController | None:
    """The process controller (None when ``cfg.pressure.enabled`` is off).
    The first enabled caller creates it and starts its monitor, sampling
    ``device`` (default ``cfg.device``); later callers share it, the first
    config's thresholds winning."""
    if not cfg.pressure.enabled:
        return None
    global _PROCESS_CONTROLLER, _PROCESS_MONITOR
    with _PROCESS_LOCK:
        if _PROCESS_CONTROLLER is None:
            ctrl = BrownoutController(cfg)
            _PROCESS_CONTROLLER = ctrl
            _PROCESS_MONITOR = PressureMonitor(cfg, ctrl, device=device).start()
            REGISTRY.register("pressure", ctrl.stats)
        return _PROCESS_CONTROLLER


def process_controller() -> BrownoutController | None:
    with _PROCESS_LOCK:
        return _PROCESS_CONTROLLER


def note_event(kind: str) -> None:
    """Report a hard resource failure: journaled (a ``pressure_event`` whose
    ``resource`` is the kind, whether or not the ladder is on), counted for
    the process (see :func:`process_events`) and handed to the process
    controller, if any. Unknown kinds are dropped."""
    if kind not in _PROCESS_EVENTS:
        return
    obs_events.emit("pressure_event", resource=kind)
    with _PROCESS_LOCK:
        _PROCESS_EVENTS[kind] += 1
    ctrl = process_controller()
    if ctrl is not None:
        ctrl.note_event(kind)


def process_events() -> dict[str, int]:
    """Hard events noted in this process since the last reset."""
    with _PROCESS_LOCK:
        return dict(_PROCESS_EVENTS)


def reset_process_pressure() -> None:
    """Stop the monitor, release every engaged level, drop the process
    controller and zero the process event counts (tests)."""
    global _PROCESS_CONTROLLER, _PROCESS_MONITOR
    with _PROCESS_LOCK:
        ctrl, _PROCESS_CONTROLLER = _PROCESS_CONTROLLER, None
        mon, _PROCESS_MONITOR = _PROCESS_MONITOR, None
        for k in _PROCESS_EVENTS:
            _PROCESS_EVENTS[k] = 0
    if mon is not None:
        mon.close()
    if ctrl is not None:
        while ctrl.level > 0:
            with ctrl._lock:
                idx = ctrl.level - 1
                ctrl.level -= 1
            ctrl._release(idx)
    REGISTRY.unregister("pressure")


__all__ = [
    "BrownoutController",
    "DiskFullError",
    "HostOOMError",
    "PressureMonitor",
    "PressureSnapshot",
    "SIGNALS",
    "controller_for",
    "hbm_free_frac",
    "note_event",
    "process_controller",
    "process_events",
    "reset_process_pressure",
]
