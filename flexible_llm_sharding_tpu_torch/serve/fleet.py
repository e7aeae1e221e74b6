"""The replica fleet: N serving engines behind a shard-phase router (the JAX
package's ``serve/fleet.py``).

N ``ServeEngine`` replicas run as threads of one process on one device,
sharing the process host shard cache, the prefix-KV pool and the adapter
store, one sweep scheduler (tenant limits and fairness are fleet-wide) and
one request WAL. The fleet presents the single engine's surface
(``submit``, ``submit_request``, ``drain``, ``shutdown``,
``shutdown_for_restart``, ``stats`` with ``tokens_served``, ``error``,
``kv_pool``, ``queue_depth``), so the serve CLI and the WAL replay drive
either. Its contracts:

- **Dispatch** goes to the replica the ``Router`` ranks first
  (``serve/router.py``): nearest its next shard-0 admission point, least
  loaded.
- **Exactly-once re-dispatch.** Every fleet request keeps one
  ``dispatch_id``. A request orphaned by a dying replica (``WaveAborted``,
  a ``ServeClosed`` cancellation, an engine-fatal error, or a reclaim from a
  wedged engine) is dispatched to a surviving replica once more, never
  dropped and never served twice: the caller's future is first-wins, and
  an outcome of an attempt the fleet abandoned is counted as
  ``stale_results`` and discarded. The new replica prefills it again from
  its prompt; greedy decode over the same weights gives the same tokens.
  An orphan whose deadline passed resolves EXPIRED instead.
- **Health.** A monitor thread polls every replica each
  ``router_health_poll_s``: an engine-fatal ``error``, or a busy sweep whose
  watermark stalled past ``watchdog_abort_s``, hard-fails the replica
  (reclaim, re-dispatch, recycle the slot with a fresh engine);
  ``engine_recoveries`` at ``router_drain_recoveries`` drains it (no new
  dispatch, in-flight work finishes, then recycle).
- **Elastic join and leave**: ``add_replica``; ``remove_replica(drain=True)``
  by the drain path, ``drain=False`` by the hard-fail path. The last serving
  replica is never removed.
- **Elasticity and phase** (``serve/autoscale.py``, ``ServeConfig.
  autoscale``): the autoscaler grows and drains the fleet; the stagger
  controller holds replicas at their shard-0 boundary to spread their
  phases.

Replica chaos (``faults/inject.py``): one injector for the whole fleet
draws ``replica_kill`` and ``replica_stall`` at every shard step of every
replica (``ServeEngine.fleet_hook``). ``replica_kill`` raises the
engine-fatal ``ReplicaKilled`` inside the victim's sweep; ``replica_stall``
wedges its thread until the fleet releases it, at hard-fail or shutdown.
Each site's schedule is deterministic in its call count; which replica
takes a draw depends on the threads' interleaving. The other sites fire in
each replica's engine, from its own injector.

Brownout (``runtime/pressure.py``): with ``FrameworkConfig.pressure`` the
fleet attaches itself to the process controller, whose ``replica_drain``
rung drains the fleet to one replica (``pressure_drain``) and whose release
restores it (``pressure_restore``); the autoscaler's interlock reads the
same controller. Each replica's engine sheds through its own queue.

On a card, the replicas' threads share one CUDA context: each launches on
its own thread's current stream of the fleet's device, and every sweep runs
eager (a capture in progress at a shard step raises). A replica released
from a stall goes on running its sweep while its successor serves; its
requests were reclaimed, so none of its outcomes counts. A retired engine
whose thread outlives its shutdown's timeout is joined again at the
fleet's shutdown, so a shutdown that returns True leaves no thread.

Observability, as in the JAX fleet: the process registry carries the
fleet's sources (``router``, the shared ``sched``, ``autoscale``, the
stagger controller's ``fleet`` and one ``replica<idx>`` per engine, whose
own sources stay out of the process registry's bare names), served by the
fleet's endpoint at ``ServeConfig.metrics_port``; replica death, drains,
recycles and re-dispatches are trace instants and journal events, the chaos
sites' ``replica_kill`` and ``replica_stall`` trace instants. :meth:`stats`
carries the same sources as the stats line.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

import torch

from flexible_llm_sharding_tpu_torch.config import (
    AutoscaleConfig,
    FrameworkConfig,
    ServeConfig,
    resolve_device,
)
from flexible_llm_sharding_tpu_torch.faults.inject import FaultInjector, InjectedFault
from flexible_llm_sharding_tpu_torch.obs import events as obs_events
from flexible_llm_sharding_tpu_torch.obs import incident as obs_incident
from flexible_llm_sharding_tpu_torch.obs import trace as obs_trace
from flexible_llm_sharding_tpu_torch.obs.registry import REGISTRY, MetricsServer
from flexible_llm_sharding_tpu_torch.runtime import pressure
from flexible_llm_sharding_tpu_torch.serve.autoscale import FleetAutoscaler, StaggerController
from flexible_llm_sharding_tpu_torch.serve.engine import ServeEngine
from flexible_llm_sharding_tpu_torch.serve.request import (
    DeadlineExceeded,
    Request,
    RequestStatus,
    RestartPending,
    ServeClosed,
    WaveAborted,
)
from flexible_llm_sharding_tpu_torch.serve.router import Router
from flexible_llm_sharding_tpu_torch.serve.sched import (
    INTERACTIVE,
    SweepScheduler,
    class_deadline_s,
    parse_class,
)
from flexible_llm_sharding_tpu_torch.serve.wal import wal_for
from flexible_llm_sharding_tpu_torch.utils.metrics import RouterMetrics


class ReplicaKilled(RuntimeError):
    """Chaos ``replica_kill``: the whole engine dies mid-sweep. Engine-fatal
    (outside the engine's recoverable family): the fleet hard-fails the
    replica and re-dispatches its requests."""


class _Replica:
    """One engine slot. ``state`` (under the fleet's lock): serving ->
    draining | removing -> dead. ``release`` frees a chaos-stalled worker
    thread."""

    def __init__(self, idx: int, engine: ServeEngine, stagger=None):
        self.idx = idx
        self.engine = engine
        self.state = "serving"
        self.release = threading.Event()
        self.stagger = stagger
        # The replica's registry source (``replica<idx>``), kept for the
        # identity-checked unregister.
        self.source = engine.metrics.registry.collect

    @property
    def serving(self) -> bool:
        return self.state == "serving"

    def snapshot(self) -> dict:
        """The router's inputs (lock-free engine reads); ``hold_frac`` is a
        pending stagger hold in sweep fractions."""
        eng = self.engine
        return {
            "boundary_frac": eng.sweep_position()["boundary_frac"],
            "hold_frac": self.stagger.hold_frac(self.idx) if self.stagger is not None else 0.0,
            "queue_depth": len(eng.queue),
            "active": eng.batcher.active_requests,
            "max_active": eng.serve_cfg.max_active_requests,
        }


@dataclasses.dataclass
class _Dispatch:
    """One caller request: the caller's ``outer`` request, the current
    engine-side ``inner`` attempt and its replica, and the attempt count
    (2 is final)."""

    outer: Request
    inner: Request | None = None
    replica: _Replica | None = None
    attempts: int = 0


class ReplicaFleet:
    """N ``ServeEngine`` replicas, the router and the health monitor.
    ``device`` defaults to ``cfg.device`` (``resolve_device``); every
    replica's engine runs on it."""

    def __init__(self, cfg: FrameworkConfig, serve_cfg: ServeConfig | None = None, tokenizer=None,
                 device: torch.device | None = None, start: bool = True):
        self.cfg = cfg
        self.serve_cfg = serve_cfg or ServeConfig()
        self._tokenizer = tokenizer
        self._device = device if device is not None else resolve_device(cfg.device)
        # The replicas' own config: one engine each, no elasticity of their
        # own, and no endpoint of their own: the fleet serves the one
        # process-registry endpoint, which mirrors every replica's sources.
        self._engine_cfg = dataclasses.replace(self.serve_cfg, replicas=1, metrics_port=None,
                                               autoscale=AutoscaleConfig())
        # One WAL for every replica: a recycled replica keeps the log, and
        # one replay at the next start covers the fleet.
        self._wal = wal_for(self.serve_cfg)
        self.metrics = RouterMetrics()
        self.router = Router(self.serve_cfg.router_phase_weight,
                             self.serve_cfg.router_depth_weight)
        self._injector = FaultInjector.from_config(cfg.faults)
        self._lock = threading.Lock()
        self._replicas: list[_Replica] = []  # guarded by: _lock
        self._dispatches: dict[int, _Dispatch] = {}  # guarded by: _lock
        self._pending: deque[_Dispatch] = deque()  # guarded by: _lock
        self._retired: list[ServeEngine] = []  # guarded by: _lock
        self._retired_stats: dict[str, dict] = {}  # guarded by: _lock
        self._closed = False  # guarded by: _lock
        self._next_idx = 0  # guarded by: _lock
        self._error: BaseException | None = None
        # Tokens of the caller requests resolved (not of abandoned attempts).
        self._tokens_served = 0  # guarded by: _lock
        self._started = False
        # Tracing and the flight recorder, armed before the replicas build.
        obs_trace.ensure_configured(cfg)
        obs_events.ensure_configured(cfg)
        obs_incident.ensure_configured(cfg, self.serve_cfg)
        # The process brownout controller (None unless cfg.pressure.enabled):
        # its replica_drain rung drains this fleet, and the autoscaler's
        # interlock reads it.
        self._pressure = pressure.controller_for(cfg, self._device)
        if self._pressure is not None:
            self._pressure.attach_fleet(self)
        # One scheduler for every replica: per-replica buckets would
        # multiply each tenant's rate by the replica count.
        self._sched = (SweepScheduler(self.serve_cfg.sched) if self.serve_cfg.sched.enabled
                       else None)
        # The fleet's process-registry sources; the bound methods are kept
        # for the identity-checked unregister at shutdown.
        self._sources: dict[str, object] = {}
        if self._sched is not None:
            self._register("sched", self._sched.stats)
        auto_cfg = self.serve_cfg.autoscale
        # Built before the replicas: each replica's fleet_hook reads it.
        self._stagger = (StaggerController(auto_cfg) if auto_cfg.enabled and auto_cfg.stagger
                         else None)
        if self._stagger is not None:
            self._register("fleet", self._stagger.stats)
        self._autoscaler: FleetAutoscaler | None = None
        self._register("router", self.metrics.snapshot)
        self.metrics_server = (MetricsServer(REGISTRY, port=self.serve_cfg.metrics_port)
                               if self.serve_cfg.metrics_port is not None else None)
        try:
            for _ in range(self.serve_cfg.replicas):
                rep = self._mk_replica(start=start)
                with self._lock:
                    self._replicas.append(rep)
        except BaseException:
            self.shutdown(drain=False, timeout=1.0)
            raise
        if auto_cfg.enabled:
            # With a WAL, the first decision waits for the replay
            # (mark_replay_complete).
            self._autoscaler = FleetAutoscaler(self, auto_cfg, replay_pending=self._wal is not None)
            self._register("autoscale", self._autoscaler.stats)
        self._stop = threading.Event()
        self._monitor = threading.Thread(target=self._monitor_loop, name="fleet-monitor",
                                         daemon=True)
        if start:
            self._started = True
            self._monitor.start()
            if self._autoscaler is not None:
                self._autoscaler.start()

    # -- lifecycle ---------------------------------------------------------

    def _register(self, name: str, source) -> None:
        self._sources[name] = source
        REGISTRY.register(name, source)

    def _close_surfaces(self) -> None:
        """The endpoint and every process-registry source of the fleet."""
        if self.metrics_server is not None:
            self.metrics_server.close()
        for name, source in self._sources.items():
            REGISTRY.unregister_if(name, source)

    def start(self) -> "ReplicaFleet":
        if not self._started:
            self._started = True
            with self._lock:
                replicas = list(self._replicas)
            for rep in replicas:
                rep.engine.start()
            self._monitor.start()
            if self._autoscaler is not None:
                self._autoscaler.start()
        return self

    def __enter__(self) -> "ReplicaFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=exc == (None, None, None))

    @property
    def error(self) -> BaseException | None:
        """A fleet-fatal error (the monitor's). A replica's engine fault is
        not one: the surviving replicas absorb it."""
        return self._error

    @property
    def replicas(self) -> list[int]:
        """The serving replicas' indices."""
        with self._lock:
            return [r.idx for r in self._replicas if r.serving]

    def drain(self, timeout: float | None = None) -> bool:
        return self.shutdown(drain=True, timeout=timeout)

    def _close_front(self, err: BaseException) -> None:
        """Stop the autoscaler and the monitor, refuse new work, and fail
        the parked dispatches with ``err``."""
        # The autoscaler first: a scale decision must not race the teardown.
        if self._autoscaler is not None:
            self._autoscaler.close()
        with self._lock:
            self._closed = True
            pending = list(self._pending)
            self._pending.clear()
        for disp in pending:
            self._finish_error(disp, err, RequestStatus.CANCELLED)
        if self._started:
            self._stop.set()
            self._monitor.join(timeout=5.0)

    def _join_retired(self, timeout: float | None) -> bool:
        with self._lock:
            retired, self._retired = self._retired, []
        ok = True
        for eng in retired:
            ok = eng.shutdown(drain=False, timeout=timeout) and ok
        return ok

    def shutdown(self, drain: bool = True, timeout: float | None = None) -> bool:
        """Stop every replica (serving out what is queued and in flight with
        ``drain``) and join every thread the fleet started. Returns whether
        all ended within ``timeout`` each."""
        if self._pressure is not None:
            self._pressure.detach_fleet(self)
        self._close_front(ServeClosed("replica fleet shut down before dispatch"))
        # After the monitor stopped: a recycle racing the shutdown could
        # otherwise add an engine this loop never sees.
        with self._lock:
            replicas = list(self._replicas)
        ok = True
        for rep in replicas:
            rep.release.set()  # free a chaos-stalled thread
            ok = rep.engine.shutdown(drain=drain, timeout=timeout) and ok
            REGISTRY.unregister_if(f"replica{rep.idx}", rep.source)
        self._close_surfaces()
        return self._join_retired(timeout) and ok

    def shutdown_for_restart(self, timeout: float | None = None) -> bool:
        """The fleet's graceful restart: every replica parks its work in the
        shared WAL at its next sweep boundary, parked dispatches resolve
        ``RestartPending`` (open in the WAL), and the next start's replay
        serves all of it. Without a WAL this is ``shutdown(drain=False)``."""
        if self._wal is None:
            return self.shutdown(drain=False, timeout=timeout)
        if self._pressure is not None:
            self._pressure.detach_fleet(self)
        self._close_front(RestartPending("replica fleet restarting; request parked for replay"))
        with self._lock:
            replicas = list(self._replicas)
        ok = True
        for rep in replicas:
            rep.release.set()
            ok = rep.engine.shutdown_for_restart(timeout=timeout) and ok
            REGISTRY.unregister_if(f"replica{rep.idx}", rep.source)
        self._close_surfaces()
        return self._join_retired(timeout) and ok

    # -- replica lifecycle -------------------------------------------------

    def _mk_replica(self, start: bool = True) -> _Replica:
        """Build one engine slot (outside the fleet's lock: it reads the
        checkpoint's config)."""
        # No process mirrors of the engine's own sources: with N replicas
        # the bare names would expose one arbitrary replica; the
        # replica<idx> source below is the mirror.
        engine = ServeEngine(self.cfg, self._engine_cfg, tokenizer=self._tokenizer,
                             device=self._device, start=False, scheduler=self._sched,
                             wal=self._wal, process_metrics_mirror=False)
        with self._lock:
            idx = self._next_idx
            self._next_idx += 1
        rep = _Replica(idx, engine, stagger=self._stagger)
        if self._injector is not None or self._stagger is not None or engine.device.type == "cuda":
            engine.fleet_hook = lambda shard_pos, rep=rep: self._fleet_step(rep, shard_pos)
        REGISTRY.register(f"replica{idx}", rep.source)
        if start:
            engine.start()
        return rep

    def add_replica(self) -> int:
        """Elastic join: one more engine, routed to from now on. Returns its
        index."""
        rep = self._mk_replica(start=self._started)
        with self._lock:
            closed = self._closed
            if not closed:
                self._replicas.append(rep)
        if closed:
            rep.engine.shutdown(drain=False, timeout=1.0)
            REGISTRY.unregister_if(f"replica{rep.idx}", rep.source)
            raise ServeClosed("replica fleet is shut down")
        self.metrics.count("replicas_added")
        obs_trace.instant("replica_added", cat="fleet", replica=rep.idx)
        if self._stagger is not None:
            self._stagger.note_membership_change()
        self._flush_pending()
        return rep.idx

    def remove_replica(self, idx: int | None = None, drain: bool = True,
                       timeout: float | None = 60.0) -> bool:
        """Elastic leave. ``drain=True``: no new dispatch, the queued and
        in-flight work is served out, then the engine retires; blocks up to
        ``timeout`` and returns whether it retired. ``drain=False``: hard-fail
        now (its requests re-dispatch). ``idx=None`` picks any serving
        replica. Refuses to remove the last serving one."""
        with self._lock:
            live = [r for r in self._replicas if r.serving]
            target = next((r for r in live if idx is None or r.idx == idx), None)
            if target is None:
                raise ValueError(f"no serving replica {'(any)' if idx is None else idx} to "
                                 f"remove (serving: {[r.idx for r in live]})")
            if len(live) <= 1:
                raise ValueError("cannot remove the last serving replica")
            # Claimed with the check, atomically: two racing removals on two
            # replicas must not both pass it.
            target.state = "removing"
        if not drain:
            self._hard_fail(target, "removed without drain")
            return True
        obs_trace.instant("replica_drain", cat="fleet", replica=target.idx, remove=True)
        obs_events.emit("replica_drain", replica=target.idx, remove=True)
        deadline = time.monotonic() + timeout if timeout is not None else None
        while True:
            with self._lock:
                if target not in self._replicas:
                    return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(min(self.serve_cfg.router_health_poll_s, 0.05))

    def _start_drain(self, rep: _Replica) -> None:
        """The monitor's drain of a flaky replica (then recycled)."""
        with self._lock:
            if rep.state != "serving":
                return
            rep.state = "draining"
        obs_trace.instant("replica_drain", cat="fleet", replica=rep.idx, remove=False)
        obs_events.emit("replica_drain", replica=rep.idx, remove=False)

    def _retire(self, rep: _Replica, drain: bool, timeout: float) -> None:
        """Shut a replica's engine down, keep its last stats, and keep the
        engine for the fleet's shutdown if its thread did not end."""
        ended = rep.engine.shutdown(drain=drain, timeout=timeout)
        REGISTRY.unregister_if(f"replica{rep.idx}", rep.source)
        stats = {"state": "dead", **rep.engine.stats()}
        with self._lock:
            self._retired_stats[str(rep.idx)] = stats
            if not ended:
                self._retired.append(rep.engine)

    def _complete_drain(self, rep: _Replica) -> None:
        """The monitor, once a draining replica is idle: retire it, then
        recycle the slot or drop it."""
        with self._lock:
            removing = rep.state == "removing"
            rep.state = "dead"
        self._retire(rep, drain=True, timeout=30.0)
        self.metrics.count("replicas_drained")
        obs_trace.instant("replica_drained", cat="fleet", replica=rep.idx)
        if removing:
            self._drop(rep)
        else:
            self._recycle(rep)

    def _hard_fail(self, rep: _Replica, reason: str) -> None:
        """A dead replica: reclaim what it holds, re-dispatch each request
        once, retire the engine, recycle the slot (or drop it when it was
        being removed)."""
        with self._lock:
            if rep.state == "dead":
                return
            removing = rep.state == "removing"
            rep.state = "dead"
        self.metrics.count("replicas_dead")
        obs_trace.instant("replica_dead", cat="fleet", replica=rep.idx, reason=reason)
        obs_events.emit("replica_dead", replica=rep.idx, reason=reason)
        rep.release.set()  # free a chaos-stalled thread so it can end
        orphans = rep.engine.reclaim_inflight()
        self._retire(rep, drain=False, timeout=2.0)
        for inner in orphans:
            self._handle_orphan(inner)
        if removing:
            self._drop(rep)
        else:
            self._recycle(rep)

    def _recycle(self, rep: _Replica) -> None:
        """Replace a dead or drained slot with a fresh engine (the shared
        host shard cache serves its weights)."""
        with self._lock:
            if self._closed:
                if rep in self._replicas:
                    self._replicas.remove(rep)
                return
        new = self._mk_replica(start=self._started)
        with self._lock:
            # Closed while the engine was built: adding it now would leak a
            # running engine no teardown sees.
            aborted = self._closed
            if not aborted:
                if rep in self._replicas:
                    self._replicas[self._replicas.index(rep)] = new
                else:
                    self._replicas.append(new)
            elif rep in self._replicas:
                self._replicas.remove(rep)
        if aborted:
            new.engine.shutdown(drain=False, timeout=1.0)
            REGISTRY.unregister_if(f"replica{new.idx}", new.source)
            return
        self.metrics.count("replicas_recycled")
        if self._stagger is not None:
            self._stagger.forget(rep.idx)
            self._stagger.note_membership_change()
        obs_trace.instant("replica_recycled", cat="fleet", replica=rep.idx, new_replica=new.idx)
        obs_events.emit("replica_recycled", replica=rep.idx, new_replica=new.idx)
        self._flush_pending()

    def _drop(self, rep: _Replica) -> None:
        with self._lock:
            if rep in self._replicas:
                self._replicas.remove(rep)
        self.metrics.count("replicas_removed")
        if self._stagger is not None:
            self._stagger.forget(rep.idx)
            self._stagger.note_membership_change()

    # -- brownout levers -----------------------------------------------------

    def pressure_drain(self, keep: int = 1) -> int:
        """Drain all but ``keep`` (at least 1) serving replicas through the
        drain path and drop them instead of recycling (the brownout ladder's
        ``replica_drain`` rung). Non-blocking; returns how many were
        marked."""
        marked: list[int] = []
        with self._lock:
            for rep in [r for r in self._replicas if r.serving][max(keep, 1):]:
                rep.state = "removing"
                marked.append(rep.idx)
        for idx in marked:
            obs_trace.instant("replica_drain", cat="fleet", replica=idx, remove=True,
                              pressure=True)
            obs_events.emit("replica_drain", replica=idx, remove=True, pressure=True)
        return len(marked)

    def pressure_restore(self) -> int:
        """Add replicas back up to :meth:`population_target`. Returns how
        many were added (0 when nothing was drained or after shutdown)."""
        restored = 0
        while True:
            target = self.population_target()
            with self._lock:
                if self._closed:
                    return restored
                deficit = target - sum(1 for r in self._replicas if r.serving)
            if deficit <= 0:
                return restored
            try:
                self.add_replica()
            except ServeClosed:
                return restored
            restored += 1

    # -- the per-shard-step hook ---------------------------------------------

    def _fleet_step(self, rep: _Replica, shard_pos: int) -> None:
        """``engine.fleet_hook``, on the replica's worker thread at every
        shard step: the stagger hold at shard 0 (the only point where no
        wave is mid-flight), then the chaos sites."""
        if rep.engine.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a CUDA graph capture is in progress on a serve replica's stream: "
                               "the serve sweep runs eager, and N replicas launch at once")
        if self._stagger is not None and shard_pos == 0:
            hold = self._stagger.on_boundary(rep.idx, time.monotonic())
            if hold > 0.0:
                self._hold_at_boundary(rep, hold)
        if self._injector is not None:
            self._chaos_step(rep, shard_pos)

    def _hold_at_boundary(self, rep: _Replica, hold: float) -> None:
        """Park the worker thread at its boundary, under a quarter of the
        liveness timeout (a hold never reads as a stall), in slices the
        replica's release interrupts."""
        if self.serve_cfg.watchdog_abort_s > 0:
            hold = min(hold, self.serve_cfg.watchdog_abort_s / 4.0)
        deadline = time.monotonic() + hold
        while True:
            left = deadline - time.monotonic()
            if left <= 0 or rep.release.wait(min(left, 0.05)):
                break

    def _chaos_step(self, rep: _Replica, shard_pos: int) -> None:
        """``replica_kill`` raises the engine-fatal ``ReplicaKilled``;
        ``replica_stall`` wedges this thread until the monitor declares the
        replica dead (or the fleet shuts down) and releases it."""
        inj = self._injector
        try:
            inj.fire("replica_kill", detail=f"replica{rep.idx} shard{shard_pos}")
        except InjectedFault as e:
            obs_trace.instant("replica_kill", cat="fleet", replica=rep.idx, shard_idx=shard_pos)
            raise ReplicaKilled(
                f"chaos replica_kill: replica {rep.idx} died at shard {shard_pos}") from e
        try:
            inj.fire("replica_stall", detail=f"replica{rep.idx} shard{shard_pos}")
        except InjectedFault:
            obs_trace.instant("replica_stall", cat="fleet", replica=rep.idx, shard_idx=shard_pos)
            rep.release.wait()

    # -- dispatch ------------------------------------------------------------

    def submit(self, prefix: str, suffixes, max_new_tokens: int | None = None,
               deadline_s: float | None = None, callback=None, slo_class: str | None = None,
               tenant_id: str | None = None, adapter_id: str | None = None,
               client_id=None) -> Request:
        """``ServeEngine.submit``'s surface: the returned request resolves
        from whichever replica serves it."""
        slo = parse_class(slo_class)
        if deadline_s is None:
            deadline_s = class_deadline_s(self.serve_cfg.sched, slo)
        if deadline_s is None and self.serve_cfg.default_deadline_s > 0:
            deadline_s = self.serve_cfg.default_deadline_s
        req = Request(
            prefix=prefix,
            suffixes=tuple(suffixes),
            max_new_tokens=(max_new_tokens if max_new_tokens is not None
                            else self.serve_cfg.default_max_new_tokens),
            deadline=(time.monotonic() + deadline_s
                      if deadline_s is not None and deadline_s > 0 else None),
            callback=callback,
            slo_class=slo,
            tenant_id=tenant_id if tenant_id is not None else "default",
            adapter_id=adapter_id,
            client_id=client_id,
        )
        return self.submit_request(req)

    def submit_request(self, req: Request) -> Request:
        """Enqueue a request built by the caller (the WAL replay: its
        ``wal_id`` passes to the first attempt, whose admission record
        reopens it)."""
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        req.dispatch_id = req.request_id
        disp = _Dispatch(outer=req)
        with self._lock:
            closed = self._closed
            if not closed:
                self._dispatches[req.request_id] = disp
        if closed:
            req.fail(ServeClosed("replica fleet is shut down"), RequestStatus.CANCELLED)
            return req
        self._dispatch(disp)
        return req

    def _dispatch(self, disp: _Dispatch, redispatch: bool = False) -> None:
        outer = disp.outer
        if outer.expired():
            # Its first-token deadline is lost: never served late.
            if redispatch:
                self.metrics.count("expired_orphans")
            self._finish_error(disp, DeadlineExceeded(
                f"request {outer.request_id} deadline passed before "
                f"{'re-' if redispatch else ''}dispatch"), RequestStatus.EXPIRED)
            return
        failed_on = disp.replica if redispatch else None
        with self._lock:
            if self._closed:
                choice, replica = "closed", None
            else:
                # Interactive work weighs boundary proximity harder.
                bias = (self.serve_cfg.sched.interactive_phase_boost
                        if self.serve_cfg.sched.enabled and outer.slo_class == INTERACTIVE
                        else 1.0)
                replica = self.router.pick(self._replicas, exclude=failed_on, phase_bias=bias)
                if replica is None:
                    # No replica serves right now: parked until the monitor
                    # recycles one.
                    self._pending.append(disp)
                    choice = "parked"
                else:
                    choice = "dispatched"
                    prev = disp.inner
                    inner = Request(
                        prefix=outer.prefix,
                        suffixes=outer.suffixes,
                        max_new_tokens=outer.max_new_tokens,
                        deadline=outer.deadline,
                        callback=self._inner_terminal,
                        dispatch_id=outer.request_id,
                        # Work accepted once is not rate-limited again.
                        shed_exempt=redispatch,
                        slo_class=outer.slo_class,
                        tenant_id=outer.tenant_id,
                        adapter_id=outer.adapter_id,
                        # One WAL id for every attempt: a re-dispatch reopens
                        # it, a replayed request's first attempt inherits it.
                        wal_id=prev.wal_id if prev is not None else outer.wal_id,
                        client_id=outer.client_id,
                    )
                    disp.inner = inner
                    disp.replica = replica
                    disp.attempts += 1
        if choice == "closed":
            self._finish_error(disp, ServeClosed("replica fleet is shut down"),
                               RequestStatus.CANCELLED)
            return
        if choice == "parked":
            return
        self.metrics.count("redispatches" if redispatch else "dispatches")
        if redispatch:
            obs_trace.instant("redispatch", cat="fleet", request_id=outer.request_id,
                              replica=replica.idx)
            obs_events.emit("redispatch", request_id=outer.request_id, replica=replica.idx,
                            attempts=disp.attempts)
        # Outside the lock: a synchronous rejection re-enters _inner_terminal.
        replica.engine.submit_request(inner)

    def _flush_pending(self) -> None:
        with self._lock:
            batch = list(self._pending)
            self._pending.clear()
        for disp in batch:
            # An attempt already made failed on a replica: this is its re-dispatch.
            self._dispatch(disp, redispatch=disp.attempts >= 1)

    # -- terminal outcomes -------------------------------------------------

    def _inner_terminal(self, inner: Request) -> None:
        """Each attempt's callback: map its outcome to the caller's request
        through the dispatch id, discarding abandoned attempts'."""
        did = inner.dispatch_id
        with self._lock:
            disp = self._dispatches.get(did) if did is not None else None
            stale = disp is None or disp.inner is not inner
            replica = disp.replica if not stale else None
            attempts = disp.attempts if not stale else 0
        if stale:
            self.metrics.count("stale_results")
            return
        if inner.status is RequestStatus.DONE:
            self._finish_result(disp, inner)
            return
        err = inner.future.exception(timeout=0)
        if inner.status is RequestStatus.EXPIRED:
            self._finish_error(disp, err, RequestStatus.EXPIRED)
            return
        # Orphaned by its replica (a wave abort, a cancellation under a
        # recycle, an engine gone fatal), or failed on its own account (a
        # rejection, a malformed prompt), which propagates.
        orphaned = isinstance(err, (WaveAborted, ServeClosed, ReplicaKilled)) or (
            replica is not None and replica.engine.error is not None)
        if orphaned and attempts == 1:
            self._dispatch(disp, redispatch=True)
        else:
            self._finish_error(disp, err, inner.status)

    def _handle_orphan(self, inner: Request) -> None:
        """A request reclaimed from a dead replica: re-dispatched once, or
        failed when this was the re-dispatch."""
        did = inner.dispatch_id
        with self._lock:
            disp = self._dispatches.get(did) if did is not None else None
            stale = disp is None or disp.inner is not inner
            attempts = disp.attempts if not stale else 0
        if stale:
            self.metrics.count("stale_results")
            return
        if attempts == 1:
            self._dispatch(disp, redispatch=True)
        else:
            self._finish_error(disp, inner.future.exception(timeout=0), RequestStatus.FAILED)

    def _finish_result(self, disp: _Dispatch, inner: Request) -> None:
        with self._lock:
            self._dispatches.pop(disp.outer.request_id, None)
        outer = disp.outer
        # TTFT and latency count from the caller's submission.
        outer.admitted_at = inner.admitted_at
        outer.first_token_at = inner.first_token_at
        res = inner.future.result(timeout=0)
        if outer.resolve(res.scores, res.updated, res.tokens):
            with self._lock:
                self._tokens_served += inner.tokens_emitted

    def _finish_error(self, disp: _Dispatch, err: BaseException | None,
                      status: RequestStatus) -> None:
        with self._lock:
            self._dispatches.pop(disp.outer.request_id, None)
        disp.outer.fail(err if err is not None else RuntimeError(
            "request failed with no recorded error"), status)

    # -- health monitor ------------------------------------------------------

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.serve_cfg.router_health_poll_s):
            try:
                self._poll_health()
                self._flush_pending()
            # flscheck: disable=EXC-TAXONOMY: fleet health-monitor daemon: a polling bug must not stop failover for every replica; the error is kept on self._error and surfaced via fleet.error
            except Exception as e:  # a polling bug must not stop failover: kept as the fleet's error
                self._error = e

    def _poll_health(self) -> None:
        now = time.monotonic()
        with self._lock:
            replicas = list(self._replicas)
        serving = 0
        phases: dict[int, float] = {}
        for rep in replicas:
            eng = rep.engine
            if rep.state == "serving":
                serving += 1
                pos = eng.sweep_position()
                if pos["busy"] and pos["n_shards"] > 0:
                    phases[rep.idx] = pos["shard_pos"] / pos["n_shards"]
                stalled = (self.serve_cfg.watchdog_abort_s > 0 and pos["busy"]
                           and now - pos["watermark"] > self.serve_cfg.watchdog_abort_s)
                if eng.error is not None:
                    self._hard_fail(rep, f"engine-fatal: {type(eng.error).__name__}")
                elif stalled:
                    self._hard_fail(rep, f"liveness watermark stalled "
                                         f"{now - pos['watermark']:.1f}s")
                elif (self.serve_cfg.router_drain_recoveries > 0
                      and eng.metrics.counter("engine_recoveries")
                      >= self.serve_cfg.router_drain_recoveries):
                    self._start_drain(rep)
            elif rep.state in ("draining", "removing"):
                if len(eng.queue) == 0 and not eng.batcher.waves:
                    self._complete_drain(rep)
        self.metrics.gauge("replicas_serving", serving)
        self.metrics.gauge("replicas_total", len(replicas))
        if self._stagger is not None:
            self._stagger.observe(phases)
        with self._lock:
            self.metrics.gauge("pending_parked", len(self._pending))

    # -- the autoscaler's surface --------------------------------------------

    def population(self) -> int:
        """Serving replicas (draining and removing ones are leaving)."""
        with self._lock:
            return sum(1 for r in self._replicas if r.serving)

    def serving_engines(self) -> list:
        with self._lock:
            return [r.engine for r in self._replicas if r.serving]

    def drains_in_flight(self) -> int:
        """Replicas draining or being removed: a shrink waits for 0."""
        with self._lock:
            return sum(1 for r in self._replicas if r.state in ("draining", "removing"))

    def queue_frac(self) -> float:
        """Parked and queued requests over the serving replicas' queue
        capacity, at most 1."""
        queued, serving = self._waiting()
        cap = self.serve_cfg.queue_capacity * max(1, serving)
        return min(1.0, queued / max(1, cap))

    def _waiting(self) -> tuple[int, int]:
        """(parked and queued requests, serving replicas)."""
        with self._lock:
            engines = [r.engine for r in self._replicas if r.serving]
            queued = len(self._pending)
        return queued + sum(eng.queue_depth() for eng in engines), len(engines)

    def population_target(self) -> int:
        """The autoscaler's target when it runs, else ``replicas``."""
        auto = self._autoscaler
        if auto is not None:
            return auto.target
        return self.serve_cfg.replicas

    def mark_replay_complete(self) -> None:
        """The WAL replay is done: open the autoscaler's first decision."""
        auto = self._autoscaler
        if auto is not None:
            auto.mark_replay_complete()

    # -- introspection -------------------------------------------------------

    def queue_depth(self) -> int:
        """Requests waiting: parked in the fleet or queued at a serving
        replica."""
        return self._waiting()[0]

    @property
    def kv_pool(self):
        """The process prefix-KV pool every replica leases from (one per
        config, so any replica's), None when it is off or no replica
        exists."""
        with self._lock:
            engines = [r.engine for r in self._replicas]
        return engines[0].kv_pool if engines else None

    def stats(self) -> dict:
        """The fleet's stats line: ``tokens_served`` (the tokens of the
        caller requests resolved; an abandoned attempt's tokens count only
        in its engine's ``tokens_emitted``), the router's counters and
        gauges, the shared scheduler's, the autoscaler's and the stagger
        controller's when on, each replica's engine stats (``replicas``)
        and the last stats of each engine retired since the start
        (``retired``)."""
        with self._lock:
            served = self._tokens_served
        out: dict = {"event": "fleet_stats", "tokens_served": served,
                     "router": self.metrics.snapshot()}
        if self._sched is not None:
            out["sched"] = self._sched.stats()
        if self._autoscaler is not None:
            out["autoscale"] = self._autoscaler.stats()
        if self._stagger is not None:
            out["stagger"] = self._stagger.stats()
        with self._lock:
            replicas = list(self._replicas)
            retired = dict(self._retired_stats)
        out["replicas"] = {str(rep.idx): {"state": rep.state, **rep.engine.stats()}
                           for rep in replicas}
        out["retired"] = retired
        return out


__all__ = ["ReplicaFleet", "ReplicaKilled"]
