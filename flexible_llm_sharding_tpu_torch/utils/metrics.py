"""Counters of the weight stream's fault handling (the JAX package's
``utils/metrics.py`` ``RetryRecorder`` and ``IntegrityRecorder``), the
host's resident memory, the analytic model sizes and device memory that
the decode gates judge residency by (``param_count``,
``weight_bytes_per_chip``, ``chip_hbm_gb``), the serving engine's metrics
(``ServingMetrics``, ``assemble_serve_stats``) and stall watchdog
(``StepWatchdog``), the batch run's structured timing log (``Recorder``,
``--verbose_metrics``), its progress bar (``progress_bar``) and device
profile (``profiler_trace``, ``--profile_dir``)."""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from flexible_llm_sharding_tpu_torch.obs import events as obs_events
from flexible_llm_sharding_tpu_torch.obs import trace as obs_trace


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
    re-read), ``recomputes`` (blocks re-derived from the previous shard
    after a corrupt spill) and ``quarantined_shards``."""

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


def chip_hbm_gb(device=None) -> float | None:
    """Memory of one card in GB (10^9 B): a CUDA device's
    ``total_memory``; None on the CPU, where the decode gates then resolve
    to off (the JAX package's CPU backend reports no HBM either).
    ``device`` None is the current CUDA device when there is one."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory / 1e9


def _arch_walk(cfg):
    """(attention projection parameters per layer, per-layer MoE flags,
    dense MLP width) of a LlamaConfig; MLA counts its q LoRA (or dense q),
    the compressed kv_a, the per-head kv_b and wo over the V head dim."""
    h = cfg.hidden_size
    hd = cfg.head_dim
    q_dim = cfg.num_attention_heads * hd
    kv_dim = cfg.num_key_value_heads * hd
    if cfg.kv_lora_rank:
        q_p = h * cfg.q_lora_rank + cfg.q_lora_rank * q_dim if cfg.q_lora_rank else h * q_dim
        kv_p = h * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) + (
            cfg.kv_lora_rank * cfg.num_attention_heads * (cfg.qk_nope_head_dim + cfg.v_dim))
        attn_proj = q_p + kv_p + cfg.num_attention_heads * cfg.v_dim * h
    else:
        attn_proj = h * q_dim + 2 * h * kv_dim + q_dim * h
    n = cfg.num_hidden_layers
    moe_pattern = cfg.moe_layer_pattern or (
        ((True,) * n) if cfg.num_local_experts else ((False,) * n))
    dense_inter = (cfg.intermediate_size_mlp if cfg.intermediate_size_mlp is not None
                   else cfg.intermediate_size)
    return attn_proj, moe_pattern, dense_inter


def _shared_expert_mult(cfg) -> int:
    """The always-on shared expert's width in routed-expert widths: 0 (none),
    1 (llama4) or ``n_shared_experts`` (deepseek_v3)."""
    if cfg.model_type == "llama4_text":
        return 1
    if cfg.model_type == "deepseek_v3":
        return int(getattr(cfg, "n_shared_experts", 1))
    return 0


def has_moe_layers(cfg) -> bool:
    """Whether any decoder layer of ``cfg`` routes over experts."""
    return any(_arch_walk(cfg)[1])


# Bytes per element at each compute dtype: the factor of every device
# memory gate (resident weights, KV on the card, fused decode).
_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def weight_bytes_per_chip(cfg, dtype: str, n_chips: int = 1) -> float:
    """Parameter bytes per card at the compute dtype: the numerator of the
    resident-decode, KV-on-device and fused-decode gates."""
    return param_count(cfg) * _DTYPE_BYTES[dtype] / max(n_chips, 1)


def param_count(cfg) -> int:
    """Every parameter of a LlamaConfig as placed on the device: every
    expert, the embedding, an untied head, the norms."""
    h = cfg.hidden_size
    attn, moe_pattern, dense_inter = _arch_walk(cfg)
    total = 0
    for is_moe in moe_pattern:
        if is_moe:
            mlp = cfg.num_local_experts * 3 * h * cfg.intermediate_size
            mlp += h * cfg.num_local_experts  # router
            mlp += _shared_expert_mult(cfg) * 3 * h * cfg.intermediate_size
        else:
            mlp = 3 * h * dense_inter
        total += attn + mlp + 2 * h  # + the two norm scale vectors
    total += h * cfg.vocab_size  # embedding
    if not cfg.tie_word_embeddings:
        total += h * cfg.vocab_size  # untied lm_head
    total += h  # final norm
    return int(total)


# SLO class names (``serve/sched/classes.py``'s, in priority order) for the
# per-class latency windows, pre-seeded so every class reports.
SLO_CLASS_NAMES = ("interactive", "standard", "best_effort")

# The registry sources the serve stats line lays out by name; any other
# source appears nested when it carries a nonzero number.
_SERVE_CORE_SOURCES = ("serve", "io_retries", "integrity", "host_cache", "residency")


@dataclass
class Recorder:
    """Append-only structured timing log of one run (the JAX package's):
    events are ``(name, seconds, extra)``; ``summary()`` aggregates by
    name. ``verbose`` prints one JSON line per event to stderr
    (``--verbose_metrics``)."""

    verbose: bool = False
    events: list[tuple[str, float, dict]] = field(default_factory=list)

    def record(self, name: str, seconds: float, **extra) -> None:
        self.events.append((name, seconds, extra))
        if self.verbose:
            print(json.dumps({"event": name, "seconds": round(seconds, 4), **extra}),
                  file=sys.stderr, flush=True)

    @contextlib.contextmanager
    def timed(self, name: str, **extra):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0, **extra)

    def total(self, name: str) -> float:
        return sum(s for n, s, _ in self.events if n == name)

    def summary(self) -> dict[str, dict[str, float]]:
        agg: dict[str, dict[str, float]] = {}
        for name, s, _ in self.events:
            d = agg.setdefault(name, {"count": 0.0, "seconds": 0.0})
            d["count"] += 1
            d["seconds"] += s
        return agg


def _latency_summary(samples: list[float]) -> dict[str, float]:
    """{count, mean, p50, p95, p99, max} in seconds of a sample list."""
    if not samples:
        return {"count": 0}
    arr = np.asarray(samples, np.float64)
    return {
        "count": int(arr.size),
        "mean": round(float(arr.mean()), 4),
        "p50": round(float(np.percentile(arr, 50)), 4),
        "p95": round(float(np.percentile(arr, 95)), 4),
        "p99": round(float(np.percentile(arr, 99)), 4),
        "max": round(float(arr.max()), 4),
    }


def assemble_serve_stats(collected: dict) -> dict:
    """One serve stats line from the sources' snapshots (the JAX package's
    layout): the ``serve`` counters at the top, retries and nonzero
    integrity counters nested, the host cache and residency tier nested with
    their headline keys lifted, then every other source with a nonzero
    number."""
    out: dict = {"event": "serve_stats"}
    out.update(collected.get("serve", {}))
    retries = collected.get("io_retries")
    if retries:
        out["io_retries"] = retries
    integrity = collected.get("integrity")
    if integrity and any(integrity.values()):
        out["integrity"] = integrity
    cache = collected.get("host_cache")
    if cache is not None:
        if "hit_rate" in cache:
            out["host_cache_hit_rate"] = cache["hit_rate"]
        out["host_cache"] = cache
    res = collected.get("residency")
    if res is not None:
        if "pinned_bytes" in res:
            out["pinned_bytes"] = res["pinned_bytes"]
        if "stream_bytes_saved" in res:
            out["stream_bytes_saved"] = res["stream_bytes_saved"]
        out["residency"] = res
    for name in sorted(collected):
        if name in _SERVE_CORE_SOURCES:
            continue
        snap = collected[name]
        if any(isinstance(v, (int, float)) and v for v in snap.values()):
            out[name] = snap
    return out


class ServingMetrics:
    """Counters, gauges and latency windows of the serving engine (the JAX
    package's ``ServingMetrics``; thread-safe: submitters, the engine's
    thread and callbacks all touch it).

    Counters (pre-seeded at 0): admitted, rejected, expired, cancelled,
    completed, failed, prefills, prefix_prefill_tokens and
    prefix_reuse_tokens (prefix tokens prefilled / served from pooled
    pages), sweeps, tokens_emitted (every sweep's tokens), tokens_served
    (the tokens of the requests this engine resolved: a request whose
    resolution lost its claim, or that failed, counts none),
    engine_recoveries, waves_aborted, source_restarts, watchdog_stalls.
    Gauges: queue_depth,
    active_requests, active_waves. Latency windows of the newest
    ``sample_window`` samples: TTFT and per-token latency, and TTFT and
    request latency per SLO class. The speculative passes' drafted,
    accepted and rejected tokens (``spec_count``), in total and per SLO
    class, make the ``spec`` source, with the acceptance rate and the
    accepted tokens per sweep.

    Every source registers into ``self.registry`` (an
    ``obs.registry.MetricsRegistry``): this object's own under ``serve``,
    the retry and integrity recorders, and what the engine attaches (host
    cache, residency tier, watchdog, SLO tracker, KV pool, the stream
    counters, the tracer and the journal). The stats line (``snapshot``)
    and the engine's metrics endpoint both render from that registry.
    Engine-scoped sources are mirrored into the process registry (last
    engine wins; ``close`` retracts them) unless ``process_mirror`` is off,
    as for a fleet's replicas, which the fleet exports under
    ``replica<idx>``."""

    KNOWN_COUNTERS = (
        "admitted", "rejected", "expired", "cancelled", "completed", "failed", "prefills",
        "prefix_prefill_tokens", "prefix_reuse_tokens", "sweeps", "tokens_emitted",
        "tokens_served", "engine_recoveries", "waves_aborted", "source_restarts",
        "watchdog_stalls",
    )
    SPEC_COUNTERS = ("drafted_tokens", "accepted_tokens", "rejected_tokens")

    def __init__(self, sample_window: int = 4096, process_mirror: bool = True) -> None:
        from flexible_llm_sharding_tpu_torch.obs.registry import MetricsRegistry

        self.process_mirror = process_mirror
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {k: 0 for k in self.KNOWN_COUNTERS}
        self._gauges: dict[str, float] = {}
        self._ttft: deque[float] = deque(maxlen=sample_window)
        self._token_lat: deque[float] = deque(maxlen=sample_window)
        self._ttft_class = {c: deque(maxlen=sample_window) for c in SLO_CLASS_NAMES}
        self._latency_class = {c: deque(maxlen=sample_window) for c in SLO_CLASS_NAMES}
        self._spec = dict.fromkeys(self.SPEC_COUNTERS, 0)
        self._spec_class = {c: dict.fromkeys(self.SPEC_COUNTERS, 0) for c in SLO_CLASS_NAMES}
        self._last_emit = 0.0
        self.retries = RetryRecorder()
        self.integrity = IntegrityRecorder()
        self.registry = MetricsRegistry()
        # Mirrored names -> the source registered process-wide, so close()
        # retracts this engine's mirrors without touching a newer engine's.
        self._mirrored: dict[str, object] = {}
        self._host_cache = None
        self._residency = None
        self.register("serve", self._core_snapshot)
        self.register("io_retries", self.retries.snapshot)
        self.register("integrity", self.integrity.snapshot)
        self.register("spec", self.spec_snapshot)

    def register(self, name: str, source, mirror: bool = True) -> None:
        """Add (or replace) a stats source (a no-argument callable returning
        a dict) in this engine's registry, and mirror it into the process
        registry. ``mirror=False`` for process-level sources (the tracer,
        the journal, the host cache, the residency tier): their owners
        register them process-wide, and an engine's teardown must not take
        them away."""
        from flexible_llm_sharding_tpu_torch.obs.registry import REGISTRY

        self.registry.register(name, source)
        if mirror and self.process_mirror:
            self._mirrored[name] = source
            REGISTRY.register(name, source)

    def unregister(self, name: str) -> None:
        from flexible_llm_sharding_tpu_torch.obs.registry import REGISTRY

        self.registry.unregister(name)
        mirrored = self._mirrored.pop(name, None)
        if mirrored is not None:
            REGISTRY.unregister_if(name, mirrored)

    def close(self) -> None:
        """Retract this engine's process-wide mirrors (engine shutdown).
        Idempotent; a newer engine's registrations of the same names stay."""
        from flexible_llm_sharding_tpu_torch.obs.registry import REGISTRY

        for name, source in self._mirrored.items():
            REGISTRY.unregister_if(name, source)
        self._mirrored = {}

    def collect(self) -> dict:
        """Every source's snapshot, by name (``MetricsRegistry.collect``: a
        raising source reads ``{"collect_error": 1}``)."""
        return self.registry.collect()

    @property
    def host_cache(self):
        return self._host_cache

    @host_cache.setter
    def host_cache(self, cache) -> None:
        self._host_cache = cache
        if cache is not None:
            self.register("host_cache", cache.stats, mirror=False)
        else:
            self.unregister("host_cache")

    @property
    def residency(self):
        return self._residency

    @residency.setter
    def residency(self, tier) -> None:
        self._residency = tier
        if tier is not None:
            self.register("residency", tier.stats, mirror=False)
        else:
            self.unregister("residency")

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe_ttft(self, seconds: float, slo_class: str | None = None) -> None:
        with self._lock:
            self._ttft.append(seconds)
            if slo_class is not None:
                self._ttft_class.setdefault(slo_class, deque(maxlen=self._ttft.maxlen)).append(
                    seconds)

    def observe_request_latency(self, seconds: float, slo_class: str | None = None) -> None:
        """Submit-to-completion latency, per SLO class."""
        if slo_class is None:
            return
        with self._lock:
            self._latency_class.setdefault(slo_class, deque(maxlen=self._ttft.maxlen)).append(
                seconds)

    def observe_token_latency(self, seconds: float) -> None:
        with self._lock:
            self._token_lat.append(seconds)

    def ttft_class_samples(self, slo_class: str) -> list[float]:
        with self._lock:
            d = self._ttft_class.get(slo_class)
            return list(d) if d is not None else []

    def token_latency_samples(self) -> list[float]:
        with self._lock:
            return list(self._token_lat)

    def spec_count(self, drafted: int = 0, accepted: int = 0, rejected: int = 0,
                   slo_class: str | None = None) -> None:
        """One verify pass's useful drafted slots, accepted and rejected
        (drafted == accepted + rejected), also in ``slo_class``'s split."""
        with self._lock:
            targets = [self._spec]
            if slo_class is not None:
                targets.append(self._spec_class.setdefault(
                    slo_class, dict.fromkeys(self.SPEC_COUNTERS, 0)))
            for t in targets:
                t["drafted_tokens"] += drafted
                t["accepted_tokens"] += accepted
                t["rejected_tokens"] += rejected

    def spec_snapshot(self) -> dict:
        """The ``spec`` source: the counters, the acceptance rate (accepted
        over drafted), the accepted tokens per sweep and the per-class
        split."""
        with self._lock:
            drafted = self._spec["drafted_tokens"]
            accepted = self._spec["accepted_tokens"]
            sweeps = self._counters.get("sweeps", 0)
            return {
                **self._spec,
                "acceptance_rate": round(accepted / drafted, 4) if drafted else 0.0,
                "extra_tokens_per_sweep": round(accepted / sweeps, 4) if sweeps else 0.0,
                "by_class": {c: dict(v) for c, v in sorted(self._spec_class.items())},
            }

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def _core_snapshot(self) -> dict:
        with self._lock:
            return {
                **{k: v for k, v in sorted(self._counters.items())},
                **{k: v for k, v in sorted(self._gauges.items())},
                "ttft_s": _latency_summary(list(self._ttft)),
                "token_latency_s": _latency_summary(list(self._token_lat)),
                "ttft_by_class": {c: _latency_summary(list(d))
                                  for c, d in sorted(self._ttft_class.items())},
                "latency_by_class": {c: _latency_summary(list(d))
                                     for c, d in sorted(self._latency_class.items())},
            }

    def snapshot(self) -> dict:
        return assemble_serve_stats(self.collect())

    def emit(self) -> None:
        print(json.dumps(self.snapshot()), file=sys.stderr, flush=True)

    def maybe_emit(self, interval_s: float) -> bool:
        """Print the stats line to stderr if ``interval_s`` passed since the
        last one (0 = never). Returns whether it printed."""
        if not interval_s:
            return False
        now = time.monotonic()
        with self._lock:
            if now - self._last_emit < interval_s:
                return False
            self._last_emit = now
        self.emit()
        return True


class RouterMetrics:
    """The replica fleet's router counters and gauges (``serve/fleet.py``),
    thread-safe. The counters of ``KNOWN_COUNTERS`` start at 0, so a
    snapshot tells "none happened" from "not counted"."""

    KNOWN_COUNTERS = (
        "dispatches",          # requests handed to a replica (first attempt)
        "redispatches",        # orphans handed to a surviving replica
        "expired_orphans",     # orphans whose deadline passed -> EXPIRED
        "stale_results",       # outcomes of attempts the fleet abandoned
        "replicas_dead",       # hard-fails (engine-fatal or stalled watermark)
        "replicas_drained",    # graceful drains completed
        "replicas_recycled",   # fresh engines in a dead or drained slot
        "replicas_added",      # elastic joins
        "replicas_removed",    # elastic leaves
    )

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, int] = dict.fromkeys(self.KNOWN_COUNTERS, 0)  # guarded by: _lock
        self._gauges: dict[str, float] = {}  # guarded by: _lock

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def snapshot(self) -> dict:
        with self._lock:
            return {**dict(sorted(self._counters.items())), **dict(sorted(self._gauges.items()))}


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """A ``torch.profiler`` scope over the CPU and, on a machine with a
    card, the CUDA activities (the JAX package's ``jax.profiler.trace``):
    its Chrome trace is written to ``<log_dir>/torch_trace_<pid>_<n>.json``
    when the scope ends. A no-op without a directory."""
    if not log_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    n = sum(1 for f in os.listdir(log_dir) if f.startswith(f"torch_trace_{os.getpid()}_"))
    prof.export_chrome_trace(os.path.join(log_dir, f"torch_trace_{os.getpid()}_{n}.json"))


class _NullBar:
    def update(self, n: int = 1) -> None:
        pass

    def set_postfix_str(self, s: str) -> None:
        pass

    def close(self) -> None:
        pass


class _WatchdogBar:
    """A progress bar with a warn-only stall watchdog (the JAX package's):
    when no update lands for ``stall_warn_s``, a warning naming the loop and
    how long it has been stuck goes to stderr, repeated each further
    interval."""

    def __init__(self, bar, desc: str, stall_warn_s: float):
        self._bar = bar
        self._desc = desc
        self._interval = stall_warn_s
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, name="progress-watchdog",
                                        daemon=True)
        self._thread.start()

    def _watch(self) -> None:
        warned = 0
        while not self._stop.wait(min(self._interval / 4, 30.0)):
            idle = time.monotonic() - self._last
            if idle >= self._interval * (warned + 1):
                warned += 1
                msg = (f"[stall] '{self._desc}' has made no progress for {idle / 60:.1f} min — "
                       "the device transfer or compute may be wedged; the run continues if it "
                       "unwedges, or can be killed and resumed (--resume, disk mode)")
                # tqdm.write, not print: a raw print would splice into the
                # bar's in-place line.
                writer = getattr(type(self._bar), "write", None)
                if callable(writer):
                    type(self._bar).write(msg, file=sys.stderr)
                else:
                    print(msg, file=sys.stderr, flush=True)
            elif idle < self._interval:
                warned = 0

    def update(self, n: int = 1) -> None:
        self._last = time.monotonic()
        self._bar.update(n)

    def set_postfix_str(self, s: str) -> None:
        self._bar.set_postfix_str(s)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._bar.close()


def progress_bar(total: int, desc: str, unit: str = "it", disable=None,
                 stall_warn_s: float = 600.0):
    """A tqdm bar over a streaming loop (the JAX package's): ``disable=None``
    is tqdm's auto mode (shown on a TTY, silent in pipes); a no-op bar
    without tqdm. A stall watchdog warns on stderr when no update lands
    for ``stall_warn_s`` (0 = off)."""
    try:
        from tqdm import tqdm
    except ImportError:
        bar = _NullBar()
    else:
        bar = tqdm(total=total, desc=desc, unit=unit, disable=disable, file=sys.stderr)
    if stall_warn_s and total > 0:
        return _WatchdogBar(bar, desc, stall_warn_s)
    return bar


class StepWatchdog:
    """Step-progress watchdog with an abort action (the JAX package's).

    ``arm(token)`` before a monitored phase, ``tick()`` at every unit of
    progress, ``disarm()`` when it completes. An armed phase that goes
    ``abort_s`` without a tick fires ``on_stall(idle_s, token)`` once, from
    the watchdog's thread, with the token its own armed period captured
    (the serving engine passes its weight source, so a late callback can
    never abort a replacement), and disarms itself. ``on_stall`` must not
    block."""

    def __init__(self, desc: str, abort_s: float, on_stall, poll_s=None):
        if abort_s <= 0:
            raise ValueError("abort_s must be > 0")
        self._desc = desc
        self._abort_s = abort_s
        self._on_stall = on_stall
        self._poll_s = poll_s if poll_s is not None else max(abort_s / 4, 0.01)
        self._armed = False
        self._token = None
        self._last = time.monotonic()
        self.stalls = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def _watch(self) -> None:
        while not self._stop.wait(self._poll_s):
            if not self._armed:
                continue
            idle = time.monotonic() - self._last
            if idle < self._abort_s:
                continue
            token = self._token  # before anything that can block
            self._armed = False
            self.stalls += 1
            # The trace instant first (a ring append), then its durable twin.
            obs_trace.instant("watchdog_stall", cat="serve", desc=self._desc,
                              idle_s=round(idle, 3), stalls=self.stalls)
            obs_events.emit("watchdog_stall", desc=self._desc, idle_s=round(idle, 3),
                            stalls=self.stalls)
            print(f"[stall] '{self._desc}' made no progress for {idle:.1f}s — aborting for "
                  "recovery", file=sys.stderr, flush=True)
            try:
                self._on_stall(idle, token)
            except Exception:  # recovery is best-effort; the watchdog must survive
                pass

    def stats(self) -> dict[str, int]:
        return {"stalls": self.stalls}

    def arm(self, token=None) -> None:
        self._token = token
        self._last = time.monotonic()
        self._armed = True

    def tick(self) -> None:
        self._last = time.monotonic()

    def disarm(self) -> None:
        self._armed = False

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)


__all__ = [
    "IntegrityRecorder",
    "Recorder",
    "RetryRecorder",
    "RouterMetrics",
    "SLO_CLASS_NAMES",
    "ServingMetrics",
    "StepWatchdog",
    "assemble_serve_stats",
    "chip_hbm_gb",
    "has_moe_layers",
    "host_rss_gib",
    "param_count",
    "profiler_trace",
    "progress_bar",
    "weight_bytes_per_chip",
]
