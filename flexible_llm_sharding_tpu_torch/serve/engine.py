"""The serving loop: continuous batching over the streaming runtime (the
JAX package's ``serve/engine.py``, single engine).

One worker thread drives an endless sequence of **weight sweeps**. Each
sweep walks the model's shards in order, kept on the card
(``decode_resident``) or streamed again through a cycling
``ShardWeightSource``. At every shard, every active wave advances by that
shard's work: a wave admitted at this sweep's shard-0 boundary runs its
prefill (``runtime/decode.prefill_decoders``, keeping each layer's KV), and
the waves in flight run one decode step against their KV. New waves join
only at the shard-0 boundary (``ShardAwareBatcher``), so a join never
prefills an in-flight request again: the late wave's prefill and the
earlier waves' decode ride the same sweep. Joining changes when a request
is served, never what it gets.

A request resolves (future and callback) as soon as its own token budget is
reached; budgets differ within a wave, and a block whose requests all
finished sits the later sweeps out. ``drain`` serves out what is queued and
in flight and refuses new requests; ``shutdown(drain=False)`` cancels the
queued ones.

The paged prefix-KV pool (``runtime/kvpool.py``): each entry leases its
prefix's block table at admission; a full prefill banks each decoder
segment's prefix KV into the pool and seals the entry after its prefill
sweep; a later wave whose block rows all lease sealed entries runs only the
suffix half of each layer (``suffix_prefill_decoders``) over the assembled
pages, uploaded page-locked in the compute dtype.

The sweep scheduler (``serve/sched/``, ``ServeConfig.sched``): the queue
pops by SLO class and tenant; at a shard-0 boundary, before admission, a
waiting interactive request with every active slot held retires the
youngest best-effort wave (``_preempt_wave``: each live request keeps its
served steps as resume state and goes back to the queue's front, its pool
leases drop but the pages stay, so the resumed entry finds its sealed
prefix); a resumed request's tokens fold into its suffix ids as ids, so its
prefill recomputes the interrupted decode's KV. Same-tokenized-prefix
requests of one boundary share one entry and one prefix prefill
(``build_entries`` keyed by ``_prefix_key``).

Speculative serving (``ServeConfig.speculative_k``): a wave that decodes
runs each later sweep as one K+1-slot verify pass per block
(``runtime/decode.SpecVerifier``, the offline decoder's verify path through
``decode_step_layer``), emitting 1..K+1 tokens per suffix, token for token
what plain greedy decode emits. Drafts come from prompt lookup or from a
resident draft model (``runtime/draft.py``, ``draft_model_path``), with
each class's depth adapted by ``serve/spec.SpecController``
(``spec_adaptive``). A request progresses at its slowest suffix.

Multi-tenant LoRA (``adapters/``, ``FrameworkConfig.adapters``): a request
may name an adapter. At wave setup each entry's adapter resolves through the
process store (an unknown or corrupt one fails only that entry's requests,
typed); the wave groups its rows by adapter and every decoder segment shifts
each row's hidden stream at each layer's entry by its adapter's own factors
(``delta``, ``adapters/apply.lora_shift_rows``), uploaded once per (shard,
segment) per wave and counted in the store's ``delta_bytes``. A base-only wave passes no delta. The pool's entries are
salted by the adapter, so the same prefix under another adapter never
shares pages.

The request WAL (``serve/wal.py``, ``ServeConfig.wal_dir``): the queue
writes each admission ahead; every sweep that emits tokens writes a
progress record with their ids; a terminal transition writes its outcome.
``shutdown_for_restart`` parks the queued requests, lets the waves in
flight finish their sweep, exports each live request's pooled prefix KV
and parks it too (``RestartPending``: open in the WAL), and the next
process's ``serve/recovery.replay`` serves them. ``FLS_WAL_CRASH_SWEEPS=N``
in the environment kills the process (SIGKILL) mid-sweep after N sweeps:
the drill the crash tests run.

Degrade, don't die: a shard load that failed for good (``ShardLoadError``),
a sweep the stall watchdog aborted (``SourceClosed``), an ``OSError`` or a
pooled page that stays corrupt (``SpillCorruptError``) fails only the waves
in flight (``WaveAborted``, the fault as its cause) and restarts the weight
source; the queue keeps being served. Anything else, a kernel launch that
fails included, is engine-fatal: every request fails with the root cause
and the loop stops. On a card the kernels are built and loaded before the
first sweep, so a build or load failure is engine-fatal too.

The replica fleet (``serve/fleet.py``) drives N engines in one process
through the same surface plus four hooks: the constructor's ``scheduler``
and ``wal`` (one of each shared by the fleet's engines), ``fleet_hook``
(called from the worker thread at every shard step, before the step's
work: the fleet's stagger holds and its chaos sites), ``reclaim_inflight``
(a dead engine's unfinished requests handed back with their prompts) and
``sweep_position`` (the router's phase and the liveness watermark). An
engine-fatal error keeps its type and message, but its traceback's frames
are cleared, so a dead engine's shard, activations and KV are not kept on
the card by the error that every future holds.

On a card the worker thread sets its device before any CUDA call and runs
every launch on that device's current stream of its own thread; the serve
sweep runs eager (no CUDA graph), so N engine threads on one card never
launch into another thread's capture. Greedy selection only.

Faults and pressure: under chaos (``FrameworkConfig.faults``) one injector
serves the engine's weight sources (the read and upload sites), its
admission queue (``queue_admission``), the KV pool and the adapter store
(the corruption sites), and ``engine_step``, fired at every shard step
after the fleet's hook; an injected ``engine_step`` fault is an ``OSError``
and takes the recovery above. With ``FrameworkConfig.pressure`` the process
brownout controller (``runtime/pressure.py``) sheds through this engine's
queue and backs its speculation off, and its counters make the stats line's
``pressure`` block.

Observability (``obs/``, the JAX package's names and correlation ids): each
sweep is a ``sweep`` span holding a ``prefill_shard`` or ``decode_shard``
span per wave and shard, kept outside any captured region (the serve sweep
runs eager); a wave's life is a string of instants (``wave_admit``,
``ttft``, ``token_latency``, ``request_finish``, ``wave_abort``,
``wave_reject``, ``wave_preempt``, ``prefix_coalesce``, ``adapter_apply``,
``adapter_reject``, ``spec_draft``, ``spec_verify``); every failure path is
also a journal event (``engine_recovery``, ``engine_fatal``,
``shutdown_drain`` among them). The engine's registry (``metrics.registry``)
serves ``ServeConfig.metrics_port``'s endpoint, and its sources are
mirrored into the process registry unless ``process_metrics_mirror`` is off
(a fleet's replicas).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
import traceback
from itertools import islice
from typing import Any, Callable

import numpy as np
import torch

from flexible_llm_sharding_tpu_torch.adapters import apply as adapter_apply
from flexible_llm_sharding_tpu_torch.adapters import loader as adapter_loader
from flexible_llm_sharding_tpu_torch.adapters.registry import AdapterCorruptError, AdapterNotFound
from flexible_llm_sharding_tpu_torch.config import (
    FrameworkConfig,
    LlamaConfig,
    ServeConfig,
    resolve_device,
)
from flexible_llm_sharding_tpu_torch.faults.inject import FaultInjector
from flexible_llm_sharding_tpu_torch.faults.retry import ShardLoadError
from flexible_llm_sharding_tpu_torch.integrity.manifest import SpillCorruptError
from flexible_llm_sharding_tpu_torch.models import llama
from flexible_llm_sharding_tpu_torch.obs import events as obs_events
from flexible_llm_sharding_tpu_torch.obs import incident as obs_incident
from flexible_llm_sharding_tpu_torch.obs import trace as obs_trace
from flexible_llm_sharding_tpu_torch.obs.slo import SLOTracker
from flexible_llm_sharding_tpu_torch.ops import cuda_build
from flexible_llm_sharding_tpu_torch.parallel.planner import plan_shards_dp
from flexible_llm_sharding_tpu_torch.runtime import hostcache, kvpool, pressure, residency
from flexible_llm_sharding_tpu_torch.runtime.decode import (
    KVStore,
    SpecVerifier,
    decode_decoders,
    decode_norm_head,
    draft_contexts,
    extend_gen_kv,
    prefill_decoders,
    spec_norm_head,
    suffix_prefill_decoders,
)
from flexible_llm_sharding_tpu_torch.runtime.executor import (
    ShardWeightSource,
    SourceClosed,
    block_meta,
    first_decoder,
    process_tied_head_requants,
)
from flexible_llm_sharding_tpu_torch.runtime.schedcore import SchedCore
from flexible_llm_sharding_tpu_torch.runtime.tokenization import (
    PromptTokenizer,
    check_longrope_regime,
    extend_tokenized,
    longrope_total_len,
    make_blocks,
)
from flexible_llm_sharding_tpu_torch.serve.batcher import ShardAwareBatcher, Wave
from flexible_llm_sharding_tpu_torch.serve.queue import AdmissionQueue
from flexible_llm_sharding_tpu_torch.serve.request import (
    Request,
    RequestStatus,
    RestartPending,
    WaveAborted,
)
from flexible_llm_sharding_tpu_torch.serve.sched import (
    SweepScheduler,
    build_entries,
    class_deadline_s,
    parse_class,
)
from flexible_llm_sharding_tpu_torch.serve.wal import wal_for
from flexible_llm_sharding_tpu_torch.utils import checkpoint
from flexible_llm_sharding_tpu_torch.utils.metrics import ServingMetrics, StepWatchdog


def _clear_frames(error: BaseException) -> None:
    """Clear the locals of every finished frame of ``error``'s traceback and
    of its causes' (a frame still executing is skipped)."""
    seen: set[int] = set()
    while error is not None and id(error) not in seen:
        seen.add(id(error))
        traceback.clear_frames(error.__traceback__)
        error = error.__cause__ or error.__context__


@dataclasses.dataclass
class _WaveState:
    """The engine's compute state of one wave: the offline decoder's
    structures, scoped to the wave's requests."""

    toks: list
    blocks: list[list[int]]
    meta: dict[int, tuple]
    kv_store: KVStore
    scores: dict[int, list[np.ndarray]]
    tok_hist: dict[int, list[np.ndarray]]
    loc: dict[int, tuple[int, int]]  # wave-entry index -> (block, row)
    slots: int
    norm_p: Any = None  # the norm shard's params, applied with the head
    # A speculative wave (after its prefill): one SpecVerifier per block, the
    # pass's per-suffix slot offsets fixed at the embed segment, and each
    # suffix row's owning request's SLO class (None: padding).
    spec: dict[int, SpecVerifier] | None = None
    spec_base: dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)
    spec_classes: dict[int, list] = dataclasses.field(default_factory=dict)
    # The pool: one lease per entry, from admission to retirement or abort,
    # and the blocks whose every row reuses a sealed entry.
    pool_handles: dict[int, Any] = dataclasses.field(default_factory=dict)
    reuse_blocks: set[int] = dataclasses.field(default_factory=set)
    # LoRA: the wave's adapter groups (names[0] the base), their [G] scales
    # (None: a base-only wave, which passes no delta), the factors, each
    # block's row -> group list, and the device copies: each (shard, decoder
    # segment)'s per-layer {group: (A, B)} and the scales, uploaded once per
    # wave.
    adapter_names: list = dataclasses.field(default_factory=list)
    adapter_scales: Any = None
    adapter_factors: dict = dataclasses.field(default_factory=dict)
    adapter_g: dict = dataclasses.field(default_factory=dict)
    adapter_pairs: dict = dataclasses.field(default_factory=dict)
    adapter_scale_dev: Any = None


class ServeEngine:
    """Continuous-batching server over the streaming decode runtime.

    ``submit()`` is thread-safe and does not block (a rejection resolves the
    returned request's future); results resolve through ``Request.future``
    and the request's callback. ``device`` defaults to ``cfg.device``
    (``resolve_device``: the card unless the CPU is asked for).

    ``scheduler`` and ``wal``: a ``SweepScheduler`` and a ``RequestWAL``
    shared with other engines (the replica fleet's); None builds this
    engine's own from ``serve_cfg``. ``process_metrics_mirror=False`` keeps
    this engine's sources out of the process registry (a fleet's replica:
    the fleet exports them under ``replica<idx>``).
    """

    def __init__(self, cfg: FrameworkConfig, serve_cfg: ServeConfig | None = None, tokenizer=None,
                 device: torch.device | None = None, start: bool = True,
                 scheduler=None, wal=None, process_metrics_mirror: bool = True):
        if cfg.temperature > 0:
            raise ValueError("serving is greedy-only (per-request rng streams under sampling are "
                             "not supported); set temperature=0")
        if cfg.speculative_k:
            raise ValueError("FrameworkConfig.speculative_k is the OFFLINE scorer's knob; "
                             "serving speculation is ServeConfig.speculative_k (--speculative_k "
                             "on the serve parser)")
        if cfg.long_context:
            raise ValueError("long_context serving is not supported yet")
        if cfg.data_parallel:
            raise ValueError("serving drives a single device; drop data_parallel")
        self.cfg = cfg
        self.serve_cfg = serve_cfg or ServeConfig()
        # 0: one token per sweep; adaptive k provisions its verify slots at
        # spec_k_max.
        self._spec_k = (self.serve_cfg.spec_k_max if self.serve_cfg.spec_adaptive
                        else self.serve_cfg.speculative_k)
        device = device if device is not None else resolve_device(cfg.device)
        if device.type == "cuda" and device.index is None:
            # The worker thread sets this index: its current device is its own.
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.model_cfg = LlamaConfig.from_pretrained(cfg.model_path)
        self.dtype = cfg.torch_dtype
        self._use_pallas = cfg.use_pallas
        if tokenizer is None:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(cfg.model_path)
        self.raw_tokenizer = tokenizer
        self.tokenizer = PromptTokenizer(tokenizer, max_token_len=cfg.max_token_len,
                                         bucket_multiple=cfg.bucket_multiple)
        self.layer_names = checkpoint.layer_names_for(self.model_cfg.num_hidden_layers)
        self.shards = list(plan_shards_dp(len(self.layer_names), cfg.layer_num_per_shard).shards)
        self._n_layers = len(self.layer_names)
        self._sliding = llama.layer_sliding_pattern(self.model_cfg)
        self._rope_on = llama.layer_rope_pattern(self.model_cfg)
        self._resident = cfg.decode_resident_enabled(self.model_cfg, 1, self.device)
        # Tracing and the flight recorder: process-wide, enabled by the
        # config. Off, an emit below is one bool read and its scalar
        # arguments; the ones whose attributes walk a wave's requests or a
        # numpy array build them only when tracing is on.
        obs_trace.ensure_configured(cfg)
        obs_events.ensure_configured(cfg)
        obs_incident.ensure_configured(cfg, self.serve_cfg)
        self.metrics = ServingMetrics(process_mirror=process_metrics_mirror)
        # The chaos injector (None unless cfg.faults.enabled), handed to the
        # queue, every source, the pool and the adapter store.
        self._injector = FaultInjector.from_config(cfg.faults)
        # The process host shard cache: a streamed engine's later sweeps,
        # and a recovery's new source, read from it.
        self._host_cache = hostcache.cache_for(cfg)
        self.metrics.host_cache = self._host_cache
        # The process residency tier; moot when the whole model stays resident.
        self._residency = (None if self._resident else residency.tier_for(
            cfg, self.layer_names, self.model_cfg.tie_word_embeddings, self.device))
        self.metrics.residency = self._residency
        self._streamed_before = 0  # bytes of the sources already closed
        # Process-level names: their owners register them process-wide (the
        # executor module's ``stream``), so no engine mirror replaces them.
        self.metrics.register("stream", self._stream_stats, mirror=False)
        self.metrics.register("trace", obs_trace.TRACER.stats, mirror=False)
        self.metrics.register("journal", obs_events.JOURNAL.stats, mirror=False)
        self._slo = SLOTracker(self.serve_cfg.slo, self.metrics)
        self.metrics.register("slo", self._slo.stats)
        # The metrics endpoint (None = off; port 0 = ephemeral, the bound
        # port is metrics_server.port). Its handler thread only collects
        # host numbers: no source makes a CUDA call.
        self.metrics_server = None
        if self.serve_cfg.metrics_port is not None:
            from flexible_llm_sharding_tpu_torch.obs.registry import MetricsServer

            self.metrics_server = MetricsServer(self.metrics.registry,
                                                port=self.serve_cfg.metrics_port)
        self._sched = scheduler
        if self._sched is None and self.serve_cfg.sched.enabled:
            self._sched = SweepScheduler(self.serve_cfg.sched)
        if self._sched is not None:
            self.metrics.register("sched", self._sched.stats)
        self._wal = wal if wal is not None else wal_for(self.serve_cfg)
        if self._wal is not None:
            self.metrics.register("wal", self._wal.stats)
        self.queue = AdmissionQueue(self.serve_cfg.queue_capacity, metrics=self.metrics,
                                    max_request_tokens=self.serve_cfg.max_request_tokens,
                                    size_fn=self._request_size_tokens, scheduler=self._sched,
                                    wal=self._wal, injector=self._injector)
        # The process brownout controller (None unless cfg.pressure.enabled):
        # attached after the queue is built, so an engine that joins
        # mid-brownout sheds at once.
        self._pressure = pressure.controller_for(cfg, self.device)
        if self._pressure is not None:
            self._pressure.attach_queue(self.queue)
            self.metrics.register("pressure", self._pressure.stats)
        # The resident draft model, pinned whole through its own tier; a
        # layer that does not pin fails construction.
        self._draft_model = None
        if self.serve_cfg.draft_model_path:
            from flexible_llm_sharding_tpu_torch.runtime.draft import DraftModel

            self._draft_model = DraftModel(self.serve_cfg.draft_model_path, self.device,
                                           self.dtype, retry_policy=cfg.retry_policy(),
                                           verify_weights=cfg.verify_weights,
                                           injector=self._injector,
                                           use_pallas=self._use_pallas)
            self.metrics.register("draft", self._draft_model.stats)
        self._spec_ctrl = None
        if self.serve_cfg.spec_adaptive:
            from flexible_llm_sharding_tpu_torch.serve.spec import SpecController

            sc = self.serve_cfg
            self._spec_ctrl = SpecController(sc.speculative_k, sc.spec_k_min, sc.spec_k_max,
                                             sc.spec_window, sc.spec_raise_threshold,
                                             sc.spec_backoff_threshold, sc.spec_draft_budget)
            self.metrics.register("spec_ctrl", self._spec_ctrl.stats)
            if self._pressure is not None:
                self._pressure.attach_spec(self._spec_ctrl)
        # The scheduling policy shared with the offline DecodeGenerator.
        self._sched_core = SchedCore(cfg)
        # The paged prefix-KV pool. Longrope models opt out: their prefix
        # KV depends on the prompt's total length through the table switch.
        self._kv_pool = (None if self.model_cfg.rope_scaling_kind == "longrope"
                         else kvpool.pool_for(cfg))
        if self._kv_pool is not None:
            self._kv_pool.set_injector(self._injector)
            self.metrics.register("kvpool", kvpool.process_stats)
        # The process store of LoRA factors; None without --adapter_dir.
        self._adapter_store = adapter_loader.store_for(cfg)
        if self._adapter_store is not None:
            self._adapter_store.injector = self._injector
            self.metrics.register("adapter", self._adapter_store.stats)
        self.batcher = ShardAwareBatcher(
            self.queue, self.serve_cfg.max_wave_requests, self.serve_cfg.max_active_requests,
            metrics=self.metrics, sched_core=self._sched_core,
            entry_builder=((lambda reqs: build_entries(reqs, self._prefix_key))
                           if self._sched is not None and self.serve_cfg.sched.coalesce
                           else None))
        self._kept: list | None = None  # resident: the placed shards
        self._source: ShardWeightSource | None = None  # streamed: cycling
        self._src_iter = None
        self._watchdog: StepWatchdog | None = None
        self._error: BaseException | None = None
        self._thread: threading.Thread | None = None
        # The sweep's position and last progress, read by sweep_position().
        self._sweep_pos = 0
        self._heartbeat = time.monotonic()
        # shutdown_for_restart's flag, read at the shard-0 boundary.
        self._restart_pending = False
        # The process-death drill: SIGKILL mid-sweep after this many sweeps
        # (0 = off). From the environment: only a crash harness sets it.
        self._crash_sweeps = int(os.environ.get("FLS_WAL_CRASH_SWEEPS", "0") or 0)
        self._sweeps_done = 0
        # The replica fleet's per-shard-step hook (worker thread), or None.
        self.fleet_hook: Callable[[int], Any] | None = None
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ServeEngine":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name="serve-engine", daemon=True)
            self._thread.start()
        return self

    def __enter__(self) -> "ServeEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=exc == (None, None, None))

    def submit(self, prefix: str, suffixes: tuple[str, ...] | list[str],
               max_new_tokens: int | None = None, deadline_s: float | None = None,
               callback: Callable[[Request], Any] | None = None, slo_class: str | None = None,
               tenant_id: str | None = None, adapter_id: str | None = None,
               client_id=None) -> Request:
        """Enqueue one request (any thread). Rejections resolve through the
        returned request's future; an unknown ``slo_class`` raises
        ``UnknownSLOClass`` and ``max_new_tokens`` < 1 ``ValueError``.
        Deadline: the request's own, else its class's (scheduler on), else
        the serve-level default. ``adapter_id`` names a LoRA adapter (None =
        the base model); an unknown one fails the request at wave setup.
        ``client_id`` is the caller's id, kept across a restart."""
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
        """Enqueue a request built by the caller (the WAL replay keeps its
        ``wal_id`` and ``client_id``)."""
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        return self.queue.submit(req)

    def drain(self, timeout: float | None = None) -> bool:
        """Refuse new submissions, serve out what is queued and in flight,
        stop. Returns whether the loop ended within ``timeout``."""
        return self.shutdown(drain=True, timeout=timeout)

    def _detach_pressure(self) -> None:
        """Stop being a shed and a spec_backoff target (a recycled replica's
        new engine attaches its own)."""
        if self._pressure is not None:
            self._pressure.detach_queue(self.queue)
            if self._spec_ctrl is not None:
                self._pressure.detach_spec(self._spec_ctrl)

    def shutdown(self, drain: bool = True, timeout: float | None = None) -> bool:
        self._detach_pressure()
        self.queue.close(drain=drain)
        ok = True
        if self._thread is not None:
            self._thread.join(timeout)
            ok = not self._thread.is_alive()
        self._close_surfaces()
        return ok

    def _close_surfaces(self) -> None:
        """The endpoint, the draft model and this engine's process-registry
        mirrors (a dead engine must not serve stale counters)."""
        if self.metrics_server is not None:
            self.metrics_server.close()
        if self._draft_model is not None:
            self._draft_model.close()
        self.metrics.close()

    def shutdown_for_restart(self, timeout: float | None = None) -> bool:
        """A graceful restart (SIGTERM): park the queued requests
        (``RestartPending``, open in the WAL), let the waves in flight
        finish their sweep, then at the boundary export their pooled prefix
        KV, write their progress, park them and stop. The next process's
        ``serve/recovery.replay`` serves every parked request. Without a
        WAL this is ``shutdown(drain=False)``."""
        if self._wal is None:
            return self.shutdown(drain=False, timeout=timeout)
        self._detach_pressure()
        self.queue.close(drain=False, persist=True)
        self._restart_pending = True
        ok = True
        if self._thread is not None:
            self._thread.join(timeout)
            ok = not self._thread.is_alive()
        self._wal.flush(sync=True)
        self._wal.maybe_compact()
        obs_events.emit("shutdown_drain", clean=ok,
                        open_requests=self._wal.stats()["open_requests"])
        self._close_surfaces()
        return ok

    def _drain_for_restart(self) -> None:
        """The loop's half of ``shutdown_for_restart``, at a shard-0
        boundary, where every wave has just finished a sweep: export each
        live request's pooled prefix KV (checksummed pages under the WAL's
        directory), write its last progress record with their refs, and
        park it."""
        for wave in self.batcher.waves:
            st = wave.state
            for r in wave.requests:
                if r.status.terminal or r.wal_id is None:
                    continue
                kv_refs = None
                if self._kv_pool is not None and st is not None and wave.steps > 0:
                    e_idx, _, _ = wave.locate(r)
                    handle = st.pool_handles.get(e_idx)
                    tp = st.toks[e_idx]
                    if handle is not None:
                        kv_refs = self._kv_pool.export_entry(
                            handle, self._wal.wal_dir,
                            tuple(int(t) for t in tp.prefix_ids[: tp.prefix_len]),
                            salt=self._entry_adapter(wave.entries[e_idx]))
                self._wal.progress(r, kv=kv_refs)
        waves = list(self.batcher.waves)  # fail_all_active clears the list
        self.batcher.fail_all_active(RestartPending(
            "serve process restarting; in-flight request journaled for token-identical replay"))
        for w in waves:
            if w.state is not None:
                w.state.kv_store.clear()
                self._release_pool_handles(w.state)

    @property
    def error(self) -> BaseException | None:
        return self._error

    def stats(self) -> dict:
        return self.metrics.snapshot()

    @property
    def kv_pool(self):
        """The process prefix-KV pool this engine leases from (None when
        the pool is off): a warm restart's replay restores into it."""
        return self._kv_pool

    def queue_depth(self) -> int:
        """Requests waiting for admission."""
        return len(self.queue)

    @property
    def slo_tracker(self) -> SLOTracker:
        """The engine's SLO tracker: the fleet autoscaler reads its burn
        rates and trend."""
        return self._slo

    def sweep_position(self) -> dict:
        """The sweep's progress (any thread, lock-free reads): ``shard_pos``
        the shard being run, ``boundary_frac`` the fraction of a sweep left
        until the next shard-0 admission point (0 while idle), ``watermark``
        the last instant the sweep moved, ``busy`` whether a wave is in
        flight or a request queued."""
        n = len(self.shards)
        pos = self._sweep_pos
        sweeping = bool(self.batcher.waves)
        return {
            "shard_pos": pos,
            "n_shards": n,
            "boundary_frac": (n - pos) / n if sweeping else 0.0,
            "watermark": self._heartbeat,
            "busy": sweeping or len(self.queue) > 0,
        }

    def reclaim_inflight(self) -> list[Request]:
        """Hand back every request this engine still holds unfinished,
        queued and in flight, with its prompt and ``dispatch_id``: the
        replica fleet re-dispatches them after declaring the engine dead.
        Each one's future resolves ``WaveAborted`` (first-wins: a wedged
        worker thread that wakes later loses the claim) without firing its
        callback, whose owner re-dispatches. The queue closes; expired
        queued requests resolve as EXPIRED."""
        err = WaveAborted("replica declared dead; request reclaimed for re-dispatch")
        # Copies: a worker thread that is not quite dead may still change
        # the wave list.
        held = self.queue.reclaim() + [r for w in list(self.batcher.waves)
                                       for r in list(w.requests)]
        orphans: list[Request] = []
        for r in held:
            if not r.status.terminal and r.future.claim():
                r.status = RequestStatus.FAILED
                r.finished_at = time.monotonic()
                r.future.finish_error(err)
                orphans.append(r)
        return orphans

    def _stream_stats(self) -> dict:
        src = self._source
        return {
            "streamed_bytes": self._streamed_before + (src.bytes_loaded if src is not None else 0),
            "tied_head_requants": process_tied_head_requants(),
        }

    # -- the serving loop --------------------------------------------------

    def _run(self) -> None:
        if self.device.type == "cuda":
            try:
                # The current device is per thread: set it before any CUDA call.
                torch.cuda.set_device(self.device)
                # Build and load the kernels before the first sweep, so a build
                # or load failure (an OSError among them) is engine-fatal here
                # and never reaches a sweep's recoverable faults.
                cuda_build.library()
            # flscheck: disable=EXC-TAXONOMY: daemon-thread boundary: a device-setup or kernel-build failure is surfaced through every pending future via _fatal, never swallowed
            except BaseException as e:  # noqa: BLE001 — surfaced through every future
                self._fatal(e)
                return
        with torch.inference_mode():
            self._loop()
        if self._error is not None:
            # The loop's own frame has finished now: clear it too.
            _clear_frames(self._error)

    def _loop(self) -> None:
        try:
            self._acquire_weights()
        # flscheck: disable=EXC-TAXONOMY: daemon-thread boundary: the error is surfaced through every pending future via _fatal, never swallowed
        except BaseException as e:  # noqa: BLE001 — surfaced through every future
            self._fatal(e)
            return
        wd = None
        if self.serve_cfg.watchdog_abort_s > 0 and not self._resident:
            # A streamed sweep that lands no shard for watchdog_abort_s has
            # its source aborted from the watchdog's thread; the pending get
            # then raises SourceClosed and the recovery below takes over. A
            # resident sweep moves no weights: no watchdog.
            wd = StepWatchdog("serve-sweep", self.serve_cfg.watchdog_abort_s, self._on_stall)
            self.metrics.register("watchdog", wd.stats)
        self._watchdog = wd
        try:
            while True:
                # ---- shard-0 boundary: the admission point ----------------
                self._heartbeat = time.monotonic()
                if self._restart_pending:
                    # A graceful restart, at the boundary: KV and pool
                    # handles are consistent.
                    self._drain_for_restart()
                    break
                # Preemption before admission: the freed slots seat the
                # waiting interactive work at this same boundary.
                self._maybe_preempt()
                wave = self.batcher.admit_at_boundary()
                if wave is not None and not self._init_wave(wave):
                    continue  # the wave failed at tokenization; check the queue again
                if wave is not None and obs_trace.enabled():
                    obs_trace.instant("wave_admit", cat="serve", wave_id=wave.wave_id,
                                      requests=len(wave.requests),
                                      request_ids=[r.request_id for r in wave.requests])
                if not self.batcher.waves:
                    if self.queue.closed and len(self.queue) == 0:
                        break
                    self.metrics.maybe_emit(self.serve_cfg.stats_interval_s)
                    if len(self.queue) == 0:
                        time.sleep(self.serve_cfg.idle_poll_s)
                    continue
                t0 = time.perf_counter()
                try:
                    if wd is not None:
                        # The token is this source: a late stall callback can
                        # never abort its replacement.
                        wd.arm(token=self._source)
                    self._sweep()
                except (ShardLoadError, SourceClosed, OSError, SpillCorruptError) as e:
                    self._recover(e)
                    continue
                finally:
                    if wd is not None:
                        wd.disarm()
                self._post_sweep(time.perf_counter() - t0)
                self.metrics.maybe_emit(self.serve_cfg.stats_interval_s)
        # flscheck: disable=EXC-TAXONOMY: daemon-thread boundary: engine-fatal errors resolve every in-flight and queued future with the root cause
        except BaseException as e:  # noqa: BLE001 — engine-fatal: every future gets the root cause
            self._fatal(e)
        finally:
            if wd is not None:
                wd.close()
            self._release_weights()

    def _fatal(self, error: BaseException) -> None:
        """Every in-flight and queued request fails with the root cause; the
        loop stops; later submits see ServeClosed. The waves' KV drops, and
        the error's traceback frames (the sweep's shard, activations and
        KV) are cleared: the error outlives the engine in every future."""
        self._error = error
        obs_events.emit("engine_fatal", error=type(error).__name__, detail=str(error)[:200],
                        waves=len(self.batcher.waves),
                        wave_ids=[w.wave_id for w in self.batcher.waves])
        _clear_frames(error)
        for w in self.batcher.waves:
            if w.state is not None:
                w.state.kv_store.clear()
                self._release_pool_handles(w.state)
        self.batcher.fail_all_active(error)
        self.queue.close(drain=False)
        self._release_weights()

    def _recover(self, root: BaseException) -> None:
        """A recoverable fault mid-sweep: the in-flight waves' state is
        unusable, so exactly their requests fail (``WaveAborted``, the fault
        as cause), their KV drops, the weight source restarts at shard 0 and
        the queue keeps being served."""
        self._heartbeat = time.monotonic()
        if self._watchdog is not None:
            # The recovery itself can block (closing a wedged producer).
            self._watchdog.disarm()
        n_waves = len(self.batcher.waves)
        for w in self.batcher.waves:
            if w.state is not None:
                w.state.kv_store.clear()
                self._release_pool_handles(w.state)
        # The root's finished frames would keep the sweep's shard and
        # activations on the card for as long as a failed future lives.
        _clear_frames(root)
        err = WaveAborted(
            f"in-flight wave aborted by a recoverable engine fault ({type(root).__name__}: "
            f"{root}); the engine recovered and keeps serving — resubmit")
        err.__cause__ = root
        for w in self.batcher.waves:
            obs_trace.instant("wave_abort", cat="serve", wave_id=w.wave_id,
                              error=type(root).__name__)
            obs_events.emit("wave_abort", wave_id=w.wave_id, error=type(root).__name__,
                            request_ids=[r.request_id for r in w.requests])
        self.batcher.fail_all_active(err)
        self.metrics.count("engine_recoveries")
        obs_trace.instant("engine_recovery", cat="serve", error=type(root).__name__,
                          waves=n_waves)
        obs_events.emit("engine_recovery", error=type(root).__name__, detail=str(root)[:200],
                        waves=n_waves)
        if n_waves:
            self.metrics.count("waves_aborted", n_waves)
        if not self._resident:
            self._release_weights()
            self._acquire_weights()
            self.metrics.count("source_restarts")

    def _on_stall(self, idle_s: float, token) -> None:
        """The watchdog's thread: abort the stalled source without blocking,
        and only while it is still the live one."""
        if token is None or token is not self._source:
            return
        self.metrics.count("watchdog_stalls")
        token.abort()

    # -- weights -----------------------------------------------------------

    def _mk_source(self, cycle: bool) -> ShardWeightSource:
        cfg = self.cfg
        return ShardWeightSource(
            cfg.model_path, self.layer_names, self.shards, self.dtype, self.device,
            cfg.prefetch_depth, self.model_cfg.tie_word_embeddings,
            verify_weights=cfg.verify_weights, host_cache=self._host_cache,
            readahead_threads=cfg.readahead_threads, retry_policy=cfg.retry_policy(),
            residency=self._residency, cycle=cycle, injector=self._injector,
            retry_recorder=self.metrics.retries, integrity_recorder=self.metrics.integrity,
        )

    def _acquire_weights(self) -> None:
        if self._resident:
            # One pass places every shard, kept for the engine's life.
            src = self._mk_source(cycle=False)
            try:
                self._kept = list(enumerate(src))
            finally:
                self._streamed_before += src.bytes_loaded
                src.close()
        else:
            self._source = self._mk_source(cycle=True)
            self._src_iter = iter(self._source)

    def _release_weights(self) -> None:
        self._kept = None
        if self._source is not None:
            src, self._source, self._src_iter = self._source, None, None
            self._streamed_before += src.bytes_loaded
            src.close()

    def _sweep_shards(self):
        if self._resident:
            return iter(self._kept)
        return enumerate(islice(self._src_iter, len(self.shards)))

    # -- wave setup --------------------------------------------------------

    def _request_size_tokens(self, req: Request) -> int:
        """Prefix tokens + the longest suffix's + the budget, truncated as
        the prompt tokenizer truncates (the submitter's thread)."""
        pids = self.raw_tokenizer(req.prefix, truncation=True,
                                  max_length=self.cfg.max_token_len)["input_ids"]
        longest = 0
        if req.suffixes:
            sids = self.raw_tokenizer(list(req.suffixes), truncation=True,
                                      max_length=self.cfg.max_token_len)["input_ids"]
            longest = max((len(s) for s in sids), default=0)
        return len(pids) + longest + req.max_new_tokens

    def _prefix_key(self, prefix: str) -> tuple:
        """The coalescing key: the prefix's token ids, truncated as the
        prompt tokenizer truncates."""
        return tuple(self.raw_tokenizer(prefix, truncation=True,
                                        max_length=self.cfg.max_token_len)["input_ids"])

    def _prefix_kv_bytes(self, prefix_tokens: int) -> int:
        """The prefix KV one prefill makes, from the shapes: the savings of a
        coalesced entry when the pool is off."""
        mc = self.model_cfg
        return int(prefix_tokens * mc.num_hidden_layers * mc.num_key_value_heads
                   * (mc.head_dim + mc.v_dim) * self.dtype.itemsize)

    def _note_coalesced(self, wave, entry, tp, saved: int) -> None:
        """One coalesced entry's savings, counted and traced: from the
        pool's own pages (at seal for a fresh prefill, at admission for a
        reuse entry), or from the shapes with the pool off."""
        self._sched.note_coalesced(len(entry.requests), saved)
        if obs_trace.enabled():
            obs_trace.instant("prefix_coalesce", cat="sched", wave_id=wave.wave_id,
                              requests=len(entry.requests),
                              request_ids=[r.request_id for r in entry.requests],
                              prefix_tokens=tp.prefix_len, kv_bytes_saved=saved)

    def _pool_saved(self, entry, handle) -> int:
        return (len(entry.requests) - 1) * self._kv_pool.entry_bytes(handle)

    def _tokenize_entry(self, entry):
        """One (prefix, suffixes) prompt per entry; a resumed request's
        served tokens fold into its suffix rows as ids (resume entries are
        never coalesced), so its prefill recomputes the interrupted decode's
        KV."""
        tp = self.tokenizer(entry.prefix, entry.suffixes)
        r = entry.requests[0]
        if len(entry.requests) == 1 and r.resume_len:
            gen = np.stack(r.resume_tokens, axis=1).astype(np.int32)
            tp = extend_tokenized(tp, gen, self.tokenizer.pad_id, self.cfg.bucket_multiple,
                                  self.cfg.max_token_len)
        return tp

    def _release_pool_handles(self, st: _WaveState) -> None:
        """Drop a wave's leases (idempotent); the pages stay for reuse."""
        if self._kv_pool is None:
            return
        for h in st.pool_handles.values():
            self._kv_pool.release(h)

    # -- multi-tenant LoRA --------------------------------------------------

    @staticmethod
    def _entry_adapter(entry) -> str | None:
        """The entry's adapter (None = base); coalesced members agree, the
        adapter being part of the coalescing key."""
        return entry.requests[0].adapter_id

    def _resolve_adapters(self, wave: Wave):
        """Resolve each entry's adapter at wave setup: ``(ok, plans,
        factors)`` by adapter name. An unknown or corrupt adapter (or a
        filesystem error reading it) fails only its entry's requests, typed,
        and the entry leaves the wave; ``ok`` is False when none is left
        (the wave is removed)."""
        entries = wave.ensure_entries()
        plans: dict[str, Any] = {}
        factors: dict[str, Any] = {}
        keep = []
        for e in entries:
            aid = self._entry_adapter(e)
            if aid is not None and aid not in plans:
                try:
                    if self._adapter_store is None:
                        raise AdapterNotFound(
                            f"adapter {aid!r} requested but adapter serving is off — start with "
                            "--adapter_dir")
                    plan, fac = self._adapter_store.get(aid)
                    if plan.hidden_size != self.model_cfg.hidden_size:
                        raise AdapterCorruptError(
                            f"adapter {aid!r} was built for hidden_size={plan.hidden_size}; this "
                            f"model has {self.model_cfg.hidden_size}")
                except (AdapterNotFound, ShardLoadError, OSError) as err:
                    for r in e.requests:
                        if not r.status.terminal and r.fail(err, RequestStatus.FAILED):
                            self.metrics.count("failed")
                    self.metrics.count("adapter_rejects")
                    obs_trace.instant("adapter_reject", cat="adapter", wave_id=wave.wave_id,
                                      adapter=aid, error=type(err).__name__)
                    obs_events.emit("adapter_reject", adapter=aid, error=type(err).__name__,
                                    detail=str(err)[:200],
                                    request_ids=[r.request_id for r in e.requests])
                    continue
                plans[aid] = plan
                factors[aid] = fac
            keep.append(e)
        if len(keep) != len(entries):
            wave.entries = keep
            wave.requests = [r for e in keep for r in e.requests]
            if not keep:
                self.batcher.waves.remove(wave)
                return False, plans, factors
        return True, plans, factors

    def _shard_decoder_layers(self, layer_idxs) -> list[str]:
        """The shard's decoder layer names in stream order."""
        return [self.layer_names[i] for i in layer_idxs
                if self.layer_names[i].startswith("model.layers.")]

    def _segment_delta(self, st: _WaveState, shard_pos: int, di: int, seg_layers, b: int):
        """The delta one decoder segment takes for block ``b``, or None for a
        base-only wave. Each layer's factors of every adapter of the wave,
        at the adapter's own rank (``lora_shift_rows``), are uploaded once
        per wave and counted in the store's ``delta_bytes``."""
        if st.adapter_scales is None:
            return None
        key = (shard_pos, di)
        pairs = st.adapter_pairs.get(key)
        if pairs is None:
            pairs, nbytes = [], 0
            for lname in seg_layers:
                layer = {}
                for gi, name in enumerate(st.adapter_names):
                    pair = st.adapter_factors[name].get(lname) if name is not None else None
                    if pair is not None:
                        layer[gi] = (pair["lora_A"].to(self.device), pair["lora_B"].to(self.device))
                        nbytes += adapter_apply.delta_nbytes(pair)
                pairs.append(layer)
            st.adapter_pairs[key] = pairs
            if self._adapter_store is not None:
                self._adapter_store.note_applied(0, nbytes)
        if st.adapter_scale_dev is None:
            st.adapter_scale_dev = torch.from_numpy(st.adapter_scales).to(self.device)
        return {"pairs": pairs, "g": st.adapter_g[b], "scale": st.adapter_scale_dev}

    # -- sweep-boundary preemption ------------------------------------------

    def _maybe_preempt(self) -> None:
        """At a shard-0 boundary: retire the wave the scheduler names (an
        interactive request waits, no active slot is free, a best-effort
        wave is in flight). Never mid-sweep."""
        if self._sched is None:
            return
        free = self.serve_cfg.max_active_requests - self.batcher.active_requests
        victim = self._sched.pick_preempt(self.batcher.waves, self.queue, free)
        if victim is not None:
            self._preempt_wave(victim)

    def _preempt_wave(self, wave: Wave) -> None:
        """Retire one wave at a boundary, resolving nothing: each live
        request keeps the steps this wave served it (scores and token ids)
        as resume state, goes back to QUEUED and to the queue's front. The
        wave's KV drops and its pool leases are released; the pages stay,
        so a resumed entry acquires the same sealed prefix."""
        st = wave.state
        live: list[Request] = []
        for r in wave.requests:
            if r.status.terminal:
                continue
            if st is not None and wave.steps > 0:
                e_idx, s_off, s_cnt = wave.locate(r)
                b, row = st.loc[e_idx]
                # A twice-preempted request's earlier steps are already kept.
                done_here = max(r.tokens_emitted - r.resume_len, 0)
                if st.spec is not None:
                    # Up to the slowest suffix (tokens_emitted): a suffix
                    # ahead on accepted drafts drops the surplus, which the
                    # resumed wave derives again, token for token.
                    sc, tk = st.spec[b].request_steps(row, s_off, s_cnt, done_here)
                    r.resume_scores.extend(sc)
                    r.resume_tokens.extend(tk)
                else:
                    for t in range(done_here):
                        r.resume_scores.append(st.scores[b][t][row, s_off:s_off + s_cnt].copy())
                        r.resume_tokens.append(st.tok_hist[b][t][row, s_off:s_off + s_cnt].copy())
            if r.first_token_at is not None:
                # The admission deadline guards the first token, already out.
                r.deadline = None
            r.status = RequestStatus.QUEUED
            live.append(r)
        if st is not None:
            st.kv_store.clear()
            self._release_pool_handles(st)
        self.batcher.waves.remove(wave)
        self._sched.note_preempted(len(live))
        obs_trace.instant("wave_preempt", cat="sched", wave_id=wave.wave_id, requests=len(live),
                          steps=wave.steps, request_ids=[r.request_id for r in live])
        obs_events.emit("wave_preempt", wave_id=wave.wave_id, steps=wave.steps,
                        request_ids=[r.request_id for r in live])
        self.queue.requeue(live)

    def _init_wave(self, wave: Wave) -> bool:
        """Tokenize and bucket the wave's entries and allocate its state. A
        bad request (a longrope straddle, a malformed prompt, an allocation
        that fails) fails only this wave; anything else is engine-fatal. An
        entry whose adapter does not resolve fails alone, first."""
        ok, a_plans, a_factors = self._resolve_adapters(wave)
        if not ok:
            return False
        entries = wave.ensure_entries()
        # Only a wave that decodes drafts.
        spec_wave = self._spec_k > 0 and wave.max_steps > 1
        pool_handles: dict[int, Any] = {}
        try:
            toks = [self._tokenize_entry(e) for e in entries]
            # A verify pass's K+1 window may overshoot the budget by K.
            check_longrope_regime(self.model_cfg, toks, extra_len=max(wave.max_steps - 1, 0)
                                  + (self._spec_k if spec_wave else 0))
            if self._sched is not None and self._kv_pool is None:
                # Pool off: the savings from the shapes, at admission.
                for e, tp in zip(entries, toks):
                    if len(e.requests) > 1:
                        saved = (len(e.requests) - 1) * self._prefix_kv_bytes(tp.prefix_len)
                        self._note_coalesced(wave, e, tp, saved)
            blocks = make_blocks(toks, self.cfg.block_size)
            meta = {b: block_meta(toks, idxs, self.device) for b, idxs in enumerate(blocks)}
            loc = {i: (b, row) for b, idxs in enumerate(blocks) for row, i in enumerate(idxs)}
            # Lease each entry's block table; a block whose every row leases
            # a sealed entry skips its prefix prefill.
            reuse_blocks: set[int] = set()
            if self._kv_pool is not None:
                for i, tp in enumerate(toks):
                    ids = tuple(int(t) for t in tp.prefix_ids[: tp.prefix_len])
                    # Salted by the adapter: the same prefix under another
                    # adapter is other KV and never shares pages.
                    pool_handles[i] = self._kv_pool.acquire(ids, int(tp.prefix_len),
                                                            int(tp.prefix_ids.shape[0]),
                                                            salt=self._entry_adapter(entries[i]))
                for b, idxs in enumerate(blocks):
                    if idxs and all(pool_handles[i].reusable for i in idxs):
                        reuse_blocks.add(b)
                for i, (e, tp) in enumerate(zip(entries, toks)):
                    reused = loc[i][0] in reuse_blocks
                    key = "prefix_reuse_tokens" if reused else "prefix_prefill_tokens"
                    self.metrics.count(key, int(tp.prefix_len))
                    if reused and self._sched is not None and len(e.requests) > 1:
                        self._note_coalesced(wave, e, tp, self._pool_saved(e, pool_handles[i]))
            # Generated-KV slots and the KV placement: the offline rules.
            slots = self._sched_core.gen_slots(wave.max_steps, self._spec_k, spec_wave)
            kv_on_device = self._sched_core.kv_on_device(
                self.model_cfg, self.cfg.dtype, toks, blocks, slots, self._resident,
                device=self.device)
            # LoRA grouping: one wave-level (names, g), so one scale vector
            # and one factor stack serve every block; a base-only wave keeps
            # its adapter state empty.
            a_names: list = []
            a_scales = None
            a_g: dict[int, list[int]] = {}
            if a_plans:
                a_names, g_all = adapter_apply.group_rows(
                    [self._entry_adapter(e) for e in entries])
                a_scales = adapter_apply.group_scales(a_names, a_plans)
                a_g = {b: [int(g_all[i]) for i in idxs] for b, idxs in enumerate(blocks)}
                if obs_trace.enabled():
                    obs_trace.instant("adapter_apply", cat="adapter", wave_id=wave.wave_id,
                                      adapters=[n for n in a_names if n is not None],
                                      rows=int((np.asarray(g_all) != 0).sum()))
            wave.state = _WaveState(
                toks=toks, blocks=blocks, meta=meta,
                kv_store=KVStore(kv_on_device, self.device),
                scores={b: [] for b in range(len(blocks))},
                tok_hist={b: [] for b in range(len(blocks))},
                loc=loc, slots=slots, pool_handles=pool_handles, reuse_blocks=reuse_blocks,
                adapter_names=a_names, adapter_scales=a_scales, adapter_factors=a_factors,
                adapter_g=a_g,
            )
            return True
        except (ValueError, KeyError, TypeError, IndexError, MemoryError) as e:
            if self._kv_pool is not None:
                for h in pool_handles.values():
                    self._kv_pool.release(h)
            for r in wave.requests:
                if not r.status.terminal and r.fail(e, RequestStatus.FAILED):
                    self.metrics.count("failed")
            self.batcher.waves.remove(wave)
            obs_trace.instant("wave_reject", cat="serve", wave_id=getattr(wave, "wave_id", -1),
                              error=type(e).__name__)
            obs_events.emit("wave_reject", wave_id=getattr(wave, "wave_id", -1),
                            error=type(e).__name__,
                            request_ids=[r.request_id for r in wave.requests])
            return False

    # -- per-shard compute -------------------------------------------------

    def _sweep(self) -> None:
        """One weight pass: the prefill of the waves at step 0, one decode
        step of every other wave."""
        wd = self._watchdog
        sweep_id = obs_trace.new_sweep_id() if obs_trace.enabled() else 0
        with obs_trace.span("sweep", cat="serve", sweep_id=sweep_id, mode="serve",
                            waves=len(self.batcher.waves)):
            for shard_pos, (layer_idxs, segments) in self._sweep_shards():
                if tuple(layer_idxs) != tuple(self.shards[shard_pos]):
                    raise RuntimeError(f"sweep out of phase: shard {tuple(layer_idxs)} arrived "
                                       f"at position {shard_pos} of {self.shards}")
                if wd is not None:
                    wd.tick()
                self._sweep_pos = shard_pos
                self._heartbeat = time.monotonic()
                if self.fleet_hook is not None:
                    # The fleet's stagger hold (shard 0) and its replica
                    # chaos: replica_kill raises the engine-fatal
                    # ReplicaKilled, replica_stall wedges this thread until
                    # the fleet releases it.
                    self.fleet_hook(shard_pos)
                if self._injector is not None:
                    self._injector.fire("engine_step", detail=f"shard{shard_pos}")
                if (self._crash_sweeps and self._sweeps_done >= self._crash_sweeps
                        and (shard_pos > 0 or len(self.shards) == 1)):
                    # The process-death drill: no cleanup, nothing flushed
                    # beyond what the WAL already handed the kernel.
                    os.kill(os.getpid(), signal.SIGKILL)
                for wave in self.batcher.waves:
                    if wave.steps == 0:
                        name, step = "prefill_shard", self._prefill_shard
                    elif wave.state.spec is not None:
                        name, step = "decode_shard", self._spec_decode_shard
                    else:
                        name, step = "decode_shard", self._decode_shard
                    with obs_trace.span(name, cat="serve", sweep_id=sweep_id,
                                        shard_idx=shard_pos, wave_id=wave.wave_id):
                        step(wave, shard_pos, layer_idxs, segments)
                del segments
            self._sweep_pos = 0

    def _assemble(self, st: _WaveState, b: int, seg_key: tuple, n_layers: int):
        """One block's pooled prefix KV of a decoder segment on the device:
        per layer (kp, vp) [B, Lp, n_kv, hd], uploaded from page-locked
        memory in the compute dtype."""
        rows = [self._kv_pool.assemble(st.pool_handles[i], seg_key) for i in st.blocks[b]]
        out = []
        for j in (0, 1):
            host = torch.stack([r[j] for r in rows], dim=1).to(self.dtype)  # [k, B, Lp, n, hd]
            if self.device.type == "cuda":
                host = host.pin_memory()
            dev = host.to(self.device, non_blocking=True)
            out.append([dev[layer] for layer in range(n_layers)])
        return out

    def _bank(self, st: _WaveState, b: int, seg_key: tuple, kvs: list[dict]) -> None:
        """Contribute a block segment's prefix KV to the pool, one row per
        entry; the copy to the host completes before the entry can seal."""
        k = torch.stack([kv["kp"].to("cpu") for kv in kvs])  # [k, B, Lp, n_kv, hd]
        v = torch.stack([kv["vp"].to("cpu") for kv in kvs])
        for row, i in enumerate(st.blocks[b]):
            self._kv_pool.contribute(st.pool_handles[i], seg_key, k[:, row], v[:, row])

    def _prefill_shard(self, wave: Wave, shard_pos: int, layer_idxs, segments) -> None:
        st: _WaveState = wave.state
        mcfg = self.model_cfg
        dec_names = self._shard_decoder_layers(layer_idxs) if st.adapter_scales is not None else ()
        for b in range(len(st.blocks)):
            prefix_ids, suffix_ids, prefix_len, suffix_eos = st.meta[b]
            # A reuse block never runs its prefix stream: the suffix stream
            # sees the prefix only through its post-rope KV, so the suffix
            # half over the assembled pages is bit-equal.
            reuse = b in st.reuse_blocks
            total_len = longrope_total_len(mcfg, prefix_len, suffix_eos)
            ph = sh = None
            if layer_idxs[0] != 0:
                ph, sh = st.kv_store.get(("h", b))
            di = li0 = 0
            for kind, params in segments:
                if kind == "embed":
                    ph = None if reuse else llama.embed(params, prefix_ids, self.dtype, mcfg)
                    sh = llama.embed(params, suffix_ids, self.dtype, mcfg)
                elif kind == "decoders":
                    first = first_decoder(layer_idxs) + li0
                    delta = self._segment_delta(st, shard_pos, di,
                                                dec_names[li0:li0 + len(params)], b)
                    if reuse:
                        kps, vps = self._assemble(st, b, (shard_pos, di), len(params))
                        sh, kvs = suffix_prefill_decoders(mcfg, params, first, kps, vps, sh,
                                                          prefix_len, total_len, self._sliding,
                                                          self._rope_on, delta=delta,
                                                          use_pallas=self._use_pallas)
                        ph = None
                    else:
                        ph, sh, kvs = prefill_decoders(mcfg, params, first, ph, sh, prefix_len,
                                                       total_len, self._sliding, self._rope_on,
                                                       delta=delta, use_pallas=self._use_pallas)
                        if self._kv_pool is not None and st.pool_handles:
                            self._bank(st, b, (shard_pos, di), kvs)
                    for li, kv in enumerate(kvs):
                        st.kv_store.put(("kv", shard_pos, li0 + li, b), extend_gen_kv(kv, st.slots))
                    del kvs
                    di += 1
                    li0 += len(params)
                elif kind == "norm":
                    sh = llama.select_eos_and_norm(params, mcfg, sh, suffix_eos)
                    ph = None
                else:  # head
                    dist = llama.lm_head_scores(params, sh, mcfg.final_logit_softcap)
                    dist = dist.to("cpu").numpy()
                    st.scores[b].append(dist)
                    st.tok_hist[b].append(np.argmax(dist, axis=-1))
            if layer_idxs[-1] != self._n_layers - 1:
                st.kv_store.put(("h", b), (ph, sh))

    def _decode_shard(self, wave: Wave, shard_pos: int, layer_idxs, segments) -> None:
        st: _WaveState = wave.state
        mcfg = self.model_cfg
        t = wave.steps - 1  # this step's generated-KV slot
        dec_names = self._shard_decoder_layers(layer_idxs) if st.adapter_scales is not None else ()
        for b in range(len(st.blocks)):
            # A block whose requests all resolved sits the sweep out
            # (statuses change only in _post_sweep).
            if all(r.status.terminal for i in st.blocks[b] for r in wave.entries[i].requests):
                continue
            _, _, prefix_len, suffix_eos = st.meta[b]
            x = None if layer_idxs[0] == 0 else st.kv_store.get(("x", b))
            li0 = di = 0
            for kind, params in segments:
                if kind == "embed":
                    ids = torch.from_numpy(np.asarray(st.tok_hist[b][-1])[..., None])
                    x = llama.embed(params, ids.to(self.device), self.dtype, mcfg)
                elif kind == "decoders":
                    keys = [("kv", shard_pos, li0 + li, b) for li in range(len(params))]
                    kvs = [st.kv_store.get(key) for key in keys]
                    delta = self._segment_delta(st, shard_pos, di,
                                                dec_names[li0:li0 + len(params)], b)
                    x = decode_decoders(mcfg, params, first_decoder(layer_idxs) + li0, kvs, x,
                                        prefix_len, suffix_eos, t, self._sliding, self._rope_on,
                                        delta=delta, use_pallas=self._use_pallas)
                    for key, kv in zip(keys, kvs):
                        st.kv_store.put(key, kv)
                    li0 += len(params)
                    di += 1
                elif kind == "norm":
                    st.norm_p = params  # applied in the head shard
                else:  # head
                    assert st.norm_p is not None
                    dist = decode_norm_head(mcfg, st.norm_p, params, x).to("cpu").numpy()
                    st.scores[b].append(dist)
                    st.tok_hist[b].append(np.argmax(dist, axis=-1))
            if layer_idxs[-1] != self._n_layers - 1:
                st.kv_store.put(("x", b), x)

    def _init_spec(self, wave: Wave) -> None:
        """Arm a freshly prefilled wave's verify passes: one SpecVerifier per
        block from the prefill's distributions and picks, each suffix's
        draft context its prefix, suffix (a resumed request's served tokens
        included) and first pick, its budget the owning request's remaining
        tokens."""
        st: _WaveState = wave.state
        st.spec, st.spec_classes = {}, {}
        draft_fn = self._draft_model.propose if self._draft_model is not None else None
        for b, idxs in enumerate(st.blocks):
            bsz, s_b = len(idxs), st.toks[idxs[0]].suffix_ids.shape[0]
            budgets = np.ones((bsz, s_b), np.int64)  # padding rows: frozen at once
            active = np.zeros((bsz, s_b), bool)
            classes: list[list] = [[None] * s_b for _ in range(bsz)]
            for row, e_idx in enumerate(idxs):
                e = wave.entries[e_idx]
                for (off, cnt), member in zip(e.slices, e.requests):
                    budgets[row, off:off + cnt] = member.max_new_tokens - member.resume_len
                    active[row, off:off + cnt] = True
                    for s in range(off, off + cnt):
                        classes[row][s] = member.slo_class
            st.spec_classes[b] = classes
            st.spec[b] = SpecVerifier(
                self._spec_k, draft_fn, draft_contexts([st.toks[i] for i in idxs],
                                                       st.tok_hist[b][0]),
                budgets, st.scores[b][0], st.tok_hist[b][0], active=active)

    def _spec_decode_shard(self, wave: Wave, shard_pos: int, layer_idxs, segments) -> None:
        """One shard of a verify pass: the embed segment fixes each block's
        fed window (last accepted token plus drafts) and slot offsets, the
        decoder segments run the K+1 tokens, the head accepts."""
        st: _WaveState = wave.state
        mcfg = self.model_cfg
        dec_names = self._shard_decoder_layers(layer_idxs) if st.adapter_scales is not None else ()
        for b in range(len(st.blocks)):
            v = st.spec[b]
            if v.done or all(r.status.terminal for i in st.blocks[b]
                             for r in wave.entries[i].requests):
                continue
            _, _, prefix_len, suffix_eos = st.meta[b]
            x = None if layer_idxs[0] == 0 else st.kv_store.get(("x", b))
            li0 = di = 0
            for kind, params in segments:
                if kind == "embed":
                    if self._spec_ctrl is not None:
                        v.set_pass_k(self._spec_ctrl.assign(st.spec_classes[b], v.budgets - v.g))
                    fed, base = v.begin_pass()
                    st.spec_base[b] = torch.from_numpy(base).to(self.device)
                    # The suffixes that drafted this pass (begin_pass skips
                    # remaining == 1), as spec_verify counts them.
                    if obs_trace.enabled():
                        obs_trace.instant("spec_draft", cat="spec", wave_id=wave.wave_id,
                                          block=b, drafted=int((v.budgets - v.g > 1).sum()))
                    x = llama.embed(params, torch.from_numpy(fed).to(self.device), self.dtype,
                                    mcfg)
                elif kind == "decoders":
                    keys = [("kv", shard_pos, li0 + li, b) for li in range(len(params))]
                    kvs = [st.kv_store.get(key) for key in keys]
                    delta = self._segment_delta(st, shard_pos, di,
                                                dec_names[li0:li0 + len(params)], b)
                    x = decode_decoders(mcfg, params, first_decoder(layer_idxs) + li0, kvs, x,
                                        prefix_len, suffix_eos, st.spec_base[b], self._sliding,
                                        self._rope_on, delta=delta, use_pallas=self._use_pallas)
                    for key, kv in zip(keys, kvs):
                        st.kv_store.put(key, kv)
                    li0 += len(params)
                    di += 1
                elif kind == "norm":
                    st.norm_p = params  # applied in the head shard
                else:  # head
                    assert st.norm_p is not None
                    dist = spec_norm_head(mcfg, st.norm_p, params, x).to("cpu").numpy()
                    before = (v.drafted, v.accepted, v.rejected)
                    emitted = v.finish_pass(dist)
                    self._count_spec(v, st.spec_classes[b], before)
                    if obs_trace.enabled():
                        obs_trace.instant("spec_verify", cat="spec", wave_id=wave.wave_id,
                                          block=b, accepted=int(v.accepted - before[1]),
                                          drafted=int(v.drafted - before[0]),
                                          emitted=int(emitted.sum()))
            if layer_idxs[-1] != self._n_layers - 1:
                st.kv_store.put(("x", b), x)

    def _count_spec(self, v: SpecVerifier, classes, before) -> None:
        """A pass's drafted and accepted tokens, split by each row's class
        (the sums are the pass's totals: padding rows draft nothing), fed to
        the adaptive controller."""
        per_cls: dict[str, list[int]] = {}
        for r_i, s_i in zip(*np.nonzero(v.last_drafted > 0)):
            acc = per_cls.setdefault(classes[r_i][s_i], [0, 0])
            acc[0] += int(v.last_drafted[r_i, s_i])
            acc[1] += int(v.last_accepted[r_i, s_i])
        if not per_cls:
            self.metrics.spec_count(drafted=v.drafted - before[0], accepted=v.accepted - before[1],
                                    rejected=v.rejected - before[2])
        for cls, (c_d, c_a) in per_cls.items():
            self.metrics.spec_count(drafted=c_d, accepted=c_a, rejected=c_d - c_a,
                                    slo_class=cls)
            if self._spec_ctrl is not None:
                self._spec_ctrl.observe(cls, c_d, c_a)

    # -- after each sweep --------------------------------------------------

    def _post_sweep(self, sweep_wall_s: float) -> None:
        now = time.monotonic()
        emitted = 0
        for wave in self.batcher.waves:
            prefilled = wave.steps == 0
            wave.steps += 1
            st = wave.state
            if prefilled:
                self.metrics.count("prefills")
                if self._kv_pool is not None and st is not None:
                    # The prefill completed: seal each freshly prefilled
                    # entry, reusable by later waves from here on, and count
                    # a coalesced entry's savings from its pages.
                    for i, handle in st.pool_handles.items():
                        if st.loc[i][0] not in st.reuse_blocks:
                            self._kv_pool.seal(handle)
                            e = wave.entries[i]
                            if self._sched is not None and len(e.requests) > 1:
                                self._note_coalesced(wave, e, st.toks[i],
                                                     self._pool_saved(e, handle))
                if self._spec_k > 0 and wave.max_steps > 1:
                    self._init_spec(wave)
            if self._adapter_store is not None and st is not None and st.adapter_scales is not None:
                # The rows of this wave that decoded under a delta this sweep.
                rows = sum(1 for g in st.adapter_g.values() for gi in g if gi)
                if rows:
                    self._adapter_store.note_applied(rows, 0)
            for r in wave.requests:
                if r.status.terminal:
                    continue
                prev_emitted = r.tokens_emitted
                if prefilled and r.first_token_at is None:
                    r.first_token_at = now
                    self.metrics.observe_ttft(now - r.arrival, r.slo_class)
                    obs_trace.instant("ttft", cat="serve", wave_id=wave.wave_id,
                                      request_id=r.request_id,
                                      seconds=round(now - r.arrival, 6))
                if st is not None and st.spec is not None:
                    # A verify pass advances each suffix by 1..K+1 tokens;
                    # the request's progress is its slowest suffix's.
                    e_idx, s_off, s_cnt = wave.locate(r)
                    b, row = st.loc[e_idx]
                    prog = min(st.spec[b].emitted(row, s_off + s) for s in range(s_cnt))
                    new_total = min(r.resume_len + prog, r.max_new_tokens)
                    emitted += max(new_total - r.tokens_emitted, 0)
                    r.tokens_emitted = new_total
                elif r.tokens_emitted < r.max_new_tokens:
                    r.tokens_emitted += 1
                    emitted += 1
                if self._wal is not None and r.tokens_emitted > prev_emitted:
                    # The sweep's progress record: the count and the ids it
                    # emitted (forensics; a replay derives them again).
                    self._wal.progress(r, tok_delta=self._wal_tok_delta(wave, r, prev_emitted))
                if r.tokens_emitted >= r.max_new_tokens:
                    self._resolve(wave, r)
        self.metrics.count("sweeps")
        self._sweeps_done += 1
        self._slo.maybe_check()
        if emitted:
            self.metrics.count("tokens_emitted", emitted)
            self.metrics.observe_token_latency(sweep_wall_s)
            obs_trace.instant("token_latency", cat="serve", seconds=round(sweep_wall_s, 6),
                              tokens=emitted)
        for w in self.batcher.retire_done():
            if w.state is not None:
                w.state.kv_store.clear()
                self._release_pool_handles(w.state)

    def _wal_tok_delta(self, wave: Wave, r: Request, prev_emitted: int):
        """The token ids this sweep emitted for ``r``, ``[step][suffix]``;
        None for a speculative wave (its histories are ragged per suffix:
        the record keeps the count only)."""
        st = wave.state
        if st is None or st.spec is not None:
            return None
        e_idx, s_off, s_cnt = wave.locate(r)
        b, row = st.loc[e_idx]
        hist = st.tok_hist[b]
        lo, hi = prev_emitted - r.resume_len, r.tokens_emitted - r.resume_len
        if lo < 0 or hi > len(hist):
            return None
        return [[int(t) for t in hist[step][row, s_off:s_off + s_cnt]] for step in range(lo, hi)]

    def _resolve(self, wave: Wave, r: Request) -> None:
        st: _WaveState = wave.state
        e_idx, s_off, s_cnt = wave.locate(r)
        b, row = st.loc[e_idx]
        # This wave's steps, behind a resumed request's earlier ones.
        rem = r.max_new_tokens - r.resume_len
        if st.spec is not None:
            sc, tk = st.spec[b].request_steps(row, s_off, s_cnt, rem)
        else:
            sc = [st.scores[b][t][row, s_off:s_off + s_cnt] for t in range(rem)]
            tk = [st.tok_hist[b][t][row, s_off:s_off + s_cnt] for t in range(rem)]
        scores = np.stack(list(r.resume_scores) + sc, axis=1)
        tokens = np.stack(list(r.resume_tokens) + tk, axis=1)
        updated = (r.prefix, tuple(s + self.raw_tokenizer.decode(tokens[s_i])
                                   for s_i, s in enumerate(r.suffixes)))
        latency = time.monotonic() - r.arrival
        if r.resolve(scores, updated, tokens):
            self.metrics.count("completed")
            self.metrics.count("tokens_served", r.tokens_emitted)
            self.metrics.observe_request_latency(latency, r.slo_class)
            obs_trace.instant("request_finish", cat="serve", wave_id=wave.wave_id,
                              request_id=r.request_id, tokens=int(r.max_new_tokens))


__all__ = ["ServeEngine"]
