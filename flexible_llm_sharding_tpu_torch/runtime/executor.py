"""The streaming executor: the model passes through the device one shard of
layers at a time (the JAX package's ``runtime/executor.py``).

For every shard, every block of same-bucket prompts runs through the
shard's layers before the next shard is loaded; activations wait in an
``ActivationStore`` between shards. ``ShardWeightSource`` streams the
weights: with ``prefetch_depth >= 1`` a thread stays that many shards ahead
of compute — while shard t computes, it reads shard t+1 from disk into
page-locked host memory and uploads it on a side CUDA stream; an event
orders each upload before the compute that reads it. As in the JAX batch
CLI's defaults, every read retries, is verified against ``integrity.json``
and is served from the process host shard cache when a pass has read it
before, with the next shard's files read ahead into the page cache.

Quantized checkpoints (int8, int4, per-layer plans) cross the link packed
and are dequantized to the compute dtype on the device, on the upload
stream, before the shard's event: the compute stream never sees a packed
tensor. With a residency tier (``runtime/residency.py``, ``hbm_pin_gb``)
the pinned layers are loaded once, kept on the device, subtracted from
every shard build and merged back in layer order.

The head stage's scores stay on the card: each block's copy into
page-locked host memory starts on a side stream (``ScoreSink``), and only
past ``score_sink_max_device`` pending prompts does the host wait on the
oldest; ``finalize_scores`` resolves the rest at the end of the run.

In disk mode a marker (``runtime/resume.py``) records each completed shard
once its activation files are flushed, and ``resume`` restarts a crashed run
at the first shard left; a spill that stays corrupt after its re-reads is
recomputed from the previous shard, whose inputs the other disk generation
still holds.

Under fault injection (``FrameworkConfig.faults``) the JAX package's sites
fire at its positions: ``shard_read`` and ``host_oom`` before every read
attempt, ``corrupt_shard`` on the read's tensors before their checksum
check, and ``link_throttle`` then ``device_put`` before every upload
attempt, which is retried (``label="device_put"``) like a read. A
``MemoryError`` while a shard is built becomes the retryable
``HostOOMError`` and a pressure event (``runtime/pressure.py``).

The multi-device modes: ``ShardWeightSource(devices=...)`` uploads each
shard to its own device (the MP pipeline's stages, ``runtime/pipeline.py``,
each on its device's upload stream), and ``BroadcastShardSource`` reads each
shard once and places it on every DP rank's device, one bounded queue per
rank; a DP rank's ``StreamingExecutor`` takes its view through
``weight_source_factory``.

Tracing (``obs/trace.py``, JAX's span names and attributes): a call is one
``sweep`` span holding a ``source_wait`` and a ``compute`` per shard; the
producer's ``shard_produce`` holds the read (``shard_load``) and the
upload's enqueue (``device_put``). ``compute`` closes after the device
synchronization that ``compute_wall_s`` measures; ``device_put`` is host
time, not the copy. Quarantines, re-read heals and spill recomputes are
trace instants and journal events (``obs/events.py``).
"""

from __future__ import annotations

import os
import threading
import time
import warnings
from queue import Empty, Full, Queue
from typing import Any, Sequence

import numpy as np
import torch

from flexible_llm_sharding_tpu_torch.config import FrameworkConfig, LlamaConfig, resolve_device
from flexible_llm_sharding_tpu_torch.faults.inject import FaultInjector
from flexible_llm_sharding_tpu_torch.faults.retry import RetryPolicy, ShardLoadError, retry_call
from flexible_llm_sharding_tpu_torch.integrity import manifest as integrity_manifest
from flexible_llm_sharding_tpu_torch.integrity.manifest import (
    ChecksumMismatch,
    ShardCorruptError,
    SpillCorruptError,
)
from flexible_llm_sharding_tpu_torch.models import llama
from flexible_llm_sharding_tpu_torch.obs import events as obs_events
from flexible_llm_sharding_tpu_torch.obs import trace as obs_trace
from flexible_llm_sharding_tpu_torch.obs.registry import REGISTRY
from flexible_llm_sharding_tpu_torch.parallel.planner import ShardPlan, plan_shards_dp
from flexible_llm_sharding_tpu_torch.runtime import residency, resume
from flexible_llm_sharding_tpu_torch.runtime.activations import ActivationStore, batch_tag
from flexible_llm_sharding_tpu_torch.runtime.hostcache import (
    HostShardCache,
    cache_for,
    stat_guard,
    tree_nbytes,
)
from flexible_llm_sharding_tpu_torch.runtime.pressure import HostOOMError
from flexible_llm_sharding_tpu_torch.runtime.pressure import note_event as _note_pressure_event
from flexible_llm_sharding_tpu_torch.runtime.tokenization import (
    PromptTokenizer,
    TokenizedPrompt,
    check_longrope_regime,
    longrope_total_len,
    make_blocks,
)
from flexible_llm_sharding_tpu_torch.utils import checkpoint, metrics
from flexible_llm_sharding_tpu_torch.utils.metrics import IntegrityRecorder, RetryRecorder
from flexible_llm_sharding_tpu_torch.utils.native import FilePrefetcher

Segments = list[tuple[str, Any]]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _tree_leaves(tree) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    _tree_map(out.append, tree)
    return out


def sync(device: torch.device) -> None:
    """Wait for the device's current stream, so a shard's compute time is a
    device-time measure (the prefetch thread keeps uploading meanwhile)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def peak_mem_gb(device: torch.device) -> float | None:
    """Peak device memory allocated by PyTorch on a CUDA device."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 1e9


class _Fault:
    """Queue envelope for an error raised by the prefetch thread."""

    def __init__(self, error: BaseException):
        self.error = error


class SourceClosed(RuntimeError):
    """The weight source was closed while a consumer waited on it."""


# Process-wide counters: host bytes built for upload (the pressure
# monitor's link signal), and tied lm_head requantizations (a dequant,
# transpose and int8 requant of [V, D], cached per source and in the host
# cache, so a warm process performs none).
_PROCESS_STREAM_LOCK = threading.Lock()
_PROCESS_STREAM_BYTES = [0]
_PROCESS_TIED_REQUANTS = [0]


def process_streamed_bytes() -> int:
    return _PROCESS_STREAM_BYTES[0]


def reset_process_streamed_bytes() -> None:
    """Zero the streamed-bytes counter: the batch CLI does at the start of a
    run, so a second run in one process reports (and the ``stream`` source
    scrapes) its own bytes."""
    with _PROCESS_STREAM_LOCK:
        _PROCESS_STREAM_BYTES[0] = 0


def _count_streamed(nbytes: int) -> None:
    with _PROCESS_STREAM_LOCK:
        _PROCESS_STREAM_BYTES[0] += nbytes


def process_tied_head_requants() -> int:
    return _PROCESS_TIED_REQUANTS[0]


def reset_process_tied_head_requants() -> None:
    with _PROCESS_STREAM_LOCK:
        _PROCESS_TIED_REQUANTS[0] = 0


def stream_stats() -> dict[str, int]:
    """The process stream counters as one registry source (``stream``):
    the batch CLI's ``--metrics_out`` and the serve endpoint read the
    numbers the stats lines print. (The JAX package's ``host_casts`` is
    not among them: the port casts on the device, after the upload.)"""
    return {
        "streamed_bytes": process_streamed_bytes(),
        "tied_head_requants": process_tied_head_requants(),
    }


REGISTRY.register("stream", stream_stats)


def _check_precision_plan(model_path: str, manifest: dict) -> None:
    """Hold a checkpoint's embedded ``PrecisionPlan`` against the manifest's
    recorded dtype kinds; a disagreement, or a plan that is corrupt or
    unreadable, raises ``PrecisionMismatch``. No plan file: a uniform
    checkpoint, nothing to check."""
    from flexible_llm_sharding_tpu_torch.runtime.precisionplan import (
        PrecisionPlan,
        plan_manifest_problems,
    )

    try:
        plan = PrecisionPlan.load(model_path)
    except (ValueError, OSError) as e:
        raise integrity_manifest.PrecisionMismatch(str(e)) from e
    if plan is None:
        return
    problems = plan_manifest_problems(plan, manifest)
    if problems:
        raise integrity_manifest.PrecisionMismatch(
            f"{model_path}: {problems[0][1]} — the checkpoint does not match its embedded "
            "precision plan (audit with the `verify` subcommand)"
        )


def _stream_only(idxs, pinned: frozenset) -> tuple[int, ...]:
    """A shard's layers that still stream (the readahead targets)."""
    return tuple(i for i in idxs if i not in pinned)


def _split_parts(layer_idxs: tuple[int, ...], pinned: frozenset) -> list[tuple[str, Any]]:
    """One shard's build plan in layer order: ``("stream", (idx, ...))``
    runs and ``("pin", idx)`` markers. With no pin in the shard it is one
    stream part of the whole shard, the unpinned build byte for byte."""
    if not any(i in pinned for i in layer_idxs):
        return [("stream", tuple(layer_idxs))]
    parts: list[tuple[str, Any]] = []
    run: list[int] = []
    for i in layer_idxs:
        if i in pinned:
            if run:
                parts.append(("stream", tuple(run)))
                run = []
            parts.append(("pin", i))
        else:
            run.append(i)
    if run:
        parts.append(("stream", tuple(run)))
    return parts


class ShardWeightSource:
    """Shard weights, disk -> host -> device, optionally prefetched (the
    JAX package's ``_HostShardLoader`` and weight source).

    Iterating yields ``(layer_idxs, segments)`` per shard, where segments is
    a list of ``(kind, params)``: ``("embed", {"embedding"})``,
    ``("decoders", [layer dict, ...])``, ``("norm", {"scale"})``,
    ``("head", {"kernel"})``. Weights arrive cast to ``dtype`` on
    ``device``; quantized leaf-groups are uploaded packed and dequantized
    there (on the upload stream on a card, before the shard's event).

    Every layer read retries under ``retry_policy`` and, with
    ``verify_weights``, is checked against the directory's
    ``integrity.json`` (a directory without one warns and loads
    unverified); a checkpoint with an embedded precision plan is checked
    against the manifest first (``PrecisionMismatch``). A mismatch is
    retried like an I/O error; one that survives two or more reads
    quarantines the file, drops it from ``host_cache`` and from the verdict
    cache, and raises ``ShardCorruptError``. With ``host_cache`` (a
    ``HostShardCache``), a shard's host tree — the page-locked tensors the
    read built — is looked up before any byte is read and put after a
    verified build; with tied embeddings the head is read once per source
    and cached under ``__tied_head__`` (from a quantized embedding, the
    transposed dequantized embedding requantized to int8). A readahead pool
    of ``readahead_threads`` (0 = none) warms the next shard's files, less
    the pinned ones.

    ``devices`` (one per shard; default ``device`` for every shard): each
    shard is uploaded to its own device on that device's upload stream, the
    MP pipeline's stages. An empty shard (a round-up padding stage) yields
    no segments.

    ``replicas`` (distinct devices, the first of them ``device``; the
    long-context scorer's): every shard is placed on each of them, on its
    upload stream, from one host build, quantized leaf-groups dequantized
    on each; an item's segments are then a list, one per replica. Each
    placement counts its host bytes in ``bytes_loaded``: a device list
    that names one card several times uploads once.

    ``residency`` (a ``DeviceResidencyTier``): its planned layers among the
    shards are pinned on their shards' devices (every replica) before the first build,
    frozen for this source's life, subtracted from every build and merged
    back in layer order.

    ``injector`` (a ``FaultInjector`` or None) fires ``shard_read`` and
    ``host_oom`` before every read attempt and ``corrupt_shard`` on the
    read tensors before their checksum check (bypassing the verdict cache
    when it flips a bit, so the crc catches it and a re-read heals it),
    and ``link_throttle`` then ``device_put`` before every upload attempt
    of the source's own shards (a broadcast placement is not retried, as
    in the JAX package). A ``MemoryError`` in a read attempt is noted as a
    ``host_oom`` pressure event and retried as ``HostOOMError``.

    ``cycle=True`` loops the shard list endlessly instead of stopping after
    one pass: the serving engine's weight stream (``serve/engine.py``),
    where the number of sweeps is open-ended and a source per sweep would
    cold-start the prefetch at every shard-0 boundary. The producer wraps
    from the last shard to shard 0 (warming shard 0's files), a shard whose
    build fails reaches the consumer at its position while the stream goes
    on, and the consumer takes ``len(shards)`` items per sweep and must
    ``close()`` (or ``abort()``) the source to end it.

    Stats: ``load_time`` (host reads, misses only), ``bytes_loaded`` (host
    bytes uploaded, hits and pin loads included), ``retries`` (a
    ``RetryRecorder``) and ``integrity`` (an ``IntegrityRecorder``), the
    caller's when given (a serving engine's metrics).
    """

    def __init__(self, model_path: str, layer_names: Sequence[str],
                 shards: Sequence[tuple[int, ...]], dtype: torch.dtype,
                 device: torch.device, prefetch_depth: int = 1,
                 tied_embeddings: bool = False, *, verify_weights: bool = True,
                 host_cache: HostShardCache | None = None, readahead_threads: int = 2,
                 retry_policy: RetryPolicy | None = None, residency=None, cycle: bool = False,
                 devices: Sequence[torch.device] | None = None,
                 injector: FaultInjector | None = None, retry_recorder: RetryRecorder | None = None,
                 integrity_recorder: IntegrityRecorder | None = None,
                 replicas: Sequence[torch.device] | None = None):
        self.model_path = model_path
        self._injector = injector
        self.cycle = cycle
        self.layer_names = list(layer_names)
        self.shards = list(shards)
        if devices is not None and len(devices) != len(self.shards):
            raise ValueError("devices must align 1:1 with shards")
        self.shard_devices = list(devices) if devices is not None else [device] * len(self.shards)
        self.replicas = list(dict.fromkeys(replicas)) if replicas is not None else None
        if self.replicas is not None and (devices is not None or self.replicas[0] != device):
            raise ValueError("replicas place every shard on each device, the first being device")
        self.dtype = dtype
        self.device = device
        self.tied = tied_embeddings
        self._cuda = device.type == "cuda"
        self._stream = torch.cuda.Stream(device) if self._cuda else None
        # One upload stream per device the shards go to.
        self._streams: dict[torch.device, torch.cuda.Stream] = (
            {device: self._stream} if self._cuda else {})
        self.load_time = 0.0
        self.bytes_loaded = 0
        self.retries = RetryRecorder() if retry_recorder is None else retry_recorder
        self.integrity = IntegrityRecorder() if integrity_recorder is None else integrity_recorder
        self.quarantined: set[str] = set()
        self._retry = retry_policy or RetryPolicy()
        self._host_cache = host_cache
        self._tied_head: dict[str, Any] | None = None
        self._manifest = None
        if verify_weights:
            self._manifest = integrity_manifest.load_manifest(model_path)
            if self._manifest is None:
                warnings.warn(
                    f"{model_path}: no {integrity_manifest.MANIFEST_NAME}; weight integrity "
                    "verification skipped for this stream (re-split or re-save to write one)",
                    stacklevel=3,
                )
            else:
                _check_precision_plan(model_path, self._manifest)
        self._prefetcher = FilePrefetcher(readahead_threads) if readahead_threads > 0 else None
        manifest_stat = integrity_manifest._file_key(
            os.path.join(model_path, integrity_manifest.MANIFEST_NAME))
        # Everything besides the layer indices that shapes a host tree.
        self._cache_key_base = (
            os.path.abspath(model_path), str(dtype), bool(tied_embeddings), manifest_stat,
            self._manifest is not None, self._cuda,
        )
        self._stop = threading.Event()
        self._residency = None
        self._pinned: frozenset = frozenset()
        if residency is not None:
            # Pinned before the producer starts; a pin that fails for good
            # is demoted and streams (its error surfaces there).
            if self.replicas is not None:
                residency.ensure_pinned_broadcast(self, self.replicas,
                                                  sorted({i for s in self.shards for i in s}))
            else:
                for idxs, dev in zip(self.shards, self.shard_devices):
                    residency.ensure_pinned(self, dev, idxs)
            self.freeze_pins(residency)
        self._q: Queue = Queue(maxsize=max(1, prefetch_depth))
        self._thread: threading.Thread | None = None
        if prefetch_depth >= 1:
            self._thread = threading.Thread(target=self._producer, daemon=True)
            self._thread.start()

    def freeze_pins(self, residency) -> None:
        """Adopt ``residency``'s healthy planned layers among the shards as
        this source's pin set, for its life."""
        self._residency = residency
        self._pinned = residency.frozen_pinned(self.shards)

    def _layer_file(self, name: str) -> str:
        return checkpoint.layer_file_for(self.model_path, name, self.tied)

    def warm(self, layer_idxs: tuple[int, ...]) -> None:
        """Queue a shard's files for page-cache readahead."""
        if self._prefetcher is not None:
            self._prefetcher.prefetch(*(self._layer_file(self.layer_names[i]) for i in layer_idxs))

    def _load_one(self, name: str) -> dict[str, Any]:
        """One layer's host tree, read under the retry policy."""
        path = self._layer_file(name)
        if path in self.quarantined:
            raise ShardCorruptError(f"{path}: quarantined after persistent checksum mismatches")
        mismatches = 0

        def attempt():
            nonlocal mismatches
            try:
                if self._injector is not None:
                    self._injector.fire("shard_read", detail=name)
                    self._injector.fire("host_oom", detail=name)
                return self._load_one_raw(name)
            except ChecksumMismatch:
                mismatches += 1
                self.integrity.count("integrity_failures")
                raise
            except MemoryError as e:
                # Typed into the retryable family: once the ladder frees
                # host RAM a retry can succeed.
                _note_pressure_event("host_oom")
                raise HostOOMError(f"host OOM loading {name}: {e}") from e

        try:
            out = retry_call(attempt, policy=self._retry, label="shard_read",
                             recorder=self.retries, wrap=ShardLoadError, abort=self._stop.is_set)
        except ShardLoadError as e:
            if isinstance(e.__cause__, ChecksumMismatch) and mismatches >= 2:
                # Two reads or more came back wrong: the bytes on disk are.
                self.quarantined.add(path)
                if self._host_cache is not None:
                    self._host_cache.invalidate_path(path)
                integrity_manifest.invalidate_verdict(path)
                self.integrity.count("quarantined_shards")
                obs_trace.instant("quarantine", cat="integrity", layer=name,
                                  mismatches=mismatches)
                obs_events.emit("quarantine", layer=name, path=path, mismatches=mismatches)
                raise ShardCorruptError(
                    f"{path}: checksum mismatch survived every re-read — on-disk corruption; "
                    "path quarantined (audit with the `verify` subcommand, then re-prepare the "
                    "shard)"
                ) from e
            raise
        if mismatches:
            self.integrity.count("reread_heals")
            obs_trace.instant("reread_heal", cat="integrity", layer=name,
                              mismatches=mismatches)
            obs_events.emit("reread_heal", layer=name, mismatches=mismatches)
        return out

    def _load_one_raw(self, name: str) -> dict[str, Any]:
        corrupt = None
        if self._injector is not None:
            def corrupt(flat, _n=name):
                return self._injector.corrupt_flat("corrupt_shard", flat, detail=_n)
        if name == "lm_head" and self.tied:
            if self._tied_head is not None:
                return self._tied_head
            # Under chaos the head's cache entry is bypassed: a seeded
            # corrupt_shard draw must meet a real read.
            cache = self._host_cache if self._injector is None else None
            key = guard = None
            if cache is not None:
                key = self._cache_key_base + ("__tied_head__",)
                guard = stat_guard([self._layer_file("model.embed_tokens")])
                hit = cache.get(key) if guard is not None else None
                if hit is not None:
                    self._tied_head = hit[0]
                    return self._tied_head
            emb = checkpoint.load_layer(self.model_path, "model.embed_tokens", self._cuda,
                                        manifest=self._manifest, corrupt=corrupt)
            e = emb["embedding"]
            if checkpoint.is_quantized_leaf(e):
                # The head kernel [D, V] needs scales laid out for the
                # transpose: requantize it, to int8 even from int4 (a second
                # group-wise 4-bit rounding would compound the first).
                with _PROCESS_STREAM_LOCK:
                    _PROCESS_TIED_REQUANTS[0] += 1
                q, sc = checkpoint._quantize_int8(checkpoint.dequantize(e).T.contiguous())
                if self._cuda:
                    q, sc = q.pin_memory(), sc.pin_memory()
                self._tied_head = {"kernel": {"q8": q, "s": sc}}
            else:
                self._tied_head = {"kernel": e}  # transposed after upload
            if cache is not None and guard is not None:
                cache.put(key, self._tied_head, guard=guard)  # charged at its packed bytes
            return self._tied_head
        return checkpoint.load_layer(self.model_path, name, self._cuda, manifest=self._manifest,
                                     corrupt=corrupt)

    def _place_leaf(self, t, device):
        if checkpoint.is_quantized_leaf(t):
            packed = {k: v.to(device, non_blocking=True) for k, v in t.items()}
            return checkpoint.dequantize(packed, self.dtype)
        t = t.to(device, non_blocking=True)
        return t.to(self.dtype) if t.is_floating_point() else t

    def _place_tree(self, tree, device):
        if checkpoint.is_quantized_leaf(tree):
            return self._place_leaf(tree, device)
        if isinstance(tree, dict):
            return {k: self._place_tree(v, device) for k, v in tree.items()}
        return None if tree is None else self._place_leaf(tree, device)

    def place_layer(self, name: str, tree, device: torch.device | None = None) -> dict[str, Any]:
        """One layer's host tree on ``device`` (default: the source's), on
        the current stream: cast, quantized leaf-groups dequantized, a tied
        float head transposed."""
        placed = self._place_tree(tree, self.device if device is None else device)
        if name == "lm_head" and self.tied and not checkpoint.is_quantized_leaf(tree["kernel"]):
            placed = {"kernel": placed["kernel"].T}
        return placed

    def build_host_shard(self, layer_idxs: tuple[int, ...]) -> list[tuple[str, Any]]:
        """The shard's host trees: from the cache, or read and verified
        (then cached), inside a ``shard_load`` span. The stat guard is
        taken before the first byte. The residency tier loads its pins
        through here too."""
        with obs_trace.span("shard_load", cat="stream", first=layer_idxs[0] if layer_idxs else -1,
                            n=len(layer_idxs)):
            return self._build_host_shard(layer_idxs)

    def _build_host_shard(self, layer_idxs: tuple[int, ...]) -> list[tuple[str, Any]]:
        cache = self._host_cache
        key = guard = None
        if cache is not None:
            key = self._cache_key_base + (tuple(layer_idxs),)
            guard = stat_guard([self._layer_file(self.layer_names[i]) for i in layer_idxs])
            hit = cache.get(key)
            if hit is not None:
                host, nbytes = hit
                self.bytes_loaded += nbytes
                _count_streamed(nbytes)
                return host
        t0 = time.perf_counter()
        host = [(self.layer_names[i], self._load_one(self.layer_names[i])) for i in layer_idxs]
        self.load_time += time.perf_counter() - t0
        nbytes = tree_nbytes([tree for _, tree in host])
        self.bytes_loaded += nbytes
        _count_streamed(nbytes)
        if cache is not None and guard is not None:
            cache.put(key, host, nbytes=nbytes, guard=guard)
        return host

    def host_parts(self, layer_idxs: tuple[int, ...]):
        """One build's plan (``_split_parts``) and the host trees of its
        stream runs; each pin counts one pass's link bytes saved, once per
        build however many devices it is placed on. While the tier's
        brownout demotion holds, the source streams its frozen pins too."""
        if not layer_idxs:
            return [], []
        pinned = self._pinned
        if pinned and self._residency.pressure_demoted:
            pinned = frozenset()
        parts = _split_parts(layer_idxs, pinned)
        for kind, val in parts:
            if kind == "pin":
                self._residency.note_skip(val)
        return parts, [self.build_host_shard(val) for kind, val in parts if kind == "stream"]

    def _upload_stream(self, device: torch.device):
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def place_parts(self, parts, hosts, device: torch.device):
        """A built shard on ``device``: (segments, the upload's event or
        None). On a card the stream runs upload on the device's upload
        stream; the pins are the tier's trees on that device. An upload
        that fails waits for what it queued before the error propagates, so
        a retry never reuses memory a queued copy still writes."""
        pinned = {val: self._residency.segments(val, device, self)
                  for kind, val in parts if kind == "pin"}
        event = None
        if device.type == "cuda":
            stream = self._upload_stream(device)
            try:
                with torch.cuda.stream(stream):
                    placed_runs = [[(n, self.place_layer(n, t, device)) for n, t in host]
                                   for host in hosts]
                    event = torch.cuda.Event()
                    event.record(stream)
            except BaseException:
                stream.synchronize()
                raise
        else:
            placed_runs = [[(n, self.place_layer(n, t, device)) for n, t in host]
                           for host in hosts]
        runs = iter(placed_runs)
        placed = []
        for kind, val in parts:
            placed.extend(next(runs) if kind == "stream" else pinned[val])
        return layer_segments(placed), event

    def _build(self, layer_idxs: tuple[int, ...], device: torch.device):
        """One shard built on the host and placed on ``device``: (segments,
        event) — with ``replicas``, a list of each, one per replica. The
        upload retries under the policy (``device_put``), the
        ``link_throttle`` and ``device_put`` sites fired before anything is
        queued; the pins were counted once, by the build. Traced as one
        ``shard_produce`` span holding the upload's ``device_put``."""
        first = layer_idxs[0] if layer_idxs else -1
        with obs_trace.span("shard_produce", cat="stream", first=first, n=len(layer_idxs)):
            parts, hosts = self.host_parts(layer_idxs)
            if self.replicas is not None:
                extra = (len(self.replicas) - 1) * sum(
                    tree_nbytes([tree for _, tree in host]) for host in hosts)
                self.bytes_loaded += extra
                _count_streamed(extra)

            def put():
                if self._injector is not None:
                    # A saturated link stalls; it never errors.
                    self._injector.fire("link_throttle", detail=str(layer_idxs))
                    self._injector.fire("device_put", detail=str(layer_idxs))
                if self.replicas is None:
                    return self.place_parts(parts, hosts, device)
                placed = [self.place_parts(parts, hosts, d) for d in self.replicas]
                return [seg for seg, _ in placed], [event for _, event in placed]

            with obs_trace.span("device_put", cat="stream", first=first, n=len(layer_idxs)):
                return retry_call(put, policy=self._retry, label="device_put",
                                  recorder=self.retries, wrap=ShardLoadError,
                                  abort=self._stop.is_set)

    def _produce(self, i: int):
        """Shard ``i`` as a queue item (idxs, segments, event, device), with
        the next shard's streamed files queued for readahead (shard 0's
        after the last when cycling)."""
        if i + 1 < len(self.shards):
            self.warm(_stream_only(self.shards[i + 1], self._pinned))
        elif self.cycle:
            self.warm(_stream_only(self.shards[0], self._pinned))
        dev = self.shard_devices[i]
        return (self.shards[i], *self._build(self.shards[i], dev),
                dev if self.replicas is None else self.replicas)

    def _ready(self, item):
        """Order the upload before the consumer's stream on the item's device
        and keep the allocator from reusing the weights' memory while that
        stream runs."""
        _, segments, event, device = item
        if isinstance(device, list):  # one placement per replica
            return [self._ready((None, *placed)) for placed in zip(segments, event, device)]
        if event is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(event)
            for t in _tree_leaves([p for _, p in segments]):
                t.record_stream(stream)
        return segments

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except Full:
                continue
        return False

    def _producer(self) -> None:
        while True:
            for i in range(len(self.shards)):
                if self._stop.is_set():
                    return
                try:
                    item = self._produce(i)
                # flscheck: disable=EXC-TAXONOMY: every producer error must travel to the consumer as a _Fault envelope; narrowing would let an unexpected type kill the thread and hang the consumer's get
                except Exception as e:  # carried to the consumer, which re-raises it
                    if not self._put(_Fault(e)) or not self.cycle:
                        return
                    continue  # cycling: the consumer fails its sweep, the stream goes on
                if not self._put(item):
                    return
            if not self.cycle:
                return

    def __iter__(self):
        while True:
            for i, idxs in enumerate(self.shards):
                if self._stop.is_set():
                    raise SourceClosed("weight source closed while streaming")
                if self._thread is None:
                    item = self._produce(i)
                else:
                    while True:
                        try:
                            item = self._q.get(timeout=0.2)
                            break
                        except Empty:
                            if self._stop.is_set() or not self._thread.is_alive():
                                raise SourceClosed(
                                    "weight source closed while streaming") from None
                    if isinstance(item, _Fault):
                        raise item.error
                if item[0] != idxs:
                    # A producer out of phase would feed one layer's weights to another.
                    raise RuntimeError(f"weight source out of phase: built shard {item[0]} at "
                                       f"the position of shard {idxs}")
                # Handed out through a slot the frame empties: a suspended
                # generator must not keep the last shard's weights on the
                # device while its consumer idles.
                slot = [item]
                del item
                yield idxs, self._ready(slot.pop())
            if not self.cycle:
                return

    def abort(self) -> None:
        """Non-blocking stop for a stall watchdog's thread: a pending get
        of the consumer raises ``SourceClosed`` and a pending put of the
        producer gives up; the owner still calls :meth:`close`."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except Empty:
                break

    def close(self, join_timeout_s: float = 10.0) -> None:
        """Stop the prefetch thread, drop queued shards and retire the
        readahead pool. The join is bounded: a producer wedged in a read
        that never returns is left behind (it puts nothing once stopped)."""
        self._stop.set()
        if self._thread is not None:
            deadline = time.monotonic() + join_timeout_s
            while self._thread.is_alive() and time.monotonic() < deadline:
                try:
                    self._q.get_nowait()
                except Empty:
                    self._thread.join(timeout=0.1)
            self._thread = None
        while not self._q.empty():
            self._q.get_nowait()
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None


class BroadcastShardSource:
    """DP's weight stream (the JAX package's ``BroadcastShardSource``): one
    host build per shard — read, checked and cast once — placed on every
    active rank's device, each placement on that device's upload stream,
    and fed to one bounded queue per rank (``prefetch_depth`` items each).
    ``rounds`` repeats the shard list: the ``num_batch`` loop's passes, or
    a decode's weight passes. Two ranks on one device get a placement each.

    A rank iterates one round through its :meth:`view`. A failed build or
    placement reaches every rank as its error; :meth:`close` unblocks the
    producer and every waiting rank (which then raises ``SourceClosed``).
    ``residency`` pins its planned layers on every rank's device from one
    host build each, and every build leaves them out.
    """

    def __init__(self, model_path: str, layer_names: Sequence[str],
                 shards: Sequence[tuple[int, ...]], dtype: torch.dtype,
                 devices: Sequence[torch.device], prefetch_depth: int = 1,
                 tied_embeddings: bool = False, *, rounds: int = 1, verify_weights: bool = True,
                 host_cache: HostShardCache | None = None, readahead_threads: int = 2,
                 retry_policy: RetryPolicy | None = None, residency=None,
                 injector: FaultInjector | None = None):
        self.shards = list(shards)
        self.devices = list(devices)
        self.rounds = rounds
        # The host half of a weight source (no thread of its own): reads,
        # checks, caches, readahead, and placement on a given device. Its
        # reads fire the injector's read sites; a placement is not retried.
        self._loader = ShardWeightSource(
            model_path, layer_names, self.shards, dtype, self.devices[0], prefetch_depth=0,
            tied_embeddings=tied_embeddings, verify_weights=verify_weights,
            host_cache=host_cache, readahead_threads=readahead_threads,
            retry_policy=retry_policy, injector=injector)
        if residency is not None:
            residency.ensure_pinned_broadcast(self._loader, self.devices,
                                              sorted({i for s in self.shards for i in s}))
            self._loader.freeze_pins(residency)
        self._stop = self._loader._stop  # a stopped source also stops the loader's retries
        self._queues = [Queue(maxsize=max(1, prefetch_depth)) for _ in self.devices]
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    @property
    def load_time(self) -> float:
        return self._loader.load_time

    @property
    def bytes_loaded(self) -> int:
        return self._loader.bytes_loaded

    @property
    def retries(self) -> RetryRecorder:
        return self._loader.retries

    @property
    def integrity(self) -> IntegrityRecorder:
        return self._loader.integrity

    def _put(self, rank: int, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queues[rank].put(item, timeout=0.2)
                return True
            except Full:
                continue
        return False

    def _fail_all(self, error: BaseException) -> None:
        for rank in range(len(self.devices)):
            self._put(rank, _Fault(error))

    def _producer(self) -> None:
        loader = self._loader
        for _ in range(self.rounds):
            for i, idxs in enumerate(self.shards):
                if self._stop.is_set():
                    return
                try:
                    if i + 1 < len(self.shards):
                        loader.warm(_stream_only(self.shards[i + 1], loader._pinned))
                    parts, hosts = loader.host_parts(idxs)
                # flscheck: disable=EXC-TAXONOMY: every producer error must reach all ranks as a _Fault envelope; a narrowed miss would hang every consumer
                except Exception as e:  # every rank gets the error at this shard
                    self._fail_all(e)
                    return
                for rank, dev in enumerate(self.devices):
                    try:
                        segments, event = loader.place_parts(parts, hosts, dev)
                    # flscheck: disable=EXC-TAXONOMY: per-rank placement errors also travel as envelopes to every rank (the same hang hazard as above)
                    except Exception as e:
                        self._fail_all(e)
                        return
                    if not self._put(rank, (idxs, segments, event, dev)):
                        return

    def view(self, rank: int) -> "_BroadcastView":
        """Rank ``rank``'s handle on one round of the stream."""
        return _BroadcastView(self, rank)

    def close(self) -> None:
        """Stop the producer, then drop every queued placement and retire
        the loader's readahead pool. The queues are drained only once the
        producer has ended (it sees the stop within one 0.2 s put attempt):
        a slot drained under a blocked put would let the next shard land in
        a rank's queue where that rank still expects the one drained."""
        self._stop.set()
        self._thread.join()
        for q in self._queues:
            while not q.empty():
                q.get_nowait()
        self._loader.close()


class _BroadcastView:
    """One rank's round of a :class:`BroadcastShardSource`, iterated as a
    ``ShardWeightSource`` is. Its stats are the shared loader's: the disk is
    read once for every rank (``load_time_shared``)."""

    load_time_shared = True

    def __init__(self, parent: BroadcastShardSource, rank: int):
        self._parent = parent
        self._rank = rank

    @property
    def load_time(self) -> float:
        return self._parent.load_time

    @property
    def bytes_loaded(self) -> int:
        return self._parent.bytes_loaded

    @property
    def retries(self) -> RetryRecorder:
        return self._parent.retries

    @property
    def integrity(self) -> IntegrityRecorder:
        return self._parent.integrity

    def __iter__(self):
        parent = self._parent
        q = parent._queues[self._rank]
        for idxs in parent.shards:
            while True:
                try:
                    item = q.get(timeout=0.2)
                    break
                except Empty:
                    if parent._stop.is_set():
                        raise SourceClosed("broadcast weight source closed while streaming "
                                           "(did another DP rank fail?)") from None
            if isinstance(item, _Fault):
                raise item.error
            slot = [item]  # as in ShardWeightSource.__iter__
            del item
            yield idxs, parent._loader._ready(slot.pop())

    def close(self) -> None:
        """The shared producer outlives a view: the orchestration closes it."""


def layer_segments(placed: list[tuple[str, Any]]) -> Segments:
    """Placed ``(layer name, params)`` in layer order -> segments, with
    consecutive decoder layers in one ``decoders`` list."""
    segments: Segments = []
    for name, params in placed:
        if name.startswith("model.layers."):
            if segments and segments[-1][0] == "decoders":
                segments[-1][1].append(params)
            else:
                segments.append(("decoders", [params]))
        elif name == "model.embed_tokens":
            segments.append(("embed", params))
        elif name == "model.norm":
            segments.append(("norm", params))
        else:
            segments.append(("head", params))
    return segments


class StreamStats:
    """The JAX executor's host-path stats keys over one call: ``io_retries``
    and the integrity counters when nonzero, the process host cache's
    ``host_cache_hits``/``host_cache_misses``/``host_cache_hit_rate``, the
    crc verdict cache's ``crc_verdict_hits``/``crc_full_verifies`` when
    nonzero, and with a residency tier ``pinned_bytes`` (the tier's bytes
    on the device) with ``stream_bytes_saved``/``pin_hits`` when nonzero.
    Baselines are taken before the source starts reading or pinning. A
    ``shared`` source (a DP rank's broadcast view) serves every rank at
    once, so its process-wide deltas are not this call's: they are left
    out."""

    def __init__(self, cache: HostShardCache | None, tier=None, device=None,
                 shared: bool = False):
        if shared:
            cache = tier = None
        self.cache = cache
        self.cache_before = cache.stats() if cache is not None else None
        self.verdict_before = None if shared else integrity_manifest.verdict_stats()
        self.tier = tier
        self.device = device
        self.tier_before = tier.stats() if tier is not None else None

    def read(self, source: ShardWeightSource) -> dict[str, float]:
        out: dict[str, float] = {}
        io_retries = source.retries.total("retries")
        if io_retries:
            out["io_retries"] = float(io_retries)
        for k, v in source.integrity.snapshot().items():
            if v:
                out[k] = float(v)
        if self.cache is not None:
            after = self.cache.stats()
            hits = after["hits"] - self.cache_before["hits"]
            misses = after["misses"] - self.cache_before["misses"]
            out["host_cache_hits"] = float(hits)
            out["host_cache_misses"] = float(misses)
            if hits + misses:
                out["host_cache_hit_rate"] = round(hits / (hits + misses), 4)
        if self.verdict_before is not None:
            after = integrity_manifest.verdict_stats()
            for key in ("verdict_hits", "full_verifies"):
                delta = after[key] - self.verdict_before[key]
                if delta:
                    out[f"crc_{key}"] = float(delta)
        if self.tier is not None:
            r_after = self.tier.stats()
            out["pinned_bytes"] = float(self.tier.pinned_device_bytes(self.device))
            for key in ("stream_bytes_saved", "pin_hits"):
                delta = r_after[key] - self.tier_before[key]
                if delta:
                    out[key] = float(delta)
        return out

    def read_peak(self, stats: dict) -> None:
        """``peak_mem_gb`` of a CUDA run, floored at the residency tier's
        bytes on the device (they stay there for the whole run)."""
        peak = peak_mem_gb(self.device)
        if self.tier is not None:
            pinned_gb = self.tier.pinned_device_bytes(self.device) / 1e9
            if pinned_gb:
                peak = max(peak or 0.0, pinned_gb)
        if peak is not None:
            stats["peak_mem_gb"] = peak


def peak_over(devices, tier=None) -> float | None:
    """``peak_mem_gb`` over several devices (each named once): the largest,
    floored at the most bytes the residency tier pins on one of them."""
    peaks = [p for p in map(peak_mem_gb, dict.fromkeys(devices)) if p is not None]
    if tier is not None and tier.max_pinned_device_bytes():
        peaks.append(tier.max_pinned_device_bytes() / 1e9)
    return max(peaks) if peaks else None


def block_meta(toks: list[TokenizedPrompt], idxs: list[int], device: torch.device):
    """(prefix_ids [B, Lp], suffix_ids [B, S, Ls], prefix_len [B],
    suffix_eos [B, S]) int32 tensors of one block on ``device``."""
    return (
        torch.from_numpy(np.stack([toks[i].prefix_ids for i in idxs])).to(device),
        torch.from_numpy(np.stack([toks[i].suffix_ids for i in idxs])).to(device),
        torch.tensor([toks[i].prefix_len for i in idxs], dtype=torch.int32).to(device),
        torch.from_numpy(np.stack([toks[i].suffix_eos for i in idxs])).to(device),
    )


def first_decoder(layer_idxs: Sequence[int]) -> int:
    """Decoder index of a shard's first decoder layer (execution-list index
    minus the embedding's slot)."""
    return max(layer_idxs[0] - 1, 0)


def apply_segments(model_cfg: LlamaConfig, dtype: torch.dtype, segments: Segments,
                   prefix_h, suffix_h, meta, first_layer: int = 0, *, use_pallas: bool):
    """Run one shard's segments over a block; the shard's first decoder
    layer is decoder ``first_layer`` of the model. Returns (prefix_h,
    suffix_h, block_scores) with block_scores the float32 [B, S, V]
    distributions when the shard holds the lm_head, else None.
    ``use_pallas`` (``FrameworkConfig.use_pallas``) picks the
    attention kernels or the plain ops."""
    prefix_ids, suffix_ids, prefix_len, suffix_eos = meta
    sliding = llama.layer_sliding_pattern(model_cfg)
    rope_on = llama.layer_rope_pattern(model_cfg)
    total_len = longrope_total_len(model_cfg, prefix_len, suffix_eos)
    block_scores = None
    for kind, params in segments:
        if kind == "embed":
            prefix_h = llama.embed(params, prefix_ids, dtype, model_cfg)
            suffix_h = llama.embed(params, suffix_ids, dtype, model_cfg)
        elif kind == "decoders":
            for i, layer in enumerate(params):
                prefix_h, suffix_h = llama.prefix_suffix_layer(
                    layer, model_cfg, prefix_h, suffix_h, prefix_len,
                    sliding=sliding[first_layer + i], total_len=total_len,
                    rope_on=rope_on[first_layer + i], use_pallas=use_pallas,
                )
        elif kind == "norm":
            suffix_h = llama.select_eos_and_norm(params, model_cfg, suffix_h, suffix_eos)
            prefix_h = None
        else:
            block_scores = llama.lm_head_scores(params, suffix_h, model_cfg.final_logit_softcap)
    return prefix_h, suffix_h, block_scores


class _ScoreCopy:
    """One head block's float32 scores [B, S, V] on their way to the host.
    On a card: a page-locked copy issued ``non_blocking`` on ``stream``
    after an event on the compute stream, the device tensor kept until the
    copy resolves; on the CPU the scores themselves."""

    def __init__(self, block_scores: torch.Tensor, stream):
        self.event = None
        self.device_ref = None
        if block_scores.device.type != "cuda":
            self.host = block_scores
            return
        self.host = torch.empty(block_scores.shape, dtype=block_scores.dtype, pin_memory=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(block_scores.device))
        stream.wait_event(ready)
        with torch.cuda.stream(stream):
            self._copy(block_scores)
            self.event = torch.cuda.Event()
            self.event.record(stream)
        self.device_ref = block_scores

    def _copy(self, block_scores: torch.Tensor) -> None:
        self.host.copy_(block_scores, non_blocking=True)

    def resolve(self) -> torch.Tensor:
        """Wait for the copy, release the device tensor, return the host one."""
        if self.event is not None:
            self.event.synchronize()
            self.event = None
            self.device_ref = None
        return self.host


class ScoreSink(dict):
    """Per-prompt scores of one run: prompt index -> float32 [n_suffixes, 1,
    V] host array (the JAX package's ``ScoreSink``). A head block's scores
    arrive on the device with their host copy started (:class:`_ScoreCopy`,
    on one side stream per sink); only the newest ``max_device`` prompts
    stay pending, and older ones resolve (their copy has had whole blocks
    of compute to finish), so the host loop waits on no copy per block.
    :func:`finalize_scores` resolves the rest."""

    def __init__(self, max_device: int = 16):
        super().__init__()
        if max_device < 1:
            raise ValueError(f"score_sink_max_device must be >= 1, got {max_device}")
        self.max_device = max_device
        self._pending: list[int] = []
        self._rows: dict[int, tuple[_ScoreCopy, int, int]] = {}
        self._stream = None

    def add_block(self, block_scores: torch.Tensor, idxs: list[int], n_suffixes: list[int]) -> None:
        """Keep a block's scores [B, S, V]: row ``r`` is prompt ``idxs[r]``,
        cut to its ``n_suffixes[r]`` real suffixes when it resolves."""
        if block_scores.device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(block_scores.device)
        copy = _ScoreCopy(block_scores, self._stream)
        for row, (i, n) in enumerate(zip(idxs, n_suffixes)):
            self._rows[i] = (copy, row, n)
            self._pending.append(i)
        while len(self._pending) > self.max_device:
            self._resolve(self._pending.pop(0))

    def _resolve(self, i: int) -> None:
        copy, row, n = self._rows.pop(i)
        self[i] = copy.resolve().numpy()[row, :n, None, :]

    def finalize(self) -> None:
        while self._pending:
            self._resolve(self._pending.pop(0))


def finalize_scores(scores: ScoreSink) -> None:
    """Resolve every pending prompt's scores: the run's one host wait on
    score copies besides the cap's."""
    scores.finalize()


def process_block(model_cfg: LlamaConfig, dtype: torch.dtype, segments: Segments,
                  layer_idxs: tuple[int, ...], n_layers: int, store: ActivationStore,
                  b: int, idxs: list[int], meta, toks: list[TokenizedPrompt],
                  scores: ScoreSink, fetched=None, device=None, *,
                  use_pallas: bool) -> None:
    """One shard over one block: fetch its activations (unless the shard
    starts at the embedding, or ``fetched`` holds them: a recompute's) onto
    ``device`` (default: the store's; an MP stage's own), apply the
    segments, hand any head scores to the sink (rows cut to the true suffix
    count), and park the activations for the next shard. Prefix states end
    at the last decoder layer (index n_layers-3)."""
    first, last = layer_idxs[0], layer_idxs[-1]
    if fetched is not None:
        prefix_h, suffix_h = fetched
    elif first == 0:
        prefix_h = suffix_h = None
    else:
        prefix_h, suffix_h = store.fetch(b, idxs, with_prefix=first <= n_layers - 3,
                                         device=device)
    prefix_h, suffix_h, block_scores = apply_segments(
        model_cfg, dtype, segments, prefix_h, suffix_h, meta, first_decoder(layer_idxs),
        use_pallas=use_pallas,
    )
    if block_scores is not None:
        scores.add_block(block_scores, idxs, [toks[i].num_suffixes for i in idxs])
    if last != n_layers - 1:
        store.store(b, idxs, prefix_h, suffix_h)


class StreamingExecutor:
    """Layer-streaming scorer on one device: one device alone, or one DP
    rank.

    ``__call__(prompts, batch)`` takes ``[(prefix_str, (suffix_str, ...)),
    ...]`` and the ``num_batch`` loop's batch index (which scopes the disk
    files and the resume marker) and returns one float32 ``[n_suffixes, 1,
    vocab]`` next-token distribution per prompt.

    ``plan``: the shard plan (default: contiguous shards of
    ``layer_num_per_shard``); it must cover every layer in order with no
    empty shard (MP's stage plans run in ``runtime/pipeline.py``). A DP
    rank's plan carries its rank, which tags its disk files and marker.
    ``weight_source_factory``: each call takes its stream from it instead
    of opening a ``ShardWeightSource`` (a DP rank's broadcast view); a
    resumed rank then drops the shards it finished.
    """

    # The registry source of the latest call's stats (a subclass names its own).
    REGISTRY_NAME = "executor"

    def __init__(self, cfg: FrameworkConfig, device: torch.device | None = None,
                 tokenizer=None, *, plan: ShardPlan | None = None,
                 weight_source_factory=None):
        self.cfg = cfg
        self.weight_source_factory = weight_source_factory
        self.device = device if device is not None else resolve_device(cfg.device)
        self.model_cfg = LlamaConfig.from_pretrained(cfg.model_path)
        self.dtype = cfg.torch_dtype
        self._use_pallas = cfg.use_pallas
        if tokenizer is None:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(cfg.model_path)
        self.tokenizer = PromptTokenizer(
            tokenizer, max_token_len=cfg.max_token_len, bucket_multiple=cfg.bucket_multiple
        )
        self.layer_names = checkpoint.layer_names_for(self.model_cfg.num_hidden_layers)
        self.plan = plan or plan_shards_dp(len(self.layer_names), cfg.layer_num_per_shard)
        covered = [i for s in self.plan.shards for i in s]
        if covered != list(range(len(self.layer_names))) or not all(self.plan.shards):
            raise ValueError("StreamingExecutor needs a plan covering every layer in order with "
                             "no empty shard (DP or one device); the MP pipeline runs stage plans")
        # The model directory's content, in the resume signature and marker.
        self._manifest_digest = integrity_manifest.manifest_digest(
            integrity_manifest.load_manifest(cfg.model_path) if cfg.verify_weights else None)
        # The process residency tier, or None when hbm_pin_gb resolves to 0.
        self._residency = self._pin_tier()
        # One chaos injector for this executor's sources and spill stores
        # (None unless cfg.faults.enabled), as the JAX executor holds one.
        self._injector = FaultInjector.from_config(cfg.faults)
        self.stats: dict[str, float] = {}
        self.stats_history: list[dict[str, float]] = []
        # Tracing and the flight recorder, enabled process-wide when the
        # config asks (one bool read per emit otherwise); the latest call's
        # stats are a registry source (last one wins, held through a weakref).
        obs_trace.ensure_configured(cfg)
        from flexible_llm_sharding_tpu_torch.obs import incident as obs_incident
        from flexible_llm_sharding_tpu_torch.obs.registry import weak_source

        obs_incident.ensure_configured(cfg)
        REGISTRY.register(self.REGISTRY_NAME, weak_source(self))
        self.recorder = metrics.Recorder(verbose=True) if cfg.verbose_metrics else None

    def _pin_tier(self):
        return residency.tier_for(self.cfg, self.layer_names, self.model_cfg.tie_word_embeddings,
                                  self.device)

    def weight_source(self, n_passes: int = 1, start: int = 0, shards=None,
                      devices=None, injector=None) -> tuple[ShardWeightSource, StreamStats]:
        """One source over ``n_passes`` passes of the shard list from shard
        ``start`` (a resumed run's) — or of ``shards`` on their ``devices``
        (an MP decode's stages) — on the process host cache and residency
        tier, and the baselines of its stats. ``injector``: the source's
        (default: the executor's)."""
        cfg = self.cfg
        cache = cache_for(cfg)
        tier = self._residency
        stats = StreamStats(cache, tier, self.device)
        shards = list(self.plan.shards[start:]) if shards is None else list(shards)
        source = ShardWeightSource(
            cfg.model_path, self.layer_names, shards * n_passes,
            self.dtype, self.device, cfg.prefetch_depth, self.model_cfg.tie_word_embeddings,
            verify_weights=cfg.verify_weights, host_cache=cache,
            readahead_threads=cfg.readahead_threads, retry_policy=cfg.retry_policy(),
            residency=tier, devices=None if devices is None else list(devices) * n_passes,
            injector=self._injector if injector is None else injector,
        )
        return source, stats

    def _rank_tag(self) -> bool:
        """The reference tags disk files with the rank in DP mode only."""
        return self.plan.num_devices > 1 and self.cfg.data_parallel

    def activation_store(self, source, batch: int) -> ActivationStore:
        cfg = self.cfg
        return ActivationStore(
            cfg.storage_location, self.device, self.dtype, cfg.disk_folder,
            max_in_cpu=cfg.max_activation_in_cpu, batch=batch, integrity=source.integrity,
            retry_policy=cfg.retry_policy(), retry_recorder=source.retries,
            device_rank=self.plan.device_rank, rank_tag=self._rank_tag(), injector=self._injector,
        )

    # -- disk-mode crash resume (runtime/resume.py) ---------------------------

    def _resume_signature(self, toks) -> str:
        return resume.workload_signature(toks, self.plan.shards, self.cfg.model_path,
                                         self.cfg.dtype, self.cfg.block_size,
                                         manifest_digest=self._manifest_digest)

    def _progress_path(self, sig: str, batch: int) -> str:
        rank = self.plan.device_rank if self._rank_tag() else None
        return resume.marker_path(self.cfg.disk_folder, sig, batch_tag(batch, rank))

    def _resume_start(self, marker: str, sig: str) -> int:
        """The first shard a run executes: 0, or with ``resume`` in disk mode
        the marker's completed shards. A crashed shard k cannot have
        destroyed its own inputs (it writes generation k % 2 and reads
        (k - 1) % 2), so the resumed run rewrites its outputs from them. The
        last shard is never marked complete: it produces the scores."""
        if not (self.cfg.resume and self.cfg.storage_location == "disk"):
            return 0
        data = resume.read_marker(marker, sig, manifest_hash=self._manifest_digest)
        return min(int(data.get("completed_shards", 0)), len(self.plan.shards) - 1)

    def _mark_progress(self, marker: str, sig: str, done: int) -> None:
        resume.write_marker(marker, sig, completed_shards=done,
                            manifest_hash=self._manifest_digest)

    def _recompute_block(self, prev_shard, store: ActivationStore, b: int, idxs: list[int], meta,
                         n_layers: int):
        """One block's activations re-derived by running the previous shard
        again, from its inputs in the other disk generation (the ping-pong
        that protects a resume). Returns (prefix_h, suffix_h) on the device,
        the current shard's input."""
        prev_idxs, prev_segments = prev_shard
        first = prev_idxs[0]
        if first == 0:
            prefix_h = suffix_h = None  # re-embedded from the token ids
        else:
            prefix_h, suffix_h = store.fetch_recompute(b, idxs, with_prefix=first <= n_layers - 3)
        prefix_h, suffix_h, _ = apply_segments(self.model_cfg, self.dtype, prev_segments,
                                               prefix_h, suffix_h, meta, first_decoder(prev_idxs),
                                               use_pallas=self._use_pallas)
        return prefix_h, suffix_h

    def _run_block(self, segments, layer_idxs, store, b, idxs, meta, toks, scores,
                   prev_shard, integrity, sweep_id: int = 0) -> None:
        """:func:`process_block`, with the recompute of a corrupt input spill:
        at most once per block and shard (a second failure means the
        previous generation is corrupt too, and raises)."""
        n_layers = len(self.layer_names)
        fetched = None
        while True:
            try:
                process_block(self.model_cfg, self.dtype, segments, layer_idxs, n_layers, store,
                              b, idxs, meta, toks, scores, fetched=fetched,
                              use_pallas=self._use_pallas)
                return
            except SpillCorruptError:
                if prev_shard is None or fetched is not None:
                    raise
                integrity.count("recomputes")
                obs_trace.instant("spill_recompute", cat="integrity", block=b, sweep_id=sweep_id)
                obs_events.emit("spill_recompute", block=b, sweep_id=sweep_id)
                fetched = self._recompute_block(prev_shard, store, b, idxs, meta, n_layers)

    @torch.inference_mode()
    def __call__(self, prompts, batch: int = 0) -> list[np.ndarray]:
        t_start = time.perf_counter()
        toks = [self.tokenizer(p, s) for p, s in prompts]
        check_longrope_regime(self.model_cfg, toks)
        blocks = make_blocks(toks, self.cfg.block_size)
        metas = [block_meta(toks, idxs, self.device) for idxs in blocks]
        scores = ScoreSink(self.cfg.score_sink_max_device)
        n_shards = len(self.plan.shards)
        resumable = self.cfg.storage_location == "disk"
        sig = self._resume_signature(toks) if resumable else ""
        marker = self._progress_path(sig, batch) if resumable else ""
        start = self._resume_start(marker, sig) if resumable else 0
        compute_time = source_wait = 0.0
        if self.weight_source_factory is None:
            source, host_stats = self.weight_source(start=start)
            skip = bytes_before = 0
        else:
            # A shared stream yields every shard: a resumed rank drops the
            # ones it finished.
            host_stats = StreamStats(None, device=self.device, shared=True)
            source = self.weight_source_factory()
            skip, bytes_before = start, source.bytes_loaded
        store = self.activation_store(source, batch)
        # Disk mode keeps the previous shard's weights one more shard, for
        # the recompute of a corrupt spill.
        prev_shard = None
        bar = metrics.progress_bar((n_shards - start) * max(len(blocks), 1), desc="stream",
                                   unit="blk")
        # The pass's correlation id: every span below carries it.
        sweep_id = obs_trace.new_sweep_id() if obs_trace.enabled() else 0
        try:
            with obs_trace.span("sweep", cat="sweep", sweep_id=sweep_id, mode="offline",
                                blocks=len(blocks)):
                it = iter(source)
                for _ in range(skip):
                    next(it)
                for shard_pos in range(start, n_shards):
                    t_wait = time.perf_counter()
                    layer_idxs, segments = next(it)
                    waited = time.perf_counter() - t_wait
                    source_wait += waited
                    # Recorded with the measured wait, after the resume skip:
                    # the trace's source_wait total is the stats line's.
                    obs_trace.TRACER.complete("source_wait", "sweep", t_wait, waited,
                                              sweep_id=sweep_id)
                    store.set_shard(shard_pos)
                    t0 = time.perf_counter()
                    with obs_trace.span("compute", cat="sweep", sweep_id=sweep_id,
                                        shard_idx=shard_pos):
                        for b, idxs in enumerate(blocks):
                            self._run_block(segments, layer_idxs, store, b, idxs, metas[b], toks,
                                            scores, prev_shard, source.integrity, sweep_id)
                            bar.update(1)
                        if not blocks:
                            bar.update(1)
                        sync(self.device)
                    compute_time += time.perf_counter() - t0
                    if resumable:
                        if shard_pos + 1 < n_shards:
                            # The marker never claims a shard whose writes are queued.
                            store.flush()
                            self._mark_progress(marker, sig, shard_pos + 1)
                        prev_shard = (layer_idxs, segments)
                    del segments
        finally:
            bar.close()
            source.close()
            store.clear()
        finalize_scores(scores)
        if resumable:
            resume.remove_marker(marker)
        self.stats = {
            "load_weights_time_s": source.load_time,
            "compute_wall_s": compute_time,
            "source_wait_s": source_wait,
            "total_wall_s": time.perf_counter() - t_start,
            "tokens_processed": float(sum(t.tokens_processed for t in toks)),
            # A shared stream's bytes over this call's window, every rank's.
            "streamed_bytes": float(source.bytes_loaded - bytes_before),
            **host_stats.read(source),
        }
        if self.weight_source_factory is not None:
            self.stats["load_time_shared"] = self.stats["streamed_bytes_shared"] = 1.0
        host_stats.read_peak(self.stats)
        self.stats_history.append(dict(self.stats))
        if self.recorder is not None:
            self.recorder.record("executor_call", self.stats["total_wall_s"], prompts=len(prompts),
                                 **{k: v for k, v in self.stats.items() if k != "total_wall_s"})
        return [scores[i] for i in range(len(prompts))]


__all__ = [
    "BroadcastShardSource",
    "ScoreSink",
    "ShardWeightSource",
    "layer_segments",
    "process_tied_head_requants",
    "reset_process_streamed_bytes",
    "reset_process_tied_head_requants",
    "SourceClosed",
    "StreamStats",
    "StreamingExecutor",
    "apply_segments",
    "block_meta",
    "finalize_scores",
    "first_decoder",
    "peak_mem_gb",
    "peak_over",
    "process_block",
    "stream_stats",
    "sync",
]
