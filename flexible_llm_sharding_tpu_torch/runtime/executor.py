"""The streaming executor: the model passes through the device one shard of
layers at a time (the JAX package's ``runtime/executor.py``, single-device
part).

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
still holds. Fault injection waits for ROADMAP item 8.
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
from flexible_llm_sharding_tpu_torch.faults.retry import RetryPolicy, ShardLoadError, retry_call
from flexible_llm_sharding_tpu_torch.integrity import manifest as integrity_manifest
from flexible_llm_sharding_tpu_torch.integrity.manifest import (
    ChecksumMismatch,
    ShardCorruptError,
    SpillCorruptError,
)
from flexible_llm_sharding_tpu_torch.models import llama
from flexible_llm_sharding_tpu_torch.parallel.planner import plan_shards_dp
from flexible_llm_sharding_tpu_torch.runtime import residency, resume
from flexible_llm_sharding_tpu_torch.runtime.activations import ActivationStore, batch_tag
from flexible_llm_sharding_tpu_torch.runtime.hostcache import (
    HostShardCache,
    cache_for,
    stat_guard,
    tree_nbytes,
)
from flexible_llm_sharding_tpu_torch.runtime.tokenization import (
    PromptTokenizer,
    TokenizedPrompt,
    check_longrope_regime,
    longrope_total_len,
    make_blocks,
)
from flexible_llm_sharding_tpu_torch.utils import checkpoint
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


# Process-wide counters: host bytes built for upload, and tied lm_head
# requantizations (a dequant, transpose and int8 requant of [V, D], cached
# per source and in the host cache, so a warm process performs none).
_PROCESS_STREAM_LOCK = threading.Lock()
_PROCESS_TIED_REQUANTS = [0]


def process_tied_head_requants() -> int:
    return _PROCESS_TIED_REQUANTS[0]


def reset_process_tied_head_requants() -> None:
    with _PROCESS_STREAM_LOCK:
        _PROCESS_TIED_REQUANTS[0] = 0


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
    JAX package's ``_HostShardLoader`` and weight source, single device).

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

    ``residency`` (a ``DeviceResidencyTier``): its planned layers among the
    shards are pinned before the first build, frozen for this source's
    life, subtracted from every build and merged back in layer order. The
    JAX loader's fault injection and host-OOM typing wait for ROADMAP item 8.

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
    ``RetryRecorder``) and ``integrity`` (an ``IntegrityRecorder``).
    """

    def __init__(self, model_path: str, layer_names: Sequence[str],
                 shards: Sequence[tuple[int, ...]], dtype: torch.dtype,
                 device: torch.device, prefetch_depth: int = 1,
                 tied_embeddings: bool = False, *, verify_weights: bool = True,
                 host_cache: HostShardCache | None = None, readahead_threads: int = 2,
                 retry_policy: RetryPolicy | None = None, residency=None, cycle: bool = False):
        self.model_path = model_path
        self.cycle = cycle
        self.layer_names = list(layer_names)
        self.shards = list(shards)
        self.dtype = dtype
        self.device = device
        self.tied = tied_embeddings
        self._cuda = device.type == "cuda"
        self._stream = torch.cuda.Stream(device) if self._cuda else None
        self.load_time = 0.0
        self.bytes_loaded = 0
        self.retries = RetryRecorder()
        self.integrity = IntegrityRecorder()
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
        self._residency = residency
        self._pinned: frozenset = frozenset()
        if residency is not None:
            # Pinned before the producer starts; a pin that fails for good
            # is demoted and streams (its error surfaces there).
            residency.ensure_pinned(self, device, [i for idxs in self.shards for i in idxs])
            self._pinned = residency.frozen_pinned(self.shards)
        self._q: Queue = Queue(maxsize=max(1, prefetch_depth))
        self._thread: threading.Thread | None = None
        if prefetch_depth >= 1:
            self._thread = threading.Thread(target=self._producer, daemon=True)
            self._thread.start()

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
                return self._load_one_raw(name)
            except ChecksumMismatch:
                mismatches += 1
                self.integrity.count("integrity_failures")
                raise

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
                raise ShardCorruptError(
                    f"{path}: checksum mismatch survived every re-read — on-disk corruption; "
                    "path quarantined (audit with the `verify` subcommand, then re-prepare the "
                    "shard)"
                ) from e
            raise
        if mismatches:
            self.integrity.count("reread_heals")
        return out

    def _load_one_raw(self, name: str) -> dict[str, Any]:
        if name == "lm_head" and self.tied:
            if self._tied_head is not None:
                return self._tied_head
            cache = self._host_cache
            key = guard = None
            if cache is not None:
                key = self._cache_key_base + ("__tied_head__",)
                guard = stat_guard([self._layer_file("model.embed_tokens")])
                hit = cache.get(key) if guard is not None else None
                if hit is not None:
                    self._tied_head = hit[0]
                    return self._tied_head
            emb = checkpoint.load_layer(self.model_path, "model.embed_tokens", self._cuda,
                                        manifest=self._manifest)
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
        return checkpoint.load_layer(self.model_path, name, self._cuda, manifest=self._manifest)

    def _place_leaf(self, t):
        if checkpoint.is_quantized_leaf(t):
            packed = {k: v.to(self.device, non_blocking=True) for k, v in t.items()}
            return checkpoint.dequantize(packed, self.dtype)
        t = t.to(self.device, non_blocking=True)
        return t.to(self.dtype) if t.is_floating_point() else t

    def _place_tree(self, tree):
        if checkpoint.is_quantized_leaf(tree):
            return self._place_leaf(tree)
        if isinstance(tree, dict):
            return {k: self._place_tree(v) for k, v in tree.items()}
        return None if tree is None else self._place_leaf(tree)

    def place_layer(self, name: str, tree) -> dict[str, Any]:
        """One layer's host tree on the device, on the current stream: cast,
        quantized leaf-groups dequantized, a tied float head transposed."""
        placed = self._place_tree(tree)
        if name == "lm_head" and self.tied and not checkpoint.is_quantized_leaf(tree["kernel"]):
            placed = {"kernel": placed["kernel"].T}
        return placed

    def build_host_shard(self, layer_idxs: tuple[int, ...]) -> list[tuple[str, Any]]:
        """The shard's host trees: from the cache, or read and verified
        (then cached). The stat guard is taken before the first byte. The
        residency tier loads its pins through here too."""
        cache = self._host_cache
        key = guard = None
        if cache is not None:
            key = self._cache_key_base + (tuple(layer_idxs),)
            guard = stat_guard([self._layer_file(self.layer_names[i]) for i in layer_idxs])
            hit = cache.get(key)
            if hit is not None:
                host, nbytes = hit
                self.bytes_loaded += nbytes
                return host
        t0 = time.perf_counter()
        host = [(self.layer_names[i], self._load_one(self.layer_names[i])) for i in layer_idxs]
        self.load_time += time.perf_counter() - t0
        nbytes = tree_nbytes([tree for _, tree in host])
        self.bytes_loaded += nbytes
        if cache is not None and guard is not None:
            cache.put(key, host, nbytes=nbytes, guard=guard)
        return host

    def _build(self, layer_idxs: tuple[int, ...]):
        parts = _split_parts(layer_idxs, self._pinned)
        pinned = {}
        for kind, val in parts:
            if kind == "pin":
                # One pass's link bytes saved, counted once per build.
                self._residency.note_skip(val)
                pinned[val] = self._residency.segments(val, self.device, self)
        hosts = [self.build_host_shard(val) for kind, val in parts if kind == "stream"]
        event = None
        if self._cuda:
            with torch.cuda.stream(self._stream):
                placed_runs = [[(n, self.place_layer(n, t)) for n, t in host] for host in hosts]
                event = torch.cuda.Event()
                event.record(self._stream)
        else:
            placed_runs = [[(n, self.place_layer(n, t)) for n, t in host] for host in hosts]
        runs = iter(placed_runs)
        placed = []
        for kind, val in parts:
            placed.extend(next(runs) if kind == "stream" else pinned[val])
        return layer_segments(placed), event

    def _produce(self, i: int):
        """Shard ``i``, with the next shard's streamed files queued for
        readahead (shard 0's after the last when cycling)."""
        if i + 1 < len(self.shards):
            self.warm(_stream_only(self.shards[i + 1], self._pinned))
        elif self.cycle:
            self.warm(_stream_only(self.shards[0], self._pinned))
        return (self.shards[i], *self._build(self.shards[i]))

    def _ready(self, item):
        """Order the upload before the consumer's stream and keep the
        allocator from reusing the weights' memory while that stream runs."""
        _, segments, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
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
                yield idxs, self._ready(item)
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
    Baselines are taken before the source starts reading or pinning."""

    def __init__(self, cache: HostShardCache | None, tier=None, device=None):
        self.cache = cache
        self.cache_before = cache.stats() if cache is not None else None
        self.verdict_before = integrity_manifest.verdict_stats()
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
                   prefix_h, suffix_h, meta, first_layer: int = 0):
    """Run one shard's segments over a block; the shard's first decoder
    layer is decoder ``first_layer`` of the model. Returns (prefix_h,
    suffix_h, block_scores) with block_scores the float32 [B, S, V]
    distributions when the shard holds the lm_head, else None."""
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
                    rope_on=rope_on[first_layer + i],
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
                  scores: ScoreSink, fetched=None) -> None:
    """One shard over one block: fetch its activations (unless the shard
    starts at the embedding, or ``fetched`` holds them: a recompute's), apply
    the segments, hand any head scores to the sink (rows cut to the true
    suffix count), and park the activations for the next shard. Prefix
    states end at the last decoder layer (index n_layers-3)."""
    first, last = layer_idxs[0], layer_idxs[-1]
    if fetched is not None:
        prefix_h, suffix_h = fetched
    elif first == 0:
        prefix_h = suffix_h = None
    else:
        prefix_h, suffix_h = store.fetch(b, idxs, with_prefix=first <= n_layers - 3)
    prefix_h, suffix_h, block_scores = apply_segments(
        model_cfg, dtype, segments, prefix_h, suffix_h, meta, first_decoder(layer_idxs)
    )
    if block_scores is not None:
        scores.add_block(block_scores, idxs, [toks[i].num_suffixes for i in idxs])
    if last != n_layers - 1:
        store.store(b, idxs, prefix_h, suffix_h)


class StreamingExecutor:
    """Single-device layer-streaming scorer.

    ``__call__(prompts, batch)`` takes ``[(prefix_str, (suffix_str, ...)),
    ...]`` and the ``num_batch`` loop's batch index (which scopes the disk
    files and the resume marker) and returns one float32 ``[n_suffixes, 1,
    vocab]`` next-token distribution per prompt.
    """

    def __init__(self, cfg: FrameworkConfig, device: torch.device | None = None,
                 tokenizer=None):
        self.cfg = cfg
        self.device = device if device is not None else resolve_device(cfg.device)
        self.model_cfg = LlamaConfig.from_pretrained(cfg.model_path)
        self.dtype = cfg.torch_dtype
        if tokenizer is None:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(cfg.model_path)
        self.tokenizer = PromptTokenizer(
            tokenizer, max_token_len=cfg.max_token_len, bucket_multiple=cfg.bucket_multiple
        )
        self.layer_names = checkpoint.layer_names_for(self.model_cfg.num_hidden_layers)
        self.plan = plan_shards_dp(len(self.layer_names), cfg.layer_num_per_shard)
        # The model directory's content, in the resume signature and marker.
        self._manifest_digest = integrity_manifest.manifest_digest(
            integrity_manifest.load_manifest(cfg.model_path) if cfg.verify_weights else None)
        # The process residency tier, or None when hbm_pin_gb resolves to 0.
        self._residency = self._pin_tier()
        self.stats: dict[str, float] = {}
        self.stats_history: list[dict[str, float]] = []

    def _pin_tier(self):
        return residency.tier_for(self.cfg, self.layer_names, self.model_cfg.tie_word_embeddings,
                                  self.device)

    def weight_source(self, n_passes: int = 1,
                      start: int = 0) -> tuple[ShardWeightSource, StreamStats]:
        """One source over ``n_passes`` passes of the shard list from shard
        ``start`` (a resumed run's), on the process host cache and residency
        tier, and the baselines of its stats."""
        cfg = self.cfg
        cache = cache_for(cfg)
        tier = self._residency
        stats = StreamStats(cache, tier, self.device)
        source = ShardWeightSource(
            cfg.model_path, self.layer_names, list(self.plan.shards[start:]) * n_passes,
            self.dtype, self.device, cfg.prefetch_depth, self.model_cfg.tie_word_embeddings,
            verify_weights=cfg.verify_weights, host_cache=cache,
            readahead_threads=cfg.readahead_threads, retry_policy=cfg.retry_policy(),
            residency=tier,
        )
        return source, stats

    def activation_store(self, source: ShardWeightSource, batch: int) -> ActivationStore:
        cfg = self.cfg
        return ActivationStore(
            cfg.storage_location, self.device, self.dtype, cfg.disk_folder,
            max_in_cpu=cfg.max_activation_in_cpu, batch=batch, integrity=source.integrity,
            retry_policy=cfg.retry_policy(), retry_recorder=source.retries,
        )

    # -- disk-mode crash resume (runtime/resume.py) ---------------------------

    def _resume_signature(self, toks) -> str:
        return resume.workload_signature(toks, self.plan.shards, self.cfg.model_path,
                                         self.cfg.dtype, self.cfg.block_size,
                                         manifest_digest=self._manifest_digest)

    def _progress_path(self, sig: str, batch: int) -> str:
        return resume.marker_path(self.cfg.disk_folder, sig, batch_tag(batch))

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
                                               prefix_h, suffix_h, meta, first_decoder(prev_idxs))
        return prefix_h, suffix_h

    def _run_block(self, segments, layer_idxs, store, b, idxs, meta, toks, scores,
                   prev_shard, integrity) -> None:
        """:func:`process_block`, with the recompute of a corrupt input spill:
        at most once per block and shard (a second failure means the
        previous generation is corrupt too, and raises)."""
        n_layers = len(self.layer_names)
        fetched = None
        while True:
            try:
                process_block(self.model_cfg, self.dtype, segments, layer_idxs, n_layers, store,
                              b, idxs, meta, toks, scores, fetched=fetched)
                return
            except SpillCorruptError:
                if prev_shard is None or fetched is not None:
                    raise
                integrity.count("recomputes")
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
        source, host_stats = self.weight_source(start=start)
        store = self.activation_store(source, batch)
        # Disk mode keeps the previous shard's weights one more shard, for
        # the recompute of a corrupt spill.
        prev_shard = None
        try:
            it = iter(source)
            for shard_pos in range(start, n_shards):
                t_wait = time.perf_counter()
                layer_idxs, segments = next(it)
                source_wait += time.perf_counter() - t_wait
                store.set_shard(shard_pos)
                t0 = time.perf_counter()
                for b, idxs in enumerate(blocks):
                    self._run_block(segments, layer_idxs, store, b, idxs, metas[b], toks, scores,
                                    prev_shard, source.integrity)
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
            "streamed_bytes": float(source.bytes_loaded),
            **host_stats.read(source),
        }
        host_stats.read_peak(self.stats)
        self.stats_history.append(dict(self.stats))
        return [scores[i] for i in range(len(prompts))]


__all__ = [
    "ScoreSink",
    "ShardWeightSource",
    "layer_segments",
    "process_tied_head_requants",
    "reset_process_tied_head_requants",
    "SourceClosed",
    "StreamStats",
    "StreamingExecutor",
    "apply_segments",
    "block_meta",
    "finalize_scores",
    "first_decoder",
    "peak_mem_gb",
    "process_block",
    "sync",
]
