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
before, with the next shard's files read ahead into the page cache. The
residency tier, quantized streaming and resume (ROADMAP 3.4-3.6), and
fault injection (item 8) are not part of this port yet.
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
from flexible_llm_sharding_tpu_torch.integrity.manifest import ChecksumMismatch, ShardCorruptError
from flexible_llm_sharding_tpu_torch.models import llama
from flexible_llm_sharding_tpu_torch.parallel.planner import plan_shards_dp
from flexible_llm_sharding_tpu_torch.runtime.activations import ActivationStore
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


class ShardWeightSource:
    """Shard weights, disk -> host -> device, optionally prefetched (the
    JAX package's ``_HostShardLoader`` and weight source, single device).

    Iterating yields ``(layer_idxs, segments)`` per shard, where segments is
    a list of ``(kind, params)``: ``("embed", {"embedding"})``,
    ``("decoders", [layer dict, ...])``, ``("norm", {"scale"})``,
    ``("head", {"kernel"})``. Weights arrive cast to ``dtype`` on
    ``device``.

    Every layer read retries under ``retry_policy`` and, with
    ``verify_weights``, is checked against the directory's
    ``integrity.json`` (a directory without one warns and loads
    unverified). A mismatch is retried like an I/O error; one that survives
    two or more reads quarantines the file, drops it from ``host_cache`` and
    from the verdict cache, and raises ``ShardCorruptError``. With
    ``host_cache`` (a ``HostShardCache``), a shard's host tree — the
    page-locked tensors the read built — is looked up before any byte is
    read and put after a verified build; with tied embeddings the head is
    read once per source and cached under ``__tied_head__``. A readahead
    pool of ``readahead_threads`` (0 = none) warms the next shard's files.
    The JAX loader's fault injection and host-OOM typing wait for ROADMAP
    item 8.

    Stats: ``load_time`` (host reads, misses only), ``bytes_loaded`` (host
    bytes uploaded, hits included), ``retries`` (a ``RetryRecorder``) and
    ``integrity`` (an ``IntegrityRecorder``).
    """

    def __init__(self, model_path: str, layer_names: Sequence[str],
                 shards: Sequence[tuple[int, ...]], dtype: torch.dtype,
                 device: torch.device, prefetch_depth: int = 1,
                 tied_embeddings: bool = False, *, verify_weights: bool = True,
                 host_cache: HostShardCache | None = None, readahead_threads: int = 2,
                 retry_policy: RetryPolicy | None = None):
        self.model_path = model_path
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
        self._prefetcher = FilePrefetcher(readahead_threads) if readahead_threads > 0 else None
        manifest_stat = integrity_manifest._file_key(
            os.path.join(model_path, integrity_manifest.MANIFEST_NAME))
        # Everything besides the layer indices that shapes a host tree.
        self._cache_key_base = (
            os.path.abspath(model_path), str(dtype), bool(tied_embeddings), manifest_stat,
            self._manifest is not None, self._cuda,
        )
        self._stop = threading.Event()
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
            self._tied_head = {"kernel": emb["embedding"]}  # transposed after upload
            if cache is not None and guard is not None:
                cache.put(key, self._tied_head, guard=guard)
            return self._tied_head
        return checkpoint.load_layer(self.model_path, name, self._cuda, manifest=self._manifest)

    def _place(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.device, non_blocking=True)
        return t.to(self.dtype) if t.is_floating_point() else t

    def _host_shard(self, layer_idxs: tuple[int, ...]) -> list[tuple[str, Any]]:
        """The shard's host trees: from the cache, or read and verified
        (then cached). The stat guard is taken before the first byte."""
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
        host = self._host_shard(layer_idxs)
        event = None
        if self._cuda:
            with torch.cuda.stream(self._stream):
                placed = [(n, _tree_map(self._place, tree)) for n, tree in host]
                event = torch.cuda.Event()
                event.record(self._stream)
        else:
            placed = [(n, _tree_map(self._place, tree)) for n, tree in host]
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
                if self.tied:
                    params = {"kernel": params["kernel"].T}
                segments.append(("head", params))
        return segments, event

    def _produce(self, i: int):
        """Shard ``i``, with the next shard's files queued for readahead."""
        if i + 1 < len(self.shards):
            self.warm(self.shards[i + 1])
        return self._build(self.shards[i])

    def _ready(self, item):
        """Order the upload before the consumer's stream and keep the
        allocator from reusing the weights' memory while that stream runs."""
        segments, event = item
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
        for i in range(len(self.shards)):
            if self._stop.is_set():
                return
            try:
                item = self._produce(i)
            except Exception as e:  # carried to the consumer, which re-raises it
                self._put(_Fault(e))
                return
            if not self._put(item):
                return

    def __iter__(self):
        for i, idxs in enumerate(self.shards):
            if self._thread is None:
                item = self._produce(i)
            else:
                while True:
                    try:
                        item = self._q.get(timeout=0.2)
                        break
                    except Empty:
                        if self._stop.is_set() or not self._thread.is_alive():
                            raise SourceClosed("weight source closed while streaming") from None
                if isinstance(item, _Fault):
                    raise item.error
            yield idxs, self._ready(item)

    def close(self) -> None:
        """Stop the prefetch thread, drop queued shards and retire the
        readahead pool."""
        self._stop.set()
        if self._thread is not None:
            while self._thread.is_alive():
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


class StreamStats:
    """The JAX executor's host-path stats keys over one call: ``io_retries``
    and the integrity counters when nonzero, the process host cache's
    ``host_cache_hits``/``host_cache_misses``/``host_cache_hit_rate``, and
    the crc verdict cache's ``crc_verdict_hits``/``crc_full_verifies`` when
    nonzero. Baselines are taken before the source starts reading."""

    def __init__(self, cache: HostShardCache | None):
        self.cache = cache
        self.cache_before = cache.stats() if cache is not None else None
        self.verdict_before = integrity_manifest.verdict_stats()

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
        return out


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
                )
        elif kind == "norm":
            suffix_h = llama.select_eos_and_norm(params, model_cfg, suffix_h, suffix_eos)
            prefix_h = None
        else:
            block_scores = llama.lm_head_scores(params, suffix_h, model_cfg.final_logit_softcap)
    return prefix_h, suffix_h, block_scores


def process_block(model_cfg: LlamaConfig, dtype: torch.dtype, segments: Segments,
                  layer_idxs: tuple[int, ...], n_layers: int, store: ActivationStore,
                  b: int, idxs: list[int], meta, toks: list[TokenizedPrompt],
                  scores: dict[int, np.ndarray]) -> None:
    """One shard over one block: fetch its activations (unless the shard
    starts at the embedding), apply the segments, keep any head scores (rows
    cut to the true suffix count), and park the activations for the next
    shard. Prefix states end at the last decoder layer (index n_layers-3)."""
    first, last = layer_idxs[0], layer_idxs[-1]
    if first == 0:
        prefix_h = suffix_h = None
    else:
        prefix_h, suffix_h = store.fetch(b, idxs, with_prefix=first <= n_layers - 3)
    prefix_h, suffix_h, block_scores = apply_segments(
        model_cfg, dtype, segments, prefix_h, suffix_h, meta, first_decoder(layer_idxs)
    )
    if block_scores is not None:
        host = block_scores.to("cpu").numpy()
        for row, i in enumerate(idxs):
            scores[i] = host[row, : toks[i].num_suffixes, None, :]
    if last != n_layers - 1:
        store.store(b, idxs, prefix_h, suffix_h)


class StreamingExecutor:
    """Single-device layer-streaming scorer.

    ``__call__(prompts)`` takes ``[(prefix_str, (suffix_str, ...)), ...]``
    and returns one float32 ``[n_suffixes, 1, vocab]`` next-token
    distribution per prompt.
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
        self.stats: dict[str, float] = {}
        self.stats_history: list[dict[str, float]] = []

    def weight_source(self, n_passes: int = 1) -> tuple[ShardWeightSource, StreamStats]:
        """One source over ``n_passes`` full passes of the shard list, on the
        process host cache, and the baselines of its stats."""
        cfg = self.cfg
        cache = cache_for(cfg)
        stats = StreamStats(cache)
        source = ShardWeightSource(
            cfg.model_path, self.layer_names, list(self.plan.shards) * n_passes,
            self.dtype, self.device, cfg.prefetch_depth, self.model_cfg.tie_word_embeddings,
            verify_weights=cfg.verify_weights, host_cache=cache,
            readahead_threads=cfg.readahead_threads, retry_policy=cfg.retry_policy(),
        )
        return source, stats

    def activation_store(self, source: ShardWeightSource, batch: int) -> ActivationStore:
        cfg = self.cfg
        return ActivationStore(
            cfg.storage_location, self.device, self.dtype, cfg.disk_folder,
            max_in_cpu=cfg.max_activation_in_cpu, batch=batch, integrity=source.integrity,
            retry_policy=cfg.retry_policy(), retry_recorder=source.retries,
        )

    @torch.inference_mode()
    def __call__(self, prompts, batch: int = 0) -> list[np.ndarray]:
        t_start = time.perf_counter()
        toks = [self.tokenizer(p, s) for p, s in prompts]
        check_longrope_regime(self.model_cfg, toks)
        blocks = make_blocks(toks, self.cfg.block_size)
        metas = [block_meta(toks, idxs, self.device) for idxs in blocks]
        scores: dict[int, np.ndarray] = {}
        n_layers = len(self.layer_names)
        compute_time = source_wait = 0.0
        source, host_stats = self.weight_source()
        store = self.activation_store(source, batch)
        try:
            it = iter(source)
            for shard_pos in range(len(self.plan.shards)):
                t_wait = time.perf_counter()
                layer_idxs, segments = next(it)
                source_wait += time.perf_counter() - t_wait
                store.set_shard(shard_pos)
                t0 = time.perf_counter()
                for b, idxs in enumerate(blocks):
                    process_block(
                        self.model_cfg, self.dtype, segments, layer_idxs, n_layers, store,
                        b, idxs, metas[b], toks, scores,
                    )
                sync(self.device)
                compute_time += time.perf_counter() - t0
                del segments
        finally:
            source.close()
            store.clear()
        self.stats = {
            "load_weights_time_s": source.load_time,
            "compute_wall_s": compute_time,
            "source_wait_s": source_wait,
            "total_wall_s": time.perf_counter() - t_start,
            "tokens_processed": float(sum(t.tokens_processed for t in toks)),
            "streamed_bytes": float(source.bytes_loaded),
            **host_stats.read(source),
        }
        peak = peak_mem_gb(self.device)
        if peak is not None:
            self.stats["peak_mem_gb"] = peak
        self.stats_history.append(dict(self.stats))
        return [scores[i] for i in range(len(prompts))]


__all__ = [
    "ShardWeightSource",
    "SourceClosed",
    "StreamStats",
    "StreamingExecutor",
    "apply_segments",
    "block_meta",
    "first_decoder",
    "peak_mem_gb",
    "process_block",
    "sync",
]
