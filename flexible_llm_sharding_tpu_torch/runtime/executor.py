"""The streaming executor: the model passes through the device one shard of
layers at a time (the JAX package's ``runtime/executor.py``, single-device
part).

For every shard, every block of same-bucket prompts runs through the
shard's layers before the next shard is loaded; activations wait in an
``ActivationStore`` between shards. ``ShardWeightSource`` streams the
weights: with ``prefetch_depth >= 1`` a thread stays that many shards ahead
of compute — while shard t computes, it reads shard t+1 from disk into
page-locked host memory and uploads it on a side CUDA stream; an event
orders each upload before the compute that reads it. The host cache,
residency tier, integrity checks, fault injection and resume of the JAX
package are not part of this port.
"""

from __future__ import annotations

import threading
import time
from queue import Empty, Full, Queue
from typing import Any, Sequence

import numpy as np
import torch

from flexible_llm_sharding_tpu_torch.config import FrameworkConfig, LlamaConfig, resolve_device
from flexible_llm_sharding_tpu_torch.models import llama
from flexible_llm_sharding_tpu_torch.parallel.planner import plan_shards_dp
from flexible_llm_sharding_tpu_torch.runtime.activations import ActivationStore
from flexible_llm_sharding_tpu_torch.runtime.tokenization import (
    PromptTokenizer,
    TokenizedPrompt,
    check_longrope_regime,
    longrope_total_len,
    make_blocks,
)
from flexible_llm_sharding_tpu_torch.utils import checkpoint

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
    """Shard weights, disk -> host -> device, optionally prefetched.

    Iterating yields ``(layer_idxs, segments)`` per shard, where segments is
    a list of ``(kind, params)``: ``("embed", {"embedding"})``,
    ``("decoders", [layer dict, ...])``, ``("norm", {"scale"})``,
    ``("head", {"kernel"})``. Weights arrive cast to ``dtype`` on
    ``device``. Stats: ``load_time`` (host file reads), ``bytes_loaded``
    (host bytes built for upload).
    """

    def __init__(self, model_path: str, layer_names: Sequence[str],
                 shards: Sequence[tuple[int, ...]], dtype: torch.dtype,
                 device: torch.device, prefetch_depth: int = 1,
                 tied_embeddings: bool = False):
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
        self._stop = threading.Event()
        self._q: Queue = Queue(maxsize=max(1, prefetch_depth))
        self._thread: threading.Thread | None = None
        if prefetch_depth >= 1:
            self._thread = threading.Thread(target=self._producer, daemon=True)
            self._thread.start()

    def _read(self, name: str) -> dict[str, Any]:
        if name == "lm_head" and self.tied:
            emb = checkpoint.load_layer(self.model_path, "model.embed_tokens", self._cuda)
            return {"kernel": emb["embedding"]}  # transposed after upload
        return checkpoint.load_layer(self.model_path, name, pin_memory=self._cuda)

    def _place(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.device, non_blocking=True)
        return t.to(self.dtype) if t.is_floating_point() else t

    def _build(self, layer_idxs: tuple[int, ...]):
        t0 = time.perf_counter()
        host = [(self.layer_names[i], self._read(self.layer_names[i])) for i in layer_idxs]
        self.load_time += time.perf_counter() - t0
        self.bytes_loaded += sum(t.nbytes for _, tree in host for t in _tree_leaves(tree))
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
        for idxs in self.shards:
            if self._stop.is_set():
                return
            try:
                item = self._build(idxs)
            except Exception as e:  # carried to the consumer, which re-raises it
                self._put(_Fault(e))
                return
            if not self._put(item):
                return

    def __iter__(self):
        for idxs in self.shards:
            if self._thread is None:
                item = self._build(idxs)
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
        """Stop the prefetch thread and drop queued shards."""
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

    def weight_source(self, n_passes: int = 1) -> ShardWeightSource:
        """One source over ``n_passes`` full passes of the shard list."""
        return ShardWeightSource(
            self.cfg.model_path, self.layer_names, list(self.plan.shards) * n_passes,
            self.dtype, self.device, self.cfg.prefetch_depth,
            self.model_cfg.tie_word_embeddings,
        )

    @torch.inference_mode()
    def __call__(self, prompts, batch: int = 0) -> list[np.ndarray]:
        t_start = time.perf_counter()
        toks = [self.tokenizer(p, s) for p, s in prompts]
        check_longrope_regime(self.model_cfg, toks)
        blocks = make_blocks(toks, self.cfg.block_size)
        store = ActivationStore(
            self.cfg.storage_location, self.device, self.dtype, self.cfg.disk_folder,
            max_in_cpu=self.cfg.max_activation_in_cpu, batch=batch,
        )
        metas = [block_meta(toks, idxs, self.device) for idxs in blocks]
        scores: dict[int, np.ndarray] = {}
        n_layers = len(self.layer_names)
        compute_time = source_wait = 0.0
        source = self.weight_source()
        try:
            it = iter(source)
            while True:
                t_wait = time.perf_counter()
                try:
                    layer_idxs, segments = next(it)
                except StopIteration:
                    break
                source_wait += time.perf_counter() - t_wait
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
        }
        peak = peak_mem_gb(self.device)
        if peak is not None:
            self.stats["peak_mem_gb"] = peak
        self.stats_history.append(dict(self.stats))
        return [scores[i] for i in range(len(prompts))]


__all__ = [
    "ShardWeightSource",
    "SourceClosed",
    "StreamingExecutor",
    "apply_segments",
    "block_meta",
    "first_decoder",
    "peak_mem_gb",
    "process_block",
    "sync",
]
