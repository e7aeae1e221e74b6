"""MP mode: the interleaved layer pipeline over a list of devices (the JAX
package's ``runtime/pipeline.py``).

The reference's assignment: contiguous layer shards, their count rounded up
to a multiple of the device count, go round-robin to the devices (shard k
on device k % N), and a prompt's activations hop device to device between
stages.

- One host thread drives every stage in global execution order
  (``planner.global_stage_order``); a round-up padding stage is skipped.
- The weights of stage t + 1 are read and uploaded to that stage's device,
  on its upload stream, while stage t computes (``ShardWeightSource`` with
  one device per shard).
- Activations hop with ``.to(next_device, non_blocking=True)``: device to
  device in ``gpu`` storage; ``cpu`` and ``disk`` keep the host and file
  transports, so disk mode resumes after a crash as the executor does, with
  the stage plan ``("mp", [(rank, shard), ...])`` in the signature (another
  device count restarts from zero).
- Before a stage is dispatched on a device, that device's previous stage
  is waited for: on distinct cards stage s + 1 runs while stage s finishes
  on its own card; with every stage on one card this keeps one stage's
  weights in flight, as the single-device executor does.

A pinned layer (``hbm_pin_gb``) stays on its stage's device. The list may
name one device several times (``[cuda:0] * 4``, or ``[cpu] * 4`` on the
CPU): every stage then runs on it, in the same order.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from flexible_llm_sharding_tpu_torch.config import FrameworkConfig, LlamaConfig, indexed_device
from flexible_llm_sharding_tpu_torch.integrity import manifest as integrity_manifest
from flexible_llm_sharding_tpu_torch.obs import trace as obs_trace
from flexible_llm_sharding_tpu_torch.faults.inject import FaultInjector
from flexible_llm_sharding_tpu_torch.parallel.planner import batch_ranges, global_stage_order
from flexible_llm_sharding_tpu_torch.runtime import residency, resume
from flexible_llm_sharding_tpu_torch.runtime.activations import ActivationStore, batch_tag
from flexible_llm_sharding_tpu_torch.runtime.executor import (
    ScoreSink,
    ShardWeightSource,
    StreamStats,
    block_meta,
    finalize_scores,
    peak_over,
    process_block,
    sync,
)
from flexible_llm_sharding_tpu_torch.runtime.hostcache import cache_for
from flexible_llm_sharding_tpu_torch.runtime.tokenization import (
    PromptTokenizer,
    check_longrope_regime,
    make_blocks,
)
from flexible_llm_sharding_tpu_torch.utils import checkpoint, metrics


class PipelineRunner:
    """One scoring pass per ``num_batch`` batch through the interleaved
    stages over ``devices``.

    Stats per batch (``stats``, and ``stats_history`` in call order): the
    executor's keys (``load_weights_time_s``, ``compute_wall_s``: the
    stages' dispatch and waits, ``source_wait_s``, ``streamed_bytes``, the
    host path's counters, ``peak_mem_gb``: the largest over the devices),
    ``dispatch_wall_s`` (until every stage was dispatched) against
    ``total_wall_s``, ``num_stages`` and, with a residency tier, the
    process-wide ``pinned_bytes``.
    """

    def __init__(self, cfg: FrameworkConfig, devices, tokenizer=None):
        from flexible_llm_sharding_tpu_torch.obs.registry import REGISTRY, weak_source

        obs_trace.ensure_configured(cfg)
        REGISTRY.register("pipeline", weak_source(self))
        self.cfg = cfg
        self.devices = [indexed_device(d) for d in devices]
        self.model_cfg = LlamaConfig.from_pretrained(cfg.model_path)
        self.dtype = cfg.torch_dtype
        if tokenizer is None:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(cfg.model_path)
        self.tokenizer = PromptTokenizer(
            tokenizer, max_token_len=cfg.max_token_len, bucket_multiple=cfg.bucket_multiple
        )
        self.layer_names = checkpoint.layer_names_for(self.model_cfg.num_hidden_layers)
        # (stage_idx, device_rank, layer_tuple) in execution order.
        self.stages = global_stage_order(len(self.layer_names), cfg.layer_num_per_shard,
                                         len(self.devices))
        # The model directory's content, in the resume signature and marker.
        self._manifest_digest = integrity_manifest.manifest_digest(
            integrity_manifest.load_manifest(cfg.model_path) if cfg.verify_weights else None)
        self.stats: dict[str, float] = {}
        self.stats_history: list[dict[str, float]] = []
        # One stage_dispatch event per stage (printed with --verbose_metrics).
        self.recorder = metrics.Recorder(verbose=cfg.verbose_metrics)

    def __call__(self, prompts) -> list[np.ndarray]:
        prompts = list(prompts)
        out: list[np.ndarray] = []
        for i, (lo, hi) in enumerate(batch_ranges(len(prompts), self.cfg.num_batch)):
            out += self._run_batch(prompts[lo:hi], batch=i)
        return out

    # -- disk-mode crash resume (the executor's, over stages) -----------------

    def _resume_signature(self, toks) -> str:
        return resume.workload_signature(
            toks, ("mp", [(r, s) for (_, r, s) in self.stages]), self.cfg.model_path,
            self.cfg.dtype, self.cfg.block_size, manifest_digest=self._manifest_digest)

    def _marker_path(self, sig: str, tag: str) -> str:
        return resume.marker_path(self.cfg.disk_folder, sig, tag)

    def _resume_start(self, sig: str, tag: str, last_real: int) -> int:
        """The first stage to run: 0, or with ``resume`` in disk mode the
        marker's completed stages. The head's stage is never marked: it
        produces the scores."""
        if not (self.cfg.resume and self.cfg.storage_location == "disk"):
            return 0
        data = resume.read_marker(self._marker_path(sig, tag), sig,
                                  manifest_hash=self._manifest_digest)
        return min(int(data.get("completed_stages", 0)), last_real)

    def _mark_stage(self, sig: str, tag: str, done: int) -> None:
        resume.write_marker(self._marker_path(sig, tag), sig, completed_stages=done,
                            manifest_hash=self._manifest_digest)

    @torch.inference_mode()
    def _run_batch(self, prompts, batch: int = 0) -> list[np.ndarray]:
        cfg = self.cfg
        t_start = time.perf_counter()
        toks = [self.tokenizer(p, s) for p, s in prompts]
        check_longrope_regime(self.model_cfg, toks)
        blocks = make_blocks(toks, cfg.block_size)
        resumable = cfg.storage_location == "disk"
        last_real = max((i for i, (_, _, s) in enumerate(self.stages) if s), default=0)
        tag = batch_tag(batch)
        sig = self._resume_signature(toks) if resumable else ""
        start = self._resume_start(sig, tag, last_real) if resumable else 0
        stages = self.stages[start:]
        cache = cache_for(cfg)
        tier = residency.tier_for(cfg, self.layer_names, self.model_cfg.tie_word_embeddings,
                                  self.devices[0])
        host_stats = StreamStats(cache, tier, self.devices[0])
        source = ShardWeightSource(
            cfg.model_path, self.layer_names, [s for (_, _, s) in stages], self.dtype,
            self.devices[0], cfg.prefetch_depth, self.model_cfg.tie_word_embeddings,
            verify_weights=cfg.verify_weights, host_cache=cache,
            readahead_threads=cfg.readahead_threads, retry_policy=cfg.retry_policy(),
            residency=tier, devices=[self.devices[r] for (_, r, _) in stages],
            injector=FaultInjector.from_config(cfg.faults),
        )
        store = ActivationStore(
            cfg.storage_location, self.devices[0], self.dtype, cfg.disk_folder,
            max_in_cpu=cfg.max_activation_in_cpu, batch=batch, integrity=source.integrity,
            retry_policy=cfg.retry_policy(), retry_recorder=source.retries,
        )
        n_layers = len(self.layer_names)
        scores = ScoreSink(cfg.score_sink_max_device)
        metas: dict[tuple, tuple] = {}  # (block, device) -> the block's ids on that device

        def meta_on(b: int, dev: torch.device):
            if (b, dev) not in metas:
                metas[(b, dev)] = block_meta(toks, blocks[b], dev)
            return metas[(b, dev)]

        compute_time = source_wait = 0.0
        bar = metrics.progress_bar(len(stages) * max(len(blocks), 1), desc="pipeline", unit="blk")
        try:
            it = iter(source)
            for stage_idx, rank, layer_idxs in stages:
                t_wait = time.perf_counter()
                _, segments = next(it)
                source_wait += time.perf_counter() - t_wait
                if not layer_idxs:  # a round-up padding stage
                    bar.update(max(len(blocks), 1))
                    continue
                dev = self.devices[rank]
                t0 = time.perf_counter()
                with obs_trace.span("pipeline_stage", cat="pipeline", stage=stage_idx, rank=rank):
                    sync(dev)  # this device's previous stage
                    store.set_shard(stage_idx)
                    for b, idxs in enumerate(blocks):
                        process_block(self.model_cfg, self.dtype, segments, layer_idxs, n_layers,
                                      store, b, idxs, meta_on(b, dev), toks, scores, device=dev)
                        bar.update(1)
                compute_time += time.perf_counter() - t0
                self.recorder.record("stage_dispatch", time.perf_counter() - t0,
                                     stage=stage_idx, rank=rank)
                del segments
                if resumable and stage_idx < last_real:
                    # The marker never claims a stage whose writes are queued.
                    store.flush()
                    self._mark_stage(sig, tag, stage_idx + 1)
        except BaseException:
            try:
                store.clear()
            except Exception:  # the stage's error is the one to surface
                pass
            raise
        finally:
            bar.close()
            source.close()
        dispatch_wall = time.perf_counter() - t_start
        for dev in dict.fromkeys(self.devices):
            sync(dev)
        finalize_scores(scores)
        store.clear()
        if resumable:
            resume.remove_marker(self._marker_path(sig, tag))
        self.stats = {
            "load_weights_time_s": source.load_time,
            "compute_wall_s": compute_time,
            "source_wait_s": source_wait,
            "dispatch_wall_s": dispatch_wall,
            "total_wall_s": time.perf_counter() - t_start,
            "num_stages": float(len(self.stages)),
            "tokens_processed": float(sum(t.tokens_processed for t in toks)),
            "streamed_bytes": float(source.bytes_loaded),
            **host_stats.read(source),
        }
        if tier is not None:
            # Process-wide: every stage device's pins.
            self.stats["pinned_bytes"] = float(tier.stats()["pinned_bytes"])
        peak = peak_over(self.devices, tier)
        if peak is not None:
            self.stats["peak_mem_gb"] = peak
        self.stats_history.append(dict(self.stats))
        return [scores[i] for i in range(len(prompts))]


def run_pipeline(cfg: FrameworkConfig, prompts, devices, tokenizer=None) -> list[np.ndarray]:
    return PipelineRunner(cfg, devices, tokenizer=tokenizer)(list(prompts))


__all__ = ["PipelineRunner", "run_pipeline"]
