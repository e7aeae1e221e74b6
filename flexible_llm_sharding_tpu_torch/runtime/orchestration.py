"""Entry points over a list of devices (the JAX package's
``runtime/orchestration.py``, without tensor parallelism, several hosts or
long context).

- One device: a ``StreamingExecutor`` (or a ``DecodeGenerator``).
- Several, ``data_parallel`` off: the interleaved MP pipeline
  (``runtime/pipeline.py``; for decode, a ``DecodeGenerator`` over
  ``mp_devices``).
- Several, ``data_parallel`` on: the prompts split with
  ``np.array_split`` sizes, one thread and one executor (or generator) per
  rank with prompts, all fed by one ``BroadcastShardSource`` that reads each
  shard once per pass. A rank's failure closes the source, unblocking the
  others, and its own exception is the one raised.

``pick_devices`` is the device list the CLI runs on: every card (cut to
``num_devices``), or on the CPU ``num_devices`` CPU stages or ranks. The
entry points take an explicit ``devices=`` list too, which may name one
device several times (``[cuda:0] * 4``).

``calls`` (a list, optional) receives one stats dict per pass, summed by
the CLI's stats line: a DP fan-out's dict counts the shared stream once.
"""

from __future__ import annotations

import time
from concurrent.futures import FIRST_EXCEPTION, ThreadPoolExecutor, wait
from typing import Sequence

import numpy as np
import torch

from flexible_llm_sharding_tpu_torch.config import (
    FrameworkConfig,
    LlamaConfig,
    indexed_device,
    resolve_device,
)
from flexible_llm_sharding_tpu_torch.faults.inject import FaultInjector
from flexible_llm_sharding_tpu_torch.parallel.planner import (
    batch_ranges,
    plan_shards_dp,
    split_prompts_dp,
)
from flexible_llm_sharding_tpu_torch.runtime import residency
from flexible_llm_sharding_tpu_torch.runtime.decode import DecodeGenerator
from flexible_llm_sharding_tpu_torch.runtime.executor import (
    BroadcastShardSource,
    SourceClosed,
    StreamingExecutor,
    StreamStats,
    peak_over,
)
from flexible_llm_sharding_tpu_torch.runtime.hostcache import cache_for
from flexible_llm_sharding_tpu_torch.runtime.pipeline import PipelineRunner
from flexible_llm_sharding_tpu_torch.utils import checkpoint

Prompt = tuple[str, tuple[str, ...]]

# Per-rank stats summed over every DP fan-out since the last clear: {rank:
# {prompts, total_wall_s, compute_wall_s, source_wait_s}} (the generation
# loop's passes sum into the same ranks). The CLI clears it at the start of
# a run and prints it as ``dp_ranks``: where each rank's wall went.
LAST_DP_RANK_STATS: dict[int, dict[str, float]] = {}

# The decode modes a DP fan-out reports, from its first rank.
_DECODE_MODE_KEYS = ("decode_resident", "decode_fused", "decode_speculative",
                     "decode_kv_on_device", "decode_graph")


def pick_devices(cfg: FrameworkConfig) -> list[torch.device]:
    """The devices of a run: ``cuda:0 ... cuda:{n-1}`` cut to
    ``num_devices`` (0 = all; a device named with its index is used alone),
    or on the CPU ``[cpu] * max(1, num_devices)``."""
    dev = resolve_device(cfg.device)
    if dev.type == "cpu":
        return [dev] * max(1, cfg.num_devices)
    if dev.index is not None:
        return [dev]
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return devs[: cfg.num_devices] if cfg.num_devices > 0 else devs


def _gather_dp(pool: ThreadPoolExecutor, futures, source) -> list:
    """The DP ranks' results, in rank order. On the first failure the source
    is closed before anything else: a dead rank stops draining its queue, so
    the producer would block and starve every other rank. The root cause is
    raised, not the ``SourceClosed`` the other ranks then die with."""
    try:
        done, _ = wait(futures, return_when=FIRST_EXCEPTION)
        if any(f.exception() is not None for f in done):
            source.close()
            wait(futures)
            root = None
            for f in futures:
                e = f.exception()
                if e is not None and (root is None or isinstance(root, SourceClosed)):
                    root = e
            raise root
        return [f.result() for f in futures]
    finally:
        source.close()
        pool.shutdown(wait=True)


def _run_batched(ex: StreamingExecutor, prompts: list[Prompt], num_batch: int):
    """The reference's ``num_batch`` loop: each batch one full streaming
    pass; the batch index scopes its disk files and resume marker."""
    out: list[np.ndarray] = []
    for i, (lo, hi) in enumerate(batch_ranges(len(prompts), num_batch)):
        out += ex(prompts[lo:hi], batch=i)
    return out


def _dp_targets(cfg: FrameworkConfig, devices: list):
    """The DP ranks' execution targets: the devices themselves (groups of
    tensor-parallel devices are not ported)."""
    return list(devices), len(devices)


def _devices(cfg: FrameworkConfig, devices) -> list[torch.device]:
    return [indexed_device(d) for d in (devices if devices is not None else pick_devices(cfg))]


def _record(calls, history) -> None:
    if calls is not None:
        calls.extend(dict(c) for c in history)


def _note_rank(rank: int, n_prompts: int, history) -> None:
    agg = LAST_DP_RANK_STATS.setdefault(rank, {"prompts": float(n_prompts)})
    for call in history:
        for key in ("total_wall_s", "compute_wall_s", "source_wait_s"):
            if key in call:
                agg[key] = agg.get(key, 0.0) + call[key]


def _dp_call(histories, source, host_stats: StreamStats, devices, tier, wall: float) -> dict:
    """One stats dict for a DP fan-out: the ranks' work summed, the shared
    stream's reads and bytes counted once."""
    calls = [c for h in histories for c in h]
    out = {
        "total_wall_s": wall,
        "load_weights_time_s": source.load_time,
        "streamed_bytes": float(source.bytes_loaded),
        **{key: sum(c.get(key, 0.0) for c in calls)
           for key in ("compute_wall_s", "source_wait_s", "tokens_processed")},
        **host_stats.read(source),
    }
    if histories and histories[0]:
        out.update({k: v for k, v in histories[0][-1].items() if k in _DECODE_MODE_KEYS})
    peak = peak_over(devices, tier)
    if peak is not None:
        out["peak_mem_gb"] = peak
    return out


def _broadcast(cfg: FrameworkConfig, model_cfg, layer_names, shards, devices, rounds: int,
               pin: bool = True):
    """The shared stream of a DP fan-out, on the process host cache and (when
    ``pin``) residency tier, and the baselines of its stats."""
    cache = cache_for(cfg)
    tier = (residency.tier_for(cfg, layer_names, model_cfg.tie_word_embeddings,
                               residency.probe_chip(devices[0])) if pin else None)
    host_stats = StreamStats(cache, tier, devices[0])
    source = BroadcastShardSource(
        cfg.model_path, layer_names, shards, cfg.torch_dtype, devices, cfg.prefetch_depth,
        model_cfg.tie_word_embeddings, rounds=rounds, verify_weights=cfg.verify_weights,
        host_cache=cache, readahead_threads=cfg.readahead_threads,
        retry_policy=cfg.retry_policy(), residency=tier,
        injector=FaultInjector.from_config(cfg.faults),
    )
    return source, host_stats, tier


def run_prompts(cfg: FrameworkConfig, prompts: Sequence[Prompt], tokenizer=None,
                devices: list | None = None, calls: list | None = None) -> list[np.ndarray]:
    """Score every prompt once over the devices -> one ``[n_suffixes, 1,
    vocab]`` array per prompt, in prompt order."""
    prompts = list(prompts)
    if not prompts:
        return []
    devices = _devices(cfg, devices)
    if len(devices) <= 1 or not cfg.data_parallel:
        if len(devices) > 1:
            runner = PipelineRunner(cfg, devices, tokenizer=tokenizer)
            out = runner(prompts)
            _record(calls, runner.stats_history)
            return out
        ex = StreamingExecutor(cfg, device=devices[0], tokenizer=tokenizer)
        out = _run_batched(ex, prompts, cfg.num_batch)
        _record(calls, ex.stats_history)
        return out

    # DP: every rank with prompts streams the same shards in lockstep, read
    # from disk once per shard and pass. A rank with none is left out of
    # the broadcast, so the producer never waits on an idle queue.
    t0 = time.perf_counter()
    model_cfg = LlamaConfig.from_pretrained(cfg.model_path)
    targets, n = _dp_targets(cfg, devices)
    ranges = split_prompts_dp(len(prompts), n)
    layer_names = checkpoint.layer_names_for(model_cfg.num_hidden_layers)
    n_layers = len(layer_names)
    active = [rank for rank in range(n) if ranges[rank][0] < ranges[rank][1]]
    active_devs = [targets[r] for r in active]
    source, host_stats, tier = _broadcast(
        cfg, model_cfg, layer_names, plan_shards_dp(n_layers, cfg.layer_num_per_shard).shards,
        active_devs, rounds=cfg.num_batch)

    def run_one(slot: int):
        rank = active[slot]
        lo, hi = ranges[rank]
        ex = StreamingExecutor(
            cfg, device=targets[rank], tokenizer=tokenizer,
            plan=plan_shards_dp(n_layers, cfg.layer_num_per_shard, device_rank=rank,
                                num_devices=n),
            weight_source_factory=lambda: source.view(slot),
        )
        try:
            return _run_batched(ex, prompts[lo:hi], cfg.num_batch), ex.stats_history
        finally:
            _note_rank(rank, hi - lo, ex.stats_history)

    pool = ThreadPoolExecutor(max_workers=len(active), thread_name_prefix="dp-rank")
    outputs = _gather_dp(pool, [pool.submit(run_one, slot) for slot in range(len(active))],
                         source)
    _record(calls, [_dp_call([h for _, h in outputs], source, host_stats, active_devs, tier,
                             time.perf_counter() - t0)])
    return [s for chunk, _ in outputs for s in chunk]


def run_decode(cfg: FrameworkConfig, prompts: Sequence[Prompt], tokenizer=None,
               devices: list | None = None, calls: list | None = None):
    """KV-cache decode of every prompt over the devices. Returns (scores,
    updated_prompts, tokens_processed)."""
    prompts = list(prompts)
    if not prompts:
        return [], [], 0

    def one(gen: DecodeGenerator):
        scores, updated = gen(prompts)
        _record(calls, gen.stats_history[-1:])
        return scores, updated, int(gen.stats["tokens_processed"])

    devices = _devices(cfg, devices)
    if len(devices) > 1 and not cfg.data_parallel:
        # The interleaved pipeline: each stage's weights and KV on its device.
        return one(DecodeGenerator(cfg, tokenizer=tokenizer, mp_devices=devices))
    if len(devices) <= 1 or len(prompts) <= 1:
        return one(DecodeGenerator(cfg, device=devices[0], tokenizer=tokenizer))

    # DP decode: one broadcast stream, a round per weight pass (prefill and
    # each step), or one round when the weights stay resident. Residency is
    # decided here, once, so every rank agrees with the round count.
    t0 = time.perf_counter()
    model_cfg = LlamaConfig.from_pretrained(cfg.model_path)
    targets, n = _dp_targets(cfg, devices)
    ranges = split_prompts_dp(len(prompts), n)
    layer_names = checkpoint.layer_names_for(model_cfg.num_hidden_layers)
    active = [rank for rank in range(n) if ranges[rank][0] < ranges[rank][1]]
    active_devs = [targets[r] for r in active]
    resident = cfg.decode_resident_enabled(model_cfg, 1, residency.probe_chip(active_devs[0]))
    source, host_stats, tier = _broadcast(
        cfg, model_cfg, layer_names,
        plan_shards_dp(len(layer_names), cfg.layer_num_per_shard).shards, active_devs,
        rounds=1 if resident else cfg.num_gen_token, pin=not resident)

    def run_one(slot: int):
        rank = active[slot]
        lo, hi = ranges[rank]
        gen = DecodeGenerator(cfg, device=targets[rank], tokenizer=tokenizer,
                              weight_source_factory=lambda: source.view(slot),
                              resident=resident)
        try:
            scores, updated = gen(prompts[lo:hi])
            return (scores, updated, int(gen.stats["tokens_processed"])), gen.stats_history
        finally:
            _note_rank(rank, hi - lo, gen.stats_history)

    pool = ThreadPoolExecutor(max_workers=len(active), thread_name_prefix="dp-rank")
    outputs = _gather_dp(pool, [pool.submit(run_one, slot) for slot in range(len(active))],
                         source)
    _record(calls, [_dp_call([h for _, h in outputs], source, host_stats, active_devs, tier,
                             time.perf_counter() - t0)])
    scores = [s for (sc, _, _), _ in outputs for s in sc]
    updated = [u for (_, up, _), _ in outputs for u in up]
    return scores, updated, sum(t for (_, _, t), _ in outputs)


__all__ = ["LAST_DP_RANK_STATS", "pick_devices", "run_decode", "run_prompts"]
