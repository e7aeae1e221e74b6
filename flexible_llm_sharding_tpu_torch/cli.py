"""The batch CLI of the PyTorch/CUDA port.

Same file contract as the JAX package's batch CLI: the prompt pickle holds
``[(prefix_str, (suffix_str, ...)), ...]``; the output pickle gets one
float32 ``[n_suffixes, num_gen_token, vocab]`` array per prompt, and
``<prompt_pickle>_updated.pkl`` the prompts with the generated text appended
to every suffix. A JSON stats line goes to stderr at the end.

    python -m flexible_llm_sharding_tpu_torch --model_path M \\
        --prompt_pickle p.pkl --output_file s.pkl [--kv_cache true]
    python -m flexible_llm_sharding_tpu_torch verify --model_path M [--spill_dir S]

The run is on the CUDA device unless ``--device cpu`` is given; without a
card a CUDA run raises instead of falling back to the CPU. By default, as in
the JAX batch CLI, every layer load is verified against ``integrity.json``
(``--verify_weights``), passes after the first are served from the process
host shard cache (``--host_cache_gb``, auto = a quarter of the available
RAM), the next shard's files are read ahead (``--readahead_threads``) and
failed reads retry (``--io_retry_*``). ``verify`` audits a model directory
and/or a spill directory and exits 2 on any problem.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time

from flexible_llm_sharding_tpu_torch.config import (
    DEFAULT_MAX_TOKEN_LEN,
    DTYPES,
    STORAGE_LOCATIONS,
    FrameworkConfig,
    resolve_device,
)
from flexible_llm_sharding_tpu_torch.utils.metrics import host_rss_gib


def _str2bool(v: str) -> bool:
    if v.lower() in ("true", "1", "yes", "y"):
        return True
    if v.lower() in ("false", "0", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def _float_or_auto(v: str) -> float | None:
    if v.lower() == "auto":
        return None
    return float(v)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m flexible_llm_sharding_tpu_torch",
        description="Layer-streaming LLM scorer/generator on a CUDA device",
    )
    p.add_argument("--model_path", type=str, default="./")
    p.add_argument("--prompt_pickle", type=str, required=True)
    p.add_argument("--output_file", type=str, required=True)
    p.add_argument("--num_batch", type=int, default=1)
    p.add_argument("--layer_num_per_shard", type=int, default=1)
    p.add_argument("--storage_location", type=str, default="cpu", choices=STORAGE_LOCATIONS,
                   help="where activations wait between shards")
    p.add_argument("--max_activation_in_cpu", type=int, default=100)
    p.add_argument("--data_parallel", type=_str2bool, default=False,
                   help="accepted for parity with the reference; one device runs everything")
    p.add_argument("--disk_folder", type=str, default="./temp")
    p.add_argument("--num_gen_token", type=int, default=1)
    p.add_argument("--dtype", type=str, default="bfloat16", choices=tuple(DTYPES))
    p.add_argument("--kv_cache", type=_str2bool, default=False,
                   help="generate with a KV cache (token-id append semantics)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--temperature", type=float, default=0.0, help="0 = greedy")
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--block_size", type=int, default=8)
    p.add_argument("--max_token_len", type=int, default=DEFAULT_MAX_TOKEN_LEN)
    p.add_argument("--bucket_multiple", type=int, default=64)
    p.add_argument("--prefetch_depth", type=int, default=1,
                   help="shards read and uploaded ahead of compute; 0 = serialized")
    p.add_argument("--io_retry_attempts", type=int, default=4,
                   help="attempts per layer read before a typed ShardLoadError; 1 = no retry")
    p.add_argument("--io_retry_base_s", type=float, default=0.05,
                   help="first retry backoff; doubles per attempt (jittered)")
    p.add_argument("--io_retry_deadline_s", type=float, default=60.0,
                   help="overall wall cap per retried read (0 = none)")
    p.add_argument("--verify_weights", type=_str2bool, default=True,
                   help="crc-verify every layer load against the model dir's integrity.json "
                        "(a mismatch re-reads; persistent corruption raises ShardCorruptError); "
                        "each file generation is hashed once per process")
    p.add_argument("--host_cache_gb", type=_float_or_auto, default=None,
                   help="process host shard cache budget in GB: passes after the first skip "
                        "the disk read and the crc. 'auto' (default) = a quarter of the "
                        "available RAM; 0 = off")
    p.add_argument("--readahead_threads", type=int, default=2,
                   help="threads of the page-cache readahead pool that warms the next "
                        "shard's files; 0 = off")
    return p


def build_verify_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m flexible_llm_sharding_tpu_torch verify",
        description="Offline integrity audit: recompute every checksum of a prepared model dir "
                    "(against integrity.json) and/or a spill dir (against the .npy sidecars). "
                    "Prints a per-file report and exits 2 on any problem, structural drift "
                    "included.",
    )
    p.add_argument("--model_path", type=str, default=None, help="prepared per-layer checkpoint dir")
    p.add_argument("--spill_dir", type=str, default=None,
                   help="activation spill dir (--disk_folder of a run)")
    return p


def verify_main(argv: list[str] | None = None) -> None:
    """The ``verify`` subcommand: exits 2 when a report has a problem."""
    args = build_verify_parser().parse_args(argv)
    if not args.model_path and not args.spill_dir:
        raise SystemExit("verify: give --model_path and/or --spill_dir")
    from flexible_llm_sharding_tpu_torch.integrity.verify import (
        format_report,
        verify_model_dir,
        verify_spill_dir,
    )

    reports = []
    if args.model_path:
        reports.append(verify_model_dir(args.model_path))
    if args.spill_dir:
        reports.append(verify_spill_dir(args.spill_dir))
    for r in reports:
        print(format_report(r))
    if not all(r["ok"] for r in reports):
        raise SystemExit(2)


def config_from_args(args: argparse.Namespace) -> FrameworkConfig:
    return FrameworkConfig(
        model_path=args.model_path,
        num_batch=args.num_batch,
        layer_num_per_shard=args.layer_num_per_shard,
        storage_location=args.storage_location,
        max_activation_in_cpu=args.max_activation_in_cpu,
        data_parallel=args.data_parallel,
        disk_folder=args.disk_folder,
        num_gen_token=args.num_gen_token,
        dtype=args.dtype,
        block_size=args.block_size,
        max_token_len=args.max_token_len,
        bucket_multiple=args.bucket_multiple,
        kv_cache=args.kv_cache,
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
        seed=args.seed,
        prefetch_depth=args.prefetch_depth,
        device=args.device,
        io_retry_attempts=args.io_retry_attempts,
        io_retry_base_s=args.io_retry_base_s,
        io_retry_deadline_s=args.io_retry_deadline_s,
        verify_weights=args.verify_weights,
        host_cache_gb=args.host_cache_gb,
        readahead_threads=args.readahead_threads,
    )


def _updated_path(p: str) -> str:
    root, ext = os.path.splitext(p)
    return f"{root}_updated{ext or '.pkl'}"


# Host-path counters of the executor's stats, summed over its calls.
_SUMMED_HOST_KEYS = ("io_retries", "integrity_failures", "reread_heals", "quarantined_shards",
                     "host_cache_hits", "host_cache_misses", "crc_verdict_hits",
                     "crc_full_verifies")


def main(argv: list[str] | None = None, tokenizer=None) -> dict | None:
    """Run the batch CLI and return the stats it prints, or the ``verify``
    subcommand."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "verify":
        return verify_main(argv[1:])
    args = build_parser().parse_args(argv)
    try:
        cfg = config_from_args(args)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    device = resolve_device(cfg.device)
    if cfg.storage_location == "disk":
        os.makedirs(cfg.disk_folder, exist_ok=True)
    with open(args.prompt_pickle, "rb") as f:
        prompts = pickle.load(f)
    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(cfg.model_path)
        tokenizer.pad_token = tokenizer.eos_token

    from flexible_llm_sharding_tpu_torch.runtime.decode import DecodeGenerator
    from flexible_llm_sharding_tpu_torch.runtime.executor import StreamingExecutor
    from flexible_llm_sharding_tpu_torch.runtime.generation import generation_loop
    from flexible_llm_sharding_tpu_torch.runtime.orchestration import run_decode, run_prompts

    if device.type == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    if cfg.kv_cache:
        ex = DecodeGenerator(cfg, device=device, tokenizer=tokenizer)
        output_scores, updated, _ = run_decode(cfg, prompts, generator=ex)
    else:
        ex = StreamingExecutor(cfg, device=device, tokenizer=tokenizer)
        output_scores, updated = generation_loop(
            lambda ps: run_prompts(cfg, ps, executor=ex),
            prompts,
            cfg.num_gen_token,
            tokenizer,
            temperature=cfg.temperature,
            seed=cfg.seed,
            top_k=cfg.top_k,
            top_p=cfg.top_p,
        )
    wall = time.perf_counter() - t0

    with open(_updated_path(args.prompt_pickle), "wb") as f:
        pickle.dump(updated, f)
    with open(args.output_file, "wb") as f:
        pickle.dump(output_scores, f)

    calls = ex.stats_history
    tokens = int(sum(c["tokens_processed"] for c in calls))
    stats = {
        "device": str(device),
        "dtype": cfg.dtype,
        "prompts": len(prompts),
        "num_gen_token": cfg.num_gen_token,
        "kv_cache": cfg.kv_cache,
        "wall_s": wall,
        "generated_tokens": sum(s.shape[0] for s in output_scores) * cfg.num_gen_token,
        "tokens_processed": tokens,
        "tokens_per_sec": tokens / wall if wall > 0 else 0.0,
    }
    for key in ("streamed_bytes", "load_weights_time_s", "source_wait_s", "compute_wall_s"):
        stats[key] = sum(c[key] for c in calls)
    for key in _SUMMED_HOST_KEYS:
        total = sum(c.get(key, 0.0) for c in calls)
        if total or (key.startswith("host_cache") and any(key in c for c in calls)):
            stats[key] = total
    looked_up = stats.get("host_cache_hits", 0.0) + stats.get("host_cache_misses", 0.0)
    if looked_up:
        stats["host_cache_hit_rate"] = round(stats["host_cache_hits"] / looked_up, 4)
    peaks = [c["peak_mem_gb"] for c in calls if "peak_mem_gb" in c]
    if peaks:
        stats["peak_mem_gb"] = max(peaks)
    rss = host_rss_gib()
    stats["peak_host_rss_gib"] = rss["peak"]
    if "rss" in rss:
        stats["host_rss_gib"] = rss["rss"]
    print(json.dumps(stats), file=sys.stderr)
    return stats


__all__ = ["build_parser", "build_verify_parser", "main", "verify_main"]
