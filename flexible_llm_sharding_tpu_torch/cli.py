"""The batch CLI of the PyTorch/CUDA port.

Same file contract as the JAX package's batch CLI: the prompt pickle holds
``[(prefix_str, (suffix_str, ...)), ...]``; the output pickle gets one
float32 ``[n_suffixes, num_gen_token, vocab]`` array per prompt, and
``<prompt_pickle>_updated.pkl`` the prompts with the generated text appended
to every suffix. A JSON stats line goes to stderr at the end.

    python -m flexible_llm_sharding_tpu_torch --model_path M \\
        --prompt_pickle p.pkl --output_file s.pkl [--kv_cache true]

The run is on the CUDA device unless ``--device cpu`` is given; without a
card a CUDA run raises instead of falling back to the CPU.
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


def _str2bool(v: str) -> bool:
    if v.lower() in ("true", "1", "yes", "y"):
        return True
    if v.lower() in ("false", "0", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


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
    return p


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
    )


def _updated_path(p: str) -> str:
    root, ext = os.path.splitext(p)
    return f"{root}_updated{ext or '.pkl'}"


def main(argv: list[str] | None = None, tokenizer=None) -> dict:
    """Run the batch CLI; returns the stats it prints."""
    args = build_parser().parse_args(sys.argv[1:] if argv is None else list(argv))
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
    peaks = [c["peak_mem_gb"] for c in calls if "peak_mem_gb" in c]
    if peaks:
        stats["peak_mem_gb"] = max(peaks)
    print(json.dumps(stats), file=sys.stderr)
    return stats


__all__ = ["build_parser", "main"]
