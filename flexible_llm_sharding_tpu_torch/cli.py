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
failed reads retry (``--io_retry_*``). With ``--kv_cache`` the decode modes
take the JAX CLI's defaults: weights stay on the card after prefill when
they fit (``--decode_resident auto``), the KV beside them, and a block's
greedy steps run on the device as one CUDA graph (``--decode_fused auto``;
uncaptured for models with MoE layers); ``--speculative_k N`` verifies N
prompt-lookup drafts per pass. ``--hbm_pin_gb`` (default 0, off; ``auto``
= the card's free memory less 35% of its total) keeps the layers that
stream the most bytes on the card and streams the rest. int8, int4 and
mixed-precision checkpoints (``prepare_weights --dtype int8|int4``,
``--precision_plan``) stream packed and are dequantized on the card.

``--storage_location disk`` writes a progress marker after every shard
whose activations are on disk; ``--resume true`` restarts a crashed run of
the same workload at the first shard it left, and a spill that stays
corrupt is recomputed from the previous shard. ``--score_sink_max_device``
caps the prompts whose head scores wait on the card, their host copies in
flight.

``verify`` audits a model directory (its precision plan included) and/or a
spill directory and exits 2 on any problem; ``verify --hbm_pin_gb N``
dry-runs the residency planner. ``plan-precision`` probes each layer's
sensitivity on a calibration batch and plans an int4/int8/bf16 dtype per
layer under a byte budget or a divergence cap (``--apply`` writes the
mixed checkpoint).
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
    p.add_argument("--decode_resident", type=str, default="auto", choices=("auto", "on", "off"),
                   help="kv_cache mode: keep streamed weights on the card after prefill when "
                        "they fit (auto = judge against the card's memory), so decode steps "
                        "move zero weight bytes")
    p.add_argument("--decode_fused", type=str, default="auto", choices=("auto", "on", "off"),
                   help="resident kv_cache mode: run ALL greedy decode steps of a block on the "
                        "device, as one CUDA graph unless the model has MoE layers (on-device "
                        "argmax, zero per-token host round-trips); 'on' errors if the "
                        "preconditions don't hold")
    p.add_argument("--hbm_pin_gb", type=_float_or_auto, default=0.0,
                   help="device residency tier budget in GB: pin the hottest layers (embedding, "
                        "lm_head, norms, then as many transformer blocks as fit) on the card "
                        "and stream only the rest; every pass's host->device traffic drops by "
                        "exactly the pinned bytes, outputs token-identical. 'auto' = the "
                        "card's free memory minus activation headroom (off on the CPU); 0 "
                        "(default) = off. Quantized layers are charged packed and pinned "
                        "dequantized")
    p.add_argument("--score_sink_max_device", type=int, default=16,
                   help="max prompts whose head-stage scores stay on the card, their host "
                        "copies in flight, before older ones resolve to host memory (bigger = "
                        "fewer host waits on big batches, more device memory)")
    p.add_argument("--resume", type=_str2bool, default=False,
                   help="disk mode: resume a crashed run of the same workload from the last "
                        "completed shard")
    p.add_argument("--speculative_k", type=int, default=0,
                   help="kv_cache mode: verify this many prompt-lookup drafted tokens per "
                        "streamed pass (greedy-exact; divides weight streams per token by the "
                        "acceptance factor when the model must re-stream); 0 = off")
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
    p.add_argument("--hbm_pin_gb", type=str, default=None,
                   help="dry-run the device residency planner at this budget (GB, or 'auto' "
                        "for the card's free memory minus headroom): reports which layers the "
                        "budget would pin and the bytes each pass would skip; requires "
                        "--model_path. Nothing is loaded or pinned")
    p.add_argument("--json", action="store_true",
                   help="print the reports (and the residency plan) as one JSON object")
    return p


def verify_main(argv: list[str] | None = None) -> None:
    """The ``verify`` subcommand: exits 2 when a report has a problem."""
    args = build_verify_parser().parse_args(argv)
    if not args.model_path and not args.spill_dir:
        raise SystemExit("verify: give --model_path and/or --spill_dir")
    if args.hbm_pin_gb is not None and not args.model_path:
        raise SystemExit("verify: --hbm_pin_gb requires --model_path")
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
    residency_plan = None
    if args.hbm_pin_gb is not None:
        from flexible_llm_sharding_tpu_torch.runtime.residency import (
            auto_pin_budget_bytes,
            plan_report,
        )

        if args.hbm_pin_gb.lower() == "auto":
            budget = auto_pin_budget_bytes()
        else:
            try:
                gb = float(args.hbm_pin_gb)
            except ValueError:
                raise SystemExit(
                    f"verify: --hbm_pin_gb must be a GB number or 'auto', got {args.hbm_pin_gb!r}"
                ) from None
            if gb < 0:
                raise SystemExit("verify: --hbm_pin_gb must be >= 0")
            budget = int(gb * 1e9)
        residency_plan = plan_report(args.model_path, budget)
    if args.json:
        out: dict = {"reports": reports}
        if residency_plan is not None:
            out["residency_plan"] = residency_plan
        print(json.dumps(out))
    else:
        for r in reports:
            print(format_report(r))
        if residency_plan is not None:
            rp = residency_plan
            print(
                f"residency plan @ {rp['budget_gb']} GB: pins {rp['pinned_layers']}/"
                f"{rp['total_layers']} layers, {rp['pinned_bytes'] / 1e9:.3f} GB "
                f"({rp['pinned_fraction']:.1%} of streamed bytes) — saves "
                f"{rp['stream_bytes_saved_per_sweep'] / 1e9:.3f} GB of host->HBM traffic per sweep"
            )
            for entry in rp["pinned"]:
                print(f"  pin {entry['layer']}  {entry['bytes']} bytes")
    if not all(r["ok"] for r in reports):
        raise SystemExit(2)


def build_plan_precision_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m flexible_llm_sharding_tpu_torch plan-precision",
        description="Mixed-precision calibration: probe each layer's sensitivity on a "
                    "calibration batch (one layer at a time quantized against the bf16 oracle), "
                    "plan an int4/int8/bf16 dtype per layer under a bytes-per-pass budget OR a "
                    "divergence cap, and emit the PrecisionPlan (optionally writing the mixed "
                    "checkpoint).",
    )
    p.add_argument("--model_path", type=str, required=True,
                   help="FLOAT native per-layer checkpoint dir (quantized dirs are rejected)")
    p.add_argument("--calib_pickle", type=str, required=True,
                   help="calibration prompts pickle, the batch CLI's [(prefix, (suffixes...)), "
                        "...] format")
    p.add_argument("--calib_limit", type=int, default=8,
                   help="use at most this many calibration prompts (the probe runs one forward "
                        "per layer per candidate dtype)")
    p.add_argument("--bytes_budget_gb", type=float, default=None,
                   help="plan mode 1: fit the pass under this many GB of streamed weight bytes, "
                        "minimizing divergence")
    p.add_argument("--divergence_cap", type=float, default=None,
                   help="plan mode 2: minimize streamed bytes subject to this cap on "
                        "calibration next-token KL vs the bf16 oracle")
    p.add_argument("--out", type=str, default=None,
                   help="write the plan JSON here (default: print only)")
    p.add_argument("--apply", type=str, default=None,
                   help="also write the mixed checkpoint into this dir "
                        "(requantize_native(plan=...): the plan and the per-layer dtype "
                        "manifest are embedded)")
    p.add_argument("--json", action="store_true", help="emit the plan as JSON on stdout")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the probe's forwards run: cuda (default) or cpu")
    return p


def plan_precision_main(argv: list[str] | None = None, tokenizer=None):
    """The ``plan-precision`` subcommand; returns the plan."""
    args = build_plan_precision_parser().parse_args(argv)
    if (args.bytes_budget_gb is None) == (args.divergence_cap is None):
        raise SystemExit("plan-precision: give exactly one of --bytes_budget_gb / --divergence_cap")
    from flexible_llm_sharding_tpu_torch.runtime.precisionplan import build_plan
    from flexible_llm_sharding_tpu_torch.utils.checkpoint import requantize_native

    device = resolve_device(args.device)
    with open(args.calib_pickle, "rb") as f:
        prompts = pickle.load(f)
    prompts = prompts[: max(1, args.calib_limit)]
    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.model_path)
    plan = build_plan(
        args.model_path, prompts, tokenizer,
        bytes_budget=(int(args.bytes_budget_gb * 1e9) if args.bytes_budget_gb is not None
                      else None),
        divergence_cap=args.divergence_cap, device=device,
    )
    if args.out:
        plan.write(args.out)
    if args.json:
        print(json.dumps(plan.to_json()))
    else:
        counts = plan.counts()
        print(
            f"plan: {counts['bf16']} bf16 / {counts['int8']} int8 / {counts['int4']} int4 layers "
            f"— {plan.est_bytes / 1e9:.3f} GB/sweep vs {plan.baseline_bytes / 1e9:.3f} GB "
            f"uniform bf16 ({plan.bytes_saved_frac:.1%} saved); measured divergence "
            f"{plan.measured_divergence:.3e} (declared cap {plan.divergence_cap:.3e})"
        )
        for name, dt in plan.layers:
            print(f"  {dt:>5}  {name}")
    if args.apply:
        done = requantize_native(args.model_path, args.apply, plan=plan)
        print(f"materialized {len(done)} mixed-precision layers -> {args.apply}", file=sys.stderr)
    return plan


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
        decode_resident=args.decode_resident,
        decode_fused=args.decode_fused,
        speculative_k=args.speculative_k,
        hbm_pin_gb=args.hbm_pin_gb,
        score_sink_max_device=args.score_sink_max_device,
        resume=args.resume,
    )


def _updated_path(p: str) -> str:
    root, ext = os.path.splitext(p)
    return f"{root}_updated{ext or '.pkl'}"


# The KV decoder's mode flags and speculative counters, from its last call.
_DECODE_KEYS = ("decode_resident", "decode_fused", "decode_speculative", "decode_kv_on_device",
                "decode_graph", "spec_passes", "spec_drafted", "spec_accepted")
# Host-path and residency counters of the executor's stats, summed over
# its calls.
_SUMMED_HOST_KEYS = ("io_retries", "integrity_failures", "reread_heals", "quarantined_shards",
                     "recomputes", "host_cache_hits", "host_cache_misses", "crc_verdict_hits",
                     "crc_full_verifies", "pin_hits", "stream_bytes_saved")


def main(argv: list[str] | None = None, tokenizer=None) -> dict | None:
    """Run the batch CLI and return the stats it prints, or the ``verify``
    subcommand."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "verify":
        return verify_main(argv[1:])
    if argv and argv[0] == "plan-precision":
        plan_precision_main(argv[1:], tokenizer=tokenizer)
        return None
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
    stats.update({k: calls[-1][k] for k in _DECODE_KEYS if calls and k in calls[-1]})
    looked_up = stats.get("host_cache_hits", 0.0) + stats.get("host_cache_misses", 0.0)
    if looked_up:
        stats["host_cache_hit_rate"] = round(stats["host_cache_hits"] / looked_up, 4)
    # Each call's peak is floored at the pins it saw; pins only grow.
    for key in ("peak_mem_gb", "pinned_bytes"):
        seen = [c[key] for c in calls if key in c]
        if seen:
            stats[key] = max(seen)
    from flexible_llm_sharding_tpu_torch.runtime.residency import process_tier

    tier = process_tier()
    if tier is not None:
        stats["residency"] = tier.stats()
    rss = host_rss_gib()
    stats["peak_host_rss_gib"] = rss["peak"]
    if "rss" in rss:
        stats["host_rss_gib"] = rss["rss"]
    print(json.dumps(stats), file=sys.stderr)
    return stats


__all__ = ["build_parser", "build_plan_precision_parser", "build_verify_parser", "main",
           "plan_precision_main", "verify_main"]
