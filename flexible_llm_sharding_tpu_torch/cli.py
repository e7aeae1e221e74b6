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
card a CUDA run raises instead of falling back to the CPU. With several
cards (``--num_devices``, default all) the layers run as the interleaved MP
pipeline across them, or with ``--data_parallel true`` the prompts are split
over them, each card streaming the whole model from one shared read of each
shard; ``--tensor_parallel T`` splits every streamed layer Megatron-style
over T of them (with ``--data_parallel true``, over each group of T);
``--device cpu --num_devices N`` runs N CPU stages or ranks. By default, as in
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

``--long_context true`` scores (or, with ``--kv_cache``, decodes) every prompt
whose prefix is longer than ``--max_token_len`` exactly over the run's devices
as one sequence-parallel mesh, instead of truncating it: the cap becomes
``max_token_len`` times the device count (``--device cpu --num_devices N``
on the CPU), and the token count uses that cap. Prompts under the cap take
the paths above; ``--speculative_k`` is refused with it.

``--storage_location disk`` writes a progress marker after every shard
whose activations are on disk; ``--resume true`` restarts a crashed run of
the same workload at the first shard it left, and a spill that stays
corrupt is recomputed from the previous shard. ``--score_sink_max_device``
caps the prompts whose head scores wait on the card, their host copies in
flight.

``serve`` runs the serving engine (``serve/engine.py``) behind two
frontends: ``--prompt_pickle P --output_file O`` submits the pickle's
prompts as requests (``--stagger_ms`` apart) and writes the batch CLI's
files; without it, requests arrive as JSON lines on stdin
(``{"prefix", "suffixes", "max_new_tokens", "deadline_s", "slo_class",
"tenant_id", "adapter_id", "id"}``) and each completion or rejection is a
JSON line on stdout. ``--adapter_dir`` serves LoRA adapters by name (both
parsers accept it and ``--adapter_max_gb``, as the JAX CLI does);
``--wal_dir`` journals every request, replays the open ones at the top of
either frontend (a ``wal replay: ...`` line on stderr) and, on SIGTERM,
parks the requests in flight for the next start and exits 143.
``--replicas N`` (N > 1) or ``--autoscale`` serves through the replica
fleet (``serve/fleet.py``): N engines on the one device behind the
shard-phase router (``--router_*``), with elastic scaling and phase stagger
(``--autoscale*``); the final stats line is then the fleet's
(``"event": "fleet_stats"``).

Observability, on both parsers as in the JAX CLI: ``--trace`` records the
sweep timeline (exported at the end to ``--trace_out``, Chrome JSON or
``.jsonl``; ``trace-report --trace F`` analyzes it), ``--journal_dir`` keeps
the durable event journal, ``--incidents_dir`` captures incident bundles
(``incidents list|show|analyze``). The batch CLI adds ``--metrics_out``
(the metrics registry and the stats line as JSON), ``--profile_dir`` (a
``torch.profiler`` Chrome trace of the run, CUDA kernels included on a
card) and ``--verbose_metrics``; ``serve --metrics_port N`` serves
``/metrics`` (Prometheus text) and ``/metrics.json`` (0 = an ephemeral
port, printed on stderr).

Both parsers take the JAX CLI's ``--chaos*`` flags (deterministic fault
injection at ``--chaos_sites``, every site by default: ``faults/inject.py``)
and its ``--pressure*`` flags (the brownout ladder, ``runtime/pressure.py``:
under resource pressure the run sheds load instead of dying, and steps back
down when the pressure lifts). A JSONL reply to a shed request carries its
``retry_after_s``.

``prepare-adapter --peft_dir P --adapter_dir R --name N`` converts a PEFT
LoRA checkpoint into the registry layout.

``--use_pallas {auto,true,false}`` on both parsers (the JAX CLI's flag):
auto (the default) and true run the attention through the hand-written
CUDA kernels on the card, false through the plain attention ops, with no
kernel launched; on the CPU both run the plain ops (the kernels have no
interpret mode). Both parsers also take the JAX CLI's ``--kv_page_tokens``,
``--kv_pool_gb``, ``--kv_host_spill`` and ``--score_sink_max_device``; the
batch paths build no prefix-KV pool and the serving engine no score sink,
as in the JAX package.

``check`` runs the port's copy of the flscheck static analyzer
(``analysis/``) over the port, against its own baseline
``flscheck-torch-baseline.json``: exit 0 when clean, 1 on findings.

``verify`` audits a model directory (its precision plan included), a spill
directory and/or an adapter registry and exits 2 on any problem; ``verify --hbm_pin_gb N``
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

import torch

from flexible_llm_sharding_tpu_torch.config import (
    DEFAULT_MAX_TOKEN_LEN,
    DTYPES,
    FAULT_SITES,
    STORAGE_LOCATIONS,
    FrameworkConfig,
    resolve_device,
)
from flexible_llm_sharding_tpu_torch.utils.metrics import host_rss_gib, profiler_trace

# --- KNOB-SYNC declarations (checked by flscheck, analysis/rules.py). A
# FrameworkConfig/FaultConfig flag normally belongs in BOTH parsers; a flag
# listed here is deliberately single-parser, for the stated reason.
BATCH_ONLY_FLAGS = frozenset({
    # Workload shape of one offline batch run: serving has no fixed batch.
    "num_batch", "num_gen_token", "disk_folder", "max_activation_in_cpu",
    "resume", "long_context",
    # Multi-device layouts: the serving engine drives one device (it
    # refuses data_parallel and tensor_parallel, as the JAX engine does).
    "data_parallel", "num_devices", "tensor_parallel",
    # Sampling: serving is greedy-only (the engine refuses temperature > 0).
    "temperature", "top_k", "top_p", "seed",
    # KV-decode specials of the offline decoder. The serve parser's
    # --speculative_k sets ServeConfig.speculative_k, a distinct field
    # behind the same flag name; this covers the batch parser's
    # FrameworkConfig.speculative_k.
    "decode_fused", "speculative_k",
    # Offline observability and profiling of a single run.
    "verbose_metrics", "profile_dir",
})
SERVE_ONLY_FLAGS = frozenset()
# Flags that drive the run (inputs, outputs, demo pacing) and set no config
# field.
DRIVER_FLAGS = frozenset({
    "prompt_pickle", "output_file", "kv_cache",
    "stagger_ms",
    # One-shot metrics-registry JSON dump path (batch CLI output file).
    "metrics_out",
})


def _str2bool(v: str) -> bool:
    if v.lower() in ("true", "1", "yes", "y"):
        return True
    if v.lower() in ("false", "0", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def _use_pallas_arg(v: str) -> bool:
    """JAX's three spellings; auto is True, as nothing here resolves by platform."""
    return True if v.lower() == "auto" else _str2bool(v)


_USE_PALLAS_HELP = ("the hand-written CUDA attention kernels: 'auto' (default) and true launch "
                    "them on the card, false runs the plain attention ops and launches none; "
                    "on the CPU both run the plain ops")


def _float_or_auto(v: str) -> float | None:
    if v.lower() == "auto":
        return None
    return float(v)


def _add_adapter_flags(p: argparse.ArgumentParser) -> None:
    """Multi-tenant LoRA serving (the JAX CLI adds them to the batch and the
    serve parsers; the batch CLI keeps them in its config and serves no
    adapter)."""
    p.add_argument("--adapter_dir", type=str, default="",
                   help="registry root of named LoRA adapters, one subdir per adapter (per-layer "
                        "delta safetensors, adapter_plan.json and an integrity manifest; "
                        "prepare-adapter makes one from a PEFT checkpoint). Requests carrying an "
                        "adapter_id decode under that adapter's low-rank delta inside the shared "
                        "base-model sweep. Empty (default) = off: adapter_id requests fail typed")
    p.add_argument("--adapter_max_gb", type=_float_or_auto, default=None,
                   help="host LRU budget of adapter factors in GB: 'auto' (default) = 5%% of the "
                        "available RAM; 0 = adapter serving off even with --adapter_dir")


def _adapter_config_from_args(args: argparse.Namespace):
    from flexible_llm_sharding_tpu_torch.config import AdapterConfig

    return AdapterConfig(dir=args.adapter_dir, max_gb=args.adapter_max_gb)


def _add_chaos_flags(p: argparse.ArgumentParser) -> None:
    """Deterministic fault injection (the JAX parsers' flags, help and
    defaults)."""
    p.add_argument("--chaos", action="store_true",
                   help="enable deterministic fault injection at the named sites "
                        "(faults/inject.py) — proves the retry/degrade layer on real workloads "
                        "without waiting for real outages; off = zero overhead")
    p.add_argument("--chaos_seed", type=int, default=0,
                   help="injection schedule seed (same seed = same faults)")
    p.add_argument("--chaos_error_rate", type=float, default=0.1,
                   help="probability of an injected IOError per site fire")
    p.add_argument("--chaos_truncate_rate", type=float, default=0.0,
                   help="probability of an injected truncated read")
    p.add_argument("--chaos_latency_rate", type=float, default=0.0,
                   help="probability of an injected latency spike")
    p.add_argument("--chaos_sites", type=str, default="",
                   help=f"comma list of sites to inject at (default all): {','.join(FAULT_SITES)}")
    p.add_argument("--chaos_max_faults", type=int, default=-1,
                   help="total faults injected before the schedule goes permanently clean (-1 = "
                        "unlimited) — models a transient outage that ENDS; e.g. replica_kill "
                        "with a budget of 1 kills exactly one replica and lets the fleet prove "
                        "clean failover")


def _add_pressure_flags(p: argparse.ArgumentParser) -> None:
    """The brownout controller (``runtime/pressure.py``; the JAX parsers'
    flags, help and defaults)."""
    p.add_argument("--pressure", action="store_true",
                   help="enable the brownout controller: monitor host RAM, spill-disk space, "
                        "the card's headroom, and the host->device link; under sustained "
                        "pressure walk a reversible degradation ladder (shrink the host cache, "
                        "evict pooled prefix-KV pages, evict residency pins, shed admissions "
                        "with typed Overloaded rejections, drain fleet replicas) instead of "
                        "dying — and step back down when pressure lifts. Off = zero overhead")
    p.add_argument("--pressure_poll_s", type=float, default=1.0,
                   help="pressure-monitor sampling interval (seconds)")
    p.add_argument("--pressure_host_min_gb", type=float, default=1.0,
                   help="MemAvailable floor in GB; below it the ladder steps up (0 = host "
                        "signal off)")
    p.add_argument("--pressure_disk_min_gb", type=float, default=1.0,
                   help="spill-disk (--disk_folder filesystem) free-bytes floor in GB (0 = disk "
                        "signal off)")
    p.add_argument("--pressure_hbm_headroom_frac", type=float, default=0.05,
                   help="the card's free share floor: 1 - allocated / total memory (0 = off)")
    p.add_argument("--pressure_link_min_gbps", type=float, default=0.0,
                   help="host->device streamed-bytes rate floor in GB/s while streaming (0 = "
                        "link signal off)")
    p.add_argument("--pressure_cache_shrink_frac", type=float, default=0.5,
                   help="host shard cache (and adapter store) budget multiplier of the ladder's "
                        "shrink levels (LRU-evicts down to this fraction)")
    p.add_argument("--pressure_shed_retry_after_s", type=float, default=1.0,
                   help="retry-after hint carried by Overloaded rejections while shedding")
    p.add_argument("--pressure_step_down_polls", type=int, default=3,
                   help="consecutive clean polls required per ladder step DOWN (hysteresis "
                        "against flapping)")


def _add_observability_flags(p: argparse.ArgumentParser) -> None:
    """Both parsers: sweep-timeline tracing and the flight recorder (the
    JAX CLI's flags and defaults)."""
    p.add_argument("--trace", action="store_true",
                   help="record the sweep timeline (shard loads, uploads, compute, source "
                        "waits, cache hits, pin loads, retry and heal events, the serve wave "
                        "lifecycle) into a bounded ring, exported at the end to --trace_out; "
                        "analyze with `trace-report` or load in Perfetto. Off = one bool read "
                        "per emit and its scalar arguments (attributes that walk a wave or "
                        "an array are built only when on)")
    p.add_argument("--trace_out", type=str, default="",
                   help="trace export path (default fls_trace.json): Chrome trace-event JSON, "
                        "or JSONL when the path ends in .jsonl")
    p.add_argument("--journal_dir", type=str, default="",
                   help="durable append-only JSONL event journal: every failure-path event "
                        "(recoveries, wave aborts, replica death, drain and re-dispatch, "
                        "quarantines, heals, pressure steps, watchdog stalls, preemptions, SLO "
                        "budget exhaustion) with a monotonic seq and correlation ids. Rotates "
                        "at --journal_max_mb; a write failure is a counted drop "
                        "(fls_journal_events_dropped), never an error. Empty = off")
    p.add_argument("--journal_max_mb", type=float, default=16.0,
                   help="journal rotation size in MB (one previous generation is kept)")
    p.add_argument("--incidents_dir", type=str, default="",
                   help="arm the incident recorder: a journal event at or above "
                        "--incident_trigger captures a bundle directory here (journal tail, "
                        "metrics snapshot, trace ring as Chrome JSON, resolved config, "
                        "manifest), debounced so a failure storm yields one bundle, the "
                        "directory budgeted at --incidents_max_mb. Inspect with `incidents "
                        "list/show/analyze`. Empty = off")
    p.add_argument("--incidents_max_mb", type=float, default=256.0,
                   help="incidents directory budget in MB (oldest bundles evicted; the newest "
                        "always survives)")
    p.add_argument("--incident_trigger", type=str, default="error",
                   choices=("info", "warning", "error", "critical"),
                   help="minimum journal-event severity that captures an incident bundle")
    p.add_argument("--incident_debounce_s", type=float, default=60.0,
                   help="after a capture, trigger events within this window only count "
                        "(fls_journal_debounces)")
    p.add_argument("--incident_settle_s", type=float, default=1.0,
                   help="a capture waits this long after its trigger (extended while trigger "
                        "events keep landing, bounded) so the whole storm lands in its journal "
                        "tail; 0 = capture at once")


def _write_trace(cfg: FrameworkConfig) -> None:
    """Export the process tracer at the end of a run (the run that died is
    the one whose timeline is needed)."""
    if cfg.trace:
        from flexible_llm_sharding_tpu_torch.obs import trace as obs_trace

        path = obs_trace.write_configured()
        if path:
            print(f"trace written -> {path} (analyze: `trace-report --trace {path}`, or load "
                  "in Perfetto)", file=sys.stderr)


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
                   help="True: split the prompts across the devices, each streaming the whole "
                        "model from one shared read of each shard; False: the interleaved layer "
                        "pipeline across the devices")
    p.add_argument("--disk_folder", type=str, default="./temp")
    p.add_argument("--num_gen_token", type=int, default=1)
    p.add_argument("--dtype", type=str, default="bfloat16", choices=tuple(DTYPES))
    p.add_argument("--kv_cache", type=_str2bool, default=False,
                   help="generate with a KV cache (token-id append semantics)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--num_devices", type=int, default=0,
                   help="0 = every visible card; on the CPU, that many CPU stages or ranks")
    p.add_argument("--temperature", type=float, default=0.0, help="0 = greedy")
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--block_size", type=int, default=8)
    p.add_argument("--max_token_len", type=int, default=DEFAULT_MAX_TOKEN_LEN)
    p.add_argument("--use_pallas", type=_use_pallas_arg, default=True, help=_USE_PALLAS_HELP)
    p.add_argument("--bucket_multiple", type=int, default=64)
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="shard every streamed layer's matmuls over this many "
                        "chips (Megatron layout over ICI); cuts per-chip "
                        "weight HBM by the factor. 1 = off")
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
    p.add_argument("--kv_page_tokens", type=int, default=16,
                   help="rows per page of the serving engine's paged prefix-KV pool; <= 0 "
                        "disables the pool (accepted here as in the JAX batch CLI, which "
                        "builds no pool)")
    p.add_argument("--kv_pool_gb", type=_float_or_auto, default=None,
                   help="host-RAM budget in GB of the serving engine's prefix-KV pool "
                        "('auto' default; 0 = off)")
    p.add_argument("--kv_host_spill", type=_str2bool, default=True,
                   help="whether cold prefix-KV pool pages spill to checksummed files or drop")
    p.add_argument("--resume", type=_str2bool, default=False,
                   help="disk mode: resume a crashed run of the same workload from the last "
                        "completed shard")
    p.add_argument("--long_context", type=_str2bool, default=False,
                   help="score prefixes longer than max_token_len exactly "
                        "via sequence parallelism (cap becomes "
                        "n_chips * max_token_len) instead of truncating")
    p.add_argument("--speculative_k", type=int, default=0,
                   help="kv_cache mode: verify this many prompt-lookup drafted tokens per "
                        "streamed pass (greedy-exact; divides weight streams per token by the "
                        "acceptance factor when the model must re-stream); 0 = off")
    p.add_argument("--verbose_metrics", type=_str2bool, default=False,
                   help="emit one JSON line per structured timing event")
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler Chrome trace of the run here (CPU and, on a "
                        "card, CUDA activity: kernels, copies)")
    p.add_argument("--metrics_out", type=str, default="",
                   help="write a one-shot JSON dump of the metrics registry (executor, stream, "
                        "cache, residency, integrity, tracer, journal) and the final stats line "
                        "to this path at the end")
    _add_adapter_flags(p)
    _add_chaos_flags(p)
    _add_pressure_flags(p)
    _add_observability_flags(p)
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
    p.add_argument("--adapter_dir", type=str, default=None,
                   help="LoRA adapter registry root to audit: every adapter's delta files "
                        "against its integrity manifest and its plan (adapter_mismatch, "
                        "plan_missing_file, corrupt_plan, ...)")
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
    if not args.model_path and not args.spill_dir and not args.adapter_dir:
        raise SystemExit("verify: give --model_path, --spill_dir and/or --adapter_dir")
    if args.hbm_pin_gb is not None and not args.model_path:
        raise SystemExit("verify: --hbm_pin_gb requires --model_path")
    from flexible_llm_sharding_tpu_torch.integrity.verify import (
        format_report,
        verify_adapter_dir,
        verify_model_dir,
        verify_spill_dir,
    )

    reports = []
    if args.model_path:
        reports.append(verify_model_dir(args.model_path))
    if args.spill_dir:
        reports.append(verify_spill_dir(args.spill_dir))
    if args.adapter_dir:
        reports.append(verify_adapter_dir(args.adapter_dir))
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


def build_prepare_adapter_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m flexible_llm_sharding_tpu_torch prepare-adapter",
        description="Convert a Hugging Face PEFT LoRA checkpoint dir (adapter_config.json + "
                    "adapter_model.safetensors) into the serving registry layout under "
                    "--adapter_dir: per-decoder-layer delta safetensors, an adapter_plan.json "
                    "and an integrity manifest. Each module's lora_alpha/r is folded into the "
                    "stored B factors (apply scale 1.0); square target modules only.",
    )
    p.add_argument("--peft_dir", type=str, required=True,
                   help="PEFT checkpoint dir to convert (adapter_model.safetensors; .bin "
                        "checkpoints are refused)")
    p.add_argument("--adapter_dir", type=str, required=True,
                   help="registry root to write into; the adapter lands at <adapter_dir>/<name>")
    p.add_argument("--name", type=str, required=True,
                   help="adapter name: the adapter_id serving requests carry")
    p.add_argument("--json", action="store_true", help="print the written plan as JSON")
    return p


def prepare_adapter_main(argv: list[str] | None = None) -> None:
    """The ``prepare-adapter`` subcommand."""
    args = build_prepare_adapter_parser().parse_args(argv)
    from flexible_llm_sharding_tpu_torch.adapters.registry import (
        AdapterPlan,
        convert_peft_checkpoint,
    )

    try:
        adir = convert_peft_checkpoint(args.peft_dir, args.adapter_dir, args.name)
    except ValueError as e:
        raise SystemExit(f"prepare-adapter: {e}") from e
    plan = AdapterPlan.load(adir)
    if args.json:
        print(json.dumps(plan.to_json()))
        return
    ranks = plan.ranks
    print(f"adapter {plan.name!r} -> {adir}: {len(plan.layers)} layers, rank {plan.rank} "
          f"(alpha {plan.alpha:g}, scale {plan.scale:g}), hidden {plan.hidden_size}, "
          f"{plan.nbytes() / 1e6:.2f} MB of deltas")
    for lname, _ in plan.layers:
        print(f"  r={ranks[lname]:<3d} {lname}")
    print(f"serve with: --adapter_dir {args.adapter_dir} ; requests carry "
          f'{{"adapter_id": "{plan.name}"}}')


def build_incidents_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m flexible_llm_sharding_tpu_torch incidents",
        description="Inspect flight-recorder incident bundles (--incidents_dir): list the "
                    "bundles in a directory, show one bundle's manifest, or analyze one into a "
                    "timeline (journal events, correlation ids and the embedded trace's "
                    "report).",
    )
    p.add_argument("action", choices=("list", "show", "analyze"),
                   help="list bundles in --dir; show one bundle's manifest; analyze one bundle "
                        "into a timeline")
    p.add_argument("bundle", nargs="?", default=None, help="bundle directory (show/analyze)")
    p.add_argument("--dir", type=str, default="incidents",
                   help="incidents directory to list (default: ./incidents)")
    p.add_argument("--json", action="store_true",
                   help="emit the structured report as JSON on stdout")
    return p


def incidents_main(argv: list[str] | None = None) -> None:
    """The ``incidents`` subcommand (the JAX CLI's, output for output)."""
    args = build_incidents_parser().parse_args(argv)
    from flexible_llm_sharding_tpu_torch.obs.report import (
        analyze_bundle,
        format_incident,
        journal_tail_len,
        load_manifest,
    )

    if args.action == "list":
        try:
            names = sorted(os.listdir(args.dir))
        except OSError as e:
            raise SystemExit(f"incidents: cannot list {args.dir}: {e}") from e
        rows = []
        for name in names:
            path = os.path.join(args.dir, name)
            if not name.startswith("incident-") or not os.path.isdir(path):
                continue
            try:
                # The manifest and the tail's line count only: a listing
                # must not parse every bundle's trace.
                manifest = load_manifest(path)
            except ValueError:
                continue  # a half-written or foreign directory
            trig = manifest.get("trigger", {})
            rows.append({"bundle": name, "captured_at": manifest.get("captured_at"),
                         "trigger": trig.get("kind"), "severity": trig.get("severity"),
                         "journal_events": journal_tail_len(path)})
        if args.json:
            print(json.dumps(rows))
        elif not rows:
            print(f"no incident bundles under {args.dir}")
        else:
            for r in rows:
                print(f"{r['bundle']}  {r['captured_at']}  trigger={r['trigger']} "
                      f"({r['severity']})  journal_events={r['journal_events']}")
        return
    if not args.bundle:
        raise SystemExit(f"incidents {args.action}: give a bundle dir")
    try:
        if args.action == "show":
            print(json.dumps(load_manifest(args.bundle), indent=None if args.json else 1))
            return
        report = analyze_bundle(args.bundle)
    except ValueError as e:
        raise SystemExit(f"incidents: {e}") from e
    print(json.dumps(report) if args.json else format_incident(report))


def _add_fleet_flags(p: argparse.ArgumentParser) -> None:
    """The replica fleet and its router (the JAX serve parser's flags and
    defaults)."""
    p.add_argument("--replicas", type=int, default=1,
                   help="serving engine replicas (thread-per-engine, one process, one device, "
                        "shared host shard cache). >1 runs the replica fleet: requests route to "
                        "the healthiest replica by shard-phase proximity + queue depth, and a "
                        "dead replica's queued/in-flight requests re-dispatch to a survivor "
                        "exactly once, token-identically")
    p.add_argument("--router_phase_weight", type=float, default=1.0,
                   help="router score weight on sweep-phase proximity (fraction of a sweep "
                        "until the replica's next shard-0 admission point)")
    p.add_argument("--router_depth_weight", type=float, default=1.0,
                   help="router score weight on normalized queue depth ((queued + active) / "
                        "max_active_requests)")
    p.add_argument("--router_health_poll_s", type=float, default=0.2,
                   help="fleet health-monitor poll interval: each tick reads every replica's "
                        "engine-fatal error, recoveries and sweep liveness watermark (a busy "
                        "replica stalled past --watchdog_abort_s is hard-failed)")
    p.add_argument("--router_drain_recoveries", type=int, default=0,
                   help="gracefully drain + recycle a replica whose engine_recoveries counter "
                        "reaches this (a flaky-but-alive engine); 0 = off")


def _add_autoscale_flags(p: argparse.ArgumentParser) -> None:
    """The fleet's autoscaler and phase stagger (the JAX serve parser's
    flags and defaults)."""
    p.add_argument("--autoscale", action="store_true",
                   help="enable the fleet autoscaler: a control loop polls SLO burn rate and "
                        "queue depth and grows/drains the replica fleet between "
                        "--autoscale_min/max with anti-flap hysteresis (consecutive-poll "
                        "confirmation, per-direction cooldowns) and interlocks (never shrink "
                        "below min or over an in-flight drain; WAL replay completes first). Also "
                        "engages the sweep-phase stagger controller (replica offsets held at i/N "
                        "so worst-case admission wait is sweep/N)")
    p.add_argument("--autoscale_min", type=int, default=1,
                   help="fleet size floor the controller may drain to")
    p.add_argument("--autoscale_max", type=int, default=4,
                   help="fleet size ceiling the controller may grow to")
    p.add_argument("--autoscale_poll_s", type=float, default=1.0,
                   help="controller poll interval in seconds")
    p.add_argument("--autoscale_grow_burn_rate", type=float, default=1.0,
                   help="grow when the worst per-class SLO burn rate sustains at or above this")
    p.add_argument("--autoscale_grow_queue_frac", type=float, default=0.75,
                   help="grow when queue depth / capacity sustains at or above this fraction")
    p.add_argument("--autoscale_shrink_burn_rate", type=float, default=0.25,
                   help="shrink only when burn rate AND queue fraction are both below their "
                        "shrink thresholds (must be <= the grow threshold)")
    p.add_argument("--autoscale_shrink_queue_frac", type=float, default=0.10,
                   help="queue-fraction half of the shrink band (must be <= the grow fraction)")
    p.add_argument("--autoscale_confirm_polls", type=int, default=3,
                   help="a breach must persist this many consecutive polls before the "
                        "controller acts")
    p.add_argument("--autoscale_grow_cooldown_s", type=float, default=10.0,
                   help="after any scale action, grow again only after this many seconds")
    p.add_argument("--autoscale_shrink_cooldown_s", type=float, default=30.0,
                   help="after any scale action, shrink only after this many seconds")
    p.add_argument("--autoscale_dry_run", action="store_true",
                   help="decide and count every decision without acting")
    p.add_argument("--autoscale_no_stagger", action="store_true",
                   help="disable the sweep-phase stagger controller")
    p.add_argument("--autoscale_stagger_tolerance", type=float, default=0.15,
                   help="normalized stagger error at or under this counts as converged "
                        "(0 = perfect i/N spread, 1 = all replicas in phase)")
    p.add_argument("--autoscale_stagger_hold_max_frac", type=float, default=0.5,
                   help="cap on a single boundary hold as a fraction of one measured sweep wall")


def _autoscale_config_from_args(args: argparse.Namespace):
    from flexible_llm_sharding_tpu_torch.config import AutoscaleConfig

    if not args.autoscale:
        return AutoscaleConfig()
    return AutoscaleConfig(
        enabled=True, min=args.autoscale_min, max=args.autoscale_max,
        poll_s=args.autoscale_poll_s, grow_burn_rate=args.autoscale_grow_burn_rate,
        grow_queue_frac=args.autoscale_grow_queue_frac,
        shrink_burn_rate=args.autoscale_shrink_burn_rate,
        shrink_queue_frac=args.autoscale_shrink_queue_frac,
        confirm_polls=args.autoscale_confirm_polls,
        grow_cooldown_s=args.autoscale_grow_cooldown_s,
        shrink_cooldown_s=args.autoscale_shrink_cooldown_s, dry_run=args.autoscale_dry_run,
        stagger=not args.autoscale_no_stagger,
        stagger_tolerance=args.autoscale_stagger_tolerance,
        stagger_hold_max_frac=args.autoscale_stagger_hold_max_frac,
    )


def _pressure_config_from_args(args: argparse.Namespace):
    from flexible_llm_sharding_tpu_torch.config import PressureConfig

    if not args.pressure:
        return PressureConfig()
    return PressureConfig(
        enabled=True, poll_s=args.pressure_poll_s, host_min_gb=args.pressure_host_min_gb,
        disk_min_gb=args.pressure_disk_min_gb,
        hbm_headroom_frac=args.pressure_hbm_headroom_frac,
        link_min_gbps=args.pressure_link_min_gbps,
        cache_shrink_frac=args.pressure_cache_shrink_frac,
        shed_retry_after_s=args.pressure_shed_retry_after_s,
        step_down_polls=args.pressure_step_down_polls,
    )


def _fault_config_from_args(args: argparse.Namespace):
    from flexible_llm_sharding_tpu_torch.config import FaultConfig

    if not args.chaos:
        return FaultConfig()
    return FaultConfig(
        enabled=True, seed=args.chaos_seed, error_rate=args.chaos_error_rate,
        truncate_rate=args.chaos_truncate_rate, latency_rate=args.chaos_latency_rate,
        sites=tuple(x for x in args.chaos_sites.split(",") if x),
        max_faults=args.chaos_max_faults,
    )


def _serve_wants_fleet(serve_cfg) -> bool:
    """Serve through the replica fleet: more than one replica, or the
    autoscaler (it lives in the fleet, and one replica that grows under load
    is its canonical start)."""
    return serve_cfg.replicas > 1 or serve_cfg.autoscale.enabled


def _add_spec_flags(p: argparse.ArgumentParser) -> None:
    """Speculative serving (the JAX serve parser's flags and defaults)."""
    p.add_argument("--speculative_k", type=int, default=0,
                   help="speculative decoding on the serving path: each in-flight request drafts "
                        "this many prompt-lookup tokens per sweep and the engine verifies all "
                        "drafts batch-wide inside the SAME weight sweep (K+1-slot verify pass); "
                        "output stays token-identical to 0 (greedy-exact verification); 0 = off")
    p.add_argument("--draft_model_path", type=str, default="",
                   help="resident draft model: checkpoint dir of a SMALL model pinned whole on "
                        "the card through its own residency tier and used as the speculative "
                        "draft source instead of prompt lookup, adding ZERO bytes to the "
                        "per-sweep weight stream; '' = off (prompt-lookup drafts)")
    p.add_argument("--spec_adaptive", action="store_true",
                   help="SLO-aware adaptive draft depth: per-class k follows windowed live "
                        "acceptance between --spec_k_min and --spec_k_max and funds interactive "
                        "rows first under --spec_draft_budget; requires --speculative_k >= 1 "
                        "(starting k)")
    p.add_argument("--spec_k_min", type=int, default=0,
                   help="adaptive-k lower bound (0 lets a class stop drafting entirely when "
                        "drafts keep missing)")
    p.add_argument("--spec_k_max", type=int, default=8,
                   help="adaptive-k upper bound; the verify slot budget is provisioned at this k "
                        "so k can grow mid-wave")
    p.add_argument("--spec_window", type=int, default=8,
                   help="acceptance window: a class's k moves only after this many observed "
                        "drafting passes")
    p.add_argument("--spec_raise_threshold", type=float, default=0.6,
                   help="raise a class's k when its windowed acceptance reaches this")
    p.add_argument("--spec_backoff_threshold", type=float, default=0.2,
                   help="shrink a class's k when its windowed acceptance falls to this or below")
    p.add_argument("--spec_draft_budget", type=int, default=0,
                   help="per-pass draft-token budget across the wave, spent in strict SLO-class "
                        "priority order (interactive first); 0 = unlimited")


def _add_sched_flags(p: argparse.ArgumentParser) -> None:
    """The sweep scheduler (the JAX serve parser's flags and defaults)."""
    p.add_argument("--sched", action="store_true",
                   help="enable the multi-tenant sweep scheduler: strict SLO-class priority "
                        "(interactive > standard > best_effort) with deficit-weighted "
                        "round-robin across tenants inside a class, per-tenant token-bucket rate "
                        "limits (typed RateLimited with a retry-after hint), sweep-boundary "
                        "preemption of best-effort waves by waiting interactive work (resumed "
                        "token-identically), and same-prefix request coalescing into one shared "
                        "prefill. Off = the plain FIFO admission path")
    p.add_argument("--sched_interactive_deadline_s", type=float, default=0.0,
                   help="default admission deadline for interactive requests that name none "
                        "(0 = fall back to --deadline_s)")
    p.add_argument("--sched_standard_deadline_s", type=float, default=0.0,
                   help="default admission deadline for standard requests (0 = fall back to "
                        "--deadline_s)")
    p.add_argument("--sched_best_effort_deadline_s", type=float, default=0.0,
                   help="default admission deadline for best_effort requests (0 = fall back to "
                        "--deadline_s)")
    p.add_argument("--sched_tenant_weights", type=str, default="",
                   help="deficit-round-robin weights, 'tenantA=4,tenantB=1' (unlisted tenants "
                        "weigh 1): a weight-w tenant gets ~w shares of each class's admission "
                        "budget while backlogged")
    p.add_argument("--sched_tenant_limits", type=str, default="",
                   help="token-bucket rate limits in requests/second, 'tenantA=5' (unlisted = "
                        "unlimited); over-limit submits resolve as typed RateLimited carrying "
                        "retry_after_s")
    p.add_argument("--sched_tenant_burst", type=float, default=4.0,
                   help="token-bucket capacity (burst requests) for every rate-limited tenant")
    p.add_argument("--sched_preempt", type=_str2bool, default=True,
                   help="allow a waiting interactive request to retire the youngest best-effort "
                        "wave at a shard-0 boundary (never mid-sweep); the preempted requests "
                        "resume token-identically with their generated-so-far tokens folded "
                        "into the prefill")
    p.add_argument("--sched_coalesce", type=_str2bool, default=True,
                   help="merge same-tokenized-prefix requests admitted at one boundary into a "
                        "single wave entry that prefills the shared prefix KV once")
    p.add_argument("--sched_interactive_phase_boost", type=float, default=2.0,
                   help="fleet routing: multiply the router's phase weight by this for "
                        "interactive requests, so they land on the replica nearest its next "
                        "shard-0 admission point (1 = no boost)")


def _sched_config_from_args(args: argparse.Namespace):
    from flexible_llm_sharding_tpu_torch.config import SchedConfig

    if not args.sched:
        return SchedConfig()
    return SchedConfig(
        enabled=True, interactive_deadline_s=args.sched_interactive_deadline_s,
        standard_deadline_s=args.sched_standard_deadline_s,
        best_effort_deadline_s=args.sched_best_effort_deadline_s,
        tenant_weights=args.sched_tenant_weights, tenant_limits=args.sched_tenant_limits,
        tenant_burst=args.sched_tenant_burst, preempt=args.sched_preempt,
        coalesce=args.sched_coalesce, interactive_phase_boost=args.sched_interactive_phase_boost,
    )


def build_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m flexible_llm_sharding_tpu_torch serve",
        description="Online serving: shard-aware continuous batching over the streaming "
                    "runtime. Requests join at shard-0 boundaries of the weight sweep; in-flight "
                    "requests are never prefilled again.",
    )
    p.add_argument("--model_path", type=str, default="./")
    p.add_argument("--dtype", type=str, default="bfloat16", choices=tuple(DTYPES))
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--layer_num_per_shard", type=int, default=1)
    p.add_argument("--storage_location", type=str, default="cpu", choices=STORAGE_LOCATIONS,
                   help="'gpu' keeps every wave's KV on the card; 'cpu' follows the weights "
                        "(on the card when they are resident and the KV fits, else host RAM)")
    p.add_argument("--block_size", type=int, default=8)
    p.add_argument("--bucket_multiple", type=int, default=64)
    p.add_argument("--prefetch_depth", type=int, default=1,
                   help="shards read and uploaded ahead of compute; 0 = serialized")
    p.add_argument("--max_token_len", type=int, default=DEFAULT_MAX_TOKEN_LEN)
    p.add_argument("--use_pallas", type=_use_pallas_arg, default=True, help=_USE_PALLAS_HELP)
    p.add_argument("--decode_resident", type=str, default="auto", choices=("auto", "on", "off"),
                   help="keep the model on the card across sweeps when it fits (auto judges "
                        "against the card's memory); off streams the weights every sweep "
                        "through a cycling source")
    p.add_argument("--queue_capacity", type=int, default=64,
                   help="admission queue bound; submissions beyond it are rejected with a "
                        "reason (backpressure)")
    p.add_argument("--max_wave_requests", type=int, default=8,
                   help="requests admitted into one wave at a shard-0 boundary")
    p.add_argument("--max_active_requests", type=int, default=32,
                   help="in-flight requests across all waves")
    p.add_argument("--max_new_tokens", type=int, default=16,
                   help="per-request token budget (JSONL requests may carry their own)")
    p.add_argument("--deadline_s", type=float, default=0.0,
                   help="admission deadline: a request not admitted within this many seconds "
                        "expires (0 = none)")
    p.add_argument("--stats_interval_s", type=float, default=10.0,
                   help="periodic serve-stats JSON line on stderr (0 = off)")
    p.add_argument("--watchdog_abort_s", type=float, default=600.0,
                   help="streamed weights: abort and recover a sweep that lands no shard for "
                        "this long; its requests fail with WaveAborted (0 = off)")
    p.add_argument("--max_request_tokens", type=int, default=0,
                   help="admission-side size cap: estimated prompt tokens (longest suffix "
                        "included) + max_new_tokens above this are rejected at submit "
                        "(RequestTooLarge); 0 = off")
    p.add_argument("--io_retry_attempts", type=int, default=4,
                   help="attempts per layer read before a typed ShardLoadError; 1 = no retry")
    p.add_argument("--io_retry_base_s", type=float, default=0.05,
                   help="first retry backoff; doubles per attempt (jittered)")
    p.add_argument("--io_retry_deadline_s", type=float, default=60.0,
                   help="overall wall cap per retried read (0 = none)")
    p.add_argument("--verify_weights", type=_str2bool, default=True,
                   help="crc-verify every layer load against integrity.json, once per file "
                        "generation per process")
    p.add_argument("--host_cache_gb", type=_float_or_auto, default=None,
                   help="process host shard cache budget in GB ('auto' default; 0 = off): "
                        "streamed sweeps after the first skip the disk read and the crc")
    p.add_argument("--hbm_pin_gb", type=_float_or_auto, default=0.0,
                   help="device residency tier budget in GB for a streamed engine ('auto' = "
                        "the card's free memory minus headroom; 0 = off, the default)")
    p.add_argument("--kv_page_tokens", type=int, default=16,
                   help="rows per page of the paged prefix-KV pool, the sharing granularity; "
                        "<= 0 disables the pool")
    p.add_argument("--kv_pool_gb", type=_float_or_auto, default=None,
                   help="host-RAM budget in GB of the prefix-KV pool: a recurring prefix "
                        "prefills once per process and later waves run only the suffix half of "
                        "each layer over its pages. 'auto' (default) = 5%% of the available RAM, "
                        "at most 4 GB; 0 = off")
    p.add_argument("--kv_host_spill", type=_str2bool, default=True,
                   help="true: cold pool pages spill to checksummed files that heal on read; "
                        "false: they drop and the prefix prefills again")
    p.add_argument("--readahead_threads", type=int, default=2,
                   help="threads of the page-cache readahead pool; 0 = off")
    p.add_argument("--score_sink_max_device", type=int, default=16,
                   help="the batch paths' score sink cap (accepted here as in the JAX serve "
                        "CLI; the engine builds no sink)")
    _add_fleet_flags(p)
    _add_chaos_flags(p)
    _add_pressure_flags(p)
    _add_spec_flags(p)
    _add_sched_flags(p)
    p.add_argument("--slo", action="store_true",
                   help="track SLO error budgets over the per-class latency windows (the "
                        "'slo' entry of the stats line)")
    p.add_argument("--slo_ttft_p95_s", type=str, default="",
                   help="per-class p95 TTFT targets in seconds, 'interactive=0.5,standard=2.0'")
    p.add_argument("--slo_token_latency_p95_s", type=float, default=0.0,
                   help="per-token decode latency p95 target in seconds (0 = off)")
    p.add_argument("--slo_availability_target", type=float, default=0.0,
                   help="fraction of requests that must complete, e.g. 0.999 (0 = off)")
    p.add_argument("--slo_min_samples", type=int, default=20,
                   help="budgets are not judged below this many samples")
    _add_adapter_flags(p)
    p.add_argument("--wal_dir", type=str, default="",
                   help="crash-safe serving: directory of the durable request WAL. Every "
                        "admission, sweep-boundary progress and terminal outcome is journaled; "
                        "the next start replays every still-open request before new traffic, "
                        "and SIGTERM parks the requests in flight for it; '' = off")
    p.add_argument("--wal_fsync", type=str, default="admit", choices=["always", "admit", "never"],
                   help="'always' fsyncs every record, 'admit' (default) the admission and "
                        "terminal records, 'never' none (every record is still flushed to the "
                        "kernel)")
    p.add_argument("--wal_max_mb", type=float, default=64.0,
                   help="WAL segment rotation size; sealed segments whose every request is "
                        "terminal are deleted")
    _add_autoscale_flags(p)
    p.add_argument("--metrics_port", type=int, default=None,
                   help="serve a Prometheus /metrics endpoint (and /metrics.json) on 127.0.0.1 "
                        "at this port: queue depth, TTFT quantiles, streamed bytes, cache hit "
                        "rate, residency savings, retry, heal and recovery counters in one "
                        "scrape; 0 = an ephemeral port, omit = off")
    _add_observability_flags(p)
    p.add_argument("--prompt_pickle", type=str, default=None,
                   help="demo mode: submit this prompt pickle's entries as requests, then write "
                        "--output_file like the batch CLI")
    p.add_argument("--output_file", type=str, default=None)
    p.add_argument("--stagger_ms", type=float, default=0.0,
                   help="demo mode: delay between submissions, so later requests join waves "
                        "already in flight")
    return p


def serve_main(argv: list[str] | None = None, tokenizer=None) -> dict:
    """The ``serve`` subcommand: the demo or the JSONL frontend over one
    engine, or over the replica fleet (``--replicas`` > 1 or
    ``--autoscale``). Prints the engine's or the fleet's stats as a JSON line
    on stderr at the end and returns them, with the run's wall, tokens served
    per second (``tokens_served``: resolved requests only) and the card's
    peak memory (demo mode adds the queue depth right after the last
    submission; the fleet's line adds the host RSS)."""
    args = build_serve_parser().parse_args(argv)
    if args.prompt_pickle and not args.output_file:
        raise SystemExit("--prompt_pickle (demo mode) requires --output_file")
    from flexible_llm_sharding_tpu_torch.config import ServeConfig, SLOConfig

    try:
        cfg = FrameworkConfig(
            model_path=args.model_path, layer_num_per_shard=args.layer_num_per_shard,
            storage_location=args.storage_location, dtype=args.dtype, block_size=args.block_size,
            bucket_multiple=args.bucket_multiple, prefetch_depth=args.prefetch_depth,
            max_token_len=args.max_token_len, decode_resident=args.decode_resident,
            device=args.device, io_retry_attempts=args.io_retry_attempts,
            io_retry_base_s=args.io_retry_base_s, io_retry_deadline_s=args.io_retry_deadline_s,
            verify_weights=args.verify_weights, host_cache_gb=args.host_cache_gb,
            kv_page_tokens=args.kv_page_tokens, kv_pool_gb=args.kv_pool_gb,
            kv_host_spill=args.kv_host_spill, hbm_pin_gb=args.hbm_pin_gb,
            readahead_threads=args.readahead_threads,
            score_sink_max_device=args.score_sink_max_device, use_pallas=args.use_pallas,
            trace=args.trace, trace_out=args.trace_out, journal_dir=args.journal_dir,
            journal_max_mb=args.journal_max_mb, incidents_dir=args.incidents_dir,
            incidents_max_mb=args.incidents_max_mb, incident_trigger=args.incident_trigger,
            incident_debounce_s=args.incident_debounce_s,
            incident_settle_s=args.incident_settle_s,
            adapters=_adapter_config_from_args(args), faults=_fault_config_from_args(args),
            pressure=_pressure_config_from_args(args),
        )
        slo = SLOConfig() if not args.slo else SLOConfig(
            enabled=True, ttft_p95_s=args.slo_ttft_p95_s,
            token_latency_p95_s=args.slo_token_latency_p95_s,
            availability_target=args.slo_availability_target, min_samples=args.slo_min_samples)
        serve_cfg = ServeConfig(
            queue_capacity=args.queue_capacity, max_wave_requests=args.max_wave_requests,
            max_active_requests=args.max_active_requests,
            default_max_new_tokens=args.max_new_tokens, default_deadline_s=args.deadline_s,
            stats_interval_s=args.stats_interval_s, watchdog_abort_s=args.watchdog_abort_s,
            max_request_tokens=args.max_request_tokens, speculative_k=args.speculative_k,
            draft_model_path=args.draft_model_path, spec_adaptive=args.spec_adaptive,
            spec_k_min=args.spec_k_min, spec_k_max=args.spec_k_max, spec_window=args.spec_window,
            spec_raise_threshold=args.spec_raise_threshold,
            spec_backoff_threshold=args.spec_backoff_threshold,
            spec_draft_budget=args.spec_draft_budget, sched=_sched_config_from_args(args),
            slo=slo, wal_dir=args.wal_dir, wal_fsync=args.wal_fsync, wal_max_mb=args.wal_max_mb,
            replicas=args.replicas, router_phase_weight=args.router_phase_weight,
            router_depth_weight=args.router_depth_weight,
            router_health_poll_s=args.router_health_poll_s,
            router_drain_recoveries=args.router_drain_recoveries,
            autoscale=_autoscale_config_from_args(args), metrics_port=args.metrics_port,
        )
    except ValueError as e:
        raise SystemExit(str(e)) from e
    device = resolve_device(cfg.device)
    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(cfg.model_path)
        tokenizer.pad_token = tokenizer.eos_token

    from flexible_llm_sharding_tpu_torch.runtime.executor import peak_mem_gb
    from flexible_llm_sharding_tpu_torch.serve import (
        QueueFull,
        ReplicaFleet,
        RequestStatus,
        ServeEngine,
    )

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    from flexible_llm_sharding_tpu_torch.faults import inject

    inject.reset_process_fault_counts()
    t0 = time.perf_counter()
    # The fleet has the engine's surface: both frontends drive either.
    fleet = _serve_wants_fleet(serve_cfg)
    if fleet:
        engine = ReplicaFleet(cfg, serve_cfg, tokenizer=tokenizer, device=device)
    else:
        engine = ServeEngine(cfg, serve_cfg, tokenizer=tokenizer, device=device)
    if engine.metrics_server is not None:
        print(f"metrics endpoint: http://{engine.metrics_server.host}:"
              f"{engine.metrics_server.port}/metrics", file=sys.stderr, flush=True)
    extra: dict = {}

    def replay_open(callback=None) -> None:
        # The requests a previous start left open, before any new traffic.
        if engine._wal is not None:
            from flexible_llm_sharding_tpu_torch.serve import recovery

            summary = recovery.replay(engine, engine._wal, callback=callback)
            print(f"wal replay: {summary['replayed']} reopened, {summary['skipped_terminal']} "
                  f"already terminal, kv restored {summary['kv_restored']} (failed "
                  f"{summary['kv_failed']})", file=sys.stderr, flush=True)
        if fleet:
            # The autoscaler's first decision waits for the replay.
            engine.mark_replay_complete()

    import signal

    def on_sigterm(signum, frame):
        # A graceful restart: the waves in flight finish their sweep, every
        # unfinished request is parked in the WAL, and the process exits.
        engine.shutdown_for_restart()
        raise SystemExit(143)

    try:
        old_sigterm = signal.signal(signal.SIGTERM, on_sigterm)
    except ValueError:  # not the main thread: the caller owns shutdown
        old_sigterm = None
    try:
        if args.prompt_pickle:
            replay_open()
            with open(args.prompt_pickle, "rb") as f:
                prompts = pickle.load(f)
            requests = []
            for prefix, suffixes in prompts:
                # One score per prompt, as the batch CLI writes: retry on
                # backpressure (QueueFull) until a slot frees. Any other
                # rejection (RequestTooLarge) is final and fails the gather
                # below, as does an engine-fatal error.
                while True:
                    req = engine.submit(prefix, tuple(suffixes))
                    if (req.status is not RequestStatus.REJECTED or engine.error is not None
                            or not isinstance(req.future.exception(), QueueFull)):
                        break
                    time.sleep(0.05)
                requests.append(req)
                if args.stagger_ms:
                    time.sleep(args.stagger_ms / 1000.0)
            extra["queue_depth_after_submit"] = engine.queue_depth()
            results = [r.future.result() for r in requests]
            with open(args.output_file, "wb") as f:
                pickle.dump([r.scores for r in results], f)
            with open(_updated_path(args.prompt_pickle), "wb") as f:
                pickle.dump([r.updated for r in results], f)
        else:
            _serve_jsonl(engine, replay_open)
    except BaseException as e:
        if engine.error is not None and not isinstance(e, SystemExit):
            # A fatal error cancels the queue, so the gather raises the
            # secondary ServeClosed: name the root cause instead.
            raise SystemExit(f"serve engine failed: {engine.error!r}") from e
        raise
    finally:
        try:
            engine.shutdown(drain=True)  # a SIGTERM meanwhile still parks the rest
        finally:
            if old_sigterm is not None:
                signal.signal(signal.SIGTERM, old_sigterm)
            _write_trace(cfg)
    if engine.error is not None:
        raise SystemExit(f"serve engine failed: {engine.error!r}")
    wall = time.perf_counter() - t0
    stats = engine.stats()
    stats.update(extra)
    stats["device"] = str(device)
    stats["wall_s"] = wall
    stats["tokens_per_sec"] = stats["tokens_served"] / wall if wall > 0 else 0.0
    peak = peak_mem_gb(device)
    if peak is not None:
        stats["peak_mem_gb"] = peak
    if fleet:
        stats["host_rss_gib"] = host_rss_gib().get("rss")
    if cfg.faults.enabled:
        stats["chaos_faults"] = inject.process_fault_counts()
    print(json.dumps(stats), file=sys.stderr)
    return stats


def _serve_jsonl(engine, replay_open) -> None:
    """Requests as JSON lines on stdin; one JSON line per completion or
    rejection on stdout (tokens and text, not scores). ``replay_open(reply)``
    first submits the WAL's open requests, their replies on stdout too."""
    import threading

    out_lock = threading.Lock()

    def reply(req) -> None:
        try:
            res = req.future.result(timeout=0)
            line = {
                "id": req.request_id,
                "status": req.status.value,
                "updated_suffixes": list(res.updated[1]),
                "tokens": res.tokens.tolist(),
                "ttft_s": round(res.ttft_s, 4),
                "latency_s": round(res.latency_s, 4),
            }
        except Exception as e:  # rejected, expired or failed
            line = {"id": req.request_id, "status": req.status.value, "error": str(e)}
            if getattr(e, "retry_after_s", None) is not None:  # a shed or a rate limit
                line["retry_after_s"] = e.retry_after_s
        if req.client_id is not None:
            line["client_id"] = req.client_id
        with out_lock:
            print(json.dumps(line), flush=True)

    replay_open(reply)
    for line_no, raw in enumerate(sys.stdin, 1):
        raw = raw.strip()
        if not raw:
            continue
        try:
            d = json.loads(raw)
            engine.submit(d["prefix"], tuple(d.get("suffixes") or ("",)),
                          max_new_tokens=d.get("max_new_tokens"), deadline_s=d.get("deadline_s"),
                          callback=reply, slo_class=d.get("slo_class"),
                          tenant_id=d.get("tenant_id"), adapter_id=d.get("adapter_id"),
                          client_id=d.get("id"))
        except Exception as e:
            # One bad line must not take the server down: reject it with
            # its reason and keep serving.
            with out_lock:
                print(json.dumps({"line": line_no, "status": "rejected",
                                  "error": f"bad request line: {e!r}"}), flush=True)


def config_from_args(args: argparse.Namespace) -> FrameworkConfig:
    return FrameworkConfig(
        model_path=args.model_path,
        num_batch=args.num_batch,
        layer_num_per_shard=args.layer_num_per_shard,
        storage_location=args.storage_location,
        max_activation_in_cpu=args.max_activation_in_cpu,
        data_parallel=args.data_parallel,
        num_devices=args.num_devices,
        tensor_parallel=args.tensor_parallel,
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
        kv_page_tokens=args.kv_page_tokens,
        kv_pool_gb=args.kv_pool_gb,
        kv_host_spill=args.kv_host_spill,
        use_pallas=args.use_pallas,
        resume=args.resume,
        long_context=args.long_context,
        adapters=_adapter_config_from_args(args),
        faults=_fault_config_from_args(args),
        pressure=_pressure_config_from_args(args),
        verbose_metrics=args.verbose_metrics,
        profile_dir=args.profile_dir,
        trace=args.trace,
        trace_out=args.trace_out,
        journal_dir=args.journal_dir,
        journal_max_mb=args.journal_max_mb,
        incidents_dir=args.incidents_dir,
        incidents_max_mb=args.incidents_max_mb,
        incident_trigger=args.incident_trigger,
        incident_debounce_s=args.incident_debounce_s,
        incident_settle_s=args.incident_settle_s,
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
    """Run the batch CLI and return the stats it prints, or the ``serve``,
    ``verify``, ``plan-precision``, ``prepare-adapter``, ``incidents``,
    ``trace-report`` or ``check`` subcommand (``check`` exits with the
    analyzer's code when it is not 0)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "serve":
        return serve_main(argv[1:], tokenizer=tokenizer)
    if argv and argv[0] == "verify":
        return verify_main(argv[1:])
    if argv and argv[0] == "plan-precision":
        plan_precision_main(argv[1:], tokenizer=tokenizer)
        return None
    if argv and argv[0] == "prepare-adapter":
        prepare_adapter_main(argv[1:])
        return None
    if argv and argv[0] == "incidents":
        incidents_main(argv[1:])
        return None
    if argv and argv[0] == "check":
        # flscheck: the port's copy of the project-invariant static analyzer.
        from flexible_llm_sharding_tpu_torch.analysis import main as check_main

        rc = check_main(argv[1:])
        if rc:
            raise SystemExit(rc)
        return None
    if argv and argv[0] == "trace-report":
        from flexible_llm_sharding_tpu_torch.obs.report import main as report_main

        rc = report_main(argv[1:])
        if rc:
            raise SystemExit(rc)
        return None
    args = build_parser().parse_args(argv)
    if args.speculative_k and args.data_parallel:
        raise SystemExit("--speculative_k does not compose with --data_parallel "
                         "(the broadcast source's round count is fixed up front)")
    if args.speculative_k and args.long_context:
        raise SystemExit("--speculative_k is not supported with --long_context yet")
    try:
        cfg = config_from_args(args)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    from flexible_llm_sharding_tpu_torch.runtime.orchestration import (
        LAST_DP_RANK_STATS,
        pick_devices,
        run_decode,
        run_prompts,
    )

    devices = pick_devices(cfg)
    if cfg.storage_location == "disk":
        os.makedirs(cfg.disk_folder, exist_ok=True)
    with open(args.prompt_pickle, "rb") as f:
        prompts = pickle.load(f)
    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(cfg.model_path)
        tokenizer.pad_token = tokenizer.eos_token

    from flexible_llm_sharding_tpu_torch.runtime.generation import generation_loop

    for dev in dict.fromkeys(d for d in devices if d.type == "cuda"):
        torch.cuda.reset_peak_memory_stats(dev)
    LAST_DP_RANK_STATS.clear()
    from flexible_llm_sharding_tpu_torch.faults import inject
    from flexible_llm_sharding_tpu_torch.runtime import pressure

    inject.reset_process_fault_counts()
    from flexible_llm_sharding_tpu_torch.runtime.executor import reset_process_streamed_bytes

    reset_process_streamed_bytes()
    # The brownout ladder of a batch run (--pressure): started here, as the
    # serving engines start it for themselves.
    ctrl = pressure.controller_for(cfg, devices[0])
    # The flight recorder of a batch run (--journal_dir/--incidents_dir).
    from flexible_llm_sharding_tpu_torch.obs import incident as obs_incident

    obs_incident.ensure_configured(cfg)
    # One stats dict per pass of every entry-point call (a DP fan-out's as one).
    calls: list[dict] = []
    t0 = time.perf_counter()
    try:
        with profiler_trace(cfg.profile_dir or None):
            if cfg.kv_cache:
                output_scores, updated, _ = run_decode(cfg, prompts, tokenizer=tokenizer,
                                                       devices=devices, calls=calls)
            else:
                output_scores, updated = generation_loop(
                    lambda ps: run_prompts(cfg, ps, tokenizer=tokenizer, devices=devices,
                                           calls=calls),
                    prompts,
                    cfg.num_gen_token,
                    tokenizer,
                    temperature=cfg.temperature,
                    seed=cfg.seed,
                    top_k=cfg.top_k,
                    top_p=cfg.top_p,
                )
    except BaseException:
        _write_trace(cfg)  # the timeline of a run that died
        raise
    wall = time.perf_counter() - t0

    with open(_updated_path(args.prompt_pickle), "wb") as f:
        pickle.dump(updated, f)
    with open(args.output_file, "wb") as f:
        pickle.dump(output_scores, f)

    tokens = int(sum(c["tokens_processed"] for c in calls))
    stats = {
        "device": str(devices[0]),
        "num_devices": len(devices),
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
    if len(devices) > 1:
        # One card named as several stages or ranks: its peak holds all of
        # theirs; on distinct cards, the largest card's.
        stats["peak_hbm_scope"] = "process" if len(set(devices)) == 1 else "max_device"
        if cfg.data_parallel:
            # Host builds: each is placed on every rank's device.
            stats["streamed_bytes_note"] = "broadcast: link traffic ~= n_ranks x host_loads"
    from flexible_llm_sharding_tpu_torch.runtime.residency import process_tier

    tier = process_tier()
    if tier is not None:
        stats["residency"] = tier.stats()
    if cfg.faults.enabled:
        stats["chaos_faults"] = inject.process_fault_counts()
    if ctrl is not None:
        stats["pressure"] = ctrl.stats()
    rss = host_rss_gib()
    stats["peak_host_rss_gib"] = rss["peak"]
    if "rss" in rss:
        stats["host_rss_gib"] = rss["rss"]
    if LAST_DP_RANK_STATS:
        stats["dp_ranks"] = {
            str(r): {k: int(v) if k == "prompts" else round(v, 3) for k, v in s.items()}
            for r, s in sorted(LAST_DP_RANK_STATS.items())
        }
    print(json.dumps(stats), file=sys.stderr)
    if args.metrics_out:
        # The registry every subsystem registered into, with the stats line:
        # the machine-readable form of the line above.
        from flexible_llm_sharding_tpu_torch.obs.registry import REGISTRY

        with open(args.metrics_out, "w") as f:
            json.dump({"stats": stats, "metrics": REGISTRY.collect()}, f, indent=1)
        print(f"metrics written -> {args.metrics_out}", file=sys.stderr)
    _write_trace(cfg)
    return stats


__all__ = ["build_incidents_parser", "build_parser", "build_plan_precision_parser",
           "build_prepare_adapter_parser", "build_serve_parser", "build_verify_parser",
           "incidents_main", "main", "plan_precision_main", "prepare_adapter_main", "serve_main",
           "verify_main"]


if __name__ == "__main__":
    main()
