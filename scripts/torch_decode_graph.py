#!/usr/bin/env python3
"""One block's greedy decode steps at Llama-2-7B widths on one GPU, three
ways: replayed from one CUDA graph (the fused default), the same device
loop uncaptured, and the per-step loop (a host pick and an upload of it
between steps, as with ``--decode_fused off``).

    python3 scripts/torch_decode_graph.py [--layers 32] [--steps 7] [--reps 5]

The block is chip_smoke.py's Llama cell: 8 prompts of 512 prefix words (a
576-token bucket) with 4 suffixes of 32 words, bf16 weights made on the
card from a seed, KV resident, generated slots for ``--steps`` steps. Each
way runs ``--reps`` times after one untimed run; per run it reports the
host wall (perf_counter to a synchronised end, capture included for the
graph), the device span (CUDA events around the call) and, from
torch.profiler over one more run, the device busy time (the sum of the
kernels' durations) and the kernel count. For the graph it also splits
the call: host time of the capture (``capture_begin`` to the end of
``capture_end``, which instantiates the graph) and the replay's device
span (CUDA events around ``replay``), by wrapping ``torch.cuda.CUDAGraph``
in this process. Prints one JSON line per way with the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build(n_layers: int, n_steps: int):
    from chip_smoke import BenchTokenizer, make_prompts, make_tensor, model_specs
    from flexible_llm_sharding_tpu_torch.config import LlamaConfig
    from flexible_llm_sharding_tpu_torch.models import llama
    from flexible_llm_sharding_tpu_torch.runtime.decode import extend_gen_kv
    from flexible_llm_sharding_tpu_torch.runtime.executor import block_meta
    from flexible_llm_sharding_tpu_torch.runtime.tokenization import PromptTokenizer, make_blocks
    from flexible_llm_sharding_tpu_torch.utils.checkpoint import unflatten

    cfg = LlamaConfig(num_hidden_layers=n_layers)
    dev, dtype = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(0)
    trees = {name: unflatten({k: make_tensor(cfg, shape, init, g, "cuda", dtype).to(dev)
                              for k, shape, init in specs})
             for name, specs in model_specs(cfg).items()}
    layers = [(trees[f"model.layers.{i}"], None, None) for i in range(n_layers)]
    prompts = make_prompts(8, 512, 4, 32, seed=0)
    tok = PromptTokenizer(BenchTokenizer(cfg.vocab_size))
    toks = [tok(p, s) for p, s in prompts]
    (idxs,) = make_blocks(toks, 8)
    prefix_ids, suffix_ids, prefix_len, suffix_eos = block_meta(toks, idxs, dev)
    # The prefill's KV of every layer, then the first pick.
    ph = llama.embed(trees["model.embed_tokens"], prefix_ids, dtype, cfg)
    sh = llama.embed(trees["model.embed_tokens"], suffix_ids, dtype, cfg)
    kvs = []
    with torch.inference_mode():
        for params, _, _ in layers:
            ph, sh, kv = llama.prefix_suffix_layer(params, cfg, ph, sh, prefix_len, return_kv=True,
                                                   use_pallas=True)
            kvs.append(extend_gen_kv(kv, n_steps))
        h = llama.select_eos_and_norm(trees["model.norm"], cfg, sh, suffix_eos)
        dist = llama.lm_head_scores(trees["lm_head"], h)
        init_ids = torch.argmax(dist, dim=-1)
    return (cfg, dtype, layers, kvs, trees["model.embed_tokens"], trees["model.norm"],
            trees["lm_head"], init_ids, prefix_len, suffix_eos)


def per_step_loop(cfg, dtype, layers, kvs, embed_p, norm_p, head_p, init_ids, prefix_len,
                  suffix_eos, n_steps):
    """The per-step loop over resident weights: each step's distributions go
    to the host, the pick is taken there and uploaded for the next step."""
    from flexible_llm_sharding_tpu_torch.models import llama
    from flexible_llm_sharding_tpu_torch.ops.norm import rms_norm

    ids = init_ids.cpu().numpy()
    out = []
    for t in range(n_steps):
        x = llama.embed(embed_p, torch.from_numpy(ids[..., None]).to(init_ids.device), dtype, cfg)
        for (params, sliding, _), kv in zip(layers, kvs):
            x = llama.decode_step_layer(params, cfg, x, kv, prefix_len, suffix_eos, t,
                                        sliding=sliding, use_pallas=True)
        h = rms_norm(x, norm_p["scale"], cfg.rms_norm_eps, cfg.norm_unit_offset)
        dist = llama.lm_head_scores(head_p, h, cfg.final_logit_softcap).to("cpu").numpy()
        ids = np.argmax(dist, axis=-1)
        out.append((dist, ids))
    return out


PHASES: dict[str, list[float]] = {"capture_ms": [], "replay_ms": []}


class TimedGraph(torch.cuda.CUDAGraph):
    """torch.cuda.CUDAGraph that records its capture's host time and its
    replays' device spans into PHASES."""

    def capture_begin(self, *args, **kwargs):
        self._t0 = time.perf_counter()
        return super().capture_begin(*args, **kwargs)

    def capture_end(self):
        out = super().capture_end()
        PHASES["capture_ms"].append((time.perf_counter() - self._t0) * 1e3)
        return out

    def replay(self):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = super().replay()
        end.record()
        end.synchronize()
        PHASES["replay_ms"].append(start.elapsed_time(end))
        return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--steps", type=int, default=7)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa
    from flexible_llm_sharding_tpu_torch.runtime.decode import fused_decode_steps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.CUDAGraph = TimedGraph
    inputs = build(args.layers, args.steps)
    ways = {
        "graph": lambda: fused_decode_steps(*inputs, args.steps, graph=True, use_pallas=True),
        "device_loop": lambda: fused_decode_steps(*inputs, args.steps, graph=False, use_pallas=True),
        "per_step_loop": lambda: per_step_loop(*inputs, args.steps),
    }
    picks = {}
    with torch.inference_mode():
        for name, fn in ways.items():
            out = fn()  # untimed: builds, first launches, allocator growth
            picks[name] = (np.stack([p for _, p in out]) if name == "per_step_loop" else out[1])
            host, span = [], []
            for v in PHASES.values():
                v.clear()
            for _ in range(args.reps):
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t0) * 1e3)
                span.append(start.elapsed_time(end))
            fa.reset_launch_counts()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
            print(json.dumps({
                "way": name, "layers": args.layers, "steps": args.steps, "card": smi,
                "host_ms": host, "device_span_ms": span,
                "host_ms_median": float(np.median(host)), "device_span_ms_median": float(np.median(span)),
                "device_busy_ms": busy, "device_events": len(kernels),
                "decode_kernel_launches": fa.launch_counts()["flash_decode_attention"],
                **({k: v[: args.reps] for k, v in PHASES.items()} if name == "graph" else {}),
            }), flush=True)
    same = all(np.array_equal(picks["graph"], p) for p in picks.values())
    print(json.dumps({"picks_equal": same, "card": smi}), flush=True)
    if not same:
        raise SystemExit("the three ways picked different tokens")


if __name__ == "__main__":
    main()
