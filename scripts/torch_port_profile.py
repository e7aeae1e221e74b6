#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's full-width run, on one GPU.

    python3 scripts/torch_port_profile.py

Writes the same seeded bf16 Llama-2-7B-width checkpoint that chip_smoke.py
writes (4 decoder layers, one per shard), warms the process up with one
scoring pass, then measures the batch CLI's configurations one after the
other, each as its own JSON line:

- the scoring pass (one token) with activations parked in host RAM
  (``cpu``, the default) and on the device (``gpu``), with and without the
  prefetch thread (``--prefetch_depth 0``);
- KV-cache decode (4 tokens) with the KV parked in host RAM and on the
  device;
- KV-cache decode (storage ``cpu``) and scoring (storage ``gpu``) again
  under ``torch.profiler``: CUDA kernel and memcpy time by name, and the
  device-busy share of the wall time (device time summed over kernels and
  copies, divided by the run's wall, which includes the profiler's own
  overhead).

Each line carries the card's ``nvidia-smi`` name and power limit. Needs a
CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import BenchTokenizer, _init_params, make_prompts  # noqa: E402


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _profile_summary(prof, wall_s: float) -> dict:
    """Device-side events only (kernels and copies): the ``aten::`` ops that
    launch them carry the same device time again."""
    rows = []
    busy_us = 0.0
    for evt in prof.key_averages():
        us = _device_us(evt)
        if (us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA
                or evt.key.startswith("aten::")):
            continue
        busy_us += us
        rows.append((us, evt.key, evt.count))
    rows.sort(reverse=True)
    return {
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall_s if wall_s > 0 else None,
        "top": [{"name": k[:90], "calls": c, "device_ms": us / 1e3} for us, k, c in rows[:14]],
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    from flexible_llm_sharding_tpu_torch import cli
    from flexible_llm_sharding_tpu_torch.config import LlamaConfig
    from flexible_llm_sharding_tpu_torch.ops import cuda_build
    from flexible_llm_sharding_tpu_torch.utils.checkpoint import save_params

    cuda_build.library()
    work = tempfile.mkdtemp(prefix="torch_port_profile_")
    try:
        cfg = LlamaConfig(num_hidden_layers=4)
        model = os.path.join(work, "model")
        save_params(_init_params(cfg, torch.bfloat16, 0, "cuda"), model, cfg)
        prompts = make_prompts(8, 512, 4, 32, seed=0)
        ppkl = os.path.join(work, "p.pkl")
        with open(ppkl, "wb") as f:
            pickle.dump(prompts, f)

        def run(extra):
            return cli.main(
                ["--model_path", model, "--prompt_pickle", ppkl,
                 "--output_file", os.path.join(work, "s.pkl"), "--device", "cuda",
                 "--disk_folder", os.path.join(work, "disk"), *extra],
                tokenizer=BenchTokenizer(),
            )

        run([])  # warm-up: cuBLAS handles, pinned-memory pool, page cache
        for name, extra in (
            ("scoring storage=cpu prefetch=1", []),
            ("scoring storage=gpu prefetch=1", ["--storage_location", "gpu"]),
            ("scoring storage=cpu prefetch=0", ["--prefetch_depth", "0"]),
            ("scoring storage=gpu prefetch=0",
             ["--storage_location", "gpu", "--prefetch_depth", "0"]),
            ("kv_cache 4 tokens storage=cpu", ["--kv_cache", "true", "--num_gen_token", "4"]),
            ("kv_cache 4 tokens storage=gpu",
             ["--kv_cache", "true", "--num_gen_token", "4", "--storage_location", "gpu"]),
        ):
            stats = run(extra)
            print(json.dumps({"run": name, "card": smi, **stats}), flush=True)

        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            stats = run(["--kv_cache", "true", "--num_gen_token", "4"])
        print(json.dumps({"run": "kv_cache 4 tokens storage=cpu (profiled)", "card": smi,
                          **stats, **_profile_summary(prof, stats["wall_s"])}), flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            stats = run(["--storage_location", "gpu"])
        print(json.dumps({"run": "scoring storage=gpu (profiled)", "card": smi,
                          **stats, **_profile_summary(prof, stats["wall_s"])}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
