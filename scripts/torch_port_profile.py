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
  under ``torch.profiler``: CUDA kernel and memcpy time by name, the copies
  by kind (device to page-locked or to pageable host memory, and back),
  and the device-busy share of the wall time (device time summed over
  kernels and copies, divided by the run's wall, which includes the
  profiler's own overhead).

Every run has the CLI's defaults: verified loads, the process host shard
cache (its hit rate is on each line), readahead and retries; runs after the
first in the process find the model in the cache.

    python3 scripts/torch_port_profile.py --deepseek

profiles instead one DeepSeek-V3-width dense layer (MLA) and one MoE layer
(MLA, 256 experts) of chip_smoke.py's DeepSeek-V3 cell, seeded bf16 weights
made on the card (no checkpoint), through ``llama.prefix_suffix_layer`` at
the cell's prompts: each layer's device and host time per call (CUDA events
and the host clock around synchronised calls), then one call of each under
``torch.profiler`` with its CUDA kernel time by name and device-busy share;
and the host-to-device copy rate from page-locked and from pageable host
memory (1 GiB copies, CUDA events), the rate at which a shard's weights
can reach the card once read; then the cell itself through the CLI (its
30.2 GB checkpoint written as chip_smoke.py writes it): one scoring pass
to warm up, one plain, one under ``torch.profiler`` with the host-side
operations and CUDA calls by self CPU time beside the device table, and
the parked activations' copies by kind (``dtoh_pinned_ms``,
``dtoh_pageable_ms``).

    python3 scripts/torch_port_profile.py --crc

times the weight check's crc32 on the card's host: one zlib pass and the
loader's pieces-on-threads form, over 1 GiB of page-locked memory.

    python3 scripts/torch_port_profile.py --quant

writes the Llama-2-7B-width checkpoint (4 decoder layers) and its int8 and
int4 copies (``requantize_native``), then per shard of each
copy: the packed bytes, their upload from page-locked memory and their
dequant to bf16 on the card (device ms from CUDA events, median of 5),
beside the bf16 shard's upload; then one scoring pass of each copy through
the CLI under ``torch.profiler`` with its device table.

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

from chip_smoke import (  # noqa: E402
    DEEPSEEK_V3,
    BenchTokenizer,
    _init_params,
    layer_specs,
    main_path_case,
    make_prompts,
    make_tensor,
    write_streamed_checkpoint,
)


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
    # Copies by kind: "Memcpy DtoH (Device -> Pinned)" rows are the parked
    # activations (and the scores), "Device -> Pageable" ones would block
    # the host; "HtoD (Pinned -> Device)" rows are the weights.
    copies = {k: {"calls": c, "device_ms": us / 1e3} for us, k, c in rows if k.startswith("Memcpy")}
    return {
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall_s if wall_s > 0 else None,
        "copies": copies,
        "dtoh_pageable_ms": sum(v["device_ms"] for k, v in copies.items()
                                if "DtoH" in k and "Pageable" in k),
        "dtoh_pinned_ms": sum(v["device_ms"] for k, v in copies.items()
                              if "DtoH" in k and "Pinned" in k),
        "top": [{"name": k[:90], "calls": c, "device_ms": us / 1e3} for us, k, c in rows[:14]],
    }


def h2d_rates(smi: str) -> None:
    """GB/s of 1 GiB host-to-device copies, page-locked and pageable, on
    the current stream and on a side stream (as the weight source uploads)."""
    n = 1 << 30
    dst = torch.empty(n, dtype=torch.uint8, device="cuda")
    out = {}
    for pinned in (True, False):
        src = torch.empty(n, dtype=torch.uint8, pin_memory=pinned)
        src.fill_(1)
        for side in (False, True):
            stream = torch.cuda.Stream() if side else torch.cuda.current_stream()
            with torch.cuda.stream(stream):
                dst.copy_(src, non_blocking=True)
                a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(5):
                    dst.copy_(src, non_blocking=True)
                e.record()
            e.synchronize()
            key = f"{'pinned' if pinned else 'pageable'} {'side stream' if side else 'current stream'}"
            out[key] = 5 * n / 1e9 / (a.elapsed_time(e) / 1e3)
    print(json.dumps({"run": "host-to-device copy GB/s, 1 GiB", "card": smi, **out}), flush=True)


def crc_rates(smi: str) -> None:
    """GB/s of the weight check's crc32 over 1 GiB of page-locked host
    memory: one zlib pass, and the pieces-on-threads form the loader uses."""
    import time
    import zlib

    from flexible_llm_sharding_tpu_torch.integrity import manifest

    buf = torch.randint(0, 256, (1 << 30,), dtype=torch.uint8).pin_memory().numpy()
    out = {}
    for name, fn in (("zlib one pass", lambda: zlib.crc32(buf)),
                     (f"{manifest._CRC_THREADS} threads", lambda: manifest.checksum_chunked(buf))):
        fn()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        out[name] = 3 * buf.nbytes / 1e9 / (time.perf_counter() - t0)
    print(json.dumps({"run": "crc32 GB/s, 1 GiB page-locked", "card": smi, **out}), flush=True)


def profile_deepseek(smi: str) -> None:
    """chip_smoke.py's DeepSeek-V3 cell, layer by layer (see the module
    docstring)."""
    import time

    from flexible_llm_sharding_tpu_torch.config import LlamaConfig
    from flexible_llm_sharding_tpu_torch.models import llama
    from flexible_llm_sharding_tpu_torch.ops import cuda_build
    from flexible_llm_sharding_tpu_torch.utils.checkpoint import unflatten
    from torch.profiler import ProfilerActivity, profile

    cuda_build.library()
    cfg = LlamaConfig.from_dict({**DEEPSEEK_V3, "num_hidden_layers": 4})
    case = main_path_case(make_prompts(8, 2048, 4, 32, seed=1), 2, nq=128, nkv=128, hd=192, hd_v=128)
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    b, s, lp, ls, d = case["B"], case["S"], case["Lp"], case["Ls"], cfg.hidden_size
    prefix_h = (torch.randn(b, lp, d, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    suffix_h = (torch.randn(b, s, ls, d, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    plen = torch.tensor(case["plen"], dtype=torch.int32, device=dev)
    for name, i in (("dense layer (MLA)", 0), ("MoE layer (MLA, 256 experts)", 3)):
        layer = unflatten({k: make_tensor(cfg, shape, init, g, "cuda", torch.bfloat16).to(dev)
                           for k, shape, init in layer_specs(cfg, i)})
        weights_gb = sum(t.nbytes for t in torch.utils._pytree.tree_leaves(layer)) / 1e9

        def call():
            return llama.prefix_suffix_layer(layer, cfg, prefix_h, suffix_h, plen, use_pallas=True)

        call()
        torch.cuda.synchronize()
        host, device = [], []
        for _ in range(3):
            a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            call()
            e.record()
            torch.cuda.synchronize()
            host.append(time.perf_counter() - t0)
            device.append(a.elapsed_time(e) / 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print(json.dumps({"run": f"deepseek-v3 {name}", "card": smi, "weights_gb": weights_gb,
                          "tokens": b * lp + b * s * ls, "wall_s": host, "events_s": device,
                          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                          **_profile_summary(prof, wall)}), flush=True)
        del layer
        torch.cuda.empty_cache()

    from flexible_llm_sharding_tpu_torch import cli

    work = tempfile.mkdtemp(prefix="torch_port_profile_")
    try:
        model = os.path.join(work, "model")
        write_streamed_checkpoint(model, cfg, seed=0)
        ppkl = os.path.join(work, "p.pkl")
        with open(ppkl, "wb") as f:
            pickle.dump(make_prompts(8, 2048, 4, 32, seed=1), f)

        def run():
            return cli.main(["--model_path", model, "--prompt_pickle", ppkl, "--output_file",
                             os.path.join(work, "s.pkl"), "--device", "cuda", "--layer_num_per_shard",
                             "1", "--disk_folder", os.path.join(work, "disk")],
                            tokenizer=BenchTokenizer(cfg.vocab_size))

        run()  # warm-up: page cache, pinned-memory pool, cuBLAS
        print(json.dumps({"run": "deepseek-v3 cli scoring, 1 token", "card": smi, **run()}), flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            stats = run()
        host = sorted(((e.self_cpu_time_total, e.key, e.count) for e in prof.key_averages()
                       if e.self_cpu_time_total > 0), reverse=True)[:14]
        print(json.dumps({"run": "deepseek-v3 cli scoring, 1 token (profiled)", "card": smi, **stats,
                          **_profile_summary(prof, stats["wall_s"]),
                          "host_top": [{"name": k[:90], "calls": c, "self_cpu_ms": us / 1e3}
                                       for us, k, c in host]}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _event_ms(fn, reps: int = 5) -> float:
    """Median device ms of ``fn`` between CUDA events on the current stream."""
    times = []
    for _ in range(reps):
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        e.record()
        e.synchronize()
        times.append(a.elapsed_time(e))
    return sorted(times)[len(times) // 2]


def profile_quant(smi: str) -> None:
    """Per-shard upload and dequant device time of int8 and int4 copies of
    the Llama-2-7B-width cell, and one profiled scoring pass of each."""
    from torch.profiler import ProfilerActivity, profile

    from flexible_llm_sharding_tpu_torch import cli
    from flexible_llm_sharding_tpu_torch.config import LlamaConfig
    from flexible_llm_sharding_tpu_torch.ops import cuda_build
    from flexible_llm_sharding_tpu_torch.runtime.hostcache import tree_nbytes
    from flexible_llm_sharding_tpu_torch.utils import checkpoint

    cuda_build.library()
    work = tempfile.mkdtemp(prefix="torch_port_profile_")
    try:
        cfg = LlamaConfig(num_hidden_layers=4)
        dirs = {"bf16": os.path.join(work, "bf16")}
        checkpoint.save_params(_init_params(cfg, torch.bfloat16, 0, "cuda"), dirs["bf16"], cfg)
        for dt in ("int8", "int4"):
            dirs[dt] = os.path.join(work, dt)
            checkpoint.requantize_native(dirs["bf16"], dirs[dt], dtype=dt)
        names = checkpoint.layer_names_for(cfg.num_hidden_layers)
        for dt, d in dirs.items():
            for name in names:
                host = checkpoint.load_layer(d, name, pin_memory=True)
                leaves = []

                def walk(t):
                    if checkpoint.is_quantized_leaf(t) or not isinstance(t, dict):
                        leaves.append(t)
                    else:
                        for v in t.values():
                            walk(v)

                walk(host)

                def upload():
                    return [({k: v.to("cuda", non_blocking=True) for k, v in x.items()}
                             if isinstance(x, dict) else x.to("cuda", non_blocking=True))
                            for x in leaves]

                dev = upload()

                def dequant():
                    for x in dev:
                        if isinstance(x, dict):
                            checkpoint.dequantize(x, torch.bfloat16)
                        else:
                            x.to(torch.bfloat16)

                up_ms, deq_ms = _event_ms(upload), _event_ms(dequant)
                print(json.dumps({"run": f"{dt} shard {name}", "card": smi,
                                  "packed_bytes": tree_nbytes(host), "upload_ms": up_ms,
                                  "dequant_ms": deq_ms}), flush=True)
        prompts = make_prompts(8, 512, 4, 32, seed=0)
        ppkl = os.path.join(work, "p.pkl")
        with open(ppkl, "wb") as f:
            pickle.dump(prompts, f)
        for dt, d in dirs.items():
            def run():
                return cli.main(["--model_path", d, "--prompt_pickle", ppkl, "--output_file",
                                 os.path.join(work, "s.pkl"), "--device", "cuda",
                                 "--disk_folder", os.path.join(work, "disk")],
                                tokenizer=BenchTokenizer())
            run()  # warm-up: the host cache holds the copy
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                stats = run()
            print(json.dumps({"run": f"scoring {dt} (profiled, warm host cache)", "card": smi,
                              **stats, **_profile_summary(prof, stats["wall_s"])}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    if "--deepseek" in sys.argv[1:]:
        h2d_rates(smi)
        profile_deepseek(smi)
        return
    if "--crc" in sys.argv[1:]:
        crc_rates(smi)
        return
    if "--quant" in sys.argv[1:]:
        profile_quant(smi)
        return

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
