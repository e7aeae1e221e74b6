#!/usr/bin/env python3
"""Time the port's attention kernels of two checkouts in turns on one GPU.

    python3 scripts/torch_kernel_ab.py [--float32] <checkout_a> <checkout_b>

Each checkout's kernels are built first, both ``nvcc`` runs at once, each in
a process of its own. Then the checkouts run in the order a, b, b, a, each in
a process of its own that imports that checkout's ``chip_smoke.py`` and
port, and reads the kernels' device times as ``chip_smoke.py`` reads them
(median of 20 rounds of 20 calls queued behind a spin kernel) at the shapes
both checkouts run. In bf16 (the default), every kernel: the Llama-2-7B
full-width run (no window), the Gemma-3-27B local (window 1024) and global
layers (head dim 128), one prompt with a 4096-token prefix, the Gemma-3-12B
local and global layers (head dim 256), Phi-3-mini's heads (96) and 64-dim
heads at the Llama prompts. With ``--float32``, the two scoring forms
(``score_kernel_f32``): the Llama-2-7B full-width run, the Llama prompts
at head dims 64, 96 and 256, and DeepSeek-V3's MLA head shard at tp = 2
(q/k [8, 2112, 64, 192], v 128; 10 rounds of 4 calls). Prints one JSON line
per run, then each time of b against the mean of a's two runs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys
import torch
sys.path.insert(0, {tree!r})
import chip_smoke as cs
from flexible_llm_sharding_tpu_torch.ops import cuda_build
from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa

cuda_build.library()
if {build_only!r}:
    sys.exit(0)
llama = cs.main_path_case(cs.make_prompts(8, 512, 4, 32, seed=0), 8)
gemma_prompts = cs.make_prompts(8, 2048, 4, 32, seed=1)
if {float32!r}:
    dtype, kernels = torch.float32, ("flash_causal_attention", "flash_prefix_shared_attention")
    cases = {{"llama": llama,
             **{{f"llama_hd{{hd}}": {{**llama, "hd": hd, "hd_v": hd}} for hd in (64, 96, 256)}},
             "deepseek_v3_tp2_shard": cs.main_path_case(gemma_prompts, 2, nq=64, nkv=64, hd=192, hd_v=128)}}
    rounds = {{"deepseek_v3_tp2_shard": (4, 10)}}  # (calls, reps): a call takes tens of ms
else:
    dtype, kernels = torch.bfloat16, None
    gemma = cs.main_path_case(gemma_prompts, 4, nq=32, nkv=16, hd=128)
    long = {{"B": 1, "S": 4, "Ls": 64, "Lp": 4096, "T": 1, "t": 0, "nq": 32, "nkv": 32, "hd": 128,
            "plen": [4096], "eos": [[63] * 4]}}
    gemma12 = {{**gemma, "nq": 16, "nkv": 8, "hd": 256, "hd_v": 256}}
    cases = {{"llama": llama, "gemma3_27b_local": {{**gemma, "local": {{"window": 1024}}}},
             "gemma3_27b_global": gemma, "prefix_4096": long,
             "gemma3_12b_local": {{**gemma12, "local": {{"window": 1024}}}}, "gemma3_12b_global": gemma12,
             "phi3_hd96": {{**llama, "hd": 96, "hd_v": 96}}, "llama_hd64": {{**llama, "hd": 64, "hd_v": 64}}}}
    rounds = {{}}
gen = torch.Generator(device="cuda").manual_seed(1234)
out = {{}}
for name, case in cases.items():
    local = case.get("local") or {{}}
    x = cs._inputs(case, dtype, gen)
    for kernel, (args, kw) in cs._calls(x, None, local).items():
        if kernels is None or kernel in kernels:
            out[name + " " + kernel] = cs._device_ms(lambda: getattr(fa, kernel)(*args, **kw),
                                                     *rounds.get(name, (20, 20)))
    del x
print(json.dumps(out))
"""


def run(tree: str, build_only: bool = False, float32: bool = False) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", CHILD.format(tree=tree, build_only=build_only, float32=float32)],
        cwd=tree, stdout=subprocess.PIPE, text=True)


def main() -> None:
    args = sys.argv[1:]
    float32 = "--float32" in args
    args = [t for t in args if t != "--float32"]
    if len(args) != 2:
        sys.exit(__doc__)
    a, b = (os.path.abspath(t) for t in args)
    builds = [run(t, build_only=True) for t in (a, b)]
    if any(p.wait() for p in builds):
        sys.exit("a build failed")
    runs = {}
    for i, (tag, tree) in enumerate((("a", a), ("b", b), ("b", b), ("a", a))):
        proc = run(tree, float32=float32)
        text, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"run {i} ({tag}) failed")
        times = json.loads(text.strip().splitlines()[-1])
        runs.setdefault(tag, []).append(times)
        print(json.dumps({"run": i, "checkout": tag, "path": tree, "ms": times}), flush=True)
    for key in runs["a"][0]:
        ta = [r[key] for r in runs["a"]]
        tb = [r[key] for r in runs["b"]]
        mean_a = sum(ta) / len(ta)
        print(f"{key}: a {ta[0]:.4f} / {ta[1]:.4f}, b {tb[0]:.4f} / {tb[1]:.4f} ms, "
              f"b/a {sum(tb) / len(tb) / mean_a:.4f}")


if __name__ == "__main__":
    main()
