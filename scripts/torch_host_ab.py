#!/usr/bin/env python3
"""Two checkouts of the PyTorch/CUDA port against each other through the
batch CLI at chip_smoke.py's full-width cells, on one GPU.

    python3 scripts/torch_host_ab.py A_DIR B_DIR [--cells llama2_7b,gemma3_27b,...]

Writes each cell's seeded bf16 checkpoint once, with this checkout's
writers (``integrity.json`` included; a checkout that does not read it
ignores it), builds both checkouts' kernels at once, then runs every cell's
scoring and ``--kv_cache`` runs (chip_smoke.py's prompts and token counts,
one layer per shard) in the order A, B, B, A, each run in a fresh process
of its checkout with the CLI's defaults. Prints one JSON line per run (the
CLI's stats line, plus the process's peak RSS) and a summary line of the
walls, host read seconds, cache hit rates and peak RSS per cell, run and
checkout. Each line carries the card's ``nvidia-smi`` name and power limit.
Cells: llama2_7b (4 layers, 2.14 GB), gemma3_27b (6 layers, 7.8 GB),
gemma3_12b (6 layers, 4.7 GB), deepseek_v3 (4 layers, 30.2 GB).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    DEEPSEEK_V3,
    GEMMA3_12B_TEXT,
    GEMMA3_27B_TEXT,
    _init_params,
    make_prompts,
    write_streamed_checkpoint,
)

# One CLI run in a checkout (argv: checkout, vocab, CLI arguments): the stats
# line's dict and the process's peak RSS, as one JSON line on stdout.
RUNNER = (
    "import json, resource, sys; sys.path.insert(0, sys.argv[1]); "
    "from chip_smoke import BenchTokenizer; from flexible_llm_sharding_tpu_torch import cli; "
    "stats = cli.main(sys.argv[3:], tokenizer=BenchTokenizer(int(sys.argv[2]))); "
    "hwm = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20; "
    "print('STATS ' + json.dumps({**stats, 'max_rss_gib': hwm}), flush=True)"
)
BUILD = "from flexible_llm_sharding_tpu_torch.ops import cuda_build; cuda_build.library()"


def cells() -> dict:
    """name -> (config, prompts, scoring tokens, --kv_cache tokens)."""
    from flexible_llm_sharding_tpu_torch.config import LlamaConfig

    llama_prompts = make_prompts(8, 512, 4, 32, seed=0)
    gemma_prompts = make_prompts(8, 2048, 4, 32, seed=1)
    return {
        "llama2_7b": (LlamaConfig(num_hidden_layers=4), llama_prompts, 4, 8),
        "gemma3_27b": (LlamaConfig.from_dict({"model_type": "gemma3", "text_config": {
            **GEMMA3_27B_TEXT, "num_hidden_layers": 6}}), gemma_prompts, 2, 4),
        "gemma3_12b": (LlamaConfig.from_dict({"model_type": "gemma3", "text_config": {
            **GEMMA3_12B_TEXT, "num_hidden_layers": 6}}), gemma_prompts, 2, 4),
        "deepseek_v3": (LlamaConfig.from_dict({**DEEPSEEK_V3, "num_hidden_layers": 4}),
                        gemma_prompts, 2, 2),
    }


def write_cell(name: str, cfg, model_dir: str) -> None:
    from flexible_llm_sharding_tpu_torch.utils.checkpoint import save_params

    if name == "deepseek_v3":
        write_streamed_checkpoint(model_dir, cfg, seed=0)
    else:
        save_params(_init_params(cfg, torch.bfloat16, 0, "cuda"), model_dir, cfg)
        torch.cuda.empty_cache()


def run(tree: str, cfg, model_dir: str, ppkl: str, work: str, extra: list[str]) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", RUNNER, tree, str(cfg.vocab_size), "--model_path", model_dir,
         "--prompt_pickle", ppkl, "--output_file", os.path.join(work, "scores.pkl"),
         "--disk_folder", os.path.join(work, "disk"), "--dtype", "bfloat16",
         "--layer_num_per_shard", "1", "--device", "cuda", *extra],
        cwd=tree, capture_output=True, text=True)
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("STATS ")]
    if proc.returncode != 0 or not line:
        raise SystemExit(f"{tree}: run failed ({proc.returncode}):\n{proc.stderr[-3000:]}")
    return json.loads(line[0][len("STATS "):])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--cells", default="llama2_7b,gemma3_27b,gemma3_12b,deepseek_v3")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    trees = {"a": os.path.abspath(args.a), "b": os.path.abspath(args.b)}
    with ThreadPoolExecutor(2) as pool:  # both nvcc builds at once
        for proc in pool.map(lambda t: subprocess.run([sys.executable, "-c", BUILD], cwd=t,
                                                      capture_output=True, text=True),
                             trees.values()):
            if proc.returncode != 0:
                raise SystemExit(proc.stderr[-3000:])
    work = tempfile.mkdtemp(prefix="torch_host_ab_")
    summary: dict = {}
    try:
        for name in args.cells.split(","):
            cfg, prompts, n_loop, n_kv = cells()[name]
            model_dir = os.path.join(work, name)
            write_cell(name, cfg, model_dir)
            ppkl = os.path.join(work, f"{name}.pkl")
            with open(ppkl, "wb") as f:
                pickle.dump(prompts, f)
            for rep, key in enumerate("abba"):
                for mode, extra in (("scoring", ["--num_gen_token", str(n_loop)]),
                                    ("kv_cache", ["--num_gen_token", str(n_kv), "--kv_cache", "true"])):
                    stats = run(trees[key], cfg, model_dir, ppkl, work, extra)
                    print(json.dumps({"cell": name, "mode": mode, "checkout": key, "rep": rep,
                                      "card": smi, **stats}), flush=True)
                    row = summary.setdefault(f"{name} {mode}", {}).setdefault(key, [])
                    row.append({k: stats.get(k) for k in (
                        "wall_s", "load_weights_time_s", "compute_wall_s", "source_wait_s",
                        "host_cache_hit_rate", "crc_full_verifies", "max_rss_gib")})
            shutil.rmtree(model_dir, ignore_errors=True)
        print(json.dumps({"summary": summary, "card": smi, "a": trees["a"], "b": trees["b"]}),
              flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
