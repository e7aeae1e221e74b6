"""Stress a data-parallel run whose rank 1 fails at once (the port's
``runtime/orchestration.run_prompts`` over ``[cpu] * 3``, two batches):
every run must raise rank 1's own error, in well under a second, and leave
no rank thread and no producer behind. Counts the runs that did not.

Before the broadcast source's close waited for its producer (ROADMAP §3,
F7), a rank still building its executor could lose shard 0 to close's drain
and take shard 1 under shard 0's name; its ``AttributeError`` then became
the run's root cause.

    python scripts/torch_dp_close_race.py [--iters 150] [--procs 6]

``--procs`` runs that many processes at once (the contention of a parallel
test run). Exits 1 if any run went wrong. CPU only; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

PROMPTS = [
    ("the capital of france is a city", (" paris", " rome")),
    ("two plus two equals", (" four", " five", " fish")),
    ("one two three four five six", (" seven",)),
    ("the cat sat on the mat the cat sat on the mat", (" the cat", " on the")),
    ("alpha beta gamma", (" delta",)),
]


def run(iters: int) -> int:
    """``iters`` failing DP runs in this process; returns how many went wrong."""
    import torch

    from chip_smoke import BenchTokenizer, _init_params
    from flexible_llm_sharding_tpu_torch.config import FrameworkConfig, LlamaConfig
    from flexible_llm_sharding_tpu_torch.runtime import orchestration
    from flexible_llm_sharding_tpu_torch.runtime.executor import StreamingExecutor
    from flexible_llm_sharding_tpu_torch.utils.checkpoint import save_params

    cfg = LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
                      num_attention_heads=4, num_key_value_heads=2)
    work = tempfile.mkdtemp(prefix="dp_close_race_")
    model_dir = os.path.join(work, "model")
    save_params(_init_params(cfg, torch.float32, 0, "cpu"), model_dir, cfg)
    real = StreamingExecutor.__call__

    def failing(self, prompts, batch=0):
        if self.plan.device_rank == 1:
            raise RuntimeError("rank 1 failed")
        return real(self, prompts, batch)

    StreamingExecutor.__call__ = failing
    made = []
    base = orchestration.BroadcastShardSource

    class Watched(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    orchestration.BroadcastShardSource = Watched
    fw = FrameworkConfig(model_path=model_dir, dtype="float32", bucket_multiple=8, block_size=2,
                         disk_folder=work, prefetch_depth=1, device="cpu", data_parallel=True,
                         num_batch=2)
    bad = 0
    for i in range(iters):
        made.clear()
        t0 = time.monotonic()
        error = None
        try:
            orchestration.run_prompts(fw, PROMPTS, tokenizer=BenchTokenizer(cfg.vocab_size),
                                      devices=[torch.device("cpu")] * 3)
        except Exception as e:  # noqa: BLE001 - the run's error is what is checked
            error = e
        elapsed = time.monotonic() - t0
        alive = [t.name for t in threading.enumerate() if t.name.startswith("dp-rank")]
        ok = (isinstance(error, RuntimeError) and "rank 1 failed" in str(error) and elapsed < 60
              and not alive and len(made) == 1 and not made[0]._thread.is_alive())
        if not ok:
            bad += 1
            print(f"run {i}: {elapsed:.2f} s, threads {alive}, raised "
                  f"{type(error).__name__}: {error}", flush=True)
    return bad


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=150, help="failing runs per process")
    p.add_argument("--procs", type=int, default=1, help="processes at once")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child or args.procs == 1:
        bad = run(args.iters)
        print(f"{args.iters} runs, {bad} wrong", flush=True)
        sys.exit(1 if bad else 0)
    procs = [subprocess.Popen([sys.executable, __file__, "--child", "--iters", str(args.iters)])
             for _ in range(args.procs)]
    codes = [proc.wait() for proc in procs]
    print(f"{args.procs} processes x {args.iters} runs: {sum(1 for c in codes if c)} with a "
          "wrong run", flush=True)
    sys.exit(1 if any(codes) else 0)


if __name__ == "__main__":
    main()
