"""Entry points over one device (the JAX package's
``runtime/orchestration.py``, single-device part)."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from flexible_llm_sharding_tpu_torch.config import FrameworkConfig
from flexible_llm_sharding_tpu_torch.parallel.planner import batch_ranges
from flexible_llm_sharding_tpu_torch.runtime.decode import DecodeGenerator
from flexible_llm_sharding_tpu_torch.runtime.executor import StreamingExecutor

Prompt = tuple[str, tuple[str, ...]]


def run_prompts(cfg: FrameworkConfig, prompts: Sequence[Prompt], tokenizer=None,
                executor: StreamingExecutor | None = None) -> list[np.ndarray]:
    """Score every prompt once -> one ``[n_suffixes, 1, vocab]`` array per
    prompt, in prompt order. Each of the reference's ``num_batch`` pieces is
    one full streaming pass."""
    prompts = list(prompts)
    if not prompts:
        return []
    ex = executor if executor is not None else StreamingExecutor(cfg, tokenizer=tokenizer)
    out: list[np.ndarray] = []
    for i, (lo, hi) in enumerate(batch_ranges(len(prompts), cfg.num_batch)):
        out += ex(prompts[lo:hi], batch=i)
    return out


def run_decode(cfg: FrameworkConfig, prompts: Sequence[Prompt], tokenizer=None,
               generator: DecodeGenerator | None = None):
    """KV-cache decode of every prompt. Returns (scores, updated_prompts,
    tokens_processed)."""
    prompts = list(prompts)
    if not prompts:
        return [], [], 0
    gen = generator if generator is not None else DecodeGenerator(cfg, tokenizer=tokenizer)
    scores, updated = gen(prompts)
    return scores, updated, int(gen.stats["tokens_processed"])


__all__ = ["run_decode", "run_prompts"]
