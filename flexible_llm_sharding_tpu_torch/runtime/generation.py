"""Token selection and the reference generation loop (the JAX package's
``runtime/generation.py``).

``generation_loop`` re-scores the current prompts once per new token (the
reference's ``num_gen_token`` loop): scores concatenate along axis 1, and
each suffix is rebuilt as the original suffix string plus the decoded token
history. Greedy by default; temperature/top-k/top-p sampling from a numpy
generator seeded with ``seed``.
"""

from __future__ import annotations

import copy
from typing import Callable, Sequence

import numpy as np

Prompt = tuple[str, tuple[str, ...]]
RunFn = Callable[[list[Prompt]], list[np.ndarray]]


def sample_tokens(dist: np.ndarray, rng: np.random.Generator, temperature: float,
                  top_k: int = 0, top_p: float = 0.0) -> np.ndarray:
    """One token per row of ``dist`` [N, V]: temperature reshaping
    ``p^(1/T)``, top-k (exactly k survivors, ties broken by index), then
    nucleus truncation on the renormalised mass, then one inverse-CDF draw
    per row."""
    dist = np.asarray(dist, np.float64)
    logits = np.log(np.maximum(dist, 1e-30)) / max(temperature, 1e-6)
    p = np.exp(logits - logits.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    v = p.shape[-1]
    if (top_k and top_k < v) or 0.0 < top_p < 1.0:
        order = np.argsort(-p, axis=-1, kind="stable")
        ranks = np.empty_like(order)
        np.put_along_axis(ranks, order, np.arange(v)[None, :], axis=-1)
        if top_k and top_k < v:
            p = np.where(ranks < top_k, p, 0.0)
            p /= p.sum(axis=-1, keepdims=True)
        if 0.0 < top_p < 1.0:
            sorted_p = np.take_along_axis(p, order, axis=-1)
            csum = np.cumsum(sorted_p, axis=-1)
            keep_sorted = (csum - sorted_p) < top_p
            p = np.where(np.take_along_axis(keep_sorted, ranks, axis=-1), p, 0.0)
        p /= p.sum(axis=-1, keepdims=True)
    u = rng.random(p.shape[0])
    csum = np.cumsum(p, axis=-1)
    csum /= csum[:, -1:]
    return np.minimum((csum < u[:, None]).sum(axis=-1), v - 1).astype(np.int64)


def make_picker(cfg, rng: np.random.Generator | None = None):
    """``pick(dist, real=None)``: [..., V] distributions -> [...] tokens.
    Greedy argmax when ``cfg.temperature`` is 0, else sampling with one rng
    seeded from ``cfg.seed``; rows where ``real`` is False (padded suffixes)
    take the argmax without advancing the rng."""
    if cfg.temperature <= 0:
        return lambda dist, real=None: np.argmax(dist, axis=-1)
    rng = rng if rng is not None else np.random.default_rng(cfg.seed)

    def pick(dist: np.ndarray, real=None) -> np.ndarray:
        lead = dist.shape[:-1]
        flat = dist.reshape(-1, dist.shape[-1])
        if real is None:
            return sample_tokens(flat, rng, cfg.temperature, cfg.top_k, cfg.top_p).reshape(lead)
        out = np.argmax(dist, axis=-1).reshape(-1)
        mask = np.broadcast_to(np.asarray(real, bool), lead).reshape(-1)
        if mask.any():
            out[mask] = sample_tokens(flat[mask], rng, cfg.temperature, cfg.top_k, cfg.top_p)
        return out.reshape(lead)

    return pick


def generation_loop(run_fn: RunFn, prompts: Sequence[Prompt], num_gen_token: int, tokenizer,
                    temperature: float = 0.0, seed: int = 0, top_k: int = 0,
                    top_p: float = 0.0) -> tuple[list[np.ndarray], list[Prompt]]:
    """``num_gen_token`` rounds of scoring. Returns (per-prompt
    ``[n_suffixes, num_gen_token, vocab]`` scores, prompts with the generated
    text appended to each suffix)."""
    original = list(prompts)
    current: list[Prompt] = copy.deepcopy(original)
    output_scores: list[np.ndarray] = []
    sampled: list[list[list[int]]] = [[[] for _ in sfx] for _, sfx in original]
    rng = np.random.default_rng(seed)

    for i_new in range(num_gen_token):
        outputs = run_fn(current)
        if i_new == 0:
            output_scores = list(outputs)
        else:
            output_scores = [
                np.concatenate((old, new), axis=1) for old, new in zip(output_scores, outputs)
            ]
        for p_idx, (prefix, suffix) in enumerate(original):
            if temperature <= 0:
                history = np.argmax(output_scores[p_idx], axis=-1)  # [S, i+1]
            else:
                for s_idx in range(len(suffix)):
                    dist = output_scores[p_idx][s_idx, i_new]
                    sampled[p_idx][s_idx].append(
                        int(sample_tokens(dist[None], rng, temperature, top_k, top_p)[0])
                    )
                history = np.asarray(sampled[p_idx])
            current[p_idx] = (
                prefix,
                tuple(s + tokenizer.decode(t) for s, t in zip(suffix, history)),
            )
    return output_scores, current


__all__ = ["generation_loop", "make_picker", "sample_tokens"]
