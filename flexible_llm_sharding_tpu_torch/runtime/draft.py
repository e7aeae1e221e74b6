"""A resident draft model for speculative serving (the JAX package's
``runtime/draft.py``).

Every decode sweep streams the target model through the card, so draft
compute is what serving can spend without touching the host-to-device
link. A small draft model is pinned whole on the card through a residency
tier of its own (``runtime/residency.py``: pin loads through the weight
source's verified loader, the tier's stats), and drafting runs on the
pinned weights only: it adds no byte to the per-sweep weight stream. The
pin loads count once, at construction (``pin_stream_bytes``).

:meth:`DraftModel.propose` is a ``SpecVerifier`` draft function
(``draft_fn(context_ids, k)`` -> exactly k int64 ids): k greedy steps, each
one :func:`models.llama.forward_full` over the context right-padded to a
multiple of ``DRAFT_PAD_MULTIPLE`` and capped at the model's
``max_position_embeddings``, with no KV cache. Verification is
draft-agnostic, so what the model proposes moves acceptance, never a token.

Differences from the JAX package: the tier's plan is ``full_pin_plan`` over
the layer files' bytes (the JAX plan sums the layer indices of its size
map, ``flexible_llm_sharding_tpu/runtime/residency.py``), a layer the plan
leaves out fails construction, and the weights take the engine's compute
dtype (JAX: float32).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from flexible_llm_sharding_tpu_torch.config import LlamaConfig
from flexible_llm_sharding_tpu_torch.models.llama import forward_full
from flexible_llm_sharding_tpu_torch.runtime.executor import ShardWeightSource, layer_segments
from flexible_llm_sharding_tpu_torch.runtime.residency import DeviceResidencyTier, full_pin_plan
from flexible_llm_sharding_tpu_torch.utils import checkpoint

# Contexts are right-padded to a multiple of this before the forward.
DRAFT_PAD_MULTIPLE = 64


class DraftModel:
    """One draft checkpoint pinned whole on ``device`` in ``dtype``, serving
    greedy draft continuations. Construction raises when a layer does not
    pin: a draft model that would stream per call defeats its purpose.
    ``use_pallas`` (the target engine's) picks the causal kernel or the
    plain op for the draft's forward."""

    def __init__(self, model_path: str, device: torch.device, dtype: torch.dtype = torch.float32,
                 retry_policy=None, verify_weights: bool = True, injector=None, *,
                 use_pallas: bool):
        self.cfg = LlamaConfig.from_pretrained(model_path)
        self.device = device
        self.dtype = dtype
        self.use_pallas = use_pallas
        self._lock = threading.Lock()
        self.draft_calls = 0
        self.draft_tokens = 0
        tied = self.cfg.tie_word_embeddings
        names = checkpoint.layer_names_for(self.cfg.num_hidden_layers, tied)
        # The weight source's loader, never iterated: its verified, retried
        # reads are what the tier's pin loads take.
        self._loader = ShardWeightSource(
            model_path, names, [], dtype, device, prefetch_depth=0, tied_embeddings=tied,
            verify_weights=verify_weights, readahead_threads=0, retry_policy=retry_policy,
            injector=injector)
        try:
            plan = full_pin_plan(model_path, names, tied)
            missing = sorted(set(range(len(names))) - plan.pinned_set)
            if missing:
                raise ValueError(f"{model_path}: draft layers {[names[i] for i in missing]} "
                                 "have no weights to pin")
            # A tier of its own, never the process tier (that one is keyed to
            # the target model).
            self.tier = DeviceResidencyTier(model_path, names, plan)
            placed = [seg for idx in range(len(names))
                      for seg in self.tier.segments(idx, device, self._loader)]
        except BaseException:
            self._loader.close()
            raise
        params: dict = {"layers": []}
        for kind, p in layer_segments(placed):
            # A decoder layer and the head are placed as rank lists: one
            # device holds one rank.
            if kind == "decoders":
                params["layers"].extend(ranks[0] for ranks in p)
            elif kind == "head":
                params["lm_head"] = p[0]
            else:
                params[kind] = p
        self._params = params
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        # Contexts keep their newest tokens within the model's positions.
        self._ctx_cap = int(self.cfg.max_position_embeddings)

    @torch.inference_mode()
    def propose(self, context_ids, k: int) -> np.ndarray:
        """The greedy k-token continuation of ``context_ids``: exactly k
        int64 ids."""
        ids = np.asarray(context_ids, np.int64)
        out: list[int] = []
        for _ in range(k):
            out.append(self._next_token(ids))
            ids = np.append(ids, out[-1])
        with self._lock:
            self.draft_calls += 1
            self.draft_tokens += k
        return np.asarray(out, np.int64)

    def _next_token(self, ids: np.ndarray) -> int:
        if len(ids) >= self._ctx_cap:
            ids = ids[-(self._ctx_cap - 1):]
        n = len(ids)
        pad = -(-n // DRAFT_PAD_MULTIPLE) * DRAFT_PAD_MULTIPLE
        buf = np.zeros((1, pad), np.int64)
        buf[0, :n] = ids
        logits = forward_full(self._params, self.cfg, torch.from_numpy(buf).to(self.device),
                              self.dtype, use_pallas=self.use_pallas)
        return int(torch.argmax(logits[0, n - 1]))

    def stats(self) -> dict:
        """The engine's ``draft`` stats source: calls and tokens drafted, the
        layers and device bytes pinned, and the bytes the pin loads read."""
        tier = self.tier.stats()
        with self._lock:
            return {
                "draft_calls": self.draft_calls,
                "draft_tokens": self.draft_tokens,
                "pinned_layers": tier["pinned_layers"],
                "pinned_bytes": tier["pinned_bytes"],
                "pin_stream_bytes": self._loader.bytes_loaded,
            }

    def close(self) -> None:
        self._loader.close()


__all__ = ["DRAFT_PAD_MULTIPLE", "DraftModel"]
