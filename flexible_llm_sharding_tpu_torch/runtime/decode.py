"""KV-cache decode: multi-token generation with KV reuse across tokens (the
JAX package's ``runtime/decode.py``, streamed single-device part).

Prefill runs one streaming pass in which every decoder layer also returns
its post-rope KV, parked per (shard, layer, block) on the device
(``storage_location='gpu'``) or in host RAM. Each decode step streams the
weights again — the design's point: the device holds one shard — but runs
only the newest token of every suffix through each layer, against the
parked KV, through the decode kernel. Token ids are appended directly (no
decode/re-encode round trip); the ``_updated`` text decodes the id history.
Every pass reads through the same host path as scoring (verified reads,
retries, readahead, the process host shard cache), so from the second pass
on the weights come from host RAM. Weights-resident decode, the fused step
loop, speculative decoding, the KV pool and adapters are not part of this
port.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from flexible_llm_sharding_tpu_torch.models import llama
from flexible_llm_sharding_tpu_torch.ops.norm import rms_norm
from flexible_llm_sharding_tpu_torch.runtime.executor import (
    StreamingExecutor,
    _tree_map,
    block_meta,
    first_decoder,
    peak_mem_gb,
    sync,
)
from flexible_llm_sharding_tpu_torch.runtime.generation import make_picker
from flexible_llm_sharding_tpu_torch.runtime.tokenization import (
    check_longrope_regime,
    longrope_total_len,
    make_blocks,
)


class KVStore:
    """Per-key KV dicts and activations, on the device (``on_device``) or in
    host RAM; ``get`` returns them on the device and removes them."""

    def __init__(self, on_device: bool, device: torch.device):
        self.on_device = on_device
        self.device = device
        self._mem: dict[tuple, Any] = {}

    def put(self, key: tuple, tree) -> None:
        self._mem[key] = tree if self.on_device else _tree_map(lambda t: t.to("cpu"), tree)

    def get(self, key: tuple):
        tree = self._mem.pop(key)
        return tree if self.on_device else _tree_map(lambda t: t.to(self.device), tree)

    def clear(self) -> None:
        self._mem.clear()


class DecodeGenerator(StreamingExecutor):
    """Streaming generation with KV reuse.

    ``__call__(prompts)`` -> (scores, updated_prompts): one float32
    ``[n_suffixes, num_gen_token, vocab]`` per prompt, and the suffix strings
    grown by the decoded tokens.
    """

    @torch.inference_mode()
    def __call__(self, prompts, num_gen_token: int | None = None):
        cfg, mcfg = self.cfg, self.model_cfg
        n_gen = num_gen_token or cfg.num_gen_token
        t_start = time.perf_counter()
        toks = [self.tokenizer(p, s) for p, s in prompts]
        # Parked KV keeps its rope table: generation must not cross longrope's
        # boundary (the last generated token is never fed back).
        check_longrope_regime(mcfg, toks, extra_len=max(n_gen - 1, 0))
        blocks = make_blocks(toks, cfg.block_size)
        metas = [block_meta(toks, idxs, self.device) for idxs in blocks]
        gen_slots = max(1, n_gen - 1)
        kv_store = KVStore(cfg.storage_location == "gpu", self.device)
        n_layers = len(self.layer_names)
        n_shards = len(self.plan.shards)
        sliding = llama.layer_sliding_pattern(mcfg)
        all_scores: list[list[np.ndarray]] = [[] for _ in blocks]
        tok_hist: list[list[np.ndarray]] = [[] for _ in blocks]
        picker = make_picker(cfg)
        real_rows = [
            np.array([[si < toks[i].num_suffixes for si in range(toks[i].suffix_ids.shape[0])]
                      for i in idxs])
            for idxs in blocks
        ]

        def head(b: int, dist: torch.Tensor) -> None:
            d = dist.to("cpu").numpy()
            all_scores[b].append(d)
            tok_hist[b].append(picker(d, real=real_rows[b]))

        source, host_stats = self.weight_source(n_gen)
        it = iter(source)
        compute_time = source_wait = 0.0

        def next_shard():
            nonlocal source_wait
            t0 = time.perf_counter()
            item = next(it)
            source_wait += time.perf_counter() - t0
            return item

        try:
            # --- prefill: one streaming pass, parking each layer's KV -------
            for shard_pos in range(n_shards):
                layer_idxs, segments = next_shard()
                t0 = time.perf_counter()
                for b, idxs in enumerate(blocks):
                    prefix_ids, suffix_ids, prefix_len, suffix_eos = metas[b]
                    total_len = longrope_total_len(mcfg, prefix_len, suffix_eos)
                    ph = sh = None
                    if layer_idxs[0] != 0:
                        ph, sh = kv_store.get(("h", b))
                    li = 0
                    for kind, params in segments:
                        if kind == "embed":
                            ph = llama.embed(params, prefix_ids, self.dtype, mcfg)
                            sh = llama.embed(params, suffix_ids, self.dtype, mcfg)
                        elif kind == "decoders":
                            for layer in params:
                                ph, sh, kv = llama.prefix_suffix_layer(
                                    layer, mcfg, ph, sh, prefix_len, return_kv=True,
                                    sliding=sliding[first_decoder(layer_idxs) + li],
                                    total_len=total_len,
                                )
                                for g, src in (("kg", "ks"), ("vg", "vs")):  # V at its own dim (MLA)
                                    shape = kv[src].shape
                                    kv[g] = kv[src].new_zeros(*shape[:2], gen_slots, *shape[3:])
                                kv_store.put(("kv", shard_pos, li, b), kv)
                                li += 1
                        elif kind == "norm":
                            sh = llama.select_eos_and_norm(params, mcfg, sh, suffix_eos)
                            ph = None
                        else:
                            head(b, llama.lm_head_scores(params, sh, mcfg.final_logit_softcap))
                    if layer_idxs[-1] != n_layers - 1:
                        kv_store.put(("h", b), (ph, sh))
                sync(self.device)
                compute_time += time.perf_counter() - t0
                del segments

            # --- decode steps: stream the weights, one token per suffix -----
            for t in range(n_gen - 1):
                norm_params = None
                for shard_pos in range(n_shards):
                    layer_idxs, segments = next_shard()
                    t0 = time.perf_counter()
                    for b in range(len(blocks)):
                        _, _, prefix_len, suffix_eos = metas[b]
                        x = None if layer_idxs[0] == 0 else kv_store.get(("x", b))
                        li = 0
                        for kind, params in segments:
                            if kind == "embed":
                                ids = torch.from_numpy(np.asarray(tok_hist[b][-1])[..., None])
                                x = llama.embed(params, ids.to(self.device), self.dtype, mcfg)
                            elif kind == "decoders":
                                for layer in params:
                                    kv = kv_store.get(("kv", shard_pos, li, b))
                                    x = llama.decode_step_layer(
                                        layer, mcfg, x, kv, prefix_len, suffix_eos, t,
                                        sliding=sliding[first_decoder(layer_idxs) + li],
                                    )
                                    kv_store.put(("kv", shard_pos, li, b), kv)
                                    li += 1
                            elif kind == "norm":
                                norm_params = params  # applied with the head
                            else:
                                h = rms_norm(x, norm_params["scale"], mcfg.rms_norm_eps,
                                             mcfg.norm_unit_offset)
                                head(b, llama.lm_head_scores(params, h, mcfg.final_logit_softcap))
                        if layer_idxs[-1] != n_layers - 1:
                            kv_store.put(("x", b), x)
                    sync(self.device)
                    compute_time += time.perf_counter() - t0
                    del segments
        finally:
            source.close()
            kv_store.clear()

        self.stats = {
            "total_wall_s": time.perf_counter() - t_start,
            "load_weights_time_s": source.load_time,
            "compute_wall_s": compute_time,
            "source_wait_s": source_wait,
            "streamed_bytes": float(source.bytes_loaded),
            "decode_kv_on_device": float(kv_store.on_device),
            **host_stats.read(source),
            "tokens_processed": float(
                sum(t.tokens_processed for t in toks)
                + sum(t.num_suffixes for t in toks) * max(n_gen - 1, 0)
            ),
        }
        peak = peak_mem_gb(self.device)
        if peak is not None:
            self.stats["peak_mem_gb"] = peak
        self.stats_history.append(dict(self.stats))

        scores_out: list[np.ndarray] = [None] * len(prompts)  # type: ignore[list-item]
        updated = list(prompts)
        raw_tok = self.tokenizer.tok
        for b, idxs in enumerate(blocks):
            stacked = np.stack(all_scores[b], axis=2)  # [B, S, n_gen, V]
            hist = np.stack(tok_hist[b], axis=2)  # [B, S, n_gen]
            for row, i in enumerate(idxs):
                scores_out[i] = stacked[row, : toks[i].num_suffixes]
                prefix, sfx = prompts[i]
                updated[i] = (
                    prefix,
                    tuple(s + raw_tok.decode(hist[row, si]) for si, s in enumerate(sfx)),
                )
        return scores_out, updated


__all__ = ["DecodeGenerator", "KVStore"]
