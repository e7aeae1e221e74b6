"""Long-context scoring and KV decode: (prefix, suffixes) prompts whose
prefix is sharded over a device list (the JAX package's
``runtime/longcontext.py``).

The reference truncates every prefix at its cap
(the reference's ``utils.py:14,250,254``). Here a prompt whose prefix
overflows one device's ``max_token_len`` is scored exactly by sharding the
prefix over an ``sp`` mesh of N ranks (``parallel/sharding.py``), which
makes the cap N * ``max_token_len``:

- The prefix's self-attention is ring attention (``ops/ring_attention.py``):
  each rank keeps one sequence block, its post-rope KV stays there.
- The suffixes need the whole prefix KV. Instead of gathering it, each rank
  folds its own prefix-KV block into flash accumulators (m, l, acc) for the
  suffix queries, and the partials are merged on the first rank's device
  with the maximum and the corrected sums over the ranks (JAX's
  ``pmax``/``psum``): one joint softmax over [prefix KV ; own causal suffix
  KV], the dense ``prefix_shared_attention``'s.
- The suffix side is replicated in JAX; here it stays on the first rank's
  device, and its queries are copied to each rank's device for that
  rank's partials (no copy when the rank shares the device).

The weights stream shard by shard through one ``ShardWeightSource`` whose
``replicas`` are the mesh's distinct devices: each shard is uploaded once
per distinct device (once for ``[cuda:0] * 4``), its pins replicated the
same way. The blocks are plain float32-accumulated products, as JAX's
plain ``einsum`` path (the scoring and decode kernels serve the prompts
under the cap, which the entry points send down the normal paths).

:class:`LongContextDecoder` composes the sp mesh with KV decode: the
prefill parks each layer's KV (the prefix's blocks on their ranks' devices,
suffix and generated regions on the first), and each decode step streams
the weights once more and runs :func:`sharded_decode_layer` per layer,
writing the new token's KV in place.
"""

from __future__ import annotations

import time
from typing import Any, Sequence

import numpy as np
import torch

from flexible_llm_sharding_tpu_torch.config import FrameworkConfig, LlamaConfig
from flexible_llm_sharding_tpu_torch.faults.inject import FaultInjector
from flexible_llm_sharding_tpu_torch.models import llama
from flexible_llm_sharding_tpu_torch.obs import trace as obs_trace
from flexible_llm_sharding_tpu_torch.obs.registry import REGISTRY, weak_source
from flexible_llm_sharding_tpu_torch.ops.attention import _NEG_INF, _local_clause, _softcap
from flexible_llm_sharding_tpu_torch.ops.norm import rms_norm
from flexible_llm_sharding_tpu_torch.ops.ring_attention import local_form, ring_decoder_blocks
from flexible_llm_sharding_tpu_torch.parallel.planner import plan_shards_dp
from flexible_llm_sharding_tpu_torch.parallel.sharding import DeviceMesh, make_mesh, shard
from flexible_llm_sharding_tpu_torch.runtime import residency
from flexible_llm_sharding_tpu_torch.runtime.executor import (
    ShardWeightSource,
    StreamStats,
    first_decoder,
    peak_over,
    sync,
)
from flexible_llm_sharding_tpu_torch.runtime.generation import make_picker
from flexible_llm_sharding_tpu_torch.runtime.hostcache import cache_for
from flexible_llm_sharding_tpu_torch.runtime.tokenization import (
    PromptTokenizer,
    bucket_len,
    check_longrope_regime,
)
from flexible_llm_sharding_tpu_torch.utils import checkpoint

Params = dict[str, Any]


def _partials(qr, k, v, mask, scale, softcap=None):
    """Flash accumulators of ``qr`` against one KV block.

    qr [S, Ls, n_kv, g, hd]; k/v [S, Lk, n_kv, hd] or [Lk, n_kv, hd]
    (shared); mask broadcastable to [S, Ls, Lk]. Returns m, l
    [S, n_kv, g, Ls, 1] and acc [S, n_kv, g, Ls, hd_v], all float32.
    ``softcap`` (Gemma 2) caps the scaled scores before the mask; tanh is
    monotone, so capping per block commutes with the merge."""
    shared = k.dim() == 3
    eq = "sqngh,knh->sngqk" if shared else "sqngh,sknh->sngqk"
    s = _softcap(torch.einsum(eq, qr, k).float() * scale, softcap)
    s = torch.where(mask[:, None, None], s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    ev = "sngqk,knh->sngqh" if shared else "sngqk,sknh->sngqh"
    return m, l, torch.einsum(ev, p.to(v.dtype), v).float()


def _merge(parts, device):
    """Accumulator sets [(m, l, acc)] as one set on ``device``: the largest
    max and the sums corrected to it (over the ranks, JAX's
    ``pmax``/``psum``)."""
    parts = [tuple(t.to(device) for t in part) for part in parts]
    m = parts[0][0]
    for m_i, _, _ in parts[1:]:
        m = torch.maximum(m, m_i)
    l = acc = None
    for m_i, l_i, acc_i in parts:
        c = torch.exp(m_i - m)
        l = l_i * c if l is None else l + l_i * c
        acc = acc_i * c if acc is None else acc + acc_i * c
    return m, l, acc


def _joint(sets, n_heads: int, v_dim: int, dtype: torch.dtype) -> torch.Tensor:
    """Accumulator sets merged into one softmax's output:
    [S, n_kv, g, Lq, hd_v] -> [S, Lq, n_q, hd_v] in ``dtype``."""
    _, l, acc = _merge(sets, sets[0][0].device)
    out = acc / torch.clamp(l, min=1e-30)
    s_cnt, lq = out.shape[0], out.shape[3]
    return out.permute(0, 3, 1, 2, 4).reshape(s_cnt, lq, n_heads, v_dim).to(dtype)


def sharded_prefix_suffix_layer(params: Sequence[Params], cfg: LlamaConfig, mesh: DeviceMesh,
                                prefix_x: Sequence[torch.Tensor], suffix_h: torch.Tensor,
                                prefix_len: int, sliding=False, rope_on=True,
                                return_kv: bool = False, total_len=None):
    """One decoder layer of the long-context scoring step.

    ``params``: the layer per rank (``parallel.sharding.replicate``);
    prefix_x: the prefix [L, D] sharded over the mesh (a block per rank on
    its device); suffix_h [S, Ls, D] on the first rank's device;
    ``prefix_len`` the true prefix length. Semantics are
    ``llama.prefix_suffix_layer``'s: every suffix sees one joint softmax
    over the real prefix keys and its own causal keys at positions
    ``prefix_len + i``, within the layer's window or chunk at absolute
    positions. ``sliding``/``rope_on`` are the layer's flags, ``total_len``
    longrope's real length. Returns (prefix_out blocks, suffix_out) and,
    with ``return_kv``, the post-rope KV {'kp','vp': blocks per rank,
    'ks','vs' [S, Ls, n_kv, hd]}.
    """
    s_cnt, ls, _ = suffix_h.shape
    dev0 = suffix_h.device
    scale, softcap = cfg.attn_scale, cfg.attn_logit_softcap
    window, chunk = local_form(cfg, sliding)
    local = window is not None or chunk is not None

    prefix_out, k_blks, v_blks = ring_decoder_blocks(params, cfg, prefix_x, mesh, sliding,
                                                     rope_on, total_len)

    p0 = params[0]
    hs = llama._norm(suffix_h, p0["input_layernorm"], cfg)
    pos_s = prefix_len + torch.arange(ls, device=dev0)
    qs, ks, vs = llama.positioned_qkv(p0, cfg, hs, pos_s, sliding, total_len, rope_on)
    n_kv = cfg.num_key_value_heads
    g = cfg.num_attention_heads // n_kv
    qr = qs.reshape(s_cnt, ls, n_kv, g, cfg.head_dim)

    # Each rank's partial softmax over its prefix-KV block, merged.
    parts = []
    for r, dev in enumerate(mesh.devices):
        lblk = k_blks[r].shape[0]
        kj = (r * lblk + torch.arange(lblk, device=dev))[None, None, :]  # global key position
        vis = kj < prefix_len
        if local:
            qi = prefix_len + torch.arange(ls, device=dev)[None, :, None]
            vis = _local_clause(vis, qi, kj, window, None, chunk)
        mask = vis.expand(s_cnt, ls, lblk)
        parts.append(_partials(qr.to(dev), k_blks[r], v_blks[r], mask, scale, softcap))
    prefix_set = _merge(parts, dev0)

    # The suffix's own block: causal, its local clause at absolute positions
    # (the window's offsets cancel the prefix_len shift; chunk boundaries
    # do not).
    qi = torch.arange(ls, device=dev0)[:, None]
    kj = torch.arange(ls, device=dev0)[None, :]
    suffix_mask = kj <= qi
    if local:
        suffix_mask = _local_clause(suffix_mask, prefix_len + qi, prefix_len + kj, window, None,
                                    chunk)
    suffix_set = _partials(qr, ks, vs, suffix_mask[None], scale, softcap)

    attn_s = _joint([prefix_set, suffix_set], n_kv * g, cfg.v_dim, suffix_h.dtype)
    suffix_out = llama._residual_mlp([p0], cfg, llama._residual_attn(p0, cfg, suffix_h, attn_s))
    if return_kv:
        return prefix_out, suffix_out, {"kp": k_blks, "vp": v_blks, "ks": ks, "vs": vs}
    return prefix_out, suffix_out


def sharded_decode_layer(params: Sequence[Params], cfg: LlamaConfig, mesh: DeviceMesh,
                         x: torch.Tensor, kv: Params, prefix_len: int, suffix_eos: torch.Tensor,
                         t: int, sliding=False, rope_on=True):
    """One decoder layer for ONE new token per suffix against cached KV
    whose prefix region is sharded over the mesh (``llama.decode_step_layer``'s
    semantics: one joint softmax over prefix, suffix and generated keys).

    x [S, 1, D] on the first rank's device; kv {'kp','vp': prefix blocks
    per rank; 'ks','vs' [S, Ls, n_kv, hd]; 'kg','vg' [S, T, n_kv, hd]} (V
    at ``cfg.v_dim``); suffix_eos int [S]; ``t`` the generated slot. The
    fed token of suffix s sits at position prefix_len + suffix_eos[s] + 1 +
    t; its k/v are written into slot t of kv['kg']/kv['vg'] in place (JAX
    donates the cache). Returns (x_out [S, 1, D], kv)."""
    s_cnt = x.shape[0]
    dev0 = x.device
    scale, softcap = cfg.attn_scale, cfg.attn_logit_softcap
    window, chunk = local_form(cfg, sliding)
    local = window is not None or chunk is not None
    p0 = params[0]
    eos = suffix_eos.to(dev0).long()

    h = llama._norm(x, p0["input_layernorm"], cfg)
    pos = (prefix_len + eos + 1 + t)[:, None]  # [S, 1]
    # longrope: each suffix's real length at this step (one regime per run).
    tl = pos[:, -1] + 1 if cfg.rope_scaling_kind == "longrope" else None
    q, k_new, v_new = llama.positioned_qkv(p0, cfg, h, pos, sliding, tl, rope_on)
    kv["kg"][:, t] = k_new[:, 0]
    kv["vg"][:, t] = v_new[:, 0]

    n_kv = cfg.num_key_value_heads
    g = cfg.num_attention_heads // n_kv
    qr = q.reshape(s_cnt, 1, n_kv, g, cfg.head_dim)
    q_abs = pos[:, :, None]  # [S, 1, 1]

    parts = []
    for r, dev in enumerate(mesh.devices):
        kp = kv["kp"][r]
        lblk = kp.shape[0]
        kj = (r * lblk + torch.arange(lblk, device=dev))[None, None, :]
        vis = (kj < prefix_len).expand(s_cnt, 1, lblk)
        if local:
            vis = _local_clause(vis, q_abs.to(dev), kj, window, None, chunk)
        parts.append(_partials(qr.to(dev), kp, kv["vp"][r], vis, scale, softcap))
    prefix_set = _merge(parts, dev0)

    # The suffix region: keys j <= eos at absolute positions prefix_len + j.
    ls = kv["ks"].shape[1]
    kj = torch.arange(ls, device=dev0)[None, None, :]
    vis = (kj <= eos[:, None, None]).expand(s_cnt, 1, ls)
    if local:
        vis = _local_clause(vis, q_abs, prefix_len + kj, window, None, chunk)
    suffix_set = _partials(qr, kv["ks"], kv["vs"], vis, scale, softcap)

    # The generated region: keys j <= t at prefix_len + eos + 1 + j.
    tm = kv["kg"].shape[1]
    kj = torch.arange(tm, device=dev0)[None, None, :]
    vis = (kj <= t).expand(s_cnt, 1, tm)
    if local:
        vis = _local_clause(vis, q_abs, prefix_len + eos[:, None, None] + 1 + kj, window, None,
                            chunk)
    gen_set = _partials(qr, kv["kg"], kv["vg"], vis, scale, softcap)

    attn = _joint([prefix_set, suffix_set, gen_set], n_kv * g, cfg.v_dim, x.dtype)
    return llama._residual_mlp([p0], cfg, llama._residual_attn(p0, cfg, x, attn)), kv


class LongContextScorer:
    """Scores prompts whose prefix exceeds one device's ``max_token_len``.

    One prompt at a time (its suffixes together): the prefix is sharded
    over an ``sp`` mesh of ``devices`` (default: every card), so the cap
    is ``len(devices) * max_token_len`` and the prefix bucket a multiple
    of ``bucket_multiple * len(devices)``. The weights stream shard by
    shard through one source for the whole call, replicated on each
    distinct device, with the single-device source's host cache,
    readahead, retries, fault injector, integrity checks and residency
    tier. ``stats`` holds the JAX scorer's keys (``total_wall_s``,
    ``load_weights_time_s``) and what the CLI's stats line sums
    (``tokens_processed``, ``streamed_bytes``, ``source_wait_s``,
    ``compute_wall_s``, the host-path counters, ``peak_mem_gb``).
    """

    def __init__(self, cfg: FrameworkConfig, devices=None, tokenizer=None):
        obs_trace.ensure_configured(cfg)
        REGISTRY.register("longcontext", weak_source(self))
        self.cfg = cfg
        self.model_cfg = LlamaConfig.from_pretrained(cfg.model_path)
        devices = list(devices) if devices else None
        self.mesh = make_mesh({"sp": len(devices) if devices else -1}, devices=devices)
        self.sp = self.mesh.size
        self.dtype = cfg.torch_dtype
        self.cap = self.sp * cfg.max_token_len
        if tokenizer is None:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(cfg.model_path)
        self.raw_tokenizer = tokenizer  # the decoder decodes picked ids with it
        self.tokenizer = PromptTokenizer(tokenizer, max_token_len=self.cap,
                                         bucket_multiple=cfg.bucket_multiple * self.sp)
        self.layer_names = checkpoint.layer_names_for(self.model_cfg.num_hidden_layers)
        self.plan = plan_shards_dp(len(self.layer_names), cfg.layer_num_per_shard)
        self._slots = [self.mesh.slot(r) for r in range(self.sp)]
        self._sliding = llama.layer_sliding_pattern(self.model_cfg)
        self._rope = llama.layer_rope_pattern(self.model_cfg)
        self.stats: dict[str, float] = {}
        self.stats_history: list[dict[str, float]] = []

    def _make_source(self, repeats: int):
        """ONE weight source for a whole call (the shard list repeated
        ``repeats`` times), and the baselines of its host-path stats."""
        cfg = self.cfg
        distinct = self.mesh.distinct
        cache = cache_for(cfg)
        tier = residency.tier_for(cfg, self.layer_names, self.model_cfg.tie_word_embeddings,
                                  residency.probe_chip(distinct))
        stats = StreamStats(cache, tier, distinct[0])
        source = ShardWeightSource(
            cfg.model_path, self.layer_names, list(self.plan.shards) * max(repeats, 1),
            self.dtype, distinct[0], cfg.prefetch_depth, self.model_cfg.tie_word_embeddings,
            verify_weights=cfg.verify_weights, host_cache=cache,
            readahead_threads=cfg.readahead_threads, retry_policy=cfg.retry_policy(),
            residency=tier, injector=FaultInjector.from_config(cfg.faults), replicas=distinct,
        )
        return source, stats, tier

    def _sweep(self, stream, timer):
        """The next shard: (first decoder index, segments with each
        segment's params listed per rank)."""
        t0 = time.perf_counter()
        layer_idxs, per_device = next(stream)
        timer["source_wait_s"] += time.perf_counter() - t0
        segments = [(kind, [per_device[s][j][1] for s in self._slots])
                    for j, (kind, _) in enumerate(per_device[0])]
        return first_decoder(layer_idxs), segments

    def _sync(self) -> None:
        for dev in self.mesh.distinct:
            sync(dev)

    def _prompt_inputs(self, prefix: str, suffixes: tuple, extra_len: int = 0):
        """The tokenized prompt and its device inputs: the prefix ids
        sharded over the mesh, suffix ids and eos on the first device."""
        t = self.tokenizer(prefix, suffixes)
        # Parked prefix KV cannot be re-rotated mid-generation: fed
        # positions must not cross the longrope boundary.
        check_longrope_regime(self.model_cfg, [t], extra_len=extra_len)
        # The prefix bucket must split evenly over the ring.
        lp = bucket_len(len(t.prefix_ids), self.cfg.bucket_multiple * self.sp, self.cap)
        ids = np.full((lp,), self.tokenizer.pad_id, np.int32)
        ids[: len(t.prefix_ids)] = t.prefix_ids
        dev0 = self.mesh.devices[0]
        prefix_ids = shard(torch.from_numpy(ids), self.mesh)
        suffix_ids = torch.from_numpy(t.suffix_ids).to(dev0)
        suffix_eos = torch.from_numpy(t.suffix_eos).to(dev0)
        total_len = None
        if self.model_cfg.rope_scaling_kind == "longrope":
            total_len = t.prefix_len + int(t.suffix_eos[: t.num_suffixes].max()) + 1
        return t, prefix_ids, suffix_ids, suffix_eos, total_len

    def _prefill(self, t, inputs, stream, timer, park: list | None = None):
        """One sharded forward over every shard: the head's distributions
        [S_true, V] as float32 numpy. With ``park``, each layer's KV is
        appended to it."""
        _, prefix_ids, suffix_ids, suffix_eos, total_len = inputs
        mc = self.model_cfg
        prefix_x = suffix_h = scores = None
        for _ in range(len(self.plan.shards)):
            first, segments = self._sweep(stream, timer)
            t0 = time.perf_counter()
            for kind, params in segments:
                if kind == "embed":
                    prefix_x = [llama.embed(p, ids, self.dtype, mc)
                                for p, ids in zip(params, prefix_ids)]
                    suffix_h = llama.embed(params[0], suffix_ids, self.dtype, mc)
                elif kind == "decoders":
                    for i in range(len(params[0])):
                        layer = [p[i][0] for p in params]  # each device's one rank
                        out = sharded_prefix_suffix_layer(
                            layer, mc, self.mesh, prefix_x, suffix_h, t.prefix_len,
                            sliding=self._sliding[first + i], rope_on=self._rope[first + i],
                            return_kv=park is not None, total_len=total_len)
                        prefix_x, suffix_h = out[0], out[1]
                        if park is not None:
                            park.append(out[2])
                elif kind == "norm":
                    suffix_h = llama.select_eos_and_norm(params[0], mc, suffix_h[None],
                                                         suffix_eos[None])[0]
                    prefix_x = None
                else:  # head
                    scores = llama.lm_head_scores(params[0], suffix_h, mc.final_logit_softcap)
            self._sync()
            timer["compute_wall_s"] += time.perf_counter() - t0
        return scores[: t.num_suffixes].cpu().numpy()

    def _finish(self, t_start: float, source, host_stats, tier, timer, tokens: float) -> None:
        self.stats = {
            "total_wall_s": time.perf_counter() - t_start,
            "load_weights_time_s": source.load_time,
            "tokens_processed": tokens,
            "streamed_bytes": float(source.bytes_loaded),
            **timer,
            **host_stats.read(source),
        }
        peak = peak_over(self.mesh.distinct, tier)
        if peak is not None:
            self.stats["peak_mem_gb"] = peak
        self.stats_history.append(dict(self.stats))

    def __call__(self, prompts) -> list[np.ndarray]:
        """One float32 [n_suffixes, 1, vocab] array per prompt."""
        t_start = time.perf_counter()
        prompts = list(prompts)
        source, host_stats, tier = self._make_source(len(prompts))
        stream = iter(source)
        timer = {"source_wait_s": 0.0, "compute_wall_s": 0.0}
        out, tokens = [], 0.0
        try:
            for prefix, suffixes in prompts:
                inputs = self._prompt_inputs(prefix, suffixes)
                out.append(self._prefill(inputs[0], inputs, stream, timer)[:, None])
                tokens += inputs[0].tokens_processed
        finally:
            source.close()
        self._finish(t_start, source, host_stats, tier, timer, tokens)
        return out


class LongContextDecoder(LongContextScorer):
    """KV-cache decode for prompts whose prefix exceeds one device's cap.

    The prefill is the scorer's sharded forward, parking every layer's KV
    (the prefix's blocks on their ranks' devices, the suffix and generated
    regions on the first); each of the ``num_gen_token - 1`` decode steps
    streams the weights once more and runs :func:`sharded_decode_layer` per
    layer, then the norm and the head. Tokens are picked by the shared
    picker (greedy, or sampled with one rng per call seeded from
    ``cfg.seed``); fed ids pad with the first row's token; the updated
    suffixes append the raw tokenizer's decode of the picked ids.
    """

    def __call__(self, prompts):
        """(scores, updated_prompts, tokens_processed), the
        ``orchestration.run_decode`` contract: scores[i] float32
        [n_suffixes, num_gen_token, vocab]."""
        t_start = time.perf_counter()
        prompts = list(prompts)
        n_gen = max(self.cfg.num_gen_token, 1)
        # Prefill and n_gen - 1 decode streams per prompt, in order.
        source, host_stats, tier = self._make_source(max(len(prompts), 1) * n_gen)
        stream = iter(source)
        timer = {"source_wait_s": 0.0, "compute_wall_s": 0.0}
        pick = make_picker(self.cfg)
        scores_out, updated, tokens = [], [], 0.0
        try:
            for prefix, suffixes in prompts:
                dists, hist, tp = self._generate_one(prefix, suffixes, stream, n_gen, pick, timer)
                scores_out.append(dists)
                updated.append((prefix, tuple(s + self.raw_tokenizer.decode(hist[i])
                                              for i, s in enumerate(suffixes))))
                tokens += tp
        finally:
            source.close()
        self._finish(t_start, source, host_stats, tier, timer, tokens)
        return scores_out, updated, int(tokens)

    def _generate_one(self, prefix: str, suffixes: tuple, stream, n_gen: int, pick, timer):
        # The last generated token is never fed back, hence n_gen - 1.
        inputs = self._prompt_inputs(prefix, suffixes, extra_len=max(n_gen - 1, 0))
        t, suffix_eos = inputs[0], inputs[3]
        mc = self.model_cfg
        dev0 = self.mesh.devices[0]
        s_cnt = t.suffix_ids.shape[0]
        kv_layers: list[Params] = []
        dists = [self._prefill(t, inputs, stream, timer, park=kv_layers)]
        slots = max(1, n_gen - 1)
        for kv in kv_layers:
            # Head count and dims from the layer's own KV (MLA: V's dim).
            kv["kg"] = torch.zeros((s_cnt, slots, *kv["ks"].shape[-2:]), dtype=self.dtype,
                                   device=dev0)
            kv["vg"] = torch.zeros((s_cnt, slots, *kv["vs"].shape[-2:]), dtype=self.dtype,
                                   device=dev0)

        hist_rows = [pick(dists[-1])]  # [S_true] per emitted step
        for step in range(n_gen - 1):
            last = hist_rows[-1]
            ids = np.full((s_cnt, 1), int(last[0]) if len(last) else 0, np.int64)
            ids[: t.num_suffixes, 0] = last
            ids = torch.from_numpy(ids).to(dev0)
            x = norm = None
            li = 0
            for _ in range(len(self.plan.shards)):
                first, segments = self._sweep(stream, timer)
                t0 = time.perf_counter()
                for kind, params in segments:
                    if kind == "embed":
                        x = llama.embed(params[0], ids, self.dtype, mc)
                    elif kind == "decoders":
                        for i in range(len(params[0])):
                            x, kv_layers[li] = sharded_decode_layer(
                                [p[i][0] for p in params], mc, self.mesh, x, kv_layers[li],
                                t.prefix_len, suffix_eos, step,
                                sliding=self._sliding[first + i], rope_on=self._rope[first + i])
                            li += 1
                    elif kind == "norm":
                        norm = params[0]
                    else:  # head
                        normed = rms_norm(x, norm["scale"], mc.rms_norm_eps, mc.norm_unit_offset)
                        dists.append(llama.lm_head_scores(params[0], normed,
                                                          mc.final_logit_softcap)
                                     [: t.num_suffixes].cpu().numpy())
                self._sync()
                timer["compute_wall_s"] += time.perf_counter() - t0
            hist_rows.append(pick(dists[-1]))

        hist = np.stack(hist_rows, axis=1)  # [S_true, n_gen]
        scores = np.stack(dists, axis=1)  # [S_true, n_gen, V]
        return scores, hist, float(t.tokens_processed + t.num_suffixes * max(n_gen - 1, 0))


def prefix_token_count(tokenizer, prefix: str) -> int:
    """Untruncated prefix token count: the long-context routing predicate."""
    return len(tokenizer(prefix)["input_ids"])


__all__ = [
    "LongContextDecoder",
    "LongContextScorer",
    "prefix_token_count",
    "sharded_decode_layer",
    "sharded_prefix_suffix_layer",
]
