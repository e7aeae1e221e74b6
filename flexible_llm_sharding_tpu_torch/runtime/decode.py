"""KV-cache decode: multi-token generation with KV reuse across tokens (the
JAX package's ``runtime/decode.py``, single-device part).

Prefill runs one streaming pass in which every decoder layer also returns
its post-rope KV, parked per (shard, layer, block). Each decode step then
runs only the newest token of every suffix through each layer, against the
parked KV, through the decode kernel. Token ids are appended directly (no
decode/re-encode round trip); the ``_updated`` text decodes the id history.
Every pass reads through the same host path as scoring (verified reads,
retries, readahead, the process host shard cache).

The decode modes, with the JAX batch CLI's defaults:

- **Weights-resident decode** (``decode_resident``): when the model fits
  the card, the shards placed by the prefill pass stay referenced, and
  every decode step walks them with no weight transfer; one weight pass is
  streamed instead of ``num_gen_token``. Otherwise each step streams the
  weights again, the design's point: the device then holds one shard.
- **KV beside the weights** (``SchedCore.kv_on_device``): the KV stays on
  the card with ``storage_location='gpu'``, or when the model is resident
  and weights plus KV fit; otherwise it waits in host RAM.
- **Fused greedy steps** (``decode_fused``): resident and greedy, a
  block's decode steps run on the device back to back (embed the previous
  pick, every layer, norm and head, ``torch.argmax`` on the device) and
  their distributions and picks reach the host once per block. On the card
  the steps are captured as one CUDA graph per block and replayed, unless
  the model has MoE layers (their expert grouping reads counts to the
  host); ``decode_graph`` reports which.
- **Speculative verify passes** (``speculative_k``): each pass feeds the
  last accepted token plus K prompt-lookup drafts per suffix through one
  walk of the model and accepts the longest draft prefix the greedy chain
  confirms, emitting 1..K+1 tokens (:class:`SpecVerifier`).

A streamed decode (not resident) takes the process residency tier: every
pass, the prefill's and each step's, skips the pinned layers. A resident
decode does not, as in the JAX package: every placed shard stays already.

The per-shard pieces (:func:`prefill_decoders`, :func:`suffix_prefill_decoders`,
:func:`decode_decoders`, :func:`decode_norm_head`, :func:`spec_norm_head`) and
:class:`SpecVerifier` are shared with the serving
engine (``serve/engine.py``), which runs them per wave at each shard of its
weight sweeps, with a wave's LoRA shift (``delta``) where it carries
adapters.

The multi-device modes (the JAX generator's ``mp_devices`` and
``weight_source_factory``): over ``mp_devices`` (more than one) each
interleaved stage's weights and parked KV live on its own device, the
stages run in order every pass, their activations hopping to the next
stage's device, and the fused steps stand down (one placement is their
precondition). A DP rank takes its passes from its broadcast view
(``weight_source_factory``) with the ``resident`` decision the source's
round count was built for.

Tensor parallelism (``device`` a ``parallel/sharding.TpPlacement``): the
weights of every pass are Megatron-split over the placement's devices, each
rank keeps its own KV heads on its device, and the activations stay on the
first device. The fused steps run as on one device; they are captured in
one CUDA graph only where every rank shares one card (``[cuda:0] * tp``).
Across distinct cards the same steps run eagerly, since one capture does
not span devices; the tokens are the same either way.
"""

from __future__ import annotations

import contextlib
import inspect
import itertools
import threading
import time
from typing import Any

import numpy as np
import torch

from flexible_llm_sharding_tpu_torch.adapters.apply import lora_shift_rows
from flexible_llm_sharding_tpu_torch.config import indexed_device
from flexible_llm_sharding_tpu_torch.models import llama
from flexible_llm_sharding_tpu_torch.obs import trace as obs_trace
from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa
from flexible_llm_sharding_tpu_torch.ops.norm import rms_norm
from flexible_llm_sharding_tpu_torch.faults.inject import FaultInjector
from flexible_llm_sharding_tpu_torch.parallel.planner import global_stage_order
from flexible_llm_sharding_tpu_torch.runtime import residency
from flexible_llm_sharding_tpu_torch.runtime.executor import (
    StreamingExecutor,
    StreamStats,
    _tree_map,
    block_meta,
    first_decoder,
    note_rank_bytes,
    peak_over,
    sync,
)
from flexible_llm_sharding_tpu_torch.runtime.generation import make_picker
from flexible_llm_sharding_tpu_torch.runtime.schedcore import SchedCore
from flexible_llm_sharding_tpu_torch.runtime.tokenization import (
    check_longrope_regime,
    longrope_total_len,
    make_blocks,
)
from flexible_llm_sharding_tpu_torch.utils import metrics

# propose_draft scans at most this many trailing tokens of each haystack:
# the lookup wants the last occurrence, and a bounded scan keeps the draft
# cost per pass constant (verification is draft-agnostic either way).
DRAFT_SCAN_WINDOW = 512


def propose_draft(context_ids, k: int, ngram: int = 2, corpus=None) -> np.ndarray:
    """Prompt-lookup drafting: find the last earlier occurrence of the
    context's final n-gram (n from ``ngram`` down to 1) and propose the
    tokens that followed it; ``corpus`` (the sibling suffixes' contexts) is
    searched when the context itself has no match. Returns exactly ``k``
    ids, padded by repeating the last token."""
    ids = np.asarray(context_ids, np.int64)
    pools = [np.asarray(c, np.int64) for c in (corpus or ())]
    n = len(ids)
    draft: list[int] = []
    for g in range(min(ngram, n - 1), 0, -1):
        tail = ids[n - g:]
        # Own context first (excluding the tail's own position), then each
        # sibling pool, every window of which is "earlier".
        for hay, pool in [(ids[: n - 1], ids)] + [(p, p) for p in pools]:
            if len(hay) < g:
                continue
            off = max(0, len(hay) - DRAFT_SCAN_WINDOW)
            win = np.lib.stride_tricks.sliding_window_view(hay[off:], g)
            hits = np.flatnonzero((win == tail[None, :]).all(axis=1))
            # The last match with a nonempty continuation.
            for start in hits[::-1]:
                start = off + int(start)
                cont = pool[start + g: start + g + k]
                if len(cont):
                    draft = [int(c) for c in cont]
                    break
            if draft:
                break
        if draft:
            break
    while len(draft) < k:
        draft.append(int(draft[-1] if draft else ids[-1]))
    return np.asarray(draft[:k], np.int64)


def draft_contexts(tps, t0) -> list[list[np.ndarray]]:
    """[B][S] initial draft contexts of a block: real prefix, real suffix and
    the prefill's pick, per tokenized prompt ``tps[r]`` and picks ``t0``
    [B, S]."""
    return [
        [np.concatenate([tp.prefix_ids[: tp.prefix_len],
                         tp.suffix_ids[s][: int(tp.suffix_eos[s]) + 1], [int(t0[r, s])]])
         for s in range(tp.suffix_ids.shape[0])]
        for r, tp in enumerate(tps)
    ]


class SpecVerifier:
    """The K+1-slot verification state of one block.

    Each pass feeds, per suffix, the last accepted token plus ``spec_k``
    drafts, then accepts the longest draft prefix matching the argmax chain
    and emits 1..K+1 tokens: exactly what sequential greedy decode emits,
    whatever the drafts. Suffixes accept different counts, so each keeps
    its own generated-KV slot clock (``g - 1`` is the offset the next pass
    writes from). Padding rows (``active`` False) are frozen at their
    budget with constant histories and never draft or count.

    :meth:`set_pass_k` caps each row's drafts per pass (the serving
    engine's adaptive depth); :meth:`request_steps` reads one request's
    rows step by step. ``last_drafted``/``last_accepted`` [B, S] hold the
    latest pass's per-row counts.
    """

    def __init__(self, spec_k: int, draft_fn, contexts, budgets, init_dist, init_toks,
                 active=None):
        self.k = spec_k
        self._draft = draft_fn if draft_fn is not None else propose_draft
        try:
            self._corpus_ok = "corpus" in inspect.signature(self._draft).parameters
        except (TypeError, ValueError):
            self._corpus_ok = False
        self.budgets = np.asarray(budgets, np.int64)
        bsz, s_b = self.budgets.shape
        self.active = (np.asarray(active, bool) if active is not None
                       else np.ones((bsz, s_b), bool))
        self.ctx = [[np.asarray(contexts[r][s], np.int64) for s in range(s_b)]
                    for r in range(bsz)]
        self.g = np.ones((bsz, s_b), np.int64)
        self.hist_d = [[[init_dist[r, s]] for s in range(s_b)] for r in range(bsz)]
        self.hist_t = [[[int(init_toks[r, s])] for s in range(s_b)] for r in range(bsz)]
        self.drafted = self.accepted = self.rejected = self.passes = 0
        for r in range(bsz):
            for s in range(s_b):
                if not self.active[r, s]:
                    bud = int(self.budgets[r, s])
                    self.g[r, s] = bud
                    self.hist_d[r][s] = [init_dist[r, s]] * bud
                    self.hist_t[r][s] = [int(init_toks[r, s])] * bud
        self._drafts = None
        self._pass_k = None  # per-row draft caps [B, S]; None: spec_k everywhere
        self.last_drafted = np.zeros((bsz, s_b), np.int64)
        self.last_accepted = np.zeros((bsz, s_b), np.int64)

    def set_pass_k(self, karr) -> None:
        """Cap the next passes' drafts per row at ``karr`` [B, S], clipped
        to [0, spec_k] (None: spec_k everywhere). The fed window stays K+1
        wide; a row capped at k drafts and verifies only its first k slots
        (0: one token per pass), and acceptance counts only the slots
        asked for."""
        if karr is None:
            self._pass_k = None
            return
        self._pass_k = np.clip(np.asarray(karr, np.int64), 0, self.k).reshape(self.g.shape)

    def _k_use(self, r: int, s: int) -> int:
        return self.k if self._pass_k is None else int(self._pass_k[r, s])

    @property
    def done(self) -> bool:
        return bool((self.g >= self.budgets).all())

    def emitted(self, r: int, s: int) -> int:
        """Tokens emitted so far for one suffix, the prefill's included."""
        return int(self.g[r, s])

    def begin_pass(self) -> tuple[np.ndarray, np.ndarray]:
        """This pass's fed tokens [B, S, K+1] int64 and per-suffix slot
        offsets [B, S] int32. A suffix drafts only while an accepted token
        could still be emitted (more than one left)."""
        bsz, s_b = self.g.shape
        fed = np.zeros((bsz, s_b, self.k + 1), np.int64)
        drafts = np.zeros((bsz, s_b, self.k), np.int64)
        for r in range(bsz):
            for s in range(s_b):
                fed[r, s, 0] = self.hist_t[r][s][-1]
                k_use = self._k_use(r, s)
                if k_use > 0 and self.budgets[r, s] - self.g[r, s] > 1:
                    if self._corpus_ok:
                        sib = [self.ctx[r][j] for j in range(s_b) if j != s and self.active[r, j]]
                        drafts[r, s, :k_use] = self._draft(self.ctx[r][s], k_use, corpus=sib)
                    else:
                        drafts[r, s, :k_use] = self._draft(self.ctx[r][s], k_use)
        fed[:, :, 1:] = drafts
        self._drafts = drafts
        return fed, (self.g - 1).astype(np.int32)

    def finish_pass(self, dist: np.ndarray) -> np.ndarray:
        """Accept against the pass's distributions [B, S, K+1, V]. Returns
        the tokens emitted per suffix [B, S]. The counters count only the
        useful draft slots (at most remaining - 1 drafts can be emitted)."""
        assert self._drafts is not None, "finish_pass without begin_pass"
        self.passes += 1
        picks = np.argmax(dist, axis=-1)  # [B, S, K+1]
        bsz, s_b = self.g.shape
        emitted = np.zeros((bsz, s_b), np.int64)
        self.last_drafted.fill(0)
        self.last_accepted.fill(0)
        for r in range(bsz):
            for s in range(s_b):
                if self.g[r, s] >= self.budgets[r, s]:
                    continue
                k_use = self._k_use(r, s)
                a = 0
                while a < k_use and picks[r, s, a] == self._drafts[r, s, a]:
                    a += 1
                remaining = int(self.budgets[r, s] - self.g[r, s])
                useful_k = min(k_use, remaining - 1)
                acc = min(a, useful_k)
                self.drafted += useful_k
                self.accepted += acc
                self.rejected += useful_k - acc
                self.last_drafted[r, s] = useful_k
                self.last_accepted[r, s] = acc
                emit = int(min(a + 1, remaining))
                for j in range(emit):
                    # A copy: a view would keep the whole pass's array alive.
                    self.hist_d[r][s].append(dist[r, s, j].copy())
                    self.hist_t[r][s].append(int(picks[r, s, j]))
                self.ctx[r][s] = np.concatenate([self.ctx[r][s], picks[r, s, :emit]])
                self.g[r, s] = min(self.g[r, s] + a + 1, self.budgets[r, s])
                emitted[r, s] = emit
        self._drafts = None
        return emitted

    def request_steps(self, row: int, s_off: int, s_cnt: int,
                      n_steps: int) -> tuple[list[np.ndarray], list[np.ndarray]]:
        """One request's suffix rows ``s_off:s_off + s_cnt`` of block row
        ``row``, step by step: ``n_steps`` [s_cnt, V] scores and [s_cnt]
        int64 tokens (the engine's resolve and preemption capture)."""
        scores = [np.stack([self.hist_d[row][s_off + s][t] for s in range(s_cnt)])
                  for t in range(n_steps)]
        toks = [np.asarray([self.hist_t[row][s_off + s][t] for s in range(s_cnt)], np.int64)
                for t in range(n_steps)]
        return scores, toks

    def step_major(self, n_steps: int) -> tuple[list[np.ndarray], list[np.ndarray]]:
        """The ragged histories as ``n_steps`` [B, S, V] distributions and
        [B, S] tokens."""
        bsz, s_b = self.g.shape
        dists = [np.stack([[self.hist_d[r][s][i] for s in range(s_b)] for r in range(bsz)])
                 for i in range(n_steps)]
        toks = [np.array([[self.hist_t[r][s][i] for s in range(s_b)] for r in range(bsz)])
                for i in range(n_steps)]
        return dists, toks


def block_kv_bytes(model_cfg, dtype_name: str, toks, idxs, gen_slots: int) -> float:
    """Decode KV bytes of one block (every layer, compute dtype)."""
    t0 = toks[idxs[0]]
    s_b, ls = t0.suffix_ids.shape
    lp = t0.prefix_ids.shape[-1]
    per_layer = (
        2  # k and v
        * len(idxs)
        * (lp + s_b * (ls + gen_slots))
        * model_cfg.num_key_value_heads
        * (model_cfg.head_dim + model_cfg.v_dim) / 2  # K/V dims differ under MLA
    )
    return per_layer * model_cfg.num_hidden_layers * metrics._DTYPE_BYTES[dtype_name]


def kv_fits_on_chip(model_cfg, dtype_name: str, toks, blocks, gen_slots: int, device=None,
                    n_chips: int = 1) -> bool:
    """Whether every block's decode KV fits on the card beside the resident
    weights: weights + KV within 80% of its known memory (off when it is
    unknown)."""
    hbm_gb = metrics.chip_hbm_gb(device)
    if not hbm_gb:
        return False
    kv_bytes = sum(block_kv_bytes(model_cfg, dtype_name, toks, i, gen_slots) for i in blocks)
    weights = metrics.weight_bytes_per_chip(model_cfg, dtype_name, n_chips)
    return weights + kv_bytes <= 0.8 * hbm_gb * 1e9


def extend_gen_kv(kv: list[dict], gen_slots: int) -> list[dict]:
    """A prefill layer's KV (each rank's dict) with ``gen_slots`` empty
    generated-token slots (``kg``/``vg`` [B, S, gen_slots, n_kv, hd])
    beside its own KV, V at its own head dim (MLA), on the rank's
    device."""
    def gen(like: torch.Tensor) -> torch.Tensor:
        return like.new_zeros(*like.shape[:2], gen_slots, *like.shape[3:])

    return [{**k, "kg": gen(k["ks"]), "vg": gen(k["vs"])} for k in kv]


class KVStore:
    """Per-key KV dicts and activations, on the device they were made on
    (``on_device``) or in host RAM; ``get`` removes them and returns them on
    ``device``, or by default each tensor on the device it was made on (a
    tensor-parallel rank's KV on its own)."""

    def __init__(self, on_device: bool, device: torch.device):
        self.on_device = on_device
        self.device = device
        self._mem: dict[tuple, Any] = {}

    def put(self, key: tuple, tree) -> None:
        if self.on_device:
            self._mem[key] = (tree, None)
            return
        homes: list[torch.device] = []
        self._mem[key] = (_tree_map(lambda t: homes.append(t.device) or t.to("cpu"), tree), homes)

    def get(self, key: tuple, device: torch.device | None = None):
        tree, homes = self._mem.pop(key)
        if device is not None:
            return _tree_map(lambda t: t.to(device), tree)
        if homes is None:
            return tree
        home = iter(homes)
        return _tree_map(lambda t: t.to(next(home)), tree)

    def clear(self) -> None:
        self._mem.clear()


def _shift(delta, i: int, h):
    """Layer ``i``'s LoRA shift of ``h`` (``adapters/apply.lora_shift_rows``)."""
    return lora_shift_rows(h, delta["pairs"][i], delta["g"], delta["scale"])


def prefill_decoders(model_cfg, layers, first: int, prefix_h, suffix_h, prefix_len, total_len,
                     sliding, rope_on, delta=None, *, use_pallas: bool):
    """A shard's decoder layers over a block's prefill (the JAX package's
    ``_prefill_decoders``): ``layers`` the shard's decoder params, the
    first of them decoder ``first`` of the model; ``sliding``/``rope_on``
    the model's per-layer patterns. Returns (prefix_h, suffix_h, kvs), kvs
    each layer's post-rope KV, one dict {'kp','vp','ks','vs'} per rank.

    ``delta``: the optional multi-adapter LoRA shift, applied to both
    streams at each layer's entry: {"pairs": per layer {group: (A [D, r],
    B [r, D])}, "g": the block's row -> group list, "scale": [G] float32},
    factors and scales on the device. None runs exactly the computation
    without adapters. ``use_pallas`` (here and in the helpers below) picks
    the attention kernels or the plain ops (``llama.prefix_suffix_layer``)."""
    kvs = []
    for i, layer in enumerate(layers):
        d = first + i
        if delta is not None:
            prefix_h, suffix_h = _shift(delta, i, prefix_h), _shift(delta, i, suffix_h)
        prefix_h, suffix_h, kv = llama.prefix_suffix_layer(
            layer, model_cfg, prefix_h, suffix_h, prefix_len, return_kv=True,
            sliding=sliding[d], total_len=total_len, rope_on=rope_on[d], use_pallas=use_pallas,
        )
        kvs.append(kv)
    return prefix_h, suffix_h, kvs


def suffix_prefill_decoders(model_cfg, layers, first: int, kps, vps, suffix_h, prefix_len,
                            total_len, sliding, rope_on, delta=None, *, use_pallas: bool):
    """The suffix-only prefill of a shard's decoder layers over pooled
    prefix KV (the JAX package's ``_suffix_prefill_decoders``): ``kps``/
    ``vps`` per layer one post-rope [B, Lp, n_kv, hd] tensor per rank.
    Bit-equal to :func:`prefill_decoders`' suffix stream. Returns
    (suffix_h, kvs), kvs each layer's per-rank {'kp','vp','ks','vs'} with
    the pooled kp/vp re-attached.
    ``delta`` shifts the suffix stream at each layer's entry (the pooled KV
    was made under the same adapter: the pool's keys are salted by it)."""
    kvs = []
    for i, (layer, kp, vp) in enumerate(zip(layers, kps, vps)):
        d = first + i
        if delta is not None:
            suffix_h = _shift(delta, i, suffix_h)
        suffix_h, kv_s = llama.suffix_only_layer(
            layer, model_cfg, kp, vp, suffix_h, prefix_len, sliding=sliding[d],
            total_len=total_len, rope_on=rope_on[d], use_pallas=use_pallas,
        )
        kvs.append([{"kp": k, "vp": v, **s} for k, v, s in zip(kp, vp, kv_s)])
    return suffix_h, kvs


def decode_decoders(model_cfg, layers, first: int, kvs, x, prefix_len, suffix_eos, t, sliding,
                    rope_on, delta=None, *, use_pallas: bool):
    """One decode step of a shard's decoder layers (the JAX package's
    ``_decode_decoders_impl``): x [B, S, K, D] the newest tokens, ``kvs``
    the layers' per-rank KV dicts (generated slot t, or the [B, S] per-suffix
    offsets of a verify pass, written in place). ``delta`` shifts x at each
    layer's entry. Returns x."""
    for i, (layer, kv) in enumerate(zip(layers, kvs)):
        d = first + i
        if delta is not None:
            x = _shift(delta, i, x)
        x = llama.decode_step_layer(layer, model_cfg, x, kv, prefix_len, suffix_eos, t,
                                    sliding=sliding[d], rope_on=rope_on[d],
                                    use_pallas=use_pallas)
    return x


def decode_norm_head(model_cfg, norm_params, head_params, x) -> torch.Tensor:
    """x [B, S, 1, D] -> float32 next-token distributions [B, S, V] (the
    JAX package's ``_decode_norm_head_impl``)."""
    h = rms_norm(x, norm_params["scale"], model_cfg.rms_norm_eps, model_cfg.norm_unit_offset)
    return llama.lm_head_scores(head_params, h, model_cfg.final_logit_softcap)


def spec_norm_head(model_cfg, norm_params, head_params, x) -> torch.Tensor:
    """x [B, S, K+1, D] -> float32 distributions [B, S, K+1, V] of every fed
    position of a verify pass (the JAX package's ``_spec_norm_head``)."""
    h = rms_norm(x, norm_params["scale"], model_cfg.rms_norm_eps, model_cfg.norm_unit_offset)
    return llama.lm_head_scores_multi(head_params, h, model_cfg.final_logit_softcap)


_CAPTURE_LOCK = threading.Lock()


def fused_decode_steps(model_cfg, dtype: torch.dtype, layers, kvs, embed_params, norm_params,
                       head_params, init_ids: torch.Tensor, prefix_len: torch.Tensor,
                       suffix_eos: torch.Tensor, n_steps: int, graph: bool, *,
                       use_pallas: bool):
    """Every greedy decode step of one block on the device (the JAX
    package's ``_fused_decode_steps``): embed the previous pick, run every
    decoder layer (``layers``: (params, sliding, rope_on) in model order, ``kvs``
    their KV dicts; step t writes generated slot t in place), norm and
    head, and pick with ``torch.argmax`` (the first index of the float32
    max, as ``np.argmax``). ``init_ids`` [B, S] int64 is the prefill's pick.

    With ``graph`` (a CUDA device) the steps are captured into one CUDA
    graph and replayed once; each step's slot t is a literal of its kernel
    launches, so the capture unrolls the steps. One warm-up step runs first
    on copies of the generated KV into scratch outputs, so it writes no KV
    slot and consumes no pick. A capture that fails raises.

    Returns the distributions [n_steps, B, S, V] float32 and the picks
    [n_steps, B, S] int64, copied to the host once.
    """
    dev = init_ids.device
    b, s = init_ids.shape
    dists = torch.empty(n_steps, b, s, model_cfg.vocab_size, dtype=torch.float32, device=dev)
    picks = torch.empty(n_steps, b, s, dtype=torch.long, device=dev)

    def step(t: int, ids, step_kvs, dist_out, pick_out) -> None:
        x = llama.embed(embed_params, ids[..., None], dtype, model_cfg)
        for (params, sliding, rope_on), kv in zip(layers, step_kvs):
            x = llama.decode_step_layer(params, model_cfg, x, kv, prefix_len, suffix_eos, t,
                                        sliding=sliding, rope_on=rope_on, use_pallas=use_pallas)
        h = rms_norm(x, norm_params["scale"], model_cfg.rms_norm_eps, model_cfg.norm_unit_offset)
        dist = llama.lm_head_scores(head_params, h, model_cfg.final_logit_softcap)
        dist_out.copy_(dist)
        pick_out.copy_(torch.argmax(dist, dim=-1))

    def all_steps() -> None:
        for t in range(n_steps):
            step(t, init_ids if t == 0 else picks[t - 1], kvs, dists[t], picks[t])

    if not graph:
        all_steps()
    else:
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            # Copies of the generated slots: the warm-up writes no real KV.
            warm = [[{**k, "kg": k["kg"].clone(), "vg": k["vg"].clone()} for k in kv]
                    for kv in kvs]
            step(0, init_ids, warm, torch.empty_like(dists[0]), torch.empty_like(picks[0]))
            del warm
            cuda_graph = torch.cuda.CUDAGraph()
            # Thread-local capture: another thread's launches, allocations
            # and waits (a DP rank on the same card) neither join this
            # graph nor invalidate it; one capture at a time.
            with _CAPTURE_LOCK, fa.graph_capture() as captured:
                cuda_graph.capture_begin(capture_error_mode="thread_local")
                try:
                    all_steps()
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        cuda_graph.capture_end()
                    raise
                cuda_graph.capture_end()
            cuda_graph.replay()
            fa.count_replay(captured)
        main.wait_stream(side)
    return dists.cpu().numpy(), picks.cpu().numpy()


class DecodeGenerator(StreamingExecutor):
    """Streaming generation with KV reuse.

    ``__call__(prompts)`` -> (scores, updated_prompts): one float32
    ``[n_suffixes, num_gen_token, vocab]`` per prompt, and the suffix strings
    grown by the decoded tokens.

    ``mp_devices`` (more than one): the interleaved pipeline's stages, each
    stage's weights and KV on its own device (one device may be named
    several times). ``weight_source_factory``: a DP rank's broadcast view
    per weight pass, with ``resident`` the decision its round count was
    built for (required with it; speculation does not compose with it).
    ``device`` a ``TpPlacement``: tensor-parallel decode (the module's
    docstring).
    """

    def __init__(self, cfg, device: torch.device | None = None, tokenizer=None, *,
                 mp_devices=None, weight_source_factory=None, resident: bool | None = None):
        if weight_source_factory is not None and mp_devices is not None:
            raise ValueError("mp_devices and weight_source_factory are exclusive")
        if weight_source_factory is not None and resident is None:
            # The shared source's round count is fixed: a rank deciding
            # residency on its own could take more or fewer passes.
            raise ValueError("weight_source_factory requires an explicit resident= flag "
                             "matching the source's round count")
        if weight_source_factory is not None and cfg.speculative_k:
            raise ValueError("speculative_k does not compose with data_parallel decode")
        if mp_devices:
            mp_devices = [indexed_device(d) for d in mp_devices]
            device = mp_devices[0]
        super().__init__(cfg, device, tokenizer, weight_source_factory=weight_source_factory)
        self._pipeline = mp_devices is not None and len(mp_devices) > 1
        if self._pipeline:
            stages = global_stage_order(len(self.layer_names), cfg.layer_num_per_shard,
                                        len(mp_devices))
            self.shards = [s for (_, _, s) in stages]
            self.shard_devices = [mp_devices[r] for (_, r, _) in stages]
        else:
            self.shards = list(self.plan.shards)
            self.shard_devices = [self.device] * len(self.shards)
        # The memory gates count physical devices: one device named as
        # several stages or tensor-parallel ranks holds all of their weights.
        self._n_chips = (len(self.placement.mesh.distinct) if self.placement is not None
                         else len(set(self.shard_devices)))
        self._probe_dev = residency.probe_chip(self.target)
        self._resident = (resident if resident is not None else
                          cfg.decode_resident_enabled(self.model_cfg, self._n_chips,
                                                      self._probe_dev))
        # A resident decode keeps every placed shard: the tier is moot.
        self._residency = None if self._resident else super()._pin_tier()
        self._sched_core = SchedCore(cfg)
        # Whether fused steps are captured in a CUDA graph, from the model
        # alone: an MoE layer groups tokens by expert from counts it reads
        # to the host, which a capture cannot hold.
        self._graph_ok = not metrics.has_moe_layers(self.model_cfg)

    # The latest call's stats are the ``decode`` registry source.
    REGISTRY_NAME = "decode"

    def _pin_tier(self):
        return None  # decided in __init__, once residency is

    def _fused_budget_ok(self, toks, blocks, n_gen: int, gen_slots: int,
                         kv_on_device: bool) -> bool:
        """Whether the fused steps' device footprint fits 80% of the card:
        resident weights, the KV (every block's when it stays on the card,
        else the largest block's) and the stacked float32 distributions
        [n_steps, B, S, V]. On the CPU device memory is host RAM: always
        ok; a card of unknown memory cannot be budgeted."""
        if self._probe_dev.type == "cpu":
            return True
        hbm_gb = metrics.chip_hbm_gb(self._probe_dev)
        if not hbm_gb:
            return False
        per_block_kv = [block_kv_bytes(self.model_cfg, self.cfg.dtype, toks, i, gen_slots)
                        for i in blocks]
        kv_bytes = sum(per_block_kv) if kv_on_device else max(per_block_kv)
        dists_bytes = max(
            (n_gen - 1) * len(idxs) * toks[idxs[0]].suffix_ids.shape[0]
            * self.model_cfg.vocab_size * 4
            for idxs in blocks
        )
        weights = metrics.weight_bytes_per_chip(self.model_cfg, self.cfg.dtype, self._n_chips)
        return weights + kv_bytes + dists_bytes <= 0.8 * hbm_gb * 1e9

    @torch.inference_mode()
    def __call__(self, prompts, num_gen_token: int | None = None):
        cfg, mcfg = self.cfg, self.model_cfg
        n_gen = num_gen_token or cfg.num_gen_token
        t_start = time.perf_counter()
        toks = [self.tokenizer(p, s) for p, s in prompts]
        # Parked KV keeps its rope table: generation must not cross longrope's
        # boundary (a speculative pass's K+1 window may overshoot by K).
        check_longrope_regime(mcfg, toks, extra_len=max(n_gen - 1, 0) + cfg.speculative_k)
        blocks = make_blocks(toks, cfg.block_size)
        metas: dict[tuple, tuple] = {}  # (block, device) -> the block's ids on that device

        def meta_on(b: int, dev: torch.device):
            if (b, dev) not in metas:
                metas[(b, dev)] = block_meta(toks, blocks[b], dev)
            return metas[(b, dev)]

        core = self._sched_core
        plain_slots = core.gen_slots(n_gen)
        kv_on_device = core.kv_on_device(mcfg, cfg.dtype, toks, blocks, plain_slots,
                                         self._resident, device=self._probe_dev,
                                         n_chips=self._n_chips)
        budget_ok = bool(blocks) and self._fused_budget_ok(toks, blocks, n_gen, plain_slots,
                                                           kv_on_device)
        fused = (cfg.decode_fused != "off" and self._resident and not self._pipeline
                 and cfg.temperature <= 0 and n_gen > 1 and budget_ok)
        if cfg.decode_fused == "on" and not fused and n_gen > 1 and blocks:
            raise ValueError(
                "decode_fused='on' needs resident weights, greedy selection, one placement "
                "(no MP pipeline) and the fused footprint (weights + KV + dists) within the "
                f"card's memory; got resident={self._resident} temperature={cfg.temperature} "
                f"single_placement={not self._pipeline} hbm_budget_ok={budget_ok}"
            )
        # One capture spans one card: tensor-parallel ranks on distinct
        # cards run the fused steps eagerly.
        graph = fused and self.device.type == "cuda" and self._graph_ok and self._n_chips == 1
        # Speculative verify passes; the fused steps are preferred when both
        # could run (resident steps move no weights to amortise).
        spec_k = cfg.speculative_k
        speculative = spec_k > 0 and n_gen > 1 and not fused and bool(blocks)
        gen_slots = core.gen_slots(n_gen, spec_k, speculative)
        if speculative and kv_on_device and cfg.storage_location != "gpu":
            # Judge the KV placement again at the larger slot count.
            kv_on_device = core.kv_on_device(mcfg, cfg.dtype, toks, blocks, gen_slots,
                                             self._resident, device=self._probe_dev,
                                             n_chips=self._n_chips)
        kv_store = KVStore(kv_on_device, self.device)
        n_layers = len(self.layer_names)
        n_shards = len(self.shards)
        sliding = llama.layer_sliding_pattern(mcfg)
        rope_on = llama.layer_rope_pattern(mcfg)
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

        n_passes = 1 if self._resident else n_gen
        if self.weight_source_factory is None:
            # A fresh injector per decode call's source, as the JAX decoder.
            source, host_stats = self.weight_source(
                n_passes, shards=self.shards,
                devices=self.shard_devices if self._pipeline else None,
                injector=FaultInjector.from_config(self.cfg.faults))
            it = iter(source)
            bytes_before = 0
        else:
            # One broadcast view per weight pass, in a row.
            host_stats = StreamStats(None, device=self.target, shared=True)
            source = self.weight_source_factory()
            bytes_before = source.bytes_loaded
            it = itertools.chain(source, itertools.chain.from_iterable(
                self.weight_source_factory() for _ in range(n_passes - 1)))
        compute_time = source_wait = 0.0
        # Resident mode: the shards the prefill pass placed, in order.
        kept: list[tuple[tuple[int, ...], list]] = []

        def next_shard():
            nonlocal source_wait
            t0 = time.perf_counter()
            item = next(it)
            source_wait += time.perf_counter() - t0
            return item

        def walk_pass(embed_ids, step_t, head_fn, skip_block=None) -> None:
            """One walk of the whole model over the blocks, shared by the
            per-step loop and the speculative verify passes: the kept
            shards or the next streamed pass, ('x', b) activations parked
            between shards. embed_ids(b) -> token ids [B, S, K] on the
            device; step_t(b) -> the generated slot (an int, or a verify
            pass's [B, S] offsets); head_fn(b, norm_params, head_params, x);
            skip_block(b) leaves a block out of this pass."""
            nonlocal compute_time
            norm_params = None
            shards = kept if self._resident else (next_shard() for _ in range(n_shards))
            for shard_pos, (layer_idxs, segments) in enumerate(shards):
                if not layer_idxs:  # an MP round-up padding stage
                    continue
                dev = self.shard_devices[shard_pos]
                t0 = time.perf_counter()
                for b in range(len(blocks)):
                    if skip_block is not None and skip_block(b):
                        continue
                    _, _, prefix_len, suffix_eos = meta_on(b, dev)
                    t = step_t(b)
                    if isinstance(t, torch.Tensor):
                        t = t.to(dev)
                    x = None if layer_idxs[0] == 0 else kv_store.get(("x", b), dev)
                    li0 = 0  # the segment's first layer within the shard
                    for kind, params in segments:
                        if kind == "embed":
                            x = llama.embed(params, embed_ids(b), self.dtype, mcfg)
                        elif kind == "decoders":
                            keys = [("kv", shard_pos, li0 + li, b) for li in range(len(params))]
                            kvs = [kv_store.get(key) for key in keys]
                            x = decode_decoders(mcfg, params, first_decoder(layer_idxs) + li0, kvs,
                                                x, prefix_len, suffix_eos, t, sliding, rope_on,
                                                use_pallas=self._use_pallas)
                            for key, kv in zip(keys, kvs):
                                kv_store.put(key, kv)
                            li0 += len(params)
                        elif kind == "norm":
                            norm_params = params  # applied with the head
                        else:
                            # The norm may sit on an earlier stage's device.
                            head_fn(b, _tree_map(lambda v: v.to(dev), norm_params), params, x)
                    if layer_idxs[-1] != n_layers - 1:
                        kv_store.put(("x", b), x)
                sync(dev if self.placement is None else self.placement)
                compute_time += time.perf_counter() - t0
                del segments

        def stream_pass(embed_ids, step_t, head_fn, skip_block=None) -> None:
            """:func:`walk_pass` as one traced ``sweep`` span (mode
            ``decode_step``): a decode step's weight pass, its shard loads
            and uploads nested under the producer's spans."""
            sid = obs_trace.new_sweep_id() if obs_trace.enabled() else 0
            with obs_trace.span("sweep", cat="decode", sweep_id=sid, mode="decode_step"):
                walk_pass(embed_ids, step_t, head_fn, skip_block)

        try:
            # --- prefill: one streaming pass, parking each layer's KV -------
            for shard_pos in range(n_shards):
                layer_idxs, segments = next_shard()
                if self._resident:
                    kept.append((layer_idxs, segments))
                if not layer_idxs:  # an MP round-up padding stage
                    continue
                dev = self.shard_devices[shard_pos]
                t0 = time.perf_counter()
                for b, idxs in enumerate(blocks):
                    prefix_ids, suffix_ids, prefix_len, suffix_eos = meta_on(b, dev)
                    total_len = longrope_total_len(mcfg, prefix_len, suffix_eos)
                    ph = sh = None
                    if layer_idxs[0] != 0:
                        ph, sh = kv_store.get(("h", b), dev)
                    li0 = 0
                    for kind, params in segments:
                        if kind == "embed":
                            ph = llama.embed(params, prefix_ids, self.dtype, mcfg)
                            sh = llama.embed(params, suffix_ids, self.dtype, mcfg)
                        elif kind == "decoders":
                            ph, sh, kvs = prefill_decoders(
                                mcfg, params, first_decoder(layer_idxs) + li0, ph, sh, prefix_len,
                                total_len, sliding, rope_on, use_pallas=self._use_pallas)
                            for li, kv in enumerate(kvs):
                                kv_store.put(("kv", shard_pos, li0 + li, b),
                                             extend_gen_kv(kv, gen_slots))
                            li0 += len(params)
                            del kvs
                        elif kind == "norm":
                            sh = llama.select_eos_and_norm(params, mcfg, sh, suffix_eos)
                            ph = None
                        else:
                            head(b, llama.lm_head_scores(params, sh, mcfg.final_logit_softcap))
                    if layer_idxs[-1] != n_layers - 1:
                        kv_store.put(("h", b), (ph, sh))
                sync(dev if self.placement is None else self.placement)
                compute_time += time.perf_counter() - t0
                del segments

            # --- decode steps -----------------------------------------------
            if fused:
                t0 = time.perf_counter()
                embed_p = norm_p = head_p = None
                layers, keys = [], []
                for shard_pos, (layer_idxs, segments) in enumerate(kept):
                    li = 0
                    for kind, params in segments:
                        if kind == "embed":
                            embed_p = params
                        elif kind == "decoders":
                            for layer in params:
                                d = first_decoder(layer_idxs) + li
                                layers.append((layer, sliding[d], rope_on[d]))
                                keys.append((shard_pos, li))
                                li += 1
                        elif kind == "norm":
                            norm_p = params
                        else:
                            head_p = params
                for b in range(len(blocks)):
                    _, _, prefix_len, suffix_eos = meta_on(b, self.device)
                    kvs = [kv_store.get(("kv", sp, li, b)) for sp, li in keys]
                    init_ids = torch.from_numpy(np.asarray(tok_hist[b][-1], np.int64)).to(
                        self.device)
                    dists, picks = fused_decode_steps(
                        mcfg, self.dtype, layers, kvs, embed_p, norm_p, head_p, init_ids,
                        prefix_len, suffix_eos, n_gen - 1, graph, use_pallas=self._use_pallas)
                    del kvs
                    all_scores[b].extend(dists)
                    tok_hist[b].extend(picks)
                sync(self.target)
                compute_time += time.perf_counter() - t0
            elif speculative:
                verifiers: dict[int, SpecVerifier] = {}
                for b, idxs in enumerate(blocks):
                    s_b = toks[idxs[0]].suffix_ids.shape[0]
                    verifiers[b] = SpecVerifier(
                        spec_k, propose_draft,
                        draft_contexts([toks[i] for i in idxs], tok_hist[b][0]),
                        np.full((len(idxs), s_b), n_gen, np.int64), all_scores[b][0],
                        tok_hist[b][0],
                        active=[[s < toks[i].num_suffixes for s in range(s_b)] for i in idxs],
                    )
                while any(not v.done for v in verifiers.values()):
                    # Fed tokens and drafts are fixed before the walk; blocks
                    # whose rows all finished sit the pass out.
                    fed, base = {}, {}
                    for b, v in verifiers.items():
                        if not v.done:
                            f, t = v.begin_pass()
                            fed[b] = torch.from_numpy(f).to(self.device)
                            base[b] = torch.from_numpy(t).to(self.device)
                    head_dists: dict[int, np.ndarray] = {}

                    def spec_head(b, norm_params, head_params, x):
                        head_dists[b] = spec_norm_head(mcfg, norm_params, head_params,
                                                       x).to("cpu").numpy()

                    stream_pass(
                        lambda b: fed[b],
                        lambda b: base[b],
                        spec_head,
                        skip_block=lambda b: b not in fed,
                    )
                    for b, dist in head_dists.items():
                        verifiers[b].finish_pass(dist)
                for b, v in verifiers.items():
                    all_scores[b], tok_hist[b] = v.step_major(n_gen)
                spec_stats = {
                    "spec_passes": float(max(v.passes for v in verifiers.values())),
                    "spec_drafted": float(sum(v.drafted for v in verifiers.values())),
                    "spec_accepted": float(sum(v.accepted for v in verifiers.values())),
                }
            else:
                def plain_head(b, norm_params, head_params, x):
                    head(b, decode_norm_head(mcfg, norm_params, head_params, x))

                for t in range(n_gen - 1):
                    stream_pass(
                        lambda b: torch.from_numpy(
                            np.asarray(tok_hist[b][-1])[..., None]).to(self.device),
                        lambda b: t,
                        plain_head,
                    )
        finally:
            source.close()  # a broadcast view's is the orchestration's
            kv_store.clear()
            kept.clear()  # release the resident weights

        self.stats = {
            "total_wall_s": time.perf_counter() - t_start,
            "load_weights_time_s": source.load_time,
            "compute_wall_s": compute_time,
            "source_wait_s": source_wait,
            "streamed_bytes": float(source.bytes_loaded - bytes_before),
            "decode_resident": float(self._resident),
            "decode_fused": float(fused),
            "decode_speculative": float(speculative),
            "decode_kv_on_device": float(kv_on_device),
            "decode_graph": float(graph),
            **host_stats.read(source),
            "tokens_processed": float(
                sum(t.tokens_processed for t in toks)
                + sum(t.num_suffixes for t in toks) * max(n_gen - 1, 0)
            ),
        }
        if speculative:
            self.stats.update(spec_stats)
        note_rank_bytes(self.stats, source)
        if self.weight_source_factory is not None:
            self.stats["load_time_shared"] = self.stats["streamed_bytes_shared"] = 1.0
        if self._pipeline:
            peak = peak_over(self.shard_devices, self._residency)
            if peak is not None:
                self.stats["peak_mem_gb"] = peak
        else:
            host_stats.read_peak(self.stats)
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


__all__ = [
    "DecodeGenerator",
    "KVStore",
    "SpecVerifier",
    "block_kv_bytes",
    "decode_decoders",
    "decode_norm_head",
    "draft_contexts",
    "extend_gen_kv",
    "fused_decode_steps",
    "kv_fits_on_chip",
    "prefill_decoders",
    "propose_draft",
    "spec_norm_head",
    "suffix_prefill_decoders",
]
