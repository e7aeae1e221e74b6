"""Ring attention: sequence parallelism over a device list (the JAX
package's ``ops/ring_attention.py``).

The reference has no long-context mechanism: it truncates every prefix at
its cap (the reference's ``utils.py:14,250,254``). Here the sequence axis
is split over the ranks of a :class:`~flexible_llm_sharding_tpu_torch.
parallel.sharding.DeviceMesh`: rank r holds query, key and value block r
on its device. Where JAX runs one SPMD body per chip and rotates K/V with
``ppermute``, the port loops over the ranks: at ring step s, rank r folds
the K/V block it holds (block (r - s) mod n) into float32 online-softmax
accumulators (m, l, acc), and then every block moves one hop, from rank j
to rank j + 1, with ``.to(device)`` (no copy, and no allocation, when both
ranks are on one device). No rank ever holds more than its own
[L/N, L/N] score tile.

The blocks are plain float32-accumulated products, as JAX's plain
``einsum`` at ``Precision.HIGHEST`` (no kernel: the JAX ring has none);
on a card float32 products run without TF32 (``config.resolve_device``).
Causality, the sliding window and the chunk are element masks at global
positions (``rank * L_blk + i``); a block whose keys a query cannot see
adds nothing to its softmax. A row that sees no key comes out 0.
"""

from __future__ import annotations

from typing import Sequence

import torch

from flexible_llm_sharding_tpu_torch.models import llama
from flexible_llm_sharding_tpu_torch.ops.attention import (
    _NEG_INF,
    _grouped_q,
    _local_clause,
    _softcap,
)
from flexible_llm_sharding_tpu_torch.parallel.sharding import (
    DeviceMesh,
    gather,
    replicate,
    shard,
)

def local_form(cfg, sliding) -> tuple[int | None, int | None]:
    """A layer's (window, chunk): the config's when the layer's ``sliding``
    flag is on, else neither."""
    return (cfg.sliding_window, cfg.attention_chunk_size) if sliding else (None, None)


def _block_update(q, k, v, mask, m, l, acc, scale, softcap=None):
    """Fold one KV block into online-softmax accumulators (GQA einsums).

    q [Lq, n_kv, g, hd]; k/v [Lk, n_kv, hd]; mask [Lq, Lk] bool; m/l
    [n_kv, g, Lq, 1] float32; acc [n_kv, g, Lq, hd_v] float32. ``softcap``
    (Gemma 2) caps the scaled scores before the mask; tanh is monotone, so
    capping per block commutes with the online max and sum."""
    s = torch.einsum("qngh,knh->ngqk", q, k).float() * scale
    s = _softcap(s, softcap)
    s = torch.where(mask[None, None], s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.einsum("ngqk,knh->ngqh", p.to(v.dtype), v)
    return m_new, l, acc


def ring_attention_blocks(q_blks: Sequence[torch.Tensor], k_blks: Sequence[torch.Tensor],
                          v_blks: Sequence[torch.Tensor], mesh: DeviceMesh, causal: bool = True,
                          scale: float | None = None, window: int | None = None,
                          chunk: int | None = None,
                          softcap: float | None = None) -> list[torch.Tensor]:
    """The ring over sharded blocks: q/k/v block r [L_blk, n, hd] on rank
    r's device -> output block r [L_blk, n_q, hd_v] there, in q's dtype.
    The local clauses and the softcap are :func:`ring_self_attention`'s."""
    n = mesh.size
    lq, n_q, hd = q_blks[0].shape
    n_kv, hd_v = k_blks[0].shape[1], v_blks[0].shape[-1]  # V's own head dim (MLA)
    g = n_q // n_kv
    if scale is None:
        scale = 1.0 / (hd**0.5)
    devs = mesh.devices
    qr = [_grouped_q(q, n_kv) for q in q_blks]
    state = []
    for r in range(n):
        m = torch.full((n_kv, g, lq, 1), _NEG_INF, dtype=torch.float32, device=devs[r])
        state.append((m, torch.zeros_like(m),
                      torch.zeros((n_kv, g, lq, hd_v), dtype=torch.float32, device=devs[r])))
    k_cur, v_cur = list(k_blks), list(v_blks)
    for step in range(n):
        for r in range(n):
            src = (r - step) % n  # whose KV block rank r holds now
            ar = torch.arange(lq, device=devs[r])
            qi = (r * lq + ar)[:, None]
            kj = (src * lq + ar)[None, :]
            mask = kj <= qi if causal else torch.ones((lq, lq), dtype=torch.bool,
                                                       device=devs[r])
            mask = _local_clause(mask, qi, kj, window, None, chunk)
            state[r] = _block_update(qr[r], k_cur[r], v_cur[r], mask, *state[r], scale, softcap)
        if step != n - 1:
            # One hop around the ring: rank j's block goes to rank j + 1.
            k_cur = [k_cur[(r - 1) % n].to(devs[r]) for r in range(n)]
            v_cur = [v_cur[(r - 1) % n].to(devs[r]) for r in range(n)]
    out = []
    for r, (_, l, acc) in enumerate(state):
        o = torch.where(l > 0, acc / torch.clamp(l, min=1e-30), 0.0)
        # [n_kv, g, Lq, hd_v] -> [Lq, n_q, hd_v]
        out.append(o.permute(2, 0, 1, 3).reshape(lq, n_q, hd_v).to(q_blks[r].dtype))
    return out


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: DeviceMesh,
                        causal: bool = True, scale: float | None = None,
                        window: int | None = None, chunk: int | None = None,
                        softcap: float | None = None) -> torch.Tensor:
    """Sequence-parallel self-attention over the mesh's axis.

    q [L, n_q, hd]; k/v [L, n_kv, hd]; L must divide evenly by the mesh
    size (else ValueError). ``window``/``chunk`` AND a local clause into
    the (causal) mask; ``softcap`` is Gemma 2's logit softcap; ``scale``
    defaults to hd^-0.5. Returns [L, n_q, hd_v] on the first rank's device,
    equal to dense masked attention."""
    q_blks, k_blks, v_blks = shard(q, mesh), shard(k, mesh), shard(v, mesh)
    return gather(ring_attention_blocks(q_blks, k_blks, v_blks, mesh, causal, scale, window,
                                        chunk, softcap), mesh.devices[0])


def ring_decoder_blocks(params: Sequence[dict], cfg, x_blks: Sequence[torch.Tensor],
                        mesh: DeviceMesh, sliding=False, rope_on=True, total_len=None):
    """One decoder layer with ring attention over sharded blocks.

    ``params``: the layer per rank (:func:`~flexible_llm_sharding_tpu_torch.
    parallel.sharding.replicate`); x block r [L_blk, D] on rank r's device.
    Norm, q/k/v (the model library's ``positioned_qkv`` at global
    positions ``r * L_blk + i``), the residual attention and MLP run on
    each rank's block on its device. ``sliding``/``rope_on`` are the
    layer's flags; ``total_len`` is longrope's real length. Returns (out
    blocks, post-rope k blocks, v blocks)."""
    window, chunk = local_form(cfg, sliding)
    qs, ks, vs = [], [], []
    for r, (p, x) in enumerate(zip(params, x_blks)):
        lq = x.shape[0]
        h = llama._norm(x, p["input_layernorm"], cfg)
        pos = r * lq + torch.arange(lq, device=x.device)
        q, k, v = llama.positioned_qkv(p, cfg, h, pos, sliding, total_len, rope_on)
        qs.append(q)
        ks.append(k)
        vs.append(v)
    attn = ring_attention_blocks(qs, ks, vs, mesh, causal=True, scale=cfg.attn_scale,
                                 window=window, chunk=chunk, softcap=cfg.attn_logit_softcap)
    out = [llama._residual_mlp([p], cfg, llama._residual_attn(p, cfg, x, a))
           for p, x, a in zip(params, x_blks, attn)]
    return out, ks, vs


def ring_decoder_layer(params: dict, cfg, x: torch.Tensor, mesh: DeviceMesh,
                       return_kv: bool = False, sliding=False, rope_on=True, total_len=None):
    """A full decoder layer with sequence-parallel (ring) attention: x
    [L, D] is sharded over the mesh, ``params`` replicated on each distinct
    device; the result [L, D] (and with ``return_kv`` the post-rope k, v
    [L, n_kv, hd]) is gathered on the first rank's device. The scorer runs
    :func:`ring_decoder_blocks` on blocks it keeps sharded."""
    out, ks, vs = ring_decoder_blocks(replicate(params, mesh), cfg, shard(x, mesh), mesh,
                                      sliding, rope_on, total_len)
    dev = mesh.devices[0]
    if return_kv:
        return gather(out, dev), gather(ks, dev), gather(vs, dev)
    return gather(out, dev)


__all__ = ["ring_attention_blocks", "ring_decoder_blocks", "ring_decoder_layer",
           "ring_self_attention"]
