"""Masked multi-head attention with grouped-query (GQA) support, in plain
PyTorch — the port of the JAX package's ``ops/attention.py``.

These are the reference semantics the CUDA kernels in
``ops/flash_attention.py`` are held against, and what those kernels' plain
versions run on the CPU, with the full mask surface: sliding window,
chunked attention and the per-layer toggle.

Conventions match the JAX ops: QK^T and PV in the input dtype, softmax in
float32, masked scores set to ``_NEG_INF`` (not -inf, so a fully masked row
stays finite), KV heads never replicated (queries are regrouped as
[n_kv, group]). Unlike the JAX ops, the prefix-sharing and decode forms take
an explicit leading batch (block) dimension ``B`` with per-prompt
``prefix_len [B]`` and ``suffix_eos [B, S]`` — the JAX package gets it from
``jax.vmap``.
"""

from __future__ import annotations

import torch

_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _grouped_q(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[..., Lq, n_q, hd] -> [..., Lq, n_kv, g, hd] (a view)."""
    *lead, lq, n_q, hd = q.shape
    return q.reshape(*lead, lq, n_kv, n_q // n_kv, hd)


def _softcap(scores: torch.Tensor, cap: float | None) -> torch.Tensor:
    """cap * tanh(scores / cap) on the scaled float32 scores, before the
    mask (HF order: scale -> softcap -> mask -> softmax)."""
    if cap is None:
        return scores
    return torch.tanh(scores / cap) * cap


def _local_clause(mask, q_pos, k_pos, window, sliding, chunk=None):
    """AND the local-attention visibility into ``mask``: a sliding ``window``
    (visible iff q_pos - k_pos < window) or a position ``chunk`` (visible iff
    both positions share a chunk). ``sliding`` None applies it; a bool (or
    bool tensor) toggles it."""
    if window is None and chunk is None:
        return mask
    if window is not None:
        in_local = (q_pos - k_pos) < window
    else:
        in_local = torch.div(q_pos, chunk, rounding_mode="floor") == torch.div(
            k_pos, chunk, rounding_mode="floor"
        )
    if sliding is not None:
        in_local = torch.logical_or(
            torch.logical_not(torch.as_tensor(sliding, device=mask.device)), in_local
        )
    return mask & in_local


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None,
    scale: float | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """Scaled dot-product attention with GQA.

    q: [..., Lq, n_q, hd]; k, v: [..., Lk, n_kv, hd] with n_q % n_kv == 0.
    mask: broadcastable to [..., Lq, Lk]; True = attend. Returns
    [..., Lq, n_q, v_dim].
    """
    n_kv = k.shape[-2]
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    qr = _grouped_q(q, n_kv)
    scores = torch.einsum("...qngh,...knh->...ngqk", qr, k)
    scores = _softcap(scores.float() * scale, softcap)
    if mask is not None:
        scores = torch.where(mask[..., None, None, :, :], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("...ngqk,...knh->...qngh", probs, v)
    return out.reshape(*q.shape[:-1], v.shape[-1])


def prefix_shared_attention(
    q: torch.Tensor,
    k_prefix: torch.Tensor,
    v_prefix: torch.Tensor,
    k_suffix: torch.Tensor,
    v_suffix: torch.Tensor,
    prefix_len: torch.Tensor,
    scale: float | None = None,
    window: int | None = None,
    softcap: float | None = None,
    sliding=None,
    chunk: int | None = None,
) -> torch.Tensor:
    """S suffix continuations over [shared prefix KV ; own causal KV], one
    joint softmax.

    q: [B, S, Ls, n_q, hd] (rope applied at positions prefix_len + i);
    k/v_prefix: [B, Lp, n_kv, hd] (shared by every suffix, never expanded);
    k/v_suffix: [B, S, Ls, n_kv, hd]; prefix_len: int [B] — prefix keys at
    j >= prefix_len are padding. Returns [B, S, Ls, n_q, v_dim].
    """
    b, s, ls, n_q, hd = q.shape
    lp, n_kv = k_prefix.shape[1], k_prefix.shape[2]
    if scale is None:
        scale = 1.0 / (hd**0.5)
    qr = _grouped_q(q, n_kv)  # [B, S, Ls, n_kv, g, hd]
    scores_p = torch.einsum("bsqngh,bknh->bsngqk", qr, k_prefix)
    scores_s = torch.einsum("bsqngh,bsknh->bsngqk", qr, k_suffix)
    scores = _softcap(
        torch.cat([scores_p, scores_s], dim=-1).float() * scale, softcap
    )  # [B, S, n_kv, g, Ls, Lp+Ls]

    dev = q.device
    plen = prefix_len.to(dev).reshape(b, 1, 1)
    kj = torch.arange(lp + ls, device=dev)[None, None, :]
    qi = torch.arange(ls, device=dev)[None, :, None]
    mask = torch.where(kj < lp, kj < plen, (kj - lp) <= qi)  # [B, Ls, Lp+Ls]
    if window is not None or chunk is not None:
        abs_k = torch.where(kj < lp, kj, plen + kj - lp)
        mask = _local_clause(mask, plen + qi, abs_k, window, sliding, chunk)
    scores = torch.where(mask[:, None, None, None], scores, _NEG_INF)

    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bsngqk,bknh->bsqngh", probs[..., :lp], v_prefix)
    out = out + torch.einsum("bsngqk,bsknh->bsqngh", probs[..., lp:], v_suffix)
    return out.reshape(b, s, ls, n_q, v_prefix.shape[-1])


def decode_attention(
    q: torch.Tensor,
    k_prefix: torch.Tensor,
    v_prefix: torch.Tensor,
    k_suffix: torch.Tensor,
    v_suffix: torch.Tensor,
    k_gen: torch.Tensor,
    v_gen: torch.Tensor,
    prefix_len: torch.Tensor,
    suffix_eos: torch.Tensor,
    t,
    scale: float | None = None,
    window: int | None = None,
    softcap: float | None = None,
    sliding=None,
    chunk: int | None = None,
) -> torch.Tensor:
    """The K newest tokens per suffix over three cached KV regions, one joint
    softmax: the shared prefix KV (keys i < prefix_len), the suffix's own KV
    (keys i <= suffix_eos) and the generated KV up to the query itself
    (keys i <= t + j, causal among the K fed tokens).

    q [B, S, K, n_q, hd]; k/v_prefix [B, Lp, n_kv, hd]; k/v_suffix
    [B, S, Ls, n_kv, hd]; k/v_gen [B, S, T, n_kv, hd] (slots t..t+K-1 hold
    this step's KV); prefix_len int [B]; suffix_eos int [B, S]; t an int or
    int [B, S]. Returns [B, S, K, n_q, v_dim].
    """
    b, s, kq, n_q, hd = q.shape
    n_kv = k_prefix.shape[-2]
    if scale is None:
        scale = 1.0 / (hd**0.5)
    lp, ls, tmax = k_prefix.shape[1], k_suffix.shape[2], k_gen.shape[2]
    dev = q.device
    plen = prefix_len.to(dev).reshape(b, 1, 1, 1)
    eos = suffix_eos.to(dev).reshape(b, s, 1, 1)
    # An int t is filled on the device: a host tensor would be a pageable
    # copy that waits for the stream.
    t = torch.full((), t, device=dev) if isinstance(t, int) else torch.as_tensor(t, device=dev)
    base = t.expand(b, s).reshape(b, s, 1, 1)
    jq = torch.arange(kq, device=dev).reshape(1, 1, kq, 1)

    qr = _grouped_q(q, n_kv)  # [B, S, K, n_kv, g, hd]
    sp = torch.einsum("bsqngh,bknh->bsngqk", qr, k_prefix)
    ss = torch.einsum("bsqngh,bsknh->bsngqk", qr, k_suffix)
    sg = torch.einsum("bsqngh,bsknh->bsngqk", qr, k_gen)
    scores = _softcap(
        torch.cat([sp, ss, sg], dim=-1).float() * scale, softcap
    )  # [B, S, n_kv, g, K, Lp+Ls+T]

    ip = torch.arange(lp, device=dev).reshape(1, 1, 1, lp)
    i_s = torch.arange(ls, device=dev).reshape(1, 1, 1, ls)
    ig = torch.arange(tmax, device=dev).reshape(1, 1, 1, tmax)
    shape = (b, s, kq)
    mask = torch.cat(
        [
            (ip < plen).expand(*shape, lp),
            (i_s <= eos).expand(*shape, ls),
            (ig <= base + jq).expand(*shape, tmax),
        ],
        dim=-1,
    )  # [B, S, K, Lp+Ls+T]
    if window is not None or chunk is not None:
        q_pos = plen + eos + 1 + base + jq  # [B, S, K, 1]
        abs_k = torch.cat(
            [
                ip.expand(b, s, 1, lp),
                (plen + i_s).expand(b, s, 1, ls),
                (plen + eos + 1 + ig).expand(b, s, 1, tmax),
            ],
            dim=-1,
        )
        mask = _local_clause(mask, q_pos, abs_k, window, sliding, chunk)
    scores = torch.where(mask[:, :, None, None], scores, _NEG_INF)

    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    pp, ps, pg = probs[..., :lp], probs[..., lp : lp + ls], probs[..., lp + ls :]
    out = torch.einsum("bsngqk,bknh->bsqngh", pp, v_prefix)
    out = out + torch.einsum("bsngqk,bsknh->bsqngh", ps, v_suffix)
    out = out + torch.einsum("bsngqk,bsknh->bsqngh", pg, v_gen)
    return out.reshape(b, s, kq, n_q, v_prefix.shape[-1])


def causal_mask(
    lq: int,
    lk: int,
    offset: int = 0,
    window: int | None = None,
    chunk: int | None = None,
    device=None,
) -> torch.Tensor:
    """Boolean [lq, lk]: query i sees key j iff j <= i + offset, and within a
    sliding ``window`` ((i + offset) - j < window) or the same ``chunk``."""
    qi = torch.arange(lq, device=device)[:, None]
    kj = torch.arange(lk, device=device)[None, :]
    mask = kj <= qi + offset
    if window is not None:
        mask &= (qi + offset) - kj < window
    if chunk is not None:
        mask &= torch.div(qi + offset, chunk, rounding_mode="floor") == torch.div(
            kj, chunk, rounding_mode="floor"
        )
    return mask


__all__ = [
    "attention",
    "causal_mask",
    "decode_attention",
    "prefix_shared_attention",
]
