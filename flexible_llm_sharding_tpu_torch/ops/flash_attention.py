"""The three attention kernels of the streamed scorer, with their plain
versions.

Each wrapper replaces one Pallas TPU kernel of the JAX package
(``flexible_llm_sharding_tpu/ops/pallas_attention.py``):

- :func:`flash_causal_attention` — the prefix's causal self-attention with
  a per-prompt valid length (``flash_causal_attention``, ``_causal_kernel``);
- :func:`flash_prefix_shared_attention` — every suffix over [shared prefix
  KV ; own causal KV] (``flash_prefix_shared_attention``,
  ``_prefix_shared_kernel``);
- :func:`flash_decode_attention` — one new token per suffix over [prefix ;
  suffix ; generated] KV (``flash_decode_attention``, ``_decode_kernel``).

On CUDA tensors a wrapper launches its hand-written kernel
(``csrc/flash_attention.cu``, built on first use) and counts the launch; it
never falls back. On CPU tensors it runs its plain version, a function of the
same signature built on ``ops/attention.py``. Every function takes an
explicit leading batch (block) dimension ``B``.

What the kernels compute, beyond the plain attention ops: key ``j`` of a
causal prefix is visible to query ``i`` iff ``j <= i`` and
``j < valid_len``, so the padding query rows ``i >= valid_len`` see the real
keys and stay finite; a query row with no visible key is written as 0 (the
TPU kernels' ``_finish``). The plain versions reproduce exactly that.
"""

from __future__ import annotations

import torch

from flexible_llm_sharding_tpu_torch.ops.attention import (
    attention,
    causal_mask,
    decode_attention,
    prefix_shared_attention,
)

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_HEAD_DIMS = (64, 128)

KERNELS = ("flash_causal_attention", "flash_prefix_shared_attention", "flash_decode_attention")


def check_cuda_args(window=None, chunk=None, local_on=None, head_dim=128, v_dim=None) -> None:
    """Reject, before any launch, what this slice's CUDA kernels do not
    compute: sliding-window/chunked attention and its per-layer toggle, a V
    head dim different from Q/K's (MLA), and head dims other than 64/128."""
    if window is not None or chunk is not None or local_on is not None:
        raise NotImplementedError(
            "the CUDA attention kernels do not support window/chunk/local_on yet"
        )
    if v_dim is not None and v_dim != head_dim:
        raise NotImplementedError("the CUDA attention kernels need v_dim == head_dim")
    if head_dim not in _HEAD_DIMS:
        raise NotImplementedError(
            f"the CUDA attention kernels support head_dim in {_HEAD_DIMS}, got {head_dim}"
        )


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.dtype.is_floating_point and x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _lengths(name: str, x, shape: tuple, device) -> torch.Tensor:
    x = torch.as_tensor(x)
    _check(name, x, torch.int32, shape, device)
    return x


def _raise_on(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} failed with CUDA error {err}")


def _scale(scale, hd: int) -> float:
    return float(scale) if scale is not None else 1.0 / (hd**0.5)


def _softcap_arg(softcap) -> float:
    return float(softcap) if softcap is not None else 0.0


def _zero_masked_rows(out: torch.Tensor, visible: torch.Tensor) -> torch.Tensor:
    """Rows with no visible key come out as 0 (the kernels' finish step).
    ``visible``: [..., Lq] bool broadcastable to out's leading dims."""
    return torch.where(visible[..., None, None], out, out.new_zeros(()))


# ---------------------------------------------------------------------------
# Causal self-attention with a per-prompt valid length
# ---------------------------------------------------------------------------

def causal_attention_plain(q, k, v, valid_len, scale=None, window=None, chunk=None,
                           softcap=None, local_on=None):
    """Plain version of :func:`flash_causal_attention`."""
    b, lq = q.shape[:2]
    lk = k.shape[1]
    dev = q.device
    base = causal_mask(lq, lk, window=window, chunk=chunk, device=dev)
    if local_on is not None and (window is not None or chunk is not None):
        base = torch.where(
            torch.as_tensor(local_on, device=dev), base, causal_mask(lq, lk, device=dev)
        )
    valid = torch.arange(lk, device=dev)[None, :] < valid_len.to(dev).reshape(b, 1)
    mask = base[None] & valid[:, None, :]  # [B, Lq, Lk]
    out = attention(q, k, v, mask, scale=scale, softcap=softcap)
    return _zero_masked_rows(out, mask.any(-1))


def flash_causal_attention(q, k, v, valid_len, scale=None, window=None, chunk=None,
                           softcap=None, local_on=None):
    """q [B, L, n_q, hd], k/v [B, L, n_kv, hd], valid_len int32 [B] ->
    [B, L, n_q, hd]. Query i attends keys j <= i with j < valid_len[b]."""
    if q.device.type == "cpu":
        return causal_attention_plain(q, k, v, valid_len, scale, window, chunk, softcap, local_on)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, lq, n_q, hd = q.shape
    n_kv = k.shape[2]
    check_cuda_args(window, chunk, local_on, hd, v.shape[-1])
    if n_q % n_kv:
        raise ValueError("n_q must be a multiple of n_kv")
    _check("q", q, q.dtype, (b, lq, n_q, hd), q.device)
    _check("k", k, q.dtype, (b, lq, n_kv, hd), q.device)
    _check("v", v, q.dtype, (b, lq, n_kv, hd), q.device)
    vl = _lengths("valid_len", valid_len, (b,), q.device)
    out = torch.empty_like(q)
    from flexible_llm_sharding_tpu_torch.ops.cuda_build import library

    stride_b = lq * n_kv * hd
    err = library().fls_score_attention(
        _DTYPE_CODES[q.dtype], hd, q.data_ptr(), out.data_ptr(), b, 1, lq, n_q, n_kv,
        _scale(scale, hd), _softcap_arg(softcap), 1,
        k.data_ptr(), v.data_ptr(), stride_b, 0, lq, vl.data_ptr(), 1, 0, 0, 1,
        None, None, 0, 0, 0, None, 0, 0, 0, 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "flash_causal_attention")
    flash_causal_attention.launches += 1
    return out


flash_causal_attention.launches = 0


# ---------------------------------------------------------------------------
# Prefix-shared suffix attention
# ---------------------------------------------------------------------------

def prefix_shared_attention_plain(q, k_prefix, v_prefix, k_suffix, v_suffix, prefix_len,
                                  scale=None, window=None, chunk=None, softcap=None,
                                  local_on=None):
    """Plain version of :func:`flash_prefix_shared_attention` (every suffix
    query sees at least its own first key, so no row is fully masked)."""
    return prefix_shared_attention(
        q, k_prefix, v_prefix, k_suffix, v_suffix, prefix_len, scale=scale,
        window=window, softcap=softcap, sliding=local_on, chunk=chunk,
    )


def flash_prefix_shared_attention(q, k_prefix, v_prefix, k_suffix, v_suffix, prefix_len,
                                  scale=None, window=None, chunk=None, softcap=None,
                                  local_on=None):
    """q [B, S, Ls, n_q, hd]; k/v_prefix [B, Lp, n_kv, hd] (shared by the S
    suffixes); k/v_suffix [B, S, Ls, n_kv, hd]; prefix_len int32 [B] ->
    [B, S, Ls, n_q, hd]. Suffix query i sees prefix keys j < prefix_len[b]
    and its own keys j <= i, under one softmax."""
    if q.device.type == "cpu":
        return prefix_shared_attention_plain(
            q, k_prefix, v_prefix, k_suffix, v_suffix, prefix_len, scale, window, chunk,
            softcap, local_on,
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, s, ls, n_q, hd = q.shape
    lp, n_kv = k_prefix.shape[1], k_prefix.shape[2]
    check_cuda_args(window, chunk, local_on, hd, v_prefix.shape[-1])
    if n_q % n_kv:
        raise ValueError("n_q must be a multiple of n_kv")
    dev = q.device
    _check("q", q, q.dtype, (b, s, ls, n_q, hd), dev)
    _check("k_prefix", k_prefix, q.dtype, (b, lp, n_kv, hd), dev)
    _check("v_prefix", v_prefix, q.dtype, (b, lp, n_kv, hd), dev)
    _check("k_suffix", k_suffix, q.dtype, (b, s, ls, n_kv, hd), dev)
    _check("v_suffix", v_suffix, q.dtype, (b, s, ls, n_kv, hd), dev)
    pl = _lengths("prefix_len", prefix_len, (b,), dev)
    out = torch.empty_like(q)
    from flexible_llm_sharding_tpu_torch.ops.cuda_build import library

    row = n_kv * hd
    err = library().fls_score_attention(
        _DTYPE_CODES[q.dtype], hd, q.data_ptr(), out.data_ptr(), b, s, ls, n_q, n_kv,
        _scale(scale, hd), _softcap_arg(softcap), 2,
        k_prefix.data_ptr(), v_prefix.data_ptr(), lp * row, 0, lp, pl.data_ptr(), 1, 0, 0, 0,
        k_suffix.data_ptr(), v_suffix.data_ptr(), s * ls * row, ls * row, ls, None, 0, 0, ls, 1,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "flash_prefix_shared_attention")
    flash_prefix_shared_attention.launches += 1
    return out


flash_prefix_shared_attention.launches = 0


# ---------------------------------------------------------------------------
# Single-token decode over three cached KV regions
# ---------------------------------------------------------------------------

def decode_attention_plain(q, k_prefix, v_prefix, k_suffix, v_suffix, k_gen, v_gen,
                           prefix_len, suffix_eos, t, scale=None, window=None, chunk=None,
                           softcap=None, local_on=None):
    """Plain version of :func:`flash_decode_attention` (the generated slot t
    is always visible, so no row is fully masked)."""
    return decode_attention(
        q, k_prefix, v_prefix, k_suffix, v_suffix, k_gen, v_gen, prefix_len, suffix_eos,
        t, scale=scale, window=window, softcap=softcap, sliding=local_on, chunk=chunk,
    )


def flash_decode_attention(q, k_prefix, v_prefix, k_suffix, v_suffix, k_gen, v_gen,
                           prefix_len, suffix_eos, t, scale=None, window=None, chunk=None,
                           softcap=None, local_on=None):
    """q [B, S, 1, n_q, hd]; k/v_prefix [B, Lp, n_kv, hd]; k/v_suffix
    [B, S, Ls, n_kv, hd]; k/v_gen [B, S, T, n_kv, hd]; prefix_len int32 [B];
    suffix_eos int32 [B, S]; t an int (the slot this step's KV was written
    to) -> [B, S, 1, n_q, hd]."""
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k_prefix, v_prefix, k_suffix, v_suffix, k_gen, v_gen, prefix_len,
            suffix_eos, t, scale, window, chunk, softcap, local_on,
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, s, kq, n_q, hd = q.shape
    lp, n_kv = k_prefix.shape[1], k_prefix.shape[2]
    ls, tg = k_suffix.shape[2], k_gen.shape[2]
    check_cuda_args(window, chunk, local_on, hd, v_prefix.shape[-1])
    if kq != 1:
        raise NotImplementedError("the CUDA decode kernel takes one new token per suffix")
    if n_q % n_kv:
        raise ValueError("n_q must be a multiple of n_kv")
    t = int(t)
    if not 0 <= t < tg:
        raise ValueError(f"t={t} is outside the {tg} generated slots")
    dev = q.device
    _check("q", q, q.dtype, (b, s, 1, n_q, hd), dev)
    _check("k_prefix", k_prefix, q.dtype, (b, lp, n_kv, hd), dev)
    _check("v_prefix", v_prefix, q.dtype, (b, lp, n_kv, hd), dev)
    _check("k_suffix", k_suffix, q.dtype, (b, s, ls, n_kv, hd), dev)
    _check("v_suffix", v_suffix, q.dtype, (b, s, ls, n_kv, hd), dev)
    _check("k_gen", k_gen, q.dtype, (b, s, tg, n_kv, hd), dev)
    _check("v_gen", v_gen, q.dtype, (b, s, tg, n_kv, hd), dev)
    pl = _lengths("prefix_len", prefix_len, (b,), dev)
    eos = _lengths("suffix_eos", suffix_eos, (b, s), dev)
    out = torch.empty_like(q)
    from flexible_llm_sharding_tpu_torch.ops.cuda_build import library

    row = n_kv * hd
    err = library().fls_decode_attention(
        _DTYPE_CODES[q.dtype], hd, q.data_ptr(), out.data_ptr(), b, s, n_q, n_kv,
        _scale(scale, hd), _softcap_arg(softcap),
        k_prefix.data_ptr(), v_prefix.data_ptr(), lp * row, lp, pl.data_ptr(),
        k_suffix.data_ptr(), v_suffix.data_ptr(), s * ls * row, ls * row, ls, eos.data_ptr(),
        k_gen.data_ptr(), v_gen.data_ptr(), s * tg * row, tg * row, tg, t,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "flash_decode_attention")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0

PLAIN = {
    "flash_causal_attention": causal_attention_plain,
    "flash_prefix_shared_attention": prefix_shared_attention_plain,
    "flash_decode_attention": decode_attention_plain,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last :func:`reset_launch_counts`."""
    return {name: globals()[name].launches for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        globals()[name].launches = 0


__all__ = [
    "KERNELS",
    "PLAIN",
    "causal_attention_plain",
    "check_cuda_args",
    "decode_attention_plain",
    "flash_causal_attention",
    "flash_decode_attention",
    "flash_prefix_shared_attention",
    "launch_counts",
    "prefix_shared_attention_plain",
    "reset_launch_counts",
]
