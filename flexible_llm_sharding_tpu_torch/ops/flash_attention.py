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
(``csrc/flash_attention.cu``, built on first use) and counts the launch,
and separately each launch with a local form on; it never falls back. On
CPU tensors it runs its plain version, a function of the same signature
built on ``ops/attention.py``. Every function takes an explicit leading
batch (block) dimension ``B``.

What the kernels compute, beyond the plain attention ops: key ``j`` of a
causal prefix is visible to query ``i`` iff ``j <= i`` and
``j < valid_len``, so the padding query rows ``i >= valid_len`` see the real
keys and stay finite; a query row with no visible key is written as 0 (the
TPU kernels' ``_finish``). The plain versions reproduce exactly that.

Local attention, as the TPU kernels take it: a sliding ``window`` (query at
absolute position q sees keys k with q - k < window) or a position
``chunk`` (q and k in the same chunk), never both, and ``local_on``, the
per-layer toggle (None or True: the local form applies; False: it does
not). On CUDA ``local_on`` must be a Python or numpy bool: it is resolved on
the host, so a launch never waits on the device for it; the plain versions
also take a bool tensor.
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
# Head dims the kernels take: 64, 128 and 256 in instantiations of their
# own, 96 (Phi-3) in the hd-128 one, with the columns past 96 zero-filled
# on load and never written.
_HEAD_DIMS = (64, 96, 128, 256)
# (Q/K head dim, V head dim) pairs the scoring kernels take besides equal
# ones: multi-head latent attention's qk 192 (nope 128 + rope 64), v 128.
_SCORING_DIM_PAIRS = ((192, 128),)

KERNELS = ("flash_causal_attention", "flash_prefix_shared_attention", "flash_decode_attention")


def check_cuda_args(window=None, chunk=None, local_on=None, head_dim=128, v_dim=None,
                    decode=False) -> None:
    """Reject, before any launch, what the CUDA kernels do not compute: a
    window and a chunk at once, a window or chunk below 1, a ``local_on``
    tensor (TypeError: the toggle is resolved on the host), head dims other
    than 64, 96, 128 and 256, and a V head dim different from Q/K's except
    MLA's (192, 128) in the scoring kernels (``decode`` False)."""
    if window is not None and chunk is not None:
        raise ValueError("window and chunk are mutually exclusive")
    if any(x is not None and int(x) < 1 for x in (window, chunk)):
        raise ValueError(f"window and chunk must be >= 1, got {window}, {chunk}")
    if torch.is_tensor(local_on):
        raise TypeError("local_on must be a bool on CUDA: the kernels take it from the host")
    if v_dim is not None and v_dim != head_dim:
        if decode or (head_dim, v_dim) not in _SCORING_DIM_PAIRS:
            raise NotImplementedError(
                f"the CUDA {'decode' if decode else 'scoring'} kernel needs v_dim == head_dim"
                + ("" if decode else f" or (head_dim, v_dim) in {_SCORING_DIM_PAIRS}")
                + f", got ({head_dim}, {v_dim})"
            )
        return
    if head_dim not in _HEAD_DIMS:
        raise NotImplementedError(
            f"the CUDA attention kernels support head_dim in {_HEAD_DIMS}, got {head_dim}"
        )


def _local_form(window, chunk, local_on) -> tuple[int, int]:
    """(window, chunk) as the kernels take them, 0 meaning off: the local
    form unless the per-layer toggle is off."""
    if local_on is not None and not bool(local_on):
        return 0, 0
    return int(window or 0), int(chunk or 0)


def _count(fn, window: int, chunk: int, dims: tuple[int, int]) -> None:
    fn.launches += 1
    if window or chunk:
        fn.local_launches += 1
    fn.dim_launches[dims] = fn.dim_launches.get(dims, 0) + 1


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
    """q/k [B, L, n_q/n_kv, hd], v [B, L, n_kv, hd_v], valid_len int32 [B]
    -> [B, L, n_q, hd_v]. Query i attends keys j <= i with j < valid_len[b].
    hd_v is hd, or 128 at MLA's hd 192."""
    if q.device.type == "cpu":
        return causal_attention_plain(q, k, v, valid_len, scale, window, chunk, softcap, local_on)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, lq, n_q, hd = q.shape
    n_kv, hd_v = k.shape[2], v.shape[-1]
    check_cuda_args(window, chunk, local_on, hd, hd_v)
    if n_q % n_kv:
        raise ValueError("n_q must be a multiple of n_kv")
    _check("q", q, q.dtype, (b, lq, n_q, hd), q.device)
    _check("k", k, q.dtype, (b, lq, n_kv, hd), q.device)
    _check("v", v, q.dtype, (b, lq, n_kv, hd_v), q.device)
    vl = _lengths("valid_len", valid_len, (b,), q.device)
    win, chk = _local_form(window, chunk, local_on)
    out = q.new_empty(b, lq, n_q, hd_v)
    from flexible_llm_sharding_tpu_torch.ops.cuda_build import library

    # K's strides, in elements; V's are the same in rows of n_kv * hd_v.
    stride_b = lq * n_kv * hd
    err = library().fls_score_attention(
        _DTYPE_CODES[q.dtype], hd, hd_v, q.data_ptr(), out.data_ptr(), b, 1, lq, n_q, n_kv,
        _scale(scale, hd), _softcap_arg(softcap), win, chk, None, 1,
        k.data_ptr(), v.data_ptr(), stride_b, 0, lq, vl.data_ptr(), 1, 0, 0, 1, 0,
        None, None, 0, 0, 0, None, 0, 0, 0, 0, 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "flash_causal_attention")
    _count(flash_causal_attention, win, chk, (hd, hd_v))
    return out


flash_causal_attention.launches = flash_causal_attention.local_launches = 0
flash_causal_attention.dim_launches = {}


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
    """q [B, S, Ls, n_q, hd]; k/v_prefix [B, Lp, n_kv, hd / hd_v] (shared by
    the S suffixes); k/v_suffix [B, S, Ls, n_kv, hd / hd_v]; prefix_len
    int32 [B] -> [B, S, Ls, n_q, hd_v]. Suffix query i sees prefix keys
    j < prefix_len[b] and its own keys j <= i, under one softmax. hd_v is
    hd, or 128 at MLA's hd 192."""
    if q.device.type == "cpu":
        return prefix_shared_attention_plain(
            q, k_prefix, v_prefix, k_suffix, v_suffix, prefix_len, scale, window, chunk,
            softcap, local_on,
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, s, ls, n_q, hd = q.shape
    lp, n_kv, hd_v = k_prefix.shape[1], k_prefix.shape[2], v_prefix.shape[-1]
    check_cuda_args(window, chunk, local_on, hd, hd_v)
    if n_q % n_kv:
        raise ValueError("n_q must be a multiple of n_kv")
    dev = q.device
    _check("q", q, q.dtype, (b, s, ls, n_q, hd), dev)
    _check("k_prefix", k_prefix, q.dtype, (b, lp, n_kv, hd), dev)
    _check("v_prefix", v_prefix, q.dtype, (b, lp, n_kv, hd_v), dev)
    _check("k_suffix", k_suffix, q.dtype, (b, s, ls, n_kv, hd), dev)
    _check("v_suffix", v_suffix, q.dtype, (b, s, ls, n_kv, hd_v), dev)
    pl = _lengths("prefix_len", prefix_len, (b,), dev)
    win, chk = _local_form(window, chunk, local_on)
    out = q.new_empty(b, s, ls, n_q, hd_v)
    from flexible_llm_sharding_tpu_torch.ops.cuda_build import library

    # Suffix query i and suffix key j sit at prefix_len[b] + i / + j: the
    # query offset is prefix_len and the suffix source is shifted by it
    # (positions matter only to a local form). Strides are K's, as above.
    row = n_kv * hd
    local = bool(win or chk)
    err = library().fls_score_attention(
        _DTYPE_CODES[q.dtype], hd, hd_v, q.data_ptr(), out.data_ptr(), b, s, ls, n_q, n_kv,
        _scale(scale, hd), _softcap_arg(softcap), win, chk, pl.data_ptr() if local else None, 2,
        k_prefix.data_ptr(), v_prefix.data_ptr(), lp * row, 0, lp, pl.data_ptr(), 1, 0, 0, 0, 0,
        k_suffix.data_ptr(), v_suffix.data_ptr(), s * ls * row, ls * row, ls, None, 0, 0, ls, 1, int(local),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "flash_prefix_shared_attention")
    _count(flash_prefix_shared_attention, win, chk, (hd, hd_v))
    return out


flash_prefix_shared_attention.launches = flash_prefix_shared_attention.local_launches = 0
flash_prefix_shared_attention.dim_launches = {}


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
    check_cuda_args(window, chunk, local_on, hd, v_prefix.shape[-1], decode=True)
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
    win, chk = _local_form(window, chunk, local_on)
    out = torch.empty_like(q)
    from flexible_llm_sharding_tpu_torch.ops.cuda_build import library

    row = n_kv * hd
    err = library().fls_decode_attention(
        _DTYPE_CODES[q.dtype], hd, q.data_ptr(), out.data_ptr(), b, s, n_q, n_kv,
        _scale(scale, hd), _softcap_arg(softcap), win, chk,
        k_prefix.data_ptr(), v_prefix.data_ptr(), lp * row, lp, pl.data_ptr(),
        k_suffix.data_ptr(), v_suffix.data_ptr(), s * ls * row, ls * row, ls, eos.data_ptr(),
        k_gen.data_ptr(), v_gen.data_ptr(), s * tg * row, tg * row, tg, t,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "flash_decode_attention")
    _count(flash_decode_attention, win, chk, (hd, hd))
    return out


flash_decode_attention.launches = flash_decode_attention.local_launches = 0
flash_decode_attention.dim_launches = {}

PLAIN = {
    "flash_causal_attention": causal_attention_plain,
    "flash_prefix_shared_attention": prefix_shared_attention_plain,
    "flash_decode_attention": decode_attention_plain,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last :func:`reset_launch_counts`."""
    return {name: globals()[name].launches for name in KERNELS}


def local_launch_counts() -> dict[str, int]:
    """Of those, the launches with a sliding window or chunk on."""
    return {name: globals()[name].local_launches for name in KERNELS}


def dim_launch_counts() -> dict[str, dict[tuple[int, int], int]]:
    """Of those, the launches per (Q/K head dim, V head dim)."""
    return {name: dict(globals()[name].dim_launches) for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        globals()[name].launches = globals()[name].local_launches = 0
        globals()[name].dim_launches = {}


__all__ = [
    "KERNELS",
    "PLAIN",
    "causal_attention_plain",
    "check_cuda_args",
    "decode_attention_plain",
    "dim_launch_counts",
    "flash_causal_attention",
    "flash_decode_attention",
    "flash_prefix_shared_attention",
    "launch_counts",
    "local_launch_counts",
    "prefix_shared_attention_plain",
    "reset_launch_counts",
]
