"""Counters of the weight stream's fault handling (the JAX package's
``utils/metrics.py`` ``RetryRecorder`` and ``IntegrityRecorder``), the
host's resident memory, and the analytic model sizes and device memory that
the decode gates judge residency by (``param_count``,
``weight_bytes_per_chip``, ``chip_hbm_gb``)."""

from __future__ import annotations

import threading


class RetryRecorder:
    """Thread-safe retry accounting fed by ``faults.retry.retry_call``, per
    call-site label: ``retries`` (backoff sleeps), ``recovered`` (calls that
    succeeded after a retry), ``exhausted`` (calls that gave up) and
    ``backoff_s`` (total sleep)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_label: dict[str, dict[str, float]] = {}

    def record(self, label: str, *, retries: int = 0, recovered: int = 0, exhausted: int = 0,
               backoff_s: float = 0.0) -> None:
        with self._lock:
            d = self._by_label.setdefault(
                label or "call", {"retries": 0, "recovered": 0, "exhausted": 0, "backoff_s": 0.0})
            d["retries"] += retries
            d["recovered"] += recovered
            d["exhausted"] += exhausted
            d["backoff_s"] += backoff_s

    def total(self, key: str = "retries") -> float:
        with self._lock:
            return sum(d[key] for d in self._by_label.values())

    def snapshot(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {k: {kk: round(vv, 4) if kk == "backoff_s" else int(vv) for kk, vv in d.items()}
                    for k, d in sorted(self._by_label.items())}


class IntegrityRecorder:
    """Thread-safe corruption counters: ``integrity_failures`` (mismatches
    and unreadable spills detected), ``reread_heals`` (loads clean on a
    re-read), ``recomputes`` (kept for the JAX key set; the recompute path
    comes with resume, ROADMAP 3.6) and ``quarantined_shards``."""

    KEYS = ("integrity_failures", "reread_heals", "recomputes", "quarantined_shards")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: dict[str, int] = dict.fromkeys(self.KEYS, 0)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def total(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)


def host_rss_gib() -> dict[str, float]:
    """This process's resident memory in GiB: ``rss`` (VmRSS of
    ``/proc/self/status``, now) where the kernel reports it, and ``peak``
    (VmHWM there, else ``getrusage``'s maximum). Page-locked buffers
    count."""
    import resource

    out = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                for key, name in (("VmRSS:", "rss"), ("VmHWM:", "peak")):
                    if line.startswith(key):
                        out[name] = int(line.split()[1]) / 2**20
    except (OSError, ValueError, IndexError):
        pass
    out.setdefault("peak", resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20)
    return out


def chip_hbm_gb(device=None) -> float | None:
    """Memory of one card in GB (10^9 B): a CUDA device's
    ``total_memory``; None on the CPU, where the decode gates then resolve
    to off (the JAX package's CPU backend reports no HBM either).
    ``device`` None is the current CUDA device when there is one."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory / 1e9


def _arch_walk(cfg):
    """(attention projection parameters per layer, per-layer MoE flags,
    dense MLP width) of a LlamaConfig; MLA counts its q LoRA (or dense q),
    the compressed kv_a, the per-head kv_b and wo over the V head dim."""
    h = cfg.hidden_size
    hd = cfg.head_dim
    q_dim = cfg.num_attention_heads * hd
    kv_dim = cfg.num_key_value_heads * hd
    if cfg.kv_lora_rank:
        q_p = h * cfg.q_lora_rank + cfg.q_lora_rank * q_dim if cfg.q_lora_rank else h * q_dim
        kv_p = h * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) + (
            cfg.kv_lora_rank * cfg.num_attention_heads * (cfg.qk_nope_head_dim + cfg.v_dim))
        attn_proj = q_p + kv_p + cfg.num_attention_heads * cfg.v_dim * h
    else:
        attn_proj = h * q_dim + 2 * h * kv_dim + q_dim * h
    n = cfg.num_hidden_layers
    moe_pattern = cfg.moe_layer_pattern or (
        ((True,) * n) if cfg.num_local_experts else ((False,) * n))
    dense_inter = (cfg.intermediate_size_mlp if cfg.intermediate_size_mlp is not None
                   else cfg.intermediate_size)
    return attn_proj, moe_pattern, dense_inter


def _shared_expert_mult(cfg) -> int:
    """The always-on shared expert's width in routed-expert widths: 0 (none),
    1 (llama4) or ``n_shared_experts`` (deepseek_v3)."""
    if cfg.model_type == "llama4_text":
        return 1
    if cfg.model_type == "deepseek_v3":
        return int(getattr(cfg, "n_shared_experts", 1))
    return 0


def has_moe_layers(cfg) -> bool:
    """Whether any decoder layer of ``cfg`` routes over experts."""
    return any(_arch_walk(cfg)[1])


# Bytes per element at each compute dtype: the factor of every device
# memory gate (resident weights, KV on the card, fused decode).
_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def weight_bytes_per_chip(cfg, dtype: str, n_chips: int = 1) -> float:
    """Parameter bytes per card at the compute dtype: the numerator of the
    resident-decode, KV-on-device and fused-decode gates."""
    return param_count(cfg) * _DTYPE_BYTES[dtype] / max(n_chips, 1)


def param_count(cfg) -> int:
    """Every parameter of a LlamaConfig as placed on the device: every
    expert, the embedding, an untied head, the norms."""
    h = cfg.hidden_size
    attn, moe_pattern, dense_inter = _arch_walk(cfg)
    total = 0
    for is_moe in moe_pattern:
        if is_moe:
            mlp = cfg.num_local_experts * 3 * h * cfg.intermediate_size
            mlp += h * cfg.num_local_experts  # router
            mlp += _shared_expert_mult(cfg) * 3 * h * cfg.intermediate_size
        else:
            mlp = 3 * h * dense_inter
        total += attn + mlp + 2 * h  # + the two norm scale vectors
    total += h * cfg.vocab_size  # embedding
    if not cfg.tie_word_embeddings:
        total += h * cfg.vocab_size  # untied lm_head
    total += h  # final norm
    return int(total)


__all__ = [
    "IntegrityRecorder",
    "RetryRecorder",
    "chip_hbm_gb",
    "has_moe_layers",
    "host_rss_gib",
    "param_count",
    "weight_bytes_per_chip",
]
