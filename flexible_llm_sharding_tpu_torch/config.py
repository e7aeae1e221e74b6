"""Model and runtime configuration of the PyTorch/CUDA port.

``LlamaConfig`` keeps the part of the JAX package's config that the port
runs (field names and defaults unchanged, so the ``config.json`` that
``utils.checkpoint.save_params`` writes reads back in either package): the
dense families llama, mistral, phi3, qwen2, qwen3 and gemma 1/2/3, with
their deltas — q/k/v biases, sliding-window layers and their per-layer
pattern, (1+w) float32 RMSNorm, per-head q/k norm, a local rope base
beside a scaled global one, sandwich norms, GeGLU, scaled embeddings and
the softcaps — the mixture-of-experts families mixtral and qwen3_moe, and
deepseek_v3 (multi-head latent attention, DeepSeek's routed and shared
experts), Llama 4's text model (chunked local layers, NoPE layers with
temperature-tuned queries, the weightless q/k L2 norm, interleaved rope, its
input-scaled experts beside a shared expert), with the linear, llama3, yarn
and longrope rope scalings.

``FrameworkConfig`` holds the batch CLI's runtime flags: the reference's ten
plus dtype, blocking, bucketing, KV-cache decode, sampling, prefetch, the
device, the JAX package's default-on host path (weight verification, the
host shard cache, readahead and I/O retries), the head stage's score sink
and disk-mode crash resume, and the paged prefix-KV pool of the serving
engine. ``ServeConfig`` (with ``SchedConfig`` and ``SLOConfig``) holds the
``serve`` subcommand's knobs. ``resolve_device`` is the one place that turns a device name into a
``torch.device``: CUDA unless the caller asks for the CPU, and an error (never
a silent CPU run) when CUDA is asked for and absent.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any

import torch

DEFAULT_MAX_TOKEN_LEN = 4096

# The family deltas, with their "off" values, and the ones each family
# carries: a native config must keep the others off.
_FAMILY_DELTAS: dict[str, Any] = {
    "sliding_window": None,
    "layer_sliding": None,
    "rope_local_theta": None,
    "ffw_sandwich_norms": False,
    "qk_norm": False,
    "norm_unit_offset": False,
    "embed_scale": False,
    "num_local_experts": 0,
    "moe_layer_pattern": None,
    "kv_lora_rank": 0,
    "q_lora_rank": None,
    "rope_interleaved": False,
    "attention_chunk_size": None,
    "layer_rope": None,
    "qk_l2_norm": False,
    "attn_temperature_tuning": False,
}
_CARRIED_DELTAS: dict[str, frozenset[str]] = {
    "llama": frozenset(),
    "mistral": frozenset({"sliding_window"}),
    "phi3": frozenset({"sliding_window"}),
    "qwen2": frozenset({"sliding_window", "layer_sliding"}),
    "qwen3": frozenset({"sliding_window", "layer_sliding", "qk_norm"}),
    "gemma": frozenset({"norm_unit_offset", "embed_scale"}),
    "gemma2": frozenset({"sliding_window", "layer_sliding", "ffw_sandwich_norms",
                         "norm_unit_offset", "embed_scale"}),
    "gemma3_text": frozenset({"sliding_window", "layer_sliding", "rope_local_theta",
                              "ffw_sandwich_norms", "qk_norm", "norm_unit_offset",
                              "embed_scale"}),
    "mixtral": frozenset({"sliding_window", "num_local_experts"}),
    "qwen3_moe": frozenset({"sliding_window", "layer_sliding", "qk_norm", "num_local_experts",
                            "moe_layer_pattern"}),
    "deepseek_v3": frozenset({"num_local_experts", "moe_layer_pattern", "kv_lora_rank",
                              "q_lora_rank", "rope_interleaved"}),
    "llama4_text": frozenset({"layer_sliding", "num_local_experts", "moe_layer_pattern",
                              "rope_interleaved", "attention_chunk_size", "layer_rope",
                              "qk_l2_norm", "attn_temperature_tuning"}),
}
# Families whose MLP is a mixture of experts (a stray num_local_experts
# elsewhere is dropped, as in the JAX package).
_MOE_FAMILIES = ("mixtral", "qwen3_moe", "deepseek_v3", "llama4_text")

ACTIVATIONS = ("silu", "gelu", "gelu_pytorch_tanh")
_ROPE_SCALINGS = (None, "linear", "llama3", "yarn", "longrope")

# Fields a foreign (Hugging Face) config.json contributes by name, as in the
# JAX package (_UNIVERSAL_HF_FIELDS, _FAMILY_HF_FIELDS): the ones that mean
# the same thing in every family, and per family the Hugging Face fields
# that mean the same thing there. The family branches of from_dict derive
# the rest, so a stray key (a softcap, a head dim, a scalar, a bias flag of
# the native names) changes nothing.
_UNIVERSAL_HF_FIELDS = frozenset({
    "model_type", "vocab_size", "hidden_size", "intermediate_size",
    "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
    "rms_norm_eps", "rope_theta", "max_position_embeddings",
    "tie_word_embeddings", "hidden_act", "mlp_bias",
})
_FAMILY_HF_FIELDS: dict[str, frozenset[str]] = {
    "mistral": frozenset({"sliding_window"}),
    "qwen2": frozenset({"sliding_window"}),
    "qwen3": frozenset({"sliding_window"}),
    "qwen3_moe": frozenset({"sliding_window", "num_local_experts", "num_experts_per_tok"}),
    "mixtral": frozenset({"sliding_window", "num_local_experts", "num_experts_per_tok"}),
    "phi3": frozenset({"sliding_window"}),
    "gemma2": frozenset({"query_pre_attn_scalar", "sliding_window"}),
    "gemma3_text": frozenset({"query_pre_attn_scalar", "sliding_window", "rope_local_theta"}),
    "deepseek_v3": frozenset({"kv_lora_rank", "q_lora_rank", "qk_nope_head_dim",
                              "qk_rope_head_dim", "v_head_dim", "num_experts_per_tok"}),
    "llama4_text": frozenset({"num_local_experts", "num_experts_per_tok", "attention_chunk_size",
                              "intermediate_size_mlp", "attn_temperature_tuning"}),
}
# Multimodal wrappers whose language model is the nested text_config.
_TEXT_CONFIG_TYPES = {"gemma3": "gemma3_text", "llama4": "llama4_text"}


def extract_text_config(d: dict) -> dict | None:
    """The language model's config dict of a multimodal wrapper config (its
    ``text_config``, with the text model_type unless it names one), or None
    when ``d`` is no wrapper. Raises ValueError for a wrapper without a
    text_config."""
    text_type = _TEXT_CONFIG_TYPES.get(d.get("model_type"))
    if text_type is None:
        return None
    if not d.get("text_config"):
        raise ValueError(f"{d.get('model_type')} config without text_config")
    return {"model_type": text_type, **d["text_config"]}


def _yarn_mscale(scale: float, m: float = 1.0) -> float:
    """HF's get_mscale: 0.1 * m * ln(scale) + 1 above scale 1, else 1."""
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Decoder hyperparameters (defaults: Llama-2-7B), with the JAX
    package's field semantics: ``sliding_window`` is the local layers'
    window (query i sees key j iff j <= i and i - j < window);
    ``layer_sliding`` marks each layer local (True) or global, None meaning
    every layer is local when a window is set; local layers take the
    unscaled ``rope_local_theta`` base where it is set, global layers
    ``rope_theta`` with the ``rope_scaling_kind`` scaling; ``norm_unit_offset``
    multiplies RMSNorm by (1 + w) in float32; ``ffw_sandwich_norms`` norms
    the attention output (``post_attention_layernorm``) and the MLP's input
    and output (``pre/post_feedforward_layernorm``); ``embed_scale`` scales
    embeddings by sqrt(hidden_size) rounded to the compute dtype; ``qk_norm``
    is the per-head RMSNorm on q and k before rope.

    Llama 4: local layers (``layer_sliding`` True) attend within position
    chunks of ``attention_chunk_size`` (exclusive with ``sliding_window``);
    ``layer_rope`` False marks a NoPE layer, whose queries are scaled by
    log(floor((pos + 1) / ``attn_floor_scale``) + 1) * ``attn_scale_coef`` + 1
    under ``attn_temperature_tuning``; ``qk_l2_norm`` is the weightless L2
    norm of q and k after rope, on rope layers only. Its MoE layers scale
    each selected expert's input by the sigmoid of its router logit and add
    a shared expert; its dense layers are ``intermediate_size_mlp`` wide.

    Mixture of experts (``num_local_experts`` > 0): Mixtral/Qwen3-MoE route
    by a float32 softmax, top ``num_experts_per_tok``, renormalised iff
    ``moe_norm_topk_prob``; DeepSeek by sigmoid scores, group-limited
    (``moe_n_group``, ``moe_topk_group``) selection biased by a correction
    buffer, times ``moe_routed_scaling_factor``, plus a shared expert. The
    checkpoint's keys say which layers are MoE (``moe_layer_pattern`` and
    ``intermediate_size_mlp`` record it). Multi-head latent attention
    (``kv_lora_rank`` > 0): q by LoRA (``q_lora_rank``) or dense, K/V
    decompressed from a ``kv_lora_rank`` latent, one shared rope key of
    ``qk_rope_head_dim``; the q/k head dim is qk_nope + qk_rope and V's is
    ``v_head_dim``."""

    model_type: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    explicit_head_dim: int | None = None
    attention_in_bias: bool = False  # bias on wq/wk/wv
    attention_out_bias: bool = False  # bias on wo
    mlp_bias: bool = False  # bias on gate/up/down
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    query_pre_attn_scalar: float | None = None
    hidden_act: str = "silu"
    sliding_window: int | None = None
    layer_sliding: tuple[bool, ...] | None = None
    rope_local_theta: float | None = None
    rope_scaling_kind: str | None = None
    rope_scaling_factor: float = 1.0
    ffw_sandwich_norms: bool = False
    qk_norm: bool = False
    norm_unit_offset: bool = False
    embed_scale: bool = False
    # Rope scalings: llama3's bands, yarn's ramp and attention factor,
    # longrope's per-band factors (head_dim // 2 each).
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_attention_factor: float = 1.0
    rope_truncate: bool = True
    rope_long_factor: tuple | None = None
    rope_short_factor: tuple | None = None
    rope_interleaved: bool = False
    # Mixture of experts.
    num_local_experts: int = 0
    num_experts_per_tok: int = 2
    moe_norm_topk_prob: bool = True
    moe_n_group: int = 1
    moe_topk_group: int = 1
    moe_routed_scaling_factor: float = 1.0
    n_shared_experts: int = 1
    moe_layer_pattern: tuple[bool, ...] | None = None
    intermediate_size_mlp: int | None = None
    # Multi-head latent attention.
    kv_lora_rank: int = 0
    q_lora_rank: int | None = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int | None = None
    # Llama 4.
    attention_chunk_size: int | None = None
    layer_rope: tuple[bool, ...] | None = None
    qk_l2_norm: bool = False
    attn_temperature_tuning: bool = False
    attn_floor_scale: float = 8192.0
    attn_scale_coef: float = 0.1

    def __post_init__(self) -> None:
        if self.hidden_act not in ACTIVATIONS:
            raise NotImplementedError(
                f"hidden_act {self.hidden_act!r}: this port runs {ACTIVATIONS}"
            )
        if self.rope_scaling_kind not in _ROPE_SCALINGS:
            raise NotImplementedError(
                f"rope scaling {self.rope_scaling_kind!r} is not supported by the PyTorch "
                f"port (it runs {_ROPE_SCALINGS[1:]})"
            )
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError("num_attention_heads must be a multiple of num_key_value_heads")
        if self.layer_sliding is not None and len(self.layer_sliding) != self.num_hidden_layers:
            raise ValueError(
                f"layer_sliding has {len(self.layer_sliding)} entries for "
                f"{self.num_hidden_layers} layers"
            )
        if self.kv_lora_rank and self.rope_local_theta is not None:
            raise NotImplementedError("MLA does not compose with rope_local_theta")
        if self.sliding_window is not None and self.attention_chunk_size is not None:
            raise ValueError("sliding_window and attention_chunk_size are mutually exclusive")

    @property
    def rope_scaling_spec(self) -> tuple | None:
        """The scaling as ``ops.rope.rope_cos_sin`` takes it: None,
        ("linear", factor), ("llama3", factor, low, high, orig_max),
        ("yarn", factor, beta_fast, beta_slow, orig_max, attention factor,
        truncate) or ("longrope", long factors, short factors, orig_max,
        attention factor)."""
        kind = self.rope_scaling_kind
        if kind is None:
            return None
        if kind == "linear":
            return ("linear", self.rope_scaling_factor)
        if kind == "yarn":
            return ("yarn", self.rope_scaling_factor, self.rope_beta_fast, self.rope_beta_slow,
                    self.rope_original_max_position, self.rope_attention_factor,
                    self.rope_truncate)
        if kind == "longrope":
            return ("longrope", self.rope_long_factor, self.rope_short_factor,
                    self.rope_original_max_position, self.rope_attention_factor)
        return ("llama3", self.rope_scaling_factor, self.rope_low_freq_factor,
                self.rope_high_freq_factor, self.rope_original_max_position)

    @property
    def head_dim(self) -> int:
        """Q/K's head dim (under MLA qk_nope + qk_rope)."""
        if self.kv_lora_rank:
            return self.qk_nope_head_dim + self.qk_rope_head_dim
        if self.explicit_head_dim is not None:
            return self.explicit_head_dim
        return self.hidden_size // self.num_attention_heads

    @property
    def v_dim(self) -> int:
        """V's head dim: head_dim except under MLA."""
        return self.v_head_dim if self.v_head_dim is not None else self.head_dim

    @property
    def attn_scale(self) -> float:
        base = (
            self.query_pre_attn_scalar
            if self.query_pre_attn_scalar is not None
            else self.head_dim
        )
        return float(base) ** -0.5

    @staticmethod
    def _apply_sliding_pattern(kwargs: dict[str, Any], d: dict[str, Any], family: str,
                               default_fn) -> None:
        """Fold the per-layer local flags — from ``layer_types`` (checked
        against num_hidden_layers) or the family's rule ``default_fn(i)`` —
        into (sliding_window, layer_sliding): all off -> no window; all on ->
        a uniform window; mixed -> flags. An explicit native layer_sliding
        key wins untouched."""
        if "layer_sliding" in kwargs:
            return
        n = d.get("num_hidden_layers", 32)  # the dataclass default
        lt = d.get("layer_types")
        pattern = (tuple(t == "sliding_attention" for t in lt) if lt
                   else tuple(bool(default_fn(i)) for i in range(n)))
        if len(pattern) != n:
            raise ValueError(f"{family} layer_types has {len(pattern)} entries for {n} layers")
        kwargs.setdefault("sliding_window", 4096)  # the HF Gemma config default
        if not any(pattern):
            kwargs["sliding_window"] = None
        elif not all(pattern):
            kwargs["layer_sliding"] = pattern

    @classmethod
    def _apply_qwen_window(cls, kwargs: dict[str, Any], d: dict[str, Any]) -> None:
        """Hugging Face qwen2/qwen3: the window applies only under
        use_sliding_window, to layers i >= max_window_layers (default 28) or
        as layer_types says; an explicit native layer_sliding key wins."""
        if "layer_sliding" in kwargs:
            return
        if not d.get("use_sliding_window", False):
            kwargs["sliding_window"] = None
            return
        mwl = d.get("max_window_layers", 28)
        cls._apply_sliding_pattern(kwargs, d, "qwen", lambda i: i >= mwl)

    @staticmethod
    def _deepseek_fields(kwargs: dict[str, Any], d: dict[str, Any]) -> None:
        """A Hugging Face deepseek_v3 config: the MLA widths, the routing
        fields, the width swap (``intermediate_size`` the expert width,
        ``intermediate_size_mlp`` the dense layers'), the MoE layers from
        first_k_dense_replace, and the attention scale
        qk_head_dim^-0.5 * mscale(factor, mscale_all_dim)^2 under yarn,
        carried by query_pre_attn_scalar."""
        kwargs["kv_lora_rank"] = int(d.get("kv_lora_rank", 512))
        qlr = d.get("q_lora_rank")
        kwargs["q_lora_rank"] = int(qlr) if qlr else None
        kwargs["qk_nope_head_dim"] = int(d.get("qk_nope_head_dim", 128))
        kwargs["qk_rope_head_dim"] = int(d.get("qk_rope_head_dim", 64))
        kwargs["v_head_dim"] = int(d.get("v_head_dim", 128))
        # HF's head_dim here is the rotary dim, not a projection width.
        kwargs["explicit_head_dim"] = None
        kwargs["rope_interleaved"] = bool(d.get("rope_interleave", True))
        if d.get("attention_bias"):  # HF: on q_a/q_proj, kv_a_proj_with_mqa, o_proj
            kwargs.setdefault("attention_in_bias", True)
            kwargs.setdefault("attention_out_bias", True)
        n_routed = int(d.get("n_routed_experts") or 0)
        kwargs["num_local_experts"] = n_routed
        if n_routed:
            kwargs["intermediate_size_mlp"] = int(d.get("intermediate_size", 11008))
            kwargs["intermediate_size"] = int(d.get("moe_intermediate_size", 2048))
            kwargs["num_experts_per_tok"] = int(d.get("num_experts_per_tok", 8))
            kwargs["moe_norm_topk_prob"] = bool(d.get("norm_topk_prob", True))
            kwargs["moe_n_group"] = int(d.get("n_group", 1))
            kwargs["moe_topk_group"] = int(d.get("topk_group", 1))
            kwargs["moe_routed_scaling_factor"] = float(d.get("routed_scaling_factor", 1.0))
            nse = d.get("n_shared_experts")
            kwargs["n_shared_experts"] = 1 if nse is None else int(nse)
            first_dense = int(d.get("first_k_dense_replace", 0))
            pattern = tuple(i >= first_dense for i in range(d.get("num_hidden_layers", 32)))
            if not all(pattern):
                kwargs["moe_layer_pattern"] = pattern
        qk_hd = kwargs["qk_nope_head_dim"] + kwargs["qk_rope_head_dim"]
        rs = d.get("rope_scaling") or {}
        mad = rs.get("mscale_all_dim")
        if mad and float(rs.get("factor", 1.0)) > 1.0:
            kwargs["query_pre_attn_scalar"] = qk_hd / _yarn_mscale(float(rs["factor"]), float(mad)) ** 4
        else:
            kwargs["query_pre_attn_scalar"] = float(qk_hd)

    @staticmethod
    def _rope_scaling_fields(kwargs: dict[str, Any], d: dict[str, Any]) -> None:
        """The Hugging Face ``rope_scaling`` dict as native fields
        (transformers' _compute_{llama3,yarn,longrope}_parameters)."""
        rs = d.get("rope_scaling") or {}
        if not rs:
            return
        kind = rs.get("rope_type", rs.get("type"))
        if kind not in _ROPE_SCALINGS[1:]:
            raise NotImplementedError(f"rope_scaling type {kind!r} is not supported")
        factor = float(rs.get("factor", 1.0))
        kwargs["rope_scaling_kind"] = kind
        kwargs["rope_scaling_factor"] = factor
        if kind == "llama3":
            kwargs["rope_low_freq_factor"] = float(rs.get("low_freq_factor", 1.0))
            kwargs["rope_high_freq_factor"] = float(rs.get("high_freq_factor", 4.0))
            kwargs["rope_original_max_position"] = int(
                rs.get("original_max_position_embeddings", 8192))
        elif kind == "yarn":
            kwargs["rope_beta_fast"] = float(rs.get("beta_fast") or 32)
            kwargs["rope_beta_slow"] = float(rs.get("beta_slow") or 1)
            kwargs["rope_truncate"] = bool(rs.get("truncate", True))
            kwargs["rope_original_max_position"] = int(
                rs.get("original_max_position_embeddings") or d.get("max_position_embeddings", 2048))
            af = rs.get("attention_factor")
            if af is None:  # from the factor, and DeepSeek's mscale pair
                ms, mad = rs.get("mscale"), rs.get("mscale_all_dim")
                af = (_yarn_mscale(factor, ms) / _yarn_mscale(factor, mad) if ms and mad
                      else _yarn_mscale(factor))
            kwargs["rope_attention_factor"] = float(af)
        elif kind == "longrope":
            # Phi-3 keeps original_max_position_embeddings at the top level;
            # then the factor is max / original, whatever rope_scaling says.
            lf, sf = rs.get("long_factor"), rs.get("short_factor")
            if not lf or not sf:
                raise ValueError("longrope rope_scaling needs long_factor and short_factor lists")
            kwargs["rope_long_factor"] = tuple(float(x) for x in lf)
            kwargs["rope_short_factor"] = tuple(float(x) for x in sf)
            max_pos = int(d.get("max_position_embeddings", 2048))
            orig = d.get("original_max_position_embeddings") or rs.get(
                "original_max_position_embeddings")
            if orig:
                factor = max_pos / int(orig)
            else:
                orig = max_pos
            kwargs["rope_original_max_position"] = int(orig)
            af = rs.get("attention_factor")
            if af is None:
                af = 1.0 if factor <= 1.0 else math.sqrt(1 + math.log(factor) / math.log(int(orig)))
            kwargs["rope_attention_factor"] = float(af)
            kwargs["rope_scaling_factor"] = float(factor)

    @staticmethod
    def _llama4_fields(kwargs: dict[str, Any], d: dict[str, Any]) -> None:
        """A Hugging Face llama4_text config (transformers' Llama4TextConfig
        defaults): interleaved rope, the L2 q/k norm under use_qk_norm, the
        temperature tuning, chunked local layers from ``layer_types`` (else
        every fourth layer global), NoPE layers from ``no_rope_layers`` (else
        every fourth), and the MoE layers from ``moe_layers`` (else every
        ``interleave_moe_layer_step``-th)."""
        kwargs.setdefault("explicit_head_dim", 128)
        kwargs.setdefault("rope_interleaved", True)
        if d.get("use_qk_norm", True):
            kwargs.setdefault("qk_l2_norm", True)
        kwargs.setdefault("attn_temperature_tuning", d.get("attn_temperature_tuning", True))
        kwargs.setdefault("attn_floor_scale", float(d.get("floor_scale", 8192)))
        kwargs.setdefault("attn_scale_coef", float(d.get("attn_scale", 0.1)))
        n = d.get("num_hidden_layers", 48)
        if "layer_sliding" not in kwargs:
            lt = d.get("layer_types")
            nn = d.get("num_hidden_layers", 32)  # the dataclass default
            chunked = (tuple(t == "chunked_attention" for t in lt) if lt
                       else tuple((i + 1) % 4 != 0 for i in range(nn)))
            if len(chunked) != nn:
                raise ValueError(f"llama4 layer_types has {len(chunked)} entries for {nn} layers")
            kwargs.setdefault("attention_chunk_size", d.get("attention_chunk_size", 8192))
            if not any(chunked):
                kwargs["attention_chunk_size"] = None
            elif not all(chunked):
                kwargs["layer_sliding"] = chunked
        nr = d.get("no_rope_layers") or [0 if (i + 1) % 4 == 0 else 1 for i in range(n)]
        if len(nr) != n:
            raise ValueError(f"llama4 no_rope_layers has {len(nr)} entries for {n} layers")
        if not all(nr):
            kwargs.setdefault("layer_rope", tuple(bool(x) for x in nr))
        step = d.get("interleave_moe_layer_step", 1)
        moe_layers = d.get("moe_layers")
        if moe_layers is None:
            moe_layers = [i for i in range(n) if (i + 1) % step == 0]
        if d.get("num_local_experts", 16) and moe_layers:
            kwargs.setdefault("num_local_experts", d.get("num_local_experts", 16))
            kwargs.setdefault("num_experts_per_tok", d.get("num_experts_per_tok", 1))
            if len(moe_layers) != n:
                kwargs.setdefault("moe_layer_pattern", tuple(i in set(moe_layers) for i in range(n)))
        else:
            kwargs["num_local_experts"] = 0
        kwargs.setdefault("intermediate_size_mlp", d.get("intermediate_size_mlp"))

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "LlamaConfig":
        """Build from a config dict with the JAX package's ``from_hf_config``
        rules: a native one (either package's ``save_params``), whose fields
        read back by name, or a Hugging Face one of model_type llama,
        mistral, mixtral, phi3, qwen2, qwen3, qwen3_moe, gemma, gemma2,
        gemma3_text, llama4_text, deepseek_v3 or the gemma3 and llama4
        wrappers (their ``text_config``), which contributes only the fields
        that mean the same thing in its family, with the family's defaults.
        Raises NotImplementedError on a native config that turns on a delta
        its family does not have."""
        model_type = d.get("model_type", "llama")
        text = extract_text_config(d)
        if text is not None:
            return cls.from_dict(text)
        family = "llama" if model_type == "" else model_type
        if family not in _CARRIED_DELTAS:
            raise NotImplementedError(
                f"model_type {model_type!r} is not supported ({', '.join(_CARRIED_DELTAS)} and "
                "the gemma3 and llama4 wrappers are)"
            )
        known = {f.name for f in dataclasses.fields(cls)}
        native = bool(d.get("fls_native")) or "attention_in_bias" in d
        if native:
            # The deltas the family does not carry must be off.
            carried = _CARRIED_DELTAS[family]
            off = {k: v for k, v in _FAMILY_DELTAS.items() if k not in carried}
            for name, off_val in off.items():
                val = d.get(name, off_val)
                if val in ([], ()):
                    val = None
                if val != off_val:
                    raise NotImplementedError(
                        f"config field {name}={val!r} is not supported by the "
                        f"PyTorch port yet (model_type {model_type!r})"
                    )
            kwargs = {k: d[k] for k in known if k in d}
        else:
            allowed = _UNIVERSAL_HF_FIELDS | _FAMILY_HF_FIELDS.get(family, frozenset())
            kwargs = {k: d[k] for k in known if k in d and k in allowed}
        if family in ("llama", "qwen3", "qwen3_moe"):
            if d.get("attention_bias"):  # one flag for all four projections
                kwargs.setdefault("attention_in_bias", True)
                kwargs.setdefault("attention_out_bias", True)
        if family == "llama":
            kwargs["sliding_window"] = None  # HF Llama ignores a stray window
        elif family == "qwen2":
            # HF Qwen2: bias on q/k/v, none on o_proj.
            kwargs.setdefault("attention_in_bias", True)
            kwargs.setdefault("attention_out_bias", False)
            cls._apply_qwen_window(kwargs, d)
        elif family in ("qwen3", "qwen3_moe"):
            kwargs.setdefault("qk_norm", True)
            cls._apply_qwen_window(kwargs, d)
            if family == "qwen3":
                kwargs.setdefault("explicit_head_dim", 128)  # Qwen3Config's default
            else:  # Qwen3MoeConfig has no head_dim default: hidden / heads
                if not d.get("num_experts") and not d.get("num_local_experts"):
                    raise ValueError("qwen3_moe config without num_experts")
                kwargs.setdefault("num_local_experts", d.get("num_experts", 0))
                kwargs.setdefault("num_experts_per_tok", d.get("num_experts_per_tok", 8))
                kwargs.setdefault("moe_norm_topk_prob", d.get("norm_topk_prob", False))
                # Dense layers (mlp_only_layers, decoder_sparse_step) are a
                # fact of the checkpoint; the pattern records them.
                step = d.get("decoder_sparse_step", 1)
                only = set(d.get("mlp_only_layers") or [])
                pattern = tuple(i not in only and (i + 1) % step == 0
                                for i in range(d.get("num_hidden_layers", 32)))
                if not all(pattern):
                    kwargs.setdefault("moe_layer_pattern", pattern)
        elif family.startswith("gemma"):
            # setdefault, so explicit native keys (explicit nulls included)
            # win over the HF names and defaults.
            for key in ("norm_unit_offset", "embed_scale", "tie_word_embeddings"):
                kwargs.setdefault(key, True)
            kwargs.setdefault("explicit_head_dim", 256)
            if not native:
                # HF Gemma MLPs ignore the legacy hidden_act key.
                kwargs["hidden_act"] = d.get("hidden_activation") or "gelu_pytorch_tanh"
            if family == "gemma":
                kwargs["sliding_window"] = None
            else:
                kwargs["ffw_sandwich_norms"] = True
        elif family == "llama4_text":
            cls._llama4_fields(kwargs, d)
        elif family == "deepseek_v3" and not native:
            # A native config's fields read back as saved: re-deriving them
            # from the HF names would undo the width swap.
            cls._deepseek_fields(kwargs, d)
        elif family == "mixtral" and not d.get("num_local_experts"):
            raise ValueError("mixtral config without num_local_experts")
        # mistral, mixtral and phi3: sliding_window flows through by name (may
        # be null); phi3's fused projections are split when its checkpoint is.
        if family == "gemma2":
            kwargs.setdefault("attn_logit_softcap", d.get("attn_logit_softcapping", 50.0))
            kwargs.setdefault("final_logit_softcap", d.get("final_logit_softcapping", 30.0))
            kwargs.setdefault("query_pre_attn_scalar", 256)
            # Every even layer slides.
            cls._apply_sliding_pattern(kwargs, d, "gemma2", lambda i: (i + 1) % 2)
        elif family == "gemma3_text":
            kwargs.setdefault("qk_norm", True)
            kwargs.setdefault("query_pre_attn_scalar", 256)
            kwargs.setdefault("rope_theta", 1_000_000.0)  # global layers
            kwargs.setdefault("rope_local_theta", d.get("rope_local_base_freq", 10_000.0))
            # 5:1 local/global: every 6th layer is global.
            cls._apply_sliding_pattern(kwargs, d, "gemma3", lambda i: (i + 1) % 6 != 0)
        if family not in _MOE_FAMILIES:
            kwargs["num_local_experts"] = 0  # a stray key in a dense export
        if d.get("head_dim") and family != "deepseek_v3":
            kwargs["explicit_head_dim"] = d["head_dim"]
        kwargs.setdefault("num_key_value_heads", d.get("num_attention_heads", 32))
        for key in ("layer_sliding", "layer_rope", "moe_layer_pattern", "rope_long_factor",
                    "rope_short_factor"):
            if kwargs.get(key) is not None:
                kwargs[key] = tuple(kwargs[key])  # json gives a list
        cls._rope_scaling_fields(kwargs, d)
        cfg = cls(**kwargs)
        if cfg.rope_scaling_kind == "longrope":
            for name, fac in (("long_factor", cfg.rope_long_factor),
                              ("short_factor", cfg.rope_short_factor)):
                if fac is None or len(fac) != cfg.head_dim // 2:
                    raise ValueError(
                        f"longrope {name} needs {cfg.head_dim // 2} entries (head_dim "
                        f"{cfg.head_dim}), got {None if fac is None else len(fac)}"
                    )
        return cfg

    @classmethod
    def from_pretrained(cls, model_path: str) -> "LlamaConfig":
        with open(os.path.join(model_path, "config.json")) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict[str, Any]:
        """The native config.json payload (read back by both packages)."""
        return {
            "fls_native": True,
            "use_sliding_window": self.sliding_window is not None,
            **dataclasses.asdict(self),
        }


STORAGE_LOCATIONS = ("gpu", "cpu", "disk")
DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
}


# Named fault-injection sites (``faults/inject.py``), the JAX package's list:
# the I/O sites, the silent-corruption sites (``corrupt_*``: a one-bit flip
# or a short read of the bytes), the replica sites of the fleet
# (``serve/fleet.py``: ``replica_kill`` crashes a whole engine mid-sweep,
# ``replica_stall`` wedges its thread until the fleet declares it dead) and
# the resource-pressure sites (``runtime/pressure.py``: ``host_oom`` raises
# ``MemoryError`` in a layer read, typed ``HostOOMError`` and retried;
# ``disk_full`` raises ``ENOSPC`` in a spill write, typed ``DiskFullError``
# and retried; ``link_throttle`` stalls an upload, it never errors). Each is
# fired where the JAX package fires it: ``shard_read``, ``host_oom`` and
# ``corrupt_shard`` in ``ShardWeightSource``'s reads (``corrupt_shard`` in
# the adapter store's too), ``link_throttle`` and ``device_put`` in its
# retried upload, ``disk_full`` and ``corrupt_activation`` in the activation
# store (``corrupt_activation`` in the KV pool's page reads too),
# ``queue_admission`` in ``AdmissionQueue.submit``, ``engine_step`` at each
# shard step of a serving sweep and the replica sites in ``serve/fleet.py``.
FAULT_SITES = (
    "shard_read",
    "device_put",
    "engine_step",
    "queue_admission",
    "corrupt_shard",
    "corrupt_activation",
    "replica_kill",
    "replica_stall",
    "host_oom",
    "disk_full",
    "link_throttle",
)


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Deterministic fault injection (``faults/inject.py``), off by default.

    The rates partition one uniform draw per site fire: ``error_rate`` an
    error, ``truncate_rate`` a truncated read, ``latency_rate`` a
    ``latency_s`` sleep, else clean. The schedule is a pure function of
    ``(seed, site, per-site call count)``. ``sites`` () means every site;
    ``max_faults`` caps the faults injected (-1 = unlimited)."""

    enabled: bool = False
    seed: int = 0
    error_rate: float = 0.0
    truncate_rate: float = 0.0
    latency_rate: float = 0.0
    latency_s: float = 0.01
    sites: tuple[str, ...] = ()
    max_faults: int = -1

    def __post_init__(self) -> None:
        for name in ("error_rate", "truncate_rate", "latency_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        # A decimal partition like 0.1 + 0.2 + 0.7 sums past 1 in floats.
        if self.error_rate + self.truncate_rate + self.latency_rate > 1.0 + 1e-9:
            raise ValueError("fault rates must sum to <= 1")
        if self.latency_s < 0:
            raise ValueError("latency_s must be >= 0")
        unknown = set(self.sites) - set(FAULT_SITES)
        if unknown:
            raise ValueError(f"unknown fault sites {sorted(unknown)} (one of {FAULT_SITES})")
        object.__setattr__(self, "sites", tuple(self.sites))


@dataclasses.dataclass(frozen=True)
class PressureConfig:
    """The resource-pressure brownout controller (``runtime/pressure.py``),
    off by default; ``--pressure`` on both CLIs turns it on.

    A ``PressureMonitor`` samples the host's MemAvailable, the spill disk's
    free bytes, the card's headroom and the host-to-device link rate every
    ``poll_s``; when a threshold trips, or a hard resource failure (a real
    or injected ``host_oom``/``disk_full``) is noted, the
    ``BrownoutController`` walks an ordered, reversible ladder (stop
    speculative drafts, shrink the host shard cache, evict adapters, evict
    pooled prefix KV, unpin resident layers, shed new admissions with a
    typed ``Overloaded`` carrying ``shed_retry_after_s``, drain fleet
    replicas), and steps back down one level per ``step_down_polls``
    consecutive clean polls. A threshold of 0 turns its signal off (events
    still drive the ladder)."""

    enabled: bool = False
    poll_s: float = 1.0
    host_min_gb: float = 1.0  # MemAvailable floor
    disk_min_gb: float = 1.0  # free bytes of disk_folder's filesystem
    hbm_headroom_frac: float = 0.05  # the card's free share floor
    link_min_gbps: float = 0.0  # streamed-bytes rate floor
    cache_shrink_frac: float = 0.5  # the cache and adapter levers' budget multiplier
    shed_retry_after_s: float = 1.0  # Overloaded.retry_after_s
    step_down_polls: int = 3  # consecutive clean polls per step down

    def __post_init__(self) -> None:
        if self.poll_s <= 0:
            raise ValueError("poll_s must be > 0")
        for name in ("host_min_gb", "disk_min_gb", "link_min_gbps", "shed_retry_after_s"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")
        for name in ("hbm_headroom_frac", "cache_shrink_frac"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.step_down_polls < 1:
            raise ValueError("step_down_polls must be >= 1")


@dataclasses.dataclass(frozen=True)
class AdapterConfig:
    """Multi-tenant LoRA serving (``adapters/``): ``dir`` is the registry
    root, one subdirectory per named adapter; empty (the default) turns
    adapters off, and a request that names one fails typed
    (``AdapterNotFound``). ``max_gb`` budgets the host LRU of adapter
    factors (``adapters/loader.py``): GB, 0 to turn adapters off, or None
    (auto) for 5% of the available RAM."""

    dir: str = ""
    max_gb: float | None = None

    def __post_init__(self) -> None:
        if self.max_gb is not None and self.max_gb < 0:
            raise ValueError(f"max_gb must be >= 0 (or None for auto), got {self.max_gb}")


@dataclasses.dataclass(frozen=True)
class FrameworkConfig:
    """Runtime flags of the batch CLI.

    ``storage_location``: where activations wait between shards — ``gpu``
    (device memory), ``cpu`` (host RAM, spilling to ``disk_folder`` past
    ``max_activation_in_cpu`` prompts) or ``disk``. ``kv_cache`` selects the
    KV-cache decode loop over the reference's re-scoring loop.

    ``num_devices``: how many devices the entry points use (0 = every
    visible card; on the CPU, that many CPU stages or ranks, at least 1).
    With more than one, ``data_parallel`` splits the prompts over them, each
    streaming the whole model from one shared read; otherwise the layers run
    as the interleaved MP pipeline across them. ``tensor_parallel`` > 1
    splits every streamed layer Megatron-style over that many of them (in
    place of the pipeline; with ``data_parallel``, over each group of that
    many).

    The host path, with the JAX package's defaults: ``verify_weights``
    checks every layer load against ``integrity.json``; ``host_cache_gb``
    budgets the process host shard cache (None = auto, a quarter of the
    available RAM; 0 = off); ``readahead_threads`` sizes the page-cache
    readahead pool (0 = off, which the JAX package does not offer);
    ``io_retry_*`` drive the retry policy of layer reads.

    The decode modes of ``kv_cache``, with the JAX package's defaults:
    ``decode_resident`` keeps every shard on the device after the prefill
    pass (auto: when the weights fit in 45% of the card's memory; unknown
    memory, as on the CPU, resolves to off); ``decode_fused`` runs a
    block's greedy decode steps on the device in one go, captured as one
    CUDA graph where the model allows it (auto: whenever resident, greedy
    and within the memory budget; ``on`` raises when that does not hold);
    ``speculative_k`` verifies that many prompt-lookup drafts per pass
    (greedy only; 0 = off; the fused steps take precedence).

    ``hbm_pin_gb``: the residency tier's budget in GB (``runtime/
    residency.py``): the layers that stream the most bytes per pass are
    loaded once and kept on the card, and every pass streams only the rest.
    0 (the default) is off; None is auto: the card's free memory less 35%
    of its total, off on the CPU.

    ``score_sink_max_device``: how many prompts' head scores may wait on the
    card, their host copies in flight, before the oldest resolve.
    ``resume``: in disk mode, start at the first shard a crashed run with
    the same workload left (its marker in ``disk_folder``).
    ``long_context``: a prompt whose prefix is longer than
    ``max_token_len`` is scored (or decoded) exactly over a
    sequence-parallel mesh of the run's devices, the cap then
    ``len(devices) * max_token_len`` (``runtime/longcontext.py``), instead
    of the reference's truncation (its ``utils.py:14,250,254``).

    The paged prefix-KV pool of the serving engine (``runtime/kvpool.py``):
    ``kv_page_tokens`` rows per page (<= 0 disables the pool),
    ``kv_pool_gb`` its host-RAM budget (None = auto, 5% of the available
    RAM capped at 4 GB; 0 disables), ``kv_host_spill`` whether cold pages
    spill to checksummed files under ``disk_folder/kvpool`` or drop.

    ``adapters``: the LoRA adapter registry the serving engine reads
    (:class:`AdapterConfig`; the batch CLI accepts and keeps it).

    ``use_pallas`` (the JAX package's name for its flag): whether the
    attention goes through the hand-written kernels of
    ``ops/flash_attention.py`` (True, the default; the parsers read auto
    as True) or the plain attention ops on every device (False: no kernel
    launches). On CPU tensors the kernels' wrappers run their plain
    versions either way.

    Observability (``obs/``, the JAX package's fields and defaults):
    ``verbose_metrics`` prints one JSON line per structured timing event;
    ``profile_dir`` writes a ``torch.profiler`` Chrome trace of the run
    there ("" = off); ``trace`` records the sweep timeline into the
    process tracer, exported at run end to ``trace_out`` (Chrome JSON, or
    JSONL for a ``.jsonl`` path; "" = ``fls_trace.json``); ``journal_dir``
    enables the durable event journal, rotated at ``journal_max_mb``;
    ``incidents_dir`` arms the incident recorder (a journal event at or
    above ``incident_trigger`` captures a bundle there, settled for
    ``incident_settle_s``, debounced for ``incident_debounce_s``, the
    directory budgeted at ``incidents_max_mb``). Every one is off by
    default, at the cost of one bool read per emit and its scalar arguments.

    ``faults``: fault injection (:class:`FaultConfig`), off by default;
    while it is on, the auto budgets of the host cache and the residency
    tier resolve to off, as in the JAX package (a cache hit or a pin would
    skip the draws a seeded schedule makes; an explicit budget still
    wins). ``pressure``: the brownout ladder (:class:`PressureConfig`),
    off by default.
    """

    model_path: str = "./"
    num_batch: int = 1
    layer_num_per_shard: int = 1
    storage_location: str = "cpu"
    max_activation_in_cpu: int = 100
    data_parallel: bool = False
    num_devices: int = 0
    # Megatron tensor parallelism over this many devices (1 = off); it
    # composes with data_parallel (groups of tensor_parallel devices) and
    # takes the MP pipeline's place.
    tensor_parallel: int = 1
    disk_folder: str = "./temp"
    num_gen_token: int = 1
    dtype: str = "bfloat16"
    block_size: int = 8
    max_token_len: int = DEFAULT_MAX_TOKEN_LEN
    bucket_multiple: int = 64
    kv_cache: bool = False
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    seed: int = 0
    prefetch_depth: int = 1
    device: str = "cuda"
    io_retry_attempts: int = 4
    io_retry_base_s: float = 0.05  # first backoff; doubles per attempt
    io_retry_deadline_s: float = 60.0  # overall wall cap per call; 0 = none
    verify_weights: bool = True
    host_cache_gb: float | None = None
    readahead_threads: int = 2
    decode_resident: str = "auto"  # 'auto' | 'on' | 'off'
    decode_fused: str = "auto"  # 'auto' | 'on' | 'off'
    speculative_k: int = 0
    hbm_pin_gb: float | None = 0.0
    score_sink_max_device: int = 16
    resume: bool = False
    long_context: bool = False
    use_pallas: bool = True
    kv_page_tokens: int = 16
    kv_pool_gb: float | None = None
    kv_host_spill: bool = True
    verbose_metrics: bool = False
    profile_dir: str = ""
    trace: bool = False
    trace_out: str = ""
    journal_dir: str = ""
    journal_max_mb: float = 16.0
    incidents_dir: str = ""
    incidents_max_mb: float = 256.0
    incident_trigger: str = "error"  # info|warning|error|critical
    incident_debounce_s: float = 60.0
    incident_settle_s: float = 1.0
    adapters: AdapterConfig = dataclasses.field(default_factory=AdapterConfig)
    faults: FaultConfig = dataclasses.field(default_factory=FaultConfig)
    pressure: PressureConfig = dataclasses.field(default_factory=PressureConfig)

    def __post_init__(self) -> None:
        if self.storage_location not in STORAGE_LOCATIONS:
            raise ValueError(
                f"storage_location must be one of {STORAGE_LOCATIONS}, got "
                f"{self.storage_location!r}"
            )
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {tuple(DTYPES)}, got {self.dtype!r}")
        if self.num_batch < 1 or self.layer_num_per_shard < 1 or self.block_size < 1:
            raise ValueError("num_batch, layer_num_per_shard and block_size must be >= 1")
        if self.prefetch_depth < 0:
            raise ValueError("prefetch_depth must be >= 0")
        if self.num_devices < 0:
            raise ValueError(f"num_devices must be >= 0 (0 = all), got {self.num_devices}")
        if self.tensor_parallel < 1:
            raise ValueError("tensor_parallel must be >= 1")
        if (self.top_k or self.top_p) and self.temperature <= 0:
            raise ValueError("top_k/top_p require temperature > 0")
        if self.decode_resident not in ("auto", "on", "off"):
            raise ValueError(f"decode_resident must be auto|on|off, got {self.decode_resident!r}")
        if self.decode_fused not in ("auto", "on", "off"):
            raise ValueError(f"decode_fused must be auto|on|off, got {self.decode_fused!r}")
        if not 0 <= self.speculative_k <= 64:
            raise ValueError(f"speculative_k must be in [0, 64], got {self.speculative_k}")
        if self.speculative_k and self.temperature > 0:
            # Greedy verification is exact; sampling would need rejection sampling.
            raise ValueError("speculative_k requires greedy (temperature=0)")
        if self.io_retry_attempts < 1:
            raise ValueError("io_retry_attempts must be >= 1")
        if self.io_retry_base_s < 0 or self.io_retry_deadline_s < 0:
            raise ValueError("io_retry_base_s/io_retry_deadline_s must be >= 0")
        if self.host_cache_gb is not None and self.host_cache_gb < 0:
            raise ValueError(
                f"host_cache_gb must be >= 0 (or None for auto), got {self.host_cache_gb}")
        if self.readahead_threads < 0:
            raise ValueError("readahead_threads must be >= 0")
        if self.hbm_pin_gb is not None and self.hbm_pin_gb < 0:
            raise ValueError(
                f"hbm_pin_gb must be >= 0 (or None for auto), got {self.hbm_pin_gb}")
        if self.score_sink_max_device < 1:
            raise ValueError("score_sink_max_device must be >= 1")
        if self.kv_pool_gb is not None and self.kv_pool_gb < 0:
            raise ValueError(f"kv_pool_gb must be >= 0 (or None for auto), got {self.kv_pool_gb}")
        if self.journal_max_mb <= 0:
            raise ValueError("journal_max_mb must be > 0")
        if self.incidents_max_mb <= 0:
            raise ValueError("incidents_max_mb must be > 0")
        if self.incident_trigger not in ("info", "warning", "error", "critical"):
            raise ValueError("incident_trigger must be info|warning|error|critical, "
                             f"got {self.incident_trigger!r}")
        if self.incident_debounce_s < 0 or self.incident_settle_s < 0:
            raise ValueError("incident_debounce_s/incident_settle_s must be >= 0")

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    def effective_host_cache_bytes(self) -> int:
        """The host cache budget in bytes: ``host_cache_gb`` GB when given
        (0 = off), else auto; unknown free RAM, or fault injection, resolves
        to off."""
        if self.host_cache_gb is not None:
            return int(self.host_cache_gb * 1e9)
        if self.faults.enabled:
            return 0
        from flexible_llm_sharding_tpu_torch.runtime.hostcache import auto_budget_bytes

        return auto_budget_bytes()

    def effective_kv_pool_bytes(self) -> int:
        """The prefix-KV pool's budget in bytes: ``kv_pool_gb`` GB when given
        (0 = off), else auto (``kvpool._auto_budget_bytes``)."""
        if self.kv_pool_gb is not None:
            return int(self.kv_pool_gb * 1e9)
        from flexible_llm_sharding_tpu_torch.runtime.kvpool import _auto_budget_bytes

        return _auto_budget_bytes()

    def effective_adapter_bytes(self) -> int:
        """The adapter store's budget in bytes: ``adapters.max_gb`` GB when
        given (0 = off), else auto (``adapters.loader._auto_budget_bytes``)."""
        if self.adapters.max_gb is not None:
            return int(self.adapters.max_gb * 1e9)
        from flexible_llm_sharding_tpu_torch.adapters.loader import _auto_budget_bytes

        return _auto_budget_bytes()

    def effective_hbm_pin_bytes(self, device=None) -> int:
        """The residency tier's budget in bytes: ``hbm_pin_gb`` GB when
        given (0 = off), else auto on ``device``; fault injection resolves
        auto to off."""
        if self.hbm_pin_gb is not None:
            return int(self.hbm_pin_gb * 1e9)
        if self.faults.enabled:
            return 0
        from flexible_llm_sharding_tpu_torch.runtime.residency import auto_pin_budget_bytes

        return auto_pin_budget_bytes(device)

    def decode_resident_enabled(self, model_cfg: LlamaConfig, n_weight_chips: int = 1,
                                device=None) -> bool:
        """Resolve ``decode_resident`` for a model: auto is on when the
        weights per card (``n_weight_chips`` cards share them) are at most
        45% of the card's known memory, and off when it is unknown."""
        if self.decode_resident != "auto":
            return self.decode_resident == "on"
        from flexible_llm_sharding_tpu_torch.utils import metrics

        hbm_gb = metrics.chip_hbm_gb(device)
        if not hbm_gb:
            return False
        per_chip = metrics.weight_bytes_per_chip(model_cfg, self.dtype, n_weight_chips)
        return per_chip <= 0.45 * hbm_gb * 1e9

    def retry_policy(self):
        """The retry policy of this run's layer reads."""
        from flexible_llm_sharding_tpu_torch.faults.retry import RetryPolicy

        return RetryPolicy(max_attempts=self.io_retry_attempts, base_delay_s=self.io_retry_base_s,
                           deadline_s=self.io_retry_deadline_s or None)


def _parse_tenant_map(spec: str, what: str) -> dict[str, float]:
    """A ``"name=value,name=value"`` spec as ``{name: value}``; raises
    ValueError naming the bad entry."""
    out: dict[str, float] = {}
    for entry in (e.strip() for e in spec.split(",") if e.strip()):
        name, sep, value = entry.partition("=")
        if not sep or not name:
            raise ValueError(f"{what}: bad entry {entry!r} (expected tenant=value)")
        try:
            out[name] = float(value)
        except ValueError:
            raise ValueError(f"{what}: non-numeric value in {entry!r}") from None
    return out


@dataclasses.dataclass(frozen=True)
class SchedConfig:
    """The sweep scheduler (``serve/sched/``), off by default: the queue
    then pops first in, first out. On, it pops by strict SLO-class priority
    with deficit round robin over tenants inside a class, rate-limits
    tenants by token bucket (``RateLimited`` with ``retry_after_s``),
    preempts the youngest best-effort wave at a shard-0 boundary for a
    waiting interactive request (``preempt``), and merges same-prefix
    requests admitted at one boundary into one prefill (``coalesce``).

    Per-class admission deadlines in seconds (0 = none: the serve-level
    default applies); ``tenant_weights`` ("a=4,b=1", unlisted tenants weigh
    1) and ``tenant_limits`` (requests per second, unlisted tenants
    unlimited) in the tenant-map syntax; ``tenant_burst`` the bucket's
    capacity. ``interactive_phase_boost`` (>= 1) multiplies the replica
    fleet router's phase term for interactive requests."""

    enabled: bool = False
    interactive_deadline_s: float = 0.0
    standard_deadline_s: float = 0.0
    best_effort_deadline_s: float = 0.0
    tenant_weights: str = ""
    tenant_limits: str = ""
    tenant_burst: float = 4.0
    preempt: bool = True
    coalesce: bool = True
    interactive_phase_boost: float = 2.0

    def __post_init__(self) -> None:
        for name in ("interactive_deadline_s", "standard_deadline_s", "best_effort_deadline_s"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0 (0 = no default)")
        for t, w in self.tenant_weight_map().items():
            # The round robin's visit bound is ~1/min_weight.
            if not 0.01 <= w <= 1e6:
                raise ValueError(f"tenant_weights: weight for {t!r} must be in [0.01, 1e6], "
                                 f"got {w}")
        for t, r in self.tenant_limit_map().items():
            if r <= 0:
                raise ValueError(f"tenant_limits: rate for {t!r} must be > 0 "
                                 "(omit the tenant for unlimited)")
        if self.tenant_burst < 1:
            raise ValueError("tenant_burst must be >= 1")
        if self.interactive_phase_boost < 1:
            raise ValueError("interactive_phase_boost must be >= 1 (1 = no boost)")

    def tenant_weight_map(self) -> dict[str, float]:
        return _parse_tenant_map(self.tenant_weights, "tenant_weights")

    def tenant_limit_map(self) -> dict[str, float]:
        return _parse_tenant_map(self.tenant_limits, "tenant_limits")


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """SLO targets and error budgets (``obs/slo.py``), off by default:
    per-class p95 TTFT targets (``"interactive=0.5,standard=2.0"``), an
    aggregate per-token latency p95 target and an availability target
    (0 = off each); budgets are judged from ``min_samples`` samples on."""

    enabled: bool = False
    ttft_p95_s: str = ""
    token_latency_p95_s: float = 0.0
    availability_target: float = 0.0
    min_samples: int = 20

    def __post_init__(self) -> None:
        from flexible_llm_sharding_tpu_torch.utils.metrics import SLO_CLASS_NAMES

        for cls, target in _parse_tenant_map(self.ttft_p95_s, "ttft_p95_s").items():
            if cls not in SLO_CLASS_NAMES:
                raise ValueError(f"ttft_p95_s: unknown SLO class {cls!r} (one of {SLO_CLASS_NAMES})")
            if target <= 0:
                raise ValueError(f"ttft_p95_s: target for {cls!r} must be > 0 "
                                 "(omit the class for no target)")
        if self.token_latency_p95_s < 0:
            raise ValueError("token_latency_p95_s must be >= 0 (0 = off)")
        if not 0.0 <= self.availability_target < 1.0:
            raise ValueError("availability_target must be in [0, 1) — 0 disables, 1.0 would "
                             "allow no failures ever (an unpayable budget)")
        if self.min_samples < 1:
            raise ValueError("min_samples must be >= 1")

    def ttft_target_map(self) -> dict[str, float]:
        return _parse_tenant_map(self.ttft_p95_s, "ttft_p95_s")


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """The replica fleet's elasticity and sweep-phase stagger
    (``serve/autoscale.py``), off by default: the fleet then stays at
    ``ServeConfig.replicas``.

    On, a ``FleetAutoscaler`` polls every ``poll_s`` seconds and grows the
    fleet (to ``max``) when the worst SLO burn rate reaches
    ``grow_burn_rate`` with a trend that is not falling, or the queued
    fraction reaches ``grow_queue_frac``; it shrinks it (to ``min``) when
    both sit under their shrink thresholds. A signal must hold for
    ``confirm_polls`` polls, and each direction has its cooldown after any
    action. ``dry_run`` decides without acting. ``stagger`` holds replicas
    at their shard-0 boundary (at most ``stagger_hold_max_frac`` of a sweep)
    until the stagger error is at most ``stagger_tolerance``."""

    enabled: bool = False
    min: int = 1
    max: int = 4
    poll_s: float = 1.0
    grow_burn_rate: float = 1.0
    grow_queue_frac: float = 0.75
    shrink_burn_rate: float = 0.25
    shrink_queue_frac: float = 0.10
    confirm_polls: int = 3
    grow_cooldown_s: float = 10.0
    shrink_cooldown_s: float = 30.0
    dry_run: bool = False
    stagger: bool = True
    stagger_tolerance: float = 0.15
    stagger_hold_max_frac: float = 0.5

    def __post_init__(self) -> None:
        if self.min < 1:
            raise ValueError("autoscale min must be >= 1")
        if self.max < self.min:
            raise ValueError("autoscale max must be >= min")
        if self.poll_s <= 0:
            raise ValueError("autoscale poll_s must be > 0")
        if self.grow_burn_rate < 0 or self.shrink_burn_rate < 0:
            raise ValueError("autoscale burn-rate thresholds must be >= 0")
        if self.shrink_burn_rate > self.grow_burn_rate:
            raise ValueError("autoscale shrink_burn_rate must be <= grow_burn_rate (the "
                             "hysteresis band would invert)")
        for name in ("grow_queue_frac", "shrink_queue_frac"):
            if not 0.0 <= getattr(self, name) <= 1.0:
                raise ValueError(f"autoscale {name} must be in [0, 1]")
        if self.shrink_queue_frac > self.grow_queue_frac:
            raise ValueError("autoscale shrink_queue_frac must be <= grow_queue_frac (the "
                             "hysteresis band would invert)")
        if self.confirm_polls < 1:
            raise ValueError("autoscale confirm_polls must be >= 1")
        if self.grow_cooldown_s < 0 or self.shrink_cooldown_s < 0:
            raise ValueError("autoscale cooldowns must be >= 0")
        if not 0.0 < self.stagger_tolerance <= 1.0:
            raise ValueError("autoscale stagger_tolerance must be in (0, 1]")
        if not 0.0 <= self.stagger_hold_max_frac <= 1.0:
            raise ValueError("autoscale stagger_hold_max_frac must be in [0, 1]")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The serving engine's knobs (the JAX package's ``ServeConfig``, single
    engine): the admission queue's capacity, the requests one wave admits
    at a shard-0 boundary and the requests in flight, the default token
    budget and admission deadline (0 = none), the engine's idle poll, the
    stats line's interval (0 = off), the stall watchdog of a streamed
    engine (0 = off), and the admission-side size cap (0 = off).

    Speculative serving: ``speculative_k`` drafts per suffix per verify
    pass (0 = off, one token per sweep), by prompt lookup or, with
    ``draft_model_path``, by a small model pinned whole on the card. With
    ``spec_adaptive`` each SLO class's draft depth moves in [``spec_k_min``,
    ``spec_k_max``] by its acceptance over ``spec_window`` drafting passes
    (raised at ``spec_raise_threshold``, lowered at
    ``spec_backoff_threshold``), funding interactive rows first within a
    pass's ``spec_draft_budget`` tokens (0 = unlimited).

    The request WAL (``serve/wal.py``): ``wal_dir`` ("" = off) holds the
    crc-framed segments of every admission, sweep-boundary progress and
    terminal outcome, replayed at the next start; ``wal_fsync`` is
    ``always`` (every record), ``admit`` (admissions and terminals) or
    ``never`` (flushed to the kernel only); segments rotate at
    ``wal_max_mb``.

    The replica fleet (``serve/fleet.py``, engaged by the serve CLI when
    ``replicas`` > 1 or ``autoscale`` is on): ``replicas`` engines behind a
    router scoring ``router_phase_weight`` times the sweep fraction left to
    the next shard-0 admission plus ``router_depth_weight`` times the
    normalized load; a health monitor polling every
    ``router_health_poll_s`` seconds, which hard-fails a replica whose
    engine died or whose busy sweep stalled past ``watchdog_abort_s``, and
    drains one whose ``engine_recoveries`` reach ``router_drain_recoveries``
    (0 = off); ``autoscale`` (:class:`AutoscaleConfig`).

    ``metrics_port``: serve the engine's (or the fleet's) registry as a
    Prometheus ``/metrics`` endpoint and ``/metrics.json`` on 127.0.0.1 at
    this port (0 = an ephemeral port, None = off)."""

    queue_capacity: int = 64
    max_wave_requests: int = 8
    max_active_requests: int = 32
    default_max_new_tokens: int = 16
    default_deadline_s: float = 0.0
    idle_poll_s: float = 0.01
    stats_interval_s: float = 0.0
    watchdog_abort_s: float = 0.0
    max_request_tokens: int = 0
    speculative_k: int = 0
    draft_model_path: str = ""
    spec_adaptive: bool = False
    spec_k_min: int = 0
    spec_k_max: int = 8
    spec_window: int = 8
    spec_raise_threshold: float = 0.6
    spec_backoff_threshold: float = 0.2
    spec_draft_budget: int = 0
    sched: SchedConfig = dataclasses.field(default_factory=SchedConfig)
    slo: SLOConfig = dataclasses.field(default_factory=SLOConfig)
    wal_dir: str = ""
    wal_fsync: str = "admit"
    wal_max_mb: float = 64.0
    replicas: int = 1
    router_phase_weight: float = 1.0
    router_depth_weight: float = 1.0
    router_health_poll_s: float = 0.2
    router_drain_recoveries: int = 0
    autoscale: AutoscaleConfig = dataclasses.field(default_factory=AutoscaleConfig)
    metrics_port: int | None = None

    def __post_init__(self) -> None:
        if self.queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1")
        if self.max_wave_requests < 1:
            raise ValueError("max_wave_requests must be >= 1")
        if self.max_active_requests < self.max_wave_requests:
            raise ValueError("max_active_requests must be >= max_wave_requests")
        if self.default_max_new_tokens < 1:
            raise ValueError("default_max_new_tokens must be >= 1")
        if self.default_deadline_s < 0:
            raise ValueError("default_deadline_s must be >= 0")
        if self.idle_poll_s <= 0:
            raise ValueError("idle_poll_s must be > 0")
        if self.stats_interval_s < 0:
            raise ValueError("stats_interval_s must be >= 0")
        if self.watchdog_abort_s < 0:
            raise ValueError("watchdog_abort_s must be >= 0")
        if self.metrics_port is not None and not 0 <= self.metrics_port <= 65535:
            raise ValueError("metrics_port must be in [0, 65535] (or None for off), "
                             f"got {self.metrics_port}")
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        if self.router_phase_weight < 0 or self.router_depth_weight < 0:
            raise ValueError("router_phase_weight/router_depth_weight must be >= 0")
        if self.router_health_poll_s <= 0:
            raise ValueError("router_health_poll_s must be > 0")
        if self.router_drain_recoveries < 0:
            raise ValueError("router_drain_recoveries must be >= 0 (0 = off)")
        if self.max_request_tokens < 0:
            raise ValueError("max_request_tokens must be >= 0 (0 = off)")
        if not 0 <= self.speculative_k <= 64:
            raise ValueError(f"ServeConfig.speculative_k must be in [0, 64], got "
                             f"{self.speculative_k}")
        if self.spec_adaptive and self.speculative_k < 1:
            raise ValueError("spec_adaptive requires speculative_k >= 1 (the starting draft "
                             "depth)")
        if not 0 <= self.spec_k_min <= self.spec_k_max <= 64:
            raise ValueError("need 0 <= spec_k_min <= spec_k_max <= 64, got "
                             f"[{self.spec_k_min}, {self.spec_k_max}]")
        if self.spec_adaptive and not self.spec_k_min <= self.speculative_k <= self.spec_k_max:
            raise ValueError(
                "speculative_k must sit inside [spec_k_min, spec_k_max] when spec_adaptive is "
                f"on, got k={self.speculative_k} bounds=[{self.spec_k_min}, {self.spec_k_max}]")
        if self.spec_window < 1:
            raise ValueError("spec_window must be >= 1")
        if not 0.0 <= self.spec_backoff_threshold <= self.spec_raise_threshold <= 1.0:
            raise ValueError(
                "need 0 <= spec_backoff_threshold <= spec_raise_threshold <= 1, got "
                f"backoff={self.spec_backoff_threshold} raise={self.spec_raise_threshold}")
        if self.spec_draft_budget < 0:
            raise ValueError("spec_draft_budget must be >= 0 (0 = unlimited)")
        if self.autoscale.enabled and not self.autoscale.min <= self.replicas <= self.autoscale.max:
            raise ValueError(
                "replicas must sit inside [autoscale.min, autoscale.max] when autoscaling is "
                f"enabled, got replicas={self.replicas} bounds=[{self.autoscale.min}, "
                f"{self.autoscale.max}]")
        if self.wal_fsync not in ("always", "admit", "never"):
            raise ValueError(
                f"wal_fsync must be one of 'always'/'admit'/'never', got {self.wal_fsync!r}")
        if self.wal_max_mb <= 0:
            raise ValueError("wal_max_mb must be > 0")


def resolve_device(name: str = "cuda") -> torch.device:
    """``torch.device`` for ``name``. A CUDA request without a usable card
    raises; the CPU runs only when asked for by name. On CUDA, the runtime
    is initialised (a call on an indexed device, such as reading its memory
    stats, does not do it) and float32 products are pinned to full float32
    (no TF32) for matmuls and cuDNN."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass --device cpu (or "
                "device='cpu') to run on the CPU"
            )
        torch.cuda.init()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {name!r}")
    return dev


def indexed_device(device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` names the current card,
    which a scoring launch may move (it binds its tensor's card), so device
    lists keep every CUDA device indexed."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


__all__ = [
    "AdapterConfig",
    "AutoscaleConfig",
    "DEFAULT_MAX_TOKEN_LEN",
    "DTYPES",
    "FAULT_SITES",
    "FaultConfig",
    "FrameworkConfig",
    "LlamaConfig",
    "PressureConfig",
    "SLOConfig",
    "STORAGE_LOCATIONS",
    "SchedConfig",
    "ServeConfig",
    "indexed_device",
    "resolve_device",
]
