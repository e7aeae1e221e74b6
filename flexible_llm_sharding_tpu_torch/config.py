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
experts), with the linear, llama3, yarn and longrope rope scalings. Llama 4
and its fields (chunked attention, NoPE layers, q/k L2 norm) raise
``NotImplementedError`` when a config asks for them, instead of being
dropped silently.

``FrameworkConfig`` holds the batch CLI's runtime flags: the reference's ten
plus dtype, blocking, bucketing, KV-cache decode, sampling, prefetch and the
device. ``resolve_device`` is the one place that turns a device name into a
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

# Native config fields of the JAX package (Llama 4's) the port does not
# implement, with the value that means "feature off". A config carrying any
# other value raises.
_UNSUPPORTED: dict[str, Any] = {
    "attention_chunk_size": None,
    "layer_rope": None,
    "qk_l2_norm": False,
}

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
}
# Families of the JAX package this port does not run yet, with the ROADMAP
# item that brings them.
_LATER_FAMILIES = {"llama4": "2.3 (Llama 4)", "llama4_text": "2.3 (Llama 4)"}
# Families whose MLP is a mixture of experts (a stray num_local_experts
# elsewhere is dropped, as in the JAX package).
_MOE_FAMILIES = ("mixtral", "qwen3_moe", "deepseek_v3")

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

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "LlamaConfig":
        """Build from a config dict with the JAX package's ``from_hf_config``
        rules: a native one (either package's ``save_params``), whose fields
        read back by name, or a Hugging Face one of model_type llama,
        mistral, mixtral, phi3, qwen2, qwen3, qwen3_moe, gemma, gemma2,
        gemma3_text, deepseek_v3 or the gemma3 wrapper (its
        ``text_config``), which contributes only the fields that mean the
        same thing in its family, with the family's defaults. Raises
        NotImplementedError on Llama 4 and its fields, and on a native
        config that turns on a delta its family does not have."""
        model_type = d.get("model_type", "llama")
        text = extract_text_config(d)
        if text is not None:
            return cls.from_dict(text)
        family = "llama" if model_type == "" else model_type
        if family in _LATER_FAMILIES:
            raise NotImplementedError(
                f"model_type {model_type!r} is not ported yet (ROADMAP item {_LATER_FAMILIES[family]})"
            )
        if family not in _CARRIED_DELTAS:
            raise NotImplementedError(
                f"model_type {model_type!r} is not supported ({', '.join(_CARRIED_DELTAS)} and "
                "the gemma3 wrapper are)"
            )
        known = {f.name for f in dataclasses.fields(cls)}
        native = bool(d.get("fls_native")) or "attention_in_bias" in d
        if native:
            # The fields of the JAX package's config that this port does not
            # implement, and the deltas the family does not carry, must be off.
            carried = _CARRIED_DELTAS[family]
            off = {**_UNSUPPORTED, **{k: v for k, v in _FAMILY_DELTAS.items() if k not in carried}}
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
        for key in ("layer_sliding", "moe_layer_pattern", "rope_long_factor", "rope_short_factor"):
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
            **_UNSUPPORTED,
        }


STORAGE_LOCATIONS = ("gpu", "cpu", "disk")
DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
}


@dataclasses.dataclass(frozen=True)
class FrameworkConfig:
    """Runtime flags of the batch CLI.

    ``storage_location``: where activations wait between shards — ``gpu``
    (device memory), ``cpu`` (host RAM, spilling to ``disk_folder`` past
    ``max_activation_in_cpu`` prompts) or ``disk``. ``kv_cache`` selects the
    KV-cache decode loop over the reference's re-scoring loop.
    """

    model_path: str = "./"
    num_batch: int = 1
    layer_num_per_shard: int = 1
    storage_location: str = "cpu"
    max_activation_in_cpu: int = 100
    data_parallel: bool = False
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
        if (self.top_k or self.top_p) and self.temperature <= 0:
            raise ValueError("top_k/top_p require temperature > 0")

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


def resolve_device(name: str = "cuda") -> torch.device:
    """``torch.device`` for ``name``. A CUDA request without a usable card
    raises; the CPU runs only when asked for by name. On CUDA, float32
    products are pinned to full float32 (no TF32) for matmuls and cuDNN."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass --device cpu (or "
                "device='cpu') to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {name!r}")
    return dev


__all__ = [
    "DEFAULT_MAX_TOKEN_LEN",
    "DTYPES",
    "FrameworkConfig",
    "LlamaConfig",
    "STORAGE_LOCATIONS",
    "resolve_device",
]
