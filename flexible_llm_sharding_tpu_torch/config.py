"""Model and runtime configuration of the PyTorch/CUDA port.

``LlamaConfig`` keeps the part of the JAX package's config that the port
runs (field names and defaults unchanged, so the ``config.json`` that
``utils.checkpoint.save_params`` writes reads back in either package): the
dense families llama, mistral, phi3, qwen2, qwen3 and gemma 1/2/3, with
their deltas — q/k/v biases, sliding-window layers and their per-layer
pattern, (1+w) float32 RMSNorm, per-head q/k norm, a local rope base
beside a linearly scaled global one, sandwich norms, GeGLU, scaled
embeddings and the softcaps. The families, attention forms and rope
scalings that this port does not carry yet raise ``NotImplementedError``
when a config asks for them, instead of being dropped silently.

``FrameworkConfig`` holds the batch CLI's runtime flags: the reference's ten
plus dtype, blocking, bucketing, KV-cache decode, sampling, prefetch and the
device. ``resolve_device`` is the one place that turns a device name into a
``torch.device``: CUDA unless the caller asks for the CPU, and an error (never
a silent CPU run) when CUDA is asked for and absent.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import torch

DEFAULT_MAX_TOKEN_LEN = 4096

# Fields the port carries, the dense-Llama ones first. Anything else that
# changes numerics must be at its neutral value (see _UNSUPPORTED).
_LLAMA_FIELDS = (
    "model_type",
    "vocab_size",
    "hidden_size",
    "intermediate_size",
    "num_hidden_layers",
    "num_attention_heads",
    "num_key_value_heads",
    "rms_norm_eps",
    "rope_theta",
    "max_position_embeddings",
    "tie_word_embeddings",
    "explicit_head_dim",
    "attention_in_bias",
    "attention_out_bias",
    "mlp_bias",
    "attn_logit_softcap",
    "final_logit_softcap",
    "query_pre_attn_scalar",
    "hidden_act",
)
_FIELDS = _LLAMA_FIELDS + (
    "sliding_window",
    "layer_sliding",
    "rope_local_theta",
    "rope_scaling_kind",
    "rope_scaling_factor",
    "ffw_sandwich_norms",
    "qk_norm",
    "norm_unit_offset",
    "embed_scale",
)

# Native config fields the port does not implement, with the value that
# means "feature off". A config carrying any other value raises.
_UNSUPPORTED: dict[str, Any] = {
    "attention_chunk_size": None,
    "layer_rope": None,
    "num_local_experts": 0,
    "moe_layer_pattern": None,
    "kv_lora_rank": 0,
    "q_lora_rank": None,
    "qk_l2_norm": False,
    "rope_interleaved": False,
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
    "gemma3_text": frozenset(_FAMILY_DELTAS),
}
# Families of the JAX package this port does not run yet, with the ROADMAP
# item that brings them.
_LATER_FAMILIES = {
    "mixtral": "2.4 (MoE)", "qwen3_moe": "2.4 (MoE)", "llama4": "2.3 (Llama 4)",
    "llama4_text": "2.3 (Llama 4)", "deepseek_v3": "2.5 (MLA) and 2.4 (MoE)",
}

ACTIVATIONS = ("silu", "gelu", "gelu_pytorch_tanh")
_ROPE_SCALINGS = (None, "linear")

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
    "phi3": frozenset({"sliding_window"}),
    "gemma2": frozenset({"query_pre_attn_scalar", "sliding_window"}),
    "gemma3_text": frozenset({"query_pre_attn_scalar", "sliding_window", "rope_local_theta"}),
}
# Multimodal wrappers whose language model is the nested text_config.
_TEXT_CONFIG_TYPES = {"gemma3": "gemma3_text"}


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
    is the per-head RMSNorm on q and k before rope."""

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

    def __post_init__(self) -> None:
        if self.hidden_act not in ACTIVATIONS:
            raise NotImplementedError(
                f"hidden_act {self.hidden_act!r}: this port runs {ACTIVATIONS}"
            )
        if self.rope_scaling_kind not in _ROPE_SCALINGS:
            raise NotImplementedError(
                f"rope scaling {self.rope_scaling_kind!r} is not supported by the PyTorch "
                "port yet (linear is)"
            )
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError("num_attention_heads must be a multiple of num_key_value_heads")
        if self.layer_sliding is not None and len(self.layer_sliding) != self.num_hidden_layers:
            raise ValueError(
                f"layer_sliding has {len(self.layer_sliding)} entries for "
                f"{self.num_hidden_layers} layers"
            )

    @property
    def rope_scaling_spec(self) -> tuple | None:
        """("linear", factor) or None, as ``ops.rope.rope_cos_sin`` takes it."""
        return None if self.rope_scaling_kind is None else ("linear", self.rope_scaling_factor)

    @property
    def head_dim(self) -> int:
        if self.explicit_head_dim is not None:
            return self.explicit_head_dim
        return self.hidden_size // self.num_attention_heads

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

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "LlamaConfig":
        """Build from a config dict with the JAX package's ``from_hf_config``
        rules: a native one (either package's ``save_params``), whose fields
        read back by name, or a Hugging Face one of model_type llama,
        mistral, phi3, qwen2, qwen3, gemma, gemma2, gemma3_text or the gemma3
        wrapper (its ``text_config``), which contributes only the fields that
        mean the same thing in its family, with the family's defaults.
        Raises NotImplementedError on any family or field this port does not
        carry (Llama4, MoE, MLA, chunked attention, NoPE, rope scalings other
        than linear), and on a native config that turns on a delta its
        family does not have."""
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
                f"model_type {model_type!r} is not supported (llama, mistral, phi3, qwen2, qwen3, "
                "gemma, gemma2, gemma3_text and the gemma3 wrapper are)"
            )
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
            kwargs = {k: d[k] for k in _FIELDS if k in d}
        else:
            allowed = _UNIVERSAL_HF_FIELDS | _FAMILY_HF_FIELDS.get(family, frozenset())
            kwargs = {k: d[k] for k in _FIELDS if k in d and k in allowed}
        if family in ("llama", "qwen3"):
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
        elif family == "qwen3":
            kwargs.setdefault("qk_norm", True)
            cls._apply_qwen_window(kwargs, d)
            kwargs.setdefault("explicit_head_dim", 128)  # Qwen3Config's default
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
        # mistral and phi3: sliding_window flows through by name (may be
        # null); phi3's fused projections are split when its checkpoint is.
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
        if d.get("head_dim"):
            kwargs["explicit_head_dim"] = d["head_dim"]
        kwargs.setdefault("num_key_value_heads", d.get("num_attention_heads", 32))
        if kwargs.get("layer_sliding") is not None:
            kwargs["layer_sliding"] = tuple(kwargs["layer_sliding"])  # json gives a list
        rs = d.get("rope_scaling") or {}
        if rs:
            kind = rs.get("rope_type", rs.get("type"))
            if kind != "linear":
                raise NotImplementedError(
                    f"rope_scaling type {kind!r} is not supported by the PyTorch port yet"
                )
            kwargs["rope_scaling_kind"] = kind
            kwargs["rope_scaling_factor"] = float(rs.get("factor", 1.0))
        return cls(**kwargs)

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
