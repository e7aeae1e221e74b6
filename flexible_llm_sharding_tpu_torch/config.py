"""Model and runtime configuration of the PyTorch/CUDA port.

``LlamaConfig`` keeps the dense-Llama part of the JAX package's config
(field names and defaults unchanged, so the ``config.json`` that
``utils.checkpoint.save_params`` writes reads back in either package). The
families, attention forms and rope scalings that this port does not carry
yet raise ``NotImplementedError`` when a config asks for them, instead of
being dropped silently.

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

# Fields the port carries. Anything else that changes numerics must be at its
# neutral value (see _UNSUPPORTED).
_FIELDS = (
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

# Native config fields this slice does not implement, with the value that
# means "feature off". A config carrying any other value raises.
_UNSUPPORTED: dict[str, Any] = {
    "sliding_window": None,
    "attention_chunk_size": None,
    "layer_sliding": None,
    "layer_rope": None,
    "num_local_experts": 0,
    "moe_layer_pattern": None,
    "kv_lora_rank": 0,
    "q_lora_rank": None,
    "rope_scaling_kind": None,
    "rope_local_theta": None,
    "ffw_sandwich_norms": False,
    "qk_norm": False,
    "qk_l2_norm": False,
    "norm_unit_offset": False,
    "embed_scale": False,
    "rope_interleaved": False,
}


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Dense Llama hyperparameters (defaults: Llama-2-7B)."""

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

    def __post_init__(self) -> None:
        if self.hidden_act != "silu":
            raise NotImplementedError(
                f"hidden_act {self.hidden_act!r}: this port runs silu MLPs only"
            )
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError("num_attention_heads must be a multiple of num_key_value_heads")

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

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "LlamaConfig":
        """Build from a config dict; raises NotImplementedError on any field
        this port does not carry (MoE, MLA, sliding window, chunked or
        per-layer attention patterns, rope scaling, sandwich norms, NoPE)."""
        model_type = d.get("model_type", "llama")
        if model_type not in ("llama", ""):
            raise NotImplementedError(
                f"model_type {model_type!r}: this port runs dense Llama only"
            )
        for name, off in _UNSUPPORTED.items():
            val = d.get(name, off)
            if val in ([], ()):
                val = None
            if val != off:
                raise NotImplementedError(
                    f"config field {name}={val!r} is not supported by the "
                    "PyTorch port yet"
                )
        if d.get("rope_scaling"):
            raise NotImplementedError("rope_scaling is not supported by the PyTorch port yet")
        kwargs = {k: d[k] for k in _FIELDS if k in d}
        if not d.get("fls_native") and "attention_in_bias" not in d:
            # A Hugging Face config: one attention_bias flag for all four
            # projections.
            if d.get("attention_bias"):
                kwargs["attention_in_bias"] = kwargs["attention_out_bias"] = True
            if "head_dim" in d:
                kwargs["explicit_head_dim"] = d["head_dim"]
        kwargs["model_type"] = "llama"
        return cls(**kwargs)

    @classmethod
    def from_pretrained(cls, model_path: str) -> "LlamaConfig":
        with open(os.path.join(model_path, "config.json")) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict[str, Any]:
        """The native config.json payload (read back by both packages)."""
        return {
            "fls_native": True,
            "use_sliding_window": False,
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
