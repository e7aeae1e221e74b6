"""The port's config parsing against the JAX package's, field by field: the
published config.json of one model of each dense family the port runs, as
it ships, and with stray keys of the native names that a merged or
"llamafied" export may carry (the JAX package ignores them unless the
family has such a field); then the native round trip through both
packages' save_params. Exact equality of every field the port has, and
the JAX package's other fields at their "off" values."""

import copy
import dataclasses
import json

import pytest

from flexible_llm_sharding_tpu.config import LlamaConfig as JLlamaConfig
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu_torch.config import LlamaConfig
from flexible_llm_sharding_tpu_torch.utils import checkpoint

PORT_FIELDS = [f.name for f in dataclasses.fields(LlamaConfig)]

# The published config.json files (the keys that reach a config parser).
PUBLISHED = {
    "llama-2-7b": {
        "architectures": ["LlamaForCausalLM"], "bos_token_id": 1, "eos_token_id": 2,
        "hidden_act": "silu", "hidden_size": 4096, "initializer_range": 0.02,
        "intermediate_size": 11008, "max_position_embeddings": 4096, "model_type": "llama",
        "num_attention_heads": 32, "num_hidden_layers": 32, "num_key_value_heads": 32,
        "pretraining_tp": 1, "rms_norm_eps": 1e-05, "rope_scaling": None,
        "tie_word_embeddings": False, "torch_dtype": "float16", "use_cache": True,
        "vocab_size": 32000,
    },
    "mistral-7b-v0.1": {
        "architectures": ["MistralForCausalLM"], "bos_token_id": 1, "eos_token_id": 2,
        "hidden_act": "silu", "hidden_size": 4096, "initializer_range": 0.02,
        "intermediate_size": 14336, "max_position_embeddings": 32768, "model_type": "mistral",
        "num_attention_heads": 32, "num_hidden_layers": 32, "num_key_value_heads": 8,
        "rms_norm_eps": 1e-05, "rope_theta": 10000.0, "sliding_window": 4096,
        "tie_word_embeddings": False, "torch_dtype": "bfloat16", "use_cache": True,
        "vocab_size": 32000,
    },
    "qwen2-7b": {
        "architectures": ["Qwen2ForCausalLM"], "attention_dropout": 0.0,
        "bos_token_id": 151643, "eos_token_id": 151643, "hidden_act": "silu",
        "hidden_size": 3584, "initializer_range": 0.02, "intermediate_size": 18944,
        "max_position_embeddings": 131072, "max_window_layers": 28, "model_type": "qwen2",
        "num_attention_heads": 28, "num_hidden_layers": 28, "num_key_value_heads": 4,
        "rms_norm_eps": 1e-06, "rope_theta": 1000000.0, "sliding_window": 131072,
        "tie_word_embeddings": False, "torch_dtype": "bfloat16", "use_cache": True,
        "use_sliding_window": False, "vocab_size": 152064,
    },
    "qwen3-8b": {
        "architectures": ["Qwen3ForCausalLM"], "attention_bias": False,
        "attention_dropout": 0.0, "bos_token_id": 151643, "eos_token_id": 151645,
        "head_dim": 128, "hidden_act": "silu", "hidden_size": 4096, "initializer_range": 0.02,
        "intermediate_size": 12288, "max_position_embeddings": 40960, "max_window_layers": 36,
        "model_type": "qwen3", "num_attention_heads": 32, "num_hidden_layers": 36,
        "num_key_value_heads": 8, "rms_norm_eps": 1e-06, "rope_scaling": None,
        "rope_theta": 1000000, "sliding_window": None, "tie_word_embeddings": False,
        "torch_dtype": "bfloat16", "use_cache": True, "use_sliding_window": False,
        "vocab_size": 151936,
    },
    "gemma-7b": {
        "architectures": ["GemmaForCausalLM"], "attention_bias": False,
        "attention_dropout": 0.0, "bos_token_id": 2, "eos_token_id": 1, "head_dim": 256,
        "hidden_act": "gelu", "hidden_size": 3072, "initializer_range": 0.02,
        "intermediate_size": 24576, "max_position_embeddings": 8192, "model_type": "gemma",
        "num_attention_heads": 16, "num_hidden_layers": 28, "num_key_value_heads": 16,
        "pad_token_id": 0, "rms_norm_eps": 1e-06, "rope_scaling": None, "rope_theta": 10000.0,
        "torch_dtype": "bfloat16", "use_cache": True, "vocab_size": 256000,
    },
    "gemma-2-9b": {
        "architectures": ["Gemma2ForCausalLM"], "attention_bias": False,
        "attention_dropout": 0.0, "attn_logit_softcapping": 50.0, "bos_token_id": 2,
        "cache_implementation": "hybrid", "eos_token_id": 1, "final_logit_softcapping": 30.0,
        "head_dim": 256, "hidden_act": "gelu_pytorch_tanh",
        "hidden_activation": "gelu_pytorch_tanh", "hidden_size": 3584,
        "initializer_range": 0.02, "intermediate_size": 14336, "max_position_embeddings": 8192,
        "model_type": "gemma2", "num_attention_heads": 16, "num_hidden_layers": 42,
        "num_key_value_heads": 8, "pad_token_id": 0, "query_pre_attn_scalar": 256,
        "rms_norm_eps": 1e-06, "rope_theta": 10000.0, "sliding_window": 4096,
        "sliding_window_size": 4096, "torch_dtype": "float32", "use_cache": True,
        "vocab_size": 256000,
    },
    "gemma-3-12b-pt": {
        "architectures": ["Gemma3ForConditionalGeneration"], "boi_token_index": 255999,
        "eoi_token_index": 256000, "eos_token_id": [1, 106], "image_token_index": 262144,
        "initializer_range": 0.02, "mm_tokens_per_image": 256, "model_type": "gemma3",
        "text_config": {
            "hidden_size": 3840, "intermediate_size": 15360, "model_type": "gemma3_text",
            "num_attention_heads": 16, "num_hidden_layers": 48, "num_key_value_heads": 8,
            "head_dim": 256, "vocab_size": 262208, "query_pre_attn_scalar": 256,
            "rope_scaling": {"factor": 8.0, "rope_type": "linear"}, "rope_theta": 1000000.0,
            "rope_local_base_freq": 10000.0, "rms_norm_eps": 1e-06, "sliding_window": 1024,
            "hidden_activation": "gelu_pytorch_tanh", "max_position_embeddings": 131072,
        },
        "torch_dtype": "bfloat16",
        "vision_config": {
            "hidden_size": 1152, "image_size": 896, "intermediate_size": 4304,
            "model_type": "siglip_vision_model", "num_attention_heads": 16,
            "num_hidden_layers": 27, "patch_size": 14, "vision_use_head": False,
        },
    },
    "phi-3-mini-4k-instruct": {
        "architectures": ["Phi3ForCausalLM"], "attention_bias": False,
        "attention_dropout": 0.0, "bos_token_id": 1, "embd_pdrop": 0.0, "eos_token_id": 32000,
        "hidden_act": "silu", "hidden_size": 3072, "initializer_range": 0.02,
        "intermediate_size": 8192, "max_position_embeddings": 4096, "model_type": "phi3",
        "num_attention_heads": 32, "num_hidden_layers": 32, "num_key_value_heads": 32,
        "original_max_position_embeddings": 4096, "pad_token_id": 32000, "resid_pdrop": 0.0,
        "rms_norm_eps": 1e-05, "rope_scaling": None, "rope_theta": 10000.0,
        "sliding_window": 2047, "tie_word_embeddings": False, "torch_dtype": "bfloat16",
        "use_cache": True, "vocab_size": 32064,
    },
}


def _strays(n_layers: int) -> dict:
    """Native-named keys that change the model if honoured (ROADMAP F1)."""
    return {
        "query_pre_attn_scalar": 144, "attn_logit_softcap": 30.0, "final_logit_softcap": 20.0,
        "explicit_head_dim": 64, "attention_out_bias": True, "num_local_experts": 8,
        "layer_sliding": [i % 2 == 0 for i in range(n_layers)],
    }


def _with_strays(d: dict) -> dict:
    d = copy.deepcopy(d)
    text = d["text_config"] if "text_config" in d else d
    text.update(_strays(text["num_hidden_layers"]))
    return d


def _assert_same(cfg: LlamaConfig, jcfg: JLlamaConfig) -> None:
    assert dataclasses.asdict(cfg) == {k: getattr(jcfg, k) for k in PORT_FIELDS}
    # What the port does not carry is off in the JAX config too.
    assert jcfg.num_local_experts == 0 and jcfg.kv_lora_rank == 0
    assert jcfg.attention_chunk_size is None and jcfg.layer_rope is None
    assert (cfg.head_dim, cfg.attn_scale) == (jcfg.head_dim, jcfg.attn_scale)


@pytest.mark.parametrize("strays", [False, True], ids=["as-published", "stray-keys"])
@pytest.mark.parametrize("name", list(PUBLISHED))
def test_config_matches_jax_field_by_field(name, strays):
    d = _with_strays(PUBLISHED[name]) if strays else PUBLISHED[name]
    d = json.loads(json.dumps(d))
    _assert_same(LlamaConfig.from_dict(d), JLlamaConfig.from_hf_config(d))


@pytest.mark.parametrize("key,value", list(_strays(2).items()))
def test_stray_key_in_a_llama_config_changes_nothing(key, value):
    """ROADMAP F1's reproduction: one stray key on a tiny Llama config."""
    base = {"model_type": "llama", "vocab_size": 512, "hidden_size": 128,
            "intermediate_size": 256, "num_hidden_layers": 2, "num_attention_heads": 4,
            "num_key_value_heads": 2}
    cfg = LlamaConfig.from_dict({**base, key: value})
    assert cfg == LlamaConfig.from_dict(base)
    _assert_same(cfg, JLlamaConfig.from_hf_config({**base, key: value}))


def test_stray_gemma2_softcap_name_is_ignored():
    """Gemma 2's softcap comes from attn_logit_softcapping (or its 50.0
    default), never from the native name."""
    d = {**PUBLISHED["gemma-2-9b"], "attn_logit_softcap": 10.0}
    cfg = LlamaConfig.from_dict(d)
    assert cfg.attn_logit_softcap == 50.0
    _assert_same(cfg, JLlamaConfig.from_hf_config(d))


@pytest.mark.parametrize("name", list(PUBLISHED))
def test_native_round_trip_through_both_packages(tmp_path, name):
    """JAX save_params -> the port reads the same config; the port's
    save_params -> JAX reads its own config back."""
    jcfg = JLlamaConfig.from_hf_config(PUBLISHED[name])
    empty = {"embed": {}, "layers": [], "norm": {}}
    jckpt.save_params(empty, str(tmp_path / "jax"), jcfg)
    cfg = LlamaConfig.from_pretrained(str(tmp_path / "jax"))
    _assert_same(cfg, jcfg)
    checkpoint.save_params(empty, str(tmp_path / "port"), cfg)
    assert JLlamaConfig.from_pretrained(str(tmp_path / "port")) == jcfg
    assert LlamaConfig.from_pretrained(str(tmp_path / "port")) == cfg


@pytest.mark.parametrize("d,item", [
    ({"model_type": "mixtral", "num_local_experts": 8}, "2.4"),
    ({"model_type": "qwen3_moe", "num_experts": 128}, "2.4"),
    ({"model_type": "llama4", "text_config": {"model_type": "llama4_text"}}, "2.3"),
    ({"model_type": "deepseek_v3"}, "2.5"),
], ids=["mixtral", "qwen3_moe", "llama4", "deepseek_v3"])
def test_later_families_raise_naming_their_roadmap_item(d, item):
    with pytest.raises(NotImplementedError, match=item):
        LlamaConfig.from_dict(d)


@pytest.mark.parametrize("family,delta", [
    ("mistral", {"qk_norm": True}), ("phi3", {"layer_sliding": [True, False]}),
    ("qwen2", {"qk_norm": True}), ("qwen3", {"ffw_sandwich_norms": True}),
    ("gemma", {"sliding_window": 64}), ("gemma2", {"qk_norm": True}),
])
def test_native_config_refuses_deltas_its_family_lacks(family, delta):
    d = {"fls_native": True, "model_type": family, "num_hidden_layers": 2, **delta}
    with pytest.raises(NotImplementedError):
        LlamaConfig.from_dict(d)
