"""The port's config parsing against the JAX package's, field by field: the
published config.json of one model of each family the port runs (the dense
ones, Mixtral-8x7B, Qwen3-30B-A3B, DeepSeek-V3 and Llama-3.1-8B's llama3
rope), as it ships, and with stray keys of the native names that a merged or
"llamafied" export may carry (the JAX package ignores them unless the
family has such a field); then the native round trip through both
packages' save_params. Exact equality of every field the port has."""

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
    # The families with experts and MLA, and a scaled rope.
    "deepseek-v3": {
        "architectures": ["DeepseekV3ForCausalLM"], "attention_bias": False,
        "attention_dropout": 0.0, "aux_loss_alpha": 0.001, "bos_token_id": 0, "eos_token_id": 1,
        "ep_size": 1, "first_k_dense_replace": 3, "hidden_act": "silu", "hidden_size": 7168,
        "initializer_range": 0.02, "intermediate_size": 18432, "kv_lora_rank": 512,
        "max_position_embeddings": 163840, "model_type": "deepseek_v3",
        "moe_intermediate_size": 2048, "moe_layer_freq": 1, "n_group": 8, "n_routed_experts": 256,
        "n_shared_experts": 1, "norm_topk_prob": True, "num_attention_heads": 128,
        "num_experts_per_tok": 8, "num_hidden_layers": 61, "num_key_value_heads": 128,
        "num_nextn_predict_layers": 1, "pretraining_tp": 1, "q_lora_rank": 1536,
        "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
        "quantization_config": {"activation_scheme": "dynamic", "fmt": "e4m3",
                                "quant_method": "fp8", "weight_block_size": [128, 128]},
        "rms_norm_eps": 1e-06,
        "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 1.0,
                         "mscale_all_dim": 1.0, "original_max_position_embeddings": 4096,
                         "type": "yarn"},
        "rope_theta": 10000, "routed_scaling_factor": 2.5, "scoring_func": "sigmoid",
        "seq_aux": True, "tie_word_embeddings": False, "topk_group": 4, "topk_method": "noaux_tc",
        "torch_dtype": "bfloat16", "use_cache": True, "v_head_dim": 128, "vocab_size": 129280,
    },
    "mixtral-8x7b-v0.1": {
        "architectures": ["MixtralForCausalLM"], "attention_dropout": 0.0, "bos_token_id": 1,
        "eos_token_id": 2, "hidden_act": "silu", "hidden_size": 4096, "initializer_range": 0.02,
        "intermediate_size": 14336, "max_position_embeddings": 32768, "model_type": "mixtral",
        "num_attention_heads": 32, "num_experts_per_tok": 2, "num_hidden_layers": 32,
        "num_key_value_heads": 8, "num_local_experts": 8, "output_router_logits": False,
        "rms_norm_eps": 1e-05, "rope_theta": 1000000.0, "router_aux_loss_coef": 0.02,
        "sliding_window": None, "tie_word_embeddings": False, "torch_dtype": "bfloat16",
        "use_cache": True, "vocab_size": 32000,
    },
    "qwen3-30b-a3b": {
        "architectures": ["Qwen3MoeForCausalLM"], "attention_bias": False,
        "attention_dropout": 0.0, "bos_token_id": 151643, "decoder_sparse_step": 1,
        "eos_token_id": 151645, "head_dim": 128, "hidden_act": "silu", "hidden_size": 2048,
        "initializer_range": 0.02, "intermediate_size": 6144, "max_position_embeddings": 40960,
        "max_window_layers": 48, "mlp_only_layers": [], "model_type": "qwen3_moe",
        "moe_intermediate_size": 768, "norm_topk_prob": True, "num_attention_heads": 32,
        "num_experts": 128, "num_experts_per_tok": 8, "num_hidden_layers": 48,
        "num_key_value_heads": 4, "output_router_logits": False, "rms_norm_eps": 1e-06,
        "rope_scaling": None, "rope_theta": 1000000.0, "router_aux_loss_coef": 0.001,
        "sliding_window": None, "tie_word_embeddings": False, "torch_dtype": "bfloat16",
        "use_cache": True, "use_sliding_window": False, "vocab_size": 151936,
    },
    "llama-3.1-8b": {
        "architectures": ["LlamaForCausalLM"], "attention_bias": False, "attention_dropout": 0.0,
        "bos_token_id": 128000, "eos_token_id": 128001, "hidden_act": "silu", "hidden_size": 4096,
        "initializer_range": 0.02, "intermediate_size": 14336, "max_position_embeddings": 131072,
        "mlp_bias": False, "model_type": "llama", "num_attention_heads": 32,
        "num_hidden_layers": 32, "num_key_value_heads": 8, "pretraining_tp": 1,
        "rms_norm_eps": 1e-05,
        "rope_scaling": {"factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                         "original_max_position_embeddings": 8192, "rope_type": "llama3"},
        "rope_theta": 500000.0, "tie_word_embeddings": False, "torch_dtype": "bfloat16",
        "use_cache": True, "vocab_size": 128256,
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
    assert (cfg.head_dim, cfg.v_dim, cfg.attn_scale, cfg.rope_scaling_spec) == (
        jcfg.head_dim, jcfg.v_dim, jcfg.attn_scale, jcfg.rope_scaling_spec)


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


def test_deepseek_v3_config_reads_as_published():
    """The published DeepSeek-V3 config cut to 4 layers, as the JAX package
    reads it: MLA heads of 192 / 128, the yarn mscale in the attention
    scale, the width swap and the dense first three layers."""
    d = {**PUBLISHED["deepseek-v3"], "num_hidden_layers": 4}
    cfg = LlamaConfig.from_dict(d)
    _assert_same(cfg, JLlamaConfig.from_hf_config(d))
    assert (cfg.head_dim, cfg.v_dim, cfg.num_attention_heads) == (192, 128, 128)
    assert abs(cfg.attn_scale - 0.1352338) < 1e-7
    assert cfg.rope_scaling_spec == ("yarn", 40.0, 32.0, 1.0, 4096, 1.0, True)
    assert (cfg.num_local_experts, cfg.intermediate_size, cfg.intermediate_size_mlp) == (256, 2048, 18432)
    assert cfg.moe_layer_pattern == (False, False, False, True)
    assert (cfg.moe_n_group, cfg.moe_topk_group, cfg.q_lora_rank) == (8, 4, 1536)


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


@pytest.mark.parametrize("d", [
    {"model_type": "mixtral", "num_local_experts": 8},
    {"model_type": "qwen3_moe", "num_experts": 128},
    {"model_type": "llama4", "text_config": {"model_type": "llama4_text"}},
    {"model_type": "deepseek_v3"},
], ids=["mixtral", "qwen3_moe", "llama4", "deepseek_v3"])
def test_moe_families_parse_as_jax(d):
    """The MoE, MLA and Llama 4 families, from their bare model types (the
    Llama 4 wrapper around its text config), parse as the JAX package
    parses them."""
    _assert_same(LlamaConfig.from_dict(d), JLlamaConfig.from_hf_config(d))


@pytest.mark.parametrize("family,delta", [
    ("mistral", {"qk_norm": True}), ("phi3", {"layer_sliding": [True, False]}),
    ("qwen2", {"qk_norm": True}), ("qwen3", {"ffw_sandwich_norms": True}),
    ("gemma", {"sliding_window": 64}), ("gemma2", {"qk_norm": True}),
])
def test_native_config_refuses_deltas_its_family_lacks(family, delta):
    d = {"fls_native": True, "model_type": family, "num_hidden_layers": 2, **delta}
    with pytest.raises(NotImplementedError):
        LlamaConfig.from_dict(d)
