"""The port's safetensors reader/writer against the JAX package's checkpoint
code: bit-exact both ways, float32 and bfloat16, and the config.json each
package writes reads back in the other."""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from flexible_llm_sharding_tpu.config import LlamaConfig as JLlamaConfig
from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu_torch.config import LlamaConfig
from flexible_llm_sharding_tpu_torch.utils import checkpoint

KW = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2)


def _jax_params(dtype):
    jcfg = JLlamaConfig(**KW)
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jax.tree.map(lambda a: np.asarray(a).astype(dtype), params)


def _assert_same_bits(got: torch.Tensor, want: np.ndarray):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    if want.dtype == ml_dtypes.bfloat16:
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_port_reads_jax_checkpoint_bit_exact(tmp_path, dtype):
    jcfg, params = _jax_params(dtype)
    jckpt.save_params(params, str(tmp_path), jcfg)
    cfg = LlamaConfig.from_pretrained(str(tmp_path))
    assert cfg.head_dim == jcfg.head_dim and cfg.num_hidden_layers == 2
    names = checkpoint.layer_names_for(cfg.num_hidden_layers)
    assert names == jckpt.layer_names_for(jcfg.num_hidden_layers)
    trees = {"model.embed_tokens": params["embed"], "model.norm": params["norm"],
             "lm_head": params["lm_head"]}
    trees.update({f"model.layers.{i}": p for i, p in enumerate(params["layers"])})
    for name in names:
        got = dict(checkpoint.flatten(checkpoint.load_layer(str(tmp_path), name)))
        want = dict(checkpoint.flatten(trees[name]))
        assert got.keys() == want.keys()
        for k in want:
            _assert_same_bits(got[k], want[k])


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_jax_reads_port_checkpoint_bit_exact(tmp_path, dtype):
    jcfg, params_np = _jax_params(dtype)
    cfg = LlamaConfig(**KW)
    params = checkpoint.params_from_jax(params_np, cfg)
    checkpoint.save_params(params, str(tmp_path), cfg)
    assert JLlamaConfig.from_pretrained(str(tmp_path)) == jcfg
    trees = {"model.embed_tokens": params_np["embed"], "model.norm": params_np["norm"],
             "lm_head": params_np["lm_head"]}
    trees.update({f"model.layers.{i}": p for i, p in enumerate(params_np["layers"])})
    for name in checkpoint.layer_names_for(cfg.num_hidden_layers):
        flat_j = dict(checkpoint.flatten(jckpt.load_layer(str(tmp_path), name)))
        want = dict(checkpoint.flatten(trees[name]))
        assert flat_j.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(
                np.asarray(flat_j[k]).view(np.uint8), np.asarray(want[k]).view(np.uint8)
            )
            assert np.asarray(flat_j[k]).dtype == np.asarray(want[k]).dtype


def test_params_from_jax_keeps_layout_and_values():
    _, params_np = _jax_params(ml_dtypes.bfloat16)
    params = checkpoint.params_from_jax(params_np, LlamaConfig(**KW), dtype=torch.float32)
    wq = params["layers"][1]["attn"]["wq"]
    assert wq.dtype == torch.float32 and tuple(wq.shape) == (128, 128)
    np.testing.assert_array_equal(
        wq.numpy(), params_np["layers"][1]["attn"]["wq"].astype(np.float32)
    )


def test_safetensors_round_trip_mixed_dtypes(tmp_path):
    path = str(tmp_path / "x.safetensors")
    tensors = {
        "a": torch.arange(7, dtype=torch.int32),
        "b": torch.randn(3, 5).to(torch.bfloat16),
        "c": torch.randn(2, 2, 2),
        "d": torch.tensor([True, False]),
        "e": torch.randn(3).to(torch.float16),
    }
    checkpoint.write_safetensors(path, tensors)
    got = checkpoint.read_safetensors(path)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype
        assert torch.equal(got[k], v)
    header, base = checkpoint.safetensors_header(path)
    assert base % 8 == 0 and set(header) == set(tensors)


@pytest.mark.parametrize("field,value", [
    ("sliding_window", 4096), ("num_local_experts", 8), ("kv_lora_rank", 512),
    ("rope_scaling_kind", "llama3"), ("ffw_sandwich_norms", True),
    ("layer_rope", [True, False]), ("attention_chunk_size", 8192),
])
def test_unsupported_config_fields_raise(field, value):
    d = {"fls_native": True, **KW, field: value}
    with pytest.raises(NotImplementedError):
        LlamaConfig.from_dict(d)
