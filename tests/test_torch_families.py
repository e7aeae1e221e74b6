"""The dense families this slice adds, end to end on the CPU in float32: a
tiny transformers checkpoint of each (random init, save_pretrained, no
download; gemma at head dim 256, phi3 at 96 with its fused projections,
mistral with a window that binds, qwen2 with a local and a global layer,
qwen3 with its q/k norm) split by the port's prepare_weights and scored by
the port's CLI, against the JAX splitter's files scored by the JAX CLI:
the re-scoring generation loop and --kv_cache decode, atol 1e-5, and the
same greedy tokens."""

import pytest

from flexible_llm_sharding_tpu.cli import main as jax_main
from flexible_llm_sharding_tpu.config import LlamaConfig as JLlamaConfig
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu_torch import prepare_weights
from flexible_llm_sharding_tpu_torch.cli import main as torch_main
from flexible_llm_sharding_tpu_torch.config import LlamaConfig
from tests.test_torch_checkpoint import assert_cli_match, hf_checkpoint, run_cli

FAMILIES = {
    # family: what the tiny checkpoint exercises
    "gemma": {"head_dim": 256, "tie_word_embeddings": True, "norm_unit_offset": True},
    "mistral": {"sliding_window": 6},
    "qwen2": {"attention_in_bias": True, "layer_sliding": (False, True)},
    "qwen3": {"qk_norm": True, "head_dim": 32},
    "phi3": {"head_dim": 96, "sliding_window": 8},
}


@pytest.mark.parametrize("mode", [[], ["--kv_cache", "true"]], ids=["generation_loop", "kv_cache"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_cli_matches_jax_cli(tmp_path, family, mode):
    hf_checkpoint(family, tmp_path / "hf", seed=2)
    prepare_weights.main([str(tmp_path / "hf"), str(tmp_path / "port"), "--dtype", "float32"])
    jckpt.split_into_layers(str(tmp_path / "hf"), str(tmp_path / "jax"), dtype="float32")
    cfg = LlamaConfig.from_pretrained(str(tmp_path / "port"))
    assert cfg.model_type == family
    for key, value in FAMILIES[family].items():
        assert getattr(cfg, key) == value, key
    assert cfg == LlamaConfig.from_dict(JLlamaConfig.from_pretrained(str(tmp_path / "jax")).__dict__
                                        | {"fls_native": True})
    extra = ["--num_gen_token", "3", *mode]
    want = run_cli(jax_main, tmp_path / "jax", tmp_path, "jax", [*extra, "--num_devices", "1"])
    got = run_cli(torch_main, tmp_path / "port", tmp_path, "torch", [*extra, "--device", "cpu"])
    assert_cli_match(got, want)
