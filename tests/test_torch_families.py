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


@pytest.fixture(scope="module")
def family_splits(tmp_path_factory):
    """family -> a directory holding its transformers checkpoint, the
    port's ``prepare_weights`` output and the JAX split, built once and
    shared by the family's modes."""
    built = {}

    def get(family):
        if family not in built:
            root = tmp_path_factory.mktemp(f"family_{family}")
            hf_checkpoint(family, root / "hf", seed=2)
            prepare_weights.main([str(root / "hf"), str(root / "port"), "--dtype", "float32"])
            jckpt.split_into_layers(str(root / "hf"), str(root / "jax"), dtype="float32")
            built[family] = root
        return built[family]

    return get


@pytest.mark.parametrize("mode", [[], ["--kv_cache", "true"]], ids=["generation_loop", "kv_cache"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_cli_matches_jax_cli(family_splits, tmp_path, family, mode):
    root = family_splits(family)
    cfg = LlamaConfig.from_pretrained(str(root / "port"))
    assert cfg.model_type == family
    for key, value in FAMILIES[family].items():
        assert getattr(cfg, key) == value, key
    assert cfg == LlamaConfig.from_dict(JLlamaConfig.from_pretrained(str(root / "jax")).__dict__
                                        | {"fls_native": True})
    extra = ["--num_gen_token", "3", *mode]
    want = run_cli(jax_main, root / "jax", tmp_path, "jax", [*extra, "--num_devices", "1"])
    got = run_cli(torch_main, root / "port", tmp_path, "torch", [*extra, "--device", "cpu"])
    assert_cli_match(got, want)
