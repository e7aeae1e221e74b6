"""The port's checkpoint code against the JAX package's: the safetensors
reader/writer bit-exact both ways, float32 and bfloat16, and the
config.json each package writes reads back in the other; the Hugging Face
splitter on tiny transformers checkpoints of every family the port runs
(random init, save_pretrained, no download), tensor-equal to the JAX
splitter's files in both layouts; and the CLI on the reference's own
hf-layout files against the JAX CLI (ROADMAP F2), float32, atol 1e-5."""

import pickle

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from bench import BenchTokenizer
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
    """A native Llama config with a field the port does not run for Llama
    raises; llama3 rope scaling, which it now runs, reads as in the JAX
    package."""
    d = {"fls_native": True, **KW, field: value}
    if field == "rope_scaling_kind":
        cfg, jcfg = LlamaConfig.from_dict(d), JLlamaConfig.from_hf_config(d)
        assert cfg.rope_scaling_spec == jcfg.rope_scaling_spec and cfg.rope_scaling_spec[0] == value
        return
    with pytest.raises(NotImplementedError):
        LlamaConfig.from_dict(d)


# ---------------------------------------------------------------------------
# Hugging Face checkpoints: the port's splitter against the JAX splitter, and
# the CLI on the reference's own (hf-layout) files
# ---------------------------------------------------------------------------

def _hf_config(family: str):
    """A tiny transformers config of ``family`` (no download)."""
    import transformers as tf

    small = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512)
    if family == "llama":
        return tf.LlamaConfig(**small, attention_bias=True, mlp_bias=True)
    if family == "mistral":  # a window that binds at the test prompts
        return tf.MistralConfig(**small, sliding_window=6)
    if family == "qwen2":  # biased q/k/v; layer 0 global, layer 1 local
        return tf.Qwen2Config(**small, use_sliding_window=True, sliding_window=6,
                              max_window_layers=1)
    if family == "qwen3":
        return tf.Qwen3Config(**small, head_dim=32)
    if family == "gemma":  # head dim 256, tied head, GeGLU, (1+w) norms
        return tf.GemmaConfig(**{**small, "num_attention_heads": 2, "num_key_value_heads": 1},
                              head_dim=256)
    if family == "phi3":  # head dim 96, fused qkv_proj / gate_up_proj
        return tf.Phi3Config(**{**small, "hidden_size": 192, "num_attention_heads": 2,
                                "num_key_value_heads": 1},
                             sliding_window=8, pad_token_id=0, bos_token_id=1, eos_token_id=2)
    if family == "gemma3":  # the multimodal wrapper, text tower hd 256
        text = tf.Gemma3TextConfig(**{**small, "num_hidden_layers": 3, "num_attention_heads": 2,
                                      "num_key_value_heads": 1},
                                   head_dim=256, query_pre_attn_scalar=256, sliding_window=6,
                                   layer_types=["sliding_attention", "sliding_attention",
                                                "full_attention"])
        vision = tf.SiglipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                                       num_attention_heads=2, image_size=28, patch_size=14)
        return tf.Gemma3Config(text_config=text.to_dict(), vision_config=vision.to_dict(),
                               mm_tokens_per_image=4, image_token_index=255,
                               boi_token_index=253, eoi_token_index=254)
    if family == "llama3":  # Llama 3.1's rope bands, bound at the test lengths
        return tf.LlamaConfig(**small, rope_theta=500000.0, rope_scaling={
            "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
            "high_freq_factor": 4.0, "original_max_position_embeddings": 64})
    if family == "qwen2_yarn":  # Qwen2.5's long-context yarn
        return tf.Qwen2Config(**small, rope_scaling={
            "type": "yarn", "factor": 4.0, "original_max_position_embeddings": 32})
    if family == "phi3_longrope":  # hd 96; the test prompts fall on both sides of 24
        return tf.Phi3Config(**{**small, "hidden_size": 192, "num_attention_heads": 2,
                                "num_key_value_heads": 1},
                             original_max_position_embeddings=24, pad_token_id=0, bos_token_id=1,
                             eos_token_id=2, rope_scaling={
                                 "type": "longrope",
                                 "long_factor": [1.0 + 0.25 * i for i in range(48)],
                                 "short_factor": [1.0 + 0.02 * i for i in range(48)]})
    if family == "mixtral":
        return tf.MixtralConfig(**small, num_local_experts=4, num_experts_per_tok=2)
    if family == "qwen3_moe":  # layer 0 dense, layer 1 experts, no renormalisation
        return tf.Qwen3MoeConfig(**small, num_experts=4, num_experts_per_tok=2,
                                 moe_intermediate_size=32, norm_topk_prob=False,
                                 mlp_only_layers=[0])
    if family in ("deepseek_v3", "deepseek_v3_dense_q"):
        # MLA (qk 16 + 8, v 12; q by LoRA or dense), layer 0 dense and layer
        # 1 experts (8 in 4 groups, the best 2 kept), yarn with the mscale pair.
        return tf.DeepseekV3Config(
            **{**small, "num_key_value_heads": 4}, moe_intermediate_size=32, n_routed_experts=8,
            num_experts_per_tok=2, n_group=4, topk_group=2, first_k_dense_replace=1,
            routed_scaling_factor=2.5, kv_lora_rank=16,
            q_lora_rank=24 if family == "deepseek_v3" else None, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=12, rope_scaling={
                "type": "yarn", "factor": 4.0, "mscale": 1.0, "mscale_all_dim": 1.0,
                "original_max_position_embeddings": 32, "beta_fast": 32, "beta_slow": 1})
    raise ValueError(family)


HF_FAMILIES = ("llama", "mistral", "qwen2", "qwen3", "gemma", "phi3", "gemma3")
# The families with experts or MLA, and the rope scalings beyond linear.
HF_MOE_FAMILIES = ("mixtral", "qwen3_moe", "deepseek_v3", "deepseek_v3_dense_q")
HF_ROPE_FAMILIES = ("llama3", "qwen2_yarn", "phi3_longrope")


def hf_checkpoint(family: str, path, seed: int = 0, shard: bool = False,
                  safetensors: bool = True) -> None:
    """A tiny randomly initialised transformers model of ``family`` saved
    with ``save_pretrained``: every parameter redrawn from ``seed`` (norm
    scales and biases too, so their placement shows)."""
    import transformers as tf

    cfg = _hf_config(family)
    cls = tf.Gemma3ForConditionalGeneration if family == "gemma3" else tf.AutoModelForCausalLM
    model = cls.from_config(cfg) if cls is tf.AutoModelForCausalLM else cls(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for _, p in model.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g) * (0.3 if p.ndim == 1 else 0.05))
        for name, buf in model.named_buffers():
            if name.endswith("e_score_correction_bias"):  # DeepSeek's, of both signs
                buf.copy_(torch.randn(buf.shape, generator=g) * 0.5)
    model.save_pretrained(str(path), safe_serialization=safetensors,
                          max_shard_size="100KB" if shard else "5GB")


def _assert_same_split(port_dir, jax_dir):
    """The same layer files, keys, dtypes and bits, and the same config.json."""
    import json
    import os

    names = sorted(f for f in os.listdir(jax_dir) if f.endswith(".safetensors"))
    assert sorted(f for f in os.listdir(port_dir) if f.endswith(".safetensors")) == names
    for fn in names:
        got = checkpoint.read_safetensors(os.path.join(port_dir, fn))
        want = checkpoint.read_safetensors(os.path.join(jax_dir, fn))
        assert got.keys() == want.keys(), fn
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (fn, k)
            assert torch.equal(got[k].reshape(-1).view(torch.uint8),
                               want[k].reshape(-1).view(torch.uint8)), (fn, k)
    with open(os.path.join(port_dir, "config.json")) as f, \
            open(os.path.join(jax_dir, "config.json")) as g:
        assert json.load(f) == json.load(g)


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["as-saved", "bf16"])
@pytest.mark.parametrize("layout", ["native", "hf"])
@pytest.mark.parametrize("family", HF_FAMILIES)
def test_split_matches_jax_splitter(tmp_path, family, layout, dtype):
    hf_checkpoint(family, tmp_path / "hf")
    want = jckpt.split_into_layers(str(tmp_path / "hf"), str(tmp_path / "jax"), dtype=dtype,
                                   layout=layout)
    got = checkpoint.split_into_layers(str(tmp_path / "hf"), str(tmp_path / "port"), dtype=dtype,
                                       layout=layout)
    assert got == want
    _assert_same_split(tmp_path / "port", tmp_path / "jax")
    cfg = LlamaConfig.from_pretrained(str(tmp_path / "port"))
    assert sorted(got) == sorted(checkpoint.layer_names_for(cfg.num_hidden_layers,
                                                            cfg.tie_word_embeddings))


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["as-saved", "bf16"])
@pytest.mark.parametrize("layout", ["native", "hf"])
@pytest.mark.parametrize("family", HF_MOE_FAMILIES)
def test_moe_and_mla_split_matches_jax_splitter(tmp_path, family, layout, dtype):
    """The expert layouts (Mixtral's block_sparse_moe, Qwen3-MoE's and
    DeepSeek's mlp.experts with its correction bias and shared expert) and
    DeepSeek's MLA projections, split tensor-equal to the JAX splitter's
    files; load_layer reads the hf layout into what the native one holds."""
    hf_checkpoint(family, tmp_path / "hf")
    want = jckpt.split_into_layers(str(tmp_path / "hf"), str(tmp_path / "jax"), dtype=dtype,
                                   layout=layout)
    got = checkpoint.split_into_layers(str(tmp_path / "hf"), str(tmp_path / "port"), dtype=dtype,
                                       layout=layout)
    assert got == want
    _assert_same_split(tmp_path / "port", tmp_path / "jax")
    if layout == "hf":
        checkpoint.split_into_layers(str(tmp_path / "hf"), str(tmp_path / "native"), dtype=dtype)
        for name in got:
            a = dict(checkpoint.flatten(checkpoint.load_layer(str(tmp_path / "port"), name)))
            b = dict(checkpoint.flatten(checkpoint.load_layer(str(tmp_path / "native"), name)))
            assert a.keys() == b.keys()
            assert all(torch.equal(a[k], b[k]) for k in b), name
    moe = dict(checkpoint.flatten(checkpoint.load_layer(str(tmp_path / "port"), "model.layers.1")))
    keys = {k for k in moe if k.startswith("mlp.")}
    if layout == "native":
        assert {"mlp.router", "mlp.gate", "mlp.up", "mlp.down"} <= keys
        assert ("mlp.correction_bias" in keys) == family.startswith("deepseek")
        assert moe["mlp.gate"].ndim == 3


@pytest.mark.parametrize("shard,safetensors", [(True, True), (False, False), (True, False)],
                         ids=["sharded-safetensors", "bin", "sharded-bin"])
def test_split_reads_every_checkpoint_form(tmp_path, shard, safetensors):
    hf_checkpoint("qwen2", tmp_path / "hf", shard=shard, safetensors=safetensors)
    index = "model.safetensors.index.json" if safetensors else "pytorch_model.bin.index.json"
    assert (tmp_path / "hf" / index).exists() == shard
    want = jckpt.split_into_layers(str(tmp_path / "hf"), str(tmp_path / "jax"), dtype="float16")
    got = checkpoint.split_into_layers(str(tmp_path / "hf"), str(tmp_path / "port"), dtype="float16")
    assert got == want
    _assert_same_split(tmp_path / "port", tmp_path / "jax")


def test_split_drops_the_vision_tower_unread(tmp_path, monkeypatch):
    """A gemma3 bundle: the text tower under native names, config.json its
    text_config, and no vision or projector tensor read from the shards."""
    hf_checkpoint("gemma3", tmp_path / "hf")
    read = []
    real = checkpoint.read_safetensors

    def spy(path, pin_memory=False, want=None):
        out = real(path, pin_memory, want)
        read.extend(out)
        return out

    monkeypatch.setattr(checkpoint, "read_safetensors", spy)
    names = checkpoint.split_into_layers(str(tmp_path / "hf"), str(tmp_path / "port"))
    assert read and not any("vision" in k or "multi_modal" in k for k in read)
    assert set(names) == {"model.embed_tokens", "model.norm", *(f"model.layers.{i}" for i in range(3))}
    cfg = LlamaConfig.from_pretrained(str(tmp_path / "port"))
    assert cfg.model_type == "gemma3_text" and cfg.head_dim == 256


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_split_quantized_dtypes_raise(tmp_path, dtype):
    hf_checkpoint("llama", tmp_path / "hf")
    with pytest.raises(NotImplementedError, match="3.5"):
        checkpoint.split_into_layers(str(tmp_path / "hf"), str(tmp_path / "port"), dtype=dtype)


def hf_layer_form(form: str, seed: int = 0) -> dict[str, np.ndarray]:
    """One decoder layer's Hugging Face state dict in ``form``'s key layout
    (seeded float32, tiny widths): ``mixtral`` (block_sparse_moe experts),
    ``qwen3_moe`` (mlp.experts), ``deepseek_moe`` (mlp.experts with the
    correction bias and a shared expert, MLA with q LoRA) or ``mla`` (dense
    q_proj, dense MLP)."""
    rng = np.random.default_rng(seed)
    d, f, e, nh, r, dn, dr, dv = 16, 8, 4, 2, 8, 6, 4, 5

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    p = "model.layers.0"
    sd = {f"{p}.input_layernorm.weight": w(d), f"{p}.post_attention_layernorm.weight": w(d)}
    if form in ("mla", "deepseek_moe"):
        if form == "mla":
            sd[f"{p}.self_attn.q_proj.weight"] = w(nh * (dn + dr), d)
        else:
            sd.update({f"{p}.self_attn.q_a_proj.weight": w(r, d),
                       f"{p}.self_attn.q_a_layernorm.weight": w(r),
                       f"{p}.self_attn.q_b_proj.weight": w(nh * (dn + dr), r)})
        sd.update({f"{p}.self_attn.kv_a_proj_with_mqa.weight": w(r + dr, d),
                   f"{p}.self_attn.kv_a_layernorm.weight": w(r),
                   f"{p}.self_attn.kv_b_proj.weight": w(nh * (dn + dv), r),
                   f"{p}.self_attn.o_proj.weight": w(d, nh * dv)})
    else:
        sd.update({f"{p}.self_attn.{x}_proj.weight": w(d, d) for x in "qkvo"})
    if form == "mixtral":
        sd[f"{p}.block_sparse_moe.gate.weight"] = w(e, d)
        for i in range(e):
            sd.update({f"{p}.block_sparse_moe.experts.{i}.w1.weight": w(f, d),
                       f"{p}.block_sparse_moe.experts.{i}.w3.weight": w(f, d),
                       f"{p}.block_sparse_moe.experts.{i}.w2.weight": w(d, f)})
    elif form in ("qwen3_moe", "deepseek_moe"):
        sd[f"{p}.mlp.gate.weight"] = w(e, d)
        for i in range(e):
            sd.update({f"{p}.mlp.experts.{i}.gate_proj.weight": w(f, d),
                       f"{p}.mlp.experts.{i}.up_proj.weight": w(f, d),
                       f"{p}.mlp.experts.{i}.down_proj.weight": w(d, f)})
        if form == "deepseek_moe":
            sd[f"{p}.mlp.gate.e_score_correction_bias"] = w(e)
            sd.update({f"{p}.mlp.shared_experts.gate_proj.weight": w(f, d),
                       f"{p}.mlp.shared_experts.up_proj.weight": w(f, d),
                       f"{p}.mlp.shared_experts.down_proj.weight": w(d, f)})
    else:
        sd.update({f"{p}.mlp.gate_proj.weight": w(f, d), f"{p}.mlp.up_proj.weight": w(f, d),
                   f"{p}.mlp.down_proj.weight": w(d, f)})
    return sd


@pytest.mark.parametrize("key,item", [
    ("model.layers.0.block_sparse_moe.gate.weight", None),
    ("model.layers.0.mlp.experts.0.gate_proj.weight", None),
    ("model.layers.0.self_attn.kv_a_proj_with_mqa.weight", None),
    ("model.layers.0.feed_forward.router.weight", "2.3"),
], ids=["mixtral", "qwen3_moe", "mla", "llama4"])
def test_unported_layer_forms_raise(key, item):
    """Llama 4's layer form raises naming its ROADMAP item; the expert and
    MLA forms once listed beside it convert as the JAX package converts
    them: the same keys, shapes and bits."""
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            checkpoint.hf_layer_to_native("model.layers.0", {key: torch.zeros(2, 2)})
        return
    form = {"block_sparse_moe": "mixtral", "experts": "qwen3_moe", "kv_a_proj": "mla"}
    sd = hf_layer_form(next(v for k, v in form.items() if k in key))
    assert key in sd
    want = jckpt.hf_layer_to_native("model.layers.0", sd)
    got = checkpoint.hf_layer_to_native("model.layers.0",
                                        {k: torch.from_numpy(v) for k, v in sd.items()})
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_prepare_weights_cli_splits(tmp_path):
    from flexible_llm_sharding_tpu_torch import prepare_weights

    hf_checkpoint("phi3", tmp_path / "hf")
    names = prepare_weights.main([str(tmp_path / "hf"), str(tmp_path / "port"), "--dtype", "float32",
                                  "--layout", "hf"])
    want = jckpt.split_into_layers(str(tmp_path / "hf"), str(tmp_path / "jax"), dtype="float32",
                                   layout="hf")
    assert names == want
    _assert_same_split(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("family", ["llama", "phi3"])
def test_load_layer_converts_hf_layout(tmp_path, family):
    """load_layer on the reference's own files gives what it gives on the
    native split, bit for bit (ROADMAP F2)."""
    hf_checkpoint(family, tmp_path / "hf")
    names = checkpoint.split_into_layers(str(tmp_path / "hf"), str(tmp_path / "native"))
    jckpt.split_into_layers(str(tmp_path / "hf"), str(tmp_path / "hfl"), layout="hf")
    for name in names:
        got = dict(checkpoint.flatten(checkpoint.load_layer(str(tmp_path / "hfl"), name)))
        want = dict(checkpoint.flatten(checkpoint.load_layer(str(tmp_path / "native"), name)))
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)


class _Vocab256(BenchTokenizer):
    VOCAB = 256


CLI_PROMPTS = [
    ("the quick brown fox jumps over the lazy dog " * 3, (" and runs", " then sleeps all day")),
    ("one two three four five six seven eight nine ten eleven twelve",
     (" thirteen fourteen", " x", " y z")),
]


def run_cli(main, model_dir, tmp_path, tag, extra, prompts=CLI_PROMPTS):
    """One batch-CLI run (the JAX package's or the port's) in float32 on the
    CPU: (scores, updated prompts)."""
    ppkl, opkl = tmp_path / f"{tag}.pkl", tmp_path / f"{tag}_scores.pkl"
    ppkl.write_bytes(pickle.dumps(prompts))
    main(["--model_path", str(model_dir), "--prompt_pickle", str(ppkl), "--output_file", str(opkl),
          "--dtype", "float32", "--bucket_multiple", "16", "--block_size", "2",
          "--disk_folder", str(tmp_path / f"{tag}_disk"), *extra],
         tokenizer=_Vocab256())
    return (pickle.loads(opkl.read_bytes()),
            pickle.loads((tmp_path / f"{tag}_updated.pkl").read_bytes()))


def assert_cli_match(got, want, atol=1e-5):
    (scores, updated), (want_scores, want_updated) = got, want
    assert len(scores) == len(want_scores)
    for g, w in zip(scores, want_scores):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)
    assert updated == want_updated


@pytest.mark.parametrize("mode", [[], ["--kv_cache", "true"]], ids=["generation_loop", "kv_cache"])
@pytest.mark.parametrize("family", ["llama", "phi3"])
def test_cli_on_hf_layout_split_matches_jax_cli(tmp_path, family, mode):
    """ROADMAP F2: the reference's own per-layer files (the JAX splitter's
    --layout hf) through the port's CLI give the JAX CLI's scores on the
    same files."""
    from flexible_llm_sharding_tpu.cli import main as jax_main
    from flexible_llm_sharding_tpu_torch.cli import main as torch_main

    hf_checkpoint(family, tmp_path / "hf", seed=1)
    model = tmp_path / "split"
    jckpt.split_into_layers(str(tmp_path / "hf"), str(model), dtype="float32", layout="hf")
    extra = ["--num_gen_token", "2", *mode]
    want = run_cli(jax_main, model, tmp_path, "jax", [*extra, "--num_devices", "1"])
    got = run_cli(torch_main, model, tmp_path, "torch", [*extra, "--device", "cpu"])
    assert_cli_match(got, want)
