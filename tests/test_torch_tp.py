"""The port's tensor parallelism against the JAX package, on the CPU in
float32: the port over ``[cpu] * tp`` against JAX's single-device run on the
same ``save_params`` checkpoint, at JAX's own TP tolerances.

- The specs (``layer_specs``, ``param_specs`` and
  ``TpPlacement.segment_target``) equal JAX's leaf for leaf on six families,
  with no JAX compile; ``check_tp_divisibility`` raises JAX's messages.
- Every case of ``tests/test_tp.py``: tp = 2 against one device, bf16, disk
  storage, bad head divisibility, DP×TP and its two-group floor, DP×TP
  decode, the flash-shaped dense and MLA models (the kernel wrappers' plain
  versions on the CPU), Llama 4's mixed MoE, the Qwen3-MoE dense
  interleave, flash decode and DeepSeek's MLA with experts.
- Beyond it: Gemma 3 (sandwich norms, softcaps, local layers, a tied
  head), Qwen2 with biases, int8 and int4 checkpoints written by JAX's
  ``requantize_native`` (and int4's refusal where a row split would cut a
  quantization group), a rank's uploaded bytes, and serving's refusal.

Each JAX reference is built once per module and shared by the cases that
compare with it.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from flexible_llm_sharding_tpu.config import FrameworkConfig as JFrameworkConfig
from flexible_llm_sharding_tpu.config import LlamaConfig as JLlamaConfig
from flexible_llm_sharding_tpu.parallel import sharding as jsharding
from flexible_llm_sharding_tpu.runtime import orchestration as jorch
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu_torch.config import FrameworkConfig, LlamaConfig
from flexible_llm_sharding_tpu_torch.models import llama
from flexible_llm_sharding_tpu_torch.parallel import sharding
from flexible_llm_sharding_tpu_torch.runtime import orchestration
from flexible_llm_sharding_tpu_torch.utils.checkpoint import load_layer
from tests.fake_tokenizer import FakeTokenizer

CPU = torch.device("cpu")
PROMPTS = [
    ("The capital of France", (" is Paris", " is Rome", " might be Lyon")),
    ("Water boils", (" at 100C", " when heated to its boiling point")),
    ("Two plus two equals", (" four", " five", " twenty-two", " fish")),
]
F32 = dict(rtol=1e-5, atol=1e-6)  # tests/test_tp.py's float32 bound
FLASH = dict(rtol=2e-5, atol=2e-6)  # its flash-shaped bound
BF16 = dict(rtol=2e-2, atol=2e-3)  # test_tp_bfloat16's bound
QUANT = dict(rtol=1e-4, atol=1e-5)  # tests/test_quantized.py's TP bound

TINY = JLlamaConfig(
    vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
    num_attention_heads=4, num_key_value_heads=2, rms_norm_eps=1e-5, rope_theta=10000.0,
    max_position_embeddings=512, tie_word_embeddings=False,
)
# Flash-eligible shapes (head dim 128): test_tp_pallas_flash's model.
FLASH_DENSE = JLlamaConfig(
    vocab_size=128, hidden_size=256, intermediate_size=384, num_hidden_layers=2,
    num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=512,
)
FLASH_MLA = JLlamaConfig(
    model_type="deepseek_v3", vocab_size=128, hidden_size=128, intermediate_size=192,
    num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2, kv_lora_rank=32,
    q_lora_rank=32, qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64,
    rope_interleaved=True, query_pre_attn_scalar=96.0, max_position_embeddings=512,
)
# Two layers each (a JAX compile scales with depth): a dense and a MoE
# layer in one shard, the MoE one NoPE.
LLAMA4 = JLlamaConfig(
    model_type="llama4_text", vocab_size=288, hidden_size=64, intermediate_size=32,
    intermediate_size_mlp=48, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, explicit_head_dim=16, max_position_embeddings=512,
    num_local_experts=2, num_experts_per_tok=1, moe_layer_pattern=(False, True),
    layer_rope=(True, False), rope_interleaved=True, qk_l2_norm=True,
    attn_temperature_tuning=True, attn_floor_scale=4.0, attn_scale_coef=0.1,
    tie_word_embeddings=False,
)
# Mixtral-style routing (softmax top-k) over 4 experts, 2 per rank at tp =
# 2: a token's two experts may sit on one rank or on both.
QWEN3_MOE = JLlamaConfig(
    model_type="qwen3_moe", vocab_size=288, hidden_size=64, intermediate_size=48,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, explicit_head_dim=16,
    max_position_embeddings=512, num_local_experts=4, num_experts_per_tok=2,
    moe_norm_topk_prob=True, moe_layer_pattern=(True, False), qk_norm=True,
    tie_word_embeddings=False,
)
# Group-limited routing under expert parallelism: 4 experts in 2 groups, the
# best group's top 2, each group one rank's experts at tp = 2.
DEEPSEEK = JLlamaConfig(
    model_type="deepseek_v3", vocab_size=288, hidden_size=64, intermediate_size=32,
    intermediate_size_mlp=48, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=4, kv_lora_rank=32, q_lora_rank=32, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16, num_local_experts=4, num_experts_per_tok=2,
    moe_n_group=2, moe_topk_group=1, moe_routed_scaling_factor=1.5,
    moe_layer_pattern=(False, True), rope_interleaved=True, query_pre_attn_scalar=24.0,
    max_position_embeddings=512,
)
# Gemma 3's layout (sandwich norms, q/k norm, local layers whose window
# binds at these lengths, a tied head) with both softcaps.
GEMMA3 = JLlamaConfig(
    model_type="gemma3_text", vocab_size=256, hidden_size=64, intermediate_size=128,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    max_position_embeddings=512, rms_norm_eps=1e-6, tie_word_embeddings=True,
    explicit_head_dim=32, hidden_act="gelu_pytorch_tanh", norm_unit_offset=True,
    embed_scale=True, ffw_sandwich_norms=True, qk_norm=True, query_pre_attn_scalar=64,
    sliding_window=6, layer_sliding=(True, False), rope_theta=1_000_000.0,
    rope_local_theta=10_000.0, attn_logit_softcap=50.0, final_logit_softcap=30.0,
)
QWEN2_BIAS = JLlamaConfig(
    model_type="qwen2", vocab_size=256, hidden_size=64, intermediate_size=128,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    max_position_embeddings=512, attention_in_bias=True, attention_out_bias=True,
    mlp_bias=True, tie_word_embeddings=False,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's runs here are tiny: one intra-op thread each, so a worker
    of the parallel suite does not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(jcfg: JLlamaConfig) -> LlamaConfig:
    return LlamaConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(LlamaConfig)})


def _save(tmp_path_factory, name: str, jcfg: JLlamaConfig, seed: int) -> str:
    """A seeded native checkpoint (mixed dense/MoE where the config
    interleaves) written by JAX's ``save_params``. The draws are the
    port's initialiser's (the JAX package's tree, shapes and scales), so
    no JAX program is compiled to make them."""
    cfg = _port_cfg(jcfg)
    gen = torch.Generator().manual_seed(seed)
    params = (llama.init_mixed_params if cfg.moe_layer_pattern else llama.init_params)(gen, cfg)
    d = tmp_path_factory.mktemp(name)
    jckpt.save_params(_tree_numpy(params), str(d), jcfg)
    return str(d)


def _tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_numpy(v) for v in tree]
    return tree.numpy()


def _common(model_dir, **kw) -> dict:
    """Every prompt in one bucket and one block: one block shape for JAX
    to compile."""
    base = dict(model_path=model_dir, layer_num_per_shard=2, storage_location="cpu",
                dtype="float32", bucket_multiple=64, block_size=4, prefetch_depth=1)
    return {**base, **kw}


def _jax(model_dir, prompts=PROMPTS, decode=False, **kw):
    """JAX's single-device scores (and, decoding, its updated prompts),
    every layer in one shard: one program to compile (the shard plan moves
    no number)."""
    cfg = JFrameworkConfig(**_common(model_dir, **{**kw, "layer_num_per_shard": 16}))
    if decode:
        scores, updated, _ = jorch.run_decode(cfg, prompts, tokenizer=FakeTokenizer(),
                                              devices=jax.devices()[:1])
        return scores, updated
    return jorch.run_prompts(cfg, prompts, tokenizer=FakeTokenizer(), devices=jax.devices()[:1])


def _port(model_dir, n_dev: int, prompts=PROMPTS, decode=False, calls=None, **kw):
    """The port over ``[cpu] * n_dev`` (``tensor_parallel`` in ``kw``)."""
    cfg = FrameworkConfig(**_common(model_dir, **kw), device="cpu")
    if decode:
        scores, updated, _ = orchestration.run_decode(cfg, prompts, tokenizer=FakeTokenizer(),
                                                      devices=[CPU] * n_dev, calls=calls)
        return scores, updated
    return orchestration.run_prompts(cfg, prompts, tokenizer=FakeTokenizer(),
                                     devices=[CPU] * n_dev, calls=calls)


def _close(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **tol)


def _decode_close(got, want, tol):
    """Decode scores within ``tol``, argmax tokens and texts equal."""
    (g_scores, g_updated), (w_scores, w_updated) = got, want
    _close(g_scores, w_scores, tol)
    for g, w in zip(g_scores, w_scores):
        assert (np.argmax(g, -1) == np.argmax(w, -1)).all()
    assert g_updated == w_updated


# ---------------------------------------------------------------------------
# The specs, leaf for leaf (no JAX compile)
# ---------------------------------------------------------------------------

SPEC_CFGS = {"tiny": TINY, "qwen2_bias": QWEN2_BIAS, "gemma3": GEMMA3, "mla": DEEPSEEK,
             "qwen3_moe": QWEN3_MOE, "llama4": LLAMA4}


def _as_tuples(tree, strip_stack: bool = False):
    """JAX specs (PartitionSpec, NamedSharding) as the port's tuples; the
    leading layer axis of a stacked decoder tree dropped."""
    def conv(x):
        if x is None:
            return None
        spec = tuple(getattr(x, "spec", x))
        return spec[1:] if strip_stack else spec

    return jax.tree.map(conv, tree, is_leaf=lambda x: isinstance(
        x, (jax.sharding.PartitionSpec, jax.sharding.NamedSharding)) or x is None)


@pytest.mark.parametrize("name", list(SPEC_CFGS))
def test_specs_match_jax_leaf_for_leaf(name):
    jcfg = SPEC_CFGS[name]
    cfg = _port_cfg(jcfg)
    assert sharding.layer_specs("tp", cfg) == _as_tuples(jsharding.layer_specs("tp", jcfg))
    for kind in ("dense", "moe"):
        assert (sharding.layer_specs("tp", cfg, mlp_kind=kind)
                == _as_tuples(jsharding.layer_specs("tp", jcfg, mlp_kind=kind)))
    assert sharding.param_specs(cfg) == _as_tuples(jsharding.param_specs(jcfg))
    ours = sharding.TpPlacement([CPU] * 2, cfg)
    theirs = jsharding.TpPlacement(jax.devices()[:2], jcfg)
    # The port places the embedding and the final norm (replicated in JAX)
    # on the activations' device alone: only the split kinds have specs.
    assert ours.segment_target("head") == _as_tuples(theirs.segment_target("head"))
    for mlp in ({"router": 0, "gate": 0}, {"gate": 0}):
        # The port's loader passes one layer's host tree, JAX's a stack.
        want = theirs.segment_target("decoders", {"layers": {"mlp": mlp}})
        assert (ours.segment_target("decoders", {"mlp": mlp})
                == _as_tuples(want["layers"], strip_stack=True))


@pytest.mark.parametrize("kw, tp", [
    (dict(num_attention_heads=3, num_key_value_heads=3, hidden_size=48), 2),
    (dict(num_key_value_heads=1), 2),
    (dict(intermediate_size=127), 2),
    (dict(num_local_experts=3, num_experts_per_tok=1), 2),
    (dict(model_type="llama4_text", num_local_experts=2, num_experts_per_tok=1,
          intermediate_size=33), 2),
    (dict(num_local_experts=2, num_experts_per_tok=1, intermediate_size_mlp=47,
          moe_layer_pattern=(True, False, True, True)), 2),
    (dict(), 4),
], ids=["heads", "kv_heads", "intermediate", "experts", "shared_expert", "dense_interleave",
        "tp4"])
def test_divisibility_refusals_match_jax(kw, tp):
    jcfg = dataclasses.replace(TINY, **kw)
    with pytest.raises(ValueError) as want:
        jsharding.check_tp_divisibility(jcfg, tp)
    with pytest.raises(ValueError) as got:
        sharding.check_tp_divisibility(_port_cfg(jcfg), tp)
    assert str(got.value) == str(want.value)


def test_placement_needs_two_devices():
    with pytest.raises(ValueError, match="TpPlacement needs >= 2 devices"):
        sharding.TpPlacement([CPU])


# ---------------------------------------------------------------------------
# tests/test_tp.py's cases, against JAX's single device
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    return _save(tmp_path_factory, "tp_tiny", TINY, 0)


@pytest.fixture(scope="module")
def tiny_jax(tiny_dir):
    return _jax(tiny_dir)


@pytest.mark.parametrize("tp", [2])
def test_tp_matches_single_device(tiny_dir, tiny_jax, tp):
    _close(_port(tiny_dir, tp, tensor_parallel=tp), tiny_jax, F32)


def test_tp_is_the_port_single_device_path(tiny_dir):
    """The one-device run takes the same layer code with one rank: TP over
    two ranks of one device stays within the float32 bound of it."""
    _close(_port(tiny_dir, 2, tensor_parallel=2), _port(tiny_dir, 1), F32)


def test_tp_bfloat16(tiny_dir):
    want = _jax(tiny_dir, dtype="bfloat16")
    _close(_port(tiny_dir, 2, dtype="bfloat16", tensor_parallel=2), want, BF16)


def test_tp_storage_disk(tiny_dir, tiny_jax, tmp_path):
    got = _port(tiny_dir, 2, tensor_parallel=2, storage_location="disk",
                disk_folder=str(tmp_path / "acts"))
    _close(got, tiny_jax, F32)


def test_tp_rejects_bad_head_divisibility(tiny_dir):
    # Two KV heads: tp = 4 cannot divide them.
    with pytest.raises(ValueError, match="num_key_value_heads"):
        _port(tiny_dir, 4, tensor_parallel=4)


def test_tp_needs_that_many_devices(tiny_dir):
    with pytest.raises(ValueError, match="tensor_parallel=2 needs that many chips, have 1"):
        _port(tiny_dir, 1, tensor_parallel=2)


def test_dp_tp_composition(tiny_dir, tiny_jax):
    """Two groups of tp = 2 over [cpu] * 4, one host read per shard cut per
    group rank."""
    _close(_port(tiny_dir, 4, tensor_parallel=2, data_parallel=True), tiny_jax, F32)


def test_dp_tp_needs_two_groups(tiny_dir):
    with pytest.raises(ValueError, match="at least 4 chips"):
        _port(tiny_dir, 2, tensor_parallel=2, data_parallel=True)


def test_dp_tp_leaves_a_remainder_idle(tiny_dir, tiny_jax, capsys):
    _close(_port(tiny_dir, 5, tensor_parallel=2, data_parallel=True), tiny_jax, F32)
    assert "dp x tp: 1 of 5 chips idle" in capsys.readouterr().err


@pytest.fixture(scope="module")
def flash_dir(tmp_path_factory):
    return _save(tmp_path_factory, "tp_flash", FLASH_DENSE, 1)


@pytest.fixture(scope="module")
def flash_decode_jax(flash_dir):
    return _jax(flash_dir, PROMPTS[:2], decode=True, bucket_multiple=64, prefetch_depth=0,
                num_gen_token=2, layer_num_per_shard=1, use_pallas=False)


def test_dp_tp_decode(flash_dir, flash_decode_jax):
    """DP×TP KV decode: greedy scores and tokens equal the single-device
    decode's (on the flash-shaped model, sharing its reference)."""
    got = _port(flash_dir, 4, PROMPTS[:2], decode=True, bucket_multiple=64, prefetch_depth=0,
                num_gen_token=2, layer_num_per_shard=1, tensor_parallel=2, data_parallel=True)
    _decode_close(got, flash_decode_jax, F32)


def test_tp_pallas_flash_decode(flash_dir, flash_decode_jax):
    """The decode kernel's wrapper per head shard (its plain version on the
    CPU), streamed and resident with fused steps."""
    for resident in ("off", "on"):
        got = _port(flash_dir, 2, PROMPTS[:2], decode=True, bucket_multiple=64,
                    prefetch_depth=0, num_gen_token=2, layer_num_per_shard=1,
                    tensor_parallel=2, decode_resident=resident)
        _decode_close(got, flash_decode_jax, FLASH)


def test_tp_pallas_flash(flash_dir, flash_decode_jax):
    """Head dim 128 at 64-multiple buckets: the scoring kernels' wrappers
    per head shard against JAX's XLA path on one device (the first
    position of its decode, which scores the prompts as scoring does)."""
    kw = dict(bucket_multiple=64, prefetch_depth=0)
    want = [s[:, :1] for s in flash_decode_jax[0]]
    _close(_port(flash_dir, 1, PROMPTS[:2], **kw), want, FLASH)
    _close(_port(flash_dir, 2, PROMPTS[:2], tensor_parallel=2, **kw), want, FLASH)


def test_tp_pallas_flash_mla(tmp_path_factory):
    """MLA's distinct qk/v head dims (96, 64) through the wrappers per head
    shard."""
    d = _save(tmp_path_factory, "tp_flash_mla", FLASH_MLA, 2)
    kw = dict(bucket_multiple=64, prefetch_depth=0)
    want = _jax(d, PROMPTS[:2], use_pallas=False, **kw)
    _close(_port(d, 2, PROMPTS[:2], tensor_parallel=2, **kw), want, FLASH)


def test_tp_llama4_mixed_moe(tmp_path_factory):
    """Dense layers take the dense specs, MoE layers the expert-axis and
    shared-expert specs; one shard spans the boundary; NoPE rides along."""
    d = _save(tmp_path_factory, "tp_llama4", LLAMA4, 7)
    _close(_port(d, 2, tensor_parallel=2), _jax(d), F32)


def test_tp_qwen3_moe_dense_interleave(tmp_path_factory):
    d = _save(tmp_path_factory, "tp_qwen3_moe", QWEN3_MOE, 7)
    _close(_port(d, 2, tensor_parallel=2), _jax(d), F32)


def test_tp_deepseek_mla(tmp_path_factory):
    """q_a/kv_a replicated, the up-projections split by head, wo by rows;
    the MoE layer's experts split on the expert axis (two per rank, each
    rank's experts one routing group) beside the replicated router and
    correction bias and the Megatron shared expert."""
    d = _save(tmp_path_factory, "tp_deepseek", DEEPSEEK, 7)
    _close(_port(d, 2, tensor_parallel=2), _jax(d), F32)


# ---------------------------------------------------------------------------
# Beyond tests/test_tp.py
# ---------------------------------------------------------------------------

def test_tp_gemma3_sandwich_softcap_local(tmp_path_factory):
    """The sandwich norms and ``bo``-free sums see the summed output; the
    softcaps and the windows hold per head shard; the tied head splits the
    embedding's rows and is transposed after placement."""
    d = _save(tmp_path_factory, "tp_gemma3", GEMMA3, 3)
    _close(_port(d, 2, tensor_parallel=2), _jax(d), F32)


def test_tp_qwen2_biases(tmp_path_factory):
    """Column biases split with their projections; ``bo`` and ``bdown``
    added once, after the sum."""
    d = _save(tmp_path_factory, "tp_qwen2", QWEN2_BIAS, 5)
    _close(_port(d, 2, tensor_parallel=2), _jax(d), F32)


@pytest.fixture(scope="module")
def int8_dir(tiny_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp_int8"))
    jckpt.requantize_native(tiny_dir, out, dtype="int8")
    return out


def test_tp_int8(int8_dir):
    """int8 payloads take their weight's split, per-channel scales the out
    axis's (replicated under a row split); DP×TP from one host read."""
    want = _jax(int8_dir)
    _close(_port(int8_dir, 2, tensor_parallel=2), want, QUANT)
    _close(_port(int8_dir, 4, tensor_parallel=2, data_parallel=True), want, QUANT)


def test_tp_int4(flash_dir, tmp_path):
    """int4 on a model whose row-split in dims hold whole groups per rank:
    the packed bytes and group scales cut with the weight."""
    out = str(tmp_path / "int4")
    jckpt.requantize_native(flash_dir, out, dtype="int4")
    kw = dict(bucket_multiple=64, prefetch_depth=0)
    want = _jax(out, PROMPTS[:2], **kw)
    _close(_port(out, 2, PROMPTS[:2], tensor_parallel=2, **kw), want, QUANT)


def test_tp_int4_refuses_a_split_group(tiny_dir, tmp_path):
    """The tiny model's wo [64, 64] is one int4 group: a row split over two
    ranks would cut it."""
    out = str(tmp_path / "int4")
    jckpt.requantize_native(tiny_dir, out, dtype="int4")
    with pytest.raises(NotImplementedError, match="int4 row shard would split a quantization "
                                                  "group across chips: 1 groups of 64 over tp=2"):
        _port(out, 2, tensor_parallel=2)


def test_rank_uploads_its_slices(tiny_dir, tmp_path):
    """One layer over [cpu] * 2: each rank's sharded leaves are half the
    layer's, each replicated leaf is charged once for the device. A run's
    ``streamed_bytes`` equals the single-device run's (one device), and its
    ``tp_rank_bytes`` is the busiest rank's."""
    cfg = _port_cfg(TINY)
    host = load_layer(tiny_dir, "model.layers.0")
    placement = sharding.TpPlacement([CPU] * 2, cfg)
    specs = placement.layer_specs_for("model.layers.0", host)
    moved = [0, 0]
    ranks = sharding.shard_params(host, placement.mesh, specs, lambda leaf, dev: leaf.to(dev),
                                  moved)

    nbytes = _tree_bytes
    sharded = sum(nbytes(host["attn"][k]) for k in ("wq", "wk", "wv", "wo")) + sum(
        nbytes(host["mlp"][k]) for k in ("gate", "up", "down"))
    replicated = nbytes(host) - sharded
    assert moved == [sharded // 2 + replicated, sharded // 2]
    assert ranks[0]["attn"]["wq"].shape == (64, 32) and ranks[1]["attn"]["wo"].shape == (32, 64)
    assert ranks[0]["input_layernorm"]["scale"] is ranks[1]["input_layernorm"]["scale"]
    assert torch.equal(torch.cat([r["mlp"]["down"] for r in ranks]), host["mlp"]["down"])

    one, two = [], []
    _port(tiny_dir, 1, calls=one)
    _port(tiny_dir, 2, calls=two, tensor_parallel=2)
    assert two[0]["streamed_bytes"] == one[0]["streamed_bytes"]
    assert one[0]["streamed_bytes"] / 2 < two[0]["tp_rank_bytes"] < one[0]["streamed_bytes"]


def test_tp_over_distinct_devices(tiny_dir, tiny_jax):
    """Two distinct devices (``cpu`` and ``cpu:0`` compare unequal): the
    scores are one device's, a decoder layer's replicated leaf is uploaded
    once per device (the stream's bytes grow by those leaves once more;
    the embedding and the final norm go to the first device alone), and the
    decode's fused steps run eagerly."""
    devices = [CPU, torch.device("cpu", 0)]
    cfg = FrameworkConfig(**_common(tiny_dir), device="cpu", tensor_parallel=2)
    one, two = [], []
    _port(tiny_dir, 1, calls=one)
    got = orchestration.run_prompts(cfg, PROMPTS, tokenizer=FakeTokenizer(), devices=devices,
                                    calls=two)
    _close(got, tiny_jax, F32)
    cfg_one = _port_cfg(TINY)
    placement = sharding.TpPlacement([CPU] * 2, cfg_one)
    names = [f"model.layers.{i}" for i in range(TINY.num_hidden_layers)]
    replicated = 0
    for name in names:
        host = load_layer(tiny_dir, name)
        moved = [0, 0]
        sharding.shard_params(host, placement.mesh, placement.layer_specs_for(name, host),
                              lambda leaf, d: leaf, moved)
        replicated += moved[0] - moved[1]
    assert two[0]["streamed_bytes"] == one[0]["streamed_bytes"] + replicated
    dec = orchestration.run_decode(dataclasses.replace(cfg, num_gen_token=2, decode_resident="on"),
                                   PROMPTS, tokenizer=FakeTokenizer(), devices=devices)
    ref = orchestration.run_decode(dataclasses.replace(cfg, num_gen_token=2, tensor_parallel=1,
                                                       decode_resident="on"),
                                   PROMPTS, tokenizer=FakeTokenizer(), devices=[CPU])
    _close(dec[0], ref[0], F32)
    assert dec[1] == ref[1]


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def test_tp_pins_the_ranks_slices(tiny_dir, tiny_jax):
    """With a residency budget the TP run pins its layers as the ranks'
    slices; a second run builds a new placement over the same devices and
    hits the same pins (no pin loaded again); the scores are unchanged."""
    from flexible_llm_sharding_tpu_torch.runtime import residency

    residency.reset_process_tier()
    try:
        first, second = [], []
        _close(_port(tiny_dir, 2, calls=first, tensor_parallel=2, hbm_pin_gb=1.0), tiny_jax, F32)
        loads = residency.process_tier().stats()["pin_loads"]
        _close(_port(tiny_dir, 2, calls=second, tensor_parallel=2, hbm_pin_gb=1.0), tiny_jax, F32)
        assert first[0]["pinned_bytes"] > 0 and second[0]["stream_bytes_saved"] > 0
        assert residency.process_tier().stats()["pin_loads"] == loads > 0
        key = residency.placement_key(sharding.TpPlacement([CPU] * 2, _port_cfg(TINY)))
        assert key == residency.placement_key(sharding.TpPlacement([CPU] * 2)) == (
            "tp", (("cpu", None), ("cpu", None)))
    finally:
        residency.reset_process_tier()


def test_long_context_runs_its_short_prompts_under_tp(tiny_dir, monkeypatch):
    """``long_context`` with ``tensor_parallel``: the prompts past the cap
    take the sequence-parallel path over every device, the rest the TP
    executor over the first tp of them, as in the JAX package; every score
    is the single device's untruncated one."""
    from tests.test_longcontext import LONG_PREFIX

    prompts = [(LONG_PREFIX + "and then", (" it stopped", " it ran on")), *PROMPTS[1:]]
    built = []
    real = orchestration.StreamingExecutor

    def executor(cfg, device=None, **kw):
        built.append(device)
        return real(cfg, device=device, **kw)

    want = _port(tiny_dir, 1, prompts, max_token_len=512)
    monkeypatch.setattr(orchestration, "StreamingExecutor", executor)
    got = _port(tiny_dir, 4, prompts, max_token_len=64, long_context=True, tensor_parallel=2)
    _close(got, want, dict(rtol=2e-4, atol=1e-5))  # tests/test_longcontext.py's bound
    assert len(built) == 1 and isinstance(built[0], sharding.TpPlacement)
    assert built[0].size == 2


def test_serving_refuses_tensor_parallel(tiny_dir):
    from flexible_llm_sharding_tpu_torch.serve.engine import ServeEngine

    cfg = FrameworkConfig(**_common(tiny_dir), device="cpu", tensor_parallel=2)
    with pytest.raises(ValueError, match="serving v1 drives a single placement target; drop "
                                         "data_parallel/tensor_parallel"):
        ServeEngine(cfg, tokenizer=FakeTokenizer(), device=CPU)


def test_tensor_parallel_must_be_positive():
    with pytest.raises(ValueError, match="tensor_parallel must be >= 1"):
        FrameworkConfig(tensor_parallel=0)
