"""The port's long-context path (``runtime/longcontext.py``, the
``long_context`` branches of ``runtime/orchestration.py``, the batch CLI's
``--long_context``) against the JAX package's, on the CPU in float32.

- The sharded layers (``sharded_prefix_suffix_layer``,
  ``sharded_decode_layer``) over ``[cpu] * 4`` against JAX's over four of
  its devices on the same inputs, JAX's ``jax.shard_map`` swapped for
  ``vmap_shard_map`` (``tests/test_torch_ring_attention.py``): a plain
  llama, a window and a softcap (Gemma 2), a chunk and a NoPE layer
  (Llama 4) crossing block boundaries, and MLA's V head dim.
- The scorer and decoder end to end, over ``[cpu] * 4`` with a per-device
  cap of 64 tokens under a 137-token prefix, against JAX's untruncated
  single-device run of the same checkpoint (JAX's own protocol,
  ``tests/test_longcontext.py``): rtol 2e-4 / atol 1e-5, and rtol 3e-4 /
  atol 2e-5 for the family surface. Every case of JAX's file: the exact
  score and the truncation, the uniform and mixed windows, the gemma2,
  gemma3 and llama4 surfaces, int8 and int4 streams, KV decode greedy,
  sampled, windowed and llama4, and the CLI.
- Routing and refusals: a batch all under the cap takes the normal path
  unchanged; ``--speculative_k`` with ``--long_context`` and serving with
  ``long_context`` are refused; one pass streams one device's bytes.

Each JAX reference is computed once per module.
"""

import dataclasses
import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexible_llm_sharding_tpu.config import FrameworkConfig as JFrameworkConfig
from flexible_llm_sharding_tpu.config import LlamaConfig as JLlamaConfig
from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu.parallel.sharding import make_mesh as jmake_mesh
from flexible_llm_sharding_tpu.runtime import longcontext as jlc
from flexible_llm_sharding_tpu.runtime import orchestration as jorch
from flexible_llm_sharding_tpu.runtime.tokenization import count_tokens
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu_torch import cli
from flexible_llm_sharding_tpu_torch.config import FrameworkConfig
from flexible_llm_sharding_tpu_torch.parallel.planner import plan_shards_dp
from flexible_llm_sharding_tpu_torch.parallel.sharding import gather, replicate, shard
from flexible_llm_sharding_tpu_torch.runtime import hostcache, longcontext, orchestration, residency
from flexible_llm_sharding_tpu_torch.runtime.executor import ShardWeightSource
from flexible_llm_sharding_tpu_torch.serve import ServeEngine
from flexible_llm_sharding_tpu_torch.utils import checkpoint
from flexible_llm_sharding_tpu_torch.utils.checkpoint import params_from_jax
from tests.fake_tokenizer import FakeTokenizer
from tests.test_longcontext import GEMMA2ISH, GEMMA3ISH, LLAMA4ISH, LONG_PREFIX, PROMPTS
from tests.test_torch_ring_attention import cpu_mesh, port_cfg, vmap_shard_map

CPU = torch.device("cpu")
EXACT = dict(rtol=2e-4, atol=1e-5)
FAMILY = dict(rtol=3e-4, atol=2e-5)
CAP, SP = 64, 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The sharded layers
# ---------------------------------------------------------------------------

def _deepseek() -> JLlamaConfig:
    return JLlamaConfig.from_hf_config({
        "model_type": "deepseek_v3", "vocab_size": 256, "hidden_size": 64,
        "intermediate_size": 128, "moe_intermediate_size": 32, "num_hidden_layers": 1,
        "num_attention_heads": 4, "num_key_value_heads": 4, "n_routed_experts": 4,
        "num_experts_per_tok": 2, "n_group": 2, "topk_group": 1, "first_k_dense_replace": 1,
        "kv_lora_rank": 16, "q_lora_rank": 24, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
        "v_head_dim": 12, "max_position_embeddings": 512})


MODELS = {
    "llama": lambda: JLlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                                  num_hidden_layers=2, num_attention_heads=4,
                                  num_key_value_heads=2, max_position_embeddings=512),
    # A 20-token window over 16-row blocks, a softcap, sandwich norms.
    "gemma2": lambda: JLlamaConfig(**{**GEMMA2ISH, "sliding_window": 20}),
    # 32-token chunks over 16-row blocks; layer 2 is NoPE.
    "llama4": lambda: JLlamaConfig(**LLAMA4ISH),
    "deepseek": _deepseek,
}
LAYER_CASES = {
    # case -> (model, layer index, sliding, rope_on)
    "llama": ("llama", 0, False, True),
    "gemma2_window": ("gemma2", 0, True, True),
    "llama4_chunk": ("llama4", 1, True, True),
    "llama4_nope": ("llama4", 2, False, False),
    "deepseek_mla": ("deepseek", 0, False, True),
}
LP, S, LS, PLEN, T = 64, 2, 8, 50, 3
EOS = np.array([3, 7], np.int32)


@functools.lru_cache(maxsize=None)
def _model(name: str):
    jcfg = MODELS[name]()
    init = jllama.init_mixed_params if jcfg.moe_layer_pattern else jllama.init_params
    full = jax.tree.map(np.asarray, init(jax.random.PRNGKey(7), jcfg))
    cfg = port_cfg(jcfg)
    return jcfg, full, cfg, params_from_jax(full, cfg)


@pytest.fixture(scope="module", params=list(LAYER_CASES))
def layer_case(request):
    """(JAX config, JAX layer params, port config, port layer, sliding,
    rope_on) of one case."""
    name, idx, sliding, rope_on = LAYER_CASES[request.param]
    jcfg, full, cfg, params = _model(name)
    return jcfg, full["layers"][idx], cfg, params["layers"][idx], sliding, rope_on


def _h(rng, *shape):
    return (rng.standard_normal(shape) * 0.5).astype(np.float32)


def test_sharded_prefix_suffix_layer_matches_jax(layer_case, monkeypatch):
    jcfg, jlayer, cfg, layer, sliding, rope_on = layer_case
    rng = np.random.default_rng(0)
    px, sh = _h(rng, LP, cfg.hidden_size), _h(rng, S, LS, cfg.hidden_size)
    monkeypatch.setattr(jax, "shard_map", vmap_shard_map)
    mesh = jmake_mesh({"sp": SP}, jax.devices()[:SP])
    want = jax.jit(lambda p, a, b: jlc.sharded_prefix_suffix_layer(
        p, jcfg, mesh, "sp", a, b, jnp.int32(PLEN), sliding=sliding, rope_on=rope_on,
        return_kv=True))(jlayer, px, sh)
    m = cpu_mesh(SP)
    got = longcontext.sharded_prefix_suffix_layer(
        replicate(layer, m), cfg, m, shard(torch.from_numpy(px), m), torch.from_numpy(sh), PLEN,
        sliding=sliding, rope_on=rope_on, return_kv=True)
    # Padding prefix rows (>= PLEN) carry garbage in both: the real rows agree.
    np.testing.assert_allclose(gather(got[0]).numpy()[:PLEN], np.asarray(want[0])[:PLEN], **FAMILY)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **FAMILY)
    for key in ("kp", "vp"):
        np.testing.assert_allclose(gather(got[2][key]).numpy(), np.asarray(want[2][key]), **FAMILY)
    for key in ("ks", "vs"):
        np.testing.assert_allclose(got[2][key].numpy(), np.asarray(want[2][key]), **FAMILY)
    assert got[1].shape == (S, LS, cfg.hidden_size)


def test_sharded_decode_layer_matches_jax(layer_case, monkeypatch):
    jcfg, jlayer, cfg, layer, sliding, rope_on = layer_case
    rng = np.random.default_rng(1)
    nkv, hd, hv = cfg.num_key_value_heads, cfg.head_dim, cfg.v_dim
    x = _h(rng, S, 1, cfg.hidden_size)
    kv_np = {"kp": _h(rng, LP, nkv, hd), "vp": _h(rng, LP, nkv, hv),
             "ks": _h(rng, S, LS, nkv, hd), "vs": _h(rng, S, LS, nkv, hv),
             "kg": _h(rng, S, T, nkv, hd), "vg": _h(rng, S, T, nkv, hv)}
    t = 1
    monkeypatch.setattr(jax, "shard_map", vmap_shard_map)
    mesh = jmake_mesh({"sp": SP}, jax.devices()[:SP])
    want_x, want_kv = jax.jit(lambda p, x, kv: jlc.sharded_decode_layer(
        p, jcfg, mesh, "sp", x, kv, jnp.int32(PLEN), jnp.asarray(EOS), jnp.int32(t),
        sliding=sliding, rope_on=rope_on))(jlayer, x, kv_np)
    m = cpu_mesh(SP)
    kv = {k: torch.from_numpy(v.copy()) for k, v in kv_np.items()}
    kv["kp"], kv["vp"] = shard(kv["kp"], m), shard(kv["vp"], m)
    got_x, got_kv = longcontext.sharded_decode_layer(
        replicate(layer, m), cfg, m, torch.from_numpy(x), kv, PLEN, torch.from_numpy(EOS), t,
        sliding=sliding, rope_on=rope_on)
    assert got_kv is kv  # written in place
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **FAMILY)
    for key in ("kg", "vg"):  # slot t written, the rest untouched
        np.testing.assert_allclose(kv[key].numpy(), np.asarray(want_kv[key]), **FAMILY)


# ---------------------------------------------------------------------------
# End to end against JAX's untruncated single-device runs
# ---------------------------------------------------------------------------

def _common(model_dir, **kw):
    return dict(model_path=model_dir, layer_num_per_shard=2, storage_location="cpu",
                dtype="float32", bucket_multiple=8, block_size=2, prefetch_depth=1, **kw)


def _cfg(model_dir, **kw):
    return FrameworkConfig(**_common(model_dir, **kw), device="cpu")


def _jax_ref(model_dir, n_gen=0, prompts=PROMPTS):
    """JAX's single-device run with a cap that holds every prompt: scores
    (``n_gen`` 0) or (scores, updated) of a KV decode. Every layer in one
    shard: one program to compile per pass kind (the shard plan moves no
    number)."""
    jcfg = JFrameworkConfig(**{**_common(model_dir, max_token_len=512,
                                         num_gen_token=max(n_gen, 1)),
                               "layer_num_per_shard": 16})
    if not n_gen:
        return jorch.run_prompts(jcfg, prompts, tokenizer=FakeTokenizer(),
                                 devices=jax.devices()[:1])
    scores, updated, _ = jorch.run_decode(jcfg, prompts, tokenizer=FakeTokenizer(),
                                          devices=jax.devices()[:1])
    return scores, updated


def _save(tmp_path_factory, name, jcfg, seed):
    init = jllama.init_mixed_params if jcfg.moe_layer_pattern else jllama.init_params
    d = tmp_path_factory.mktemp(name)
    jckpt.save_params(jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), jcfg)), str(d),
                      jcfg)
    return str(d)


def _close(got, want, tol=EXACT):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **tol)


def _run(model_dir, calls=None, devices=None, **kw):
    hostcache.reset_process_cache()
    kw = {"max_token_len": CAP, "long_context": True, **kw}
    return orchestration.run_prompts(_cfg(model_dir, **kw), PROMPTS, tokenizer=FakeTokenizer(),
                                     devices=[CPU] * SP if devices is None else devices,
                                     calls=calls)


def _decode(model_dir, n_gen, prompts=PROMPTS, **kw):
    return orchestration.run_decode(
        _cfg(model_dir, max_token_len=CAP, long_context=True, num_gen_token=n_gen, **kw),
        prompts, tokenizer=FakeTokenizer(), devices=[CPU] * SP)


def _step0(decoded):
    """The scoring reference inside a KV decode's: its first step."""
    return [d[:, :1] for d in decoded[0]]


@pytest.fixture(scope="module")
def model_dir(tiny_cfg, tmp_path_factory):
    return _save(tmp_path_factory, "torch_longctx", tiny_cfg, 0)


@pytest.fixture(scope="module")
def jax_decode(model_dir):
    """JAX's KV decode of PROMPTS (3 tokens); its first step is the
    scoring reference."""
    return _jax_ref(model_dir, n_gen=3)


@pytest.fixture(scope="module")
def jax_scores(jax_decode):
    return _step0(jax_decode)


@pytest.fixture(scope="module")
def window_model(tiny_cfg, tmp_path_factory):
    """A Mistral-style uniform window that binds inside the prefix, and
    JAX's 2-token decode of PROMPTS on it."""
    jcfg = dataclasses.replace(tiny_cfg, model_type="mistral", sliding_window=48)
    d = _save(tmp_path_factory, "torch_longctx_win", jcfg, 6)
    return d, _jax_ref(d, n_gen=2)


@pytest.fixture(scope="module")
def llama4_model(tmp_path_factory):
    """The Llama 4 surface (chunks across ranks, NoPE, interleaved rope,
    mixed dense/MoE) and JAX's 2-token decode of PROMPTS on it."""
    d = _save(tmp_path_factory, "torch_longctx_l4", JLlamaConfig(**LLAMA4ISH), 9)
    return d, _jax_ref(d, n_gen=2)


def test_long_prefix_scores_exactly(model_dir, jax_scores):
    assert len(FakeTokenizer()(LONG_PREFIX)["input_ids"]) > CAP
    calls = []
    got = _run(model_dir, calls=calls)
    _close(got, jax_scores)
    # The sp pass over [cpu] * 4 streams one device's bytes: the pass of
    # the short prompt (on the normal path) streams the same.
    assert [c["tokens_processed"] > 0 for c in calls] == [True, True]
    assert calls[0]["streamed_bytes"] == calls[1]["streamed_bytes"] > 0
    # Without long_context the same cap truncates, as the reference does.
    truncated = orchestration.run_prompts(_cfg(model_dir, max_token_len=CAP), PROMPTS[:1],
                                          tokenizer=FakeTokenizer(), devices=[CPU])
    assert not np.allclose(truncated[0], jax_scores[0], **EXACT)


def test_all_short_batch_takes_the_normal_path(model_dir, monkeypatch):
    want = _run(model_dir, long_context=False, devices=[CPU])
    monkeypatch.setattr(orchestration, "LongContextScorer", None)  # never built
    short = [PROMPTS[1], ("another short one", (" a", " b"))]
    got = orchestration.run_prompts(_cfg(model_dir, max_token_len=CAP, long_context=True), short,
                                    tokenizer=FakeTokenizer(), devices=[CPU])
    np.testing.assert_array_equal(got[0], want[1])
    assert got[1].shape == (2, 1, 256)


def test_long_prefix_sliding_window_uniform(window_model):
    d, decoded = window_model
    _close(_run(d), _step0(decoded))


def test_long_prefix_sliding_window_mixed(tiny_cfg, tmp_path_factory):
    """A Qwen2-style local/global mix (JAX's test sets the mix on a mistral
    config, which the port's config refuses: Hugging Face's Mistral has no
    per-layer mix)."""
    jcfg = dataclasses.replace(tiny_cfg, model_type="qwen2", sliding_window=48,
                               layer_sliding=(True, True, False, False))
    d = _save(tmp_path_factory, "torch_longctx_mix", jcfg, 2)
    _close(_run(d), _jax_ref(d))


@pytest.mark.parametrize("family", ["gemma2", "gemma3", "llama4"])
def test_long_prefix_full_family_surface(tmp_path_factory, request, family):
    if family == "llama4":
        d, decoded = request.getfixturevalue("llama4_model")
        want = _step0(decoded)
    else:
        jcfg = JLlamaConfig(**{"gemma2": GEMMA2ISH, "gemma3": GEMMA3ISH}[family])
        d = _save(tmp_path_factory, f"torch_longctx_{family}", jcfg, 5)
        want = _jax_ref(d)
    _close(_run(d), want, FAMILY)


@pytest.mark.parametrize("dtype,bar", [("int8", 0.05), ("int4", 0.15)])
def test_long_context_quantized_stream(model_dir, jax_scores, tmp_path, dtype, bar):
    """int8/int4 shards cross packed and dequantize on each distinct
    device: scores equal the port's own untruncated single-device run of
    the quantized checkpoint, and stay within JAX's quality bar of the
    float32 oracle."""
    qdir = tmp_path / dtype
    jckpt.requantize_native(model_dir, str(qdir), dtype=dtype)
    got = _run(str(qdir))
    single = _run(str(qdir), long_context=False, max_token_len=512, devices=[CPU])
    _close(got, single)
    assert np.isfinite(got[0]).all()
    assert float(np.abs(got[0] - jax_scores[0]).max()) < bar


def test_replicated_source_uploads_once_per_distinct_device(model_dir):
    """``ShardWeightSource(replicas=)`` places each shard on every distinct
    device from one host build: a list naming one device twice uploads
    once, two devices twice."""
    names = checkpoint.layer_names_for(4)
    shards = plan_shards_dp(len(names), 2).shards

    def one_pass(replicas):
        src = ShardWeightSource(model_dir, names, shards, torch.float32, replicas[0], 0,
                                readahead_threads=0, replicas=replicas)
        items = list(src)
        src.close()
        return items, src.bytes_loaded

    (single, n1), (same, n_same), (two, n2) = (
        one_pass(r) for r in ([CPU], [CPU, CPU], [CPU, torch.device("cpu", 0)]))
    assert n_same == n1 > 0 and n2 == 2 * n1
    assert [len(segs) for _, segs in same] == [1] * len(shards)
    for (idxs, segs), (idxs1, segs1) in zip(two, single):
        assert idxs == idxs1 and len(segs) == 2
        assert [k for k, _ in segs[0]] == [k for k, _ in segs[1]] == [k for k, _ in segs1[0]]


def test_long_context_pins_replicate(model_dir, jax_scores):
    """With a residency budget the sp pass's layers are pinned (once on the
    one distinct device) and the scores are unchanged."""
    residency.reset_process_tier()
    try:
        calls = []
        got = _run(model_dir, calls=calls, hbm_pin_gb=1.0)
        _close(got, jax_scores)
        assert calls[0]["pinned_bytes"] > 0 and calls[0]["stream_bytes_saved"] > 0
    finally:
        residency.reset_process_tier()


def _decode_matches(got, want, tol=EXACT):
    scores, updated, _ = got
    _close(scores, want[0], tol)
    assert updated == want[1]
    for (_, sfx), (_, usfx) in zip(PROMPTS, updated):
        for orig, new in zip(sfx, usfx):
            assert new.startswith(orig) and len(new) > len(orig)


def test_long_context_kv_decode(model_dir, jax_decode, tiny_cfg):
    got = _decode(model_dir, 3)
    for p_i, prompt in enumerate(PROMPTS):
        assert got[0][p_i].shape == (len(prompt[1]), 3, tiny_cfg.vocab_size)
    _decode_matches(got, jax_decode)
    prefix_tokens = sum(len(FakeTokenizer()(p)["input_ids"]) for p, _ in PROMPTS)
    suffix_tokens = sum(len(FakeTokenizer()(s)["input_ids"]) - 1 for _, sfx in PROMPTS for s in sfx)
    n_suffixes = sum(len(sfx) for _, sfx in PROMPTS)
    assert got[2] == prefix_tokens + suffix_tokens + n_suffixes * 2


def test_long_context_kv_decode_sampling(model_dir, jax_decode):
    kw = dict(temperature=0.8, top_k=20, top_p=0.95, seed=5)
    a, ua, _ = _decode(model_dir, 3, PROMPTS[:1], **kw)
    b, ub, _ = _decode(model_dir, 3, PROMPTS[:1], **kw)
    assert ua == ub
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_allclose(a[0][:, 0], jax_decode[0][0][:, 0], **EXACT)
    for orig, new in zip(PROMPTS[0][1], ua[0][1]):
        assert new.startswith(orig) and len(new) > len(orig)


def test_long_context_kv_decode_windowed(window_model):
    d, decoded = window_model
    _decode_matches(_decode(d, 2), decoded)


def test_long_context_kv_decode_llama4(llama4_model):
    d, decoded = llama4_model
    _decode_matches(_decode(d, 2), decoded, FAMILY)


def _pickle(tmp_path, prompts):
    ppkl = tmp_path / "p.pkl"
    ppkl.write_bytes(pickle.dumps(prompts))
    return ppkl


def test_long_context_cli(model_dir, jax_scores, tmp_path):
    ppkl, opkl = _pickle(tmp_path, PROMPTS[:1]), tmp_path / "s.pkl"
    hostcache.reset_process_cache()
    stats = cli.main(["--model_path", model_dir, "--prompt_pickle", str(ppkl),
                      "--output_file", str(opkl), "--num_gen_token", "1", "--dtype", "float32",
                      "--max_token_len", str(CAP), "--bucket_multiple", "8",
                      "--long_context", "true", "--num_devices", str(SP), "--device", "cpu"],
                     tokenizer=FakeTokenizer())
    scores = pickle.loads(opkl.read_bytes())
    assert scores[0].shape == (2, 1, 256)
    np.testing.assert_allclose(scores[0], jax_scores[0], **EXACT)
    # Tokens counted with the sp cap, as the JAX CLI counts them.
    assert stats["tokens_processed"] == count_tokens(FakeTokenizer(), PROMPTS[:1], CAP * SP)
    assert stats["num_devices"] == SP


def test_long_context_refusals(model_dir, tmp_path):
    ppkl = _pickle(tmp_path, PROMPTS[:1])
    with pytest.raises(SystemExit, match="not supported with --long_context"):
        cli.main(["--model_path", model_dir, "--prompt_pickle", str(ppkl),
                  "--output_file", str(tmp_path / "s.pkl"), "--kv_cache", "true",
                  "--speculative_k", "2", "--long_context", "true", "--device", "cpu"],
                 tokenizer=FakeTokenizer())
    with pytest.raises(ValueError, match="long_context serving is not supported yet"):
        ServeEngine(_cfg(model_dir, long_context=True), tokenizer=FakeTokenizer(), device=CPU,
                    start=False)
