"""The port's quantized streaming against the JAX package's, on the CPU in
float32: the int8/int4 quantizers (bytes equal), ``requantize_native`` and
the quantized split (tensor-equal files, byte-equal ``integrity.json`` and
``precision_plan.json``), streaming JAX-written int8, int4 and mixed
checkpoints through scoring and ``--kv_cache`` (scores within atol 1e-5 of
JAX's, tokens equal, and bit-equal to the port's own run on the
dequantized weights), the tied head's int8 requantization and its cache,
the host cache's packed charge, the typed plan errors, the precision
planner and ``plan-precision``, and the ``verify`` plan audit.

Tiny llama, gemma3 (windows of 6 that bind), deepseek_v3 (MLA, experts;
kv_b's in dim 16 is off the int4 group, so int4 falls back to int8 there)
and a tied llama, seeded and saved by the JAX package."""

import contextlib
import dataclasses
import io
import json
import os
import pickle
import shutil

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from bench import BenchTokenizer
from flexible_llm_sharding_tpu import cli as jcli
from flexible_llm_sharding_tpu.config import FrameworkConfig as JFrameworkConfig
from flexible_llm_sharding_tpu.config import LlamaConfig as JLlamaConfig
from flexible_llm_sharding_tpu.integrity import manifest as jman
from flexible_llm_sharding_tpu.integrity import verify as jverify
from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu.runtime import decode as jdecode
from flexible_llm_sharding_tpu.runtime import executor as jexecutor
from flexible_llm_sharding_tpu.runtime import hostcache as jhostcache
from flexible_llm_sharding_tpu.runtime import precisionplan as jpp
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu_torch import cli, prepare_weights
from flexible_llm_sharding_tpu_torch.config import FrameworkConfig
from flexible_llm_sharding_tpu_torch.integrity import manifest
from flexible_llm_sharding_tpu_torch.integrity.manifest import PrecisionMismatch
from flexible_llm_sharding_tpu_torch.integrity.verify import verify_model_dir
from flexible_llm_sharding_tpu_torch.runtime import decode, executor, hostcache
from flexible_llm_sharding_tpu_torch.runtime import precisionplan as pp
from flexible_llm_sharding_tpu_torch.runtime.hostcache import HostShardCache
from flexible_llm_sharding_tpu_torch.runtime.residency import layer_stream_bytes
from flexible_llm_sharding_tpu_torch.utils import checkpoint

CPU = torch.device("cpu")


class _Vocab256(BenchTokenizer):
    VOCAB = 256


PROMPTS = [
    ("the cat sat on the mat the cat sat on the mat", (" the cat sat", " on the mat")),
    ("alpha beta gamma alpha beta gamma alpha", (" beta gamma alpha", " delta")),
    ("one two three four", (" five six",)),
]

_SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=128, max_position_embeddings=512)
HF_CONFIGS = {
    "llama": dict(model_type="llama", **_SMALL, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2),
    "gemma3": dict(model_type="gemma3_text", **_SMALL, num_hidden_layers=3, num_attention_heads=2,
                   num_key_value_heads=1, head_dim=64, query_pre_attn_scalar=64,
                   sliding_window=6, rope_theta=1000000.0, rope_local_base_freq=10000.0,
                   layer_types=["sliding_attention", "sliding_attention", "full_attention"]),
    "deepseek_v3": dict(model_type="deepseek_v3", **_SMALL, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=4, moe_intermediate_size=32,
                        n_routed_experts=8, num_experts_per_tok=2, n_group=4, topk_group=2,
                        first_k_dense_replace=1, routed_scaling_factor=2.5, n_shared_experts=1,
                        norm_topk_prob=True, kv_lora_rank=16, q_lora_rank=24,
                        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=12,
                        rope_scaling={"type": "yarn", "factor": 4.0, "mscale": 1.0,
                                      "mscale_all_dim": 1.0, "beta_fast": 32, "beta_slow": 1,
                                      "original_max_position_embeddings": 32}),
    "tied": dict(model_type="llama", **_SMALL, num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, tie_word_embeddings=True),
}
FAMILIES = list(HF_CONFIGS)
DTYPES = ("int8", "int4", "mixed")


def _plan(layer_names) -> jpp.PrecisionPlan:
    """int4 embedding and head, bf16 first decoder and norm, int8 second
    decoder, int4 after: every dtype and every fallback."""
    pick = {"model.embed_tokens": "int4", "model.layers.0": "bf16", "model.layers.1": "int8",
            "model.norm": "bf16", "lm_head": "int4"}
    return jpp.PrecisionPlan(layers=tuple((n, pick.get(n, "int4")) for n in layer_names),
                             divergence_cap=1.0)


def _port_plan(jplan: jpp.PrecisionPlan) -> pp.PrecisionPlan:
    return pp.PrecisionPlan.from_json(jplan.to_json())


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{family: {"f32", "cfg", "names", "plan", "<dtype>": (JAX dir, port dir)}}"""
    root = tmp_path_factory.mktemp("quant_models")
    out = {}
    for i, (family, d) in enumerate(HF_CONFIGS.items()):
        cfg = JLlamaConfig.from_hf_config(d)
        init = jllama.init_mixed_params if cfg.moe_layer_pattern else jllama.init_params
        params = init(jax.random.PRNGKey(20 + i), cfg)
        f32 = root / family / "f32"
        jckpt.save_params(jax.tree.map(np.asarray, params), str(f32), cfg)
        names = jckpt.layer_names_for(cfg.num_hidden_layers, cfg.tie_word_embeddings)
        plan = _plan(names)
        entry = {"f32": str(f32), "cfg": cfg, "names": names, "plan": plan}
        for dt in DTYPES:
            jdir, pdir = root / family / f"jax_{dt}", root / family / f"port_{dt}"
            if dt == "mixed":
                jckpt.requantize_native(str(f32), str(jdir), plan=plan)
                checkpoint.requantize_native(str(f32), str(pdir), plan=_port_plan(plan))
            else:
                jckpt.requantize_native(str(f32), str(jdir), dtype=dt)
                checkpoint.requantize_native(str(f32), str(pdir), dtype=dt)
            entry[dt] = (str(jdir), str(pdir))
        out[family] = entry
    return out


@pytest.fixture(autouse=True)
def _fresh_process_state():
    hostcache.reset_process_cache()
    jhostcache.reset_process_cache()
    manifest.reset_verdicts()
    jman.reset_verdicts()
    yield
    hostcache.reset_process_cache()
    jhostcache.reset_process_cache()


def _assert_same_dir(port_dir, jax_dir):
    """The same layer files with the same keys, dtypes and bits, and the
    same integrity.json, layout marker and plan bytes."""
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
    for fn in (manifest.MANIFEST_NAME, checkpoint.NATIVE_LAYOUT_MARKER, pp.PLAN_NAME,
               "config.json"):
        a, b = os.path.join(port_dir, fn), os.path.join(jax_dir, fn)
        assert os.path.exists(a) == os.path.exists(b), fn
        if os.path.exists(b):
            with open(a, "rb") as f, open(b, "rb") as g:
                assert f.read() == g.read(), fn


# -- the quantizers ------------------------------------------------------------

@pytest.mark.parametrize("shape", [(128, 96), (4, 128, 32), (100, 40), (64, 64)])
@pytest.mark.parametrize("dtype", ["int8", "int4"])
@pytest.mark.parametrize("src", ["float32", "bfloat16", "float16"])
def test_quantizers_match_jax(shape, dtype, src):
    rng = np.random.default_rng(len(shape) * 7 + shape[-1])
    w = (rng.standard_normal(shape) * rng.uniform(0.01, 3)).astype(np.float32)
    w[..., 1] = 0.0  # an all-zero channel: the 1e-12 floor
    jw = w.astype({"bfloat16": ml_dtypes.bfloat16}.get(src, src))
    pw = checkpoint.tensor_from_numpy(jw)
    want = jckpt._quantize_flat({"k": jw, "b": jw[..., 0, :]}, dtype)
    got = checkpoint._quantize_flat({"k": pw, "b": pw[..., 0, :]}, dtype)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].numpy().tobytes() == np.ascontiguousarray(want[k]).tobytes(), k
        assert str(got[k].dtype).removeprefix("torch.") == np.asarray(want[k]).dtype.name, k
    sim = checkpoint.simulate_quantized(pw, dtype)
    assert sim.numpy().tobytes() == jckpt.simulate_quantized(jw, dtype).tobytes()
    scale = "k" + (checkpoint.QUANT4_SCALE_SUFFIX if "k::scale4" in got
                   else checkpoint.QUANT_SCALE_SUFFIX)
    node = {"q4" if scale.endswith("4") else "q8": got["k"], "s": got[scale]}
    jnode = {k: v.numpy() for k, v in node.items()}
    assert checkpoint.dequantize(node).numpy().tobytes() == jckpt.dequantize_np(jnode).tobytes()
    assert torch.equal(checkpoint.dequantize(node, torch.bfloat16),
                       torch.from_numpy(jckpt.dequantize_np(jnode)).to(torch.bfloat16))


def test_int4_quantize_roundtrip_bound():
    """Each weight within half its group's scale; the group's amax exact."""
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((128, 96)).astype(np.float32))
    q, s = checkpoint._quantize_int4(w)
    assert q.dtype == torch.uint8 and q.shape == (64, 96)
    assert s.shape == (128 // checkpoint.INT4_GROUP, 96)
    deq = checkpoint.dequantize({"q4": q, "s": s})
    err = (deq - w).abs().reshape(s.shape[0], checkpoint.INT4_GROUP, 96)
    assert bool((err <= s[:, None, :] / 2 + 1e-6).all())
    assert bool((deq.abs().reshape(err.shape).amax(dim=1) <= s * 7 + 1e-6).all())


def test_quantize_flat_upcasts_low_floats_and_estimator_agrees():
    sd = {"scale": np.ones(8, np.float16), "kern": np.ones((8, 8), np.float16)}
    qd = checkpoint._quantize_flat({k: torch.from_numpy(v) for k, v in sd.items()}, "int8")
    assert qd["scale"].dtype == torch.float32
    est = pp.layer_dtype_bytes({k: torch.from_numpy(v) for k, v in sd.items()})
    assert est == jpp.layer_dtype_bytes(sd)
    assert est["int8"] == sum(v.numel() * v.element_size() for v in qd.values()) == 8 * 4 + 64 + 32


# -- writing: requantize_native, the split, prepare_weights --------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", FAMILIES)
def test_requantize_native_matches_jax(models, family, dtype):
    jdir, pdir = models[family][dtype]
    _assert_same_dir(pdir, jdir)
    kinds = {k: v["dtype"] for k, v in manifest.load_manifest(pdir)["layers"].items()}
    if dtype == "mixed":
        assert kinds["model.layers.0"] == "bfloat16" and kinds["model.layers.1"] == "int8"
        assert kinds["model.embed_tokens"] == "int4" and kinds["model.norm"] == "bfloat16"
    else:
        assert kinds["model.layers.0"] == dtype and kinds["model.norm"] == "float32"


def test_requantize_bf16_and_refusals_match_jax(models, tmp_path):
    m = models["llama"]
    jckpt.requantize_native(m["f32"], str(tmp_path / "jax"), dtype="bfloat16")
    checkpoint.requantize_native(m["f32"], str(tmp_path / "port"), dtype="bfloat16")
    _assert_same_dir(tmp_path / "port", tmp_path / "jax")
    # The plan's bf16 layers equal the uniform bf16 checkpoint's bit for bit.
    for name, dt in m["plan"].layers:
        if dt == "bf16":
            a = checkpoint.read_safetensors(str(tmp_path / "port" / f"{name}.safetensors"))
            b = checkpoint.read_safetensors(os.path.join(m["mixed"][1], f"{name}.safetensors"))
            assert all(torch.equal(a[k].view(torch.int16), b[k].view(torch.int16)) for k in a)
    with pytest.raises(ValueError, match="already quantized"):
        checkpoint.requantize_native(m["int4"][1], str(tmp_path / "bad"), dtype="int8")
    short = pp.PrecisionPlan(layers=m["plan"].layers[:-1], divergence_cap=1.0)
    with pytest.raises(ValueError, match="drifted"):
        checkpoint.requantize_native(m["f32"], str(tmp_path / "bad2"), plan=short)
    assert not (tmp_path / "bad2").exists()
    with pytest.raises(ValueError, match="unsupported dtype"):
        checkpoint.requantize_native(m["f32"], str(tmp_path / "bad3"), dtype="int2")


def test_prepare_weights_precision_plan_matches_jax(models, tmp_path):
    import prepare_weights as jprepare

    m = models["gemma3"]
    plan_path = tmp_path / "plan.json"
    m["plan"].write(str(plan_path))
    jprepare.main([m["f32"], str(tmp_path / "jax"), "--precision_plan", str(plan_path)])
    prepare_weights.main([m["f32"], str(tmp_path / "port"), "--precision_plan", str(plan_path)])
    _assert_same_dir(tmp_path / "port", tmp_path / "jax")
    with pytest.raises(SystemExit, match="drop --dtype"):
        prepare_weights.main([m["f32"], str(tmp_path / "x"), "--precision_plan", str(plan_path),
                              "--dtype", "int8"])


# -- reading: load_layer, streaming, decode ------------------------------------

def test_load_layer_groups_scales_as_jax(models):
    _, pdir = models["deepseek_v3"]["int4"]
    for name in models["deepseek_v3"]["names"]:
        got = dict(checkpoint.flatten(checkpoint.load_layer(pdir, name)))
        jtree = jckpt.load_layer(pdir, name)
        flat_j = {}

        def walk(t, pre=""):
            for k, v in t.items():
                key = f"{pre}.{k}" if pre else k
                if jckpt.is_quantized_leaf(v):
                    for kk, vv in v.items():
                        flat_j[f"{key}.{kk}"] = np.asarray(vv)
                elif isinstance(v, dict):
                    walk(v, key)
                else:
                    flat_j[key] = np.asarray(v)

        walk(jtree)
        assert got.keys() == flat_j.keys(), name
        for k in got:
            assert got[k].numpy().tobytes() == flat_j[k].tobytes(), (name, k)
    layer = checkpoint.load_layer(pdir, "model.layers.1")
    assert checkpoint.quant_kind(layer["mlp"]["gate"]) == "q4"  # [E, 64, 32] experts
    assert checkpoint.quant_kind(layer["attn"]["kv_b"]) == "q8"  # in dim 16: int8 fallback
    assert layer["mlp"]["gate"]["q4"].shape == (8, 32, 32)


def _cfgs(model_dir, **kw):
    common = dict(model_path=model_dir, dtype="float32", bucket_multiple=8, block_size=2,
                  prefetch_depth=0, **kw)
    return FrameworkConfig(**common, device="cpu"), JFrameworkConfig(**common)


def _score_both(model_dir, **kw):
    cfg, jcfg = _cfgs(model_dir, **kw)
    want = jexecutor.StreamingExecutor(jcfg, tokenizer=_Vocab256())(list(PROMPTS))
    jhostcache.reset_process_cache()
    ex = executor.StreamingExecutor(cfg, device=CPU, tokenizer=_Vocab256())
    return ex(list(PROMPTS)), want, ex


def _dequantized_dir(qdir: str, out: str) -> str:
    """The port's host dequant of every layer of ``qdir`` as a float32
    checkpoint: what the weight source must compute on the device."""
    os.makedirs(out, exist_ok=True)
    shutil.copy(os.path.join(qdir, "config.json"), out)
    for fn in os.listdir(qdir):
        if fn.endswith(".safetensors"):
            tree = checkpoint.dequantize_tree(checkpoint.load_layer(qdir, fn[:-12]))
            flat = {k: v.float() for k, v in checkpoint.flatten(tree)}
            checkpoint.write_safetensors(os.path.join(out, fn), flat)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", FAMILIES)
def test_scoring_matches_jax_and_dequantized_oracle(models, family, dtype, tmp_path):
    jdir, _ = models[family][dtype]
    got, want, ex = _score_both(jdir)
    for g, w, (_, sfx) in zip(got, want, PROMPTS):
        assert g.shape == w.shape == (len(sfx), 1, 256)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    # Packed bytes crossed: fewer than the float32 checkpoint's.
    assert 0 < ex.stats["streamed_bytes"] < 0.5 * sum(
        os.path.getsize(os.path.join(models[family]["f32"], f))
        for f in os.listdir(models[family]["f32"]) if f.endswith(".safetensors"))
    if not models[family]["cfg"].tie_word_embeddings:  # a tied head is requantized
        oracle = _dequantized_dir(jdir, str(tmp_path / "deq"))
        hostcache.reset_process_cache()
        want_deq = executor.StreamingExecutor(_cfgs(oracle, verify_weights=False)[0], device=CPU,
                                              tokenizer=_Vocab256())(list(PROMPTS))
        for g, w in zip(got, want_deq):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", FAMILIES)
def test_kv_cache_matches_jax(models, family, dtype):
    jdir, _ = models[family][dtype]
    cfg, jcfg = _cfgs(jdir, num_gen_token=3, decode_resident="off", decode_fused="off")
    want, want_up = jdecode.DecodeGenerator(jcfg, tokenizer=_Vocab256())(list(PROMPTS))
    jhostcache.reset_process_cache()
    got, got_up = decode.DecodeGenerator(cfg, device=CPU, tokenizer=_Vocab256())(list(PROMPTS))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    assert got_up == want_up


def test_tied_head_requantized_once_and_cached(models):
    """The tied head over a quantized embedding is the int8 requantization
    of the transposed dequantized embedding (JAX's bytes), computed once
    per source without a cache and once per process with one."""
    _, pdir = models["tied"]["int4"]
    names = checkpoint.layer_names_for(2)
    head = names.index("lm_head")

    def source(cache):
        return executor.ShardWeightSource(pdir, names, [(head,)], torch.float32, CPU, 0, True,
                                          host_cache=cache, readahead_threads=0)

    executor.reset_process_tied_head_requants()
    src = source(None)
    for _ in range(3):
        cold = src.build_host_shard((head,))
    src.close()
    assert executor.process_tied_head_requants() == 1
    jloader = jexecutor._HostShardLoader(pdir, names, np.float32, tied_embeddings=True)
    jhead = jloader.build_host_shard((head,))[0][1]["kernel"]
    jloader.close()
    kern = cold[0][1]["kernel"]
    assert kern["q8"].numpy().tobytes() == jhead["q8"].tobytes()
    assert kern["s"].numpy().tobytes() == jhead["s"].tobytes()
    cache = HostShardCache(1 << 30)
    executor.reset_process_tied_head_requants()
    for _ in range(2):
        src = source(cache)
        warm = src.build_host_shard((head,))
        src.close()
    assert executor.process_tied_head_requants() == 1
    assert cache.stats()["hits"] >= 1
    assert torch.equal(warm[0][1]["kernel"]["q8"], kern["q8"])
    # The head's link bytes: int8 [D, V] + float32 [V], as the planner says.
    sizes = layer_stream_bytes(pdir, names, tied_embeddings=True)
    assert sizes[head] == 64 * 256 + 4 * 256 == hostcache.tree_nbytes(warm)
    from flexible_llm_sharding_tpu.runtime import residency as jresidency

    assert sizes == jresidency.layer_stream_bytes(pdir, names, tied_embeddings=True)


def test_hostcache_charges_packed_bytes(models):
    _, pdir = models["llama"]["int4"]
    names = checkpoint.layer_names_for(2)
    cache = HostShardCache(1 << 30)
    src = executor.ShardWeightSource(pdir, names, [(1,)], torch.float32, CPU, 0,
                                     host_cache=cache, readahead_threads=0)
    host = src.build_host_shard((1,))
    src.close()
    packed = hostcache.tree_nbytes(host)
    jloader = jexecutor._HostShardLoader(pdir, names, np.float32)
    jbuilt = sum(a.nbytes for _, seg in jloader.build_host_shard((1,))
                 for a in jax.tree.leaves(seg))
    jloader.close()
    assert cache.stats()["bytes"] == packed == jbuilt
    assert packed < 0.4 * hostcache.tree_nbytes(checkpoint.load_layer(models["llama"]["f32"],
                                                                      "model.layers.0"))


# -- typed errors --------------------------------------------------------------

def test_precision_mismatch_typed_at_load(models):
    _, pdir = models["llama"]["int8"]
    man = manifest.load_manifest(pdir)
    bad = {"layers": {**man["layers"],
                      "model.layers.1": {**man["layers"]["model.layers.1"], "dtype": "int4"}}}
    with pytest.raises(PrecisionMismatch, match="dtype kind 'int8'"):
        checkpoint.load_layer(pdir, "model.layers.1", manifest=bad)
    with pytest.raises(jman.PrecisionMismatch, match="dtype kind 'int8'"):
        jckpt.load_layer(pdir, "model.layers.1", manifest=bad)
    checkpoint.load_layer(pdir, "model.layers.0", manifest=man)


@pytest.mark.parametrize("damage", ["plan_edit", "torn_plan"])
def test_plan_errors_typed_at_source_construction(models, tmp_path, damage):
    _, pdir = models["llama"]["mixed"]
    broken = tmp_path / "broken"
    shutil.copytree(pdir, broken)
    path = broken / pp.PLAN_NAME
    if damage == "plan_edit":
        data = json.loads(path.read_text())
        data["layers"]["model.layers.1"] = "bf16"  # the manifest says int8
        path.write_text(json.dumps(data))
        match = "planned 'bf16'"
    else:
        path.write_text('{"version": 1, "layers": {truncated')
        match = "corrupt precision plan"
    names = checkpoint.layer_names_for(2)
    with pytest.raises(PrecisionMismatch, match=match):
        executor.ShardWeightSource(str(broken), names, [(0,)], torch.float32, CPU, 0)
    with pytest.raises(jman.PrecisionMismatch, match=match):
        jexecutor._HostShardLoader(str(broken), names, np.float32)
    # The verify audit reports the same problems as JAX's.
    assert _report(str(broken)) == _jreport(str(broken))


# -- the planner ---------------------------------------------------------------

def _report(d):
    return json.loads(json.dumps(verify_model_dir(d)))


def _jreport(d):
    return json.loads(json.dumps(jverify.verify_model_dir(d)))


@pytest.mark.parametrize("damage", ["none", "missing_entry", "extra_entry", "swapped_file"])
def test_verify_plan_audit_matches_jax(models, tmp_path, damage):
    _, pdir = models["gemma3"]["mixed"]
    d = tmp_path / "dir"
    shutil.copytree(pdir, d)
    path = d / pp.PLAN_NAME
    data = json.loads(path.read_text())
    if damage == "missing_entry":
        del data["layers"]["model.layers.2"]
        data["layer_order"].remove("model.layers.2")
    elif damage == "extra_entry":
        data["layers"]["model.layers.9"] = "int4"
        data["layer_order"].append("model.layers.9")
    elif damage == "swapped_file":  # an int8 file where the plan and manifest say bf16
        shutil.copy(os.path.join(models["gemma3"]["int8"][1], "model.layers.0.safetensors"),
                    d / "model.layers.0.safetensors")
    path.write_text(json.dumps(data))
    got, want = _report(str(d)), _jreport(str(d))
    assert got == want
    assert got["ok"] == (damage == "none")
    assert got["plan_layers_checked"] == want["plan_layers_checked"] > 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) if damage != "none" \
            else contextlib.nullcontext():
        cli.main(["verify", "--model_path", str(d)])
    jbuf = io.StringIO()
    with contextlib.redirect_stdout(jbuf), pytest.raises(SystemExit) if damage != "none" \
            else contextlib.nullcontext():
        jcli.verify_main(["--model_path", str(d)])
    assert buf.getvalue() == jbuf.getvalue()


def test_layer_dtype_bytes_match_jax_and_the_files(models):
    """The planner's shape-only bytes per dtype equal JAX's and the packed
    bytes the mixed checkpoint stores for each layer's planned dtype."""
    m = models["deepseek_v3"]
    for name, dt in m["plan"].layers:
        est = pp.layer_dtype_bytes(checkpoint.load_layer(m["f32"], name))
        assert est == jpp.layer_dtype_bytes(jckpt.load_layer(m["f32"], name))
        stored = checkpoint.read_safetensors(os.path.join(m["mixed"][1], f"{name}.safetensors"))
        assert est[dt] == sum(v.numel() * v.element_size() for v in stored.values()), (name, dt)


def test_simulate_layer_matches_jax(models):
    m = models["deepseek_v3"]
    for name in m["names"]:
        tree = checkpoint.load_layer(m["f32"], name)
        jtree = jckpt.load_layer(m["f32"], name)
        for dt in ("int8", "int4", "bf16"):
            got = dict(checkpoint.flatten(pp.simulate_layer(tree, dt)))
            want = dict(checkpoint.flatten(jpp.simulate_layer(jtree, dt)))
            assert got.keys() == want.keys()
            for k in got:
                assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes(), (name, dt, k)


def _random_table(seed, names):
    rng = np.random.default_rng(seed)
    sizes, sens = {}, {}
    for n in names:
        bf = int(rng.integers(100, 1000))
        i8 = bf // 2 + int(rng.integers(0, 20))
        i4 = i8 if rng.random() < 0.2 else bf // 4 + int(rng.integers(0, 20))
        sizes[n] = {"bf16": bf, "int8": i8, "int4": i4}
        a = float(rng.choice([0.0, rng.random() * 1e-3]))
        sens[n] = {"int8": a, "int4": a + float(rng.random() * 1e-2)}
    return sizes, sens


@pytest.mark.parametrize("seed", range(6))
def test_plan_from_sensitivity_matches_jax(seed):
    names = [f"l{i}" for i in range(7)]
    sizes, sens = _random_table(seed, names)
    total = sum(s["bf16"] for s in sizes.values())
    for kw in (dict(bytes_budget=int(total * f)) for f in (0.2, 0.45, 0.7, 1.0)):
        got = pp.plan_from_sensitivity(names, sizes, sens, **kw).to_json()
        assert got == jpp.plan_from_sensitivity(names, sizes, sens, **kw).to_json()
    for cap in (0.0, 1e-4, 5e-3, 1.0):
        got = pp.plan_from_sensitivity(names, sizes, sens, divergence_cap=cap).to_json()
        assert got == jpp.plan_from_sensitivity(names, sizes, sens, divergence_cap=cap).to_json()
    with pytest.raises(ValueError, match="exactly one"):
        pp.plan_from_sensitivity(names, sizes, sens)


def test_probe_sensitivity_matches_jax(models):
    m = models["llama"]
    got = pp.probe_sensitivity(m["f32"], PROMPTS, _Vocab256(), device="cpu")
    want = jpp.probe_sensitivity(m["f32"], PROMPTS, _Vocab256())
    assert got.keys() == want.keys()
    for name in want:
        for dt in ("int8", "int4"):
            assert got[name][dt] == pytest.approx(want[name][dt], rel=1e-3, abs=1e-9), (name, dt)
    with pytest.raises(ValueError, match="already quantized"):
        pp.probe_sensitivity(m["int8"][1], PROMPTS, _Vocab256(), device="cpu")


@pytest.mark.parametrize("mode", ["budget", "cap"])
@pytest.mark.parametrize("family", ["llama", "gemma3"])
def test_plan_precision_cli_matches_jax(models, tmp_path, family, mode):
    m = models[family]
    calib = tmp_path / "calib.pkl"
    calib.write_bytes(pickle.dumps(PROMPTS))
    bf16 = sum(jpp.layer_dtype_bytes(jckpt.load_layer(m["f32"], n))["bf16"] for n in m["names"])
    flag = (["--bytes_budget_gb", str(0.5 * bf16 / 1e9)] if mode == "budget"
            else ["--divergence_cap", "0.002"])
    args = ["--model_path", m["f32"], "--calib_pickle", str(calib), *flag, "--json"]
    jbuf = io.StringIO()
    with contextlib.redirect_stdout(jbuf):
        jcli.plan_precision_main(args + ["--out", str(tmp_path / "jplan.json"),
                                         "--apply", str(tmp_path / "japply")],
                                 tokenizer=_Vocab256())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["plan-precision", *args, "--device", "cpu", "--out", str(tmp_path / "plan.json"),
                  "--apply", str(tmp_path / "apply")], tokenizer=_Vocab256())
    got, want = json.loads(buf.getvalue()), json.loads(jbuf.getvalue())
    for key in ("layers", "layer_order", "bytes_budget", "est_bytes", "baseline_bytes",
                "calibration_prompts", "version"):
        assert got[key] == want[key], key
    for key in ("est_divergence", "measured_divergence", "divergence_cap"):
        assert got[key] == pytest.approx(want[key], rel=1e-3, abs=1e-9), key
    assert len(set(got["layers"].values())) > 1  # a real mix
    # The materialized checkpoints agree but for the plan's own floats.
    shutil.copy(tmp_path / "jplan.json", tmp_path / "apply" / pp.PLAN_NAME)
    _assert_same_dir(tmp_path / "apply", tmp_path / "japply")
    with pytest.raises(SystemExit, match="exactly one"):
        cli.main(["plan-precision", "--model_path", m["f32"], "--calib_pickle", str(calib)])


def test_plan_precision_defaults_to_the_card(monkeypatch, models, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calib = tmp_path / "calib.pkl"
    calib.write_bytes(pickle.dumps(PROMPTS))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["plan-precision", "--model_path", models["llama"]["f32"], "--calib_pickle",
                  str(calib), "--divergence_cap", "1"], tokenizer=_Vocab256())


def test_cli_streams_mixed_checkpoint_as_jax_cli(models, tmp_path):
    jdir, _ = models["deepseek_v3"]["mixed"]
    ppkl = tmp_path / "p.pkl"
    ppkl.write_bytes(pickle.dumps(PROMPTS))
    common = ["--model_path", jdir, "--prompt_pickle", str(ppkl), "--dtype", "float32",
              "--bucket_multiple", "8", "--kv_cache", "true", "--num_gen_token", "2"]
    jcli.main(common + ["--output_file", str(tmp_path / "j.pkl"), "--num_devices", "1"],
              tokenizer=_Vocab256())
    stats = cli.main(common + ["--output_file", str(tmp_path / "p.pkl2"), "--device", "cpu"],
                     tokenizer=_Vocab256())
    got = pickle.loads((tmp_path / "p.pkl2").read_bytes())
    want = pickle.loads((tmp_path / "j.pkl").read_bytes())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    assert stats["streamed_bytes"] > 0


def test_dataclass_round_trip_matches_jax(models):
    plan = _port_plan(models["llama"]["plan"])
    plan2 = dataclasses.replace(plan, measured_divergence=0.25, bytes_budget=123)
    assert plan2.to_json() == jpp.PrecisionPlan.from_json(plan2.to_json()).to_json()
    assert plan2.counts() == jpp.PrecisionPlan.from_json(plan2.to_json()).counts()
    with pytest.raises(ValueError, match="must be one of"):
        pp.PrecisionPlan(layers=(("a", "fp8"),), divergence_cap=1.0)
