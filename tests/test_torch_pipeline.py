"""The port's interleaved MP pipeline against the JAX package's, on the CPU
in float32: the port over ``[cpu] * N`` stages, JAX over N of its virtual
CPU devices, on one tiny llama checkpoint (7 execution layers: with one per
shard, 8 stages over 2 or 4 devices, the last a padding stage).

- Scoring through ``run_pipeline`` for N in {2, 4}, each storage location,
  ``num_batch`` 2: within atol 1e-5 of JAX, and bit for bit the port's
  single-device run, streaming its bytes.
- Disk-mode crash resume: a pipeline killed after 3 marked stages resumes
  bit for bit, the marker removed; a run over another device count starts
  from zero; the workload signature equals JAX's.
- KV decode over ``mp_devices``, greedy and sampled, weights resident or
  streamed: tokens equal JAX's, scores within atol 1e-5, and bit for bit
  the port's single-device per-step decode.
"""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from bench import BenchTokenizer
from flexible_llm_sharding_tpu.config import FrameworkConfig as JFrameworkConfig
from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu.runtime import decode as jdecode
from flexible_llm_sharding_tpu.runtime import hostcache as jhostcache
from flexible_llm_sharding_tpu.runtime import pipeline as jpipeline
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu_torch.config import FrameworkConfig
from flexible_llm_sharding_tpu_torch.runtime import decode, hostcache, pipeline
from flexible_llm_sharding_tpu_torch.runtime.orchestration import run_prompts

CPU = torch.device("cpu")
ATOL = 1e-5


class _Vocab256(BenchTokenizer):
    VOCAB = 256


PROMPTS = [
    ("the capital of france is a city", (" paris", " rome")),
    ("two plus two equals", (" four", " five", " fish")),
    ("one two three four five six", (" seven",)),
    ("the cat sat on the mat the cat sat on the mat", (" the cat", " on the")),
    ("alpha beta gamma", (" delta",)),
]
N_GEN = 4


class _Bomb(Exception):
    pass


@pytest.fixture(scope="module")
def model_dir(tiny_cfg, tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pipeline_model")
    params = jllama.init_params(jax.random.PRNGKey(3), tiny_cfg)
    jckpt.save_params(jax.tree.map(np.asarray, params), str(d), tiny_cfg)
    return str(d)


def _common(model_dir, disk, **kw):
    return dict(model_path=model_dir, dtype="float32", bucket_multiple=8, block_size=2,
                disk_folder=str(disk), **kw)


def _cfg(model_dir, disk, **kw):
    return FrameworkConfig(**_common(model_dir, disk, **kw), prefetch_depth=1, device="cpu")


def _jcfg(model_dir, disk, kv_cache=False, **kw):
    """The JAX config (``kv_cache`` is the JAX CLI's choice of entry point,
    not a config field)."""
    return JFrameworkConfig(**_common(model_dir, disk, **kw), prefetch_depth=1)


@pytest.fixture(scope="module")
def single(model_dir, tmp_path_factory):
    """The port's single-device scoring and its streamed bytes."""
    calls = []
    hostcache.reset_process_cache()
    out = run_prompts(_cfg(model_dir, tmp_path_factory.mktemp("single"), num_batch=2), PROMPTS,
                      tokenizer=_Vocab256(), devices=[CPU], calls=calls)
    return out, sum(c["streamed_bytes"] for c in calls)


def _close(got, want, atol=ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


def _bit_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("storage", ["gpu", "cpu", "disk"])
@pytest.mark.parametrize("n_dev", [2, 4])
def test_mp_scoring_matches_jax(model_dir, single, storage, n_dev, tmp_path):
    kw = dict(storage_location=storage, num_batch=2)
    jhostcache.reset_process_cache()
    want = jpipeline.run_pipeline(_jcfg(model_dir, tmp_path / "jax", **kw), PROMPTS,
                                  jax.devices()[:n_dev], tokenizer=_Vocab256())
    hostcache.reset_process_cache()
    runner = pipeline.PipelineRunner(_cfg(model_dir, tmp_path / "port", **kw), [CPU] * n_dev,
                                     tokenizer=_Vocab256())
    got = runner(PROMPTS)
    _close(got, want)
    _bit_equal(got, single[0])
    assert [s["num_stages"] for s in runner.stats_history] == [8.0, 8.0]
    assert sum(s["streamed_bytes"] for s in runner.stats_history) == single[1]
    assert all(s["dispatch_wall_s"] <= s["total_wall_s"] for s in runner.stats_history)


def test_mp_two_layers_a_shard_over_3_devices(model_dir, single, tmp_path):
    """ceil(7 / 2) = 4 shards, rounded up to 6 stages of the 7 layers over 3
    devices, each device with two."""
    kw = dict(layer_num_per_shard=2, num_batch=2)
    want = jpipeline.run_pipeline(_jcfg(model_dir, tmp_path, **kw), PROMPTS, jax.devices()[:3],
                                  tokenizer=_Vocab256())
    runner = pipeline.PipelineRunner(_cfg(model_dir, tmp_path, **kw), [CPU] * 3,
                                     tokenizer=_Vocab256())
    got = runner(PROMPTS)
    _close(got, want)
    _close(got, single[0])
    assert [s for _, _, s in runner.stages] == [(0, 1), (2,), (3,), (4,), (5,), (6,)]
    assert [r for _, r, _ in runner.stages] == [0, 1, 2, 0, 1, 2]


def _marker(disk):
    hits = glob.glob(os.path.join(str(disk), "progress-*.json"))
    assert len(hits) <= 1, hits
    return hits[0] if hits else None


def _bomb_after(runner, n_done: int):
    real = runner._mark_stage

    def bomb(sig, tag, done):
        real(sig, tag, done)
        if done >= n_done:
            raise _Bomb()

    runner._mark_stage = bomb


def test_mp_resume_after_crash(model_dir, tmp_path):
    want = pipeline.run_pipeline(_cfg(model_dir, tmp_path / "clean", storage_location="disk"),
                                 PROMPTS, [CPU] * 3, tokenizer=_Vocab256())
    disk = tmp_path / "acts"
    runner = pipeline.PipelineRunner(_cfg(model_dir, disk, storage_location="disk"), [CPU] * 3,
                                     tokenizer=_Vocab256())
    _bomb_after(runner, 3)
    with pytest.raises(_Bomb):
        runner(PROMPTS)
    with open(_marker(disk)) as f:
        assert json.load(f)["completed_stages"] == 3
    resumed = pipeline.PipelineRunner(
        _cfg(model_dir, disk, storage_location="disk", resume=True), [CPU] * 3,
        tokenizer=_Vocab256())
    got = resumed(PROMPTS)
    _bit_equal(got, want)
    assert _marker(disk) is None
    # Only the stages left streamed: 3 to 6 of the 9 (7 and 8 are padding).
    full = pipeline.PipelineRunner(_cfg(model_dir, tmp_path / "full", storage_location="disk"),
                                   [CPU] * 3, tokenizer=_Vocab256())
    full(PROMPTS)
    assert 0 < resumed.stats["streamed_bytes"] < full.stats["streamed_bytes"]
    # The signature and stage plan equal JAX's, so either package resumes
    # the other's run.
    jrunner = jpipeline.PipelineRunner(_jcfg(model_dir, disk), jax.devices()[:3],
                                       tokenizer=_Vocab256())
    toks = [resumed.tokenizer(p, s) for p, s in PROMPTS]
    jtoks = [jrunner.tokenizer(p, s) for p, s in PROMPTS]
    assert resumed.stages == jrunner.stages
    assert resumed._resume_signature(toks) == jrunner._resume_signature(jtoks)


def test_mp_resume_refuses_another_device_count(model_dir, tmp_path):
    disk = tmp_path / "acts"
    runner = pipeline.PipelineRunner(_cfg(model_dir, disk, storage_location="disk"), [CPU] * 3,
                                     tokenizer=_Vocab256())
    _bomb_after(runner, 2)
    with pytest.raises(_Bomb):
        runner(PROMPTS)
    assert _marker(disk) is not None
    other = pipeline.PipelineRunner(
        _cfg(model_dir, disk, storage_location="disk", resume=True), [CPU] * 2,
        tokenizer=_Vocab256())
    toks = [other.tokenizer(p, s) for p, s in PROMPTS]
    assert other._resume_start(other._resume_signature(toks), "", 99) == 0
    want = pipeline.run_pipeline(_cfg(model_dir, tmp_path / "clean", storage_location="disk"),
                                 PROMPTS, [CPU] * 2, tokenizer=_Vocab256())
    _bit_equal(other(PROMPTS), want)


DECODE_CASES = [(2, "on", 0.0), (2, "off", 0.0), (4, "on", 0.0), (4, "off", 0.8), (3, "on", 0.8)]


@pytest.mark.parametrize("n_dev,resident,temperature", DECODE_CASES,
                         ids=[f"{n}-{r}-t{t}" for n, r, t in DECODE_CASES])
def test_mp_decode_matches_jax(model_dir, tmp_path, n_dev, resident, temperature):
    kw = dict(kv_cache=True, num_gen_token=N_GEN, decode_resident=resident,
              temperature=temperature, seed=3)
    jhostcache.reset_process_cache()
    jgen = jdecode.DecodeGenerator(_jcfg(model_dir, tmp_path, **kw), tokenizer=_Vocab256(),
                                   mp_devices=jax.devices()[:n_dev])
    want, want_up = jgen(list(PROMPTS))
    hostcache.reset_process_cache()
    gen = decode.DecodeGenerator(_cfg(model_dir, tmp_path, **kw), tokenizer=_Vocab256(),
                                 mp_devices=[CPU] * n_dev)
    got, got_up = gen(list(PROMPTS))
    assert got_up == want_up
    for g, w in zip(got, want):
        assert (g.argmax(-1) == w.argmax(-1)).all()
    _close(got, want)
    assert gen.stats["decode_resident"] == jgen.stats["decode_resident"] == (resident == "on")
    assert gen.stats["decode_fused"] == jgen.stats["decode_fused"] == 0.0
    assert gen.stats["tokens_processed"] == jgen.stats["tokens_processed"]
    assert len(gen.shards) == (8 if n_dev in (2, 4) else 9)
    # The stages' per-step loop is the single device's, bit for bit.
    one = decode.DecodeGenerator(_cfg(model_dir, tmp_path, decode_fused="off", **kw), CPU,
                                 tokenizer=_Vocab256())
    one_scores, one_up = one(list(PROMPTS))
    assert one_up == got_up
    _bit_equal(got, one_scores)
    assert gen.stats["streamed_bytes"] == one.stats["streamed_bytes"]


def test_mp_decode_refuses_fused_on(model_dir, tmp_path):
    kw = dict(kv_cache=True, num_gen_token=N_GEN, decode_resident="on", decode_fused="on")
    with pytest.raises(ValueError, match="single_placement=False") as err:
        decode.DecodeGenerator(_cfg(model_dir, tmp_path, **kw), tokenizer=_Vocab256(),
                               mp_devices=[CPU] * 2)(list(PROMPTS))
    with pytest.raises(ValueError, match="single_placement=False"):
        jdecode.DecodeGenerator(_jcfg(model_dir, tmp_path, **kw), tokenizer=_Vocab256(),
                                mp_devices=jax.devices()[:2])(list(PROMPTS))
    assert "no MP pipeline" in str(err.value)


def test_mp_pins_stream_only_the_rest(model_dir, single, tmp_path):
    """A residency tier under MP: every pinned layer is pinned on its
    stage's device, each pass leaves it out of the stream, and the scores
    are the unpinned run's bit for bit."""
    from flexible_llm_sharding_tpu_torch.runtime import residency

    hostcache.reset_process_cache()
    residency.reset_process_tier()
    try:
        runner = pipeline.PipelineRunner(
            _cfg(model_dir, tmp_path, num_batch=2, hbm_pin_gb=0.0003), [CPU] * 4,
            tokenizer=_Vocab256())
        got = runner(PROMPTS)
        stats = residency.process_tier().stats()
    finally:
        residency.reset_process_tier()
    _bit_equal(got, single[0])
    assert stats["pinned_layers"] >= 2 and stats["pin_hits"] == 2 * stats["pinned_layers"]
    first, second = (s["streamed_bytes"] for s in runner.stats_history)
    assert first - second == stats["pinned_bytes"] > 0  # the pin loads, in the first pass
    assert second + stats["stream_bytes_saved"] / 2 == single[1] / 2
