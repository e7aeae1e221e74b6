"""Disk-mode crash resume, the recompute of a corrupt spill and the head
stage's score sink in the port's executor, on the CPU in float32, after the
JAX package's ``tests/test_resume.py`` and ``tests/test_integrity.py``: a
run killed after 3 of 7 shards resumes from its marker, streams only the
shards left and gives the uninterrupted run's scores bit for bit, its
marker removed; another workload, other tokens of the same shapes or
another model directory restart from zero; ``--resume false`` ignores a
marker; the batches of a ``num_batch`` loop keep markers of their own; a
spill rotted on disk between shards is recomputed from the previous
shard, bit for bit, and counted; the signature and the marker JSON equal
the JAX package's; and the score sink keeps at most its cap pending, with
the same scores at every cap."""

import dataclasses
import glob
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from bench import BenchTokenizer
from flexible_llm_sharding_tpu.cli import build_parser as jax_build_parser
from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu.parallel.planner import plan_shards_dp as jplan_shards_dp
from flexible_llm_sharding_tpu.runtime import resume as jresume
from flexible_llm_sharding_tpu.runtime.tokenization import PromptTokenizer as JPromptTokenizer
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu_torch import cli
from flexible_llm_sharding_tpu_torch.config import FrameworkConfig
from flexible_llm_sharding_tpu_torch.integrity.manifest import SpillCorruptError
from flexible_llm_sharding_tpu_torch.parallel.planner import plan_shards_dp
from flexible_llm_sharding_tpu_torch.runtime import hostcache, resume
from flexible_llm_sharding_tpu_torch.runtime.activations import ActivationStore
from flexible_llm_sharding_tpu_torch.runtime.executor import ScoreSink, StreamingExecutor
from flexible_llm_sharding_tpu_torch.runtime.hostcache import tree_nbytes
from flexible_llm_sharding_tpu_torch.runtime.orchestration import run_prompts
from flexible_llm_sharding_tpu_torch.runtime.tokenization import PromptTokenizer
from flexible_llm_sharding_tpu_torch.utils.checkpoint import layer_names_for, load_layer


class _Vocab256(BenchTokenizer):
    VOCAB = 256


PROMPTS = [
    ("the capital of france is a city", (" paris", " rome")),
    ("two plus two equals", (" four", " five", " fish")),
    ("one two three four five six", (" seven",)),
]


class _Bomb(Exception):
    pass


@pytest.fixture(scope="module")
def model_dir(tiny_cfg, tmp_path_factory):
    """The tiny 4-layer llama: 7 shards of one layer each."""
    d = tmp_path_factory.mktemp("torch_resume_model")
    params = jllama.init_params(jax.random.PRNGKey(0), tiny_cfg)
    jckpt.save_params(jax.tree.map(np.asarray, params), str(d), tiny_cfg)
    return str(d)


def _cfg(model_dir, disk, **kw):
    return FrameworkConfig(model_path=model_dir, storage_location="disk", disk_folder=str(disk),
                           dtype="float32", bucket_multiple=8, block_size=2, prefetch_depth=0,
                           device="cpu", **kw)


def _run(cfg, prompts=PROMPTS):
    hostcache.reset_process_cache()
    ex = StreamingExecutor(cfg, tokenizer=_Vocab256())
    return ex(list(prompts)), ex.stats


def _crash_after(monkeypatch, n_done: int, tag: str = ""):
    """Kill the next run of the store tagged ``tag`` as shard ``n_done``
    begins, once ``n_done`` shards have completed."""
    orig = ActivationStore.set_shard
    fired = {"n": 0}

    def bomb(self, shard_idx):
        if shard_idx == n_done and self.tag == tag and not fired["n"]:
            fired["n"] += 1
            raise _Bomb()
        orig(self, shard_idx)

    monkeypatch.setattr(ActivationStore, "set_shard", bomb)
    return fired


def _marker(disk) -> str | None:
    hits = glob.glob(os.path.join(str(disk), "progress-*.json"))
    assert len(hits) <= 1, hits
    return hits[0] if hits else None


def _shard_bytes(model_dir, first: int) -> int:
    """Host bytes of the layer files from execution slot ``first`` on."""
    names = layer_names_for(4)
    return sum(tree_nbytes(load_layer(model_dir, n)) for n in names[first:])


def _assert_bit_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_resume_after_crash_is_bit_equal(model_dir, tmp_path, monkeypatch):
    want, full = _run(_cfg(model_dir, tmp_path / "clean"))
    assert full["streamed_bytes"] == _shard_bytes(model_dir, 0)
    disk = tmp_path / "acts"
    _crash_after(monkeypatch, 3)
    with pytest.raises(_Bomb):
        _run(_cfg(model_dir, disk))
    with open(_marker(disk)) as f:
        marker = json.load(f)
    assert marker["completed_shards"] == 3 and "manifest_hash" in marker
    got, stats = _run(_cfg(model_dir, disk, resume=True))
    _assert_bit_equal(got, want)
    assert stats["streamed_bytes"] == _shard_bytes(model_dir, 3) < full["streamed_bytes"]
    assert _marker(disk) is None


_OTHER = {
    "other prompts": [("completely different", (" one", " two"))],
    "other tokens, same shapes": [(p.upper(), tuple(s.upper() for s in sfx)) for p, sfx in PROMPTS],
}


@pytest.mark.parametrize("case", [*_OTHER, "other model dir"])
def test_signature_mismatch_restarts_from_zero(model_dir, tmp_path, monkeypatch, case):
    disk = tmp_path / "acts"
    _crash_after(monkeypatch, 3)
    with pytest.raises(_Bomb):
        _run(_cfg(model_dir, disk))
    prompts, path = _OTHER.get(case, PROMPTS), model_dir
    if case == "other model dir":
        path = str(tmp_path / "copy")
        shutil.copytree(model_dir, path)
    want, _ = _run(_cfg(path, tmp_path / "clean"), prompts)
    got, stats = _run(_cfg(path, disk, resume=True), prompts)
    _assert_bit_equal(got, want)
    assert stats["streamed_bytes"] == _shard_bytes(model_dir, 0)  # every shard again
    with open(_marker(disk)) as f:  # the crashed workload's marker stays
        assert json.load(f)["completed_shards"] == 3


def test_resume_false_ignores_a_marker(model_dir, tmp_path, monkeypatch):
    want, _ = _run(_cfg(model_dir, tmp_path / "clean"))
    disk = tmp_path / "acts"
    _crash_after(monkeypatch, 3)
    with pytest.raises(_Bomb):
        _run(_cfg(model_dir, disk))
    got, stats = _run(_cfg(model_dir, disk, resume=False))
    _assert_bit_equal(got, want)
    assert stats["streamed_bytes"] == _shard_bytes(model_dir, 0)
    assert _marker(disk) is None  # the same workload's marker, removed on success


def test_num_batch_batches_keep_their_own_markers(model_dir, tmp_path, monkeypatch):
    """Batch 1 crashes after batch 0 completed; the resumed loop runs batch
    0 from zero and batch 1 from its own marker, and both batches' files and
    markers carry their batch's tag."""
    prompts = PROMPTS + [("the sky is blue", (" today", " now")), ("a b c d", (" e",))]
    hostcache.reset_process_cache()
    want = run_prompts(dataclasses.replace(_cfg(model_dir, tmp_path / "clean"), num_batch=2),
                       prompts, tokenizer=_Vocab256())
    disk = tmp_path / "acts"
    _crash_after(monkeypatch, 3, tag=".b1")
    cfg = dataclasses.replace(_cfg(model_dir, disk), num_batch=2)
    with pytest.raises(_Bomb):
        run_prompts(cfg, prompts, tokenizer=_Vocab256())
    marker = _marker(disk)
    assert marker.endswith(".b1.json")
    assert glob.glob(os.path.join(str(disk), "suffix-*.npy"))
    assert glob.glob(os.path.join(str(disk), "suffix.b1-*.npy"))
    hostcache.reset_process_cache()
    calls = []
    got = run_prompts(dataclasses.replace(cfg, resume=True), prompts, tokenizer=_Vocab256(),
                      calls=calls)
    _assert_bit_equal(got, want)
    first, second = calls
    assert first["streamed_bytes"] == _shard_bytes(model_dir, 0)
    assert second["streamed_bytes"] == _shard_bytes(model_dir, 3)
    assert _marker(disk) is None


def _flip_bit(path: str, offset_from_end: int = 9) -> None:
    pos = max(0, os.path.getsize(path) - offset_from_end)
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0x01]))


def test_recompute_after_spill_rot_is_bit_equal(model_dir, tmp_path, monkeypatch):
    """A spill rots on disk between shards 2 and 3 (re-reads cannot heal
    it): the block is re-derived from shard 2 over its intact inputs, the
    run counts the recompute, and the scores equal a clean run's."""
    want, _ = _run(_cfg(model_dir, tmp_path / "clean"))
    disk = tmp_path / "acts"
    orig = ActivationStore.set_shard
    flipped = []

    def hooked(self, shard_idx):
        orig(self, shard_idx)
        if shard_idx == 3 and not flipped:
            self.flush()  # shard 2's writes are on disk: rot one of them
            _flip_bit(os.path.join(str(disk), "suffix-00000.npy"))
            flipped.append(shard_idx)

    monkeypatch.setattr(ActivationStore, "set_shard", hooked)
    got, stats = _run(_cfg(model_dir, disk))
    assert flipped
    assert stats["recomputes"] >= 1 and stats["integrity_failures"] >= 1
    _assert_bit_equal(got, want)


def test_recompute_is_bounded_to_one_per_block(model_dir, tmp_path, monkeypatch):
    """Both generations rotten: the recompute fails too, and the run raises."""
    disk = tmp_path / "acts"
    orig = ActivationStore.set_shard

    def hooked(self, shard_idx):
        orig(self, shard_idx)
        if shard_idx == 3:
            self.flush()
            for gen in ("", ".g1"):
                _flip_bit(os.path.join(str(disk), f"suffix-00000{gen}.npy"))

    monkeypatch.setattr(ActivationStore, "set_shard", hooked)
    with pytest.raises(SpillCorruptError):
        _run(_cfg(model_dir, disk))


@pytest.mark.parametrize("location", ["cpu", "gpu"])
def test_fetch_recompute_raises_outside_disk_mode(tmp_path, location):
    store = ActivationStore(location, torch.device("cpu"), torch.float32, str(tmp_path))
    with pytest.raises(SpillCorruptError, match="disk"):
        store.fetch_recompute(0, [0])


def test_signature_and_marker_match_jax(model_dir, tmp_path):
    from flexible_llm_sharding_tpu.integrity import manifest as jmanifest
    from flexible_llm_sharding_tpu_torch.integrity import manifest

    toks = [PromptTokenizer(_Vocab256(), bucket_multiple=8)(p, s) for p, s in PROMPTS]
    jtoks = [JPromptTokenizer(_Vocab256(), bucket_multiple=8)(p, s) for p, s in PROMPTS]
    digest = manifest.manifest_digest(manifest.load_manifest(model_dir))
    assert digest and digest == jmanifest.manifest_digest(jmanifest.load_manifest(model_dir))
    plan, jplan = plan_shards_dp(7, 1), jplan_shards_dp(7, 1)
    sig = resume.workload_signature(toks, plan.shards, model_dir, "float32", 2, digest)
    assert sig == jresume.workload_signature(jtoks, jplan.shards, model_dir, "float32", 2, digest)
    assert resume.marker_path("d", sig, ".b1") == jresume.marker_path("d", sig, ".b1")
    port, jax_path = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    resume.write_marker(port, sig, completed_shards=3, manifest_hash=digest)
    jresume.write_marker(jax_path, sig, completed_shards=3, manifest_hash=digest)
    with open(port, "rb") as f, open(jax_path, "rb") as g:
        assert f.read() == g.read()
    assert resume.read_marker(jax_path, sig, digest) == jresume.read_marker(port, sig, digest)
    assert resume.read_marker(port, sig, "other") == {} == resume.read_marker(port, "x" + sig)


# ---------------------------------------------------------------------------
# The score sink
# ---------------------------------------------------------------------------

def test_score_sink_keeps_at_most_its_cap_pending():
    sink = ScoreSink(max_device=2)
    scores = torch.arange(3 * 2 * 5, dtype=torch.float32).reshape(3, 2, 5)
    sink.add_block(scores, [4, 1, 7], [2, 1, 2])
    assert len(sink._pending) == 2 and set(sink) == {4}
    sink.add_block(scores[:1] + 100, [0], [1])
    assert len(sink._pending) == 2 and set(sink) == {4, 1}
    sink.finalize()
    assert len(sink._pending) == 0 and set(sink) == {0, 1, 4, 7}
    np.testing.assert_array_equal(sink[1], scores[1, :1, None].numpy())
    np.testing.assert_array_equal(sink[7], scores[2, :, None].numpy())
    assert sink[0].shape == (1, 1, 5)


def test_score_sink_cap_below_one_raises():
    with pytest.raises(ValueError, match="score_sink_max_device"):
        ScoreSink(0)
    with pytest.raises(ValueError, match="score_sink_max_device"):
        FrameworkConfig(score_sink_max_device=0)


@pytest.mark.parametrize("location", ["cpu", "disk"])
def test_scores_are_bit_equal_at_every_cap(model_dir, tmp_path, location):
    runs = [_run(dataclasses.replace(_cfg(model_dir, tmp_path / f"d{cap}"),
                                     storage_location=location, score_sink_max_device=cap))[0]
            for cap in (1, 2, 16)]
    for got in runs[1:]:
        _assert_bit_equal(got, runs[0])


def test_cli_flags_match_jax_cli():
    argv = ["--prompt_pickle", "p", "--output_file", "o"]
    args, jargs = cli.build_parser().parse_args(argv), jax_build_parser().parse_args(argv)
    assert (args.resume, args.score_sink_max_device) == (jargs.resume, jargs.score_sink_max_device)
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        [*argv, "--resume", "true", "--score_sink_max_device", "3"]))
    assert (cfg.resume, cfg.score_sink_max_device) == (True, 3)
