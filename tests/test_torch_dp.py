"""The port's data-parallel mode and the batch CLI's multi-device runs
against the JAX package's, on the CPU in float32: the port over ``[cpu] *
N`` ranks, JAX over N of its virtual CPU devices, on one tiny llama.

- DP scoring (``run_prompts``, ``data_parallel``) for N in {2, 3}, host and
  disk activations, ``num_batch`` 2: within atol 1e-5 of JAX and bit for
  bit the port's single-device run, the disk files named as JAX names them
  (``suffix{rank}-{idx:05d}.npy``); more devices than prompts.
- The broadcast reads each shard once per round, so a DP run streams the
  single-device run's bytes; the per-rank stats.
- A rank that raises: its own exception surfaces, in scoring and decode, and
  no thread is left waiting.
- DP KV decode (``run_decode``), greedy and sampled, weights resident or
  streamed: tokens equal JAX's, scores within atol 1e-5.
- The batch CLI with ``--num_devices 2`` (the MP pipeline) and with
  ``--data_parallel true``, re-scoring loop and ``--kv_cache``, against the
  JAX CLI; the ``--speculative_k`` refusal under ``--data_parallel``.
"""

import collections
import os
import pickle
import re
import threading
import time
from queue import Queue

import jax
import numpy as np
import pytest
import torch

from bench import BenchTokenizer
from flexible_llm_sharding_tpu.cli import main as jax_main
from flexible_llm_sharding_tpu.config import FrameworkConfig as JFrameworkConfig
from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu.runtime import hostcache as jhostcache
from flexible_llm_sharding_tpu.runtime import orchestration as jorch
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu_torch import cli
from flexible_llm_sharding_tpu_torch.config import FrameworkConfig
from flexible_llm_sharding_tpu_torch.runtime import executor, hostcache, orchestration
from flexible_llm_sharding_tpu_torch.runtime.decode import DecodeGenerator
from flexible_llm_sharding_tpu_torch.runtime.executor import (
    BroadcastShardSource,
    ShardWeightSource,
    SourceClosed,
    StreamingExecutor,
)
from flexible_llm_sharding_tpu_torch.utils.checkpoint import layer_names_for

CPU = torch.device("cpu")
ATOL = 1e-5
WAIT_S = 60  # no DP run here may take longer


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


@pytest.fixture(scope="module")
def model_dir(tiny_cfg, tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_dp_model")
    params = jllama.init_params(jax.random.PRNGKey(4), tiny_cfg)
    jckpt.save_params(jax.tree.map(np.asarray, params), str(d), tiny_cfg)
    return str(d)


def _common(model_dir, disk, **kw):
    return dict(model_path=model_dir, dtype="float32", bucket_multiple=8, block_size=2,
                disk_folder=str(disk), **kw)


def _cfg(model_dir, disk, **kw):
    return FrameworkConfig(**_common(model_dir, disk, **kw), prefetch_depth=1, device="cpu")


def _jcfg(model_dir, disk, kv_cache=False, **kw):
    """The JAX config (``kv_cache`` picks the JAX CLI's entry point, it is
    not a config field)."""
    return JFrameworkConfig(**_common(model_dir, disk, **kw), prefetch_depth=1)


@pytest.fixture(scope="module")
def single(model_dir, tmp_path_factory):
    """The port's single-device scoring (``num_batch`` 2) and its bytes."""
    calls = []
    hostcache.reset_process_cache()
    out = orchestration.run_prompts(_cfg(model_dir, tmp_path_factory.mktemp("single"),
                                         num_batch=2), PROMPTS, tokenizer=_Vocab256(),
                                    devices=[CPU], calls=calls)
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


@pytest.mark.parametrize("storage", ["cpu", "disk"])
@pytest.mark.parametrize("n_dev", [2, 3])
def test_dp_scoring_matches_jax(model_dir, single, tmp_path, n_dev, storage):
    kw = dict(storage_location=storage, num_batch=2, data_parallel=True)
    jhostcache.reset_process_cache()
    want = jorch.run_prompts(_jcfg(model_dir, tmp_path / "jax", **kw), PROMPTS,
                             tokenizer=_Vocab256(), devices=jax.devices()[:n_dev])
    hostcache.reset_process_cache()
    orchestration.LAST_DP_RANK_STATS.clear()
    calls = []
    got = orchestration.run_prompts(_cfg(model_dir, tmp_path / "port", **kw), PROMPTS,
                                    tokenizer=_Vocab256(), devices=[CPU] * n_dev, calls=calls)
    _close(got, want)
    _bit_equal(got, single[0])
    # One stats dict for the fan-out; the shared stream counted once.
    assert len(calls) == 1 and calls[0]["streamed_bytes"] == single[1]
    ranks = orchestration.LAST_DP_RANK_STATS
    assert sorted(ranks) == list(range(n_dev))
    assert sum(r["prompts"] for r in ranks.values()) == len(PROMPTS)
    if storage == "disk":
        names = sorted(os.listdir(tmp_path / "port"))
        assert names == sorted(os.listdir(tmp_path / "jax"))
        assert "suffix1-00000.npy" in names and "suffix0.b1-00000.g1.npy" in names


def test_dp_more_devices_than_prompts(model_dir, single, tmp_path):
    cfg = _cfg(model_dir, tmp_path, data_parallel=True)
    want = jorch.run_prompts(_jcfg(model_dir, tmp_path, data_parallel=True), PROMPTS[:2],
                             tokenizer=_Vocab256(), devices=jax.devices()[:8])
    got = orchestration.run_prompts(cfg, PROMPTS[:2], tokenizer=_Vocab256(), devices=[CPU] * 8)
    _close(got, want)
    _close(got, single[0][:2])


def test_broadcast_reads_each_shard_once_per_round(model_dir, single, tmp_path, monkeypatch):
    """3 ranks, 2 rounds (``num_batch``): each shard is built on the host
    twice, whatever the number of ranks, and placed once per rank."""
    builds = collections.Counter()
    placed = collections.Counter()
    real_build, real_place = ShardWeightSource.build_host_shard, ShardWeightSource.place_parts

    def build(self, layer_idxs):
        builds[tuple(layer_idxs)] += 1
        return real_build(self, layer_idxs)

    def place(self, parts, hosts, device):
        placed[tuple(i for _, run in parts for i in run)] += 1
        return real_place(self, parts, hosts, device)

    monkeypatch.setattr(ShardWeightSource, "build_host_shard", build)
    monkeypatch.setattr(ShardWeightSource, "place_parts", place)
    hostcache.reset_process_cache()
    got = orchestration.run_prompts(_cfg(model_dir, tmp_path, num_batch=2, data_parallel=True),
                                    PROMPTS, tokenizer=_Vocab256(), devices=[CPU] * 3)
    _bit_equal(got, single[0])
    assert len(builds) == 7 and set(builds.values()) == {2}
    assert len(placed) == 7 and set(placed.values()) == {6}


def _no_dp_threads_left() -> bool:
    deadline = time.monotonic() + WAIT_S
    while any(t.name.startswith("dp-rank") for t in threading.enumerate()):
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def _raised(call):
    """The exception ``call`` raised (None if it returned)."""
    try:
        call()
    except Exception as e:  # noqa: BLE001 - the test checks its type
        return e
    return None


def _seen(t0: float, error) -> str:
    """What a DP failure test saw: the elapsed seconds, the threads still
    alive and the exception that surfaced."""
    alive = sorted(t.name for t in threading.enumerate() if t is not threading.current_thread())
    return (f"after {time.monotonic() - t0:.2f} s; threads alive: {alive}; "
            f"raised: {type(error).__name__}: {error}")


def _watch_sources(monkeypatch) -> list:
    made = []

    class Watched(executor.BroadcastShardSource):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(orchestration, "BroadcastShardSource", Watched)
    return made


def test_a_failing_scoring_rank_raises_its_own_error(model_dir, tmp_path, monkeypatch):
    real = StreamingExecutor.__call__

    def failing(self, prompts, batch=0):
        if self.plan.device_rank == 1:
            raise RuntimeError("rank 1 failed")
        return real(self, prompts, batch)

    monkeypatch.setattr(StreamingExecutor, "__call__", failing)
    made = _watch_sources(monkeypatch)
    t0 = time.monotonic()
    error = _raised(lambda: orchestration.run_prompts(
        _cfg(model_dir, tmp_path, data_parallel=True, num_batch=2), PROMPTS,
        tokenizer=_Vocab256(), devices=[CPU] * 3))
    assert isinstance(error, RuntimeError) and re.search("rank 1 failed", str(error)), \
        _seen(t0, error)
    assert time.monotonic() - t0 < WAIT_S, _seen(t0, error)
    assert _no_dp_threads_left(), _seen(t0, error)
    assert len(made) == 1 and not made[0]._thread.is_alive(), \
        f"{len(made)} sources made; " + _seen(t0, error)


def _wait_until(cond, what: str) -> None:
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def test_a_closed_broadcast_yields_no_shard_out_of_phase(model_dir, monkeypatch):
    """F7: the broadcast's close drained a rank's queue while the producer
    was blocked putting the next shard into it, so a rank that had not
    consumed shard 0 yet could take shard 1's weights as shard 0's and fail
    with its own error, which then hid the root cause. Here the producer is
    left blocked on a put into a full queue: close() drains no queue until
    the producer has ended, and a view of the closed source raises
    ``SourceClosed`` without yielding a shard."""
    sources: list[BroadcastShardSource] = []
    drained_while_producing: list[bool] = []

    class WatchedQueue(Queue):
        def get_nowait(self):
            drained_while_producing.append(sources[0]._thread.is_alive())
            return super().get_nowait()

    monkeypatch.setattr(executor, "Queue", WatchedQueue)
    names = layer_names_for(4)
    src = BroadcastShardSource(model_dir, names, [(i,) for i in range(len(names))],
                               torch.float32, [CPU, CPU], prefetch_depth=1)
    sources.append(src)
    q0, q1 = src._queues
    # Shard 0 fills both ranks' queues; no rank consumes, so the producer
    # cannot end: it builds shard 1 and blocks putting it.
    _wait_until(lambda: q0.full() and q1.full(), "shard 0 never reached both ranks")
    src.close()
    assert not src._thread.is_alive()
    assert drained_while_producing and not any(drained_while_producing), \
        f"close drained a queue while its producer could still put: {drained_while_producing}"
    assert q0.empty() and q1.empty()
    for rank in (0, 1):
        yielded = []
        with pytest.raises(SourceClosed):
            for idxs, _ in src.view(rank):
                yielded.append(idxs)
        assert yielded == [], f"rank {rank} took {yielded} from a closed source"


def test_a_failing_decode_rank_raises_its_own_error(model_dir, tmp_path, monkeypatch):
    real = DecodeGenerator.__call__

    def failing(self, prompts, num_gen_token=None):
        if list(prompts)[0] == PROMPTS[3]:  # rank 1 of 2
            raise RuntimeError("decode rank failed")
        return real(self, prompts, num_gen_token)

    monkeypatch.setattr(DecodeGenerator, "__call__", failing)
    made = _watch_sources(monkeypatch)
    t0 = time.monotonic()
    error = _raised(lambda: orchestration.run_decode(
        _cfg(model_dir, tmp_path, data_parallel=True, kv_cache=True, num_gen_token=N_GEN,
             decode_resident="off"), PROMPTS, tokenizer=_Vocab256(), devices=[CPU] * 2))
    assert isinstance(error, RuntimeError) and re.search("decode rank failed", str(error)), \
        _seen(t0, error)
    assert _no_dp_threads_left(), _seen(t0, error)
    assert len(made) == 1 and not made[0]._thread.is_alive(), \
        f"{len(made)} sources made; " + _seen(t0, error)


DECODE_CASES = [(2, "on", 0.0), (2, "off", 0.0), (3, "off", 0.8), (3, "on", 0.8)]


@pytest.mark.parametrize("n_dev,resident,temperature", DECODE_CASES,
                         ids=[f"{n}-{r}-t{t}" for n, r, t in DECODE_CASES])
def test_dp_decode_matches_jax(model_dir, tmp_path, n_dev, resident, temperature):
    kw = dict(kv_cache=True, num_gen_token=N_GEN, decode_resident=resident,
              temperature=temperature, seed=3, data_parallel=True)
    jhostcache.reset_process_cache()
    want, want_up, want_tokens = jorch.run_decode(_jcfg(model_dir, tmp_path, **kw), PROMPTS,
                                                  tokenizer=_Vocab256(),
                                                  devices=jax.devices()[:n_dev])
    hostcache.reset_process_cache()
    calls = []
    got, got_up, tokens = orchestration.run_decode(_cfg(model_dir, tmp_path, **kw), PROMPTS,
                                                   tokenizer=_Vocab256(), devices=[CPU] * n_dev,
                                                   calls=calls)
    assert got_up == want_up and tokens == want_tokens
    for g, w in zip(got, want):
        assert (g.argmax(-1) == w.argmax(-1)).all()
    _close(got, want)
    # One read per pass: resident streams the model once, streamed once per token.
    one = DecodeGenerator(_cfg(model_dir, tmp_path, kv_cache=True, num_gen_token=N_GEN,
                               decode_resident=resident), CPU, tokenizer=_Vocab256())
    one(list(PROMPTS))
    assert len(calls) == 1 and calls[0]["streamed_bytes"] == one.stats["streamed_bytes"]
    assert calls[0]["decode_resident"] == (resident == "on")


def _run_cli(main, model_dir, tmp_path, tag, extra):
    ppkl, opkl = tmp_path / f"{tag}.pkl", tmp_path / f"{tag}_scores.pkl"
    with open(ppkl, "wb") as f:
        pickle.dump(PROMPTS, f)
    stats = main(["--model_path", model_dir, "--prompt_pickle", str(ppkl), "--output_file",
                  str(opkl), "--dtype", "float32", "--bucket_multiple", "8", "--block_size", "2",
                  "--num_devices", "2", "--disk_folder", str(tmp_path / f"{tag}_disk"), *extra],
                 tokenizer=_Vocab256())
    with open(opkl, "rb") as f:
        scores = pickle.load(f)
    with open(tmp_path / f"{tag}_updated.pkl", "rb") as f:
        updated = pickle.load(f)
    return scores, updated, stats


CLI_CASES = {
    "mp_loop": ["--num_gen_token", "3", "--num_batch", "2"],
    "mp_kv": ["--num_gen_token", "3", "--kv_cache", "true", "--decode_resident", "on"],
    "dp_loop": ["--num_gen_token", "3", "--data_parallel", "true"],
    "dp_kv": ["--num_gen_token", "3", "--kv_cache", "true", "--decode_resident", "off",
              "--data_parallel", "true"],
    "dp_kv_sampled": ["--num_gen_token", "3", "--kv_cache", "true", "--decode_resident", "on",
                      "--data_parallel", "true", "--temperature", "0.7", "--seed", "5"],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_multi_device_matches_jax_cli(model_dir, tmp_path, case):
    extra = CLI_CASES[case]
    jhostcache.reset_process_cache()
    want, want_up, _ = _run_cli(jax_main, model_dir, tmp_path, "jax", extra)
    hostcache.reset_process_cache()
    got, got_up, stats = _run_cli(cli.main, model_dir, tmp_path, "port",
                                  [*extra, "--device", "cpu"])
    assert got_up == want_up
    for g, w in zip(got, want):
        assert (g.argmax(-1) == w.argmax(-1)).all()
    _close(got, want)
    assert stats["num_devices"] == 2 and stats["peak_hbm_scope"] == "process"
    if "--data_parallel" in extra:
        assert stats["streamed_bytes_note"].startswith("broadcast")
        assert sorted(stats["dp_ranks"]) == ["0", "1"]
        # A rank's prompts, however many passes the loop made (as JAX counts).
        assert sum(r["prompts"] for r in stats["dp_ranks"].values()) == len(PROMPTS)
    else:
        assert "dp_ranks" not in stats and "streamed_bytes_note" not in stats


def test_cli_refuses_speculation_with_data_parallel(model_dir, tmp_path):
    args = ["--kv_cache", "true", "--speculative_k", "2", "--data_parallel", "true"]
    with pytest.raises(SystemExit) as jerr:
        _run_cli(jax_main, model_dir, tmp_path, "jax", args)
    with pytest.raises(SystemExit) as err:
        _run_cli(cli.main, model_dir, tmp_path, "port", [*args, "--device", "cpu"])
    assert str(err.value) == str(jerr.value)
    assert "--speculative_k does not compose with --data_parallel" in str(err.value)
    assert "ignore" not in cli.build_parser().format_help().lower()


def test_dp_pins_are_read_once_and_left_out_of_every_round(model_dir, single, tmp_path,
                                                           monkeypatch):
    """A residency tier under DP (``ensure_pinned_broadcast``): each pinned
    layer is built on the host once and seated on the ranks' device from
    that build, every round's stream leaves it out, the other shards are
    built once a round, and the scores are the unpinned run's."""
    from flexible_llm_sharding_tpu_torch.runtime import residency

    builds = collections.Counter()
    real_build = ShardWeightSource.build_host_shard

    def build(self, layer_idxs):
        builds[tuple(layer_idxs)] += 1
        return real_build(self, layer_idxs)

    monkeypatch.setattr(ShardWeightSource, "build_host_shard", build)
    hostcache.reset_process_cache()
    residency.reset_process_tier()
    try:
        # 300 kB: the embedding, head and norm, then one decoder layer.
        got = orchestration.run_prompts(
            _cfg(model_dir, tmp_path, num_batch=2, data_parallel=True, hbm_pin_gb=0.0003),
            PROMPTS, tokenizer=_Vocab256(), devices=[CPU] * 3)
        tier = residency.process_tier()
        pinned = set(tier.plan.pinned)
        stats = tier.stats()
    finally:
        residency.reset_process_tier()
    _bit_equal(got, single[0])
    assert 2 <= len(pinned) < 7
    assert {idxs[0]: n for idxs, n in builds.items()} == {
        i: 1 if i in pinned else 2 for i in range(7)}
    assert stats["pin_hits"] == 2 * len(pinned) and stats["pin_loads"] == len(pinned)
