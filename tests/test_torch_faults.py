"""The port's fault sites against the JAX package's, on the CPU: the cases of
``tests/test_faults.py``, the batch CLI under every loader, upload and spill
site, the MP and DP modes under ``shard_read``, ``engine_step`` wave
recovery, and the twin of ``tests/test_spec_adaptive.py``'s brownout case.

- Units: the injector's schedule and budget, the retry policy, the step
  watchdog, the weight source's producer surviving a failed shard and the
  loader absorbing flaky reads (the JAX loader's retry count on the same
  schedule), the queue's ``queue_admission`` rejection.
- The batch CLI (``--chaos --chaos_sites S``) for each of ``shard_read``,
  ``device_put``, ``host_oom``, ``corrupt_shard``, ``link_throttle``,
  ``disk_full`` and ``corrupt_activation``: scores within 1e-5 of the JAX
  executor's under the same chaos config, the same ``io_retries`` and
  ``reread_heals``, the same faults injected, and the clean run's scores.
- The serving engine on a tiny checkpoint (2 layers, hidden 64, float32,
  the ``FakeTokenizer``): tokens equal to the JAX offline decode's under
  ``shard_read`` and ``engine_step`` chaos, a persistent fault failing one
  wave and a restarted source serving the next, the stall watchdog.

Threaded cases fix their order: engines start after their first requests
are queued, and a brownout is noted and sampled before the engine starts.
"""

import io
import json
import os
import pickle
import threading
import time

import jax
import numpy as np
import pytest
import torch

from flexible_llm_sharding_tpu.adapters import loader as jloader
from flexible_llm_sharding_tpu.config import FaultConfig as JFaultConfig
from flexible_llm_sharding_tpu.config import FrameworkConfig as JFrameworkConfig
from flexible_llm_sharding_tpu.config import LlamaConfig as JLlamaConfig
from flexible_llm_sharding_tpu.faults import inject as jinject
from flexible_llm_sharding_tpu.faults import retry as jretry
from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu.runtime import hostcache as jhostcache
from flexible_llm_sharding_tpu.runtime import kvpool as jkvpool
from flexible_llm_sharding_tpu.runtime import pressure as jpressure
from flexible_llm_sharding_tpu.runtime.decode import DecodeGenerator as JDecodeGenerator
from flexible_llm_sharding_tpu.runtime.executor import StreamingExecutor as JStreamingExecutor
from flexible_llm_sharding_tpu.runtime.executor import _HostShardLoader as JHostShardLoader
from flexible_llm_sharding_tpu.serve import queue as jqueue
from flexible_llm_sharding_tpu.serve import request as jrequest
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu.utils.metrics import RetryRecorder as JRetryRecorder
from flexible_llm_sharding_tpu.utils.metrics import StepWatchdog as JStepWatchdog
from flexible_llm_sharding_tpu_torch import cli
from flexible_llm_sharding_tpu_torch.adapters import loader
from flexible_llm_sharding_tpu_torch.config import (
    FaultConfig,
    FrameworkConfig,
    PressureConfig,
    ServeConfig,
)
from flexible_llm_sharding_tpu_torch.faults import inject
from flexible_llm_sharding_tpu_torch.faults.inject import FaultInjector, InjectedFault
from flexible_llm_sharding_tpu_torch.faults.retry import RetryPolicy, ShardLoadError, retry_call
from flexible_llm_sharding_tpu_torch.parallel.planner import plan_shards_dp
from flexible_llm_sharding_tpu_torch.runtime import hostcache, kvpool, orchestration, pressure
from flexible_llm_sharding_tpu_torch.runtime.executor import ShardWeightSource, _tree_leaves
from flexible_llm_sharding_tpu_torch.runtime.pressure import PressureSnapshot
from flexible_llm_sharding_tpu_torch.serve import (
    AdmissionQueue,
    Request,
    RequestStatus,
    ServeEngine,
    WaveAborted,
)
from flexible_llm_sharding_tpu_torch.utils.checkpoint import layer_names_for
from flexible_llm_sharding_tpu_torch.utils.metrics import RetryRecorder, StepWatchdog

from tests.fake_tokenizer import FakeTokenizer

CHAOS_SEED = int(os.environ.get("FLS_CHAOS_SEED", "1234"))
CPU = torch.device("cpu")
N_LAYERS = 2
N_GEN = 4
PROMPTS = [
    ("The capital of France", (" is Paris", " is Rome")),
    ("Two plus two equals", (" four", " five")),
    ("The sky is", (" blue", " green")),
    ("Hello world", (" again", " anew")),
]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny llama (2 layers, hidden 64) saved by the JAX package."""
    d = tmp_path_factory.mktemp("faults_model")
    cfg = JLlamaConfig.from_hf_config(dict(
        model_type="llama", vocab_size=256, hidden_size=64, intermediate_size=128,
        max_position_embeddings=512, num_hidden_layers=N_LAYERS, num_attention_heads=4,
        num_key_value_heads=2))
    jckpt.save_params(jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(0), cfg)),
                      str(d), cfg)
    return str(d)


def _reset():
    for mod in (loader, jloader):
        mod.reset_process_store()
    for mod in (pressure, jpressure):
        mod.reset_process_pressure()
    for mod in (hostcache, jhostcache):
        mod.reset_process_cache()
    for mod in (kvpool, jkvpool):
        mod.reset_process_pools()


@pytest.fixture(autouse=True)
def _fresh_process_state():
    _reset()
    yield
    _reset()


_FW = dict(layer_num_per_shard=1, storage_location="cpu", dtype="float32", bucket_multiple=8,
           block_size=2, prefetch_depth=0, io_retry_attempts=8, io_retry_base_s=0.001)


def _fw(model_dir, port: bool = True, **kw):
    if port:
        return FrameworkConfig(model_path=model_dir, device="cpu", **{**_FW, **kw})
    return JFrameworkConfig(model_path=model_dir, **{**_FW, **kw})


def _chaos(port: bool = True, **kw):
    return (FaultConfig if port else JFaultConfig)(enabled=True, seed=CHAOS_SEED, **kw)


@pytest.fixture(scope="module")
def oracle(model_dir, tmp_path_factory):
    """The JAX package's offline decode of PROMPTS, N_GEN tokens: (scores,
    tokens) per prompt."""
    cfg = _fw(model_dir, port=False, num_gen_token=N_GEN,
              disk_folder=str(tmp_path_factory.mktemp("oracle")))
    scores, _ = JDecodeGenerator(cfg, tokenizer=FakeTokenizer())(list(PROMPTS))
    return [(s, s.argmax(-1)) for s in scores]


def _check(res, want, n=N_GEN):
    scores, tokens = want
    np.testing.assert_array_equal(res.tokens, tokens[:, :n])
    np.testing.assert_allclose(res.scores, scores[:, :n], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Injector, retry policy and watchdog units
# ---------------------------------------------------------------------------

def test_fault_config_validation():
    for mod, fw in ((FaultConfig, FrameworkConfig), (JFaultConfig, JFrameworkConfig)):
        for kw, match in ((dict(error_rate=1.5), "error_rate"),
                          (dict(error_rate=0.6, truncate_rate=0.6), "sum"),
                          (dict(sites=("shard_red",)), "unknown fault sites")):
            with pytest.raises(ValueError, match=match):
                mod(**kw)
        with pytest.raises(ValueError):
            fw(io_retry_attempts=0)


def test_injector_deterministic_schedule_and_kinds():
    def run(mod, cfg_cls, seed):
        inj = mod.FaultInjector.from_config(cfg_cls(
            enabled=True, seed=seed, error_rate=0.2, truncate_rate=0.2, latency_rate=0.2,
            latency_s=0.0))
        for _ in range(200):
            try:
                inj.fire("shard_read")
            except mod.InjectedFault:
                pass
        return inj.events

    a = run(inject, FaultConfig, 7)
    assert a == run(inject, FaultConfig, 7) == run(jinject, JFaultConfig, 7) and a
    assert run(inject, FaultConfig, 8) != a
    assert {k for _, k, _ in a} == {"error", "truncated", "latency"}
    assert issubclass(inject.TruncatedRead, InjectedFault) and issubclass(InjectedFault, IOError)


def test_injector_sites_filter_and_budget():
    for mod, cfg_cls in ((inject, FaultConfig), (jinject, JFaultConfig)):
        inj = mod.FaultInjector.from_config(cfg_cls(enabled=True, seed=CHAOS_SEED, error_rate=1.0,
                                                    sites=("device_put",), max_faults=2))
        inj.fire("shard_read")
        for _ in range(5):
            try:
                inj.fire("device_put")
            except mod.InjectedFault:
                pass
        assert inj.count() == 2
        inj.fire("device_put")
        with pytest.raises(ValueError, match="unknown fault site"):
            inj.fire("nonsense")
        assert mod.FaultInjector.from_config(cfg_cls()) is None


def test_retry_call_recovers_exhausts_and_fails_fast():
    """The port's retry policy against JAX's: recovery, typed exhaustion
    chained to the last error, non-retryable errors on their first
    attempt, the deadline."""
    for mod, rec_cls in (((RetryPolicy, ShardLoadError, retry_call), RetryRecorder),
                         ((jretry.RetryPolicy, jretry.ShardLoadError, jretry.retry_call),
                          JRetryRecorder)):
        policy_cls, load_err, call = mod
        rec, calls = rec_cls(), [0]

        def flaky():
            calls[0] += 1
            if calls[0] < 3:
                raise IOError("blip")
            return "ok"

        assert call(flaky, policy=policy_cls(max_attempts=5, base_delay_s=0.001), label="x",
                    recorder=rec) == "ok"
        assert rec.snapshot()["x"]["retries"] == 2 and rec.snapshot()["x"]["recovered"] == 1
        with pytest.raises(load_err, match="giving up after 3") as ei:
            call(lambda: (_ for _ in ()).throw(IOError("persistent")),
                 policy=policy_cls(max_attempts=3, base_delay_s=0.001), label="y",
                 recorder=rec, wrap=load_err)
        assert isinstance(ei.value.__cause__, IOError)
        assert rec.snapshot()["y"]["exhausted"] == 1 and not isinstance(load_err("x"), OSError)
        bugs = [0]

        def bug():
            bugs[0] += 1
            raise ValueError("deterministic bug")

        with pytest.raises(ValueError):
            call(bug, policy=policy_cls(max_attempts=5, base_delay_s=0.001))
        assert bugs[0] == 1
        t0 = time.monotonic()
        with pytest.raises(load_err, match="deadline passed"):
            call(lambda: (_ for _ in ()).throw(IOError("x")),
                 policy=policy_cls(max_attempts=10_000, base_delay_s=0.02, deadline_s=0.1),
                 wrap=load_err)
        assert time.monotonic() - t0 < 2.0


def test_step_watchdog_fires_once_and_respects_ticks():
    for cls in (StepWatchdog, JStepWatchdog):
        fired = []
        wd = cls("t", abort_s=0.1, on_stall=lambda idle, token: fired.append((idle, token)),
                 poll_s=0.01)
        try:
            wd.arm(token="phase-1")
            for _ in range(5):
                time.sleep(0.03)
                wd.tick()
            assert fired == []
            deadline = time.monotonic() + 5
            while not fired and time.monotonic() < deadline:
                time.sleep(0.01)
            time.sleep(0.15)
            assert len(fired) == 1 and fired[0][0] >= 0.1 and fired[0][1] == "phase-1"
            wd.disarm()
        finally:
            wd.close()


# ---------------------------------------------------------------------------
# The weight source
# ---------------------------------------------------------------------------

def _mk_source(model_dir, injector, attempts=2, prefetch=1):
    names = layer_names_for(N_LAYERS)
    return ShardWeightSource(model_dir, names, plan_shards_dp(len(names), 1).shards,
                             torch.float32, CPU, prefetch_depth=prefetch,
                             retry_policy=RetryPolicy(max_attempts=attempts, base_delay_s=0.001),
                             injector=injector, cycle=True)


def test_producer_survives_per_shard_failure(model_dir):
    """Exhaustion at shard 0 reaches the consumer typed and chained, and the
    producer goes on to the next shard (the serving engine's cycling
    source; a one-pass source ends at its consumer's failure)."""
    inj = FaultInjector(_chaos(error_rate=1.0, sites=("shard_read",), max_faults=2))
    src = _mk_source(model_dir, inj)
    try:
        with pytest.raises(ShardLoadError) as ei:
            next(iter(src))
        assert isinstance(ei.value.__cause__, InjectedFault)
        assert src._thread is not None and src._thread.is_alive()
        item = src._q.get(timeout=30)
        assert item[0] == src.shards[1] and item[1]
    finally:
        src.close()
    assert src._thread is None


def test_loader_absorbs_transient_faults(model_dir):
    """Flaky reads (errors and short reads) build the clean loader's host
    shard, with the JAX loader's retry count on the same schedule."""
    names = layer_names_for(N_LAYERS)
    idxs = tuple(range(len(names)))
    kw = dict(error_rate=0.4, truncate_rate=0.1, sites=("shard_read",))
    flaky = ShardWeightSource(model_dir, names, [], torch.float32, CPU, prefetch_depth=0,
                              retry_policy=RetryPolicy(max_attempts=10, base_delay_s=0.0),
                              injector=FaultInjector(_chaos(**kw)))
    clean = ShardWeightSource(model_dir, names, [], torch.float32, CPU, prefetch_depth=0)
    jrec = JRetryRecorder()
    jflaky = JHostShardLoader(model_dir, names, np.dtype(np.float32),
                              retry_policy=jretry.RetryPolicy(max_attempts=10, base_delay_s=0.0),
                              injector=jinject.FaultInjector(_chaos(False, **kw)),
                              retry_recorder=jrec)
    try:
        got, want = flaky.build_host_shard(idxs), clean.build_host_shard(idxs)
        jflaky.build_host_shard(idxs)
        assert [k for k, _ in got] == [k for k, _ in want]
        got_leaves, want_leaves = _tree_leaves([t for _, t in got]), _tree_leaves(
            [t for _, t in want])
        assert len(got_leaves) == len(want_leaves) > 0
        assert all(torch.equal(g, w) for g, w in zip(got_leaves, want_leaves))
        retries = flaky.retries.snapshot()["shard_read"]["retries"]
        assert retries == jrec.snapshot()["shard_read"]["retries"] > 0
    finally:
        flaky.close()
        clean.close()
        jflaky.close()


# ---------------------------------------------------------------------------
# The batch CLI under every loader, upload and spill site
# ---------------------------------------------------------------------------

SITE_CASES = {
    "shard_read": dict(error_rate=0.4, truncate_rate=0.1),
    "device_put": dict(error_rate=0.5),
    "host_oom": dict(error_rate=0.5),
    "corrupt_shard": dict(error_rate=0.5),
    "link_throttle": dict(error_rate=0.5),
    "disk_full": dict(error_rate=0.5),
    "corrupt_activation": dict(error_rate=0.5),
}
# A fixed schedule under which every site above injects; the budget stays
# under the read attempts, so no retry runs out.
SITE_SEED, SITE_BUDGET = 8, 6
SPILL_SITES = ("disk_full", "corrupt_activation")


@pytest.fixture(scope="module")
def clean_scores(model_dir):
    ex = orchestration.StreamingExecutor(_fw(model_dir), device=CPU, tokenizer=FakeTokenizer())
    return ex(list(PROMPTS))


@pytest.mark.parametrize("site", sorted(SITE_CASES))
def test_batch_cli_under_each_site_matches_jax(site, model_dir, tmp_path, clean_scores):
    """The port's batch CLI against the JAX executor under one chaos config:
    scores within 1e-5, the same retries, heals and faults, and the clean
    run's scores bit for bit."""
    rates = SITE_CASES[site]
    disk = site in SPILL_SITES
    kw = dict(sites=(site,), max_faults=SITE_BUDGET, **rates)
    ppkl, opkl = tmp_path / "p.pkl", tmp_path / "s.pkl"
    ppkl.write_bytes(pickle.dumps(PROMPTS))
    argv = ["--model_path", model_dir, "--prompt_pickle", str(ppkl), "--output_file", str(opkl),
            "--device", "cpu", "--dtype", "float32", "--bucket_multiple", "8", "--block_size", "2",
            "--prefetch_depth", "1", "--io_retry_attempts", "8", "--io_retry_base_s", "0.001",
            "--chaos", "--chaos_seed", str(SITE_SEED), "--chaos_sites", site,
            "--chaos_error_rate", str(rates["error_rate"]),
            "--chaos_truncate_rate", str(rates.get("truncate_rate", 0.0)),
            "--chaos_max_faults", str(SITE_BUDGET)]
    if disk:
        argv += ["--storage_location", "disk", "--disk_folder", str(tmp_path / "port")]
    stats = cli.main(argv, tokenizer=FakeTokenizer())
    scores = pickle.loads(opkl.read_bytes())
    jcfg = _fw(model_dir, False, prefetch_depth=1,
               faults=JFaultConfig(enabled=True, seed=SITE_SEED, **kw),
               **(dict(storage_location="disk", disk_folder=str(tmp_path / "jax")) if disk else {}))
    jex = JStreamingExecutor(jcfg, tokenizer=FakeTokenizer())
    jscores = jex(list(PROMPTS))
    for a, b, c in zip(scores, jscores, clean_scores):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(a, c)
    faults = stats["chaos_faults"]
    assert faults[site] == jex._injector.count(site) > 0
    assert sum(faults.values()) == faults[site]
    for key in ("io_retries", "reread_heals", "recomputes"):
        assert stats.get(key, 0.0) == jex.stats.get(key, 0.0), key
    if site in ("shard_read", "device_put", "host_oom", "corrupt_shard", "disk_full"):
        assert stats["io_retries"] > 0
    if site in ("corrupt_shard", "corrupt_activation"):
        assert stats["reread_heals"] > 0
    if site == "host_oom":
        assert pressure.process_events()["host_oom"] == faults[site]


def test_a_flipped_read_never_reaches_the_host_cache(model_dir, clean_scores):
    """corrupt_shard flips a bit before the crc check, so a flipped tree is
    re-read, never cached: with an explicit cache under chaos, the second
    call (every shard a cache hit) gives the clean scores too."""
    hostcache.reset_process_cache()
    cfg = _fw(model_dir, host_cache_gb=0.01,
              faults=FaultConfig(enabled=True, seed=SITE_SEED, error_rate=0.5,
                                 sites=("corrupt_shard",), max_faults=4))
    ex = orchestration.StreamingExecutor(cfg, device=CPU, tokenizer=FakeTokenizer())
    first = ex(list(PROMPTS))
    heals = ex.stats.get("reread_heals", 0)
    second = ex(list(PROMPTS))
    assert heals > 0 and ex.stats["host_cache_hit_rate"] == 1.0
    for a, b, c in zip(first, second, clean_scores):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)


@pytest.mark.parametrize("mode", ["mp", "dp"])
def test_mp_and_dp_under_shard_read_chaos_equal_their_clean_runs(mode, model_dir, clean_scores):
    """Two CPU stages (MP) and two CPU ranks (DP) under shard_read faults:
    the one-device clean scores bit for bit, the faults absorbed."""
    cfg = _fw(model_dir, data_parallel=mode == "dp", prefetch_depth=1,
              faults=_chaos(error_rate=0.3, sites=("shard_read",), max_faults=6))
    inject.reset_process_fault_counts()
    calls: list = []
    got = orchestration.run_prompts(cfg, list(PROMPTS), tokenizer=FakeTokenizer(),
                                    devices=[CPU, CPU], calls=calls)
    for a, b in zip(got, clean_scores):
        np.testing.assert_array_equal(a, b)
    assert inject.process_fault_counts()["shard_read"] > 0
    assert sum(c.get("io_retries", 0.0) for c in calls) > 0


# ---------------------------------------------------------------------------
# The serving engine and the queue
# ---------------------------------------------------------------------------

def _engine(model_dir, serve_kw=None, start=True, **fw_kw):
    return ServeEngine(_fw(model_dir, **fw_kw),
                       ServeConfig(**{"max_wave_requests": 2, "default_max_new_tokens": N_GEN,
                                      **(serve_kw or {})}),
                       tokenizer=FakeTokenizer(), device=CPU, start=start)


def test_serve_chaos_token_identical(model_dir, oracle):
    """shard_read faults while serving: every request completes with the JAX
    decode's tokens, the retries absorbed below the degrade path."""
    eng = _engine(model_dir, prefetch_depth=1, faults=_chaos(error_rate=0.2,
                                                               sites=("shard_read",)))
    try:
        results = [r.future.result(timeout=60) for r in [eng.submit(p, s) for p, s in PROMPTS]]
    finally:
        eng.shutdown(drain=True)
    assert eng.error is None
    for res, want in zip(results, oracle):
        _check(res, want)
    stats = eng.stats()
    assert stats["completed"] == len(PROMPTS)
    assert stats["io_retries"]["shard_read"]["retries"] > 0
    assert stats.get("engine_recoveries", 0) == 0


def test_serve_wave_recovery_and_source_restart(model_dir, oracle):
    """A persistent fault fails only the wave in flight (``WaveAborted``
    chained to the ``ShardLoadError``); the source restarts and the next
    request has the JAX decode's tokens."""
    eng = _engine(model_dir, prefetch_depth=1, io_retry_attempts=2,
                  faults=_chaos(error_rate=1.0, sites=("shard_read",), max_faults=2))
    try:
        doomed = eng.submit(*PROMPTS[0])
        with pytest.raises(WaveAborted) as ei:
            doomed.future.result(timeout=60)
        assert isinstance(ei.value.__cause__, ShardLoadError)
        assert doomed.status is RequestStatus.FAILED and eng.error is None
        _check(eng.submit(*PROMPTS[1]).future.result(timeout=60), oracle[1])
    finally:
        eng.shutdown(drain=True)
    stats = eng.stats()
    assert stats["engine_recoveries"] >= 1 and stats["source_restarts"] >= 1
    assert stats["waves_aborted"] >= 1 and stats["failed"] == 1 and stats["completed"] == 1


def test_engine_step_wave_recovery_keeps_tokens(model_dir, oracle):
    """An injected engine_step fault at the first shard step of the first
    sweep: the wave in flight fails (the fault its cause), its KV drops, and
    resubmitted requests (and the ones queued behind) get the JAX decode's
    tokens."""
    eng = _engine(model_dir, start=False, faults=_chaos(error_rate=1.0, sites=("engine_step",),
                                                        max_faults=1))
    try:
        reqs = [eng.submit(p, s) for p, s in PROMPTS]
        eng.start()
        outcomes = []
        for i, r in enumerate(reqs):
            try:
                outcomes.append((i, r.future.result(timeout=60)))
            except WaveAborted as e:
                assert isinstance(e.__cause__, InjectedFault) and "engine_step #0" in str(e)
                outcomes.append((i, eng.submit(*PROMPTS[i]).future.result(timeout=60)))
    finally:
        eng.shutdown(drain=True)
    assert eng.error is None
    for i, res in outcomes:
        _check(res, oracle[i])
    stats = eng.stats()
    assert eng._injector.count("engine_step") == 1
    assert stats["engine_recoveries"] == 1 and stats["waves_aborted"] == 1
    assert stats["failed"] == 2  # the first wave's two requests


def test_serve_watchdog_recovers_stalled_sweep(model_dir, oracle, monkeypatch):
    """A producer wedged in a build: the watchdog aborts the sweep, the wave
    fails promptly, the source restarts and the engine serves on."""
    stall = {"calls": 0, "lock": threading.Lock()}
    release = threading.Event()
    orig = ShardWeightSource.build_host_shard

    def wedged(self, layer_idxs):
        with stall["lock"]:
            stall["calls"] += 1
            n = stall["calls"]
        if n == 2:  # the first source's second shard hangs
            release.wait(timeout=30)
        return orig(self, layer_idxs)

    monkeypatch.setattr(ShardWeightSource, "build_host_shard", wedged)
    eng = _engine(model_dir, serve_kw=dict(watchdog_abort_s=0.5), prefetch_depth=1)
    try:
        with pytest.raises(WaveAborted):
            eng.submit(*PROMPTS[0]).future.result(timeout=60)
        release.set()
        assert eng.error is None
        _check(eng.submit(*PROMPTS[1]).future.result(timeout=60), oracle[1])
    finally:
        release.set()
        eng.shutdown(drain=True)
    stats = eng.stats()
    assert stats["watchdog_stalls"] >= 1 and stats["source_restarts"] >= 1
    assert stats["completed"] == 1


def test_queue_admission_site_rejects_with_reason():
    """An injected front-door fault resolves the request as a rejection
    carrying it (the JAX queue's outcome), and the next submit is clean."""
    out = []
    for port in (True, False):
        Q = AdmissionQueue if port else jqueue.AdmissionQueue
        R = Request if port else jrequest.Request
        inj = (inject if port else jinject).FaultInjector.from_config(
            _chaos(port, error_rate=1.0, sites=("queue_admission",), max_faults=1))
        q = Q(capacity=4, injector=inj)
        bad = q.submit(R(prefix="p", suffixes=("s",), max_new_tokens=1))
        with pytest.raises((inject if port else jinject).InjectedFault) as ei:
            bad.future.result(timeout=1)
        good = q.submit(R(prefix="p", suffixes=("s",), max_new_tokens=1))
        out.append((bad.status.value, str(ei.value), good.status.value, len(q)))
    assert out[0] == out[1] == ("rejected", "injected I/O error at queue_admission #0",
                                "queued", 1)


def test_serve_cli_jsonl_reply_carries_retry_after(model_dir, monkeypatch, capsys):
    """The JSONL frontend under a shed: the rejected line carries the
    Overloaded message and its retry_after_s."""
    real = ServeEngine.__init__

    def shedding_engine(self, *a, **kw):
        real(self, *a, **kw)
        self.queue.set_shedding(0.5)

    monkeypatch.setattr(ServeEngine, "__init__", shedding_engine)
    monkeypatch.setattr("sys.stdin", io.StringIO('{"id": "a", "prefix": "p", "suffixes": ["s"]}\n'))
    cli.main(["serve", "--model_path", model_dir, "--device", "cpu", "--dtype", "float32",
              "--bucket_multiple", "8", "--stats_interval_s", "0"], tokenizer=FakeTokenizer())
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")][0]
    reply = json.loads(line)
    assert reply["status"] == "rejected" and reply["retry_after_s"] == 0.5
    assert "retry after ~0.5s" in reply["error"] and reply["client_id"] == "a"


# ---------------------------------------------------------------------------
# Brownout: spec_backoff drives k to 0, release restores it
# ---------------------------------------------------------------------------

def test_pressure_event_backs_off_k_then_restores(model_dir, oracle):
    """The twin of the JAX spec test: a hard pressure event before the first
    wave serves it at k = 0 (no drafts, the plain sweep count); the release
    restores k and the next request drafts and saves sweeps. Every
    completion has the JAX decode's tokens. The draft model is the target's
    checkpoint, so every draft is accepted."""
    plain = _engine(model_dir, serve_kw=dict(max_wave_requests=1), start=False)
    try:
        req = plain.submit(*PROMPTS[0])
        plain.start()
        _check(req.future.result(timeout=60), oracle[0])
    finally:
        plain.shutdown(drain=True)
    plain_sweeps = plain.metrics.counter("sweeps")
    spec_kw = dict(max_wave_requests=1, speculative_k=2, spec_adaptive=True, spec_k_max=4,
                   spec_window=1, draft_model_path=model_dir)
    eng = _engine(model_dir, serve_kw=spec_kw, start=False,
                  pressure=PressureConfig(enabled=True, poll_s=30.0, step_down_polls=1))
    try:
        ctrl = eng._pressure
        assert ctrl is not None and ctrl is pressure.process_controller()
        first = eng.submit(*PROMPTS[0])
        ctrl.note_event("host_oom")
        ctrl.on_sample(PressureSnapshot())
        assert eng._spec_ctrl.stats()["backed_off"] == 1
        eng.start()
        first_res = first.future.result(timeout=60)
        backed_sweeps = eng.metrics.counter("sweeps")
        backed_spec = eng.metrics.spec_snapshot()
        for _ in range(len(ctrl.LADDER)):
            ctrl.on_sample(PressureSnapshot())
        assert ctrl.level == 0 and eng._spec_ctrl.stats()["backed_off"] == 0
        second_res = eng.submit(*PROMPTS[0]).future.result(timeout=60)
    finally:
        eng.shutdown(drain=True)
    assert eng.error is None
    _check(first_res, oracle[0])
    _check(second_res, oracle[0])
    assert backed_spec["drafted_tokens"] == 0 and backed_sweeps == plain_sweeps
    stats = eng.stats()
    assert stats["spec"]["accepted_tokens"] > 0
    assert eng.metrics.counter("sweeps") - backed_sweeps < plain_sweeps
    assert stats["spec_ctrl"]["pressure_backoffs"] == stats["spec_ctrl"]["pressure_restores"] == 1
    assert stats["pressure"]["spec_backoffs"] == stats["pressure"]["spec_restores"] == 1
