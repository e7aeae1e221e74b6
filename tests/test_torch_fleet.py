"""The port's replica fleet against the JAX package, on the CPU in float32
(the cases of ``tests/test_fleet.py`` and the fleet tests the serving
files deferred: ``tests/test_sched.py``'s shared rate limiter and phase
bias, ``tests/test_spec_serve.py``'s speculative replica kill,
``tests/test_wal.py``'s replay into a resized fleet).

- Units: the first-wins future, the router against JAX's ``Router`` on the
  same fakes and on seeded random snapshots (same pick, scores within
  1e-12), ``reclaim_inflight``, expired orphans, the health poll's drain.
- Fleets of 2 and 3 replicas on one tiny checkpoint (2 layers, hidden 64,
  the ``FakeTokenizer``), no chaos, under a seeded ``replica_kill`` and a
  ``replica_stall`` (``FLS_CHAOS_SEED``, default 1234), elastic join and
  leave, brownout drain and restore, the autoscaler's surface and a live
  staggered fleet: every request completes exactly once, its tokens those
  of one JAX ``DecodeGenerator`` call on the same checkpoint and prompts,
  its scores within rtol 1e-5, atol 1e-6. A one-replica fleet killed
  mid-decode counts only the resolved requests' tokens as served, and the
  fleet exposes the engine's ``kv_pool``, ``queue_depth`` and
  ``tokens_served``.
- The serve CLI: ``--replicas 3`` and ``--chaos --chaos_sites
  replica_kill`` through the demo frontend, the fleet and chaos flags
  parsed as the JAX CLI parses them, and the SIGKILL drill of a
  3-replica process replayed by a 2-replica one.
- The launch counters stay exact under 8 threads, and no serve sweep
  enters a CUDA graph capture.

Every wait in this file takes at most what is left of its time limit
(``FILE_LIMIT_S``), so a wedged thread fails a test instead of hanging it.
"""

import dataclasses
import io
import json
import os
import pickle
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from flexible_llm_sharding_tpu import cli as jcli
from flexible_llm_sharding_tpu.config import AutoscaleConfig as JAutoscaleConfig
from flexible_llm_sharding_tpu.config import FrameworkConfig as JFrameworkConfig
from flexible_llm_sharding_tpu.config import LlamaConfig as JLlamaConfig
from flexible_llm_sharding_tpu.config import ServeConfig as JServeConfig
from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu.runtime import kvpool as jkvpool
from flexible_llm_sharding_tpu.runtime.decode import DecodeGenerator as JDecodeGenerator
from flexible_llm_sharding_tpu.serve.router import Router as JRouter
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu_torch import cli
from flexible_llm_sharding_tpu_torch.config import (
    AutoscaleConfig,
    FaultConfig,
    FrameworkConfig,
    SchedConfig,
    ServeConfig,
)
from flexible_llm_sharding_tpu_torch.faults.retry import hash_unit
from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa
from flexible_llm_sharding_tpu_torch.runtime import kvpool
from flexible_llm_sharding_tpu_torch.serve import (
    ReplicaFleet,
    Router,
    ServeEngine,
    WaveAborted,
)
from flexible_llm_sharding_tpu_torch.serve.fleet import _Dispatch
from flexible_llm_sharding_tpu_torch.serve.request import (
    DeadlineExceeded,
    Request,
    RequestStatus,
    ServeFuture,
)
from flexible_llm_sharding_tpu_torch.serve.sched import RateLimited
from flexible_llm_sharding_tpu_torch.serve.wal import read_segment

from tests.fake_tokenizer import FakeTokenizer

CHAOS_SEED = int(os.environ.get("FLS_CHAOS_SEED", "1234"))
N_GEN = 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILE_LIMIT_S = 150.0
CPU = torch.device("cpu")

PROMPTS = [
    ("The capital of France", (" is Paris", " is Rome")),
    ("Two plus two equals", (" four", " five")),
    ("The sky is", (" blue", " green")),
    ("Hello world", (" again", " anew")),
    ("Water boils at", (" one hundred", " zero")),
    ("A stitch in time", (" saves nine", " is lost")),
]

_DEADLINE = [time.monotonic() + FILE_LIMIT_S]


@pytest.fixture(scope="module", autouse=True)
def _file_time_limit():
    _DEADLINE[0] = time.monotonic() + FILE_LIMIT_S
    yield


def _left() -> float:
    """Seconds left of this file's time limit (every wait takes at most this)."""
    left = _DEADLINE[0] - time.monotonic()
    if left <= 0:
        pytest.fail(f"test_torch_fleet.py ran past its {FILE_LIMIT_S} s limit")
    return left


@pytest.fixture(autouse=True)
def _fresh_pools():
    kvpool.reset_process_pools()
    jkvpool.reset_process_pools()
    yield
    kvpool.reset_process_pools()
    jkvpool.reset_process_pools()


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny llama (2 layers, hidden 64) saved by the JAX package."""
    d = tmp_path_factory.mktemp("fleet_model")
    cfg = JLlamaConfig.from_hf_config(dict(
        model_type="llama", vocab_size=256, hidden_size=64, intermediate_size=128,
        max_position_embeddings=512, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2))
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    jckpt.save_params(jax.tree.map(np.asarray, params), str(d), cfg)
    return str(d)


_FW = dict(layer_num_per_shard=1, storage_location="cpu", dtype="float32", bucket_multiple=8,
           block_size=2, prefetch_depth=0, num_gen_token=N_GEN, io_retry_attempts=8,
           io_retry_base_s=0.001)


@pytest.fixture(scope="module")
def oracle(model_dir, tmp_path_factory):
    """The JAX package's offline decode of PROMPTS: (scores, updated)."""
    jcfg = JFrameworkConfig(model_path=model_dir, disk_folder=str(tmp_path_factory.mktemp("o")),
                            **_FW)
    return JDecodeGenerator(jcfg, tokenizer=FakeTokenizer())(list(PROMPTS))


def _fw(model_dir, **kw) -> FrameworkConfig:
    return FrameworkConfig(model_path=model_dir, device="cpu", **{**_FW, **kw})


def _chaos(**kw) -> FaultConfig:
    return FaultConfig(enabled=True, seed=CHAOS_SEED, **kw)


def _serve_cfg(**kw) -> ServeConfig:
    base = dict(replicas=3, max_wave_requests=2, default_max_new_tokens=N_GEN,
                router_health_poll_s=0.05)
    base.update(kw)
    return ServeConfig(**base)


def _fleet(model_dir, serve_cfg, start=True, **fw) -> ReplicaFleet:
    return ReplicaFleet(_fw(model_dir, **fw), serve_cfg, tokenizer=FakeTokenizer(), device=CPU,
                        start=start)


def _same(res, scores, updated) -> None:
    assert res.updated == updated
    assert (res.tokens == scores.argmax(-1)).all()
    np.testing.assert_allclose(res.scores, scores, rtol=1e-5, atol=1e-6)


def _served(fleet, prompts, **kw):
    reqs = [fleet.submit(p, s, **kw) for p, s in prompts]
    return reqs, [r.future.result(timeout=_left()) for r in reqs]


def _until(cond) -> None:
    """Wait (within the file's limit) for the health monitor's next polls
    to make ``cond`` true: the requests of a tiny model can all resolve on
    survivors before the monitor has hard-failed the dead replica."""
    while not cond():
        _left()
        time.sleep(0.01)


# ---------------------------------------------------------------------------
# Units: the future's claim, the router, reclaim
# ---------------------------------------------------------------------------

def test_future_first_wins_and_callback_exactly_once():
    fired = []
    r = Request(prefix="p", suffixes=("s",), max_new_tokens=1,
                callback=lambda req: fired.append(req.status))
    r.fail(WaveAborted("first"), RequestStatus.FAILED)
    r.resolve(np.zeros((1, 1, 4)), ("p", ("s",)), np.zeros((1, 1), np.int64))
    r.fail(RuntimeError("second"), RequestStatus.CANCELLED)
    assert r.status is RequestStatus.FAILED
    assert fired == [RequestStatus.FAILED]
    with pytest.raises(WaveAborted, match="first"):
        r.future.result(timeout=1)
    f = ServeFuture()
    assert f.claim() and not f.claim()
    g = ServeFuture()
    assert g.claim()
    g.finish_error(RuntimeError("y"))
    assert not g.claim()
    assert isinstance(g.exception(timeout=0), RuntimeError)


class _FakeReplica:
    def __init__(self, idx, frac, depth, active, serving=True, max_active=8, hold=None):
        self.idx = idx
        self.serving = serving
        self._snap = {"boundary_frac": frac, "queue_depth": depth, "active": active,
                      "max_active": max_active}
        if hold is not None:
            self._snap["hold_frac"] = hold

    def snapshot(self):
        return self._snap


def _picks(router_cls, replicas, **kw):
    got = router_cls().pick(replicas, **kw)
    return None if got is None else got.idx


def test_router_scoring_phase_and_depth():
    idle = _FakeReplica(0, frac=0.0, depth=0, active=0)
    mid = _FakeReplica(1, frac=0.75, depth=0, active=0)
    deep = _FakeReplica(2, frac=0.0, depth=4, active=4)
    dead = _FakeReplica(3, frac=0.0, depth=0, active=0, serving=False)
    cases = [([mid, deep, idle, dead], {}, 0), ([mid, _FakeReplica(4, 0.25, 0, 0)], {}, 4),
             ([deep, mid], {}, 1), ([idle, mid], {"exclude": idle}, 1),
             ([idle], {"exclude": idle}, 0), ([dead], {}, None)]
    for reps, kw, want in cases:
        assert _picks(Router, reps, **kw) == want == _picks(JRouter, reps, **kw)
    with pytest.raises(ValueError):
        Router(phase_weight=-1)


def test_router_never_picks_engine_with_fatal_error():
    class _Eng:
        def __init__(self, error=None):
            self.error = error

    corpse = _FakeReplica(0, frac=0.0, depth=0, active=0)
    corpse.engine = _Eng(error=RuntimeError("killed"))
    live = _FakeReplica(1, frac=0.9, depth=4, active=4)
    live.engine = _Eng()
    for mod in (Router, JRouter):
        assert mod().pick([corpse, live]) is live
        assert mod().pick([corpse]) is None
        assert mod().pick([corpse], exclude=live) is None


@pytest.mark.parametrize("seed", range(4))
def test_router_matches_jax_on_seeded_snapshots(seed):
    """200 seeded fleets of 1-5 replicas (some draining, some holding),
    random weights and phase bias: the same pick as JAX's router, with the
    same excluded replica, and every score within 1e-12."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        n = int(rng.integers(1, 6))
        reps = [_FakeReplica(i, float(rng.random()), int(rng.integers(0, 9)),
                             int(rng.integers(0, 9)), serving=bool(rng.random() > 0.2),
                             max_active=int(rng.integers(1, 17)),
                             hold=float(rng.random()) if rng.random() > 0.5 else None)
                for i in range(n)]
        pw, dw, bias = float(rng.random() * 3), float(rng.random() * 3), float(1 + rng.random() * 3)
        exclude = reps[int(rng.integers(0, n))] if rng.random() > 0.5 else None
        ours, theirs = Router(pw, dw), JRouter(pw, dw)
        a = ours.pick(reps, exclude=exclude, phase_bias=bias)
        b = theirs.pick(reps, exclude=exclude, phase_bias=bias)
        assert a is b
        for r in reps:
            assert abs(ours.score(r.snapshot(), bias) - theirs.score(r.snapshot(), bias)) <= 1e-12


def test_router_phase_bias_prefers_boundary_proximity():
    near = _FakeReplica(0, 0.1, 8, 0)
    far = _FakeReplica(1, 0.9, 0, 0)
    for mod in (Router, JRouter):
        router = mod(phase_weight=1.0, depth_weight=1.0)
        assert router.pick([near, far]) is far
        assert router.pick([near, far], phase_bias=4.0) is near


def test_router_score_folds_pending_stagger_hold():
    held = _FakeReplica(0, frac=0.1, depth=0, active=0, hold=0.5)
    free = _FakeReplica(1, frac=0.1, depth=0, active=0)
    assert Router().pick([held, free]) is free
    assert Router().score(free.snapshot()) == pytest.approx(0.1)
    assert Router().score(held.snapshot()) == pytest.approx(0.6)


def test_reclaim_inflight_returns_orphans(model_dir):
    fired = []
    engine = ServeEngine(_fw(model_dir), _serve_cfg(replicas=1), tokenizer=FakeTokenizer(),
                         device=CPU, start=False)
    reqs = []
    for i, (p, s) in enumerate(PROMPTS[:2]):
        r = Request(prefix=p, suffixes=s, max_new_tokens=1, callback=fired.append,
                    dispatch_id=100 + i)
        engine.submit_request(r)
        reqs.append(r)
    orphans = engine.reclaim_inflight()
    assert orphans == reqs
    assert [o.dispatch_id for o in orphans] == [100, 101]
    assert [(o.prefix, o.suffixes) for o in orphans] == list(PROMPTS[:2])
    for o in orphans:
        assert o.status is RequestStatus.FAILED
        with pytest.raises(WaveAborted):
            o.future.result(timeout=1)
    assert fired == []
    assert engine.reclaim_inflight() == []
    engine.shutdown(drain=False)


def test_orphan_with_expired_deadline_resolves_expired(model_dir):
    fleet = _fleet(model_dir, _serve_cfg(replicas=1), start=False)
    try:
        req = fleet.submit(*PROMPTS[0], deadline_s=0.01)
        time.sleep(0.03)
        orphans = fleet._replicas[0].engine.reclaim_inflight()
        assert orphans == []
        assert req.status is RequestStatus.EXPIRED
        with pytest.raises(DeadlineExceeded):
            req.future.result(timeout=1)
        req2 = Request(prefix="p", suffixes=("s",), max_new_tokens=1,
                       deadline=time.monotonic() - 0.01)
        req2.dispatch_id = req2.request_id
        disp2 = _Dispatch(outer=req2, attempts=1)
        fleet._dispatches[req2.request_id] = disp2
        fleet._dispatch(disp2, redispatch=True)
        assert req2.status is RequestStatus.EXPIRED
        assert fleet.metrics.counter("expired_orphans") == 1
        assert fleet.metrics.counter("redispatches") == 0
    finally:
        fleet.shutdown(drain=False)


def test_poll_health_auto_drains_flaky_replica(model_dir):
    fleet = _fleet(model_dir, _serve_cfg(replicas=2, router_drain_recoveries=2), start=False)
    try:
        flaky = fleet._replicas[0]
        flaky.engine.metrics.count("engine_recoveries", 2)
        fleet._poll_health()
        assert flaky.state == "draining"
        assert fleet._replicas[1].state == "serving"
    finally:
        fleet.shutdown(drain=False)


# ---------------------------------------------------------------------------
# Fleets end to end, held to the JAX offline oracle
# ---------------------------------------------------------------------------

def test_fleet_parity_multi_replica(model_dir, oracle, tmp_path):
    """3 replicas, no chaos, with a WAL: every result the oracle's, the
    load spread, no re-dispatch; each admission record carries its fleet
    dispatch id."""
    off_scores, off_updated = oracle
    fleet = _fleet(model_dir, _serve_cfg(wal_dir=str(tmp_path / "wal")))
    try:
        reqs, results = _served(fleet, PROMPTS)
    finally:
        assert fleet.shutdown(drain=True, timeout=_left())
    assert fleet.error is None
    for res, want, upd in zip(results, off_scores, off_updated):
        _same(res, want, upd)
    snap = fleet.metrics.snapshot()
    assert snap["dispatches"] == len(PROMPTS) and snap["redispatches"] == 0
    stats = fleet.stats()
    assert stats["event"] == "fleet_stats"
    completed = [rep.get("completed", 0) for rep in stats["replicas"].values()]
    assert sum(completed) == len(PROMPTS) and all(c >= 1 for c in completed)
    admits = [rec for name in sorted(os.listdir(tmp_path / "wal")) if name.endswith(".log")
              for rec in read_segment(str(tmp_path / "wal" / name))[0] if rec["k"] == "admit"]
    assert sorted(a["dispatch_id"] for a in admits) == sorted(r.request_id for r in reqs)


def test_fleet_chaos_replica_kill_exactly_once(model_dir, oracle):
    """A seeded replica_kill takes one engine down mid-sweep: one callback
    per request, every request DONE with the oracle's tokens, and the dead
    replica re-dispatched from and recycled."""
    off_scores, off_updated = oracle
    fleet = _fleet(model_dir, _serve_cfg(),
                   faults=_chaos(error_rate=1.0, sites=("replica_kill",), max_faults=1))
    counts: dict[int, int] = {}
    lock = threading.Lock()

    def cb(req):
        with lock:
            counts[req.request_id] = counts.get(req.request_id, 0) + 1

    try:
        reqs, results = _served(fleet, PROMPTS, callback=cb)
        _until(lambda: fleet.metrics.counter("replicas_recycled") == 1)
    finally:
        assert fleet.shutdown(drain=True, timeout=_left())
    assert fleet.error is None
    assert sorted(counts) == sorted(r.request_id for r in reqs)
    assert set(counts.values()) == {1}
    assert all(r.status is RequestStatus.DONE for r in reqs)
    for res, want, upd in zip(results, off_scores, off_updated):
        _same(res, want, upd)
    snap = fleet.metrics.snapshot()
    assert snap["replicas_dead"] == 1 and snap["redispatches"] >= 1
    assert snap["replicas_recycled"] == 1 and snap["expired_orphans"] == 0
    stats = fleet.stats()
    assert sum(r.get("completed", 0) for part in ("replicas", "retired")
               for r in stats[part].values()) == len(PROMPTS)
    assert stats["tokens_served"] == len(PROMPTS) * N_GEN


def _seed_first_kill_at(n: int, rate: float = 0.05) -> int:
    """A chaos seed whose ``replica_kill`` schedule at ``rate`` fires first
    at draw ``n`` (0-based)."""
    for seed in range(100_000):
        units = [hash_unit(f"{seed}:replica_kill:{i}") for i in range(n + 1)]
        if min(units[:n], default=1.0) >= rate > units[n]:
            return seed
    raise AssertionError(f"no seed fires first at draw {n}")


def test_fleet_counts_served_tokens_not_abandoned_attempts(model_dir, oracle):
    """One replica killed mid-decode (the second shard step of its third
    sweep: its first wave two tokens in), its requests re-prefilled on the
    recycled slot: the engines' ``tokens_emitted`` then exceed what was
    served, while the fleet's ``tokens_served`` (and the engines' own) are
    exactly the tokens of the requests resolved."""
    off_scores, off_updated = oracle
    probe = ServeEngine(_fw(model_dir), _serve_cfg(replicas=1), tokenizer=FakeTokenizer(),
                        device=CPU, start=False)
    n_shards = len(probe.shards)
    probe.shutdown(drain=False)
    seed = _seed_first_kill_at(2 * n_shards + 1)
    # One replica: its thread makes every draw, so the kill's point is fixed.
    fleet = _fleet(model_dir, _serve_cfg(replicas=1),
                   faults=FaultConfig(enabled=True, seed=seed, error_rate=0.05,
                                      sites=("replica_kill",), max_faults=1))
    try:
        reqs, results = _served(fleet, PROMPTS)
        _until(lambda: fleet.metrics.counter("replicas_recycled") == 1)
    finally:
        assert fleet.shutdown(drain=True, timeout=_left())
    for res, want, upd in zip(results, off_scores, off_updated):
        _same(res, want, upd)
    stats = fleet.stats()
    engines = [r for part in ("replicas", "retired") for r in stats[part].values()]
    assert stats["router"]["replicas_dead"] == 1 and stats["router"]["redispatches"] >= 1
    assert stats["tokens_served"] == len(PROMPTS) * N_GEN
    assert sum(e["tokens_served"] for e in engines) == stats["tokens_served"]
    assert stats["retired"]["0"]["tokens_emitted"] >= 2
    assert sum(e["tokens_emitted"] for e in engines) > stats["tokens_served"]


def test_fleet_exposes_the_engine_surface(model_dir):
    """What the CLI and the WAL replay read of an engine, the fleet has:
    the process KV pool (any replica's: one per config), the queue depth
    (parked and queued) and ``tokens_served``."""
    engine = ServeEngine(_fw(model_dir), _serve_cfg(replicas=1), tokenizer=FakeTokenizer(),
                         device=CPU, start=False)
    fleet = _fleet(model_dir, _serve_cfg(replicas=2), start=False)
    try:
        assert engine.kv_pool is not None
        assert fleet.kv_pool is engine.kv_pool
        assert all(r.engine.kv_pool is engine.kv_pool for r in fleet._replicas)
        assert engine.queue_depth() == 0 and fleet.queue_depth() == 0
        engine.submit(*PROMPTS[0])
        for p, sfx in PROMPTS[:3]:
            fleet.submit(p, sfx)
        assert engine.queue_depth() == 1 and fleet.queue_depth() == 3
        assert engine.stats()["tokens_served"] == 0 and fleet.stats()["tokens_served"] == 0
    finally:
        engine.shutdown(drain=False)
        fleet.shutdown(drain=False, timeout=_left())


def test_fleet_chaos_replica_stall_liveness_failover(model_dir, oracle):
    """A wedged engine thread (replica_stall) is found by the watermark
    check, hard-failed and its requests re-dispatched; the released thread's
    late results lose the claim (``completed`` sums to the requests), and
    shutdown leaves no thread."""
    off_scores, off_updated = oracle
    fleet = _fleet(model_dir, _serve_cfg(replicas=2, watchdog_abort_s=2.0),
                   faults=_chaos(error_rate=1.0, sites=("replica_stall",), max_faults=1))
    try:
        reqs, results = _served(fleet, PROMPTS[:4])
        _until(lambda: fleet.metrics.counter("replicas_recycled") >= 1)
    finally:
        assert fleet.shutdown(drain=True, timeout=_left())
    for res, want, upd in zip(results, off_scores, off_updated):
        _same(res, want, upd)
    snap = fleet.metrics.snapshot()
    assert snap["replicas_dead"] >= 1 and snap["redispatches"] >= 1
    assert snap["replicas_recycled"] >= 1
    stats = fleet.stats()
    assert sum(rep.get("completed", 0) for rep in stats["replicas"].values()) == len(reqs)
    assert sum(rep.get("completed", 0) for rep in stats["retired"].values()) == 0
    assert stats["tokens_served"] == len(reqs) * N_GEN
    assert sum(rep["tokens_served"] for rep in stats["retired"].values()) == 0
    assert not [t for t in threading.enumerate() if t.name in ("serve-engine", "fleet-monitor")]


def test_fleet_elastic_add_remove(model_dir, oracle):
    off_scores, off_updated = oracle
    fleet = _fleet(model_dir, _serve_cfg(replicas=1))
    try:
        assert len(fleet.replicas) == 1
        new_idx = fleet.add_replica()
        assert len(fleet.replicas) == 2
        _, results = _served(fleet, PROMPTS[:4])
        for res, want, upd in zip(results, off_scores, off_updated):
            _same(res, want, upd)
        assert fleet.remove_replica(new_idx, drain=True, timeout=_left())
        assert len(fleet.replicas) == 1
        for key in ("replicas_added", "replicas_removed", "replicas_drained"):
            assert fleet.metrics.counter(key) == 1
        with pytest.raises(ValueError, match="last serving replica"):
            fleet.remove_replica(drain=True)
        _same(fleet.submit(*PROMPTS[0]).future.result(timeout=_left()), off_scores[0],
              off_updated[0])
    finally:
        assert fleet.shutdown(drain=True, timeout=_left())
    assert fleet.error is None


def test_fleet_hard_remove_redispatches(model_dir, oracle):
    off_scores, off_updated = oracle
    fleet = _fleet(model_dir, _serve_cfg(replicas=2, max_wave_requests=1, max_active_requests=1))
    try:
        reqs = [fleet.submit(p, s) for p, s in PROMPTS[:4]]
        victim = fleet.replicas[0]
        assert fleet.remove_replica(victim, drain=False)
        assert len(fleet.replicas) == 1
        for r, want, upd in zip(reqs, off_scores, off_updated):
            _same(r.future.result(timeout=_left()), want, upd)
        assert fleet.metrics.counter("replicas_removed") == 1
    finally:
        assert fleet.shutdown(drain=True, timeout=_left())


def test_pressure_restore_targets_autoscaler_population(model_dir):
    auto = AutoscaleConfig(enabled=True, min=1, max=4, stagger=False)
    fleet = _fleet(model_dir, _serve_cfg(replicas=2, autoscale=auto), start=False)
    try:
        assert fleet.population() == 2 and fleet.population_target() == 2
        fleet.add_replica()
        with fleet._autoscaler._lock:
            fleet._autoscaler.target = 3
        assert fleet.pressure_drain(keep=1) == 2
        for rep in list(fleet._replicas):
            if rep.state == "removing":
                fleet._complete_drain(rep)
        assert fleet.population() == 1
        assert fleet.pressure_restore() == 2
        assert fleet.population() == 3
    finally:
        fleet.shutdown(drain=False)


def test_pressure_restore_without_autoscaler_uses_config(model_dir):
    fleet = _fleet(model_dir, _serve_cfg(replicas=2), start=False)
    try:
        assert fleet.population_target() == 2
        assert fleet.pressure_drain(keep=1) == 1
        for rep in list(fleet._replicas):
            if rep.state == "removing":
                fleet._complete_drain(rep)
        assert fleet.pressure_restore() == 1
        assert fleet.population() == 2
    finally:
        fleet.shutdown(drain=False)


def test_fleet_autoscale_helpers_and_stats_surface(model_dir):
    auto = AutoscaleConfig(enabled=True, min=1, max=4)
    fleet = _fleet(model_dir, _serve_cfg(replicas=2, autoscale=auto), start=False)
    try:
        assert fleet.population() == 2 and fleet.drains_in_flight() == 0
        assert fleet.queue_frac() == 0.0 and len(fleet.serving_engines()) == 2
        fleet.mark_replay_complete()
        assert fleet._autoscaler.stats()["replay_pending"] == 0
        stats = fleet.stats()
        assert stats["autoscale"]["target_replicas"] == 2
        assert "stagger_error" in stats["stagger"]
        for rep in fleet._replicas:
            assert rep.snapshot()["hold_frac"] == 0.0
    finally:
        fleet.shutdown(drain=False)
    assert fleet.error is None


def test_fleet_builds_with_an_autoscale_floor_above_one(model_dir):
    """A fleet whose autoscale floor is 2 builds: its engines get their own
    ``replicas=1`` config without the autoscale band. The JAX fleet copies
    the band into each engine's config, whose validation then refuses it
    (a reference caveat, ROADMAP.md §3)."""
    sc = _serve_cfg(replicas=2, autoscale=AutoscaleConfig(enabled=True, min=2, max=3))
    fleet = _fleet(model_dir, sc, start=False)
    try:
        assert fleet.population() == 2 and fleet.population_target() == 2
    finally:
        fleet.shutdown(drain=False)
    jsc = JServeConfig(replicas=2, autoscale=JAutoscaleConfig(enabled=True, min=2, max=3))
    with pytest.raises(ValueError, match="autoscale"):
        dataclasses.replace(jsc, metrics_port=None, replicas=1)


def test_fleet_staggered_parity_live(model_dir, oracle):
    off_scores, off_updated = oracle
    auto = AutoscaleConfig(enabled=True, min=1, max=4, poll_s=0.05, confirm_polls=1000)
    fleet = _fleet(model_dir, _serve_cfg(replicas=2, autoscale=auto))
    try:
        _, results = _served(fleet, PROMPTS)
    finally:
        assert fleet.shutdown(drain=True, timeout=_left())
    assert fleet.error is None
    for res, want, upd in zip(results, off_scores, off_updated):
        _same(res, want, upd)
    stats = fleet.stats()
    assert stats["autoscale"]["polls"] >= 0
    assert 0.0 <= stats["stagger"]["stagger_error"] <= 1.0


def test_replicas_share_the_pool_under_concurrent_sweeps(model_dir, oracle):
    """The process prefix-KV pool under 3 replicas' concurrent sweeps, with
    the prompts submitted three times at once (one prefix prefilled on
    several replicas, later waves reusing sealed entries): every result the
    oracle's, and the pool's leases all released at the end."""
    off_scores, off_updated = oracle
    fleet = _fleet(model_dir, _serve_cfg(max_wave_requests=1))
    try:
        _, results = _served(fleet, PROMPTS * 3)
    finally:
        assert fleet.shutdown(drain=True, timeout=_left())
    for j, res in enumerate(results):
        _same(res, off_scores[j % len(PROMPTS)], off_updated[j % len(PROMPTS)])
    pools = kvpool._POOLS
    assert pools and all(node.refs == 0 for pool in pools.values()
                         for node in _walk(pool._root) if node is not pool._root)


def _walk(node):
    yield node
    for child in node.children.values():
        yield from _walk(child)


def test_fleet_shares_one_rate_limiter_across_replicas(model_dir):
    """Tenant rate limits are fleet-wide: burst 1 over two replicas admits
    one instant submit of three."""
    fleet = _fleet(model_dir, _serve_cfg(
        replicas=2, default_max_new_tokens=1,
        sched=SchedConfig(enabled=True, tenant_limits="m=1", tenant_burst=1.0)), start=False)
    try:
        reqs = [fleet.submit(*PROMPTS[0], tenant_id="m") for _ in range(3)]
        limited = [r for r in reqs if r.future.done()
                   and isinstance(r.future.exception(timeout=1), RateLimited)]
        assert len(limited) == 2
        assert fleet._sched.stats()["rate_limited"] == 2
        assert all(rep.engine._sched is fleet._sched for rep in fleet._replicas)
    finally:
        fleet.shutdown(drain=False, timeout=_left())


def test_spec_serve_fleet_replica_kill_token_identical(model_dir, oracle):
    """3 speculative replicas under a seeded replica_kill: the dead
    replica's requests re-dispatch once, every result the oracle's."""
    off_scores, off_updated = oracle
    fleet = _fleet(model_dir, _serve_cfg(speculative_k=4),
                   faults=_chaos(error_rate=1.0, sites=("replica_kill",), max_faults=1))
    try:
        reqs, results = _served(fleet, PROMPTS[:2])
        _until(lambda: fleet.metrics.counter("replicas_dead") == 1)
    finally:
        assert fleet.shutdown(drain=True, timeout=_left())
    assert fleet.error is None
    assert all(r.status is RequestStatus.DONE for r in reqs)
    for res, want, upd in zip(results, off_scores, off_updated):
        _same(res, want, upd)
    snap = fleet.metrics.snapshot()
    assert snap["replicas_dead"] == 1 and snap["redispatches"] >= 1


# ---------------------------------------------------------------------------
# The serve CLI
# ---------------------------------------------------------------------------

def _demo(model_dir, tmp_path, tag, extra, stagger_ms=20):
    ppkl = tmp_path / f"{tag}.pkl"
    ppkl.write_bytes(pickle.dumps(PROMPTS))
    out = tmp_path / f"{tag}_scores.pkl"
    stats = cli.main(["serve", "--model_path", model_dir, "--device", "cpu", "--prompt_pickle",
                      str(ppkl), "--output_file", str(out), "--dtype", "float32",
                      "--bucket_multiple", "8", "--block_size", "2", "--prefetch_depth", "0",
                      "--max_new_tokens", str(N_GEN), "--max_wave_requests", "2",
                      "--stats_interval_s", "0", "--router_health_poll_s", "0.05",
                      "--stagger_ms", str(stagger_ms), *extra], tokenizer=FakeTokenizer())
    scores = pickle.loads(out.read_bytes())
    updated = pickle.loads((tmp_path / f"{tag}_updated.pkl").read_bytes())
    return scores, updated, stats


@pytest.mark.parametrize("chaos", [False, True], ids=["clean", "replica_kill"])
def test_serve_cli_replicas_3_runs_the_fleet(model_dir, oracle, tmp_path, chaos):
    """``serve --replicas 3`` in demo mode (and with one seeded replica
    kill): the fleet's stats line, the oracle's scores and text."""
    off_scores, off_updated = oracle
    extra = ["--replicas", "3"]
    if chaos:
        extra += ["--chaos", "--chaos_error_rate", "1.0", "--chaos_sites", "replica_kill",
                  "--chaos_max_faults", "1", "--chaos_seed", str(CHAOS_SEED)]
    # Under chaos the submissions span several health polls (50 ms): the
    # monitor hard-fails and recycles the dead replica before the last
    # request resolves.
    scores, updated, stats = _demo(model_dir, tmp_path, "fleet", extra,
                                   stagger_ms=100 if chaos else 20)
    assert stats["event"] == "fleet_stats" and len(stats["replicas"]) == 3
    assert stats["router"]["dispatches"] == len(PROMPTS)
    assert stats["router"]["replicas_dead"] == (1 if chaos else 0)
    assert (stats["router"]["redispatches"] >= 1) == chaos
    assert sum(r.get("completed", 0) for part in ("replicas", "retired")
               for r in stats[part].values()) == len(PROMPTS)
    assert stats["tokens_served"] == len(PROMPTS) * N_GEN
    assert stats["tokens_per_sec"] == stats["tokens_served"] / stats["wall_s"]
    assert updated == list(off_updated)
    for got, want in zip(scores, off_scores):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


FLEET_FLAGS = [
    ["--replicas", "3"],
    ["--replicas", "0"],
    ["--router_phase_weight", "2.5"],
    ["--router_depth_weight", "0.5"],
    ["--router_depth_weight", "-1"],
    ["--router_health_poll_s", "0.05"],
    ["--router_drain_recoveries", "3"],
    ["--sched", "--sched_interactive_phase_boost", "4"],
    ["--sched", "--sched_interactive_phase_boost", "0.5"],
    ["--autoscale"],
    ["--autoscale", "--replicas", "2", "--autoscale_min", "2", "--autoscale_max", "3"],
    ["--autoscale", "--replicas", "5"],
    ["--autoscale", "--autoscale_poll_s", "0.5", "--autoscale_confirm_polls", "1"],
    ["--autoscale", "--autoscale_grow_burn_rate", "2", "--autoscale_shrink_burn_rate", "0.5"],
    ["--autoscale", "--autoscale_grow_queue_frac", "0.5", "--autoscale_shrink_queue_frac", "0.6"],
    ["--autoscale", "--autoscale_grow_cooldown_s", "1", "--autoscale_shrink_cooldown_s", "2"],
    ["--autoscale", "--autoscale_dry_run", "--autoscale_no_stagger"],
    ["--autoscale", "--autoscale_stagger_tolerance", "0.3"],
    ["--autoscale", "--autoscale_stagger_hold_max_frac", "1.5"],
    ["--autoscale_min", "3"],  # parsed, inert without --autoscale
    ["--chaos", "--chaos_sites", "replica_kill,replica_stall", "--chaos_seed", "7"],
    ["--chaos", "--chaos_error_rate", "0.5", "--chaos_truncate_rate", "0.2",
     "--chaos_latency_rate", "0.1", "--chaos_max_faults", "2"],
    ["--chaos", "--chaos_error_rate", "0.9", "--chaos_truncate_rate", "0.2"],
    ["--chaos_seed", "3"],  # parsed, inert without --chaos
]


def _fleet_fields(mod, serve_config, argv):
    """The fleet's part of the ServeConfig and the FaultConfig the serve
    parser ``mod`` builds from ``argv`` (or the ValueError's message)."""
    args = mod.build_serve_parser().parse_args(["--model_path", "/m", *argv])
    try:
        sched = mod._sched_config_from_args(args)
        auto = mod._autoscale_config_from_args(args)
        faults = mod._fault_config_from_args(args)
        serve = serve_config(replicas=args.replicas, router_phase_weight=args.router_phase_weight,
                             router_depth_weight=args.router_depth_weight,
                             router_health_poll_s=args.router_health_poll_s,
                             router_drain_recoveries=args.router_drain_recoveries,
                             sched=sched, autoscale=auto)
    except ValueError as e:
        return str(e)
    return ({f: getattr(serve, f) for f in ("replicas", "router_phase_weight",
                                            "router_depth_weight", "router_health_poll_s",
                                            "router_drain_recoveries")},
            sched.interactive_phase_boost, dataclasses.asdict(auto), dataclasses.asdict(faults),
            mod._serve_wants_fleet(serve))


@pytest.mark.parametrize("argv", FLEET_FLAGS, ids=[" ".join(a) for a in FLEET_FLAGS])
def test_fleet_and_chaos_flags_parse_as_jax(argv):
    assert _fleet_fields(cli, ServeConfig, argv) == _fleet_fields(jcli, JServeConfig, argv)


# ---------------------------------------------------------------------------
# Elasticity meets the WAL: a SIGKILLed 3-replica process, replayed by 2
# ---------------------------------------------------------------------------

_DRIVER = """
import os, sys
sys.path.insert(0, os.getcwd())
from tests.fake_tokenizer import FakeTokenizer
from flexible_llm_sharding_tpu_torch import cli

cli.main(["serve", *sys.argv[1:]], tokenizer=FakeTokenizer())
"""


def _wal_argv(model_dir, wal_dir, adapter_dir, extra=()):
    return ["--model_path", model_dir, "--wal_dir", wal_dir, "--adapter_dir", adapter_dir,
            "--device", "cpu", "--max_new_tokens", str(N_GEN), "--dtype", "float32",
            "--bucket_multiple", "8", "--block_size", "2", "--prefetch_depth", "0",
            "--max_wave_requests", "4", "--sched", "--stats_interval_s", "0",
            "--router_health_poll_s", "0.05", *extra]


def _done(text):
    out = {}
    for ln in text.splitlines():
        try:
            d = json.loads(ln)
        except ValueError:
            continue
        if d.get("status") == "done" and "client_id" in d:
            out[d["client_id"]] = d
    return out


def test_crash_drill_replay_into_resized_fleet(model_dir, oracle, tmp_path, monkeypatch,
                                               capsys):
    """SIGKILL a 3-replica serve process mid-sweep (``FLS_WAL_CRASH_SWEEPS``),
    restart over the same WAL with ``--replicas 2``: the replay owes the same
    requests whatever the topology, the merged replies carry the oracle's
    tokens and text, and the restarted fleet is 2 replicas that dispatched
    each replayed request once and none again."""
    off_scores, off_updated = oracle
    adapter_dir = str(tmp_path / "adapters_unused")
    os.makedirs(adapter_dir)
    lines = [{"id": f"r{i}", "prefix": p, "suffixes": list(s)}
             for i, (p, s) in enumerate(PROMPTS[:4])]
    wal_dir = str(tmp_path / "wal")
    env = {**os.environ, "FLS_WAL_CRASH_SWEEPS": "2"}
    proc = subprocess.run(
        [sys.executable, "-c", _DRIVER, *_wal_argv(model_dir, wal_dir, adapter_dir,
                                                    ("--replicas", "3"))],
        input="".join(json.dumps(d) + "\n" for d in lines), capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=_left())
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    crashed = _done(proc.stdout)
    assert len(crashed) < len(lines), "the drill came too late: nothing in flight"

    monkeypatch.delenv("FLS_WAL_CRASH_SWEEPS", raising=False)
    monkeypatch.setattr("sys.stdin", io.StringIO(""))
    capsys.readouterr()
    stats = cli.main(["serve", *_wal_argv(model_dir, wal_dir, adapter_dir, ("--replicas", "2"))],
                     tokenizer=FakeTokenizer())
    captured = capsys.readouterr()
    replayed = _done(captured.out)
    owed = {d["id"] for d in lines} - set(crashed)
    assert "wal replay:" in captured.err and set(replayed) >= owed
    merged = {**crashed, **replayed}
    for i, d in enumerate(lines):
        got = merged[d["id"]]
        assert got["updated_suffixes"] == list(off_updated[i][1]), d["id"]
        assert got["tokens"] == off_scores[i].argmax(-1).tolist(), d["id"]
    assert stats["event"] == "fleet_stats" and len(stats["replicas"]) == 2
    assert stats["router"]["dispatches"] == len(replayed)
    assert stats["router"]["redispatches"] == 0


# ---------------------------------------------------------------------------
# The card's shared state, checked on the CPU
# ---------------------------------------------------------------------------

def test_launch_counts_exact_under_8_threads():
    """8 threads, each counting 5000 launches of every wrapper through the
    counter the CUDA path calls, while each runs the plain path: the totals
    are exact."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(np.float32))
    vl = torch.tensor([8], dtype=torch.int32)
    fa.reset_launch_counts()
    start = threading.Barrier(8)

    def work():
        start.wait()
        for i in range(5000):
            for name in fa.KERNELS:
                fa._count(getattr(fa, name), i % 2, 0, (16, 16))
            if i % 1000 == 0:
                fa.flash_causal_attention(q, q, q, vl)  # CPU tensors: plain, not counted

    threads = [threading.Thread(target=work) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often: a lost update shows
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(_left())
    finally:
        sys.setswitchinterval(interval)
    try:
        assert not any(t.is_alive() for t in threads)
        assert fa.launch_counts() == dict.fromkeys(fa.KERNELS, 40000)
        assert fa.local_launch_counts() == dict.fromkeys(fa.KERNELS, 20000)
        assert fa.dim_launch_counts() == {k: {(16, 16): 40000} for k in fa.KERNELS}
    finally:
        fa.reset_launch_counts()


def test_fleet_sweeps_never_enter_a_graph_capture(model_dir, oracle, monkeypatch):
    """The serve sweep runs eager: a fleet of 2 serves every prompt with
    every graph-capture entry point of the port made to raise."""
    from flexible_llm_sharding_tpu_torch.runtime import decode

    def refuse(*a, **kw):
        raise AssertionError("a serve sweep entered a CUDA graph capture")

    monkeypatch.setattr(fa, "graph_capture", refuse)
    monkeypatch.setattr(torch.cuda, "graph", refuse)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    for name in dir(decode):
        if "graph" in name.lower() and callable(getattr(decode, name)):
            monkeypatch.setattr(decode, name, refuse)
    off_scores, off_updated = oracle
    fleet = _fleet(model_dir, _serve_cfg(replicas=2))
    try:
        _, results = _served(fleet, PROMPTS)
    finally:
        assert fleet.shutdown(drain=True, timeout=_left())
    for res, want, upd in zip(results, off_scores, off_updated):
        _same(res, want, upd)
