"""The port's crash-safe serving against the JAX package's, on the CPU in
float32 (the cases of ``tests/test_wal.py`` before its fleet test).

- The segment format: a WAL written by either package is read by the
  other's scan to the same folded entries; the terminal hook, torn tails,
  the fold's dedup and reopen, deadlines as seconds left, compaction, and
  the queue's write-ahead and persist close, each against JAX's.
- ``export_entry``/``restore_entry``: pages written by either pool restore
  in the other bit for bit; a corrupt page fails the restore closed.
- The engine's graceful restart: queued and in-flight requests parked, a
  second engine replays them; every result within 1e-5 of the JAX
  package's offline decode, tokens equal, the exported KV restored. And
  three starts over one WAL, the second stopped while a restored request
  is still queued: each export's pages stay its own.
- The drills through the serve CLI in a child process: SIGTERM (the
  handler parks and exits 143) and SIGKILL mid-sweep
  (``FLS_WAL_CRASH_SWEEPS``), each followed by a restart over the same WAL
  directory; the replies merged by client id equal an uninterrupted run's.
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from bench import BenchTokenizer
from flexible_llm_sharding_tpu.config import FrameworkConfig as JFrameworkConfig
from flexible_llm_sharding_tpu.config import LlamaConfig as JLlamaConfig
from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu.runtime import kvpool as jkvpool
from flexible_llm_sharding_tpu.runtime.decode import DecodeGenerator as JDecodeGenerator
from flexible_llm_sharding_tpu.serve import recovery as jrecovery
from flexible_llm_sharding_tpu.serve import request as jrequest
from flexible_llm_sharding_tpu.serve import wal as jwal
from flexible_llm_sharding_tpu.serve.queue import AdmissionQueue as JAdmissionQueue
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu.utils.metrics import ServingMetrics as JServingMetrics
from flexible_llm_sharding_tpu_torch import cli
from flexible_llm_sharding_tpu_torch.adapters import loader
from flexible_llm_sharding_tpu_torch.adapters.registry import save_adapter
from flexible_llm_sharding_tpu_torch.config import FrameworkConfig, SchedConfig, ServeConfig
from flexible_llm_sharding_tpu_torch.runtime import kvpool
from flexible_llm_sharding_tpu_torch.runtime.schedcore import SchedCore
from flexible_llm_sharding_tpu_torch.serve import (
    AdmissionQueue,
    Request,
    RequestStatus,
    RequestWAL,
    RestartPending,
    ServeEngine,
    recovery,
)
from flexible_llm_sharding_tpu_torch.serve.wal import fold_records, read_segment
from flexible_llm_sharding_tpu_torch.utils.metrics import ServingMetrics

ATOL = 1e-5
N_GEN = 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Vocab256(BenchTokenizer):
    VOCAB = 256


PROMPTS = [
    ("the cat sat on the mat and looked at the door", (" then left", " then slept")),
    ("two plus two equals", (" four", " five")),
    ("water boils at one hundred degrees", (" celsius", " kelvin")),
    ("hello world", (" again", " anew")),
]


@pytest.fixture(autouse=True)
def _fresh_state():
    for reset in (kvpool.reset_process_pools, jkvpool.reset_process_pools,
                  loader.reset_process_store):
        reset()
    yield
    for reset in (kvpool.reset_process_pools, jkvpool.reset_process_pools,
                  loader.reset_process_store):
        reset()


def _req(**kw):
    return Request(**{"prefix": "p", "suffixes": ("s",), "max_new_tokens": 4, **kw})


SIDES = {"port": (RequestWAL, Request, RestartPending, RequestStatus),
         "jax": (jwal.RequestWAL, jrequest.Request, jrequest.RestartPending,
                 jrequest.RequestStatus)}


def _entries_view(entries):
    return {w: (e.admit, e.emitted, e.tokens, e.kv, e.outcome) for w, e in entries.items()}


# ---------------------------------------------------------------------------
# The record format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_wal_roundtrip_terminal_hook_and_cross_read(writer, tmp_path):
    """Admit, progress and terminal records round-trip; the hook fired by
    resolve()/fail() writes the terminal, except RestartPending, which
    leaves the entry open. The other package's scan folds the segments to
    the same entries."""
    wal_cls, req_cls, restart_cls, status = SIDES[writer]
    d = str(tmp_path / "wal")
    wal = wal_cls(d)
    done, parked = req_cls(prefix="p", suffixes=("s",), max_new_tokens=4, client_id="c-1"), \
        req_cls(prefix="q", suffixes=("t", "u"), max_new_tokens=2, adapter_id="tenant-a")
    wal.admit(done)
    wal.admit(parked)
    done.tokens_emitted = 1
    wal.progress(done, tok_delta=[[5, 6]])
    assert done.resolve(np.zeros((1, 1, 2)), ("p", ["s"]), np.zeros((1, 1), np.int32))
    assert parked.fail(restart_cls("restarting"), status.CANCELLED)
    entries = wal.scan()
    assert not entries[done.wal_id].open and entries[done.wal_id].outcome == "done"
    assert entries[done.wal_id].tokens == [[5, 6]]
    assert entries[done.wal_id].admit["client_id"] == "c-1"
    assert entries[parked.wal_id].open and entries[parked.wal_id].admit["adapter"] == "tenant-a"
    st = wal.stats()
    assert st["records_written"] == 4 and st["open_requests"] == 1
    wal.close()
    other = (jwal.RequestWAL if writer == "port" else RequestWAL)(d)
    assert _entries_view(other.scan()) == _entries_view(entries)
    assert other.stats()["open_requests"] == 1
    other.close()


def test_torn_tail_truncated_mid_record_never_fatal(tmp_path):
    d = str(tmp_path / "wal")
    wal = RequestWAL(d)
    reqs = [_req() for _ in range(3)]
    for r in reqs:
        wal.admit(r)
    wal.close()
    (seg,) = [os.path.join(d, n) for n in os.listdir(d) if n.startswith("wal-")]
    _, valid, torn = read_segment(seg)
    assert not torn
    os.truncate(seg, valid - 7)
    assert jwal.read_segment(seg)[1:] == read_segment(seg)[1:]
    wal2 = RequestWAL(d)
    assert wal2.stats()["torn_tails"] == 1
    assert os.path.getsize(seg) < valid - 7
    assert set(wal2.scan()) == {reqs[0].wal_id, reqs[1].wal_id}
    records, _, torn = read_segment(seg)
    assert len(records) == 2 and not torn
    wal2.close()


def test_fold_dedup_reopen_and_stray_progress():
    recs = [
        {"k": "admit", "id": "a", "ts": 1.0, "prefix": "p1"},
        {"k": "progress", "id": "a", "emitted": 2},
        {"k": "terminal", "id": "a", "outcome": "done"},
        {"k": "admit", "id": "b", "ts": 2.0, "prefix": "p2"},
        {"k": "progress", "id": "a", "emitted": 3},
    ]
    for more in ([], [{"k": "admit", "id": "a", "ts": 3.0, "prefix": "p1"}]):
        entries = fold_records(recs + more)
        assert _entries_view(entries) == _entries_view(jwal.fold_records(recs + more))
    entries = fold_records(recs)
    assert not entries["a"].open and entries["a"].emitted == 2 and entries["b"].open
    entries = fold_records(recs + [{"k": "admit", "id": "a", "ts": 3.0, "prefix": "p1"}])
    assert entries["a"].open and entries["a"].emitted == 0


def test_replay_deadline_remaining_seconds_immune_to_clock_skew(tmp_path):
    wal = RequestWAL(str(tmp_path / "wal"))
    r = _req(deadline=time.monotonic() + 30.0)
    wal.admit(r)
    wal.close()
    entry = RequestWAL(str(tmp_path / "wal")).scan()[r.wal_id]
    left = entry.admit["deadline_left_s"]
    assert 29.0 < left <= 30.0
    entry.admit["ts"] -= 86400.0
    rebuilt = recovery.build_request(entry, now=1000.0)
    jrebuilt = jrecovery.build_request(entry, now=1000.0)
    assert rebuilt.deadline == pytest.approx(1000.0 + left) == jrebuilt.deadline
    assert rebuilt.wal_id == r.wal_id
    entry.emitted = 1
    assert recovery.build_request(entry, now=1000.0).deadline is None
    core = SchedCore()
    assert core.replay_deadline(None) is None
    assert core.replay_deadline(5.0, now=100.0) == 105.0
    assert core.replay_deadline(-3.0, now=100.0) == 100.0


def test_compaction_never_drops_nonterminal_record(tmp_path):
    outs = []
    for tag, (wal_cls, req_cls, _, _) in SIDES.items():
        d = str(tmp_path / tag)
        wal = wal_cls(d, max_segment_bytes=4096)
        survivor = req_cls(prefix="keepme", suffixes=("s",), max_new_tokens=4)
        wal.admit(survivor)
        for _ in range(60):
            r = req_cls(prefix="x" * 64, suffixes=("s",), max_new_tokens=4)
            wal.admit(r)
            wal.terminal(r, "done")
        st = wal.stats()
        assert st["rotations"] >= 2 and st["segments_compacted"] >= 1
        entries = wal.scan()
        assert entries[survivor.wal_id].open
        assert entries[survivor.wal_id].admit["prefix"] == "keepme"
        wal.terminal(survivor, "done")
        wal.flush()
        wal2 = wal_cls(d, max_segment_bytes=4096)
        wal2.maybe_compact()
        assert wal2.stats()["open_requests"] == 0
        assert all(not e.open for e in wal2.scan().values())
        outs.append((st["rotations"], st["segments_compacted"], st["segments"]))
        wal.close()
        wal2.close()
    assert outs[0] == outs[1]


def test_queue_writes_ahead_and_parks_on_persist_close(tmp_path):
    outs = []
    for tag, q_cls, m_cls in (("port", AdmissionQueue, ServingMetrics),
                              ("jax", JAdmissionQueue, JServingMetrics)):
        wal_cls, req_cls, restart_cls, status = SIDES[tag]
        wal = wal_cls(str(tmp_path / tag))
        q = q_cls(capacity=2, metrics=m_cls(), wal=wal)
        kept = [req_cls(prefix="p", suffixes=("s",), max_new_tokens=4) for _ in range(2)]
        for r in kept:
            assert q.submit(r).status is status.QUEUED
        rejected = q.submit(req_cls(prefix="p", suffixes=("s",), max_new_tokens=4))
        assert rejected.status is status.REJECTED
        q.close(drain=False, persist=True)
        for r in kept:
            assert r.status is status.CANCELLED
            with pytest.raises(restart_cls):
                r.future.result(timeout=1)
        entries = wal.scan()
        assert entries[rejected.wal_id].outcome == "rejected"
        assert {w for w, e in entries.items() if e.open} == {r.wal_id for r in kept}
        # Record sizes vary with the wall-clock "ts" field's digits.
        outs.append({k: v for k, v in wal.stats().items() if k != "bytes_written"})
        wal.close()
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# The pool's durable export and restore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kvpool_export_restore_across_packages(dtype, tmp_path):
    """Pages exported by either pool restore in the other (and in a fresh
    pool of its own) bit for bit and sealed; a corrupted page fails the
    restore closed, counted, and leaves nothing reusable."""
    rng = np.random.default_rng(7)
    k32 = rng.standard_normal((2, 16, 2, 4)).astype(np.float32)
    v32 = rng.standard_normal((2, 16, 2, 4)).astype(np.float32)
    kt, vt = torch.from_numpy(k32).to(getattr(torch, dtype)), torch.from_numpy(v32).to(
        getattr(torch, dtype))
    if dtype == "bfloat16":
        import ml_dtypes

        kj, vj = (t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16) for t in (kt, vt))
    else:
        kj, vj = k32, v32
    ids = tuple(range(10, 26))

    def pool(mod):
        return mod.KVPagePool(4, 1 << 30, spill_dir=str(tmp_path / "spill"), host_spill=True)

    def export(mod, k, v, where):
        p = pool(mod)
        h = p.acquire(ids, 16, 16, salt="tenant-a")
        p.contribute(h, (0, 0), k, v)
        p.contribute(h, (1, 0), k, v)
        p.seal(h)
        refs = p.export_entry(h, str(tmp_path / where), ids, salt="tenant-a")
        p.release(h)
        assert refs is not None and refs["dtype"] == dtype and p.stats()["entries_exported"] == 1
        assert json.loads(json.dumps(refs)) == refs
        return refs

    def restored(mod, refs):
        p = pool(mod)
        assert p.restore_entry(refs) and p.stats()["entries_restored"] == 1
        assert not p.acquire(ids, 16, 16).reusable  # another salt: another trie
        h = p.acquire(ids, 16, 16, salt="tenant-a")
        assert h.reusable
        return [p.assemble(h, seg) for seg in ((0, 0), (1, 0))]

    p_refs = export(kvpool, kt, vt, "port")
    j_refs = export(jkvpool, kj, vj, "jax")
    for refs in (p_refs, j_refs):
        for k, v in restored(kvpool, refs):
            assert torch.equal(k, kt) and torch.equal(v, vt)
        for k, v in restored(jkvpool, refs):
            assert (np.asarray(k) == kj).all() and (np.asarray(v) == vj).all()
    # Pages that do not hold the refs' positions (another entry's) fail too.
    short = dict(p_refs, prefix_ids=p_refs["prefix_ids"][:8], prefix_len=8, lp_bucket=8)
    broken = pool(kvpool)
    assert not broken.restore_entry(short) and broken.stats()["restore_failures"] == 1
    with open(p_refs["segs"][1][1], "r+b") as f:
        f.seek(128)
        f.write(b"\xff" * 8)
    for mod in (kvpool, jkvpool):
        broken = pool(mod)
        assert not broken.restore_entry(p_refs)
        assert broken.stats()["restore_failures"] == 1
        assert not broken.acquire(ids, 16, 16, salt="tenant-a").reusable


# ---------------------------------------------------------------------------
# The engine's graceful restart, and the drills through the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("wal_model")
    cfg = JLlamaConfig.from_hf_config(dict(
        model_type="llama", vocab_size=256, hidden_size=64, intermediate_size=128,
        max_position_embeddings=512, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2))
    params = jllama.init_params(jax.random.PRNGKey(9), cfg)
    jckpt.save_params(jax.tree.map(np.asarray, params), str(d), cfg)
    return str(d)


@pytest.fixture(scope="module")
def offline(model_dir, tmp_path_factory):
    """The JAX package's offline ``--kv_cache`` decode of PROMPTS."""
    jcfg = JFrameworkConfig(model_path=model_dir, dtype="float32", bucket_multiple=8,
                            block_size=2, prefetch_depth=0, num_gen_token=N_GEN,
                            disk_folder=str(tmp_path_factory.mktemp("off")))
    return JDecodeGenerator(jcfg, tokenizer=_Vocab256())(list(PROMPTS))


def test_graceful_restart_replays_within_1e5_of_jax(model_dir, offline, tmp_path):
    """``shutdown_for_restart`` once the first wave has prefilled parks the
    queued and in-flight requests; a second engine over the same WAL
    replays them, restoring the exported prefix KV, and every merged result
    is within 1e-5 of the JAX offline decode with its tokens."""
    off_scores, off_updated = offline
    cfg = FrameworkConfig(model_path=model_dir, dtype="float32", bucket_multiple=8,
                          block_size=2, prefetch_depth=0, device="cpu",
                          disk_folder=str(tmp_path / "d"))
    serve_cfg = ServeConfig(max_wave_requests=2, max_active_requests=2,
                            default_max_new_tokens=N_GEN, wal_dir=str(tmp_path / "wal"))
    engine = ServeEngine(cfg, serve_cfg, tokenizer=_Vocab256(), device=torch.device("cpu"),
                         start=False)
    # Held after its first prefill until the restart: a loaded host could
    # otherwise finish the first wave and park only unprefilled requests,
    # leaving no KV to export (F9).
    _hold_after_first_prefill(engine)
    reqs = [engine.submit(p, s, client_id=i) for i, (p, s) in enumerate(PROMPTS)]
    engine.start()
    deadline = time.monotonic() + 60
    while engine.metrics.counter("prefills") < 1:
        assert time.monotonic() < deadline, "the first wave never prefilled"
        time.sleep(0.005)
    assert engine.shutdown_for_restart(timeout=60) and engine.error is None
    results = {}
    for r in reqs:
        if r.status is RequestStatus.DONE:
            results[r.client_id] = r.future.result(timeout=1)
        else:
            with pytest.raises(RestartPending):
                r.future.result(timeout=1)
    engine._wal.close()
    kvpool.reset_process_pools()  # a new process: the pool starts empty

    engine2 = ServeEngine(cfg, serve_cfg, tokenizer=_Vocab256(), device=torch.device("cpu"))
    try:
        summary = recovery.replay(engine2, engine2._wal)
        assert summary["replayed"] == len(PROMPTS) - len(results) >= 1
        assert summary["skipped_terminal"] == len(results)
        assert summary["kv_restored"] >= 1 and summary["kv_failed"] == 0
        for rr in summary["requests"]:
            results[rr.client_id] = rr.future.result(timeout=60)
        assert engine2.drain(timeout=60)
    finally:
        engine2.shutdown(drain=False)
    assert engine2.error is None
    assert engine2.stats()["kvpool"]["prefix_reuse_hits"] >= 1
    for i in range(len(PROMPTS)):
        assert results[i].updated == off_updated[i]
        np.testing.assert_allclose(results[i].scores, off_scores[i], atol=ATOL, rtol=0)
    assert engine2._wal.stats()["open_requests"] == 0


def _hold_after_first_prefill(engine):
    """Keep the engine's loop at the end of its first prefill sweep until
    ``shutdown_for_restart`` is called, so what is in flight and what is
    queued at the restart is fixed, not raced."""
    real = engine._post_sweep

    def post_sweep(wall):
        real(wall)
        deadline = time.monotonic() + 60
        while (engine.metrics.counter("prefills") >= 1 and not engine._restart_pending
               and time.monotonic() < deadline):
            time.sleep(0.002)

    engine._post_sweep = post_sweep


def _hold_admission(engine) -> threading.Event:
    """Keep the engine's loop from admitting a wave until the returned event
    is set: ``recovery.replay`` submits one request at a time into a running
    loop, so without the hold the loop may prefill the first replayed
    request before a later, higher-priority one is queued."""
    gate = threading.Event()
    real = engine.batcher.admit_at_boundary

    def admit():
        gate.wait(timeout=60)
        return real()

    engine.batcher.admit_at_boundary = admit
    return gate


def _wait_prefilled(engine):
    deadline = time.monotonic() + 60
    while engine.metrics.counter("prefills") < 1:
        assert time.monotonic() < deadline and engine.error is None, "no prefill"
        time.sleep(0.002)


def test_second_restart_keeps_each_requests_exported_kv(model_dir, offline, tmp_path):
    """Three starts over one WAL. The first exports the KV of request 2 (in
    flight) and parks the rest. The second restores it, but the scheduler
    serves the interactive request 1 first, so a second restart exports
    request 1's KV while request 2 is still queued and keeps its first
    refs. Each export's files are its own: the third start restores request
    2's KV, not request 1's (their prefixes share a bucket, so a file name
    reused across starts would pass the checksum and serve request 1's KV
    under request 2's ids). Every result is within 1e-5 of the JAX offline
    decode, with its tokens."""
    off_scores, off_updated = offline
    cfg = FrameworkConfig(model_path=model_dir, dtype="float32", bucket_multiple=8,
                          block_size=2, prefetch_depth=0, device="cpu",
                          disk_folder=str(tmp_path / "d"))
    serve_cfg = ServeConfig(max_wave_requests=1, max_active_requests=1,
                            default_max_new_tokens=N_GEN, wal_dir=str(tmp_path / "wal"),
                            sched=SchedConfig(enabled=True, preempt=False))
    slo = {1: "interactive"}

    def engine(start=True):
        e = ServeEngine(cfg, serve_cfg, tokenizer=_Vocab256(), device=torch.device("cpu"),
                        start=start)
        _hold_after_first_prefill(e)
        return e

    first = engine()
    first.submit(*PROMPTS[2], client_id=2)
    _wait_prefilled(first)
    for i in (0, 1, 3):
        first.submit(*PROMPTS[i], client_id=i, slo_class=slo.get(i))
    assert first.shutdown_for_restart(timeout=60) and first.error is None
    assert first._kv_pool.stats()["entries_exported"] == 1
    first._wal.close()
    kvpool.reset_process_pools()

    second = engine(start=False)
    admitting = _hold_admission(second)
    second.start()  # the replay below submits into a running loop
    try:
        summary = recovery.replay(second, second._wal)
    finally:
        admitting.set()
    assert summary["replayed"] == len(PROMPTS) and summary["kv_restored"] == 1
    _wait_prefilled(second)
    assert second.shutdown_for_restart(timeout=60) and second.error is None
    assert second._kv_pool.stats()["entries_exported"] == 1
    in_flight = [r.client_id for r in summary["requests"] if r.status is not RequestStatus.DONE
                 and r.tokens_emitted > 0]
    assert in_flight == [1], in_flight
    second._wal.close()
    kvpool.reset_process_pools()

    third = ServeEngine(cfg, serve_cfg, tokenizer=_Vocab256(), device=torch.device("cpu"))
    try:
        summary = recovery.replay(third, third._wal)
        assert summary["replayed"] == len(PROMPTS)
        assert summary["kv_restored"] == 2 and summary["kv_failed"] == 0
        results = {r.client_id: r.future.result(timeout=60) for r in summary["requests"]}
        assert third.drain(timeout=60)
    finally:
        third.shutdown(drain=False)
    assert third.error is None
    for i in range(len(PROMPTS)):
        assert results[i].updated == off_updated[i], i
        np.testing.assert_allclose(results[i].scores, off_scores[i], atol=ATOL, rtol=0)


_DRIVER = """
import os, sys, time
sys.path.insert(0, os.getcwd())
from bench import BenchTokenizer
from flexible_llm_sharding_tpu_torch import cli
from flexible_llm_sharding_tpu_torch.serve import engine

class V(BenchTokenizer):
    VOCAB = 256

if os.environ.get("DRILL_SIGTERM_AFTER_PREFILLS"):
    # A graceful restart once that many waves have prefilled: the CLI's
    # SIGTERM handler parks everything in flight and exits 143.
    n = int(os.environ["DRILL_SIGTERM_AFTER_PREFILLS"])
    real = engine.ServeEngine._post_sweep

    def post_sweep(self, wall):
        real(self, wall)
        if self.metrics.counter("prefills") >= n:
            os.kill(os.getpid(), 15)
            time.sleep(0.5)

    engine.ServeEngine._post_sweep = post_sweep
cli.main(["serve", *sys.argv[1:]], tokenizer=V())
"""


def _serve_argv(model_dir, wal_dir, adapter_dir):
    return ["--model_path", model_dir, "--wal_dir", wal_dir, "--adapter_dir", adapter_dir,
            "--device", "cpu", "--max_new_tokens", str(N_GEN), "--dtype", "float32",
            "--bucket_multiple", "8", "--block_size", "2", "--prefetch_depth", "0",
            "--max_wave_requests", "2", "--max_active_requests", "2", "--sched",
            "--stats_interval_s", "0"]


def _done_replies(text):
    out = {}
    for ln in text.splitlines():
        try:
            d = json.loads(ln)
        except ValueError:
            continue
        if d.get("status") == "done" and "client_id" in d:
            out[d["client_id"]] = d
    return out


def _in_process(argv, lines, monkeypatch, capsys):
    monkeypatch.setattr("sys.stdin", io.StringIO("".join(json.dumps(d) + "\n" for d in lines)))
    capsys.readouterr()
    cli.main(["serve", *argv], tokenizer=_Vocab256())
    captured = capsys.readouterr()
    return _done_replies(captured.out), captured.err


@pytest.fixture(scope="module")
def drill_adapter(tmp_path_factory):
    rng = np.random.default_rng(11)
    root = str(tmp_path_factory.mktemp("drill_adapters"))
    save_adapter(root, "tenant-a", {
        f"model.layers.{i}": ((0.05 * rng.standard_normal((64, 2))).astype(np.float32),
                              (0.05 * rng.standard_normal((2, 64))).astype(np.float32))
        for i in range(2)})
    return root


DRILL_LINES = [
    # Two requests of one prefix, coalesced into one prefill.
    {"id": "c0", "prefix": PROMPTS[0][0], "suffixes": list(PROMPTS[0][1])},
    {"id": "c1", "prefix": PROMPTS[0][0], "suffixes": [" then ran"]},
    {"id": "c2", "prefix": PROMPTS[1][0], "suffixes": list(PROMPTS[1][1]),
     "adapter_id": "tenant-a"},
    {"id": "c3", "prefix": PROMPTS[2][0], "suffixes": list(PROMPTS[2][1])},
    {"id": "c4", "prefix": PROMPTS[3][0], "suffixes": list(PROMPTS[3][1])},
]


@pytest.mark.parametrize("drill", ["sigterm", "sigkill"])
def test_drill_then_restart_merges_token_identically(drill, model_dir, drill_adapter, tmp_path,
                                                     monkeypatch, capsys):
    """The serve CLI in a child process, stopped by SIGTERM once its first
    wave prefilled (the handler parks the rest, exit 143) or killed by
    SIGKILL mid-sweep after 2 sweeps, then restarted in this process over
    the same WAL with no new request: the replay serves every owed request,
    and the replies merged by client id equal an uninterrupted run's
    tokens and text, a LoRA tenant and a coalesced prefix among them."""
    oracle, _ = _in_process(_serve_argv(model_dir, str(tmp_path / "wal_oracle"), drill_adapter),
                            DRILL_LINES, monkeypatch, capsys)
    assert set(oracle) == {d["id"] for d in DRILL_LINES}
    wal_dir = str(tmp_path / "wal")
    env = {k: v for k, v in os.environ.items() if k != "FLS_WAL_CRASH_SWEEPS"}
    if drill == "sigkill":
        env["FLS_WAL_CRASH_SWEEPS"] = "2"
    else:
        env["DRILL_SIGTERM_AFTER_PREFILLS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-c", _DRIVER, *_serve_argv(model_dir, wal_dir, drill_adapter)],
        input="".join(json.dumps(d) + "\n" for d in DRILL_LINES), capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=300)
    want_rc = -signal.SIGKILL if drill == "sigkill" else 143
    assert proc.returncode == want_rc, proc.stderr[-2000:]
    crashed = _done_replies(proc.stdout)
    assert len(crashed) < len(DRILL_LINES), "the drill came too late: nothing in flight"
    kvpool.reset_process_pools()
    replayed, err = _in_process(_serve_argv(model_dir, wal_dir, drill_adapter), [], monkeypatch,
                                capsys)
    assert "wal replay:" in err
    assert set(replayed) >= {d["id"] for d in DRILL_LINES} - set(crashed)
    merged = {**crashed, **replayed}
    for d in DRILL_LINES:
        cid = d["id"]
        assert merged[cid]["tokens"] == oracle[cid]["tokens"], cid
        assert merged[cid]["updated_suffixes"] == oracle[cid]["updated_suffixes"], cid
    if drill == "sigterm":
        assert "kv restored 0 " not in err  # the parked prefixes came back
