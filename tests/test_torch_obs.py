"""The port's observability (``obs/``) against the JAX package's, on the CPU
at the tiny float32 llama's widths.

- The span tracer's ring, drops and exports, the metrics registry and its
  endpoint, the registry-backed serve stats line, the watchdog's stall
  instant and the trace analyzer: each case of the JAX package's
  ``tests/test_obs.py`` on the port's modules.
- The analyzer and its rendering on one synthetic event list: equal to
  JAX's, exactly.
- A traced batch CLI run (scoring, and a streamed ``--kv_cache`` decode):
  the ordered span names, categories and attributes equal JAX's, sweep ids
  taken relative and times left out.
- A traced serve run: the wave lifecycle's instants and spans equal JAX's,
  wave and request ids taken relative; the engines are built unstarted and
  started once every request is queued, so both admit one wave.
- Each traced run is made once per module (``cli_runs``, ``serve_run``)
  and read by every test that checks it; the checkpoint is drawn with numpy
  (``seeded_checkpoint``).
- The scheduler's and speculation's instants (``tenant_throttle``,
  ``prefix_coalesce``, ``spec_draft``, ``spec_verify``) against JAX's, and a
  preemption's ``wave_preempt`` instant and journal event.
- The scoring run's ``--metrics_out``: the registry's sources and
  Prometheus families equal JAX's, but for the ones listed with their
  reasons.
"""

import json
import os
import pickle
import socket
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from flexible_llm_sharding_tpu import cli as jcli
from flexible_llm_sharding_tpu.config import FrameworkConfig as JFrameworkConfig
from flexible_llm_sharding_tpu.config import SchedConfig as JSchedConfig
from flexible_llm_sharding_tpu.config import ServeConfig as JServeConfig
from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu.obs import report as jreport
from flexible_llm_sharding_tpu.obs import trace as jtrace
from flexible_llm_sharding_tpu.runtime import hostcache as jhostcache
from flexible_llm_sharding_tpu.runtime import kvpool as jkvpool
from flexible_llm_sharding_tpu.serve import ServeEngine as JServeEngine
from flexible_llm_sharding_tpu.serve import queue as jqueue
from flexible_llm_sharding_tpu.serve import request as jrequest
from flexible_llm_sharding_tpu.serve.sched import SweepScheduler as JSweepScheduler
from flexible_llm_sharding_tpu.utils.checkpoint import save_params
from flexible_llm_sharding_tpu_torch import cli
from flexible_llm_sharding_tpu_torch.config import FrameworkConfig, SchedConfig, ServeConfig
from flexible_llm_sharding_tpu_torch.obs import report as obs_report
from flexible_llm_sharding_tpu_torch.obs import trace as obs_trace
from flexible_llm_sharding_tpu_torch.obs.registry import (
    REGISTRY,
    MetricsRegistry,
    MetricsServer,
    weak_source,
)
from flexible_llm_sharding_tpu_torch.obs.trace import Tracer
from flexible_llm_sharding_tpu_torch.runtime import hostcache, kvpool
from flexible_llm_sharding_tpu_torch.serve import ReplicaFleet, ServeEngine, queue, request
from flexible_llm_sharding_tpu_torch.serve.sched import SweepScheduler
from flexible_llm_sharding_tpu_torch.utils.metrics import (
    ServingMetrics,
    StepWatchdog,
    assemble_serve_stats,
)
from tests.fake_tokenizer import FakeTokenizer

PROMPTS = [
    ("The capital of France", (" is Paris", " is Rome")),
    ("Two plus two equals", (" four", " five")),
]
# Keys of a span that differ between two runs by nature (times, threads,
# measured latencies).
_VOLATILE = ("ts_s", "dur_s", "tid", "seconds")


def _tok():
    # Ids stay below the tiny model's vocabulary (torch does not clamp).
    return FakeTokenizer(vocab_size=256)


def seeded_checkpoint(cfg, path: str, seed: int = 0) -> str:
    """A native checkpoint of ``jllama.init_params``' tree, drawn with numpy
    from ``seed`` at its scales (no XLA compile): projections at
    ``sqrt(2 / (fan_in + fan_out))``, the embedding, the head and biases at
    0.02, norms at one."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jllama.init_params(k, cfg), jax.random.PRNGKey(seed))

    def draw(keypath, leaf):
        names = [str(getattr(k, "key", "")) for k in keypath]
        if names[-1] == "scale" or names[-1].endswith("_norm"):
            return np.ones(leaf.shape, np.float32)
        if len(leaf.shape) == 2 and names[0] not in ("embed", "lm_head"):
            std = (2.0 / sum(leaf.shape)) ** 0.5
        else:
            std = 0.02
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    save_params(jax.tree_util.tree_map_with_path(draw, shapes), path, cfg)
    return path


@pytest.fixture(scope="module")
def model(tiny_cfg, tmp_path_factory):
    return seeded_checkpoint(tiny_cfg, str(tmp_path_factory.mktemp("tiny_model_torch_obs")))


def _kw(model_dir, **kw):
    base = dict(model_path=model_dir, layer_num_per_shard=1, storage_location="cpu",
                dtype="float32", bucket_multiple=8, block_size=2, prefetch_depth=0)
    base.update(kw)
    return base


def _fw(model_dir, **kw):
    return FrameworkConfig(**_kw(model_dir, **kw), device="cpu")


def _jfw(model_dir, **kw):
    return JFrameworkConfig(**_kw(model_dir, **kw))


@pytest.fixture()
def process_tracer():
    """The port's process tracer, enabled for one test and cleared after."""
    t = obs_trace.TRACER
    t.clear()
    t.enable()
    yield t
    t.disable()
    t.clear()


@pytest.fixture()
def both_tracers():
    """Both packages' process tracers, enabled and cleared, with fresh host
    caches and pools (a warm cache would turn misses into hits)."""
    tracers = (obs_trace.TRACER, jtrace.TRACER)
    for t in tracers:
        t.clear()
        t.enable()
    _reset_caches()
    yield tracers
    for t in tracers:
        t.disable()
        t.clear()
    for reset in (kvpool.reset_process_pools, jkvpool.reset_process_pools):
        reset()


def _reset_caches():
    for reset in (hostcache.reset_process_cache, jhostcache.reset_process_cache,
                  kvpool.reset_process_pools, jkvpool.reset_process_pools):
        reset()


# The batch CLI's flags per traced mode. prefetch_depth 0 keeps the
# producer's spans in one order; the KV decode streams its weights every
# step (per-step passes).
_CLI_MODES = {
    "scoring": [],
    "kv_cache": ["--kv_cache", "true", "--num_gen_token", "3", "--decode_resident", "off",
                 "--decode_fused", "off"],
}


@pytest.fixture(scope="module")
def cli_runs(model, tmp_path_factory):
    """Each mode's batch CLI run through both packages with both process
    tracers on and ``--metrics_out``, made once for the module and read by
    every test of that mode: ``run(mode)`` gives ``(our spans, JAX's spans,
    our metrics_out, JAX's metrics_out)``."""
    made: dict[str, tuple] = {}

    def run(mode):
        if mode in made:
            return made[mode]
        d = tmp_path_factory.mktemp(f"torch_obs_cli_{mode}")
        ppkl = d / "p.pkl"
        ppkl.write_bytes(pickle.dumps(PROMPTS))
        common = ["--model_path", model, "--prompt_pickle", str(ppkl), "--dtype", "float32",
                  "--bucket_multiple", "8", "--block_size", "2", "--prefetch_depth", "0",
                  *_CLI_MODES[mode]]
        tracers = (obs_trace.TRACER, jtrace.TRACER)
        for t in tracers:
            t.clear()
            t.enable()
        _reset_caches()
        try:
            cli.main(common + ["--device", "cpu", "--output_file", str(d / "o.pkl"),
                               "--metrics_out", str(d / "m.json")], tokenizer=_tok())
            jcli.main(common + ["--num_devices", "1", "--output_file", str(d / "jo.pkl"),
                                "--metrics_out", str(d / "jm.json")], tokenizer=_tok())
            spans = tuple(t.snapshot() for t in tracers)
        finally:
            for t in tracers:
                t.disable()
                t.clear()
            _reset_caches()
        assert os.path.exists(d / "o.pkl")
        made[mode] = (*spans, *(json.loads((d / f).read_text()) for f in ("m.json", "jm.json")))
        return made[mode]

    return run


@pytest.fixture(scope="module")
def serve_run(model):
    """One traced serve run through both packages, made once for the module:
    the same requests queued before each engine starts (one wave each), the
    port's ``/metrics`` scraped while its endpoint serves. Gives ``(our
    spans, JAX's spans, our exposition)``."""
    tracers = (obs_trace.TRACER, jtrace.TRACER)
    for t in tracers:
        t.clear()
        t.enable()
    _reset_caches()
    sc = dict(max_wave_requests=2, default_max_new_tokens=3)
    runs = ((ServeEngine, _fw(model, decode_resident="on"), ServeConfig(**sc, metrics_port=0)),
            (JServeEngine, _jfw(model, decode_resident="on"), JServeConfig(**sc)))
    text = None
    try:
        for engine_cls, fw, scfg in runs:
            engine = engine_cls(fw, scfg, tokenizer=_tok(), start=False)
            reqs = [engine.submit(p, s) for p, s in PROMPTS]
            engine.start()
            try:
                for r in reqs:
                    r.future.result(timeout=300)
                if text is None:
                    url = f"http://127.0.0.1:{engine.metrics_server.port}/metrics"
                    text = urllib.request.urlopen(url, timeout=30).read().decode()
            finally:
                engine.shutdown(drain=True)
            assert engine.error is None
        spans = tuple(t.snapshot() for t in tracers)
    finally:
        for t in tracers:
            t.disable()
            t.clear()
        _reset_caches()
    return (*spans, text)


def _relative(events: list[dict], id_keys=("sweep_id", "wave_id", "request_id")) -> list[dict]:
    """Events without their volatile keys, each correlation id replaced by
    its order of first appearance (the packages' id wells differ)."""
    seen: dict[tuple, int] = {}

    def rel(key, value):
        if isinstance(value, list):
            return [rel(key, v) for v in value]
        return seen.setdefault((key, value), sum(1 for k in seen if k[0] == key))

    out = []
    for e in events:
        d = {k: v for k, v in e.items() if k not in _VOLATILE}
        for key in id_keys:
            if key in d:
                d[key] = rel(key, d[key])
        if "request_ids" in d:
            d["request_ids"] = rel("request_id", d["request_ids"])
        out.append(d)
    return out


# ---------------------------------------------------------------------------
# Tracer: ring, drops, the disabled path, exports
# ---------------------------------------------------------------------------

def test_tracer_disabled_records_nothing_and_shares_null_span():
    t = Tracer()
    assert not t.enabled
    s1, s2 = t.span("a"), t.span("b")
    assert s1 is s2  # one shared no-op object
    with t.span("x", cat="c", k=1):
        pass
    t.instant("y")
    assert len(t) == 0 and t.stats()["trace_spans"] == 0
    # The module-level emit takes the same path.
    assert obs_trace.span("z") is obs_trace.span("w")


def test_tracer_ring_overflow_drops_oldest_and_counts():
    t = Tracer(capacity=10)
    t.enabled = True  # direct: a unit test leaves the process registry alone
    for i in range(25):
        t.instant("ev", i=i)
    assert len(t) == 10 and t.drops == 15 and t.stats()["trace_drops"] == 15
    assert [s["i"] for s in t.snapshot()] == list(range(15, 25))


def test_tracer_span_timing_and_attrs():
    t = Tracer()
    t.enabled = True
    with t.span("work", cat="test", sweep_id=7, shard_idx=3):
        time.sleep(0.01)
    (rec,) = t.snapshot()
    assert rec["name"] == "work" and rec["cat"] == "test"
    assert rec["sweep_id"] == 7 and rec["shard_idx"] == 3
    assert rec["dur_s"] >= 0.009 and rec["tid"] == threading.get_ident()


def test_tracer_exports_chrome_and_jsonl(tmp_path):
    t = Tracer(capacity=100)
    t.enabled = True
    with t.span("s", cat="c", sweep_id=1):
        pass
    t.instant("i", cat="c", request_id="r-1")
    chrome, jsonl = tmp_path / "t.json", tmp_path / "t.jsonl"
    t.write(str(chrome))
    t.write(str(jsonl))
    evs = json.loads(chrome.read_text())["traceEvents"]
    assert any(e.get("ph") == "X" and e["name"] == "s" for e in evs)
    assert any(e.get("ph") == "i" and e["name"] == "i" for e in evs)
    meta = [e for e in evs if e["name"] == "trace_meta"]
    assert meta and meta[0]["args"]["trace_drops"] == 0
    lines = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    assert {ln["name"] for ln in lines} == {"s", "i", "trace_meta"}
    span = next(ln for ln in lines if ln["name"] == "s")
    assert "dur_s" in span and span["sweep_id"] == 1


def test_jsonl_export_carries_drop_count(tmp_path):
    t = Tracer(capacity=4)
    t.enabled = True
    for i in range(9):
        t.instant("ev", i=i)
    p = str(tmp_path / "t.jsonl")
    t.write(p)
    assert obs_report.analyze(obs_report.load_trace(p))["trace_drops"] == 5


# ---------------------------------------------------------------------------
# StepWatchdog: the stall is a trace instant
# ---------------------------------------------------------------------------

def test_watchdog_abort_emits_structured_span_event(process_tracer):
    fired = threading.Event()
    wd = StepWatchdog("test-sweep", abort_s=0.05, on_stall=lambda idle, tok: fired.set(),
                      poll_s=0.01)
    try:
        wd.arm(token="src")
        assert fired.wait(timeout=5.0)
    finally:
        wd.close()
    stalls = [s for s in process_tracer.snapshot() if s["name"] == "watchdog_stall"]
    assert stalls, "the stall must land in the trace"
    ev = stalls[0]
    assert ev["cat"] == "serve" and ev["desc"] == "test-sweep" and ev["idle_s"] >= 0.05
    assert wd.stats() == {"stalls": 1}


# ---------------------------------------------------------------------------
# The metrics registry and its endpoint
# ---------------------------------------------------------------------------

def test_registry_collect_and_prometheus_text():
    reg = MetricsRegistry()
    reg.register("a", lambda: {"x": 1, "nested": {"y": 2.5}})

    class Src:
        def stats(self):
            return {"z": 3}

    reg.register("b", Src())
    assert reg.collect() == {"a": {"x": 1, "nested": {"y": 2.5}}, "b": {"z": 3}}
    text = reg.prometheus_text()
    assert "# TYPE fls_a_x gauge\nfls_a_x 1" in text
    assert "fls_a_nested_y 2.5" in text and "fls_b_z 3" in text
    reg.register("b", lambda: {"z": 9})  # last wins
    assert reg.collect()["b"] == {"z": 9}
    reg.unregister("a")
    assert "a" not in reg.collect()


def test_registry_broken_source_reports_error_not_raise():
    reg = MetricsRegistry()

    def broken():
        raise RuntimeError("wedged")

    reg.register("bad", broken)
    assert reg.collect()["bad"] == {"collect_error": 1}
    assert "fls_bad_collect_error 1" in reg.prometheus_text()


def test_metrics_server_scrape():
    reg = MetricsRegistry()
    reg.register("s", lambda: {"up": 1})
    srv = MetricsServer(reg, port=0)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        assert b"fls_s_up 1" in urllib.request.urlopen(f"{base}/metrics", timeout=10).read()
        js = json.loads(urllib.request.urlopen(f"{base}/metrics.json", timeout=10).read())
        assert js == {"s": {"up": 1}}
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/nope", timeout=10)
    finally:
        srv.close()
    srv.close()  # idempotent


# ---------------------------------------------------------------------------
# The serve stats line: one registry-backed assembly
# ---------------------------------------------------------------------------

class _FakeCache:
    def stats(self):
        return {"hits": 3, "misses": 1, "hit_rate": 0.75}


class _FakeTier:
    def stats(self):
        return {"pinned_bytes": 1024, "stream_bytes_saved": 4096, "pin_hits": 2}


def test_stats_line_layout_regression():
    m = ServingMetrics(process_mirror=False)
    m.count("admitted", 2)
    m.count("completed", 1)
    m.gauge("queue_depth", 5)
    m.observe_ttft(0.25, "interactive")
    m.retries.record("shard_read", retries=1, backoff_s=0.05)
    m.integrity.count("reread_heals")
    m.host_cache = _FakeCache()
    m.residency = _FakeTier()
    line = m.snapshot()
    for key in ServingMetrics.KNOWN_COUNTERS:
        assert key in line, f"counter {key} missing from the stats line"
    assert line["event"] == "serve_stats"
    assert line["admitted"] == 2 and line["completed"] == 1 and line["queue_depth"] == 5
    assert set(line["ttft_s"]) == {"count", "mean", "p50", "p95", "p99", "max"}
    assert line["token_latency_s"] == {"count": 0}
    for block in ("ttft_by_class", "latency_by_class"):
        assert set(line[block]) == {"best_effort", "interactive", "standard"}
    assert line["ttft_by_class"]["interactive"]["count"] == 1
    assert line["ttft_by_class"]["standard"] == {"count": 0}
    assert line["io_retries"]["shard_read"]["retries"] == 1
    assert line["integrity"]["reread_heals"] == 1
    assert line["host_cache_hit_rate"] == 0.75 and line["host_cache"]["hits"] == 3
    assert line["pinned_bytes"] == 1024 and line["stream_bytes_saved"] == 4096
    assert line["residency"]["pin_hits"] == 2
    m.spec_count(drafted=4, accepted=3, rejected=1, slo_class="interactive")
    line = m.snapshot()
    spec = line["spec"]
    assert spec["drafted_tokens"] == 4 and spec["accepted_tokens"] == 3
    assert spec["by_class"]["interactive"] == {
        "drafted_tokens": 4, "accepted_tokens": 3, "rejected_tokens": 1}
    text = m.registry.prometheus_text()
    assert "fls_spec_by_class_interactive_accepted_tokens 3" in text
    assert "fls_spec_by_class_standard_drafted_tokens 0" in text
    assert assemble_serve_stats(m.registry.collect()) == line


def test_stats_line_omits_empty_recorder_blocks():
    m = ServingMetrics(process_mirror=False)
    line = m.snapshot()
    assert "io_retries" not in line and "integrity" not in line
    assert "host_cache" not in line and "residency" not in line
    m.host_cache = _FakeCache()
    m.host_cache = None
    assert "host_cache" not in m.snapshot()


def test_stats_line_survives_broken_attached_source():
    m = ServingMetrics(process_mirror=False)

    class Broken:
        def stats(self):
            raise RuntimeError("wedged")

    m.host_cache = Broken()
    m.residency = Broken()
    line = m.snapshot()  # must not raise
    assert line["host_cache"] == {"collect_error": 1} and line["residency"] == {"collect_error": 1}
    assert "host_cache_hit_rate" not in line and "pinned_bytes" not in line


def test_metrics_close_retracts_only_own_process_mirrors():
    a = ServingMetrics()
    b = ServingMetrics()  # the newer engine wins the process names
    a.close()
    assert "serve" in REGISTRY.collect()
    b.close()
    assert "serve" not in REGISTRY.collect()
    REGISTRY.register("host_cache", lambda: {"hit_rate": 1.0})
    c = ServingMetrics()
    c.host_cache = _FakeCache()
    c.host_cache = None
    c.close()
    assert REGISTRY.collect()["host_cache"] == {"hit_rate": 1.0}
    REGISTRY.unregister("host_cache")


def test_weak_source_releases_dead_instances():
    import gc

    class Runner:
        def __init__(self):
            self.stats = {"x": 1}

    r = Runner()
    src = weak_source(r)
    assert src() == {"x": 1}
    del r
    gc.collect()
    assert src() == {}


def test_serving_metrics_prometheus_has_full_counter_family():
    m = ServingMetrics(process_mirror=False)
    text = m.registry.prometheus_text()
    for key in ("engine_recoveries", "waves_aborted", "source_restarts", "watchdog_stalls",
                "admitted"):
        assert f"fls_serve_{key} 0" in text
    for cls in ("interactive", "standard", "best_effort"):
        assert f"fls_serve_ttft_by_class_{cls}_count 0" in text
        assert f"fls_serve_latency_by_class_{cls}_count 0" in text


# ---------------------------------------------------------------------------
# The trace analyzer
# ---------------------------------------------------------------------------

_SYNTHETIC = [
    {"name": "shard_produce", "cat": "stream", "ts_s": 0.0, "dur_s": 0.2},
    {"name": "shard_load", "cat": "stream", "ts_s": 0.0, "dur_s": 0.15},
    {"name": "device_put", "cat": "stream", "ts_s": 0.15, "dur_s": 0.05},
    {"name": "shard_produce", "cat": "stream", "ts_s": 0.5, "dur_s": 0.2},
    {"name": "shard_load", "cat": "stream", "ts_s": 0.5, "dur_s": 0.2},
    {"name": "source_wait", "cat": "sweep", "ts_s": 0.0, "dur_s": 0.1, "sweep_id": 1},
    {"name": "compute", "cat": "sweep", "ts_s": 0.2, "dur_s": 0.3, "sweep_id": 1, "shard_idx": 0},
    {"name": "sweep", "cat": "sweep", "ts_s": 0.0, "dur_s": 1.0, "sweep_id": 1},
] + [{"name": "ttft", "cat": "serve", "ts_s": 0.9, "seconds": s} for s in (0.1, 0.2, 0.3, 0.4)] + [
    {"name": "token_latency", "cat": "serve", "ts_s": 0.95, "seconds": 0.05, "tokens": 2},
    {"name": "wave_admit", "cat": "serve", "ts_s": 0.05, "wave_id": 1, "requests": 2},
]


def test_analyzer_derives_utilization_overlap_and_quantiles():
    rep = obs_report.analyze(_SYNTHETIC)
    assert rep["wall_s"] == pytest.approx(1.0)
    assert rep["stream_busy_s"] == pytest.approx(0.4)
    assert rep["link_utilization"] == pytest.approx(0.4)
    assert rep["overlap_efficiency"] == pytest.approx(0.75)
    assert rep["sweeps"] == 1
    assert rep["sweep_phase_s"]["compute"] == pytest.approx(0.3)
    assert rep["sweep_wall_s"] == pytest.approx(1.0)
    q = rep["ttft_s"]
    assert q["count"] == 4 and q["p50"] == 0.3 and q["max"] == 0.4
    # The same report and rendering as the JAX analyzer's, exactly.
    assert rep == jreport.analyze(_SYNTHETIC)
    assert obs_report.format_report(rep) == jreport.format_report(rep)


def test_analyzer_roundtrips_both_export_formats(tmp_path):
    t = Tracer()
    time.sleep(0.05)  # the spans start well after the tracer's construction
    t.enabled = True
    with t.span("shard_load", cat="stream"):
        time.sleep(0.002)
    t.instant("ttft", cat="serve", seconds=0.5)
    walls = {}
    for suffix in ("chrome.json", "spans.jsonl"):
        p = tmp_path / suffix
        t.write(str(p))
        rep = obs_report.analyze(obs_report.load_trace(str(p)))
        assert rep["spans_by_name"]["shard_load"]["count"] == 1 and rep["ttft_s"]["count"] == 1
        walls[suffix] = rep["wall_s"]
    assert walls["chrome.json"] == pytest.approx(walls["spans.jsonl"], abs=1e-3)
    assert walls["chrome.json"] < 0.05


# ---------------------------------------------------------------------------
# End to end: traced runs, held against JAX's
# ---------------------------------------------------------------------------

def test_executor_run_produces_sweep_timeline(cli_runs):
    spans, _, metrics, _ = cli_runs("scoring")
    names = {s["name"] for s in spans}
    assert {"sweep", "compute", "source_wait", "shard_load", "shard_produce",
            "device_put"} <= names
    assert len({s["sweep_id"] for s in spans if s["name"] == "compute"}) == 1
    rep = obs_report.analyze(spans)
    assert rep["sweeps"] == 1 and 0.0 <= rep["link_utilization"] <= 1.0
    assert "overlap_efficiency" in rep
    # The trace's source_wait total is the stats line's.
    assert rep["spans_by_name"]["source_wait"]["total_s"] == pytest.approx(
        metrics["stats"]["source_wait_s"], abs=1e-5)


@pytest.mark.parametrize("mode", sorted(_CLI_MODES))
def test_traced_offline_run_matches_jax(cli_runs, mode):
    """Scoring and a streamed KV decode (per-step passes): every span and
    instant in the same order with the same category and attributes."""
    got, want = (_relative(spans) for spans in cli_runs(mode)[:2])
    assert len(got) == len(want) and got == want
    sweeps = [e for e in got if e["name"] == "sweep"]
    assert sweeps and all(e["mode"] == ("offline" if mode == "scoring" else "decode_step")
                          for e in sweeps)


def _serve_lifecycle(spans) -> list[dict]:
    """The serve-side events of a trace (the weight stream's spans left
    out), ids relative."""
    return _relative([e for e in spans if e["cat"] in ("serve", "sched")])


def test_serve_run_traces_waves_and_exposes_metrics(serve_run):
    spans, _, text = serve_run
    for series in ("fls_serve_queue_depth", "fls_serve_ttft_s_p99", "fls_stream_streamed_bytes",
                   "fls_serve_engine_recoveries", "fls_integrity_reread_heals",
                   "fls_host_cache_hit_rate", "fls_trace_trace_drops"):
        assert series in text, f"{series} missing from the exposition"
    names = {s["name"] for s in spans}
    assert {"sweep", "prefill_shard", "decode_shard", "wave_admit", "ttft", "token_latency",
            "request_finish"} <= names
    assert all("wave_id" in s for s in spans if s["name"] in ("prefill_shard", "decode_shard"))
    assert all("request_id" in s for s in spans if s["name"] == "ttft")
    rep = obs_report.analyze(spans)
    assert rep["ttft_s"]["count"] == len(PROMPTS) and rep["token_latency_s"]["count"] >= 1
    assert rep["event_counts"]["wave_admit"] >= 1


def test_fleet_serves_one_endpoint_on_a_fixed_port(model):
    """A fleet on a fixed ``metrics_port``: the fleet binds it and its
    replicas open no endpoint of their own (as the JAX fleet's do not), and
    one scrape carries the router's and every replica's families."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]

    def endpoints():
        return sum(t.name == "metrics-endpoint" and t.is_alive() for t in threading.enumerate())

    before = endpoints()
    fleet = ReplicaFleet(_fw(model), ServeConfig(replicas=2, metrics_port=port),
                         tokenizer=_tok(), device=torch.device("cpu"), start=False)
    try:
        opened = endpoints() - before
        text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                      timeout=30).read().decode()
    finally:
        fleet.shutdown(drain=False, timeout=5.0)
    assert fleet.metrics_server.port == port
    assert opened == 1, f"{opened} metrics endpoints opened for one fleet"
    for family in ("fls_router_", "fls_replica0_", "fls_replica1_"):
        assert family in text, f"{family} missing from the fleet's exposition"
    assert endpoints() == before


def test_traced_serve_run_matches_jax(serve_run):
    """The same requests queued before each engine starts: one wave each,
    the same lifecycle events in the same order."""
    got, want = (_serve_lifecycle(spans) for spans in serve_run[:2])
    assert got == want
    assert [e["name"] for e in got if e["name"] == "wave_admit"] == ["wave_admit"]
    assert sum(e["name"] == "request_finish" for e in got) == len(PROMPTS)


def test_tenant_throttle_instants_match_jax(both_tracers):
    """Each rate-limited submission is a ``tenant_throttle`` instant in the
    ``sched`` category, as in the JAX scheduler."""
    for sched_cls, sched_cfg, queue_mod, request_mod in (
            (SweepScheduler, SchedConfig, queue, request),
            (JSweepScheduler, JSchedConfig, jqueue, jrequest)):
        sched = sched_cls(sched_cfg(enabled=True, tenant_limits="metered=2", tenant_burst=2.0))
        q = queue_mod.AdmissionQueue(capacity=16, scheduler=sched)
        reqs = [request_mod.Request(prefix="p", suffixes=("s",), max_new_tokens=1,
                                    tenant_id="metered") for _ in range(4)]
        for r in reqs:
            q.submit(r)
        assert sum(r.status is request_mod.RequestStatus.REJECTED for r in reqs) == 2
    drop = _VOLATILE + ("retry_after_s",)
    got, want = ([{k: v for k, v in e.items() if k not in drop} for e in _relative(t.snapshot())]
                 for t in both_tracers)
    assert got == want and [e["name"] for e in got] == ["tenant_throttle"] * 2
    assert got[0]["cat"] == "sched" and got[0]["tenant"] == "metered"
    assert all(e["retry_after_s"] > 0 for e in both_tracers[0].snapshot())


_SERVE_CASES = {
    # Four requests over one prefix: one coalesced entry, one prefill.
    "coalesce": (dict(max_wave_requests=4, default_max_new_tokens=2),
                 dict(enabled=True, coalesce=True),
                 [("The capital of France", (s,)) for s in (" is Paris", " is Rome", " was",
                                                              " is")]),
    # Prompt-lookup drafts verified in the sweep.
    "spec": (dict(max_wave_requests=2, default_max_new_tokens=4, speculative_k=2), None,
             [("the cat the cat the cat", (" the cat",)), ("a b a b a b", (" a b",))]),
}


@pytest.mark.parametrize("case", sorted(_SERVE_CASES))
def test_sched_and_spec_instants_match_jax(model, both_tracers, case):
    """Coalescing and speculation as the JAX engine traces them: the
    ``prefix_coalesce`` and ``spec_draft``/``spec_verify`` instants in the
    same order with the same attributes, and the ``fls_sched_*`` /
    ``fls_spec_*`` families scrapeable."""
    ours, theirs = both_tracers
    sc, sched, prompts = _SERVE_CASES[case]
    texts = []
    for engine_cls, fw, sc_cls, sched_cls in (
            (ServeEngine, _fw(model, decode_resident="on"), ServeConfig, SchedConfig),
            (JServeEngine, _jfw(model, decode_resident="on"), JServeConfig, JSchedConfig)):
        scfg = sc_cls(**sc, sched=sched_cls(**sched) if sched else sched_cls())
        engine = engine_cls(fw, scfg, tokenizer=_tok(), start=False)
        reqs = [engine.submit(p, s) for p, s in prompts]
        engine.start()
        try:
            for r in reqs:
                r.future.result(timeout=300)
            texts.append(engine.metrics.registry.prometheus_text())
        finally:
            engine.shutdown(drain=True)
        assert engine.error is None
    cats = ("serve", "sched", "spec")
    got, want = (_relative([e for e in t.snapshot() if e["cat"] in cats]) for t in (ours, theirs))
    assert got == want
    names = {e["name"] for e in got}
    if case == "coalesce":
        assert "prefix_coalesce" in names
        assert "fls_sched_coalesced_requests 4" in texts[0]
    else:
        assert {"spec_draft", "spec_verify"} <= names
        assert "fls_spec_drafted_tokens" in texts[0] and "fls_spec_accepted_tokens" in texts[0]


def test_preemption_is_a_sched_instant_and_a_journal_event(model, process_tracer, tmp_path):
    """An interactive arrival retires the best-effort wave at a boundary:
    a ``wave_preempt`` instant (``sched``, with the wave's and the requests'
    ids) and journal event, and the ``fls_sched_preemptions`` family."""
    from flexible_llm_sharding_tpu_torch.obs import events as obs_events

    obs_events.reset_journal()
    obs_events.JOURNAL.configure(str(tmp_path / "j"))
    engine = ServeEngine(_fw(model, decode_resident="on"),
                         ServeConfig(max_wave_requests=1, max_active_requests=1,
                                     default_max_new_tokens=2, sched=SchedConfig(enabled=True)),
                         tokenizer=_tok(), start=False)
    gate, real = threading.Event(), engine._post_sweep

    def post_sweep(wall):  # hold after the first prefill: the next submit queues
        real(wall)
        if engine.metrics.counter("prefills") >= 1:
            gate.wait(timeout=120)

    engine._post_sweep = post_sweep
    engine.start()
    try:
        victim = engine.submit(*PROMPTS[0], max_new_tokens=6, slo_class="best_effort",
                               tenant_id="batch")
        deadline = time.monotonic() + 120
        while engine.metrics.counter("prefills") < 1:
            assert time.monotonic() < deadline
            time.sleep(0.002)
        urgent = engine.submit(*PROMPTS[1], max_new_tokens=1, slo_class="interactive",
                               tenant_id="live")
        gate.set()
        urgent.future.result(timeout=120)
        victim.future.result(timeout=120)
        text = engine.metrics.registry.prometheus_text()
    finally:
        engine.shutdown(drain=True)
        journal = obs_events.JOURNAL.tail()
        obs_events.reset_journal()
    assert engine.error is None
    preempts = [s for s in process_tracer.snapshot() if s["name"] == "wave_preempt"]
    assert preempts and preempts[0]["cat"] == "sched"
    assert preempts[0]["request_ids"] == [victim.request_id]
    events = [e for e in journal if e["kind"] == "wave_preempt"]
    assert [e["wave_id"] for e in events] == [p["wave_id"] for p in preempts]
    assert "fls_sched_preemptions 1" in text


# Sources of the JAX batch run's registry that the port does not have, and why.
JAX_ONLY_SOURCES: dict[str, str] = {}
# Families of a common source that only one package exports, and why.
JAX_ONLY_FAMILIES = {
    "fls_stream_host_casts": "the port casts on the device, after the upload",
}


def _families(text: str) -> set[str]:
    return {ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE")}


def test_batch_metrics_out_sources_match_jax(cli_runs):
    """``--metrics_out`` after a batch run: the same registry sources and,
    for the process-wide ones, the same Prometheus families as JAX's."""
    _, _, ours, theirs = cli_runs("scoring")
    assert set(theirs["metrics"]) - set(ours["metrics"]) == set(JAX_ONLY_SOURCES)
    assert set(ours["metrics"]) <= set(theirs["metrics"])
    # The metrics equal the stats line's numbers (the executor's weak source
    # is gone with the executor, in both packages).
    assert ours["metrics"]["stream"]["streamed_bytes"] == ours["stats"]["streamed_bytes"]
    for key in ("hits", "misses"):
        assert ours["metrics"]["host_cache"][key] == ours["stats"][f"host_cache_{key}"]
    for name in ("stream", "host_cache"):
        fam = _families(_prom({name: ours["metrics"][name]}))
        jfam = _families(_prom({name: theirs["metrics"][name]}))
        assert jfam - fam == {f for f in JAX_ONLY_FAMILIES if f.startswith(f"fls_{name}_")}
        assert fam <= jfam


def _prom(collected: dict) -> str:
    reg = MetricsRegistry()
    for name, snap in collected.items():
        reg.register(name, lambda snap=snap: snap)
    return reg.prometheus_text()
