"""The port's flight recorder (``obs/events.py``, ``obs/incident.py``, the
SLO tracker's journal events, ``obs/report.py``'s bundle analyzer and the
``incidents`` subcommand) against the JAX package's, on the CPU at the tiny
float32 llama's widths.

- Each case of the JAX package's ``tests/test_incidents.py`` on the port's
  modules: the journal's append, rotation and counted drops, incident
  bundles (trigger, settle, debounce, disk budget, a broken source kept as
  its ``collect_error``), SLO budget exhaustion as a journal event and a
  bundle, the analyzer and the CLI, and serve runs whose failure paths
  journal while the engine never fails for the journal's sake.
- A serve run under the same seeded ``engine_step`` chaos in both packages,
  the requests queued before each engine starts: the journal's ``(kind,
  severity, correlation ids)`` sequence is JAX's, ids taken relative; each
  captures one bundle with the same files and manifest keys, and the
  ``incidents list/show/analyze`` output is JAX's apart from paths and
  times.
- The brownout ladder's registry source (``fls_pressure_*``) and the
  adaptive speculation controller's journal events, against JAX's.
"""

import json
import os
import threading
import time
import urllib.request

import pytest

from flexible_llm_sharding_tpu.cli import incidents_main as jincidents_main
from flexible_llm_sharding_tpu.config import FaultConfig as JFaultConfig
from flexible_llm_sharding_tpu.config import FrameworkConfig as JFrameworkConfig
from flexible_llm_sharding_tpu.config import ServeConfig as JServeConfig
from flexible_llm_sharding_tpu.obs import events as jevents
from flexible_llm_sharding_tpu.runtime import kvpool as jkvpool
from flexible_llm_sharding_tpu.serve import ServeEngine as JServeEngine
from flexible_llm_sharding_tpu.serve.spec import SpecController as JSpecController
from flexible_llm_sharding_tpu_torch.cli import incidents_main
from flexible_llm_sharding_tpu_torch.config import (
    FaultConfig,
    FrameworkConfig,
    PressureConfig,
    ServeConfig,
    SLOConfig,
)
from flexible_llm_sharding_tpu_torch.faults.inject import FaultInjector
from flexible_llm_sharding_tpu_torch.obs import events as obs_events
from flexible_llm_sharding_tpu_torch.obs import incident as obs_incident
from flexible_llm_sharding_tpu_torch.obs import report as obs_report
from flexible_llm_sharding_tpu_torch.obs import trace as obs_trace
from flexible_llm_sharding_tpu_torch.obs.registry import REGISTRY
from flexible_llm_sharding_tpu_torch.obs.slo import SLOTracker
from flexible_llm_sharding_tpu_torch.runtime import kvpool, pressure
from flexible_llm_sharding_tpu_torch.runtime.pressure import PressureSnapshot
from flexible_llm_sharding_tpu_torch.serve import ServeEngine
from flexible_llm_sharding_tpu_torch.serve.spec import SpecController
from flexible_llm_sharding_tpu_torch.utils.metrics import ServingMetrics
from tests.fake_tokenizer import FakeTokenizer
from tests.test_torch_obs import seeded_checkpoint

PROMPTS = [
    ("The capital of France", (" is Paris", " is Rome")),
    ("Two plus two equals", (" four", " five")),
]


def _tok():
    return FakeTokenizer(vocab_size=256)  # ids below the tiny vocabulary


@pytest.fixture(scope="module")
def model(tiny_cfg, tmp_path_factory):
    return seeded_checkpoint(tiny_cfg, str(tmp_path_factory.mktemp("tiny_model_torch_incidents")))


def _kw(model_dir, **kw):
    base = dict(model_path=model_dir, layer_num_per_shard=1, storage_location="cpu",
                dtype="float32", bucket_multiple=8, block_size=2, prefetch_depth=0)
    base.update(kw)
    return base


def _fw(model_dir, **kw):
    return FrameworkConfig(**_kw(model_dir, **kw), device="cpu")


@pytest.fixture(autouse=True)
def fresh_journal():
    """Every test starts and ends with both packages' process journals
    closed, so no singleton carries events, recorders or sources over."""
    obs_events.reset_journal()
    jevents.reset_journal()
    yield
    obs_events.reset_journal()
    jevents.reset_journal()


def _arm(tmp_path, trigger="error", debounce_s=60.0, settle_s=0.0, max_bytes=50_000_000,
         journal_max=1_000_000, injector=None, config_snapshot=None):
    d = str(tmp_path / "incidents")
    obs_events.JOURNAL.configure(d, max_bytes=journal_max, injector=injector)
    rec = obs_incident.IncidentRecorder(d, max_bytes=max_bytes, trigger=trigger,
                                        debounce_s=debounce_s, settle_s=settle_s,
                                        config_snapshot=config_snapshot)
    obs_events.JOURNAL.attach_recorder(rec)
    return d, rec


def _bundles(d):
    return sorted(n for n in os.listdir(d) if n.startswith("incident-") and not n.endswith(".tmp"))


# ---------------------------------------------------------------------------
# The journal: append, seq, rotation, counted drops
# ---------------------------------------------------------------------------

def test_journal_disabled_is_noop_and_enabled_appends(tmp_path):
    obs_events.emit("reread_heal", layer="l0")  # disabled: a no-op
    assert len(obs_events.JOURNAL) == 0
    obs_events.JOURNAL.configure(str(tmp_path / "j"))
    obs_events.emit("reread_heal", layer="l0", mismatches=1)
    obs_events.emit("quarantine", layer="l1", path="/x")
    lines = [json.loads(ln) for ln in open(obs_events.JOURNAL.path).read().splitlines()]
    assert [ev["seq"] for ev in lines] == [1, 2]
    assert lines[0]["kind"] == "reread_heal" and lines[0]["severity"] == "warning"
    assert lines[1]["severity"] == "critical" and lines[1]["layer"] == "l1"
    st = obs_events.JOURNAL.stats()
    assert st["events_written"] == 2 and st["events_dropped"] == 0
    assert "journal" in REGISTRY.names()
    assert "fls_journal_events_written 2" in REGISTRY.prometheus_text()
    # The same vocabulary and severities as the JAX journal.
    assert obs_events.EVENT_KINDS == jevents.EVENT_KINDS


def test_journal_unknown_kind_counts_drop_never_raises(tmp_path):
    obs_events.JOURNAL.configure(str(tmp_path / "j"))
    obs_events.emit("not_a_kind", x=1)
    st = obs_events.JOURNAL.stats()
    assert st["events_dropped"] == 1 and st["events_written"] == 0


def test_journal_rotation_is_atomic_and_bounded(tmp_path):
    obs_events.JOURNAL.configure(str(tmp_path / "j"), max_bytes=400)
    for i in range(40):
        obs_events.emit("reread_heal", layer=f"layer{i}", mismatches=1)
    st = obs_events.JOURNAL.stats()
    assert st["rotations"] >= 1 and st["events_written"] == 40 and st["events_dropped"] == 0
    path = obs_events.JOURNAL.path
    gens = [n for n in os.listdir(tmp_path / "j") if n.startswith("journal")]
    assert sorted(gens) == ["journal.jsonl", "journal.jsonl.1"]
    seqs = []
    for gen in (path + ".1", path):
        seqs += [json.loads(ln)["seq"] for ln in open(gen).read().splitlines()]
    assert sorted(seqs) == list(range(min(seqs), 41)) and max(seqs) == 40


def test_journal_write_failure_degrades_to_counted_drops(tmp_path):
    """ENOSPC on the journal's own write (the ``disk_full`` site) is a
    counted drop; the in-memory ring keeps the tail."""
    inj = FaultInjector(FaultConfig(enabled=True, seed=7, error_rate=1.0, sites=("disk_full",)))
    obs_events.JOURNAL.configure(str(tmp_path / "j"), injector=inj)
    for i in range(5):
        obs_events.emit("reread_heal", layer=f"l{i}")  # must not raise
    st = obs_events.JOURNAL.stats()
    assert st["events_dropped"] == 5 and st["events_written"] == 0
    assert [e["layer"] for e in obs_events.JOURNAL.tail()] == [f"l{i}" for i in range(5)]
    assert "fls_journal_events_dropped 5" in REGISTRY.prometheus_text()


def test_journal_concurrent_emits_keep_seq_monotonic(tmp_path):
    obs_events.JOURNAL.configure(str(tmp_path / "j"))
    n_threads, per = 8, 50

    def worker():
        for _ in range(per):
            obs_events.emit("reread_heal", layer="x")

    ts = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    lines = [json.loads(ln) for ln in open(obs_events.JOURNAL.path).read().splitlines()]
    assert [ev["seq"] for ev in lines] == list(range(1, n_threads * per + 1))


# ---------------------------------------------------------------------------
# Incident bundles: trigger, contents, debounce, settle, budget
# ---------------------------------------------------------------------------

def test_incident_bundle_contents_and_collect_error_preserved(tmp_path):
    class Broken:
        def stats(self):
            raise RuntimeError("wedged at capture time")

    REGISTRY.register("broken_src", Broken().stats)
    try:
        d, rec = _arm(tmp_path, config_snapshot={"framework": {"dtype": "float32"}})
        obs_events.emit("wave_abort", wave_id=9, error="ShardLoadError", request_ids=[4, 5])
        bundles = _bundles(d)
        assert len(bundles) == 1
        b = obs_report.load_bundle(os.path.join(d, bundles[0]))
        assert b["manifest"]["trigger"]["kind"] == "wave_abort"
        assert b["manifest"]["format"] == "fls-incident-bundle"
        assert set(b["manifest"]["files"]) == {"config.json", "journal_tail.jsonl",
                                               "metrics.json", "trace.json"}
        assert b["metrics"]["broken_src"] == {"collect_error": 1}
        assert b["config"]["framework"]["dtype"] == "float32"
        assert [e["kind"] for e in b["journal"]] == ["wave_abort"]
        assert b["journal"][0]["request_ids"] == [4, 5]
        assert [e["kind"] for e in obs_events.JOURNAL.tail()] == ["wave_abort",
                                                                   "incident_capture"]
        assert rec.bundles == 1
    finally:
        REGISTRY.unregister("broken_src")


def test_incident_trigger_severity_threshold(tmp_path):
    d, rec = _arm(tmp_path, trigger="critical")
    obs_events.emit("engine_recovery", error="OSError", waves=1)  # error
    assert _bundles(d) == [] and rec.bundles == 0
    rec.observe({"kind": "manual", "severity": "shouting", "seq": 99})
    rec.observe({"kind": "manual", "seq": 100})
    assert _bundles(d) == [] and rec.bundles == 0
    obs_events.emit("replica_dead", replica=2, reason="test")  # critical
    assert len(_bundles(d)) == 1


def test_incident_storm_debounces_to_one_bundle(tmp_path):
    d, rec = _arm(tmp_path, debounce_s=60.0)
    for i in range(10):
        obs_events.emit("wave_abort", wave_id=i, error="X")
    assert len(_bundles(d)) == 1 and rec.debounces == 9
    st = obs_events.JOURNAL.stats()
    assert st["bundles"] == 1 and st["debounces"] == 9


def test_incident_settle_window_captures_the_whole_storm(tmp_path):
    d, rec = _arm(tmp_path, trigger="critical", settle_s=0.3, debounce_s=60.0)
    obs_events.emit("replica_dead", replica=1, reason="kill")
    obs_events.emit("redispatch", request_id=7, replica=2, attempts=2)
    deadline = time.monotonic() + 30
    while not _bundles(d) and time.monotonic() < deadline:
        time.sleep(0.02)
    bundles = _bundles(d)
    assert len(bundles) == 1
    tail = obs_report.load_bundle(os.path.join(d, bundles[0]))["journal"]
    assert {"replica_dead", "redispatch"} <= {e["kind"] for e in tail}


def test_incidents_dir_disk_budget_evicts_oldest(tmp_path):
    d, rec = _arm(tmp_path, debounce_s=0.0)
    for i in range(4):
        obs_events.emit("wave_abort", wave_id=i, error="X")
    assert len(_bundles(d)) == 4
    rec.max_bytes = 1
    obs_events.emit("wave_abort", wave_id=99, error="X")
    left = _bundles(d)
    assert len(left) == 1 and left[0].endswith("wave_abort")
    assert rec.bundle_evictions == 4 and obs_events.JOURNAL.stats()["bundle_evictions"] == 4


def test_capture_failure_counts_never_raises(tmp_path):
    d, rec = _arm(tmp_path)
    blocker = str(tmp_path / "blocker")
    with open(blocker, "w") as f:
        f.write("")
    rec.out_dir = blocker  # a file: the bundle's makedirs fails
    obs_events.emit("wave_abort", wave_id=1, error="X")  # must not raise
    assert rec.bundles == 0 and rec.bundle_errors == 1


# ---------------------------------------------------------------------------
# SLO error budgets: exhaustion journals and bundles
# ---------------------------------------------------------------------------

def test_slo_pre_seeded_zeros_and_disabled_noop():
    m = ServingMetrics(process_mirror=False)
    s = SLOTracker(SLOConfig(), m).stats()
    assert s["enabled"] == 0 and s["budget_exhausted_events"] == 0
    for cls in ("interactive", "standard", "best_effort"):
        assert s["ttft"][cls]["burn_rate"] == 0.0 and s["ttft"][cls]["budget_remaining"] == 1.0


def test_slo_burn_rate_math_and_exhaustion_latch(tmp_path):
    obs_events.JOURNAL.configure(str(tmp_path / "j"))
    m = ServingMetrics(process_mirror=False)
    t = SLOTracker(SLOConfig(enabled=True, ttft_p95_s="interactive=0.1", min_samples=10), m)
    for _ in range(19):
        m.observe_ttft(0.05, "interactive")
    m.observe_ttft(0.5, "interactive")
    e = t.stats()["ttft"]["interactive"]
    assert e["burn_rate"] == pytest.approx(1.0) and e["budget_remaining"] == pytest.approx(0.0)
    assert t.stats()["budget_exhausted_events"] == 1  # latched: one event
    kinds = [ev["kind"] for ev in obs_events.JOURNAL.tail()]
    assert kinds.count("slo_budget_exhausted") == 1
    ev = obs_events.JOURNAL.tail()[0]
    assert ev["metric"] == "ttft" and ev["slo_class"] == "interactive"
    assert ev["severity"] == "error" and ev["samples"] == 20
    for _ in range(500):
        m.observe_ttft(0.01, "interactive")
    assert t.stats()["ttft"]["interactive"]["burn_rate"] < 0.5
    for _ in range(500):
        m.observe_ttft(0.9, "interactive")
    assert t.stats()["budget_exhausted_events"] == 2


def test_slo_worst_burn_and_trend_direction():
    m = ServingMetrics(process_mirror=False)
    t = SLOTracker(SLOConfig(enabled=True, ttft_p95_s="interactive=0.1", min_samples=10_000), m)
    s = t.stats()
    assert s["worst_burn_rate"] == 0.0
    assert s["trend"] == {"window": 1, "burn_delta": 0.0, "rising": 0, "falling": 0}
    for _ in range(5):
        m.observe_ttft(5.0, "interactive")
        s = t.stats()
    assert s["worst_burn_rate"] > 1.0 and s["trend"]["rising"] == 1
    for i in range(300):
        m.observe_ttft(0.01, "interactive")
        if i % 50 == 0:
            t.stats()
    s = t.stats()
    assert s["trend"]["falling"] == 1 and s["trend"]["rising"] == 0
    for _ in range(10):
        s = t.stats()
    assert s["trend"] == {"window": 8, "burn_delta": 0.0, "rising": 0, "falling": 0}


def test_slo_min_samples_gate():
    m = ServingMetrics(process_mirror=False)
    t = SLOTracker(SLOConfig(enabled=True, ttft_p95_s="standard=0.1", min_samples=50), m)
    for _ in range(10):
        m.observe_ttft(5.0, "standard")
    s = t.stats()
    assert s["ttft"]["standard"]["burn_rate"] > 1.0 and s["budget_exhausted_events"] == 0


def test_slo_exhaustion_captures_incident_bundle(tmp_path):
    """Budget exhaustion is severity error: an armed recorder bundles it."""
    d, rec = _arm(tmp_path)
    m = ServingMetrics(process_mirror=False)
    t = SLOTracker(SLOConfig(enabled=True, availability_target=0.5, min_samples=4), m)
    for _ in range(5):
        m.count("failed")
    t.stats()
    bundles = _bundles(d)
    assert len(bundles) == 1 and bundles[0].endswith("slo_budget_exhausted")
    b = obs_report.load_bundle(os.path.join(d, bundles[0]))
    assert b["manifest"]["trigger"]["metric"] == "availability"


def test_slo_config_validation():
    with pytest.raises(ValueError, match="unknown SLO class"):
        SLOConfig(enabled=True, ttft_p95_s="nope=1")
    with pytest.raises(ValueError, match="must be > 0"):
        SLOConfig(enabled=True, ttft_p95_s="interactive=0")
    with pytest.raises(ValueError, match="availability_target"):
        SLOConfig(enabled=True, availability_target=1.0)
    with pytest.raises(ValueError, match="incident_trigger"):
        FrameworkConfig(incident_trigger="loud")
    with pytest.raises(ValueError, match="journal_max_mb"):
        FrameworkConfig(journal_max_mb=0)
    with pytest.raises(ValueError, match="metrics_port"):
        ServeConfig(metrics_port=70000)


# ---------------------------------------------------------------------------
# The analyzer and the CLI
# ---------------------------------------------------------------------------

def test_trace_report_accepts_bundle_dir(tmp_path, capsys):
    obs_trace.TRACER.clear()
    obs_trace.TRACER.enable()
    try:
        with obs_trace.span("sweep", cat="serve", sweep_id=1):
            obs_trace.instant("replica_kill", cat="fleet", replica=0)
        d, rec = _arm(tmp_path)
        obs_events.emit("replica_dead", replica=0, reason="t")
    finally:
        obs_trace.TRACER.disable()
        obs_trace.TRACER.clear()
    bundle = os.path.join(d, _bundles(d)[0])
    events = obs_report.load_trace(bundle)
    assert any(e["name"] == "replica_kill" for e in events)
    assert len(obs_report.load_trace(os.path.join(bundle, "manifest.json"))) == len(events)
    assert obs_report.main(["--trace", bundle, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["events"] >= 2


def test_incidents_cli_list_show_analyze(tmp_path, capsys):
    d, rec = _arm(tmp_path)
    obs_events.emit("replica_dead", replica=3, reason="kill")
    obs_events.emit("redispatch", request_id=11, replica=1, attempts=2)
    bundle = os.path.join(d, _bundles(d)[0])
    incidents_main(["list", "--dir", d, "--json"])
    rows = json.loads(capsys.readouterr().out)
    assert len(rows) == 1 and rows[0]["trigger"] == "replica_dead"
    incidents_main(["show", bundle, "--json"])
    assert json.loads(capsys.readouterr().out)["trigger"]["replica"] == 3
    incidents_main(["analyze", bundle])
    out = capsys.readouterr().out
    assert "replica_dead" in out and "timeline:" in out
    incidents_main(["analyze", bundle, "--json"])
    rep = json.loads(capsys.readouterr().out)
    assert rep["replicas"] == [3] and rep["trigger"]["kind"] == "replica_dead"
    with pytest.raises(SystemExit):
        incidents_main(["analyze", str(tmp_path)])  # not a bundle


def test_ensure_configured_arms_journal_only_configs(tmp_path):
    cfg = _fw(".", journal_dir=str(tmp_path / "j"))
    assert obs_incident.ensure_configured(cfg) is None
    assert obs_events.JOURNAL.enabled
    assert obs_events.JOURNAL.path == str(tmp_path / "j" / "journal.jsonl")
    obs_events.reset_journal()
    rec = obs_incident.ensure_configured(_fw(".", incidents_dir=str(tmp_path / "inc")))
    assert rec is not None and obs_events.JOURNAL.enabled
    assert obs_events.JOURNAL.path == str(tmp_path / "inc" / "journal.jsonl")


# ---------------------------------------------------------------------------
# Serving with the recorder armed, held against JAX
# ---------------------------------------------------------------------------

_CHAOS = dict(enabled=True, seed=3, error_rate=1.0, sites=("engine_step",), max_faults=1)


def test_serve_failure_paths_journal_and_bundle(model, tmp_path):
    """Seeded ``engine_step`` faults: the recovery journals
    ``engine_recovery`` and ``wave_abort`` with wave and request ids, one
    debounced bundle lands, the endpoint carries the journal and SLO
    families, and the engine never errs for the journal's sake."""
    inc_dir = str(tmp_path / "inc")
    engine = ServeEngine(
        _fw(model, incidents_dir=inc_dir, incident_settle_s=0.0, incident_debounce_s=600.0,
            io_retry_attempts=2, io_retry_base_s=0.001, faults=FaultConfig(**_CHAOS)),
        ServeConfig(max_wave_requests=2, default_max_new_tokens=1, metrics_port=0),
        tokenizer=_tok())
    try:
        for r in [engine.submit(p, s) for p, s in PROMPTS]:
            try:
                r.future.result(timeout=300)
            except Exception:  # the aborted wave's requests
                pass
        port = engine.metrics_server.port
        text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                      timeout=30).read().decode()
    finally:
        engine.shutdown(drain=True)
    assert engine.error is None
    tail = obs_events.JOURNAL.tail()
    kinds = [e["kind"] for e in tail]
    assert "engine_recovery" in kinds and "wave_abort" in kinds
    assert all("wave_id" in e and e["request_ids"] for e in tail if e["kind"] == "wave_abort")
    assert len(_bundles(inc_dir)) == 1
    assert "fls_journal_events_written" in text and "fls_journal_bundles 1" in text
    assert "fls_slo_ttft_interactive_burn_rate 0" in text


def test_serve_journal_enospc_never_an_engine_error(model, tmp_path):
    inj = FaultInjector(FaultConfig(enabled=True, seed=11, error_rate=1.0, sites=("disk_full",)))
    obs_events.JOURNAL.configure(str(tmp_path / "j"), injector=inj)
    engine = ServeEngine(_fw(model, io_retry_attempts=2, io_retry_base_s=0.001,
                             faults=FaultConfig(**_CHAOS)),
                         ServeConfig(max_wave_requests=2, default_max_new_tokens=1),
                         tokenizer=_tok())
    try:
        for r in [engine.submit(p, s) for p, s in PROMPTS]:
            try:
                r.future.result(timeout=300)
            except Exception:
                pass
    finally:
        engine.shutdown(drain=True)
    assert engine.error is None
    st = obs_events.JOURNAL.stats()
    assert st["events_dropped"] >= 1 and st["events_written"] == 0
    assert "engine_recovery" in [e["kind"] for e in obs_events.JOURNAL.tail()]


_ID_KEYS = ("wave_id", "request_id", "sweep_id")


def _journal_story(tail: list[dict]) -> list[tuple]:
    """(kind, severity, correlation ids) per event, ids taken relative."""
    seen: dict[tuple, int] = {}

    def rel(key, v):
        return seen.setdefault((key, v), sum(1 for k in seen if k[0] == key))

    out = []
    for e in tail:
        ids = tuple((k, rel(k, e[k])) for k in _ID_KEYS if k in e)
        reqs = tuple(rel("request_id", r) for r in e.get("request_ids") or ())
        out.append((e["kind"], e["severity"], ids, reqs, e.get("error"), e.get("replica")))
    return out


def _cli_json(main, argv, capsys):
    main(argv + ["--json"])
    return json.loads(capsys.readouterr().out)


def _strip(obj, keys=("path", "captured_at", "ts", "bundle", "pid", "detail")):
    """A report without its paths, times and per-process values."""
    if isinstance(obj, dict):
        return {k: _strip(v, keys) for k, v in obj.items() if k not in keys}
    if isinstance(obj, list):
        return [_strip(v, keys) for v in obj]
    return obj


def test_chaos_journal_and_bundle_match_jax(model, tmp_path, capsys):
    """The same seeded ``engine_step`` fault in both packages: the same
    journal story, one bundle each with the same files and manifest keys,
    and the same ``incidents`` output apart from paths and times."""
    kvpool.reset_process_pools()
    jkvpool.reset_process_pools()
    runs = {}
    for side, engine_cls, fw_cls, sc_cls, fault_cls in (
            ("port", ServeEngine, FrameworkConfig, ServeConfig, FaultConfig),
            ("jax", JServeEngine, JFrameworkConfig, JServeConfig, JFaultConfig)):
        inc_dir = str(tmp_path / side)
        kw = _kw(model, incidents_dir=inc_dir, incident_settle_s=0.0, io_retry_attempts=2,
                 io_retry_base_s=0.001, decode_resident="on", faults=fault_cls(**_CHAOS))
        fw = fw_cls(**kw, device="cpu") if side == "port" else fw_cls(**kw)
        engine = engine_cls(fw, sc_cls(max_wave_requests=2, default_max_new_tokens=2),
                            tokenizer=_tok(), start=False)
        reqs = [engine.submit(p, s) for p, s in PROMPTS]
        engine.start()
        outcomes = []
        try:
            for r in reqs:
                try:
                    outcomes.append(r.future.result(timeout=300).tokens.tolist())
                except Exception as e:  # the aborted wave's requests
                    outcomes.append(type(e).__name__)
        finally:
            engine.shutdown(drain=True)
        assert engine.error is None
        journal = (obs_events if side == "port" else jevents).JOURNAL
        runs[side] = (inc_dir, journal.tail(), outcomes)
    (p_dir, p_tail, p_out), (j_dir, j_tail, j_out) = runs["port"], runs["jax"]
    assert p_out == j_out
    assert _journal_story(p_tail) == _journal_story(j_tail)
    assert {"engine_recovery", "wave_abort"} <= {e["kind"] for e in p_tail}
    (p_b,), (j_b,) = _bundles(p_dir), _bundles(j_dir)
    pb, jb = (obs_report.load_bundle(os.path.join(d, b)) for d, b in ((p_dir, p_b), (j_dir, j_b)))
    assert pb["manifest"]["files"] == jb["manifest"]["files"]
    assert set(pb["manifest"]) == set(jb["manifest"])
    assert set(pb["manifest"]["journal"]) == set(jb["manifest"]["journal"])
    rows = _cli_json(incidents_main, ["list", "--dir", p_dir], capsys)
    jrows = _cli_json(jincidents_main, ["list", "--dir", j_dir], capsys)
    assert _strip(rows) == _strip(jrows)
    show = _cli_json(incidents_main, ["show", os.path.join(p_dir, p_b)], capsys)
    jshow = _cli_json(jincidents_main, ["show", os.path.join(j_dir, j_b)], capsys)
    # Ids, and the pool's auto budget (a share of the RAM available when each
    # package's pool was made), differ by nature.
    drop = ("path", "captured_at", "ts", "pid", "detail", "journal", "wave_id", "request_ids",
            "seq", "trigger_seq", "budget_bytes")
    assert _strip(show, keys=drop) == _strip(jshow, keys=drop)
    rep = _cli_json(incidents_main, ["analyze", os.path.join(p_dir, p_b)], capsys)
    jrep = _cli_json(jincidents_main, ["analyze", os.path.join(j_dir, j_b)], capsys)
    for key in ("events_by_kind", "events_by_severity", "journal_events", "replicas"):
        assert rep[key] == jrep[key]
    assert len(rep["waves"]) == len(jrep["waves"]) and len(rep["requests"]) == len(jrep["requests"])
    assert _journal_story(rep["timeline"]) == _journal_story(jrep["timeline"])


# ---------------------------------------------------------------------------
# The ladder's registry source and the speculation controller's events
# ---------------------------------------------------------------------------

def test_pressure_counters_scrapeable(model):
    cfg = _fw(model, pressure=PressureConfig(enabled=True, poll_s=60.0))
    pressure.reset_process_pressure()
    try:
        ctrl = pressure.controller_for(cfg)
        assert ctrl is pressure.controller_for(cfg)  # the process singleton
        ctrl.note_event("host_oom")
        ctrl.on_sample(PressureSnapshot())
        text = REGISTRY.prometheus_text()
        assert "fls_pressure_level" in text
        assert "fls_pressure_sheds 0" in text
        assert "fls_pressure_host_oom_events 1" in text
    finally:
        pressure.reset_process_pressure()
    assert "pressure" not in REGISTRY.names()


def _drive_spec(cls, journal, tmp_path):
    journal.configure(str(tmp_path))
    ctrl = cls(2, 0, 4, 2, 0.6, 0.2, 0)
    for cls_name, drafted, accepted in (("interactive", 4, 4), ("interactive", 4, 4),
                                        ("standard", 4, 0), ("standard", 4, 0),
                                        ("interactive", 4, 3), ("interactive", 4, 4)):
        ctrl.observe(cls_name, drafted, accepted)
    ctrl.pressure_backoff()
    ctrl.pressure_backoff()  # idempotent: one event
    ctrl.pressure_restore()
    return [{k: v for k, v in e.items() if k not in ("ts", "seq")} for e in journal.tail()]


def test_spec_controller_journals_its_decisions_as_jax(tmp_path):
    """Windowed raises and backoffs and the ladder's backoff and restore:
    the same journal events, reasons and k's as the JAX controller's."""
    ours = _drive_spec(SpecController, obs_events.JOURNAL, tmp_path / "p")
    theirs = _drive_spec(JSpecController, jevents.JOURNAL, tmp_path / "j")
    assert ours == theirs
    assert [e["reason"] for e in ours].count("pressure") == 1
    assert {e["kind"] for e in ours} == {"spec_k_raise", "spec_k_backoff"}
