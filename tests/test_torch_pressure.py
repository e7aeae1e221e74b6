"""The port's brownout ladder (``runtime/pressure.py``) and its levers against
the JAX package's, on the CPU: the cases of ``tests/test_pressure.py`` but
the registry scrape (``obs/`` is not ported).

- Units against JAX on the same inputs: the config's validation, the
  monitor's tripped set over the same samplers, the ladder's levels and
  ``stats()`` over one scripted ``PressureSnapshot`` sequence (``on_sample``
  called directly, never a poll), the hard-event jump, the mid-brownout
  attach rules, the host cache's cap and lift, the residency tier's
  demotion (the port's also drops its placed trees), the queue's shed and
  size cap, ``DiskFullError`` and the link stall.
- The serving engine and the executor on a tiny checkpoint (2 layers,
  hidden 64, float32, the ``FakeTokenizer``): a bounded ``host_oom`` outage
  keeps every token the JAX offline decode's, a persistent one fails the
  wave and keeps the engine, a disk-mode run under ``disk_full`` gives the
  JAX executor's scores and retry counts, a brownout sheds ``Overloaded``
  and steps back to level 0, and the fleet drains and restores.

Threaded cases fix their order: the ladder is driven by ``on_sample`` where
the order matters, and the brownout case waits on the ladder's own state.
"""

import dataclasses
import errno
import os
import tempfile
import time

import jax
import numpy as np
import pytest
import torch

from flexible_llm_sharding_tpu.adapters import loader as jloader
from flexible_llm_sharding_tpu.config import FaultConfig as JFaultConfig
from flexible_llm_sharding_tpu.config import FrameworkConfig as JFrameworkConfig
from flexible_llm_sharding_tpu.config import LlamaConfig as JLlamaConfig
from flexible_llm_sharding_tpu.config import PressureConfig as JPressureConfig
from flexible_llm_sharding_tpu.faults import inject as jinject
from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu.obs import events as jevents
from flexible_llm_sharding_tpu.obs import trace as jtrace
from flexible_llm_sharding_tpu.runtime import hostcache as jhostcache
from flexible_llm_sharding_tpu.runtime import kvpool as jkvpool
from flexible_llm_sharding_tpu.runtime import pressure as jpressure
from flexible_llm_sharding_tpu.runtime import residency as jresidency
from flexible_llm_sharding_tpu.runtime.activations import ActivationStore as JActivationStore
from flexible_llm_sharding_tpu.runtime.decode import DecodeGenerator as JDecodeGenerator
from flexible_llm_sharding_tpu.runtime.executor import StreamingExecutor as JStreamingExecutor
from flexible_llm_sharding_tpu.serve import queue as jqueue
from flexible_llm_sharding_tpu.serve import request as jrequest
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu_torch.adapters import loader
from flexible_llm_sharding_tpu_torch.config import (
    FaultConfig,
    FrameworkConfig,
    PressureConfig,
    ServeConfig,
)
from flexible_llm_sharding_tpu_torch.faults import inject
from flexible_llm_sharding_tpu_torch.faults.retry import RetryPolicy, ShardLoadError
from flexible_llm_sharding_tpu_torch.obs import events as pevents
from flexible_llm_sharding_tpu_torch.obs import trace as ptrace
from flexible_llm_sharding_tpu_torch.runtime import hostcache, kvpool, pressure, residency
from flexible_llm_sharding_tpu_torch.runtime.activations import ActivationStore
from flexible_llm_sharding_tpu_torch.runtime.executor import StreamingExecutor
from flexible_llm_sharding_tpu_torch.runtime.pressure import (
    BrownoutController,
    DiskFullError,
    HostOOMError,
    PressureMonitor,
    PressureSnapshot,
)
from flexible_llm_sharding_tpu_torch.serve import (
    AdmissionQueue,
    Overloaded,
    QueueFull,
    ReplicaFleet,
    Request,
    RequestStatus,
    RequestTooLarge,
    ServeEngine,
    WaveAborted,
)
from flexible_llm_sharding_tpu_torch.utils.checkpoint import layer_names_for

from tests.fake_tokenizer import FakeTokenizer

CHAOS_SEED = int(os.environ.get("FLS_CHAOS_SEED", "1234"))
CPU = torch.device("cpu")
PROMPTS = [
    ("The capital of France", (" is Paris", " is Rome")),
    ("Two plus two equals", (" four", " five")),
    ("The sky is", (" blue", " green")),
    ("Hello world", (" again", " anew")),
]
N_LAYERS = 2
# The keys the port's controller adds to the JAX controller's stats().
PORT_ONLY = ("sample_errors", "lever_errors")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny llama (2 layers, hidden 64) saved by the JAX package."""
    d = tmp_path_factory.mktemp("pressure_model")
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
    for mod in (residency, jresidency):
        mod.reset_process_tier()
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


def _pcfg(port: bool = True, **kw):
    base = dict(enabled=True, poll_s=0.02, host_min_gb=0.0, disk_min_gb=0.0,
                hbm_headroom_frac=0.0, shed_retry_after_s=0.25, step_down_polls=2)
    return (PressureConfig if port else JPressureConfig)(**{**base, **kw})


def _both(model_dir, **kw):
    """(port config, JAX config) with the same fields; ``pressure`` and
    ``faults`` given as dicts."""
    p, f = kw.pop("pressure", None), kw.pop("faults", None)
    out = []
    for port in (True, False):
        extra = dict(kw)
        if p is not None:
            extra["pressure"] = _pcfg(port, **p)
        if f is not None:
            extra["faults"] = (FaultConfig if port else JFaultConfig)(**f)
        out.append(_fw(model_dir, port, **extra))
    return out


@pytest.fixture(scope="module")
def oracle(model_dir):
    """The JAX package's offline decode of PROMPTS, one new token: (scores,
    updated)."""
    cfg = _fw(model_dir, port=False, num_gen_token=1,
              disk_folder=tempfile.mkdtemp(prefix="fls_pressure_oracle_"))
    return JDecodeGenerator(cfg, tokenizer=FakeTokenizer())(list(PROMPTS))


def _same_as_oracle(res, want_scores, want_updated):
    assert (res.scores.argmax(-1) == want_scores.argmax(-1)).all()
    np.testing.assert_allclose(res.scores, want_scores, rtol=1e-5, atol=1e-5)
    assert res.updated == want_updated


# ---------------------------------------------------------------------------
# Config and monitor
# ---------------------------------------------------------------------------

BAD = [dict(poll_s=0.0), dict(host_min_gb=-1), dict(cache_shrink_frac=1.5),
       dict(hbm_headroom_frac=-0.1), dict(step_down_polls=0)]


@pytest.mark.parametrize("kw", BAD, ids=[str(k) for k in BAD])
def test_pressure_config_validation(kw):
    with pytest.raises(ValueError) as ours:
        PressureConfig(**kw)
    with pytest.raises(ValueError) as theirs:
        JPressureConfig(**kw)
    assert str(ours.value) == str(theirs.value)
    assert dataclasses.asdict(PressureConfig(enabled=True)) == dataclasses.asdict(
        JPressureConfig(enabled=True))
    assert FrameworkConfig().pressure == PressureConfig()


SAMPLERS = {
    "host_low": (dict(host_min_gb=1.0, disk_min_gb=2.0, hbm_headroom_frac=0.1),
                 (int(0.5e9), int(10e9), 0.5)),
    "unknown": (dict(host_min_gb=1.0, disk_min_gb=2.0, hbm_headroom_frac=0.1), (None, None, None)),
    "all_off": (dict(host_min_gb=0.0, disk_min_gb=0.0, hbm_headroom_frac=0.0), (1, 1, 0.0)),
    "all_low": (dict(host_min_gb=1.0, disk_min_gb=2.0, hbm_headroom_frac=0.1), (1, 1, 0.0)),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_monitor_trips_exactly_configured_thresholds(name, model_dir):
    thresholds, (host, disk, hbm) = SAMPLERS[name]
    snaps = []
    for port, mod in ((True, pressure), (False, jpressure)):
        cfg = _fw(model_dir, port, pressure=(PressureConfig if port else JPressureConfig)(
            enabled=True, **thresholds))
        mon = mod.PressureMonitor(cfg, mod.BrownoutController(cfg),
                                  host_bytes_fn=lambda: host, disk_free_fn=lambda: disk,
                                  hbm_free_frac_fn=lambda: hbm, link_bytes_fn=lambda: 0)
        snaps.append(mon.sample())
    assert snaps[0].tripped == snaps[1].tripped
    assert (snaps[0].host_available_bytes, snaps[0].disk_free_bytes, snaps[0].hbm_free_frac) == (
        snaps[1].host_available_bytes, snaps[1].disk_free_bytes, snaps[1].hbm_free_frac)
    want = {"host_low": {"host"}, "unknown": set(), "all_off": set(),
            "all_low": {"host", "disk", "hbm"}}[name]
    assert snaps[0].tripped == frozenset(want)


def test_hbm_sampler_unknown_on_the_cpu_and_failures_counted(model_dir):
    """On a CPU device the HBM signal is unknown (never trips); a sampler
    that fails elsewhere reads as unknown and is counted, not swallowed."""
    cfg = _fw(model_dir, pressure=_pcfg(hbm_headroom_frac=0.5))
    ctrl = BrownoutController(cfg)
    assert PressureMonitor(cfg, ctrl).sample().hbm_free_frac is None
    assert pressure.hbm_free_frac(CPU) is None
    if not torch.cuda.is_available():
        snap = PressureMonitor(cfg, ctrl, device="cuda").sample()
        assert snap.hbm_free_frac is None and "hbm" not in snap.tripped
        assert ctrl.stats()["sample_errors"] == 1


def test_link_rate_from_the_streamed_bytes(model_dir):
    """The link signal is the executor's process streamed-bytes counter's
    rate between samples, only while bytes flow."""
    cfg = _fw(model_dir, pressure=_pcfg(link_min_gbps=1e6))
    total = [0]
    mon = PressureMonitor(cfg, BrownoutController(cfg), link_bytes_fn=lambda: total[0])
    assert mon.sample().link_gbps is None  # no window yet
    total[0] = 1000
    time.sleep(0.01)
    snap = mon.sample()
    assert snap.link_gbps is not None and snap.link_gbps > 0 and "link" in snap.tripped
    assert mon.sample().link_gbps is None  # idle: no rate
    before = pressure.PressureMonitor._default_link_bytes()
    StreamingExecutor(_fw(model_dir), device=CPU, tokenizer=FakeTokenizer())(PROMPTS[:1])
    assert pressure.PressureMonitor._default_link_bytes() > before


# ---------------------------------------------------------------------------
# The ladder
# ---------------------------------------------------------------------------

class _FakeQueue:
    def __init__(self):
        self.shedding = False
        self.retry_after = None

    def set_shedding(self, retry_after_s, on_shed=None):
        self.shedding = True
        self.retry_after = retry_after_s

    def clear_shedding(self):
        self.shedding = False


class _FakeFleet:
    def __init__(self):
        self.drained = 0
        self.restored = 0

    def pressure_drain(self, keep=1):
        self.drained += 1
        return 2

    def pressure_restore(self):
        self.restored += 1
        return 2


class _FakeSpecCtrl:
    def __init__(self):
        self.backed_off = False
        self.backoffs = 0
        self.restores = 0

    def pressure_backoff(self):
        self.backed_off = True
        self.backoffs += 1

    def pressure_restore(self):
        self.backed_off = False
        self.restores += 1


def _pressured():
    return PressureSnapshot(tripped=frozenset({"host"}))


def _jpressured():
    return jpressure.PressureSnapshot(tripped=frozenset({"host"}))


# A scripted poll sequence: "p" a tripped threshold, "c" a clean poll, "h"/"d"
# a hard host_oom/disk_full event before a clean poll, "x" an unknown event.
LADDER_SCRIPTS = {
    "walk_up_and_down": "p" * 9 + "c" * 16,
    "event_jump": "h" + "c" * 3 + "p" + "c" * 14,
    "mixed": "pcpcp" + "d" + "pp" + "c" * 5 + "x" + "c" * 12,
}


def _drive_ladder(mod, cfg, script):
    cache = mod is pressure and hostcache or jhostcache
    cache.cache_for(cfg)
    ctrl = mod.BrownoutController(cfg)
    q, fleet, spec = _FakeQueue(), _FakeFleet(), _FakeSpecCtrl()
    ctrl.attach_queue(q)
    ctrl.attach_fleet(fleet)
    ctrl.attach_spec(spec)
    trace = []
    for step in script:
        if step in "hdx":
            ctrl.note_event({"h": "host_oom", "d": "disk_full", "x": "typo"}[step])
        snap = mod.PressureSnapshot(tripped=frozenset({"host"}) if step == "p" else frozenset())
        ctrl.on_sample(snap)
        trace.append((ctrl.level, q.shedding, q.retry_after, spec.backed_off, fleet.drained,
                      fleet.restored, cache.process_cache().budget_bytes, cache.pressure_cap()))
    return trace, ctrl.stats()


def _pressure_instants(tracer) -> list:
    """The tracer's ``pressure`` instants as (name, attributes), times left out."""
    drop = ("name", "cat", "ts_s", "tid")
    return [(e["name"], {k: v for k, v in e.items() if k not in drop})
            for e in tracer.snapshot() if e["cat"] == "pressure"]


@pytest.mark.parametrize("name", sorted(LADDER_SCRIPTS))
def test_ladder_walks_up_engages_in_order_and_reverses(name, model_dir):
    """The same scripted snapshots and events give the same level, levers,
    cache budget and cap after every poll, the same stats(), and the same
    trace instants: a ``pressure_step`` per move, a ``pressure_event`` per
    hard event."""
    pcfg, jcfg = _both(model_dir, host_cache_gb=0.001, pressure={})
    tracers = (ptrace.TRACER, jtrace.TRACER)
    for t in tracers:
        t.clear()
        t.enable()
    try:
        trace, stats = _drive_ladder(pressure, pcfg, LADDER_SCRIPTS[name])
        jtrace_, jstats = _drive_ladder(jpressure, jcfg, LADDER_SCRIPTS[name])
        instants, jinstants = (_pressure_instants(t) for t in tracers)
    finally:
        for t in tracers:
            t.disable()
            t.clear()
    assert trace == jtrace_
    assert {k: v for k, v in stats.items() if k not in PORT_ONLY} == jstats
    assert stats["sample_errors"] == stats["lever_errors"] == 0
    assert instants == jinstants
    names = [n for n, _ in instants]
    assert names.count("pressure_step") == stats["steps_up"] + stats["steps_down"]
    assert names.count("pressure_event") == stats["host_oom_events"] + stats["disk_full_events"]
    assert trace[-1][0] == 0 and max(t[0] for t in trace) >= 6


def test_a_failing_lever_is_counted_and_the_level_holds(model_dir):
    """A lever that raises (a fleet mid-teardown) does not stop the ladder:
    the level is taken, the failure counted in ``lever_errors``."""
    class _Broken(_FakeFleet):
        def pressure_drain(self, keep=1):
            raise RuntimeError("fleet mid-teardown")

    ctrl = BrownoutController(_fw(model_dir, pressure=_pcfg(step_down_polls=1)))
    ctrl.attach_fleet(_Broken())
    for _ in range(7):
        ctrl.on_sample(_pressured())
    assert ctrl.level == 7 and ctrl.stats()["lever_errors"] == 1
    for _ in range(7):
        ctrl.on_sample(PressureSnapshot())
    assert ctrl.level == 0 and ctrl.stats()["replica_restores"] == 2


def test_hard_event_jumps_straight_to_shed_level(model_dir):
    for mod, cfg in zip((pressure, jpressure), _both(model_dir, pressure={})):
        ctrl = mod.BrownoutController(cfg)
        q = _FakeQueue()
        ctrl.attach_queue(q)
        ctrl.note_event("host_oom")
        ctrl.on_sample(mod.PressureSnapshot())
        assert ctrl.level == ctrl._level_of("shed") == 6 and q.shedding
        assert ctrl.stats()["host_oom_events"] == 1 and ctrl.stats()["steps_up"] == 6


def test_queue_attached_mid_brownout_sheds_immediately(model_dir):
    for mod, cfg in zip((pressure, jpressure), _both(model_dir, pressure={})):
        ctrl = mod.BrownoutController(cfg)
        ctrl.note_event("disk_full")
        ctrl.on_sample(mod.PressureSnapshot())
        late = _FakeQueue()
        ctrl.attach_queue(late)
        assert late.shedding
        ctrl.detach_queue(late)
        assert not late.shedding


def test_spec_ctrl_attached_mid_brownout_backs_off_immediately(model_dir):
    for mod, cfg in zip((pressure, jpressure), _both(model_dir, pressure={})):
        ctrl = mod.BrownoutController(cfg)
        ctrl.on_sample(mod.PressureSnapshot(tripped=frozenset({"disk"})))
        late = _FakeSpecCtrl()
        ctrl.attach_spec(late)
        assert late.backed_off
        ctrl.detach_spec(late)
        assert not late.backed_off
        with pytest.raises(ValueError):
            ctrl.at_or_above("no_such_stage")


def test_note_event_unknown_kind_is_dropped(model_dir):
    out = []
    for mod, cfg in zip((pressure, jpressure), _both(model_dir, pressure={})):
        ctrl = mod.BrownoutController(cfg)
        ctrl.note_event("typo_kind")
        ctrl.on_sample(mod.PressureSnapshot())
        first = (ctrl.level, ctrl.stats()["link_events"])
        ctrl.on_sample(mod.PressureSnapshot(tripped=frozenset({"link"})))
        out.append((first, ctrl.level, ctrl.stats()["link_events"]))
    assert out[0] == out[1] == ((0, 0), 1, 1)
    # The module-level note journals a hard event with or without a ladder,
    # as JAX's does, and drops an unknown kind.
    journals = (pevents.JOURNAL, jevents.JOURNAL)
    tails = []
    for mod, journal in zip((pressure, jpressure), journals):
        journal.close()
        journal.configure(tempfile.mkdtemp())
        try:
            mod.note_event("typo_kind")
            mod.note_event("host_oom")
            tails.append([(e["kind"], e["severity"], e["resource"]) for e in journal.tail()])
        finally:
            journal.close()
    assert tails[0] == tails[1] == [("pressure_event", "error", "host_oom")]
    assert pressure.process_events() == {"host_oom": 1, "disk_full": 0}


def test_controller_for_is_a_process_singleton_and_reset_releases(model_dir):
    cfg = _fw(model_dir, host_cache_gb=0.001, pressure=_pcfg(poll_s=30.0))
    assert pressure.controller_for(_fw(model_dir)) is None  # pressure off
    ctrl = pressure.controller_for(cfg)
    assert ctrl is pressure.controller_for(cfg) is pressure.process_controller()
    before = hostcache.cache_for(cfg).budget_bytes
    pressure.note_event("host_oom")  # reaches the process controller
    ctrl.on_sample(PressureSnapshot())
    assert ctrl.level == 6 and hostcache.process_cache().budget_bytes < before
    pressure.reset_process_pressure()
    assert pressure.process_controller() is None and ctrl.level == 0
    assert hostcache.process_cache().budget_bytes == before and hostcache.pressure_cap() is None


# ---------------------------------------------------------------------------
# The levers
# ---------------------------------------------------------------------------

def _cap_script(mod, model_dir, port):
    big = mod.cache_for(_fw(model_dir, port, host_cache_gb=0.001))
    before = big.budget_bytes
    prev = mod.apply_pressure_cap(0.5)
    steps = [prev == before, big.budget_bytes, mod.cache_for(_fw(model_dir, port)).budget_bytes,
             mod.cache_for(_fw(model_dir, port, host_cache_gb=0.002)).budget_bytes,
             mod.pressure_cap()]
    mod.lift_pressure_cap(prev)
    steps += [big.budget_bytes, mod.pressure_cap()]
    mod.reset_process_cache()
    pinned = mod.cache_for(_fw(model_dir, port, host_cache_gb=0.004))
    pre = pinned.budget_bytes
    mod.apply_pressure_cap(0.5)
    mod.cache_for(_fw(model_dir, port, host_cache_gb=0.001))
    mod.lift_pressure_cap(pre)
    steps.append(pinned.budget_bytes)
    return steps


def test_cache_for_cannot_grow_past_pressure_cap(model_dir):
    """Mid-brownout resolutions, explicit or auto, stay capped, and the lift
    installs the intended budget (an explicit pin given meanwhile wins)."""
    steps = _cap_script(hostcache, model_dir, True)
    assert steps == _cap_script(jhostcache, model_dir, False)
    assert steps[1] == int(0.001e9) // 2 and steps[5] == int(0.002e9)
    assert steps[-1] == int(0.001e9)


def test_lift_pressure_cap_honors_mid_brownout_explicit_pin(model_dir):
    for mod, port in ((hostcache, True), (jhostcache, False)):
        big = mod.cache_for(_fw(model_dir, port, host_cache_gb=0.004))
        pre = big.budget_bytes
        mod.apply_pressure_cap(0.5)
        assert big.budget_bytes == pre // 2
        assert mod.cache_for(_fw(model_dir, port, host_cache_gb=0.001)) is big
        mod.lift_pressure_cap(pre)
        assert big.budget_bytes == int(0.001e9)
        mod.reset_process_cache()


def _tier_script(mod, model_dir, port):
    names = layer_names_for(N_LAYERS)
    cfg = _fw(model_dir, port, hbm_pin_gb=1.0)
    tier = mod.tier_for(cfg, names, False, CPU) if port else mod.tier_for(cfg, names, False)
    planned = len(tier.plan.pinned)
    out = [planned > 0, tier.pressure_unpin(), list(tier.plan.pinned), tier.pressure_demoted,
           sorted(tier.frozen_pinned([range(len(names))])), tier.stats()["pressure_demoted"]]
    again = mod.tier_for(cfg, names, False, CPU) if port else mod.tier_for(cfg, names, False)
    out += [again is tier, list(tier.plan.pinned), tier.pressure_unpin(), tier.pressure_restore(),
            len(tier.plan.pinned), tier.pressure_demoted, tier.pressure_restore()]
    return out


def test_residency_pressure_unpin_and_restore(model_dir):
    got = _tier_script(residency, model_dir, True)
    assert got == _tier_script(jresidency, model_dir, False)
    assert got[0] and got[1] == got[10] > 0


def test_residency_unpin_drops_the_placed_pins(model_dir):
    """Unlike the JAX tier, the port's drops its placed trees (the card's
    memory frees with the last reference); a live source streams its
    frozen pins meanwhile with the same scores, and the restored plan
    reloads them on request."""
    cfg = _fw(model_dir, hbm_pin_gb=1.0)
    clean = StreamingExecutor(_fw(model_dir), device=CPU, tokenizer=FakeTokenizer())(PROMPTS)
    ex = StreamingExecutor(cfg, device=CPU, tokenizer=FakeTokenizer())
    first = ex(PROMPTS)
    tier = residency.process_tier()
    held = tier.stats()
    assert held["pinned_bytes"] > 0 and held["pinned_layers"] == held["planned_layers"]
    source, _ = ex.weight_source()  # frozen with its pins
    try:
        assert tier.pressure_unpin() == held["planned_layers"]
        assert tier.stats()["pinned_bytes"] == 0 and tier.stats()["pinned_layers"] == 0
        streamed = list(source)  # streams the frozen pins, seats nothing
        assert tier.stats()["pinned_layers"] == 0 and len(streamed) == len(ex.plan.shards)
    finally:
        source.close()
    assert len(ex(PROMPTS)) == len(PROMPTS)
    tier.pressure_restore()
    again = ex(PROMPTS)
    assert tier.stats()["pinned_layers"] == held["planned_layers"]
    for a, b, c in zip(clean, first, again):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_install_plan_refused_while_pressure_demoted(model_dir):
    names = layer_names_for(N_LAYERS)
    for mod, port in ((residency, True), (jresidency, False)):
        cfg = _fw(model_dir, port, hbm_pin_gb=1.0)
        tier = mod.tier_for(cfg, names, False, CPU) if port else mod.tier_for(cfg, names, False)
        stale = tier.plan
        assert tier.pressure_unpin() > 0
        tier._install_plan(stale)
        assert not tier.plan.pinned
        tier.pressure_restore()
        assert tier.plan.pinned
        mod.reset_process_tier()


def _req(mod, prefix="p", suffixes=("s",), max_new_tokens=1, **kw):
    return mod.Request(prefix=prefix, suffixes=suffixes, max_new_tokens=max_new_tokens, **kw)


def test_queue_shed_overloaded_typed_and_reversible():
    out = []
    for qmod, rmod in ((None, None), (jqueue, jrequest)):
        Q = AdmissionQueue if qmod is None else qmod.AdmissionQueue
        R = Request if rmod is None else rmod.Request
        Ov = Overloaded if rmod is None else rmod.Overloaded
        shed = [0]
        q = Q(4)
        q.set_shedding(2.5, on_shed=lambda: shed.__setitem__(0, shed[0] + 1))
        assert q.shedding
        r = q.submit(R(prefix="p", suffixes=("s",), max_new_tokens=1))
        with pytest.raises(Ov) as ei:
            r.future.result(timeout=0)
        first = (r.status.value, ei.value.retry_after_s, str(ei.value), shed[0], len(q))
        q.clear_shedding()
        r2 = q.submit(R(prefix="p", suffixes=("s",), max_new_tokens=1))
        out.append((first, r2.status.value, len(q), q.shedding))
    assert out[0] == out[1]
    assert out[0][0][:2] == ("rejected", 2.5) and out[0][1] == "queued"
    assert issubclass(Overloaded, QueueFull)


def test_shed_exempt_redispatch_bypasses_shedding():
    q = AdmissionQueue(4)
    q.set_shedding(1.0)
    assert q.submit(Request(prefix="p", suffixes=("s",), max_new_tokens=1,
                            shed_exempt=True)).status is RequestStatus.QUEUED
    assert q.submit(Request(prefix="p", suffixes=("s",),
                            max_new_tokens=1)).status is RequestStatus.REJECTED


def test_queue_size_cap_rejects_typed_at_admission():
    q = AdmissionQueue(4, max_request_tokens=10, size_fn=lambda r: len(r.prefix) + r.max_new_tokens)
    big = q.submit(Request(prefix="x" * 100, suffixes=("s",), max_new_tokens=1))
    with pytest.raises(RequestTooLarge):
        big.future.result(timeout=0)
    assert q.submit(Request(prefix="xx", suffixes=("s",),
                            max_new_tokens=1)).status is RequestStatus.QUEUED

    def boom(r):
        raise ValueError("tokenizer edge case")

    q2 = AdmissionQueue(4, max_request_tokens=10, size_fn=boom)
    assert q2.submit(Request(prefix="x" * 100, suffixes=("s",),
                             max_new_tokens=1)).status is RequestStatus.QUEUED


def test_spill_write_atomic_enospc_typed_and_clean(tmp_path):
    """Persistent ENOSPC: a typed ``DiskFullError`` naming the file, with
    neither the file nor its temp left (the port fires the site inside the
    temp write); a bounded outage retries and the file lands whole. JAX's
    store takes the same draws."""
    arr = np.arange(16, dtype=np.float32).reshape(4, 4)
    for port in (True, False):
        d = tmp_path / ("port" if port else "jax")
        d.mkdir()
        path = str(d / "suffix-00000.npy")
        for budget in (-1, 1):
            kw = dict(enabled=True, seed=CHAOS_SEED, error_rate=1.0, sites=("disk_full",),
                      max_faults=budget)
            policy = RetryPolicy(max_attempts=3, base_delay_s=0.0)
            if port:
                inj = inject.FaultInjector(FaultConfig(**kw))
                store = ActivationStore("disk", CPU, torch.float32, str(d), injector=inj,
                                        retry_policy=policy)
            else:
                from flexible_llm_sharding_tpu.faults.retry import RetryPolicy as JRetryPolicy

                inj = jinject.FaultInjector(JFaultConfig(**kw))
                store = JActivationStore("disk", str(d), np_dtype=np.dtype(np.float32),
                                         injector=inj,
                                         retry_policy=JRetryPolicy(max_attempts=3,
                                                                   base_delay_s=0.0))
            if budget < 0:
                with pytest.raises(jpressure.DiskFullError if not port else DiskFullError) as ei:
                    store._write_spill(path, arr)
                assert ei.value.errno == errno.ENOSPC and path in str(ei.value)
                assert not os.path.exists(path) and inj.count("disk_full") == 3
            else:
                store._write_spill(path, arr)
                np.testing.assert_array_equal(np.load(path), arr)
                assert inj.count("disk_full") == 1
            assert not any(f.endswith(".tmp") for f in os.listdir(d))
    assert issubclass(DiskFullError, OSError) and issubclass(HostOOMError, OSError)


def test_link_throttle_stalls_never_raises():
    kw = dict(enabled=True, seed=CHAOS_SEED, error_rate=0.5, truncate_rate=0.25,
              latency_rate=0.25, latency_s=0.0, sites=("link_throttle",))
    ours = inject.FaultInjector(FaultConfig(**kw))
    theirs = jinject.FaultInjector(JFaultConfig(**kw))
    for _ in range(64):
        ours.fire("link_throttle")
        theirs.fire("link_throttle")
    assert ours.events == theirs.events and ours.count("link_throttle") > 0


# ---------------------------------------------------------------------------
# The hardened paths end to end
# ---------------------------------------------------------------------------

def test_offline_disk_run_survives_bounded_disk_full(model_dir, tmp_path):
    """A disk-mode run under injected ENOSPC on spill writes: the JAX
    executor's scores (1e-5) and the same spill_write retries, and no temp
    file left."""
    faults = dict(enabled=True, seed=CHAOS_SEED, error_rate=0.3, sites=("disk_full",),
                  max_faults=8)
    got = {}
    for port in (True, False):
        spills = str(tmp_path / ("port" if port else "jax"))
        cfg = _fw(model_dir, port, storage_location="disk", disk_folder=spills,
                  faults=(FaultConfig if port else JFaultConfig)(**faults))
        ex = (StreamingExecutor(cfg, device=CPU, tokenizer=FakeTokenizer()) if port
              else JStreamingExecutor(cfg, tokenizer=FakeTokenizer()))
        scores = ex(list(PROMPTS))
        got[port] = scores, (ex.stats, ex._injector.count("disk_full"))
        assert not any(f.endswith(".tmp") for f in os.listdir(spills))
    (ps, (pstats, pfaults)), (js, (jstats, jfaults)) = got[True], got[False]
    for a, b in zip(ps, js):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert pfaults == jfaults > 0
    assert pstats["io_retries"] == jstats["io_retries"] > 0
    clean = StreamingExecutor(_fw(model_dir), device=CPU, tokenizer=FakeTokenizer())(PROMPTS)
    for a, b in zip(ps, clean):
        np.testing.assert_array_equal(a, b)


def test_serve_survives_bounded_host_oom_token_identical(model_dir, oracle):
    """A budgeted host_oom outage: typed, retried inside the read, counted as
    a pressure event; every request completes with the JAX offline decode's
    tokens."""
    fc = FaultConfig(enabled=True, seed=CHAOS_SEED, error_rate=0.4, sites=("host_oom",),
                     max_faults=6)
    eng = ServeEngine(_fw(model_dir, faults=fc),
                      ServeConfig(max_wave_requests=2, default_max_new_tokens=1),
                      tokenizer=FakeTokenizer(), device=CPU)
    try:
        results = [r.future.result(timeout=60) for r in [eng.submit(p, s) for p, s in PROMPTS]]
    finally:
        eng.shutdown(drain=True)
    assert eng.error is None
    for res, want, upd in zip(results, *oracle):
        _same_as_oracle(res, want, upd)
    assert eng._injector.count("host_oom") > 0
    assert pressure.process_events()["host_oom"] == eng._injector.count("host_oom")
    assert eng.stats()["io_retries"]["shard_read"]["recovered"] > 0


def test_serve_persistent_host_oom_degrades_not_dies(model_dir, oracle):
    """An unbounded OOM storm fails the wave (``WaveAborted`` over the typed
    family) and keeps the engine; once the storm is over (the budget), the
    engine serves the JAX decode's tokens."""
    fc = FaultConfig(enabled=True, seed=CHAOS_SEED, error_rate=1.0, sites=("host_oom",),
                     max_faults=2)
    eng = ServeEngine(_fw(model_dir, faults=fc, io_retry_attempts=2),
                      ServeConfig(max_wave_requests=2, default_max_new_tokens=1),
                      tokenizer=FakeTokenizer(), device=CPU)
    try:
        r = eng.submit(*PROMPTS[0])
        with pytest.raises(WaveAborted) as ei:
            r.future.result(timeout=60)
        assert isinstance(ei.value.__cause__, ShardLoadError)
        assert isinstance(ei.value.__cause__.__cause__, HostOOMError)
        assert eng.error is None
        ok = eng.submit(*PROMPTS[1]).future.result(timeout=60)
    finally:
        eng.shutdown(drain=False)
    _same_as_oracle(ok, oracle[0][1], oracle[1][1])
    assert eng.metrics.counter("engine_recoveries") >= 1


def test_serve_brownout_sheds_then_reverses(model_dir, oracle):
    """A bounded host_oom outage drives the ladder to shed: new submits get
    a typed ``Overloaded`` with the configured retry-after; once the budget
    is spent the ladder steps back to 0, the cache budget is restored, and
    every served request has the JAX decode's tokens. The order is fixed:
    the engine starts after the first request is queued, and the sheds are
    probed only once the queue reports it sheds."""
    fc = FaultConfig(enabled=True, seed=CHAOS_SEED, error_rate=1.0, sites=("host_oom",),
                     max_faults=1)
    eng = ServeEngine(_fw(model_dir, faults=fc, host_cache_gb=0.01,
                          pressure=_pcfg(poll_s=0.02, step_down_polls=3)),
                      ServeConfig(max_wave_requests=2, default_max_new_tokens=1),
                      tokenizer=FakeTokenizer(), device=CPU, start=False)
    ctrl, cache = pressure.process_controller(), hostcache.process_cache()
    assert ctrl is not None and cache is not None
    before = cache.budget_bytes
    served, sheds = [], []
    try:
        first = eng.submit(*PROMPTS[0])
        eng.start()
        deadline = time.monotonic() + 30
        while not eng.queue.shedding and time.monotonic() < deadline:
            time.sleep(0.001)
        assert eng.queue.shedding, "the brownout never shed"
        shed = eng.submit(*PROMPTS[1])
        with pytest.raises(Overloaded) as ei:
            shed.future.result(timeout=5)
        sheds.append(ei.value.retry_after_s)
        served.append((0, first.future.result(timeout=60)))
        while ctrl.level > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ctrl.level == 0 and not eng.queue.shedding
        served.append((2, eng.submit(*PROMPTS[2]).future.result(timeout=60)))
    finally:
        eng.shutdown(drain=True)
    assert eng.error is None and sheds == [0.25]
    stats = eng.stats()["pressure"]
    assert stats["host_oom_events"] == 1 and stats["sheds"] == 1 and stats["cache_shrinks"] == 1
    assert stats["steps_up"] == 6 and stats["steps_down"] == 6
    assert cache.budget_bytes == before and hostcache.pressure_cap() is None
    for i, res in served:
        _same_as_oracle(res, oracle[0][i], oracle[1][i])


def test_fleet_pressure_drain_and_restore(model_dir):
    """The ladder's replica_drain rung drains the fleet to one replica and
    its release restores three; the fleet attached itself to the process
    controller, and the restored fleet serves."""
    cfg = _fw(model_dir, pressure=_pcfg(poll_s=30.0, step_down_polls=1))
    fleet = ReplicaFleet(cfg, ServeConfig(replicas=3, max_wave_requests=2,
                                          default_max_new_tokens=1, router_health_poll_s=0.05),
                         tokenizer=FakeTokenizer(), device=CPU)
    try:
        ctrl = pressure.process_controller()
        assert ctrl is not None and fleet._pressure is ctrl
        for _ in range(7):
            ctrl.on_sample(_pressured())
        deadline = time.monotonic() + 30
        while len(fleet.replicas) > 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(fleet.replicas) == 1 and ctrl.stats()["replica_drains"] == 2
        for _ in range(7):
            ctrl.on_sample(PressureSnapshot())
        while len(fleet.replicas) < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(fleet.replicas) == 3 and ctrl.stats()["replica_restores"] >= 2
        res = fleet.submit(*PROMPTS[0]).future.result(timeout=60)
        assert res.tokens.shape[-1] == 1
    finally:
        fleet.shutdown(drain=True)
    assert ctrl._fleet is None  # detached at shutdown


def test_an_idle_cycling_source_holds_no_shard(model_dir):
    """Between sweeps a cycling source without a prefetch thread holds no
    reference to a shard it handed out: once its consumer drops the
    segments, their tensors are freed (on the card, an idle engine keeps no
    shard's weights, so the ladder's unpinning frees all it can)."""
    import gc
    import weakref

    from flexible_llm_sharding_tpu_torch.runtime.executor import ShardWeightSource, _tree_leaves

    names = layer_names_for(N_LAYERS)
    src = ShardWeightSource(model_dir, names, [(i,) for i in range(len(names))], torch.float32,
                            CPU, prefetch_depth=0, cycle=True)
    try:
        it = iter(src)
        for _ in range(len(names)):
            _, segments = next(it)
            refs = [weakref.ref(t) for t in _tree_leaves([p for _, p in segments])]
            del segments
            gc.collect()
            assert refs and all(r() is None for r in refs)
    finally:
        src.close()
