"""The port's sweep scheduler against the JAX package's, on the CPU in float32.

- The pure pieces on the same inputs: ``SweepScheduler.select`` (strict
  class priority, weighted and unweighted tenants), the token bucket
  (rejection with ``retry_after_s``, refill, refund), the LRU bound on
  tenant state, the queue's scheduler pop, front requeue and
  ``has_waiting``, ``build_entries``, ``SchedConfig`` and the class
  deadlines.
- Engine pairs, each held to the port's own oracle and to the JAX engine
  (tokens equal, scores within 1e-5): a scheduled single-tenant run, a
  coalesced wave, a preempted request resuming, and the starvation case of
  ``tests/test_sched.py``.
- The serve CLI: every ``--sched*`` flag parses into the config the JAX
  parser builds (``--sched_interactive_phase_boost`` too, which the
  replica fleet's router reads).
"""

import threading
import time
from collections import deque

import jax
import numpy as np
import pytest
import torch

from bench import BenchTokenizer
from flexible_llm_sharding_tpu import cli as jcli
from flexible_llm_sharding_tpu import serve as jserve
from flexible_llm_sharding_tpu.config import FrameworkConfig as JFrameworkConfig
from flexible_llm_sharding_tpu.config import LlamaConfig as JLlamaConfig
from flexible_llm_sharding_tpu.config import SchedConfig as JSchedConfig
from flexible_llm_sharding_tpu.config import ServeConfig as JServeConfig
from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu.runtime import kvpool as jkvpool
from flexible_llm_sharding_tpu.serve import queue as jqueue
from flexible_llm_sharding_tpu.serve import request as jrequest
from flexible_llm_sharding_tpu.serve.sched import classes as jclasses
from flexible_llm_sharding_tpu.serve.sched import coalesce as jcoalesce
from flexible_llm_sharding_tpu.serve.sched import scheduler as jscheduler
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu_torch import cli, serve
from flexible_llm_sharding_tpu_torch.config import FrameworkConfig, SchedConfig, ServeConfig
from flexible_llm_sharding_tpu_torch.runtime import kvpool
from flexible_llm_sharding_tpu_torch.runtime.decode import DecodeGenerator
from flexible_llm_sharding_tpu_torch.serve import queue, request
from flexible_llm_sharding_tpu_torch.serve.batcher import _CLASS_RANK
from flexible_llm_sharding_tpu_torch.serve.sched import classes, coalesce, scheduler
from flexible_llm_sharding_tpu_torch.utils.metrics import SLO_CLASS_NAMES

ATOL = 1e-5
N_GEN = 3

# The port's modules and the JAX package's, by side.
SIDES = {
    "port": (scheduler, queue, request, classes, coalesce, SchedConfig),
    "jax": (jscheduler, jqueue, jrequest, jclasses, jcoalesce, JSchedConfig),
}


class _Vocab256(BenchTokenizer):
    VOCAB = 256


PROMPTS = [
    ("the cat sat on the mat", (" then left", " then slept")),
    ("two plus two equals", (" four", " five")),
    ("the sky is", (" blue", " green")),
    ("hello world", (" again", " anew")),
]


@pytest.fixture(autouse=True)
def _fresh_pools():
    kvpool.reset_process_pools()
    jkvpool.reset_process_pools()
    yield
    kvpool.reset_process_pools()
    jkvpool.reset_process_pools()


def _req(side, slo="standard", tenant="default", deadline=None):
    return SIDES[side][2].Request(prefix="p", suffixes=("s",), max_new_tokens=1,
                                  deadline=deadline, slo_class=slo, tenant_id=tenant)


# ---------------------------------------------------------------------------
# The pure pieces
# ---------------------------------------------------------------------------

def test_class_taxonomy_and_mirrors():
    assert tuple(SLO_CLASS_NAMES) == classes.SLO_CLASSES == jclasses.SLO_CLASSES
    assert _CLASS_RANK == classes.CLASS_RANK
    err = classes.RateLimited("m", retry_after_s=0.5, tenant="t")
    assert isinstance(err, request.QueueFull)
    assert (err.retry_after_s, err.tenant) == (0.5, "t")


def _select_script(side, weights, arrivals, budgets):
    """Picks of successive boundaries as (arrival index) lists, and the
    scheduler's stats."""
    mod, cfg_cls = SIDES[side][0], SIDES[side][5]
    sched = mod.SweepScheduler(cfg_cls(enabled=True, tenant_weights=weights))
    reqs = [_req(side, slo, tenant) for slo, tenant in arrivals]
    index = {id(r): i for i, r in enumerate(reqs)}
    items = deque(reqs)
    picks = [[index[id(r)] for r in sched.select(items, n)] for n in budgets]
    return picks, sched.stats()


SELECT_CASES = {
    "strict_priority": ("", [("best_effort", "a"), ("standard", "a"), ("interactive", "a"),
                             ("best_effort", "b"), ("interactive", "b")], [8, 1, 8]),
    "weighted": ("a=2,b=1", [("standard", "a")] * 4 + [("standard", "b")] * 4, [6, 2]),
    "unweighted": ("", [("standard", "x")] * 6 + [("standard", "y")] * 6, [6, 3, 3]),
    "fractional": ("a=0.5,b=1.5,c=1", [("standard", t) for t in "abcabcabcabc"], [3, 3, 3, 3]),
}


@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_select_matches_jax(case):
    weights, arrivals, budgets = SELECT_CASES[case]
    port = _select_script("port", weights, arrivals, budgets)
    assert port == _select_script("jax", weights, arrivals, budgets)
    if case == "weighted":
        assert port[0][0] == [0, 1, 4, 2, 3, 5]  # 2:1 shares, interleaved


def _bucket_script(side):
    mod = SIDES[side][0]
    b = mod._TokenBucket(rate=2.0, burst=2.0)
    b.last = 100.0
    return [b.try_take(t) for t in (100.0, 100.0, 100.0, 100.25, 100.5, 100.5, 99.0, 103.0)]


def test_token_bucket_matches_jax():
    port = _bucket_script("port")
    assert port == _bucket_script("jax")
    assert port[:2] == [None, None] and port[2] == pytest.approx(0.5)


def _rate_script(side):
    """A limited tenant's burst of 2 against a queue of capacity 1: its
    backpressure rejections give their tokens back, so after the pop one
    submit is admitted and the next is rate limited."""
    mod, qmod, rmod, _, _, cfg_cls = SIDES[side]
    sched = mod.SweepScheduler(cfg_cls(enabled=True, tenant_limits="t=0.001", tenant_burst=2.0))
    q = qmod.AdmissionQueue(capacity=1, scheduler=sched)
    out = []

    def submit(tenant):
        r = q.submit(_req(side, tenant=tenant))
        err = r.future.exception(timeout=1) if r.status.terminal else None
        out.append((r.status.value, type(err).__name__ if err else None,
                    getattr(err, "tenant", None), getattr(err, "retry_after_s", None) is not None))

    for tenant in ("t", "t", "t", "u"):
        submit(tenant)
    q.pop_wave(1)
    submit("t")
    submit("t")
    return out, sched.stats()


def test_rate_limits_and_refund_match_jax():
    port = _rate_script("port")
    assert port == _rate_script("jax")
    outcomes, stats = port
    assert [o[1] for o in outcomes] == [None, "QueueFull", "QueueFull", "QueueFull", None,
                                        "RateLimited"]
    assert outcomes[-1] == ("rejected", "RateLimited", "t", True)
    assert stats["rate_limited"] == 1 and stats["tenants"]["t"]["rate_limited"] == 1


def test_rate_limit_refills_over_time():
    out = {}
    for side in SIDES:
        mod, qmod, _, _, _, cfg_cls = SIDES[side]
        q = qmod.AdmissionQueue(capacity=16, scheduler=mod.SweepScheduler(
            cfg_cls(enabled=True, tenant_limits="t=50", tenant_burst=1.0)))
        got = [q.submit(_req(side, tenant="t")).status.value for _ in range(2)]
        time.sleep(0.05)  # 50 per second: a token in 20 ms
        got.append(q.submit(_req(side, tenant="t")).status.value)
        out[side] = got
    assert out["port"] == out["jax"] == ["queued", "rejected", "queued"]


@pytest.mark.parametrize("side", sorted(SIDES))
def test_tenant_state_is_lru_bounded(side, monkeypatch):
    mod, cfg_cls = SIDES[side][0], SIDES[side][5]
    monkeypatch.setattr(mod, "_MAX_TENANT_STATE", 3)
    sched = mod.SweepScheduler(cfg_cls(enabled=True))
    sched.select(deque(_req(side, tenant=f"t{i}") for i in range(8)), 8)
    st = sched.stats()
    assert (st["tenants_evicted"], sorted(st["tenants"])) == (5, ["t5", "t6", "t7"])


def _queue_script(side):
    mod, qmod, _, _, _, cfg_cls = SIDES[side]
    q = qmod.AdmissionQueue(capacity=2, scheduler=mod.SweepScheduler(cfg_cls(enabled=True)))
    be = [_req(side, "best_effort") for _ in range(2)]
    ia = _req(side, "interactive")
    late = _req(side, "interactive", deadline=time.monotonic() + 0.02)
    names = {id(r): n for n, r in zip(("be0", "be1", "ia", "late"), (*be, ia, late))}
    out = [q.submit(r).status.value for r in (*be, ia)]  # capacity 2: ia refused
    out.append(q.has_waiting("interactive"))
    first = q.pop_wave(1)
    out.append([names[id(r)] for r in first])
    q.submit(late)
    out.append(q.has_waiting("interactive"))
    time.sleep(0.04)
    out.append(q.has_waiting("interactive"))  # expired waiters do not count
    q.requeue(first)  # front, past capacity
    out.append(len(q))
    out.append([names[id(r)] for r in q.pop_wave(3)])
    return out


def test_queue_pop_requeue_and_has_waiting_match_jax():
    port = _queue_script("port")
    assert port == _queue_script("jax")
    assert port[-1] == ["be0", "be1"]


def _entries(side, reqs_spec):
    _, _, rmod, _, cmod, _ = SIDES[side]
    reqs = []
    for prefix, suffixes, resume in reqs_spec:
        r = rmod.Request(prefix=prefix, suffixes=suffixes, max_new_tokens=2)
        r.resume_tokens.extend(np.zeros(len(suffixes), np.int64) for _ in range(resume))
        reqs.append(r)
    index = {id(r): i for i, r in enumerate(reqs)}

    def key_fn(prefix):
        if prefix == "bad":
            raise ValueError("tokenizer edge case")
        return tuple(prefix.split())

    return [(e.prefix, e.suffixes, e.slices, [index[id(r)] for r in e.requests])
            for e in cmod.build_entries(reqs, key_fn)]


def test_build_entries_matches_jax():
    spec = [("a b", ("x", "y"), 0), ("c", ("z",), 0), ("a  b", ("w",), 0), ("a b", ("v",), 1),
            ("bad", ("u",), 0), ("bad", ("t",), 0), ("c", ("s", "r"), 0)]
    port = _entries("port", spec)
    assert port == _entries("jax", spec)
    assert port[0] == ("a b", ("x", "y", "w"), [(0, 2), (2, 1)], [0, 2])
    assert len(port) == 5  # the resume and the key failures stay alone


SCHED_CONFIGS = [
    dict(tenant_weights="a"), dict(tenant_weights="a=0"), dict(tenant_weights="a=2e6"),
    dict(tenant_limits="a=-1"), dict(tenant_burst=0.5), dict(standard_deadline_s=-1.0),
    dict(tenant_weights="a=2, b=1", tenant_limits="a=3"),
]


@pytest.mark.parametrize("kw", SCHED_CONFIGS, ids=[str(k) for k in SCHED_CONFIGS])
def test_sched_config_validates_as_jax(kw):
    def outcome(cls):
        try:
            c = cls(enabled=True, **kw)
        except ValueError as e:
            return str(e)
        return c.tenant_weight_map(), c.tenant_limit_map()

    assert outcome(SchedConfig) == outcome(JSchedConfig)


def test_class_deadlines_match_jax():
    for cfg_kw in (dict(enabled=True, interactive_deadline_s=5.0, best_effort_deadline_s=0.5),
                   dict(interactive_deadline_s=5.0)):
        for cls in classes.SLO_CLASSES:
            assert (classes.class_deadline_s(SchedConfig(**cfg_kw), cls)
                    == jclasses.class_deadline_s(JSchedConfig(**cfg_kw), cls))
    assert classes.class_deadline_s(SchedConfig(enabled=True, interactive_deadline_s=5.0),
                                    "interactive") == 5.0


# ---------------------------------------------------------------------------
# Engine pairs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("sched_model")
    cfg = JLlamaConfig.from_hf_config(dict(
        model_type="llama", vocab_size=256, hidden_size=64, intermediate_size=128,
        max_position_embeddings=512, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2))
    params = jllama.init_params(jax.random.PRNGKey(5), cfg)
    jckpt.save_params(jax.tree.map(np.asarray, params), str(d), cfg)
    return str(d)


def _fw(model_dir, side, **kw):
    common = dict(model_path=model_dir, dtype="float32", bucket_multiple=8, block_size=2,
                  prefetch_depth=0, **kw)
    return FrameworkConfig(device="cpu", **common) if side == "port" else JFrameworkConfig(**common)


def _engine(model_dir, side, start=True, fw_kw=None, **serve_kw):
    sched = serve_kw.pop("sched", None)
    if side == "port":
        sc = ServeConfig(sched=SchedConfig(**sched) if sched is not None else SchedConfig(),
                         **serve_kw)
        return serve.ServeEngine(_fw(model_dir, side, **(fw_kw or {})), sc, tokenizer=_Vocab256(),
                                 device=torch.device("cpu"), start=start)
    sc = JServeConfig(sched=JSchedConfig(**sched) if sched is not None else JSchedConfig(),
                      **serve_kw)
    return jserve.ServeEngine(_fw(model_dir, side, **(fw_kw or {})), sc, tokenizer=_Vocab256(),
                              start=start)


def _oracle(model_dir, prompts, n_gen):
    gen = DecodeGenerator(_fw(model_dir, "port", kv_cache=True, num_gen_token=n_gen),
                          torch.device("cpu"), tokenizer=_Vocab256())
    return gen(list(prompts))


def _same(res, scores, updated, atol=ATOL):
    assert res.updated == updated
    assert (res.tokens == scores.argmax(-1)).all()
    np.testing.assert_allclose(res.scores, scores, atol=atol, rtol=0)


def _wait_prefills(engine, n=1):
    deadline = time.monotonic() + 120
    while engine.metrics.counter("prefills") < n:
        assert time.monotonic() < deadline, "the first wave never prefilled"
        time.sleep(0.002)


def _hold_after_first_prefill(engine) -> threading.Event:
    """Keep the engine's loop at the end of its first prefill sweep until
    the returned event is set, so the requests a test submits next are
    queued before the next boundary, not raced against the running waves."""
    gate = threading.Event()
    real = engine._post_sweep

    def post_sweep(wall):
        real(wall)
        if engine.metrics.counter("prefills") >= 1:
            gate.wait(timeout=120)

    engine._post_sweep = post_sweep
    return gate


def test_single_tenant_parity_matches_jax(model_dir):
    """Scheduling changes when, never what: a scheduled single-tenant run is
    bit-equal to the default engine's on the port, and equal to JAX's."""
    runs = {}
    for side, sched in (("port", None), ("port_sched", {"enabled": True}),
                        ("jax", {"enabled": True})):
        engine = _engine(model_dir, "jax" if side == "jax" else "port", max_wave_requests=2,
                         default_max_new_tokens=N_GEN, sched=sched)
        try:
            runs[side] = [engine.submit(p, s).future.result(timeout=120) for p, s in PROMPTS]
        finally:
            engine.shutdown(drain=True)
        assert engine.error is None
    for a, b, j in zip(runs["port"], runs["port_sched"], runs["jax"]):
        assert a.updated == b.updated and np.array_equal(a.scores, b.scores)
        _same(b, j.scores, j.updated)


@pytest.mark.parametrize("pool", ["on", "off"])
def test_coalesced_wave_matches_jax_and_oracle(model_dir, pool):
    """Four same-prefix requests queued before the first boundary share one
    entry and one prefill; each scores what it scores alone; the savings
    (the pool's page bytes, or the shapes' estimate with the pool off)
    equal JAX's."""
    prefix = "shared system prompt answer briefly"
    suffix_sets = [(" paris", " rome"), (" four", " five"), (" blue", " green"),
                   (" again", " anew")]
    fw_kw = {} if pool == "on" else {"kv_pool_gb": 0.0}
    o_scores, o_updated = _oracle(model_dir, [(prefix, s) for s in suffix_sets], N_GEN)
    out = {}
    for side in ("port", "jax"):
        engine = _engine(model_dir, side, start=False, fw_kw=fw_kw, max_wave_requests=4,
                         default_max_new_tokens=N_GEN, sched={"enabled": True})
        try:
            reqs = [engine.submit(prefix, s) for s in suffix_sets]
            engine.start()
            res = [r.future.result(timeout=120) for r in reqs]
        finally:
            engine.shutdown(drain=True)
        assert engine.error is None
        out[side] = (res, engine.metrics.counter("prefills"), engine._sched.stats())
    (p_res, p_prefills, p_sched), (j_res, j_prefills, j_sched) = out["port"], out["jax"]
    for p, j, s, u in zip(p_res, j_res, o_scores, o_updated):
        _same(p, s, u)
        _same(p, j.scores, j.updated)
    assert p_prefills == j_prefills == 1
    assert p_sched["coalesced_requests"] == j_sched["coalesced_requests"] == 4
    assert p_sched["prefill_kv_bytes_saved"] == j_sched["prefill_kv_bytes_saved"] > 0


def _preempt_run(model_dir, side, n_long):
    engine = _engine(model_dir, side, start=False, max_wave_requests=1, max_active_requests=1,
                     default_max_new_tokens=N_GEN, sched={"enabled": True})
    held = _hold_after_first_prefill(engine)
    engine.start()
    try:
        victim = engine.submit(*PROMPTS[0], max_new_tokens=n_long, slo_class="best_effort",
                               tenant_id="batch")
        _wait_prefills(engine)
        urgent = engine.submit(*PROMPTS[1], max_new_tokens=1, slo_class="interactive",
                               tenant_id="live")
        held.set()
        urgent_res = urgent.future.result(timeout=120)
        victim_res = victim.future.result(timeout=120)
    finally:
        engine.shutdown(drain=True)
    assert engine.error is None
    assert urgent.finished_at < victim.finished_at
    return victim_res, urgent_res, engine._sched.stats()


def test_preempted_request_resumes_token_identical(model_dir):
    """An interactive arrival retires the best-effort wave at a boundary;
    the victim's whole stream equals its uninterrupted run (the oracle) and
    JAX's preempted run."""
    n_long = 8
    o_scores, o_updated = _oracle(model_dir, [PROMPTS[0]], n_long)
    p_victim, p_urgent, p_stats = _preempt_run(model_dir, "port", n_long)
    j_victim, j_urgent, j_stats = _preempt_run(model_dir, "jax", n_long)
    _same(p_victim, o_scores[0], o_updated[0])
    _same(p_victim, j_victim.scores, j_victim.updated)
    _same(p_urgent, j_urgent.scores, j_urgent.updated)
    assert p_urgent.tokens.shape[1] == 1
    assert p_stats["preemptions"] >= 1 and j_stats["preemptions"] >= 1
    assert p_stats["preempted_requests"] >= 1


def test_starvation_bounded_and_backlog_completes(model_dir):
    """One saturating best-effort tenant against interactive arrivals: each
    interactive request finishes before the backlog's last, by preemption,
    and every best-effort stream resumes token for token (oracle and JAX)."""
    be_tokens = 6
    o_scores, _ = _oracle(model_dir, PROMPTS, be_tokens)
    out = {}
    for side in ("port", "jax"):
        engine = _engine(model_dir, side, start=False, max_wave_requests=1,
                         max_active_requests=1, default_max_new_tokens=N_GEN,
                         sched={"enabled": True})
        held = _hold_after_first_prefill(engine)
        engine.start()
        try:
            be = [engine.submit(p, s, max_new_tokens=be_tokens, slo_class="best_effort",
                                tenant_id="batch") for p, s in PROMPTS]
            _wait_prefills(engine)
            ia = [engine.submit(p, s, max_new_tokens=1, slo_class="interactive",
                                tenant_id="live") for p, s in PROMPTS[:2]]
            held.set()
            ia_res = [r.future.result(timeout=120) for r in ia]
            be_res = [r.future.result(timeout=120) for r in be]
        finally:
            engine.shutdown(drain=True)
        assert engine.error is None
        last_be = max(r.finished_at for r in be)
        assert all(r.finished_at < last_be for r in ia)
        stats = engine.stats()
        assert stats["ttft_by_class"]["interactive"]["count"] == 2
        assert engine._sched.stats()["preemptions"] >= 1
        out[side] = (ia_res, be_res)
    for p, j in zip(out["port"][0] + out["port"][1], out["jax"][0] + out["jax"][1]):
        _same(p, j.scores, j.updated)
    for res, s in zip(out["port"][1], o_scores):
        assert (res.tokens == s.argmax(-1)).all()
        np.testing.assert_allclose(res.scores, s, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# The serve CLI
# ---------------------------------------------------------------------------

SCHED_FLAGS = [
    ["--sched"],
    ["--sched", "--sched_interactive_deadline_s", "2.5"],
    ["--sched", "--sched_standard_deadline_s", "3"],
    ["--sched", "--sched_best_effort_deadline_s", "9"],
    ["--sched", "--sched_tenant_weights", "a=4,b=1"],
    ["--sched", "--sched_tenant_limits", "a=5"],
    ["--sched", "--sched_tenant_burst", "2"],
    ["--sched", "--sched_preempt", "false"],
    ["--sched", "--sched_coalesce", "false"],
    ["--sched", "--sched_interactive_phase_boost", "3"],
    ["--sched", "--sched_interactive_phase_boost", "0.5"],  # refused by both
    ["--sched_tenant_weights", "a=4"],  # parsed, inert without --sched
    ["--sched", "--sched_tenant_weights", "a=0"],  # refused by both
]


@pytest.mark.parametrize("argv", SCHED_FLAGS, ids=[" ".join(a) for a in SCHED_FLAGS])
def test_sched_flags_parse_as_jax(argv):
    def config(mod):
        args = mod.build_serve_parser().parse_args(["--model_path", "/m", *argv])
        try:
            c = mod._sched_config_from_args(args)
        except ValueError as e:
            return str(e)
        return {f: getattr(c, f) for f in SchedConfig.__dataclass_fields__}

    assert config(cli) == config(jcli)
