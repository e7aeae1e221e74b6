"""The port's serving slice against the JAX package's, on the CPU in float32.

- ``suffix_only_layer`` and ``suffix_prefill_decoders`` against JAX's on the
  same seeded pooled KV (JAX's on its XLA ops and on its Pallas kernels in
  interpret mode), and bit-equal to the port's own full layer's suffix
  stream.
- The admission queue, the batcher and the SLO tracker against their JAX
  twins, driven by the same submit, deadline and sample scripts (the cases
  of ``tests/test_serve.py``'s queue section as pairs).
- Both ``serve`` CLIs on one checkpoint: demo mode with the default engine
  (streamed on the CPU), resident and streamed weights, and a round that
  reuses the pool's sealed prefixes; the JSONL frontend with per-request
  budgets, an expiring deadline, an unknown SLO class and a malformed
  line; an engine whose sweep stalls past the watchdog, recovered, against
  an unstalled run. Tokens equal, scores within 1e-5, and the port's served
  scores equal to its offline ``--kv_cache`` run.
- Every serve flag whose module is not ported raises.
"""

import dataclasses
import io
import json
import pickle
import re
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import BenchTokenizer
from flexible_llm_sharding_tpu import cli as jcli
from flexible_llm_sharding_tpu import serve as jserve
from flexible_llm_sharding_tpu.config import FrameworkConfig as JFrameworkConfig
from flexible_llm_sharding_tpu.config import LlamaConfig as JLlamaConfig
from flexible_llm_sharding_tpu.config import ServeConfig as JServeConfig
from flexible_llm_sharding_tpu.config import SLOConfig as JSLOConfig
from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu.obs import slo as jslo
from flexible_llm_sharding_tpu.runtime import decode as jdecode
from flexible_llm_sharding_tpu.runtime import executor as jexecutor
from flexible_llm_sharding_tpu.runtime import kvpool as jkvpool
from flexible_llm_sharding_tpu.serve import request as jrequest
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu.utils import metrics as jmetrics
from flexible_llm_sharding_tpu_torch import cli, serve
from flexible_llm_sharding_tpu_torch.config import (
    FrameworkConfig,
    LlamaConfig,
    ServeConfig,
    SLOConfig,
)
from flexible_llm_sharding_tpu_torch.models import llama
from flexible_llm_sharding_tpu_torch.obs import slo
from flexible_llm_sharding_tpu_torch.runtime import decode, executor, kvpool
from flexible_llm_sharding_tpu_torch.serve import request
from flexible_llm_sharding_tpu_torch.utils import metrics
from flexible_llm_sharding_tpu_torch.utils.checkpoint import params_from_jax

ATOL = 1e-5
N_GEN = 3


class _Vocab256(BenchTokenizer):
    VOCAB = 256


# Two bucket shapes, padded suffix rows, a prompt that recurs (the pool's
# cross-wave reuse) and one whose prefix shares only a head with another.
PROMPTS = [
    ("the cat sat on the mat and looked at the door", (" then left", " then slept")),
    ("two plus two equals", (" four", " five", " six")),
    ("the cat sat on the mat and looked at the window", (" then left",)),
    ("water boils at one hundred degrees", (" celsius", " kelvin")),
]


@pytest.fixture(autouse=True)
def _fresh_pools():
    kvpool.reset_process_pools()
    jkvpool.reset_process_pools()
    yield
    kvpool.reset_process_pools()
    jkvpool.reset_process_pools()


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny llama checkpoint (2 layers, hidden 64) saved by the JAX package."""
    d = tmp_path_factory.mktemp("serve_model")
    cfg = JLlamaConfig.from_hf_config(dict(
        model_type="llama", vocab_size=256, hidden_size=64, intermediate_size=128,
        max_position_embeddings=512, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2))
    params = jllama.init_params(jax.random.PRNGKey(3), cfg)
    jckpt.save_params(jax.tree.map(np.asarray, params), str(d), cfg)
    return str(d)


# ---------------------------------------------------------------------------
# The suffix-only layer and its decoder loop
# ---------------------------------------------------------------------------

B, LP, S, LS = 2, 64, 2, 64
PLEN = np.array([50, 9], np.int32)


def _layer_model():
    kw = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2)
    jcfg = JLlamaConfig(**kw)
    params_np = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(0), jcfg))
    cfg = LlamaConfig.from_dict({"fls_native": True, **kw})
    return jcfg, cfg, params_np, params_from_jax(params_np, cfg)


def _h(rng, *shape):
    return (rng.standard_normal(shape) * 0.5).astype(np.float32)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_suffix_only_layer_matches_jax(use_pallas):
    jcfg, cfg, params_np, params = _layer_model()
    rng = np.random.default_rng(1)
    kp, vp = _h(rng, B, LP, 2, 32), _h(rng, B, LP, 2, 32)
    sh = _h(rng, B, S, LS, cfg.hidden_size)
    out, (kv_s,) = llama.suffix_only_layer([params["layers"][0]], cfg, [torch.from_numpy(kp)],
                                           [torch.from_numpy(vp)], torch.from_numpy(sh),
                                           torch.from_numpy(PLEN), use_pallas=use_pallas)
    jp = jax.tree.map(jnp.asarray, params_np["layers"][0])
    for b in range(B):
        jout, jkv = jllama.suffix_only_layer(jp, jcfg, jnp.asarray(kp[b]), jnp.asarray(vp[b]),
                                             jnp.asarray(sh[b]), jnp.int32(PLEN[b]),
                                             use_pallas=use_pallas)
        np.testing.assert_allclose(out[b].numpy(), np.asarray(jout), atol=ATOL, rtol=0)
        for key in ("ks", "vs"):
            np.testing.assert_allclose(kv_s[key][b].numpy(), np.asarray(jkv[key]), atol=ATOL,
                                       rtol=0)


def test_suffix_only_layer_is_the_full_layers_suffix_stream():
    """Fed the full layer's own post-rope prefix KV, the suffix-only layer
    gives its suffix output and suffix KV bit for bit."""
    _, cfg, _, params = _layer_model()
    rng = np.random.default_rng(2)
    ph, sh = torch.from_numpy(_h(rng, B, LP, cfg.hidden_size)), torch.from_numpy(
        _h(rng, B, S, LS, cfg.hidden_size))
    pl = torch.from_numpy(PLEN)
    _, s_out, (kv,) = llama.prefix_suffix_layer([params["layers"][1]], cfg, ph, sh, pl,
                                                return_kv=True, use_pallas=True)
    out, (kv_s,) = llama.suffix_only_layer([params["layers"][1]], cfg, [kv["kp"]], [kv["vp"]], sh,
                                           pl, use_pallas=True)
    assert torch.equal(out, s_out)
    assert torch.equal(kv_s["ks"], kv["ks"]) and torch.equal(kv_s["vs"], kv["vs"])


def test_suffix_prefill_decoders_matches_jax():
    """Two layers' suffix-only prefill over pooled KV, against JAX's scan."""
    jcfg, cfg, params_np, params = _layer_model()
    rng = np.random.default_rng(3)
    kps, vps = _h(rng, 2, B, LP, 2, 32), _h(rng, 2, B, LP, 2, 32)
    sh = _h(rng, B, S, LS, cfg.hidden_size)
    out, kvs = decode.suffix_prefill_decoders(
        cfg, [[p] for p in params["layers"]], 0, [[k] for k in torch.from_numpy(kps)],
        [[v] for v in torch.from_numpy(vps)],
        torch.from_numpy(sh), torch.from_numpy(PLEN), None, llama.layer_sliding_pattern(cfg),
        llama.layer_rope_pattern(cfg), use_pallas=True)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *params_np["layers"])
    seg = {"layers": stacked, "sliding": None, "rope": None}
    jout, jkv = jdecode._suffix_prefill_decoders(
        jcfg, False, None, seg, {"kp": jnp.asarray(kps), "vp": jnp.asarray(vps)},
        jnp.asarray(sh), jnp.asarray(PLEN))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    for li, (kv,) in enumerate(kvs):
        assert torch.equal(kv["kp"], torch.from_numpy(kps[li]))
        for key in ("ks", "vs"):
            np.testing.assert_allclose(kv[key].numpy(), np.asarray(jkv[key][li]), atol=ATOL,
                                       rtol=0)


# ---------------------------------------------------------------------------
# Admission queue, batcher and SLO tracker against their JAX twins
# ---------------------------------------------------------------------------

PORT = dict(AdmissionQueue=serve.AdmissionQueue, ShardAwareBatcher=serve.ShardAwareBatcher,
            ServingMetrics=metrics.ServingMetrics, req=request)
JAX = dict(AdmissionQueue=jserve.AdmissionQueue, ShardAwareBatcher=jserve.ShardAwareBatcher,
           ServingMetrics=jmetrics.ServingMetrics, req=jrequest)


def _req(side, deadline=None):
    return side["req"].Request(prefix="p", suffixes=("s",), max_new_tokens=1, deadline=deadline)


def _outcome(r):
    """A request's status and terminal error type, if any."""
    err = r.future.exception(timeout=1) if r.future.done() else None
    return r.status.value, type(err).__name__ if err is not None else None


def _case_backpressure(side):
    m = side["ServingMetrics"]()
    q = side["AdmissionQueue"](capacity=4, metrics=m)
    reqs = [_req(side) for _ in range(16)]
    barrier = threading.Barrier(16)

    def submit(r):
        barrier.wait()
        q.submit(r)

    threads = [threading.Thread(target=submit, args=(r,)) for r in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rejected = [r for r in reqs if r.status.value == "rejected"]
    assert all("capacity 4" in str(r.future.exception(timeout=1)) for r in rejected)
    return (sorted(_outcome(r) for r in reqs), len(q), m.counter("rejected"))


def _case_deadline_eviction(side):
    m = side["ServingMetrics"]()
    q = side["AdmissionQueue"](capacity=8, metrics=m)
    expired = _req(side, deadline=time.monotonic() - 0.01)
    live_a, live_b = _req(side), _req(side, deadline=time.monotonic() + 60)
    for r in (live_a, expired, live_b):
        q.submit(r)
    wave = q.pop_wave(8)
    return (wave == [live_a, live_b], _outcome(expired), m.counter("expired"), len(q))


def _case_submit_evicts_expired_first(side):
    m = side["ServingMetrics"]()
    q = side["AdmissionQueue"](capacity=2, metrics=m)
    dead = [_req(side, deadline=time.monotonic() + 0.01) for _ in range(2)]
    for r in dead:
        q.submit(r)
    time.sleep(0.03)
    live = q.submit(_req(side))
    return (_outcome(live), [_outcome(r) for r in dead], m.counter("expired"),
            q.pop_wave(8) == [live])


def _case_drain_and_no_drain(side):
    q = side["AdmissionQueue"](capacity=8)
    kept = [_req(side), _req(side)]
    for r in kept:
        q.submit(r)
    first = (q.close(drain=True), len(q))
    late = q.submit(_req(side))
    popped = q.pop_wave(8) == kept
    q2 = side["AdmissionQueue"](capacity=8)
    doomed = [_req(side) for _ in range(3)]
    for r in doomed:
        q2.submit(r)
    cancelled = q2.close(drain=False)
    return (first, _outcome(late), popped, cancelled == doomed, len(q2),
            [_outcome(r) for r in doomed])


def _case_shutdown_resolves_expired(side):
    out = []
    for drain in (True, False):
        m = side["ServingMetrics"]()
        q = side["AdmissionQueue"](capacity=8, metrics=m)
        live = _req(side, deadline=time.monotonic() + 60)
        stale = _req(side, deadline=time.monotonic() - 0.01)
        q.submit(live)
        q.submit(stale)
        cancelled = q.close(drain=drain)
        out.append((_outcome(stale), stale in cancelled, m.counter("expired"),
                    cancelled == ([] if drain else [live]), _outcome(live)[0]))
    return out


def _case_batcher_evicts_while_saturated(side):
    m = side["ServingMetrics"]()
    q = side["AdmissionQueue"](capacity=8, metrics=m)
    batcher = side["ShardAwareBatcher"](q, max_wave_requests=2, max_active_requests=1, metrics=m)
    q.submit(_req(side))
    first = batcher.admit_at_boundary() is not None
    active = batcher.active_requests
    doomed = _req(side, deadline=time.monotonic() - 0.01)
    q.submit(doomed)
    second = batcher.admit_at_boundary()
    return (first, active, second, _outcome(doomed), m.counter("expired"))


QUEUE_CASES = {
    "backpressure_under_concurrent_submitters": _case_backpressure,
    "deadline_eviction": _case_deadline_eviction,
    "submit_evicts_expired_before_capacity_check": _case_submit_evicts_expired_first,
    "drain_and_no_drain_shutdown": _case_drain_and_no_drain,
    "shutdown_resolves_expired_as_expired": _case_shutdown_resolves_expired,
    "batcher_evicts_expired_while_saturated": _case_batcher_evicts_while_saturated,
}


@pytest.mark.parametrize("case", sorted(QUEUE_CASES))
def test_queue_and_batcher_match_jax(case):
    got = QUEUE_CASES[case](PORT)
    assert got == QUEUE_CASES[case](JAX)
    # The JAX suite's expectations hold on the port's side.
    if case == "backpressure_under_concurrent_submitters":
        assert got[1:] == (4, 12)
    elif case == "deadline_eviction":
        assert got == (True, ("expired", "DeadlineExceeded"), 1, 0)
    elif case == "batcher_evicts_expired_while_saturated":
        assert got == (True, 1, None, ("expired", "DeadlineExceeded"), 1)


SLO_SCRIPTS = {
    "off": (dict(), [(0.1, "standard")] * 30, [0.01] * 30, (30, 0)),
    "ttft_burning": (dict(enabled=True, ttft_p95_s="interactive=0.5,standard=2.0",
                          min_samples=5),
                     [(0.4, "interactive")] * 10 + [(0.9, "interactive")] * 5
                     + [(1.0, "standard")] * 8, [], (23, 0)),
    "token_latency_and_availability": (
        dict(enabled=True, token_latency_p95_s=0.05, availability_target=0.9, min_samples=3),
        [(0.2, "best_effort")] * 4, [0.01] * 20 + [0.2] * 3, (17, 3)),
}


@pytest.mark.parametrize("name", sorted(SLO_SCRIPTS))
def test_slo_tracker_matches_jax(name):
    """The same TTFT, token-latency and outcome samples, evaluated three
    times (the latch and the trend move): equal stats on both sides."""
    kw, ttfts, token_lats, (completed, failed) = SLO_SCRIPTS[name]
    outs = []
    for mod, metrics_cls, cfg in ((slo, metrics.ServingMetrics, SLOConfig(**kw)),
                                  (jslo, jmetrics.ServingMetrics, JSLOConfig(**kw))):
        m = metrics_cls()
        tracker = mod.SLOTracker(cfg, m)
        evals = []
        for third in range(3):
            for t, cls in ttfts[third::3]:
                m.observe_ttft(t, cls)
            for t in token_lats[third::3]:
                m.observe_token_latency(t)
            m.count("completed", completed // 3)
            m.count("failed", failed // 3)
            evals.append(tracker.stats())
        outs.append(evals)
        if hasattr(m, "close"):
            m.close()
    assert outs[0] == outs[1]
    if name == "ttft_burning":
        assert outs[0][-1]["budget_exhausted_events"] >= 1


# ---------------------------------------------------------------------------
# Both serve CLIs on one checkpoint
# ---------------------------------------------------------------------------

COMMON = ["--dtype", "float32", "--bucket_multiple", "8", "--block_size", "2", "--prefetch_depth",
          "0", "--stats_interval_s", "0"]


def _jax_serve(argv, **kw):
    """JAX ``serve_main`` (it installs a SIGTERM handler; restored here)."""
    handler = signal.getsignal(signal.SIGTERM)
    try:
        return jcli.serve_main(argv, tokenizer=_Vocab256(), **kw)
    finally:
        signal.signal(signal.SIGTERM, handler)


def _demo(tmp_path, model_dir, tag, prompts, extra, port: bool):
    ppkl = tmp_path / f"{tag}.pkl"
    ppkl.write_bytes(pickle.dumps(prompts))
    opkl = tmp_path / f"{tag}_scores.pkl"
    argv = ["--model_path", model_dir, "--prompt_pickle", str(ppkl), "--output_file", str(opkl),
            *COMMON, *extra]
    stats = (cli.main(["serve", "--device", "cpu", *argv], tokenizer=_Vocab256()) if port
             else _jax_serve(argv))
    scores = pickle.loads(opkl.read_bytes())
    updated = pickle.loads((tmp_path / f"{tag}_updated.pkl").read_bytes())
    return scores, updated, stats


def _offline(tmp_path, model_dir, prompts, n_gen, resident):
    ppkl = tmp_path / "offline.pkl"
    ppkl.write_bytes(pickle.dumps(prompts))
    cli.main(["--model_path", model_dir, "--prompt_pickle", str(ppkl), "--output_file",
              str(tmp_path / "offline_scores.pkl"), "--device", "cpu", "--dtype", "float32",
              "--bucket_multiple", "8", "--block_size", "2", "--prefetch_depth", "0",
              "--kv_cache", "true", "--num_gen_token", str(n_gen), "--decode_resident", resident],
             tokenizer=_Vocab256())
    return (pickle.loads((tmp_path / "offline_scores.pkl").read_bytes()),
            pickle.loads((tmp_path / "offline_updated.pkl").read_bytes()))


def _same(got, ref, atol=ATOL):
    (g_scores, g_up), (r_scores, r_up) = got, ref
    assert g_up == r_up
    assert len(g_scores) == len(r_scores)
    for g, r in zip(g_scores, r_scores):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=atol, rtol=0)


DEMO_MODES = {
    "default": [],  # decode_resident auto: streamed on the CPU
    "resident": ["--decode_resident", "on"],
    "streamed": ["--decode_resident", "off", "--queue_capacity", "2", "--stagger_ms", "5"],
}


@pytest.mark.parametrize("mode", sorted(DEMO_MODES))
def test_serve_demo_matches_jax_and_offline(mode, model_dir, tmp_path):
    extra = ["--max_new_tokens", str(N_GEN), "--max_wave_requests", "2", *DEMO_MODES[mode]]
    p_scores, p_up, p_stats = _demo(tmp_path, model_dir, "port", PROMPTS, extra, port=True)
    j_scores, j_up, _ = _demo(tmp_path, model_dir, "jax", PROMPTS, extra, port=False)
    _same((p_scores, p_up), (j_scores, j_up))
    resident = "on" if mode == "resident" else "off"
    _same((p_scores, p_up), _offline(tmp_path, model_dir, PROMPTS, N_GEN, resident))
    assert p_stats["admitted"] == p_stats["completed"] == len(PROMPTS)
    assert p_stats["tokens_emitted"] == len(PROMPTS) * N_GEN
    assert p_stats["ttft_s"]["count"] == len(PROMPTS)
    # A resident engine uploads the weights once; a streamed one (no
    # prefetch here) once per sweep.
    one_pass = metrics.param_count(LlamaConfig.from_pretrained(model_dir)) * 4
    passes = 1 if mode == "resident" else p_stats["sweeps"]
    assert p_stats["stream"]["streamed_bytes"] == passes * one_pass


def test_serve_pool_reuse_round_matches_jax(model_dir, tmp_path):
    """The prompts twice, one request per wave: the second round's waves
    lease the first round's sealed entries and run only the suffix half of
    each layer. Outputs equal the first round's (bit for bit on the port)
    and JAX's; the pool counters match."""
    prompts = PROMPTS + PROMPTS
    extra = ["--max_new_tokens", str(N_GEN), "--max_wave_requests", "1", "--decode_resident", "on"]
    p_scores, p_up, p_stats = _demo(tmp_path, model_dir, "port", prompts, extra, port=True)
    j_scores, j_up, _ = _demo(tmp_path, model_dir, "jax", prompts, extra, port=False)
    j_pool = jkvpool.process_stats()
    _same((p_scores, p_up), (j_scores, j_up))
    n = len(PROMPTS)
    for a, b in zip(p_scores[:n], p_scores[n:]):
        assert np.array_equal(a, b)
    assert p_up[:n] == p_up[n:]
    pool = p_stats["kvpool"]
    assert pool["prefix_reuse_hits"] == n and p_stats["prefix_reuse_tokens"] > 0
    for key in ("pages_allocated", "pages_shared", "prefix_reuse_hits", "entries_sealed",
                "bytes_resident"):
        assert pool[key] == j_pool[key], key


JSONL = [
    {"id": "a", "prefix": PROMPTS[0][0], "suffixes": list(PROMPTS[0][1]), "max_new_tokens": 1},
    {"id": "b", "prefix": PROMPTS[1][0], "suffixes": list(PROMPTS[1][1]), "max_new_tokens": 4},
    {"id": "c", "prefix": PROMPTS[3][0], "suffixes": list(PROMPTS[3][1])},
    {"id": "late", "prefix": PROMPTS[2][0], "suffixes": list(PROMPTS[2][1]), "deadline_s": 1e-6},
    {"id": "cls", "prefix": PROMPTS[2][0], "suffixes": ["x"], "slo_class": "urgent"},
    {"id": "interactive", "prefix": PROMPTS[2][0], "suffixes": list(PROMPTS[2][1]),
     "slo_class": "interactive", "tenant_id": "t1", "max_new_tokens": 2},
]


def _jsonl_lines(run, monkeypatch, capsys):
    lines = "\n".join([json.dumps(d) for d in JSONL] + ["not json"]) + "\n"
    monkeypatch.setattr("sys.stdin", io.StringIO(lines))
    capsys.readouterr()
    run()
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.strip()]
    by_id = {}
    for d in out:
        key = d.get("client_id", d.get("line"))
        by_id[key] = {k: v for k, v in d.items() if k not in ("id", "ttft_s", "latency_s")}
        if "error" in d:  # request ids and waits differ between the runs
            by_id[key]["error"] = re.sub(r"\d+(\.\d+)?", "N", d["error"])
    return by_id


def test_serve_jsonl_matches_jax(model_dir, monkeypatch, capsys):
    """Per-request budgets, an admission deadline that expires in the
    queue, an unknown SLO class (a typed error line) and a malformed line."""
    argv = ["--model_path", model_dir, *COMMON, "--max_new_tokens", "2"]
    port = _jsonl_lines(lambda: cli.main(["serve", "--device", "cpu", *argv],
                                         tokenizer=_Vocab256()), monkeypatch, capsys)
    jax_ = _jsonl_lines(lambda: _jax_serve(argv), monkeypatch, capsys)
    assert port == jax_
    assert port["a"]["status"] == "done" and np.shape(port["a"]["tokens"]) == (2, 1)
    assert np.shape(port["b"]["tokens"]) == (3, 4)
    assert np.shape(port["c"]["tokens"]) == (2, 2)
    assert port["late"]["status"] == "expired"
    # A line the engine refuses at submit replies by its line number.
    assert port[5]["status"] == "rejected" and "UnknownSLOClass" in port[5]["error"]
    assert port[7]["status"] == "rejected" and port["interactive"]["status"] == "done"


@pytest.fixture
def _tiny_cfgs(model_dir, tmp_path):
    def make(**kw):
        common = dict(model_path=model_dir, dtype="float32", bucket_multiple=8, block_size=2,
                      disk_folder=str(tmp_path / "d"), **kw)
        return FrameworkConfig(device="cpu", **common), JFrameworkConfig(**common)
    return make


def _serve_requests(engine, prompts, n_gen):
    reqs = [engine.submit(p, s, max_new_tokens=n_gen) for p, s in prompts]
    return [r.future.result(timeout=120) for r in reqs]


def test_recover_after_stalled_sweep_matches_jax(_tiny_cfgs, monkeypatch):
    """A streamed engine whose first source stalls on shard 1 past
    ``watchdog_abort_s``: the watchdog aborts the source, the wave in flight
    fails with WaveAborted, the source restarts and the engine serves the
    resubmitted request like an unstalled engine; the recovery counters
    match JAX's."""
    cfg, jcfg = _tiny_cfgs(decode_resident="off", prefetch_depth=1)
    # A tiny model's shard lands in milliseconds: a second without one is
    # the stall, never a busy machine.
    scfg = dict(max_wave_requests=2, default_max_new_tokens=N_GEN, watchdog_abort_s=1.0)

    def stall_once(cls, name):
        real, fired = getattr(cls, name), []

        def slow(self, idxs, *a):
            if not fired and tuple(idxs) == (1,):
                fired.append(True)
                time.sleep(2.5)
            return real(self, idxs, *a)

        monkeypatch.setattr(cls, name, slow)

    stall_once(executor.ShardWeightSource, "_build")
    stall_once(jexecutor.ShardWeightSource, "_build_shard")
    outs = []
    for engine_cls, fw, sc in ((serve.ServeEngine, cfg, ServeConfig(**scfg)),
                               (jserve.ServeEngine, jcfg, JServeConfig(**scfg))):
        kwargs = {"device": torch.device("cpu")} if engine_cls is serve.ServeEngine else {}
        engine = engine_cls(fw, sc, tokenizer=_Vocab256(), **kwargs)
        try:
            first = engine.submit(*PROMPTS[0])
            err = first.future.exception(timeout=60)
            assert type(err).__name__ == "WaveAborted" and first.status.value == "failed"
            res = _serve_requests(engine, PROMPTS[:2], N_GEN)
            counters = {k: engine.metrics.counter(k) for k in (
                "engine_recoveries", "waves_aborted", "source_restarts", "watchdog_stalls")}
        finally:
            engine.shutdown(drain=True)
        assert engine.error is None
        outs.append((res, counters))
    (p_res, p_counters), (j_res, j_counters) = outs
    assert p_counters == j_counters == dict(engine_recoveries=1, waves_aborted=1,
                                           source_restarts=1, watchdog_stalls=1)
    monkeypatch.undo()
    clean = serve.ServeEngine(cfg, ServeConfig(**scfg), tokenizer=_Vocab256(),
                              device=torch.device("cpu"))
    try:
        ref = _serve_requests(clean, PROMPTS[:2], N_GEN)
    finally:
        clean.shutdown(drain=True)
    for p, j, r in zip(p_res, j_res, ref):
        assert p.updated == j.updated == r.updated
        assert np.array_equal(p.scores, r.scores)
        np.testing.assert_allclose(p.scores, j.scores, atol=ATOL, rtol=0)


def test_engine_backpressure_drain_and_guards(_tiny_cfgs):
    """A stopped engine's queue fills: the overflow is rejected with a
    reason and drain serves exactly the accepted requests; callbacks fire
    once; sampling and data parallel are refused at construction."""
    cfg, _ = _tiny_cfgs()
    with pytest.raises(ValueError, match="greedy-only"):
        serve.ServeEngine(FrameworkConfig(model_path=cfg.model_path, temperature=0.5,
                                          device="cpu"), tokenizer=_Vocab256(), start=False)
    with pytest.raises(ValueError, match="single device"):
        serve.ServeEngine(FrameworkConfig(model_path=cfg.model_path, data_parallel=True,
                                          device="cpu"), tokenizer=_Vocab256(), start=False)
    engine = serve.ServeEngine(cfg, ServeConfig(queue_capacity=3, default_max_new_tokens=1),
                               tokenizer=_Vocab256(), start=False)
    done = []
    reqs = [engine.submit(p, s, callback=done.append) for p, s in PROMPTS + PROMPTS[:2]]
    accepted = [r for r in reqs if r.status is request.RequestStatus.QUEUED]
    rejected = [r for r in reqs if r.status is request.RequestStatus.REJECTED]
    assert len(accepted) == 3 and len(rejected) == 3
    for r in rejected:
        with pytest.raises(request.QueueFull, match="capacity 3"):
            r.future.result(timeout=1)
    with pytest.raises(ValueError, match="max_new_tokens"):
        engine.submit(*PROMPTS[0], max_new_tokens=0)
    engine.start()
    assert engine.drain(timeout=60)
    assert engine.error is None
    assert all(r.future.result(timeout=1).scores.shape[1] == 1 for r in accepted)
    stats = engine.stats()
    assert (stats["admitted"], stats["rejected"], stats["completed"]) == (3, 3, 3)
    assert sorted(id(r) for r in done) == sorted(id(r) for r in reqs)
    late = engine.submit(*PROMPTS[0])
    assert late.status is request.RequestStatus.CANCELLED


def _non_default(kw):
    if kw.get("action") == "store_true":
        return []
    if "choices" in kw:
        return [next(c for c in kw["choices"] if c != kw["default"])]
    default = kw["default"]
    if kw["type"] is cli._str2bool:
        return ["false" if default else "true"]
    if default is None:
        return ["1"]
    if isinstance(default, str):
        return ["x"]
    return [str(default + 1)]


# The brownout flags, parsed as the JAX serve parser parses them.
_PRESSURE_FLAGS = tuple(
    (f"--{name}", dict(action="store_true", default=False) if name == "pressure" else
     dict(type=type(default), default=default), None)
    for name, default in (("pressure", False), ("pressure_poll_s", 1.0),
                          ("pressure_host_min_gb", 1.0), ("pressure_disk_min_gb", 1.0),
                          ("pressure_hbm_headroom_frac", 0.05), ("pressure_link_min_gbps", 0.0),
                          ("pressure_cache_shrink_frac", 0.5),
                          ("pressure_shed_retry_after_s", 1.0), ("pressure_step_down_polls", 3)))
# The observability flags, parsed as the JAX serve parser parses them.
_OBS_FLAGS = tuple(
    (flag, kw, "obs") for flag, kw in (
        ("--metrics_port", dict(type=int, default=None)),
        ("--trace", dict(action="store_true", default=False)),
        ("--trace_out", dict(type=str, default="")),
        ("--journal_dir", dict(type=str, default="")),
        ("--journal_max_mb", dict(type=float, default=16.0)),
        ("--incidents_dir", dict(type=str, default="")),
        ("--incidents_max_mb", dict(type=float, default=256.0)),
        ("--incident_trigger", dict(type=str, default="error",
                                    choices=("info", "warning", "error", "critical"))),
        ("--incident_debounce_s", dict(type=float, default=60.0)),
        ("--incident_settle_s", dict(type=float, default=1.0))))
_SERVE_FLAG_CASES = _OBS_FLAGS + _PRESSURE_FLAGS


@pytest.mark.parametrize("flag,kw,where", _SERVE_FLAG_CASES,
                         ids=[f for f, _, _ in _SERVE_FLAG_CASES])
def test_unported_serve_flags_raise(flag, kw, where, tmp_path, monkeypatch):
    """No serve flag of the JAX parser is refused any more: the
    observability flags take JAX's defaults and values into the configs
    that ``serve_main`` builds, as the ``--pressure*`` flags take theirs
    into ``PressureConfig``."""
    if where == "obs":
        dest = flag.lstrip("-")
        ours, theirs = cli.build_serve_parser(), jcli.build_serve_parser()
        assert ours.get_default(dest) == theirs.get_default(dest) == kw["default"]
        argv = ["--model_path", str(tmp_path), flag, *_non_default(kw)]
        args, jargs = ours.parse_args(argv), theirs.parse_args(argv)
        assert getattr(args, dest) == getattr(jargs, dest) != kw["default"]
        if dest == "metrics_port":
            assert ServeConfig(metrics_port=args.metrics_port).metrics_port == 1
        else:
            class Built(Exception):
                pass

            def capture(**kw):
                raise Built(kw)

            monkeypatch.setattr(cli, "FrameworkConfig", capture)
            with pytest.raises(Built) as built:
                cli.serve_main(argv)
            fcfg = FrameworkConfig(**built.value.args[0])
            assert getattr(fcfg, dest) == getattr(jargs, dest)
        return
    dest = flag.lstrip("-")
    default = kw["default"]
    value = ([] if dest == "pressure" else
             [str(default / 2 if default else 1.0) if isinstance(default, float)
              else str(default + 1)])
    argv = ["--model_path", str(tmp_path), "--pressure", flag, *value]
    ours, theirs = cli.build_serve_parser(), jcli.build_serve_parser()
    assert ours.get_default(dest) == theirs.get_default(dest) == kw["default"]
    pcfg = cli._pressure_config_from_args(ours.parse_args(argv))
    jpcfg = jcli._pressure_config_from_args(theirs.parse_args(argv))
    assert pcfg.enabled and dataclasses.asdict(pcfg) == dataclasses.asdict(jpcfg)
    if dest != "pressure":
        assert getattr(pcfg, dest.removeprefix("pressure_")) != kw["default"]


def test_serve_demo_fails_on_an_oversized_prompt_instead_of_retrying(model_dir, tmp_path):
    """Demo mode retries a submission only on backpressure (``QueueFull``):
    a prompt over ``--max_request_tokens`` is rejected for good, and the run
    fails naming ``RequestTooLarge`` instead of resubmitting it forever (the
    JAX demo retries every rejection)."""
    ppkl = tmp_path / "big.pkl"
    ppkl.write_bytes(pickle.dumps([PROMPTS[1], PROMPTS[0]]))
    argv = ["serve", "--device", "cpu", "--model_path", model_dir, "--prompt_pickle", str(ppkl),
            "--output_file", str(tmp_path / "big_scores.pkl"), *COMMON, "--max_new_tokens",
            str(N_GEN), "--max_request_tokens", "12"]
    outcome = []

    def run():
        try:
            cli.main(argv, tokenizer=_Vocab256())
        except BaseException as e:  # noqa: BLE001 — the outcome is the assertion
            outcome.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(60)
    assert not t.is_alive(), "demo mode kept resubmitting a rejected prompt"
    assert len(outcome) == 1 and isinstance(outcome[0], request.RequestTooLarge)
    assert "admission cap of 12" in str(outcome[0])
