"""The port's speculative serving against the JAX package's, on the CPU in
float32.

- The pure pieces on the same inputs: ``SpecVerifier.set_pass_k`` (per-row
  caps, identity at full width) and ``request_steps``, and
  ``SpecController`` (``assign`` with class funding and a budget,
  ``observe`` over its window and thresholds).
- ``forward_full`` against JAX's for llama, gemma3 with a binding window and
  a longrope model on both sides of its table switch; ``DraftModel.propose``
  against JAX's on one checkpoint (ids only: the JAX pin plan sums layer
  indices, the port's bytes).
- Engine pairs, each held to the port's plain engine or its offline oracle
  and to the JAX engine (tokens equal, scores within 1e-5): one wave, mixed
  budgets with a late wave, zero acceptance costing no extra sweep, a
  coalesced wave, a preempted wave resuming, a resident draft model adding
  no streamed byte per sweep, and a draft budget funding interactive rows
  first.
- ``ServeConfig``'s speculative fields and the serve CLI's flags validate
  and parse as JAX's; ``FrameworkConfig.speculative_k`` stays refused.
"""

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
from flexible_llm_sharding_tpu.config import SchedConfig as JSchedConfig
from flexible_llm_sharding_tpu.config import ServeConfig as JServeConfig
from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu.runtime import decode as jdecode
from flexible_llm_sharding_tpu.runtime import draft as jdraft
from flexible_llm_sharding_tpu.runtime import kvpool as jkvpool
from flexible_llm_sharding_tpu.serve import spec as jspec
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu.utils import metrics as jmetrics
from flexible_llm_sharding_tpu_torch import cli, serve
from flexible_llm_sharding_tpu_torch.config import (
    FrameworkConfig,
    LlamaConfig,
    SchedConfig,
    ServeConfig,
)
from flexible_llm_sharding_tpu_torch.models import llama
from flexible_llm_sharding_tpu_torch.runtime import decode, draft, kvpool
from flexible_llm_sharding_tpu_torch.serve import spec
from flexible_llm_sharding_tpu_torch.utils import metrics
from flexible_llm_sharding_tpu_torch.utils.checkpoint import params_from_jax

ATOL = 1e-5
N_GEN = 4
SPEC_K = 4


class _Vocab256(BenchTokenizer):
    VOCAB = 256


# Repetition-heavy prompts first (prompt lookup lands there), then ones
# whose generated tokens never appear in the prompt.
PROMPTS = [
    ("the cat sat on the mat the cat sat on the mat", (" the cat sat", " on the mat")),
    ("alpha beta gamma alpha beta gamma alpha", (" beta gamma alpha", " delta")),
    ("the capital of france", (" is paris", " is rome")),
    ("two plus two equals", (" four", " five")),
]


@pytest.fixture(autouse=True)
def _fresh_pools():
    kvpool.reset_process_pools()
    jkvpool.reset_process_pools()
    yield
    kvpool.reset_process_pools()
    jkvpool.reset_process_pools()


# ---------------------------------------------------------------------------
# SpecVerifier's serving hooks and the adaptive controller
# ---------------------------------------------------------------------------

def _verifier(mod, karr=None, k=3):
    calls = []

    def dfn(ctx, kk):
        calls.append((len(ctx), kk))
        return (np.arange(kk) % 3 + 2).astype(np.int64)

    init_dist = np.zeros((1, 2, 16), np.float32)
    init_dist[:, :, 1] = 1.0
    v = mod.SpecVerifier(k, dfn, [[np.array([1, 2, 1]), np.array([3, 4, 1])]],
                         np.array([[6, 5]]), init_dist, np.array([[1, 1]]))
    if karr is not None:
        v.set_pass_k(karr)
    return v, calls


def _verify_script(mod, karr):
    v, calls = _verifier(mod, karr)
    rng = np.random.default_rng(3)
    out = []
    for _ in range(3):
        if v.done:
            break
        fed, base = v.begin_pass()
        dist = rng.random((1, 2, 4, 16)).astype(np.float32)
        dist[0, 0, :2, 2] = 2.0  # row 0 accepts its first draft
        emitted = v.finish_pass(dist)
        out.append((fed.tolist(), base.tolist(), emitted.tolist(), v.last_drafted.tolist(),
                    v.last_accepted.tolist(), v.g.tolist()))
    n = int(v.g.min())
    sc, tk = v.request_steps(0, 1, 1, n)
    counts = (v.passes, v.drafted, v.accepted, v.rejected)
    return out, calls, counts, [s.tolist() for s in sc], [t.tolist() for t in tk]


@pytest.mark.parametrize("karr", [None, [[3, 3]], [[2, 0]], [[1, 3]]],
                         ids=["default", "full_width", "capped", "mixed"])
def test_set_pass_k_and_request_steps_match_jax(karr):
    port = _verify_script(decode, None if karr is None else np.array(karr))
    assert port == _verify_script(jdecode, None if karr is None else np.array(karr))
    if karr == [[3, 3]]:
        assert port == _verify_script(decode, None)  # full width is the default
    if karr == [[2, 0]]:
        assert all(c[1] == 2 for c in port[1])  # row 1 never drafts


CTRL_SCRIPTS = {
    "window": (dict(spec_k=2, k_min=0, k_max=4, window=2, raise_threshold=0.6,
                    backoff_threshold=0.2),
               [("standard", 2, 2), ("standard", 2, 2), ("standard", 2, 0), ("standard", 2, 0),
                ("standard", 2, 0), ("standard", 2, 0), ("interactive", 0, 0),
                ("best_effort", 4, 3), ("best_effort", 4, 4)]),
    "budget": (dict(spec_k=3, k_min=1, k_max=5, window=1, raise_threshold=0.5,
                    backoff_threshold=0.1, draft_budget=4),
               [("interactive", 3, 3), ("best_effort", 3, 0)]),
}


@pytest.mark.parametrize("name", sorted(CTRL_SCRIPTS))
def test_spec_controller_matches_jax(name):
    kw, observations = CTRL_SCRIPTS[name]
    classes = [["best_effort", "interactive", None], ["standard", "interactive", "best_effort"]]
    remaining = np.array([[5, 9, 3], [1, 2, 7]])

    def run(mod):
        ctrl = mod.SpecController(**kw)
        out = [ctrl.assign(classes, remaining).tolist()]
        for cls, d, a in observations:
            ctrl.observe(cls, d, a)
            out.append({c: ctrl.current_k(c) for c in ("interactive", "standard", "best_effort")})
            out.append(ctrl.assign(classes, remaining).tolist())
        keys = ("k_raises", "k_backoffs", "assigned_tokens", "budget_clipped_tokens",
                "k_by_class")
        return out, {k: ctrl.stats()[k] for k in keys}

    port = run(spec)
    assert port == run(jspec)
    if name == "budget":
        assert port[1]["budget_clipped_tokens"] > 0


def test_spec_counters_and_class_split_match_jax():
    """The ``spec`` source: pre-seeded zeros for every class before any pass,
    then the totals, the per-class split, the acceptance rate and the
    accepted tokens per sweep of the same passes."""
    port, jax_ = metrics.ServingMetrics(), jmetrics.ServingMetrics(process_mirror=False)
    try:
        assert port.spec_snapshot() == jax_.spec_snapshot()
        for m in (port, jax_):
            m.count("sweeps", 3)
            m.spec_count(drafted=5, accepted=2, rejected=3, slo_class="interactive")
            m.spec_count(drafted=4, accepted=4, rejected=0, slo_class="best_effort")
            m.spec_count(drafted=2, accepted=0, rejected=2)
        snap = port.spec_snapshot()
        assert snap == jax_.spec_snapshot()
        assert snap["drafted_tokens"] == 11 and snap["by_class"]["interactive"]["accepted_tokens"] == 2
    finally:
        jax_.close()


# ---------------------------------------------------------------------------
# forward_full and the draft model
# ---------------------------------------------------------------------------

_SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=128, max_position_embeddings=512)
FULL_MODELS = {
    "llama": dict(model_type="llama", **_SMALL, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2),
    # Layers 0-1 local with a window of 6 that binds, layer 2 global.
    "gemma3": dict(model_type="gemma3_text", **_SMALL, num_hidden_layers=3,
                   num_attention_heads=2, num_key_value_heads=1, head_dim=64,
                   query_pre_attn_scalar=64, sliding_window=6, rope_theta=1000000.0,
                   rope_local_base_freq=10000.0,
                   layer_types=["sliding_attention", "sliding_attention", "full_attention"]),
    # hd 96; its table switches at 24 positions.
    "phi3_longrope": dict(model_type="phi3", **{**_SMALL, "hidden_size": 192},
                          num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
                          original_max_position_embeddings=24,
                          rope_scaling={"type": "longrope",
                                        "long_factor": [1.0 + 0.25 * i for i in range(48)],
                                        "short_factor": [1.0 + 0.02 * i for i in range(48)]}),
}


def _save(hf: dict, d, seed: int) -> str:
    jcfg = JLlamaConfig.from_hf_config(hf)
    jckpt.save_params(jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(seed), jcfg)),
                      str(d), jcfg)
    return str(d)


@pytest.mark.parametrize("family", sorted(FULL_MODELS))
def test_forward_full_matches_jax(family, tmp_path):
    jcfg = JLlamaConfig.from_hf_config(FULL_MODELS[family])
    params_np = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(7), jcfg))
    jckpt.save_params(params_np, str(tmp_path), jcfg)
    cfg = LlamaConfig.from_pretrained(str(tmp_path))
    params = params_from_jax(params_np, cfg)
    rng = np.random.default_rng(1)
    for length in (16, 40):  # longrope: both tables
        ids = rng.integers(3, 256, size=(2, length))
        got = llama.forward_full(params, cfg, torch.from_numpy(ids), use_pallas=True)
        want = jax.jit(lambda p, x: jllama.forward_full(p, jcfg, x))(
            jax.tree.map(jnp.asarray, params_np), jnp.asarray(ids))
        assert got.dtype == torch.float32 and got.shape == (2, length, 256)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return _save(FULL_MODELS["llama"], tmp_path_factory.mktemp("spec_target"), 5)


@pytest.fixture(scope="module")
def draft_dir(tmp_path_factory):
    """A draft with the target's widths and vocabulary and other weights."""
    return _save(FULL_MODELS["llama"], tmp_path_factory.mktemp("spec_draft"), 11)


@pytest.fixture(scope="module")
def twin_draft_dir(tmp_path_factory):
    """A draft with the target's own weights: every draft is accepted."""
    return _save(FULL_MODELS["llama"], tmp_path_factory.mktemp("spec_twin"), 5)


def test_draft_model_propose_matches_jax(draft_dir):
    rng = np.random.default_rng(2)
    port = draft.DraftModel(draft_dir, torch.device("cpu"), use_pallas=True)
    jdm = jdraft.DraftModel(draft_dir)
    try:
        for n in (1, 5, 63, 64, 70):
            ctx = rng.integers(3, 256, size=n)
            got = port.propose(ctx, 3)
            assert got.dtype == np.int64 and got.shape == (3,)
            assert got.tolist() == jdm.propose(ctx, 3).tolist()
        stats = port.stats()
        assert stats["draft_calls"] == 5 and stats["draft_tokens"] == 15
        n_layers = LlamaConfig.from_pretrained(draft_dir).num_hidden_layers + 3
        assert stats["pinned_layers"] == n_layers
        # Pinned at the loader's bytes (float32 host trees, float32 on the
        # device), never at JAX's sum of layer indices.
        assert stats["pinned_bytes"] == stats["pin_stream_bytes"] > 0
        plan = port.tier.plan
        assert plan.budget_bytes == sum(b for _, b in plan.layer_bytes) > n_layers * 100
    finally:
        port.close()
        jdm.close()


def test_draft_model_refuses_a_layer_it_cannot_pin(draft_dir, tmp_path):
    import shutil

    d = tmp_path / "broken"
    shutil.copytree(draft_dir, d)
    victim = next(p for p in d.iterdir() if p.name.startswith("model.layers.1"))
    victim.unlink()
    with pytest.raises((ValueError, OSError)):
        draft.DraftModel(str(d), torch.device("cpu"), use_pallas=True)


# ---------------------------------------------------------------------------
# Engine pairs
# ---------------------------------------------------------------------------

def _engine(model_dir, side, start=True, **serve_kw):
    sched = serve_kw.pop("sched", None)
    common = dict(model_path=model_dir, dtype="float32", bucket_multiple=8, block_size=2,
                  prefetch_depth=0)
    if side == "port":
        sc = ServeConfig(sched=SchedConfig(**sched) if sched else SchedConfig(), **serve_kw)
        return serve.ServeEngine(FrameworkConfig(device="cpu", **common), sc,
                                 tokenizer=_Vocab256(), device=torch.device("cpu"), start=start)
    sc = JServeConfig(sched=JSchedConfig(**sched) if sched else JSchedConfig(), **serve_kw)
    return jserve.ServeEngine(JFrameworkConfig(**common), sc, tokenizer=_Vocab256(), start=start)


def _serve(model_dir, side, prompts, submit_kw=None, **serve_kw):
    """Serve ``prompts`` admitted at one boundary: (results, stats)."""
    engine = _engine(model_dir, side, start=False, **serve_kw)
    try:
        reqs = [engine.submit(p, s, **(submit_kw[i] if submit_kw else {}))
                for i, (p, s) in enumerate(prompts)]
        engine.start()
        res = [r.future.result(timeout=120) for r in reqs]
    finally:
        engine.shutdown(drain=True)
    assert engine.error is None
    return res, engine.stats()


def _same(res, want, atol=ATOL):
    assert res.updated == want.updated
    assert np.array_equal(res.tokens, want.tokens)
    np.testing.assert_allclose(res.scores, want.scores, atol=atol, rtol=0)


SPEC_KEYS = ("drafted_tokens", "accepted_tokens", "rejected_tokens")


def test_spec_single_wave_matches_plain_and_jax(model_dir):
    """One wave under --speculative_k: the plain path's tokens in fewer
    sweeps, with the draft counters and sweeps equal to JAX's."""
    kw = dict(max_wave_requests=2, default_max_new_tokens=10)
    plain, p_stats = _serve(model_dir, "port", PROMPTS[:2], **kw)
    port, s_stats = _serve(model_dir, "port", PROMPTS[:2], speculative_k=SPEC_K, **kw)
    jax_, j_stats = _serve(model_dir, "jax", PROMPTS[:2], speculative_k=SPEC_K, **kw)
    for s, p, j in zip(port, plain, jax_):
        _same(s, p)
        _same(s, j)
    assert s_stats["spec"]["accepted_tokens"] > 0
    assert s_stats["sweeps"] < p_stats["sweeps"]
    assert s_stats["sweeps"] == j_stats["sweeps"]
    assert s_stats["tokens_emitted"] == p_stats["tokens_emitted"]
    for key in SPEC_KEYS:
        assert s_stats["spec"][key] == j_stats["spec"][key]
    assert (s_stats["spec"]["by_class"]["standard"]["accepted_tokens"]
            == s_stats["spec"]["accepted_tokens"])


def test_spec_mixed_budgets_and_a_late_wave_match_plain(model_dir):
    """A short and a long request in one spec wave and a late wave joining:
    the short one stops at its own budget, every stream equals the plain
    engine's and JAX's spec run, and speculation never adds a sweep."""
    def run(side, spec_k):
        engine = _engine(model_dir, side, max_wave_requests=2, default_max_new_tokens=N_GEN,
                         speculative_k=spec_k)
        try:
            short = engine.submit(*PROMPTS[0], max_new_tokens=2)
            long = engine.submit(*PROMPTS[1], max_new_tokens=6)
            deadline = time.monotonic() + 120
            while engine.metrics.counter("prefills") < 1:
                assert time.monotonic() < deadline
                time.sleep(0.002)
            late = engine.submit(*PROMPTS[2], max_new_tokens=4)
            out = [r.future.result(timeout=120) for r in (short, long, late)]
        finally:
            engine.shutdown(drain=True)
        assert engine.error is None
        return out, engine.stats()

    plain, p_stats = run("port", 0)
    port, s_stats = run("port", SPEC_K)
    jax_, _ = run("jax", SPEC_K)
    for s, p, j in zip(port, plain, jax_):
        _same(s, p)
        _same(s, j)
    assert port[0].tokens.shape[1] == 2 and port[1].tokens.shape[1] == 6
    assert s_stats["sweeps"] <= p_stats["sweeps"]


def test_zero_acceptance_costs_no_extra_sweeps(model_dir, monkeypatch):
    """Drafts that are always wrong: acceptance 0, the plain path's sweep
    count exactly, the plain tokens; JAX counts the same."""
    prompt = (PROMPTS[0][0], (PROMPTS[0][1][0],))
    plain, p_stats = _serve(model_dir, "port", [prompt], default_max_new_tokens=N_GEN)
    chain = [int(t) for t in plain[0].tokens[0]]
    from flexible_llm_sharding_tpu_torch.runtime.tokenization import PromptTokenizer

    tp = PromptTokenizer(_Vocab256(), bucket_multiple=8)(*prompt)
    base_len = tp.prefix_len + int(tp.suffix_eos[0]) + 1

    def anti_draft(context_ids, k, ngram=2, corpus=None):
        done = len(context_ids) - base_len
        return np.asarray([(chain[min(done + j, len(chain) - 1)] + 1) % 256 for j in range(k)],
                          np.int64)

    monkeypatch.setattr(decode, "propose_draft", anti_draft)
    monkeypatch.setattr(jdecode, "propose_draft", anti_draft)
    runs = {side: _serve(model_dir, side, [prompt], default_max_new_tokens=N_GEN,
                         speculative_k=SPEC_K) for side in ("port", "jax")}
    (port, s_stats), (jax_, j_stats) = runs["port"], runs["jax"]
    _same(port[0], plain[0])
    _same(port[0], jax_[0])
    assert s_stats["sweeps"] == p_stats["sweeps"] == j_stats["sweeps"]
    assert s_stats["spec"]["accepted_tokens"] == 0
    assert s_stats["spec"]["rejected_tokens"] == s_stats["spec"]["drafted_tokens"] > 0
    for key in SPEC_KEYS:
        assert s_stats["spec"][key] == j_stats["spec"][key]


@pytest.mark.parametrize("drafts", ["lookup", "adaptive_draft"])
def test_spec_coalesced_wave_matches_oracle_and_jax(model_dir, twin_draft_dir, drafts):
    """Same-prefix requests share one prefill, then draft per suffix (by
    prompt lookup, or by the resident draft under the adaptive controller);
    each equals its own plain run and JAX's."""
    prefix = "repeat repeat repeat repeat repeat"
    suffix_sets = [(" repeat repeat", " again again"), (" red blue", " blue red"),
                   (" one two", " two one")]
    prompts = [(prefix, s) for s in suffix_sets]
    plain, _ = _serve(model_dir, "port", prompts, max_wave_requests=1,
                      default_max_new_tokens=N_GEN)
    kw = dict(max_wave_requests=4, default_max_new_tokens=N_GEN, speculative_k=SPEC_K,
              sched={"enabled": True})
    if drafts == "adaptive_draft":
        kw.update(spec_adaptive=True, spec_k_max=SPEC_K, spec_window=1,
                  draft_model_path=twin_draft_dir)
    port, s_stats = _serve(model_dir, "port", prompts, **kw)
    jax_, j_stats = _serve(model_dir, "jax", prompts, **kw)
    for s, p, j in zip(port, plain, jax_):
        _same(s, p)
        _same(s, j)
    assert s_stats["prefills"] == j_stats["prefills"] == 1
    assert s_stats["sched"]["coalesced_requests"] == 3
    assert s_stats["spec"]["accepted_tokens"] == j_stats["spec"]["accepted_tokens"] > 0


def test_spec_preempted_wave_resumes_token_identical(model_dir):
    """A best-effort spec wave preempted by an interactive arrival keeps its
    steps up to its slowest suffix and resumes with them in its draft
    context; its whole stream equals the uninterrupted plain run's."""
    n_long = 6
    want, _ = _serve(model_dir, "port", [PROMPTS[0]], default_max_new_tokens=n_long)
    out = {}
    for side in ("port", "jax"):
        engine = _engine(model_dir, side, max_wave_requests=1, max_active_requests=1,
                         default_max_new_tokens=N_GEN, speculative_k=SPEC_K,
                         sched={"enabled": True})
        try:
            victim = engine.submit(*PROMPTS[0], max_new_tokens=n_long, slo_class="best_effort",
                                   tenant_id="batch")
            deadline = time.monotonic() + 120
            while engine.metrics.counter("prefills") < 1:
                assert time.monotonic() < deadline
                time.sleep(0.002)
            urgent = engine.submit(*PROMPTS[2], max_new_tokens=1, slo_class="interactive",
                                   tenant_id="live")
            res = (victim.future.result(timeout=120), urgent.future.result(timeout=120))
        finally:
            engine.shutdown(drain=True)
        assert engine.error is None
        assert urgent.finished_at < victim.finished_at
        assert engine._sched.stats()["preemptions"] >= 1
        out[side] = res
    _same(out["port"][0], want[0])
    _same(out["port"][0], out["jax"][0])
    _same(out["port"][1], out["jax"][1])


def _adaptive(draft_path, **kw):
    return dict(max_wave_requests=2, default_max_new_tokens=6, speculative_k=2,
                spec_adaptive=True, spec_k_max=4, spec_window=1, draft_model_path=draft_path,
                **kw)


def test_draft_model_adds_no_streamed_bytes_per_sweep(model_dir, twin_draft_dir):
    """The resident draft drafts every pass and every sweep still streams
    exactly the target once: the draft's bytes count once, at its pins.
    With the target's own weights every draft lands: fewer sweeps, k
    raised; counters and sweeps equal JAX's."""
    plain, p_stats = _serve(model_dir, "port", PROMPTS[2:], max_wave_requests=2,
                            default_max_new_tokens=6)
    per_sweep, rem = divmod(p_stats["stream"]["streamed_bytes"], p_stats["sweeps"])
    assert rem == 0 and per_sweep > 0
    port, a_stats = _serve(model_dir, "port", PROMPTS[2:], **_adaptive(twin_draft_dir))
    jax_, j_stats = _serve(model_dir, "jax", PROMPTS[2:], **_adaptive(twin_draft_dir))
    for a, p, j in zip(port, plain, jax_):
        _same(a, p)
        _same(a, j)
    assert a_stats["stream"]["streamed_bytes"] == per_sweep * a_stats["sweeps"]
    d = a_stats["draft"]
    assert d["draft_tokens"] > 0 and d["pinned_bytes"] == d["pin_stream_bytes"] > 0
    assert a_stats["sweeps"] < p_stats["sweeps"] and a_stats["sweeps"] == j_stats["sweeps"]
    assert a_stats["spec_ctrl"]["k_raises"] > 0
    assert a_stats["spec_ctrl"]["k_by_class"] == j_stats["spec_ctrl"]["k_by_class"]
    assert a_stats["spec_ctrl"]["assigned_tokens"] == a_stats["spec"]["drafted_tokens"]
    for key in SPEC_KEYS:
        assert a_stats["spec"][key] == j_stats["spec"][key]


def test_draft_budget_funds_interactive_first(model_dir, draft_dir):
    """A per-pass draft budget below the wave's appetite goes to the
    interactive row first; the clipped slots are counted; outputs equal the
    plain run's and JAX's."""
    submit_kw = [dict(slo_class="interactive", tenant_id="live"),
                 dict(slo_class="best_effort", tenant_id="batch")]
    plain, _ = _serve(model_dir, "port", PROMPTS[2:], submit_kw, max_wave_requests=2,
                      default_max_new_tokens=6, sched={"enabled": True})
    kw = _adaptive(draft_dir, spec_draft_budget=2, sched={"enabled": True})
    port, stats = _serve(model_dir, "port", PROMPTS[2:], submit_kw, **kw)
    jax_, j_stats = _serve(model_dir, "jax", PROMPTS[2:], submit_kw, **kw)
    for a, p, j in zip(port, plain, jax_):
        _same(a, p)
        _same(a, j)
    by_class = stats["spec"]["by_class"]
    assert by_class["interactive"]["drafted_tokens"] > 0
    assert by_class["interactive"]["drafted_tokens"] >= by_class["best_effort"]["drafted_tokens"]
    assert stats["spec_ctrl"]["budget_clipped_tokens"] > 0
    assert by_class == j_stats["spec"]["by_class"]
    assert stats["spec_ctrl"] == {k: j_stats["spec_ctrl"][k] for k in stats["spec_ctrl"]}


# ---------------------------------------------------------------------------
# Config and CLI
# ---------------------------------------------------------------------------

SPEC_CONFIGS = [
    dict(speculative_k=-1), dict(speculative_k=65), dict(spec_adaptive=True),
    dict(spec_k_min=5, spec_k_max=2), dict(speculative_k=8, spec_adaptive=True, spec_k_max=4),
    dict(spec_window=0), dict(spec_raise_threshold=0.1, spec_backoff_threshold=0.5),
    dict(spec_draft_budget=-1), dict(speculative_k=3, spec_adaptive=True, spec_k_max=6),
]


@pytest.mark.parametrize("kw", SPEC_CONFIGS, ids=[str(k) for k in SPEC_CONFIGS])
def test_spec_config_validates_as_jax(kw):
    def outcome(cls):
        try:
            cls(**kw)
        except ValueError as e:
            return str(e)
        return "ok"

    assert outcome(ServeConfig) == outcome(JServeConfig)


SPEC_FLAGS = [
    ["--speculative_k", "3"],
    ["--draft_model_path", "/drafts/d1"],
    ["--speculative_k", "2", "--spec_adaptive"],
    ["--spec_k_min", "1"],
    ["--spec_k_max", "6"],
    ["--spec_window", "4"],
    ["--spec_raise_threshold", "0.7"],
    ["--spec_backoff_threshold", "0.1"],
    ["--spec_draft_budget", "8"],
]
SPEC_FIELDS = ("speculative_k", "draft_model_path", "spec_adaptive", "spec_k_min", "spec_k_max",
               "spec_window", "spec_raise_threshold", "spec_backoff_threshold",
               "spec_draft_budget")


@pytest.mark.parametrize("argv", SPEC_FLAGS, ids=[" ".join(a) for a in SPEC_FLAGS])
def test_spec_flags_parse_as_jax(argv):
    def fields(mod):
        args = mod.build_serve_parser().parse_args(["--model_path", "/m", *argv])
        return {f: getattr(args, f) for f in SPEC_FIELDS}

    assert fields(cli) == fields(jcli)


def test_spec_flags_reach_the_engine_config(model_dir, tmp_path, monkeypatch):
    seen = {}

    class Stop(Exception):
        pass

    def fake_engine(cfg, serve_cfg, **kw):
        seen["serve_cfg"] = serve_cfg
        raise Stop

    monkeypatch.setattr(serve, "ServeEngine", fake_engine)
    with pytest.raises(Stop):
        cli.main(["serve", "--device", "cpu", "--model_path", model_dir, "--speculative_k", "2",
                  "--spec_adaptive", "--spec_k_max", "3", "--spec_draft_budget", "5", "--sched",
                  "--sched_tenant_weights", "a=2"], tokenizer=_Vocab256())
    sc = seen["serve_cfg"]
    assert (sc.speculative_k, sc.spec_adaptive, sc.spec_k_max, sc.spec_draft_budget) == (2, True,
                                                                                         3, 5)
    assert sc.sched.enabled and sc.sched.tenant_weight_map() == {"a": 2.0}


def test_offline_knob_still_refused(model_dir):
    with pytest.raises(ValueError, match="ServeConfig.speculative_k"):
        serve.ServeEngine(FrameworkConfig(model_path=model_dir, speculative_k=2, device="cpu"),
                          ServeConfig(), tokenizer=_Vocab256(), device=torch.device("cpu"),
                          start=False)
