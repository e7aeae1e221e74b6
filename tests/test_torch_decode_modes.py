"""The port's KV decode modes against the JAX package's, on the CPU in
float32: weights-resident decode, the KV placement rule, the fused greedy
steps (on the CPU the same device loop the card captures as one CUDA graph,
uncaptured) and speculative verify passes.

Every generator test runs the port's ``DecodeGenerator`` and the JAX one on
the same checkpoint and prompts with equal ``decode_resident``,
``decode_fused`` and ``speculative_k``, on tiny llama, gemma3 (windows of
6 that bind, local and global layers) and deepseek_v3 (MLA and experts)
checkpoints: scores within atol 1e-5 (float32 summation order), tokens,
updated strings, the decode stats and the host cache's hits and misses
equal. The helpers (``propose_draft``, ``SpecVerifier``, the model-size
formulas and the three memory gates at a given card memory) are held
against JAX's on scripted inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import BenchTokenizer
from flexible_llm_sharding_tpu.config import FrameworkConfig as JFrameworkConfig
from flexible_llm_sharding_tpu.config import LlamaConfig as JLlamaConfig
from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu.runtime import decode as jdecode
from flexible_llm_sharding_tpu.runtime import hostcache as jhostcache
from flexible_llm_sharding_tpu.runtime.schedcore import SchedCore as JSchedCore
from flexible_llm_sharding_tpu.runtime.tokenization import PromptTokenizer as JPromptTokenizer
from flexible_llm_sharding_tpu.runtime.tokenization import make_blocks as jmake_blocks
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu.utils import metrics as jmetrics
from flexible_llm_sharding_tpu_torch import cli
from flexible_llm_sharding_tpu_torch.config import FrameworkConfig, LlamaConfig
from flexible_llm_sharding_tpu_torch.models import llama
from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa
from flexible_llm_sharding_tpu_torch.runtime import decode, hostcache
from flexible_llm_sharding_tpu_torch.runtime.schedcore import SchedCore
from flexible_llm_sharding_tpu_torch.runtime.tokenization import PromptTokenizer, make_blocks
from flexible_llm_sharding_tpu_torch.utils import metrics
from flexible_llm_sharding_tpu_torch.utils.checkpoint import params_from_jax


class _Vocab256(BenchTokenizer):
    VOCAB = 256


# The JAX decode tests' repetition-heavy prompts (tests/test_decode.py), where
# prompt lookup accepts drafts, and one more prompt: two blocks of two
# bucket shapes, padded suffix rows, and a block that finishes early.
PROMPTS = [
    ("the cat sat on the mat the cat sat on the mat", (" the cat sat", " on the mat")),
    ("alpha beta gamma alpha beta gamma alpha", (" beta gamma alpha", " delta")),
    ("one two three four", (" five six",)),
]
N_GEN = 6

# (decode_resident, decode_fused, speculative_k, storage_location); the
# port's 'gpu' storage is the JAX package's 'tpu'.
MODES = {
    "streamed": ("off", "off", 0, "cpu"),
    "streamed_spec": ("off", "off", 4, "cpu"),
    "resident": ("on", "off", 0, "cpu"),
    "resident_spec": ("on", "off", 4, "cpu"),
    "fused": ("on", "on", 0, "cpu"),
    "fused_over_spec": ("on", "auto", 4, "cpu"),
    "kv_on_device": ("off", "off", 0, "gpu"),
}
DECODE_STATS = ("decode_resident", "decode_fused", "decode_speculative", "decode_kv_on_device",
                "tokens_processed", "spec_passes", "spec_drafted", "spec_accepted")


_SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=128, max_position_embeddings=512)
HF_CONFIGS = {
    "llama": dict(model_type="llama", **_SMALL, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2),
    # Layers 0-1 local (a window of 6 that binds at these prompts), layer 2 global.
    "gemma3": dict(model_type="gemma3_text", **_SMALL, num_hidden_layers=3, num_attention_heads=2,
                   num_key_value_heads=1, head_dim=64, query_pre_attn_scalar=64,
                   sliding_window=6, rope_theta=1000000.0, rope_local_base_freq=10000.0,
                   layer_types=["sliding_attention", "sliding_attention", "full_attention"]),
    # MLA (qk 16 + 8, v 12, q by LoRA); layer 0 dense, layer 1 experts (8 in
    # 4 groups, the best 2 kept); yarn.
    "deepseek_v3": dict(model_type="deepseek_v3", **_SMALL, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=4, moe_intermediate_size=32,
                        n_routed_experts=8, num_experts_per_tok=2, n_group=4, topk_group=2,
                        first_k_dense_replace=1, routed_scaling_factor=2.5, n_shared_experts=1,
                        norm_topk_prob=True, kv_lora_rank=16, q_lora_rank=24,
                        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=12,
                        rope_scaling={"type": "yarn", "factor": 4.0, "mscale": 1.0,
                                      "mscale_all_dim": 1.0, "beta_fast": 32, "beta_slow": 1,
                                      "original_max_position_embeddings": 32}),
}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Tiny llama, gemma3 and deepseek_v3 checkpoints: seeded weights of
    the Hugging Face configs above, saved by the JAX package."""
    root = tmp_path_factory.mktemp("decode_models")
    out = {}
    for i, (family, d) in enumerate(HF_CONFIGS.items()):
        cfg = JLlamaConfig.from_hf_config(d)
        init = jllama.init_mixed_params if cfg.moe_layer_pattern else jllama.init_params
        params = init(jax.random.PRNGKey(5 + i), cfg)
        jckpt.save_params(jax.tree.map(np.asarray, params), str(root / family), cfg)
        out[family] = str(root / family)
    return out


def _configs(model_dir, mode, n_gen=N_GEN, **kw):
    resident, fused, spec_k, storage = MODES[mode]
    common = dict(model_path=model_dir, dtype="float32", bucket_multiple=8, block_size=2,
                  prefetch_depth=0, num_gen_token=n_gen, decode_resident=resident,
                  decode_fused=fused, speculative_k=spec_k, **kw)
    return (FrameworkConfig(**common, storage_location=storage, device="cpu"),
            JFrameworkConfig(**common, storage_location="tpu" if storage == "gpu" else storage))


def _both(model_dir, mode, prompts=PROMPTS, **kw):
    cfg, jcfg = _configs(model_dir, mode, **kw)
    jhostcache.reset_process_cache()
    jgen = jdecode.DecodeGenerator(jcfg, tokenizer=_Vocab256())
    want, want_up = jgen(list(prompts))
    jcache = jhostcache.process_cache().stats()
    jhostcache.reset_process_cache()
    hostcache.reset_process_cache()
    gen = decode.DecodeGenerator(cfg, device=torch.device("cpu"), tokenizer=_Vocab256())
    got, got_up = gen(list(prompts))
    hostcache.reset_process_cache()
    return (got, got_up, gen.stats), (want, want_up, jgen.stats, jcache)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("family", ["llama", "gemma3", "deepseek_v3"])
def test_decoder_matches_jax(models, family, mode):
    (got, got_up, stats), (want, want_up, jstats, jcache) = _both(models[family], mode)
    for g, w, (_, sfx) in zip(got, want, PROMPTS):
        assert g.shape == w.shape == (len(sfx), N_GEN, 256)
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    assert got_up == want_up
    assert {k: stats[k] for k in DECODE_STATS if k in stats} == \
        {k: jstats[k] for k in DECODE_STATS if k in jstats}
    assert stats["decode_graph"] == 0.0  # the CPU never captures
    assert (stats["host_cache_hits"], stats["host_cache_misses"]) == \
        (jcache["hits"], jcache["misses"])
    resident, fused, spec_k, storage = MODES[mode]
    if resident == "on":  # one weight pass from a fresh cache: every lookup misses
        assert stats["host_cache_hits"] == 0 and stats["host_cache_misses"] > 0
    else:
        assert stats["host_cache_hits"] > 0
    assert stats["decode_kv_on_device"] == (storage == "gpu")
    if spec_k and fused == "off" and family == "llama":  # drafts land on this model
        assert stats["spec_accepted"] > 0


@pytest.mark.parametrize("n_gen", [1, 2])
def test_short_generations_match_jax(models, n_gen):
    """One token (prefill only, no decode step) and one decode step: the
    fused and speculative gates stand down or engage as JAX's do."""
    for mode in ("fused_over_spec", "resident_spec", "streamed_spec"):
        (got, got_up, stats), (want, want_up, jstats, _) = _both(models["llama"], mode,
                                                                 n_gen=n_gen)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
        assert got_up == want_up
        assert {k: stats[k] for k in DECODE_STATS if k in stats} == \
            {k: jstats[k] for k in DECODE_STATS if k in jstats}


def _raises_like_jax(model_dir, **kw):
    base = dict(model_path=model_dir, dtype="float32", bucket_multiple=8, block_size=2,
                prefetch_depth=0, num_gen_token=N_GEN, **kw)
    with pytest.raises(ValueError, match="decode_fused") as jerr:
        jdecode.DecodeGenerator(JFrameworkConfig(**base), tokenizer=_Vocab256())(list(PROMPTS))
    with pytest.raises(ValueError, match="decode_fused") as err:
        decode.DecodeGenerator(FrameworkConfig(**base, device="cpu"), device=torch.device("cpu"),
                               tokenizer=_Vocab256())(list(PROMPTS))
    return str(err.value), str(jerr.value)


@pytest.mark.parametrize("case", [
    dict(decode_resident="on", decode_fused="on", temperature=0.7),
    dict(decode_resident="off", decode_fused="on"),
], ids=["sampling", "streamed"])
def test_fused_on_raises_on_jax_preconditions(models, case):
    msg, jmsg = _raises_like_jax(models["llama"], **case)
    for part in ("resident=", "temperature=", "hbm_budget_ok="):
        assert part in msg and part in jmsg


def test_fused_on_raises_when_the_card_cannot_hold_it(models, monkeypatch):
    """decode_fused='on' on a card whose memory holds weights but not the
    stacked distributions: both packages refuse, naming the budget."""
    cfg, jcfg = _configs(models["llama"], "fused")
    gen = decode.DecodeGenerator(cfg, device=torch.device("cpu"), tokenizer=_Vocab256())
    jgen = jdecode.DecodeGenerator(jcfg, tokenizer=_Vocab256())
    gen._probe_dev = torch.device("cuda")
    jgen._probe_dev = _FakeDev(1e-4)
    monkeypatch.setattr(metrics, "chip_hbm_gb", lambda device=None: 1e-4)
    for g in (gen, jgen):
        with pytest.raises(ValueError, match="hbm_budget_ok=False"):
            g(list(PROMPTS))


def test_speculative_needs_greedy_in_both_configs():
    for cls in (FrameworkConfig, JFrameworkConfig):
        with pytest.raises(ValueError, match="speculative_k requires greedy"):
            cls(speculative_k=2, temperature=0.5)
        with pytest.raises(ValueError, match="speculative_k must be in"):
            cls(speculative_k=65)
        for field in ("decode_resident", "decode_fused"):
            with pytest.raises(ValueError, match=field):
                cls(**{field: "maybe"})


# -- speculative helpers on scripted inputs -----------------------------------

DRAFT_CASES = [
    ([5, 6, 7, 5, 6, 9, 4, 5, 6], 3, None),
    ([5, 6, 7, 5, 6], 4, None),  # the continuation runs out: padded with its last
    ([1, 2, 3, 4], 2, [[9, 3, 4, 8, 7], [4, 4]]),  # no own match, a sibling's
    ([8], 3, None),
    ([1, 2, 1, 2, 1, 2], 5, [[2, 7]]),
    (list(range(600)) + [3, 4], 2, None),  # the match lies before the scan window
    (list(range(300)) + [7, 8] + list(range(300)) + [7], 3, None),
]


@pytest.mark.parametrize("ctx,k,corpus", DRAFT_CASES)
def test_propose_draft_matches_jax(ctx, k, corpus):
    for ngram in (1, 2, 3):
        np.testing.assert_array_equal(
            decode.propose_draft(ctx, k, ngram, corpus=corpus),
            jdecode.propose_draft(ctx, k, ngram, corpus=corpus))


def _scripted_draft(context_ids, k, corpus=None):
    c = np.asarray(context_ids)
    return (c[-1] * 7 + np.arange(1, k + 1) + (3 if corpus else 0)) % 11


def _scripted_draft_no_corpus(context_ids, k):
    return (np.asarray(context_ids)[-1] + np.arange(k)) % 11


@pytest.mark.parametrize("draft_fn", [None, _scripted_draft, _scripted_draft_no_corpus],
                         ids=["prompt_lookup", "corpus", "no_corpus"])
@pytest.mark.parametrize("spec_k", [1, 3])
def test_spec_verifier_matches_jax(draft_fn, spec_k):
    """Two verifiers fed the same distributions pass by pass (argmax chains
    that follow the drafts for a while, then diverge): the same fed
    tokens, slot offsets, emissions, histories and counters."""
    rng = np.random.default_rng(spec_k)
    bsz, s_b, v = 2, 3, 11
    budgets = np.array([[5, 3, 7], [1, 6, 4]])
    active = [[True, True, True], [True, False, True]]
    contexts = [[rng.integers(0, v, size=rng.integers(2, 9)) for _ in range(s_b)]
                for _ in range(bsz)]
    init_dist = rng.dirichlet(np.ones(v), size=(bsz, s_b)).astype(np.float32)
    init_toks = init_dist.argmax(-1)
    mine = decode.SpecVerifier(spec_k, draft_fn, contexts, budgets, init_dist, init_toks, active)
    ref = jdecode.SpecVerifier(spec_k, draft_fn, contexts, budgets, init_dist, init_toks, active)
    while not ref.done:
        fed, base = mine.begin_pass()
        jfed, jbase = ref.begin_pass()
        np.testing.assert_array_equal(fed, jfed)
        np.testing.assert_array_equal(base, jbase)
        dist = rng.dirichlet(np.ones(v), size=(bsz, s_b, spec_k + 1)).astype(np.float32)
        # Make the argmax follow the drafts at a random depth.
        for r in range(bsz):
            for s in range(s_b):
                for j in range(rng.integers(0, spec_k + 1)):
                    dist[r, s, j, fed[r, s, j + 1]] += 2.0
        np.testing.assert_array_equal(mine.finish_pass(dist), ref.finish_pass(dist))
        counters = ("passes", "drafted", "accepted", "rejected", "done")
        assert [getattr(mine, c) for c in counters] == [getattr(ref, c) for c in counters]
    assert mine.hist_t == ref.hist_t
    for r in range(bsz):
        for s in range(s_b):
            np.testing.assert_array_equal(np.stack(mine.hist_d[r][s]), np.stack(ref.hist_d[r][s]))
    n = int(budgets.min())
    for a, b in zip(mine.step_major(n), ref.step_major(n)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert mine.accepted > 0 or draft_fn is None


def test_draft_contexts_match_jax():
    toks = [PromptTokenizer(_Vocab256(), bucket_multiple=8)(p, s) for p, s in PROMPTS[:2]]
    jtoks = [JPromptTokenizer(_Vocab256(), bucket_multiple=8)(p, s) for p, s in PROMPTS[:2]]
    t0 = np.arange(2 * toks[0].suffix_ids.shape[0]).reshape(2, -1) + 3
    for a, b in zip(decode.draft_contexts(toks, t0), jdecode.draft_contexts(jtoks, t0)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


# -- model sizes and the memory gates -------------------------------------------

def _published():
    from test_torch_config import PUBLISHED

    return PUBLISHED


def _toks_blocks(port: bool):
    tok = (PromptTokenizer if port else JPromptTokenizer)(_Vocab256(), bucket_multiple=8)
    toks = [tok(p, s) for p, s in PROMPTS]
    return toks, (make_blocks if port else jmake_blocks)(toks, 2)


@pytest.mark.parametrize("name", list(_published()))
def test_model_sizes_match_jax(name):
    d = _published()[name]
    cfg, jcfg = LlamaConfig.from_dict(d), JLlamaConfig.from_hf_config(d)
    assert metrics.param_count(cfg) == jmetrics.param_count(jcfg)
    assert metrics.has_moe_layers(cfg) == any(jmetrics._arch_walk(jcfg)[1])
    for dtype in ("float32", "bfloat16", "float16"):
        for n_chips in (1, 8):
            assert metrics.weight_bytes_per_chip(cfg, dtype, n_chips) == \
                jmetrics.weight_bytes_per_chip(jcfg, dtype, n_chips)
        (toks, blocks), (jtoks, jblocks) = _toks_blocks(True), _toks_blocks(False)
        for slots in (1, 5, 10):
            for idxs, jidxs in zip(blocks, jblocks):
                assert decode.block_kv_bytes(cfg, dtype, toks, idxs, slots) == \
                    jdecode.block_kv_bytes(jcfg, dtype, jtoks, jidxs, slots)


class _FakeDev:
    """A JAX device of a given memory (the allocator's ``bytes_limit``)."""

    device_kind = "fake"

    def __init__(self, gb):
        self.gb = gb

    def memory_stats(self):
        return {"bytes_limit": self.gb * 1e9}


@pytest.mark.parametrize("hbm_gb", [None, 16.0, 85.0])
@pytest.mark.parametrize("name", ["llama-2-7b", "gemma-3-12b-pt", "deepseek-v3"])
def test_resident_and_kv_gates_match_jax(monkeypatch, name, hbm_gb):
    """At a given card memory (the probe patched on both sides; None is
    the CPU's unknown memory): the resident gate for every tri-state and
    chip count, the KV placement and SchedCore's decision."""
    d = {**_published()[name]}
    text = d.get("text_config", d)
    cfgs = []
    for layers in (4, text["num_hidden_layers"]):
        dd = {**d, "text_config": {**text, "num_hidden_layers": layers}} if "text_config" in d \
            else {**d, "num_hidden_layers": layers}
        cfgs.append((LlamaConfig.from_dict(dd), JLlamaConfig.from_hf_config(dd)))
    monkeypatch.setattr(metrics, "chip_hbm_gb", lambda device=None: hbm_gb)
    dev, jdev = torch.device("cuda"), (_FakeDev(hbm_gb) if hbm_gb else jax.devices()[0])
    (toks, blocks), (jtoks, jblocks) = _toks_blocks(True), _toks_blocks(False)
    for cfg, jcfg in cfgs:
        for mode in ("auto", "on", "off"):
            for dtype in ("bfloat16", "float32"):
                for n in (1, 8, 64):
                    fw = FrameworkConfig(decode_resident=mode, dtype=dtype)
                    jfw = JFrameworkConfig(decode_resident=mode, dtype=dtype)
                    assert fw.decode_resident_enabled(cfg, n, dev) == \
                        jfw.decode_resident_enabled(jcfg, n, jdev)
        for slots in (1, 7, 10**6):
            for n in (1, 8):
                assert decode.kv_fits_on_chip(cfg, "bfloat16", toks, blocks, slots, dev, n) == \
                    jdecode.kv_fits_on_chip(jcfg, "bfloat16", jtoks, jblocks, slots, jdev, n)
            for storage, jstorage in (("cpu", "cpu"), ("gpu", "tpu")):
                core = SchedCore(FrameworkConfig(storage_location=storage))
                jcore = JSchedCore(JFrameworkConfig(storage_location=jstorage))
                for resident in (False, True):
                    assert core.kv_on_device(cfg, "bfloat16", toks, blocks, slots, resident,
                                             device=dev) == \
                        jcore.kv_on_device(jcfg, "bfloat16", jtoks, jblocks, slots, resident,
                                           device=jdev)


@pytest.mark.parametrize("hbm_gb", [1e-3, 16.0, None])
def test_fused_budget_gate_matches_jax(models, monkeypatch, hbm_gb):
    """The fused footprint gate through both generators: on a card of known
    memory it fits the tiny workload and refuses a huge one; of unknown
    memory it stands down; on the CPU it always holds."""
    cfg, jcfg = _configs(models["llama"], "fused")
    gen = decode.DecodeGenerator(cfg, device=torch.device("cpu"), tokenizer=_Vocab256())
    jgen = jdecode.DecodeGenerator(jcfg, tokenizer=_Vocab256())
    toks = [gen.tokenizer(p, s) for p, s in PROMPTS]
    jtoks = [jgen.tokenizer(p, s) for p, s in PROMPTS]
    blocks, jblocks = make_blocks(toks, 2), jmake_blocks(jtoks, 2)
    cases = [(N_GEN, N_GEN - 1), (10**6, 10**6)]
    for probe, jprobe in ((torch.device("cpu"), None),
                          (torch.device("cuda"), _FakeDev(hbm_gb) if hbm_gb else _NoMemDev())):
        gen._probe_dev, jgen._probe_dev = probe, jprobe
        monkeypatch.setattr(metrics, "chip_hbm_gb",
                            lambda device=None: None if device.type == "cpu" else hbm_gb)
        for n_gen, slots in cases:
            for on_dev in (False, True):
                assert gen._fused_budget_ok(toks, blocks, n_gen, slots, on_dev) == \
                    jgen._fused_budget_ok(jtoks, jblocks, n_gen, slots, on_dev)
                assert decode.kv_fits_on_chip(gen.model_cfg, "float32", toks, blocks, slots,
                                              device=gen._probe_dev) == \
                    jgen._kv_fits_on_chip(jtoks, jblocks, slots)


class _NoMemDev:
    """A JAX accelerator of unknown memory."""

    device_kind = "unknown accelerator"
    platform = "gpu"

    def memory_stats(self):
        return None


def test_chip_memory_probe_on_the_cpu_is_unknown():
    assert metrics.chip_hbm_gb(torch.device("cpu")) is None
    assert jmetrics.chip_hbm_gb(jax.devices()[0]) is None
    assert not FrameworkConfig().decode_resident_enabled(LlamaConfig(), 1, torch.device("cpu"))


@pytest.mark.parametrize("budget,spec_k", [(1, 0), (2, 0), (6, 0), (6, 4), (1, 8), (3, 64)])
def test_gen_slots_and_extended_kv_match_jax(budget, spec_k):
    for speculative in (False, True):
        slots = SchedCore().gen_slots(budget, spec_k, speculative)
        assert slots == JSchedCore().gen_slots(budget, spec_k, speculative)
    kv = {"kp": torch.zeros(2, 9, 4, 24), "vp": torch.zeros(2, 9, 4, 12),
          "ks": torch.ones(2, 3, 5, 4, 24), "vs": torch.ones(2, 3, 5, 4, 12)}
    jkv = {k: jnp.asarray(v.numpy())[None] for k, v in kv.items()}
    got = decode.extend_gen_kv(kv, slots)
    want = jdecode.extend_gen_kv(jkv, slots, jnp.float32)
    for k in ("kg", "vg"):
        assert tuple(got[k].shape) == want[k].shape[1:] and not got[k].any()
    assert got["ks"] is kv["ks"]


# -- the layer and the head ----------------------------------------------------

def _layer_inputs(jcfg, b, s, k, t_max, seed):
    rng = np.random.default_rng(seed)
    lp, ls, d = 12, 6, jcfg.hidden_size
    nkv, hd = jcfg.num_key_value_heads, jcfg.head_dim

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    kv = {"kp": rnd(b, lp, nkv, hd), "vp": rnd(b, lp, nkv, hd), "ks": rnd(b, s, ls, nkv, hd),
          "vs": rnd(b, s, ls, nkv, hd), "kg": rnd(b, s, t_max, nkv, hd),
          "vg": rnd(b, s, t_max, nkv, hd)}
    plen = np.array([9, 12][:b], np.int32)
    eos = rng.integers(0, ls, size=(b, s)).astype(np.int32)
    return rnd(b, s, k, d), kv, plen, eos


@pytest.mark.parametrize("k,per_suffix,sliding", [
    (1, False, None), (1, False, False), (3, False, True), (3, True, True), (3, True, False),
    (5, True, None),
])
def test_decode_step_layer_matches_jax(k, per_suffix, sliding):
    """K fed tokens per suffix at a shared or per-suffix slot offset
    (speculative passes): the layer output and the written slots equal
    JAX's (vmapped over the block), with a window of 7 on local layers."""
    kw = dict(model_type="mistral", vocab_size=64, hidden_size=64, intermediate_size=96,
              num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2, sliding_window=7)
    jcfg = JLlamaConfig(**kw)
    cfg = LlamaConfig.from_dict({"fls_native": True, **kw})
    params_np = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(2), jcfg))
    params = params_np["layers"][0]
    b, s, t_max = 2, 3, 9
    x, kv, plen, eos = _layer_inputs(jcfg, b, s, k, t_max, seed=k)
    t = (np.array([[0, 2, 4], [6, 1, 3]], np.int32) if per_suffix else 2)

    def one(xb, kvb, pl, se, tb):
        return jllama.decode_step_layer(params, jcfg, xb, kvb, pl, se, tb, sliding=sliding)

    want_x, want_kv = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, 0 if per_suffix else None)))(
        x, kv, plen, eos, jnp.asarray(t))
    tkv = {n: torch.from_numpy(v.copy()) for n, v in kv.items()}
    got_x = llama.decode_step_layer(
        params_from_jax(params_np, cfg)["layers"][0], cfg,
        torch.from_numpy(x), tkv, torch.from_numpy(plen), torch.from_numpy(eos),
        torch.from_numpy(t) if per_suffix else t, sliding=sliding, use_pallas=True)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=1e-5, rtol=0)
    for n in ("kg", "vg"):
        np.testing.assert_allclose(tkv[n].numpy(), np.asarray(want_kv[n]), atol=1e-5, rtol=0)


def test_lm_head_scores_multi_matches_jax():
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    w = rng.standard_normal((16, 40)).astype(np.float32)
    for softcap in (None, 5.0):
        got = llama.lm_head_scores_multi({"kernel": torch.from_numpy(w)}, torch.from_numpy(h),
                                         softcap)
        want = jllama.lm_head_scores_multi({"kernel": jnp.asarray(w)}, jnp.asarray(h), softcap)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


# -- launch accounting of captured graphs, the CLI --------------------------------

def test_graph_capture_moves_counts_to_replays():
    """Launches counted while a graph is captured are taken back out and
    added once per replay, for every counter."""
    fa.reset_launch_counts()
    fa._count(fa.flash_decode_attention, 0, 0, (128, 128))
    with fa.graph_capture() as captured:
        for window in (0, 32, 0):
            fa._count(fa.flash_decode_attention, window, 0, (128, 128))
        fa._count(fa.flash_causal_attention, 0, 0, (64, 64))
    assert fa.launch_counts()["flash_decode_attention"] == 1
    assert fa.launch_counts()["flash_causal_attention"] == 0
    for _ in range(2):
        fa.count_replay(captured)
    assert fa.launch_counts() == {"flash_causal_attention": 2, "flash_prefix_shared_attention": 0,
                                  "flash_decode_attention": 7}
    assert fa.local_launch_counts()["flash_decode_attention"] == 2
    assert fa.dim_launch_counts() == {"flash_causal_attention": {(64, 64): 2},
                                      "flash_prefix_shared_attention": {},
                                      "flash_decode_attention": {(128, 128): 7}}
    fa.reset_launch_counts()


def test_cli_decode_flags_match_jax_cli():
    from flexible_llm_sharding_tpu.cli import build_parser as jbuild

    args = cli.build_parser().parse_args(["--prompt_pickle", "p", "--output_file", "o"])
    jargs = jbuild().parse_args(["--prompt_pickle", "p", "--output_file", "o"])
    for flag in ("decode_resident", "decode_fused", "speculative_k"):
        assert getattr(args, flag) == getattr(jargs, flag)


def test_cli_speculative_run_matches_jax_cli(models, tmp_path):
    """The CLI with --speculative_k 4 over resident weights: the JAX CLI's
    scores and updated prompts, the decode stats on the stats line."""
    import pickle

    from flexible_llm_sharding_tpu.cli import main as jax_main

    ppkl = tmp_path / "p.pkl"
    ppkl.write_bytes(pickle.dumps(PROMPTS))
    out = {}
    for tag, main, extra in (("jax", jax_main, ["--num_devices", "1"]),
                             ("torch", cli.main, ["--device", "cpu"])):
        stats = main(["--model_path", models["gemma3"], "--prompt_pickle", str(ppkl),
                      "--output_file", str(tmp_path / f"{tag}.pkl"), "--dtype", "float32",
                      "--bucket_multiple", "8", "--block_size", "2", "--kv_cache", "true",
                      "--num_gen_token", str(N_GEN), "--speculative_k", "4",
                      "--decode_resident", "on", "--decode_fused", "off", *extra],
                     tokenizer=_Vocab256())
        out[tag] = (pickle.loads((tmp_path / f"{tag}.pkl").read_bytes()),
                    pickle.loads((tmp_path / "p_updated.pkl").read_bytes()), stats)
    (got, got_up, stats), (want, want_up, _) = out["torch"], out["jax"]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    assert got_up == want_up
    assert (stats["decode_resident"], stats["decode_speculative"], stats["decode_fused"]) == \
        (1.0, 1.0, 0.0)
    assert stats["spec_accepted"] > 0 and stats["spec_passes"] <= N_GEN - 1
