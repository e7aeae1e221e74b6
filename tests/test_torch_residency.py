"""The port's device residency tier against the JAX package's, on the CPU in
float32 (the single-device cases of JAX ``tests/test_residency.py``): the
planner's choices and byte estimates, the budget resolution and its
explicit-versus-auto rule, ``--hbm_pin_gb 0`` as a no-op, a full pin that
streams nothing, a partial pin that streams exactly the pinned bytes fewer
per pass, a pin inside a shard, decode with pins, a persistently corrupt
pin demoted and never pinned, and the ``verify --hbm_pin_gb`` dry run.
Every pinned run's scores equal the unpinned run's bit for bit and JAX's
within atol 1e-5."""

import contextlib
import io
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from bench import BenchTokenizer
from flexible_llm_sharding_tpu import cli as jcli
from flexible_llm_sharding_tpu.config import FrameworkConfig as JFrameworkConfig
from flexible_llm_sharding_tpu.config import LlamaConfig as JLlamaConfig
from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu.runtime import executor as jexecutor
from flexible_llm_sharding_tpu.runtime import hostcache as jhostcache
from flexible_llm_sharding_tpu.runtime import precisionplan as jpp
from flexible_llm_sharding_tpu.runtime import residency as jresidency
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu_torch import cli
from flexible_llm_sharding_tpu_torch.config import FrameworkConfig
from flexible_llm_sharding_tpu_torch.integrity import manifest
from flexible_llm_sharding_tpu_torch.integrity.manifest import ShardCorruptError
from flexible_llm_sharding_tpu_torch.runtime import decode, executor, hostcache, residency
from flexible_llm_sharding_tpu_torch.utils.checkpoint import layer_names_for

CPU = torch.device("cpu")


class _Vocab256(BenchTokenizer):
    VOCAB = 256


PROMPTS = [
    ("the cat sat on the mat the cat sat on the mat", (" the cat sat", " on the mat")),
    ("alpha beta gamma alpha beta gamma alpha", (" beta gamma alpha", " delta")),
    ("one two three four", (" five six",)),
    ("a b c d e f", (" g", " h i")),
]
NAMES = layer_names_for(4)
HF = dict(model_type="llama", vocab_size=256, hidden_size=64, intermediate_size=128,
          max_position_embeddings=512, num_hidden_layers=4, num_attention_heads=4,
          num_key_value_heads=2)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{"f32", "int4", "mixed", "tied_q4"}: a 4-layer llama saved by the JAX
    package, its int4 and mixed requantizations, and a tied int4 copy."""
    root = tmp_path_factory.mktemp("residency")
    cfg = JLlamaConfig.from_hf_config(HF)
    params = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(3), cfg))
    out = {"f32": str(root / "f32")}
    jckpt.save_params(params, out["f32"], cfg)
    out["int4"] = str(root / "int4")
    jckpt.requantize_native(out["f32"], out["int4"], dtype="int4")
    plan = jpp.PrecisionPlan(layers=tuple(
        (n, {"model.layers.0": "bf16", "model.layers.1": "int8"}.get(n, "int4")) for n in NAMES),
        divergence_cap=1.0)
    out["mixed"] = str(root / "mixed")
    jckpt.requantize_native(out["f32"], out["mixed"], plan=plan)
    tcfg = JLlamaConfig.from_hf_config({**HF, "tie_word_embeddings": True})
    tparams = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(4), tcfg))
    jckpt.save_params(tparams, str(root / "tied"), tcfg)
    out["tied_q4"] = str(root / "tied_q4")
    jckpt.requantize_native(str(root / "tied"), out["tied_q4"], dtype="int4")
    return out


@pytest.fixture(autouse=True)
def _fresh_process_state():
    for mod in (residency, jresidency):
        mod.reset_process_tier()
    hostcache.reset_process_cache()
    jhostcache.reset_process_cache()
    manifest.reset_verdicts()
    yield
    for mod in (residency, jresidency):
        mod.reset_process_tier()
    hostcache.reset_process_cache()


def _fw(model_dir, **kw) -> FrameworkConfig:
    base = dict(model_path=model_dir, layer_num_per_shard=1, storage_location="cpu",
                dtype="float32", bucket_multiple=8, block_size=2, prefetch_depth=0,
                host_cache_gb=0.0, io_retry_attempts=8, io_retry_base_s=0.001, device="cpu")
    base.update(kw)
    return FrameworkConfig(**base)


def _jfw(model_dir, **kw) -> JFrameworkConfig:
    base = dict(model_path=model_dir, layer_num_per_shard=1, storage_location="cpu",
                dtype="float32", bucket_multiple=8, block_size=2, prefetch_depth=0,
                host_cache_gb=0.0)
    base.update(kw)
    return JFrameworkConfig(**base)


def _run(cfg):
    ex = executor.StreamingExecutor(cfg, device=CPU, tokenizer=_Vocab256())
    return ex(list(PROMPTS)), ex


def _sizes(d):
    return residency.layer_stream_bytes(d, NAMES, False)


def _partial_budget_gb(d) -> float:
    """Pins embed + norm + lm_head + one block and no more."""
    s = _sizes(d)
    return (s[0] + s[5] + s[6] + s[1] + 16) / 1e9


# -- the planner -----------------------------------------------------------------

@pytest.mark.parametrize("which", ["f32", "int4", "mixed", "tied_q4"])
@pytest.mark.parametrize("budget", ["hot", "hot+1", "small", "all", "zero", "half"])
def test_plan_residency_matches_jax(dirs, which, budget):
    d = dirs[which]
    tied = which == "tied_q4"
    sizes = residency.layer_stream_bytes(d, NAMES, tied)
    assert sizes == jresidency.layer_stream_bytes(d, NAMES, tied)
    hot = sizes[0] + sizes[5] + sizes[6]
    b = {"hot": hot, "hot+1": hot + sizes[1], "small": sizes[5] + 1, "all": 1 << 40, "zero": 0,
         "half": sum(sizes.values()) // 2}[budget]
    got = residency.plan_residency(d, NAMES, b, tied)
    want = jresidency.plan_residency(d, NAMES, b, tied)
    assert (got.budget_bytes, got.pinned, got.layer_bytes, got.skipped) == \
        (want.budget_bytes, want.pinned, want.layer_bytes, want.skipped)
    assert got.pinned_bytes_est <= max(b, 0)
    if budget == "hot":
        assert got.pinned == (0, 5, 6)
    if which == "mixed" and budget == "hot+1":
        assert got.pinned == (0, 1, 5, 6)  # the bf16 decoder first
    if which == "tied_q4":  # the tied head streams its int8 requantization
        assert sizes[6] == 64 * 256 + 4 * 256


def test_full_pin_plan_pins_everything(dirs):
    plan = residency.full_pin_plan(dirs["f32"], NAMES)
    assert plan.pinned == tuple(range(7)) and plan.pinned_fraction == 1.0


def test_config_validation_and_budget_resolution(dirs, monkeypatch):
    d = dirs["f32"]
    with pytest.raises(ValueError, match="hbm_pin_gb"):
        _fw(d, hbm_pin_gb=-1.0)
    assert FrameworkConfig().hbm_pin_gb == JFrameworkConfig().hbm_pin_gb == 0.0
    assert _fw(d, hbm_pin_gb=0.0).effective_hbm_pin_bytes() == 0
    assert _fw(d, hbm_pin_gb=2.0).effective_hbm_pin_bytes() == int(2e9)
    assert _fw(d, hbm_pin_gb=None).effective_hbm_pin_bytes(CPU) == 0  # off on the CPU
    assert residency.auto_pin_budget_bytes(CPU) == 0
    # On a card: the free memory less 35% of the total.
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (70 * 10**9, 80 * 10**9))
    assert residency.auto_pin_budget_bytes(torch.device("cuda")) == int(70e9 - 0.35 * 80e9)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (20 * 10**9, 80 * 10**9))
    assert residency.auto_pin_budget_bytes(torch.device("cuda")) == 0


def test_explicit_budget_pins_tier_against_auto_growth(dirs):
    d = dirs["f32"]
    capped = residency.tier_for(_fw(d, hbm_pin_gb=1.0), NAMES, False, CPU)
    assert capped is not None and capped.plan.budget_bytes == int(1e9)
    assert residency.tier_for(_fw(d, hbm_pin_gb=None), NAMES, False, CPU) is None
    assert capped.plan.budget_bytes == int(1e9)
    again = residency.tier_for(_fw(d, hbm_pin_gb=0.5), NAMES, False, CPU)
    assert again is capped and again.plan.budget_bytes == int(5e8)


def _auto(monkeypatch, auto_budget):
    monkeypatch.setattr(
        FrameworkConfig, "effective_hbm_pin_bytes",
        lambda self, device=None: (auto_budget[0] if self.hbm_pin_gb is None
                                   else int(self.hbm_pin_gb * 1e9)))


def test_tier_for_install_race_applies_losers_explicit_cap(dirs, monkeypatch):
    d = dirs["f32"]
    real_plan = residency.plan_residency
    raced, loser_plans = [], []

    def racing_plan(path, layer_names, budget_bytes, tied_embeddings=False):
        if budget_bytes == int(5e8):
            loser_plans.append(budget_bytes)
        plan = real_plan(path, layer_names, budget_bytes, tied_embeddings)
        if not raced:
            raced.append(True)
            key = (os.path.abspath(d), "float32", True, tuple(layer_names), bool(tied_embeddings))
            with residency._PROCESS_LOCK:
                residency._PROCESS_TIER = residency.DeviceResidencyTier(
                    d, layer_names, real_plan(path, layer_names, int(2e9), tied_embeddings))
                residency._PROCESS_TIER_KEY = key
                residency._PROCESS_BUDGET_EXPLICIT = False
        return plan

    monkeypatch.setattr(residency, "plan_residency", racing_plan)
    tier = residency.tier_for(_fw(d, hbm_pin_gb=0.5), NAMES, False, CPU)
    assert tier is residency.process_tier()
    assert tier.plan.budget_bytes == int(5e8)
    assert residency._PROCESS_BUDGET_EXPLICIT is True
    assert loser_plans == [int(5e8)]


def test_auto_grow_apply_revalidates_against_explicit_cap(dirs, monkeypatch):
    d = dirs["f32"]
    real_plan = residency.plan_residency
    auto_budget = [int(1e9)]
    _auto(monkeypatch, auto_budget)
    seeded = residency.tier_for(_fw(d, hbm_pin_gb=None), NAMES, False, CPU)
    assert seeded is not None and not residency._PROCESS_BUDGET_EXPLICIT
    auto_budget[0] = int(2e9)
    raced = []

    def racing_plan(path, layer_names, budget_bytes, tied_embeddings=False):
        if budget_bytes == int(2e9) and not raced:
            raced.append(True)
            residency.tier_for(_fw(d, hbm_pin_gb=0.5), NAMES, False, CPU)
        return real_plan(path, layer_names, budget_bytes, tied_embeddings)

    monkeypatch.setattr(residency, "plan_residency", racing_plan)
    grown = residency.tier_for(_fw(d, hbm_pin_gb=None), NAMES, False, CPU)
    assert grown is seeded and grown.plan.budget_bytes == int(5e8)
    assert residency._PROCESS_BUDGET_EXPLICIT is True


def test_auto_grow_apply_revalidates_against_bigger_auto(dirs, monkeypatch):
    d = dirs["f32"]
    real_plan = residency.plan_residency
    auto_budget = [int(1e9)]
    _auto(monkeypatch, auto_budget)
    seeded = residency.tier_for(_fw(d, hbm_pin_gb=None), NAMES, False, CPU)
    assert seeded.plan.budget_bytes == int(1e9)
    auto_budget[0] = int(15e8)
    raced = []

    def racing_plan(path, layer_names, budget_bytes, tied_embeddings=False):
        if budget_bytes == int(15e8) and not raced:
            raced.append(True)
            auto_budget[0] = int(2e9)
            residency.tier_for(_fw(d, hbm_pin_gb=None), NAMES, False, CPU)
        return real_plan(path, layer_names, budget_bytes, tied_embeddings)

    monkeypatch.setattr(residency, "plan_residency", racing_plan)
    grown = residency.tier_for(_fw(d, hbm_pin_gb=None), NAMES, False, CPU)
    assert grown is seeded and grown.plan.budget_bytes == int(2e9)
    assert residency._PROCESS_BUDGET_EXPLICIT is False


def test_failed_explicit_resize_does_not_latch_explicit(dirs, monkeypatch):
    d = dirs["f32"]
    real_plan = residency.plan_residency
    auto_budget = [int(1e9)]
    _auto(monkeypatch, auto_budget)
    seeded = residency.tier_for(_fw(d, hbm_pin_gb=None), NAMES, False, CPU)

    def failing_plan(path, layer_names, budget_bytes, tied_embeddings=False):
        if budget_bytes == int(5e8):
            raise OSError("transient stat failure")
        return real_plan(path, layer_names, budget_bytes, tied_embeddings)

    monkeypatch.setattr(residency, "plan_residency", failing_plan)
    with pytest.raises(OSError):
        residency.tier_for(_fw(d, hbm_pin_gb=0.5), NAMES, False, CPU)
    assert residency._PROCESS_BUDGET_EXPLICIT is False
    assert seeded.plan.budget_bytes == int(1e9)
    auto_budget[0] = int(2e9)
    grown = residency.tier_for(_fw(d, hbm_pin_gb=None), NAMES, False, CPU)
    assert grown is seeded and grown.plan.budget_bytes == int(2e9)


# -- streaming with pins -----------------------------------------------------------

@pytest.fixture(scope="module")
def clean(dirs):
    """Unpinned scores and streamed bytes per checkpoint (port), and JAX's."""
    out = {}
    for which in ("f32", "int4"):
        residency.reset_process_tier()
        got, ex = _run(_fw(dirs[which]))
        want = jexecutor.StreamingExecutor(_jfw(dirs[which]), tokenizer=_Vocab256())(list(PROMPTS))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
        out[which] = (got, ex.stats["streamed_bytes"])
    return out


def test_hbm_pin_zero_is_a_noop(dirs, clean):
    got, ex = _run(_fw(dirs["f32"], hbm_pin_gb=0.0))
    assert ex._residency is None and residency.process_tier() is None
    for k in ("pinned_bytes", "stream_bytes_saved", "pin_hits"):
        assert k not in ex.stats
    for g, w in zip(got, clean["f32"][0]):
        np.testing.assert_array_equal(g, w)
    assert ex.stats["streamed_bytes"] == clean["f32"][1]


@pytest.mark.parametrize("which", ["f32", "int4"])
def test_full_pin_parity_and_zero_stream(dirs, clean, which):
    want, full_stream = clean[which]
    ex = executor.StreamingExecutor(_fw(dirs[which], hbm_pin_gb=1.0), device=CPU,
                                    tokenizer=_Vocab256())
    first = ex(list(PROMPTS))
    s1 = dict(ex.stats)
    warm = ex(list(PROMPTS))
    s2 = dict(ex.stats)
    for g, w in zip(first + warm, want + want):
        np.testing.assert_array_equal(g, w)
    # The first call's pin loads stream each layer once; then nothing.
    assert s1["streamed_bytes"] == full_stream
    assert s2["streamed_bytes"] == 0.0
    assert s2["stream_bytes_saved"] == full_stream
    assert s2["pin_hits"] == 7.0
    tier = residency.process_tier()
    assert s2["pinned_bytes"] == tier.stats()["pinned_bytes"] > 0
    assert s2["peak_mem_gb"] >= s2["pinned_bytes"] / 1e9  # floored at the pins
    if which == "int4":  # charged packed, pinned dequantized (float32 here)
        assert s2["pinned_bytes"] > 3 * full_stream


def test_partial_pin_streams_drop_by_exactly_pinned_bytes(dirs, clean):
    want, full_stream = clean["f32"]
    ex = executor.StreamingExecutor(_fw(dirs["f32"], hbm_pin_gb=_partial_budget_gb(dirs["f32"])),
                                    device=CPU, tokenizer=_Vocab256())
    ex(list(PROMPTS))
    warm = ex(list(PROMPTS))
    s2 = dict(ex.stats)
    for g, w in zip(warm, want):
        np.testing.assert_array_equal(g, w)
    assert residency.process_tier().plan.pinned == (0, 1, 5, 6)
    assert s2["streamed_bytes"] > 0
    assert s2["streamed_bytes"] + s2["stream_bytes_saved"] == full_stream
    assert s2["pin_hits"] == 4.0


def test_mid_shard_pin_splits_shard_token_identical(dirs):
    """Two layers a shard: pinning the norm (5) splits shard (4, 5) into a
    streamed layer and a pinned one; pinning layer 1 splits (1, 2)."""
    want, _ = _run(_fw(dirs["f32"], layer_num_per_shard=2))
    residency.reset_process_tier()
    got, ex = _run(_fw(dirs["f32"], layer_num_per_shard=2,
                       hbm_pin_gb=_partial_budget_gb(dirs["f32"])))
    assert list(ex.plan.shards) == [(0, 1), (2, 3), (4, 5), (6,)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("which", ["f32", "int4"])
def test_decode_parity_with_pins(dirs, which):
    kw = dict(num_gen_token=3, decode_resident="off", decode_fused="off")
    sc_off, up_off = decode.DecodeGenerator(_fw(dirs[which], **kw), device=CPU,
                                            tokenizer=_Vocab256())(list(PROMPTS))
    residency.reset_process_tier()
    gen = decode.DecodeGenerator(_fw(dirs[which], hbm_pin_gb=_partial_budget_gb(dirs[which]),
                                     **kw), device=CPU, tokenizer=_Vocab256())
    sc_on, up_on = gen(list(PROMPTS))
    for a, b in zip(sc_off, sc_on):
        np.testing.assert_array_equal(a, b)
    assert up_off == up_on
    # Prefill and both steps skipped the pinned layers.
    assert gen.stats["pin_hits"] == residency.process_tier().stats()["pin_hits"] >= 4 * 3
    # A resident decode takes no tier, as in the JAX package.
    residency.reset_process_tier()
    res = decode.DecodeGenerator(_fw(dirs[which], hbm_pin_gb=1.0, num_gen_token=3,
                                     decode_resident="on"), device=CPU, tokenizer=_Vocab256())
    assert res._residency is None
    sc_res, up_res = res(list(PROMPTS))
    assert up_res == up_off


def test_persistent_pin_corruption_demotes_never_pins(dirs, tmp_path):
    """Every read of a pinned layer's file is corrupt: it is demoted, never
    pinned, the rest pin, and the run raises the streamed path's typed
    error."""
    import shutil

    d = tmp_path / "m"
    shutil.copytree(dirs["f32"], d)
    path = d / "model.layers.1.safetensors"
    data = bytearray(path.read_bytes())
    data[-5] ^= 0x40
    path.write_bytes(bytes(data))
    ex = executor.StreamingExecutor(_fw(str(d), hbm_pin_gb=1.0, io_retry_attempts=2), device=CPU,
                                    tokenizer=_Vocab256())
    with pytest.raises(ShardCorruptError):
        ex(list(PROMPTS))
    st = residency.process_tier().stats()
    assert st["pin_failures"] == 1
    assert st["pinned_layers"] == 6
    assert not residency.process_tier().is_pinned(NAMES.index("model.layers.1"))


def test_verify_dry_run_matches_jax(dirs):
    for argv in (["--hbm_pin_gb", "0.0001"], ["--hbm_pin_gb", "1"],
                 ["--hbm_pin_gb", "0.0001", "--json"]):
        args = ["--model_path", dirs["mixed"], *argv]
        buf, jbuf = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["verify", *args])
        with contextlib.redirect_stdout(jbuf):
            jcli.verify_main(args)
        assert buf.getvalue() == jbuf.getvalue()
    rep = json.loads(buf.getvalue())["residency_plan"]
    assert rep["stream_bytes_saved_per_sweep"] == rep["pinned_bytes"] <= int(0.0001 * 1e9)
    assert residency.process_tier() is None  # nothing pinned by the audit
    with pytest.raises(SystemExit, match="requires --model_path"):
        cli.main(["verify", "--spill_dir", dirs["f32"], "--hbm_pin_gb", "1"])
    with pytest.raises(SystemExit, match="GB number or 'auto'"):
        cli.main(["verify", "--model_path", dirs["f32"], "--hbm_pin_gb", "lots"])


def test_cli_hbm_pin_gb_flag_and_stats(dirs, tmp_path):
    assert cli.build_parser().parse_args(["--prompt_pickle", "p", "--output_file", "o"]) \
        .hbm_pin_gb == 0.0
    assert cli.build_parser().parse_args(["--prompt_pickle", "p", "--output_file", "o",
                                          "--hbm_pin_gb", "auto"]).hbm_pin_gb is None
    ppkl = tmp_path / "p.pkl"
    ppkl.write_bytes(pickle.dumps(PROMPTS))
    common = ["--model_path", dirs["int4"], "--prompt_pickle", str(ppkl), "--dtype", "float32",
              "--bucket_multiple", "8", "--device", "cpu", "--num_gen_token", "2"]
    off = cli.main(common + ["--output_file", str(tmp_path / "a.pkl")], tokenizer=_Vocab256())
    assert "pinned_bytes" not in off
    on = cli.main(common + ["--output_file", str(tmp_path / "b.pkl"), "--hbm_pin_gb", "1"],
                  tokenizer=_Vocab256())
    a = pickle.loads((tmp_path / "a.pkl").read_bytes())
    b = pickle.loads((tmp_path / "b.pkl").read_bytes())
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    # Two passes: the first loads the pins, the second streams nothing.
    assert on["streamed_bytes"] == off["streamed_bytes"] / 2
    assert on["stream_bytes_saved"] == off["streamed_bytes"]  # every pass skipped them all
    assert on["pinned_bytes"] == on["residency"]["pinned_bytes"] > 0
    assert on["pin_hits"] == 14.0
