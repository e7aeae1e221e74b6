"""The port's integrity layer against the JAX package's: the manifest each
splitter and each ``save_params`` writes (byte-equal, and each package
verifies the other's directory), corruption and dtype-kind drift on load,
the crc verdict cache's counters, the retry policy, and the ``verify``
subcommand's reports and exit codes."""

import os
import warnings

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from flexible_llm_sharding_tpu.cli import main as jax_main
from flexible_llm_sharding_tpu.config import LlamaConfig as JLlamaConfig
from flexible_llm_sharding_tpu.faults import retry as jretry
from flexible_llm_sharding_tpu.integrity import manifest as jman
from flexible_llm_sharding_tpu.integrity import verify as jverify
from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu.runtime.executor import _HostShardLoader
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu.utils.metrics import IntegrityRecorder as JIntegrityRecorder
from flexible_llm_sharding_tpu.utils.metrics import RetryRecorder as JRetryRecorder
from flexible_llm_sharding_tpu_torch.cli import main as torch_main
from flexible_llm_sharding_tpu_torch.config import LlamaConfig
from flexible_llm_sharding_tpu_torch.faults import retry
from flexible_llm_sharding_tpu_torch.integrity import manifest
from flexible_llm_sharding_tpu_torch.integrity import verify
from flexible_llm_sharding_tpu_torch.runtime.executor import ShardWeightSource
from flexible_llm_sharding_tpu_torch.runtime.hostcache import reset_process_cache
from flexible_llm_sharding_tpu_torch.utils import checkpoint
from flexible_llm_sharding_tpu_torch.utils.metrics import RetryRecorder
from test_torch_checkpoint import hf_checkpoint

KW = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2)
NO_WAIT = retry.RetryPolicy(base_delay_s=0.0)
J_NO_WAIT = jretry.RetryPolicy(base_delay_s=0.0)


@pytest.fixture(autouse=True)
def _fresh_process_state():
    """The verdict caches and host caches are process-wide."""
    manifest.reset_verdicts()
    jman.reset_verdicts()
    reset_process_cache()
    yield
    reset_process_cache()


def _jax_model(path, dtype=np.float32, tied=False, seed=0):
    """A JAX ``save_params`` checkpoint: (config, numpy params)."""
    jcfg = JLlamaConfig(**KW, tie_word_embeddings=tied)
    params = jax.tree.map(lambda a: np.asarray(a).astype(dtype),
                          jllama.init_params(jax.random.PRNGKey(seed), jcfg))
    jckpt.save_params(params, str(path), jcfg)
    return jcfg, params


def _flip_byte(path, offset_from_end=5):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) - offset_from_end)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0x40]))


def _layer_names(cfg):
    return checkpoint.layer_names_for(cfg.num_hidden_layers)


# -- the manifest, written by either package ---------------------------------

@pytest.mark.parametrize("layout", ["native", "hf"])
@pytest.mark.parametrize("family", ["llama", "gemma3", "mixtral"])
def test_split_manifest_is_jax_manifest_and_verifies_both_ways(tmp_path, family, layout):
    hf_checkpoint(family, tmp_path / "hf", seed=2)
    jckpt.split_into_layers(str(tmp_path / "hf"), str(tmp_path / "jax"), layout=layout)
    checkpoint.split_into_layers(str(tmp_path / "hf"), str(tmp_path / "port"), layout=layout)
    got = (tmp_path / "port" / manifest.MANIFEST_NAME).read_bytes()
    assert got == (tmp_path / "jax" / jman.MANIFEST_NAME).read_bytes()
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert jverify.verify_model_dir(port_dir)["ok"] and verify.verify_model_dir(jax_dir)["ok"]
    cfg = LlamaConfig.from_pretrained(port_dir)
    for name in checkpoint.layer_names_for(cfg.num_hidden_layers, cfg.tie_word_embeddings):
        jckpt.load_layer(port_dir, name, manifest=jman.load_manifest(port_dir))
        checkpoint.load_layer(jax_dir, name, manifest=manifest.load_manifest(jax_dir))
    assert jman.verdict_stats() == manifest.verdict_stats()


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_save_params_manifest_is_jax_manifest(tmp_path, dtype, tied):
    jcfg, params = _jax_model(tmp_path / "jax", dtype, tied)
    cfg = LlamaConfig.from_pretrained(str(tmp_path / "jax"))
    checkpoint.save_params(checkpoint.params_from_jax(params, cfg), str(tmp_path / "port"), cfg)
    assert ((tmp_path / "port" / manifest.MANIFEST_NAME).read_bytes()
            == (tmp_path / "jax" / jman.MANIFEST_NAME).read_bytes())
    kinds = {e["dtype"] for e in manifest.load_manifest(str(tmp_path / "port"))["layers"].values()}
    assert kinds == {np.dtype(dtype).name}


@pytest.mark.parametrize("make", [
    lambda: {"a": torch.zeros(0), "b": torch.ones(3, dtype=torch.int32)},
    lambda: {"w": torch.randn(4, 4).to(torch.float16), "v": torch.randn(16)},
    lambda: {"s::scale": torch.ones(2), "w": torch.ones(2, 2, dtype=torch.int8)},
], ids=["empty-and-int", "tie-by-bytes", "int8"])
def test_layer_entry_matches_jax(make):
    flat = make()
    want = jman.layer_entry({k: v.numpy() for k, v in flat.items()}, "f.safetensors")
    assert manifest.layer_entry(flat, "f.safetensors") == want


# -- loads: corruption, dtype kind, no manifest ------------------------------

def _port_source(model_dir, cfg, **kw):
    return ShardWeightSource(str(model_dir), _layer_names(cfg), [], torch.float32,
                             torch.device("cpu"), prefetch_depth=0, retry_policy=NO_WAIT, **kw)


def _jax_loader(model_dir, recorder, **kw):
    jcfg = JLlamaConfig.from_pretrained(str(model_dir))
    return _HostShardLoader(str(model_dir), jckpt.layer_names_for(jcfg.num_hidden_layers),
                            np.float32, retry_policy=J_NO_WAIT, integrity=recorder, **kw)


@pytest.mark.parametrize("layer", ["model.layers.1", "model.embed_tokens"])
def test_flipped_byte_raises_shard_corrupt_and_quarantines_in_both(tmp_path, layer):
    _jax_model(tmp_path)
    cfg = LlamaConfig.from_pretrained(str(tmp_path))
    _flip_byte(tmp_path / f"{layer}.safetensors")
    jrec = JIntegrityRecorder()
    jloader = _jax_loader(tmp_path, jrec, retry_recorder=JRetryRecorder())
    with pytest.raises(jman.ShardCorruptError):
        jloader._load_one(layer)
    source = _port_source(tmp_path, cfg)
    with pytest.raises(manifest.ShardCorruptError, match="quarantined"):
        source._load_one(layer)
    path = str(tmp_path / f"{layer}.safetensors")
    assert source.quarantined == jloader.quarantined == {path}
    assert source.integrity.snapshot() == jrec.snapshot()
    assert source.integrity.snapshot()["integrity_failures"] == NO_WAIT.max_attempts
    with pytest.raises(manifest.ShardCorruptError, match="quarantined after"):
        source._load_one(layer)  # fails fast now
    source.close()


def test_flipped_dtype_kind_raises_precision_mismatch(tmp_path):
    _jax_model(tmp_path)
    cfg = LlamaConfig.from_pretrained(str(tmp_path))
    data = jman.load_manifest(str(tmp_path))
    data["layers"]["model.layers.0"]["dtype"] = "bfloat16"
    jman.write_manifest(str(tmp_path), data["layers"])
    with pytest.raises(jman.PrecisionMismatch):
        jckpt.load_layer(str(tmp_path), "model.layers.0", manifest=jman.load_manifest(str(tmp_path)))
    with pytest.raises(manifest.PrecisionMismatch, match="dtype kind 'float32'"):
        checkpoint.load_layer(str(tmp_path), "model.layers.0",
                              manifest=manifest.load_manifest(str(tmp_path)))
    source = _port_source(tmp_path, cfg)
    with pytest.raises(manifest.PrecisionMismatch):  # structural: never retried
        source._load_one("model.layers.0")
    assert source.retries.total("retries") == 0


def test_no_manifest_loads_unverified_with_one_warning(tmp_path):
    _jax_model(tmp_path)
    cfg = LlamaConfig.from_pretrained(str(tmp_path))
    want = checkpoint.load_layer(str(tmp_path), "model.layers.0")
    os.remove(tmp_path / manifest.MANIFEST_NAME)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        source = _port_source(tmp_path, cfg)
        got = source._load_one("model.layers.0")
        source._load_one("model.layers.1")
    assert [str(w.message).count("no integrity.json") for w in caught] == [1]
    for k, v in checkpoint.flatten(want):
        assert torch.equal(dict(checkpoint.flatten(got))[k], v)
    assert manifest.verdict_stats() == {"verdict_hits": 0, "full_verifies": 0}
    source.close()


def test_cli_raises_shard_corrupt_on_a_flipped_byte(tmp_path):
    import pickle

    from bench import BenchTokenizer

    class Vocab512(BenchTokenizer):
        VOCAB = 512

    _jax_model(tmp_path / "m")
    _flip_byte(tmp_path / "m" / "model.layers.0.safetensors")
    ppkl = tmp_path / "p.pkl"
    ppkl.write_bytes(pickle.dumps([("a b c", (" d",))]))
    args = ["--model_path", str(tmp_path / "m"), "--prompt_pickle", str(ppkl), "--output_file",
            str(tmp_path / "s.pkl"), "--dtype", "float32", "--io_retry_base_s", "0"]
    with pytest.raises(jman.ShardCorruptError):
        jax_main([*args, "--num_devices", "1"], tokenizer=Vocab512())
    with pytest.raises(manifest.ShardCorruptError):
        torch_main([*args, "--device", "cpu"], tokenizer=Vocab512())


# -- the crc verdict cache ---------------------------------------------------

def _bump_mtime(path, ns=10**9):
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + ns))


@pytest.mark.parametrize("bump", [None, "model.layers.0.safetensors", "lm_head.safetensors",
                                  manifest.MANIFEST_NAME])
def test_verdict_counters_match_jax(tmp_path, bump):
    jcfg, _ = _jax_model(tmp_path)
    names = jckpt.layer_names_for(jcfg.num_hidden_layers)

    def sweep(load, man):
        for name in names:
            load(str(tmp_path), name, manifest=man)

    counts = []
    for load, man_mod in ((jckpt.load_layer, jman), (checkpoint.load_layer, manifest)):
        man_mod.reset_verdicts()
        sweep(load, man_mod.load_manifest(str(tmp_path)))
        sweep(load, man_mod.load_manifest(str(tmp_path)))
        if bump:
            _bump_mtime(tmp_path / bump)
        sweep(load, man_mod.load_manifest(str(tmp_path)))
        counts.append(man_mod.verdict_stats())
    assert counts[0] == counts[1]
    reverified = {None: 0, manifest.MANIFEST_NAME: len(names)}.get(bump, 1)
    assert counts[1] == {"full_verifies": len(names) + reverified,
                         "verdict_hits": 2 * len(names) - reverified}


# -- retries -----------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"base_delay_s": 0.2, "multiplier": 3.0, "max_delay_s": 1.0},
                                {"jitter": 0.0}, {"jitter": 1.5, "base_delay_s": 0.01}])
def test_delay_for_matches_jax(kw):
    mine, ref = retry.RetryPolicy(**kw), jretry.RetryPolicy(**kw)
    for label in ("", "shard_read", "spill_write", "x" * 40):
        for attempt in range(1, 9):
            assert mine.delay_for(attempt, label) == ref.delay_for(attempt, label)
    assert retry.hash_unit("k") == jretry.hash_unit("k")


@pytest.mark.parametrize("fails", [0, 1, 3, 4, 6])
@pytest.mark.parametrize("wrap", [True, False])
def test_retry_call_matches_jax(fails, wrap):
    outcomes = []
    for mod, rec in ((jretry, JRetryRecorder()), (retry, RetryRecorder())):
        calls = []

        def reader():
            calls.append(1)
            if len(calls) <= fails:
                raise OSError(f"blip {len(calls)}")
            return "bytes"

        policy = mod.RetryPolicy(base_delay_s=0.0)
        try:
            result = mod.retry_call(reader, policy=policy, label="shard_read", recorder=rec,
                                    wrap=mod.ShardLoadError if wrap else None)
        except Exception as e:  # noqa: BLE001 - the outcome is compared
            result = (type(e).__name__, str(e), type(e.__cause__).__name__)
        outcomes.append((len(calls), result, rec.snapshot()))
    assert outcomes[0] == outcomes[1]


def test_retry_call_stops_on_abort_and_deadline():
    for kw in ({"abort": lambda: True}, {}):
        for mod in (jretry, retry):
            calls = []

            def reader():
                calls.append(1)
                raise TimeoutError("slow")

            policy = mod.RetryPolicy(base_delay_s=0.0, deadline_s=None if kw else 1e-9)
            with pytest.raises(mod.ShardLoadError, match="aborted" if kw else "deadline"):
                mod.retry_call(reader, policy=policy, wrap=mod.ShardLoadError, **kw)
            assert len(calls) == 1


def test_non_retryable_errors_fail_at_once():
    calls = []

    def reader():
        calls.append(1)
        raise KeyError("structural")

    with pytest.raises(KeyError):
        retry.retry_call(reader, policy=NO_WAIT, wrap=retry.ShardLoadError)
    assert len(calls) == 1


# -- the verify subcommand ---------------------------------------------------

def _damage(model_dir, kind):
    d = str(model_dir)
    if kind == "flip":
        _flip_byte(os.path.join(d, "model.layers.1.safetensors"))
    elif kind == "missing_file":
        os.remove(os.path.join(d, "model.norm.safetensors"))
    elif kind == "extra_file":
        checkpoint.write_safetensors(os.path.join(d, "model.layers.9.safetensors"),
                                     {"w": torch.ones(2)})
    elif kind == "no_manifest":
        os.remove(os.path.join(d, manifest.MANIFEST_NAME))
    elif kind == "corrupt_manifest":
        with open(os.path.join(d, manifest.MANIFEST_NAME), "a") as f:
            f.write("}")
    elif kind == "truncated":
        p = os.path.join(d, "lm_head.safetensors")
        os.truncate(p, os.path.getsize(p) - 64)
    elif kind == "tensor_diff":
        p = os.path.join(d, "model.norm.safetensors")
        checkpoint.write_safetensors(p, {"scale": torch.ones(KW["hidden_size"]),
                                         "extra": torch.ones(1)})


@pytest.mark.parametrize("kind", [None, "flip", "missing_file", "extra_file", "no_manifest",
                                  "corrupt_manifest", "truncated", "tensor_diff"])
def test_verify_reports_match_jax(tmp_path, capsys, kind):
    _jax_model(tmp_path / "m")
    _damage(tmp_path / "m", kind)
    want = jverify.verify_model_dir(str(tmp_path / "m"))
    got = verify.verify_model_dir(str(tmp_path / "m"))
    assert [(p["file"], p["status"]) for p in got["problems"]] == \
        [(p["file"], p["status"]) for p in want["problems"]]
    assert {k: v for k, v in got.items() if k != "problems"} == \
        {k: v for k, v in want.items() if k != "problems"}
    codes = []
    for main in (jax_main, torch_main):
        try:
            main(["verify", "--model_path", str(tmp_path / "m")])
            codes.append(0)
        except SystemExit as e:
            codes.append(e.code)
    out = capsys.readouterr().out.splitlines()
    half = len(out) // 2
    assert codes[0] == codes[1] == (0 if kind is None else 2)
    assert [ln.split()[0] for ln in out[:half]] == [ln.split()[0] for ln in out[half:]]


@pytest.mark.parametrize("kind", [None, "flip", "orphan", "legacy"])
def test_verify_spill_dir_matches_jax(tmp_path, kind):
    from flexible_llm_sharding_tpu_torch.runtime.activations import ActivationStore

    store = ActivationStore("disk", torch.device("cpu"), torch.bfloat16, str(tmp_path))
    store.store(0, [0, 1], torch.randn(2, 3, 8).bfloat16(), torch.randn(2, 2, 4, 8).bfloat16())
    store.flush()
    spill = tmp_path / "suffix-00001.npy"
    if kind == "flip":
        _flip_byte(spill, 3)
    elif kind == "orphan":
        os.remove(spill)
    elif kind == "legacy":
        os.remove(str(spill) + manifest.SIDECAR_SUFFIX)
    want = jverify.verify_spill_dir(str(tmp_path))
    got = verify.verify_spill_dir(str(tmp_path))
    assert [(p["file"], p["status"]) for p in got["problems"]] == \
        [(p["file"], p["status"]) for p in want["problems"]]
    assert {k: v for k, v in got.items() if k != "problems"} == \
        {k: v for k, v in want.items() if k != "problems"}
    assert verify.format_report(got).splitlines()[-1] == jverify.format_report(want).splitlines()[-1]


@pytest.mark.parametrize("n", [0, 5, manifest._CRC_PARALLEL_MIN - 1, manifest._CRC_PARALLEL_MIN,
                               3 * manifest._CRC_PIECE + 12345])
def test_parallel_crc_is_zlib_crc(n):
    """Past the threshold the crc is taken in pieces on threads and combined:
    the same value as one zlib pass and as the JAX package's checksum."""
    import zlib

    a = np.random.default_rng(n).integers(0, 256, size=n, dtype=np.uint8)
    want = f"{zlib.crc32(a) & 0xFFFFFFFF:08x}"
    assert manifest.checksum_chunked(a) == want == jman.tensor_checksum(a)
    assert manifest.tensor_checksum(torch.from_numpy(a)) == want
    if n > 10:
        assert manifest.crc32_combine(zlib.crc32(a[:7]), zlib.crc32(a[7:]), n - 7) == int(want, 16)
