"""The port's multi-tenant LoRA serving against the JAX package's, on the CPU
in float32 (the cases of ``tests/test_adapters.py``, each held against the
JAX module on the same seeded inputs).

- ``adapters/apply.py``: the grouped shift bit-equal to the dense oracle on
  integer-valued inputs, and within 1e-5 of JAX's ``lora_shift`` with mixed
  ranks; zero-padding, grouping and scales equal to JAX's.
- ``adapters/registry.py``: adapter directories, plans and PEFT
  conversions byte-equal to JAX's (both directions load), typed misses and
  refusals.
- ``adapters/loader.py``: the LRU budget, the stat guard, typed persistent
  corruption and the pressure cap, counters equal to JAX's store.
- ``verify --adapter_dir``: JAX's report on the same broken registries.
- The serve engine with tenants: coalescing never crosses adapters; the
  base-only path is bit-equal to an engine without adapters; a mixed wave
  matches its batch-of-1 oracle and the JAX engine (scores within 1e-5,
  tokens equal) and streams the base weights as a base-only run does; an
  unknown adapter fails only its request; the pool never reuses another
  adapter's pages.
- Fault F3: both JSONL frontends without ``--adapter_dir`` fail the tenant
  request typed (``AdapterNotFound``) and serve the rest.
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import BenchTokenizer
from flexible_llm_sharding_tpu import cli as jcli
from flexible_llm_sharding_tpu.adapters import apply as japply
from flexible_llm_sharding_tpu.adapters import loader as jloader
from flexible_llm_sharding_tpu.adapters import registry as jregistry
from flexible_llm_sharding_tpu.config import AdapterConfig as JAdapterConfig
from flexible_llm_sharding_tpu.config import FrameworkConfig as JFrameworkConfig
from flexible_llm_sharding_tpu.config import LlamaConfig as JLlamaConfig
from flexible_llm_sharding_tpu.config import ServeConfig as JServeConfig
from flexible_llm_sharding_tpu.integrity import verify as jverify
from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu.runtime import kvpool as jkvpool
from flexible_llm_sharding_tpu.serve import ServeEngine as JServeEngine
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu_torch import cli
from flexible_llm_sharding_tpu_torch.adapters import apply, loader
from flexible_llm_sharding_tpu_torch.adapters.registry import (
    AdapterCorruptError,
    AdapterNotFound,
    AdapterPlan,
    AdapterRegistry,
    convert_peft_checkpoint,
    save_adapter,
)
from flexible_llm_sharding_tpu_torch.config import (
    AdapterConfig,
    FaultConfig,
    FrameworkConfig,
    ServeConfig,
)
from flexible_llm_sharding_tpu_torch.faults.inject import FaultInjector
from flexible_llm_sharding_tpu_torch.integrity.verify import verify_adapter_dir
from flexible_llm_sharding_tpu_torch.runtime import kvpool
from flexible_llm_sharding_tpu_torch.serve import Request, ServeEngine
from flexible_llm_sharding_tpu_torch.serve.sched.coalesce import build_entries
from flexible_llm_sharding_tpu_torch.utils.checkpoint import read_safetensors, write_safetensors

from tests.test_torch_serve import _jax_serve

ATOL = 1e-5
N_GEN = 3
HIDDEN = 64
N_LAYERS = 2


class _Vocab256(BenchTokenizer):
    VOCAB = 256


PROMPTS = [
    ("the cat sat on the mat and looked at the door", (" then left", " then slept")),
    ("two plus two equals", (" four", " five")),
    ("water boils at one hundred degrees", (" celsius", " kelvin")),
]


@pytest.fixture(autouse=True)
def _fresh_state():
    for reset in (loader.reset_process_store, jloader.reset_process_store,
                  kvpool.reset_process_pools, jkvpool.reset_process_pools):
        reset()
    yield
    for reset in (loader.reset_process_store, jloader.reset_process_store,
                  kvpool.reset_process_pools, jkvpool.reset_process_pools):
        reset()


def _int_factors(rng, n_layers, hidden, rank):
    """Integer-valued float32 factors: exact in float32 in any order."""
    return {f"model.layers.{i}": (rng.integers(-3, 4, (hidden, rank)).astype(np.float32),
                                  rng.integers(-3, 4, (rank, hidden)).astype(np.float32))
            for i in range(n_layers)}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


# ---------------------------------------------------------------------------
# The grouped shift (apply.py)
# ---------------------------------------------------------------------------

def test_grouped_apply_matches_dense_oracle_bitwise():
    rng = np.random.default_rng(3)
    B, S, D, R, G = 5, 2, 8, 3, 3
    h = rng.integers(-4, 5, (B, S, D)).astype(np.float32)
    a = rng.integers(-3, 4, (G, D, R)).astype(np.float32)
    b = rng.integers(-3, 4, (G, R, D)).astype(np.float32)
    a[0] = b[0] = 0.0
    g = np.asarray([0, 1, 2, 1, 0], np.int32)
    scale = np.asarray([0.0, 1.0, 2.0], np.float32)
    out = apply.lora_shift(_t(h), _t(a), _t(b), _t(g.astype(np.int64)), _t(scale)).numpy()
    for i in range(B):
        want = h[i] + (h[i] @ a[g[i]]) @ b[g[i]] * scale[g[i]]
        assert (out[i] == want).all(), f"row {i} diverged from the dense oracle"
    assert (out[g == 0] == h[g == 0]).all()
    jout = np.asarray(japply.lora_shift(jnp.asarray(h), a, b, g, scale))
    assert (out == jout).all()


@pytest.mark.parametrize("shape", [(4, 16, 64), (4, 2, 8, 64), (4, 2, 1, 64)],
                         ids=["prefix", "suffix", "decode"])
def test_lora_shift_mixed_ranks_matches_jax(shape):
    """Random float32 inputs at the shapes the decoder loops hand it, two
    adapters of ranks 2 and 5 zero-padded to 5, against JAX at 1e-5."""
    rng = np.random.default_rng(4)
    fac = {name: {"model.layers.0": {
        "lora_A": (0.1 * rng.standard_normal((64, r))).astype(np.float32),
        "lora_B": (0.1 * rng.standard_normal((r, 64))).astype(np.float32)}}
        for name, r in (("a", 2), ("b", 5))}
    names = [None, "a", "b"]
    a, b = apply.stack_layer(names, fac, "model.layers.0", 64, 5)
    ja, jb = japply.stack_layer(names, fac, "model.layers.0", 64, 5)
    assert (a.numpy() == ja).all() and (b.numpy() == jb).all()
    h = rng.standard_normal(shape).astype(np.float32)
    g = np.asarray([1, 0, 2, 1], np.int32)
    scale = np.asarray([0.0, 0.5, 2.0], np.float32)
    out = apply.lora_shift(_t(h), a, b, _t(g.astype(np.int64)), _t(scale)).numpy()
    jout = np.asarray(japply.lora_shift(jnp.asarray(h), ja, jb, g, scale))
    np.testing.assert_allclose(out, jout, atol=ATOL, rtol=0)
    assert (out[1] == h[1]).all()
    # The engine's form: row by row with each adapter's own unpadded pair.
    pairs = {gi: (_t(fac[n]["model.layers.0"]["lora_A"]), _t(fac[n]["model.layers.0"]["lora_B"]))
             for gi, n in ((1, "a"), (2, "b"))}
    rows = apply.lora_shift_rows(_t(h), pairs, g.tolist(), _t(scale)).numpy()
    np.testing.assert_allclose(rows, jout, atol=ATOL, rtol=0)
    assert (rows[1] == h[1]).all()
    th = _t(h)
    assert apply.lora_shift_rows(th, {}, g.tolist(), _t(scale)) is th  # no delta on this layer


def test_stack_layer_zero_pads_mixed_ranks_bit_identically():
    rng = np.random.default_rng(4)
    D = 8
    fa, fb = _int_factors(rng, 1, D, 2), _int_factors(rng, 1, D, 4)
    factors = {n: {"model.layers.0": {"lora_A": f["model.layers.0"][0],
                                      "lora_B": f["model.layers.0"][1]}}
               for n, f in (("a", fa), ("b", fb))}
    a, b = apply.stack_layer([None, "a", "b"], factors, "model.layers.0", D, 4)
    assert tuple(a.shape) == (3, D, 4) and tuple(b.shape) == (3, 4, D)
    assert (a[0] == 0).all() and (b[0] == 0).all()
    assert (a[1][:, 2:] == 0).all() and (b[1][2:, :] == 0).all()
    h = rng.integers(-4, 5, (3, D)).astype(np.float32)
    scale = torch.tensor([0.0, 1.0, 1.0])
    out = apply.lora_shift(_t(h), a, b, torch.tensor([0, 1, 2]), scale).numpy()
    pairs = {gi: tuple(_t(x) for x in f["model.layers.0"]) for gi, f in ((1, fa), (2, fb))}
    rows = apply.lora_shift_rows(_t(h), pairs, [0, 1, 2], scale).numpy()
    assert (out[0] == h[0]).all() and (rows == out).all()
    for i, f in ((1, fa), (2, fb)):
        la, lb = f["model.layers.0"]
        assert (out[i] == h[i] + (h[i] @ la) @ lb).all()
    th = _t(h)
    assert apply.lora_shift_rows(th, pairs, [0, 0, 0], scale) is th  # base rows only


def test_group_rows_base_first_and_scales():
    ids = ["a", None, "b", "a", None]
    names, g = apply.group_rows(ids)
    jnames, jg = japply.group_rows(ids)
    assert names == jnames == [None, "a", "b"]
    assert g.dtype == np.int32 and g.tolist() == jg.tolist() == [1, 0, 2, 1, 0]

    class _P:
        scale = 1.5

    s = apply.group_scales(names, {"a": _P(), "b": _P()})
    assert s.dtype == np.float32 and s.tolist() == [0.0, 1.5, 1.5]
    assert apply.delta_nbytes(None) == 0
    assert apply.delta_nbytes({"A": np.zeros((2, 2), np.float32)}) == 16
    assert apply.delta_nbytes({"A": torch.zeros(2, 2)}) == 16


# ---------------------------------------------------------------------------
# The registry: files byte-equal to JAX's, typed misses, PEFT conversion
# ---------------------------------------------------------------------------

def test_registry_roundtrip_byte_equal_to_jax_and_typed_miss(tmp_path):
    rng = np.random.default_rng(5)
    fac = _int_factors(rng, 2, 16, 3)
    adir = save_adapter(str(tmp_path / "port"), "tenant-a", fac)
    jdir = jregistry.save_adapter(str(tmp_path / "jax"), "tenant-a", fac)
    assert _files(adir) == _files(jdir)
    reg = AdapterRegistry(str(tmp_path / "port"))
    assert reg.names() == ("tenant-a",)
    plan = reg.plan("tenant-a")
    assert plan.rank == 3 and plan.hidden_size == 16 and plan.scale == 1.0
    assert plan.ranks == {"model.layers.0": 3, "model.layers.1": 3}
    assert plan.nbytes() == 2 * 2 * 16 * 3 * 4
    assert plan.to_json() == jregistry.AdapterRegistry(str(tmp_path / "jax")).plan(
        "tenant-a").to_json()
    with pytest.raises(AdapterNotFound):
        reg.path("tenant-z")
    # Each package's store loads the other's adapter, to the same factors.
    _, pf = loader.AdapterStore(str(tmp_path / "jax"), 1 << 20).get("tenant-a")
    _, jf = jloader.AdapterStore(str(tmp_path / "port"), 1 << 20).get("tenant-a")
    for lname, (a, b) in fac.items():
        assert (pf[lname]["lora_A"].numpy() == a).all() and (jf[lname]["lora_B"] == b).all()


def test_plan_dir_name_mismatch_is_corrupt(tmp_path):
    rng = np.random.default_rng(6)
    root = str(tmp_path / "adapters")
    save_adapter(root, "tenant-a", _int_factors(rng, 1, 16, 2))
    os.rename(os.path.join(root, "tenant-a"), os.path.join(root, "moved"))
    with pytest.raises(AdapterCorruptError, match="moved or hand-edited"):
        AdapterRegistry(root).plan("moved")
    with pytest.raises(jregistry.AdapterCorruptError, match="moved or hand-edited"):
        jregistry.AdapterRegistry(root).plan("moved")


def _peft_dir(path, rng, D=16, r=2, dtype=torch.float32, modules=("q_proj", "o_proj")):
    path.mkdir()
    (path / "adapter_config.json").write_text(
        json.dumps({"r": r, "lora_alpha": 4.0, "target_modules": list(modules)}))
    tensors, mods = {}, {}
    for module in modules:
        a = rng.standard_normal((r, D)).astype(np.float32)
        b = rng.standard_normal((D, r)).astype(np.float32)
        key = f"base_model.model.model.layers.0.self_attn.{module}"
        tensors[f"{key}.lora_A.weight"] = _t(a).to(dtype)
        tensors[f"{key}.lora_B.weight"] = _t(b).to(dtype)
        mods[module] = (a, b)
    write_safetensors(str(path / "adapter_model.safetensors"), tensors)
    return mods


def test_convert_peft_checkpoint_folds_alpha_byte_equal_to_jax(tmp_path, capsys):
    """Modules concatenate along the rank axis in sorted order, lora_alpha/r
    folds into B, the plan applies at scale 1.0; ``prepare-adapter`` writes
    the JAX CLI's plan and layer files byte for byte."""
    rng = np.random.default_rng(7)
    mods = _peft_dir(tmp_path / "peft", rng)
    adir = convert_peft_checkpoint(str(tmp_path / "peft"), str(tmp_path / "port"), "ft")
    plan = AdapterPlan.load(adir)
    assert plan.rank == 4 and plan.scale == 1.0
    assert plan.target_modules == ("self_attn.o_proj", "self_attn.q_proj")
    flat = read_safetensors(os.path.join(adir, "model.layers.0.safetensors"))
    (oa, ob), (qa, qb) = mods["o_proj"], mods["q_proj"]
    np.testing.assert_array_equal(flat["lora_A"].numpy(), np.concatenate([oa.T, qa.T], axis=1))
    np.testing.assert_array_equal(flat["lora_B"].numpy(),
                                  np.concatenate([ob.T * 2.0, qb.T * 2.0], axis=0))
    cli.main(["prepare-adapter", "--peft_dir", str(tmp_path / "peft"), "--adapter_dir",
              str(tmp_path / "port_cli"), "--name", "ft", "--json"])
    jcli.main(["prepare-adapter", "--peft_dir", str(tmp_path / "peft"), "--adapter_dir",
               str(tmp_path / "jax_cli"), "--name", "ft", "--json"])
    port_out, jax_out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(port_out) == json.loads(jax_out)
    assert _files(str(tmp_path / "port_cli" / "ft")) == _files(str(tmp_path / "jax_cli" / "ft"))
    assert _files(adir) == _files(str(tmp_path / "jax_cli" / "ft"))


def test_convert_peft_rejects_bin_and_nonsquare(tmp_path):
    src = tmp_path / "peft"
    src.mkdir()
    out = str(tmp_path / "out")
    with pytest.raises(ValueError, match="no adapter_config.json"):
        convert_peft_checkpoint(str(src), out, "x")
    (src / "adapter_config.json").write_text(json.dumps({"r": 2}))
    (src / "adapter_model.bin").write_bytes(b"\x80\x02")
    with pytest.raises(ValueError, match="safetensors only"):
        convert_peft_checkpoint(str(src), out, "x")
    with pytest.raises(SystemExit, match="prepare-adapter: .*safetensors only"):
        cli.main(["prepare-adapter", "--peft_dir", str(src), "--adapter_dir", out, "--name", "x"])
    os.remove(src / "adapter_model.bin")
    key = "base_model.model.model.layers.0.self_attn.q_proj"
    write_safetensors(str(src / "adapter_model.safetensors"),
                      {f"{key}.lora_A.weight": torch.zeros(2, 16),
                       f"{key}.lora_B.weight": torch.zeros(8, 2)})
    with pytest.raises(ValueError, match="non-square"):
        convert_peft_checkpoint(str(src), out, "x")


# ---------------------------------------------------------------------------
# The loader: LRU budget, stat guard, typed corruption, pressure cap
# ---------------------------------------------------------------------------

def _two_adapters(tmp_path, hidden=16, rank=2):
    rng = np.random.default_rng(8)
    root = str(tmp_path / "adapters")
    for name in ("a", "b"):
        save_adapter(root, name, _int_factors(rng, 2, hidden, rank))
    return root


def test_store_lru_budget_math_matches_jax(tmp_path):
    """A load that would overflow evicts the least recently used entry; an
    evicted adapter reloads the same bytes. The same script on JAX's store
    gives the same counters after every step."""
    root = _two_adapters(tmp_path)
    one_entry = loader.AdapterStore(root, 1 << 20)
    one_entry.get("a")
    one = one_entry.stats()["bytes"]
    assert one > 0
    stores = (loader.AdapterStore(root, one), jloader.AdapterStore(root, one))
    seen = []
    for store in stores:
        steps = []
        for name in ("a", "a", "b", "a"):
            store.get(name)
            steps.append(store.stats())
        seen.append(steps)
    assert seen[0] == seen[1]
    s = seen[0][-1]
    assert s["evictions"] == 2 and s["loads"] == 3 and s["hits"] == 1
    assert s["bytes"] == one <= stores[0].budget_bytes
    _, f0 = one_entry.get("a")
    _, f1 = stores[0].get("a")
    for lname, pair in f0.items():
        assert torch.equal(f1[lname]["lora_A"], pair["lora_A"])
    # A chaos injector is taken: every read of "b" comes back one bit off
    # until the budget is spent, and the re-reads heal it to the same bytes.
    stores[0].injector = FaultInjector(FaultConfig(enabled=True, error_rate=1.0, max_faults=2,
                                                   sites=("corrupt_shard",)))
    _, fb = stores[0].get("b")
    assert stores[0].stats()["reread_heals"] == 2
    _, fb_clean = one_entry.get("b")
    for lname, pair in fb_clean.items():
        assert torch.equal(fb[lname]["lora_B"], pair["lora_B"])


def test_store_stat_guard_invalidation(tmp_path):
    rng = np.random.default_rng(9)
    root = str(tmp_path / "adapters")
    save_adapter(root, "a", _int_factors(rng, 1, 16, 2))
    store = loader.AdapterStore(root, 1 << 20)
    store.get("a")
    new = _int_factors(rng, 1, 16, 2)
    save_adapter(root, "a", new)
    path = os.path.join(root, "a", "model.layers.0.safetensors")
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    _, factors = store.get("a")
    assert store.stats()["invalidations"] >= 1
    assert (factors["model.layers.0"]["lora_A"].numpy() == new["model.layers.0"][0]).all()


def test_store_corrupt_delta_typed_nonretried(tmp_path):
    root = _two_adapters(tmp_path)
    victim = os.path.join(root, "a", "model.layers.0.safetensors")
    blob = bytearray(open(victim, "rb").read())
    blob[-3] ^= 0xFF
    open(victim, "wb").write(bytes(blob))
    outs = []
    for mod, err in ((loader, AdapterCorruptError), (jloader, jregistry.AdapterCorruptError)):
        store = mod.AdapterStore(root, 1 << 20)
        for _ in range(2):
            with pytest.raises(err):
                store.get("a")
        store.get("b")
        outs.append(store.stats())
    assert outs[0] == outs[1]
    assert outs[0]["corrupt_evictions"] == 2 and outs[0]["entries"] == 1


def _fw_pair(model_dir, tmp_path, **kw):
    common = dict(model_path=model_dir, dtype="float32", bucket_multiple=8, block_size=2,
                  prefetch_depth=0, disk_folder=str(tmp_path / "d"))
    port_kw = {**common, **{k: v for k, v in kw.items() if k != "adapters"}}
    jax_kw = dict(port_kw)
    if "adapters" in kw:
        port_kw["adapters"] = AdapterConfig(**kw["adapters"])
        jax_kw["adapters"] = JAdapterConfig(**kw["adapters"])
    return FrameworkConfig(device="cpu", **port_kw), JFrameworkConfig(**jax_kw)


def test_adapter_evict_pressure_cap_reversible(tmp_path, model_dir):
    root = _two_adapters(tmp_path)
    cfg, jcfg = _fw_pair(model_dir, tmp_path, adapters=dict(dir=root, max_gb=0.001))
    trace = []
    for mod, c in ((loader, cfg), (jloader, jcfg)):
        store = mod.store_for(c)
        prev = store.budget_bytes
        store.get("a")
        steps = [store.stats()["entries"], mod.apply_pressure_cap(1e-9) == prev,
                 store.budget_bytes, store.stats()["entries"], mod.pressure_cap(),
                 mod.store_for(c) is store, store.budget_bytes]
        mod.lift_pressure_cap()
        store.get("a")
        steps += [mod.pressure_cap(), store.budget_bytes == prev, store.stats()["entries"]]
        trace.append(steps)
    assert trace[0] == trace[1] == [1, True, 1, 0, 1, True, 1, None, True, 1]
    assert loader.store_for(FrameworkConfig(device="cpu", adapters=AdapterConfig(
        dir=root, max_gb=0))) is None


def test_verify_adapter_dir_statuses_match_jax(tmp_path, capsys):
    rng = np.random.default_rng(10)

    def fresh(tag):
        root = str(tmp_path / tag)
        save_adapter(root, "a", _int_factors(rng, 2, 16, 2))
        return root

    roots = {"clean": fresh("clean")}
    roots["corrupt"] = fresh("corrupt")
    path = os.path.join(roots["corrupt"], "a", "model.layers.1.safetensors")
    blob = bytearray(open(path, "rb").read())
    blob[-2] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    roots["gone"] = fresh("gone")
    os.remove(os.path.join(roots["gone"], "a", "model.layers.0.safetensors"))
    roots["badplan"] = fresh("badplan")
    open(os.path.join(roots["badplan"], "a", "adapter_plan.json"), "w").write("{not json")
    reports = {k: verify_adapter_dir(r) for k, r in roots.items()}
    for k, r in roots.items():
        assert reports[k] == jverify.verify_adapter_dir(r), k
    assert reports["clean"]["ok"] and reports["clean"]["layers_checked"] == 2
    assert any(p["status"] == "adapter_mismatch" for p in reports["corrupt"]["problems"])
    assert "plan_missing_file" in {p["status"] for p in reports["gone"]["problems"]}
    assert any(p["status"] == "corrupt_plan" for p in reports["badplan"]["problems"])
    cli.main(["verify", "--adapter_dir", roots["clean"]])
    with pytest.raises(SystemExit) as e:
        cli.main(["verify", "--adapter_dir", roots["corrupt"]])
    assert e.value.code == 2 and "ADAPTER_MISMATCH" in capsys.readouterr().out


def test_coalesce_never_merges_across_adapters():
    rs = [Request(prefix="shared", suffixes=("s",), max_new_tokens=1, adapter_id=a)
          for a in ("a", "a", "b", None)]
    entries = build_entries(rs, key_fn=lambda p: p)
    assert [len(e.requests) for e in entries] == [2, 1, 1]
    assert entries[0].requests == [rs[0], rs[1]]


def test_batch_parser_accepts_the_adapter_flags():
    args = cli.build_parser().parse_args(["--prompt_pickle", "p", "--output_file", "o",
                                          "--adapter_dir", "/r", "--adapter_max_gb", "0.5"])
    cfg = cli.config_from_args(args)
    assert cfg.adapters == AdapterConfig(dir="/r", max_gb=0.5)
    jargs = jcli.build_parser().parse_args(["--prompt_pickle", "p", "--output_file", "o",
                                            "--adapter_dir", "/r", "--adapter_max_gb", "0.5"])
    assert (jargs.adapter_dir, jargs.adapter_max_gb) == (args.adapter_dir, args.adapter_max_gb)


# ---------------------------------------------------------------------------
# The serve engine with tenants
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("adapter_model")
    cfg = JLlamaConfig.from_hf_config(dict(
        model_type="llama", vocab_size=256, hidden_size=HIDDEN, intermediate_size=128,
        max_position_embeddings=512, num_hidden_layers=N_LAYERS, num_attention_heads=4,
        num_key_value_heads=2))
    params = jllama.init_params(jax.random.PRNGKey(5), cfg)
    jckpt.save_params(jax.tree.map(np.asarray, params), str(d), cfg)
    return str(d)


@pytest.fixture(scope="module")
def adapter_root(tmp_path_factory):
    """Two tenants of ranks 2 and 3 on every layer (the wave pads to 3)."""
    rng = np.random.default_rng(11)
    root = str(tmp_path_factory.mktemp("adapter_root"))
    for name, rank in (("tenant-a", 2), ("tenant-b", 3)):
        save_adapter(root, name, {
            f"model.layers.{i}": ((0.05 * rng.standard_normal((HIDDEN, rank))).astype(np.float32),
                                  (0.05 * rng.standard_normal((rank, HIDDEN))).astype(np.float32))
            for i in range(N_LAYERS)})
    return root


def _serve(engine, submissions, sequential=False):
    """Results of ``submissions`` ((prefix, suffixes, adapter_id)) on an
    engine built with ``start=False``: futures in order (errors as the
    exception). ``sequential`` waits for each before the next submit (a
    wave of one each); otherwise all are queued before the engine starts
    (one wave). Returns (results, stats)."""
    if sequential:
        engine.start()
    try:
        if sequential:
            reqs = []
            for p, s, aid in submissions:
                reqs.append(engine.submit(p, s, adapter_id=aid))
                reqs[-1].future.exception(timeout=120)
        else:
            reqs = [engine.submit(p, s, adapter_id=aid) for p, s, aid in submissions]
            engine.start()
        out = []
        for r in reqs:
            err = r.future.exception(timeout=120)
            out.append(err if err is not None else r.future.result())
        stats = engine.stats()
    finally:
        engine.shutdown(drain=True)
    assert engine.error is None
    return out, stats


def _port_engine(cfg):
    return ServeEngine(cfg, ServeConfig(max_wave_requests=4, default_max_new_tokens=N_GEN),
                       tokenizer=_Vocab256(), device=torch.device("cpu"), start=False)


def _jax_engine(jcfg):
    return JServeEngine(jcfg, JServeConfig(max_wave_requests=4, default_max_new_tokens=N_GEN),
                        tokenizer=_Vocab256(), start=False)


MIXED = [(PROMPTS[0][0], PROMPTS[0][1], "tenant-a"), (PROMPTS[1][0], PROMPTS[1][1], "tenant-b"),
         (PROMPTS[2][0], PROMPTS[2][1], None), (PROMPTS[1][0], PROMPTS[1][1], "tenant-a")]


def test_serve_zero_adapter_path_bit_identical(model_dir, adapter_root, tmp_path):
    """``--adapter_dir`` set but every request on the base model: the scores
    of an engine without adapters bit for bit, and no delta byte moved."""
    subs = [(p, s, None) for p, s in PROMPTS]
    cfg_off, _ = _fw_pair(model_dir, tmp_path)
    base, _ = _serve(_port_engine(cfg_off), subs)
    cfg_on, _ = _fw_pair(model_dir, tmp_path, adapters=dict(dir=adapter_root, max_gb=1.0))
    on, stats = _serve(_port_engine(cfg_on), subs)
    for b, o in zip(base, on):
        assert b.updated == o.updated and np.array_equal(b.scores, o.scores)
    assert stats["adapter"]["delta_bytes"] == 0 and stats["adapter"]["applied_rows"] == 0


def test_serve_multi_tenant_matches_oracle_and_jax(model_dir, adapter_root, tmp_path):
    """Two tenants and the base in one wave: each request's tokens and
    argmax equal its batch-of-1 run's, scores within 1e-5 of the JAX
    engine's; the deltas engage (a tenant's scores differ from the base's
    on the same prompt); the base weights stream as in a base-only run, per
    sweep; the delta bytes stay under 5% of them."""
    cfg, jcfg = _fw_pair(model_dir, tmp_path, adapters=dict(dir=adapter_root, max_gb=1.0))
    oracle, _ = _serve(_port_engine(cfg), MIXED, sequential=True)
    loader.reset_process_store()
    batched, stats = _serve(_port_engine(cfg), MIXED)
    jres, _ = _serve(_jax_engine(jcfg), MIXED)
    for o, b, j in zip(oracle, batched, jres):
        assert o.updated == b.updated == j.updated
        assert (o.scores.argmax(-1) == b.scores.argmax(-1)).all()
        np.testing.assert_allclose(b.scores, o.scores, atol=ATOL, rtol=0)
        np.testing.assert_allclose(b.scores, j.scores, atol=ATOL, rtol=0)
    assert stats["prefills"] == 1
    a = stats["adapter"]
    # 3 of the 4 rows took a delta in each of the 3 sweeps.
    assert a["applied_rows"] == 3 * N_GEN and a["delta_bytes"] > 0
    assert not np.allclose(batched[1].scores, batched[3].scores)  # same prompt, b vs a
    cfg_off, _ = _fw_pair(model_dir, tmp_path)
    base, b_stats = _serve(_port_engine(cfg_off), [(p, s, None) for p, s, _ in MIXED])
    assert not np.allclose(base[0].scores, batched[0].scores)
    np.testing.assert_allclose(base[2].scores, batched[2].scores, atol=ATOL, rtol=0)
    per_sweep = stats["stream"]["streamed_bytes"] / stats["sweeps"]
    assert per_sweep == b_stats["stream"]["streamed_bytes"] / b_stats["sweeps"]
    assert a["delta_bytes"] < 0.05 * stats["stream"]["streamed_bytes"]


def test_serve_hot_evict_reload_and_reject(model_dir, adapter_root, tmp_path):
    """Dropping the process store between two runs (a restart) gives the
    same scores bit for bit from factors read again; an unknown adapter in
    a wave fails only its request, typed, as in the JAX engine."""
    cfg, jcfg = _fw_pair(model_dir, tmp_path, adapters=dict(dir=adapter_root, max_gb=1.0))
    subs = MIXED[:2]
    first, _ = _serve(_port_engine(cfg), subs, sequential=True)
    loader.reset_process_store()
    second, _ = _serve(_port_engine(cfg), subs, sequential=True)
    assert loader.process_store().stats()["loads"] == 2
    for a, b in zip(first, second):
        assert a.updated == b.updated and np.array_equal(a.scores, b.scores)
    bad = [MIXED[0], (PROMPTS[2][0], PROMPTS[2][1], "tenant-z"), MIXED[2]]
    res, stats = _serve(_port_engine(cfg), bad)
    assert isinstance(res[1], AdapterNotFound) and "tenant-z" in str(res[1])
    assert stats["adapter_rejects"] == 1 and stats["completed"] == 2
    np.testing.assert_array_equal(res[0].scores, first[0].scores)
    jres, j_stats = _serve(_jax_engine(jcfg), bad)
    assert type(jres[1]).__name__ == "AdapterNotFound" and j_stats["adapter_rejects"] == 1
    np.testing.assert_allclose(res[2].scores, jres[2].scores, atol=ATOL, rtol=0)


def test_serve_pool_is_salted_by_adapter(model_dir, adapter_root, tmp_path):
    """One prompt under tenant-a twice, then under tenant-b, a wave each:
    tenant-a's second run reuses its sealed prefix (scores bit for bit);
    tenant-b gets no reuse hit from tenant-a's pages."""
    cfg, _ = _fw_pair(model_dir, tmp_path, adapters=dict(dir=adapter_root, max_gb=1.0))
    p, s = PROMPTS[0]
    res, stats = _serve(_port_engine(cfg), [(p, s, "tenant-a"), (p, s, "tenant-a"),
                                            (p, s, "tenant-b")], sequential=True)
    assert np.array_equal(res[0].scores, res[1].scores)
    assert stats["kvpool"]["prefix_reuse_hits"] == 1
    assert stats["prefix_reuse_tokens"] == stats["prefix_prefill_tokens"] // 2
    assert not np.allclose(res[2].scores, res[0].scores)


def _jsonl(run, lines, monkeypatch, capsys):
    monkeypatch.setattr("sys.stdin", io.StringIO("".join(json.dumps(d) + "\n" for d in lines)))
    capsys.readouterr()
    run()
    return {d["client_id"]: d for d in map(json.loads, capsys.readouterr().out.splitlines())}


def test_f3_adapter_request_without_adapter_dir_fails_typed(model_dir, tmp_path, monkeypatch,
                                                           capsys):
    """Fault F3: without ``--adapter_dir`` a request naming an adapter was
    served on the base model. Both engines and both JSONL frontends must
    fail it with ``AdapterNotFound`` and serve the base request of the same
    wave (scores within 1e-5 of JAX's, tokens equal)."""
    cfg, jcfg = _fw_pair(model_dir, tmp_path)
    subs = [(*PROMPTS[0], None), (*PROMPTS[1], "tenant-a")]
    res, stats = _serve(_port_engine(cfg), subs)
    jres, _ = _serve(_jax_engine(jcfg), subs)
    assert isinstance(res[1], AdapterNotFound) and type(jres[1]).__name__ == "AdapterNotFound"
    assert stats["adapter_rejects"] == 1 and stats["completed"] == 1
    assert res[0].updated == jres[0].updated
    np.testing.assert_allclose(res[0].scores, jres[0].scores, atol=ATOL, rtol=0)
    lines = [{"id": "base", "prefix": PROMPTS[0][0], "suffixes": list(PROMPTS[0][1])},
             {"id": "tenant", "prefix": PROMPTS[1][0], "suffixes": list(PROMPTS[1][1]),
              "adapter_id": "tenant-a"}]
    argv = ["--model_path", model_dir, "--dtype", "float32", "--bucket_multiple", "8",
            "--block_size", "2", "--prefetch_depth", "0", "--stats_interval_s", "0",
            "--max_new_tokens", str(N_GEN)]
    port = _jsonl(lambda: cli.main(["serve", "--device", "cpu", *argv], tokenizer=_Vocab256()),
                  lines, monkeypatch, capsys)
    jax_ = _jsonl(lambda: _jax_serve(argv), lines, monkeypatch, capsys)
    for out in (port, jax_):
        assert out["tenant"]["status"] == "failed"
        assert "serving is off" in out["tenant"]["error"] and "tenant-a" in out["tenant"]["error"]
        assert out["base"]["status"] == "done"
    assert port["base"]["tokens"] == jax_["base"]["tokens"]
    assert port["base"]["updated_suffixes"] == jax_["base"]["updated_suffixes"]
