"""The port's fault injector (``faults/inject.py``) against the JAX
package's, on the CPU.

- The schedule: for every site, seeds 0-3 and the first 200 fires per site,
  the same outcome (clean, error, truncated read or latency, with the same
  error type and message) and the same event list, with and without a
  fault budget; a fire with sites restricted draws nothing elsewhere.
- ``corrupt_flat`` and ``corrupt_array`` on tensors give the bytes JAX's
  give on the same arrays.
- ``FaultConfig`` validates as JAX's does.
- Every site is armed: each is fired somewhere in the port's package, and an
  engine, a fleet and both CLI parsers take a config naming any site (or
  every site, the default), handing the injector to what fires it.
"""

import errno
import os
import re

import jax
import numpy as np
import pytest
import torch

from flexible_llm_sharding_tpu.config import FAULT_SITES as JFAULT_SITES
from flexible_llm_sharding_tpu.config import FaultConfig as JFaultConfig
from flexible_llm_sharding_tpu.config import LlamaConfig as JLlamaConfig
from flexible_llm_sharding_tpu.faults import inject as jinject
from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu_torch import cli
from flexible_llm_sharding_tpu_torch.config import (
    FAULT_SITES,
    FaultConfig,
    FrameworkConfig,
    ServeConfig,
)
from flexible_llm_sharding_tpu_torch.faults import inject
from flexible_llm_sharding_tpu_torch.serve import ReplicaFleet, ServeEngine

from tests.fake_tokenizer import FakeTokenizer

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "flexible_llm_sharding_tpu_torch")
# The sites the replica fleet fires itself; every other fires in an engine,
# a source, a store or a queue.
FLEET_SITES = ("replica_kill", "replica_stall")
RATES = dict(error_rate=0.2, truncate_rate=0.1, latency_rate=0.1, latency_s=0.0)


def _fired_sites() -> set[str]:
    """The site literals at the port's fire/corrupt_* calls."""
    call = re.compile(r"\.(?:fire|corrupt_flat|corrupt_array)\(\s*\"(\w+)\"")
    found = set()
    for root, _, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    found.update(call.findall(f.read()))
    return found


def test_fault_sites_are_jax_sites():
    assert FAULT_SITES == JFAULT_SITES
    assert not hasattr(inject, "ARMED_SITES") and not hasattr(inject, "require_armed")
    assert _fired_sites() == set(FAULT_SITES)


def _outcomes(mod, cfg, sites, n=200):
    inj = mod.FaultInjector(cfg)
    out = []
    for i in range(n):
        for site in sites:
            before = inj.count(site)
            try:
                inj.fire(site, detail=f"step{i}")
                kind = "latency" if inj.count(site) > before else "clean"
                out.append((site, kind))
            except BaseException as e:  # noqa: BLE001 — the outcome is the assertion
                code = getattr(e, "errno", None)
                out.append((site, type(e).__name__, str(e), code))
    return out, list(inj.events), {s: inj.count(s) for s in sites}


@pytest.mark.parametrize("site", FAULT_SITES)
def test_schedule_matches_jax_for_every_site(site):
    for seed in range(4):
        kw = dict(enabled=True, seed=seed, **RATES)
        ours = _outcomes(inject, FaultConfig(**kw), [site])
        theirs = _outcomes(jinject, JFaultConfig(**kw), [site])
        assert ours == theirs, (site, seed)
        assert ours[2][site] > 0  # the rates did fire


@pytest.mark.parametrize("budget", [0, 1, 7])
def test_budget_and_site_filter_match_jax(budget):
    """All sites interleaved on one thread under a shared budget, and a
    config restricted to two sites (the others draw nothing)."""
    for seed in range(4):
        kw = dict(enabled=True, seed=seed, max_faults=budget, **RATES)
        assert (_outcomes(inject, FaultConfig(**kw), FAULT_SITES, n=50)
                == _outcomes(jinject, JFaultConfig(**kw), FAULT_SITES, n=50))
        kw = dict(kw, sites=("replica_kill", "shard_read"))
        ours = _outcomes(inject, FaultConfig(**kw), FAULT_SITES, n=50)
        assert ours == _outcomes(jinject, JFaultConfig(**kw), FAULT_SITES, n=50)
        assert set(ours[2]) == set(FAULT_SITES)
        assert all(ours[2][s] == 0 for s in FAULT_SITES if s not in kw["sites"])


def test_disk_full_raises_enospc_and_link_throttle_never_errors():
    cfg = FaultConfig(enabled=True, error_rate=1.0, latency_s=0.0)
    inj = inject.FaultInjector(cfg)
    with pytest.raises(OSError) as e:
        inj.fire("disk_full")
    assert e.value.errno == errno.ENOSPC
    inj.fire("link_throttle")  # a stall, not an error
    with pytest.raises(MemoryError):
        inj.fire("host_oom")
    with pytest.raises(inject.InjectedFault):
        inj.fire("replica_kill")
    with pytest.raises(ValueError, match="unknown fault site"):
        inj.fire("nope")
    assert inject.FaultInjector.from_config(FaultConfig()) is None


ARRAYS = {
    "float32": np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32),
    "int8": np.random.default_rng(1).integers(-128, 127, (7,)).astype(np.int8),
    "float64": np.random.default_rng(2).standard_normal((2, 2, 3)),
    "empty": np.zeros((0, 4), np.float32),
}


@pytest.mark.parametrize("seed", range(3))
def test_corrupt_flat_and_array_give_jax_bytes(seed):
    """Bit-flip, truncated and latency draws over 60 calls each: the same
    outcome, the same chosen tensor and the same bytes."""
    kw = dict(enabled=True, seed=seed, error_rate=0.5, truncate_rate=0.2, latency_rate=0.1,
              latency_s=0.0)
    ours, theirs = inject.FaultInjector(FaultConfig(**kw)), jinject.FaultInjector(JFaultConfig(**kw))
    flips = 0
    for i in range(60):
        flat_np = {k: v.copy() for k, v in ARRAYS.items()}
        flat_t = {k: torch.from_numpy(v.copy()) for k, v in ARRAYS.items()}
        got = want = None
        try:
            got = ours.corrupt_flat("corrupt_shard", flat_t)
        except inject.TruncatedRead as e:
            got = ("truncated", str(e))
        try:
            want = theirs.corrupt_flat("corrupt_shard", flat_np)
        except jinject.TruncatedRead as e:
            want = ("truncated", str(e))
        if isinstance(want, tuple):
            assert got == want
        else:
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].numpy().tobytes() == np.ascontiguousarray(want[k]).tobytes(), (i, k)
                flips += int(got[k].numpy().tobytes() != ARRAYS[k].tobytes())
        arr = ARRAYS["float32"]
        try:
            a = ours.corrupt_array("corrupt_activation", torch.from_numpy(arr.copy()))
            a = a.numpy().tobytes()
        except inject.TruncatedRead as e:
            a = str(e)
        try:
            b = theirs.corrupt_array("corrupt_activation", arr.copy())
            b = np.ascontiguousarray(b).tobytes()
        except jinject.TruncatedRead as e:
            b = str(e)
        assert a == b, i
    assert flips > 0
    assert ours.events == theirs.events


def test_flip_bit_keeps_dtype_shape_and_source():
    t = torch.arange(12, dtype=torch.bfloat16).reshape(3, 4)
    out = inject.FaultInjector._flip_bit(t, "k")
    assert out.dtype == t.dtype and out.shape == t.shape
    assert torch.equal(t, torch.arange(12, dtype=torch.bfloat16).reshape(3, 4))
    diff = (out.view(torch.int16) ^ t.view(torch.int16)).flatten().tolist()
    assert sum(bin(d & 0xFFFF).count("1") for d in diff) == 1


BAD_FAULTS = [dict(error_rate=1.5), dict(error_rate=0.6, truncate_rate=0.6),
              dict(latency_s=-1.0), dict(sites=("nope",))]


@pytest.mark.parametrize("kw", BAD_FAULTS, ids=[str(k) for k in BAD_FAULTS])
def test_fault_config_validates_as_jax(kw):
    with pytest.raises(ValueError) as ours:
        FaultConfig(**kw)
    with pytest.raises(ValueError) as theirs:
        JFaultConfig(**kw)
    assert str(ours.value) == str(theirs.value)
    assert FaultConfig(error_rate=0.1, truncate_rate=0.2, latency_rate=0.7).sites == ()


# ---------------------------------------------------------------------------
# Every site is taken
# ---------------------------------------------------------------------------

UNARMED = [(s,) for s in FAULT_SITES if s not in FLEET_SITES] + [(), (
    "replica_kill", "shard_read")]


def _ids(sites):
    return ",".join(sites) or "every_site"


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny llama (1 layer, hidden 32) saved by the JAX package."""
    d = tmp_path_factory.mktemp("inject_model")
    cfg = JLlamaConfig.from_hf_config(dict(
        model_type="llama", vocab_size=256, hidden_size=32, intermediate_size=64,
        max_position_embeddings=128, num_hidden_layers=1, num_attention_heads=2,
        num_key_value_heads=1))
    jckpt.save_params(jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(0), cfg)),
                      str(d), cfg)
    return str(d)


@pytest.mark.parametrize("where", ["engine", "fleet", "cli"])
@pytest.mark.parametrize("sites", UNARMED, ids=[_ids(s) for s in UNARMED])
def test_unarmed_site_raises(where, sites, model_dir):
    """The sites the fleet does not fire itself, and every site, the
    default: an engine and a fleet are built with the injector wired into
    their queues, and both CLI parsers turn ``--chaos_sites`` into the
    config (the name is kept from when the port refused them)."""
    faults = FaultConfig(enabled=True, error_rate=0.5, sites=sites)
    cfg = FrameworkConfig(model_path=model_dir, device="cpu", dtype="float32", faults=faults)
    if where == "engine":
        eng = ServeEngine(cfg, ServeConfig(), tokenizer=FakeTokenizer(),
                          device=torch.device("cpu"), start=False)
        try:
            assert eng._injector.config.sites == sites
            assert eng.queue._injector is eng._injector
        finally:
            eng.shutdown(drain=False)
    elif where == "fleet":
        fleet = ReplicaFleet(cfg, ServeConfig(replicas=2), tokenizer=FakeTokenizer(),
                             device=torch.device("cpu"), start=False)
        try:
            with fleet._lock:
                engines = [rep.engine for rep in fleet._replicas]
            assert len(engines) == 2
            assert all(e._injector.config.sites == sites for e in engines)
        finally:
            fleet.shutdown(drain=False)
    else:
        flags = ["--chaos", *(["--chaos_sites", ",".join(sites)] if sites else [])]
        serve = cli.build_serve_parser().parse_args(["--replicas", "2", *flags])
        batch = cli.build_parser().parse_args(["--prompt_pickle", "p", "--output_file", "o",
                                               *flags])
        assert cli._fault_config_from_args(serve) == faults.__class__(
            enabled=True, error_rate=0.1, sites=sites)
        assert cli.config_from_args(batch).faults == cli._fault_config_from_args(serve)


@pytest.mark.parametrize("sites", [("replica_kill",), ("replica_stall",),
                                   ("replica_kill", "replica_stall")])
def test_armed_sites_are_taken(sites):
    """A config naming the fleet's sites draws only them."""
    inj = inject.FaultInjector(FaultConfig(enabled=True, error_rate=1.0, sites=sites))
    for site in FAULT_SITES:
        try:
            inj.fire(site)
        except inject.InjectedFault:
            pass
    assert {s for s, _, _ in inj.events} == set(sites)
    assert inject.FaultInjector.from_config(FaultConfig(sites=sites)) is None
    assert inject.FaultInjector.from_config(None) is None
