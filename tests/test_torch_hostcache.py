"""The port's host shard cache against the JAX package's: the same scripted
sequences of put, get, invalidate_path, set_budget and backing-file drift
give the same hits, misses, evictions, invalidations and bytes; the auto
budget resolves the same way from a monkeypatched MemAvailable; and the
port's weight source serves warm passes from it."""

import os

import numpy as np
import pytest
import torch

from flexible_llm_sharding_tpu.config import FrameworkConfig as JFrameworkConfig
from flexible_llm_sharding_tpu.runtime import hostcache as jhostcache
from flexible_llm_sharding_tpu_torch.config import FrameworkConfig
from flexible_llm_sharding_tpu_torch.runtime import hostcache
from flexible_llm_sharding_tpu_torch.runtime.executor import ShardWeightSource, _tree_leaves
from flexible_llm_sharding_tpu_torch.utils import checkpoint


@pytest.fixture(autouse=True)
def _fresh_process_caches():
    hostcache.reset_process_cache()
    jhostcache.reset_process_cache()
    yield
    hostcache.reset_process_cache()
    jhostcache.reset_process_cache()


def _files(tmp_path, n=6):
    paths = []
    for i in range(n):
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(b"x" * (i + 1))
        paths.append(str(p))
    return paths


def _script(seed, paths, n_ops=120):
    """A random sequence of cache operations over ``paths``."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(["put", "get", "get", "get", "invalidate", "budget", "drift"],
                          p=[0.3, 0.15, 0.15, 0.15, 0.08, 0.07, 0.1])
        key = int(rng.integers(0, 8))
        if kind == "put":
            ps = [paths[j] for j in rng.choice(len(paths), size=int(rng.integers(1, 3)))]
            ops.append(("put", key, ps, int(rng.integers(10, 400))))
        elif kind == "get":
            ops.append(("get", key))
        elif kind == "invalidate":
            ops.append(("invalidate", paths[int(rng.integers(0, len(paths)))]))
        elif kind == "budget":
            ops.append(("budget", int(rng.integers(100, 1200))))
        else:
            ops.append(("drift", paths[int(rng.integers(0, len(paths)))]))
    return ops


def _replay(cache, mod, ops):
    trace = []
    for op in ops:
        if op[0] == "put":
            _, key, ps, n = op
            trace.append(cache.put(key, {"v": key}, nbytes=n, guard=mod.stat_guard(ps)))
        elif op[0] == "get":
            hit = cache.get(op[1])
            trace.append(None if hit is None else hit[1])
        elif op[0] == "invalidate":
            trace.append(cache.invalidate_path(op[1]))
        elif op[0] == "budget":
            cache.set_budget(op[1])
        trace.append(cache.stats())
    return trace


@pytest.mark.parametrize("seed", range(6))
def test_scripted_sequences_match_jax(tmp_path, seed):
    paths = _files(tmp_path)
    ops = _script(seed, paths)
    # Drift is applied to the files between the two replays' matching
    # steps: each replay sees the same stat changes at the same step.
    traces = []
    for cache, mod in ((jhostcache.HostShardCache(800), jhostcache),
                       (hostcache.HostShardCache(800), hostcache)):
        for p in paths:
            os.utime(p, ns=(10**18, 10**18))
        trace = []
        for op in ops:
            if op[0] == "drift":
                st = os.stat(op[1])
                os.utime(op[1], ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
                continue
            trace += _replay(cache, mod, [op])
        traces.append(trace)
    assert traces[0] == traces[1]
    final = traces[1][-1]
    assert final["hits"] and final["misses"] and final["evictions"]


def test_put_refuses_an_entry_over_budget_and_an_unstatable_path(tmp_path):
    for mod in (jhostcache, hostcache):
        cache = mod.HostShardCache(100)
        assert not cache.put("big", {}, nbytes=101, guard=())
        assert not cache.put("gone", {}, paths=[str(tmp_path / "missing")], nbytes=1)
        assert cache.stats()["entries"] == 0
    with pytest.raises(ValueError):
        hostcache.HostShardCache(0)


def test_tree_nbytes_charges_full_size():
    tree = [("model.layers.0", {"attn": {"wq": torch.zeros(4, 8)}, "n": torch.zeros(3).half()}),
            ("lm_head", {"kernel": torch.zeros(2, 2, dtype=torch.bfloat16)})]
    want = jhostcache._tree_nbytes([
        ("decoders", {"wq": np.zeros((4, 8), np.float32), "n": np.zeros(3, np.float16)}),
        ("head", {"kernel": np.zeros((2, 2), np.float16)})])
    assert hostcache.tree_nbytes([t for _, t in tree]) == want == 4 * 8 * 4 + 3 * 2 + 4 * 2


def test_auto_budget_and_explicit_pin_match_jax(monkeypatch):
    avail = {"n": 8 * 10**9}
    monkeypatch.setattr(hostcache, "available_host_bytes", lambda: avail["n"])
    monkeypatch.setattr(jhostcache, "available_host_bytes", lambda: avail["n"])
    steps = [(None, 8e9), (None, 12e9), (None, 4e9), (1.5, 4e9), (None, 40e9), (0.5, 4e9),
             (0, 4e9)]
    budgets = []
    for gb, mem in steps:
        avail["n"] = int(mem)
        mine = hostcache.cache_for(FrameworkConfig(host_cache_gb=gb))
        ref = jhostcache.cache_for(JFrameworkConfig(host_cache_gb=gb))
        assert (mine is None) == (ref is None)
        budgets.append(None if mine is None else (mine.budget_bytes, ref.budget_bytes))
    assert [b[0] for b in budgets[:-1]] == [b[1] for b in budgets[:-1]] == \
        [2 * 10**9, 3 * 10**9, 3 * 10**9, 15 * 10**8, 15 * 10**8, 5 * 10**8]
    assert budgets[-1] is None
    assert hostcache.process_cache() is hostcache.cache_for(FrameworkConfig(host_cache_gb=None))
    avail["n"] = 0
    hostcache.reset_process_cache()
    assert hostcache.cache_for(FrameworkConfig()) is None  # unknown free RAM: off


def test_available_host_bytes_reads_meminfo():
    assert hostcache.available_host_bytes() == jhostcache.available_host_bytes()


def _llama_dir(tmp_path, tied=False):
    from flexible_llm_sharding_tpu_torch.config import LlamaConfig

    cfg = LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                      num_attention_heads=2, num_key_value_heads=1, tie_word_embeddings=tied)
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(*s, generator=g)

    layer = {"input_layernorm": {"scale": r(32)}, "post_attention_layernorm": {"scale": r(32)},
             "attn": {"wq": r(32, 32), "wk": r(32, 16), "wv": r(32, 16), "wo": r(32, 32)},
             "mlp": {"gate": r(32, 64), "up": r(32, 64), "down": r(64, 32)}}
    params = {"embed": {"embedding": r(64, 32)}, "layers": [layer, layer],
              "norm": {"scale": r(32)}}
    if not tied:
        params["lm_head"] = {"kernel": r(32, 64)}
    checkpoint.save_params(params, str(tmp_path), cfg)
    return cfg


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_source_serves_warm_passes_from_the_cache(tmp_path, tied):
    cfg = _llama_dir(tmp_path, tied)
    names = checkpoint.layer_names_for(cfg.num_hidden_layers)
    shards = [(i,) for i in range(len(names))]
    cache = hostcache.HostShardCache(10**9)
    outs = []
    for _ in range(3):
        src = ShardWeightSource(str(tmp_path), names, shards, torch.float32, torch.device("cpu"),
                                prefetch_depth=1, tied_embeddings=tied, host_cache=cache)
        outs.append([[params for _, params in segments] for _, segments in src])
        src.close()
    n = len(shards)
    assert cache.stats()["hits"] == 2 * n
    assert cache.stats()["misses"] == n + tied  # the tied head: one more entry
    for a, b in zip(_tree_leaves(outs[0]), _tree_leaves(outs[2])):
        assert torch.equal(a, b)
    # A rewritten file drops its entry; the next pass reads and verifies it.
    p = checkpoint.layer_file(str(tmp_path), "model.layers.1")
    st = os.stat(p)
    os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    src = ShardWeightSource(str(tmp_path), names, shards, torch.float32, torch.device("cpu"),
                            prefetch_depth=0, tied_embeddings=tied, host_cache=cache)
    list(src)
    src.close()
    assert cache.stats()["invalidations"] == 1
