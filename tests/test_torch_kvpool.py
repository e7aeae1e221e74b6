"""The port's paged prefix-KV pool against the JAX package's, on the same
scripted id sequences and seeded float32 KV rows.

Each script runs on a fresh pool of each package. After every operation
the two must agree: ``reusable`` of each acquire, every stats counter the
two pools share, ``entry_bytes``, the assembled pages (byte-equal), a typed
spill error where one is raised, and at the end the spill files and their
``.crc`` sidecars (byte-equal; compared as multisets of contents, because
pages of one contribution tie in the LRU order and take their file
numbers in set order). Budgets force spills (``set_budget``) that the next
reuse loads back; a read that fails its checksum once heals, one that
fails every time drops the page and unseals the entry. The brownout lever
(``pressure_evict``/``pressure_restore``) and a chaos injector's
``corrupt_activation`` flips on page reads run the same scripts.
"""

import os

import numpy as np
import pytest
import torch

from flexible_llm_sharding_tpu.config import FaultConfig as JFaultConfig
from flexible_llm_sharding_tpu.faults.inject import FaultInjector as JFaultInjector
from flexible_llm_sharding_tpu.integrity.manifest import SpillCorruptError as JSpillCorruptError
from flexible_llm_sharding_tpu.runtime import kvpool as jkvpool
from flexible_llm_sharding_tpu_torch.config import FaultConfig
from flexible_llm_sharding_tpu_torch.faults.inject import FaultInjector
from flexible_llm_sharding_tpu_torch.integrity.manifest import SpillCorruptError
from flexible_llm_sharding_tpu_torch.runtime import kvpool

SHAPE = (2, 16, 2, 4)  # [k_layers, Lp_bucket, n_kv, hd]
IDS_A = tuple(range(10, 26))
IDS_B = IDS_A[:8] + tuple(range(200, 208))  # shares A's first two 4-token chunks
IDS_C = tuple(range(40, 50))  # 10 real tokens in a 16-row bucket

SCRIPTS = {
    "roundtrip": [
        ("acquire", "a", IDS_A, 16, 16), ("contribute", "a", (0, 0), 1),
        ("contribute", "a", (1, 0), 2), ("seal", "a"), ("release", "a"),
        ("acquire", "a2", IDS_A, 16, 16), ("assemble", "a2", (0, 0)), ("assemble", "a2", (1, 0)),
        ("release", "a2"), ("release", "a2"),
    ],
    "cow_split": [
        ("acquire", "a", IDS_A, 16, 16), ("contribute", "a", (0, 0), 1), ("seal", "a"),
        ("release", "a"), ("acquire", "b", IDS_B, 16, 16), ("contribute", "b", (0, 0), 2),
        ("seal", "b"), ("assemble", "b", (0, 0)), ("release", "b"),
        ("acquire", "b2", IDS_B, 16, 16), ("assemble", "b2", (0, 0)),
    ],
    "bucket_and_salt": [
        ("acquire", "c", IDS_C, 10, 16), ("contribute", "c", (0, 0), 3), ("seal", "c"),
        ("release", "c"), ("acquire", "c24", IDS_C, 10, 24),  # another bucket: a new leaf
        ("acquire", "cs", IDS_C, 10, 16, "adapter-x"),  # salted: a trie of its own
        ("acquire", "c2", IDS_C, 10, 16), ("assemble", "c2", (0, 0)),
    ],
    "spill_then_heal_on_reuse": [
        ("acquire", "a", IDS_A, 16, 16), ("contribute", "a", (0, 0), 1), ("seal", "a"),
        ("budget", 0),  # leased: nothing evicts
        ("release", "a"), ("budget", 0),  # every page spills
        ("files",), ("budget", 1 << 30),
        ("acquire", "a2", IDS_A, 16, 16), ("assemble", "a2", (0, 0)), ("files",),
    ],
    "lru_eviction_order": [
        ("acquire", "a", IDS_A, 16, 16), ("contribute", "a", (0, 0), 1), ("seal", "a"),
        ("release", "a"), ("acquire", "c", IDS_C, 10, 16), ("contribute", "c", (0, 0), 3),
        ("seal", "c"), ("release", "c"),
        # C's pages are newer: a budget of exactly C's bytes (k and v of its
        # 16-row bucket) spills A's only.
        ("budget", 2 * int(np.prod(SHAPE)) * 4), ("files",),
        ("acquire", "c2", IDS_C, 10, 16), ("assemble", "c2", (0, 0)),
        ("budget", 1 << 30), ("acquire", "a2", IDS_A, 16, 16), ("assemble", "a2", (0, 0)),
    ],
    "drop_without_spill": [
        ("acquire", "a", IDS_A, 16, 16), ("contribute", "a", (0, 0), 1), ("seal", "a"),
        ("release", "a"), ("no_spill",), ("budget", 0), ("budget", 1 << 30),
        ("acquire", "a2", IDS_A, 16, 16), ("files",),
    ],
    "persistent_corruption": [
        ("acquire", "a", IDS_A, 16, 16), ("contribute", "a", (0, 0), 1), ("seal", "a"),
        ("release", "a"), ("budget", 0), ("budget", 1 << 30), ("corrupt_files",),
        ("acquire", "a2", IDS_A, 16, 16), ("assemble", "a2", (0, 0)), ("release", "a2"),
        ("acquire", "a3", IDS_A, 16, 16), ("files",),
    ],
    "transient_corruption_heals": [
        ("acquire", "a", IDS_A, 16, 16), ("contribute", "a", (0, 0), 1), ("seal", "a"),
        ("release", "a"), ("budget", 0), ("budget", 1 << 30), ("flaky_load",),
        ("acquire", "a2", IDS_A, 16, 16), ("assemble", "a2", (0, 0)), ("files",),
    ],
}

_COMMON_STATS = ("pages_allocated", "pages_shared", "cow_splits", "pages_evicted", "pages_healed",
                 "prefix_reuse_hits", "pages_resident", "pages_spilled", "bytes_resident",
                 "budget_bytes", "entries_sealed")


def _kv(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(SHAPE).astype(np.float32),
            rng.standard_normal(SHAPE).astype(np.float32))


def _spill_files(spill_dir):
    """The spill files as multisets of (k or v, contents) and sidecar
    contents."""
    if not os.path.isdir(spill_dir):
        return [], []
    npy, crc = [], []
    for name in sorted(os.listdir(spill_dir)):
        with open(os.path.join(spill_dir, name), "rb") as f:
            data = f.read()
        if name.endswith(".crc"):
            crc.append(data)
        else:
            npy.append((name.rsplit("-", 1)[1], data))
    return sorted(npy), sorted(crc)


def _run(script, module, spill_dir, monkeypatch, port: bool):
    """Apply ``script`` to a fresh pool of ``module``; returns what each
    operation observed."""
    pool = module.KVPagePool(4, 1 << 30, spill_dir=spill_dir, host_spill=True)
    handles, obs = {}, []
    for op, *args in script:
        if op == "acquire":
            name, ids, plen, bucket, *salt = args
            h = pool.acquire(ids, plen, bucket, salt=salt[0] if salt else None)
            handles[name] = h
            obs.append((op, name, h.reusable, pool.entry_bytes(h)))
        elif op == "contribute":
            name, seg, seed = args
            k, v = _kv(seed)
            if port:
                k, v = torch.from_numpy(k), torch.from_numpy(v)
            pool.contribute(handles[name], seg, k, v)
        elif op == "seal":
            pool.seal(handles[args[0]])
            obs.append((op, pool.entry_bytes(handles[args[0]])))
        elif op == "release":
            pool.release(handles[args[0]])
        elif op == "assemble":
            try:
                k, v = pool.assemble(handles[args[0]], args[1])
            except (SpillCorruptError, JSpillCorruptError) as e:
                obs.append((op, "corrupt", "corrupt after" in str(e)))
            else:
                if port:
                    assert k.dtype == v.dtype == torch.float32
                    k, v = k.numpy(), v.numpy()
                obs.append((op, k.tobytes(), v.tobytes()))
        elif op == "budget":
            pool.set_budget(args[0])
        elif op == "pressure_evict":
            obs.append((op, pool.pressure_evict()))
        elif op == "pressure_restore":
            obs.append((op, pool.pressure_restore()))
        elif op == "injector":
            rate, budget = args
            kw = dict(enabled=True, seed=7, error_rate=rate, max_faults=budget,
                      sites=("corrupt_activation",))
            pool.set_injector(FaultInjector(FaultConfig(**kw)) if port
                              else JFaultInjector(JFaultConfig(**kw)))
        elif op == "no_spill":
            pool.host_spill = False
        elif op == "files":
            obs.append((op, _spill_files(spill_dir)))
        elif op == "corrupt_files":
            for name in os.listdir(spill_dir):
                if name.endswith(".npy"):
                    path = os.path.join(spill_dir, name)
                    data = bytearray(open(path, "rb").read())
                    data[-1] ^= 0xFF
                    open(path, "wb").write(bytes(data))
        elif op == "flaky_load":
            real, first = np.load, [True]

            def flaky(path, *a, **kw):
                arr = real(path, *a, **kw)
                if first[0]:
                    first[0] = False
                    arr = arr.copy()
                    arr.reshape(-1)[0] += 1.0
                return arr

            monkeypatch.setattr(np, "load", flaky)
        stats = pool.stats()
        obs.append(("stats", op, tuple(stats[k] for k in _COMMON_STATS)))
    return obs


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_pool_matches_jax_pool(name, tmp_path, monkeypatch):
    real_load = np.load
    got_j = _run(SCRIPTS[name], jkvpool, str(tmp_path / "jax"), monkeypatch, port=False)
    monkeypatch.setattr(np, "load", real_load)
    got_p = _run(SCRIPTS[name], kvpool, str(tmp_path / "port"), monkeypatch, port=True)
    monkeypatch.setattr(np, "load", real_load)
    assert len(got_p) == len(got_j)
    for j, p in zip(got_j, got_p):
        assert p == j


def test_scripts_reach_every_pool_path(tmp_path, monkeypatch):
    """The scripts above exercise what they claim (on the port's pool):
    a copy-on-write split, spills, an eviction that keeps the newer entry,
    a heal, a drop without spill, and the typed persistent-corruption
    error that unseals the entry."""
    def final(name):
        real_load = np.load
        try:
            return _run(SCRIPTS[name], kvpool, str(tmp_path / name), monkeypatch, port=True)
        finally:
            monkeypatch.setattr(np, "load", real_load)

    def last_stats(obs):
        return dict(zip(_COMMON_STATS, [o for o in obs if o[0] == "stats"][-1][2]))

    assert last_stats(final("cow_split"))["cow_splits"] == 1
    obs = final("spill_then_heal_on_reuse")
    files = [o[1] for o in obs if o[0] == "files"]
    assert len(files[0][0]) == 8 and len(files[0][1]) == 8 and files[1] == ([], [])
    assert last_stats(obs)["pages_evicted"] == 4
    lru = final("lru_eviction_order")
    assert len([o for o in lru if o[0] == "files"][0][1][0]) == 8  # A's four pages, k and v
    assert last_stats(final("transient_corruption_heals"))["pages_healed"] == 1
    drop = final("drop_without_spill")
    assert [o for o in drop if o[0] == "acquire"][-1][2] is False
    corrupt = final("persistent_corruption")
    assert ("assemble", "corrupt", True) in corrupt
    assert [o for o in corrupt if o[0] == "acquire"][-1][2] is False


def test_process_pools_follow_the_config(tmp_path):
    """``pool_for``: one pool per (model, dtype, paging geometry), None when
    disabled; the budget follows the latest config; the auto budget is the
    JAX package's."""
    from flexible_llm_sharding_tpu.config import FrameworkConfig as JFrameworkConfig
    from flexible_llm_sharding_tpu_torch.config import FrameworkConfig

    kvpool.reset_process_pools()
    jkvpool.reset_process_pools()
    try:
        for kw in ({}, {"kv_pool_gb": 0.0}, {"kv_page_tokens": 0}, {"kv_pool_gb": 0.5}):
            common = dict(model_path=str(tmp_path), disk_folder=str(tmp_path / "d"), **kw)
            p, j = kvpool.pool_for(FrameworkConfig(**common)), jkvpool.pool_for(
                JFrameworkConfig(**common))
            assert (p is None) == (j is None)
            if p is not None:
                assert (p.page_tokens, p.spill_dir, p.host_spill) == (
                    j.page_tokens, j.spill_dir, j.host_spill)
        assert len(kvpool.process_pools()) == len(jkvpool.process_pools()) == 1
        assert kvpool.process_pools()[0].budget_bytes == int(0.5e9)
        assert set(kvpool.process_stats()) <= set(jkvpool.process_stats())
        assert kvpool._auto_budget_bytes() == jkvpool._auto_budget_bytes() or abs(
            kvpool._auto_budget_bytes() - jkvpool._auto_budget_bytes()) < 64 << 20
    finally:
        kvpool.reset_process_pools()
        jkvpool.reset_process_pools()


# The brownout lever and the chaos site, each on a sealed, released entry.
PRESSURE_SCRIPTS = {
    "pressure_evict": [
        ("acquire", "a", IDS_A, 16, 16), ("contribute", "a", (0, 0), 1), ("seal", "a"),
        ("pressure_evict",),  # leased: nothing evicts
        ("release", "a"), ("pressure_evict",),  # every page spills
        ("acquire", "c", IDS_C, 10, 16), ("contribute", "c", (0, 0), 3), ("seal", "c"),
        ("release", "c"), ("budget", 1 << 30), ("files",),  # the latch holds the budget at 0
    ],
    "pressure_restore": [
        ("acquire", "a", IDS_A, 16, 16), ("contribute", "a", (0, 0), 1), ("seal", "a"),
        ("release", "a"), ("pressure_evict",), ("pressure_restore",),
        ("acquire", "a2", IDS_A, 16, 16), ("assemble", "a2", (0, 0)), ("release", "a2"),
        ("budget", 1 << 30), ("files",),
    ],
    "set_injector": [
        ("acquire", "a", IDS_A, 16, 16), ("contribute", "a", (0, 0), 1), ("seal", "a"),
        ("release", "a"), ("budget", 0), ("budget", 1 << 30), ("injector", 1.0, 2),
        ("acquire", "a2", IDS_A, 16, 16), ("assemble", "a2", (0, 0)), ("files",),
    ],
}


@pytest.mark.parametrize("call", ["pressure_evict", "pressure_restore", "set_injector"])
def test_unported_pool_paths_raise(call, tmp_path, monkeypatch):
    """The pool's brownout lever and chaos site against the JAX pool's (the
    name is kept from when the port refused them): the same observations
    after every step, and each path really acts."""
    script = PRESSURE_SCRIPTS[call]
    got_j = _run(script, jkvpool, str(tmp_path / "jax"), monkeypatch, port=False)
    got_p = _run(script, kvpool, str(tmp_path / "port"), monkeypatch, port=True)
    assert got_p == got_j
    last = dict(zip(_COMMON_STATS, [o for o in got_p if o[0] == "stats"][-1][2]))
    if call == "pressure_evict":
        assert [o[1] for o in got_p if o[0] == "pressure_evict"] == [0, 4]
        assert last["pages_resident"] == 0 and last["pages_spilled"] == 7  # A 4 pages, C 3
    elif call == "pressure_restore":
        assert last["pages_evicted"] == 4 and last["pages_resident"] == 4
    else:
        assert last["pages_healed"] == 1 and last["pages_resident"] == 4


def test_pool_summary_matches_jax(tmp_path, monkeypatch):
    """The bounded entry table of ``summary`` after the copy-on-write
    script: the same entries (order aside) and counters as the JAX pool's."""
    pools = []
    for module, port in ((jkvpool, False), (kvpool, True)):
        pool = module.KVPagePool(4, 1 << 30, spill_dir=str(tmp_path / str(port)))
        for ids, seed in ((IDS_A, 1), (IDS_B, 2), (IDS_C, 3)):
            h = pool.acquire(ids, len(ids), 16)
            k, v = _kv(seed)
            if port:
                k, v = torch.from_numpy(k), torch.from_numpy(v)
            pool.contribute(h, (0, 0), k, v)
            pool.seal(h)
        pools.append(pool.summary())
    (j, p) = pools
    key = lambda e: sorted(e.items())  # noqa: E731
    assert sorted(p["entries"], key=key) == sorted(j["entries"], key=key)
    assert p["counters"] == j["counters"]


@pytest.mark.parametrize("spill", [True, False])
def test_schedcore_serving_methods_match_jax(spill, tmp_path):
    """``admission_quota``, ``replay_deadline`` and ``spill_policy`` of the
    port's SchedCore against JAX's."""
    from flexible_llm_sharding_tpu.config import FrameworkConfig as JFrameworkConfig
    from flexible_llm_sharding_tpu.runtime.schedcore import SchedCore as JSchedCore
    from flexible_llm_sharding_tpu_torch.config import FrameworkConfig
    from flexible_llm_sharding_tpu_torch.runtime.schedcore import SchedCore

    common = dict(model_path=str(tmp_path), kv_host_spill=spill)
    for core, jcore in ((SchedCore(FrameworkConfig(**common)),
                         JSchedCore(JFrameworkConfig(**common))), (SchedCore(), JSchedCore())):
        assert core.spill_policy() == jcore.spill_policy()
        for cap, active in ((32, 0), (32, 31), (8, 8), (4, 9)):
            assert core.admission_quota(cap, active) == jcore.admission_quota(cap, active)
        for left in (None, -3.0, 0.0, 2.5):
            assert core.replay_deadline(left, now=100.0) == jcore.replay_deadline(left, now=100.0)
