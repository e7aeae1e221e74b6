"""Per-tenant adapter hot-load and eviction: a byte-budgeted host LRU (the
JAX package's ``adapters/loader.py``), with the safety model of the host
shard cache (``runtime/hostcache.py``):

- An entry is inserted only after every delta file's checksum verified
  against the adapter directory's manifest: a cached adapter is a verified
  one.
- Every entry records its files' ``(mtime_ns, size)`` taken before the read
  (``hostcache.stat_guard``) and re-stats them on a hit: any drift drops the
  entry, so a re-prepared or repaired adapter is read again without a
  restart.
- A read whose checksum fails is read again (``reread_heals`` when a later
  read passes); corruption that survives every read raises
  :class:`~flexible_llm_sharding_tpu_torch.adapters.registry.AdapterCorruptError`,
  not retried: the store drops the adapter (``corrupt_evictions``) and only
  that tenant's requests fail.

The budget is ``AdapterConfig.max_gb``: explicit GB, 0 to disable, or None
(auto) for 5% of the available host RAM. The brownout ladder's reversible
``adapter_evict`` rung (``runtime/pressure.py``) shrinks the live budget
through :func:`apply_pressure_cap` and restores it through
:func:`lift_pressure_cap`. Under chaos the store's ``injector`` fires
``corrupt_shard`` on every delta read, before its checksum check. Hits,
loads, re-read heals and corrupt evictions are trace instants, and the
process store is the ``adapter`` registry source.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any

from flexible_llm_sharding_tpu_torch.adapters.registry import (
    ADAPTER_PLAN_NAME,
    AdapterCorruptError,
    AdapterRegistry,
)
from flexible_llm_sharding_tpu_torch.faults.inject import InjectedFault
from flexible_llm_sharding_tpu_torch.integrity import manifest as integrity_manifest
from flexible_llm_sharding_tpu_torch.obs import trace as obs_trace
from flexible_llm_sharding_tpu_torch.obs.registry import REGISTRY
from flexible_llm_sharding_tpu_torch.runtime.hostcache import available_host_bytes, stat_guard
from flexible_llm_sharding_tpu_torch.utils.checkpoint import read_safetensors

# Auto budget: a small slice of MemAvailable; deltas are tiny next to the
# base model.
ADAPTER_AUTO_FRACTION = 0.05
# Unknown free RAM must not disable adapter serving: fall back to 1 GB.
_AUTO_FALLBACK_BYTES = 1 << 30
# Reads per delta file before a checksum mismatch counts as persistent.
_READ_ATTEMPTS = 3


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class AdapterStore:
    """Byte-budgeted, thread-safe LRU of verified adapter factors.

    Values are ``(plan, factors)``, ``factors`` mapping decoder layer names
    to ``{"lora_A": [D, r], "lora_B": [r, D]}`` float32 CPU tensors, shared
    across waves and never modified. ``get`` re-stats on a hit and loads
    and verifies on a miss."""

    def __init__(self, root: str, budget_bytes: int, injector=None):
        if budget_bytes <= 0:
            raise ValueError("budget_bytes must be > 0 (use None store to disable)")
        self.registry = AdapterRegistry(root)
        self._lock = threading.RLock()
        self.budget_bytes = int(budget_bytes)  # guarded by: _lock
        # name -> ((plan, factors), nbytes, ((path, (mtime_ns, size)), ...))
        self._entries: "OrderedDict[str, tuple[Any, int, tuple]]" = OrderedDict()  # guarded by: _lock
        self.bytes = 0  # guarded by: _lock
        self.hits = 0
        self.misses = 0
        self.loads = 0
        self.evictions = 0
        self.invalidations = 0
        self.reread_heals = 0
        self.corrupt_evictions = 0
        self.applied_rows = 0
        self.delta_bytes = 0
        # Chaos only (a FaultInjector): corrupt_shard on every delta read.
        self.injector = injector

    # -- core API ----------------------------------------------------------

    def get(self, name: str):
        """``(plan, factors)`` of adapter ``name``: from the LRU when its
        files are unchanged, else read, verified and cached when it fits
        the budget. Raises ``AdapterNotFound`` for an unknown name and
        ``AdapterCorruptError`` for corruption that survives every read."""
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                self.misses += 1
        if entry is not None:
            value, _nb, guard = entry
            # Stat outside the lock: a wedged filesystem must not stall
            # every wave of the process.
            stale = any(integrity_manifest._file_key(path) != st for path, st in guard)
            with self._lock:
                cur = self._entries.get(name)
                if cur is not entry:
                    self.misses += 1
                elif stale:
                    self._drop(name)
                    self.invalidations += 1
                    self.misses += 1
                else:
                    self._entries.move_to_end(name)
                    self.hits += 1
                    obs_trace.instant("adapter_hit", cat="adapter", adapter=name,
                                      bytes=entry[1])
                    return value
        value, nbytes, guard = self._load(name)
        with self._lock:
            self.loads += 1
            if nbytes <= self.budget_bytes:
                if name in self._entries:
                    self._drop(name)
                while self.bytes + nbytes > self.budget_bytes and self._entries:
                    self._drop(next(iter(self._entries)))
                    self.evictions += 1
                self._entries[name] = (value, int(nbytes), guard)
                self.bytes += int(nbytes)
        obs_trace.instant("adapter_load", cat="adapter", adapter=name, bytes=nbytes)
        return value

    def _load(self, name: str):
        """One verified read of adapter ``name``: its plan and every delta
        file, each checked against the manifest (``_READ_ATTEMPTS`` reads
        per file) and against the plan's shapes."""
        adir = self.registry.path(name)  # AdapterNotFound on a miss
        try:
            plan = self.registry.plan(name)  # AdapterCorruptError on rot
            manifest = integrity_manifest.load_manifest(adir)
        except ValueError as e:
            raise self._poison(name, AdapterCorruptError(str(e))) from e
        paths = [os.path.join(adir, ADAPTER_PLAN_NAME)]
        paths += [os.path.join(adir, plan.layer_file(ln)) for ln, _ in plan.layers]
        guard = stat_guard(paths)
        factors: dict[str, dict] = {}
        nbytes = 0
        healed = 0
        for lname, rank in plan.layers:
            path = os.path.join(adir, plan.layer_file(lname))
            flat, healed_here = self._read_verified(name, lname, path, manifest)
            healed += healed_here
            a, b = flat.get("lora_A"), flat.get("lora_B")
            if (a is None or b is None or tuple(a.shape) != (plan.hidden_size, rank)
                    or tuple(b.shape) != (rank, plan.hidden_size)):
                shapes = {k: tuple(v.shape) for k, v in flat.items()}
                raise self._poison(name, AdapterCorruptError(
                    f"{path}: delta shapes {shapes} disagree with the plan ([{plan.hidden_size}, "
                    f"{rank}] / [{rank}, {plan.hidden_size}]) — re-run prepare-adapter"))
            factors[lname] = {"lora_A": a, "lora_B": b}
            nbytes += _nbytes(a) + _nbytes(b)
        if healed:
            with self._lock:
                self.reread_heals += healed
            obs_trace.instant("adapter_reread_heal", cat="adapter", adapter=name, n=healed)
        return (plan, factors), nbytes, guard or ()

    def _read_verified(self, name: str, lname: str, path: str, manifest):
        """One delta file, read again until its checksum verifies or the
        attempts are spent. Returns ``(flat, heals)``. A file the reader
        rejects (a torn header or payload) counts as a mismatch too."""
        mismatches = 0
        for _ in range(_READ_ATTEMPTS):
            try:
                flat = read_safetensors(path)
            except FileNotFoundError:
                raise self._poison(name, AdapterCorruptError(
                    f"{path}: plan lists layer {lname!r} but the delta file is missing — audit "
                    "with verify --adapter_dir")) from None
            except ValueError:
                mismatches += 1
                continue
            if self.injector is not None:
                try:
                    flat = self.injector.corrupt_flat("corrupt_shard", flat,
                                                      detail=f"adapter:{name}/{lname}")
                except InjectedFault:
                    mismatches += 1
                    continue
            if manifest is not None:
                try:
                    integrity_manifest.verify_flat(lname, flat, manifest, path=path)
                except integrity_manifest.ChecksumMismatch:
                    mismatches += 1
                    continue
            return flat, mismatches
        raise self._poison(name, AdapterCorruptError(
            f"{path}: checksum mismatch survived {_READ_ATTEMPTS} re-reads — on-disk "
            "corruption; adapter evicted (audit with verify --adapter_dir, then re-prepare the "
            "adapter)"))

    def _poison(self, name: str, err: AdapterCorruptError) -> AdapterCorruptError:
        """Persistent corruption: drop any cached copy, count it, and hand
        back the typed error for the caller to raise."""
        with self._lock:
            if name in self._entries:
                self._drop(name)
                self.evictions += 1
            self.corrupt_evictions += 1
        obs_trace.instant("adapter_corrupt_evict", cat="adapter", adapter=name)
        return err

    def _drop(self, name: str) -> None:
        # flscheck: holds=_lock: internal helper — every caller already owns the lock
        _value, nbytes, _guard = self._entries.pop(name)
        self.bytes -= nbytes

    # -- budget ------------------------------------------------------------

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.bytes = 0

    def set_budget(self, budget_bytes: int) -> None:
        """Resize the budget; a shrink evicts least recently used first."""
        with self._lock:
            self.budget_bytes = max(int(budget_bytes), 0)
            while self.bytes > self.budget_bytes and self._entries:
                self._drop(next(iter(self._entries)))
                self.evictions += 1

    # -- sweep accounting ----------------------------------------------------

    def note_applied(self, rows: int, nbytes: int) -> None:
        """The engine's charge: batch rows that took a delta in a sweep, and
        delta bytes uploaded to the device."""
        with self._lock:
            self.applied_rows += int(rows)
            self.delta_bytes += int(nbytes)

    def stats(self) -> dict[str, float]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "loads": self.loads,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "reread_heals": self.reread_heals,
                "corrupt_evictions": self.corrupt_evictions,
                "applied_rows": self.applied_rows,
                "delta_bytes": self.delta_bytes,
                "entries": len(self._entries),
                "bytes": self.bytes,
                "budget_bytes": self.budget_bytes,
                "hit_rate": round(self.hits / total, 4) if total else 0.0,
            }


# -- the process-wide store ----------------------------------------------------
# One store per process (the host cache's rule): engines rebuilt by a
# recovery, and several engines in one process, hit the same verified
# entries. The pressure latch keeps a brownout shrink from being undone by
# the next engine's construction.

_PROCESS_STORE: AdapterStore | None = None
_PROCESS_ROOT: str | None = None
_PROCESS_BUDGET_EXPLICIT = False
_PRESSURE_CAP: int | None = None
_PRESSURE_INTENDED: int | None = None
_PROCESS_LOCK = threading.Lock()


def _auto_budget_bytes() -> int:
    avail = available_host_bytes()
    return int(avail * ADAPTER_AUTO_FRACTION) if avail else _AUTO_FALLBACK_BYTES


def store_for(cfg) -> AdapterStore | None:
    """The process store of ``cfg.adapters``, or None when adapters are off
    (no directory, or a budget of 0). Auto only grows an auto-sized store;
    an explicit budget wins exactly and pins; a live pressure cap bounds
    every resolution and records the intended budget for its release. A
    different registry root rebuilds the store."""
    root = cfg.adapters.dir
    if not root:
        return None
    budget = cfg.effective_adapter_bytes()
    if budget <= 0:
        return None
    explicit = cfg.adapters.max_gb is not None
    global _PROCESS_STORE, _PROCESS_ROOT, _PROCESS_BUDGET_EXPLICIT, _PRESSURE_INTENDED
    with _PROCESS_LOCK:
        cap = _PRESSURE_CAP
        if _PROCESS_STORE is not None and _PROCESS_ROOT != root:
            _PROCESS_STORE.clear()
            _PROCESS_STORE = None
        if _PROCESS_STORE is None:
            if cap is not None:
                _PRESSURE_INTENDED = budget
                budget = min(budget, max(cap, 1))
            _PROCESS_STORE = AdapterStore(root, budget)
            _PROCESS_ROOT = root
            _PROCESS_BUDGET_EXPLICIT = explicit
            REGISTRY.register("adapter", _PROCESS_STORE.stats)
        elif explicit:
            if cap is not None:
                _PRESSURE_INTENDED = budget
                budget = min(budget, max(cap, 1))
            if _PROCESS_STORE.budget_bytes != budget:
                _PROCESS_STORE.set_budget(budget)
            _PROCESS_BUDGET_EXPLICIT = True
        elif not _PROCESS_BUDGET_EXPLICIT:
            base = (_PRESSURE_INTENDED if cap is not None and _PRESSURE_INTENDED is not None
                    else _PROCESS_STORE.budget_bytes)
            if budget > base:
                if cap is not None:
                    _PRESSURE_INTENDED = budget
                    budget = min(budget, max(cap, 1))
                if budget > _PROCESS_STORE.budget_bytes:
                    _PROCESS_STORE.set_budget(budget)
        return _PROCESS_STORE


def process_store() -> AdapterStore | None:
    """The live process store, if any."""
    with _PROCESS_LOCK:
        return _PROCESS_STORE


def apply_pressure_cap(shrink_frac: float) -> int | None:
    """The ``adapter_evict`` lever: shrink the live store to ``shrink_frac``
    of its budget (least recently used first, reversible) and latch the cap
    so later ``store_for`` resolutions cannot grow past it. Returns the
    budget before the shrink, or None when no store is live."""
    global _PRESSURE_CAP, _PRESSURE_INTENDED
    with _PROCESS_LOCK:
        store = _PROCESS_STORE
        if store is None:
            return None
        prev = store.budget_bytes
        _PRESSURE_CAP = max(int(prev * shrink_frac), 1)
        _PRESSURE_INTENDED = prev
        cap = _PRESSURE_CAP
    store.set_budget(cap)  # the evictions run off the process lock
    return prev


def lift_pressure_cap(restore_bytes: int | None = None) -> None:
    """Reverse :func:`apply_pressure_cap`: drop the latch and install the
    intended budget (``restore_bytes`` only when none was recorded)."""
    global _PRESSURE_CAP, _PRESSURE_INTENDED
    with _PROCESS_LOCK:
        _PRESSURE_CAP = None
        intended, _PRESSURE_INTENDED = _PRESSURE_INTENDED, None
        store = _PROCESS_STORE
    target = intended if intended is not None else restore_bytes
    if store is not None and target and target != store.budget_bytes:
        store.set_budget(target)


def pressure_cap() -> int | None:
    """The live brownout cap, if any."""
    with _PROCESS_LOCK:
        return _PRESSURE_CAP


def reset_process_store() -> None:
    """Drop the process store and the pressure latch (tests)."""
    global _PROCESS_STORE, _PROCESS_ROOT, _PROCESS_BUDGET_EXPLICIT, _PRESSURE_CAP
    global _PRESSURE_INTENDED
    with _PROCESS_LOCK:
        if _PROCESS_STORE is not None:
            _PROCESS_STORE.clear()
        _PROCESS_STORE = None
        _PROCESS_ROOT = None
        _PROCESS_BUDGET_EXPLICIT = False
        _PRESSURE_CAP = None
        _PRESSURE_INTENDED = None
    REGISTRY.unregister("adapter")


__all__ = [
    "ADAPTER_AUTO_FRACTION",
    "AdapterStore",
    "apply_pressure_cap",
    "lift_pressure_cap",
    "pressure_cap",
    "process_store",
    "reset_process_store",
    "store_for",
]
