"""Host-resident shard cache (the JAX package's ``runtime/hostcache.py``).

The stream re-reads the whole model every pass: each step of the
generation loop and each decode step. This cache keeps the host trees the
loader built — page-locked CPU tensors on a CUDA run, ready to upload — keyed
by shard, so a warm pass skips the disk read, the parse and the crc and goes
straight to the upload. Entries are the load's own buffers (no second copy),
charged at their full size; an evicted entry's buffers go back to PyTorch's
page-locked pool when the last reference drops.

A quantized checkpoint's entries are its packed trees (int8 or uint8
payloads with their float32 scales), charged at those bytes, as the JAX
cache charges them; the tied head over a quantized embedding is its int8
requantization.

Entries are put only after the load's integrity check passed; each records
its backing files' ``(mtime_ns, size)``, taken before the read, and a hit
re-stats them, so a rewritten or rotted file drops the entry. The loader
calls :meth:`HostShardCache.invalidate_path` when it quarantines a file.

Budget: ``FrameworkConfig.host_cache_gb``, an explicit number of GB, 0 for
off, or None for auto: ``AUTO_FRACTION`` of the host's available RAM (off
while fault injection is on). The brownout ladder's ``cache_shrink`` rung
(``runtime/pressure.py``) shrinks the live cache with
:func:`apply_pressure_cap` and latches the cap, so no later ``cache_for``
grows it back while the brownout holds; :func:`lift_pressure_cap` restores
the budget the process would run at without the cap. The JAX module's trace
instants and metrics registration wait for ROADMAP item 7.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Sequence

import torch

from flexible_llm_sharding_tpu_torch.integrity.manifest import _file_key as _stat_key

AUTO_FRACTION = 0.25


def available_host_bytes() -> int:
    """MemAvailable from /proc/meminfo (bytes); 0 when unknown."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return 0


def auto_budget_bytes(fraction: float = AUTO_FRACTION) -> int:
    return int(available_host_bytes() * fraction)


def tree_nbytes(tree) -> int:
    """Bytes of every tensor in a nested dict/list/tuple."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return int(getattr(tree, "nbytes", 0))


def stat_guard(paths: Sequence[str]) -> tuple | None:
    """((path, (mtime_ns, size)), ...) for ``paths`` (deduplicated, order
    kept), or None when one cannot be stat'ed. Taken before the files are
    read, so a file replaced during the read leaves the entry guarded by
    the old generation and the next get() drops it."""
    guard = []
    for p in dict.fromkeys(paths):
        st = _stat_key(p)
        if st is None:
            return None
        guard.append((p, st))
    return tuple(guard)


class HostShardCache:
    """Byte-budgeted, thread-safe LRU of host shard trees. Values are shared
    across passes and sources: callers treat them as immutable."""

    def __init__(self, budget_bytes: int):
        if budget_bytes <= 0:
            raise ValueError("budget_bytes must be > 0 (use None cache to disable)")
        self._lock = threading.RLock()
        self.budget_bytes = int(budget_bytes)
        # key -> (value, nbytes, ((path, (mtime_ns, size)), ...))
        self._entries: OrderedDict[Any, tuple[Any, int, tuple]] = OrderedDict()
        self._by_path: dict[str, set] = {}
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    def get(self, key) -> tuple[Any, int] | None:
        """(value, nbytes) of a current entry, else None (a miss). The
        backing files are stat'ed outside the lock."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
        value, nbytes, guard = entry
        stale = any(_stat_key(path) != stat for path, stat in guard)
        with self._lock:
            cur = self._entries.get(key)
            if cur is None or cur is not entry:
                self.misses += 1
                return None
            if stale:
                self._drop(key)
                self.invalidations += 1
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
        return value, nbytes

    def put(self, key, value, paths: Sequence[str] = (), nbytes: int | None = None,
            guard: tuple | None = None) -> bool:
        """Insert one entry guarded by ``guard`` (from :func:`stat_guard`,
        taken before the read; bare ``paths`` are stat'ed now). False when a
        path cannot be stat'ed or the entry alone exceeds the budget."""
        if guard is None:
            guard = stat_guard(paths)
            if guard is None:
                return False
        if nbytes is None:
            nbytes = tree_nbytes(value)
        if nbytes > self.budget_bytes:
            return False
        with self._lock:
            if key in self._entries:
                self._drop(key)
            while self.bytes + nbytes > self.budget_bytes and self._entries:
                self._drop(next(iter(self._entries)))
                self.evictions += 1
            self._entries[key] = (value, int(nbytes), tuple(guard))
            self.bytes += int(nbytes)
            for p, _ in guard:
                self._by_path.setdefault(p, set()).add(key)
            return True

    def _drop(self, key) -> None:
        # Callers hold the lock.
        _, nbytes, guard = self._entries.pop(key)
        self.bytes -= nbytes
        for p, _ in guard:
            keys = self._by_path.get(p)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._by_path[p]

    def invalidate_path(self, path: str) -> int:
        """Drop every entry built from ``path``; returns how many."""
        with self._lock:
            keys = list(self._by_path.get(path, ()))
            for k in keys:
                self._drop(k)
            self.invalidations += len(keys)
            return len(keys)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._by_path.clear()
            self.bytes = 0

    def set_budget(self, budget_bytes: int) -> None:
        """Resize; a shrink evicts least recently used entries first."""
        with self._lock:
            self.budget_bytes = max(int(budget_bytes), 0)
            while self.bytes > self.budget_bytes and self._entries:
                self._drop(next(iter(self._entries)))
                self.evictions += 1

    def stats(self) -> dict[str, float]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "entries": len(self._entries),
                "bytes": self.bytes,
                "budget_bytes": self.budget_bytes,
                "hit_rate": round(self.hits / total, 4) if total else 0.0,
            }


# One cache per process: the port builds a weight source per executor call,
# so the generation loop's passes and the decode steps meet here.
_PROCESS_CACHE: HostShardCache | None = None
_PROCESS_BUDGET_EXPLICIT = False
# The brownout cap: while set, no budget resolution may exceed it.
# _PRESSURE_INTENDED is the budget the process would run at without the cap
# (every resolution that lands mid-brownout moves it by the usual
# precedence), which the lift installs.
_PRESSURE_CAP: int | None = None
_PRESSURE_INTENDED: int | None = None
_PROCESS_LOCK = threading.Lock()


def cache_for(cfg) -> HostShardCache | None:
    """The process cache sized by ``cfg.effective_host_cache_bytes()``, or
    None when that is 0. An auto budget only ever grows an auto-sized cache
    (the cache's own entries lower MemAvailable); an explicit budget wins
    exactly (a shrink evicts) and pins the cap against later auto configs.
    A live brownout cap bounds every resolution; the budget it holds back
    is remembered for :func:`lift_pressure_cap`."""
    budget = cfg.effective_host_cache_bytes()
    if budget <= 0:
        return None
    explicit = cfg.host_cache_gb is not None
    global _PROCESS_CACHE, _PROCESS_BUDGET_EXPLICIT, _PRESSURE_INTENDED
    with _PROCESS_LOCK:
        cap = _PRESSURE_CAP
        if _PROCESS_CACHE is None:
            if cap is not None:
                _PRESSURE_INTENDED = budget
                budget = min(budget, max(cap, 1))
            _PROCESS_CACHE = HostShardCache(budget)
            _PROCESS_BUDGET_EXPLICIT = explicit
        elif explicit:
            if cap is not None:
                _PRESSURE_INTENDED = budget
                budget = min(budget, max(cap, 1))
            if _PROCESS_CACHE.budget_bytes != budget:
                _PROCESS_CACHE.set_budget(budget)
            _PROCESS_BUDGET_EXPLICIT = True
        elif not _PROCESS_BUDGET_EXPLICIT:
            base = (_PRESSURE_INTENDED if cap is not None and _PRESSURE_INTENDED is not None
                    else _PROCESS_CACHE.budget_bytes)
            if budget > base:
                if cap is not None:
                    _PRESSURE_INTENDED = budget
                    budget = min(budget, max(cap, 1))
                if budget > _PROCESS_CACHE.budget_bytes:
                    _PROCESS_CACHE.set_budget(budget)
        return _PROCESS_CACHE


def process_cache() -> HostShardCache | None:
    """The live process cache, if any."""
    with _PROCESS_LOCK:
        return _PROCESS_CACHE


def apply_pressure_cap(shrink_frac: float) -> int | None:
    """The ladder's ``cache_shrink`` rung: shrink the live cache to
    ``shrink_frac`` of its budget (least recently used entries go first;
    the others keep serving hits) and latch that cap. Returns the budget
    before the shrink, or None when no cache is live."""
    global _PRESSURE_CAP, _PRESSURE_INTENDED
    with _PROCESS_LOCK:
        cache = _PROCESS_CACHE
        if cache is None:
            return None
        prev = cache.budget_bytes
        _PRESSURE_CAP = max(int(prev * shrink_frac), 1)
        _PRESSURE_INTENDED = prev
        cap = _PRESSURE_CAP
    cache.set_budget(cap)  # the evictions run off the process lock
    return prev


def lift_pressure_cap(restore_bytes: int | None = None) -> None:
    """Undo :func:`apply_pressure_cap`: drop the latch and install the
    intended budget (so an explicit budget given mid-brownout holds);
    ``restore_bytes`` is the fallback when none is recorded."""
    global _PRESSURE_CAP, _PRESSURE_INTENDED
    with _PROCESS_LOCK:
        _PRESSURE_CAP = None
        intended, _PRESSURE_INTENDED = _PRESSURE_INTENDED, None
        cache = _PROCESS_CACHE
    target = intended if intended is not None else restore_bytes
    if cache is not None and target and target != cache.budget_bytes:
        cache.set_budget(target)


def pressure_cap() -> int | None:
    """The live brownout cap, if any."""
    with _PROCESS_LOCK:
        return _PRESSURE_CAP


def reset_process_cache() -> None:
    """Drop the process cache and the brownout latch (tests; one process
    serving several models)."""
    global _PROCESS_CACHE, _PROCESS_BUDGET_EXPLICIT, _PRESSURE_CAP, _PRESSURE_INTENDED
    with _PROCESS_LOCK:
        if _PROCESS_CACHE is not None:
            _PROCESS_CACHE.clear()
        _PROCESS_CACHE = None
        _PROCESS_BUDGET_EXPLICIT = False
        _PRESSURE_CAP = None
        _PRESSURE_INTENDED = None


__all__ = [
    "AUTO_FRACTION",
    "HostShardCache",
    "apply_pressure_cap",
    "auto_budget_bytes",
    "available_host_bytes",
    "cache_for",
    "lift_pressure_cap",
    "pressure_cap",
    "process_cache",
    "reset_process_cache",
    "stat_guard",
    "tree_nbytes",
]
