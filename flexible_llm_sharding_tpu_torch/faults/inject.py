"""Deterministic, seeded fault injection (the JAX package's
``faults/inject.py``).

A ``FaultInjector`` is handed explicitly to the code that fires its sites;
``fire(site)`` draws the site's next outcome. The sites are the JAX
package's (``config.FAULT_SITES``, which names where each fires): the I/O
sites, the silent-corruption sites (``corrupt_flat`` and ``corrupt_array``:
a deterministic one-bit flip of a tensor's or an array's bytes), the
replica fleet's two sites and the resource-pressure sites (``host_oom``
raises ``MemoryError``, ``disk_full`` ``OSError(ENOSPC)``, and
``link_throttle`` only stalls).

The schedule is a pure function of ``(seed, site, per-site call count)``
through SHA-256 (``faults/retry.hash_unit``), the JAX package's draw bit
for bit: a chaos run replays the same faults on every run and in either
package, and two sites never take each other's draws. Disabled injection
costs the caller one ``is None`` check (``from_config`` returns None).
"""

from __future__ import annotations

import errno
import threading
import time

import numpy as np
import torch

from flexible_llm_sharding_tpu_torch.config import FAULT_SITES, FaultConfig
from flexible_llm_sharding_tpu_torch.faults.retry import hash_unit


# Faults injected in this process, per site, over every injector (a run's
# executors and sources each hold their own): the CLIs' ``chaos_faults``.
_PROCESS_LOCK = threading.Lock()
_PROCESS_FAULTS: dict[str, int] = {}


def process_fault_counts() -> dict[str, int]:
    """Faults injected per site since the last reset, every site listed."""
    with _PROCESS_LOCK:
        return {s: _PROCESS_FAULTS.get(s, 0) for s in FAULT_SITES}


def reset_process_fault_counts() -> None:
    with _PROCESS_LOCK:
        _PROCESS_FAULTS.clear()


class InjectedFault(IOError):
    """A fault raised by the injector (an ``IOError``, as the transient I/O
    errors it stands in for)."""


class TruncatedRead(InjectedFault):
    """A simulated short read."""


class FaultInjector:
    """Seeded fault schedule over named sites. Every injected fault is
    appended to ``events`` as ``(site, kind, n)``; ``max_faults >= 0`` caps
    the total, after which every fire is clean. Each site's schedule is
    deterministic; a shared budget contended by sites on different threads
    is spent in arrival order."""

    def __init__(self, config: FaultConfig):
        self.config = config
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}  # guarded by: _lock
        self._budget = config.max_faults if config.max_faults >= 0 else None  # guarded by: _lock
        self.events: list[tuple[str, str, int]] = []  # guarded by: _lock

    @classmethod
    def from_config(cls, config: FaultConfig | None) -> "FaultInjector | None":
        """None when injection is off: the caller skips the fire entirely."""
        if config is None or not config.enabled:
            return None
        return cls(config)

    def count(self, site: str | None = None) -> int:
        """Injected faults, for one site or in total."""
        with self._lock:
            if site is None:
                return len(self.events)
            return sum(1 for s, _, _ in self.events if s == site)

    def _draw(self, site: str, kinds: tuple[str, str, str]) -> tuple[str | None, int]:
        """One draw for ``site``: ``(kind, n)``, kind None when clean.
        ``kinds`` names the (error, truncated, latency) outcomes."""
        if site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {site!r} (one of {FAULT_SITES})")
        cfg = self.config
        if cfg.sites and site not in cfg.sites:
            return None, -1
        # One critical section from the count to the budget: a racing fire
        # must not take the budget unit this draw committed to.
        with self._lock:
            n = self._counts.get(site, 0)
            self._counts[site] = n + 1
            u = hash_unit(f"{cfg.seed}:{site}:{n}")
            if u < cfg.error_rate:
                kind = kinds[0]
            elif u < cfg.error_rate + cfg.truncate_rate:
                kind = kinds[1]
            elif u < cfg.error_rate + cfg.truncate_rate + cfg.latency_rate:
                kind = kinds[2]
            else:
                return None, n
            if self._budget is not None:
                if self._budget == 0:
                    return None, n
                self._budget -= 1
            self.events.append((site, kind, n))
        with _PROCESS_LOCK:
            _PROCESS_FAULTS[site] = _PROCESS_FAULTS.get(site, 0) + 1
        return kind, n

    def fire(self, site: str, detail: str = "") -> None:
        """Draw ``site``: raise its fault, sleep its latency, or return."""
        kind, n = self._draw(site, ("error", "truncated", "latency"))
        if kind is None:
            return
        at = f"{site} #{n}" + (f" ({detail})" if detail else "")
        if site == "link_throttle":
            # A saturated link slows, it never errors.
            time.sleep(self.config.latency_s)
            return
        if kind == "latency":
            time.sleep(self.config.latency_s)
        elif kind == "truncated":
            raise TruncatedRead(f"injected truncated read at {at}")
        elif site == "host_oom":
            raise MemoryError(f"injected host OOM at {at}")
        elif site == "disk_full":
            raise OSError(errno.ENOSPC, f"injected disk full at {at}")
        else:
            raise InjectedFault(f"injected I/O error at {at}")

    # -- silent corruption ----------------------------------------------------
    # The error slot of the draw becomes a one-bit flip, its position hashed
    # from the same (seed, site, count) key; a truncated draw still raises
    # and a latency draw sleeps.

    @staticmethod
    def _flip_bit(t, key: str):
        """A copy of ``t`` (a tensor, or a numpy array: a spill read's) with
        one bit flipped: byte ``hash(key:pos)`` of its contiguous bytes, bit
        ``hash(key:bit)``."""
        if isinstance(t, np.ndarray):
            a = np.ascontiguousarray(t)
            if a.nbytes == 0:
                return a
            buf = a.reshape(-1).view(np.uint8).copy()
            pos = int(hash_unit(key + ":pos") * buf.size)
            buf[pos] ^= np.uint8(1 << int(hash_unit(key + ":bit") * 8))
            return buf.view(a.dtype).reshape(a.shape)
        a = t.detach().contiguous()
        if a.numel() == 0:
            return a
        buf = a.reshape(-1).view(torch.uint8).clone()
        pos = int(hash_unit(key + ":pos") * buf.numel())
        buf[pos] ^= 1 << int(hash_unit(key + ":bit") * 8)
        return buf.view(a.dtype).reshape(a.shape)

    def corrupt_flat(self, site: str, flat: dict, detail: str = "") -> dict:
        """One draw for a whole layer file's flat tensor dict: on a
        'bitflip' draw a new dict whose one deterministically chosen tensor
        is a one-bit-flipped copy; 'truncated' raises ``TruncatedRead``;
        'latency' sleeps; clean returns ``flat`` itself."""
        kind, n = self._draw(site, ("bitflip", "truncated", "latency"))
        if kind is None or not flat:
            return flat
        at = f"{site} #{n}" + (f" ({detail})" if detail else "")
        if kind == "latency":
            time.sleep(self.config.latency_s)
            return flat
        if kind == "truncated":
            raise TruncatedRead(f"injected truncated read at {at}")
        keys = sorted(flat)
        key = keys[int(hash_unit(f"{self.config.seed}:{site}:key:{n}") * len(keys))]
        out = dict(flat)
        out[key] = self._flip_bit(flat[key], f"{self.config.seed}:{site}:{n}:{key}")
        return out

    def corrupt_array(self, site: str, t, detail: str = ""):
        """The single-tensor (or single-array) form of :meth:`corrupt_flat`."""
        kind, n = self._draw(site, ("bitflip", "truncated", "latency"))
        if kind is None:
            return t
        at = f"{site} #{n}" + (f" ({detail})" if detail else "")
        if kind == "latency":
            time.sleep(self.config.latency_s)
            return t
        if kind == "truncated":
            raise TruncatedRead(f"injected truncated read at {at}")
        return self._flip_bit(t, f"{self.config.seed}:{site}:{n}")


__all__ = ["FaultInjector", "InjectedFault", "TruncatedRead", "process_fault_counts",
           "reset_process_fault_counts"]
