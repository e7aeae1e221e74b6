"""Retry with exponential backoff for the weight stream's I/O (the JAX
package's ``faults/retry.py``).

``retry_call(fn, policy=...)`` re-invokes ``fn`` on the policy's retryable
exception types with exponentially growing, jittered sleeps, under an
attempt cap and an overall deadline. The jitter is deterministic — a hash
of (label, attempt) — so a run's retry schedule repeats. Exhaustion can be
typed: ``wrap=ShardLoadError`` raises that type, chained to the last
error. ``ShardLoadError`` is not an ``OSError``, so a nested
``retry_call`` never retries an exhausted inner one. The JAX module's trace
instants wait for the observability port (ROADMAP item 7).
"""

from __future__ import annotations

import dataclasses
import hashlib
import time


class ShardLoadError(RuntimeError):
    """A shard's load failed even after the retry policy was exhausted
    (``__cause__`` carries the last underlying error)."""


def hash_unit(key: str) -> float:
    """Deterministic uniform in [0, 1) from a key string."""
    digest = hashlib.sha256(key.encode()).digest()
    return int.from_bytes(digest[:8], "big") / 2**64


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Transient-I/O retry knobs (``FrameworkConfig.retry_policy()`` builds
    one from the ``io_retry_*`` fields). ``retryable`` is the transient
    family, ``OSError`` and ``TimeoutError``; everything else fails on its
    first attempt."""

    max_attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.25  # each delay scaled by 1 + jitter * U[0, 1)
    deadline_s: float | None = 60.0  # overall wall cap; None = attempts only
    retryable: tuple[type[BaseException], ...] = (OSError, TimeoutError)

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_delay_s < 0 or self.max_delay_s < 0 or self.jitter < 0:
            raise ValueError("delays and jitter must be >= 0")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be > 0 (or None)")

    def delay_for(self, attempt: int, label: str = "") -> float:
        """Backoff before attempt ``attempt + 1`` (attempts count from 1)."""
        delay = min(self.max_delay_s, self.base_delay_s * self.multiplier ** (attempt - 1))
        return delay * (1.0 + self.jitter * hash_unit(f"jitter:{label}:{attempt}"))


def retry_call(fn, *, policy: RetryPolicy | None = None, label: str = "", recorder=None,
               wrap: type[Exception] | None = None, abort=None):
    """Call ``fn()`` under ``policy`` and return its result.

    ``recorder`` (``utils.metrics.RetryRecorder`` or None) gets one
    ``retries`` tick per backoff sleep, one ``recovered`` when a retried
    call succeeds and one ``exhausted`` when it gives up, keyed by
    ``label``. On exhaustion the last error re-raises, wrapped in ``wrap``
    when given. ``abort`` (callable -> bool) is checked before every sleep
    and the sleep is chunked against it: an aborted call gives up at once,
    through the same path as exhaustion."""
    policy = policy or RetryPolicy()
    deadline = time.monotonic() + policy.deadline_s if policy.deadline_s is not None else None
    attempt = 1
    while True:
        try:
            out = fn()
        except policy.retryable as e:
            out_of_time = deadline is not None and time.monotonic() >= deadline
            aborted = abort is not None and abort()
            if attempt >= policy.max_attempts or out_of_time or aborted:
                if recorder is not None:
                    recorder.record(label, exhausted=1)
                why = ("aborted" if aborted else "deadline passed" if out_of_time
                       else "attempts exhausted")
                if wrap is not None:
                    raise wrap(
                        f"{label or 'call'}: giving up after {attempt} attempt(s) ({why}): {e!r}"
                    ) from e
                raise
            delay = policy.delay_for(attempt, label)
            if deadline is not None:
                delay = min(delay, max(0.0, deadline - time.monotonic()))
            if recorder is not None:
                recorder.record(label, retries=1, backoff_s=delay)
            end = time.monotonic() + delay
            while True:
                left = end - time.monotonic()
                if left <= 0 or (abort is not None and abort()):
                    break
                time.sleep(min(left, 0.2) if abort is not None else left)
            attempt += 1
        else:
            if attempt > 1 and recorder is not None:
                recorder.record(label, recovered=1)
            return out


__all__ = ["RetryPolicy", "ShardLoadError", "hash_unit", "retry_call"]
