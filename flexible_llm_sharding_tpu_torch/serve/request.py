"""Requests of the serving engine and their typed outcomes (the JAX
package's ``serve/request.py``, single engine).

A request is one (prefix, suffixes) prompt, the shape of the batch CLI's
pickle entries, with a token budget and an optional admission deadline. Its
status moves QUEUED -> ACTIVE -> DONE, or to one of the terminal rejection,
expiry, failure and cancellation states; the queue, the batcher and the
engine each make the transitions they own. Every terminal transition is
first-wins (``ServeFuture.claim``) and fires the request's callback once:
when the replica fleet reclaims a request from an engine it declared dead,
the engine thread's later resolution loses the claim, so a re-dispatched
request is never served twice.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import threading
import time
from typing import Any, Callable

import numpy as np

Prompt = tuple[str, tuple[str, ...]]

_REQUEST_IDS = itertools.count()


class RequestStatus(enum.Enum):
    QUEUED = "queued"      # accepted by the admission queue, waiting
    ACTIVE = "active"      # admitted into a wave (prefill or decode)
    DONE = "done"          # all tokens emitted; result resolved
    REJECTED = "rejected"  # backpressure: queue full at submit time
    EXPIRED = "expired"    # deadline passed before admission
    FAILED = "failed"      # engine error while the request was in flight
    CANCELLED = "cancelled"  # shutdown without drain while still queued

    @property
    def terminal(self) -> bool:
        return self not in (RequestStatus.QUEUED, RequestStatus.ACTIVE)


class QueueFull(RuntimeError):
    """Backpressure: the admission queue was at capacity. The message names
    the capacity and the depth."""


class RequestTooLarge(RuntimeError):
    """The request's estimated prompt tokens plus its budget exceed
    ``ServeConfig.max_request_tokens``; raised at submit, before the request
    can join a wave and fail it at allocation."""


class DeadlineExceeded(RuntimeError):
    """The request's admission deadline passed while it was queued."""


class ServeClosed(RuntimeError):
    """Submit after shutdown, or a queued request cancelled by a shutdown
    without drain."""


class RestartPending(ServeClosed):
    """A graceful restart parked the request: its state is in the request
    WAL (``serve/wal.py``), which writes no terminal record for this error,
    so the next start's replay (``serve/recovery.py``) serves it to a
    token-identical completion."""


class WaveAborted(RuntimeError):
    """The request's wave was aborted by a recoverable engine fault (a
    shard load that failed for good, a stalled sweep the watchdog aborted):
    only the waves in flight fail, ``__cause__`` holds the fault, and the
    engine restarts its weight source and keeps serving. Resubmit."""


@dataclasses.dataclass
class RequestResult:
    """A served completion: the batch CLI's per-prompt contract
    (``scores`` float32 [n_suffixes, n_tokens, vocab]; ``updated`` the prompt
    with the generated text appended to each suffix; ``tokens`` the emitted
    ids [n_suffixes, n_tokens]) plus its timings."""

    request_id: int
    scores: np.ndarray
    updated: Prompt
    tokens: np.ndarray
    ttft_s: float       # submit -> first token
    latency_s: float    # submit -> completion
    queue_wait_s: float  # submit -> admission


class ServeFuture:
    """The future the engine resolves per request. ``result(timeout)``
    returns the :class:`RequestResult` or raises the request's terminal
    error. ``claim()`` hands exactly one resolver the right to finish it."""

    def __init__(self) -> None:
        self._event = threading.Event()
        self._claim_lock = threading.Lock()
        self._claimed = False  # guarded by: _claim_lock
        self._result: RequestResult | None = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def claim(self) -> bool:
        """First-wins terminal claim: True for exactly one caller, who must
        then call ``finish_result`` or ``finish_error``."""
        with self._claim_lock:
            if self._claimed:
                return False
            self._claimed = True
            return True

    def finish_result(self, result: RequestResult) -> None:
        self._result = result
        self._event.set()

    def finish_error(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def result(self, timeout: float | None = None) -> RequestResult:
        if not self._event.wait(timeout):
            raise TimeoutError("request not finished")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result

    def exception(self, timeout: float | None = None) -> BaseException | None:
        if not self._event.wait(timeout):
            raise TimeoutError("request not finished")
        return self._error


@dataclasses.dataclass
class Request:
    """One request plus its serving state.

    ``deadline``: absolute monotonic instant by which it must be admitted
    (None = none). ``slo_class``/``tenant_id``: the scheduler's labels,
    validated at submit. ``adapter_id``: the LoRA adapter the request
    decodes under (None = the base model), part of the coalescing key and
    the pool's salt. ``client_id``: the caller's own id, echoed in the
    JSONL replies and kept in the WAL, the one identity that survives a
    restart. ``wal_id``: the WAL's key for the request (None without a
    WAL), kept across a replay. ``dispatch_id``: the replica fleet's id of
    the caller's request that this engine-side attempt serves, the same on
    every attempt (None outside a fleet). ``shed_exempt``: a fleet
    re-dispatch, work the fleet accepted once, which skips the tenant rate
    limit. ``on_terminal``: the WAL's hook, fired once
    after the callback on the terminal transition. ``tokens_emitted``: tokens served per suffix so far
    (``resume_len`` included; on a speculative wave the slowest suffix's).
    ``resume_scores``/``resume_tokens``: per step served before a
    sweep-boundary preemption, the [n_suffixes, vocab] scores and
    [n_suffixes] token ids; the engine folds the tokens into the suffix ids
    on re-admission and stitches both in front of the later steps."""

    prefix: str
    suffixes: tuple[str, ...]
    max_new_tokens: int
    deadline: float | None = None
    callback: Callable[["Request"], Any] | None = None
    slo_class: str = "standard"
    tenant_id: str = "default"
    adapter_id: str | None = None
    client_id: Any = None
    wal_id: str | None = None
    dispatch_id: int | None = None
    shed_exempt: bool = False
    on_terminal: Callable[["Request", BaseException | None], Any] | None = dataclasses.field(
        default=None, repr=False)
    resume_scores: list = dataclasses.field(default_factory=list, repr=False)
    resume_tokens: list = dataclasses.field(default_factory=list, repr=False)
    request_id: int = dataclasses.field(default_factory=lambda: next(_REQUEST_IDS))
    status: RequestStatus = RequestStatus.QUEUED
    arrival: float = dataclasses.field(default_factory=time.monotonic)
    admitted_at: float | None = None
    first_token_at: float | None = None
    finished_at: float | None = None
    tokens_emitted: int = 0
    future: ServeFuture = dataclasses.field(default_factory=ServeFuture)

    @property
    def resume_len(self) -> int:
        """Tokens per suffix served before preemptions."""
        return len(self.resume_tokens)

    def expired(self, now: float | None = None) -> bool:
        return self.deadline is not None and (
            now if now is not None else time.monotonic()
        ) >= self.deadline

    # Status and finished_at are set before the future resolves (a woken
    # waiter never sees a stale status); the callback fires next and the
    # WAL's terminal hook last, so a crash between the two leaves the WAL
    # entry open and the replay emits the same output again (clients merge
    # by client_id).

    def _fire_callback(self) -> None:
        if self.callback is not None:
            try:
                self.callback(self)
            except Exception:  # a callback's bug must not take down the serving loop
                pass

    def _fire_terminal_hook(self, error: BaseException | None) -> None:
        if self.on_terminal is not None:
            try:
                self.on_terminal(self, error)
            except Exception:  # the WAL counts its own write errors
                pass

    def resolve(self, scores: np.ndarray, updated: Prompt, tokens: np.ndarray) -> bool:
        """Terminal DONE transition. Returns whether this call won the
        claim; callers gate their counters on it."""
        if not self.future.claim():
            return False
        now = time.monotonic()
        result = RequestResult(
            request_id=self.request_id,
            scores=scores,
            updated=updated,
            tokens=tokens,
            ttft_s=(self.first_token_at or now) - self.arrival,
            latency_s=now - self.arrival,
            queue_wait_s=(self.admitted_at or self.arrival) - self.arrival,
        )
        self.status = RequestStatus.DONE
        self.finished_at = now
        self.future.finish_result(result)
        self._fire_callback()
        self._fire_terminal_hook(None)
        return True

    def fail(self, error: BaseException, status: RequestStatus) -> bool:
        """Terminal failure transition; the claim contract of ``resolve``."""
        if not self.future.claim():
            return False
        self.status = status
        self.finished_at = time.monotonic()
        self.future.finish_error(error)
        self._fire_callback()
        self._fire_terminal_hook(error)
        return True


__all__ = [
    "DeadlineExceeded",
    "Prompt",
    "QueueFull",
    "Request",
    "RequestResult",
    "RequestStatus",
    "RequestTooLarge",
    "RestartPending",
    "ServeClosed",
    "ServeFuture",
    "WaveAborted",
]
