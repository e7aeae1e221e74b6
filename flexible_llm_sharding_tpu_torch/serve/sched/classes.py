"""SLO classes and the class-based rejections (the JAX package's
``serve/sched/classes.py``).

Three classes in strict priority order: ``interactive`` (a person waits on
it), ``standard`` (the default) and ``best_effort`` (batch traffic). A
request carries its class in ``Request.slo_class``, validated at submit by
:func:`parse_class`; ``utils.metrics.SLO_CLASS_NAMES`` mirrors the tuple for
the per-class latency windows. The scheduler (``scheduler.py``) admits by
class, fair-queues tenants within one, and preempts best-effort waves for
waiting interactive work.
"""

from __future__ import annotations

from flexible_llm_sharding_tpu_torch.serve.request import QueueFull

INTERACTIVE = "interactive"
STANDARD = "standard"
BEST_EFFORT = "best_effort"

# Strict priority order: lower rank admits first.
SLO_CLASSES = (INTERACTIVE, STANDARD, BEST_EFFORT)
CLASS_RANK = {c: i for i, c in enumerate(SLO_CLASSES)}


class UnknownSLOClass(ValueError):
    """The request named an SLO class outside the taxonomy; raised at
    submit, never served at some default priority."""


class RateLimited(QueueFull):
    """A tenant's token bucket was empty at submit
    (``SchedConfig.tenant_limits``): a ``QueueFull``, so every backpressure
    handler applies, carrying ``retry_after_s`` (when the bucket next holds
    a whole token) and ``tenant``."""

    def __init__(self, message: str, retry_after_s: float | None = None,
                 tenant: str | None = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.tenant = tenant


def parse_class(name: str | None) -> str:
    """Validate an SLO class name (None -> ``standard``)."""
    if name is None:
        return STANDARD
    if name not in CLASS_RANK:
        raise UnknownSLOClass(f"unknown slo_class {name!r} (one of {', '.join(SLO_CLASSES)})")
    return name


def class_deadline_s(sched_cfg, slo_class: str) -> float | None:
    """The class's default admission deadline in seconds, or None when the
    scheduler is off or the class sets none (the serve-level default then
    applies)."""
    if sched_cfg is None or not sched_cfg.enabled:
        return None
    v = {
        INTERACTIVE: sched_cfg.interactive_deadline_s,
        STANDARD: sched_cfg.standard_deadline_s,
        BEST_EFFORT: sched_cfg.best_effort_deadline_s,
    }.get(slo_class, 0.0)
    return v if v > 0 else None


__all__ = [
    "BEST_EFFORT",
    "CLASS_RANK",
    "INTERACTIVE",
    "SLO_CLASSES",
    "STANDARD",
    "RateLimited",
    "UnknownSLOClass",
    "class_deadline_s",
    "parse_class",
]
