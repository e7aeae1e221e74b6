"""SLO classes (the JAX package's ``serve/sched/classes.py``).

Three classes in strict priority order: ``interactive`` (a person waits on
it), ``standard`` (the default) and ``best_effort`` (batch traffic). A
request carries its class in ``Request.slo_class``, validated at submit by
:func:`parse_class`; ``utils.metrics.SLO_CLASS_NAMES`` mirrors the tuple for
the per-class latency windows. The scheduler that acts on the classes is
not ported yet (``--sched`` raises), so they label requests and their
latency windows only.
"""

from __future__ import annotations

INTERACTIVE = "interactive"
STANDARD = "standard"
BEST_EFFORT = "best_effort"

# Strict priority order: lower rank admits first.
SLO_CLASSES = (INTERACTIVE, STANDARD, BEST_EFFORT)
CLASS_RANK = {c: i for i, c in enumerate(SLO_CLASSES)}


class UnknownSLOClass(ValueError):
    """The request named an SLO class outside the taxonomy; raised at
    submit, never served at some default priority."""


def parse_class(name: str | None) -> str:
    """Validate an SLO class name (None -> ``standard``)."""
    if name is None:
        return STANDARD
    if name not in CLASS_RANK:
        raise UnknownSLOClass(f"unknown slo_class {name!r} (one of {', '.join(SLO_CLASSES)})")
    return name


__all__ = [
    "BEST_EFFORT",
    "CLASS_RANK",
    "INTERACTIVE",
    "SLO_CLASSES",
    "STANDARD",
    "UnknownSLOClass",
    "parse_class",
]
