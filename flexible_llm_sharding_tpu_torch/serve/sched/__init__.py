"""The sweep scheduler of the serving engine (the JAX package's
``serve/sched/``).

- ``classes``   — SLO classes (interactive, standard, best_effort), their
  default admission deadlines, and the class-based rejections
  (``RateLimited``, ``UnknownSLOClass``).
- ``scheduler`` — ``SweepScheduler``: strict priority across classes,
  deficit round robin over tenants within a class, per-tenant token-bucket
  rate limits, and the sweep-boundary preemption decision.
- ``coalesce``  — same-tokenized-prefix requests of one boundary merged
  into one wave entry, so their shared prefix KV prefills once.
"""

from flexible_llm_sharding_tpu_torch.serve.sched.classes import (  # noqa: F401
    BEST_EFFORT,
    CLASS_RANK,
    INTERACTIVE,
    SLO_CLASSES,
    STANDARD,
    RateLimited,
    UnknownSLOClass,
    class_deadline_s,
    parse_class,
)
from flexible_llm_sharding_tpu_torch.serve.sched.coalesce import build_entries  # noqa: F401
from flexible_llm_sharding_tpu_torch.serve.sched.scheduler import SweepScheduler  # noqa: F401

__all__ = [
    "BEST_EFFORT",
    "CLASS_RANK",
    "INTERACTIVE",
    "SLO_CLASSES",
    "STANDARD",
    "RateLimited",
    "SweepScheduler",
    "UnknownSLOClass",
    "build_entries",
    "class_deadline_s",
    "parse_class",
]
