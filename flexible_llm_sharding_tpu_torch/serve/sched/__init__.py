"""The serving engine's SLO classes (``classes``). The JAX package's sweep
scheduler and prefix coalescing (``scheduler``, ``coalesce``) are not
ported yet."""

from flexible_llm_sharding_tpu_torch.serve.sched.classes import (  # noqa: F401
    BEST_EFFORT,
    CLASS_RANK,
    INTERACTIVE,
    SLO_CLASSES,
    STANDARD,
    UnknownSLOClass,
    parse_class,
)
