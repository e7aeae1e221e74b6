"""``flscheck`` — project-invariant static analysis, the port's own copy.

The rules, messages and fingerprints are those of the JAX package's
analyzer, so that the two report the same findings on the same tree; this
copy defaults to the port package as its root and to the port's own
baseline, ``flscheck-torch-baseline.json``.

The streaming architecture lives on a handful of concurrency and
configuration invariants (one producer thread feeding consumers through
process-wide caches and tiers; knobs threaded through two CLI parsers;
fault sites registered in ``config.FAULT_SITES``; counters exported to
stats). The last several PRs each burned review rounds on the *same*
recurring defect classes — this package machine-checks them per PR.

Entry points:

- ``python -m flexible_llm_sharding_tpu_torch.cli check`` (the tier-1 gate)
- ``python -m flexible_llm_sharding_tpu_torch.analysis``
- ``scripts/torch_flscheck.py``

See ``docs/analysis.md`` for the rule catalog, the pragma and baseline
workflow, and how to add a rule.
"""

from flexible_llm_sharding_tpu_torch.analysis.core import (
    Finding,
    analyze_source,
    main,
    run,
)

__all__ = ["Finding", "analyze_source", "main", "run"]
