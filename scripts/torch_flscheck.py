#!/usr/bin/env python3
"""Repo entry point for the port's flscheck static analyzer (same CLI as
``python -m flexible_llm_sharding_tpu_torch.cli check``).

    python scripts/torch_flscheck.py            # the port package, its baseline
    python scripts/torch_flscheck.py --json     # machine-readable report
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flexible_llm_sharding_tpu_torch.analysis.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
