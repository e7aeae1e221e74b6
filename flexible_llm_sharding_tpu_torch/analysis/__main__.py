"""``python -m flexible_llm_sharding_tpu_torch.analysis`` — the flscheck CLI."""

import sys

from flexible_llm_sharding_tpu_torch.analysis.core import main

if __name__ == "__main__":
    sys.exit(main())
