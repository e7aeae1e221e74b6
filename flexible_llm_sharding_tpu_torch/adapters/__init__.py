"""Multi-tenant LoRA serving of the PyTorch/CUDA port (the JAX package's
``adapters/``): many fine-tuned variants over one base-model sweep.

Requests carry an ``adapter_id``; a wave groups its rows by adapter and the
decoder loops apply ``h += (h @ A_g) @ B_g * scale_g`` at each layer's
entry, so several tenants decode in one sweep over one base-weight stream.

- ``registry`` — named adapters on disk (per-layer safetensors deltas, a
  plan and an integrity manifest) and the PEFT converter behind the
  ``prepare-adapter`` subcommand.
- ``apply``    — the grouped shift and the wave's grouping and stacking.
- ``loader``   — the verified, byte-budgeted host LRU of adapter factors.
"""

from flexible_llm_sharding_tpu_torch.adapters.registry import (
    ADAPTER_PLAN_NAME,
    AdapterCorruptError,
    AdapterNotFound,
    AdapterPlan,
    AdapterRegistry,
    convert_peft_checkpoint,
    save_adapter,
)

__all__ = [
    "ADAPTER_PLAN_NAME",
    "AdapterCorruptError",
    "AdapterNotFound",
    "AdapterPlan",
    "AdapterRegistry",
    "convert_peft_checkpoint",
    "save_adapter",
]
