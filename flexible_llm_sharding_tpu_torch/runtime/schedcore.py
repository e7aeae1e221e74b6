"""The decode scheduling policy (the JAX package's ``runtime/schedcore.py``,
the part the offline decoder uses).

- **gen_slots**: how many generated-KV slots a block's cache carves. Plain
  decode fills one slot per step and never writes the last step's
  (``budget - 1``, at least 1); a speculative pass writes K+1 slots at
  per-suffix offsets up to budget-1, so its high-water slot is
  ``budget + spec_k``.
- **kv_on_device**: KV follows the weights. ``storage_location='gpu'``
  always keeps it on the card (the JAX package's ``'tpu'``); otherwise it
  stays there only when the model is resident and weights plus every
  block's KV fit the card's memory at this slot count. Speculative decode
  judges again at its larger slot count.

The serving methods (``admission_quota``, ``replay_deadline``,
``spill_policy``) come with the serving slice.
"""

from __future__ import annotations


class SchedCore:
    """Stateless decode policy over a ``FrameworkConfig`` (or None)."""

    def __init__(self, cfg=None):
        self.cfg = cfg

    def gen_slots(self, budget: int, spec_k: int = 0, speculative: bool = False) -> int:
        """Generated-KV slots for a token budget (offline: n_gen)."""
        if speculative:
            return budget + spec_k
        return max(1, budget - 1)

    def kv_on_device(self, model_cfg, dtype, toks, blocks, gen_slots, resident, device=None,
                     n_chips=1) -> bool:
        """Whether the decode KV stays on the card (see the module doc)."""
        cfg = self.cfg
        if cfg is not None and cfg.storage_location == "gpu":
            return True
        if not resident:
            return False
        from flexible_llm_sharding_tpu_torch.runtime.decode import kv_fits_on_chip

        dt = cfg.dtype if cfg is not None else dtype
        return kv_fits_on_chip(model_cfg, dt, toks, blocks, gen_slots, device=device,
                               n_chips=n_chips)


__all__ = ["SchedCore"]
