"""The scheduling policy shared by the offline decoder and the serving
engine (the JAX package's ``runtime/schedcore.py``).

- **admission_quota**: how many requests a shard-0 boundary may admit: the
  active-request cap less what is in flight.
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
- **replay_deadline**: a replayed request's admission deadline from its
  remaining seconds, counted from now (None stays None).
- **spill_policy**: whether cold prefix-KV pages spill to checksummed files
  (``kv_host_spill``) or drop and re-prefill.
"""

from __future__ import annotations

import time


class SchedCore:
    """Stateless decode policy over a ``FrameworkConfig`` (or None)."""

    def __init__(self, cfg=None):
        self.cfg = cfg

    def admission_quota(self, max_active: int, active: int) -> int:
        """Requests a shard-0 boundary may admit (never negative)."""
        return max(0, max_active - active)

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

    def replay_deadline(self, deadline_left_s, now=None):
        """A replayed request's absolute monotonic deadline: its recorded
        remaining seconds counted from ``now`` (default: the monotonic
        clock), so downtime is not charged; None (no deadline, or already
        admitted) stays None."""
        if deadline_left_s is None:
            return None
        base = time.monotonic() if now is None else now
        return base + max(float(deadline_left_s), 0.0)

    def spill_policy(self) -> bool:
        """True: cold prefix-KV pages spill to checksummed files and heal
        on read; False: they drop and the prefix re-prefills."""
        return bool(self.cfg.kv_host_spill) if self.cfg is not None else True


__all__ = ["SchedCore"]
