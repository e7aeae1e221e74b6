"""Adaptive draft depth per SLO class (``--spec_adaptive``; the JAX
package's ``serve/spec.py``).

The verify passes' acceptance, counted per SLO class, moves each class's
draft depth k: raised while its drafts land, lowered toward ``spec_k_min``
while they miss. A pass's draft budget is spent on interactive rows first,
in the scheduler's class order. Verification stays draft-agnostic, so a
decision here moves only the sweeps per token, never an emitted token.

The controller is also the brownout ladder's first rung
(``runtime/pressure.py`` ``spec_backoff``): :meth:`SpecController.
pressure_backoff` stops every draft (k = 0, the plain path) while keeping
the adapted k's and windows, and :meth:`~SpecController.pressure_restore`
drafts again at them. Each decision is a ``spec_k_raise`` or
``spec_k_backoff`` journal event (``obs/events.py``), as in the JAX package.
"""

from __future__ import annotations

import threading

import numpy as np

from flexible_llm_sharding_tpu_torch.obs import events as obs_events
from flexible_llm_sharding_tpu_torch.serve.sched.classes import SLO_CLASSES


class SpecController:
    """Per-class adaptive draft depth of one serving engine.

    ``assign(classes, remaining)`` gives each row's k for the next verify
    pass (handed to ``SpecVerifier.set_pass_k``); ``observe(slo_class,
    drafted, accepted)`` feeds a pass's per-class counts back, and every
    ``window`` observed passes of a class move its k by one step. Called
    from the serving loop; ``stats()`` from any thread."""

    def __init__(self, spec_k: int, k_min: int, k_max: int, window: int, raise_threshold: float,
                 backoff_threshold: float, draft_budget: int = 0):
        self._lock = threading.Lock()
        self.k_min = int(k_min)
        self.k_max = int(k_max)
        self.window = int(window)
        self.raise_threshold = float(raise_threshold)
        self.backoff_threshold = float(backoff_threshold)
        self.draft_budget = int(draft_budget)
        start = min(max(int(spec_k), self.k_min), self.k_max)
        self._k = {c: start for c in SLO_CLASSES}
        # Per class since its last decision: [passes, drafted, accepted].
        self._win = {c: [0, 0, 0] for c in SLO_CLASSES}
        self._backed_off = False
        self.k_raises = 0
        self.k_backoffs = 0
        self.pressure_backoffs = 0
        self.pressure_restores = 0
        self.assigned_tokens = 0
        self.budget_clipped_tokens = 0

    def assign(self, classes, remaining) -> np.ndarray:
        """Each row's draft depth for one verify pass. ``classes``: [B][S]
        class names (None for padding); ``remaining``: [B, S] tokens each
        row may still emit. Rows are funded class by class, interactive
        first, and ``draft_budget`` (0 = unlimited) caps the pass's drafted
        tokens."""
        rem = np.asarray(remaining)
        karr = np.zeros(rem.shape, np.int64)
        with self._lock:
            if self._backed_off:
                return karr
            budget_left = self.draft_budget if self.draft_budget > 0 else None
            for cls in SLO_CLASSES:
                k_cls = self._k[cls]
                if k_cls <= 0:
                    continue
                for r in range(rem.shape[0]):
                    for s in range(rem.shape[1]):
                        if classes[r][s] != cls or rem[r, s] <= 1:
                            continue
                        # At most remaining - 1 drafts can become emissions.
                        k_row = min(k_cls, int(rem[r, s]) - 1)
                        if budget_left is not None:
                            if budget_left <= 0:
                                self.budget_clipped_tokens += k_row
                                continue
                            if k_row > budget_left:
                                self.budget_clipped_tokens += k_row - budget_left
                                k_row = budget_left
                            budget_left -= k_row
                        karr[r, s] = k_row
                        self.assigned_tokens += k_row
        return karr

    def observe(self, slo_class: str, drafted: int, accepted: int) -> None:
        """One pass's drafted and accepted tokens of one class; a pass that
        drafted nothing is no evidence and is not counted."""
        if drafted <= 0:
            return
        decision = None
        with self._lock:
            win = self._win.setdefault(slo_class, [0, 0, 0])
            win[0] += 1
            win[1] += drafted
            win[2] += accepted
            if win[0] < self.window:
                return
            acceptance = win[2] / win[1]
            self._win[slo_class] = [0, 0, 0]
            k = self._k[slo_class]
            if acceptance >= self.raise_threshold and k < self.k_max:
                self._k[slo_class] = k + 1
                self.k_raises += 1
                decision = ("spec_k_raise", k + 1, acceptance)
            elif acceptance <= self.backoff_threshold and k > self.k_min:
                self._k[slo_class] = k - 1
                self.k_backoffs += 1
                decision = ("spec_k_backoff", k - 1, acceptance)
        if decision is not None:
            kind, new_k, acc = decision
            obs_events.emit(kind, slo_class=slo_class, k=new_k, acceptance=round(acc, 4),
                            reason="acceptance")

    def pressure_backoff(self) -> None:
        """The ladder's engage: draft nothing (every row k = 0) until the
        release; the adapted k's and windows are kept."""
        with self._lock:
            if self._backed_off:
                return
            self._backed_off = True
            self.pressure_backoffs += 1
            ks = dict(self._k)
        obs_events.emit("spec_k_backoff", k=0, reason="pressure",
                        **{f"k_{c}": v for c, v in ks.items()})

    def pressure_restore(self) -> None:
        """The ladder's release: draft again at the adapted k's."""
        with self._lock:
            if not self._backed_off:
                return
            self._backed_off = False
            self.pressure_restores += 1
            ks = dict(self._k)
        obs_events.emit("spec_k_raise", reason="pressure_restore",
                        **{f"k_{c}": v for c, v in ks.items()})

    def current_k(self, slo_class: str) -> int:
        with self._lock:
            if self._backed_off:
                return 0
            return self._k.get(slo_class, self.k_min)

    def stats(self) -> dict:
        """The engine's ``spec_ctrl`` stats source: each class's k and the
        decision and allocation counters."""
        with self._lock:
            return {
                "k_raises": self.k_raises,
                "k_backoffs": self.k_backoffs,
                "pressure_backoffs": self.pressure_backoffs,
                "pressure_restores": self.pressure_restores,
                "assigned_tokens": self.assigned_tokens,
                "budget_clipped_tokens": self.budget_clipped_tokens,
                "backed_off": int(self._backed_off),
                "k_by_class": dict(self._k),
            }


__all__ = ["SpecController"]
