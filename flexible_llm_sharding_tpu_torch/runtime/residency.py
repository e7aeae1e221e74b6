"""Device residency tier (the JAX package's ``runtime/residency.py``, one
device): pin the layers that stream the most bytes per pass on the card,
stream the rest.

Given a byte budget (``FrameworkConfig.hbm_pin_gb``), :func:`plan_residency`
selects the non-decoder layers first (embedding, norm, lm_head: they run on
every pass), then the decoder layers with the most streamed bytes per pass
(ties by index), skipping what does not fit. :class:`DeviceResidencyTier`
loads each planned layer once through the weight source's own loader — the
retried, crc-verified, host-cached path every streamed byte takes — places
it on the device and keeps it for the process's life. Every weight source
subtracts the pinned layers from its builds and merges their placed trees
back in layer order, so a pass's ``streamed_bytes`` falls by exactly the
pinned layers' bytes and the outputs are the unpinned run's.

Safety, as in the JAX package: a pin load whose corruption survives every
re-read is never pinned — the layer is demoted to streaming for the tier's
life (counted in ``pin_failures``) and its typed error surfaces on the
streamed path. A source freezes its pin set at construction. An explicit
``hbm_pin_gb`` fixes the process tier's budget; an auto budget (None) only
ever grows an auto-sized tier; auto is the card's free memory less
``ACTIVATION_HEADROOM_FRACTION`` of its total (``torch.cuda.mem_get_info``),
and 0 on the CPU.

Budget caveat: layers are charged at their streamed (file) size. A pinned
int8 or int4 layer is dequantized to the compute dtype on placement, so it
holds 2-4x its charge on the device: leave headroom. ``pinned_bytes``
reports the bytes on the device, and ``peak_mem_gb`` is floored at them.

The brownout ladder's ``pin_evict`` rung (``runtime/pressure.py``) calls
:meth:`DeviceResidencyTier.pressure_unpin`: the plan becomes empty, no
``tier_for`` or ``_install_plan`` re-plans it while the demotion holds,
and, unlike the JAX tier, the tier drops its placed trees, so the card's
memory falls by the pinned bytes once the shards in flight are consumed
(a live source streams its frozen pins from then on; the segment lists are
the same either way). :meth:`~DeviceResidencyTier.pressure_restore`
reinstalls the plan, and the pins reload on their next request. As in the
JAX tier, each pin load is traced (a ``residency_pin`` span) and the
process tier's stats are registered with the metrics registry as
``residency``.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Sequence

import torch

from flexible_llm_sharding_tpu_torch.obs import trace as obs_trace
from flexible_llm_sharding_tpu_torch.obs.registry import REGISTRY
from flexible_llm_sharding_tpu_torch.utils import checkpoint

# Auto budget: the share of the card's total memory held back for
# activations, KV, the prefetch queue and the allocator's scratch.
ACTIVATION_HEADROOM_FRACTION = 0.35


def layer_stream_bytes(model_path: str, layer_names: Sequence[str],
                       tied_embeddings: bool = False) -> dict[int, int]:
    """Streamed bytes per pass per layer index, from the layer files' size
    (quantized layers travel packed, so the file size is what crosses the
    link), through the loader's own name -> file mapping. The tied lm_head
    over a quantized embedding streams its int8 requantization instead
    (:func:`_tied_head_stream_bytes`). Unreadable files count 0."""
    out: dict[int, int] = {}
    for i, name in enumerate(layer_names):
        path = checkpoint.layer_file_for(model_path, name, tied_embeddings)
        try:
            if name == "lm_head" and tied_embeddings:
                out[i] = _tied_head_stream_bytes(path)
            else:
                out[i] = os.path.getsize(path)
        except OSError:
            out[i] = 0
    return out


def _tied_head_stream_bytes(embed_path: str) -> int:
    """The tied lm_head's bytes per pass: the embedding file's size for a
    float embedding, else int8 [D, V] plus float32 [V] scales (an int4
    payload [V/2, D] is V/2 rows of packed nibbles)."""
    try:
        header, _ = checkpoint.safetensors_header(embed_path)
        q4 = "embedding" + checkpoint.QUANT4_SCALE_SUFFIX in header
        q8 = "embedding" + checkpoint.QUANT_SCALE_SUFFIX in header
        meta = header.get("embedding")
        if meta is None or not (q4 or q8):
            return os.path.getsize(embed_path)
        v = int(meta["shape"][0]) * (2 if q4 else 1)
        d = int(meta["shape"][1])
        return d * v + 4 * v
    except (ValueError, KeyError, IndexError):
        return os.path.getsize(embed_path)


@dataclasses.dataclass(frozen=True)
class ResidencyPlan:
    """Which layers a byte budget pins, and each layer's bytes per pass."""

    budget_bytes: int
    pinned: tuple[int, ...]  # layer indices, execution order
    layer_bytes: tuple[tuple[int, int], ...]  # (index, streamed bytes)
    skipped: tuple[int, ...]  # considered, did not fit

    @property
    def pinned_set(self) -> frozenset:
        return frozenset(self.pinned)

    @property
    def pinned_bytes_est(self) -> int:
        sizes = dict(self.layer_bytes)
        return sum(sizes[i] for i in self.pinned)

    @property
    def total_bytes_est(self) -> int:
        return sum(b for _, b in self.layer_bytes)

    @property
    def pinned_fraction(self) -> float:
        total = self.total_bytes_est
        return self.pinned_bytes_est / total if total else 0.0


def plan_residency(model_path: str, layer_names: Sequence[str], budget_bytes: int,
                   tied_embeddings: bool = False) -> ResidencyPlan:
    """Greedy selection under ``budget_bytes``: non-decoder layers first,
    then decoder layers by descending streamed bytes; an embedded precision
    plan's dtype (bf16, int8, int4) breaks size ties only; then the index. A
    layer that does not fit is skipped and the scan goes on."""
    from flexible_llm_sharding_tpu_torch.runtime.precisionplan import PrecisionPlan

    sizes = layer_stream_bytes(model_path, layer_names, tied_embeddings)
    dtype_rank = {}
    try:
        plan = PrecisionPlan.load(model_path)
    except (ValueError, OSError):
        plan = None  # the weight source raises the typed error
    if plan is not None:
        rank = {"bf16": 0, "int8": 1, "int4": 2}
        dtype_rank = {i: rank.get(plan.dtypes.get(name, ""), 0)
                      for i, name in enumerate(layer_names)}

    def tier(i: int) -> int:
        return 1 if layer_names[i].startswith("model.layers.") else 0

    order = sorted(range(len(layer_names)),
                   key=lambda i: (tier(i), -sizes[i], dtype_rank.get(i, 0), i))
    pinned: list[int] = []
    skipped: list[int] = []
    used = 0
    for i in order:
        if budget_bytes > 0 and sizes[i] > 0 and used + sizes[i] <= budget_bytes:
            pinned.append(i)
            used += sizes[i]
        else:
            skipped.append(i)
    return ResidencyPlan(
        budget_bytes=int(budget_bytes),
        pinned=tuple(sorted(pinned)),
        layer_bytes=tuple((i, sizes[i]) for i in range(len(layer_names))),
        skipped=tuple(sorted(skipped)),
    )


def full_pin_plan(model_path: str, layer_names: Sequence[str],
                  tied_embeddings: bool = False) -> ResidencyPlan:
    """A plan that pins every layer: the budget is the model's own bytes."""
    sizes = layer_stream_bytes(model_path, layer_names, tied_embeddings)
    return plan_residency(model_path, layer_names, max(sum(sizes.values()), 1), tied_embeddings)


def auto_pin_budget_bytes(device=None) -> int:
    """The card's free memory less ``ACTIVATION_HEADROOM_FRACTION`` of its
    total; 0 on the CPU (unknown device memory resolves to off)."""
    dev = torch.device(device) if device is not None else None
    if dev is None:
        if not torch.cuda.is_available():
            return 0
        dev = torch.device("cuda")
    if dev.type != "cuda":
        return 0
    free, total = torch.cuda.mem_get_info(dev)
    return int(max(0.0, free - ACTIVATION_HEADROOM_FRACTION * total))


def placement_key(device) -> tuple:
    """A placement target's identity (pins survive a rebuilt device
    object)."""
    if device is None:
        return ("default",)
    dev = torch.device(device)
    index = dev.index
    if dev.type == "cuda" and index is None:
        index = torch.cuda.current_device()
    return ("device", dev.type, index)


def probe_chip(target):
    """The device whose memory a gate over ``target`` probes: one device is
    its own probe; a device list (the long-context mesh, whose pins
    replicate on every distinct device) probes each distinct device and
    gives the one with the least auto budget."""
    if isinstance(target, (list, tuple)):
        return min(dict.fromkeys(torch.device(d) for d in target), key=auto_pin_budget_bytes)
    return target


def _tree_nbytes(tree) -> int:
    from flexible_llm_sharding_tpu_torch.runtime.hostcache import tree_nbytes

    return tree_nbytes(tree)


def checkpoint_unavailable(name: str):
    """The error of a layer demoted after a failed pin (the stream path's
    ``ShardCorruptError`` family)."""
    from flexible_llm_sharding_tpu_torch.integrity.manifest import ShardCorruptError

    return ShardCorruptError(
        f"{name}: pin-time load failed persistently; layer demoted to streaming (audit with "
        "the `verify` subcommand)"
    )


class DeviceResidencyTier:
    """Process-lifetime pins of the planned layers' placed trees.

    ``segments(idx, device, loader)`` returns the pinned layer's placed
    ``[(name, params)]`` on ``device``, loading it on first request through
    ``loader`` (a ``ShardWeightSource``: ``build_host_shard`` then
    ``place_layer``). Callers treat the trees as immutable: they are shared
    by every pass and source. A pin load that fails demotes the layer for
    the tier's life (``pin_failures``) and re-raises."""

    def __init__(self, model_path: str, layer_names: Sequence[str], plan: ResidencyPlan):
        self.model_path = model_path
        self.layer_names = list(layer_names)
        self.plan = plan
        self._lock = threading.RLock()
        self._inflight: dict[tuple, threading.Event] = {}
        self._failed: set[int] = set()
        self._host_nbytes: dict[int, int] = {}  # idx -> host bytes a skip saves
        self._plan_bytes: dict[int, int] = dict(plan.layer_bytes)
        self._placed: dict[tuple, dict[int, list]] = {}
        self._dev_bytes: dict[tuple, int] = {}
        self.pin_hits = 0
        self.stream_bytes_saved = 0
        self.pin_loads = 0
        self.pin_failures = 0
        # The brownout demotion: while True the plan is empty, nothing
        # re-plans it, and pressure_restore() reinstalls _saved_plan.
        self.pressure_demoted = False  # guarded by: _lock
        self._saved_plan: ResidencyPlan | None = None  # guarded by: _lock

    def is_pinned(self, idx: int) -> bool:
        with self._lock:
            return idx in self.plan.pinned_set and idx not in self._failed

    def frozen_pinned(self, layer_idxs_groups) -> frozenset:
        """The planned, healthy layers among a source's shards: the pin set
        the source keeps for its life."""
        with self._lock:
            return frozenset(i for group in layer_idxs_groups for i in group
                             if i in self.plan.pinned_set and i not in self._failed)

    def segments(self, idx: int, device, loader) -> list:
        """The pinned layer's placed ``[(name, params)]`` on ``device``,
        pinned on first request. A failed load demotes the layer and
        re-raises the loader's error. While a brownout demotion holds, a
        layer not placed is loaded for this one use and not seated."""
        key = placement_key(device)
        while True:
            with self._lock:
                hit = self._placed.setdefault(key, {}).get(idx)
                if hit is not None:
                    return hit
                if idx in self._failed:
                    raise checkpoint_unavailable(self.layer_names[idx])
                if self.pressure_demoted:
                    gate = None
                    break
                gate = self._inflight.get((key, idx))
                if gate is None:
                    gate = threading.Event()
                    self._inflight[(key, idx)] = gate
                    break
            gate.wait()  # another caller loads it: re-check when it is done
        if gate is None:
            host = loader.build_host_shard((idx,))
            return [(name, loader.place_layer(name, tree, device)) for name, tree in host]
        try:
            # One span per pin load: a one-time cost, not a per-pass one.
            with obs_trace.span("residency_pin", cat="residency", layer=self.layer_names[idx],
                                idx=idx):
                host = loader.build_host_shard((idx,))
                placed = [(name, loader.place_layer(name, tree, device)) for name, tree in host]
        except Exception:
            # Never pin bytes that did not verify: stream this layer for good.
            with self._lock:
                self._failed.add(idx)
                self.pin_failures += 1
                self._inflight.pop((key, idx), None)
            gate.set()
            raise
        with self._lock:
            placed = self._seat(key, idx, host, placed)
            self._inflight.pop((key, idx), None)
        gate.set()
        return placed

    def _seat(self, key: tuple, idx: int, host, placed) -> list:
        """Seat a placed pin under the lock; a pin seated first wins and
        the duplicate is dropped, never counted twice."""
        seats = self._placed.setdefault(key, {})
        if seats.get(idx) is None:
            seats[idx] = placed
            self._host_nbytes.setdefault(idx, _tree_nbytes([t for _, t in host]))
            self._dev_bytes[key] = self._dev_bytes.get(key, 0) + _tree_nbytes(
                [t for _, t in placed])
            self.pin_loads += 1
        return seats[idx]

    def pin_from_host(self, idx: int, device, host, loader) -> None:
        """Seat an already built, verified host tree as ``idx``'s pin on
        ``device`` (the broadcast pre-pin's read-once path)."""
        key = placement_key(device)
        with self._lock:
            if self._placed.setdefault(key, {}).get(idx) is not None:
                return
        placed = [(name, loader.place_layer(name, tree, device)) for name, tree in host]
        with self._lock:
            self._seat(key, idx, host, placed)

    def ensure_pinned_broadcast(self, loader, devices, layer_idxs) -> None:
        """Pin the planned layers among ``layer_idxs`` on every DP device
        with one host build per layer (``ensure_pinned`` per device would
        read and check each pinned file once per device). A failed build or
        placement demotes the layer, which then streams everywhere."""
        for i in layer_idxs:
            if not self.is_pinned(i):
                continue
            with self._lock:
                missing = list({placement_key(d): d for d in devices
                                if self._placed.get(placement_key(d), {}).get(i) is None
                                }.values())
            if not missing:
                continue
            try:
                host = loader.build_host_shard((i,))
                for d in missing:
                    self.pin_from_host(i, d, host, loader)
            # flscheck: disable=EXC-TAXONOMY: any pin build or placement failure demotes the layer, which then streams everywhere, where its typed error surfaces
            except Exception:  # never pin unverified bytes: stream this layer for good
                with self._lock:
                    self._failed.add(i)
                    self.pin_failures += 1

    def ensure_pinned(self, loader, device, layer_idxs) -> None:
        """Pin the planned layers among ``layer_idxs`` now; a failure has
        demoted its layer, which then streams and raises there."""
        for i in layer_idxs:
            if not self.is_pinned(i):
                continue
            try:
                self.segments(i, device, loader)
            # flscheck: disable=EXC-TAXONOMY: pre-pin is best-effort; segments() already demoted the layer and the streamed path surfaces its typed error
            except Exception:  # demoted inside segments(); the stream reports it
                pass

    def note_skip(self, idx: int) -> None:
        """One pinned layer left out of one shard build: one pass's bytes
        of it saved."""
        with self._lock:
            self.pin_hits += 1
            saved = self._host_nbytes.get(idx)
            self.stream_bytes_saved += saved if saved is not None else self._plan_bytes.get(idx, 0)

    def pinned_device_bytes(self, device=None) -> int:
        """Bytes pinned on one placement target (the peak memory floor)."""
        with self._lock:
            return self._dev_bytes.get(placement_key(device), 0)

    def max_pinned_device_bytes(self) -> int:
        """The most bytes pinned on any one placement target (the stats'
        ``pinned_bytes`` sums every target)."""
        with self._lock:
            return max(self._dev_bytes.values(), default=0)

    def stats(self) -> dict[str, float]:
        with self._lock:
            return {
                "pinned_layers": len({i for m in self._placed.values() for i in m}),
                "planned_layers": len(self.plan.pinned),
                "pinned_bytes": sum(self._dev_bytes.values()),
                "stream_bytes_saved": self.stream_bytes_saved,
                "pin_hits": self.pin_hits,
                "pin_loads": self.pin_loads,
                "pin_failures": self.pin_failures,
                "budget_bytes": self.plan.budget_bytes,
                "pressure_demoted": int(self.pressure_demoted),
            }

    def _install_plan(self, plan: ResidencyPlan) -> None:
        """A shrink drops layers from the plan for future sources; placed
        trees stay (live sources froze their pin sets). Refused while a
        brownout demotion holds: a plan made before it must not re-pin."""
        with self._lock:
            if self.pressure_demoted:
                return
            self.plan = plan

    def pressure_unpin(self) -> int:
        """The ladder's ``pin_evict`` rung: install an empty plan, latch
        the demotion and drop every placed tree (the memory frees with the
        last reference, a shard in flight's). Returns the planned layers
        demoted (0 when already demoted)."""
        with self._lock:
            if self.pressure_demoted:
                return 0
            demoted = len(self.plan.pinned)
            self._saved_plan = self.plan
            self.plan = ResidencyPlan(budget_bytes=0, pinned=(),
                                      layer_bytes=self.plan.layer_bytes,
                                      skipped=tuple(range(len(self.layer_names))))
            self.pressure_demoted = True
            self._placed.clear()
            self._dev_bytes.clear()
        obs_trace.instant("pressure_unpin", cat="pressure", layers=demoted)
        return demoted

    def pressure_restore(self) -> int:
        """Undo :meth:`pressure_unpin`: reinstall the saved plan (the pins
        reload on their next request). Returns the layers planned again."""
        with self._lock:
            if not self.pressure_demoted:
                return 0
            saved, self._saved_plan = self._saved_plan, None
            if saved is not None:
                self.plan = saved
            self.pressure_demoted = False
            restored = len(self.plan.pinned)
        obs_trace.instant("pressure_repin", cat="pressure", layers=restored)
        return restored


# -- the process tier ----------------------------------------------------------
# One tier per process, as the host cache: every source of every call finds
# the same pins. An explicit budget fixes the cap; auto only grows an
# auto-sized tier. Planning stats every layer file, so it runs off the lock;
# the install re-checks the precedence under it.

_PROCESS_TIER: DeviceResidencyTier | None = None
_PROCESS_TIER_KEY: tuple | None = None
_PROCESS_BUDGET_EXPLICIT = False
_PROCESS_LOCK = threading.Lock()


def tier_for(cfg, layer_names: Sequence[str], tied_embeddings: bool,
             device=None) -> DeviceResidencyTier | None:
    """The process tier for ``cfg``, or None when its budget resolves to 0."""
    budget = cfg.effective_hbm_pin_bytes(device)
    if budget <= 0:
        return None
    explicit = cfg.hbm_pin_gb is not None
    key = (os.path.abspath(cfg.model_path), cfg.dtype, bool(cfg.verify_weights),
           tuple(layer_names), bool(tied_embeddings))
    global _PROCESS_TIER, _PROCESS_TIER_KEY, _PROCESS_BUDGET_EXPLICIT
    resize = False
    with _PROCESS_LOCK:
        tier = _PROCESS_TIER if _PROCESS_TIER is not None and _PROCESS_TIER_KEY == key else None
        if tier is not None:
            if tier.pressure_demoted:
                resize = False  # no re-plan until the brownout lifts
            elif explicit:
                resize = tier.plan.budget_bytes != budget
                if not resize:
                    _PROCESS_BUDGET_EXPLICIT = True
            else:
                resize = not _PROCESS_BUDGET_EXPLICIT and budget > tier.plan.budget_bytes
    if tier is not None:
        if resize:
            _apply_process_budget(tier, budget, explicit, tied_embeddings)
        return tier
    plan = plan_residency(cfg.model_path, layer_names, budget, tied_embeddings)
    with _PROCESS_LOCK:
        if _PROCESS_TIER is not None and _PROCESS_TIER_KEY == key:
            # Lost the install race: reuse the winner, under this caller's
            # budget precedence.
            tier = _PROCESS_TIER
            if explicit:
                resize = tier.plan.budget_bytes != budget
                if not resize:
                    _PROCESS_BUDGET_EXPLICIT = True
            else:
                resize = not _PROCESS_BUDGET_EXPLICIT and budget > tier.plan.budget_bytes
        else:
            _PROCESS_TIER = DeviceResidencyTier(cfg.model_path, layer_names, plan)
            _PROCESS_TIER_KEY = key
            _PROCESS_BUDGET_EXPLICIT = explicit
            REGISTRY.register("residency", _PROCESS_TIER.stats)
            return _PROCESS_TIER
    if resize:
        _apply_process_budget(tier, budget, explicit, tied_embeddings, plan=plan)
    return tier


def _apply_process_budget(tier: DeviceResidencyTier, budget: int, explicit: bool,
                          tied_embeddings: bool, plan: ResidencyPlan | None = None) -> None:
    """Re-plan ``tier`` to ``budget`` and install the plan if this caller's
    precedence still holds: an explicit budget latches with its install; an
    auto one yields to an explicit cap or a larger auto budget that landed
    while it planned."""
    if plan is None:
        plan = plan_residency(tier.model_path, tier.layer_names, budget, tied_embeddings)
    global _PROCESS_BUDGET_EXPLICIT
    with _PROCESS_LOCK:
        if explicit:
            _PROCESS_BUDGET_EXPLICIT = True
        elif _PROCESS_BUDGET_EXPLICIT or budget <= tier.plan.budget_bytes:
            return
        tier._install_plan(plan)


def process_tier() -> DeviceResidencyTier | None:
    """The live process tier (the CLI's stats read it)."""
    with _PROCESS_LOCK:
        return _PROCESS_TIER


def reset_process_tier() -> None:
    """Drop the process tier and its pins (tests; one process, several
    models). The device memory frees with the last reference."""
    global _PROCESS_TIER, _PROCESS_TIER_KEY, _PROCESS_BUDGET_EXPLICIT
    with _PROCESS_LOCK:
        _PROCESS_TIER = None
        _PROCESS_TIER_KEY = None
        _PROCESS_BUDGET_EXPLICIT = False
    REGISTRY.unregister("residency")


def plan_report(model_path: str, budget_bytes: int) -> dict:
    """The ``verify --hbm_pin_gb`` dry run: which layers the budget would
    pin and the bytes each pass would skip. Nothing is loaded."""
    from flexible_llm_sharding_tpu_torch.config import LlamaConfig

    model_cfg = LlamaConfig.from_pretrained(model_path)
    layer_names = checkpoint.layer_names_for(model_cfg.num_hidden_layers, tie_word_embeddings=False)
    plan = plan_residency(model_path, layer_names, budget_bytes, model_cfg.tie_word_embeddings)
    sizes = dict(plan.layer_bytes)
    return {
        "model_path": model_path,
        "budget_gb": round(budget_bytes / 1e9, 3),
        "pinned": [{"layer": layer_names[i], "bytes": sizes[i]} for i in plan.pinned],
        "pinned_layers": len(plan.pinned),
        "total_layers": len(layer_names),
        "pinned_bytes": plan.pinned_bytes_est,
        "total_bytes": plan.total_bytes_est,
        "pinned_fraction": round(plan.pinned_fraction, 4),
        "stream_bytes_saved_per_sweep": plan.pinned_bytes_est,
        "skipped_layers": len(plan.skipped),
    }


__all__ = [
    "ACTIVATION_HEADROOM_FRACTION",
    "DeviceResidencyTier",
    "ResidencyPlan",
    "auto_pin_budget_bytes",
    "full_pin_plan",
    "layer_stream_bytes",
    "placement_key",
    "plan_report",
    "plan_residency",
    "probe_chip",
    "process_tier",
    "reset_process_tier",
    "tier_for",
]
