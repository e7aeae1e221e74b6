"""On-disk LoRA adapter registry: named per-layer delta directories (the JAX
package's ``adapters/registry.py``; the files are byte-compatible, so an
adapter written by either package loads in the other).

One subdirectory per adapter under the registry root (``--adapter_dir``)::

    <root>/<name>/
        adapter_plan.json          # AdapterPlan
        integrity.json             # integrity/manifest.py manifest
        model.layers.0.safetensors # {"lora_A": [D, r], "lora_B": [r, D]}
        ...

``lora_A``/``lora_B`` are float32 in the row-vector layout of the
hidden-stream shift ``h += (h @ A) @ B * scale`` at a decoder layer's entry
(PEFT's weights are transposed by the converter). The plan records the
per-layer ranks (the files may cover a subset of the layers); ``scale`` is
the adapter-wide ``alpha / rank``. The PEFT converter folds each module's
``lora_alpha / r`` into B and writes ``alpha == rank``, so its factors apply
at scale 1.0.

Every delta file is checksummed into the directory's manifest, so ``verify
--adapter_dir`` audits it (``integrity/verify.verify_adapter_dir``) and the
serving loader (``adapters/loader.py``) re-reads transient corruption away
and types persistent corruption as :class:`AdapterCorruptError`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Mapping

import torch

from flexible_llm_sharding_tpu_torch.faults.retry import ShardLoadError
from flexible_llm_sharding_tpu_torch.integrity import manifest as integrity_manifest
from flexible_llm_sharding_tpu_torch.utils.checkpoint import (
    LAYER_FILE_SUFFIX,
    read_safetensors,
    write_safetensors,
)

ADAPTER_PLAN_NAME = "adapter_plan.json"


class AdapterNotFound(KeyError):
    """No adapter of that name in the registry: a per-request input error
    (the request fails typed; the engine never retries it)."""


class AdapterCorruptError(ShardLoadError):
    """An adapter's files are structurally wrong or their corruption
    survived every re-read: a corrupt or misplaced plan, a delta file whose
    shapes disagree with the plan, or a checksum mismatch that persisted.
    Not retried; only that tenant's requests fail. Audit with ``verify
    --adapter_dir``."""


@dataclasses.dataclass(frozen=True)
class AdapterPlan:
    """A named adapter's layer -> rank map and its apply scale, serialized
    as ``adapter_plan.json``. ``layers`` is the execution-ordered
    ``(decoder_layer_name, rank)`` of the layers that have delta files;
    ``rank`` is the largest per-layer rank, ``scale`` ``alpha / rank``."""

    name: str
    rank: int
    alpha: float
    hidden_size: int
    layers: tuple[tuple[str, int], ...]
    target_modules: tuple[str, ...] = ()

    def __post_init__(self) -> None:
        if self.rank < 1:
            raise ValueError(f"AdapterPlan: rank must be >= 1, got {self.rank}")
        if self.hidden_size < 1:
            raise ValueError(f"AdapterPlan: hidden_size must be >= 1, got {self.hidden_size}")
        for lname, r in self.layers:
            if not 1 <= r <= self.rank:
                raise ValueError(
                    f"AdapterPlan: layer {lname!r} has rank {r}; must be in [1, {self.rank}] "
                    "(rank is the plan-wide max)")

    @property
    def scale(self) -> float:
        return float(self.alpha) / float(self.rank)

    @property
    def ranks(self) -> dict[str, int]:
        return dict(self.layers)

    def layer_file(self, layer_name: str) -> str:
        return f"{layer_name}{LAYER_FILE_SUFFIX}"

    def nbytes(self) -> int:
        """Host bytes of the float32 factors the plan describes."""
        return sum(2 * self.hidden_size * r * 4 for _, r in self.layers)

    def to_json(self) -> dict:
        return {
            "version": 1,
            "name": self.name,
            "rank": self.rank,
            "alpha": self.alpha,
            "hidden_size": self.hidden_size,
            "layers": {n: r for n, r in self.layers},
            "layer_order": [n for n, _ in self.layers],
            "target_modules": list(self.target_modules),
        }

    @classmethod
    def from_json(cls, data: Mapping[str, Any]) -> "AdapterPlan":
        layer_map = data["layers"]
        order = data.get("layer_order") or sorted(layer_map)
        return cls(
            name=str(data["name"]),
            rank=int(data["rank"]),
            alpha=float(data["alpha"]),
            hidden_size=int(data["hidden_size"]),
            layers=tuple((n, int(layer_map[n])) for n in order),
            target_modules=tuple(data.get("target_modules", ())),
        )

    def write(self, path: str) -> str:
        """Write the plan JSON atomically (tmp + rename)."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, sort_keys=True, indent=1)
        os.replace(tmp, path)
        return path

    def save(self, adapter_dir: str) -> str:
        return self.write(os.path.join(adapter_dir, ADAPTER_PLAN_NAME))

    @classmethod
    def load(cls, adapter_dir: str) -> "AdapterPlan | None":
        """The plan in an adapter directory, or None without a plan file. A
        corrupt plan raises ValueError; an unreadable one its OSError."""
        path = os.path.join(adapter_dir, ADAPTER_PLAN_NAME)
        try:
            with open(path) as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        try:
            return cls.from_json(json.loads(raw))
        except (ValueError, KeyError, TypeError) as e:
            raise ValueError(
                f"{path}: corrupt adapter plan ({e!r}); re-run prepare-adapter or delete the "
                "adapter dir") from e


class AdapterRegistry:
    """Named adapters under one root directory: names to directories and
    plans, with the typed errors the serve path relies on. Caching, budgets
    and re-reads are the loader's."""

    def __init__(self, root: str):
        self.root = root

    def names(self) -> tuple[str, ...]:
        """Every adapter present (sorted): subdirectories holding an
        ``adapter_plan.json``. An unreadable root reads as empty."""
        try:
            entries = sorted(os.listdir(self.root))
        except OSError:
            return ()
        return tuple(n for n in entries
                     if os.path.isfile(os.path.join(self.root, n, ADAPTER_PLAN_NAME)))

    def path(self, name: str) -> str:
        d = os.path.join(self.root, name)
        if not os.path.isfile(os.path.join(d, ADAPTER_PLAN_NAME)):
            raise AdapterNotFound(
                f"adapter {name!r} not found under {self.root!r} (available: "
                f"{list(self.names())})")
        return d

    def plan(self, name: str) -> AdapterPlan:
        d = self.path(name)
        try:
            plan = AdapterPlan.load(d)
        except ValueError as e:
            raise AdapterCorruptError(str(e)) from e
        if plan is None:  # path() just found the file; it went meanwhile
            raise AdapterNotFound(f"adapter {name!r} has no plan file")
        if plan.name != name:
            raise AdapterCorruptError(
                f"{d}/{ADAPTER_PLAN_NAME}: plan names adapter {plan.name!r} but lives in dir "
                f"{name!r} — a moved or hand-edited dir; re-run prepare-adapter")
        return plan


def save_adapter(root: str, name: str, factors: Mapping[str, tuple[Any, Any]], *,
                 alpha: float | None = None, target_modules: tuple[str, ...] = ()) -> str:
    """Write one adapter directory: per-layer delta safetensors, the plan
    and the integrity manifest. ``factors`` maps decoder layer names to
    ``(A [D, r], B [r, D])`` pairs (numpy or torch, stored float32).
    ``alpha`` defaults to the largest rank (apply scale 1.0). Returns the
    adapter directory."""
    if not factors:
        raise ValueError(f"adapter {name!r}: no layer factors to save")
    adir = os.path.join(root, name)
    os.makedirs(adir, exist_ok=True)
    layers = []
    hidden = None
    manifest_layers: dict[str, dict] = {}
    for lname in sorted(factors, key=_layer_sort_key):
        a, b = (torch.as_tensor(x, dtype=torch.float32).contiguous() for x in factors[lname])
        if a.ndim != 2 or b.ndim != 2 or tuple(a.shape) != tuple(b.shape)[::-1]:
            raise ValueError(
                f"adapter {name!r} layer {lname!r}: A {tuple(a.shape)} / B {tuple(b.shape)} "
                "must be [D, r] / [r, D]")
        if hidden is None:
            hidden = int(a.shape[0])
        elif int(a.shape[0]) != hidden:
            raise ValueError(
                f"adapter {name!r} layer {lname!r}: hidden size {a.shape[0]} disagrees with "
                f"{hidden}")
        r = int(a.shape[1])
        if r < 1:
            raise ValueError(f"adapter {name!r} layer {lname!r}: rank 0")
        layers.append((lname, r))
        flat = {"lora_A": a, "lora_B": b}
        file_name = f"{lname}{LAYER_FILE_SUFFIX}"
        write_safetensors(os.path.join(adir, file_name), flat)
        manifest_layers[lname] = integrity_manifest.layer_entry(flat, file_name)
    rank = max(r for _, r in layers)
    AdapterPlan(
        name=name, rank=rank, alpha=float(alpha) if alpha is not None else float(rank),
        hidden_size=int(hidden), layers=tuple(layers), target_modules=tuple(target_modules),
    ).save(adir)
    integrity_manifest.write_manifest(adir, manifest_layers)
    return adir


def _layer_sort_key(lname: str):
    parts = lname.split(".")
    try:
        return (0, int(parts[2]))
    except (IndexError, ValueError):
        return (1, lname)


# base_model.model.model.layers.3.self_attn.q_proj.lora_A.weight
_PEFT_KEY = re.compile(r".*\.layers\.(\d+)\.(.+?)\.lora_(A|B)\.weight$")


def convert_peft_checkpoint(src_dir: str, root: str, name: str) -> str:
    """Convert a Hugging Face PEFT LoRA directory (``adapter_config.json`` +
    ``adapter_model.safetensors``) into the registry layout, the
    ``prepare-adapter`` subcommand.

    Square target modules only (in == out == hidden). A layer's module
    deltas concatenate along the rank axis (modules in sorted order) into
    one hidden-stream pair applied at the layer's entry, each module's
    ``lora_alpha / r`` folded into its B slice (the plan's scale is 1.0).
    Non-square targets and ``.bin`` checkpoints raise ``ValueError``."""
    cfg_path = os.path.join(src_dir, "adapter_config.json")
    try:
        with open(cfg_path) as f:
            peft_cfg = json.load(f)
    except FileNotFoundError:
        raise ValueError(f"{src_dir}: no adapter_config.json — not a PEFT checkpoint dir") from None
    st_path = os.path.join(src_dir, "adapter_model.safetensors")
    if not os.path.isfile(st_path):
        if os.path.isfile(os.path.join(src_dir, "adapter_model.bin")):
            raise ValueError(
                f"{src_dir}: only a torch-pickle adapter_model.bin — re-save the PEFT checkpoint "
                "with safe_serialization=True (this toolchain reads safetensors only)")
        raise ValueError(f"{src_dir}: no adapter_model.safetensors")
    tensors = read_safetensors(st_path)
    alpha = float(peft_cfg.get("lora_alpha", peft_cfg.get("r", 1)))
    # (layer index, module) -> {"A": [r, D_in], "B": [D_out, r]} (PEFT layout)
    pairs: dict[tuple[int, str], dict[str, torch.Tensor]] = {}
    for key, t in tensors.items():
        m = _PEFT_KEY.match(key)
        if m is None:
            continue
        idx, module, ab = int(m.group(1)), m.group(2), m.group(3)
        pairs.setdefault((idx, module), {})[ab] = t.to(torch.float32)
    if not pairs:
        raise ValueError(
            f"{st_path}: no '*.layers.N.<module>.lora_A/B.weight' tensors — unsupported PEFT "
            "layout")
    hidden = None
    per_layer: dict[int, list[tuple[torch.Tensor, torch.Tensor]]] = {}
    for (idx, module), ab in sorted(pairs.items()):
        if "A" not in ab or "B" not in ab:
            raise ValueError(
                f"{st_path}: layer {idx} module {module!r} has only half a lora_A/lora_B pair")
        a_w, b_w = ab["A"], ab["B"]  # [r, D_in], [D_out, r]
        r = int(a_w.shape[0])
        if a_w.shape[1] != b_w.shape[0] or b_w.shape[1] != r:
            raise ValueError(
                f"{st_path}: layer {idx} module {module!r} is non-square (lora_A "
                f"{tuple(a_w.shape)}, lora_B {tuple(b_w.shape)}) — v1 converts square target "
                "modules only (in == out == hidden)")
        d = int(a_w.shape[1])
        if hidden is None:
            hidden = d
        elif d != hidden:
            raise ValueError(
                f"{st_path}: module {module!r} hidden size {d} disagrees with {hidden}")
        # Row-vector layout with alpha/r folded into B (scale 1.0).
        per_layer.setdefault(idx, []).append((a_w.t(), b_w.t() * (alpha / float(r))))
    factors = {
        f"model.layers.{idx}": (torch.cat([a for a, _ in mods], dim=1),
                                torch.cat([b for _, b in mods], dim=0))
        for idx, mods in per_layer.items()
    }
    modules = tuple(sorted({mod for _, mod in pairs}))
    return save_adapter(root, name, factors, target_modules=modules)


__all__ = [
    "ADAPTER_PLAN_NAME",
    "AdapterCorruptError",
    "AdapterNotFound",
    "AdapterPlan",
    "AdapterRegistry",
    "convert_peft_checkpoint",
    "save_adapter",
]
