"""Activations parked between shards (the JAX package's
``runtime/activations.py``, without checksums or fault injection).

Three places, chosen by ``storage_location``: ``gpu`` keeps each block's
(prefix_h, suffix_h) in device memory, ``cpu`` in host RAM, ``disk`` in the
reference's per-prompt files ``prefix{tag}-{idx:05d}.npy`` /
``suffix{tag}-{idx:05d}.npy``. In ``cpu`` mode at most ``max_in_cpu``
prompts' activations stay in RAM; later blocks spill to disk. A block is
fetched (and removed) before the next shard stores it again, so one file
generation suffices.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from flexible_llm_sharding_tpu_torch.utils.checkpoint import tensor_from_numpy


def _save_npy(path: str, t: torch.Tensor) -> None:
    """Save one CPU tensor; bfloat16 goes to disk as its 16 raw bits."""
    arr = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.save(f, arr)
    os.replace(tmp, path)


def _load_npy(path: str, dtype: torch.dtype) -> torch.Tensor:
    arr = np.load(path)
    if dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return tensor_from_numpy(arr).to(dtype)


class ActivationStore:
    """Store/fetch (prefix_h [B, Lp, D] | None, suffix_h [B, S, Ls, D]) per
    block id; fetch returns tensors on ``device``."""

    def __init__(self, location: str, device: torch.device, dtype: torch.dtype,
                 disk_folder: str = "./temp", max_in_cpu: int | None = None,
                 batch: int = 0):
        if location not in ("gpu", "cpu", "disk"):
            raise ValueError(f"storage_location must be gpu|cpu|disk, got {location!r}")
        self.location = location
        self.device = device
        self.dtype = dtype
        self.disk_folder = disk_folder
        self.max_in_cpu = max_in_cpu
        # Batch 0 keeps the reference's exact file names.
        self.tag = f".b{batch}" if batch else ""
        self._mem: dict[object, tuple] = {}
        self._spilled: set[object] = set()
        self._cpu_prompts = 0
        if location == "disk":
            os.makedirs(disk_folder, exist_ok=True)

    def _paths(self, idx: int) -> tuple[str, str]:
        return (
            os.path.join(self.disk_folder, f"prefix{self.tag}-{idx:05d}.npy"),
            os.path.join(self.disk_folder, f"suffix{self.tag}-{idx:05d}.npy"),
        )

    def _store_disk(self, prompt_idxs, prefix_h, suffix_h) -> None:
        os.makedirs(self.disk_folder, exist_ok=True)
        prefix_c = None if prefix_h is None else prefix_h.to("cpu")
        suffix_c = suffix_h.to("cpu")
        for row, idx in enumerate(prompt_idxs):
            ppath, spath = self._paths(idx)
            _save_npy(spath, suffix_c[row])
            if prefix_c is not None:
                _save_npy(ppath, prefix_c[row])

    def _fetch_disk(self, prompt_idxs, with_prefix: bool):
        prefixes, suffixes = [], []
        for idx in prompt_idxs:
            ppath, spath = self._paths(idx)
            suffixes.append(_load_npy(spath, self.dtype))
            if with_prefix:
                prefixes.append(_load_npy(ppath, self.dtype))
        prefix = torch.stack(prefixes) if with_prefix else None
        return prefix, torch.stack(suffixes)

    def store(self, block_id, prompt_idxs: list[int], prefix_h, suffix_h) -> None:
        if self.location == "gpu":
            self._mem[block_id] = (prefix_h, suffix_h)
        elif self.location == "cpu":
            if (
                self.max_in_cpu is not None
                and self._cpu_prompts + len(prompt_idxs) > self.max_in_cpu
            ):
                self._spilled.add(block_id)
                self._store_disk(prompt_idxs, prefix_h, suffix_h)
                return
            self._cpu_prompts += len(prompt_idxs)
            self._mem[block_id] = (
                None if prefix_h is None else prefix_h.to("cpu"),
                suffix_h.to("cpu"),
            )
        else:
            self._store_disk(prompt_idxs, prefix_h, suffix_h)

    def fetch(self, block_id, prompt_idxs: list[int], with_prefix: bool = True):
        if self.location == "disk" or block_id in self._spilled:
            self._spilled.discard(block_id)
            prefix, suffix = self._fetch_disk(prompt_idxs, with_prefix)
        else:
            prefix, suffix = self._mem.pop(block_id)
            if self.location == "cpu":
                self._cpu_prompts -= len(prompt_idxs)
            if not with_prefix:
                prefix = None
        suffix = suffix.to(self.device)
        if prefix is not None:
            prefix = prefix.to(self.device)
        return prefix, suffix

    def clear(self) -> None:
        self._mem.clear()
        self._spilled.clear()
        self._cpu_prompts = 0


__all__ = ["ActivationStore"]
