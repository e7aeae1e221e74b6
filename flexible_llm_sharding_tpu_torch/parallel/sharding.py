"""A one-axis device mesh: the part of the JAX package's
``parallel/sharding.py`` the sequence-parallel (``sp``) path needs.

A JAX ``Mesh`` is a grid of chips that XLA programs run on as one SPMD
program; here a mesh is a list of devices that the long-context path loops
over rank by rank (``ops/ring_attention.py``, ``runtime/longcontext.py``).
A list may name one device several times (``[cuda:0] * 4``): its ranks
then share that device's memory, and a hop between them moves nothing.

A tensor sharded over the mesh is a list of blocks, one per rank, block
``r`` on ``mesh.devices[r]`` (:func:`shard`, :func:`gather`); a tree
replicated over the mesh is one copy per distinct device, listed per rank
(:func:`replicate`). Tensor parallelism's layer specs and the Megatron
placement are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from flexible_llm_sharding_tpu_torch.config import indexed_device, resolve_device


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """One named axis over ``devices`` (rank r on ``devices[r]``)."""

    axis: str
    devices: tuple[torch.device, ...]

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> list[torch.device]:
        """The mesh's devices, each named once, in rank order."""
        return list(dict.fromkeys(self.devices))

    def slot(self, rank: int) -> int:
        """Index of rank ``rank``'s device in :attr:`distinct`."""
        return self.distinct.index(self.devices[rank])


def make_mesh(shape: dict[str, int] | None = None,
              devices: Sequence | None = None) -> DeviceMesh:
    """A mesh of ``shape`` (axis name -> size) over ``devices``.

    ``devices`` defaults to every visible card (a run without one raises,
    as every entry point of the port does unless the CPU is asked for);
    ``shape`` None is a ``dp`` axis over all of them, and a size of -1
    takes them all. The mesh takes the first ``size`` devices; fewer raise
    "needs N devices, have M". One axis only (tensor parallelism's grids
    are not ported)."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [indexed_device(d) for d in devices]
    if shape is None:
        shape = {"dp": len(devices)}
    if len(shape) != 1:
        raise ValueError(f"mesh shape {shape}: only one axis is supported")
    ((axis, size),) = shape.items()
    if size == -1:
        size = len(devices)
    if size < 1:
        raise ValueError(f"mesh shape {shape}: the axis size must be >= 1")
    if size > len(devices):
        raise ValueError(f"mesh shape {{{axis!r}: {size}}} needs {size} devices, "
                         f"have {len(devices)}")
    return DeviceMesh(axis, tuple(devices[:size]))


def shard(x: torch.Tensor, mesh: DeviceMesh) -> list[torch.Tensor]:
    """``x`` split along its first dimension into ``mesh.size`` equal
    blocks, block r on rank r's device. A length the axis does not divide
    raises ValueError."""
    n = mesh.size
    if x.shape[0] % n:
        raise ValueError(f"sequence length {x.shape[0]} not divisible by {mesh.axis}={n}")
    return [blk.to(dev) for blk, dev in zip(torch.chunk(x, n, dim=0), mesh.devices)]


def gather(blocks: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """The blocks of a sharded tensor joined along their first dimension on
    ``device`` (default: block 0's)."""
    dev = blocks[0].device if device is None else torch.device(device)
    return torch.cat([b.to(dev) for b in blocks], dim=0)


def _tree_to(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def replicate(tree: Any, mesh: DeviceMesh) -> list[Any]:
    """``tree`` (a dict/list of tensors) per rank: one copy on each
    distinct device (the copy on the tree's own device is the tree
    itself), ranks on one device sharing it."""
    copies = [_tree_to(tree, dev) for dev in mesh.distinct]
    return [copies[mesh.slot(r)] for r in range(mesh.size)]


__all__ = ["DeviceMesh", "gather", "make_mesh", "replicate", "shard"]
