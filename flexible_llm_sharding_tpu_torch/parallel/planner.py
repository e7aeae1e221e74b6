"""Shard planning for one device (the JAX package's ``parallel/planner.py``,
single-device part): the execution list — embed, decoder layers, norm,
lm_head — cut into contiguous shards of ``layer_num_per_shard`` layers with
``np.array_split`` sizes, and the reference's ``num_batch`` prompt ranges."""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """One device's shards, each a tuple of global layer indices."""

    shards: tuple[tuple[int, ...], ...]
    n_layers: int

    @property
    def num_local_layers(self) -> int:
        return sum(len(s) for s in self.shards)


def _array_split_sizes(n: int, parts: int) -> list[int]:
    """Sizes produced by ``np.array_split(np.arange(n), parts)``."""
    base, extra = divmod(n, parts)
    return [base + 1] * extra + [base] * (parts - extra)


def plan_shards_dp(n_layers: int, layer_num_per_shard: int) -> ShardPlan:
    """Contiguous shards, ``ceil(n_layers / layer_num_per_shard)`` of them."""
    num_shards = math.ceil(n_layers / layer_num_per_shard)
    shards, start = [], 0
    for size in _array_split_sizes(n_layers, num_shards):
        shards.append(tuple(range(start, start + size)))
        start += size
    return ShardPlan(shards=tuple(shards), n_layers=n_layers)


def batch_ranges(num_prompts: int, num_batch: int) -> list[tuple[int, int]]:
    """``num_batch`` pieces of ``num_prompts // num_batch`` prompts, the
    remainder folded into the last piece."""
    ends = [num_prompts // num_batch * i for i in range(1, num_batch)] + [num_prompts]
    return list(zip([0] + ends[:-1], ends))


__all__ = ["ShardPlan", "batch_ranges", "plan_shards_dp"]
