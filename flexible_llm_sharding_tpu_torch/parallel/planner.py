"""Shard planning (the JAX package's ``parallel/planner.py``): how the
execution list — embed, decoder layers, norm, lm_head — is cut into shards
and assigned to devices.

- **DP and one device**: ``ceil(n_layers / layer_num_per_shard)``
  contiguous shards with ``np.array_split`` sizes (the first
  ``n % num_shards`` shards get one layer more), all streamed by each
  device.
- **MP** (the interleaved pipeline): the shard count is rounded up to a
  multiple of the device count, and device ``k`` takes shards
  ``k, k + N, k + 2N, ...``; a round-up shard may be empty (a padding
  stage).

DP splits the prompts with ``np.array_split`` semantics too, and the
reference's ``num_batch`` prompt ranges fold the remainder into the last
piece.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """One device's shards, each a tuple of global layer indices;
    ``device_rank`` of ``num_devices`` names the device within a DP group
    or an MP pipeline (DP tags its disk activation files with it)."""

    shards: tuple[tuple[int, ...], ...]
    n_layers: int
    device_rank: int = 0
    num_devices: int = 1

    @property
    def num_local_layers(self) -> int:
        return sum(len(s) for s in self.shards)

    def owns_layer(self, layer_idx: int) -> bool:
        return any(layer_idx in s for s in self.shards)


def _array_split_sizes(n: int, parts: int) -> list[int]:
    """Sizes produced by ``np.array_split(np.arange(n), parts)``."""
    base, extra = divmod(n, parts)
    return [base + 1] * extra + [base] * (parts - extra)


def _contiguous_shards(n_layers: int, num_shards: int) -> list[tuple[int, ...]]:
    out, start = [], 0
    for size in _array_split_sizes(n_layers, num_shards):
        out.append(tuple(range(start, start + size)))
        start += size
    return out


def plan_shards_dp(n_layers: int, layer_num_per_shard: int, device_rank: int = 0,
                   num_devices: int = 1) -> ShardPlan:
    """Contiguous shards, ``ceil(n_layers / layer_num_per_shard)`` of them,
    all streamed by this device."""
    num_shards = math.ceil(n_layers / layer_num_per_shard)
    return ShardPlan(shards=tuple(_contiguous_shards(n_layers, num_shards)), n_layers=n_layers,
                     device_rank=device_rank, num_devices=num_devices)


def _mp_num_shards(n_layers: int, layer_num_per_shard: int, num_devices: int) -> int:
    """The MP shard count: rounded up to a multiple of ``num_devices`` so
    every device gets as many stages."""
    return math.ceil(math.ceil(n_layers / layer_num_per_shard) / num_devices) * num_devices


def plan_shards_mp(n_layers: int, layer_num_per_shard: int, device_rank: int,
                   num_devices: int) -> ShardPlan:
    """One device's MP stages: every ``num_devices``-th shard from
    ``device_rank``."""
    shards = _contiguous_shards(n_layers, _mp_num_shards(n_layers, layer_num_per_shard,
                                                         num_devices))
    return ShardPlan(shards=tuple(shards[device_rank::num_devices]), n_layers=n_layers,
                     device_rank=device_rank, num_devices=num_devices)


def global_stage_order(n_layers: int, layer_num_per_shard: int, num_devices: int):
    """Every MP stage in execution order as (stage_idx, device_rank,
    layer_tuple)."""
    shards = _contiguous_shards(n_layers, _mp_num_shards(n_layers, layer_num_per_shard,
                                                         num_devices))
    return [(i, i % num_devices, s) for i, s in enumerate(shards)]


def split_prompts_dp(num_prompts: int, num_devices: int) -> list[tuple[int, int]]:
    """[start, end) prompt ranges per device, ``np.array_split`` sizes."""
    ranges, start = [], 0
    for size in _array_split_sizes(num_prompts, num_devices):
        ranges.append((start, start + size))
        start += size
    return ranges


def batch_ranges(num_prompts: int, num_batch: int) -> list[tuple[int, int]]:
    """``num_batch`` pieces of ``num_prompts // num_batch`` prompts, the
    remainder folded into the last piece."""
    ends = [num_prompts // num_batch * i for i in range(1, num_batch)] + [num_prompts]
    return list(zip([0] + ends[:-1], ends))


__all__ = ["ShardPlan", "batch_ranges", "global_stage_order", "plan_shards_dp", "plan_shards_mp",
           "split_prompts_dp"]
