"""The port's multi-device planning against the JAX package's
``parallel/planner.py``: the DP, MP and stage-order plans, the prompt split
and the batch ranges over a grid of (execution layers, layers per shard,
devices), MP's round-up padding stages where there are more stages than
shards; and the device choice and plan checks around them."""

import itertools

import pytest
import torch

from flexible_llm_sharding_tpu.parallel import planner as jplanner
from flexible_llm_sharding_tpu_torch.config import FrameworkConfig, indexed_device
from flexible_llm_sharding_tpu_torch.parallel import planner
from flexible_llm_sharding_tpu_torch.runtime.orchestration import pick_devices

# (execution layers, layers per shard, devices): 7 is a 4-layer model's
# list (embed, 4 decoders, norm, head), 3 a 1-layer one's.
GRID = [(n, lps, d) for n, lps, d in itertools.product((3, 7, 10, 35), (1, 2, 3), (1, 2, 3, 4, 8))
        if not (n == 35 and lps == 3)]


def _plan(p) -> tuple:
    return (p.shards, p.n_layers, p.device_rank, p.num_devices, p.num_local_layers)


@pytest.mark.parametrize("n_layers,lps,n_dev", GRID, ids=[f"{n}-{l}-{d}" for n, l, d in GRID])
def test_plans_equal_jax(n_layers, lps, n_dev):
    assert planner._mp_num_shards(n_layers, lps, n_dev) == jplanner._mp_num_shards(
        n_layers, lps, n_dev)
    assert planner.global_stage_order(n_layers, lps, n_dev) == jplanner.global_stage_order(
        n_layers, lps, n_dev)
    for rank in range(n_dev):
        mp, jmp = (planner.plan_shards_mp(n_layers, lps, rank, n_dev),
                   jplanner.plan_shards_mp(n_layers, lps, rank, n_dev))
        dp, jdp = (planner.plan_shards_dp(n_layers, lps, rank, n_dev),
                   jplanner.plan_shards_dp(n_layers, lps, rank, n_dev))
        assert _plan(mp) == _plan(jmp) and _plan(dp) == _plan(jdp)
        for layer in range(n_layers + 1):
            assert mp.owns_layer(layer) == jmp.owns_layer(layer)
            assert dp.owns_layer(layer) == jdp.owns_layer(layer)
    # The stages cover every layer once, in order; the rest are padding.
    stages = planner.global_stage_order(n_layers, lps, n_dev)
    assert [i for _, _, s in stages for i in s] == list(range(n_layers))
    assert len(stages) % n_dev == 0


def test_more_stages_than_shards_pads():
    """7 layers in 3 devices' stages of 3: 3 stages, the last one short; of
    1 over 8 devices: 8 stages, the eighth empty (a padding stage)."""
    assert [s for _, _, s in planner.global_stage_order(7, 1, 8)][-1] == ()
    assert [r for _, r, _ in planner.global_stage_order(7, 1, 4)] == [0, 1, 2, 3] * 2
    assert planner.plan_shards_mp(7, 1, 3, 4).shards == ((3,), ())


@pytest.mark.parametrize("n_prompts,n_dev,n_batch", [(0, 3, 1), (2, 8, 1), (5, 3, 2), (9, 4, 4),
                                                     (12, 5, 3)])
def test_prompt_ranges_equal_jax(n_prompts, n_dev, n_batch):
    assert planner.split_prompts_dp(n_prompts, n_dev) == jplanner.split_prompts_dp(n_prompts,
                                                                                   n_dev)
    assert planner.batch_ranges(n_prompts, n_batch) == jplanner.batch_ranges(n_prompts, n_batch)


@pytest.mark.parametrize("num_devices,want", [(0, 1), (1, 1), (3, 3)])
def test_pick_devices_on_the_cpu(num_devices, want):
    """The CPU counterpart of the JAX tests' virtual devices: that many CPU
    stages or ranks."""
    devs = pick_devices(FrameworkConfig(device="cpu", num_devices=num_devices))
    assert devs == [torch.device("cpu")] * want


def test_devices_and_plans_are_checked():
    with pytest.raises(ValueError, match="num_devices"):
        FrameworkConfig(device="cpu", num_devices=-1)
    assert indexed_device("cpu") == torch.device("cpu")
    assert indexed_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
