"""chip_smoke.py's library yardsticks compute their kernels' functions.

Each kernel's ``library_ms`` times one ``scaled_dot_product_attention`` call
on inputs its yardstick builds (the KV a query sees concatenated, a bool
mask). Here, on the CPU in float32, each yardstick's output equals the
kernel's plain version on the same seeded inputs at small, ragged sizes,
within atol 1e-5 (float32 summation order).
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa

_SMOKE = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
_spec = importlib.util.spec_from_file_location("chip_smoke", _SMOKE)
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

B, S, LP, LS, T, HD = 2, 3, 19, 10, 4, 64


def _inputs(nq: int, nkv: int) -> dict:
    rng = np.random.default_rng(7)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    return {
        "q_prefix": rnd(B, LP, nq, HD), "kp": rnd(B, LP, nkv, HD), "vp": rnd(B, LP, nkv, HD),
        "q_suffix": rnd(B, S, LS, nq, HD), "ks": rnd(B, S, LS, nkv, HD),
        "vs": rnd(B, S, LS, nkv, HD), "q_dec": rnd(B, S, 1, nq, HD),
        "kg": rnd(B, S, T, nkv, HD), "vg": rnd(B, S, T, nkv, HD),
        "plen": torch.tensor([7, LP], dtype=torch.int32),
        "eos": torch.tensor([[0, 4, 9], [3, 9, 1]], dtype=torch.int32),
        "t": 2,
    }


@pytest.mark.parametrize("nq,nkv", [(4, 2), (4, 4)], ids=["gqa", "mha"])
@pytest.mark.parametrize("kernel", fa.KERNELS)
def test_yardstick_equals_plain_version(kernel, nq, nkv):
    args, kw = chip_smoke._calls(_inputs(nq, nkv), None)[kernel]
    want = fa.PLAIN[kernel](*args, **kw)
    sdpa = chip_smoke.YARDSTICKS[kernel](*args)
    assert sdpa["enable_gqa"] == (nq != nkv)
    got = chip_smoke.run_yardstick(sdpa, want)
    assert got.shape == want.shape
    assert torch.allclose(got, want, atol=1e-5, rtol=0)


def test_past_limit_rows_match_the_decode_limits():
    x = _inputs(4, 2)
    past = chip_smoke._past_limits(x)
    assert past["kp"].tolist()[0] == [j >= 7 for j in range(LP)]
    assert not past["kp"][1].any()
    assert past["ks"][1, 2].tolist() == [j > 1 for j in range(LS)]
    assert past["kg"][0, 0].tolist() == [j > 2 for j in range(T)]


LOCAL = [{"window": 3}, {"window": 8}, {"chunk": 4}, {"window": 3, "local_on": False}]


@pytest.mark.parametrize("local", LOCAL, ids=["window3", "window8", "chunk4", "window3-off"])
@pytest.mark.parametrize("kernel", fa.KERNELS)
def test_local_yardstick_equals_plain_version(kernel, local):
    """With a window or chunk (the SDPA mask's local clause at the kernels'
    absolute positions). Lengths keep every query row seeing a key, as the
    timed yardsticks need: plen 19 for both prompts, no causal padding."""
    x = {**_inputs(4, 2), "plen": torch.tensor([LP, LP], dtype=torch.int32)}
    args, kw = chip_smoke._calls(x, None, local)[kernel]
    want = fa.PLAIN[kernel](*args, **kw)
    got = chip_smoke.run_yardstick(chip_smoke.YARDSTICKS[kernel](*args, **local), want)
    assert torch.allclose(got, want, atol=1e-5, rtol=0)


def test_local_bounds_count_only_pairs_in_the_window():
    """Without a local form the mask-based count is the closed form; a
    window of 1 leaves one pair per real query row."""
    case = {"B": 2, "S": 3, "Ls": LS, "Lp": LP, "T": T, "t": 2, "nq": 4, "nkv": 2, "hd": HD,
            "plen": [7, LP], "eos": [[0, 4, 9], [3, 9, 1]]}
    work = chip_smoke._work(case)
    assert work["flash_causal_attention"][0] == sum(min(i + 1, p) for p in (7, LP) for i in range(LP))
    assert work["flash_decode_attention"][0] == sum(7 + e + 1 + 3 for e in (0, 4, 9)) + sum(
        LP + e + 1 + 3 for e in (3, 9, 1))
    one = chip_smoke._work({**case, "local": {"window": 1}})
    assert one["flash_causal_attention"][0] == 7 + LP  # each row sees itself, if real
    assert one["flash_decode_attention"][0] == 2 * S  # the new token's own generated slot
    assert one["flash_prefix_shared_attention"] == (2 * S * LS, 2 * S * LS)


@pytest.mark.parametrize("local", [{"window": 1024}, {}], ids=["local", "global"])
def test_gemma3_12b_bounds_equal_the_27b_rows(local):
    """Gemma-3-12B's heads (16 x 256 query, 8 x 256 KV) do the work of
    Gemma-3-27B's (32 x 128, 16 x 128) on the same prompts: chip_smoke.py's
    bounds for the hd-256 rows equal those of the hd-128 rows."""
    prompts = chip_smoke.make_prompts(8, 2048, 4, 32, seed=1)
    c27 = chip_smoke.main_path_case(prompts, 4, nq=32, nkv=16, hd=128)
    c12 = chip_smoke.main_path_case(prompts, 4, nq=16, nkv=8, hd=256)
    b27 = chip_smoke._bounds({**c27, "local": local})
    b12 = chip_smoke._bounds({**c12, "local": local})
    for kernel in b27:
        assert b12[kernel][1] == b27[kernel][1]
        assert b12[kernel][0] == pytest.approx(b27[kernel][0], rel=1e-12)


def test_cross_check_models_cover_the_families():
    """The float32 card-vs-CPU check runs every family the port carries
    (the MoE ones and DeepSeek's MLA at qk 192 / v 128 too), at head dims
    256 and 96 too, every rope scaling, and binds a window in each windowed
    one."""
    cfgs = chip_smoke.cross_configs()
    assert {c.model_type for c in cfgs.values()} == {
        "llama", "gemma", "gemma3_text", "phi3", "qwen2", "qwen3", "mistral", "mixtral", "qwen3_moe",
        "deepseek_v3"}
    assert {c.head_dim for c in cfgs.values()} == {64, 96, 128, 192, 256}
    assert {(c.head_dim, c.v_dim) for c in cfgs.values() if c.kv_lora_rank} == {(192, 128)}
    assert {c.rope_scaling_kind for c in cfgs.values()} == {None, "linear", "llama3", "yarn", "longrope"}
    assert all(c.sliding_window in (None, 32) for c in cfgs.values())


def _mla_inputs(nq: int, nkv: int) -> dict:
    """The scoring inputs at MLA's head dims: Q/K 192, V 128."""
    rng = np.random.default_rng(8)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    return {**_inputs(nq, nkv), "q_prefix": rnd(B, LP, nq, 192), "kp": rnd(B, LP, nkv, 192),
            "vp": rnd(B, LP, nkv, 128), "q_suffix": rnd(B, S, LS, nq, 192),
            "ks": rnd(B, S, LS, nkv, 192), "vs": rnd(B, S, LS, nkv, 128)}


@pytest.mark.parametrize("local", [{}, *LOCAL], ids=["global", "window3", "window8", "chunk4", "window3-off"])
@pytest.mark.parametrize("kernel", ["flash_causal_attention", "flash_prefix_shared_attention"])
def test_mla_yardstick_equals_plain_version(kernel, local):
    """At MLA's (192, 128) the SDPA yardstick (V of its own head dim) gives
    the plain version's 128 columns; the decode kernel has no MLA call."""
    x = {**_mla_inputs(4, 4), "plen": torch.tensor([LP, LP], dtype=torch.int32)}
    calls = chip_smoke._calls(x, None, local)
    assert "flash_decode_attention" not in calls
    args, kw = calls[kernel]
    want = fa.PLAIN[kernel](*args, **kw)
    assert want.shape[-1] == 128
    got = chip_smoke.run_yardstick(chip_smoke.YARDSTICKS[kernel](*args, **local), want)
    assert torch.allclose(got, want, atol=1e-5, rtol=0)


def test_mla_bounds_count_qk_and_pv_at_their_own_dims():
    """FLOPs 2 * (hd + hd_v) per visible pair and bytes at each dim: the
    DeepSeek-V3 main path's causal pass is held by its products (about 1.48
    ms), the prefix-shared pass by its bytes (about 0.50 ms); with hd_v = hd
    the bounds are the 4 * hd ones."""
    prompts = chip_smoke.make_prompts(8, 2048, 4, 32, seed=1)
    mla = chip_smoke.main_path_case(prompts, 2, nq=128, nkv=128, hd=192, hd_v=128)
    bounds = chip_smoke._bounds(mla)
    assert bounds["flash_causal_attention"][1] == "operations"
    assert bounds["flash_causal_attention"][0] == pytest.approx(1.4773, rel=1e-3)
    assert bounds["flash_prefix_shared_attention"][1] == "bytes"
    assert bounds["flash_prefix_shared_attention"][0] == pytest.approx(0.5010, rel=1e-3)
    pairs = chip_smoke._work(mla)["flash_causal_attention"][0]
    assert bounds["flash_causal_attention"][0] == pytest.approx(
        2 * 320 * 128 * pairs / chip_smoke.PEAK_BF16_FLOPS * 1e3, rel=1e-12)
    eq = chip_smoke._bounds({**mla, "hd_v": 192})
    assert eq["flash_causal_attention"][0] == pytest.approx(
        4 * 192 * 128 * pairs / chip_smoke.PEAK_BF16_FLOPS * 1e3, rel=1e-12)
