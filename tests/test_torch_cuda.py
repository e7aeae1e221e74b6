"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and skip without one. This file imports neither
JAX nor the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

import os

import numpy as np
import pytest
import torch

from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 2e-2), torch.float16: (2e-2, 2e-2)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, dtype, *shape):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    assert torch.isfinite(got).all()
    assert ((got.float() - want).abs() <= atol + rtol * want.abs()).all()


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("nq,nkv,hd", [(4, 2, 64), (8, 8, 128)])
def test_kernels_match_plain(gen, dtype, nq, nkv, hd):
    b, lp, s, ls, tg = 2, 130, 3, 70, 5
    plen = torch.tensor([130, 41], dtype=torch.int32, device="cuda")
    eos = torch.tensor([[0, 69, 12], [5, 6, 7]], dtype=torch.int32, device="cuda")
    q, k, v = (_rnd(gen, dtype, b, lp, n, hd) for n in (nq, nkv, nkv))
    qs, ks, vs = (_rnd(gen, dtype, b, s, ls, n, hd) for n in (nq, nkv, nkv))
    qd = _rnd(gen, dtype, b, s, 1, nq, hd)
    kg, vg = (_rnd(gen, dtype, b, s, tg, nkv, hd) for _ in range(2))
    f = lambda *a: tuple(x.float() if x.is_floating_point() else x for x in a)  # noqa: E731
    fa.reset_launch_counts()
    for softcap in (None, 20.0):
        _close(fa.flash_causal_attention(q, k, v, plen, softcap=softcap),
               fa.causal_attention_plain(*f(q, k, v, plen), softcap=softcap), dtype)
        _close(fa.flash_prefix_shared_attention(qs, k, v, ks, vs, plen, softcap=softcap),
               fa.prefix_shared_attention_plain(*f(qs, k, v, ks, vs, plen), softcap=softcap),
               dtype)
        for t in (0, tg - 1):
            _close(fa.flash_decode_attention(qd, k, v, ks, vs, kg, vg, plen, eos, t,
                                             softcap=softcap),
                   fa.decode_attention_plain(*f(qd, k, v, ks, vs, kg, vg, plen, eos), t,
                                             softcap=softcap), dtype)
    torch.cuda.synchronize()
    assert fa.launch_counts() == {
        "flash_causal_attention": 2, "flash_prefix_shared_attention": 2,
        "flash_decode_attention": 4,
    }


def _f32(*a):
    return tuple(x.float() if x.is_floating_point() else x for x in a)


# (S, Lp, Ls, nq, nkv, hd, prefix_len, dtype, softcap): odd S leaves one of
# the scoring kernel's two consumer warpgroups idle; query lengths 1, 64,
# 130 and 576 are no multiple of its 128-row causal tile or fill it; prefix
# lengths sit around its 64-key tiles; MQA, GQA, fp16, hd 64 and softcap.
EDGES = [
    (1, 1, 1, 8, 1, 128, [0, 1], torch.bfloat16, None),
    (3, 64, 130, 4, 2, 64, [63, 64], torch.float16, None),
    (3, 130, 64, 32, 8, 128, [65, 130], torch.bfloat16, 30.0),
    (4, 576, 64, 32, 8, 128, [1, 576], torch.float16, None),
    (1, 576, 576, 8, 1, 64, [0, 513], torch.bfloat16, None),
]


@pytest.mark.parametrize("edge", EDGES, ids=lambda e: f"S{e[0]}-Lp{e[1]}-Ls{e[2]}-{e[3]}/{e[4]}-hd{e[5]}")
def test_scoring_kernels_edge_cases(gen, edge):
    s, lp, ls, nq, nkv, hd, plen, dtype, softcap = edge
    plen = torch.tensor(plen, dtype=torch.int32, device="cuda")
    q, k, v = (_rnd(gen, dtype, 2, lp, n, hd) for n in (nq, nkv, nkv))
    qs, ks, vs = (_rnd(gen, dtype, 2, s, ls, n, hd) for n in (nq, nkv, nkv))
    _close(fa.flash_causal_attention(q, k, v, plen, softcap=softcap),
           fa.causal_attention_plain(*_f32(q, k, v, plen), softcap=softcap), dtype)
    _close(fa.flash_prefix_shared_attention(qs, k, v, ks, vs, plen, softcap=softcap),
           fa.prefix_shared_attention_plain(*_f32(qs, k, v, ks, vs, plen), softcap=softcap), dtype)


def _decode_kv(gen, dtype, b, s, lp, ls, tg, nkv, hd, plen, eos, t, hd_v=None):
    """Random decode K/V with every row past its source's limit (prefix rows
    at or past plen, suffix rows past eos, generated rows past t) zero, and
    the same K/V with those rows NaN: two dicts keyed kp, vp, ks, vs, kg, vg.
    V has head dim ``hd_v`` (default hd)."""
    prefix = (torch.arange(lp, device="cuda")[None, :] >= plen[:, None])[..., None, None]
    suffix = (torch.arange(ls, device="cuda")[None, None, :] > eos[..., None])[..., None, None]
    gen_past = torch.arange(tg, device="cuda")[None, None, :, None, None] > t
    zero, nan = {}, {}
    for name, shape, past in (("p", (b, lp, nkv, hd), prefix), ("s", (b, s, ls, nkv, hd), suffix),
                              ("g", (b, s, tg, nkv, hd), gen_past)):
        for kind in "kv":
            if kind == "v" and hd_v is not None:
                shape = (*shape[:-1], hd_v)
            x = _rnd(gen, dtype, *shape).masked_fill(past, 0.0)
            zero[kind + name], nan[kind + name] = x, x.masked_fill(past, float("nan"))
    return zero, nan


DECODE_KV = ("kp", "vp", "ks", "vs", "kg", "vg")


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 128), (torch.float16, 64)])
def test_nan_past_limits_never_reaches_the_output(gen, dtype, hd):
    """K/V rows at or past each source's limit filled with NaN: every kernel
    gives what the plain version gives with those rows zeroed."""
    b, s, lp, ls, tg, t, nq, nkv = 2, 3, 130, 70, 5, 2, 8, 2
    plen = torch.tensor([65, 0], dtype=torch.int32, device="cuda")
    eos = torch.tensor([[0, 69, 12], [5, 6, 7]], dtype=torch.int32, device="cuda")
    q = _rnd(gen, dtype, b, lp, nq, hd)
    qs = _rnd(gen, dtype, b, s, ls, nq, hd)
    qd = _rnd(gen, dtype, b, s, 1, nq, hd)
    zero, nan = _decode_kv(gen, dtype, b, s, lp, ls, tg, nkv, hd, plen, eos, t)
    _close(fa.flash_causal_attention(q, nan["kp"], nan["vp"], plen),
           fa.causal_attention_plain(*_f32(q, zero["kp"], zero["vp"], plen)), dtype)
    # Every suffix row is visible to the scoring form, so its suffix KV stays finite.
    _close(fa.flash_prefix_shared_attention(qs, nan["kp"], nan["vp"], zero["ks"], zero["vs"], plen),
           fa.prefix_shared_attention_plain(*_f32(qs, zero["kp"], zero["vp"], zero["ks"],
                                                  zero["vs"], plen)), dtype)
    _close(fa.flash_decode_attention(qd, *(nan[n] for n in DECODE_KV), plen, eos, t),
           fa.decode_attention_plain(*_f32(qd, *(zero[n] for n in DECODE_KV)), plen, eos, t), dtype)


# (S, nq, nkv, hd, T, t, prefix_len, suffix_eos, dtype, softcap) at Lp 130
# and Ls 64. The decode kernel takes 16 query rows (suffix, head) per block
# and 64-key tiles: S*g above 16 spreads a KV head's rows over several
# blocks (S 7 at g 3 and S 2 at g 32 split a suffix between two), S 1,
# prefix lengths 0/1/63/64/65/130 around the tiles, eos 0 and Ls-1, t 0 and
# T-1, hd 64 with fp16, float32 and softcap.
DECODE_EDGES = [
    (5, 32, 4, 128, 5, 4, [130, 65], [[0, 63, 9, 31, 62], [5, 0, 63, 1, 40]], torch.bfloat16, None),
    (3, 8, 1, 128, 5, 0, [64, 63], [[63, 0, 12], [5, 6, 7]], torch.bfloat16, None),
    (7, 12, 4, 128, 3, 1, [65, 130], [[0, 9, 18, 27, 36, 45, 63]] * 2, torch.bfloat16, None),
    (2, 32, 1, 128, 4, 3, [1, 0], [[0, 63], [63, 31]], torch.bfloat16, None),
    (1, 32, 32, 128, 5, 2, [0, 1], [[0], [63]], torch.bfloat16, None),
    (4, 8, 2, 64, 5, 4, [0, 130], [[0, 63, 20, 33], [63, 0, 1, 2]], torch.float16, None),
    (3, 8, 4, 128, 5, 0, [65, 64], [[0, 63, 17], [31, 32, 0]], torch.float32, None),
    (3, 4, 2, 64, 2, 1, [130, 0], [[63, 0, 1], [2, 63, 0]], torch.float32, None),
    (4, 32, 8, 128, 5, 4, [63, 130], [[0, 63, 5, 6], [7, 8, 63, 0]], torch.bfloat16, 30.0),
]


@pytest.mark.parametrize("nan_past_limits", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize(
    "edge", DECODE_EDGES,
    ids=lambda e: f"S{e[0]}-{e[1]}/{e[2]}-hd{e[3]}-{str(e[8])[6:]}{'-softcap' if e[9] else ''}")
def test_decode_kernel_edge_cases(gen, edge, nan_past_limits):
    s, nq, nkv, hd, tg, t, plen, eos, dtype, softcap = edge
    b, lp, ls = 2, 130, 64
    plen = torch.tensor(plen, dtype=torch.int32, device="cuda")
    eos = torch.tensor(eos, dtype=torch.int32, device="cuda")
    q = _rnd(gen, dtype, b, s, 1, nq, hd)
    zero, nan = _decode_kv(gen, dtype, b, s, lp, ls, tg, nkv, hd, plen, eos, t)
    fed = nan if nan_past_limits else zero
    _close(fa.flash_decode_attention(q, *(fed[n] for n in DECODE_KV), plen, eos, t, softcap=softcap),
           fa.decode_attention_plain(*_f32(q, *(zero[n] for n in DECODE_KV)), plen, eos, t,
                                     softcap=softcap), dtype)


def test_zero_valid_length_rows_are_zero(gen):
    q = _rnd(gen, torch.bfloat16, 1, 64, 2, 64)
    out = fa.flash_causal_attention(q, q, q, torch.zeros(1, dtype=torch.int32, device="cuda"))
    assert torch.count_nonzero(out) == 0


def test_cuda_wrappers_refuse_window(gen):
    """A window and a chunk at once, or a window below 1, never launch."""
    q = _rnd(gen, torch.bfloat16, 1, 64, 2, 64)
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    fa.reset_launch_counts()
    with pytest.raises(ValueError):
        fa.flash_causal_attention(q, q, q, one, window=16, chunk=32)
    with pytest.raises(ValueError):
        fa.flash_causal_attention(q, q, q, one, window=0)
    assert fa.launch_counts()["flash_causal_attention"] == 0


# Local forms: windows around the 64-key tiles (1, 48, 64, 65, 130), chunks
# (32, 64, 100), and a window with the per-layer toggle off.
LOCAL = [({"window": w}, f"window{w}") for w in (1, 48, 64, 65, 130)] + [
    ({"chunk": c}, f"chunk{c}") for c in (32, 64, 100)] + [
    ({"window": 48, "local_on": False}, "window48-off")]


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("local", [kw for kw, _ in LOCAL], ids=[name for _, name in LOCAL])
def test_local_attention_kernels_match_plain(gen, dtype, local):
    """Every kernel with a window, a chunk or the toggle off, GQA 32/16, with
    and without NaN past every limit. Prompt 1's prefix (41 of 130 rows)
    leaves causal padding rows with no visible key under a small window;
    the decode suffixes' different eos put their bounds in different tiles."""
    b, s, lp, ls, tg, t, nq, nkv, hd = 2, 3, 130, 70, 5, 4, 32, 16, 128
    plen = torch.tensor([130, 41], dtype=torch.int32, device="cuda")
    eos = torch.tensor([[0, 69, 12], [5, 66, 37]], dtype=torch.int32, device="cuda")
    q = _rnd(gen, dtype, b, lp, nq, hd)
    qs = _rnd(gen, dtype, b, s, ls, nq, hd)
    qd = _rnd(gen, dtype, b, s, 1, nq, hd)
    zero, nan = _decode_kv(gen, dtype, b, s, lp, ls, tg, nkv, hd, plen, eos, t)
    for fed in (zero, nan):
        _close(fa.flash_causal_attention(q, fed["kp"], fed["vp"], plen, **local),
               fa.causal_attention_plain(*_f32(q, zero["kp"], zero["vp"], plen), **local), dtype)
        _close(fa.flash_prefix_shared_attention(qs, fed["kp"], fed["vp"], zero["ks"], zero["vs"], plen,
                                                **local),
               fa.prefix_shared_attention_plain(*_f32(qs, zero["kp"], zero["vp"], zero["ks"], zero["vs"],
                                                      plen), **local), dtype)
        _close(fa.flash_decode_attention(qd, *(fed[n] for n in DECODE_KV), plen, eos, t, **local),
               fa.decode_attention_plain(*_f32(qd, *(zero[n] for n in DECODE_KV)), plen, eos, t,
                                         **local), dtype)


def test_local_launches_are_counted(gen):
    """The local count moves only for launches with the window on."""
    q = _rnd(gen, torch.bfloat16, 1, 64, 2, 64)
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    fa.reset_launch_counts()
    fa.flash_causal_attention(q, q, q, one, window=16)
    fa.flash_causal_attention(q, q, q, one, window=16, local_on=False)
    fa.flash_causal_attention(q, q, q, one, chunk=32, local_on=True)
    assert fa.launch_counts()["flash_causal_attention"] == 3
    assert fa.local_launch_counts()["flash_causal_attention"] == 2


def test_local_on_tensor_raises_on_cuda(gen):
    q = _rnd(gen, torch.bfloat16, 1, 64, 2, 64)
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        fa.flash_causal_attention(q, q, q, one, window=16,
                                  local_on=torch.tensor(True, device="cuda"))


# Head dims 256 (the kernels' own instantiations) and 96 (the hd-128 ones on
# unpadded tensors, columns past 96 zero-filled): every kernel in every
# dtype, with NaN past every limit and without, plain and with a window, a
# chunk, the toggle off and a softcap.
HEAD_DIM_FORMS = [({}, "plain"), ({"window": 48}, "window48"), ({"window": 130}, "window130"),
                  ({"chunk": 64}, "chunk64"), ({"window": 48, "local_on": False}, "window48-off"),
                  ({"softcap": 30.0}, "softcap30")]


@pytest.mark.parametrize("form", [f for f, _ in HEAD_DIM_FORMS], ids=[n for _, n in HEAD_DIM_FORMS])
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("hd", [256, 96])
def test_head_dims_256_and_96_match_plain(gen, hd, dtype, form):
    b, s, lp, ls, tg, t, nq, nkv = 2, 3, 200, 70, 6, 4, 16, 8
    plen = torch.tensor([200, 41], dtype=torch.int32, device="cuda")
    eos = torch.tensor([[0, 69, 12], [5, 66, 37]], dtype=torch.int32, device="cuda")
    q = _rnd(gen, dtype, b, lp, nq, hd)
    qs = _rnd(gen, dtype, b, s, ls, nq, hd)
    qd = _rnd(gen, dtype, b, s, 1, nq, hd)
    zero, nan = _decode_kv(gen, dtype, b, s, lp, ls, tg, nkv, hd, plen, eos, t)
    fa.reset_launch_counts()
    for fed in (zero, nan):
        _close(fa.flash_causal_attention(q, fed["kp"], fed["vp"], plen, **form),
               fa.causal_attention_plain(*_f32(q, zero["kp"], zero["vp"], plen), **form), dtype)
        _close(fa.flash_prefix_shared_attention(qs, fed["kp"], fed["vp"], zero["ks"], zero["vs"], plen,
                                                **form),
               fa.prefix_shared_attention_plain(*_f32(qs, zero["kp"], zero["vp"], zero["ks"], zero["vs"],
                                                      plen), **form), dtype)
        _close(fa.flash_decode_attention(qd, *(fed[n] for n in DECODE_KV), plen, eos, t, **form),
               fa.decode_attention_plain(*_f32(qd, *(zero[n] for n in DECODE_KV)), plen, eos, t,
                                         **form), dtype)
    torch.cuda.synchronize()
    assert fa.launch_counts() == dict.fromkeys(fa.KERNELS, 2)


# Multi-head latent attention's (qk 192, v 128) in the scoring kernels: GQA 1
# as DeepSeek runs it, every dtype, with NaN past every limit and without,
# plain, softcap and every local form; the hd-128 edge lengths (with GQA as
# well); and the decode kernel refusing it.
MLA_FORMS = [({}, "plain"), ({"softcap": 30.0}, "softcap30")] + LOCAL


@pytest.mark.parametrize("form", [f for f, _ in MLA_FORMS], ids=[n for _, n in MLA_FORMS])
@pytest.mark.parametrize("dtype", list(TOL))
def test_mla_dims_match_plain(gen, dtype, form):
    b, s, lp, ls, tg, t, nq = 2, 3, 200, 70, 6, 4, 16
    plen = torch.tensor([200, 41], dtype=torch.int32, device="cuda")
    eos = torch.tensor([[0, 69, 12], [5, 66, 37]], dtype=torch.int32, device="cuda")
    q = _rnd(gen, dtype, b, lp, nq, 192)
    qs = _rnd(gen, dtype, b, s, ls, nq, 192)
    zero, nan = _decode_kv(gen, dtype, b, s, lp, ls, tg, nq, 192, plen, eos, t, hd_v=128)
    fa.reset_launch_counts()
    for fed in (zero, nan):
        out = fa.flash_causal_attention(q, fed["kp"], fed["vp"], plen, **form)
        assert out.shape == (b, lp, nq, 128)
        _close(out, fa.causal_attention_plain(*_f32(q, zero["kp"], zero["vp"], plen), **form), dtype)
        _close(fa.flash_prefix_shared_attention(qs, fed["kp"], fed["vp"], zero["ks"], zero["vs"], plen,
                                                **form),
               fa.prefix_shared_attention_plain(*_f32(qs, zero["kp"], zero["vp"], zero["ks"], zero["vs"],
                                                      plen), **form), dtype)
    torch.cuda.synchronize()
    assert fa.dim_launch_counts() == {"flash_causal_attention": {(192, 128): 2},
                                      "flash_prefix_shared_attention": {(192, 128): 2},
                                      "flash_decode_attention": {}}


@pytest.mark.parametrize("edge", EDGES, ids=lambda e: f"S{e[0]}-Lp{e[1]}-Ls{e[2]}-{e[3]}/{e[4]}")
def test_mla_scoring_edge_cases(gen, edge):
    s, lp, ls, nq, nkv, _, plen, dtype, softcap = edge
    plen = torch.tensor(plen, dtype=torch.int32, device="cuda")
    q, k, v = _rnd(gen, dtype, 2, lp, nq, 192), _rnd(gen, dtype, 2, lp, nkv, 192), _rnd(gen, dtype, 2, lp, nkv, 128)
    qs, ks, vs = (_rnd(gen, dtype, 2, s, ls, n, d) for n, d in ((nq, 192), (nkv, 192), (nkv, 128)))
    _close(fa.flash_causal_attention(q, k, v, plen, softcap=softcap),
           fa.causal_attention_plain(*_f32(q, k, v, plen), softcap=softcap), dtype)
    _close(fa.flash_prefix_shared_attention(qs, k, v, ks, vs, plen, softcap=softcap),
           fa.prefix_shared_attention_plain(*_f32(qs, k, v, ks, vs, plen), softcap=softcap), dtype)


def test_mla_dims_never_reach_the_decode_kernel(gen):
    """MLA decode is the plain op's (as in the JAX package): the decode
    kernel refuses a V head dim of its own, and so do the scoring kernels
    for any pair but (192, 128)."""
    plen = torch.tensor([5], dtype=torch.int32, device="cuda")
    eos = torch.zeros(1, 1, dtype=torch.int32, device="cuda")
    q = _rnd(gen, torch.bfloat16, 1, 1, 1, 4, 192)
    k, v = _rnd(gen, torch.bfloat16, 1, 8, 4, 192), _rnd(gen, torch.bfloat16, 1, 8, 4, 128)
    ks, vs = _rnd(gen, torch.bfloat16, 1, 1, 8, 4, 192), _rnd(gen, torch.bfloat16, 1, 1, 8, 4, 128)
    fa.reset_launch_counts()
    with pytest.raises(NotImplementedError):
        fa.flash_decode_attention(q, k, v, ks, vs, ks, vs, plen, eos, 0)
    with pytest.raises(NotImplementedError):
        fa.flash_causal_attention(k, k, k[..., :64].contiguous(), plen)
    assert fa.launch_counts() == dict.fromkeys(fa.KERNELS, 0)


# The float32 scoring kernel's edges: blocks of 64 query rows over 64-key
# tiles, rows past a limit zero-filled by its copies. (Lp, Ls, prefix_len,
# S, hd, hd_v, n_q, n_kv, keywords): query lengths 1, 63, 65 and 576 (in
# both forms), prefix lengths around the key tiles (0, 1, 62-65, 127-129,
# 513), odd S, every instantiation (hd 64, 96, 128, 256 and MLA's
# (192, 128)), GQA, softcap, and windows and a chunk whose bounds split a
# block's 64 rows.
F32_EDGES = [
    (1, 1, [0, 1], 3, 128, 128, 8, 2, {}),
    (63, 63, [63, 62], 1, 64, 64, 8, 8, {}),
    (65, 65, [64, 65], 3, 96, 96, 8, 4, {}),
    (576, 64, [513, 129], 5, 128, 128, 32, 8, {}),
    (129, 576, [128, 127], 2, 256, 256, 16, 8, {}),
    (200, 70, [200, 41], 3, 192, 128, 16, 16, {}),
    (130, 64, [65, 130], 4, 128, 128, 8, 8, {"softcap": 30.0}),
    (576, 64, [576, 300], 3, 128, 128, 32, 16, {"window": 40}),
    (200, 70, [200, 41], 3, 256, 256, 8, 2, {"window": 100}),
    (200, 65, [199, 64], 3, 192, 128, 8, 8, {"window": 65}),
    (300, 64, [300, 77], 3, 64, 64, 8, 4, {"chunk": 48}),
    (130, 63, [1, 0], 1, 96, 96, 8, 1, {"window": 1}),
]


@pytest.mark.parametrize("edge", F32_EDGES,
                         ids=lambda e: f"Lp{e[0]}-Ls{e[1]}-S{e[3]}-hd{e[4]}/{e[5]}-{e[6]}/{e[7]}-"
                                       + ("-".join(f"{k}{v}" for k, v in e[8].items()) or "plain"))
def test_float32_scoring_at_the_tile_edges(gen, edge):
    """Both scoring forms in float32 against their plain versions, with the
    prefix K/V past each prompt's limit zero and then NaN."""
    lp, ls, plen, s, hd, hd_v, nq, nkv, form = edge
    dt = torch.float32
    plen = torch.tensor(plen, dtype=torch.int32, device="cuda")
    past = (torch.arange(lp, device="cuda")[None, :] >= plen[:, None])[..., None, None]
    q = _rnd(gen, dt, 2, lp, nq, hd)
    k = _rnd(gen, dt, 2, lp, nkv, hd).masked_fill(past, 0.0)
    v = _rnd(gen, dt, 2, lp, nkv, hd_v).masked_fill(past, 0.0)
    qs = _rnd(gen, dt, 2, s, ls, nq, hd)
    ks, vs = _rnd(gen, dt, 2, s, ls, nkv, hd), _rnd(gen, dt, 2, s, ls, nkv, hd_v)
    want_causal = fa.causal_attention_plain(q, k, v, plen, **form)
    want_prefix = fa.prefix_shared_attention_plain(qs, k, v, ks, vs, plen, **form)
    fa.reset_launch_counts()
    for fed_k, fed_v in ((k, v), (k.masked_fill(past, float("nan")), v.masked_fill(past, float("nan")))):
        _close(fa.flash_causal_attention(q, fed_k, fed_v, plen, **form), want_causal, dt)
        _close(fa.flash_prefix_shared_attention(qs, fed_k, fed_v, ks, vs, plen, **form), want_prefix, dt)
    torch.cuda.synchronize()
    assert fa.launch_counts() == {"flash_causal_attention": 2, "flash_prefix_shared_attention": 2,
                                  "flash_decode_attention": 0}


@pytest.mark.parametrize("location,max_in_cpu", [("cpu", None), ("cpu", 1), ("disk", None)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_activation_store_stages_into_page_locked_memory(gen, tmp_path, location, max_in_cpu,
                                                         dtype):
    """cpu blocks are copied into page-locked host tensors behind an event,
    at most one block pending; every location round-trips bit for bit."""
    from flexible_llm_sharding_tpu_torch.runtime.activations import ActivationStore

    store = ActivationStore(location, torch.device("cuda"), dtype, str(tmp_path),
                            max_in_cpu=max_in_cpu)
    data = {b: (_rnd(gen, dtype, 2, 33, 16), _rnd(gen, dtype, 2, 3, 9, 16)) for b in range(3)}
    for b, (p, s) in data.items():
        store.store(b, [2 * b, 2 * b + 1], p, s)
        if location == "cpu" and max_in_cpu is None:
            staged = store._mem[b]
            assert staged.suffix.is_pinned() and staged.event is not None
            assert store._pending == [b]
    for b, (p, s) in data.items():
        got_p, got_s = store.fetch(b, [2 * b, 2 * b + 1])
        assert got_s.is_cuda and torch.equal(got_p, p) and torch.equal(got_s, s)
    store.clear()


# -- the decode modes: one CUDA graph per block against the loops ------------

class _WordTokenizer:
    """A word-hash tokenizer over a 512-token vocabulary (no model assets)."""

    eos_token = pad_token = "</s>"
    pad_token_id = 2
    padding_side = "right"

    def _ids(self, text: str) -> list[int]:
        import zlib

        return [1] + [3 + zlib.crc32(w.encode()) % 509 for w in text.split()]

    def decode(self, ids) -> str:
        return "".join(f" tok{int(i)}" for i in torch.as_tensor(ids).reshape(-1))

    def __call__(self, text, max_length=None, padding=False, **kw):
        if isinstance(text, str):
            return {"input_ids": self._ids(text)[:max_length]}
        batch = [self._ids(t)[:max_length] for t in text]
        if padding:
            width = max(len(b) for b in batch)
            batch = [b + [self.pad_token_id] * (width - len(b)) for b in batch]
        return {"input_ids": batch}


_DECODE_PROMPTS = [
    ("the cat sat on the mat " * 12, (" the cat sat", " on the mat", " a")),
    ("alpha beta gamma delta " * 20, (" beta gamma alpha", " delta")),
    ("one two three four five six", (" seven eight",)),
]
_SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_attention_heads=4,
              num_key_value_heads=2)
_DECODE_MODELS = {
    "llama": dict(model_type="llama", **_SMALL, num_hidden_layers=3, head_dim=128),
    # Gemma 3: layers 0-1 local (a window of 32 that binds), layer 2 global.
    "gemma3": dict(model_type="gemma3_text", **_SMALL, num_hidden_layers=3, head_dim=128,
                   query_pre_attn_scalar=128, sliding_window=32, rope_theta=1000000.0,
                   rope_local_base_freq=10000.0,
                   layer_types=["sliding_attention", "sliding_attention", "full_attention"]),
    # Llama 4, dense: layers 0-1 chunked (32, binding), layer 2 NoPE with
    # temperature-tuned queries (floor scale 4: the temperature moves at
    # every fourth position).
    "llama4": dict(model_type="llama4_text", **_SMALL, num_hidden_layers=3, head_dim=128,
                   num_local_experts=0, attention_chunk_size=32, floor_scale=4,
                   layer_types=["chunked_attention", "chunked_attention", "full_attention"],
                   no_rope_layers=[1, 1, 0]),
}


def _decode_params(name):
    """Seeded bf16 weights of one of ``_DECODE_MODELS``: (cfg, params)."""
    from flexible_llm_sharding_tpu_torch.config import LlamaConfig

    cfg = LlamaConfig.from_dict(_DECODE_MODELS[name])
    g = torch.Generator().manual_seed(3)

    def w(*shape, scale=None):
        scale = scale if scale is not None else (2.0 / (shape[-2] + shape[-1])) ** 0.5
        return (torch.randn(*shape, generator=g) * scale).to(torch.bfloat16)

    def norm(n):
        return w(n, scale=0.1) if cfg.norm_unit_offset else torch.ones(n, dtype=torch.bfloat16)

    d, f, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    layers = []
    for _ in range(cfg.num_hidden_layers):
        layer = {"input_layernorm": {"scale": norm(d)}, "post_attention_layernorm": {"scale": norm(d)},
                 "attn": {"wq": w(d, nq * hd), "wk": w(d, nkv * hd), "wv": w(d, nkv * hd),
                          "wo": w(nq * hd, d)},
                 "mlp": {"gate": w(d, f), "up": w(d, f), "down": w(f, d)}}
        if cfg.qk_norm:
            layer["attn"].update(q_norm=norm(hd), k_norm=norm(hd))
        if cfg.ffw_sandwich_norms:
            layer.update(pre_feedforward_layernorm={"scale": norm(d)},
                         post_feedforward_layernorm={"scale": norm(d)})
        layers.append(layer)
    params = {"embed": {"embedding": w(cfg.vocab_size, d, scale=0.02)}, "layers": layers,
              "norm": {"scale": norm(d)}}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": w(d, cfg.vocab_size, scale=0.02)}
    return cfg, params


def _decode_model(tmp_path, name):
    from flexible_llm_sharding_tpu_torch.utils.checkpoint import save_params

    cfg, params = _decode_params(name)
    path = tmp_path / name
    save_params(params, str(path), cfg)
    return str(path)


def _decode_run(model_dir, n_gen=5, **modes):
    from flexible_llm_sharding_tpu_torch.config import FrameworkConfig
    from flexible_llm_sharding_tpu_torch.runtime import hostcache
    from flexible_llm_sharding_tpu_torch.runtime.decode import DecodeGenerator

    hostcache.reset_process_cache()
    graph_ok = modes.pop("graph_ok", None)
    cfg = FrameworkConfig(model_path=model_dir, dtype="bfloat16", num_gen_token=n_gen,
                          block_size=2, kv_cache=True, **modes)
    gen = DecodeGenerator(cfg, device=torch.device("cuda"), tokenizer=_WordTokenizer())
    if graph_ok is not None:
        gen._graph_ok = graph_ok
    fa.reset_launch_counts()
    scores, updated = gen(list(_DECODE_PROMPTS))
    torch.cuda.synchronize()
    counts = (fa.launch_counts(), fa.local_launch_counts(), fa.dim_launch_counts())
    return scores, updated, gen.stats, counts


@pytest.mark.parametrize("name", list(_DECODE_MODELS))
def test_captured_fused_steps_equal_the_loops_bit_for_bit(gen, tmp_path, name):
    """bf16 on the card: the steps replayed from one CUDA graph per block
    equal the uncaptured device loop, the per-step loop over resident
    weights and the streamed per-step loop, bit for bit."""
    model_dir = _decode_model(tmp_path, name)
    graph, graph_up, graph_stats, _ = _decode_run(model_dir)
    runs = {
        "device loop": _decode_run(model_dir, graph_ok=False),
        "per-step loop": _decode_run(model_dir, decode_fused="off"),
        "streamed": _decode_run(model_dir, decode_resident="off"),
    }
    assert (graph_stats["decode_resident"], graph_stats["decode_fused"],
            graph_stats["decode_graph"], graph_stats["decode_kv_on_device"]) == (1, 1, 1, 1)
    assert runs["device loop"][2]["decode_graph"] == 0 and runs["device loop"][2]["decode_fused"] == 1
    assert runs["per-step loop"][2]["decode_fused"] == 0
    assert runs["streamed"][2]["decode_resident"] == 0
    for tag, (scores, updated, _, _) in runs.items():
        assert updated == graph_up, tag
        for a, b in zip(graph, scores):
            assert np.array_equal(a, b), tag


@pytest.mark.parametrize("name", list(_DECODE_MODELS))
def test_replays_count_the_decode_kernel(gen, tmp_path, name):
    """A graph's launches count once per replay: the captured run counts the
    uncaptured loop's launches plus its warm-up step (one launch per layer
    and block), window on and off alike; the scoring kernels are the
    prefill's in both."""
    model_dir = _decode_model(tmp_path, name)
    *_, (counts, local, dims) = _decode_run(model_dir)
    *_, (loop_counts, loop_local, loop_dims) = _decode_run(model_dir, graph_ok=False)
    n_layers, n_blocks = 3, 2
    warm = n_layers * n_blocks
    assert loop_counts["flash_decode_attention"] == n_layers * n_blocks * 4
    assert counts["flash_decode_attention"] == loop_counts["flash_decode_attention"] + warm
    assert dims["flash_decode_attention"] == {(128, 128): counts["flash_decode_attention"]}
    for k in ("flash_causal_attention", "flash_prefix_shared_attention"):
        assert counts[k] == loop_counts[k] == n_layers * n_blocks
    if name in ("gemma3", "llama4"):  # two of three layers local
        assert local["flash_decode_attention"] == loop_local["flash_decode_attention"] + 2 * n_blocks
        assert 0 < local["flash_decode_attention"] < counts["flash_decode_attention"]
    else:
        assert local == dict.fromkeys(fa.KERNELS, 0)


# -- quantized streaming and the residency tier on the card --------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,shape", [("int8", (192, 96)), ("int4", (192, 96)),
                                        ("int8", (4, 128, 64)), ("int4", (4, 128, 64))])
def test_device_dequant_equals_host_dequant(gen, kind, shape, dtype):
    """The weight source's dequant on the card equals the host dequant bit
    for bit, q8 and q4, 2-D kernels and expert stacks, float32 and bf16."""
    from flexible_llm_sharding_tpu_torch.utils import checkpoint

    w = torch.randn(*shape, generator=torch.Generator().manual_seed(len(shape))) * 0.3
    flat = checkpoint._quantize_flat({"k": w}, kind)
    node = {"q4" if kind == "int4" else "q8": flat["k"], "s": flat[[k for k in flat if k != "k"][0]]}
    host = checkpoint.dequantize(node).to(dtype)
    card = checkpoint.dequantize({k: v.cuda() for k, v in node.items()}, dtype)
    assert card.dtype == dtype and torch.equal(card.cpu(), host)


def _quant_model(tmp_path, kind="int4"):
    from flexible_llm_sharding_tpu_torch.utils.checkpoint import requantize_native

    model_dir = _decode_model(tmp_path, "llama")
    out = str(tmp_path / f"llama_{kind}")
    requantize_native(model_dir, out, dtype=kind)
    return model_dir, out


def test_dequant_runs_on_the_upload_stream_before_the_event(gen, tmp_path, monkeypatch):
    """Every quantized leaf-group of a streamed shard is dequantized on the
    source's upload stream, and what the consumer receives holds only
    compute-dtype tensors."""
    from flexible_llm_sharding_tpu_torch.runtime import executor
    from flexible_llm_sharding_tpu_torch.utils import checkpoint
    from flexible_llm_sharding_tpu_torch.utils.checkpoint import layer_names_for

    _, qdir = _quant_model(tmp_path)
    streams = []
    real = checkpoint.dequantize

    def spy(node, dtype=torch.float32):
        streams.append(torch.cuda.current_stream().cuda_stream)
        return real(node, dtype)

    monkeypatch.setattr(checkpoint, "dequantize", spy)
    names = layer_names_for(3)
    src = executor.ShardWeightSource(qdir, names, [(i,) for i in range(len(names))],
                                     torch.bfloat16, torch.device("cuda"), prefetch_depth=1)
    leaves = []
    try:
        for _, segments in src:
            leaves += executor._tree_leaves([p for _, p in segments])
    finally:
        src.close()
    assert streams and set(streams) == {src._stream.cuda_stream}
    assert src._stream.cuda_stream != torch.cuda.current_stream().cuda_stream
    assert all(t.is_cuda and t.dtype in (torch.bfloat16, torch.int32, torch.int64, torch.bool)
               for t in leaves)


@pytest.mark.parametrize("quantized", [False, True])
def test_pinned_run_equals_unpinned_bit_for_bit(gen, tmp_path, quantized):
    """bf16 on the card: scoring with every layer pinned, and with part of
    them, equals the unpinned run bit for bit; the pinned run streams the
    pinned layers once."""
    from flexible_llm_sharding_tpu_torch.config import FrameworkConfig
    from flexible_llm_sharding_tpu_torch.runtime import hostcache, residency
    from flexible_llm_sharding_tpu_torch.runtime.executor import StreamingExecutor
    from flexible_llm_sharding_tpu_torch.utils.checkpoint import layer_names_for

    model_dir, qdir = _quant_model(tmp_path)
    model_dir = qdir if quantized else model_dir

    def run(pin_gb):
        hostcache.reset_process_cache()
        residency.reset_process_tier()
        cfg = FrameworkConfig(model_path=model_dir, dtype="bfloat16", block_size=2,
                              hbm_pin_gb=pin_gb)
        ex = StreamingExecutor(cfg, device=torch.device("cuda"), tokenizer=_WordTokenizer())
        out = [ex(list(_DECODE_PROMPTS)) for _ in range(2)]
        return out, ex.stats_history

    (off, off_stats) = run(0.0)
    sizes = residency.layer_stream_bytes(model_dir, layer_names_for(3))
    for pin_gb in (1.0, (sizes[0] + sizes[4] + sizes[5] + sizes[1]) / 1e9):
        on, on_stats = run(pin_gb)
        for a, b in zip(off, on):
            for x, y in zip(a, b):
                assert np.array_equal(x, y)
        warm, cold = on_stats[1], off_stats[1]
        assert warm["streamed_bytes"] + warm["stream_bytes_saved"] == cold["streamed_bytes"]
        assert warm["pinned_bytes"] > 0 and warm["peak_mem_gb"] >= warm["pinned_bytes"] / 1e9
    residency.reset_process_tier()


# -- Llama 4: its kernel shapes, a NoPE layer in a captured graph, the score sink

# Scout's heads (40 over 8 KV heads of 128: a GQA group of 5, so the decode
# kernel's 16-row blocks split suffix 3's group across two blocks) at
# shorter lengths; its chunk made to bind.
_L4 = dict(b=2, lp=576, s=4, ls=64, nq=40, nkv=8, hd=128, tg=3)


@pytest.mark.parametrize("local", [{}, {"chunk": 256}, {"chunk": 256, "local_on": False}],
                         ids=["global", "chunk-256", "chunk-off"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_at_llama4_shapes_match_plain(gen, dtype, local):
    c = _L4
    plen = torch.tensor([576, 333], dtype=torch.int32, device="cuda")
    eos = torch.tensor([[0, 63, 17, 40], [5, 1, 62, 33]], dtype=torch.int32, device="cuda")
    q, k, v = (_rnd(gen, dtype, c["b"], c["lp"], n, c["hd"]) for n in (c["nq"], c["nkv"], c["nkv"]))
    qs, ks, vs = (_rnd(gen, dtype, c["b"], c["s"], c["ls"], n, c["hd"])
                  for n in (c["nq"], c["nkv"], c["nkv"]))
    qd = _rnd(gen, dtype, c["b"], c["s"], 1, c["nq"], c["hd"])
    kg, vg = (_rnd(gen, dtype, c["b"], c["s"], c["tg"], c["nkv"], c["hd"]) for _ in range(2))
    fa.reset_launch_counts()
    _close(fa.flash_causal_attention(q, k, v, plen, **local),
           fa.causal_attention_plain(*_f32(q, k, v, plen), **local), dtype)
    _close(fa.flash_prefix_shared_attention(qs, k, v, ks, vs, plen, **local),
           fa.prefix_shared_attention_plain(*_f32(qs, k, v, ks, vs, plen), **local), dtype)
    for t in (0, c["tg"] - 1):
        _close(fa.flash_decode_attention(qd, k, v, ks, vs, kg, vg, plen, eos, t, **local),
               fa.decode_attention_plain(*_f32(qd, k, v, ks, vs, kg, vg, plen, eos), t, **local),
               dtype)
    torch.cuda.synchronize()
    assert fa.launch_counts() == {"flash_causal_attention": 1, "flash_prefix_shared_attention": 1,
                                  "flash_decode_attention": 2}


def test_nope_layer_graph_follows_the_position_across_replays(gen):
    """A Llama 4 NoPE decode layer captured once in a CUDA graph, replayed
    with other prefix lengths written into its device tensor: each replay
    equals the uncaptured layer at those positions, and the temperature is
    in it (without temperature tuning the layer gives other values)."""
    from flexible_llm_sharding_tpu_torch.config import LlamaConfig
    from flexible_llm_sharding_tpu_torch.models import llama

    cfg = LlamaConfig.from_dict({**_DECODE_MODELS["llama4"], "num_hidden_layers": 1,
                                 "layer_types": ["full_attention"], "no_rope_layers": [0]})
    assert cfg.layer_rope == (False,) and cfg.attn_temperature_tuning
    d, nq, nkv, hd, f = cfg.hidden_size, 4, 2, 128, cfg.intermediate_size
    b, s, lp, ls, tg = 2, 3, 192, 16, 4

    def w(*shape):
        return torch.randn(*shape, generator=gen, device="cuda") * (2.0 / (shape[-2] + shape[-1])) ** 0.5

    ones = torch.ones(d, device="cuda")
    params = {"input_layernorm": {"scale": ones}, "post_attention_layernorm": {"scale": ones},
              "attn": {"wq": w(d, nq * hd), "wk": w(d, nkv * hd), "wv": w(d, nkv * hd),
                       "wo": w(nq * hd, d)},
              "mlp": {"gate": w(d, f), "up": w(d, f), "down": w(f, d)}}
    x = torch.randn(b, s, 1, d, generator=gen, device="cuda")
    kv0 = {"kp": torch.randn(b, lp, nkv, hd, generator=gen, device="cuda"),
           "vp": torch.randn(b, lp, nkv, hd, generator=gen, device="cuda"),
           "ks": torch.randn(b, s, ls, nkv, hd, generator=gen, device="cuda"),
           "vs": torch.randn(b, s, ls, nkv, hd, generator=gen, device="cuda"),
           "kg": torch.zeros(b, s, tg, nkv, hd, device="cuda"),
           "vg": torch.zeros(b, s, tg, nkv, hd, device="cuda")}
    eos = torch.tensor([[3, 15, 0], [7, 7, 12]], dtype=torch.int32, device="cuda")
    plen = torch.tensor([192, 41], dtype=torch.int32, device="cuda")
    t = 1

    def eager(c, lens):
        kv = {k: v.clone() for k, v in kv0.items()}
        return llama.decode_step_layer([params], c, x, [kv], lens, eos, t, sliding=False,
                                       rope_on=False, use_pallas=True)

    kv_g = {k: v.clone() for k, v in kv0.items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        llama.decode_step_layer([params], cfg, x, [{k: v.clone() for k, v in kv0.items()}], plen,
                                eos, t, sliding=False, rope_on=False, use_pallas=True)
        graph = torch.cuda.CUDAGraph()
        with fa.graph_capture(), torch.cuda.graph(graph, stream=side):
            out = llama.decode_step_layer([params], cfg, x, [kv_g], plen, eos, t, sliding=False,
                                          rope_on=False, use_pallas=True)
    torch.cuda.current_stream().wait_stream(side)
    plain = LlamaConfig.from_dict({**_DECODE_MODELS["llama4"], "num_hidden_layers": 1,
                                   "layer_types": ["full_attention"], "no_rope_layers": [0],
                                   "attn_temperature_tuning": False})
    for lens in ([192, 41], [100, 3], [5, 180]):
        plen.copy_(torch.tensor(lens, dtype=torch.int32))
        for k in ("kg", "vg"):
            kv_g[k].copy_(kv0[k])
        graph.replay()
        torch.cuda.synchronize()
        want = eager(cfg, plen.clone())
        assert torch.equal(out, want), lens
        assert not torch.equal(want, eager(plain, plen.clone())), lens


def test_score_sink_copies_on_a_side_stream_without_a_wait_per_block(gen, tmp_path, monkeypatch):
    """The head's scores reach the host through page-locked copies on the
    sink's side stream, and at the default cap the host waits on none of
    them before the run's end; caps 1 and 16 give the same scores bit for
    bit."""
    from flexible_llm_sharding_tpu_torch.config import FrameworkConfig
    from flexible_llm_sharding_tpu_torch.runtime import executor, hostcache

    model_dir = _decode_model(tmp_path, "llama")
    streams, waits = [], []
    finalizing = [False]
    real_copy, real_resolve = executor._ScoreCopy._copy, executor._ScoreCopy.resolve
    real_finalize = executor.ScoreSink.finalize

    def spy_copy(self, block_scores):
        streams.append(torch.cuda.current_stream().cuda_stream)
        assert self.host.is_pinned()
        return real_copy(self, block_scores)

    def spy_resolve(self):
        waits.append(finalizing[0])
        return real_resolve(self)

    def spy_finalize(self):
        finalizing[0] = True
        return real_finalize(self)

    monkeypatch.setattr(executor._ScoreCopy, "_copy", spy_copy)
    monkeypatch.setattr(executor._ScoreCopy, "resolve", spy_resolve)
    monkeypatch.setattr(executor.ScoreSink, "finalize", spy_finalize)
    out = {}
    for cap in (16, 1):
        hostcache.reset_process_cache()
        cfg = FrameworkConfig(model_path=model_dir, dtype="bfloat16", block_size=1,
                              score_sink_max_device=cap)
        ex = executor.StreamingExecutor(cfg, device=torch.device("cuda"),
                                        tokenizer=_WordTokenizer())
        finalizing[0] = False
        del streams[:], waits[:]
        out[cap] = ex(list(_DECODE_PROMPTS))
        n_blocks = len(_DECODE_PROMPTS)
        assert len(streams) == n_blocks and len(set(streams)) == 1
        assert streams[0] != torch.cuda.current_stream().cuda_stream
        if cap == 16:
            assert waits == [True] * n_blocks  # every wait at the run's end
        else:
            assert waits.count(False) == n_blocks - 1
    for a, b in zip(out[16], out[1]):
        assert np.array_equal(a, b)


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    return tree.to("cuda")


@pytest.mark.parametrize("name", list(_DECODE_MODELS))
def test_suffix_only_layer_equals_the_full_layers_suffix_stream_in_bf16(gen, tmp_path, name):
    """The serving pool's reuse path: fed the full layer's own post-rope
    prefix KV, the suffix-only layer gives the suffix output and suffix KV
    of ``prefix_suffix_layer`` bit for bit, through the same
    prefix-shared kernel (one launch each)."""
    from flexible_llm_sharding_tpu_torch.config import LlamaConfig
    from flexible_llm_sharding_tpu_torch.models import llama
    from flexible_llm_sharding_tpu_torch.utils.checkpoint import load_layer

    model_dir = _decode_model(tmp_path, name)
    cfg = LlamaConfig.from_pretrained(model_dir)
    sliding, rope_on = llama.layer_sliding_pattern(cfg), llama.layer_rope_pattern(cfg)
    b, lp, s, ls = 2, 64, 3, 32
    ph = _rnd(gen, torch.bfloat16, b, lp, cfg.hidden_size)
    sh = _rnd(gen, torch.bfloat16, b, s, ls, cfg.hidden_size)
    plen = torch.tensor([64, 23], dtype=torch.int32, device="cuda")
    for i in range(cfg.num_hidden_layers):
        layer = _to_cuda(load_layer(model_dir, f"model.layers.{i}"))
        kw = dict(sliding=sliding[i], rope_on=rope_on[i], use_pallas=True)
        fa.reset_launch_counts()
        _, s_out, (kv,) = llama.prefix_suffix_layer([layer], cfg, ph, sh, plen, return_kv=True,
                                                    **kw)
        out, (kv_s,) = llama.suffix_only_layer([layer], cfg, [kv["kp"]], [kv["vp"]], sh, plen,
                                               **kw)
        torch.cuda.synchronize()
        assert fa.launch_counts()["flash_prefix_shared_attention"] == 2
        assert torch.equal(out, s_out)
        assert torch.equal(kv_s["ks"], kv["ks"]) and torch.equal(kv_s["vs"], kv["vs"])


def test_serve_engine_worker_thread_launches_the_three_kernels(gen, tmp_path):
    """A bf16 engine on cuda:0: its worker thread launches the causal and
    prefix-shared kernels for the first round's prefills, the prefix-shared
    kernel alone for the second round's (every wave reuses sealed pool
    entries) and the decode kernel for every decode sweep; both rounds'
    scores are equal bit for bit."""
    from flexible_llm_sharding_tpu_torch.config import FrameworkConfig, ServeConfig
    from flexible_llm_sharding_tpu_torch.runtime import kvpool
    from flexible_llm_sharding_tpu_torch.serve import ServeEngine

    kvpool.reset_process_pools()
    model_dir = _decode_model(tmp_path, "llama")
    cfg = FrameworkConfig(model_path=model_dir, dtype="bfloat16", block_size=2,
                          decode_resident="on", disk_folder=str(tmp_path / "d"))
    engine = ServeEngine(cfg, ServeConfig(max_wave_requests=1, default_max_new_tokens=4),
                         tokenizer=_WordTokenizer(), device=torch.device("cuda:0"))
    try:
        fa.reset_launch_counts()
        first = [engine.submit(p, sfx) for p, sfx in _DECODE_PROMPTS]
        first = [r.future.result(timeout=300) for r in first]
        counts_first = fa.launch_counts()
        second = [engine.submit(p, sfx) for p, sfx in _DECODE_PROMPTS]
        second = [r.future.result(timeout=300) for r in second]
        counts = fa.launch_counts()
        stats = engine.stats()
    finally:
        engine.shutdown(drain=True)
        kvpool.reset_process_pools()
    assert engine.error is None
    n, layers = len(_DECODE_PROMPTS), 3
    assert counts_first["flash_causal_attention"] == n * layers
    assert counts["flash_causal_attention"] == n * layers  # the second round prefilled no prefix
    assert counts["flash_prefix_shared_attention"] == 2 * n * layers
    assert counts["flash_decode_attention"] == 2 * n * layers * 3
    assert stats["kvpool"]["prefix_reuse_hits"] == n
    for a, b in zip(first, second):
        assert a.updated == b.updated and np.array_equal(a.scores, b.scores)


def test_serve_engine_kernel_library_failure_is_engine_fatal(gen, tmp_path, monkeypatch):
    """A kernel library that fails to build or load (an ``OSError`` from
    ``ctypes`` or the compiler's files) stops the engine through ``_fatal``
    before the first sweep: it is never taken for a recoverable sweep
    fault, and the queued request fails instead of being served."""
    from flexible_llm_sharding_tpu_torch.config import FrameworkConfig, ServeConfig
    from flexible_llm_sharding_tpu_torch.ops import cuda_build
    from flexible_llm_sharding_tpu_torch.runtime import kvpool
    from flexible_llm_sharding_tpu_torch.serve import ServeEngine
    from flexible_llm_sharding_tpu_torch.serve.request import ServeClosed

    def broken_library():
        raise OSError("cannot open shared object file")

    kvpool.reset_process_pools()
    monkeypatch.setattr(cuda_build, "library", broken_library)
    model_dir = _decode_model(tmp_path, "llama")
    cfg = FrameworkConfig(model_path=model_dir, dtype="bfloat16", block_size=2,
                          decode_resident="on", disk_folder=str(tmp_path / "d"))
    engine = ServeEngine(cfg, ServeConfig(default_max_new_tokens=2), tokenizer=_WordTokenizer(),
                         device=torch.device("cuda:0"), start=False)
    req = engine.submit(*_DECODE_PROMPTS[0])
    try:
        engine.start()
        assert engine.shutdown(drain=True, timeout=120)
    finally:
        kvpool.reset_process_pools()
    assert isinstance(engine.error, OSError)
    with pytest.raises(ServeClosed):
        req.future.result(timeout=1)
    assert engine.stats().get("engine_recoveries", 0) == 0


@pytest.mark.parametrize("name", ["llama", "gemma3"])
def test_forward_full_launches_the_causal_kernel_and_matches_the_cpu(gen, name):
    """The draft model's monolithic forward on the card: one causal launch
    per layer (gemma3's local layers with their window), float32 logits
    equal to the same forward on the CPU's plain attention."""
    from flexible_llm_sharding_tpu_torch.models import llama

    from flexible_llm_sharding_tpu_torch.runtime.executor import _tree_map

    cfg, params = _decode_params(name)
    params32 = _tree_map(lambda t: t.float(), params)
    on_card = _tree_map(lambda t: t.cuda(), params32)
    ids = torch.randint(3, cfg.vocab_size, (1, 128), generator=torch.Generator().manual_seed(1))
    fa.reset_launch_counts()
    got = llama.forward_full(on_card, cfg, ids.cuda(), use_pallas=True)
    torch.cuda.synchronize()
    counts, local = fa.launch_counts(), fa.local_launch_counts()
    want = llama.forward_full(params32, cfg, ids, use_pallas=True)
    assert counts["flash_causal_attention"] == cfg.num_hidden_layers
    assert local["flash_causal_attention"] == (2 if name == "gemma3" else 0)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert (got.cpu() - want).abs().max().item() <= 1e-4


def test_draft_model_whose_pin_fails_raises_and_does_not_stream(gen, tmp_path, monkeypatch):
    """A draft layer whose pin load fails stops the construction with the
    loader's error: the layers after it are never read, and nothing falls
    back to streaming."""
    from flexible_llm_sharding_tpu_torch.runtime import draft, executor

    model_dir = _decode_model(tmp_path, "llama")
    reads = []
    real = executor.ShardWeightSource.build_host_shard

    def failing(self, idxs):
        reads.append(tuple(idxs))
        if self.layer_names[idxs[0]] == "model.layers.1":
            raise executor.ShardLoadError("injected pin-load failure")
        return real(self, idxs)

    monkeypatch.setattr(executor.ShardWeightSource, "build_host_shard", failing)
    with pytest.raises(executor.ShardLoadError, match="injected"):
        draft.DraftModel(model_dir, torch.device("cuda:0"), torch.bfloat16, use_pallas=True)
    assert reads == [(0,), (1,), (2,)]


def test_lora_shift_on_cuda_matches_the_cpu(gen):
    """The grouped LoRA shift on CUDA tensors (float32 products, no TF32)
    against the same call on the CPU, in float32 and in bf16."""
    from flexible_llm_sharding_tpu_torch.adapters.apply import lora_shift
    from flexible_llm_sharding_tpu_torch.config import resolve_device

    resolve_device("cuda")  # float32 products without TF32, as the engine runs them
    g_cpu = torch.Generator().manual_seed(3)
    a = 0.02 * torch.randn(3, 256, 16, generator=g_cpu)
    b = 0.02 * torch.randn(3, 16, 256, generator=g_cpu)
    a[0] = b[0] = 0.0
    a[1, :, 8:] = b[1, 8:] = 0.0  # a rank-8 adapter padded to 16
    g = torch.tensor([1, 0, 2, 1])
    scale = torch.tensor([0.0, 1.0, 0.5])
    for dtype in (torch.float32, torch.bfloat16):
        h = torch.randn(4, 2, 40, 256, generator=g_cpu).to(dtype)
        want = lora_shift(h, a, b, g, scale)
        got = lora_shift(h.cuda(), a.cuda(), b.cuda(), g.cuda(), scale.cuda())
        assert got.dtype == dtype
        assert torch.equal(got[1].cpu(), h[1])  # the base row is untouched
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        assert (got.cpu().float() - want.float()).abs().max().item() <= tol


def test_lora_shift_rows_on_cuda_matches_the_cpu(gen):
    """The engine's form of the shift (``lora_shift_rows``: each row by its
    adapter's own factors) on CUDA tensors against the same call on the
    CPU, at the decoder loops' [rows, suffixes, positions, D] layout: ranks
    8 and 16 mixed in one call, a base row and a row of an adapter with no
    factors on this layer left untouched, in float32 and in bf16; the card's
    float32 rows within 1e-5 of the gathered form over padded stacks."""
    from flexible_llm_sharding_tpu_torch.adapters.apply import lora_shift, lora_shift_rows
    from flexible_llm_sharding_tpu_torch.config import resolve_device

    resolve_device("cuda")  # float32 products without TF32, as the engine runs them
    g_cpu = torch.Generator().manual_seed(5)
    d = 512
    pairs = {gi: (0.02 * torch.randn(d, r, generator=g_cpu),
                  0.02 * torch.randn(r, d, generator=g_cpu)) for gi, r in ((1, 8), (2, 16))}
    g = [2, 0, 1, 3, 1]  # group 3: an adapter without factors on this layer
    scale = torch.tensor([0.0, 2.0, 0.5, 1.0])
    on_card = {gi: (a.cuda(), b.cuda()) for gi, (a, b) in pairs.items()}
    for dtype in (torch.float32, torch.bfloat16):
        h = torch.randn(5, 2, 24, d, generator=g_cpu).to(dtype)
        want = lora_shift_rows(h, pairs, g, scale)
        got = lora_shift_rows(h.cuda(), on_card, g, scale.cuda())
        assert got.dtype == dtype and got.is_cuda
        for i in (1, 3):
            assert torch.equal(got[i].cpu(), h[i])
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        assert (got.cpu().float() - want.float()).abs().max().item() <= tol
        assert (got.cpu().float() - h.float()).abs().max().item() > 10 * tol  # the shift engages
    a = torch.zeros(4, d, 16)
    b = torch.zeros(4, 16, d)
    for gi, (pa, pb) in pairs.items():
        a[gi, :, :pa.shape[1]], b[gi, :pb.shape[0]] = pa, pb
    h = torch.randn(5, 2, 24, d, generator=g_cpu).cuda()
    gathered = lora_shift(h, a.cuda(), b.cuda(), torch.tensor(g).cuda(), scale.cuda())
    assert (lora_shift_rows(h, on_card, g, scale.cuda()) - gathered).abs().max().item() <= 1e-5


def test_adapter_wave_launches_the_three_kernels(gen, tmp_path):
    """A bf16 engine on the card serving two tenants and the base in one
    wave: all three kernels launch (the prefill's causal and prefix-shared,
    the decode sweeps' decode kernel), a tenant's scores differ from the
    base's on the same prompt, and the base row equals the same row of a
    base-only wave bit for bit."""
    from flexible_llm_sharding_tpu_torch.adapters import loader
    from flexible_llm_sharding_tpu_torch.adapters.registry import save_adapter
    from flexible_llm_sharding_tpu_torch.config import AdapterConfig, FrameworkConfig, ServeConfig
    from flexible_llm_sharding_tpu_torch.runtime import kvpool
    from flexible_llm_sharding_tpu_torch.serve import ServeEngine

    model_dir = _decode_model(tmp_path, "llama")
    rng = np.random.default_rng(5)
    root = str(tmp_path / "adapters")
    for name, rank in (("tenant-a", 4), ("tenant-b", 8)):
        save_adapter(root, name, {f"model.layers.{i}": (
            (0.05 * rng.standard_normal((256, rank))).astype(np.float32),
            (0.05 * rng.standard_normal((rank, 256))).astype(np.float32)) for i in range(3)})
    prompt = _DECODE_PROMPTS[0]
    outs = {}
    for tag, adapters, subs in (("on", AdapterConfig(dir=root), ["tenant-a", "tenant-b", None]),
                                ("off", AdapterConfig(), [None, None, None])):
        kvpool.reset_process_pools()
        loader.reset_process_store()
        cfg = FrameworkConfig(model_path=model_dir, dtype="bfloat16", block_size=4,
                              decode_resident="on", disk_folder=str(tmp_path / "d"),
                              adapters=adapters)
        engine = ServeEngine(cfg, ServeConfig(max_wave_requests=4, default_max_new_tokens=3),
                             tokenizer=_WordTokenizer(), device=torch.device("cuda:0"),
                             start=False)
        reqs = [engine.submit(*prompt, adapter_id=aid) for aid in subs]
        try:
            fa.reset_launch_counts()
            engine.start()
            outs[tag] = [r.future.result(timeout=300) for r in reqs]
            counts = fa.launch_counts()
            stats = engine.stats()
        finally:
            engine.shutdown(drain=True)
            kvpool.reset_process_pools()
            loader.reset_process_store()
        assert engine.error is None
        if tag == "on":
            assert all(counts[k] > 0 for k in fa.KERNELS), counts
            assert stats["adapter"]["delta_bytes"] > 0 and stats["adapter"]["applied_rows"] > 0
    on, off = outs["on"], outs["off"]
    assert not np.allclose(on[0].scores, on[2].scores)
    assert np.array_equal(on[2].scores, off[2].scores)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kvpool_export_restore_of_card_pages(gen, tmp_path, dtype):
    """Pages banked from the card (bf16 and fp16 KV copied to the host, as
    the engine banks them) export to checksummed files and restore in a
    fresh pool bit for bit, sealed; uploaded back they equal the card's."""
    from flexible_llm_sharding_tpu_torch.runtime import kvpool

    k, v = (_rnd(gen, dtype, 2, 64, 4, 128) for _ in range(2))
    ids = tuple(range(3, 53))

    def pool():
        return kvpool.KVPagePool(16, 1 << 30, spill_dir=str(tmp_path / "spill"))

    src = pool()
    h = src.acquire(ids, 50, 64, salt="tenant-a")
    src.contribute(h, (0, 0), k.cpu(), v.cpu())
    src.seal(h)
    refs = src.export_entry(h, str(tmp_path / "wal"), ids, salt="tenant-a")
    src.release(h)
    assert refs is not None and refs["dtype"] == str(dtype).removeprefix("torch.")
    dst = pool()
    assert dst.restore_entry(refs)
    h2 = dst.acquire(ids, 50, 64, salt="tenant-a")
    assert h2.reusable
    k2, v2 = dst.assemble(h2, (0, 0))
    assert k2.dtype == dtype
    assert torch.equal(k2.cuda(), k) and torch.equal(v2.cuda(), v)


def _first_kill_seed(n: int, rate: float) -> int:
    """A chaos seed whose ``replica_kill`` schedule at ``rate`` fires first
    at draw ``n`` (0-based)."""
    from flexible_llm_sharding_tpu_torch.faults.retry import hash_unit

    for seed in range(100_000):
        units = [hash_unit(f"{seed}:replica_kill:{i}") for i in range(n + 1)]
        if min(units[:n], default=1.0) >= rate > units[n]:
            return seed
    raise AssertionError(f"no seed fires first at draw {n}")


def _cuda_bytes(tree) -> int:
    """Bytes of the CUDA storages behind the tensors in ``tree``, each
    storage once."""
    storages = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                storages[x.untyped_storage().data_ptr()] = x.untyped_storage().nbytes()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    return sum(storages.values())


def test_fleet_of_2_under_a_replica_kill_on_the_card(gen, tmp_path):
    """Two replicas on cuda:0, one killed mid-decode by a seeded
    ``replica_kill`` (the first kill draw at about each replica's third
    sweep; the victim's waves past their prefill, their KV on the card):
    every request gets the single engine's tokens and scores bit for bit
    (waves of 1, so each request's computation is the same on any
    replica), the three kernels launch, and ``memory_allocated`` after the
    kill, the recycle and the drain exceeds the clean fleet's by less than
    the victim's wave state at the kill and a quarter of one replica's
    weights (both read with PyTorch's cuBLAS workspaces freed)."""
    import dataclasses
    import gc
    import time

    from flexible_llm_sharding_tpu_torch.config import FaultConfig, FrameworkConfig, ServeConfig
    from flexible_llm_sharding_tpu_torch.runtime import kvpool
    from flexible_llm_sharding_tpu_torch.serve import ReplicaFleet, ReplicaKilled, ServeEngine

    kvpool.reset_process_pools()
    model_dir = _decode_model(tmp_path, "llama")
    weights = sum(os.path.getsize(os.path.join(model_dir, f)) for f in os.listdir(model_dir)
                  if f.endswith(".safetensors"))
    cfg = FrameworkConfig(model_path=model_dir, dtype="bfloat16", block_size=2,
                          decode_resident="on", disk_folder=str(tmp_path / "d"))
    serve_cfg = ServeConfig(max_wave_requests=1, default_max_new_tokens=4)
    engine = ServeEngine(cfg, serve_cfg, tokenizer=_WordTokenizer(),
                         device=torch.device("cuda:0"))
    try:
        want = [r.future.result(timeout=300)
                for r in [engine.submit(p, sfx) for p, sfx in _DECODE_PROMPTS]]
    finally:
        engine.shutdown(drain=True)
    kvpool.reset_process_pools()
    # Both replicas draw at every shard step: draw 4 S + 1 is about each
    # one's third sweep of S shards.
    seed = _first_kill_seed(4 * len(engine.shards) + 1, 0.05)
    fleet = ReplicaFleet(
        dataclasses.replace(cfg, faults=FaultConfig(enabled=True, seed=seed, error_rate=0.05,
                                                    sites=("replica_kill",), max_faults=1)),
        dataclasses.replace(serve_cfg, replicas=2, router_health_poll_s=0.05),
        tokenizer=_WordTokenizer(), device=torch.device("cuda:0"))
    kill = {}
    step = fleet._chaos_step

    def watched(rep, shard_pos):
        try:
            step(rep, shard_pos)
        except ReplicaKilled:
            waves = [w for w in rep.engine.batcher.waves if w.state is not None]
            kill.update(steps=[w.steps for w in waves],
                        state_bytes=_cuda_bytes([w.state.kv_store._mem for w in waves]))
            raise

    fleet._chaos_step = watched

    def wait(cond):
        deadline = time.monotonic() + 120
        while not cond():
            assert time.monotonic() < deadline
            time.sleep(0.01)

    def allocated():
        # PyTorch's per-handle cuBLAS workspaces (32 MiB each) freed first:
        # a new engine thread can add one, and no engine owns it. Read until
        # two reads 0.1 s apart agree: an engine thread can still hold its
        # last sweep's tensors for a moment after its waves retire.
        last = None
        for _ in range(50):
            gc.collect()
            torch.cuda.synchronize()
            torch._C._cuda_clearCublasWorkspaces()
            now = torch.cuda.memory_allocated()
            if now == last:
                return now
            last = now
            time.sleep(0.1)
        return now

    try:
        wait(lambda: all(r.engine._kept is not None for r in list(fleet._replicas)))
        clean = allocated()
        fa.reset_launch_counts()
        got = [r.future.result(timeout=300)
               for r in [fleet.submit(p, sfx) for p, sfx in _DECODE_PROMPTS]]
        counts = fa.launch_counts()
        wait(lambda: fleet.metrics.counter("replicas_recycled") == 1 and all(
            r.engine._kept is not None and len(r.engine.queue) == 0 and not r.engine.batcher.waves
            for r in list(fleet._replicas)))
        after = allocated()
        snap = fleet.metrics.snapshot()
    finally:
        assert fleet.shutdown(drain=True, timeout=120)
        kvpool.reset_process_pools()
    assert snap["replicas_dead"] == 1 and snap["redispatches"] >= 1
    assert max(kill["steps"]) >= 1 and kill["state_bytes"] > 0, kill
    assert all(counts[k] > 0 for k in fa.KERNELS)
    for a, b in zip(got, want):
        assert a.updated == b.updated and np.array_equal(a.scores, b.scores)
    print(f"fleet kill: {kill}, allocated {clean} clean, {after} after, weights {weights}")
    assert after - clean < min(kill["state_bytes"], weights // 4), (clean, after, kill, weights)


@pytest.mark.parametrize("kernel", fa.KERNELS)
def test_a_fresh_thread_launches_each_kernel(gen, kernel):
    """A thread whose first CUDA call is the launch (a serving replica's
    worker could be one) gets the main thread's output bit for bit: the
    scoring kernels' TMA encoding needs the device's context current on the
    calling thread, which the wrapper binds."""
    import threading

    dtype = torch.bfloat16
    b, lp, s, ls, tg = 2, 64, 2, 32, 3
    plen = torch.tensor([64, 23], dtype=torch.int32, device="cuda")
    eos = torch.tensor([[31, 5], [0, 12]], dtype=torch.int32, device="cuda")
    q, k, v = (_rnd(gen, dtype, b, lp, 4, 128) for _ in range(3))
    qs, ks, vs = (_rnd(gen, dtype, b, s, ls, 4, 128) for _ in range(3))
    qd = _rnd(gen, dtype, b, s, 1, 4, 128)
    kg, vg = (_rnd(gen, dtype, b, s, tg, 4, 128) for _ in range(2))
    args = {"flash_causal_attention": (q, k, v, plen),
            "flash_prefix_shared_attention": (qs, k, v, ks, vs, plen),
            "flash_decode_attention": (qd, k, v, ks, vs, kg, vg, plen, eos, 1)}[kernel]
    want = getattr(fa, kernel)(*args)
    torch.cuda.synchronize()
    out = {}

    def run():
        try:
            out["got"] = getattr(fa, kernel)(*args)
            torch.cuda.current_stream().synchronize()
        except Exception as e:  # noqa: BLE001 — the outcome is the assertion
            out["err"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(120)
    assert not t.is_alive() and "err" not in out, out.get("err")
    assert torch.equal(out["got"], want)


# -- the multi-device modes over one card ---------------------------------------

def _md_cfg(model_dir, tmp_path, **kw):
    from flexible_llm_sharding_tpu_torch.config import FrameworkConfig

    return FrameworkConfig(model_path=model_dir, dtype="bfloat16", block_size=2, device="cuda",
                           disk_folder=str(tmp_path / "acts"), **kw)


def _md_run(cfg, devices, kv=False):
    """(scores, updated, the entry point's stats dicts, launch counts)."""
    from flexible_llm_sharding_tpu_torch.runtime import hostcache, orchestration

    hostcache.reset_process_cache()
    fa.reset_launch_counts()
    calls = []
    if kv:
        scores, updated, _ = orchestration.run_decode(cfg, _DECODE_PROMPTS,
                                                      tokenizer=_WordTokenizer(),
                                                      devices=devices, calls=calls)
    else:
        scores = orchestration.run_prompts(cfg, _DECODE_PROMPTS, tokenizer=_WordTokenizer(),
                                           devices=devices, calls=calls)
        updated = None
    torch.cuda.synchronize()
    return scores, updated, calls, fa.launch_counts()


def _bit_equal(got, want):
    assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))


def test_mp_over_one_card_equals_one_device(gen, tmp_path):
    """The interleaved pipeline over [cuda:0] * 4 (6 execution layers in 8
    stages, 2 of them padding): scoring in each storage location and KV
    decode equal the single-device run bit for bit, launching the kernels."""
    model_dir = _decode_model(tmp_path, "llama")
    card = torch.device("cuda", 0)
    cfg = _md_cfg(model_dir, tmp_path, num_batch=2)
    want, _, want_calls, _ = _md_run(cfg, [card])
    for storage in ("gpu", "cpu", "disk"):
        got, _, calls, counts = _md_run(_md_cfg(model_dir, tmp_path, num_batch=2,
                                                storage_location=storage), [card] * 4)
        _bit_equal(got, want)
        assert calls[0]["num_stages"] == 8.0
        assert sum(c["streamed_bytes"] for c in calls) == sum(
            c["streamed_bytes"] for c in want_calls)
        assert counts["flash_causal_attention"] and counts["flash_prefix_shared_attention"]
    kv = _md_cfg(model_dir, tmp_path, kv_cache=True, num_gen_token=5)
    want, want_up, _, _ = _md_run(kv, [card], kv=True)
    got, got_up, calls, counts = _md_run(kv, [card] * 4, kv=True)
    assert got_up == want_up
    _bit_equal(got, want)
    assert calls[0]["decode_resident"] == 1 and calls[0]["decode_fused"] == 0
    assert all(counts.values()), counts


def test_dp_two_threads_on_one_card_equal_one_device(gen, tmp_path):
    """Two DP ranks, each its own thread, on cuda:0: scoring and KV decode
    (resident, every block's steps one CUDA graph captured on its rank's
    thread while the other rank runs) equal the single-device run bit for
    bit (the ranks' blocks are the single run's), stream its bytes, and
    launch every kernel."""
    model_dir = _decode_model(tmp_path, "llama")
    card = torch.device("cuda", 0)
    cfg = _md_cfg(model_dir, tmp_path, num_batch=2)
    want, _, want_calls, _ = _md_run(cfg, [card])
    got, _, calls, counts = _md_run(_md_cfg(model_dir, tmp_path, num_batch=2,
                                            data_parallel=True), [card] * 2)
    _bit_equal(got, want)
    assert calls[0]["streamed_bytes"] == sum(c["streamed_bytes"] for c in want_calls)
    assert counts["flash_causal_attention"] and counts["flash_prefix_shared_attention"]
    kv = _md_cfg(model_dir, tmp_path, kv_cache=True, num_gen_token=5)
    want, want_up, want_calls, want_counts = _md_run(kv, [card], kv=True)
    for _ in range(3):  # the two captures race differently each time
        got, got_up, calls, counts = _md_run(
            _md_cfg(model_dir, tmp_path, kv_cache=True, num_gen_token=5, data_parallel=True),
            [card] * 2, kv=True)
        assert got_up == want_up
        _bit_equal(got, want)
        assert calls[0]["decode_graph"] == 1 and calls[0]["decode_fused"] == 1
        assert calls[0]["streamed_bytes"] == want_calls[0]["streamed_bytes"]
        assert counts == want_counts


def test_a_fresh_process_reads_an_indexed_cards_memory_stats(gen):
    """``resolve_device`` initialises the runtime, so a fresh process (a CLI
    run) can reset an indexed card's peak memory before its first kernel:
    on an uninitialised runtime ``reset_peak_memory_stats(cuda:0)`` raises
    "Invalid device argument"."""
    import subprocess
    import sys

    code = ("import torch\n"
            "from flexible_llm_sharding_tpu_torch.config import resolve_device\n"
            "torch.cuda.reset_peak_memory_stats(resolve_device('cuda:0'))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]


def test_retried_upload_on_the_side_stream_equals_a_clean_upload(gen, tmp_path):
    """Every shard's upload retried once (device_put at rate 1, link_throttle
    stalling) on the weight source's side stream: the placed trees equal a
    clean source's bit for bit, and the scores of a chaos run the clean
    run's."""
    from flexible_llm_sharding_tpu_torch.config import FaultConfig
    from flexible_llm_sharding_tpu_torch.faults.inject import FaultInjector
    from flexible_llm_sharding_tpu_torch.faults.retry import RetryPolicy
    from flexible_llm_sharding_tpu_torch.runtime.executor import ShardWeightSource, _tree_leaves
    from flexible_llm_sharding_tpu_torch.utils.checkpoint import layer_names_for

    model_dir = _decode_model(tmp_path, "llama")
    n_layers = len([f for f in os.listdir(model_dir) if f.startswith("model.layers.")])
    names = layer_names_for(n_layers)
    shards = [(i,) for i in range(len(names))]
    card = torch.device("cuda", 0)

    def placed(injector):
        src = ShardWeightSource(model_dir, names, shards, torch.bfloat16, card, prefetch_depth=1,
                                retry_policy=RetryPolicy(max_attempts=8, base_delay_s=0.0),
                                injector=injector)
        try:
            return [[t.clone() for t in _tree_leaves([p for _, p in segs])] for _, segs in src], src
        finally:
            src.close()

    # Three faults: the first shard's upload fails three times, then lands.
    inj = FaultInjector(FaultConfig(enabled=True, error_rate=1.0, latency_s=0.001,
                                    sites=("device_put", "link_throttle"), max_faults=3))
    got, src = placed(inj)
    want, _ = placed(None)
    assert inj.count() == 3
    assert src.retries.snapshot()["device_put"]["recovered"] == 1
    for a, b in zip(got, want):
        assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    cfg = _md_cfg(model_dir, tmp_path, faults=FaultConfig(
        enabled=True, error_rate=0.5, sites=("device_put", "link_throttle"), max_faults=6))
    clean, _, _, _ = _md_run(_md_cfg(model_dir, tmp_path), [card])
    chaos, _, calls, counts = _md_run(cfg, [card])
    _bit_equal(chaos, clean)
    assert calls[0]["io_retries"] > 0 and all(counts[k] for k in fa.KERNELS[:2])


def test_hbm_sampler_on_a_fresh_thread(gen, tmp_path):
    """``PressureMonitor.sample()`` from a thread that made no CUDA call
    reads the card's free share as ``1 - memory_allocated / total``, and it
    falls when a tensor is held and rises when it is dropped."""
    import threading

    from flexible_llm_sharding_tpu_torch.config import FrameworkConfig, PressureConfig
    from flexible_llm_sharding_tpu_torch.runtime import pressure

    cfg = FrameworkConfig(disk_folder=str(tmp_path), pressure=PressureConfig(enabled=True))
    mon = pressure.PressureMonitor(cfg, pressure.BrownoutController(cfg),
                                   device=torch.device("cuda", 0))

    def sample():
        out = []
        t = threading.Thread(target=lambda: out.append(mon.sample().hbm_free_frac))
        t.start()
        t.join(60)
        return out[0]

    total = torch.cuda.get_device_properties(0).total_memory
    before = sample()
    assert before is not None and 0.0 < before <= 1.0
    block = torch.empty(total // 20, dtype=torch.uint8, device="cuda")
    held = sample()
    assert before - held >= 0.04
    del block
    assert sample() >= held + 0.04


def test_pressure_unpin_lowers_memory_allocated(gen, tmp_path):
    """The ladder's pin_evict rung on a tier holding every layer on the card:
    ``torch.cuda.memory_allocated`` falls by at least the pinned bytes, a
    source built meanwhile streams every layer with the same scores, and the
    restored plan pins them again."""
    import gc

    from flexible_llm_sharding_tpu_torch.runtime import residency

    model_dir = _decode_model(tmp_path, "llama")
    card = torch.device("cuda", 0)
    residency.reset_process_tier()
    try:
        want, _, _, _ = _md_run(_md_cfg(model_dir, tmp_path), [card])
        cfg = _md_cfg(model_dir, tmp_path, hbm_pin_gb=1.0)
        pinned_run, _, _, _ = _md_run(cfg, [card])
        tier = residency.process_tier()
        held = tier.stats()
        assert held["pinned_layers"] == held["planned_layers"] > 0
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(card)
        assert tier.pressure_unpin() == held["planned_layers"]
        gc.collect()
        torch.cuda.synchronize()
        assert before - torch.cuda.memory_allocated(card) >= held["pinned_bytes"] > 0
        demoted_run, _, calls, _ = _md_run(cfg, [card])
        assert tier.stats()["pinned_bytes"] == 0 and calls[0].get("pin_hits", 0) == 0
        assert tier.pressure_restore() == held["planned_layers"]
        restored_run, _, _, _ = _md_run(cfg, [card])
        assert tier.stats()["pinned_layers"] == held["planned_layers"]
        for run in (pinned_run, demoted_run, restored_run):
            _bit_equal(run, want)
    finally:
        residency.reset_process_tier()


# -- observability on the card -------------------------------------------------

@pytest.fixture
def traced():
    """The port's process tracer, enabled for one test, off and empty after."""
    from flexible_llm_sharding_tpu_torch.obs import trace as obs_trace

    obs_trace.TRACER.clear()
    obs_trace.TRACER.enable()
    yield obs_trace.TRACER
    obs_trace.TRACER.disable()
    obs_trace.TRACER.clear()


@pytest.mark.parametrize("kv", [False, True], ids=["scoring", "kv_cache"])
def test_traced_run_equals_the_untraced_run_on_the_card(gen, tmp_path, kv, traced):
    """Tracing changes no output and no launch: scoring, and KV decode with
    its steps one captured CUDA graph per block (no span inside a captured
    region), bit-equal with equal launch counts; every span of the run is
    recorded and ``compute`` closes after the device synchronization."""
    model_dir = _decode_model(tmp_path, "llama")
    card = torch.device("cuda", 0)
    cfg = (_md_cfg(model_dir, tmp_path, kv_cache=True, num_gen_token=5) if kv
           else _md_cfg(model_dir, tmp_path, num_batch=2))
    traced.disable()
    want, want_up, want_calls, want_counts = _md_run(cfg, [card], kv=kv)
    traced.enable()
    got, got_up, calls, counts = _md_run(cfg, [card], kv=kv)
    _bit_equal(got, want)
    assert got_up == want_up and counts == want_counts
    spans = traced.snapshot()
    names = {s["name"] for s in spans}
    assert {"shard_load", "shard_produce", "device_put"} <= names
    if kv:
        assert calls[0]["decode_graph"] == 1
    else:
        computes = [s for s in spans if s["name"] == "compute"]
        waits = [s for s in spans if s["name"] == "source_wait"]
        assert computes and len(computes) == len(waits)
        # compute_wall_s is measured over the same region the span covers.
        total = sum(s["dur_s"] for s in computes)
        assert total == pytest.approx(sum(c["compute_wall_s"] for c in calls), abs=2e-3)


def test_registry_sources_from_a_fresh_thread_on_a_card_engine(gen, tmp_path):
    """The endpoint's handler and the incident capture collect on threads
    that never touched the card: every source of a CUDA engine (stream,
    host cache, residency, pool, SLO, pressure, trace, journal) returns
    host numbers there, none a ``collect_error``."""
    import threading
    import urllib.request

    from flexible_llm_sharding_tpu_torch.config import (
        FrameworkConfig,
        PressureConfig,
        ServeConfig,
    )
    from flexible_llm_sharding_tpu_torch.obs import events as obs_events
    from flexible_llm_sharding_tpu_torch.runtime import kvpool, pressure
    from flexible_llm_sharding_tpu_torch.serve import ServeEngine

    kvpool.reset_process_pools()
    obs_events.reset_journal()
    model_dir = _decode_model(tmp_path, "llama")
    cfg = FrameworkConfig(model_path=model_dir, dtype="bfloat16", block_size=2,
                          decode_resident="off", hbm_pin_gb=0.01,
                          disk_folder=str(tmp_path / "d"), journal_dir=str(tmp_path / "j"),
                          pressure=PressureConfig(enabled=True, poll_s=0.05, host_min_gb=0.0,
                                                  disk_min_gb=0.0, hbm_headroom_frac=0.0))
    engine = ServeEngine(cfg, ServeConfig(max_wave_requests=1, default_max_new_tokens=2,
                                          metrics_port=0),
                         tokenizer=_WordTokenizer(), device=torch.device("cuda:0"))
    got: list = []
    try:
        for r in [engine.submit(p, sfx) for p, sfx in _DECODE_PROMPTS]:
            r.future.result(timeout=300)
        thread = threading.Thread(target=lambda: got.append(engine.metrics.registry.collect()))
        thread.start()
        thread.join(60)
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{engine.metrics_server.port}/metrics", timeout=30).read().decode()
    finally:
        engine.shutdown(drain=True)
        pressure.reset_process_pressure()
        obs_events.reset_journal()
        kvpool.reset_process_pools()
    assert engine.error is None and got
    assert not [k for k, v in got[0].items() if "collect_error" in v], got[0]
    assert {"serve", "stream", "host_cache", "residency", "kvpool", "slo", "pressure",
            "journal"} <= set(got[0])
    assert "collect_error" not in text and "fls_pressure_level" in text


def test_profiler_trace_records_the_scoring_kernel(gen, tmp_path):
    """``--profile_dir``'s ``profiler_trace`` over a scoring run on the card:
    the Chrome trace it writes holds one ``score_tc_kernel`` event per
    scoring launch."""
    import json

    from flexible_llm_sharding_tpu_torch.utils.metrics import profiler_trace

    model_dir = _decode_model(tmp_path, "llama")
    cfg = _md_cfg(model_dir, tmp_path)
    out = tmp_path / "prof"
    with profiler_trace(str(out)):
        _, _, _, counts = _md_run(cfg, [torch.device("cuda", 0)])
    (name,) = os.listdir(out)
    with open(out / name) as f:
        events = json.load(f)["traceEvents"]
    score = [e for e in events if e.get("cat") == "kernel" and "score_tc_kernel" in e["name"]]
    assert len(score) == counts["flash_causal_attention"] + counts["flash_prefix_shared_attention"]


def _grad_inputs(gen, requires_grad: bool):
    b, lp, s, ls, tg, n, hd = 2, 64, 2, 16, 3, 4, 64
    plen = torch.tensor([64, 17], dtype=torch.int32, device="cuda")
    eos = torch.tensor([[3, 15], [0, 7]], dtype=torch.int32, device="cuda")
    q, k, v = (_rnd(gen, torch.bfloat16, b, lp, n, hd) for _ in range(3))
    qs, ks, vs = (_rnd(gen, torch.bfloat16, b, s, ls, n, hd) for _ in range(3))
    qd = _rnd(gen, torch.bfloat16, b, s, 1, n, hd)
    kg, vg = (_rnd(gen, torch.bfloat16, b, s, tg, n, hd) for _ in range(2))
    for t in (q, qs, qd):
        t.requires_grad_(requires_grad)
    return {
        "flash_causal_attention": (q, k, v, plen),
        "flash_prefix_shared_attention": (qs, k, v, ks, vs, plen),
        "flash_decode_attention": (qd, k, v, ks, vs, kg, vg, plen, eos, 0),
    }


def test_cuda_wrappers_refuse_a_gradient(gen):
    """No kernel has a backward: asked for one on the card, each wrapper
    raises naming the training path, before any launch; under no_grad, or
    with no input that requires a gradient, each launches."""
    fa.reset_launch_counts()
    for name, args in _grad_inputs(gen, True).items():
        with pytest.raises(RuntimeError, match="training path"):
            getattr(fa, name)(*args)
    assert fa.launch_counts() == dict.fromkeys(fa.KERNELS, 0)
    with torch.no_grad():
        for name, args in _grad_inputs(gen, True).items():
            getattr(fa, name)(*args)
    for name, args in _grad_inputs(gen, False).items():
        getattr(fa, name)(*args)
    torch.cuda.synchronize()
    assert fa.launch_counts() == dict.fromkeys(fa.KERNELS, 2)


def _tiny_train_model():
    from flexible_llm_sharding_tpu_torch.config import LlamaConfig
    from flexible_llm_sharding_tpu_torch.models import llama

    cfg = LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2)
    return cfg, llama.init_params(torch.Generator().manual_seed(0), cfg)


def test_streamed_step_on_the_card_equals_the_cpus(gen):
    """One StreamedTrainer step on the card against the same step on the
    CPU, float32 (no TF32): the loss within 1e-5 relative; the params within
    rtol 2e-5 / atol 2e-6 wherever the clipped gradient is not near zero
    (below 1e-6 AdamW's first update lr * g / (|g| + 1e-8) is
    summation-order noise on either device, so there within 2 * lr). No
    kernel launches."""
    from flexible_llm_sharding_tpu_torch import training
    from flexible_llm_sharding_tpu_torch.training_stream import StreamedTrainer

    cfg, params = _tiny_train_model()
    tokens = torch.from_numpy(np.random.default_rng(1).integers(1, 256, (2, 17)))
    lr = 1e-3
    fa.reset_launch_counts()
    runs = {}
    for dev in ("cpu", "cuda"):
        tr = StreamedTrainer(cfg, params, lr=lr, device=dev)
        runs[dev] = (tr.step(tokens), tr.params)
    assert fa.launch_counts() == dict.fromkeys(fa.KERNELS, 0)
    assert runs["cuda"][0] == pytest.approx(runs["cpu"][0], rel=1e-5)
    _, grads = training.value_and_grad(params, cfg, tokens, torch.float32, None)
    bound = 1e-6 / min(1.0, 1.0 / float(training.global_norm(grads)))  # the clip at 1.0
    for got, want, g in zip(*(training.tree_leaves(t) for t in
                              (runs["cuda"][1], runs["cpu"][1], grads))):
        noisy = g.abs() < bound
        err = (got - want).abs()
        assert (err[~noisy] <= 2e-6 + 2e-5 * want[~noisy].abs()).all()
        assert (err[noisy] <= 2 * lr).all()


def test_long_context_over_one_card_equals_the_cpu(gen, tmp_path):
    """The sequence-parallel scorer and decoder (``long_context``, a cap of
    48 tokens per device) over [cuda:0] * 2 against the same over [cpu] * 2,
    float32 (no TF32): scores and distributions within 1e-5, the same
    tokens; the sp pass launches no kernel, the short prompt's path does;
    each sp pass streams one device's bytes on both."""
    from dataclasses import replace

    from flexible_llm_sharding_tpu_torch.config import FrameworkConfig
    from flexible_llm_sharding_tpu_torch.runtime import hostcache, orchestration

    model_dir = _decode_model(tmp_path, "llama")
    card = torch.device("cuda", 0)
    cfg = FrameworkConfig(model_path=model_dir, dtype="float32", block_size=2, device="cuda",
                          max_token_len=48, bucket_multiple=8, long_context=True)
    runs = {}
    for name, devices, run_cfg in (("cuda", [card] * 2, cfg),
                                   ("cpu", [torch.device("cpu")] * 2, replace(cfg, device="cpu"))):
        hostcache.reset_process_cache()
        fa.reset_launch_counts()
        calls = []
        scores = orchestration.run_prompts(run_cfg, _DECODE_PROMPTS, tokenizer=_WordTokenizer(),
                                           devices=devices, calls=calls)
        sp_counts = fa.launch_counts()
        decoded = orchestration.run_decode(replace(run_cfg, num_gen_token=3), _DECODE_PROMPTS,
                                           tokenizer=_WordTokenizer(), devices=devices)
        runs[name] = (scores, decoded, calls, sp_counts)
    (scores, decoded, calls, counts), (want, want_dec, want_calls, _) = runs["cuda"], runs["cpu"]
    for got, ref in zip(scores, want):
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert decoded[1] == want_dec[1]
    for got, ref in zip(decoded[0], want_dec[0]):
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    # Prompts 0 and 1 are past the cap (one sp call, a pass for each),
    # prompt 2 is not (one pass of the MP pipeline).
    assert [c["streamed_bytes"] for c in calls] == [c["streamed_bytes"] for c in want_calls]
    assert calls[0]["streamed_bytes"] == 2 * calls[1]["streamed_bytes"]
    assert counts["flash_causal_attention"] and counts["flash_prefix_shared_attention"]
    fa.reset_launch_counts()
    orchestration.run_prompts(cfg, _DECODE_PROMPTS[:2], tokenizer=_WordTokenizer(),
                              devices=[card] * 2)
    assert fa.launch_counts() == dict.fromkeys(fa.KERNELS, 0)


def test_a_ring_hop_on_one_card_allocates_nothing(gen):
    """Ring attention over [cuda:0] * 4: every hop's ``.to`` returns its
    block itself, so no step copies or allocates a K/V block; the result is
    the one-rank ring's."""
    from flexible_llm_sharding_tpu_torch.ops import ring_attention as ring
    from flexible_llm_sharding_tpu_torch.parallel.sharding import gather, make_mesh, shard

    card = torch.device("cuda", 0)
    q, k, v = (_rnd(gen, torch.float32, 256, 8, 64) for _ in range(3))
    mesh = make_mesh({"sp": 4}, [card] * 4)
    blocks = [shard(t, mesh) for t in (q, k, v)]
    made = []
    real_to = torch.Tensor.to

    def counting_to(self, *args, **kw):
        out = real_to(self, *args, **kw)
        if out is not self:
            made.append(tuple(out.shape))
        return out

    torch.Tensor.to = counting_to
    try:
        out = ring.ring_attention_blocks(*blocks, mesh)
    finally:
        torch.Tensor.to = real_to
    assert made == []
    want = ring.ring_self_attention(q, k, v, make_mesh({"sp": 1}, [card]))
    torch.testing.assert_close(gather(out), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kv", [False, True], ids=["scoring", "kv_cache"])
def test_use_pallas_false_launches_no_kernel_and_matches_the_default(gen, tmp_path, kv):
    """``use_pallas=False`` on the card: scoring and KV decode (resident, one
    CUDA graph per block, over the plain decode op) launch no kernel, and
    their float32 scores are the default run's within 1e-6 (a 512-token
    vocabulary: 1/2000 of a typical probability) with the same tokens; the
    default run launches each kernel it reaches."""
    from flexible_llm_sharding_tpu_torch.config import FrameworkConfig

    model_dir = _decode_model(tmp_path, "llama")
    runs = {}
    for use_pallas in (True, False):
        cfg = FrameworkConfig(model_path=model_dir, dtype="float32", block_size=2, device="cuda",
                              disk_folder=str(tmp_path / "acts"), use_pallas=use_pallas,
                              num_gen_token=4 if kv else 1)
        runs[use_pallas] = _md_run(cfg, [torch.device("cuda", 0)], kv=kv)
    (want, want_up, _, counts), (got, got_up, _, off) = runs[True], runs[False]
    assert off == dict.fromkeys(fa.KERNELS, 0)
    wanted = fa.KERNELS if kv else ("flash_causal_attention", "flash_prefix_shared_attention")
    assert all(counts[k] > 0 for k in wanted)
    assert got_up == want_up
    for g, w in zip(got, want):
        assert np.array_equal(g.argmax(-1), w.argmax(-1))
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)


def test_use_pallas_false_serve_engine_launches_no_kernel(gen, tmp_path):
    """A float32 engine at ``use_pallas=False`` serves one wave on cuda:0 with
    no kernel launch, token for token the default engine's, its scores
    within 1e-6."""
    from flexible_llm_sharding_tpu_torch.config import FrameworkConfig, ServeConfig
    from flexible_llm_sharding_tpu_torch.serve import ServeEngine

    model_dir = _decode_model(tmp_path, "llama")
    out = {}
    for use_pallas in (True, False):
        cfg = FrameworkConfig(model_path=model_dir, dtype="float32", block_size=2,
                              use_pallas=use_pallas, disk_folder=str(tmp_path / "d"))
        engine = ServeEngine(cfg, ServeConfig(max_wave_requests=len(_DECODE_PROMPTS),
                                              default_max_new_tokens=3),
                             tokenizer=_WordTokenizer(), device=torch.device("cuda:0"),
                             start=False)
        try:
            reqs = [engine.submit(p, sfx) for p, sfx in _DECODE_PROMPTS]
            fa.reset_launch_counts()
            engine.start()
            out[use_pallas] = ([r.future.result(timeout=300) for r in reqs], fa.launch_counts())
        finally:
            engine.shutdown(drain=True)
    (want, counts), (got, off) = out[True], out[False]
    assert off == dict.fromkeys(fa.KERNELS, 0) and all(counts[k] > 0 for k in fa.KERNELS)
    for g, w in zip(got, want):
        assert g.updated == w.updated
        np.testing.assert_allclose(g.scores, w.scores, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kv", [False, True], ids=["scoring", "kv_cache"])
def test_tp_over_one_card_equals_the_cpu_and_one_card(gen, tmp_path, kv):
    """Tensor parallelism at tp = 2 over [cuda:0] * 2, float32: scores
    within 1e-6 of [cpu] * 2 and of one card, the same tokens, and each
    kernel launched once per rank (twice the one card's launches; decode
    resident, its steps captured in one CUDA graph per block)."""
    from flexible_llm_sharding_tpu_torch.config import FrameworkConfig

    model_dir = _decode_model(tmp_path, "llama")

    def cfg(device, tp):
        return FrameworkConfig(model_path=model_dir, dtype="float32", block_size=2,
                               device=device, disk_folder=str(tmp_path / "acts"),
                               num_gen_token=4 if kv else 1, tensor_parallel=tp)

    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    one_card, one_up, _, counts = _md_run(cfg("cuda", 1), [card], kv=kv)
    tp_card, tp_up, calls, tp_counts = _md_run(cfg("cuda", 2), [card] * 2, kv=kv)
    tp_cpu, cpu_up, _, _ = _md_run(cfg("cpu", 2), [cpu] * 2, kv=kv)
    wanted = fa.KERNELS if kv else ("flash_causal_attention", "flash_prefix_shared_attention")
    assert all(counts[k] > 0 for k in wanted)
    assert tp_counts == {k: 2 * counts[k] for k in fa.KERNELS}
    if kv:
        assert calls[-1]["decode_graph"] == 1.0
    assert tp_up == one_up == cpu_up
    for got, a, b in zip(tp_card, one_card, tp_cpu):
        assert np.array_equal(got.argmax(-1), a.argmax(-1))
        assert np.array_equal(got.argmax(-1), b.argmax(-1))
        np.testing.assert_allclose(got, a, atol=1e-6, rtol=0)
        np.testing.assert_allclose(got, b, atol=1e-6, rtol=0)
