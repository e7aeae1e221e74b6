"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and skip without one. This file imports neither
JAX nor the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

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
