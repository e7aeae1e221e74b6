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


def test_zero_valid_length_rows_are_zero(gen):
    q = _rnd(gen, torch.bfloat16, 1, 64, 2, 64)
    out = fa.flash_causal_attention(q, q, q, torch.zeros(1, dtype=torch.int32, device="cuda"))
    assert torch.count_nonzero(out) == 0


def test_cuda_wrappers_refuse_window(gen):
    q = _rnd(gen, torch.bfloat16, 1, 64, 2, 64)
    with pytest.raises(NotImplementedError):
        fa.flash_causal_attention(q, q, q, torch.ones(1, dtype=torch.int32, device="cuda"),
                                  window=16)
