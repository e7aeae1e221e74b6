"""Head dims 256 (Gemma) and 96 (Phi-3): the plain versions of the three
kernels, which the CUDA wrappers run on CPU tensors, against the JAX
package's Pallas kernels in interpret mode (which zero-pad hd 96 to 128),
with a window, a chunk, the per-layer toggle off and a softcap. At hd 96
the JAX package decodes with its plain op (the Pallas decode kernel takes
multiples of 128), so decode is held against that op there. Float32,
atol 1e-5."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexible_llm_sharding_tpu.ops import pallas_attention as jpallas
from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa

jattn = importlib.import_module("flexible_llm_sharding_tpu.ops.attention")
ATOL = 1e-5
B, NQ, NKV, LP, S, LS, T = 2, 4, 2, 128, 2, 64, 3
PLEN = np.array([100, 37], np.int32)
EOS = np.array([[5, 63], [0, 20]], np.int32)

# (keywords of the kernel call, id): no local form, a window, a chunk, the
# window with the toggle off, a softcap.
FORMS = [({}, "plain"), ({"window": 48}, "window48"), ({"chunk": 32}, "chunk32"),
         ({"window": 48, "local_on": False}, "window48-off"), ({"softcap": 30.0}, "softcap30")]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jax_kw(kw):
    return {k: jnp.asarray(v) if k == "local_on" else v for k, v in kw.items()}


@pytest.mark.parametrize("kw", [f for f, _ in FORMS], ids=[n for _, n in FORMS])
@pytest.mark.parametrize("hd", [256, 96])
def test_causal_plain_matches_pallas(hd, kw):
    rng = np.random.default_rng(hd)
    q, k, v = _rand(rng, B, LP, NQ, hd), _rand(rng, B, LP, NKV, hd), _rand(rng, B, LP, NKV, hd)
    got = fa.flash_causal_attention(_t(q), _t(k), _t(v), _t(PLEN), **kw).numpy()
    window, chunk = kw.get("window"), kw.get("chunk")
    base = np.asarray(jattn.causal_mask(LP, LP, window=window, chunk=chunk))
    if kw.get("local_on") is False:
        base = np.asarray(jattn.causal_mask(LP, LP))
    for b in range(B):
        pal = jpallas.flash_causal_attention(
            jnp.asarray(q[b]), jnp.asarray(k[b]), jnp.asarray(v[b]), jnp.int32(PLEN[b]),
            interpret=True, **_jax_kw(kw))
        assert pal.shape == (LP, NQ, hd)
        # Rows that see no key (padding rows past the window) are 0 here and
        # in the CUDA kernels; the Pallas kernel leaves another value there.
        seen = (base & (np.arange(LP)[None, :] < PLEN[b])).any(-1)
        np.testing.assert_allclose(got[b][seen], np.asarray(pal)[seen], atol=ATOL, rtol=0)


@pytest.mark.parametrize("kw", [f for f, _ in FORMS], ids=[n for _, n in FORMS])
@pytest.mark.parametrize("hd", [256, 96])
def test_prefix_shared_plain_matches_pallas(hd, kw):
    rng = np.random.default_rng(hd + 1)
    q = _rand(rng, B, S, LS, NQ, hd)
    kp, vp = _rand(rng, B, LP, NKV, hd), _rand(rng, B, LP, NKV, hd)
    ks, vs = _rand(rng, B, S, LS, NKV, hd), _rand(rng, B, S, LS, NKV, hd)
    got = fa.flash_prefix_shared_attention(_t(q), _t(kp), _t(vp), _t(ks), _t(vs), _t(PLEN),
                                           **kw).numpy()
    for b in range(B):
        args = [jnp.asarray(a[b]) for a in (q, kp, vp, ks, vs)]
        pal = jpallas.flash_prefix_shared_attention(*args, jnp.int32(PLEN[b]), interpret=True,
                                                    **_jax_kw(kw))
        np.testing.assert_allclose(got[b], np.asarray(pal), atol=ATOL, rtol=0)


@pytest.mark.parametrize("kw", [f for f, _ in FORMS], ids=[n for _, n in FORMS])
@pytest.mark.parametrize("hd", [256, 96])
def test_decode_plain_matches_jax(hd, kw):
    rng = np.random.default_rng(hd + 2)
    q = _rand(rng, B, S, 1, NQ, hd)
    kp, vp = _rand(rng, B, LP, NKV, hd), _rand(rng, B, LP, NKV, hd)
    ks, vs = _rand(rng, B, S, LS, NKV, hd), _rand(rng, B, S, LS, NKV, hd)
    kg, vg = _rand(rng, B, S, T, NKV, hd), _rand(rng, B, S, T, NKV, hd)
    t = 1
    got = fa.flash_decode_attention(_t(q), _t(kp), _t(vp), _t(ks), _t(vs), _t(kg), _t(vg), _t(PLEN),
                                    _t(EOS), t, **kw).numpy()
    assert jpallas.supports_decode(NQ, NKV, hd) == (hd % 128 == 0)
    for b in range(B):
        args = [jnp.asarray(a[b]) for a in (q, kp, vp, ks, vs, kg, vg)]
        lens = (jnp.int32(PLEN[b]), jnp.asarray(EOS[b]), jnp.int32(t))
        if hd % 128 == 0:
            want = jpallas.flash_decode_attention(*args, *lens, interpret=True, **_jax_kw(kw))
        else:
            jkw = {"sliding" if k == "local_on" else k: v for k, v in _jax_kw(kw).items()}
            want = jattn.decode_attention(*args, *lens, **jkw)
        np.testing.assert_allclose(got[b], np.asarray(want), atol=ATOL, rtol=0)
