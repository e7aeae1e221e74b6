"""The PyTorch port's ops against the JAX package's: rms_norm, rope, and the
plain versions of the three attention kernels (what the kernel wrappers run
on CPU tensors), checked against the JAX XLA ops and the Pallas kernels in
interpret mode. Float32, atol 1e-5."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexible_llm_sharding_tpu.ops import pallas_attention as jpallas
from flexible_llm_sharding_tpu.ops.norm import rms_norm as j_rms_norm
from flexible_llm_sharding_tpu.ops.rope import apply_rope as j_apply_rope
from flexible_llm_sharding_tpu.ops.rope import rope_cos_sin as j_rope_cos_sin
from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa
from flexible_llm_sharding_tpu_torch.ops.norm import rms_norm
from flexible_llm_sharding_tpu_torch.ops.rope import apply_rope, rope_cos_sin

# The ops package re-exports attention() under the module's name.
jattn = importlib.import_module("flexible_llm_sharding_tpu.ops.attention")
ATOL = 1e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x, scale = _rand(rng, 3, 5, 128), _rand(rng, 128)
    want = np.asarray(j_rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    got = rms_norm(_t(x), _t(scale), 1e-5).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 4, 64)
    pos = rng.integers(0, 4000, size=(2, 7)).astype(np.int32)
    jc, js = j_rope_cos_sin(jnp.asarray(pos), 64, 10000.0)
    c, s = rope_cos_sin(_t(pos), 64, 10000.0)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=ATOL, rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=ATOL, rtol=0)
    want = np.asarray(j_apply_rope(jnp.asarray(x), jc, js))
    np.testing.assert_allclose(apply_rope(_t(x), c, s).numpy(), want, atol=ATOL, rtol=0)


# B=2 prompts, 4 query heads over 2 KV heads, hd 64, lengths that are
# multiples of 64 (what the Pallas kernels take), ragged valid lengths.
B, NQ, NKV, HD, LP, S, LS, T = 2, 4, 2, 64, 128, 2, 64, 3
PLEN = np.array([100, 37], np.int32)
EOS = np.array([[5, 63], [0, 20]], np.int32)


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_causal_plain_matches_jax(softcap):
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, B, LP, NQ, HD), _rand(rng, B, LP, NKV, HD), _rand(rng, B, LP, NKV, HD)
    got = fa.flash_causal_attention(_t(q), _t(k), _t(v), _t(PLEN), softcap=softcap).numpy()
    mask = jattn.causal_mask(LP, LP)
    for b in range(B):
        # The XLA op (no valid-length mask) agrees on the real rows.
        xla = jattn.attention(jnp.asarray(q[b]), jnp.asarray(k[b]), jnp.asarray(v[b]), mask,
                              softcap=softcap)
        n = PLEN[b]
        np.testing.assert_allclose(got[b, :n], np.asarray(xla)[:n], atol=ATOL, rtol=0)
        # The Pallas kernel computes the padding rows the same way too.
        pal = jpallas.flash_causal_attention(
            jnp.asarray(q[b]), jnp.asarray(k[b]), jnp.asarray(v[b]), jnp.int32(n),
            softcap=softcap, interpret=True,
        )
        np.testing.assert_allclose(got[b], np.asarray(pal), atol=ATOL, rtol=0)


def test_causal_plain_zero_valid_len_rows_are_zero():
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, 1, 64, NQ, HD), _rand(rng, 1, 64, NKV, HD), _rand(rng, 1, 64, NKV, HD)
    got = fa.flash_causal_attention(_t(q), _t(k), _t(v), torch.zeros(1, dtype=torch.int32))
    assert torch.count_nonzero(got) == 0


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_prefix_shared_plain_matches_jax(softcap):
    rng = np.random.default_rng(4)
    q = _rand(rng, B, S, LS, NQ, HD)
    kp, vp = _rand(rng, B, LP, NKV, HD), _rand(rng, B, LP, NKV, HD)
    ks, vs = _rand(rng, B, S, LS, NKV, HD), _rand(rng, B, S, LS, NKV, HD)
    got = fa.flash_prefix_shared_attention(
        _t(q), _t(kp), _t(vp), _t(ks), _t(vs), _t(PLEN), softcap=softcap
    ).numpy()
    for b in range(B):
        args = [jnp.asarray(a[b]) for a in (q, kp, vp, ks, vs)]
        xla = jattn.prefix_shared_attention(*args, jnp.int32(PLEN[b]), softcap=softcap)
        np.testing.assert_allclose(got[b], np.asarray(xla), atol=ATOL, rtol=0)
        pal = jpallas.flash_prefix_shared_attention(
            *args, jnp.int32(PLEN[b]), softcap=softcap, interpret=True
        )
        np.testing.assert_allclose(got[b], np.asarray(pal), atol=ATOL, rtol=0)


@pytest.mark.parametrize("hd", [64, 128])
def test_decode_plain_matches_jax(hd):
    rng = np.random.default_rng(5)
    q = _rand(rng, B, S, 1, NQ, hd)
    kp, vp = _rand(rng, B, LP, NKV, hd), _rand(rng, B, LP, NKV, hd)
    ks, vs = _rand(rng, B, S, LS, NKV, hd), _rand(rng, B, S, LS, NKV, hd)
    kg, vg = _rand(rng, B, S, T, NKV, hd), _rand(rng, B, S, T, NKV, hd)
    t = 1
    got = fa.flash_decode_attention(
        _t(q), _t(kp), _t(vp), _t(ks), _t(vs), _t(kg), _t(vg), _t(PLEN), _t(EOS), t
    ).numpy()
    for b in range(B):
        args = [jnp.asarray(a[b]) for a in (q, kp, vp, ks, vs, kg, vg)]
        xla = jattn.decode_attention(*args, jnp.int32(PLEN[b]), jnp.asarray(EOS[b]), jnp.int32(t))
        np.testing.assert_allclose(got[b], np.asarray(xla), atol=ATOL, rtol=0)
        if hd % 128 == 0:  # the Pallas decode kernel's own eligibility
            pal = jpallas.flash_decode_attention(
                *args, jnp.int32(PLEN[b]), jnp.asarray(EOS[b]), jnp.int32(t), interpret=True
            )
            np.testing.assert_allclose(got[b], np.asarray(pal), atol=ATOL, rtol=0)


@pytest.mark.parametrize("window,chunk", [(48, None), (None, 32)])
def test_plain_local_attention_matches_jax(window, chunk):
    """The plain ops carry the window/chunk mask forms for later slices."""
    rng = np.random.default_rng(6)
    q = _rand(rng, B, S, LS, NQ, HD)
    kp, vp = _rand(rng, B, LP, NKV, HD), _rand(rng, B, LP, NKV, HD)
    ks, vs = _rand(rng, B, S, LS, NKV, HD), _rand(rng, B, S, LS, NKV, HD)
    got = fa.flash_prefix_shared_attention(
        _t(q), _t(kp), _t(vp), _t(ks), _t(vs), _t(PLEN), window=window, chunk=chunk
    ).numpy()
    for b in range(B):
        args = [jnp.asarray(a[b]) for a in (q, kp, vp, ks, vs)]
        want = jattn.prefix_shared_attention(
            *args, jnp.int32(PLEN[b]), window=window, chunk=chunk
        )
        np.testing.assert_allclose(got[b], np.asarray(want), atol=ATOL, rtol=0)


LOCAL_FORMS = [(48, None), (None, 32)]


@pytest.mark.parametrize("local_on", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("window,chunk", LOCAL_FORMS, ids=["window48", "chunk32"])
def test_causal_plain_local_matches_pallas(window, chunk, local_on):
    """The causal plain version with a window or chunk and the per-layer
    toggle, against the Pallas kernel in interpret mode on every row that
    sees a key. Padding rows that see none (prompt 1's rows past its 37 keys
    plus the window) are 0 here and in the CUDA kernels; the Pallas kernel
    leaves there the mean of V over the blocks it loaded. No real row reads
    them: their keys lie past valid_len."""
    rng = np.random.default_rng(7)
    q, k, v = _rand(rng, B, LP, NQ, HD), _rand(rng, B, LP, NKV, HD), _rand(rng, B, LP, NKV, HD)
    got = fa.flash_causal_attention(_t(q), _t(k), _t(v), _t(PLEN), window=window, chunk=chunk,
                                    local_on=local_on).numpy()
    local = np.asarray(jattn.causal_mask(LP, LP, window=window, chunk=chunk))
    base = local if local_on else np.asarray(jattn.causal_mask(LP, LP))
    for b in range(B):
        pal = jpallas.flash_causal_attention(
            jnp.asarray(q[b]), jnp.asarray(k[b]), jnp.asarray(v[b]), jnp.int32(PLEN[b]),
            window=window, chunk=chunk, local_on=jnp.asarray(local_on), interpret=True,
        )
        seen = (base & (np.arange(LP)[None, :] < PLEN[b])).any(-1)
        assert seen[: PLEN[b]].all()
        np.testing.assert_allclose(got[b][seen], np.asarray(pal)[seen], atol=ATOL, rtol=0)
        assert not got[b][~seen].any()


@pytest.mark.parametrize("local_on", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("window,chunk", LOCAL_FORMS, ids=["window48", "chunk32"])
def test_decode_plain_local_matches_pallas(window, chunk, local_on):
    """The decode plain version with a window or chunk and the toggle, hd
    128 (the Pallas decode kernel's eligibility), against the kernel in
    interpret mode."""
    rng = np.random.default_rng(8)
    hd, t = 128, 2
    q = _rand(rng, B, S, 1, NQ, hd)
    kp, vp = _rand(rng, B, LP, NKV, hd), _rand(rng, B, LP, NKV, hd)
    ks, vs = _rand(rng, B, S, LS, NKV, hd), _rand(rng, B, S, LS, NKV, hd)
    kg, vg = _rand(rng, B, S, T, NKV, hd), _rand(rng, B, S, T, NKV, hd)
    got = fa.flash_decode_attention(
        _t(q), _t(kp), _t(vp), _t(ks), _t(vs), _t(kg), _t(vg), _t(PLEN), _t(EOS), t,
        window=window, chunk=chunk, local_on=local_on,
    ).numpy()
    for b in range(B):
        args = [jnp.asarray(a[b]) for a in (q, kp, vp, ks, vs, kg, vg)]
        pal = jpallas.flash_decode_attention(
            *args, jnp.int32(PLEN[b]), jnp.asarray(EOS[b]), jnp.int32(t), window=window,
            chunk=chunk, local_on=jnp.asarray(local_on), interpret=True,
        )
        np.testing.assert_allclose(got[b], np.asarray(pal), atol=ATOL, rtol=0)
