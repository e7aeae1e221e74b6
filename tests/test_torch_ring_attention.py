"""The port's ring attention (``ops/ring_attention.py``) and its one-axis
device mesh (``parallel/sharding.py``) against the JAX package's, on the
CPU in float32: the port over ``[cpu] * n``, JAX over n of its virtual
CPU devices.

The JAX ring runs its own code (``ring_self_attention``,
``ring_decoder_layer``, ``_ring_local``) with ``jax.shard_map`` swapped for
:func:`vmap_shard_map`: the same per-chip body vmapped over a named axis,
where ``axis_index``, ``ppermute``, ``pmax`` and ``psum`` mean what they
mean on a mesh, compiled as one program (an n-device ``shard_map`` costs
several times more to compile on the CPU). The swapped-in ring equals
JAX's dense attention (``test_vmapped_jax_ring_is_dense_attention``),
which JAX's own ``tests/test_ring_attention.py`` holds its ring on a real
mesh against.

Cases: JAX's ``tests/test_ring_attention.py`` (n in {2, 4, 8} x (n_q,
n_kv) in {(4, 4), (8, 2)} causal, non-causal, the ragged refusal, the
decoder layer on ``tiny_cfg``), the local clauses across block boundaries
(window, chunk, softcap, scale) and MLA's V head dim, and the mesh
helpers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu.ops import ring_attention as jring
from flexible_llm_sharding_tpu.parallel.sharding import make_mesh as jmake_mesh
from flexible_llm_sharding_tpu_torch.config import LlamaConfig
from flexible_llm_sharding_tpu_torch.ops import ring_attention as ring
from flexible_llm_sharding_tpu_torch.parallel.sharding import (
    gather,
    make_mesh,
    replicate,
    shard,
)
from flexible_llm_sharding_tpu_torch.utils.checkpoint import params_from_jax

CPU = torch.device("cpu")
ATOL = RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny tensors (the suite's
    parallel workers would oversubscribe the cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def vmap_shard_map(f, *, mesh, in_specs, out_specs, **_):
    """``jax.shard_map`` over a one-axis mesh as ``jax.vmap`` over that
    axis's name: inputs sharded on their first dimension are split into
    [n, L/n, ...] blocks, replicated ones broadcast, and the outputs joined
    back (a replicated output is every rank's, so rank 0's)."""
    (axis,) = mesh.axis_names
    n = mesh.shape[axis]

    def sharded(spec) -> bool:
        return len(spec) > 0 and spec[0] == axis

    def run(*args):
        ins = [a.reshape(n, a.shape[0] // n, *a.shape[1:]) if sharded(s) else a
               for a, s in zip(args, in_specs)]
        outs = jax.vmap(f, in_axes=tuple(0 if sharded(s) else None for s in in_specs),
                        axis_name=axis)(*ins)
        single = not isinstance(out_specs, tuple)
        specs, outs = ((out_specs,), (outs,)) if single else (out_specs, outs)
        res = tuple(o.reshape(-1, *o.shape[2:]) if sharded(s) else o[0]
                    for o, s in zip(outs, specs))
        return res[0] if single else res

    return run


@pytest.fixture
def vmapped_mesh(monkeypatch):
    monkeypatch.setattr(jax, "shard_map", vmap_shard_map)


def port_cfg(jcfg) -> LlamaConfig:
    return LlamaConfig.from_dict({**dataclasses.asdict(jcfg), "fls_native": True})


def cpu_mesh(n: int):
    return make_mesh({"sp": n}, [CPU] * n)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jax_ring(q, k, v, n, **kw):
    mesh = jmake_mesh({"sp": n}, jax.devices()[:n])
    return np.asarray(jax.jit(lambda a, b, c: jring.ring_self_attention(a, b, c, mesh, **kw))(
        q, k, v))


def _port_ring(q, k, v, n, **kw):
    return ring.ring_self_attention(_t(q), _t(k), _t(v), cpu_mesh(n), **kw).numpy()


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("n_q,n_kv", [(4, 4), (8, 2)])
def test_ring_matches_jax_causal(vmapped_mesh, n_dev, n_q, n_kv):
    rng = np.random.default_rng(0)
    l, hd = 64, 32
    q, k, v = _rand(rng, l, n_q, hd), _rand(rng, l, n_kv, hd), _rand(rng, l, n_kv, hd)
    np.testing.assert_allclose(_port_ring(q, k, v, n_dev), _jax_ring(q, k, v, n_dev),
                               rtol=RTOL, atol=ATOL)


def test_ring_non_causal(vmapped_mesh):
    rng = np.random.default_rng(1)
    l, n_q, n_kv, hd = 32, 4, 4, 16
    q, k, v = _rand(rng, l, n_q, hd), _rand(rng, l, n_kv, hd), _rand(rng, l, n_kv, hd)
    np.testing.assert_allclose(_port_ring(q, k, v, 4, causal=False),
                               _jax_ring(q, k, v, 4, causal=False), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kw", [
    {"window": 20},  # 16-row blocks: the window reaches into the previous block
    {"chunk": 24},  # chunk boundaries inside a block
    {"softcap": 5.0, "scale": 0.3},
    {"window": 1, "causal": False},  # every key at or after the query
], ids=["window", "chunk", "softcap_scale", "window1_noncausal"])
def test_ring_local_clauses_match_jax(vmapped_mesh, kw):
    rng = np.random.default_rng(2)
    l, n_q, n_kv, hd = 64, 8, 2, 16
    q, k, v = _rand(rng, l, n_q, hd), _rand(rng, l, n_kv, hd), _rand(rng, l, n_kv, hd)
    np.testing.assert_allclose(_port_ring(q, k, v, 4, **kw), _jax_ring(q, k, v, 4, **kw),
                               rtol=RTOL, atol=ATOL)


def test_ring_mla_v_dim_matches_jax(vmapped_mesh):
    """V's head dim differs from the q/k head dim (multi-head latent
    attention): the accumulators and the output take V's."""
    rng = np.random.default_rng(3)
    l, n, hd, hd_v = 32, 4, 24, 12
    q, k, v = _rand(rng, l, n, hd), _rand(rng, l, n, hd), _rand(rng, l, n, hd_v)
    got = _port_ring(q, k, v, 4)
    assert got.shape == (l, n, hd_v)
    np.testing.assert_allclose(got, _jax_ring(q, k, v, 4), rtol=RTOL, atol=ATOL)


def test_vmapped_jax_ring_is_dense_attention(vmapped_mesh):
    """The swapped-in JAX ring equals JAX's dense masked attention, which
    JAX's own suite holds its ring on a real mesh against."""
    from flexible_llm_sharding_tpu.ops.attention import attention, causal_mask

    rng = np.random.default_rng(4)
    q, k, v = _rand(rng, 64, 8, 16), _rand(rng, 64, 2, 16), _rand(rng, 64, 2, 16)
    want = np.asarray(attention(q, k, v, causal_mask(64, 64)))
    np.testing.assert_allclose(_jax_ring(q, k, v, 4), want, rtol=RTOL, atol=ATOL)


def test_ring_rejects_ragged():
    q = torch.zeros((60, 4, 16))
    with pytest.raises(ValueError, match="not divisible by sp=8"):
        ring.ring_self_attention(q, q[:, :2], q[:, :2], cpu_mesh(8))
    jq = jnp.zeros((60, 4, 16))
    with pytest.raises(ValueError):
        jring.ring_self_attention(jq, jq[:, :2], jq[:, :2],
                                  jmake_mesh({"sp": 8}, jax.devices()[:8]))


def test_ring_decoder_layer_matches_jax(vmapped_mesh, tiny_cfg):
    rng = np.random.default_rng(2)
    l = 64
    jparams = jax.tree.map(np.asarray, jllama.init_layer_params(jax.random.PRNGKey(0), tiny_cfg))
    x = _rand(rng, l, tiny_cfg.hidden_size)
    mesh = jmake_mesh({"sp": 4}, jax.devices()[:4])
    want_out, want_k, want_v = jax.jit(
        lambda p, x: jring.ring_decoder_layer(p, tiny_cfg, x, mesh, return_kv=True))(jparams, x)
    cfg = port_cfg(tiny_cfg)
    params = params_from_jax({"layers": [jparams]}, dataclasses.replace(cfg, num_hidden_layers=1))
    got_out, got_k, got_v = ring.ring_decoder_layer(params["layers"][0], cfg, _t(x),
                                                    cpu_mesh(4), return_kv=True)
    for got, want in ((got_out, want_out), (got_k, want_k), (got_v, want_v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_make_mesh_checks_the_device_count(monkeypatch):
    mesh = make_mesh({"sp": 4}, [CPU] * 6)
    assert mesh.shape == {"sp": 4} and mesh.devices == (CPU,) * 4
    assert mesh.distinct == [CPU] and [mesh.slot(r) for r in range(4)] == [0] * 4
    assert make_mesh({"sp": -1}, [CPU] * 3).size == 3
    assert make_mesh(None, [CPU] * 2).shape == {"dp": 2}
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        make_mesh({"sp": 4}, [CPU] * 2)
    with pytest.raises(ValueError, match="only one axis"):
        make_mesh({"dp": 1, "sp": 1}, [CPU])
    # The default device list is the cards': none here, and no CPU fallback.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh({"sp": 1})


def test_shard_gather_and_replicate():
    mesh = cpu_mesh(4)
    x = torch.arange(24.0).reshape(8, 3)
    blocks = shard(x, mesh)
    assert [b.shape for b in blocks] == [(2, 3)] * 4
    assert torch.equal(gather(blocks), x)
    tree = {"w": torch.ones(2), "sub": {"b": torch.zeros(1)}}
    per_rank = replicate(tree, mesh)
    # Every rank shares the one device's copy, which is the tree itself.
    assert all(p["w"] is tree["w"] and p["sub"]["b"] is tree["sub"]["b"] for p in per_rank)
    with pytest.raises(ValueError, match="not divisible by sp=4"):
        shard(torch.zeros(6, 2), mesh)


def test_a_hop_to_the_same_device_moves_nothing(monkeypatch):
    """Over [cpu] * n every hop's ``.to`` returns its block itself: the ring
    holds n blocks of K and of V whatever the step."""
    made = []
    real_to = torch.Tensor.to

    def counting_to(self, *args, **kw):
        out = real_to(self, *args, **kw)
        if out is not self:
            made.append(out.shape)
        return out

    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(_rand(rng, 32, 2, 8)) for _ in range(3))
    mesh = cpu_mesh(4)
    blocks = [shard(t, mesh) for t in (q, k, v)]
    monkeypatch.setattr(torch.Tensor, "to", counting_to)
    out = ring.ring_attention_blocks(*blocks, mesh)
    monkeypatch.undo()
    assert made == []  # no copy, dtype casts of same-dtype tensors included
    assert torch.allclose(gather(out), ring.ring_self_attention(q, k, v, cpu_mesh(1)), atol=1e-5)
