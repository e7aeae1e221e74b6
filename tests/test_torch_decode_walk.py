"""A CPU emulation of the CUDA decode kernel's walk, held against the JAX
package's decode attention.

``decode_rows_kernel`` (``flexible_llm_sharding_tpu_torch/csrc/flash_attention.cu``)
runs only on the card. Its tiling is emulated here in plain torch, step for
step as the kernel walks:

- the query rows of one KV head are its (suffix, query head) pairs,
  suffix-major, in chunks of ``ROWS`` (one block each);
- per chunk the prefix tiles are walked once for all of its rows, then per
  suffix its own tiles and its generated tiles, for that suffix's rows only;
- tiles are ``TILE`` keys, and the rows at or past a source's limit are
  zero-filled, never read;
- one online-softmax update per tile, with P rounded to V's dtype before PV;
- with a sliding window or chunk, each stretch starts at the tile holding
  the smallest local bound of its rows (for the prefix, over every suffix
  of the chunk), and each row's own bound is tested per key.

The emulation lives here, not in the package: the package keeps one plain
version. It is held against the Pallas kernel in interpret mode (hd 128) and
the XLA op (hd 64), in float32 with atol 1e-5, over the kernel's edge cases
(the same shapes and lengths as ``DECODE_EDGES`` in ``test_torch_cuda.py``),
with and without NaN in every K/V row past a source's limit.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexible_llm_sharding_tpu.ops import pallas_attention as jpallas

jattn = importlib.import_module("flexible_llm_sharding_tpu.ops.attention")

ROWS, TILE = 16, 64  # kDecodeRows and kTile of the kernel
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
ATOL = 1e-5
B, LP, LS = 2, 130, 64


def local_lo(qpos, window=None, chunk=None):
    """The first absolute key position a query at qpos may see."""
    if window is not None:
        return qpos - window + 1
    if chunk is not None:
        return qpos // chunk * chunk
    return 0


def walk_decode(q, kp, vp, ks, vs, kg, vg, plen, eos, t, softcap=None, tiles=None,
                window=None, chunk=None):
    """The kernel's function, computed in its walk order. Shapes as
    ``flash_decode_attention`` (q [B, S, 1, n_q, hd], ...). ``tiles``, if a
    list, gets one (b, kv head, first row, source, first key) per tile read."""
    nb, ns, _, nq, hd = q.shape
    lp, nkv = kp.shape[1], kp.shape[2]
    ls, tg = ks.shape[2], kg.shape[2]
    g = nq // nkv
    scale = 1.0 / math.sqrt(hd)
    out = torch.zeros_like(q)
    for b in range(nb):
        for h in range(nkv):
            for r0 in range(0, ns * g, ROWS):
                rows = range(r0, min(ns * g, r0 + ROWS))
                nr = len(rows)
                qr = torch.stack([q[b, r // g, 0, h * g + r % g] for r in rows]).float()
                m = torch.full((nr,), NEG_INF)
                l = torch.zeros(nr)
                acc = torch.zeros(nr, hd)
                pl = int(plen[b])
                lo = torch.tensor([local_lo(pl + int(eos[b, r // g]) + 1 + t, window, chunk)
                                   for r in rows])
                # (source, K, V, limit, rows ra:rb it updates, position of key 0)
                walk = [(0, kp[b, :, h], vp[b, :, h], min(max(pl, 0), lp), 0, nr, 0)]
                for s in range(r0 // g, rows[-1] // g + 1):
                    ra, rb = max(s * g - r0, 0), min((s + 1) * g - r0, nr)
                    walk.append((1, ks[b, s, :, h], vs[b, s, :, h], min(max(int(eos[b, s]) + 1, 0), ls),
                                 ra, rb, pl))
                    walk.append((2, kg[b, s, :, h], vg[b, s, :, h], min(t + 1, tg), ra, rb,
                                 pl + int(eos[b, s]) + 1))
                for src, k, v, limit, ra, rb, pos0 in walk:
                    first = int(lo[ra:rb].min()) - pos0  # no tile when no key is visible
                    for k0 in range(max(first, 0) // TILE * TILE if first < limit else limit, limit, TILE):
                        n = min(TILE, limit - k0)
                        kt, vt = k.new_zeros(TILE, hd), v.new_zeros(TILE, hd)
                        kt[:n], vt[:n] = k[k0:k0 + n], v[k0:k0 + n]
                        if tiles is not None:
                            tiles.append((b, h, r0, src, k0))
                        sc = qr[ra:rb] @ kt.float().T * scale
                        if softcap is not None:
                            sc = torch.tanh(sc / softcap) * softcap
                        col = torch.arange(TILE)
                        vis = (col < n) & (pos0 + k0 + col >= lo[ra:rb, None])
                        sc = torch.where(vis, sc, NEG_INF)
                        m_new = torch.maximum(m[ra:rb], sc.max(-1).values)
                        p = torch.where(vis, torch.exp(sc - m_new[:, None]), 0.0)
                        alpha = torch.exp(m[ra:rb] - m_new)
                        l[ra:rb] = l[ra:rb] * alpha + p.sum(-1)
                        acc[ra:rb] = acc[ra:rb] * alpha[:, None] + p.to(v.dtype).float() @ vt.float()
                        m[ra:rb] = m_new
                o = torch.where(l[:, None] > 0, acc / l.clamp_min(1e-30)[:, None], 0.0)
                for i, r in enumerate(rows):
                    out[b, r // g, 0, h * g + r % g] = o[i].to(q.dtype)
    return out


def _inputs(seed, s, nq, nkv, hd, tg, t, plen, eos):
    """Seeded float32 inputs, and their K/V with every row past its source's
    limit set to NaN (the zero-filled form is the inputs themselves)."""
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    x = {"q": rnd(B, s, 1, nq, hd), "kp": rnd(B, LP, nkv, hd), "vp": rnd(B, LP, nkv, hd),
         "ks": rnd(B, s, LS, nkv, hd), "vs": rnd(B, s, LS, nkv, hd),
         "kg": rnd(B, s, tg, nkv, hd), "vg": rnd(B, s, tg, nkv, hd)}
    past = {"p": np.arange(LP)[None, :] >= np.asarray(plen)[:, None],
            "s": np.arange(LS)[None, None, :] > np.asarray(eos)[..., None],
            "g": np.broadcast_to(np.arange(tg) > t, (B, s, tg))}
    nan = dict(x)
    for name in ("kp", "vp", "ks", "vs", "kg", "vg"):
        mask = past[name[1]][..., None, None]
        x[name] = np.where(mask, 0.0, x[name]).astype(np.float32)
        nan[name] = np.where(mask, np.nan, x[name]).astype(np.float32)
    return x, nan


# (S, nq, nkv, hd, T, t, prefix_len, suffix_eos, softcap): the shapes and
# lengths of DECODE_EDGES in test_torch_cuda.py, in float32. S*g above ROWS
# spreads a KV head's rows over several chunks (S 7 at g 3 and S 2 at g 32
# split a suffix between two), S 1, prefix lengths 0/1/63/64/65/130 around
# the tiles, eos 0 and Ls-1, t 0 and T-1, hd 64 and softcap.
DECODE_EDGES = [
    (5, 32, 4, 128, 5, 4, [130, 65], [[0, 63, 9, 31, 62], [5, 0, 63, 1, 40]], None),
    (3, 8, 1, 128, 5, 0, [64, 63], [[63, 0, 12], [5, 6, 7]], None),
    (7, 12, 4, 128, 3, 1, [65, 130], [[0, 9, 18, 27, 36, 45, 63]] * 2, None),
    (2, 32, 1, 128, 4, 3, [1, 0], [[0, 63], [63, 31]], None),
    (1, 32, 32, 128, 5, 2, [0, 1], [[0], [63]], None),
    (4, 8, 2, 64, 5, 4, [0, 130], [[0, 63, 20, 33], [63, 0, 1, 2]], None),
    (3, 8, 4, 128, 5, 0, [65, 64], [[0, 63, 17], [31, 32, 0]], None),
    (3, 4, 2, 64, 2, 1, [130, 0], [[63, 0, 1], [2, 63, 0]], None),
    (4, 32, 8, 128, 5, 4, [63, 130], [[0, 63, 5, 6], [7, 8, 63, 0]], 30.0),
]


@pytest.mark.parametrize("nan_past_limits", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize(
    "edge", DECODE_EDGES,
    ids=lambda e: f"S{e[0]}-{e[1]}/{e[2]}-hd{e[3]}-t{e[5]}{'-softcap' if e[8] else ''}")
def test_walk_matches_jax(edge, nan_past_limits):
    s, nq, nkv, hd, tg, t, plen, eos, softcap = edge
    x, nan = _inputs(len(plen) + s + nq + hd, s, nq, nkv, hd, tg, t, plen, eos)
    fed = nan if nan_past_limits else x
    names = ("q", "kp", "vp", "ks", "vs", "kg", "vg")
    got = walk_decode(*(torch.from_numpy(fed[n]) for n in names), torch.tensor(plen),
                      torch.tensor(eos), t, softcap=softcap).numpy()
    assert np.isfinite(got).all()
    for b in range(B):
        args = [jnp.asarray(x[n][b]) for n in names]
        lens = (jnp.int32(plen[b]), jnp.asarray(eos[b], jnp.int32), jnp.int32(t))
        if hd % 128 == 0:  # the Pallas decode kernel's own eligibility
            want = jpallas.flash_decode_attention(*args, *lens, softcap=softcap, interpret=True)
        else:
            want = jattn.decode_attention(*args, *lens, softcap=softcap)
        np.testing.assert_allclose(got[b], np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "s,nq,nkv,chunks",
    [(4, 32, 32, 1), (5, 32, 4, 3), (3, 8, 1, 2), (2, 32, 1, 4), (16, 4, 4, 1), (17, 4, 4, 2)])
def test_walk_reads_each_prefix_tile_once_per_chunk(s, nq, nkv, chunks):
    """Per (prompt, KV head) the prefix tiles are read once per chunk of
    ROWS query rows (once where S*g <= ROWS), and each suffix's own and
    generated tiles once, by the chunk holding its rows (twice where its
    rows straddle two chunks)."""
    tg, t, plen = 3, 2, [130, 64]
    eos = [[(7 * i) % LS for i in range(s)], [LS - 1] * s]
    x, _ = _inputs(0, s, nq, nkv, 64, tg, t, plen, eos)
    tiles = []
    walk_decode(*(torch.from_numpy(x[n]) for n in ("q", "kp", "vp", "ks", "vs", "kg", "vg")),
                torch.tensor(plen), torch.tensor(eos), t, tiles=tiles)
    g = nq // nkv
    assert len({r0 for (_, _, r0, _, _) in tiles}) == chunks == -(-s * g // ROWS)
    for b in range(B):
        prefix = [k0 for (bb, h, _, src, k0) in tiles if bb == b and h == 0 and src == 0]
        assert sorted(prefix) == sorted(list(range(0, plen[b], TILE)) * chunks)
        for src, limits in ((1, [e + 1 for e in eos[b]]), (2, [t + 1] * s)):
            own = [k0 for (bb, h, _, sr, k0) in tiles if bb == b and h == 0 and sr == src]
            straddling = sum(1 for i in range(s) if (i * g) // ROWS != ((i + 1) * g - 1) // ROWS)
            want = sum(-(-lim // TILE) for lim in limits)
            assert want <= len(own) <= want + straddling * -(-max(limits) // TILE)


# Local forms around the 64-key tiles, on edges whose suffixes' eos spread
# over more than a tile, so the bounds of one block's rows fall in
# different tiles.
LOCAL_FORMS = [{"window": 1}, {"window": 48}, {"window": 65}, {"window": 130},
               {"chunk": 32}, {"chunk": 100}]
LOCAL_EDGES = [DECODE_EDGES[0], DECODE_EDGES[2], DECODE_EDGES[5]]


@pytest.mark.parametrize("nan_past_limits", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("local", LOCAL_FORMS, ids=lambda d: "".join(f"{k}{v}" for k, v in d.items()))
@pytest.mark.parametrize("edge", LOCAL_EDGES, ids=lambda e: f"S{e[0]}-{e[1]}/{e[2]}-hd{e[3]}")
def test_local_walk_matches_jax(edge, local, nan_past_limits):
    s, nq, nkv, hd, tg, t, plen, eos, softcap = edge
    x, nan = _inputs(len(plen) + s + nq + hd, s, nq, nkv, hd, tg, t, plen, eos)
    fed = nan if nan_past_limits else x
    names = ("q", "kp", "vp", "ks", "vs", "kg", "vg")
    got = walk_decode(*(torch.from_numpy(fed[n]) for n in names), torch.tensor(plen),
                      torch.tensor(eos), t, softcap=softcap, **local).numpy()
    assert np.isfinite(got).all()
    for b in range(B):
        args = [jnp.asarray(x[n][b]) for n in names]
        lens = (jnp.int32(plen[b]), jnp.asarray(eos[b], jnp.int32), jnp.int32(t))
        if hd % 128 == 0:
            want = jpallas.flash_decode_attention(*args, *lens, softcap=softcap, interpret=True, **local)
        else:
            want = jattn.decode_attention(*args, *lens, softcap=softcap, **local)
        np.testing.assert_allclose(got[b], np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("local", LOCAL_FORMS, ids=lambda d: "".join(f"{k}{v}" for k, v in d.items()))
def test_local_walk_skips_tiles_below_every_bound(local):
    """Per chunk of rows, the first prefix tile read is the one holding the
    smallest bound over the chunk's suffixes; no tile read lies wholly below
    the bound of every row it serves; and every tile holding a key some row
    sees is read."""
    s, nq, nkv, hd, tg, t = 5, 32, 4, 64, 5, 4
    plen = [130, 65]
    eos = [[0, 63, 9, 31, 62], [5, 0, 63, 1, 40]]
    x, _ = _inputs(1, s, nq, nkv, hd, tg, t, plen, eos)
    tiles = []
    walk_decode(*(torch.from_numpy(x[n]) for n in ("q", "kp", "vp", "ks", "vs", "kg", "vg")),
                torch.tensor(plen), torch.tensor(eos), t, tiles=tiles, **local)
    g = nq // nkv
    for b in range(B):
        lo = [local_lo(plen[b] + eos[b][i] + 1 + t, **local) for i in range(s)]
        for r0 in range(0, s * g, ROWS):
            sfx = range(r0 // g, (min(s * g, r0 + ROWS) - 1) // g + 1)
            read = sorted(k0 for (bb, h, rr, src, k0) in tiles if (bb, h, rr, src) == (b, 0, r0, 0))
            low = min(lo[i] for i in sfx)
            need = sorted({j // TILE * TILE for j in range(max(low, 0), plen[b])})
            assert read == need
            for src, pos0 in ((1, lambda i: plen[b]), (2, lambda i: plen[b] + eos[b][i] + 1)):
                own = [k0 for (bb, h, rr, sr, k0) in tiles if (bb, h, rr, sr) == (b, 0, r0, src)]
                for i in sfx:
                    limit = eos[b][i] + 1 if src == 1 else t + 1
                    first = max(lo[i] - pos0(i), 0)
                    want = sorted({j // TILE * TILE for j in range(first, limit)})
                    assert set(want) <= set(own)
                assert all(k0 + TILE > min(lo[i] - pos0(i) for i in sfx) for k0 in own)
