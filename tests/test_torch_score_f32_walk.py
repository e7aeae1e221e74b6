"""A CPU emulation of the float32 scoring kernel's tile plan, held against
the JAX package's Pallas kernels.

``score_kernel_f32`` (``flexible_llm_sharding_tpu_torch/csrc/flash_attention.cu``)
runs only on the card. A block takes 64 query rows of one head and walks,
per source, the 64-key tiles [t0, nt): nt from the source's limit and, for a
causal source, the block's last row; t0 from the local bound of the block's
first row. It tests visibility per (row, key) only on an edge tile: one
holding the limit, the causal diagonal of the block's first row, or a key
below the bound of its last row. Emulated here for every block of a call,
and checked against the Pallas kernels' ``_local_start_block``
(``flexible_llm_sharding_tpu/ops/pallas_attention.py``) and against the
visible pairs of the plain masks: every visible key lies in a walked tile,
and every key of a walked tile that is not an edge is visible to every row
of the block.
"""

import numpy as np
import pytest

from flexible_llm_sharding_tpu.ops import pallas_attention as jpallas

BM = BN = 64  # kTile of the kernel: query rows per block, keys per tile


def local_lo(qpos, window, chunk):
    if window:
        return qpos - window + 1
    if chunk:
        return qpos // chunk * chunk
    return qpos * 0


def plan_source(lim, causal, off, qoff, q0, q_rows, window, chunk):
    """The block's tiles [t0, nt) of one source."""
    nt = -(-lim // BN)
    if causal:
        nt = min(nt, -(-(q0 + q_rows) // BN))
    lo = local_lo(qoff + q0, window, chunk) - off
    return (nt if lo >= lim else min(max(lo, 0) // BN, nt)), nt


def edge(k0, lim, causal, off, q0, lo_last, local):
    return k0 + BN > lim or (causal and k0 + BN - 1 > q0) or (local and off + k0 < lo_last)


def check_block(lim, causal, off, qoff, q0, lq, window, chunk, visible):
    """visible(i, j) -> bool array over rows i [n, 1] and keys j [1, m]."""
    q_rows = min(BM, lq - q0)
    t0, nt = plan_source(lim, causal, off, qoff, q0, q_rows, window, chunk)
    rows = np.arange(q0, q0 + q_rows)[:, None]
    keys = np.arange(max(lim, 1))[None, :]
    vis = visible(rows, keys)
    tiles = keys[0] // BN
    assert not vis[:, (tiles < t0) | (tiles >= nt)].any()  # every visible key is walked
    lo_last = local_lo(qoff + q0 + q_rows - 1, window, chunk)
    for t in range(t0, nt):
        if not edge(t * BN, lim, causal, off, q0, lo_last, bool(window or chunk)):
            assert vis[:, t * BN:(t + 1) * BN].all()  # no per-row test needed
    return t0, nt


LOCAL = [(1, None), (40, None), (48, None), (64, None), (65, None), (130, None), (None, 32),
         (None, 48), (None, 64), (None, 100), (None, None)]


@pytest.mark.parametrize("window,chunk", LOCAL, ids=lambda x: str(x))
@pytest.mark.parametrize("lq,valid", [(1, 1), (63, 62), (65, 65), (256, 41), (576, 513)])
def test_causal_blocks_walk_every_visible_key(window, chunk, lq, valid):
    """The causal form: one source, keys j <= i below the valid length and
    at or above the row's local bound; the first tile is the Pallas
    kernel's wherever the block has a visible key."""
    def visible(i, j):
        return (j <= i) & (j < valid) & (j >= local_lo(i, window, chunk))

    for q0 in range(0, lq, BM):
        t0, nt = check_block(valid, True, 0, 0, q0, lq, window, chunk, visible)
        if t0 < nt and (window or chunk):
            assert t0 == int(jpallas._local_start_block(q0, window, chunk, BN, True))


@pytest.mark.parametrize("window,chunk", LOCAL, ids=lambda x: str(x))
@pytest.mark.parametrize("plen,ls", [(513, 64), (2049, 64), (65, 130), (0, 63)])
def test_prefix_shared_blocks_walk_every_visible_key(window, chunk, plen, ls):
    """The prefix-shared form: the prefix (keys j < prefix_len at j) and the
    suffix's own keys (j <= i, at prefix_len + j), query i at
    prefix_len + i."""
    def lo_of(i):
        return local_lo(plen + i, window, chunk)

    for q0 in range(0, ls, BM):
        t0, nt = check_block(plen, False, 0, plen, q0, ls, window, chunk,
                             lambda i, j: (j < plen) & (j >= lo_of(i)))
        if t0 < nt and (window or chunk):
            assert t0 == min(int(jpallas._local_start_block(plen + q0, window, chunk, BN, True)), nt)
        check_block(ls, True, plen, plen, q0, ls, window, chunk,
                    lambda i, j: (j <= i) & (plen + j >= lo_of(i)))
