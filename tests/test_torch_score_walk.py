"""A CPU emulation of the CUDA scoring kernel's tile plan under local
attention, held against the JAX package's Pallas kernels.

``score_tc_kernel`` (``flexible_llm_sharding_tpu_torch/csrc/flash_attention.cu``)
runs only on the card. Its plan (``plan_source`` and ``walk_items``) is
emulated here for one work unit: two consumer warpgroups of 64 query rows,
the two halves of a 128-row causal tile, or two suffixes of one prompt over
the shared prefix. Per source and consumer the plan gives the first tile
``t0`` (from the local bound of the consumer's first row), the end ``nt``,
and ``edge`` (the bound of its last row; tiles starting at or past it need
no per-row test); a tile both consumers share is loaded once, from the
smaller ``t0``, and used by a consumer only within its own [t0, nt).

Checked against the Pallas kernels' ``_local_start_block``
(``flexible_llm_sharding_tpu/ops/pallas_attention.py``) and against the
visible pairs of the plain masks: every visible key lies in a tile its
consumer uses, no used tile lies wholly below every row's bound, and the
per-row test is needed only below ``edge``.
"""

import pytest

from flexible_llm_sharding_tpu.ops import pallas_attention as jpallas

BM = BN = 64  # kBM, kBN of the kernel


def local_lo(qpos, window, chunk):
    if window:
        return qpos - window + 1
    if chunk:
        return qpos // chunk * chunk
    return 0


def plan_source(lim, causal, off, qoff, qa, lq, window, chunk):
    """One consumer's plan of one source: (t0, nt, edge)."""
    last = min(qa + BM, lq) - 1
    nt = -(-lim // BN)
    if causal:
        nt = min(nt, last // BN + 1)
    lo = local_lo(qoff + qa, window, chunk) - off
    t0 = nt if lo >= lim else min(max(lo, 0) // BN, nt)
    return t0, nt, local_lo(qoff + last, window, chunk) - off


def walk_items(plans, shared):
    """[(t, used_by_0, used_by_1)] in load order."""
    (a0, n0, _), (a1, n1, _) = plans
    if shared:
        return [(t, a0 <= t < n0, a1 <= t < n1) for t in range(min(a0, a1), max(n0, n1))]
    return [(t, True, False) for t in range(a0, n0)] + [(t, False, True) for t in range(a1, n1)]


def check_unit(plans, items, rows, visible, off, lo_of):
    """rows[g]: the consumer's query rows; visible(i, j): key j (local
    index) visible to row i; lo_of(i): row i's absolute bound."""
    for g in range(2):
        used = {t for t, *u in items if u[g]}
        t0, nt, edge = plans[g]
        assert used == set(range(t0, nt)) or (not rows[g] and not used)
        for i in rows[g]:
            for j in range(nt * BN):
                if visible(i, j):
                    assert j // BN in used
        for t in used:
            assert t * BN + BN - 1 >= lo_of(rows[g][0]) - off  # not wholly below every bound
            if t * BN >= edge:  # no per-row test: the bound hides nothing here
                assert all(t * BN + c + off >= lo_of(i) for i in rows[g] for c in range(BN))


LOCAL = [(1, None), (48, None), (64, None), (65, None), (130, None), (None, 32), (None, 64),
         (None, 100), (None, None)]


@pytest.mark.parametrize("window,chunk", LOCAL, ids=lambda x: str(x))
@pytest.mark.parametrize("lq,valid", [(256, 41), (256, 256), (130, 130), (576, 513)])
def test_causal_plan_matches_pallas_start(window, chunk, lq, valid):
    """The causal form: two 64-row halves of a 128-row tile share each K/V
    tile; their first tiles differ where the window or chunk binds."""
    lo_of = lambda i: local_lo(i, window, chunk)  # noqa: E731
    for qt in range(-(-lq // (2 * BM))):
        qa = [(2 * qt + g) * BM for g in range(2)]
        active = [a < lq for a in qa]
        plans = [plan_source(valid, True, 0, 0, qa[g], lq, window, chunk) if active[g]
                 else (1 << 30, 0, 0) for g in range(2)]
        for g in range(2):
            if active[g] and plans[g][0] < plans[g][1]:
                want = int(jpallas._local_start_block(qa[g], window, chunk, BN, True)) \
                    if (window or chunk) else 0
                assert plans[g][0] == want
        rows = [list(range(qa[g], min(qa[g] + BM, lq))) if active[g] else [] for g in range(2)]
        visible = lambda i, j: j <= i and j < valid and j >= lo_of(i)  # noqa: E731
        check_unit(plans, walk_items(plans, shared=True), rows, visible, 0, lo_of)


@pytest.mark.parametrize("window,chunk", LOCAL, ids=lambda x: str(x))
@pytest.mark.parametrize("lp,plen,ls", [(576, 513, 64), (2112, 2049, 64), (130, 65, 130)])
def test_prefix_shared_plan_matches_pallas_start(window, chunk, lp, plen, ls):
    """The prefix-shared form: two suffixes at the same positions share the
    prefix tiles (one first tile, the Pallas kernel's prefix start) and walk
    their own suffix tiles, shifted by prefix_len."""
    lo_of = lambda i: local_lo(plen + i, window, chunk)  # noqa: E731
    for qt in range(-(-ls // BM)):
        qa = qt * BM
        rows = [list(range(qa, min(qa + BM, ls)))] * 2
        # Prefix: keys at j < plen, no causality, shared by both consumers.
        plans = [plan_source(plen, False, 0, plen, qa, ls, window, chunk)] * 2
        n_real = min(-(-plen // BN), lp // BN)
        want = min(int(jpallas._local_start_block(plen + qa, window, chunk, BN, True)), n_real) \
            if (window or chunk) else 0
        assert plans[0][0] == (n_real if lo_of(qa) >= plen else want)  # no tile: nothing visible
        visible = lambda i, j: j < plen and j >= lo_of(i)  # noqa: E731
        check_unit(plans, walk_items(plans, shared=True), rows, visible, 0, lo_of)
        # Own suffix keys at plen + j, causal, one walk per consumer.
        plans = [plan_source(ls, True, plen, plen, qa, ls, window, chunk)] * 2
        visible = lambda i, j: j <= i and plen + j >= lo_of(i)  # noqa: E731
        check_unit(plans, walk_items(plans, shared=False), rows, visible, plen, lo_of)
