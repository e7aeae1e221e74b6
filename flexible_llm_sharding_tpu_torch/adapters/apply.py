"""Batched multi-adapter LoRA application inside one sweep (the JAX
package's ``adapters/apply.py``).

One wave may mix rows of several tenants on different adapters and rows on
the base model. The base weights stream once; at each decoder layer's entry
the engine applies the grouped low-rank shift

    h += (h @ A_g) @ B_g * scale_g

where ``g`` maps each batch row to its adapter group. Group 0 is always the
base, with zero factors and zero scale. ``A``/``B`` are stacked ``[G, D, R]``
/ ``[G, R, D]`` and each row gathers its group's factors, so row order never
changes. An adapter of a smaller rank pads with zeros to the wave's rank R,
which leaves the shift bit-identical (zero columns of A feed zero rows of B).

No kernel: the JAX package computes the shift as two ``jnp.einsum`` over the
gathered factors, outside any Pallas kernel, so here it is two float32
matrix products. :func:`lora_shift` is the JAX function's form (stacked,
padded factors, two batched ``torch.bmm``). The engine runs
:func:`lora_shift_rows`, the same sum row by row with each adapter's own
unpadded factors: on the card the rounding of a float32 product depends on
its shapes (the wave's padded rank, the rows batched together), and a
row's shift must not depend on which tenants share its wave; a base row is
left as it is. A base-only wave passes no delta at all (the decoder loops'
``delta=None`` branch), so its computation is the one without adapters.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch


def lora_shift(h: torch.Tensor, a: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """The grouped delta at one decoder layer: ``h`` batch-major ``[B, ...,
    D]``, ``a``/``b`` the stacked float32 factors ``[G, D, R]``/``[G, R, D]``,
    ``g`` the ``[B]`` row->group map and ``scale`` the ``[G]`` float32
    multipliers. Returns ``h + ((h @ a[g]) @ b[g]) * scale[g]`` in ``h``'s
    dtype. The products run in float32, as JAX promotes a bf16 ``h`` against
    the float32 factors, and the shift is cast to ``h``'s dtype before the
    add."""
    ar = a.index_select(0, g)  # [B, D, R]
    br = b.index_select(0, g)  # [B, R, D]
    s = scale.index_select(0, g)  # [B]
    x = h.reshape(h.shape[0], -1, h.shape[-1]).to(ar.dtype)  # [B, N, D]
    d = torch.bmm(torch.bmm(x, ar), br)  # [B, N, D]
    d = d * s.reshape(-1, 1, 1)
    return h + d.reshape(h.shape).to(h.dtype)


def lora_shift_rows(h: torch.Tensor, pairs: Mapping[int, tuple[torch.Tensor, torch.Tensor]],
                    g: Sequence[int], scale: torch.Tensor) -> torch.Tensor:
    """:func:`lora_shift` row by row: row ``i`` of ``h`` ``[B, ..., D]`` is
    shifted by group ``g[i]``'s own float32 pair ``pairs[g[i]]`` (``A [D,
    r]``, ``B [r, D]``, r its own rank) at ``scale[g[i]]``; base rows (group
    0), and rows whose adapter has no delta on this layer (no pair), are
    returned untouched. ``g`` is a host sequence. One copy of ``h``; only
    the adapter rows are written into it."""
    if not any(gi in pairs for gi in g):
        return h
    out = h.clone()
    for i, gi in enumerate(g):
        pair = pairs.get(gi)
        if pair is None:
            continue
        a, b = pair
        x = h[i].reshape(-1, h.shape[-1]).to(a.dtype)
        d = torch.matmul(torch.matmul(x, a), b) * scale[gi]
        out[i] += d.reshape(h.shape[1:]).to(h.dtype)
    return out


def group_rows(adapter_ids: Sequence[str | None]) -> tuple[list, np.ndarray]:
    """Group a wave's per-row adapter ids: ``(names, g)`` with ``names[0]``
    always None (the base group) and ``g[i]`` indexing ``names`` for row
    ``i``, in first-seen order."""
    names: list = [None]
    index: dict = {None: 0}
    g = []
    for aid in adapter_ids:
        if aid not in index:
            index[aid] = len(names)
            names.append(aid)
        g.append(index[aid])
    return names, np.asarray(g, np.int32)


def group_scales(names: Sequence, plans: Mapping[str, Any]) -> np.ndarray:
    """[G] float32 apply scales, 0.0 for the base group."""
    return np.asarray([0.0 if n is None else float(plans[n].scale) for n in names], np.float32)


def stack_layer(names: Sequence, factors: Mapping[str, Mapping[str, Mapping[str, Any]]],
                layer_name: str, hidden: int, rank: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer's stacked float32 factors ``(A [G, D, R], B [G, R,
    D])`` on the host. The base group and adapters without a delta on this
    layer get zeros; a smaller rank zero-pads to the wave's rank ``R``."""
    a = torch.zeros((len(names), hidden, rank), dtype=torch.float32)
    b = torch.zeros((len(names), rank, hidden), dtype=torch.float32)
    for gi, name in enumerate(names):
        if name is None:
            continue
        pair = factors[name].get(layer_name)
        if pair is None:
            continue
        la, lb = torch.as_tensor(pair["lora_A"]), torch.as_tensor(pair["lora_B"])
        r = int(la.shape[1])
        a[gi, :, :r] = la
        b[gi, :r, :] = lb
    return a, b


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    return int(getattr(v, "nbytes", 0))


def delta_nbytes(delta: Mapping[str, Any] | None) -> int:
    """Bytes of one segment's delta arrays: what uploading them costs."""
    if not delta:
        return 0
    return sum(_nbytes(v) for v in delta.values())


__all__ = ["delta_nbytes", "group_rows", "group_scales", "lora_shift", "lora_shift_rows",
           "stack_layer"]
