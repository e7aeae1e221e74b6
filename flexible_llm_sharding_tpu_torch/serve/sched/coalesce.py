"""Admission-time prefix coalescing (the JAX package's
``serve/sched/coalesce.py``): one prefill for the requests of one boundary
that share a tokenized prefix.

A wave entry is one ``(prefix, suffixes)`` prompt, and a prompt's suffixes
already share one prefix-KV prefill. Requests admitted at the same shard-0
boundary whose tokenized prefix matches merge into one ``WaveEntry`` whose
suffixes are the members' in order; the engine prefills the shared prefix
KV once and each member reads its own suffix rows back (``slices``). Suffix
rows are independent given the prefix KV, so a member scores exactly what
it scores alone.

Requests under different LoRA adapters never merge: the adapter id is part
of the key. Not merged either: a request resuming after a preemption (its suffixes grow by
its generated tokens at wave setup) and one whose key function raises
(coalescing is an optimisation; the wave's own checks still reject a
malformed request).
"""

from __future__ import annotations

from flexible_llm_sharding_tpu_torch.serve.batcher import WaveEntry


def build_entries(requests, key_fn) -> list[WaveEntry]:
    """Group one boundary's ``requests`` (order kept) into wave entries by
    ``key_fn(prefix)``, the engine's tokenized-prefix key."""
    groups: dict[object, list] = {}
    order: list[object] = []
    for i, r in enumerate(requests):
        if r.resume_len:
            key = ("resume", i)
        else:
            try:
                # The same prefix under another adapter is another model's
                # KV: the adapter is part of the key.
                key = ("prefix", r.adapter_id, key_fn(r.prefix))
            except Exception:  # a tokenizer edge case degrades to no coalescing
                key = ("solo", i)
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(r)
    entries: list[WaveEntry] = []
    for key in order:
        members = groups[key]
        suffixes: list[str] = []
        slices: list[tuple[int, int]] = []
        for r in members:
            slices.append((len(suffixes), len(r.suffixes)))
            suffixes.extend(r.suffixes)
        entries.append(WaveEntry(requests=members, prefix=members[0].prefix,
                                 suffixes=tuple(suffixes), slices=slices))
    return entries


__all__ = ["build_entries"]
