"""Paged, refcounted prefix-KV pool: cross-wave copy-on-write prefix sharing
(the JAX package's ``runtime/kvpool.py``).

A recurring prefix (a system prompt, a shared document) would otherwise be
prefilled again by every wave that carries it. The pool keeps its post-rope
KV for the life of the process:

- **Pages.** A prefix's KV is cut into pages of ``kv_page_tokens`` rows,
  one page per (token chunk, decoder segment). A page holds K and V as CPU
  tensors ``[k_layers, rows, n_kv, hd]`` / ``[..., v_dim]``, evicted and
  healed as one unit.
- **Block tables as a trie.** Pages hang off a trie of token chunks keyed
  by the token ids. A node's identity is its whole root path, so a chunk is
  shared exactly when every token before it matches as well, which is when
  causal attention makes its KV rows equal. An entry's block table is its
  root-to-leaf path; the refcounts on the path are its lease.
- **Copy-on-write.** Prefixes that share a head walk the same nodes
  (``pages_shared``); the first divergent chunk forks a node of its own
  (``cow_splits``). Nothing is copied eagerly.
- **Reuse.** A sealed entry (every decoder segment contributed by a
  completed prefill) lets a later request with the same prefix skip its
  prefix prefill: the engine assembles the pages back into ``[k_layers,
  Lp, n_kv, hd]`` KV and runs only the suffix half of each layer
  (``llama.suffix_only_layer``). Rows at positions >= prefix_len are the
  Lp bucket's pad tail; the last chunk's key folds in the bucket, so a
  different bucket never aliases.
- **Budget and spill.** Resident pages live in host RAM under
  ``kv_pool_gb``. Past it, cold pages of unleased paths spill to disk
  (``kv_host_spill``: an atomic ``.npy`` with a ``.crc`` sidecar, the
  activation store's format, re-read up to three times on load, which
  heals; persistent corruption raises ``SpillCorruptError``) or drop (the
  entries through them unseal and re-prefill later). Leased pages are
  never evicted.

Longrope models are excluded by the engine: their prefix KV depends on the
prompt's total length through the rope-table switch.

- **Export and restore.** A graceful restart writes each live request's
  entry to checksummed ``.npy`` page files (``export_entry``, the spill
  format) and records their refs in the request WAL; the next process's
  replay rebuilds and seals the entry from them (``restore_entry``), so the
  replayed request's prefill is a reuse hit. A page that fails its check
  fails the restore (counted) and the request prefills again: the restore
  is never a correctness dependency. The files are the JAX package's, so
  either package restores the other's.

One ``threading.RLock`` guards the pool's state; spill file I/O runs off
the lock. The brownout ladder's ``kv_evict`` rung (``runtime/pressure.py``)
calls :func:`process_pressure_evict`: every pool's effective budget latches
to 0 and its unleased pages spill (or drop) until
:func:`process_pressure_restore`. Under chaos (``set_injector``) a page's
spill read may come back with one bit flipped (``corrupt_activation``),
which its checksum catches and a re-read heals.
"""

from __future__ import annotations

import os
import tempfile
import threading

import numpy as np
import torch

from flexible_llm_sharding_tpu_torch.integrity import manifest as integrity_manifest
from flexible_llm_sharding_tpu_torch.integrity.manifest import SpillCorruptError, SpillReadError
from flexible_llm_sharding_tpu_torch.obs.registry import REGISTRY
from flexible_llm_sharding_tpu_torch.runtime.activations import (
    _SPILL_REREAD_ATTEMPTS,
    _from_numpy,
    _save_npy,
    _to_numpy,
)
from flexible_llm_sharding_tpu_torch.runtime.hostcache import available_host_bytes


class _Page:
    """KV rows of one token chunk of one decoder segment: ``k``/``v`` CPU
    tensors while resident, None while spilled (``paths`` then names the two
    checksummed files). ``pending_spill`` marks a spill write in flight."""

    __slots__ = ("k", "v", "paths", "nbytes", "last_used", "node", "pending_spill")

    def __init__(self, k: torch.Tensor, v: torch.Tensor, node, clock: int):
        self.k = k
        self.v = v
        self.paths: tuple[str, str] | None = None
        self.nbytes = k.numel() * k.element_size() + v.numel() * v.element_size()
        self.last_used = clock
        self.node = node
        self.pending_spill = False

    @property
    def resident(self) -> bool:
        return self.k is not None


class _Node:
    """One token chunk of the trie (identity: the whole root path)."""

    __slots__ = ("key", "parent", "children", "pages", "refs", "span", "entry")

    def __init__(self, key, parent, span):
        self.key = key
        self.parent = parent
        self.children: dict = {}
        self.pages: dict[tuple, _Page] = {}  # seg_key -> page
        self.refs = 0  # live handles whose path includes this node
        self.span = span  # (row_start, row_end) within the Lp bucket
        # Leaf entry metadata (sealed, prefix_len, lp_bucket, seg_keys), or None.
        self.entry: dict | None = None


class PrefixHandle:
    """One request entry's lease on a trie path (its block table).
    ``reusable``: an earlier prefill sealed the same (tokens, bucket) leaf,
    so the engine assembles pages instead of prefilling. The handle
    refcounts every node of its path from ``acquire`` to ``release``."""

    __slots__ = ("pool", "path", "reusable", "released", "segs", "prefix_len", "lp_bucket",
                 "shared_any", "alloc_any")

    def __init__(self, pool, path, prefix_len, lp_bucket, reusable, segs):
        self.pool = pool
        self.path: list[_Node] = path
        self.prefix_len = prefix_len
        self.lp_bucket = lp_bucket
        self.reusable = reusable
        self.released = False
        self.segs: set[tuple] = segs  # decoder seg keys with pages
        self.shared_any = False  # a chunk was already present
        self.alloc_any = False  # a chunk was newly allocated


def _chunk_keys(ids: tuple, prefix_len: int, lp_bucket: int, page_tokens: int):
    """(key, (row_start, row_end)) per chunk. Interior chunks are keyed by
    their token ids; the last carries the bucket's pad tail, so its key folds
    in the bucket."""
    out = []
    for a in range(0, prefix_len, page_tokens):
        b = min(a + page_tokens, prefix_len)
        if b == prefix_len:
            out.append((("tail", ids[a:b], lp_bucket), (a, lp_bucket)))
        else:
            out.append((("mid", ids[a:b]), (a, b)))
    return out


class KVPagePool:
    """Process-lived paged prefix-KV allocator (module docstring)."""

    COUNTERS = (
        "pages_allocated",
        "pages_shared",
        "cow_splits",
        "pages_evicted",
        "pages_healed",
        "prefix_reuse_hits",
    )

    def __init__(self, page_tokens: int, budget_bytes: int, spill_dir: str,
                 host_spill: bool = True):
        self._lock = threading.RLock()
        self.page_tokens = int(page_tokens)  # guarded by: _lock
        self.budget_bytes = int(budget_bytes)  # guarded by: _lock
        self.host_spill = bool(host_spill)  # guarded by: _lock
        self.spill_dir = spill_dir  # guarded by: _lock
        self._root = _Node(None, None, (0, 0))  # guarded by: _lock
        self._pages: set[_Page] = set()  # guarded by: _lock
        self._clock = 0  # guarded by: _lock
        self._page_seq = 0  # guarded by: _lock
        self._dtype: torch.dtype | None = None  # guarded by: _lock
        self.pages_allocated = 0  # guarded by: _lock
        self.pages_shared = 0  # guarded by: _lock
        self.cow_splits = 0  # guarded by: _lock
        self.pages_evicted = 0  # guarded by: _lock
        self.pages_healed = 0  # guarded by: _lock
        self.prefix_reuse_hits = 0  # guarded by: _lock
        self.bytes_resident = 0  # guarded by: _lock
        self.entries_sealed = 0  # guarded by: _lock
        self.entries_exported = 0  # guarded by: _lock
        self.entries_restored = 0  # guarded by: _lock
        self.restore_failures = 0  # guarded by: _lock
        self._injector = None  # guarded by: _lock
        self._pressure_evicting = False  # guarded by: _lock

    # -- configuration -----------------------------------------------------

    def set_budget(self, budget_bytes: int) -> None:
        with self._lock:
            self.budget_bytes = int(budget_bytes)
        self._enforce_budget()

    def set_injector(self, injector) -> None:
        """Chaos only: ``corrupt_activation`` fires on every page spill
        read (None turns it off)."""
        with self._lock:
            self._injector = injector

    # -- lease lifecycle ---------------------------------------------------

    def acquire(self, ids: tuple, prefix_len: int, lp_bucket: int, salt=None) -> PrefixHandle:
        """Lease the trie path of one tokenized prefix: missing nodes are
        created (a prefill's ``contribute`` fills their pages) and every node
        refcounted. ``salt`` (hashable; None = none) forks the whole path by
        wrapping the first chunk's key only."""
        with self._lock:
            if prefix_len <= 0 or self.page_tokens <= 0:
                return PrefixHandle(self, [], prefix_len, lp_bucket, False, set())
            path = []
            node = self._root
            for ci, (key, span) in enumerate(
                    _chunk_keys(tuple(ids), prefix_len, lp_bucket, self.page_tokens)):
                if salt is not None and ci == 0:
                    key = ("salted", salt, key)
                child = node.children.get(key)
                if child is None:
                    child = _Node(key, node, span)
                    node.children[key] = child
                child.refs += 1
                path.append(child)
                node = child
            e = path[-1].entry
            reusable = bool(e is not None and e["sealed"] and e["lp_bucket"] == lp_bucket
                            and e["prefix_len"] == prefix_len)
            segs = set(e["seg_keys"]) if reusable else set()
            if reusable:
                self.prefix_reuse_hits += 1
            return PrefixHandle(self, path, prefix_len, lp_bucket, reusable, segs)

    def release(self, handle: PrefixHandle) -> None:
        """Drop the lease (idempotent). Pages stay for later reuse; only the
        refcounts drop, so the path is evictable again."""
        with self._lock:
            if handle.released:
                return
            handle.released = True
            for node in handle.path:
                node.refs -= 1

    # -- write path ----------------------------------------------------------

    def contribute(self, handle: PrefixHandle, seg_key: tuple, k: torch.Tensor,
                   v: torch.Tensor) -> None:
        """Cut one decoder segment's prefix KV of one block row (CPU tensors
        ``[k_layers, Lp_bucket, n_kv, hd]``) into pages along the handle's
        path. Chunks another prefix already contributed are kept
        (``pages_shared``); only the divergent tail allocates."""
        if handle.released or not handle.path:
            return
        with self._lock:
            if self._dtype is None:
                self._dtype = k.dtype
            self._clock += 1
            for node in handle.path:
                page = node.pages.get(seg_key)
                if page is not None:
                    self.pages_shared += 1
                    page.last_used = self._clock
                    handle.shared_any = True
                    continue
                a, b = node.span
                page = _Page(k[:, a:b].clone(memory_format=torch.contiguous_format),
                             v[:, a:b].clone(memory_format=torch.contiguous_format),
                             node, self._clock)
                node.pages[seg_key] = page
                self._pages.add(page)
                self.pages_allocated += 1
                self.bytes_resident += page.nbytes
                handle.alloc_any = True
            handle.segs.add(seg_key)
        self._enforce_budget()

    def seal(self, handle: PrefixHandle) -> None:
        """Mark the entry complete (every decoder segment contributed, the
        wave's prefill finished): later acquires of it are ``reusable``. A
        copy-on-write fork counts once, here."""
        with self._lock:
            if handle.released or not handle.path or not handle.segs:
                return
            leaf = handle.path[-1]
            if leaf.entry is None or not leaf.entry["sealed"]:
                self.entries_sealed += 1
            leaf.entry = {
                "sealed": True,
                "prefix_len": handle.prefix_len,
                "lp_bucket": handle.lp_bucket,
                "seg_keys": frozenset(handle.segs),
            }
            if handle.shared_any and handle.alloc_any:
                self.cow_splits += 1

    # -- read path -----------------------------------------------------------

    def assemble(self, handle: PrefixHandle, seg_key: tuple):
        """(k, v) CPU tensors ``[k_layers, lp_bucket, n_kv, hd]`` of one
        decoder segment, concatenated from the handle's pages; spilled pages
        reload through the verified read (:meth:`_unspill`)."""
        with self._lock:
            if handle.released or seg_key not in handle.segs:
                raise KeyError(f"kvpool: segment {seg_key!r} not present for this prefix entry")
            self._clock += 1
            pages = []
            for node in handle.path:
                page = node.pages[seg_key]
                page.last_used = self._clock
                pages.append(page)
            jobs = [p for p in pages if not p.resident]
        for page in jobs:
            self._unspill(page)
        with self._lock:
            ks = [p.k for p in pages]
            vs = [p.v for p in pages]
        return (torch.cat(ks, dim=1) if len(ks) > 1 else ks[0],
                torch.cat(vs, dim=1) if len(vs) > 1 else vs[0])

    def entry_bytes(self, handle: PrefixHandle) -> int:
        """Bytes the pool holds for this entry's prefix KV (its pages over
        every contributed segment, resident or spilled)."""
        with self._lock:
            total = 0
            for node in handle.path:
                for seg_key in handle.segs:
                    page = node.pages.get(seg_key)
                    if page is not None:
                        total += page.nbytes
            return total

    # -- durable export/restore (the request WAL) ----------------------------

    def export_entry(self, handle: PrefixHandle, dirpath: str, prefix_ids: tuple,
                     salt=None) -> dict | None:
        """Write one entry's prefix KV to checksummed ``.npy`` page files
        in a new directory under ``dirpath`` (``_save_npy`` with its
        ``.crc`` sidecar) and return the JSON-able refs
        :meth:`restore_entry` rebuilds it from. ``prefix_ids``/``salt`` are
        the acquire key. None, never a raise, when the entry cannot be
        exported (a released handle, an unreadable page, a full disk): the
        replay then prefills again.

        Every export's directory is new (``mkdtemp``), so a later start's
        export never rewrites the files that an older export's refs, still
        held by a parked request, name. (The JAX package numbers its files
        from a per-process counter, which restarts at every start.)"""
        if handle.released or not handle.path or not handle.segs:
            return None
        dtype_name = None
        segs = []
        try:
            os.makedirs(dirpath, exist_ok=True)
            export_dir = tempfile.mkdtemp(prefix="walkv-", dir=dirpath)
            for seg_key in sorted(handle.segs):
                k, v = self.assemble(handle, seg_key)
                if dtype_name is None:
                    dtype_name = str(k.dtype).removeprefix("torch.")
                stem = os.path.join(export_dir, "-".join(str(part) for part in seg_key))
                kp, vp = f"{stem}-k.npy", f"{stem}-v.npy"
                _save_npy(kp, _to_numpy(k))
                _save_npy(vp, _to_numpy(v))
                segs.append([list(seg_key), kp, vp])
        except (OSError, SpillCorruptError, SpillReadError, KeyError):
            return None
        with self._lock:
            self.entries_exported += 1
        return {
            "prefix_ids": [int(t) for t in prefix_ids],
            "prefix_len": int(handle.prefix_len),
            "lp_bucket": int(handle.lp_bucket),
            "salt": salt,
            # bfloat16 pages are stored as their uint16 bits: the refs name
            # the real dtype.
            "dtype": dtype_name,
            "segs": segs,
        }

    def restore_entry(self, refs: dict) -> bool:
        """Rebuild and seal one entry from :meth:`export_entry` refs, each
        page file checked against its sidecar. True on success, also when
        the entry is already sealed here; False, never a raise, on any read
        or check failure (counted), and the caller prefills again."""
        try:
            ids = tuple(int(t) for t in refs["prefix_ids"])
            dtype = getattr(torch, refs["dtype"])
            if not isinstance(dtype, torch.dtype):
                raise TypeError(f"kvpool: {refs['dtype']!r} is not a dtype")
            lp_bucket = int(refs["lp_bucket"])
            h = self.acquire(ids, int(refs["prefix_len"]), lp_bucket, salt=refs.get("salt"))
            try:
                if h.reusable:
                    return True
                for seg, kp, vp in refs["segs"]:
                    kv = []
                    for path in (kp, vp):
                        arr = np.load(path)
                        if arr.ndim != 4 or arr.shape[1] != lp_bucket:
                            raise SpillCorruptError(
                                f"{path} (wal kv export): shape {arr.shape} does not hold "
                                f"{lp_bucket} positions")
                        side = integrity_manifest.read_sidecar(path)
                        if side is not None:
                            csum, nbytes = side
                            if (int(arr.nbytes) != nbytes
                                    or integrity_manifest.tensor_checksum(arr) != csum):
                                raise SpillCorruptError(
                                    f"{path} (wal kv export): checksum mismatch")
                        kv.append(_from_numpy(arr, dtype))
                    self.contribute(h, tuple(seg), kv[0], kv[1])
                self.seal(h)
            finally:
                self.release(h)
        except (OSError, ValueError, EOFError, KeyError, TypeError, AttributeError,
                SpillCorruptError, SpillReadError):
            with self._lock:
                self.restore_failures += 1
            return False
        with self._lock:
            self.entries_restored += 1
        return True

    # -- eviction / spill ----------------------------------------------------

    def _pick_victim(self) -> _Page | None:
        # Caller holds _lock. LRU over resident pages of unleased paths.
        best = None
        for page in self._pages:
            if not page.resident or page.pending_spill or page.node.refs > 0:
                continue
            if best is None or page.last_used < best.last_used:
                best = page
        return best

    def _page_paths(self) -> tuple[str, str]:
        # Caller holds _lock.
        self._page_seq += 1
        stem = os.path.join(self.spill_dir, f"kvpage-{self._page_seq:08d}")
        return f"{stem}-k.npy", f"{stem}-v.npy"

    def _enforce_budget(self) -> None:
        """Evict LRU unleased pages until the resident bytes fit the
        budget; spill writes run off the lock (whole-or-absent files)."""
        while True:
            with self._lock:
                if self.bytes_resident <= self._effective_budget():
                    return
                page = self._pick_victim()
                if page is None:
                    return  # everything left is leased
                if not self.host_spill:
                    self._drop_page(page)
                    continue
                page.pending_spill = True
                k, v = page.k, page.v
                kp, vp = self._page_paths()
                spill_dir = self.spill_dir
            try:
                os.makedirs(spill_dir, exist_ok=True)
                _save_npy(kp, _to_numpy(k))
                _save_npy(vp, _to_numpy(v))
                ok = True
            except OSError:
                ok = False  # disk full or unwritable: drop instead
            with self._lock:
                page.pending_spill = False
                if not page.resident:
                    continue  # dropped meanwhile
                if ok:
                    page.k = page.v = None
                    page.paths = (kp, vp)
                    self.bytes_resident -= page.nbytes
                    self.pages_evicted += 1
                else:
                    self._drop_page(page)

    def _drop_page(self, page: _Page) -> None:
        # Caller holds _lock. Every sealed entry whose path crosses this
        # node unseals, so later acquires re-prefill instead of assembling
        # a hole.
        node = page.node
        for seg_key, p in list(node.pages.items()):
            if p is page:
                del node.pages[seg_key]
                break
        self._pages.discard(page)
        if page.resident:
            self.bytes_resident -= page.nbytes
            page.k = page.v = None
        self.pages_evicted += 1
        self._remove_spill_files(page)
        self._unseal_subtree(node)

    def _unseal_subtree(self, node: _Node) -> None:
        # Caller holds _lock.
        stack = [node]
        while stack:
            n = stack.pop()
            if n.entry is not None and n.entry["sealed"]:
                n.entry["sealed"] = False
                self.entries_sealed -= 1
            stack.extend(n.children.values())

    def _remove_spill_files(self, page: _Page) -> None:
        if page.paths is None:
            return
        for path in page.paths:
            try:
                os.remove(path)
            except OSError:
                pass  # never written, or already removed
            integrity_manifest.remove_sidecar(path)
        page.paths = None

    def _unspill(self, page: _Page) -> None:
        """Reload one spilled page: ``np.load`` and the sidecar's checksum,
        up to ``_SPILL_REREAD_ATTEMPTS`` reads per file (a re-read that
        passes heals, ``pages_healed``); a page that stays unreadable or
        corrupt is dropped (its entries unseal) and the typed spill error
        raised, naming the file."""
        with self._lock:
            if page.resident or page.paths is None:
                return
            paths = page.paths
            dtype = self._dtype
            injector = self._injector
        tensors = []
        healed = False
        for path in paths:
            where = f"{path} (kvpool page)"
            last: Exception | None = None
            decode_failure = False
            arr = None
            for attempt in range(_SPILL_REREAD_ATTEMPTS):
                try:
                    arr = np.load(path)
                    if injector is not None:
                        arr = injector.corrupt_array("corrupt_activation", arr, detail=path)
                except (OSError, ValueError, EOFError) as e:
                    last, decode_failure, arr = e, True, None
                    continue
                side = integrity_manifest.read_sidecar(path)
                if side is not None:
                    csum, nbytes = side
                    if int(arr.nbytes) != nbytes or integrity_manifest.tensor_checksum(arr) != csum:
                        last, decode_failure, arr = (
                            SpillCorruptError(f"{where}: checksum mismatch"), False, None)
                        continue
                if attempt:
                    healed = True
                break
            if arr is None:
                with self._lock:
                    self._drop_page(page)
                exc_type = SpillReadError if decode_failure else SpillCorruptError
                raise exc_type(
                    f"{where}: {'unreadable' if decode_failure else 'corrupt'} after "
                    f"{_SPILL_REREAD_ATTEMPTS} read attempt(s): {last!r}") from last
            tensors.append(_from_numpy(arr, dtype))
        with self._lock:
            if healed:
                self.pages_healed += 1
            if page.resident:
                return  # a concurrent assemble reloaded it
            page.k, page.v = tensors
            self.bytes_resident += page.nbytes
            self._remove_spill_files(page)

    # -- brownout lever ------------------------------------------------------

    def _effective_budget(self) -> int:
        # Caller holds _lock.
        return 0 if self._pressure_evicting else self.budget_bytes

    def pressure_evict(self) -> int:
        """The ``kv_evict`` rung: latch the effective budget to 0 and evict
        every unleased resident page now (spilled with ``host_spill``,
        else dropped and its entries unsealed). Returns the pages this
        call spilled."""
        with self._lock:
            self._pressure_evicting = True
            before = self.pages_evicted
        self._enforce_budget()
        with self._lock:
            return self.pages_evicted - before

    def pressure_restore(self) -> None:
        """Release the rung: the budget applies again and spilled pages
        reload on demand through the verified read."""
        with self._lock:
            self._pressure_evicting = False

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "pages_allocated": self.pages_allocated,
                "pages_shared": self.pages_shared,
                "cow_splits": self.cow_splits,
                "pages_evicted": self.pages_evicted,
                "pages_healed": self.pages_healed,
                "prefix_reuse_hits": self.prefix_reuse_hits,
                "pages_resident": sum(1 for p in self._pages if p.resident),
                "pages_spilled": sum(1 for p in self._pages
                                     if not p.resident and p.paths is not None),
                "bytes_resident": self.bytes_resident,
                "budget_bytes": self._effective_budget(),
                "entries_sealed": self.entries_sealed,
                "entries_exported": self.entries_exported,
                "entries_restored": self.entries_restored,
                "restore_failures": self.restore_failures,
            }

    def summary(self) -> dict:
        """Counters plus a bounded table of the entries (at most 64)."""
        with self._lock:
            entries = []
            stack = [(self._root, 0)]
            while stack and len(entries) < 64:
                node, depth = stack.pop()
                if node.entry is not None:
                    entries.append({
                        "prefix_len": node.entry["prefix_len"],
                        "lp_bucket": node.entry["lp_bucket"],
                        "sealed": node.entry["sealed"],
                        "segs": len(node.entry["seg_keys"]),
                        "chunks": depth,
                        "refs": node.refs,
                    })
                stack.extend((c, depth + 1) for c in node.children.values())
        return {"counters": self.stats(), "entries": entries}


# -- process-wide pools --------------------------------------------------------
# One pool per (model, dtype, paging geometry): engines rebuilt by a recovery,
# and several engines in one process, hit the same sealed prefixes.

_POOLS: dict[tuple, KVPagePool] = {}
_POOLS_LOCK = threading.Lock()


def _auto_budget_bytes() -> int:
    """Auto ``kv_pool_gb``: 5% of the available host RAM capped at 4 GB, or
    1 GB when the available RAM is unknown."""
    avail = available_host_bytes()
    if not avail:
        return int(1e9)
    return min(int(avail * 0.05), int(4e9))


def pool_for(cfg) -> KVPagePool | None:
    """The process pool of this config's (model, dtype, paging geometry), or
    None when disabled (``kv_pool_gb`` 0 or ``kv_page_tokens`` <= 0). Budget
    and spill follow the latest config."""
    budget = cfg.effective_kv_pool_bytes()
    if budget <= 0 or cfg.kv_page_tokens <= 0:
        return None
    key = (cfg.model_path, cfg.dtype, int(cfg.kv_page_tokens), int(cfg.layer_num_per_shard),
           int(cfg.bucket_multiple), int(cfg.max_token_len))
    with _POOLS_LOCK:
        pool = _POOLS.get(key)
        if pool is None:
            pool = KVPagePool(cfg.kv_page_tokens, budget,
                              spill_dir=os.path.join(cfg.disk_folder, "kvpool"),
                              host_spill=cfg.kv_host_spill)
            _POOLS[key] = pool
            # The fls_kvpool_* family scrapes the aggregate the stats lines print.
            REGISTRY.register("kvpool", process_stats)
        else:
            with pool._lock:
                pool.budget_bytes = int(budget)
                pool.host_spill = bool(cfg.kv_host_spill)
    return pool


def process_pools() -> list[KVPagePool]:
    with _POOLS_LOCK:
        return list(_POOLS.values())


def process_pressure_evict() -> int:
    """The ladder's ``kv_evict`` engage: every pool's pages evicted."""
    return sum(pool.pressure_evict() for pool in process_pools())


def process_pressure_restore() -> None:
    """The ladder's ``kv_evict`` release."""
    for pool in process_pools():
        pool.pressure_restore()


def process_stats() -> dict:
    """Counters summed over every live pool (usually one), pre-seeded."""
    agg = {k: 0 for k in KVPagePool.COUNTERS + (
        "pages_resident", "pages_spilled", "bytes_resident", "budget_bytes", "entries_sealed")}
    for pool in process_pools():
        for k, n in pool.stats().items():
            agg[k] = agg.get(k, 0) + n
    return agg


def process_summary() -> dict:
    return {"pools": [pool.summary() for pool in process_pools()]}


def reset_process_pools() -> None:
    """Drop every pool and its spill files (tests)."""
    with _POOLS_LOCK:
        pools = list(_POOLS.values())
        _POOLS.clear()
    for pool in pools:
        with pool._lock:
            pages = list(pool._pages)
        for page in pages:
            pool._remove_spill_files(page)
    REGISTRY.unregister("kvpool")


__all__ = [
    "KVPagePool",
    "PrefixHandle",
    "pool_for",
    "process_pools",
    "process_pressure_evict",
    "process_pressure_restore",
    "process_stats",
    "process_summary",
    "reset_process_pools",
]
