"""Activations parked between shards (the JAX package's
``runtime/activations.py``).

Three places, chosen by ``storage_location``: ``gpu`` keeps each block's
(prefix_h, suffix_h) in device memory, ``cpu`` in host RAM, ``disk`` in the
reference's per-prompt files ``prefix{tag}-{idx:05d}{gen}.npy`` /
``suffix{tag}-{idx:05d}{gen}.npy``.

``cpu`` copies a block from the card into page-locked host tensors with
``non_blocking=True`` on the current stream and records an event; the
block stays pending (its device tensors referenced) until the next store or
its fetch waits on the event, so at most one block is pending and the host
never blocks on a copy into pageable memory. A fetch uploads from the
page-locked tensors with ``non_blocking=True``. Past ``max_in_cpu``
prompts, blocks spill to disk.

``disk`` (and the spills) hand each block, staged the same way, to one
writer thread, at most two writes pending; the writer waits on the block's
event before it saves. Writes ping-pong between two file generations
(``set_shard``): shard k stores generation k % 2 and fetches (k - 1) % 2.
Every ``.npy`` gets a ``.crc`` sidecar, checked on read with up to
``_SPILL_REREAD_ATTEMPTS`` reads before ``SpillCorruptError`` /
``SpillReadError``. ``flush`` is the barrier a crash-resume marker waits on;
``fetch_recompute`` reads the previous shard's inputs back from the other
generation, for the executor's recompute of a corrupt spill.

A spill write is atomic (temp file, fsync, rename) and retried under the
policy (``spill_write``); ``ENOSPC``, real or injected (the ``disk_full``
site, fired inside the write), is noted as a pressure event, and on
exhaustion raises ``DiskFullError`` naming the file, with no temp file
left. Under chaos a spill read may come back with one bit flipped (the
``corrupt_activation`` site), which its checksum catches and a re-read
heals.

In DP mode (``rank_tag``) the file names carry the device's rank, as the
reference's do: ``suffix{rank}-{idx:05d}.npy``. A fetch returns a block on
the store's device, or on the ``device`` it is given (the MP pipeline's
next stage).
"""

from __future__ import annotations

import errno
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from flexible_llm_sharding_tpu_torch.faults.retry import retry_call
from flexible_llm_sharding_tpu_torch.integrity import manifest as integrity_manifest
from flexible_llm_sharding_tpu_torch.integrity.manifest import SpillCorruptError, SpillReadError
from flexible_llm_sharding_tpu_torch.runtime.pressure import DiskFullError
from flexible_llm_sharding_tpu_torch.runtime.pressure import note_event as _note_pressure_event
from flexible_llm_sharding_tpu_torch.utils.checkpoint import tensor_from_numpy

_SPILL_REREAD_ATTEMPTS = 3


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy; bfloat16 as its 16 raw bits (uint16), as the
    JAX store writes its extension dtypes."""
    return t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _save_npy(path: str, arr: np.ndarray, injector=None) -> None:
    """Atomic ``np.save`` (temp + fsync + rename), then the ``.crc``
    sidecar; a failed sidecar write removes any stale one. A failed write
    removes its temp file. ``injector`` fires ``disk_full`` once the bytes
    are in the temp file, where a real full disk raises (at the flush)."""
    tmp = f"{path}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.save(f, arr)
            if injector is not None:
                injector.fire("disk_full", detail=path)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    try:
        integrity_manifest.write_sidecar(path, arr)
    except BaseException:
        integrity_manifest.remove_sidecar(path)
        raise


def _from_numpy(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bfloat16 and arr.dtype.itemsize == 2 and arr.dtype.kind in "uiV":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return tensor_from_numpy(arr).to(dtype)


class _Staged:
    """A block's host copies (page-locked on a CUDA run), the event that
    marks them complete and, until then, the device tensors they copy."""

    def __init__(self, prefix_h, suffix_h):
        self.device_refs = (prefix_h, suffix_h)
        self.event = None
        if suffix_h.device.type == "cuda":
            self.prefix = None if prefix_h is None else self._copy(prefix_h)
            self.suffix = self._copy(suffix_h)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(suffix_h.device))
        else:
            self.prefix, self.suffix = prefix_h, suffix_h

    @staticmethod
    def _copy(t: torch.Tensor) -> torch.Tensor:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    def resolve(self) -> tuple:
        """Wait for the copies and release the device tensors."""
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        self.device_refs = None
        return self.prefix, self.suffix


class ActivationStore:
    """Store/fetch (prefix_h [B, Lp, D] | None, suffix_h [B, S, Ls, D]) per
    block id; fetch returns tensors on ``device``. ``integrity`` (an
    ``IntegrityRecorder``) counts spill mismatches and re-read heals;
    ``retry_policy``/``retry_recorder`` drive spill writes; ``injector``
    (chaos only) fires ``disk_full`` in each write attempt and
    ``corrupt_activation`` on each read."""

    _MAX_PENDING_WRITES = 2

    def __init__(self, location: str, device: torch.device, dtype: torch.dtype,
                 disk_folder: str = "./temp", max_in_cpu: int | None = None,
                 batch: int = 0, integrity=None, retry_policy=None, retry_recorder=None,
                 device_rank: int = 0, rank_tag: bool = False, injector=None):
        if location not in ("gpu", "cpu", "disk"):
            raise ValueError(f"storage_location must be gpu|cpu|disk, got {location!r}")
        self.location = location
        self.device = device
        self.dtype = dtype
        self.disk_folder = disk_folder
        self.max_in_cpu = max_in_cpu
        self.tag = batch_tag(batch, device_rank if rank_tag else None)
        self._mem: dict[object, object] = {}
        self._spilled: set[object] = set()
        self._cpu_prompts = 0
        self._pending: list[object] = []  # cpu blocks whose copies are unresolved
        self._writer: ThreadPoolExecutor | None = None
        self._write_futs: list = []
        self._store_gen = 0
        self._fetch_gen = 0
        self._shard_idx = 0
        self._integrity = integrity
        self._retry = retry_policy
        self._retry_recorder = retry_recorder
        self._injector = injector
        if location == "disk":
            os.makedirs(disk_folder, exist_ok=True)

    def _paths(self, idx: int, gen: int = 0) -> tuple[str, str]:
        g = f".g{gen}" if gen else ""
        return (
            os.path.join(self.disk_folder, f"prefix{self.tag}-{idx:05d}{g}.npy"),
            os.path.join(self.disk_folder, f"suffix{self.tag}-{idx:05d}{g}.npy"),
        )

    def set_shard(self, shard_idx: int) -> None:
        """Declare the shard about to run: in disk mode its stores go to
        generation ``shard_idx % 2`` and its fetches read ``(shard_idx - 1) %
        2``, so a shard never overwrites its own inputs. cpu spills keep
        generation 0 (they live within one shard)."""
        self._shard_idx = shard_idx
        if self.location == "disk":
            self._store_gen = shard_idx % 2
            self._fetch_gen = (shard_idx - 1) % 2

    def _write_spill(self, path: str, arr: np.ndarray) -> None:
        """One spill file, written atomically under the retry policy; a full
        disk is noted as a pressure event on every attempt and, once the
        retries are spent, raises ``DiskFullError`` naming the file."""

        def attempt() -> None:
            try:
                _save_npy(path, arr, self._injector)
            except OSError as e:
                if e.errno == errno.ENOSPC:
                    _note_pressure_event("disk_full")
                raise

        try:
            retry_call(attempt, policy=self._retry, label="spill_write",
                       recorder=self._retry_recorder)
        except OSError as e:
            if e.errno == errno.ENOSPC:
                raise DiskFullError(
                    errno.ENOSPC,
                    f"spill write failed, disk full: {path} (shard {self._shard_idx}); no "
                    "partial file was left",
                ) from e
            raise

    def _store_disk(self, prompt_idxs, staged: _Staged, gen: int) -> None:
        prefix, suffix = staged.resolve()
        os.makedirs(self.disk_folder, exist_ok=True)
        for row, idx in enumerate(prompt_idxs):
            ppath, spath = self._paths(idx, gen)
            self._write_spill(spath, _to_numpy(suffix[row]))
            if prefix is not None:
                self._write_spill(ppath, _to_numpy(prefix[row]))

    def _submit_disk(self, prompt_idxs, prefix_h, suffix_h) -> None:
        staged = _Staged(prefix_h, suffix_h)  # the copy starts before queueing
        if self._writer is None:
            self._writer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="act-disk-writer")
        # The generation is taken now: the writer may run after set_shard.
        self._write_futs.append(
            self._writer.submit(self._store_disk, list(prompt_idxs), staged, self._store_gen))
        while len(self._write_futs) > self._MAX_PENDING_WRITES:
            self._write_futs.pop(0).result()

    def flush(self) -> None:
        """Wait for every queued disk write (re-raising a writer failure): the
        barrier before a resume marker may claim the shard that wrote them."""
        while self._write_futs:
            self._write_futs.pop(0).result()

    def _read_spill(self, path: str) -> torch.Tensor:
        """One verified spill read, re-read up to ``_SPILL_REREAD_ATTEMPTS``
        times; persistent failure raises naming the file and the shard."""
        where = f"{path} (activation spill, shard {self._shard_idx})"
        last: Exception | None = None
        decode_failure = False
        for attempt in range(_SPILL_REREAD_ATTEMPTS):
            try:
                arr = np.load(path)
                if self._injector is not None:
                    arr = self._injector.corrupt_array("corrupt_activation", arr, detail=path)
            except (OSError, ValueError, EOFError) as e:
                last, decode_failure = e, True
                if self._integrity is not None:
                    self._integrity.count("integrity_failures")
                continue
            side = integrity_manifest.read_sidecar(path)
            if side is not None:
                csum, nbytes = side
                if int(arr.nbytes) != nbytes or integrity_manifest.tensor_checksum(arr) != csum:
                    last, decode_failure = SpillCorruptError(f"{where}: checksum mismatch"), False
                    if self._integrity is not None:
                        self._integrity.count("integrity_failures")
                    continue
            if attempt and self._integrity is not None:
                self._integrity.count("reread_heals")
            return _from_numpy(arr, self.dtype)
        exc_type = SpillReadError if decode_failure else SpillCorruptError
        raise exc_type(
            f"{where}: {'unreadable' if decode_failure else 'corrupt'} after "
            f"{_SPILL_REREAD_ATTEMPTS} read attempt(s): {last!r}"
        ) from last

    def _fetch_disk(self, prompt_idxs, with_prefix: bool, gen: int = 0):
        prefixes, suffixes = [], []
        for idx in prompt_idxs:
            ppath, spath = self._paths(idx, gen)
            suffixes.append(self._read_spill(spath))
            if with_prefix:
                prefixes.append(self._read_spill(ppath))
        return (torch.stack(prefixes) if with_prefix else None), torch.stack(suffixes)

    def store(self, block_id, prompt_idxs: list[int], prefix_h, suffix_h) -> None:
        if self.location == "gpu":
            self._mem[block_id] = (prefix_h, suffix_h)
        elif self.location == "cpu":
            if block_id in self._spilled:
                # A re-store supersedes the spilled copy.
                self._spilled.discard(block_id)
                for idx in prompt_idxs:
                    for path in self._paths(idx):
                        try:
                            os.remove(path)
                        except OSError:
                            pass
                        integrity_manifest.remove_sidecar(path)
            over = (self.max_in_cpu is not None
                    and self._cpu_prompts + len(prompt_idxs) > self.max_in_cpu
                    and block_id not in self._mem)
            if over:
                self._spilled.add(block_id)
                self._submit_disk(prompt_idxs, prefix_h, suffix_h)
                return
            if block_id not in self._mem:
                self._cpu_prompts += len(prompt_idxs)
            self._mem[block_id] = _Staged(prefix_h, suffix_h)
            if block_id not in self._pending:
                self._pending.append(block_id)
            while len(self._pending) > 1:
                self._finalize(self._pending.pop(0))
        else:
            self._submit_disk(prompt_idxs, prefix_h, suffix_h)

    def _finalize(self, block_id) -> None:
        entry = self._mem.get(block_id)
        if isinstance(entry, _Staged):
            self._mem[block_id] = entry.resolve()

    def fetch(self, block_id, prompt_idxs: list[int], with_prefix: bool = True, device=None):
        if self.location == "cpu" and block_id in self._pending:
            self._pending.remove(block_id)
            self._finalize(block_id)
        if self.location == "disk" or block_id in self._spilled:
            self._spilled.discard(block_id)
            self.flush()
            gen = self._fetch_gen if self.location == "disk" else 0
            prefix, suffix = self._fetch_disk(prompt_idxs, with_prefix, gen)
        else:
            prefix, suffix = self._mem.pop(block_id)
            if self.location == "cpu":
                self._cpu_prompts -= len(prompt_idxs)
            if not with_prefix:
                prefix = None
        return self._to_device(prefix, suffix, device)

    def _to_device(self, prefix, suffix, device=None):
        device = self.device if device is None else device
        suffix = suffix.to(device, non_blocking=True)
        if prefix is not None:
            prefix = prefix.to(device, non_blocking=True)
        return prefix, suffix

    def fetch_recompute(self, block_id, prompt_idxs: list[int], with_prefix: bool = True,
                        device=None):
        """The previous shard's inputs of one block, on ``device`` (disk mode
        only), for the executor's recompute of a corrupt spill: shard k - 1
        read generation k % 2, the current store generation, which this
        block's store has not overwritten yet (a block stores only after its
        fetch). Other locations pop a block on fetch: SpillCorruptError."""
        if self.location != "disk":
            raise SpillCorruptError(
                "recompute needs disk-mode activation generations "
                f"(storage_location={self.location!r} pops its inputs on fetch)"
            )
        self.flush()
        prefix, suffix = self._fetch_disk(prompt_idxs, with_prefix, self._store_gen)
        return self._to_device(prefix, suffix, device)

    def clear(self) -> None:
        try:
            self.flush()
        finally:
            if self._writer is not None:
                self._writer.shutdown(wait=True)
                self._writer = None
            self._write_futs.clear()
            self._mem.clear()
            self._spilled.clear()
            self._pending.clear()
            self._cpu_prompts = 0


def batch_tag(batch: int, rank: int | None = None) -> str:
    """The disk file and resume-marker tag of a ``num_batch`` batch, after a
    DP rank's number when given: batch 0 keeps the reference's exact file
    names."""
    return ("" if rank is None else str(rank)) + (f".b{batch}" if batch else "")


__all__ = ["ActivationStore", "batch_tag"]
