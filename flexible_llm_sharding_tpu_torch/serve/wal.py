"""The durable request write-ahead log: crash-safe serving, part 1 (the JAX
package's ``serve/wal.py``; the segment format is the same byte for byte, so
either package replays the other's log).

An append-only, length-prefixed, crc-checked segment log records, per
request:

- **admission** (``admit``): the whole request — prompt, budget, tenant,
  SLO class, adapter, client id — and the admission deadline as the
  seconds left (a duration: a restart under clock skew cannot corrupt it);
- **progress** (``progress``): at sweep boundaries, the emitted-token count
  and the token ids emitted since the last record, and, on a graceful
  shutdown, refs to the checksummed prefix-KV page files of a warm restart;
- **terminal outcomes** (``terminal``): done, failed, expired, rejected or
  cancelled, so a replay skips completed requests.

A frame is ``<4-byte LE payload length><8 hex chars of the payload's
crc32><UTF-8 JSON payload>``. A torn tail (a short frame or a crc mismatch:
the process died mid-write) ends the scan at the last good record, is
truncated away and counted, and is never fatal.

``fsync`` policy (``ServeConfig.wal_fsync``): every record is flushed to
the kernel, so a killed process loses nothing already written; ``always``
also fsyncs every record, ``admit`` (the default) the admission and
terminal records (progress is recomputable: greedy decode replays the same
tokens), and ``never`` none.

Segments rotate at ``wal_max_mb``. A sealed segment whose every request id
is terminal is deleted (compaction); an id admitted again after its
terminal (a replay) is open again and pins every segment that names it.

``Request.on_terminal`` keeps the log in step with the request's state: the
queue attaches it at admission. A ``RestartPending`` failure (a graceful
shutdown) writes no terminal record, so the request stays open and the next
start replays it (``serve/recovery.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import threading
import time

from flexible_llm_sharding_tpu_torch.integrity.manifest import checksum_bytes
from flexible_llm_sharding_tpu_torch.obs import events as obs_events
from flexible_llm_sharding_tpu_torch.serve.request import Request, RestartPending

_LEN = struct.Struct("<I")
_CRC_BYTES = 8  # ascii hex crc32
_HEADER = _LEN.size + _CRC_BYTES
# A payload longer than this is a torn length field, not a record.
_MAX_PAYLOAD = 64 * 1024 * 1024
FSYNC_POLICIES = ("always", "admit", "never")
SEGMENT_PREFIX = "wal-"
SEGMENT_SUFFIX = ".log"


def _frame(payload: bytes) -> bytes:
    return _LEN.pack(len(payload)) + checksum_bytes(payload).encode("ascii") + payload


def read_segment(path: str) -> tuple[list[dict], int, bool]:
    """Parse one segment file: ``(records, valid_bytes, torn)``. Stops at
    the first bad frame (short header or payload, crc mismatch, undecodable
    JSON); ``valid_bytes`` is the end of the last good record."""
    records: list[dict] = []
    valid = 0
    torn = False
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except OSError:
        return records, 0, False
    off = 0
    n = len(buf)
    while off < n:
        if off + _HEADER > n:
            torn = True
            break
        (plen,) = _LEN.unpack_from(buf, off)
        if plen > _MAX_PAYLOAD or off + _HEADER + plen > n:
            torn = True
            break
        crc = buf[off + _LEN.size: off + _HEADER]
        payload = buf[off + _HEADER: off + _HEADER + plen]
        if checksum_bytes(payload).encode("ascii") != crc:
            torn = True
            break
        try:
            rec = json.loads(payload.decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            torn = True
            break
        records.append(rec)
        off += _HEADER + plen
        valid = off
    return records, valid, torn


@dataclasses.dataclass
class WalEntry:
    """One request's folded state: its latest admission record, its
    progress, and its outcome (None = open, a replay candidate)."""

    wal_id: str
    admit: dict
    emitted: int = 0
    tokens: list = dataclasses.field(default_factory=list)  # [step][suffix]
    kv: dict | None = None
    outcome: str | None = None

    @property
    def open(self) -> bool:
        return self.outcome is None


def fold_records(records) -> dict[str, WalEntry]:
    """Fold records by request id, in log order: a terminal closes the
    entry; a later admission of the same id opens it again with fresh
    state; progress after a terminal is ignored."""
    entries: dict[str, WalEntry] = {}
    for rec in records:
        wid = rec.get("id")
        kind = rec.get("k")
        if not wid or kind not in ("admit", "progress", "terminal"):
            continue
        e = entries.get(wid)
        if kind == "admit":
            if e is None or e.outcome is not None:
                entries[wid] = WalEntry(wal_id=wid, admit=rec)
            else:
                e.admit = rec  # a second admission while open
        elif e is not None:
            if kind == "progress":
                if e.outcome is not None:
                    continue
                e.emitted = int(rec.get("emitted", e.emitted))
                delta = rec.get("tok_delta")
                if delta:
                    e.tokens.extend(delta)
                if rec.get("kv") is not None:
                    e.kv = rec["kv"]
            else:
                e.outcome = str(rec.get("outcome", "failed"))
    return entries


class RequestWAL:
    """The append-only request log over rotating checksummed segments.
    Thread-safe: admissions come from submitting threads, progress and
    terminals from the engine's. One lock orders the frames; each write is
    a short append on an open file."""

    def __init__(self, wal_dir: str, fsync: str = "admit", max_segment_bytes: int = 64 * 1024 * 1024):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"wal_fsync must be one of {FSYNC_POLICIES}, got {fsync!r}")
        if max_segment_bytes < 4096:
            raise ValueError("wal_max_mb too small: segment floor is 4 KiB")
        self.wal_dir = wal_dir
        self.fsync_policy = fsync
        self.max_segment_bytes = int(max_segment_bytes)
        os.makedirs(wal_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._boot = os.urandom(4).hex()  # keeps wal ids unique across starts
        self._seq = 0  # guarded by: _lock
        self._f = None  # guarded by: _lock
        self._cur_path: str | None = None  # guarded by: _lock
        self._cur_bytes = 0  # guarded by: _lock
        self._cur_ids: set[str] = set()  # guarded by: _lock
        # Sealed segments and the ids each mentions: compaction's input.
        self._sealed: list[tuple[str, set[str]]] = []  # guarded by: _lock
        # id -> terminal?, the liveness view compaction consults.
        self._terminal: dict[str, bool] = {}  # guarded by: _lock
        self.records_written = 0  # guarded by: _lock
        self.bytes_written = 0  # guarded by: _lock
        self.fsyncs = 0  # guarded by: _lock
        self.rotations = 0  # guarded by: _lock
        self.torn_tails = 0  # guarded by: _lock
        self.segments_compacted = 0  # guarded by: _lock
        self.write_errors = 0  # guarded by: _lock
        with self._lock:
            self._next_index = self._scan_existing()

    # -- startup scan ------------------------------------------------------

    def _segment_paths(self) -> list[str]:
        try:
            names = sorted(n for n in os.listdir(self.wal_dir)
                           if n.startswith(SEGMENT_PREFIX) and n.endswith(SEGMENT_SUFFIX))
        except OSError:
            names = []
        return [os.path.join(self.wal_dir, n) for n in names]

    def _scan_existing(self) -> int:
        """Index the segments of earlier starts: seal them (this start
        appends to a fresh one), seed the terminal map, truncate torn tails
        in place, and return the next segment index. Caller holds _lock."""
        last = -1
        for path in self._segment_paths():
            name = os.path.basename(path)
            try:
                last = max(last, int(name[len(SEGMENT_PREFIX):-len(SEGMENT_SUFFIX)]))
            except ValueError:
                continue
            records, valid, torn = read_segment(path)
            if torn:
                self.torn_tails += 1
                try:
                    os.truncate(path, valid)
                except OSError:
                    pass  # a read-only directory: the scan already stops there
                obs_events.emit("wal_torn_tail", segment=name, valid_bytes=valid,
                                records=len(records))
            ids = set()
            for rec in records:
                wid = rec.get("id")
                if not wid:
                    continue
                ids.add(wid)
                if rec.get("k") == "terminal":
                    self._terminal[wid] = True
                elif rec.get("k") == "admit":
                    self._terminal[wid] = False
            self._sealed.append((path, ids))
        return last + 1

    def scan(self) -> dict[str, WalEntry]:
        """Fold every segment, sealed and current, into per-request entries:
        the replay's input."""
        with self._lock:
            paths = [p for p, _ in self._sealed]
            if self._cur_path is not None:
                if self._f is not None:
                    self._f.flush()
                paths.append(self._cur_path)
        records: list[dict] = []
        for path in paths:
            recs, _, _ = read_segment(path)
            records.extend(recs)
        return fold_records(records)

    # -- write path --------------------------------------------------------

    def _open_segment_locked(self) -> None:
        path = os.path.join(self.wal_dir,
                            f"{SEGMENT_PREFIX}{self._next_index:08d}{SEGMENT_SUFFIX}")
        self._next_index += 1
        self._f = open(path, "ab")
        self._cur_path = path
        self._cur_bytes = 0
        self._cur_ids = set()

    def _write(self, rec: dict, sync: bool) -> None:
        frame = _frame(json.dumps(rec, separators=(",", ":")).encode("utf-8"))
        with self._lock:
            try:
                if self._f is None:
                    self._open_segment_locked()
                elif self._cur_bytes and self._cur_bytes + len(frame) > self.max_segment_bytes:
                    self._f.close()
                    self._sealed.append((self._cur_path, self._cur_ids))
                    self.rotations += 1
                    self._open_segment_locked()
                self._f.write(frame)
                # Always handed to the kernel: a killed process loses at
                # most the record in flight.
                self._f.flush()
                if sync:
                    os.fsync(self._f.fileno())
                    self.fsyncs += 1
                self._cur_bytes += len(frame)
                self._cur_ids.add(rec["id"])
                self.records_written += 1
                self.bytes_written += len(frame)
                self._terminal[rec["id"]] = rec["k"] == "terminal"
            except OSError:
                # A full or lost volume must never fail the request being
                # served: durability degrades to a counted drop.
                self.write_errors += 1

    def admit(self, req: Request) -> str:
        """Record an admission before the request joins the queue, and
        attach the terminal hook. A request that already carries a
        ``wal_id`` (a replay) keeps it, and the record opens it again."""
        if req.wal_id is None:
            with self._lock:
                self._seq += 1
                req.wal_id = f"{self._boot}-{self._seq}"
        req.on_terminal = self._on_request_terminal
        self._write({
            "k": "admit",
            "id": req.wal_id,
            "ts": time.time(),
            "prefix": req.prefix,
            "suffixes": list(req.suffixes),
            "max_new_tokens": int(req.max_new_tokens),
            # Seconds left, never an instant: the replay re-arms the clock
            # from it (SchedCore.replay_deadline).
            "deadline_left_s": (max(req.deadline - time.monotonic(), 0.0)
                                if req.deadline is not None else None),
            "slo": req.slo_class,
            "tenant": req.tenant_id,
            "adapter": req.adapter_id,
            "client_id": req.client_id,
            # The replica fleet's id of the caller's request (null outside a
            # fleet): every attempt of one fleet request records the same.
            "dispatch_id": req.dispatch_id,
        }, sync=self.fsync_policy in ("always", "admit"))
        return req.wal_id

    def progress(self, req: Request, tok_delta=None, kv=None) -> None:
        """Record sweep-boundary progress: the emitted-token count, the
        token ids since the last record, and (graceful shutdown) the
        prefix-KV page refs of a warm restart."""
        if req.wal_id is None:
            return
        rec = {"k": "progress", "id": req.wal_id, "ts": time.time(),
               "emitted": int(req.tokens_emitted)}
        if tok_delta is not None:
            rec["tok_delta"] = tok_delta
        if kv is not None:
            rec["kv"] = kv
        self._write(rec, sync=self.fsync_policy == "always")

    def terminal(self, req: Request, outcome: str, error: BaseException | None = None) -> None:
        if req.wal_id is None:
            return
        rec = {"k": "terminal", "id": req.wal_id, "ts": time.time(), "outcome": outcome}
        if error is not None:
            rec["error"] = f"{type(error).__name__}: {error}"[:200]
        self._write(rec, sync=self.fsync_policy in ("always", "admit"))
        self.maybe_compact()

    def _on_request_terminal(self, req: Request, error: BaseException | None) -> None:
        """``Request.on_terminal``: a ``RestartPending`` parks the request,
        so it writes no terminal record and the request stays open."""
        if isinstance(error, RestartPending):
            return
        self.terminal(req, req.status.value, error)

    # -- compaction --------------------------------------------------------

    def maybe_compact(self) -> int:
        """Delete the sealed segments whose every request id is terminal
        now. Returns how many went."""
        with self._lock:
            victims = [(path, ids) for path, ids in self._sealed
                       if all(self._terminal.get(w, False) for w in ids)]
            self._sealed = [s for s in self._sealed if s not in victims]
        removed = 0
        for path, _ in victims:
            try:
                os.remove(path)
                removed += 1
            except OSError:
                pass
        if removed:
            with self._lock:
                self.segments_compacted += removed
        return removed

    # -- lifecycle ---------------------------------------------------------

    def flush(self, sync: bool = True) -> None:
        with self._lock:
            if self._f is not None:
                self._f.flush()
                if sync:
                    try:
                        os.fsync(self._f.fileno())
                        self.fsyncs += 1
                    except OSError:
                        self.write_errors += 1

    def close(self) -> None:
        self.flush(sync=True)
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def stats(self) -> dict:
        with self._lock:
            return {
                "records_written": self.records_written,
                "bytes_written": self.bytes_written,
                "fsyncs": self.fsyncs,
                "rotations": self.rotations,
                "torn_tails": self.torn_tails,
                "segments_compacted": self.segments_compacted,
                "write_errors": self.write_errors,
                "segments": len(self._sealed) + (1 if self._f else 0),
                "open_requests": sum(1 for t in self._terminal.values() if not t),
            }


def wal_for(serve_cfg) -> RequestWAL | None:
    """The WAL a ServeConfig asks for, or None without ``wal_dir``."""
    if not serve_cfg.wal_dir:
        return None
    return RequestWAL(serve_cfg.wal_dir, fsync=serve_cfg.wal_fsync,
                      max_segment_bytes=int(serve_cfg.wal_max_mb * 1024 * 1024))


__all__ = ["FSYNC_POLICIES", "RequestWAL", "WalEntry", "fold_records", "read_segment", "wal_for"]
