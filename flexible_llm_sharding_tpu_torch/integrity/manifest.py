"""Weight-manifest checksums (the JAX package's ``integrity/manifest.py``).

One ``integrity.json`` per prepared model directory, written atomically
after the last layer file, keyed by layer name::

    {"algorithm": "crc32", "layers": {"model.layers.0": {"dtype": "bfloat16",
     "file": "model.layers.0.safetensors", "tensors": {"attn.wq": {"c":
     "9a3f01b2", "n": 16384}, ...}}}, "version": 1}

``c`` is the crc32 (hex) of a tensor's raw stored bytes, ``n`` their count,
``dtype`` the layer's storage-dtype kind. The format is the JAX package's
byte for byte (``json.dump`` with sorted keys), so a directory split by
either package verifies in the other.

Errors: ``ChecksumMismatch`` is an ``IOError`` on purpose, so the retry
policy re-reads (page-cache corruption heals on a re-read);
``ShardCorruptError`` (a ``ShardLoadError``) means the mismatch survived
every re-read; ``PrecisionMismatch`` is a structural dtype-kind
disagreement, never retried; ``SpillCorruptError``/``SpillReadError`` are an
activation spill corrupt or unreadable after its re-reads.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from flexible_llm_sharding_tpu_torch.faults.retry import ShardLoadError

MANIFEST_NAME = "integrity.json"
ALGORITHM = "crc32"
# Key suffixes of the JAX package's quantized leaves' scales (int8, int4).
QUANT_SCALE_SUFFIX = "::scale"
QUANT4_SCALE_SUFFIX = "::scale4"


class ChecksumMismatch(IOError):
    """A stored tensor's bytes do not match the manifest (retryable)."""


class ShardCorruptError(ShardLoadError):
    """A weight shard's checksum mismatch survived every re-read: the bytes
    on disk are wrong. The loader quarantines the path."""


class SpillCorruptError(RuntimeError):
    """An activation spill failed verification even after re-reads."""


class SpillReadError(SpillCorruptError):
    """A spill file could not be read or decoded at all."""


class PrecisionMismatch(ShardLoadError):
    """A layer file's storage-dtype kind disagrees with the manifest's.
    Structural, so not an ``OSError``: a re-read gives the same dtype."""


def _raw_bytes(x) -> np.ndarray:
    """A tensor's (torch or numpy) stored payload as a flat uint8 array,
    without a copy when it is contiguous."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous()
        if t.numel() == 0:
            return np.empty(0, np.uint8)
        return t.reshape(-1).view(torch.uint8).numpy()
    a = np.ascontiguousarray(x)
    if a.nbytes == 0:
        return np.empty(0, np.uint8)
    return a.reshape(-1).view(np.uint8)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


# zlib releases the GIL on each chunk, so the crc pass of the producer
# thread overlaps the consumer's compute. A tensor past _CRC_PARALLEL_MIN
# bytes is hashed in _CRC_PIECE pieces on a small thread pool and the
# pieces' crcs are combined (zlib's crc32_combine, in GF(2)): the same
# crc32 as one pass, a few times faster on a multi-core host.
_CRC_CHUNK = 4 << 20
_CRC_PIECE = 16 << 20
_CRC_PARALLEL_MIN = 2 * _CRC_PIECE
_CRC_THREADS = max(1, min(4, os.cpu_count() or 1))
_crc_pool = None
_crc_pool_lock = threading.Lock()


def _gf2_times(mat: list[int], vec: int) -> int:
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


@functools.lru_cache(maxsize=64)
def _zeros_operator(nbytes: int) -> tuple[int, ...]:
    """The GF(2) matrix that advances a crc32 register over ``nbytes`` zero
    bytes (columns as 32-bit ints)."""
    power = [0xEDB88320] + [1 << n for n in range(31)]  # one zero bit
    op = [1 << n for n in range(32)]  # identity
    bits = 8 * nbytes
    while bits:
        if bits & 1:
            op = [_gf2_times(power, c) for c in op]
        power = [_gf2_times(power, c) for c in power]
        bits >>= 1
    return tuple(op)


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """crc32 of A + B from crc32(A), crc32(B) and len(B)."""
    return _gf2_times(_zeros_operator(len2), crc1) ^ crc2 if len2 else crc1


def _pool():
    global _crc_pool
    with _crc_pool_lock:
        if _crc_pool is None:
            _crc_pool = ThreadPoolExecutor(max_workers=_CRC_THREADS, thread_name_prefix="crc")
        return _crc_pool


def checksum_chunked(flat_u8: np.ndarray, chunk: int = _CRC_CHUNK) -> str:
    """crc32 over a flat uint8 array: ``chunk`` bytes at a time, or, past
    ``_CRC_PARALLEL_MIN`` bytes, in pieces on the crc thread pool."""
    n = flat_u8.nbytes
    if n >= _CRC_PARALLEL_MIN and _CRC_THREADS > 1:
        bounds = [(b, min(b + _CRC_PIECE, n)) for b in range(0, n, _CRC_PIECE)]
        crcs = list(_pool().map(lambda be: zlib.crc32(flat_u8[be[0]: be[1]]), bounds))
        crc = crcs[0]
        for (b, e), c in zip(bounds[1:], crcs[1:]):
            crc = crc32_combine(crc, c, e - b)
        return f"{crc & 0xFFFFFFFF:08x}"
    crc = 0
    for off in range(0, n, chunk):
        crc = zlib.crc32(flat_u8[off: off + chunk], crc)
    return f"{crc & 0xFFFFFFFF:08x}"


def tensor_checksum(x) -> str:
    """crc32 (hex) over a tensor's raw contiguous bytes: the one checksum of
    the manifest, the spill sidecars and the ``verify`` audit."""
    return checksum_chunked(_raw_bytes(x))


def _dtype_name(x) -> str:
    return str(x.dtype).removeprefix("torch.") if isinstance(x, torch.Tensor) else x.dtype.name


def _is_float(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_floating_point()
    dt = np.asarray(x).dtype
    return np.issubdtype(dt, np.floating) or dt.name == "bfloat16"


def flat_dtype_kind(flat: dict) -> str:
    """Storage-dtype kind of one layer file's flat tensors: 'int4' or 'int8'
    when quantized scales are present, else the dtype name of the largest
    float tensor (first in key order on a tie), or 'none'."""
    keys = flat.keys()
    if any(k.endswith(QUANT4_SCALE_SUFFIX) for k in keys):
        return "int4"
    if any(k.endswith(QUANT_SCALE_SUFFIX) for k in keys):
        return "int8"
    best = None
    for k in sorted(keys):
        a = flat[k]
        if _is_float(a) and (best is None or _nbytes(a) > _nbytes(best)):
            best = a
    return _dtype_name(best) if best is not None else "none"


def layer_entry(flat: dict, file_name: str) -> dict:
    """Manifest entry for one layer file's flat tensors, as stored."""
    return {
        "file": file_name,
        "dtype": flat_dtype_kind(flat),
        "tensors": {k: {"c": tensor_checksum(v), "n": _nbytes(v)} for k, v in flat.items()},
    }


def write_manifest(out_dir: str, layers: dict[str, dict]) -> str:
    """Write ``integrity.json`` atomically (tmp + rename). Returns its path."""
    path = os.path.join(out_dir, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"version": 1, "algorithm": ALGORITHM, "layers": layers}, f, sort_keys=True)
    os.replace(tmp, path)
    return path


# (path -> ((mtime_ns, size), parsed)): one parse per manifest generation.
_MANIFEST_CACHE: dict[str, tuple[tuple[int, int], dict]] = {}


def load_manifest(model_dir: str) -> dict | None:
    """The directory's manifest, or None when it has none. A corrupt
    manifest raises: writes are atomic, so torn JSON is itself corruption."""
    path = os.path.join(model_dir, MANIFEST_NAME)
    try:
        st = os.stat(path)
    except OSError:
        return None
    key = (st.st_mtime_ns, st.st_size)
    hit = _MANIFEST_CACHE.get(path)
    if hit is not None and hit[0] == key:
        return hit[1]
    with open(path) as f:
        try:
            data = json.load(f)
        except ValueError as e:
            raise ValueError(
                f"{path}: integrity manifest is corrupt JSON ({e}); re-prepare the model dir "
                "or delete the manifest to load unverified"
            ) from e
    if not isinstance(data.get("layers"), dict):
        raise ValueError(f"{path}: integrity manifest has no 'layers' map")
    _MANIFEST_CACHE[path] = (key, data)
    return data


def manifest_digest(manifest: dict | None) -> str:
    """Stable hash of a manifest ("" when absent)."""
    if manifest is None:
        return ""
    return hashlib.sha1(json.dumps(manifest, sort_keys=True).encode()).hexdigest()


# -- crc verdict cache -------------------------------------------------------
# One crc pass per file generation: a clean full verify is recorded against
# the layer file's (path, mtime_ns, size) and the manifest's (mtime_ns,
# size), so a rewritten shard or manifest re-verifies. Failures are never
# cached.

_VERDICT_CACHE: dict[tuple, tuple] = {}
_VERDICT_LOCK = threading.Lock()
_VERDICT_STATS = {"verdict_hits": 0, "full_verifies": 0}


def _file_key(path: str) -> tuple[int, int] | None:
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_mtime_ns, st.st_size)


def _verdict_key(model_dir: str, file_path: str) -> tuple | None:
    fk = _file_key(file_path)
    mk = _file_key(os.path.join(model_dir, MANIFEST_NAME))
    if fk is None or mk is None:
        return None
    return (file_path, mk)


def verdict_token(model_dir: str, file_path: str):
    """(cache key, file stat) of ``file_path``, taken before its bytes are
    read, or None when either file cannot be stat'ed."""
    key = _verdict_key(model_dir, file_path)
    fk = _file_key(file_path)
    if key is None or fk is None:
        return None
    return (key, fk)


def verdict_cached(token) -> bool:
    """True (counted as a verdict hit) when the generation ``token`` names
    already passed a full verify."""
    if token is None:
        return False
    key, fk = token
    with _VERDICT_LOCK:
        hit = _VERDICT_CACHE.get(key) == fk
        if hit:
            _VERDICT_STATS["verdict_hits"] += 1
        return hit


def record_verdict(token) -> None:
    if token is None:
        return
    key, fk = token
    with _VERDICT_LOCK:
        _VERDICT_CACHE[key] = fk


def invalidate_verdict(file_path: str) -> None:
    """Drop every cached verdict of ``file_path`` (quarantine)."""
    with _VERDICT_LOCK:
        for key in [k for k in _VERDICT_CACHE if k[0] == file_path]:
            del _VERDICT_CACHE[key]


def count_full_verify() -> None:
    with _VERDICT_LOCK:
        _VERDICT_STATS["full_verifies"] += 1


def verdict_stats() -> dict[str, int]:
    """Process-wide ``verdict_hits`` and ``full_verifies``."""
    with _VERDICT_LOCK:
        return dict(_VERDICT_STATS)


def reset_verdicts() -> None:
    """Drop every cached verdict and zero the counters."""
    with _VERDICT_LOCK:
        _VERDICT_CACHE.clear()
        _VERDICT_STATS["verdict_hits"] = 0
        _VERDICT_STATS["full_verifies"] = 0


def verify_flat(layer_name: str, flat: dict, manifest: dict, path: str = "") -> None:
    """Verify one layer's flat stored tensors against the manifest; raise
    ``ChecksumMismatch`` naming the file and tensor. A layer absent from the
    manifest verifies vacuously (drift is the ``verify`` audit's job)."""
    count_full_verify()
    entry = manifest.get("layers", {}).get(layer_name)
    if entry is None:
        return
    where = path or layer_name
    want = entry.get("tensors", {})
    missing = want.keys() - flat.keys()
    if missing:
        raise ChecksumMismatch(
            f"{where}: tensors {sorted(missing)} listed in the integrity manifest are absent "
            "from the file")
    extra = flat.keys() - want.keys()
    if extra:
        raise ChecksumMismatch(
            f"{where}: tensors {sorted(extra)} present in the file but not in the integrity "
            "manifest")
    for key, meta in want.items():
        n = _nbytes(flat[key])
        if n != int(meta["n"]):
            raise ChecksumMismatch(
                f"{where}: tensor {key!r} has {n} bytes, manifest records {meta['n']} "
                "(truncated/resized payload)")
        got = tensor_checksum(flat[key])
        if got != meta["c"]:
            raise ChecksumMismatch(
                f"{where}: tensor {key!r} checksum {got} != manifest {meta['c']} (corrupt bytes)")


# -- spill sidecars ----------------------------------------------------------
# One text sidecar per .npy activation spill: "crc32:<hex>:<nbytes>",
# written atomically after the .npy lands.

SIDECAR_SUFFIX = ".crc"


def write_sidecar(npy_path: str, arr) -> None:
    tmp = npy_path + SIDECAR_SUFFIX + ".tmp"
    with open(tmp, "w") as f:
        f.write(f"{ALGORITHM}:{tensor_checksum(arr)}:{_nbytes(arr)}\n")
    os.replace(tmp, npy_path + SIDECAR_SUFFIX)


def read_sidecar(npy_path: str) -> tuple[str, int] | None:
    """(checksum, nbytes) of a spill, None without a sidecar, and ("", -1)
    for a malformed one (sidecar corruption is corruption)."""
    try:
        with open(npy_path + SIDECAR_SUFFIX) as f:
            algo, csum, nbytes = f.read().strip().split(":")
        if algo != ALGORITHM:
            return ("", -1)
        return (csum, int(nbytes))
    except FileNotFoundError:
        return None
    except (OSError, ValueError):
        return ("", -1)


def remove_sidecar(npy_path: str) -> None:
    try:
        os.remove(npy_path + SIDECAR_SUFFIX)
    except OSError:
        pass


__all__ = [
    "ALGORITHM",
    "MANIFEST_NAME",
    "SIDECAR_SUFFIX",
    "ChecksumMismatch",
    "PrecisionMismatch",
    "ShardCorruptError",
    "SpillCorruptError",
    "SpillReadError",
    "checksum_chunked",
    "crc32_combine",
    "flat_dtype_kind",
    "invalidate_verdict",
    "layer_entry",
    "load_manifest",
    "manifest_digest",
    "read_sidecar",
    "record_verdict",
    "remove_sidecar",
    "reset_verdicts",
    "tensor_checksum",
    "verdict_cached",
    "verdict_stats",
    "verdict_token",
    "verify_flat",
    "write_manifest",
    "write_sidecar",
]
