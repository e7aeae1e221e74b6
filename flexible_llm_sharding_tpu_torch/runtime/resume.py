"""Disk-mode crash-resume markers (the JAX package's ``runtime/resume.py``).

A marker is a small JSON file in the disk folder that records how many
shards of a run have completed, with their activations durably on disk.

- The file is named by the workload signature (plus the store's batch tag),
  so the batches of a ``num_batch`` loop never consume each other's
  progress.
- The signature hashes the model path, the prompts' token content, the
  shard plan, the dtype, the block size and the manifest digest: resuming
  into another checkpoint, workload or plan restarts from zero instead of
  mixing incompatible activations.
- Writes are atomic (a temp file, then a rename): a crash mid-write keeps
  the old marker.

The signature and the marker JSON are the JAX package's, so either package
resumes a run the other left.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any


def workload_signature(toks, plan_repr: Any, model_path: str, dtype: str, block_size: int,
                       manifest_digest: str = "") -> str:
    """Hash of everything a resumed run must share with the crashed one:
    the model directory's path and, through ``manifest_digest``
    (``integrity.manifest.manifest_digest``, "" without a manifest), its
    content; the prompts' bucket shapes and token ids; the plan; the dtype
    and the block size."""
    h = hashlib.sha1(repr((
        os.path.abspath(model_path),
        len(toks),
        [t.bucket_key for t in toks],
        plan_repr,
        dtype,
        block_size,
        manifest_digest,
    )).encode())
    # Token content, not just shapes: a generation step appends tokens
    # without necessarily crossing a bucket boundary.
    for t in toks:
        h.update(t.prefix_ids.tobytes())
        h.update(t.suffix_ids.tobytes())
    return h.hexdigest()


def marker_path(disk_folder: str, sig: str, tag: str = "") -> str:
    """The signature-named marker file of a disk folder."""
    return os.path.join(disk_folder, f"progress-{sig[:16]}{tag}.json")


def read_marker(path: str, sig: str, manifest_hash: str | None = None) -> dict:
    """The marker's fields, or {} when it is absent, unreadable, of another
    signature, or written against another manifest (``manifest_hash``, when
    both sides have one)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(data, dict) or data.get("signature") != sig:
        return {}
    if manifest_hash is not None and "manifest_hash" in data and data["manifest_hash"] != manifest_hash:
        return {}
    return data


def write_marker(path: str, sig: str, **fields) -> None:
    """Write the marker atomically: a temp file, then a rename."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"signature": sig, **fields}, f)
    os.replace(tmp, path)


def remove_marker(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


__all__ = ["marker_path", "read_marker", "remove_marker", "workload_signature", "write_marker"]
