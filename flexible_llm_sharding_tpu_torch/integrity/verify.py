"""Offline integrity audit, the ``verify`` subcommand's engine (the JAX
package's ``integrity/verify.py``, less the precision-plan audit, which
comes with ROADMAP 3.5, and the adapter audit, item 7).

Recomputes every checksum of a prepared model directory against its
``integrity.json``, and of a spill directory against the ``.npy``
sidecars. Unlike the load path, the audit is strict: a layer in the
manifest but not on disk, a layer file the manifest lacks, and tensor-set
differences are all problems.
"""

from __future__ import annotations

import os

import numpy as np

from flexible_llm_sharding_tpu_torch.integrity import manifest as iman
from flexible_llm_sharding_tpu_torch.utils.checkpoint import (
    _ST_TO_TORCH,
    LAYER_FILE_SUFFIX,
    safetensors_header,
)


def _problem(file: str, status: str, detail: str = "") -> dict:
    return {"file": file, "status": status, "detail": detail}


def stored_bytes(path: str) -> dict[str, np.ndarray]:
    """Each tensor's stored payload of a safetensors file as a read-only
    uint8 memory map, without reading the bytes. Raises ``ValueError`` on
    a header whose offsets do not fit the file or the tensor's shape."""
    header, base = safetensors_header(path)
    mm = np.memmap(path, mode="r", dtype=np.uint8)
    out = {}
    for key, meta in header.items():
        b, e = meta["data_offsets"]
        dt = _ST_TO_TORCH.get(meta["dtype"])
        size = None if dt is None else int(np.prod(meta["shape"])) * dt.itemsize
        if b < 0 or e < b or base + e > mm.size or (size is not None and e - b != size):
            raise ValueError(f"{path}: {key} has inconsistent data_offsets")
        out[key] = mm[base + b: base + e]
    return out


def verify_model_dir(model_dir: str) -> dict:
    """Audit a prepared per-layer checkpoint directory. Returns ``{"path",
    "ok", "layers_checked", "tensors_checked", "problems": [{"file",
    "status", "detail"}, ...]}``; statuses ``no_manifest`` |
    ``corrupt_manifest`` | ``missing_file`` | ``not_in_manifest`` |
    ``unreadable`` | ``tensor_diff`` | ``mismatch``."""
    problems: list[dict] = []
    layers_checked = tensors_checked = 0
    try:
        manifest = iman.load_manifest(model_dir)
    except ValueError as e:
        manifest = None
        problems.append(_problem(iman.MANIFEST_NAME, "corrupt_manifest", str(e)))
    else:
        if manifest is None:
            problems.append(_problem(
                iman.MANIFEST_NAME, "no_manifest",
                "dir has no integrity manifest; re-prepare (or re-save) to enable verification"))
    man_layers = dict((manifest or {}).get("layers", {}))
    disk_layers = {f[: -len(LAYER_FILE_SUFFIX)] for f in os.listdir(model_dir)
                   if f.endswith(LAYER_FILE_SUFFIX)}
    for layer in sorted(man_layers.keys() - disk_layers):
        problems.append(_problem(man_layers[layer].get("file", layer + LAYER_FILE_SUFFIX),
                                 "missing_file",
                                 f"layer {layer!r} is in the manifest but its file is gone"))
    if manifest is not None:
        for layer in sorted(disk_layers - man_layers.keys()):
            problems.append(_problem(
                layer + LAYER_FILE_SUFFIX, "not_in_manifest",
                f"layer file {layer!r} exists on disk but the manifest has no entry for it"))
    for layer in sorted(man_layers.keys() & disk_layers):
        fname = layer + LAYER_FILE_SUFFIX
        try:
            flat = stored_bytes(os.path.join(model_dir, fname))
        except Exception as e:  # truncated header, bad JSON, offsets past the end
            problems.append(_problem(fname, "unreadable", repr(e)))
            continue
        layers_checked += 1
        want = man_layers[layer].get("tensors", {})
        missing = sorted(want.keys() - flat.keys())
        extra = sorted(flat.keys() - want.keys())
        if missing or extra:
            problems.append(_problem(fname, "tensor_diff",
                                     f"manifest-only tensors {missing}, file-only tensors {extra}"))
        for key in sorted(want.keys() & flat.keys()):
            tensors_checked += 1
            arr, meta = flat[key], want[key]
            if int(arr.nbytes) != int(meta["n"]):
                problems.append(_problem(
                    fname, "mismatch",
                    f"tensor {key!r}: {arr.nbytes} bytes vs manifest {meta['n']} (truncated/resized)"))
                continue
            got = iman.tensor_checksum(arr)
            if got != meta["c"]:
                problems.append(_problem(fname, "mismatch",
                                         f"tensor {key!r}: checksum {got} != manifest {meta['c']}"))
    return {"path": model_dir, "ok": not problems, "layers_checked": layers_checked,
            "tensors_checked": tensors_checked, "problems": problems}


def verify_spill_dir(spill_dir: str) -> dict:
    """Audit an activation spill directory: every ``.npy`` against its
    sidecar. A spill without one is ``unverified`` (reported, not a
    failure); orphan sidecars and unreadable or mismatching spills fail."""
    problems: list[dict] = []
    checked = unverified = 0
    names = sorted(os.listdir(spill_dir))
    npys = [f for f in names if f.endswith(".npy")]
    for f in names:
        if f.endswith(".npy" + iman.SIDECAR_SUFFIX) and f[: -len(iman.SIDECAR_SUFFIX)] not in npys:
            problems.append(_problem(f, "orphan_sidecar", "spill file is gone"))
    for f in npys:
        path = os.path.join(spill_dir, f)
        side = iman.read_sidecar(path)
        if side is None:
            unverified += 1
            continue
        try:
            arr = np.load(path)
        except Exception as e:  # truncated / undecodable
            problems.append(_problem(f, "unreadable", repr(e)))
            continue
        checked += 1
        csum, nbytes = side
        if int(arr.nbytes) != nbytes:
            problems.append(_problem(f, "mismatch", f"{arr.nbytes} bytes vs sidecar {nbytes} (truncated)"))
            continue
        got = iman.tensor_checksum(arr)
        if got != csum:
            problems.append(_problem(f, "mismatch", f"checksum {got} != sidecar {csum}"))
    return {"path": spill_dir, "ok": not problems, "spills_checked": checked,
            "spills_unverified": unverified, "problems": problems}


def format_report(report: dict) -> str:
    """Human-readable per-file lines and one summary line."""
    lines = [f"{p['status'].upper():>15}  {p['file']}  {p['detail']}" for p in report["problems"]]
    counted = ", ".join(f"{v} {k.replace('_', ' ')}" for k, v in report.items()
                        if k.endswith(("_checked", "_unverified")) and v)
    verdict = "OK" if report["ok"] else f"{len(report['problems'])} problem(s)"
    lines.append(f"{report['path']}: {verdict}" + (f" ({counted})" if counted else ""))
    return "\n".join(lines)


__all__ = ["format_report", "stored_bytes", "verify_model_dir", "verify_spill_dir"]
