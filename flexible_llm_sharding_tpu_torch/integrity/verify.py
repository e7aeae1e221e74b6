"""Offline integrity audit, the ``verify`` subcommand's engine (the JAX
package's ``integrity/verify.py``).

Recomputes every checksum of a prepared model directory against its
``integrity.json``, of a spill directory against the ``.npy`` sidecars, and
of every adapter of a LoRA registry root against its adapter's manifest and
plan (``verify_adapter_dir``). Unlike the load path, the audit is strict: a layer in the
manifest but not on disk, a layer file the manifest lacks, and tensor-set
differences are all problems. A directory with an embedded precision plan
is audited against it both ways: the plan against the manifest's recorded
dtype kinds, each file's stored kind against its planned dtype, and the
plan's coverage of the layer files (``corrupt_plan``,
``precision_mismatch``, ``plan_missing_file``, ``not_in_plan``).
"""

from __future__ import annotations

import os

import numpy as np

from flexible_llm_sharding_tpu_torch.integrity import manifest as iman
from flexible_llm_sharding_tpu_torch.runtime.precisionplan import (
    PLAN_KIND_ACCEPTS,
    PLAN_NAME,
    PrecisionPlan,
    plan_manifest_problems,
)
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


def file_dtype_kind(path: str) -> str:
    """A layer file's storage-dtype kind from its header alone (the rule of
    ``manifest.flat_dtype_kind``: 'int4'/'int8' by scale twins, else the
    dtype of the largest float tensor, the first in key order on a tie,
    else 'none')."""
    header, _ = safetensors_header(path)
    if any(k.endswith(iman.QUANT4_SCALE_SUFFIX) for k in header):
        return "int4"
    if any(k.endswith(iman.QUANT_SCALE_SUFFIX) for k in header):
        return "int8"
    best = None
    for k in sorted(header):
        dt = _ST_TO_TORCH.get(header[k]["dtype"])
        if dt is None or not dt.is_floating_point:
            continue
        n = int(np.prod(header[k]["shape"], dtype=np.int64)) * dt.itemsize
        if best is None or n > best[0]:
            best = (n, dt)
    return str(best[1]).removeprefix("torch.") if best is not None else "none"


def _load_plan(model_dir: str):
    """(PrecisionPlan or None, problems): a corrupt or unreadable plan is
    reported, not raised, so the audit walks the rest of the directory."""
    try:
        return PrecisionPlan.load(model_dir), []
    except ValueError as e:
        return None, [_problem(PLAN_NAME, "corrupt_plan", str(e))]
    except OSError as e:
        return None, [_problem(PLAN_NAME, "corrupt_plan", f"unreadable: {e}")]


def _check_plan_layer(plan: PrecisionPlan, layer: str, fname: str, path: str,
                      problems: list) -> int:
    """One layer file's stored kind against its planned dtype; 1 when the
    plan covers the layer (the coverage pass reports the rest)."""
    plan_dtype = plan.dtypes.get(layer)
    if plan_dtype is None:
        return 0
    accepted = PLAN_KIND_ACCEPTS.get(plan_dtype, ())
    got = file_dtype_kind(path)
    if got not in accepted:
        problems.append(_problem(
            fname, "precision_mismatch",
            f"layer {layer!r} stores dtype kind {got!r}; the embedded plan declares "
            f"{plan_dtype!r} (accepts {list(accepted)})"))
    return 1


def verify_model_dir(model_dir: str) -> dict:
    """Audit a prepared per-layer checkpoint directory. Returns ``{"path",
    "ok", "layers_checked", "tensors_checked", "problems": [{"file",
    "status", "detail"}, ...]}``, plus ``plan_layers_checked`` and
    ``plan_divergence_cap`` when it embeds a precision plan; statuses
    ``no_manifest`` | ``corrupt_manifest`` | ``missing_file`` |
    ``not_in_manifest`` | ``corrupt_plan`` | ``precision_mismatch`` |
    ``unreadable`` | ``tensor_diff`` | ``mismatch`` | ``plan_missing_file``
    | ``not_in_plan``."""
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
    plan, plan_problems = _load_plan(model_dir)
    problems.extend(plan_problems)
    if plan is not None:
        for layer, detail in plan_manifest_problems(plan, manifest):
            problems.append(_problem(layer + LAYER_FILE_SUFFIX, "precision_mismatch", detail))
    plan_layers_checked = 0
    for layer in sorted(man_layers.keys() & disk_layers):
        fname = layer + LAYER_FILE_SUFFIX
        path = os.path.join(model_dir, fname)
        try:
            flat = stored_bytes(path)
        except Exception as e:  # truncated header, bad JSON, offsets past the end
            problems.append(_problem(fname, "unreadable", repr(e)))
            continue
        layers_checked += 1
        if plan is not None:
            plan_layers_checked += _check_plan_layer(plan, layer, fname, path, problems)
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
    if plan is not None:
        for layer in sorted(set(plan.dtypes) - disk_layers):
            problems.append(_problem(layer + LAYER_FILE_SUFFIX, "plan_missing_file",
                                     f"precision plan covers layer {layer!r} but its file is gone"))
        for layer in sorted(disk_layers - set(plan.dtypes)):
            problems.append(_problem(
                layer + LAYER_FILE_SUFFIX, "not_in_plan",
                f"layer file {layer!r} exists on disk but the embedded precision plan has no "
                "entry for it"))
    report = {"path": model_dir, "ok": not problems, "layers_checked": layers_checked,
              "tensors_checked": tensors_checked, "problems": problems}
    if plan is not None:
        report["plan_layers_checked"] = plan_layers_checked
        report["plan_divergence_cap"] = plan.divergence_cap
    return report


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


def verify_adapter_dir(root: str) -> dict:
    """Audit a LoRA adapter registry root (``--adapter_dir``): every
    adapter's delta files against its manifest and its plan, strictly.
    Returns ``{"path", "ok", "adapters_checked", "layers_checked",
    "tensors_checked", "problems"}``; statuses ``corrupt_plan`` |
    ``plan_missing_file`` | ``not_in_plan`` | ``adapter_mismatch`` (a
    checksum, size or shape that differs from the manifest or the plan) and
    the manifest's ``no_manifest`` | ``corrupt_manifest`` | ``missing_file``
    | ``not_in_manifest`` | ``unreadable`` | ``tensor_diff``."""
    from flexible_llm_sharding_tpu_torch.adapters.registry import ADAPTER_PLAN_NAME, AdapterPlan

    problems: list[dict] = []
    adapters_checked = layers_checked = tensors_checked = 0
    try:
        entries = sorted(os.listdir(root))
    except OSError as e:
        return {"path": root, "ok": False, "adapters_checked": 0, "layers_checked": 0,
                "tensors_checked": 0, "problems": [_problem(root, "unreadable", repr(e))]}
    for name in entries:
        adir = os.path.join(root, name)
        if not os.path.isdir(adir):
            continue
        disk_layers = {f[: -len(LAYER_FILE_SUFFIX)] for f in os.listdir(adir)
                       if f.endswith(LAYER_FILE_SUFFIX)}
        try:
            plan = AdapterPlan.load(adir)
        except (ValueError, OSError) as e:
            problems.append(_problem(f"{name}/{ADAPTER_PLAN_NAME}", "corrupt_plan", str(e)))
            plan = None
        else:
            if plan is None:
                if not disk_layers:
                    continue  # not an adapter
                problems.append(_problem(
                    f"{name}/{ADAPTER_PLAN_NAME}", "corrupt_plan",
                    f"dir holds {len(disk_layers)} delta file(s) but no adapter plan; re-run "
                    "prepare-adapter"))
        if plan is None and not disk_layers:
            continue
        adapters_checked += 1
        plan_ranks = dict(plan.layers) if plan is not None else {}
        for layer in sorted(plan_ranks.keys() - disk_layers):
            problems.append(_problem(f"{name}/{layer}{LAYER_FILE_SUFFIX}", "plan_missing_file",
                                     f"adapter plan covers layer {layer!r} but its delta file is "
                                     "gone"))
        if plan is not None:
            for layer in sorted(disk_layers - plan_ranks.keys()):
                problems.append(_problem(
                    f"{name}/{layer}{LAYER_FILE_SUFFIX}", "not_in_plan",
                    f"delta file {layer!r} exists on disk but the adapter plan has no entry for "
                    "it"))
        try:
            manifest = iman.load_manifest(adir)
        except ValueError as e:
            manifest = None
            problems.append(_problem(f"{name}/{iman.MANIFEST_NAME}", "corrupt_manifest", str(e)))
        else:
            if manifest is None:
                problems.append(_problem(
                    f"{name}/{iman.MANIFEST_NAME}", "no_manifest",
                    "adapter dir has no integrity manifest; re-run prepare-adapter to enable "
                    "verification"))
        man_layers = dict((manifest or {}).get("layers", {}))
        for layer in sorted(man_layers.keys() - disk_layers):
            problems.append(_problem(f"{name}/{layer}{LAYER_FILE_SUFFIX}", "missing_file",
                                     f"layer {layer!r} is in the manifest but its file is gone"))
        if manifest is not None:
            for layer in sorted(disk_layers - man_layers.keys()):
                problems.append(_problem(
                    f"{name}/{layer}{LAYER_FILE_SUFFIX}", "not_in_manifest",
                    f"delta file {layer!r} exists on disk but the manifest has no entry for it"))
        for layer in sorted(disk_layers):
            ref = f"{name}/{layer}{LAYER_FILE_SUFFIX}"
            path = os.path.join(adir, layer + LAYER_FILE_SUFFIX)
            try:
                header, _ = safetensors_header(path)
                flat = stored_bytes(path)
            except Exception as e:  # truncated header, bad JSON, offsets past the end
                problems.append(_problem(ref, "unreadable", repr(e)))
                continue
            layers_checked += 1
            if plan is not None and layer in plan_ranks:
                # The plan's shapes: the offline face of the loader's check.
                want_a = (plan.hidden_size, plan_ranks[layer])
                for key, want in (("lora_A", want_a), ("lora_B", want_a[::-1])):
                    got = tuple(header[key]["shape"]) if key in header else None
                    if got is not None and got != want:
                        problems.append(_problem(ref, "adapter_mismatch",
                                                 f"{key} shape {got} vs plan {want}"))
            want = man_layers.get(layer, {}).get("tensors")
            if want is None:
                continue
            missing = sorted(want.keys() - flat.keys())
            extra = sorted(flat.keys() - want.keys())
            if missing or extra:
                problems.append(_problem(ref, "tensor_diff",
                                         f"manifest-only tensors {missing}, file-only tensors "
                                         f"{extra}"))
            for key in sorted(want.keys() & flat.keys()):
                tensors_checked += 1
                arr, meta = flat[key], want[key]
                if int(arr.nbytes) != int(meta["n"]):
                    problems.append(_problem(
                        ref, "adapter_mismatch",
                        f"tensor {key!r}: {arr.nbytes} bytes vs manifest {meta['n']} "
                        "(truncated/resized)"))
                    continue
                got = iman.tensor_checksum(arr)
                if got != meta["c"]:
                    problems.append(_problem(ref, "adapter_mismatch",
                                             f"tensor {key!r}: checksum {got} != manifest "
                                             f"{meta['c']}"))
    return {"path": root, "ok": not problems, "adapters_checked": adapters_checked,
            "layers_checked": layers_checked, "tensors_checked": tensors_checked,
            "problems": problems}


def format_report(report: dict) -> str:
    """Human-readable per-file lines and one summary line."""
    lines = [f"{p['status'].upper():>15}  {p['file']}  {p['detail']}" for p in report["problems"]]
    counted = ", ".join(f"{v} {k.replace('_', ' ')}" for k, v in report.items()
                        if k.endswith(("_checked", "_unverified")) and v)
    verdict = "OK" if report["ok"] else f"{len(report['problems'])} problem(s)"
    lines.append(f"{report['path']}: {verdict}" + (f" ({counted})" if counted else ""))
    return "\n".join(lines)


__all__ = ["file_dtype_kind", "format_report", "stored_bytes", "verify_adapter_dir",
           "verify_model_dir", "verify_spill_dir"]
