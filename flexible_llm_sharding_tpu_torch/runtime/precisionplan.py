"""Per-layer mixed precision (the JAX package's ``runtime/precisionplan.py``):
int4, int8 or bf16 chosen per layer from a measured sensitivity.

- :func:`probe_sensitivity` swaps one layer at a time to a
  quantize-dequantize simulation of each candidate dtype (the rounding
  ``requantize_native`` writes, ``checkpoint.simulate_quantized``) and
  scores the KL divergence of the next-token distribution against the bf16
  oracle on a calibration batch. No randomness and no clock: one batch
  gives one table. The forwards are the port's own scoring layers, in
  float32, on the card unless the caller asks for the CPU.
- :func:`plan_from_sensitivity` is the greedy planner: in budget mode it
  starts from bf16 and takes the downgrade with the least added divergence
  per byte saved until the bytes per pass fit; in cap mode it starts from
  int4 and takes the upgrade with the most divergence relieved per byte
  until the summed divergence fits. Ties break by layer index.
- :class:`PrecisionPlan` is the artifact, ``precision_plan.json``, which
  ``checkpoint.requantize_native(plan=...)`` embeds in the checkpoint it
  writes; the weight source and the ``verify`` audit check it against the
  integrity manifest.

The probe holds the whole float model in host memory and a float32 copy
on the device: it is an offline calibration tool.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from flexible_llm_sharding_tpu_torch.utils import checkpoint

PLAN_NAME = "precision_plan.json"

# The dtype ladder, cheapest first; "bf16" is the oracle's own storage.
PLAN_DTYPES = ("int4", "int8", "bf16")

# Plan dtype -> the stored dtype kinds the manifest may record for it: an
# int4 layer may carry int8 fallbacks (in dim off the group), and a layer
# with nothing to quantize (model.norm) stays float32 under a quantizer.
PLAN_KIND_ACCEPTS = {
    "bf16": ("bfloat16", "none"),
    "int8": ("int8", "float32", "none"),
    "int4": ("int4", "int8", "float32", "none"),
}


@dataclasses.dataclass(frozen=True)
class PrecisionPlan:
    """A layer -> dtype assignment and the evidence it was planned from.

    ``layers``: execution-ordered ``(layer_name, dtype)``, dtype in
    :data:`PLAN_DTYPES`. ``divergence_cap``: the plan's declared cap on the
    next-token KL against the bf16 oracle (the user's cap in cap mode, the
    calibration measurement with headroom in budget mode)."""

    layers: tuple[tuple[str, str], ...]
    divergence_cap: float
    bytes_budget: int | None = None
    est_bytes: int = 0
    baseline_bytes: int = 0
    est_divergence: float = 0.0
    measured_divergence: float | None = None
    calibration_prompts: int = 0

    def __post_init__(self) -> None:
        for name, dt in self.layers:
            if dt not in PLAN_DTYPES:
                raise ValueError(
                    f"PrecisionPlan: layer {name!r} has dtype {dt!r}; must be one of {PLAN_DTYPES}"
                )

    @functools.cached_property
    def dtypes(self) -> dict[str, str]:
        """layer -> dtype, built once (read-only)."""
        return dict(self.layers)

    def dtype_for(self, layer_name: str) -> str:
        try:
            return self.dtypes[layer_name]
        except KeyError:
            raise KeyError(
                f"PrecisionPlan has no entry for layer {layer_name!r} — the plan must cover "
                "every layer of the checkpoint it is applied to"
            ) from None

    @property
    def bytes_saved_frac(self) -> float:
        """Estimated fraction of the uniform-bf16 bytes per pass removed."""
        if not self.baseline_bytes:
            return 0.0
        return 1.0 - self.est_bytes / self.baseline_bytes

    def counts(self) -> dict[str, int]:
        out = {d: 0 for d in PLAN_DTYPES}
        for _, dt in self.layers:
            out[dt] += 1
        return out

    def to_json(self) -> dict:
        return {
            "version": 1,
            "layers": {name: dt for name, dt in self.layers},
            "layer_order": [name for name, _ in self.layers],
            "divergence_cap": self.divergence_cap,
            "bytes_budget": self.bytes_budget,
            "est_bytes": self.est_bytes,
            "baseline_bytes": self.baseline_bytes,
            "est_divergence": self.est_divergence,
            "measured_divergence": self.measured_divergence,
            "calibration_prompts": self.calibration_prompts,
        }

    @classmethod
    def from_json(cls, data: Mapping[str, Any]) -> "PrecisionPlan":
        layer_map = data["layers"]
        order = data.get("layer_order") or sorted(layer_map)
        return cls(
            layers=tuple((n, layer_map[n]) for n in order),
            divergence_cap=float(data["divergence_cap"]),
            bytes_budget=(int(data["bytes_budget"]) if data.get("bytes_budget") is not None
                          else None),
            est_bytes=int(data.get("est_bytes", 0)),
            baseline_bytes=int(data.get("baseline_bytes", 0)),
            est_divergence=float(data.get("est_divergence", 0.0)),
            measured_divergence=(float(data["measured_divergence"])
                                 if data.get("measured_divergence") is not None else None),
            calibration_prompts=int(data.get("calibration_prompts", 0)),
        )

    def write(self, path: str) -> str:
        """Write the plan's JSON to ``path`` atomically (the JAX package's
        bytes: sorted keys, indent 1)."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, sort_keys=True, indent=1)
        os.replace(tmp, path)
        return path

    def save(self, model_dir: str) -> str:
        """Embed the plan in a checkpoint directory."""
        return self.write(os.path.join(model_dir, PLAN_NAME))

    @classmethod
    def load(cls, model_dir: str) -> "PrecisionPlan | None":
        """The plan embedded in a checkpoint directory, or None for a
        uniform checkpoint. A corrupt plan raises ValueError; one that
        exists but cannot be read raises its OSError."""
        path = os.path.join(model_dir, PLAN_NAME)
        try:
            with open(path) as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        try:
            return cls.from_json(json.loads(raw))
        except (ValueError, KeyError, TypeError) as e:
            raise ValueError(
                f"{path}: corrupt precision plan ({e!r}); re-materialize the checkpoint or "
                "delete the plan file"
            ) from e


def plan_manifest_problems(plan: PrecisionPlan,
                           manifest: Mapping[str, Any] | None) -> list[tuple[str, str]]:
    """``[(layer, description)]`` of every disagreement between a plan and
    the manifest's recorded dtype kinds, shared by the weight source (which
    raises on the first) and the ``verify`` audit (which reports all). A
    manifest entry without a dtype is not a problem."""
    problems: list[tuple[str, str]] = []
    layers = (manifest or {}).get("layers", {})
    for name, plan_dtype in plan.layers:
        entry = layers.get(name)
        if entry is None:
            problems.append((
                name,
                f"precision plan covers layer {name!r} but the integrity manifest has no entry "
                "for it — plan and checkpoint drifted (re-materialize with "
                "requantize_native(plan=...))",
            ))
            continue
        kind = entry.get("dtype")
        if kind is not None and kind not in PLAN_KIND_ACCEPTS[plan_dtype]:
            problems.append((
                name,
                f"layer {name!r} is planned {plan_dtype!r} but the integrity manifest records "
                f"stored kind {kind!r}",
            ))
    return problems


# ---------------------------------------------------------------------------
# Bytes per plan dtype, from shapes alone
# ---------------------------------------------------------------------------

def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree] if hasattr(tree, "shape") else []


def _quantizable(a) -> bool:
    """``_quantize_flat``'s rule: floats of 2 dims or more quantize."""
    return len(a.shape) >= 2 and checkpoint.is_float_like(a)


def _itemsize(a) -> int:
    return a.element_size() if isinstance(a, torch.Tensor) else np.asarray(a).dtype.itemsize


def layer_dtype_bytes(tree) -> dict[str, int]:
    """Bytes one layer's float host tree streams per plan dtype: the packed
    sizes (payload and scales) ``_quantize_flat`` writes, from shapes."""
    out = {d: 0 for d in PLAN_DTYPES}
    for a in _leaves(tree):
        shape = tuple(a.shape)
        elems = int(np.prod(shape)) if shape else 1
        if not checkpoint.is_float_like(a):
            for d in PLAN_DTYPES:
                out[d] += elems * _itemsize(a)
            continue
        if not _quantizable(a):
            # 1-D floats: bf16 casts them; the quantizers keep them at
            # float32 or wider.
            itemsize = max(_itemsize(a), 4)
            out["bf16"] += elems * 2
            out["int8"] += elems * itemsize
            out["int4"] += elems * itemsize
            continue
        *lead, n_in, n_out = shape
        lead_n = int(np.prod(lead)) if lead else 1
        out["bf16"] += elems * 2
        out["int8"] += elems + lead_n * n_out * 4
        if n_in % checkpoint.INT4_GROUP == 0:
            out["int4"] += elems // 2 + lead_n * (n_in // checkpoint.INT4_GROUP) * n_out * 4
        else:
            out["int4"] += elems + lead_n * n_out * 4
    return out


# ---------------------------------------------------------------------------
# Sensitivity probe
# ---------------------------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _load_float_params(model_path: str, layer_names) -> dict[str, Any]:
    """The host parameters of a float native checkpoint, at their stored
    values (what every dtype is simulated from, as the converter
    quantizes them)."""
    params: dict[str, Any] = {"layers": []}
    for name in layer_names:
        tree = checkpoint.load_layer(model_path, name)
        if _has_quantized(tree):
            raise ValueError(
                f"{model_path}/{name}: already quantized — probe and plan from the original "
                "float checkpoint (requantize_native's rule)"
            )
        holder, key = _slot(params, name)
        if key is None:
            holder.append(tree)
        else:
            holder[key] = tree
    return params


def _has_quantized(tree) -> bool:
    if checkpoint.is_quantized_leaf(tree):
        return True
    return isinstance(tree, dict) and any(_has_quantized(v) for v in tree.values())


def _slot(params, name: str):
    """(container, key) of a layer name in the parameter dict; key None
    appends a decoder layer while loading."""
    if name == "model.embed_tokens":
        return params, "embed"
    if name == "model.norm":
        return params, "norm"
    if name == "lm_head":
        return params, "lm_head"
    idx = int(name.split(".")[2])
    return params["layers"], (idx if idx < len(params["layers"]) else None)


def simulate_layer(tree, dtype: str):
    """One layer's stored-value tree at ``dtype``, float32 out: what the
    weight source computes after ``requantize_native`` wrote the dtype and
    the upload dequantized or cast it. Quantizable kernels take the
    quantize-dequantize round trip (or the bf16 cast round trip); 1-D
    floats stay exact under the quantizers and round under bf16."""
    def one(a):
        if not checkpoint.is_float_like(a):
            return a
        if dtype == "bf16":
            return a.to(torch.bfloat16).float()
        if not _quantizable(a):
            return a.float()
        return checkpoint.simulate_quantized(a, dtype)

    return _tree_map(one, tree)


def _calibration_rows(prompts, tokenizer) -> list[np.ndarray]:
    """Every (prompt, suffix) pair's real prefix + suffix token row."""
    from flexible_llm_sharding_tpu_torch.runtime.tokenization import PromptTokenizer

    tok = PromptTokenizer(tokenizer, bucket_multiple=8)
    rows = []
    for prefix, suffixes in prompts:
        t = tok(prefix, suffixes)
        for s in range(t.num_suffixes):
            n_real = int(t.suffix_eos[s]) + 1
            rows.append(np.concatenate([t.prefix_ids[: t.prefix_len], t.suffix_ids[s, :n_real]]))
    return rows


_PROBE_PAD = 64


def _next_token_probs(params_dev, model_cfg, rows, device) -> np.ndarray:
    """[n_rows, V] float32 next-token distributions after each row's last
    token, through the port's scoring layers in float32: the row's first
    n - 1 tokens are the prefix (padded to a multiple of 64), its last
    token a one-token suffix. Rows of equal length share one forward."""
    from flexible_llm_sharding_tpu_torch.models import llama
    from flexible_llm_sharding_tpu_torch.runtime.tokenization import longrope_total_len

    sliding = llama.layer_sliding_pattern(model_cfg)
    rope_on = llama.layer_rope_pattern(model_cfg)
    head = llama.head_params(params_dev)
    by_len: dict[int, list[int]] = {}
    for i, row in enumerate(rows):
        by_len.setdefault(len(row), []).append(i)
    out: list[np.ndarray | None] = [None] * len(rows)
    for n, idxs in by_len.items():
        ids = torch.from_numpy(np.stack([rows[i] for i in idxs]).astype(np.int64))
        b = len(idxs)
        lp = -(-(n - 1) // _PROBE_PAD) * _PROBE_PAD
        prefix_ids = torch.zeros(b, lp, dtype=torch.int64)
        prefix_ids[:, : n - 1] = ids[:, : n - 1]
        suffix_ids = ids[:, None, n - 1:]
        prefix_len = torch.full((b,), n - 1, dtype=torch.int32, device=device)
        suffix_eos = torch.zeros(b, 1, dtype=torch.int32, device=device)
        total_len = longrope_total_len(model_cfg, prefix_len, suffix_eos)
        ph = llama.embed(params_dev["embed"], prefix_ids.to(device), torch.float32, model_cfg)
        sh = llama.embed(params_dev["embed"], suffix_ids.to(device), torch.float32, model_cfg)
        for li, layer in enumerate(params_dev["layers"]):
            ph, sh = llama.prefix_suffix_layer([layer], model_cfg, ph, sh, prefix_len,
                                               sliding=sliding[li], total_len=total_len,
                                               rope_on=rope_on[li], use_pallas=True)
        h = llama.select_eos_and_norm(params_dev["norm"], model_cfg, sh, suffix_eos)
        probs = llama.lm_head_scores([head], h, model_cfg.final_logit_softcap)[:, 0]
        probs = probs.cpu().numpy()
        for j, i in enumerate(idxs):
            out[i] = probs[j]
    return np.stack(out)


def kl_divergence(p: np.ndarray, q: np.ndarray) -> float:
    """Mean KL(p || q) over rows, floored at 1e-12 and renormalised: the
    one divergence of the probe and the planner."""
    p = np.clip(np.asarray(p, np.float64), 1e-12, None)
    q = np.clip(np.asarray(q, np.float64), 1e-12, None)
    p = p / p.sum(axis=-1, keepdims=True)
    q = q / q.sum(axis=-1, keepdims=True)
    return float(np.mean(np.sum(p * (np.log(p) - np.log(q)), axis=-1)))


@dataclasses.dataclass
class _ProbeContext:
    """One calibration session: the model loaded once (``params``, stored
    values on the host), its bf16-oracle network on the device once
    (``params_dev``, every layer at ``simulate_layer(raw, "bf16")``), and
    the oracle's distributions, shared by the probe, the byte estimates
    and the validation."""

    model_cfg: Any
    layer_names: list[str]
    params: dict
    params_dev: dict
    rows: list
    oracle: np.ndarray
    device: torch.device

    def host_tree(self, name: str):
        holder, key = _slot(self.params, name)
        return holder[key]

    def swapped_dev(self, sims: Mapping[str, Any]) -> dict:
        """``params_dev`` with the layers in ``sims`` replaced (on the
        device); every other layer is the same tensor."""
        out = dict(self.params_dev)
        out["layers"] = list(self.params_dev["layers"])
        for name, sim in sims.items():
            holder, key = _slot(out, name)
            holder[key] = _tree_map(lambda t: t.to(self.device), sim)
        return out


def _probe_context(model_path: str, prompts, tokenizer, device) -> _ProbeContext:
    from flexible_llm_sharding_tpu_torch.config import LlamaConfig, resolve_device

    device = resolve_device(device) if not isinstance(device, torch.device) else device
    model_cfg = LlamaConfig.from_pretrained(model_path)
    layer_names = checkpoint.layer_names_for(model_cfg.num_hidden_layers,
                                             model_cfg.tie_word_embeddings)
    params = _load_float_params(model_path, layer_names)
    oracle_host = {
        "embed": simulate_layer(params["embed"], "bf16"),
        "layers": [simulate_layer(t, "bf16") for t in params["layers"]],
        "norm": simulate_layer(params["norm"], "bf16"),
    }
    if "lm_head" in params:
        oracle_host["lm_head"] = simulate_layer(params["lm_head"], "bf16")
    params_dev = {k: ([_tree_map(lambda t: t.to(device), x) for x in v] if k == "layers"
                      else _tree_map(lambda t: t.to(device), v))
                  for k, v in oracle_host.items()}
    rows = _calibration_rows(prompts, tokenizer)
    with torch.inference_mode():
        oracle = _next_token_probs(params_dev, model_cfg, rows, device)
    return _ProbeContext(model_cfg=model_cfg, layer_names=list(layer_names), params=params,
                         params_dev=params_dev, rows=rows, oracle=oracle, device=device)


def _probe_table(ctx: _ProbeContext, candidates: Sequence[str]) -> dict[str, dict[str, float]]:
    table: dict[str, dict[str, float]] = {}
    for name in ctx.layer_names:
        original = ctx.host_tree(name)
        if not any(_quantizable(a) for a in _leaves(original)):
            # Nothing to quantize (model.norm): below the probe's resolution.
            table[name] = {d: 0.0 for d in candidates}
            continue
        per: dict[str, float] = {}
        for dtype in candidates:
            sim = simulate_layer(original, dtype)
            with torch.inference_mode():
                probs = _next_token_probs(ctx.swapped_dev({name: sim}), ctx.model_cfg, ctx.rows,
                                          ctx.device)
            per[dtype] = kl_divergence(ctx.oracle, probs)
        table[name] = per
    return table


def probe_sensitivity(model_path: str, prompts: Sequence, tokenizer,
                      candidates: Sequence[str] = ("int8", "int4"),
                      device="cuda") -> dict[str, dict[str, float]]:
    """``{layer_name: {dtype: kl}}``: each layer alone at each candidate
    dtype against the bf16 oracle on the calibration batch (bf16 is 0.0)."""
    return _probe_table(_probe_context(model_path, prompts, tokenizer, device), candidates)


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------

def plan_from_sensitivity(layer_names: Sequence[str], layer_bytes: Mapping[str, Mapping[str, int]],
                          sensitivity: Mapping[str, Mapping[str, float]], *,
                          bytes_budget: int | None = None,
                          divergence_cap: float | None = None) -> PrecisionPlan:
    """Greedy dtype assignment under exactly one of ``bytes_budget`` (start
    at bf16, downgrade by least divergence added per byte saved until the
    bytes fit, or every layer is at int4) and ``divergence_cap`` (start at
    int4, upgrade by most divergence relieved per byte added until the sum
    fits). Every lower (higher) dtype is a candidate move, not only the next
    rung; ties break by layer index; a last pass takes bf16 wherever it
    costs no more bytes than the choice."""
    if (bytes_budget is None) == (divergence_cap is None):
        raise ValueError("give exactly one of bytes_budget / divergence_cap")

    def kl(name: str, dtype: str) -> float:
        return 0.0 if dtype == "bf16" else float(sensitivity[name][dtype])

    def cost(name: str, dtype: str) -> int:
        return int(layer_bytes[name][dtype])

    names = list(layer_names)
    baseline = sum(cost(n, "bf16") for n in names)
    lower = {"bf16": ("int8", "int4"), "int8": ("int4",), "int4": ()}
    higher = {"int4": ("int8", "bf16"), "int8": ("bf16",), "bf16": ()}
    if bytes_budget is not None:
        chosen = {n: "bf16" for n in names}
        total = baseline

        def downgrades():
            for i, n in enumerate(names):
                cur = chosen[n]
                for nxt in lower[cur]:
                    saved = cost(n, cur) - cost(n, nxt)
                    if saved <= 0:
                        continue
                    added = kl(n, nxt) - kl(n, cur)
                    yield (added / saved, -saved, i, n, nxt, saved)

        while total > bytes_budget:
            steps = sorted(downgrades())
            if not steps:
                break
            _, _, _, n, nxt, saved = steps[0]
            chosen[n] = nxt
            total -= saved
    else:
        chosen = {n: "int4" for n in names}

        def upgrades():
            for i, n in enumerate(names):
                cur = chosen[n]
                for nxt in higher[cur]:
                    relief = kl(n, cur) - kl(n, nxt)
                    added_bytes = max(cost(n, nxt) - cost(n, cur), 1)
                    if relief <= 0:
                        continue
                    yield (-(relief / added_bytes), i, n, nxt)

        while sum(kl(n, chosen[n]) for n in names) > divergence_cap:
            steps = sorted(upgrades())
            if not steps:
                break
            _, _, n, nxt = steps[0]
            chosen[n] = nxt

    for n in names:
        if cost(n, "bf16") <= cost(n, chosen[n]):
            chosen[n] = "bf16"
    total = sum(cost(n, chosen[n]) for n in names)
    est_div = sum(kl(n, chosen[n]) for n in names)
    return PrecisionPlan(
        layers=tuple((n, chosen[n]) for n in names),
        divergence_cap=(divergence_cap if divergence_cap is not None else est_div * 1.5 + 1e-6),
        bytes_budget=bytes_budget,
        est_bytes=int(total),
        baseline_bytes=int(baseline),
        est_divergence=float(est_div),
    )


def build_plan(model_path: str, prompts: Sequence, tokenizer, *, bytes_budget: int | None = None,
               divergence_cap: float | None = None, validate: bool = True,
               device="cuda") -> PrecisionPlan:
    """Probe, plan and validate in one calibration session. ``validate``
    runs the batch with every layer at its chosen dtype at once and records
    the measured divergence: in budget mode the declared cap becomes the
    larger of the measurement and the estimate, times 1.5, plus 1e-6; a
    measurement over an explicit cap raises."""
    ctx = _probe_context(model_path, prompts, tokenizer, device)
    sens = _probe_table(ctx, ("int8", "int4"))
    sizes = {n: layer_dtype_bytes(ctx.host_tree(n)) for n in ctx.layer_names}
    plan = plan_from_sensitivity(ctx.layer_names, sizes, sens, bytes_budget=bytes_budget,
                                 divergence_cap=divergence_cap)
    if not validate:
        return dataclasses.replace(plan, calibration_prompts=len(prompts))
    sims = {name: simulate_layer(ctx.host_tree(name), dt) for name, dt in plan.layers}
    with torch.inference_mode():
        measured = kl_divergence(
            ctx.oracle, _next_token_probs(ctx.swapped_dev(sims), ctx.model_cfg, ctx.rows,
                                          ctx.device))
    if divergence_cap is not None and measured > divergence_cap:
        raise ValueError(
            f"planned checkpoint measures {measured:.6f} end-to-end divergence on the "
            f"calibration batch, over the requested cap {divergence_cap:.6f} — loosen the cap "
            "or grow the calibration batch"
        )
    cap = (divergence_cap if divergence_cap is not None
           else max(measured * 1.5, plan.est_divergence * 1.5) + 1e-6)
    return dataclasses.replace(plan, measured_divergence=measured, divergence_cap=cap,
                               calibration_prompts=len(prompts))


__all__ = [
    "PLAN_DTYPES",
    "PLAN_KIND_ACCEPTS",
    "PLAN_NAME",
    "PrecisionPlan",
    "build_plan",
    "kl_divergence",
    "layer_dtype_bytes",
    "plan_from_sensitivity",
    "plan_manifest_problems",
    "probe_sensitivity",
    "simulate_layer",
]
