"""Training on one device: the loss, AdamW with global-norm clipping, the
learning-rate schedules, the single-device train step and its checkpoints.

The port of the JAX package's ``training.py`` without its mesh. JAX's step
differentiates ``models/llama.decoder_layer`` (the plain attention op under
a mask), and so does this one: none of the CUDA attention kernels has a
backward, and their wrappers refuse a gradient on the card.

- :func:`make_train_step`: one eager step, optionally accumulating
  ``accum_steps`` microbatches per update (gradients averaged).
- :func:`make_optimizer` / :func:`make_lr_schedule`: global-norm clip, then
  AdamW, on a warmup + cosine/linear schedule. The port cannot use optax
  (it imports JAX), so :class:`AdamW` and :func:`clip_by_global_norm_` are
  its own, equal to optax 0.2.6's ``adamw`` and ``clip_by_global_norm``
  step for step.
- :func:`save_train_state` / :func:`restore_train_state`: NOT orbax (JAX's
  format, which the port can neither read nor write) but the layout of
  ``training_stream.StreamedTrainer.save_state``, shared with the JAX
  package's ``StreamedTrainer``: a native per-layer params checkpoint, one
  ``opt-<segment>.npz`` per segment and ``train_state.json``.

Usage:
    opt = make_optimizer(peak_lr=3e-4, warmup_steps=100, total_steps=10_000)
    state = TrainState.create(cfg, params, opt)       # on the card
    step = make_train_step(cfg, opt)
    state, loss = step(state, batch)   # batch: int [B, L+1] token ids
    save_train_state(state, "ckpt/step_1000", cfg)

The mesh arguments exist only to refuse: tensor and data parallel training
wait for ROADMAP queue 1 item 8 (training's mesh parts), which builds on the
tensor-parallel specs of ``parallel/sharding.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Callable

import numpy as np
import torch

from flexible_llm_sharding_tpu_torch.config import LlamaConfig, resolve_device
from flexible_llm_sharding_tpu_torch.models import llama
from flexible_llm_sharding_tpu_torch.ops.attention import causal_mask
from flexible_llm_sharding_tpu_torch.ops.norm import rms_norm
from flexible_llm_sharding_tpu_torch.utils import checkpoint

Params = dict[str, Any]

_NO_MESH = (
    "training over a mesh (tensor or data parallel) is not ported: ROADMAP queue 1 "
    "item 8 (training's mesh parts); pass mesh=None"
)


class CheckpointFormatError(ValueError):
    """A train-state directory the port cannot read (an orbax checkpoint of
    the JAX package's ``save_train_state``)."""


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree):
    """``fn`` over every tensor of a nested dict/list tree, structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves in JAX's tree-flatten order: dict keys sorted at every
    level, lists in order. Checkpoints of optimizer state list their leaves
    in this order, so the JAX package reads them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves: list):
    """``tree``'s structure with ``leaves`` (in :func:`tree_leaves` order)."""
    return _fill(tree, iter(leaves))


def _fill(node, it):
    # A module-level function, not a closure: a recursive closure is a
    # reference cycle that would keep ``it``, and through it every leaf (a
    # layer's device params and gradients), alive until the cyclic garbage
    # collector ran, raising the device peak with depth.
    if isinstance(node, dict):
        filled = {k: _fill(node[k], it) for k in sorted(node)}
        return {k: filled[k] for k in node}
    if isinstance(node, (list, tuple)):
        return [_fill(v, it) for v in node]
    return next(it)


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------

def token_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                        pad_id: int | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy of float32 logits [..., L, V] against
    int targets [..., L]. With ``pad_id``, positions whose target is pad
    are left out of the mean (right-padded ragged batches). Shared by the
    monolithic loss and the streamed trainer's tail."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    if pad_id is None:
        return -ll.mean()
    keep = (targets != pad_id).float()
    return -(ll * keep).sum() / torch.clamp(keep.sum(), min=1.0)


def _softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    return x if cap is None else torch.tanh(x / cap) * cap


def head_logits(norm_p: Params, head_p: Params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    """The tail: final norm, the head in x's dtype, float32 logits with the
    final softcap."""
    h = rms_norm(x, norm_p["scale"], cfg.rms_norm_eps, cfg.norm_unit_offset)
    return _softcap(llama._mm(h, head_p["kernel"]).float(), cfg.final_logit_softcap)


def layer_mask(cfg: LlamaConfig, length: int, sliding: bool, device) -> torch.Tensor:
    """The causal mask [L, L] of one layer: banded by the window or chunk on
    a local layer, full on a global one."""
    return causal_mask(length, length, window=cfg.sliding_window if sliding else None,
                       chunk=cfg.attention_chunk_size if sliding else None, device=device)


def forward_logits(params: Params, cfg: LlamaConfig, ids: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The JAX package's ``forward_full`` on the training path: embed, then
    :func:`models.llama.decoder_layer` per layer under its banded or full
    mask and rope flag (longrope's length is L, as a Hugging Face batch
    forward takes it), the tail. ids [B, L] -> float32 logits [B, L, V].
    Differentiable; no kernel runs."""
    length = ids.shape[1]
    dev = ids.device
    total_len = length if cfg.rope_scaling_kind == "longrope" else None
    x = llama.embed(params["embed"], ids, dtype, cfg)
    positions = torch.arange(length, device=dev)[None]
    sliding, rope_on = llama.layer_sliding_pattern(cfg), llama.layer_rope_pattern(cfg)
    masks = {}
    for i, layer in enumerate(params["layers"]):
        if sliding[i] not in masks:
            masks[sliding[i]] = layer_mask(cfg, length, sliding[i], dev)
        x = llama.decoder_layer(layer, cfg, x, positions, masks[sliding[i]], sliding=sliding[i],
                                rope_on=rope_on[i], total_len=total_len)
    return head_logits(params["norm"], llama.head_params(params), cfg, x)


def next_token_loss(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16, pad_id: int | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy. tokens: int [B, L+1] (inputs :-1,
    targets 1:)."""
    return token_cross_entropy(forward_logits(params, cfg, tokens[:, :-1], dtype),
                               tokens[:, 1:], pad_id)


# ---------------------------------------------------------------------------
# Learning-rate schedules (optax's, in float32)
# ---------------------------------------------------------------------------

_F32 = np.float32


def _linear(init: float, end: float, steps: int) -> Callable[[int], np.float32]:
    """optax.linear_schedule: init -> end over ``steps``, then end."""
    if steps <= 0:
        return lambda count: _F32(init)

    def schedule(count: int) -> np.float32:
        c = _F32(min(max(count, 0), steps))
        frac = _F32(1) - c / _F32(steps)
        return _F32(init - end) * frac + _F32(end)

    return schedule


def _cosine(init: float, steps: int, alpha: float) -> Callable[[int], np.float32]:
    """optax.cosine_decay_schedule(init, steps, alpha)."""
    if not steps > 0:
        raise ValueError(f"the cosine decay needs positive decay steps, got {steps}")

    def schedule(count: int) -> np.float32:
        c = np.minimum(_F32(count), _F32(steps))
        decay = _F32(0.5) * (_F32(1) + np.cos(_F32(np.pi) * c / _F32(steps)))
        return _F32(init) * (_F32(1 - alpha) * decay + _F32(alpha))

    return schedule


def make_lr_schedule(peak_lr: float, warmup_steps: int = 0, total_steps: int | None = None,
                     kind: str = "cosine", end_scale: float = 0.1):
    """Linear warmup to ``peak_lr``, then cosine or linear decay to ``peak_lr
    * end_scale`` over ``total_steps`` (constant after the warmup if
    ``total_steps`` is None). Returns ``peak_lr`` itself when there is
    neither, else a function of the step count (optax's
    ``join_schedules([linear_schedule, decay], [warmup_steps])``)."""
    if warmup_steps == 0 and total_steps is None:
        return peak_lr
    warm = _linear(0.0, peak_lr, max(warmup_steps, 1))
    if total_steps is None:
        decay = lambda count: _F32(peak_lr)  # noqa: E731
    else:
        decay_steps = max(total_steps - warmup_steps, 1)
        if kind == "cosine":
            decay = _cosine(peak_lr, decay_steps, end_scale)
        elif kind == "linear":
            decay = _linear(peak_lr, peak_lr * end_scale, decay_steps)
        else:
            raise ValueError(f"unknown schedule kind {kind!r}")

    def schedule(count: int) -> np.float32:
        return warm(count) if count < warmup_steps else decay(count - warmup_steps)

    return schedule


# ---------------------------------------------------------------------------
# AdamW and the global-norm clip (optax 0.2.6's, leaf by leaf)
# ---------------------------------------------------------------------------

def round_to(value, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: a scalar that JAX
    converts to the array's dtype before the operation (a weakly typed
    constant, or an explicit cast) multiplies the same way in torch."""
    return torch.tensor(float(value), dtype=dtype).item()


@dataclasses.dataclass
class AdamWState:
    """optax's ``adamw`` state: ``ScaleByAdamState(count, mu, nu)``, then,
    for a scheduled learning rate, ``ScaleByScheduleState(count)``
    (``lr_count``; None for a constant rate)."""

    count: int
    mu: Params
    nu: Params
    lr_count: int | None = None

    def leaves(self) -> list:
        """JAX's tree-flatten order: count, the mu leaves, the nu leaves,
        then the schedule's count."""
        out = [self.count, *tree_leaves(self.mu), *tree_leaves(self.nu)]
        return out if self.lr_count is None else [*out, self.lr_count]


def _adamw_leaf(p, g, mu, nu, b1, b2, eps, wd, bc1: float, bc2: float, step: float):
    """One leaf's update, in optax's order of operations: the two moments,
    bias corrections by ``count + 1``, mu_hat / (sqrt(nu_hat) + eps), plus
    wd * p, times the step (-lr), added to p. Returns (p, mu, nu), new
    tensors."""
    # Each product and sum rounded on its own, as optax's; the in-place
    # forms only spare temporaries.
    mu_new = g * round_to(1 - b1, g.dtype)
    mu_new += mu * round_to(b1, mu.dtype)
    nu_new = g * g
    nu_new *= round_to(1 - b2, g.dtype)
    nu_new += nu * round_to(b2, nu.dtype)
    denom = (nu_new / round_to(bc2, nu_new.dtype)).sqrt_()
    denom += round_to(eps, denom.dtype)
    u = mu_new / round_to(bc1, mu_new.dtype)
    u /= denom
    del denom
    u += p * round_to(wd, p.dtype)
    u *= round_to(step, u.dtype)
    return (p + u).to(p.dtype), mu_new, nu_new


def _update_(params, grads, mu, nu, *args) -> None:
    """Every leaf of the trees through :func:`_adamw_leaf`, each result
    replacing its entry as it is made: one leaf's old tensors are released
    before the next leaf's are computed."""
    if isinstance(params, dict):
        keys = params.keys()
    else:
        keys = range(len(params))
    for k in keys:
        if isinstance(params[k], (dict, list)):
            _update_(params[k], grads[k], mu[k], nu[k], *args)
        else:
            params[k], mu[k], nu[k] = _adamw_leaf(params[k], grads[k], mu[k], nu[k], *args)


class AdamW:
    """optax 0.2.6's ``adamw(learning_rate, b1, b2, eps, weight_decay)``
    (eps_root 0, no mask: the decay applies to every leaf), with its
    defaults. ``lr`` is a float or a schedule over the step count, read at
    the count from before the step."""

    def __init__(self, lr=1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4):
        self.lr, self.b1, self.b2, self.eps, self.weight_decay = lr, b1, b2, eps, weight_decay

    def init(self, params: Params) -> AdamWState:
        return AdamWState(0, tree_map(torch.zeros_like, params), tree_map(torch.zeros_like, params),
                          0 if callable(self.lr) else None)

    def update_(self, params: Params, grads: Params, state: AdamWState) -> None:
        """One step: ``params`` and ``state`` (trees and counts) updated in
        place, their entries replaced leaf by leaf."""
        count = state.count + 1
        bc1 = float(_F32(1) - _F32(self.b1) ** _F32(count))
        bc2 = float(_F32(1) - _F32(self.b2) ** _F32(count))
        if state.lr_count is None:
            step = -self.lr
        else:
            step = float(-self.lr(state.lr_count))
            state.lr_count += 1
        _update_(params, grads, state.mu, state.nu, self.b1, self.b2, self.eps,
                 self.weight_decay, bc1, bc2, step)
        state.count = count


def global_norm(grads) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum over leaves (in tree order) of
    each leaf's sum of squares, in the leaves' dtype."""
    total = 0
    for g in tree_leaves(grads):
        total = total + (g * g).sum()
    return torch.sqrt(total)


def clip_by_global_norm_(grads: Params, max_norm: float) -> None:
    """optax.clip_by_global_norm, in place: the grads unchanged where their
    global norm is below ``max_norm``, else each leaf (t / norm) * max_norm."""
    norm = global_norm(grads)
    if bool(norm < max_norm):
        return
    for t in tree_leaves(grads):
        t.div_(norm.to(t.dtype)).mul_(round_to(max_norm, t.dtype))


class Optimizer:
    """make_optimizer's chain: the global-norm clip, then AdamW. Its state
    is AdamW's (the clip keeps none)."""

    def __init__(self, adamw: AdamW, grad_clip: float | None):
        self.adamw, self.grad_clip = adamw, grad_clip

    def init(self, params: Params) -> AdamWState:
        return self.adamw.init(params)

    def update_(self, params: Params, grads: Params, state: AdamWState) -> None:
        """One step in place, as :meth:`AdamW.update_`; ``grads`` are
        clipped in place."""
        if self.grad_clip is not None:
            clip_by_global_norm_(grads, self.grad_clip)
        self.adamw.update_(params, grads, state)


def make_optimizer(peak_lr: float = 3e-4, weight_decay: float = 0.1, warmup_steps: int = 0,
                   total_steps: int | None = None, grad_clip: float = 1.0, b1: float = 0.9,
                   b2: float = 0.95, schedule_kind: str = "cosine") -> Optimizer:
    """The standard LLM recipe: global-norm clip, then AdamW on a warmup +
    decay schedule."""
    lr = make_lr_schedule(peak_lr, warmup_steps, total_steps, schedule_kind)
    return Optimizer(AdamW(lr, b1=b1, b2=b2, weight_decay=weight_decay), grad_clip)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """Parameters, optimizer state and step count, on one device."""

    params: Params
    opt_state: AdamWState
    step: int

    @classmethod
    def create(cls, cfg: LlamaConfig, params: Params, optimizer, mesh=None,
               device="cuda") -> "TrainState":
        """``params`` copied into trees of the state's own on ``device``
        (the card unless the caller names the CPU) and a fresh optimizer
        state. ``mesh`` must be None (ROADMAP item 8)."""
        if mesh is not None:
            raise NotImplementedError(_NO_MESH)
        dev = resolve_device(str(device))
        params = tree_map(lambda t: t.to(dev), params)
        return cls(params=params, opt_state=optimizer.init(params), step=0)


def live_leaves(tree) -> list:
    """The tree's leaves as tensors autograd tracks, sharing its storage."""
    return [t.detach().requires_grad_() for t in tree_leaves(tree)]


def grads_of(out: torch.Tensor, live: list, dout: torch.Tensor | None = None) -> list:
    """d out / d live (times ``dout``), with zeros for a leaf the output
    does not reach (a routing correction bias, which only selects), as
    JAX's vjp gives."""
    got = torch.autograd.grad(out, live, dout, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(live, got)]


def value_and_grad(params: Params, cfg: LlamaConfig, tokens: torch.Tensor, dtype, pad_id):
    """(loss, grads) of :func:`next_token_loss`."""
    live = live_leaves(params)
    with torch.enable_grad():
        loss = next_token_loss(tree_unflatten(params, live), cfg, tokens, dtype, pad_id)
        grads = grads_of(loss, live)
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(cfg: LlamaConfig, optimizer, mesh=None, dp: str | None = None,
                    dtype: torch.dtype = torch.bfloat16, pad_id: int | None = None,
                    accum_steps: int = 1) -> Callable[[TrainState, Any], tuple[TrainState, torch.Tensor]]:
    """The train step, an eager function of (state, tokens) -> (state, loss).

    The state is donated, as JAX's jitted step donates it: its trees are
    updated in place and the returned state is the same object, one step on.
    ``accum_steps > 1``: tokens arrive as [accum_steps, B, L+1] and the update
    applies the microbatch-averaged gradient. ``mesh`` and ``dp`` (a data
    parallel axis) must be None (ROADMAP item 8)."""
    if mesh is not None or dp is not None:
        raise NotImplementedError(_NO_MESH)

    def step_fn(state: TrainState, tokens):
        dev = tree_leaves(state.params)[0].device
        tokens = torch.as_tensor(np.asarray(tokens) if not torch.is_tensor(tokens) else tokens)
        tokens = tokens.to(dev)
        if accum_steps > 1:
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = tree_map(torch.zeros_like, state.params)
            for mb in tokens:
                l, g = value_and_grad(state.params, cfg, mb, dtype, pad_id)
                loss = loss + l
                grads = _tree_zip(torch.add, grads, g)
                del g
            loss = loss / accum_steps
            grads = tree_map(lambda g: g / accum_steps, grads)
        else:
            loss, grads = value_and_grad(state.params, cfg, tokens, dtype, pad_id)
        optimizer.update_(state.params, grads, state.opt_state)
        state.step += 1
        return state, loss

    return step_fn


def _tree_zip(fn, a, b):
    if isinstance(a, dict):
        return {k: _tree_zip(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return [_tree_zip(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


# ---------------------------------------------------------------------------
# Train-state checkpoints (StreamedTrainer's layout, shared with JAX's)
# ---------------------------------------------------------------------------

def segment_names(n_layers: int, tied: bool) -> list[str]:
    """The optimizer-state segments of a model: one ``opt-<name>.npz`` each."""
    head = [] if tied else ["lm_head"]
    return ["embed", "norm", *head, *(f"layer{i}" for i in range(n_layers))]


def segment_of(tree: Params, name: str):
    """The subtree of a whole-model tree that segment ``name`` holds."""
    if name.startswith("layer"):
        return tree["layers"][int(name[len("layer"):])]
    return tree[name]


def _to_numpy(x) -> np.ndarray:
    """A leaf as numpy: counts as int32, bfloat16 as its uint16 bits (np.savez
    cannot store it; JAX's reader views them back by the template)."""
    if not torch.is_tensor(x):
        return np.asarray(x, np.int32)
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _from_numpy(a: np.ndarray, like) -> Any:
    """A stored leaf back to the template leaf's type and dtype."""
    if not torch.is_tensor(like):
        return int(a)
    if like.dtype == torch.bfloat16 and a.dtype.kind in "uV" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return checkpoint.tensor_from_numpy(a).to(like.dtype)


def write_state_dir(out_dir: str, params: Params, cfg: LlamaConfig,
                    states: dict[str, AdamWState], step: int) -> None:
    """Write a train state: the native per-layer params checkpoint, one
    ``opt-<segment>.npz`` per segment holding ``l0..ln`` in JAX's
    tree-flatten order of ``optax.adamw(...).init(segment)``, and
    ``train_state.json`` ({"step": n}). Atomic: written into a ``.tmp``
    sibling and swapped into place only when whole (the old directory
    parked at ``.old`` between the two renames), so a crash mid-save never
    pairs new params with stale moments."""
    tmp = out_dir.rstrip("/\\") + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    checkpoint.save_params(tree_map(lambda t: t.detach().cpu(), params), tmp, cfg)
    for name, state in states.items():
        np.savez(os.path.join(tmp, f"opt-{name}.npz"),
                 **{f"l{i}": _to_numpy(x) for i, x in enumerate(state.leaves())})
    with open(os.path.join(tmp, "train_state.json"), "w") as f:
        json.dump({"step": int(step)}, f)
    if os.path.isdir(out_dir):
        old = out_dir.rstrip("/\\") + ".old"
        shutil.rmtree(old, ignore_errors=True)
        os.rename(out_dir, old)
        os.rename(tmp, out_dir)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.rename(tmp, out_dir)


def open_state_dir(ckpt_dir: str) -> None:
    """Make ``ckpt_dir`` readable: recover a checkpoint that a crash between
    :func:`write_state_dir`'s two renames left at ``.old``; refuse an orbax
    directory with :class:`CheckpointFormatError`."""
    if not os.path.isdir(ckpt_dir):
        old = ckpt_dir.rstrip("/\\") + ".old"
        if os.path.isdir(old):
            os.rename(old, ckpt_dir)
    orbax = {"_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt"}
    if os.path.isdir(ckpt_dir) and orbax & set(os.listdir(ckpt_dir)):
        raise CheckpointFormatError(
            f"{ckpt_dir} is an orbax checkpoint (the JAX package's save_train_state); the port "
            "reads only its own train-state layout (native params, opt-<segment>.npz, "
            "train_state.json), which the JAX package's StreamedTrainer.save_state also writes"
        )
    if not os.path.isfile(os.path.join(ckpt_dir, "train_state.json")):
        raise CheckpointFormatError(f"{ckpt_dir} holds no train_state.json: not a train state")


def read_segment_state(ckpt_dir: str, name: str, template: AdamWState) -> AdamWState:
    """Segment ``name``'s optimizer state, read against ``template`` (the
    same recipe's fresh state: its structure, dtypes and whether the rate
    is scheduled)."""
    data = np.load(os.path.join(ckpt_dir, f"opt-{name}.npz"))
    leaves = template.leaves()
    if len(data.files) != len(leaves):
        raise ValueError(f"opt-{name}.npz has {len(data.files)} leaves, the trainer expects "
                         f"{len(leaves)}: a different optimizer recipe?")
    got = [_from_numpy(data[f"l{i}"], t) for i, t in enumerate(leaves)]
    n = len(tree_leaves(template.mu))
    return AdamWState(got[0], tree_unflatten(template.mu, got[1:1 + n]),
                      tree_unflatten(template.nu, got[1 + n:1 + 2 * n]),
                      got[-1] if template.lr_count is not None else None)


def read_step(ckpt_dir: str) -> int:
    with open(os.path.join(ckpt_dir, "train_state.json")) as f:
        return int(json.load(f)["step"])


def load_params(model_path: str, n_layers: int, tied: bool) -> Params:
    """A native per-layer checkpoint as a host params tree, int8 and int4
    leaves dequantized to float32."""
    def load(name: str) -> Params:
        return checkpoint.dequantize_tree(checkpoint.load_layer(model_path, name))

    params: Params = {
        "embed": load("model.embed_tokens"),
        "layers": [load(f"model.layers.{i}") for i in range(n_layers)],
        "norm": load("model.norm"),
    }
    if not tied:
        params["lm_head"] = load("lm_head")
    return params


def save_train_state(state: TrainState, path: str, cfg: LlamaConfig) -> None:
    """Checkpoint the full train state (params, AdamW moments, step) in the
    streamed trainer's layout (:func:`write_state_dir`), not orbax: a
    ``StreamedTrainer`` of either package resumes from it. ``cfg`` goes into
    the params checkpoint's ``config.json``."""
    tied = not state.params.get("lm_head")
    opt = state.opt_state
    states = {name: AdamWState(opt.count, segment_of(opt.mu, name), segment_of(opt.nu, name),
                               opt.lr_count)
              for name in segment_names(len(state.params["layers"]), tied)}
    write_state_dir(path, state.params, cfg, states, state.step)


def restore_train_state(path: str, cfg: LlamaConfig, optimizer, mesh=None,
                        dtype: torch.dtype = torch.float32, device="cuda") -> TrainState:
    """Restore a :func:`save_train_state` (or ``StreamedTrainer.save_state``)
    directory onto ``device``, params and moments cast to ``dtype``. The
    optimizer must be the same recipe. An orbax directory raises
    :class:`CheckpointFormatError`; ``mesh`` must be None (ROADMAP item 8)."""
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)
    open_state_dir(path)
    tied = cfg.tie_word_embeddings
    params = tree_map(lambda t: t.to(dtype),
                      load_params(path, cfg.num_hidden_layers, tied))
    template = optimizer.init(params)
    mu, nu = template.mu, template.nu
    counts, lr_counts = set(), set()
    for name in segment_names(cfg.num_hidden_layers, tied):
        seg = read_segment_state(path, name, AdamWState(
            0, segment_of(mu, name), segment_of(nu, name), template.lr_count))
        counts.add(seg.count)
        lr_counts.add(seg.lr_count)
        put_segment(mu, name, seg.mu)
        put_segment(nu, name, seg.nu)
    if len(counts) != 1 or len(lr_counts) != 1:
        raise ValueError(f"{path}: the segments' step counts differ ({sorted(counts)})")
    state = AdamWState(counts.pop(), mu, nu, lr_counts.pop())
    dev = resolve_device(str(device))
    state.mu, state.nu = tree_map(lambda t: t.to(dev), state.mu), tree_map(lambda t: t.to(dev), state.nu)
    return TrainState(tree_map(lambda t: t.to(dev), params), state, read_step(path))


def put_segment(tree: Params, name: str, sub) -> None:
    """Set segment ``name``'s subtree of a whole-model tree."""
    if name.startswith("layer"):
        tree["layers"][int(name[len("layer"):])] = sub
    else:
        tree[name] = sub


__all__ = [
    "AdamW",
    "AdamWState",
    "CheckpointFormatError",
    "Optimizer",
    "TrainState",
    "clip_by_global_norm_",
    "forward_logits",
    "global_norm",
    "make_lr_schedule",
    "make_optimizer",
    "make_train_step",
    "next_token_loss",
    "restore_train_state",
    "save_train_state",
    "token_cross_entropy",
]
