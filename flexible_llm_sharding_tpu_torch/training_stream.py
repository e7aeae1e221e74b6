"""Layer-streamed training: weights, gradients and AdamW moments stay on the
host, and one layer at a time goes through the device.

The port of the JAX package's ``training_stream.py``. ``training.py``'s step
holds the whole model on the device; this trainer applies the framework's
streaming idea to training, so a model larger than the card's memory can
train:

- **Forward stream**, layers 0..L-1: each layer's input activation is
  cached on the host (rematerialisation at layer granularity).
- **Backward stream**, layers L-1..0: each layer runs again under autograd
  from its cached input and gives its parameter gradients and the input
  gradient that chains to the layer below.
- **Update stream**: AdamW one segment at a time; the segment's params,
  gradient and moments make one round trip host -> device -> host. The
  global-norm clip runs on the host in float64, where every gradient is.

Peak device memory is one segment's update (params, gradient, two moments)
or one layer's recompute, whatever the depth: every device copy of a
segment is released before the next one uploads. One :meth:`StreamedTrainer.step`
equals one ``training.make_train_step`` update (the same loss and updated
params), which ``tests/test_torch_training_stream.py`` holds, together with
the JAX package's trainer.
"""

from __future__ import annotations

import math
import time
from typing import Any

import numpy as np
import torch

from flexible_llm_sharding_tpu_torch.config import LlamaConfig, resolve_device
from flexible_llm_sharding_tpu_torch.models import llama
from flexible_llm_sharding_tpu_torch.training import (
    AdamW,
    AdamWState,
    grads_of,
    head_logits,
    layer_mask,
    live_leaves,
    load_params,
    open_state_dir,
    put_segment,
    read_segment_state,
    read_step,
    round_to,
    segment_names,
    segment_of,
    token_cross_entropy,
    tree_leaves,
    tree_map,
    tree_unflatten,
    write_state_dir,
)
from flexible_llm_sharding_tpu_torch.utils import checkpoint

Params = dict[str, Any]


def _fwd_layer(cfg: LlamaConfig, params: Params, x: torch.Tensor, sliding: bool,
               rope_on: bool) -> torch.Tensor:
    """One decoder layer over x [B, L, D] under its causal mask (banded on a
    local layer); longrope takes L as the length, as the monolithic forward
    does."""
    length = x.shape[1]
    total_len = length if cfg.rope_scaling_kind == "longrope" else None
    return llama.decoder_layer(params, cfg, x, torch.arange(length, device=x.device)[None],
                               layer_mask(cfg, length, sliding, x.device), sliding=sliding,
                               rope_on=rope_on, total_len=total_len)


def _bwd_layer(cfg: LlamaConfig, params: Params, x: torch.Tensor, sliding: bool, rope_on: bool,
               dy: torch.Tensor) -> tuple[Params, torch.Tensor]:
    """Layer ``params`` recomputed under autograd from its cached input x:
    (parameter gradients, input gradient)."""
    live, xr = live_leaves(params), x.detach().requires_grad_()
    with torch.enable_grad():
        out = _fwd_layer(cfg, tree_unflatten(params, live), xr, sliding, rope_on)
        *dp, dx = grads_of(out, [*live, xr], dy)
    return tree_unflatten(params, dp), dx


def _embed_bwd(cfg: LlamaConfig, params: Params, ids: torch.Tensor, dx: torch.Tensor) -> Params:
    live = live_leaves(params)
    with torch.enable_grad():
        out = llama.embed(tree_unflatten(params, live), ids, dx.dtype, cfg)
        return tree_unflatten(params, grads_of(out, live, dx))


def _tail_loss_vjp(cfg: LlamaConfig, norm_p: Params, head_p: Params, x: torch.Tensor,
                   targets: torch.Tensor, pad_id: int | None):
    """norm -> head -> final softcap -> next-token cross-entropy (with pad
    masking), differentiated: (loss, d_norm, d_head, d_x)."""
    live_n, live_h, xr = live_leaves(norm_p), live_leaves(head_p), x.detach().requires_grad_()
    with torch.enable_grad():
        logits = head_logits(tree_unflatten(norm_p, live_n), tree_unflatten(head_p, live_h),
                             cfg, xr)
        loss = token_cross_entropy(logits, targets, pad_id)
        g = grads_of(loss, [*live_n, *live_h, xr])
    n = len(live_n)
    return (loss.detach(), tree_unflatten(norm_p, g[:n]),
            tree_unflatten(head_p, g[n:-1]), g[-1])


def _square_sum64(g: torch.Tensor, chunk: int = 1 << 22) -> float:
    """The float64 sum of squares of a host tensor, a chunk at a time (a
    float64 copy of a 131 M-element embedding gradient would be 1 GB)."""
    return sum(float(torch.sum(torch.square(c.double()))) for c in g.reshape(-1).split(chunk))


class StreamedTrainer:
    """Train a model whose weights never all fit on the device.

    ``params`` is a host tree of tensors (``models.llama.init_params``
    layout, layers a list). The trainer keeps its own host copy of them, of
    the AdamW moments and of the gradients, page-locked when ``device`` is
    the card (the card unless the caller names the CPU), and updates those
    copies in place; the tensors passed in are never written. Each
    :meth:`step` runs the forward, backward and update streams through
    ``device``.

    ``grad_clip`` and the AdamW hyperparameters mirror
    ``training.make_optimizer`` (global-norm clip, then AdamW); ``lr`` may be
    a schedule (``training.make_lr_schedule``).

    Tied embeddings (``cfg.tie_word_embeddings``, no ``lm_head`` entry): the
    head kernel is ``embedding.T``, so the tail receives the transpose and
    the head kernel's gradient is transposed into the embedding's, both on
    the host when they meet; the embedding then updates once (one AdamW
    segment), as ``training.make_train_step`` does on a tied tree.

    ``stats`` holds the last step's forward, backward and update seconds,
    the bytes it moved host to device and back, and (with a clip) the
    gradients' global norm, which is finite only if every gradient is.
    """

    def __init__(self, cfg: LlamaConfig, params: Params, lr=1e-4, grad_clip: float | None = 1.0,
                 b1: float = 0.9, b2: float = 0.95, weight_decay: float = 0.1,
                 dtype: torch.dtype = torch.float32, pad_id: int | None = None, device="cuda"):
        # The tie rule must be the one llama.head_params applies in the
        # forward (absent or empty lm_head: embedding.T), or the gradient
        # routing below would diverge from the head actually used.
        self._tied = not params.get("lm_head")
        if cfg.tie_word_embeddings and not self._tied:
            raise ValueError(
                "cfg.tie_word_embeddings=True but params carry a nonempty lm_head: drop the "
                "lm_head entry (tied) or clear the flag (untied)"
            )
        self.cfg = cfg
        self.device = resolve_device(str(device))
        # Page-locked host copies: every step moves the whole model and its
        # moments both ways, which pageable memory would make several times
        # slower (each copy staged, each new buffer's pages faulted in).
        self._pin = self.device.type == "cuda"
        self.params = tree_map(self._own, params)
        self.dtype = dtype
        self.pad_id = pad_id
        self.grad_clip = grad_clip
        self.step_count = 0
        self.stats: dict[str, float] = {}
        self._adamw = AdamW(lr, b1=b1, b2=b2, weight_decay=weight_decay)
        # Per-segment moments on the host: one segment's are on the device
        # only during its own update. A tied model has no lm_head segment.
        self.opt_state = {
            "embed": self._init_state(self.params["embed"]),
            "layers": [self._init_state(lp) for lp in self.params["layers"]],
            "norm": self._init_state(self.params["norm"]),
        }
        if not self._tied:
            self.opt_state["lm_head"] = self._init_state(self.params["lm_head"])
        self._grads = tree_map(self._zeros, self.params)

    # -- host buffers ------------------------------------------------------
    def _zeros(self, t: torch.Tensor) -> torch.Tensor:
        return torch.zeros(t.shape, dtype=t.dtype, pin_memory=self._pin)

    def _own(self, t: torch.Tensor) -> torch.Tensor:
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=self._pin).copy_(t)

    def _init_state(self, params: Params) -> AdamWState:
        """``AdamW.init`` in the trainer's own host buffers."""
        return AdamWState(0, tree_map(self._zeros, params), tree_map(self._zeros, params),
                          0 if callable(self._adamw.lr) else None)

    # -- host <-> device, counted ------------------------------------------
    def _up(self, tree):
        self.stats["h2d_bytes"] += sum(t.numel() * t.element_size() for t in tree_leaves(tree))
        return tree_map(lambda t: t.to(self.device), tree)

    def _down(self, t: torch.Tensor) -> torch.Tensor:
        self.stats["d2h_bytes"] += t.numel() * t.element_size()
        return t.to("cpu")

    def _down_into(self, host, dev, add: bool = False) -> None:
        """Device tree -> the host buffers ``host`` (same structure), copied
        over them, or with ``add`` added to them (a microbatch's gradient)."""
        for h, d in zip(tree_leaves(host), tree_leaves(dev)):
            self.stats["d2h_bytes"] += d.numel() * d.element_size()
            if add:
                h.add_(d.to("cpu"))
            else:
                h.copy_(d)

    def _sync(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    # -- the three streams, one segment per call (its device copies die on return)
    def _forward_layer(self, i: int, x: torch.Tensor, sliding, rope_on) -> torch.Tensor:
        with torch.no_grad():
            return _fwd_layer(self.cfg, self._up(self.params["layers"][i]), x, sliding, rope_on)

    def _backward_layer(self, i: int, x_host: torch.Tensor, dx: torch.Tensor, sliding, rope_on,
                        add: bool) -> torch.Tensor:
        dp, dx = _bwd_layer(self.cfg, self._up(self.params["layers"][i]),
                            x_host.to(self.device), sliding, rope_on, dx)
        self.stats["h2d_bytes"] += x_host.numel() * x_host.element_size()
        self._down_into(self._grads["layers"][i], dp, add)
        return dx

    def _tail(self, x: torch.Tensor, targets: torch.Tensor, add: bool):
        if self._tied:
            head = {"kernel": self._up(self.params["embed"])["embedding"].T}
        else:
            head = self._up(self.params["lm_head"])
        loss, d_norm, d_head, dx = _tail_loss_vjp(self.cfg, self._up(self.params["norm"]), head, x,
                                                  targets, self.pad_id)
        self._down_into(self._grads["norm"], d_norm, add)
        if self._tied:
            # Through kernel = embedding.T: the kernel's gradient [D, V]
            # transposes into the embedding's [V, D].
            self._down_into(self._grads["embed"], {"embedding": d_head["kernel"].T}, add)
        else:
            self._down_into(self._grads["lm_head"], d_head, add)
        return float(loss), dx

    def _update_segment(self, p_host: Params, g_host: Params, s: AdamWState) -> None:
        p = self._up(p_host)
        dev_state = AdamWState(s.count, self._up(s.mu), self._up(s.nu), s.lr_count)
        self._adamw.update_(p, self._up(g_host), dev_state)
        self._down_into(p_host, p)
        self._down_into(s.mu, dev_state.mu)
        self._down_into(s.nu, dev_state.nu)
        s.count, s.lr_count = dev_state.count, dev_state.lr_count

    # -- one optimizer step over [accum, B, L+1] or [B, L+1] tokens ---------
    def step(self, tokens) -> float:
        """One update: forward, backward and update streams over the tokens
        (int [B, L+1], or [accum, B, L+1] microbatches whose gradients are
        averaged). Returns the mean loss."""
        cfg, dev = self.cfg, self.device
        tokens = torch.as_tensor(np.asarray(tokens) if not torch.is_tensor(tokens) else tokens)
        micro = tokens[None] if tokens.ndim == 2 else tokens
        n_micro = micro.shape[0]
        pattern = llama.layer_sliding_pattern(cfg)
        rope_pat = llama.layer_rope_pattern(cfg)
        n_layers = cfg.num_hidden_layers
        self.stats = {"h2d_bytes": 0, "d2h_bytes": 0, "forward_s": 0.0, "backward_s": 0.0}

        loss_sum = 0.0
        for m, mb in enumerate(micro):
            add = m > 0  # later microbatches add their gradients to the first's
            t0 = self._sync()
            ids, targets = mb[:, :-1].to(dev), mb[:, 1:].to(dev)
            # Forward stream: each layer's input cached on the host.
            with torch.no_grad():
                x = llama.embed(self._up(self.params["embed"]), ids, self.dtype, cfg)
            acts: list[torch.Tensor] = []
            for i in range(n_layers):
                acts.append(self._down(x))
                x = self._forward_layer(i, x, pattern[i], rope_pat[i])
            t1 = self._sync()
            loss, dx = self._tail(x, targets, add)
            del x
            loss_sum += loss
            # Backward stream: layers in reverse, recomputed from the cached
            # inputs; dx chains downward.
            for i in reversed(range(n_layers)):
                dx = self._backward_layer(i, acts[i], dx, pattern[i], rope_pat[i], add)
                acts[i] = None
            self._down_into(self._grads["embed"],
                            _embed_bwd(cfg, self._up(self.params["embed"]), ids, dx),
                            add=add or self._tied)
            del dx
            t2 = self._sync()
            self.stats["forward_s"] += t1 - t0
            self.stats["backward_s"] += t2 - t1

        t2 = time.perf_counter()
        grads = self._grads
        if n_micro > 1:
            for g in tree_leaves(grads):
                g.div_(n_micro)
        # The global-norm clip on the host in float64 (the JAX trainer's
        # form, not optax's float32 one): the one step that needs every
        # gradient at once, and all of them are on the host here.
        if self.grad_clip is not None:
            gnorm = math.sqrt(sum(_square_sum64(g) for g in tree_leaves(grads)))
            self.stats["grad_norm"] = gnorm
            scale = self.grad_clip / max(gnorm, self.grad_clip)
            if scale < 1.0:
                for g in tree_leaves(grads):
                    g.mul_(round_to(scale, g.dtype))

        # Update stream: one segment at a time through the device.
        for key in (("embed", "norm") if self._tied else ("embed", "norm", "lm_head")):
            self._update_segment(self.params[key], grads[key], self.opt_state[key])
        for i in range(n_layers):
            self._update_segment(self.params["layers"][i], grads["layers"][i],
                                 self.opt_state["layers"][i])
        self.stats["update_s"] = self._sync() - t2
        self.step_count += 1
        return loss_sum / n_micro

    @classmethod
    def from_pretrained(cls, model_path: str, dtype: torch.dtype = torch.float32, **kw):
        """Build from a native per-layer checkpoint directory (the splitter's
        output), loaded a layer at a time on the host. int8 and int4
        checkpoints are dequantized to float32 at load: the optimizer needs
        real-valued params, and the quantization error becomes the
        fine-tune's starting point."""
        cfg = LlamaConfig.from_pretrained(model_path)
        return cls(cfg, load_params(model_path, cfg.num_hidden_layers, cfg.tie_word_embeddings),
                   dtype=dtype, **kw)

    def save(self, out_dir: str) -> None:
        """Write the current params as a native per-layer checkpoint."""
        checkpoint.save_params(self.params, out_dir, self.cfg)

    # -- the full train state (params, moments, step) ------------------------
    def save_state(self, out_dir: str) -> None:
        """Durable train state: the native per-layer params checkpoint, one
        ``opt-<segment>.npz`` per segment with its AdamW state (``l0..ln``
        in JAX's tree-flatten order, bf16 leaves as their uint16 bits) and
        ``train_state.json`` with the step count: the JAX package's
        ``StreamedTrainer.save_state`` layout, so either package resumes
        the other's. Atomic through a ``.tmp`` sibling (``training.
        write_state_dir``)."""
        names = segment_names(self.cfg.num_hidden_layers, self._tied)
        write_state_dir(out_dir, self.params, self.cfg,
                        {n: segment_of(self.opt_state, n) for n in names}, self.step_count)

    def restore_state(self, ckpt_dir: str) -> None:
        """Resume from :meth:`save_state` (of either package): params, every
        segment's moments and the step count. A checkpoint left at ``.old``
        by a crash between the save's two renames is recovered. The trainer
        must have the same optimizer recipe (the same state structure)."""
        open_state_dir(ckpt_dir)
        self.params = tree_map(self._own,
                               load_params(ckpt_dir, self.cfg.num_hidden_layers, self._tied))
        for name in segment_names(self.cfg.num_hidden_layers, self._tied):
            state = read_segment_state(ckpt_dir, name, segment_of(self.opt_state, name))
            state.mu, state.nu = tree_map(self._own, state.mu), tree_map(self._own, state.nu)
            put_segment(self.opt_state, name, state)
        self.step_count = read_step(ckpt_dir)


__all__ = ["StreamedTrainer"]
