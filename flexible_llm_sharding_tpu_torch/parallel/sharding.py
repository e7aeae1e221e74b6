"""Device meshes and the tensor-parallel layout (the JAX package's
``parallel/sharding.py``, in one process over a device list).

A JAX ``Mesh`` is a grid of chips that XLA programs run on as one SPMD
program; here a mesh is a list of devices that the port loops over rank by
rank: the long-context path's ``sp`` axis (``ops/ring_attention.py``,
``runtime/longcontext.py``) and tensor parallelism's ``tp`` axis
(:class:`TpPlacement`). A list may name one device several times
(``[cuda:0] * 4``): its ranks then share that device's memory, and a hop
between them moves nothing.

A tensor sharded over the mesh is a list of blocks, one per rank, block
``r`` on ``mesh.devices[r]`` (:func:`shard`, :func:`gather`); a tree
replicated over the mesh is one copy per distinct device, listed per rank
(:func:`replicate`).

Tensor parallelism (Megatron layout): :func:`layer_specs` and
:func:`param_specs` give every parameter a spec, a tuple of axis names per
dimension as JAX's ``PartitionSpec`` holds them. Linear kernels are stored
``[in, out]``, so ``(None, "tp")`` is a column shard (split on out),
``("tp", None)`` a row shard (split on in) and ``(None,)`` replicated.
:func:`shard_params` turns a host tree and its specs into one tree per rank
(rank r's slices on ``mesh.devices[r]``, ranks on one device sharing each
replicated leaf), and :class:`TpPlacement` is the executor's placement
target. Where GSPMD inserts the all-reduce after a row-parallel product,
the port's layers (``models/llama.py``) sum the ranks' partial outputs on
the first device. DP×TP is a list of placements, one per group of tp
devices (``runtime/orchestration.py``), not a two-axis grid.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from flexible_llm_sharding_tpu_torch.config import LlamaConfig, indexed_device, resolve_device

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """One named axis over ``devices`` (rank r on ``devices[r]``)."""

    axis: str
    devices: tuple[torch.device, ...]

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> list[torch.device]:
        """The mesh's devices, each named once, in rank order."""
        return list(dict.fromkeys(self.devices))

    def slot(self, rank: int) -> int:
        """Index of rank ``rank``'s device in :attr:`distinct`."""
        return self.distinct.index(self.devices[rank])


def make_mesh(shape: dict[str, int] | None = None,
              devices: Sequence | None = None) -> DeviceMesh:
    """A mesh of ``shape`` (axis name -> size) over ``devices``.

    ``devices`` defaults to every visible card (a run without one raises,
    as every entry point of the port does unless the CPU is asked for);
    ``shape`` None is a ``dp`` axis over all of them, and a size of -1
    takes them all. The mesh takes the first ``size`` devices; fewer raise
    "needs N devices, have M". One axis only: the ``sp`` and ``tp`` paths
    each run over one, and DP×TP is a list of ``tp`` meshes."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [indexed_device(d) for d in devices]
    if shape is None:
        shape = {"dp": len(devices)}
    if len(shape) != 1:
        raise ValueError(f"mesh shape {shape}: only one axis is supported")
    ((axis, size),) = shape.items()
    if size == -1:
        size = len(devices)
    if size < 1:
        raise ValueError(f"mesh shape {shape}: the axis size must be >= 1")
    if size > len(devices):
        raise ValueError(f"mesh shape {{{axis!r}: {size}}} needs {size} devices, "
                         f"have {len(devices)}")
    return DeviceMesh(axis, tuple(devices[:size]))


def shard(x: torch.Tensor, mesh: DeviceMesh) -> list[torch.Tensor]:
    """``x`` split along its first dimension into ``mesh.size`` equal
    blocks, block r on rank r's device. A length the axis does not divide
    raises ValueError."""
    n = mesh.size
    if x.shape[0] % n:
        raise ValueError(f"sequence length {x.shape[0]} not divisible by {mesh.axis}={n}")
    return [blk.to(dev) for blk, dev in zip(torch.chunk(x, n, dim=0), mesh.devices)]


def gather(blocks: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """The blocks of a sharded tensor joined along their first dimension on
    ``device`` (default: block 0's)."""
    dev = blocks[0].device if device is None else torch.device(device)
    return torch.cat([b.to(dev) for b in blocks], dim=0)


def _tree_to(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def replicate(tree: Any, mesh: DeviceMesh) -> list[Any]:
    """``tree`` (a dict/list of tensors) per rank: one copy on each
    distinct device (the copy on the tree's own device is the tree
    itself), ranks on one device sharing it."""
    copies = [_tree_to(tree, dev) for dev in mesh.distinct]
    return [copies[mesh.slot(r)] for r in range(mesh.size)]


# ---------------------------------------------------------------------------
# Tensor parallelism: the Megatron layout and its placement
# ---------------------------------------------------------------------------

def layer_specs(tp: str | None = "tp", cfg: LlamaConfig | None = None,
                mlp_kind: str | None = None) -> Params:
    """The spec of every parameter of one decoder layer (Megatron TP).

    ``cfg`` adds the entries of the bias vectors and norms the family
    carries: a column-parallel projection's bias is split with its output
    axis, a row-parallel one's replicated (added once, after the sum).
    ``mlp_kind`` (``"dense"`` or ``"moe"``) overrides the MLP's structure
    for stacks that interleave both (Llama 4, the Qwen3-MoE dense
    interleave); None takes MoE iff the config declares experts."""
    col = (None, tp)  # [in, out] split on out
    row = (tp, None)  # [in, out] split on in
    rep = (None,)
    bcol = (tp,)  # the bias of a column-parallel projection
    if cfg is not None and cfg.kv_lora_rank:
        # MLA: the LoRA down-projections (q_a, kv_a) and their norms are
        # replicated, since kv_a's output carries the rope key every head
        # shares; the per-head up-projections split by head like q/k/v,
        # and wo splits over the heads' values.
        attn: Params = {"kv_a": rep, "kv_a_norm": rep, "kv_b": col, "wo": row}
        if cfg.q_lora_rank:
            attn |= {"q_a": rep, "q_a_norm": rep, "q_b": col}
        else:
            attn["wq"] = col
        if cfg.attention_in_bias:
            # Biases sit on the down-projections only, whose outputs are
            # replicated.
            attn["bkv_a"] = rep
            if cfg.q_lora_rank:
                attn["bq_a"] = rep
    else:
        attn = {"wq": col, "wk": col, "wv": col, "wo": row}
    if mlp_kind is None:
        mlp_kind = "moe" if (cfg is not None and cfg.num_local_experts) else "dense"
    if mlp_kind == "moe":
        # Expert parallelism: the stacked [E, ...] experts split on the
        # expert axis, each rank running its own experts for every token;
        # the router is replicated, so every rank routes alike.
        exp = (tp, None, None)
        mlp: Params = {"router": rep, "gate": exp, "up": exp, "down": exp}
        if cfg is not None and cfg.model_type in ("llama4_text", "deepseek_v3"):
            # The shared expert is a Megatron MLP beside the routed stack;
            # its row-parallel down-projection joins the same sum.
            mlp |= {"shared_gate": col, "shared_up": col, "shared_down": row}
        if cfg is not None and cfg.model_type == "deepseek_v3":
            mlp["correction_bias"] = rep
    else:
        mlp = {"gate": col, "up": col, "down": row}
    if cfg is not None:
        if cfg.attention_in_bias and not cfg.kv_lora_rank:
            attn |= {"bq": bcol, "bk": bcol, "bv": bcol}
        if cfg.attention_out_bias:
            attn["bo"] = rep
        if cfg.qk_norm:
            attn |= {"q_norm": rep, "k_norm": rep}
        if cfg.mlp_bias and not cfg.num_local_experts:
            mlp |= {"bgate": bcol, "bup": bcol, "bdown": rep}
    out = {
        "input_layernorm": {"scale": rep},
        "post_attention_layernorm": {"scale": rep},
        "attn": attn,
        "mlp": mlp,
    }
    if cfg is not None and cfg.ffw_sandwich_norms:
        out["pre_feedforward_layernorm"] = {"scale": rep}
        out["post_feedforward_layernorm"] = {"scale": rep}
    return out


def param_specs(cfg: LlamaConfig, tp: str | None = "tp") -> Params:
    """The specs of the whole model's tree (``llama.init_params``'s): one
    spec tree per decoder layer."""
    specs: Params = {
        "embed": {"embedding": (None, tp)},  # [V, D] split on hidden
        "layers": [layer_specs(tp, cfg)] * cfg.num_hidden_layers,
        "norm": {"scale": (None,)},
    }
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = {"kernel": (None, tp)}  # [D, V] split on vocab
    return specs


def check_tp_divisibility(cfg: LlamaConfig, tp_size: int) -> None:
    """The TP constraints, checked before any weight moves."""
    if cfg.num_attention_heads % tp_size:
        raise ValueError(
            f"num_attention_heads={cfg.num_attention_heads} not divisible by tp={tp_size}")
    if cfg.num_key_value_heads % tp_size:
        raise ValueError(
            f"num_key_value_heads={cfg.num_key_value_heads} not divisible by tp={tp_size}")
    if cfg.num_local_experts:
        # MoE MLPs split on the expert axis; the dense interleave layers and
        # the shared expert on their own hidden axis.
        if cfg.num_local_experts % tp_size:
            raise ValueError(
                f"num_local_experts={cfg.num_local_experts} not divisible by tp={tp_size}")
        dense_f = cfg.intermediate_size_mlp or (
            cfg.intermediate_size if cfg.moe_layer_pattern else None)
        if cfg.model_type in ("llama4_text", "deepseek_v3") and cfg.intermediate_size % tp_size:
            raise ValueError(
                f"shared-expert intermediate_size={cfg.intermediate_size} "
                f"not divisible by tp={tp_size}")
        if dense_f and dense_f % tp_size:
            raise ValueError(
                f"dense-layer intermediate size {dense_f} not divisible by tp={tp_size}")
    elif cfg.intermediate_size % tp_size:
        raise ValueError(
            f"intermediate_size={cfg.intermediate_size} not divisible by tp={tp_size}")


def _split_axis(spec: tuple, ndim: int, axis: str) -> int | None:
    """The dimension ``spec`` splits over ``axis`` (None: replicated)."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    hits = [d for d, name in enumerate(spec) if name == axis]
    return hits[0] if hits else None


def _cut(t: torch.Tensor, dim: int | None, rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s block of ``t`` along ``dim`` (a view), or ``t``."""
    if dim is None:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of a {tuple(t.shape)} tensor not divisible by tp={n}")
    size = t.shape[dim] // n
    return t.narrow(dim, rank * size, size)


def _is_quant(node) -> bool:
    return isinstance(node, dict) and set(node) in ({"q8", "s"}, {"q4", "s"})


def _quant_slices(node: dict, spec: tuple, n: int, axis: str) -> list:
    """A quantized leaf-group's per-rank groups (the JAX executor's
    ``_quantized_target``). int8: the payload takes the weight's split and
    its per-channel scale the out axis's (with the expert axis), so a row
    split replicates the scale. int4: payload [.., in/2, out] and group
    scales [.., in/g, out] have the weight's rank and take its split as it
    is; a row split must leave every rank whole groups."""
    if "q4" in node:
        q = node["q4"]
        dim = _split_axis(spec, q.ndim, axis)
        if dim is not None and dim == q.ndim - 2 and node["s"].shape[-2] % n:
            from flexible_llm_sharding_tpu_torch.utils.checkpoint import INT4_GROUP

            raise NotImplementedError(
                "int4 row shard would split a quantization group across chips: "
                f"{node['s'].shape[-2]} groups of {INT4_GROUP} over tp={n}; pad the in "
                "dim or use int8 for this kernel")
        if dim is None:
            return [node] * n
        return [{"q4": _cut(q, dim, r, n), "s": _cut(node["s"], dim, r, n)} for r in range(n)]
    q, s = node["q8"], node["s"]
    full = tuple(spec) + (None,) * (q.ndim - len(spec))
    s_spec = (full[: s.ndim - 1] + (full[-1],)) if s.ndim else ()
    q_dim = _split_axis(full, q.ndim, axis)
    s_dim = _split_axis(s_spec, s.ndim, axis)
    if q_dim is None:
        return [node] * n
    return [{"q8": _cut(q, q_dim, r, n), "s": _cut(s, s_dim, r, n)} for r in range(n)]


def rank_slices(tree: Any, specs: Any, n: int, axis: str = "tp") -> list[Any]:
    """``tree`` cut into ``n`` per-rank trees by ``specs`` (a spec tree of
    the same keys, or one spec for a whole subtree), each block a view of
    ``tree``'s tensor; a replicated leaf is the same object in every
    rank's tree. Quantized leaf-groups split as :func:`_quant_slices`
    says."""
    if tree is None:
        return [None] * n
    if _is_quant(tree):
        return _quant_slices(tree, specs, n, axis)
    if isinstance(tree, dict):
        per_key = {k: rank_slices(v, specs[k] if isinstance(specs, dict) else specs, n, axis)
                   for k, v in tree.items()}
        return [{k: v[r] for k, v in per_key.items()} for r in range(n)]
    dim = _split_axis(specs, tree.ndim, axis)
    return [_cut(tree, dim, r, n) for r in range(n)]


def _host_nbytes(leaf) -> int:
    if isinstance(leaf, dict):
        return sum(_host_nbytes(v) for v in leaf.values())
    return leaf.numel() * leaf.element_size()


def shard_params(params: Any, mesh: DeviceMesh, specs: Any, place=None,
                 rank_bytes: list[int] | None = None) -> list[Any]:
    """One tree per rank of ``mesh`` (the JAX package's ``shard_params``
    and ``tree_shardings`` in one): rank r's slices of ``params`` by ``specs``,
    placed on ``mesh.devices[r]`` by ``place(leaf, device)`` (a leaf is a
    tensor or a quantized leaf-group; default ``.to(device)`` of each
    tensor). A replicated leaf is placed once per distinct device and
    shared by the ranks there, as :func:`replicate` shares it.
    ``rank_bytes`` (one int per rank) gains the host bytes each placement
    moved, a shared leaf charged to the first rank on its device."""
    if place is None:
        place = lambda leaf, dev: _tree_to(leaf, dev)  # noqa: E731
    slices = rank_slices(params, specs, mesh.size, mesh.axis)
    placed: dict[tuple[int, torch.device], Any] = {}

    def put(leaf, rank: int):
        dev = mesh.devices[rank]
        key = (id(leaf), dev)
        if key not in placed:
            placed[key] = place(leaf, dev)
            if rank_bytes is not None:
                rank_bytes[rank] += _host_nbytes(leaf)
        return placed[key]

    def walk(tree, rank: int):
        if tree is None:
            return None
        if _is_quant(tree) or not isinstance(tree, dict):
            return put(tree, rank)
        return {k: walk(v, rank) for k, v in tree.items()}

    return [walk(s, r) for r, s in enumerate(slices)]


class TpPlacement:
    """Weights and activations of tensor-parallel streaming over a ``tp``
    mesh (the JAX package's ``TpPlacement``): every streamed shard's
    weights are split Megatron-style over the mesh's devices
    (:func:`layer_specs`), each rank uploading only its slices, while the
    activations stay one copy on the first device, :attr:`device`, where
    the layers sum the ranks' partial outputs. The embedding and the final
    norm, replicated in the JAX package, are placed once, on that device:
    only the activations read them.

    The executor takes it as its ``device``: :meth:`segment_target` gives
    the specs of a split segment kind, :meth:`layer_specs_for` those of one
    streamed decoder layer or head, which :func:`shard_params` places as
    one tree per rank."""

    def __init__(self, devices: Sequence, cfg: LlamaConfig | None = None):
        if len(devices) < 2:
            raise ValueError("TpPlacement needs >= 2 devices")
        self.mesh = make_mesh({"tp": len(devices)}, list(devices))
        self.device = self.mesh.devices[0]
        self._decoder = layer_specs("tp", cfg)
        # Mixed dense/MoE stacks: a decoder layer without a router takes
        # the dense Megatron specs.
        self._decoder_dense = (layer_specs("tp", cfg, mlp_kind="dense")
                               if cfg is not None and cfg.num_local_experts
                               and cfg.moe_layer_pattern else self._decoder)
    @property
    def size(self) -> int:
        return self.mesh.size

    def segment_target(self, kind: str, host=None):
        """The specs of a split segment kind: for ``"decoders"`` those of
        the decoder layer whose host tree is ``host`` (the dense specs
        where its MLP has no router); for ``"head"`` the kernel [D, V]
        split on vocab, each rank scoring a slice that the first device
        joins before the softmax."""
        if kind == "head":
            return {"kernel": (None, "tp")}
        return self._decoder_dense if "router" not in host["mlp"] else self._decoder

    def layer_specs_for(self, name: str, host, tied_head: bool = False) -> Any:
        """The specs of a streamed decoder layer's or the head's host tree
        by its name (the checkpoint's ``model.layers.{i}`` or ``lm_head``).
        ``tied_head``: a float head arrives as the tied embedding [V, D],
        transposed after placement, so it splits on its first axis (a
        quantized one arrives as [D, V])."""
        if name.startswith("model.layers."):
            return self.segment_target("decoders", host)
        if tied_head and not _is_quant(host["kernel"]):
            return {"kernel": ("tp", None)}
        return self.segment_target("head")

    def check(self, cfg: LlamaConfig) -> None:
        check_tp_divisibility(cfg, self.mesh.size)


__all__ = [
    "DeviceMesh",
    "TpPlacement",
    "check_tp_divisibility",
    "gather",
    "layer_specs",
    "make_mesh",
    "param_specs",
    "rank_slices",
    "replicate",
    "shard",
    "shard_params",
]
