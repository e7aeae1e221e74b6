"""Per-layer checkpoints: a safetensors reader and writer of the port's
own, the offline splitter of Hugging Face checkpoints, layer loading,
saving, and conversion from the JAX package's parameter pytree.

The on-disk layout is the JAX package's (``utils/checkpoint.py``): one
``<layer name>.safetensors`` file per execution-list entry
(``model.embed_tokens``, ``model.layers.{i}``, ``model.norm``, ``lm_head``),
and a ``config.json``. In the native layout the keys are the dotted keys of
the nested parameter dict (``attn.wq``, ``input_layernorm.scale``, ...) and
linear kernels are stored [in, out]; in the ``hf`` layout (the reference's
own ``prepare_weights.py`` files) they keep their Hugging Face names and
[out, in] shapes, and :func:`load_layer` converts them. A safetensors file
is an 8-byte little-endian header length, a JSON header ``{key: {"dtype",
"shape", "data_offsets"}}``, then the raw tensor bytes. BF16 payloads are
read as uint16 and reinterpreted with ``.view(torch.bfloat16)``, so neither
``safetensors`` nor ``ml_dtypes`` is needed. Every writer here also writes
the directory's ``integrity.json`` (``integrity/manifest.py``, the JAX
package's format), and :func:`load_layer` verifies against it.

Quantized layers are the JAX package's too: a matmul kernel stored as
``{key}`` int8 with a float32 ``{key}::scale`` (one scale per output
channel; per (expert, channel) for [E, in, out] expert stacks), or as
``{key}`` packed uint8 with a float32 ``{key}::scale4`` (int4: groups of
``INT4_GROUP`` along the in axis, offset-binary nibbles, the low nibble
the even index). :func:`load_layer` returns each such pair as a
``{"q8", "s"}`` or ``{"q4", "s"}`` leaf-group, still packed: the weight
source dequantizes it on the device after the upload. The quantizers give
the JAX package's bytes exactly (float32 scales in its order, division by
the scale, round half to even).
"""

from __future__ import annotations

import json
import os
import re
import shutil
from glob import glob
from typing import Any, Callable, Iterator

import numpy as np
import torch

from flexible_llm_sharding_tpu_torch.config import LlamaConfig, extract_text_config
from flexible_llm_sharding_tpu_torch.integrity import manifest as integrity_manifest

LAYER_FILE_SUFFIX = ".safetensors"
# Written beside the layer files by both splitters and requantize_native:
# {"layout", "dtype", "layers"}.
NATIVE_LAYOUT_MARKER = "fls_tpu_layout.json"
QUANT_SCALE_SUFFIX = integrity_manifest.QUANT_SCALE_SUFFIX
QUANT4_SCALE_SUFFIX = integrity_manifest.QUANT4_SCALE_SUFFIX
_SCALE_SUFFIXES = (QUANT_SCALE_SUFFIX, QUANT4_SCALE_SUFFIX)
INT4_GROUP = 64
QUANT_DTYPES = ("int8", "int4")
is_float_like = integrity_manifest.is_float_like

_ST_TO_TORCH = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_TORCH_TO_ST = {v: k for k, v in _ST_TO_TORCH.items()}


def layer_names_for(num_hidden_layers: int, tie_word_embeddings: bool = False) -> list[str]:
    """Execution-ordered layer names."""
    names = (
        ["model.embed_tokens"]
        + [f"model.layers.{i}" for i in range(num_hidden_layers)]
        + ["model.norm"]
    )
    if not tie_word_embeddings:
        names.append("lm_head")
    return names


def safetensors_header(path: str) -> tuple[dict[str, dict], int]:
    """({key: {"dtype", "shape", "data_offsets"}}, payload offset)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def _read_into(f, buf: torch.Tensor, path: str) -> None:
    view = memoryview(buf.numpy())
    got = 0
    while got < buf.numel():
        n = f.readinto(view[got:])
        if not n:
            raise ValueError(f"{path}: truncated payload ({got} of {buf.numel()} bytes)")
        got += n


def read_safetensors(path: str, pin_memory: bool = False,
                     want: Callable[[str], bool] | None = None) -> dict[str, torch.Tensor]:
    """Read a safetensors file into one host buffer (page-locked with
    ``pin_memory``, so uploads can run asynchronously) and return CPU tensor
    views into it, one per key. With ``want`` (key -> bool) only the wanted
    tensors are read, each into its own buffer: the others' bytes are never
    read (a multimodal bundle's vision tower)."""
    header, base = safetensors_header(path)
    size = os.path.getsize(path) - base
    metas = {}
    for key, meta in header.items():
        if want is not None and not want(key):
            continue
        if meta["dtype"] not in _ST_TO_TORCH:
            raise ValueError(f"{path}: {key} has unsupported dtype {meta['dtype']}")
        dt = _ST_TO_TORCH[meta["dtype"]]
        b, e = meta["data_offsets"]
        itemsize = torch.empty((), dtype=dt).element_size()
        if e - b != int(np.prod(meta["shape"], dtype=np.int64)) * itemsize or e > size or b < 0:
            raise ValueError(f"{path}: {key} has inconsistent data_offsets")
        metas[key] = (dt, meta["shape"], b, e, itemsize)
    out = {}
    with open(path, "rb") as f:
        if want is not None:
            for key, (dt, shape, b, e, _) in metas.items():
                buf = torch.empty(e - b, dtype=torch.uint8, pin_memory=pin_memory)
                f.seek(base + b)
                _read_into(f, buf, path)
                out[key] = buf.view(dt).reshape(shape)
            return out
        buf = torch.empty(size, dtype=torch.uint8, pin_memory=pin_memory)
        f.seek(base)
        _read_into(f, buf, path)
    for key, (dt, shape, b, e, itemsize) in metas.items():
        raw = buf[b:e]
        if b % itemsize:
            raw = raw.clone()  # the payload is not aligned for a view
        out[key] = raw.view(dt).reshape(shape)
    return out


def write_safetensors(path: str, tensors: dict[str, torch.Tensor]) -> None:
    """Write CPU tensors (any layout) as one safetensors file, atomically."""
    header: dict[str, Any] = {}
    payloads = []
    off = 0
    for key, t in tensors.items():
        t = t.detach().to("cpu").contiguous()
        if t.dtype not in _TORCH_TO_ST:
            raise ValueError(f"{key}: unsupported dtype {t.dtype}")
        data = t.reshape(-1).view(torch.uint8) if t.numel() else torch.empty(0, dtype=torch.uint8)
        header[key] = {
            "dtype": _TORCH_TO_ST[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [off, off + data.numel()],
        }
        payloads.append(data)
        off += data.numel()
    hbytes = json.dumps(header, separators=(",", ":")).encode()
    hbytes += b" " * (-(8 + len(hbytes)) % 8)  # payload starts 8-byte aligned
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(len(hbytes).to_bytes(8, "little"))
        f.write(hbytes)
        for data in payloads:
            f.write(data.numpy())
    os.replace(tmp, path)


def unflatten(flat: dict[str, Any]) -> dict[str, Any]:
    """Dotted keys -> nested dict."""
    tree: dict[str, Any] = {}
    for k, v in flat.items():
        node = tree
        parts = k.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def flatten(tree: dict[str, Any], prefix: str = "") -> Iterator[tuple[str, Any]]:
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from flatten(v, name)
        else:
            yield name, v


def layer_file(model_path: str, name: str) -> str:
    return os.path.join(model_path, f"{name}{LAYER_FILE_SUFFIX}")


def layer_file_for(model_path: str, name: str, tied: bool = False) -> str:
    """The file a layer name reads: with tied embeddings, ``lm_head`` comes
    from the embedding file (the loader's quarantine and stat-guard key)."""
    return layer_file(model_path, "model.embed_tokens" if (name == "lm_head" and tied) else name)


# ---------------------------------------------------------------------------
# Quantized layouts (the JAX package's int8/int4 files, on torch tensors)
# ---------------------------------------------------------------------------

def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else tensor_from_numpy(np.asarray(a))


def _scale_expand(scale: torch.Tensor, q_ndim: int) -> tuple[int, ...]:
    """Broadcast shape of a quantization scale against its payload: the
    scale keeps the payload's leading (expert) axes and its trailing
    channel axis; the reduced axes between become size 1."""
    return tuple(scale.shape[:-1]) + (1,) * (q_ndim - scale.ndim) + tuple(scale.shape[-1:])


def _float32_scratch(w, scratch: torch.Tensor | None) -> torch.Tensor:
    """``w`` as a float32 tensor of its own, which the quantizers overwrite
    in place: ``scratch`` when given (an expert stack reuses one for every
    expert), else a new copy. Every large temporary is a fresh allocation
    that the host pays for in page faults, so they make at most this one."""
    if scratch is None:
        return _as_tensor(w).to(torch.float32, copy=True)
    return scratch.copy_(_as_tensor(w))


def _absmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x.abs().amax(dim)`` without the ``|x|`` temporary (exact: the
    larger of the maximum and the negated minimum)."""
    lo, hi = torch.aminmax(x, dim=dim)
    return torch.maximum(hi, lo.neg_())


def _quantize_int8(w, scratch: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: (q int8 [same shape], float32
    scale). A 2-D [in, out] kernel gets one scale per output channel; a
    3-D [E, in, out] expert stack one per (expert, channel), scale [E, out]."""
    w32 = _float32_scratch(w, scratch)
    scale = _absmax(w32, -2).clamp_min_(1e-12).div_(127.0)
    q = w32.div_(scale.reshape(_scale_expand(scale, w32.ndim))).round_().clamp_(-127, 127)
    return q.to(torch.int8), scale


def _quantize_int4(w, group: int = INT4_GROUP,
                   scratch: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric group-wise int4 along the in axis (-2): values in [-7, 7]
    stored offset-binary (nibble = q + 8), two per byte along the in axis,
    the low nibble the even index. Returns (packed uint8 [.., in/2, out],
    float32 scale [.., in/group, out]); in % group must be 0."""
    w32 = _float32_scratch(w, scratch)
    *lead, n_in, n_out = w32.shape
    wg = w32.view(*lead, n_in // group, group, n_out)
    scale = _absmax(wg, -2).clamp_min_(1e-12).div_(7.0)
    q = wg.div_(scale[..., None, :]).round_().clamp_(-7, 7).to(torch.int8)
    nib = q.add_(8).view(torch.uint8).view(*lead, n_in, n_out)
    packed = nib[..., 1::2, :] << 4
    return packed.bitwise_or_(nib[..., 0::2, :]), scale


def _quantize_one(v: torch.Tensor, dtype: str) -> tuple[torch.Tensor, torch.Tensor]:
    """One kernel at ``dtype`` (``int4`` falls back to int8 when its in dim
    is off the group). Expert stacks are quantized one expert at a time:
    both layouts reduce within an expert, so the bytes are those of one
    pass over the stack, and a 23 GB stack never needs float32 copies of
    itself."""
    quant = _quantize_int4 if dtype == "int4" and v.shape[-2] % INT4_GROUP == 0 else _quantize_int8
    if v.ndim < 3:
        return quant(v)
    scratch = torch.empty(v.shape[1:], dtype=torch.float32)
    parts = [quant(e, scratch=scratch) for e in v]
    return torch.stack([q for q, _ in parts]), torch.stack([s for _, s in parts])


def _quantize_flat(sd: dict, dtype: str = "int8") -> dict[str, torch.Tensor]:
    """One flat native state dict at ``dtype`` (``int8`` or ``int4``):
    matmul kernels (floats of 2 dims or more) quantize and gain a scale
    twin (``::scale`` for int8, ``::scale4`` for int4; an int4 kernel whose
    in dim is off the group falls back to int8); 1-D floats below float32
    are up-cast to float32 exactly; everything else is kept. The one rule of
    ``split_into_layers`` and ``requantize_native``."""
    qd: dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        v = _as_tensor(v)
        if v.ndim >= 2 and v.is_floating_point():
            q, sc = _quantize_one(v, dtype)
            four = q.dtype == torch.uint8
            qd[k] = q
            qd[k + (QUANT4_SCALE_SUFFIX if four else QUANT_SCALE_SUFFIX)] = sc
        elif v.is_floating_point() and v.element_size() < 4:
            qd[k] = v.float()
        else:
            qd[k] = v
    return qd


def is_quantized_leaf(node) -> bool:
    """True for an int8 ``{"q8", "s"}`` or int4 ``{"q4", "s"}`` leaf-group."""
    return isinstance(node, dict) and set(node) in ({"q8", "s"}, {"q4", "s"})


def quant_kind(node) -> str:
    """'q8' or 'q4' for a quantized leaf-group."""
    return "q8" if "q8" in node else "q4"


def dequant4_math(b: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int4 unpack and group dequant, float32 out: low nibble = even in
    index, offset-binary (nibble = q + 8), scales [.., in/g, out]."""
    lo = (b & 0xF).float() - 8.0
    hi = (b >> 4).float() - 8.0
    q = torch.stack([lo, hi], dim=-2)  # [.., in/2, 2, out]
    *lead, half, _, out = q.shape
    q = q.reshape(*lead, half * 2, out)
    n_groups = s.shape[-2]
    qg = q.reshape(*lead, n_groups, (half * 2) // n_groups, out)
    return (qg * s[..., None, :]).reshape(*lead, half * 2, out)


def _dequant_math(node: dict, dtype: torch.dtype) -> torch.Tensor:
    if quant_kind(node) == "q4":
        return dequant4_math(node["q4"], node["s"].float()).to(dtype)
    q, s = node["q8"], node["s"]
    return (q.float() * s.reshape(_scale_expand(s, q.ndim))).to(dtype)


def dequantize(node: dict, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One quantized leaf-group as ``dtype``, on the leaf-group's device:
    ``q * s`` in float32 (int4 through :func:`dequant4_math`), then cast.
    Expert stacks are expanded one expert at a time into the output, so the
    float32 products of one expert exist at a time; every element is the
    same product either way."""
    payload = node[quant_kind(node)]
    if payload.ndim < 3:
        return _dequant_math(node, dtype)
    first = _dequant_math({k: v[0] for k, v in node.items()}, dtype)
    out = first.new_empty((payload.shape[0], *first.shape))
    out[0] = first
    for e in range(1, payload.shape[0]):
        out[e] = _dequant_math({k: v[e] for k, v in node.items()}, dtype)
    return out


def dequantize_tree(tree, dtype: torch.dtype = torch.float32):
    """Every quantized leaf-group of a nested dict dequantized to ``dtype``
    (the host oracle of the weight source's on-device dequant); other
    leaves are returned as they are."""
    if is_quantized_leaf(tree):
        return dequantize(tree, dtype)
    if isinstance(tree, dict):
        return {k: dequantize_tree(v, dtype) for k, v in tree.items()}
    return tree


def simulate_quantized(a, dtype: str) -> torch.Tensor:
    """Quantize-dequantize round trip of one kernel under exactly the rule
    ``_quantize_flat`` writes (int4 falls back to int8 off the group),
    float32 out: what the sensitivity probe scores."""
    if dtype not in QUANT_DTYPES:
        raise ValueError(f"simulate_quantized: unsupported dtype {dtype!r}")
    a32 = _as_tensor(a).float()
    if dtype == "int4" and a32.ndim >= 2 and a32.shape[-2] % INT4_GROUP == 0:
        q, s = _quantize_int4(a32)
        return dequantize({"q4": q, "s": s})
    q, s = _quantize_int8(a32)
    return dequantize({"q8": q, "s": s})


def _group_quantized(flat: dict) -> dict:
    """Each ``{key}`` with a scale twin as its ``{"q8"|"q4", "s"}`` group."""
    if not any(k.endswith(_SCALE_SUFFIXES) for k in flat):
        return flat
    grouped: dict[str, Any] = {}
    for k, v in flat.items():
        if k.endswith(_SCALE_SUFFIXES):
            continue
        if k + QUANT4_SCALE_SUFFIX in flat:
            grouped[k] = {"q4": v, "s": flat[k + QUANT4_SCALE_SUFFIX]}
        elif k + QUANT_SCALE_SUFFIX in flat:
            grouped[k] = {"q8": v, "s": flat[k + QUANT_SCALE_SUFFIX]}
        else:
            grouped[k] = v
    return grouped


def load_layer(model_path: str, layer_name: str, pin_memory: bool = False,
               manifest: dict | None = None, corrupt=None) -> dict[str, Any]:
    """One layer file -> nested dict of CPU tensors in the native layout:
    bit-exact with the stored values for a native file; a file of Hugging
    Face keys (``prepare_weights --layout hf``, the reference's own split)
    is converted by :func:`hf_layer_to_native` (page-locked again with
    ``pin_memory``, since the transposes make new tensors).

    With ``manifest`` (``integrity.json``), in the JAX package's order: the
    verdict token is taken before the read and re-taken after it; the raw
    stored tensors are crc-verified unless that file generation already
    passed (a mismatch raises the retryable ``ChecksumMismatch``); the
    storage-dtype kind is checked on every load (``PrecisionMismatch``);
    then the layout is converted and quantized kernels are grouped with
    their scales.

    ``corrupt`` (chaos only: ``FaultInjector.corrupt_flat``) is applied to
    the raw tensors before the check; a load it changed (it returns a new
    dict then) is always crc-verified and records no verdict, so the
    injected flip is what the checksum must catch."""
    path = layer_file(model_path, layer_name)
    token = integrity_manifest.verdict_token(model_path, path) if manifest is not None else None
    flat = raw = read_safetensors(path, pin_memory)
    if token is not None and integrity_manifest.verdict_token(model_path, path) != token:
        token = None  # replaced mid-read: verify these bytes, record nothing
    if corrupt is not None:
        flat = corrupt(flat)
    if manifest is not None:
        injected = flat is not raw
        if injected or not integrity_manifest.verdict_cached(token):
            integrity_manifest.verify_flat(layer_name, flat, manifest, path=path)
            if not injected:
                integrity_manifest.record_verdict(token)
        want_kind = (manifest.get("layers", {}).get(layer_name) or {}).get("dtype")
        if want_kind is not None:
            got_kind = integrity_manifest.flat_dtype_kind(flat)
            if got_kind != want_kind:
                raise integrity_manifest.PrecisionMismatch(
                    f"{path}: layer {layer_name!r} stores dtype kind {got_kind!r} but the "
                    f"integrity manifest declares {want_kind!r} (audit with the `verify` "
                    "subcommand)"
                )
    if not _is_native(flat):
        flat = hf_layer_to_native(layer_name, flat)
        if pin_memory:
            flat = {k: v.pin_memory() for k, v in flat.items()}
    return unflatten(_group_quantized(flat))


# ---------------------------------------------------------------------------
# Hugging Face checkpoints: enumeration, layout conversion, the splitter
# (the JAX package's utils/checkpoint.py, on torch tensors)
# ---------------------------------------------------------------------------

def key_to_layer(key: str) -> str:
    """The layer a flat Hugging Face key belongs to: ``.weight``/``.bias``
    stripped, the first three dotted parts kept
    (``model.layers.17.self_attn.q_proj.weight`` -> ``model.layers.17``;
    ``lm_head.weight`` -> ``lm_head``), the reference's grouping rule."""
    return ".".join(re.sub(r"\.(weight|bias)$", "", key).split(".")[:3])


def _hf_weight_map(src_dir: str) -> tuple[dict[str, str], str]:
    """({key: shard file name}, "safetensors" or "bin") for an indexed or a
    single-file Hugging Face checkpoint."""
    for index_name, kind in (("model.safetensors.index.json", "safetensors"),
                             ("pytorch_model.bin.index.json", "bin")):
        p = os.path.join(src_dir, index_name)
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)["weight_map"], kind
    for single, kind in (("model.safetensors", "safetensors"), ("pytorch_model.bin", "bin")):
        p = os.path.join(src_dir, single)
        if os.path.exists(p):
            if kind == "safetensors":
                keys = list(safetensors_header(p)[0])
            else:
                keys = list(torch.load(p, map_location="meta", weights_only=True))
            return {k: single for k in keys}, kind
    raise FileNotFoundError(f"No HF checkpoint found under {src_dir}")


def _load_shard(path: str, kind: str, want: Callable[[str], bool] | None = None
                ) -> dict[str, torch.Tensor]:
    """One Hugging Face shard as CPU tensors; ``want`` (key -> bool) selects
    keys. A safetensors shard is read by the port's own reader, which never
    reads the unwanted tensors; a ``.bin`` shard is loaded whole
    (``torch.load(weights_only=True)``) and filtered."""
    if kind == "safetensors":
        return read_safetensors(path, want=want)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in sd.items() if want is None or want(k)}


# (native flat key, Hugging Face sub-key, transpose?) of a decoder layer.
_LAYER_MAP = [
    ("input_layernorm.scale", "input_layernorm.weight", False),
    ("post_attention_layernorm.scale", "post_attention_layernorm.weight", False),
    ("attn.wq", "self_attn.q_proj.weight", True),
    ("attn.wk", "self_attn.k_proj.weight", True),
    ("attn.wv", "self_attn.v_proj.weight", True),
    ("attn.wo", "self_attn.o_proj.weight", True),
    ("mlp.gate", "mlp.gate_proj.weight", True),
    ("mlp.up", "mlp.up_proj.weight", True),
    ("mlp.down", "mlp.down_proj.weight", True),
]

# Tensors only some families have, kept where the checkpoint has them (the
# layer functions key on their presence): Qwen2's q/k/v biases, Llama's
# attention_bias/mlp_bias, Qwen3's and Gemma 3's q/k norms, Gemma 2/3's
# sandwich norms.
_LAYER_MAP_OPTIONAL = [
    ("attn.bq", "self_attn.q_proj.bias"),
    ("attn.bk", "self_attn.k_proj.bias"),
    ("attn.bv", "self_attn.v_proj.bias"),
    ("attn.bo", "self_attn.o_proj.bias"),
    ("attn.q_norm", "self_attn.q_norm.weight"),
    ("attn.k_norm", "self_attn.k_norm.weight"),
    ("pre_feedforward_layernorm.scale", "pre_feedforward_layernorm.weight"),
    ("post_feedforward_layernorm.scale", "post_feedforward_layernorm.weight"),
    ("mlp.bgate", "mlp.gate_proj.bias"),
    ("mlp.bup", "mlp.up_proj.bias"),
    ("mlp.bdown", "mlp.down_proj.bias"),
]

# Buffers some checkpoints carry that hold no weights.
_IGNORABLE_HF_SUFFIXES = ("rotary_emb.inv_freq",)

def _t(w: torch.Tensor) -> torch.Tensor:
    return w.T.contiguous()


def _stack_experts(layer_name: str, prefix: str, name_map, sd: dict, out: dict,
                   consumed: set) -> None:
    """Stack per-expert Linear weights ``{prefix}.{e}.{hf_name}.weight`` into
    one [E, in, out] native tensor per projection (the layout the MoE
    layers index by expert)."""
    probe = name_map[0][1]
    n_exp = 0
    while f"{prefix}.{n_exp}.{probe}.weight" in sd:
        n_exp += 1
    if not n_exp:
        raise ValueError(f"{layer_name}: MoE layer with no expert weights")
    for native_key, hf_w in name_map:
        keys = [f"{prefix}.{e}.{hf_w}.weight" for e in range(n_exp)]
        out[native_key] = torch.stack([sd[k].T for k in keys]).contiguous()
        consumed.update(keys)


_EXPERT_PROJ = (("mlp.gate", "gate_proj"), ("mlp.up", "up_proj"), ("mlp.down", "down_proj"))
_SHARED_PROJ = (("mlp.shared_gate", "gate_proj"), ("mlp.shared_up", "up_proj"),
                ("mlp.shared_down", "down_proj"))


def _llama4_ff_to_native(layer_name: str, sd: dict, out: dict, consumed: set) -> None:
    """Llama 4's ``feed_forward``: a dense layer's gate/up/down Linears, or
    an MoE layer's fused ``experts.gate_up_proj`` [E, D, 2F] (already [in,
    out] per expert, a Parameter, not a Linear) split into gate and up,
    ``experts.down_proj`` [E, F, D] as it is, the transposed router and the
    shared expert's Linears."""
    ff = f"{layer_name}.feed_forward"

    def take(native_key, key, transpose=True):
        consumed.add(key)
        out[native_key] = _t(sd[key]) if transpose else sd[key]

    if f"{ff}.router.weight" not in sd:
        for native_key, sub in _EXPERT_PROJ:
            take(native_key, f"{ff}.{sub}.weight")
        return
    key = f"{ff}.experts.gate_up_proj"
    gu = sd[key]
    consumed.add(key)
    f_dim = gu.shape[-1] // 2
    out["mlp.gate"] = gu[..., :f_dim].contiguous()
    out["mlp.up"] = gu[..., f_dim:].contiguous()
    take("mlp.down", f"{ff}.experts.down_proj", transpose=False)
    take("mlp.router", f"{ff}.router.weight")
    for native_key, sub in _SHARED_PROJ:
        take(native_key, f"{ff}.shared_expert.{sub}.weight")


def _mla_to_native(layer_name: str, sd: dict, out: dict, consumed: set) -> None:
    """DeepSeek's multi-head latent attention (DeepseekV3Attention): q dense
    (q_proj) or by LoRA (q_a -> norm -> q_b), K/V always compressed
    (kv_a_proj_with_mqa -> norm -> kv_b); kernels [in, out]."""
    def take(native_key, hf_sub, transpose=True, optional=False):
        key = f"{layer_name}.self_attn.{hf_sub}"
        if key not in sd:
            if optional:
                return
            raise KeyError(f"{layer_name}: missing MLA tensor {key}")
        consumed.add(key)
        out[native_key] = _t(sd[key]) if transpose else sd[key]

    if f"{layer_name}.self_attn.q_proj.weight" in sd:
        take("attn.wq", "q_proj.weight")
    else:
        take("attn.q_a", "q_a_proj.weight")
        take("attn.q_a_norm", "q_a_layernorm.weight", transpose=False)
        take("attn.q_b", "q_b_proj.weight")
        take("attn.bq_a", "q_a_proj.bias", transpose=False, optional=True)
    take("attn.kv_a", "kv_a_proj_with_mqa.weight")
    take("attn.kv_a_norm", "kv_a_layernorm.weight", transpose=False)
    take("attn.kv_b", "kv_b_proj.weight")
    take("attn.bkv_a", "kv_a_proj_with_mqa.bias", transpose=False, optional=True)


def hf_layer_to_native(layer_name: str, sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """One layer's Hugging Face state dict -> native flat keys and layout
    (linear kernels transposed to [in, out]). Phi-3's fused ``qkv_proj`` and
    ``gate_up_proj`` are split (o_proj's input width is n_q * hd and the two
    KV blocks share the rest); DeepSeek's MLA projections keep their own
    keys; the experts of Mixtral (``block_sparse_moe``), Qwen3-MoE and
    DeepSeek (``mlp.experts``, DeepSeek's correction bias and shared expert)
    are stacked per projection under a transposed router; Llama 4's
    ``feed_forward`` keys as :func:`_llama4_ff_to_native` maps them. A
    tensor with no native slot raises."""
    if layer_name == "model.embed_tokens":
        return {"embedding": sd["model.embed_tokens.weight"]}
    if layer_name == "model.norm":
        return {"scale": sd["model.norm.weight"]}
    if layer_name == "lm_head":
        return {"kernel": _t(sd["lm_head.weight"])}
    mixtral = any(".block_sparse_moe." in k for k in sd)
    experts = f"{layer_name}.mlp.experts.0.gate_proj.weight" in sd  # qwen3_moe, deepseek
    fused = f"{layer_name}.self_attn.qkv_proj.weight" in sd  # phi3
    mla = f"{layer_name}.self_attn.kv_a_proj_with_mqa.weight" in sd  # deepseek
    ff = any(".feed_forward." in k for k in sd)  # llama4
    out: dict[str, torch.Tensor] = {}
    consumed = set()
    for native_key, hf_sub, transpose in _LAYER_MAP:
        if (mixtral or experts or ff) and native_key.startswith("mlp."):
            continue
        if fused and native_key in ("attn.wq", "attn.wk", "attn.wv", "mlp.gate", "mlp.up"):
            continue
        if mla and native_key in ("attn.wq", "attn.wk", "attn.wv"):
            continue
        key = f"{layer_name}.{hf_sub}"
        consumed.add(key)
        out[native_key] = _t(sd[key]) if transpose else sd[key]
    if mla:
        _mla_to_native(layer_name, sd, out, consumed)
    if fused:
        key = f"{layer_name}.self_attn.qkv_proj.weight"
        qkv = sd[key]
        consumed.add(key)
        nq_hd = out["attn.wo"].shape[0]
        nkv_hd = (qkv.shape[0] - nq_hd) // 2
        if qkv.shape[0] != nq_hd + 2 * nkv_hd:
            raise ValueError(
                f"{layer_name}: qkv_proj rows {qkv.shape[0]} do not split into "
                f"q={nq_hd} + 2*kv (o_proj implies nq*hd={nq_hd})"
            )
        out["attn.wq"] = _t(qkv[:nq_hd])
        out["attn.wk"] = _t(qkv[nq_hd: nq_hd + nkv_hd])
        out["attn.wv"] = _t(qkv[nq_hd + nkv_hd:])
        key = f"{layer_name}.mlp.gate_up_proj.weight"
        gu = sd[key]
        consumed.add(key)
        f_dim = gu.shape[0] // 2
        out["mlp.gate"] = _t(gu[:f_dim])
        out["mlp.up"] = _t(gu[f_dim:])
    for native_key, hf_sub in _LAYER_MAP_OPTIONAL:
        if mla and native_key in ("attn.bq", "attn.bk", "attn.bv"):
            continue  # HF's MLA projections carry no such bias
        key = f"{layer_name}.{hf_sub}"
        if key in sd:
            consumed.add(key)
            out[native_key] = sd[key]
    if ff:
        _llama4_ff_to_native(layer_name, sd, out, consumed)
    if experts:
        key = f"{layer_name}.mlp.gate.weight"
        out["mlp.router"] = _t(sd[key])
        consumed.add(key)
        _stack_experts(layer_name, f"{layer_name}.mlp.experts", _EXPERT_PROJ, sd, out, consumed)
        key = f"{layer_name}.mlp.gate.e_score_correction_bias"
        if key in sd:
            out["mlp.correction_bias"] = sd[key]
            consumed.add(key)
        for native_key, sub in _SHARED_PROJ:
            key = f"{layer_name}.mlp.shared_experts.{sub}.weight"
            if key in sd:
                out[native_key] = _t(sd[key])
                consumed.add(key)
    if mixtral:
        key = f"{layer_name}.block_sparse_moe.gate.weight"
        out["mlp.router"] = _t(sd[key])
        consumed.add(key)
        _stack_experts(layer_name, f"{layer_name}.block_sparse_moe.experts",
                       (("mlp.gate", "w1"), ("mlp.up", "w3"), ("mlp.down", "w2")),
                       sd, out, consumed)
    leftover = {k for k in sd.keys() - consumed if not k.endswith(_IGNORABLE_HF_SUFFIXES)}
    if leftover:
        raise ValueError(f"{layer_name}: tensors {sorted(leftover)} have no native-layout slot")
    return out


def _is_native(keys) -> bool:
    return not any(k.startswith(("model.", "lm_head")) for k in keys)


# Multimodal wrapper checkpoints (Gemma 3, Llama 4): the splitter keeps the text
# tower. Language-model keys are renamed to the plain text layout, vision
# and projector keys are dropped (never read), and the emitted config.json
# is the nested text_config, so the split directory is a text checkpoint.
_MM_DROP_PREFIXES = (
    "model.vision_tower.",
    "model.multi_modal_projector.",
    "model.vision_model.",
    "vision_tower.",
    "vision_model.",
    "multi_modal_projector.",
)


def _multimodal_remap(src_dir: str):
    """(remap, text config dict) of a multimodal wrapper checkpoint, or
    (None, None) for a text checkpoint. remap: Hugging Face key -> text-model
    key, or None for a dropped key."""
    cfg_path = os.path.join(src_dir, "config.json")
    if not os.path.exists(cfg_path):
        return None, None
    with open(cfg_path) as f:
        tc = extract_text_config(json.load(f))
    if tc is None:
        return None, None

    def remap(k: str):
        if k.startswith(_MM_DROP_PREFIXES):
            return None
        # transformers >= 4.52 nests the tower as model.language_model.*;
        # older exports use language_model.model.* (+ language_model.lm_head).
        if k.startswith("model.language_model."):
            return "model." + k[len("model.language_model."):]
        if k.startswith("language_model.model."):
            return "model." + k[len("language_model.model."):]
        if k.startswith("language_model.lm_head"):
            return k[len("language_model."):]
        return k

    return remap, tc


SPLIT_DTYPES = {None: None, "bfloat16": torch.bfloat16, "float16": torch.float16,
                "float32": torch.float32}


def split_into_layers(src_dir: str, out_dir: str, dtype: str | None = None, layout: str = "native",
                      progress: Callable[[str], None] | None = None) -> list[str]:
    """Hugging Face checkpoint directory -> one safetensors file per layer,
    plus the non-weight files (config, tokenizer) copied, as the JAX
    package's splitter writes them: layers in ascending (first shard, shard
    count) order, shards read as their layers need them and freed once
    those are written, so host memory holds about two shards. ``dtype``
    casts every float tensor (None keeps the checkpoint's), or quantizes
    the native layout's kernels (``int8``, ``int4``: :func:`_quantize_flat`,
    native layout only); ``layout`` is ``native`` ([in, out] kernels under
    native names) or ``hf`` (the reference's own files). ``integrity.json``
    is written after the last layer, over each file's stored bytes, and
    ``fls_tpu_layout.json`` names the layout, dtype and layers. Returns the
    layer names in the order written."""
    if layout not in ("native", "hf"):
        raise ValueError(f"layout must be 'native' or 'hf', got {layout!r}")
    quantize = dtype in QUANT_DTYPES
    if quantize and layout != "native":
        raise ValueError(f"dtype='{dtype}' requires layout='native'")
    if dtype not in SPLIT_DTYPES and not quantize:
        raise ValueError(
            f"dtype must be one of {list(SPLIT_DTYPES) + list(QUANT_DTYPES)}, got {dtype!r}")
    cast = SPLIT_DTYPES.get(dtype)
    os.makedirs(out_dir, exist_ok=True)
    for fn in glob(f"{src_dir}/*"):
        base = os.path.basename(fn)
        if (os.path.isfile(fn) and ".bin" not in base and not base.endswith(".safetensors")
                and not base.endswith(".index.json")):
            shutil.copy(fn, os.path.join(out_dir, base))

    weight_map, kind = _hf_weight_map(src_dir)
    remap, text_cfg = _multimodal_remap(src_dir)
    if remap is not None:
        weight_map = {remap(k): v for k, v in weight_map.items() if remap(k) is not None}
        with open(os.path.join(out_dir, "config.json"), "w") as f:
            json.dump(text_cfg, f, indent=1)
    layer2keys: dict[str, set[str]] = {}
    for k in weight_map:
        layer2keys.setdefault(key_to_layer(k), set()).add(k)
    layer2shards = {layer: {weight_map[k] for k in keys} for layer, keys in layer2keys.items()}
    shard_ids = {s: i for i, s in enumerate(sorted({s for ss in layer2shards.values() for s in ss}))}
    layer_list = sorted(
        layer2shards,
        key=lambda name: (min(shard_ids[s] for s in layer2shards[name]), len(layer2shards[name])),
    )

    want = (lambda k: remap(k) is not None) if remap is not None else None
    state: dict[str, torch.Tensor] = {}
    loaded: set[str] = set()
    manifest_layers: dict[str, dict] = {}
    for layer in layer_list:
        for shard in sorted(layer2shards[layer] - loaded):
            loaded.add(shard)
            for k, v in _load_shard(os.path.join(src_dir, shard), kind, want).items():
                state[remap(k) if remap is not None else k] = v
        missing = layer2keys[layer] - state.keys()
        if missing:
            raise KeyError(
                f"{layer}: keys {sorted(missing)} listed in the index but absent from shards "
                f"{sorted(layer2shards[layer])}"
            )
        sd = {k: state[k] for k in layer2keys[layer]}
        if cast is not None:
            sd = {k: v.to(cast) if v.is_floating_point() else v for k, v in sd.items()}
        if layout == "native":
            sd = hf_layer_to_native(layer, sd)
        if quantize:
            sd = _quantize_flat(sd, dtype)
        write_safetensors(os.path.join(out_dir, f"{layer}{LAYER_FILE_SUFFIX}"), sd)
        manifest_layers[layer] = integrity_manifest.layer_entry(sd, f"{layer}{LAYER_FILE_SUFFIX}")
        for k in layer2keys[layer]:
            del state[k]  # the shard's buffer goes with its last layer's tensors
        del sd
        if progress:
            progress(layer)
    _write_layout_marker(out_dir, layout, dtype, layer_list)
    integrity_manifest.write_manifest(out_dir, manifest_layers)
    return layer_list


def _write_layout_marker(out_dir: str, layout: str, dtype: str | None, layers: list[str]) -> None:
    with open(os.path.join(out_dir, NATIVE_LAYOUT_MARKER), "w") as f:
        json.dump({"layout": layout, "dtype": dtype, "layers": layers}, f)


def _cast_flat_bf16(sd: dict) -> dict:
    """Every float tensor cast to bfloat16, the uniform cast of
    ``split_into_layers(dtype='bfloat16')``, so a plan's bf16 layers equal
    the uniform-bf16 checkpoint's bit for bit."""
    return {k: v.to(torch.bfloat16) if v.is_floating_point() else v for k, v in sd.items()}


def _encode_flat(sd: dict, dtype: str) -> dict:
    """One layer's flat native tensors re-encoded at ``dtype`` (plan dtype
    ``bf16`` is ``bfloat16``)."""
    if dtype in ("bfloat16", "bf16"):
        return _cast_flat_bf16(sd)
    return _quantize_flat(sd, dtype)


def requantize_native(src_dir: str, out_dir: str, dtype: str = "int8", plan=None) -> list[str]:
    """Re-encode a native per-layer float checkpoint directory at ``dtype``
    (``int8``, ``int4`` or ``bfloat16``) or, with ``plan`` (a
    ``runtime.precisionplan.PrecisionPlan``), at each layer's planned dtype,
    as the JAX package's ``requantize_native`` does: a plan must cover every
    layer file and nothing else (checked before the first byte is written);
    a quantized source is refused; the non-layer files are copied except the
    source's ``integrity.json``, layout marker and embedded plan, which no
    longer describe the output; the plan is embedded as
    ``precision_plan.json`` and a fresh ``integrity.json`` records every
    layer's dtype kind. Returns the layers written, in file-name order."""
    if plan is None and dtype not in ("int8", "int4", "bfloat16"):
        raise ValueError(f"requantize_native: unsupported dtype {dtype!r}")
    from flexible_llm_sharding_tpu_torch.runtime.precisionplan import PLAN_NAME

    if plan is not None:
        on_disk = {fn[: -len(LAYER_FILE_SUFFIX)] for fn in os.listdir(src_dir)
                   if fn.endswith(LAYER_FILE_SUFFIX)}
        missing, extra = on_disk - set(plan.dtypes), set(plan.dtypes) - on_disk
        if missing or extra:
            raise ValueError(
                f"precision plan and {src_dir} drifted: layers on disk with no plan entry "
                f"{sorted(missing)}; planned layers with no file {sorted(extra)}"
            )
    os.makedirs(out_dir, exist_ok=True)
    done = []
    manifest_layers: dict[str, dict] = {}
    for fn in sorted(os.listdir(src_dir)):
        src = os.path.join(src_dir, fn)
        if not fn.endswith(LAYER_FILE_SUFFIX):
            if os.path.isfile(src) and fn not in (
                    NATIVE_LAYOUT_MARKER, integrity_manifest.MANIFEST_NAME, PLAN_NAME):
                shutil.copy(src, os.path.join(out_dir, fn))
            continue
        layer_name = fn[: -len(LAYER_FILE_SUFFIX)]
        flat = read_safetensors(src)
        if not _is_native(flat):
            raise ValueError(f"{fn}: not native layout (run split_into_layers)")
        if any(k.endswith(_SCALE_SUFFIXES) for k in flat):
            raise ValueError(
                f"{fn}: source is already quantized; requantize from the original float "
                "checkpoint"
            )
        layer_dtype = dtype if plan is None else plan.dtype_for(layer_name)
        stored = _encode_flat(flat, layer_dtype)
        del flat
        write_safetensors(os.path.join(out_dir, fn), stored)
        manifest_layers[layer_name] = integrity_manifest.layer_entry(stored, fn)
        del stored
        done.append(layer_name)
    if plan is not None:
        plan.save(out_dir)
    _write_layout_marker(out_dir, "native", "mixed" if plan is not None else dtype, done)
    integrity_manifest.write_manifest(out_dir, manifest_layers)
    return done


def save_params(params: dict[str, Any], out_dir: str, cfg: LlamaConfig) -> None:
    """Write a full parameter dict ({'embed', 'layers', 'norm', 'lm_head'})
    as per-layer native files, ``integrity.json`` and ``config.json``."""
    os.makedirs(out_dir, exist_ok=True)
    manifest_layers: dict[str, dict] = {}

    def save(name: str, tree: dict[str, Any]) -> None:
        flat = dict(flatten(tree))
        write_safetensors(layer_file(out_dir, name), flat)
        manifest_layers[name] = integrity_manifest.layer_entry(flat, f"{name}{LAYER_FILE_SUFFIX}")

    save("model.embed_tokens", params["embed"])
    for i, layer in enumerate(params["layers"]):
        save(f"model.layers.{i}", layer)
    save("model.norm", params["norm"])
    if params.get("lm_head"):
        save("lm_head", params["lm_head"])
    integrity_manifest.write_manifest(out_dir, manifest_layers)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg.to_dict(), f)


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor, including bfloat16 arrays (ml_dtypes), which are
    reinterpreted from their uint16 bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(params_np: dict[str, Any], cfg: LlamaConfig, device="cpu",
                    dtype: torch.dtype | None = None) -> dict[str, Any]:
    """The JAX package's parameter pytree (numpy leaves, ``models/llama.py``
    layout) -> the port's parameter dict on ``device``, cast to ``dtype``
    when given. ``cfg`` checks the decoder-layer count."""
    if len(params_np["layers"]) != cfg.num_hidden_layers:
        raise ValueError(
            f"{len(params_np['layers'])} layers in the pytree, config says "
            f"{cfg.num_hidden_layers}"
        )

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [conv(v) for v in tree]
        t = tensor_from_numpy(np.asarray(tree)).to(device)
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t

    return conv(params_np)


__all__ = [
    "INT4_GROUP",
    "LAYER_FILE_SUFFIX",
    "NATIVE_LAYOUT_MARKER",
    "QUANT4_SCALE_SUFFIX",
    "QUANT_DTYPES",
    "QUANT_SCALE_SUFFIX",
    "SPLIT_DTYPES",
    "dequant4_math",
    "dequantize",
    "dequantize_tree",
    "is_float_like",
    "is_quantized_leaf",
    "quant_kind",
    "requantize_native",
    "simulate_quantized",
    "flatten",
    "hf_layer_to_native",
    "key_to_layer",
    "layer_file",
    "layer_file_for",
    "layer_names_for",
    "load_layer",
    "params_from_jax",
    "read_safetensors",
    "safetensors_header",
    "save_params",
    "split_into_layers",
    "tensor_from_numpy",
    "unflatten",
    "write_safetensors",
]
