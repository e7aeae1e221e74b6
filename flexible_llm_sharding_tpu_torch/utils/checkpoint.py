"""Per-layer native checkpoints: a safetensors reader and writer of the
port's own, layer loading, saving, and conversion from the JAX package's
parameter pytree.

The on-disk layout is the JAX package's (``utils/checkpoint.py``): one
``<layer name>.safetensors`` file per execution-list entry
(``model.embed_tokens``, ``model.layers.{i}``, ``model.norm``, ``lm_head``),
dotted keys of the nested parameter dict inside (``attn.wq``,
``input_layernorm.scale``, ...), linear kernels stored [in, out], and a
``config.json``. A safetensors file is an 8-byte little-endian header
length, a JSON header ``{key: {"dtype", "shape", "data_offsets"}}``, then
the raw tensor bytes. BF16 payloads are read as uint16 and reinterpreted
with ``.view(torch.bfloat16)``, so neither ``safetensors`` nor
``ml_dtypes`` is needed. Float layers only: quantized leaves and integrity
manifests are not read by this slice.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterator

import numpy as np
import torch

from flexible_llm_sharding_tpu_torch.config import LlamaConfig

LAYER_FILE_SUFFIX = ".safetensors"

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


def read_safetensors(path: str, pin_memory: bool = False) -> dict[str, torch.Tensor]:
    """Read a whole safetensors file into one host buffer (page-locked with
    ``pin_memory``, so uploads can run asynchronously) and return CPU tensor
    views into it, one per key."""
    header, base = safetensors_header(path)
    size = os.path.getsize(path) - base
    buf = torch.empty(size, dtype=torch.uint8, pin_memory=pin_memory)
    with open(path, "rb") as f:
        f.seek(base)
        view = memoryview(buf.numpy())
        got = 0
        while got < size:
            n = f.readinto(view[got:])
            if not n:
                raise ValueError(f"{path}: truncated payload ({got} of {size} bytes)")
            got += n
    out = {}
    for key, meta in header.items():
        if meta["dtype"] not in _ST_TO_TORCH:
            raise ValueError(f"{path}: {key} has unsupported dtype {meta['dtype']}")
        dt = _ST_TO_TORCH[meta["dtype"]]
        b, e = meta["data_offsets"]
        shape = meta["shape"]
        itemsize = torch.empty((), dtype=dt).element_size()
        if e - b != int(np.prod(shape, dtype=np.int64)) * itemsize or e > size or b < 0:
            raise ValueError(f"{path}: {key} has inconsistent data_offsets")
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


def load_layer(model_path: str, layer_name: str, pin_memory: bool = False) -> dict[str, Any]:
    """One native-layout layer file -> nested dict of CPU tensors, bit-exact
    with the stored values."""
    return unflatten(read_safetensors(layer_file(model_path, layer_name), pin_memory))


def save_params(params: dict[str, Any], out_dir: str, cfg: LlamaConfig) -> None:
    """Write a full parameter dict ({'embed', 'layers', 'norm', 'lm_head'})
    as per-layer native files plus ``config.json``."""
    os.makedirs(out_dir, exist_ok=True)

    def save(name: str, tree: dict[str, Any]) -> None:
        write_safetensors(layer_file(out_dir, name), dict(flatten(tree)))

    save("model.embed_tokens", params["embed"])
    for i, layer in enumerate(params["layers"]):
        save(f"model.layers.{i}", layer)
    save("model.norm", params["norm"])
    if params.get("lm_head"):
        save("lm_head", params["lm_head"])
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
    "LAYER_FILE_SUFFIX",
    "flatten",
    "layer_file",
    "layer_names_for",
    "load_layer",
    "params_from_jax",
    "read_safetensors",
    "safetensors_header",
    "save_params",
    "tensor_from_numpy",
    "unflatten",
    "write_safetensors",
]
