"""The PyTorch port stands alone: no JAX and nothing of the JAX package in
its sources, in chip_smoke.py or in its scripts (scripts/torch_*.py, which
run on the card's machine); it runs on CUDA unless the CPU is asked
for, and never falls back silently; the CUDA wrappers refuse what their
kernels do not compute."""

import ast
import pathlib
import pickle

import pytest
import torch

import flexible_llm_sharding_tpu_torch
from flexible_llm_sharding_tpu_torch import cli
from flexible_llm_sharding_tpu_torch.config import FrameworkConfig, resolve_device
from flexible_llm_sharding_tpu_torch.ops import cuda_build
from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa

ROOT = pathlib.Path(flexible_llm_sharding_tpu_torch.__file__).resolve().parent
PORT_FILES = (sorted(ROOT.rglob("*.py")) + [ROOT.parent / "chip_smoke.py"]
              + sorted((ROOT.parent / "scripts").glob("torch_*.py")))


def _imported_modules(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            mods.add(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            mods.update(a.value for a in node.args if isinstance(a, ast.Constant))
    return mods


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT.parent)))
def test_port_imports_no_jax(path):
    assert path.exists()
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "optax", "orbax"), f"{path} imports {mod}"
        assert top != "flexible_llm_sharding_tpu", f"{path} imports {mod}"


def test_default_device_is_cuda():
    assert FrameworkConfig().device == "cuda"
    args = cli.build_parser().parse_args(["--prompt_pickle", "p", "--output_file", "o"])
    assert args.device == "cuda"


def test_default_device_run_without_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    ppkl = tmp_path / "p.pkl"
    ppkl.write_bytes(pickle.dumps([("a", ("b",))]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--model_path", str(tmp_path), "--prompt_pickle", str(ppkl),
                  "--output_file", str(tmp_path / "s.pkl")])
    assert not (tmp_path / "s.pkl").exists()


def test_training_entry_points_default_to_cuda(monkeypatch):
    from flexible_llm_sharding_tpu_torch import training
    from flexible_llm_sharding_tpu_torch.config import LlamaConfig
    from flexible_llm_sharding_tpu_torch.models import llama
    from flexible_llm_sharding_tpu_torch.training_stream import StreamedTrainer

    cfg = LlamaConfig(vocab_size=16, hidden_size=8, intermediate_size=16, num_hidden_layers=1,
                      num_attention_heads=2, num_key_value_heads=1)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamedTrainer(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        training.TrainState.create(cfg, params, training.AdamW())


@pytest.mark.parametrize("kw", [
    {"head_dim": 512}, {"head_dim": 32}, {"window": 1024, "head_dim": 80},
    {"head_dim": 160}, {"head_dim": 128, "v_dim": 64},
])
def test_cuda_argument_check_refuses_unsupported(kw):
    with pytest.raises(NotImplementedError):
        fa.check_cuda_args(**kw)


@pytest.mark.parametrize("kw,error", [
    ({"window": 64, "chunk": 64}, ValueError), ({"window": 0}, ValueError),
    ({"chunk": -8}, ValueError), ({"window": 64, "local_on": torch.tensor(True)}, TypeError),
], ids=["window-and-chunk", "window0", "chunk-negative", "local_on-tensor"])
def test_cuda_argument_check_refuses_bad_local_forms(kw, error):
    with pytest.raises(error):
        fa.check_cuda_args(**kw)


def test_cuda_argument_check_accepts_the_slice():
    for hd in (64, 96, 128, 256):
        fa.check_cuda_args(head_dim=hd, v_dim=hd)
        for local in ({"window": 1}, {"window": 1024, "local_on": False}, {"chunk": 64},
                      {"chunk": 8192, "local_on": True}, {"window": 4096, "local_on": None}):
            fa.check_cuda_args(head_dim=hd, v_dim=hd, **local)


def test_cpu_wrappers_launch_nothing():
    """CPU tensors go to the plain versions: no kernel build, no count."""
    fa.reset_launch_counts()
    q = torch.randn(1, 64, 2, 64)
    fa.flash_causal_attention(q, q, q, torch.tensor([10], dtype=torch.int32))
    assert fa.launch_counts() == dict.fromkeys(fa.KERNELS, 0)
    assert cuda_build._lib is None


def test_build_flags_target_sm90a():
    flags = " ".join(cuda_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    assert cuda_build.SOURCE.exists()


def test_offline_entry_and_scripts_are_checked():
    """The port's own prepare_weights and the card-side scripts are among
    the files held to the no-JAX rule above."""
    names = {str(p.relative_to(ROOT.parent)) for p in PORT_FILES}
    assert {"flexible_llm_sharding_tpu_torch/prepare_weights.py",
            "flexible_llm_sharding_tpu_torch/utils/checkpoint.py",
            "scripts/torch_kernel_ab.py", "chip_smoke.py"} <= names
