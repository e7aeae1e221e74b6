#!/usr/bin/env python3
"""Time variants of the port's kernels side by side on one NVIDIA GPU.

    python3 scripts/torch_decode_variants.py

Each variant is ``csrc/flash_attention.cu`` with a few source substitutions
(each must match exactly once), built by ``nvcc`` with the port's flags into
``build/torch_kernels/variants/`` (all builds started together). For each
variant in turn the wrapper's library is swapped, the kernels it names are
held against their plain versions (bf16, atol = rtol = 2e-2; diagnostic
variants that skip the loads or the products are not checked), and their
device times are read as ``chip_smoke.py`` reads them: at the Llama-2-7B
full-width run's shapes and at a 4096-token prefix with one prompt. The
variants are printed in the order given, base first and last, so drift
within the call shows.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from flexible_llm_sharding_tpu_torch.ops import cuda_build  # noqa: E402
from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa  # noqa: E402

DECODE = ("flash_decode_attention",)
ALL = ("flash_causal_attention", "flash_prefix_shared_attention", "flash_decode_attention")
STAGES = "static constexpr int kStages = sizeof(T) == 4 ? (HD > 128 ? 1 : 2) : 3;"
LOCAL = "p.window > 0 || p.chunk > 0"

# name -> (substitutions, checked against the plain version, kernels timed)
VARIANTS = {
    "base": ([], True, ALL),
    "stages 2": ([(STAGES, STAGES.replace(": 3;", ": 2;"))], True, DECODE),
    # Diagnostics of the bf16 path: the ring, softmax and barriers without
    # the products; the products without the copies (the stages hold
    # whatever they held).
    "no products": ([("const bool keys = warp * 16 < nk;", "const bool keys = false;")], False, DECODE),
    "no loads": ([("    cp_async16(stage + which * L::kTileBytes + swizzled(r, ch, L::kRowBytes), src, r < avail && data ? 16 : 0);",
                   "    (void)src;")], False, DECODE),
    # What the local bound's code costs where no window is set: the kernels
    # built with it (kLocal) launched at window 0, as for a local layer.
    "local path at window 0": ([(f"if ({LOCAL}) {k}<T, HD, true>", f"if (true) {k}<T, HD, true>")
                                for k in ("score_tc_kernel", "decode_rows_kernel")], True, ALL),
}


def build(names: list[str]) -> dict[str, str]:
    out_dir = cuda_build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = cuda_build.SOURCE.read_text()
    procs = {}
    for name in names:
        text = source
        for old, new in VARIANTS[name][0]:
            if text.count(old) != 1:
                chip_smoke.fail(f"variant {name!r}: {old.strip()!r} matches {text.count(old)} times")
            text = text.replace(old, new)
        stem = out_dir / name.replace(" ", "_")
        stem.with_suffix(".cu").write_text(text)
        procs[name] = (str(stem.with_suffix(".so")), subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(stem.with_suffix(".so")),
             str(stem.with_suffix(".cu"))], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    paths = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            chip_smoke.fail(f"variant {name!r} did not build:\n{log}")
        paths[name] = path
    return paths


def load(path: str) -> None:
    lib = ctypes.CDLL(path)
    for fn, argtypes in cuda_build._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    cuda_build._lib = lib


def main() -> None:
    chip_smoke.phase_device()
    names = list(VARIANTS)
    paths = build(names)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    main_case = chip_smoke.main_path_case(chip_smoke.make_prompts(8, 512, 4, 32, seed=0), 8)
    long_case = {"B": 1, "S": 4, "Ls": 64, "Lp": 4096, "T": 1, "t": 0, "nq": 32, "nkv": 32,
                 "hd": 128, "plen": [4096], "eos": [[63] * 4]}
    cases = {"main": main_case, "4096 prefix, B 1": long_case}
    inputs = {k: chip_smoke._inputs(c, torch.bfloat16, gen) for k, c in cases.items()}
    bounds = {k: chip_smoke._bounds(c) for k, c in cases.items()}
    for name in [*names, "base"]:
        load(paths[name])
        _, checked, kernels = VARIANTS[name]
        for kernel in kernels:
            times = {}
            for k, x in inputs.items():
                call, kw = chip_smoke._calls(x, None)[kernel]
                fn = getattr(fa, kernel)
                if checked:
                    got = fn(*call, **kw).float()
                    want = fa.PLAIN[kernel](*chip_smoke._f32(call), **kw)
                    if not ((got - want).abs() <= 2e-2 + 2e-2 * want.abs()).all():
                        chip_smoke.fail(f"variant {name!r} disagrees with the plain version ({kernel}, {k})")
                times[k] = chip_smoke._device_ms(lambda: fn(*call, **kw))
            chip_smoke.log(f"[variant] {name}, {kernel}: " + ", ".join(
                f"{k} {ms:.4f} ms ({ms / bounds[k][kernel][0]:.2f}x bound)" for k, ms in times.items()))


if __name__ == "__main__":
    main()
