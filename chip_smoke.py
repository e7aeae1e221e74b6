#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a nonzero exit if it fails:

1. device  — a CUDA device must be present; prints its name and power limit.
2. build   — builds the port's CUDA kernels from the source in this
             checkout (one nvcc).
3. kernels — every kernel against its plain PyTorch version on the card, at
             Llama-2-7B attention shapes (plus GQA, softcap and ragged-length
             cases); bf16 within atol = rtol = 2e-2 of the plain version
             computed in float32 from the same bf16 inputs, float32 within
             atol 1e-4. Times each kernel, its plain version and, where one
             PyTorch call computes the same function, that call (device
             time from CUDA events around back-to-back calls queued behind
             a spin kernel, so the host's launch work is not in it), at the
             shapes of the full-width run.
4. cross   — a reduced-width float32 checkpoint through the port's CLI on
             the card and on the CPU: scores within atol 1e-4 and identical
             greedy tokens, for the re-scoring loop and for --kv_cache.
5. full    — a seeded bf16 checkpoint at Llama-2-7B widths (4 decoder
             layers, one layer per shard, so every layer streams) through
             the CLI: scoring with --num_gen_token 4, then --kv_cache with
             --num_gen_token 8. Scores must be finite and sum to 1, and every
             kernel of each run must have launched.

Output: per-phase lines, then a JSON line of kernel records, the card's
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
TPU_SOURCE = "flexible_llm_sharding_tpu/ops/pallas_attention.py"
REPLACES = {
    "flash_causal_attention": f"{TPU_SOURCE}:249",
    "flash_prefix_shared_attention": f"{TPU_SOURCE}:372",
    "flash_decode_attention": f"{TPU_SOURCE}:560",
}
CUDA_SOURCE = "flexible_llm_sharding_tpu_torch/csrc/flash_attention.cu"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


class BenchTokenizer:
    """Deterministic word-hash tokenizer (no model assets needed): a copy of
    the repository bench's tokenizer with the vocabulary size as a field."""

    BOS, EOS = 1, 2
    eos_token = "</s>"
    pad_token = "</s>"
    pad_token_id = EOS
    padding_side = "right"

    def __init__(self, vocab: int = 32000):
        self.VOCAB = vocab

    def _one_id(self, w: str) -> int:
        if w.startswith("tok") and w[3:].isdigit():
            return int(w[3:]) % self.VOCAB
        return 3 + (zlib.crc32(w.encode()) % (self.VOCAB - 3))

    def _ids(self, text: str) -> list[int]:
        return [self.BOS] + [self._one_id(w) for w in text.split()]

    def decode(self, ids) -> str:
        if np.ndim(ids) == 0:
            ids = [int(ids)]
        return "".join(f" tok{int(i)}" for i in ids)

    def __call__(self, text, max_length=None, padding=False, **kw):
        if isinstance(text, str):
            return {"input_ids": self._ids(text)[:max_length]}
        batch = [self._ids(t)[:max_length] for t in text]
        if padding:
            width = max(len(b) for b in batch)
            batch = [b + [self.pad_token_id] * (width - len(b)) for b in batch]
        return {"input_ids": batch}


def make_prompts(n: int, prefix_words: int, n_suffix: int, suffix_words: int, seed: int):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(5000)]

    def text(k):
        return " ".join(words[j] for j in rng.integers(0, len(words), size=k))

    return [
        (text(prefix_words), tuple(" " + text(suffix_words) for _ in range(n_suffix)))
        for _ in range(n)
    ]


# ---------------------------------------------------------------------------
# Phase 1-2: device and build
# ---------------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    props = torch.cuda.get_device_properties(0)
    log(f"[device] {smi} | {props.name}, {props.total_memory / 2**30:.1f} GiB, "
        f"{props.multi_processor_count} SMs | torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


def phase_build() -> None:
    from flexible_llm_sharding_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.library()
    log(f"[build] {cuda_build.SOURCE.name} built and loaded in {time.perf_counter() - t0:.3f} s")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _inputs(case: dict, dtype, gen: torch.Generator):
    b, s, nq, nkv, hd = case["B"], case["S"], case["nq"], case["nkv"], case["hd"]
    lp, ls, tg = case["Lp"], case["Ls"], case["T"]

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    return {
        "q_prefix": rnd(b, lp, nq, hd), "kp": rnd(b, lp, nkv, hd), "vp": rnd(b, lp, nkv, hd),
        "q_suffix": rnd(b, s, ls, nq, hd), "ks": rnd(b, s, ls, nkv, hd),
        "vs": rnd(b, s, ls, nkv, hd), "q_dec": rnd(b, s, 1, nq, hd),
        "kg": rnd(b, s, tg, nkv, hd), "vg": rnd(b, s, tg, nkv, hd),
        "plen": torch.tensor(case["plen"], dtype=torch.int32, device="cuda"),
        "eos": torch.tensor(case["eos"], dtype=torch.int32, device="cuda"),
        "t": case["t"],
    }


def _calls(x: dict, softcap):
    """Per kernel: (positional args, keyword args)."""
    kw = {"softcap": softcap}
    return {
        "flash_causal_attention": ((x["q_prefix"], x["kp"], x["vp"], x["plen"]), kw),
        "flash_prefix_shared_attention": (
            (x["q_suffix"], x["kp"], x["vp"], x["ks"], x["vs"], x["plen"]), kw),
        "flash_decode_attention": (
            (x["q_dec"], x["kp"], x["vp"], x["ks"], x["vs"], x["kg"], x["vg"], x["plen"],
             x["eos"], x["t"]), kw),
    }


def _f32(args):
    return tuple(a.float() if torch.is_tensor(a) and a.is_floating_point() else a for a in args)


def check_case(name: str, case: dict, dtype, gen) -> dict[str, float]:
    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa

    atol, rtol = (1e-4, 0.0) if dtype == torch.float32 else (2e-2, 2e-2)
    x = _inputs(case, dtype, gen)
    errs = {}
    for kernel, (args, kw) in _calls(x, case.get("softcap")).items():
        got = getattr(fa, kernel)(*args, **kw)
        torch.cuda.synchronize()
        want = fa.PLAIN[kernel](*_f32(args), **kw)
        if not torch.isfinite(got).all():
            fail(f"{kernel} [{name}] produced non-finite values")
        diff = (got.float() - want).abs()
        err = diff.max().item()
        if (diff > atol + rtol * want.abs()).any():
            fail(f"{kernel} [{name}] disagrees with its plain version: max_abs_err {err:.3e}")
        errs[kernel] = err
        log(f"[kernels] {kernel} [{name}, {str(dtype)[6:]}] max_abs_err {err:.3e} "
            f"(atol {atol}, rtol {rtol})")
    return errs


def _device_ms(fn, calls: int = 20, reps: int = 20) -> float:
    """Device time of one call of ``fn``, median of ``reps`` rounds. Each
    round queues ``calls`` calls back to back behind a spin kernel and reads
    CUDA events around them, so the card runs them without waiting for the
    host and the wrappers' host work (argument checks, ctypes) stays out of
    the time. A round whose spin ended before the host had queued every call
    is repeated with a longer spin."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    times = []
    while len(times) < reps:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        if a.query():
            if cycles >= 2**31:
                fail("the host cannot queue the timed calls ahead of the card")
            torch.cuda.synchronize()
            cycles *= 2
            continue
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def _bounds(case: dict) -> dict[str, tuple[float, str]]:
    """Least time on the card for each kernel's work at this case's data:
    the larger of the bytes it must move (each needed input read once, each
    output written once, bf16) over 3.35 TB/s and its tensor FLOPs (QK^T and
    PV, 4*hd per visible query-key pair) over 989 TFLOP/s."""
    b, s, nq, nkv, hd = case["B"], case["S"], case["nq"], case["nkv"], case["hd"]
    lp, ls, t = case["Lp"], case["Ls"], case["t"]
    plen = np.asarray(case["plen"], np.int64)
    eos = np.asarray(case["eos"], np.int64)
    e = 2  # bytes per bf16 element
    kv_row = 2 * nkv * hd * e  # one key row of K and V
    i = np.arange(lp)[None, :]
    causal_pairs = np.minimum(i + 1, plen[:, None]).sum()
    j = np.arange(ls)[None, :]
    prefix_pairs = s * (plen[:, None] + j + 1).sum()
    decode_pairs = (plen[:, None] + eos + 1 + t + 1).sum()
    work = {
        "flash_causal_attention": (
            causal_pairs, 2 * b * lp * nq * hd * e + plen.sum() * kv_row),
        "flash_prefix_shared_attention": (
            prefix_pairs, 2 * b * s * ls * nq * hd * e + plen.sum() * kv_row + b * s * ls * kv_row),
        "flash_decode_attention": (
            decode_pairs,
            2 * b * s * nq * hd * e + (plen.sum() + (eos + 1).sum() + b * s * (t + 1)) * kv_row),
    }
    out = {}
    for k, (pairs, nbytes) in work.items():
        t_ops = 4 * hd * nq * float(pairs) / PEAK_BF16_FLOPS * 1e3
        t_bytes = float(nbytes) / PEAK_BYTES * 1e3
        out[k] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return out


def time_case(case: dict, gen) -> dict[str, dict]:
    """Kernel, plain and library times at the main path's shapes (bf16)."""
    import torch.nn.functional as F

    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa

    x = _inputs(case, torch.bfloat16, gen)
    bounds = _bounds(case)
    out = {}
    for kernel, (args, kw) in _calls(x, None).items():
        out[kernel] = {
            "ms": _device_ms(lambda: getattr(fa, kernel)(*args, **kw)),
            "plain_ms": _device_ms(lambda: fa.PLAIN[kernel](*args, **kw)),
            "library_ms": None,
            "bound_ms": bounds[kernel][0],
            "bound_by": bounds[kernel][1],
        }
    # One PyTorch call computes the causal kernel's function: SDPA with the
    # causal-and-valid-length mask. The other two need several calls (the
    # shared prefix KV concatenated per suffix), so they have no yardstick.
    lp = case["Lp"]
    ii = torch.arange(lp, device="cuda")
    mask = (ii[None, :] <= ii[:, None])[None] & (ii[None, None, :] < x["plen"][:, None, None])
    mask = mask[:, None]  # [B, 1, L, L]
    qt, kt, vt = (a.transpose(1, 2) for a in (x["q_prefix"], x["kp"], x["vp"]))
    gqa = case["nq"] != case["nkv"]
    out["flash_causal_attention"]["library_ms"] = _device_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=gqa)
    )
    for kernel, rec in out.items():
        log(f"[kernels] time {kernel}: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
            f"library {rec['library_ms']}, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return out


def main_path_case(prompts, n_gen_kv: int) -> dict:
    """The attention shapes and lengths the full-width run gives the kernels
    (Llama-2-7B heads; prompts tokenized as the CLI tokenizes them)."""
    from flexible_llm_sharding_tpu_torch.runtime.tokenization import PromptTokenizer

    toks = [PromptTokenizer(BenchTokenizer())(p, s) for p, s in prompts]
    keys = {t.bucket_key for t in toks}
    if len(keys) != 1:
        fail(f"full-width prompts fall into several buckets: {keys}")
    lp, s, ls = keys.pop()
    tg = max(1, n_gen_kv - 1)
    return {
        "B": len(toks), "S": s, "Ls": ls, "Lp": lp, "T": tg, "t": tg - 1,
        "nq": 32, "nkv": 32, "hd": 128,
        "plen": [t.prefix_len for t in toks], "eos": [t.suffix_eos.tolist() for t in toks],
    }


def phase_kernels(main_case: dict) -> dict[str, dict]:
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rng = np.random.default_rng(5)

    def case(b, s, nq, nkv, hd, lp, ls, tg, plen, softcap=None):
        return {"B": b, "S": s, "nq": nq, "nkv": nkv, "hd": hd, "Lp": lp, "Ls": ls, "T": tg,
                "t": tg - 2, "plen": plen, "softcap": softcap,
                "eos": rng.integers(0, ls, size=(b, s)).tolist()}

    base = case(2, 4, 32, 32, 128, 1024, 64, 16, [1000, 517])
    check_case("llama2-7b", base, torch.bfloat16, gen)
    check_case("llama2-7b", base, torch.float32, gen)
    check_case("gqa 32/8", case(2, 4, 32, 8, 128, 1024, 64, 16, [1024, 300]), torch.bfloat16, gen)
    check_case("softcap 50", {**base, "softcap": 50.0}, torch.bfloat16, gen)
    check_case("ragged 1000/50/7", case(2, 3, 32, 32, 128, 1000, 50, 7, [999, 61]),
               torch.bfloat16, gen)
    errs = check_case("main path", main_case, torch.bfloat16, gen)
    timed = time_case(main_case, gen)
    for k in timed:
        timed[k]["max_abs_err"] = errs[k]
    return timed


# ---------------------------------------------------------------------------
# Phases 4-5: the port's CLI
# ---------------------------------------------------------------------------

def _init_params(cfg, dtype, seed: int, device: str) -> dict:
    """Seeded random weights in the JAX package's layout and scales."""
    g = torch.Generator(device=device).manual_seed(seed)
    d, f, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads

    def lin(fan_in, fan_out):
        w = torch.randn(fan_in, fan_out, generator=g, device=device)
        return (w * (2.0 / (fan_in + fan_out)) ** 0.5).to(dtype).cpu()

    def ones(n):
        return torch.ones(n, dtype=dtype)

    return {
        "embed": {"embedding": (torch.randn(cfg.vocab_size, d, generator=g, device=device)
                                * 0.02).to(dtype).cpu()},
        "layers": [
            {
                "input_layernorm": {"scale": ones(d)},
                "post_attention_layernorm": {"scale": ones(d)},
                "attn": {"wq": lin(d, nq * hd), "wk": lin(d, nkv * hd),
                         "wv": lin(d, nkv * hd), "wo": lin(nq * hd, d)},
                "mlp": {"gate": lin(d, f), "up": lin(d, f), "down": lin(f, d)},
            }
            for _ in range(cfg.num_hidden_layers)
        ],
        "norm": {"scale": ones(d)},
        "lm_head": {"kernel": (torch.randn(d, cfg.vocab_size, generator=g, device=device)
                               * 0.02).to(dtype).cpu()},
    }


def run_cli(model_dir: str, work: str, tag: str, prompts, extra: list[str], vocab: int):
    from flexible_llm_sharding_tpu_torch import cli

    ppkl = os.path.join(work, f"{tag}.pkl")
    opkl = os.path.join(work, f"{tag}_scores.pkl")
    with open(ppkl, "wb") as f:
        pickle.dump(prompts, f)
    stats = cli.main(
        ["--model_path", model_dir, "--prompt_pickle", ppkl, "--output_file", opkl,
         "--disk_folder", os.path.join(work, f"{tag}_disk"), *extra],
        tokenizer=BenchTokenizer(vocab),
    )
    with open(opkl, "rb") as f:
        scores = pickle.load(f)
    with open(os.path.join(work, f"{tag}_updated.pkl"), "rb") as f:
        updated = pickle.load(f)
    return scores, updated, stats


def phase_cross(work: str) -> None:
    from flexible_llm_sharding_tpu_torch.config import LlamaConfig
    from flexible_llm_sharding_tpu_torch.utils.checkpoint import save_params

    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      explicit_head_dim=128)
    model_dir = os.path.join(work, "cross_model")
    save_params(_init_params(cfg, torch.float32, 11, "cpu"), model_dir, cfg)
    prompts = make_prompts(5, 70, 3, 6, seed=2) + make_prompts(2, 150, 2, 9, seed=3)
    for mode, extra in (("loop", []), ("kv_cache", ["--kv_cache", "true"])):
        args = ["--dtype", "float32", "--num_gen_token", "3", "--block_size", "4", *extra]
        gpu, gpu_up, _ = run_cli(model_dir, work, f"cross_gpu_{mode}", prompts,
                                 [*args, "--device", "cuda"], 512)
        cpu, cpu_up, _ = run_cli(model_dir, work, f"cross_cpu_{mode}", prompts,
                                 [*args, "--device", "cpu"], 512)
        err = max(float(np.abs(g - c).max()) for g, c in zip(gpu, cpu))
        if not all(np.allclose(g, c, atol=1e-4, rtol=0) for g, c in zip(gpu, cpu)):
            fail(f"cross-check {mode}: card and CPU scores differ by {err:.3e}")
        if any((g.argmax(-1) != c.argmax(-1)).any() for g, c in zip(gpu, cpu)) or gpu_up != cpu_up:
            fail(f"cross-check {mode}: greedy tokens differ between card and CPU")
        log(f"[cross] float32 {mode}: card vs CPU max_abs_err {err:.3e}, greedy tokens identical")


def _check_scores(scores, prompts, n_gen: int, tag: str) -> None:
    for s, (_, sfx) in zip(scores, prompts):
        if s.shape != (len(sfx), n_gen, 32000):
            fail(f"{tag}: scores of shape {s.shape}")
        if not np.isfinite(s).all():
            fail(f"{tag}: non-finite scores")
        if not np.allclose(s.sum(-1), 1.0, atol=1e-3):
            fail(f"{tag}: distributions do not sum to 1")


def phase_full(work: str, prompts, n_gen_loop: int, n_gen_kv: int) -> dict[str, int]:
    from flexible_llm_sharding_tpu_torch.config import LlamaConfig
    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa
    from flexible_llm_sharding_tpu_torch.utils.checkpoint import save_params

    cfg = LlamaConfig(num_hidden_layers=4)  # Llama-2-7B widths, depth cut to 4
    model_dir = os.path.join(work, "llama2_7b_4layers")
    t0 = time.perf_counter()
    save_params(_init_params(cfg, torch.bfloat16, 0, "cuda"), model_dir, cfg)
    log(f"[full] wrote a seeded bf16 Llama-2-7B-width checkpoint with {cfg.num_hidden_layers} "
        f"decoder layers in {time.perf_counter() - t0:.3f} s")
    common = ["--dtype", "bfloat16", "--layer_num_per_shard", "1", "--device", "cuda"]
    launches = dict.fromkeys(fa.KERNELS, 0)
    runs = (
        ("scoring", ["--num_gen_token", str(n_gen_loop)], n_gen_loop,
         ("flash_causal_attention", "flash_prefix_shared_attention")),
        ("kv_cache", ["--num_gen_token", str(n_gen_kv), "--kv_cache", "true"], n_gen_kv,
         fa.KERNELS),
    )
    for tag, extra, n_gen, needed in runs:
        fa.reset_launch_counts()
        scores, _, stats = run_cli(model_dir, work, f"full_{tag}", prompts, [*common, *extra],
                                   32000)
        counts = fa.launch_counts()
        _check_scores(scores, prompts, n_gen, tag)
        missing = [k for k in needed if counts[k] == 0]
        if missing:
            fail(f"full {tag}: kernels never launched on the main path: {missing}")
        for k in counts:
            launches[k] += counts[k]
        keys = ("wall_s", "tokens_processed", "tokens_per_sec", "streamed_bytes", "peak_mem_gb",
                "source_wait_s", "load_weights_time_s", "compute_wall_s")
        log(f"[full] {tag} stats " + json.dumps({k: stats.get(k) for k in keys}))
        log(f"[full] {tag} kernels " + json.dumps(counts))
    return launches


def main() -> None:
    smi = phase_device()
    phase_build()
    prompts = make_prompts(8, 512, 4, 32, seed=0)
    n_gen_loop, n_gen_kv = 4, 8
    timed = phase_kernels(main_path_case(prompts, n_gen_kv))
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        phase_cross(work)
        launches = phase_full(work, prompts, n_gen_loop, n_gen_kv)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    kernels = [
        {
            "name": k,
            "route": "cuda",
            "source": CUDA_SOURCE,
            "replaces": REPLACES[k],
            "launches": launches[k],
            **{key: timed[k][key] for key in
               ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        }
        for k in REPLACES
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
