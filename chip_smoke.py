#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a nonzero exit if it fails:

1. device  — a CUDA device must be present; prints its name and power limit.
2. build   — builds the port's CUDA kernels from the source in this
             checkout (one nvcc).
3. kernels — every kernel against its plain PyTorch version on the card, at
             Llama-2-7B attention shapes (plus GQA, softcap and ragged-length
             cases; the scoring kernel's edge cases: odd S, query lengths
             1/64/130/576, prefix lengths 0/1/63/64/65/130/513, MQA, fp16,
             hd 64; the decode kernel's: S*g above its 16 rows per block,
             S 1, prefix lengths 0/1/63/64/65/130, eos 0 and Ls-1, t 0 and
             T-1, hd 64 fp16, float32, softcap; each with and without NaN in
             every K/V row past a source's limit); bf16 and fp16 within
             atol = rtol = 2e-2 of the plain version computed in float32
             from the same inputs, float32 within atol 1e-4. Times each
             kernel, its plain version and its library yardstick (one SDPA
             call on KV concatenated beforehand) at the shapes of the
             full-width run, and every kernel and its yardstick at a
             4096-token prefix with one prompt (device time from CUDA events
             around back-to-back calls queued behind a spin kernel, so the
             host's launch work is not in it).
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
import re
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
    lib = cuda_build.library()
    log(f"[build] {cuda_build.SOURCE.name} built and loaded in {time.perf_counter() - t0:.3f} s")
    # Registers, stack and local memory (spills) of every kernel, as built.
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        log("[build] cuobjdump not found: resource usage not read")
        return
    usage = subprocess.run([tool, "--dump-resource-usage", lib._name], capture_output=True,
                           text=True).stdout.splitlines()
    for name, res in zip(usage, usage[1:]):
        kernel = re.search(r"(score_tc_kernel|score_kernel_f32|decode_rows_kernel)I(\w+?)EEEv", name)
        if kernel:
            targs = ", ".join(a if a.isdigit() else re.sub(r"^\d+", "", a)  # drop name lengths
                              for a in kernel.group(2).split("Li") if a)
            log(f"[build] {kernel.group(1)}<{targs}>: {' '.join(res.split()[:5])}")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _inputs(case: dict, dtype, gen: torch.Generator, fill_past_limits=None):
    """Random inputs of ``case``. With ``fill_past_limits`` set, the K/V rows
    no query can see (prefix rows at or past prefix_len, suffix rows past
    eos, generated rows past t) hold that value."""
    b, s, nq, nkv, hd = case["B"], case["S"], case["nq"], case["nkv"], case["hd"]
    lp, ls, tg = case["Lp"], case["Ls"], case["T"]

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    x = {
        "q_prefix": rnd(b, lp, nq, hd), "kp": rnd(b, lp, nkv, hd), "vp": rnd(b, lp, nkv, hd),
        "q_suffix": rnd(b, s, ls, nq, hd), "ks": rnd(b, s, ls, nkv, hd),
        "vs": rnd(b, s, ls, nkv, hd), "q_dec": rnd(b, s, 1, nq, hd),
        "kg": rnd(b, s, tg, nkv, hd), "vg": rnd(b, s, tg, nkv, hd),
        "plen": torch.tensor(case["plen"], dtype=torch.int32, device="cuda"),
        "eos": torch.tensor(case["eos"], dtype=torch.int32, device="cuda"),
        "t": case["t"],
    }
    if fill_past_limits is not None:
        for name, past in _past_limits(x).items():
            x[name] = x[name].masked_fill(past[..., None, None], fill_past_limits)
    return x


def _past_limits(x: dict) -> dict[str, torch.Tensor]:
    """Per K/V tensor, the rows (bool, over its leading dims) past every
    query's limit in the decode form."""
    lp, ls, tg = x["kp"].shape[1], x["ks"].shape[2], x["kg"].shape[2]
    dev = x["kp"].device
    prefix = torch.arange(lp, device=dev)[None, :] >= x["plen"][:, None]
    suffix = torch.arange(ls, device=dev)[None, None, :] > x["eos"][..., None]
    gen = (torch.arange(tg, device=dev) > x["t"]).expand(*x["kg"].shape[:3])
    return {"kp": prefix, "vp": prefix, "ks": suffix, "vs": suffix, "kg": gen, "vg": gen}


# ---------------------------------------------------------------------------
# Library yardsticks: one SDPA call computing each kernel's function. The
# KV a query sees is concatenated here, before any timing, so the timed call
# is the attention alone. Every query row must see at least one key (SDPA
# gives NaN where the kernels write 0).
# ---------------------------------------------------------------------------

def _sdpa_args(q, k, v, mask) -> dict:
    """q [N, Lq, n_q, hd], k/v [N, Lk, n_kv, hd], mask [N, Lq, Lk] -> the
    keyword arguments of ``scaled_dot_product_attention``."""
    return {"query": q.transpose(1, 2), "key": k.transpose(1, 2), "value": v.transpose(1, 2),
            "attn_mask": mask[:, None], "enable_gqa": q.shape[2] != k.shape[2]}


def yardstick_causal(q, k, v, valid_len) -> dict:
    """flash_causal_attention: query i sees keys j <= i with j < valid_len[b]."""
    i = torch.arange(q.shape[1], device=q.device)
    mask = (i[None, :] <= i[:, None])[None] & (i[None, None, :] < valid_len[:, None, None])
    return _sdpa_args(q, k, v, mask)


def yardstick_prefix_shared(q, k_prefix, v_prefix, k_suffix, v_suffix, prefix_len) -> dict:
    """flash_prefix_shared_attention: the queries of every (b, s) over
    [prefix KV expanded over S ; own suffix KV]; prefix key j < prefix_len[b],
    own key j <= i."""
    b, s, ls = q.shape[:3]
    lp = k_prefix.shape[1]
    dev = q.device

    def cat(prefix, suffix):
        return torch.cat([prefix[:, None].expand(b, s, *prefix.shape[1:]), suffix], 2).flatten(0, 1)

    j = torch.arange(lp + ls, device=dev)[None, None, :]
    i = torch.arange(ls, device=dev)[None, :, None]
    mask = torch.where(j < lp, j < prefix_len[:, None, None], j - lp <= i)  # [B, Ls, Lp+Ls]
    mask = mask[:, None].expand(b, s, ls, lp + ls).flatten(0, 1)
    return _sdpa_args(q.flatten(0, 1), cat(k_prefix, k_suffix), cat(v_prefix, v_suffix), mask)


def yardstick_decode(q, k_prefix, v_prefix, k_suffix, v_suffix, k_gen, v_gen, prefix_len,
                     suffix_eos, t) -> dict:
    """flash_decode_attention: each suffix's new token over [prefix ; own
    suffix ; own generated] KV; prefix key j < prefix_len[b], suffix key
    j <= suffix_eos[b, s], generated key j <= t."""
    b, s = q.shape[:2]
    lp, ls, tg = k_prefix.shape[1], k_suffix.shape[2], k_gen.shape[2]
    dev = q.device

    def cat(prefix, suffix, gen):
        return torch.cat([prefix[:, None].expand(b, s, *prefix.shape[1:]), suffix, gen],
                         2).flatten(0, 1)

    mask = torch.cat([
        (torch.arange(lp, device=dev)[None, :] < prefix_len[:, None])[:, None].expand(b, s, lp),
        torch.arange(ls, device=dev)[None, None, :] <= suffix_eos[..., None],
        (torch.arange(tg, device=dev) <= t).expand(b, s, tg),
    ], -1).flatten(0, 1)[:, None]  # [B*S, 1, Lp+Ls+T]
    return _sdpa_args(q.flatten(0, 1), cat(k_prefix, k_suffix, k_gen),
                      cat(v_prefix, v_suffix, v_gen), mask)


YARDSTICKS = {
    "flash_causal_attention": yardstick_causal,
    "flash_prefix_shared_attention": yardstick_prefix_shared,
    "flash_decode_attention": yardstick_decode,
}


def run_yardstick(args: dict, like: torch.Tensor) -> torch.Tensor:
    """The SDPA call on ``args``, back in the kernel's output layout ``like``."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(**args).transpose(1, 2).reshape(like.shape)


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


def check_case(name: str, case: dict, dtype, gen, nan_past_limits: bool = False,
               kernels=None) -> dict[str, float]:
    """Every kernel (or those named in ``kernels``) against its plain version
    on the same inputs. With ``nan_past_limits`` the kernels get K/V rows
    that no query may see filled with NaN, and the plain versions the same
    rows as zeros."""
    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa

    atol, rtol = (1e-4, 0.0) if dtype == torch.float32 else (2e-2, 2e-2)
    x = _inputs(case, dtype, gen, fill_past_limits=0.0 if nan_past_limits else None)
    calls = _calls(x, case.get("softcap"))
    if nan_past_limits:
        # The scoring kernels see every suffix row, so only decode gets NaN there.
        nan = {k: x[k].masked_fill(m[..., None, None], float("nan"))
               for k, m in _past_limits(x).items()}
        scoring = {**x, "kp": nan["kp"], "vp": nan["vp"]}
        fed = {**_calls(scoring, case.get("softcap")),
               "flash_decode_attention": _calls({**x, **nan}, case.get("softcap"))[
                   "flash_decode_attention"]}
    else:
        fed = calls
    errs = {}
    for kernel, (args, kw) in calls.items():
        if kernels is not None and kernel not in kernels:
            continue
        got = getattr(fa, kernel)(*fed[kernel][0], **kw)
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
    """Kernel, plain and library times at the main path's shapes (bf16). The
    library time is one SDPA call on inputs its yardstick built beforehand."""
    import torch.nn.functional as F

    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa

    x = _inputs(case, torch.bfloat16, gen)
    bounds = _bounds(case)
    out = {}
    for kernel, (args, kw) in _calls(x, None).items():
        sdpa = YARDSTICKS[kernel](*args)
        out[kernel] = {
            "ms": _device_ms(lambda: getattr(fa, kernel)(*args, **kw)),
            "plain_ms": _device_ms(lambda: fa.PLAIN[kernel](*args, **kw)),
            "library_ms": _device_ms(lambda: F.scaled_dot_product_attention(**sdpa)),
            "bound_ms": bounds[kernel][0],
            "bound_by": bounds[kernel][1],
        }
    for kernel, rec in out.items():
        log(f"[kernels] time {kernel}: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
            f"library {rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return out


def time_long_prefix(gen) -> None:
    """Every kernel and its SDPA yardstick at a 4096-token prefix (B = 1,
    S = 4, Ls = 64, Llama-2-7B heads), where the causal pass is bound by its
    products and decode has only B * n_kv = 32 blocks for the card's SMs."""
    import torch.nn.functional as F

    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa

    case = {"B": 1, "S": 4, "Ls": 64, "Lp": 4096, "T": 1, "t": 0, "nq": 32, "nkv": 32, "hd": 128,
            "plen": [4096], "eos": [[63] * 4]}
    x = _inputs(case, torch.bfloat16, gen)
    bounds = _bounds(case)
    for kernel, (args, kw) in _calls(x, None).items():
        sdpa = YARDSTICKS[kernel](*args)
        ms = _device_ms(lambda: getattr(fa, kernel)(*args, **kw))
        lib = _device_ms(lambda: F.scaled_dot_product_attention(**sdpa))
        log(f"[kernels] time {kernel} at a 4096-token prefix: kernel {ms:.4f} ms, "
            f"library {lib:.4f} ms, bound {bounds[kernel][0]:.4f} ms ({bounds[kernel][1]})")


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
    # Edge cases of the tensor-core kernel: odd S (an idle consumer), query
    # lengths that are no multiple of its 128-row tile, prefix lengths around
    # its 64-key tiles, MQA/GQA, fp16, hd 64, softcap, and NaN in every K/V
    # row past a source's limit.
    edges = [
        ("S 1, lq 1, MQA 8/1", case(2, 1, 8, 1, 128, 1, 1, 3, [0, 1]), torch.bfloat16, False),
        ("S 3, lq 64/130, GQA 4/2, hd 64", case(2, 3, 4, 2, 64, 64, 130, 5, [63, 64]),
         torch.float16, False),
        ("S 3, lq 130/64, softcap 30", {**case(2, 3, 32, 8, 128, 130, 64, 5, [65, 130]),
                                        "softcap": 30.0}, torch.bfloat16, False),
        ("lq 576, NaN past limits", case(2, 4, 32, 8, 128, 576, 64, 7, [65, 513]),
         torch.bfloat16, True),
        ("S 3, lq 130, hd 64, NaN past limits", case(2, 3, 8, 1, 64, 130, 130, 5, [0, 127]),
         torch.float16, True),
    ]
    for name, c, dtype, nan in edges:
        check_case(name, c, dtype, gen, nan_past_limits=nan)
    # Edge cases of the decode kernel (16 query rows per block, 64-key
    # tiles): S*g above 16, so a KV head's rows span several blocks (and a
    # suffix two blocks), S 1, prefix lengths around its tiles, eos 0 and
    # Ls-1, t 0 and T-1, Lp 130, hd 64 fp16, float32 and softcap; each with
    # and without NaN in every K/V row past a source's limit.
    def dcase(s, nq, nkv, hd, tg, t, plen, eos, softcap=None):
        return {**case(2, s, nq, nkv, hd, 130, 64, tg, plen, softcap), "t": t, "eos": eos}

    decode_edges = [
        ("S 5, GQA 32/4", dcase(5, 32, 4, 128, 5, 4, [130, 65], [[0, 63, 9, 31, 62], [5, 0, 63, 1, 40]]),
         torch.bfloat16),
        ("S 3, MQA 8/1", dcase(3, 8, 1, 128, 5, 0, [64, 63], [[63, 0, 12], [5, 6, 7]]), torch.bfloat16),
        ("S 7, GQA 12/4", dcase(7, 12, 4, 128, 3, 1, [65, 130], [[i * 9 for i in range(7)]] * 2),
         torch.bfloat16),
        ("S 2, MQA 32/1", dcase(2, 32, 1, 128, 4, 3, [1, 0], [[0, 63], [63, 31]]), torch.bfloat16),
        ("S 1", dcase(1, 32, 32, 128, 5, 2, [0, 1], [[0], [63]]), torch.bfloat16),
        ("S 4, hd 64", dcase(4, 8, 2, 64, 5, 4, [0, 130], [[0, 63, 20, 33], [63, 0, 1, 2]]),
         torch.float16),
        ("S 3, GQA 8/4", dcase(3, 8, 4, 128, 5, 0, [65, 64], [[0, 63, 17], [31, 32, 0]]), torch.float32),
        ("S 4, softcap 30", dcase(4, 32, 8, 128, 5, 4, [63, 130], [[0, 63, 5, 6], [7, 8, 63, 0]], 30.0),
         torch.bfloat16),
    ]
    for name, c, dtype in decode_edges:
        for nan in (False, True):
            check_case(f"{name}{', NaN past limits' if nan else ''}", c, dtype, gen,
                       nan_past_limits=nan, kernels=("flash_decode_attention",))
    errs = check_case("main path", main_case, torch.bfloat16, gen)
    time_long_prefix(gen)
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
