#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a nonzero exit if it fails:

1. device  — a CUDA device must be present; prints its name and power limit.
2. build   — builds the port's CUDA kernels from the source in this
             checkout (one nvcc); prints each instantiation's registers,
             stack, local memory and dynamic shared memory, and fails on
             ptxas warning C7518, on local memory (spills) and on shared
             memory above the 232,448 B a block may have.
3. kernels — every kernel against its plain PyTorch version on the card, at
             Llama-2-7B attention shapes (plus GQA, softcap and ragged-length
             cases; the scoring kernel's edge cases: odd S, query lengths
             1/64/130/576, prefix lengths 0/1/63/64/65/130/513, MQA, fp16,
             hd 64; the decode kernel's: S*g above its 16 rows per block,
             S 1, prefix lengths 0/1/63/64/65/130, eos 0 and Ls-1, t 0 and
             T-1, hd 64 fp16, float32, softcap; each with and without NaN in
             every K/V row past a source's limit; head dims 256 and 96 in
             every dtype, with and without NaN past the limits, with
             windows, chunks, the toggle off and softcap; the scoring
             kernels at multi-head latent attention's qk 192 / v 128 in
             every dtype, ± NaN, every local form, softcap and the hd-128
             edge lengths); bf16 and fp16 within
             atol = rtol = 2e-2 of the plain version computed in float32
             from the same inputs, float32 within atol 1e-4. Times each
             kernel, its plain version and its library yardstick (one SDPA
             call on KV concatenated beforehand) at the shapes of the
             full-width runs (Llama-2-7B; Gemma-3-27B and Gemma-3-12B local
             and global layers; Phi-3-mini heads, hd 96, at the Llama
             prompts; DeepSeek-V3's 128 MLA heads, the scoring kernels),
             and every kernel and its yardstick at a
             4096-token prefix with one prompt (device time from CUDA events
             around back-to-back calls queued behind a spin kernel, so the
             host's launch work is not in it).
4. cross   — reduced-width float32 checkpoints (llama, gemma 3 and gemma 1
             at hd 256, phi3 at hd 96, qwen2, qwen3, mistral; windows that
             bind; llama3, yarn and longrope rope scalings; mixtral,
             qwen3_moe and deepseek_v3 with its MLA heads) through the
             port's CLI on the card and on the CPU: scores within atol 1e-4
             and identical greedy tokens, for the re-scoring loop and for
             --kv_cache.
5. full    — seeded bf16 checkpoints at full width through the CLI, one
             layer per shard so every layer streams: Llama-2-7B (4 decoder
             layers; scoring with --num_gen_token 4, then --kv_cache with
             8), Gemma-3-27B (6 layers, 5 local and 1 global), and
             Gemma-3-12B (hd 256, 6 layers), which is written as a
             Hugging Face bundle shaped as google/gemma-3-12b-pt ships it
             (the gemma3 wrapper config, language-model keys at [out, in],
             a vision tower, three shards and an index) and split by the
             port's prepare_weights first; then DeepSeek-V3 (4 layers: 0-2
             dense, 3 with its 256 experts; 30.2 GB written one layer file
             at a time), scoring with --num_gen_token 2, then --kv_cache.
             Scores must be finite and sum to 1, and every kernel of each
             run must have launched (with a window: with it on and with it
             off); under MLA the scoring kernels at (192, 128) only and the
             decode kernel never (MLA decode runs the plain op, as in the
             JAX package).

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
import resource
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
HEAD_DIMS = (64, 96, 128, 256)
MLA_DIMS = ((192, 128),)  # (Q/K head dim, V head dim) of multi-head latent attention
SMEM_LIMIT = 232448  # opt-in dynamic shared memory per block on the H100


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
    warnings = [ln for ln in cuda_build.build_log.splitlines() if "warning" in ln.lower()]
    log(f"[build] compiler warnings: {len(warnings)}")
    for ln in warnings:
        log(f"[build]   {ln}")
    if any("C7518" in ln for ln in warnings):
        fail("ptxas serialised wgmma (warning C7518)")
    if any("spill" in ln.lower() for ln in warnings):
        fail("ptxas spilled registers to local memory (built with -warn-spills)")
    # Dynamic shared memory of every instantiation, against the opt-in limit.
    names = {(0, 0): "score_kernel_f32", (0, 1): "score_tc_kernel fp16", (0, 2): "score_tc_kernel bf16",
             (1, 0): "decode_rows_kernel f32", (1, 1): "decode_rows_kernel fp16",
             (1, 2): "decode_rows_kernel bf16"}
    for (kind, dtype), name in names.items():
        sizes = {f"{hd}": lib.fls_dynamic_smem(kind, dtype, hd, hd) for hd in HEAD_DIMS}
        if kind == 0:  # the scoring kernels also take MLA's (192, 128)
            sizes.update({f"{hd}/{hd_v}": lib.fls_dynamic_smem(kind, dtype, hd, hd_v)
                          for hd, hd_v in MLA_DIMS})
        log(f"[build] {name} dynamic shared memory (B) by head dim: {sizes}")
        if max(sizes.values()) > SMEM_LIMIT or min(sizes.values()) <= 0:
            fail(f"{name}: shared memory outside (0, {SMEM_LIMIT}] B: {sizes}")
    # Registers, stack and local memory (spills) of every kernel, as built.
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        log("[build] cuobjdump not found: resource usage not read")
        return
    usage = subprocess.run([tool, "--dump-resource-usage", lib._name], capture_output=True,
                           text=True).stdout.splitlines()
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    for name, res in zip(usage, usage[1:]):
        mangled = re.search(r"_Z\w*(score_tc_kernel|score_kernel_f32|decode_rows_kernel)\w*", name)
        if mangled:
            kernel = mangled.group(0)
            if os.path.exists(filt):  # e.g. void <unnamed>::score_tc_kernel<__half, 64, (bool)1>(...)
                kernel = subprocess.run([filt, kernel], capture_output=True, text=True).stdout.strip()
                kernel = re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::", "", kernel).split(">(")[0] + ">"
                kernel = kernel.replace("(bool)1", "local").replace("(bool)0", "no local")
            log(f"[build] {kernel}: {' '.join(res.split()[:5])}")
            spill = re.search(r"LOCAL:(\d+)", res)
            if spill and int(spill.group(1)) > 0:
                fail(f"{kernel} spills to local memory: {res.strip()}")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _inputs(case: dict, dtype, gen: torch.Generator, fill_past_limits=None):
    """Random inputs of ``case``. With ``fill_past_limits`` set, the K/V rows
    no query can see (prefix rows at or past prefix_len, suffix rows past
    eos, generated rows past t) hold that value."""
    b, s, nq, nkv, hd = case["B"], case["S"], case["nq"], case["nkv"], case["hd"]
    hd_v = case.get("hd_v", hd)  # V's head dim (MLA: 128 beside hd 192)
    lp, ls, tg = case["Lp"], case["Ls"], case["T"]

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    x = {
        "q_prefix": rnd(b, lp, nq, hd), "kp": rnd(b, lp, nkv, hd), "vp": rnd(b, lp, nkv, hd_v),
        "q_suffix": rnd(b, s, ls, nq, hd), "ks": rnd(b, s, ls, nkv, hd),
        "vs": rnd(b, s, ls, nkv, hd_v), "q_dec": rnd(b, s, 1, nq, hd),
        "kg": rnd(b, s, tg, nkv, hd), "vg": rnd(b, s, tg, nkv, hd_v),
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

def _local_keep(q_pos, k_pos, window=None, chunk=None, local_on=None):
    """The local clause as a bool mask (True = visible), broadcasting the
    absolute query and key positions; all True when no local form is on."""
    if local_on is False or (window is None and chunk is None):
        return torch.ones((), dtype=torch.bool, device=q_pos.device)
    if window is not None:
        return q_pos - k_pos < window
    return torch.div(q_pos, chunk, rounding_mode="floor") == torch.div(k_pos, chunk, rounding_mode="floor")


def _sdpa_args(q, k, v, mask) -> dict:
    """q [N, Lq, n_q, hd], k/v [N, Lk, n_kv, hd], mask [N, Lq, Lk] -> the
    keyword arguments of ``scaled_dot_product_attention``."""
    return {"query": q.transpose(1, 2), "key": k.transpose(1, 2), "value": v.transpose(1, 2),
            "attn_mask": mask[:, None], "enable_gqa": q.shape[2] != k.shape[2]}


def yardstick_causal(q, k, v, valid_len, **local) -> dict:
    """flash_causal_attention: query i sees keys j <= i with j < valid_len[b]
    (and within the local form, if any)."""
    i = torch.arange(q.shape[1], device=q.device)
    mask = (i[None, :] <= i[:, None])[None] & (i[None, None, :] < valid_len[:, None, None])
    mask = mask & _local_keep(i[:, None], i[None, :], **local)
    return _sdpa_args(q, k, v, mask)


def yardstick_prefix_shared(q, k_prefix, v_prefix, k_suffix, v_suffix, prefix_len, **local) -> dict:
    """flash_prefix_shared_attention: the queries of every (b, s) over
    [prefix KV expanded over S ; own suffix KV]; prefix key j < prefix_len[b],
    own key j <= i (query i and own key j at prefix_len[b] + i / + j)."""
    b, s, ls = q.shape[:3]
    lp = k_prefix.shape[1]
    dev = q.device

    def cat(prefix, suffix):
        return torch.cat([prefix[:, None].expand(b, s, *prefix.shape[1:]), suffix], 2).flatten(0, 1)

    j = torch.arange(lp + ls, device=dev)[None, None, :]
    i = torch.arange(ls, device=dev)[None, :, None]
    mask = torch.where(j < lp, j < prefix_len[:, None, None], j - lp <= i)  # [B, Ls, Lp+Ls]
    plen = prefix_len[:, None, None]
    mask = mask & _local_keep(plen + i, torch.where(j < lp, j, plen + j - lp), **local)
    mask = mask[:, None].expand(b, s, ls, lp + ls).flatten(0, 1)
    return _sdpa_args(q.flatten(0, 1), cat(k_prefix, k_suffix), cat(v_prefix, v_suffix), mask)


def yardstick_decode(q, k_prefix, v_prefix, k_suffix, v_suffix, k_gen, v_gen, prefix_len,
                     suffix_eos, t, **local) -> dict:
    """flash_decode_attention: each suffix's new token over [prefix ; own
    suffix ; own generated] KV; prefix key j < prefix_len[b], suffix key
    j <= suffix_eos[b, s], generated key j <= t (positions: prefix key j at
    j, suffix key at prefix_len + j, generated key at prefix_len + eos + 1 +
    j, the query at prefix_len + eos + 1 + t)."""
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
    ], -1)  # [B, S, Lp+Ls+T]
    plen, eos = prefix_len[:, None, None], suffix_eos[..., None]
    k_pos = torch.cat([torch.arange(lp, device=dev).expand(b, s, lp),
                       (plen + torch.arange(ls, device=dev)).expand(b, s, ls),
                       plen + eos + 1 + torch.arange(tg, device=dev)], -1)
    mask = (mask & _local_keep(plen + eos + 1 + t, k_pos, **local)).flatten(0, 1)[:, None]
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


def _calls(x: dict, softcap, local=None):
    """Per kernel: (positional args, keyword args); ``local``: the window,
    chunk and local_on keywords, if any. With a V head dim of its own (MLA)
    only the scoring kernels: the decode kernel never takes MLA."""
    kw = {"softcap": softcap, **(local or {})}
    calls = {
        "flash_causal_attention": ((x["q_prefix"], x["kp"], x["vp"], x["plen"]), kw),
        "flash_prefix_shared_attention": (
            (x["q_suffix"], x["kp"], x["vp"], x["ks"], x["vs"], x["plen"]), kw),
        "flash_decode_attention": (
            (x["q_dec"], x["kp"], x["vp"], x["ks"], x["vs"], x["kg"], x["vg"], x["plen"],
             x["eos"], x["t"]), kw),
    }
    if x["vp"].shape[-1] != x["kp"].shape[-1]:
        del calls["flash_decode_attention"]
    return calls


def run_plain(kernel: str, args, kw, head_chunk: int | None = None):
    """The kernel's plain version on ``args``; with ``head_chunk`` over that
    many heads at a time (query and KV heads alike: MLA's GQA ratio is 1),
    where the scores of all heads at once would not fit on the card."""
    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa

    fn = fa.PLAIN[kernel]
    if not head_chunk:
        return fn(*args, **kw)
    n = args[0].shape[-2]
    return torch.cat([
        fn(*(a[..., h:h + head_chunk, :] if torch.is_tensor(a) and a.is_floating_point() else a
             for a in args), **kw)
        for h in range(0, n, head_chunk)], dim=-2)


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
    softcap, local = case.get("softcap"), case.get("local")
    calls = _calls(x, softcap, local)
    if nan_past_limits:
        # The scoring kernels see every suffix row, so only decode gets NaN there.
        nan = {k: x[k].masked_fill(m[..., None, None], float("nan"))
               for k, m in _past_limits(x).items()}
        scoring = {**x, "kp": nan["kp"], "vp": nan["vp"]}
        fed = {**_calls(scoring, softcap, local),
               **{k: c for k, c in _calls({**x, **nan}, softcap, local).items()
                  if k == "flash_decode_attention"}}
    else:
        fed = calls
    errs = {}
    for kernel, (args, kw) in calls.items():
        if kernels is not None and kernel not in kernels:
            continue
        got = getattr(fa, kernel)(*fed[kernel][0], **kw)
        torch.cuda.synchronize()
        want = run_plain(kernel, _f32(args), kw, case.get("plain_head_chunk"))
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


def _lo(q_pos: np.ndarray, local) -> np.ndarray:
    """The first absolute key position each query may see (0 without a
    local form): the kernels' one lower bound."""
    local = local or {}
    if local.get("local_on") is False:
        return np.zeros_like(q_pos)
    if local.get("window") is not None:
        return q_pos - local["window"] + 1
    if local.get("chunk") is not None:
        return q_pos // local["chunk"] * local["chunk"]
    return np.zeros_like(q_pos)


def _work(case: dict) -> dict[str, tuple[int, int]]:
    """Per kernel, at this case's data: (visible query-key pairs per query
    head, key rows it must read), each key row counted once where the
    kernel's inputs hold it once (the prefix once per prompt)."""
    s, lp, ls, t = case["S"], case["Lp"], case["Ls"], case["t"]
    local = case.get("local")
    out = dict.fromkeys(("flash_causal_attention", "flash_prefix_shared_attention",
                         "flash_decode_attention"), (0, 0))

    def add(kernel, pairs, keys):
        out[kernel] = (out[kernel][0] + int(pairs), out[kernel][1] + int(keys))

    for b, plen in enumerate(case["plen"]):
        i = np.arange(lp)[:, None]
        j = np.arange(lp)[None, :]
        vis = (j <= i) & (j < plen) & (j >= _lo(i, local))
        add("flash_causal_attention", vis.sum(), vis.any(0).sum())
        i = np.arange(ls)[:, None]
        lo = _lo(plen + i, local)
        vp = (j < plen) & (j >= lo)  # prefix keys, shared by the S suffixes
        vs = (np.arange(ls)[None, :] <= i) & (plen + np.arange(ls)[None, :] >= lo)
        add("flash_prefix_shared_attention", s * (vp.sum() + vs.sum()), vp.any(0).sum() + s * vs.any(0).sum())
        eos = np.asarray(case["eos"][b])[:, None]
        lo = _lo(plen + eos + 1 + t, local)  # [S, 1]
        vp = (np.arange(lp)[None, :] < plen) & (np.arange(lp)[None, :] >= lo)
        vs = (np.arange(ls)[None, :] <= eos) & (plen + np.arange(ls)[None, :] >= lo)
        g = np.arange(case["T"])[None, :]
        vg = (g <= t) & (plen + eos + 1 + g >= lo)
        add("flash_decode_attention", vp.sum() + vs.sum() + vg.sum(),
            vp.any(0).sum() + vs.sum() + vg.sum())
    return out


def _bounds(case: dict) -> dict[str, tuple[float, str]]:
    """Least time on the card for each kernel's work at this case's data:
    the larger of the bytes it must move (Q read and O written once, each
    key row it must read once, K and V, bf16) over 3.35 TB/s and its tensor
    FLOPs (QK^T over hd and PV over V's head dim hd_v: 2*(hd + hd_v) per
    visible query-key pair and query head) over 989 TFLOP/s. With a local
    form only the pairs within it count, and only the key rows some query
    sees within it."""
    b, s, nq, nkv, hd = case["B"], case["S"], case["nq"], case["nkv"], case["hd"]
    hd_v = case.get("hd_v", hd)
    e = 2  # bytes per bf16 element
    kv_row = nkv * (hd + hd_v) * e  # one key row of K and V
    q_rows = {"flash_causal_attention": b * case["Lp"],
              "flash_prefix_shared_attention": b * s * case["Ls"], "flash_decode_attention": b * s}
    out = {}
    for k, (pairs, keys) in _work(case).items():
        t_ops = 2 * (hd + hd_v) * nq * float(pairs) / PEAK_BF16_FLOPS * 1e3
        t_bytes = float(q_rows[k] * nq * (hd + hd_v) * e + keys * kv_row) / PEAK_BYTES * 1e3
        out[k] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return out


def time_case(case: dict, gen, plain_calls: int = 20) -> dict[str, dict]:
    """Kernel, plain and library times at the case's shapes and local form
    (bf16). The library time is one SDPA call on inputs its yardstick built
    beforehand; ``plain_calls`` calls per round time the plain version."""
    import torch.nn.functional as F

    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa

    x = _inputs(case, torch.bfloat16, gen)
    bounds = _bounds(case)
    local = case.get("local") or {}
    out = {}
    chunk = case.get("plain_head_chunk")
    for kernel, (args, kw) in _calls(x, None, local).items():
        sdpa = YARDSTICKS[kernel](*args, **local)
        out[kernel] = {
            "ms": _device_ms(lambda: getattr(fa, kernel)(*args, **kw)),
            "plain_ms": _device_ms(lambda: run_plain(kernel, args, kw, chunk), calls=plain_calls),
            "library_ms": _device_ms(lambda: F.scaled_dot_product_attention(**sdpa)),
            "bound_ms": bounds[kernel][0],
            "bound_by": bounds[kernel][1],
        }
    tag = f" [{case['name']}]" if "name" in case else ""
    for kernel, rec in out.items():
        log(f"[kernels] time {kernel}{tag}: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
            f"library {rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return out


def time_long_prefix(gen) -> None:
    """Every kernel and its SDPA yardstick at a 4096-token prefix (B = 1,
    S = 4, Ls = 64, Llama-2-7B heads), where the causal pass is bound by its
    products and decode has only B * n_kv = 32 blocks for the card's SMs;
    then decode alone with a 1024-token window."""
    import torch.nn.functional as F

    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa

    case = {"B": 1, "S": 4, "Ls": 64, "Lp": 4096, "T": 1, "t": 0, "nq": 32, "nkv": 32, "hd": 128,
            "plen": [4096], "eos": [[63] * 4]}
    x = _inputs(case, torch.bfloat16, gen)
    for local in ({}, {"window": 1024}):
        bounds = _bounds({**case, "local": local})
        for kernel, (args, kw) in _calls(x, None, local).items():
            if local and kernel != "flash_decode_attention":
                continue
            sdpa = YARDSTICKS[kernel](*args, **local)
            ms = _device_ms(lambda: getattr(fa, kernel)(*args, **kw))
            lib = _device_ms(lambda: F.scaled_dot_product_attention(**sdpa))
            tag = " with a 1024-token window" if local else ""
            log(f"[kernels] time {kernel} at a 4096-token prefix{tag}: kernel {ms:.4f} ms, "
                f"library {lib:.4f} ms, bound {bounds[kernel][0]:.4f} ms ({bounds[kernel][1]})")


def main_path_case(prompts, n_gen_kv: int, nq: int = 32, nkv: int = 32, hd: int = 128,
                   hd_v: int | None = None) -> dict:
    """The attention shapes and lengths a full-width run gives the kernels
    (Llama-2-7B heads unless given, V's head dim hd unless given; prompts
    tokenized as the CLI tokenizes them)."""
    from flexible_llm_sharding_tpu_torch.runtime.tokenization import PromptTokenizer

    toks = [PromptTokenizer(BenchTokenizer())(p, s) for p, s in prompts]
    keys = {t.bucket_key for t in toks}
    if len(keys) != 1:
        fail(f"full-width prompts fall into several buckets: {keys}")
    lp, s, ls = keys.pop()
    tg = max(1, n_gen_kv - 1)
    return {
        "B": len(toks), "S": s, "Ls": ls, "Lp": lp, "T": tg, "t": tg - 1,
        "nq": nq, "nkv": nkv, "hd": hd, "hd_v": hd if hd_v is None else hd_v,
        "plen": [t.prefix_len for t in toks], "eos": [t.suffix_eos.tolist() for t in toks],
    }


def check_mla_cases(case, gen) -> None:
    """The scoring kernels at MLA's (qk 192, v 128), against their plain
    versions: 16 and 8 heads (GQA 1, as the model runs them), softcap, every
    local form, in every dtype, with and without NaN past the limits; then
    the hd-128 edge lengths (S 1 / lq 1, odd S, lq 64/130/576, prefix lengths
    around the 64-key tiles) with GQA as well."""
    def mla(c):
        return {**c, "hd": 192, "hd_v": 128}

    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for nan in (False, True):
            tag = f"mla 192/128{', NaN past limits' if nan else ''}"
            check_case(f"{tag}, 16 heads", mla(case(2, 3, 16, 16, 192, 200, 70, 6, [200, 41])), dtype,
                       gen, nan_past_limits=nan)
            check_case(f"{tag}, softcap 30", mla(case(2, 4, 8, 8, 192, 130, 64, 5, [65, 130], 30.0)),
                       dtype, gen, nan_past_limits=nan)
            for name, local in LOCAL_FORMS:
                c = {**mla(case(2, 3, 16, 16, 192, 200, 70, 6, [200, 41])), "t": 4,
                     "eos": [[0, 69, 12], [5, 66, 37]], "local": local}
                check_case(f"{tag}, {name}", c, dtype, gen, nan_past_limits=nan)
    edges = [
        ("S 1, lq 1, MQA 8/1", case(2, 1, 8, 1, 192, 1, 1, 3, [0, 1]), torch.bfloat16, False),
        ("S 3, lq 64/130, GQA 4/2", case(2, 3, 4, 2, 192, 64, 130, 5, [63, 64]), torch.float16, False),
        ("S 3, lq 130/64, softcap 30", case(2, 3, 8, 8, 192, 130, 64, 5, [65, 130], 30.0),
         torch.bfloat16, False),
        ("lq 576, NaN past limits", case(2, 4, 16, 16, 192, 576, 64, 7, [65, 513]), torch.bfloat16, True),
        ("S 3, lq 130, NaN past limits", case(2, 3, 8, 1, 192, 130, 130, 5, [0, 127]), torch.float16,
         True),
        ("S 5, lq 576, float32", case(2, 5, 8, 8, 192, 576, 130, 7, [65, 513]), torch.float32, True),
    ]
    for name, c, dtype, nan in edges:
        check_case(f"mla 192/128, {name}", mla(c), dtype, gen, nan_past_limits=nan)


def phase_kernels(main_case: dict, gemma_case: dict, gemma12_case: dict, phi3_case: dict,
                  mla_case: dict) -> dict[str, dict]:
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
    # Local attention in every kernel: windows around the 64-key tiles, chunks,
    # and a window with the per-layer toggle off; GQA 32/16; bf16, fp16 and
    # float32; with and without NaN past every limit. Prompt 1's 41-key
    # prefix in a 200-row bucket leaves causal padding rows that see no key;
    # the decode suffixes' eos spread puts their bounds in different tiles.
    for name, local in LOCAL_FORMS:
        c = {**case(2, 3, 32, 16, 128, 200, 70, 6, [200, 41]), "t": 4,
             "eos": [[0, 69, 12], [5, 66, 37]], "local": local}
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            for nan in (False, True):
                check_case(f"{name}, GQA 32/16{', NaN past limits' if nan else ''}", c, dtype, gen,
                           nan_past_limits=nan)
    # Head dims 256 (own instantiations) and 96 (the hd-128 ones, columns
    # past 96 zero-filled): GQA 16/8 with softcap, every local form, query
    # lengths 1 and 576, in every dtype, with and without NaN past the limits.
    for hd in (256, 96):
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            for nan in (False, True):
                tag = f"hd {hd}{', NaN past limits' if nan else ''}"
                check_case(f"{tag}, GQA 16/8", case(2, 3, 16, 8, hd, 200, 70, 6, [200, 41]), dtype, gen,
                           nan_past_limits=nan)
                check_case(f"{tag}, softcap 30", case(2, 4, 8, 2, hd, 130, 64, 5, [65, 130], 30.0),
                           dtype, gen, nan_past_limits=nan)
                for name, local in LOCAL_FORMS:
                    c = {**case(2, 3, 16, 8, hd, 200, 70, 6, [200, 41]), "t": 4,
                         "eos": [[0, 69, 12], [5, 66, 37]], "local": local}
                    check_case(f"{tag}, {name}", c, dtype, gen, nan_past_limits=nan)
        check_case(f"hd {hd}, S 1, lq 1, MQA 8/1", case(2, 1, 8, 1, hd, 1, 1, 3, [0, 1]), torch.bfloat16,
                   gen)
        check_case(f"hd {hd}, S 5, lq 576, NaN past limits", case(2, 5, 32, 4, hd, 576, 130, 7, [65, 513]),
                   torch.bfloat16, gen, nan_past_limits=True)
    check_mla_cases(case, gen)
    errs = check_case("main path", main_case, torch.bfloat16, gen)
    gemma_local = {**gemma_case, "local": {"window": GEMMA_WINDOW}}
    gemma12_local = {**gemma12_case, "local": {"window": GEMMA_WINDOW}}
    shapes = {  # record key: (name, case, plain calls per timing round)
        "gemma3_27b_local": ("gemma3-27b local layer", gemma_local, 4),
        "gemma3_27b_global": ("gemma3-27b global layer", gemma_case, 4),
        "gemma3_12b_local": ("gemma3-12b local layer, hd 256", gemma12_local, 4),
        "gemma3_12b_global": ("gemma3-12b global layer, hd 256", gemma12_case, 4),
        "phi3_hd96": ("phi-3-mini heads, hd 96", phi3_case, 20),
        # The plain version runs 16 of the 128 heads at a time (all at once
        # its float32 scores alone would take 18 GB a copy).
        "deepseek_v3_mla": ("deepseek-v3 mla, qk 192 / v 128", {**mla_case, "plain_head_chunk": 16}, 2),
    }
    shape_errs = {key: check_case(name, c, torch.bfloat16, gen) for key, (name, c, _) in shapes.items()}
    time_long_prefix(gen)
    timed = time_case(main_case, gen)
    # The plain versions at the Gemma shapes take tens of ms a call: fewer calls.
    shape_t = {key: time_case({**c, "name": name}, gen, plain_calls=n)
               for key, (name, c, n) in shapes.items()}
    for k in timed:
        timed[k]["max_abs_err"] = errs[k]
        for key in shapes:
            if k in shape_t[key]:  # MLA shapes: the scoring kernels only
                timed[k][key] = {**shape_t[key][k], "max_abs_err": shape_errs[key][k]}
    return timed


# Local forms of the kernel checks: (name, window/chunk/local_on keywords).
LOCAL_FORMS = [(f"window {w}", {"window": w}) for w in (1, 48, 64, 65, 130)] + [
    (f"chunk {c}", {"chunk": c}) for c in (32, 64, 100)] + [
    ("window 48, local_on False", {"window": 48, "local_on": False})]

# google/gemma-3-27b-pt, config.json text_config: the fields that shape the
# model (its depth is cut per phase).
GEMMA3_27B_TEXT = {
    "model_type": "gemma3_text", "hidden_size": 5376, "intermediate_size": 21504,
    "num_hidden_layers": 62, "num_attention_heads": 32, "num_key_value_heads": 16,
    "head_dim": 128, "vocab_size": 262208, "rms_norm_eps": 1e-6,
    "query_pre_attn_scalar": 168, "sliding_window": 1024, "rope_theta": 1000000.0,
    "rope_local_base_freq": 10000.0, "rope_scaling": {"factor": 8.0, "rope_type": "linear"},
    "hidden_activation": "gelu_pytorch_tanh", "max_position_embeddings": 131072,
}
GEMMA_WINDOW = GEMMA3_27B_TEXT["sliding_window"]
# google/gemma-3-12b-pt, config.json text_config (head dim 256; the same
# window and rope as 27B).
GEMMA3_12B_TEXT = {
    "model_type": "gemma3_text", "hidden_size": 3840, "intermediate_size": 15360,
    "num_hidden_layers": 48, "num_attention_heads": 16, "num_key_value_heads": 8,
    "head_dim": 256, "vocab_size": 262208, "rms_norm_eps": 1e-6,
    "query_pre_attn_scalar": 256, "sliding_window": 1024, "rope_theta": 1000000.0,
    "rope_local_base_freq": 10000.0, "rope_scaling": {"factor": 8.0, "rope_type": "linear"},
    "hidden_activation": "gelu_pytorch_tanh", "max_position_embeddings": 131072,
}


# deepseek-ai/DeepSeek-V3, config.json: the fields that shape the model (its
# depth is cut per phase; first_k_dense_replace keeps layers 0-2 dense).
DEEPSEEK_V3 = {
    "model_type": "deepseek_v3", "vocab_size": 129280, "hidden_size": 7168,
    "intermediate_size": 18432, "moe_intermediate_size": 2048, "num_hidden_layers": 61,
    "num_attention_heads": 128, "num_key_value_heads": 128, "n_shared_experts": 1,
    "n_routed_experts": 256, "routed_scaling_factor": 2.5, "kv_lora_rank": 512, "q_lora_rank": 1536,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "qk_nope_head_dim": 128, "topk_method": "noaux_tc",
    "n_group": 8, "topk_group": 4, "num_experts_per_tok": 8, "moe_layer_freq": 1,
    "first_k_dense_replace": 3, "norm_topk_prob": True, "scoring_func": "sigmoid",
    "hidden_act": "silu", "max_position_embeddings": 163840, "rms_norm_eps": 1e-6,
    "tie_word_embeddings": False, "rope_theta": 10000, "attention_bias": False,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 1.0,
                     "mscale_all_dim": 1.0, "original_max_position_embeddings": 4096, "type": "yarn"},
}


# ---------------------------------------------------------------------------
# Phases 4-5: the port's CLI
# ---------------------------------------------------------------------------

# Initialisers of layer_specs: a linear kernel (scale sqrt(2 / (fan_in +
# fan_out)) over its last two dims), a norm scale (ones, or for the (1+w)
# Gemma norms small values around 0), a bias (both signs, DeepSeek's
# routing correction too) and the embedding / head (0.02).
LIN, NORM, BIAS, EMBED = "lin", "norm", "bias", "embed"


def layer_specs(cfg, i: int) -> list[tuple[str, tuple, str]]:
    """Decoder layer ``i``'s tensors in the JAX package's native layout:
    (flat key, shape, initialiser). MLA layers carry the q LoRA (or a dense
    q) and the compressed KV; MoE layers (``moe_layer_pattern``, or every
    layer of a MoE model without one) a router and stacked experts at the
    expert width, DeepSeek's adding the correction bias and the shared
    expert; its dense layers take ``intermediate_size_mlp``. Gemma's layers
    add the sandwich norms, Gemma 3's and Qwen3's the q/k norms, Qwen2's its
    q/k/v biases."""
    d, hd, hv = cfg.hidden_size, cfg.head_dim, cfg.v_dim
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    moe = cfg.num_local_experts > 0 and (cfg.moe_layer_pattern is None or cfg.moe_layer_pattern[i])
    f = cfg.intermediate_size if moe or not cfg.intermediate_size_mlp else cfg.intermediate_size_mlp
    specs = [("input_layernorm.scale", (d,), NORM), ("post_attention_layernorm.scale", (d,), NORM)]
    if cfg.kv_lora_rank:
        r, rq = cfg.kv_lora_rank, cfg.q_lora_rank
        if rq:
            specs += [("attn.q_a", (d, rq), LIN), ("attn.q_a_norm", (rq,), NORM),
                      ("attn.q_b", (rq, nq * hd), LIN)]
        else:
            specs.append(("attn.wq", (d, nq * hd), LIN))
        specs += [("attn.kv_a", (d, r + cfg.qk_rope_head_dim), LIN), ("attn.kv_a_norm", (r,), NORM),
                  ("attn.kv_b", (r, nq * (cfg.qk_nope_head_dim + hv)), LIN), ("attn.wo", (nq * hv, d), LIN)]
    else:
        specs += [("attn.wq", (d, nq * hd), LIN), ("attn.wk", (d, nkv * hd), LIN),
                  ("attn.wv", (d, nkv * hd), LIN), ("attn.wo", (nq * hd, d), LIN)]
    if moe:
        e = cfg.num_local_experts
        specs += [("mlp.router", (d, e), LIN), ("mlp.gate", (e, d, f), LIN), ("mlp.up", (e, d, f), LIN),
                  ("mlp.down", (e, f, d), LIN)]
        if cfg.model_type == "deepseek_v3":
            fs = f * cfg.n_shared_experts
            specs += [("mlp.correction_bias", (e,), BIAS), ("mlp.shared_gate", (d, fs), LIN),
                      ("mlp.shared_up", (d, fs), LIN), ("mlp.shared_down", (fs, d), LIN)]
    else:
        specs += [("mlp.gate", (d, f), LIN), ("mlp.up", (d, f), LIN), ("mlp.down", (f, d), LIN)]
    if cfg.qk_norm:
        specs += [("attn.q_norm", (hd,), NORM), ("attn.k_norm", (hd,), NORM)]
    if cfg.attention_in_bias and not cfg.kv_lora_rank:
        specs += [("attn.bq", (nq * hd,), BIAS), ("attn.bk", (nkv * hd,), BIAS), ("attn.bv", (nkv * hd,), BIAS)]
    if cfg.ffw_sandwich_norms:
        specs += [("pre_feedforward_layernorm.scale", (d,), NORM),
                  ("post_feedforward_layernorm.scale", (d,), NORM)]
    return specs


def model_specs(cfg) -> dict[str, list[tuple[str, tuple, str]]]:
    """Every layer file's specs, in execution order (no lm_head when tied)."""
    d = cfg.hidden_size
    out = {"model.embed_tokens": [("embedding", (cfg.vocab_size, d), EMBED)]}
    out.update({f"model.layers.{i}": layer_specs(cfg, i) for i in range(cfg.num_hidden_layers)})
    out["model.norm"] = [("scale", (d,), NORM)]
    if not cfg.tie_word_embeddings:
        out["lm_head"] = [("kernel", (d, cfg.vocab_size), EMBED)]
    return out


def make_tensor(cfg, shape, init: str, g, device, dtype, rows=None) -> torch.Tensor:
    """A seeded tensor of ``shape`` (or, with ``rows``, that many of its
    leading rows) by ``init``, made on ``device``, returned on the CPU."""
    shape = tuple(shape) if rows is None else (rows, *shape[1:])
    if init == NORM and not cfg.norm_unit_offset:
        return torch.ones(shape, dtype=dtype)
    scale = {NORM: 0.1, BIAS: 0.1, EMBED: 0.02}.get(init)
    if scale is None:
        scale = (2.0 / (shape[-2] + shape[-1])) ** 0.5
    return (torch.randn(*shape, generator=g, device=device) * scale).to(dtype).cpu()


def _init_params(cfg, dtype, seed: int, device: str) -> dict:
    """Seeded random weights of ``cfg`` (:func:`model_specs`) as one
    parameter dict in the JAX package's layout."""
    from flexible_llm_sharding_tpu_torch.utils.checkpoint import unflatten

    g = torch.Generator(device=device).manual_seed(seed)
    trees = {name: unflatten({k: make_tensor(cfg, shape, init, g, device, dtype)
                              for k, shape, init in specs})
             for name, specs in model_specs(cfg).items()}
    params = {"embed": trees["model.embed_tokens"], "norm": trees["model.norm"],
              "layers": [trees[f"model.layers.{i}"] for i in range(cfg.num_hidden_layers)]}
    if "lm_head" in trees:
        params["lm_head"] = trees["lm_head"]
    return params


def write_streamed_checkpoint(model_dir: str, cfg, seed: int) -> tuple[int, float]:
    """Seeded bf16 native layer files of ``cfg`` and its config.json, each
    tensor made on the card in pieces of leading rows (at most 2^27
    elements) and written as it is made, so host memory holds one piece, not
    a layer and never the model. Returns (bytes written, seconds)."""
    t0 = time.perf_counter()
    os.makedirs(model_dir, exist_ok=True)
    g = torch.Generator(device="cuda").manual_seed(seed)
    total = 0
    for name, specs in model_specs(cfg).items():
        header, off = {}, 0
        for key, shape, _ in specs:
            n = int(np.prod(shape)) * 2
            header[key] = {"dtype": "BF16", "shape": list(shape), "data_offsets": [off, off + n]}
            off += n
        hbytes = json.dumps(header, separators=(",", ":")).encode()
        hbytes += b" " * (-(8 + len(hbytes)) % 8)
        path = os.path.join(model_dir, f"{name}.safetensors")
        with open(path + ".tmp", "wb") as f:
            f.write(len(hbytes).to_bytes(8, "little"))
            f.write(hbytes)
            for key, shape, init in specs:
                step = max(1, (1 << 27) // max(1, int(np.prod(shape[1:]))))
                for r0 in range(0, shape[0], step):
                    piece = make_tensor(cfg, shape, init, g, "cuda", torch.bfloat16,
                                        rows=min(step, shape[0] - r0))
                    f.write(piece.reshape(-1).view(torch.uint8).numpy())
        os.replace(path + ".tmp", path)
        total += 8 + len(hbytes) + off
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(cfg.to_dict(), f)
    return total, time.perf_counter() - t0


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


def cross_configs() -> dict:
    """The reduced-width models of the float32 card-vs-CPU check, by name:
    each family's Hugging Face config at a small width. Windows of 32 bind at
    the check's 71- to 151-token prompts."""
    from flexible_llm_sharding_tpu_torch.config import LlamaConfig

    small = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_attention_heads=4,
                 num_key_value_heads=2)
    local3 = ["sliding_attention", "sliding_attention", "full_attention"]
    hf = {
        "gemma3": {**GEMMA3_27B_TEXT, **small, "head_dim": 128, "num_hidden_layers": 3,
                   "sliding_window": 32, "layer_types": local3},
        "gemma3 hd256": {**GEMMA3_12B_TEXT, **small, "num_hidden_layers": 3, "sliding_window": 32,
                         "layer_types": local3},
        "gemma hd256": {"model_type": "gemma", **small, "head_dim": 256, "num_hidden_layers": 2},
        "phi3 hd96": {"model_type": "phi3", **small, "hidden_size": 384, "num_hidden_layers": 2,
                      "sliding_window": 32},
        "qwen2": {"model_type": "qwen2", **small, "num_attention_heads": 2, "num_key_value_heads": 1,
                  "num_hidden_layers": 2, "use_sliding_window": True, "sliding_window": 32,
                  "max_window_layers": 1},
        "qwen3": {"model_type": "qwen3", **small, "head_dim": 128, "num_hidden_layers": 2},
        "mistral": {"model_type": "mistral", **small, "hidden_size": 512, "num_hidden_layers": 2,
                    "sliding_window": 32},
        # Rope scalings: llama3 bands and yarn bound at these lengths; the
        # longrope boundary (100) between the 71- and the 151-token prompts.
        "llama3": {"model_type": "llama", **small, "num_hidden_layers": 2, "rope_theta": 500000.0,
                   "rope_scaling": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                                    "high_freq_factor": 4.0, "original_max_position_embeddings": 64}},
        "qwen2 yarn": {"model_type": "qwen2", **small, "num_hidden_layers": 2,
                       "rope_scaling": {"type": "yarn", "factor": 4.0,
                                        "original_max_position_embeddings": 32}},
        "phi3 longrope": {"model_type": "phi3", **small, "hidden_size": 384, "num_hidden_layers": 2,
                          "max_position_embeddings": 4096, "original_max_position_embeddings": 100,
                          "rope_scaling": {"type": "longrope",
                                           "long_factor": [1.0 + 0.25 * i for i in range(48)],
                                           "short_factor": [1.0 + 0.02 * i for i in range(48)]}},
        # Experts: Mixtral's (renormalised top 2), Qwen3-MoE's (layer 0 dense,
        # no renormalisation); DeepSeek-V3's MLA at its qk 192 / v 128 heads,
        # layer 0 dense, 8 experts in 4 groups of which 2 are kept.
        "mixtral": {"model_type": "mixtral", **small, "num_hidden_layers": 2, "num_local_experts": 4,
                    "num_experts_per_tok": 2},
        "qwen3_moe": {"model_type": "qwen3_moe", **small, "head_dim": 128, "num_hidden_layers": 2,
                      "num_experts": 4, "num_experts_per_tok": 2, "mlp_only_layers": [0]},
        "deepseek_v3": {**DEEPSEEK_V3, **small, "num_attention_heads": 2, "num_key_value_heads": 2,
                        "moe_intermediate_size": 128, "num_hidden_layers": 2, "n_routed_experts": 8,
                        "num_experts_per_tok": 2, "n_group": 4, "topk_group": 2,
                        "first_k_dense_replace": 1, "kv_lora_rank": 64, "q_lora_rank": 96},
    }
    return {"llama": LlamaConfig(num_hidden_layers=2, explicit_head_dim=128, **small),
            **{name: LlamaConfig.from_dict(d) for name, d in hf.items()}}


def phase_cross(work: str) -> None:
    """Float32 card vs CPU through the CLI, for every model of
    :func:`cross_configs`."""
    from flexible_llm_sharding_tpu_torch.utils.checkpoint import save_params

    prompts = make_prompts(5, 70, 3, 6, seed=2) + make_prompts(2, 150, 2, 9, seed=3)
    for name, cfg in cross_configs().items():
        name = name.replace(" ", "_")
        model_dir = os.path.join(work, f"cross_{name}")
        save_params(_init_params(cfg, torch.float32, 11, "cpu"), model_dir, cfg)
        for mode, extra in (("loop", []), ("kv_cache", ["--kv_cache", "true"])):
            args = ["--dtype", "float32", "--num_gen_token", "3", "--block_size", "4", *extra]
            gpu, gpu_up, _ = run_cli(model_dir, work, f"cross_gpu_{name}_{mode}", prompts,
                                     [*args, "--device", "cuda"], 512)
            cpu, cpu_up, _ = run_cli(model_dir, work, f"cross_cpu_{name}_{mode}", prompts,
                                     [*args, "--device", "cpu"], 512)
            err = max(float(np.abs(g - c).max()) for g, c in zip(gpu, cpu))
            if not all(np.allclose(g, c, atol=1e-4, rtol=0) for g, c in zip(gpu, cpu)):
                fail(f"cross-check {name} {mode}: card and CPU scores differ by {err:.3e}")
            if any((g.argmax(-1) != c.argmax(-1)).any() for g, c in zip(gpu, cpu)) or gpu_up != cpu_up:
                fail(f"cross-check {name} {mode}: greedy tokens differ between card and CPU")
            log(f"[cross] float32 {name} {mode}: card vs CPU max_abs_err {err:.3e}, "
                "greedy tokens identical")


def _check_scores(scores, prompts, n_gen: int, vocab: int, tag: str) -> None:
    for s, (_, sfx) in zip(scores, prompts):
        if s.shape != (len(sfx), n_gen, vocab):
            fail(f"{tag}: scores of shape {s.shape}")
        if not np.isfinite(s).all():
            fail(f"{tag}: non-finite scores")
        if not np.allclose(s.sum(-1), 1.0, atol=1e-3):
            fail(f"{tag}: distributions do not sum to 1")


def write_gemma3_bundle(bundle: str, text_config: dict, seed: int) -> int:
    """A seeded bf16 Hugging Face checkpoint shaped as google/gemma-3-12b-pt
    ships it: the gemma3 wrapper config.json (``text_config`` and a small
    ``vision_config``), the language model's keys under
    ``language_model.model.*`` at Hugging Face shapes ([out, in]), a few
    vision-tower and projector tensors, in three shards with
    ``model.safetensors.index.json``. Returns the bytes written."""
    from flexible_llm_sharding_tpu_torch.config import LlamaConfig
    from flexible_llm_sharding_tpu_torch.utils.checkpoint import write_safetensors

    os.makedirs(bundle, exist_ok=True)
    wrapper = {
        "architectures": ["Gemma3ForConditionalGeneration"], "model_type": "gemma3",
        "boi_token_index": 255999, "eoi_token_index": 256000, "image_token_index": 262144,
        "mm_tokens_per_image": 256, "torch_dtype": "bfloat16", "text_config": text_config,
        "vision_config": {"model_type": "siglip_vision_model", "hidden_size": 1152,
                          "intermediate_size": 4304, "num_hidden_layers": 27,
                          "num_attention_heads": 16, "image_size": 896, "patch_size": 14},
    }
    with open(os.path.join(bundle, "config.json"), "w") as f:
        json.dump(wrapper, f, indent=1)
    cfg = LlamaConfig.from_dict(wrapper)
    g = torch.Generator(device="cuda").manual_seed(seed)
    d, ff, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads

    def w(out, inp):  # a Linear weight, [out, in]
        return (torch.randn(out, inp, generator=g, device="cuda")
                * (2.0 / (out + inp)) ** 0.5).to(torch.bfloat16).cpu()

    def norm(n):  # a (1+w) norm scale
        return (torch.randn(n, generator=g, device="cuda") * 0.1).to(torch.bfloat16).cpu()

    lm = "language_model.model"
    n = cfg.num_hidden_layers
    shards = [
        {f"{lm}.embed_tokens.weight": (torch.randn(cfg.vocab_size, d, generator=g, device="cuda")
                                       * 0.02).to(torch.bfloat16).cpu(),
         "vision_tower.vision_model.embeddings.patch_embedding.weight": w(1152, 3 * 14 * 14),
         "vision_tower.vision_model.post_layernorm.weight": norm(1152),
         "multi_modal_projector.mm_input_projection_weight": w(1152, d),
         "multi_modal_projector.mm_soft_emb_norm.weight": norm(1152)},
        {}, {f"{lm}.norm.weight": norm(d)},
    ]
    for i in range(n):
        p = f"{lm}.layers.{i}"
        shards[1 if i < n // 2 else 2].update({
            f"{p}.input_layernorm.weight": norm(d), f"{p}.post_attention_layernorm.weight": norm(d),
            f"{p}.pre_feedforward_layernorm.weight": norm(d),
            f"{p}.post_feedforward_layernorm.weight": norm(d),
            f"{p}.self_attn.q_proj.weight": w(nq * hd, d), f"{p}.self_attn.k_proj.weight": w(nkv * hd, d),
            f"{p}.self_attn.v_proj.weight": w(nkv * hd, d), f"{p}.self_attn.o_proj.weight": w(d, nq * hd),
            f"{p}.self_attn.q_norm.weight": norm(hd), f"{p}.self_attn.k_norm.weight": norm(hd),
            f"{p}.mlp.gate_proj.weight": w(ff, d), f"{p}.mlp.up_proj.weight": w(ff, d),
            f"{p}.mlp.down_proj.weight": w(d, ff),
        })
    weight_map, total = {}, 0
    for j, tensors in enumerate(shards):
        fn = f"model-{j + 1:05d}-of-{len(shards):05d}.safetensors"
        write_safetensors(os.path.join(bundle, fn), tensors)
        weight_map.update(dict.fromkeys(tensors, fn))
        total += sum(t.nbytes for t in tensors.values())
    with open(os.path.join(bundle, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    return total


def phase_split(work: str, name: str, text_config: dict) -> tuple[str, dict]:
    """A gemma3 bundle of ``text_config`` split into per-layer native files
    by the port's offline entry, run as a user runs it:
    ``python -m flexible_llm_sharding_tpu_torch.prepare_weights``. The
    bundle is deleted once split. Returns (split directory, its config)."""
    from flexible_llm_sharding_tpu_torch.config import LlamaConfig

    bundle, model_dir = os.path.join(work, f"{name}_hf"), os.path.join(work, name)
    t0 = time.perf_counter()
    total = write_gemma3_bundle(bundle, text_config, seed=0)
    log(f"[full] wrote a seeded bf16 {name}-width Hugging Face bundle ({total} bytes in 3 shards) "
        f"in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "flexible_llm_sharding_tpu_torch.prepare_weights",
                           bundle, model_dir], cwd=HERE, capture_output=True, text=True)
    split_s = time.perf_counter() - t0
    shutil.rmtree(bundle, ignore_errors=True)
    if proc.returncode != 0:
        fail(f"prepare_weights failed on the {name} bundle:\n{proc.stderr[-4000:]}")
    written = sum(os.path.getsize(os.path.join(model_dir, f)) for f in os.listdir(model_dir)
                  if f.endswith(".safetensors"))
    files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    if any("vision" in f or "multi_modal" in f for f in files):
        fail(f"prepare_weights kept vision-tower files: {files}")
    cfg = LlamaConfig.from_pretrained(model_dir)
    log(f"[full] prepare_weights split the {name} bundle into {len(files)} layer files, "
        f"{written} bytes, in {split_s:.3f} s (model_type {cfg.model_type}, head dim {cfg.head_dim})")
    return model_dir, cfg


def phase_full(work: str, name: str, cfg, prompts, n_gen_loop: int, n_gen_kv: int,
               model_dir: str | None = None) -> dict:
    """A seeded bf16 checkpoint of ``cfg`` (one layer per shard, so every
    layer streams; written here unless ``model_dir`` holds one) through the
    CLI: scoring, then --kv_cache. Every kernel of each run must launch;
    with local layers (a window) each must launch with the window on and
    with it off, without them never with it on. Under MLA the scoring
    kernels must launch at the model's (qk, v) head dims only and the decode
    kernel never (MLA decode is the plain op's, as in the JAX package).
    Returns per kernel its launches and its launches with the window on."""
    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa
    from flexible_llm_sharding_tpu_torch.utils.checkpoint import save_params

    if model_dir is None:
        model_dir = os.path.join(work, name)
        t0 = time.perf_counter()
        save_params(_init_params(cfg, torch.bfloat16, 0, "cuda"), model_dir, cfg)
        log(f"[full] wrote a seeded bf16 {name}-width checkpoint with {cfg.num_hidden_layers} "
            f"decoder layers in {time.perf_counter() - t0:.3f} s")
    common = ["--dtype", "bfloat16", "--layer_num_per_shard", "1", "--device", "cuda"]
    launches = {k: {"launches": 0, "local_launches": 0} for k in fa.KERNELS}
    scoring = ("flash_causal_attention", "flash_prefix_shared_attention")
    mla = bool(cfg.kv_lora_rank)
    runs = (
        ("scoring", ["--num_gen_token", str(n_gen_loop)], n_gen_loop, scoring),
        ("kv_cache", ["--num_gen_token", str(n_gen_kv), "--kv_cache", "true"], n_gen_kv,
         scoring if mla else fa.KERNELS),
    )
    windowed = cfg.sliding_window is not None
    try:
        for tag, extra, n_gen, needed in runs:
            fa.reset_launch_counts()
            scores, _, stats = run_cli(model_dir, work, f"full_{name}_{tag}", prompts,
                                       [*common, *extra], cfg.vocab_size)
            counts, local = fa.launch_counts(), fa.local_launch_counts()
            dims = fa.dim_launch_counts()
            _check_scores(scores, prompts, n_gen, cfg.vocab_size, f"{name} {tag}")
            missing = [k for k in needed if counts[k] == 0]
            if missing:
                fail(f"full {name} {tag}: kernels never launched on the main path: {missing}")
            if mla and (counts["flash_decode_attention"]
                        or any(set(dims[k]) != {(cfg.head_dim, cfg.v_dim)} for k in scoring)):
                fail(f"full {name} {tag}: MLA launches by (qk, v) head dims {dims}: the scoring "
                     f"kernels must run at ({cfg.head_dim}, {cfg.v_dim}) only and decode never")
            if windowed and any(local[k] == 0 or local[k] == counts[k] for k in needed):
                fail(f"full {name} {tag}: a kernel did not launch both with and without the window: "
                     f"{counts} (window on: {local})")
            if not windowed and any(local.values()):
                fail(f"full {name} {tag}: a window reached a kernel of a model without one: {local}")
            for k in counts:
                launches[k]["launches"] += counts[k]
                launches[k]["local_launches"] += local[k]
            keys = ("wall_s", "tokens_processed", "tokens_per_sec", "streamed_bytes", "peak_mem_gb",
                    "source_wait_s", "load_weights_time_s", "compute_wall_s")
            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20  # KiB -> GiB
            log(f"[full] {name} {tag} stats " + json.dumps({**{k: stats.get(k) for k in keys},
                                                           "host_peak_rss_gib": rss}))
            log(f"[full] {name} {tag} kernels " + json.dumps(counts) + " window on "
                + json.dumps(local) + " by (qk, v) head dims "
                + json.dumps({k: {f"{a}/{b}": n for (a, b), n in v.items()} for k, v in dims.items()}))
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    return launches


def main() -> None:
    from flexible_llm_sharding_tpu_torch.config import LlamaConfig

    smi = phase_device()
    phase_build()
    prompts = make_prompts(8, 512, 4, 32, seed=0)
    n_gen_loop, n_gen_kv = 4, 8
    # Gemma 3: 2048 prefix words (2049 tokens in a 2112 bucket), past the
    # 1024-token window; depth cut from 62 to 6 layers, 5 local and 1 global.
    gemma_prompts = make_prompts(8, 2048, 4, 32, seed=1)
    gemma_loop, gemma_kv = 2, 4
    gemma_cfg = LlamaConfig.from_dict(
        {"model_type": "gemma3", "text_config": {**GEMMA3_27B_TEXT, "num_hidden_layers": 6}})
    # Gemma-3-12B: depth cut from 48 to 6 layers (layers 0-4 local, 5 global).
    gemma12_text = {**GEMMA3_12B_TEXT, "num_hidden_layers": 6}
    gemma12_cfg = LlamaConfig.from_dict({"model_type": "gemma3", "text_config": gemma12_text})
    # DeepSeek-V3: depth cut from 61 to 4 layers (0-2 dense, 3 MoE), the
    # Gemma prompts.
    ds_cfg = LlamaConfig.from_dict({**DEEPSEEK_V3, "num_hidden_layers": 4})
    ds_loop, ds_kv = 2, 2
    timed = phase_kernels(
        main_path_case(prompts, n_gen_kv),
        main_path_case(gemma_prompts, gemma_kv, nq=gemma_cfg.num_attention_heads,
                       nkv=gemma_cfg.num_key_value_heads, hd=gemma_cfg.head_dim),
        main_path_case(gemma_prompts, gemma_kv, nq=gemma12_cfg.num_attention_heads,
                       nkv=gemma12_cfg.num_key_value_heads, hd=gemma12_cfg.head_dim),
        # Phi-3-mini-4k's heads (32 query and KV heads of 96) at the Llama prompts.
        main_path_case(prompts, n_gen_kv, nq=32, nkv=32, hd=96),
        # DeepSeek-V3's MLA heads: every query head has its own K and V.
        main_path_case(gemma_prompts, ds_kv, nq=ds_cfg.num_attention_heads,
                       nkv=ds_cfg.num_attention_heads, hd=ds_cfg.head_dim, hd_v=ds_cfg.v_dim))
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        phase_cross(work)
        paths = {
            "llama2_7b": phase_full(work, "llama2-7b", LlamaConfig(num_hidden_layers=4), prompts,
                                    n_gen_loop, n_gen_kv),
            "gemma3_27b": phase_full(work, "gemma3-27b", gemma_cfg, gemma_prompts, gemma_loop,
                                     gemma_kv),
        }
        split_dir, split_cfg = phase_split(work, "gemma3-12b", gemma12_text)
        if split_cfg != gemma12_cfg:
            fail(f"the split gemma3-12b config differs from the bundle's: {split_cfg}")
        paths["gemma3_12b"] = phase_full(work, "gemma3-12b", split_cfg, gemma_prompts, gemma_loop,
                                         gemma_kv, model_dir=split_dir)
        ds_dir = os.path.join(work, "deepseek-v3")
        nbytes, secs = write_streamed_checkpoint(ds_dir, ds_cfg, seed=0)
        log(f"[full] wrote a seeded bf16 deepseek-v3-width checkpoint with {ds_cfg.num_hidden_layers} "
            f"decoder layers ({nbytes} bytes, one layer file at a time) in {secs:.3f} s")
        paths["deepseek_v3"] = phase_full(work, "deepseek-v3", ds_cfg, gemma_prompts, ds_loop, ds_kv,
                                          model_dir=ds_dir)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    kernels = [
        {
            "name": k,
            "route": "cuda",
            "source": CUDA_SOURCE,
            "replaces": REPLACES[k],
            "launches": sum(p[k]["launches"] for p in paths.values()),
            **{key: timed[k][key] for key in
               ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "launches_by_path": {name: p[k] for name, p in paths.items()},
            **{key: timed[k][key] for key in ("gemma3_27b_local", "gemma3_27b_global",
                                              "gemma3_12b_local", "gemma3_12b_global", "phi3_hd96",
                                              "deepseek_v3_mla") if key in timed[k]},
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
