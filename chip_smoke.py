#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a nonzero exit if it fails:

1. device  — a CUDA device must be present; prints its name and power limit.
2. build   — builds the port's CUDA kernels from the source in this
             checkout (one nvcc) and, at the same time, its readahead pool
             (one g++, csrc/fileprefetch.cpp); prints each instantiation's
             registers, stack, local memory and dynamic shared memory, and
             fails on ptxas warning C7518, on local memory (spills), on
             shared memory above the 232,448 B a block may have, and unless
             the readahead pool is the native one.
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
             edge lengths; Llama-4-Scout's heads at its full-width shapes
             and with chunks of 64 and 8192, in bf16 and float32, ± NaN);
             bf16 and fp16 within
             atol = rtol = 2e-2 of the plain version computed in float32
             from the same inputs, float32 within atol 1e-4. Times each
             kernel, its plain version and its library yardstick (one SDPA
             call on KV concatenated beforehand) at the shapes of the
             full-width runs (Llama-2-7B; Gemma-3-27B and Gemma-3-12B local
             and global layers; Phi-3-mini heads, hd 96, at the Llama
             prompts; DeepSeek-V3's 128 MLA heads, the scoring kernels;
             Llama-4-Scout's 40 query heads over 8 KV heads, a GQA group of
             5, on its NoPE layer and with its 8192-token chunk, which the
             decode kernel applies; and the serving slice's two shapes, each
             checked and timed on its one kernel: the draft model's causal
             call, one context of 576 positions over TinyLlama-1.1B's 32/4
             heads of 64, and a coalesced entry's 8 suffixes over one
             576-token prefix on the prefix-shared kernel),
             and every kernel and its yardstick at a
             4096-token prefix with one prompt (device time from CUDA events
             around back-to-back calls queued behind a spin kernel, so the
             host's launch work is not in it).
4. cross   — reduced-width float32 checkpoints (llama, gemma 3 and gemma 1
             at hd 256, phi3 at hd 96, qwen2, qwen3, mistral; windows that
             bind; llama3, yarn and longrope rope scalings; mixtral,
             qwen3_moe and deepseek_v3 with its MLA heads; llama4 with a
             GQA group of 5, a chunk of 32 that binds, a NoPE layer whose
             temperature moves, dense and MoE layers and Scout's rope
             scaling) through the
             port's CLI on the card and on the CPU: scores within atol 1e-4
             and identical greedy tokens, for the re-scoring loop and for
             --kv_cache (on the card resident, its steps one CUDA graph per
             block, or the uncaptured device loop for MoE models); on the
             llama, gemma3, deepseek_v3 and llama4 checkpoints also
             --speculative_k
             4 (verify passes over resident weights) on the card: the
             tokens of plain --kv_cache, scores within 1e-4; and the int8
             and int4 copies of llama, gemma3, deepseek_v3 and llama4
             (requantize_native) through both loops, card against CPU:
             scores within 1e-4, tokens equal; and on the llama checkpoint
             the ``serve`` subcommand (demo mode, waves of 2) on the card
             against the same on the CPU: tokens equal, scores within 1e-4,
             and the serve engine with 5 requests on two seeded LoRA
             adapters (ranks 4 and 8) and 2 base ones in waves of 2, card
             against CPU: tokens equal, scores within 1e-4;
             and on the llama and gemma3 checkpoints ``serve`` on the card
             against a run it must equal (tokens equal, scores within
             1e-4): --speculative_k 4 by prompt lookup, by a reduced seeded
             draft model of the same vocabulary and by that draft with
             --spec_adaptive, each against --speculative_k 0; --sched with
             6 requests of 2 prefixes coalesced into 2 prefills against the
             same requests one per wave; and --sched with a best-effort
             request preempted by an interactive one against its
             uninterrupted run.
5. full    — seeded bf16 checkpoints at full width through the CLI, one
             layer per shard so every layer streams: Llama-2-7B (4 decoder
             layers; scoring with --num_gen_token 4, then --kv_cache with
             8), Gemma-3-27B (2 layers, 1 local and 1 global), and
             Gemma-3-12B (hd 256, 2 layers), which is written as a
             Hugging Face bundle shaped as google/gemma-3-12b-pt ships it
             (the gemma3 wrapper config, language-model keys at [out, in],
             a vision tower, three shards and an index) and split by the
             port's prepare_weights first; then DeepSeek-V3 (2 layers: 0
             dense, 1 with its 256 experts; 27.9 GB written one layer file
             at a time), scoring with --num_gen_token 2, then --kv_cache;
             then Llama-4-Scout's text model (2 of 48 layers: 0 a chunked
             rope layer, 1 the NoPE layer; 16 experts, top 1, and the
             shared expert in every layer; vocabulary 202,048; Scout's
             llama3 rope; 12.9 GB written one layer file at a time) on the
             Gemma prompts, scoring with --num_gen_token 2, then --kv_cache
             with 2, each pass streaming exactly the checkpoint's bytes.
             Scores must be finite and sum to 1, and every kernel of each
             run must have launched (with a local form that binds at the
             bucket, or in decode, where the local form always applies:
             with it on and with it off; else never on); under MLA the scoring kernels at (192, 128) only and the
             decode kernel never (MLA decode runs the plain op, as in the
             JAX package). Every run has the CLI's defaults (verified loads,
             the process host shard cache, readahead, retries) and starts
             as a CLI process would, with no cached shard or crc verdict; it
             prints its cache hits, misses and hit rate, crc passes and
             verdict hits, host read seconds and host RSS, and a cell whose
             files fit the cache budget must hit on every shard of every
             pass after the first. Each --kv_cache run takes the decode
             modes' defaults and must report them engaged: weights resident
             (one weight pass streamed: one miss per shard, no hit), KV on
             the card, fused steps, captured as one CUDA graph per block
             for the dense models and uncaptured for DeepSeek-V3 (MoE); on
             the Llama-2-7B cell the defaults must equal --decode_fused off
             and --decode_resident off bit for bit.
   quant   — after the Llama-2-7B cell: its int8 and int4 copies
             (requantize_native, on the host as prepare_weights makes
             them) and a mixed copy that plan-precision plans on the card
             under a budget halfway between the int4 and the bf16 bytes
             (written by --apply, then audited by verify, which must find
             no problem), each through scoring and --kv_cache: finite
             distributions summing to 1, every kernel launched, the first
             position's probabilities within the JAX tests' bounds of the
             bf16 run's (0.05 int8; 0.15 int4 and mixed); each run prints
             its streamed bytes, wall and load_weights_time_s beside the
             bf16 run's. The card's dequant is held tight at full width:
             a bf16 copy written from the host's dequant of the int4 copy
             (its [32000, 4096] embedding included) must give the int4
             runs' scores and tokens bit for bit. The DeepSeek-V3
             checkpoint's int4 copy is made before its cell runs and goes
             through --kv_cache after it, against the cell's bf16
             --kv_cache run; its MoE layer's 256-expert stacks and other
             kernels, dequantized on the card as the weight source does,
             must equal the host's dequant bit for bit (the first, middle
             and last expert of each stack).
   serve   — after the resume phase, on the 4-layer Llama-2-7B cell:
             first the kernels against their plain versions at the serve
             path's shapes (a block of 2 rows, 32/32 heads, Lp 576, bf16;
             then the prefix-shared and decode kernels on prefix K/V sliced
             from a pool stack uploaded from page-locked memory); then the
             ``serve`` subcommand's demo frontend with the 8 prompts, 8
             tokens each, waves of at most 2, blocks of 2. The default
             engine (resident) must give the scores of the batch CLI's
             --kv_cache --block_size 2 run bit for bit, with every request
             admitted and completed, 2 <= prefills < 8 and more sweeps than
             prefills (later waves joined while earlier ones decoded);
             --decode_resident off (the cycling weight source) must give
             the default engine's scores bit for bit and stream more than
             one pass; and a pickle of the 8 prompts twice must reuse the
             first round's sealed pool entries (prefix_reuse_hits >= 1),
             give the second round the first round's scores bit for bit,
             and launch the prefix-shared kernel on the suffix-only path:
             beyond the full prefills' launches, one per reused block and
             layer. Each run prints its wall, tokens/s, TTFT mean and p95,
             per-token latency, queue depth after submission, pool pages
             and bytes and peak memory, beside the card's name and power
             limit; the served runs' launches are the ``llama2_7b_serve``
             path. Then the scheduler's runs (the ``llama2_7b_serve_sched``
             path): --sched on the 8 prompts (one tenant, class standard)
             must give the default engine's scores bit for bit; 2 prefixes
             of 512 words shared by 4 requests each (2 suffixes of 32),
             --sched --max_wave_requests 4, must coalesce all 8 requests
             into 2 prefills with prefix-KV bytes saved and call the
             prefix-shared kernel at S 8 only; through the JSONL frontend,
             4 best-effort requests and, once all four are in flight, 2
             interactive ones (--max_active_requests 4, waves of 2) must
             preempt at least once and complete all six (printing the
             interactive TTFT against sched_parity's and how many resumed
             best-effort tokens differ from the default run's: bf16 bits
             may move in the resumed prefill). Then speculation (the
             ``llama2_7b_serve_spec`` path, where decode is the verify
             pass's plain op, so the decode kernel is not on it): the 8
             prompts with --speculative_k 4 (prompt lookup), printing its
             verify passes, drafted and accepted tokens; then with a
             seeded bf16 draft checkpoint at TinyLlama-1.1B's published
             widths (22 layers, 2.2 GB), --spec_adaptive --spec_k_min 0
             --spec_k_max 4: the draft's pinned bytes must equal its
             payload, the target must stream what the lookup run streamed,
             and the causal kernel must launch once per draft layer per
             draft token beyond the prefills; it prints the draft's pin
             load and drafting seconds.
   tenants — right after serve, on the same cell (the
             ``llama2_7b_serve_adapters`` and ``llama2_7b_serve_wal``
             paths): two seeded float32 LoRA adapters on all 4 layers,
             tenant-a (rank 8, ``save_adapter``) and tenant-b (rank 16,
             ``prepare-adapter`` from a PEFT directory written here); the
             card's bf16 shift against a float32 one; the serve CLI with
             --adapter_dir and every request on the base model, which must
             give the default engine's scores bit for bit with 0 delta
             bytes; 3 requests on tenant-a, 3 on tenant-b and 2 base queued
             at once (waves of 2), whose tokens and argmax must equal the
             batch-of-1 oracle's (the same engine, one request at a time),
             whose tenants' scores must differ from the base model's, which
             must stream the base-only run's bytes, with delta bytes under
             5% of them, then served again with the shift and the factor
             upload timed (host clock and CUDA events, per sweep); tenant-a's prompts twice, then under tenant-b: the
             second round must reuse the pool (no causal launch, the first
             round's scores bit for bit) and tenant-b must get no hit; an
             unknown adapter, failing only its request; ``verify
             --adapter_dir`` exit 0, then exit 2 naming adapter_mismatch
             after one flipped byte, and the engine failing only that
             tenant's request (AdapterCorruptError). Then the request WAL:
             the fsync cost of an admission record per policy; the serve
             CLI (JSONL, --wal_dir) in a child process stopped by SIGTERM
             once its first wave prefilled (exit 143), then a second serve
             CLI process over the same --wal_dir with no new line, whose
             ``wal replay:`` line is read: every open request replayed,
             the exported prefix KV restored and served by the suffix-only
             path (prefix-shared launches without a causal one, counted in
             that process), the replies of both processes merged by client
             id with the tokens of the serve phase's default run (the
             largest bf16 score gap printed); then a child process killed
             by SIGKILL mid-sweep after 3 sweeps (FLS_WAL_CRASH_SWEEPS; the
             first wave's two requests, budget 2, done before it), and a
             restart process that must not serve those two again, merged
             tokens the default run's, torn tails counted.
   fleet   — right after tenants, on the same cell (the
             ``llama2_7b_serve_fleet`` path): each kernel launched 30 times
             from 3 fresh threads at once at the serve block's shapes, every
             launch equal bit for bit to one from the main thread; the serve
             CLI with --replicas 3 (150 ms apart) in a fresh process, whose
             tokens and argmax must equal the serve phase's default engine's,
             with 8 dispatches, no re-dispatch and every replica serving; the
             same with --chaos --chaos_sites replica_kill
             --chaos_max_faults 1: one replica dead, at least one
             re-dispatch, one recycle, no expired orphan; then in process a
             3-replica fleet with one replica_kill seeded to land mid-decode
             (the first kill draw is the 107th shard step of the fleet's,
             about every replica's sixth sweep; the victim must be in a
             decode sweep of a prefilled wave, its waves' device state
             measured at the kill), whose torch.cuda.memory_allocated()
             after the kill, the recycle, the drain and gc.collect() must
             exceed the clean fleet's (every replica holding its weights)
             by less than that state and a quarter of one replica's weights
             (both read with PyTorch's per-handle cuBLAS workspaces freed,
             and printed with them), host RSS printed at both; 2 replicas with one replica_stall and
             --watchdog_abort_s 2.5: hard-failed, completions summing to the
             requests, shutdown True with no thread left; a replica added
             while requests are in flight and drained out, then one removed
             hard with queued work (re-dispatched), then the last one's
             removal refused; --autoscale (min 1, max 2) growing under a
             burst of 8 and shrinking back once idle (its stagger error
             printed); and a 3-replica serve CLI with --wal_dir killed by
             SIGKILL mid-sweep, replayed by a 2-replica process: one dispatch
             per replayed request, merged tokens the default engine's. Each
             run prints its wall, TTFT and per-token latency (mean, p95),
             completions per replica, sweeps, streamed bytes, router
             counters, memory and launches beside the card's name and power
             limit, and the phase its seconds.
   resume  — after the quant phase, on the 4-layer Llama-2-7B cell with
             --storage_location disk: a CLI process (each shard started
             one second late) killed with SIGKILL once its marker reads 2
             or more completed shards, then --resume true: the scores of
             an uninterrupted disk run bit for bit, only the shards left
             streamed, the marker removed; then, in-process, one bit of a
             spill flipped between shards 2 and 3: the block recomputed
             from shard 2, the scores bit for bit and the recompute
             counted. And the cell's scoring at --score_sink_max_device 1:
             the default's scores bit for bit.
   multidevice — right after fleet, on the same cell (the ``llama2_7b_mp``
             and ``llama2_7b_dp`` paths): scoring (num_batch 2) and
             --kv_cache's decode through ``run_prompts``/``run_decode``, one
             device against the interleaved MP pipeline over [cuda:0] * 4
             (bit for bit) and data parallelism over [cuda:0] * 2 (two rank
             threads on one broadcast read; tokens equal, scores within
             1e-4, streamed bytes equal); with several cards, the same over
             them. Each run prints its wall, streamed bytes and launches.
   longctx — right after multidevice, on the same cell in float32 (the
             ``llama2_7b_longctx`` path): long context over a device list
             through ``run_prompts``/``run_decode`` with ``long_context``,
             a prompt of a 3000-token prefix and 4 suffixes of 32 tokens
             beside one of 512 words, at a per-device cap of 1024 over
             [cuda:0] * 4 (an sp cap of 4096): the scores equal the
             untruncated single-device run's at a cap of 4096 (rtol 2e-4,
             atol 1e-5), the same cap without long_context truncates and
             differs, 4-token KV decode gives its tokens and distributions;
             the short prompt launches the scoring kernels (and in decode
             the decode kernel), the sequence-parallel pass none; its
             streamed bytes equal one device's; with several cards, the
             same over them. Prints each run's wall, load seconds, peak
             memory, streamed bytes and launches.
   use_pallas — right after longctx, on the same cell at 2 of its 4 layers
             (a directory of links to its files), float32, one layer per
             shard (the ``llama2_7b_use_pallas`` path): one scoring call,
             a 4-token --kv_cache decode and one wave of a ServeEngine
             through the library entry points, each at the default and at
             ``use_pallas=False``: under False no kernel launches, under the
             default each kernel of the run launches, the scores agree
             within atol 1e-6 (rtol 0; 1/30 of a typical probability of
             the 32,000-token vocabulary) and the greedy tokens are equal.
             Prints each run's wall and launches beside the card's name and
             power limit: an end-to-end A/B of the kernels against the plain
             ops.
   pressure — right after use_pallas, on the same cell (the
             ``llama2_7b_pressure`` path): the batch CLI under --chaos at
             the loader and upload sites (shard_read, device_put, host_oom,
             corrupt_shard, link_throttle; a seed under which each injects
             in the first pass) with the ladder on, scoring and --kv_cache,
             and in disk mode under disk_full and corrupt_activation: the
             cell's clean scores and tokens bit for bit, every site's faults,
             retries and heals above 0, and the card's allocated memory after
             each run equal to before it; a serving engine under
             engine_step and queue_admission, resubmitting what a fault
             rejected or aborted: the serve phase's default tokens, the
             rejections typed, no memory left after its shutdown; the
             brownout ladder (--pressure, polled every 50 ms): an engine at
             --hbm_pin_gb auto streaming pinned layers serves the 8 prompts,
             then an engine with one host_oom fault walks the ladder to
             shed (a submit meanwhile gets Overloaded with its retry-after),
             drops the pins (the allocated memory falls by at least their
             bytes), steps back to level 0 and serves on, every token the
             default engine's; and one pressure sample from a fresh thread
             reads the card's free share.
   obs     — right after pressure, on the same cell (the ``llama2_7b_obs``
             path): scoring x4 with --trace, --metrics_out, --journal_dir
             and --verbose_metrics, bit-equal to the untraced run with
             equal launches, a sweep span a pass and compute, source_wait,
             shard_produce and device_put spans a shard, `trace-report`'s
             source_wait_s the stats line's within 1 ms and the metrics
             dump the stats line's numbers; --kv_cache 8 traced to JSONL,
             equal to the untraced run; scoring with --profile_dir (the
             torch.profiler trace's score_tc_kernel events against the
             launches); the default engine under engine_step chaos with
             tracing, the endpoint scraped while it serves, the journal and
             one incident bundle naming the aborted wave; a 2-replica fleet
             under a replica_kill whose bundle's journal, metrics and trace
             name the same dead replica; and untraced, traced, traced,
             untraced scoring, twice, for the tracer's overhead (the
             medians' ratio; fails above 1.25).
6. host    — a reduced bf16 checkpoint through the CLI on the card: the
             defaults give the scores of --host_cache_gb 0 --verify_weights
             false --readahead_threads 0 bit for bit; after one flipped
             byte, a warm process raises ShardCorruptError, a fresh CLI
             process exits nonzero naming it, and ``verify`` exits 2.

7. decode  — Llama-2-7B at 2 of its 32 layers (1.33 GB of seeded bf16,
             written one layer file at a time), --kv_cache with 8 tokens,
             three runs: the defaults (resident, one CUDA graph per block),
             --decode_fused off and --decode_resident off; prints each
             run's wall and stats and requires equal tokens. Then scoring
             with --num_gen_token 4 at --hbm_pin_gb 0, 1 and auto: scores
             equal bit for bit, streamed bytes lower by the pinned bytes on
             every pass after the first, auto pinning every layer; prints
             each run's pinned and streamed bytes and wall.
8. train   — training at Llama-2-7B's widths (depth 1 and 2, seeded
             float32 params from the port's init_params; a seeded bf16
             native checkpoint for the resume leg): the streamed trainer
             against the monolithic step, its peak device memory flat in
             depth and under the monolithic step's, a falling loss, a
             save_state parked at .old and resumed, gradient accumulation,
             bf16 compute over float32 masters, no attention kernel launched
             and each CUDA wrapper refusing a gradient (``phase_train``).
             Prints each step's forward, backward and update seconds, its
             bytes each way and the peaks.

Output: per-phase lines, then a JSON line of kernel records, the card's
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import contextlib
import gc
import io
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
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores (score_kernel_f32's FMAs)
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
    import threading

    from flexible_llm_sharding_tpu_torch.ops import cuda_build
    from flexible_llm_sharding_tpu_torch.utils import native

    t0 = time.perf_counter()
    gxx = threading.Thread(target=native.load_lib)  # g++ beside nvcc
    gxx.start()
    lib = cuda_build.library()
    log(f"[build] {cuda_build.SOURCE.name} built and loaded in {time.perf_counter() - t0:.3f} s")
    gxx.join()
    prefetcher = native.FilePrefetcher(2)
    if not prefetcher.native:
        fail(f"the readahead pool did not build natively: {native.build_log}")
    prefetcher.close()
    log(f"[build] {native.SOURCE.name} built and loaded (native readahead pool) in "
        f"{time.perf_counter() - t0:.3f} s since the build phase began")
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
    # score_kernel_f32 keeps at least 8 warps on an SM (two blocks of 128
    # threads up to hd 128, one of 256 above) to hide its shared loads.
    warps = {f"{hd}": lib.fls_score_f32_warps(hd, hd) for hd in HEAD_DIMS}
    warps.update({f"{hd}/{hd_v}": lib.fls_score_f32_warps(hd, hd_v) for hd, hd_v in MLA_DIMS})
    log(f"[build] score_kernel_f32 resident warps per SM by head dim: {warps}")
    if min(warps.values()) < 8:
        fail(f"score_kernel_f32: fewer than 8 resident warps per SM: {warps}")
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
               kernels=None, pooled_layers: int = 0) -> dict[str, float]:
    """Every kernel (or those named in ``kernels``) against its plain version
    on the same inputs. With ``nan_past_limits`` the kernels get K/V rows
    that no query may see filled with NaN, and the plain versions the same
    rows as zeros. With ``pooled_layers`` the prefix K/V is the last layer's
    slice of a [pooled_layers, B, Lp, n_kv, hd] stack uploaded from
    page-locked host memory, as the serve engine's ``_assemble`` feeds the
    suffix-only prefill and the decode of a block that reuses pooled pages."""
    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa

    atol, rtol = (1e-4, 0.0) if dtype == torch.float32 else (2e-2, 2e-2)
    x = _inputs(case, dtype, gen, fill_past_limits=0.0 if nan_past_limits else None)
    if pooled_layers:
        for key in ("kp", "vp"):
            layers = [torch.randn(*x[key].shape, generator=gen, device="cuda").to(dtype)
                      for _ in range(pooled_layers - 1)] + [x[key]]
            host = torch.stack(layers).cpu().pin_memory()
            x[key] = host.to("cuda", non_blocking=True)[pooled_layers - 1]
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


def _bounds(case: dict, dtype=torch.bfloat16) -> dict[str, tuple[float, str]]:
    """Least time on the card for each kernel's work at this case's data:
    the larger of the bytes it must move (Q read and O written once, each
    key row it must read once, K and V, at ``dtype``'s width) over 3.35 TB/s
    and its FLOPs (QK^T over hd and PV over V's head dim hd_v: 2*(hd + hd_v)
    per visible query-key pair and query head) over 989 TFLOP/s in bf16 and
    fp16 (tensor cores), 67 TFLOP/s in float32 (the FMA units, where
    score_kernel_f32 runs its products). With a local form only the pairs
    within it count, and only the key rows some query sees within it."""
    b, s, nq, nkv, hd = case["B"], case["S"], case["nq"], case["nkv"], case["hd"]
    hd_v = case.get("hd_v", hd)
    e = torch.tensor([], dtype=dtype).element_size()  # bytes per element
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    kv_row = nkv * (hd + hd_v) * e  # one key row of K and V
    q_rows = {"flash_causal_attention": b * case["Lp"],
              "flash_prefix_shared_attention": b * s * case["Ls"], "flash_decode_attention": b * s}
    out = {}
    for k, (pairs, keys) in _work(case).items():
        t_ops = 2 * (hd + hd_v) * nq * float(pairs) / peak * 1e3
        t_bytes = float(q_rows[k] * nq * (hd + hd_v) * e + keys * kv_row) / PEAK_BYTES * 1e3
        out[k] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return out


def time_case(case: dict, gen, plain_calls: int = 20, kernels=None,
              dtype=torch.bfloat16, calls: int = 20, reps: int = 20) -> dict[str, dict]:
    """Kernel, plain and library times at the case's shapes and local form
    (in ``dtype``), for every kernel or those named in ``kernels``. The
    library time is one SDPA call on inputs its yardstick built beforehand;
    each time is the median of ``reps`` rounds of ``calls`` calls
    (``plain_calls`` for the plain version)."""
    import torch.nn.functional as F

    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa

    x = _inputs(case, dtype, gen)
    bounds = _bounds(case, dtype)
    local = case.get("local") or {}
    out = {}
    chunk = case.get("plain_head_chunk")
    for kernel, (args, kw) in _calls(x, None, local).items():
        if kernels is not None and kernel not in kernels:
            continue
        sdpa = YARDSTICKS[kernel](*args, **local)
        out[kernel] = {
            "ms": _device_ms(lambda: getattr(fa, kernel)(*args, **kw), calls, reps),
            "plain_ms": _device_ms(lambda: run_plain(kernel, args, kw, chunk), plain_calls, reps),
            "library_ms": _device_ms(lambda: F.scaled_dot_product_attention(**sdpa), calls, reps),
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


def coalesce_prompts():
    """The coalesced entries of the coalescing run: two 512-word prefixes,
    each with the 8 suffixes of 32 words its 4 requests bring."""
    return make_prompts(2, 512, 8, 32, seed=5)


def coalesce_requests():
    """The coalescing run's requests: each entry's 4 requests of 2 suffixes,
    the first prefix's four first."""
    return [(p, sfx[i:i + 2]) for p, sfx in coalesce_prompts() for i in range(0, 8, 2)]


def draft_path_case(prompts, n_gen_kv: int) -> dict:
    """The draft model's causal call on the serve path: one context (B 1) of
    a prompt's prefix, one suffix and its tokens so far, right-padded to the
    next multiple of 64 (``DRAFT_PAD_MULTIPLE``), the valid length all of it;
    TinyLlama-1.1B's heads."""
    from flexible_llm_sharding_tpu_torch.runtime.draft import DRAFT_PAD_MULTIPLE
    from flexible_llm_sharding_tpu_torch.runtime.tokenization import PromptTokenizer

    tp = PromptTokenizer(BenchTokenizer())(*prompts[0])
    n = tp.prefix_len + int(tp.suffix_eos.max()) + 1 + n_gen_kv
    lp = -(-n // DRAFT_PAD_MULTIPLE) * DRAFT_PAD_MULTIPLE
    hd = TINYLLAMA_1_1B["hidden_size"] // TINYLLAMA_1_1B["num_attention_heads"]
    return {"B": 1, "S": 1, "Ls": 64, "Lp": lp, "T": 1, "t": 0,
            "nq": TINYLLAMA_1_1B["num_attention_heads"],
            "nkv": TINYLLAMA_1_1B["num_key_value_heads"], "hd": hd, "hd_v": hd,
            "plen": [lp], "eos": [[0]]}


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
                  mla_case: dict, scout_case: dict, draft_case: dict,
                  coalesced_case: dict) -> dict[str, dict]:
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
    # Llama-4-Scout's heads: 40 over 8, a GQA group of 5, so the decode
    # kernel's 16-row blocks split a suffix's group between two blocks; at
    # its full-width shapes and with chunks of 64 (binding) and 8192, in bf16
    # and float32, with and without NaN past the limits.
    for dtype in (torch.bfloat16, torch.float32):
        for nan in (False, True):
            tag = f"llama4-scout heads 40/8{', NaN past limits' if nan else ''}"
            check_case(f"{tag}, full width", scout_case, dtype, gen, nan_past_limits=nan)
            for chunk in (64, 8192):
                c = {**case(2, 4, 40, 8, 128, 200, 70, 6, [200, 41]), "t": 4,
                     "eos": [[0, 69, 12, 33], [5, 66, 37, 1]], "local": {"chunk": chunk}}
                check_case(f"{tag}, chunk {chunk}", c, dtype, gen, nan_past_limits=nan)
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
        # Scout's NoPE layer (no local form) and its rope layers, whose
        # 8192-token chunk the decode kernel applies (the scoring kernels'
        # shortcut drops it at the 2112 + 64 bucket).
        "llama4_scout_global": ("llama4-scout NoPE layer, GQA 40/8", scout_case, 4),
        "llama4_scout_chunked": ("llama4-scout rope layer, chunk 8192",
                                 {**scout_case, "local": {"chunk": 8192}}, 4),
    }
    # Tensor parallelism's head shards of the Llama main path: 16 and 8 of
    # the 32 query and KV heads (tp = 2 and 4).
    shapes.update({
        f"llama2_7b_tp{tp}_shard": (f"llama2-7b head shard at tp = {tp}",
                                    {**main_case, "nq": 32 // tp, "nkv": 32 // tp}, 20)
        for tp in (2, 4)})
    shape_errs = {key: check_case(name, c, torch.bfloat16, gen) for key, (name, c, _) in shapes.items()}
    # The float32 paths (use_pallas, longctx, tp) at the Llama main path's
    # shapes: score_kernel_f32 for the scoring kernels, decode_rows_kernel
    # in float32.
    f32_name = "llama2-7b float32"
    shape_errs["llama2_7b_f32"] = check_case(f32_name, main_case, torch.float32, gen)
    # DeepSeek-V3's MLA head shard at tp = 2 (64 of the 128 heads), in bf16
    # (score_tc_kernel) and float32 (score_kernel_f32); its plain version 16
    # heads at a time, and few calls a round (a plain call takes tens of ms).
    ds_name = "deepseek-v3 mla head shard at tp = 2"
    ds_shard = {**mla_case, "nq": mla_case["nq"] // 2, "nkv": mla_case["nkv"] // 2, "plain_head_chunk": 16}
    ds_shapes = {"deepseek_v3_tp2_shard": (ds_name, torch.bfloat16),
                 "deepseek_v3_tp2_shard_f32": (f"{ds_name}, float32", torch.float32)}
    for key, (name, dtype) in ds_shapes.items():
        shape_errs[key] = check_case(name, ds_shard, dtype, gen)
    # The serving slice's shapes, each on the one kernel that meets it: the
    # draft model's forward (TinyLlama-1.1B's 32 query heads over 4 KV heads
    # of 64, one context) and a coalesced entry's 8 suffixes over one prefix.
    serve_shapes = {  # record key: (name, case, kernel)
        "tinyllama_draft": ("tinyllama-1.1b draft forward, GQA 32/4, hd 64", draft_case,
                            "flash_causal_attention"),
        "llama2_7b_coalesced_s8": ("llama2-7b coalesced entry, S 8", coalesced_case,
                                   "flash_prefix_shared_attention"),
    }
    for key, (name, c, kernel) in serve_shapes.items():
        shape_errs[key] = check_case(name, c, torch.bfloat16, gen, kernels=(kernel,))
    time_long_prefix(gen)
    timed = time_case(main_case, gen)
    # The plain versions at the Gemma shapes take tens of ms a call: fewer calls.
    shape_t = {key: time_case({**c, "name": name}, gen, plain_calls=n)
               for key, (name, c, n) in shapes.items()}
    shape_t.update({key: time_case({**c, "name": name}, gen, kernels=(kernel,))
                    for key, (name, c, kernel) in serve_shapes.items()})
    shape_t["llama2_7b_f32"] = time_case({**main_case, "name": f32_name}, gen, plain_calls=4,
                                         dtype=torch.float32)
    shape_t.update({key: time_case({**ds_shard, "name": name}, gen, plain_calls=1, dtype=dtype, calls=5, reps=5)
                    for key, (name, dtype) in ds_shapes.items()})
    shapes.update(serve_shapes)
    shapes.update(ds_shapes)
    shapes["llama2_7b_f32"] = (f32_name, main_case, 4)
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
# depth is cut per phase, with first_k_dense_replace cut to keep one dense
# layer before the MoE ones).
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


# meta-llama/Llama-4-Scout-17B-16E, config.json text_config: the fields that
# shape the model (transformers' Llama4TextConfig defaults are its widths),
# with its published rope_scaling. Its depth is cut per phase, and the
# per-layer lists (layer_types, no_rope_layers, moe_layers) follow from
# their rules: every fourth layer global and NoPE, every layer MoE.
LLAMA4_SCOUT_TEXT = {
    "model_type": "llama4_text", "vocab_size": 202048, "hidden_size": 5120,
    "intermediate_size": 8192, "intermediate_size_mlp": 16384, "num_hidden_layers": 48,
    "num_attention_heads": 40, "num_key_value_heads": 8, "head_dim": 128,
    "num_local_experts": 16, "num_experts_per_tok": 1, "interleave_moe_layer_step": 1,
    "rms_norm_eps": 1e-5, "rope_theta": 500000.0, "attention_chunk_size": 8192,
    "use_qk_norm": True, "attn_temperature_tuning": True, "floor_scale": 8192,
    "attn_scale": 0.1, "hidden_act": "silu", "max_position_embeddings": 131072,
    "tie_word_embeddings": False,
    "rope_scaling": {"rope_type": "llama3", "factor": 16.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 1.0, "original_max_position_embeddings": 8192},
}


# TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T, config.json: a draft
# model paired with Llama-2-7B (Llama 2's tokenizer), at full depth.
TINYLLAMA_1_1B = {
    "model_type": "llama", "hidden_size": 2048, "intermediate_size": 5632,
    "num_hidden_layers": 22, "num_attention_heads": 32, "num_key_value_heads": 4,
    "vocab_size": 32000, "max_position_embeddings": 2048, "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0, "tie_word_embeddings": False, "hidden_act": "silu",
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
    expert, Llama 4's the shared expert; their dense layers take
    ``intermediate_size_mlp``. Gemma's layers
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
        if cfg.model_type in ("deepseek_v3", "llama4_text"):
            fs = f * (cfg.n_shared_experts if cfg.model_type == "deepseek_v3" else 1)
            specs += [("mlp.shared_gate", (d, fs), LIN), ("mlp.shared_up", (d, fs), LIN),
                      ("mlp.shared_down", (fs, d), LIN)]
        if cfg.model_type == "deepseek_v3":
            specs.append(("mlp.correction_bias", (e,), BIAS))
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


def payload_bytes(cfg, names=None) -> int:
    """The bf16 tensor bytes of the layer files ``names`` (every file when
    None): what one weight pass streams of them."""
    specs = model_specs(cfg)
    return sum(int(np.prod(shape)) * 2 for name, layer in specs.items()
               if names is None or name in names for _, shape, _ in layer)


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
    """Seeded bf16 native layer files of ``cfg``, its ``integrity.json`` and
    config.json, each tensor made on the card in pieces of leading rows (at
    most 2^27 elements) and written (and crc'd) as it is made, so host
    memory holds one piece, not a layer and never the model. Returns (bytes
    written, seconds)."""
    from flexible_llm_sharding_tpu_torch.integrity import manifest

    t0 = time.perf_counter()
    os.makedirs(model_dir, exist_ok=True)
    g = torch.Generator(device="cuda").manual_seed(seed)
    total = 0
    layers = {}
    for name, specs in model_specs(cfg).items():
        header, off = {}, 0
        for key, shape, _ in specs:
            n = int(np.prod(shape)) * 2
            header[key] = {"dtype": "BF16", "shape": list(shape), "data_offsets": [off, off + n]}
            off += n
        hbytes = json.dumps(header, separators=(",", ":")).encode()
        hbytes += b" " * (-(8 + len(hbytes)) % 8)
        path = os.path.join(model_dir, f"{name}.safetensors")
        tensors = {}
        with open(path + ".tmp", "wb") as f:
            f.write(len(hbytes).to_bytes(8, "little"))
            f.write(hbytes)
            for key, shape, init in specs:
                step = max(1, (1 << 27) // max(1, int(np.prod(shape[1:]))))
                crc = 0
                for r0 in range(0, shape[0], step):
                    piece = make_tensor(cfg, shape, init, g, "cuda", torch.bfloat16,
                                        rows=min(step, shape[0] - r0))
                    raw = piece.reshape(-1).view(torch.uint8).numpy()
                    f.write(raw)
                    crc = zlib.crc32(raw, crc)
                tensors[key] = {"c": f"{crc & 0xFFFFFFFF:08x}", "n": header[key]["data_offsets"][1]
                                - header[key]["data_offsets"][0]}
        os.replace(path + ".tmp", path)
        layers[name] = {"file": f"{name}.safetensors", "dtype": "bfloat16", "tensors": tensors}
        total += 8 + len(hbytes) + off
    manifest.write_manifest(model_dir, layers)
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


def run_serve(model_dir: str, work: str, tag: str, prompts, extra: list[str], vocab: int):
    """The port's ``serve`` subcommand in demo mode over ``prompts``:
    (scores, updated prompts, stats)."""
    from flexible_llm_sharding_tpu_torch import cli

    ppkl = os.path.join(work, f"{tag}.pkl")
    opkl = os.path.join(work, f"{tag}_scores.pkl")
    with open(ppkl, "wb") as f:
        pickle.dump(prompts, f)
    stats = cli.main(["serve", "--model_path", model_dir, "--prompt_pickle", ppkl,
                      "--output_file", opkl, "--stats_interval_s", "0", *extra],
                     tokenizer=BenchTokenizer(vocab))
    with open(opkl, "rb") as f:
        scores = pickle.load(f)
    with open(os.path.join(work, f"{tag}_updated.pkl"), "rb") as f:
        updated = pickle.load(f)
    return scores, updated, stats


def fresh_process_state() -> None:
    """Start the next CLI run as a new process would: no cached shard, no
    pinned layer, no crc verdict, and PyTorch's page-locked pool and cached
    device blocks handed back."""
    import gc

    from flexible_llm_sharding_tpu_torch.adapters import loader
    from flexible_llm_sharding_tpu_torch.integrity import manifest
    from flexible_llm_sharding_tpu_torch.runtime import hostcache, kvpool, pressure, residency
    from flexible_llm_sharding_tpu_torch.utils.metrics import host_rss_gib

    from flexible_llm_sharding_tpu_torch.obs import events as obs_events
    from flexible_llm_sharding_tpu_torch.obs import trace as obs_trace

    before = host_rss_gib().get("rss")
    # Tracing and the journal are process-wide and never switched off by a
    # later config: a new process starts with both off.
    obs_trace.TRACER.disable()
    obs_trace.TRACER.clear()
    obs_trace.TRACER.default_out = ""
    obs_events.reset_journal()
    pressure.reset_process_pressure()
    loader.reset_process_store()
    hostcache.reset_process_cache()
    residency.reset_process_tier()
    kvpool.reset_process_pools()
    manifest.reset_verdicts()
    gc.collect()
    torch.cuda.empty_cache()
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None:
        empty()
    log(f"[process] caches reset, page-locked pool {'emptied' if empty else 'kept (no API)'}: "
        f"RSS {before} -> {host_rss_gib().get('rss')} GiB")


HOST_KEYS = ("host_cache_hits", "host_cache_misses", "host_cache_hit_rate", "crc_full_verifies",
             "crc_verdict_hits", "io_retries", "integrity_failures", "reread_heals",
             "quarantined_shards", "load_weights_time_s", "host_rss_gib", "peak_host_rss_gib")


def check_host_path(tag: str, stats: dict, model_dir: str, cfg, passes: int) -> dict:
    """The run's host-path stats; a model whose layer files (the embedding
    twice when the head is tied) fit the cache budget must miss on its first
    pass only: one miss per shard, plus the tied head, and a hit for every
    shard of every later pass. A run of one pass (a resident --kv_cache
    run) misses on every shard and hits none, whatever the budget."""
    from flexible_llm_sharding_tpu_torch.runtime import hostcache

    cache = hostcache.process_cache()
    budget = cache.budget_bytes if cache is not None else 0
    n_shards = cfg.num_hidden_layers + 3  # one layer per shard
    tied = int(cfg.tie_word_embeddings)
    files = [os.path.join(model_dir, f) for f in os.listdir(model_dir) if f.endswith(".safetensors")]
    model_bytes = sum(os.path.getsize(f) for f in files)
    if tied:
        model_bytes += os.path.getsize(os.path.join(model_dir, "model.embed_tokens.safetensors"))
    out = {k: stats.get(k) for k in HOST_KEYS}
    out.update(cache_budget_bytes=budget, model_bytes=model_bytes, fits=model_bytes <= budget)
    if out["fits"] or passes == 1:
        want = (n_shards * (passes - 1), n_shards + tied)
        got = (stats.get("host_cache_hits"), stats.get("host_cache_misses"))
        if got != want:
            fail(f"{tag}: {passes} weight pass(es), model {model_bytes} B, cache budget {budget} "
                 f"B, but (hits, misses) = {got}, not {want}")
    if not stats.get("crc_full_verifies"):
        fail(f"{tag}: no layer load was crc-verified")
    return out


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
        # Llama 4: Scout's rope and GQA group of 5 (10 over 2 heads of 128),
        # layers 0-2 chunked (32, binding), layer 3 NoPE with a temperature
        # that moves every 16 positions, layers 1 and 3 MoE.
        "llama4": {**LLAMA4_SCOUT_TEXT, **small, "num_attention_heads": 10, "num_key_value_heads": 2,
                   "intermediate_size_mlp": 768, "num_hidden_layers": 4, "num_local_experts": 4,
                   "interleave_moe_layer_step": 2, "attention_chunk_size": 32, "floor_scale": 16},
    }
    return {"llama": LlamaConfig(num_hidden_layers=2, explicit_head_dim=128, **small),
            **{name: LlamaConfig.from_dict(d) for name, d in hf.items()}}


# The cross-check models that also run speculative decode on the card, those
# whose int8 and int4 copies are cross-checked too, and those that serve with
# the scheduler and speculation on the card.
CROSS_SPECULATIVE = ("llama", "gemma3", "deepseek_v3", "llama4")
CROSS_QUANTIZED = ("llama", "gemma3", "deepseek_v3", "llama4")
CROSS_SERVE = ("llama", "gemma3")


def _served_equal(tag: str, got, ref, atol: float = 1e-4) -> float:
    """Served results (scores, tokens) against a reference run's: the same
    tokens, scores within ``atol``; returns the largest score difference."""
    if len(got) != len(ref):
        fail(f"cross-check {tag}: {len(got)} results, {len(ref)} in the reference")
    err = max(float(np.abs(g[0] - r[0]).max()) for g, r in zip(got, ref))
    if any(not np.array_equal(g[1], r[1]) for g, r in zip(got, ref)) or err > atol:
        fail(f"cross-check {tag}: tokens equal "
             f"{all(np.array_equal(g[1], r[1]) for g, r in zip(got, ref))}, max_abs_err "
             f"{err:.3e}")
    return err


def cross_serve(work: str, name: str, model_dir: str, prompts, draft_dir: str) -> None:
    """Float32 ``serve`` on the card with speculation and the scheduler,
    each against the run it must equal (see the module doc)."""
    from flexible_llm_sharding_tpu_torch.config import FrameworkConfig, SchedConfig, ServeConfig
    from flexible_llm_sharding_tpu_torch.runtime import kvpool
    from flexible_llm_sharding_tpu_torch.serve import ServeEngine

    args = ["--dtype", "float32", "--max_new_tokens", "6", "--block_size", "4",
            "--max_wave_requests", "2", "--device", "cuda"]

    def demo(tag, extra):
        kvpool.reset_process_pools()
        scores, updated, stats = run_serve(model_dir, work, f"cross_{name}_{tag}", prompts,
                                           [*args, *extra], 512)
        tokens = [np.asarray([[int(t) for t in row] for row in _new_tokens(u, p)])
                  for u, p in zip(updated, prompts)]
        return list(zip(scores, tokens)), stats

    ref, _ = demo("spec_off", ["--speculative_k", "0"])
    for tag, extra in (
        ("lookup", ["--speculative_k", "4"]),
        ("draft", ["--speculative_k", "4", "--draft_model_path", draft_dir]),
        ("draft_adaptive", ["--speculative_k", "4", "--draft_model_path", draft_dir,
                            "--spec_adaptive", "--spec_k_max", "4", "--spec_window", "2"]),
    ):
        got, stats = demo(tag, extra)
        err = _served_equal(f"{name} serve {tag}", got, ref)
        spec = stats.get("spec", {})
        log(f"[cross] float32 {name} serve --speculative_k 4 ({tag}) on the card: the tokens of "
            f"--speculative_k 0, max_abs_err {err:.3e}; drafted {spec.get('drafted_tokens')}, "
            f"accepted {spec.get('accepted_tokens')}, sweeps {stats['sweeps']}")

    def engine(sched: bool, **kw):
        kvpool.reset_process_pools()
        return ServeEngine(
            FrameworkConfig(model_path=model_dir, dtype="float32", block_size=4, device="cuda"),
            ServeConfig(default_max_new_tokens=6, sched=SchedConfig(enabled=sched), **kw),
            tokenizer=BenchTokenizer(512), device=torch.device("cuda"), start=False)

    def finish(e, reqs):
        try:
            out = [r.future.result(timeout=300) for r in reqs]
        finally:
            e.shutdown(drain=True)
        if e.error is not None:
            fail(f"cross-check {name} serve: engine failed: {e.error!r}")
        return [(r.scores, r.tokens) for r in out], e

    # Coalescing: two prefixes, three requests each, queued before the first
    # boundary, against the same requests served one prompt per wave.
    reqs = [(p, sfx[i:i + 2]) for p, sfx in make_prompts(2, 70, 6, 6, seed=4)
            for i in range(0, 6, 2)]
    e = engine(False, max_wave_requests=1)
    ref = finish(e.start(), [e.submit(p, sfx) for p, sfx in reqs])[0]
    e = engine(True, max_wave_requests=3)
    submitted = [e.submit(p, sfx) for p, sfx in reqs]
    got, e = finish(e.start(), submitted)
    err = _served_equal(f"{name} serve --sched coalesced", got, ref)
    sched = e.stats()["sched"]
    if sched["coalesced_requests"] != len(reqs) or e.stats()["prefills"] != 2:
        fail(f"cross-check {name} serve --sched: coalesced {sched['coalesced_requests']} of "
             f"{len(reqs)} requests in {e.stats()['prefills']} prefills, want all in 2")
    log(f"[cross] float32 {name} serve --sched, {len(reqs)} requests coalesced into 2 prefills: "
        f"the tokens of one prompt per wave, max_abs_err {err:.3e}")

    # Preemption: a best-effort request interrupted by an interactive one,
    # against its uninterrupted run.
    n_long = 8
    e = engine(False, max_wave_requests=1)
    ref = finish(e.start(), [e.submit(*prompts[0], max_new_tokens=n_long)])[0]
    e = engine(True, max_wave_requests=1, max_active_requests=1).start()
    victim = e.submit(*prompts[0], max_new_tokens=n_long, slo_class="best_effort",
                      tenant_id="batch")
    deadline = time.monotonic() + 300
    while e.metrics.counter("prefills") < 1:
        if time.monotonic() > deadline:
            fail(f"cross-check {name} serve --sched: the best-effort request never prefilled")
        time.sleep(0.002)
    urgent = e.submit(*prompts[1], max_new_tokens=1, slo_class="interactive", tenant_id="live")
    got, e = finish(e, [victim, urgent])
    err = _served_equal(f"{name} serve --sched preempted", got[:1], ref)
    preemptions = e.stats()["sched"]["preemptions"]
    if preemptions < 1 or not urgent.finished_at < victim.finished_at:
        fail(f"cross-check {name} serve --sched: {preemptions} preemptions, the interactive "
             "request did not finish first")
    log(f"[cross] float32 {name} serve --sched, best-effort request preempted {preemptions} "
        f"time(s): the tokens of its uninterrupted run, max_abs_err {err:.3e}")


def cross_tenants(work: str, model_dir: str, prompts) -> None:
    """Float32 tenant-mixed serving, the card's engine against the CPU's:
    two seeded adapters (ranks 4 and 8, both layers) and base rows mixed in
    waves of 2, all queued at once; the same tokens, scores within 1e-4,
    and on the card the delta applied."""
    from flexible_llm_sharding_tpu_torch.adapters import loader
    from flexible_llm_sharding_tpu_torch.adapters.registry import save_adapter
    from flexible_llm_sharding_tpu_torch.config import AdapterConfig, FrameworkConfig, ServeConfig
    from flexible_llm_sharding_tpu_torch.runtime import kvpool
    from flexible_llm_sharding_tpu_torch.serve import ServeEngine

    root = os.path.join(work, "cross_adapters")
    rng = np.random.default_rng(31)
    for name, r in (("tenant-a", 4), ("tenant-b", 8)):
        save_adapter(root, name, {f"model.layers.{i}": (
            (rng.standard_normal((256, r)) / 16).astype(np.float32),
            (0.1 / np.sqrt(r) * rng.standard_normal((r, 256))).astype(np.float32))
            for i in range(2)})
    aids = ["tenant-a", None, "tenant-b", "tenant-a", "tenant-b", None, "tenant-b"]
    runs = {}
    for dev in ("cuda", "cpu"):
        kvpool.reset_process_pools()
        loader.reset_process_store()
        e = ServeEngine(
            FrameworkConfig(model_path=model_dir, dtype="float32", block_size=2, device=dev,
                            adapters=AdapterConfig(dir=root)),
            ServeConfig(default_max_new_tokens=4, max_wave_requests=2),
            tokenizer=BenchTokenizer(512), device=torch.device(dev), start=False)
        reqs = [e.submit(p, sfx, adapter_id=aid) for (p, sfx), aid in zip(prompts, aids)]
        e.start()
        try:
            out = [r.future.result(timeout=600) for r in reqs]
        finally:
            e.shutdown(drain=True)
        if e.error is not None:
            fail(f"cross-check llama serve tenants on {dev}: engine failed: {e.error!r}")
        runs[dev] = ([(r.scores, r.tokens) for r in out], e.stats())
    loader.reset_process_store()
    err = _served_equal("llama serve tenants", runs["cuda"][0], runs["cpu"][0])
    a = runs["cuda"][1]["adapter"]
    if a["applied_rows"] != runs["cpu"][1]["adapter"]["applied_rows"] or not a["delta_bytes"]:
        fail(f"cross-check llama serve tenants: card adapter stats {a}, CPU "
             f"{runs['cpu'][1]['adapter']}")
    log(f"[cross] float32 llama serve, 5 tenant requests (ranks 4 and 8) and 2 base in waves of "
        f"2: card vs CPU engine max_abs_err {err:.3e}, tokens identical; {a['applied_rows']} rows "
        f"shifted, {a['delta_bytes']} delta bytes")


def phase_cross(work: str) -> None:
    """Float32 card vs CPU through the CLI, for every model of
    :func:`cross_configs`, and for the int8 and int4 copies of
    :data:`CROSS_QUANTIZED`; speculative decode on the card against plain
    --kv_cache for :data:`CROSS_SPECULATIVE`; tenant-mixed serving on the
    llama (:func:`cross_tenants`)."""
    from flexible_llm_sharding_tpu_torch.config import LlamaConfig
    from flexible_llm_sharding_tpu_torch.runtime import kvpool
    from flexible_llm_sharding_tpu_torch.utils.checkpoint import requantize_native, save_params

    prompts = make_prompts(5, 70, 3, 6, seed=2) + make_prompts(2, 150, 2, 9, seed=3)
    # The serve checks' draft: the cross models' vocabulary, 4 heads of 64.
    draft_dir = os.path.join(work, "cross_draft")
    draft_cfg = LlamaConfig(num_hidden_layers=2, vocab_size=512, hidden_size=256,
                            intermediate_size=512, num_attention_heads=4, num_key_value_heads=1)
    save_params(_init_params(draft_cfg, torch.float32, 13, "cpu"), draft_dir, draft_cfg)
    for name, cfg in cross_configs().items():
        name = name.replace(" ", "_")
        model_dir = os.path.join(work, f"cross_{name}")
        save_params(_init_params(cfg, torch.float32, 11, "cpu"), model_dir, cfg)
        float_runs = {}
        for mode, extra in (("loop", []), ("kv_cache", ["--kv_cache", "true"])):
            args = ["--dtype", "float32", "--num_gen_token", "3", "--block_size", "4", *extra]
            gpu, gpu_up, gpu_stats = run_cli(model_dir, work, f"cross_gpu_{name}_{mode}", prompts,
                                             [*args, "--device", "cuda"], 512)
            cpu, cpu_up, _ = run_cli(model_dir, work, f"cross_cpu_{name}_{mode}", prompts,
                                     [*args, "--device", "cpu"], 512)
            err = max(float(np.abs(g - c).max()) for g, c in zip(gpu, cpu))
            if not all(np.allclose(g, c, atol=1e-4, rtol=0) for g, c in zip(gpu, cpu)):
                fail(f"cross-check {name} {mode}: card and CPU scores differ by {err:.3e}")
            if any((g.argmax(-1) != c.argmax(-1)).any() for g, c in zip(gpu, cpu)) or gpu_up != cpu_up:
                fail(f"cross-check {name} {mode}: greedy tokens differ between card and CPU")
            log(f"[cross] float32 {name} {mode}: card vs CPU max_abs_err {err:.3e}, "
                "greedy tokens identical"
                + (" " + json.dumps({k: gpu_stats.get(k) for k in DECODE_KEYS}) if extra else ""))
            float_runs[mode] = (args, gpu, gpu_up)
        if name == "llama":
            args = ["--dtype", "float32", "--max_new_tokens", "3", "--block_size", "4",
                    "--max_wave_requests", "2"]
            gpu, gpu_up, gpu_stats = run_serve(model_dir, work, f"cross_gpu_{name}_serve", prompts,
                                               [*args, "--device", "cuda"], 512)
            kvpool.reset_process_pools()  # the CPU run prefills its own prefixes
            cpu, cpu_up, _ = run_serve(model_dir, work, f"cross_cpu_{name}_serve", prompts,
                                       [*args, "--device", "cpu"], 512)
            err = max(float(np.abs(g - c).max()) for g, c in zip(gpu, cpu))
            if not all(np.allclose(g, c, atol=1e-4, rtol=0) for g, c in zip(gpu, cpu)):
                fail(f"cross-check {name} serve: card and CPU scores differ by {err:.3e}")
            if gpu_up != cpu_up or gpu_stats["completed"] != len(prompts):
                fail(f"cross-check {name} serve: tokens differ between card and CPU, or requests "
                     f"were lost ({gpu_stats['completed']} of {len(prompts)} completed)")
            log(f"[cross] float32 {name} serve: card vs CPU max_abs_err {err:.3e}, tokens "
                f"identical; card prefills {gpu_stats['prefills']}, sweeps {gpu_stats['sweeps']}")
            cross_tenants(work, model_dir, prompts)
        if name in CROSS_SERVE:
            cross_serve(work, name, model_dir, prompts, draft_dir)
        if name in CROSS_QUANTIZED:
            for dt in ("int8", "int4"):
                qdir = os.path.join(work, f"cross_{name}_{dt}")
                requantize_native(model_dir, qdir, dtype=dt)
                for mode, extra in (("loop", []), ("kv_cache", ["--kv_cache", "true"])):
                    qargs = ["--dtype", "float32", "--num_gen_token", "3", "--block_size", "4",
                             *extra]
                    qgpu, qgpu_up, _ = run_cli(qdir, work, f"cross_gpu_{name}_{dt}_{mode}",
                                               prompts, [*qargs, "--device", "cuda"], 512)
                    qcpu, qcpu_up, _ = run_cli(qdir, work, f"cross_cpu_{name}_{dt}_{mode}",
                                               prompts, [*qargs, "--device", "cpu"], 512)
                    err = max(float(np.abs(g - c).max()) for g, c in zip(qgpu, qcpu))
                    if not all(np.allclose(g, c, atol=1e-4, rtol=0) for g, c in zip(qgpu, qcpu)):
                        fail(f"cross-check {name} {dt} {mode}: card and CPU scores differ by "
                             f"{err:.3e}")
                    if qgpu_up != qcpu_up:
                        fail(f"cross-check {name} {dt} {mode}: tokens differ between card and CPU")
                    log(f"[cross] float32 {name} {dt} {mode}: card vs CPU max_abs_err {err:.3e}, "
                        "tokens identical")
        if name in CROSS_SPECULATIVE:
            # Against the float checkpoint's --kv_cache run on the card.
            # Fused steps take precedence over speculation: turned off here.
            kv_args, kv, kv_up = float_runs["kv_cache"]
            spec, spec_up, stats = run_cli(
                model_dir, work, f"cross_gpu_{name}_spec", prompts,
                [*kv_args, "--device", "cuda", "--speculative_k", "4", "--decode_fused", "off"], 512)
            if stats.get("decode_speculative") != 1.0 or stats.get("decode_resident") != 1.0:
                fail(f"cross-check {name}: speculative decode did not engage: {stats}")
            err = max(float(np.abs(g - c).max()) for g, c in zip(spec, kv))
            if spec_up != kv_up or not all(np.allclose(g, c, atol=1e-4, rtol=0)
                                           for g, c in zip(spec, kv)):
                fail(f"cross-check {name}: --speculative_k 4 differs from --kv_cache "
                     f"(tokens equal: {spec_up == kv_up}, max_abs_err {err:.3e})")
            log(f"[cross] float32 {name} --speculative_k 4 on the card: the tokens of --kv_cache, "
                f"max_abs_err {err:.3e}; passes {stats.get('spec_passes')}, drafted "
                f"{stats.get('spec_drafted')}, accepted {stats.get('spec_accepted')}")


# A fresh CLI process with chip_smoke's tokenizer (argv: the CLI's arguments).
_CLI_PROCESS = (
    "import sys; sys.path.insert(0, sys.argv[1]); from chip_smoke import BenchTokenizer; "
    "from flexible_llm_sharding_tpu_torch import cli; "
    "cli.main(sys.argv[3:], tokenizer=BenchTokenizer(int(sys.argv[2])))"
)


def phase_host(work: str) -> None:
    """The host path on a reduced bf16 checkpoint (Llama-2-7B widths, 2
    decoder layers): defaults against everything off, bit for bit, for the
    re-scoring loop and --kv_cache; then the rot drill."""
    from flexible_llm_sharding_tpu_torch import cli
    from flexible_llm_sharding_tpu_torch.config import LlamaConfig
    from flexible_llm_sharding_tpu_torch.integrity.manifest import ShardCorruptError
    from flexible_llm_sharding_tpu_torch.utils.checkpoint import save_params

    cfg = LlamaConfig(num_hidden_layers=2)
    model_dir = os.path.join(work, "host")
    save_params(_init_params(cfg, torch.bfloat16, 5, "cuda"), model_dir, cfg)
    prompts = make_prompts(4, 200, 3, 16, seed=4)
    common = ["--dtype", "bfloat16", "--device", "cuda", "--num_gen_token", "3"]
    off = ["--host_cache_gb", "0", "--verify_weights", "false", "--readahead_threads", "0"]
    for mode, extra in (("loop", []), ("kv_cache", ["--kv_cache", "true"])):
        fresh_process_state()
        on, on_up, on_stats = run_cli(model_dir, work, f"host_on_{mode}", prompts,
                                      [*common, *extra], cfg.vocab_size)
        fresh_process_state()
        plain, plain_up, _ = run_cli(model_dir, work, f"host_off_{mode}", prompts,
                                     [*common, *extra, *off], cfg.vocab_size)
        if not all(np.array_equal(a, b) for a, b in zip(on, plain)) or on_up != plain_up:
            fail(f"host {mode}: the defaults' scores differ from everything off")
        log(f"[host] {mode}: defaults and --host_cache_gb 0 --verify_weights false "
            "--readahead_threads 0 give identical scores and tokens; defaults "
            + json.dumps({k: on_stats.get(k) for k in HOST_KEYS}))
    # Rot drill: a warm process (every shard cached, every file verified),
    # one flipped payload byte, the same run again.
    fresh_process_state()
    args = [*common, "--io_retry_base_s", "0"]
    run_cli(model_dir, work, "host_warm", prompts, args, cfg.vocab_size)
    path = os.path.join(model_dir, "model.layers.1.safetensors")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) - 1001)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0x20]))
    try:
        run_cli(model_dir, work, "host_rot", prompts, args, cfg.vocab_size)
        fail("host: a flipped byte went through a warm process unnoticed")
    except ShardCorruptError as e:
        log(f"[host] warm process after a flipped byte: ShardCorruptError: {str(e)[:160]}")
    ppkl = os.path.join(work, "host_rot.pkl")
    proc = subprocess.run(
        [sys.executable, "-c", _CLI_PROCESS, HERE, str(cfg.vocab_size), "--model_path", model_dir,
         "--prompt_pickle", ppkl, "--output_file", os.path.join(work, "host_rot_cli.pkl"),
         "--disk_folder", os.path.join(work, "host_disk"), *args],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    if proc.returncode == 0 or "ShardCorruptError" not in proc.stderr:
        fail(f"host: the CLI exited {proc.returncode} on a flipped byte:\n{proc.stderr[-3000:]}")
    log(f"[host] a fresh CLI process on the flipped byte exits {proc.returncode}: "
        + proc.stderr.strip().splitlines()[-1][:200])
    try:
        cli.main(["verify", "--model_path", model_dir])
        fail("host: verify passed a rotted directory")
    except SystemExit as e:
        if e.code != 2:
            fail(f"host: verify exited {e.code} on a rotted directory")
    log("[host] verify on the rotted directory exits 2")
    fresh_process_state()
    shutil.rmtree(model_dir, ignore_errors=True)


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


STAT_KEYS = ("wall_s", "tokens_processed", "tokens_per_sec", "streamed_bytes", "peak_mem_gb",
             "source_wait_s", "load_weights_time_s", "compute_wall_s", "decode_resident",
             "decode_kv_on_device", "decode_fused", "decode_graph")
DECODE_KEYS = ("decode_resident", "decode_kv_on_device", "decode_fused", "decode_graph",
               "decode_speculative")


def check_decode_modes(tag: str, stats: dict, cfg) -> None:
    """A full-width --kv_cache run with the defaults: weights resident, KV
    on the card, fused steps, captured as CUDA graphs unless the model has
    MoE layers."""
    from flexible_llm_sharding_tpu_torch.utils.metrics import has_moe_layers

    want = {"decode_resident": 1.0, "decode_kv_on_device": 1.0, "decode_fused": 1.0,
            "decode_graph": 0.0 if has_moe_layers(cfg) else 1.0, "decode_speculative": 0.0}
    got = {k: stats.get(k) for k in DECODE_KEYS}
    if got != want:
        fail(f"{tag}: decode modes {got}, expected {want}")


def phase_full(work: str, name: str, cfg, prompts, n_gen_loop: int, n_gen_kv: int,
               model_dir: str | None = None, compare_modes: bool = False,
               record: dict | None = None, payload: int | None = None) -> dict:
    """A seeded bf16 checkpoint of ``cfg`` (one layer per shard, so every
    layer streams; written here unless ``model_dir`` holds one) through the
    CLI: scoring, then --kv_cache. Every kernel of each run must launch;
    with local layers (a window or a chunk) a kernel must launch with the
    local form on and with it off where it applies (the scoring kernels
    when it binds at the prompts' bucket, decode always), else never with
    it on. With ``payload`` (the checkpoint's tensor bytes) every run must
    stream exactly that per weight pass. Under MLA the scoring
    kernels must launch at the model's (qk, v) head dims only and the decode
    kernel never (MLA decode is the plain op's, as in the JAX package).
    The --kv_cache run must have the decode modes engaged
    (:func:`check_decode_modes`) and stream one weight pass; with
    ``compare_modes`` it must equal --decode_fused off and
    --decode_resident off bit for bit. With ``record`` (a dict) the
    checkpoint is kept and ``record[tag]`` gets each run's (scores,
    updated prompts, stats). Returns per kernel its launches and its
    launches with the window on."""
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
    kv = ["--num_gen_token", str(n_gen_kv), "--kv_cache", "true"]
    runs = [
        ("scoring", ["--num_gen_token", str(n_gen_loop)], n_gen_loop, scoring),
        ("kv_cache", kv, n_gen_kv, scoring if mla else fa.KERNELS),
    ]
    if compare_modes:
        runs += [("kv_cache_fused_off", [*kv, "--decode_fused", "off"], n_gen_kv, fa.KERNELS),
                 ("kv_cache_resident_off", [*kv, "--decode_resident", "off"], n_gen_kv,
                  fa.KERNELS)]
    local_size = cfg.sliding_window or cfg.attention_chunk_size
    bucket = main_path_case(prompts, n_gen_kv)
    binds = local_size is not None and bucket["Lp"] + bucket["Ls"] > local_size

    def mixed(kernel: str) -> bool:  # local on in some launches and off in others
        return local_size is not None and (binds or kernel == "flash_decode_attention")

    outputs = {}
    try:
        for tag, extra, n_gen, needed in runs:
            fresh_process_state()
            fa.reset_launch_counts()
            scores, updated, stats = run_cli(model_dir, work, f"full_{name}_{tag}", prompts,
                                             [*common, *extra], cfg.vocab_size)
            counts, local = fa.launch_counts(), fa.local_launch_counts()
            dims = fa.dim_launch_counts()
            _check_scores(scores, prompts, n_gen, cfg.vocab_size, f"{name} {tag}")
            outputs[tag] = (scores, updated)
            if record is not None:
                record[tag] = (scores, updated, stats)
                record[f"{tag}_launches"] = dict(counts)
            if tag == "kv_cache":
                check_decode_modes(f"full {name} {tag}", stats, cfg)
            elif tag != "scoring":
                ref, ref_up = outputs["kv_cache"]
                if not all(np.array_equal(a, b) for a, b in zip(ref, scores)) or ref_up != updated:
                    fail(f"full {name}: the defaults' --kv_cache scores differ from {tag}")
                log(f"[full] {name} {tag}: scores and tokens equal the defaults' bit for bit")
            missing = [k for k in needed if counts[k] == 0]
            if missing:
                fail(f"full {name} {tag}: kernels never launched on the main path: {missing}")
            if mla and (counts["flash_decode_attention"]
                        or any(set(dims[k]) != {(cfg.head_dim, cfg.v_dim)} for k in scoring)):
                fail(f"full {name} {tag}: MLA launches by (qk, v) head dims {dims}: the scoring "
                     f"kernels must run at ({cfg.head_dim}, {cfg.v_dim}) only and decode never")
            if any(local[k] == 0 or local[k] == counts[k] for k in needed if mixed(k)):
                fail(f"full {name} {tag}: a kernel did not launch both with and without its local "
                     f"form: {counts} (local on: {local})")
            if any(local[k] for k in fa.KERNELS if not mixed(k)):
                fail(f"full {name} {tag}: a local form reached a kernel where none applies: {local}")
            for k in counts:
                launches[k]["launches"] += counts[k]
                launches[k]["local_launches"] += local[k]
            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20  # KiB -> GiB
            log(f"[full] {name} {tag} stats " + json.dumps({**{k: stats.get(k) for k in STAT_KEYS},
                                                           "host_peak_rss_gib": rss}))
            passes = 1 if stats.get("decode_resident") else n_gen
            host = check_host_path(f"full {name} {tag}", stats, model_dir, cfg, passes)
            log(f"[full] {name} {tag} host " + json.dumps(host))
            if payload is not None and stats["streamed_bytes"] != payload * passes:
                fail(f"full {name} {tag}: streamed {stats['streamed_bytes']} bytes in {passes} "
                     f"pass(es) of a {payload}-byte checkpoint")
            log(f"[full] {name} {tag} kernels " + json.dumps(counts) + " window on "
                + json.dumps(local) + " by (qk, v) head dims "
                + json.dumps({k: {f"{a}/{b}": n for (a, b), n in v.items()} for k, v in dims.items()}))
    finally:
        if record is None:
            shutil.rmtree(model_dir, ignore_errors=True)
    return launches


# The JAX tests' bounds on a quantized copy's largest probability difference
# from the float run (tests/test_quantized.py:162 for int8, :614 for int4;
# the mixed copy holds int4 layers).
QUANT_BOUNDS = {"int8": 0.05, "int4": 0.15, "mixed": 0.15}


def _dir_bytes(model_dir: str) -> int:
    return sum(os.path.getsize(os.path.join(model_dir, f)) for f in os.listdir(model_dir)
               if f.endswith(".safetensors"))


# The quantized runs' common flags: bf16 compute, every layer its own shard.
QUANT_COMMON = ["--dtype", "bfloat16", "--layer_num_per_shard", "1", "--device", "cuda"]


def quant_run(work: str, name: str, model_dir: str, cfg, prompts, tag: str, extra: list[str],
              n_gen: int, ref: tuple, bound: float, needed, record: dict | None = None) -> dict:
    """One CLI run of a quantized copy: finite distributions summing to 1,
    every kernel in ``needed`` launched, and every probability of the first
    generated position within ``bound`` of the bf16 run ``ref`` (scores,
    updated, stats). Later positions follow each run's own picks, which
    seeded random weights may tie differently. Keeps (scores, updated) in
    ``record[tag]`` and returns its launch counts."""
    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa

    fresh_process_state()
    fa.reset_launch_counts()
    scores, updated, stats = run_cli(model_dir, work, f"quant_{name}_{tag}", prompts,
                                     [*QUANT_COMMON, *extra], cfg.vocab_size)
    if record is not None:
        record[tag] = (scores, updated)
    counts, local = fa.launch_counts(), fa.local_launch_counts()
    _check_scores(scores, prompts, n_gen, cfg.vocab_size, f"quant {name} {tag}")
    missing = [k for k in needed if counts[k] == 0]
    if missing:
        fail(f"quant {name} {tag}: kernels never launched on the main path: {missing}")
    ref_scores, ref_up, ref_stats = ref
    err = max(float(np.abs(a[:, 0] - b[:, 0]).max()) for a, b in zip(scores, ref_scores))
    if not err < bound:
        fail(f"quant {name} {tag}: first-position probabilities differ from the bf16 run's by "
             f"{err:.4f}, over the bound {bound}")
    same = sum(a == b for a, b in zip(updated, ref_up))
    keys = ("wall_s", "streamed_bytes", "load_weights_time_s", "source_wait_s", "compute_wall_s",
            "peak_mem_gb", "host_cache_hits", "host_cache_misses")
    log(f"[quant] {name} {tag}: max |p - p_bf16| at the first position {err:.3e} (bound {bound}); "
        f"{same} of {len(prompts)} prompts' generated text equal to bf16's; streamed bytes "
        f"{stats['streamed_bytes'] / ref_stats['streamed_bytes']:.4f}x bf16's; "
        + json.dumps({"run": {k: stats.get(k) for k in keys},
                      "bf16": {k: ref_stats.get(k) for k in keys}}))
    return {k: {"launches": counts[k], "local_launches": local[k]} for k in fa.KERNELS}


def write_dequantized_copy(qdir: str, out: str) -> str:
    """Every layer of the quantized checkpoint ``qdir`` dequantized to bf16
    on the host (``checkpoint.dequantize_tree``), written with its
    ``integrity.json``: the weights the weight source must give on the card."""
    from flexible_llm_sharding_tpu_torch.integrity import manifest
    from flexible_llm_sharding_tpu_torch.utils import checkpoint

    os.makedirs(out, exist_ok=True)
    shutil.copy(os.path.join(qdir, "config.json"), out)
    entries = {}
    for fn in sorted(os.listdir(qdir)):
        if fn.endswith(".safetensors"):
            name = fn[: -len(".safetensors")]
            tree = checkpoint.dequantize_tree(checkpoint.load_layer(qdir, name), torch.bfloat16)
            flat = dict(checkpoint.flatten(tree))
            checkpoint.write_safetensors(os.path.join(out, fn), flat)
            entries[name] = manifest.layer_entry(flat, fn)
    manifest.write_manifest(out, entries)
    return out


def check_card_dequant(qdir: str, name: str) -> None:
    """One layer of a quantized checkpoint dequantized to bf16 on the card as
    the weight source does (``checkpoint.dequantize`` of the uploaded
    leaf-group) against the host's dequant, bit for bit: each 2-D kernel
    whole, and the first, middle and last expert of each expert stack."""
    from flexible_llm_sharding_tpu_torch.utils import checkpoint

    t0 = time.perf_counter()
    checked = []

    def walk(node, path):
        if checkpoint.is_quantized_leaf(node):
            kind = checkpoint.quant_kind(node)
            card = checkpoint.dequantize({k: v.cuda() for k, v in node.items()}, torch.bfloat16)
            n = node[kind].shape[0]
            picks = [None] if node[kind].ndim < 3 else sorted({0, n // 2, n - 1})
            for e in picks:
                host = checkpoint.dequantize(node if e is None else {k: v[e] for k, v in node.items()},
                                             torch.bfloat16)
                got = (card if e is None else card[e]).cpu()
                if not torch.equal(got.view(torch.int16), host.view(torch.int16)):
                    fail(f"quant: {name} {path} ({kind}{'' if e is None else f', expert {e}'}): "
                         "the card's dequant differs from the host's")
            checked.append(f"{path} {kind} {list(card.shape)}")
            del card
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k)

    walk(checkpoint.load_layer(qdir, name), "")
    if not checked:
        fail(f"quant: {name} of {qdir} holds no quantized kernel")
    log(f"[quant] {name}: the card's dequant equals the host's bit for bit on "
        f"{len(checked)} kernels ({time.perf_counter() - t0:.3f} s): " + "; ".join(checked))


def _add_launches(total: dict, more: dict) -> dict:
    for k, v in more.items():
        t = total.setdefault(k, {"launches": 0, "local_launches": 0})
        t["launches"] += v["launches"]
        t["local_launches"] += v["local_launches"]
    return total


def phase_quant(work: str, model_dir: str, cfg, prompts, bf16_runs: dict, n_gen_loop: int,
                n_gen_kv: int) -> dict:
    """The 4-layer Llama-2-7B bf16 checkpoint's int8 and int4 copies
    (``requantize_native``) and a mixed copy planned by ``plan-precision``
    on the card under a budget halfway between the int4 and the bf16 bytes
    (written by its ``--apply`` and audited by ``verify``), each through
    scoring and --kv_cache against the bf16 runs (:func:`quant_run`); then
    the int4 copy's host dequant (:func:`write_dequantized_copy`) through
    the same runs, which must give the int4 runs' scores and tokens bit for
    bit. Returns the quantized runs' kernel launches."""
    from flexible_llm_sharding_tpu_torch import cli
    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa
    from flexible_llm_sharding_tpu_torch.utils.checkpoint import requantize_native

    copies = {}
    for dt in ("int8", "int4"):
        copies[dt] = os.path.join(work, f"llama_{dt}")
        t0 = time.perf_counter()
        requantize_native(model_dir, copies[dt], dtype=dt)
        log(f"[quant] requantize_native {dt}: {_dir_bytes(copies[dt])} bytes from "
            f"{_dir_bytes(model_dir)} in {time.perf_counter() - t0:.3f} s")
    calib = os.path.join(work, "calib.pkl")
    with open(calib, "wb") as f:
        pickle.dump(prompts[:1], f)  # one prompt's four suffixes: four calibration rows
    budget_gb = (_dir_bytes(model_dir) + _dir_bytes(copies["int4"])) / 2 / 1e9
    copies["mixed"] = os.path.join(work, "llama_mixed")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["plan-precision", "--model_path", model_dir, "--calib_pickle", calib,
                  "--bytes_budget_gb", f"{budget_gb:.9f}", "--json", "--apply", copies["mixed"]],
                 tokenizer=BenchTokenizer(cfg.vocab_size))
    plan = json.loads(buf.getvalue())
    counts = {d: list(plan["layers"].values()).count(d) for d in ("bf16", "int8", "int4")}
    log(f"[quant] plan-precision on the card in {time.perf_counter() - t0:.3f} s, budget "
        f"{budget_gb:.6f} GB: {counts}, est_bytes {plan['est_bytes']} of {plan['baseline_bytes']}, "
        f"measured divergence {plan['measured_divergence']:.3e}, cap {plan['divergence_cap']:.3e}; "
        f"{json.dumps(plan['layers'])}")
    if plan["est_bytes"] > budget_gb * 1e9:
        fail(f"quant: the plan's {plan['est_bytes']} bytes exceed its budget")
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["verify", "--model_path", copies["mixed"]])
    except SystemExit as e:
        fail(f"quant: verify found problems in the mixed checkpoint (exit {e.code}):\n"
             + buf.getvalue())
    log("[quant] verify on the mixed checkpoint: " + buf.getvalue().strip().splitlines()[-1])
    launches: dict = {}
    runs = (("scoring", ["--num_gen_token", str(n_gen_loop)], n_gen_loop,
             ("flash_causal_attention", "flash_prefix_shared_attention")),
            ("kv_cache", ["--num_gen_token", str(n_gen_kv), "--kv_cache", "true"], n_gen_kv,
             fa.KERNELS))
    outputs: dict = {}
    deq = os.path.join(work, "llama_int4_dequantized")
    try:
        for dt, qdir in copies.items():
            for tag, extra, n_gen, needed in runs:
                _add_launches(launches, quant_run(work, dt, qdir, cfg, prompts, tag, extra, n_gen,
                                                  bf16_runs[tag], QUANT_BOUNDS[dt], needed,
                                                  record=outputs.setdefault(dt, {})))
        t0 = time.perf_counter()
        write_dequantized_copy(copies["int4"], deq)
        log(f"[quant] wrote the int4 copy's host dequant as bf16 ({_dir_bytes(deq)} bytes) in "
            f"{time.perf_counter() - t0:.3f} s")
        for tag, extra, _, _ in runs:
            fresh_process_state()
            scores, updated, _ = run_cli(deq, work, f"quant_int4_dequantized_{tag}", prompts,
                                         [*QUANT_COMMON, *extra], cfg.vocab_size)
            q_scores, q_up = outputs["int4"][tag]
            if updated != q_up or not all(np.array_equal(a, b) for a, b in zip(scores, q_scores)):
                err = max(float(np.abs(a - b).max()) for a, b in zip(scores, q_scores))
                fail(f"quant int4 {tag}: the host-dequantized bf16 copy differs from the int4 run "
                     f"(tokens equal: {updated == q_up}, max_abs_err {err:.3e})")
            log(f"[quant] int4 {tag}: the host-dequantized bf16 copy gives the int4 run's scores "
                "and tokens bit for bit")
    finally:
        for qdir in (*copies.values(), deq):
            shutil.rmtree(qdir, ignore_errors=True)
    return launches


# A CLI process whose every shard starts one second late, so that its
# marker can be read after its second shard and the process killed mid-run
# (argv as _CLI_PROCESS's).
_SLOW_CLI_PROCESS = (
    "import sys, time; sys.path.insert(0, sys.argv[1]); from chip_smoke import BenchTokenizer; "
    "from flexible_llm_sharding_tpu_torch import cli; "
    "from flexible_llm_sharding_tpu_torch.runtime.activations import ActivationStore; "
    "late = ActivationStore.set_shard; "
    "ActivationStore.set_shard = lambda self, i: (time.sleep(1.0), late(self, i))[1]; "
    "cli.main(sys.argv[3:], tokenizer=BenchTokenizer(int(sys.argv[2])))"
)


def _flip_bit(path: str, offset_from_end: int = 1001) -> None:
    pos = max(0, os.path.getsize(path) - offset_from_end)
    with open(path, "r+b") as f:
        f.seek(pos)
        byte = f.read(1)
        f.seek(pos)
        f.write(bytes([byte[0] ^ 0x20]))


@contextlib.contextmanager
def watch_calls():
    """Record, while inside, what the serve path hands the attention
    wrappers (the query shape of every causal and prefix-shared call, as
    ``models/llama.py`` makes them), every speculative verify pass
    (``SpecVerifier.finish_pass``), and the draft model's construction and
    drafting seconds (host clock, each ``propose`` ending in its picks on the
    host). Observation only: every call goes through to the real one."""
    from flexible_llm_sharding_tpu_torch.models import llama
    from flexible_llm_sharding_tpu_torch.runtime import decode, draft

    seen = {"causal": [], "prefix_shared": [], "verify_passes": 0, "draft_init_s": 0.0,
            "draft_propose_s": 0.0}
    real = (llama.flash_causal_attention, llama.flash_prefix_shared_attention,
            decode.SpecVerifier.finish_pass, draft.DraftModel.__init__, draft.DraftModel.propose)

    def causal(q, *a, **kw):
        seen["causal"].append(tuple(q.shape))
        return real[0](q, *a, **kw)

    def prefix_shared(q, *a, **kw):
        seen["prefix_shared"].append(tuple(q.shape))
        return real[1](q, *a, **kw)

    def finish_pass(self, dist):
        seen["verify_passes"] += 1
        return real[2](self, dist)

    def timed(key, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                seen[key] += time.perf_counter() - t0
        return call

    llama.flash_causal_attention, llama.flash_prefix_shared_attention = causal, prefix_shared
    decode.SpecVerifier.finish_pass = finish_pass
    draft.DraftModel.__init__ = timed("draft_init_s", real[3])
    draft.DraftModel.propose = timed("draft_propose_s", real[4])
    try:
        yield seen
    finally:
        llama.flash_causal_attention, llama.flash_prefix_shared_attention = real[:2]
        decode.SpecVerifier.finish_pass = real[2]
        draft.DraftModel.__init__, draft.DraftModel.propose = real[3:]


def _new_tokens(updated: tuple, prompt: tuple) -> list[list[str]]:
    """Per suffix, the generated token ids of a served run, from its text."""
    return [re.findall(r" tok(\d+)", u[len(s):]) for u, s in zip(updated[1], prompt[1])]


def serve_jsonl(model_dir: str, lines_before: list, lines_after: list, extra: list[str],
                vocab: int, active_before: int) -> tuple[list, dict]:
    """The ``serve`` JSONL frontend in-process: ``lines_before`` on stdin, then,
    once ``active_before`` requests are in flight at the end of a sweep,
    ``lines_after``. Returns the reply lines and the stats."""
    import threading

    from flexible_llm_sharding_tpu_torch import cli
    from flexible_llm_sharding_tpu_torch.serve import engine as serve_engine

    ready = threading.Event()
    real = serve_engine.ServeEngine._post_sweep

    def post_sweep(self, wall):
        real(self, wall)
        if self.batcher.active_requests >= active_before:
            ready.set()

    def stdin():
        yield from (json.dumps(d) + "\n" for d in lines_before)
        if not ready.wait(300):
            fail(f"serve jsonl: {active_before} requests were never in flight together")
        yield from (json.dumps(d) + "\n" for d in lines_after)

    out = io.StringIO()
    old_stdin = sys.stdin
    serve_engine.ServeEngine._post_sweep = post_sweep
    sys.stdin = stdin()
    try:
        with contextlib.redirect_stdout(out):
            stats = cli.main(["serve", "--model_path", model_dir, "--stats_interval_s", "0",
                              *extra], tokenizer=BenchTokenizer(vocab))
    finally:
        sys.stdin = old_stdin
        serve_engine.ServeEngine._post_sweep = real
    return [json.loads(x) for x in out.getvalue().splitlines() if x.strip()], stats


def phase_serve(work: str, model_dir: str, cfg, prompts, n_gen: int, smi: str,
                record: dict | None = None) -> dict:
    """The ``serve`` subcommand on the 4-layer Llama-2-7B cell (see the
    module doc): the batch CLI's --kv_cache --block_size 2 run as the
    reference, then the default engine, --decode_resident off and a
    pool-reuse round of the prompts twice; then the scheduler's runs
    (sched_parity, sched_coalesce, sched_preempt) and the speculative ones
    (spec_lookup, spec_draft). Returns the kernel launches of the three
    groups of runs by path name; ``record["default"]`` gets the default
    engine's (scores, updated prompts, stats)."""
    from flexible_llm_sharding_tpu_torch.config import LlamaConfig
    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa

    common = ["--dtype", "bfloat16", "--layer_num_per_shard", "1", "--device", "cuda",
              "--block_size", "2"]
    serve_args = [*common, "--max_new_tokens", str(n_gen), "--max_wave_requests", "2"]
    n_layers = cfg.num_hidden_layers
    paths = {"llama2_7b_serve": {}, "llama2_7b_serve_sched": {}, "llama2_7b_serve_spec": {}}

    def same(a, b):
        return all(np.array_equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)

    # The kernels at the serve path's own shapes, against their plain
    # versions: a wave block of 2 rows (32/32 heads, Lp 576, Ls 64, T n_gen-1),
    # and the reuse path's prefix K/V from an uploaded pool stack, one layer
    # per shard as this phase runs it and two (a slice at an offset).
    gen = torch.Generator(device="cuda").manual_seed(4321)
    block = main_path_case(prompts[:2], n_gen)
    check_case("serve block of 2", block, torch.bfloat16, gen)
    pooled = ("flash_prefix_shared_attention", "flash_decode_attention")
    for k in (1, 2):
        check_case(f"serve block of 2, pooled prefix KV of a {k}-layer stack", block,
                   torch.bfloat16, gen, kernels=pooled, pooled_layers=k)

    def report(tag, stats, counts, **more):
        pool = stats.get("kvpool", {})
        line = {
            "wall_s": stats["wall_s"], "tokens_per_sec": stats["tokens_per_sec"],
            "ttft_mean_s": stats["ttft_s"].get("mean"), "ttft_p95_s": stats["ttft_s"].get("p95"),
            "token_latency_mean_s": stats["token_latency_s"].get("mean"),
            "token_latency_p95_s": stats["token_latency_s"].get("p95"),
            "queue_depth_after_submit": stats.get("queue_depth_after_submit"),
            "pool_pages": pool.get("pages_resident"), "pool_bytes": pool.get("bytes_resident"),
            "prefix_reuse_hits": pool.get("prefix_reuse_hits"),
            "admitted": stats["admitted"], "completed": stats["completed"],
            "prefills": stats["prefills"], "sweeps": stats["sweeps"],
            "tokens_emitted": stats["tokens_emitted"],
            "streamed_bytes": stats["stream"]["streamed_bytes"],
            "peak_mem_gb": stats.get("peak_mem_gb"), "kernels": counts, **more,
        }
        log(f"[serve] {tag} | {smi} | " + json.dumps(line))

    def served(tag, pp, extra, path="llama2_7b_serve", n_new=n_gen):
        fresh_process_state()
        with watch_calls() as seen:
            fa.reset_launch_counts()
            scores, updated, stats = run_serve(model_dir, work, f"serve_{tag}", pp,
                                               [*serve_args, *extra], cfg.vocab_size)
            counts, local = fa.launch_counts(), fa.local_launch_counts()
        _add_launches(paths[path], {k: {"launches": counts[k], "local_launches": local[k]}
                                    for k in counts})
        _check_scores(scores, pp, n_new, cfg.vocab_size, f"serve {tag}")
        if stats["admitted"] != len(pp) or stats["completed"] != len(pp):
            fail(f"serve {tag}: admitted {stats['admitted']}, completed {stats['completed']} "
                 f"of {len(pp)}")
        return scores, updated, stats, counts, seen

    fresh_process_state()
    t0 = time.perf_counter()
    ref, ref_up, ref_stats = run_cli(model_dir, work, "serve_offline", prompts,
                                     [*common, "--kv_cache", "true", "--num_gen_token",
                                      str(n_gen)], cfg.vocab_size)
    log(f"[serve] offline --kv_cache --block_size 2 | {smi} | wall "
        f"{time.perf_counter() - t0:.3f} s, " + json.dumps({k: ref_stats.get(k) for k in STAT_KEYS}))

    scores, updated, stats, counts, _ = served("default", prompts, [])
    report("default", stats, counts)
    if not 2 <= stats["prefills"] < len(prompts) or stats["sweeps"] <= stats["prefills"]:
        fail(f"serve default: prefills {stats['prefills']}, sweeps {stats['sweeps']}: the waves "
             "did not join a run in progress")
    if not same(scores, ref) or updated != ref_up:
        err = max(float(np.abs(a - b).max()) for a, b in zip(scores, ref))
        fail(f"serve default: scores differ from the offline --kv_cache run (max_abs_err "
             f"{err:.3e}, tokens equal: {updated == ref_up})")
    log("[serve] default: the offline --kv_cache --block_size 2 run's scores and tokens bit for "
        "bit")
    if record is not None:
        record["default"] = (scores, updated, stats)

    streamed, streamed_up, s_stats, s_counts, _ = served("streamed", prompts,
                                                         ["--decode_resident", "off"])
    report("streamed", s_stats, s_counts)
    one_pass = payload_bytes(cfg)
    if not same(streamed, scores) or streamed_up != updated:
        fail("serve --decode_resident off: scores differ from the default engine's")
    if s_stats["stream"]["streamed_bytes"] <= one_pass:
        fail(f"serve --decode_resident off streamed {s_stats['stream']['streamed_bytes']} bytes, "
             f"not more than one {one_pass}-byte pass")
    log(f"[serve] --decode_resident off: the default engine's scores bit for bit, "
        f"{s_stats['stream']['streamed_bytes'] / one_pass:.2f} passes streamed")

    twice, twice_up, t_stats, t_counts, _ = served("pool_reuse", prompts + prompts, [])
    report("pool_reuse", t_stats, t_counts)
    n = len(prompts)
    reused = t_stats["kvpool"]["prefix_reuse_hits"]
    if reused < 1:
        fail("serve pool reuse: no sealed entry was reused")
    if not same(twice[n:], twice[:n]) or twice_up[n:] != twice_up[:n]:
        fail("serve pool reuse: the second round's scores differ from the first round's")
    # A reused block's layers launch the prefix-shared kernel without the
    # causal one: n_layers launches per reused block.
    extra_ps = t_counts["flash_prefix_shared_attention"] - t_counts["flash_causal_attention"]
    if extra_ps < n_layers or extra_ps % n_layers:
        fail(f"serve pool reuse: {extra_ps} prefix-shared launches beyond the full prefills' "
             f"for {reused} reused entries of {n_layers} layers: the suffix-only path did not "
             "run the kernel")
    log(f"[serve] pool reuse: {reused} entries reused, the second round's scores bit for bit, "
        f"{extra_ps} prefix-shared launches on the suffix-only path")

    # -- the scheduler ------------------------------------------------------
    sched_path = "llama2_7b_serve_sched"
    par, par_up, p_stats, p_counts, _ = served("sched_parity", prompts, ["--sched"], sched_path)
    report("sched_parity", p_stats, p_counts, sched=p_stats.get("sched"))
    if not same(par, scores) or par_up != updated:
        fail("serve --sched (one tenant, class standard): scores differ from the default "
             "engine's")
    log("[serve] sched_parity: the default engine's scores and tokens bit for bit")

    reqs = coalesce_requests()
    _, _, c_stats, c_counts, c_seen = served("sched_coalesce", reqs,
                                             ["--sched", "--max_wave_requests", "4"], sched_path)
    c_sched = c_stats.get("sched", {})
    report("sched_coalesce", c_stats, c_counts, sched=c_sched)
    ps_s = sorted({q[1] for q in c_seen["prefix_shared"]})
    if (c_sched.get("coalesced_requests") != len(reqs) or c_stats["prefills"] != 2
            or not c_sched.get("prefill_kv_bytes_saved", 0) > 0 or ps_s != [8]):
        fail(f"serve sched_coalesce: coalesced_requests {c_sched.get('coalesced_requests')}, "
             f"prefills {c_stats['prefills']}, prefill_kv_bytes_saved "
             f"{c_sched.get('prefill_kv_bytes_saved')}, prefix-shared S {ps_s}: want 8, 2, > 0, "
             "[8]")
    log(f"[serve] sched_coalesce: {len(reqs)} requests in 2 prefills, "
        f"{c_sched['prefill_kv_bytes_saved']} prefix-KV bytes saved, the prefix-shared kernel "
        f"at S 8 ({len(c_seen['prefix_shared'])} calls)")

    be = [{"id": f"be{i}", "prefix": p, "suffixes": list(sfx), "max_new_tokens": n_gen,
           "slo_class": "best_effort", "tenant_id": "batch"} for i, (p, sfx) in
          enumerate(prompts[:4])]
    ia = [{"id": f"ia{i}", "prefix": p, "suffixes": list(sfx), "max_new_tokens": n_gen,
           "slo_class": "interactive", "tenant_id": "live"} for i, (p, sfx) in
          enumerate(prompts[4:6])]
    fresh_process_state()
    fa.reset_launch_counts()
    replies, pr_stats = serve_jsonl(
        model_dir, be, ia, [*serve_args, "--sched", "--max_active_requests", "4",
                            "--max_wave_requests", "2"], cfg.vocab_size, active_before=4)
    counts, local = fa.launch_counts(), fa.local_launch_counts()
    _add_launches(paths[sched_path], {k: {"launches": counts[k], "local_launches": local[k]}
                                      for k in counts})
    pr_sched = pr_stats.get("sched", {})
    by_id = {r.get("client_id"): r for r in replies}
    done = [i for i in (*[d["id"] for d in be], *[d["id"] for d in ia])
            if by_id.get(i, {}).get("status") == "done"]
    if len(done) != 6 or not pr_sched.get("preemptions", 0) >= 1:
        fail(f"serve sched_preempt: {len(done)} of 6 requests done, preemptions "
             f"{pr_sched.get('preemptions')}: {replies}")
    diff = total = 0
    for i, d in enumerate(be):
        got = [[str(t) for t in row] for row in by_id[d["id"]]["tokens"]]
        want = _new_tokens(updated[i], prompts[i])
        total += sum(len(r) for r in want)
        diff += sum(a != b for gr, wr in zip(got, want) for a, b in zip(gr, wr))
    ia_ttft = [by_id[d["id"]]["ttft_s"] for d in ia]
    report("sched_preempt", pr_stats, counts, sched=pr_sched, interactive_ttft_s=ia_ttft,
           sched_parity_ttft_mean_s=p_stats["ttft_s"].get("mean"),
           resumed_tokens_differing=diff, resumed_tokens=total)
    log(f"[serve] sched_preempt: {pr_sched['preemptions']} preemption(s), every request done; "
        f"interactive TTFT {ia_ttft} s against the sched_parity run's mean "
        f"{p_stats['ttft_s'].get('mean')} s; {diff} of {total} best-effort tokens differ from "
        "the uninterrupted default run (bf16: the resumed KV comes from the suffix prefill)")

    # -- speculative serving ------------------------------------------------
    spec_path = "llama2_7b_serve_spec"
    lk, lk_up, l_stats, l_counts, l_seen = served("spec_lookup", prompts,
                                                  ["--speculative_k", "4"], spec_path)
    l_spec = l_stats.get("spec", {})
    report("spec_lookup", l_stats, l_counts, spec=l_spec, spec_passes=l_seen["verify_passes"])
    if not l_seen["verify_passes"] or "drafted_tokens" not in l_spec:
        fail(f"serve spec_lookup: no verify pass ran: {l_spec}")
    lk_diff = sum(a != b for i in range(len(prompts))
                  for gr, wr in zip(_new_tokens(lk_up[i], prompts[i]),
                                    _new_tokens(updated[i], prompts[i]))
                  for a, b in zip(gr, wr))
    log(f"[serve] spec_lookup: {l_seen['verify_passes']} verify passes, drafted "
        f"{l_spec.get('drafted_tokens')}, accepted {l_spec.get('accepted_tokens')}; {lk_diff} "
        "tokens differ from the default engine's (bf16: the verify pass runs the plain op)")

    draft_cfg = LlamaConfig.from_dict(TINYLLAMA_1_1B)
    draft_dir = os.path.join(work, "tinyllama-1.1b")
    nbytes, secs = write_streamed_checkpoint(draft_dir, draft_cfg, seed=7)
    log(f"[serve] wrote a seeded bf16 draft checkpoint at TinyLlama-1.1B's widths "
        f"({draft_cfg.num_hidden_layers} layers, {nbytes} bytes) in {secs:.3f} s")
    _, _, d_stats, d_counts, d_seen = served(
        "spec_draft", prompts, ["--speculative_k", "4", "--spec_adaptive", "--spec_k_min", "0",
                                "--spec_k_max", "4", "--draft_model_path", draft_dir], spec_path)
    shutil.rmtree(draft_dir, ignore_errors=True)
    d = d_stats.get("draft", {})
    d_spec = d_stats.get("spec", {})
    draft_calls = [q for q in d_seen["causal"] if q[2:] == (draft_cfg.num_attention_heads,
                                                           draft_cfg.head_dim)]
    target_causal = d_counts["flash_causal_attention"] - len(draft_calls)
    lengths = sorted({q[1] for q in draft_calls})
    forward_ms = 1e3 * d_seen["draft_propose_s"] / max(d.get("draft_tokens", 0), 1)
    report("spec_draft", d_stats, d_counts, spec=d_spec, draft=d,
           spec_ctrl=d_stats.get("spec_ctrl"), spec_passes=d_seen["verify_passes"],
           draft_pin_load_s=d_seen["draft_init_s"], draft_propose_s=d_seen["draft_propose_s"],
           draft_forward_ms=forward_ms, draft_context_lengths=lengths)
    want_payload = payload_bytes(draft_cfg)
    problems = []
    if d.get("pinned_bytes") != want_payload:
        problems.append(f"pinned_bytes {d.get('pinned_bytes')} != payload {want_payload}")
    if d_stats["stream"]["streamed_bytes"] != l_stats["stream"]["streamed_bytes"]:
        problems.append(f"streamed_bytes {d_stats['stream']['streamed_bytes']} != spec_lookup's "
                        f"{l_stats['stream']['streamed_bytes']}")
    if not d.get("draft_calls", 0) > 0:
        problems.append("no draft call")
    if len(draft_calls) != d.get("draft_tokens", 0) * draft_cfg.num_hidden_layers:
        problems.append(f"{len(draft_calls)} draft causal calls for {d.get('draft_tokens')} "
                        f"draft tokens of {draft_cfg.num_hidden_layers} layers")
    if target_causal != p_counts["flash_causal_attention"]:
        problems.append(f"{target_causal} causal launches of the target, not the prefills' "
                        f"{p_counts['flash_causal_attention']}")
    if problems:
        fail("serve spec_draft: " + "; ".join(problems))
    log(f"[serve] spec_draft: {d['pinned_layers']} draft layers pinned ({d['pinned_bytes']} "
        f"bytes, the checkpoint's payload) in {d_seen['draft_init_s']:.3f} s; the target streamed what "
        f"spec_lookup streamed; {d['draft_calls']} draft calls, {d['draft_tokens']} tokens, "
        f"{len(draft_calls)} causal launches at context lengths {lengths} "
        f"({forward_ms:.3f} ms per draft forward)")

    # A speculative wave decodes by verify passes, which run the plain op
    # (as the JAX package's do): the decode kernel is not on that path.
    for name, p in paths.items():
        needed = [k for k in fa.KERNELS
                  if not (name == spec_path and k == "flash_decode_attention")]
        missing = [k for k in needed if p.get(k, {}).get("launches", 0) == 0]
        if missing:
            fail(f"serve: kernels never launched on the {name} path: {missing}")
    return paths


# The serve path's tenants and its restarts (the ``tenants`` phase).

# A serve CLI process with chip_smoke's tokenizer (argv: the repo, the
# vocabulary, the CLI's arguments). SMOKE_SIGTERM_AFTER_PREFILLS sends it
# SIGTERM once that many waves have prefilled. With SMOKE_RESTART_OUT the
# process writes there, after the CLI returns, its stats and the kernel
# launches of its run (counted from 0 at its start) as JSON, and the scores
# of the requests its WAL replay submitted, by client id, to ``.npz``.
_WAL_DRILL_PROCESS = """
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from chip_smoke import BenchTokenizer
from flexible_llm_sharding_tpu_torch import cli
from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa
from flexible_llm_sharding_tpu_torch.serve import engine, recovery

n = int(os.environ.get("SMOKE_SIGTERM_AFTER_PREFILLS", "0"))
if n:
    real_post_sweep = engine.ServeEngine._post_sweep

    def post_sweep(self, wall):
        real_post_sweep(self, wall)
        if self.metrics.counter("prefills") >= n:
            os.kill(os.getpid(), 15)
            time.sleep(0.5)

    engine.ServeEngine._post_sweep = post_sweep
out = os.environ.get("SMOKE_RESTART_OUT")
replayed = []
real_replay = recovery.replay

def replay(eng, wal, callback=None):
    summary = real_replay(eng, wal, callback=callback)
    replayed.extend(summary["requests"])
    return summary

recovery.replay = replay
fa.reset_launch_counts()
stats = cli.main(sys.argv[3:], tokenizer=BenchTokenizer(int(sys.argv[2])))
if out:
    torch.cuda.synchronize()
    np.savez(out + ".npz", **{str(r.client_id): r.future.result().scores for r in replayed})
    with open(out, "w") as f:
        json.dump({"stats": stats, "launches": fa.launch_counts(),
                   "local_launches": fa.local_launch_counts()}, f)
"""


def write_adapters(root: str, work: str, cfg) -> None:
    """The cell's two seeded float32 adapters on all its layers: tenant-a
    (rank 8) written by ``save_adapter``; tenant-b (rank 16) converted by
    ``prepare-adapter`` from a PEFT-layout directory written here (square
    ``q_proj`` targets, lora_alpha 32). Each shifts the hidden stream by
    about a tenth of its size."""
    from flexible_llm_sharding_tpu_torch import cli
    from flexible_llm_sharding_tpu_torch.adapters.registry import save_adapter
    from flexible_llm_sharding_tpu_torch.utils.checkpoint import write_safetensors

    d, n = cfg.hidden_size, cfg.num_hidden_layers
    rng = np.random.default_rng(21)
    save_adapter(root, "tenant-a", {
        f"model.layers.{i}": ((rng.standard_normal((d, 8)) / np.sqrt(d)).astype(np.float32),
                              (0.1 / np.sqrt(8) * rng.standard_normal((8, d))).astype(np.float32))
        for i in range(n)})
    peft = os.path.join(work, "peft-tenant-b")
    os.makedirs(peft, exist_ok=True)
    with open(os.path.join(peft, "adapter_config.json"), "w") as f:
        json.dump({"r": 16, "lora_alpha": 32, "target_modules": ["q_proj"],
                   "peft_type": "LORA"}, f)
    tensors = {}
    for i in range(n):
        key = f"base_model.model.model.layers.{i}.self_attn.q_proj"
        tensors[f"{key}.lora_A.weight"] = torch.from_numpy(
            (rng.standard_normal((16, d)) / np.sqrt(d)).astype(np.float32))
        tensors[f"{key}.lora_B.weight"] = torch.from_numpy(
            (0.05 / 4 * rng.standard_normal((d, 16))).astype(np.float32))
    write_safetensors(os.path.join(peft, "adapter_model.safetensors"), tensors)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["prepare-adapter", "--peft_dir", peft, "--adapter_dir", root, "--name",
                  "tenant-b"])
    log("[tenants] prepare-adapter: " + " | ".join(out.getvalue().strip().splitlines()[:2]))


def tenant_engine(model_dir: str, work: str, vocab: int, n_gen: int, adapter_dir: str = ""):
    """A ServeEngine (not started) with the serve CLI's defaults at this
    phase's settings: bf16, one layer per shard, blocks of 2, waves of 2."""
    from flexible_llm_sharding_tpu_torch.config import AdapterConfig, FrameworkConfig, ServeConfig
    from flexible_llm_sharding_tpu_torch.serve import ServeEngine

    cfg = FrameworkConfig(model_path=model_dir, dtype="bfloat16", layer_num_per_shard=1,
                          block_size=2, device="cuda", disk_folder=os.path.join(work, "tenants"),
                          adapters=AdapterConfig(dir=adapter_dir))
    return ServeEngine(cfg, ServeConfig(max_wave_requests=2, default_max_new_tokens=n_gen),
                       tokenizer=BenchTokenizer(vocab), device=torch.device("cuda"), start=False)


def serve_tenants(engine, subs, sequential: bool = False):
    """``subs`` ((prefix, suffixes, adapter_id)) on ``engine``: all queued
    before it starts (waves of 2 in order), or one at a time, each waited
    for (``sequential``: the batch-of-1 oracle). Returns (results, errors,
    stats, launches, wall_s): a result or an error per submission."""
    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa

    fa.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        if sequential:
            engine.start()
            reqs = []
            for p, sfx, aid in subs:
                reqs.append(engine.submit(p, sfx, adapter_id=aid))
                reqs[-1].future.exception(timeout=600)
        else:
            reqs = [engine.submit(p, sfx, adapter_id=aid) for p, sfx, aid in subs]
            engine.start()
        errors = [r.future.exception(timeout=600) for r in reqs]
        results = [None if e is not None else r.future.result() for r, e in zip(reqs, errors)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, local = fa.launch_counts(), fa.local_launch_counts()
        stats = engine.stats()
    finally:
        engine.shutdown(drain=True)
    if engine.error is not None:
        fail(f"tenants: the engine failed: {engine.error!r}")
    launches = {k: {"launches": counts[k], "local_launches": local[k]} for k in counts}
    return results, errors, stats, launches, wall


def _wal_serve(model_dir: str, work: str, tag: str, wal_dir: str, lines: str, vocab: int,
               env_extra: dict, want_rc: int, extra: tuple = ()):
    """One serve CLI process (:data:`_WAL_DRILL_PROCESS`, JSONL frontend,
    ``--wal_dir``, then ``extra``) fed ``lines``. Returns (done replies by
    client id, stderr, seconds from start to exit)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("FLS_WAL_CRASH_SWEEPS", "SMOKE_SIGTERM_AFTER_PREFILLS",
                        "SMOKE_RESTART_OUT")}
    env.update(env_extra)
    argv = ["serve", "--model_path", model_dir, "--dtype", "bfloat16", "--layer_num_per_shard",
            "1", "--device", "cuda", "--block_size", "2", "--max_wave_requests", "2",
            "--wal_dir", wal_dir, "--stats_interval_s", "0", *extra]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _WAL_DRILL_PROCESS, HERE, str(vocab), *argv],
                          input=lines, capture_output=True, text=True, env=env, cwd=work,
                          timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != want_rc:
        fail(f"tenants {tag}: the serve process exited {proc.returncode}, not {want_rc}: "
             f"{proc.stderr[-3000:]}")
    done = {}
    for ln in proc.stdout.splitlines():
        try:
            d = json.loads(ln)
        except ValueError:
            continue
        if d.get("status") == "done":
            done[d["client_id"]] = d
    return done, proc.stderr, secs


def wal_drill(model_dir: str, work: str, tag: str, prompts, budgets: list[int], vocab: int,
              env_extra: dict, want_rc: int, extra: tuple = ()):
    """The serve CLI over the prompts (request ``w<i>`` with budget
    ``budgets[i]``), stopped by its drill. Returns (wal_dir, done replies by
    client id, seconds)."""
    wal_dir = os.path.join(work, f"wal_{tag}")
    lines = "".join(json.dumps({"id": f"w{i}", "prefix": p, "suffixes": list(sfx),
                                "max_new_tokens": n}) + "\n"
                    for i, ((p, sfx), n) in enumerate(zip(prompts, budgets)))
    done, _, secs = _wal_serve(model_dir, work, tag, wal_dir, lines, vocab, env_extra, want_rc,
                               extra)
    if len(done) >= len(prompts):
        fail(f"tenants {tag}: every request finished before the drill: nothing in flight")
    return wal_dir, done, secs


_WAL_REPLAY_LINE = re.compile(r"wal replay: (\d+) reopened, (\d+) already terminal, "
                              r"kv restored (\d+) \(failed (\d+)\)")


def wal_restart(model_dir: str, work: str, tag: str, wal_dir: str, vocab: int,
                extra: tuple = ()):
    """The restart: a new serve CLI process over the same ``--wal_dir``
    with no new request line, whose replay serves every open request before
    it reads stdin. Returns (the ``wal replay:`` summary, done replies by
    client id, the replayed requests' scores by client id, the process's
    stats, its kernel launches, seconds from start to exit)."""
    out = os.path.join(work, f"wal_{tag}_restart.json")
    done, err, secs = _wal_serve(model_dir, work, f"{tag} restart", wal_dir, "", vocab,
                                 {"SMOKE_RESTART_OUT": out}, 0, extra)
    m = _WAL_REPLAY_LINE.search(err)
    if m is None:
        fail(f"tenants {tag} restart: no `wal replay:` line on stderr: {err[-3000:]}")
    summary = dict(zip(("replayed", "skipped_terminal", "kv_restored", "kv_failed"),
                       (int(x) for x in m.groups())))
    with open(out) as f:
        dumped = json.load(f)
    with np.load(out + ".npz") as z:
        scores = {cid: z[cid] for cid in z.files}
    launches = {k: {"launches": dumped["launches"][k],
                    "local_launches": dumped["local_launches"][k]} for k in dumped["launches"]}
    return summary, done, scores, dumped["stats"], launches, secs


def fsync_cost(work: str, n: int = 200) -> dict:
    """Seconds per admission record of a RequestWAL on this machine's disk,
    for each fsync policy (``admit`` fsyncs every admission)."""
    from flexible_llm_sharding_tpu_torch.serve import Request, RequestWAL

    out = {}
    for policy in ("never", "admit", "always"):
        wal = RequestWAL(os.path.join(work, f"wal_fsync_{policy}"), fsync=policy)
        reqs = [Request(prefix="p " * 512, suffixes=("s",) * 4, max_new_tokens=8)
                for _ in range(n)]
        t0 = time.perf_counter()
        for r in reqs:
            wal.admit(r)
        out[policy] = (time.perf_counter() - t0) / n
        wal.close()
    return out


def time_tenant_sweeps(model_dir: str, work: str, vocab: int, n_gen: int, adapter_dir: str,
                       subs) -> dict:
    """Where an adapter run's time goes: ``subs`` served again with the
    shift (``runtime/decode._shift``, which runs ``lora_shift_rows``) and
    the per-wave factor upload (``ServeEngine._segment_delta``) each
    wrapped in a host clock and a pair of CUDA events on the calling
    thread's stream. Returns per sweep the calls, host ms and device ms
    (the events' span) of each, with the run's per-token latency."""
    from flexible_llm_sharding_tpu_torch.runtime import decode
    from flexible_llm_sharding_tpu_torch.serve import engine as engine_mod

    spans: dict = {"lora_shift_rows": [], "segment_delta": []}
    host = dict.fromkeys(spans, 0.0)
    real_shift, real_seg = decode._shift, engine_mod.ServeEngine._segment_delta

    def timed(key, fn):
        def run(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = fn(*a, **kw)
            end.record()
            host[key] += time.perf_counter() - t0
            spans[key].append((start, end))
            return out
        return run

    decode._shift = timed("lora_shift_rows", real_shift)
    engine_mod.ServeEngine._segment_delta = timed("segment_delta", real_seg)
    try:
        fresh_process_state()
        _, errs, stats, _, _ = serve_tenants(
            tenant_engine(model_dir, work, vocab, n_gen, adapter_dir), subs)
    finally:
        decode._shift, engine_mod.ServeEngine._segment_delta = real_shift, real_seg
    if any(e is not None for e in errs):
        fail(f"tenants timing run: failed requests {errs}")
    torch.cuda.synchronize()
    sweeps = stats["sweeps"]
    out = {"sweeps": sweeps, "token_latency_mean_s": stats["token_latency_s"].get("mean")}
    for key, pairs in spans.items():
        out[key] = {"calls_per_sweep": len(pairs) / sweeps,
                    "host_ms_per_sweep": 1e3 * host[key] / sweeps,
                    "device_ms_per_sweep": sum(a.elapsed_time(b) for a, b in pairs) / sweeps}
    return out


def phase_tenants(work: str, model_dir: str, cfg, prompts, n_gen: int, smi: str,
                  default: tuple) -> dict:
    """Multi-tenant LoRA serving and the request WAL on the 4-layer
    Llama-2-7B cell (see the module doc), against the serve phase's default
    engine (``default``: its scores, updated prompts and stats). Returns the
    kernel launches of the ``llama2_7b_serve_adapters`` and
    ``llama2_7b_serve_wal`` paths."""
    from flexible_llm_sharding_tpu_torch import cli
    from flexible_llm_sharding_tpu_torch.adapters import loader
    from flexible_llm_sharding_tpu_torch.adapters.apply import (
        lora_shift,
        lora_shift_rows,
        stack_layer,
    )
    from flexible_llm_sharding_tpu_torch.adapters.registry import (
        AdapterCorruptError,
        AdapterNotFound,
    )
    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa
    from flexible_llm_sharding_tpu_torch.runtime import kvpool

    def_scores, def_updated, _ = default
    n_layers = cfg.num_hidden_layers
    vocab = cfg.vocab_size
    a_path, w_path = "llama2_7b_serve_adapters", "llama2_7b_serve_wal"
    paths = {a_path: {}, w_path: {}}
    t_phase = time.perf_counter()
    root = os.path.join(work, "adapters")
    write_adapters(root, work, cfg)

    def line(tag, stats, launches, wall, **more):
        a = stats.get("adapter", {})
        pool = stats.get("kvpool", {})
        log(f"[tenants] {tag} | {smi} | " + json.dumps({
            "wall_s": wall, "ttft_mean_s": stats["ttft_s"].get("mean"),
            "ttft_p95_s": stats["ttft_s"].get("p95"),
            "token_latency_mean_s": stats["token_latency_s"].get("mean"),
            "token_latency_p95_s": stats["token_latency_s"].get("p95"),
            "completed": stats.get("completed"), "prefills": stats.get("prefills"),
            "sweeps": stats.get("sweeps"), "streamed_bytes": stats["stream"]["streamed_bytes"],
            "applied_rows": a.get("applied_rows"), "delta_bytes": a.get("delta_bytes"),
            "adapter_rejects": stats.get("adapter_rejects", 0),
            "prefix_reuse_hits": pool.get("prefix_reuse_hits"),
            "kernels": {k: v["launches"] for k, v in launches.items()}, **more}))

    def same(a, b):
        return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))

    # The shift on the card in bf16 against a float32 shift of the same
    # hidden states (a block of 3 prefixes at the cell's width: tenant-a,
    # tenant-b, base), and the engine's row form against the JAX package's
    # gathered form over the padded stacks.
    from flexible_llm_sharding_tpu_torch.adapters.loader import AdapterStore

    store = AdapterStore(root, 1 << 30)
    facs = {n: store.get(n)[1] for n in ("tenant-a", "tenant-b")}
    a_st, b_st = stack_layer([None, "tenant-a", "tenant-b"], facs, "model.layers.0",
                             cfg.hidden_size, 16)
    pairs = {gi: (facs[n]["model.layers.0"]["lora_A"].cuda(),
                  facs[n]["model.layers.0"]["lora_B"].cuda())
             for gi, n in ((1, "tenant-a"), (2, "tenant-b"))}
    gen = torch.Generator(device="cuda").manual_seed(77)
    h = torch.randn(3, 576, cfg.hidden_size, generator=gen, device="cuda")
    sc = torch.tensor([0.0, 1.0, 1.0], device="cuda")
    bf = lora_shift_rows(h.bfloat16(), pairs, [1, 2, 0], sc)
    f32 = lora_shift_rows(h, pairs, [1, 2, 0], sc)
    gathered = lora_shift(h, a_st.cuda(), b_st.cuda(), torch.tensor([1, 2, 0], device="cuda"), sc)
    log(f"[tenants] lora_shift_rows bf16 vs float32 on the card at [3, 576, {cfg.hidden_size}], "
        f"ranks 8 and 16: max |diff| {(bf.float() - f32).abs().max().item():.6e} (shift max "
        f"{(f32 - h).abs().max().item():.4e}; bf16 rounding of h alone "
        f"{(h.bfloat16().float() - h).abs().max().item():.6e}); float32 rows vs the gathered "
        f"form over stacks padded to 16: {(f32 - gathered).abs().max().item():.3e}")
    if (not bool(torch.isfinite(bf).all()) or not torch.equal(bf[2], h[2].bfloat16())
            or (f32 - gathered).abs().max().item() > 1e-4):
        fail("tenants: the bf16 shift is not finite, moved the base row, or the row form "
             "disagrees with the gathered form")

    # -- adapters_off: --adapter_dir set, every request on the base model --
    fresh_process_state()
    serve_args = ["--dtype", "bfloat16", "--layer_num_per_shard", "1", "--device", "cuda",
                  "--block_size", "2", "--max_new_tokens", str(n_gen), "--max_wave_requests",
                  "2"]
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    off, off_up, off_stats = run_serve(model_dir, work, "tenants_off", prompts,
                                       [*serve_args, "--adapter_dir", root], vocab)
    off_wall = time.perf_counter() - t0
    counts, local = fa.launch_counts(), fa.local_launch_counts()
    launches = {k: {"launches": counts[k], "local_launches": local[k]} for k in counts}
    _add_launches(paths[a_path], launches)
    line("adapters_off", off_stats, launches, off_wall)
    if not same(off, def_scores) or off_up != def_updated:
        fail("tenants adapters_off: scores differ from the default engine's")
    if off_stats["adapter"]["delta_bytes"] != 0:
        fail(f"tenants adapters_off: {off_stats['adapter']['delta_bytes']} delta bytes moved")
    log("[tenants] adapters_off: the default engine's scores bit for bit, 0 delta bytes")

    # -- adapters_mixed: 3 on tenant-a, 3 on tenant-b, 2 base, at once -----
    aids = ["tenant-a"] * 3 + ["tenant-b"] * 3 + [None] * 2
    subs = [(p, sfx, aid) for (p, sfx), aid in zip(prompts, aids)]
    fresh_process_state()
    oracle, _, o_stats, o_launch, o_wall = serve_tenants(
        tenant_engine(model_dir, work, vocab, n_gen, root), subs, sequential=True)
    _add_launches(paths[a_path], o_launch)
    line("adapters_mixed_oracle", o_stats, o_launch, o_wall)
    fresh_process_state()
    mixed, errs, m_stats, m_launch, m_wall = serve_tenants(
        tenant_engine(model_dir, work, vocab, n_gen, root), subs)
    _add_launches(paths[a_path], m_launch)
    if any(e is not None for e in errs):
        fail(f"tenants adapters_mixed: failed requests {errs}")
    tok_diff = arg_diff = 0
    for m, o in zip(mixed, oracle):
        tok_diff += int((m.tokens != o.tokens).sum())
        arg_diff += int((m.scores.argmax(-1) != o.scores.argmax(-1)).sum())
    vs_oracle = max(float(np.abs(m.scores - o.scores).max()) for m, o in zip(mixed, oracle))
    vs_base = [float(np.abs(m.scores - d).max()) for m, d in zip(mixed, def_scores)]
    streamed = m_stats["stream"]["streamed_bytes"]
    a = m_stats["adapter"]
    line("adapters_mixed", m_stats, m_launch, m_wall, max_abs_vs_oracle=vs_oracle,
         max_abs_vs_base_by_request=vs_base,
         delta_frac_of_stream=a["delta_bytes"] / streamed,
         streamed_per_sweep=streamed / m_stats["sweeps"],
         off_streamed_per_sweep=off_stats["stream"]["streamed_bytes"] / off_stats["sweeps"])
    problems = []
    if tok_diff or arg_diff:
        problems.append(f"{tok_diff} tokens and {arg_diff} argmaxes differ from the batch-of-1 "
                        "oracle's")
    # The base requests' gap from the default run is the batching's noise
    # (0 when rows are independent); every tenant must stand above it.
    noise = max(vs_base[6:])
    if min(vs_base[:6]) <= 10 * noise:
        problems.append(f"a tenant's scores are the base model's: {vs_base}")
    # A resident engine streams one pass whatever its sweeps: the tenants'
    # run must stream exactly what adapters_off streamed.
    if streamed != off_stats["stream"]["streamed_bytes"]:
        problems.append(f"streamed {streamed} bytes, adapters_off "
                        f"{off_stats['stream']['streamed_bytes']}")
    if not 0 < a["delta_bytes"] < 0.05 * streamed or not a["applied_rows"] > 0:
        problems.append(f"delta_bytes {a['delta_bytes']}, applied_rows {a['applied_rows']}")
    if problems:
        fail("tenants adapters_mixed: " + "; ".join(problems))
    log(f"[tenants] adapters_mixed: tokens and argmax of the batch-of-1 oracle, scores within "
        f"{vs_oracle:.3e} of it; tenants differ from the base by {min(vs_base[:6]):.3e}.."
        f"{max(vs_base[:6]):.3e}; {a['applied_rows']} rows shifted, {a['delta_bytes']} delta "
        f"bytes ({a['delta_bytes'] / streamed:.4%} of the {streamed}-byte stream)")

    timing = time_tenant_sweeps(model_dir, work, vocab, n_gen, root, subs)
    log(f"[tenants] adapters_mixed again, the shift and the factor upload timed | {smi} | "
        + json.dumps(timing))

    # -- adapters_reuse: tenant-a's prompts twice, then under tenant-b -----
    fresh_process_state()
    engine = tenant_engine(model_dir, work, vocab, n_gen, root)
    rounds = {}
    t0 = time.perf_counter()
    try:
        engine.start()
        for tag, aid in (("a1", "tenant-a"), ("a2", "tenant-a"), ("b", "tenant-b")):
            fa.reset_launch_counts()
            hits0 = kvpool.process_stats()["prefix_reuse_hits"]
            reqs = [engine.submit(p, sfx, adapter_id=aid) for p, sfx in prompts[:3]]
            res = [r.future.result(timeout=600) for r in reqs]
            torch.cuda.synchronize()
            counts, local = fa.launch_counts(), fa.local_launch_counts()
            launches = {k: {"launches": counts[k], "local_launches": local[k]} for k in counts}
            _add_launches(paths[a_path], launches)
            rounds[tag] = (res, kvpool.process_stats()["prefix_reuse_hits"] - hits0, counts)
        r_stats = engine.stats()
    finally:
        engine.shutdown(drain=True)
    r_wall = time.perf_counter() - t0
    line("adapters_reuse", r_stats, {k: {"launches": v} for k, v in rounds["a2"][2].items()},
         r_wall, hits_by_round={t: v[1] for t, v in rounds.items()})
    a2_counts = rounds["a2"][2]
    if (rounds["a2"][1] != 3 or rounds["b"][1] != 0
            or not same([r.scores for r in rounds["a2"][0]], [r.scores for r in rounds["a1"][0]])
            or a2_counts["flash_causal_attention"] != 0
            or a2_counts["flash_prefix_shared_attention"] < n_layers):
        fail(f"tenants adapters_reuse: hits by round {[v[1] for v in rounds.values()]}, round 2 "
             f"launches {a2_counts}, round 2 scores equal to round 1's: "
             f"{same([r.scores for r in rounds['a2'][0]], [r.scores for r in rounds['a1'][0]])}")
    log(f"[tenants] adapters_reuse: round 2 reused 3 tenant-a entries (first round's scores bit "
        f"for bit, {a2_counts['flash_prefix_shared_attention']} prefix-shared and no causal "
        "launch); tenant-b got no hit from tenant-a's pages")

    # -- adapters_reject: one request names an unknown adapter -------------
    fresh_process_state()
    rej_subs = [subs[0], (prompts[1][0], prompts[1][1], "tenant-unknown"), subs[6], subs[3]]
    res, errs, j_stats, j_launch, j_wall = serve_tenants(
        tenant_engine(model_dir, work, vocab, n_gen, root), rej_subs)
    _add_launches(paths[a_path], j_launch)
    line("adapters_reject", j_stats, j_launch, j_wall)
    if (not isinstance(errs[1], AdapterNotFound)
            or any(e is not None for i, e in enumerate(errs) if i != 1)
            or j_stats.get("adapter_rejects") != 1):
        fail(f"tenants adapters_reject: errors {errs}, adapter_rejects "
             f"{j_stats.get('adapter_rejects')}")
    log(f"[tenants] adapters_reject: only the unknown adapter's request failed "
        f"({type(errs[1]).__name__}), the other 3 completed")

    # -- verify --adapter_dir, then a flipped byte --------------------------
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["verify", "--adapter_dir", root])
    log("[tenants] verify --adapter_dir: exit 0 | " + out.getvalue().strip().splitlines()[-1])
    _flip_bit(os.path.join(root, "tenant-a", f"model.layers.{n_layers - 1}.safetensors"), 301)
    out = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out):
        try:
            cli.main(["verify", "--adapter_dir", root])
        except SystemExit as e:
            code = e.code
    if not code or "ADAPTER_MISMATCH" not in out.getvalue():
        fail(f"tenants verify after a flipped byte: exit {code}: {out.getvalue()}")
    log(f"[tenants] verify --adapter_dir after one flipped byte: exit {code} | "
        + out.getvalue().strip().splitlines()[0].strip())
    fresh_process_state()
    res, errs, _, launches, _ = serve_tenants(tenant_engine(model_dir, work, vocab, n_gen, root),
                                              [subs[0], subs[6], subs[3]])
    _add_launches(paths[a_path], launches)
    if (not isinstance(errs[0], AdapterCorruptError) or errs[1] is not None
            or errs[2] is not None):
        fail(f"tenants corrupt adapter: errors {errs}")
    log(f"[tenants] the engine failed only tenant-a's request ({type(errs[0]).__name__}); base "
        "and tenant-b completed")
    loader.reset_process_store()

    # -- the request WAL ------------------------------------------------------
    fsync = fsync_cost(work)
    log(f"[tenants] WAL admission record cost on this disk (200 records of a 512-word prompt) | "
        f"{smi} | " + json.dumps({f"{k}_s_per_admit": v for k, v in fsync.items()}))

    def merged_check(tag, done, replies, scores, budgets):
        # Replies of both processes merged by client id: a request's tokens
        # are the uninterrupted run's first ``budget``. Returns the largest
        # gap of the replayed requests' scores from that run's.
        want = {f"w{i}": [row[:n] for row in _new_tokens(def_updated[i], prompts[i])]
                for i, n in enumerate(budgets)}
        got = {cid: [[str(t) for t in row] for row in d["tokens"]]
               for cid, d in {**done, **replies}.items()}
        wrong = [cid for cid in want if got.get(cid) != want[cid]]
        if wrong or set(scores) != set(replies):
            fail(f"tenants {tag}: merged tokens differ from the uninterrupted run for {wrong}, "
                 f"or replayed scores {sorted(scores)} are not those of the replies "
                 f"{sorted(replies)}")
        return max((float(np.abs(sc - def_scores[int(cid[1:])][:, :sc.shape[1]]).max())
                    for cid, sc in scores.items()), default=0.0)

    budgets = [n_gen] * len(prompts)
    wal_dir, done, secs = wal_drill(model_dir, work, "graceful", prompts, budgets, vocab,
                                    {"SMOKE_SIGTERM_AFTER_PREFILLS": "1"}, 143)
    summary, replies, scores, s_stats, launches, r_secs = wal_restart(model_dir, work, "graceful",
                                                                      wal_dir, vocab)
    _add_launches(paths[w_path], launches)
    counts = {k: v["launches"] for k, v in launches.items()}
    extra_ps = counts["flash_prefix_shared_attention"] - counts["flash_causal_attention"]
    gap = merged_check("wal_graceful", done, replies, scores, budgets)
    line("wal_graceful_restart", s_stats, launches, s_stats["wall_s"], drill_process_s=secs,
         restart_process_s=r_secs, done_before=sorted(done), replay=summary,
         wal=s_stats.get("wal"), max_abs_score_gap_bf16=gap)
    if (summary["replayed"] != len(prompts) - len(done) or summary["kv_restored"] < 1
            or set(replies) != {f"w{i}" for i in range(len(prompts))} - set(done)
            or s_stats["kvpool"]["prefix_reuse_hits"] < 1 or extra_ps < n_layers
            or extra_ps % n_layers):
        fail(f"tenants wal_graceful: replay {summary}, replies {sorted(replies)}, reuse hits "
             f"{s_stats['kvpool']['prefix_reuse_hits']}, {extra_ps} prefix-shared launches "
             "beyond the full prefills'")
    log(f"[tenants] wal_graceful: SIGTERM after the first prefill, exit 143 with {len(done)} of "
        f"{len(prompts)} done; the restart process replayed {summary['replayed']} (kv restored "
        f"{summary['kv_restored']}, {extra_ps // n_layers} restored block(s) on the suffix-only "
        f"path: {extra_ps} prefix-shared launches without a causal one), merged tokens equal the "
        f"default run's, largest score gap {gap:.4e} (bf16, regrouped waves)")

    # The first wave's two requests take 2 tokens: they complete (terminal
    # records written) before the kill, mid-sweep 4.
    budgets = [2, 2] + [n_gen] * (len(prompts) - 2)
    wal_dir, done, secs = wal_drill(model_dir, work, "crash", prompts, budgets, vocab,
                                    {"FLS_WAL_CRASH_SWEEPS": "3"}, -9)
    summary, replies, scores, c_stats, launches, r_secs = wal_restart(model_dir, work, "crash",
                                                                      wal_dir, vocab)
    _add_launches(paths[w_path], launches)
    gap = merged_check("wal_crash", done, replies, scores, budgets)
    torn = c_stats["wal"]["torn_tails"]
    line("wal_crash_restart", c_stats, launches, c_stats["wall_s"], drill_process_s=secs,
         restart_process_s=r_secs, done_before=sorted(done), replay=summary,
         wal=c_stats.get("wal"), max_abs_score_gap_bf16=gap)
    if (not done or set(replies) & set(done) or summary["skipped_terminal"] != len(done)
            or summary["replayed"] != len(prompts) - len(done)):
        fail(f"tenants wal_crash: done before the kill {sorted(done)}, replayed "
             f"{sorted(replies)}, skipped_terminal {summary['skipped_terminal']}")
    log(f"[tenants] wal_crash: SIGKILL mid-sweep after 3 sweeps with {len(done)} done; the "
        f"restart process skipped them and replayed {summary['replayed']}; torn tails {torn} "
        f"(not fatal); merged tokens equal the default run's, largest score gap {gap:.4e}")
    shutil.rmtree(root, ignore_errors=True)
    for name, p in paths.items():
        missing = [k for k in fa.KERNELS if p.get(k, {}).get("launches", 0) == 0]
        if missing:
            fail(f"tenants: kernels never launched on the {name} path: {missing}")
    log(f"[tenants] phase wall {time.perf_counter() - t_phase:.3f} s | {smi}")
    return paths


# The replica fleet (the ``fleet`` phase).

# A serve CLI process for the fleet's runs (argv: the repo, the vocabulary,
# the CLI's arguments). It counts the kernel launches of its run from 0 and,
# after the CLI returns, writes to SMOKE_FLEET_OUT its stats, the launches,
# the TTFT and per-token latency of every request the fleet was given and
# the device memory still allocated.
_FLEET_PROCESS = """
import json, os, sys
sys.path.insert(0, sys.argv[1])
import torch
from chip_smoke import BenchTokenizer, request_timing
from flexible_llm_sharding_tpu_torch import cli
from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa
from flexible_llm_sharding_tpu_torch.serve import fleet

given = []
real = fleet.ReplicaFleet.submit_request

def submit_request(self, req):
    given.append(req)
    return real(self, req)

fleet.ReplicaFleet.submit_request = submit_request
fa.reset_launch_counts()
stats = cli.main(sys.argv[3:], tokenizer=BenchTokenizer(int(sys.argv[2])))
torch.cuda.synchronize()
with open(os.environ["SMOKE_FLEET_OUT"], "w") as f:
    json.dump({"stats": stats, "launches": fa.launch_counts(),
               "local_launches": fa.local_launch_counts(), "timing": request_timing(given),
               "allocated_after_gb": torch.cuda.memory_allocated() / 1e9}, f)
"""


def request_timing(reqs) -> dict:
    """TTFT and per-token latency (the wall after the first token over the
    tokens after it) of the served requests among ``reqs``: mean and p95 in
    seconds, and how many were served."""
    ttft, per_token = [], []
    for r in reqs:
        if not r.future.done() or r.future.exception(timeout=0) is not None:
            continue
        res = r.future.result(timeout=0)
        ttft.append(res.ttft_s)
        n = res.tokens.shape[1]
        if n > 1:
            per_token.append((res.latency_s - res.ttft_s) / (n - 1))

    def summary(v):
        return {"mean": float(np.mean(v)), "p95": float(np.percentile(v, 95))} if v else {}

    return {"served": len(ttft), "ttft_s": summary(ttft), "token_latency_s": summary(per_token)}


def fleet_totals(stats: dict) -> dict:
    """A ``fleet_stats`` line's replicas, the retired ones included:
    ``completed`` per replica and the sums of sweeps, prefills, tokens and
    streamed bytes; and the fleet's ``tokens_served`` (the engines'
    ``tokens_emitted`` also count attempts a kill abandoned)."""
    reps = {**{k: v for k, v in stats["replicas"].items()},
            **{f"retired{k}": v for k, v in stats.get("retired", {}).items()}}
    return {
        "completed_by_replica": {k: v.get("completed", 0) for k, v in reps.items()},
        "sweeps": sum(v.get("sweeps", 0) for v in reps.values()),
        "prefills": sum(v.get("prefills", 0) for v in reps.values()),
        "tokens_emitted": sum(v.get("tokens_emitted", 0) for v in reps.values()),
        "tokens_served": stats.get("tokens_served"),
        "streamed_bytes": sum(v["stream"]["streamed_bytes"] for v in reps.values()),
    }


def fleet_cli(model_dir: str, work: str, tag: str, prompts, extra: list[str], vocab: int):
    """The serve CLI's demo frontend over ``prompts`` in a fresh process
    (:data:`_FLEET_PROCESS`). Returns (scores, updated prompts, its dump,
    seconds from start to exit)."""
    ppkl, opkl = os.path.join(work, f"{tag}.pkl"), os.path.join(work, f"{tag}_scores.pkl")
    out = os.path.join(work, f"{tag}.json")
    with open(ppkl, "wb") as f:
        pickle.dump(prompts, f)
    argv = ["serve", "--model_path", model_dir, "--prompt_pickle", ppkl, "--output_file", opkl,
            "--stats_interval_s", "0", *extra]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _FLEET_PROCESS, HERE, str(vocab), *argv],
                          capture_output=True, text=True, cwd=work, timeout=600,
                          env={**os.environ, "SMOKE_FLEET_OUT": out})
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"fleet {tag}: the serve process exited {proc.returncode}: {proc.stderr[-3000:]}")
    with open(opkl, "rb") as f:
        scores = pickle.load(f)
    with open(os.path.join(work, f"{tag}_updated.pkl"), "rb") as f:
        updated = pickle.load(f)
    with open(out) as f:
        return scores, updated, json.load(f), secs


def first_kill_seed(n: int, rate: float) -> int:
    """A chaos seed whose ``replica_kill`` schedule at ``rate`` fires first
    at draw ``n`` (0-based; the injector's SHA-256 unit per draw)."""
    from flexible_llm_sharding_tpu_torch.faults.retry import hash_unit

    for seed in range(1_000_000):
        units = [hash_unit(f"{seed}:replica_kill:{i}") for i in range(n + 1)]
        if min(units[:n], default=1.0) >= rate > units[n]:
            return seed
    fail(f"no chaos seed fires first at draw {n}")


def settled_allocated() -> tuple[int, int]:
    """``torch.cuda.memory_allocated()`` as first read, then with PyTorch's
    per-handle cuBLAS workspaces freed (32 MiB for each thread handle in use
    at once, which a new engine thread can add and no engine owns), once two
    reads 0.1 s apart agree: an engine thread can still hold its last
    sweep's tensors for a moment after its waves retire."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    raw, last = torch.cuda.memory_allocated(), None
    for _ in range(50):
        gc.collect()
        torch.cuda.synchronize()
        torch._C._cuda_clearCublasWorkspaces()
        now = torch.cuda.memory_allocated()
        if now == last:
            break
        last = now
        time.sleep(0.1)
    return raw, now


def device_bytes(tree) -> int:
    """Bytes of the CUDA storages behind the tensors in ``tree`` (nested
    dicts, lists and tuples), each storage once."""
    storages: dict[int, int] = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                st = x.untyped_storage()
                storages[st.data_ptr()] = st.nbytes()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    return sum(storages.values())


def watch_kill(fleet) -> dict:
    """Wrap ``fleet``'s chaos step: when it kills a replica, record the
    victim, the shard, its waves' steps (sweeps run: 1 is the prefill) and
    the device bytes of their state (KV and activations) at that moment."""
    from flexible_llm_sharding_tpu_torch.serve import ReplicaKilled

    seen: dict = {}
    step = fleet._chaos_step

    def watched(rep, shard_pos):
        try:
            step(rep, shard_pos)
        except ReplicaKilled:
            waves = [w for w in rep.engine.batcher.waves if w.state is not None]
            seen.update(replica=rep.idx, shard=shard_pos, steps=[w.steps for w in waves],
                        state_bytes=device_bytes([w.state.kv_store._mem for w in waves]))
            raise

    fleet._chaos_step = watched
    return seen


def check_concurrent_launches(case: dict, gen, threads: int = 3, calls: int = 10) -> None:
    """Each kernel launched from ``threads`` fresh threads at once, ``calls``
    times each, on the same inputs (every thread on its own current stream
    of one context, as the fleet's engine threads launch; no thread makes a
    CUDA call before its first launch): every launch succeeds and every
    output equals one launch from this thread bit for bit."""
    import threading

    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa

    x = _inputs(case, torch.bfloat16, gen)
    for kernel, (args, kw) in _calls(x, None).items():
        want = getattr(fa, kernel)(*args, **kw)
        torch.cuda.synchronize()
        bad: list = []

        def run():
            try:
                with torch.inference_mode():
                    for _ in range(calls):
                        got = getattr(fa, kernel)(*args, **kw)
                        torch.cuda.current_stream().synchronize()
                        if not torch.equal(got, want):
                            bad.append(float((got.float() - want.float()).abs().max()))
            except Exception as e:  # recorded: the check fails on it below
                bad.append(repr(e))

        ts = [threading.Thread(target=run) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
        if bad or any(t.is_alive() for t in ts):
            fail(f"{kernel}: launches from {threads} threads at once differ from one launch: {bad}")
        log(f"[fleet] {kernel}: {threads * calls} launches from {threads} threads at once at the "
            "serve block's shapes, each equal bit for bit to a single launch")


def phase_fleet(work: str, model_dir: str, cfg, prompts, n_gen: int, smi: str,
                default: tuple) -> dict:
    """The replica fleet on the 4-layer Llama-2-7B cell (see the module doc),
    against the serve phase's default engine (``default``: its scores,
    updated prompts and stats). Returns the kernel launches of the
    ``llama2_7b_serve_fleet`` path."""
    import threading

    from flexible_llm_sharding_tpu_torch.config import (
        AutoscaleConfig,
        FaultConfig,
        FrameworkConfig,
        ServeConfig,
    )
    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa
    from flexible_llm_sharding_tpu_torch.parallel.planner import plan_shards_dp
    from flexible_llm_sharding_tpu_torch.runtime import kvpool
    from flexible_llm_sharding_tpu_torch.serve import ReplicaFleet
    from flexible_llm_sharding_tpu_torch.utils import checkpoint
    from flexible_llm_sharding_tpu_torch.utils.metrics import host_rss_gib

    def_scores, def_updated, _ = default
    vocab = cfg.vocab_size
    n = len(prompts)
    path = "llama2_7b_serve_fleet"
    paths: dict = {path: {}}
    one_replica = payload_bytes(cfg)  # one replica's resident weights
    t_phase = time.perf_counter()
    serve_args = ["--dtype", "bfloat16", "--layer_num_per_shard", "1", "--device", "cuda",
                  "--block_size", "2", "--max_new_tokens", str(n_gen), "--max_wave_requests",
                  "2", "--router_health_poll_s", "0.05"]
    chaos_kill = ["--chaos", "--chaos_error_rate", "1.0", "--chaos_sites", "replica_kill",
                  "--chaos_max_faults", "1", "--chaos_seed", "1234"]

    def add(counts, local):
        launches = {k: {"launches": counts[k], "local_launches": local[k]} for k in counts}
        _add_launches(paths[path], launches)
        return counts

    def same_tokens(tag, scores, updated, idxs) -> float:
        # Tokens (the text) and argmax of the default engine's; returns the
        # largest score gap (bf16, other wave groupings).
        for j, i in enumerate(idxs):
            if (updated[j] != def_updated[i]
                    or not np.array_equal(np.asarray(scores[j]).argmax(-1),
                                          def_scores[i].argmax(-1))):
                fail(f"fleet {tag}: request {i}'s tokens or argmax differ from the default "
                     "engine's")
        return max(float(np.abs(np.asarray(scores[j]) - def_scores[i]).max())
                   for j, i in enumerate(idxs))

    def line(tag, stats, timing, launches, wall, **more):
        log(f"[fleet] {tag} | {smi} | " + json.dumps({
            "wall_s": wall, "ttft_s": timing.get("ttft_s"),
            "token_latency_s": timing.get("token_latency_s"), **fleet_totals(stats),
            "router": stats["router"], "autoscale": stats.get("autoscale"),
            "stagger": stats.get("stagger"), "kernels": launches, **more}))

    def threads_left():
        return [t.name for t in threading.enumerate()
                if t.name in ("serve-engine", "fleet-monitor", "fleet-autoscale")]

    # -- N threads launching at once, at the serve block's shapes --------------
    check_concurrent_launches(main_path_case(prompts[:2], n_gen),
                              torch.Generator(device="cuda").manual_seed(99))

    # -- fleet_parity: serve --replicas 3, a fresh process -----------------------
    sc, up, dump, secs = fleet_cli(model_dir, work, "fleet_parity", prompts,
                                   [*serve_args, "--replicas", "3", "--stagger_ms", "150"], vocab)
    stats, router = dump["stats"], dump["stats"]["router"]
    counts = add(dump["launches"], dump["local_launches"])
    gap = same_tokens("fleet_parity", sc, up, range(n))
    line("fleet_parity", stats, dump["timing"], counts, stats["wall_s"], process_s=secs,
         max_abs_vs_default=gap, peak_mem_gb=stats.get("peak_mem_gb"),
         allocated_after_shutdown_gb=dump["allocated_after_gb"],
         host_rss_gib=stats.get("host_rss_gib"))
    served = fleet_totals(stats)["completed_by_replica"]
    if (router["dispatches"] != n or router["redispatches"] != 0 or sum(served.values()) != n
            or len(stats["replicas"]) != 3 or min(served.values()) < 1):
        fail(f"fleet_parity: router {router}, completed by replica {served}")
    log(f"[fleet] fleet_parity: 3 replicas served {served}, tokens and argmax of the default "
        f"engine, scores within {gap:.4e} of it (bf16, other wave groupings)")

    # -- fleet_kill: one seeded replica_kill, a fresh process ----------------------
    sc, up, dump, secs = fleet_cli(model_dir, work, "fleet_kill", prompts,
                                   [*serve_args, "--replicas", "3", "--stagger_ms", "150",
                                    *chaos_kill], vocab)
    stats, router = dump["stats"], dump["stats"]["router"]
    counts = add(dump["launches"], dump["local_launches"])
    gap = same_tokens("fleet_kill", sc, up, range(n))
    line("fleet_kill", stats, dump["timing"], counts, stats["wall_s"], process_s=secs,
         max_abs_vs_default=gap, peak_mem_gb=stats.get("peak_mem_gb"),
         allocated_after_shutdown_gb=dump["allocated_after_gb"],
         host_rss_gib=stats.get("host_rss_gib"))
    if (router["replicas_dead"] != 1 or router["redispatches"] < 1
            or router["replicas_recycled"] != 1 or router["expired_orphans"] != 0
            or sum(fleet_totals(stats)["completed_by_replica"].values()) != n
            or stats["tokens_served"] != n * n_gen):
        fail(f"fleet_kill: router {router}, completed "
             f"{fleet_totals(stats)['completed_by_replica']}, tokens_served "
             f"{stats['tokens_served']}")
    log(f"[fleet] fleet_kill: replica killed, {router['redispatches']} re-dispatched, slot "
        f"recycled; tokens and argmax of the default engine")

    # -- in process: the device memory of a kill and a recycle -------------------
    def mk_fleet(start=True, faults=None, **kw):
        fw = FrameworkConfig(model_path=model_dir, dtype="bfloat16", layer_num_per_shard=1,
                             block_size=2, device="cuda", disk_folder=os.path.join(work, "fleet"),
                             faults=faults or FaultConfig())
        sc = ServeConfig(**{"max_wave_requests": 2, "default_max_new_tokens": n_gen,
                            "router_health_poll_s": 0.05, **kw})
        return ReplicaFleet(fw, sc, tokenizer=BenchTokenizer(vocab), device=torch.device("cuda"),
                            start=start)

    def wait_for(what, cond, limit=120.0):
        deadline = time.monotonic() + limit
        while not cond():
            if time.monotonic() > deadline:
                fail(f"fleet: timed out waiting for {what}")
            time.sleep(0.01)

    def ready(fleet):  # every replica's weights on the card
        return all(r.engine._kept is not None for r in list(fleet._replicas))

    def idle(fleet):
        return all(r.serving and len(r.engine.queue) == 0 and not r.engine.batcher.waves
                   for r in list(fleet._replicas))

    def served_in_process(tag, fleet, idxs, wait_ready=True, between=None):
        if wait_ready:
            wait_for(f"{tag}'s weights", lambda: ready(fleet))
        kvpool.reset_process_pools()
        fa.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        reqs = [fleet.submit(*prompts[i]) for i in idxs]
        if between is not None:
            between()
        res = [r.future.result(timeout=300) for r in reqs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = add(fa.launch_counts(), fa.local_launch_counts())
        gap = same_tokens(tag, [r.scores for r in res], [r.updated for r in res], idxs)
        return reqs, wall, counts, gap

    fresh_process_state()
    # Every replica draws at each shard step; 8 requests keep all 3 busy
    # for about 9 sweeps of 7 shards, so a first kill at the 107th draw
    # (about every replica's sixth sweep) lands mid-decode, whichever
    # replica takes it.
    n_shards = len(plan_shards_dp(len(checkpoint.layer_names_for(cfg.num_hidden_layers)),
                                  1).shards)
    kill_rate = 0.02
    kill_seed = first_kill_seed(3 * n_shards * 5 + 1, kill_rate)

    fleet = mk_fleet(replicas=3, faults=FaultConfig(enabled=True, seed=kill_seed,
                                                    error_rate=kill_rate,
                                                    sites=("replica_kill",), max_faults=1))
    kill = watch_kill(fleet)
    try:
        wait_for("the clean fleet's weights", lambda: ready(fleet))
        clean_raw, clean = settled_allocated()
        rss_clean = host_rss_gib().get("rss")
        reqs, wall, counts, gap = served_in_process("fleet_kill_memory", fleet, range(n),
                                                    wait_ready=False)
        peak = torch.cuda.max_memory_allocated()
        wait_for("the recycled replica", lambda: fleet.metrics.counter("replicas_recycled") == 1
                 and ready(fleet) and idle(fleet))
        after_raw, after = settled_allocated()
        rss_after = host_rss_gib().get("rss")
        stats = fleet.stats()
    finally:
        ok = fleet.shutdown(drain=True, timeout=120)
    bound = min(kill.get("state_bytes", 0), one_replica // 4)
    line("fleet_kill_memory", stats, request_timing(reqs), counts, wall, max_abs_vs_default=gap,
         kill_seed=kill_seed, kill=kill, clean_allocated_gb=clean / 1e9,
         after_recycle_allocated_gb=after / 1e9, bound_gb=bound / 1e9,
         clean_with_cublas_workspaces_gb=clean_raw / 1e9,
         after_with_cublas_workspaces_gb=after_raw / 1e9,
         peak_allocated_gb=peak / 1e9, one_replica_weights_gb=one_replica / 1e9,
         host_rss_clean_gib=rss_clean, host_rss_after_recycle_gib=rss_after)
    if stats["tokens_served"] != n * n_gen:
        fail(f"fleet_kill_memory: tokens_served {stats['tokens_served']}, not the {n * n_gen} "
             "of the requests resolved")
    if (not kill or max(kill["steps"], default=0) < 1 or kill["state_bytes"] <= 0
            or stats["router"]["replicas_dead"] != 1 or stats["router"]["redispatches"] < 1):
        fail(f"fleet_kill_memory: the kill did not land mid-decode (in a decode sweep of a "
             f"prefilled wave, with device state held): {kill}; router {stats['router']}")
    if after - clean >= bound:
        fail(f"fleet_kill_memory: {after - clean} more bytes allocated after the kill and "
             f"recycle than in the clean fleet, not under {bound} (the victim's wave state at "
             f"the kill, {kill['state_bytes']}, or a quarter of one replica's weights, "
             f"{one_replica})")
    if not ok or threads_left():
        fail(f"fleet_kill_memory: shutdown {ok}, threads left {threads_left()}")
    log(f"[fleet] fleet_kill_memory: replica {kill['replica']} killed at shard {kill['shard']} "
        f"with waves at steps {kill['steps']} holding {kill['state_bytes'] / 1e9:.4f} GB on the "
        f"card; allocated {clean / 1e9:.4f} GB clean, {after / 1e9:.4f} GB after the kill, "
        f"recycle and drain, cuBLAS workspaces freed ({clean_raw / 1e9:.4f} and "
        f"{after_raw / 1e9:.4f} GB with them; bound {bound / 1e9:.4f} GB; one replica's weights "
        f"{one_replica / 1e9:.3f} GB); host RSS {rss_clean} -> {rss_after} GiB")

    # -- fleet_stall: a wedged engine thread, found by its watermark ------------
    fleet = mk_fleet(replicas=2, watchdog_abort_s=2.5,
                     faults=FaultConfig(enabled=True, seed=1234, error_rate=1.0,
                                        sites=("replica_stall",), max_faults=1))
    try:
        reqs, wall, counts, gap = served_in_process("fleet_stall", fleet, range(n))
        stats = fleet.stats()
    finally:
        ok = fleet.shutdown(drain=True, timeout=120)
    totals = fleet_totals(stats)
    line("fleet_stall", stats, request_timing(reqs), counts, wall, max_abs_vs_default=gap,
         shutdown_ok=ok, peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    if (stats["router"]["replicas_dead"] < 1 or sum(totals["completed_by_replica"].values()) != n
            or not ok or threads_left()):
        fail(f"fleet_stall: router {stats['router']}, completed "
             f"{totals['completed_by_replica']}, shutdown {ok}, threads left {threads_left()}")
    log(f"[fleet] fleet_stall: the wedged replica hard-failed on its watermark, "
        f"completed {totals['completed_by_replica']} (the released thread counted nothing), "
        "shutdown True with no thread left")

    # -- fleet_elastic: join while in flight, drain out, hard remove -------------
    fleet = mk_fleet(replicas=2, max_active_requests=2)
    try:
        added = []
        reqs, wall, counts, gap = served_in_process(
            "fleet_elastic_join", fleet, range(4), between=lambda: added.append(fleet.add_replica()))
        if not fleet.remove_replica(added[0], drain=True, timeout=120):
            fail("fleet_elastic: the drained replica did not retire")
        redisp = fleet.metrics.counter("redispatches")
        idxs = [4, 5, 6, 7, 0, 1]

        def hard_remove():
            # The replica holding the most work, queued and in flight.
            victim = max(fleet._replicas, key=lambda r: len(r.engine.queue)
                         + r.engine.batcher.active_requests)
            fleet.remove_replica(victim.idx, drain=False)

        reqs2, wall2, counts2, gap2 = served_in_process("fleet_elastic_remove", fleet, idxs,
                                                        between=hard_remove)
        refused = False
        try:
            fleet.remove_replica(drain=True)
        except ValueError as e:
            refused = "last serving replica" in str(e)
        stats = fleet.stats()
    finally:
        ok = fleet.shutdown(drain=True, timeout=120)
    r = stats["router"]
    line("fleet_elastic", stats, request_timing(reqs + reqs2), counts, wall + wall2,
         max_abs_vs_default=max(gap, gap2), redispatched_by_hard_remove=r["redispatches"] - redisp)
    if (r["replicas_added"] != 1 or r["replicas_drained"] != 1 or r["replicas_removed"] != 2
            or r["redispatches"] <= redisp or not refused or not ok):
        fail(f"fleet_elastic: router {r}, last replica refused {refused}, shutdown {ok}")
    log(f"[fleet] fleet_elastic: a replica added in flight and drained out, one removed hard "
        f"({r['redispatches'] - redisp} re-dispatched), the last one's removal refused; tokens "
        "and argmax of the default engine")

    # -- fleet_autoscale: a burst grows the fleet, idle shrinks it back ----------
    auto = AutoscaleConfig(enabled=True, min=1, max=2, poll_s=0.05, confirm_polls=1,
                           grow_queue_frac=0.25, shrink_queue_frac=0.01, grow_cooldown_s=0.0,
                           shrink_cooldown_s=3.0)
    # Queued before the start: the autoscaler sees the burst while replica 0
    # loads its weights.
    fleet = mk_fleet(start=False, replicas=1, queue_capacity=16, autoscale=auto)
    try:
        kvpool.reset_process_pools()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        reqs = [fleet.submit(*p) for p in prompts]
        fleet.start()
        res = [q.future.result(timeout=300) for q in reqs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = add(fa.launch_counts(), fa.local_launch_counts())
        gap = same_tokens("fleet_autoscale", [q.scores for q in res], [q.updated for q in res],
                          range(n))
        wait_for("the shrink back to 1", lambda: fleet.population() == 1
                 and fleet.drains_in_flight() == 0, limit=60.0)
        stats = fleet.stats()
    finally:
        ok = fleet.shutdown(drain=True, timeout=120)
    a = stats["autoscale"]
    line("fleet_autoscale", stats, request_timing(reqs), counts, wall, max_abs_vs_default=gap,
         stagger_error=stats["stagger"]["stagger_error"])
    if a["grows"] < 1 or a["shrinks"] < 1 or not ok:
        fail(f"fleet_autoscale: autoscale {a}, shutdown {ok}")
    log(f"[fleet] fleet_autoscale: {a['grows']} grow(s) under the burst, {a['shrinks']} "
        f"shrink(s) once idle, stagger error {stats['stagger']['stagger_error']} (the fleet "
        "source)")

    # -- fleet_wal: SIGKILL a 3-replica process, replay into 2 -------------------
    budgets = [n_gen] * n
    wal_dir, done, secs = wal_drill(model_dir, work, "fleet_crash", prompts, budgets, vocab,
                                    {"FLS_WAL_CRASH_SWEEPS": "3"}, -9,
                                    extra=("--replicas", "3", "--router_health_poll_s", "0.05"))
    summary, replies, scores, r_stats, launches, r_secs = wal_restart(
        model_dir, work, "fleet_crash", wal_dir, vocab,
        extra=("--replicas", "2", "--router_health_poll_s", "0.05"))
    _add_launches(paths[path], launches)
    want = {f"w{i}": _new_tokens(def_updated[i], prompts[i]) for i in range(n)}
    got = {cid: [[str(t) for t in row] for row in d["tokens"]]
           for cid, d in {**done, **replies}.items()}
    wrong = [cid for cid in want if got.get(cid) != want[cid]]
    r = r_stats["router"]
    log(f"[fleet] fleet_wal_restart | {smi} | " + json.dumps({
        "wall_s": r_stats["wall_s"], "drill_process_s": secs, "restart_process_s": r_secs,
        "done_before": sorted(done), "replay": summary, **fleet_totals(r_stats), "router": r,
        "kernels": {k: v["launches"] for k, v in launches.items()}}))
    if (wrong or summary["replayed"] != n - len(done) or len(r_stats["replicas"]) != 2
            or r["dispatches"] != summary["replayed"] or r["redispatches"] != 0):
        fail(f"fleet_wal: tokens differ for {wrong}, replay {summary}, router {r}, replicas "
             f"{sorted(r_stats['replicas'])}")
    log(f"[fleet] fleet_wal: SIGKILL of the 3-replica process with {len(done)} done; the "
        f"2-replica restart replayed {summary['replayed']}, one dispatch each; merged tokens "
        "equal the default engine's")

    missing = [k for k in fa.KERNELS if paths[path].get(k, {}).get("launches", 0) == 0]
    if missing:
        fail(f"fleet: kernels never launched on the {path} path: {missing}")
    log(f"[fleet] phase wall {time.perf_counter() - t_phase:.3f} s | {smi}")
    return paths


# DP's scores against the single device's: the float32 card-against-CPU
# tolerance of the cross phase. The ranks' blocks are the single run's
# (block size 2, each rank's prompts whole blocks), so the expectation is
# bit equality; the tolerance is what the check allows.
DP_ATOL = 1e-4


def phase_multidevice(work: str, model_dir: str, cfg, prompts, n_gen_kv: int, smi: str) -> dict:
    """The reference's two multi-device modes on the 4-layer Llama-2-7B
    cell, through the library entry points (``run_prompts`` with num_batch
    2, ``run_decode`` with ``n_gen_kv`` tokens at the defaults), one layer
    per shard, blocks of 2:

    - MP over [cuda:0] * 4 (7 execution layers in 8 stages, the last a
      padding stage): scores and tokens equal the single-device run's bit
      for bit, scoring's stream its bytes;
    - DP over [cuda:0] * 2 (two rank threads fed by one read of each shard
      per pass; decode resident, each rank capturing its blocks' steps as
      CUDA graphs): tokens equal, scores within ``DP_ATOL``, and
      ``streamed_bytes`` equal to the single-device run's;
    - with more than one card, the same over the real cards.

    Every MP and DP run must launch the path's kernels. Each run prints its
    wall, streamed bytes, launches and the card's name and power limit.
    Returns the launches of the MP runs and of the DP runs."""
    from flexible_llm_sharding_tpu_torch.config import FrameworkConfig
    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa
    from flexible_llm_sharding_tpu_torch.runtime import orchestration

    t_phase = time.perf_counter()
    fresh_process_state()
    base = dict(model_path=model_dir, dtype="bfloat16", layer_num_per_shard=1, block_size=2,
                device="cuda", disk_folder=os.path.join(work, "multidevice_disk"))
    scoring = ("flash_causal_attention", "flash_prefix_shared_attention")
    paths: dict = {"llama2_7b_mp": {}, "llama2_7b_dp": {}}

    def run(tag, devices, kv, path=None, **kw):
        run_cfg = FrameworkConfig(**base, **kw)
        calls: list = []
        fa.reset_launch_counts()
        torch.cuda.synchronize()
        for dev in set(devices):  # each run's own peak
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        if kv:
            scores, updated, _ = orchestration.run_decode(
                run_cfg, prompts, tokenizer=BenchTokenizer(cfg.vocab_size), devices=devices,
                calls=calls)
        else:
            scores = orchestration.run_prompts(run_cfg, prompts,
                                               tokenizer=BenchTokenizer(cfg.vocab_size),
                                               devices=devices, calls=calls)
            updated = None
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, local = fa.launch_counts(), fa.local_launch_counts()
        _check_scores(scores, prompts, n_gen_kv if kv else 1, cfg.vocab_size,
                      f"multidevice {tag}")
        needed = fa.KERNELS if kv else scoring
        if path is not None:
            if any(counts[k] == 0 for k in needed):
                fail(f"multidevice {tag}: a kernel of the path never launched: {counts}")
            _add_launches(paths[path], {k: {"launches": counts[k], "local_launches": local[k]}
                                        for k in fa.KERNELS})
        streamed = sum(c["streamed_bytes"] for c in calls)
        keys = ("dispatch_wall_s", "compute_wall_s", "source_wait_s", "load_weights_time_s",
                "decode_resident", "decode_fused", "decode_graph", "peak_mem_gb")
        log(f"[multidevice] {tag} on {len(devices)} x {sorted({str(d) for d in devices})}: "
            f"wall {wall:.4f} s, streamed {streamed:.0f} B, launches {json.dumps(counts)}, "
            + json.dumps({k: calls[-1][k] for k in keys if k in calls[-1]}) + f" ({smi})")
        return scores, updated, streamed

    def same(a, b) -> bool:
        return all(np.array_equal(x, y) for x, y in zip(a, b))

    def compare(tag, got, ref, exact: bool) -> None:
        scores, updated, streamed = got
        ref_scores, ref_updated, ref_streamed = ref
        tokens = (updated == ref_updated and all(
            np.array_equal(g.argmax(-1), r.argmax(-1)) for g, r in zip(scores, ref_scores)))
        err = max(float(np.abs(g - r).max()) for g, r in zip(scores, ref_scores))
        bit = same(scores, ref_scores)
        if not tokens or (exact and not bit) or err > DP_ATOL:
            fail(f"multidevice {tag}: tokens equal {tokens}, bit-equal {bit}, largest score "
                 f"difference {err} (bound {'0' if exact else DP_ATOL})")
        if streamed != ref_streamed:
            fail(f"multidevice {tag}: streamed {streamed} bytes, the single device {ref_streamed}")
        log(f"[multidevice] {tag}: tokens equal, scores bit-equal {bit}, largest difference "
            f"{err}, streamed bytes equal ({streamed:.0f})")

    card = torch.device("cuda", 0)
    layouts = [("", [card] * 4, [card] * 2)]
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        cards = [torch.device("cuda", i) for i in range(n_cards)]
        layouts.append(("_cards", cards[:4], cards[:2]))
    for kv in (False, True):
        kind = "decode" if kv else "scoring"
        extra = {"kv_cache": True, "num_gen_token": n_gen_kv} if kv else {"num_batch": 2}
        ref = run(f"{kind}_one_device", [card], kv, **extra)
        for suffix, mp_devs, dp_devs in layouts:
            compare(f"{kind}_mp{suffix}", run(f"{kind}_mp{suffix}", mp_devs, kv,
                                              "llama2_7b_mp", **extra), ref, exact=True)
            compare(f"{kind}_dp{suffix}", run(f"{kind}_dp{suffix}", dp_devs, kv, "llama2_7b_dp",
                                              data_parallel=True, **extra), ref, exact=False)
    log(f"[multidevice] phase {time.perf_counter() - t_phase:.1f} s")
    return paths


LONGCTX_CAP = 1024  # per device; over 4 ranks an sp cap of 4096
LONGCTX_TOL = dict(rtol=2e-4, atol=1e-5)


def phase_longctx(work: str, model_dir: str, cfg, smi: str, card=None) -> dict:
    """Long context over a device list on the 4-layer Llama-2-7B cell, in
    float32, one layer per shard, through the library entry points: a
    prompt whose prefix (3000 tokens, 4 suffixes of 32) is past a
    per-device cap of ``LONGCTX_CAP`` and one of 512 words under it.

    (a) ``run_prompts`` with ``long_context`` over [card] * 4 equals the
    untruncated single-device run at a cap of 4096 (which runs the scoring
    kernels) within ``LONGCTX_TOL``; (b) the cap without ``long_context``
    truncates and differs; (c) ``run_decode`` with 4 tokens: the
    single-device decode's tokens, distributions within ``LONGCTX_TOL``;
    (d) the short prompt launches the scoring kernels and, in decode, the
    decode kernel; the sp pass alone launches none; (e) the sp pass
    streams one device's bytes; (f) with several cards, (a) over them,
    streaming once per card. Each run prints its wall, load seconds, peak
    memory, streamed bytes and launches beside the card's name and power
    limit. Returns the launches of the long-context runs."""
    from flexible_llm_sharding_tpu_torch.config import FrameworkConfig
    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa
    from flexible_llm_sharding_tpu_torch.runtime import orchestration

    t_phase = time.perf_counter()
    fresh_process_state()
    card = torch.device("cuda", 0) if card is None else card
    cuda = card.type == "cuda"
    long_prompt = make_prompts(1, 2999, 4, 32, seed=20)[0]
    prompts = [long_prompt, make_prompts(1, 512, 4, 32, seed=21)[0]]
    tok = BenchTokenizer(cfg.vocab_size)
    n_long = len(tok(long_prompt[0])["input_ids"])
    if not LONGCTX_CAP < n_long <= 4 * LONGCTX_CAP:
        fail(f"longctx: a {n_long}-token prefix is not past one device's cap")
    base = dict(model_path=model_dir, dtype="float32", layer_num_per_shard=1,
                device=card.type)
    scoring = ("flash_causal_attention", "flash_prefix_shared_attention")
    launches: dict = {}

    def run(tag, devices, kv=False, ps=prompts, counted=True, **kw):
        run_cfg = FrameworkConfig(**base, **kw)
        calls: list = []
        fa.reset_launch_counts()
        if cuda:
            torch.cuda.synchronize()
            for dev in set(devices):
                torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        if kv:
            scores, updated, _ = orchestration.run_decode(run_cfg, ps, tokenizer=tok,
                                                          devices=devices, calls=calls)
        else:
            scores = orchestration.run_prompts(run_cfg, ps, tokenizer=tok, devices=devices,
                                               calls=calls)
            updated = None
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = fa.launch_counts()
        _check_scores(scores, ps, kw.get("num_gen_token", 1), cfg.vocab_size, f"longctx {tag}")
        if counted:
            _add_launches(launches, {k: {"launches": counts[k], "local_launches": 0}
                                     for k in fa.KERNELS})
        peak = max((c.get("peak_mem_gb", 0.0) for c in calls), default=0.0)
        log(f"[longctx] {tag} on {len(devices)} x {sorted({str(d) for d in devices})}: wall "
            f"{wall:.4f} s, load_weights_time_s "
            f"{sum(c['load_weights_time_s'] for c in calls):.4f}, peak {peak:.3f} GB, streamed "
            f"{[c['streamed_bytes'] for c in calls]} B, launches {json.dumps(counts)} ({smi})")
        return scores, updated, calls, counts

    def close(tag, got, want) -> float:
        err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
        if not all(np.allclose(g, w, **LONGCTX_TOL) for g, w in zip(got, want)):
            fail(f"longctx {tag}: scores differ from the untruncated single-device run's "
                 f"(largest difference {err}, tolerance {LONGCTX_TOL})")
        return err

    long_cfg = dict(max_token_len=LONGCTX_CAP, long_context=True)
    ref, _, ref_calls, ref_counts = run("scoring_one_device_cap4096", [card], counted=False,
                                        max_token_len=4 * LONGCTX_CAP)
    if any(ref_counts[k] == 0 for k in scoring):
        fail(f"longctx: the single-device reference launched no scoring kernel: {ref_counts}")
    one_pass = ref_calls[0]["streamed_bytes"]
    # (a) and (d): both prompts; the short one takes the normal path.
    got, _, calls, counts = run("scoring_sp4", [card] * 4, **long_cfg)
    err = close("scoring_sp4", got, ref)
    if any(counts[k] == 0 for k in scoring):
        fail(f"longctx: the normal-path prompt launched no scoring kernel: {counts}")
    # (d) and (e): the long prompt alone is the sp pass.
    _, _, sp_calls, sp_counts = run("scoring_sp4_long_only", [card] * 4, ps=prompts[:1],
                                    **long_cfg)
    if any(sp_counts.values()):
        fail(f"longctx: the sequence-parallel pass launched a kernel: {sp_counts}")
    if [c["streamed_bytes"] for c in sp_calls] != [one_pass]:
        fail(f"longctx: the sp pass over [card] * 4 streamed "
             f"{[c['streamed_bytes'] for c in sp_calls]} B, one device's pass {one_pass} B")
    # (b) the reference's truncation at the per-device cap.
    trunc, _, _, _ = run("scoring_one_device_cap1024", [card], ps=prompts[:1],
                         max_token_len=LONGCTX_CAP)
    if np.allclose(trunc[0], ref[0], **LONGCTX_TOL):
        fail("longctx: the truncated run equals the untruncated one")
    log(f"[longctx] scoring exact: largest difference {err} (tolerance {LONGCTX_TOL}); "
        f"truncated at {LONGCTX_CAP} differs by {float(np.abs(trunc[0] - ref[0]).max())}; "
        f"sp pass streamed {one_pass} B = one device's")
    # (c) KV decode, 4 tokens.
    n_gen = 4
    want, want_up, _, _ = run("decode_one_device_cap4096", [card], kv=True, counted=False,
                              max_token_len=4 * LONGCTX_CAP, num_gen_token=n_gen)
    got, got_up, _, counts = run("decode_sp4", [card] * 4, kv=True, num_gen_token=n_gen,
                                 **long_cfg)
    tokens = got_up == want_up and all(np.array_equal(g.argmax(-1), w.argmax(-1))
                                       for g, w in zip(got, want))
    if not tokens:
        fail("longctx: the sp decode's tokens differ from the single-device decode's")
    err = close("decode_sp4", got, want)
    if counts["flash_decode_attention"] == 0:
        fail(f"longctx: the normal-path prompt's decode launched no decode kernel: {counts}")
    log(f"[longctx] decode exact: tokens equal, largest difference {err}")
    # (f) several cards.
    n_cards = torch.cuda.device_count() if cuda else 1
    if n_cards > 1:
        cards = [torch.device("cuda", i) for i in range(min(n_cards, 4))]
        got, _, calls, _ = run("scoring_sp_cards", cards, ps=prompts[:1], **long_cfg)
        close("scoring_sp_cards", got, ref[:1])
        if calls[0]["streamed_bytes"] != len(cards) * one_pass:
            fail(f"longctx: the sp pass over {len(cards)} cards streamed "
                 f"{calls[0]['streamed_bytes']} B, not {len(cards)} x {one_pass}")
    log(f"[longctx] phase {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


# The use_pallas phase's bound on the float32 distributions: Llama-2's
# 32,000 entries average 3.1e-5 each, so the bound is 1/30 of a typical one.
USE_PALLAS_TOL = dict(atol=1e-6, rtol=0.0)
USE_PALLAS_LAYERS = 2


def layer_view(src: str, dst: str, n_layers: int) -> None:
    """A model directory of ``src``'s first ``n_layers`` decoder layers: its
    layer files hard-linked (nothing copied), their integrity entries and
    its config at that depth."""
    from flexible_llm_sharding_tpu_torch.integrity import manifest
    from flexible_llm_sharding_tpu_torch.utils import checkpoint

    with open(os.path.join(src, "config.json")) as f:
        conf = json.load(f)
    conf["num_hidden_layers"] = n_layers
    names = checkpoint.layer_names_for(n_layers, bool(conf.get("tie_word_embeddings")))
    entries = manifest.load_manifest(src)["layers"]
    os.makedirs(dst)
    for name in names:
        os.link(os.path.join(src, entries[name]["file"]), os.path.join(dst, entries[name]["file"]))
    manifest.write_manifest(dst, {name: entries[name] for name in names})
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(conf, f)


def phase_use_pallas(work: str, model_dir: str, cfg, prompts, smi: str, card=None,
                     record: dict | None = None) -> dict:
    """``use_pallas`` on the Llama-2-7B cell at ``USE_PALLAS_LAYERS`` layers
    (a :func:`layer_view` of ``model_dir``), float32, one layer per shard,
    through the library entry points: one scoring call (``run_prompts``), a
    4-token KV decode (``run_decode``) and one wave of a ``ServeEngine``
    (every prompt submitted before it starts), each at the default (True)
    and at ``use_pallas=False``. Under False no kernel launches; under the default
    each kernel the run reaches launches; the scores agree within
    ``USE_PALLAS_TOL`` and the greedy tokens are equal. Each run prints its
    wall and launches beside the card's name and power limit (the default
    scoring run, the first, reads the layer files from disk; the others
    hit the host shard cache). With ``record`` (a dict) ``record[kind]``
    gets each default run's (scores, updated prompts, launches). Returns
    the default runs' launches."""
    from flexible_llm_sharding_tpu_torch.config import FrameworkConfig, ServeConfig
    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa
    from flexible_llm_sharding_tpu_torch.runtime import orchestration
    from flexible_llm_sharding_tpu_torch.serve import ServeEngine

    t_phase = time.perf_counter()
    fresh_process_state()
    view = os.path.join(work, f"llama2-7b-{USE_PALLAS_LAYERS}-view")
    layer_view(model_dir, view, USE_PALLAS_LAYERS)
    card = torch.device("cuda", 0) if card is None else card
    cuda = card.type == "cuda"
    tok = BenchTokenizer(cfg.vocab_size)
    n_gen = 4
    scoring = ("flash_causal_attention", "flash_prefix_shared_attention")
    wants = {"scoring": scoring, "kv_cache": fa.KERNELS, "serve": fa.KERNELS}

    def serve(run_cfg):
        eng = ServeEngine(run_cfg, ServeConfig(max_wave_requests=len(prompts),
                                               default_max_new_tokens=n_gen, stats_interval_s=0),
                          tokenizer=tok, device=card, start=False)
        try:
            reqs = [eng.submit(*p) for p in prompts]
            eng.start()
            results = [r.future.result(timeout=600) for r in reqs]
        finally:
            eng.shutdown(drain=True)
        if eng.metrics.counter("prefills") != 1:
            fail(f"use_pallas serve: {eng.metrics.counter('prefills')} prefills, not one wave")
        return [r.scores for r in results], [r.updated for r in results]

    def run(kind: str, use_pallas):
        run_cfg = FrameworkConfig(model_path=view, dtype="float32", layer_num_per_shard=1,
                                  device=card.type, use_pallas=use_pallas,
                                  num_gen_token=n_gen if kind == "kv_cache" else 1)
        fa.reset_launch_counts()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "scoring":
            scores, updated = orchestration.run_prompts(run_cfg, prompts, tokenizer=tok,
                                                        devices=[card]), None
        elif kind == "kv_cache":
            scores, updated, _ = orchestration.run_decode(run_cfg, prompts, tokenizer=tok,
                                                          devices=[card])
        else:
            scores, updated = serve(run_cfg)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = fa.launch_counts()
        tag = f"{kind} use_pallas={use_pallas}"
        _check_scores(scores, prompts, 1 if kind == "scoring" else n_gen, cfg.vocab_size,
                      f"use_pallas {tag}")
        if cuda and use_pallas and any(counts[k] == 0 for k in wants[kind]):
            fail(f"use_pallas {tag}: a kernel of the run never launched: {counts}")
        if not use_pallas and any(counts.values()):
            fail(f"use_pallas {tag}: a kernel launched under use_pallas=False: {counts}")
        log(f"[use_pallas] {tag}: wall {wall:.4f} s, launches {json.dumps(counts)} ({smi})")
        return scores, updated, counts

    launches: dict = {}
    try:
        for kind in ("scoring", "kv_cache", "serve"):
            ref, ref_up, counts = run(kind, True)
            if record is not None:
                record[kind] = (ref, ref_up, counts)
            _add_launches(launches, {k: {"launches": counts[k], "local_launches": 0}
                                     for k in fa.KERNELS})
            got, got_up, _ = run(kind, False)
            err = max(float(np.abs(g - r).max()) for g, r in zip(got, ref))
            if not all(np.allclose(g, r, **USE_PALLAS_TOL) for g, r in zip(got, ref)):
                fail(f"use_pallas {kind}: the plain ops' scores differ from the kernels' "
                     f"(largest difference {err}, tolerance {USE_PALLAS_TOL})")
            if got_up != ref_up or not all(np.array_equal(g.argmax(-1), r.argmax(-1))
                                           for g, r in zip(got, ref)):
                fail(f"use_pallas {kind}: the plain ops' greedy tokens differ from the kernels'")
            log(f"[use_pallas] {kind}: tokens equal, largest difference {err} "
                f"(tolerance {USE_PALLAS_TOL})")
    finally:
        shutil.rmtree(view, ignore_errors=True)
    log(f"[use_pallas] phase {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


TP_LAYERS = USE_PALLAS_LAYERS
TP_TOL_F32 = USE_PALLAS_TOL
# tests/test_tp.py's bf16 bound (JAX's test_tp_bfloat16), against the bf16
# single-device run.
TP_TOL_BF16 = dict(atol=2e-3, rtol=2e-2)
# A bf16 TP run is also held to the float32 single-device run (the truth
# both bf16 runs approximate): its mean absolute difference from it, over
# every probability of every scored position, may be at most this multiple
# of the bf16 single device's own. Summing the ranks' partials in float32
# and rounding once leaves TP as exact as one device, so the two means
# differ only by where the roundings fall; TP adding rounding noise of its
# own as large as bf16's would raise its mean by about 1.4 x. The largest
# difference is no such measure: it is the rounding luck of one position's
# largest probabilities, and is only reported.
TP_BF16_FACTOR = 1.25


def _max_diff(a, b) -> float:
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def _mean_diff(a, b) -> float:
    return float(np.mean(np.concatenate([np.abs(x - y).ravel() for x, y in zip(a, b)])))


def bf16_against_f32(tag: str, scores, one_scores, f32_scores) -> str:
    """Hold a bf16 run's ``scores`` against the bf16 single-device run's
    (``one_scores``) and the float32 single-device run's (``f32_scores``):
    within ``TP_TOL_BF16`` of the bf16 run; a mean absolute difference from
    the float32 run at most ``TP_BF16_FACTOR`` times the bf16 single
    device's; and a greedy token different from the bf16 single device's
    only where the float32 run's probabilities of the two tokens lie closer
    than the bf16 single device's largest difference from it (e1: a tie
    that the bf16 error can turn either way). Fails otherwise; returns the
    figures for the log."""
    e1, err = _max_diff(one_scores, f32_scores), _max_diff(scores, f32_scores)
    m1, mean = _mean_diff(one_scores, f32_scores), _mean_diff(scores, f32_scores)
    to_one = _max_diff(scores, one_scores)
    if not all(np.allclose(g, r, **TP_TOL_BF16) for g, r in zip(scores, one_scores)):
        fail(f"tp {tag}: scores differ from the bf16 single device's (largest difference "
             f"{to_one}, tolerance {TP_TOL_BF16})")
    if not mean <= TP_BF16_FACTOR * m1:
        fail(f"tp {tag}: mean difference from the float32 single device {mean}, more than "
             f"{TP_BF16_FACTOR} x the bf16 single device's {m1}")
    flips = n = 0
    gap_max = 0.0
    for g, o, f in zip(scores, one_scores, f32_scores):
        gi, oi = g.argmax(-1), o.argmax(-1)
        n += gi.size
        moved = gi != oi
        if not moved.any():
            continue
        gap = np.abs(np.take_along_axis(f, oi[..., None], -1)
                     - np.take_along_axis(f, gi[..., None], -1))[..., 0][moved]
        flips += int(moved.sum())
        gap_max = max(gap_max, float(gap.max()))
        if (gap >= e1).any():
            fail(f"tp {tag}: {int((gap >= e1).sum())} greedy tokens differ from the bf16 single "
                 f"device's where the float32 run's gap is not below its error {e1} (largest "
                 f"gap {float(gap.max())})")
    return (f"largest difference {to_one} from the bf16 single device (tolerance "
            f"{TP_TOL_BF16}); from the float32 one mean {mean} (the bf16 single device's {m1}: "
            f"{mean / m1:.4f} x, bound {TP_BF16_FACTOR} x), largest {err} (its {e1}); {flips} of "
            f"{n} greedy tokens differ from the bf16 single device's, each where the float32 gap "
            f"is below {e1} (largest {gap_max})")


def phase_tp(work: str, model_dir: str, cfg, prompts, smi: str, f32_runs: dict,
             card=None) -> dict:
    """Tensor parallelism on the Llama-2-7B cell at ``TP_LAYERS`` layers (a
    :func:`layer_view` of ``model_dir``, the published 32 query and KV heads
    and 4096 hidden), one layer per shard, through the library entry points
    over one card named tp times (``[cuda:0] * tp``; with more than one
    card, over the real cards too):

    - bf16 scoring at tp = 2 and tp = 4 against the bf16 and the float32
      single-device runs (:func:`bf16_against_f32`; the float32 run is the
      ``use_pallas`` phase's, ``f32_runs``);
    - float32 scoring and a 4-token ``--kv_cache`` at tp = 2, with the
      kernels and at ``use_pallas=False``, against the ``use_pallas``
      phase's single-device runs: within ``TP_TOL_F32``, tokens equal;
    - int8 and int4 copies (``requantize_native`` of the view) at tp = 2,
      bf16 compute, against their bf16 and float32 single-device runs, as
      bf16 above;
    - DP×TP over ``[cuda:0] * 4`` (two groups of tp = 2) as bf16 above.

    Every kernel run's launches must be tp times the single-device run's
    (times the groups under DP×TP), 0 under ``use_pallas=False``; each run
    prints its wall, its launches, the bytes its busiest rank uploaded per
    shard beside a whole shard's, the greedy tokens that differ from the
    single device's and the card's name and power limit. Returns the
    launches of the TP runs."""
    from flexible_llm_sharding_tpu_torch.config import FrameworkConfig
    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa
    from flexible_llm_sharding_tpu_torch.runtime import orchestration
    from flexible_llm_sharding_tpu_torch.utils.checkpoint import requantize_native

    t_phase = time.perf_counter()
    fresh_process_state()
    view = os.path.join(work, f"llama2-7b-{TP_LAYERS}-tp-view")
    layer_view(model_dir, view, TP_LAYERS)
    copies = {}
    card = torch.device("cuda", 0) if card is None else card
    tok = BenchTokenizer(cfg.vocab_size)
    n_gen = 4
    n_shards = TP_LAYERS + 3  # one layer per shard: embed, the layers, norm, head
    launches: dict = {}
    f32_launches = {k: 0 for k in fa.KERNELS}

    def run(tag, model, devices, dtype, kind="scoring", **kw):
        run_cfg = FrameworkConfig(model_path=model, dtype=dtype, layer_num_per_shard=1,
                                  device=card.type, disk_folder=os.path.join(work, "tp_disk"),
                                  num_gen_token=n_gen if kind == "kv_cache" else 1, **kw)
        calls: list = []
        fa.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "kv_cache":
            scores, updated, _ = orchestration.run_decode(run_cfg, prompts, tokenizer=tok,
                                                          devices=devices, calls=calls)
        else:
            scores = orchestration.run_prompts(run_cfg, prompts, tokenizer=tok, devices=devices,
                                               calls=calls)
            updated = None
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = fa.launch_counts()
        _check_scores(scores, prompts, n_gen if kind == "kv_cache" else 1, cfg.vocab_size,
                      f"tp {tag}")
        stats = calls[-1]
        per_shard = {"rank": stats.get("tp_rank_bytes", stats["streamed_bytes"]) / n_shards,
                     "shard": stats["streamed_bytes"] / n_shards}
        log(f"[tp] {tag} on {len(devices)} x {sorted({str(d) for d in devices})}: wall "
            f"{wall:.4f} s, launches {json.dumps(counts)}, uploaded bytes per shard: busiest rank "
            f"{per_shard['rank']:.0f} of {per_shard['shard']:.0f}; "
            + json.dumps({k: stats[k] for k in ("decode_fused", "decode_graph", "peak_mem_gb")
                          if k in stats}) + f" ({smi})")
        return scores, updated, counts, per_shard

    def launched(tag, counts, ref_counts, times: int, kernels: bool = True) -> str:
        want = {k: times * ref_counts[k] for k in fa.KERNELS} if kernels else \
            dict.fromkeys(fa.KERNELS, 0)
        if counts != want:
            fail(f"tp {tag}: launches {counts}, want {want} ({times} x the single device's)")
        if kernels:
            _add_launches(launches, {k: {"launches": counts[k], "local_launches": 0}
                                     for k in fa.KERNELS})
        return (f"launches {times} x the single device's" if kernels
                else "launches 0 (use_pallas=False)")

    def compare_f32(tag, got, ref, kernels: bool):
        """A float32 TP run against the float32 single device's: within
        ``TP_TOL_F32``, every greedy token equal."""
        scores, updated, counts, _ = got
        err = _max_diff(scores, ref[0])
        if not all(np.allclose(g, r, **TP_TOL_F32) for g, r in zip(scores, ref[0])):
            fail(f"tp {tag}: scores differ from one device's (largest difference {err}, "
                 f"tolerance {TP_TOL_F32})")
        if updated != ref[1] or not all(np.array_equal(g.argmax(-1), r.argmax(-1))
                                        for g, r in zip(scores, ref[0])):
            fail(f"tp {tag}: greedy tokens differ from one device's")
        log(f"[tp] {tag}: largest difference {err} (tolerance {TP_TOL_F32}), greedy tokens "
            f"equal, {launched(tag, counts, ref[2], 2, kernels)}")
        return counts

    def compare_bf16(tag, got, ref, f32_ref, times: int):
        log(f"[tp] {tag}: {bf16_against_f32(tag, got[0], ref[0], f32_ref[0])}, "
            f"{launched(tag, got[2], ref[2], times)}")

    try:
        card_sets = [("", [card] * 4)]
        if torch.cuda.device_count() > 1:
            card_sets.append(("_cards", [torch.device("cuda", i)
                                         for i in range(torch.cuda.device_count())][:4]))
        ref = run("bf16 one device", view, [card], "bfloat16")
        f32_ref = f32_runs["scoring"]
        for suffix, devs in card_sets:
            for tp in (2, 4):
                if len(devs) >= tp:
                    tag = f"bf16 tp={tp}{suffix}"
                    compare_bf16(tag, run(tag, view, devs[:tp], "bfloat16", tensor_parallel=tp),
                                 ref, f32_ref, tp)
            if len(devs) >= 4:
                # Two groups of 2, each scoring 4 of the 8 prompts in a block
                # of its own: 2 x 2 x the single device's launches.
                tag = f"bf16 dp x tp=2{suffix}"
                compare_bf16(tag, run(tag, view, devs[:4], "bfloat16", tensor_parallel=2,
                                      data_parallel=True), ref, f32_ref, 4)
        for kind in ("scoring", "kv_cache"):
            for use_pallas in (True, False):
                tag = f"float32 {kind} tp=2 use_pallas={use_pallas}"
                counts = compare_f32(tag, run(tag, view, [card] * 2, "float32", kind,
                                              tensor_parallel=2, use_pallas=use_pallas),
                                     f32_runs[kind], kernels=use_pallas)
                for k in fa.KERNELS:
                    f32_launches[k] += counts[k]
        for dt in ("int8", "int4"):
            copies[dt] = os.path.join(work, f"llama2-7b-{TP_LAYERS}-{dt}")
            t0 = time.perf_counter()
            requantize_native(view, copies[dt], dtype=dt)
            log(f"[tp] requantize_native {dt} of the view in {time.perf_counter() - t0:.3f} s")
            q_f32 = run(f"{dt} one device float32", copies[dt], [card], "float32")
            q_ref = run(f"{dt} one device", copies[dt], [card], "bfloat16")
            compare_bf16(f"{dt} tp=2", run(f"{dt} tp=2", copies[dt], [card] * 2, "bfloat16",
                                           tensor_parallel=2), q_ref, q_f32, 2)
    finally:
        for d in (view, *copies.values()):
            shutil.rmtree(d, ignore_errors=True)
    log(f"[tp] float32 runs' launches (the scoring kernels' float32 form is score_kernel_f32): "
        f"{json.dumps(f32_launches)}")
    log(f"[tp] phase {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


def tp_deepseek(ds_dir: str, cfg, prompts, ref: tuple, ref_counts: dict, n_gen_loop: int,
                smi: str) -> dict:
    """Scoring runs of the DeepSeek-V3 cell at tp = 2 over [cuda:0] * 2
    (MLA split by heads, the 256 experts by expert, the vocab-split head),
    in bf16 and in float32, beside a float32 single-device run. The bf16
    run is held as :func:`bf16_against_f32` says, against the first
    position of that cell's single-device bf16 scoring run (the CLI's
    ``n_gen_loop`` passes, each launching alike) and the float32 one; the
    float32 run within ``TP_TOL_F32`` of the float32 single device, every
    greedy token equal; the float32 runs stream without read-ahead. Each
    TP run launches each scoring kernel twice as often as one
    single-device pass. Returns the TP runs' launches."""
    from flexible_llm_sharding_tpu_torch.config import FrameworkConfig
    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa
    from flexible_llm_sharding_tpu_torch.runtime import orchestration

    fresh_process_state()
    card = torch.device("cuda", 0)
    tok = BenchTokenizer(cfg.vocab_size)
    n_shards = cfg.num_hidden_layers + 3

    def run(tag, dtype, tp):
        # Float32 weights are twice bf16's (the MoE layer alone 45 GB): those
        # runs stream without read-ahead, one shard on the card at a time.
        run_cfg = FrameworkConfig(model_path=ds_dir, dtype=dtype, layer_num_per_shard=1,
                                  device="cuda", tensor_parallel=tp,
                                  prefetch_depth=0 if dtype == "float32" else 1)
        calls: list = []
        gc.collect()  # the previous run's shards, before this run's peak
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = orchestration.run_prompts(run_cfg, prompts, tokenizer=tok, devices=[card] * tp,
                                           calls=calls)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = fa.launch_counts()
        _check_scores(scores, prompts, 1, cfg.vocab_size, f"tp deepseek-v3 {tag}")
        stats = calls[-1]
        log(f"[tp] deepseek-v3 {tag} over [cuda:0] x {tp}: wall {wall:.4f} s, launches "
            f"{json.dumps(counts)}, uploaded bytes per shard: busiest rank "
            f"{stats.get('tp_rank_bytes', stats['streamed_bytes']) / n_shards:.0f} of "
            f"{stats['streamed_bytes'] / n_shards:.0f}, peak {stats.get('peak_mem_gb')} GB "
            f"({smi})")
        return scores, counts

    def twice(tag, counts, one_pass):
        want = {k: 2 * one_pass[k] for k in fa.KERNELS}
        if counts != want:
            fail(f"tp deepseek-v3 {tag}: launches {counts}, want {want}")

    launches: dict = {}
    f32_one, f32_counts = run("float32 one device", "float32", 1)
    scores, counts = run("bf16 tp=2", "bfloat16", 2)
    twice("bf16 tp=2", counts, {k: ref_counts[k] // n_gen_loop for k in fa.KERNELS})
    _add_launches(launches, {k: {"launches": counts[k], "local_launches": 0} for k in fa.KERNELS})
    log(f"[tp] deepseek-v3 bf16 tp=2: " + bf16_against_f32(
        "deepseek-v3 bf16 tp=2", scores, [s[:, :1] for s in ref[0]], f32_one)
        + ", launches 2 x one pass of the single device's")
    scores, counts = run("float32 tp=2", "float32", 2)
    twice("float32 tp=2", counts, f32_counts)
    _add_launches(launches, {k: {"launches": counts[k], "local_launches": 0} for k in fa.KERNELS})
    err = _max_diff(scores, f32_one)
    if not all(np.allclose(g, w, **TP_TOL_F32) for g, w in zip(scores, f32_one)):
        fail(f"tp deepseek-v3 float32 tp=2: scores differ from one device's (largest difference "
             f"{err}, tolerance {TP_TOL_F32})")
    if not all(np.array_equal(g.argmax(-1), w.argmax(-1)) for g, w in zip(scores, f32_one)):
        fail("tp deepseek-v3 float32 tp=2: greedy tokens differ from one device's")
    log(f"[tp] deepseek-v3 float32 tp=2: largest difference {err} from the float32 single device "
        f"(tolerance {TP_TOL_F32}), greedy tokens equal, launches 2 x the single device's")
    return launches


# The brownout phase's ladder: polled every 50 ms; a threshold of 0 turns a
# signal off, so the injected host_oom is what moves the ladder.
PRESSURE_FLAGS = ["--pressure", "--pressure_poll_s", "0.05", "--pressure_host_min_gb", "0",
                  "--pressure_disk_min_gb", "0", "--pressure_hbm_headroom_frac", "0"]
# The loader and upload sites of the batch chaos runs.
BATCH_SITES = ("shard_read", "device_put", "host_oom", "corrupt_shard", "link_throttle")


def chaos_seed(want: dict[str, tuple[int, int, int]], rate: float) -> int:
    """A chaos seed under which, for each site of ``want`` (``(n, lo,
    hi)``), between lo and hi of its first n draws inject at ``rate`` (the
    injector's SHA-256 unit per draw)."""
    from flexible_llm_sharding_tpu_torch.faults.retry import hash_unit

    for seed in range(1_000_000):
        if all(lo <= sum(hash_unit(f"{seed}:{site}:{i}") < rate for i in range(n)) <= hi
               for site, (n, lo, hi) in want.items()):
            return seed
    fail(f"no chaos seed injects as {want} at rate {rate}")


def phase_pressure(work: str, model_dir: str, cfg, prompts, llama_runs: dict, serve_ref: tuple,
                   n_gen_loop: int, n_gen_kv: int, smi: str) -> dict:
    """Faults and the brownout ladder on the 4-layer Llama-2-7B cell (the
    ``llama2_7b_pressure`` path), bf16, one layer per shard, blocks of 2:

    (a) the batch CLI under chaos at the loader and upload sites
        (``BATCH_SITES``, a seed under which each injects in the first
        pass; the ladder on for scoring): scoring x ``n_gen_loop`` and
        --kv_cache with ``n_gen_kv``, each bit-equal to the cell's clean
        run, with retries, re-read heals and every site's faults above 0,
        and the card's allocated memory after the run equal to before it;
    (b) scoring of 2 positions in disk mode under ``disk_full`` and
        ``corrupt_activation``: the clean run's first 2 bit for bit, spill
        retries and heals counted, no memory left behind;
    (c) a serving engine at the serve CLI's defaults under ``engine_step``
        and ``queue_admission``: a rejected submit is resubmitted, a
        request of an aborted wave too; every request's tokens equal the
        serve phase's default engine's, the rejections typed, and the
        memory after shutdown equal to before;
    (d) the ladder: an engine streaming at ``--hbm_pin_gb auto`` (every
        layer pinned) serves the 8 prompts (the default engine's tokens);
        then an engine under a ``host_oom`` outage of one fault, which
        walks the ladder to ``shed``: a submit meanwhile gets a typed
        ``Overloaded`` with its retry-after, the pins are dropped (the
        card's allocated memory falls by at least their bytes), the ladder
        steps back to level 0, and the requests served on both sides of it
        have the default engine's tokens;
    (e) one ``PressureMonitor.sample()`` from a fresh thread reads the
        card's free share.

    Every kernel must launch in (a), (c) and (d). Returns the phase's
    launches."""
    import threading

    from flexible_llm_sharding_tpu_torch.config import (
        FaultConfig,
        FrameworkConfig,
        PressureConfig,
        ServeConfig,
    )
    from flexible_llm_sharding_tpu_torch.faults.inject import InjectedFault
    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa
    from flexible_llm_sharding_tpu_torch.runtime import pressure, residency
    from flexible_llm_sharding_tpu_torch.serve import Overloaded, ServeEngine, WaveAborted
    from flexible_llm_sharding_tpu_torch.utils.metrics import host_rss_gib

    t_phase = time.perf_counter()
    path: dict = {}
    common = ["--dtype", "bfloat16", "--layer_num_per_shard", "1", "--device", "cuda",
              "--io_retry_attempts", "8", "--io_retry_base_s", "0.001"]
    scoring = ("flash_causal_attention", "flash_prefix_shared_attention")

    def launched(tag, needed) -> dict:
        counts = fa.launch_counts()
        if any(counts[k] == 0 for k in needed):
            fail(f"pressure {tag}: a kernel of the path never launched: {counts}")
        _add_launches(path, {k: {"launches": counts[k], "local_launches": 0} for k in counts})
        return counts

    def same(a, b) -> bool:
        return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))

    # (a), (b): the batch CLI under chaos, against the cell's clean runs.
    rate = 0.1
    seed = chaos_seed({site: (7, 1, 7) for site in BATCH_SITES}, rate)
    batch_runs = [
        ("scoring", ["--num_gen_token", str(n_gen_loop), *PRESSURE_FLAGS], BATCH_SITES, scoring,
         llama_runs["scoring"]),
        ("kv_cache", ["--num_gen_token", str(n_gen_kv), "--kv_cache", "true"], BATCH_SITES,
         fa.KERNELS, llama_runs["kv_cache"]),
        # Two positions: a pass writes and reads every spill (fsynced).
        ("disk", ["--num_gen_token", "2", "--storage_location", "disk"],
         ("disk_full", "corrupt_activation"), scoring, llama_runs["scoring"]),
    ]
    for tag, extra, sites, needed, (ref, ref_up, _) in batch_runs:
        fresh_process_state()
        _, before = settled_allocated()
        rss_before = host_rss_gib().get("rss")
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        scores, updated, stats = run_cli(
            model_dir, work, f"pressure_{tag}", prompts,
            [*common, *extra, "--chaos", "--chaos_seed", str(seed), "--chaos_error_rate",
             str(rate), "--chaos_sites", ",".join(sites), "--chaos_max_faults", "20"],
            cfg.vocab_size)
        wall = time.perf_counter() - t0
        counts = launched(tag, needed)
        ladder = stats.get("pressure")
        pressure.reset_process_pressure()
        _, after = settled_allocated()
        faults = {k: v for k, v in stats["chaos_faults"].items() if v}
        heals = stats.get("reread_heals", 0) + stats.get("recomputes", 0)
        line = {"wall_s": wall, "io_retries": stats.get("io_retries"),
                "reread_heals": stats.get("reread_heals"), "recomputes": stats.get("recomputes"),
                "integrity_failures": stats.get("integrity_failures"), "faults": faults,
                "allocated_before": before, "allocated_after": after,
                "host_rss_gib": [rss_before, host_rss_gib().get("rss")], "kernels": counts}
        if ladder is not None:
            line["ladder"] = {k: ladder[k] for k in ("level", "steps_up", "steps_down",
                                                      "host_oom_events")}
        log(f"[pressure] {tag} chaos {','.join(sites)} seed {seed} | {smi} | "
            + json.dumps(line))
        n = scores[0].shape[1]
        if not same(scores, [r[:, :n] for r in ref]) or (n == ref[0].shape[1]
                                                         and updated != ref_up):
            fail(f"pressure {tag}: the chaos run's scores or tokens differ from the clean run's")
        if any(faults.get(site, 0) == 0 for site in sites) or set(faults) - set(sites):
            fail(f"pressure {tag}: faults injected {faults}, sites {sites}")
        if not stats.get("io_retries") or not heals:
            fail(f"pressure {tag}: io_retries {stats.get('io_retries')}, heals {heals}")
        if after != before:
            fail(f"pressure {tag}: {after - before} bytes allocated on the card after the run")
        if ladder is not None and (ladder["host_oom_events"] != faults["host_oom"]
                                   or ladder["steps_up"] < 6):
            fail(f"pressure {tag}: the batch run's ladder {ladder} against {faults}")
        log(f"[pressure] {tag}: the clean run's scores and tokens bit for bit, every site "
            "injected, retries and heals counted, no memory left on the card")

    def serve_cfg_for(**kw):
        return FrameworkConfig(model_path=model_dir, dtype="bfloat16", layer_num_per_shard=1,
                               block_size=2, device="cuda", io_retry_attempts=8,
                               io_retry_base_s=0.001,
                               disk_folder=os.path.join(work, "pressure_serve"), **kw)

    def engine(fw) -> ServeEngine:
        return ServeEngine(fw, ServeConfig(max_wave_requests=2, default_max_new_tokens=n_gen_kv,
                                           stats_interval_s=0),
                           tokenizer=BenchTokenizer(cfg.vocab_size),
                           device=torch.device("cuda", 0), start=False)

    def submit(eng, i, rejected: list, n_new=None):
        """Prompt ``i``, resubmitted while an injected fault rejects it."""
        while True:
            req = eng.submit(*prompts[i], max_new_tokens=n_new)
            err = req.future.exception(timeout=0) if req.status.terminal else None
            if not isinstance(err, InjectedFault):
                return req
            rejected.append(str(err))

    ref_scores = serve_ref[0]

    def check_tokens(tag, results: dict) -> float:
        """``results``: prompt index -> result, whose tokens must be the
        default engine's (its first n where n were asked for); returns the
        largest score difference."""
        worst = 0.0
        for i, res in results.items():
            want = ref_scores[i][:, :res.scores.shape[1]]
            if not np.array_equal(res.scores.argmax(-1), want.argmax(-1)):
                fail(f"pressure {tag}: prompt {i}'s tokens differ from the default engine's")
            worst = max(worst, float(np.abs(res.scores - want).max()))
        return worst

    # (c) engine_step and queue_admission chaos on the default engine.
    fresh_process_state()
    _, before = settled_allocated()
    rate_c = 0.2
    # One admission rejection among the 8 submits and its resubmit, so the
    # shared budget leaves engine_step its faults.
    seed_c = chaos_seed({"queue_admission": (9, 1, 1), "engine_step": (7, 1, 7)}, rate_c)
    eng = engine(serve_cfg_for(faults=FaultConfig(
        enabled=True, seed=seed_c, error_rate=rate_c, sites=("engine_step", "queue_admission"),
        max_faults=4)))
    rejected: list = []
    aborted: list = []
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        reqs = {i: submit(eng, i, rejected) for i in range(len(prompts))}
        eng.start()
        results = {}
        while reqs:
            i, req = next(iter(reqs.items()))
            err = req.future.exception(timeout=600)
            if err is None:
                results[i] = reqs.pop(i).future.result()
            elif isinstance(err, WaveAborted) and isinstance(err.__cause__, InjectedFault):
                aborted.append(str(err.__cause__))
                reqs[i] = submit(eng, i, rejected)
            else:
                fail(f"pressure serve_chaos: prompt {i} failed: {err!r}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launched("serve_chaos", fa.KERNELS)
        stats = eng.stats()
    finally:
        eng.shutdown(drain=True)
    if eng.error is not None:
        fail(f"pressure serve_chaos: the engine failed: {eng.error!r}")
    worst = check_tokens("serve_chaos", results)
    del eng
    _, after = settled_allocated()
    log(f"[pressure] serve_chaos engine_step,queue_admission seed {seed_c} | {smi} | " + json.dumps(
        {"wall_s": wall, "rejected_at_admission": len(rejected), "waves_aborted":
         stats.get("waves_aborted"), "engine_recoveries": stats.get("engine_recoveries"),
         "requests_aborted": len(aborted), "completed": stats["completed"],
         "largest_score_difference": worst, "allocated_before": before, "allocated_after": after,
         "kernels": counts}))
    if not rejected or not aborted or not all("queue_admission" in r for r in rejected):
        fail(f"pressure serve_chaos: {len(rejected)} typed admission rejections, {len(aborted)} "
             "requests of aborted waves: both sites must have struck")
    if after != before:
        fail(f"pressure serve_chaos: {after - before} bytes left on the card after the recoveries")
    log("[pressure] serve_chaos: every request's tokens the default engine's, rejections typed, "
        "no memory left on the card")

    # (d) the ladder on a streaming engine's pins.
    fresh_process_state()
    pcfg = PressureConfig(enabled=True, poll_s=0.05, host_min_gb=0.0, disk_min_gb=0.0,
                          hbm_headroom_frac=0.0, shed_retry_after_s=0.5, step_down_polls=16)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    pinned_eng = engine(serve_cfg_for(decode_resident="off", hbm_pin_gb=None, pressure=pcfg))
    ctrl, tier = pressure.process_controller(), residency.process_tier()
    if ctrl is None or tier is None:
        fail("pressure ladder: no process controller or no residency tier at --hbm_pin_gb auto")
    try:
        reqs = {i: pinned_eng.submit(*prompts[i]) for i in range(len(prompts))}
        pinned_eng.start()
        first = {i: r.future.result(timeout=600) for i, r in reqs.items()}
    finally:
        pinned_eng.shutdown(drain=True)
    worst = check_tokens("ladder_pinned", first)
    held = tier.stats()
    del pinned_eng
    _, with_pins = settled_allocated()
    # The outage: one host_oom at the next engine's first read. It streams
    # every layer (auto pins are off under chaos), and with prefetch 0 an
    # idle engine holds no shard. Its pool drops its pages at kv_evict
    # (spilling them would fsync 2112 page files from the monitor's thread).
    eng = engine(serve_cfg_for(decode_resident="off", hbm_pin_gb=None, prefetch_depth=0,
                               kv_host_spill=False, pressure=pcfg, faults=FaultConfig(
                                   enabled=True, error_rate=1.0, sites=("host_oom",),
                                   max_faults=1)))
    try:
        trigger = eng.submit(*prompts[0], max_new_tokens=1)
        eng.start()
        deadline = time.monotonic() + 60
        while not eng.queue.shedding and time.monotonic() < deadline:
            time.sleep(0.001)
        shed = eng.submit(*prompts[1], max_new_tokens=1).future.exception(timeout=10)
        second = {0: trigger.future.result(timeout=600)}
        while eng.batcher.waves and time.monotonic() < deadline:
            time.sleep(0.01)
        _, unpinned = settled_allocated()
        # The ladder may have stepped below pin_evict by now: nothing reloads
        # the pins (the chaos engine streams), so the drop holds.
        evicted, seated, level_at_read = (ctrl.stats()["pin_evictions"],
                                          tier.stats()["pinned_bytes"], ctrl.level)
        while ctrl.level > 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        later = {i: eng.submit(*prompts[i], max_new_tokens=1) for i in (2, 3)}
        second.update({i: r.future.result(timeout=600) for i, r in later.items()})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launched("ladder", fa.KERNELS)
        stats = eng.stats()
    finally:
        eng.shutdown(drain=True)
    if eng.error is not None:
        fail(f"pressure ladder: the engine failed: {eng.error!r}")
    worst = max(worst, check_tokens("ladder", second))
    ladder = ctrl.stats()
    log(f"[pressure] ladder | {smi} | " + json.dumps(
        {"wall_s": wall, "pinned_bytes": held["pinned_bytes"], "pinned_layers":
         held["pinned_layers"], "allocated_with_pins": with_pins, "allocated_unpinned": unpinned,
         "level_when_read": level_at_read, "shed": repr(shed), "ladder": ladder,
         "served": stats["completed"], "largest_score_difference": worst, "kernels": counts}))
    if not isinstance(shed, Overloaded) or shed.retry_after_s != pcfg.shed_retry_after_s:
        fail(f"pressure ladder: a submit while shedding got {shed!r}, not Overloaded with a "
             f"{pcfg.shed_retry_after_s} s retry-after")
    if evicted != held["planned_layers"] or seated:
        fail(f"pressure ladder: {evicted} pins evicted and {seated} bytes still seated when the "
             f"memory was read (level {level_at_read})")
    if held["pinned_layers"] != held["planned_layers"] or held["pinned_bytes"] <= 0:
        fail(f"pressure ladder: --hbm_pin_gb auto pinned {held}")
    if with_pins - unpinned < held["pinned_bytes"]:
        fail(f"pressure ladder: the card's allocated memory fell by {with_pins - unpinned} bytes "
             f"on unpinning, under the {held['pinned_bytes']} pinned")
    if (ladder["level"] != 0 or ladder["host_oom_events"] != 1 or ladder["sheds"] < 1
            or ladder["pin_evictions"] != held["planned_layers"] or ladder["steps_down"] < 6
            or tier.pressure_demoted):
        fail(f"pressure ladder: {ladder}, tier demoted {tier.pressure_demoted}")
    log("[pressure] ladder: shed with a typed Overloaded, unpinned (the card's memory fell by "
        "the pinned bytes), back to level 0; every served request the default engine's tokens")

    # (e) the HBM sample from a fresh thread.
    fresh_process_state()
    hbm_cfg = serve_cfg_for(pressure=pcfg)
    mon = pressure.PressureMonitor(hbm_cfg, pressure.BrownoutController(hbm_cfg),
                                   device=torch.device("cuda", 0))
    got: list = []
    thread = threading.Thread(target=lambda: got.append(mon.sample()))
    thread.start()
    thread.join(30)
    frac = got[0].hbm_free_frac if got else None
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"[pressure] hbm sample from a fresh thread: free share {frac} (main thread: "
        f"{1 - torch.cuda.memory_allocated(0) / total:.6f}) | {smi}")
    if frac is None or not 0.0 < frac <= 1.0:
        fail(f"pressure: the HBM sampler read {frac!r} on the card")
    log(f"[pressure] phase {time.perf_counter() - t_phase:.1f} s")
    return path


def _scrape(port: int) -> str:
    import urllib.request

    return urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30).read().decode()


def _families(text: str) -> set[str]:
    return {ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE")}


def _span_totals(report: dict) -> dict:
    """Seconds per span name of a ``trace-report`` (the layers' split)."""
    return {k: v["total_s"] for k, v in report.get("spans_by_name", {}).items()}


def _cli_out(argv: list[str]) -> str:
    """A subcommand's stdout (``trace-report``, ``incidents``) in process."""
    from flexible_llm_sharding_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


def phase_obs(work: str, model_dir: str, cfg, prompts, llama_runs: dict, serve_ref: tuple,
              n_gen_loop: int, n_gen_kv: int, smi: str) -> dict:
    """Observability on the 4-layer Llama-2-7B cell (the ``llama2_7b_obs``
    path), bf16, one layer per shard:

    (a) scoring x ``n_gen_loop`` with --trace (Chrome JSON), --metrics_out,
        --journal_dir and --verbose_metrics: scores bit-equal to the cell's
        untraced run with equal launches; one ``sweep`` span a pass and a
        ``compute``, ``source_wait``, ``shard_produce`` and ``device_put``
        span a shard; ``trace-report --json``'s ``source_wait_s`` within
        1 ms of the stats line's; the dump's stats, stream bytes and host
        cache counters the stats line's; one ``executor_call`` line a pass;
    (b) --kv_cache ``n_gen_kv`` traced to JSONL: the untraced run's scores,
        tokens and launches;
    (c) scoring x1 with --profile_dir: the torch.profiler Chrome trace
        exists and its ``score_tc_kernel`` events equal the scoring
        kernels' launches (CUPTI recording no kernel is printed with the
        profiler's warnings, and the CPU-side record is required);
    (d) the default engine under ``engine_step`` chaos with tracing, the
        journal, incidents and the pressure ladder (thresholds 0) on and
        --metrics_port 0: /metrics scraped while it serves carries the
        serve, journal, trace and pressure families; exactly one bundle,
        whose ``incidents analyze`` names the aborted wave; every token the
        default engine's;
    (e) a 2-replica fleet under one seeded ``replica_kill``: one bundle
        whose journal (``replica_dead``), metrics (the router's
        ``replicas_dead``, the dead replica's source gone) and trace (the
        ``replica_kill`` instant) name the same replica; the fleet opens
        one metrics endpoint and its replicas none; every token the
        default engine's;
    (f) untraced, traced, traced, untraced scoring in this call, the host
        cache warm: the traced runs' mean wall over the untraced runs'
        (fails above 1.25).

    Any registry source that raises (a ``collect_error``) fails the phase.
    Returns the phase's launches."""
    import threading

    from flexible_llm_sharding_tpu_torch.config import (
        FaultConfig,
        FrameworkConfig,
        PressureConfig,
        ServeConfig,
    )
    from flexible_llm_sharding_tpu_torch.faults.inject import InjectedFault
    from flexible_llm_sharding_tpu_torch.obs import events as obs_events
    from flexible_llm_sharding_tpu_torch.obs import report as obs_report
    from flexible_llm_sharding_tpu_torch.obs import trace as obs_trace
    from flexible_llm_sharding_tpu_torch.obs.registry import REGISTRY
    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa
    from flexible_llm_sharding_tpu_torch.parallel.planner import plan_shards_dp
    from flexible_llm_sharding_tpu_torch.serve import ReplicaFleet, ServeEngine, WaveAborted
    from flexible_llm_sharding_tpu_torch.utils import checkpoint

    t_phase = time.perf_counter()
    path: dict = {}
    d = os.path.join(work, "obs")
    os.makedirs(d, exist_ok=True)
    common = ["--dtype", "bfloat16", "--layer_num_per_shard", "1", "--device", "cuda"]
    scoring = ("flash_causal_attention", "flash_prefix_shared_attention")
    n_shards = len(plan_shards_dp(len(checkpoint.layer_names_for(cfg.num_hidden_layers)),
                                  1).shards)
    ref_scores = serve_ref[0]

    def launched(tag, needed) -> dict:
        counts = fa.launch_counts()
        if any(counts[k] == 0 for k in needed):
            fail(f"obs {tag}: a kernel of the path never launched: {counts}")
        _add_launches(path, {k: {"launches": counts[k], "local_launches": 0} for k in counts})
        return counts

    def same(a, b) -> bool:
        return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))

    def no_collect_error(tag, collected: dict) -> None:
        broken = sorted(k for k, v in collected.items() if "collect_error" in v)
        if broken:
            fail(f"obs {tag}: registry sources raised on the card: {broken}")

    def obs_off() -> None:
        obs_trace.TRACER.disable()
        obs_trace.TRACER.clear()
        obs_trace.TRACER.default_out = ""
        obs_events.reset_journal()

    def traced_cli(tag, extra, flags, fresh=True):
        # ``fresh``: a new process's state; else only tracing and the
        # journal off (the host cache kept warm).
        fresh_process_state() if fresh else obs_off()
        fa.reset_launch_counts()
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            scores, updated, stats = run_cli(model_dir, work, f"obs_{tag}", prompts,
                                             [*common, *extra, *flags], cfg.vocab_size)
        wall = time.perf_counter() - t0
        sys.stderr.write(err.getvalue())
        return scores, updated, stats, wall, err.getvalue()

    # (a) traced scoring, the metrics dump, the journal, the verbose lines.
    trace_json, metrics_json = os.path.join(d, "a_trace.json"), os.path.join(d, "a_metrics.json")
    flags_a = ["--trace", "--trace_out", trace_json, "--metrics_out", metrics_json,
               "--journal_dir", os.path.join(d, "a_journal"), "--verbose_metrics", "true"]
    scores, updated, stats, wall_a, err_a = traced_cli(
        "scoring", ["--num_gen_token", str(n_gen_loop)], flags_a)
    counts = launched("scoring", scoring)
    ref, ref_up, ref_stats = llama_runs["scoring"]
    if not same(scores, ref) or updated != ref_up:
        fail("obs scoring: the traced run's scores or tokens differ from the untraced run's")
    if counts != llama_runs["scoring_launches"]:
        fail(f"obs scoring: launches {counts} against the untraced "
             f"{llama_runs['scoring_launches']}")
    spans = obs_report.load_trace(trace_json)
    per = {name: sum(1 for e in spans if e["name"] == name)
           for name in ("sweep", "compute", "source_wait", "shard_produce", "device_put")}
    want = {"sweep": n_gen_loop, **{k: n_gen_loop * n_shards for k in
                                   ("compute", "source_wait", "shard_produce", "device_put")}}
    if per != want:
        fail(f"obs scoring: spans {per}, wanted {want}")
    rep = json.loads(_cli_out(["trace-report", "--trace", trace_json, "--json"]))
    if abs(rep["source_wait_s"] - stats["source_wait_s"]) > 1e-3:
        fail(f"obs scoring: trace-report source_wait_s {rep['source_wait_s']} against the stats "
             f"line's {stats['source_wait_s']}")
    with open(metrics_json) as f:
        dump = json.load(f)
    no_collect_error("scoring", dump["metrics"])
    m = dump["metrics"]
    if (dump["stats"] != json.loads(json.dumps(stats))
            or m["stream"]["streamed_bytes"] != stats["streamed_bytes"]
            or m["host_cache"]["hits"] != stats["host_cache_hits"]
            or m["host_cache"]["misses"] != stats["host_cache_misses"]):
        fail(f"obs scoring: the metrics dump {m.get('stream')} {m.get('host_cache')} differs "
             "from the stats line")
    verbose = [ln for ln in err_a.splitlines() if '"event": "executor_call"' in ln]
    if len(verbose) != n_gen_loop:
        fail(f"obs scoring: {len(verbose)} executor_call lines for {n_gen_loop} passes")
    journal = m.get("journal", {})
    if not journal.get("enabled") or journal.get("events_dropped"):
        fail(f"obs scoring: the journal {journal}")
    log(f"[obs] scoring x{n_gen_loop} traced | {smi} | " + json.dumps(
        {"wall_s": wall_a, "stats_wall_s": stats["wall_s"], "untraced_wall_s": ref_stats["wall_s"],
         "spans": per, "span_s": _span_totals(rep), "trace_report": {k: rep.get(k) for k in (
             "source_wait_s", "produce_s", "overlap_efficiency", "link_utilization",
             "sweep_wall_s", "sweep_phase_s", "wall_s")},
         "stats": {k: stats.get(k) for k in ("source_wait_s", "compute_wall_s",
                                             "load_weights_time_s")}, "kernels": counts}))

    # (b) traced --kv_cache, exported as JSONL.
    trace_jsonl = os.path.join(d, "b_trace.jsonl")
    scores, updated, stats, wall_b, _ = traced_cli(
        "kv_cache", ["--num_gen_token", str(n_gen_kv), "--kv_cache", "true"],
        ["--trace", "--trace_out", trace_jsonl])
    counts = launched("kv_cache", fa.KERNELS)
    ref, ref_up, ref_stats = llama_runs["kv_cache"]
    if not same(scores, ref) or updated != ref_up:
        fail("obs kv_cache: the traced run's scores or tokens differ from the untraced run's")
    if counts != llama_runs["kv_cache_launches"]:
        fail(f"obs kv_cache: launches {counts} against the untraced "
             f"{llama_runs['kv_cache_launches']}")
    events = obs_report.load_trace(trace_jsonl)
    rep_b = obs_report.analyze(events)
    produced = rep_b["spans_by_name"].get("shard_produce", {}).get("count", 0)
    passes = 1 if stats.get("decode_resident") else n_gen_kv
    if produced != passes * n_shards or rep_b.get("trace_drops") != 0:
        fail(f"obs kv_cache: {produced} shard_produce spans for {passes} weight pass(es) of "
             f"{n_shards} shards, drops {rep_b.get('trace_drops')}")
    log(f"[obs] kv_cache {n_gen_kv} traced to JSONL | {smi} | " + json.dumps(
        {"wall_s": wall_b, "stats_wall_s": stats["wall_s"], "untraced_wall_s": ref_stats["wall_s"],
         "events": len(events), "span_s": _span_totals(rep_b),
         "trace_report": {k: rep_b.get(k) for k in (
             "source_wait_s", "produce_s", "overlap_efficiency", "link_utilization")},
         "decode_graph": stats.get("decode_graph"), "kernels": counts}))

    # (c) the device profile.
    prof_dir = os.path.join(d, "c_profile")
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        scores, _, stats, wall_c, err_c = traced_cli("profile", ["--num_gen_token", "1"],
                                                     ["--profile_dir", prof_dir])
    counts = launched("profile", scoring)
    files = [f for f in os.listdir(prof_dir) if f.endswith(".json")] if os.path.isdir(
        prof_dir) else []
    if len(files) != 1:
        fail(f"obs profile: {files} in --profile_dir, not one Chrome trace")
    with open(os.path.join(prof_dir, files[0])) as f:
        prof = json.load(f)["traceEvents"]
    kernels = [e for e in prof if e.get("cat") == "kernel"]
    score_evs = [e for e in kernels if "score_tc_kernel" in e.get("name", "")]
    by_kernel: dict = {}
    for e in kernels:
        key = e["name"].split("(")[0][:60]
        by_kernel[key] = by_kernel.get(key, 0.0) + e.get("dur", 0.0) / 1e3
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8])
    want_score = sum(counts[k] for k in scoring)
    line = {"wall_s": wall_c, "trace_bytes": os.path.getsize(os.path.join(prof_dir, files[0])),
            "events": len(prof), "kernel_events": len(kernels),
            "score_tc_kernel_events": len(score_evs), "score_launches": want_score,
            "score_tc_kernel_ms": sum(e.get("dur", 0.0) for e in score_evs) / 1e3,
            "device_ms_by_kernel_top8": top, "kernels": counts}
    if not kernels:
        warned = [str(w.message) for w in caught] + [ln for ln in err_c.splitlines()
                                                      if "CUPTI" in ln or "profil" in ln.lower()]
        cpu_ops = sum(1 for e in prof if e.get("cat") == "cpu_op")
        log(f"[obs] profile: CUPTI recorded no CUDA kernel; the profiler said {warned[:5]}; "
            f"{cpu_ops} CPU-side op events recorded | {smi} | " + json.dumps(line))
        if not cpu_ops:
            fail("obs profile: the trace holds neither CUDA kernels nor CPU-side ops")
    else:
        log(f"[obs] profile scoring x1 | {smi} | " + json.dumps(line))
        if len(score_evs) != want_score:
            fail(f"obs profile: {len(score_evs)} score_tc_kernel events against {want_score} "
                 "scoring launches")

    # (d) the default engine under engine_step chaos, traced, journaled.
    fresh_process_state()
    inc_d = os.path.join(d, "d_incidents")
    fw = FrameworkConfig(model_path=model_dir, dtype="bfloat16", layer_num_per_shard=1,
                         block_size=2, device="cuda", disk_folder=os.path.join(d, "d_disk"),
                         trace=True, trace_out=os.path.join(d, "d_trace.json"),
                         journal_dir=os.path.join(d, "d_journal"), incidents_dir=inc_d,
                         incident_settle_s=0.5, incident_debounce_s=600.0,
                         pressure=PressureConfig(enabled=True, poll_s=0.05, host_min_gb=0.0,
                                                 disk_min_gb=0.0, hbm_headroom_frac=0.0),
                         faults=FaultConfig(enabled=True, error_rate=1.0, sites=("engine_step",),
                                            max_faults=1))
    eng = ServeEngine(fw, ServeConfig(max_wave_requests=2, default_max_new_tokens=n_gen_kv,
                                      stats_interval_s=0, metrics_port=0),
                      tokenizer=BenchTokenizer(cfg.vocab_size), device=torch.device("cuda", 0),
                      start=False)
    fa.reset_launch_counts()
    aborted: list = []
    t0 = time.perf_counter()
    try:
        reqs = {i: eng.submit(*prompts[i]) for i in range(len(prompts))}
        eng.start()
        results: dict = {}
        scraped = None
        while reqs:
            i, req = next(iter(reqs.items()))
            err = req.future.exception(timeout=600)
            if err is None:
                results[i] = reqs.pop(i).future.result()
            elif isinstance(err, WaveAborted) and isinstance(err.__cause__, InjectedFault):
                aborted.append(req.request_id)
                reqs[i] = eng.submit(*prompts[i])
            else:
                fail(f"obs serve: prompt {i} failed: {err!r}")
            if scraped is None and reqs:  # while it serves
                scraped = _scrape(eng.metrics_server.port)
        torch.cuda.synchronize()
        wall_d = time.perf_counter() - t0
        counts = launched("serve", fa.KERNELS)
        collected = eng.metrics.registry.collect()
    finally:
        eng.shutdown(drain=True)
    if eng.error is not None:
        fail(f"obs serve: the engine failed: {eng.error!r}")
    no_collect_error("serve", collected)
    worst = 0.0
    for i, res in results.items():
        want_s = ref_scores[i][:, :res.scores.shape[1]]
        if not np.array_equal(res.scores.argmax(-1), want_s.argmax(-1)):
            fail(f"obs serve: prompt {i}'s tokens differ from the default engine's")
        worst = max(worst, float(np.abs(res.scores - want_s).max()))
    fams = _families(scraped or "")
    need = ("fls_serve_", "fls_journal_", "fls_trace_", "fls_pressure_")
    missing = [p for p in need if not any(f.startswith(p) for f in fams)]
    if scraped is None or missing:
        fail(f"obs serve: the endpoint scraped while serving lacks {missing}")
    deadline = time.monotonic() + 30
    while not [b for b in os.listdir(inc_d) if b.startswith("incident-")
               and not b.endswith(".tmp")] and time.monotonic() < deadline:
        time.sleep(0.05)
    bundles = sorted(b for b in os.listdir(inc_d) if b.startswith("incident-")
                     and not b.endswith(".tmp"))
    if len(bundles) != 1:
        fail(f"obs serve: {len(bundles)} incident bundles, not one: {bundles}")
    analysis = json.loads(_cli_out(["incidents", "analyze", os.path.join(inc_d, bundles[0]),
                                    "--json"]))
    abort_waves = [e["wave_id"] for e in analysis["timeline"] if e["kind"] == "wave_abort"]
    if not abort_waves or not set(abort_waves) <= set(analysis["waves"]) or not aborted:
        fail(f"obs serve: the bundle's analysis names waves {analysis['waves']}, the aborted "
             f"{abort_waves}; {len(aborted)} requests aborted")
    text = _cli_out(["incidents", "analyze", os.path.join(inc_d, bundles[0])])
    log(f"[obs] serve engine_step chaos traced | {smi} | " + json.dumps(
        {"wall_s": wall_d, "requests_aborted": len(aborted), "aborted_waves": abort_waves,
         "bundle": bundles[0], "bundle_events": analysis["events_by_kind"],
         "families_scraped": len(fams), "journal": collected.get("journal"),
         "trace": collected.get("trace"), "largest_score_difference": worst, "kernels": counts}))
    log("[obs] serve bundle analysis:\n" + text.rstrip())

    # (e) a 2-replica fleet under one replica_kill.
    fresh_process_state()
    inc_e = os.path.join(d, "e_incidents")
    fw = FrameworkConfig(model_path=model_dir, dtype="bfloat16", layer_num_per_shard=1,
                         block_size=2, device="cuda", disk_folder=os.path.join(d, "e_disk"),
                         trace=True, journal_dir=os.path.join(d, "e_journal"),
                         incidents_dir=inc_e, incident_settle_s=0.5, incident_debounce_s=600.0,
                         faults=FaultConfig(enabled=True, seed=1234, error_rate=1.0,
                                            sites=("replica_kill",), max_faults=1))
    fa.reset_launch_counts()
    t0 = time.perf_counter()

    def endpoints() -> int:
        return sum(t.name == "metrics-endpoint" and t.is_alive() for t in threading.enumerate())

    endpoints_before = endpoints()
    fleet = ReplicaFleet(fw, ServeConfig(replicas=2, max_wave_requests=2,
                                         default_max_new_tokens=n_gen_kv, stats_interval_s=0,
                                         router_health_poll_s=0.05, metrics_port=0),
                         tokenizer=BenchTokenizer(cfg.vocab_size), device=torch.device("cuda"))
    try:
        # The fleet's one endpoint: its replicas open none of their own.
        fleet_endpoints = endpoints() - endpoints_before
        if fleet_endpoints != 1:
            fail(f"obs fleet: {fleet_endpoints} metrics endpoints for one fleet, not one")
        reqs = [fleet.submit(*prompts[i]) for i in range(len(prompts))]
        res_e = [r.future.result(timeout=600) for r in reqs]
        fleet_text = _scrape(fleet.metrics_server.port)
        torch.cuda.synchronize()
        wall_e = time.perf_counter() - t0
        counts = launched("fleet", fa.KERNELS)
        router = fleet.stats()["router"]
    finally:
        fleet.shutdown(drain=True)
    for i, res in enumerate(res_e):
        if not np.array_equal(res.scores.argmax(-1), ref_scores[i].argmax(-1)):
            fail(f"obs fleet: prompt {i}'s tokens differ from the default engine's")
    deadline = time.monotonic() + 30
    while not os.listdir(inc_e) and time.monotonic() < deadline:
        time.sleep(0.05)
    bundles = sorted(b for b in os.listdir(inc_e) if b.startswith("incident-")
                     and not b.endswith(".tmp"))
    if len(bundles) != 1:
        fail(f"obs fleet: {len(bundles)} incident bundles, not one: {bundles}")
    b = obs_report.load_bundle(os.path.join(inc_e, bundles[0]))
    no_collect_error("fleet bundle", b["metrics"])
    dead = [e["replica"] for e in b["journal"] if e["kind"] == "replica_dead"]
    killed = [e.get("replica") for e in b["trace_events"] if e["name"] == "replica_kill"]
    if (len(dead) != 1 or killed != dead or b["metrics"]["router"]["replicas_dead"] != 1
            or f"replica{dead[0]}" in b["metrics"] or router["replicas_dead"] != 1
            or "fls_router_replicas_dead 1" not in fleet_text):
        fail(f"obs fleet: journal replica_dead {dead}, trace replica_kill {killed}, bundle "
             f"router {b['metrics'].get('router')}, sources {sorted(b['metrics'])}")
    log(f"[obs] fleet replica_kill traced | {smi} | " + json.dumps(
        {"wall_s": wall_e, "dead_replica": dead[0], "bundle": bundles[0],
         "metrics_endpoints": fleet_endpoints,
         "bundle_events": sorted({e["kind"] for e in b["journal"]}),
         "bundle_sources": sorted(b["metrics"]), "router": router, "kernels": counts}))

    # (f) the tracer's overhead: untraced, traced, traced, untraced, twice,
    # every pass from the warm host cache (an untimed run first), so the
    # page cache's read times stay out of the comparison; the medians of
    # four walls each, since one run of half a second can move by half
    # itself.
    walls: dict = {"untraced": [], "traced": []}
    hit_rates = []
    traced_cli("overhead_warm", ["--num_gen_token", str(n_gen_loop)], [])
    launched("overhead_warm", scoring)
    for k, kind in enumerate(("untraced", "traced", "traced", "untraced") * 2):
        flags = [] if kind == "untraced" else [
            "--trace", "--trace_out", os.path.join(d, f"f{k}.json"), "--metrics_out",
            os.path.join(d, f"f{k}_m.json"), "--journal_dir", os.path.join(d, f"f{k}_j")]
        scores, _, stats, _, _ = traced_cli(f"overhead{k}", ["--num_gen_token", str(n_gen_loop)],
                                            flags, fresh=False)
        launched(f"overhead{k}", scoring)
        if not same(scores, llama_runs["scoring"][0]):
            fail(f"obs overhead: run {k} ({kind}) differs from the untraced run")
        walls[kind].append(stats["wall_s"])
        hit_rates.append(stats.get("host_cache_hit_rate"))
    ratio = float(np.median(walls["traced"]) / np.median(walls["untraced"]))
    log(f"[obs] overhead: untraced {walls['untraced']} s, traced {walls['traced']} s, ratio "
        f"{ratio:.4f}, host cache hit rates {hit_rates} | {smi}")
    if ratio > 1.25:
        fail(f"obs overhead: tracing costs {ratio:.3f}x the untraced wall (limit 1.25)")
    fresh_process_state()
    leftover = [t.name for t in threading.enumerate() if t.name in (
        "serve-engine", "fleet-monitor", "metrics-endpoint", "incident-capture")]
    if leftover or obs_trace.TRACER.enabled or "journal" in REGISTRY.names():
        fail(f"obs: threads {leftover}, a live tracer or journal left behind")
    obs_events.reset_journal()
    log(f"[obs] phase {time.perf_counter() - t_phase:.1f} s")
    return path


def phase_resume(work: str, model_dir: str, cfg, prompts, scoring_ref: tuple,
                 n_gen_loop: int) -> dict:
    """Disk-mode crash resume and spill recompute on the 4-layer Llama-2-7B
    cell, and the score sink's cap. A CLI process is killed (SIGKILL) once
    its marker reads 2 or more completed shards; --resume true then must
    give an uninterrupted disk run's scores bit for bit, stream only the
    shards left and remove the marker. In-process, one bit of a spill is
    flipped between shards 2 and 3: the block is recomputed and the scores
    stay bit for bit. Scoring at --score_sink_max_device 1 must equal the
    cell's scoring run (``scoring_ref``) bit for bit. Returns the runs'
    kernel launches."""
    import glob
    import signal

    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa
    from flexible_llm_sharding_tpu_torch.runtime.activations import ActivationStore
    from flexible_llm_sharding_tpu_torch.utils.checkpoint import layer_names_for

    disk_args = ["--dtype", "bfloat16", "--layer_num_per_shard", "1", "--device", "cuda",
                 "--storage_location", "disk", "--num_gen_token", "1"]
    scoring = ("flash_causal_attention", "flash_prefix_shared_attention")
    launches: dict = {}

    def run(tag, extra, hook=None):
        fresh_process_state()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        out = run_cli(model_dir, work, tag, prompts, extra, cfg.vocab_size)
        counts, local = fa.launch_counts(), fa.local_launch_counts()
        _check_scores(out[0], prompts, int(extra[extra.index("--num_gen_token") + 1]),
                      cfg.vocab_size, f"resume {tag}")
        if any(counts[k] == 0 for k in scoring):
            fail(f"resume {tag}: a scoring kernel never launched: {counts}")
        _add_launches(launches, {k: {"launches": counts[k], "local_launches": local[k]}
                                 for k in fa.KERNELS})
        log(f"[resume] {tag}: wall {time.perf_counter() - t0:.3f} s, " + json.dumps(
            {k: out[2].get(k) for k in ("streamed_bytes", "recomputes", "integrity_failures",
                                        "compute_wall_s", "load_weights_time_s")}))
        return out

    def same(a, b):
        return all(np.array_equal(x, y) for x, y in zip(a, b))

    clean, _, clean_stats = run("resume_clean", disk_args)
    disk = os.path.join(work, "resume_disk")
    ppkl = os.path.join(work, "resume.pkl")
    with open(ppkl, "wb") as f:
        pickle.dump(prompts, f)
    err_path = os.path.join(work, "resume_killed.err")
    fresh_process_state()
    done, marker = 0, None
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", _SLOW_CLI_PROCESS, HERE, str(cfg.vocab_size), "--model_path",
             model_dir, "--prompt_pickle", ppkl, "--output_file",
             os.path.join(work, "resume_killed.pkl"), "--disk_folder", disk, *disk_args],
            cwd=HERE, stdout=subprocess.DEVNULL, stderr=err)
        try:
            deadline = time.monotonic() + 600
            while proc.poll() is None and time.monotonic() < deadline and done < 2:
                for marker in glob.glob(os.path.join(disk, "progress-*.json")):
                    with open(marker) as f:
                        done = json.load(f).get("completed_shards", 0)
                time.sleep(0.02)
        finally:
            if proc.poll() is None:
                proc.send_signal(signal.SIGKILL)
            code = proc.wait()
    if done < 2 or code != -signal.SIGKILL:
        with open(err_path) as f:
            fail(f"resume: the CLI process exited {code} with {done} shards marked:\n"
                 + f.read()[-3000:])
    with open(marker) as f:
        done = json.load(f)["completed_shards"]
    log(f"[resume] a disk-mode CLI process killed (SIGKILL) with {done} of "
        f"{cfg.num_hidden_layers + 3} shards marked complete")
    got, _, stats = run("resume", [*disk_args, "--resume", "true"])
    left = payload_bytes(cfg, layer_names_for(cfg.num_hidden_layers)[done:])
    if not same(got, clean):
        fail("resume: the resumed run's scores differ from the uninterrupted run's")
    if stats["streamed_bytes"] != left or not left < clean_stats["streamed_bytes"]:
        fail(f"resume: streamed {stats['streamed_bytes']} bytes, not the {left} of the shards left")
    if glob.glob(os.path.join(disk, "progress-*.json")):
        fail("resume: the marker outlived the resumed run")
    log(f"[resume] --resume true from shard {done}: the uninterrupted run's scores bit for bit, "
        f"{stats['streamed_bytes']} of {clean_stats['streamed_bytes']} bytes streamed, marker removed")
    # Rot drill: shard 2's spills are on disk when shard 3 begins; one bit of
    # one of them flips, past what the re-reads can heal.
    orig = ActivationStore.set_shard
    flipped = []

    def rot(self, shard_idx):
        orig(self, shard_idx)
        if shard_idx == 3 and not flipped:
            self.flush()
            path = os.path.join(self.disk_folder, "suffix-00000.npy")
            _flip_bit(path)
            flipped.append(path)

    ActivationStore.set_shard = rot
    try:
        rotted, _, rot_stats = run("resume_rot", disk_args)
    finally:
        ActivationStore.set_shard = orig
    if not flipped or not same(rotted, clean) or not rot_stats.get("recomputes", 0) >= 1:
        fail(f"resume: a rotted spill gave recomputes {rot_stats.get('recomputes')}, scores "
             f"equal: {same(rotted, clean)}")
    log(f"[resume] a flipped spill bit ({flipped[0]}) recomputed from the previous shard "
        f"({rot_stats['recomputes']} recompute(s), {rot_stats.get('integrity_failures')} integrity "
        "failures): the scores bit for bit")
    sink, _, _ = run("sink_1", ["--dtype", "bfloat16", "--layer_num_per_shard", "1", "--device",
                                "cuda", "--num_gen_token", str(n_gen_loop),
                                "--score_sink_max_device", "1"])
    if not same(sink, scoring_ref[0]):
        fail("score sink: --score_sink_max_device 1 changed the scores")
    log("[resume] --score_sink_max_device 1: the default's scores bit for bit")
    return launches


# The decode phase's depth: Llama-2-7B's widths, 2 of its 32 layers (cut
# from 8 for the train phase's time).
DECODE_LAYERS = 2
# The pin run that pins part of them: embedding, norm, head and 1 layer.
PARTIAL_PIN_GB = "1"


def phase_decode(work: str) -> dict:
    """Llama-2-7B at ``DECODE_LAYERS`` of its 32 layers (1.35 GB of seeded
    bf16 at 2, the depth cut for the smoke's time limit, written one layer
    file at a time), --kv_cache with 8 tokens: the defaults (weights
    resident, KV on the card, one CUDA graph per block), --decode_fused off
    and --decode_resident off. Each run starts as a fresh CLI process would
    and prints its wall and stats; the three must pick the same tokens.
    Returns per kernel the defaults' launches."""
    from flexible_llm_sharding_tpu_torch.config import LlamaConfig
    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa

    cfg = LlamaConfig(num_hidden_layers=DECODE_LAYERS)
    model_dir = os.path.join(work, f"llama2-7b-{DECODE_LAYERS}")
    nbytes, secs = write_streamed_checkpoint(model_dir, cfg, seed=0)
    log(f"[decode] wrote a seeded bf16 Llama-2-7B checkpoint with {cfg.num_hidden_layers} decoder "
        f"layers ({nbytes} bytes, one layer file at a time) in {secs:.3f} s")
    prompts = make_prompts(8, 512, 4, 32, seed=0)
    n_gen = 8
    common = ["--dtype", "bfloat16", "--layer_num_per_shard", "1", "--device", "cuda",
              "--kv_cache", "true", "--num_gen_token", str(n_gen)]
    runs = (("defaults", []), ("fused_off", ["--decode_fused", "off"]),
            ("resident_off", ["--decode_resident", "off"]))
    outputs, launches = {}, {}
    try:
        for tag, extra in runs:
            fresh_process_state()
            fa.reset_launch_counts()
            scores, updated, stats = run_cli(model_dir, work, f"decode_{tag}", prompts,
                                             [*common, *extra], cfg.vocab_size)
            counts, local = fa.launch_counts(), fa.local_launch_counts()
            _check_scores(scores, prompts, n_gen, cfg.vocab_size, f"decode {tag}")
            if tag == "defaults":
                check_decode_modes(f"decode {tag}", stats, cfg)
                launches = {k: {"launches": counts[k], "local_launches": local[k]}
                            for k in fa.KERNELS}
            missing = [k for k in fa.KERNELS if counts[k] == 0]
            if missing:
                fail(f"decode {tag}: kernels never launched on the main path: {missing}")
            passes = 1 if stats.get("decode_resident") else n_gen
            host = check_host_path(f"decode {tag}", stats, model_dir, cfg, passes)
            outputs[tag] = (scores, updated)
            log(f"[decode] {tag} stats " + json.dumps({k: stats.get(k) for k in STAT_KEYS}))
            log(f"[decode] {tag} host " + json.dumps(host) + " kernels " + json.dumps(counts))
        pinned = phase_pins(work, model_dir, cfg, prompts)
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    ref, ref_up = outputs["defaults"]
    for tag, (scores, updated) in outputs.items():
        if updated != ref_up:
            fail(f"decode {tag}: the generated tokens differ from the defaults'")
        err = max(float(np.abs(a - b).max()) for a, b in zip(ref, scores))
        log(f"[decode] {tag}: tokens equal the defaults', max_abs_err {err:.3e}")
    return _add_launches(launches, pinned)


def phase_pins(work: str, model_dir: str, cfg, prompts) -> dict:
    """The residency tier at ``DECODE_LAYERS``: scoring with --num_gen_token 4
    (four weight passes) at --hbm_pin_gb 0, ``PARTIAL_PIN_GB`` and auto.
    Every run's scores must equal the unpinned run's bit for bit, and its
    streamed bytes must fall by the pinned layers' bytes on every pass but
    the first (which loads the pins). Returns the runs' kernel launches."""
    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa

    n_gen = 4
    common = ["--dtype", "bfloat16", "--layer_num_per_shard", "1", "--device", "cuda",
              "--num_gen_token", str(n_gen)]
    launches: dict = {}
    ref = None
    for budget in ("0", PARTIAL_PIN_GB, "auto"):
        fresh_process_state()
        fa.reset_launch_counts()
        scores, updated, stats = run_cli(model_dir, work, f"pins_{budget}", prompts,
                                         [*common, "--hbm_pin_gb", budget], cfg.vocab_size)
        counts, local = fa.launch_counts(), fa.local_launch_counts()
        _check_scores(scores, prompts, n_gen, cfg.vocab_size, f"pins {budget}")
        scoring = ("flash_causal_attention", "flash_prefix_shared_attention")
        if any(counts[k] == 0 for k in scoring):
            fail(f"pins {budget}: a scoring kernel never launched: {counts}")
        _add_launches(launches, {k: {"launches": counts[k], "local_launches": local[k]}
                                 for k in fa.KERNELS})
        res = stats.get("residency") or {}
        log(f"[pins] --hbm_pin_gb {budget}: " + json.dumps(
            {**{k: stats.get(k) for k in ("wall_s", "streamed_bytes", "stream_bytes_saved",
                                          "pinned_bytes", "load_weights_time_s", "peak_mem_gb",
                                          "host_cache_hits", "host_cache_misses")},
             **{k: res.get(k) for k in ("pinned_layers", "planned_layers", "pin_loads",
                                        "pin_failures", "budget_bytes")}}))
        if ref is None:
            ref = (scores, updated, stats)
            if stats.get("pinned_bytes"):
                fail("pins 0: --hbm_pin_gb 0 pinned a layer")
            continue
        if not all(np.array_equal(a, b) for a, b in zip(ref[0], scores)) or updated != ref[1]:
            fail(f"pins {budget}: scores differ from the unpinned run's")
        saved = stats.get("stream_bytes_saved", 0)
        if not res.get("pinned_layers") or res.get("pin_failures"):
            fail(f"pins {budget}: the tier pinned nothing or failed a pin: {res}")
        # Each pass skips the pinned bytes; the first pass also loaded them.
        if ref[2]["streamed_bytes"] - stats["streamed_bytes"] != saved * (n_gen - 1) // n_gen:
            fail(f"pins {budget}: streamed {stats['streamed_bytes']} against "
                 f"{ref[2]['streamed_bytes']} unpinned, saving {saved}: not the pinned bytes per pass")
        if budget == "auto" and res.get("pinned_layers") != cfg.num_hidden_layers + 3:
            fail(f"pins auto: {res.get('pinned_layers')} layers pinned, not the whole model")
        log(f"[pins] --hbm_pin_gb {budget}: scores equal the unpinned run's bit for bit; "
            f"{res.get('pinned_layers')} layers pinned, {saved / n_gen} bytes saved per pass")
    fresh_process_state()
    return launches


# The train phase: Llama-2-7B's widths at 1 and 2 decoder layers, float32,
# a batch of 2 sequences of 128 + 1 tokens, AdamW at lr 1e-3 (the falling
# loss at 1e-6: AdamW's first step, lr * sign(g) on 460 M params, moves the
# loss by about lr * |g|_1, some 400 nats at 1e-3, and memorizes the batch).
TRAIN_B, TRAIN_L, TRAIN_LR, TRAIN_WD, TRAIN_CLIP = 2, 128, 1e-3, 0.1, 1.0
TRAIN_FALL_LR = 1e-6
# A gradient this close to 0 (after the clip) is within float32 summation
# noise of AdamW's eps (1e-8): its first update lr * g / (|g| + eps) may land
# anywhere in [-lr, lr] in either of two runs (atomics, another order).
NEAR_ZERO_GRAD = 1e-6


def _tree_to(tree, device):
    from flexible_llm_sharding_tpu_torch.training import tree_map

    return tree_map(lambda t: t.to(device), tree)


def _near_zero_mask(cfg, params, tokens):
    """Where the float32 gradient of one step from ``params``, clipped to a
    global norm of ``TRAIN_CLIP`` as the update sees it, is near zero (on
    the host, as bools)."""
    from flexible_llm_sharding_tpu_torch import training

    dev_params = _tree_to(params, "cuda")
    _, grads = training.value_and_grad(dev_params, cfg, tokens.cuda(), torch.float32, None)
    norm = float(training.global_norm(grads))
    bound = NEAR_ZERO_GRAD / min(1.0, TRAIN_CLIP / norm)
    return training.tree_map(lambda g: (g.abs() < bound).cpu(), grads)


def _update_err(tag: str, got, want, noisy, lr: float) -> dict:
    """Updated params against a reference update: within rtol 2e-5 / atol
    2e-6 (the JAX package's own invariant tolerance) where the gradient is
    not near zero, within 2 * lr where it is (``NEAR_ZERO_GRAD``)."""
    from flexible_llm_sharding_tpu_torch.training import tree_leaves

    worst, n_outside, n_noisy, n = 0.0, 0, 0, 0
    for a, b, m in zip(tree_leaves(got), tree_leaves(want), tree_leaves(noisy)):
        a, b = a.float(), b.float()
        err = (a - b).abs()
        outside = err > 2e-6 + 2e-5 * b.abs()
        if (outside & ~m).any() or (err[m] > 2 * lr).any():
            fail(f"train {tag}: {int((outside & ~m).sum())} params outside rtol 2e-5 / atol "
                 f"2e-6 with a clipped gradient of 1e-6 or more, max err {float(err.max()):.3e}")
        worst = max(worst, float(err.max()))
        n_outside += int(outside.sum())
        n_noisy += int(m.sum())
        n += m.numel()
    return {"max_abs_err": worst, "outside_rtol_2e-5_atol_2e-6": n_outside,
            "near_zero_grads": n_noisy, "params": n}


def _train_step_log(tag: str, tr, loss: float, peak: int | None = None) -> None:
    st = tr.stats
    log(f"[train] {tag}: loss {loss:.6f}, forward {st['forward_s']:.3f} s, backward "
        f"{st['backward_s']:.3f} s, update {st['update_s']:.3f} s, host->device "
        f"{st['h2d_bytes']} B, device->host {st['d2h_bytes']} B, grad norm "
        f"{st.get('grad_norm', float('nan')):.6f}"
        + (f", peak {peak} B" if peak is not None else ""))


def _refusals() -> None:
    """Satellite of the train phase: each CUDA attention wrapper asked for a
    gradient raises naming the training path, before any launch."""
    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape, grad=False):
        return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16).requires_grad_(grad)

    plen = torch.tensor([64, 17], dtype=torch.int32, device="cuda")
    eos = torch.tensor([[3, 15], [0, 7]], dtype=torch.int32, device="cuda")
    k, v = rnd(2, 64, 4, 128), rnd(2, 64, 4, 128)
    ks, vs = rnd(2, 2, 16, 4, 128), rnd(2, 2, 16, 4, 128)
    kg, vg = rnd(2, 2, 3, 4, 128), rnd(2, 2, 3, 4, 128)
    calls = {
        "flash_causal_attention": lambda: fa.flash_causal_attention(rnd(2, 64, 4, 128, grad=True),
                                                                    k, v, plen),
        "flash_prefix_shared_attention": lambda: fa.flash_prefix_shared_attention(
            rnd(2, 2, 16, 4, 128, grad=True), k, v, ks, vs, plen),
        "flash_decode_attention": lambda: fa.flash_decode_attention(
            rnd(2, 2, 1, 4, 128, grad=True), k, v, ks, vs, kg, vg, plen, eos, 0),
    }
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if "training path" not in str(e):
                fail(f"train: {name} refused a gradient without naming the training path: {e}")
            continue
        fail(f"train: {name} launched with an input that requires a gradient")
    log("[train] each CUDA attention wrapper refuses a gradient, naming the training path")


def phase_train(work: str, smi: str) -> dict:
    """Training on one card at Llama-2-7B's widths (hidden 4096, 32/32
    heads of 128, intermediate 11008, vocabulary 32000, untied), depth cut
    to 1 and 2 layers, seeded float32 params from the port's init_params:

    (a) one StreamedTrainer step equals one make_train_step update at
        depth 2 (loss within 1e-5 relative, params as ``_update_err``);
    (b) the streamed step's peak device memory is the same at depth 1 and 2
        (within 2%) and under the depth-2 monolithic step's;
    (c) four streamed steps on one batch at lr 1e-6 (``TRAIN_FALL_LR``):
        the loss falls at each, the first within 0.5 of ln V + s^2 / 2
        (random logits of the init's spread s = 0.02 sqrt(hidden));
    (d) a seeded bf16 native checkpoint (depth 1) through from_pretrained
        (bf16 masters and moments): save_state after step 2, the directory
        parked at .old as a crash between the save's renames leaves it, a
        new trainer's restore_state, step 3 equal to the uninterrupted one;
    (e) make_train_step with accum_steps=2 on [2, 1, L+1] equals the full
        batch at depth 1;
    (f) bf16 compute with float32 masters: a finite loss within 2% of the
        float32 step's and a finite gradient norm;
    (g) no attention kernel launches in training, and each wrapper refuses
        a gradient. Returns the phase's launches (all 0)."""
    import gc

    from flexible_llm_sharding_tpu_torch import training
    from flexible_llm_sharding_tpu_torch.config import LlamaConfig
    from flexible_llm_sharding_tpu_torch.models import llama
    from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa
    from flexible_llm_sharding_tpu_torch.training_stream import StreamedTrainer

    t_phase = time.perf_counter()
    fa.reset_launch_counts()
    cfg2, cfg1 = LlamaConfig(num_hidden_layers=2), LlamaConfig(num_hidden_layers=1)
    params2 = _tree_to(llama.init_params(torch.Generator(device="cuda").manual_seed(0), cfg2), "cpu")
    params1 = {**params2, "layers": params2["layers"][:1]}
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(1, cfg2.vocab_size, (TRAIN_B, TRAIN_L + 1)))
    kw = dict(lr=TRAIN_LR, grad_clip=TRAIN_CLIP, weight_decay=TRAIN_WD)
    opt = training.make_optimizer(peak_lr=TRAIN_LR, weight_decay=TRAIN_WD, grad_clip=TRAIN_CLIP)
    log(f"[train] {smi} | Llama-2-7B widths, depth 2: "
        f"{sum(t.numel() for t in training.tree_leaves(params2))} params, tokens "
        f"[{TRAIN_B}, {TRAIN_L + 1}]")

    def peak_of(fn):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated()

    # (a) streamed against monolithic at depth 2.
    noisy2 = _near_zero_mask(cfg2, params2, tokens)
    step = training.make_train_step(cfg2, opt, dtype=torch.float32)

    def mono():
        state = training.TrainState.create(cfg2, params2, opt, device="cuda")
        state, loss = step(state, tokens)
        return float(loss), _tree_to(state.params, "cpu")

    t0 = time.perf_counter()
    (loss_m, params_m), peak_m = peak_of(mono)
    log(f"[train] monolithic depth 2: loss {loss_m:.6f}, {time.perf_counter() - t0:.3f} s, "
        f"peak {peak_m} B")
    tr2 = StreamedTrainer(cfg2, params2, **kw)
    loss_s2, peak_s2 = peak_of(lambda: tr2.step(tokens))
    _train_step_log("streamed depth 2", tr2, loss_s2, peak_s2)
    if abs(loss_s2 - loss_m) > 1e-5 * abs(loss_m):
        fail(f"train (a): streamed loss {loss_s2} against monolithic {loss_m}")
    err = _update_err("(a) streamed vs monolithic", tr2.params, params_m, noisy2, TRAIN_LR)
    log(f"[train] (a) streamed == monolithic at depth 2: loss rel err "
        f"{abs(loss_s2 - loss_m) / abs(loss_m):.3e}, params " + json.dumps(err))
    del tr2, params_m, noisy2

    # (b) and (c): depth 1, four steps on the batch.
    tr1 = StreamedTrainer(cfg1, params1, **{**kw, "lr": TRAIN_FALL_LR})
    loss1, peak_s1 = peak_of(lambda: tr1.step(tokens))
    _train_step_log("streamed depth 1 step 1", tr1, loss1, peak_s1)
    spread = abs(peak_s1 - peak_s2) / peak_s2
    log(f"[train] (b) peaks: streamed depth 1 {peak_s1} B, depth 2 {peak_s2} B ({spread:.4%} "
        f"apart), monolithic depth 2 {peak_m} B")
    if spread > 0.02 or max(peak_s1, peak_s2) >= peak_m:
        fail("train (b): the streamed peak grows with depth or is not under the monolithic one")
    losses = [loss1]
    for i in range(2, 5):
        losses.append(tr1.step(tokens))
        _train_step_log(f"streamed depth 1 step {i}", tr1, losses[-1])
    expect = float(np.log(cfg1.vocab_size)) + (0.02**2 * cfg1.hidden_size) / 2
    log(f"[train] (c) losses {losses}; expected first {expect:.4f}")
    if any(b >= a for a, b in zip(losses, losses[1:])) or abs(losses[0] - expect) > 0.5:
        fail(f"train (c): the loss must fall at every step from about {expect:.3f}: {losses}")
    del tr1

    # (f) bf16 compute, float32 masters.
    trb = StreamedTrainer(cfg1, params1, dtype=torch.bfloat16, **kw)
    loss_b = trb.step(tokens)
    _train_step_log("streamed depth 1 bf16 compute", trb, loss_b)
    gnorm = trb.stats.get("grad_norm", float("nan"))
    if not (np.isfinite(loss_b) and np.isfinite(gnorm)) or abs(loss_b - loss1) > 0.02 * loss1:
        fail(f"train (f): bf16 loss {loss_b} (float32 {loss1}), grad norm {gnorm}")
    log(f"[train] (f) bf16 compute: loss {loss_b:.6f} against float32 {loss1:.6f} "
        f"({abs(loss_b - loss1) / loss1:.4%}), grad norm {gnorm:.6f}")
    del trb

    # (e) gradient accumulation at depth 1.
    noisy1 = _near_zero_mask(cfg1, params1, tokens)
    out = {}
    for accum, batch in ((1, tokens), (2, tokens.reshape(2, TRAIN_B // 2, TRAIN_L + 1))):
        state = training.TrainState.create(cfg1, params1, opt, device="cuda")
        state, loss = training.make_train_step(cfg1, opt, dtype=torch.float32,
                                               accum_steps=accum)(state, batch)
        out[accum] = (float(loss), _tree_to(state.params, "cpu"))
        del state
    if abs(out[2][0] - out[1][0]) > 1e-5 * abs(out[1][0]):
        fail(f"train (e): accumulated loss {out[2][0]} against the full batch's {out[1][0]}")
    err = _update_err("(e) accum_steps=2 vs full batch", out[2][1], out[1][1], noisy1, TRAIN_LR)
    log(f"[train] (e) accum_steps=2 == full batch: losses {out[2][0]:.6f} / {out[1][0]:.6f}, "
        f"params " + json.dumps(err))
    del out, noisy1

    # (d) checkpoint resume on a bf16 checkpoint.
    ckpt = os.path.join(work, "train-bf16")
    nbytes, secs = write_streamed_checkpoint(ckpt, cfg1, seed=1)
    log(f"[train] wrote a seeded bf16 depth-1 checkpoint ({nbytes} bytes) in {secs:.3f} s")
    batches = [torch.from_numpy(rng.integers(1, cfg1.vocab_size, (TRAIN_B, TRAIN_L + 1)))
               for _ in range(3)]
    tra = StreamedTrainer.from_pretrained(ckpt, **kw)
    for i, b in enumerate(batches[:2]):
        _train_step_log(f"bf16 checkpoint step {i + 1}", tra, tra.step(b))
    state_dir = os.path.join(work, "train-state")
    t0 = time.perf_counter()
    tra.save_state(state_dir)
    log(f"[train] save_state: {_dir_bytes(state_dir)} bytes in {time.perf_counter() - t0:.3f} s")
    loss3 = tra.step(batches[2])
    _train_step_log("bf16 checkpoint step 3", tra, loss3)
    os.rename(state_dir, state_dir + ".old")  # a crash between save_state's two renames
    trr = StreamedTrainer.from_pretrained(ckpt, **kw)
    t0 = time.perf_counter()
    trr.restore_state(state_dir)
    log(f"[train] restore_state from the .old directory in {time.perf_counter() - t0:.3f} s")
    if trr.step_count != 2 or not os.path.isdir(state_dir):
        fail(f"train (d): restored step {trr.step_count}, directory recovered "
             f"{os.path.isdir(state_dir)}")
    loss3r = trr.step(batches[2])
    if abs(loss3r - loss3) > 1e-5 * abs(loss3):
        fail(f"train (d): resumed step 3 loss {loss3r} against {loss3}")
    diff = [(a.float() - b.float()).abs() for a, b in
            zip(training.tree_leaves(trr.params), training.tree_leaves(tra.params))]
    ulp = [(d > torch.finfo(torch.bfloat16).eps * b.float().abs()).sum() for d, b in
           zip(diff, training.tree_leaves(tra.params))]
    n_diff = sum(int((d > 0).sum()) for d in diff)
    log(f"[train] (d) resumed step 3: loss {loss3r:.6f} against {loss3:.6f}, {n_diff} of "
        f"{sum(d.numel() for d in diff)} bf16 params differ, by at most one bf16 step")
    if any(int(u) for u in ulp):
        fail("train (d): a resumed bf16 param differs by more than one bf16 step")
    del tra, trr
    shutil.rmtree(ckpt, ignore_errors=True)
    shutil.rmtree(state_dir, ignore_errors=True)

    # (g)
    _refusals()
    counts = fa.launch_counts()
    if any(counts.values()):
        fail(f"train (g): attention kernels launched in training: {counts}")
    log(f"[train] (g) kernel launches across the phase: {counts}; the phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {k: {"launches": 0, "local_launches": 0} for k in fa.KERNELS}


def main() -> None:
    from flexible_llm_sharding_tpu_torch.config import LlamaConfig
    from flexible_llm_sharding_tpu_torch.utils.checkpoint import requantize_native

    t_start = time.perf_counter()

    def mark(step: str) -> None:
        """The seconds since the start at the end of a step: the run's time
        limit is shared by every phase."""
        log(f"[time] {step} done at {time.perf_counter() - t_start:.1f} s")

    smi = phase_device()
    phase_build()
    mark("build")
    prompts = make_prompts(8, 512, 4, 32, seed=0)
    n_gen_loop, n_gen_kv = 4, 8
    # Gemma 3: 2048 prefix words (2049 tokens in a 2112 bucket), past the
    # 1024-token window; depth cut from 62 to 2 layers, one local (the
    # published pattern's first five) and one global (its sixth).
    gemma_prompts = make_prompts(8, 2048, 4, 32, seed=1)
    gemma_loop, gemma_kv = 2, 4
    gemma_types = {"num_hidden_layers": 2, "layer_types": ["sliding_attention", "full_attention"]}
    gemma_cfg = LlamaConfig.from_dict(
        {"model_type": "gemma3", "text_config": {**GEMMA3_27B_TEXT, **gemma_types}})
    # Gemma-3-12B: depth cut from 48 to 2 layers (layer 0 local, 1 global).
    gemma12_text = {**GEMMA3_12B_TEXT, **gemma_types}
    gemma12_cfg = LlamaConfig.from_dict({"model_type": "gemma3", "text_config": gemma12_text})
    # DeepSeek-V3: depth cut from 61 to 2 layers (0 dense, as the published
    # first three are, 1 MoE), the Gemma prompts.
    ds_cfg = LlamaConfig.from_dict({**DEEPSEEK_V3, "num_hidden_layers": 2,
                                    "first_k_dense_replace": 1})
    ds_loop, ds_kv = 2, 2
    # Llama-4-Scout: depth cut from 48 to 2 layers (0 a chunked rope layer,
    # as the published pattern's first three are, 1 the NoPE layer, its
    # fourth; every layer MoE), the Gemma prompts.
    scout_cfg = LlamaConfig.from_dict({**LLAMA4_SCOUT_TEXT, "num_hidden_layers": 2,
                                       "layer_types": ["chunked_attention", "full_attention"],
                                       "no_rope_layers": [1, 0]})
    scout_loop, scout_kv = 2, 2
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
                       nkv=ds_cfg.num_attention_heads, hd=ds_cfg.head_dim, hd_v=ds_cfg.v_dim),
        main_path_case(gemma_prompts, scout_kv, nq=scout_cfg.num_attention_heads,
                       nkv=scout_cfg.num_key_value_heads, hd=scout_cfg.head_dim),
        draft_path_case(prompts, n_gen_kv),
        main_path_case(coalesce_prompts()[:1], n_gen_kv))
    mark("kernels")
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        phase_cross(work)
        mark("cross")
        phase_host(work)
        mark("host")
        llama_cfg = LlamaConfig(num_hidden_layers=4)
        llama_runs: dict = {}
        paths = {
            "llama2_7b": phase_full(work, "llama2-7b", llama_cfg, prompts, n_gen_loop, n_gen_kv,
                                    compare_modes=True, record=llama_runs),
        }
        llama_dir = os.path.join(work, "llama2-7b")
        mark("full llama2-7b")
        paths["llama2_7b_quant"] = phase_quant(work, llama_dir, llama_cfg, prompts, llama_runs,
                                               n_gen_loop, n_gen_kv)
        mark("quant")
        paths["llama2_7b_resume"] = phase_resume(work, llama_dir, llama_cfg, prompts,
                                                 llama_runs["scoring"], n_gen_loop)
        mark("resume")
        serve_runs: dict = {}
        paths.update(phase_serve(work, llama_dir, llama_cfg, prompts, n_gen_kv, smi,
                                 record=serve_runs))
        mark("serve")
        paths.update(phase_tenants(work, llama_dir, llama_cfg, prompts, n_gen_kv, smi,
                                   serve_runs["default"]))
        mark("tenants")
        paths.update(phase_fleet(work, llama_dir, llama_cfg, prompts, n_gen_kv, smi,
                                 serve_runs["default"]))
        mark("fleet")
        paths.update(phase_multidevice(work, llama_dir, llama_cfg, prompts, n_gen_kv, smi))
        mark("multidevice")
        paths["llama2_7b_longctx"] = phase_longctx(work, llama_dir, llama_cfg, smi)
        mark("longctx")
        f32_runs: dict = {}
        paths["llama2_7b_use_pallas"] = phase_use_pallas(work, llama_dir, llama_cfg, prompts, smi,
                                                         record=f32_runs)
        mark("use_pallas")
        paths["llama2_7b_tp"] = phase_tp(work, llama_dir, llama_cfg, prompts, smi, f32_runs)
        mark("tp")
        paths["llama2_7b_pressure"] = phase_pressure(work, llama_dir, llama_cfg, prompts,
                                                     llama_runs, serve_runs["default"],
                                                     n_gen_loop, n_gen_kv, smi)
        mark("pressure")
        paths["llama2_7b_obs"] = phase_obs(work, llama_dir, llama_cfg, prompts, llama_runs,
                                           serve_runs["default"], n_gen_loop, n_gen_kv, smi)
        mark("obs")
        shutil.rmtree(llama_dir, ignore_errors=True)
        paths.update({
            "gemma3_27b": phase_full(work, "gemma3-27b", gemma_cfg, gemma_prompts, gemma_loop,
                                     gemma_kv),
        })
        mark("full gemma3-27b")
        split_dir, split_cfg = phase_split(work, "gemma3-12b", gemma12_text)
        if split_cfg != gemma12_cfg:
            fail(f"the split gemma3-12b config differs from the bundle's: {split_cfg}")
        paths["gemma3_12b"] = phase_full(work, "gemma3-12b", split_cfg, gemma_prompts, gemma_loop,
                                         gemma_kv, model_dir=split_dir)
        mark("split and full gemma3-12b")
        ds_dir = os.path.join(work, "deepseek-v3")
        nbytes, secs = write_streamed_checkpoint(ds_dir, ds_cfg, seed=0)
        log(f"[full] wrote a seeded bf16 deepseek-v3-width checkpoint with {ds_cfg.num_hidden_layers} "
            f"decoder layers ({nbytes} bytes, one layer file at a time) in {secs:.3f} s")
        ds_q4 = os.path.join(work, "deepseek-v3-int4")
        t0 = time.perf_counter()
        requantize_native(ds_dir, ds_q4, dtype="int4")
        log(f"[quant] requantize_native int4 of deepseek-v3: {_dir_bytes(ds_q4)} bytes from "
            f"{nbytes} in {time.perf_counter() - t0:.3f} s")
        # Layer 0 is dense; layer 1 holds the 256-expert stacks.
        check_card_dequant(ds_q4, f"model.layers.{ds_cfg.num_hidden_layers - 1}")
        mark("deepseek-v3 written, requantized, dequant checked")
        ds_runs: dict = {}
        paths["deepseek_v3"] = phase_full(work, "deepseek-v3", ds_cfg, gemma_prompts, ds_loop, ds_kv,
                                          model_dir=ds_dir, record=ds_runs)
        paths["deepseek_v3_tp"] = tp_deepseek(ds_dir, ds_cfg, gemma_prompts, ds_runs["scoring"],
                                              ds_runs["scoring_launches"], ds_loop, smi)
        shutil.rmtree(ds_dir, ignore_errors=True)
        paths["deepseek_v3_int4"] = quant_run(
            work, "deepseek-v3-int4", ds_q4, ds_cfg, gemma_prompts, "kv_cache",
            ["--num_gen_token", str(ds_kv), "--kv_cache", "true"], ds_kv, ds_runs["kv_cache"],
            QUANT_BOUNDS["int4"], ("flash_causal_attention", "flash_prefix_shared_attention"))
        shutil.rmtree(ds_q4, ignore_errors=True)
        mark("full deepseek-v3 and its int4 copy")
        scout_dir = os.path.join(work, "llama4-scout")
        nbytes, secs = write_streamed_checkpoint(scout_dir, scout_cfg, seed=0)
        log(f"[full] wrote a seeded bf16 llama4-scout-width checkpoint with "
            f"{scout_cfg.num_hidden_layers} decoder layers ({nbytes} bytes, one layer file at a "
            f"time) in {secs:.3f} s")
        paths["llama4_scout"] = phase_full(work, "llama4-scout", scout_cfg, gemma_prompts, scout_loop,
                                           scout_kv, model_dir=scout_dir,
                                           payload=payload_bytes(scout_cfg))
        mark("full llama4-scout")
        paths[f"llama2_7b_{DECODE_LAYERS}_layers"] = phase_decode(work)
        mark("decode")
        paths["llama2_7b_train"] = phase_train(work, smi)
        mark("train")
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
                                              "deepseek_v3_mla", "llama4_scout_global",
                                              "llama4_scout_chunked", "tinyllama_draft",
                                              "llama2_7b_coalesced_s8", "llama2_7b_tp2_shard",
                                              "llama2_7b_tp4_shard", "llama2_7b_f32",
                                              "deepseek_v3_tp2_shard", "deepseek_v3_tp2_shard_f32")
               if key in timed[k]},
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
