// Hopper (sm_90a) attention kernels for the layer-streamed scorer.
//
// Kernels and the Pallas TPU kernels of
// flexible_llm_sharding_tpu/ops/pallas_attention.py they replace:
//
//   score_tc_kernel (bf16/fp16), one KV source   <- flash_causal_attention
//                                                   (_causal_kernel)
//   score_tc_kernel (bf16/fp16), two KV sources  <- flash_prefix_shared_attention
//                                                   (_prefix_shared_kernel)
//   decode_kernel                                <- flash_decode_attention
//                                                   (_decode_kernel)
//   score_kernel_f32: the float32 form of the first two (FMA products), the
//   path of the float32 card-vs-CPU cross-check, not of the bf16 main path.
//
// Each computes what its TPU kernel computes (one joint online softmax over
// one or more KV "sources", fp32 statistics and accumulators, P cast to V's
// type before the PV product, a masked key adding exactly 0, rows with no
// visible key written as 0), not a block-by-block copy of it. The TPU runs a
// sequential grid with scalar prefetch; here every block computes its own
// offsets, masks and loop bounds from blockIdx and the per-batch lengths.
//
// What bounds them on the H100, and what the design does about it:
//
// * Scoring (causal prefix pass, prefix-shared suffix pass). QK^T plus PV
//   cost 4*hd FLOPs per visible (query, key) pair; the bytes that must move
//   are 4*hd per query row (Q in, O out) and 4*hd per key row (K and V, read
//   once). The H100 does 295 bf16 FLOPs per byte, so the products bound the
//   causal pass once queries see about 1200 keys on average (prefixes of
//   ~2k tokens and more); at 512-token prefixes both passes are bound by
//   bytes. Either way the kernel must keep the tensor cores fed and move
//   nothing but K/V tiles through shared memory:
//   - A block is three warpgroups: one producer and two consumers. The
//     producer's one thread keeps K/V tiles (64 keys) in flight with TMA
//     (cp.async.bulk.tensor, 128-byte swizzle, completion on mbarriers)
//     into a ring of kStages shared-memory stages, so loads overlap the
//     products of earlier tiles; it gives up registers (setmaxnreg) to the
//     consumers.
//   - Blocks are persistent, one per SM, each walking a strided list of
//     work units (a query tile of one head). Q is double-buffered, so the
//     producer loads the next unit's Q and first K/V tiles while the
//     consumers finish the current one, and the load latency a short unit
//     would pay at its start is hidden.
//   - Each consumer owns 64 query rows, loaded once by TMA. S = Q K^T is
//     wgmma m64n64k16 from shared memory (K K-major); O += P V is
//     wgmma m64n{hd}k16 with P taken from registers (the fp32 scores
//     converted pairwise in place) and V read with the transpose bit.
//     Softmax statistics and O never leave registers: row max and sum are
//     reduced across the 4 threads of a quad with shuffles, exp2 with
//     scale*log2(e) folded in, O rescaled in registers.
//   - One load of a K/V tile serves both consumers: in the causal form the
//     two 64-row halves of a 128-row query tile; in the prefix-shared form
//     two suffixes of one (prompt, head), which walk the same prefix tiles
//     (loaded once) and then their own suffix tiles. The prefix bytes moved
//     into shared memory halve against one block per suffix.
//   - The visibility mask runs only on the tiles that need it (a causal
//     source's diagonal tile, the tile holding a source's limit). TMA loads
//     whatever lies in the tensor past a source's limit, so that tile's P is
//     0 there and its V rows are zeroed before PV (0 * NaN would be NaN).
//   - Tiles past the limit and above the diagonal are never loaded. The
//     tile loop starts at an explicit index (0 today), where a sliding
//     window or chunk adds its start bound.
// * Decode. One new token per suffix: 2 products per key against one key
//   row of K and V each, so it is bound by the bytes of the KV it reads.
//   One block per (batch, suffix, KV head, group of <= 8 query heads) reads
//   each KV tile once for all query heads of its group (GQA), reads only the
//   tiles a suffix can see (prefix tiles up to prefix_len, suffix tiles up
//   to its eos, generated tiles up to t), with 16-byte global loads. Products
//   are FMA loops; at one query row per head the tensor cores would idle.
//
// Plain C interface, loaded with ctypes. Every launch goes on the caller's
// stream and returns cudaGetLastError(). The TMA descriptors are encoded on
// the host by cuTensorMapEncodeTiled, looked up at run time (no link against
// libcuda).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -0.7f * FLT_MAX;  // the JAX package's _NEG_INF
constexpr int kTile = 64;                    // queries / keys per tile of the FMA kernels
constexpr int kScoreThreads = 128;           // float32 scoring: 4 warps, 16 query rows each
constexpr int kDecodeGroup = 8;              // query heads per decode block

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__half>(__half x) { return __half2float(x); }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One KV source: rows [len] of K and V with row stride n_kv*hd, located at
// k + b*stride_b + s*stride_s. Key j is visible iff j < limit and, for a
// causal source, j <= the query's row index. limit = lim[b*lim_sb +
// s*lim_ss] + lim_add, or lim_add alone when lim is null; clamped to len.
struct Source {
  const void* k;
  const void* v;
  long long stride_b;
  long long stride_s;
  int len;
  const int* lim;
  int lim_sb;
  int lim_ss;
  int lim_add;
  int causal;
};

__device__ __forceinline__ int source_limit(const Source& src, int b, int s) {
  int lim = src.lim ? src.lim[b * src.lim_sb + s * src.lim_ss] + src.lim_add : src.lim_add;
  return max(0, min(lim, src.len));
}

__device__ __forceinline__ float cap_score(float x, float softcap) {
  return softcap > 0.f ? tanhf(x / softcap) * softcap : x;
}

// Cooperative copy of `rows` rows of HD elements (row stride `stride` in
// global memory, pitch P in shared memory) with 16-byte global loads; rows
// at or past `avail` are zero-filled. Global rows start at multiples of HD
// elements from a 16-byte aligned base (checked by the wrapper).
template <typename T, int HD, int P, int NT>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long stride, int avail) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = HD / kVec;
  for (int c = threadIdx.x; c < kTile * kChunks; c += NT) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < avail) val = *reinterpret_cast<const uint4*>(src + r * stride + col);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&val);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst + r * P + col);
    if constexpr ((P * sizeof(T)) % 16 == 0) {
      *reinterpret_cast<uint4*>(d) = val;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = w[i];
    }
  }
}

struct ScoreParams {
  const void* q;
  void* o;
  long long q_stride_bs;  // elements per (b, s) slab of q and o
  int lq;
  int n_q;
  int n_kv;
  int n_s;
  float scale;
  float softcap;
  int n_src;
  Source src[2];
};

// ---------------------------------------------------------------------------
// Float32 scoring kernel: a 64-query tile of one head, FMA products (the
// tensor cores would round float32 inputs to TF32)
// ---------------------------------------------------------------------------

template <int HD>
struct F32Layout {
  static constexpr int QP = HD + 1;     // Q/K/V pitch
  static constexpr int SP = kTile + 1;  // scores and P pitch
  static constexpr int OP = HD + 1;     // O pitch
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = align128(kQ + sizeof(float) * kTile * QP);
  static constexpr size_t kV = align128(kK + sizeof(float) * kTile * QP);
  static constexpr size_t kS = align128(kV + sizeof(float) * kTile * QP);
  static constexpr size_t kP = align128(kS + sizeof(float) * kTile * SP);
  static constexpr size_t kO = align128(kP + sizeof(float) * kTile * SP);
  static constexpr size_t kBytes = align128(kO + sizeof(float) * kTile * OP);
};

// S[16 x 64] = Q[16 x HD] K^T for this warp's 16 query rows.
template <int HD>
__device__ __forceinline__ void warp_scores(const float* Qs, const float* Ks, float* Ss, int warp, int lane) {
  using L = F32Layout<HD>;
  for (int r = 0; r < 16; ++r) {
    const float* qr = Qs + (warp * 16 + r) * L::QP;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float qv = qr[d];
      a0 = fmaf(qv, Ks[lane * L::QP + d], a0);
      a1 = fmaf(qv, Ks[(lane + 32) * L::QP + d], a1);
    }
    Ss[(warp * 16 + r) * L::SP + lane] = a0;
    Ss[(warp * 16 + r) * L::SP + lane + 32] = a1;
  }
}

// O[16 x HD] += P[16 x 64] V[64 x HD] for this warp's 16 query rows.
template <int HD>
__device__ __forceinline__ void warp_pv(const float* Ps, const float* Vs, float* Os, int warp, int lane) {
  using L = F32Layout<HD>;
  for (int r = 0; r < 16; ++r) {
    const float* pr = Ps + (warp * 16 + r) * L::SP;
    float acc[HD / 32];
#pragma unroll
    for (int j = 0; j < HD / 32; ++j) acc[j] = 0.f;
    for (int c = 0; c < kTile; ++c) {
      const float pv = pr[c];
#pragma unroll
      for (int j = 0; j < HD / 32; ++j) acc[j] = fmaf(pv, Vs[c * L::QP + lane + 32 * j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < HD / 32; ++j) Os[(warp * 16 + r) * L::OP + lane + 32 * j] += acc[j];
  }
}

template <int HD>
__global__ void __launch_bounds__(kScoreThreads) score_kernel_f32(const ScoreParams p) {
  using L = F32Layout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::kQ);
  float* Ks = reinterpret_cast<float*>(smem + L::kK);
  float* Vs = reinterpret_cast<float*>(smem + L::kV);
  float* Ss = reinterpret_cast<float*>(smem + L::kS);
  float* Ps = reinterpret_cast<float*>(smem + L::kP);
  float* Os = reinterpret_cast<float*>(smem + L::kO);

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int bs = blockIdx.z;
  const int b = bs / p.n_s;
  const int s = bs % p.n_s;
  const int kvh = h / (p.n_q / p.n_kv);
  const int q_rows = min(kTile, p.lq - q0);
  const long long q_row_stride = (long long)p.n_q * HD;
  const long long kv_row_stride = (long long)p.n_kv * HD;

  const float* qbase = static_cast<const float*>(p.q) + bs * p.q_stride_bs + q0 * q_row_stride + h * HD;
  load_rows<float, HD, L::QP, kScoreThreads>(Qs, qbase, q_row_stride, q_rows);
  for (int i = threadIdx.x; i < kTile * L::OP; i += kScoreThreads) Os[i] = 0.f;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // Softmax ownership: each query row belongs to a lane pair, each lane
  // handling 32 of the tile's 64 keys.
  const int row = warp * 16 + lane / 2;
  const int half = lane & 1;
  const int qi = q0 + row;
  float m = kNegInf;
  float l = 0.f;

  for (int si = 0; si < p.n_src; ++si) {
    const Source src = p.src[si];
    const int limit = source_limit(src, b, s);
    int n_tiles = (limit + kTile - 1) / kTile;
    if (src.causal) n_tiles = min(n_tiles, (q0 + q_rows + kTile - 1) / kTile);
    const float* kbase = static_cast<const float*>(src.k) + b * src.stride_b + s * src.stride_s + kvh * HD;
    const float* vbase = static_cast<const float*>(src.v) + b * src.stride_b + s * src.stride_s + kvh * HD;
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * kTile;
      __syncthreads();  // the previous tile's K/V are no longer read
      load_rows<float, HD, L::QP, kScoreThreads>(Ks, kbase + k0 * kv_row_stride, kv_row_stride, limit - k0);
      load_rows<float, HD, L::QP, kScoreThreads>(Vs, vbase + k0 * kv_row_stride, kv_row_stride, limit - k0);
      __syncthreads();

      warp_scores<HD>(Qs, Ks, Ss, warp, lane);
      __syncwarp();

      float x[32];
      uint32_t vis = 0u;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int col = half * 32 + c;
        const int kj = k0 + col;
        const bool v = kj < limit && (!src.causal || kj <= qi);
        float val = kNegInf;
        if (v) {
          val = cap_score(Ss[row * L::SP + col] * p.scale, p.softcap);
          vis |= 1u << c;
        }
        x[c] = val;
        mx = fmaxf(mx, val);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        // A masked key adds exactly 0: exp(NEG - NEG) would add 1.
        const float pv = (vis >> c) & 1u ? expf(x[c] - m_new) : 0.f;
        rs += pv;
        Ps[row * L::SP + half * 32 + c] = pv;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      l = l * alpha + rs;
      m = m_new;
      for (int d = half * (HD / 2); d < (half + 1) * (HD / 2); ++d) Os[row * L::OP + d] *= alpha;
      __syncwarp();

      warp_pv<HD>(Ps, Vs, Os, warp, lane);
      __syncwarp();
    }
  }

  __syncthreads();  // O was zeroed by other threads when no tile ran
  if (qi < p.lq) {
    float* obase = static_cast<float*>(p.o) + bs * p.q_stride_bs + qi * q_row_stride + h * HD;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    for (int d = half * (HD / 2); d < (half + 1) * (HD / 2); ++d) obase[d] = Os[row * L::OP + d] * inv;
  }
}

template <int HD>
cudaError_t launch_score_f32(const ScoreParams& p, int n_bs, cudaStream_t stream) {
  using L = F32Layout<HD>;
  // Once per template instantiation (thread-safe static init), not per launch.
  static const cudaError_t attr = cudaFuncSetAttribute(score_kernel_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (attr != cudaSuccess) return attr;
  dim3 grid((p.lq + kTile - 1) / kTile, p.n_q, n_bs);
  score_kernel_f32<HD><<<grid, kScoreThreads, L::kBytes, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16/fp16 scoring kernel: TMA-fed K/V ring, wgmma products, softmax and O
// in registers, one K/V load for two consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int kBM = 64;                             // query rows per consumer warpgroup
constexpr int kBN = 64;                             // keys per K/V tile
constexpr int kStages = 4;                          // K/V tiles in the ring
constexpr int kConsumers = 2;                       // consumer warpgroups per block
constexpr int kTcThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// K and V of source i come through TMA descriptors k_map[i]/v_map[i] over a
// 4-D view [batch entry, row, head, hd] (Q likewise through q_map); the
// batch entry of (b, s) is b*n_s + s for a per-suffix source (stride_s !=
// 0), else b. The pointers of src are not read on the device.
struct TcParams {
  CUtensorMap q_map;
  CUtensorMap k_map[2];
  CUtensorMap v_map[2];
  void* o;
  int lq;
  int n_q;
  int n_kv;
  int n_s;
  int n_pairs;    // suffix pairs per batch entry in pair mode
  int pair_mode;  // 1: the consumers take suffixes 2p and 2p+1; 0: two halves of a 128-row tile
  int n_qt;       // query tiles per (batch entry, head)
  int n_units;    // work units: n_qt per (b, head, suffix pair)
  float scale;
  float scale_log2;
  float softcap;
  int n_src;
  Source src[2];
};

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle's
// period): two Q buffers (one per unit in flight) of one tile per consumer,
// then the K/V stages, then the barriers. A tile of hd columns is stored as
// hd/64 column halves of rows x 128 bytes.
template <int HD>
struct TcLayout {
  static constexpr int kHalves = HD / 64;
  static constexpr int kHalfQ = kBM * 128;
  static constexpr int kHalfKV = kBN * 128;
  static constexpr int kQBytes = kHalves * kHalfQ;
  static constexpr int kKVBytes = kHalves * kHalfKV;
  static constexpr int kStageBytes = 2 * kKVBytes;  // K then V
  static constexpr int kQ = 0;
  static constexpr int kStage0 = 2 * kConsumers * kQBytes;
  static constexpr int kBar = kStage0 + kStages * kStageBytes;
  static constexpr int kBytes = kBar + (2 * kStages + 4) * 8 + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Waits for the phase of parity `parity` to complete. A wait of seconds
// means a barrier that can never complete: trap, so the launch fails with
// an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spin == 1024) t0 = clock64();
    if (spin > 1024 && (spin & 1023) == 0 && clock64() - t0 > (1ll << 33)) __trap();
  }
}

// One box of the 4-D map (64 columns, 1 head, rows, 1 batch entry) into
// shared memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int col,
                                         int head, int row, int entry) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(entry)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor of a 128-byte swizzled tile: start address,
// leading byte offset (16-byte units; the next 64-column half of an
// MN-major operand, unused for K-major), stride byte offset 1024 B (the next
// 8 rows), layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(64) << 32) | (1ull << 62);
}

// The four wgmma forms of the kernel, for bf16 and fp16.
__device__ __forceinline__ void wgmma_qk_bf16(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_pv64_bf16(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_pv128_bf16(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_qk_f16(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_pv64_f16(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_pv128_f16(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <typename T>
__device__ __forceinline__ void mma_qk(float (&d)[kBN / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) wgmma_qk_bf16(d, da, db, scale_d);
  else wgmma_qk_f16(d, da, db, scale_d);
}

template <typename T, int HD>
__device__ __forceinline__ void mma_pv(float (&d)[HD / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 64) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) wgmma_pv64_bf16(d, a, db, 1);
    else wgmma_pv64_f16(d, a, db, 1);
  } else {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) wgmma_pv128_bf16(d, a, db, 1);
    else wgmma_pv128_f16(d, a, db, 1);
  }
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// One work unit: head h of batch b, and per consumer its first query row,
// its suffix and whether it has any rows at all.
struct BlockPos {
  int b;
  int h;
  int kvh;
  int qa[kConsumers];
  int s[kConsumers];
  bool active[kConsumers];
};

// Unit u: the query tiles of one (b, h) (and suffix pair) are consecutive,
// longest causal tile first, so the blocks running at once share few K/V
// heads in L2 and every block gets a mix of long and short tiles.
__device__ __forceinline__ BlockPos unit_pos(const TcParams& p, int u) {
  BlockPos bp;
  const int qt = p.n_qt - 1 - u % p.n_qt;
  int rest = u / p.n_qt;
  bp.h = rest % p.n_q;
  rest /= p.n_q;
  bp.kvh = bp.h / (p.n_q / p.n_kv);
  bp.b = p.pair_mode ? rest / p.n_pairs : rest;
#pragma unroll
  for (int g = 0; g < kConsumers; ++g) {
    if (p.pair_mode) {
      bp.s[g] = (rest % p.n_pairs) * kConsumers + g;
      bp.qa[g] = qt * kBM;
      bp.active[g] = bp.s[g] < p.n_s;
    } else {
      bp.s[g] = 0;
      bp.qa[g] = (qt * kConsumers + g) * kBM;
      bp.active[g] = bp.qa[g] < p.lq;
    }
  }
  return bp;
}

// One source as the block walks it: per consumer its TMA batch entry, its
// key limit and its tile count; t0 is the first tile (a later window or
// chunk start bound goes here).
struct SrcPlan {
  int entry[kConsumers];
  int limit[kConsumers];
  int nt[kConsumers];
  int t0;
};

__device__ __forceinline__ SrcPlan plan_source(const TcParams& p, const BlockPos& bp, int si) {
  const Source& src = p.src[si];
  SrcPlan sp;
  sp.t0 = 0;
#pragma unroll
  for (int g = 0; g < kConsumers; ++g) {
    sp.entry[g] = src.stride_s ? bp.b * p.n_s + bp.s[g] : bp.b;
    sp.limit[g] = 0;
    sp.nt[g] = 0;
    if (!bp.active[g]) continue;
    const int lim = source_limit(src, bp.b, bp.s[g]);
    int nt = (lim + kBN - 1) / kBN;
    if (src.causal) nt = min(nt, (min(bp.qa[g] + kBM, p.lq) + kBN - 1) / kBN);
    sp.limit[g] = lim;
    sp.nt[g] = nt;
  }
  return sp;
}

// The ring's items, in the order the producer loads them and the consumers
// take them: per source, tiles both consumers share once (same batch entry:
// the causal form, the shared prefix), else each consumer's own tiles.
// f(si, plan, entry, t, used_by_0, used_by_1).
template <class F>
__device__ __forceinline__ void walk_items(const TcParams& p, const BlockPos& bp, F&& f) {
  for (int si = 0; si < p.n_src; ++si) {
    const SrcPlan sp = plan_source(p, bp, si);
    if (sp.entry[0] == sp.entry[1]) {
      const int n = max(sp.nt[0], sp.nt[1]);
      for (int t = sp.t0; t < n; ++t) f(si, sp, sp.entry[0], t, t < sp.nt[0], t < sp.nt[1]);
    } else {
      for (int t = sp.t0; t < sp.nt[0]; ++t) f(si, sp, sp.entry[0], t, true, false);
      for (int t = sp.t0; t < sp.nt[1]; ++t) f(si, sp, sp.entry[1], t, false, true);
    }
  }
}

// Barrier addresses: full[i] (stage i's bytes arrived), empty[i] (every
// consumer warp is done with stage i), qfull[j] / qempty[j] the same for Q
// buffer j.
struct Barriers {
  uint32_t full0;
  uint32_t empty0;
  uint32_t qfull0;
  uint32_t qempty0;
};

// The producer's one thread: per unit, Q into the unit's buffer once the
// unit two back has released it, then the unit's K/V tiles through the ring.
template <int HD>
__device__ __forceinline__ void produce(const TcParams& p, uint32_t base, const Barriers& bar) {
  using L = TcLayout<HD>;
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x, n = 0; u < p.n_units; u += gridDim.x, ++n) {
    const BlockPos bp = unit_pos(p, u);
    const int qb = n & 1;
    mbar_wait(bar.qempty0 + 8 * qb, ((n >> 1) & 1) ^ 1);
    uint32_t qbytes = 0;
#pragma unroll
    for (int g = 0; g < kConsumers; ++g) qbytes += bp.active[g] ? L::kQBytes : 0;
    mbar_expect_tx(bar.qfull0 + 8 * qb, qbytes);
#pragma unroll
    for (int g = 0; g < kConsumers; ++g) {
      if (!bp.active[g]) continue;
#pragma unroll
      for (int hh = 0; hh < L::kHalves; ++hh)
        tma_load(base + L::kQ + (qb * kConsumers + g) * L::kQBytes + hh * L::kHalfQ, &p.q_map,
                 bar.qfull0 + 8 * qb, hh * 64, bp.h, bp.qa[g], bp.b * p.n_s + bp.s[g]);
    }
    walk_items(p, bp, [&](int si, const SrcPlan&, int entry, int t, bool, bool) {
      mbar_wait(bar.empty0 + 8 * stage, phase ^ 1);
      const uint32_t full = bar.full0 + 8 * stage;
      mbar_expect_tx(full, L::kStageBytes);
      const uint32_t ks = base + L::kStage0 + stage * L::kStageBytes;
#pragma unroll
      for (int hh = 0; hh < L::kHalves; ++hh) {
        tma_load(ks + hh * L::kHalfKV, &p.k_map[si], full, hh * 64, bp.kvh, t * kBN, entry);
        tma_load(ks + L::kKVBytes + hh * L::kHalfKV, &p.v_map[si], full, hh * 64, bp.kvh, t * kBN, entry);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    });
  }
}

// Consumer warpgroup g: per unit, its 64 query rows against every item of
// the ring (computing on the items it uses, releasing all of them).
template <typename T, int HD>
__device__ __forceinline__ void consume(const TcParams& p, const int g, uint8_t* smem, uint32_t base,
                                        const Barriers& bar) {
  using L = TcLayout<HD>;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int cq = 2 * (lane % 4);              // its first column in every 8-column block
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x, n = 0; u < p.n_units; u += gridDim.x, ++n) {
    const BlockPos bp = unit_pos(p, u);
    const int qb = n & 1;
    const int qa = g == 0 ? bp.qa[0] : bp.qa[1];
    const int i0 = qa + r0;
    const int i1 = i0 + 8;
    const uint32_t qs = base + L::kQ + (qb * kConsumers + g) * L::kQBytes;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    mbar_wait(bar.qfull0 + 8 * qb, (n >> 1) & 1);
    walk_items(p, bp, [&](int si, const SrcPlan& sp, int, int t, bool use0, bool use1) {
      mbar_wait(bar.full0 + 8 * stage, phase);
      if (g == 0 ? use0 : use1) {
        const int limit = g == 0 ? sp.limit[0] : sp.limit[1];
        const int causal = p.src[si].causal;
        const int k0 = t * kBN;
        const uint32_t ks = base + L::kStage0 + stage * L::kStageBytes;
        const uint32_t vs = ks + L::kKVBytes;
        if (k0 + kBN > limit) {
          // Rows past the limit hold whatever the tensor has there: zero
          // them in V (both consumers may write the same zeros).
          const int rz = max(limit - k0, 0);
          const int chunks = (kBN - rz) * 8;  // 16-byte chunks per column half
          for (int c = tid; c < chunks * L::kHalves; c += 128) {
            const int hh = c / chunks;
            const int r = rz + (c % chunks) / 8;
            *reinterpret_cast<uint4*>(smem + (vs - base) + hh * L::kHalfKV + r * 128 + (c % 8) * 16) =
                make_uint4(0u, 0u, 0u, 0u);
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile("bar.sync %0, 128;\n" :: "r"(1 + g) : "memory");
        }

        // S = Q K^T, both K-major from shared memory.
        float s[kBN / 2];
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;
        pin(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          mma_qk<T>(s, sw128_desc(qs + (kk / 4) * L::kHalfQ + off, 1),
                    sw128_desc(ks + (kk / 4) * L::kHalfKV + off, 1), kk > 0);
        }
        wgmma_commit();
        wgmma_wait();
        pin(s);

        // Scores in log2 units: scale -> softcap -> mask, as the reference.
        if (p.softcap > 0.f) {
          const float inv_cap = p.scale / p.softcap;
          const float cap2 = p.softcap * kLog2e;
#pragma unroll
          for (int i = 0; i < kBN / 2; ++i) s[i] = tanhf(s[i] * inv_cap) * cap2;
        } else {
#pragma unroll
          for (int i = 0; i < kBN / 2; ++i) s[i] *= p.scale_log2;
        }
        if (k0 + kBN > limit || (causal && k0 + kBN - 1 > qa)) {
#pragma unroll
          for (int i = 0; i < kBN / 2; ++i) {
            const int kj = k0 + 8 * (i / 4) + cq + (i & 1);
            const int qi = (i & 2) ? i1 : i0;
            if (!(kj < limit && (!causal || kj <= qi))) s[i] = -INFINITY;
          }
        }
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          if (i & 2) mx1 = fmaxf(mx1, s[i]);
          else mx0 = fmaxf(mx0, s[i]);
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        // m stays finite (it starts at kNegInf), so a masked key's -inf gives
        // exactly 0 and a row with no visible key yet keeps l = 0.
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          if (i & 2) {
            s[i] = exp2f(s[i] - mn1);
            rs1 += s[i];
          } else {
            s[i] = exp2f(s[i] - mn0);
            rs0 += s[i];
          }
        }
        l0 = l0 * a0 + rs0;  // per-thread partial sums, reduced over the quad at the end
        l1 = l1 * a1 + rs1;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          o[4 * j] *= a0;
          o[4 * j + 1] *= a0;
          o[4 * j + 2] *= a1;
          o[4 * j + 3] *= a1;
        }

        // O += P V: P from registers in V's type, V MN-major (transposed).
        uint32_t pa[kBN / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) pa[kk][r] = pack2<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        }
        pin(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          mma_pv<T, HD>(o, pa[kk], sw128_desc(vs + kk * 16 * 128, L::kHalfKV / 16));
        wgmma_commit();
        wgmma_wait();
        pin(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar.empty0 + 8 * stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    });
    __syncwarp();  // every wgmma reading this unit's Q has completed
    if (lane == 0) mbar_arrive(bar.qempty0 + 8 * qb);

    if (g == 0 ? bp.active[0] : bp.active[1]) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
      const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
      const long long row_stride = (long long)p.n_q * HD;
      const int sg = g == 0 ? bp.s[0] : bp.s[1];
      T* obase = static_cast<T*>(p.o) + (long long)(bp.b * p.n_s + sg) * p.lq * row_stride + bp.h * HD + cq;
      if (i0 < p.lq) {
        uint32_t* dst = reinterpret_cast<uint32_t*>(obase + i0 * row_stride);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) dst[4 * j] = pack2<T>(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      }
      if (i1 < p.lq) {
        uint32_t* dst = reinterpret_cast<uint32_t*>(obase + i1 * row_stride);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) dst[4 * j] = pack2<T>(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kTcThreads, 1) score_tc_kernel(const __grid_constant__ TcParams p) {
  using L = TcLayout<HD>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  Barriers bar;
  bar.full0 = base + L::kBar;
  bar.empty0 = bar.full0 + 8 * kStages;
  bar.qfull0 = bar.empty0 + 8 * kStages;
  bar.qempty0 = bar.qfull0 + 16;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(bar.full0 + 8 * i, 1);
      mbar_init(bar.empty0 + 8 * i, kConsumers * 4);
    }
    for (int j = 0; j < 2; ++j) {
      mbar_init(bar.qfull0 + 8 * j, 1);
      mbar_init(bar.qempty0 + 8 * j, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Persistent: every block walks units blockIdx.x, + gridDim.x, ...; the
  // producer runs ahead into the next unit's Q and K/V while the consumers
  // finish the current one.
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) produce<HD>(p, base, bar);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume<T, HD>(p, wg, smem, base, bar);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(f)
                                                                       : nullptr;
  }();
  return fn;
}

// A 4-D TMA view [entries, rows, heads, hd] of 16-bit elements, entries
// `entry_stride` elements apart, boxes of 64 columns x box_rows rows.
bool encode_rows(CUtensorMap* map, const void* base, bool bf16, int hd, int heads, int rows, int entries,
                 long long entry_stride, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)rows, (cuuint64_t)entries};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2, (cuuint64_t)entry_stride * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int HD>
cudaError_t launch_score_tc(const ScoreParams& sp, int n_b, cudaStream_t stream) {
  using L = TcLayout<HD>;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  TcParams p;
  memset(&p, 0, sizeof(p));
  p.o = sp.o;
  p.lq = sp.lq;
  p.n_q = sp.n_q;
  p.n_kv = sp.n_kv;
  p.n_s = sp.n_s;
  p.n_pairs = (sp.n_s + kConsumers - 1) / kConsumers;
  p.pair_mode = sp.n_s > 1;
  p.scale = sp.scale;
  p.scale_log2 = sp.scale * kLog2e;
  p.softcap = sp.softcap;
  p.n_src = sp.n_src;
  if (!encode_rows(&p.q_map, sp.q, kBf16, HD, sp.n_q, sp.lq, n_b * sp.n_s, sp.q_stride_bs, kBM))
    return cudaErrorInvalidValue;
  for (int i = 0; i < sp.n_src; ++i) {
    const Source& s = sp.src[i];
    p.src[i] = s;
    const bool per_s = s.stride_s != 0;
    // Per-suffix sources are [B, S, len] slabs: entry b*S + s.
    if (per_s && s.stride_b != s.stride_s * sp.n_s) return cudaErrorInvalidValue;
    if (s.len <= 0) continue;  // no tile is ever loaded from an empty source
    const int entries = per_s ? n_b * sp.n_s : n_b;
    const long long stride = per_s ? s.stride_s : s.stride_b;
    if (!encode_rows(&p.k_map[i], s.k, kBf16, HD, sp.n_kv, s.len, entries, stride, kBN) ||
        !encode_rows(&p.v_map[i], s.v, kBf16, HD, sp.n_kv, s.len, entries, stride, kBN))
      return cudaErrorInvalidValue;
  }
  // Once per template instantiation (thread-safe static init), not per launch.
  static const cudaError_t attr =
      cudaFuncSetAttribute(score_tc_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return attr;
  p.n_qt = p.pair_mode ? (sp.lq + kBM - 1) / kBM : (sp.lq + kConsumers * kBM - 1) / (kConsumers * kBM);
  p.n_units = p.n_qt * sp.n_q * n_b * (p.pair_mode ? p.n_pairs : 1);
  static const int n_sm = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  const dim3 grid(p.n_units < n_sm ? p.n_units : n_sm);
  score_tc_kernel<T, HD><<<grid, kTcThreads, L::kBytes, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Decode kernel: one new token per (batch, suffix), three sources
// ---------------------------------------------------------------------------

struct DecodeParams {
  const void* q;  // [B, S, n_q, HD]
  void* o;        // [B, S, n_q, HD]
  int n_s;
  int n_q;
  int n_kv;
  int n_groups;  // ceil(g / kDecodeGroup) blocks per KV head
  float scale;
  float softcap;
  Source src[3];
};

template <typename T, int HD>
struct DecodeLayout {
  static constexpr int KP = std::is_same<T, float>::value ? HD + 1 : HD + 2;  // odd word pitch
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = align128(kQ + sizeof(float) * kDecodeGroup * HD);
  static constexpr size_t kV = align128(kK + sizeof(T) * kTile * KP);
  static constexpr size_t kS = align128(kV + sizeof(T) * kTile * KP);
  static constexpr size_t kStat = align128(kS + sizeof(float) * kDecodeGroup * kTile);
  static constexpr size_t kBytes = align128(kStat + sizeof(float) * 3 * kDecodeGroup);
};

template <typename T, int HD>
__global__ void __launch_bounds__(HD) decode_kernel(const DecodeParams p) {
  using L = DecodeLayout<T, HD>;
  constexpr int NT = HD;
  constexpr int kWarps = NT / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::kQ);
  T* Ks = reinterpret_cast<T*>(smem + L::kK);
  T* Vs = reinterpret_cast<T*>(smem + L::kV);
  float* Ss = reinterpret_cast<float*>(smem + L::kS);
  float* m_s = reinterpret_cast<float*>(smem + L::kStat);
  float* l_s = m_s + kDecodeGroup;
  float* a_s = l_s + kDecodeGroup;

  const int g = p.n_q / p.n_kv;
  const int kvh = blockIdx.x / p.n_groups;
  const int j0 = (blockIdx.x % p.n_groups) * kDecodeGroup;
  const int gb = min(kDecodeGroup, g - j0);
  const int s = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long qoff = ((long long)b * p.n_s + s) * p.n_q * HD + (long long)(kvh * g + j0) * HD;
  const long long kv_row_stride = (long long)p.n_kv * HD;

  for (int i = tid; i < gb * HD; i += NT) Qs[i] = to_f(static_cast<const T*>(p.q)[qoff + i]);
  if (tid < kDecodeGroup) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kDecodeGroup];
#pragma unroll
  for (int j = 0; j < kDecodeGroup; ++j) acc[j] = 0.f;

  for (int si = 0; si < 3; ++si) {
    const Source src = p.src[si];
    const int limit = source_limit(src, b, s);
    const int n_tiles = (limit + kTile - 1) / kTile;
    const T* kbase = static_cast<const T*>(src.k) + b * src.stride_b + s * src.stride_s + kvh * HD;
    const T* vbase = static_cast<const T*>(src.v) + b * src.stride_b + s * src.stride_s + kvh * HD;
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * kTile;
      __syncthreads();
      load_rows<T, HD, L::KP, NT>(Ks, kbase + k0 * kv_row_stride, kv_row_stride, limit - k0);
      load_rows<T, HD, L::KP, NT>(Vs, vbase + k0 * kv_row_stride, kv_row_stride, limit - k0);
      __syncthreads();

      // Scores for every (query head, key) pair of the tile.
      for (int pair = tid; pair < gb * kTile; pair += NT) {
        const int j = pair / kTile;
        const int c = pair % kTile;
        const float* qj = Qs + j * HD;
        const T* kc = Ks + c * L::KP;
        float a = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) a = fmaf(qj[d], to_f(kc[d]), a);
        Ss[j * kTile + c] = a;
      }
      __syncthreads();

      // Online softmax, one warp per query head; Ss becomes P.
      for (int j = warp; j < gb; j += kWarps) {
        float x[2];
        bool v[2];
        float mx = kNegInf;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = lane + 32 * i;
          v[i] = k0 + c < limit;
          x[i] = v[i] ? cap_score(Ss[j * kTile + c] * p.scale, p.softcap) : kNegInf;
          mx = fmaxf(mx, x[i]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = m_s[j];
        const float m_new = fmaxf(m_old, mx);
        float rs = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float pv = v[i] ? expf(x[i] - m_new) : 0.f;
          rs += pv;
          // P enters the PV product in V's type, as on the TPU.
          Ss[j * kTile + lane + 32 * i] = to_f(from_f<T>(pv));
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          a_s[j] = alpha;
          l_s[j] = l_s[j] * alpha + rs;
          m_s[j] = m_new;
        }
      }
      __syncthreads();

      // acc[j] (this thread's dim) = acc[j] * alpha_j + sum_c P[j][c] V[c][dim].
#pragma unroll
      for (int j = 0; j < kDecodeGroup; ++j) {
        if (j < gb) {
          float a = acc[j] * a_s[j];
          const float* pj = Ss + j * kTile;
#pragma unroll 8
          for (int c = 0; c < kTile; ++c) a = fmaf(pj[c], to_f(Vs[c * L::KP + tid]), a);
          acc[j] = a;
        }
      }
    }
  }
  __syncthreads();
  T* obase = static_cast<T*>(p.o) + qoff;
#pragma unroll
  for (int j = 0; j < kDecodeGroup; ++j) {
    if (j < gb) {
      const float lj = l_s[j];
      obase[j * HD + tid] = from_f<T>(lj > 0.f ? acc[j] / lj : 0.f);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_decode(const DecodeParams& p, int n_b, cudaStream_t stream) {
  using L = DecodeLayout<T, HD>;
  // Once per template instantiation (thread-safe static init), not per launch.
  static const cudaError_t attr = cudaFuncSetAttribute(decode_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (attr != cudaSuccess) return attr;
  dim3 grid(p.n_kv * p.n_groups, p.n_s, n_b);
  decode_kernel<T, HD><<<grid, HD, L::kBytes, stream>>>(p);
  return cudaGetLastError();
}

Source make_source(const void* k, const void* v, long long stride_b, long long stride_s, int len,
                   const int* lim, int lim_sb, int lim_ss, int lim_add, int causal) {
  Source s;
  s.k = k;
  s.v = v;
  s.stride_b = stride_b;
  s.stride_s = stride_s;
  s.len = len;
  s.lim = lim;
  s.lim_sb = lim_sb;
  s.lim_ss = lim_ss;
  s.lim_add = lim_add;
  s.causal = causal;
  return s;
}

template <typename T>
cudaError_t decode_hd(const DecodeParams& p, int hd, int n, cudaStream_t stream) {
  if (hd == 64) return launch_decode<T, 64>(p, n, stream);
  if (hd == 128) return launch_decode<T, 128>(p, n, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32 (score_kernel_f32), 1 float16 and 2 bfloat16
// (score_tc_kernel).
//
// q, o: [B, S, lq, n_q, hd] contiguous (the causal form passes S = 1).
// Source i: K and V rows of n_kv*hd elements at k_i + b*sb_i + s*ss_i, len_i
// rows; limit lim_i[b*lsb_i + s*lss_i] + ladd_i (ladd_i alone when lim_i is
// null); causal_i masks keys past the query's row index. A source with
// ss_i != 0 is a stack of [B, S, len_i] slabs (sb_i == n_s * ss_i).
extern "C" int fls_score_attention(
    int dtype, int hd, const void* q, void* o, int n_b, int n_s, int lq, int n_q, int n_kv,
    float scale, float softcap, int n_src,
    const void* k0, const void* v0, long long sb0, long long ss0, int len0,
    const void* lim0, int lsb0, int lss0, int ladd0, int causal0,
    const void* k1, const void* v1, long long sb1, long long ss1, int len1,
    const void* lim1, int lsb1, int lss1, int ladd1, int causal1,
    void* stream) {
  ScoreParams p;
  p.q = q;
  p.o = o;
  p.q_stride_bs = (long long)lq * n_q * hd;
  p.lq = lq;
  p.n_q = n_q;
  p.n_kv = n_kv;
  p.n_s = n_s;
  p.scale = scale;
  p.softcap = softcap;
  p.n_src = n_src;
  p.src[0] = make_source(k0, v0, sb0, ss0, len0, static_cast<const int*>(lim0), lsb0, lss0, ladd0, causal0);
  p.src[1] = make_source(k1, v1, sb1, ss1, len1, static_cast<const int*>(lim1), lsb1, lss1, ladd1, causal1);
  if (lq <= 0 || n_b * n_s <= 0) return (int)cudaSuccess;
  if (hd != 64 && hd != 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = hd == 64 ? launch_score_f32<64>(p, n_b * n_s, st) : launch_score_f32<128>(p, n_b * n_s, st);
  else if (dtype == 1) err = hd == 64 ? launch_score_tc<__half, 64>(p, n_b, st) : launch_score_tc<__half, 128>(p, n_b, st);
  else if (dtype == 2) err = hd == 64 ? launch_score_tc<__nv_bfloat16, 64>(p, n_b, st) : launch_score_tc<__nv_bfloat16, 128>(p, n_b, st);
  else err = cudaErrorInvalidValue;
  return (int)err;
}

// q, o: [B, S, n_q, hd]. Sources: 0 the shared prefix (limit prefix_len[b]),
// 1 the suffix's own KV (limit suffix_eos[b, s] + 1), 2 the generated KV
// (limit t + 1); layout as for fls_score_attention.
extern "C" int fls_decode_attention(
    int dtype, int hd, const void* q, void* o, int n_b, int n_s, int n_q, int n_kv,
    float scale, float softcap,
    const void* kp, const void* vp, long long p_sb, int lp, const void* prefix_len,
    const void* ks, const void* vs, long long s_sb, long long s_ss, int ls, const void* suffix_eos,
    const void* kg, const void* vg, long long g_sb, long long g_ss, int tg, int t,
    void* stream) {
  DecodeParams p;
  const int g = n_q / n_kv;
  p.q = q;
  p.o = o;
  p.n_s = n_s;
  p.n_q = n_q;
  p.n_kv = n_kv;
  p.n_groups = (g + kDecodeGroup - 1) / kDecodeGroup;
  p.scale = scale;
  p.softcap = softcap;
  p.src[0] = make_source(kp, vp, p_sb, 0, lp, static_cast<const int*>(prefix_len), 1, 0, 0, 0);
  p.src[1] = make_source(ks, vs, s_sb, s_ss, ls, static_cast<const int*>(suffix_eos), n_s, 1, 1, 0);
  p.src[2] = make_source(kg, vg, g_sb, g_ss, tg, nullptr, 0, 0, t + 1, 0);
  if (n_b * n_s <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = decode_hd<float>(p, hd, n_b, st);
  else if (dtype == 1) err = decode_hd<__half>(p, hd, n_b, st);
  else if (dtype == 2) err = decode_hd<__nv_bfloat16>(p, hd, n_b, st);
  else err = cudaErrorInvalidValue;
  return (int)err;
}
