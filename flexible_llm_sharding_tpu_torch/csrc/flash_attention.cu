// Hopper (sm_90a) attention kernels for the layer-streamed scorer.
//
// Kernels and the Pallas TPU kernels of
// flexible_llm_sharding_tpu/ops/pallas_attention.py they replace:
//
//   score_tc_kernel (bf16/fp16), one KV source   <- flash_causal_attention
//                                                   (_causal_kernel)
//   score_tc_kernel (bf16/fp16), two KV sources  <- flash_prefix_shared_attention
//                                                   (_prefix_shared_kernel)
//   decode_rows_kernel (all dtypes)              <- flash_decode_attention
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
//   cost 2*(hd + hd_v) FLOPs per visible (query, key) pair (4*hd where V's
//   head dim is Q's); the bytes that must move are 2*(hd + hd_v) per query
//   row (Q in, O out) and per key row (K and V, read once). The H100 does 295 bf16 FLOPs per byte, so the products bound the
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
//   - Tiles past the limit and above the diagonal are never loaded, and
//     neither are tiles wholly below a sliding window or position chunk
//     (see "Local attention" below).
// * Decode. One new token per suffix: 4*hd FLOPs per visible key against
//   4*hd bytes of K and V (bf16), about one FLOP per byte, so on the H100
//   (295 bf16 FLOPs per byte of HBM) it is bound by the bytes of the KV it
//   reads, and most of those are the shared prefix. The design reads each
//   byte once and keeps loads in flight:
//   - One block per (prompt, KV head, chunk of <= kDecodeRows query rows).
//     A block's rows are the (suffix, query head) pairs of its KV head,
//     suffix-major, so every suffix of a prompt and every query head of a
//     GQA group shares one read of each prefix tile. Only where S*g exceeds
//     kDecodeRows does the prefix go through several blocks (one per chunk).
//   - The block walks one flat list of 64-key tiles: the prefix tiles up to
//     prefix_len (updating every row), then per suffix its own tiles up to
//     eos + 1 and its generated tiles up to t + 1 (updating that suffix's
//     rows only). A cp.async ring of kStages stages runs along that list,
//     so the next source's first tile is in flight while the current one's
//     last tile is computed. Rows at or past a source's limit are
//     zero-filled by the copy itself (src-size 0): NaN there never reaches
//     PV, and rows past the tensor's end are never addressed. K/V rows are
//     stored unpadded with 16-byte chunks XOR-swizzled by the row, so the
//     reads below hit distinct banks.
//   - Products: bf16/fp16 on the tensor cores with mma.sync m16n8k16, the
//     block's rows padded to one m16 tile (with FMA the products, not the
//     loads, set the time). Each warp takes 16 keys of a tile: Q stays in
//     registers, K and V come by ldmatrix, the scores stay in registers and
//     become PV's A fragment; the warps exchange only each tile's row maxima
//     and sum their l and O at the end. Float32 (the cross-check's path)
//     keeps FMA products, which the tensor cores would round to TF32. The
//     key-limit mask runs only on a source's last tile.
//   - No split-KV: at the main path's shapes B*n_kv = 256 blocks already
//     fill the 132 SMs (two resident per SM). It pays only where B*n_kv is
//     small against the SM count (one prompt with a long prefix), and needs
//     a combine pass.
// * Local attention (the TPU kernels' window, chunk and local_on; local_on
//   is resolved on the host and arrives as window = chunk = 0). Every key a
//   query sees without the local clause sits at an absolute position <= the
//   query's own (causal j <= i; a prefix key below prefix_len <= the suffix
//   query's prefix_len + i; an own or generated key at or before the
//   query), so the clause "q - k < window" or "q and k share a chunk" is one
//   per-query lower bound on the key position: lo(q) = q - window + 1, or
//   the start of q's chunk. Each source carries the absolute position of its
//   key 0 and the query its own; a block starts each source at the tile
//   holding the smallest lo of its rows, and tests the bound per row only on
//   tiles that start below the largest. The bound grows with the query
//   position, so only the tiles between a block's smallest and largest
//   bound need the test: at most two per consumer in the scoring kernel.
//   Both kernels are built with and without the bound (template kLocal)
//   and launched without it when no window or chunk is set, so a global
//   layer or a model without local layers runs no local code.
//
// * Head dims 64, 96, 128 and 256 (the TPU kernels take any head dim of at
//   least 64, zero-padded to a multiple of 128). Each kernel is built at 64,
//   128 and 256 (float32 scoring also at 96). Head dim 96 runs in the
//   hd-128 instantiation on the unpadded tensors: the scoring kernel's
//   tensor maps are 96 columns wide and TMA writes zeros past them, the
//   decode kernel's copies zero-fill the chunks past column 96, and both
//   write 96 columns. Zero columns add nothing to QK^T and give zero output
//   columns, so this is exact, and no padded copy of the cache is made. At
//   256 a 64-key K/V tile of 16-bit elements is 64 KB: the scoring kernel
//   keeps one Q buffer and two ring stages (197,680 B of shared memory,
//   what four stages and two Q buffers take at 128), and O, 128 fp32
//   registers per consumer thread, is accumulated by two n128 wgmma halves
//   (Q's descriptors are rebuilt per tile, not held); the decode kernel keeps
//   three stages (one block per SM instead of two) and reads Q's fragments
//   from shared memory per tile instead of holding them; the float32
//   kernels take K and V in turn through one buffer (scoring) or run one
//   stage (decode).
//
// * Multi-head latent attention (DeepSeek-V3's qk 192 = nope 128 + rope 64,
//   v 128; the TPU kernels pad Q/K and V separately and return v_dim
//   columns). The scoring kernels are templated on Q/K's head dim HD and
//   V's HDV, built at (192, 128) besides the equal pairs: QK^T runs 12 k16
//   steps over three 64-column pieces of Q and K, PV and O stay at 128
//   columns (64 fp32 registers per consumer thread, as at hd 128), and V
//   moves at its own width instead of being padded to 192 (which would add
//   half again to PV, O's registers and V's bytes). A TMA stage is K 24 KB
//   + V 16 KB; two Q buffers and three stages take 222,288 B. Float32
//   scoring keeps K and V apart (198,144 B). Decode never takes MLA: the
//   JAX package runs MLA decode on its plain op, and so does the port.
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
// For the local bound, key j sits at absolute position j, plus the batch
// entry's query offset (pos[b] of the scoring kernel) when shift is set.
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
  int shift;
};

__device__ __forceinline__ int source_limit(const Source& src, int b, int s) {
  int lim = src.lim ? src.lim[b * src.lim_sb + s * src.lim_ss] + src.lim_add : src.lim_add;
  return max(0, min(lim, src.len));
}

// The first absolute key position a query at absolute position qpos may see
// under a sliding window (qpos - window + 1) or a position chunk (the start
// of qpos's chunk); 0, which bounds nothing, when neither is set.
__device__ __forceinline__ int local_lo(int qpos, int window, int chunk) {
  if (window > 0) return qpos - window + 1;
  if (chunk > 0) return qpos / chunk * chunk;
  return 0;
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
  long long q_stride_bs;  // elements per (b, s) slab of q
  long long o_stride_bs;  // elements per (b, s) slab of o
  int hd;                 // the tensors' Q/K head dim (the instantiation's, or 96 in the hd-128 one)
  int hd_v;               // V's and O's head dim: hd, or 128 at MLA's hd 192
  int lq;
  int n_q;
  int n_kv;
  int n_s;
  float scale;
  float softcap;
  int window;      // sliding window, 0 = off
  int chunk;       // position chunk, 0 = off
  const int* pos;  // query row i of batch entry b sits at pos[b] + i (null: i)
  int n_src;
  Source src[2];
};

// ---------------------------------------------------------------------------
// Float32 scoring kernel: a 64-query tile of one head, FMA products (the
// tensor cores would round float32 inputs to TF32)
// ---------------------------------------------------------------------------

template <int HD, int HDV = HD>
struct F32Layout {
  static constexpr int QP = HD + 1;     // Q/K pitch (V's too in the hd x hd layouts)
  static constexpr int VP = HDV + 1;    // V pitch
  static constexpr int SP = kTile + 1;  // scores and P pitch
  static constexpr int OP = HDV + 1;    // O pitch
  // At hd 256 Q, K, V and O tiles of 64 rows would take 263 KB: K and V
  // then take turns in one buffer (230,656 B in all). MLA's (192, 128)
  // fits them apart (198,144 B).
  static constexpr bool kOneKV = HDV > 128;
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = align128(kQ + sizeof(float) * kTile * QP);
  static constexpr size_t kV = kOneKV ? kK : align128(kK + sizeof(float) * kTile * QP);
  static constexpr size_t kS = align128(kV + sizeof(float) * kTile * (kOneKV && QP > VP ? QP : VP));
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

// Q/K head dim HD, V/O head dim HDV.
template <int HD, int HDV>
// One block per SM is enough (shared memory allows 1-2): without the hint
// ptxas trades a spill at hd 256 for registers it does not need.
__global__ void __launch_bounds__(kScoreThreads, 1) score_kernel_f32(const ScoreParams p) {
  using L = F32Layout<HD, HDV>;
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
  const long long o_row_stride = (long long)p.n_q * HDV;
  const long long kv_row_stride = (long long)p.n_kv * HD;
  const long long v_row_stride = (long long)p.n_kv * HDV;

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
  const int qoff = p.pos ? p.pos[b] : 0;
  const int lo_first = local_lo(qoff + q0, p.window, p.chunk);  // the tile's smallest bound
  const int lo_row = local_lo(qoff + qi, p.window, p.chunk);
  float m = kNegInf;
  float l = 0.f;

  for (int si = 0; si < p.n_src; ++si) {
    const Source src = p.src[si];
    const int limit = source_limit(src, b, s);
    const int off = src.shift ? qoff : 0;  // absolute position of key 0
    int n_tiles = (limit + kTile - 1) / kTile;
    if (src.causal) n_tiles = min(n_tiles, (q0 + q_rows + kTile - 1) / kTile);
    const float* kbase = static_cast<const float*>(src.k) + b * src.stride_b + s * src.stride_s + kvh * HD;
    // The source's strides are K's; V's rows are HDV elements per head.
    const long long v_off = HD == HDV ? b * src.stride_b + s * src.stride_s
                                      : (b * src.stride_b + s * src.stride_s) / HD * HDV;
    const float* vbase = static_cast<const float*>(src.v) + v_off + kvh * HDV;
    const int t0 = lo_first - off >= limit ? n_tiles : max(lo_first - off, 0) / kTile;
    for (int t = t0; t < n_tiles; ++t) {
      const int k0 = t * kTile;
      __syncthreads();  // the previous tile's K/V are no longer read
      load_rows<float, HD, L::QP, kScoreThreads>(Ks, kbase + k0 * kv_row_stride, kv_row_stride, limit - k0);
      if constexpr (!L::kOneKV)
        load_rows<float, HDV, L::VP, kScoreThreads>(Vs, vbase + k0 * v_row_stride, v_row_stride, limit - k0);
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
        const bool v = kj < limit && (!src.causal || kj <= qi) && off + kj >= lo_row;
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
      for (int d = half * (HDV / 2); d < (half + 1) * (HDV / 2); ++d) Os[row * L::OP + d] *= alpha;
      __syncwarp();
      if constexpr (L::kOneKV) {
        __syncthreads();  // every warp's scores have read K
        load_rows<float, HDV, L::VP, kScoreThreads>(Vs, vbase + k0 * v_row_stride, v_row_stride, limit - k0);
        __syncthreads();
      }

      warp_pv<HDV>(Ps, Vs, Os, warp, lane);
      __syncwarp();
    }
  }

  __syncthreads();  // O was zeroed by other threads when no tile ran
  if (qi < p.lq) {
    float* obase = static_cast<float*>(p.o) + bs * p.o_stride_bs + qi * o_row_stride + h * HDV;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    for (int d = half * (HDV / 2); d < (half + 1) * (HDV / 2); ++d) obase[d] = Os[row * L::OP + d] * inv;
  }
}

template <int HD, int HDV = HD>
cudaError_t launch_score_f32(const ScoreParams& p, int n_bs, cudaStream_t stream) {
  using L = F32Layout<HD, HDV>;
  // Once per template instantiation (thread-safe static init), not per launch.
  static const cudaError_t attr = cudaFuncSetAttribute(score_kernel_f32<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (attr != cudaSuccess) return attr;
  dim3 grid((p.lq + kTile - 1) / kTile, p.n_q, n_bs);
  score_kernel_f32<HD, HDV><<<grid, kScoreThreads, L::kBytes, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16/fp16 scoring kernel: TMA-fed K/V ring, wgmma products, softmax and O
// in registers, one K/V load for two consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int kBM = 64;                             // query rows per consumer warpgroup
constexpr int kBN = 64;                             // keys per K/V tile
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
  int hd;  // the tensors' Q/K head dim: HD, or 96 in the hd-128 instantiation
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
  int window;
  int chunk;
  const int* pos;
  int n_src;
  Source src[2];
  int hd_v;  // V's and O's head dim: hd, or 128 at MLA's hd 192 (read only there)
};

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle's
// period): kQBufs Q buffers (two: one per unit in flight) of one tile per
// consumer, then the kStages K/V stages, then the barriers. A tile of hd
// columns is stored as hd/64 column pieces of rows x 128 bytes. At hd 256 a
// stage is 64 KB, so one Q buffer and two stages fit (the producer loads a
// unit's Q once the previous unit is done with it). At MLA's (192, 128) a
// Q tile is 24 KB and a stage 40 KB (K 24, V 16): two Q buffers and three
// stages (222,288 B).
template <int HD, int HDV = HD>
struct TcLayout {
  static constexpr int kHalves = HD / 64;    // column pieces of Q and K
  static constexpr int kHalvesV = HDV / 64;  // of V
  static constexpr int kHalfQ = kBM * 128;
  static constexpr int kHalfKV = kBN * 128;
  static constexpr int kQBytes = kHalves * kHalfQ;
  static constexpr int kKBytes = kHalves * kHalfKV;
  static constexpr int kStageBytes = kKBytes + kHalvesV * kHalfKV;  // K then V
  static constexpr int kQBufs = HDV > 128 ? 1 : 2;
  static constexpr int kStages = HD <= 128 ? 4 : HDV <= 128 ? 3 : 2;
  static constexpr int kQ = 0;
  static constexpr int kStage0 = kQBufs * kConsumers * kQBytes;
  static constexpr int kBar = kStage0 + kStages * kStageBytes;
  static constexpr int kBytes = kBar + (2 * kStages + 2 * kQBufs) * 8 + 1024;  // + alignment slack
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

template <typename T>
__device__ __forceinline__ void mma_pv128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) wgmma_pv128_bf16(d, a, db, 1);
  else wgmma_pv128_f16(d, a, db, 1);
}

// O += P V for an HDV-column O. At 256: two n128 products, on the two
// halves of O's registers (columns 0-127 and 128-255, in the accumulator
// order of one n256 product) and of V's column pieces (two pieces, 2 *
// kBN * 128 bytes, further on; the descriptor counts 16-byte units).
template <typename T, int HDV>
__device__ __forceinline__ void mma_pv(float (&d)[HDV / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HDV == 64) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) wgmma_pv64_bf16(d, a, db, 1);
    else wgmma_pv64_f16(d, a, db, 1);
  } else if constexpr (HDV == 128) {
    mma_pv128<T>(d, a, db);
  } else {
    static_assert(HDV == 256, "V head dims 64, 128 and 256");
    float(&halves)[2][64] = reinterpret_cast<float(&)[2][64]>(d);
    mma_pv128<T>(halves[0], a, db);
    mma_pv128<T>(halves[1], a, db + ((2 * kBN * 128) >> 4));
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
// its suffix and whether it has any rows at all; query row i sits at
// absolute position qoff + i.
struct BlockPos {
  int b;
  int h;
  int kvh;
  int qoff;
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
  bp.qoff = p.pos ? p.pos[bp.b] : 0;
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
// key limit, its tiles [t0, nt) and the local bound of its last query row
// as a key index of this source (edge: a tile starting below it holds a key
// some row of the consumer may not see); off is the absolute position of
// key 0. A consumer without rows has no tiles (t0 past every tile).
struct SrcPlan {
  int entry[kConsumers];
  int limit[kConsumers];
  int t0[kConsumers];
  int nt[kConsumers];
  int edge[kConsumers];
  int off;
};

constexpr int kNoTile = 1 << 30;

template <bool kLocal>
__device__ __forceinline__ SrcPlan plan_source(const TcParams& p, const BlockPos& bp, int si) {
  const Source& src = p.src[si];
  SrcPlan sp;
  sp.off = src.shift ? bp.qoff : 0;
#pragma unroll
  for (int g = 0; g < kConsumers; ++g) {
    sp.entry[g] = src.stride_s ? bp.b * p.n_s + bp.s[g] : bp.b;
    sp.limit[g] = 0;
    sp.t0[g] = kNoTile;
    sp.nt[g] = 0;
    sp.edge[g] = 0;
    if (!bp.active[g]) continue;
    const int lim = source_limit(src, bp.b, bp.s[g]);
    const int last = min(bp.qa[g] + kBM, p.lq) - 1;
    int nt = (lim + kBN - 1) / kBN;
    if (src.causal) nt = min(nt, last / kBN + 1);
    sp.limit[g] = lim;
    sp.t0[g] = 0;
    sp.nt[g] = nt;
    if constexpr (kLocal) {
      // The bound grows with the row: the first row's bound gives the first
      // tile any row can use, the last row's the end of the tiles to test.
      const int lo = local_lo(bp.qoff + bp.qa[g], p.window, p.chunk) - sp.off;
      sp.t0[g] = lo >= lim ? nt : min(max(lo, 0) / kBN, nt);  // no tile when no key is visible
      sp.edge[g] = local_lo(bp.qoff + last, p.window, p.chunk) - sp.off;
    }
  }
  return sp;
}

// The ring's items, in the order the producer loads them and the consumers
// take them: per source, tiles both consumers share once (same batch entry:
// the causal form, the shared prefix) from the smaller of their first
// tiles, else each consumer's own tiles. f(si, plan, entry, t, used_by_0,
// used_by_1). Without a local form every walk starts at tile 0.
template <bool kLocal, class F>
__device__ __forceinline__ void walk_items(const TcParams& p, const BlockPos& bp, F&& f) {
  for (int si = 0; si < p.n_src; ++si) {
    const SrcPlan sp = plan_source<kLocal>(p, bp, si);
    const int a0 = kLocal ? sp.t0[0] : 0;
    const int a1 = kLocal ? sp.t0[1] : 0;
    if (sp.entry[0] == sp.entry[1]) {
      const int n = max(sp.nt[0], sp.nt[1]);
      for (int t = min(a0, a1); t < n; ++t)
        f(si, sp, sp.entry[0], t, t >= a0 && t < sp.nt[0], t >= a1 && t < sp.nt[1]);
    } else {
      for (int t = a0; t < sp.nt[0]; ++t) f(si, sp, sp.entry[0], t, true, false);
      for (int t = a1; t < sp.nt[1]; ++t) f(si, sp, sp.entry[1], t, false, true);
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
template <int HD, int HDV, bool kLocal>
__device__ __forceinline__ void produce(const TcParams& p, uint32_t base, const Barriers& bar) {
  using L = TcLayout<HD, HDV>;
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x, n = 0; u < p.n_units; u += gridDim.x, ++n) {
    const BlockPos bp = unit_pos(p, u);
    const int qb = n % L::kQBufs;
    mbar_wait(bar.qempty0 + 8 * qb, ((n / L::kQBufs) & 1) ^ 1);
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
    walk_items<kLocal>(p, bp, [&](int si, const SrcPlan&, int entry, int t, bool, bool) {
      mbar_wait(bar.empty0 + 8 * stage, phase ^ 1);
      const uint32_t full = bar.full0 + 8 * stage;
      mbar_expect_tx(full, L::kStageBytes);
      const uint32_t ks = base + L::kStage0 + stage * L::kStageBytes;
#pragma unroll
      for (int hh = 0; hh < L::kHalves; ++hh) {
        tma_load(ks + hh * L::kHalfKV, &p.k_map[si], full, hh * 64, bp.kvh, t * kBN, entry);
        if (hh < L::kHalvesV)
          tma_load(ks + L::kKBytes + hh * L::kHalfKV, &p.v_map[si], full, hh * 64, bp.kvh, t * kBN, entry);
      }
      if (++stage == L::kStages) {
        stage = 0;
        phase ^= 1;
      }
    });
  }
}

// Consumer warpgroup g: per unit, its 64 query rows against every item of
// the ring (computing on the items it uses, releasing all of them).
template <typename T, int HD, int HDV, bool kLocal>
__device__ __forceinline__ void consume(const TcParams& p, const int g, uint8_t* smem, uint32_t base,
                                        const Barriers& bar) {
  using L = TcLayout<HD, HDV>;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int cq = 2 * (lane % 4);              // its first column in every 8-column block
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x, n = 0; u < p.n_units; u += gridDim.x, ++n) {
    const BlockPos bp = unit_pos(p, u);
    const int qb = n % L::kQBufs;
    const int qa = g == 0 ? bp.qa[0] : bp.qa[1];
    const int i0 = qa + r0;
    const int i1 = i0 + 8;
    const int lo0 = kLocal ? local_lo(bp.qoff + i0, p.window, p.chunk) : 0;  // rows i0, i1: first visible keys
    const int lo1 = kLocal ? local_lo(bp.qoff + i1, p.window, p.chunk) : 0;
    const uint32_t qs = base + L::kQ + (qb * kConsumers + g) * L::kQBytes;

    float o[HDV / 2];
#pragma unroll
    for (int i = 0; i < HDV / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    mbar_wait(bar.qfull0 + 8 * qb, (n / L::kQBufs) & 1);
    walk_items<kLocal>(p, bp, [&](int si, const SrcPlan& sp, int, int t, bool use0, bool use1) {
      mbar_wait(bar.full0 + 8 * stage, phase);
      if (g == 0 ? use0 : use1) {
        const int limit = g == 0 ? sp.limit[0] : sp.limit[1];
        const int causal = p.src[si].causal;
        const int k0 = t * kBN;
        const uint32_t ks = base + L::kStage0 + stage * L::kStageBytes;
        const uint32_t vs = ks + L::kKBytes;
        if (k0 + kBN > limit) {
          // Rows past the limit hold whatever the tensor has there: zero
          // them in V (both consumers may write the same zeros).
          const int rz = max(limit - k0, 0);
          const int chunks = (kBN - rz) * 8;  // 16-byte chunks per column half
          for (int c = tid; c < chunks * L::kHalvesV; c += 128) {
            const int hh = c / chunks;
            const int r = rz + (c % chunks) / 8;
            *reinterpret_cast<uint4*>(smem + (vs - base) + hh * L::kHalfKV + r * 128 + (c % 8) * 16) =
                make_uint4(0u, 0u, 0u, 0u);
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile("bar.sync %0, 128;\n" :: "r"(1 + g) : "memory");
        }

        // S = Q K^T, both K-major from shared memory. Above hd 128 the Q
        // buffer's address passes an empty asm on every tile, so its 12 or
        // 16 descriptors are built per tile: hoisted out of the walk they
        // would hold 24-32 registers and spill at hd 256 (O alone takes 128
        // there).
        uint32_t qsv = qs;
        if constexpr (HD > 128) asm volatile("" : "+r"(qsv));
        float s[kBN / 2];
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;
        pin(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          mma_qk<T>(s, sw128_desc(qsv + (kk / 4) * L::kHalfQ + off, 1),
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
        // One branch picks a masked or an unmasked tile, around the mask
        // only (ptxas serialises wgmma under data-dependent branches).
        if (k0 + kBN > limit || (causal && k0 + kBN - 1 > qa) ||
            (kLocal && k0 < (g == 0 ? sp.edge[0] : sp.edge[1]))) {
          const int lk0 = lo0 - sp.off;  // the rows' bounds as key indices of this source
          const int lk1 = lo1 - sp.off;
#pragma unroll
          for (int i = 0; i < kBN / 2; ++i) {
            const int kj = k0 + 8 * (i / 4) + cq + (i & 1);
            const int qi = (i & 2) ? i1 : i0;
            if (!(kj < limit && (!causal || kj <= qi) && (!kLocal || kj >= ((i & 2) ? lk1 : lk0))))
              s[i] = -INFINITY;
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
        for (int j = 0; j < HDV / 8; ++j) {
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
          mma_pv<T, HDV>(o, pa[kk], sw128_desc(vs + kk * 16 * 128, L::kHalfKV / 16));
        wgmma_commit();
        wgmma_wait();
        pin(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar.empty0 + 8 * stage);
      if (++stage == L::kStages) {
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
      // The tensors' O columns (96 of the hd-128 instantiation's 128: the
      // rest are zero).
      const int hd_o = HD == HDV ? p.hd : p.hd_v;
      const long long row_stride = (long long)p.n_q * hd_o;
      const int sg = g == 0 ? bp.s[0] : bp.s[1];
      T* obase = static_cast<T*>(p.o) + (long long)(bp.b * p.n_s + sg) * p.lq * row_stride + bp.h * hd_o + cq;
      if (i0 < p.lq) {
        uint32_t* dst = reinterpret_cast<uint32_t*>(obase + i0 * row_stride);
#pragma unroll
        for (int j = 0; j < HDV / 8; ++j)
          if (8 * j < hd_o) dst[4 * j] = pack2<T>(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      }
      if (i1 < p.lq) {
        uint32_t* dst = reinterpret_cast<uint32_t*>(obase + i1 * row_stride);
#pragma unroll
        for (int j = 0; j < HDV / 8; ++j)
          if (8 * j < hd_o) dst[4 * j] = pack2<T>(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
    }
  }
}

// Q/K head dim HD, V/O head dim HDV. kLocal: a window or chunk is set
// (without one the kernel carries no local-bound code at all).
template <typename T, int HD, int HDV, bool kLocal>
__global__ void __launch_bounds__(kTcThreads, 1) score_tc_kernel(const __grid_constant__ TcParams p) {
  using L = TcLayout<HD, HDV>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  Barriers bar;
  bar.full0 = base + L::kBar;
  bar.empty0 = bar.full0 + 8 * L::kStages;
  bar.qfull0 = bar.empty0 + 8 * L::kStages;
  bar.qempty0 = bar.qfull0 + 8 * L::kQBufs;
  if (threadIdx.x == 0) {
    for (int i = 0; i < L::kStages; ++i) {
      mbar_init(bar.full0 + 8 * i, 1);
      mbar_init(bar.empty0 + 8 * i, kConsumers * 4);
    }
    for (int j = 0; j < L::kQBufs; ++j) {
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
    if (threadIdx.x == kConsumers * 128) produce<HD, HDV, kLocal>(p, base, bar);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume<T, HD, HDV, kLocal>(p, wg, smem, base, bar);
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

template <typename T, int HD, int HDV = HD>
cudaError_t launch_score_tc(const ScoreParams& sp, int n_b, cudaStream_t stream) {
  using L = TcLayout<HD, HDV>;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  TcParams p;
  memset(&p, 0, sizeof(p));
  p.o = sp.o;
  p.hd = sp.hd;
  p.hd_v = sp.hd_v;
  p.lq = sp.lq;
  p.n_q = sp.n_q;
  p.n_kv = sp.n_kv;
  p.n_s = sp.n_s;
  p.n_pairs = (sp.n_s + kConsumers - 1) / kConsumers;
  p.pair_mode = sp.n_s > 1;
  p.scale = sp.scale;
  p.scale_log2 = sp.scale * kLog2e;
  p.softcap = sp.softcap;
  p.window = sp.window;
  p.chunk = sp.chunk;
  p.pos = sp.pos;
  p.n_src = sp.n_src;
  // The maps span the tensors' sp.hd columns; boxes past them (columns 96-127
  // at hd 96) arrive as zeros.
  if (!encode_rows(&p.q_map, sp.q, kBf16, sp.hd, sp.n_q, sp.lq, n_b * sp.n_s, sp.q_stride_bs, kBM))
    return cudaErrorInvalidValue;
  for (int i = 0; i < sp.n_src; ++i) {
    const Source& s = sp.src[i];
    p.src[i] = s;
    const bool per_s = s.stride_s != 0;
    // Per-suffix sources are [B, S, len] slabs: entry b*S + s.
    if (per_s && s.stride_b != s.stride_s * sp.n_s) return cudaErrorInvalidValue;
    if (s.len <= 0) continue;  // no tile is ever loaded from an empty source
    const int entries = per_s ? n_b * sp.n_s : n_b;
    const long long stride = per_s ? s.stride_s : s.stride_b;  // K's; V's rows are hd_v wide
    if (stride % sp.hd) return cudaErrorInvalidValue;
    if (!encode_rows(&p.k_map[i], s.k, kBf16, sp.hd, sp.n_kv, s.len, entries, stride, kBN) ||
        !encode_rows(&p.v_map[i], s.v, kBf16, sp.hd_v, sp.n_kv, s.len, entries, stride / sp.hd * sp.hd_v,
                     kBN))
      return cudaErrorInvalidValue;
  }
  // Once per template instantiation (thread-safe static init), not per launch.
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(score_tc_kernel<T, HD, HDV, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(score_tc_kernel<T, HD, HDV, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kBytes);
    return e;
  }();
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
  if (p.window > 0 || p.chunk > 0) score_tc_kernel<T, HD, HDV, true><<<grid, kTcThreads, L::kBytes, stream>>>(p);
  else score_tc_kernel<T, HD, HDV, false><<<grid, kTcThreads, L::kBytes, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Decode kernel: one new token per suffix over three KV sources; one block
// per (prompt, KV head, chunk of query rows), a cp.async K/V ring
// ---------------------------------------------------------------------------

constexpr int kDecodeRows = 16;                    // query rows (suffix, query head) per block
constexpr int kDecodeThreads = 128;                // 4 warps; warp w owns keys 16w..16w+15 of a tile
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr int kDecodeSegs = 1 + 2 * kDecodeRows;  // the prefix, then own and generated KV per suffix

struct DecodeParams {
  const void* q;  // [B, S, n_q, hd]
  void* o;        // [B, S, n_q, hd]
  int hd;         // the tensors' head dim: HD, or 96 in the hd-128 instantiation
  int n_s;
  int n_q;
  int n_kv;
  int n_chunks;  // blocks per (prompt, KV head): ceil(S * g / kDecodeRows)
  float scale;
  float softcap;
  int window;  // sliding window, 0 = off
  int chunk;   // position chunk, 0 = off
  int t;       // the generated slot of this step's token
  Source src[3];  // prefix, own suffix, generated
};

// The block's rows: query rows r0 .. r0 + nrow - 1 of KV head kvh of prompt
// b, where query row r is suffix r / g, query head kvh * g + r % g.
struct DecodeBlock {
  int b;
  int kvh;
  int g;
  int r0;
  int nrow;
  int n_s;
  int n_q;
  int n_seg;
  int hd;                // the tensors' head dim
  long long row_stride;  // K/V elements between consecutive keys

  // Element offset of block row i in q and o (head dim hd).
  __device__ __forceinline__ long long row_offset(int i, int hd) const {
    const int r = r0 + i;
    return ((long long)(b * n_s + r / g) * n_q + kvh * g + r % g) * hd;
  }
};

// One stretch of a block's walk: the tiles t0 .. of keys [0, limit) of one
// source for one suffix (for the prefix, of the prompt), updating the
// block's rows [ra, rb). Key j sits at absolute position pos0 + j; t0 is
// the tile holding the smallest local bound of those rows.
struct DecodeSeg {
  const void* k;  // key 0 of the stretch at the block's KV head
  const void* v;
  int limit;
  int ra;
  int rb;
  int t0;
  int pos0;
};

// Shared memory: the K/V ring, then the path's scratch (float32: Q rows in
// fp32, scores/P, per-row m, l and alpha; 16-bit: Q rows in T, kQPitch
// apart, and per-warp row maxima, double-buffered), then the walk's
// stretches, then each row's local bound (the first absolute key position
// it may see). At hd 256 a float32 stage is 128 KB, so that path runs one
// stage, and the 16-bit path's Q rows are padded by 16 bytes so that its
// ldmatrix reads of them hit distinct banks.
template <typename T, int HD>
struct DecodeLayout {
  static constexpr int kRowBytes = HD * (int)sizeof(T);  // one K or V row, unpadded
  static constexpr int kChunks = kRowBytes / 16;         // 16-byte chunks per row
  static constexpr int kElems = 16 / (int)sizeof(T);     // elements per chunk
  static constexpr int kStages = sizeof(T) == 4 ? (HD > 128 ? 1 : 2) : 3;
  static constexpr int kQPitch = HD > 128 ? HD + kElems : HD;  // 16-bit Q rows
  // Blocks per SM that ptxas may assume: float32 two (without the hint it
  // spills at hd 64 to save registers it does not need); 16-bit three up to
  // hd 128 (168 registers, what it takes there), one at 256 (254 registers).
  static constexpr int kMinBlocks = sizeof(T) == 4 ? 2 : (HD > 128 ? 1 : 3);
  static constexpr int kTileBytes = kTile * kRowBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;  // K then V
  static constexpr size_t kRing = (size_t)kStages * kStageBytes;
  static constexpr size_t kScratch = sizeof(T) == 4
      ? sizeof(float) * kDecodeRows * (HD + kTile + 3)
      : sizeof(T) * kDecodeRows * kQPitch + sizeof(float) * 2 * kDecodeWarps * kDecodeRows;
  static constexpr size_t kSeg = align128(kRing + kScratch);
  static constexpr size_t kLo = kSeg + sizeof(DecodeSeg) * kDecodeSegs;
  static constexpr size_t kBytes = kLo + sizeof(int) * kDecodeRows;
};

// Byte offset of 16-byte chunk `ch` of row `r` in a K or V tile: the chunk
// index XOR (r mod 8), so eight rows read at one column, or one row read
// across eight chunks, hit eight different bank groups.
__device__ __forceinline__ int swizzled(int r, int ch, int row_bytes) {
  return r * row_bytes + ((ch ^ (r & 7)) << 4);
}

// 16 bytes from global to shared memory, of which the first `src_bytes`
// (16 or 0) are read and the rest written as zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" :: "r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Tile `tile` of a stretch (K then V, 64 rows each) into a ring stage. Rows
// at or past the limit, and the chunks past the tensors' hd columns (hd 96
// in the hd-128 instantiation), are zero-filled without being read; their
// address is clamped to the last visible row and its first chunk, which
// exist.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(uint32_t stage, const DecodeSeg& sg, int tile, long long row_stride,
                                          int hd) {
  using L = DecodeLayout<T, HD>;
  const int k0 = tile * kTile;
  const int avail = sg.limit - k0;  // >= 1: the walk only visits tiles with a visible key
  const int data_chunks = hd / L::kElems;
#pragma unroll 4
  for (int c = threadIdx.x; c < 2 * kTile * L::kChunks; c += kDecodeThreads) {
    const int which = c / (kTile * L::kChunks);
    const int r = (c / L::kChunks) % kTile;
    const int ch = c % L::kChunks;
    const bool data = ch < data_chunks;
    const T* base = static_cast<const T*>(which ? sg.v : sg.k);
    const T* src = base + (long long)(k0 + min(r, avail - 1)) * row_stride + (data ? ch : 0) * L::kElems;
    cp_async16(stage + which * L::kTileBytes + swizzled(r, ch, L::kRowBytes), src, r < avail && data ? 16 : 0);
  }
}

// The walk's position: tile `tile` of stretch `seg`; seg == n_seg at the end.
struct WalkPos {
  int seg;
  int tile;
};

// The next tile with a visible key: the next of this stretch, else the first
// (t0) of the next stretch that has one.
__device__ __forceinline__ void next_tile(WalkPos& w, const DecodeSeg* segs, int n_seg) {
  ++w.tile;
  while (w.seg < n_seg && w.tile * kTile >= segs[w.seg].limit) {
    if (++w.seg < n_seg) w.tile = segs[w.seg].t0;
  }
}

// Walks the block's tiles through a ring of kStages stages, kStages - 1
// tiles ahead of the compute, calling tile(K/V stage, stretch, visible keys,
// first key, tile number) once each tile's bytes are in shared memory. One
// commit group per tile (empty past the walk's end, so the group count
// stays fixed). With one stage each tile is loaded, awaited and computed in
// turn.
template <typename T, int HD, class F>
__device__ __forceinline__ void walk_tiles(const DecodeBlock& blk, const DecodeSeg* segs, unsigned char* smem,
                                           F&& tile) {
  using L = DecodeLayout<T, HD>;
  const uint32_t ring = smem_u32(smem);
  WalkPos ld = {0, segs[0].t0 - 1};
  next_tile(ld, segs, blk.n_seg);
  WalkPos at = ld;
  if constexpr (L::kStages == 1) {
    for (int i = 0; at.seg < blk.n_seg; ++i) {
      __syncthreads();  // tile i - 1 is no longer read
      const DecodeSeg sg = segs[at.seg];
      load_tile<T, HD>(ring, sg, at.tile, blk.row_stride, blk.hd);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      const int k0 = at.tile * kTile;
      tile(smem, sg, min(kTile, sg.limit - k0), k0, i);
      next_tile(at, segs, blk.n_seg);
    }
  } else {
#pragma unroll
    for (int i = 0; i < L::kStages - 1; ++i) {
      if (ld.seg < blk.n_seg) {
        load_tile<T, HD>(ring + i * L::kStageBytes, segs[ld.seg], ld.tile, blk.row_stride, blk.hd);
        next_tile(ld, segs, blk.n_seg);
      }
      cp_async_commit();
    }
    for (int i = 0, stage = 0; at.seg < blk.n_seg; ++i, stage = stage + 1 == L::kStages ? 0 : stage + 1) {
      cp_async_wait<L::kStages - 2>();  // this thread's copies of tile i have landed
      __syncthreads();                  // everyone's have, and tile i - 1 is no longer read
      if (ld.seg < blk.n_seg) {
        const int free_stage = stage == 0 ? L::kStages - 1 : stage - 1;
        load_tile<T, HD>(ring + free_stage * L::kStageBytes, segs[ld.seg], ld.tile, blk.row_stride, blk.hd);
        next_tile(ld, segs, blk.n_seg);
      }
      cp_async_commit();
      const DecodeSeg sg = segs[at.seg];
      const int k0 = at.tile * kTile;
      tile(smem + stage * L::kStageBytes, sg, min(kTile, sg.limit - k0), k0, i);
      next_tile(at, segs, blk.n_seg);
    }
  }
  cp_async_wait<0>();
}

// 16 bytes of float32 as floats / two consecutive float32 elements.
__device__ __forceinline__ void unpack16(const uint4& raw, float* f) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}

// Float32: products on the CUDA cores (the tensor cores would round float32
// to TF32), the path of the float32 card-vs-CPU cross-check. QK^T: each
// thread owns one key of the tile and half of hd, one shuffle completes the
// dot; the online softmax runs one warp per row; PV: each thread owns two
// output dims of a share of the rows.
template <int HD, bool kLocal>
__device__ __forceinline__ void decode_rows_f32(const DecodeParams& p, const DecodeBlock& blk, const DecodeSeg* segs,
                                                const int* lo_rows, unsigned char* smem) {
  using L = DecodeLayout<float, HD>;
  constexpr int kPairs = HD / 2;                       // PV: one pair of output dims per thread
  constexpr int kRowGroups = kDecodeThreads / kPairs;  // 2 (hd 128) or 4 (hd 64)
  constexpr int kOwn = kDecodeRows / kRowGroups;       // rows per PV thread
  float* Qs = reinterpret_cast<float*>(smem + L::kRing);
  float* Ss = Qs + kDecodeRows * HD;  // scores, then P
  float* m_s = Ss + kDecodeRows * kTile;
  float* l_s = m_s + kDecodeRows;
  float* a_s = l_s + kDecodeRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < blk.nrow * HD; i += kDecodeThreads)
    Qs[i] = i % HD < blk.hd ? static_cast<const float*>(p.q)[blk.row_offset(i / HD, blk.hd) + i % HD] : 0.f;
  if (tid < kDecodeRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const int key = warp * 16 + (lane & 15);  // QK^T: this thread's key and half of hd
  const int half = lane >> 4;
  const int pair = tid % kPairs;  // PV: this thread's output dims 2*pair, 2*pair + 1
  const int rg = tid / kPairs;    // and rows rg, rg + kRowGroups, ...
  float2 o[kOwn];
#pragma unroll
  for (int k = 0; k < kOwn; ++k) o[k] = make_float2(0.f, 0.f);

  walk_tiles<float, HD>(blk, segs, smem, [&](const unsigned char* Kt, const DecodeSeg& sg, int nk, int k0, int) {
    const unsigned char* Vt = Kt + L::kTileBytes;
    const int ra = sg.ra;
    const int nr = sg.rb - sg.ra;

    // Scores of this thread's key against the stretch's rows (Ss[row - ra]).
    if (warp * 16 < nk) {
      float kf[HD / 2];
#pragma unroll
      for (int c = 0; c < L::kChunks / 2; ++c)
        unpack16(*reinterpret_cast<const uint4*>(Kt + swizzled(key, half * (L::kChunks / 2) + c, L::kRowBytes)),
                 kf + c * L::kElems);
      for (int r = 0; r < nr; ++r) {
        const float4* qr = reinterpret_cast<const float4*>(Qs + (ra + r) * HD + half * (HD / 2));
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int d = 0; d < HD / 8; d += 2) {
          const float4 x = qr[d];
          const float4 y = qr[d + 1];
          a0 = fmaf(x.x, kf[4 * d], a0);
          a0 = fmaf(x.y, kf[4 * d + 1], a0);
          a0 = fmaf(x.z, kf[4 * d + 2], a0);
          a0 = fmaf(x.w, kf[4 * d + 3], a0);
          a1 = fmaf(y.x, kf[4 * d + 4], a1);
          a1 = fmaf(y.y, kf[4 * d + 5], a1);
          a1 = fmaf(y.z, kf[4 * d + 6], a1);
          a1 = fmaf(y.w, kf[4 * d + 7], a1);
        }
        float a = a0 + a1;
        a += __shfl_xor_sync(0xffffffffu, a, 16);
        if (half == 0) Ss[r * kTile + key] = a;
      }
    }
    __syncthreads();

    // Online softmax, one warp per row; Ss becomes P. The limit is tested
    // only on a source's last tile (the only one with nk < 64), the row's
    // local bound on every tile (it costs nothing next to the FMA products).
    for (int r = warp; r < nr; r += kDecodeWarps) {
      const int row = ra + r;
      const int lo = kLocal ? lo_rows[row] - sg.pos0 - k0 : 0;  // the row's first visible key of this tile
      float x[2];
      bool vis[2];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = lane + 32 * i;
        vis[i] = (nk == kTile || c < nk) && (!kLocal || c >= lo);
        x[i] = vis[i] ? cap_score(Ss[r * kTile + c] * p.scale, p.softcap) : kNegInf;
        mx = fmaxf(mx, x[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, mx);
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // A masked key adds exactly 0: exp(NEG - NEG) would add 1.
        const float pv = vis[i] ? expf(x[i] - m_new) : 0.f;
        rs += pv;
        Ss[r * kTile + lane + 32 * i] = pv;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[row] = alpha;
        l_s[row] = l_s[row] * alpha + rs;
        m_s[row] = m_new;
      }
    }
    __syncthreads();

    // O += P V over the visible keys (rounded up to 4: P and V are 0 past nk).
    bool mine[kOwn];
#pragma unroll
    for (int k = 0; k < kOwn; ++k) {
      const int row = rg + k * kRowGroups;
      mine[k] = row >= ra && row < ra + nr;
      if (mine[k]) {
        const float alpha = a_s[row];
        o[k].x *= alpha;
        o[k].y *= alpha;
      }
    }
    const int pb = pair * 2 * (int)sizeof(float);  // the pair's byte offset in a row
    const int nk4 = (nk + 3) & ~3;
    for (int c = 0; c < nk4; c += 4) {
      float2 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = *reinterpret_cast<const float2*>(Vt + swizzled(c + u, pb >> 4, L::kRowBytes) + (pb & 15));
#pragma unroll
      for (int k = 0; k < kOwn; ++k) {
        if (mine[k]) {
          const float4 pr = *reinterpret_cast<const float4*>(Ss + (rg + k * kRowGroups - ra) * kTile + c);
          o[k].x = fmaf(pr.x, v[0].x, o[k].x);
          o[k].y = fmaf(pr.x, v[0].y, o[k].y);
          o[k].x = fmaf(pr.y, v[1].x, o[k].x);
          o[k].y = fmaf(pr.y, v[1].y, o[k].y);
          o[k].x = fmaf(pr.z, v[2].x, o[k].x);
          o[k].y = fmaf(pr.z, v[2].y, o[k].y);
          o[k].x = fmaf(pr.w, v[3].x, o[k].x);
          o[k].y = fmaf(pr.w, v[3].y, o[k].y);
        }
      }
    }
  });

  // l_s was last written before the walk's final barrier.
  float* out = static_cast<float*>(p.o);
#pragma unroll
  for (int k = 0; k < kOwn; ++k) {
    const int row = rg + k * kRowGroups;
    if (row < blk.nrow && 2 * pair < blk.hd) {
      const float l = l_s[row];
      const float inv = l > 0.f ? 1.f / l : 0.f;
      *reinterpret_cast<float2*>(out + blk.row_offset(row, blk.hd) + 2 * pair) =
          make_float2(o[k].x * inv, o[k].y * inv);
    }
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// d += a b for one m16n8k16 tile: a the 16x16 A fragment, (b0, b1) the
// 16x8 B fragment, fp32 accumulators.
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// bf16/fp16: the block's rows, padded to 16, are one m16 tile, and QK^T and
// PV are mma.sync m16n8k16 with fp32 accumulators (the FMA form of the
// float32 path left the products, not the loads, setting the time). Warp w
// takes keys 16w..16w+15 of every tile: Q's fragments stay in registers for
// the whole walk (at hd 256, where O alone takes 128 registers, they come
// by ldmatrix from shared memory on every tile), K comes by ldmatrix, and
// the scores stay in registers,
// where they become P (in V's type) as PV's A fragment, with V by
// ldmatrix.trans. Each tile's row maxima are exchanged between the warps
// through shared memory, so every warp rescales by the same m; each warp
// keeps its own l and O over its keys, summed across the warps at the end.
template <typename T, int HD, bool kLocal>
__device__ __forceinline__ void decode_rows_mma(const DecodeParams& p, const DecodeBlock& blk, const DecodeSeg* segs,
                                                const int* lo_rows, unsigned char* smem) {
  using L = DecodeLayout<T, HD>;
  constexpr bool kQRegs = HD <= 128;
  T* Qs = reinterpret_cast<T*>(smem + L::kRing);  // [16][kQPitch], rows past nrow and columns past hd zero
  float* pmax = reinterpret_cast<float*>(smem + L::kRing + sizeof(T) * kDecodeRows * L::kQPitch);  // [2][warp][row]
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gr = lane / 4;  // fragment rows gr and gr + 8
  const int tq = lane % 4;  // fragment columns 2*tq, 2*tq + 1 of each 8

  for (int i = tid; i < kDecodeRows * HD; i += kDecodeThreads) {
    const int row = i / HD;
    const int col = i % HD;
    Qs[row * L::kQPitch + col] = row < blk.nrow && col < blk.hd
        ? static_cast<const T*>(p.q)[blk.row_offset(row, blk.hd) + col] : from_f<T>(0.f);
  }
  __syncthreads();
  uint32_t qa[kQRegs ? HD / 16 : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t* q0 = reinterpret_cast<const uint32_t*>(Qs + gr * HD + 16 * kk + 2 * tq);
      const uint32_t* q1 = reinterpret_cast<const uint32_t*>(Qs + (gr + 8) * HD + 16 * kk + 2 * tq);
      qa[kk][0] = q0[0];
      qa[kk][1] = q1[0];
      qa[kk][2] = q0[4];  // columns + 8
      qa[kk][3] = q1[4];
    }
  }
  // ldmatrix row addresses of Q's A fragments: row lane % 16, columns + 8 for lanes 16-31.
  const uint32_t qrow = smem_u32(Qs) + ((lane % 16) * L::kQPitch + (lane / 16) * 8) * (int)sizeof(T);

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // rows gr, gr + 8, in log2 units
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the warp's sums
  const float qk_scale = p.softcap > 0.f ? p.scale / p.softcap : p.scale * kLog2e;
  const float cap2 = p.softcap * kLog2e;
  const int krow = warp * 16 + (lane / 16) * 8 + lane % 8;  // ldmatrix row addresses: K
  const int kcol = (lane / 8) % 2;
  const int vrow = warp * 16 + ((lane / 8) % 2) * 8 + lane % 8;  // and V
  const int vcol = lane / 16;
  const int lo0 = kLocal ? lo_rows[gr] : 0;  // rows gr, gr + 8: first visible key positions
  const int lo1 = kLocal ? lo_rows[gr + 8] : 0;

  walk_tiles<T, HD>(blk, segs, smem, [&](const unsigned char* Kt, const DecodeSeg& sg, int nk, int k0, int i) {
    const uint32_t kb = smem_u32(Kt);
    const uint32_t vb = kb + L::kTileBytes;
    const bool act0 = gr >= sg.ra && gr < sg.rb;  // rows this stretch updates
    const bool act1 = gr + 8 >= sg.ra && gr + 8 < sg.rb;
    const bool keys = warp * 16 < nk;  // the warp's keys include a visible one
    // The rows' first visible key as a column of the warp's 16 keys; only
    // a tile that starts below a row's bound needs the per-row test.
    const int kpos = sg.pos0 + k0 + warp * 16;
    const int c0 = lo0 - kpos, c1 = lo1 - kpos;
    const bool low = kLocal && max(c0, c1) > 0;

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if (keys) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, kb + swizzled(krow, 2 * kk + kcol, L::kRowBytes));
        if constexpr (kQRegs) {
          mma16816<T>(s[0], qa[kk], b[0], b[1]);
          mma16816<T>(s[1], qa[kk], b[2], b[3]);
        } else {
          uint32_t a[4];
          ldsm_x4(a, qrow + 16 * kk * (int)sizeof(T));
          mma16816<T>(s[0], a, b[0], b[1]);
          mma16816<T>(s[1], a, b[2], b[3]);
        }
      }
    }
    // Scores in log2 units: scale -> softcap -> mask, the limit tested only
    // on a source's last tile, the local bound only on a low tile.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = p.softcap > 0.f ? tanhf(s[j][e] * qk_scale) * cap2 : s[j][e] * qk_scale;
        const int c = 8 * j + 2 * tq + (e & 1);  // the key's column among the warp's 16
        if (!keys || (nk < kTile && warp * 16 + c >= nk) || (low && c < (e < 2 ? c0 : c1))) x = -INFINITY;
        s[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    float* pm = pmax + (i & 1) * kDecodeWarps * kDecodeRows;
    if (tq == 0) {
      pm[warp * kDecodeRows + gr] = mx0;
      pm[warp * kDecodeRows + gr + 8] = mx1;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      mx0 = fmaxf(mx0, pm[w * kDecodeRows + gr]);
      mx1 = fmaxf(mx1, pm[w * kDecodeRows + gr + 8]);
    }
    // m stays finite (it starts at kNegInf), so a masked key's -inf gives
    // exactly 0; rows the stretch does not update keep m, l and O.
    const float mn0 = act0 ? fmaxf(m0, mx0) : m0;
    const float mn1 = act1 ? fmaxf(m1, mx1) : m1;
    const float a0 = exp2f(m0 - mn0);
    const float a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[j][0] = act0 ? exp2f(s[j][0] - mn0) : 0.f;
      s[j][1] = act0 ? exp2f(s[j][1] - mn0) : 0.f;
      s[j][2] = act1 ? exp2f(s[j][2] - mn1) : 0.f;
      s[j][3] = act1 ? exp2f(s[j][3] - mn1) : 0.f;
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }
    if (keys) {
      // P in V's type as the A fragment of keys 16w..16w+15.
      const uint32_t pa[4] = {pack2<T>(s[0][0], s[0][1]), pack2<T>(s[0][2], s[0][3]),
                              pack2<T>(s[1][0], s[1][1]), pack2<T>(s[1][2], s[1][3])};
#pragma unroll
      for (int jj = 0; jj < HD / 16; ++jj) {
        uint32_t b[4];
        ldsm_x4_trans(b, vb + swizzled(vrow, 2 * jj + vcol, L::kRowBytes));
        mma16816<T>(o[2 * jj], pa, b[0], b[1]);
        mma16816<T>(o[2 * jj + 1], pa, b[2], b[3]);
      }
    }
  });

  // The warps' l and O summed through shared memory (the ring is free: every
  // copy has landed and the barrier below orders the last reads).
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  __syncthreads();
  float* o_red = reinterpret_cast<float*>(smem);           // [warp][row][HD]
  float* l_red = o_red + kDecodeWarps * kDecodeRows * HD;  // [warp][row]
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    *reinterpret_cast<float2*>(o_red + (warp * kDecodeRows + gr) * HD + 8 * n + 2 * tq) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(o_red + (warp * kDecodeRows + gr + 8) * HD + 8 * n + 2 * tq) =
        make_float2(o[n][2], o[n][3]);
  }
  if (tq == 0) {
    l_red[warp * kDecodeRows + gr] = l0;
    l_red[warp * kDecodeRows + gr + 8] = l1;
  }
  __syncthreads();
  T* out = static_cast<T*>(p.o);
  for (int i = tid; i < blk.nrow * (HD / 2); i += kDecodeThreads) {
    const int row = i / (HD / 2);
    const int d = 2 * (i % (HD / 2));
    if (d >= blk.hd) continue;
    float l = 0.f, x = 0.f, y = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float2 ow = *reinterpret_cast<const float2*>(o_red + (w * kDecodeRows + row) * HD + d);
      l += l_red[w * kDecodeRows + row];
      x += ow.x;
      y += ow.y;
    }
    const float inv = l > 0.f ? 1.f / l : 0.f;
    *reinterpret_cast<uint32_t*>(out + blk.row_offset(row, blk.hd) + d) = pack2<T>(x * inv, y * inv);
  }
}

// kLocal: a window or chunk is set (without one the kernel carries no
// local-bound code at all).
template <typename T, int HD, bool kLocal>
__global__ void __launch_bounds__(kDecodeThreads, (DecodeLayout<T, HD>::kMinBlocks))
    decode_rows_kernel(const __grid_constant__ DecodeParams p) {
  using L = DecodeLayout<T, HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  DecodeSeg* segs = reinterpret_cast<DecodeSeg*>(smem + L::kSeg);
  DecodeBlock blk;
  blk.b = blockIdx.y;
  blk.g = p.n_q / p.n_kv;
  blk.kvh = blockIdx.x / p.n_chunks;
  blk.r0 = (blockIdx.x % p.n_chunks) * kDecodeRows;
  blk.nrow = min(kDecodeRows, p.n_s * blk.g - blk.r0);
  blk.n_s = p.n_s;
  blk.n_q = p.n_q;
  const int s_lo = blk.r0 / blk.g;
  blk.n_seg = 1 + 2 * ((blk.r0 + blk.nrow - 1) / blk.g - s_lo + 1);
  blk.hd = p.hd;
  blk.row_stride = (long long)p.n_kv * p.hd;

  // Absolute positions: prefix key j at j, own key j of suffix s at
  // prefix_len + j, generated key j at prefix_len + eos[s] + 1 + j, and the
  // new token of suffix s at prefix_len + eos[s] + 1 + t.
  const int plen = p.src[0].lim[blk.b];
  const int* eos = p.src[1].lim + blk.b * p.n_s;
  auto suffix_lo = [&](int s) { return local_lo(plen + eos[s] + 1 + p.t, p.window, p.chunk); };
  const int tid = threadIdx.x;
  int* lo_rows = reinterpret_cast<int*>(smem + L::kLo);
  if (kLocal && tid < kDecodeRows) lo_rows[tid] = tid < blk.nrow ? suffix_lo((blk.r0 + tid) / blk.g) : 0;
  if (tid < blk.n_seg) {
    // Stretch 0 is the prefix; then per suffix s_lo + (tid - 1) / 2 its own
    // KV (odd tid) and its generated KV (even tid).
    const int s = tid == 0 ? 0 : s_lo + (tid - 1) / 2;
    Source src = p.src[0];
    if (tid > 0) src = tid % 2 ? p.src[1] : p.src[2];
    const long long off = blk.b * src.stride_b + s * src.stride_s + blk.kvh * p.hd;
    DecodeSeg sg;
    sg.k = static_cast<const T*>(src.k) + off;
    sg.v = static_cast<const T*>(src.v) + off;
    sg.limit = source_limit(src, blk.b, s);
    sg.ra = tid == 0 ? 0 : max(s * blk.g - blk.r0, 0);
    sg.rb = tid == 0 ? blk.nrow : min((s + 1) * blk.g - blk.r0, blk.nrow);
    sg.pos0 = 0;
    sg.t0 = 0;
    if constexpr (kLocal) {
      int lo;
      if (tid == 0) {
        // The prefix serves every suffix of the block: start at the tile of
        // the smallest bound, each row's own bound tested per row.
        lo = suffix_lo(s_lo);
        for (int si = s_lo + 1; si <= (blk.r0 + blk.nrow - 1) / blk.g; ++si) lo = min(lo, suffix_lo(si));
      } else {
        sg.pos0 = tid % 2 ? plen : plen + eos[s] + 1;
        lo = suffix_lo(s);
      }
      // No tile when the bound lies at or past the limit (no key is visible).
      sg.t0 = lo - sg.pos0 >= sg.limit ? (sg.limit + kTile - 1) / kTile : max(lo - sg.pos0, 0) / kTile;
    }
    segs[tid] = sg;
  }
  // Each path stages Q and passes a barrier before the walk reads segs and
  // lo_rows.
  if constexpr (std::is_same<T, float>::value) decode_rows_f32<HD, kLocal>(p, blk, segs, lo_rows, smem);
  else decode_rows_mma<T, HD, kLocal>(p, blk, segs, lo_rows, smem);
}

template <typename T, int HD>
cudaError_t launch_decode_rows(const DecodeParams& p, int n_b, cudaStream_t stream) {
  using L = DecodeLayout<T, HD>;
  // Once per template instantiation (thread-safe static init), not per
  // launch. The carveout asks for all of the SM's 228 KB as shared memory,
  // so two 16-bit blocks fit on one SM.
  static const cudaError_t attr = [] {
    auto set = [](const void* kernel) {
      const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
      return e != cudaSuccess ? e : cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                                         (int)cudaSharedmemCarveoutMaxShared);
    };
    const cudaError_t e = set((const void*)decode_rows_kernel<T, HD, false>);
    return e != cudaSuccess ? e : set((const void*)decode_rows_kernel<T, HD, true>);
  }();
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.n_kv * p.n_chunks, n_b);
  if (p.window > 0 || p.chunk > 0) decode_rows_kernel<T, HD, true><<<grid, kDecodeThreads, L::kBytes, stream>>>(p);
  else decode_rows_kernel<T, HD, false><<<grid, kDecodeThreads, L::kBytes, stream>>>(p);
  return cudaGetLastError();
}

Source make_source(const void* k, const void* v, long long stride_b, long long stride_s, int len,
                   const int* lim, int lim_sb, int lim_ss, int lim_add, int causal, int shift) {
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
  s.shift = shift;
  return s;
}

bool bad_local(int window, int chunk) { return window < 0 || chunk < 0 || (window > 0 && chunk > 0); }

// The instantiation of each head dim: its own, or for the 16-bit scoring
// kernel and for decode at 96 the hd-128 one (unpadded tensors, zero-filled
// columns past 96). The scoring kernels also take MLA's (192, 128).
bool mla_dims(const ScoreParams& p) { return p.hd == 192 && p.hd_v == 128; }

cudaError_t score_f32(const ScoreParams& p, int n_bs, cudaStream_t st) {
  if (p.hd_v != p.hd) return mla_dims(p) ? launch_score_f32<192, 128>(p, n_bs, st) : cudaErrorInvalidValue;
  switch (p.hd) {
    case 64: return launch_score_f32<64>(p, n_bs, st);
    case 96: return launch_score_f32<96>(p, n_bs, st);
    case 128: return launch_score_f32<128>(p, n_bs, st);
    case 256: return launch_score_f32<256>(p, n_bs, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t score_tc(const ScoreParams& p, int n_b, cudaStream_t st) {
  if (p.hd_v != p.hd) return mla_dims(p) ? launch_score_tc<T, 192, 128>(p, n_b, st) : cudaErrorInvalidValue;
  switch (p.hd) {
    case 64: return launch_score_tc<T, 64>(p, n_b, st);
    case 96:
    case 128: return launch_score_tc<T, 128>(p, n_b, st);
    case 256: return launch_score_tc<T, 256>(p, n_b, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t decode_rows(const DecodeParams& p, int n_b, cudaStream_t st) {
  switch (p.hd) {
    case 64: return launch_decode_rows<T, 64>(p, n_b, st);
    case 96:
    case 128: return launch_decode_rows<T, 128>(p, n_b, st);
    case 256: return launch_decode_rows<T, 256>(p, n_b, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32 (score_kernel_f32), 1 float16 and 2 bfloat16
// (score_tc_kernel); hd 64, 96, 128 or 256 with hd_v = hd, or MLA's hd 192
// with hd_v 128.
//
// q: [B, S, lq, n_q, hd], o: [B, S, lq, n_q, hd_v], contiguous (the causal
// form passes S = 1). Source i: K rows of n_kv*hd elements at k_i + b*sb_i +
// s*ss_i, len_i rows, and V rows of n_kv*hd_v elements at the same strides
// scaled by hd_v / hd; limit lim_i[b*lsb_i + s*lss_i] + ladd_i (ladd_i alone when lim_i is
// null); causal_i masks keys past the query's row index. A source with
// ss_i != 0 is a stack of [B, S, len_i] slabs (sb_i == n_s * ss_i).
// Local attention: a sliding `window` or a position `chunk` (0 = off, not
// both). Query row i of prompt b sits at absolute position pos[b] + i (i
// when pos is null), key j of source i at j, plus pos[b] when shift_i.
extern "C" int fls_score_attention(
    int dtype, int hd, int hd_v, const void* q, void* o, int n_b, int n_s, int lq, int n_q, int n_kv,
    float scale, float softcap, int window, int chunk, const void* pos, int n_src,
    const void* k0, const void* v0, long long sb0, long long ss0, int len0,
    const void* lim0, int lsb0, int lss0, int ladd0, int causal0, int shift0,
    const void* k1, const void* v1, long long sb1, long long ss1, int len1,
    const void* lim1, int lsb1, int lss1, int ladd1, int causal1, int shift1,
    void* stream) {
  ScoreParams p;
  p.q = q;
  p.o = o;
  p.q_stride_bs = (long long)lq * n_q * hd;
  p.o_stride_bs = (long long)lq * n_q * hd_v;
  p.hd = hd;
  p.hd_v = hd_v;
  p.lq = lq;
  p.n_q = n_q;
  p.n_kv = n_kv;
  p.n_s = n_s;
  p.scale = scale;
  p.softcap = softcap;
  p.window = window;
  p.chunk = chunk;
  p.pos = static_cast<const int*>(pos);
  p.n_src = n_src;
  p.src[0] = make_source(k0, v0, sb0, ss0, len0, static_cast<const int*>(lim0), lsb0, lss0, ladd0, causal0,
                         shift0);
  p.src[1] = make_source(k1, v1, sb1, ss1, len1, static_cast<const int*>(lim1), lsb1, lss1, ladd1, causal1,
                         shift1);
  if (lq <= 0 || n_b * n_s <= 0) return (int)cudaSuccess;
  if (bad_local(window, chunk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = score_f32(p, n_b * n_s, st);
  else if (dtype == 1) err = score_tc<__half>(p, n_b, st);
  else if (dtype == 2) err = score_tc<__nv_bfloat16>(p, n_b, st);
  else err = cudaErrorInvalidValue;
  return (int)err;
}

// q, o: [B, S, n_q, hd]. Sources: 0 the shared prefix (limit prefix_len[b]),
// 1 the suffix's own KV (limit suffix_eos[b, s] + 1), 2 the generated KV
// (limit t + 1); layout as for fls_score_attention. Local attention as for
// fls_score_attention, with the positions of the decode form (the new token
// of suffix s at prefix_len[b] + suffix_eos[b, s] + 1 + t). Every dtype
// launches decode_rows_kernel; hd 64, 96, 128 or 256.
extern "C" int fls_decode_attention(
    int dtype, int hd, const void* q, void* o, int n_b, int n_s, int n_q, int n_kv,
    float scale, float softcap, int window, int chunk,
    const void* kp, const void* vp, long long p_sb, int lp, const void* prefix_len,
    const void* ks, const void* vs, long long s_sb, long long s_ss, int ls, const void* suffix_eos,
    const void* kg, const void* vg, long long g_sb, long long g_ss, int tg, int t,
    void* stream) {
  DecodeParams p;
  const int g = n_q / n_kv;
  p.q = q;
  p.o = o;
  p.hd = hd;
  p.n_s = n_s;
  p.n_q = n_q;
  p.n_kv = n_kv;
  p.n_chunks = (n_s * g + kDecodeRows - 1) / kDecodeRows;
  p.scale = scale;
  p.softcap = softcap;
  p.window = window;
  p.chunk = chunk;
  p.t = t;
  p.src[0] = make_source(kp, vp, p_sb, 0, lp, static_cast<const int*>(prefix_len), 1, 0, 0, 0, 0);
  p.src[1] = make_source(ks, vs, s_sb, s_ss, ls, static_cast<const int*>(suffix_eos), n_s, 1, 1, 0, 0);
  p.src[2] = make_source(kg, vg, g_sb, g_ss, tg, nullptr, 0, 0, t + 1, 0, 0);
  if (n_b * n_s <= 0) return (int)cudaSuccess;
  if (bad_local(window, chunk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = decode_rows<float>(p, n_b, st);
  else if (dtype == 1) err = decode_rows<__half>(p, n_b, st);
  else if (dtype == 2) err = decode_rows<__nv_bfloat16>(p, n_b, st);
  else err = cudaErrorInvalidValue;
  return (int)err;
}

// Dynamic shared memory, in bytes, that the instantiation serving (kind,
// dtype, hd, hd_v) launches with (kind 0: scoring, 1: decode; dtype as
// above), for the build report; -1 for a combination no kernel takes.
extern "C" int fls_dynamic_smem(int kind, int dtype, int hd, int hd_v) {
  if (hd_v != hd) {
    if (kind != 0 || hd != 192 || hd_v != 128) return -1;
    return dtype == 0 ? (int)F32Layout<192, 128>::kBytes : TcLayout<192, 128>::kBytes;
  }
  const int inst = hd == 96 && !(kind == 0 && dtype == 0) ? 128 : hd;  // hd 96 runs at 128 but in f32 scoring
  if (kind == 0 && dtype == 0) {
    switch (inst) {
      case 64: return (int)F32Layout<64>::kBytes;
      case 96: return (int)F32Layout<96>::kBytes;
      case 128: return (int)F32Layout<128>::kBytes;
      case 256: return (int)F32Layout<256>::kBytes;
    }
  } else if (kind == 0 && (dtype == 1 || dtype == 2)) {
    switch (inst) {
      case 64: return TcLayout<64>::kBytes;
      case 128: return TcLayout<128>::kBytes;
      case 256: return TcLayout<256>::kBytes;
    }
  } else if (kind == 1) {
    const bool f32 = dtype == 0;
    switch (inst) {
      case 64: return (int)(f32 ? DecodeLayout<float, 64>::kBytes : DecodeLayout<__half, 64>::kBytes);
      case 128: return (int)(f32 ? DecodeLayout<float, 128>::kBytes : DecodeLayout<__half, 128>::kBytes);
      case 256: return (int)(f32 ? DecodeLayout<float, 256>::kBytes : DecodeLayout<__half, 256>::kBytes);
    }
  }
  return -1;
}
