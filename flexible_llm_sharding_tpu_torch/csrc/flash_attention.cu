// Hopper (sm_90a) attention kernels for the layer-streamed scorer.
//
// Three kernels replace the three Pallas TPU kernels of
// flexible_llm_sharding_tpu/ops/pallas_attention.py:
//
//   fls_score_attention, causal form   <- flash_causal_attention
//                                         (_causal_kernel)
//   fls_score_attention, two sources   <- flash_prefix_shared_attention
//                                         (_prefix_shared_kernel)
//   fls_decode_attention               <- flash_decode_attention
//                                         (_decode_kernel)
//
// Each computes what its TPU kernel computes (one joint online softmax over
// one or more KV "sources", fp32 accumulators, P cast to V's type before the
// PV product, fully masked rows written as 0), not a block-by-block copy of
// it. The TPU runs a sequential grid with scalar prefetch; here every block
// computes its own offsets, masks and loop bounds from blockIdx and the
// per-batch length arrays it is given.
//
// What bounds them on the H100, and what the design does about it:
//
// * Scoring (causal prefix pass and prefix-shared suffix pass). QK^T plus PV
//   cost 4*hd FLOPs per visible (query, key) pair; the bytes that must move
//   are 4*hd per query row (Q in, O out) and 4*hd per key row (K and V, read
//   once). The H100 does 295 bf16 FLOPs per byte, so the products bound the
//   causal pass once queries see about 1200 keys on average (prefixes of
//   ~2k tokens and more); at 512-token prefixes both passes are bound by
//   bytes, by a factor under 2. The kernel moves each byte from device
//   memory about once (a query tile re-reads its KV from L2, never Q, O or
//   the scores): it keeps the 64-query tile resident in shared memory,
//   streams 64-key KV tiles through shared memory, and runs both products on
//   the tensor cores
//   (WMMA 16x16x16, bf16/fp16 in, fp32 out); scores never leave the SM. KV
//   tiles past the valid length and, for causal sources, above the diagonal
//   are skipped, so a short prompt in a long bucket pays only for its real
//   keys. fp32 inputs take an FMA path (the tensor cores would round them to
//   TF32). This is the simple form: no wgmma, TMA or warp specialisation.
// * Decode. One new token per suffix: 2 products per key against one key
//   row of K and V each, so it is bound by the bytes of the KV it reads.
//   One block per (batch, suffix, KV head, group of <= 8 query heads) reads
//   each KV tile once for all query heads of its group (GQA), reads only the
//   tiles a suffix can see (prefix tiles up to prefix_len, suffix tiles up
//   to its eos, generated tiles up to t), with 16-byte global loads. Products
//   are FMA loops; at one query row per head the tensor cores would idle.
//
// Plain C interface, loaded with ctypes. Every launch goes on the caller's
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <mma.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -0.7f * FLT_MAX;  // the JAX package's _NEG_INF
constexpr int kTile = 64;                    // queries per block and keys per KV tile
constexpr int kScoreThreads = 128;           // 4 warps, 16 query rows each
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

// ---------------------------------------------------------------------------
// Scoring kernel: a 64-query tile of one head against up to two sources
// ---------------------------------------------------------------------------

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

template <typename T, int HD>
struct ScoreLayout {
  static constexpr bool kTC = !std::is_same<T, float>::value;
  static constexpr int QP = kTC ? HD + 8 : HD + 1;        // Q/K/V pitch (T)
  static constexpr int SP = kTC ? kTile + 4 : kTile + 1;  // scores pitch (float)
  static constexpr int PP = kTC ? kTile + 8 : kTile + 1;  // P pitch (T)
  static constexpr int OP = kTC ? HD + 4 : HD + 1;        // O pitch (float)
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = align128(kQ + sizeof(T) * kTile * QP);
  static constexpr size_t kV = align128(kK + sizeof(T) * kTile * QP);
  static constexpr size_t kS = align128(kV + sizeof(T) * kTile * QP);
  static constexpr size_t kP = align128(kS + sizeof(float) * kTile * SP);
  static constexpr size_t kO = align128(kP + sizeof(T) * kTile * PP);
  static constexpr size_t kBytes = align128(kO + sizeof(float) * kTile * OP);
};

// S[16 x 64] = Q[16 x HD] K^T for this warp's 16 query rows.
template <typename T, int HD>
__device__ __forceinline__ void warp_scores(const T* Qs, const T* Ks, float* Ss, int warp, int lane) {
  using L = ScoreLayout<T, HD>;
  if constexpr (L::kTC) {
    using namespace nvcuda;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
    for (int n = 0; n < kTile / 16; ++n) {
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int k = 0; k < HD / 16; ++k) {
        wmma::load_matrix_sync(a, Qs + (warp * 16) * L::QP + k * 16, L::QP);
        wmma::load_matrix_sync(b, Ks + (n * 16) * L::QP + k * 16, L::QP);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Ss + (warp * 16) * L::SP + n * 16, acc, L::SP, wmma::mem_row_major);
    }
  } else {
    for (int r = 0; r < 16; ++r) {
      const T* qr = Qs + (warp * 16 + r) * L::QP;
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        const float qv = to_f(qr[d]);
        a0 = fmaf(qv, to_f(Ks[lane * L::QP + d]), a0);
        a1 = fmaf(qv, to_f(Ks[(lane + 32) * L::QP + d]), a1);
      }
      Ss[(warp * 16 + r) * L::SP + lane] = a0;
      Ss[(warp * 16 + r) * L::SP + lane + 32] = a1;
    }
  }
}

// O[16 x HD] += P[16 x 64] V[64 x HD] for this warp's 16 query rows.
template <typename T, int HD>
__device__ __forceinline__ void warp_pv(const T* Ps, const T* Vs, float* Os, int warp, int lane) {
  using L = ScoreLayout<T, HD>;
  if constexpr (L::kTC) {
    using namespace nvcuda;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      float* o = Os + (warp * 16) * L::OP + n * 16;
      wmma::load_matrix_sync(acc, o, L::OP, wmma::mem_row_major);
#pragma unroll
      for (int k = 0; k < kTile / 16; ++k) {
        wmma::load_matrix_sync(a, Ps + (warp * 16) * L::PP + k * 16, L::PP);
        wmma::load_matrix_sync(b, Vs + (k * 16) * L::QP + n * 16, L::QP);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(o, acc, L::OP, wmma::mem_row_major);
    }
  } else {
    for (int r = 0; r < 16; ++r) {
      const T* pr = Ps + (warp * 16 + r) * L::PP;
      float acc[HD / 32];
#pragma unroll
      for (int j = 0; j < HD / 32; ++j) acc[j] = 0.f;
      for (int c = 0; c < kTile; ++c) {
        const float pv = to_f(pr[c]);
#pragma unroll
        for (int j = 0; j < HD / 32; ++j) acc[j] = fmaf(pv, to_f(Vs[c * L::QP + lane + 32 * j]), acc[j]);
      }
#pragma unroll
      for (int j = 0; j < HD / 32; ++j) Os[(warp * 16 + r) * L::OP + lane + 32 * j] += acc[j];
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kScoreThreads) score_kernel(const ScoreParams p) {
  using L = ScoreLayout<T, HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::kQ);
  T* Ks = reinterpret_cast<T*>(smem + L::kK);
  T* Vs = reinterpret_cast<T*>(smem + L::kV);
  float* Ss = reinterpret_cast<float*>(smem + L::kS);
  T* Ps = reinterpret_cast<T*>(smem + L::kP);
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

  const T* qbase = static_cast<const T*>(p.q) + bs * p.q_stride_bs + q0 * q_row_stride + h * HD;
  load_rows<T, HD, L::QP, kScoreThreads>(Qs, qbase, q_row_stride, q_rows);
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
    const T* kbase = static_cast<const T*>(src.k) + b * src.stride_b + s * src.stride_s + kvh * HD;
    const T* vbase = static_cast<const T*>(src.v) + b * src.stride_b + s * src.stride_s + kvh * HD;
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * kTile;
      __syncthreads();  // the previous tile's K/V are no longer read
      load_rows<T, HD, L::QP, kScoreThreads>(Ks, kbase + k0 * kv_row_stride, kv_row_stride, limit - k0);
      load_rows<T, HD, L::QP, kScoreThreads>(Vs, vbase + k0 * kv_row_stride, kv_row_stride, limit - k0);
      __syncthreads();

      warp_scores<T, HD>(Qs, Ks, Ss, warp, lane);
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
        Ps[row * L::PP + half * 32 + c] = from_f<T>(pv);
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      l = l * alpha + rs;
      m = m_new;
      for (int d = half * (HD / 2); d < (half + 1) * (HD / 2); ++d) Os[row * L::OP + d] *= alpha;
      __syncwarp();

      warp_pv<T, HD>(Ps, Vs, Os, warp, lane);
      __syncwarp();
    }
  }

  __syncthreads();  // O was zeroed by other threads when no tile ran
  if (qi < p.lq) {
    T* obase = static_cast<T*>(p.o) + bs * p.q_stride_bs + qi * q_row_stride + h * HD;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    for (int d = half * (HD / 2); d < (half + 1) * (HD / 2); ++d) obase[d] = from_f<T>(Os[row * L::OP + d] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch_score(const ScoreParams& p, int n_bs, cudaStream_t stream) {
  using L = ScoreLayout<T, HD>;
  // Once per template instantiation (thread-safe static init), not per launch.
  static const cudaError_t attr = cudaFuncSetAttribute(score_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (attr != cudaSuccess) return attr;
  dim3 grid((p.lq + kTile - 1) / kTile, p.n_q, n_bs);
  score_kernel<T, HD><<<grid, kScoreThreads, L::kBytes, stream>>>(p);
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
cudaError_t score_hd(const ScoreParams& p, int hd, int n, cudaStream_t stream) {
  if (hd == 64) return launch_score<T, 64>(p, n, stream);
  if (hd == 128) return launch_score<T, 128>(p, n, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t decode_hd(const DecodeParams& p, int hd, int n, cudaStream_t stream) {
  if (hd == 64) return launch_decode<T, 64>(p, n, stream);
  if (hd == 128) return launch_decode<T, 128>(p, n, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16.
//
// q, o: [B, S, lq, n_q, hd] contiguous (the causal form passes S = 1).
// Source i: K and V rows of n_kv*hd elements at k_i + b*sb_i + s*ss_i, len_i
// rows; limit lim_i[b*lsb_i + s*lss_i] + ladd_i (ladd_i alone when lim_i is
// null); causal_i masks keys past the query's row index.
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = score_hd<float>(p, hd, n_b * n_s, st);
  else if (dtype == 1) err = score_hd<__half>(p, hd, n_b * n_s, st);
  else if (dtype == 2) err = score_hd<__nv_bfloat16>(p, hd, n_b * n_s, st);
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
