// Paged (block) KV-cache attention for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py::_kernel (the bf16/f32
// path of `paged_attention`, launched there by pl.pallas_call).  Same
// semantics: q [B, H, D] against K/V pages [P, page, KVH, D] addressed by
// block_tables [B, S] (int32) with context_lens [B] (int32); each kv head
// serves its group of H/KVH query heads; online softmax in f32 with the
// finite NEG_INF = -1e30 mask; P is cast to V's dtype before the PV product
// (as the TPU kernel does); out = acc / max(l, 1e-30) in q's dtype, so a row
// with nothing to attend to returns 0, never NaN.  Tokens at or past
// context_lens[b] are never read, so block-table entries past
// ceil(ctx / page) may hold anything.
//
// Design.  The TPU grid (B, S) walks one sequence's pages in order and
// carries m / l / acc in VMEM from one grid step to the next.  Hopper
// blocks run in parallel and in no order, so here ONE block owns one
// (sequence, kv head) pair and loops over that sequence's tokens itself,
// TILE = 32 tokens at a time (any page size: each token row is addressed
// through the block table on its own).  Per tile: the block stages the K
// and V rows [TILE, D] in shared memory (16-byte loads, K rows padded by 16
// bytes so the lane-per-token dot products are bank-conflict free); warp w
// scores query rows w, w+4, ... (lane j <-> token j) and updates that row's
// m / l; then thread t accumulates output dims of the group's rows from the
// rounded P and the V tile.  acc lives in shared memory so any group size
// fits.
//
// Bound.  Decode attention reads every valid K/V byte once and does ~4*G
// flops per byte at bf16 (G = H/KVH = 4 for Llama-3-8B), far below the
// card's ~295 flop/byte ridge: it is bound by device-memory bytes.  What
// this simple design leaves on the table: only B*KVH blocks (64-256 on 132
// SMs at the engine's shapes), so short batches leave SMs idle (split-K
// over pages with a second reduction pass would fix that); loads are
// synchronous (no cp.async / TMA double buffering, so each tile's load
// latency is exposed); the dot products run on CUDA cores, not mma/wgmma,
// which matters for the prefill case where 32 query rows stream the same
// pages (one block per row re-reads them 32 times; a multi-row block
// with mma would read them once).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // tokens per tile (one per lane)
constexpr float kNegInf = -1e30f;
constexpr int kPadBytes = 16;      // K row padding (bank-conflict free)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T as floats
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x; f[2 * i + 1] = t.y;
    }
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
struct Smem {
  static constexpr int kRow = D * (int)sizeof(T) + kPadBytes;  // K row bytes
  static constexpr int kVRow = D * (int)sizeof(T);
  static size_t bytes(int G) {
    return (size_t)kTile * kRow + (size_t)kTile * kVRow  // K, V tiles
           + (size_t)G * D * 4 * 2                        // q, acc (f32)
           + (size_t)G * kTile * 4                        // P
           + (size_t)G * 4 * 3;                           // m, l, corr
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ context_lens,
                       T* __restrict__ out, int H, int KVH, int page_size,
                       int S, float scale) {
  using S_ = Smem<T, D>;
  constexpr int VN = Vec<T>::N;          // elements per 16-byte load
  constexpr int kChunks = D / VN;        // 16-byte chunks per row
  const int h = blockIdx.x;              // kv head
  const int b = blockIdx.y;              // sequence
  const int G = H / KVH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* k_s = smem;
  unsigned char* v_s = k_s + kTile * S_::kRow;
  float* q_s = reinterpret_cast<float*>(v_s + kTile * S_::kVRow);
  float* acc_s = q_s + G * D;
  float* p_s = acc_s + G * D;
  float* m_s = p_s + G * kTile;
  float* l_s = m_s + G;
  float* c_s = l_s + G;

  const int ctx = context_lens[b];
  const T* qb = q + ((size_t)b * H + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f(qb[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  const int* bt = block_tables + (size_t)b * S;
  const size_t tok_stride = (size_t)KVH * D;   // elements between tokens

  for (int t0 = 0; t0 < ctx; t0 += kTile) {
    __syncthreads();   // previous tile fully consumed (and init visible)
    // ---- stage K/V rows of this tile; rows past ctx are zero-filled and
    // never touch the block table
    for (int i = tid; i < kTile * kChunks; i += kThreads) {
      const int j = i / kChunks, c = i % kChunks;
      const int t = t0 + j;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (t < ctx) {
        const int page = bt[t / page_size];
        const size_t off = ((size_t)page * page_size + (t % page_size)) *
                               tok_stride + (size_t)h * D + (size_t)c * VN;
        kv = *reinterpret_cast<const uint4*>(kp + off);
        vv = *reinterpret_cast<const uint4*>(vp + off);
      }
      *reinterpret_cast<uint4*>(k_s + j * S_::kRow + c * 16) = kv;
      *reinterpret_cast<uint4*>(v_s + j * S_::kVRow + c * 16) = vv;
    }
    __syncthreads();
    // ---- scores and online-softmax statistics: warp w owns rows w, w+4..
    const int t = t0 + lane;
    for (int g = warp; g < G; g += kWarps) {
      float s = 0.f;
      const float* qg = q_s + g * D;
#pragma unroll 4
      for (int c = 0; c < kChunks; ++c) {
        float kf[VN];
        Vec<T>::unpack(*reinterpret_cast<const uint4*>(
                           k_s + lane * S_::kRow + c * 16), kf);
#pragma unroll
        for (int e = 0; e < VN; ++e) s = fmaf(qg[c * VN + e], kf[e], s);
      }
      s = (t < ctx) ? s * scale : kNegInf;
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = expf(s - m_new);
      const float corr = expf(m_prev - m_new);
      const float psum = warp_sum(p);
      // P rounds to V's dtype before the PV product; l keeps the f32 sum
      p_s[g * kTile + lane] = to_f(from_f<T>(p));
      if (lane == 0) {
        l_s[g] = l_s[g] * corr + psum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();
    // ---- acc[g, d] = acc[g, d] * corr[g] + sum_j P[g, j] * V[j, d]
    const int n_valid = min(kTile, ctx - t0);
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      const float* pg = p_s + g * kTile;
      const T* vcol = reinterpret_cast<const T*>(v_s) + d;
      float a = 0.f;
      for (int j = 0; j < n_valid; ++j)
        a = fmaf(pg[j], to_f(vcol[j * D]), a);
      acc_s[i] = acc_s[i] * c_s[g] + a;
    }
  }
  __syncthreads();
  T* ob = out + ((size_t)b * H + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads)
    ob[i] = from_f<T>(acc_s[i] / fmaxf(l_s[i / D], 1e-30f));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* bt, const int* cl, void* out, int B, int H,
                   int KVH, int page_size, int S, float scale,
                   cudaStream_t stream) {
  const int G = H / KVH;
  const size_t smem = Smem<T, D>::bytes(G);
  auto kern = paged_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(KVH, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, cl, static_cast<T*>(out), H, KVH,
      page_size, S, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
int paged_attention_fwd(const void* q, const void* k_pages,
                        const void* v_pages, const void* block_tables,
                        const void* context_lens, void* out, int B, int H,
                        int KVH, int D, int page_size, int S, float scale,
                        int dtype, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (KVH <= 0 || H % KVH != 0 || page_size <= 0)
    return (int)cudaErrorInvalidValue;
  const int* bt = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(context_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return (int)launch<float, 64>(q, k_pages, v_pages, bt, cl, out, B, H,
                                  KVH, page_size, S, scale, st);
  if (dtype == 0 && D == 128)
    return (int)launch<float, 128>(q, k_pages, v_pages, bt, cl, out, B, H,
                                   KVH, page_size, S, scale, st);
  if (dtype == 1 && D == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k_pages, v_pages, bt, cl, out,
                                          B, H, KVH, page_size, S, scale, st);
  if (dtype == 1 && D == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k_pages, v_pages, bt, cl, out,
                                           B, H, KVH, page_size, S, scale,
                                           st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory one block needs; the wrapper checks it against the
// card's per-block limit before launching.
size_t paged_attention_smem_bytes(int H, int KVH, int D, int dtype) {
  const int G = H / KVH;
  if (dtype == 0)
    return D == 64 ? Smem<float, 64>::bytes(G) : Smem<float, 128>::bytes(G);
  return D == 64 ? Smem<__nv_bfloat16, 64>::bytes(G)
                 : Smem<__nv_bfloat16, 128>::bytes(G);
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
