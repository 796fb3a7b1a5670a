// Paged (block) KV-cache attention for Hopper (sm_90a): one kernel body,
// the single-query wrapper's two instantiations.
//
//   K5  pages in q's dtype, q_len = 1  replaces paddle_tpu/ops/pallas/
//       paged_attention.py::_kernel (decode / prefill-chunk attention)
//   K6  int8 pages + scales, q_len = 1 replaces ::_kernel_q
//
// The body takes any q_len, but only the single-query wrapper launches
// it: the multi-query verify kernels K7 / K7q (::_kernel_mq, ::_kernel_mq_q)
// have a split-K body of their own, paged_attention_mq.cu.
//
// Semantics (those of the TPU kernels): q [B, Q, H, D] (row j of sequence b
// sits at position context_lens[b] - 1 + j) against K/V pages
// [P, page, KVH, D] addressed by block_tables [B, S] (int32), with
// context_lens [B] (int32).  Row j sees tokens t < ctx + j, and never a
// token at or past S * page (the TPU grid (B, S) has no page past S).  Each
// kv head serves its group of G = H / KVH query heads.  Online softmax in
// f32 with the finite NEG_INF = -1e30 mask; P is rounded to V's working
// dtype before the PV product; out = acc / max(l, 1e-30) in q's dtype, so a
// row with nothing to attend to returns 0, never NaN.  Int8 pages carry a
// f32 scale per (token, kv head), scales [P, page, KVH]; each int8 value is
// dequantized as float(v) * scale and ROUNDED TO q's DTYPE before the dots,
// as _kernel_q does (`(k.astype(f32) * ks).astype(q.dtype)`).
//
// Design.  The TPU grid (B, S) walks one sequence's pages in order and
// carries m / l / acc in VMEM from one grid step to the next.  Hopper
// blocks run in parallel and in no order, so here ONE block owns one
// (sequence, kv head) pair and loops over that sequence's tokens itself,
// TILE = 32 tokens at a time, up to min(ctx + Q - 1, S * page); no
// block-table entry past that bound is read.  Any page size works: each
// token row is addressed through the block table on its own.  Each thread
// loads its share of the next tile's K/V rows (16-byte loads, with the
// rows' scales for int8 pages) into registers while the block computes on
// the current tile, so device-memory latency hides behind the arithmetic;
// then the block stages the tile [TILE, D] in shared memory ONCE (int8 rows
// are dequantized to q's dtype as they are staged, so the rest of the body
// is the same for both kernels) and scores ALL R = G * Q rows of its
// group against it: G = 4 rows for K5 / K6 at Llama-3-8B, 32 for a
// multi-query call with Q = 8.  That is what _mq_step does on the TPU
// (each page DMA'd once for all Q rows); a row-by-row loop over K5 would
// stream the prefix Q times.  Warp w scores rows w, w+4, ... in groups of 4
// (lane j <-> token j, K rows padded by 16 bytes so the lane-per-token dot
// products are bank-conflict free, each K chunk unpacked once for the
// group), then thread t accumulates output column t % D of its rows from
// the rounded P and the V tile, 4 rows at a time in registers.  q and acc
// live in shared memory in f32, so any R that fits 227 KB works (the
// wrapper checks).
//
// Bound.  Both read every valid K/V byte once and do about 4 * R flops
// per K/V element (R = 4 at decode), far below the card's
// ~295 flop/byte ridge in bf16: they are bound by device-memory bytes, and
// int8 pages halve those bytes (D + 4 bytes per token-head instead of 2D).
// What this simple design leaves on the table: only B * KVH blocks (64 at
// batch 8 on 132 SMs), so short batches leave SMs idle and one long
// sequence sets the time (split-K over pages with a second reduction pass
// would fix that); one tile in flight per block (a cp.async / TMA ring of
// several would keep more bytes moving); the dot products run on CUDA
// cores, not mma / wgmma, which matters once R = 32 verify rows (or 32
// prefill rows, which today are 32 single-row problems that each re-read
// the pages) share a tile: a Q = 8 call on this body reads about K5's
// bytes and takes about four times as long, so its arithmetic, not the
// bytes, sets its time, which is why K7 / K7q have the split-K, mma body of
// paged_attention_mq.cu.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // tokens per tile (one per lane)
constexpr int kRB = 4;             // rows a thread holds in registers
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

// One 16-byte chunk of a page row (16 / sizeof(PT) elements), loaded from
// device memory into registers, then staged into shared memory as T.  Pages
// in q's dtype copy through; int8 pages are dequantized (float(v) * scale,
// rounded to T) on the way.
template <typename T, typename PT>
struct Stage {
  static constexpr int kElems = 16 / (int)sizeof(PT);
  __device__ __forceinline__ static void store(const uint4& u, float sc,
                                               unsigned char* dst) {
    if constexpr (sizeof(PT) == sizeof(T)) {
      *reinterpret_cast<uint4*>(dst) = u;
    } else {
      const int8_t* v8 = reinterpret_cast<const int8_t*>(&u);
      __align__(16) T tmp[kElems];
#pragma unroll
      for (int e = 0; e < kElems; ++e)
        tmp[e] = from_f<T>(static_cast<float>(v8[e]) * sc);
      const uint4* t4 = reinterpret_cast<const uint4*>(tmp);
#pragma unroll
      for (int i = 0; i < (int)sizeof(tmp) / 16; ++i)
        reinterpret_cast<uint4*>(dst)[i] = t4[i];
    }
  }
};

template <typename T, int D>
struct Smem {
  static constexpr int kRow = D * (int)sizeof(T) + kPadBytes;  // K row bytes
  static constexpr int kVRow = D * (int)sizeof(T);
  static size_t bytes(int R) {
    return (size_t)kTile * kRow + (size_t)kTile * kVRow  // K, V tiles
           + (size_t)R * D * 4 * 2                        // q, acc (f32)
           + (size_t)R * kTile * 4                        // P
           + (size_t)R * 4 * 3;                           // m, l, corr
  }
};

template <typename T, typename PT, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const PT* __restrict__ kp,
                       const PT* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ context_lens,
                       T* __restrict__ out, int Q, int H, int KVH,
                       int page_size, int S, float scale) {
  using S_ = Smem<T, D>;
  using St = Stage<T, PT>;
  constexpr bool kQuant = sizeof(PT) != sizeof(T);
  constexpr int VN = Vec<T>::N;          // T elements per 16 smem bytes
  constexpr int kChunks = D / VN;        // 16-byte smem chunks per row
  constexpr int kSrcChunks = D / St::kElems;   // 16-byte loads per row
  constexpr int kDstBytes = St::kElems * (int)sizeof(T);
  constexpr int kRS = kThreads / D;      // PV: rows between a thread's rows
  const int h = blockIdx.x;              // kv head
  const int b = blockIdx.y;              // sequence
  const int G = H / KVH;
  const int R = G * Q;                   // query rows of this block
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* k_s = smem;
  unsigned char* v_s = k_s + kTile * S_::kRow;
  float* q_s = reinterpret_cast<float*>(v_s + kTile * S_::kVRow);
  float* acc_s = q_s + R * D;
  float* p_s = acc_s + R * D;
  float* m_s = p_s + R * kTile;
  float* l_s = m_s + R;
  float* c_s = l_s + R;

  // row r of the block is query position j = r / G of q head h * G + r % G
  auto row_off = [&](int r) {
    return (((size_t)b * Q + r / G) * H + (size_t)h * G + r % G) * D;
  };
  const int ctx = context_lens[b];
  const int t_cap = S * page_size;              // no page past the table
  const int t_end = max(0, min(ctx + Q - 1, t_cap));
  for (int i = tid; i < R * D; i += kThreads) {
    q_s[i] = to_f(q[row_off(i / D) + i % D]);
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  const int* bt = block_tables + (size_t)b * S;
  const size_t tok_stride = (size_t)KVH * D;   // elements between tokens

  // this thread's share of a tile: kIters 16-byte chunks of K and of V
  constexpr int kIters = (kTile * kSrcChunks + kThreads - 1) / kThreads;
  uint4 kr[kIters], vr[kIters];
  float ksr[kIters], vsr[kIters];
  // load tile t0's chunks into registers; rows past t_end load zeros and
  // never touch the block table
  auto load = [&](int t0) {
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = tid + it * kThreads;
      const int j = i / kSrcChunks, c = i % kSrcChunks;
      const int t = t0 + j;
      kr[it] = vr[it] = make_uint4(0, 0, 0, 0);
      ksr[it] = vsr[it] = 0.f;
      if (i < kTile * kSrcChunks && t < t_end) {
        const size_t slot = (size_t)bt[t / page_size] * page_size +
                            t % page_size;
        const size_t off =
            slot * tok_stride + (size_t)h * D + (size_t)c * St::kElems;
        kr[it] = *reinterpret_cast<const uint4*>(kp + off);
        vr[it] = *reinterpret_cast<const uint4*>(vp + off);
        if (kQuant) {
          ksr[it] = ks[slot * KVH + h];
          vsr[it] = vs[slot * KVH + h];
        }
      }
    }
  };
  if (t_end > 0) load(0);
  for (int t0 = 0; t0 < t_end; t0 += kTile) {
    __syncthreads();   // previous tile fully consumed (and init visible)
    // ---- stage the loaded rows, then start loading the next tile: its
    // device-memory latency hides behind this tile's arithmetic
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = tid + it * kThreads;
      if (i < kTile * kSrcChunks) {
        const int j = i / kSrcChunks, c = i % kSrcChunks;
        St::store(kr[it], ksr[it], k_s + j * S_::kRow + c * kDstBytes);
        St::store(vr[it], vsr[it], v_s + j * S_::kVRow + c * kDstBytes);
      }
    }
    __syncthreads();
    if (t0 + kTile < t_end) load(t0 + kTile);
    // ---- scores and online-softmax statistics: warp w owns rows w, w+4..,
    // kRB of them at a time, each K chunk unpacked once for all of them
    const int t = t0 + lane;
    for (int rb = warp; rb < R; rb += kWarps * kRB) {
      float s[kRB];
#pragma unroll
      for (int i = 0; i < kRB; ++i) s[i] = 0.f;
#pragma unroll 4
      for (int c = 0; c < kChunks; ++c) {
        float kf[VN];
        Vec<T>::unpack(*reinterpret_cast<const uint4*>(
                           k_s + lane * S_::kRow + c * 16), kf);
#pragma unroll
        for (int i = 0; i < kRB; ++i) {
          const int r = rb + i * kWarps;
          if (r < R) {
            const float* qr = q_s + r * D + c * VN;
#pragma unroll
            for (int e = 0; e < VN; ++e) s[i] = fmaf(qr[e], kf[e], s[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRB; ++i) {
        const int r = rb + i * kWarps;
        if (r >= R) break;
        // row r (position j = r / G) sees tokens t < ctx + j, capped at S*page
        const bool valid = t < min(ctx + r / G, t_cap);
        const float sv = valid ? s[i] * scale : kNegInf;
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, warp_max(sv));
        const float p = valid ? expf(sv - m_new) : 0.f;
        const float corr = expf(m_prev - m_new);
        const float psum = warp_sum(p);
        // P rounds to V's working dtype before the PV product; l keeps the
        // f32 sum
        p_s[r * kTile + lane] = to_f(from_f<T>(p));
        if (lane == 0) {
          l_s[r] = l_s[r] * corr + psum;
          m_s[r] = m_new;
          c_s[r] = corr;
        }
      }
    }
    __syncthreads();
    // ---- acc[r, d] = acc[r, d] * corr[r] + sum_j P[r, j] * V[j, d]: thread
    // t owns column t % D of rows t / D, t / D + kRS, ...
    const int n_valid = min(kTile, t_end - t0);
    const int d = tid % D;
    const T* vcol = reinterpret_cast<const T*>(v_s) + d;
    for (int rb = tid / D; rb < R; rb += kRS * kRB) {
      float a[kRB];
#pragma unroll
      for (int i = 0; i < kRB; ++i) a[i] = 0.f;
      for (int j = 0; j < n_valid; ++j) {
        const float v = to_f(vcol[j * D]);
#pragma unroll
        for (int i = 0; i < kRB; ++i) {
          const int r = rb + i * kRS;
          if (r < R) a[i] = fmaf(p_s[r * kTile + j], v, a[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRB; ++i) {
        const int r = rb + i * kRS;
        if (r < R) acc_s[r * D + d] = acc_s[r * D + d] * c_s[r] + a[i];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D;
    out[row_off(r) + i % D] =
        from_f<T>(acc_s[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T, typename PT, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* bt,
                   const int* cl, void* out, int B, int Q, int H, int KVH,
                   int page_size, int S, float scale, cudaStream_t stream) {
  const int R = (H / KVH) * Q;
  const size_t smem = Smem<T, D>::bytes(R);
  auto kern = paged_attention_kernel<T, PT, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(KVH, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const PT*>(kp),
      static_cast<const PT*>(vp), ks, vs, bt, cl, static_cast<T*>(out), Q, H,
      KVH, page_size, S, scale);
  return cudaGetLastError();
}

template <typename T, typename PT>
cudaError_t launch_d(int D, const void* q, const void* kp, const void* vp,
                     const float* ks, const float* vs, const int* bt,
                     const int* cl, void* out, int B, int Q, int H, int KVH,
                     int page_size, int S, float scale, cudaStream_t st) {
  if (D == 64)
    return launch<T, PT, 64>(q, kp, vp, ks, vs, bt, cl, out, B, Q, H, KVH,
                             page_size, S, scale, st);
  if (D == 128)
    return launch<T, PT, 128>(q, kp, vp, ks, vs, bt, cl, out, B, Q, H, KVH,
                              page_size, S, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q [B, Q, H, D] (Q = 1: K5 / K6) and out alike; pages [P, page, KVH, D] in
// q's dtype (quant = 0) or int8 with f32 scales [P, page, KVH] (quant = 1).
// dtype (q's): 0 = float32, 1 = bfloat16.  Returns a cudaError_t
// (0 = launched).
int paged_attention_fwd(const void* q, const void* k_pages,
                        const void* v_pages, const void* k_scales,
                        const void* v_scales, const void* block_tables,
                        const void* context_lens, void* out, int B, int Q,
                        int H, int KVH, int D, int page_size, int S,
                        float scale, int dtype, int quant, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (KVH <= 0 || H % KVH != 0 || page_size <= 0 || Q <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  if (quant && (k_scales == nullptr || v_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* bt = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(context_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !quant)
    return (int)launch_d<float, float>(D, q, k_pages, v_pages, ks, vs, bt,
                                       cl, out, B, Q, H, KVH, page_size, S,
                                       scale, st);
  if (dtype == 0 && quant)
    return (int)launch_d<float, int8_t>(D, q, k_pages, v_pages, ks, vs, bt,
                                        cl, out, B, Q, H, KVH, page_size, S,
                                        scale, st);
  if (dtype == 1 && !quant)
    return (int)launch_d<__nv_bfloat16, __nv_bfloat16>(
        D, q, k_pages, v_pages, ks, vs, bt, cl, out, B, Q, H, KVH, page_size,
        S, scale, st);
  if (dtype == 1 && quant)
    return (int)launch_d<__nv_bfloat16, int8_t>(
        D, q, k_pages, v_pages, ks, vs, bt, cl, out, B, Q, H, KVH, page_size,
        S, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory one block needs for `rows` = (H / KVH) * Q query
// rows; the wrapper checks it against the card's per-block limit before
// launching.  0 for a head_dim the kernel does not take.
size_t paged_attention_smem_bytes(int rows, int D, int dtype) {
  if (D != 64 && D != 128) return 0;
  if (dtype == 0)
    return D == 64 ? Smem<float, 64>::bytes(rows)
                   : Smem<float, 128>::bytes(rows);
  return D == 64 ? Smem<__nv_bfloat16, 64>::bytes(rows)
                 : Smem<__nv_bfloat16, 128>::bytes(rows);
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
