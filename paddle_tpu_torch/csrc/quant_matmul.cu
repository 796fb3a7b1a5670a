// Weight-only quantized matmul for Hopper (sm_90a): K8.
//
//   K8  qmm<bf16 | float, int8 | int4>  replaces
//       paddle_tpu/ops/pallas/quant_matmul.py::_kernel (launched by
//       quant_matmul)
//
// Semantics (those of the TPU kernel).  y [M, N] = (x [M, K] @ W) *
// scale [N], W int8 [K, N], or int4 packed two to a byte [K / 2, N]: byte
// (i, n) holds row 2i in its low nibble and row 2i + 1 in its high nibble,
// each sign-extended.  Each tile of W is dequantized where it is used (to
// bf16, which holds every int8 value exactly, or to f32), the products
// are summed in f32 over the whole of K, the f32 per-column scale is
// applied once after the sum, and y is cast to x's dtype once.  bf16 x
// runs on the tensor cores (mma.sync m16n8k16, bf16 x bf16 -> f32); f32 x
// runs on CUDA cores in full f32, as the reference computes it on the CPU
// (on its TPU, DEFAULT precision would round f32 x to bf16).
//
// Bound.  Decode calls it with M = 8: 2 M K N flops against K N (int8) or
// K N / 2 (int4) weight bytes, about 16 (or 32) flops a byte, far under the
// card's ~295 flop/byte bf16 ridge.  So the weight stream sets the time:
// its bytes over 3.35 TB/s, and the kernel has to keep most SMs reading at
// once.  The bf16 weight is never materialised: each 16-byte chunk of W
// goes from device memory into registers, is unpacked and dequantized on
// its way into a shared-memory tile of KS x BN values, and is read from
// there as the tensor cores' B operand.
//
// Grid.  The TPU grid (N / 256, K / 256) walks K in order with its f32
// accumulator in VMEM; carried over it would give 16 blocks for a 4096 x
// 4096 projection and 4 for 4096 x 1024, on a card of 132 SMs.  Here a
// block owns a strip of BN = 64 columns, a tile of BM = 16 rows of x (M
// tiled in the grid, zero-padded inside the block) and one of `splits`
// equal chunks of K: grid (N / 64, splits, ceil(M / 16)).  The wrapper
// picks `splits`, a divisor of K / 256, so that a call has at least two
// blocks for each SM (4096 x 1024 at M = 8: 16 strips x 16 splits).  With
// splits > 1 each block writes its f32 partial sums to a [splits, M, N]
// workspace and a second kernel adds them in split order (deterministic),
// applies the scale and casts; with one split the first kernel does that
// itself.  The workspace is 4 splits M N bytes, small beside the weight
// at decode M (0.5 MB against 4 MB int8 for 4096 x 1024).
//
// Inside a block (128 threads), each of K / splits / KS steps stages KS =
// 128 rows of W (8 KB int8, 4 KB int4) and the matching 16 x 128 tile of x.
// The next step's W chunks are loaded into registers while the tensor cores
// work on the current tile.  Each warp owns 16 of the 64 columns.  What
// this simple design leaves on the table: no cp.async / TMA ring (one step
// in flight per block), byte-wise dequantization into shared memory and
// back out as fragments, M beyond 16 re-reads W once per 16 rows (from L2
// when the tiles run together), and mma.sync rather than wgmma.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;
constexpr int BN = 64;     // columns of a block
constexpr int BM = 16;     // rows of x of a block
constexpr int KS = 128;    // rows of K staged a step

struct Params {
  const void* x;           // [M, K], row stride K
  const int8_t* w;         // [K, N] int8 or [K / 2, N] packed int4
  const float* scale;      // [N]
  void* y;                 // [M, N]
  float* part;             // [splits, M, N] when splits > 1
  int M, K, N, splits;
};

template <typename T>
struct Tiles {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int LDW = kBf16 ? BN + 8 : BN;   // bf16 rows padded 16 B
  static constexpr int LDX = kBf16 ? KS + 8 : KS;
};

template <bool kInt4>
struct Chunks {
  static constexpr int ROWS = kInt4 ? KS / 2 : KS;  // byte rows of W a step
  static constexpr int PER = ROWS * BN / 16 / kThreads;   // 16-B chunks
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 dequantized values of one row of W into shared memory at t.
template <typename T>
__device__ __forceinline__ void store_row(T* t, const int (&v)[16]) {
  if constexpr (Tiles<T>::kBf16) {
    uint32_t u[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      u[i] = pack_bf16((float)v[2 * i], (float)v[2 * i + 1]);
    uint4* d = reinterpret_cast<uint4*>(t);
    d[0] = make_uint4(u[0], u[1], u[2], u[3]);
    d[1] = make_uint4(u[4], u[5], u[6], u[7]);
  } else {
    float4* d = reinterpret_cast<float4*>(t);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      d[i] = make_float4((float)v[4 * i], (float)v[4 * i + 1],
                         (float)v[4 * i + 2], (float)v[4 * i + 3]);
  }
}

// One 16-byte chunk of W (byte row r, columns c .. c + 15 of the strip),
// unpacked into the KS x BN tile: int8 gives tile row r; int4 gives rows
// 2r (low nibbles) and 2r + 1 (high nibbles), sign-extended.
template <typename T, bool kInt4>
__device__ __forceinline__ void dequant_chunk(T* sW, const uint4& u, int r,
                                              int c) {
  constexpr int LDW = Tiles<T>::LDW;
  const uint32_t word[4] = {u.x, u.y, u.z, u.w};
  int lo[16], hi[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int8_t b = (int8_t)(word[i / 4] >> (8 * (i % 4)));
    if constexpr (kInt4) {
      lo[i] = (int8_t)(b << 4) >> 4;
      hi[i] = b >> 4;
    } else {
      lo[i] = b;
    }
  }
  if constexpr (kInt4) {
    store_row(sW + (2 * r) * LDW + c, lo);
    store_row(sW + (2 * r + 1) * LDW + c, hi);
  } else {
    store_row(sW + r * LDW + c, lo);
  }
}

template <typename T>
__device__ __forceinline__ T to_out(float v) {
  if constexpr (Tiles<T>::kBf16) return __float2bfloat16_rn(v);
  else return v;
}

template <typename T, bool kInt4>
__global__ void __launch_bounds__(kThreads) qmm(const Params p) {
  using TL = Tiles<T>;
  using CH = Chunks<kInt4>;
  constexpr int LDW = TL::LDW, LDX = TL::LDX;
  __shared__ __align__(16) unsigned char smem[(KS * LDW + BM * LDX) * sizeof(T)];
  T* sW = reinterpret_cast<T*>(smem);
  T* sX = sW + KS * LDW;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, split = blockIdx.y, m0 = blockIdx.z * BM;
  const int kc_len = p.K / p.splits, kbeg = split * kc_len;
  const int steps = kc_len / KS;
  const int8_t* wbase =
      p.w + (long long)(kInt4 ? kbeg / 2 : kbeg) * p.N + n0;
  const T* xbase = static_cast<const T*>(p.x) + kbeg;

  uint4 wr[CH::PER];
  auto load_w = [&](int j) {
    const int8_t* src = wbase + (long long)j * CH::ROWS * p.N;
#pragma unroll
    for (int t = 0; t < CH::PER; ++t) {
      const int i = tid + t * kThreads;
      wr[t] = *reinterpret_cast<const uint4*>(src + (long long)(i / 4) * p.N +
                                              (i % 4) * 16);
    }
  };

  float acc[2][4];               // bf16: 2 n-blocks; f32: 8 rows
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i >> 2][i & 3] = 0.f;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;

  load_w(0);
  for (int j = 0; j < steps; ++j) {
    __syncthreads();
#pragma unroll
    for (int t = 0; t < CH::PER; ++t) {
      const int i = tid + t * kThreads;
      dequant_chunk<T, kInt4>(sW, wr[t], i / 4, (i % 4) * 16);
    }
    {  // the 16 x KS tile of x, rows past M zero
      constexpr int kPerRow = KS * (int)sizeof(T) / 16;
      for (int i = tid; i < BM * kPerRow; i += kThreads) {
        const int r = i / kPerRow, c = (i % kPerRow) * (16 / (int)sizeof(T));
        uint4 u = make_uint4(0, 0, 0, 0);
        if (m0 + r < p.M)
          u = *reinterpret_cast<const uint4*>(
              xbase + (long long)(m0 + r) * p.K + j * KS + c);
        *reinterpret_cast<uint4*>(sX + r * LDX + c) = u;
      }
    }
    __syncthreads();
    if (j + 1 < steps) load_w(j + 1);            // in flight during the math
    if constexpr (TL::kBf16) {
      const uint16_t* w16 = reinterpret_cast<const uint16_t*>(sW);
#pragma unroll
      for (int kc = 0; kc < KS / 16; ++kc) {
        const bf16* xa = sX + g * LDX + kc * 16 + 2 * tq;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(xa);
        a[1] = *reinterpret_cast<const uint32_t*>(xa + 8 * LDX);
        a[2] = *reinterpret_cast<const uint32_t*>(xa + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(xa + 8 * LDX + 8);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          const uint16_t* wb =
              w16 + (kc * 16 + 2 * tq) * LDW + warp * 16 + nb * 8 + g;
          uint32_t b[2];
          b[0] = (uint32_t)wb[0] | ((uint32_t)wb[LDW] << 16);
          b[1] = (uint32_t)wb[8 * LDW] | ((uint32_t)wb[9 * LDW] << 16);
          mma_bf16(acc[nb], a, b);
        }
      }
    } else {
      const int n = tid % BN, mg = tid / BN;     // column, rows mg*8 .. +7
#pragma unroll 4
      for (int kk = 0; kk < KS; ++kk) {
        const float w = sW[kk * LDW + n];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          acc[r >> 2][r & 3] =
              fmaf(sX[(mg * 8 + r) * LDX + kk], w, acc[r >> 2][r & 3]);
      }
    }
  }

  // epilogue: (row, column, sum) of each accumulator
  auto emit = [&](int m, int n, float v) {
    if (m >= p.M) return;
    const long long i = (long long)m * p.N + n;
    if (p.splits == 1)
      static_cast<T*>(p.y)[i] = to_out<T>(v * p.scale[n]);
    else
      p.part[(long long)split * p.M * p.N + i] = v;
  };
  if constexpr (TL::kBf16) {
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        emit(m0 + g + (e >> 1) * 8, n0 + warp * 16 + nb * 8 + 2 * tq + (e & 1),
             acc[nb][e]);
  } else {
    const int n = tid % BN, mg = tid / BN;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      emit(m0 + mg * 8 + r, n0 + n, acc[r >> 2][r & 3]);
  }
}

// The split partial sums added in split order, scaled and cast.
template <typename T>
__global__ void __launch_bounds__(256) reduce_splits(const Params p) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long mn = (long long)p.M * p.N;
  if (i >= mn) return;
  float s = 0.f;
  for (int k = 0; k < p.splits; ++k) s += p.part[k * mn + i];
  static_cast<T*>(p.y)[i] = to_out<T>(s * p.scale[i % p.N]);
}

template <typename T>
cudaError_t run(const Params& p, bool int4, cudaStream_t st) {
  const dim3 grid(p.N / BN, p.splits, (p.M + BM - 1) / BM);
  if (int4) qmm<T, true><<<grid, kThreads, 0, st>>>(p);
  else qmm<T, false><<<grid, kThreads, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return e;
  const long long mn = (long long)p.M * p.N;
  reduce_splits<T><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y [M, N] (x's dtype) = (x [M, K] @ dequant(w)) * scale [N].  dtype: 0 =
// float32, 1 = bfloat16 (x and y).  w is int8 [K, N], or with int4 packed
// [K / 2, N].  part: a float32 [splits, M, N] workspace, unused when
// splits == 1.  K must divide into splits chunks of a multiple of 128 rows,
// N into strips of 64; x, w, y 16-byte aligned, contiguous.  Returns a
// cudaError_t (0 = launched).
int quant_matmul(const void* x, const void* w, const float* scale, void* y,
                 float* part, int M, int K, int N, int splits, int int4,
                 int dtype, void* stream) {
  if (M == 0) return (int)cudaSuccess;
  if (splits < 1 || K % splits || (K / splits) % KS || N % BN ||
      (dtype != 0 && dtype != 1) || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x; p.w = static_cast<const int8_t*>(w); p.scale = scale; p.y = y;
  p.part = part; p.M = M; p.K = K; p.N = N; p.splits = splits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? run<bf16>(p, int4 != 0, st)
                          : run<float>(p, int4 != 0, st));
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
