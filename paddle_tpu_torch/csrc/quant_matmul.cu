// Weight-only quantized matmul for Hopper (sm_90a): K8.
//
//   K8  qmm_bf16<BN, int8 | int4, MT> (bf16 x) and qmm_f32 (f32 x) replace
//       paddle_tpu/ops/pallas/quant_matmul.py::_kernel (launched by
//       quant_matmul)
//
// Semantics (those of the TPU kernel).  y [M, N] = (x [M, K] @ W) *
// scale [N], W int8 [K, N], or int4 packed two to a byte [K / 2, N]: byte
// (i, n) holds row 2i in its low nibble and row 2i + 1 in its high nibble,
// each sign-extended.  The kernel reads that layout as it is stored; no
// repacked copy of W exists.  Each weight is dequantized where it is used
// (to bf16, which holds every int8 value exactly, or to f32), the products
// are summed in f32 over the whole of K, the f32 per-column scale is
// applied once after the sum, and y is cast to x's dtype once.  bf16 x
// runs on the tensor cores (mma.sync m16n8k16, bf16 x bf16 -> f32); f32 x
// runs on CUDA cores in full f32, as the reference computes it on the CPU.
//
// Bound: bytes.  Decode calls it with M = 8: 2 M K N flops against K N
// (int8) or K N / 2 (int4) weight bytes, 16 (or 32) flops a byte, far under
// the card's ~295 flop/byte bf16 ridge (a decode step's 224 GEMMs need 0.11
// ms of tensor-core time against 2.1 / 1.06 ms of weight bytes at 3.35
// TB/s).  So the kernel has to keep enough weight bytes in flight to cover
// HBM latency on every SM, and dequantize them for less than their
// transfer costs.  The bf16 body does three things about it.
//
// 1. A ring of raw weight bytes.  A block (8 warps, one an SM) streams its
//    strip of BN columns through shared-memory stages of 16 KB of int8 /
//    int4 bytes (8 KB for int4 strips of 64), each with the matching KS
//    columns of x, fed by cp.async 16-byte copies in commit groups.  The
//    ring takes as many stages as the block's 227 KB hold (up to 8: 112 KB
//    of int8 requested ahead of the math), which also keeps one block on an
//    SM.  int4 runs two pipelines of four warps, each with a ring and a
//    named barrier of its own over alternate stages, so that one pipeline's
//    dequantization overlaps the other's wait; int8, which converts less a
//    byte, runs one.  cp.async needs nothing from the host, where a TMA
//    feed would encode a tensor map for every call of a pass that is
//    already host-bound.  Stage rows are XOR-swizzled by 16-byte chunk
//    (strips of 64 columns pair two rows in each 128-byte line) so that
//    every fragment load below is free of bank conflicts.
// 2. Dequantization in registers, straight into swapped-operand fragments.
//    The product is computed as y^T = W^T x^T: the weight is the 16-row A
//    operand (16 output columns an m16 tile), and the decode batch is the n
//    = 8 of m16n8k16, so M = 8 fills it without padding (a block loops over
//    MT batch tiles of 8 for each dequantized slice: MT = 1, 2 or 4, beyond
//    32 rows M is tiled in the grid).  The order of k inside a k16 step and
//    of the columns inside a warp's pair of m16 tiles is free as long as x's
//    fragment and the epilogue follow it: lane (g, tq) takes columns 4g ..
//    4g + 3 and k rows 4tq .. 4tq + 3, so its whole A fragment for two m16
//    tiles is four 32-bit shared loads for int8 (two for int4, whose byte
//    already holds a k pair), its x fragment one 64-bit load, and its
//    accumulators four adjacent columns of two rows of y.  int8 converts by
//    byte permutes into the mantissa of 2^23 + u (u = q + 128), an f32
//    subtract and a permute of the two high halves into bf16x2; int4 by one
//    permute and one LOP3 into bf16 128 + (n ^ 8) per half, less 136 in one
//    bf16x2 FMA; neither uses the conversion unit, and no bf16 weight tile
//    is ever written to shared memory.
// 3. One launch a GEMM.  The wrapper splits K into `splits` (1-8) parts so
//    that a call has a block on as many SMs as it can (launch plan in
//    ops/quant_matmul.py, which keeps every cluster resident at once);
//    split s of a strip takes the stages s, s + splits, ... of K, and the
//    blocks of one column strip form a thread block cluster along K.  Each
//    block sums its warps' partials in shared memory (in warp order), then
//    each block of the cluster reads its share of the strip's output from
//    every block's shared memory (distributed shared memory), adds them in
//    rank order, scales, casts and writes y.  The sum order is fixed, so y
//    is bitwise repeatable, and there is no workspace and no second kernel.
//
// The f32 body (qmm_f32, the correctness path) keeps the first port's
// design: a registers-staged step of 128 rows of W dequantized into a
// shared tile, CUDA-core FMAs, one block a strip of 64 columns and 16 rows
// of x, the whole of K in one block.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

struct Params {
  const void* x;           // [M, K], row stride K
  const int8_t* w;         // [K, N] int8 or [K / 2, N] packed int4
  const float* scale;      // [N]
  void* y;                 // [M, N]
  int M, K, N, splits;
};

constexpr int kThreads = 256;   // bf16 body: 8 warps
constexpr int kMaxStages = 8;
constexpr int kMaxSplits = 8;   // a portable cluster
constexpr int kSmemPerBlock = 232448;
constexpr int kSmemPerSM = 233472;

// The bf16 body's tiles: a block owns BN columns and 8 MT rows of x over
// its stages of K (KS rows each), which alternate between its PIPES
// pipelines (two for int4, whose dequantization costs more a byte; one
// for int8).  In a pipeline, BN / 32 column groups of one warp each; the
// warps of a column group take alternate k16 steps of a stage.  A
// pipeline's ring takes as many stages as the block's shared memory holds
// (up to 8), which also keeps to one block an SM: the blocks of a cluster
// then land on as many SMs.
template <int BN, bool kInt4, int MT>
struct Plan {
  static constexpr int PIPES = kInt4 ? 2 : 1;
  static constexpr int PT = kThreads / PIPES;        // threads a pipeline
  static constexpr int CG = BN / 32;                 // column groups
  static constexpr int KGP = PT / 32 / CG;           // their warps a pipe
  static constexpr int KG = PIPES * KGP;             // partials a column
  static constexpr int KS = (!kInt4 && BN == 128) ? 128 : 256;  // k a stage
  static constexpr int RPT = kInt4 ? 2 : 4;          // W rows a lane a k16
  static constexpr int WROWS = kInt4 ? KS / 2 : KS;  // byte rows a stage
  static constexpr int CPR = BN / 16;                // 16-B chunks a row
  static constexpr int WBYTES = WROWS * BN;
  static constexpr int XROWS = 8 * MT;
  static constexpr int XRS = 2 * KS + 32;            // padded x row, bytes
  static constexpr int STAGE = WBYTES + XROWS * XRS;
  static constexpr int FIT = kSmemPerBlock / (PIPES * STAGE);
  static constexpr int STAGES = FIT < kMaxStages ? FIT : kMaxStages;
  static constexpr int STEPS = KS / 16 / KGP;        // k16 steps a warp
  static constexpr int LDR = BN + 4;                 // epilogue row, floats
  static constexpr int RED = KG * XROWS * LDR * 4;
  static constexpr int RING = PIPES * STAGES * STAGE;
  static constexpr int SMEM = RING > RED ? RING : RED;
  static_assert(WBYTES / 16 % PT == 0, "whole chunks a thread");
  static_assert(STAGES >= 3, "a ring of three stages at least");
  static_assert(2 * (SMEM + 1024) > kSmemPerSM, "one block an SM");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled, with no read,
// when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The `threads` threads of pipeline `pipe` alone (named barrier 1 + pipe).
__device__ __forceinline__ void pipe_sync(int pipe, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + pipe), "r"(threads)
               : "memory");
}

// Byte offset in a stage of W's 16-byte chunk c of byte row r.  A lane
// reads rows RPT tq .. + RPT - 1 of a k16 step, so t = (r / RPT) & 3 is
// the tq of the lanes that read row r: the swizzle gives the four tq of a
// warp four disjoint groups of 8 banks.  BN 128: a row fills a 128-byte
// line, chunk c ^ 2t.  BN 64: rows r and r ^ 1 share a line, row r takes
// its half 4 ((r ^ t) & 1), chunk c ^ 2 (t >> 1) inside it.
template <int BN, int RPT>
__device__ __forceinline__ int w_off(int r, int c) {
  const int t = (r / RPT) & 3;
  if constexpr (BN == 128) return r * 128 + 16 * (c ^ (2 * t));
  else return (r >> 1) * 128 + 16 * ((c ^ (2 * (t >> 1))) + 4 * ((r ^ t) & 1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Constants of the conversions below, read from constant memory so that
// the compiler keeps each in a register operand: folded in, it would take
// the one immediate slot of PRMT / LOP3 that the selector or the other
// constant needs, and cost an extra instruction every use.
__constant__ uint32_t kExp23 = 0x4B000000u;    // f32 2^23
__constant__ uint32_t kNibbles = 0x000F000Fu;  // low nibble of each half

// Byte c of lo and of hi, each already biased to u = q + 128 (xor 0x80),
// as the bf16 pair (q_lo, q_hi), without the conversion unit: u becomes the
// mantissa of 2^23 + u (exp23 = kExp23), an f32 subtract leaves q exact,
// and an integer of at most 8 significant bits is its f32's high half as a
// bf16.
template <int C>
__device__ __forceinline__ uint32_t i8_pair(uint32_t lo, uint32_t hi,
                                            uint32_t exp23) {
  const float a =
      __uint_as_float(__byte_perm(lo, exp23, 0x7650 + C)) - 8388736.f;
  const float b =
      __uint_as_float(__byte_perm(hi, exp23, 0x7650 + C)) - 8388736.f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// Byte c of w (h = w >> 4) as the bf16 pair (low nibble, high nibble), each
// sign-extended: the nibbles go to the low bits of each half (nib =
// kNibbles), n ^ 8 into the mantissa of bf16 128 (exact: 128 + (n ^ 8) =
// q + 136), less 136 in one bf16x2 FMA (exact).
template <int C>
__device__ __forceinline__ uint32_t i4_pair(uint32_t w, uint32_t h,
                                            uint32_t nib) {
  const uint32_t v =
      (__byte_perm(w, h, C | ((C + 4) << 8)) & nib) ^ 0x43084308u;
  uint32_t out;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(out)
      : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return out;
}

// The A fragments of a warp's two m16 tiles for one k16 step.  Lane (g, tq)
// holds W columns 4g .. 4g + 3 of its column group (tile t: row g is column
// 4g + 2t, row g + 8 column 4g + 2t + 1) and k rows 4tq .. 4tq + 3 (the
// fragment's k pairs (2tq, 2tq + 1) and (2tq + 8, 2tq + 9) in that order).
// int8: w[j] holds row 4tq + j of the four columns.
__device__ __forceinline__ void frag_int8(const uint32_t (&w)[4],
                                          uint32_t (&a)[2][4], uint32_t k) {
  uint32_t u[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) u[j] = w[j] ^ 0x80808080u;
  a[0][0] = i8_pair<0>(u[0], u[1], k);
  a[0][1] = i8_pair<1>(u[0], u[1], k);
  a[0][2] = i8_pair<0>(u[2], u[3], k);
  a[0][3] = i8_pair<1>(u[2], u[3], k);
  a[1][0] = i8_pair<2>(u[0], u[1], k);
  a[1][1] = i8_pair<3>(u[0], u[1], k);
  a[1][2] = i8_pair<2>(u[2], u[3], k);
  a[1][3] = i8_pair<3>(u[2], u[3], k);
}

// int4: w[j] holds packed row 2tq + j (k rows 4tq + 2j, + 1) of the four
// columns, so each byte is one register of the fragment.
__device__ __forceinline__ void frag_int4(const uint32_t (&w)[2],
                                          uint32_t (&a)[2][4], uint32_t k) {
  const uint32_t h0 = w[0] >> 4, h1 = w[1] >> 4;
  a[0][0] = i4_pair<0>(w[0], h0, k);
  a[0][1] = i4_pair<1>(w[0], h0, k);
  a[0][2] = i4_pair<0>(w[1], h1, k);
  a[0][3] = i4_pair<1>(w[1], h1, k);
  a[1][0] = i4_pair<2>(w[0], h0, k);
  a[1][1] = i4_pair<3>(w[0], h0, k);
  a[1][2] = i4_pair<2>(w[1], h1, k);
  a[1][3] = i4_pair<3>(w[1], h1, k);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Four floats at shared address `addr` of the cluster's block `rank`.
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote) : "memory");
  return v;
}

__device__ __forceinline__ void add4(float4& s, const float4& v) {
  s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
}

// Block (column strip, split, batch tile): grid (N / BN, splits, ceil(M / (8
// MT))), each column strip's splits one cluster along K.  Pipeline p of a
// block streams its stages p, p + PIPES, ... through a ring of its own
// under its own barrier, so one pipeline's math overlaps the other's wait.
template <int BN, bool kInt4, int MT>
__global__ void __launch_bounds__(kThreads, 1) qmm_bf16(const Params p) {
  using P = Plan<BN, kInt4, MT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int pipe = tid / P::PT, ptid = tid % P::PT;
  const int pw = ptid >> 5, cg = pw % P::CG, kgp = pw / P::CG;
  const int kg = pipe * P::KGP + kgp;              // this warp's partial
  const int n0 = blockIdx.x * BN, m0 = blockIdx.z * P::XROWS;
  const int mine = p.K / P::KS / p.splits;         // the block's stages
  const int steps = (mine - pipe + P::PIPES - 1) / P::PIPES;  // its pipe's
  unsigned char* ring = smem + pipe * P::STAGES * P::STAGE;

  // This thread's copies of a stage: rows r0 + RT t of W's chunk column c0
  // (RT = rows a pass of the pipe's threads) and rows rx0 + XT u of x's
  // chunk column cx0.  Along a thread's rows the swizzle does not change,
  // so the chunks' offsets in a stage are fixed steps from the first.
  constexpr int RT = P::PT / P::CPR, XCPR = P::KS / 8, XT = P::PT / XCPR;
  static_assert(RT % (4 * P::RPT) == 0 && P::PT % XCPR == 0, "fixed steps");
  const int r0 = ptid / P::CPR, c0 = ptid % P::CPR;
  const int rx0 = ptid / XCPR, cx0 = ptid % XCPR;
  const int wdst = w_off<BN, P::RPT>(r0, c0);
  const int8_t* wsrc = p.w + (long long)r0 * p.N + n0 + 16 * c0;
  const long long wstep = (long long)RT * p.N;
  const bf16* xsrc[(P::XROWS + XT - 1) / XT];
#pragma unroll
  for (int u = 0; u < (P::XROWS + XT - 1) / XT; ++u) {
    const int m = m0 + rx0 + XT * u;
    xsrc[u] = static_cast<const bf16*>(p.x) +
              (long long)(m < p.M ? m : 0) * p.K + 8 * cx0;
  }

  // the pipe's stage j: the block's stage PIPES j + pipe, which is stage
  // split + splits (PIPES j + pipe) of K (the blocks of a cluster read
  // adjacent stages): WROWS rows of the strip's bytes, and x's KS columns
  // for the block's 8 MT rows (rows past M zero-filled, not read)
  auto load = [&](int j) {
    unsigned char* st = ring + (j % P::STAGES) * P::STAGE;
    const int js = blockIdx.y + p.splits * (P::PIPES * j + pipe);
    const int8_t* ws = wsrc + (long long)js * P::WROWS * p.N;
#pragma unroll
    for (int t = 0; t < P::WROWS / RT; ++t)
      cp_async16(st + wdst + t * RT * BN, ws + t * wstep, true);
    unsigned char* sx = st + P::WBYTES + rx0 * P::XRS + 16 * cx0;
#pragma unroll
    for (int u = 0; u < (P::XROWS + XT - 1) / XT; ++u) {
      const int r = rx0 + XT * u;
      if (r < P::XROWS)
        cp_async16(sx + XT * u * P::XRS, xsrc[u] + js * P::KS,
                   m0 + r < p.M);
    }
  };

  int woff[P::RPT];                  // this lane's rows in a k16 step
#pragma unroll
  for (int j = 0; j < P::RPT; ++j)
    woff[j] = w_off<BN, P::RPT>(P::RPT * tq + j, 2 * cg + (g >> 2)) +
              4 * (g & 3);
  const int xoff = g * P::XRS + 8 * tq;
  const uint32_t conv = kInt4 ? kNibbles : kExp23;

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[mt][i >> 2][i & 3] = 0.f;

#pragma unroll
  for (int s = 0; s < P::STAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_commit();
  }
  for (int j = 0; j < steps; ++j) {
    cp_wait<P::STAGES - 2>();        // this thread's copies of stage j
    pipe_sync(pipe, P::PT);          // the pipe's; its stage j - 1 is free
    if (j + P::STAGES - 1 < steps) load(j + P::STAGES - 1);
    cp_commit();
    const unsigned char* sw = ring + (j % P::STAGES) * P::STAGE;
    const unsigned char* sx = sw + P::WBYTES + xoff;
#pragma unroll
    for (int i = 0; i < P::STEPS; ++i) {
      const int q = kgp + P::KGP * i;  // k16 step of the stage
      const unsigned char* wq = sw + q * 16 * P::WROWS / P::KS * BN;
      uint32_t a[2][4];
      if constexpr (kInt4) {
        const uint32_t w[2] = {*reinterpret_cast<const uint32_t*>(wq + woff[0]),
                               *reinterpret_cast<const uint32_t*>(wq + woff[1])};
        frag_int4(w, a, conv);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          w[r] = *reinterpret_cast<const uint32_t*>(wq + woff[r]);
        frag_int8(w, a, conv);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint2 xb = *reinterpret_cast<const uint2*>(
            sx + mt * 8 * P::XRS + q * 32);
        const uint32_t b[2] = {xb.x, xb.y};
        mma_bf16(acc[mt][0], a[0], b);
        mma_bf16(acc[mt][1], a[1], b);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();                   // the ring is free for the partials

  // each warp's partial tile: lane (g, tq) holds columns 4g .. 4g + 3 of
  // rows 2tq and 2tq + 1 of each batch tile
  float* red = reinterpret_cast<float*>(smem);   // [KG][XROWS][LDR]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(
          red + (kg * P::XROWS + mt * 8 + 2 * tq + h) * P::LDR + 32 * cg +
          4 * g) = make_float4(acc[mt][0][h], acc[mt][0][2 + h],
                               acc[mt][1][h], acc[mt][1][2 + h]);
  __syncthreads();

  constexpr int Q4 = BN / 4;                     // four columns an item
  const int rows = min(P::XROWS, p.M - m0);
  const int items = rows * Q4;
  auto emit = [&](int i, const float4& s) {
    const int m = i / Q4, n = n0 + 4 * (i % Q4);
    const float4 sc = *reinterpret_cast<const float4*>(p.scale + n);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(s.x * sc.x, s.y * sc.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(s.z * sc.z, s.w * sc.w);
    uint2 o;
    o.x = *reinterpret_cast<const uint32_t*>(&lo);
    o.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<bf16*>(p.y) +
                              (long long)(m0 + m) * p.N + n) = o;
  };
  auto at = [&](int k, int i) {                  // group k's item i
    return red + (k * P::XROWS + i / Q4) * P::LDR + 4 * (i % Q4);
  };
  // the warps' partials in warp order
  for (int i = tid; i < items; i += kThreads) {
    float4 s = *reinterpret_cast<const float4*>(at(0, i));
#pragma unroll
    for (int k = 1; k < P::KG; ++k)
      add4(s, *reinterpret_cast<const float4*>(at(k, i)));
    if (p.splits == 1) emit(i, s);
    else *reinterpret_cast<float4*>(at(0, i)) = s;
  }
  if (p.splits == 1) return;
  // the cluster's blocks in rank order, each block its share of the items
  cluster_sync();
  const int per = (items + p.splits - 1) / p.splits;
  const int i0 = (int)cluster_rank() * per, i1 = min(items, i0 + per);
  for (int i = i0 + tid; i < i1; i += kThreads) {
    const uint32_t addr = smem_u32(at(0, i));
    float4 s = ld_cluster4(addr, 0);
    for (int r = 1; r < p.splits; ++r) add4(s, ld_cluster4(addr, r));
    emit(i, s);
  }
  cluster_sync();                    // no block leaves while it is read
}

// ------------------------------------------------------------ f32 body
constexpr int kF32Threads = 128;
constexpr int FBN = 64;     // columns of a block
constexpr int FBM = 16;     // rows of x of a block
constexpr int FKS = 128;    // rows of K staged a step

// 16 dequantized values of one row of W into shared memory at t.
__device__ __forceinline__ void store_row(float* t, const int (&v)[16]) {
  float4* d = reinterpret_cast<float4*>(t);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    d[i] = make_float4((float)v[4 * i], (float)v[4 * i + 1],
                       (float)v[4 * i + 2], (float)v[4 * i + 3]);
}

// One 16-byte chunk of W (byte row r, columns c .. c + 15 of the strip),
// unpacked into the FKS x FBN tile: int8 gives tile row r; int4 gives rows
// 2r (low nibbles) and 2r + 1 (high nibbles), sign-extended.
template <bool kInt4>
__device__ __forceinline__ void dequant_chunk(float* sW, const uint4& u, int r,
                                              int c) {
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
    store_row(sW + (2 * r) * FBN + c, lo);
    store_row(sW + (2 * r + 1) * FBN + c, hi);
  } else {
    store_row(sW + r * FBN + c, lo);
  }
}

// Block (strip, -, row tile): grid (N / 64, 1, ceil(M / 16)); each step
// stages FKS rows of W, dequantized, and the 16 x FKS tile of x; thread
// (column n, row group mg) sums rows mg * 8 .. + 7 in f32.
template <bool kInt4>
__global__ void __launch_bounds__(kF32Threads) qmm_f32(const Params p) {
  constexpr int ROWS = kInt4 ? FKS / 2 : FKS;   // byte rows of W a step
  constexpr int PER = ROWS * FBN / 16 / kF32Threads;
  __shared__ __align__(16) float sW[FKS * FBN];
  __shared__ __align__(16) float sX[FBM * FKS];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * FBN, m0 = blockIdx.z * FBM;
  const float* x = static_cast<const float*>(p.x);
  const int n = tid % FBN, mg = tid / FBN;
  float acc[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) acc[r] = 0.f;
  for (int j = 0; j < p.K / FKS; ++j) {
    const int8_t* src = p.w + (long long)j * ROWS * p.N + n0;
    uint4 wr[PER];
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int i = tid + t * kF32Threads;
      wr[t] = *reinterpret_cast<const uint4*>(src + (long long)(i / 4) * p.N +
                                              (i % 4) * 16);
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int i = tid + t * kF32Threads;
      dequant_chunk<kInt4>(sW, wr[t], i / 4, (i % 4) * 16);
    }
    for (int i = tid; i < FBM * FKS / 4; i += kF32Threads) {
      const int r = i / (FKS / 4), c = (i % (FKS / 4)) * 4;
      float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < p.M)
        u = *reinterpret_cast<const float4*>(x + (long long)(m0 + r) * p.K +
                                             j * FKS + c);
      *reinterpret_cast<float4*>(sX + r * FKS + c) = u;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < FKS; ++kk) {
      const float w = sW[kk * FBN + n];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        acc[r] = fmaf(sX[(mg * 8 + r) * FKS + kk], w, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int m = m0 + mg * 8 + r;
    if (m < p.M)
      static_cast<float*>(p.y)[(long long)m * p.N + n0 + n] =
          acc[r] * p.scale[n0 + n];
  }
}

template <int BN, bool kInt4, int MT>
cudaError_t launch_bf16(const Params& p, cudaStream_t st) {
  using P = Plan<BN, kInt4, MT>;
  if (p.K % (p.splits * P::KS) || p.N % BN) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      qmm_bf16<BN, kInt4, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::SMEM);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.N / BN, p.splits, (p.M + P::XROWS - 1) / P::XROWS);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = P::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, qmm_bf16<BN, kInt4, MT>, p);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int BN, bool kInt4>
cudaError_t launch_mt(const Params& p, int mt, cudaStream_t st) {
  switch (mt) {
    case 1: return launch_bf16<BN, kInt4, 1>(p, st);
    case 2: return launch_bf16<BN, kInt4, 2>(p, st);
    case 4: return launch_bf16<BN, kInt4, 4>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

// How many clusters of `splits` blocks of the body can be resident at once
// on the current device (cudaOccupancyMaxActiveClusters).
template <int BN, bool kInt4, int MT>
cudaError_t clusters_of(int splits, int* out) {
  using P = Plan<BN, kInt4, MT>;
  cudaError_t e = cudaFuncSetAttribute(
      qmm_bf16<BN, kInt4, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::SMEM);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, splits, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = P::SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, qmm_bf16<BN, kInt4, MT>, &cfg);
}

template <int BN, bool kInt4>
cudaError_t clusters_mt(int mt, int splits, int* out) {
  switch (mt) {
    case 1: return clusters_of<BN, kInt4, 1>(splits, out);
    case 2: return clusters_of<BN, kInt4, 2>(splits, out);
    case 4: return clusters_of<BN, kInt4, 4>(splits, out);
    default: return cudaErrorInvalidValue;
  }
}

template <int BN, bool kInt4, int MT>
cudaError_t plan_of(int* out) {
  using P = Plan<BN, kInt4, MT>;
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, qmm_bf16<BN, kInt4, MT>);
  if (e != cudaSuccess) return e;
  const int v[10] = {BN, P::KS, P::PIPES, P::STAGES, kThreads, P::SMEM,
                     fa.numRegs, (int)fa.localSizeBytes,
                     (int)fa.sharedSizeBytes, fa.maxThreadsPerBlock};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return cudaSuccess;
}

template <int BN, bool kInt4>
cudaError_t plan_mt(int mt, int* out) {
  switch (mt) {
    case 1: return plan_of<BN, kInt4, 1>(out);
    case 2: return plan_of<BN, kInt4, 2>(out);
    case 4: return plan_of<BN, kInt4, 4>(out);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// y [M, N] (x's dtype) = (x [M, K] @ dequant(w)) * scale [N].  dtype: 0 =
// float32, 1 = bfloat16 (x and y).  w is int8 [K, N], or with int4 packed
// [K / 2, N].  bf16: the launch plan from the wrapper, strips of bn (64 or
// 128) columns, `splits` (1-8) chunks of K (a cluster each strip; K must
// divide into chunks of a multiple of 256 rows), mt (1, 2 or 4) batch
// tiles of 8 a block.  f32 takes strips of 64 and one chunk (bn 64,
// splits 1).  x, w, scale, y 16-byte aligned, contiguous.  Returns a
// cudaError_t (0 = launched).
int quant_matmul(const void* x, const void* w, const float* scale, void* y,
                 int M, int K, int N, int bn, int splits, int mt, int int4,
                 int dtype, void* stream) {
  if (M == 0) return (int)cudaSuccess;
  if ((bn != 64 && bn != 128) || splits < 1 || splits > kMaxSplits ||
      K % 256 || N % bn)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x; p.w = static_cast<const int8_t*>(w); p.scale = scale; p.y = y;
  p.M = M; p.K = K; p.N = N; p.splits = splits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (bn != FBN || splits != 1) return (int)cudaErrorInvalidValue;
    const dim3 grid(N / FBN, 1, (M + FBM - 1) / FBM);
    if (int4) qmm_f32<true><<<grid, kF32Threads, 0, st>>>(p);
    else qmm_f32<false><<<grid, kF32Threads, 0, st>>>(p);
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (bn == 128)
    return (int)(int4 ? launch_mt<128, true>(p, mt, st)
                      : launch_mt<128, false>(p, mt, st));
  return (int)(int4 ? launch_mt<64, true>(p, mt, st)
                    : launch_mt<64, false>(p, mt, st));
}

// The bf16 body's plan for strips of bn columns, int4 or int8 and mt batch
// tiles, as compiled: out[0..9] = bn, k rows a stage, pipelines, stages
// a pipeline, threads a block, dynamic shared bytes, and from
// cudaFuncGetAttributes the body's
// registers a thread, local (spill) bytes, static shared bytes and largest
// block.
int quant_matmul_plan(int bn, int int4, int mt, int* out) {
  cudaError_t e;
  if (bn == 128) e = int4 ? plan_mt<128, true>(mt, out)
                          : plan_mt<128, false>(mt, out);
  else if (bn == 64) e = int4 ? plan_mt<64, true>(mt, out)
                              : plan_mt<64, false>(mt, out);
  else e = cudaErrorInvalidValue;
  return (int)e;
}

// The most clusters of `splits` (1-8) blocks of the bf16 body (strips of
// bn columns, int4 or int8, mt batch tiles) the current device holds at
// once, into *out.
int quant_matmul_max_clusters(int bn, int int4, int mt, int splits,
                              int* out) {
  if (splits < 1 || splits > kMaxSplits) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (bn == 128) e = int4 ? clusters_mt<128, true>(mt, splits, out)
                          : clusters_mt<128, false>(mt, splits, out);
  else if (bn == 64) e = int4 ? clusters_mt<64, true>(mt, splits, out)
                              : clusters_mt<64, false>(mt, splits, out);
  else e = cudaErrorInvalidValue;
  return (int)e;
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
