// Paged (block) KV-cache attention for Hopper (sm_90a): one split-K body
// (flash-decoding) for all four paged kernels.
//
//   K5  one query row, pages in q's dtype  replaces paddle_tpu/ops/pallas/
//       paged_attention.py::_kernel (:30, via paged_attention :232)
//   K6  one query row, int8 pages + scales replaces ::_kernel_q (:78)
//   K7  Q query rows, pages in q's dtype   replaces ::_kernel_mq (:191, via
//       _mq_step and paged_attention_multiquery :321)
//   K7q Q query rows, int8 pages + scales  replaces ::_kernel_mq_q (:201)
//
// Semantics (those of the TPU kernels): q [B, Q, H, D] (Q = 1 for K5 / K6,
// whose q is [B, H, D]; row j of sequence b sits at position
// context_lens[b] - 1 + j) against K/V pages [P, page, KVH, D] addressed by
// block_tables [B, S] (int32), with context_lens [B] (int32).  Row j sees
// tokens t < ctx + j, and never a token at or past S * page; no table entry
// past the last row's horizon min(ctx + Q - 1, S * page) is read.  Each kv
// head serves its G = H / KVH query heads, so a (sequence, kv head) pair
// has R = G * Q query rows (row r: position r / G of q head h * G + r % G).
// Online softmax in f32 with the finite NEG_INF = -1e30 mask; P is rounded
// to V's working dtype before the PV product; out = acc / max(l, 1e-30) in
// q's dtype, so a row that sees nothing returns 0, never NaN.  Int8 pages
// carry an f32 scale per (token, kv head), scales [P, page, KVH]; each int8
// value is dequantized as float(v) * scale and rounded to q's dtype before
// the products, as _kernel_q and _kernel_mq_q do.  Scores are kept in the
// log2 domain (q.k * scale * log2 e, then exp2), which is the natural-exp
// softmax.  head_dim: every multiple of 16 from 16 to 256.
//
// Bound.  Each call reads every K/V row that some row sees once (2 D bytes
// a token and kv head in bf16, D + 4 with int8 pages and their scales) and
// does 4 D flops a visible (row, token) pair: 4 * R / 2 flops a bf16 byte,
// 8 at decode (R = G = 4 at Llama-3-8B) and 64 at verify (R = 32), under
// the card's ~295 flop/byte ridge, so all four are bound by device-memory
// bytes (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W: decode 15.4 MB,
// 4.6 us for K5, 7.9 MB, 2.4 us for K6; verify 16.8 MB, 5.0 us for K7,
// 9.2 MB, 2.7 us for K7q).  At decode the bytes are few and the time is a
// chain of latencies (the sequence's length, its table entries, its tiles,
// a second launch), so what matters is how many blocks stream at once.
//
// Design: what a Hopper card needs to stream those bytes.
// 1. Split-K.  The TPU walks one sequence's pages in order; a block per
//    (sequence, kv head) gives 64 blocks on 132 SMs and lets the longest
//    sequence set the time (32 tiles one after another at 1024 tokens).
//    Here a block owns (split, kv head, sequence x row group of 32 rows): a
//    split is `split` tokens (a multiple of the page size and of the
//    32-token tile, chosen by the wrapper: 128 at page 16, so the decode and
//    verify shapes have 272 live blocks, two an SM, and the longest chain
//    is 4 tiles).  A block whose split starts at or past its sequence's
//    last horizon exits before it reads the table; the rest read their
//    split's table entries once into shared memory.  Each split writes its
//    rows' f32 (m, l, unnormalised acc [R, D]) to a workspace the wrapper
//    allocates; a second launch combines the splits of each row in split
//    order (no atomics: bitwise the same result run to run) and writes q's
//    dtype into q's layout.  A split no row sees contributes m = NEG_INF,
//    l = 0, acc = 0 and leaves the row unchanged.
// 2. A cp.async ring of kStages = 3 tiles of 32 tokens (K rows, V rows and,
//    for int8 pages, their scales) in shared memory.  Each token row is
//    addressed through the block table on its own, so any page size works;
//    rows past the split's last visible token are zero-filled, never read.
//    Int8 rows travel as int8 (half the bytes) and are dequantized on their
//    way from shared memory into the mma fragments, never staged as bf16:
//    four bytes a lane at a time, converted by byte permutes and a float
//    add (the conversion unit runs at an eighth of the FP32 rate), times
//    the token's scale in f32, rounded to bf16.
// 3. bf16 on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
//    accumulate).  wgmma takes 64-row tiles, far more than R here, and the
//    kernels are bound by bytes, not operations, so mma.sync is the
//    instrument.  A block holds MT m16 tiles of rows: one where R <= 16
//    (decode: G rows, the rest padding that costs nothing that matters),
//    two (32 rows) otherwise; padded rows are masked.  Warp w takes 16
//    tokens of every tile and one half of D for its m16 tiles: it forms
//    partial scores over its half, the two warps of a token group add
//    theirs through shared memory (a 64-thread named barrier), both run the
//    same online softmax on the f32 accumulator fragments, and each
//    accumulates P V for its half of the columns, with P rounded to bf16 in
//    registers and fed straight into the mma (the m16n8 accumulator layout
//    of two n-blocks is the m16k16 A layout).  So each K / V element is
//    read from shared memory, and dequantized, once.  q is held as bf16 A
//    fragments for the whole split; K's B fragments come from ldmatrix,
//    V's from ldmatrix.trans (rows padded by 16 bytes: conflict-free).  The
//    two token groups merge their (m, l, acc) through shared memory at the
//    end of the split.
// 4. float32 q (the f32 engine and the 2e-5 checks) runs in full f32 on
//    CUDA cores (TF32 would break 2e-5), on the same grid and ring: four
//    threads a row, each holding a quarter of q and of acc in registers.
// 5. Head dims.  The bodies are instantiated at DP = 64, 128, 192 and 256
//    columns, DP the next multiple of 64 above the real D (a multiple of
//    16): a half of DP is then whole 16-deep k steps and whole 32-column
//    groups of the int8 V permutation.  Where D is smaller (kPad), D comes
//    at run time; the pad columns of the ring are zero-filled by cp.async
//    without a read, q's pad is zero, so the pad adds nothing to the
//    scores, and the pad columns of acc are never written: the pad costs
//    arithmetic, never bytes.  Where D = DP (the engine's 64 and 128) it
//    is a compile-time constant: at run time the combine's index
//    arithmetic alone cost K7 / K7q 0.2 us (of 4.5) on the H100 (700 W).
// What it leaves: each live block waits two dependent reads (its length,
// then its table entries) before its first K/V request, and the combine is
// a second launch.  A persistent grid over (split, kv head) pairs and a
// TMA ring would attack the first.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr int kTile = 32;      // tokens a ring stage holds
constexpr int kStages = 3;     // ring depth
constexpr int kPad = 16;       // bytes of padding a staged row
constexpr int kBlockRows = 32; // query rows a block at most (two m16 tiles)
constexpr int kMaxPages = 128; // table entries a split may span

struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const float* ks;          // int8 pages: [P, page, KVH]
  const float* vs;
  const int* bt;            // [B, S]
  const int* cl;            // [B]
  float* ws_acc;            // [B, KVH, NS, R, D]
  float* ws_ml;             // [B, KVH, NS, R, 2]: m (log2 domain), l
  void* out;                // q's layout
  int Q, H, KVH, D, page, S, split, NS, nrg;
  float scale_log2;         // softmax scale * log2(e)
};

// The ring: per stage K rows [kTile][Row], V rows [kTile][Row], then the
// K and V scales [kTile] each (int8 pages only, space kept regardless).  A
// staged row holds DP columns; those past the real D are zero-filled.
template <typename PT, int DP>
struct Ring {
  static constexpr int kRow = DP * (int)sizeof(PT) + kPad;
  static constexpr int kChunks = DP * (int)sizeof(PT) / 16;
  static constexpr int kStage = 2 * kTile * kRow + 2 * kTile * 4;
  static constexpr bool kQuant = sizeof(PT) == 1;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; zero-filled, with no
// read, when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The split's table entries, pages s0 / page on, up to the one holding
// token s1 - 1 (no entry past the last horizon), into pg: one round of
// loads instead of one a staged row.
__device__ __forceinline__ void load_pages(int* pg, const Args& a, int b,
                                           int s0, int s1, int tid, int nt) {
  const int p0 = s0 / a.page, n = s1 > s0 ? (s1 - 1) / a.page - p0 + 1 : 0;
  const int* bt_row = a.bt + (size_t)b * a.S + p0;
  for (int i = tid; i < n; i += nt) pg[i] = bt_row[i];
  __syncthreads();
}

// Stage the 32 tokens t0 .. t0 + 31 of kv head h (those at or past t_lim,
// and every row's columns past D, zero-filled); pg holds the split's
// pages, from token s0 on.
template <typename PT, int DP, bool kPad>
__device__ __forceinline__ void issue(unsigned char* st, const Args& a,
                                      const int* pg, int s0, int t0,
                                      int t_lim, int h, int tid, int nt) {
  using Rg = Ring<PT, DP>;
  const char* kp = static_cast<const char*>(a.kp);
  const char* vp = static_cast<const char*>(a.vp);
  const int D = kPad ? a.D : DP;
  const int nc = D * (int)sizeof(PT) / 16;     // chunks of a real row
  for (int i = tid; i < kTile * Rg::kChunks; i += nt) {
    const int j = i / Rg::kChunks, c = i % Rg::kChunks;
    const int t = t0 + j;
    const bool ok = t < t_lim && c < nc;
    size_t off = 0;
    if (ok) {
      const int u = t - s0;
      const size_t slot = (size_t)pg[u / a.page] * a.page + u % a.page;
      off = ((slot * a.KVH + h) * D) * sizeof(PT) + (size_t)c * 16;
    }
    cp_async16(st + j * Rg::kRow + c * 16, kp + off, ok);
    cp_async16(st + (kTile + j) * Rg::kRow + c * 16, vp + off, ok);
  }
  if constexpr (Rg::kQuant) {
    float* sc = reinterpret_cast<float*>(st + 2 * kTile * Rg::kRow);
    for (int j = tid; j < kTile; j += nt) {
      const int t = t0 + j;
      const bool ok = t < t_lim;
      const int u = t - s0;
      size_t off = 0;
      if (ok) off = ((size_t)pg[u / a.page] * a.page + u % a.page) * a.KVH + h;
      cp_async4(sc + j, a.ks + off, ok);
      cp_async4(sc + kTile + j, a.vs + off, ok);
    }
  }
}

// Row r of a (sequence b, kv head h) pair in q / out [B, Q, H, D]
__device__ __forceinline__ size_t row_off(int b, int r, int h, int G,
                                          const Args& a, int D) {
  return (((size_t)b * a.Q + r / G) * a.H + (size_t)h * G + r % G) * D;
}

// ---------------------------------------------------------------- combine
template <typename T> struct Out;
template <> struct Out<float> {
  __device__ __forceinline__ static void store4(float* o, float4 v) {
    *reinterpret_cast<float4*>(o) = v;
  }
};
template <> struct Out<bf16> {
  __device__ __forceinline__ static void store4(bf16* o, float4 v) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(o) = u;
  }
};

// The combine: block (chunk of 128 (row, float4 column) pairs, kv head h,
// sequence b), one float4 column of one row a thread.  The ns live splits
// of each row in split order: out = sum_s acc_s 2^(m_s - M) /
// max(sum_s l_s 2^(m_s - M), 1e-30) with M the largest m_s.  Eight splits'
// loads in flight at a time.
template <typename T, int DP, bool kPad>
__global__ void __launch_bounds__(128) paged_combine(const Args a) {
  const int D = kPad ? a.D : DP;
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KVH, R = G * a.Q, C4 = D / 4;
  const int i = blockIdx.x * 128 + threadIdx.x;
  if (i >= R * C4) return;
  const int r = i / C4, c4 = i % C4;
  const int t_end = max(0, min(a.cl[b] + a.Q - 1, a.S * a.page));
  const int ns = max(1, (t_end + a.split - 1) / a.split);
  const size_t base = ((size_t)b * a.KVH + h) * a.NS * R + r;
  const float* ml = a.ws_ml + base * 2;
  float M = kNegInf;
  for (int s0 = 0; s0 < ns; s0 += 8) {
#pragma unroll
    for (int s = s0; s < s0 + 8; ++s)
      if (s < ns) M = fmaxf(M, ml[(size_t)s * R * 2]);
  }
  float L = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < ns; s0 += 8) {
#pragma unroll
    for (int s = s0; s < s0 + 8; ++s) {
      if (s < ns) {
        const size_t row = base + (size_t)s * R;
        const float w = exp2f(a.ws_ml[row * 2] - M);
        const float4 v =
            reinterpret_cast<const float4*>(a.ws_acc + row * D)[c4];
        L = fmaf(a.ws_ml[row * 2 + 1], w, L);
        acc.x = fmaf(v.x, w, acc.x);
        acc.y = fmaf(v.y, w, acc.y);
        acc.z = fmaf(v.z, w, acc.z);
        acc.w = fmaf(v.w, w, acc.w);
      }
    }
  }
  L = fmaxf(L, 1e-30f);
  Out<T>::store4(static_cast<T*>(a.out) + row_off(b, r, h, G, a, D) + c4 * 4,
                 make_float4(acc.x / L, acc.y / L, acc.z / L, acc.w / L));
}

// ---------------------------------------------------------------- bf16 q
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Four int8 values (one 32-bit word) as exact floats, without the
// conversion unit (an eighth of the FP32 rate on Hopper): each byte, biased
// to u = x + 128, becomes the mantissa of 2^23 + u.
__device__ __forceinline__ void i8x4(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

// The split kernel, bf16 q.  Block (split, kv head h, b * nrg + row group
// rg): the 16 MT rows 16 MT rg .. (MT m16 tiles), 4 warps.  Warp w owns
// tokens 16 (w / 2) .. + 15 of every ring tile (its token group) and
// columns DH (w % 2) .. + DH - 1, DH = DP / 2 (its half), for its m16
// tiles: it forms partial scores over its half of q K^T, the two warps of
// a token group add their partials through shared memory, both take the
// same softmax, and each accumulates P V for its half of the columns.  So
// every K / V element is read (and, for int8 pages, dequantized) once.
//
// Fragment layouts.  Pages in q's dtype take the standard ones: K's B
// fragments by ldmatrix, V's by ldmatrix.trans, column d of acc's n-block
// nb at nb * 8 + d.  Int8 pages permute what a dot product leaves free, so
// that every lane reads whole 32-bit words of int8 values: in k step kc,
// lane quad tq takes q's and K's columns kc * 16 + 4 tq .. + 3 for its k
// slots 2 tq, 2 tq + 1, 2 tq + 8, 2 tq + 9; and P V's n slot j of n-block
// nb is V's column 32 (nb / 4) + 4 j + nb % 4, so lane group gq reads V's
// columns 32 g + 4 gq .. + 3 of four n-blocks in one word.
template <typename PT, int DP, int MT, bool kPad>
__global__ void __launch_bounds__(128) paged_split_bf16(const Args a) {
  using Rg = Ring<PT, DP>;
  constexpr bool kQuant = Rg::kQuant;
  constexpr int DH = DP / 2, KC = DH / 16, NB = DH / 8;
  const int D = kPad ? a.D : DP;
  const int split = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / a.nrg, rg = blockIdx.z % a.nrg;
  const int ctx = a.cl[b];
  const int t_cap = a.S * a.page;
  const int t_end = max(0, min(ctx + a.Q - 1, t_cap));
  // live splits start before t_end; split 0 always lives, so that a
  // sequence no row sees still gets its zeros written
  const int ns = max(1, (t_end + a.split - 1) / a.split);
  if (split >= ns) return;
  const int s0 = split * a.split, s1 = min(s0 + a.split, t_end);
  const int n_tiles = max(0, (s1 - s0 + kTile - 1) / kTile);
  const int G = a.H / a.KVH, R = G * a.Q;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int tg = warp >> 1, hf = warp & 1, c0 = hf * DH;
  const int r0 = rg * 16 * MT;
  const bool two = MT == 2 && r0 + 16 < R;  // the second m16 tile has rows
  // rows r0 + 16 m + gq (+ 8): their horizons, [m][lo / hi]
  int hz[MT][2];
  int hzw = 0;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = r0 + 16 * m + 8 * x + gq;
      hz[m][x] = r < R ? min(ctx + r / G, t_cap) : 0;
      hzw = max(hzw, hz[m][x]);
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)         // the block's last horizon
    hzw = max(hzw, __shfl_xor_sync(0xffffffffu, hzw, o));

  // q's A fragments for the warp's half, its m16 tiles, held for the whole
  // split (loads in flight with the table's); columns past D are zero
  const bf16* q = static_cast<const bf16*>(a.q);
  uint32_t qf[MT][KC][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int rlo = r0 + 16 * m + gq, rhi = rlo + 8;
    const bf16* qlo = q + (rlo < R ? row_off(b, rlo, h, G, a, D) : 0) + c0;
    const bf16* qhi = q + (rhi < R ? row_off(b, rhi, h, G, a, D) : 0) + c0;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const int c = kc * 16 + (kQuant ? 4 * tq : 2 * tq);
      const int c2 = kQuant ? c + 2 : c + 8;
      const bool in = c0 + c < D, in2 = c0 + c2 < D;
      qf[m][kc][0] = rlo < R && in ? *reinterpret_cast<const uint32_t*>(qlo + c) : 0u;
      qf[m][kc][1] = rhi < R && in ? *reinterpret_cast<const uint32_t*>(qhi + c) : 0u;
      qf[m][kc][2] = rlo < R && in2 ? *reinterpret_cast<const uint32_t*>(qlo + c2) : 0u;
      qf[m][kc][3] = rhi < R && in2 ? *reinterpret_cast<const uint32_t*>(qhi + c2) : 0u;
    }
  }

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int pg[kMaxPages];
  __shared__ float xch[4][8 * MT][32];     // partial scores, by warp
  load_pages(pg, a, b, s0, s1, tid, nt);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles)
      issue<PT, DP, kPad>(smem + i * Rg::kStage, a, pg, s0, s0 + i * kTile,
                          s1, h, tid, nt);
    cp_commit();
  }
  float acc[MT][NB][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      acc[m][nb][0] = acc[m][nb][1] = acc[m][nb][2] = acc[m][nb][3] = 0.f;
  float mrow[MT][2], lrow[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    mrow[m][0] = mrow[m][1] = kNegInf;
    lrow[m][0] = lrow[m][1] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int nx = i + kStages - 1;
    if (nx < n_tiles)
      issue<PT, DP, kPad>(smem + (nx % kStages) * Rg::kStage, a, pg, s0,
                          s0 + nx * kTile, s1, h, tid, nt);
    cp_commit();
    cp_wait<kStages - 1>();
    __syncthreads();
    const int tb = s0 + i * kTile + tg * 16;    // this warp's 16 tokens
    if (tb < hzw) {
      const unsigned char* st = smem + (i % kStages) * Rg::kStage;
      const unsigned char* k16 = st + tg * 16 * Rg::kRow;
      const unsigned char* v16 = st + (kTile + tg * 16) * Rg::kRow;
      const float* ksc =
          reinterpret_cast<const float*>(st + 2 * kTile * Rg::kRow) +
          tg * 16;
      const float* vsc = ksc + kTile;
      // ---- partial S = q K^T over the warp's columns, [m][nb]
      float s[MT][2][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
          s[m][nb][0] = s[m][nb][1] = s[m][nb][2] = s[m][nb][3] = 0.f;
      const float ks0 = kQuant ? ksc[gq] : 0.f;
      const float ks1 = kQuant ? ksc[8 + gq] : 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t bk[2][2];
        if constexpr (!kQuant) {
          const int mat = lane >> 3, rr = lane & 7;
          uint32_t r4[4];
          ldsm_x4(r4, k16 + ((mat >> 1) * 8 + rr) * Rg::kRow +
                          (c0 + kc * 16 + (mat & 1) * 8) * 2);
          bk[0][0] = r4[0]; bk[0][1] = r4[1]; bk[1][0] = r4[2]; bk[1][1] = r4[3];
        } else {
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) {
            float f[4];
            i8x4(*reinterpret_cast<const uint32_t*>(
                     k16 + (nb * 8 + gq) * Rg::kRow + c0 + kc * 16 + 4 * tq),
                 f);
            const float sc = nb ? ks1 : ks0;
            bk[nb][0] = pack_bf16(f[0] * sc, f[1] * sc);
            bk[nb][1] = pack_bf16(f[2] * sc, f[3] * sc);
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
          if (m == 0 || two) {
            mma_bf16(s[m][0], qf[m][kc], bk[0][0], bk[0][1]);
            mma_bf16(s[m][1], qf[m][kc], bk[1][0], bk[1][1]);
          }
      }
      // ---- the two halves' partials summed: own + partner's
      float* mine = &xch[warp][0][lane];
      const float* other = &xch[warp ^ 1][0][lane];
#pragma unroll
      for (int e = 0; e < 8 * MT; ++e) mine[e * 32] = s[e >> 3][(e >> 2) & 1][e & 3];
      asm volatile("bar.sync %0, 64;\n" ::"r"(1 + tg));
#pragma unroll
      for (int e = 0; e < 8 * MT; ++e) s[e >> 3][(e >> 2) & 1][e & 3] += other[e * 32];
      // ---- mask, online softmax: row set (m, x), x = 0 (e 0, 1) or 8 (e 2, 3)
      uint32_t pa[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          bool vis[2][2];
          float mx = mrow[m][x];
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              vis[nb][e] = tb + nb * 8 + 2 * tq + e < hz[m][x];
              const float sv = s[m][nb][2 * x + e] * a.scale_log2;
              s[m][nb][2 * x + e] = sv;
              if (vis[nb][e]) mx = fmaxf(mx, sv);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float corr = exp2f(mrow[m][x] - mx);
          mrow[m][x] = mx;
          float sum = 0.f;
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p =
                  vis[nb][e] ? exp2f(s[m][nb][2 * x + e] - mx) : 0.f;
              s[m][nb][2 * x + e] = p;
              sum += p;
            }
          lrow[m][x] = lrow[m][x] * corr + sum;  // this lane's tokens
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            acc[m][nb][2 * x] *= corr;
            acc[m][nb][2 * x + 1] *= corr;
          }
        }
        // P rounded to bf16 in registers: the m16k16 A fragment
        pa[m][0] = pack_bf16(s[m][0][0], s[m][0][1]);
        pa[m][1] = pack_bf16(s[m][0][2], s[m][0][3]);
        pa[m][2] = pack_bf16(s[m][1][0], s[m][1][1]);
        pa[m][3] = pack_bf16(s[m][1][2], s[m][1][3]);
      }
      // ---- acc += P V over the warp's columns
      if constexpr (!kQuant) {
        const int mat = lane >> 3, rr = lane & 7;
        const unsigned char* vrow = v16 + ((mat & 1) * 8 + rr) * Rg::kRow +
                                    c0 * 2 + (mat >> 1) * 16;
#pragma unroll
        for (int n2 = 0; n2 < NB / 2; ++n2) {
          uint32_t r4[4];
          ldsm_x4_t(r4, vrow + n2 * 32);
#pragma unroll
          for (int m = 0; m < MT; ++m)
            if (m == 0 || two) {
              mma_bf16(acc[m][2 * n2], pa[m], r4[0], r4[1]);
              mma_bf16(acc[m][2 * n2 + 1], pa[m], r4[2], r4[3]);
            }
        }
      } else {
        // tokens 2 tq, 2 tq + 1, 2 tq + 8, 2 tq + 9 (P's k slots) and
        // their scales
        const float vsx[4] = {vsc[2 * tq], vsc[2 * tq + 1], vsc[2 * tq + 8],
                              vsc[2 * tq + 9]};
        const unsigned char* vr[4] = {
            v16 + (2 * tq) * Rg::kRow + c0, v16 + (2 * tq + 1) * Rg::kRow + c0,
            v16 + (2 * tq + 8) * Rg::kRow + c0,
            v16 + (2 * tq + 9) * Rg::kRow + c0};
#pragma unroll
        for (int g4 = 0; g4 < DH / 32; ++g4) {
          float f[4][4];                       // [token][n-block % 4]
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            i8x4(*reinterpret_cast<const uint32_t*>(vr[x] + g4 * 32 + 4 * gq),
                 f[x]);
#pragma unroll
            for (int y = 0; y < 4; ++y) f[x][y] *= vsx[x];
          }
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            const uint32_t b0 = pack_bf16(f[0][y], f[1][y]);
            const uint32_t b1 = pack_bf16(f[2][y], f[3][y]);
#pragma unroll
            for (int m = 0; m < MT; ++m)
              if (m == 0 || two) mma_bf16(acc[m][4 * g4 + y], pa[m], b0, b1);
          }
        }
      }
    }
    __syncthreads();                     // the stage is free for reuse
  }

  // ---- merge the two token groups through shared memory (group 1 hands
  // its state to group 0, half by half), then write the split's (m, l,
  // acc) rows to the workspace, the real D columns only
  cp_wait<0>();
  __syncthreads();
  constexpr int kA = MT * NB * 4;          // acc floats a lane hands over
  constexpr int kX = kA + 4 * MT;          // with its m and l
  float* xs = reinterpret_cast<float*>(smem) + (size_t)hf * kX * 32 + lane;
  if (tg == 1) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) xs[((m * NB + nb) * 4 + e) * 32] = acc[m][nb][e];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        xs[(kA + m * 2 + x) * 32] = mrow[m][x];
        xs[(kA + 2 * MT + m * 2 + x) * 32] = lrow[m][x];
      }
    }
  }
  __syncthreads();
  if (tg != 0) return;
  const size_t base = (((size_t)b * a.KVH + h) * a.NS + split) * R;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const float m1 = xs[(kA + m * 2 + x) * 32];
      const float mx = fmaxf(mrow[m][x], m1);
      const float w0 = exp2f(mrow[m][x] - mx), w1 = exp2f(m1 - mx);
      float lr = lrow[m][x] * w0 + xs[(kA + 2 * MT + m * 2 + x) * 32] * w1;
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          acc[m][nb][2 * x + e] = acc[m][nb][2 * x + e] * w0 +
                                  xs[((m * NB + nb) * 4 + 2 * x + e) * 32] * w1;
      const int row = r0 + 16 * m + 8 * x + gq;
      if (row >= R) continue;
      float* wa = a.ws_acc + (base + row) * D + c0;
      if constexpr (!kQuant) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          if (c0 + nb * 8 + 2 * tq < D)
            *reinterpret_cast<float2*>(wa + nb * 8 + 2 * tq) =
                make_float2(acc[m][nb][2 * x], acc[m][nb][2 * x + 1]);
      } else {                           // n slot j of n-block 4 g + y:
#pragma unroll                           // column 32 g + 4 j + y
        for (int g4 = 0; g4 < DH / 32; ++g4)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (c0 + g4 * 32 + (2 * tq + e) * 4 < D)
              *reinterpret_cast<float4*>(wa + g4 * 32 + (2 * tq + e) * 4) =
                  make_float4(acc[m][4 * g4][2 * x + e],
                              acc[m][4 * g4 + 1][2 * x + e],
                              acc[m][4 * g4 + 2][2 * x + e],
                              acc[m][4 * g4 + 3][2 * x + e]);
      }
      if (hf == 0 && tq == 0) {
        a.ws_ml[(base + row) * 2] = mx;
        a.ws_ml[(base + row) * 2 + 1] = lr;
      }
    }
}

// ---------------------------------------------------------------- f32 q
// Block (split, kv head h, b * nrg + row group): 128 threads, four a row
// (32 rows); thread quarter qt owns the float4 chunks qt, qt + 4, ... of
// q's and acc's DP columns, in registers (those past D hold zeros).
template <typename PT>
__device__ __forceinline__ float4 row4(const unsigned char* row, int c,
                                       float sc) {
  if constexpr (sizeof(PT) == 4) {
    return reinterpret_cast<const float4*>(row)[c];
  } else {
    const char4 v = reinterpret_cast<const char4*>(row)[c];
    return make_float4(v.x * sc, v.y * sc, v.z * sc, v.w * sc);
  }
}

template <typename PT, int DP, bool kPad>
__global__ void __launch_bounds__(4 * kBlockRows) paged_split_f32(const Args a) {
  using Rg = Ring<PT, DP>;
  constexpr int kC = DP / 16;              // float4 chunks a thread owns
  const int D = kPad ? a.D : DP;
  const int split = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / a.nrg, rg = blockIdx.z % a.nrg;
  const int ctx = a.cl[b];
  const int t_cap = a.S * a.page;
  const int t_end = max(0, min(ctx + a.Q - 1, t_cap));
  const int ns = max(1, (t_end + a.split - 1) / a.split);
  if (split >= ns) return;
  const int s0 = split * a.split, s1 = min(s0 + a.split, t_end);
  const int n_tiles = max(0, (s1 - s0 + kTile - 1) / kTile);
  const int G = a.H / a.KVH, R = G * a.Q;
  const int tid = threadIdx.x, nt = blockDim.x, qt = tid & 3;
  const int r = rg * kBlockRows + (tid >> 2);
  const bool live = r < R;
  const int hz = live ? min(ctx + r / G, t_cap) : 0;

  float qr[kC][4], acc[kC][4];
  {
    const float4* qp = reinterpret_cast<const float4*>(
        static_cast<const float*>(a.q) + (live ? row_off(b, r, h, G, a, D) : 0));
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float4 v = live && (c * 4 + qt) * 4 < D
                           ? qp[c * 4 + qt] : make_float4(0.f, 0.f, 0.f, 0.f);
      qr[c][0] = v.x; qr[c][1] = v.y; qr[c][2] = v.z; qr[c][3] = v.w;
      acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
    }
  }
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int pg[kMaxPages];
  load_pages(pg, a, b, s0, s1, tid, nt);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles)
      issue<PT, DP, kPad>(smem + i * Rg::kStage, a, pg, s0, s0 + i * kTile,
                          s1, h, tid, nt);
    cp_commit();
  }
  float m = kNegInf, l = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int nx = i + kStages - 1;
    if (nx < n_tiles)
      issue<PT, DP, kPad>(smem + (nx % kStages) * Rg::kStage, a, pg, s0,
                          s0 + nx * kTile, s1, h, tid, nt);
    cp_commit();
    cp_wait<kStages - 1>();
    __syncthreads();
    const int t0 = s0 + i * kTile;
    const unsigned char* st = smem + (i % kStages) * Rg::kStage;
    const float* ksc = reinterpret_cast<const float*>(st + 2 * kTile * Rg::kRow);
    const float* vsc = ksc + kTile;
    float s[kTile];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const unsigned char* kr = st + j * Rg::kRow;
      const float sc = Rg::kQuant ? ksc[j] : 1.f;
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float4 kv = row4<PT>(kr, c * 4 + qt, sc);
        part = fmaf(qr[c][0], kv.x, part);
        part = fmaf(qr[c][1], kv.y, part);
        part = fmaf(qr[c][2], kv.z, part);
        part = fmaf(qr[c][3], kv.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      s[j] = part * a.scale_log2;
      if (t0 + j < hz) mx = fmaxf(mx, s[j]);
    }
    const float corr = exp2f(m - mx);
    m = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      s[j] = t0 + j < hz ? exp2f(s[j] - mx) : 0.f;
      sum += s[j];
    }
    l = l * corr + sum;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] *= corr;
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const unsigned char* vr = st + (kTile + j) * Rg::kRow;
      const float sc = Rg::kQuant ? vsc[j] : 1.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float4 vv = row4<PT>(vr, c * 4 + qt, sc);
        acc[c][0] = fmaf(s[j], vv.x, acc[c][0]);
        acc[c][1] = fmaf(s[j], vv.y, acc[c][1]);
        acc[c][2] = fmaf(s[j], vv.z, acc[c][2]);
        acc[c][3] = fmaf(s[j], vv.w, acc[c][3]);
      }
    }
    __syncthreads();
  }
  cp_wait<0>();
  if (live) {                              // the split's row to the workspace
    const size_t row = (((size_t)b * a.KVH + h) * a.NS + split) * R + r;
    float4* wa = reinterpret_cast<float4*>(a.ws_acc + row * D);
#pragma unroll
    for (int c = 0; c < kC; ++c)
      if ((c * 4 + qt) * 4 < D)
        wa[c * 4 + qt] = make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
    if (qt == 0) {
      a.ws_ml[row * 2] = m;
      a.ws_ml[row * 2 + 1] = l;
    }
  }
}

// ------------------------------------------------------------------ launch
template <typename PT, int DP, int MT>
constexpr size_t smem_bytes() {
  // the ring, or the bf16 merge's hand-over area if that is larger
  constexpr size_t ring = (size_t)kStages * Ring<PT, DP>::kStage;
  constexpr size_t merge = (size_t)2 * (MT * DP / 4 + 4 * MT) * 32 * 4;
  return ring > merge ? ring : merge;
}

// the static shared memory a split block holds at most (its table entries
// and the partial-score exchange): with the dynamic part it must fit the
// 48 KB a launch may take unless the kernel's attribute allows more
constexpr size_t kStaticSmem = kMaxPages * 4 + 4 * 16 * 32 * 4;

template <typename K>
cudaError_t set_smem(K kern, size_t smem) {
  if (smem + kStaticSmem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, typename PT, int DP, bool kPad>
cudaError_t launch(Args a, int B, int R, cudaStream_t st) {
  cudaError_t e;
  a.nrg = (R + kBlockRows - 1) / kBlockRows;
  const dim3 grid(a.NS, a.KVH, B * a.nrg);
  if constexpr (sizeof(T) == 2) {
    if (R <= 16) {                         // one m16 tile of rows
      const size_t smem = smem_bytes<PT, DP, 1>();
      e = set_smem(paged_split_bf16<PT, DP, 1, kPad>, smem);
      if (e != cudaSuccess) return e;
      paged_split_bf16<PT, DP, 1, kPad><<<grid, 128, smem, st>>>(a);
    } else {
      const size_t smem = smem_bytes<PT, DP, 2>();
      e = set_smem(paged_split_bf16<PT, DP, 2, kPad>, smem);
      if (e != cudaSuccess) return e;
      paged_split_bf16<PT, DP, 2, kPad><<<grid, 128, smem, st>>>(a);
    }
  } else {
    const size_t smem = smem_bytes<PT, DP, 1>();
    e = set_smem(paged_split_f32<PT, DP, kPad>, smem);
    if (e != cudaSuccess) return e;
    paged_split_f32<PT, DP, kPad><<<grid, 128, smem, st>>>(a);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  paged_combine<T, DP, kPad>
      <<<dim3((R * (a.D / 4) + 127) / 128, a.KVH, B), 128, 0, st>>>(a);
  return cudaGetLastError();
}

// D at its instantiated width (compile-time), or padded to it (run time)
template <typename T, typename PT, int DP>
cudaError_t launch_w(const Args& a, int B, int R, cudaStream_t st) {
  return a.D == DP ? launch<T, PT, DP, false>(a, B, R, st)
                   : launch<T, PT, DP, true>(a, B, R, st);
}

// the instantiated width for head_dim D: the next multiple of 64
inline int padded(int D) { return (D + 63) / 64 * 64; }

template <typename T, typename PT>
cudaError_t launch_d(const Args& a, int B, int R, cudaStream_t st) {
  switch (padded(a.D)) {
    case 64: return launch_w<T, PT, 64>(a, B, R, st);
    case 128: return launch_w<T, PT, 128>(a, B, R, st);
    case 192: return launch_w<T, PT, 192>(a, B, R, st);
    case 256: return launch_w<T, PT, 256>(a, B, R, st);
  }
  return cudaErrorInvalidValue;
}

inline bool head_dim_ok(int D) { return D >= 16 && D <= 256 && D % 16 == 0; }

}  // namespace

extern "C" {

// q [B, Q, H, D] (K5 / K6: Q = 1, q [B, H, D]) and out alike; pages
// [P, page, KVH, D] in q's dtype (quant = 0) or int8 with f32 scales
// [P, page, KVH] (quant = 1); workspace: f32, B * KVH * NS * R * (D + 2)
// floats with R = (H / KVH) * Q and NS = ceil(S * page / split), split a
// multiple of 32 and of the page size, at most 128 pages.  dtype (q's):
// 0 = float32, 1 = bfloat16.  D: a multiple of 16 from 16 to 256.  Two
// launches on `stream`: the splits, then their combine.
// Returns a cudaError_t (0 = launched).
int paged_attention_fwd(const void* q, const void* k_pages,
                        const void* v_pages, const void* k_scales,
                        const void* v_scales, const void* block_tables,
                        const void* context_lens, void* workspace, void* out,
                        int B, int Q, int H, int KVH, int D, int page_size,
                        int S, int split, int NS, float scale, int dtype,
                        int quant, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (KVH <= 0 || H % KVH != 0 || page_size <= 0 || Q <= 0 || S <= 0 ||
      !head_dim_ok(D) || split <= 0 || split % kTile != 0 ||
      split % page_size != 0 || split / page_size > kMaxPages ||
      NS != (S * page_size + split - 1) / split)
    return (int)cudaErrorInvalidValue;
  if (quant && (k_scales == nullptr || v_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  const int R = (H / KVH) * Q;
  Args a;
  a.q = q; a.kp = k_pages; a.vp = v_pages;
  a.ks = static_cast<const float*>(k_scales);
  a.vs = static_cast<const float*>(v_scales);
  a.bt = static_cast<const int*>(block_tables);
  a.cl = static_cast<const int*>(context_lens);
  a.ws_acc = static_cast<float*>(workspace);
  a.ws_ml = a.ws_acc + (size_t)B * KVH * NS * R * D;
  a.out = out;
  a.Q = Q; a.H = H; a.KVH = KVH; a.D = D; a.page = page_size; a.S = S;
  a.split = split; a.NS = NS; a.nrg = 1;
  a.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !quant) return (int)launch_d<float, float>(a, B, R, st);
  if (dtype == 0 && quant) return (int)launch_d<float, int8_t>(a, B, R, st);
  if (dtype == 1 && !quant) return (int)launch_d<bf16, bf16>(a, B, R, st);
  if (dtype == 1 && quant) return (int)launch_d<bf16, int8_t>(a, B, R, st);
  return (int)cudaErrorInvalidValue;
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
