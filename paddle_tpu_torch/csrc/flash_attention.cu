// Flash attention for Hopper (sm_90a): the forward (K1) and the two
// backward kernels (K2: dQ, K3: dK / dV) of training, and their
// layout-direct twins (K4).
//
//   K1  fwd_bf16 / fwd_f32  replaces paddle_tpu/ops/pallas/flash_attention.py
//       ::_fwd_kernel (launched by _flash_fwd)
//   K2  dq_bf16 / dq_f32    replaces ::_dq_kernel (launched by _flash_bwd)
//   K3  dkv_bf16 / dkv_f32  replaces ::_dkv_kernel (launched by _flash_bwd)
//   K4  the same three bodies instantiated with kDirect = true replace
//       ::_bshd_fwd_kernel (launched by _bshd_fwd), ::_bshd_dq_kernel and
//       ::_bshd_dkv_kernel (launched by _bshd_bwd): the
//       FLAGS_flash_layout_direct path, MHA only (the wrapper routes).
//
// Semantics (those of the TPU kernels).  q [B, Sq, H, D], k / v
// [B, Sk, Hk, D], H % Hk == 0: query head h reads kv head h / (H / Hk)
// (GQA), and K / V are never repeated.  K1-K3: q is pre-scaled by scale *
// log2(e) and rounded to q's dtype, so scores live in the log2 domain and
// the softmax uses exp2.  K4 (kDirect): scores come from the unscaled q and
// k and are multiplied by scale * log2(e) in f32, i.e. the TPU's f32 `s *
// scale` followed by a natural exp computed as exp2(x * log2 e) with the
// two multiplies folded into one.  Softmax statistics and every
// accumulation are f32; the finite NEG_INF = -1e30 masks scores above the
// causal diagonal (row >= col visible); l is clamped at 1e-30.  The forward
// writes O in q's dtype and the natural-log LSE [B * H, Sq] f32 (not the
// TPU's 128-lane broadcast).  The backward recomputes P from the LSE, dP =
// dO V^T, delta = rowsum(dO * O), dS = P (dP - delta); dQ = dS K * scale,
// dK = dS^T q * scale (unscaled q), dV = P^T dO, each summed in f32 and
// written in its input's dtype.  P is rounded to V's (dO's) dtype before
// P V (P^T dO), and dS to K's (q's) dtype before dS K (dS^T q), as the TPU
// kernels round them.  The TPU's K4 recomputes delta in both backward
// bodies; here, as for K2 / K3, the dQ body stores it and dK / dV reads it,
// which changes no result.
//
// Design.  The TPU grids walk their sequential axis in order, carrying
// m / l / acc (or dq, dk, dv) in VMEM from one grid step to the next;
// Hopper blocks run in parallel and in no order, so the sequential axis
// becomes a loop inside each block and nothing crosses blocks:
//   K1, K2: one block per (b * H + h, q tile), looping over the k tiles
//           that reach it;
//   K3:     one block per (b * Hk + hk, k tile), looping over the group's
//           rep = H / Hk query heads x the q tiles that reach it, so dK and
//           dV sum over the whole GQA group in registers, with no atomics.
// Causal: tiles wholly above the diagonal are skipped (the loops stop, or
// start, at it), and only tiles that cross it are masked.  q / k / v / o /
// dO are read in place as [B, S, H, D] through their strides (a row
// stride of H * D, or 3 * H * D for a fused qkv projection), so the
// wrapper makes no [B * H, S, D] copies; outputs are written contiguous.
// That is already K4's whole point on the TPU (no relayout), so K4 differs
// from K1-K3 in numerics only, and its TPU tiles (bq, bk, hb) do not apply.
// K2 computes delta for its q tile (as _dq_kernel does) and also stores it,
// [B * H, Sq] f32, so K3 reads it instead of reading O again.
//
// bf16 runs on the tensor cores: mma.sync m16n8k16 (bf16 x bf16 -> f32),
// each warp owning 16 rows (K1, K2: queries; K3: keys).  The products whose
// A operand is a score tile (P V, dS K, P^T dO, dS^T q) take it straight
// from the accumulator registers of the product before (the m16n8 C layout
// of two n-blocks is the m16k16 A layout), so the score tiles never touch
// shared memory.  Tiles are staged in shared memory with 16-byte loads;
// rows are padded by 16 bytes so every fragment load is free of bank
// conflicts.  Fixed Hopper tiles (no autotune), four warps a block except
// K3 above D = 128:
//   K1: 64 q rows x 64 keys (x 32 keys above D = 192);
//   K2: 64 q rows x 64 keys (D = 64) or x 32 keys (D >= 128);
//   K3: 64 keys x 64 q rows (D = 64), x 32 q rows (D 128 - 256) or x 16
//       q rows (above 256).
// Registers set the tiles: a warp's 16-row f32 accumulator is D / 2
// registers a thread (128 at D = 256), of 255.  Up to D = 128 the q (and
// dO) fragments are held in registers for the whole k loop; above it they
// are read again from shared memory at each 16-wide k step.  K3's dK and
// dV together are D f32 registers a thread, too many above D = 128, so
// there K3 runs eight warps: warps w and w + 4 own the same 16 keys, each
// recomputes their S^T and dP^T tiles over the full D and accumulates dK
// and dV for its half of the columns (96 or 128).  That costs K3 1.5x the
// products of one warp a key group (12 D flops instead of 8 D a pair), but
// needs no shared-memory accumulators and no exchange of P between warps.
// Above D = 256 (320 - 512, every multiple of 64) no accumulator fits a
// warp, so the output columns are split over a third grid dimension of NC
// = 2 blocks: each block of a pair computes the same scores (and dP) over
// the full D from the same tiles and accumulates O (dQ; dK and dV) for its
// half of the columns only, D / 2 <= 256, which is the D = 256 case again.
// The pair repeats the score products (K1 6 D flops a pair instead of 4 D,
// K2 10 D instead of 6 D, K3 20 D instead of 8 D); only the first block of
// a pair writes the LSE (K1) and delta (K2).  This repairs a gap (the
// reference takes any head_dim % 64 == 0); it is right, not tuned.
// float32 runs on CUDA cores in full f32 (TF32 cannot meet the reference's
// 2e-5 bar): a plain block of 128 threads over 32 x 32 tiles in shared
// memory (16 x 16 above D = 256; K3: 32 keys x 16 q rows at D = 256, 16 x 8
// above it, to fit 227 KB), for checks and small models only.
// Instantiated for D = 64, 128, 192, 256, 320, 384, 448 and 512; the
// wrapper refuses a larger D: above 512 half the columns no longer fit a
// warp's registers (a third column chunk would be needed), and from D = 640
// K2's q, dO, K and V tiles alone need 248,832 bytes of shared memory, more
// than the 232,448 a block may use.
//
// Bound.  Each kernel does 4 D (K1), 6 D (K2) or 8 D (K3) flops per
// visible (query, key) pair, about S^2 / 2 pairs a head when causal, over
// O(S D) bytes.  At GPT-2's D = 64 and S = 1024, K1 and K2 sit just under
// the card's ~295 flop/byte bf16 ridge (bound by bytes, about 0.03 and
// 0.05 ms); K3, and all three at D >= 128, sit above it (bound by the 989
// TFLOP/s of the tensor cores).  Either way the bound is about a tenth of
// what these kernels take: how fast synchronous loads feed mma.sync sets
// their time, not the card's limits.  What this simple design
// leaves on the table: mma.sync reaches a fraction of what wgmma does;
// tiles are loaded synchronously (no cp.async / TMA ring overlapping the
// next tile with the current product); causal blocks do unequal work (the
// last q tile walks S / 64 k tiles, the first one), with no balancing or
// persistent scheduling; and K3 reloads each q tile and recomputes P and
// dP, as K2 does.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, s, h;   // elements between batches, rows (positions), heads
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;       // K2: the forward's output
  const void* dout;    // K2, K3: dO
  void* out;           // K1: o; K2: dq; K3: dk   (contiguous)
  void* out2;          // K3: dv                  (contiguous)
  float* lse;          // [B * H, Sq], natural log
  float* delta;        // [B * H, Sq]: written by K2, read by K3
  Strides sq, sk, sv, so, sdo;
  int B, H, Hk, Sq, Sk;
  float scale;         // softmax scale
  float qscale;        // scale * log2(e), rounded to f32 by the caller
  int causal;
};

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* base, const Strides& st,
                                             int b, int h) {
  return static_cast<const T*>(base) + (long long)b * st.b + (long long)h * st.h;
}

// ---------------------------------------------------------------- bf16 path
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

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 x 16) at (r0, c0) of a row-major tile t[row][col].
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t, int ld,
                                       int r0, int c0, int g, int tq) {
  const bf16* p = t + (r0 + g) * ld + c0 + 2 * tq;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * ld);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * ld + 8);
}

// A fragment for k step kc of a warp's 16 rows at r0: from the registers
// held since the tile was staged (kHold) or read again from the tile.
template <bool kHold, int N>
__device__ __forceinline__ void row_frag(uint32_t (&a)[4],
                                         const uint32_t (&held)[N][4],
                                         const bf16* t, int ld, int r0,
                                         int kc, int g, int tq) {
  if constexpr (kHold) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = held[kc][i];
  } else {
    frag_a(a, t, ld, r0, kc * 16, g, tq);
  }
}

// B fragment (16 k x 8 n) from a tile stored t[n][k] (K for q K^T).
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[2], const bf16* t,
                                          int ld, int n0, int k0, int g,
                                          int tq) {
  const bf16* p = t + (n0 + g) * ld + k0 + 2 * tq;
  b[0] = lds32(p);
  b[1] = lds32(p + 8);
}

// B fragment (16 k x 8 n) from a tile stored t[k][n] (V for P V).
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[2], const bf16* t,
                                          int ld, int k0, int n0, int g,
                                          int tq) {
  const uint16_t* p =
      reinterpret_cast<const uint16_t*>(t) + (k0 + 2 * tq) * ld + n0 + g;
  b[0] = (uint32_t)p[0] | ((uint32_t)p[ld] << 16);
  b[1] = (uint32_t)p[8 * ld] | ((uint32_t)p[9 * ld] << 16);
}

// A fragment for k-chunk kc from the f32 accumulators of n-blocks 2kc and
// 2kc + 1 (the m16n8 C layout), rounded to bf16.
template <int N>
__device__ __forceinline__ void frag_a_acc(uint32_t (&a)[4],
                                           const float (&s)[N][4], int kc) {
  a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
  a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
  a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
  a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
}

// K4: the raw q k^T scores times scale * log2 e, in f32.
template <bool kDirect, int N>
__device__ __forceinline__ void scale_scores(float (&s)[N][4], float mul) {
  if constexpr (kDirect) {
#pragma unroll
    for (int nb = 0; nb < N; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] *= mul;
  }
}

// R rows x D columns of a [.., S, .., D] tensor (row stride `rs` elements,
// 16-byte aligned rows) into shared memory t[R][D + 8] by NT threads; with
// `mul`, each value is multiplied by it in f32 and rounded back to bf16.
template <int R, int D, bool kScale, int NT = kThreads>
__device__ __forceinline__ void load_tile(bf16* t, const bf16* src,
                                          long long rs, float mul, int tid) {
  constexpr int kChunks = D / 8;
  for (int i = tid; i < R * kChunks; i += NT) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 u = *reinterpret_cast<const uint4*>(src + r * rs + c);
    if (kScale) {
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        h2[e] = __floats2bfloat162_rn(f.x * mul, f.y * mul);
      }
    }
    *reinterpret_cast<uint4*>(t + r * (D + 8) + c) = u;
  }
}

template <int D>
struct FwdTile {
  static constexpr int BQ = 64, BK = D <= 192 ? 64 : 32, LD = D + 8;
  static constexpr bool kHold = D <= 128;      // q fragments in registers
  static constexpr int NC = D > 256 ? 2 : 1;   // column chunks (grid z)
  static constexpr int DC = D / NC;            // O columns a block owns
  static constexpr size_t smem = (size_t)(BQ + 2 * BK) * LD * sizeof(bf16);
};

// K1 / K4-fwd.  Block: 64 q rows of one (b, h) and O columns c0 .. c0 +
// DC - 1 (all of them up to D = 256); warp w owns rows 16w .. 16w + 15.
template <int D, bool kDirect>
__global__ void __launch_bounds__(kThreads) fwd_bf16(const Params p) {
  using C = FwdTile<D>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, DC = C::DC;
  constexpr bool kHold = C::kHold;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LD;
  bf16* sV = sK + BK * LD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * BQ, bh = blockIdx.y, c0 = blockIdx.z * DC;
  const int b = bh / p.H, h = bh % p.H, hk = h / (p.H / p.Hk);
  const bf16* kb = head_ptr<bf16>(p.k, p.sk, b, hk);
  const bf16* vb = head_ptr<bf16>(p.v, p.sv, b, hk);

  load_tile<BQ, D, !kDirect>(sQ, head_ptr<bf16>(p.q, p.sq, b, h) + q0 * p.sq.s,
                             p.sq.s, p.qscale, tid);
  __syncthreads();
  uint32_t qf[kHold ? D / 16 : 1][4];
  if constexpr (kHold) {
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      frag_a(qf[kc], sQ, LD, warp * 16, kc * 16, g, tq);
  }

  float acc[DC / 8][4];
#pragma unroll
  for (int nb = 0; nb < DC / 8; ++nb)
    acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;           // rows row0, row0 + 8
  int nk = p.Sk / BK;
  if (p.causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    __syncthreads();
    load_tile<BK, D, false>(sK, kb + k0 * p.sk.s, p.sk.s, 0.f, tid);
    load_tile<BK, D, false>(sV, vb + k0 * p.sv.s, p.sv.s, 0.f, tid);
    __syncthreads();
    float s[BK / 8][4];
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb)
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t a[4];
      row_frag<kHold>(a, qf, sQ, LD, warp * 16, kc, g, tq);
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb) {
        uint32_t bf[2];
        frag_b_nk(bf, sK, LD, nb * 8, kc * 16, g, tq);
        mma_bf16(s[nb], a, bf);
      }
    }
    scale_scores<kDirect>(s, p.qscale);
    if (p.causal && k0 + BK - 1 > q0) {          // the tile crosses it
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + nb * 8 + 2 * tq + (e & 1) > row0 + (e >> 1) * 8)
            s[nb][e] = kNegInf;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb)
        mx = fmaxf(mx, fmaxf(s[nb][2 * r], s[nb][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = exp2f(m[r] - mx);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb) {
        s[nb][2 * r] = exp2f(s[nb][2 * r] - mx);
        s[nb][2 * r + 1] = exp2f(s[nb][2 * r + 1] - mx);
        sum += s[nb][2 * r] + s[nb][2 * r + 1];
      }
      l[r] = l[r] * corr + sum;                  // this thread's columns
#pragma unroll
      for (int nb = 0; nb < DC / 8; ++nb) {
        acc[nb][2 * r] *= corr;
        acc[nb][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4];
      frag_a_acc(a, s, kc);                      // P rounded to v's dtype
#pragma unroll
      for (int nb = 0; nb < DC / 8; ++nb) {
        uint32_t bf[2];
        frag_b_kn(bf, sV, LD, kc * 16, c0 + nb * 8, g, tq);
        mma_bf16(acc[nb], a, bf);
      }
    }
  }

  bf16* ob = static_cast<bf16*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float lc = fmaxf(lr, 1e-30f);
    const int row = row0 + 8 * r;
    bf16* orow = ob + ((long long)(b * p.Sq + row) * p.H + h) * D + c0;
#pragma unroll
    for (int nb = 0; nb < DC / 8; ++nb)
      *reinterpret_cast<uint32_t*>(orow + nb * 8 + 2 * tq) =
          pack_bf16(acc[nb][2 * r] / lc, acc[nb][2 * r + 1] / lc);
    if (tq == 0 && blockIdx.z == 0) p.lse[(long long)bh * p.Sq + row] = (m[r] + log2f(lc)) * kLn2;
  }
}

template <int D>
struct DqTile {
  static constexpr int BQ = 64, BK = D == 64 ? 64 : 32, LD = D + 8;
  static constexpr bool kHold = D <= 128;      // q, dO fragments in registers
  static constexpr int NC = D > 256 ? 2 : 1;   // column chunks (grid z)
  static constexpr int DC = D / NC;            // dQ columns a block owns
  static constexpr size_t smem =
      (size_t)(2 * BQ + 2 * BK) * LD * sizeof(bf16) + 2 * BQ * sizeof(float);
};

// K2 / K4-dq.  Block: 64 q rows of one (b, h) and dQ columns c0 .. c0 +
// DC - 1; warp w owns rows 16w .. 16w + 15.
template <int D, bool kDirect>
__global__ void __launch_bounds__(kThreads) dq_bf16(const Params p) {
  using C = DqTile<D>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, DC = C::DC;
  constexpr bool kHold = C::kHold;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);      // q (K2: * scale * log2 e)
  bf16* sdO = sQ + BQ * LD;
  bf16* sK = sdO + BQ * LD;
  bf16* sV = sK + BK * LD;
  float* sL = reinterpret_cast<float*>(sV + BK * LD);   // lse * log2 e
  float* sDl = sL + BQ;                                  // delta
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * BQ, bh = blockIdx.y, c0 = blockIdx.z * DC;
  const int b = bh / p.H, h = bh % p.H, hk = h / (p.H / p.Hk);
  const bf16* kb = head_ptr<bf16>(p.k, p.sk, b, hk);
  const bf16* vb = head_ptr<bf16>(p.v, p.sv, b, hk);
  const bf16* dob = head_ptr<bf16>(p.dout, p.sdo, b, h);
  const bf16* obase = head_ptr<bf16>(p.o, p.so, b, h);

  load_tile<BQ, D, !kDirect>(sQ, head_ptr<bf16>(p.q, p.sq, b, h) + q0 * p.sq.s,
                             p.sq.s, p.qscale, tid);
  load_tile<BQ, D, false>(sdO, dob + q0 * p.sdo.s, p.sdo.s, 0.f, tid);
  {  // delta = rowsum(dO * O) in f32: two threads a row, half a row each
    const int r = tid >> 1, half = tid & 1;
    const bf16* dr = dob + (q0 + r) * p.sdo.s + half * (D / 2);
    const bf16* orw = obase + (q0 + r) * p.so.s + half * (D / 2);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < D / 2; c += 8) {
      uint4 ud = *reinterpret_cast<const uint4*>(dr + c);
      uint4 uo = *reinterpret_cast<const uint4*>(orw + c);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&ud);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&uo);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 fd = __bfloat1622float2(d2[e]);
        const float2 fo = __bfloat1622float2(o2[e]);
        sum += fd.x * fo.x + fd.y * fo.y;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      const long long i = (long long)bh * p.Sq + q0 + r;
      sDl[r] = sum;
      if (blockIdx.z == 0) p.delta[i] = sum;
      sL[r] = p.lse[i] * kLog2e;
    }
  }
  __syncthreads();
  uint32_t qf[kHold ? D / 16 : 1][4], df[kHold ? D / 16 : 1][4];
  if constexpr (kHold) {
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      frag_a(qf[kc], sQ, LD, warp * 16, kc * 16, g, tq);
      frag_a(df[kc], sdO, LD, warp * 16, kc * 16, g, tq);
    }
  }
  const float lse2[2] = {sL[warp * 16 + g], sL[warp * 16 + g + 8]};
  const float dl[2] = {sDl[warp * 16 + g], sDl[warp * 16 + g + 8]};
  float dq[DC / 8][4];
#pragma unroll
  for (int nb = 0; nb < DC / 8; ++nb)
    dq[nb][0] = dq[nb][1] = dq[nb][2] = dq[nb][3] = 0.f;
  const int row0 = q0 + warp * 16 + g;
  int nk = p.Sk / BK;
  if (p.causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    __syncthreads();
    load_tile<BK, D, false>(sK, kb + k0 * p.sk.s, p.sk.s, 0.f, tid);
    load_tile<BK, D, false>(sV, vb + k0 * p.sv.s, p.sv.s, 0.f, tid);
    __syncthreads();
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t aq[4], ad[4];
      row_frag<kHold>(aq, qf, sQ, LD, warp * 16, kc, g, tq);
      row_frag<kHold>(ad, df, sdO, LD, warp * 16, kc, g, tq);
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb) {
        uint32_t bf[2];
        frag_b_nk(bf, sK, LD, nb * 8, kc * 16, g, tq);
        mma_bf16(s[nb], aq, bf);
        frag_b_nk(bf, sV, LD, nb * 8, kc * 16, g, tq);
        mma_bf16(dp[nb], ad, bf);
      }
    }
    scale_scores<kDirect>(s, p.qscale);
    const bool crosses = p.causal && k0 + BK - 1 > q0;
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sc = s[nb][e];
        if (crosses && k0 + nb * 8 + 2 * tq + (e & 1) > row0 + (e >> 1) * 8)
          sc = kNegInf;
        const float pr = exp2f(sc - lse2[e >> 1]);
        s[nb][e] = pr * (dp[nb][e] - dl[e >> 1]);          // dS
      }
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4];
      frag_a_acc(a, s, kc);                      // dS rounded to k's dtype
#pragma unroll
      for (int nb = 0; nb < DC / 8; ++nb) {
        uint32_t bf[2];
        frag_b_kn(bf, sK, LD, kc * 16, c0 + nb * 8, g, tq);
        mma_bf16(dq[nb], a, bf);
      }
    }
  }

  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* orow =
        out + ((long long)(b * p.Sq + row0 + 8 * r) * p.H + h) * D + c0;
#pragma unroll
    for (int nb = 0; nb < DC / 8; ++nb)
      *reinterpret_cast<uint32_t*>(orow + nb * 8 + 2 * tq) = pack_bf16(
          dq[nb][2 * r] * p.scale, dq[nb][2 * r + 1] * p.scale);
  }
}

template <int D, bool kDirect>
struct DkvTile {
  static constexpr int BK = 64, BQ = D == 64 ? 64 : D > 256 ? 16 : 32;
  static constexpr int LD = D + 8;
  static constexpr int NS = D > 128 ? 2 : 1;   // warps sharing a key group
  static constexpr int NC = D > 256 ? 2 : 1;   // column chunks (grid z)
  static constexpr int DW = D / NC / NS;       // dK / dV columns a warp owns
  static constexpr int NT = kThreads * NS;
  // K4 keeps one q tile: its scores come from the unscaled q
  static constexpr size_t smem =
      (size_t)(2 * BK + (kDirect ? 2 : 3) * BQ) * LD * sizeof(bf16) +
      2 * BQ * sizeof(float);
};

// K3 / K4-dkv.  Block: 64 keys of one (b, hk) and dK / dV columns D / NC
// blockIdx.z .. + D / NC - 1; warp w owns keys 16 (w % 4) .. + 15 and DW
// of those columns from DW (w / 4) on, and computes the transposed tiles
// (keys x queries) directly.
template <int D, bool kDirect>
__global__ void __launch_bounds__(DkvTile<D, kDirect>::NT)
    dkv_bf16(const Params p) {
  using C = DkvTile<D, kDirect>;
  constexpr int BK = C::BK, BQ = C::BQ, LD = C::LD, DW = C::DW, NT = C::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BK * LD;
  bf16* sQ = sV + BK * LD;                       // q, unscaled
  bf16* sQ2 = kDirect ? sQ : sQ + BQ * LD;       // K3: q * scale * log2 e
  bf16* sdO = sQ2 + BQ * LD;
  float* sL = reinterpret_cast<float*>(sdO + BQ * LD);
  float* sDl = sL + BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int kw = (warp % 4) * 16;
  const int c0 = blockIdx.z * (D / C::NC) + (warp / 4) * DW;
  const int k0 = blockIdx.x * BK, bhk = blockIdx.y;
  const int b = bhk / p.Hk, hk = bhk % p.Hk, rep = p.H / p.Hk;

  load_tile<BK, D, false, NT>(sK, head_ptr<bf16>(p.k, p.sk, b, hk) + k0 * p.sk.s,
                              p.sk.s, 0.f, tid);
  load_tile<BK, D, false, NT>(sV, head_ptr<bf16>(p.v, p.sv, b, hk) + k0 * p.sv.s,
                              p.sv.s, 0.f, tid);
  float dk[DW / 8][4], dv[DW / 8][4];
#pragma unroll
  for (int nb = 0; nb < DW / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nb][e] = dv[nb][e] = 0.f;
  const int key0 = k0 + kw + g;                  // keys key0, key0 + 8
  const int nq = p.Sq / BQ;
  const int i0 = p.causal ? k0 / BQ : 0;         // first q tile that sees it

  for (int rr = 0; rr < rep; ++rr) {
    const int h = hk * rep + rr, bh = b * p.H + h;
    const bf16* qb = head_ptr<bf16>(p.q, p.sq, b, h);
    const bf16* dob = head_ptr<bf16>(p.dout, p.sdo, b, h);
    for (int i = i0; i < nq; ++i) {
      const int q0 = i * BQ;
      __syncthreads();
      load_tile<BQ, D, false, NT>(sQ, qb + q0 * p.sq.s, p.sq.s, 0.f, tid);
      if constexpr (!kDirect)
        load_tile<BQ, D, true, NT>(sQ2, qb + q0 * p.sq.s, p.sq.s, p.qscale,
                                   tid);
      load_tile<BQ, D, false, NT>(sdO, dob + q0 * p.sdo.s, p.sdo.s, 0.f, tid);
      for (int x = tid; x < BQ; x += NT) {
        const long long idx = (long long)bh * p.Sq + q0 + x;
        sL[x] = p.lse[idx] * kLog2e;
        sDl[x] = p.delta[idx];
      }
      __syncthreads();
      float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
      for (int nb = 0; nb < BQ / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t ak[4], av[4];
        frag_a(ak, sK, LD, kw, kc * 16, g, tq);
        frag_a(av, sV, LD, kw, kc * 16, g, tq);
#pragma unroll
        for (int nb = 0; nb < BQ / 8; ++nb) {
          uint32_t bf[2];
          frag_b_nk(bf, sQ2, LD, nb * 8, kc * 16, g, tq);
          mma_bf16(s[nb], ak, bf);               // (q2 K^T)^T
          frag_b_nk(bf, sdO, LD, nb * 8, kc * 16, g, tq);
          mma_bf16(dp[nb], av, bf);              // (dO V^T)^T
        }
      }
      scale_scores<kDirect>(s, p.qscale);
      const bool crosses = p.causal && k0 + BK - 1 > q0;
#pragma unroll
      for (int nb = 0; nb < BQ / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = nb * 8 + 2 * tq + (e & 1);     // query in the tile
          float sc = s[nb][e];
          if (crosses && key0 + (e >> 1) * 8 > q0 + qc) sc = kNegInf;
          s[nb][e] = exp2f(sc - sL[qc]);                // P^T
        }
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        uint32_t a[4];
        frag_a_acc(a, s, kc);                    // P rounded to dO's dtype
#pragma unroll
        for (int nb = 0; nb < DW / 8; ++nb) {
          uint32_t bf[2];
          frag_b_kn(bf, sdO, LD, kc * 16, c0 + nb * 8, g, tq);
          mma_bf16(dv[nb], a, bf);
        }
      }
#pragma unroll
      for (int nb = 0; nb < BQ / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nb][e] *= dp[nb][e] - sDl[nb * 8 + 2 * tq + (e & 1)];  // dS^T
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        uint32_t a[4];
        frag_a_acc(a, s, kc);                    // dS rounded to q's dtype
#pragma unroll
        for (int nb = 0; nb < DW / 8; ++nb) {
          uint32_t bf[2];
          frag_b_kn(bf, sQ, LD, kc * 16, c0 + nb * 8, g, tq);
          mma_bf16(dk[nb], a, bf);
        }
      }
    }
  }

  bf16* dkb = static_cast<bf16*>(p.out);
  bf16* dvb = static_cast<bf16*>(p.out2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long off =
        ((long long)(b * p.Sk + key0 + 8 * r) * p.Hk + hk) * D + c0;
#pragma unroll
    for (int nb = 0; nb < DW / 8; ++nb) {
      *reinterpret_cast<uint32_t*>(dkb + off + nb * 8 + 2 * tq) = pack_bf16(
          dk[nb][2 * r] * p.scale, dk[nb][2 * r + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvb + off + nb * 8 + 2 * tq) =
          pack_bf16(dv[nb][2 * r], dv[nb][2 * r + 1]);
    }
  }
}

// ----------------------------------------------------------------- f32 path
// Plain blocks of 128 threads over T x T tiles in shared memory (rows
// padded by one float); every product in full f32 on CUDA cores.  T = 32,
// or 16 above D = 256.  K3 walks q tiles of KQ rows: 32, 16 at D = 256
// (32 would need 239 KB), 8 above it.
template <int D, bool kDirect>
struct F32Tile {
  static constexpr int T = D > 256 ? 16 : 32;
  static constexpr int LD = D + 1, LS = T + 1;
  static constexpr int KQ = D > 256 ? 8 : D > 192 ? 16 : 32, LQ = KQ + 1;
  static constexpr size_t fwd = (size_t)(3 * T * LD + T * D + T * LS + 3 * T) * 4;
  static constexpr size_t dq = (size_t)(4 * T * LD + T * D + T * LS + 2 * T) * 4;
  static constexpr size_t dkv =
      (size_t)(2 * T * LD + (kDirect ? 2 : 3) * KQ * LD + 2 * T * D +
               2 * T * LQ + 2 * KQ) * 4;
};

// R rows of one head into t[R][D + 1], times `mul`
template <int D, int R>
__device__ __forceinline__ void load_f32(float* t, const float* src,
                                         long long rs, float mul, int tid) {
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, c = i % D;
    t[r * (D + 1) + c] = src[r * rs + c] * mul;
  }
}

template <int D>
__device__ __forceinline__ float dot_f32(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// K1 / K4-fwd, float32.
template <int D, bool kDirect>
__global__ void __launch_bounds__(kThreads) fwd_f32(const Params p) {
  constexpr int kT = F32Tile<D, kDirect>::T, LD = D + 1, LS = kT + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + kT * LD;
  float* sV = sK + kT * LD;
  float* sAcc = sV + kT * LD;
  float* sS = sAcc + kT * D;
  float* sM = sS + kT * LS;
  float* sLs = sM + kT;
  float* sC = sLs + kT;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kT, bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, hk = h / (p.H / p.Hk);
  const float* kb = head_ptr<float>(p.k, p.sk, b, hk);
  const float* vb = head_ptr<float>(p.v, p.sv, b, hk);
  const float smul = kDirect ? p.qscale : 1.f;   // on the score (K4) ...
  load_f32<D, kT>(sQ, head_ptr<float>(p.q, p.sq, b, h) + q0 * p.sq.s, p.sq.s,
              kDirect ? 1.f : p.qscale, tid);    // ... or on q (K1)
  for (int i = tid; i < kT * D; i += kThreads) sAcc[i] = 0.f;
  if (tid < kT) { sM[tid] = kNegInf; sLs[tid] = 0.f; }
  int nk = p.Sk / kT;
  if (p.causal) nk = min(nk, (q0 + kT - 1) / kT + 1);
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kT;
    __syncthreads();
    load_f32<D, kT>(sK, kb + k0 * p.sk.s, p.sk.s, 1.f, tid);
    load_f32<D, kT>(sV, vb + k0 * p.sv.s, p.sv.s, 1.f, tid);
    __syncthreads();
    for (int i = tid; i < kT * kT; i += kThreads) {
      const int r = i / kT, c = i % kT;
      float s = dot_f32<D>(sQ + r * LD, sK + c * LD) * smul;
      if (p.causal && k0 + c > q0 + r) s = kNegInf;
      sS[r * LS + c] = s;
    }
    __syncthreads();
    if (tid < kT) {
      const int r = tid;
      float mx = sM[r];
      for (int c = 0; c < kT; ++c) mx = fmaxf(mx, sS[r * LS + c]);
      const float corr = exp2f(sM[r] - mx);
      float sum = 0.f;
      for (int c = 0; c < kT; ++c) {
        const float pv = exp2f(sS[r * LS + c] - mx);
        sS[r * LS + c] = pv;
        sum += pv;
      }
      sLs[r] = sLs[r] * corr + sum;
      sM[r] = mx;
      sC[r] = corr;
    }
    __syncthreads();
    for (int i = tid; i < kT * D; i += kThreads) {
      const int r = i / D, c = i % D;
      float a = 0.f;
      for (int x = 0; x < kT; ++x) a = fmaf(sS[r * LS + x], sV[x * LD + c], a);
      sAcc[i] = sAcc[i] * sC[r] + a;
    }
  }
  __syncthreads();
  float* ob = static_cast<float*>(p.out);
  for (int i = tid; i < kT * D; i += kThreads) {
    const int r = i / D, c = i % D;
    ob[((long long)(b * p.Sq + q0 + r) * p.H + h) * D + c] =
        sAcc[i] / fmaxf(sLs[r], 1e-30f);
  }
  if (tid < kT)
    p.lse[(long long)bh * p.Sq + q0 + tid] =
        (sM[tid] + log2f(fmaxf(sLs[tid], 1e-30f))) * kLn2;
}

// K2 / K4-dq, float32 (also writes delta).
template <int D, bool kDirect>
__global__ void __launch_bounds__(kThreads) dq_f32(const Params p) {
  constexpr int kT = F32Tile<D, kDirect>::T, LD = D + 1, LS = kT + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);    // q (K2: * scale * log2 e)
  float* sdO = sQ + kT * LD;
  float* sK = sdO + kT * LD;
  float* sV = sK + kT * LD;
  float* sdq = sV + kT * LD;
  float* sS = sdq + kT * D;
  float* sL = sS + kT * LS;
  float* sDl = sL + kT;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kT, bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, hk = h / (p.H / p.Hk);
  const float* kb = head_ptr<float>(p.k, p.sk, b, hk);
  const float* vb = head_ptr<float>(p.v, p.sv, b, hk);
  const float* obase = head_ptr<float>(p.o, p.so, b, h);
  const float smul = kDirect ? p.qscale : 1.f;
  load_f32<D, kT>(sQ, head_ptr<float>(p.q, p.sq, b, h) + q0 * p.sq.s, p.sq.s,
              kDirect ? 1.f : p.qscale, tid);
  load_f32<D, kT>(sdO, head_ptr<float>(p.dout, p.sdo, b, h) + q0 * p.sdo.s,
              p.sdo.s, 1.f, tid);
  for (int i = tid; i < kT * D; i += kThreads) sdq[i] = 0.f;
  __syncthreads();
  if (tid < kT) {
    const float* orow = obase + (q0 + tid) * p.so.s;
    float sum = 0.f;
    for (int c = 0; c < D; ++c) sum = fmaf(sdO[tid * LD + c], orow[c], sum);
    const long long idx = (long long)bh * p.Sq + q0 + tid;
    sDl[tid] = sum;
    p.delta[idx] = sum;
    sL[tid] = p.lse[idx] * kLog2e;
  }
  int nk = p.Sk / kT;
  if (p.causal) nk = min(nk, (q0 + kT - 1) / kT + 1);
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kT;
    __syncthreads();
    load_f32<D, kT>(sK, kb + k0 * p.sk.s, p.sk.s, 1.f, tid);
    load_f32<D, kT>(sV, vb + k0 * p.sv.s, p.sv.s, 1.f, tid);
    __syncthreads();
    for (int i = tid; i < kT * kT; i += kThreads) {
      const int r = i / kT, c = i % kT;
      float s = dot_f32<D>(sQ + r * LD, sK + c * LD) * smul;
      if (p.causal && k0 + c > q0 + r) s = kNegInf;
      const float pr = exp2f(s - sL[r]);
      const float dp = dot_f32<D>(sdO + r * LD, sV + c * LD);
      sS[r * LS + c] = pr * (dp - sDl[r]);
    }
    __syncthreads();
    for (int i = tid; i < kT * D; i += kThreads) {
      const int r = i / D, c = i % D;
      float a = 0.f;
      for (int x = 0; x < kT; ++x) a = fmaf(sS[r * LS + x], sK[x * LD + c], a);
      sdq[i] += a;
    }
  }
  __syncthreads();
  float* out = static_cast<float*>(p.out);
  for (int i = tid; i < kT * D; i += kThreads) {
    const int r = i / D, c = i % D;
    out[((long long)(b * p.Sq + q0 + r) * p.H + h) * D + c] = sdq[i] * p.scale;
  }
}

// K3 / K4-dkv, float32: T keys a block, q tiles of KQ rows.
template <int D, bool kDirect>
__global__ void __launch_bounds__(kThreads) dkv_f32(const Params p) {
  using C = F32Tile<D, kDirect>;
  constexpr int kT = C::T, LD = C::LD, KQ = C::KQ, LQ = C::LQ;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + kT * LD;
  float* sQ = sV + kT * LD;
  float* sQ2 = kDirect ? sQ : sQ + KQ * LD;
  float* sdO = sQ2 + KQ * LD;
  float* sdk = sdO + KQ * LD;
  float* sdv = sdk + kT * D;
  float* sP = sdv + kT * D;                      // [key][query]
  float* sDS = sP + kT * LQ;
  float* sL = sDS + kT * LQ;
  float* sDl = sL + KQ;
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kT, bhk = blockIdx.y;
  const int b = bhk / p.Hk, hk = bhk % p.Hk, rep = p.H / p.Hk;
  const float smul = kDirect ? p.qscale : 1.f;
  load_f32<D, kT>(sK, head_ptr<float>(p.k, p.sk, b, hk) + k0 * p.sk.s, p.sk.s,
              1.f, tid);
  load_f32<D, kT>(sV, head_ptr<float>(p.v, p.sv, b, hk) + k0 * p.sv.s, p.sv.s,
              1.f, tid);
  for (int i = tid; i < kT * D; i += kThreads) sdk[i] = sdv[i] = 0.f;
  const int nq = p.Sq / KQ;
  const int i0 = p.causal ? k0 / KQ : 0;
  for (int rr = 0; rr < rep; ++rr) {
    const int h = hk * rep + rr, bh = b * p.H + h;
    const float* qb = head_ptr<float>(p.q, p.sq, b, h);
    const float* dob = head_ptr<float>(p.dout, p.sdo, b, h);
    for (int i = i0; i < nq; ++i) {
      const int q0 = i * KQ;
      __syncthreads();
      load_f32<D, KQ>(sQ, qb + q0 * p.sq.s, p.sq.s, 1.f, tid);
      if constexpr (!kDirect)
        load_f32<D, KQ>(sQ2, qb + q0 * p.sq.s, p.sq.s, p.qscale, tid);
      load_f32<D, KQ>(sdO, dob + q0 * p.sdo.s, p.sdo.s, 1.f, tid);
      if (tid < KQ) {
        const long long idx = (long long)bh * p.Sq + q0 + tid;
        sL[tid] = p.lse[idx] * kLog2e;
        sDl[tid] = p.delta[idx];
      }
      __syncthreads();
      for (int i2 = tid; i2 < kT * KQ; i2 += kThreads) {
        const int c = i2 / KQ, r = i2 % KQ;      // key c, query r
        float s = dot_f32<D>(sK + c * LD, sQ2 + r * LD) * smul;
        if (p.causal && k0 + c > q0 + r) s = kNegInf;
        const float pr = exp2f(s - sL[r]);
        const float dp = dot_f32<D>(sV + c * LD, sdO + r * LD);
        sP[c * LQ + r] = pr;
        sDS[c * LQ + r] = pr * (dp - sDl[r]);
      }
      __syncthreads();
      for (int i2 = tid; i2 < kT * D; i2 += kThreads) {
        const int c = i2 / D, d = i2 % D;
        float av = 0.f, ak = 0.f;
        for (int x = 0; x < KQ; ++x) {
          av = fmaf(sP[c * LQ + x], sdO[x * LD + d], av);
          ak = fmaf(sDS[c * LQ + x], sQ[x * LD + d], ak);
        }
        sdv[i2] += av;
        sdk[i2] += ak;
      }
    }
  }
  __syncthreads();
  float* dkb = static_cast<float*>(p.out);
  float* dvb = static_cast<float*>(p.out2);
  for (int i = tid; i < kT * D; i += kThreads) {
    const int c = i / D, d = i % D;
    const long long off = ((long long)(b * p.Sk + k0 + c) * p.Hk + hk) * D + d;
    dkb[off] = sdk[i] * p.scale;
    dvb[off] = sdv[i];
  }
}

// ------------------------------------------------------------------ launch
template <typename K>
cudaError_t launch(K kern, dim3 grid, int threads, size_t smem,
                   cudaStream_t st, const Params& p) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, threads, smem, st>>>(p);
  return cudaGetLastError();
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <int D, bool kDirect>
cudaError_t dispatch(Which w, int dtype, const Params& p, cudaStream_t st) {
  const int BH = p.B * p.H, BHk = p.B * p.Hk;
  if (dtype == 1) {
    if (w == kFwd) {
      using C = FwdTile<D>;
      if (p.Sq % C::BQ || p.Sk % C::BK) return cudaErrorInvalidValue;
      return launch(fwd_bf16<D, kDirect>, dim3(p.Sq / C::BQ, BH, C::NC), kThreads,
                    C::smem, st, p);
    }
    if (w == kDq) {
      using C = DqTile<D>;
      if (p.Sq % C::BQ || p.Sk % C::BK) return cudaErrorInvalidValue;
      return launch(dq_bf16<D, kDirect>, dim3(p.Sq / C::BQ, BH, C::NC), kThreads,
                    C::smem, st, p);
    }
    using C = DkvTile<D, kDirect>;
    if (p.Sq % C::BQ || p.Sk % C::BK) return cudaErrorInvalidValue;
    return launch(dkv_bf16<D, kDirect>, dim3(p.Sk / C::BK, BHk, C::NC), C::NT,
                  C::smem, st, p);
  }
  using C = F32Tile<D, kDirect>;
  if (p.Sq % C::T || p.Sk % C::T) return cudaErrorInvalidValue;
  if (w == kFwd)
    return launch(fwd_f32<D, kDirect>, dim3(p.Sq / C::T, BH), kThreads, C::fwd,
                  st, p);
  if (w == kDq)
    return launch(dq_f32<D, kDirect>, dim3(p.Sq / C::T, BH), kThreads, C::dq,
                  st, p);
  return launch(dkv_f32<D, kDirect>, dim3(p.Sk / C::T, BHk), kThreads, C::dkv,
                st, p);
}

template <bool kDirect>
cudaError_t by_dim(Which w, int D, int dtype, const Params& p,
                   cudaStream_t st) {
  switch (D) {
    case 64: return dispatch<64, kDirect>(w, dtype, p, st);
    case 128: return dispatch<128, kDirect>(w, dtype, p, st);
    case 192: return dispatch<192, kDirect>(w, dtype, p, st);
    case 256: return dispatch<256, kDirect>(w, dtype, p, st);
    case 320: return dispatch<320, kDirect>(w, dtype, p, st);
    case 384: return dispatch<384, kDirect>(w, dtype, p, st);
    case 448: return dispatch<448, kDirect>(w, dtype, p, st);
    case 512: return dispatch<512, kDirect>(w, dtype, p, st);
    default: return cudaErrorInvalidValue;
  }
}

int run(Which w, bool direct, const void* q, const void* k, const void* v,
        const void* o, const void* dout, void* out, void* out2, float* lse,
        float* delta, const long long* strides, int B, int H, int Hk, int Sq,
        int Sk, int D, float scale, float qscale, int causal, int dtype,
        void* stream) {
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  if (Hk <= 0 || H % Hk != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.out = out; p.out2 = out2; p.lse = lse; p.delta = delta;
  Strides* st[5] = {&p.sq, &p.sk, &p.sv, &p.so, &p.sdo};
  for (int i = 0; i < 5; ++i) {
    st[i]->b = strides[3 * i];
    st[i]->s = strides[3 * i + 1];
    st[i]->h = strides[3 * i + 2];
  }
  p.B = B; p.H = H; p.Hk = Hk; p.Sq = Sq; p.Sk = Sk;
  p.scale = scale; p.qscale = qscale; p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(direct ? by_dim<true>(w, D, dtype, p, s)
                      : by_dim<false>(w, D, dtype, p, s));
}

}  // namespace

extern "C" {

// Every function takes `strides`: 15 element strides (batch, row, head) of
// q, k, v, o and dO, in that order, on the host (unused ones are ignored).
// dtype: 0 = float32, 1 = bfloat16 (every tensor but lse / delta).  `direct`
// selects K4's numerics (0: K1-K3).  Outputs are contiguous: o and dq
// [B, Sq, H, D]; dk and dv [B, Sk, Hk, D]; lse and delta [B * H, Sq]
// float32.  Each returns a cudaError_t (0 = launched).

// K1 / K4-fwd: o and lse from q, k, v.
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              float* lse, const long long* strides, int B, int H, int Hk,
              int Sq, int Sk, int D, float scale, float qscale, int causal,
              int dtype, int direct, void* stream) {
  return run(kFwd, direct, q, k, v, nullptr, nullptr, o, nullptr, lse,
             nullptr, strides, B, H, Hk, Sq, Sk, D, scale, qscale, causal,
             dtype, stream);
}

// K2 / K4-dq: dq from q, k, v, o, dO and lse; also writes delta.
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, void* dq, const float* lse, float* delta,
                 const long long* strides, int B, int H, int Hk, int Sq,
                 int Sk, int D, float scale, float qscale, int causal,
                 int dtype, int direct, void* stream) {
  return run(kDq, direct, q, k, v, o, dout, dq, nullptr,
             const_cast<float*>(lse), delta, strides, B, H, Hk, Sq, Sk, D,
             scale, qscale, causal, dtype, stream);
}

// K3 / K4-dkv: dk, dv from q, k, v, dO, lse and the dq body's delta.
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, void* dk, void* dv, const float* lse,
                  const float* delta, const long long* strides, int B, int H,
                  int Hk, int Sq, int Sk, int D, float scale, float qscale,
                  int causal, int dtype, int direct, void* stream) {
  return run(kDkv, direct, q, k, v, nullptr, dout, dk, dv,
             const_cast<float*>(lse), const_cast<float*>(delta), strides, B,
             H, Hk, Sq, Sk, D, scale, qscale, causal, dtype, stream);
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
