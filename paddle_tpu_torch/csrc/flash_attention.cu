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
// The bf16 forward up to D = 256 (K1 and K4-fwd: fwd_bf16_sm90) is built
// for Hopper.  A persistent grid, one block of 384 threads an SM, walks
// the (b * H + h, 128-row q tile) items: two consumer warpgroups of 64 q
// rows each and one producer warpgroup, of which one thread issues every
// load.  The producer copies an item's q tile and its K / V tiles into a
// ring of STAGES stages with TMA (4-D tensor maps over [B, S, H, D] with
// the tensors' own strides, so fused-qkv views and GQA K / V are read in
// place; each D-wide tile is D / 64 boxes of 64 columns, 128-byte
// swizzled), each stage guarded by full barriers (K, V: the bytes landed)
// and an empty one (all 256 consumer threads are done with it); the next
// item's q lands once both warpgroups have issued their last q K^T, and
// its K / V as stages free, so one item's tail overlaps the next one's
// loads.  Each consumer computes S = q K^T with wgmma m64nBKk16 (both
// operands K-major in shared memory) and O += P V with wgmma m64nDk16, P
// from registers (the accumulator layout of S is the A layout of the next
// product) and V read MN-major (the transpose bit), so nothing is
// transposed.  Each tile's softmax overlaps the P V product of the tile
// before (S_j and P_(j-1) V_(j-1) issued together, the scores awaited
// first), and the two warpgroups take turns to issue their products (named
// barriers), so one's softmax runs under the other's wgmma.  setmaxnreg
// gives the consumers 232 registers (O is D / 2 f32 a thread), the
// producer 40.  K1 scales its q rows in place in shared memory once they
// land (q * scale * log2 e rounded to bf16, the TPU's rounding), then
// fences the async proxy before the first wgmma.  Causal: k tiles above
// the diagonal are never loaded and only tiles that cross the diagonal
// are masked.  Items go head by head, each head's heaviest q tile first
// (a head's K / V stays in L2 while its q tiles run), in rounds of one
// item a block, every other round walked backwards, which balances the
// blocks' causal work as well as a heaviest-first order does.
// Tiles (BQ x BK, stages): D 64 and 128: 128 x 128, 3; D 192: 128 x 64, 3;
// D 256: 128 x 64, 2 (at most 197,760 of 232,448 bytes of shared memory;
// 230,528 at D 128).  Every barrier wait is bounded: a wait of more than
// 2^32 clocks traps, so a phase bug is a launch error, not a hang.
//
// The bf16 backward up to D = 256 (K2 and K4-dq: dq_bf16_sm90, K3 and
// K4-dkv: dkv_bf16_sm90) keeps that skeleton: a persistent grid of 384-thread blocks in the same
// head-major snake rounds, one producer thread's TMA ring (the same 4-D
// maps, so fused-qkv views, GQA K / V and dO are read in place) under
// bounded full / empty barriers, two consumer warpgroups on wgmma,
// setmaxnreg 232 / 40.  Every product is one of the forward's two forms:
// both operands K-major in shared memory, or A from registers (an
// accumulator rounded to bf16) and B read MN-major.  Each product's
// operand descriptors are made where it is issued, from a base the
// compiler cannot see through (`fresh`): hoisted out of the loops, K2's
// 32 q and dO descriptors at D 256 spilled.
//   K2: an item is 128 q rows of one head; the producer loads q and dO an
//   item, K / V a k tile.  Each consumer computes delta = rowsum(dO * O)
//   for its 64 rows (dO from the swizzled tile, O from device memory),
//   stores it, and scales its q rows in place (q2, as K1).  Per k tile, S =
//   q2 K^T and dP = dO V^T are issued together with dQ += dS K of the tile
//   before (K MN-major, no transposed copy), and P and dS of this tile are
//   computed under that product; the warpgroups take turns to issue, as
//   K1's do.  Registers a consumer thread: dQ D / 2, S and dP BK / 2 each,
//   dS's fragments BK / 4, which sets BK: 128 at D 64 (192), 64 at D 128
//   and 192 (144, 176), 32 at D 256 (168), where q and dO alone take 128
//   KB of shared memory.
//   K3: an item is a key tile of one kv head; the producer loads K / V an
//   item, then for each of the GQA group's heads each q tile that sees the
//   keys (causal: from the key tile's start on) q, dO and the tile's LSE
//   and delta rows (1-D bulk copies) into a stage under one full barrier,
//   so the ring runs on from one head to the next.  K3 needs q twice: q2
//   for S^T and the unscaled q for dK.  Three more producer warps write q2
//   from each landed q tile into a q2 buffer (Q2 of them), fence the async
//   proxy and arrive on its barrier, so q is loaded once and neither
//   consumer waits for the other.  Per q tile: S^T = K q2^T (then q2 is
//   released) and dP^T = V dO^T, then P^T and dS^T in registers, then dV
//   += P^T dO and dK += dS^T q (dO and q MN-major).  The warpgroups issue
//   freely: on the H100, turns made K3 slower at D 192 and 256, and
//   issuing a tile's S^T with the dV / dK of the tile before slower from D
//   128 on, neither faster at D 64.  dK and dV sum over the group in
//   registers, with no atomics (dQ and dK / dV each belong to one block,
//   so every gradient is bitwise repeatable; K2 and K3 stay two kernels
//   for that).  Up to D
//   128 each warpgroup takes 64 of a block's 128 keys and holds both dK
//   and dV (D f32 registers a thread); above it they do not fit beside the
//   score tiles, so both warpgroups take the same 64 keys, warpgroup 0
//   holding dV and warpgroup 1 dK, and each computes S^T for itself: 10 D
//   flops a pair instead of 8 D (the mma.sync body's eight warps cost 12
//   D).  Passing P^T through shared memory instead would save the product
//   but make warpgroup 0 wait on warpgroup 1's elementwise work each tile.
//   K4 (kDirect) changes the numerics only: K4-dq leaves its q rows as
//   they landed, and K4-dkv takes S^T = K q^T from the ring stage's own q
//   tile, so it has no q2 buffers, no q2 barriers and no q2 writer warps;
//   both multiply each raw score by scale * log2 e in f32 before the mask
//   and the exp2.  A third K4-dkv stage at D 192, which the freed q2 room
//   allows, measured no faster on the H100 and was left out.
// Tiles (K2 / K4-dq: BQ x BK, stages; K3: keys x BQ, stages, q2 buffers;
// K4-dkv: K3's with no q2 buffer): D 64: 128 x 128, 3 and 128 x 64, 3, 2;
// D 128: 128 x 64, 3 and 128 x 64, 3, 2; D 192: 128 x 64, 2 and 64 x 64,
// 2, 2 (split); D 256: 128 x 32, 3 and 64 x 64, 2, 1 (split; K3 231,552
// bytes of shared memory, the most of any body; K4-dkv 198,784).
//
// The other bf16 bodies (every path above D = 256: the forward, dQ and
// dK / dV) run on the tensor cores with mma.sync m16n8k16 (bf16 x bf16 ->
// f32), each warp owning 16 rows (the forward and dQ: queries; dK / dV:
// keys).  The products whose A operand is a score tile (P V, dS K, P^T
// dO, dS^T q) take it straight from the accumulator registers of the
// product before (the m16n8 C layout of two n-blocks is the m16k16 A
// layout), so the score tiles never touch shared memory.  Tiles are
// staged in shared memory with 16-byte loads; rows are padded by 16 bytes
// so every fragment load is free of bank conflicts, and the q (and dO)
// fragments are read again from shared memory at each 16-wide k step.
// Fixed Hopper tiles (no autotune): the forward 64 q rows x 32 keys and
// dQ 64 q rows x 32 keys, four warps a block; dK / dV 64 keys x 16 q rows,
// eight warps: dK and dV together are D f32 registers a thread, too many
// for one warp, so warps w and w + 4 own the same 16 keys, each
// recomputes their S^T and dP^T tiles over the full D and accumulates dK
// and dV for its half of the block's columns, with no shared-memory
// accumulators and no exchange of P between warps.  No accumulator of the
// full D fits a warp (a warp's 16-row f32 accumulator is D / 2 registers
// a thread, of 255), so the output columns are split over a third grid
// dimension of NC = 2 blocks: each block of a pair computes the same
// scores (and dP) over the full D from the same tiles and accumulates O
// (dQ; dK and dV) for its half of the columns only, D / 2 <= 256.  The
// pair repeats the score products (K1 6 D flops a pair instead of 4 D, K2
// 10 D instead of 6 D, K3 20 D instead of 8 D); only the first block of a
// pair writes the LSE (K1) and delta (K2).  This repairs a gap (the
// reference takes any head_dim % 64 == 0, 320 - 512 here); it is right,
// not tuned.
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
// TFLOP/s of the tensor cores).  The mma.sync bodies took about ten times
// their bound up to D 256: how fast synchronous loads feed mma.sync set
// their time, not the card's limits (tiles loaded synchronously with no
// ring, causal blocks of unequal work, K3 loading each q tile twice).  The
// sm90 bodies answer each of these: wgmma, a TMA ring overlapping the next
// tile with the current products, a persistent grid in snake order, q
// loaded once.
#include <cuda.h>            // CUtensorMap and its enums (no -lcuda)
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

// ---------------------------------------- bf16 forward on Hopper, D <= 256
// (fwd_bf16_sm90: K1 and K4-fwd; the design is in the note at the top.)
template <int D>
struct Sm90Fwd {
  static constexpr int BQ = 128;               // two consumer warpgroups
  static constexpr int BK = D <= 128 ? 128 : 64;
  static constexpr int STAGES = D == 256 ? 2 : 3;
  static constexpr int kThreads = 384;         // and one producer warpgroup
  static constexpr int kPanels = D / 64;       // 64-column, 128-byte boxes
  static constexpr uint32_t QBYTES = BQ * D * 2, TBYTES = BK * D * 2;
  // 1024 bytes to align the base (the swizzle repeats every 8 rows of 128
  // bytes), the q tile, STAGES x (K, V) and 128 bytes of barriers
  static constexpr size_t smem = 1024 + QBYTES + 2 * STAGES * TBYTES + 128;
  static_assert(D % 64 == 0 && D <= 256, "the sm90 forward takes D <= 256");
  static_assert(smem <= 232448, "over the shared memory a block may use");
};

struct FwdArgs {
  CUtensorMap q, k, v;   // 4-D {D, S, H, B}, innermost first, bf16
  bf16* o;               // [B, Sq, H, D] contiguous
  float* lse;            // [B * H, Sq]
  int H, rep, Sq, Sk, causal;
  int nq, items;         // q tiles a head; items = B * H * nq
  float qscale;
};

constexpr long long kWaitClocks = 1ll << 32;   // far beyond any real wait

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed; trap after
// kWaitClocks, so a phase bug fails the launch instead of hanging it.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.b32 %0, 1, 0, P1;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > kWaitClocks) __trap();
  }
}

// One box of a 4-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::
          "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// into shared memory; completes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Eight bf16 values times `mul` in f32, rounded back to bf16.
__device__ __forceinline__ uint4 scale_chunk(uint4 u, float mul) {
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h2[e]);
    h2[e] = __floats2bfloat162_rn(f.x * mul, f.y * mul);
  }
  return u;
}

// A consumer warpgroup's 64 rows of a landed R-row, D-column tile (D / 64
// panels of R x 128 bytes) times `mul` in place, rounded to bf16 (the
// TPU's q * scale * log2 e), then the async proxy fenced for the wgmma
// that reads them; the caller syncs the warpgroup.  A panel's 64 rows are
// 512 chunks of 16 bytes, whose swizzled order does not matter here.
template <int R, int D>
__device__ __forceinline__ void scale_rows(uint4* tile, int wg, int t,
                                           float mul) {
  for (int i = t; i < 64 * D / 8; i += 128) {
    uint4* a = tile + (i >> 9) * (R * 8) + wg * 512 + (i & 511);
    *a = scale_chunk(*a, mul);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// The descriptor `d`, opaque to the compiler: the k steps' descriptors,
// `d` plus constants, are then computed where the products are issued,
// not hoisted out of the loops into registers (at D 256, K2's 32 of them
// spilled).
__device__ __forceinline__ uint64_t fresh(uint64_t d) {
  asm volatile("" : "+l"(d));
  return d;
}

// 2^x in one MUFU op: exp2f's handling of results under 2^-126 costs three
// more instructions an element, for probabilities that small.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers that an asynchronous wgmma writes or reads: pinned here, so the
// compiler neither reads them before the wait nor reuses them during it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// S (+)= A B^T, m64n32k16: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

// S (+)= A B^T, m64n64k16: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// S (+)= A B^T, m64n128k16: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// O += A B, m64n64k16: A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

// O += A B, m64n128k16: A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

// O += A B, m64n192k16: A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[96],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

// O += A B, m64n256k16: A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}
// The work item `item` of the persistent grid: a q tile of (b * H + h) =
// bh, and the k tiles it reads.  Items go head by head (a head's K / V
// stays in L2 while its q tiles run; GQA groups are neighbours), each
// head's heaviest q tile first.
struct FwdItem {
  int bh, q0, nk;
};

// The block's item in round r of the persistent grid: rounds of gridDim.x
// items, every other one walked backwards, so a block that took a heavy
// item in one round takes a light one in the next.
__device__ __forceinline__ int snake_item(int r) {
  const int b = r & 1 ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x;
  return r * (int)gridDim.x + b;
}

template <int BQ, int BK, typename A>   // FwdArgs, or BwdArgs (K2)
__device__ __forceinline__ FwdItem fwd_item(const A& p, int item) {
  FwdItem it;
  it.bh = item / p.nq;
  it.q0 = (p.nq - 1 - item % p.nq) * BQ;
  it.nk = p.Sk / BK;
  if (p.causal) it.nk = min(it.nk, (it.q0 + BQ - 1) / BK + 1);
  return it;
}

// A consumer warpgroup of fwd_bf16_sm90: of each item's q tile, rows r0 ..
// r0 + 63, of which this thread holds row0 and row0 + 8 (the wgmma
// accumulator layout).
template <int D, bool kDirect>
__device__ __forceinline__ void fwd_consumer(const FwdArgs& p, uint32_t sQ,
                                             uint4* gQ, uint32_t sKV,
                                             uint32_t bars, int wg) {
  using C = Sm90Fwd<D>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::STAGES;
  constexpr uint32_t TB = C::TBYTES;
  const uint32_t fullQ = bars, emptyQ = bars + 8, fullK = bars + 16;
  const uint32_t fullV = fullK + 8 * ST, empty = fullV + 8 * ST;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const uint32_t qa = sQ + wg * 64 * 128;     // this warpgroup's q rows

  float o[D / 2], s[BK / 2];
  uint32_t pf[BK / 16][4];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 16; ++i) pf[i][0] = pf[i][1] = pf[i][2] = pf[i][3] = 0u;
  float m[2], l[2], corr[2];
  int r0 = 0, row0 = 0, ring = 0;   // ring: k tiles consumed so far

  // stage and phase parity of the item's k tile j in the ring
  auto stage = [&](int j) { return (ring + j) % ST; };
  auto parity = [&](int j) { return (uint32_t)(((ring + j) / ST) & 1); };
  // S = q K_j^T: D / 16 steps of 16 columns (32 bytes) of both operands
  auto issue_s = [&](int j) {
    const uint32_t k_s = sKV + 2 * stage(j) * TB;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s,
               sw128_desc(qa + (kk >> 2) * BQ * 128 + (kk & 3) * 32, 16, 1024),
               sw128_desc(k_s + (kk >> 2) * BK * 128 + (kk & 3) * 32, 16,
                          1024),
               kk > 0);
  };
  // O += P_j V_j: BK / 16 steps of 16 keys (2048 bytes of every panel of
  // V); the panels are BK * 128 bytes apart
  auto issue_pv = [&](int j) {
    const uint32_t v_s = sKV + (2 * stage(j) + 1) * TB;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(o, pf[kk], sw128_desc(v_s + kk * 2048, BK * 128, 1024));
  };
  // mask, online softmax of S_j in place (the f32 P), corr = the rescale of
  // the rows' earlier O and l
  auto softmax = [&](int j) {
    const int k0 = j * BK;
    if constexpr (kDirect) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] *= p.qscale;
    }
    if (p.causal && k0 + BK - 1 > r0) {          // the tile crosses the rows
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        if (k0 + (i >> 2) * 8 + 2 * tq + (i & 1) > row0 + ((i >> 1) & 1) * 8)
          s[i] = kNegInf;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
        mx = fmaxf(mx, fmaxf(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[r] = exp2f(m[r] - mx);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        s[4 * n + 2 * r] = ex2(s[4 * n + 2 * r] - mx);
        s[4 * n + 2 * r + 1] = ex2(s[4 * n + 2 * r + 1] - mx);
        sum += s[4 * n + 2 * r] + s[4 * n + 2 * r + 1];
      }
      l[r] = l[r] * corr[r] + sum;               // this thread's columns
    }
  };
  auto rescale = [&]() {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n] *= corr[0];
      o[4 * n + 1] *= corr[0];
      o[4 * n + 2] *= corr[1];
      o[4 * n + 3] *= corr[1];
    }
  };
  auto to_p = [&]() {                            // P rounded to V's dtype
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pf[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pf[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pf[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pf[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  // Ping-pong: the two warpgroups take turns to issue their products
  // (named barrier 3 + wg is this one's turn), so one's softmax runs under
  // the other's wgmma.  Both take the same turns: nk + 1 an item.
  auto turn_wait = [&]() {
    asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory");
  };
  auto turn_pass = [&]() {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - wg) : "memory");
  };
  if (wg == 1) turn_pass();                      // warpgroup 0 goes first
  for (int n = 0, rd = 0; rd * (int)gridDim.x < p.items; ++rd) {
    const int item = snake_item(rd);
    if (item >= p.items) continue;
    const FwdItem w = fwd_item<BQ, BK>(p, item);
    r0 = w.q0 + 64 * wg;
    row0 = r0 + 16 * warp + g;
    // both warpgroups walk all nk tiles (they take the same turns); a tile
    // wholly above one's rows is masked to P = 0
    const int nk = w.nk;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;

    mbar_wait(fullQ, n & 1);   // n: the items this block has consumed
    if constexpr (!kDirect) {   // K1: q * scale * log2 e, rounded to bf16
      scale_rows<BQ, D>(gQ, wg, t, p.qscale);
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }

    if (nk > 0) {
      mbar_wait(fullK + 8 * stage(0), parity(0));
      turn_wait();
      wg_fence();
      issue_s(0);
      wg_commit();
      turn_pass();
      wg_wait<0>();
      pin(s);
      if (nk == 1) mbar_arrive(emptyQ);          // q is read: the next
      softmax(0);                                // item's may land
      to_p();
      for (int j = 1; j < nk; ++j) {
        mbar_wait(fullK + 8 * stage(j), parity(j));
        mbar_wait(fullV + 8 * stage(j - 1), parity(j - 1));
        turn_wait();
        wg_fence();
        issue_s(j);
        wg_commit();
        issue_pv(j - 1);
        wg_commit();
        turn_pass();
        wg_wait<1>();                            // S_j; P V still running
        pin(s);
        if (j == nk - 1) mbar_arrive(emptyQ);
        softmax(j);
        wg_wait<0>();
        pin(o);
        pin(pf);
        mbar_arrive(empty + 8 * stage(j - 1));   // its stage is free
        rescale();
        to_p();
      }
      mbar_wait(fullV + 8 * stage(nk - 1), parity(nk - 1));
      turn_wait();
      wg_fence();
      issue_pv(nk - 1);
      wg_commit();
      turn_pass();
      wg_wait<0>();
      pin(o);
      pin(pf);
      mbar_arrive(empty + 8 * stage(nk - 1));
    } else {
      mbar_arrive(emptyQ);
    }
    ring += nk;
    ++n;

    const int b = w.bh / p.H, h = w.bh % p.H;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float lc = fmaxf(lr, 1e-30f), inv = 1.f / lc;
      const int row = row0 + 8 * r;
      bf16* orow = p.o + ((long long)(b * p.Sq + row) * p.H + h) * D;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint32_t*>(orow + 8 * c + 2 * tq) =
            pack_bf16(o[4 * c + 2 * r] * inv, o[4 * c + 2 * r + 1] * inv);
      if (tq == 0)
        p.lse[(long long)w.bh * p.Sq + row] = (m[r] + log2f(lc)) * kLn2;
    }
  }
  if (wg == 0) turn_wait();                      // warpgroup 1's last pass
}

// K1 / K4-fwd in bf16 up to D = 256: a persistent grid (one block an SM)
// over the items (q tiles); warpgroups 0 and 1 consume, warpgroup 2
// produces: the next item's q and K / V tiles load while the consumers
// finish the current one.
template <int D, bool kDirect>
__global__ void __launch_bounds__(384, 1)
    fwd_bf16_sm90(const __grid_constant__ FwdArgs p) {
  using C = Sm90Fwd<D>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::STAGES, NP = C::kPanels;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sKV = sQ + C::QBYTES;           // stage s: K, then V
  // fullQ, emptyQ, fullK[ST], fullV[ST], empty[ST]
  const uint32_t bars = sKV + 2 * ST * C::TBYTES;
  const uint32_t fullQ = bars, emptyQ = bars + 8, fullK = bars + 16;
  const uint32_t fullV = fullK + 8 * ST, empty = fullV + 8 * ST;
  if (threadIdx.x == 0) {
    mbar_init(fullQ, 1);
    mbar_init(emptyQ, 256);
    for (int s = 0; s < ST; ++s) {
      mbar_init(fullK + 8 * s, 1);
      mbar_init(fullV + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int ring = 0;                              // k tiles loaded so far
      for (int n = 0, rd = 0; rd * (int)gridDim.x < p.items; ++rd) {
        const int item = snake_item(rd);
        if (item >= p.items) continue;
        const FwdItem w = fwd_item<BQ, BK>(p, item);
        const int b = w.bh / p.H, h = w.bh % p.H, hk = h / p.rep;
        if (n > 0) mbar_wait(emptyQ, (n - 1) & 1);
        ++n;
        mbar_expect_tx(fullQ, C::QBYTES);
        for (int c = 0; c < NP; ++c)
          tma_load(sQ + c * BQ * 128, &p.q, fullQ, 64 * c, w.q0, h, b);
        for (int j = 0; j < w.nk; ++j, ++ring) {
          const int s = ring % ST;
          if (ring >= ST) mbar_wait(empty + 8 * s, (ring / ST - 1) & 1);
          const uint32_t k_s = sKV + 2 * s * C::TBYTES, v_s = k_s + C::TBYTES;
          mbar_expect_tx(fullK + 8 * s, C::TBYTES);
          for (int c = 0; c < NP; ++c)
            tma_load(k_s + c * BK * 128, &p.k, fullK + 8 * s, 64 * c,
                     j * BK, hk, b);
          mbar_expect_tx(fullV + 8 * s, C::TBYTES);
          for (int c = 0; c < NP; ++c)
            tma_load(v_s + c * BK * 128, &p.v, fullV + 8 * s, 64 * c,
                     j * BK, hk, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    fwd_consumer<D, kDirect>(
        p, sQ, reinterpret_cast<uint4*>(smem_raw + (sQ - raw)), sKV, bars,
        wg);
  }
}

// ----------------------------------------- bf16 backward on Hopper, D <= 256
// (dq_bf16_sm90: K2, dkv_bf16_sm90: K3; the design is in the note at the
// top.)  Both keep the forward's skeleton: a persistent grid of 384-thread
// blocks, one producer thread's TMA ring under full / empty mbarriers, two
// consumer warpgroups on wgmma (K2's taking turns to issue), setmaxnreg
// 232 / 40.

// A f32 accumulator of a 64 x (2 N) wgmma tile as the bf16 A fragments of
// the next product (the accumulator layout is the A layout), rounded.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&f)[N / 8][4],
                                         const float (&s)[N]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

template <int D>
struct Sm90Dq {
  static constexpr int BQ = 128;               // two consumer warpgroups
  // dQ (D / 2), S and dP (BK / 2 each) and dS's fragments (BK / 4) are
  // the registers a consumer thread holds
  static constexpr int BK = D == 64 ? 128 : D == 256 ? 32 : 64;
  static constexpr int STAGES = D == 192 ? 2 : 3;
  static constexpr int kPanels = D / 64;
  static constexpr uint32_t QBYTES = BQ * D * 2, TBYTES = BK * D * 2;
  // align, q and dO, STAGES x (K, V), barriers
  static constexpr size_t smem = 1024 + 2 * QBYTES + 2 * STAGES * TBYTES + 128;
  static_assert(D % 64 == 0 && D <= 256, "the sm90 backward takes D <= 256");
  static_assert(smem <= 232448, "over the shared memory a block may use");
};

template <int D, bool kDirect>
struct Sm90Dkv {
  // above D = 128, dK and dV do not fit one warpgroup's registers: both
  // warpgroups take the same 64 keys, warpgroup 0 dV and warpgroup 1 dK
  static constexpr bool kSplit = D > 128;
  static constexpr int BN = kSplit ? 64 : 128;  // keys an item
  static constexpr int BQ = 64;                 // q rows a ring stage
  static constexpr int STAGES = D <= 128 ? 3 : 2;
  // buffers of q * scale * log2 e: K4 scores the stage's own q tile and
  // needs none
  static constexpr int Q2 = kDirect ? 0 : D == 256 ? 1 : 2;
  static constexpr int kPanels = D / 64;
  static constexpr uint32_t KVBYTES = BN * D * 2, QBYTES = BQ * D * 2;
  static constexpr uint32_t ROWBYTES = BQ * 4;  // lse or delta of a q tile
  // align, K, V, STAGES x (q, dO), Q2 x q2, STAGES x (lse, delta), barriers
  static constexpr size_t smem = 1024 + 2 * KVBYTES + 2 * STAGES * QBYTES +
                                 Q2 * QBYTES + 2 * STAGES * ROWBYTES + 128;
  static_assert(D % 64 == 0 && D <= 256, "the sm90 backward takes D <= 256");
  static_assert(smem <= 232448, "over the shared memory a block may use");
};

struct BwdArgs {
  CUtensorMap q, k, v, dout;   // 4-D {D, S, H, B}, innermost first, bf16
  const bf16* o;               // K2: the forward's output
  Strides so;
  bf16* out;                   // K2: dq; K3: dk   (contiguous)
  bf16* out2;                  // K3: dv
  const float* lse;            // [B * H, Sq], natural log
  float* delta;                // [B * H, Sq]: written by K2, read by K3
  int H, Hk, rep, Sq, Sk, causal;
  int nq, nk, items;   // K2: 128-row q tiles a head; K3: q tiles a head and
                       // key tiles a kv head; the grid's items
  float scale, qscale;
};

// A consumer warpgroup of dq_bf16_sm90: of each item's q tile, rows r0 ..
// r0 + 63, of which this thread holds row0 and row0 + 8.  Per k tile j: S
// = q2 K^T (K4: q K^T, times scale * log2 e in f32) and dP = dO V^T (both
// from shared memory), issued with dQ += dS_(j-1) K_(j-1) (dS from
// registers, K read MN-major); P and dS of tile j are computed under that
// product.
template <int D, bool kDirect>
__device__ __forceinline__ void dq_consumer(const BwdArgs& p, uint32_t sQ,
                                            uint4* gQ, const uint4* gDO,
                                            uint32_t sKV, uint32_t bars,
                                            int wg) {
  using C = Sm90Dq<D>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::STAGES;
  constexpr uint32_t TB = C::TBYTES;
  const uint32_t fullQ = bars, emptyQ = bars + 8, full = bars + 16;
  const uint32_t empty = full + 8 * ST;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const uint32_t qa = sQ + wg * 64 * 128;      // this warpgroup's q rows
  const uint32_t da = qa + C::QBYTES;          // and dO rows

  float dq[D / 2], s[BK / 2], dp[BK / 2];
  uint32_t dsf[BK / 16][4];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 16; ++i)
    dsf[i][0] = dsf[i][1] = dsf[i][2] = dsf[i][3] = 0u;
  float lse2[2], dl[2];
  int r0 = 0, row0 = 0, ring = 0;   // ring: k tiles consumed so far

  auto stage = [&](int j) { return (ring + j) % ST; };
  auto parity = [&](int j) { return (uint32_t)(((ring + j) / ST) & 1); };
  // S = q2 K_j^T (K4: q K_j^T) and dP = dO V_j^T: D / 16 steps of 16
  // columns each (descriptor offsets are in 16-byte units)
  auto issue_sdp = [&](int j) {
    const uint32_t k_s = sKV + 2 * stage(j) * TB;
    const uint64_t qd = fresh(sw128_desc(qa, 16, 1024));
    const uint64_t kd = fresh(sw128_desc(k_s, 16, 1024));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, qd + ((kk >> 2) * BQ * 8 + (kk & 3) * 2),
               kd + ((kk >> 2) * BK * 8 + (kk & 3) * 2), kk > 0);
    const uint64_t dd = fresh(sw128_desc(da, 16, 1024));
    const uint64_t vd = fresh(sw128_desc(k_s + TB, 16, 1024));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, dd + ((kk >> 2) * BQ * 8 + (kk & 3) * 2),
               vd + ((kk >> 2) * BK * 8 + (kk & 3) * 2), kk > 0);
  };
  // dQ += dS_j K_j: BK / 16 steps of 16 keys; K's panels BK * 128 bytes apart
  auto issue_dq = [&](int j) {
    const uint64_t kd =
        fresh(sw128_desc(sKV + 2 * stage(j) * TB, BK * 128, 1024));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs(dq, dsf[kk], kd + kk * 128);
  };
  // dS = P (dP - delta) in s, P = exp2(S - lse * log2 e) masked, in f32
  // (K4: S is the raw q K^T times scale * log2 e)
  auto grad = [&](int j) {
    const int k0 = j * BK;
    const bool crosses = p.causal && k0 + BK - 1 > r0;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      float x = s[i];
      if constexpr (kDirect) x *= p.qscale;
      if (crosses && k0 + (i >> 2) * 8 + 2 * tq + (i & 1) > row0 + 8 * r)
        x = kNegInf;
      s[i] = ex2(x - lse2[r]) * (dp[i] - dl[r]);
    }
  };

  // the forward's ping-pong: nk + 1 turns an item for both warpgroups
  auto turn_wait = [&]() {
    asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory");
  };
  auto turn_pass = [&]() {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - wg) : "memory");
  };
  if (wg == 1) turn_pass();                      // warpgroup 0 goes first
  for (int n = 0, rd = 0; rd * (int)gridDim.x < p.items; ++rd) {
    const int item = snake_item(rd);
    if (item >= p.items) continue;
    const FwdItem w = fwd_item<BQ, BK>(p, item);
    const int nk = w.nk, b = w.bh / p.H, h = w.bh % p.H;
    r0 = w.q0 + 64 * wg;
    row0 = r0 + 16 * warp + g;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      lse2[r] = p.lse[(long long)w.bh * p.Sq + row0 + 8 * r] * kLog2e;

    mbar_wait(fullQ, n & 1);
    // delta = rowsum(dO * O) in f32 for rows row0 and row0 + 8: this
    // thread's quarter of the 16-byte chunks (dO swizzled in shared memory,
    // O from device memory), summed over the row's four threads; above
    // D = 128 one row at a time, so the loads in flight stay few
    auto delta_row = [&](int r) {
      const int rt = 64 * wg + 16 * warp + g + 8 * r, row = w.q0 + rt;
      const bf16* orow = p.o + (long long)b * p.so.b + (long long)row * p.so.s +
                         (long long)h * p.so.h;
      float sum = 0.f;
#pragma unroll
      for (int m = 0; m < D / 32; ++m) {
        const int c = tq + 4 * m;
        uint4 ud = gDO[(c >> 3) * (BQ * 8) + rt * 8 + ((c & 7) ^ g)];
        uint4 uo = *reinterpret_cast<const uint4*>(orow + 8 * c);
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
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (tq == 0) p.delta[(long long)w.bh * p.Sq + row] = sum;
      return sum;
    };
    if constexpr (D <= 128) {
      dl[0] = delta_row(0);
      dl[1] = delta_row(1);
    } else {
#pragma unroll 1
      for (int r = 0; r < 2; ++r) {
        const float d = delta_row(r);
        if (r == 0) dl[0] = d;
        else dl[1] = d;
      }
    }
    if constexpr (!kDirect) {   // K2: q2, in place
      scale_rows<BQ, D>(gQ, wg, t, p.qscale);
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    if (nk > 0) {
      mbar_wait(full + 8 * stage(0), parity(0));
      turn_wait();
      wg_fence();
      issue_sdp(0);
      wg_commit();
      turn_pass();
      wg_wait<0>();
      pin(s);
      pin(dp);
      if (nk == 1) mbar_arrive(emptyQ);          // q and dO are read
      grad(0);
      acc_to_a(dsf, s);                          // dS rounded to K's dtype
      for (int j = 1; j < nk; ++j) {
        mbar_wait(full + 8 * stage(j), parity(j));
        turn_wait();
        wg_fence();
        issue_sdp(j);
        wg_commit();
        issue_dq(j - 1);
        wg_commit();
        turn_pass();
        wg_wait<1>();                            // S_j, dP_j; dQ still running
        pin(s);
        pin(dp);
        if (j == nk - 1) mbar_arrive(emptyQ);
        grad(j);
        wg_wait<0>();
        pin(dq);
        pin(dsf);
        mbar_arrive(empty + 8 * stage(j - 1));   // its stage is free
        acc_to_a(dsf, s);
      }
      turn_wait();
      wg_fence();
      issue_dq(nk - 1);
      wg_commit();
      turn_pass();
      wg_wait<0>();
      pin(dq);
      pin(dsf);
      mbar_arrive(empty + 8 * stage(nk - 1));
    } else {
      mbar_arrive(emptyQ);
    }
    ring += nk;
    ++n;

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bf16* orow = p.out + ((long long)(b * p.Sq + row0 + 8 * r) * p.H + h) * D;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint32_t*>(orow + 8 * c + 2 * tq) = pack_bf16(
            dq[4 * c + 2 * r] * p.scale, dq[4 * c + 2 * r + 1] * p.scale);
    }
  }
  if (wg == 0) turn_wait();                      // warpgroup 1's last pass
}

// K2 / K4-dq in bf16 up to D = 256: a persistent grid over the items
// (b * H + h, 128-row q tile); warpgroups 0 and 1 consume, one thread of
// warpgroup 2 loads q and dO an item and K / V a k tile into the ring.
template <int D, bool kDirect>
__global__ void __launch_bounds__(384, 1)
    dq_bf16_sm90(const __grid_constant__ BwdArgs p) {
  using C = Sm90Dq<D>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::STAGES, NP = C::kPanels;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sDO = sQ + C::QBYTES;
  const uint32_t sKV = sDO + C::QBYTES;          // stage s: K, then V
  // fullQ, emptyQ, full[ST], empty[ST]
  const uint32_t bars = sKV + 2 * ST * C::TBYTES;
  const uint32_t fullQ = bars, emptyQ = bars + 8, full = bars + 16;
  const uint32_t empty = full + 8 * ST;
  if (threadIdx.x == 0) {
    mbar_init(fullQ, 1);
    mbar_init(emptyQ, 256);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int ring = 0;                              // k tiles loaded so far
      for (int n = 0, rd = 0; rd * (int)gridDim.x < p.items; ++rd) {
        const int item = snake_item(rd);
        if (item >= p.items) continue;
        const FwdItem w = fwd_item<BQ, BK>(p, item);
        const int b = w.bh / p.H, h = w.bh % p.H, hk = h / p.rep;
        if (n > 0) mbar_wait(emptyQ, (n - 1) & 1);
        ++n;
        mbar_expect_tx(fullQ, 2 * C::QBYTES);
        for (int c = 0; c < NP; ++c) {
          tma_load(sQ + c * BQ * 128, &p.q, fullQ, 64 * c, w.q0, h, b);
          tma_load(sDO + c * BQ * 128, &p.dout, fullQ, 64 * c, w.q0, h, b);
        }
        for (int j = 0; j < w.nk; ++j, ++ring) {
          const int s = ring % ST;
          if (ring >= ST) mbar_wait(empty + 8 * s, (ring / ST - 1) & 1);
          const uint32_t k_s = sKV + 2 * s * C::TBYTES, v_s = k_s + C::TBYTES;
          mbar_expect_tx(full + 8 * s, 2 * C::TBYTES);
          for (int c = 0; c < NP; ++c) {
            tma_load(k_s + c * BK * 128, &p.k, full + 8 * s, 64 * c, j * BK,
                     hk, b);
            tma_load(v_s + c * BK * 128, &p.v, full + 8 * s, 64 * c, j * BK,
                     hk, b);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    dq_consumer<D, kDirect>(
        p, sQ, reinterpret_cast<uint4*>(smem_raw + (sQ - raw)),
        reinterpret_cast<const uint4*>(smem_raw + (sDO - raw)), sKV, bars, wg);
  }
}

// A K3 item: a key tile of (b * Hk + hk) = bhk at k0, and the q tiles that
// see it, i0 .. nq - 1 of each of the group's rep heads (tiles = rep *
// per), heaviest (first) key tile of a kv head first.
struct DkvItem {
  int bhk, k0, i0, per, tiles;
};

template <int BN, int BQ>
__device__ __forceinline__ DkvItem dkv_item(const BwdArgs& p, int item) {
  DkvItem it;
  it.bhk = item / p.nk;
  it.k0 = (item % p.nk) * BN;
  it.i0 = p.causal ? it.k0 / BQ : 0;
  it.per = max(0, p.nq - it.i0);
  it.tiles = p.rep * it.per;
  return it;
}

// A consumer warpgroup of dkv_bf16_sm90.  Rows are keys: kw0 .. kw0 + 63
// (this thread: key0 and key0 + 8), columns the q rows of a tile.  Per q
// tile: S^T = K q2^T (K4: K q^T from the stage's q tile, times scale *
// log2 e in f32) and dP^T = V dO^T (from shared memory), P^T and dS^T in
// registers, then dV += P^T dO and dK += dS^T q (A from registers, dO and
// q read MN-major).  kSplit: both warpgroups take the same 64 keys,
// warpgroup 0 computes S^T and dV, warpgroup 1 S^T, dP^T and dK.
template <int D, bool kDirect>
__device__ __forceinline__ void dkv_consumer(const BwdArgs& p, uint32_t sK,
                                             uint32_t sStages, uint32_t sQ2,
                                             const float* rows, uint32_t bars,
                                             int wg) {
  using C = Sm90Dkv<D, kDirect>;
  constexpr int BN = C::BN, BQ = C::BQ, ST = C::STAGES, Q2 = C::Q2;
  constexpr bool kSplit = C::kSplit;
  constexpr uint32_t QB = C::QBYTES;
  const uint32_t fullKV = bars, emptyKV = bars + 8, full = bars + 16;
  const uint32_t empty = full + 8 * ST, q2full = empty + 8 * ST;
  const uint32_t q2empty = q2full + 8 * Q2;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const bool doK = !kSplit || wg == 1;           // dP^T and dS^T needed
  const uint32_t ka = sK + (kSplit ? 0 : wg * 64 * 128);   // this one's keys
  const uint32_t va = ka + C::KVBYTES;

  // joint: acc = dV, acc2 = dK; kSplit: acc = dV (wg 0) or dK (wg 1)
  float acc[D / 2], acc2[kSplit ? 1 : D / 2];
  float s[BQ / 2], dp[BQ / 2];
  uint32_t fa[BQ / 16][4], fb[kSplit ? 1 : BQ / 16][4];
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
  acc2[0] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 16; ++i) fa[i][0] = fa[i][1] = fa[i][2] = fa[i][3] = 0u;
  fb[0][0] = fb[0][1] = fb[0][2] = fb[0][3] = 0u;
  int ring = 0;                                  // q tiles consumed so far

  // S^T = K q2^T (K4: K q^T) and dP^T = V dO^T: D / 16 steps of 16
  // columns (descriptor offsets are in 16-byte units); S^T and dP^T are
  // two commit groups, so K3 releases q2 as soon as S^T is done
  auto issue_a = [&](uint32_t q2_s, uint32_t do_s) {
    const uint64_t kd = fresh(sw128_desc(ka, 16, 1024));
    const uint64_t qd = fresh(sw128_desc(q2_s, 16, 1024));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, kd + ((kk >> 2) * BN * 8 + (kk & 3) * 2),
               qd + ((kk >> 2) * BQ * 8 + (kk & 3) * 2), kk > 0);
    wg_commit();
    if (doK) {
      const uint64_t vd = fresh(sw128_desc(va, 16, 1024));
      const uint64_t dd = fresh(sw128_desc(do_s, 16, 1024));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dp, vd + ((kk >> 2) * BN * 8 + (kk & 3) * 2),
                 dd + ((kk >> 2) * BQ * 8 + (kk & 3) * 2), kk > 0);
    }
  };
  // dV += P^T dO, dK += dS^T q: BQ / 16 steps of 16 q rows (2048 bytes);
  // the panels of dO and q are BQ * 128 bytes apart
  auto issue_b = [&](uint32_t q_s, uint32_t do_s) {
    if constexpr (kSplit) {
      const uint64_t bd =
          fresh(sw128_desc(wg == 0 ? do_s : q_s, BQ * 128, 1024));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs(acc, fa[kk], bd + kk * 128);
    } else {
      const uint64_t dd = fresh(sw128_desc(do_s, BQ * 128, 1024));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs(acc, fa[kk], dd + kk * 128);
      const uint64_t qd = fresh(sw128_desc(q_s, BQ * 128, 1024));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs(acc2, fb[kk], qd + kk * 128);
    }
  };
  // P^T = exp2(S^T - lse * log2 e) masked (key > query) into s, dS^T =
  // P^T (dP^T - delta) into dp, in f32 (K4: S^T is the raw K q^T times
  // scale * log2 e)
  auto grads = [&](const float* lse, int q0, int kw0) {
    const float* dlt = lse + BQ;
    const int key0 = kw0 + 16 * warp + g;
    const bool crosses = p.causal && q0 < kw0 + 63;
#pragma unroll
    for (int nb = 0; nb < BQ / 8; ++nb) {
      const float2 l = *reinterpret_cast<const float2*>(lse + 8 * nb + 2 * tq);
      const float2 d = *reinterpret_cast<const float2*>(dlt + 8 * nb + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * nb + e;
        float x = s[i];
        if constexpr (kDirect) x *= p.qscale;
        if (crosses && key0 + 8 * (e >> 1) > q0 + 8 * nb + 2 * tq + (e & 1))
          x = kNegInf;
        const float pr = ex2(x - (e & 1 ? l.y : l.x) * kLog2e);
        s[i] = pr;
        dp[i] = pr * (dp[i] - (e & 1 ? d.y : d.x));
      }
    }
  };
  // the A fragments of dV += P^T dO and dK += dS^T q, rounded
  auto to_frags = [&]() {
    if constexpr (kSplit) {
      if (wg == 0) acc_to_a(fa, s);              // P rounded to dO's dtype
      else acc_to_a(fa, dp);                     // dS rounded to q's dtype
    } else {
      acc_to_a(fa, s);
      acc_to_a(fb, dp);
    }
  };
  auto store = [&](bf16* base, const float (&a)[D / 2], float mul, int key0,
                   int b, int hk) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bf16* orow = base + ((long long)(b * p.Sk + key0 + 8 * r) * p.Hk + hk) * D;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint32_t*>(orow + 8 * c + 2 * tq) = pack_bf16(
            a[4 * c + 2 * r] * mul, a[4 * c + 2 * r + 1] * mul);
    }
  };

  for (int n = 0, rd = 0; rd * (int)gridDim.x < p.items; ++rd) {
    const int item = snake_item(rd);
    if (item >= p.items) continue;
    const DkvItem w = dkv_item<BN, BQ>(p, item);
    const int b = w.bhk / p.Hk, hk = w.bhk % p.Hk;
    const int kw0 = w.k0 + (kSplit ? 0 : 64 * wg);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    if constexpr (!kSplit) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc2[i] = 0.f;
    }
    mbar_wait(fullKV, n & 1);                    // n: items consumed
    if (w.tiles == 0) mbar_arrive(emptyKV);
    for (int tt = 0; tt < w.tiles; ++tt, ++ring) {
      const int q0 = (w.i0 + tt % w.per) * BQ;
      const int st = ring % ST;
      const uint32_t q_s = sStages + 2 * st * QB, do_s = q_s + QB;
      mbar_wait(full + 8 * st, (ring / ST) & 1);
      if constexpr (kDirect) {                   // S^T from the stage's q
        wg_fence();
        issue_a(q_s, do_s);
        wg_commit();
        wg_wait<0>();
        pin(s);
      } else {
        const int slot = ring % Q2;
        mbar_wait(q2full + 8 * slot, (ring / Q2) & 1);
        wg_fence();
        issue_a(sQ2 + slot * QB, do_s);
        wg_commit();
        wg_wait<1>();                            // S^T: q2 is read
        pin(s);
        mbar_arrive(q2empty + 8 * slot);
        wg_wait<0>();
      }
      pin(dp);
      if (tt == w.tiles - 1) mbar_arrive(emptyKV);   // K and V are read
      grads(rows + 2 * st * BQ, q0, kw0);
      to_frags();
      wg_fence();
      issue_b(q_s, do_s);
      wg_commit();
      wg_wait<0>();
      pin(acc);
      pin(acc2);
      pin(fa);
      pin(fb);
      mbar_arrive(empty + 8 * st);
    }
    ++n;
    const int key0 = kw0 + 16 * warp + g;
    if constexpr (kSplit) {
      if (wg == 0) store(p.out2, acc, 1.f, key0, b, hk);
      else store(p.out, acc, p.scale, key0, b, hk);
    } else {
      store(p.out2, acc, 1.f, key0, b, hk);
      store(p.out, acc2, p.scale, key0, b, hk);
    }
  }
}

// K3 / K4-dkv in bf16 up to D = 256: a persistent grid over the items
// (b * Hk + hk, key tile).  Warpgroups 0 and 1 consume.  In warpgroup 2,
// one thread loads an item's K / V, then q, dO, and the q tile's LSE and
// delta rows into the ring (for each of the group's heads, each q tile
// that sees the keys); for K3, warps 9-11 write q2 = q * scale * log2 e
// from each landed q tile into a q2 buffer for S^T, since dK takes the
// unscaled q.  K4 scores the unscaled q, so it has no q2 buffers.
template <int D, bool kDirect>
__global__ void __launch_bounds__(384, 1)
    dkv_bf16_sm90(const __grid_constant__ BwdArgs p) {
  using C = Sm90Dkv<D, kDirect>;
  constexpr int BN = C::BN, BQ = C::BQ, ST = C::STAGES, Q2 = C::Q2;
  constexpr int NP = C::kPanels;
  constexpr uint32_t QB = C::QBYTES, RB = C::ROWBYTES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023) & ~1023u;
  const uint32_t sV = sK + C::KVBYTES;
  const uint32_t sStages = sV + C::KVBYTES;      // stage s: q, then dO
  const uint32_t sQ2 = sStages + 2 * ST * QB;
  const uint32_t sRows = sQ2 + Q2 * QB;          // stage s: lse, then delta
  // fullKV, emptyKV, full[ST], empty[ST], q2full[Q2], q2empty[Q2]
  const uint32_t bars = sRows + 2 * ST * RB;
  const uint32_t fullKV = bars, emptyKV = bars + 8, full = bars + 16;
  const uint32_t empty = full + 8 * ST, q2full = empty + 8 * ST;
  const uint32_t q2empty = q2full + 8 * Q2;
  if (threadIdx.x == 0) {
    mbar_init(fullKV, 1);
    mbar_init(emptyKV, 256);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    for (int s = 0; s < Q2; ++s) {
      mbar_init(q2full + 8 * s, 96);
      mbar_init(q2empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {                    // the loads
      int ring = 0;                              // q tiles loaded so far
      for (int n = 0, rd = 0; rd * (int)gridDim.x < p.items; ++rd) {
        const int item = snake_item(rd);
        if (item >= p.items) continue;
        const DkvItem w = dkv_item<BN, BQ>(p, item);
        const int b = w.bhk / p.Hk, hk = w.bhk % p.Hk;
        if (n > 0) mbar_wait(emptyKV, (n - 1) & 1);
        ++n;
        mbar_expect_tx(fullKV, 2 * C::KVBYTES);
        for (int c = 0; c < NP; ++c) {
          tma_load(sK + c * BN * 128, &p.k, fullKV, 64 * c, w.k0, hk, b);
          tma_load(sV + c * BN * 128, &p.v, fullKV, 64 * c, w.k0, hk, b);
        }
        for (int tt = 0; tt < w.tiles; ++tt, ++ring) {
          const int h = hk * p.rep + tt / w.per;
          const int q0 = (w.i0 + tt % w.per) * BQ;
          const long long row = (long long)(b * p.H + h) * p.Sq + q0;
          const int s = ring % ST;
          if (ring >= ST) mbar_wait(empty + 8 * s, (ring / ST - 1) & 1);
          const uint32_t q_s = sStages + 2 * s * QB, r_s = sRows + 2 * s * RB;
          mbar_expect_tx(full + 8 * s, 2 * QB + 2 * RB);
          for (int c = 0; c < NP; ++c) {
            tma_load(q_s + c * BQ * 128, &p.q, full + 8 * s, 64 * c, q0, h, b);
            tma_load(q_s + QB + c * BQ * 128, &p.dout, full + 8 * s, 64 * c,
                     q0, h, b);
          }
          bulk_load(r_s, p.lse + row, RB, full + 8 * s);
          bulk_load(r_s + RB, p.delta + row, RB, full + 8 * s);
        }
      }
    } else if constexpr (!kDirect) {
      if (threadIdx.x >= 288) {                  // q2 from each landed q
        const int ct = threadIdx.x - 288;
        const uint4* gStages =
            reinterpret_cast<const uint4*>(smem_raw + (sStages - raw));
        uint4* gQ2 = reinterpret_cast<uint4*>(smem_raw + (sQ2 - raw));
        int ring = 0;
        for (int rd = 0; rd * (int)gridDim.x < p.items; ++rd) {
          const int item = snake_item(rd);
          if (item >= p.items) continue;
          const DkvItem w = dkv_item<BN, BQ>(p, item);
          for (int tt = 0; tt < w.tiles; ++tt, ++ring) {
            const int s = ring % ST, slot = ring % Q2;
            mbar_wait(full + 8 * s, (ring / ST) & 1);
            if (ring >= Q2) mbar_wait(q2empty + 8 * slot, (ring / Q2 - 1) & 1);
            const uint4* src = gStages + 2 * s * (QB / 16);
            uint4* dst = gQ2 + slot * (QB / 16);
            for (int i = ct; i < (int)(QB / 16); i += 96)
              dst[i] = scale_chunk(src[i], p.qscale);
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_arrive(q2full + 8 * slot);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    dkv_consumer<D, kDirect>(
        p, sK, sStages, sQ2,
        reinterpret_cast<const float*>(smem_raw + (sRows - raw)), bars, wg);
  }
}

// The mma.sync forward, above D = 256 only (fwd_bf16_sm90 takes the rest).
template <int D>
struct FwdTile {
  static_assert(D > 256, "D <= 256 runs fwd_bf16_sm90");
  static constexpr int BQ = 64, BK = 32, LD = D + 8;
  static constexpr int NC = 2;                 // column chunks (grid z)
  static constexpr int DC = D / NC;            // O columns a block owns
  static constexpr size_t smem = (size_t)(BQ + 2 * BK) * LD * sizeof(bf16);
};

// K1 / K4-fwd above D = 256.  Block: 64 q rows of one (b, h) and O columns
// c0 .. c0 + DC - 1; warp w owns rows 16w .. 16w + 15.
template <int D, bool kDirect>
__global__ void __launch_bounds__(kThreads) fwd_bf16(const Params p) {
  using C = FwdTile<D>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, DC = C::DC;
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
      frag_a(a, sQ, LD, warp * 16, kc * 16, g, tq);
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
    if (tq == 0 && blockIdx.z == 0)
      p.lse[(long long)bh * p.Sq + row] = (m[r] + log2f(lc)) * kLn2;
  }
}

// The mma.sync dQ body, above D = 256 only (dq_bf16_sm90 takes the rest).
template <int D>
struct DqTile {
  static_assert(D > 256, "D <= 256 runs dq_bf16_sm90");
  static constexpr int BQ = 64, BK = 32, LD = D + 8;
  static constexpr int NC = 2;                 // column chunks (grid z)
  static constexpr int DC = D / NC;            // dQ columns a block owns
  static constexpr size_t smem =
      (size_t)(2 * BQ + 2 * BK) * LD * sizeof(bf16) + 2 * BQ * sizeof(float);
};

// K2 / K4-dq above D = 256.  Block: 64 q rows of one (b, h) and dQ
// columns c0 .. c0 + DC - 1; warp w owns rows 16w .. 16w + 15.
template <int D, bool kDirect>
__global__ void __launch_bounds__(kThreads) dq_bf16(const Params p) {
  using C = DqTile<D>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, DC = C::DC;
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
      frag_a(aq, sQ, LD, warp * 16, kc * 16, g, tq);
      frag_a(ad, sdO, LD, warp * 16, kc * 16, g, tq);
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

// The mma.sync dK / dV body, above D = 256 only (dkv_bf16_sm90 takes the
// rest).
template <int D, bool kDirect>
struct DkvTile {
  static_assert(D > 256, "D <= 256 runs dkv_bf16_sm90");
  static constexpr int BK = 64, BQ = 16, LD = D + 8;
  static constexpr int NS = 2;                 // warps sharing a key group
  static constexpr int NC = 2;                 // column chunks (grid z)
  static constexpr int DW = D / NC / NS;       // dK / dV columns a warp owns
  static constexpr int NT = kThreads * NS;
  // K4 keeps one q tile: its scores come from the unscaled q
  static constexpr size_t smem =
      (size_t)(2 * BK + (kDirect ? 2 : 3) * BQ) * LD * sizeof(bf16) +
      2 * BQ * sizeof(float);
};

// K3 / K4-dkv above D = 256.  Block: 64 keys of one (b, hk) and dK / dV
// columns D / NC blockIdx.z .. + D / NC - 1; warp w owns keys 16 (w % 4)
// .. + 15 and DW of those columns from DW (w / 4) on, and computes the
// transposed tiles (keys x queries) directly.
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
// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(f)
                                            : nullptr;
  }();
  return fn;
}

// The map of a bf16 [B, S, H, D] tensor with element strides `st`, read in
// boxes of 64 columns x `rows` rows (one head, one batch).  A dimension of
// size 1 is never stepped, so it gets the row stride, which is legal.
bool tensor_map(CUtensorMap* map, const void* base, const Strides& st, int B,
                int S, int H, int D, int rows) {
  const EncodeTiledFn enc = encode_tiled();
  const cuuint64_t row = (cuuint64_t)st.s * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {row, H > 1 ? (cuuint64_t)st.h * 2 : row,
                                 B > 1 ? (cuuint64_t)st.b * 2 : row};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc && enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                    const_cast<void*>(base), dims, strides, box, unit,
                    CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The current device's primary context made current on this thread
// before a tensor map is encoded: the encoder is a driver call and needs
// one, and autograd runs the backward on a thread of its own, where none
// may be current yet (the map then fails to encode).
cudaError_t bind_context() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  return e == cudaSuccess ? cudaSetDevice(dev) : e;
}

// One block of 384 threads an SM (or an item), `smem` dynamic bytes.
template <typename A>
cudaError_t launch_persistent(void (*kern)(A), int items, size_t smem,
                              cudaStream_t st, const A& a) {
  if (items == 0) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<min(items, sms), 384, smem, st>>>(a);
  return cudaGetLastError();
}

template <int D, bool kDirect>
cudaError_t launch_fwd_sm90(const Params& p, cudaStream_t st) {
  using C = Sm90Fwd<D>;
  if (p.Sq % C::BQ || p.Sk % C::BK) return cudaErrorInvalidValue;
  if (!encode_tiled()) return cudaErrorNotSupported;
  if (const cudaError_t e = bind_context()) return e;
  FwdArgs a;
  if (!tensor_map(&a.q, p.q, p.sq, p.B, p.Sq, p.H, D, C::BQ) ||
      !tensor_map(&a.k, p.k, p.sk, p.B, p.Sk, p.Hk, D, C::BK) ||
      !tensor_map(&a.v, p.v, p.sv, p.B, p.Sk, p.Hk, D, C::BK))
    return cudaErrorInvalidValue;
  a.o = static_cast<bf16*>(p.out);
  a.lse = p.lse;
  a.H = p.H; a.rep = p.H / p.Hk; a.Sq = p.Sq; a.Sk = p.Sk;
  a.causal = p.causal; a.qscale = p.qscale;
  a.nq = p.Sq / C::BQ;
  a.items = p.B * p.H * a.nq;
  return launch_persistent(fwd_bf16_sm90<D, kDirect>, a.items, C::smem, st, a);
}

// K2 / K4-dq (w == kDq) or K3 / K4-dkv in bf16 up to D = 256: the sm90
// bodies.  q and dO are read in tiles of `qrows` rows, K and V of `krows`.
BwdArgs bwd_args(const Params& p, int D, int qrows, int krows, bool* ok) {
  BwdArgs a;
  *ok = tensor_map(&a.q, p.q, p.sq, p.B, p.Sq, p.H, D, qrows) &&
        tensor_map(&a.dout, p.dout, p.sdo, p.B, p.Sq, p.H, D, qrows) &&
        tensor_map(&a.k, p.k, p.sk, p.B, p.Sk, p.Hk, D, krows) &&
        tensor_map(&a.v, p.v, p.sv, p.B, p.Sk, p.Hk, D, krows);
  a.o = static_cast<const bf16*>(p.o);
  a.so = p.so;
  a.out = static_cast<bf16*>(p.out);
  a.out2 = static_cast<bf16*>(p.out2);
  a.lse = p.lse;
  a.delta = p.delta;
  a.H = p.H; a.Hk = p.Hk; a.rep = p.H / p.Hk; a.Sq = p.Sq; a.Sk = p.Sk;
  a.causal = p.causal; a.scale = p.scale; a.qscale = p.qscale;
  a.nq = p.Sq / qrows;
  a.nk = p.Sk / krows;
  return a;
}

template <int D, bool kDirect>
cudaError_t launch_dq_sm90(const Params& p, cudaStream_t st) {
  using C = Sm90Dq<D>;
  if (p.Sq % C::BQ || p.Sk % C::BK) return cudaErrorInvalidValue;
  if (!encode_tiled()) return cudaErrorNotSupported;
  if (const cudaError_t e = bind_context()) return e;
  bool ok = false;
  BwdArgs a = bwd_args(p, D, C::BQ, C::BK, &ok);
  if (!ok) return cudaErrorInvalidValue;
  a.items = p.B * p.H * a.nq;
  return launch_persistent(dq_bf16_sm90<D, kDirect>, a.items, C::smem, st,
                           a);
}

template <int D, bool kDirect>
cudaError_t launch_dkv_sm90(const Params& p, cudaStream_t st) {
  using C = Sm90Dkv<D, kDirect>;
  if (p.Sq % C::BQ || p.Sk % C::BN) return cudaErrorInvalidValue;
  if (!encode_tiled()) return cudaErrorNotSupported;
  if (const cudaError_t e = bind_context()) return e;
  bool ok = false;
  BwdArgs a = bwd_args(p, D, C::BQ, C::BN, &ok);
  if (!ok) return cudaErrorInvalidValue;
  a.items = p.B * p.Hk * a.nk;
  return launch_persistent(dkv_bf16_sm90<D, kDirect>, a.items, C::smem, st,
                           a);
}

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
      if constexpr (D <= 256) {
        return launch_fwd_sm90<D, kDirect>(p, st);
      } else {
        using C = FwdTile<D>;
        if (p.Sq % C::BQ || p.Sk % C::BK) return cudaErrorInvalidValue;
        return launch(fwd_bf16<D, kDirect>, dim3(p.Sq / C::BQ, BH, C::NC),
                      kThreads, C::smem, st, p);
      }
    }
    if constexpr (D <= 256) {                    // K2, K3 (K4-dq, K4-dkv)
      return w == kDq ? launch_dq_sm90<D, kDirect>(p, st)
                      : launch_dkv_sm90<D, kDirect>(p, st);
    } else {
      if (w == kDq) {
        using C = DqTile<D>;
        if (p.Sq % C::BQ || p.Sk % C::BK) return cudaErrorInvalidValue;
        return launch(dq_bf16<D, kDirect>, dim3(p.Sq / C::BQ, BH, C::NC),
                      kThreads, C::smem, st, p);
      }
      using C = DkvTile<D, kDirect>;
      if (p.Sq % C::BQ || p.Sk % C::BK) return cudaErrorInvalidValue;
      return launch(dkv_bf16<D, kDirect>, dim3(p.Sk / C::BK, BHk, C::NC),
                    C::NT, C::smem, st, p);
    }
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

// The bf16 forward's plan at head_dim D <= 256 as compiled (see
// flash_fwd_plan).
template <int D, bool kDirect>
cudaError_t fwd_plan(int* out) {
  using C = Sm90Fwd<D>;
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, fwd_bf16_sm90<D, kDirect>);
  if (e != cudaSuccess) return e;
  const int v[9] = {C::BQ, C::BK, C::STAGES, (int)C::smem, C::kThreads,
                    fa.numRegs, (int)fa.localSizeBytes,
                    (int)fa.sharedSizeBytes, fa.maxThreadsPerBlock};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return cudaSuccess;
}

template <bool kDirect>
cudaError_t fwd_plan_by_dim(int D, int* out) {
  switch (D) {
    case 64: return fwd_plan<64, kDirect>(out);
    case 128: return fwd_plan<128, kDirect>(out);
    case 192: return fwd_plan<192, kDirect>(out);
    case 256: return fwd_plan<256, kDirect>(out);
    default: return cudaErrorInvalidValue;
  }
}

// The bf16 backward's plans at head_dim D <= 256 as compiled (see
// flash_bwd_plan): K2 (dkv = false) or K3; K4-dq or K4-dkv with kDirect.
template <int D, bool kDirect>
cudaError_t bwd_plan(bool dkv, int* out) {
  using Q = Sm90Dq<D>;
  using K = Sm90Dkv<D, kDirect>;
  cudaFuncAttributes fa;
  const cudaError_t e =
      dkv ? cudaFuncGetAttributes(&fa, dkv_bf16_sm90<D, kDirect>)
          : cudaFuncGetAttributes(&fa, dq_bf16_sm90<D, kDirect>);
  if (e != cudaSuccess) return e;
  const int v[11] = {dkv ? K::BQ : Q::BQ, dkv ? K::BN : Q::BK,
                     dkv ? K::STAGES : Q::STAGES, dkv ? K::Q2 : 0,
                     dkv ? (int)K::kSplit : 0,
                     (int)(dkv ? K::smem : Q::smem), 384, fa.numRegs,
                     (int)fa.localSizeBytes, (int)fa.sharedSizeBytes,
                     fa.maxThreadsPerBlock};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return cudaSuccess;
}

template <bool kDirect>
cudaError_t bwd_plan_by_dim(int D, bool dkv, int* out) {
  switch (D) {
    case 64: return bwd_plan<64, kDirect>(dkv, out);
    case 128: return bwd_plan<128, kDirect>(dkv, out);
    case 192: return bwd_plan<192, kDirect>(dkv, out);
    case 256: return bwd_plan<256, kDirect>(dkv, out);
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

// The bf16 forward's tile plan at head_dim D (64, 128, 192 or 256), as
// compiled: out[0..8] = BQ, BK, stages, dynamic shared bytes, threads a
// block, and from cudaFuncGetAttributes the body's registers a thread (at
// entry, before setmaxnreg), local (spill) bytes, static shared bytes and
// largest block.  `direct` picks K4's body.
int flash_fwd_plan(int D, int direct, int* out) {
  return (int)(direct ? fwd_plan_by_dim<true>(D, out)
                      : fwd_plan_by_dim<false>(D, out));
}

// The bf16 backward's tile plan at head_dim D (64, 128, 192 or 256), as
// compiled, of K2 (dkv = 0) or K3 (dkv = 1): out[0..10] = q rows (K2: a
// block; K3: a ring stage), keys (K2: a ring stage; K3: a block), stages,
// q2 buffers (K3), split (K3: 1 if the two consumer warpgroups hold dV and
// dK of the same keys), dynamic shared bytes, threads a block, and from
// cudaFuncGetAttributes the body's registers a thread (at entry), local
// (spill) bytes, static shared bytes and largest block.  `direct` picks
// K4's bodies (K4-dq, K4-dkv: no q2 buffers).
int flash_bwd_plan(int D, int dkv, int direct, int* out) {
  return (int)(direct ? bwd_plan_by_dim<true>(D, dkv != 0, out)
                      : bwd_plan_by_dim<false>(D, dkv != 0, out));
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
