// The tensor-core pieces of the Psi kernels (psi_fwd.cu, psi_bwd.cu): the
// exponent tile, 64 x 64 base-2 exponents of data rows and upper-triangle
// cells (Psi2) or inducing points (Psi1), and the products that follow it.
//
// Replaces the direct-difference exponent that the kernels once formed per
// pair on the CUDA cores (one subtraction, product and FMA per latent
// dimension), and takes the place of the TPU's K-major basis product
// (gparml_tpu/ops/psi_pallas.py `_tile_basis`, `_flat_lhs3`, `_rz3_inputs`,
// run in `_fwd_flat_body` as bf16 hi/lo rungs on the MXU, the B~ = (coef
// z) z^T products of `_tile_stats_tri`, and the Psi1 tiles and Psi1^T Y,
// dpsi1 and dyw products of :151-153 and :355-358). With mu' = mu - zeta
// and zb' = (z_m + z_m') / 2 - zeta, z' = z_m - zeta (zeta = the
// per-dimension mean of Z, passed by the wrapper; the exponents depend on
// differences only, so the shift changes nothing but the magnitudes):
//
//   L2[n, p] = sum_k R[n, k] C[p, k] + rc_n + ce_p
//   R[n] = [2 c mu' log2e (QM) | -c log2e (QM) | 0 (pad)]   (the row operand)
//   C[p] = [zb' (QM) | zb'^2 (QM) | 0 (pad)]                (the cell operand)
//   rc_n = (lc_n - sum_q c mu'^2) log2e + S,  ce_p = E0_p log2e
//
// and Psi1 the same with c1 / 2 in place of c and the points in place of
// the cells (TcForm): L1[n, m] = sum_k [c1 mu' | -c1/2] log2e [z' | z'^2] +
// (l1_n - 1/2 sum_q c1 mu'^2) log2e + S1, no point constant.
//
// The row constant carries an exact shift (S, S1: whole numbers passed by
// the wrapper, -floor(max_n lc_n log2e)), so that every pair's exp2 lies
// below 2 and stays clear of float32's subnormal range, where
// ex2.approx.ftz would flush it to zero (at sf2 = 1e-20 every Psi2 entry
// lies there, at any Q; Psi1 past Q = 64 with the raw alpha); the kernels
// multiply their float64 totals by 2^-S.
//
// Up to the widest bucket (Q = 64 for Psi2, 16 for Psi1) K = 2 QM padded
// to a multiple of 8 (tc_k), one operand build per tile. Past it K is
// walked in chunks of kTcQChunk latent dimensions (each chunk [2 c mu' |
// -c] and [zb' | zb'^2] of its dimensions, kTcKChunk columns), built into
// shared memory in turn and added into the same accumulator registers, so
// nothing staged grows with Q.
//
// tc_tile runs the product as wgmma m64n64k8 in TF32 with the 3-term split
// hi = tf32(x), lo = tf32(x - hi): A_hi B_lo + A_lo B_hi first, then
// A_hi B_hi, float32 accumulators; the kernels add the constants in float32
// after it, apply exp2 and mask the padding in their epilogues (the
// operands hold no -inf). The rows sit on the tile's M axis in the row
// passes and on its N axis in the forwards and the column passes, so that
// each sums along N. The Psi1 kernels also run y . dPsi1Y (K = D, in
// chunks of kTcDChunk columns) through tc_tile. A single TF32 product would
// carry the exponent to ~1e-3 (a 1e-3 relative error in the statistic); the
// split and the centring keep it at float32's level: ops/psi_tc_model.py
// models this arithmetic on the CPU and tools/psi_tc_numerics.py measures
// it for Psi2 (<= 2.9e-6 of max|ref| on Psi2 and every gradient leaf at
// Q <= 64, latents offset +5; 2.4e-4 without the centring; past Q = 64
// <= 6.3e-6 with the shift, 4.5e-3 without it where Psi2 is subnormal);
// tests/test_torch_psi1_tc.py holds the Psi1 model within 1e-5 of float64.
//
// tc_reduce multiplies a tile of values still in the accumulator registers
// (the backward's g or w e, Psi1's p) by a transposed operand in shared
// memory, as the A operand of wgmma m64nNk8 from registers (the
// FlashAttention form of P V): Psi2's row sums [zb' | zb'^2 | 1] and cell
// sums [c mu' | c] (past Q = 64 one dimension chunk at a time); Psi1's
// p Y and p dPsi1Y, 3-term split as above. Psi1's centred sums are not
// products: the Psi1 passes take them pair by pair (psi_bwd.cu).
//
// Operands are K-major in shared memory as 8-row x 16-byte core matrices
// without swizzle (tc_at): the descriptor's leading byte offset is 128 (the
// next 4 columns of K), its stride byte offset 32 K (the next 8 rows).
// Cells are the upper triangle packed row by row (the wrapper's table), so
// a tile of 64 cells wastes nothing but the last block's tail. Rows are
// staged by cp.async up to the widest bucket, and read from device memory
// into each chunk's build past it.
//
// What bounds the kernels built on it, on an H100: operations, of three
// kinds that a kernel can overlap. The 3-term TF32 products are the
// largest floor: 3 K x 2 flops a pair for the exponents and, where a
// reduction follows, 3 N2 x 2 more (the Psi2 row pass at Q = 10: 288 flops
// a pair, 0.73 s at N = 1e7, M = 500 at 495 TFLOP/s); then the exp2 of
// each pair on the MUFU (16 a clock per SM: 0.30 s there); then the
// per-pair float32 and integer work of the epilogues (the constants, the
// weight, the hi/lo split of a register A operand) and the per-tile
// operand builds. Device memory carries O(N (Q + D)) bytes. The pipeline
// pieces below (mbarriers, named barriers, setmaxnreg) let a producer
// warpgroup build tiles while consumer warpgroups multiply them. Off the
// card (CPU emulation of these sources) tc_tile and tc_reduce run as scalar
// loops of the same 3-term split over the same layouts (their #ifndef
// __CUDA_ARCH__ twins); the pipeline pieces have none.
#pragma once

#include <string.h>

#include "psi_common.cuh"

namespace gparml {

// Rows and columns of an exponent tile (wgmma m64n64), and the threads of
// one warpgroup. A kernel runs one or two warpgroups (tc_wg), each on its
// own tiles; operands of more than 64 rows are 64-row tiles back to back
// (tc_at carries on past row 63).
constexpr int kTcRows = 64;
constexpr int kTcWarpgroup = 128;
// Row stride of the 64 x 64 tile that tc_reduce's scalar twin gathers
// (CPU emulation only).
constexpr int kTcTileLd = kTcRows + 1;
constexpr float kLog2e = 1.4426950408889634f;
// Latent dimensions of one K chunk past Q = 64, and its K columns.
constexpr int kTcQChunk = 16;
constexpr int kTcKChunk = 2 * kTcQChunk;
// Most K chunks whose float64 row or cell totals a backward pass past
// Q = 64 keeps in shared memory at once (64 x (2 x 160 + 1) doubles,
// 160 KB); wider Q is walked in passes over the dimensions, each
// recomputing the exponents.
constexpr int kTcPassChunks = 10;
// Psi1's exponent runs through the register buckets up to this Q and
// K-chunked past it; Y and dPsi1Y enter the Psi1 products in chunks of
// kTcDChunk columns.
constexpr int kTcP1BucketMax = 16;
constexpr int kTcDChunk = 16;
// Psi1's bucket of a Q bucket qm (0: past 64): qm up to kTcP1BucketMax,
// else 0 (K chunked).
__host__ __device__ constexpr int p1_qm(int qm) { return qm > 0 && qm <= kTcP1BucketMax ? qm : 0; }

// The row terms of the Psi2 (P1 = false) and Psi1 (P1 = true) exponents:
// den = kDen a s + 1, c = a / den, the row operand [kR c mu' | -kQ c]
// log2e and the constant (kSf log sf2 - 1/2 sum log den - kQ sum c mu'^2)
// log2e + S. Psi1 (c = c1) is Psi2's form with c / 2 in place of c.
template <bool P1>
struct TcForm {
  static constexpr float kDen = P1 ? 1.f : 2.f, kR = P1 ? 1.f : 2.f, kQ = P1 ? 0.5f : 1.f;
  static constexpr double kSf = P1 ? 1.0 : 2.0, kQd = P1 ? 0.5 : 1.0;
};

// K of a bucket: [2 c mu' | -c], 2 QM columns padded to a multiple of 8.
__host__ __device__ constexpr int tc_k(int qm) { return (2 * qm + 7) / 8 * 8; }
// Warpgroups of a block (consumer warpgroups where a producer warpgroup
// feeds them) and cell tiles per warpgroup of the forward without the cell
// sums, by bucket: as many as fit one block in 227 KB at Q = 64 (the
// passes that reduce on the tensor cores take one tile a warpgroup: two
// took 200 registers in the backward).
__host__ __device__ constexpr int tc_wg(int qm) { return qm <= 32 ? 2 : 1; }
__host__ __device__ constexpr int tc_fwd_ct(int qm) { return qm <= 16 ? 2 : 1; }
// N of the reduction products (tc_reduce), a multiple of 8: the backward
// row pass's [zb' | zb'^2 | 1] (2 QM + 1 columns) and the cell sums'
// [c mu' | c] (2 QM; psi2_fwd_tc_kernel<QM, true>).
__host__ __device__ constexpr int tc_n2_rows(int qm) { return (2 * qm + 1 + 7) / 8 * 8; }
__host__ __device__ constexpr int tc_n2_cells(int qm) { return (2 * qm + 7) / 8 * 8; }
// K position of column c (0..63) of an exponent tile when the tile, from
// its accumulator registers, is the A operand of a reduction product:
// within each 8 columns the even ones come first (a thread's registers hold
// columns 2t and 2t + 1 of each 8, and a TF32 A fragment takes columns t
// and t + 4).
__host__ __device__ constexpr int tc_kperm(int c) {
  return (c & ~7) | ((c & 1) ? 4 + ((c & 7) >> 1) : (c & 7) >> 1);
}

// Float index of element (r, k) of an operand with kp columns: K-major
// 8 x 4 core matrices (128 bytes each), K chunks adjacent.
__host__ __device__ constexpr int tc_at(int r, int k, int kp) {
  return ((r >> 3) * (kp >> 2) + (k >> 2)) * 32 + (r & 7) * 4 + (k & 3);
}

// Cells of an m x m upper triangle, and blocks of `per` cells.
__host__ __device__ inline int tri_cells(int m) { return m * (m + 1) / 2; }
__host__ __device__ inline int tc_blocks(int m, int per) {
  return (tri_cells(m) + per - 1) / per;
}

// x rounded to TF32 as cvt.rna.tf32.f32 does (nearest, ties away from
// zero, for finite x): two integer operations on the bit pattern.
__device__ inline float to_tf32(float x) {
  uint32_t b;
  memcpy(&b, &x, 4);
  b = (b + 0x1000u) & 0xffffe000u;
  float r;
  memcpy(&r, &b, 4);
  return r;
}

// 2^x on the MUFU (ex2.approx.ftz: relative error ~2^-22, results below
// 2^-126 flushed to zero; the shift S puts every pair within that range of
// the largest row's).
__device__ inline float tc_exp2(float x) {
#ifdef __CUDA_ARCH__
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return exp2f(x);
#endif
}

// Operand element idx = x, as its TF32 hi and lo parts.
__device__ inline void tc_put(float* hi, float* lo, int idx, float x) {
  const float h = to_tf32(x);
  hi[idx] = h;
  lo[idx] = to_tf32(x - h);
}

// Row (M index) and column (N index) of accumulator register i of this
// thread within its warpgroup's 64 x 64 tile: wgmma's m64nN f32 layout,
// warp w of the warpgroup holding rows 16 w .. 16 w + 15.
__device__ inline int tc_m(int i) {
  const int t = threadIdx.x & (kTcWarpgroup - 1);
  return (t >> 5) * 16 + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ inline int tc_n(int i) {
  return (i >> 2) * 8 + (threadIdx.x & 3) * 2 + (i & 1);
}

// 4-byte asynchronous copy from device to shared memory, and its group
// commit / wait.
__device__ inline void cp_async4(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}
__device__ inline void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}
template <int N>
__device__ inline void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// Order this thread's shared-memory stores before wgmma's reads of them
// (the async proxy), for whoever synchronises with it next.
__device__ inline void tc_fence_async() {
#ifdef __CUDA_ARCH__
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#endif
}

// Make this block's shared-memory stores visible to wgmma, then a block
// barrier.
__device__ inline void tc_operands_ready() {
  tc_fence_async();
  __syncthreads();
}

// --- the pipeline pieces: a ring of stages in shared memory that a
// producer warpgroup fills and consumer warpgroups drain (psi_fwd.cu
// psi2_fwd_tc_kernel, psi_bwd.cu psi2_bwd_rows_tc_kernel) ------------------

// The most dynamic shared memory an H100 gives a block.
constexpr size_t kTcSmemMax = 232448;

// An mbarrier in shared memory: tc_bar_init sets the arrivals that
// complete a phase (before a block barrier, after tc_bar_init_fence);
// tc_bar_arrive arrives, releasing this thread's earlier memory operations
// to whoever waits for the phase; tc_bar_wait waits (acquire) until the
// phase of the given parity has completed. A freshly initialised barrier
// is in phase 0, and counts the phase before it, parity 1, as complete.
__device__ inline void tc_bar_init(uint64_t* bar, int count) {
#ifdef __CUDA_ARCH__
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(bar)),
               "r"(count)
               : "memory");
#endif
}
__device__ inline void tc_bar_init_fence() {
#ifdef __CUDA_ARCH__
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#endif
}
__device__ inline void tc_bar_arrive(uint64_t* bar) {
#ifdef __CUDA_ARCH__
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(bar))
               : "memory");
#endif
}
#ifdef __CUDA_ARCH__
__device__ inline bool tc_bar_try(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
#endif
__device__ inline void tc_bar_wait(uint64_t* bar, int parity) {
#ifdef __CUDA_ARCH__
  const uint32_t b = (uint32_t)__cvta_generic_to_shared(bar);
  while (!tc_bar_try(b, parity)) {
  }
#endif
}

// Named barrier id (0 is __syncthreads') of `threads` threads.
__device__ inline void tc_bar_sync(int id, int threads) {
#ifdef __CUDA_ARCH__
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
#endif
}

// Give a warpgroup's registers back (dec) or take them (inc): every thread
// of the warpgroup, N a multiple of 8 in [24, 256].
template <int N>
__device__ inline void tc_setmaxnreg_dec() {
#ifdef __CUDA_ARCH__
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
#endif
}
template <int N>
__device__ inline void tc_setmaxnreg_inc() {
#ifdef __CUDA_ARCH__
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
#endif
}

// Keep values in registers live and unmoved up to here: an accumulator or
// A register of a wgmma group belongs to the hardware until the group is
// waited for, and the compiler must not read it earlier or reuse it.
template <int N>
__device__ inline void tc_fence_vals(float (&v)[N]) {
#ifdef __CUDA_ARCH__
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(v[i])::"memory");
#endif
}

#ifdef __CUDA_ARCH__
// wgmma shared-memory descriptor of a K-major operand with kp columns,
// no swizzle: start address, leading byte offset 128 (adjacent K chunks),
// stride byte offset 32 kp (adjacent 8-row groups), all in 16-byte units.
__device__ inline uint64_t tc_desc(const float* p, int kp) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)(128 >> 4) << 16;
  d |= (uint64_t)((32 * kp) >> 4) << 32;
  return d;
}

// d (+)= A (64 x 8) . B (64 x 8)^T, TF32 in, float32 accumulate.
__device__ inline void wgmma_tf32(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}
#endif

// Wait until at most N of this warpgroup's committed wgmma groups are
// still in flight (they complete in order).
template <int N>
__device__ inline void tc_wgmma_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
#endif
}

// The tile's product: d[i] (+)= sum_k A[tc_m(i), k] B[tc_n(i), k] in the
// 3-term split, the small terms first, A and B 64-row operands; with
// `accumulate` (a later K chunk) added to d. Every thread of a warpgroup
// calls it (each warpgroup on its own A), after its operands are ready.
// tc_tile_issue commits the products as one wgmma group and returns at
// once: d is the hardware's until tc_wgmma_wait has seen the group
// complete, and the caller then fences it (tc_fence_vals) before reading.
template <int KP>
__device__ inline void tc_tile_issue(const float* a_hi, const float* a_lo, const float* b_hi,
                                     const float* b_lo, float (&d)[32], bool accumulate = false) {
#ifdef __CUDA_ARCH__
  tc_fence_vals(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < KP / 8; ++s) {
    wgmma_tf32(d, tc_desc(a_hi + 64 * s, KP), tc_desc(b_lo + 64 * s, KP), accumulate || s > 0);
    wgmma_tf32(d, tc_desc(a_lo + 64 * s, KP), tc_desc(b_hi + 64 * s, KP), 1);
  }
#pragma unroll
  for (int s = 0; s < KP / 8; ++s)
    wgmma_tf32(d, tc_desc(a_hi + 64 * s, KP), tc_desc(b_hi + 64 * s, KP), 1);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#endif
}

template <int KP>
__device__ inline void tc_tile(const float* a_hi, const float* a_lo, const float* b_hi,
                               const float* b_lo, float (&d)[32], bool accumulate = false) {
#ifdef __CUDA_ARCH__
  tc_tile_issue<KP>(a_hi, a_lo, b_hi, b_lo, d, accumulate);
  tc_wgmma_wait<0>();
  tc_fence_vals(d);
#else
  for (int i = 0; i < 32; ++i) {
    const int r = tc_m(i), c = tc_n(i);
    float small = 0.f, big = 0.f;
    for (int k = 0; k < KP; ++k) {
      const int ia = tc_at(r, k, KP), ib = tc_at(c, k, KP);
      small = fmaf(a_hi[ia], b_lo[ib], small);
      small = fmaf(a_lo[ia], b_hi[ib], small);
      big = fmaf(a_hi[ia], b_hi[ib], big);
    }
    d[i] = (accumulate ? d[i] : 0.f) + small;
    d[i] += big;
  }
#endif
}

#ifdef __CUDA_ARCH__
// d (+)= A (64 x 8, TF32 in registers: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4) for g = 16 warp + lane / 4, t = lane % 4) . B (N x 8)^T,
// one wgmma m64nNk8 for each N the reduction products take.
template <int N>
struct TcRs;
template <>
struct TcRs<8> {
  __device__ static void mma(float* d, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
  }
};
template <>
struct TcRs<16> {
  __device__ static void mma(float* d, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
  }
};
template <>
struct TcRs<24> {
  __device__ static void mma(float* d, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
  }
};
template <>
struct TcRs<32> {
  __device__ static void mma(float* d, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
  }
};
template <>
struct TcRs<40> {
  __device__ static void mma(float* d, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19}, {%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
  }
};
template <>
struct TcRs<64> {
  __device__ static void mma(float* d, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
  }
};
template <>
struct TcRs<72> {
  __device__ static void mma(float* d, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35}, {%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
  }
};
template <>
struct TcRs<128> {
  __device__ static void mma(float* d, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
  }
};
template <>
struct TcRs<136> {
  __device__ static void mma(float* d, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %73, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n136k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67}, {%68, %69, %70, %71}, %72, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
  }
};
#endif

// A 64 x 64 tile of values in accumulator registers (x[i] at (tc_m(i),
// tc_n(i))) as the TF32 A operand of reduction products, hi and lo (split
// once for all of a tile's dimension chunks in the K-chunked passes). Off
// the card it keeps the tile in `scratch` (64 x kTcTileLd floats a
// warpgroup) for the scalar twin of tc_reduce_split. Every thread of the
// block calls set().
struct TcRegA {
  uint32_t hi[32], lo[32];
  __device__ void set(const float (&x)[32], float* scratch) {
#ifdef __CUDA_ARCH__
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float h = to_tf32(x[i]);
      hi[i] = __float_as_uint(h);
      lo[i] = __float_as_uint(to_tf32(x[i] - h));
    }
    fence();
#else
    for (int i = 0; i < 32; ++i) scratch[tc_m(i) * kTcTileLd + tc_n(i)] = x[i];
    __syncthreads();
#endif
  }
  // tc_fence_vals of the registers
  __device__ void fence() {
#ifdef __CUDA_ARCH__
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(hi[i]), "+r"(lo[i])::"memory");
#endif
  }
};

// A warpgroup's 64-row K-major operand (hi, lo; KP columns, rows r0 ..
// r0 + 63) as the A registers of tc_tile_issue_regs: for K step s its
// elements (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of columns 8 s
// .. 8 s + 7, g = 16 warp + lane / 4, t = lane % 4, the TF32 A fragment.
// Loaded once where the operand stays fixed over a walk (the rows of the
// Psi2 row pass), it spares the walk's products their A reads from shared
// memory.
template <int KP>
struct TcRowsA {
  uint32_t hi[KP / 2], lo[KP / 2];
  __device__ void load(const float* o_hi, const float* o_lo, int r0) {
    const int lane = threadIdx.x & 31;
    const int g = r0 + (threadIdx.x & (kTcWarpgroup - 1)) / 32 * 16 + lane / 4, t = lane % 4;
#pragma unroll
    for (int s = 0; s < KP / 8; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int at = tc_at(g + 8 * (j & 1), 8 * s + t + 4 * (j >> 1), KP);
        hi[4 * s + j] = __float_as_uint(o_hi[at]);
        lo[4 * s + j] = __float_as_uint(o_lo[at]);
      }
  }
};

// tc_tile_issue with A from registers (TcRowsA): the same products in the
// same order, committed as one wgmma group.
template <int KP>
__device__ inline void tc_tile_issue_regs(const TcRowsA<KP>& a, const float* b_hi,
                                          const float* b_lo, float (&d)[32]) {
#ifdef __CUDA_ARCH__
  tc_fence_vals(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < KP / 8; ++s) {
    TcRs<64>::mma(d, a.hi[4 * s], a.hi[4 * s + 1], a.hi[4 * s + 2], a.hi[4 * s + 3],
                  tc_desc(b_lo + 64 * s, KP), s > 0);
    TcRs<64>::mma(d, a.lo[4 * s], a.lo[4 * s + 1], a.lo[4 * s + 2], a.lo[4 * s + 3],
                  tc_desc(b_hi + 64 * s, KP), 1);
  }
#pragma unroll
  for (int s = 0; s < KP / 8; ++s)
    TcRs<64>::mma(d, a.hi[4 * s], a.hi[4 * s + 1], a.hi[4 * s + 2], a.hi[4 * s + 3],
                  tc_desc(b_hi + 64 * s, KP), 1);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#endif
}

// A reduction product of the backward: d2 = X . B2^T with X a warpgroup's
// 64 x 64 tile of values, split into a (TcRegA), and B2 an N2 x 64 K-major
// operand in shared memory whose K axis is the tile's columns in tc_kperm
// order; d2[e] is element (tc_m(e), tc_n(e)) of the 64 x N2 result. 3-term
// TF32 split as tc_tile's, the small terms first; wgmma m64nNk8 with A from
// registers, one per K step and term. Every thread of a warpgroup calls it,
// after its operands are ready. tc_reduce_issue commits the products as one
// wgmma group and returns at once: d2 and a are the hardware's until
// tc_wgmma_wait has seen the group complete (then tc_fence_vals(d2),
// a.fence()).
template <int N2>
__device__ inline void tc_reduce_issue(TcRegA& a, const float* b_hi, const float* b_lo,
                                       float (&d2)[N2 / 2]) {
#ifdef __CUDA_ARCH__
  tc_fence_vals(d2);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    TcRs<N2>::mma(d2, a.hi[4 * s], a.hi[4 * s + 2], a.hi[4 * s + 1], a.hi[4 * s + 3],
                  tc_desc(b_lo + 64 * s, 64), s > 0);
    TcRs<N2>::mma(d2, a.lo[4 * s], a.lo[4 * s + 2], a.lo[4 * s + 1], a.lo[4 * s + 3],
                  tc_desc(b_hi + 64 * s, 64), 1);
  }
#pragma unroll
  for (int s = 0; s < 8; ++s)
    TcRs<N2>::mma(d2, a.hi[4 * s], a.hi[4 * s + 2], a.hi[4 * s + 1], a.hi[4 * s + 3],
                  tc_desc(b_hi + 64 * s, 64), 1);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#endif
}

template <int N2>
__device__ inline void tc_reduce_split(TcRegA& a, const float* b_hi, const float* b_lo,
                                       float (&d2)[N2 / 2], const float* scratch) {
#ifdef __CUDA_ARCH__
  tc_reduce_issue<N2>(a, b_hi, b_lo, d2);
  tc_wgmma_wait<0>();
  tc_fence_vals(d2);
  a.fence();
#else
  for (int e = 0; e < N2 / 2; ++e) {
    const int r = tc_m(e), n = tc_n(e);
    float small = 0.f, big = 0.f;
    for (int kp = 0; kp < 64; ++kp) {
      const int p = kp & 7;
      const int c = (kp & ~7) + (p < 4 ? 2 * p : 2 * (p - 4) + 1);  // tc_kperm(c) == kp
      const float x = scratch[r * kTcTileLd + c];
      const float ahv = to_tf32(x), alv = to_tf32(x - ahv);
      const int ib = tc_at(n, kp, 64);
      small = fmaf(ahv, b_lo[ib], small);
      small = fmaf(alv, b_hi[ib], small);
      big = fmaf(ahv, b_hi[ib], big);
    }
    d2[e] = small + big;
  }
#endif
}

// tc_reduce_split of the tile x (in the accumulator registers of tc_tile),
// split here. Every thread of the block calls it; off the card the tile
// goes through `scratch`.
template <int N2>
__device__ inline void tc_reduce(float (&x)[32], const float* b_hi, const float* b_lo,
                                 float (&d2)[N2 / 2], float* scratch) {
  TcRegA a;
  a.set(x, scratch);
  tc_reduce_split<N2>(a, b_hi, b_lo, d2, scratch);
#ifndef __CUDA_ARCH__
  __syncthreads();
#endif
}

// Shared memory of the emulation-only scratch of tc_reduce (a tile a
// warpgroup), none in a CUDA build.
__host__ __device__ constexpr size_t tc_scratch_bytes(int warpgroups) {
#ifdef __CUDACC__
  return 0 * warpgroups;
#else
  return (size_t)warpgroups * kTcRows * kTcTileLd * sizeof(float);
#endif
}

// Shared memory of the tile kernels, in 128-byte aligned regions carved in
// a fixed order (TcCarve); each kernel's *_smem function adds up the same
// regions.
__host__ __device__ constexpr size_t tc_region(size_t bytes) { return (bytes + 127) / 128 * 128; }
// hi and lo of an operand of `rows` rows.
__host__ __device__ constexpr size_t tc_operand_bytes(int rows, int qm) {
  return 2 * tc_region((size_t)rows * tc_k(qm) * sizeof(float));
}
// One raw stage of `rows` rows: mu, s (rows x QM) and w (rows).
__host__ __device__ constexpr size_t tc_stage_bytes(int rows, int qm) {
  return tc_region(((size_t)2 * rows * qm + rows) * sizeof(float));
}
// The transposed operand (hi and lo) of a reduction product with n2 rows.
__host__ __device__ constexpr size_t tc_b2_bytes(int n2) {
  return 2 * tc_region((size_t)n2 * kTcRows * sizeof(float));
}
// What tc_build_cells writes beside the operand for `cells` cells: ce and
// (i, j).
__host__ __device__ constexpr size_t tc_cellterm_bytes(int cells) {
  return tc_region((size_t)cells * sizeof(float)) + tc_region((size_t)cells * sizeof(int2));
}

struct TcCarve {
  char* p;
  __device__ explicit TcCarve(void* base) : p(static_cast<char*>(base)) {}
  template <typename T>
  __device__ T* take(size_t bytes) {
    T* r = reinterpret_cast<T*>(p);
    p += tc_region(bytes);
    return r;
  }
};

// An operand (hi, lo) of `rows` rows, zeroed: its padding columns stay
// zero; the builds write the rest.
struct TcOperand {
  float *hi, *lo;
};
template <int KP>
__device__ inline TcOperand tc_take_operand(TcCarve& cv, int rows) {
  const size_t bytes = (size_t)rows * KP * sizeof(float);
  TcOperand o{cv.take<float>(bytes), cv.take<float>(bytes)};
  for (int i = threadIdx.x; i < rows * KP; i += blockDim.x) o.hi[i] = o.lo[i] = 0.f;
  return o;
}

// Stage raw rows [n0, n0 + R) of mu, s (zero past hi or q) and w (zero
// past hi) into st = [mu (R x QM) | s (R x QM) | w (R)] with asynchronous
// copies; neighbouring threads copy neighbouring addresses in both layouts.
template <int QM, int R>
__device__ inline void tc_stage_rows(const float* __restrict__ mu, const float* __restrict__ s,
                                     Strides ls, const float* __restrict__ w, int q, int n0,
                                     int hi, float* st) {
  float* st_mu = st;
  float* st_s = st + R * QM;
  float* st_w = st_s + R * QM;
  const bool by_row = ls.rows_contiguous();
  for (int i = threadIdx.x; i < R * QM; i += blockDim.x) {
    int r, k;
    stage_index<R>(i, QM, by_row, &r, &k);
    const int n = n0 + r, at = r * QM + k;
    if (n < hi && k < q) {
      cp_async4(st_mu + at, mu + ls.at(n, k));
      cp_async4(st_s + at, s + ls.at(n, k));
    } else {
      st_mu[at] = 0.f;
      st_s[at] = 0.f;
    }
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    if (n0 + r < hi)
      cp_async4(st_w + r, w + n0 + r);
    else
      st_w[r] = 0.f;
  }
}

// From a raw stage of R rows: the row operand (R rows) and the row
// constant s_rc[r] (with the shift, in double, rounded once) of the Psi2
// (P1 = false) or Psi1 exponent (TcForm); with b2 (Psi2, R = 64, the cell
// pass), the transposed operand [c mu' | c] (2 QM x 64, row r of the stage
// at K position tc_kperm(r)) of its reduction product, whose padding rows
// stay zero; with cmu (Psi1), c and mu' as floats, cmu[k * R + r] and
// cmu[(QM + k) * R + r]. The block's first NT threads build (NT = 0: all
// of them): NT / R neighbouring threads share a row, each taking every
// (NT / R)-th dimension, and add their parts of
// the row constant with warp shuffles in a fixed order: sum_q log den as
// the logs of float32 products of up to 8 terms, and sum_q c mu'^2, both in
// double.
template <int QM, int KP, int R, bool P1 = false, int NT = 0>
__device__ inline void tc_build_rows(const float* st, const float* __restrict__ alpha,
                                     const float* __restrict__ zeta, float logsf2, float shift,
                                     int q, const TcOperand& op, float* s_rc,
                                     const TcOperand* b2, float* cmu = nullptr) {
  using F = TcForm<P1>;
  const float* st_mu = st;
  const float* st_s = st + R * QM;
  const int tpr = (NT ? NT : blockDim.x) / R;  // 1, 2 or 4
  const int r = threadIdx.x / tpr, sub = threadIdx.x % tpr;
  double lsum = 0.0, cm = 0.0;
  float prod = 1.f;
  int in_prod = 0;
  for (int k = sub; k < QM; k += tpr) {
    const int i = r * QM + k;
    float c = 0.f, mv = 0.f;
    if (k < q) {
      const float a = alpha[k];
      const float den = F::kDen * a * st_s[i] + 1.f;
      c = a / den;
      mv = st_mu[i] - zeta[k];
      prod *= den;
      if (++in_prod == 8) {
        lsum += (double)logf(prod);
        prod = 1.f;
        in_prod = 0;
      }
      cm += (double)(c * mv * mv);
    }
    tc_put(op.hi, op.lo, tc_at(r, k, KP), (F::kR * c * mv) * kLog2e);
    tc_put(op.hi, op.lo, tc_at(r, QM + k, KP), -(F::kQ * c) * kLog2e);
    if (b2) {
      tc_put(b2->hi, b2->lo, tc_at(k, tc_kperm(r), 64), c * mv);
      tc_put(b2->hi, b2->lo, tc_at(QM + k, tc_kperm(r), 64), c);
    }
    if (cmu) {
      cmu[k * R + r] = c;
      cmu[(QM + k) * R + r] = mv;
    }
  }
  if (in_prod) lsum += (double)logf(prod);
  for (int o = 1; o < tpr; o <<= 1) {
    lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
    cm += __shfl_xor_sync(0xffffffffu, cm, o);
  }
  if (sub == 0)
    s_rc[r] = (float)((F::kSf * (double)logsf2 - 0.5 * lsum - F::kQd * cm) * (double)kLog2e +
                      (double)shift);
}

// Cells [p0, p0 + NC) of the wrapper's packed table: s_ij[c] ((-1, -1)
// past the last cell), s_ce[c] (0 past it) and, with kmat, s_k[c] = kmat[i,
// j] (0 past it). No barrier.
template <int NC>
__device__ inline void tc_stage_cells(const int2* __restrict__ cells, const float* __restrict__ ce,
                                      const float* __restrict__ kmat, int m, int p0, int2* s_ij,
                                      float* s_ce, float* s_k) {
  const int ncell = tri_cells(m);
  for (int c = threadIdx.x; c < NC; c += blockDim.x) {
    const bool live = p0 + c < ncell;
    const int2 ij = live ? cells[p0 + c] : make_int2(-1, -1);
    s_ij[c] = ij;
    s_ce[c] = live ? ce[p0 + c] : 0.f;
    if (s_k) s_k[c] = live ? kmat[(size_t)ij.x * m + ij.y] : 0.f;
  }
}

// The cell operand of packed cells [p0, p0 + NC) (cells[p] = (i, j), i <=
// j; ce[p] = E0 log2e, both from the wrapper), and per cell c: s_ce[c]
// (0 past the last cell) and s_ij[c] ((-1, -1) past it). Two barriers
// inside.
template <int QM, int KP, int NC>
__device__ inline void tc_build_cells(const float* __restrict__ z, const float* __restrict__ zeta,
                                      const int2* __restrict__ cells,
                                      const float* __restrict__ ce, int m, int q, int p0,
                                      const TcOperand& op, float* s_ce, int2* s_ij) {
  tc_stage_cells<NC>(cells, ce, nullptr, m, p0, s_ij, s_ce, nullptr);
  __syncthreads();
  for (int t = threadIdx.x; t < NC * QM; t += blockDim.x) {
    const int c = t / QM, k = t % QM;
    const int2 ij = s_ij[c];
    float zb = 0.f;
    if (ij.x >= 0 && k < q) {
      const float zi = z[(size_t)ij.x * q + k] - zeta[k];
      const float zj = z[(size_t)ij.y * q + k] - zeta[k];
      zb = 0.5f * (zi + zj);
    }
    tc_put(op.hi, op.lo, tc_at(c, k, KP), zb);
    tc_put(op.hi, op.lo, tc_at(c, QM + k, KP), zb * zb);
  }
  __syncthreads();
}

// The most rows of one N-split of a pass whose blocks hold fixed cells or
// points and walk the rows (psi2_fwd_tc_kernel, the backward's point
// pass and chunked cell pass).
constexpr int kCellRowsMax = 262144;

// --- the K-chunked pieces (Q > 64) ------------------------------------------

// hi and lo of a chunk operand of `rows` rows (kTcKChunk columns).
__host__ __device__ constexpr size_t tc_chunk_operand_bytes(int rows) {
  return 2 * tc_region((size_t)rows * kTcKChunk * sizeof(float));
}

// d (+)= one K chunk's tile product, for the Psi1 kernels: the first chunk
// into d, every later one into its own accumulator and added to d on the
// CUDA cores (rounded to nearest), so that the tensor cores' accumulation
// never runs over more than one chunk of the expanded exponent's large
// terms (past Q = 16 they reach hundreds where the exponent is tens).
template <int KC>
__device__ inline void tc_tile_chunk(const float* a_hi, const float* a_lo, const float* b_hi,
                                     const float* b_lo, float (&d)[32], bool first) {
  if (first) {
    tc_tile<KC>(a_hi, a_lo, b_hi, b_lo, d);
    return;
  }
  float part[32];
  tc_tile<KC>(a_hi, a_lo, b_hi, b_lo, part);
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] += part[i];
}

// An operand (hi, lo) of `rows` rows of `cols` columns, not zeroed: the
// chunk builds write every element.
__device__ inline TcOperand tc_take_chunk(TcCarve& cv, int rows, int cols) {
  const size_t bytes = (size_t)rows * cols * sizeof(float);
  return TcOperand{cv.take<float>(bytes), cv.take<float>(bytes)};
}

// Dimensions a backward pass keeps totals for past Q = 64: whole chunks,
// as few passes as kTcPassChunks allows, spread evenly.
__host__ __device__ inline int tc_pass_dims(int q) {
  const int chunks = (q + kTcQChunk - 1) / kTcQChunk;
  const int passes = (chunks + kTcPassChunks - 1) / kTcPassChunks;
  return (chunks + passes - 1) / passes * kTcQChunk;
}

// A row constant summed over the K chunks by the threads of a row, as
// tc_build_rows sums it: sum_q log den as the logs of float32 products of
// up to 8 terms, and sum_q c mu'^2, both in double.
struct TcRowConst {
  double lsum = 0.0, cm = 0.0;
  float prod = 1.f;
  int in_prod = 0;
  __device__ void add(float den, float c, float mv) {
    prod *= den;
    if (++in_prod == 8) {
      lsum += (double)logf(prod);
      prod = 1.f;
      in_prod = 0;
    }
    cm += (double)(c * mv * mv);
  }
};

// A thread's share of one K chunk of rows [n0, n0 + R), built by NT
// threads: NT / R neighbouring threads share a row, each taking every
// (NT / R)-th of the chunk's kTcQChunk dimensions, the same ones in every
// chunk. load() reads the chunk's raw values (mu, s, alpha, zeta) into
// registers, all its loads issued together, so that a kernel can issue the
// next chunk's before it multiplies this one; put() writes from them, with
// op, the chunk of the row operand (R x kTcKChunk, [2 c mu' log2e | -c
// log2e]); with b2 (the cell pass), for each 64-row tile t the chunk of its
// transposed operand [c mu' | c] in b2[t] (2 kTcQChunk x 64, row r at K
// position tc_kperm(r)); with rc, each thread adds its share of its row's
// constant; with cmu (Psi1's point pass), c and mu' as floats, cmu[kk * R
// + r] and cmu[(kTcQChunk + kk) * R + r]. Zero past hi or q.
template <int R, int NT, bool P1 = false>
struct TcRowChunk {
  using F = TcForm<P1>;
  static constexpr int kTpr = NT / R, kE = kTcQChunk / kTpr;
  // alpha and zeta: held per element for Psi2, read again in put() for
  // Psi1 (whose passes keep more of their registers live)
  static constexpr int kA = P1 ? 1 : kE;
  float sv[kE], mv[kE], av[kA], zv[kA];
  const float* alpha_ = nullptr;
  const float* zeta_ = nullptr;
  __device__ void load(const float* __restrict__ mu, const float* __restrict__ s, Strides ls,
                       const float* __restrict__ alpha, const float* __restrict__ zeta, int q,
                       int n0, int hi, int k0) {
    const int n = n0 + threadIdx.x / kTpr, sub = threadIdx.x % kTpr;
    if constexpr (P1) {
      alpha_ = alpha;
      zeta_ = zeta;
    }
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int k = k0 + sub + kTpr * j;
      const bool live = n < hi && k < q;
      sv[j] = live ? s[ls.at(n, k)] : 0.f;
      mv[j] = live ? mu[ls.at(n, k)] : 0.f;
      if constexpr (!P1) {
        av[j] = live ? alpha[k] : 0.f;
        zv[j] = live ? zeta[k] : 0.f;
      }
    }
  }
  __device__ void put(int q, int n0, int hi, int k0, const TcOperand* op, const TcOperand* b2,
                      TcRowConst* rc, float* cmu = nullptr) const {
    const int r = threadIdx.x / kTpr, sub = threadIdx.x % kTpr;
    const bool row_live = n0 + r < hi;
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int kk = sub + kTpr * j;
      float c = 0.f, mvc = 0.f;
      if (row_live && k0 + kk < q) {
        const float a = P1 ? alpha_[k0 + kk] : av[j < kA ? j : 0];
        const float zt = P1 ? zeta_[k0 + kk] : zv[j < kA ? j : 0];
        const float den = F::kDen * a * sv[j] + 1.f;
        c = a / den;
        mvc = mv[j] - zt;
        if (rc) rc->add(den, c, mvc);
      }
      if (op) {
        tc_put(op->hi, op->lo, tc_at(r, kk, kTcKChunk), (F::kR * c * mvc) * kLog2e);
        tc_put(op->hi, op->lo, tc_at(r, kTcQChunk + kk, kTcKChunk), -(F::kQ * c) * kLog2e);
      }
      if (b2) {
        const TcOperand& bt = b2[r / kTcRows];
        tc_put(bt.hi, bt.lo, tc_at(kk, tc_kperm(r % kTcRows), 64), c * mvc);
        tc_put(bt.hi, bt.lo, tc_at(kTcQChunk + kk, tc_kperm(r % kTcRows), 64), c);
      }
      if (cmu) {
        cmu[kk * R + r] = c;
        cmu[(kTcQChunk + kk) * R + r] = mvc;
      }
    }
  }
};

// The row constants of rows [n0, n0 + R) from the threads' shares (every
// thread calls it; warp shuffles in a fixed order): s_rc[r] = (lc - sum_q c
// mu'^2) log2e + shift, summed in double and rounded once, and s_w[r] (0
// past hi). No barrier.
template <int R, bool P1 = false>
__device__ inline void tc_finish_rows(TcRowConst& rc, const float* __restrict__ w, float logsf2,
                                      float shift, int n0, int hi, float* s_rc, float* s_w) {
  using F = TcForm<P1>;
  const int tpr = blockDim.x / R;
  const int r = threadIdx.x / tpr, sub = threadIdx.x % tpr;
  if (rc.in_prod) rc.lsum += (double)logf(rc.prod);
  for (int o = 1; o < tpr; o <<= 1) {
    rc.lsum += __shfl_xor_sync(0xffffffffu, rc.lsum, o);
    rc.cm += __shfl_xor_sync(0xffffffffu, rc.cm, o);
  }
  if (sub == 0) {
    s_rc[r] = (float)((F::kSf * (double)logsf2 - 0.5 * rc.lsum - F::kQd * rc.cm) *
                          (double)kLog2e +
                      (double)shift);
    s_w[r] = n0 + r < hi ? w[n0 + r] : 0.f;
  }
}

// A thread's share of one K chunk of the NC cells staged in s_ij, built
// by NT threads: element j of thread t is cell c, dimension kk of the chunk
// with (kk % 4, c % 8) from the lane, so that a warp's stores into the
// operand's core matrices fall in distinct banks. load() reads z_i - zeta
// and z_j - zeta into registers, all its loads issued together; put()
// writes from them, with op, the chunk of the cell operand (NC x
// kTcKChunk, [zb' | zb'^2]); with b2 (the row pass), for each 64-cell tile
// t the chunk of its transposed operand [zb' | zb'^2] in b2[t] (2
// kTcQChunk x 64, cell c at K position tc_kperm(c)). Zero past the last
// cell or q.
template <int NC, int NT>
struct TcCellChunk {
  static constexpr int kE = NC * kTcQChunk / NT;
  float zi[kE], zj[kE];
  __device__ static void at(int j, int* c, int* kk) {
    const int t = threadIdx.x + NT * j, rest = t >> 5;
    *c = (rest % (NC / 8)) * 8 + ((t >> 2) & 7);
    *kk = (rest / (NC / 8)) * 4 + (t & 3);
  }
  __device__ void load(const float* __restrict__ z, const float* __restrict__ zeta,
                       const int2* s_ij, int q, int k0) {
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      int c, kk;
      at(j, &c, &kk);
      const int k = k0 + kk;
      const int2 ij = s_ij[c];
      const bool live = ij.x >= 0 && k < q;
      const float zk = live ? zeta[k] : 0.f;
      zi[j] = live ? z[(size_t)ij.x * q + k] - zk : 0.f;
      zj[j] = live ? z[(size_t)ij.y * q + k] - zk : 0.f;
    }
  }
  __device__ void put(const TcOperand* op, const TcOperand* b2) const {
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      int c, kk;
      at(j, &c, &kk);
      const float zb = 0.5f * (zi[j] + zj[j]);
      if (op) {
        tc_put(op->hi, op->lo, tc_at(c, kk, kTcKChunk), zb);
        tc_put(op->hi, op->lo, tc_at(c, kTcQChunk + kk, kTcKChunk), zb * zb);
      }
      if (b2) {
        const TcOperand& bt = b2[c / kTcRows];
        tc_put(bt.hi, bt.lo, tc_at(kk, tc_kperm(c % kTcRows), 64), zb);
        tc_put(bt.hi, bt.lo, tc_at(kTcQChunk + kk, tc_kperm(c % kTcRows), 64), zb * zb);
      }
    }
  }
};

// Row stride (doubles) of the float64 totals of qp dimensions: [first |
// second] sums, one more to spread the rows over the banks.
__host__ __device__ constexpr int tc_tot_ld(int qp) { return 2 * qp + 1; }

// Add a dimension chunk's reduction product d2 (64 x 2 kTcQChunk: columns
// [0, kTcQChunk) the first sum of dimensions kd.., the rest the second) into
// the float64 totals tot (64 rows of tc_tot_ld(qp): [first | second] of the
// pass's dimensions, off = kd - the pass's first). Each element has one
// owner.
__device__ inline void tc_add_chunk(const float (&d2)[kTcQChunk], double* tot, int qp, int off) {
#pragma unroll
  for (int e = 0; e < kTcQChunk; ++e) {
    const int col = tc_n(e), half = col / kTcQChunk;
    tot[tc_m(e) * tc_tot_ld(qp) + half * qp + off + col % kTcQChunk] += (double)d2[e];
  }
}

// --- the Psi1 pieces: inducing points in place of the packed cells ---------

// Warpgroups of a Psi1 block: each owns 64-tiles of the fixed side (points
// in the forward and the point pass, rows in the row pass); the walked
// side's operands are built once for both. kP1Fixed: the row pass's rows a
// block.
constexpr int kP1Wg = 2;
constexpr int kP1Threads = kP1Wg * kTcWarpgroup;
constexpr int kP1Fixed = kP1Wg * kTcRows;
// 64-point tiles a warpgroup of the Psi1 forward and point pass takes at
// bucket qm (two up to Q = 10, so that each row tile's build serves 256
// points; in rounds of one tile a warpgroup, so that at M <= 128 the
// second round, padding alone, is skipped), and the points of such a block.
__host__ __device__ constexpr int p1_point_tiles(int qm) { return qm > 0 && qm <= 10 ? 2 : 1; }
__host__ __device__ constexpr int p1_points(int qm) {
  return kP1Wg * p1_point_tiles(qm) * kTcRows;
}

// The point operand [z' | z'^2] (np x KP, z' = z - zeta) of points [p0, p0
// + np) (zero past m or q; the padding columns keep their zeros from
// tc_take_operand) and, with zf, z' as floats, zf[k * np + c]. No barrier.
template <int QM, int KP>
__device__ inline void tc_build_points(const float* __restrict__ z, const float* __restrict__ zeta,
                                       int m, int q, int p0, int np, const TcOperand& op,
                                       float* zf = nullptr) {
  for (int t = threadIdx.x; t < np * QM; t += blockDim.x) {
    const int c = t / QM, k = t % QM;
    const float zv = p0 + c < m && k < q ? z[(size_t)(p0 + c) * q + k] - zeta[k] : 0.f;
    tc_put(op.hi, op.lo, tc_at(c, k, KP), zv);
    tc_put(op.hi, op.lo, tc_at(c, QM + k, KP), zv * zv);
    if (zf) zf[k * np + c] = zv;
  }
}

// A thread's share of the 64 points [p0, p0 + 64) at bucket QM, built by NT
// threads: load() reads z - zeta into registers, all its loads issued
// together (a tile ahead of put in the row pass); put() writes the point
// operand [z' | z'^2] (64 x KP) and, with zf, z' as floats, zf[k * 64 + c].
// Zero past m or q.
template <int QM, int NT>
struct TcPointLoad {
  static constexpr int kE = (kTcRows * QM + NT - 1) / NT;
  float zv[kE];
  __device__ void load(const float* __restrict__ z, const float* __restrict__ zeta, int m, int q,
                       int p0) {
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int t = threadIdx.x + NT * j, c = t / QM, k = t % QM;
      zv[j] = t < kTcRows * QM && p0 + c < m && k < q ? z[(size_t)(p0 + c) * q + k] - zeta[k]
                                                       : 0.f;
    }
  }
  template <int KP>
  __device__ void put(const TcOperand& op, float* zf) const {
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int t = threadIdx.x + NT * j, c = t / QM, k = t % QM;
      if (t >= kTcRows * QM) break;
      tc_put(op.hi, op.lo, tc_at(c, k, KP), zv[j]);
      tc_put(op.hi, op.lo, tc_at(c, QM + k, KP), zv[j] * zv[j]);
      if (zf) zf[k * kTcRows + c] = zv[j];
    }
  }
};

// A thread's share of one K chunk of the NP points [p0, p0 + NP), built by
// NT threads as TcCellChunk builds cells: load() reads z - zeta into
// registers; put() writes, with op, the chunk of the point operand (NP x
// kTcKChunk, [z' | z'^2]) and, with zf, the chunk's z' as floats, zf[kk *
// NP + c]. Zero past m or q.
template <int NP, int NT>
struct TcPointChunk {
  static constexpr int kE = NP * kTcQChunk / NT;
  float zv[kE];
  __device__ static void at(int j, int* c, int* kk) { TcCellChunk<NP, NT>::at(j, c, kk); }
  __device__ void load(const float* __restrict__ z, const float* __restrict__ zeta, int m, int q,
                       int p0, int k0) {
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      int c, kk;
      at(j, &c, &kk);
      const int k = k0 + kk;
      zv[j] = p0 + c < m && k < q ? z[(size_t)(p0 + c) * q + k] - zeta[k] : 0.f;
    }
  }
  __device__ void put(const TcOperand* op, float* zf) const {
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      int c, kk;
      at(j, &c, &kk);
      if (op) {
        tc_put(op->hi, op->lo, tc_at(c, kk, kTcKChunk), zv[j]);
        tc_put(op->hi, op->lo, tc_at(c, kTcQChunk + kk, kTcKChunk), zv[j] * zv[j]);
      }
      if (zf) zf[kk * NP + c] = zv[j];
    }
  }
};

// A thread's share of columns [dc, dc + kTcDChunk) of R rows [e0, e0 + R)
// of x (element (e, j) at xs.at(e, j); zero past hi or d), built by NT
// threads: load() reads them into registers, all its loads issued together,
// neighbouring threads on neighbouring addresses in both layouts; put()
// writes, with op, a K-major operand of those rows (R x kTcDChunk, K the
// columns) for the dot products and, with opt (R = 64), the transposed one
// (kTcDChunk x 64, row e at K position tc_kperm(e)) for the reductions.
template <int R, int NT>
struct TcDChunk {
  static constexpr int kE = R * kTcDChunk / NT;
  float v[kE];
  __device__ void load(const float* __restrict__ x, Strides xs, int e0, int hi, int dc, int d) {
    const bool by_row = xs.rows_contiguous();
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      int e, c;
      stage_index<R>(threadIdx.x + NT * j, kTcDChunk, by_row, &e, &c);
      v[j] = e0 + e < hi && dc + c < d ? x[xs.at(e0 + e, dc + c)] : 0.f;
    }
  }
  __device__ void put(Strides xs, const TcOperand* op, const TcOperand* opt) const {
    const bool by_row = xs.rows_contiguous();
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      int e, c;
      stage_index<R>(threadIdx.x + NT * j, kTcDChunk, by_row, &e, &c);
      if (op) tc_put(op->hi, op->lo, tc_at(e, c, kTcDChunk), v[j]);
      if (opt) tc_put(opt->hi, opt->lo, tc_at(c, tc_kperm(e), 64), v[j]);
    }
  }
};

// Add a reduction product d2 (64 x N2) into float64 totals tot (64 rows
// of ld doubles) at columns [col0, col0 + N2). Each element has one owner.
template <int N2>
__device__ inline void tc_add_cols(const float (&d2)[N2 / 2], double* tot, int ld, int col0) {
#pragma unroll
  for (int e = 0; e < N2 / 2; ++e) tot[tc_m(e) * ld + col0 + tc_n(e)] += (double)d2[e];
}

}  // namespace gparml
