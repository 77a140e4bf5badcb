// Psi-statistics forward on Hopper: Psi1^T (w Y) (M, D) and
// sum_n w_n Psi2_n (M, M), float32.
//
// Replaces the TPU kernels gparml_tpu/ops/psi_pallas.py `_fwd_kernel_flat`
// (:634, launched by `_call_fwd_flat`) and its (Q, N)-layout twin
// `_fwd_kernel_flat_t` (:671, launched by `_call_fwd_flat_t`), which carried
// both sums across a sequential grid over N and multiplied bf16 hi/lo rungs
// on the MXU. One set of kernels serves both layouts through the Strides of
// psi_common.cuh (the qn twin reads mu^T, s^T (Q, N) and Y^T (D, N)). Here:
//
//  * psi2_fwd_tc_kernel<QM, CELLS> (Q <= 64): one grid axis over blocks of
//    packed upper-triangle cells (a tile of 64 a consumer warpgroup; two up
//    to Q = 16 without the cell sums), one over N-splits. The exponents of
//    each 64-cell x 64-row tile come from the tensor cores (psi_tc.cuh,
//    3-term TF32, centred on zeta, an exact shift 2^S in the row constants,
//    undone on the float64 totals). The walk over row tiles is a software
//    pipeline: producer warpgroups load each tile's rows into registers
//    and build their operand into a ring of shared-memory stages (4 up to
//    Q = 16, fewer past it) handed to the consumer warpgroups by a full and
//    an empty mbarrier a stage, with no block barrier in the walk; each
//    consumer thread adds w_n exp2(L2) over its 16 rows into float32 tile
//    sums of its two cells a tile, and the four threads of a cell add theirs
//    in float64 by quad shuffles into the cell's total in a register; up to
//    Q = 10 a consumer, its cells' operand in registers, forms the next
//    tile's exponents while this tile's epilogue (or sums) runs.
//    With CELLS (where dZ will be wanted: the wrapper passes the flag) the
//    sweep also builds the rows' transposed operand [c mu' | c], by which the
//    tensor cores multiply each tile's w exp2(L2), so that each pair's
//    exponent and exp2 serve both sum_n w_n Psi2_n and the centred cell sums
//    A_q = sum_n w e c_nq (mu'_nq - zb'_q) that dZ takes; without it that
//    operand, its product and its memory are compiled out. Each split writes
//    its totals into its own float64 (Q + 1, M, M) partial, Psi2 first, A
//    after it with CELLS; the wrapper sums the partials (deterministic, no
//    atomics), and the backward (psi_bwd.cu) takes A and forms no cell sums.
//  * psi1y_fwd_tc_kernel<QM>: one grid axis over blocks of 64 inducing
//    points (one warpgroup, the points on the tile's M axis), one over
//    N-splits, one over passes of up to kP1FwdCols columns of Y. Psi1 is
//    Psi2 with the packed cells replaced by the points (psi_tc.cuh): the
//    exponents of each 64-point x 64-row tile come from the tensor cores
//    (3-term TF32, centred on zeta, the shift 2^S1 in the row constants);
//    p = w exp2(L1 + S1) stays in the accumulator registers and is
//    multiplied by the rows' Y chunk on the tensor cores again (the
//    FlashAttention form of P V); each tile's float32 sums go into float64
//    totals in shared memory, and each split writes its points' totals
//    x 2^-S1 into its own float64 (M, D) partial.
//
// Past Q = 64 (any Q) psi2_fwd_tc_chunked_kernel and, past Q = 16,
// psi1y_fwd_tc_kernel<0> replace the TPU's `_fwd_kernel` (:225, launched by
// `_call_fwd`, which took the shapes outside the flat window) there: each
// is its tensor-core kernel with K walked in chunks of kTcQChunk latent
// dimensions (psi_tc.cuh), each chunk's operands built in shared memory,
// with the same shifts; Psi2 adds the chunks into the same accumulators,
// Psi1 forms each chunk in its own and adds them on the CUDA cores
// (tc_tile_chunk). The Q <= 64
// kernels take the rest of `_fwd_kernel`'s window (M <= 128, and
// 512 < M <= 640) as they take the flat window.
//
// What bounds it on an H100: operations, not bytes. The Psi2 kernels are
// bound by the 3-term TF32 products of the exponent tiles (psi_tc.cuh; 3 K
// x 2 flops a pair, with CELLS 3 (K + N2) x 2: 288 at Q = 10, 0.73 s at
// config 5's N = 1e7, M = 500), by the exp2 of each of the N M (M + 1) / 2
// pairs on the MUFU (0.30 s there) and by the row operand's build, shared
// by the block's cells (128 up to Q = 32, 64 past it; 256 up to Q = 16
// without the cell sums), with CELLS the [c mu' | c] build on top; the
// epilogue costs two float32 adds and an FMA a pair, and the rows come
// from device memory once per cell block. Up to Q = 64 the pipeline runs
// the products, the exp2 epilogues and the next tiles' builds at once,
// where an unpipelined walk ran them one after another; past Q = 64 the
// rows' and the 128 cells' operands are rebuilt chunk by chunk for every
// row tile, the rows read from device memory (L1, L2) once per cell
// block. The Psi1
// kernel (N M pairs) is bound the same way: an exp2 a pair on the MUFU, a
// float32 add and product, and per 64-row tile the row operand's and the
// Y chunk's builds, which M / 64 point blocks repeat.
#include "psi_tc.cuh"

namespace gparml {

// Most rows of one N-split of psi2_fwd_tc_chunked_kernel in one launch.
constexpr int kFwdRowsMax = 1024 * kRowsPsi2;

// The block of psi2_fwd_tc_kernel: tc_wg consumer warpgroups, each owning
// tc_cell_tiles tiles of 64 cells (one with the cell sums, whose reduction
// takes the registers; without them tc_fwd_ct, so that each row tile's
// operand build serves twice the cells up to Q = 16), then the producer
// warpgroups that build the row tiles.
__host__ __device__ constexpr int tc_cell_tiles(int qm, bool cells) {
  return cells ? 1 : tc_fwd_ct(qm);
}
__host__ __device__ constexpr int tc_cell_cells(int qm, bool cells) {
  return tc_wg(qm) * tc_cell_tiles(qm, cells) * kTcRows;
}
// Producer warpgroups: as many as consumer warpgroups, so that each thread
// of an unpipelined build of the whole block has a producer thread.
__host__ __device__ constexpr int tc_cells_producers(int qm) { return tc_wg(qm); }
__host__ __device__ constexpr int tc_cells_threads(int qm) {
  return (tc_wg(qm) + tc_cells_producers(qm)) * kTcWarpgroup;
}
// One stage of its ring: a 64-row tile's operand, constants and weights,
// and with the cell sums the tile's transposed operand [c mu' | c]
// (tc_n2_cells x 64).
__host__ __device__ constexpr size_t tc_cells_stage_bytes(int qm, bool cells) {
  return tc_operand_bytes(kTcRows, qm) + 2 * tc_region(kTcRows * sizeof(float)) +
         (cells ? tc_b2_bytes(tc_n2_cells(qm)) : 0);
}
// Its shared memory beside the ring: the cells' operand (whose room holds
// the cells' float64 sums of the centred products at the end) and terms,
// the ring's full and empty barriers, and alpha and zeta.
constexpr int kTcCellsStagesMax = 4;
__host__ __device__ constexpr size_t tc_cells_fixed_bytes(int qm, bool cells) {
  return tc_operand_bytes(tc_cell_cells(qm, cells), qm) +
         tc_cellterm_bytes(tc_cell_cells(qm, cells)) +
         tc_region(2 * kTcCellsStagesMax * sizeof(uint64_t)) + tc_region(2 * qm * sizeof(float));
}
// Stages of the ring: as many as fit beside that in an H100 block's shared
// memory, up to kTcCellsStagesMax (4 up to Q = 16; 2 at Q = 32 with the
// cell sums, 4 without; 1 at Q = 64 with them, 2 without).
__host__ __device__ constexpr int tc_cells_stages(int qm, bool cells) {
  return (int)std::min<size_t>(kTcCellsStagesMax, (kTcSmemMax - tc_cells_fixed_bytes(qm, cells)) /
                                                      tc_cells_stage_bytes(qm, cells));
}
__host__ __device__ constexpr size_t tc_cells_smem(int qm, bool cells) {
  return tc_cells_fixed_bytes(qm, cells) +
         tc_cells_stages(qm, cells) * tc_cells_stage_bytes(qm, cells);
}
// Whether a consumer forms a tile's exponents while the last tile's
// epilogue (with the cell sums: while its sums) runs, its cells' operand
// in registers, up to Q = 10 (as the backward's row pass, whose registers
// run out past it the same way).
__host__ __device__ constexpr bool tc_cells_ahead(int qm) { return qm <= 10; }
// Registers of a producer thread and of a consumer thread where the block
// runs four warpgroups (up to Q = 32; setmaxnreg): the launch gives each
// of the 512 threads 128; a producer holds the raw values of the row tiles
// it has in flight and a row's constant sums, 64 up to Q = 16 and 48 at
// Q = 32; the consumers take what the producers give back (192, 208).
__host__ __device__ constexpr int tc_cells_regs(int qm) {
  return 65536 / tc_cells_threads(qm) / 8 * 8;
}
__host__ __device__ constexpr int tc_cells_producer_regs(int qm) { return qm <= 16 ? 64 : 48; }
__host__ __device__ constexpr int tc_cells_consumer_regs(int qm) {
  return (2 * tc_cells_regs(qm) - tc_cells_producer_regs(qm)) / 8 * 8;
}
// Whether a producer loads its next row tile's values while it builds this
// one: up to Q = 16; past it the registers go to the wider tile, whose
// loads it issues before it waits for the stage, and past Q = 32 (more than
// kTcCellsLoadDims dimensions a builder) kTcCellsLoadDims dimensions at a
// time as it builds them.
__host__ __device__ constexpr bool tc_cells_load_ahead(int qm) { return qm <= 16; }
constexpr int kTcCellsLoadDims = 8;

// The named barrier of psi2_fwd_tc_kernel's consumers (0 is
// __syncthreads').
constexpr int kTcBarConsumers = 1;

// Stage s of the ring.
struct TcCellsStage {
  TcOperand rop, b2;
  float *rc, *w;
};
template <int QM, bool CELLS>
__device__ inline TcCellsStage tc_cells_stage(char* ring, int s) {
  constexpr int KP = tc_k(QM), N2 = tc_n2_cells(QM);
  TcCarve cv(ring + (size_t)s * tc_cells_stage_bytes(QM, CELLS));
  TcCellsStage st;
  st.rop.hi = cv.take<float>(kTcRows * KP * sizeof(float));
  st.rop.lo = cv.take<float>(kTcRows * KP * sizeof(float));
  st.rc = cv.take<float>(kTcRows * sizeof(float));
  st.w = cv.take<float>(kTcRows * sizeof(float));
  st.b2.hi = CELLS ? cv.take<float>(N2 * kTcRows * sizeof(float)) : nullptr;
  st.b2.lo = CELLS ? cv.take<float>(N2 * kTcRows * sizeof(float)) : nullptr;
  return st;
}

// A builder's raw values of one row tile (tc_cells_load): mu and s of its
// dimensions, zero past hi or q, and w of its row, zero past hi.
template <int KT>
struct TcCellsRaw {
  float mu[KT], s[KT], w;
};

// Row n's values of dimensions sub, sub + TPR, ... (live: n is a row of the
// split, else zeros), from device memory into registers.
template <int QM, int TPR>
__device__ inline void tc_cells_load(TcCellsRaw<(QM + TPR - 1) / TPR>& x,
                                     const float* __restrict__ mu, const float* __restrict__ s,
                                     Strides ls, const float* __restrict__ w, int q, int n,
                                     bool live, int sub) {
  constexpr int KT = (QM + TPR - 1) / TPR;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    const int k = sub + j * TPR;
    const bool ok = live && k < q;
    x.mu[j] = ok ? mu[ls.at(n, k)] : 0.f;
    x.s[j] = ok ? s[ls.at(n, k)] : 0.f;
  }
  x.w = live ? w[n] : 0.f;
}

// Dimensions j0 .. j0 + KC - 1 (mu_c, s_c) of builder (r, sub) of a row
// tile into stage sg as tc_build_rows forms them from staged rows with TPR
// builders a row (the threads of an unpipelined build of the whole block:
// the builder takes dimensions sub, sub + TPR, ...; j its j-th): the row
// operand, with CELLS the transposed operand [c mu' | c], and the row
// constant's sums in rc, in the same groups and order. s_az: alpha (QM),
// then zeta (QM).
template <int QM, int TPR, bool CELLS, int KC>
__device__ inline void tc_cells_build_dims(int r, int sub, int j0, const float (&mu_c)[KC],
                                           const float (&s_c)[KC], const float* s_az, int q,
                                           const TcCellsStage& sg, TcRowConst& rc) {
  using F = TcForm<false>;
  constexpr int KP = tc_k(QM);
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    const int k = sub + (j0 + j) * TPR;
    if (k >= QM) break;
    float c = 0.f, mv = 0.f;
    if (k < q) {
      const float a = s_az[k];
      const float den = F::kDen * a * s_c[j] + 1.f;
      c = a / den;
      mv = mu_c[j] - s_az[QM + k];
      rc.add(den, c, mv);
    }
    tc_put(sg.rop.hi, sg.rop.lo, tc_at(r, k, KP), (F::kR * c * mv) * kLog2e);
    tc_put(sg.rop.hi, sg.rop.lo, tc_at(r, QM + k, KP), -(F::kQ * c) * kLog2e);
    if constexpr (CELLS) {
      tc_put(sg.b2.hi, sg.b2.lo, tc_at(k, tc_kperm(r), 64), c * mv);
      tc_put(sg.b2.hi, sg.b2.lo, tc_at(QM + k, tc_kperm(r), 64), c);
    }
  }
}

// Row r's constant from its builders' sums rc, added over the row's TPR
// builders by warp shuffles in a fixed order, and its weight w, written by
// sub 0 into stage sg.
template <int TPR>
__device__ inline void tc_cells_build_const(int r, int sub, TcRowConst rc, float w, float logsf2,
                                            float shift, const TcCellsStage& sg) {
  using F = TcForm<false>;
  if (rc.in_prod) rc.lsum += (double)logf(rc.prod);
  for (int o = 1; o < TPR; o <<= 1) {
    rc.lsum += __shfl_xor_sync(0xffffffffu, rc.lsum, o);
    rc.cm += __shfl_xor_sync(0xffffffffu, rc.cm, o);
  }
  if (sub == 0) {
    sg.rc[r] = (float)((F::kSf * (double)logsf2 - 0.5 * rc.lsum - F::kQd * rc.cm) *
                           (double)kLog2e +
                       (double)shift);
    sg.w[r] = w;
  }
}

// The producer warpgroups of psi2_fwd_tc_kernel: row tile t of the split
// (rows [lo + 64 t, lo + 64 t + 64) below hi) into stage t % NS once every
// consumer has released the stage's last tile. Producer thread p is
// builder p of an unpipelined build of the whole block (NB = 128 tc_wg
// builders, TPR = NB / 64 a row), so that the row constants' sums keep
// their grouping and order. It loads its raw values of each tile straight
// from device memory into registers (tc_cells_load), up to Q = 16 a tile
// ahead and up to Q = 32 before it waits for the stage, past it
// kTcCellsLoadDims dimensions at a time as it builds them, builds its share
// of the stage (tc_cells_build_dims, tc_cells_build_const), fences its
// stores for the tensor cores and arrives on the stage's full barrier.
template <int QM, bool CELLS>
__device__ inline void tc_cells_produce(const float* __restrict__ mu, const float* __restrict__ s,
                                        Strides ls, const float* __restrict__ w,
                                        const float* s_az, float logsf2, float sh, int q, int lo,
                                        int hi, char* ring, uint64_t* full, uint64_t* empty) {
  constexpr int NS = tc_cells_stages(QM, CELLS), NB = tc_wg(QM) * kTcWarpgroup;
  constexpr int TPR = NB / kTcRows, KT = (QM + TPR - 1) / TPR, KC = kTcCellsLoadDims;
  constexpr bool kAhead = tc_cells_load_ahead(QM);
  const int p = threadIdx.x - NB, r = p / TPR, sub = p % TPR;
  const int ntiles = hi > lo ? (hi - lo + kTcRows - 1) / kTcRows : 0;
  auto load = [&](TcCellsRaw<KT>& x, int t) {
    const int n = lo + t * kTcRows + r;
    tc_cells_load<QM, TPR>(x, mu, s, ls, w, q, n, t < ntiles && n < hi, sub);
  };
  TcCellsRaw<KT> x[2];
  if (kAhead) load(x[0], 0);
  for (int t0 = 0; t0 < ntiles; t0 += 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + h, sx = t % NS;
      if (t >= ntiles) break;
      const TcCellsStage sg = tc_cells_stage<QM, CELLS>(ring, sx);
      TcRowConst rc;
      if constexpr (KT <= KC) {
        load(x[kAhead ? h ^ 1 : h], kAhead ? t + 1 : t);
        tc_bar_wait(empty + sx, (t / NS & 1) ^ 1);
        tc_cells_build_dims<QM, TPR, CELLS>(r, sub, 0, x[h].mu, x[h].s, s_az, q, sg, rc);
        tc_cells_build_const<TPR>(r, sub, rc, x[h].w, logsf2, sh, sg);
      } else {
        const int n = lo + t * kTcRows + r;
        const float wn = n < hi ? w[n] : 0.f;
        tc_bar_wait(empty + sx, (t / NS & 1) ^ 1);
#pragma unroll 1
        for (int j0 = 0; j0 < KT; j0 += KC) {
          float mu_c[KC], s_c[KC];
#pragma unroll
          for (int j = 0; j < KC; ++j) {
            const int k = sub + (j0 + j) * TPR;
            const bool ok = n < hi && k < q;
            mu_c[j] = ok ? mu[ls.at(n, k)] : 0.f;
            s_c[j] = ok ? s[ls.at(n, k)] : 0.f;
          }
          tc_cells_build_dims<QM, TPR, CELLS>(r, sub, j0, mu_c, s_c, s_az, q, sg, rc);
        }
        tc_cells_build_const<TPR>(r, sub, rc, wn, logsf2, sh, sg);
      }
      tc_fence_async();
      tc_bar_arrive(full + sx);
    }
  }
}

// The consumer warpgroups of psi2_fwd_tc_kernel: warpgroup wg's CT cell
// tiles against every row tile of the split in turn, as stage t % NS
// fills. Per row tile and cell tile the exponents (tc_tile, the cells on
// the tile's M axis), then the epilogue: each thread adds w exp2(L2) over
// its 16 rows into float32 sums of its two cells, and the four threads of
// a cell (one quad of a warp) add theirs by shuffles in float64,
// ((t0 + t1) + (t2 + t3)), into the cell's total p2 (lane 0's); with CELLS
// the exponents in registers become ev = w exp2(L2) (0 past the last
// cell), multiplied by the stage's [c mu' | c] on the tensor cores
// (tc_reduce) and added to the float64 totals tot, tile after tile; then
// the stage is released. Up to Q = 10 (tc_cells_ahead) a warpgroup keeps
// the tensor cores busy over its epilogues, its cells' operand held in
// registers as the exponents' A (TcRowsA): with CELLS, tile t's ev split
// into the reduction's A registers, it issues tile t + 1's exponents and
// then tile t's sums and waits for the exponents alone (wgmma.wait_group
// 1), so that tile t + 1's epilogue runs while tile t's sums do; without,
// each cell tile's next exponents are issued as soon as its epilogue is
// done, so that one cell tile's epilogue runs while the other's exponents
// do.
template <int QM, bool CELLS>
__device__ inline void tc_cells_consume(const TcOperand& cop, const float* s_ce, const int2* s_ij,
                                        char* ring, uint64_t* full, uint64_t* empty, int ntiles,
                                        double (&p2)[tc_cell_tiles(QM, CELLS)][2],
                                        double (&tot)[tc_n2_cells(QM) / 2]) {
  constexpr int KP = tc_k(QM), N2 = tc_n2_cells(QM), NS = tc_cells_stages(QM, CELLS);
  constexpr int CT = tc_cell_tiles(QM, CELLS);
  const int tile0 = threadIdx.x / kTcWarpgroup * CT * kTcRows;
  auto epilogue = [&](float (&d)[32], int j, const TcCellsStage& st) {
    const int tile = tile0 + j * kTcRows;
    // the constants and weights of the thread's 16 rows, tc_n(4 g) and
    // tc_n(4 g) + 1 in pairs
    float2 rc2[8], w2[8];
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      rc2[g] = *reinterpret_cast<const float2*>(st.rc + tc_n(4 * g));
      w2[g] = *reinterpret_cast<const float2*>(st.w + tc_n(4 * g));
    }
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = tc_m(i);
      const float rc = i & 1 ? rc2[i >> 2].y : rc2[i >> 2].x;
      const float wr = i & 1 ? w2[i >> 2].y : w2[i >> 2].x;
      const float ev = tc_exp2(d[i] + s_ce[tile + c] + rc);
      part[(i >> 1) & 1] += wr * ev;
      if constexpr (CELLS) d[i] = s_ij[tile + c].x >= 0 ? wr * ev : 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      double x = (double)part[h];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      p2[j][h] += x;
    }
  };
  auto add = [&](const float (&d2)[N2 / 2]) {
#pragma unroll
    for (int e = 0; e < N2 / 2; ++e) tot[e] += d2[e];
  };
  auto stage = [&](int t) { return tc_cells_stage<QM, CELLS>(ring, t % NS); };
  auto wait_full = [&](int t) { tc_bar_wait(full + t % NS, t / NS & 1); };
  if (ntiles == 0) return;
  if constexpr (tc_cells_ahead(QM) && CELLS) {
    TcRowsA<KP> ca;
    ca.load(cop.hi, cop.lo, tile0);
    TcRegA a;
    float d[32], d2[N2 / 2];
    auto exps = [&](int t) {
      wait_full(t);
      const TcCellsStage sx = stage(t);
      tc_tile_issue_regs<KP>(ca, sx.rop.hi, sx.rop.lo, d);
    };
    // tile t's epilogue and split, once tile t - 1's sums are in
    auto front = [&](int t, const TcCellsStage& st) {
      epilogue(d, 0, st);
      tc_wgmma_wait<0>();
      tc_fence_vals(d2);
      a.fence();
      if (t > 0) {
        add(d2);
        tc_bar_arrive(empty + (t - 1) % NS);
      }
      a.set(d, nullptr);
    };
    exps(0);
    tc_wgmma_wait<0>();
    tc_fence_vals(d);
    int t = 0;
    for (; t + 1 < ntiles; ++t) {
      const TcCellsStage st = stage(t);
      front(t, st);
      exps(t + 1);
      tc_reduce_issue<N2>(a, st.b2.hi, st.b2.lo, d2);
      tc_wgmma_wait<1>();
      tc_fence_vals(d);
    }
    const TcCellsStage st = stage(t);
    front(t, st);
    tc_reduce_issue<N2>(a, st.b2.hi, st.b2.lo, d2);
    tc_wgmma_wait<0>();
    tc_fence_vals(d2);
    a.fence();
    add(d2);
    tc_bar_arrive(empty + t % NS);
  } else if constexpr (tc_cells_ahead(QM)) {
    static_assert(CT == 2, "the walk without the cell sums alternates two cell tiles");
    TcRowsA<KP> ca[CT];
    float d[CT][32];
#pragma unroll
    for (int j = 0; j < CT; ++j) ca[j].load(cop.hi, cop.lo, tile0 + j * kTcRows);
    auto exps = [&](int t, int j) {
      const TcCellsStage sx = stage(t);
      tc_tile_issue_regs<KP>(ca[j], sx.rop.hi, sx.rop.lo, d[j]);
    };
    wait_full(0);
#pragma unroll
    for (int j = 0; j < CT; ++j) exps(0, j);
    for (int t = 0; t < ntiles; ++t) {
      const TcCellsStage st = stage(t);
      const bool next = t + 1 < ntiles;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        // in flight: (t, j), and (t, 1) or (t + 1, 0) after it
        if (j == 0 || next)
          tc_wgmma_wait<1>();
        else
          tc_wgmma_wait<0>();
        tc_fence_vals(d[j]);
        epilogue(d[j], j, st);
        if (j + 1 == CT) tc_bar_arrive(empty + t % NS);
        if (next) {
          if (j == 0) wait_full(t + 1);
          exps(t + 1, j);
        }
      }
    }
  } else {
    for (int t = 0; t < ntiles; ++t) {
      wait_full(t);
      const TcCellsStage st = stage(t);
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int tile = tile0 + j * kTcRows;
        float d[32];
        tc_tile<KP>(cop.hi + tile * KP, cop.lo + tile * KP, st.rop.hi, st.rop.lo, d);
        epilogue(d, j, st);
        if constexpr (CELLS) {
          float d2[N2 / 2];
          tc_reduce<N2>(d, st.b2.hi, st.b2.lo, d2, nullptr);
          add(d2);
        }
      }
      tc_bar_arrive(empty + t % NS);
    }
  }
}

// The Psi2 forward (Q <= 64): sum_n w_n Psi2_n and, with CELLS (where dZ
// will be wanted), the centred cell sums A_q = sum_n w e c_nq (mu'_nq -
// zb'_q) that dZ takes (e = Psi2[n, cell]) in the same sweep, per block of
// packed cells (grid x: tc_wg consumer warpgroups with tc_cell_tiles tiles
// of 64 cells each, on the tiles' M axis) and N-split (grid y). The cells'
// operand is built once; the split's rows are walked in tiles of 64 (the
// tile's N axis), pipelined: producer warpgroups (tc_cells_producers) build
// each row tile's operand, constants and weights, with CELLS also its
// transposed operand [c mu' | c], once for the block into a ring of
// tc_cells_stages stages, handed over by a full and an empty mbarrier a
// stage, with no block barrier in the walk (tc_cells_produce); each
// consumer warpgroup forms its
// cells' exponents on the tensor cores and adds w exp2(L2) into the
// cells' float64 totals, with CELLS also the tile's sums S1_q = sum ev c
// mu'_q and S2_q = sum ev c_q, each tile's added to float64 registers
// (tc_cells_consume; no float32 sum spans more than a 64-row tile). At the
// end each split writes its cells' sum_n w_n Psi2_n into its float64
// (Q + 1, M, M) partial, Psi2 first, both triangles, and with CELLS, in
// float64, the centred A_q = S1_q - zb'_q S2_q (ops/psi_tc_model.py, form
// "tc") after it. Every value and sum is the one an unpipelined walk forms,
// in the same order, and a cell's tile takes the same rows, threads and
// order in both instantiations, so Psi2 does not depend on CELLS, bit for
// bit. One block an SM.
template <int QM, bool CELLS>
__global__ void __launch_bounds__(tc_cells_threads(QM), 1)
psi2_fwd_tc_kernel(const float* __restrict__ mu, const float* __restrict__ s, Strides ls,
                   const float* __restrict__ w, const float* __restrict__ z,
                   const float* __restrict__ alpha, const float* __restrict__ sf2,
                   const float* __restrict__ zeta, const int2* __restrict__ cells,
                   const float* __restrict__ ce, const float* __restrict__ shift, int n, int m,
                   int q, int rows_per_split, double* __restrict__ out) {
  constexpr int KP = tc_k(QM), QS = QM / 2, CT = tc_cell_tiles(QM, CELLS);
  constexpr int N2 = tc_n2_cells(QM), NC = tc_cell_cells(QM, CELLS);
  constexpr int NS = tc_cells_stages(QM, CELLS), NT = tc_wg(QM) * kTcWarpgroup;
  static_assert(NS >= (tc_cells_ahead(QM) ? 2 : 1), "the ring holds too few stages");
  extern __shared__ float4 smem4[];
  TcCarve cv(smem4);
  const TcOperand cop = tc_take_operand<KP>(cv, NC);
  float* s_ce = cv.take<float>(NC * sizeof(float));
  int2* s_ij = cv.take<int2>(NC * sizeof(int2));
  uint64_t* full = cv.take<uint64_t>(2 * kTcCellsStagesMax * sizeof(uint64_t));
  uint64_t* empty = full + NS;
  float* s_az = cv.take<float>(2 * QM * sizeof(float));
  char* ring = cv.take<char>(NS * tc_cells_stage_bytes(QM, CELLS));

  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(n, lo + rows_per_split);
  const int ntiles = hi > lo ? (hi - lo + kTcRows - 1) / kTcRows : 0;
  // the stages the walk fills, zeroed (the operands' padding stays zero)
  float* ring_f = reinterpret_cast<float*>(ring);
  const int ring_used = min(NS, ntiles) * (int)(tc_cells_stage_bytes(QM, CELLS) / sizeof(float));
  for (int i = threadIdx.x; i < ring_used; i += blockDim.x) ring_f[i] = 0.f;
  for (int k = threadIdx.x; k < QM; k += blockDim.x) {
    s_az[k] = k < q ? alpha[k] : 0.f;
    s_az[QM + k] = k < q ? zeta[k] : 0.f;
  }
  tc_build_cells<QM, KP, NC>(z, zeta, cells, ce, m, q, blockIdx.x * NC, cop, s_ce, s_ij);
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      tc_bar_init(full + i, tc_cells_producers(QM) * kTcWarpgroup);
      tc_bar_init(empty + i, NT);
    }
    tc_bar_init_fence();
  }
  tc_operands_ready();

  const float sh = *shift;
  constexpr bool kRegs = NT > kTcWarpgroup;  // setmaxnreg
  if (threadIdx.x >= NT) {
    if constexpr (kRegs) tc_setmaxnreg_dec<tc_cells_producer_regs(QM)>();
    tc_cells_produce<QM, CELLS>(mu, s, ls, w, s_az, logf(*sf2), sh, q, lo, hi, ring, full,
                                empty);
    return;
  }
  if constexpr (kRegs) tc_setmaxnreg_inc<tc_cells_consumer_regs(QM)>();
  double p2[CT][2], tot[N2 / 2];
#pragma unroll
  for (int j = 0; j < CT; ++j) p2[j][0] = p2[j][1] = 0.0;
#pragma unroll
  for (int e = 0; e < N2 / 2; ++e) tot[e] = 0.0;
  tc_cells_consume<QM, CELLS>(cop, s_ce, s_ij, ring, full, empty, ntiles, p2, tot);

  // out: (splits, q + 1, M, M), Psi2 first, each cell written by lane 0 of
  // its quad
  const size_t mm = (size_t)m * m;
  double* o = out + (size_t)blockIdx.y * (q + 1) * mm;
  const double unshift = ldexp(1.0, -(int)sh);
  const int tile0 = threadIdx.x / kTcWarpgroup * CT * kTcRows;
#pragma unroll
  for (int h = 0; h < 2 * CT; ++h) {
    const int c = tile0 + (h >> 1) * kTcRows + tc_m(2 * (h & 1));
    const int2 ij = s_ij[c];
    if ((threadIdx.x & 3) != 0 || ij.x < 0) continue;
    const double v = p2[h >> 1][h & 1] * unshift;
    o[(size_t)ij.x * m + ij.y] = v;
    if (ij.x != ij.y) o[(size_t)ij.y * m + ij.x] = v;
  }
  if constexpr (CELLS) {
    o += mm;
    // the cells' sums through shared memory, once every consumer's products
    // are done with the cells' operand: NC x N2 (N2 == KP)
    double* s_tot = reinterpret_cast<double*>(cop.hi);
    tc_bar_sync(kTcBarConsumers, NT);
#pragma unroll
    for (int e = 0; e < N2 / 2; ++e) s_tot[(tile0 + tc_m(e)) * N2 + tc_n(e)] = tot[e];
    tc_bar_sync(kTcBarConsumers, NT);
    // each (cell, dimension) written by one thread
    for (int idx = threadIdx.x; idx < 2 * NC; idx += NT) {
      const int c = idx % NC, k0 = (idx / NC) * QS;
      const int2 ij = s_ij[c];
      if (ij.x < 0) continue;
      const double* t_c = s_tot + c * N2;
      for (int k = 0; k < QS; ++k) {
        const int kk = k0 + k;
        if (kk >= q) break;
        const float zb = 0.5f * ((z[(size_t)ij.x * q + kk] - zeta[kk]) +
                                 (z[(size_t)ij.y * q + kk] - zeta[kk]));
        const double a = (t_c[kk] - (double)zb * t_c[QM + kk]) * unshift;
        o[kk * mm + (size_t)ij.x * m + ij.y] = a;
        if (ij.x != ij.y) o[kk * mm + (size_t)ij.y * m + ij.x] = a;
      }
    }
  }
}

// Cells of one block of psi2_fwd_tc_chunked_kernel (two warpgroups, a
// tile of 64 cells each), and its shared memory: the cells' and the rows'
// operand chunks, the cells' terms and the rows' constants and weights.
constexpr int kTcChunkFwdCells = 2 * kTcRows;
__host__ __device__ constexpr size_t tc_fwd_chunked_smem() {
  return tc_chunk_operand_bytes(kTcChunkFwdCells) + tc_chunk_operand_bytes(kTcRows) +
         tc_region(kTcChunkFwdCells * sizeof(float)) + tc_region(kTcChunkFwdCells * sizeof(int2)) +
         2 * tc_region(kTcRows * sizeof(float));
}

// sum_n w_n Psi2_n for any Q > 64, with K in chunks: 128 packed cells a
// block (two warpgroups, on the tiles' M axis) and one N-split (grid y),
// each split into its own float64 (M, M) partial; where the partials'
// budget lowered the split count, the launcher runs the grid again for each
// further kFwdRowsMax rows a split, adding in.
// Per 64-row tile of the split, each chunk of kTcQChunk latent dimensions
// is built into shared memory for the rows and the block's cells and
// multiplied into the warpgroups' accumulators (tc_tile, accumulating over
// the chunks), each chunk's raw values loaded while the last one is built
// and multiplied. The rows' constants (with the shift S) are summed over
// the chunks by the threads that build them. The epilogue adds
// w exp2(L2 + S) over the tile's rows into float32 tile sums, then float64
// registers; at the end the four threads of a cell add theirs and one
// writes the split's partial times 2^-S, both triangles.
__global__ void __launch_bounds__(2 * kTcWarpgroup)
psi2_fwd_tc_chunked_kernel(const float* __restrict__ mu, const float* __restrict__ s, Strides ls,
                           const float* __restrict__ w, const float* __restrict__ z,
                           const float* __restrict__ alpha, const float* __restrict__ sf2,
                           const float* __restrict__ zeta, const int2* __restrict__ cells,
                           const float* __restrict__ ce, const float* __restrict__ shift,
                           int n_begin, int n, int m, int q, int rows_per_split,
                           double* __restrict__ out) {
  constexpr int NC = kTcChunkFwdCells, KC = kTcKChunk, NT = 2 * kTcWarpgroup;
  extern __shared__ float4 smem4[];
  TcCarve cv(smem4);
  const TcOperand cop = tc_take_chunk(cv, NC, KC);
  const TcOperand rop = tc_take_chunk(cv, kTcRows, KC);
  float* s_ce = cv.take<float>(NC * sizeof(float));
  int2* s_ij = cv.take<int2>(NC * sizeof(int2));
  float* s_rc = cv.take<float>(kTcRows * sizeof(float));
  float* s_w = cv.take<float>(kTcRows * sizeof(float));

  tc_stage_cells<NC>(cells, ce, nullptr, m, blockIdx.x * NC, s_ij, s_ce, nullptr);
  __syncthreads();
  const int wg = threadIdx.x / kTcWarpgroup, tile = wg * kTcRows;
  const float logsf2 = logf(*sf2), sh = *shift;
  const int lo = n_begin + blockIdx.y * rows_per_split;
  const int hi = min(n, lo + rows_per_split);
  double acc[2] = {0.0, 0.0};
  for (int n0 = lo; n0 < hi; n0 += kTcRows) {
    TcRowConst rc;
    TcRowChunk<kTcRows, NT> rows;
    TcCellChunk<NC, NT> cch;
    float d[32];
    rows.load(mu, s, ls, alpha, zeta, q, n0, hi, 0);
    cch.load(z, zeta, s_ij, q, 0);
    for (int k0 = 0; k0 < q; k0 += kTcQChunk) {
      __syncthreads();  // the last chunk's products (and s_rc's readers) are done
      rows.put(q, n0, hi, k0, &rop, nullptr, &rc);
      cch.put(&cop, nullptr);
      if (k0 + kTcQChunk < q) {  // the next chunk's loads, in flight over this one's products
        rows.load(mu, s, ls, alpha, zeta, q, n0, hi, k0 + kTcQChunk);
        cch.load(z, zeta, s_ij, q, k0 + kTcQChunk);
      }
      tc_operands_ready();
      tc_tile<KC>(cop.hi + tile * KC, cop.lo + tile * KC, rop.hi, rop.lo, d, k0 > 0);
    }
    tc_finish_rows<kTcRows>(rc, w, logsf2, sh, n0, hi, s_rc, s_w);
    __syncthreads();
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = tc_m(i), r = tc_n(i);
      part[(i >> 1) & 1] += s_w[r] * tc_exp2((d[i] + s_rc[r]) + s_ce[tile + c]);
    }
    acc[0] += part[0];
    acc[1] += part[1];
  }

  const double unshift = ldexp(1.0, -(int)sh);
  double* o = out + (size_t)blockIdx.y * m * m;
  const bool first = n_begin == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    double v = acc[h];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v *= unshift;
    const int2 ij = s_ij[tile + tc_m(2 * h)];
    if ((threadIdx.x & 3) != 0 || ij.x < 0) continue;
    double* up = o + (size_t)ij.x * m + ij.y;
    *up = first ? v : *up + v;
    if (ij.x != ij.y) {
      double* mirror = o + (size_t)ij.y * m + ij.x;
      *mirror = first ? v : *mirror + v;
    }
  }
}

// Columns of Y one block of psi1y_fwd_tc_kernel<qm> sums (its float64
// totals in shared memory: kP1FwdCols for 128 points, half for 256); wider D
// is split over the grid's z axis.
constexpr int kP1FwdCols = 128;
inline int p1_fwd_cols(int d, int qm) {
  const int cols = (d + kTcDChunk - 1) / kTcDChunk * kTcDChunk;
  const int most = kP1FwdCols / p1_point_tiles(qm);
  return cols < most ? cols : most;
}
inline int p1_fwd_passes(int d, int qm) {
  return (d + p1_fwd_cols(d, qm) - 1) / p1_fwd_cols(d, qm);
}

// Shared memory of psi1y_fwd_tc_kernel<QM> with dcols columns a block: the
// points' operand (p1_points points) and the rows' (or K chunks of them),
// the rows' constants and weights, the ring of raw row stages (buckets),
// the transposed Y chunk, the float64 totals (p1_points x (dcols + 1)) and
// the emulation's scratch.
__host__ __device__ constexpr size_t tc_p1_fwd_smem(int qm, int dcols) {
  return (qm ? tc_operand_bytes(p1_points(qm), qm) + tc_operand_bytes(kTcRows, qm) +
                   2 * tc_stage_bytes(kTcRows, qm)
             : tc_chunk_operand_bytes(p1_points(qm)) + tc_chunk_operand_bytes(kTcRows)) +
         2 * tc_region(kTcRows * sizeof(float)) + tc_b2_bytes(kTcDChunk) +
         tc_region((size_t)p1_points(qm) * (dcols + 1) * sizeof(double)) +
         tc_scratch_bytes(kP1Wg);
}

// Psi1^T (w Y) for one block of p1_points inducing points (grid x; 64-tiles
// of them on the tile's M axis, taken in p1_point_tiles rounds of one tile a
// warpgroup, a round that holds only padding skipped), one
// N-split (grid y) and dcols columns of Y (grid z). The points' operand
// [z' | z'^2] is built once; the split's rows are walked in tiles of 64
// (the tile's N axis), staged by cp.async one tile ahead, and each tile's
// row operand [c1 mu' | -c1/2] log2e and constants (with the shift S1) are
// built once for both warpgroups. Each warpgroup forms its points'
// exponents on the tensor cores (tc_tile, 3-term TF32, centred on zeta) and
// turns them in registers into p = w exp2(L1 + S1), split once (TcRegA);
// per chunk of kTcDChunk columns the rows' Y chunk is staged transposed
// (read a tile ahead when the block takes one chunk) and p Y runs on the
// tensor cores again (tc_reduce_split, the FlashAttention form of P V); its
// float32 tile sums are added into float64 totals in shared memory. Past
// kTcP1BucketMax (QM = 0) K is walked in chunks of kTcQChunk dimensions,
// both operands' chunks built in turn and multiplied into the same
// accumulators, the rows' constants summed over the chunks. At the end the
// block writes its points' totals x 2^-S1 into the split's float64 (M, D)
// partial.
template <int QM>
__global__ void __launch_bounds__(kP1Threads)
psi1y_fwd_tc_kernel(const float* __restrict__ mu, const float* __restrict__ s, Strides ls,
                    const float* __restrict__ y, Strides ys, const float* __restrict__ w,
                    const float* __restrict__ z, const float* __restrict__ alpha,
                    const float* __restrict__ sf2, const float* __restrict__ zeta,
                    const float* __restrict__ shift, int n, int m, int q, int d,
                    int rows_per_split, int dcols, double* __restrict__ out) {
  constexpr int KP = QM ? tc_k(QM) : kTcKChunk;
  constexpr int PT = p1_point_tiles(QM), NF = p1_points(QM);
  extern __shared__ float4 smem4[];
  TcCarve cv(smem4);
  const TcOperand pop = tc_take_operand<KP>(cv, NF);
  const TcOperand rop = tc_take_operand<KP>(cv, kTcRows);
  float* s_rc = cv.take<float>(kTcRows * sizeof(float));
  float* s_w = cv.take<float>(kTcRows * sizeof(float));
  const int stage = (int)(tc_stage_bytes(kTcRows, QM) / sizeof(float));
  float* ring = QM ? cv.take<float>(2 * tc_stage_bytes(kTcRows, QM)) : nullptr;
  const TcOperand yb = tc_take_chunk(cv, kTcDChunk, kTcRows);
  const int ld = dcols + 1;
  double* tot = cv.take<double>((size_t)NF * ld * sizeof(double));
  const int wg = threadIdx.x / kTcWarpgroup;
  float* scratch = cv.take<float>(tc_scratch_bytes(kP1Wg)) + wg * kTcRows * kTcTileLd;
  for (int i = threadIdx.x; i < NF * ld; i += blockDim.x) tot[i] = 0.0;
  __syncthreads();  // the carve's zeros are in

  const int p0 = blockIdx.x * NF;
  const int d0 = blockIdx.z * dcols, d1 = min(d, d0 + dcols);
  const bool one_d = d1 - d0 <= kTcDChunk;
  if constexpr (QM > 0) tc_build_points<QM, KP>(z, zeta, m, q, p0, NF, pop);
  const float logsf2 = logf(*sf2), sh = *shift;
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(n, lo + rows_per_split);
  const int ntiles = hi > lo ? (hi - lo + kTcRows - 1) / kTcRows : 0;
  TcDChunk<kTcRows, kP1Threads> yl;
  if (ntiles > 0) {
    if constexpr (QM > 0) tc_stage_rows<QM, kTcRows>(mu, s, ls, w, q, lo, hi, ring);
    if (one_d) yl.load(y, ys, lo, hi, d0, d);
  }
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    const int n0 = lo + t * kTcRows;
    float x[32];
    if constexpr (QM > 0) {
      const float* st = ring + (t % 2) * stage;
      if (t + 1 < ntiles)
        tc_stage_rows<QM, kTcRows>(mu, s, ls, w, q, n0 + kTcRows, hi, ring + ((t + 1) % 2) * stage);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // this tile's stage is in; the last tile's readers are done
      tc_build_rows<QM, KP, kTcRows, true>(st, alpha, zeta, logsf2, sh, q, rop, s_rc, nullptr);
      for (int r = threadIdx.x; r < kTcRows; r += blockDim.x) s_w[r] = st[2 * kTcRows * QM + r];
      if (one_d) yl.put(ys, nullptr, &yb);
      tc_operands_ready();
      if (one_d && t + 1 < ntiles) yl.load(y, ys, n0 + kTcRows, hi, d0, d);
    } else {
      TcRowConst rc;
      TcRowChunk<kTcRows, kP1Threads, true> rows;
      TcPointChunk<NF, kP1Threads> pch;
      rows.load(mu, s, ls, alpha, zeta, q, n0, hi, 0);
      pch.load(z, zeta, m, q, p0, 0);
      for (int k0 = 0; k0 < q; k0 += kTcQChunk) {
        __syncthreads();  // the last chunk's products (and the last tile's readers) are done
        rows.put(q, n0, hi, k0, &rop, nullptr, &rc);
        pch.put(&pop, nullptr);
        if (k0 == 0 && one_d) yl.put(ys, nullptr, &yb);
        if (k0 + kTcQChunk < q) {  // the next chunk's values, read over this chunk's products
          rows.load(mu, s, ls, alpha, zeta, q, n0, hi, k0 + kTcQChunk);
          pch.load(z, zeta, m, q, p0, k0 + kTcQChunk);
        }
        tc_operands_ready();
        tc_tile_chunk<KP>(pop.hi + wg * kTcRows * KP, pop.lo + wg * kTcRows * KP, rop.hi,
                          rop.lo, x, k0 == 0);
      }
      if (one_d && t + 1 < ntiles) yl.load(y, ys, n0 + kTcRows, hi, d0, d);
      tc_finish_rows<kTcRows, true>(rc, w, logsf2, sh, n0, hi, s_rc, s_w);
      __syncthreads();
    }
    for (int u = 0; u < PT; ++u) {  // round u: the warpgroups' tiles u kP1Wg + wg
      if (p0 + u * kP1Wg * kTcRows >= m) break;  // the round is padding alone (uniform)
      const int ft = (u * kP1Wg + wg) * kTcRows;
      if constexpr (QM > 0) tc_tile<KP>(pop.hi + ft * KP, pop.lo + ft * KP, rop.hi, rop.lo, x);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = tc_n(i);
        x[i] = s_w[r] * tc_exp2(x[i] + s_rc[r]);
      }
      TcRegA a;
      a.set(x, scratch);
      for (int dc = d0; dc < d1; dc += kTcDChunk) {
        if (!one_d) {
          yl.load(y, ys, n0, hi, dc, d);
          __syncthreads();  // the last chunk's readers are done
          yl.put(ys, nullptr, &yb);
          tc_operands_ready();
        }
        float d2[kTcDChunk / 2];
        tc_reduce_split<kTcDChunk>(a, yb.hi, yb.lo, d2, scratch);
        tc_add_cols<kTcDChunk>(d2, tot + ft * ld, ld, dc - d0);
      }
#ifndef __CUDA_ARCH__
      __syncthreads();  // (emulation: the scratch's last readers are done)
#endif
    }
  }

  __syncthreads();
  const double unshift = ldexp(1.0, -(int)sh);
  const int w1 = d1 - d0;
  for (int i = threadIdx.x; i < NF * w1; i += blockDim.x) {
    const int c = i / w1, j = i % w1;
    if (p0 + c < m)
      out[((size_t)blockIdx.y * m + p0 + c) * d + d0 + j] = tot[c * ld + j] * unshift;
  }
}

// The Psi1 forward grid: blocks of 64 inducing points, splits1 N-splits and
// the column passes of Y, into p1y_part (splits1, M, D), every element
// written.
template <int QM>
int launch_psi1_fwd(const float* mu, const float* s, Strides ls, const float* y, Strides ys,
                    const float* w, const float* z, const float* alpha, const float* sf2,
                    const float* zeta, const float* shift1, int n, int m, int q, int d,
                    int splits1, double* p1y_part, cudaStream_t stream) {
  const int dcols = p1_fwd_cols(d, QM);
  const size_t smem = tc_p1_fwd_smem(QM, dcols);
  cudaError_t err = allow_smem(psi1y_fwd_tc_kernel<QM>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m + p1_points(QM) - 1) / p1_points(QM), splits1, p1_fwd_passes(d, QM));
  psi1y_fwd_tc_kernel<QM><<<grid, kP1Threads, smem, stream>>>(
      mu, s, ls, y, ys, w, z, alpha, sf2, zeta, shift1, n, m, q, d,
      (n + splits1 - 1) / splits1, dcols, p1y_part);
  return (int)cudaGetLastError();
}

// What an SM holds of psi2_fwd_tc_kernel<QM, CELLS> as launched: out =
// (its blocks by the card's occupancy calculator, from the kernel's
// registers, launch bounds' threads and tc_cells_smem; the blocks its launch
// bounds ask for; registers a thread; local memory bytes a thread).
template <int QM, bool CELLS>
int psi2_fwd_residency(int* out) {
  const auto kernel = psi2_fwd_tc_kernel<QM, CELLS>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = tc_cells_smem(QM, CELLS);
  if ((err = allow_smem(kernel, smem)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, fa.maxThreadsPerBlock,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  out[1] = 1;
  out[2] = fa.numRegs;
  out[3] = (int)fa.localSizeBytes;
  return 0;
}
template <int QM>
int fwd_residency(int cells, int* out) {
  return cells ? psi2_fwd_residency<QM, true>(out) : psi2_fwd_residency<QM, false>(out);
}
inline int fwd_residency_chunked(int, int*) { return (int)cudaErrorInvalidValue; }

// The Psi2 grid of psi2_fwd_tc_kernel<QM, CELLS> into p2_part (splits2,
// Q + 1, M, M).
template <int QM, bool CELLS>
cudaError_t launch_psi2_fwd(const float* mu, const float* s, Strides ls, const float* w,
                            const float* z, const float* alpha, const float* sf2,
                            const float* zeta, const int2* cells, const float* ce,
                            const float* shift, int n, int m, int q, int splits2,
                            double* p2_part, cudaStream_t stream) {
  const size_t smem = tc_cells_smem(QM, CELLS);
  cudaError_t err = allow_smem(psi2_fwd_tc_kernel<QM, CELLS>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(tc_blocks(m, tc_cell_cells(QM, CELLS)), splits2);
  psi2_fwd_tc_kernel<QM, CELLS><<<grid, tc_cells_threads(QM), smem, stream>>>(
      mu, s, ls, w, z, alpha, sf2, zeta, cells, ce, shift, n, m, q,
      (n + splits2 - 1) / splits2, p2_part);
  return cudaGetLastError();
}

// The Psi2 grid (with cells_sums, forming the cell sums A too), then the
// Psi1 grid.
template <int QM>
int launch_fwd(const float* mu, const float* s, const float* y,
               const float* w, const float* z, const float* alpha,
               const float* sf2, const float* zeta, const int* cells,
               const float* ce, const float* shift, const float* shift1, int n, int m,
               int q, int d, int qn, int splits2, int splits1, int cell_sums,
               double* p2_part, double* p1y_part, cudaStream_t stream) {
  const Strides ls = strides_of(qn, n, q), ys = strides_of(qn, n, d);
  const int2* cells2 = reinterpret_cast<const int2*>(cells);
  const cudaError_t err =
      cell_sums ? launch_psi2_fwd<QM, true>(mu, s, ls, w, z, alpha, sf2, zeta, cells2, ce, shift,
                                            n, m, q, splits2, p2_part, stream)
                : launch_psi2_fwd<QM, false>(mu, s, ls, w, z, alpha, sf2, zeta, cells2, ce,
                                             shift, n, m, q, splits2, p2_part, stream);
  if (err != cudaSuccess) return (int)err;
  return launch_psi1_fwd<p1_qm(QM)>(mu, s, ls, y, ys, w, z, alpha, sf2, zeta, shift1, n, m, q,
                                     d, splits1, p1y_part, stream);
}

// launch_fwd for Q > 64: psi2_fwd_tc_chunked_kernel into p2_part (splits2,
// M, M) and the K-chunked psi1y_fwd_tc_kernel. No forward forms the cell
// sums past Q = 64 (the backward's chunked cell pass does): cell_sums is
// refused.
inline int launch_fwd_chunked(const float* mu, const float* s, const float* y,
                              const float* w, const float* z,
                              const float* alpha, const float* sf2,
                              const float* zeta, const int* cells, const float* ce,
                              const float* shift, const float* shift1, int n, int m, int q,
                              int d, int qn, int splits2, int splits1, int cell_sums,
                              double* p2_part, double* p1y_part, cudaStream_t stream) {
  if (cell_sums) return (int)cudaErrorInvalidValue;
  const Strides ls = strides_of(qn, n, q), ys = strides_of(qn, n, d);
  const int rows2 = std::min((n + splits2 - 1) / splits2, kFwdRowsMax);
  dim3 grid2(tc_blocks(m, kTcChunkFwdCells), splits2);
  const size_t smem2 = tc_fwd_chunked_smem();
  cudaError_t err = allow_smem(psi2_fwd_tc_chunked_kernel, smem2);
  if (err != cudaSuccess) return (int)err;
  for (int n0 = 0; n0 < n; n0 += splits2 * rows2) {
    psi2_fwd_tc_chunked_kernel<<<grid2, 2 * kTcWarpgroup, smem2, stream>>>(
        mu, s, ls, w, z, alpha, sf2, zeta, reinterpret_cast<const int2*>(cells), ce, shift, n0,
        n, m, q, rows2, p2_part);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return launch_psi1_fwd<0>(mu, s, ls, y, ys, w, z, alpha, sf2, zeta, shift1, n, m, q, d,
                            splits1, p1y_part, stream);
}

}  // namespace gparml

// Launch plan of gparml_psi_fwd: plan (int[4]) = (splits2, the N-splits of
// the Psi2 grid, whether or not it forms the cell sums; splits1, the Psi1
// grid's; the largest dynamic shared memory of its blocks in bytes; the
// device's limit for it). Each grid's float64 partials take at most
// partial_bytes.
extern "C" int gparml_psi_fwd_plan(int n, int m, int q, int d, int num_sms,
                                   size_t partial_bytes, int* plan) {
  using namespace gparml;
  const int qm = qm_for(q);
  plan[0] = qm == 0 ? cap_splits(n_splits(n, tc_blocks(m, kTcChunkFwdCells), kRowsPsi2,
                                          kFwdRowsMax, num_sms),
                                 (size_t)m * m * sizeof(double), partial_bytes)
                    : cap_splits(n_splits(n, tc_blocks(m, tc_cell_cells(qm, true)), kRowsPsi2,
                                          kCellRowsMax, num_sms),
                                 (size_t)(q + 1) * m * m * sizeof(double), partial_bytes);
  const int p1 = p1_qm(qm), p1b = (m + p1_points(p1) - 1) / p1_points(p1);
  plan[1] = cap_splits(n_splits(n, p1b * p1_fwd_passes(d, p1), kTcRows,
                                kFwdRowsMax, num_sms),
                       (size_t)m * d * sizeof(double), partial_bytes);
  plan[2] = smem_bytes(std::max({qm == 0 ? tc_fwd_chunked_smem() : tc_cells_smem(qm, true),
                                 qm == 0 ? 0 : tc_cells_smem(qm, false),
                                 tc_p1_fwd_smem(p1, p1_fwd_cols(d, p1))}));
  return (int)smem_limit(plan);
}

// qn = 0: mu, s (N, Q) and y (N, D); qn = 1: mu, s (Q, N) and y (D, N).
// zeta (Q): the shift of mu and Z in the exponents (psi_tc.cuh; the
// wrapper passes the mean of Z); cells (M (M + 1) / 2, 2) int32: the packed
// upper-triangle cells (i, j), i <= j, row by row; ce (M (M + 1) / 2): their
// E0 log2e; shift, shift1: one float each, the whole numbers S and S1 the
// Psi2 and the Psi1 kernels add to every base-2 exponent and take off their
// sums. p1y_part: (splits1, M, D) float64; p2_part: (splits2, Q + 1, M, M)
// float64 up to Q = 64, the Psi2 totals, then with cell_sums the centred
// cell sums A (without, those Q slabs are not written); past Q = 64
// (splits2, M, M), and cell_sums refused. Returns cudaGetLastError.
extern "C" int gparml_psi_fwd(const float* mu, const float* s, const float* y,
                              const float* w, const float* z,
                              const float* alpha, const float* sf2,
                              const float* zeta, const int* cells, const float* ce,
                              const float* shift, const float* shift1, int n, int m, int q, int d,
                              int qn, int splits2, int splits1, int cell_sums, double* p2_part,
                              double* p1y_part, void* stream) {
  GPARML_QM_SWITCH(q, gparml::launch_fwd, gparml::launch_fwd_chunked, mu, s,
                   y, w, z, alpha, sf2, zeta, cells, ce, shift, shift1, n, m, q, d, qn, splits2,
                   splits1, cell_sums, p2_part, p1y_part, static_cast<cudaStream_t>(stream));
}

// psi2_fwd_tc_kernel<Q's bucket, cell_sums>'s residency (Q <= 64), into
// out (int[4]).
extern "C" int gparml_psi_fwd_residency(int q, int cell_sums, int* out) {
  GPARML_QM_SWITCH(q, gparml::fwd_residency, gparml::fwd_residency_chunked, cell_sums, out);
}
