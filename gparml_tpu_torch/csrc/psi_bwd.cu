// Psi-statistics backward on Hopper, float32.
//
// Replaces the TPU kernels gparml_tpu/ops/psi_pallas.py `_bwd_kernel_flat`
// (:794, launched by `_call_bwd_flat`) and its (Q, N)-layout twin
// `_bwd_kernel_flat_t` (:820, launched by `_call_bwd_flat_t`, which emits
// dmu^T, ds^T (Q, N) and dY^T (D, N)), which formed G = exp2(lp) * sym(dPsi2)
// per staircase slab on the MXU and closed the 2-D chains by an in-kernel
// jax.vjp. One set of kernels serves both layouts through the Strides of
// psi_common.cuh: the row passes read mu, s, Y and write dmu, ds, dalpha's
// share and dY at the layout's strides; the column passes stage rows the
// same way in both. Given the cotangents dPsi1Y (M, D) and S = sym(dPsi2)
// (M, M), the cotangents reduce over two different axes, so this file has
// two kinds of pass, each recomputing the exponent:
//
//  * row passes (reductions over cells):
//      psi2_bwd_rows_tc_kernel (Q <= 64), a block per 64 or 128 data rows,
//        walks the packed upper-triangle cells (m <= m') in tiles of 64
//        with K = mult * S (mult = 2 off the diagonal): the tile's
//        exponents and its sums G = sum g, t_q = sum g (zb - mu),
//        u_q = sum g (zb - mu)^2 (g = K w Psi2) on the tensor cores
//        (psi_tc.cuh); it writes dmu = 2 c t, ds = -c G + 2 c^2 u and the
//        row's share of dalpha, -(s/den) G - u / den^2. The walk is a
//        software pipeline: a producer warpgroup builds the cell tiles
//        into a ring of shared-memory stages (4 up to Q = 16, 2 at 32, 1
//        at 64) handed to the consumer warpgroups by a full and an empty
//        mbarrier a stage, with no block barrier in the walk; up to
//        Q = 10 a consumer, its rows' operand in registers, issues the
//        next tile's exponents and this tile's sums together, waits for
//        the exponents alone (wgmma.wait_group 1) and runs the next
//        tile's exp2 epilogue while the sums run.
//      psi1_bwd_rows_tc_kernel<QM>, a block per 128 data rows, walks the
//        inducing points in tiles of 64 (split over blocks at small N):
//        per tile the exponents, y_n . dPsi1Y_m (K = D) and dY = p dPsi1Y
//        on the tensor cores (p = w Psi1), and with h = p (y_n . dPsi1Y_m)
//        the sums H = sum h, t = sum h (mu - z) and u = sum h (mu - z)^2
//        pair by pair; it adds -c1 t, -c1 H/2 + c1^2 u/2 and -(s/den1) H/2
//        - u/(2 den1^2) and writes dY.
//  * column passes (reductions over n, one float64 partial per N-split):
//      the Psi2 cell sums A_q = sum_n w e c_nq (mu_nq - zb_q) with
//        e = Psi2[n, m, m'], which dZ takes, do not depend on dPsi2: up to
//        Q = 64 the forward's sweep forms them (psi_fwd.cu
//        psi2_fwd_tc_kernel<QM, true>) and the caller passes them in, so no
//        pass here forms them; past Q = 64 psi2_bwd_cells_tc_chunked_kernel
//        does, per block of 64 packed cells, wherever dZ is wanted (a_part
//        given). Where no dZ is wanted (Z held), nothing forms A;
//      psi1_bwd_m_tc_kernel<QM>, per block of 128 or 256 inducing points:
//        B_q = sum_n h c1_nq (mu_nq - z_mq), the exponents and the dot on
//        the tensor cores, the sum pair by pair, each 64-row tile's sums
//        added into float64 totals in shared memory.
//    Both sums are centred on the cell (the inducing point), so dZ never
//    forms them as differences of two large uncentred sums.
//    The wrapper sums the partials and assembles dZ, dalpha's cell share and
//    dsf2 with small tensor operations (gparml_tpu_torch/ops/psi_cuda.py).
//
// Past Q = 64 (any Q) the Psi2 row pass has a twin, the cell sums a pass
// of their own and, past Q = 16, the Psi1 passes their K-chunked
// instantiations (QM = 0); they replace the TPU's `_bwd_kernel_stair`
// (:409) and `_bwd_kernel` (:249), launched by `_psi_fused_bwd` outside the
// flat window; the Q <= 64 kernels take the rest of those windows. The
// Psi2 passes, psi2_bwd_rows_tc_chunked_kernel and
// psi2_bwd_cells_tc_chunked_kernel, are tensor-core passes with K
// walked in chunks of kTcQChunk latent dimensions (psi_tc.cuh), the
// reductions taken one dimension chunk at a time into float64 totals in
// shared memory; the Psi1 passes take their centred sums a dimension
// chunk at a time at every Q. Every pass, at any Q, adds an exact shift (2^S for
// Psi2, 2^S1 for Psi1) to its row constants that keeps exp2 clear of
// float32's subnormal range (the totals are scaled back). No pass keeps a
// per-row scratch in device memory: a Psi1 row pass whose float64 totals
// (Y's columns and the dimensions) would outgrow kP1RowCols takes them in
// passes over the grid's z axis, the exponents recomputed in each.
//
// What bounds it on an H100: operations. The backward sweeps the
// N M (M + 1) / 2 (n, cell) pairs once (rows; past Q = 64 twice where dZ
// is wanted, rows and cells) and the N M (n, point) pairs twice; every
// pass forms each tile's exponents on the tensor cores and spends a pair's exp2 on the MUFU and a few float32 operations
// in the epilogue. The Q <= 64 row pass's floor is its 3-term TF32
// products, 3 (K + N2) x 2 flops a pair (288 at Q = 10: 0.73 s at config
// 5's N = 1e7, M = 500), above the MUFU's one exp2 a pair (0.30 s); its
// pipeline runs the products, the exp2 epilogue and the next tile's build
// at once, where an unpipelined walk runs them one after another, and on
// an H100 the products now set its pace (their small-N reduction wgmmas
// run well below the tensor cores' peak rate; PERF.md section 6);
// the Psi2 passes' reductions run on the tensor cores, the
// Psi1 passes' centred sums pair by pair on the CUDA cores (~4 Q float32
// operations a pair: the tensor-core form of them, an expansion around
// zeta, cancels where the latents lie far from zeta, ~1e-5 of float64 on
// the slice's data); the per-tile operand builds
// (the rows' in the cell and point passes, the cells' or points' in the
// row passes, Y's and dPsi1Y's chunks in the Psi1 passes) are shared by a
// block's warpgroups; past Q = 64 (Psi1: 32) both operands of a tile are
// rebuilt chunk by chunk (the dimensions twice: for the exponent and for
// the reductions), and the reductions' float64 totals are read and written
// in shared memory once per tile. Device memory traffic is O(N (Q + D)): a
// row pass reads its rows once and every cell's or point's Z (and K) per
// tile, a column pass its cells or points once and the rows once per block
// (from L2: the grid's x axis varies fastest, so the blocks of one N-split
// read the same rows together).
#include "psi_tc.cuh"

namespace gparml {

// The Psi2 row pass's block (Q <= 64): tc_wg(qm) consumer warpgroups of 64
// data rows each, then one producer warpgroup.
__host__ __device__ constexpr int tc_row_rows(int qm) { return tc_wg(qm) * kTcRows; }
__host__ __device__ constexpr int tc_rows_threads(int qm) {
  return (tc_wg(qm) + 1) * kTcWarpgroup;
}
// One stage of its ring: a 64-cell tile's operand, the tile's transposed
// operand [zb' | zb'^2 | 1] (tc_n2_rows x 64) and the cells' ce and kmat
// entries.
__host__ __device__ constexpr size_t tc_rows_stage_bytes(int qm) {
  return tc_operand_bytes(kTcRows, qm) + tc_b2_bytes(tc_n2_rows(qm)) +
         2 * tc_region(kTcRows * sizeof(float));
}
// Its shared memory beside the ring: the rows' operand, constants and
// weights, and the ring's full and empty barriers.
constexpr int kTcRowsStagesMax = 4;
__host__ __device__ constexpr size_t tc_rows_fixed_bytes(int qm) {
  return tc_operand_bytes(tc_row_rows(qm), qm) + 2 * tc_region(tc_row_rows(qm) * sizeof(float)) +
         tc_region(2 * kTcRowsStagesMax * sizeof(uint64_t));
}
// Stages of the ring: as many as fit beside that in an H100 block's shared
// memory, up to kTcRowsStagesMax (4 up to Q = 16, 2 at 32, 1 at 64).
__host__ __device__ constexpr int tc_rows_stages(int qm) {
  return (int)std::min<size_t>(kTcRowsStagesMax,
                               (kTcSmemMax - tc_rows_fixed_bytes(qm)) / tc_rows_stage_bytes(qm));
}
// Whether a consumer runs each tile's epilogue while the last tile's sums
// are in flight (tc_rows_consume), its rows' operand in registers, up to
// Q = 10: past it the registers of the float64 totals, the reduction and
// that operand leave too few (at Q = 16 the overlapped walk spilled and
// ran no faster on an H100 than running each tile's products in turn).
__host__ __device__ constexpr bool tc_rows_ahead(int qm) { return qm <= 10; }
// The ring's room, which holds the rows' raw stage before the walk and
// their float64 sums (rows x tc_n2_rows) after it.
__host__ __device__ constexpr size_t tc_rows_ring_bytes(int qm) {
  return std::max({tc_rows_stages(qm) * tc_rows_stage_bytes(qm),
                   tc_stage_bytes(tc_row_rows(qm), qm),
                   tc_region((size_t)tc_row_rows(qm) * tc_n2_rows(qm) * sizeof(double))});
}
__host__ __device__ constexpr size_t tc_rows_smem(int qm) {
  return tc_rows_fixed_bytes(qm) + tc_rows_ring_bytes(qm);
}
// Registers of a producer thread and of a consumer thread where the block
// runs two consumer warpgroups (setmaxnreg; the launch gives each of the
// 384 threads 168): the producer holds a cell's QM / 2 values between its
// reads and its writes, 40 registers up to Q = 16 and 72 at Q = 32; the
// consumers share what it leaves of an SM's 65 536 (232, 216).
__host__ __device__ constexpr int tc_rows_producer_regs(int qm) { return qm <= 16 ? 40 : 72; }
__host__ __device__ constexpr int tc_rows_consumer_regs(int qm) {
  return (65536 / kTcWarpgroup - tc_rows_producer_regs(qm)) / 2 / 8 * 8;
}

// Stage s of the ring.
struct TcRowsStage {
  TcOperand cop, b2;
  float *ce, *k;
};
template <int QM>
__device__ inline TcRowsStage tc_rows_stage(char* ring, int s) {
  constexpr int KP = tc_k(QM), N2 = tc_n2_rows(QM);
  TcCarve cv(ring + (size_t)s * tc_rows_stage_bytes(QM));
  TcRowsStage st;
  st.cop.hi = cv.take<float>(kTcRows * KP * sizeof(float));
  st.cop.lo = cv.take<float>(kTcRows * KP * sizeof(float));
  st.b2.hi = cv.take<float>(N2 * kTcRows * sizeof(float));
  st.b2.lo = cv.take<float>(N2 * kTcRows * sizeof(float));
  st.ce = cv.take<float>(kTcRows * sizeof(float));
  st.k = cv.take<float>(kTcRows * sizeof(float));
  return st;
}

// The producer warpgroup of psi2_bwd_rows_tc_kernel: cell tile p (packed
// cells [64 p, 64 p + 64)) into stage p % NS once every consumer has
// released the stage's last tile: thread (cell c, half h) writes the
// cell's dimensions h, h + 2, ... of the operand [zb' | zb'^2] (as
// tc_build_cells forms it) and of its transpose [zb' | zb'^2 | 1], half 0
// also the cell's ce, its kmat entry and the transpose's row of ones (all
// 0 past the last cell; the transpose's padding rows stay zero). The
// tile's Z and kmat reads, and the next tile's (i, j) and ce, are in
// flight while it waits for the stage.
template <int QM>
__device__ inline void tc_rows_produce(const float* __restrict__ z,
                                       const float* __restrict__ zeta,
                                       const int2* __restrict__ cells,
                                       const float* __restrict__ ce,
                                       const float* __restrict__ kmat, int m, int q, char* ring,
                                       uint64_t* full, uint64_t* empty) {
  constexpr int KP = tc_k(QM), NS = tc_rows_stages(QM), KE = QM / 2;
  const int c = threadIdx.x % kTcWarpgroup >> 1, h = threadIdx.x & 1, kc = tc_kperm(c);
  const int ncell = tri_cells(m), tiles = (ncell + kTcRows - 1) / kTcRows;
  int2 ij = c < ncell ? cells[c] : make_int2(-1, -1);
  float ce_c = c < ncell ? ce[c] : 0.f;
  for (int p = 0; p < tiles; ++p) {
    const int pn = (p + 1) * kTcRows + c;
    const int2 ij_n = pn < ncell ? cells[pn] : make_int2(-1, -1);
    const float ce_n = pn < ncell ? ce[pn] : 0.f;
    const bool live = ij.x >= 0;
    const float kv = live && h == 0 ? kmat[(size_t)ij.x * m + ij.y] : 0.f;
    float zb[KE];
#pragma unroll
    for (int j = 0; j < KE; ++j) {
      const int k = h + 2 * j;
      zb[j] = 0.f;
      if (live && k < q) {
        const float zi = z[(size_t)ij.x * q + k] - zeta[k];
        const float zj = z[(size_t)ij.y * q + k] - zeta[k];
        zb[j] = 0.5f * (zi + zj);
      }
    }
    const int s = p % NS;
    tc_bar_wait(empty + s, (p / NS & 1) ^ 1);
    const TcRowsStage st = tc_rows_stage<QM>(ring, s);
#pragma unroll
    for (int j = 0; j < KE; ++j) {
      const int k = h + 2 * j;
      tc_put(st.cop.hi, st.cop.lo, tc_at(c, k, KP), zb[j]);
      tc_put(st.cop.hi, st.cop.lo, tc_at(c, QM + k, KP), zb[j] * zb[j]);
      tc_put(st.b2.hi, st.b2.lo, tc_at(k, kc, 64), zb[j]);
      tc_put(st.b2.hi, st.b2.lo, tc_at(QM + k, kc, 64), zb[j] * zb[j]);
    }
    if (h == 0) {
      st.ce[c] = ce_c;
      st.k[c] = kv;
      tc_put(st.b2.hi, st.b2.lo, tc_at(2 * QM, kc, 64), live ? 1.f : 0.f);
    }
    tc_fence_async();
    tc_bar_arrive(full + s);
    ij = ij_n;
    ce_c = ce_n;
  }
}

// The consumer warpgroups of psi2_bwd_rows_tc_kernel: warpgroup wg's 64
// rows against every cell tile in turn, as stage p % NS fills. Per tile
// the exponents (tc_tile), g = K w exp2(L2) in their registers, and the
// sums T1, T2, G of g [zb' | zb'^2 | 1] (tc_reduce), added into the rows'
// float64 totals tot in tile order; then the stage is released. Up to
// Q = 10 (tc_rows_ahead) a warpgroup keeps the tensor cores busy over its
// epilogue: its rows' operand held in registers as the exponents' A
// (TcRowsA), and tile p's g split into the reduction's A registers, it
// issues tile p + 1's exponents and then tile p's sums and waits for the
// exponents alone (wgmma.wait_group 1); tile p + 1's epilogue then runs
// while tile p's sums are in flight, and waits for them (wait_group 0)
// only before it splits its own g.
template <int QM>
__device__ inline void tc_rows_consume(const TcOperand& rop, const float* s_rc, const float* s_w,
                                       char* ring, uint64_t* full, uint64_t* empty, int ncell,
                                       double (&tot)[tc_n2_rows(QM) / 2]) {
  constexpr int KP = tc_k(QM), N2 = tc_n2_rows(QM), NS = tc_rows_stages(QM);
  const int rw = threadIdx.x / kTcWarpgroup * kTcRows;
  // the constants and weights of the thread's two rows, tc_m(0) and tc_m(2)
  const float rc[2] = {s_rc[rw + tc_m(0)], s_rc[rw + tc_m(2)]};
  const float wr[2] = {s_w[rw + tc_m(0)], s_w[rw + tc_m(2)]};
  const int tiles = (ncell + kTcRows - 1) / kTcRows;
  auto weigh = [&](float (&d)[32], const TcRowsStage& st) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = tc_n(i), h = (i >> 1) & 1;
      d[i] = st.k[c] * (wr[h] * tc_exp2(d[i] + rc[h] + st.ce[c]));
    }
  };
  auto add = [&](const float (&d2)[N2 / 2]) {
#pragma unroll
    for (int e = 0; e < N2 / 2; ++e) tot[e] += d2[e];
  };
  float d[32], d2[N2 / 2];
  if constexpr (tc_rows_ahead(QM)) {
    TcRowsA<KP> ra;
    ra.load(rop.hi, rop.lo, rw);
    TcRegA a;
    auto exps = [&](int p) {
      tc_bar_wait(full + p % NS, p / NS & 1);
      const TcRowsStage sx = tc_rows_stage<QM>(ring, p % NS);
      tc_tile_issue_regs<KP>(ra, sx.cop.hi, sx.cop.lo, d);
    };
    // tile p's epilogue and split, once tile p - 1's sums are in
    auto front = [&](int p, const TcRowsStage& st) {
      weigh(d, st);
      tc_wgmma_wait<0>();
      tc_fence_vals(d2);
      a.fence();
      if (p > 0) {
        add(d2);
        tc_bar_arrive(empty + (p - 1) % NS);
      }
      a.set(d, nullptr);
    };
    exps(0);
    tc_wgmma_wait<0>();
    tc_fence_vals(d);
    int p = 0;
    for (; p + 1 < tiles; ++p) {
      const TcRowsStage st = tc_rows_stage<QM>(ring, p % NS);
      front(p, st);
      exps(p + 1);
      tc_reduce_issue<N2>(a, st.b2.hi, st.b2.lo, d2);
      tc_wgmma_wait<1>();
      tc_fence_vals(d);
    }
    const TcRowsStage st = tc_rows_stage<QM>(ring, p % NS);
    front(p, st);
    tc_reduce_issue<N2>(a, st.b2.hi, st.b2.lo, d2);
    tc_wgmma_wait<0>();
    tc_fence_vals(d2);
    a.fence();
    add(d2);
    tc_bar_arrive(empty + p % NS);
  } else {
    const float* a_hi = rop.hi + rw * KP;
    const float* a_lo = rop.lo + rw * KP;
    for (int p = 0; p < tiles; ++p) {
      tc_bar_wait(full + p % NS, p / NS & 1);
      const TcRowsStage st = tc_rows_stage<QM>(ring, p % NS);
      tc_tile<KP>(a_hi, a_lo, st.cop.hi, st.cop.lo, d);
      weigh(d, st);
      tc_reduce<N2>(d, st.b2.hi, st.b2.lo, d2, nullptr);
      add(d2);
      tc_bar_arrive(empty + p % NS);
    }
  }
}

// The Psi2 row pass (Q <= 64): a block owns 64 data rows a consumer
// warpgroup (the rows' operand built once, the rows on the tile's M axis)
// and walks all packed cells in tiles of 64 (the N axis), pipelined: a
// producer warpgroup builds each tile's cell operand and its transpose
// [zb' | zb'^2 | 1] once for the block into a ring of tc_rows_stages
// stages (4 up to Q = 16, 2 at 32, 1 at 64), handed over by a full and an
// empty mbarrier a stage, with no block barrier in the walk; each consumer
// warpgroup forms its rows' exponents on the tensor cores (psi_tc.cuh),
// turns them in registers into g = K w exp2(L2) (K = mult *
// sym(dPsi2), 0 past the last cell), and multiplies that tile, still in
// registers, by the transpose on the tensor cores again (tc_reduce):
// T1_q = sum g zb'_q, T2_q = sum g zb'_q^2 and G = sum g over the tile's
// cells, which it adds to float64 registers (no float32 sum spans more than
// 64 cells; one over a row's 125 250 cells at M = 500 put dalpha 4e-5 off
// float64), tile after tile (tc_rows_consume: up to Q = 10 a tile's sums
// run on the tensor cores over the next tile's epilogue). At the end,
// in float64, t_q = sum g (zb' - mu')_q = T1 - mu' G and u_q = sum g (zb' -
// mu')_q^2 = T2 - 2 mu' T1 + mu'^2 G (centred on zeta, the expansion keeps
// float32's accuracy: ops/psi_tc_model.py, form "tc"), and thread (row,
// half of the latent dimensions) writes dmu = 2 c t, ds = -c G + 2 c^2 u
// and the row's share of dalpha, -(s/den) G - u/den^2. Every value and sum
// is the one the unpipelined walk formed, in the same order.
template <int QM>
__global__ void __launch_bounds__(tc_rows_threads(QM), 1)
psi2_bwd_rows_tc_kernel(const float* __restrict__ mu, const float* __restrict__ s, Strides ls,
                        const float* __restrict__ w, const float* __restrict__ z,
                        const float* __restrict__ alpha, const float* __restrict__ sf2,
                        const float* __restrict__ zeta, const int2* __restrict__ cells,
                        const float* __restrict__ ce, const float* __restrict__ shift,
                        const float* __restrict__ kmat, int n, int m, int q,
                        float* __restrict__ dmu, float* __restrict__ ds,
                        float* __restrict__ dal) {
  constexpr int KP = tc_k(QM), QS = QM / 2, R = tc_row_rows(QM), N2 = tc_n2_rows(QM);
  constexpr int NC = tc_wg(QM) * kTcWarpgroup, NS = tc_rows_stages(QM);
  static_assert(NS >= (tc_rows_ahead(QM) ? 2 : 1), "the ring holds too few stages");
  extern __shared__ float4 smem4[];
  TcCarve cv(smem4);
  const TcOperand rop = tc_take_operand<KP>(cv, R);
  float* s_rc = cv.take<float>(R * sizeof(float));
  float* s_w = cv.take<float>(R * sizeof(float));
  uint64_t* full = cv.take<uint64_t>(2 * kTcRowsStagesMax * sizeof(uint64_t));
  uint64_t* empty = full + NS;
  char* ring = cv.take<char>(tc_rows_ring_bytes(QM));
  float* st = reinterpret_cast<float*>(ring);
  double* s_tot = reinterpret_cast<double*>(ring);

  const int n0 = blockIdx.x * R;
  tc_stage_rows<QM, R>(mu, s, ls, w, q, n0, n, st);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const float sh = *shift;
  if (threadIdx.x < NC)
    tc_build_rows<QM, KP, R, false, NC>(st, alpha, zeta, logf(*sf2), sh, q, rop, s_rc, nullptr);
  for (int r = threadIdx.x; r < R; r += blockDim.x) s_w[r] = st[2 * R * QM + r];
  __syncthreads();  // the stage's room is the ring's from here; its padding stays zero
  for (int i = threadIdx.x; i < (int)(tc_rows_ring_bytes(QM) / sizeof(float)); i += blockDim.x)
    st[i] = 0.f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      tc_bar_init(full + i, kTcWarpgroup);
      tc_bar_init(empty + i, NC);
    }
    tc_bar_init_fence();
  }
  tc_operands_ready();

  if (threadIdx.x >= NC) {
    if constexpr (NC > kTcWarpgroup) tc_setmaxnreg_dec<tc_rows_producer_regs(QM)>();
    tc_rows_produce<QM>(z, zeta, cells, ce, kmat, m, q, ring, full, empty);
  } else {
    if constexpr (NC > kTcWarpgroup) tc_setmaxnreg_inc<tc_rows_consumer_regs(QM)>();
    double tot[N2 / 2];
#pragma unroll
    for (int e = 0; e < N2 / 2; ++e) tot[e] = 0.0;
    tc_rows_consume<QM>(rop, s_rc, s_w, ring, full, empty, tri_cells(m), tot);

    // the rows' sums through the ring's room once every consumer is done
    // with it, then thread (row, half) writes
    const int rw = threadIdx.x / kTcWarpgroup * kTcRows;
    tc_bar_sync(1, NC);
#pragma unroll
    for (int e = 0; e < N2 / 2; ++e) s_tot[(rw + tc_m(e)) * N2 + tc_n(e)] = tot[e];
    tc_bar_sync(1, NC);
    const int r = threadIdx.x % R, k0 = (threadIdx.x / R) * QS;
    const int row = n0 + r;
    if (row >= n) return;
    const double* t_r = s_tot + r * N2;
    const double unshift = ldexp(1.0, -(int)sh);
    const double g = t_r[2 * QM] * unshift;
    const float gs = (float)g;
    for (int k = 0; k < QS; ++k) {
      const int kk = k0 + k;
      if (kk >= q) break;
      const size_t i = ls.at(row, kk);
      const double mv = (double)(mu[i] - zeta[kk]);
      const double t1 = t_r[kk] * unshift, t2 = t_r[QM + kk] * unshift;
      const float t = (float)(t1 - mv * g);
      const float u = (float)(t2 - 2.0 * mv * t1 + mv * mv * g);
      const float a = alpha[kk];
      const float den = 2.f * a * s[i] + 1.f;
      const float c = a / den;
      dmu[i] = 2.f * c * t;
      ds[i] = -c * gs + 2.f * c * c * u;
      dal[i] = -(s[i] / den) * gs - u / (den * den);
    }
  }
}

// Warpgroups of a Psi2 pass past Q = 64, and the rows (cell pass) or
// cells (row pass) the block walks a step: a 64-tile a warpgroup.
constexpr int kTcChunkWg = 2;
constexpr int kTcChunkWalk = kTcChunkWg * kTcRows;

// Shared memory of the Psi2 passes past Q = 64 (with qp dimensions'
// totals): the operand chunks of the block's fixed 64 rows or cells and of
// the walked 128, whose room holds, in the reductions, the walked tiles'
// transposed operand chunks; the walked (or fixed) rows' constants and
// weights, the cells' ce, kmat entries and (i, j), the rows' G, the
// emulation's scratch, and the float64 totals of the fixed side (64 rows
// of tc_tot_ld(qp)).
__host__ __device__ constexpr size_t tc_bwd_chunked_smem(int qp) {
  return tc_chunk_operand_bytes(kTcRows) + tc_chunk_operand_bytes(kTcChunkWalk) +
         4 * tc_region(kTcChunkWalk * sizeof(float)) + tc_region(kTcChunkWalk * sizeof(int2)) +
         tc_region(kTcRows * sizeof(double)) + tc_scratch_bytes(kTcChunkWg) +
         tc_region((size_t)kTcRows * tc_tot_ld(qp) * sizeof(double));
}

// The carve of tc_bwd_chunked_smem. b2[t]: walked tile t's transposed
// operand chunk (in the room of walk: kTcChunkWg of them, 2 kTcQChunk x 64
// each, fill it).
struct TcChunkSmem {
  TcOperand fix, walk, b2[kTcChunkWg];
  float *s_rc, *s_w, *s_ce, *s_k;
  int2* s_ij;
  double *s_g, *s_tot;
  float* scratch;
  __device__ TcChunkSmem(void* base, int qp) {
    constexpr int kB2 = 2 * kTcQChunk * kTcRows;  // floats of a transposed chunk's hi (or lo)
    static_assert(2 * kTcChunkWg * kB2 == 2 * kTcChunkWalk * kTcKChunk, "b2 fills walk");
    TcCarve cv(base);
    fix = tc_take_chunk(cv, kTcRows, kTcKChunk);
    walk = tc_take_chunk(cv, kTcChunkWalk, kTcKChunk);
    for (int u = 0; u < kTcChunkWg; ++u)
      b2[u] = TcOperand{walk.hi + 2 * u * kB2, walk.hi + (2 * u + 1) * kB2};
    s_rc = cv.take<float>(kTcChunkWalk * sizeof(float));
    s_w = cv.take<float>(kTcChunkWalk * sizeof(float));
    s_ce = cv.take<float>(kTcChunkWalk * sizeof(float));
    s_k = cv.take<float>(kTcChunkWalk * sizeof(float));
    s_ij = cv.take<int2>(kTcChunkWalk * sizeof(int2));
    s_g = cv.take<double>(kTcRows * sizeof(double));
    scratch = cv.take<float>(tc_scratch_bytes(kTcChunkWg)) +
              threadIdx.x / kTcWarpgroup * kTcRows * kTcTileLd;
    s_tot = cv.take<double>((size_t)kTcRows * tc_tot_ld(qp) * sizeof(double));
  }
};

// Add a warpgroup's float32 tile sums into the block's float64 totals, the
// warpgroups one after another (a fixed order; every thread calls it).
template <typename F>
__device__ inline void tc_in_turn(F add) {
  for (int t = 0; t < kTcChunkWg; ++t) {
    if (threadIdx.x / kTcWarpgroup == t) add();
    __syncthreads();
  }
}

// The exponent tile of one step of a chunked pass (A the fixed 64, B the
// warpgroup's walked tile): K walked in chunks, each chunk's raw values
// loaded while the last one is built and multiplied. load_*(k0) reads
// chunk k0's raw values into registers; put_*(k0, op) writes them into an
// operand.
template <class LoadFix, class LoadWalk, class PutFix, class PutWalk>
__device__ inline void tc_chunked_exponents(const TcChunkSmem& sm, int q, int tile,
                                            LoadFix load_fix, LoadWalk load_walk, PutFix put_fix,
                                            PutWalk put_walk, float (&d)[32]) {
  load_fix(0);
  load_walk(0);
  for (int k0 = 0; k0 < q; k0 += kTcQChunk) {
    __syncthreads();  // the operands' last readers are done
    put_fix(k0, sm.fix);
    put_walk(k0, sm.walk);
    if (k0 + kTcQChunk < q) {  // the next chunk's loads, in flight over this one's products
      load_fix(k0 + kTcQChunk);
      load_walk(k0 + kTcQChunk);
    }
    tc_operands_ready();
    tc_tile<kTcKChunk>(sm.fix.hi, sm.fix.lo, sm.walk.hi + tile * kTcKChunk,
                       sm.walk.lo + tile * kTcKChunk, d, k0 > 0);
  }
}

// The reductions of one step of a chunked pass over the dimensions [pq,
// pe): per chunk of kTcQChunk, the warpgroup's tile a (split once) times
// its walked tile's transposed operand chunk (in the walked operand's
// room), added into the totals in turn. load(k0) reads chunk k0's raw
// values; put(k0, b2) writes the walked tiles' transposed chunks into
// b2[0 .. kTcChunkWg).
template <class Load, class Put>
__device__ inline void tc_chunked_reductions(const TcChunkSmem& sm, int pq, int pe, int qp,
                                             TcRegA& a, Load load, Put put) {
  constexpr int N2 = 2 * kTcQChunk;
  const int wg = threadIdx.x / kTcWarpgroup;
  load(pq);
  for (int kd = pq; kd < pe; kd += kTcQChunk) {
    __syncthreads();
    put(kd, sm.b2);
    if (kd + kTcQChunk < pe) load(kd + kTcQChunk);
    tc_operands_ready();
    float d2[N2 / 2];
    tc_reduce_split<N2>(a, sm.b2[wg].hi, sm.b2[wg].lo, d2, sm.scratch);
    tc_in_turn([&] { tc_add_chunk(d2, sm.s_tot, qp, kd - pq); });
  }
}

// psi2_bwd_rows_tc_kernel for any Q > 64, with K in chunks: a block owns
// 64 data rows (on the tiles' M axis; their constants, with the shift S,
// summed once) and walks all packed cells 128 at a time, a tile of 64 for
// each of its two warpgroups. Per step the exponents come from the tensor
// cores over the K chunks (each chunk's operands built in shared memory,
// the rows' once for both warpgroups), are turned in registers into
// g = K w exp2(L2 + S) and, for each chunk of kTcQChunk dimensions,
// multiplied by the warpgroup's cells' transposed [zb' | zb'^2] chunk
// (tc_reduce): T1, T2 over the tile's cells, float32, added into the rows'
// float64 totals in shared memory; G = sum g by warp shuffles over the
// tile, into float64. Past kTcPassChunks chunks the dimensions are taken in
// passes of qp (the exponents recomputed each pass). At the end of a pass
// thread (row, quarter of the pass's dimensions) scales the totals by 2^-S
// and writes dmu = 2 c t, ds = -c G + 2 c^2 u and the row's share of dalpha
// (t = T1 - mu' G, u = T2 - 2 mu' T1 + mu'^2 G, in float64), as
// psi2_bwd_rows_tc_kernel does. No float32 sum spans more than a 64-cell
// tile.
__global__ void __launch_bounds__(kTcChunkWg * kTcWarpgroup)
psi2_bwd_rows_tc_chunked_kernel(const float* __restrict__ mu, const float* __restrict__ s,
                                Strides ls, const float* __restrict__ w,
                                const float* __restrict__ z, const float* __restrict__ alpha,
                                const float* __restrict__ sf2, const float* __restrict__ zeta,
                                const int2* __restrict__ cells, const float* __restrict__ ce,
                                const float* __restrict__ shift, const float* __restrict__ kmat,
                                int n, int m, int q, int qp, float* __restrict__ dmu,
                                float* __restrict__ ds, float* __restrict__ dal) {
  constexpr int NT = kTcChunkWg * kTcWarpgroup;
  extern __shared__ float4 smem4[];
  const TcChunkSmem sm(smem4, qp);
  const int tile = threadIdx.x / kTcWarpgroup * kTcRows;
  const int n0 = blockIdx.x * kTcRows;
  const float sh = *shift;
  TcRowChunk<kTcRows, NT> rows;
  TcCellChunk<kTcChunkWalk, NT> cch;
  {
    TcRowConst rc;
    for (int k0 = 0; k0 < q; k0 += kTcQChunk) {
      rows.load(mu, s, ls, alpha, zeta, q, n0, n, k0);
      rows.put(q, n0, n, k0, nullptr, nullptr, &rc);
    }
    tc_finish_rows<kTcRows>(rc, w, logf(*sf2), sh, n0, n, sm.s_rc, sm.s_w);
  }
  for (int r = threadIdx.x; r < kTcRows; r += blockDim.x) sm.s_g[r] = 0.0;

  const double unshift = ldexp(1.0, -(int)sh);
  const int ncell = tri_cells(m);
  for (int pq = 0; pq < q; pq += qp) {
    const int pe = min(q, pq + qp);
    __syncthreads();
    for (int i = threadIdx.x; i < kTcRows * tc_tot_ld(qp); i += blockDim.x) sm.s_tot[i] = 0.0;
    for (int p0 = 0; p0 < ncell; p0 += kTcChunkWalk) {
      __syncthreads();
      tc_stage_cells<kTcChunkWalk>(cells, ce, kmat, m, p0, sm.s_ij, sm.s_ce, sm.s_k);
      __syncthreads();
      float d[32];
      tc_chunked_exponents(
          sm, q, tile, [&](int k0) { rows.load(mu, s, ls, alpha, zeta, q, n0, n, k0); },
          [&](int k0) { cch.load(z, zeta, sm.s_ij, q, k0); },
          [&](int k0, const TcOperand& op) { rows.put(q, n0, n, k0, &op, nullptr, nullptr); },
          [&](int, const TcOperand& op) { cch.put(&op, nullptr); }, d);
      float gp[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int rr = tc_m(i), c = tile + tc_n(i);
        d[i] = sm.s_k[c] * (sm.s_w[rr] * tc_exp2((d[i] + sm.s_rc[rr]) + sm.s_ce[c]));
        gp[(i >> 1) & 1] += d[i];
      }
      if (pq == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          gp[h] += __shfl_xor_sync(0xffffffffu, gp[h], 1);
          gp[h] += __shfl_xor_sync(0xffffffffu, gp[h], 2);
        }
        tc_in_turn([&] {
          if ((threadIdx.x & 3) != 0) return;
          sm.s_g[tc_m(0)] += (double)gp[0];
          sm.s_g[tc_m(2)] += (double)gp[1];
        });
      }
      TcRegA a;
      a.set(d, sm.scratch);
      tc_chunked_reductions(
          sm, pq, pe, qp, a, [&](int k0) { cch.load(z, zeta, sm.s_ij, q, k0); },
          [&](int, const TcOperand* b2) { cch.put(nullptr, b2); });
    }

    // the pass's dimensions: thread (row, quarter) writes
    __syncthreads();
    const int r = threadIdx.x % kTcRows, row = n0 + r;
    if (row >= n) continue;
    const double g = sm.s_g[r] * unshift;
    const float gs = (float)g;
    const double* t_r = sm.s_tot + (size_t)r * tc_tot_ld(qp);
    for (int kk = pq + threadIdx.x / kTcRows; kk < pe; kk += blockDim.x / kTcRows) {
      const size_t i = ls.at(row, kk);
      const double t1 = t_r[kk - pq] * unshift, t2 = t_r[qp + kk - pq] * unshift;
      const double mv = (double)(mu[i] - zeta[kk]);
      const float t = (float)(t1 - mv * g);
      const float u = (float)(t2 - 2.0 * mv * t1 + mv * mv * g);
      const float a = alpha[kk];
      const float den = 2.f * a * s[i] + 1.f;
      const float c = a / den;
      dmu[i] = 2.f * c * t;
      ds[i] = -c * gs + 2.f * c * c * u;
      dal[i] = -(s[i] / den) * gs - u / (den * den);
    }
  }
}

// The cell sums that psi2_fwd_tc_kernel<QM, true> (psi_fwd.cu) forms up to
// Q = 64, for any Q > 64, in the backward and with K in chunks: per block of
// 64 packed cells (on the tiles' M axis) and N-split, A_q = sum_n w e c_nq
// (mu'_nq - zb'_q), centred on the cell. The split's rows are walked 128
// at a time, a tile of 64 for each of the two warpgroups; per step the
// exponents come from the tensor cores over the K chunks (the cells'
// operand chunk built once for both warpgroups; the rows' constants, with
// the shift S, summed over the chunks by the threads that build them), are
// turned in registers into ev = w exp2(L2 + S) (0 past the last cell) and,
// for each chunk of kTcQChunk dimensions, multiplied by the warpgroup's
// rows' transposed [c mu' | c] chunk (tc_reduce): S1, S2 over the tile's
// rows, float32, added into the cells' float64 totals in shared memory.
// Past kTcPassChunks chunks the dimensions are taken in passes of qp. At
// the end of a pass the split's float64 (Q, M, M) partial gets A = (S1 -
// zb' S2) 2^-S, both triangles.
__global__ void __launch_bounds__(kTcChunkWg * kTcWarpgroup)
psi2_bwd_cells_tc_chunked_kernel(const float* __restrict__ mu, const float* __restrict__ s,
                                 Strides ls, const float* __restrict__ w,
                                 const float* __restrict__ z, const float* __restrict__ alpha,
                                 const float* __restrict__ sf2, const float* __restrict__ zeta,
                                 const int2* __restrict__ cells, const float* __restrict__ ce,
                                 const float* __restrict__ shift, int n, int m, int q, int qp,
                                 int rows_per_split, double* __restrict__ out) {
  constexpr int NT = kTcChunkWg * kTcWarpgroup;
  extern __shared__ float4 smem4[];
  const TcChunkSmem sm(smem4, qp);
  const int tile = threadIdx.x / kTcWarpgroup * kTcRows;
  tc_stage_cells<kTcRows>(cells, ce, nullptr, m, blockIdx.x * kTcRows, sm.s_ij, sm.s_ce,
                          nullptr);
  __syncthreads();
  TcRowChunk<kTcChunkWalk, NT> rows;
  TcCellChunk<kTcRows, NT> cch;
  const float logsf2 = logf(*sf2), sh = *shift;
  const double unshift = ldexp(1.0, -(int)sh);
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(n, lo + rows_per_split);
  const size_t mm = (size_t)m * m;
  double* o = out + (size_t)blockIdx.y * q * mm;
  for (int pq = 0; pq < q; pq += qp) {
    const int pe = min(q, pq + qp);
    __syncthreads();
    for (int i = threadIdx.x; i < kTcRows * tc_tot_ld(qp); i += blockDim.x) sm.s_tot[i] = 0.0;
    for (int n0 = lo; n0 < hi; n0 += kTcChunkWalk) {
      TcRowConst rc;
      float d[32];
      tc_chunked_exponents(
          sm, q, tile, [&](int k0) { cch.load(z, zeta, sm.s_ij, q, k0); },
          [&](int k0) { rows.load(mu, s, ls, alpha, zeta, q, n0, hi, k0); },
          [&](int, const TcOperand& op) { cch.put(&op, nullptr); },
          [&](int k0, const TcOperand& op) { rows.put(q, n0, hi, k0, &op, nullptr, &rc); }, d);
      tc_finish_rows<kTcChunkWalk>(rc, w, logsf2, sh, n0, hi, sm.s_rc, sm.s_w);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = tc_m(i), r = tile + tc_n(i);
        d[i] = sm.s_ij[c].x >= 0
                   ? sm.s_w[r] * tc_exp2((d[i] + sm.s_rc[r]) + sm.s_ce[c])
                   : 0.f;
      }
      TcRegA a;
      a.set(d, sm.scratch);
      tc_chunked_reductions(
          sm, pq, pe, qp, a, [&](int k0) { rows.load(mu, s, ls, alpha, zeta, q, n0, hi, k0); },
          [&](int k0, const TcOperand* b2) { rows.put(q, n0, hi, k0, nullptr, b2, nullptr); });
    }

    // the pass's dimensions of the split's partial, each (cell, dimension)
    // written by one thread
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTcRows * (pe - pq); idx += blockDim.x) {
      const int c = idx % kTcRows, kk = pq + idx / kTcRows;
      const int2 ij = sm.s_ij[c];
      if (ij.x < 0) continue;
      const double* t_c = sm.s_tot + (size_t)c * tc_tot_ld(qp);
      const float zb = 0.5f * ((z[(size_t)ij.x * q + kk] - zeta[kk]) +
                               (z[(size_t)ij.y * q + kk] - zeta[kk]));
      const double a = (t_c[kk - pq] - (double)zb * t_c[qp + kk - pq]) * unshift;
      o[kk * mm + (size_t)ij.x * m + ij.y] = a;
      if (ij.x != ij.y) o[kk * mm + (size_t)ij.y * m + ij.x] = a;
    }
  }
}

// --- the Psi1 passes ---------------------------------------------------------

// Latent dimensions whose floats (mu', z', c1) a Psi1 pass keeps in shared
// memory at once for its per-pair sums: all of a bucket's, a chunk past it.
__host__ __device__ constexpr int p1_qdims(int qm) { return qm ? qm : kTcQChunk; }

// The Psi1 row pass's reductions come in chunks: for Y, kTcDChunk columns
// of dY (p dPsi1Y); for the latent dimensions, kTcQChunk of them, 2
// kTcQChunk columns [t | u] (sum h (mu - z), sum h (mu - z)^2). A block
// keeps the float64
// totals of at most kP1RowCols such columns of its rows in shared memory;
// the chunks, the Y chunks first, are packed in that order into as few
// passes (the grid's z axis) as fit, each pass recomputing the exponents.
// p1_row_plan returns the number of passes and, with range, pass `want`'s
// Y chunks [range[0], range[1]) and dimension chunks [range[2], range[3]).
constexpr int kP1RowCols = 96;
__host__ __device__ inline int p1_row_plan(int q, int d, int want, int* range) {
  const int ny = (d + kTcDChunk - 1) / kTcDChunk, nt = (q + kTcQChunk - 1) / kTcQChunk;
  int pass = 0, used = 0, c0 = 0;
  for (int c = 0; c <= ny + nt; ++c) {
    const int width = c < ny ? kTcDChunk : 2 * kTcQChunk;
    if (c == ny + nt || (used > 0 && used + width > kP1RowCols)) {
      if (pass == want && range) {
        range[0] = c0 < ny ? c0 : ny;
        range[1] = c < ny ? c : ny;
        range[2] = c0 > ny ? c0 - ny : 0;
        range[3] = c > ny ? c - ny : 0;
      }
      ++pass;
      used = 0;
      c0 = c;
    }
    used += width;
  }
  return pass;
}
// Row stride (doubles) of a row pass's totals: its widest pass's columns,
// then the column of H = sum h.
__host__ __device__ inline int p1_row_ld(int q, int d) {
  const int ny = (d + kTcDChunk - 1) / kTcDChunk, nt = (q + kTcQChunk - 1) / kTcQChunk;
  const int cols = kTcDChunk * ny + 2 * kTcQChunk * nt;
  return (cols < kP1RowCols ? cols : kP1RowCols) + 1;
}

// Shared memory of the Psi1 row pass (bucket qm, or 0) with totals of ld
// doubles a row: the rows' operand (kP1Fixed rows) and the points' (or K
// chunks of them); the rows' mu' and the points' z' as floats (p1_qdims
// of them); the rows' constants and weights; the dot's operands (the rows'
// Y chunk, the points' dPsi1Y chunk) and dPsi1Y's transposed chunk; the
// float64 totals (kP1Fixed x ld, whose room holds the rows' raw stage at
// the start) and the emulation's scratch.
__host__ __device__ constexpr size_t tc_p1_rows_smem(int qm, int ld) {
  return (qm ? tc_operand_bytes(kP1Fixed, qm) + tc_operand_bytes(kTcRows, qm)
             : tc_chunk_operand_bytes(kP1Fixed) + tc_chunk_operand_bytes(kTcRows)) +
         tc_region((size_t)(kP1Fixed + kTcRows) * p1_qdims(qm) * sizeof(float)) +
         2 * tc_region(kP1Fixed * sizeof(float)) +
         2 * tc_region((size_t)kP1Fixed * kTcDChunk * sizeof(float)) + 2 * tc_b2_bytes(kTcDChunk) +
         tc_region((size_t)kP1Fixed * ld * sizeof(double) > tc_stage_bytes(kP1Fixed, qm)
                       ? (size_t)kP1Fixed * ld * sizeof(double)
                       : tc_stage_bytes(kP1Fixed, qm)) +
         tc_scratch_bytes(kP1Wg);
}

// Elements of dmu, ds and dalpha's row shares a thread updates at once in
// the Psi1 row pass's epilogue: all their loads issued before any store.
constexpr int kP1GradBatch = 4;

// The Psi1 row terms of dmu, ds and dalpha's row share at one element (s
// and alpha of it) from the row's float64 sums over the inducing points
// (already x 2^-S1) H = sum h, t = sum h (mu - z) and u = sum h (mu - z)^2:
// -c1 t, -c1 H / 2 + c1^2 u / 2 and -(s/den1) H / 2 - u / (2 den1^2).
struct P1Grads {
  float dmu, ds, dal;
};
__device__ inline P1Grads p1_grad_terms(float s, float a, double g, double t, double u) {
  const float gs = (float)g, tf = (float)t, uf = (float)u;
  const float den = a * s + 1.f;
  const float c = a / den;
  return {-c * tf, -0.5f * c * gs + 0.5f * c * c * uf,
          -0.5f * (s / den) * gs - 0.5f * uf / (den * den)};
}

// Add the Psi1 row terms (p1_grad_terms) to dmu, ds and dalpha's row share
// at elements i0, i0 + stride, ... (kP1GradBatch of them, those below
// total), element e at (row, k) = at(e) with the row's sums sums(e, &H, &t,
// &u), added to what the Psi2 row pass wrote. Every load of the batch is
// issued before its stores, so that their latencies overlap.
template <class At, class Sums>
__device__ inline void p1_row_grads(const float* __restrict__ s, Strides ls,
                                    const float* __restrict__ alpha, int i0, int stride,
                                    int total, At at, Sums sums, float* __restrict__ dmu,
                                    float* __restrict__ ds, float* __restrict__ dal) {
  size_t idx[kP1GradBatch];
  int kk[kP1GradBatch];
  bool live[kP1GradBatch];
  float sv[kP1GradBatch], o0[kP1GradBatch], o1[kP1GradBatch], o2[kP1GradBatch];
#pragma unroll
  for (int b = 0; b < kP1GradBatch; ++b) {
    const int e = i0 + b * stride;
    int row;
    live[b] = e < total && at(e, &row, &kk[b]);
    if (!live[b]) continue;
    idx[b] = ls.at(row, kk[b]);
    sv[b] = s[idx[b]];
    o0[b] = dmu[idx[b]];
    o1[b] = ds[idx[b]];
    o2[b] = dal[idx[b]];
  }
#pragma unroll
  for (int b = 0; b < kP1GradBatch; ++b) {
    if (!live[b]) continue;
    double g, t, u;
    sums(i0 + b * stride, &g, &t, &u);
    const P1Grads gr = p1_grad_terms(sv[b], alpha[kk[b]], g, t, u);
    dmu[idx[b]] = o0[b] + gr.dmu;
    ds[idx[b]] = o1[b] + gr.ds;
    dal[idx[b]] = o2[b] + gr.dal;
  }
}

// The Psi1 row pass: a block owns kP1Fixed data rows (grid x; 64 a
// warpgroup, on the tile's M axis; their operand [c1 mu' | -c1/2] log2e and
// constants, with the shift S1, built once) and walks its split's inducing
// points (grid y, when the row blocks alone cannot fill the card) in tiles
// of 64 (the N axis). Each tile's point operand [z' | z'^2], transposed
// chunks and dPsi1Y chunk are built once for both warpgroups, from values
// read a tile ahead. Each warpgroup forms its rows' exponents on the
// tensor cores (tc_tile, 3-term TF32, centred on zeta), turns them in
// registers into p = w exp2(L1 + S1) (0 past the last point) and walks D in
// chunks of kTcDChunk: y . dPsi1Y_m as a second tensor-core product (the
// rows' Y chunk, built once when D fits one chunk, times the points'
// dPsi1Y chunk, K = D, into one float32 accumulator), and for the pass's Y
// chunks dY = p dPsi1Y (tc_reduce_split of p, split once, by the points'
// transposed chunk). Then h = p (y . dPsi1Y) in registers, H = sum h by warp
// shuffles, and per dimension of the pass t = sum h (mu' - z') and u = sum
// h (mu' - z')^2 pair by pair from the rows' mu' and the points' z' kept as
// floats (each thread over its 16 points, then warp shuffles). Every
// float32 sum spans one 64-point tile; the tiles add into float64 totals in
// shared memory. Each exponent is computed once
// per pass (grid z: one pass unless the totals of Y and the dimensions
// exceed kP1RowCols columns). At the end, with one split, the block writes
// dY (=) and adds dmu, ds, dalpha's share (p1_row_grads) to the Psi2 row
// pass's; with several it writes its split's float64 row partials part
// (splits, N, 2 Q + 1 + D: [t | u | H | dY]) for
// psi1_bwd_rows_finish_kernel. Past kTcP1BucketMax (QM = 0) K is walked in
// chunks, the rows' operand chunks rebuilt for every tile, and mu' and z'
// staged a dimension chunk at a time.
template <int QM>
__global__ void __launch_bounds__(kP1Threads)
psi1_bwd_rows_tc_kernel(const float* __restrict__ mu, const float* __restrict__ s, Strides ls,
                        const float* __restrict__ y, Strides ys, const float* __restrict__ w,
                        const float* __restrict__ z, const float* __restrict__ alpha,
                        const float* __restrict__ sf2, const float* __restrict__ zeta,
                        const float* __restrict__ shift, const float* __restrict__ r1, int n,
                        int m, int q, int d, int tiles_per_split, int ld,
                        float* __restrict__ dmu, float* __restrict__ ds,
                        float* __restrict__ dal, float* __restrict__ dy,
                        double* __restrict__ part) {
  constexpr int KP = QM ? tc_k(QM) : kTcKChunk;
  extern __shared__ float4 smem4[];
  TcCarve cv(smem4);
  constexpr int QD = p1_qdims(QM);
  const TcOperand fix = tc_take_operand<KP>(cv, kP1Fixed);
  const TcOperand walk = tc_take_operand<KP>(cv, kTcRows);
  float* s_mu = cv.take<float>((kP1Fixed + kTcRows) * QD * sizeof(float));  // mu' [k][row]
  float* s_zt = s_mu + kP1Fixed * QD;                                        // z' [k][point]
  float* s_rc = cv.take<float>(kP1Fixed * sizeof(float));
  float* s_w = cv.take<float>(kP1Fixed * sizeof(float));
  const TcOperand da = tc_take_chunk(cv, kP1Fixed, kTcDChunk);
  const TcOperand db = tc_take_chunk(cv, kTcRows, kTcDChunk);
  const TcOperand dt = tc_take_chunk(cv, kTcDChunk, kTcRows);
  const size_t tot_bytes = (size_t)kP1Fixed * ld * sizeof(double);
  double* tot = cv.take<double>(tot_bytes > tc_stage_bytes(kP1Fixed, QM)
                                    ? tot_bytes
                                    : tc_stage_bytes(kP1Fixed, QM));
  const int wg = threadIdx.x / kTcWarpgroup, rw = wg * kTcRows;
  float* scratch = cv.take<float>(tc_scratch_bytes(kP1Wg)) + wg * kTcRows * kTcTileLd;
  int range[4];
  p1_row_plan(q, d, blockIdx.z, range);
  const int y0 = range[0], y1 = range[1], t0 = range[2], t1 = range[3];
  const bool has_t = t1 > t0;
  const int ny = (d + kTcDChunk - 1) / kTcDChunk;
  const bool one_d = ny == 1, in_y0 = y0 == 0 && y1 > 0;
  const Strides rs{(size_t)d, 1};
  const int n0 = blockIdx.x * kP1Fixed;
  const float logsf2 = logf(*sf2), sh = *shift;
  __syncthreads();  // the carve's zeros are in
  // the rows: operand (buckets) and constants, from a raw stage in the
  // totals' room; the rows' Y chunk and the first point tile's values are
  // read while the stage is in flight
  const int ntiles = (m + kTcRows - 1) / kTcRows;
  const int pt0 = blockIdx.y * tiles_per_split, pt1 = min(ntiles, pt0 + tiles_per_split);
  TcPointLoad<QM ? QM : 1, kP1Threads> pl;
  TcDChunk<kTcRows, kP1Threads> rl;
  TcDChunk<kP1Fixed, kP1Threads> yl;
  if constexpr (QM > 0)
    tc_stage_rows<QM, kP1Fixed>(mu, s, ls, w, q, n0, n, reinterpret_cast<float*>(tot));
  cp_async_commit();
  if (one_d && has_t) yl.load(y, ys, n0, n, 0, d);
  if (pt0 < pt1) {
    if constexpr (QM > 0) pl.load(z, zeta, m, q, pt0 * kTcRows);
    if (one_d) rl.load(r1, rs, pt0 * kTcRows, m, 0, d);
  }
  if constexpr (QM > 0) {
    const float* st = reinterpret_cast<const float*>(tot);
    cp_async_wait<0>();
    __syncthreads();
    tc_build_rows<QM, KP, kP1Fixed, true>(st, alpha, zeta, logsf2, sh, q, fix, s_rc, nullptr);
    for (int r = threadIdx.x; r < kP1Fixed; r += blockDim.x) s_w[r] = st[2 * kP1Fixed * QM + r];
    for (int i = threadIdx.x; i < kP1Fixed * QM; i += blockDim.x) {
      const int r = i % kP1Fixed, k = i / kP1Fixed;
      s_mu[i] = k < q ? st[r * QM + k] - zeta[k] : 0.f;
    }
    __syncthreads();  // the stage is read
  } else {
    TcRowConst rc;
    TcRowChunk<kP1Fixed, kP1Threads, true> rows;
    for (int k0 = 0; k0 < q; k0 += kTcQChunk) {
      rows.load(mu, s, ls, alpha, zeta, q, n0, n, k0);
      rows.put(q, n0, n, k0, nullptr, nullptr, &rc);
    }
    tc_finish_rows<kP1Fixed, true>(rc, w, logsf2, sh, n0, n, s_rc, s_w);
  }
  for (int i = threadIdx.x; i < kP1Fixed * ld; i += blockDim.x) tot[i] = 0.0;
  double* tot_w = tot + rw * ld;
  if (one_d && has_t) yl.put(ys, &da, nullptr);  // the rows' Y chunk, for every tile

  for (int pt = pt0; pt < pt1; ++pt) {
    const int p0 = pt * kTcRows;
    const bool next = pt + 1 < pt1;
    float x[32], dot[32];
    __syncthreads();  // the last tile's readers (and the rows' build) are done
    if (one_d) rl.put(rs, has_t ? &db : nullptr, in_y0 ? &dt : nullptr);
    if constexpr (QM > 0) {
      pl.template put<KP>(walk, has_t ? s_zt : nullptr);
      tc_operands_ready();
      if (next) {  // the next tile's values, in flight over this tile's products
        pl.load(z, zeta, m, q, p0 + kTcRows);
        if (one_d) rl.load(r1, rs, p0 + kTcRows, m, 0, d);
      }
    }
    if constexpr (QM > 0) {
      tc_tile<KP>(fix.hi + rw * KP, fix.lo + rw * KP, walk.hi, walk.lo, x);
    } else {
      TcRowChunk<kP1Fixed, kP1Threads, true> rows;
      TcPointChunk<kTcRows, kP1Threads> pch;
      rows.load(mu, s, ls, alpha, zeta, q, n0, n, 0);
      pch.load(z, zeta, m, q, p0, 0);
      for (int k0 = 0; k0 < q; k0 += kTcQChunk) {
        __syncthreads();  // the operands' last readers are done
        rows.put(q, n0, n, k0, &fix, nullptr, nullptr);
        pch.put(&walk, nullptr);
        if (k0 + kTcQChunk < q) {
          rows.load(mu, s, ls, alpha, zeta, q, n0, n, k0 + kTcQChunk);
          pch.load(z, zeta, m, q, p0, k0 + kTcQChunk);
        }
        tc_operands_ready();
        tc_tile_chunk<KP>(fix.hi + rw * KP, fix.lo + rw * KP, walk.hi, walk.lo, x, k0 == 0);
      }
      if (next && one_d) rl.load(r1, rs, p0 + kTcRows, m, 0, d);  // over the rest of the tile
    }
    // y . dPsi1Y over D's chunks (the Y chunks' operands built here when
    // D takes more than one)
    for (int j = 0; has_t && j < ny; ++j) {
      if (!one_d) {
        TcDChunk<kP1Fixed, kP1Threads> yl;
        yl.load(y, ys, n0, n, j * kTcDChunk, d);
        rl.load(r1, rs, p0, m, j * kTcDChunk, d);
        __syncthreads();  // the last chunk's readers are done
        yl.put(ys, &da, nullptr);
        rl.put(rs, &db, nullptr);
        tc_operands_ready();
      }
      tc_tile_chunk<kTcDChunk>(da.hi + rw * kTcDChunk, da.lo + rw * kTcDChunk, db.hi, db.lo, dot,
                               j == 0);
    }
    // p = w exp2(L1 + S1), 0 past the last point
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = rw + tc_m(i);
      x[i] = p0 + tc_n(i) < m ? s_w[r] * tc_exp2(x[i] + s_rc[r]) : 0.f;
    }
    if (has_t) {  // h = p (y . dPsi1Y) into dot's registers, and H = sum h
      float hp[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        dot[i] *= x[i];
        hp[(i >> 1) & 1] += dot[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        hp[h] += __shfl_xor_sync(0xffffffffu, hp[h], 1);
        hp[h] += __shfl_xor_sync(0xffffffffu, hp[h], 2);
      }
      if ((threadIdx.x & 3) == 0) {
        tot_w[tc_m(0) * ld + ld - 1] += (double)hp[0];
        tot_w[tc_m(2) * ld + ld - 1] += (double)hp[1];
      }
    }
    if (y1 > y0) {  // dY = p dPsi1Y for the pass's Y chunks
      TcRegA a;
      a.set(x, scratch);
      for (int j = y0; j < y1; ++j) {
        if (!one_d) {
          rl.load(r1, rs, p0, m, j * kTcDChunk, d);
          __syncthreads();  // the last chunk's readers are done
          rl.put(rs, nullptr, &dt);
          tc_operands_ready();
        }
        float d2[kTcDChunk / 2];
        tc_reduce_split<kTcDChunk>(a, dt.hi, dt.lo, d2, scratch);
        tc_add_cols<kTcDChunk>(d2, tot_w, ld, (j - y0) * kTcDChunk);
      }
#ifndef __CUDA_ARCH__
      __syncthreads();  // (emulation: the scratch's last readers are done)
#endif
    }
    if (!has_t) continue;
    // per dimension of the pass, t = sum h (mu' - z') and u = sum h (mu' -
    // z')^2 over the tile's points, pair by pair in float32 (the expanded
    // form mu'^2 H - 2 mu' T1 + T2 cancels where |mu'| >> |mu - z|)
    for (int j = t0; j < t1; ++j) {
      const int kb = j * kTcQChunk, ke = min(q, kb + kTcQChunk);
      if constexpr (QM == 0) {  // this chunk's mu' of the rows and z' of the points
        TcPointChunk<kTcRows, kP1Threads> pch;
        pch.load(z, zeta, m, q, p0, kb);
        __syncthreads();  // the last chunk's readers are done
        pch.put(nullptr, s_zt);
        for (int i = threadIdx.x; i < kP1Fixed * kTcQChunk; i += blockDim.x) {
          const int r = i % kP1Fixed, k = kb + i / kP1Fixed;
          s_mu[i] = n0 + r < n && k < q ? mu[ls.at(n0 + r, k)] - zeta[k] : 0.f;
        }
        __syncthreads();
      }
      for (int k = kb; k < ke; ++k) {
        const int kq = QM ? k : k - kb;
        const float* zq = s_zt + kq * kTcRows;
        const float mA = s_mu[kq * kP1Fixed + rw + tc_m(0)], mB = s_mu[kq * kP1Fixed + rw + tc_m(2)];
        float tA = 0.f, uA = 0.f, tB = 0.f, uB = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const bool b = (i >> 1) & 1;
          const float dv = (b ? mB : mA) - zq[tc_n(i)];
          const float hd = dot[i] * dv;
          if (b) {
            tB += hd;
            uB = fmaf(hd, dv, uB);
          } else {
            tA += hd;
            uA = fmaf(hd, dv, uA);
          }
        }
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          tA += __shfl_xor_sync(0xffffffffu, tA, o);
          uA += __shfl_xor_sync(0xffffffffu, uA, o);
          tB += __shfl_xor_sync(0xffffffffu, tB, o);
          uB += __shfl_xor_sync(0xffffffffu, uB, o);
        }
        if ((threadIdx.x & 3) == 0) {
          const int col = (y1 - y0) * kTcDChunk + (j - t0) * 2 * kTcQChunk + (k - kb);
          tot_w[tc_m(0) * ld + col] += (double)tA;
          tot_w[tc_m(0) * ld + col + kTcQChunk] += (double)uA;
          tot_w[tc_m(2) * ld + col] += (double)tB;
          tot_w[tc_m(2) * ld + col + kTcQChunk] += (double)uB;
        }
      }
    }
  }

  __syncthreads();
  const double unshift = ldexp(1.0, -(int)sh);
  const size_t pw = (size_t)2 * q + 1 + d;  // a partial row
  const int dc0 = y0 * kTcDChunk, yw = min(d, y1 * kTcDChunk) - dc0;
  for (int i = threadIdx.x; i < kP1Fixed * yw; i += blockDim.x) {
    int r, j;
    stage_index<kP1Fixed>(i, yw, ys.rows_contiguous(), &r, &j);
    const int row = n0 + r;
    if (row >= n) continue;
    const double v = tot[r * ld + j] * unshift;
    if (part)
      part[((size_t)blockIdx.y * n + row) * pw + 2 * q + 1 + dc0 + j] = v;
    else
      dy[ys.at(row, dc0 + j)] = (float)v;
  }
  if (!has_t) return;
  const int k0 = t0 * kTcQChunk, kw = min(q, t1 * kTcQChunk) - k0, total = kP1Fixed * kw;
  const bool lat_by_row = ls.rows_contiguous();
  // element e of the pass's dimensions: (row, k), and its row's sums
  auto at = [&](int e, int* row, int* k) {
    int r, kk;
    stage_index<kP1Fixed>(e, kw, lat_by_row, &r, &kk);
    *row = n0 + r;
    *k = k0 + kk;
    return *row < n;
  };
  auto sums = [&](int e, double* g, double* tv, double* uv) {
    int r, kk;
    stage_index<kP1Fixed>(e, kw, lat_by_row, &r, &kk);
    const double* tr = tot + r * ld;
    const int k = k0 + kk;
    const int col = (y1 - y0) * kTcDChunk + (k / kTcQChunk - t0) * 2 * kTcQChunk + k % kTcQChunk;
    *g = tr[ld - 1] * unshift;
    *tv = tr[col] * unshift;
    *uv = tr[col + kTcQChunk] * unshift;
  };
  if (!part) {
    for (int i0 = threadIdx.x; i0 < total; i0 += kP1GradBatch * blockDim.x)
      p1_row_grads(s, ls, alpha, i0, blockDim.x, total, at, sums, dmu, ds, dal);
    return;
  }
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    int row, k;
    if (!at(e, &row, &k)) continue;
    double g, tv, uv;
    sums(e, &g, &tv, &uv);
    double* pr = part + ((size_t)blockIdx.y * n + row) * pw;
    pr[k] = tv;
    pr[q + k] = uv;
    if (k == 0) pr[2 * q] = g;
  }
}

// The Psi1 row pass's finish when its points were split over blocks: per
// data row, the splits' float64 partials [t | u | H | dY] summed in split
// order, then dmu, ds and dalpha's share added (p1_grad_terms) and dY
// written.
__global__ void __launch_bounds__(256)
psi1_bwd_rows_finish_kernel(const float* __restrict__ s, Strides ls, Strides ys,
                            const float* __restrict__ alpha, const double* __restrict__ part,
                            int splits, int n, int q, int d, float* __restrict__ dmu,
                            float* __restrict__ ds, float* __restrict__ dal,
                            float* __restrict__ dy) {
  const size_t pw = (size_t)2 * q + 1 + d, step = (size_t)n * pw;
  const int stride = gridDim.x * blockDim.x, first = blockIdx.x * blockDim.x + threadIdx.x;
  for (int e = first; e < n * q; e += stride) {  // dmu, ds, dalpha: (row, k) row-major
    const int row = e / q, k = e % q;
    const double* pr = part + (size_t)row * pw;
    double g = 0.0, t1 = 0.0, t2 = 0.0;
    for (int sp = 0; sp < splits; ++sp) {
      g += pr[sp * step + 2 * q];
      t1 += pr[sp * step + k];
      t2 += pr[sp * step + q + k];
    }
    const size_t i = ls.at(row, k);
    const P1Grads gr = p1_grad_terms(s[i], alpha[k], g, t1, t2);
    dmu[i] += gr.dmu;
    ds[i] += gr.ds;
    dal[i] += gr.dal;
  }
  for (int e = first; e < n * d; e += stride) {
    const int row = e / d, j = e % d;
    const double* pr = part + (size_t)row * pw + 2 * q + 1 + j;
    double v = 0.0;
    for (int sp = 0; sp < splits; ++sp) v += pr[sp * step];
    dy[ys.at(row, j)] = (float)v;
  }
}

// Dimension chunks (of kTcQChunk) one block of the Psi1 point pass keeps
// the float64 totals of; wider Q is split over the grid's z axis.
constexpr int kP1PointChunks = 3;
inline int p1_point_passes(int q) {
  return ((q + kTcQChunk - 1) / kTcQChunk + kP1PointChunks - 1) / kP1PointChunks;
}
__host__ __device__ inline int p1_point_ld(int q) {
  const int nt = (q + kTcQChunk - 1) / kTcQChunk;
  return kTcQChunk * (nt < kP1PointChunks ? nt : kP1PointChunks) + 1;
}

// Shared memory of the Psi1 point pass (bucket qm, or 0): the points'
// operand (p1_points points) and the rows' (or K chunks of them); the
// rows' c1 and mu' and the points' z' as floats (p1_qdims of them); the
// rows' constants and weights and the ring of raw row stages (buckets); the
// dot's operands (the points' dPsi1Y chunk, the rows' Y chunk) and the
// float64 totals (p1_points x p1_point_ld).
__host__ __device__ constexpr size_t tc_p1_m_smem(int qm, int ld) {
  return (qm ? tc_operand_bytes(p1_points(qm), qm) + tc_operand_bytes(kTcRows, qm) +
                   2 * tc_stage_bytes(kTcRows, qm)
             : tc_chunk_operand_bytes(p1_points(qm)) + tc_chunk_operand_bytes(kTcRows)) +
         tc_region((size_t)(2 * kTcRows + p1_points(qm)) * p1_qdims(qm) * sizeof(float)) +
         2 * tc_region(kTcRows * sizeof(float)) +
         2 * tc_region((size_t)p1_points(qm) * kTcDChunk * sizeof(float)) +
         tc_b2_bytes(kTcDChunk) + tc_region((size_t)p1_points(qm) * ld * sizeof(double));
}

// The Psi1 point pass: per block of p1_points inducing points (grid x;
// 64-tiles of them on the tile's M axis, in p1_point_tiles rounds of one
// tile a warpgroup, a round that holds only padding skipped; their operand
// [z' | z'^2] built once), N-split (grid y) and pass of at most
// kP1PointChunks dimension chunks (grid z), the centred sums B_q = sum_n h
// c1 (mu' - z')_q. The split's rows are walked in tiles of 64 (the N axis),
// staged by cp.async one tile ahead; each tile's operand [c1 mu' | -c1/2]
// log2e, constants (with S1), transposed chunks [c1 mu' | c1] and Y chunk
// (read a tile ahead when D fits one chunk) are built once for both
// warpgroups, with the rows' c1 and mu' as floats. Each warpgroup forms the
// exponents and p = w exp2(L1 + S1) as in the forward, y . dPsi1Y as a
// second tensor-core product over D's chunks (its points' dPsi1Y chunk
// built once when D fits one chunk), h = p (y . dPsi1Y) in registers, and
// per dimension of the pass B = sum h c1 (mu' - z') over the tile pair by
// pair (each thread over its 16 rows, then warp shuffles), float32, added
// into float64 totals in shared memory. At the end B 2^-S1 goes into the
// split's float64 (Q, M) partial, every element written once. Past
// kTcP1BucketMax (QM = 0) K is walked in chunks as in the forward, and c1,
// mu' and z' are staged a dimension chunk at a time.
template <int QM>
__global__ void __launch_bounds__(kP1Threads)
psi1_bwd_m_tc_kernel(const float* __restrict__ mu, const float* __restrict__ s, Strides ls,
                     const float* __restrict__ y, Strides ys, const float* __restrict__ w,
                     const float* __restrict__ z, const float* __restrict__ alpha,
                     const float* __restrict__ sf2, const float* __restrict__ zeta,
                     const float* __restrict__ shift, const float* __restrict__ r1, int n, int m,
                     int q, int d, int rows_per_split, double* __restrict__ out) {
  constexpr int KP = QM ? tc_k(QM) : kTcKChunk;
  constexpr int PT = p1_point_tiles(QM), NF = p1_points(QM);
  extern __shared__ float4 smem4[];
  TcCarve cv(smem4);
  constexpr int QD = p1_qdims(QM);
  const TcOperand fix = tc_take_operand<KP>(cv, NF);
  const TcOperand walk = tc_take_operand<KP>(cv, kTcRows);
  float* s_cm = cv.take<float>((2 * kTcRows + NF) * QD * sizeof(float));  // c1, mu' [k][row]
  float* s_zp = s_cm + 2 * kTcRows * QD;                                   // z' [k][point]
  float* s_rc = cv.take<float>(kTcRows * sizeof(float));
  float* s_w = cv.take<float>(kTcRows * sizeof(float));
  const int stage = (int)(tc_stage_bytes(kTcRows, QM) / sizeof(float));
  float* ring = QM ? cv.take<float>(2 * tc_stage_bytes(kTcRows, QM)) : nullptr;
  const TcOperand da = tc_take_chunk(cv, NF, kTcDChunk);
  const TcOperand db = tc_take_chunk(cv, kTcRows, kTcDChunk);
  const int ld = p1_point_ld(q);
  double* tot = cv.take<double>((size_t)NF * ld * sizeof(double));
  const int wg = threadIdx.x / kTcWarpgroup;
  for (int i = threadIdx.x; i < NF * ld; i += blockDim.x) tot[i] = 0.0;
  __syncthreads();  // the carve's zeros are in

  const int nt = (q + kTcQChunk - 1) / kTcQChunk;
  const int c0 = blockIdx.z * kP1PointChunks, c1 = min(nt, c0 + kP1PointChunks);
  const int ny = (d + kTcDChunk - 1) / kTcDChunk;
  const bool one_d = ny == 1;
  const Strides rs{(size_t)d, 1};
  const int p0 = blockIdx.x * NF;
  if constexpr (QM > 0) tc_build_points<QM, KP>(z, zeta, m, q, p0, NF, fix, s_zp);
  TcDChunk<NF, kP1Threads> rl;
  if (one_d) {  // the points' dPsi1Y chunk, for every tile
    rl.load(r1, rs, p0, m, 0, d);
    rl.put(rs, &da, nullptr);
  }
  const float logsf2 = logf(*sf2), sh = *shift;
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(n, lo + rows_per_split);
  const int ntiles = hi > lo ? (hi - lo + kTcRows - 1) / kTcRows : 0;
  TcDChunk<kTcRows, kP1Threads> yl;
  if (ntiles > 0) {
    if constexpr (QM > 0) tc_stage_rows<QM, kTcRows>(mu, s, ls, w, q, lo, hi, ring);
    if (one_d) yl.load(y, ys, lo, hi, 0, d);
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
      tc_build_rows<QM, KP, kTcRows, true>(st, alpha, zeta, logsf2, sh, q, walk, s_rc, nullptr,
                                           s_cm);
      for (int r = threadIdx.x; r < kTcRows; r += blockDim.x) s_w[r] = st[2 * kTcRows * QM + r];
      if (one_d) yl.put(ys, &db, nullptr);
      tc_operands_ready();
      if (one_d && t + 1 < ntiles) yl.load(y, ys, n0 + kTcRows, hi, 0, d);
    } else {
      TcRowConst rc;
      TcRowChunk<kTcRows, kP1Threads, true> rows;
      TcPointChunk<NF, kP1Threads> pch;
      rows.load(mu, s, ls, alpha, zeta, q, n0, hi, 0);
      pch.load(z, zeta, m, q, p0, 0);
      for (int k0 = 0; k0 < q; k0 += kTcQChunk) {
        __syncthreads();  // the last chunk's products (and the last tile's readers) are done
        rows.put(q, n0, hi, k0, &walk, nullptr, &rc);
        pch.put(&fix, nullptr);
        if (k0 == 0 && one_d) yl.put(ys, &db, nullptr);
        if (k0 + kTcQChunk < q) {
          rows.load(mu, s, ls, alpha, zeta, q, n0, hi, k0 + kTcQChunk);
          pch.load(z, zeta, m, q, p0, k0 + kTcQChunk);
        }
        tc_operands_ready();
        tc_tile_chunk<KP>(fix.hi + wg * kTcRows * KP, fix.lo + wg * kTcRows * KP, walk.hi,
                          walk.lo, x, k0 == 0);
      }
      if (one_d && t + 1 < ntiles) yl.load(y, ys, n0 + kTcRows, hi, 0, d);
      tc_finish_rows<kTcRows, true>(rc, w, logsf2, sh, n0, hi, s_rc, s_w);
      __syncthreads();
    }
    for (int u = 0; u < PT; ++u) {  // round u: the warpgroups' tiles u kP1Wg + wg
      if (p0 + u * kP1Wg * kTcRows >= m) break;  // the round is padding alone (uniform)
      const int ft = (u * kP1Wg + wg) * kTcRows;
      if constexpr (QM > 0) tc_tile<KP>(fix.hi + ft * KP, fix.lo + ft * KP, walk.hi, walk.lo, x);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = tc_n(i);
        x[i] = s_w[r] * tc_exp2(x[i] + s_rc[r]);
      }
      float dot[32];
      for (int j = 0; j < ny; ++j) {
        if (!one_d) {
          yl.load(y, ys, n0, hi, j * kTcDChunk, d);
          rl.load(r1, rs, p0, m, j * kTcDChunk, d);
          __syncthreads();  // the last chunk's readers are done
          yl.put(ys, &db, nullptr);
          rl.put(rs, &da, nullptr);
          tc_operands_ready();
        }
        tc_tile_chunk<kTcDChunk>(da.hi + ft * kTcDChunk, da.lo + ft * kTcDChunk, db.hi, db.lo,
                                 dot, j == 0);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] *= dot[i];
      // per dimension of the pass, B = sum h c1 (mu' - z') over the tile's
      // rows, pair by pair in float32 (the expanded form S1 - z' S2 cancels
      // where |z'| >> |mu - z|)
      for (int c = c0; c < c1; ++c) {
        const int kb = c * kTcQChunk, ke = min(q, kb + kTcQChunk);
        if constexpr (QM == 0) {  // this chunk's c1, mu' of the rows and z' of the points
          TcRowChunk<kTcRows, kP1Threads, true> rows;
          TcPointChunk<NF, kP1Threads> pz;
          rows.load(mu, s, ls, alpha, zeta, q, n0, hi, kb);
          pz.load(z, zeta, m, q, p0, kb);
          __syncthreads();  // the last chunk's readers are done
          rows.put(q, n0, hi, kb, nullptr, nullptr, nullptr, s_cm);
          pz.put(nullptr, s_zp);
          __syncthreads();
        }
        for (int k = kb; k < ke; ++k) {
          const int kq = QM ? k : k - kb;
          const float* cq = s_cm + kq * kTcRows;
          const float* mq = s_cm + (QD + kq) * kTcRows;
          const float zA = s_zp[kq * NF + ft + tc_m(0)], zB = s_zp[kq * NF + ft + tc_m(2)];
          float bA = 0.f, bB = 0.f;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = tc_n(i);
            const float hc = x[i] * cq[r];
            if ((i >> 1) & 1)
              bB = fmaf(hc, mq[r] - zB, bB);
            else
              bA = fmaf(hc, mq[r] - zA, bA);
          }
#pragma unroll
          for (int o = 1; o <= 2; o <<= 1) {
            bA += __shfl_xor_sync(0xffffffffu, bA, o);
            bB += __shfl_xor_sync(0xffffffffu, bB, o);
          }
          if ((threadIdx.x & 3) == 0) {
            const int col = (c - c0) * kTcQChunk + (k - kb);
            tot[(ft + tc_m(0)) * ld + col] += (double)bA;
            tot[(ft + tc_m(2)) * ld + col] += (double)bB;
          }
        }
      }
    }
  }

  // out: (splits, Q, M), each (dimension, point) written by one thread
  __syncthreads();
  const double unshift = ldexp(1.0, -(int)sh);
  const int k0 = c0 * kTcQChunk, kw = min(q, c1 * kTcQChunk) - k0;
  for (int i = threadIdx.x; i < NF * kw; i += blockDim.x) {
    const int c = i % NF, k = k0 + i / NF;
    if (p0 + c >= m) continue;
    out[((size_t)blockIdx.y * q + k) * m + p0 + c] = tot[c * ld + (k - k0)] * unshift;
  }
}

// The Psi1 passes of one backward call: the row pass (and its finish when
// its points are split, splits_p > 1, into row_part), then the point pass.
template <int QM>
int launch_psi1_bwd_rows(const float* mu, const float* s, Strides ls, const float* y, Strides ys,
                         const float* w, const float* z, const float* alpha, const float* sf2,
                         const float* zeta, const float* shift1, const float* r1, int n, int m,
                         int q, int d, int splits_p, float* dmu, float* ds, float* dal, float* dy,
                         double* row_part, cudaStream_t stream) {
  const int ld = p1_row_ld(q, d);
  const size_t smem = tc_p1_rows_smem(QM, ld);
  cudaError_t err = allow_smem(psi1_bwd_rows_tc_kernel<QM>, smem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (m + kTcRows - 1) / kTcRows;
  dim3 grid((n + kP1Fixed - 1) / kP1Fixed, splits_p, p1_row_plan(q, d, -1, nullptr));
  psi1_bwd_rows_tc_kernel<QM><<<grid, kP1Threads, smem, stream>>>(
      mu, s, ls, y, ys, w, z, alpha, sf2, zeta, shift1, r1, n, m, q, d,
      (ntiles + splits_p - 1) / splits_p, ld, dmu, ds, dal, dy, splits_p > 1 ? row_part : nullptr);
  if ((err = cudaGetLastError()) != cudaSuccess || splits_p == 1) return (int)err;
  const size_t total = (size_t)n * (q > d ? q : d);
  const int blocks = (int)std::min<size_t>((total + 255) / 256, 4096);
  psi1_bwd_rows_finish_kernel<<<blocks, 256, 0, stream>>>(s, ls, ys, alpha, row_part, splits_p, n,
                                                          q, d, dmu, ds, dal, dy);
  return (int)cudaGetLastError();
}

template <int QM>
int launch_psi1_bwd_m(const float* mu, const float* s, Strides ls, const float* y, Strides ys,
                      const float* w, const float* z, const float* alpha, const float* sf2,
                      const float* zeta, const float* shift1, const float* r1, int n, int m,
                      int q, int d, int splits_m, double* b_part, cudaStream_t stream) {
  const size_t smem = tc_p1_m_smem(QM, p1_point_ld(q));
  cudaError_t err = allow_smem(psi1_bwd_m_tc_kernel<QM>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m + p1_points(QM) - 1) / p1_points(QM), splits_m, p1_point_passes(q));
  psi1_bwd_m_tc_kernel<QM><<<grid, kP1Threads, smem, stream>>>(
      mu, s, ls, y, ys, w, z, alpha, sf2, zeta, shift1, r1, n, m, q, d,
      (n + splits_m - 1) / splits_m, b_part);
  return (int)cudaGetLastError();
}

// The row passes, then the Psi1 point pass (Q <= 64). The cell sums come
// from the forward (psi2_fwd_tc_kernel<QM, true>): an a_part is refused.
template <int QM>
int launch_bwd(const float* mu, const float* s, const float* y,
               const float* w, const float* z, const float* alpha,
               const float* sf2, const float* zeta, const int* cells,
               const float* ce, const float* shift, const float* shift1,
               const float* kmat, const float* r1, int n, int m, int q, int d, int qn,
               int splits_c, int splits_m, int splits_p, float* dmu, float* ds, float* dal,
               float* dy, double* a_part, double* b_part, double* row_part,
               cudaStream_t stream) {
  if (a_part) return (int)cudaErrorInvalidValue;
  const Strides ls = strides_of(qn, n, q), ys = strides_of(qn, n, d);
  const size_t smem_r = tc_rows_smem(QM);
  cudaError_t err = allow_smem(psi2_bwd_rows_tc_kernel<QM>, smem_r);
  if (err != cudaSuccess) return (int)err;
  const int2* cells2 = reinterpret_cast<const int2*>(cells);
  constexpr int R = tc_row_rows(QM);
  psi2_bwd_rows_tc_kernel<QM><<<(n + R - 1) / R, tc_rows_threads(QM), smem_r, stream>>>(
      mu, s, ls, w, z, alpha, sf2, zeta, cells2, ce, shift, kmat, n, m, q, dmu, ds, dal);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  constexpr int P1 = p1_qm(QM);
  int rc = launch_psi1_bwd_rows<P1>(mu, s, ls, y, ys, w, z, alpha, sf2, zeta, shift1, r1, n, m,
                                    q, d, splits_p, dmu, ds, dal, dy, row_part, stream);
  if (rc != 0) return rc;

  return launch_psi1_bwd_m<P1>(mu, s, ls, y, ys, w, z, alpha, sf2, zeta, shift1, r1, n, m, q,
                               d, splits_m, b_part, stream);
}

// launch_bwd for Q > 64: the K-chunked tensor-core passes, the same grids
// and partials, and, with a_part (dZ wanted), the chunked cell pass.
inline int launch_bwd_chunked(const float* mu, const float* s, const float* y,
                              const float* w, const float* z,
                              const float* alpha, const float* sf2,
                              const float* zeta, const int* cells, const float* ce,
                              const float* shift, const float* shift1, const float* kmat,
                              const float* r1, int n, int m, int q, int d,
                              int qn, int splits_c, int splits_m, int splits_p, float* dmu,
                              float* ds, float* dal, float* dy,
                              double* a_part, double* b_part, double* row_part,
                              cudaStream_t stream) {
  const Strides ls = strides_of(qn, n, q), ys = strides_of(qn, n, d);
  const int2* cells2 = reinterpret_cast<const int2*>(cells);
  const int qp = tc_pass_dims(q);
  const size_t smem_tc = tc_bwd_chunked_smem(qp);
  cudaError_t err = allow_smem(psi2_bwd_rows_tc_chunked_kernel, smem_tc);
  if (err != cudaSuccess) return (int)err;
  psi2_bwd_rows_tc_chunked_kernel<<<(n + kTcRows - 1) / kTcRows, kTcChunkWg * kTcWarpgroup,
                                    smem_tc, stream>>>(
      mu, s, ls, w, z, alpha, sf2, zeta, cells2, ce, shift, kmat, n, m, q, qp, dmu, ds, dal);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int rc = launch_psi1_bwd_rows<0>(mu, s, ls, y, ys, w, z, alpha, sf2, zeta, shift1, r1, n, m, q,
                                   d, splits_p, dmu, ds, dal, dy, row_part, stream);
  if (rc != 0) return rc;

  if (a_part) {
    err = allow_smem(psi2_bwd_cells_tc_chunked_kernel, smem_tc);
    if (err != cudaSuccess) return (int)err;
    dim3 grid_c(tc_blocks(m, kTcRows), splits_c);
    psi2_bwd_cells_tc_chunked_kernel<<<grid_c, kTcChunkWg * kTcWarpgroup, smem_tc, stream>>>(
        mu, s, ls, w, z, alpha, sf2, zeta, cells2, ce, shift, n, m, q, qp,
        (n + splits_c - 1) / splits_c, a_part);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return launch_psi1_bwd_m<0>(mu, s, ls, y, ys, w, z, alpha, sf2, zeta, shift1, r1, n, m, q, d,
                              splits_m, b_part, stream);
}

}  // namespace gparml

// Launch plan of gparml_psi_bwd: plan = (splits_c: the N-splits of the
// chunked cell pass, 0 up to Q = 64, where there is none; splits_m, the largest
// dynamic shared memory of its blocks in bytes, the device's limit for it,
// splits_p: the inducing-point splits of the Psi1 row pass, above 1 only
// when its row blocks alone fill less than two waves of the card, i.e. at
// small N). Each grid's float64 partials take at most partial_bytes.
extern "C" int gparml_psi_bwd_plan(int n, int m, int q, int d, int num_sms,
                                   size_t partial_bytes, int* plan) {
  using namespace gparml;
  const int qm = qm_for(q), p1 = p1_qm(qm);
  const int ptiles = (m + kTcRows - 1) / kTcRows;
  const int pblocks = (m + p1_points(p1) - 1) / p1_points(p1);
  plan[0] = qm != 0 ? 0
                    : cap_splits(n_splits(n, tc_blocks(m, kTcRows), kRowsPsi2, kCellRowsMax,
                                          num_sms),
                                 (size_t)q * m * m * sizeof(double), partial_bytes);
  plan[1] = cap_splits(n_splits(n, pblocks * p1_point_passes(q), kTcRows, kCellRowsMax, num_sms),
                       (size_t)q * m * sizeof(double), partial_bytes);
  plan[2] = smem_bytes(std::max(
      {qm == 0 ? tc_bwd_chunked_smem(tc_pass_dims(q)) : tc_rows_smem(qm),
       tc_p1_rows_smem(p1, p1_row_ld(q, d)), tc_p1_m_smem(p1, p1_point_ld(q))}));
  const int row_blocks = (n + kP1Fixed - 1) / kP1Fixed * p1_row_plan(q, d, -1, nullptr);
  int splits_p = 1;
  if (row_blocks < 2 * num_sms) {
    const int want = std::min(ptiles, (2 * num_sms + row_blocks - 1) / row_blocks);
    const int per = (ptiles + want - 1) / want;
    splits_p = cap_splits((ptiles + per - 1) / per,
                          (size_t)n * (2 * q + 1 + d) * sizeof(double), partial_bytes);
  }
  plan[4] = splits_p;
  return (int)smem_limit(plan);
}

// zeta (Q), cells, ce, shift and shift1: as gparml_psi_fwd's; kmat: (M, M)
// = mult * sym(dPsi2) (upper triangle read); r1 = dPsi1Y: (M, D). qn = 0:
// mu, s, dmu, ds, dal (N, Q) and y, dy (N, D); qn = 1: (Q, N) and (D, N).
// Writes dmu, ds, dal, dy, the float64 b_part (splits_m, Q, M) and, past
// Q = 64 with a_part given (dZ wanted), the float64 a_part (splits_c, Q, M,
// M); up to Q = 64 a_part must be null (the forward forms A). row_part:
// with splits_p > 1, the Psi1 row pass's
// float64 per-split row partials (splits_p, N, 2 Q + 1 + D), every element
// written; unused with one split. Returns cudaGetLastError.
extern "C" int gparml_psi_bwd(const float* mu, const float* s, const float* y,
                              const float* w, const float* z,
                              const float* alpha, const float* sf2,
                              const float* zeta, const int* cells,
                              const float* ce, const float* shift, const float* shift1,
                              const float* kmat, const float* r1, int n, int m,
                              int q, int d, int qn, int splits_c, int splits_m, int splits_p,
                              float* dmu, float* ds, float* dal, float* dy,
                              double* a_part, double* b_part,
                              double* row_part, void* stream) {
  GPARML_QM_SWITCH(q, gparml::launch_bwd, gparml::launch_bwd_chunked, mu, s,
                   y, w, z, alpha, sf2, zeta, cells, ce, shift, shift1, kmat, r1, n, m, q, d, qn,
                   splits_c, splits_m, splits_p, dmu, ds, dal, dy, a_part, b_part,
                   row_part, static_cast<cudaStream_t>(stream));
}
