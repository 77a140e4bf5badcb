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
//        row's share of dalpha, -(s/den) G - u / den^2.
//      psi1_bwd_rows_kernel walks the inducing points (Z staged in pieces
//        of a fixed size, so at any M) with
//        h = w Psi1 (y_n . dPsi1Y_m), adds -c1 T, -c1 H/2 + c1^2 U/2 and
//        -(s/den1) H/2 - U/(2 den1^2) (T, U, H the h-sums as above), and
//        writes dY = sum_m w Psi1 dPsi1Y_m.
//  * column passes (reductions over n, one float64 partial per N-split):
//      psi2_bwd_cells_tc_kernel (Q <= 64), per block of packed cells:
//        A_q = sum_n w e c_nq (mu_nq - zb_q) with e = Psi2[n, m, m'], the
//        exponents and the sums on the tensor cores, each 64-row tile's
//        sums added into float64;//      psi1_bwd_m_kernel, per inducing point m:
//        B_q = sum_n h c1_nq (mu_nq - z_mq), at most kPsi1RowsMax rows a
//        split in one launch (the launcher runs the grid again for further
//        rows when the partials' memory budget lowers the split count).
//    Both sums are centred on the cell (the inducing point), so dZ never
//    forms them as differences of two large uncentred sums.
//    The wrapper sums the partials and assembles dZ, dalpha's cell share and
//    dsf2 with small tensor operations (gparml_tpu_torch/ops/psi_cuda.py).
//
// Past Q = 64 (any Q) the four passes have twins, which replace the TPU's
// `_bwd_kernel_stair` (:409) and `_bwd_kernel` (:249), launched by
// `_psi_fused_bwd` outside the flat window; the Q <= 64 kernels take the
// rest of those windows. The Psi2 passes, psi2_bwd_rows_tc_chunked_kernel
// and psi2_bwd_cells_tc_chunked_kernel, are the tensor-core passes with K
// walked in chunks of kTcQChunk latent dimensions (psi_tc.cuh), the
// reductions taken one dimension chunk at a time into float64 totals in
// shared memory. Every Psi2 pass, at any Q, adds an exact shift 2^S to its
// row constants that keeps exp2 clear of float32's subnormal range (the
// totals are scaled by 2^-S).
// The Psi1 passes (*_chunked) keep no Q-long vector in registers: each
// walks the latent dimensions in chunks of kQChunk twice, first to sum the
// exponents of a group (kGroup inducing points of one data row, or a
// staged chunk of rows of one inducing point, held in the thread's own
// column of shared memory) before expf, then for the per-dimension sums of
// that group, which it adds into float64: the row pass into a (2, Q, N)
// scratch of the row's totals t_q and u_q, the column pass into its
// partials.
//
// What bounds it on an H100: operations. The backward sweeps the
// N M (M + 1) / 2 (n, cell) pairs twice (rows, cells); the Psi2 passes
// form each tile's exponents and its reductions on the tensor cores and
// spend a pair's exp2 on the MUFU and a few float32 operations in the
// epilogue; the per-tile operand builds (the rows' in the cell pass, the
// cells' in the row pass) are shared by the block's warpgroups; past Q = 64
// both operands of a tile are rebuilt chunk by chunk (the dimensions twice:
// for the exponent and for the reductions), and the reductions' float64
// totals are read and written in shared memory once per tile. Device
// memory traffic is O(N (Q + D)): a row pass reads its rows once and every
// cell's Z and K per tile, a cell pass its cells once and the rows once per
// cell block (from L2: the grid's x axis, cells, varies fastest, so the
// blocks of one N-split read the same rows together).
#include "psi_tc.cuh"

namespace gparml {

// Threads of a row-pass block (the direct-form and chunked row passes).
constexpr int kRowThreads = 128;

// Rows of one block of psi2_bwd_rows_tc_kernel (64 a warpgroup), and its
// shared memory: the rows' operand, constants and weights, one cell tile's
// operand and terms, and one region that holds in turn the rows' raw
// stage, the cell tile's transposed operand [zb' | zb'^2 | 1] and, at the
// end, the rows' float64 sums (rows x tc_n2_rows).
__host__ __device__ constexpr int tc_row_rows(int qm) { return tc_wg(qm) * kTcRows; }
__host__ __device__ constexpr size_t tc_rows_union_bytes(int qm) {
  return std::max({tc_stage_bytes(tc_row_rows(qm), qm), tc_b2_bytes(tc_n2_rows(qm)),
                   tc_region((size_t)tc_row_rows(qm) * tc_n2_rows(qm) * sizeof(double))});
}
__host__ __device__ constexpr size_t tc_rows_smem(int qm) {
  return tc_operand_bytes(tc_row_rows(qm), qm) + 2 * tc_region(tc_row_rows(qm) * sizeof(float)) +
         tc_operand_bytes(kTcRows, qm) + tc_cellterm_bytes(kTcRows) + tc_rows_union_bytes(qm) +
         tc_scratch_bytes(tc_wg(qm));
}

// The Psi2 row pass (Q <= 64): a block owns 64 data rows a warpgroup (the
// rows' operand built once, the rows on the tile's M axis) and walks all
// packed cells in tiles of 64 (the N axis). Per tile it builds the cells'
// operand and its transpose [zb' | zb'^2 | 1] once for its warpgroups;
// each warpgroup forms its rows' exponents on the tensor cores
// (psi_tc.cuh), turns them in registers into g = K w exp2(L2) (K = mult *
// sym(dPsi2), 0 past the last cell), and multiplies that tile, still in
// registers, by the transpose on the tensor cores again (tc_reduce):
// T1_q = sum g zb'_q, T2_q = sum g zb'_q^2 and G = sum g over the tile's
// cells, which it adds to float64 registers (no float32 sum spans more than
// 64 cells; one over a row's 125 250 cells at M = 500 put dalpha 4e-5 off
// float64). At the end, in float64, t_q = sum g (zb' - mu')_q =
// T1 - mu' G and u_q = sum g (zb' - mu')_q^2 = T2 - 2 mu' T1 + mu'^2 G
// (centred on zeta, the expansion keeps float32's accuracy:
// ops/psi_tc_model.py, form "tc"), and thread (row, half of the latent
// dimensions) writes dmu = 2 c t, ds = -c G + 2 c^2 u and the row's share
// of dalpha, -(s/den) G - u/den^2.
template <int QM>
__global__ void __launch_bounds__(tc_wg(QM) * kTcWarpgroup)
psi2_bwd_rows_tc_kernel(const float* __restrict__ mu, const float* __restrict__ s, Strides ls,
                        const float* __restrict__ w, const float* __restrict__ z,
                        const float* __restrict__ alpha, const float* __restrict__ sf2,
                        const float* __restrict__ zeta, const int2* __restrict__ cells,
                        const float* __restrict__ ce, const float* __restrict__ shift,
                        const float* __restrict__ kmat, int n, int m, int q,
                        float* __restrict__ dmu, float* __restrict__ ds,
                        float* __restrict__ dal) {
  constexpr int KP = tc_k(QM), QS = QM / 2, R = tc_row_rows(QM), N2 = tc_n2_rows(QM);
  extern __shared__ float4 smem4[];
  TcCarve cv(smem4);
  const TcOperand rop = tc_take_operand<KP>(cv, R);
  float* s_rc = cv.take<float>(R * sizeof(float));
  float* s_w = cv.take<float>(R * sizeof(float));
  const TcOperand cop = tc_take_operand<KP>(cv, kTcRows);
  float* s_ce = cv.take<float>(kTcRows * sizeof(float));
  float* s_k = cv.take<float>(kTcRows * sizeof(float));
  int2* s_ij = cv.take<int2>(kTcRows * sizeof(int2));
  char* uni = cv.take<char>(tc_rows_union_bytes(QM));
  const int wg = threadIdx.x / kTcWarpgroup;
  float* scratch = cv.take<float>(tc_scratch_bytes(tc_wg(QM))) + wg * kTcRows * kTcTileLd;
  float* st = reinterpret_cast<float*>(uni);
  const size_t b2_half = tc_b2_bytes(N2) / 2;
  const TcOperand b2{reinterpret_cast<float*>(uni), reinterpret_cast<float*>(uni + b2_half)};
  double* s_tot = reinterpret_cast<double*>(uni);

  const int n0 = blockIdx.x * R;
  tc_stage_rows<QM, R>(mu, s, ls, w, q, n0, n, st);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const float sh = *shift;
  tc_build_rows<QM, KP, R>(st, alpha, zeta, logf(*sf2), sh, q, rop, s_rc, nullptr);
  for (int r = threadIdx.x; r < R; r += blockDim.x) s_w[r] = st[2 * R * QM + r];
  __syncthreads();  // the stage's room is the cells' transpose's from here

  const int rw = wg * kTcRows;  // the warpgroup's first row
  double tot[N2 / 2];
#pragma unroll
  for (int e = 0; e < N2 / 2; ++e) tot[e] = 0.0;
  const int ncell = tri_cells(m);
  for (int p0 = 0; p0 < ncell; p0 += kTcRows) {
    tc_build_cells<QM, KP, kTcRows>(z, zeta, cells, ce, kmat, m, q, p0, cop, s_ce, s_ij, &b2,
                                    s_k);
    tc_operands_ready();
    float d[32];
    tc_tile<KP>(rop.hi + rw * KP, rop.lo + rw * KP, cop.hi, cop.lo, d);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = rw + tc_m(i), c = tc_n(i);
      d[i] = s_k[c] * (s_w[rr] * tc_exp2(d[i] + s_rc[rr] + s_ce[c]));
    }
    float d2[N2 / 2];
    tc_reduce<N2>(d, b2.hi, b2.lo, d2, scratch);
#pragma unroll
    for (int e = 0; e < N2 / 2; ++e) tot[e] += d2[e];
    __syncthreads();
  }

  // the rows' sums through shared memory, then thread (row, half) writes
#pragma unroll
  for (int e = 0; e < N2 / 2; ++e) s_tot[(rw + tc_m(e)) * N2 + tc_n(e)] = tot[e];
  __syncthreads();
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

constexpr int kDChunk = 16;

// The Psi1 row pass (Q <= 64): a thread per data row walks the inducing
// points with h = w Psi1 (y_n . dPsi1Y_m) and adds the row's shares (see
// the file's head). Z is staged in pieces of mp inducing points (mp x QM
// floats, the plan's kZPieceBytes at most), so M has no limit: every thread
// of the block, a row or not, reaches each piece's barriers. The row's
// sums tt, uu and hsum run on across the pieces in registers, in the order
// of one whole stage, and dY's partial sums over a D chunk leave the
// registers between pieces through dY itself (a float32 stored and loaded
// back unchanged): a piece changes no sum, only where it is kept.
template <int QM>
__global__ void __launch_bounds__(128)
psi1_bwd_rows_kernel(const float* __restrict__ mu, const float* __restrict__ s,
                     Strides ls, const float* __restrict__ y, Strides ys,
                     const float* __restrict__ w,
                     const float* __restrict__ z,
                     const float* __restrict__ alpha,
                     const float* __restrict__ sf2,
                     const float* __restrict__ r1, int n, int m, int q, int d, int mp,
                     float* __restrict__ dmu, float* __restrict__ ds,
                     float* __restrict__ dal, float* __restrict__ dy) {
  extern __shared__ float4 smem4[];
  float* zs = reinterpret_cast<float*>(smem4);
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = row < n;

  float mv[QM], c[QM], tt[QM], uu[QM];
  float lsum = 0.f;
#pragma unroll
  for (int k = 0; k < QM; ++k) {
    mv[k] = 0.f;
    c[k] = 0.f;
    tt[k] = 0.f;
    uu[k] = 0.f;
    if (live && k < q) {
      const float a = alpha[k];
      const float den = a * s[ls.at(row, k)] + 1.f;
      mv[k] = mu[ls.at(row, k)];
      c[k] = a / den;
      lsum += logf(den);
    }
  }
  const float l1 = logf(*sf2) - 0.5f * lsum;
  const float wn = live ? w[row] : 0.f;
  float hsum = 0.f;

  for (int m0 = 0; m0 < m; m0 += mp) {
    const int np = min(mp, m - m0);
    __syncthreads();  // the previous piece is read
    stage_z<QM>(z + (size_t)m0 * q, np, q, zs);
    __syncthreads();
    if (!live) continue;
    // h is linear in y_n . dPsi1Y_m, so D is walked in chunks of kDChunk
    // (Psi1 is recomputed per chunk only when D > kDChunk).
    for (int d0 = 0; d0 < d; d0 += kDChunk) {
      float yv[kDChunk], gy[kDChunk];
#pragma unroll
      for (int j = 0; j < kDChunk; ++j) {
        yv[j] = d0 + j < d ? y[ys.at(row, d0 + j)] : 0.f;
        gy[j] = m0 > 0 && d0 + j < d ? dy[ys.at(row, d0 + j)] : 0.f;
      }
      for (int mi = 0; mi < np; ++mi) {
        const float2* zm = reinterpret_cast<const float2*>(zs + mi * QM);
        float dd[QM];
        float qd = 0.f;
#pragma unroll
        for (int k2 = 0; k2 < QM / 2; ++k2) {
          const float2 v = zm[k2];
          dd[2 * k2] = mv[2 * k2] - v.x;
          dd[2 * k2 + 1] = mv[2 * k2 + 1] - v.y;
          qd = fmaf(c[2 * k2] * dd[2 * k2], dd[2 * k2], qd);
          qd = fmaf(c[2 * k2 + 1] * dd[2 * k2 + 1], dd[2 * k2 + 1], qd);
        }
        const float p = wn * expf(l1 - 0.5f * qd);
        const float* rr = r1 + (size_t)(m0 + mi) * d + d0;
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < kDChunk; ++j) {
          if (d0 + j < d) {
            const float rv = __ldg(rr + j);
            dot = fmaf(yv[j], rv, dot);
            gy[j] = fmaf(p, rv, gy[j]);
          }
        }
        const float h = p * dot;
        hsum += h;
#pragma unroll
        for (int k = 0; k < QM; ++k) {
          const float hd = h * dd[k];
          tt[k] += hd;
          uu[k] = fmaf(hd, dd[k], uu[k]);
        }
      }
#pragma unroll
      for (int j = 0; j < kDChunk; ++j)
        if (d0 + j < d) dy[ys.at(row, d0 + j)] = gy[j];
    }
  }
  if (!live) return;

  for (int k = 0; k < q; ++k) {
    const size_t i = ls.at(row, k);
    const float den = alpha[k] * s[i] + 1.f;
    dmu[i] += -c[k] * tt[k];
    ds[i] += -0.5f * c[k] * hsum + 0.5f * c[k] * c[k] * uu[k];
    dal[i] += -0.5f * (s[i] / den) * hsum - 0.5f * uu[k] / (den * den);
  }
}

// Cells of one block of psi2_bwd_cells_tc_kernel, and its shared memory:
// the cells' operand and terms (the operand's room holds the cells' float64
// sums at the end), the rows' operand and constants, the ring of raw row
// stages, and the rows' transposed operand [c mu' | c].
__host__ __device__ constexpr int tc_cell_cells(int qm) { return tc_wg(qm) * kTcRows; }
__host__ __device__ constexpr size_t tc_cells_smem(int qm) {
  return tc_operand_bytes(tc_cell_cells(qm), qm) + tc_cellterm_bytes(tc_cell_cells(qm)) +
         tc_operand_bytes(kTcRows, qm) + tc_region(kTcRows * sizeof(float)) +
         tc_stages(qm) * tc_stage_bytes(kTcRows, qm) + tc_b2_bytes(tc_n2_cells(qm)) +
         tc_scratch_bytes(tc_wg(qm));
}

// The Psi2 cell pass (Q <= 64): per block of packed cells (grid x: tc_wg
// warpgroups with a tile of 64 cells each, on the tile's M axis)
// and N-split (grid y), A_q = sum_n w e c_nq (mu'_nq - zb'_q) with
// e = Psi2[n, cell], centred on the cell. The rows are walked as in
// psi2_fwd_tc_kernel (cp.async ring, the row operand built once a row tile
// for all the block's cell tiles, exponents on the tensor cores), with the
// rows' transposed operand [c mu' | c] beside it. Each warpgroup turns a
// tile's exponents in registers into ev = w exp2(L2) (0 past the last
// cell) and multiplies that tile by the transpose on the tensor cores
// (tc_reduce): S1_q = sum ev c mu'_q and S2_q = sum ev c_q over the tile's
// 64 rows, added to float64 registers. At the end, in float64, the centred
// A_q = S1_q - zb'_q S2_q (ops/psi_tc_model.py, form "tc"); each split
// writes its cells' A into its float64 (Q, M, M) partial, both triangles.
// Up to Q = 16, two resident blocks per SM (128 registers a thread).
template <int QM>
__global__ void __launch_bounds__(tc_wg(QM) * kTcWarpgroup, QM <= 16 ? 2 : 1)
psi2_bwd_cells_tc_kernel(const float* __restrict__ mu, const float* __restrict__ s, Strides ls,
                         const float* __restrict__ w, const float* __restrict__ z,
                         const float* __restrict__ alpha, const float* __restrict__ sf2,
                         const float* __restrict__ zeta, const int2* __restrict__ cells,
                         const float* __restrict__ ce, const float* __restrict__ shift, int n,
                         int m, int q, int rows_per_split, double* __restrict__ out) {
  constexpr int KP = tc_k(QM), S = tc_stages(QM), QS = QM / 2;
  constexpr int N2 = tc_n2_cells(QM), NC = tc_cell_cells(QM);
  extern __shared__ float4 smem4[];
  TcCarve cv(smem4);
  const TcOperand cop = tc_take_operand<KP>(cv, NC);
  double* s_tot = reinterpret_cast<double*>(cop.hi);  // at the end: NC x N2 (N2 == KP)
  float* s_ce = cv.take<float>(NC * sizeof(float));
  cv.take<float>(NC * sizeof(float));  // (kmat entries: the row pass's)
  int2* s_ij = cv.take<int2>(NC * sizeof(int2));
  const TcOperand rop = tc_take_operand<KP>(cv, kTcRows);
  float* s_rc = cv.take<float>(kTcRows * sizeof(float));
  const int stage = (int)(tc_stage_bytes(kTcRows, QM) / sizeof(float));
  float* ring = cv.take<float>(S * tc_stage_bytes(kTcRows, QM));
  const TcOperand b2 = tc_take_operand<kTcRows>(cv, N2);
  const int wg = threadIdx.x / kTcWarpgroup;
  float* scratch = cv.take<float>(tc_scratch_bytes(tc_wg(QM))) + wg * kTcRows * kTcTileLd;
  __syncthreads();

  const int p0 = blockIdx.x * NC;
  tc_build_cells<QM, KP, NC>(z, zeta, cells, ce, nullptr, m, q, p0, cop, s_ce, s_ij, nullptr,
                             nullptr);
  const int tile = wg * kTcRows;  // the warpgroup's cells
  double tot[N2 / 2];
#pragma unroll
  for (int e = 0; e < N2 / 2; ++e) tot[e] = 0.0;

  const float logsf2 = logf(*sf2), sh = *shift;
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(n, lo + rows_per_split);
  const int ntiles = hi > lo ? (hi - lo + kTcRows - 1) / kTcRows : 0;
  if (S == 2 && ntiles > 0) tc_stage_rows<QM, kTcRows>(mu, s, ls, w, q, lo, hi, ring);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    const float* st = ring + (t % S) * stage;
    if (S == 2) {
      if (t + 1 < ntiles)
        tc_stage_rows<QM, kTcRows>(mu, s, ls, w, q, lo + (t + 1) * kTcRows, hi,
                                   ring + ((t + 1) % S) * stage);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      tc_stage_rows<QM, kTcRows>(mu, s, ls, w, q, lo + t * kTcRows, hi, ring);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    tc_build_rows<QM, KP, kTcRows>(st, alpha, zeta, logsf2, sh, q, rop, s_rc, &b2);
    tc_operands_ready();
    const float* st_w = st + 2 * kTcRows * QM;
    float d[32];
    tc_tile<KP>(cop.hi + tile * KP, cop.lo + tile * KP, rop.hi, rop.lo, d);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = tc_m(i), r = tc_n(i);
      d[i] = s_ij[tile + c].x >= 0 ? st_w[r] * tc_exp2(d[i] + s_ce[tile + c] + s_rc[r]) : 0.f;
    }
    float d2[N2 / 2];
    tc_reduce<N2>(d, b2.hi, b2.lo, d2, scratch);
#pragma unroll
    for (int e = 0; e < N2 / 2; ++e) tot[e] += d2[e];
    __syncthreads();
  }

  // the cells' sums through shared memory (the cells' operand is done with)
#pragma unroll
  for (int e = 0; e < N2 / 2; ++e) s_tot[(tile + tc_m(e)) * N2 + tc_n(e)] = tot[e];
  __syncthreads();
  // out: (splits, q, M, M), each (cell, dimension) written by one thread
  const size_t mm = (size_t)m * m;
  double* o = out + (size_t)blockIdx.y * q * mm;
  const double unshift = ldexp(1.0, -(int)sh);
  for (int idx = threadIdx.x; idx < 2 * NC; idx += blockDim.x) {
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

template <int QM>
__global__ void __launch_bounds__(128)
psi1_bwd_m_kernel(const float* __restrict__ mu, const float* __restrict__ s,
                  Strides ls, const float* __restrict__ y, Strides ys,
                  const float* __restrict__ w,
                  const float* __restrict__ z, const float* __restrict__ alpha,
                  const float* __restrict__ sf2,
                  const float* __restrict__ r1, int n_begin, int n, int m,
                  int q, int d, int rows_per_split, double* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float2* s_mc = reinterpret_cast<float2*>(smem4);
  float2* s_lw = s_mc + kRowsPsi1 * QM;
  float* s_y = reinterpret_cast<float*>(s_lw + kRowsPsi1);

  const int mi = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = mi < m;
  float zm[QM];
#pragma unroll
  for (int k = 0; k < QM; ++k)
    zm[k] = (active && k < q) ? z[(size_t)mi * q + k] : 0.f;
  const float* rm = r1 + (size_t)(active ? mi : 0) * d;

  float acc[QM];
#pragma unroll
  for (int k = 0; k < QM; ++k) acc[k] = 0.f;

  const float logsf2 = logf(*sf2);
  const int lo = n_begin + blockIdx.x * rows_per_split;
  const int hi = min(n, lo + rows_per_split);
  for (int n0 = lo; n0 < hi; n0 += kRowsPsi1) {
    __syncthreads();
    stage_rows<QM, kRowsPsi1>(mu, s, ls, w, alpha, logsf2, 1.f, 1.f, q, n0,
                              hi, s_mc, s_lw);
    stage_y<kRowsPsi1>(y, ys, d, n0, hi, s_y);
    __syncthreads();
    // y_n . dPsi1Y_m first, so one register array of kRowsPsi1 is live
    // (a second one for w Psi1 spilled at Q=10).
    float dot[kRowsPsi1];
#pragma unroll
    for (int r = 0; r < kRowsPsi1; ++r) dot[r] = 0.f;
    for (int k = 0; k < d; ++k) {
      const float rv = __ldg(rm + k);
#pragma unroll
      for (int r = 0; r < kRowsPsi1; ++r) dot[r] = fmaf(s_y[r * d + k], rv, dot[r]);
    }
#pragma unroll
    for (int r = 0; r < kRowsPsi1; ++r) {
      const float2 lw = s_lw[r];
      const float4* mc = reinterpret_cast<const float4*>(s_mc + r * QM);
      float qd = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < QM / 2; ++k2) {
        const float4 v = mc[k2];
        const float t0 = v.x - zm[2 * k2];
        const float t1 = v.z - zm[2 * k2 + 1];
        qd = fmaf(v.y * t0, t0, qd);
        qd = fmaf(v.w * t1, t1, qd);
      }
      const float hr = lw.y * expf(lw.x - 0.5f * qd) * dot[r];
#pragma unroll
      for (int k2 = 0; k2 < QM / 2; ++k2) {
        const float4 v = mc[k2];
        acc[2 * k2] = fmaf(hr * v.y, v.x - zm[2 * k2], acc[2 * k2]);
        acc[2 * k2 + 1] =
            fmaf(hr * v.w, v.z - zm[2 * k2 + 1], acc[2 * k2 + 1]);
      }
    }
  }

  if (active) {
    // out: (splits, q, M) float64: the grid's first launch writes it, a
    // further one adds to it
    double* o = out + (size_t)blockIdx.x * q * m + mi;
#pragma unroll
    for (int k = 0; k < QM; ++k) {
      if (k < q) o[(size_t)k * m] = n_begin == 0 ? acc[k] : o[(size_t)k * m] + acc[k];
    }
  }
}

// The most rows of one N-split of a cell pass.
constexpr int kCellRowsMax = 262144;

// Shared memory of the chunked Psi1 row pass: a group's inducing points of
// one chunk, and each thread's exponents of that group in its own column
// (s_h[c * kRowThreads + threadIdx.x]).
constexpr size_t kRowGroupSmem = (size_t)kGroup * (kQChunk + kRowThreads) * sizeof(float);

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

// psi1_bwd_rows_kernel for any Q: the inducing points in groups of kGroup,
// each walked over the dimension chunks of kQChunk twice, first to sum
// each point's exponent (in the thread's own column of shared memory)
// before expf, then for the per-dimension sums t_q, u_q of the group, which
// it adds into the row's float64 totals tu[0][q][n], tu[1][q][n] (the
// caller zero-fills them).
__global__ void __launch_bounds__(kRowThreads)
psi1_bwd_rows_chunked_kernel(const float* __restrict__ mu,
                             const float* __restrict__ s, Strides ls,
                             const float* __restrict__ y, Strides ys,
                             const float* __restrict__ w,
                             const float* __restrict__ z,
                             const float* __restrict__ alpha,
                             const float* __restrict__ sf2,
                             const float* __restrict__ r1, int n, int m,
                             int q, int d, float* __restrict__ dmu,
                             float* __restrict__ ds, float* __restrict__ dal,
                             float* __restrict__ dy,
                             double* __restrict__ tu) {
  extern __shared__ float4 smem4[];
  float* s_z = reinterpret_cast<float*>(smem4);
  float* s_h = s_z + kGroup * kQChunk + threadIdx.x;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = row < n;

  double lsum = 0.0;  // over Q, in double as stage_lw's sums
  if (live)
    for (int k = 0; k < q; ++k) lsum += logf(alpha[k] * s[ls.at(row, k)] + 1.f);
  const float l1 = logf(*sf2) - 0.5f * (float)lsum;
  const float wn = live ? w[row] : 0.f;
  double* tt = tu + row;
  double* uu = tu + (size_t)q * n + row;
  float hsum = 0.f;

  // h is linear in y_n . dPsi1Y_m, so D is walked in chunks of kDChunk as
  // in psi1_bwd_rows_kernel.
  for (int d0 = 0; d0 < d; d0 += kDChunk) {
    float yv[kDChunk], gy[kDChunk];
#pragma unroll
    for (int j = 0; j < kDChunk; ++j) {
      yv[j] = live && d0 + j < d ? y[ys.at(row, d0 + j)] : 0.f;
      gy[j] = 0.f;
    }
    for (int m0 = 0; m0 < m; m0 += kGroup) {
      const int nc = min(kGroup, m - m0);
      for (int k0 = 0; k0 < q; k0 += kQChunk) {
        __syncthreads();
        stage_group(z, m, q, m0, k0, s_z);
        __syncthreads();
        float mv[kQChunk], cc[kQChunk];
        load_row_chunk(mu, s, ls, alpha, 1.f, q, row, live, k0, mv, cc);
#pragma unroll 2
        for (int c = 0; c < nc; ++c) {
          const float4* zc = reinterpret_cast<const float4*>(s_z + c * kQChunk);
          float qd = k0 == 0 ? 0.f : s_h[c * kRowThreads];
#pragma unroll
          for (int k4 = 0; k4 < kQChunk / 4; ++k4) {
            const float4 v = zc[k4];
            const float e0_ = mv[4 * k4] - v.x, e1 = mv[4 * k4 + 1] - v.y;
            const float e2 = mv[4 * k4 + 2] - v.z, e3 = mv[4 * k4 + 3] - v.w;
            qd = fmaf(cc[4 * k4] * e0_, e0_, qd);
            qd = fmaf(cc[4 * k4 + 1] * e1, e1, qd);
            qd = fmaf(cc[4 * k4 + 2] * e2, e2, qd);
            qd = fmaf(cc[4 * k4 + 3] * e3, e3, qd);
          }
          s_h[c * kRowThreads] = qd;
        }
      }
      for (int c = 0; c < nc; ++c) {
        const float p = wn * expf(l1 - 0.5f * s_h[c * kRowThreads]);
        const float* rr = r1 + (size_t)(m0 + c) * d + d0;
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < kDChunk; ++j) {
          if (d0 + j < d) {
            const float rv = __ldg(rr + j);
            dot = fmaf(yv[j], rv, dot);
            gy[j] = fmaf(p, rv, gy[j]);
          }
        }
        const float h = p * dot;
        s_h[c * kRowThreads] = h;
        hsum += h;
      }
      for (int k0 = 0; k0 < q; k0 += kQChunk) {
        __syncthreads();
        stage_group(z, m, q, m0, k0, s_z);
        __syncthreads();
        float mv[kQChunk], cc[kQChunk], tp[kQChunk], up[kQChunk];
        load_row_chunk(mu, s, ls, alpha, 1.f, q, row, live, k0, mv, cc);
#pragma unroll
        for (int k = 0; k < kQChunk; ++k) {
          tp[k] = 0.f;
          up[k] = 0.f;
        }
#pragma unroll 2
        for (int c = 0; c < nc; ++c) {
          const float4* zc = reinterpret_cast<const float4*>(s_z + c * kQChunk);
          const float h = s_h[c * kRowThreads];
#pragma unroll
          for (int k4 = 0; k4 < kQChunk / 4; ++k4) {
            const float4 v = zc[k4];
            const float dv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int k = 4 * k4 + j;
              const float dd = mv[k] - dv[j];
              const float hd = h * dd;
              tp[k] += hd;
              up[k] = fmaf(hd, dd, up[k]);
            }
          }
        }
        if (live) {
#pragma unroll
          for (int k = 0; k < kQChunk; ++k) {
            if (k0 + k < q) {
              tt[(size_t)(k0 + k) * n] += tp[k];
              uu[(size_t)(k0 + k) * n] += up[k];
            }
          }
        }
      }
    }
    if (live) {
#pragma unroll
      for (int j = 0; j < kDChunk; ++j)
        if (d0 + j < d) dy[ys.at(row, d0 + j)] = gy[j];
    }
  }

  if (!live) return;
  for (int k = 0; k < q; ++k) {
    const size_t i = ls.at(row, k);
    const float a = alpha[k];
    const float den = a * s[i] + 1.f;
    const float c = a / den;
    const float t = (float)tt[(size_t)k * n], u = (float)uu[(size_t)k * n];
    dmu[i] += -c * t;
    ds[i] += -0.5f * c * hsum + 0.5f * c * c * u;
    dal[i] += -0.5f * (s[i] / den) * hsum - 0.5f * u / (den * den);
  }
}

// psi2_bwd_cells_tc_kernel for any Q > 64, with K in chunks: per block of
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

// Shared memory of the chunked inducing-point pass with D columns of Y:
// a staged chunk of kRowsPsi1 rows and Y rows, and each thread's h of
// those rows in its own column.
constexpr size_t psi1_m_chunk_smem(int d) {
  return smem_rows_chunk(kRowsPsi1, d) + (size_t)kRowsPsi1 * 128 * sizeof(float);
}

// psi1_bwd_m_kernel for any Q: per staged chunk of kRowsPsi1 rows the
// exponents are summed over the dimension chunks (in the thread's column of
// shared memory), then the chunks are walked again and each chunk's
// centred sums B_q over those rows are added into the split's float64
// partial.
__global__ void __launch_bounds__(128)
psi1_bwd_m_chunked_kernel(const float* __restrict__ mu,
                          const float* __restrict__ s, Strides ls,
                          const float* __restrict__ y, Strides ys,
                          const float* __restrict__ w,
                          const float* __restrict__ z,
                          const float* __restrict__ alpha,
                          const float* __restrict__ sf2,
                          const float* __restrict__ r1, int n_begin, int n,
                          int m, int q, int d, int rows_per_split,
                          double* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float2* s_mc = reinterpret_cast<float2*>(smem4);
  float2* s_lw = s_mc + kRowsPsi1 * kQChunk;
  float* s_y = reinterpret_cast<float*>(s_lw + kRowsPsi1);
  float* s_hr = s_y + kRowsPsi1 * d + threadIdx.x;

  const int mi = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = mi < m;
  const float* zm = z + (size_t)(active ? mi : 0) * q;
  const float* rm = r1 + (size_t)(active ? mi : 0) * d;
  // out: (splits, q, M) float64: the grid's first launch zeroes it
  double* o = out + (size_t)blockIdx.x * q * m + (active ? mi : 0);
  if (active && n_begin == 0)
    for (int k = 0; k < q; ++k) o[(size_t)k * m] = 0.0;

  const float logsf2 = logf(*sf2);
  const int lo = n_begin + blockIdx.x * rows_per_split;
  const int hi = min(n, lo + rows_per_split);
  for (int n0 = lo; n0 < hi; n0 += kRowsPsi1) {
    const int nr = min(kRowsPsi1, hi - n0);
    for (int k0 = 0; k0 < q; k0 += kQChunk) {
      __syncthreads();
      stage_rows_chunk<kRowsPsi1>(mu, s, ls, alpha, 1.f, q, k0, n0, hi, s_mc);
      if (k0 == 0) {
        stage_lw<kRowsPsi1, double>(s, ls, w, alpha, logsf2, 1.f, 1.f, q, n0, hi, s_lw);
        stage_y<kRowsPsi1>(y, ys, d, n0, hi, s_y);
      }
      float zc[kQChunk];
#pragma unroll
      for (int k = 0; k < kQChunk; ++k) zc[k] = k0 + k < q ? zm[k0 + k] : 0.f;
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < nr; ++r) {
        const float4* mc = reinterpret_cast<const float4*>(s_mc + r * kQChunk);
        float qd = k0 == 0 ? 0.f : s_hr[r * 128];
#pragma unroll
        for (int k2 = 0; k2 < kQChunk / 2; ++k2) {
          const float4 v = mc[k2];
          const float t0 = v.x - zc[2 * k2];
          const float t1 = v.z - zc[2 * k2 + 1];
          qd = fmaf(v.y * t0, t0, qd);
          qd = fmaf(v.w * t1, t1, qd);
        }
        s_hr[r * 128] = qd;
      }
    }
    // y_n . dPsi1Y_m, one load of dPsi1Y_m's entry for all the rows
    float dot[kRowsPsi1];
#pragma unroll
    for (int r = 0; r < kRowsPsi1; ++r) dot[r] = 0.f;
    for (int k = 0; k < d; ++k) {
      const float rv = __ldg(rm + k);
#pragma unroll
      for (int r = 0; r < kRowsPsi1; ++r) dot[r] = fmaf(s_y[r * d + k], rv, dot[r]);
    }
#pragma unroll
    for (int r = 0; r < kRowsPsi1; ++r) {
      if (r < nr) {
        const float2 lw = s_lw[r];
        s_hr[r * 128] = lw.y * expf(lw.x - 0.5f * s_hr[r * 128]) * dot[r];
      }
    }
    for (int k0 = 0; k0 < q; k0 += kQChunk) {
      __syncthreads();
      stage_rows_chunk<kRowsPsi1>(mu, s, ls, alpha, 1.f, q, k0, n0, hi, s_mc);
      float zc[kQChunk], acc[kQChunk];
#pragma unroll
      for (int k = 0; k < kQChunk; ++k) {
        zc[k] = k0 + k < q ? zm[k0 + k] : 0.f;
        acc[k] = 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < nr; ++r) {
        const float4* mc = reinterpret_cast<const float4*>(s_mc + r * kQChunk);
        const float hr = s_hr[r * 128];
#pragma unroll
        for (int k2 = 0; k2 < kQChunk / 2; ++k2) {
          const float4 v = mc[k2];
          acc[2 * k2] = fmaf(hr * v.y, v.x - zc[2 * k2], acc[2 * k2]);
          acc[2 * k2 + 1] = fmaf(hr * v.w, v.z - zc[2 * k2 + 1], acc[2 * k2 + 1]);
        }
      }
      if (active) {
#pragma unroll
        for (int k = 0; k < kQChunk; ++k)
          if (k0 + k < q) o[(size_t)(k0 + k) * m] += acc[k];
      }
    }
  }
}

template <int QM>
int launch_bwd(const float* mu, const float* s, const float* y,
               const float* w, const float* z, const float* alpha,
               const float* sf2, const float* zeta, const int* cells,
               const float* ce, const float* shift,
               const float* kmat, const float* r1, int n, int m, int q, int d, int qn,
               int splits_c, int splits_m, float* dmu, float* ds, float* dal,
               float* dy, double* a_part, double* b_part,
               double* /* row scratch: the chunked kernels' only */,
               cudaStream_t stream) {
  const Strides ls = strides_of(qn, n, q), ys = strides_of(qn, n, d);
  const size_t smem_r = tc_rows_smem(QM);
  cudaError_t err = allow_smem(psi2_bwd_rows_tc_kernel<QM>, smem_r);
  if (err != cudaSuccess) return (int)err;
  const int2* cells2 = reinterpret_cast<const int2*>(cells);
  constexpr int R = tc_row_rows(QM);
  psi2_bwd_rows_tc_kernel<QM><<<(n + R - 1) / R, tc_wg(QM) * kTcWarpgroup, smem_r, stream>>>(
      mu, s, ls, w, z, alpha, sf2, zeta, cells2, ce, shift, kmat, n, m, q, dmu, ds, dal);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int mp = z_piece(m, QM);
  const size_t smem_zm = smem_z(mp, QM);
  const int nblk = (n + kRowThreads - 1) / kRowThreads;
  err = allow_smem(psi1_bwd_rows_kernel<QM>, smem_zm);
  if (err != cudaSuccess) return (int)err;
  psi1_bwd_rows_kernel<QM><<<nblk, kRowThreads, smem_zm, stream>>>(
      mu, s, ls, y, ys, w, z, alpha, sf2, r1, n, m, q, d, mp, dmu, ds, dal, dy);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem_c = tc_cells_smem(QM);
  err = allow_smem(psi2_bwd_cells_tc_kernel<QM>, smem_c);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_c(tc_blocks(m, tc_cell_cells(QM)), splits_c);
  psi2_bwd_cells_tc_kernel<QM><<<grid_c, tc_wg(QM) * kTcWarpgroup, smem_c, stream>>>(
      mu, s, ls, w, z, alpha, sf2, zeta, cells2, ce, shift, n, m, q,
      (n + splits_c - 1) / splits_c, a_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem_m = smem_rows_psi1(QM, d);
  err = allow_smem(psi1_bwd_m_kernel<QM>, smem_m);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_m(splits_m, (m + 127) / 128);
  const int rows_m = std::min((n + splits_m - 1) / splits_m, kPsi1RowsMax);
  // One launch unless the partials' budget lowered splits_m below
  // n / kPsi1RowsMax: each further launch adds the next rows_m rows a split.
  for (int n0 = 0; n0 < n; n0 += splits_m * rows_m) {
    psi1_bwd_m_kernel<QM><<<grid_m, 128, smem_m, stream>>>(
        mu, s, ls, y, ys, w, z, alpha, sf2, r1, n0, n, m, q, d, rows_m,
        b_part);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// launch_bwd for Q > 64: the K-chunked tensor-core Psi2 passes and the
// chunked Psi1 passes, the same grids and partials, and the float64 totals
// tu (2, Q, N) of psi1_bwd_rows_chunked_kernel, zero-filled by the caller.
inline int launch_bwd_chunked(const float* mu, const float* s, const float* y,
                              const float* w, const float* z,
                              const float* alpha, const float* sf2,
                              const float* zeta, const int* cells, const float* ce,
                              const float* shift, const float* kmat,
                              const float* r1, int n, int m, int q, int d,
                              int qn, int splits_c, int splits_m, float* dmu,
                              float* ds, float* dal, float* dy,
                              double* a_part, double* b_part, double* tu,
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
  const int nblk = (n + kRowThreads - 1) / kRowThreads;
  psi1_bwd_rows_chunked_kernel<<<nblk, kRowThreads, kRowGroupSmem, stream>>>(
      mu, s, ls, y, ys, w, z, alpha, sf2, r1, n, m, q, d, dmu, ds, dal, dy, tu);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  err = allow_smem(psi2_bwd_cells_tc_chunked_kernel, smem_tc);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_c(tc_blocks(m, kTcRows), splits_c);
  psi2_bwd_cells_tc_chunked_kernel<<<grid_c, kTcChunkWg * kTcWarpgroup, smem_tc, stream>>>(
      mu, s, ls, w, z, alpha, sf2, zeta, cells2, ce, shift, n, m, q, qp,
      (n + splits_c - 1) / splits_c, a_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem_m = psi1_m_chunk_smem(d);
  err = allow_smem(psi1_bwd_m_chunked_kernel, smem_m);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_m(splits_m, (m + 127) / 128);
  const int rows_m = std::min((n + splits_m - 1) / splits_m, kPsi1RowsMax);
  for (int n0 = 0; n0 < n; n0 += splits_m * rows_m) {
    psi1_bwd_m_chunked_kernel<<<grid_m, 128, smem_m, stream>>>(
        mu, s, ls, y, ys, w, z, alpha, sf2, r1, n0, n, m, q, d, rows_m,
        b_part);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace gparml

// Launch plan of gparml_psi_bwd: plan = (splits_c, splits_m, the largest
// dynamic shared memory of its blocks in bytes, the device's limit for it,
// the float64 scratch gparml_psi_bwd takes per data row: 2 Q past Q = 64,
// the chunked Psi1 row pass's totals, else 0). Each grid's float64 partials take at most
// partial_bytes.
extern "C" int gparml_psi_bwd_plan(int n, int m, int q, int d, int num_sms,
                                   size_t partial_bytes, int* plan) {
  using namespace gparml;
  const int qm = qm_for(q);
  const int tiles = tc_blocks(m, qm == 0 ? kTcRows : tc_cell_cells(qm));
  plan[0] = cap_splits(n_splits(n, tiles, kRowsPsi2, kCellRowsMax, num_sms),
                       (size_t)q * m * m * sizeof(double), partial_bytes);
  plan[1] = cap_splits(
      n_splits(n, (m + 127) / 128, kRowsPsi1, kPsi1RowsMax, num_sms),
      (size_t)q * m * sizeof(double), partial_bytes);
  plan[2] = smem_bytes(
      qm == 0 ? std::max({kRowGroupSmem, tc_bwd_chunked_smem(tc_pass_dims(q)),
                          psi1_m_chunk_smem(d)})
              : std::max({smem_z(z_piece(m, qm), qm), tc_rows_smem(qm), tc_cells_smem(qm),
                          smem_rows_psi1(qm, d)}));
  plan[4] = qm == 0 ? 2 * q : 0;
  return (int)smem_limit(plan);
}

// zeta (Q), cells, ce and shift: as gparml_psi_fwd's; kmat: (M, M) = mult *
// sym(dPsi2) (upper triangle read); r1 = dPsi1Y: (M, D). qn = 0: mu, s, dmu, ds, dal (N, Q) and y, dy (N, D);
// qn = 1: (Q, N) and (D, N). Writes dmu, ds, dal, dy and the float64
// a_part (splits_c, Q, M, M) and b_part (splits_m, Q, M). row_scratch: the
// plan's float64 scratch (plan[4] per data row, zero-filled; unused when
// that is 0). Returns cudaGetLastError.
extern "C" int gparml_psi_bwd(const float* mu, const float* s, const float* y,
                              const float* w, const float* z,
                              const float* alpha, const float* sf2,
                              const float* zeta, const int* cells,
                              const float* ce, const float* shift, const float* kmat,
                              const float* r1, int n, int m,
                              int q, int d, int qn, int splits_c, int splits_m,
                              float* dmu, float* ds, float* dal, float* dy,
                              double* a_part, double* b_part,
                              double* row_scratch, void* stream) {
  GPARML_QM_SWITCH(q, gparml::launch_bwd, gparml::launch_bwd_chunked, mu, s,
                   y, w, z, alpha, sf2, zeta, cells, ce, shift, kmat, r1, n, m, q, d, qn,
                   splits_c, splits_m, dmu, ds, dal, dy, a_part, b_part,
                   row_scratch, static_cast<cudaStream_t>(stream));
}
