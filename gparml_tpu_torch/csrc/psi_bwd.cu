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
//      psi1_bwd_rows_kernel walks the inducing points with
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
// Past Q = 64 (any Q) the four passes have chunked twins (the *_chunked
// kernels below), which replace the TPU's `_bwd_kernel_stair` (:409) and
// `_bwd_kernel` (:249), launched by `_psi_fused_bwd` outside the flat
// window; the Q <= 64 kernels take the rest of those windows. They keep no
// Q-long vector in registers: each walks the latent dimensions in chunks of
// kQChunk twice, first to sum the exponents of a group (kGroup cells or
// inducing points of one data row, or a staged chunk of rows of one cell or
// inducing point, held in the thread's own column of shared memory) before
// expf, then for the per-dimension sums of that group, which it adds into
// float64: the row passes into a (2, Q, N) scratch of the row's totals t_q
// and u_q, the column passes into their partials.
//
// What bounds it on an H100: operations. The backward sweeps the
// N M (M + 1) / 2 (n, cell) pairs twice (rows, cells); the Q <= 64 passes
// form each tile's exponents and its reductions on the tensor cores and
// spend a pair's exp2 on the MUFU and a few float32 operations in the
// epilogue; the per-tile operand builds (the rows' in the cell pass, the
// cells' in the row pass) are shared by the block's warpgroups. Device
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
                        const float* __restrict__ ce, const float* __restrict__ kmat, int n,
                        int m, int q, float* __restrict__ dmu, float* __restrict__ ds,
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
  tc_build_rows<QM, KP, R>(st, alpha, zeta, logf(*sf2), q, rop, s_rc, nullptr);
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
  const double g = t_r[2 * QM];
  const float gs = (float)g;
  for (int k = 0; k < QS; ++k) {
    const int kk = k0 + k;
    if (kk >= q) break;
    const size_t i = ls.at(row, kk);
    const double mv = (double)(mu[i] - zeta[kk]);
    const float t = (float)(t_r[kk] - mv * g);
    const float u = (float)(t_r[QM + kk] - 2.0 * mv * t_r[kk] + mv * mv * g);
    const float a = alpha[kk];
    const float den = 2.f * a * s[i] + 1.f;
    const float c = a / den;
    dmu[i] = 2.f * c * t;
    ds[i] = -c * gs + 2.f * c * c * u;
    dal[i] = -(s[i] / den) * gs - u / (den * den);
  }
}

constexpr int kDChunk = 16;

template <int QM>
__global__ void __launch_bounds__(128)
psi1_bwd_rows_kernel(const float* __restrict__ mu, const float* __restrict__ s,
                     Strides ls, const float* __restrict__ y, Strides ys,
                     const float* __restrict__ w,
                     const float* __restrict__ z,
                     const float* __restrict__ alpha,
                     const float* __restrict__ sf2,
                     const float* __restrict__ r1, int n, int m, int q, int d,
                     float* __restrict__ dmu, float* __restrict__ ds,
                     float* __restrict__ dal, float* __restrict__ dy) {
  extern __shared__ float4 smem4[];
  float* zs = reinterpret_cast<float*>(smem4);
  stage_z<QM>(z, m, q, zs);
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;

  float mv[QM], c[QM], tt[QM], uu[QM];
  float lsum = 0.f;
#pragma unroll
  for (int k = 0; k < QM; ++k) {
    mv[k] = 0.f;
    c[k] = 0.f;
    tt[k] = 0.f;
    uu[k] = 0.f;
    if (k < q) {
      const float a = alpha[k];
      const float den = a * s[ls.at(row, k)] + 1.f;
      mv[k] = mu[ls.at(row, k)];
      c[k] = a / den;
      lsum += logf(den);
    }
  }
  const float l1 = logf(*sf2) - 0.5f * lsum;
  const float wn = w[row];
  float hsum = 0.f;

  // h is linear in y_n . dPsi1Y_m, so D is walked in chunks of kDChunk
  // (Psi1 is recomputed per chunk only when D > kDChunk).
  for (int d0 = 0; d0 < d; d0 += kDChunk) {
    float yv[kDChunk], gy[kDChunk];
#pragma unroll
    for (int j = 0; j < kDChunk; ++j) {
      yv[j] = d0 + j < d ? y[ys.at(row, d0 + j)] : 0.f;
      gy[j] = 0.f;
    }
    for (int mi = 0; mi < m; ++mi) {
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
      const float* rr = r1 + (size_t)mi * d + d0;
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
                         const float* __restrict__ ce, int n, int m, int q,
                         int rows_per_split, double* __restrict__ out) {
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

  const float logsf2 = logf(*sf2);
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
    tc_build_rows<QM, KP, kTcRows>(st, alpha, zeta, logsf2, q, rop, s_rc, &b2);
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
      const double a = t_c[kk] - (double)zb * t_c[QM + kk];
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

// The chunked cell pass's tile edge, and the most rows of one N-split of a
// cell pass.
constexpr int kCellTile = 16;
constexpr int kCellRowsMax = 262144;

// Shared memory of a chunked row pass: a group's cells (inducing points)
// of one chunk, and each thread's exponents of that group in its own
// column (s_g[c * kRowThreads + threadIdx.x]).
constexpr size_t kRowGroupSmem = (size_t)kGroup * (kQChunk + kRowThreads) * sizeof(float);

// psi2_bwd_rows_kernel for any Q. The row's cells are walked in groups of
// up to kGroup cells of one row mi of cells; per group the exponents are
// summed over the dimension chunks (in the thread's column of shared
// memory), then the chunks are walked again for t_q, u_q, whose group sums
// are added into the row's float64 totals tu[0][q][n], tu[1][q][n] (zero
// on entry; zeroed again on exit for psi1_bwd_rows_chunked_kernel). The
// cells' midpoints come from shared memory, the row's own (mu, c) chunk
// from device memory into registers.
__global__ void __launch_bounds__(kRowThreads)
psi2_bwd_rows_chunked_kernel(const float* __restrict__ mu,
                             const float* __restrict__ s, Strides ls,
                             const float* __restrict__ w,
                             const float* __restrict__ z,
                             const float* __restrict__ alpha,
                             const float* __restrict__ sf2,
                             const float* __restrict__ kmat,
                             const float* __restrict__ e0, int n, int m,
                             int q, float* __restrict__ dmu,
                             float* __restrict__ ds, float* __restrict__ dal,
                             double* __restrict__ tu) {
  extern __shared__ float4 smem4[];
  float* s_zb = reinterpret_cast<float*>(smem4);
  float* s_g = s_zb + kGroup * kQChunk + threadIdx.x;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = row < n;  // every thread takes part in the staging

  double lsum = 0.0;  // over Q, in double as stage_lw's sums
  if (live)
    for (int k = 0; k < q; ++k) lsum += logf(2.f * alpha[k] * s[ls.at(row, k)] + 1.f);
  const float lc = 2.f * logf(*sf2) - 0.5f * (float)lsum;
  const float wn = live ? w[row] : 0.f;
  double* tt = tu + row;
  double* uu = tu + (size_t)q * n + row;

  float gsum = 0.f;
  for (int mi = 0; mi < m; ++mi) {
    const float* krow = kmat + (size_t)mi * m;
    const float* erow = e0 + (size_t)mi * m;
    float gp = 0.f;
    for (int mj0 = mi; mj0 < m; mj0 += kGroup) {
      const int nc = min(kGroup, m - mj0);
      for (int k0 = 0; k0 < q; k0 += kQChunk) {
        __syncthreads();
        stage_group(z, m, q, mi, mj0, k0, true, s_zb);
        __syncthreads();
        float mv[kQChunk], cc[kQChunk];
        load_row_chunk(mu, s, ls, alpha, 2.f, q, row, live, k0, mv, cc);
#pragma unroll 2
        for (int c = 0; c < nc; ++c) {
          const float4* zb = reinterpret_cast<const float4*>(s_zb + c * kQChunk);
          float qd = k0 == 0 ? 0.f : s_g[c * kRowThreads];
#pragma unroll
          for (int k4 = 0; k4 < kQChunk / 4; ++k4) {
            const float4 v = zb[k4];
            const float d0 = v.x - mv[4 * k4], d1 = v.y - mv[4 * k4 + 1];
            const float d2 = v.z - mv[4 * k4 + 2], d3 = v.w - mv[4 * k4 + 3];
            qd = fmaf(cc[4 * k4] * d0, d0, qd);
            qd = fmaf(cc[4 * k4 + 1] * d1, d1, qd);
            qd = fmaf(cc[4 * k4 + 2] * d2, d2, qd);
            qd = fmaf(cc[4 * k4 + 3] * d3, d3, qd);
          }
          s_g[c * kRowThreads] = qd;
        }
      }
      for (int c = 0; c < nc; ++c) {
        const int mj = mj0 + c;
        const float g = __ldg(krow + mj) * wn *
                        expf(lc + __ldg(erow + mj) - s_g[c * kRowThreads]);
        s_g[c * kRowThreads] = g;
        gp += g;
      }
      for (int k0 = 0; k0 < q; k0 += kQChunk) {
        __syncthreads();
        stage_group(z, m, q, mi, mj0, k0, true, s_zb);
        __syncthreads();
        float mv[kQChunk], cc[kQChunk], tp[kQChunk], up[kQChunk];
        load_row_chunk(mu, s, ls, alpha, 2.f, q, row, live, k0, mv, cc);
#pragma unroll
        for (int k = 0; k < kQChunk; ++k) {
          tp[k] = 0.f;
          up[k] = 0.f;
        }
#pragma unroll 2
        for (int c = 0; c < nc; ++c) {
          const float4* zb = reinterpret_cast<const float4*>(s_zb + c * kQChunk);
          const float g = s_g[c * kRowThreads];
#pragma unroll
          for (int k4 = 0; k4 < kQChunk / 4; ++k4) {
            const float4 v = zb[k4];
            const float dv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int k = 4 * k4 + j;
              const float dd = dv[j] - mv[k];
              const float gd = g * dd;
              tp[k] += gd;
              up[k] = fmaf(gd, dd, up[k]);
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
    gsum += gp;
  }

  if (!live) return;
  for (int k = 0; k < q; ++k) {
    const size_t i = ls.at(row, k);
    const float a = alpha[k];
    const float den = 2.f * a * s[i] + 1.f;
    const float c = a / den;
    const float t = (float)tt[(size_t)k * n], u = (float)uu[(size_t)k * n];
    dmu[i] = 2.f * c * t;
    ds[i] = -c * gsum + 2.f * c * c * u;
    dal[i] = -(s[i] / den) * gsum - u / (den * den);
    tt[(size_t)k * n] = 0.0;
    uu[(size_t)k * n] = 0.0;
  }
}

// psi1_bwd_rows_kernel for any Q: the inducing points in groups of kGroup,
// each walked over the dimension chunks twice as in
// psi2_bwd_rows_chunked_kernel, with the same float64 totals tu.
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
        stage_group(z, m, q, 0, m0, k0, false, s_z);
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
        stage_group(z, m, q, 0, m0, k0, false, s_z);
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

// Shared memory of the chunked cell pass: a staged chunk of kRowsPsi2 rows
// and the exponents of those rows for each thread's cell, in the thread's
// own column.
constexpr size_t kCellChunkSmem =
    smem_rows_chunk(kRowsPsi2, 0) + (size_t)kRowsPsi2 * kCellTile * kCellTile * sizeof(float);

// psi2_bwd_cells_kernel for any Q: per staged chunk of kRowsPsi2 rows the
// cell's exponents are summed over the dimension chunks (in the thread's
// column of shared memory), then the chunks are walked again and each
// chunk's centred sums A_q over those rows are added into the cell's
// float64 partial.
__global__ void __launch_bounds__(kCellTile * kCellTile)
psi2_bwd_cells_chunked_kernel(const float* __restrict__ mu,
                              const float* __restrict__ s, Strides ls,
                              const float* __restrict__ w,
                              const float* __restrict__ z,
                              const float* __restrict__ alpha,
                              const float* __restrict__ sf2, int n, int m,
                              int q, int rows_per_split, int ntile,
                              double* __restrict__ out) {
  constexpr int kThreads = kCellTile * kCellTile;
  extern __shared__ float4 smem4[];
  float2* s_mc = reinterpret_cast<float2*>(smem4);
  float2* s_lw = s_mc + kRowsPsi2 * kQChunk;
  float* s_ev = reinterpret_cast<float*>(s_lw + kRowsPsi2) + threadIdx.x;

  int ti, tj;
  upper_tile(blockIdx.x, ntile, &ti, &tj);
  const int mi = ti * kCellTile + threadIdx.x / kCellTile;
  const int mj = tj * kCellTile + threadIdx.x % kCellTile;
  const bool own = mi < m && mj < m;
  const float* zi = z + (size_t)(own ? mi : 0) * q;
  const float* zj = z + (size_t)(own ? mj : 0) * q;
  double e = 0.0;  // over Q, in double as stage_lw's sums
  for (int k = 0; k < q; ++k) {
    const float dz = zi[k] - zj[k];
    e += alpha[k] * dz * dz;
  }
  const float e0 = (float)(-0.25 * e);

  // out: (splits, q, M, M), as psi2_bwd_cells_kernel's
  const size_t mm = (size_t)m * m;
  double* o = out + (size_t)blockIdx.y * q * mm + (own ? (size_t)mi * m + mj : 0);
  if (own)
    for (int k = 0; k < q; ++k) o[k * mm] = 0.0;

  const float logsf2 = logf(*sf2);
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(n, lo + rows_per_split);
  for (int n0 = lo; n0 < hi; n0 += kRowsPsi2) {
    const int nr = min(kRowsPsi2, hi - n0);
    for (int k0 = 0; k0 < q; k0 += kQChunk) {
      __syncthreads();
      stage_rows_chunk<kRowsPsi2>(mu, s, ls, alpha, 2.f, q, k0, n0, hi, s_mc);
      if (k0 == 0)
        stage_lw<kRowsPsi2, double>(s, ls, w, alpha, logsf2, 2.f, 2.f, q, n0, hi, s_lw);
      float zb[kQChunk];
#pragma unroll
      for (int k = 0; k < kQChunk; ++k)
        zb[k] = k0 + k < q ? 0.5f * (zi[k0 + k] + zj[k0 + k]) : 0.f;
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < nr; ++r) {
        const float4* mc = reinterpret_cast<const float4*>(s_mc + r * kQChunk);
        float qd = k0 == 0 ? 0.f : s_ev[r * kThreads];
#pragma unroll
        for (int k2 = 0; k2 < kQChunk / 2; ++k2) {
          const float4 v = mc[k2];
          const float t0 = zb[2 * k2] - v.x;
          const float t1 = zb[2 * k2 + 1] - v.z;
          qd = fmaf(v.y * t0, t0, qd);
          qd = fmaf(v.w * t1, t1, qd);
        }
        s_ev[r * kThreads] = qd;
      }
    }
    for (int r = 0; r < nr; ++r) {
      const float2 lw = s_lw[r];
      s_ev[r * kThreads] = lw.y * expf(lw.x + e0 - s_ev[r * kThreads]);
    }
    for (int k0 = 0; k0 < q; k0 += kQChunk) {
      __syncthreads();
      stage_rows_chunk<kRowsPsi2>(mu, s, ls, alpha, 2.f, q, k0, n0, hi, s_mc);
      float zb[kQChunk], acc[kQChunk];
#pragma unroll
      for (int k = 0; k < kQChunk; ++k) {
        zb[k] = k0 + k < q ? 0.5f * (zi[k0 + k] + zj[k0 + k]) : 0.f;
        acc[k] = 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < nr; ++r) {
        const float4* mc = reinterpret_cast<const float4*>(s_mc + r * kQChunk);
        const float ev = s_ev[r * kThreads];
#pragma unroll
        for (int k2 = 0; k2 < kQChunk / 2; ++k2) {
          const float4 v = mc[k2];
          acc[2 * k2] = fmaf(ev * v.y, v.x - zb[2 * k2], acc[2 * k2]);
          acc[2 * k2 + 1] = fmaf(ev * v.w, v.z - zb[2 * k2 + 1], acc[2 * k2 + 1]);
        }
      }
      if (own) {
#pragma unroll
        for (int k = 0; k < kQChunk; ++k)
          if (k0 + k < q) o[(k0 + k) * mm] += acc[k];
      }
    }
  }

  if (own && ti != tj) {
    double* lower = o - ((size_t)mi * m + mj) + (size_t)mj * m + mi;
    for (int k = 0; k < q; ++k) lower[k * mm] = o[k * mm];
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
               const float* ce, const float* kmat,
               const float* /* e0: the chunked kernels' only */,
               const float* r1, int n, int m, int q, int d, int qn,
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
      mu, s, ls, w, z, alpha, sf2, zeta, cells2, ce, kmat, n, m, q, dmu, ds, dal);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem_zm = smem_z(m, QM);
  const int nblk = (n + kRowThreads - 1) / kRowThreads;
  err = allow_smem(psi1_bwd_rows_kernel<QM>, smem_zm);
  if (err != cudaSuccess) return (int)err;
  psi1_bwd_rows_kernel<QM><<<nblk, kRowThreads, smem_zm, stream>>>(
      mu, s, ls, y, ys, w, z, alpha, sf2, r1, n, m, q, d, dmu, ds, dal, dy);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem_c = tc_cells_smem(QM);
  err = allow_smem(psi2_bwd_cells_tc_kernel<QM>, smem_c);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_c(tc_blocks(m, tc_cell_cells(QM)), splits_c);
  psi2_bwd_cells_tc_kernel<QM><<<grid_c, tc_wg(QM) * kTcWarpgroup, smem_c, stream>>>(
      mu, s, ls, w, z, alpha, sf2, zeta, cells2, ce, n, m, q, (n + splits_c - 1) / splits_c,
      a_part);
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

// launch_bwd for Q > 64: the chunked kernels, the same grids and partials,
// and the float64 row totals tu (2, Q, N), zero-filled by the caller.
inline int launch_bwd_chunked(const float* mu, const float* s, const float* y,
                              const float* w, const float* z,
                              const float* alpha, const float* sf2,
                              const float* /* zeta, cells, ce: the Q <= 64 */,
                              const int* /* kernels' only */, const float*,
                              const float* kmat, const float* e0,
                              const float* r1, int n, int m, int q, int d,
                              int qn, int splits_c, int splits_m, float* dmu,
                              float* ds, float* dal, float* dy,
                              double* a_part, double* b_part, double* tu,
                              cudaStream_t stream) {
  const Strides ls = strides_of(qn, n, q), ys = strides_of(qn, n, d);
  const int nblk = (n + kRowThreads - 1) / kRowThreads;
  psi2_bwd_rows_chunked_kernel<<<nblk, kRowThreads, kRowGroupSmem, stream>>>(
      mu, s, ls, w, z, alpha, sf2, kmat, e0, n, m, q, dmu, ds, dal, tu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  psi1_bwd_rows_chunked_kernel<<<nblk, kRowThreads, kRowGroupSmem, stream>>>(
      mu, s, ls, y, ys, w, z, alpha, sf2, r1, n, m, q, d, dmu, ds, dal, dy, tu);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int ntile = (m + kCellTile - 1) / kCellTile;
  dim3 grid_c(ntile * (ntile + 1) / 2, splits_c);
  err = allow_smem(psi2_bwd_cells_chunked_kernel, kCellChunkSmem);
  if (err != cudaSuccess) return (int)err;
  psi2_bwd_cells_chunked_kernel<<<grid_c, kCellTile * kCellTile,
                                  kCellChunkSmem, stream>>>(
      mu, s, ls, w, z, alpha, sf2, n, m, q, (n + splits_c - 1) / splits_c,
      ntile, a_part);
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
// the float64 scratch gparml_psi_bwd takes per data row: 2 Q for the
// chunked kernels, else 0). Each grid's float64 partials take at most
// partial_bytes.
extern "C" int gparml_psi_bwd_plan(int n, int m, int q, int d, int num_sms,
                                   size_t partial_bytes, int* plan) {
  using namespace gparml;
  const int qm = qm_for(q);
  const int tiles = qm == 0 ? tri_tiles(m, kCellTile) : tc_blocks(m, tc_cell_cells(qm));
  plan[0] = cap_splits(n_splits(n, tiles, kRowsPsi2, kCellRowsMax, num_sms),
                       (size_t)q * m * m * sizeof(double), partial_bytes);
  plan[1] = cap_splits(
      n_splits(n, (m + 127) / 128, kRowsPsi1, kPsi1RowsMax, num_sms),
      (size_t)q * m * sizeof(double), partial_bytes);
  plan[2] = smem_bytes(
      qm == 0 ? std::max({kRowGroupSmem, kCellChunkSmem, psi1_m_chunk_smem(d)})
              : std::max({smem_z(m, qm), tc_rows_smem(qm), tc_cells_smem(qm),
                          smem_rows_psi1(qm, d)}));
  plan[4] = qm == 0 ? 2 * q : 0;
  return (int)smem_limit(plan);
}

// zeta (Q), cells and ce: as gparml_psi_fwd's; kmat: (M, M) = mult * sym(dPsi2)
// (upper triangle read); e0: (M, M) (read past Q = 64 only);
// r1 = dPsi1Y: (M, D). qn = 0: mu, s, dmu, ds, dal (N, Q) and y, dy (N, D);
// qn = 1: (Q, N) and (D, N). Writes dmu, ds, dal, dy and the float64
// a_part (splits_c, Q, M, M) and b_part (splits_m, Q, M). row_scratch: the
// plan's float64 scratch (plan[4] per data row, zero-filled; unused when
// that is 0). Returns cudaGetLastError.
extern "C" int gparml_psi_bwd(const float* mu, const float* s, const float* y,
                              const float* w, const float* z,
                              const float* alpha, const float* sf2,
                              const float* zeta, const int* cells,
                              const float* ce, const float* kmat,
                              const float* e0, const float* r1, int n, int m,
                              int q, int d, int qn, int splits_c, int splits_m,
                              float* dmu, float* ds, float* dal, float* dy,
                              double* a_part, double* b_part,
                              double* row_scratch, void* stream) {
  GPARML_QM_SWITCH(q, gparml::launch_bwd, gparml::launch_bwd_chunked, mu, s,
                   y, w, z, alpha, sf2, zeta, cells, ce, kmat, e0, r1, n, m, q, d, qn,
                   splits_c, splits_m, dmu, ds, dal, dy, a_part, b_part,
                   row_scratch, static_cast<cudaStream_t>(stream));
}
