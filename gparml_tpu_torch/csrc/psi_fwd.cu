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
//  * psi2_fwd_tc_kernel (Q <= 64): one grid axis over blocks of packed
//    upper-triangle cells (up to 256: two warpgroups, two tiles of 64
//    cells each), one over N-splits. The exponents of each 64-cell x
//    64-row tile come from the tensor cores (psi_tc.cuh, 3-term TF32,
//    centred on zeta, an exact shift 2^S in the row constants, undone on
//    the float64 totals); each thread adds w_n exp2(L2) over its 16 rows into
//    float32 tile sums of its two cells, then into float64 registers, and
//    the four threads of a cell add theirs at the end. Each split writes its totals
//    into its own float64 (M, M) partial, in both triangles; the wrapper
//    sums the partials (deterministic, no atomics). When the partials'
//    memory budget lowers the split count, the launcher runs the grid again
//    for each further kFwdRowsMax rows a split, adding in.
//  * psi1y_fwd_kernel: one thread per inducing point m, grid over
//    (N-splits, m-blocks); per staged chunk of 32 rows it forms
//    w_n Psi1[n, m] in registers and adds their products with the staged
//    Y rows into its split's (M, D) float64 partial row.
//
// Past Q = 64 (any Q) psi2_fwd_tc_chunked_kernel and
// psi1y_fwd_chunked_kernel replace the TPU's `_fwd_kernel` (:225, launched
// by `_call_fwd`, which took the shapes outside the flat window) there. The
// Psi2 kernel is psi2_fwd_tc_kernel with K walked in chunks of kTcQChunk
// latent dimensions (psi_tc.cuh): each chunk's operands are built in shared
// memory and added into the same tensor-core accumulators, with the same
// shift 2^S. psi1y_fwd_chunked_kernel sums a staged chunk of rows' exponents
// over the dimension chunks in registers and applies expf once all are in.
// The Q <= 64 kernels take the rest of `_fwd_kernel`'s window (M <= 128,
// and 512 < M <= 640) as they take the flat window.
//
// What bounds it on an H100: operations, not bytes. The Psi2 kernel is
// bound by the exp2 of each of the N M (M + 1) / 2 pairs on the MUFU, the
// rate of issuing the exponent tiles' wgmma (psi_tc.cuh) and the row operand's
// build, shared by the block's 256 cells; its epilogue costs two float32
// adds and an FMA a pair, and the rows come from device memory once per
// cell block (cp.async, one tile ahead); past Q = 64 the rows' and the
// 128 cells' operands are rebuilt chunk by chunk for every row tile, the
// rows read from device memory (L1, L2) once per cell block. psi1y_fwd_kernel (N M pairs)
// keeps the direct form on the CUDA cores: ~3 FMA-pipe operations per
// latent dimension plus one expf, with the operands in registers and the
// rows from shared memory as warp-wide broadcasts.
#include "psi_tc.cuh"

namespace gparml {

// Most rows of one N-split of the Psi2 kernel in one launch.
constexpr int kFwdRowsMax = 1024 * kRowsPsi2;

// Cells of one block of psi2_fwd_tc_kernel, and its shared memory: the
// cells' operand and terms, the rows' operand and terms, and the ring of
// raw row stages.
__host__ __device__ constexpr int tc_fwd_cells(int qm) {
  return tc_wg(qm) * tc_fwd_ct(qm) * kTcRows;
}
__host__ __device__ constexpr size_t tc_fwd_smem(int qm) {
  return tc_operand_bytes(tc_fwd_cells(qm), qm) + tc_cellterm_bytes(tc_fwd_cells(qm)) +
         tc_operand_bytes(kTcRows, qm) + tc_region(kTcRows * sizeof(float)) +
         tc_stages(qm) * tc_stage_bytes(kTcRows, qm);
}

// sum_n w_n Psi2_n for one block of packed cells (grid x: tc_wg warpgroups,
// each with tc_fwd_ct tiles of 64 cells, the cells on the tile's M axis)
// and one N-split (grid y). The cells' operand is built once; the split's
// rows are walked in tiles of 64 (the tile's N axis), staged by cp.async
// one tile ahead, each tile's row operand built once in shared memory for
// all the block's cell tiles. Per tile each thread adds w_n exp2(L2) over
// its 16 rows into its two cells' float32 tile sums, then into float64
// registers; at the end the four threads that share a cell add theirs (warp
// shuffles) and one writes the split's float64 (M, M) partial, both
// triangles: the grid's first launch writes it, a further one adds to it.
// Cells past the last (the last block's tail) are dropped there.
template <int QM>
__global__ void __launch_bounds__(tc_wg(QM) * kTcWarpgroup)
psi2_fwd_tc_kernel(const float* __restrict__ mu, const float* __restrict__ s, Strides ls,
                   const float* __restrict__ w, const float* __restrict__ z,
                   const float* __restrict__ alpha, const float* __restrict__ sf2,
                   const float* __restrict__ zeta, const int2* __restrict__ cells,
                   const float* __restrict__ ce, const float* __restrict__ shift, int n_begin,
                   int n, int m, int q, int rows_per_split, double* __restrict__ out) {
  constexpr int KP = tc_k(QM), S = tc_stages(QM), CT = tc_fwd_ct(QM);
  constexpr int NC = tc_fwd_cells(QM);
  extern __shared__ float4 smem4[];
  TcCarve cv(smem4);
  const TcOperand cop = tc_take_operand<KP>(cv, NC);
  float* s_ce = cv.take<float>(NC * sizeof(float));
  cv.take<float>(NC * sizeof(float));  // (kmat entries: the row pass's)
  int2* s_ij = cv.take<int2>(NC * sizeof(int2));
  const TcOperand rop = tc_take_operand<KP>(cv, kTcRows);
  float* s_rc = cv.take<float>(kTcRows * sizeof(float));
  const int stage = (int)(tc_stage_bytes(kTcRows, QM) / sizeof(float));
  float* ring = cv.take<float>(S * tc_stage_bytes(kTcRows, QM));
  __syncthreads();

  const int p0 = blockIdx.x * NC;
  tc_build_cells<QM, KP, NC>(z, zeta, cells, ce, nullptr, m, q, p0, cop, s_ce, s_ij, nullptr,
                             nullptr);
  const int wg = threadIdx.x / kTcWarpgroup;

  const float logsf2 = logf(*sf2), sh = *shift;
  const int lo = n_begin + blockIdx.y * rows_per_split;
  const int hi = min(n, lo + rows_per_split);
  const int ntiles = hi > lo ? (hi - lo + kTcRows - 1) / kTcRows : 0;
  double acc[CT][2];
#pragma unroll
  for (int j = 0; j < CT; ++j) acc[j][0] = acc[j][1] = 0.0;
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
    tc_build_rows<QM, KP, kTcRows>(st, alpha, zeta, logsf2, sh, q, rop, s_rc, nullptr);
    tc_operands_ready();
    const float* st_w = st + 2 * kTcRows * QM;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int tile = (wg * CT + j) * kTcRows;
      float d[32];
      tc_tile<KP>(cop.hi + tile * KP, cop.lo + tile * KP, rop.hi, rop.lo, d);
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = tc_m(i), r = tc_n(i);
        part[(i >> 1) & 1] += st_w[r] * tc_exp2(d[i] + s_ce[tile + c] + s_rc[r]);
      }
      acc[j][0] += part[0];
      acc[j][1] += part[1];
    }
    __syncthreads();
  }

  double* o = out + (size_t)blockIdx.y * m * m;
  const bool first = n_begin == 0;
  const double unshift = ldexp(1.0, -(int)sh);
#pragma unroll
  for (int j = 0; j < CT; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      double v = acc[j][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v *= unshift;
      const int c = (wg * CT + j) * kTcRows + tc_m(2 * h);
      const int2 ij = s_ij[c];
      if ((threadIdx.x & 3) != 0 || ij.x < 0) continue;
      double* up = o + (size_t)ij.x * m + ij.y;
      *up = first ? v : *up + v;
      if (ij.x != ij.y) {
        double* mirror = o + (size_t)ij.y * m + ij.x;
        *mirror = first ? v : *mirror + v;
      }
    }
  }
}

template <int QM>
__global__ void __launch_bounds__(128)
psi1y_fwd_kernel(const float* __restrict__ mu, const float* __restrict__ s,
                 Strides ls, const float* __restrict__ y, Strides ys,
                 const float* __restrict__ w,
                 const float* __restrict__ z, const float* __restrict__ alpha,
                 const float* __restrict__ sf2, int n, int m, int q, int d,
                 int rows_per_split, double* __restrict__ out) {
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

  const float logsf2 = logf(*sf2);
  const int lo = blockIdx.x * rows_per_split;
  const int hi = min(n, lo + rows_per_split);
  double* o = out + ((size_t)blockIdx.x * m + (active ? mi : 0)) * d;
  for (int n0 = lo; n0 < hi; n0 += kRowsPsi1) {
    __syncthreads();
    stage_rows<QM, kRowsPsi1>(mu, s, ls, w, alpha, logsf2, 1.f, 1.f, q, n0,
                              hi, s_mc, s_lw);
    stage_y<kRowsPsi1>(y, ys, d, n0, hi, s_y);
    __syncthreads();
    float p[kRowsPsi1];
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
      p[r] = lw.y * expf(lw.x - 0.5f * qd);
    }
    if (active) {
      for (int k = 0; k < d; ++k) {
        float a = 0.f;
#pragma unroll
        for (int r = 0; r < kRowsPsi1; ++r) a = fmaf(p[r], s_y[r * d + k], a);
        o[k] += a;
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

// psi2_fwd_tc_kernel for any Q > 64, with K in chunks: the same grid (128
// packed cells a block, on the tiles' M axis), partials and relaunches.
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

// psi1y_fwd_kernel for any Q, the latent dimensions in chunks of kQChunk.
__global__ void __launch_bounds__(128)
psi1y_fwd_chunked_kernel(const float* __restrict__ mu,
                         const float* __restrict__ s, Strides ls,
                         const float* __restrict__ y, Strides ys,
                         const float* __restrict__ w,
                         const float* __restrict__ z,
                         const float* __restrict__ alpha,
                         const float* __restrict__ sf2, int n, int m, int q,
                         int d, int rows_per_split, double* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float2* s_mc = reinterpret_cast<float2*>(smem4);
  float2* s_lw = s_mc + kRowsPsi1 * kQChunk;
  float* s_y = reinterpret_cast<float*>(s_lw + kRowsPsi1);

  const int mi = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = mi < m;
  const float* zm = z + (size_t)(active ? mi : 0) * q;

  const float logsf2 = logf(*sf2);
  const int lo = blockIdx.x * rows_per_split;
  const int hi = min(n, lo + rows_per_split);
  double* o = out + ((size_t)blockIdx.x * m + (active ? mi : 0)) * d;
  for (int n0 = lo; n0 < hi; n0 += kRowsPsi1) {
    float p[kRowsPsi1];
#pragma unroll
    for (int r = 0; r < kRowsPsi1; ++r) p[r] = 0.f;
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
#pragma unroll
      for (int r = 0; r < kRowsPsi1; ++r) {
        const float4* mc = reinterpret_cast<const float4*>(s_mc + r * kQChunk);
#pragma unroll
        for (int k2 = 0; k2 < kQChunk / 2; ++k2) {
          const float4 v = mc[k2];
          const float t0 = v.x - zc[2 * k2];
          const float t1 = v.z - zc[2 * k2 + 1];
          p[r] = fmaf(v.y * t0, t0, p[r]);
          p[r] = fmaf(v.w * t1, t1, p[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPsi1; ++r) {
      const float2 lw = s_lw[r];
      p[r] = lw.y * expf(lw.x - 0.5f * p[r]);
    }
    if (active) {
      for (int k = 0; k < d; ++k) {
        float a = 0.f;
#pragma unroll
        for (int r = 0; r < kRowsPsi1; ++r) a = fmaf(p[r], s_y[r * d + k], a);
        o[k] += a;
      }
    }
  }
}

template <int QM>
int launch_fwd(const float* mu, const float* s, const float* y,
               const float* w, const float* z, const float* alpha,
               const float* sf2, const float* zeta, const int* cells,
               const float* ce, const float* shift, int n, int m,
               int q, int d, int qn, int splits2,
               int splits1, double* p2_part, double* p1y_part,
               cudaStream_t stream) {
  const Strides ls = strides_of(qn, n, q), ys = strides_of(qn, n, d);
  const int rows2 = std::min((n + splits2 - 1) / splits2, kFwdRowsMax);
  dim3 grid2(tc_blocks(m, tc_fwd_cells(QM)), splits2);
  const size_t smem2 = tc_fwd_smem(QM);
  cudaError_t err = allow_smem(psi2_fwd_tc_kernel<QM>, smem2);
  if (err != cudaSuccess) return (int)err;
  // One launch unless the partials' budget lowered splits2 below
  // n / kFwdRowsMax: each further launch adds the next rows2 rows a split.
  for (int n0 = 0; n0 < n; n0 += splits2 * rows2) {
    psi2_fwd_tc_kernel<QM><<<grid2, tc_wg(QM) * kTcWarpgroup, smem2, stream>>>(
        mu, s, ls, w, z, alpha, sf2, zeta, reinterpret_cast<const int2*>(cells), ce, shift, n0,
        n, m, q, rows2, p2_part);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  const int rows1 = (n + splits1 - 1) / splits1;
  const size_t smem1 = smem_rows_psi1(QM, d);
  err = allow_smem(psi1y_fwd_kernel<QM>, smem1);
  if (err != cudaSuccess) return (int)err;
  dim3 grid1(splits1, (m + 127) / 128);
  psi1y_fwd_kernel<QM><<<grid1, 128, smem1, stream>>>(
      mu, s, ls, y, ys, w, z, alpha, sf2, n, m, q, d, rows1, p1y_part);
  return (int)cudaGetLastError();
}

// launch_fwd for Q > 64: psi2_fwd_tc_chunked_kernel and
// psi1y_fwd_chunked_kernel, the same grids and partials.
inline int launch_fwd_chunked(const float* mu, const float* s, const float* y,
                              const float* w, const float* z,
                              const float* alpha, const float* sf2,
                              const float* zeta, const int* cells, const float* ce,
                              const float* shift, int n, int m, int q, int d, int qn,
                              int splits2, int splits1, double* p2_part, double* p1y_part,
                              cudaStream_t stream) {
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

  const size_t smem1 = smem_rows_chunk(kRowsPsi1, d);
  err = allow_smem(psi1y_fwd_chunked_kernel, smem1);
  if (err != cudaSuccess) return (int)err;
  dim3 grid1(splits1, (m + 127) / 128);
  psi1y_fwd_chunked_kernel<<<grid1, 128, smem1, stream>>>(
      mu, s, ls, y, ys, w, z, alpha, sf2, n, m, q, d,
      (n + splits1 - 1) / splits1, p1y_part);
  return (int)cudaGetLastError();
}

}  // namespace gparml

// Launch plan of gparml_psi_fwd: plan = (splits2, splits1, the largest
// dynamic shared memory of its blocks in bytes, the device's limit for it).
// Each grid's float64 partials take at most partial_bytes.
extern "C" int gparml_psi_fwd_plan(int n, int m, int q, int d, int num_sms,
                                   size_t partial_bytes, int* plan) {
  using namespace gparml;
  const int qm = qm_for(q);
  const int tiles = tc_blocks(m, qm == 0 ? kTcChunkFwdCells : tc_fwd_cells(qm));
  plan[0] = cap_splits(n_splits(n, tiles, kRowsPsi2, kFwdRowsMax, num_sms),
                       (size_t)m * m * sizeof(double), partial_bytes);
  plan[1] = cap_splits(
      n_splits(n, (m + 127) / 128, kRowsPsi1, kPsi1RowsMax, num_sms),
      (size_t)m * d * sizeof(double), partial_bytes);
  plan[2] = smem_bytes(
      qm == 0 ? std::max(tc_fwd_chunked_smem(), smem_rows_chunk(kRowsPsi1, d))
              : std::max(tc_fwd_smem(qm), smem_rows_psi1(qm, d)));
  return (int)smem_limit(plan);
}

// qn = 0: mu, s (N, Q) and y (N, D); qn = 1: mu, s (Q, N) and y (D, N).
// zeta (Q): the shift of mu and Z in the Psi2 exponent (psi_tc.cuh; the
// wrapper passes the mean of Z); cells (M (M + 1) / 2, 2) int32: the packed
// upper-triangle cells (i, j), i <= j, row by row; ce (M (M + 1) / 2): their
// E0 log2e; shift: one float, the whole number S the Psi2 kernels add to
// every base-2 exponent and take off their sums.
// p2_part: (splits2, M, M) float64, every element written. p1y_part:
// (splits1, M, D) float64, zero-filled by the caller (accumulated in place).
// Returns cudaGetLastError.
extern "C" int gparml_psi_fwd(const float* mu, const float* s, const float* y,
                              const float* w, const float* z,
                              const float* alpha, const float* sf2,
                              const float* zeta, const int* cells, const float* ce,
                              const float* shift, int n, int m, int q, int d, int qn,
                              int splits2, int splits1, double* p2_part, double* p1y_part,
                              void* stream) {
  GPARML_QM_SWITCH(q, gparml::launch_fwd, gparml::launch_fwd_chunked, mu, s,
                   y, w, z, alpha, sf2, zeta, cells, ce, shift, n, m, q, d, qn, splits2, splits1,
                   p2_part, p1y_part, static_cast<cudaStream_t>(stream));
}
