// Psi-statistics backward on Hopper, float32.
//
// Replaces the TPU kernel gparml_tpu/ops/psi_pallas.py `_bwd_kernel_flat`
// (launched by `_call_bwd_flat`), which formed G = exp2(lp) * sym(dPsi2) per
// staircase slab on the MXU and closed the 2-D chains by an in-kernel
// jax.vjp. Given the cotangents dPsi1Y (M, D) and S = sym(dPsi2) (M, M),
// the cotangents reduce over two different axes, so this file has two
// kinds of pass, each recomputing the exponent:
//
//  * row passes, one thread per data row n (reductions over cells):
//      psi2_bwd_rows_kernel walks the upper-triangle cells (m <= m') with
//        K = mult * S (mult = 2 off the diagonal) and accumulates
//        G = sum g, t_q = sum g (zb - mu), u_q = sum g (zb - mu)^2,
//        g = K w exp(log Psi2); it writes dmu = 2 c t,
//        ds = -c G + 2 c^2 u and the row's share of dalpha,
//        -(s/den) G - u / den^2.
//      psi1_bwd_rows_kernel walks the inducing points with
//        h = w Psi1 (y_n . dPsi1Y_m), adds -c1 T, -c1 H/2 + c1^2 U/2 and
//        -(s/den1) H/2 - U/(2 den1^2) (T, U, H the h-sums as above), and
//        writes dY = sum_m w Psi1 dPsi1Y_m.
//  * column passes (reductions over n, one partial per N-split):
//      psi2_bwd_cells_kernel, per (m, m') cell:
//        A_q = sum_n w e c_nq (mu_nq - zb_q) with e = Psi2[n, m, m'],
//        summed kFlushRows rows at a time into the split's partial;
//      psi1_bwd_m_kernel, per inducing point m:
//        B_q = sum_n h c1_nq (mu_nq - z_mq).
//    Both sums are centred on the cell (the inducing point), so dZ never
//    forms them as differences of two large uncentred sums.
//    The wrapper sums the partials and assembles dZ, dalpha's cell share and
//    dsf2 with small tensor operations (gparml_tpu_torch/ops/psi_cuda.py).
//
// What bounds it on an H100: exp and FMA issue, as in the forward; the
// backward sweeps the N * M^2 / 2 (n, cell) pairs twice (rows, cells). Row
// passes read each cell's K, E0 and z_m' as warp-wide broadcasts (every
// thread of the grid walks the same cell sequence), so device-memory
// traffic is O(N (Q + D)); the register accumulators (4 Q + 1 per thread)
// are what limits occupancy at large Q.
#include "psi_common.cuh"

namespace gparml {

template <int QM>
__global__ void __launch_bounds__(128)
psi2_bwd_rows_kernel(const float* __restrict__ mu, const float* __restrict__ s,
                     const float* __restrict__ w, const float* __restrict__ z,
                     const float* __restrict__ alpha,
                     const float* __restrict__ sf2,
                     const float* __restrict__ kmat,
                     const float* __restrict__ e0, int n, int m, int q,
                     float* __restrict__ dmu, float* __restrict__ ds,
                     float* __restrict__ dal) {
  extern __shared__ float4 smem4[];
  float* zs = reinterpret_cast<float*>(smem4);
  stage_z<QM>(z, m, q, zs);
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;

  float mv[QM], c[QM], t[QM], u[QM];
  float lsum = 0.f;
#pragma unroll
  for (int k = 0; k < QM; ++k) {
    mv[k] = 0.f;
    c[k] = 0.f;
    t[k] = 0.f;
    u[k] = 0.f;
    if (k < q) {
      const float a = alpha[k];
      const float den = 2.f * a * s[(size_t)row * q + k] + 1.f;
      mv[k] = mu[(size_t)row * q + k];
      c[k] = a / den;
      lsum += logf(den);
    }
  }
  const float lc = 2.f * logf(*sf2) - 0.5f * lsum;
  const float wn = w[row];
  float gsum = 0.f;

  for (int mi = 0; mi < m; ++mi) {
    float hm[QM];
#pragma unroll
    for (int k = 0; k < QM; ++k) hm[k] = 0.5f * zs[mi * QM + k];
    const float* krow = kmat + (size_t)mi * m;
    const float* erow = e0 + (size_t)mi * m;
    for (int mj = mi; mj < m; ++mj) {
      const float2* zj = reinterpret_cast<const float2*>(zs + mj * QM);
      float dd[QM];
      float qd = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < QM / 2; ++k2) {
        const float2 v = zj[k2];
        dd[2 * k2] = fmaf(0.5f, v.x, hm[2 * k2]) - mv[2 * k2];
        dd[2 * k2 + 1] = fmaf(0.5f, v.y, hm[2 * k2 + 1]) - mv[2 * k2 + 1];
        qd = fmaf(c[2 * k2] * dd[2 * k2], dd[2 * k2], qd);
        qd = fmaf(c[2 * k2 + 1] * dd[2 * k2 + 1], dd[2 * k2 + 1], qd);
      }
      const float g = __ldg(krow + mj) * wn * expf(lc + __ldg(erow + mj) - qd);
      gsum += g;
#pragma unroll
      for (int k = 0; k < QM; ++k) {
        const float gd = g * dd[k];
        t[k] += gd;
        u[k] = fmaf(gd, dd[k], u[k]);
      }
    }
  }

  for (int k = 0; k < q; ++k) {
    const size_t i = (size_t)row * q + k;
    const float den = 2.f * alpha[k] * s[i] + 1.f;
    dmu[i] = 2.f * c[k] * t[k];
    ds[i] = -c[k] * gsum + 2.f * c[k] * c[k] * u[k];
    dal[i] = -(s[i] / den) * gsum - u[k] / (den * den);
  }
}

constexpr int kDChunk = 16;

template <int QM>
__global__ void __launch_bounds__(128)
psi1_bwd_rows_kernel(const float* __restrict__ mu, const float* __restrict__ s,
                     const float* __restrict__ y, const float* __restrict__ w,
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
      const float den = a * s[(size_t)row * q + k] + 1.f;
      mv[k] = mu[(size_t)row * q + k];
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
      yv[j] = d0 + j < d ? y[(size_t)row * d + d0 + j] : 0.f;
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
      if (d0 + j < d) dy[(size_t)row * d + d0 + j] = gy[j];
  }

  for (int k = 0; k < q; ++k) {
    const size_t i = (size_t)row * q + k;
    const float den = alpha[k] * s[i] + 1.f;
    dmu[i] += -c[k] * tt[k];
    ds[i] += -0.5f * c[k] * hsum + 0.5f * c[k] * c[k] * uu[k];
    dal[i] += -0.5f * (s[i] / den) * hsum - 0.5f * uu[k] / (den * den);
  }
}

// Rows summed in registers between two additions into a cell's partial.
constexpr int kFlushRows = 1024;
static_assert(kFlushRows % kRowsPsi2 == 0, "flush at a staged-chunk edge");

// Up to Q = 10, three resident blocks per SM (80 registers a thread): left
// to itself ptxas picks 64 registers and spills the flush's live state
// (44 B), which cost the pass ~3% on an H100.
template <int QM, int TILE>
__global__ void __launch_bounds__(TILE * TILE, QM <= 10 ? 3 : 1)
psi2_bwd_cells_kernel(const float* __restrict__ mu,
                      const float* __restrict__ s,
                      const float* __restrict__ w,
                      const float* __restrict__ z,
                      const float* __restrict__ alpha,
                      const float* __restrict__ sf2, int n, int m, int q,
                      int rows_per_split, int ntile, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float2* s_mc = reinterpret_cast<float2*>(smem4);
  float2* s_lw = s_mc + kRowsPsi2 * QM;

  int ti, tj;
  upper_tile(blockIdx.x, ntile, &ti, &tj);
  const int mi = ti * TILE + threadIdx.x / TILE;
  const int mj = tj * TILE + threadIdx.x % TILE;

  float zb[QM], acc[QM];
  float e = 0.f;
#pragma unroll
  for (int k = 0; k < QM; ++k) {
    const float zi = (mi < m && k < q) ? z[(size_t)mi * q + k] : 0.f;
    const float zj = (mj < m && k < q) ? z[(size_t)mj * q + k] : 0.f;
    zb[k] = 0.5f * (zi + zj);
    const float dz = zi - zj;
    if (k < q) e = fmaf(alpha[k] * dz, dz, e);
    acc[k] = 0.f;
  }
  const float e0 = -0.25f * e;

  // out: (splits, q, M, M). Each thread owns cell (mi, mj): the whole
  // of a diagonal tile, the upper triangle elsewhere (mirrored at the end).
  // The registers hold the sums of kFlushRows rows at a time, which are
  // added to the cell in `out`, so no float32 running sum spans a split
  // (~83k rows at N=1e6) and no registers are spent on a second level.
  const bool own = mi < m && mj < m;
  const size_t mm = (size_t)m * m;
  float* o = out + (size_t)blockIdx.y * q * mm + (size_t)mi * m + mj;
  if (own)
    for (int k = 0; k < q; ++k) o[k * mm] = 0.f;

  const float logsf2 = logf(*sf2);
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(n, lo + rows_per_split);
  for (int f0 = lo; f0 < hi; f0 += kFlushRows) {
    const int fhi = min(hi, f0 + kFlushRows);
    for (int n0 = f0; n0 < fhi; n0 += kRowsPsi2) {
      __syncthreads();
      stage_rows<QM, kRowsPsi2>(mu, s, w, alpha, logsf2, 2.f, 2.f, q, n0,
                                fhi, s_mc, s_lw);
      __syncthreads();
      const int nr = min(kRowsPsi2, fhi - n0);
      for (int r = 0; r < nr; ++r) {
        const float2 lw = s_lw[r];
        const float4* mc = reinterpret_cast<const float4*>(s_mc + r * QM);
        float qd = 0.f;
#pragma unroll
        for (int k2 = 0; k2 < QM / 2; ++k2) {
          const float4 v = mc[k2];
          const float t0 = zb[2 * k2] - v.x;
          const float t1 = zb[2 * k2 + 1] - v.z;
          qd = fmaf(v.y * t0, t0, qd);
          qd = fmaf(v.w * t1, t1, qd);
        }
        const float ev = lw.y * expf(lw.x + e0 - qd);
#pragma unroll
        for (int k2 = 0; k2 < QM / 2; ++k2) {
          const float4 v = mc[k2];
          acc[2 * k2] = fmaf(ev * v.y, v.x - zb[2 * k2], acc[2 * k2]);
          acc[2 * k2 + 1] =
              fmaf(ev * v.w, v.z - zb[2 * k2 + 1], acc[2 * k2 + 1]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < QM; ++k) {
      if (own && k < q) o[k * mm] += acc[k];
      acc[k] = 0.f;
    }
  }

  if (own && ti != tj) {
    float* lower = o - ((size_t)mi * m + mj) + (size_t)mj * m + mi;
    for (int k = 0; k < q; ++k) lower[k * mm] = o[k * mm];
  }
}

template <int QM>
__global__ void __launch_bounds__(128)
psi1_bwd_m_kernel(const float* __restrict__ mu, const float* __restrict__ s,
                  const float* __restrict__ y, const float* __restrict__ w,
                  const float* __restrict__ z, const float* __restrict__ alpha,
                  const float* __restrict__ sf2,
                  const float* __restrict__ r1, int n, int m, int q, int d,
                  int rows_per_split, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float2* s_mc = reinterpret_cast<float2*>(smem4);
  float2* s_lw = s_mc + kRowsPsi1 * QM;
  float* s_y = reinterpret_cast<float*>(s_lw + kRowsPsi1);

  const int mi = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = mi < m;
  float zm[QM], acc[QM];
#pragma unroll
  for (int k = 0; k < QM; ++k) {
    zm[k] = (active && k < q) ? z[(size_t)mi * q + k] : 0.f;
    acc[k] = 0.f;
  }
  const float* rm = r1 + (size_t)(active ? mi : 0) * d;

  const float logsf2 = logf(*sf2);
  const int lo = blockIdx.x * rows_per_split;
  const int hi = min(n, lo + rows_per_split);
  for (int n0 = lo; n0 < hi; n0 += kRowsPsi1) {
    __syncthreads();
    stage_rows<QM, kRowsPsi1>(mu, s, w, alpha, logsf2, 1.f, 1.f, q, n0, hi,
                              s_mc, s_lw);
    for (int i = threadIdx.x; i < kRowsPsi1 * d; i += blockDim.x) {
      const int nn = n0 + i / d;
      s_y[i] = nn < hi ? y[(size_t)nn * d + i % d] : 0.f;
    }
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
    // out: (splits, q, M)
    float* o = out + (size_t)blockIdx.x * q * m;
#pragma unroll
    for (int k = 0; k < QM; ++k) {
      if (k < q) o[(size_t)k * m + mi] = acc[k];
    }
  }
}

// Cell-pass tile edge, and the cap on its per-split partials (float32
// elements, 512 MB).
constexpr int kCellTile = 16;
constexpr size_t kCellPartialElems = (size_t)1 << 27;

template <int QM>
int launch_bwd(const float* mu, const float* s, const float* y,
               const float* w, const float* z, const float* alpha,
               const float* sf2, const float* kmat, const float* e0,
               const float* r1, int n, int m, int q, int d, int splits_c,
               int splits_m, float* dmu, float* ds, float* dal, float* dy,
               float* a_part, float* b_part, cudaStream_t stream) {
  const size_t smem_zm = smem_z(m, QM);
  const int nblk = (n + 127) / 128;
  cudaError_t err = allow_smem(psi2_bwd_rows_kernel<QM>, smem_zm);
  if (err != cudaSuccess) return (int)err;
  psi2_bwd_rows_kernel<QM><<<nblk, 128, smem_zm, stream>>>(
      mu, s, w, z, alpha, sf2, kmat, e0, n, m, q, dmu, ds, dal);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  err = allow_smem(psi1_bwd_rows_kernel<QM>, smem_zm);
  if (err != cudaSuccess) return (int)err;
  psi1_bwd_rows_kernel<QM><<<nblk, 128, smem_zm, stream>>>(
      mu, s, y, w, z, alpha, sf2, r1, n, m, q, d, dmu, ds, dal, dy);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  constexpr int TILE = kCellTile;
  const int ntile = (m + TILE - 1) / TILE;
  dim3 grid_c(ntile * (ntile + 1) / 2, splits_c);
  psi2_bwd_cells_kernel<QM, TILE>
      <<<grid_c, TILE * TILE, smem_rows_psi2(QM), stream>>>(
      mu, s, w, z, alpha, sf2, n, m, q, (n + splits_c - 1) / splits_c, ntile,
      a_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem_m = smem_rows_psi1(QM, d);
  err = allow_smem(psi1_bwd_m_kernel<QM>, smem_m);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_m(splits_m, (m + 127) / 128);
  psi1_bwd_m_kernel<QM><<<grid_m, 128, smem_m, stream>>>(
      mu, s, y, w, z, alpha, sf2, r1, n, m, q, d,
      (n + splits_m - 1) / splits_m, b_part);
  return (int)cudaGetLastError();
}

}  // namespace gparml

// Launch plan of gparml_psi_bwd: plan = (splits_c, splits_m, the largest
// dynamic shared memory of its blocks in bytes, the device's limit for it).
extern "C" int gparml_psi_bwd_plan(int n, int m, int q, int d, int num_sms,
                                   int* plan) {
  using namespace gparml;
  const int qm = qm_for(q);
  if (qm == 0) return (int)cudaErrorInvalidValue;
  const size_t cap = kCellPartialElems / ((size_t)q * m * m);
  plan[0] = std::max(1, (int)std::min(
      (size_t)n_splits(n, tri_tiles(m, kCellTile), kRowsPsi2, num_sms), cap));
  plan[1] = n_splits(n, (m + 127) / 128, kRowsPsi1, num_sms);
  plan[2] = smem_bytes(
      std::max({smem_z(m, qm), smem_rows_psi2(qm), smem_rows_psi1(qm, d)}));
  return (int)smem_limit(plan);
}

// kmat: (M, M) = mult * sym(dPsi2) (upper triangle read); e0: (M, M);
// r1 = dPsi1Y: (M, D). Writes dmu, ds, dal (N, Q), dy (N, D),
// a_part (splits_c, Q, M, M) and b_part (splits_m, Q, M).
// Returns cudaGetLastError.
extern "C" int gparml_psi_bwd(const float* mu, const float* s, const float* y,
                              const float* w, const float* z,
                              const float* alpha, const float* sf2,
                              const float* kmat, const float* e0,
                              const float* r1, int n, int m, int q, int d,
                              int splits_c, int splits_m, float* dmu,
                              float* ds, float* dal, float* dy, float* a_part,
                              float* b_part, void* stream) {
  GPARML_QM_SWITCH(q, gparml::launch_bwd, mu, s, y, w, z, alpha, sf2, kmat,
                   e0, r1, n, m, q, d, splits_c, splits_m, dmu, ds, dal, dy,
                   a_part, b_part, static_cast<cudaStream_t>(stream));
}
