// Shared pieces of the Psi-statistics kernels (psi_fwd.cu, psi_bwd.cu).
//
// Notation (gparml_tpu/ops/psi.py, module docstring). For data row n and
// latent dimension q, with a = alpha_q:
//   Psi2 terms:  den = 2 a s_nq + 1,  c_nq = a / den,
//                lc_n = 2 log sf2 - 1/2 sum_q log den
//                log Psi2[n, m, m'] = lc_n + E0[m, m'] - sum_q c_nq (zb_q - mu_nq)^2
//                zb = (z_m + z_m') / 2,  E0 = -1/4 sum_q a (z_mq - z_m'q)^2
//   Psi1 terms:  den1 = a s_nq + 1,  c1_nq = a / den1,
//                l1_n = log sf2 - 1/2 sum_q log den1
//                log Psi1[n, m] = l1_n - 1/2 sum_q c1_nq (mu_nq - z_mq)^2
// Everything is float32 in the direct-difference form on the CUDA cores
// (plain FMA, accurate expf/logf: the build does not use fast math).
//
// The latent width Q is a template bucket QM >= Q (2, 4, 10, 16, 32, 64)
// so per-thread vectors live in registers; entries q >= Q are zero (c = 0,
// mu = 0, z = 0) and contribute exactly nothing. Each bucket has a parity
// case on the card (chip_smoke.py PARITY_CASES).
//
// Launch geometry (tile sizes, N-splits, shared memory) is decided here and
// in the launchers only; the Python wrapper asks for it through the
// gparml_psi_{fwd,bwd}_plan entry points and allocates what they report.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace gparml {

// Rows of (mu, c) staged per shared-memory chunk by the cell-major kernels.
constexpr int kRowsPsi2 = 64;
// Rows per chunk in the inducing-point-major Psi1 kernels (per-thread
// register arrays of this length).
constexpr int kRowsPsi1 = 32;

__host__ __device__ inline int qm_for(int q) {
  if (q <= 2) return 2;
  if (q <= 4) return 4;
  if (q <= 10) return 10;
  if (q <= 16) return 16;
  if (q <= 32) return 32;
  if (q <= 64) return 64;
  return 0;
}

// Dynamic shared memory of the three kinds of block: 64 staged rows of
// (mu, c) and (lc, w); 32 staged rows of those plus 32 rows of Y; and Z
// staged whole as (M, QM).
constexpr size_t smem_rows_psi2(int qm) {
  return (size_t)kRowsPsi2 * (qm + 1) * sizeof(float2);
}
constexpr size_t smem_rows_psi1(int qm, int d) {
  return (size_t)kRowsPsi1 * (qm + 1) * sizeof(float2) +
         (size_t)kRowsPsi1 * d * sizeof(float);
}
constexpr size_t smem_z(int m, int qm) {
  return (size_t)m * qm * sizeof(float);
}

// A shared-memory size as a plan entry (saturated, so it never wraps).
inline int smem_bytes(size_t bytes) {
  return (int)std::min(bytes, (size_t)0x7fffffff);
}

// Number of N-splits of a grid with blocks_per_split blocks per split:
// about eight resident blocks per SM, and at least rows_min rows a split.
inline int n_splits(int n, int blocks_per_split, int rows_min, int num_sms) {
  const int sp = (8 * num_sms + blocks_per_split - 1) / blocks_per_split;
  return std::max(1, std::min(sp, (n + rows_min - 1) / rows_min));
}

// Upper-triangle tiles of an m x m matrix in tile x tile blocks.
inline int tri_tiles(int m, int tile) {
  const int nt = (m + tile - 1) / tile;
  return nt * (nt + 1) / 2;
}

// plan[3] = the current device's opt-in shared memory per block (bytes).
inline cudaError_t smem_limit(int* plan) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(&plan[3],
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// Stage data rows [n0, min(n0 + NB, hi)) into shared memory:
//   s_mc[r * QM + k] = (mu_nk, c_nk)   (zero for k >= q and rows >= hi)
//   s_lw[r]          = (lc_n, w_n)     (w = 0 for rows >= hi)
// kden = 2, ksf = 2 gives the Psi2 terms; kden = 1, ksf = 1 the Psi1 terms.
template <int QM, int NB>
__device__ inline void stage_rows(const float* __restrict__ mu,
                                  const float* __restrict__ s,
                                  const float* __restrict__ w,
                                  const float* __restrict__ alpha,
                                  float logsf2, float kden, float ksf, int q,
                                  int n0, int hi, float2* s_mc, float2* s_lw) {
  for (int i = threadIdx.x; i < NB * QM; i += blockDim.x) {
    const int r = i / QM, k = i % QM, n = n0 + r;
    float mv = 0.f, c = 0.f;
    if (n < hi && k < q) {
      const float a = alpha[k];
      mv = mu[(size_t)n * q + k];
      c = a / (kden * a * s[(size_t)n * q + k] + 1.f);
    }
    s_mc[i] = make_float2(mv, c);
  }
  for (int r = threadIdx.x; r < NB; r += blockDim.x) {
    const int n = n0 + r;
    float lc = 0.f, wn = 0.f;
    if (n < hi) {
      float acc = 0.f;
      for (int k = 0; k < q; ++k)
        acc += logf(kden * alpha[k] * s[(size_t)n * q + k] + 1.f);
      lc = ksf * logsf2 - 0.5f * acc;
      wn = w[n];
    }
    s_lw[r] = make_float2(lc, wn);
  }
}

// Upper-triangle tile (ti <= tj) of linear index t among nt x nt tiles.
__device__ inline void upper_tile(int t, int nt, int* ti, int* tj) {
  int i = 0, rem = nt;
  while (t >= rem) {
    t -= rem;
    ++i;
    --rem;
  }
  *ti = i;
  *tj = i + t;
}

// Copy Z (m, q) into shared memory as (m, QM), zero-padded.
template <int QM>
__device__ inline void stage_z(const float* __restrict__ z, int m, int q,
                               float* zs) {
  for (int i = threadIdx.x; i < m * QM; i += blockDim.x) {
    const int j = i / QM, k = i % QM;
    zs[i] = k < q ? z[(size_t)j * q + k] : 0.f;
  }
}

// Allow a kernel more than the default 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace gparml

// Dispatch a host launcher template F<QM>(...) on the Q bucket.
#define GPARML_QM_SWITCH(q, F, ...)                   \
  switch (::gparml::qm_for(q)) {                      \
    case 2: return F<2>(__VA_ARGS__);                 \
    case 4: return F<4>(__VA_ARGS__);                 \
    case 10: return F<10>(__VA_ARGS__);               \
    case 16: return F<16>(__VA_ARGS__);               \
    case 32: return F<32>(__VA_ARGS__);               \
    case 64: return F<64>(__VA_ARGS__);               \
    default: return (int)cudaErrorInvalidValue;       \
  }
