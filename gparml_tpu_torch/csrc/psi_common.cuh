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
// Everything is float32 outside the float64 totals (accurate logf: the
// build does not use fast math). Both exponents are formed as expanded
// products on the tensor cores (psi_tc.cuh), shifted by exact powers of two.
//
// The latent width selects a template bucket QM >= Q (2, 4, 10, 16, 32, 64)
// up to Q = 64, so that a row's operand is built in one piece; entries
// q >= Q are zero (c = 0, mu = 0, z = 0) and contribute exactly nothing.
// Past the buckets (Q > 64 for Psi2, Q > 16 for Psi1) the kernels walk K in
// chunks of kTcQChunk latent dimensions (psi_tc.cuh), so registers and
// shared memory do not grow with Q, and at no Q does shared memory grow
// with M or (past the column passes of the Psi1 kernels) with D. Each
// bucket, and the chunked kernels, have parity cases on the card
// (chip_smoke.py PARITY_CASES).
//
// Launch geometry (tile sizes, N-splits, shared memory) is decided here and
// in the launchers only; the Python wrapper asks for it through the
// gparml_psi_{fwd,bwd}_plan entry points and allocates what they report.
//
// Two storage layouts of the N-sized arrays share one set of kernels: nq
// keeps mu, s (N, Q) and Y (N, D) row-major; qn keeps them transposed,
// mu^T, s^T (Q, N) and Y^T (D, N) (GPLVMConfig layout='qn', y_layout='dn').
// The kernels take the layout as element strides (Strides below), read only
// where rows are staged or a row's prologue and epilogue run, never in the
// (n, cell) loops; the values staged, and so every sum, are the same in
// both layouts.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace gparml {

// The rows a Psi2 N-split is counted in.
constexpr int kRowsPsi2 = 64;

// The Q bucket of q, or 0: the chunked kernels.
__host__ __device__ inline int qm_for(int q) {
  if (q <= 2) return 2;
  if (q <= 4) return 4;
  if (q <= 10) return 10;
  if (q <= 16) return 16;
  if (q <= 32) return 32;
  if (q <= 64) return 64;
  return 0;
}

// A shared-memory size as a plan entry (saturated, so it never wraps).
inline int smem_bytes(size_t bytes) {
  return (int)std::min(bytes, (size_t)0x7fffffff);
}

// Number of N-splits of a grid with blocks_per_split blocks per split:
// about eight resident blocks per SM and at least rows_min rows a split,
// but at most rows_max rows a split, so that a large N gives a grid many
// waves deep whose last wave is nearly full (on an H100 at N=1e7, M=500 the
// forward's Psi2 kernel took 2568 ms in 8 splits, 2278 ms in 153).
inline int n_splits(int n, int blocks_per_split, int rows_min, int rows_max,
                    int num_sms) {
  const int sp = (8 * num_sms + blocks_per_split - 1) / blocks_per_split;
  const int fewest = (n + rows_max - 1) / rows_max;
  return std::max({1, fewest, std::min(sp, (n + rows_min - 1) / rows_min)});
}

// splits, lowered so that the float64 partials (bytes_per_split each) take
// at most budget bytes. The kernels add a split's rows into its partial in
// float32 pieces of bounded length (a chunk of rows, a flush, or one launch
// of a grid that the launcher repeats over N), so a lowered split count
// costs time, never accuracy.
inline int cap_splits(int splits, size_t bytes_per_split, size_t budget) {
  const size_t cap = budget / bytes_per_split;
  return std::max(1, (int)std::min((size_t)splits, cap));
}

// plan[3] = the current device's opt-in shared memory per block (bytes).
inline cudaError_t smem_limit(int* plan) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(&plan[3],
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// Where element (n, k) of an N-sized array lies: at n * n_ + k * k_.
// (n_, k_) = (width, 1) in the nq layout, (1, N) in qn. Offsets are size_t:
// k * N reaches 6.4e8 at Q = 64, N = 1e7.
struct Strides {
  size_t n_, k_;
  __host__ __device__ size_t at(int n, int k) const {
    return (size_t)n * n_ + (size_t)k * k_;
  }
  // Row-major (each row contiguous), or transposed (each column).
  __host__ __device__ bool rows_contiguous() const { return k_ == 1; }
};

// The strides of an (n, width) array in the nq (qn = 0) or qn layout.
inline Strides strides_of(int qn, int n, int width) {
  return qn ? Strides{1, (size_t)n} : Strides{(size_t)width, 1};
}

// Entry i of a block's NB x W staging loop as (row r, column k): neighbouring
// threads take neighbouring k of one row where rows are contiguous, and
// neighbouring rows of one k where columns are, so the loads coalesce in
// both layouts.
template <int NB>
__device__ inline void stage_index(int i, int width, bool by_row, int* r,
                                   int* k) {
  *r = by_row ? i / width : i % NB;
  *k = by_row ? i % width : i / NB;
}

// Allow a kernel more than the default 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace gparml

// Dispatch a host launcher template F<QM>(...) on the Q bucket, and Q > 64
// to the chunked launcher FC(...).
#define GPARML_QM_SWITCH(q, F, FC, ...)               \
  switch (::gparml::qm_for(q)) {                      \
    case 2: return F<2>(__VA_ARGS__);                 \
    case 4: return F<4>(__VA_ARGS__);                 \
    case 10: return F<10>(__VA_ARGS__);               \
    case 16: return F<16>(__VA_ARGS__);               \
    case 32: return F<32>(__VA_ARGS__);               \
    case 64: return F<64>(__VA_ARGS__);               \
    default: return FC(__VA_ARGS__);                  \
  }
