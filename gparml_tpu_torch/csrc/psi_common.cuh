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
// Everything is float32 (accurate expf/logf: the build does not use fast
// math). The Psi1 kernels form each exponent in the direct-difference form
// on the CUDA cores; the Psi2 kernels form theirs as an expanded product on
// the tensor cores (psi_tc.cuh).
//
// Up to Q = 64 the latent width is a template bucket QM >= Q (2, 4, 10, 16,
// 32, 64) so per-thread vectors live in registers; entries q >= Q are zero
// (c = 0, mu = 0, z = 0) and contribute exactly nothing. Past Q = 64 the
// chunked kernels take any Q: the Psi1 ones walk the latent dimensions in
// chunks of kQChunk staged in shared memory, sum each exponent over the
// chunks (in the thread's own column of shared memory, or registers)
// before expf, and (backward) walk the chunks a second time for the
// per-dimension sums; the Psi2 ones walk K in chunks of kTcQChunk
// dimensions on the tensor cores (psi_tc.cuh). Registers and shared
// memory do not grow with Q, and at no Q does shared memory grow with M
// (the Q <= 64 Psi1 row pass stages Z in pieces). Each bucket, and the chunked
// kernels, have parity cases on the card (chip_smoke.py PARITY_CASES).
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
// Rows per chunk in the inducing-point-major Psi1 kernels (per-thread
// register arrays of this length).
constexpr int kRowsPsi1 = 32;
// Most rows of one N-split in the Psi1 kernels (in one launch, for the
// backward's inducing-point pass, whose registers sum them): 64 chunk sums
// into a Psi1^T Y partial row, a running sum of 2048 rows in the backward's.
constexpr int kPsi1RowsMax = 64 * kRowsPsi1;

// Latent dimensions per chunk of the chunked Psi1 kernels (Q > 64), and the
// inducing points whose exponents a row-pass thread of those kernels holds
// between its two walks over the chunks.
constexpr int kQChunk = 16;
constexpr int kGroup = 64;

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

// Dynamic shared memory of the Q <= 64 Psi1 blocks: 32 staged rows of
// (mu, c) and (lc, w) plus 32 rows of Y; and m inducing points of Z as
// (m, QM), the row pass's piece of Z.
constexpr size_t smem_rows_psi1(int qm, int d) {
  return (size_t)kRowsPsi1 * (qm + 1) * sizeof(float2) +
         (size_t)kRowsPsi1 * d * sizeof(float);
}
constexpr size_t smem_z(int m, int qm) {
  return (size_t)m * qm * sizeof(float);
}
// Most bytes of Z the Psi1 row pass stages at once, and the inducing points
// of one such piece at bucket qm: 48 KB holds M = 1228 at Q <= 10 (one
// piece at every M the repo's configurations take) and 192 inducing points
// at Q <= 64.
constexpr size_t kZPieceBytes = 48 * 1024;
__host__ __device__ constexpr int z_piece(int m, int qm) {
  return m < (int)(kZPieceBytes / (qm * sizeof(float))) ? m
                                                       : (int)(kZPieceBytes / (qm * sizeof(float)));
}
// The chunked Psi1 kernels' staging: nb rows of one chunk of (mu, c) and of
// (lc, w), plus nb rows of Y.
constexpr size_t smem_rows_chunk(int nb, int d) {
  return (size_t)nb * (kQChunk + 1) * sizeof(float2) +
         (size_t)nb * d * sizeof(float);
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

// Stage (lc_n, w_n) of rows [n0, min(n0 + NB, hi)) as s_lw[r] (w = 0 past
// hi); lc sums log den over all q in Acc. The chunked Psi1 kernels sum
// in double: at their init (s = 0.5, alpha = 1) the Q terms are equal, and
// one float32 running sum of 100 of them put every output 2.8e-5 off.
template <int NB, typename Acc = float>
__device__ inline void stage_lw(const float* __restrict__ s, Strides ls,
                                const float* __restrict__ w,
                                const float* __restrict__ alpha, float logsf2,
                                float kden, float ksf, int q, int n0, int hi,
                                float2* s_lw) {
  for (int r = threadIdx.x; r < NB; r += blockDim.x) {
    const int n = n0 + r;
    float lc = 0.f, wn = 0.f;
    if (n < hi) {
      Acc acc = 0;
      for (int k = 0; k < q; ++k)
        acc += logf(kden * alpha[k] * s[ls.at(n, k)] + 1.f);
      lc = ksf * logsf2 - 0.5f * (float)acc;
      wn = w[n];
    }
    s_lw[r] = make_float2(lc, wn);
  }
}

// Stage data rows [n0, min(n0 + NB, hi)) into shared memory:
//   s_mc[r * QM + k] = (mu_nk, c_nk)   (zero for k >= q and rows >= hi)
//   s_lw[r]          = (lc_n, w_n)     (w = 0 for rows >= hi)
// kden = 2, ksf = 2 gives the Psi2 terms; kden = 1, ksf = 1 the Psi1 terms.
template <int QM, int NB>
__device__ inline void stage_rows(const float* __restrict__ mu,
                                  const float* __restrict__ s, Strides ls,
                                  const float* __restrict__ w,
                                  const float* __restrict__ alpha,
                                  float logsf2, float kden, float ksf, int q,
                                  int n0, int hi, float2* s_mc, float2* s_lw) {
  const bool by_row = ls.rows_contiguous();
  for (int i = threadIdx.x; i < NB * QM; i += blockDim.x) {
    int r, k;
    stage_index<NB>(i, QM, by_row, &r, &k);
    const int n = n0 + r;
    float mv = 0.f, c = 0.f;
    if (n < hi && k < q) {
      const float a = alpha[k];
      mv = mu[ls.at(n, k)];
      c = a / (kden * a * s[ls.at(n, k)] + 1.f);
    }
    s_mc[r * QM + k] = make_float2(mv, c);
  }
  stage_lw<NB>(s, ls, w, alpha, logsf2, kden, ksf, q, n0, hi, s_lw);
}

// The chunked Psi1 kernels' staging: (mu, c) of rows [n0, min(n0 + NB, hi)) and
// latent dimensions [k0, k0 + kQChunk) as s_mc[r * kQChunk + k], zero for
// k0 + k >= q and rows >= hi.
template <int NB>
__device__ inline void stage_rows_chunk(const float* __restrict__ mu,
                                        const float* __restrict__ s,
                                        Strides ls,
                                        const float* __restrict__ alpha,
                                        float kden, int q, int k0, int n0,
                                        int hi, float2* s_mc) {
  const bool by_row = ls.rows_contiguous();
  for (int i = threadIdx.x; i < NB * kQChunk; i += blockDim.x) {
    int r, k;
    stage_index<NB>(i, kQChunk, by_row, &r, &k);
    const int n = n0 + r, kk = k0 + k;
    float mv = 0.f, c = 0.f;
    if (n < hi && kk < q) {
      const float a = alpha[kk];
      mv = mu[ls.at(n, kk)];
      c = a / (kden * a * s[ls.at(n, kk)] + 1.f);
    }
    s_mc[r * kQChunk + k] = make_float2(mv, c);
  }
}

// One thread's own row: (mu, c) of latent dimensions [k0, k0 + kQChunk) into
// registers (zero past q, or for a row that does not exist).
__device__ inline void load_row_chunk(const float* __restrict__ mu,
                                      const float* __restrict__ s, Strides ls,
                                      const float* __restrict__ alpha,
                                      float kden, int q, int row, bool live,
                                      int k0, float* mv, float* c) {
#pragma unroll
  for (int k = 0; k < kQChunk; ++k) {
    const int kk = k0 + k;
    mv[k] = 0.f;
    c[k] = 0.f;
    if (live && kk < q) {
      const float a = alpha[kk];
      mv[k] = mu[ls.at(row, kk)];
      c[k] = a / (kden * a * s[ls.at(row, kk)] + 1.f);
    }
  }
}

// Stage latent dimensions [k0, k0 + kQChunk) of the kGroup inducing points
// m0 + c as z_m into s_z[c * kQChunk + k]; zero for m0 + c >= m or k0 + k
// >= q.
__device__ inline void stage_group(const float* __restrict__ z, int m, int q, int m0, int k0,
                                   float* s_z) {
  for (int i = threadIdx.x; i < kGroup * kQChunk; i += blockDim.x) {
    const int mj = m0 + i / kQChunk, kk = k0 + i % kQChunk;
    s_z[i] = mj < m && kk < q ? z[(size_t)mj * q + kk] : 0.f;
  }
}

// Stage rows [n0, min(n0 + NB, hi)) of Y (N x D in strides ys) as
// s_y[r * d + j], zero past hi: the same shared layout in nq and qn.
template <int NB>
__device__ inline void stage_y(const float* __restrict__ y, Strides ys,
                               int d, int n0, int hi, float* s_y) {
  const bool by_row = ys.rows_contiguous();
  for (int i = threadIdx.x; i < NB * d; i += blockDim.x) {
    int r, j;
    stage_index<NB>(i, d, by_row, &r, &j);
    const int nn = n0 + r;
    s_y[r * d + j] = nn < hi ? y[ys.at(nn, j)] : 0.f;
  }
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
