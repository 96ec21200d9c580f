// The O(N^2) middle of the Alg.-2 Gram MVM: reduce the per-CTA partials
// of M_r = (Xt*lam) V_r^T, then fold Alg. 2's small matrix
//
//   dot:         small_r = K2e * M_r
//   stationary:  small_r = diag(rowsum(Mt)) - Mt,  Mt = K2e * (M_r - diag(M_r)[None, :])
//
// in one CTA per right-hand side r (gridDim.x = R), entirely in shared
// memory. This is the TPU kernel's _small_from_m epilogue; it runs between
// the two D-streams. A partial row holds the (n, R*n) product of Xt with
// the stacked V, so M_r is its column block [r*n, (r+1)*n).
//
// The partials are added by fold.cuh's fold_entries over all kFoldThreads
// threads of the CTA (kFoldThreads / n^2 runs an entry), so that many
// loads are in flight: a fixed tree, the same bits on every run.
#pragma once

#include "common.cuh"
#include "fold.cuh"

namespace rt {

constexpr int kFoldThreads = 1024;

// M_r, Mt and the runs' sums (kFoldThreads floats, used when n*n leaves
// room for two or more runs per entry).
__host__ __device__ inline i64 mvm_small_smem_bytes(int n) {
  return (2LL * n * n + kFoldThreads) * (i64)sizeof(float);
}

__global__ void __launch_bounds__(kFoldThreads)
    mvm_small(const float* __restrict__ part, int G, int n,
              const float* __restrict__ K2e, int stationary,
              float* __restrict__ small) {
  extern __shared__ float smem[];
  const int nn = n * n, r = blockIdx.x, ldp = gridDim.x * n;
  const int pstride = n * ldp;  // floats in one CTA's partial row
  float* sM = smem;             // [n][n]
  float* sT = smem + nn;        // [n][n]
  float* sRun = sT + nn;        // [kFoldThreads] the runs' sums
  small += (i64)r * nn;
  // M_r[e] sits at column r*n + e%n of row e/n of a partial row
  const auto at = [=](int e) { return (e / n) * ldp + r * n + e % n; };
  fold_entries(part, pstride, G, nn, at, sRun, sM);
  __syncthreads();
  if (!stationary) {
    for (int e = threadIdx.x; e < nn; e += blockDim.x) small[e] = K2e[e] * sM[e];
    return;
  }
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int b = e % n;
    sT[e] = K2e[e] * (sM[e] - sM[b * n + b]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int a = e / n, b = e % n;
    float v = -sT[e];
    if (a == b) {
      float rs = 0.f;
      for (int c = 0; c < n; ++c) rs += sT[a * n + c];
      v += rs;
    }
    small[e] = v;
  }
}

}  // namespace rt
