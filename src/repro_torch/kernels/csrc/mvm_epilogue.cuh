// The O(N^2) middle of the Alg.-2 Gram MVM: reduce the per-CTA partials
// of M_r = (Xt*lam) V_r^T in CTA order, then fold Alg. 2's small matrix
//
//   dot:         small_r = K2e * M_r
//   stationary:  small_r = diag(rowsum(Mt)) - Mt,  Mt = K2e * (M_r - diag(M_r)[None, :])
//
// in one CTA per right-hand side r (gridDim.x = R), entirely in shared
// memory. This is the TPU kernel's _small_from_m epilogue; it runs between
// the two D-streams. A partial row holds the (n, R*n) product of Xt with
// the stacked V, so M_r is its column block [r*n, (r+1)*n).
#pragma once

#include "common.cuh"

namespace rt {

__host__ __device__ inline i64 mvm_small_smem_bytes(int n) {
  return 2LL * n * n * (i64)sizeof(float);
}

__global__ void __launch_bounds__(256)
    mvm_small(const float* __restrict__ part, int G, int n,
              const float* __restrict__ K2e, int stationary,
              float* __restrict__ small) {
  extern __shared__ float smem[];
  const int nn = n * n, r = blockIdx.x, ldp = gridDim.x * n;
  const int pstride = n * ldp;  // floats in one CTA's partial row
  float* sM = smem;       // [n][n]
  float* sT = smem + nn;  // [n][n]
  small += (i64)r * nn;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int at = (e / n) * ldp + r * n + e % n;  // M_r[e] in a row
    float s = 0.f;
#pragma unroll 8
    for (int g = 0; g < G; ++g) s += part[(i64)g * pstride + at];
    sM[e] = s;
  }
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
