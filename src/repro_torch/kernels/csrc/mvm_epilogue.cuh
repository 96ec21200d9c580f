// The O(N^2) middle of the Alg.-2 Gram MVM: reduce the per-CTA partials
// of M = (Xt*lam) V^T in CTA order, then fold Alg. 2's small matrix
//
//   dot:         small = K2e * M
//   stationary:  small = diag(rowsum(Mt)) - Mt,  Mt = K2e * (M - diag(M)[None, :])
//
// in one CTA, entirely in shared memory. This is the TPU kernel's
// _small_from_m epilogue; it runs between the two D-streams.
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
  const int nn = n * n;
  float* sM = smem;       // [n][n]
  float* sT = smem + nn;  // [n][n]
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    float s = 0.f;
#pragma unroll 8
    for (int g = 0; g < G; ++g) s += part[(i64)g * nn + e];
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
