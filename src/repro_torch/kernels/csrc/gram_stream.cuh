// The output stream W = (K1 @ (V*vs) + M @ X) * lam + noise * V.
//
// K1 and M are small (Nq, N) f32 matrices, staged in shared memory
// transposed so that four output rows of one coefficient column are one
// 16-byte load. Each thread owns one column d of the D axis: it stages its
// N values of V and X, then writes the Nq outputs of that column. There is
// no reduction over D, so CTAs never meet: one read of V and X and one
// write of W, which is the least traffic the function allows.
#pragma once

#include "common.cuh"

namespace rt {

constexpr int kStreamRows = 4;  // output rows per register block

__host__ __device__ inline int stream_ldq(int nq) {
  return (nq + kStreamRows - 1) / kStreamRows * kStreamRows;
}

__host__ __device__ inline i64 stream_smem_bytes(int nq, int n, int cols) {
  return (2LL * n * stream_ldq(nq) + 2LL * n * cols) * (i64)sizeof(float);
}

// Widest block (columns = threads) whose staging fits the shared-memory
// budget; 0 when even 32 columns do not fit.
inline int stream_cols(int nq, int n) {
  for (int cols = 256; cols >= 32; cols /= 2)
    if (stream_smem_bytes(nq, n, cols) <= kSmemBytes) return cols;
  return 0;
}

// V and X may each be f32 or bf16 storage.
// noise != 0 requires nq == n (the ridge adds V row q to output row q).
template <typename TV, typename TX>
__global__ void __launch_bounds__(256)
    gram_stream(const float* __restrict__ K1, const float* __restrict__ M,
                const TV* __restrict__ V, const TX* __restrict__ X,
                const float* __restrict__ lam, i64 lam_stride,
                const float* __restrict__ vs, i64 vs_stride, float noise,
                int nq, int n, i64 D, float* __restrict__ W) {
  extern __shared__ float smem[];
  const int cols = blockDim.x, tid = threadIdx.x;
  const int ldq = stream_ldq(nq);
  float* sK = smem;           // [n][ldq]  K1 transposed, zero-padded rows
  float* sM = sK + n * ldq;   // [n][ldq]  M transposed
  float* sV = sM + n * ldq;   // [n][cols]
  float* sX = sV + n * cols;  // [n][cols]

  for (int e = tid; e < n * ldq; e += cols) {
    const int k = e / ldq, q = e % ldq;
    sK[e] = q < nq ? K1[q * n + k] : 0.f;
    sM[e] = q < nq ? M[q * n + k] : 0.f;
  }
  const i64 d = (i64)blockIdx.x * cols + tid;
  const bool ok = d < D;
#pragma unroll 8
  for (int k = 0; k < n; ++k) {
    sV[k * cols + tid] = ok ? to_f32(V[(i64)k * D + d]) : 0.f;
    sX[k * cols + tid] = ok ? to_f32(X[(i64)k * D + d]) : 0.f;
  }
  __syncthreads();
  if (!ok) return;

  const float l = lam[d * lam_stride];
  const float s = lane_factor(vs, vs_stride, d);
  for (int q0 = 0; q0 < nq; q0 += kStreamRows) {
    float a1[kStreamRows] = {0.f, 0.f, 0.f, 0.f};
    float a2[kStreamRows] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < n; ++k) {
      const float v = sV[k * cols + tid], x = sX[k * cols + tid];
      const float4 kk = *reinterpret_cast<const float4*>(sK + k * ldq + q0);
      const float4 mm = *reinterpret_cast<const float4*>(sM + k * ldq + q0);
      a1[0] = fmaf(kk.x, v, a1[0]);
      a1[1] = fmaf(kk.y, v, a1[1]);
      a1[2] = fmaf(kk.z, v, a1[2]);
      a1[3] = fmaf(kk.w, v, a1[3]);
      a2[0] = fmaf(mm.x, x, a2[0]);
      a2[1] = fmaf(mm.y, x, a2[1]);
      a2[2] = fmaf(mm.z, x, a2[2]);
      a2[3] = fmaf(mm.w, x, a2[3]);
    }
#pragma unroll
    for (int i = 0; i < kStreamRows; ++i) {
      const int q = q0 + i;
      if (q >= nq) break;
      float w = fmaf(s, a1[i], a2[i]) * l;
      if (noise != 0.f) w = fmaf(noise, sV[q * cols + tid], w);
      W[(i64)q * D + d] = w;
    }
  }
}

}  // namespace rt
