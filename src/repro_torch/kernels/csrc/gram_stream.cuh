// The output stream W_r = (K1 @ (V_r*vs) + M_r @ X) * lam + noise * V_r,
// for r = 0 .. R-1 stacked right-hand sides (R = 1 but for the multi-RHS
// Gram MVM), or W = (K1 @ V) * lam alone when the kernel is built without
// the X stream (small_matmul).
//
// K1 (Nq, N) and M (R, Nq, N) are small f32 matrices, staged in shared
// memory transposed so that four output rows of one coefficient column are
// one 16-byte load. Each thread owns one column d of the D axis: it stages
// its N values of X and R*N values of V, then writes the R*Nq outputs of
// that column. There is no reduction over D, so CTAs never meet: one read
// of V and X (X once for all R) and one write of W, which is the least
// traffic the function allows.
#pragma once

#include "common.cuh"

namespace rt {

constexpr int kStreamRows = 4;  // output rows per register block

__host__ __device__ inline int stream_ldq(int nq) {
  return (nq + kStreamRows - 1) / kStreamRows * kStreamRows;
}

// K1 and each M_r are (n, ldq) in shared memory; V_r and X are (n, cols).
__host__ __device__ inline i64 stream_smem_bytes(int nq, int n, int cols,
                                                 int R, bool with_x) {
  const i64 mats = 1 + (with_x ? R : 0), rows = R + (with_x ? 1 : 0);
  return (mats * n * stream_ldq(nq) + rows * n * cols) * (i64)sizeof(float);
}

// Widest block (columns = threads) whose staging fits the shared-memory
// budget; 0 when even 32 columns do not fit.
inline int stream_cols(int nq, int n, int R, bool with_x) {
  for (int cols = 256; cols >= 32; cols /= 2)
    if (stream_smem_bytes(nq, n, cols, R, with_x) <= kSmemBytes) return cols;
  return 0;
}

// V and X may each be f32 or bf16 storage; V, M and W are stacked over R
// with strides n*D, nq*n and nq*D. Without WITH_X, M and X are not read.
// noise != 0 requires nq == n (the ridge adds V_r row q to output row q).
// FIXED_R > 0 fixes R at compile time (the argument is then ignored), so
// a single right-hand side compiles without the loop over r; and each
// k-step issues its shared-memory loads before its FMAs. On an H100 both
// choices move the stream's time by several percent.
template <typename TV, typename TX, bool WITH_X, int FIXED_R>
__global__ void __launch_bounds__(256)
    gram_stream(const float* __restrict__ K1, const float* __restrict__ M,
                const TV* __restrict__ V, const TX* __restrict__ X,
                const float* __restrict__ lam, i64 lam_stride,
                const float* __restrict__ vs, i64 vs_stride, float noise,
                int R_arg, int nq, int n, i64 D, float* __restrict__ W) {
  const int R = FIXED_R > 0 ? FIXED_R : R_arg;
  extern __shared__ float smem[];
  const int cols = blockDim.x, tid = threadIdx.x;
  const int ldq = stream_ldq(nq);
  float* sK = smem;                               // [n][ldq] K1 transposed
  float* sM = sK + n * ldq;                       // [R][n][ldq] M_r transposed
  float* sV = sM + (WITH_X ? R * n * ldq : 0);    // [R][n][cols]
  float* sX = sV + R * n * cols;                  // [n][cols]

  for (int e = tid; e < n * ldq; e += cols) {
    const int k = e / ldq, q = e % ldq;
    sK[e] = q < nq ? K1[q * n + k] : 0.f;
    if (WITH_X) sM[e] = q < nq ? M[q * n + k] : 0.f;
  }
  if (WITH_X) {
    for (int e = n * ldq + tid; e < R * n * ldq; e += cols) {
      const int r = e / (n * ldq), k = (e / ldq) % n, q = e % ldq;
      sM[e] = q < nq ? M[((i64)r * nq + q) * n + k] : 0.f;
    }
  }
  const i64 d = (i64)blockIdx.x * cols + tid;
  const bool ok = d < D;
  // X is staged beside V_0 (two loads in flight an iteration), then the
  // rows of V_1 .. V_{R-1}.
#pragma unroll 8
  for (int k = 0; k < n; ++k) {
    sV[k * cols + tid] = ok ? to_f32(V[(i64)k * D + d]) : 0.f;
    if (WITH_X) sX[k * cols + tid] = ok ? to_f32(X[(i64)k * D + d]) : 0.f;
  }
#pragma unroll 8
  for (int k = n; k < R * n; ++k)
    sV[k * cols + tid] = ok ? to_f32(V[(i64)k * D + d]) : 0.f;
  __syncthreads();
  if (!ok) return;

  const float l = lam[d * lam_stride];
  const float s = lane_factor(vs, vs_stride, d);
  for (int r = 0; r < R; ++r) {
    const float* sVr = sV + r * n * cols;
    const float* sMr = sM + r * n * ldq;
    float* Wr = W + (i64)r * nq * D;
    for (int q0 = 0; q0 < nq; q0 += kStreamRows) {
      float a1[kStreamRows] = {0.f, 0.f, 0.f, 0.f};
      float a2[kStreamRows] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < n; ++k) {
        const float v = sVr[k * cols + tid];
        const float x = WITH_X ? sX[k * cols + tid] : 0.f;
        const float4 kk = *reinterpret_cast<const float4*>(sK + k * ldq + q0);
        const float4 mm =
            WITH_X ? *reinterpret_cast<const float4*>(sMr + k * ldq + q0)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
        a1[0] = fmaf(kk.x, v, a1[0]);
        a1[1] = fmaf(kk.y, v, a1[1]);
        a1[2] = fmaf(kk.z, v, a1[2]);
        a1[3] = fmaf(kk.w, v, a1[3]);
        if (WITH_X) {
          a2[0] = fmaf(mm.x, x, a2[0]);
          a2[1] = fmaf(mm.y, x, a2[1]);
          a2[2] = fmaf(mm.z, x, a2[2]);
          a2[3] = fmaf(mm.w, x, a2[3]);
        }
      }
#pragma unroll
      for (int i = 0; i < kStreamRows; ++i) {
        const int q = q0 + i;
        if (q >= nq) break;
        float w = fmaf(s, a1[i], a2[i]) * l;
        if (noise != 0.f) w = fmaf(noise, sVr[q * cols + tid], w);
        Wr[(i64)q * D + d] = w;
      }
    }
  }
}

}  // namespace rt
