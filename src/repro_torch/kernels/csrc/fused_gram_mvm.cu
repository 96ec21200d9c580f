// fused_gram_mvm for Hopper (sm_90a): the whole Alg.-2 Gram MVM of R
// stacked right-hand sides V (R, N, D) against one set of factors
// (R = 1 for a single V),
//
//   W_r = (K1e @ V_r + small_r @ Xt) * lam + noise * V_r
//   dot:         small_r = K2e * M_r
//   stationary:  small_r = diag(rowsum(Mt)) - Mt,  Mt = K2e * (M_r - diag(M_r)[None, :])
//   with M_r = (Xt * lam) @ V_r^T.
//
// Replaces two TPU kernels: src/repro/kernels/fused_gram_mvm.py:73
// (_kernel), its _small_from_m epilogue (:59) and fused_gram_mvm_padded
// (:121), which carry every CG iteration of extend, evict and resolve; and
// the stacked src/repro/kernels/fused_gram_mvm.py:138 (_kernel_multi)
// behind fused_gram_mvm_multi_padded (:193), which carries every iteration
// of gram_cg_solve_multi.
//
// What bounds it on an H100: bytes. The function reads Xt once and the R
// blocks of V, and writes the R blocks of W: (1 + 2R) N elements a column
// for about 6 R N^2 f32 operations; at N = 16, f32 that is 8 operations a
// byte for R = 1 and about 11 for R = 4, under the card's ~20. This kernel
// moves (2 + 3R) N elements a column, since each phase reads Xt and V
// again.
//
// Design: the TPU kernel's two-phase grid with a resident M becomes three
// launches in one stream, so stream order is the phase barrier:
//   1. skinny_stage.cuh's pipelined first stage with A = Xt and B = V seen
//      as one (R*N, D) matrix: per-CTA partials of the (N, R*N) product
//      [M_0 ... M_{R-1}], each tile of Xt read once for all R, with loads
//      in flight while the FMAs run (the stage the first version lost most
//      of its time in);
//   2. mvm_small, one CTA per r: the partials of M_r added in a fixed tree
//      spread over the CTA, then small_r folded in shared memory;
//   3. gram_stream with R stacked outputs: each thread stages its column
//      of Xt once and of every V_r, and writes W_r for all r.
// The shared-memory budget bounds R * N^2 (all small_r sit in every CTA of
// the output stream); past it the launcher refuses the shape. The kernel
// still reads Xt and V twice, once in phase 1 and once in phase 3; a
// cooperative single launch with a grid barrier is later work.
#include "gram_stream.cuh"
#include "mvm_epilogue.cuh"
#include "skinny_stage.cuh"

namespace {

template <typename TX, typename TV>
int launch(const float* K1e, const float* K2e, const TX* Xt, const TV* V,
           const float* lam, rt::i64 lam_stride, float noise, int stationary,
           int R, int n, rt::i64 D, float* part, float* small, float* W,
           int phases, cudaStream_t stream) {
  const rt::i64 small_smem = rt::mvm_small_smem_bytes(n);
  const int cols = rt::stream_cols(n, n, R, true);
  if (R < 1 || small_smem > rt::kSmemBytes || cols == 0 ||
      rt::stage_shape<TX, TV>(n, R * n, false, lam_stride != 0).sw == 0)
    return RT_BAD_SHAPE;
  if (phases & 1) {
    const int err = rt::skinny_stage<TX, TV>(Xt, V, lam, lam_stride, n,
                                             R * n, 0, D, part, stream);
    if (err != 0) return err;
  }
  if (phases & 2) {
    rt::mvm_small<<<R, rt::kFoldThreads, small_smem, stream>>>(
        part, rt::stage_plan(D).ctas, n, K2e, stationary, small);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (!(phases & 4)) return 0;
  const rt::i64 blocks = (D + cols - 1) / cols;
  const rt::i64 smem = rt::stream_smem_bytes(n, n, cols, R, true);
  if (R == 1)
    rt::gram_stream<TV, TX, true, 1><<<blocks, cols, smem, stream>>>(
        K1e, small, V, Xt, lam, lam_stride, nullptr, 0, noise, 1, n, n, D, W);
  else
    rt::gram_stream<TV, TX, true, 0><<<blocks, cols, smem, stream>>>(
        K1e, small, V, Xt, lam, lam_stride, nullptr, 0, noise, R, n, n, D, W);
  return cudaGetLastError();
}

}  // namespace

// Xt (n, D) has storage dtype x_dtype, V (R, n, D) has v_dtype. part holds
// rt_split_plan(D) * R * n * n floats of scratch, small R * n * n floats.
// phases is a mask of the launches to make, in stream order: 1 the first
// stage, 2 the fold, 4 the output stream (7 for the product; one phase
// alone times that launch on buffers an earlier call filled). Returns
// RT_BAD_SHAPE when a phase's staging does not fit the shared-memory
// budget, else the launches' CUDA error code.
RT_EXPORT int fgm_launch(int x_dtype, int v_dtype, const float* K1e,
                         const float* K2e, const void* Xt, const void* V,
                         const float* lam, long long lam_stride, float noise,
                         int stationary, int R, int n, long long D,
                         float* part, float* small, float* W, int phases,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rt::with_types(x_dtype, v_dtype, [&](auto tx, auto tv) {
    return launch(K1e, K2e, static_cast<const decltype(tx)*>(Xt),
                  static_cast<const decltype(tv)*>(V), lam, lam_stride, noise,
                  stationary, R, n, D, part, small, W, phases, st);
  });
}

// Columns one ring of the first stage holds for Xt (a_dtype, n rows) and
// the stacked V (b_dtype, R*n rows) on the current device
// (rt::p_ring_columns); v_dtype is not read, flags are RT_RING_*.
RT_EXPORT int rt_stage_ring(int a_dtype, int b_dtype, int v_dtype, int na,
                            int nb, int flags) {
  return rt::p_ring_columns(a_dtype, b_dtype, na, nb, flags);
}
