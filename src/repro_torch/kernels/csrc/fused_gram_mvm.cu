// fused_gram_mvm for Hopper (sm_90a): the whole Alg.-2 Gram MVM
//
//   W = (K1e @ V + small @ Xt) * lam + noise * V
//   dot:         small = K2e * M
//   stationary:  small = diag(rowsum(Mt)) - Mt,  Mt = K2e * (M - diag(M)[None, :])
//   with M = (Xt * lam) @ V^T.
//
// Replaces the TPU kernel src/repro/kernels/fused_gram_mvm.py:73 (_kernel),
// its _small_from_m epilogue (:59) and fused_gram_mvm_padded (:121). It
// carries every CG iteration of extend, evict and resolve.
//
// What bounds it on an H100: bytes. The function reads Xt and V and writes
// W, 3 N elements a column, for about 6 N^2 f32 operations; at N = 16,
// f32, that is 192 bytes against 1,536 operations, 8 operations a byte,
// under the card's ~20. This kernel moves 5 N elements a column, since
// each phase reads Xt and V again.
//
// Design: the TPU kernel's two-phase grid with a resident M becomes three
// launches in one stream, so stream order is the phase barrier:
//   1. split_partials (P only): per-CTA partials of M over slices of D;
//   2. mvm_small: one CTA adds the partials in CTA order and folds small;
//   3. gram_stream: the output stream of phase 1.
// A cooperative single launch with a grid barrier is later work.
#include "gram_stream.cuh"
#include "mvm_epilogue.cuh"
#include "splitk.cuh"

namespace {

template <typename TX, typename TV>
int launch(const float* K1e, const float* K2e, const void* Xt, const void* V,
           const float* lam, rt::i64 lam_stride, float noise, int stationary,
           int n, rt::i64 D, float* part, float* small, float* W,
           cudaStream_t stream) {
  const rt::i64 split_smem = rt::split_smem_bytes(n, n);
  const rt::i64 small_smem = rt::mvm_small_smem_bytes(n);
  const int cols = rt::stream_cols(n, n);
  if (split_smem > rt::kSmemBytes || small_smem > rt::kSmemBytes || cols == 0)
    return RT_BAD_SHAPE;
  const TX* x = static_cast<const TX*>(Xt);
  const TV* v = static_cast<const TV*>(V);
  const rt::SplitPlan plan = rt::split_plan(D);
  rt::split_partials<TX, TV, TV, false>
      <<<plan.ctas, rt::kSplitThreads, split_smem, stream>>>(
          x, v, v, lam, lam_stride, nullptr, 0, n, n, D, plan.chunk, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rt::mvm_small<<<1, 256, small_smem, stream>>>(part, plan.ctas, n, K2e,
                                                stationary, small);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const rt::i64 blocks = (D + cols - 1) / cols;
  rt::gram_stream<TV, TX><<<blocks, cols, rt::stream_smem_bytes(n, n, cols),
                            stream>>>(K1e, small, v, x, lam, lam_stride,
                                      nullptr, 0, noise, n, n, D, W);
  return cudaGetLastError();
}

}  // namespace

// Xt has storage dtype x_dtype, V has v_dtype. part holds
// rt_split_plan(D) * n * n floats of scratch, small n * n floats.
RT_EXPORT int fgm_launch(int x_dtype, int v_dtype, const float* K1e,
                         const float* K2e, const void* Xt, const void* V,
                         const float* lam, long long lam_stride, float noise,
                         int stationary, int n, long long D, float* part,
                         float* small, float* W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rt::with_types(x_dtype, v_dtype, [&](auto tx, auto tv) {
    return launch<decltype(tx), decltype(tv)>(K1e, K2e, Xt, V, lam,
                                              lam_stride, noise, stationary,
                                              n, D, part, small, W, st);
  });
}

RT_EXPORT const char* rt_error_string(int code) {
  return code == RT_BAD_SHAPE ? "shape or dtype not supported by the kernel"
                              : cudaGetErrorString(static_cast<cudaError_t>(code));
}
