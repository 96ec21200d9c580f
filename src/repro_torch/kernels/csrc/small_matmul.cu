// small_matmul for Hopper (sm_90a): W = (K @ V) * scale.
//
// Replaces the TPU kernel src/repro/kernels/gram_update.py:50
// (_small_matmul_kernel) behind small_matmul_padded (:72). On the port's
// path it is the Kronecker preconditioner B^-1 vec(V) = (K1^-1 @ V) / lam
// of every CG iteration (gram_cg_solve and the state's warm-started
// re-solve), with scale = 1/lam.
//
// What bounds it on an H100: bytes. Each column of D reads N stream
// elements and writes Nq f32 outputs for 2 Nq N + Nq f32 operations; at
// (16, 16) that is 128 bytes against 528 operations, about 4 operations a
// byte, under the card's ~20.
//
// Design: the output stream of gram_stream.cuh built without its X stream:
// K (Nq, N) sits in shared memory and each thread owns one column, so V is
// read once and W written once, with the per-lane scale fused into the
// store. No reduction over D, so no partials. K may be rectangular.
#include "gram_stream.cuh"

namespace {

template <typename TV>
int launch(const float* K, const void* V, const float* scale,
           rt::i64 scale_stride, int nq, int n, rt::i64 D, float* W,
           cudaStream_t stream) {
  const int cols = rt::stream_cols(nq, n, 1, false);
  if (cols == 0) return RT_BAD_SHAPE;
  const rt::i64 blocks = (D + cols - 1) / cols;
  rt::gram_stream<TV, float, false, 1>
      <<<blocks, cols, rt::stream_smem_bytes(nq, n, cols, 1, false),
         stream>>>(K, nullptr, static_cast<const TV*>(V), nullptr, scale,
                   scale_stride, nullptr, 0, 0.f, 1, nq, n, D, W);
  return cudaGetLastError();
}

}  // namespace

// V has storage dtype v_dtype; scale is a scalar (stride 0) or (D,)
// (stride 1) f32 factor.
RT_EXPORT int sm_launch(int v_dtype, const float* K, const void* V,
                        const float* scale, long long scale_stride, int nq,
                        int n, long long D, float* W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rt::with_types(v_dtype, RT_F32, [&](auto tv, auto) {
    return launch<decltype(tv)>(K, V, scale, scale_stride, nq, n, D, W, st);
  });
}
