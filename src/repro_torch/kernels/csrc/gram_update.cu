// gram_update for Hopper (sm_90a): W = (K1 @ (V*vs) + M @ X) * lam + noise*V.
//
// Replaces the TPU kernel src/repro/kernels/gram_update.py:36 (_kernel)
// behind gram_update_padded (:104). On the port's path it is the gradient
// stream of every query microbatch: K1, M (64, 16), V = Z and X = Xt
// (16, D), W (64, D).
//
// What bounds it on an H100: bytes. Each column of D reads 2 N stream
// elements and writes Nq f32 outputs for about 4 Nq N f32 operations; at
// the query shape that is 384 bytes against 4,096 operations, about 11
// operations a byte, under the card's ~20.
//
// Design: a pure stream with no reduction over D (gram_stream.cuh). K1 and
// M sit in shared memory; each thread owns one column and writes its Nq
// outputs, so V and X are read once and W written once.
#include "gram_stream.cuh"

namespace {

template <typename TV, typename TX>
int launch(const float* K1, const float* M, const void* V, const void* X,
           const float* lam, rt::i64 lam_stride, const float* vs,
           rt::i64 vs_stride, float noise, int nq, int n, rt::i64 D, float* W,
           cudaStream_t stream) {
  const int cols = rt::stream_cols(nq, n, 1, true);
  if (cols == 0 || (noise != 0.f && nq != n)) return RT_BAD_SHAPE;
  const rt::i64 blocks = (D + cols - 1) / cols;
  rt::gram_stream<TV, TX, true, 1>
      <<<blocks, cols, rt::stream_smem_bytes(nq, n, cols, 1, true), stream>>>(
          K1, M, static_cast<const TV*>(V), static_cast<const TX*>(X), lam,
          lam_stride, vs, vs_stride, noise, 1, nq, n, D, W);
  return cudaGetLastError();
}

}  // namespace

// V has storage dtype v_dtype, X has x_dtype; vs may be null (no
// pre-scale of V).
RT_EXPORT int gu_launch(int v_dtype, int x_dtype, const float* K1,
                        const float* M, const void* V, const void* X,
                        const float* lam, long long lam_stride,
                        const float* vs, long long vs_stride, float noise,
                        int nq, int n, long long D, float* W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rt::with_types(v_dtype, x_dtype, [&](auto tv, auto tx) {
    return launch<decltype(tv), decltype(tx)>(K1, M, V, X, lam, lam_stride,
                                              vs, vs_stride, noise, nq, n, D,
                                              W, st);
  });
}
