// skinny_gram for Hopper (sm_90a): P = (A * lam) @ B^T.
//
// Replaces the TPU kernel src/repro/kernels/skinny_gram.py:28 (_kernel)
// behind skinny_gram_padded (:50). On the port's batch path it is every
// dot-kernel pairwise r (build_factors) and the m strips of the cross
// matvecs (posterior value and gradient, infer_optimum).
//
//   P (Na, Nb) = sum_d A[a, d] lam[d] B[b, d]
//
// What bounds it on an H100: bytes. Each column of D costs Na + Nb stream
// elements and about 2 Na Nb f32 operations; at the query shape (Na = 64,
// Nb = 16, f32) that is 320 bytes against 2,048 operations, about 6
// operations a byte, under the card's ~20 (67 TFLOP/s f32 over 3.35 TB/s).
//
// Design: the split-D first stage of splitk.cuh in its P-only mode (one
// slice of D per CTA, each tile of A and B read once), then
// reduce_partials adds the partial rows in CTA order. No atomics.
#include "splitk.cuh"

// A has storage dtype a_dtype, B has b_dtype. out holds P (na*nb); part
// holds rt_split_plan(D) * na * nb floats of scratch.
RT_EXPORT int sg_launch(int a_dtype, int b_dtype, const void* A,
                        const void* B, const float* lam, long long lam_stride,
                        int na, int nb, long long D, float* part, float* out,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rt::with_types(a_dtype, b_dtype, [&](auto ta, auto tb) {
    using TA = decltype(ta);
    using TB = decltype(tb);
    return rt::split_reduce<TA, TB, TB, rt::kSplitP>(
        static_cast<const TA*>(A), static_cast<const TB*>(B), nullptr, lam,
        lam_stride, nullptr, 0, na, nb, D, part, out, st);
  });
}
