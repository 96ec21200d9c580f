// fused_gram_norms for Hopper (sm_90a): P and both lam-weighted row-norm
// strips in one read of A and B.
//
// Replaces the TPU kernel src/repro/kernels/fused_gram_norms.py:22
// (_kernel) behind fused_gram_norms_padded (:49). On the port's batch path
// it is every stationary pairwise r: build_factors, gpg_refactor
// (GPGState.from_data / refactor) and the cross matvecs (posterior value
// and gradient, infer_optimum).
//
//   P  (Na, Nb) = (A * lam) @ B^T
//   na (Na,)    = sum_d A lam A        nb (Nb,) = sum_d B lam B
//
// What bounds it on an H100: bytes. Each column of D costs Na + Nb stream
// elements and about 2 Na Nb + 3 (Na + Nb) f32 operations; at the query
// shape (Na = 64, Nb = 16, f32) that is 320 bytes against 2,288
// operations, about 7 operations a byte, under the card's ~20.
//
// Design: the split-D first stage of splitk.cuh in its P-plus-norms mode:
// the warp that stages a row of a tile also folds that row's norm with a
// fixed shuffle tree, so the norms cost no extra read. reduce_partials then
// adds the partial rows (P, na, nb back to back) in CTA order. When the
// caller passes the same tensor as A and B (build_factors(X, X)) it is read
// twice; a symmetric mode is later work.
#include "splitk.cuh"

// A has storage dtype a_dtype, B has b_dtype. out holds P (na*nb), na, nb
// back to back; part holds rt_split_plan(D) * (na nb + na + nb) floats of
// scratch.
RT_EXPORT int fgn_launch(int a_dtype, int b_dtype, const void* A,
                         const void* B, const float* lam,
                         long long lam_stride, int na, int nb, long long D,
                         float* part, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rt::with_types(a_dtype, b_dtype, [&](auto ta, auto tb) {
    using TA = decltype(ta);
    using TB = decltype(tb);
    return rt::split_reduce<TA, TB, TB, rt::kSplitNorms>(
        static_cast<const TA*>(A), static_cast<const TB*>(B), nullptr, lam,
        lam_stride, nullptr, 0, na, nb, D, part, out, st);
  });
}
