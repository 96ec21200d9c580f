// fused_factor_build for Hopper (sm_90a): P, na, nb, C and tv in one read
// of A, B and V.
//
// Replaces the TPU kernel src/repro/kernels/fused_factor_build.py:49
// (_kernel) behind fused_factor_build_padded (:91).
//
//   P  (Na, Nb) = (A * lam) @ B^T       na (Na,) = sum_d A lam A
//   C  (Nb, Na) = (V * vs) @ A^T        nb (Nb,) = sum_d B lam B
//                                       tv (Nb,) = sum_d B lam V
//
// What bounds it on an H100: bytes. Each column of D costs (Na + 2 Nb)
// stream elements and about 4 Na Nb f32 operations; at the query shape
// (Na = 64, Nb = 16, f32) that is 384 bytes against 4,096 operations, about
// 11 operations a byte, under the card's ~20 (67 TFLOP/s f32 over
// 3.35 TB/s).
//
// Design: the TPU kernel's resident accumulators become two launches.
// split_partials (splitk.cuh) gives every CTA one slice of D; it reads its
// slice of A, B and V once, tile by tile, and writes one f32 partial row.
// reduce_partials adds the rows in CTA order. Both stages are plain f32
// CUDA-core code; wgmma and TMA are later work.
#include "splitk.cuh"

// A and B share the storage dtype ab_dtype; V has v_dtype. out holds P
// (na*nb), C (nb*na), na, nb, tv back to back; part holds
// rt_split_plan(D) * (2 na nb + na + 2 nb) floats of scratch.
RT_EXPORT int ffb_launch(int ab_dtype, int v_dtype, const void* A,
                         const void* B, const void* V, const float* lam,
                         long long lam_stride, const float* vs,
                         long long vs_stride, int na, int nb, long long D,
                         float* part, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rt::with_types(ab_dtype, v_dtype, [&](auto ta, auto tv) {
    using TA = decltype(ta);
    using TV = decltype(tv);
    return rt::split_reduce<TA, TA, TV, rt::kSplitFull>(
        static_cast<const TA*>(A), static_cast<const TA*>(B),
        static_cast<const TV*>(V), lam, lam_stride, vs, vs_stride, na, nb, D,
        part, out, st);
  });
}
