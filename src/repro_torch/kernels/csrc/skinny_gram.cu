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
// elements (Na when A and B are one tensor) and about 2 Na Nb f32
// operations; at the query shape (Na = 64, Nb = 16, f32) that is 320 bytes
// against 2,048 operations, about 6 operations a byte, under the card's
// ~20 (67 TFLOP/s f32 over 3.35 TB/s).
//
// Design: skinny_stage.cuh's pipelined first stage (one slice of D per
// CTA, a persistent grid sized to the device, a cp.async ring that keeps
// loads in flight while the FMAs run, each tile of A and B read once, and
// A's rows alone when the caller passes one tensor as A and B), then
// fold.cuh's reduce_partials adds the partial rows in a fixed tree. No
// atomics.
#include "fold.cuh"
#include "skinny_stage.cuh"

// A has storage dtype a_dtype, B has b_dtype; sym says that B is A (same
// pointer, shape and dtype: its rows are read once). out holds P (na*nb);
// part holds rt_split_plan(D) * na * nb floats of scratch.
RT_EXPORT int sg_launch(int a_dtype, int b_dtype, const void* A,
                        const void* B, const float* lam, long long lam_stride,
                        int na, int nb, int sym, long long D, float* part,
                        float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rt::with_types(a_dtype, b_dtype, [&](auto ta, auto tb) {
    using TA = decltype(ta);
    using TB = decltype(tb);
    const int err = rt::skinny_stage<TA, TB>(
        static_cast<const TA*>(A), static_cast<const TB*>(B), lam, lam_stride,
        na, nb, sym, D, part, st);
    if (err != 0) return err;
    return static_cast<int>(
        rt::launch_reduce(part, rt::stage_plan(D).ctas, na * nb, out, st));
  });
}

// Columns one ring of the stage holds for these operands on the current
// device (rt::p_ring_columns); v_dtype is not read, flags are RT_RING_*.
RT_EXPORT int rt_stage_ring(int a_dtype, int b_dtype, int v_dtype, int na,
                            int nb, int flags) {
  return rt::p_ring_columns(a_dtype, b_dtype, na, nb, flags);
}
