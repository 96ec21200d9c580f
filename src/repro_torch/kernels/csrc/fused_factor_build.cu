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
// 3.35 TB/s): the FMAs cost about half of what the bytes do, so the ring
// keeps copies in flight while they run.
//
// Design: factor_stage.cuh's full mode of the pipelined first stage: A, B
// and V staged once a tile, half-warps holding an 8 x 4 block of P and the
// 4 x 8 block of C formed from the same A values, and the norm strips in
// registers. The path calls it three ways, and each stages only what it
// must read:
//   query  (Xq, Xt, Z)     A, B and V: 96 rows at (64, 16);
//   border (Xt, x, None)   V is B: B's row serves both, tv is nb;
//   bundle (Xt, Xt, G)     B is A: A's rows serve both, na = nb is P's
//                          diagonal.
// fold.cuh's reduce_partials then adds the partial rows in a fixed tree.
// No atomics.
#include "factor_stage.cuh"
#include "fold.cuh"

namespace {

template <typename TA, typename TV>
rt::StageArgs<TA, TA, TV> args(const void* A, const void* B, const void* V,
                               const float* lam, int vec_lam, const float* vs,
                               int vec_vs, int na, int nb, int sym,
                               int v_is_b, rt::i64 D) {
  return {static_cast<const TA*>(A), static_cast<const TA*>(B),
          static_cast<const TV*>(V), lam, vs, vec_lam, vec_vs, na, nb, sym,
          v_is_b, D};
}

}  // namespace

// A and B share the storage dtype ab_dtype; V has v_dtype. sym says that B
// is A, v_is_b that V is B (same pointer, shape and dtype). out holds P
// (na*nb), C (nb*na), na, nb, tv back to back; part holds rt_split_plan(D) *
// (2 na nb + na + 2 nb) floats of scratch.
RT_EXPORT int ffb_launch(int ab_dtype, int v_dtype, const void* A,
                         const void* B, const void* V, const float* lam,
                         long long lam_stride, const float* vs,
                         long long vs_stride, int na, int nb, int sym,
                         int v_is_b, long long D, float* part, float* out,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rt::with_types(ab_dtype, v_dtype, [&](auto ta, auto tv) {
    const auto s = args<decltype(ta), decltype(tv)>(
        A, B, V, lam, lam_stride != 0, vs, vs_stride != 0, na, nb, sym,
        v_is_b, D);
    const int err = rt::run_stage<rt::kStageFull>(s, part, st);
    if (err != 0) return err;
    const rt::RowLayout lay{rt::kStageFull, na, nb, sym, v_is_b};
    return static_cast<int>(rt::launch_reduce(part, rt::stage_plan(D).ctas,
                                              lay.stride(), lay.width(), lay,
                                              out, st));
  });
}

// Columns one ring of the stage holds for these operands on the current
// device (rt::ring_columns): A and B in a_dtype (b_dtype is not read), V in
// v_dtype; flags are RT_RING_*.
RT_EXPORT int rt_stage_ring(int a_dtype, int b_dtype, int v_dtype, int na,
                            int nb, int flags) {
  return rt::with_types(a_dtype, v_dtype, [&](auto ta, auto tv) {
    const auto s = args<decltype(ta), decltype(tv)>(
        nullptr, nullptr, nullptr, nullptr, flags & RT_RING_VEC_LAM, nullptr,
        flags & RT_RING_VEC_VS, na, nb, flags & RT_RING_SYM,
        flags & RT_RING_V_IS_B, 0);
    return rt::ring_columns<rt::kStageFull>(s);
  });
}
