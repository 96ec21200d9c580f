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
// elements (Na when A and B are one tensor) and about 2 Na Nb + 3 (Na + Nb)
// f32 operations; at the query shape (Na = 64, Nb = 16, f32) that is 320
// bytes against 2,288 operations, about 7 operations a byte, under the
// card's ~20.
//
// Design: factor_stage.cuh's norms mode of the pipelined first stage: the
// warps that hold a block of P also sum the lam-weighted squares of its
// rows in registers, so the norms cost no extra read and no shuffle tree a
// tile. When the caller passes one tensor as A and B (build_factors(X, X),
// from_data) skinny_stage.cuh's symmetric P mode runs, skinny_gram's, and
// the fold reads na = nb off P's diagonal. fold.cuh's reduce_partials adds
// the partial rows in a fixed tree. No atomics.
#include "factor_stage.cuh"
#include "fold.cuh"

namespace {

template <typename TA, typename TB>
rt::StageArgs<TA, TB, TB> args(const void* A, const void* B, const float* lam,
                               int vec_lam, int na, int nb, int sym,
                               rt::i64 D) {
  return {static_cast<const TA*>(A), static_cast<const TB*>(B), nullptr, lam,
          nullptr, vec_lam, 0, na, nb, sym, 0, D};
}

}  // namespace

// A has storage dtype a_dtype, B has b_dtype; sym says that B is A (same
// pointer, shape and dtype: its rows are read once). out holds P (na*nb),
// na, nb back to back; part holds rt_split_plan(D) * (na nb + na + nb)
// floats of scratch.
RT_EXPORT int fgn_launch(int a_dtype, int b_dtype, const void* A,
                         const void* B, const float* lam,
                         long long lam_stride, int na, int nb, int sym,
                         long long D, float* part, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rt::with_types(a_dtype, b_dtype, [&](auto ta, auto tb) {
    const auto s = args<decltype(ta), decltype(tb)>(A, B, lam, lam_stride != 0,
                                                    na, nb, sym, D);
    const int err =
        sym ? rt::skinny_stage(s.A, s.B, lam, lam_stride, na, nb, 1, D, part,
                               st)
            : rt::run_stage<rt::kStageNorms>(s, part, st);
    if (err != 0) return err;
    const rt::RowLayout lay{rt::kStageNorms, na, nb, sym, 0};
    return static_cast<int>(rt::launch_reduce(part, rt::stage_plan(D).ctas,
                                              lay.stride(), lay.width(), lay,
                                              out, st));
  });
}

// Columns one ring of the stage holds for these operands on the current
// device (rt::ring_columns, or rt::p_ring_columns when B is A); v_dtype
// is not read, flags are RT_RING_*.
RT_EXPORT int rt_stage_ring(int a_dtype, int b_dtype, int v_dtype, int na,
                            int nb, int flags) {
  return rt::with_types(a_dtype, b_dtype, [&](auto ta, auto tb) {
    const auto s = args<decltype(ta), decltype(tb)>(
        nullptr, nullptr, nullptr, flags & RT_RING_VEC_LAM, na, nb, 0, 0);
    return flags & RT_RING_SYM
               ? rt::p_ring_columns(a_dtype, b_dtype, na, nb, flags)
               : rt::ring_columns<rt::kStageNorms>(s);
  });
}
