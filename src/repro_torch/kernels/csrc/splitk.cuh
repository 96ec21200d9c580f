// Split-D reductions: the first stage of the sums over D that also fold
// row norms (fused_gram_norms, fused_factor_build). The P-only stage of
// skinny_gram and the Gram MVMs is skinny_stage.cuh.
//
// On the TPU one grid walked D in order and kept an f32 accumulator
// resident in VMEM. Hopper runs its CTAs at the same time, so here CTA c
// reduces its own slice of columns [c*chunk, min(D, (c+1)*chunk)) into an
// f32 partial row, and a second launch (fold.cuh's reduce_partials) adds
// the partial rows in a fixed tree.
// No atomics: the result is the same bits on every run.
//
// Per tile of kTileD columns, one warp per matrix row loads the tile into
// shared memory (lane = column, so the global reads coalesce; a warp has
// up to kLoadRows rows in flight) and, where the mode asks, folds the
// row's lam-weighted norms with a fixed shuffle tree.
// Then every thread accumulates kRowsPerThread entries of the skinny
// products in registers. When there are fewer products than threads the
// CTA splits the tile's columns between thread groups and adds the groups
// in order at the end of its slice.
//
// Two output modes share the body: P with both norm strips
// (fused_gram_norms), and the full factor bundle with the V stream
// (fused_factor_build).
#pragma once

#include "common.cuh"
#include "fold.cuh"

#ifdef RT_SPLIT_PLAN
#error "one split plan per library: splitk.cuh and skinny_stage.cuh both export rt_split_plan"
#endif
#define RT_SPLIT_PLAN 1

namespace rt {

constexpr int kSplitThreads = 256;
constexpr int kTileD = 32;         // D-columns per tile: one per lane
constexpr int kRowsPerThread = 4;  // rows of A held by one thread
constexpr int kLoadRows = 8;       // rows a warp loads before storing

// The split plan is decided here and nowhere else: D is cut into at most
// kMaxSlices slices of `chunk` columns, a multiple of kTileD, so every tile
// but the last of D is full. One CTA reduces one slice.
constexpr int kMaxSlices = 512;

struct SplitPlan {
  int ctas;
  i64 chunk;
};

inline SplitPlan split_plan(i64 D) {
  const i64 per = (D + kMaxSlices - 1) / kMaxSlices;
  const i64 chunk = (per + kTileD - 1) / kTileD * kTileD;
  return {static_cast<int>((D + chunk - 1) / chunk), chunk};
}

// What a first stage writes (see split_partials).
enum SplitMode { kSplitNorms = 1, kSplitFull = 2 };

// Shared-memory rows are padded to an odd stride, so a warp storing one
// column of 32 rows and a warp reading 32 rows of one column both hit 32
// different banks.
__host__ __device__ inline int odd_stride(int rows) { return rows | 1; }

// The V tile is staged only in the full mode.
__host__ __device__ inline i64 split_smem_bytes(int na, int nb, int mode) {
  const int vrows = mode == kSplitFull ? odd_stride(nb) : 0;
  const i64 floats =
      (i64)kTileD * (odd_stride(na) + odd_stride(nb) + vrows + 2) + na +
      2 * nb + 2 * kRowsPerThread * kSplitThreads;
  return floats * (i64)sizeof(float);
}

// Where the norm strips start in a partial row, and how many there are.
__host__ __device__ inline int split_norms_at(int na, int nb, int mode) {
  return (mode == kSplitFull ? 2 : 1) * na * nb;
}
__host__ __device__ inline int split_norms_len(int na, int nb, int mode) {
  return mode == kSplitFull ? na + 2 * nb : na + nb;
}

// Width of one CTA's partial row.
__host__ __device__ inline int split_stride(int na, int nb, int mode) {
  return split_norms_at(na, nb, mode) + split_norms_len(na, nb, mode);
}

// Each stream may be f32 or bf16 storage (TA, TB, TV; V is read only in
// the full mode). Partials of one slice of D, written to
// part[blockIdx.x * stride + ...]:
//   [0, na*nb)             P[a*nb + b] = sum_d A[a] lam B[b]
// then, in kSplitNorms mode,
//   na, nb                 na[a] = sum A lam A, nb[b] = sum B lam B
// or, in kSplitFull mode,
//   [na*nb, 2*na*nb)       C[b*na + a] = sum_d V[b] vs A[a]
//   then na, nb, tv        tv[b] = sum B lam V
template <typename TA, typename TB, typename TV, int MODE>
__global__ void __launch_bounds__(kSplitThreads)
    split_partials(const TA* __restrict__ A, const TB* __restrict__ B,
                   const TV* __restrict__ V, const float* __restrict__ lam,
                   i64 lam_stride, const float* __restrict__ vs, i64 vs_stride,
                   int na, int nb, i64 D, i64 chunk, float* __restrict__ part) {
  constexpr bool FULL = MODE == kSplitFull;
  extern __shared__ float smem[];
  const int lda = odd_stride(na), ldb = odd_stride(nb);
  float* sA = smem;               // [kTileD][lda]
  float* sB = sA + kTileD * lda;  // [kTileD][ldb]
  float* sV = sB + kTileD * ldb;  // [kTileD][ldb], full mode only
  float* sL = sV + (FULL ? kTileD * ldb : 0);  // [kTileD] lam
  float* sS = sL + kTileD;        // [kTileD] vs
  float* sNa = sS + kTileD;       // [na]
  float* sNb = sNa + na;          // [nb]
  float* sTv = sNb + nb;          // [nb], full mode only
  float* sRed = sTv + nb;         // [2 * kRowsPerThread][kSplitThreads]

  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int nwarps = kSplitThreads / kWarp;
  const i64 d_begin = (i64)blockIdx.x * chunk;
  const i64 d_end = d_begin + chunk < D ? d_begin + chunk : D;
  float* out = part + (i64)blockIdx.x * split_stride(na, nb, MODE);

  // A thread's slot is one column b of B (and V) and the rows
  // a0, a0 + sa, ... of A.
  const int sa = (na + kRowsPerThread - 1) / kRowsPerThread;
  const int nslots = sa * nb;
  const int groups = nslots >= kSplitThreads ? 1 : kSplitThreads / nslots;
  const int npass = (nslots + kSplitThreads - 1) / kSplitThreads;

  for (int i = tid; i < na + 2 * nb; i += kSplitThreads) sNa[i] = 0.f;

  for (int pass = 0; pass < npass; ++pass) {
    const int slot = groups > 1 ? tid % nslots : pass * kSplitThreads + tid;
    const int grp = groups > 1 ? tid / nslots : 0;
    const bool active = slot < nslots && grp < groups;
    const int b = active ? slot / sa : 0;
    const int a0 = active ? slot % sa : 0;
    const bool norms = pass == 0;
    float accP[kRowsPerThread], accC[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) accP[i] = accC[i] = 0.f;

    for (i64 t0 = d_begin; t0 < d_end; t0 += kTileD) {
      __syncthreads();  // the previous tile is consumed
      const i64 d = t0 + lane;
      const bool ok = d < d_end;
      const float l = ok ? lam[d * lam_stride] : 0.f;
      if (warp == 0) {
        sL[lane] = l;
        sS[lane] = (FULL && ok) ? lane_factor(vs, vs_stride, d) : 0.f;
      }
      // Rows j = warp, warp + nwarps, ...: each round issues the loads of
      // up to kLoadRows rows before it stores any, so that many reads are
      // in flight per warp.
      for (int j0 = warp; j0 < na + nb; j0 += kLoadRows * nwarps) {
        float xs[kLoadRows], vs_[kLoadRows];
#pragma unroll
        for (int u = 0; u < kLoadRows; ++u) {
          const int j = j0 + u * nwarps;
          xs[u] = vs_[u] = 0.f;
          if (!ok || j >= na + nb) continue;
          if (j < na) {
            xs[u] = to_f32(A[(i64)j * D + d]);
          } else {
            xs[u] = to_f32(B[(i64)(j - na) * D + d]);
            if (FULL) vs_[u] = to_f32(V[(i64)(j - na) * D + d]);
          }
        }
#pragma unroll
        for (int u = 0; u < kLoadRows; ++u) {
          const int j = j0 + u * nwarps;
          if (j >= na + nb) break;
          const float x = xs[u];
          if (j < na) {
            sA[lane * lda + j] = x;
            if (norms) {
              const float s = warp_sum(x * l * x);
              if (lane == 0) sNa[j] += s;
            }
          } else {
            const int r = j - na;
            sB[lane * ldb + r] = x;
            if (FULL) sV[lane * ldb + r] = vs_[u];
            if (norms) {
              const float s1 = warp_sum(x * l * x);
              const float s2 = FULL ? warp_sum(x * l * vs_[u]) : 0.f;
              if (lane == 0) {
                sNb[r] += s1;
                if (FULL) sTv[r] += s2;
              }
            }
          }
        }
      }
      __syncthreads();
      if (active) {
        for (int c = grp; c < kTileD; c += groups) {
          const float bl = sB[c * ldb + b] * sL[c];
          const float vv = FULL ? sV[c * ldb + b] * sS[c] : 0.f;
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            const int a = a0 + i * sa;
            if (a < na) {
              const float x = sA[c * lda + a];
              accP[i] = fmaf(x, bl, accP[i]);
              if (FULL) accC[i] = fmaf(x, vv, accC[i]);
            }
          }
        }
      }
    }

    // Fold the thread groups in group order.
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      sRed[(2 * i) * kSplitThreads + tid] = accP[i];
      sRed[(2 * i + 1) * kSplitThreads + tid] = accC[i];
    }
    __syncthreads();
    if (active && grp == 0) {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int a = a0 + i * sa;
        if (a >= na) continue;
        float p = 0.f, c = 0.f;
        for (int g = 0; g < groups; ++g) {
          const int t = groups > 1 ? g * nslots + slot : tid;
          p += sRed[(2 * i) * kSplitThreads + t];
          c += sRed[(2 * i + 1) * kSplitThreads + t];
        }
        out[a * nb + b] = p;
        if (FULL) out[na * nb + b * na + a] = c;
      }
    }
  }

  __syncthreads();
  const int at = split_norms_at(na, nb, MODE);
  for (int i = tid; i < split_norms_len(na, nb, MODE); i += kSplitThreads)
    out[at + i] = sNa[i];
}

// Both stages in stream order: part holds split_plan(D).ctas rows of
// split_stride(na, nb, MODE) floats of scratch, out one reduced row.
// Returns RT_BAD_SHAPE when the first stage's staging does not fit the
// shared-memory budget, else the launches' CUDA error code.
template <typename TA, typename TB, typename TV, int MODE>
int split_reduce(const TA* A, const TB* B, const TV* V, const float* lam,
                 i64 lam_stride, const float* vs, i64 vs_stride, int na,
                 int nb, i64 D, float* part, float* out,
                 cudaStream_t stream) {
  const i64 smem = split_smem_bytes(na, nb, MODE);
  if (smem > kSmemBytes) return RT_BAD_SHAPE;
  const SplitPlan plan = split_plan(D);
  split_partials<TA, TB, TV, MODE>
      <<<plan.ctas, kSplitThreads, smem, stream>>>(A, B, V, lam, lam_stride,
                                                   vs, vs_stride, na, nb, D,
                                                   plan.chunk, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(part, plan.ctas, split_stride(na, nb, MODE), out,
                       stream);
}

}  // namespace rt

// The first stage's CTA count for D columns (the rows of the caller's
// partials buffer); the columns each CTA reduces go to *chunk when given.
RT_EXPORT int rt_split_plan(long long D, long long* chunk) {
  const rt::SplitPlan plan = rt::split_plan(D);
  if (chunk != nullptr) *chunk = plan.chunk;
  return plan.ctas;
}
