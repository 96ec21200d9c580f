// The split-D first stage with norm strips, on skinny_stage.cuh's ring:
// per-CTA partials of
//
//   P  (Na, Nb) = sum_d A[a, d] lam[d] B[b, d]                 both modes
//   na (Na,)    = sum_d A lam A,  nb (Nb,) = sum_d B lam B     both modes
//   C  (Nb, Na) = sum_d V[b, d] vs[d] A[a, d]                  full mode
//   tv (Nb,)    = sum_d B lam V                                full mode
//
// The norms mode is fused_gram_norms (B4), the full mode fused_factor_build
// (B1); the P-only mode (B5, B3, B7) is skinny_stage.cuh's skinny_partials,
// whose ring, copies, device query and plan this file uses. A CTA reduces
// one contiguous slice of D into one f32 partial row; fold.cuh adds the
// rows in a fixed tree through a RowLayout. No atomics: the same bits on
// every run.
//
// What bounds it on an H100: bytes. A column costs the staged rows' elements
// (Na + Nb, + Nb of V in the full mode; A's rows alone when A and B are one
// tensor) against 2 Na Nb f32 operations a product: at the query shape
// (64, 16) f32, about 7 operations a byte in the norms mode and 11 in the
// full mode (two products), under the card's ~20, so loads and FMAs must
// overlap.
//
// Design:
//   * skinny_stage.cuh's persistent grid (one slice of D a CTA, the plan
//     sized from the device's SM count), its ring of S >= 3 stages filled
//     with 16-byte cp.async and one barrier a tile, and its shapes: U
//     sub-tiles of SW columns a stage, 512 bytes a row of the widest stream
//     type, the row stride SW elements of the row's own type. A sub-tile
//     holds A's rows, B's (none when B is A), V's (full mode; none when V
//     is B), then a (D,) lam and a (D,) vs as one f32 row each.
//   * Units of lanes own register blocks. A unit's lane takes C consecutive
//     columns of a stripe (one 4C-byte f32 or 2C-byte bf16 shared-memory
//     load a row), so a unit reads one contiguous run of a row:
//     conflict-free. A unit holds 64 accumulators a thread, the most that
//     512 threads' registers allow beside the operands:
//       - Norms mode: a warp owns an 8 x 8 block of P, as in the P mode,
//         but reads 2 columns a lane (not 4), to leave registers for 16
//         norm accumulators (the 8 A rows' na in the warps of the first B
//         block, the 8 B rows' nb in those of the first A block).
//       - Full mode: a half-warp (16 lanes) owns 8 A rows against 4 rows of
//         B and of V: a P block 8 x 4 and the C block 4 x 8 from the same A
//         values, 2 columns a lane, plus na, nb and tv in registers as
//         above. So 32 units cover the query shape's 2,048 outputs of P and
//         C in one pass over the slice: each tile of A, B and V is read from
//         device memory once. (One warp holding both 8 x 8 blocks would need
//         128 accumulators a thread; units past the 32nd take further
//         passes, which only shapes wider than the path's do.)
//     A (D,) lam scales the B values once per (b, column) (vs the V values);
//     a scalar factor multiplies the partial row once. When there are fewer
//     blocks than units, the units of one block take every groups-th stripe.
//   * At the end of a slice: a fixed shuffle tree over each unit's lanes,
//     then the units of each block in a fixed order, then one partial row
//     (RowLayout).
//   * The norm strips fold into shared memory every kNormFoldTiles tiles
//     (see stage_partials).
//   * Symmetric mode (A and B one tensor, the bundle sweep): only A's rows
//     are staged, the B blocks read them, and na = nb is P's diagonal,
//     which the fold reads (no norm accumulators). fused_gram_norms(X, X)
//     runs skinny_stage.cuh's symmetric P mode and folds the same way.
//     Likewise when V is B (the extend border), V's blocks read B's rows
//     and tv is nb.
#pragma once

#include "skinny_stage.cuh"

namespace rt {

// What a stage kernel computes (see the top of the file).
enum StageMode { kStageNorms = 1, kStageFull = 2 };

// Columns a lane reads a row (at most), and norm accumulators a thread.
constexpr int kLaneCols = 2, kNorms = 16;

template <int MODE>
struct ModeTraits {
  static constexpr int kLanes = MODE == kStageFull ? 16 : kWarp;  // a unit
  static constexpr int kBr = MODE == kStageFull ? 4 : 8;  // its B rows
  static constexpr int kAcc = kBlk * kBlk + kNorms;  // accumulators a thread
  static constexpr int kUnits = kStageThreads / kLanes;
  static constexpr i64 kRedBytes = (i64)kUnits * kAcc * sizeof(float);
};

// One CTA's partial row, and where each entry of the reduced row comes
// from. The reduced row is P (na*nb), then C (nb*na, full mode), then na,
// nb and tv (full mode). The partial row leaves out
// what another entry already sums: na and nb when B is A (P's diagonal),
// tv when V is B (nb).
struct RowLayout {
  int mode, na, nb, sym, v_is_b;

  __host__ __device__ int k() const { return na * nb; }
  __host__ __device__ bool norms() const { return !sym; }
  __host__ __device__ bool tv() const {
    return mode == kStageFull && !v_is_b;
  }
  __host__ __device__ int off_na() const {
    return mode == kStageFull ? 2 * k() : k();
  }
  __host__ __device__ int off_nb() const {
    return off_na() + (norms() ? na : 0);
  }
  __host__ __device__ int off_tv() const {
    return off_nb() + (norms() ? nb : 0);
  }
  __host__ __device__ int stride() const {
    return off_tv() + (tv() ? nb : 0);
  }
  __host__ __device__ int width() const {
    return off_na() + na + nb + (mode == kStageFull ? nb : 0);
  }
  // The partial-row column that entry e of the reduced row sums.
  __host__ __device__ int operator()(int e) const {
    if (e < off_na()) return e;
    int r = e - off_na();
    if (r < na) return sym ? r * nb + r : off_na() + r;
    r -= na;
    if (r < nb) return sym ? r * nb + r : off_nb() + r;
    r -= nb;
    if (v_is_b) return sym ? r * nb + r : off_nb() + r;
    return off_tv() + r;
  }
};

// A launch's operands. V, vs and v_is_b are read in the full mode only;
// a factor is a scalar f[0] or, with vec_*, a (D,) row.
template <typename TA, typename TB, typename TV>
struct StageArgs {
  const TA* A;
  const TB* B;
  const TV* V;
  const float* lam;
  const float* vs;
  int vec_lam, vec_vs;
  int na, nb;
  int sym;     // B is A: same pointer, rows and dtype
  int v_is_b;  // V is B
  i64 D;
};

__host__ __device__ inline int pad_to(int rows, int m) {
  return (rows + m - 1) / m * m;
}

// Rows of one sub-tile: A's, B's, V's, and the f32 factor rows. Row blocks
// are padded to the unit's block so a unit never reads outside its region
// (padding rows are never written; their products are discarded).
struct SubRows {
  int a, b, v, f;
};

template <int MODE, typename TA, typename TB, typename TV>
__host__ __device__ inline SubRows sub_rows(const StageArgs<TA, TB, TV>& s) {
  constexpr int br = ModeTraits<MODE>::kBr;
  const bool full = MODE == kStageFull;
  return {pad_to(s.na, kBlk), s.sym ? 0 : pad_to(s.nb, br),
          full && !s.v_is_b ? pad_to(s.nb, br) : 0,
          (s.vec_lam ? 1 : 0) + (full && s.vec_vs ? 1 : 0)};
}

// Bytes of one sub-tile of sw columns; a ring stage is U sub-tiles side by
// side.
template <typename TA, typename TB, typename TV>
__host__ __device__ inline i64 factor_sub_bytes(int sw, const SubRows& r) {
  return (i64)sw * ((i64)r.a * sizeof(TA) + (i64)r.b * sizeof(TB) +
                    (i64)r.v * sizeof(TV) + (i64)r.f * sizeof(float));
}

// 512 bytes a row of the widest stream type.
template <typename TA, typename TB, typename TV>
constexpr int factor_wide_sub() {
  constexpr int s = sizeof(TA) > sizeof(TB) ? sizeof(TA) : sizeof(TB);
  return 512 / (s > (int)sizeof(TV) ? s : (int)sizeof(TV));
}

// The ring for these rows: the largest stage that still leaves room for
// kMinStages of them, i.e. as many wide sub-tiles a stage as fit (up to
// kMaxSubs), then as many stages as fit (up to kMaxStages); narrow
// sub-tiles (a quarter of the width) only when many rows leave no other
// room. On an H100 fewer, larger stages beat more, smaller ones at the same
// bytes in flight (PERF.md). sw == 0 when nothing fits.
template <int MODE, typename TA, typename TB, typename TV>
StageShape ring_shape(const SubRows& r) {
  constexpr i64 red = ModeTraits<MODE>::kRedBytes;
  const i64 budget = device_info().smem_optin - red;
  const int wide = factor_wide_sub<TA, TB, TV>();
  const int shapes[][2] = {{wide, 8}, {wide, 4}, {wide, 2}, {wide, 1},
                           {wide / 4, 1}};
  static_assert(kMaxSubs == 8, "the widest stage above");
  for (const auto& sh : shapes) {
    const i64 sb = sh[1] * factor_sub_bytes<TA, TB, TV>(sh[0], r);
    const i64 s = budget / sb < kMaxStages ? budget / sb : kMaxStages;
    if (s >= kMinStages)
      return {sh[0], sh[1], static_cast<int>(s), s * sb + red};
  }
  return {0, 0, 0, 0};
}

// load_cols, with MASK zeroing the columns from lim on (their shared
// memory is stale or was never written).
template <int C, bool MASK, typename T>
__device__ __forceinline__ void load_masked(const T* p, float (&v)[C],
                                            int lim) {
  load_cols<C>(p, v);
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (MASK && c >= lim) v[c] = 0.f;
}

// Which norm strips a unit's block folds (see the top of the file).
struct NormsOn {
  bool na, nb, tv;
};

// The norms mode: skinny_stage.cuh's P stripe plus nrm[i] += a_i lam a_i
// (the block's A rows) and nrm[8 + j] += b_j lam b_j (its B rows).
template <bool MASK, bool VEC, int C, int SW, typename TA, typename TB>
__device__ __forceinline__ void fma_norms(float (&acc)[kBlk][kBlk],
                                          float (&nrm)[kNorms], const TA* a,
                                          const TB* b, const float* l,
                                          int lim, NormsOn on) {
  float av[kBlk][C], lv[C];
#pragma unroll
  for (int i = 0; i < kBlk; ++i) load_masked<C, MASK>(a + i * SW, av[i], lim);
  if (VEC) load_masked<C, MASK>(l, lv, lim);
  if (on.na) {
#pragma unroll
    for (int i = 0; i < kBlk; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c)
        nrm[i] = fmaf(av[i][c], VEC ? av[i][c] * lv[c] : av[i][c], nrm[i]);
  }
#pragma unroll
  for (int j = 0; j < kBlk; ++j) {
    float bv[C], bl[C];
    load_masked<C, MASK>(b + j * SW, bv, lim);
#pragma unroll
    for (int c = 0; c < C; ++c) bl[c] = VEC ? bv[c] * lv[c] : bv[c];
    if (on.nb) {
#pragma unroll
      for (int c = 0; c < C; ++c) nrm[kBlk + j] = fmaf(bv[c], bl[c], nrm[kBlk + j]);
    }
#pragma unroll
    for (int i = 0; i < kBlk; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][j] = fmaf(av[i][c], bl[c], acc[i][j]);
  }
}

// The full mode, for a half-warp's block of 8 A rows against 4 rows of B
// and of V: acc[i][j] += a_i lam b_j (P) and acc[i][4 + j] += v_j vs a_i
// (C), from one load of each row; nrm[i] += a_i lam a_i, nrm[8 + j] +=
// b_j lam b_j, nrm[12 + j] += b_j lam v_j.
template <bool MASK, bool VL, bool VS, int C, int SW, typename TA,
          typename TB, typename TV>
__device__ __forceinline__ void fma_full(float (&acc)[kBlk][kBlk],
                                         float (&nrm)[kNorms], const TA* a,
                                         const TB* b, const TV* v,
                                         const float* l, const float* s,
                                         int lim, NormsOn on) {
  constexpr int BR = ModeTraits<kStageFull>::kBr;
  float av[kBlk][C], lv[C], sv[C];
#pragma unroll
  for (int i = 0; i < kBlk; ++i) load_masked<C, MASK>(a + i * SW, av[i], lim);
  if (VL) load_masked<C, MASK>(l, lv, lim);
  if (VS) load_masked<C, MASK>(s, sv, lim);
  if (on.na) {
#pragma unroll
    for (int i = 0; i < kBlk; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c)
        nrm[i] = fmaf(av[i][c], VL ? av[i][c] * lv[c] : av[i][c], nrm[i]);
  }
#pragma unroll
  for (int j = 0; j < BR; ++j) {
    float bv[C], vv[C], bl[C], vl[C];
    load_masked<C, MASK>(b + j * SW, bv, lim);
    load_masked<C, MASK>(v + j * SW, vv, lim);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      bl[c] = VL ? bv[c] * lv[c] : bv[c];
      vl[c] = VS ? vv[c] * sv[c] : vv[c];
    }
    if (on.nb) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        nrm[kBlk + j] = fmaf(bv[c], bl[c], nrm[kBlk + j]);
    }
    if (on.tv) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        nrm[kBlk + BR + j] = fmaf(vv[c], bl[c], nrm[kBlk + BR + j]);
    }
#pragma unroll
    for (int i = 0; i < kBlk; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[i][j] = fmaf(av[i][c], bl[c], acc[i][j]);
        acc[i][BR + j] = fmaf(av[i][c], vl[c], acc[i][BR + j]);
      }
  }
}

// One stripe of the norms or full mode, with the factors' vector flags
// resolved.
template <int MODE, bool MASK, int C, int SW, typename TA, typename TB,
          typename TV>
__device__ __forceinline__ void fma_mode(float (&acc)[kBlk][kBlk],
                                         float (&nrm)[kNorms], const TA* a,
                                         const TB* b, const TV* v,
                                         const float* l, const float* s,
                                         int lim, bool vl, bool vs,
                                         NormsOn on) {
  if constexpr (MODE == kStageNorms) {
    if (vl)
      fma_norms<MASK, true, C, SW>(acc, nrm, a, b, l, lim, on);
    else
      fma_norms<MASK, false, C, SW>(acc, nrm, a, b, l, lim, on);
  } else {
    if (vl && vs)
      fma_full<MASK, true, true, C, SW>(acc, nrm, a, b, v, l, s, lim, on);
    else if (vl)
      fma_full<MASK, true, false, C, SW>(acc, nrm, a, b, v, l, s, lim, on);
    else if (vs)
      fma_full<MASK, false, true, C, SW>(acc, nrm, a, b, v, l, s, lim, on);
    else
      fma_full<MASK, false, false, C, SW>(acc, nrm, a, b, v, l, s, lim, on);
  }
}

// Sum over the L lanes of a unit (L = 16 or 32) with a fixed shuffle tree;
// the total lands in the unit's first lane. Every lane of the warp calls it.
template <int L>
__device__ __forceinline__ float unit_sum(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off, L);
  return v;
}

// Where accumulator k of the block at rows (a0, b0) goes in the partial
// row, and its scalar factor; -1 for a padding row or a strip the block
// does not fold.
template <int MODE>
__device__ __forceinline__ int acc_dest(const RowLayout& lay, int a0, int b0,
                                        int k, NormsOn on, float lam0,
                                        float vs0, float& scale) {
  constexpr int BR = ModeTraits<MODE>::kBr;
  scale = lam0;
  if (k < kBlk * kBlk) {
    const int a = a0 + k / kBlk, j = k % kBlk;
    if (MODE != kStageFull || j < BR) {
      const int b = b0 + j;
      return a < lay.na && b < lay.nb ? a * lay.nb + b : -1;
    }
    const int b = b0 + j - BR;  // C[b][a]
    scale = vs0;
    return a < lay.na && b < lay.nb ? lay.k() + b * lay.na + a : -1;
  }
  int r = k - kBlk * kBlk;
  if (r < kBlk) return on.na && a0 + r < lay.na ? lay.off_na() + a0 + r : -1;
  r -= kBlk;
  if (r < BR) return on.nb && b0 + r < lay.nb ? lay.off_nb() + b0 + r : -1;
  r -= BR;
  return on.tv && b0 + r < lay.nb ? lay.off_tv() + b0 + r : -1;
}

// Tiles between two folds of the norm accumulators into the unit's slot
// in shared memory.
constexpr int kNormFoldTiles = 8;

// The norms and full modes: partials of one slice of D, written to
// part[blockIdx.x * stride + ...] in the RowLayout of MODE. A tile is
// `subs` sub-tiles of SW columns; the ring holds `stages` tiles.
//
// The norm strips sum positive, strongly correlated terms (squares), and a
// long sequential f32 sum of bf16 squares drifts: a lane adding 2,000 of
// them rounds with a bias of about -4e-6 of the sum (a numpy model of the
// order; the card showed the same against float64 at D = 2^22). So every
// kNormFoldTiles tiles each unit folds its 16 norm accumulators with the
// shuffle tree and its first lane adds the total to the unit's slot in
// shared memory: a lane's run stays short enough to sum bf16 squares
// exactly, and the slot adds full-precision totals.
template <typename TA, typename TB, typename TV, int SW, int MODE>
__global__ void __launch_bounds__(kStageThreads, 1)
    stage_partials(const StageArgs<TA, TB, TV> s, i64 chunk, int subs,
                   int stages, float* __restrict__ part) {
  using M = ModeTraits<MODE>;
  constexpr int L = M::kLanes, BR = M::kBr, kUnits = M::kUnits;
  constexpr int kAcc = M::kAcc, kP = kBlk * kBlk;
  // A lane takes C consecutive columns of a stripe of kStripeCols; a
  // sub-tile is kStripes stripes.
  constexpr int C = SW / L < kLaneCols ? SW / L : kLaneCols;
  constexpr int kStripeCols = L * C, kStripes = SW / kStripeCols;
  extern __shared__ __align__(16) unsigned char stage_smem[];
  unsigned char* smem = stage_smem;
  const RowLayout lay{MODE, s.na, s.nb, s.sym, s.v_is_b};
  const SubRows rows = sub_rows<MODE>(s);
  const i64 bytes_a = (i64)SW * rows.a * sizeof(TA);
  const i64 bytes_b = (i64)SW * rows.b * sizeof(TB);
  const i64 bytes_v = (i64)SW * rows.v * sizeof(TV);
  const i64 off_b = s.sym ? 0 : bytes_a;
  const i64 off_v = s.v_is_b ? off_b : bytes_a + bytes_b;
  const i64 off_l = bytes_a + bytes_b + bytes_v;
  const i64 off_s = off_l + (s.vec_lam ? SW * (i64)sizeof(float) : 0);
  const i64 sub = factor_sub_bytes<TA, TB, TV>(SW, rows);
  const i64 sbytes = subs * sub;
  const int tw = subs * SW, nstripes = subs * kStripes;
  float* red = reinterpret_cast<float*>(smem + stages * sbytes);
  const bool folds = lay.norms() || lay.tv();

  const int tid = threadIdx.x, lane = tid % L, unit = tid / L;
  const i64 d_begin = (i64)blockIdx.x * chunk;
  const i64 d_end = d_begin + chunk < s.D ? d_begin + chunk : s.D;
  const int ntiles = static_cast<int>((d_end - d_begin + tw - 1) / tw);
  const float lam0 = s.vec_lam ? 1.f : s.lam[0];
  const float vs0 = MODE != kStageFull || s.vec_vs ? 1.f : s.vs[0];
  float* out = part + (i64)blockIdx.x * lay.stride();
  const int nbb = (s.nb + BR - 1) / BR;
  const int nblk = (s.na + kBlk - 1) / kBlk * nbb;

  auto stage = [&](int t) {
    for (int u = 0; u < subs; ++u) {
      unsigned char* su = smem + (t % stages) * sbytes + u * sub;
      const i64 t0 = d_begin + (i64)t * tw + u * SW;
      if (t0 >= d_end) break;
      const i64 tend = t0 + SW < d_end ? t0 + SW : d_end;
      stage_rows<TA, SW>(reinterpret_cast<TA*>(su), s.A, s.na, s.D, t0, tend);
      if (!s.sym)
        stage_rows<TB, SW>(reinterpret_cast<TB*>(su + bytes_a), s.B, s.nb,
                           s.D, t0, tend);
      if (rows.v)
        stage_rows<TV, SW>(reinterpret_cast<TV*>(su + off_v), s.V, s.nb, s.D,
                           t0, tend);
      if (s.vec_lam)
        stage_rows<float, SW>(reinterpret_cast<float*>(su + off_l), s.lam, 1,
                              s.D, t0, tend);
      if (MODE == kStageFull && s.vec_vs)
        stage_rows<float, SW>(reinterpret_cast<float*>(su + off_s), s.vs, 1,
                              s.D, t0, tend);
    }
  };

  for (int first = 0; first < nblk; first += kUnits) {
    const int nloc = nblk - first < kUnits ? nblk - first : kUnits;
    const int groups = kUnits / nloc;
    const bool active = unit < nloc * groups;
    const int blk = first + unit % nloc, grp = unit / nloc;
    const int a0 = blk / nbb * kBlk, b0 = blk % nbb * BR;
    const NormsOn on{lay.norms() && b0 == 0, lay.norms() && a0 == 0,
                     lay.tv() && a0 == 0};
    float acc[kBlk][kBlk], nrm[kNorms];
#pragma unroll
    for (int i = 0; i < kBlk; ++i)
#pragma unroll
      for (int j = 0; j < kBlk; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int i = 0; i < kNorms; ++i) nrm[i] = 0.f;
    // the units' norm slots (the first tile's barrier orders this before
    // the first fold)
    for (int e = tid; e < kUnits * kNorms; e += kStageThreads)
      red[e / kNorms * kAcc + kP + e % kNorms] = 0.f;

    for (int t = 0; t < stages - 1; ++t) {
      if (t < ntiles) stage(t);
      cp_async_commit();
    }
    for (int t = 0; t < ntiles; ++t) {
      cp_async_wait_upto(stages - 2);  // this thread's copies of tile t
      __syncthreads();  // everyone's; and tile t-1's slot is consumed
      if (t + stages - 1 < ntiles) stage(t + stages - 1);
      cp_async_commit();
      if (active) {
        const unsigned char* st = smem + (t % stages) * sbytes;
        const i64 t0 = d_begin + (i64)t * tw;
        const int valid =
            static_cast<int>((t0 + tw < d_end ? t0 + tw : d_end) - t0);
        // stripe q = t*nstripes + k of the slice belongs to group q % groups
        for (int k = ((grp - t * nstripes) % groups + groups) % groups;
             k < nstripes; k += groups) {
          const unsigned char* su = st + (k / kStripes) * sub;
          const int c = (k % kStripes) * kStripeCols + lane * C;
          const TA* a = reinterpret_cast<const TA*>(su) + a0 * SW + c;
          const TB* b = reinterpret_cast<const TB*>(su + off_b) + b0 * SW + c;
          const TV* v = reinterpret_cast<const TV*>(su + off_v) + b0 * SW + c;
          const float* l = reinterpret_cast<const float*>(su + off_l) + c;
          const float* sp = reinterpret_cast<const float*>(su + off_s) + c;
          const int col = k * kStripeCols;  // the stripe's first tile column
          if (col + kStripeCols <= valid)
            fma_mode<MODE, false, C, SW>(acc, nrm, a, b, v, l, sp, C,
                                         s.vec_lam, s.vec_vs, on);
          else if (col < valid)
            fma_mode<MODE, true, C, SW>(acc, nrm, a, b, v, l, sp,
                                        valid - col - lane * C, s.vec_lam,
                                        s.vec_vs, on);
        }
      }
      // every lane shuffles (the two units of a warp may differ in
      // `active`); each unit's first lane owns its slot
      if (folds && (t % kNormFoldTiles == kNormFoldTiles - 1 ||
                    t == ntiles - 1)) {
#pragma unroll
        for (int k = 0; k < kNorms; ++k) {
          const float v = unit_sum<L>(nrm[k]);
          nrm[k] = 0.f;
          if (active && lane == 0) red[unit * kAcc + kP + k] += v;
        }
      }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int k = 0; k < kP; ++k) {
      const float v = unit_sum<L>(acc[k / kBlk][k % kBlk]);
      if (active && lane == 0) red[unit * kAcc + k] = v;
    }
    __syncthreads();
    for (int e = tid; e < nloc * kAcc; e += kStageThreads) {
      const int bl = e / kAcc, k = e % kAcc;
      const int ba0 = (first + bl) / nbb * kBlk, bb0 = (first + bl) % nbb * BR;
      const NormsOn bon{lay.norms() && bb0 == 0, lay.norms() && ba0 == 0,
                        lay.tv() && ba0 == 0};
      float scale;
      const int dst =
          acc_dest<MODE>(lay, ba0, bb0, k, bon, lam0, vs0, scale);
      if (dst < 0) continue;
      float v = 0.f;
      for (int g = 0; g < groups; ++g) v += red[(g * nloc + bl) * kAcc + k];
      out[dst] = v * scale;
    }
    __syncthreads();  // red and the ring are free for the next pass
  }
}

template <int MODE, typename TA, typename TB, typename TV, int SW>
int launch_stage(const StageArgs<TA, TB, TV>& s, const StageShape& sh,
                 float* part, cudaStream_t stream) {
  auto kern = stage_partials<TA, TB, TV, SW, MODE>;
  if (sh.smem > kSmemBytes) {  // the opt-in, on every launch that needs it
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sh.smem));
    if (err != cudaSuccess) return err;
  }
  const StagePlan plan = stage_plan(s.D);
  kern<<<plan.ctas, kStageThreads, sh.smem, stream>>>(s, plan.chunk, sh.subs,
                                                      sh.stages, part);
  return cudaGetLastError();
}

// Whether the mode takes these operands' aliasing: sym asks for B to be A
// (same pointer, rows and dtype), v_is_b (full mode) for V to be B.
template <int MODE, typename TA, typename TB, typename TV>
bool takes(const StageArgs<TA, TB, TV>& s) {
  if (s.sym && (s.na != s.nb || sizeof(TA) != sizeof(TB) ||
                static_cast<const void*>(s.A) != static_cast<const void*>(s.B)))
    return false;
  return !s.v_is_b ||
         (MODE == kStageFull && sizeof(TV) == sizeof(TB) &&
          static_cast<const void*>(s.V) == static_cast<const void*>(s.B));
}

// Columns one ring holds (stages x tile width) for these operands on the
// current device, or RT_BAD_SHAPE when none fits (the stage then refuses).
template <int MODE, typename TA, typename TB, typename TV>
int ring_columns(const StageArgs<TA, TB, TV>& s) {
  const StageShape sh = ring_shape<MODE, TA, TB, TV>(sub_rows<MODE>(s));
  return sh.sw == 0 ? RT_BAD_SHAPE : sh.tw() * sh.stages;
}

// The norms or full mode alone: part receives stage_plan(D).ctas rows of
// RowLayout{MODE, ...}.stride() floats. Returns RT_BAD_SHAPE when no ring
// of kMinStages stages fits the shared memory (or an aliasing flag does not
// hold), else the launch's CUDA error code.
template <int MODE, typename TA, typename TB, typename TV>
int run_stage(const StageArgs<TA, TB, TV>& s, float* part,
              cudaStream_t stream) {
  if (!takes<MODE>(s)) return RT_BAD_SHAPE;
  const StageShape sh = ring_shape<MODE, TA, TB, TV>(sub_rows<MODE>(s));
  constexpr int wide = factor_wide_sub<TA, TB, TV>();
  if (sh.sw == wide)
    return launch_stage<MODE, TA, TB, TV, wide>(s, sh, part, stream);
  if (sh.sw == wide / 4)
    return launch_stage<MODE, TA, TB, TV, wide / 4>(s, sh, part, stream);
  return RT_BAD_SHAPE;
}

}  // namespace rt
