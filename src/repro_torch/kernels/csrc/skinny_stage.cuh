// The split-D first stage for Hopper, P-only: per-CTA partials of
//
//   P (Na, Nb) = sum_d A[a, d] lam[d] B[b, d]
//
// for skinny_gram (B5) and the M-reduction of fused_gram_mvm (B3, and B7
// with R stacked right-hand sides). factor_stage.cuh builds the norms and
// full modes of fused_gram_norms (B4) and fused_factor_build (B1) on this
// file's ring, copies, device query and plan: every split-D library of the
// port cuts D with stage_plan. A CTA reduces one contiguous slice of D into
// one f32 partial row; fold.cuh adds the rows in a fixed tree
// (reduce_partials, or inside the Gram MVM's mvm_small). No atomics: the
// same bits on every run.
//
// What bounds it on an H100: bytes. A column costs Na + Nb stream elements
// (Na when A and B are one tensor) against 2 Na Nb f32 operations: at the
// query shape (64, 16) f32, about 6 operations a byte under the card's ~20.
// The port's first split-D stage moved one 32-column tile between two
// barriers, so a CTA's loads and FMAs never overlapped and far fewer bytes
// were in flight than HBM latency needs (~3.35 TB/s x ~1 us).
//
// Design:
//   * A persistent grid: about kCtasPerSm CTAs a streaming multiprocessor,
//     one wave, each walking one slice of D. The plan (rt_split_plan)
//     depends on the device's SM count, queried once per device.
//   * A ring of S >= 3 shared-memory stages filled with 16-byte cp.async:
//     while tile t is consumed, tiles t+1 .. t+S-1 are in flight, with one
//     barrier a tile. A tile is U sub-tiles of SW columns of every row,
//     512 bytes a row (128 f32 or 256 bf16 columns; the row stride in
//     shared memory is SW, fixed at compile time). U is as large as leaves
//     room for three stages (up to 8: few rows take wide tiles), then S as
//     large as fits (up to 8); a quarter of SW only when many rows leave no
//     room for three one-sub-tile stages. So 16 rows move 64 KB a stage,
//     80 rows 40 KB a stage in five stages.
//   * Row j starts at j*D elements, 16-byte aligned only when D is a
//     multiple of 16 bytes' worth of elements: a vector that is not
//     aligned, or that holds the end of D, is copied element by element
//     (4-byte cp.async, plain loads for bf16 elements that 4 bytes cannot
//     carry). Nothing reads past a row's end.
//   * A lane takes 4 consecutive columns of a 128-column stripe (one
//     16-byte f32 or 8-byte bf16 shared-memory load a row; 1 or 2 columns
//     in the narrow sub-tiles), so a warp reads
//     one contiguous run of a row: conflict-free, and a quarter of the load
//     instructions of one column a lane. Each warp owns an 8 x 8 block of
//     P in registers (64 accumulators a thread). A (D,) lam scales the B
//     values once per (b, column); a scalar lam multiplies the partial row
//     once. When there are fewer blocks than warps, the warps of one block
//     take every groups-th stripe; more than kStageWarps blocks take
//     further passes over the slice.
//   * At the end of a slice: a fixed shuffle tree over lanes, then the
//     warps of each block in a fixed order, then one partial row.
//   * Symmetric mode (A and B one tensor, build_factors(X, X)): only A's
//     rows are staged, and the B blocks read them.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace rt {

constexpr int kStageThreads = 512;
constexpr int kStageWarps = kStageThreads / kWarp;
constexpr int kBlk = 8;  // a warp's block of P is kBlk x kBlk
constexpr int kMinStages = 3, kMaxStages = 8;
constexpr int kMaxSubs = 8;  // sub-tiles a stage
constexpr int kCtasPerSm = 1;
// Slices start at multiples of this many columns, so every tile starts
// 16-byte aligned within a row whose start is.
constexpr int kSliceQuantum = 256;
constexpr i64 kRedBytes = (i64)kStageWarps * kBlk * kBlk * sizeof(float);
constexpr int kMaxDevices = 64;

struct DeviceInfo {
  int sms;         // streaming multiprocessors
  int smem_optin;  // shared memory a block may take after the opt-in
};

namespace {
// Per library (internal linkage): a static inside an inline function would
// be one object for every library of the process, which the dynamic
// loader merges.
DeviceInfo device_cache[kMaxDevices];
}  // namespace

// Queried once per device (the current one).
inline DeviceInfo device_info() {
  int dev = 0;
  cudaGetDevice(&dev);
  DeviceInfo fresh{0, 0};
  DeviceInfo& d = dev >= 0 && dev < kMaxDevices ? device_cache[dev] : fresh;
  if (d.sms == 0) {
    cudaDeviceGetAttribute(&d.smem_optin,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return d;
}

struct StagePlan {
  int ctas;
  i64 chunk;  // columns per CTA, a multiple of kSliceQuantum
};

// The one place that cuts D for this stage: at most kCtasPerSm * SMs
// slices, each CTA one slice.
inline StagePlan stage_plan(i64 D) {
  const i64 target = (i64)kCtasPerSm * device_info().sms;
  const i64 per = (D + target - 1) / target;
  const i64 chunk = (per + kSliceQuantum - 1) / kSliceQuantum * kSliceQuantum;
  return {static_cast<int>((D + chunk - 1) / chunk), chunk};
}

__host__ __device__ inline int pad_blk(int rows) {
  return (rows + kBlk - 1) / kBlk * kBlk;
}

// Bytes of one sub-tile of SW columns: A's rows, B's rows (none in the
// symmetric mode), and a (D,) lam as one more f32 row, each row SW
// elements. Row blocks are padded to kBlk rows so a warp's block never
// reads outside its region (padding rows are never written; their products
// are discarded). A ring stage is U sub-tiles side by side.
template <typename TA, typename TB>
__host__ __device__ inline i64 sub_bytes(int sw, int na, int nb, bool sym,
                                         bool vec_lam) {
  return (i64)sw * ((i64)pad_blk(na) * sizeof(TA) +
                    (sym ? 0 : (i64)pad_blk(nb) * sizeof(TB)) +
                    (vec_lam ? sizeof(float) : 0));
}

// 512 bytes a row of the wider stream type.
template <typename TA, typename TB>
constexpr int wide_sub() {
  return 512 / (sizeof(TA) > sizeof(TB) ? sizeof(TA) : sizeof(TB));
}

struct StageShape {
  int sw;      // columns of a sub-tile (the row stride in shared memory)
  int subs;    // sub-tiles a stage, so sw * subs columns a tile
  int stages;  // ring length
  i64 smem;    // dynamic shared memory of a CTA
  int tw() const { return sw * subs; }
};

// The ring for these operands: the largest stage that still leaves room
// for kMinStages of them, i.e. as many wide sub-tiles a stage as fit (up to
// kMaxSubs), then as many stages as fit (up to kMaxStages); narrow sub-tiles
// (a quarter of the width) only when many rows leave no other room. On an
// H100 fewer, larger stages beat more, smaller ones at the same bytes in
// flight (PERF.md). sw == 0 when nothing fits.
template <typename TA, typename TB>
StageShape stage_shape(int na, int nb, bool sym, bool vec_lam) {
  const i64 budget = device_info().smem_optin - kRedBytes;
  const int wide = wide_sub<TA, TB>();
  const int shapes[][2] = {{wide, 8}, {wide, 4}, {wide, 2}, {wide, 1},
                           {wide / 4, 1}};
  static_assert(kMaxSubs == 8, "the widest stage above");
  for (const auto& sh : shapes) {
    const i64 sb = sh[1] * sub_bytes<TA, TB>(sh[0], na, nb, sym, vec_lam);
    const i64 s = budget / sb < kMaxStages ? budget / sb : kMaxStages;
    if (s >= kMinStages)
      return {sh[0], sh[1], static_cast<int>(s), s * sb + kRedBytes};
  }
  return {0, 0, 0, 0};
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Wait until at most n of this thread's groups are pending (n is the ring
// length less two, so 1 .. kMaxStages - 2).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
  static_assert(kMaxStages - 2 == 6, "one case per ring length");
}

// n <= 16 bytes' worth of elements that a 16-byte copy cannot take.
template <typename T>
__device__ __forceinline__ void copy_elems(T* d, const T* s, int n) {
  if constexpr (sizeof(T) == 4) {
    for (int e = 0; e < n; ++e) cp_async4(d + e, s + e);
  } else if ((reinterpret_cast<uintptr_t>(s) & 3) == 0) {
    int e = 0;
    for (; e + 1 < n; e += 2) cp_async4(d + e, s + e);
    if (e < n) d[e] = s[e];
  } else {
    for (int e = 0; e < n; ++e) d[e] = s[e];
  }
}

// Columns [t0, tend) of rows 0 .. nrows-1 of the row-major (nrows, D)
// matrix g into dst[j * SW + (column - t0)]. tend <= D.
template <typename T, int SW>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ g,
                                           int nrows, i64 D, i64 t0,
                                           i64 tend) {
  constexpr int V = 16 / sizeof(T);  // elements in 16 bytes
  constexpr int NV = SW / V;         // vectors in one row of a sub-tile
  const int nvec = static_cast<int>((tend - t0 + V - 1) / V);
  for (int idx = threadIdx.x; idx < nrows * NV; idx += kStageThreads) {
    const int j = idx / NV, k = idx % NV;
    if (k >= nvec) continue;
    const i64 c0 = t0 + (i64)k * V;
    const T* src = g + (i64)j * D + c0;
    T* d = dst + j * SW + k * V;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && c0 + V <= D)
      cp_async16(d, src);
    else
      copy_elems(d, src, static_cast<int>(tend - c0 < V ? tend - c0 : V));
  }
}

// A lane's C consecutive columns of one row of a tile, as f32: one
// 4C-byte (f32) or 2C-byte (bf16) shared-memory load.
template <int C, typename T>
__device__ __forceinline__ void load_cols(const T* p, float (&v)[C]) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (C == 4) {
      const float4 x = *reinterpret_cast<const float4*>(p);
      v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
    } else if constexpr (C == 2) {
      const float2 x = *reinterpret_cast<const float2*>(p);
      v[0] = x.x, v[1] = x.y;
    } else {
      v[0] = to_f32(*p);
    }
  } else {  // bf16: element 2k is the low half of 32-bit word k
    if constexpr (C == 4) {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      v[0] = __uint_as_float(x.x << 16), v[1] = __uint_as_float(x.x & 0xffff0000u);
      v[2] = __uint_as_float(x.y << 16), v[3] = __uint_as_float(x.y & 0xffff0000u);
    } else if constexpr (C == 2) {
      const unsigned x = *reinterpret_cast<const unsigned*>(p);
      v[0] = __uint_as_float(x << 16), v[1] = __uint_as_float(x & 0xffff0000u);
    } else {
      v[0] = to_f32(*p);
    }
  }
}

// One stripe (32 lanes x C consecutive columns) of one sub-tile:
// acc[i][j] += sum_c a_i[c] * b_j[c] (* lam[c] with a (D,) lam; a scalar
// lam is applied to the partial row instead). a and b point at the lane's
// first column in the block's first row; rows are SW elements apart. lim
// is how many of the lane's columns lie before the slice's end: MASK zeroes
// the others (their shared memory is stale or was never written).
template <bool MASK, bool VEC, int C, int SW, typename TA, typename TB>
__device__ __forceinline__ void fma_stripe(float (&acc)[kBlk][kBlk],
                                           const TA* a, const TB* b,
                                           const float* l, int lim) {
  float av[kBlk][C], lv[C];
#pragma unroll
  for (int i = 0; i < kBlk; ++i) {
    load_cols<C>(a + i * SW, av[i]);
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (MASK && c >= lim) av[i][c] = 0.f;
  }
  if (VEC) load_cols<C>(l, lv);
#pragma unroll
  for (int j = 0; j < kBlk; ++j) {
    float bv[C];
    load_cols<C>(b + j * SW, bv);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (VEC) bv[c] *= lv[c];
      if (MASK && c >= lim) bv[c] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBlk; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][j] = fmaf(av[i][c], bv[c], acc[i][j]);
  }
}

// Partials of one slice of D, written to part[blockIdx.x * na * nb + a * nb
// + b]. lam_stride is 0 (scalar lam[0]) or 1 ((D,) lam). With sym, B is A
// (na == nb, TA == TB) and is not read. A tile is `subs` sub-tiles of SW
// columns; the ring holds `stages` tiles.
template <typename TA, typename TB, int SW>
__global__ void __launch_bounds__(kStageThreads, 1)
    skinny_partials(const TA* __restrict__ A, const TB* __restrict__ B,
                    const float* __restrict__ lam, i64 lam_stride, int na,
                    int nb, int sym, i64 D, i64 chunk, int subs, int stages,
                    float* __restrict__ part) {
  // A lane takes C consecutive columns of a stripe of kStripeCols; a
  // sub-tile is kStripes stripes.
  constexpr int C = SW / kWarp < 4 ? SW / kWarp : 4;
  constexpr int kStripeCols = kWarp * C, kStripes = SW / kStripeCols;
  extern __shared__ __align__(16) unsigned char stage_smem[];
  unsigned char* smem = stage_smem;
  const bool vec_lam = lam_stride != 0;
  const i64 bytes_a = (i64)SW * pad_blk(na) * sizeof(TA);
  const i64 bytes_b = sym ? 0 : (i64)SW * pad_blk(nb) * sizeof(TB);
  const i64 sub = sub_bytes<TA, TB>(SW, na, nb, sym, vec_lam);
  const i64 sbytes = subs * sub;
  const int tw = subs * SW, nstripes = subs * kStripes;
  float* red = reinterpret_cast<float*>(smem + stages * sbytes);

  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const i64 d_begin = (i64)blockIdx.x * chunk;
  const i64 d_end = d_begin + chunk < D ? d_begin + chunk : D;
  const int ntiles = static_cast<int>((d_end - d_begin + tw - 1) / tw);
  const float lam0 = vec_lam ? 1.f : lam[0];
  float* out = part + (i64)blockIdx.x * na * nb;
  const int nbb = (nb + kBlk - 1) / kBlk;
  const int nblk = (na + kBlk - 1) / kBlk * nbb;

  auto stage = [&](int t) {
    for (int u = 0; u < subs; ++u) {
      unsigned char* s = smem + (t % stages) * sbytes + u * sub;
      const i64 t0 = d_begin + (i64)t * tw + u * SW;
      if (t0 >= d_end) break;
      const i64 tend = t0 + SW < d_end ? t0 + SW : d_end;
      stage_rows<TA, SW>(reinterpret_cast<TA*>(s), A, na, D, t0, tend);
      if (!sym)
        stage_rows<TB, SW>(reinterpret_cast<TB*>(s + bytes_a), B, nb, D, t0,
                           tend);
      if (vec_lam)
        stage_rows<float, SW>(
            reinterpret_cast<float*>(s + bytes_a + bytes_b), lam, 1, D, t0,
            tend);
    }
  };

  for (int first = 0; first < nblk; first += kStageWarps) {
    const int nloc = nblk - first < kStageWarps ? nblk - first : kStageWarps;
    const int groups = kStageWarps / nloc;
    const bool active = warp < nloc * groups;
    const int blk = first + warp % nloc, grp = warp / nloc;
    const int a0 = blk / nbb * kBlk, b0 = blk % nbb * kBlk;
    float acc[kBlk][kBlk];
#pragma unroll
    for (int i = 0; i < kBlk; ++i)
#pragma unroll
      for (int j = 0; j < kBlk; ++j) acc[i][j] = 0.f;

    for (int t = 0; t < stages - 1; ++t) {
      if (t < ntiles) stage(t);
      cp_async_commit();
    }
    for (int t = 0; t < ntiles; ++t) {
      cp_async_wait_upto(stages - 2);  // this thread's copies of tile t
      __syncthreads();  // everyone's; and tile t-1's slot is consumed
      if (t + stages - 1 < ntiles) stage(t + stages - 1);
      cp_async_commit();
      if (!active) continue;
      const unsigned char* s = smem + (t % stages) * sbytes;
      const i64 t0 = d_begin + (i64)t * tw;
      const int valid =
          static_cast<int>((t0 + tw < d_end ? t0 + tw : d_end) - t0);
      // stripe q = t*nstripes + k of the slice belongs to group q % groups
      for (int k = ((grp - t * nstripes) % groups + groups) % groups;
           k < nstripes; k += groups) {
        const unsigned char* su = s + (k / kStripes) * sub;
        const int c = (k % kStripes) * kStripeCols + lane * C;
        const TA* a = reinterpret_cast<const TA*>(su) + a0 * SW + c;
        const TB* b =
            reinterpret_cast<const TB*>(sym ? su : su + bytes_a) + b0 * SW + c;
        const float* l =
            reinterpret_cast<const float*>(su + bytes_a + bytes_b) + c;
        const int col = k * kStripeCols;  // the stripe's first tile column
        if (col + kStripeCols <= valid) {
          if (vec_lam)
            fma_stripe<false, true, C, SW>(acc, a, b, l, C);
          else
            fma_stripe<false, false, C, SW>(acc, a, b, l, C);
        } else if (col < valid) {
          const int lim = valid - col - lane * C;
          if (vec_lam)
            fma_stripe<true, true, C, SW>(acc, a, b, l, lim);
          else
            fma_stripe<true, false, C, SW>(acc, a, b, l, lim);
        }
      }
    }
    cp_async_wait<0>();

    if (active) {
#pragma unroll
      for (int i = 0; i < kBlk; ++i)
#pragma unroll
        for (int j = 0; j < kBlk; ++j) {
          const float v = warp_sum(acc[i][j]);
          if (lane == 0) red[(warp * kBlk + i) * kBlk + j] = v;
        }
    }
    __syncthreads();
    for (int e = tid; e < nloc * kBlk * kBlk; e += kStageThreads) {
      const int bl = e / (kBlk * kBlk), ij = e % (kBlk * kBlk);
      const int a = (first + bl) / nbb * kBlk + ij / kBlk;
      const int b = (first + bl) % nbb * kBlk + ij % kBlk;
      if (a >= na || b >= nb) continue;
      float v = 0.f;
      for (int g = 0; g < groups; ++g)
        v += red[(g * nloc + bl) * kBlk * kBlk + ij];
      out[a * nb + b] = v * lam0;
    }
    __syncthreads();  // red and the ring are free for the next pass
  }
}

template <typename TA, typename TB, int SW>
int launch_partials(const TA* A, const TB* B, const float* lam,
                    i64 lam_stride, int na, int nb, int sym, i64 D,
                    const StageShape& sh, float* part, cudaStream_t stream) {
  auto kern = skinny_partials<TA, TB, SW>;
  if (sh.smem > kSmemBytes) {  // the opt-in, on every launch that needs it
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sh.smem));
    if (err != cudaSuccess) return err;
  }
  const StagePlan plan = stage_plan(D);
  kern<<<plan.ctas, kStageThreads, sh.smem, stream>>>(
      A, B, lam, lam_stride, na, nb, sym, D, plan.chunk, sh.subs, sh.stages,
      part);
  return cudaGetLastError();
}

// The first stage alone: part receives stage_plan(D).ctas rows of na*nb
// floats. Returns RT_BAD_SHAPE when no ring of kMinStages stages fits the
// shared memory (or sym is asked of two tensors), else the launch's CUDA
// error code.
template <typename TA, typename TB>
int skinny_stage(const TA* A, const TB* B, const float* lam, i64 lam_stride,
                 int na, int nb, int sym, i64 D, float* part,
                 cudaStream_t stream) {
  if (sym && (na != nb || static_cast<const void*>(A) !=
                              static_cast<const void*>(B) ||
              sizeof(TA) != sizeof(TB)))
    return RT_BAD_SHAPE;
  const StageShape sh = stage_shape<TA, TB>(na, nb, sym, lam_stride != 0);
  constexpr int wide = wide_sub<TA, TB>();
  if (sh.sw == wide)
    return launch_partials<TA, TB, wide>(A, B, lam, lam_stride, na, nb, sym,
                                         D, sh, part, stream);
  if (sh.sw == wide / 4)
    return launch_partials<TA, TB, wide / 4>(A, B, lam, lam_stride, na, nb,
                                             sym, D, sh, part, stream);
  return RT_BAD_SHAPE;
}

}  // namespace rt

// The first stage's CTA count for D columns on the current device (the
// rows of the caller's partials buffer); the columns each CTA reduces go
// to *chunk when given.
RT_EXPORT int rt_split_plan(long long D, long long* chunk) {
  const rt::StagePlan plan = rt::stage_plan(D);
  if (chunk != nullptr) *chunk = plan.chunk;
  return plan.ctas;
}

namespace rt {

// Columns one ring of the stage holds (stages x tile width) for these
// operands on the current device, or RT_BAD_SHAPE when none fits: each P
// library's rt_stage_ring.
inline int p_ring_columns(int a_dtype, int b_dtype, int na, int nb,
                          int flags) {
  return with_types(a_dtype, b_dtype, [&](auto ta, auto tb) {
    const StageShape sh = stage_shape<decltype(ta), decltype(tb)>(
        na, nb, flags & RT_RING_SYM, flags & RT_RING_VEC_LAM);
    return sh.sw == 0 ? RT_BAD_SHAPE : sh.tw() * sh.stages;
  });
}

}  // namespace rt
