// The second stage of every split-D reduction: the sum over the G partial
// rows that a first stage wrote, part[g * stride + e] for g = 0 .. G-1.
//
// The partials were just written and sit in L2, so the fold is bound by
// the latency of its loads. Each entry's G partials are cut into `runs`
// contiguous runs of g, each summed in g order by one thread, and the runs
// are then added in run order. The tree depends only on G and the shape,
// so two launches give the same bits. No atomics.
//
// The body is fold_entries; reduce_partials (B5) and reduce_mapped (B1,
// B4) call it over 32 entries a block, mvm_small (B3) over one M_r a
// block.
#pragma once

#include "common.cuh"

namespace rt {

// Threads of one reduce_partials block: kFoldRuns warps, one run a warp.
constexpr int kFoldRuns = 8;

// The block folds n entries; entry e's partials start at part + at(e).
// With blockDim.x / n runs an entry (one when n fills the block), the
// runs' sums go to sRun (blockDim.x floats of shared memory) and entry e's
// total to dst[e]. Every thread of the block must call it.
template <typename At>
__device__ void fold_entries(const float* __restrict__ part, i64 stride,
                             int G, int n, At at, float* sRun, float* dst) {
  const int runs = n < (int)blockDim.x ? blockDim.x / n : 1;
  for (int x = threadIdx.x; x < runs * n; x += blockDim.x) {
    const int run = x / n, e = x % n;
    const float* p = part + at(e);
    const int g1 = (run + 1) * G / runs;
    float s = 0.f;
#pragma unroll 8
    for (int g = run * G / runs; g < g1; ++g) s += p[(i64)g * stride];
    (runs > 1 ? sRun : dst)[x] = s;
  }
  if (runs == 1) return;
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    float s = 0.f;
    for (int run = 0; run < runs; ++run) s += sRun[run * n + e];
    dst[e] = s;
  }
}

// out[e] = the sum over g of part[g * stride + e], 32 entries a block.
__global__ void __launch_bounds__(kFoldRuns* kWarp)
    reduce_partials(const float* __restrict__ part, int G, int stride,
                    float* __restrict__ out) {
  __shared__ float sRun[kFoldRuns * kWarp];
  const int e0 = blockIdx.x * kWarp;
  const int n = stride - e0 < kWarp ? stride - e0 : kWarp;
  fold_entries(part + e0, stride, G, n, [](int e) { return e; }, sRun,
               out + e0);
}

inline cudaError_t launch_reduce(const float* part, int G, int stride,
                                 float* out, cudaStream_t stream) {
  reduce_partials<<<(stride + kWarp - 1) / kWarp, kFoldRuns * kWarp, 0,
                    stream>>>(part, G, stride, out);
  return cudaGetLastError();
}

// out[e] = the sum over g of part[g * stride + map(e)] for e < width, 32
// entries a block: map picks the column an entry sums (factor_stage.cuh's
// RowLayout, which reads na off P's diagonal when B is A).
template <typename Map>
__global__ void __launch_bounds__(kFoldRuns* kWarp)
    reduce_mapped(const float* __restrict__ part, int G, int stride,
                  int width, Map map, float* __restrict__ out) {
  __shared__ float sRun[kFoldRuns * kWarp];
  const int e0 = blockIdx.x * kWarp;
  const int n = width - e0 < kWarp ? width - e0 : kWarp;
  fold_entries(part, stride, G, n, [=](int e) { return map(e0 + e); }, sRun,
               out + e0);
}

template <typename Map>
cudaError_t launch_reduce(const float* part, int G, int stride, int width,
                          Map map, float* out, cudaStream_t stream) {
  reduce_mapped<<<(width + kWarp - 1) / kWarp, kFoldRuns * kWarp, 0,
                  stream>>>(part, G, stride, width, map, out);
  return cudaGetLastError();
}

}  // namespace rt
