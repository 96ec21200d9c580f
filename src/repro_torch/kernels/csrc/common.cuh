// Helpers shared by the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel reads f32 or bf16 storage, accumulates in f32 and writes
// f32. Row-major (rows, D) streams are indexed with 64-bit offsets, since
// rows * D passes 2^31 at the sizes the method serves.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {

typedef long long i64;

constexpr int kWarp = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Sum over the 32 lanes of a converged warp; the total lands in lane 0.
// The shuffle tree is fixed, so the result is the same on every run.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// A per-lane factor: a scalar (stride 0) or a (D,) vector (stride 1).
// A null pointer stands for 1.
__device__ __forceinline__ float lane_factor(const float* s, i64 stride,
                                             i64 d) {
  return s == nullptr ? 1.0f : s[d * stride];
}

// Static shared memory a block may take without an opt-in attribute.
constexpr i64 kSmemBytes = 48 * 1024;

}  // namespace rt

// Stream dtype codes, shared with kernels/ops.py.
enum { RT_F32 = 0, RT_BF16 = 1 };
// Flags of each split-D library's rt_stage_ring: B is A, a (D,) lam, V is
// B, a (D,) v_scale.
enum { RT_RING_SYM = 1, RT_RING_VEC_LAM = 2, RT_RING_V_IS_B = 4,
       RT_RING_VEC_VS = 8 };
// Returned by a launcher for a shape or dtype its kernel does not take.
#define RT_BAD_SHAPE (-1)
#define RT_EXPORT extern "C" __attribute__((visibility("default")))

namespace rt {

// Calls f(T1{}, T2{}) with the storage types of two stream dtype codes.
template <typename F>
int with_types(int c1, int c2, F&& f) {
  if (c1 == RT_F32 && c2 == RT_F32) return f(float{}, float{});
  if (c1 == RT_F32 && c2 == RT_BF16) return f(float{}, __nv_bfloat16{});
  if (c1 == RT_BF16 && c2 == RT_F32) return f(__nv_bfloat16{}, float{});
  if (c1 == RT_BF16 && c2 == RT_BF16)
    return f(__nv_bfloat16{}, __nv_bfloat16{});
  return RT_BAD_SHAPE;
}

}  // namespace rt

// Every library exports the message of its launchers' return codes (each
// source is compiled into a library of its own).
RT_EXPORT const char* rt_error_string(int code) {
  return code == RT_BAD_SHAPE ? "shape or dtype not supported by the kernel"
                              : cudaGetErrorString(static_cast<cudaError_t>(code));
}
