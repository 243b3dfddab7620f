// Shared helpers for the qllm_tpu_torch kernels (plain C interface,
// built by qllm_tpu_torch/ops/_build.py for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define QLLM_API extern "C" __attribute__((visibility("default")))

// Every entry point returns this after its launches: a refused launch
// (too many threads, too much shared memory) never runs and is only
// visible here.
static inline int qllm_launch_status() { return static_cast<int>(cudaGetLastError()); }

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }

__device__ __forceinline__ float bf2f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
