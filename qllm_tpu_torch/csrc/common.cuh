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

// D += A * B on the tensor cores: A 16x16 bf16 (row-major fragments),
// B 16x8 bf16 (column-major fragments), D 16x8 f32. Fragment layout,
// with gq = lane / 4 and c = lane % 4: a0 = A[gq][2c, 2c+1],
// a1 = A[gq+8][2c, 2c+1], a2 = A[gq][2c+8, 2c+9], a3 = A[gq+8][2c+8, 2c+9];
// b0 = B[2c, 2c+1][gq], b1 = B[2c+8, 2c+9][gq]; d0, d1 = D[gq][2c, 2c+1],
// d2, d3 = D[gq+8][2c, 2c+1]. The lower half of each register holds the
// lower index.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
