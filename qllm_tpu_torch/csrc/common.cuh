// Shared helpers for the qllm_tpu_torch kernels (plain C interface,
// built by qllm_tpu_torch/ops/_build.py for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define QLLM_API extern "C" __attribute__((visibility("default")))

// Every entry point returns this after its launches: a refused launch
// (too many threads, too much shared memory) never runs and is only
// visible here.
static inline int qllm_launch_status() { return static_cast<int>(cudaGetLastError()); }

// What the planar kernels take (K1, K2, K8, K11, K17-K20): K a multiple of
// 128 (whole 64-k tiles of each half) below 2^17, any group size g >= 1
// that splits at K/2 (the JAX package's planar_full_ok). Groups that close
// inside a kernel's k-tile run the tile once per group it touches, each
// time with the other groups' elements zeroed, one bf16 (or int8) value at
// a time where a group ends inside a k quadruple.
inline bool planar_geometry_ok(int K, int g) { return K % 128 == 0 && K < (1 << 17) && g >= 1 && (K / 2) % g == 0; }

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }

__device__ __forceinline__ float bf2f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// an activation stored as f32 (x_f32 = 1) or bf16, as f32
__device__ __forceinline__ float load_x(const void* x, int x_f32, size_t i) {
  if (x_f32) return static_cast<const float*>(x)[i];
  return __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
}

// `p` advanced by `i` elements of a parameter stored as type 0 (f32), 1
// (fp16) or 2 (bf16)
inline const void* param_offset(const void* p, int type, size_t i) {
  return static_cast<const char*>(p) + i * (type == 0 ? 4 : 2);
}

// The partial sums of K-split GEMV blocks, part [splits, MN], added in
// split order and written as bf16 (out_bf16 = 1) or f32: a row's result
// depends on the split count alone, never on M
static __global__ void split_sum_out_kernel(const float* __restrict__ part, int splits, int MN, int out_bf16,
                                            void* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[static_cast<size_t>(s) * MN + i];
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(acc);
  else
    static_cast<float*>(out)[i] = acc;
}

// a scale or zero point stored as f32 (type 0), fp16 (1) or bf16 (2), as f32
__device__ __forceinline__ float load_param(const void* p, int type, size_t i) {
  if (type == 0) return __ldg(static_cast<const float*>(p) + i);
  if (type == 1) return __half2float(__ldg(static_cast<const __half*>(p) + i));
  return __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(p) + i));
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

// D += A * B: A 16x32 s8 (row-major fragments), B 32x8 s8 (column-major),
// D 16x8 s32. With gq = lane / 4 and c = lane % 4: a0 = A[gq][4c..4c+3],
// a1 = A[gq+8][4c..], a2 = A[gq][16+4c..], a3 = A[gq+8][16+4c..];
// b0 = B[4c..4c+3][gq], b1 = B[16+4c..][gq]; d0, d1 = D[gq][2c, 2c+1],
// d2, d3 = D[gq+8][2c, 2c+1]. The lowest byte holds the lowest index.
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// D += A * B: A 16x16 s8, B 16x8 s8, D 16x8 s32, with a0 = A[gq][4c..4c+3],
// a1 = A[gq+8][4c..4c+3], b0 = B[4c..4c+3][gq]; D as mma_s8_16832's
__device__ __forceinline__ void mma_s8_16816(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// the nibbles at bits s..s+3 and s+16..s+19 of w as an exact bf16 pair:
// OR-ed into the mantissa of 128.0 they give 128 + v, then minus 128
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t w, int s) {
  uint32_t v = ((w >> s) & 0x000F000Fu) | 0x43004300u;
  return bf16x2_bits(__hsub2(*reinterpret_cast<__nv_bfloat162*>(&v), __floats2bfloat162_rn(128.f, 128.f)));
}

// 16 bytes global -> shared without the registers (zero-filled when
// !pred), then commit the copies issued so far as one group, and wait
// until at most N groups are in flight
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

constexpr int kMaxDevices = 64;

// Let `kernel` launch with `bytes` of dynamic shared memory on the current
// device (above 48 KB a kernel needs its limit raised): `allowed` is the
// kernel's own zero-initialised table of the limits raised so far, per
// device. Returns a cudaError_t.
template <typename Kernel>
inline int allow_dynamic_smem(Kernel kernel, int bytes, int (&allowed)[kMaxDevices]) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (bytes > allowed[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed[dev] = bytes;
  }
  return 0;
}

// 4 bytes global -> shared (zero-filled when !pred), through L1
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(pred ? 4 : 0));
}
