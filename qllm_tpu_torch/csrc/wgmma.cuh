// Hopper warpgroup MMA pieces shared by the wgmma kernels (K10 gptq_gemm
// in csrc/gptq_mm.cu, K18 w4_planar_f32s_gemm in csrc/planar_f32.cu, K2
// w4_planar_gemm in csrc/qmm.cu, K5 flash_prefill in
// csrc/flash_prefill.cu).
//
// The GEMMs (K10, K18, K2) run the product swapped: D [64 output columns, n rows of x] =
// W^T [64, 16 k] (A, bf16 from registers, dequantized in the thread) x
// X^T [16 k, n] (B, bf16 in shared memory). B is an x tile [rows, 64 k]
// as it lies in device memory, k contiguous (K-major), 128 bytes a row,
// written by cp.async into the 128-byte swizzle wgmma reads: the 16-byte
// chunk q of row r sits at chunk q ^ (r % 8) of its row, 8 rows (1024
// bytes) a swizzle atom. Fragment layouts (warp w of the warpgroup owns
// A and D rows 16w .. 16w + 15; gq = lane / 4, c = lane % 4):
//   A: a0 = (row gq, k 2c, 2c+1), a1 = (gq + 8, 2c, 2c+1),
//      a2 = (gq, 2c+8, 2c+9), a3 = (gq + 8, 2c+8, 2c+9), the lower k in
//      the lower half (mma.sync m16n8k16's A);
//   D (m64n64): d[4i + e] = (row gq + 8 (e >> 1), column 8i + 2c + (e & 1)).
#pragma once

#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The descriptor of a K-major bf16 operand in the 128-byte swizzle whose
// atoms follow each other every 1024 bytes, starting at shared address
// `addr` (atom-aligned, plus 32 bytes per 16-k step inside the row).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4)   // start address
         | (static_cast<uint64_t>(1) << 16)              // leading offset (unused when swizzled)
         | (static_cast<uint64_t>(1024 >> 4) << 32)      // stride between 8-row atoms
         | (static_cast<uint64_t>(1) << 62);             // 128-byte swizzle
}

// the byte offset of row r, 16-byte chunk q (of 8) in a swizzled
// [rows, 64] bf16 tile
__device__ __forceinline__ uint32_t sw128_offset(int r, int q) { return r * 128 + ((q ^ (r & 7)) << 4); }

// 16 bytes global -> shared address `saddr` (zero-filled when !pred)
__device__ __forceinline__ void cp_async16_s(uint32_t saddr, const void* gmem, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(gmem), "r"(pred ? 16 : 0));
}

// cp.async writes through the generic proxy and wgmma reads through the
// async one: each thread fences its landed copies before the barrier
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving an accumulator across the async product
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(d[i]);
}

// A registers read here, in program order among the asm statements: all
// computed before (ahead of wgmma.fence), or all still held (after the wait
// that retires the products reading them, so no other value takes their
// registers while those products run). Input-only, so no copy stands in.
__device__ __forceinline__ void keep_regs(const uint32_t (&ar)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    asm volatile("" ::"r"(ar[j][0]), "r"(ar[j][1]), "r"(ar[j][2]), "r"(ar[j][3]) : "memory");
}

// D (+)= A * B: m64n64k16, bf16 in, f32 out; A from registers, B by
// descriptor (K-major); scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// D (+)= A * B: m64n128k16 over two 64-row halves of B (d[0]: x rows 0-63,
// d[1]: 64-127 of the instruction's width), as wgmma_m64n64k16_rs
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[2][32], uint32_t a0, uint32_t a1, uint32_t a2,
                                                    uint32_t a3, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      :
      "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[0][4]), "+f"(d[0][5]),
      "+f"(d[0][6]), "+f"(d[0][7]), "+f"(d[0][8]), "+f"(d[0][9]), "+f"(d[0][10]), "+f"(d[0][11]),
      "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]), "+f"(d[0][15]), "+f"(d[0][16]),
      "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]), "+f"(d[0][20]), "+f"(d[0][21]),
      "+f"(d[0][22]), "+f"(d[0][23]), "+f"(d[0][24]), "+f"(d[0][25]), "+f"(d[0][26]),
      "+f"(d[0][27]), "+f"(d[0][28]), "+f"(d[0][29]), "+f"(d[0][30]), "+f"(d[0][31]),
      "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[1][4]), "+f"(d[1][5]),
      "+f"(d[1][6]), "+f"(d[1][7]), "+f"(d[1][8]), "+f"(d[1][9]), "+f"(d[1][10]), "+f"(d[1][11]),
      "+f"(d[1][12]), "+f"(d[1][13]), "+f"(d[1][14]), "+f"(d[1][15]), "+f"(d[1][16]),
      "+f"(d[1][17]), "+f"(d[1][18]), "+f"(d[1][19]), "+f"(d[1][20]), "+f"(d[1][21]),
      "+f"(d[1][22]), "+f"(d[1][23]), "+f"(d[1][24]), "+f"(d[1][25]), "+f"(d[1][26]),
      "+f"(d[1][27]), "+f"(d[1][28]), "+f"(d[1][29]), "+f"(d[1][30]), "+f"(d[1][31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// the product of one 16-k step over MC 64-row chunks of x: one instruction,
// or at MC = 4 two of 128 rows each (the second's B 16 atoms further)
template <int MC>
__device__ __forceinline__ void wgmma_rs(float (&d)[MC][32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  if constexpr (MC == 1) {
    wgmma_m64n64k16_rs(d[0], a[0], a[1], a[2], a[3], desc_b, scale_d);
  } else if constexpr (MC == 2) {
    wgmma_m64n128k16_rs(d, a[0], a[1], a[2], a[3], desc_b, scale_d);
  } else {
    static_assert(MC == 4, "MC x 64 rows: 1, 2 or 4");
    wgmma_m64n128k16_rs(*reinterpret_cast<float(*)[2][32]>(&d[0]), a[0], a[1], a[2], a[3], desc_b, scale_d);
    wgmma_m64n128k16_rs(*reinterpret_cast<float(*)[2][32]>(&d[2]), a[0], a[1], a[2], a[3], desc_b + (16384 >> 4),
                        scale_d);
  }
}

// The descriptor of an MN-major (transposed) bf16 operand in the 128-byte
// swizzle: rows of 128 bytes hold 64 consecutive values of the N
// dimension, one row per k; 8 rows (k) make a 1024-byte atom, atoms follow
// each other every 1024 bytes along k (the stride offset), and the next 64
// values of N start `panel_bytes` further (the leading offset).
__device__ __forceinline__ uint64_t sw128_desc_mn(uint32_t addr, uint32_t panel_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4)              // start address
         | (static_cast<uint64_t>(panel_bytes >> 4) << 16)          // leading offset: the next 64 of N
         | (static_cast<uint64_t>(1024 >> 4) << 32)                 // stride offset: the next 8 k
         | (static_cast<uint64_t>(1) << 62);                        // 128-byte swizzle
}

// D (+)= A * B: m64nNk16, bf16 in, f32 out, A and B both by descriptor
// (K-major); scale_d = 0 overwrites D. N = 16, 32, 64 (D: N / 2 floats).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b, int scale_d);
template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D += A * B: m64n128k16, A from registers (a0-a3 as in the header), B by
// an MN-major descriptor (sw128_desc_mn: the B operand transposed, its N
// values contiguous)
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// the dynamic shared memory of a block, rounded up to a 1024-byte swizzle
// atom (the launch asks for 1024 bytes more than it uses)
__device__ __forceinline__ unsigned char* atom_aligned(unsigned char* smem) {
  const uint32_t a = smem_u32(smem);
  return smem + (((a + 1023u) & ~1023u) - a);
}

}  // namespace
