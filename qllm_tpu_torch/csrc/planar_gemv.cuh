// The planar W4 GEMV block, shared by K1 w4_planar_gemv (csrc/qmm.cu) and
// K17 w4_planar_f32s_gemv (csrc/planar_f32.cu).
//
// Planar contract (qllm_tpu/quant/qtensor.py:157-161): word r, byte j
// holds k = 4r+j in its low nibble and k = K/2+4r+j in its high nibble,
// so word row r serves one low-half and one high-half k quadruple and a
// group of g k-values spans g/4 word rows in each half.
//
// With bf16 scales (K1) the block computes
//   y[m,n] = sum_g (x_g . q_g[:,n]) * s_g[n] - (sum x_g) * zs_g[n]
// as bf16 [M, Np]; with f32 scales (K17) it drops the zero-point term,
//   y[m,n] = sum_g (x_g . q_g[:,n]) * s_g[n]
// as f32 [M, Np], and the caller takes the correction off outside. Either
// way the dot is f32-accumulated over the integer nibbles and each
// group's partial is scaled at the group's end. Without the norm x enters
// as bf16; with it (K1) the row is x * rsqrt(mean(x^2) + eps) * w in f32.
// The row factor rsqrt(...) is common to both terms, so the kernel works
// on x * w and scales each row's result by it at the end.
//
// Bound on the H100: bytes (the weight words, read once). At M = 8 each
// 4-byte word feeds 64 multiply-adds; on the f32 CUDA cores that work and
// the unpacking take longer than streaming the words at 3.35 TB/s, so the
// dot runs on the tensor cores: mma.sync m16n8k16 with 16 output columns
// of weights as the A operand and 8 rows of x as the B operand. Nibbles
// 0..15 and bf16 x are exact in bf16, their products are exact and the
// sums are f32, as in the TPU kernels. With the norm, x * w is an f32
// value: it is split into a bf16 part and a bf16 remainder, and both are
// multiplied (two MMAs), which keeps ~16 mantissa bits.
//
// The order of k inside one MMA is free as long as A and B agree, so
// every thread's A registers come from whole planar words: thread (group
// gq, lane-in-group c) takes word row 4t + c of k-tile t, whose low
// nibbles are k = 16t + 4c + 0..3 of the low half of K and whose high
// nibbles are the same k of the high half (one MMA per half), and reads
// x[m, 16t + 4c .. +3] with one 8-byte load for its B registers.
//
// A block owns 16*NT output columns over the whole K; its warps split the
// k-tiles and keep the next P tiles' words in registers while they
// compute (~64 KB of weight loads in flight per SM); each tile a warp
// reads 4 rows x 64*NT contiguous bytes. At each group end the f32
// partial dots are scaled (and the zero-point term subtracted); the
// warps' partial sums meet in shared memory in a fixed order (no atomics:
// repeated runs give identical bits, and the caller picks the warp count
// from K and Np alone, so a row's bits never depend on M). gridDim.y
// walks M in chunks of 8.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kGemvMaxWarps = 16;

// What the planar kernels take (K1, K2, K8, K11, K17-K20; K8 checks it in
// csrc/grouped_mma.cu): K a multiple
// of 128 (whole 64-k tiles of each half) below 2^17, any group size g >= 1
// that splits at K/2 (the JAX package's planar_full_ok). Groups that close
// inside a kernel's k-tile (g % 16 != 0 here) run the tile once per group
// it touches, each time with the other groups' elements zeroed, one bf16
// (or int8) value at a time where a group ends inside a k quadruple.
inline bool planar_geometry_ok(int K, int g) {
  return K % 128 == 0 && K < (1 << 17) && g >= 1 && (K / 2) % g == 0;
}

// AND masks of the bf16 elements e = 0..3 of a 4-value x vector (two
// words, lower element in the lower half) with lo <= e < lo + g: the
// elements k0 + e of the group [k0 + lo, k0 + lo + g)
__device__ __forceinline__ uint2 group_mask4(int lo, int g) {
  uint32_t m[2];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const int e = 2 * w - lo;
    m[w] = (e >= 0 && e < g ? 0x0000FFFFu : 0u) | (e + 1 >= 0 && e + 1 < g ? 0xFFFF0000u : 0u);
  }
  return make_uint2(m[0], m[1]);
}
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 bf16x4_to_float4(uint2 v) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// x * w for four k (f32), split into bf16 part (b0, b1) and remainder
// (r0, r1) fragments; adds their sum to xsum and sum(x^2) to sq
__device__ __forceinline__ void normed_fragments(uint2 xv, float4 w, uint32_t& b0, uint32_t& b1,
                                                 uint32_t& r0, uint32_t& r1, float& xsum, float& sq) {
  const float4 xf = bf16x4_to_float4(xv);
  const float v0 = xf.x * w.x, v1 = xf.y * w.y, v2 = xf.z * w.z, v3 = xf.w * w.w;
  const __nv_bfloat162 h02 = __floats2bfloat162_rn(v0, v2), h13 = __floats2bfloat162_rn(v1, v3);
  const float2 f02 = __bfloat1622float2(h02), f13 = __bfloat1622float2(h13);
  b0 = bf16x2_bits(h02);
  b1 = bf16x2_bits(h13);
  r0 = bf16x2_bits(__floats2bfloat162_rn(v0 - f02.x, v2 - f02.y));
  r1 = bf16x2_bits(__floats2bfloat162_rn(v1 - f13.x, v3 - f13.y));
  xsum += (v0 + v1) + (v2 + v3);
  sq = fmaf(xf.x, xf.x, fmaf(xf.y, xf.y, fmaf(xf.z, xf.z, fmaf(xf.w, xf.w, sq))));
}

__device__ __forceinline__ float4 norm_weight4(const void* nw, int nw_f32, int k) {
  if (nw_f32) return __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(nw) + k));
  return bf16x4_to_float4(__ldg(reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(nw) + k)));
}

__device__ __forceinline__ float sum_bf16x4(uint2 xv) {
  const float4 f = bf16x4_to_float4(xv);
  return (f.x + f.y) + (f.z + f.w);
}

// the scales of two adjacent columns as f32
__device__ __forceinline__ float2 scale_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 scale_pair(const float* p) { return __ldg(reinterpret_cast<const float2*>(p)); }

__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

// S: the scale type; bf16 scales carry the zero-point term (zs) and write
// bf16, f32 scales (K17) have none and write f32
template <int NT, int P, bool NORM, typename S = __nv_bfloat16>
__global__ void __launch_bounds__(kGemvMaxWarps * 32)
    w4_gemv_kernel(const __nv_bfloat16* __restrict__ x,   // [M, K]
                   const uint32_t* __restrict__ qw,       // [K/8, Np] this layer
                   const S* __restrict__ sc,              // [G, Np]
                   const __nv_bfloat16* __restrict__ zs,  // [G, Np] (bf16 scales only)
                   const void* __restrict__ nw,           // [K] norm weight (NORM)
                   int nw_f32, float eps, int M, int K, int Np, int g,
                   typename std::conditional<std::is_same<S, float>::value, float, __nv_bfloat16>::type*
                       __restrict__ out) {                // [M, Np]
  constexpr bool ZS = !std::is_same<S, float>::value;  // the zero-point term
  static_assert(ZS || !NORM, "f32 scales: the plain GEMV only");
  constexpr int kCols = 16 * NT;  // output columns of the block
  constexpr int kW = 2 * NT;      // words per thread per k-tile
  __shared__ float red[kGemvMaxWarps][8][kCols];
  __shared__ float ssq[kGemvMaxWarps][8];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int gq = lane >> 2, c = lane & 3;
  const int n0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * 8;
  const int Kh = K / 2;
  const int T = K / 32;    // k-tiles of 4 word rows: 16 low-half + 16 high-half k
  const int tpg = g / 16;  // k-tiles per group (g % 16 == 0)
  const int Gh = Kh / g;
  const int t0 = warp * T / nwarps, t1 = (warp + 1) * T / nwarps;
  const bool xrow = m0 + gq < M;  // the x row this thread feeds into B
  const __nv_bfloat16* xr = x + static_cast<size_t>(xrow ? m0 + gq : 0) * K + 4 * c;
  const uint32_t* wp = qw + static_cast<size_t>(c) * Np + n0 + kW * gq;
  const size_t tile_words = static_cast<size_t>(4) * Np;

  uint32_t wbuf[P][kW];
  uint2 xbuf[P][2];
  auto load = [&](int i, int t) {
    const uint4* src = reinterpret_cast<const uint4*>(wp + t * tile_words);
#pragma unroll
    for (int j = 0; j < kW / 4; ++j) {
      const uint4 v = __ldcs(src + j);  // streamed once: evict first
      wbuf[i][4 * j] = v.x;
      wbuf[i][4 * j + 1] = v.y;
      wbuf[i][4 * j + 2] = v.z;
      wbuf[i][4 * j + 3] = v.w;
    }
    xbuf[i][0] = xrow ? __ldg(reinterpret_cast<const uint2*>(xr + 16 * t)) : make_uint2(0u, 0u);
    xbuf[i][1] = xrow ? __ldg(reinterpret_cast<const uint2*>(xr + Kh + 16 * t)) : make_uint2(0u, 0u);
  };

  float acc_lo[NT][4], acc_hi[NT][4], y[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_lo[nt][e] = acc_hi[nt][e] = y[nt][e] = 0.f;
  float xs_lo = 0.f, xs_hi = 0.f, sq = 0.f;

  // one k-tile: x fragments, then per n-tile one MMA per half of K (two
  // with the norm's remainder)
  auto compute = [&](const uint32_t (&w)[kW], uint2 xl, uint2 xh, int t) {
    uint32_t bl0, bl1, bh0, bh1, rl0 = 0u, rl1 = 0u, rh0 = 0u, rh1 = 0u;
    if constexpr (NORM) {
      const int k = 16 * t + 4 * c;
      normed_fragments(xl, norm_weight4(nw, nw_f32, k), bl0, bl1, rl0, rl1, xs_lo, sq);
      normed_fragments(xh, norm_weight4(nw, nw_f32, Kh + k), bh0, bh1, rh0, rh1, xs_hi, sq);
    } else {
      x_fragments(xl, bl0, bl1);
      x_fragments(xh, bh0, bh1);
      if constexpr (ZS) {
        xs_lo += sum_bf16x4(xl);
        xs_hi += sum_bf16x4(xh);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      // A row gq is column kW*gq + 2nt, A row gq+8 is the next column
      const uint32_t wa = w[2 * nt], wb = w[2 * nt + 1];
      const uint32_t l0 = nibbles_bf16x2(wa, 0), l1 = nibbles_bf16x2(wb, 0);
      const uint32_t l2 = nibbles_bf16x2(wa, 8), l3 = nibbles_bf16x2(wb, 8);
      const uint32_t h0 = nibbles_bf16x2(wa, 4), h1 = nibbles_bf16x2(wb, 4);
      const uint32_t h2 = nibbles_bf16x2(wa, 12), h3 = nibbles_bf16x2(wb, 12);
      mma_bf16_16816(acc_lo[nt], l0, l1, l2, l3, bl0, bl1);
      mma_bf16_16816(acc_hi[nt], h0, h1, h2, h3, bh0, bh1);
      if constexpr (NORM) {
        mma_bf16_16816(acc_lo[nt], l0, l1, l2, l3, rl0, rl1);
        mma_bf16_16816(acc_hi[nt], h0, h1, h2, h3, rh0, rh1);
      }
    }
  };

  // close group grp (or the part of it this warp covers): y += dot * s
  // (- xsum * zs) for the low-half group and the high-half one
  auto flush = [&](int grp) {
    float xl0 = 0.f, xl1 = 0.f, xh0 = 0.f, xh1 = 0.f;
    if constexpr (ZS) {
      xs_lo += __shfl_xor_sync(kFull, xs_lo, 1);
      xs_lo += __shfl_xor_sync(kFull, xs_lo, 2);
      xs_hi += __shfl_xor_sync(kFull, xs_hi, 1);
      xs_hi += __shfl_xor_sync(kFull, xs_hi, 2);
      // the C fragment holds rows 2c and 2c+1, whose sums sit in lanes 8c, 8c+4
      xl0 = __shfl_sync(kFull, xs_lo, 8 * c);
      xl1 = __shfl_sync(kFull, xs_lo, 8 * c + 4);
      xh0 = __shfl_sync(kFull, xs_hi, 8 * c);
      xh1 = __shfl_sync(kFull, xs_hi, 8 * c + 4);
    }
    const size_t col = static_cast<size_t>(n0 + kW * gq);
    const size_t lo = static_cast<size_t>(grp) * Np + col, hi = static_cast<size_t>(Gh + grp) * Np + col;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 sl = scale_pair(sc + lo + 2 * nt), sh = scale_pair(sc + hi + 2 * nt);
      // C registers: (column 2nt; rows 2c, 2c+1), (column 2nt+1; rows 2c, 2c+1)
      if constexpr (ZS) {
        const float2 zl = scale_pair(zs + lo + 2 * nt), zh = scale_pair(zs + hi + 2 * nt);
        y[nt][0] = y[nt][0] + acc_lo[nt][0] * sl.x - xl0 * zl.x;
        y[nt][1] = y[nt][1] + acc_lo[nt][1] * sl.x - xl1 * zl.x;
        y[nt][2] = y[nt][2] + acc_lo[nt][2] * sl.y - xl0 * zl.y;
        y[nt][3] = y[nt][3] + acc_lo[nt][3] * sl.y - xl1 * zl.y;
        y[nt][0] = y[nt][0] + acc_hi[nt][0] * sh.x - xh0 * zh.x;
        y[nt][1] = y[nt][1] + acc_hi[nt][1] * sh.x - xh1 * zh.x;
        y[nt][2] = y[nt][2] + acc_hi[nt][2] * sh.y - xh0 * zh.y;
        y[nt][3] = y[nt][3] + acc_hi[nt][3] * sh.y - xh1 * zh.y;
      } else {
        y[nt][0] = fmaf(acc_lo[nt][0], sl.x, y[nt][0]);
        y[nt][1] = fmaf(acc_lo[nt][1], sl.x, y[nt][1]);
        y[nt][2] = fmaf(acc_lo[nt][2], sl.y, y[nt][2]);
        y[nt][3] = fmaf(acc_lo[nt][3], sl.y, y[nt][3]);
        y[nt][0] = fmaf(acc_hi[nt][0], sh.x, y[nt][0]);
        y[nt][1] = fmaf(acc_hi[nt][1], sh.x, y[nt][1]);
        y[nt][2] = fmaf(acc_hi[nt][2], sh.y, y[nt][2]);
        y[nt][3] = fmaf(acc_hi[nt][3], sh.y, y[nt][3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_lo[nt][e] = acc_hi[nt][e] = 0.f;
    }
    xs_lo = xs_hi = 0.f;
  };

#pragma unroll
  for (int i = 0; i < P; ++i)
    if (t0 + i < t1) load(i, t0 + i);
  for (int tb = t0; tb < t1; tb += P) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int t = tb + i;
      if (t < t1) {  // uniform across the warp, as mma.sync needs
        uint32_t w[kW];
#pragma unroll
        for (int j = 0; j < kW; ++j) w[j] = wbuf[i][j];
        const uint2 xl = xbuf[i][0], xh = xbuf[i][1];
        if (t + P < t1) load(i, t + P);
        if (g % 16 == 0) {  // one group a tile: uniform across the block
          compute(w, xl, xh, t);
          if ((t + 1) % tpg == 0 || t + 1 == t1) flush(t / tpg);
        } else {
          // the tile touches groups g_first .. g_last; it runs once per
          // group, with the x of the other groups' k zeroed (the high half's
          // groups are the low half's + G/2: the same mask)
          const int g_first = 16 * t / g, g_last = (16 * t + 15) / g;
          for (int gi = g_first; gi <= g_last; ++gi) {
            const uint2 on = group_mask4(gi * g - (16 * t + 4 * c), g);
            compute(w, make_uint2(xl.x & on.x, xl.y & on.y), make_uint2(xh.x & on.x, xh.y & on.y), t);
            if ((gi + 1) * g <= 16 * t + 16 || t + 1 == t1) flush(gi);
          }
        }
      }
    }
  }

  // the warps' partial sums meet in shared memory, summed in warp order
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = kW * gq + 2 * nt;
    red[warp][2 * c][col] = y[nt][0];
    red[warp][2 * c + 1][col] = y[nt][1];
    red[warp][2 * c][col + 1] = y[nt][2];
    red[warp][2 * c + 1][col + 1] = y[nt][3];
  }
  if constexpr (NORM) {
    sq += __shfl_xor_sync(kFull, sq, 1);
    sq += __shfl_xor_sync(kFull, sq, 2);
    if (c == 0) ssq[warp][gq] = sq;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 8 * kCols; i += blockDim.x) {
    const int m = i / kCols, col = i % kCols;
    if (m0 + m < M) {
      float s = 0.f;
      for (int w = 0; w < nwarps; ++w) s += red[w][m][col];
      if constexpr (NORM) {
        float q = 0.f;
        for (int w = 0; w < nwarps; ++w) q += ssq[w][m];
        s *= rsqrtf(q * (1.0f / static_cast<float>(K)) + eps);
      }
      store_out(out + static_cast<size_t>(m0 + m) * Np + n0 + col, s);
    }
  }
}

}  // namespace
