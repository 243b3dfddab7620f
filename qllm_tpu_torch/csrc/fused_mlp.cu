// K19 w4_grouped_fused_mlp and K20 w4_pnp_gemv: two W4 products with a
// serial dependency between them, each pair in ONE launch.
//
// K19 replaces _qmm_kernel_grouped_fused (qllm_tpu/ops/pallas_qmm.py:2239,
// called by qmatmul_grouped_experts_fused :2363): for every MoE selection
// i with e = ids[i],
//   gu = x_i @ GU[e] (f32), a = act(gu[:, :K2]) * gu[:, K2:2K2] (f32),
//   y_i = a @ DN[e] -> bf16,
// a single token's whole expert MLP (Qwen3-30B-A3B at batch 1: 8
// selections, K1 = 2048, K2 = 768).
//
// K20 replaces _qmm_kernel_pnp (:1950, called by qmatmul_pnp_stacked
// :2109): hn = h + x1 @ W1[layer] (f32), y2 = rmsnorm(hn) @ W2[layer] ->
// (hn f32, y2 bf16), o_proj, the residual, the post-attention RMSNorm and
// gate|up of a decode step.
//
// Every product is the planar full-K per-group product of the TPU
// kernels (fullk, :1976-2006): y[m,n] = sum_g (x_g . q_g[:,n]) * s_g[n] -
// (sum x_g) * zs_g[n] in f32, bf16 scales and prefolded zs. The second
// product of each pair reads an f32 row (the activation, the normalised
// residual) that the TPU kernels keep in VMEM and never round to bf16;
// here it lives in an f32 scratch in device memory, read through L2.
//
// Design. The TPU kernel walks its grid in order on one core, so phase 2
// simply follows phase 1. On the H100 the blocks run in parallel, so the
// kernel is a cooperative launch (every block co-resident, or the launch
// is refused) over a grid of min(tiles, blocks per SM x SMs) blocks: phase
// 1 hands its column tiles to the blocks in turn, one grid-wide barrier
// (two words in device memory: an arrival count and a generation, left
// ready for the next launch), then phase 2 does the same with its tiles.
// A tile is 128 output columns (4 per lane) over the whole K for up to
// MR rows; the 8 warps of a block split K's word rows, each warp closes a
// group's partial (its part of it) into f32 at the group's end, and the
// warps' sums meet in shared memory in warp order (no atomics: the same
// inputs give the same bits). The dots are f32 FMAs on the CUDA cores:
// a nibble and a bf16 or f32 input multiply exactly or within f32
// rounding, so the f32 inputs of phase 2 are used as they are. K20
// recomputes each row's sum of squares from hn after the barrier, in
// every tile (M x D floats from L2).
//
// Bound on the H100: bytes (the selected experts' or the layer's words,
// scales and zs, read once), ~19 MB for K19 at Qwen3 batch 1 (5.7 us at
// 3.35 TB/s); the f32 FMAs (K19: 38 M a call) keep up with that stream.
// This first version streams 512 bytes a warp per word row, 8 rows in
// flight at one row a tile (K19, K20 at M = 1: 2 blocks a SM), 2 at 8
// rows a tile (K20 at M > 1: 1 block a SM, and 256 FMAs a lane per word
// row): it is not fast (PERF.md).
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;  // output columns of a tile, 4 per lane

// the nibble at bits s..s+3 of w as an exact f32: OR-ed into the mantissa
// of 2^23, then minus 2^23
__device__ __forceinline__ float nib(uint32_t w, int s) {
  return __int_as_float(0x4B000000u | ((w >> s) & 0xFu)) - 8388608.f;
}

__device__ __forceinline__ float4 bf16x4(uint2 v) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// x sources: four consecutive k of row m, in f32
struct XBf16 {  // bf16 rows [.., K] (an input of the launch)
  const __nv_bfloat16* x;
  int K;
  __device__ float4 operator()(int m, int k) const {
    return bf16x4(__ldg(reinterpret_cast<const uint2*>(x + static_cast<size_t>(m) * K + k)));
  }
};

// the gate activation of _qmm_kernel_grouped_fused (:2297-2308): silu, or
// gelu in its tanh form
__device__ __forceinline__ float gate_act(float gt, int gelu) {
  if (gelu) return 0.5f * gt * (1.0f + tanhf(0.7978845608f * (gt + 0.044715f * gt * gt * gt)));
  return gt * (1.0f / (1.0f + expf(-gt)));
}

struct XAct {  // K19 phase 2: act(gate) * up from this selection's f32 gate|up row
  const float* gu;  // written in phase 1: read through L2 (__ldcg)
  int K2, gelu;
  __device__ float4 operator()(int, int k) const {
    const float4 g = __ldcg(reinterpret_cast<const float4*>(gu + k));
    const float4 u = __ldcg(reinterpret_cast<const float4*>(gu + K2 + k));
    return make_float4(gate_act(g.x, gelu) * u.x, gate_act(g.y, gelu) * u.y, gate_act(g.z, gelu) * u.z,
                       gate_act(g.w, gelu) * u.w);
  }
};

struct XNorm {  // K20 phase 2: hn * rstd[m] * nw, f32
  const float* hn;  // written in phase 1: read through L2 (__ldcg)
  int D;
  const float* rstd;  // shared memory
  const void* nw;     // this layer's norm weight
  int nw_f32;
  __device__ float4 operator()(int m, int k) const {
    const float4 h = __ldcg(reinterpret_cast<const float4*>(hn + static_cast<size_t>(m) * D + k));
    const float4 w = nw_f32 ? __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(nw) + k))
                            : bf16x4(__ldg(reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(nw) + k)));
    const float r = rstd[m];
    return make_float4(h.x * r * w.x, h.y * r * w.y, h.z * r * w.z, h.w * r * w.w);
  }
};

// One tile: for rows m < M (<= MR) and columns [col0, col0 + 128) below
// ncols, s = sum_g (x_g . q_g[:, n]) * s_g[n] - (sum x_g) * zs_g[n] over the
// whole K of one layer's (expert's) planar words qw [K/8, Np] with scales
// and zs [G, Np]; epi(m, n, s) takes each result. Planar contract: word
// row r, byte j holds k = 4r+j in its low nibble and K/2+4r+j in its high
// one, so a group of g k-values spans g/4 word rows of each half.
template <int MR, int U, class XS, class Epi>
__device__ void tile_product(const XS& xs, int M, const uint32_t* __restrict__ qw, const __nv_bfloat16* __restrict__ sc,
                             const __nv_bfloat16* __restrict__ zs, int K, int g, int Np, int col0, int ncols,
                             float (*red)[MR][kCols], Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int R = K / 8, Rg = g % 4 == 0 ? g / 4 : 1, Gh = K / 2 / g, Kh = K / 2;
  const int r0 = warp * R / kWarps, r1 = (warp + 1) * R / kWarps;
  const int c0 = col0 + 4 * lane;
  const bool live = c0 < ncols;
  float y[MR][4], dl[MR][4], dh[MR][4], sl[MR], sh[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    sl[m] = sh[m] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) y[m][q] = dl[m][q] = dh[m][q] = 0.f;
  }
  for (int rb = r0; rb < r1; rb += U) {
    uint4 wv[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      wv[u] = (live && rb + u < r1) ? __ldcs(reinterpret_cast<const uint4*>(qw + static_cast<size_t>(rb + u) * Np + c0))
                                    : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = rb + u;
      if (r < r1) {  // uniform across the warp
        const uint32_t w[4] = {wv[u].x, wv[u].y, wv[u].z, wv[u].w};
        float lo[4][4], hi[4][4];  // [column][byte j]
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            lo[q][j] = nib(w[q], 8 * j);
            hi[q][j] = nib(w[q], 8 * j + 4);
          }
        // the row's k = 4r + j (and K/2 + 4r + j) with bit j of `on` set
        auto accum = [&](uint32_t on) {
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            if (m < M) {
              float4 xl = xs(m, 4 * r), xh = xs(m, Kh + 4 * r);
              if (on != 0xFu) {
                xl = make_float4((on & 1u) ? xl.x : 0.f, (on & 2u) ? xl.y : 0.f, (on & 4u) ? xl.z : 0.f,
                                 (on & 8u) ? xl.w : 0.f);
                xh = make_float4((on & 1u) ? xh.x : 0.f, (on & 2u) ? xh.y : 0.f, (on & 4u) ? xh.z : 0.f,
                                 (on & 8u) ? xh.w : 0.f);
              }
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                dl[m][q] =
                    fmaf(xl.x, lo[q][0], fmaf(xl.y, lo[q][1], fmaf(xl.z, lo[q][2], fmaf(xl.w, lo[q][3], dl[m][q]))));
                dh[m][q] =
                    fmaf(xh.x, hi[q][0], fmaf(xh.y, hi[q][1], fmaf(xh.z, hi[q][2], fmaf(xh.w, hi[q][3], dh[m][q]))));
              }
              sl[m] += (xl.x + xl.y) + (xl.z + xl.w);
              sh[m] += (xh.x + xh.y) + (xh.z + xh.w);
            }
          }
        };
        // close the low-half group grp and the high-half one Gh + grp
        auto close = [&](int grp) {
          if (live) {
            const size_t lo_at = static_cast<size_t>(grp) * Np + c0, hi_at = static_cast<size_t>(Gh + grp) * Np + c0;
            const float4 s_l = bf16x4(__ldg(reinterpret_cast<const uint2*>(sc + lo_at)));
            const float4 s_h = bf16x4(__ldg(reinterpret_cast<const uint2*>(sc + hi_at)));
            const float4 z_l = bf16x4(__ldg(reinterpret_cast<const uint2*>(zs + lo_at)));
            const float4 z_h = bf16x4(__ldg(reinterpret_cast<const uint2*>(zs + hi_at)));
            const float sla[4] = {s_l.x, s_l.y, s_l.z, s_l.w}, sha[4] = {s_h.x, s_h.y, s_h.z, s_h.w};
            const float zla[4] = {z_l.x, z_l.y, z_l.z, z_l.w}, zha[4] = {z_h.x, z_h.y, z_h.z, z_h.w};
#pragma unroll
            for (int m = 0; m < MR; ++m)
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                y[m][q] = y[m][q] + dl[m][q] * sla[q] - sl[m] * zla[q];
                y[m][q] = y[m][q] + dh[m][q] * sha[q] - sh[m] * zha[q];
              }
          }
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            sl[m] = sh[m] = 0.f;
#pragma unroll
            for (int q = 0; q < 4; ++q) dl[m][q] = dh[m][q] = 0.f;
          }
        };
        if (g % 4 == 0) {  // the row's quadruple lies in group r / Rg (uniform across the block)
          accum(0xFu);
          if ((r + 1) % Rg == 0 || r + 1 == r1) close(r / Rg);
        } else {
          // the row's k run once per group they touch, the other groups' k zeroed
          const int g_first = 4 * r / g, g_last = (4 * r + 3) / g;
          for (int gi = g_first; gi <= g_last; ++gi) {
            const int lo = gi * g - 4 * r;  // group gi holds k in [gi g, gi g + g)
            uint32_t on = 0u;
#pragma unroll
            for (int j = 0; j < 4; ++j) on |= (j >= lo && j < lo + g ? 1u : 0u) << j;
            accum(on);
            if ((gi + 1) * g <= 4 * r + 4 || r + 1 == r1) close(gi);
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) red[warp][m][4 * lane + q] = y[m][q];
  __syncthreads();
  for (int i = threadIdx.x; i < MR * kCols; i += kThreads) {
    const int m = i / kCols, c = i % kCols;
    if (m < M && col0 + c < ncols) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[w][m][c];
      epi(m, col0 + c, s);
    }
  }
  __syncthreads();  // red is reused by the next tile
}

// Every block of the (cooperative, hence co-resident) grid waits here
// until all have arrived. bar[0] counts arrivals, bar[1] is the
// generation: the last block to arrive resets the count and moves the
// generation on. Writes before the barrier are made visible by the fences;
// what phase 1 wrote is read after it through L2 (__ldcg).
__device__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g0 = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      unsigned spins = 0;
      while (*gen == g0) {
        __nanosleep(64);
        if (++spins > (1u << 28)) __trap();  // a lost block: fail, never hang
      }
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    grouped_fused_mlp_kernel(const __nv_bfloat16* __restrict__ x,      // [n or 1, K1]
                             const uint32_t* __restrict__ gqw,         // [E, K1/8, Np1]
                             const __nv_bfloat16* __restrict__ gsc,    // [E, G1, Np1]
                             const __nv_bfloat16* __restrict__ gzs,    // [E, G1, Np1]
                             const uint32_t* __restrict__ dqw,         // [E, K2/8, Np2]
                             const __nv_bfloat16* __restrict__ dsc,    // [E, G2, Np2]
                             const __nv_bfloat16* __restrict__ dzs,    // [E, G2, Np2]
                             const int* __restrict__ ids,              // [n]
                             float* gu,                                // scratch [n, 2*K2]
                             unsigned* bar, __nv_bfloat16* __restrict__ out,  // [n, Np2]
                             int n, int n_experts, int x_shared, int K1, int K2, int Np1, int Np2, int g, int gelu) {
  __shared__ float red[kWarps][1][kCols];
  const int ct1 = (2 * K2 + kCols - 1) / kCols, ct2 = (Np2 + kCols - 1) / kCols;
  const int G1 = K1 / g, G2 = K2 / g;
  // phase 1: gate|up of every selection, f32, into the scratch
  for (int t = blockIdx.x; t < n * ct1; t += gridDim.x) {
    const int sel = t / ct1, ct = t % ct1;
    const int e = __ldg(ids + sel);
    if (e < 0 || e >= n_experts) continue;  // phase 2 writes the row's NaN
    float* row = gu + static_cast<size_t>(sel) * 2 * K2;
    const XBf16 xs{x + (x_shared ? 0 : static_cast<size_t>(sel) * K1), K1};
    tile_product<1, 8>(xs, 1, gqw + static_cast<size_t>(e) * (K1 / 8) * Np1, gsc + static_cast<size_t>(e) * G1 * Np1,
                       gzs + static_cast<size_t>(e) * G1 * Np1, K1, g, Np1, ct * kCols, 2 * K2, red,
                       [&](int, int c, float s) { row[c] = s; });
  }
  grid_barrier(bar);
  // phase 2: down on act(gate) * up
  for (int t = blockIdx.x; t < n * ct2; t += gridDim.x) {
    const int sel = t / ct2, ct = t % ct2;
    const int e = __ldg(ids + sel);
    __nv_bfloat16* orow = out + static_cast<size_t>(sel) * Np2;
    if (e < 0 || e >= n_experts) {  // uniform across the block
      for (int c = ct * kCols + threadIdx.x; c < min(Np2, (ct + 1) * kCols); c += kThreads)
        orow[c] = __float2bfloat16_rn(__int_as_float(0x7fc00000));
      continue;
    }
    const XAct xs{gu + static_cast<size_t>(sel) * 2 * K2, K2, gelu};
    tile_product<1, 8>(xs, 1, dqw + static_cast<size_t>(e) * (K2 / 8) * Np2, dsc + static_cast<size_t>(e) * G2 * Np2,
                       dzs + static_cast<size_t>(e) * G2 * Np2, K2, g, Np2, ct * kCols, Np2, red,
                       [&](int, int c, float s) { orow[c] = __float2bfloat16_rn(s); });
  }
}

// MR: rows of a K20 tile, 1 for a single row (127 registers: two blocks
// a SM and 8 word rows in flight a warp) or 8 (U = 2 rows in flight)
template <int MR, int U>
__global__ void __launch_bounds__(kThreads)
    pnp_gemv_kernel(const __nv_bfloat16* __restrict__ x1,  // [M, K1]
                    const float* __restrict__ h,           // [M, D]
                    const void* __restrict__ nw, int nw_f32,  // [L, D]
                    const uint32_t* __restrict__ qw1,      // [L, K1/8, D]
                    const __nv_bfloat16* __restrict__ s1,  // [L, G1, D]
                    const __nv_bfloat16* __restrict__ z1,
                    const uint32_t* __restrict__ qw2,      // [L, D/8, Np2]
                    const __nv_bfloat16* __restrict__ s2,  // [L, G2, Np2]
                    const __nv_bfloat16* __restrict__ z2,
                    float* hn,                              // out [M, D], read back in phase 2
                    unsigned* bar, __nv_bfloat16* __restrict__ y2,  // out [M, Np2]
                    int layer, int M, int K1, int D, int Np2, int g1, int g2, float eps) {
  __shared__ float red[kWarps][MR][kCols];
  __shared__ float ssq[kWarps][MR];
  __shared__ float rstd[MR];
  const int chunks = (M + MR - 1) / MR;
  const int ct1 = (D + kCols - 1) / kCols, ct2 = (Np2 + kCols - 1) / kCols;
  const int G1 = K1 / g1, G2 = D / g2;
  const uint32_t* w1 = qw1 + static_cast<size_t>(layer) * (K1 / 8) * D;
  const __nv_bfloat16* sc1 = s1 + static_cast<size_t>(layer) * G1 * D;
  const __nv_bfloat16* zs1 = z1 + static_cast<size_t>(layer) * G1 * D;
  const uint32_t* w2 = qw2 + static_cast<size_t>(layer) * (D / 8) * Np2;
  const __nv_bfloat16* sc2 = s2 + static_cast<size_t>(layer) * G2 * Np2;
  const __nv_bfloat16* zs2 = z2 + static_cast<size_t>(layer) * G2 * Np2;
  const size_t nw_at = static_cast<size_t>(layer) * D;
  const void* nwl = nw_f32 ? static_cast<const void*>(static_cast<const float*>(nw) + nw_at)
                           : static_cast<const void*>(static_cast<const __nv_bfloat16*>(nw) + nw_at);
  // phase 1: hn = h + x1 @ W1
  for (int t = blockIdx.x; t < chunks * ct1; t += gridDim.x) {
    const int m0 = (t / ct1) * MR, ct = t % ct1;
    const int Mc = min(MR, M - m0);
    const XBf16 xs{x1 + static_cast<size_t>(m0) * K1, K1};
    tile_product<MR, U>(xs, Mc, w1, sc1, zs1, K1, g1, D, ct * kCols, D, red, [&](int m, int c, float s) {
      const size_t i = static_cast<size_t>(m0 + m) * D + c;
      hn[i] = s + h[i];
    });
  }
  grid_barrier(bar);
  // phase 2: y2 = (hn * rsqrt(mean(hn^2) + eps) * nw) @ W2
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = blockIdx.x; t < chunks * ct2; t += gridDim.x) {
    const int m0 = (t / ct2) * MR, ct = t % ct2;
    const int Mc = min(MR, M - m0);
    for (int m = 0; m < Mc; ++m) {
      const float* row = hn + static_cast<size_t>(m0 + m) * D;
      float s = 0.f;
      for (int k = 4 * threadIdx.x; k < D; k += 4 * kThreads) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(row + k));
        s = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, s))));
      }
      s = warp_sum(s);
      if (lane == 0) ssq[warp][m] = s;
    }
    __syncthreads();
    if (threadIdx.x < Mc) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += ssq[w][threadIdx.x];
      rstd[threadIdx.x] = 1.0f / sqrtf(s * (1.0f / static_cast<float>(D)) + eps);
    }
    __syncthreads();
    const XNorm xs{hn + static_cast<size_t>(m0) * D, D, rstd, nwl, nw_f32};
    tile_product<MR, U>(xs, Mc, w2, sc2, zs2, D, g2, Np2, ct * kCols, Np2, red, [&](int m, int c, float s) {
      y2[static_cast<size_t>(m0 + m) * Np2 + c] = __float2bfloat16_rn(s);
    });
  }
}

// the grid of a cooperative launch: one block per tile, at most as many
// as fit on the card at once; 0 where the card takes no cooperative launch
int coop_grid(const void* kernel, int tiles) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) != cudaSuccess)
    return 0;
  if (!coop || per_sm < 1) return 0;
  return std::max(1, std::min(tiles, per_sm * sms));
}

// the full-K planar geometry (K % 256 == 0, groups split at K/2, any g);
// a word row's quadruple that straddles two groups runs once per group
bool fullk_geometry(int K, int g) { return g >= 1 && K % 256 == 0 && (K / 2) % g == 0; }

}  // namespace

QLLM_API int qllm_w4_grouped_fused_mlp(const void* x, const void* gqw, const void* gsc, const void* gzs, const void* dqw,
                                       const void* dsc, const void* dzs, const void* ids, void* gu, void* bar, void* out,
                                       int n, int n_experts, int x_shared, int K1, int K2, int Np1, int Np2, int g,
                                       int gelu, void* stream) {
  if (n < 1 || n > 65535 || n_experts < 1 || !fullk_geometry(K1, g) || !fullk_geometry(K2, g) || Np1 < 2 * K2 ||
      Np1 % 4 || Np2 % 4 || Np2 < 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = (const void*)grouped_fused_mlp_kernel;
  const int tiles = n * std::max((2 * K2 + kCols - 1) / kCols, (Np2 + kCols - 1) / kCols);
  const int grid = coop_grid(kernel, tiles);
  if (grid < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&x, &gqw, &gsc, &gzs, &dqw, &dsc, &dzs, &ids, &gu, &bar, &out, &n, &n_experts, &x_shared,
                  &K1, &K2, &Np1, &Np2, &g, &gelu};
  const cudaError_t err =
      cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? static_cast<int>(err) : qllm_launch_status();
}

QLLM_API int qllm_w4_pnp_gemv(const void* x1, const void* h, const void* nw, int nw_f32, const void* qw1,
                              const void* s1, const void* z1, const void* qw2, const void* s2, const void* z2, void* hn,
                              void* bar, void* y2, int layer, int M, int K1, int D, int Np2, int g1, int g2, float eps,
                              void* stream) {
  if (M < 1 || layer < 0 || !fullk_geometry(K1, g1) || !fullk_geometry(D, g2) || Np2 % 4 || Np2 < 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = M == 1 ? (const void*)pnp_gemv_kernel<1, 8> : (const void*)pnp_gemv_kernel<8, 2>;
  const int chunks = M == 1 ? 1 : (M + 7) / 8;
  const int tiles = chunks * std::max((D + kCols - 1) / kCols, (Np2 + kCols - 1) / kCols);
  const int grid = coop_grid(kernel, tiles);
  if (grid < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&x1, &h, &nw, &nw_f32, &qw1, &s1, &z1, &qw2, &s2, &z2, &hn, &bar, &y2, &layer, &M, &K1, &D, &Np2,
                  &g1, &g2, &eps};
  const cudaError_t err =
      cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? static_cast<int>(err) : qllm_launch_status();
}
