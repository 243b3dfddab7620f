// K19 w4_grouped_fused_mlp and K20 w4_pnp_gemv: two W4 products with a
// serial dependency between them, each pair in ONE cooperative launch.
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
// here it lives in a scratch in device memory, read through L2.
//
// The TPU kernel walks its grid in order on one core, so phase 2 simply
// follows phase 1. On the H100 the blocks run in parallel, so each kernel
// is a cooperative launch (every block co-resident, or the launch is
// refused) whose phases meet at grid-wide barriers (two words in device
// memory: an arrival count and a generation, left ready for the next
// launch; no atomics in any sum: the same inputs give the same bits).
//
// K19 (the first design): 128 output columns a tile over the whole K, the
// 8 warps of a block splitting K's word rows, f32 FMAs on the CUDA cores
// meeting in shared memory in warp order; bound by bytes (~19 MB at Qwen3
// batch 1, 5.7 us at 3.35 TB/s), it runs at ~7x that (PERF.md).
//
// K20 on the tensor-core body (csrc/stacked_mma.cuh, planar_consume):
// persistent blocks, each a producer warp that streams the words of its
// items into the shared-memory ring and four consumer warps on mma.sync,
// walk
//   phase 1: o_proj's (row chunk, 128 columns, split of K1) items on bf16
//            x1 (exact in bf16), each split's f32 partial sums to scratch;
//   barrier; merge, by (row, 128 columns) over the grid: hn = (the splits
//            in split order) + h, written out; x~ = hn * w (f32) as three
//            exact bf16 parts hi + mid + lo, stored planar-interleaved; sum
//            hn^2 of each (row, tile) in a fixed order;
//   barrier; r_m = rsqrt(sum of the tiles' sums / D + eps), each block;
//   phase 2: gate|up's items on x~ (kXParts3: three MMAs on each A), the
//            splits' partial sums to scratch (unsplit: bf16(r_m y) straight
//            out);
//   barrier; y2 = bf16(r_m * the splits in split order).
// The producer runs on into phase 2's words while the consumers wait at
// the barriers. Items are at most 8 rows (one n-tile), and the splits of
// K1 and D come from the shapes alone (ops.qmm.planar_splits), so a row's
// bits depend neither on M nor on the grid. Bound: bytes (both layers'
// words, scales and zs, read once), 57 MB at the 7B (17 us at 3.35 TB/s).
#include <algorithm>

#include "common.cuh"
#include "stacked_mma.cuh"

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
// until all have arrived; sync() joins the block's threads that take part
// (thread 0 among them). bar[0] counts arrivals, bar[1] is the
// generation: the last block to arrive resets the count and moves the
// generation on. Writes before the barrier are made visible by the fences;
// what another block wrote is read after it through L2 (__ldcg, cp.async.cg).
template <class Sync>
__device__ void grid_barrier(unsigned* bar, Sync sync) {
  sync();
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
  sync();
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
  grid_barrier(bar, [] { __syncthreads(); });
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

namespace sm = stacked_mma;

constexpr int kPnpRows = 8;  // the rows of x an item takes: one n-tile
// the x rows and parameters a chunk may stage: with the ring, four blocks an SM
constexpr int kPnpXBudget = 38 * 1024;

// K20: one layer's pointers; hn, part1, x3, sq, part2 as the C entry's
__global__ void __launch_bounds__(sm::kBlock, 4)
    pnp_kernel(const __nv_bfloat16* __restrict__ x1,  // [M, K1]
               const float* __restrict__ h,           // [M, D]
               const void* __restrict__ nw, int nw_f32,  // [D] the norm weight
               const uint32_t* __restrict__ w1,       // [K1/8, D]
               const __nv_bfloat16* __restrict__ s1, const __nv_bfloat16* __restrict__ z1,  // [G1, D]
               const uint32_t* __restrict__ w2,       // [D/8, Np2]
               const __nv_bfloat16* __restrict__ s2, const __nv_bfloat16* __restrict__ z2,  // [G2, Np2]
               float* hn, float* part1, __nv_bfloat16* x3, float* sq, float* part2, unsigned* bar,
               __nv_bfloat16* __restrict__ y2, int M, int K1, int D, int Np2, int g1, int g2, int splits1,
               int per1, int splits2, int per2, int kc1, int kc2, float eps) {
  constexpr int S = sm::Planar::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[sm::kWarps];  // a merge's sum of squares by warp
  __shared__ float rr[32];           // the rows' norm factors
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S;
  unsigned char* ring = smem + sm::kBarBytes;
  unsigned char* xt = ring + S * 4 * sm::ring_row_bytes<sm::Planar>();
  const int chunks = (M + kPnpRows - 1) / kPnpRows;
  const int T1 = D / sm::kCols, T2 = (Np2 + sm::kCols - 1) / sm::kCols, W1 = K1 / 8, W2 = D / 8;
  const int items1 = chunks * T1 * splits1, items2 = chunks * T2 * splits2;
  // item i of a phase: rows of chunk i % chunks, columns of tile (i /
  // chunks) % T, split i / (chunks T)
  sm::init_ring<S>(full, empty, false);
  if ((threadIdx.x >> 5) == sm::kWarps) {  // the producer: phase 1's items, then phase 2's, without a stop
    const int lane = threadIdx.x & 31;
    int t = 0;
    for (int i = blockIdx.x; i < items1; i += gridDim.x) {
      const int ct = i / chunks % T1, u0 = i / (chunks * T1) * per1;
      t = sm::produce<sm::Planar>(w1, full, empty, ring, lane, ct * sm::kCols, D, u0, min(W1, u0 + per1), W1,
                                  sm::kCopyLanes, t);
    }
    for (int i = blockIdx.x; i < items2; i += gridDim.x) {
      const int ct = i / chunks % T2, u0 = i / (chunks * T2) * per2;
      t = sm::produce<sm::Planar>(w2, full, empty, ring, lane, ct * sm::kCols, Np2, u0, min(W2, u0 + per2), W2,
                                  sm::kCopyLanes, t);
    }
    return;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const auto sync = [] { sm::consumers_sync(); };
  int t = 0;
  // phase 1: o_proj, each split's partial sums
  for (int i = blockIdx.x; i < items1; i += gridDim.x) {
    const int m0 = i % chunks * kPnpRows, ct = i / chunks % T1, s = i / (chunks * T1), u0 = s * per1;
    sync();  // the last item's tile is read
    t = sm::planar_consume<1, sm::kXBf16, true>(full, empty, ring, xt, x1 + static_cast<size_t>(m0) * K1, K1,
                                                nullptr, s1, z1, min(kPnpRows, M - m0), K1, D, g1, ct * sm::kCols, u0,
                                                min(W1, u0 + per1), kc1,
                                                part1 + (static_cast<size_t>(s) * M + m0) * D, nullptr, nullptr, t);
  }
  grid_barrier(bar, sync);
  // merge, item (row m, tile ct): columns n = ct * 128 + tid of row m; hn =
  // the splits in split order + h; x~ = hn * w as hi, mid, lo (each
  // difference exact in f32) at the planar-interleaved place of k = n in
  // rows 3m .. 3m + 2; the row's sum of squares over the tile
  for (int i = blockIdx.x; i < M * T1; i += gridDim.x) {
    const int m = i / T1, ct = i - m * T1, n = ct * sm::kCols + tid;
    float acc = 0.f;
    for (int s = 0; s < splits1; ++s) acc += __ldcg(part1 + (static_cast<size_t>(s) * M + m) * D + n);
    const float v = acc + __ldg(h + static_cast<size_t>(m) * D + n);
    hn[static_cast<size_t>(m) * D + n] = v;
    const float w = nw_f32 ? __ldg(static_cast<const float*>(nw) + n)
                           : __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(nw) + n));
    const int half = n >= D / 2, k = n - half * (D / 2);
    __nv_bfloat16* xr = x3 + static_cast<size_t>(3 * m) * D + (k / 4) * 8 + 4 * half + (k & 3);
    float p = v * w;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const __nv_bfloat16 b = __float2bfloat16_rn(p);
      xr[static_cast<size_t>(q) * D] = b;
      p -= __bfloat162float(b);
    }
    const float ss = warp_sum(v * v);
    if (lane == 0) red[warp] = ss;
    sync();
    if (tid == 0) sq[static_cast<size_t>(m) * T1 + ct] = ((red[0] + red[1]) + red[2]) + red[3];
    sync();
  }
  grid_barrier(bar, sync);
  if (tid < M) {  // read after the next sync
    float q = 0.f;
    for (int ct = 0; ct < T1; ++ct) q += __ldcg(sq + static_cast<size_t>(tid) * T1 + ct);
    rr[tid] = rsqrtf(q * (1.0f / static_cast<float>(D)) + eps);
  }
  // phase 2: gate|up on x~'s parts
  for (int i = blockIdx.x; i < items2; i += gridDim.x) {
    const int m0 = i % chunks * kPnpRows, ct = i / chunks % T2, s = i / (chunks * T2), u0 = s * per2;
    sync();
    t = sm::planar_consume<1, sm::kXParts3, true>(
        full, empty, ring, xt, x3 + static_cast<size_t>(3 * m0) * D, D, nullptr, s2, z2, min(kPnpRows, M - m0), D,
        Np2, g2, ct * sm::kCols, u0, min(W2, u0 + per2), kc2,
        splits2 > 1 ? part2 + (static_cast<size_t>(s) * M + m0) * Np2 : nullptr, y2 + static_cast<size_t>(m0) * Np2,
        rr + m0, t);
  }
  if (splits2 == 1) return;
  grid_barrier(bar, sync);
  // y2 = bf16(r_m * the splits in split order)
  const size_t MN = static_cast<size_t>(M) * Np2;
  for (size_t i = static_cast<size_t>(blockIdx.x) * sm::kThreads + tid; i < MN;
       i += static_cast<size_t>(gridDim.x) * sm::kThreads) {
    float acc = 0.f;
    for (int s = 0; s < splits2; ++s) acc += __ldcg(part2 + s * MN + i);
    y2[i] = __float2bfloat16_rn(acc * rr[i / Np2]);
  }
}

// the grid of a cooperative launch: one block per work item, at most as
// many as fit on the card at once; 0 where the card takes no cooperative launch
int coop_grid(const void* kernel, int items, int threads, int smem) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) != cudaSuccess)
    return 0;
  if (!coop || per_sm < 1) return 0;
  return std::max(1, std::min(items, per_sm * sms));
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
  const int grid = coop_grid(kernel, tiles, kThreads, 0);
  if (grid < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&x, &gqw, &gsc, &gzs, &dqw, &dsc, &dzs, &ids, &gu, &bar, &out, &n, &n_experts, &x_shared,
                  &K1, &K2, &Np1, &Np2, &g, &gelu};
  const cudaError_t err =
      cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? static_cast<int>(err) : qllm_launch_status();
}

// K20: layer `layer` of the stacks; hn [M, D] and y2 [M, Np2] the outputs;
// scratch part1 [splits1, M, D] f32, x3 [M, 3, D] bf16, sq [M, D / 128]
// f32 and, when splits2 > 1, part2 [splits2, M, Np2] f32; K1 split in
// splits1 of per1 word rows, D in splits2 of per2; bar: the grid barrier's
// two words
QLLM_API int qllm_w4_pnp_gemv(const void* x1, const void* h, const void* nw, int nw_f32, const void* qw1,
                              const void* s1, const void* z1, const void* qw2, const void* s2, const void* z2, void* hn,
                              void* part1, void* x3, void* sq, void* part2, void* bar, void* y2, int layer, int M,
                              int K1, int D, int Np2, int g1, int g2, int splits1, int per1, int splits2, int per2,
                              float eps, void* stream) {
  using sm::aligned16;
  if (M < 1 || M > 32 || layer < 0 || !planar_geometry_ok(K1, g1) || !planar_geometry_ok(D, g2) || Np2 % 4 ||
      Np2 < 4 || !sm::split_plan_ok(K1 / 8, splits1, per1) || !sm::split_plan_ok(D / 8, splits2, per2) ||
      (splits2 > 1 && part2 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t l = static_cast<size_t>(layer), G1 = K1 / g1, G2 = D / g2;
  const auto* w1 = static_cast<const uint32_t*>(qw1) + l * (K1 / 8) * D;
  const auto* sc1 = static_cast<const __nv_bfloat16*>(s1) + l * G1 * D;
  const auto* zs1 = static_cast<const __nv_bfloat16*>(z1) + l * G1 * D;
  const auto* w2 = static_cast<const uint32_t*>(qw2) + l * (D / 8) * Np2;
  const auto* sc2 = static_cast<const __nv_bfloat16*>(s2) + l * G2 * Np2;
  const auto* zs2 = static_cast<const __nv_bfloat16*>(z2) + l * G2 * Np2;
  const void* nwl = static_cast<const char*>(nw) + l * D * (nw_f32 ? 4 : 2);
  if (!aligned16(x1) || !aligned16(w1) || !aligned16(sc1) || !aligned16(zs1) || !aligned16(w2) || !aligned16(sc2) ||
      !aligned16(zs2) || !aligned16(part1) || !aligned16(x3) || (part2 != nullptr && !aligned16(part2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = std::min(M, kPnpRows);
  int kc1 = sm::planar_chunk_units(rows, per1, g1, 2, 2, false, kPnpXBudget);
  int kc2 = sm::planar_chunk_units(3 * rows, per2, g2, 2, 2, false, kPnpXBudget);
  const int smem = sm::ring_bytes<sm::Planar>() + std::max(sm::planar_chunk_bytes(rows, kc1, g1, 2, 2, false),
                                                           sm::planar_chunk_bytes(3 * rows, kc2, g2, 2, 2, false));
  static int allowed[kMaxDevices];
  if (const int e = allow_dynamic_smem(pnp_kernel, smem, allowed)) return e;
  const int chunks = (M + kPnpRows - 1) / kPnpRows;
  const int items = std::max(chunks * (D / sm::kCols) * splits1, chunks * ((Np2 + sm::kCols - 1) / sm::kCols) * splits2);
  const void* kernel = (const void*)pnp_kernel;
  const int grid = coop_grid(kernel, items, sm::kBlock, smem);
  if (grid < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&x1, &h, &nwl, &nw_f32, &w1, &sc1, &zs1, &w2, &sc2, &zs2, &hn, &part1, &x3, &sq, &part2, &bar, &y2,
                  &M, &K1, &D, &Np2, &g1, &g2, &splits1, &per1, &splits2, &per2, &kc1, &kc2, &eps};
  const cudaError_t err =
      cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(sm::kBlock), args, smem, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? static_cast<int>(err) : qllm_launch_status();
}
