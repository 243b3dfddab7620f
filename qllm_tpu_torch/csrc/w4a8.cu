// W4A8 decode matmuls: per-token int8 activations against 4- (and 2-)
// bit weights, s8 x s8 -> s32 products, the counterpart of the JAX
// package's W4A8 kernels (qllm_tpu/ops/pallas_qmm.py):
//
//   * quantize_rows: x [M, K] -> x8 int8, sx [M] f32 and per-group sums of
//     x8; the prologue that K11 and K12 launch first from their own entry
//     points (the JAX package computes it in XLA, :366-367, :1271-1275),
//     for K11 with the RMSNorm JAX runs before its a8 kernel fused in, for
//     K12 with the act-order gather of x fused in;
//   * K11 w4a8_planar_gemv: the a8 branch of _qmm_kernel_planar_full
//     (:832, :871-873, :932-942) on the [L]-stacked planar serving layout.
//
// K12 gptq_w4a8_gemv (csrc/gptq_stacked.cu) runs the quantizer from here
// (launch_quantize_rows) before its product on the tensor-core body.
//
// The quantizer takes x as it arrives (bf16 or f32) and quantizes it
// exactly as the JAX package does: sx = max(max|x_row|, 1e-8) / 127 and x8
// = clip(round_half_even(x / sx), -127, 127), with IEEE division (the
// build uses no fast-math flag), so x8 and sx are JAX's bit for bit. The
// token scale factors out of the whole contraction: y = bf16(sx * sum_g
// (d_g * s_g - sum(x8_g) * zs_g)), d_g the exact integer dot of x8 and the
// weight fields of group g, zs = zeros * scales.

#include "common.cuh"

namespace {

constexpr unsigned kAll = 0xffffffffu;

// ---------------------------------------------------------------------------
// The activation quantizer: one block per row, x8 in natural k order.
// With a perm (K12 on act-order weights) value k of the row is x[perm[k]]:
// the gather JAX runs on x before its kernel, exact, so the bits are the
// gathered x's. Group sums are taken in shared memory with integer
// atomics: exact in any order.
// ---------------------------------------------------------------------------

constexpr int kQuantThreads = 1024;
constexpr int kQuantItems = 16;  // values a thread keeps in registers: rows up to 16384 are read once
constexpr int kQuantMaxK = 32 * 1024;  // the longest row whose group sums are taken (its x8 in shared memory)

__device__ __forceinline__ float load_act(const void* x, int x_f32, size_t i) {
  if (x_f32) return static_cast<const float*>(x)[i];
  return __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
}

// Latency is what bounds this kernel (a few rows of a few thousand
// values): every value of the row is loaded at once, before any use, into
// registers (kQuantItems a thread), reduced to the row's max, then
// quantized from the registers; only rows past 16384 values are read twice.
//
// With a norm weight nw (K11's stacked path) the row is first RMS-
// normalised as the JAX package does before its a8 kernel
// (_rms_norm_rows, pallas_qmm.py:43, :1193-1195): xn = x * rsqrt(mean(x^2)
// + eps) * nw in f32, rounded to x's own dtype, and xn is quantized. The
// mean is summed in a fixed order (per thread, then the warps' tree, then
// the warps in order), so a row's bits do not depend on M.
__device__ __forceinline__ float norm_value(float v, float r, const void* nw, int nw_f32, int k, int x_f32) {
  const float w = nw_f32 ? __ldg(static_cast<const float*>(nw) + k)
                         : __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(nw) + k));
  const float y = v * r * w;
  return x_f32 ? y : round_bf16(y);
}

__global__ void __launch_bounds__(kQuantThreads)
    quantize_rows_kernel(const void* __restrict__ x, int x_f32, const int* __restrict__ perm, int K, int g,
                         const void* __restrict__ nw, int nw_f32, float eps,
                         int8_t* __restrict__ x8, float* __restrict__ sx, int* __restrict__ xsum) {
  constexpr int kWarps = kQuantThreads / 32;
  __shared__ float wred[kWarps];
  extern __shared__ int8_t q8s[];  // [K] the row's x8, for the group sums (xsum only)
  const int m = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = static_cast<size_t>(m) * K;
  const int G = K / g;
  auto at = [&](int k) { return row + (perm != nullptr ? __ldg(perm + k) : k); };  // x's index of value k
  // the values a thread keeps in registers: items of them in range (uniform)
  const int items = min(kQuantItems, (K + kQuantThreads - 1) / kQuantThreads);
  float v[kQuantItems];
#pragma unroll
  for (int j = 0; j < kQuantItems; ++j) {
    if (j >= items) break;
    const int k = tid + j * kQuantThreads;
    v[j] = k < K ? load_act(x, x_f32, at(k)) : 0.f;
  }
  float r = 1.f;  // the row's norm factor
  if (nw != nullptr) {
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < kQuantItems; ++j) {
      if (j >= items) break;
      ss = fmaf(v[j], v[j], ss);
    }
    for (int k = tid + kQuantItems * kQuantThreads; k < K; k += kQuantThreads) {
      const float a = load_act(x, x_f32, at(k));
      ss = fmaf(a, a, ss);
    }
    ss = warp_sum(ss);
    if (lane == 0) wred[warp] = ss;
    __syncthreads();
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tot += wred[w];
    r = rsqrtf(tot / static_cast<float>(K) + eps);
#pragma unroll
    for (int j = 0; j < kQuantItems; ++j) {
      if (j >= items) break;
      const int k = tid + j * kQuantThreads;
      if (k < K) v[j] = norm_value(v[j], r, nw, nw_f32, k, x_f32);
    }
    __syncthreads();  // wred is reused below
  }
  auto value = [&](int k) {  // a value past the registers, read again
    const float a = load_act(x, x_f32, at(k));
    return nw != nullptr ? norm_value(a, r, nw, nw_f32, k, x_f32) : a;
  };
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kQuantItems; ++j) {
    if (j >= items) break;
    amax = fmaxf(amax, fabsf(v[j]));
  }
  for (int k = tid + kQuantItems * kQuantThreads; k < K; k += kQuantThreads) amax = fmaxf(amax, fabsf(value(k)));
  amax = warp_max(amax);
  if (lane == 0) wred[warp] = amax;
  __syncthreads();
  const float top = warp_max(wred[lane]);  // kWarps == 32
  const float s = fmaxf(top, 1e-8f) / 127.0f;
  if (tid == 0) sx[m] = s;
  // each value on its own: no warp-wide step between them, so the values of
  // a thread overlap
  auto emit = [&](int k, float val) {
    const int q = static_cast<int>(fminf(fmaxf(rintf(val / s), -127.f), 127.f));
    x8[row + k] = static_cast<int8_t>(q);
    if (xsum != nullptr) q8s[k] = static_cast<int8_t>(q);
  };
#pragma unroll
  for (int j = 0; j < kQuantItems; ++j) {
    if (j >= items) break;
    const int k = tid + j * kQuantThreads;
    if (k < K) emit(k, v[j]);
  }
  for (int k = tid + kQuantItems * kQuantThreads; k < K; k += kQuantThreads) emit(k, value(k));
  if (xsum == nullptr) return;
  // the group sums, exact: warp w takes groups w, w + kWarps, ..., its
  // lanes a stride of the group each, then a warp sum
  __syncthreads();
  for (int gi = warp; gi < G; gi += kWarps) {
    int acc = 0;
    for (int i = lane; i < g; i += 32) acc += q8s[gi * g + i];
    acc = __reduce_add_sync(kAll, acc);
    if (lane == 0) xsum[static_cast<size_t>(m) * G + gi] = acc;
  }
}

int launch_quantize(const void* x, int x_f32, const int* perm, void* x8, void* sx, void* xsum, int M, int K, int g,
                    cudaStream_t st, const void* nw = nullptr, int nw_f32 = 0, float eps = 0.f) {
  // xsum: the row's x8 in shared memory (below 48 KB: no limit to raise)
  if (M < 1 || K < 1 || g < 1 || K % g != 0 || (xsum != nullptr && K > kQuantMaxK))
    return static_cast<int>(cudaErrorInvalidValue);
  quantize_rows_kernel<<<M, kQuantThreads, xsum != nullptr ? K : 0, st>>>(
      x, x_f32, perm, K, g, nw, nw_f32, eps, static_cast<int8_t*>(x8), static_cast<float*>(sx),
      static_cast<int*>(xsum));
  return 0;
}

// ---------------------------------------------------------------------------
// K11 w4a8_planar_gemv (stacked decode, M <= 32).
//
// Replaces the a8 branch of _qmm_kernel_planar_full: per group, an exact
// s8 x s8 -> s32 dot of x8 with the weight nibbles (0..15 fit s8), then
// in f32 acc += d * s - sum(x8_g) * zs, and y = bf16(acc * sx).
//
// Bound on the H100: bytes (the weight words, read once). K1's design
// with the int8 tensor-core product: mma.sync m16n8k32 s8, 16 output
// columns of weights as A and 8 rows of x8 as B. A planar word (byte j:
// k = 4r + j in the low nibble, K/2 + 4r + j in the high one) masked
// with 0x0F0F0F0F is already four s8 values of A, so no dequantization
// happens at all: thread (gq, c) takes word rows 8t + c and 8t + 4 + c of
// k-tile t, whose low nibbles are k = 32t + 4c + 0..3 and 32t + 16 + 4c +
// 0..3 (A's k slots 4c.. and 16 + 4c..), and x8 at the same k as its two
// B registers (natural order: one 4-byte load each); the high nibbles
// run the same against x8 at K/2 + the same k. Every B fragment is
// reused by the block's 32 columns, and every A fragment by all M rows
// (MT tiles of 8 rows): the words are read once for any M <= 32.
// The x8 sums that the zero-point term needs are taken from the same B
// registers (dp4a against ones), so a warp that covers part of a group
// subtracts exactly its part. The warps split K's tiles and meet in
// shared memory, summed in warp order (no atomics). Groups of g % 32 != 0
// (GENERIC, any g) can close inside a k-tile: the tile then runs once per
// group it touches, each MMA with the x8 bytes of the other groups zeroed,
// and a group closes after its own.
// ---------------------------------------------------------------------------

constexpr int kA8MaxWarps = 8;
constexpr int kA8NT = 2;               // 16-column MMA tiles per block
constexpr int kA8Cols = 16 * kA8NT;    // output columns per block
constexpr int kA8W = 2 * kA8NT;        // consecutive words of a word row per thread
constexpr uint32_t kLowNibbles = 0x0F0F0F0Fu;
constexpr int kOnes = 0x01010101;

template <int MT, int P, bool GENERIC>
__global__ void __launch_bounds__(kA8MaxWarps * 32)
    w4a8_planar_gemv_kernel(const int8_t* __restrict__ x8,         // [M, K]
                            const float* __restrict__ sx,          // [M]
                            const uint32_t* __restrict__ qw,       // [K/8, Np] this layer
                            const __nv_bfloat16* __restrict__ sc,  // [G, Np]
                            const __nv_bfloat16* __restrict__ zs,  // [G, Np]
                            int M, int K, int Np, int g,
                            __nv_bfloat16* __restrict__ out) {     // [M, Np]
  __shared__ float red[kA8MaxWarps][8 * MT][kA8Cols];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int gq = lane >> 2, c = lane & 3;
  const int n0 = blockIdx.x * kA8Cols;
  const int Kh = K / 2;
  const int T = K / 64;    // k-tiles of 8 word rows: 32 low-half + 32 high-half k
  const int upg = g / 16;  // 16-k units per group (g % 32 == 0: two a k-tile)
  const int Gh = Kh / g;
  const int t0 = warp * T / nwarps, t1 = (warp + 1) * T / nwarps;
  const uint32_t* wp = qw + static_cast<size_t>(c) * Np + n0 + kA8W * gq;
  const size_t tile_words = static_cast<size_t>(8) * Np;

  // the next P tiles' words and x8 B registers wait in registers: (low
  // half: k = 32t + 4c.., 32t + 16 + 4c..; high half: the same + K/2)
  uint4 wbuf[P][2];
  uint4 xbuf[P][MT];
  auto load = [&](int i, int t) {
    const uint32_t* src = wp + t * tile_words;
    wbuf[i][0] = __ldcs(reinterpret_cast<const uint4*>(src));           // word row 8t + c
    wbuf[i][1] = __ldcs(reinterpret_cast<const uint4*>(src + 4 * Np));  // word row 8t + 4 + c
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = 8 * mt + gq;
      if (m < M) {
        const int8_t* xr = x8 + static_cast<size_t>(m) * K + 32 * t + 4 * c;
        xbuf[i][mt] = make_uint4(__ldg(reinterpret_cast<const unsigned*>(xr)),
                                 __ldg(reinterpret_cast<const unsigned*>(xr + 16)),
                                 __ldg(reinterpret_cast<const unsigned*>(xr + Kh)),
                                 __ldg(reinterpret_cast<const unsigned*>(xr + Kh + 16)));
      } else {
        xbuf[i][mt] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  int acc_lo[kA8NT][MT][4], acc_hi[kA8NT][MT][4];
  float y[kA8NT][MT][4];
  int xs_lo[MT], xs_hi[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    xs_lo[mt] = xs_hi[mt] = 0;
#pragma unroll
    for (int nt = 0; nt < kA8NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_lo[nt][mt][e] = acc_hi[nt][mt][e] = 0;
        y[nt][mt][e] = 0.f;
      }
  }

  // on0 / on1: byte masks of this thread's k quadruple of the tile's
  // first 16 k and of its last 16 (a zeroed x8 value adds nothing to the
  // dot or the sums)
  auto compute = [&](const uint4 (&w)[2], const uint4 (&xv)[MT], uint32_t on0, uint32_t on1) {
    uint32_t bl0[MT], bl1[MT], bh0[MT], bh1[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      bl0[mt] = xv[mt].x & on0;
      bl1[mt] = xv[mt].y & on1;
      bh0[mt] = xv[mt].z & on0;
      bh1[mt] = xv[mt].w & on1;
      xs_lo[mt] = __dp4a(static_cast<int>(bl1[mt]), kOnes, __dp4a(static_cast<int>(bl0[mt]), kOnes, xs_lo[mt]));
      xs_hi[mt] = __dp4a(static_cast<int>(bh1[mt]), kOnes, __dp4a(static_cast<int>(bh0[mt]), kOnes, xs_hi[mt]));
    }
    const uint32_t r0[kA8W] = {w[0].x, w[0].y, w[0].z, w[0].w};
    const uint32_t r1[kA8W] = {w[1].x, w[1].y, w[1].z, w[1].w};
#pragma unroll
    for (int nt = 0; nt < kA8NT; ++nt) {
      // A row gq is column kA8W*gq + 2nt, A row gq+8 the next column
      const uint32_t a0 = r0[2 * nt], a1 = r0[2 * nt + 1], a2 = r1[2 * nt], a3 = r1[2 * nt + 1];
      const uint32_t l0 = a0 & kLowNibbles, l1 = a1 & kLowNibbles, l2 = a2 & kLowNibbles, l3 = a3 & kLowNibbles;
      const uint32_t h0 = (a0 >> 4) & kLowNibbles, h1 = (a1 >> 4) & kLowNibbles;
      const uint32_t h2 = (a2 >> 4) & kLowNibbles, h3 = (a3 >> 4) & kLowNibbles;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_s8_16832(acc_lo[nt][mt], l0, l1, l2, l3, bl0[mt], bl1[mt]);
        mma_s8_16832(acc_hi[nt][mt], h0, h1, h2, h3, bh0[mt], bh1[mt]);
      }
    }
  };

  // close group grp of each half (or this warp's part of it): y += d * s
  // - sum(x8) * zs for the low-half group and for the high-half one
  auto flush = [&](int grp) {
    const size_t col = static_cast<size_t>(n0 + kA8W * gq);
    const size_t lo = static_cast<size_t>(grp) * Np + col, hi = static_cast<size_t>(Gh + grp) * Np + col;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      int sl_ = xs_lo[mt], sh_ = xs_hi[mt];
      sl_ += __shfl_xor_sync(kAll, sl_, 1);
      sl_ += __shfl_xor_sync(kAll, sl_, 2);
      sh_ += __shfl_xor_sync(kAll, sh_, 1);
      sh_ += __shfl_xor_sync(kAll, sh_, 2);
      // the C fragment holds rows 2c and 2c+1, whose sums sit in lanes 8c, 8c+4
      const float xl0 = static_cast<float>(__shfl_sync(kAll, sl_, 8 * c));
      const float xl1 = static_cast<float>(__shfl_sync(kAll, sl_, 8 * c + 4));
      const float xh0 = static_cast<float>(__shfl_sync(kAll, sh_, 8 * c));
      const float xh1 = static_cast<float>(__shfl_sync(kAll, sh_, 8 * c + 4));
#pragma unroll
      for (int nt = 0; nt < kA8NT; ++nt) {
        const float2 sl = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sc + lo + 2 * nt));
        const float2 zl = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(zs + lo + 2 * nt));
        const float2 sh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sc + hi + 2 * nt));
        const float2 zh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(zs + hi + 2 * nt));
        // C registers: (column 2nt; rows 2c, 2c+1), (column 2nt+1; rows 2c, 2c+1)
        const float s_lo[4] = {sl.x, sl.x, sl.y, sl.y}, z_lo[4] = {zl.x * xl0, zl.x * xl1, zl.y * xl0, zl.y * xl1};
        const float s_hi[4] = {sh.x, sh.x, sh.y, sh.y}, z_hi[4] = {zh.x * xh0, zh.x * xh1, zh.y * xh0, zh.y * xh1};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          y[nt][mt][e] = y[nt][mt][e] + static_cast<float>(acc_lo[nt][mt][e]) * s_lo[e] - z_lo[e];
          y[nt][mt][e] = y[nt][mt][e] + static_cast<float>(acc_hi[nt][mt][e]) * s_hi[e] - z_hi[e];
          acc_lo[nt][mt][e] = acc_hi[nt][mt][e] = 0;
        }
      }
      xs_lo[mt] = xs_hi[mt] = 0;
    }
  };

#pragma unroll
  for (int i = 0; i < P; ++i)
    if (t0 + i < t1) load(i, t0 + i);
  for (int tb = t0; tb < t1; tb += P) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int t = tb + i;
      if (t < t1) {  // uniform across the warp, as mma.sync needs
        const uint4 w[2] = {wbuf[i][0], wbuf[i][1]};
        uint4 xv[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) xv[mt] = xbuf[i][mt];
        if (t + P < t1) load(i, t + P);
        if constexpr (GENERIC) {
          // the tile's groups; per group, the bytes of this thread's two k
          // quadruples that lie in it
          const int g_first = 32 * t / g, g_last = (32 * t + 31) / g;
          for (int gi = g_first; gi <= g_last; ++gi) {
            auto bytes_in = [&](int k0) {  // group gi holds k in [gi g, gi g + g)
              const int lo = gi * g - k0;
              uint32_t m = 0u;
#pragma unroll
              for (int j = 0; j < 4; ++j) m |= (j >= lo && j < lo + g ? 0xFFu : 0u) << (8 * j);
              return m;
            };
            compute(w, xv, bytes_in(32 * t + 4 * c), bytes_in(32 * t + 16 + 4 * c));
            if ((gi + 1) * g <= 32 * t + 32 || t + 1 == t1) flush(gi);
          }
        } else {
          const int u = 2 * t;  // the tile's first 16-k unit
          compute(w, xv, 0xFFFFFFFFu, 0xFFFFFFFFu);
          if ((u + 2) % upg == 0 || t + 1 == t1) flush(u / upg);
        }
      }
    }
  }

  // the warps' partial sums meet in shared memory, summed in warp order
#pragma unroll
  for (int nt = 0; nt < kA8NT; ++nt) {
    const int col = kA8W * gq + 2 * nt;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = 8 * mt + 2 * c;
      red[warp][r][col] = y[nt][mt][0];
      red[warp][r + 1][col] = y[nt][mt][1];
      red[warp][r][col + 1] = y[nt][mt][2];
      red[warp][r + 1][col + 1] = y[nt][mt][3];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 8 * MT * kA8Cols; i += blockDim.x) {
    const int m = i / kA8Cols, col = i % kA8Cols;
    if (m < M) {
      float s = 0.f;
      for (int w = 0; w < nwarps; ++w) s += red[w][m][col];
      out[static_cast<size_t>(m) * Np + n0 + col] = __float2bfloat16_rn(s * sx[m]);
    }
  }
}

template <int MT>
void launch_planar(int warps, cudaStream_t st, const int8_t* x8, const float* sx, const uint32_t* qw,
                   const __nv_bfloat16* sc, const __nv_bfloat16* zs, int M, int K, int Np, int g,
                   __nv_bfloat16* out) {
  // 32 words in flight per thread at MT 1, fewer registers to spare above
  constexpr int P = MT == 1 ? 4 : 2;
  if (g % 32 == 0)
    w4a8_planar_gemv_kernel<MT, P, false><<<Np / kA8Cols, warps * 32, 0, st>>>(x8, sx, qw, sc, zs, M, K, Np, g, out);
  else
    w4a8_planar_gemv_kernel<MT, P, true><<<Np / kA8Cols, warps * 32, 0, st>>>(x8, sx, qw, sc, zs, M, K, Np, g, out);
}

}  // namespace

// K12's prologue (csrc/gptq_stacked.cu): x8, sx and xsum of x [M, K],
// value k of a row taken from x[perm[k]] when perm is not null; a
// cudaError_t for the launch
int launch_quantize_rows(const void* x, int x_f32, const int* perm, void* x8, void* sx, void* xsum, int M, int K,
                         int g, cudaStream_t st) {
  return launch_quantize(x, x_f32, perm, x8, sx, xsum, M, K, g, st);
}

// The quantizer alone (xsum may be null)
QLLM_API int qllm_quantize_rows_int8(const void* x, int x_f32, void* x8, void* sx, void* xsum, int M, int K, int g,
                                     void* stream) {
  const int code = launch_quantize(x, x_f32, nullptr, x8, sx, xsum, M, K, g, static_cast<cudaStream_t>(stream));
  return code != 0 ? code : qllm_launch_status();
}

// K11: the quantizer (with the RMSNorm of layer `layer`'s row of norm_w
// [L, K] first when norm_w is not null) into x8 / sx, scratch the caller
// allocates, then the product; warps: the block's split of K
QLLM_API int qllm_w4a8_planar_gemv(const void* x, int x_f32, void* x8, void* sx, const void* qweight,
                                   const void* scales, const void* zs, const void* norm_w, int nw_f32, float eps,
                                   void* out, int layer, int M, int K, int Np, int g, int warps, void* stream) {
  if (M < 1 || M > 32 || !planar_geometry_ok(K, g) || Np % kA8Cols != 0 ||
      warps < 1 || warps > kA8MaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const void* nw = nullptr;
  if (norm_w != nullptr)
    nw = nw_f32 ? static_cast<const void*>(static_cast<const float*>(norm_w) + static_cast<size_t>(layer) * K)
                : static_cast<const void*>(static_cast<const __nv_bfloat16*>(norm_w) + static_cast<size_t>(layer) * K);
  const int code = launch_quantize(x, x_f32, nullptr, x8, sx, nullptr, M, K, g, st, nw, nw_f32, eps);
  if (code != 0) return code;
  const size_t lw = static_cast<size_t>(K / 8) * Np;
  const size_t ls = static_cast<size_t>(K / g) * Np;
  const auto* q8 = static_cast<const int8_t*>(x8);
  const auto* s8 = static_cast<const float*>(sx);
  const auto* qw = static_cast<const uint32_t*>(qweight) + layer * lw;
  const auto* sc = static_cast<const __nv_bfloat16*>(scales) + layer * ls;
  const auto* zz = static_cast<const __nv_bfloat16*>(zs) + layer * ls;
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (M <= 8)
    launch_planar<1>(warps, st, q8, s8, qw, sc, zz, M, K, Np, g, ob);
  else if (M <= 16)
    launch_planar<2>(warps, st, q8, s8, qw, sc, zz, M, K, Np, g, ob);
  else
    launch_planar<4>(warps, st, q8, s8, qw, sc, zz, M, K, Np, g, ob);
  return qllm_launch_status();
}
