// K1 w4_planar_gemv and K2 w4_planar_gemm: the planar W4 g-grouped
// matmul y = x @ dequant(W[layer]) on [L]-stacked serving weights
// (qweight [L, K/8, Np] planar words, scales / zs [L, G, Np] bf16,
// zs = zeros * scales prefolded), output bf16 [M, Np]. K8
// w4_grouped_gemv: K1 over MoE selections, y[i] = x[i] @ dequant(W[ids[i]]).
//
// Planar contract (qllm_tpu/quant/qtensor.py:157-161): word r, byte j
// holds k = 4r+j in its low nibble and k = K/2+4r+j in its high nibble,
// so word row r serves one low-half and one high-half k quadruple and a
// group of g k-values spans g/4 word rows in each half.

#include "common.cuh"

// ---------------------------------------------------------------------------
// K1 w4_planar_gemv (decode, M <= 32).
//
// Replaces the per-group branch of _qmm_kernel_planar_full
// (qllm_tpu/ops/pallas_qmm.py:832, :917-954) with its fused RMSNorm
// (:883-893), driven by _qmm_2d_stacked / qmatmul_pallas_stacked:
//   y[m,n] = sum_g (x_g . q_g[:,n]) * s_g[n] - (sum x_g) * zs_g[n]
// with an f32-accumulated dot over the integer nibbles. Without the norm
// x enters as bf16; with it the row is x * rsqrt(mean(x^2) + eps) * w in
// f32. The row factor rsqrt(...) is common to both terms, so the kernel
// works on x * w and scales each row's result by it at the end.
//
// Bound on the H100: bytes (the weight words, read once). At M = 8 each
// 4-byte word feeds 64 multiply-adds; on the f32 CUDA cores that work and
// the unpacking take longer than streaming the words at 3.35 TB/s, so the
// dot runs on the tensor cores: mma.sync m16n8k16 with 16 output columns
// of weights as the A operand and 8 rows of x as the B operand. Nibbles
// 0..15 and bf16 x are exact in bf16, their products are exact and the
// sums are f32, as in the TPU kernel. With the norm, x * w is an f32
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
// partial dots are scaled and the zero-point term subtracted; the warps'
// partial sums meet in shared memory in a fixed order (no atomics:
// repeated runs give identical bits). gridDim.y walks M in chunks of 8.
// ---------------------------------------------------------------------------

namespace {

constexpr int kGemvMaxWarps = 16;
constexpr unsigned kFull = 0xffffffffu;

// the nibbles at bits s..s+3 and s+16..s+19 of w as an exact bf16 pair:
// OR-ed into the mantissa of 128.0 they give 128 + v, then minus 128
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t w, int s) {
  uint32_t v = ((w >> s) & 0x000F000Fu) | 0x43004300u;
  return bf16x2_bits(__hsub2(*reinterpret_cast<__nv_bfloat162*>(&v), __floats2bfloat162_rn(128.f, 128.f)));
}

// the A registers take nibbles (0, 2) and (1, 3) of a word's bytes, so
// the B registers take x values (k0, k2) and (k1, k3) of the same four k
__device__ __forceinline__ void x_fragments(uint2 xv, uint32_t& b0, uint32_t& b1) {
  b0 = __byte_perm(xv.x, xv.y, 0x5410);
  b1 = __byte_perm(xv.x, xv.y, 0x7632);
}

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

template <int NT, int P, bool NORM, bool GROUPED>
__global__ void __launch_bounds__(kGemvMaxWarps * 32)
    w4_gemv_kernel(const __nv_bfloat16* __restrict__ x,   // [M, K]
                   const uint32_t* __restrict__ qw,       // [K/8, Np] this layer
                   const __nv_bfloat16* __restrict__ sc,  // [G, Np]
                   const __nv_bfloat16* __restrict__ zs,  // [G, Np]
                   const void* __restrict__ nw,           // [K] norm weight (NORM)
                   int nw_f32, float eps, int M, int K, int Np, int g,
                   __nv_bfloat16* __restrict__ out,       // [M, Np]
                   // GROUPED (K8) only: per-selection expert ids [n] into an
                   // [n_experts] stack, and whether every selection reads x row 0
                   const int* __restrict__ ids, int n_experts, int x_shared) {
  constexpr int kCols = 16 * NT;  // output columns of the block
  constexpr int kW = 2 * NT;      // words per thread per k-tile
  __shared__ float red[kGemvMaxWarps][8][kCols];
  __shared__ float ssq[kGemvMaxWarps][8];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int gq = lane >> 2, c = lane & 3;
  const int n0 = blockIdx.x * kCols;
  const int m0 = GROUPED ? 0 : blockIdx.y * 8;
  if constexpr (GROUPED) {
    // blockIdx.y is selection `sel`: one x row (M = 1) against expert
    // ids[sel], whose words start ids[sel] * (K/8) * Np words into the
    // stack (64-bit: an [L*E] stack passes 2^31 words)
    const int sel = blockIdx.y;
    const int e = ids[sel];
    out += static_cast<size_t>(sel) * Np;
    if (e < 0 || e >= n_experts) {  // uniform across the block
      for (int i = threadIdx.x; i < kCols; i += blockDim.x) out[n0 + i] = __float2bfloat16_rn(__int_as_float(0x7fc00000));
      return;
    }
    qw += static_cast<size_t>(e) * (K / 8) * Np;
    sc += static_cast<size_t>(e) * (K / g) * Np;
    zs += static_cast<size_t>(e) * (K / g) * Np;
    if (!x_shared) x += static_cast<size_t>(sel) * K;
    M = 1;
  }
  const int Kh = K / 2;
  const int T = K / 32;    // k-tiles of 4 word rows: 16 low-half + 16 high-half k
  const int tpg = g / 16;  // k-tiles per group
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
      xs_lo += sum_bf16x4(xl);
      xs_hi += sum_bf16x4(xh);
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

  // close the group of tile t (or the part of it this warp covers):
  // y += dot * s - xsum * zs for the low-half group and the high-half one
  auto flush = [&](int t) {
    xs_lo += __shfl_xor_sync(kFull, xs_lo, 1);
    xs_lo += __shfl_xor_sync(kFull, xs_lo, 2);
    xs_hi += __shfl_xor_sync(kFull, xs_hi, 1);
    xs_hi += __shfl_xor_sync(kFull, xs_hi, 2);
    // the C fragment holds rows 2c and 2c+1, whose sums sit in lanes 8c, 8c+4
    const float xl0 = __shfl_sync(kFull, xs_lo, 8 * c), xl1 = __shfl_sync(kFull, xs_lo, 8 * c + 4);
    const float xh0 = __shfl_sync(kFull, xs_hi, 8 * c), xh1 = __shfl_sync(kFull, xs_hi, 8 * c + 4);
    const int grp = t / tpg;
    const size_t col = static_cast<size_t>(n0 + kW * gq);
    const size_t lo = static_cast<size_t>(grp) * Np + col, hi = static_cast<size_t>(Gh + grp) * Np + col;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 sl = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sc + lo + 2 * nt));
      const float2 zl = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(zs + lo + 2 * nt));
      const float2 sh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sc + hi + 2 * nt));
      const float2 zh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(zs + hi + 2 * nt));
      // C registers: (column 2nt; rows 2c, 2c+1), (column 2nt+1; rows 2c, 2c+1)
      y[nt][0] = y[nt][0] + acc_lo[nt][0] * sl.x - xl0 * zl.x;
      y[nt][1] = y[nt][1] + acc_lo[nt][1] * sl.x - xl1 * zl.x;
      y[nt][2] = y[nt][2] + acc_lo[nt][2] * sl.y - xl0 * zl.y;
      y[nt][3] = y[nt][3] + acc_lo[nt][3] * sl.y - xl1 * zl.y;
      y[nt][0] = y[nt][0] + acc_hi[nt][0] * sh.x - xh0 * zh.x;
      y[nt][1] = y[nt][1] + acc_hi[nt][1] * sh.x - xh1 * zh.x;
      y[nt][2] = y[nt][2] + acc_hi[nt][2] * sh.y - xh0 * zh.y;
      y[nt][3] = y[nt][3] + acc_hi[nt][3] * sh.y - xh1 * zh.y;
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
        compute(w, xl, xh, t);
        if ((t + 1) % tpg == 0 || t + 1 == t1) flush(t);
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
      out[static_cast<size_t>(m0 + m) * Np + n0 + col] = __float2bfloat16_rn(s);
    }
  }
}

enum GemvMode { kPlain, kNorm, kGrouped };

template <int NT, int P>
void launch_gemv(GemvMode mode, dim3 grid, int warps, cudaStream_t st, const __nv_bfloat16* x,
                 const uint32_t* qw, const __nv_bfloat16* sc, const __nv_bfloat16* zs, const void* nw,
                 int nw_f32, float eps, int M, int K, int Np, int g, __nv_bfloat16* out,
                 const int* ids = nullptr, int n_experts = 0, int x_shared = 0) {
  const int th = warps * 32;
  if (mode == kNorm)
    w4_gemv_kernel<NT, P, true, false><<<grid, th, 0, st>>>(x, qw, sc, zs, nw, nw_f32, eps, M, K, Np, g, out,
                                                              ids, n_experts, x_shared);
  else if (mode == kGrouped)
    w4_gemv_kernel<NT, P, false, true><<<grid, th, 0, st>>>(x, qw, sc, zs, nw, nw_f32, eps, M, K, Np, g, out,
                                                              ids, n_experts, x_shared);
  else
    w4_gemv_kernel<NT, P, false, false><<<grid, th, 0, st>>>(x, qw, sc, zs, nw, nw_f32, eps, M, K, Np, g, out,
                                                               ids, n_experts, x_shared);
}

}  // namespace

// nt: 16-column MMA tiles per block (2 or 4); warps: the block's split of K
QLLM_API int qllm_w4_planar_gemv(const void* x, const void* qweight, const void* scales,
                                 const void* zs, const void* norm_w, void* out, int layer, int M,
                                 int K, int Np, int g, int nt, int warps, int nw_f32, float eps,
                                 void* stream) {
  if (M < 1 || M > 32 || g < 16 || g % 16 != 0 || (K / 2) % g != 0 || (nt != 2 && nt != 4) ||
      Np % (16 * nt) != 0 || warps < 1 || warps > kGemvMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = K / g;
  const size_t lw = static_cast<size_t>(K / 8) * Np;
  const size_t ls = static_cast<size_t>(G) * Np;
  const auto* qw = static_cast<const uint32_t*>(qweight) + layer * lw;
  const auto* sc = static_cast<const __nv_bfloat16*>(scales) + layer * ls;
  const auto* zz = static_cast<const __nv_bfloat16*>(zs) + layer * ls;
  const void* nw = nullptr;
  if (norm_w != nullptr) {
    nw = nw_f32 ? static_cast<const void*>(static_cast<const float*>(norm_w) + static_cast<size_t>(layer) * K)
                : static_cast<const void*>(static_cast<const __nv_bfloat16*>(norm_w) +
                                           static_cast<size_t>(layer) * K);
  }
  const dim3 grid(Np / (16 * nt), (M + 7) / 8);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  // P k-tiles in flight per warp: 32 words per thread either way
  const GemvMode mode = nw != nullptr ? kNorm : kPlain;
  if (nt == 2)
    launch_gemv<2, 8>(mode, grid, warps, st, xb, qw, sc, zz, nw, nw_f32, eps, M, K, Np, g, ob);
  else
    launch_gemv<4, 4>(mode, grid, warps, st, xb, qw, sc, zz, nw, nw_f32, eps, M, K, Np, g, ob);
  return qllm_launch_status();
}

// ---------------------------------------------------------------------------
// K8 w4_grouped_gemv (MoE decode).
//
// Replaces _qmm_kernel_planar_full as qmatmul_grouped_experts runs it
// (qllm_tpu/ops/pallas_qmm.py:1843, pallas_call :1914): for every
// (token, expert) selection i, y[i] = x[i or 0] @ dequant(W[ids[i]]) from
// an [E]-stacked (or [L*E]-stacked) expert weight, all selections in one
// launch, f32 sums rounded to bf16. The TPU kernel takes the ids by
// scalar prefetch into its weight index maps; here each block reads its
// selection's id itself, so the ids never leave the device.
//
// Bound on the H100: bytes, the selected experts' words read once. The
// block is K1's (the per-group tensor-core dot on whole planar words with
// the zero-point correction, w4_gemv_kernel with GROUPED set) with one
// x row: a grid of (column tiles, selections), one block per pair.
// Selections arrive sorted by id; taking a run of equal ids as K1's M
// rows would stream each touched expert once (later work): here an
// expert chosen by several selections is read once per selection.
// ---------------------------------------------------------------------------

QLLM_API int qllm_w4_grouped_gemv(const void* x, const void* qweight, const void* scales,
                                  const void* zs, const void* ids, void* out, int n, int n_experts,
                                  int x_shared, int K, int Np, int g, int nt, int warps, void* stream) {
  if (n < 1 || n > 65535 || n_experts < 1 || g < 16 || g % 16 != 0 || (K / 2) % g != 0 ||
      (nt != 2 && nt != 4) || Np % (16 * nt) != 0 || warps < 1 || warps > kGemvMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Np / (16 * nt), n);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qw = static_cast<const uint32_t*>(qweight);
  const auto* sc = static_cast<const __nv_bfloat16*>(scales);
  const auto* zz = static_cast<const __nv_bfloat16*>(zs);
  const auto* id = static_cast<const int*>(ids);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (nt == 2)
    launch_gemv<2, 8>(kGrouped, grid, warps, st, xb, qw, sc, zz, nullptr, 0, 0.f, 1, K, Np, g, ob, id, n_experts,
                      x_shared);
  else
    launch_gemv<4, 4>(kGrouped, grid, warps, st, xb, qw, sc, zz, nullptr, 0, 0.f, 1, K, Np, g, ob, id, n_experts,
                      x_shared);
  return qllm_launch_status();
}

// ---------------------------------------------------------------------------
// K2 w4_planar_gemm (prefill, M > 32).
//
// Replaces the big-dot branches of _qmm_kernel_planar_fused
// (pallas_qmm.py:751, :785-807; K blocked, K = 4096 at 7B) and of
// _qmm_kernel_planar_full (:832, :895-916; full K, down_proj K = 11008):
// both dequantize w = bf16(q * s - zs) and run a bf16 x bf16 product
// with f32 accumulation, so one kernel serves both. The RMSNorm of the
// qkv / gate|up inputs is applied before the call, as the JAX package
// does outside its blocked kernel.
//
// Bound on the H100: at M = 1024 the product is 2*M*K*N flops against
// K*N/2 weight bytes (~4000 flops/byte), far above the bf16 ridge
// (~295 flops/byte), so the tensor-core rate bounds it. Design: the MMA
// layout of K1 with many rows of x. mma.sync m16n8k16 takes 16 output
// columns of dequantized weights as A and 8 rows of x as B; a thread's A
// registers come from whole planar words (thread (gq, c) holds word row
// 4t + c of k-tile t for its columns), dequantized in registers to
// bf16(q * s - zs) once and reused for the warp's 8 row tiles, so no
// weight tile passes through shared memory. x tiles (128 rows x 16
// low-half + 16 high-half k) stream into a 3-stage shared-memory ring by
// cp.async; the next k-tiles' weight words wait in registers. A block is
// 8 warps over 128 columns x 128 rows; each warp owns 32 columns x 64
// rows (64 f32 accumulators a thread). wgmma / TMA are later work.
// ---------------------------------------------------------------------------

namespace {

constexpr int kGemmThreads = 256;
constexpr int kBM = 128, kBN = 128;  // rows of x, output columns per block
constexpr int kMT = 8;               // 8-row MMA tiles per warp (64 rows)
constexpr int kNT = 2;               // 16-column MMA tiles per warp (32 columns)
constexpr int kStages = 3;           // x tiles in flight (cp.async ring)
constexpr int kWPre = 4;             // k-tiles of weight words in registers
constexpr int kXRow = 48;            // bf16 per x-tile row: 32 used, 96 bytes
                                     // (no bank conflicts on 8-byte reads)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// 4-bit values 0..15 in the bytes of `bits` (each byte < 16) as exact
// floats: PRMT builds 0x4B0000vv = 2^23 + vv, one FADD removes 2^23
__device__ __forceinline__ float nibble_f32(uint32_t bits, int byte) {
  return __int_as_float(__byte_perm(bits, 0x4B000000u, 0x7440u + byte)) - 8388608.f;
}

// bf16(v * s - z) for the nibbles of bytes j and j + 2 of `nib` (each
// byte < 16) as one bf16 pair: the A registers of one MMA row
__device__ __forceinline__ uint32_t dequant_pair(uint32_t nib, int j, float s, float z) {
  return bf16x2_bits(__floats2bfloat162_rn(fmaf(nibble_f32(nib, j), s, -z), fmaf(nibble_f32(nib, j + 2), s, -z)));
}

__global__ void __launch_bounds__(kGemmThreads)
    w4_gemm_kernel(const __nv_bfloat16* __restrict__ x,   // [M, K]
                   const uint32_t* __restrict__ qw,       // [K/8, Np] this layer
                   const __nv_bfloat16* __restrict__ sc,  // [G, Np]
                   const __nv_bfloat16* __restrict__ zs,  // [G, Np]
                   __nv_bfloat16* __restrict__ out,       // [M, Np]
                   int M, int K, int Np, int g) {
  __shared__ __align__(16) __nv_bfloat16 xs[kStages][kBM][kXRow];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, c = lane & 3;
  const int wn = warp & 3, wm = warp >> 2;
  const int m0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN + wn * 32 + 4 * gq;  // this thread's 4 columns
  const int Kh = K / 2;
  const int T = K / 32;    // k-tiles: 16 low-half + 16 high-half k each
  const int tpg = g / 16;  // k-tiles per group
  const int Gh = Kh / g;

  // x tile t into stage s: row r holds x[m0 + r, 16t .. +16) then
  // x[m0 + r, Kh + 16t .. +16), two 16-byte copies per thread
  auto issue_x = [&](int t, int s) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * kGemmThreads;
      const int r = i >> 2, q = i & 3;
      const int k = (q < 2 ? 16 * t + 8 * q : Kh + 16 * t + 8 * (q - 2));
      const bool ok = m0 + r < M;
      cp_async16(&xs[s][r][8 * q], ok ? x + static_cast<size_t>(m0 + r) * K + k : x, ok);
    }
  };
  const uint32_t* wp = qw + static_cast<size_t>(c) * Np + col0;
  auto load_w = [&](int t) { return __ldg(reinterpret_cast<const uint4*>(wp + static_cast<size_t>(4 * t) * Np)); };

  float acc[kNT][kMT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][mt][e] = 0.f;

  // one k-tile: dequantize this thread's A registers for both halves of
  // K, then run them against the warp's 8 row tiles of x
  auto compute = [&](uint4 wv, int t) {
    const uint32_t w[4] = {wv.x, wv.y, wv.z, wv.w};
    const int grp = t / tpg;
    const uint2 s_lo = __ldg(reinterpret_cast<const uint2*>(sc + static_cast<size_t>(grp) * Np + col0));
    const uint2 z_lo = __ldg(reinterpret_cast<const uint2*>(zs + static_cast<size_t>(grp) * Np + col0));
    const uint2 s_hi = __ldg(reinterpret_cast<const uint2*>(sc + static_cast<size_t>(Gh + grp) * Np + col0));
    const uint2 z_hi = __ldg(reinterpret_cast<const uint2*>(zs + static_cast<size_t>(Gh + grp) * Np + col0));
    const float4 sl = bf16x4_to_float4(s_lo), zl = bf16x4_to_float4(z_lo);
    const float4 sh = bf16x4_to_float4(s_hi), zh = bf16x4_to_float4(z_hi);
    const float slv[4] = {sl.x, sl.y, sl.z, sl.w}, zlv[4] = {zl.x, zl.y, zl.z, zl.w};
    const float shv[4] = {sh.x, sh.y, sh.z, sh.w}, zhv[4] = {zh.x, zh.y, zh.z, zh.w};
    uint32_t alo[kNT][4], ahi[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      // A row gq is column col0 + 2nt (word a), row gq + 8 the next (word b)
      const int ca = 2 * nt, cb = 2 * nt + 1;
      const uint32_t la = w[ca] & 0x0F0F0F0Fu, lb = w[cb] & 0x0F0F0F0Fu;
      const uint32_t ha = (w[ca] >> 4) & 0x0F0F0F0Fu, hb = (w[cb] >> 4) & 0x0F0F0F0Fu;
      alo[nt][0] = dequant_pair(la, 0, slv[ca], zlv[ca]);
      alo[nt][1] = dequant_pair(lb, 0, slv[cb], zlv[cb]);
      alo[nt][2] = dequant_pair(la, 1, slv[ca], zlv[ca]);
      alo[nt][3] = dequant_pair(lb, 1, slv[cb], zlv[cb]);
      ahi[nt][0] = dequant_pair(ha, 0, shv[ca], zhv[ca]);
      ahi[nt][1] = dequant_pair(hb, 0, shv[cb], zhv[cb]);
      ahi[nt][2] = dequant_pair(ha, 1, shv[ca], zhv[ca]);
      ahi[nt][3] = dequant_pair(hb, 1, shv[cb], zhv[cb]);
    }
    const __nv_bfloat16(*xt)[kXRow] = xs[t % kStages];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int r = wm * 64 + mt * 8 + gq;
      uint32_t bl0, bl1, bh0, bh1;
      x_fragments(*reinterpret_cast<const uint2*>(&xt[r][4 * c]), bl0, bl1);
      x_fragments(*reinterpret_cast<const uint2*>(&xt[r][16 + 4 * c]), bh0, bh1);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        mma_bf16_16816(acc[nt][mt], alo[nt][0], alo[nt][1], alo[nt][2], alo[nt][3], bl0, bl1);
        mma_bf16_16816(acc[nt][mt], ahi[nt][0], ahi[nt][1], ahi[nt][2], ahi[nt][3], bh0, bh1);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < T) issue_x(s, s);
    cp_async_commit();
  }
  uint4 wbuf[kWPre];
#pragma unroll
  for (int i = 0; i < kWPre; ++i)
    if (i < T) wbuf[i] = load_w(i);
  for (int tb = 0; tb < T; tb += kWPre) {
#pragma unroll
    for (int i = 0; i < kWPre; ++i) {
      const int t = tb + i;
      if (t < T) {  // uniform across the block
        const uint4 wv = wbuf[i];
        if (t + kWPre < T) wbuf[i] = load_w(t + kWPre);
        cp_async_wait<kStages - 2>();  // this thread's copies of tile t landed
        __syncthreads();               // everyone's did; stage (t-1) % kStages is free
        if (t + kStages - 1 < T) issue_x(t + kStages - 1, (t + kStages - 1) % kStages);
        cp_async_commit();
        compute(wv, t);
      }
    }
  }

  // C registers: (column col0 + 2nt; rows 2c, 2c+1), (the next column;
  // rows 2c, 2c+1) of each row tile: one bf16 pair per row
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int m = m0 + wm * 64 + mt * 8 + 2 * c;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = col0 + 2 * nt;
      if (m < M)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(m) * Np + col) =
            __floats2bfloat162_rn(acc[nt][mt][0], acc[nt][mt][2]);
      if (m + 1 < M)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(m + 1) * Np + col) =
            __floats2bfloat162_rn(acc[nt][mt][1], acc[nt][mt][3]);
    }
  }
}

}  // namespace

QLLM_API int qllm_w4_planar_gemm(const void* x, const void* qweight, const void* scales,
                                 const void* zs, void* out, int layer, int M, int K, int Np,
                                 int g, void* stream) {
  if (M < 1 || K % 64 != 0 || g % 32 != 0 || (K / 2) % g != 0 || Np % kBN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = K / g;
  const size_t lw = static_cast<size_t>(K / 8) * Np;
  const size_t ls = static_cast<size_t>(G) * Np;
  const dim3 grid(Np / kBN, (M + kBM - 1) / kBM);
  w4_gemm_kernel<<<grid, kGemmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(qweight) + layer * lw,
      static_cast<const __nv_bfloat16*>(scales) + layer * ls,
      static_cast<const __nv_bfloat16*>(zs) + layer * ls, static_cast<__nv_bfloat16*>(out), M, K,
      Np, g);
  return qllm_launch_status();
}
