// K17 w4_planar_f32s_gemv and K18 w4_planar_f32s_gemm: the planar W4
// g-grouped matmul with f32 scales and no zero-point term,
//   out[m, n] = sum_g (x_g . q_g[:, n]) * s_g[n]      (f32 [M, Np])
// on [L]-stacked serving weights (qweight [L, K/8, Np] planar words,
// scales [L, G, Np] f32), x bf16 [M, K], q the nibble value 0..15. The
// caller takes off the zero-point term, out - (sum x_g) @ zs, in f32.
//
// Both replace _qmm_kernel_planar (qllm_tpu/ops/pallas_qmm.py:999, driven
// by _qmm_2d_stacked :1357): the blocked planar kernel the JAX package
// runs on its chip for planar stacks whose correction is not fused (f32
// scales, or zeros not prefolded), at every M (decode and prefill).
//
// Rounding as in the TPU kernel: nibbles and bf16 x are exact in bf16,
// so each group's dot runs on the tensor cores (mma.sync m16n8k16 bf16
// -> f32) into an f32 fragment of its own; at the group's end that
// partial is multiplied by the f32 scale and added into the accumulator.
// The weight is never rounded to bf16 and the scale never enters the
// product (K2's dequantize-then-one-big-dot is #2's rounding, not #3's).
//
// Planar contract (qllm_tpu/quant/qtensor.py:157-161): word r, byte j
// holds k = 4r+j in its low nibble and k = K/2+4r+j in its high nibble.
// A k-tile t is 4 word rows: the low nibbles are k = 16t..16t+15 of the
// low half of K, the high nibbles the same k of the high half.
//
// K17 is the planar GEMV block of csrc/planar_gemv.cuh (K1's) with f32
// scales: no norm, no zero-point term, f32 out. The block's warps split
// the k-tiles, each closes a group (or its part of one) with the f32
// scales, and the warps' sums meet in shared memory in warp order; the
// caller picks the warp count from K and Np alone, so repeated runs give
// identical bits and a row's bits never depend on M. Bound on the H100:
// bytes (the layer's words and f32 scales read once).

#include "planar_gemv.cuh"

namespace {

// ---------------------------------------------------------------------------
// K18 w4_planar_f32s_gemm (prefill, M > 32).
//
// K2's tiling (csrc/qmm.cu) with #3's rounding. A block is 8 warps over
// 128 output columns x 128 rows of x; each warp owns 32 columns x 64 rows.
// The low-half and high-half groups of a k-tile have scales of their own,
// so the block walks K twice: first every k-tile's low-half nibbles
// against the low half of x, then the high-half nibbles against the high
// half. Within a pass one f32 partial fragment a (column tile, row tile)
// holds the open group's dot and is closed into the accumulator with the
// f32 scales at the group's end (any g % 16 == 0; the TPU grid's k-block,
// 2048 or the relaxed 256 of down_proj, sets only its order of adding the
// group terms). A thread's A registers come from whole planar words
// (thread (gq, c) holds word row 4t + c of k-tile t for its 4 columns) as
// exact bf16 nibbles, reused for the warp's 8 row tiles; x (128 rows x 32 k
// of the pass's half: two k-tiles a step, one barrier per 32 MMAs a warp)
// streams into a 3-stage shared-memory ring by cp.async and the next
// steps' words wait in registers. Each pass reads
// the words once (from L2 after the first: a column tile's words are 256 KB
// at K = 4096). Row blocks run along gridDim.x, so the blocks that share a
// column tile's words are resident together. wgmma / TMA are later work.
//
// Bound on the H100: at M = 1024, 2*M*K*N flops against K*N/2 weight
// bytes: the bf16 tensor-core rate.
// ---------------------------------------------------------------------------

constexpr int kGemmThreads = 256;
constexpr int kBM = 128, kBN = 128;  // rows of x, output columns per block
constexpr int kMT = 8;               // 8-row MMA tiles per warp (64 rows)
constexpr int kNT = 2;               // 16-column MMA tiles per warp (32 columns)
constexpr int kStages = 3;           // steps of x in flight (cp.async ring)
constexpr int kWPre = 2;             // steps of weight words in registers
constexpr int kXRow = 48;            // bf16 per x row of a stage: 32 used, 96
                                     // bytes (no bank conflicts on 8-byte reads)

__global__ void __launch_bounds__(kGemmThreads)
    f32s_gemm_kernel(const __nv_bfloat16* __restrict__ x,  // [M, K]
                     const uint32_t* __restrict__ qw,      // [K/8, Np] this layer
                     const float* __restrict__ sc,         // [G, Np] this layer
                     float* __restrict__ out,              // [M, Np]
                     int M, int K, int Np, int g) {
  __shared__ __align__(16) __nv_bfloat16 xs[kStages][kBM][kXRow];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, c = lane & 3;
  const int wn = warp & 3, wm = warp >> 2;
  const int m0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN + wn * 32 + 4 * gq;  // this thread's 4 columns
  const int Kh = K / 2;
  const int T = K / 32;    // k-tiles: 16 low-half + 16 high-half k each
  const int tpg = g / 16;  // k-tiles per group
  const int Gh = Kh / g;
  const uint32_t* wp = qw + static_cast<size_t>(c) * Np + col0;
  auto load_w = [&](int t) { return __ldg(reinterpret_cast<const uint4*>(wp + static_cast<size_t>(4 * t) * Np)); };

  float acc[kNT][kMT][4], part[kNT][kMT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][mt][e] = part[nt][mt][e] = 0.f;

  const int U = T / 2;  // steps of two k-tiles (K % 64 == 0)
  for (int half = 0; half < 2; ++half) {
    const int kx = half * Kh;  // x columns of this pass
    const int sh = 4 * half;   // nibble shift of this pass
    // step u's x into stage s: row r holds x[m0 + r, kx + 32u .. +32), two
    // 16-byte copies per thread
    auto issue_x = [&](int u, int s) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = tid + j * kGemmThreads;
        const int r = i >> 2, q = i & 3;
        const bool ok = m0 + r < M;
        cp_async16(&xs[s][r][8 * q], ok ? x + static_cast<size_t>(m0 + r) * K + kx + 32 * u + 8 * q : x, ok);
      }
    };
    // k-tile t (the j-th of its step, in stage s): this thread's A
    // registers for the pass's half, run against the warp's 8 row tiles of
    // x into the group partials
    auto compute = [&](uint4 wv, int s, int j) {
      const uint32_t w[4] = {wv.x, wv.y, wv.z, wv.w};
      uint32_t a[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        // A row gq is column col0 + 2nt (word 2nt), A row gq + 8 the next
        a[nt][0] = nibbles_bf16x2(w[2 * nt], sh);
        a[nt][1] = nibbles_bf16x2(w[2 * nt + 1], sh);
        a[nt][2] = nibbles_bf16x2(w[2 * nt], sh + 8);
        a[nt][3] = nibbles_bf16x2(w[2 * nt + 1], sh + 8);
      }
      const __nv_bfloat16(*xt)[kXRow] = xs[s];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        uint32_t b0, b1;
        x_fragments(*reinterpret_cast<const uint2*>(&xt[wm * 64 + mt * 8 + gq][16 * j + 4 * c]), b0, b1);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_bf16_16816(part[nt][mt], a[nt][0], a[nt][1], a[nt][2], a[nt][3], b0, b1);
      }
    };
    // close the group of tile t: acc += partial * s in f32
    auto close_group = [&](int t) {
      const int grp = half * Gh + t / tpg;
      const float4 s4 = __ldg(reinterpret_cast<const float4*>(sc + static_cast<size_t>(grp) * Np + col0));
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          // C registers: (column col0 + 2nt; rows 2c, 2c+1), (the next column; rows 2c, 2c+1)
          acc[nt][mt][0] = fmaf(part[nt][mt][0], sv[2 * nt], acc[nt][mt][0]);
          acc[nt][mt][1] = fmaf(part[nt][mt][1], sv[2 * nt], acc[nt][mt][1]);
          acc[nt][mt][2] = fmaf(part[nt][mt][2], sv[2 * nt + 1], acc[nt][mt][2]);
          acc[nt][mt][3] = fmaf(part[nt][mt][3], sv[2 * nt + 1], acc[nt][mt][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) part[nt][mt][e] = 0.f;
        }
    };

    __syncthreads();  // the previous pass's last x is read
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < U) issue_x(s, s);
      cp_async_commit();
    }
    uint4 wbuf[kWPre][2];
#pragma unroll
    for (int i = 0; i < kWPre; ++i)
      if (i < U) {
        wbuf[i][0] = load_w(2 * i);
        wbuf[i][1] = load_w(2 * i + 1);
      }
    for (int ub = 0; ub < U; ub += kWPre) {
#pragma unroll
      for (int i = 0; i < kWPre; ++i) {
        const int u = ub + i;
        if (u < U) {  // uniform across the block
          const uint4 w0 = wbuf[i][0], w1 = wbuf[i][1];
          if (u + kWPre < U) {
            wbuf[i][0] = load_w(2 * (u + kWPre));
            wbuf[i][1] = load_w(2 * (u + kWPre) + 1);
          }
          cp_async_wait<kStages - 2>();  // this thread's copies of step u landed
          __syncthreads();           // everyone's did; stage (u-1) % kStages is free
          if (u + kStages - 1 < U) issue_x(u + kStages - 1, (u + kStages - 1) % kStages);
          cp_async_commit();
          const int s = u % kStages;
          compute(w0, s, 0);
          if ((2 * u + 1) % tpg == 0) close_group(2 * u);
          compute(w1, s, 1);
          if ((2 * u + 2) % tpg == 0) close_group(2 * u + 1);
        }
      }
    }
    cp_async_wait<0>();
  }

  // C registers: (column col0 + 2nt; rows 2c, 2c+1), (the next column;
  // rows 2c, 2c+1) of each row tile: one f32 pair per row
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int m = m0 + wm * 64 + mt * 8 + 2 * c;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = col0 + 2 * nt;
      if (m < M)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(m) * Np + col) =
            make_float2(acc[nt][mt][0], acc[nt][mt][2]);
      if (m + 1 < M)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(m + 1) * Np + col) =
            make_float2(acc[nt][mt][1], acc[nt][mt][3]);
    }
  }
}

bool geometry_ok(int K, int g) { return K % 64 == 0 && g >= 16 && g % 16 == 0 && (K / 2) % g == 0; }

}  // namespace

// nt: 16-column MMA tiles per block (2 or 4); warps: the block's split of K
QLLM_API int qllm_w4_planar_f32s_gemv(const void* x, const void* qweight, const void* scales, void* out,
                                      int layer, int M, int K, int Np, int g, int nt, int warps, void* stream) {
  if (M < 1 || M > 32 || !geometry_ok(K, g) || (nt != 2 && nt != 4) || Np % (16 * nt) != 0 || warps < 1 ||
      warps > kGemvMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t lw = static_cast<size_t>(K / 8) * Np;
  const size_t ls = static_cast<size_t>(K / g) * Np;
  const auto* qw = static_cast<const uint32_t*>(qweight) + layer * lw;
  const auto* sc = static_cast<const float*>(scales) + layer * ls;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* o = static_cast<float*>(out);
  const dim3 grid(Np / (16 * nt), (M + 7) / 8);
  const auto st = static_cast<cudaStream_t>(stream);
  // P k-tiles in flight per warp: 32 words per thread either way
  if (nt == 2)
    w4_gemv_kernel<2, 8, false, false, float>
        <<<grid, warps * 32, 0, st>>>(xb, qw, sc, nullptr, nullptr, 0, 0.f, M, K, Np, g, o, nullptr, 0, 0);
  else
    w4_gemv_kernel<4, 4, false, false, float>
        <<<grid, warps * 32, 0, st>>>(xb, qw, sc, nullptr, nullptr, 0, 0.f, M, K, Np, g, o, nullptr, 0, 0);
  return qllm_launch_status();
}

QLLM_API int qllm_w4_planar_f32s_gemm(const void* x, const void* qweight, const void* scales, void* out,
                                      int layer, int M, int K, int Np, int g, void* stream) {
  if (M < 1 || !geometry_ok(K, g) || Np % kBN != 0 || Np / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t lw = static_cast<size_t>(K / 8) * Np;
  const size_t ls = static_cast<size_t>(K / g) * Np;
  const dim3 grid((M + kBM - 1) / kBM, Np / kBN);
  f32s_gemm_kernel<<<grid, kGemmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(qweight) + layer * lw,
      static_cast<const float*>(scales) + layer * ls, static_cast<float*>(out), M, K, Np, g);
  return qllm_launch_status();
}
