// K9 gptq_gemv and K10 gptq_gemm: the per-layer quantized matmul
// y = x @ dequant(W) on GPTQ-order packed words (the counterpart of
// _qmm_2d, qllm_tpu/ops/pallas_qmm.py:300). Word row r of qweight
// [K/pf, N] (pf = 32 / bits, bits in {2, 4, 8}) holds k = r * pf + s at
// bit offset bits * s; scales and zeros [G, N] are read in the dtype they
// are stored in (0 = f32, 1 = fp16, 2 = bf16) and converted in registers.
// Both kernels leave the output in bf16 [M, N].
//
// Neither kernel splits its sums with atomics: a row's result depends
// only on that row of x and the weights, never on M or on the run.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// K9 gptq_gemv (decode, M <= 32).
//
// Replaces _qmm_kernel_v3 (pallas_qmm.py:177) and the f32-dot branch of
// _qmm_kernel (:119) as _qmm_2d runs them at M <= 32: x in f32,
//   y[m, n] = sum_g s_g[n] * sum_{k in g} x[m, k] * (q[k, n] - z_g[n])
// in f32, rounded to bf16. The TPU kernel subtracts the zero-point term
// xsum_g @ (z * s) outside the kernel; here it is folded into the dot as
// q - z (the same function, another f32 rounding).
//
// Bound on the H100: bytes (the packed words, read once). Design: one
// thread per output column, so a warp reads one 128-byte run of a word
// row (coalesced), loads 8 word rows ahead of its arithmetic, and keeps
// MT rows of f32 sums in registers (MT = the smallest of 1, 4, 8, 16, 32
// that holds M; each row's sums run the same way at any MT); x tiles of
// 256 k live in shared memory as f32 and every lane reads the same x
// value (a broadcast). At decode shapes one block per 128 columns gives
// 32 blocks at N = 4096, so K is split over gridDim.y (a count chosen
// from K and N alone); each split writes its f32 partial sums, and a
// second kernel adds them in split order.
// ---------------------------------------------------------------------------

constexpr int kGemvThreads = 128;
constexpr int kGemvKT = 256;  // k per x tile in shared memory
constexpr int kGemvPre = 8;   // word rows a thread loads ahead

template <int BITS, int MT>
__global__ void __launch_bounds__(kGemvThreads)
    gptq_gemv_kernel(const void* __restrict__ x, int x_f32,  // [M, K]
                     const uint32_t* __restrict__ qw,        // [K/pf, N]
                     const void* __restrict__ sc, const void* __restrict__ zr, int s_type,  // [G, N]
                     int M, int K, int N, int g, int rows_per_split,
                     float* __restrict__ part,               // [splits, M, N] when split
                     __nv_bfloat16* __restrict__ out) {      // [M, N] when not
  constexpr int PF = 32 / BITS;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  __shared__ float xs[MT][kGemvKT];

  const int tid = threadIdx.x;
  const int n = blockIdx.x * kGemvThreads + tid;
  const bool col = n < N;
  const int rows = K / PF;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(rows, r0 + rows_per_split);

  float y[MT], dot[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) y[m] = dot[m] = 0.f;
  float s = 0.f, z = 0.f;

  for (int k0 = r0 * PF; k0 < r1 * PF; k0 += kGemvKT) {
    const int kn = min(kGemvKT, r1 * PF - k0);
    __syncthreads();
    for (int i = tid; i < MT * kGemvKT; i += kGemvThreads) {
      const int m = i / kGemvKT, kk = i % kGemvKT;
      xs[m][kk] = (m < M && kk < kn) ? load_x(x, x_f32, static_cast<size_t>(m) * K + k0 + kk) : 0.f;
    }
    __syncthreads();
    if (col) {
      const int ra = k0 / PF, rb = (k0 + kn) / PF;
      for (int rc = ra; rc < rb; rc += kGemvPre) {
        // kGemvPre words in flight before any is used
        uint32_t wb[kGemvPre];
#pragma unroll
        for (int i = 0; i < kGemvPre; ++i)
          wb[i] = rc + i < rb ? __ldcs(qw + static_cast<size_t>(rc + i) * N + n) : 0u;
#pragma unroll
        for (int i = 0; i < kGemvPre; ++i) {
          const int r = rc + i;
          if (r >= rb) break;
          if ((r * PF) % g == 0 || r == r0) {  // a group starts: close the last one
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              y[m] = fmaf(dot[m], s, y[m]);
              dot[m] = 0.f;
            }
            const size_t gi = static_cast<size_t>((r * PF) / g) * N + n;
            s = load_param(sc, s_type, gi);
            z = load_param(zr, s_type, gi);
          }
          const float* xr = &xs[0][(r - ra) * PF];
#pragma unroll
          for (int f = 0; f < PF; ++f) {
            const float q = static_cast<float>((wb[i] >> (BITS * f)) & kMask) - z;
#pragma unroll
            for (int m = 0; m < MT; ++m) dot[m] = fmaf(xr[m * kGemvKT + f], q, dot[m]);
          }
        }
      }
    }
  }
  if (!col) return;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    y[m] = fmaf(dot[m], s, y[m]);
    if (m < M) {
      if (part != nullptr)
        part[(static_cast<size_t>(blockIdx.y) * M + m) * N + n] = y[m];
      else
        out[static_cast<size_t>(m) * N + n] = __float2bfloat16_rn(y[m]);
    }
  }
}

template <int BITS, int MT>
void launch_gemv_mt(dim3 grid, cudaStream_t st, const void* x, int x_f32, const uint32_t* qw, const void* sc,
                    const void* zr, int s_type, int M, int K, int N, int g, int rps, float* part,
                    __nv_bfloat16* out) {
  gptq_gemv_kernel<BITS, MT><<<grid, kGemvThreads, 0, st>>>(x, x_f32, qw, sc, zr, s_type, M, K, N, g, rps, part,
                                                            out);
}

template <int BITS>
void launch_gemv_bits(dim3 grid, cudaStream_t st, const void* x, int x_f32, const uint32_t* qw, const void* sc,
                      const void* zr, int s_type, int M, int K, int N, int g, int rps, float* part,
                      __nv_bfloat16* out) {
  if (M <= 1)
    launch_gemv_mt<BITS, 1>(grid, st, x, x_f32, qw, sc, zr, s_type, M, K, N, g, rps, part, out);
  else if (M <= 4)
    launch_gemv_mt<BITS, 4>(grid, st, x, x_f32, qw, sc, zr, s_type, M, K, N, g, rps, part, out);
  else if (M <= 8)
    launch_gemv_mt<BITS, 8>(grid, st, x, x_f32, qw, sc, zr, s_type, M, K, N, g, rps, part, out);
  else if (M <= 16)
    launch_gemv_mt<BITS, 16>(grid, st, x, x_f32, qw, sc, zr, s_type, M, K, N, g, rps, part, out);
  else
    launch_gemv_mt<BITS, 32>(grid, st, x, x_f32, qw, sc, zr, s_type, M, K, N, g, rps, part, out);
}

}  // namespace

// splits: the blocks along K (1 = no partial sums; else `part` holds
// splits * M * N floats); rows_per_split: word rows each split covers
QLLM_API int qllm_gptq_gemv(const void* x, int x_f32, const void* qweight, const void* scales,
                            const void* zeros, int s_type, void* part, void* out, int bits, int M,
                            int K, int N, int g, int splits, int rows_per_split, void* stream) {
  const int pf = bits > 0 ? 32 / bits : 0;
  if ((bits != 2 && bits != 4 && bits != 8) || M < 1 || M > 32 || N < 1 || K % pf != 0 || g < pf ||
      g % pf != 0 || K % g != 0 || splits < 1 || splits > 65535 || rows_per_split < 1 ||
      static_cast<long long>(splits) * rows_per_split < K / pf || (splits > 1 && part == nullptr) ||
      s_type < 0 || s_type > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kGemvThreads - 1) / kGemvThreads, splits);
  const auto* qw = static_cast<const uint32_t*>(qweight);
  float* p = splits > 1 ? static_cast<float*>(part) : nullptr;
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (bits == 2)
    launch_gemv_bits<2>(grid, st, x, x_f32, qw, scales, zeros, s_type, M, K, N, g, rows_per_split, p, o);
  else if (bits == 4)
    launch_gemv_bits<4>(grid, st, x, x_f32, qw, scales, zeros, s_type, M, K, N, g, rows_per_split, p, o);
  else
    launch_gemv_bits<8>(grid, st, x, x_f32, qw, scales, zeros, s_type, M, K, N, g, rows_per_split, p, o);
  if (splits > 1) {
    const int MN = M * N;
    split_sum_out_kernel<<<(MN + 255) / 256, 256, 0, st>>>(p, splits, MN, 1, o);
  }
  return qllm_launch_status();
}

// ---------------------------------------------------------------------------
// K10 gptq_gemm (prefill and speculative verify, M > 32).
//
// Replaces _qmm_kernel (pallas_qmm.py:119) as _qmm_2d runs it at M > 32:
// x in bf16, w = bf16(q * s) (the zero point NOT subtracted), a bf16 x
// bf16 product with f32 accumulation, then y = bf16(y1 - xsum_g @ (z*s))
// with xsum_g the f32 sums of x over each group (:469-473). The kernel
// rounds where the TPU kernel does: the zero-point mass (~8x the final
// magnitude) stays in the f32 accumulators and is taken off at the end.
//
// Bound on the H100: at M = 256 and beyond the product (2*M*K*N flops)
// is far above the bf16 ridge (~295 flops per weight byte), so the
// tensor-core rate bounds it. Design (K2's layout, csrc/qmm.cu):
// mma.sync m16n8k16 with 16 output columns of dequantized weights as A
// and 8 rows of x as B. In GPTQ order one word holds pf consecutive k of
// one column, so thread (gq, c) takes word row 4t + c of word tile t for
// its 4 columns (one 16-byte load) and feeds its k in fours: the MMA's k
// order is free as long as A and B agree, so the four k of A positions
// (2c, 2c+1, 2c+8, 2c+9) are k0..k3 of the word, and B reads
// x[row, k0..k3] with one 8-byte load. Per 64-k x tile (double-buffered
// by cp.async) that is 16 / pf word tiles of pf / 4 MMAs each. A block is
// 8 warps over 128 columns x 128 rows. The group sums of x come from a
// first small kernel (one warp per (row, group), fixed order).
// ---------------------------------------------------------------------------

namespace {

constexpr int kGemmThreads = 256;
constexpr int kBM = 128, kBN = 128;
constexpr int kMT = 8;      // 8-row MMA tiles per warp (64 rows)
constexpr int kNT = 2;      // 16-column MMA tiles per warp (32 columns)
constexpr int kKT = 64;     // k per x tile
constexpr int kXRow = 72;   // bf16 per x-tile row: 64 used, 144 bytes
constexpr int kStages = 2;

// xsum[m, gi] = sum of x[m, k] over group gi in f32: one warp per entry
__global__ void group_sum_kernel(const void* __restrict__ x, int x_f32, int M, int K, int g,
                                 float* __restrict__ xsum) {
  const int G = K / g;
  const long long e = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (e >= static_cast<long long>(M) * G) return;
  const int m = static_cast<int>(e / G), gi = static_cast<int>(e % G);
  const size_t base = static_cast<size_t>(m) * K + static_cast<size_t>(gi) * g;
  float acc = 0.f;
  for (int k = lane; k < g; k += 32) acc += load_x(x, x_f32, base + k);
  acc = warp_sum(acc);
  if (lane == 0) xsum[e] = acc;
}

template <int BITS>
__global__ void __launch_bounds__(kGemmThreads)
    gptq_gemm_kernel(const __nv_bfloat16* __restrict__ x,  // [M, K] bf16
                     const uint32_t* __restrict__ qw,      // [K/pf, N]
                     const void* __restrict__ sc, const void* __restrict__ zr, int s_type,  // [G, N]
                     const float* __restrict__ xsum,       // [M, G]
                     __nv_bfloat16* __restrict__ out,      // [M, N]
                     int M, int K, int N, int g) {
  constexpr int PF = 32 / BITS;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  constexpr int kWT = kKT / (4 * PF);  // word tiles per x tile
  constexpr int kMMA = PF / 4;         // MMAs per word (four k each)
  __shared__ __align__(16) __nv_bfloat16 xs[kStages][kBM][kXRow];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, c = lane & 3;
  const int wn = warp & 3, wm = warp >> 2;
  const int m0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN + wn * 32 + 4 * gq;  // this thread's 4 columns
  const bool cols_ok = col0 < N;                           // N % 4 == 0: all four or none
  const int T = K / kKT;

  // x tile t into stage s: 128 rows x 64 k, four 16-byte copies a thread
  auto issue_x = [&](int t, int s) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = tid + j * kGemmThreads;
      const int r = i >> 3, q = i & 7;
      const bool ok = m0 + r < M;
      cp_async16(&xs[s][r][8 * q], ok ? x + static_cast<size_t>(m0 + r) * K + kKT * t + 8 * q : x, ok);
    }
  };

  float acc[kNT][kMT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][mt][e] = 0.f;

  issue_x(0, 0);
  cp_async_commit();
  for (int t = 0; t < T; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t landed for everyone; the other stage is free
    if (t + 1 < T) issue_x(t + 1, (t + 1) & 1);
    cp_async_commit();
    const __nv_bfloat16(*xt)[kXRow] = xs[t & 1];
#pragma unroll
    for (int wt = 0; wt < kWT; ++wt) {
      const int wrow = (t * kWT + wt) * 4 + c;  // this thread's word row
      const int kw = wrow * PF;                 // its first k
      uint4 wv = make_uint4(0u, 0u, 0u, 0u);
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
      if (cols_ok) {
        wv = __ldg(reinterpret_cast<const uint4*>(qw + static_cast<size_t>(wrow) * N + col0));
        const size_t gi = static_cast<size_t>(kw / g) * N + col0;
#pragma unroll
        for (int j = 0; j < 4; ++j) s4[j] = load_param(sc, s_type, gi + j);
      }
      const uint32_t w[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int j = 0; j < kMMA; ++j) {
        // A registers: bf16(q * s) of fields 4j..4j+3 for columns 2nt, 2nt+1
        uint32_t a[kNT][4];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // h = 0: column 2nt (A row gq), 1: 2nt+1 (row gq+8)
            const int cc = 2 * nt + h;
            const uint32_t wc = w[cc];
            const float v0 = static_cast<float>((wc >> (BITS * (4 * j + 0))) & kMask) * s4[cc];
            const float v1 = static_cast<float>((wc >> (BITS * (4 * j + 1))) & kMask) * s4[cc];
            const float v2 = static_cast<float>((wc >> (BITS * (4 * j + 2))) & kMask) * s4[cc];
            const float v3 = static_cast<float>((wc >> (BITS * (4 * j + 3))) & kMask) * s4[cc];
            a[nt][h] = bf16x2_bits(__floats2bfloat162_rn(v0, v1));
            a[nt][2 + h] = bf16x2_bits(__floats2bfloat162_rn(v2, v3));
          }
        }
        const int kx = kw + 4 * j - kKT * t;  // the four k within the x tile
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const int r = wm * 64 + mt * 8 + gq;
          const uint2 xv = *reinterpret_cast<const uint2*>(&xt[r][kx]);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
            mma_bf16_16816(acc[nt][mt], a[nt][0], a[nt][1], a[nt][2], a[nt][3], xv.x, xv.y);
        }
      }
    }
  }
  if (!cols_ok) return;

  // y = y1 - sum_g xsum[m, g] * (z * s)[g, n], then bf16. C registers:
  // (column col0 + 2nt; rows 2c, 2c+1) and (the next column; rows 2c, 2c+1)
  const int G = K / g;
  for (int gi = 0; gi < G; ++gi) {
    float zs[4];
    const size_t pi = static_cast<size_t>(gi) * N + col0;
#pragma unroll
    for (int j = 0; j < 4; ++j) zs[j] = load_param(zr, s_type, pi + j) * load_param(sc, s_type, pi + j);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int m = m0 + wm * 64 + mt * 8 + 2 * c;
      const float xa = m < M ? __ldg(xsum + static_cast<size_t>(m) * G + gi) : 0.f;
      const float xb = m + 1 < M ? __ldg(xsum + static_cast<size_t>(m + 1) * G + gi) : 0.f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        acc[nt][mt][0] = fmaf(-xa, zs[2 * nt], acc[nt][mt][0]);
        acc[nt][mt][1] = fmaf(-xb, zs[2 * nt], acc[nt][mt][1]);
        acc[nt][mt][2] = fmaf(-xa, zs[2 * nt + 1], acc[nt][mt][2]);
        acc[nt][mt][3] = fmaf(-xb, zs[2 * nt + 1], acc[nt][mt][3]);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int m = m0 + wm * 64 + mt * 8 + 2 * c;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = col0 + 2 * nt;
      if (m < M)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(m) * N + col) =
            __floats2bfloat162_rn(acc[nt][mt][0], acc[nt][mt][2]);
      if (m + 1 < M)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(m + 1) * N + col) =
            __floats2bfloat162_rn(acc[nt][mt][1], acc[nt][mt][3]);
    }
  }
}

}  // namespace

// x_mma: x in bf16 (the MMA operand); x / x_f32: x as the caller holds it
// (the group sums read it unrounded); xsum: scratch of M * (K / g) floats
QLLM_API int qllm_gptq_gemm(const void* x_mma, const void* x, int x_f32, const void* qweight,
                            const void* scales, const void* zeros, int s_type, void* xsum, void* out,
                            int bits, int M, int K, int N, int g, void* stream) {
  if ((bits != 2 && bits != 4 && bits != 8) || M < 1 || M > 65535 * kBM || K % kKT != 0 || g < 32 ||
      g % 32 != 0 || K % g != 0 || N < 4 || N % 4 != 0 || s_type < 0 || s_type > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const long long entries = static_cast<long long>(M) * (K / g);
  group_sum_kernel<<<static_cast<unsigned>((entries + 7) / 8), 256, 0, st>>>(x, x_f32, M, K, g,
                                                                            static_cast<float*>(xsum));
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const auto* xb = static_cast<const __nv_bfloat16*>(x_mma);
  const auto* qw = static_cast<const uint32_t*>(qweight);
  const auto* xs = static_cast<const float*>(xsum);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (bits == 2)
    gptq_gemm_kernel<2><<<grid, kGemmThreads, 0, st>>>(xb, qw, scales, zeros, s_type, xs, o, M, K, N, g);
  else if (bits == 4)
    gptq_gemm_kernel<4><<<grid, kGemmThreads, 0, st>>>(xb, qw, scales, zeros, s_type, xs, o, M, K, N, g);
  else
    gptq_gemm_kernel<8><<<grid, kGemmThreads, 0, st>>>(xb, qw, scales, zeros, s_type, xs, o, M, K, N, g);
  return qllm_launch_status();
}
