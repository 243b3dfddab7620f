// K14 gptq_stacked_gemv and K15 gptq_stacked_w4a8_gemv: decode matmuls
// (M <= 32) on [L]-stacked GPTQ-order 2- and 4-bit serving weights, the
// counterpart of the packed branch of _qmm_2d_stacked
// (qllm_tpu/ops/pallas_qmm.py:1530). Word row r of a layer's words
// [K/pf, Np] (pf = 32 / bits) holds k = r * pf + f at bit offset bits * f;
// scales and zs = zeros * scales [G, Np] are read in the dtype they are
// stored in (0 = f32, 1 = fp16, 2 = bf16). The layer is taken from the
// stack by pointer arithmetic: nothing copies it out.
//
// Bound on the H100: bytes (each layer's words, scales and zs, read once).
// K14 runs its group dots on the tensor cores (csrc/stacked_mma.cuh, the
// body it shares with K16). K15, as K9 (gptq_mm.cu:47): one thread per
// output column, so a warp reads one 128-byte run of a word row, word rows
// loaded ahead of their arithmetic, MT rows of sums in registers (MT = 1,
// 8 or 32, the smallest that holds M; each row's sums run the same way at
// any MT), and x tiles in shared memory read by every lane at once (a
// broadcast). K is split over gridDim.y by a count chosen from K and N
// alone; each split writes its f32 partial sums and a second kernel adds
// them in split order, so a row's result never depends on M or on the run.

#include "common.cuh"
#include "stacked_mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPre = 8;  // word rows a thread loads ahead

// K14 gptq_stacked_gemv replaces _qmm_kernel_v3_stacked (pallas_qmm.py:476,
// unfused, f32 out) and _qmm_kernel_v4_stacked (:514, fused, bf16 out):
// stacked_mma::stacked_mma_kernel on stacked_mma::GptqOrder<bits>.

// ---------------------------------------------------------------------------
// K15 gptq_stacked_w4a8_gemv.
//
// Replaces _qmm_kernel_w4a8_v3_stacked (pallas_qmm.py:584): x8 the
// per-token int8 activations (ops.qmm.quantize_rows_int8, natural k
// order), exact s8 x s8 -> s32 group dots, y[m, n] = sum_g s_g[n] * d_g in
// f32. The zero-point term and the token scale are applied by the caller,
// as JAX applies them outside its kernel (:1544-1559).
//
// A word shifted by bits * p and masked per byte is the fields k = r*pf +
// p + npar*b (b = 0..3, npar = 8 / bits) as four s8 values (K12's trick,
// w4a8.cu:414); the x8 tile is laid out in shared memory so that the
// matching four activations form one word, so each (word, parity, row) is
// one __dp4a into the group's s32 sum.
// ---------------------------------------------------------------------------

constexpr int kA8KT = 1024;  // k per x8 tile
constexpr int kA8Words = kA8KT / 4;

template <int BITS, int MT>
__global__ void __launch_bounds__(kThreads)
    gptq_stacked_w4a8_kernel(const int8_t* __restrict__ x8,   // [M, K] natural order
                             const uint32_t* __restrict__ qw,  // [K/pf, Np] of the layer
                             const void* __restrict__ sc, int s_type,  // [G, Np]
                             int M, int K, int Np, int g, int rows_per_split,
                             float* __restrict__ part,   // [splits, M, Np] when split
                             float* __restrict__ out) {  // [M, Np] when not
  constexpr int PF = 32 / BITS;
  constexpr int NPAR = 8 / BITS;
  constexpr uint32_t kMask = ((1u << BITS) - 1u) * 0x01010101u;
  __shared__ int xs[MT][kA8Words];

  const int tid = threadIdx.x;
  const int n = blockIdx.x * kThreads + tid;
  const bool col = n < Np;
  const int rows = K / PF;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(rows, r0 + rows_per_split);

  float y[MT];
  int dot[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    y[m] = 0.f;
    dot[m] = 0;
  }
  int left = g - (r0 * PF) % g;
  float s = 0.f;
  auto close = [&]() {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      y[m] = fmaf(static_cast<float>(dot[m]), s, y[m]);
      dot[m] = 0;
    }
  };
  if (col && r0 < r1) s = load_param(sc, s_type, static_cast<size_t>((r0 * PF) / g) * Np + n);

  for (int k0 = r0 * PF; k0 < r1 * PF; k0 += kA8KT) {
    const int kn = min(kA8KT, r1 * PF - k0);
    const int nw = kn / 4;  // x8 words of each row in this tile
    __syncthreads();
    for (int i = tid; i < MT * nw; i += kThreads) {
      const int m = i / nw, w = i % nw;
      uint32_t v = 0;
      if (m < M) {
        // word w = (word row rr, parity p): bytes b hold k = rr*pf + p + npar*b
        const int rr = w / NPAR, p = w % NPAR;
        const int8_t* xr = x8 + static_cast<size_t>(m) * K + k0 + rr * PF + p;
#pragma unroll
        for (int b = 0; b < 4; ++b) v |= (static_cast<uint32_t>(xr[NPAR * b]) & 0xFFu) << (8 * b);
      }
      xs[m][w] = static_cast<int>(v);
    }
    __syncthreads();
    if (col) {
      const int ra = k0 / PF, rb = (k0 + kn) / PF;
      for (int rc = ra; rc < rb; rc += kPre) {
        uint32_t wb[kPre];
#pragma unroll
        for (int i = 0; i < kPre; ++i)
          wb[i] = rc + i < rb ? __ldcs(qw + static_cast<size_t>(rc + i) * Np + n) : 0u;
#pragma unroll
        for (int i = 0; i < kPre; ++i) {
          const int r = rc + i;
          if (r >= rb) break;
          const int* xr = &xs[0][(r - ra) * NPAR];
#pragma unroll
          for (int p = 0; p < NPAR; ++p) {
            const int v = static_cast<int>((wb[i] >> (BITS * p)) & kMask);
#pragma unroll
            for (int m = 0; m < MT; ++m) dot[m] = __dp4a(v, xr[m * kA8Words + p], dot[m]);
          }
          left -= PF;
          if (left == 0) {
            close();
            left = g;
            if (r + 1 < r1) s = load_param(sc, s_type, static_cast<size_t>(((r + 1) * PF) / g) * Np + n);
          }
        }
      }
    }
  }
  if (!col) return;
  if (left != g) close();
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < M) {
      if (part != nullptr)
        part[(static_cast<size_t>(blockIdx.y) * M + m) * Np + n] = y[m];
      else
        out[static_cast<size_t>(m) * Np + n] = y[m];
    }
  }
}

template <int BITS>
void launch_k15_bits(dim3 grid, cudaStream_t st, const int8_t* x8, const uint32_t* qw, const void* sc, int s_type,
                     int M, int K, int Np, int g, int rps, float* part, float* out) {
  if (M <= 1)
    gptq_stacked_w4a8_kernel<BITS, 1><<<grid, kThreads, 0, st>>>(x8, qw, sc, s_type, M, K, Np, g, rps, part, out);
  else if (M <= 8)
    gptq_stacked_w4a8_kernel<BITS, 8><<<grid, kThreads, 0, st>>>(x8, qw, sc, s_type, M, K, Np, g, rps, part, out);
  else
    gptq_stacked_w4a8_kernel<BITS, 32><<<grid, kThreads, 0, st>>>(x8, qw, sc, s_type, M, K, Np, g, rps, part, out);
}

bool stacked_args_ok(int bits, int M, int K, int Np, int g, int layer, int splits, int rows_per_split, void* part,
                     int s_type) {
  const int pf = (bits == 2 || bits == 4) ? 32 / bits : 0;
  return pf != 0 && M >= 1 && M <= 32 && Np >= 1 && layer >= 0 && g >= pf && g % pf == 0 && K % g == 0 &&
         splits >= 1 && splits <= 65535 && rows_per_split >= 1 &&
         static_cast<long long>(splits) * rows_per_split >= K / pf && (splits == 1 || part != nullptr) &&
         s_type >= 0 && s_type <= 2;
}

}  // namespace

// K14: layer `layer` of qweight [L, K/pf, Np] and scales / zs [L, G, Np];
// fused = 1 runs v4 (bf16 out), 0 runs v3 (f32 out, zs not read); splits:
// blocks along K, each rows_per_split word rows; `part` holds splits * M *
// Np floats when split
QLLM_API int qllm_gptq_stacked_gemv(const void* x, int x_f32, const void* qweight, const void* scales,
                                    const void* zs, int s_type, void* part, void* out, int layer, int bits,
                                    int fused, int M, int K, int Np, int g, int splits, int rows_per_split,
                                    void* stream) {
  if (!stacked_args_ok(bits, M, K, Np, g, layer, splits, rows_per_split, part, s_type) ||
      (fused && zs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int pf = 32 / bits;
  const size_t lw = static_cast<size_t>(K / pf) * Np, ls = static_cast<size_t>(K / g) * Np;
  const auto* qw = static_cast<const uint32_t*>(qweight) + layer * lw;
  const void* sc = param_offset(scales, s_type, layer * ls);
  const void* zz = fused ? param_offset(zs, s_type, layer * ls) : nullptr;
  if (bits == 2)
    return stacked_mma::run<stacked_mma::GptqOrder<2>>(x, x_f32, qw, sc, zz, s_type, part, out, fused, M, K, Np, g,
                                                        splits, rows_per_split, st);
  return stacked_mma::run<stacked_mma::GptqOrder<4>>(x, x_f32, qw, sc, zz, s_type, part, out, fused, M, K, Np, g,
                                                      splits, rows_per_split, st);
}

// K15: x8 [M, K] int8 against layer `layer` of qweight [L, K/pf, Np] and
// scales [L, G, Np] -> f32 [M, Np]; splits as K14's
QLLM_API int qllm_gptq_stacked_w4a8_gemv(const void* x8, const void* qweight, const void* scales, int s_type,
                                         void* part, void* out, int layer, int bits, int M, int K, int Np, int g,
                                         int splits, int rows_per_split, void* stream) {
  if (!stacked_args_ok(bits, M, K, Np, g, layer, splits, rows_per_split, part, s_type) || K % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int pf = 32 / bits;
  const size_t lw = static_cast<size_t>(K / pf) * Np, ls = static_cast<size_t>(K / g) * Np;
  const auto* qw = static_cast<const uint32_t*>(qweight) + layer * lw;
  const void* sc = param_offset(scales, s_type, layer * ls);
  const auto* xq = static_cast<const int8_t*>(x8);
  const dim3 grid((Np + kThreads - 1) / kThreads, splits);
  float* p = splits > 1 ? static_cast<float*>(part) : nullptr;
  auto* o = static_cast<float*>(out);
  if (bits == 2)
    launch_k15_bits<2>(grid, st, xq, qw, sc, s_type, M, K, Np, g, rows_per_split, p, o);
  else
    launch_k15_bits<4>(grid, st, xq, qw, sc, s_type, M, K, Np, g, rows_per_split, p, o);
  if (splits > 1) {
    const int MN = M * Np;
    split_sum_out_kernel<<<(MN + 255) / 256, 256, 0, st>>>(p, splits, MN, 0, out);
  }
  return qllm_launch_status();
}
