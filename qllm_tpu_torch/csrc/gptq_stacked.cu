// The GPTQ-order decode matmuls (M <= 32), all on the tensor-core body of
// csrc/stacked_mma.cuh (one translation unit, so that K9 and K14 share its
// bf16 instantiations, K15 and K12 its int8 ones). Word row r of a layer's words [K/pf, Np] (pf = 32 /
// bits) holds k = r * pf + f at bit offset bits * f; scales, zs = zeros *
// scales and zero points [G, Np] are read in the dtype they are stored in
// (0 = f32, 1 = fp16, 2 = bf16). A stacked layer is taken from the stack by
// pointer arithmetic: nothing copies it out.
//
// Bound on the H100: bytes (each layer's words, scales and zs or zero
// points, read once). What the body does about it: a producer warp keeps
// the block's word rows in flight by bulk copies into a shared-memory ring,
// and four consumer warps run the group dots on mma.sync (see the header).
//
// K14 gptq_stacked_gemv replaces _qmm_kernel_v3_stacked (pallas_qmm.py:476,
// unfused, f32 out) and _qmm_kernel_v4_stacked (:514, fused, bf16 out), the
// packed branch of _qmm_2d_stacked (:1530): stacked_mma_kernel on
// GptqOrder<2 | 4>.
//
// K9 gptq_gemv (the per-layer decode GEMV) replaces _qmm_kernel_v3
// (pallas_qmm.py:177) and the f32-dot branch of _qmm_kernel (:119) as
// _qmm_2d (:300) runs them at M <= 32: x in bf16 or f32,
//   y[m, n] = bf16(sum_g (s_g[n] * (x_g . q_g[:, n]) - sum(x_g) * z_g[n] * s_g[n]))
// in JAX's order: an f32 dot per group scaled at its end, the zero-point
// term JAX takes off outside its kernel (:470-472) formed in f32 from the
// zero points beside the scales and taken off at the same group end (the
// geometries JAX sends to its f32-dot branch compute the same function
// with another f32 rounding). stacked_mma_kernel, fused, on GptqOrder<2 |
// 4 | 8> of layer 0; an 8-bit field runs as two exact nibble MMAs. A
// second kernel adds the splits (a merge in the launch by the last split
// to arrive measured ~1 us slower a call at the 7B shapes: PERF.md).
//
// K15 gptq_stacked_w4a8_gemv replaces _qmm_kernel_w4a8_v3_stacked
// (pallas_qmm.py:584): x8 the per-token int8 activations
// (ops.qmm.quantize_rows_int8, natural k order), exact s8 x s8 -> s32 group
// dots on mma.sync m16n8k32 (stacked_s8_kernel), y[m, n] = sum_g s_g[n] *
// d_g in f32. The zero-point term and the token scale are applied by the
// caller, as JAX applies them outside its kernel (:1544-1559).
//
// K12 gptq_w4a8_gemv (the per-layer W4A8 decode GEMV) replaces
// _qmm_kernel_w4a8 (pallas_qmm.py:239) with the correction _qmm_2d runs
// after it (:385-400), 2 and 4 bits: three launches, whatever the shape.
//   1. The quantizer (csrc/w4a8.cu): x8 in natural k order, sx and the
//      per-group sums xsum of x8; with act-order it gathers x by the perm
//      as it reads it (the gather JAX runs first, exact: the same bits).
//   2. K15's body, stacked_s8_kernel on layer 0: y1 = sum_g s_g * d_g, d_g
//      the exact s32 group dot, each split's f32 partial sums to `part`
//      (K split at group boundaries, from (K, N, g) alone).
//   3. a8_epilogue_kernel: y1 = the splits' partials added in split order,
//      corr = sum_g xsum[m, g] * (z[g, n] * s[g, n]) in f32 in group order,
//      y = bf16((y1 - corr) * sx[m]): JAX's order (xsum @ zs after the
//      kernel, then the token scale).
// Bound on the H100: bytes (the words, scales and zero points, read once).

#include "common.cuh"
#include "stacked_mma.cuh"

// csrc/w4a8.cu
int launch_quantize_rows(const void* x, int x_f32, const int* perm, void* x8, void* sx, void* xsum, int M, int K,
                         int g, cudaStream_t st);

namespace {

constexpr int kEpiThreads = 64;   // columns a block of the epilogue takes
constexpr int kEpiGroups = 32;    // groups whose z * s a thread loads before it sums them
constexpr int kEpiSplits = 16;    // splits whose partial sums a thread loads before it adds them
constexpr int kEpiMaxGroups = 2048;  // groups a row: a block's 4 rows of xsum in 32 KB of shared memory

// K12's epilogue: thread (column n, rows m0 .. m0 + R) forms each row's
// correction over the groups in order (z * s formed once a group), then
// adds the splits' partial sums in split order. Latency bounds it (a few
// loads a thread, all from L2), so each chunk's loads are issued before
// any of its sums, and the first chunks' before the block stages its rows
// of xsum in shared memory; ST, the parameters' storage type, is a template
// argument, so that no branch separates the loads. R = 1 at M <= 8 (more
// threads), 4 above (z * s loaded once for 4 rows): each faster there
// (chip_stacked_ab.py --parts k12). A row's bits do not depend on R.
template <int ST, int R>
__global__ void __launch_bounds__(kEpiThreads)
    a8_epilogue_kernel(const float* __restrict__ part, int splits, int M, int N, int G,
                       const float* __restrict__ sx, const int* __restrict__ xsum,  // [M], [M, G]
                       const void* __restrict__ sc, const void* __restrict__ zr,    // [G, N]
                       __nv_bfloat16* __restrict__ out) {                           // [M, N]
  extern __shared__ int xs[];  // [R][G]
  const int m0 = blockIdx.y * R;
  const int rows = min(R, M - m0);
  const int col = blockIdx.x * kEpiThreads + threadIdx.x;
  const int n = min(col, N - 1);  // past N: column N - 1 again, not stored
  const size_t MN = static_cast<size_t>(M) * N;
  const float* pn = part + static_cast<size_t>(m0) * N + n;
  float zs[kEpiGroups], v[R][kEpiSplits];
  auto load_groups = [&](int g0) {
#pragma unroll
    for (int j = 0; j < kEpiGroups; ++j) {
      const size_t at = static_cast<size_t>(min(g0 + j, G - 1)) * N + n;
      zs[j] = load_param(zr, ST, at) * load_param(sc, ST, at);
    }
  };
  auto load_splits = [&](int s0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < kEpiSplits; ++j)
        v[r][j] = r < rows ? __ldg(pn + min(s0 + j, splits - 1) * MN + static_cast<size_t>(r) * N) : 0.f;
  };
  load_groups(0);
  load_splits(0);
  for (int i = threadIdx.x; i < rows * G; i += kEpiThreads) xs[i] = __ldg(xsum + static_cast<size_t>(m0) * G + i);
  __syncthreads();
  float corr[R], y1[R];
#pragma unroll
  for (int r = 0; r < R; ++r) corr[r] = y1[r] = 0.f;
  for (int g0 = 0; g0 < G; g0 += kEpiGroups) {
    if (g0 > 0) load_groups(g0);
#pragma unroll
    for (int j = 0; j < kEpiGroups; ++j) {
      if (g0 + j >= G) break;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < rows) corr[r] = fmaf(static_cast<float>(xs[r * G + g0 + j]), zs[j], corr[r]);
    }
  }
  for (int s0 = 0; s0 < splits; s0 += kEpiSplits) {
    if (s0 > 0) load_splits(s0);
#pragma unroll
    for (int j = 0; j < kEpiSplits; ++j) {
      if (s0 + j >= splits) break;
#pragma unroll
      for (int r = 0; r < R; ++r) y1[r] += v[r][j];
    }
  }
  if (col >= N) return;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r < rows)
      out[static_cast<size_t>(m0 + r) * N + n] = __float2bfloat16_rn((y1[r] - corr[r]) * __ldg(sx + m0 + r));
}

bool gptq_args_ok(int bits, int M, int K, int Np, int g, int splits, int units_per_split, const void* part,
                  int s_type) {
  const int pf = (bits == 2 || bits == 4 || bits == 8) ? 32 / bits : 0;
  return pf != 0 && M >= 1 && M <= 32 && Np >= 1 && K >= 1 && K % pf == 0 && g >= pf && g % pf == 0 &&
         K % g == 0 && splits >= 1 && splits <= 65535 && units_per_split >= 1 &&
         static_cast<long long>(splits) * units_per_split >= K / pf &&
         static_cast<long long>(splits - 1) * units_per_split < K / pf && (splits == 1 || part != nullptr) &&
         s_type >= 0 && s_type <= 2;
}

}  // namespace

// K9: x [M, K] (bf16, or f32 with x_f32 = 1) against qweight [K/pf, N],
// scales and zeros [G, N] -> bf16 [M, N]; splits: blocks along K, each
// units_per_split word rows; when split, `part` holds splits * M * N floats
QLLM_API int qllm_gptq_gemv(const void* x, int x_f32, const void* qweight, const void* scales, const void* zeros,
                            int s_type, void* part, void* out, int bits, int M, int K, int N, int g, int splits,
                            int units_per_split, void* stream) {
  if (!gptq_args_ok(bits, M, K, N, g, splits, units_per_split, part, s_type))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* qw = static_cast<const uint32_t*>(qweight);
  if (bits == 2)
    return stacked_mma::run_body<stacked_mma::GptqOrder<2>, true>(x, x_f32, qw, scales, zeros, s_type, 1, part, out,
                                                                  M, K, N, g, splits, units_per_split, st);
  if (bits == 4)
    return stacked_mma::run_body<stacked_mma::GptqOrder<4>, true>(x, x_f32, qw, scales, zeros, s_type, 1, part, out,
                                                                  M, K, N, g, splits, units_per_split, st);
  return stacked_mma::run_body<stacked_mma::GptqOrder<8>, true>(x, x_f32, qw, scales, zeros, s_type, 1, part, out,
                                                                M, K, N, g, splits, units_per_split, st);
}

// K14: layer `layer` of qweight [L, K/pf, Np] and scales / zs [L, G, Np];
// fused = 1 runs v4 (bf16 out), 0 runs v3 (f32 out, zs not read); splits:
// blocks along K, each rows_per_split word rows; `part` holds splits * M *
// Np floats when split
QLLM_API int qllm_gptq_stacked_gemv(const void* x, int x_f32, const void* qweight, const void* scales,
                                    const void* zs, int s_type, void* part, void* out, int layer, int bits,
                                    int fused, int M, int K, int Np, int g, int splits, int rows_per_split,
                                    void* stream) {
  if (bits == 8 || !gptq_args_ok(bits, M, K, Np, g, splits, rows_per_split, part, s_type) || layer < 0 ||
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

// K12: x [M, K] (bf16, or f32 with x_f32 = 1; act-order: value k is
// x[:, perm[k]], perm null otherwise) against qweight [K/pf, N], scales and
// zeros [G, N] -> bf16 [M, N]; x8 [M, K], sx [M] and xsum [M, G] are the
// quantizer's scratch, part [splits, M, N] the body's partial sums (at any
// split count); splits: blocks along K, each units_per_split word rows, a
// multiple of a group's
QLLM_API int qllm_gptq_w4a8_gemv(const void* x, int x_f32, const void* perm, void* x8, void* sx, void* xsum,
                                 const void* qweight, const void* scales, const void* zeros, int s_type, void* part,
                                 void* out, int bits, int M, int K, int N, int g, int splits, int units_per_split,
                                 void* stream) {
  if (bits == 8 || part == nullptr || !gptq_args_ok(bits, M, K, N, g, splits, units_per_split, part, s_type) ||
      units_per_split % (g / (32 / bits)) != 0 || K / g > kEpiMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  int e = launch_quantize_rows(x, x_f32, static_cast<const int*>(perm), x8, sx, xsum, M, K, g, st);
  if (e != 0) return e;
  const auto* xq = static_cast<const int8_t*>(x8);
  const auto* qw = static_cast<const uint32_t*>(qweight);
  e = bits == 2 ? stacked_mma::run_s8<2>(xq, qw, scales, s_type, part, nullptr, M, K, N, g, splits, units_per_split,
                                         st, true)
                : stacked_mma::run_s8<4>(xq, qw, scales, s_type, part, nullptr, M, K, N, g, splits, units_per_split,
                                         st, true);
  if (e != 0) return e;
  const int R = M <= 8 ? 1 : 4;
  const dim3 grid((N + kEpiThreads - 1) / kEpiThreads, (M + R - 1) / R);
  const size_t xs_bytes = R * (K / g) * sizeof(int);
  auto epilogue = R == 1 ? (s_type == 0 ? a8_epilogue_kernel<0, 1> : s_type == 1 ? a8_epilogue_kernel<1, 1>
                                                                                   : a8_epilogue_kernel<2, 1>)
                         : (s_type == 0 ? a8_epilogue_kernel<0, 4> : s_type == 1 ? a8_epilogue_kernel<1, 4>
                                                                                   : a8_epilogue_kernel<2, 4>);
  epilogue<<<grid, kEpiThreads, xs_bytes, st>>>(static_cast<const float*>(part), splits, M, N, K / g,
                                                static_cast<const float*>(sx), static_cast<const int*>(xsum), scales,
                                                zeros, static_cast<__nv_bfloat16*>(out));
  return qllm_launch_status();
}

// K15: x8 [M, K] int8 against layer `layer` of qweight [L, K/pf, Np] and
// scales [L, G, Np] -> f32 [M, Np]; splits as K14's
QLLM_API int qllm_gptq_stacked_w4a8_gemv(const void* x8, const void* qweight, const void* scales, int s_type,
                                         void* part, void* out, int layer, int bits, int M, int K, int Np, int g,
                                         int splits, int rows_per_split, void* stream) {
  if (bits == 8 || !gptq_args_ok(bits, M, K, Np, g, splits, rows_per_split, part, s_type) || layer < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int pf = 32 / bits;
  const size_t lw = static_cast<size_t>(K / pf) * Np, ls = static_cast<size_t>(K / g) * Np;
  const auto* qw = static_cast<const uint32_t*>(qweight) + layer * lw;
  const void* sc = param_offset(scales, s_type, layer * ls);
  const auto* xq = static_cast<const int8_t*>(x8);
  auto* o = static_cast<float*>(out);
  if (bits == 2)
    return stacked_mma::run_s8<2>(xq, qw, sc, s_type, part, o, M, K, Np, g, splits, rows_per_split, st);
  return stacked_mma::run_s8<4>(xq, qw, sc, s_type, part, o, M, K, Np, g, splits, rows_per_split, st);
}
