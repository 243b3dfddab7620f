// The GPTQ-order decode matmuls (M <= 32), all on the tensor-core body of
// csrc/stacked_mma.cuh (one translation unit, so that K9 and K14 share its
// instantiations). Word row r of a layer's words [K/pf, Np] (pf = 32 /
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

#include "common.cuh"
#include "stacked_mma.cuh"

namespace {

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
