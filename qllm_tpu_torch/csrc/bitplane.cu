// K16 bitplane_stacked_gemv: the decode matmul (M <= 32) on [L]-stacked
// odd-width (3, 5, 6, 7-bit) serving weights in the plane-major bit-plane
// layout. Replaces _qmm_kernel_odd_stacked (qllm_tpu/ops/pallas_qmm.py:676),
// reached through _qmm_2d_stacked (:1434).
//
// Layout: a layer's words are [bits * K/32, Np]; plane b is word rows
// [b * K/32, (b + 1) * K/32), and bit 8c + p of word w of a plane holds
// that bit of row k = 32w + 8c + p. With x in f32 and q the unsigned field:
//   unfused: y[m, n] = sum_g s_g[n] * (x_g . q_g[:, n]), f32 out; the caller
//            takes off xsum_g @ zs_g outside, as JAX does (:1465-1473);
//   fused:   y[m, n] = sum_g (s_g[n] * (x_g . q_g[:, n]) - sum(x_g) *
//            zs_g[n]), rounded to bf16 (the bf16-scale stacks).
// Groups hold a multiple of 8 rows (odd_stacked_kernel_ok); g = K is the
// full-K block.
//
// Bound on the H100: bytes (bits words per 32 rows of a column, scales and
// zs, read once). The group dots run on the tensor cores
// (csrc/stacked_mma.cuh, the body K14 shares): a lane takes the `bits`
// plane words of one word index for four adjacent columns (16 bytes a
// plane) and rebuilds four q bytes at a time with shifts and masks as the
// TPU kernel does (plane b's bit p of each byte moved to bit b, summed over
// the planes; q < 128: no byte overflows), then sets two of them beside
// 0x43 by a byte permute: an exact bf16 pair 128 + q, less 128. No repack
// to wider words.

#include "bitplane_run.cuh"

// K16: layer `layer` of qweight [L, bits * K/32, Np] and scales / zs
// [L, G, Np]; fused = 1: bf16 out with the zero-point term in-kernel, 0:
// f32 out without it (zs not read); splits: blocks along K, each
// words_per_split words of every plane; `part` holds splits * M * Np
// floats when split
QLLM_API int qllm_bitplane_stacked_gemv(const void* x, int x_f32, const void* qweight, const void* scales,
                                        const void* zs, int s_type, void* part, void* out, int layer, int bits,
                                        int fused, int M, int K, int Np, int g, int splits, int words_per_split,
                                        void* stream) {
  if ((bits != 3 && bits != 5 && bits != 6 && bits != 7) || M < 1 || M > 32 || Np < 1 || layer < 0 ||
      K % 32 != 0 || g < 8 || g % 8 != 0 || K % g != 0 || splits < 1 || splits > 65535 || words_per_split < 1 ||
      static_cast<long long>(splits) * words_per_split < K / 32 || (splits > 1 && part == nullptr) ||
      s_type < 0 || s_type > 2 || (fused && zs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const size_t lw = static_cast<size_t>(bits) * (K / 32) * Np, ls = static_cast<size_t>(K / g) * Np;
  const auto* qw = static_cast<const uint32_t*>(qweight) + layer * lw;
  const void* sc = param_offset(scales, s_type, layer * ls);
  const void* zz = fused ? param_offset(zs, s_type, layer * ls) : nullptr;
  switch (bits) {
    case 3:
      return bitplane_run<3>(x, x_f32, qw, sc, zz, s_type, part, out, fused, M, K, Np, g, splits, words_per_split, st);
    case 5:
      return bitplane_run<5>(x, x_f32, qw, sc, zz, s_type, part, out, fused, M, K, Np, g, splits, words_per_split, st);
    case 6:
      return bitplane_run<6>(x, x_f32, qw, sc, zz, s_type, part, out, fused, M, K, Np, g, splits, words_per_split, st);
    default:
      return bitplane_run<7>(x, x_f32, qw, sc, zz, s_type, part, out, fused, M, K, Np, g, splits, words_per_split, st);
  }
}
