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
// zs, read once). Design: one thread per output column (a warp reads one
// 128-byte run of each plane's word row), the `bits` plane words of the
// next 32 rows loaded while the current ones are used; q is rebuilt in
// registers with shifts and masks as the TPU kernel does it: plane b
// shifted right by p and masked with 0x01010101 is bit b of rows 32w + 8c
// + p (c = 0..3) as bytes, and their sum shifted by b is four q values at
// once (q < 128: no byte overflows). No repack to wider words. x tiles in
// shared memory are read by every lane at once, with the sums of each 8
// rows beside them for the fused correction. K is split over gridDim.y by
// a count chosen from K and N alone and the partial sums added in split
// order, so a row's result never depends on M or on the run.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kKT = 256;  // k per x tile in shared memory
constexpr int kChunks = kKT / 8;

template <int BITS, int MT, bool FUSE>
__global__ void __launch_bounds__(kThreads)
    bitplane_stacked_gemv_kernel(const void* __restrict__ x, int x_f32,  // [M, K]
                                 const uint32_t* __restrict__ qw,        // [bits * K/32, Np] of the layer
                                 const void* __restrict__ sc, const void* __restrict__ zs, int s_type,  // [G, Np]
                                 int M, int K, int Np, int g, int words_per_split,
                                 float* __restrict__ part,  // [splits, M, Np] when split
                                 void* __restrict__ out) {  // [M, Np] f32 (unfused) or bf16 (fused) when not
  __shared__ float xs[MT][kKT];
  __shared__ float xc[FUSE ? MT : 1][kChunks];  // sums of x over each 8 rows

  const int tid = threadIdx.x;
  const int n = blockIdx.x * kThreads + tid;
  const bool col = n < Np;
  const int W = K / 32;  // words per plane
  const int w0 = blockIdx.y * words_per_split;
  const int w1 = min(W, w0 + words_per_split);

  float y[MT], dot[MT], xg[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) y[m] = dot[m] = xg[m] = 0.f;
  int left = g - (32 * w0) % g;  // rows left in the group open at w0
  float s = 0.f, z = 0.f;
  auto load_group = [&](int k) {
    const size_t gi = static_cast<size_t>(k / g) * Np + n;
    s = load_param(sc, s_type, gi);
    if (FUSE) z = load_param(zs, s_type, gi);
  };
  auto close = [&]() {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      y[m] = FUSE ? y[m] + dot[m] * s - xg[m] * z : fmaf(dot[m], s, y[m]);
      dot[m] = xg[m] = 0.f;
    }
  };
  auto load_planes = [&](int w, uint32_t (&pl)[BITS]) {
#pragma unroll
    for (int b = 0; b < BITS; ++b) pl[b] = __ldcs(qw + (static_cast<size_t>(b) * W + w) * Np + n);
  };
  uint32_t nxt[BITS];
  if (col && w0 < w1) {
    load_group(32 * w0);
    load_planes(w0, nxt);
  }

  for (int k0 = 32 * w0; k0 < 32 * w1; k0 += kKT) {
    const int kn = min(kKT, 32 * w1 - k0);
    __syncthreads();
    for (int i = tid; i < MT * kKT; i += kThreads) {
      const int m = i / kKT, kk = i % kKT;
      xs[m][kk] = (m < M && kk < kn) ? load_x(x, x_f32, static_cast<size_t>(m) * K + k0 + kk) : 0.f;
    }
    __syncthreads();
    if (FUSE) {
      for (int i = tid; i < MT * kChunks; i += kThreads) {
        const int m = i / kChunks, c = i % kChunks;
        float a = 0.f;
#pragma unroll
        for (int p = 0; p < 8; ++p) a += xs[m][8 * c + p];
        xc[m][c] = a;
      }
      __syncthreads();
    }
    if (!col) continue;
    const int wa = k0 / 32, wb = (k0 + kn) / 32;
    for (int w = wa; w < wb; ++w) {
      uint32_t pl[BITS];
#pragma unroll
      for (int b = 0; b < BITS; ++b) pl[b] = nxt[b];
      if (w + 1 < w1) load_planes(w + 1, nxt);
      // v[p]: byte c holds q of row 32w + 8c + p
      uint32_t v[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        uint32_t a = 0u;
#pragma unroll
        for (int b = 0; b < BITS; ++b) a += ((pl[b] >> p) & 0x01010101u) << b;
        v[p] = a;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float* xr = &xs[0][(w - wa) * 32 + 8 * c];
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const float q = static_cast<float>((v[p] >> (8 * c)) & 0xFFu);
#pragma unroll
          for (int m = 0; m < MT; ++m) dot[m] = fmaf(xr[m * kKT + p], q, dot[m]);
        }
        if (FUSE) {
#pragma unroll
          for (int m = 0; m < MT; ++m) xg[m] += xc[m][(w - wa) * 4 + c];
        }
        left -= 8;
        if (left == 0) {  // the group ends with these 8 rows
          close();
          left = g;
          const int k_next = 32 * w + 8 * c + 8;
          if (k_next < 32 * w1) load_group(k_next);
        }
      }
    }
  }
  if (!col) return;
  if (left != g) close();  // the split ends inside a group
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < M) {
      const size_t o = static_cast<size_t>(m) * Np + n;
      if (part != nullptr)
        part[(static_cast<size_t>(blockIdx.y) * M + m) * Np + n] = y[m];
      else if (FUSE)
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y[m]);
      else
        static_cast<float*>(out)[o] = y[m];
    }
  }
}

template <int BITS, int MT>
void launch_mt(dim3 grid, cudaStream_t st, int fused, const void* x, int x_f32, const uint32_t* qw, const void* sc,
               const void* zs, int s_type, int M, int K, int Np, int g, int wps, float* part, void* out) {
  if (fused)
    bitplane_stacked_gemv_kernel<BITS, MT, true>
        <<<grid, kThreads, 0, st>>>(x, x_f32, qw, sc, zs, s_type, M, K, Np, g, wps, part, out);
  else
    bitplane_stacked_gemv_kernel<BITS, MT, false>
        <<<grid, kThreads, 0, st>>>(x, x_f32, qw, sc, zs, s_type, M, K, Np, g, wps, part, out);
}

template <int BITS>
void launch_bits(dim3 grid, cudaStream_t st, int fused, const void* x, int x_f32, const uint32_t* qw,
                 const void* sc, const void* zs, int s_type, int M, int K, int Np, int g, int wps, float* part,
                 void* out) {
  if (M <= 1)
    launch_mt<BITS, 1>(grid, st, fused, x, x_f32, qw, sc, zs, s_type, M, K, Np, g, wps, part, out);
  else if (M <= 8)
    launch_mt<BITS, 8>(grid, st, fused, x, x_f32, qw, sc, zs, s_type, M, K, Np, g, wps, part, out);
  else
    launch_mt<BITS, 32>(grid, st, fused, x, x_f32, qw, sc, zs, s_type, M, K, Np, g, wps, part, out);
}

}  // namespace

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
  const dim3 grid((Np + kThreads - 1) / kThreads, splits);
  float* p = splits > 1 ? static_cast<float*>(part) : nullptr;
  if (bits == 3)
    launch_bits<3>(grid, st, fused, x, x_f32, qw, sc, zz, s_type, M, K, Np, g, words_per_split, p, out);
  else if (bits == 5)
    launch_bits<5>(grid, st, fused, x, x_f32, qw, sc, zz, s_type, M, K, Np, g, words_per_split, p, out);
  else if (bits == 6)
    launch_bits<6>(grid, st, fused, x, x_f32, qw, sc, zz, s_type, M, K, Np, g, words_per_split, p, out);
  else
    launch_bits<7>(grid, st, fused, x, x_f32, qw, sc, zz, s_type, M, K, Np, g, words_per_split, p, out);
  if (splits > 1) {
    const int MN = M * Np;
    split_sum_out_kernel<<<(MN + 255) / 256, 256, 0, st>>>(p, splits, MN, fused, out);
  }
  return qllm_launch_status();
}
