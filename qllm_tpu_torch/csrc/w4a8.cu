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
//     (:832, :871-873, :932-942) on the [L]-stacked planar serving layout,
//     its product on the tensor-core body's int8 planar consumer
//     (csrc/stacked_mma.cuh, planar_s8_kernel).
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
#include "stacked_mma.cuh"

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

using namespace stacked_mma;

template <int NT>
int launch_planar_s8(int splits, cudaStream_t st, const int8_t* x8, const float* sx, const uint32_t* qw,
                     const __nv_bfloat16* sc, const __nv_bfloat16* zs, int M, int K, int Np, int g, int ups,
                     float* part, __nv_bfloat16* out) {
  static int allowed[kMaxDevices];
  int kc = ups;  // a multiple of 4, within kXBudget
  while (kc > 4 && planar_s8_chunk_bytes(M, kc, g) > kXBudget) kc -= 4;
  const int smem = ring_bytes<Planar>() + planar_s8_chunk_bytes(M, kc, g);
  auto kern = planar_s8_kernel<NT>;
  if (const int e = allow_dynamic_smem(kern, smem, allowed)) return e;
  kern<<<dim3((Np + kCols - 1) / kCols, 1, splits), kBlock, smem, st>>>(x8, sx, qw, sc, zs, M, K, Np, g, ups, kc, part,
                                                                         out);
  return 0;
}

// K11's product (x8 and sx made): the int8 body of csrc/stacked_mma.cuh
// for M (1, 2 or 4 n-tiles) and, if K is split, planar_out_kernel; a
// cudaError_t. units_per_split % 4 == 0; part: [splits, M, Np] f32 when
// split
int run_planar_s8(const int8_t* x8, const float* sx, const uint32_t* qw, const __nv_bfloat16* sc,
                  const __nv_bfloat16* zs, float* part, __nv_bfloat16* out, int M, int K, int Np, int g, int splits,
                  int ups, cudaStream_t st) {
  float* p = splits > 1 ? part : nullptr;
  const int e = M <= 8    ? launch_planar_s8<1>(splits, st, x8, sx, qw, sc, zs, M, K, Np, g, ups, p, out)
                : M <= 16 ? launch_planar_s8<2>(splits, st, x8, sx, qw, sc, zs, M, K, Np, g, ups, p, out)
                          : launch_planar_s8<4>(splits, st, x8, sx, qw, sc, zs, M, K, Np, g, ups, p, out);
  if (e != 0) return e;
  if (p != nullptr)
    planar_out_kernel<__nv_bfloat16><<<dim3((Np + 255) / 256, M), 256, 0, st>>>(p, splits, M, Np, nullptr, K, 0.f, sx,
                                                                                out);
  return qllm_launch_status();
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
// allocates, then the int8 body (splits along K, units_per_split word rows
// each, a multiple of 4) and, when split, its second kernel; part: splits
// * M * Np floats when split
QLLM_API int qllm_w4a8_planar_gemv(const void* x, int x_f32, void* x8, void* sx, const void* qweight,
                                   const void* scales, const void* zs, const void* norm_w, int nw_f32, float eps,
                                   void* part, void* out, int layer, int M, int K, int Np, int g, int splits,
                                   int units_per_split, void* stream) {
  using stacked_mma::aligned16;
  if (M < 1 || M > 32 || !planar_geometry_ok(K, g) || Np < 32 || Np % 32 != 0 || units_per_split % 4 != 0 ||
      !stacked_mma::split_plan_ok(K / 8, splits, units_per_split) || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const void* nw = nullptr;
  if (norm_w != nullptr)
    nw = static_cast<const char*>(norm_w) + static_cast<size_t>(layer) * K * (nw_f32 ? 4 : 2);
  const size_t ls = static_cast<size_t>(K / g) * Np;
  const auto* qw = static_cast<const uint32_t*>(qweight) + layer * (static_cast<size_t>(K / 8) * Np);
  const auto* sc = static_cast<const __nv_bfloat16*>(scales) + layer * ls;
  const auto* zz = static_cast<const __nv_bfloat16*>(zs) + layer * ls;
  if (!aligned16(x8) || !aligned16(qw) || !aligned16(sc) || !aligned16(zz) || (part != nullptr && !aligned16(part)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int code = launch_quantize(x, x_f32, nullptr, x8, sx, nullptr, M, K, g, st, nw, nw_f32, eps);
  if (code != 0) return code;
  return run_planar_s8(static_cast<const int8_t*>(x8), static_cast<const float*>(sx), qw, sc, zz,
                                    static_cast<float*>(part), static_cast<__nv_bfloat16*>(out), M, K, Np, g, splits,
                                    units_per_split, st);
}
