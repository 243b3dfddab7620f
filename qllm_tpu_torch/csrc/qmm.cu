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

#include "planar_gemv.cuh"

// ---------------------------------------------------------------------------
// K1 w4_planar_gemv (decode, M <= 32).
//
// Replaces the per-group branch of _qmm_kernel_planar_full
// (qllm_tpu/ops/pallas_qmm.py:832, :917-954) with its fused RMSNorm
// (:883-893), driven by _qmm_2d_stacked / qmatmul_pallas_stacked:
//   y[m,n] = sum_g (x_g . q_g[:,n]) * s_g[n] - (sum x_g) * zs_g[n]
// with an f32-accumulated dot over the integer nibbles: the block of
// csrc/planar_gemv.cuh with bf16 scales and zs.
// ---------------------------------------------------------------------------

namespace {

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
  if (M < 1 || M > 32 || !planar_geometry_ok(K, g) || (nt != 2 && nt != 4) ||
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
  if (n < 1 || n > 65535 || n_experts < 1 || !planar_geometry_ok(K, g) ||
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
    const int grp = (16 * t + 4 * c) / g;  // the group of this thread's k quadruple
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
  if (M < 1 || !planar_geometry_ok(K, g) || Np % kBN != 0)
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
