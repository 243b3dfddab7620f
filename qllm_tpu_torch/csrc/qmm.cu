// K1 w4_planar_gemv and K2 w4_planar_gemm: the planar W4 g-grouped
// matmul y = x @ dequant(W[layer]) on [L]-stacked serving weights
// (qweight [L, K/8, Np] planar words, scales / zs [L, G, Np] bf16,
// zs = zeros * scales prefolded), output bf16 [M, Np]. (K8
// w4_grouped_gemv, the MoE selections' GEMV: csrc/grouped_mma.cu.)
//
// Planar contract (qllm_tpu/quant/qtensor.py:157-161): word r, byte j
// holds k = 4r+j in its low nibble and k = K/2+4r+j in its high nibble,
// so word row r serves one low-half and one high-half k quadruple and a
// group of g k-values spans g/4 word rows in each half.

#include "stacked_mma.cuh"
#include "wgmma.cuh"

// ---------------------------------------------------------------------------
// K1 w4_planar_gemv (decode, M <= 32).
//
// Replaces the per-group branch of _qmm_kernel_planar_full
// (qllm_tpu/ops/pallas_qmm.py:832, :917-954) with its fused RMSNorm
// (:883-893), driven by _qmm_2d_stacked / qmatmul_pallas_stacked:
//   y[m,n] = bf16(r_m * sum_g ((x~_g . q_g[:,n]) * s_g[n] - (sum x~_g) * zs_g[n]))
// with x~ = x and r_m = 1 without the norm, x~ = x * w in f32 and r_m =
// rsqrt(sum_k x[m,k]^2 / K + eps) with it: an f32-accumulated dot per
// group, scaled at the group's end.
//
// Bound on the H100: bytes (the layer's words, scales and zs read once).
// Design: the tensor-core body of csrc/stacked_mma.cuh on planar words
// (planar_mma_kernel, the planar consumer K17 and K8 share): a producer
// warp streams word rows into a shared-memory ring by cp.async.bulk, four
// consumer warps run mma.sync m16n8k16 with the words as A and up to 32
// rows of x as 1, 2 or 4 n-tiles of B; with the norm, x * w as two exact
// bf16 parts (three for an f32 w), each its own MMAs. K is split over
// gridDim.z by a
// count the wrapper takes from K and Np alone (ops.tc_plan.tc_splits), so
// a row's bits never depend on M; planar_out_kernel adds the splits in
// split order and applies r_m, whose sum of squares it takes over the
// whole row.
// ---------------------------------------------------------------------------

// splits: blocks along K, each units_per_split word rows; part: splits * M
// * Np floats when K is split or the norm is on
QLLM_API int qllm_w4_planar_gemv(const void* x, const void* qweight, const void* scales, const void* zs,
                                 const void* norm_w, void* part, void* out, int layer, int M, int K, int Np, int g,
                                 int splits, int units_per_split, int nw_f32, float eps, void* stream) {
  using stacked_mma::aligned16;
  if (M < 1 || M > 32 || !planar_geometry_ok(K, g) || Np < 32 || Np % 32 != 0 ||
      !stacked_mma::split_plan_ok(K / 8, splits, units_per_split) ||
      ((splits > 1 || norm_w != nullptr) && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t ls = static_cast<size_t>(K / g) * Np;
  const auto* qw = static_cast<const uint32_t*>(qweight) + layer * (static_cast<size_t>(K / 8) * Np);
  const auto* sc = static_cast<const __nv_bfloat16*>(scales) + layer * ls;
  const auto* zz = static_cast<const __nv_bfloat16*>(zs) + layer * ls;
  const void* nw = nullptr;
  if (norm_w != nullptr)
    nw = static_cast<const char*>(norm_w) + static_cast<size_t>(layer) * K * (nw_f32 ? 4 : 2);
  if (!aligned16(x) || !aligned16(qw) || !aligned16(sc) || !aligned16(zz) || (nw != nullptr && !aligned16(nw)))
    return static_cast<int>(cudaErrorInvalidValue);
  return stacked_mma::run_planar<true>(static_cast<const __nv_bfloat16*>(x), qw, sc, zz, nw, nw_f32, eps,
                                       static_cast<float*>(part), out, M, K, Np, g, splits, units_per_split,
                                       static_cast<cudaStream_t>(stream));
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
// (~295 flops/byte), so the tensor-core rate bounds it.
//
// Design (csrc/wgmma.cuh, K18's skeleton in csrc/planar_f32.cu):
// wgmma.mma_async with the product swapped: 64 output columns are the
// instruction's rows and the rows of x its width, A = the dequantized
// weight bf16(fmaf(q, s, -zs)) from registers, B = the x tile in
// 128-byte-swizzled shared memory. A block is two warpgroups over 128
// output columns and MC x 64 rows of x (MC = 1 at M <= 64, 2 at M <= 128,
// else 4: the dequantize, built once a block for its rows, costs about as
// much issue time as 128 rows' products, so 256 rows let the tensor cores
// set the pace). The weight is bf16(q * s - zs) in one product (no group
// partials), so the block walks K once: a stage holds 16 word rows and the
// x tiles of both halves (64 k of each); the low nibbles build A against
// the low-half tile and the high nibbles against the high-half tile, into
// the same accumulator. Stages come through a ring filled by cp.async two
// (at MC = 4 one) stages ahead. Each half's four 16-k steps are built at
// once into one of two A register sets while the other half's products
// still read the other set (both held until the wait that retires their
// products: keep_regs), and issued as one group of m64n(64 MC)k16
// instructions.
// Thread (gq, c) of warp w takes columns gq and gq + 8 of its 16 and, for
// the 16-k step j, k 2c, 2c+1 (word row 4j + c/2, bytes 2(c&1), 2(c&1)+1)
// and the same + 8 (two rows further). A nibble becomes an exact f32 by
// PRMT (0x4B0000vv = 2^23 + v) and one FADD, then one FFMA with the
// scale and zs, one rounding to bf16: the TPU kernel's w.
// Scales: where g % 64 == 0 a half-stage lies in one group of each half;
// the (s, zs) of the next group are loaded a group ahead, counted without
// divisions. Elsewhere (any g with (K/2) % g == 0) each element takes the
// (s, zs) of its own group, the group found by a multiply-high with
// ceil(2^32 / g) (exact for k, g < 2^16).
// No split of K: a row's bits never depend on M (MC = 1, 2 and 4 run the
// same k order per output).
// ---------------------------------------------------------------------------

namespace {

constexpr int kGemmThreads = 256;  // two warpgroups
constexpr int kGemmCols = 128;     // output columns of a block
constexpr int kGemmK = 64;         // k of each half a stage
constexpr int kGemmRows = 16;      // word rows a stage (4 k of each half a row)
constexpr int kGemmPitch = 136;    // words of a staged word row: 128 used, rows 8 banks apart

// the ring: copies run kGemmStagesOf<MC> - 2 stages ahead (three stages
// of 256 rows fill the shared memory)
template <int MC>
constexpr int kGemmStagesOf = MC == 4 ? 3 : 4;
template <int MC>
constexpr int kGemmSmemOf = kGemmStagesOf<MC> * (2 * MC * 64 * 128 + kGemmRows * kGemmPitch * 4) + 1024;

// byte `sel` (0x7440 + byte) of `bits` (each byte < 16) as an exact float:
// PRMT builds 0x4B0000vv = 2^23 + v, one FADD removes 2^23
__device__ __forceinline__ float nibble_f32(uint32_t bits, uint32_t sel) {
  return __int_as_float(__byte_perm(bits, 0x4B000000u, sel)) - 8388608.f;
}

template <int MC, bool G64>
__global__ void __launch_bounds__(kGemmThreads, 1)
    w4_gemm_kernel(const __nv_bfloat16* __restrict__ x,   // [M, K]
                   const uint32_t* __restrict__ qw,       // [K/8, Np] this layer
                   const __nv_bfloat16* __restrict__ sc,  // [G, Np]
                   const __nv_bfloat16* __restrict__ zs,  // [G, Np]
                   __nv_bfloat16* __restrict__ out,       // [M, Np]
                   int M, int K, int Np, int g) {
  constexpr int kXBytes = MC * 64 * 128;  // one half's x tile
  constexpr int kStageX = 2 * kXBytes;
  constexpr int kWWords = kGemmRows * kGemmPitch;
  constexpr int kGemmStages = kGemmStagesOf<MC>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = atom_aligned(smem_raw);
  const uint32_t xs0 = smem_u32(smem);
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem + kGemmStages * kStageX);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, c = lane & 3;
  const int m0 = blockIdx.x * 64 * MC, n0 = blockIdx.y * kGemmCols;
  const int cl0 = 64 * (warp >> 2) + 16 * (warp & 3) + gq;  // this thread's columns cl0, cl0 + 8
  const int Kh = K / 2, U = Kh / kGemmK, Gh = Kh / g;
  // the PRMT selectors of this thread's bytes 2(c&1) and 2(c&1) + 1
  const uint32_t sel0 = 0x7440u + 2 * (c & 1), sel1 = sel0 + 1;

  // The copy plan, fixed for the block: x chunk `it` of a half's tile is
  // row (tid >> 3) + 32 it, 16-byte chunk tid & 7; word chunk `it` is word
  // row (tid >> 5) + 8 it, columns n0 + 4 (tid & 31) ..+3.
  const int xr = tid >> 3, xq = tid & 7;
  const __nv_bfloat16* xsrc = x + static_cast<size_t>(m0 + xr) * K + 8 * xq;
  const uint32_t xdst = sw128_offset(xr, xq);  // + 4096 per 32 rows: the same swizzle
  unsigned xok = 0;
#pragma unroll
  for (int it = 0; it < 2 * MC; ++it) xok |= (m0 + xr + 32 * it < M ? 1u : 0u) << it;
  const uint32_t* wsrc = qw + static_cast<size_t>(tid >> 5) * Np + n0 + 4 * (tid & 31);
  const int wdst = (tid >> 5) * kGemmPitch + 4 * (tid & 31);

  // stage u (word rows 16u.., k 64u.. of each half) into ring slot st
  auto issue = [&](int u, int st) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t xt = xs0 + st * kStageX + h * kXBytes + xdst;
      const __nv_bfloat16* xs = xsrc + h * Kh + kGemmK * u;
#pragma unroll
      for (int it = 0; it < 2 * MC; ++it) {
        const bool ok = (xok >> it) & 1u;
        cp_async16_s(xt + it * 4096, ok ? xs + static_cast<size_t>(32 * it) * K : x, ok);
      }
    }
    uint32_t* wt = ws + st * kWWords + wdst;
    const uint32_t* wg = wsrc + static_cast<size_t>(kGemmRows * u) * Np;
#pragma unroll
    for (int it = 0; it < kGemmRows * 32 / kGemmThreads; ++it)
      cp_async16(wt + 8 * it * kGemmPitch, wg + static_cast<size_t>(8 * it) * Np, true);
  };

  float acc[MC][32];
#pragma unroll
  for (int mc = 0; mc < MC; ++mc)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mc][i] = 0.f;

  // g % 64 == 0: (s, zs) of columns cl0, cl0 + 8 for the low-half group
  // and the high-half one, {s0, z0, s1, z1} each; the next group's wait in
  // bf16, loaded a group ahead
  const int stages_per_group = G64 ? g / kGemmK : 1;
  int left = stages_per_group, grp = 0;
  float cur[2][4] = {};
  __nv_bfloat16 nxt[2][4];
  auto fetch = [&](int gi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t at = static_cast<size_t>(h * Gh + gi) * Np + n0 + cl0;
      nxt[h][0] = sc[at];
      nxt[h][1] = zs[at];
      nxt[h][2] = sc[at + 8];
      nxt[h][3] = zs[at + 8];
    }
  };
  auto take = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) cur[h][i] = bf2f(nxt[h][i]);
  };
  // elsewhere: the group of half-k kh is __umulhi(kh, gmagic)
  const uint32_t gmagic = 0xFFFFFFFFu / static_cast<uint32_t>(g) + 1u;
  if constexpr (G64) {
    fetch(0);
    take();
    if (Gh > 1) fetch(1);
  }

  // bf16(fmaf(q, s, -z)) of this thread's two nibbles of `bits`, one
  // (s, z) for both or one each
  auto deq = [&](uint32_t bits, float s0, float z0, float s1, float z1) {
    return bf16x2_bits(__floats2bfloat162_rn(fmaf(nibble_f32(bits, sel0), s0, -z0),
                                             fmaf(nibble_f32(bits, sel1), s1, -z1)));
  };
  // A registers of half h's four 16-k steps of stage u (words wt):
  // columns cl0 (a0, a2) and cl0 + 8 (a1, a3), k 2c.. (a0, a1) and 2c + 8..
  // (a2, a3) of each step
  auto build = [&](const uint32_t* wt, int u, int h, uint32_t (&ar)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r0 = (4 * j + (c >> 1)) * kGemmPitch + cl0, r1 = r0 + 2 * kGemmPitch;
      const uint32_t w[4] = {wt[r0], wt[r0 + 8], wt[r1], wt[r1 + 8]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t bits = (w[i] >> (4 * h)) & 0x0F0F0F0Fu;
        const int col = i & 1;  // 0: cl0, 1: cl0 + 8
        if constexpr (G64) {
          const float s = cur[h][2 * col], z = cur[h][2 * col + 1];
          ar[j][i] = deq(bits, s, z, s, z);
        } else {
          const uint32_t kh = kGemmK * u + 16 * j + 2 * c + 8 * (i >> 1);
          const size_t a0 = static_cast<size_t>(h * Gh + __umulhi(kh, gmagic)) * Np + n0 + cl0 + 8 * col;
          const size_t a1 = static_cast<size_t>(h * Gh + __umulhi(kh + 1, gmagic)) * Np + n0 + cl0 + 8 * col;
          ar[j][i] = deq(bits, bf2f(sc[a0]), bf2f(zs[a0]), bf2f(sc[a1]), bf2f(zs[a1]));
        }
      }
    }
  };

  // stage u in ring slot st: wait for its copies, refill the ring, then
  // per half: build its A set (while the other half's products still read
  // the other set), issue its four steps as one group
  uint32_t ar[2][4][4] = {};
  auto stage = [&](int u, int st, int ist) {
    cp_async_wait<kGemmStages - 3>();  // this thread's copies of stage u landed
    fence_proxy_async();
    // everyone's did, and every warpgroup has waited for stage u - 1's low
    // half (so for all of stage u - 2): its slot is free
    __syncthreads();
    if (u + kGemmStages - 2 < U) issue(u + kGemmStages - 2, ist);
    cp_async_commit();
    const uint32_t* wt = ws + st * kWWords;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      build(wt, u, h, ar[h]);
      const uint64_t desc = sw128_desc(xs0 + st * kStageX + h * kXBytes);  // + 2 per 16-k step: 32 bytes
      // every A register is written before the fence, none between the products
      keep_regs(ar[h]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_rs<MC>(acc, ar[h][j], desc + 2 * j, 1);
      wgmma_commit();
      wgmma_wait<1>();
      // the other half's products are done: only now may its A set be
      // written (kept live until here, so no build reuses its registers)
      keep_regs(ar[1 - h]);
    }
    if constexpr (G64) {
      if (--left == 0) {  // the next stage starts a group
        left = stages_per_group;
        take();
        if (++grp + 1 < Gh) fetch(grp + 1);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kGemmStages - 2; ++i) {
    if (i < U) issue(i, i);
    cp_async_commit();
  }
  int st = 0, ist = kGemmStages - 2;
  for (int u = 0; u < U; ++u) {
    stage(u, st, ist);
    if (++st == kGemmStages) st = 0;
    if (++ist == kGemmStages) ist = 0;
  }
  cp_async_wait<0>();
  wgmma_wait<0>();
#pragma unroll
  for (int mc = 0; mc < MC; ++mc) fence_regs(acc[mc]);

  // D element 4i + e: column cl0 + 8 (e >> 1), x row 8i + 2c + (e & 1) of the chunk
#pragma unroll
  for (int mc = 0; mc < MC; ++mc)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 64 * mc + 8 * i + 2 * c + (e & 1);
        if (m < M) out[static_cast<size_t>(m) * Np + n0 + cl0 + 8 * (e >> 1)] = __float2bfloat16_rn(acc[mc][4 * i + e]);
      }
}

template <int MC, bool G64>
int launch_gemm(dim3 grid, cudaStream_t st, const __nv_bfloat16* x, const uint32_t* qw, const __nv_bfloat16* sc,
                const __nv_bfloat16* zs, __nv_bfloat16* out, int M, int K, int Np, int g) {
  constexpr int bytes = kGemmSmemOf<MC>;
  static int allowed[kMaxDevices];
  if (const int e = allow_dynamic_smem(w4_gemm_kernel<MC, G64>, bytes, allowed)) return e;
  w4_gemm_kernel<MC, G64><<<grid, kGemmThreads, bytes, st>>>(x, qw, sc, zs, out, M, K, Np, g);
  return 0;
}

}  // namespace

QLLM_API int qllm_w4_planar_gemm(const void* x, const void* qweight, const void* scales,
                                 const void* zs, void* out, int layer, int M, int K, int Np,
                                 int g, void* stream) {
  if (M < 1 || !planar_geometry_ok(K, g) || Np % kGemmCols != 0 || Np / kGemmCols > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t lw = static_cast<size_t>(K / 8) * Np;
  const size_t ls = static_cast<size_t>(K / g) * Np;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qw = static_cast<const uint32_t*>(qweight) + layer * lw;
  const auto* sc = static_cast<const __nv_bfloat16*>(scales) + layer * ls;
  const auto* zz = static_cast<const __nv_bfloat16*>(zs) + layer * ls;
  auto* o = static_cast<__nv_bfloat16*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const int MC = M <= 64 ? 1 : M <= 128 ? 2 : 4;
  const dim3 grid((M + 64 * MC - 1) / (64 * MC), Np / kGemmCols);
  const bool g64 = g % kGemmK == 0;
  int e;
  if (MC == 1)
    e = g64 ? launch_gemm<1, true>(grid, st, xb, qw, sc, zz, o, M, K, Np, g)
            : launch_gemm<1, false>(grid, st, xb, qw, sc, zz, o, M, K, Np, g);
  else if (MC == 2)
    e = g64 ? launch_gemm<2, true>(grid, st, xb, qw, sc, zz, o, M, K, Np, g)
            : launch_gemm<2, false>(grid, st, xb, qw, sc, zz, o, M, K, Np, g);
  else
    e = g64 ? launch_gemm<4, true>(grid, st, xb, qw, sc, zz, o, M, K, Np, g)
            : launch_gemm<4, false>(grid, st, xb, qw, sc, zz, o, M, K, Np, g);
  return e != 0 ? e : qllm_launch_status();
}
