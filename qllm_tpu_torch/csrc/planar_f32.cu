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
// so each group's dot runs on the tensor cores (K17: mma.sync m16n8k16,
// K18: wgmma; bf16 -> f32) into an f32 fragment of its own; at the
// group's end that partial is multiplied by the f32 scale and added into
// the accumulator.
// The weight is never rounded to bf16 and the scale never enters the
// product (K2's dequantize-then-one-big-dot is #2's rounding, not #3's).
//
// Planar contract (qllm_tpu/quant/qtensor.py:157-161): word r, byte j
// holds k = 4r+j in its low nibble and k = K/2+4r+j in its high nibble.
// A k-tile t is 4 word rows: the low nibbles are k = 16t..16t+15 of the
// low half of K, the high nibbles the same k of the high half.
//
// K17 runs on the tensor-core body of csrc/stacked_mma.cuh with its
// planar consumer (K1's and K8's), unfused: f32 scales, no zero-point
// term, f32 out. K is split over gridDim.z by a count the wrapper takes
// from K and Np alone, so a row's bits never depend on M, and a second
// kernel adds the splits in split order. Bound on the H100: bytes (the
// layer's words and f32 scales read once).

#include "stacked_mma.cuh"
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// K18 w4_planar_f32s_gemm (prefill, M > 32).
//
// Bound on the H100: at M = 1024, 2*M*K*N flops against K*N/2 weight
// bytes: the bf16 tensor-core rate.
//
// Design (csrc/wgmma.cuh): wgmma.mma_async with the product swapped, as in
// K10 (csrc/gptq_mm.cu): 64 output columns are the instruction's rows and
// the rows of x its width, A = the exact bf16 nibbles from registers, B =
// the x tile in 128-byte-swizzled shared memory. A block is two
// warpgroups over 128 output columns and MC x 64 rows of x (MC = 1 at M
// <= 64). The low-half and high-half groups of a word have scales of their
// own, so the block walks K twice: the low nibbles of the word rows
// against the low half of x, then the high nibbles against the high half
// (the second pass reads the words from L2). A stage holds 64 k of one
// half: the x tile and 16 word rows, in a ring filled by cp.async
// kF32sStages - 2 stages ahead. Thread (gq, c) of warp w takes columns gq
// and gq + 8 of its 16 and, for the 16-k step j, k 2c, 2c+1 (word row 4j +
// c/2, bytes 2(c&1) and 2(c&1)+1) and the same + 8 (two rows further).
//
// A stage's four 16-k steps are built at once, into one of two register
// sets while the previous stage's products still read the other (both held
// until the wait that retires their products: keep_regs), and issued as
// one group of m64n(64 MC)k16 instructions. Each group's dot
// accumulates into a partial fragment that starts fresh (scale-d 0) at the
// group's first step; at the group's end the partial is promoted into the
// accumulator with the f32 scales, acc += partial * s, as fp8 GEMMs
// promote theirs; the two warpgroups wait for their own products, so one
// promotes while the other's run. With g % 16 == 0 the groups close every
// g / 16 steps in order over both halves (counted, no divisions), and each
// group's f32 scales are loaded a group ahead. A group that closes inside
// a 16-k step (g % 16 != 0) runs the step once per group it touches, the
// A values of the other groups zeroed one bf16 half at a time: any g.
// ---------------------------------------------------------------------------

constexpr int kF32sThreads = 256;  // two warpgroups
constexpr int kF32sCols = 128;     // output columns of a block
constexpr int kF32sK = 64;         // k of one half a stage
constexpr int kF32sRows = 16;      // word rows a stage (4 k of each half a row)
constexpr int kF32sStages = 5;     // the ring; copies run kF32sStages - 2 stages ahead
constexpr int kF32sPitch = 136;    // words of a staged word row: 128 used, rows 8 banks apart

template <int MC>
constexpr int f32s_smem_bytes() {
  return kF32sStages * (MC * 64 * 128 + kF32sRows * kF32sPitch * 4) + 1024;
}

template <int MC>
__global__ void __launch_bounds__(kF32sThreads, 1)
    f32s_wgmma_kernel(const __nv_bfloat16* __restrict__ x,  // [M, K]
                      const uint32_t* __restrict__ qw,      // [K/8, Np] this layer
                      const float* __restrict__ sc,         // [G, Np] this layer
                      float* __restrict__ out,              // [M, Np]
                      int M, int K, int Np, int g) {
  constexpr int kXBytes = MC * 64 * 128;
  constexpr int kWWords = kF32sRows * kF32sPitch;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = atom_aligned(smem_raw);
  const uint32_t xs0 = smem_u32(smem);
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem + kF32sStages * kXBytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, c = lane & 3;
  const int m0 = blockIdx.x * 64 * MC, n0 = blockIdx.y * kF32sCols;
  const int cl0 = 64 * (warp >> 2) + 16 * (warp & 3) + gq;  // this thread's columns cl0, cl0 + 8
  const int Kh = K / 2, Th = Kh / kF32sK, U = 2 * Th, Gh = Kh / g;
  // bytes 2(c&1), 2(c&1)+1 of a word into bytes 0 and 2
  const uint32_t sel = (c & 1) ? 0x4342u : 0x4140u;

  // The copy plan, fixed for the block: x chunk `it` of a stage is row
  // (tid >> 3) + 32 it, 16-byte chunk tid & 7; word chunk `it` is word row
  // (tid >> 5) + 8 it, columns n0 + 4 (tid & 31) ..+3.
  const int xr = tid >> 3, xq = tid & 7;
  const __nv_bfloat16* xsrc = x + static_cast<size_t>(m0 + xr) * K + 8 * xq;
  const uint32_t xdst = sw128_offset(xr, xq);  // + 4096 per 32 rows: the same swizzle
  unsigned xok = 0;
#pragma unroll
  for (int it = 0; it < 2 * MC; ++it) xok |= (m0 + xr + 32 * it < M ? 1u : 0u) << it;
  const uint32_t* wsrc = qw + static_cast<size_t>(tid >> 5) * Np + n0 + 4 * (tid & 31);
  const int wdst = (tid >> 5) * kF32sPitch + 4 * (tid & 31);

  // stage (h, t) of the walk (half h, its 64-k tile t) into ring slot st
  auto issue = [&](int h, int t, int st) {
    const uint32_t xt = xs0 + st * kXBytes + xdst;
    const __nv_bfloat16* xs = xsrc + h * Kh + kF32sK * t;
#pragma unroll
    for (int it = 0; it < 2 * MC; ++it) {
      const bool ok = (xok >> it) & 1u;
      cp_async16_s(xt + it * 4096, ok ? xs + static_cast<size_t>(32 * it) * K : x, ok);
    }
    uint32_t* wt = ws + st * kWWords + wdst;
    const uint32_t* wg = wsrc + static_cast<size_t>(kF32sRows * t) * Np;
#pragma unroll
    for (int it = 0; it < kF32sRows * 32 / kF32sThreads; ++it)
      cp_async16(wt + 8 * it * kF32sPitch, wg + static_cast<size_t>(8 * it) * Np, true);
  };

  float acc[MC][32], part[MC][32];
#pragma unroll
  for (int mc = 0; mc < MC; ++mc)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mc][i] = part[mc][i] = 0.f;
  int fresh = 1;  // the next product starts a group's partial

  // acc += partial * s with the f32 scales s0, s1 of its two columns
  auto promote = [&](float s0, float s1) {
    wgmma_wait<0>();
#pragma unroll
    for (int mc = 0; mc < MC; ++mc) {
      fence_regs(part[mc]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[mc][4 * i + 0] = fmaf(part[mc][4 * i + 0], s0, acc[mc][4 * i + 0]);
        acc[mc][4 * i + 1] = fmaf(part[mc][4 * i + 1], s0, acc[mc][4 * i + 1]);
        acc[mc][4 * i + 2] = fmaf(part[mc][4 * i + 2], s1, acc[mc][4 * i + 2]);
        acc[mc][4 * i + 3] = fmaf(part[mc][4 * i + 3], s1, acc[mc][4 * i + 3]);
      }
    }
    fresh = 1;
  };
  auto scale = [&](int grp, int col) { return __ldg(sc + static_cast<size_t>(grp) * Np + n0 + col); };
  // g % 16 == 0: groups close at step ends, every g / 16 steps, in order
  // over both halves (K/2 % g == 0); the next group's scales are loaded a
  // group ahead
  const int steps_per_group = g / 16;
  int left = steps_per_group, grp = 0;
  float ns0 = 0.f, ns1 = 0.f;
  if (g % 16 == 0) {
    ns0 = scale(0, cl0);
    ns1 = scale(0, cl0 + 8);
  }

  // A registers of the four 16-k steps of a stage (words wt, half h):
  // exact bf16 nibbles of columns cl0 (a0, a2) and cl0 + 8 (a1, a3)
  auto build = [&](const uint32_t* wt, int h, uint32_t (&ar)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r0 = (4 * j + (c >> 1)) * kF32sPitch + cl0, r1 = r0 + 2 * kF32sPitch;
      ar[j][0] = nibbles_bf16x2(__byte_perm(wt[r0], 0u, sel), 4 * h);
      ar[j][1] = nibbles_bf16x2(__byte_perm(wt[r0 + 8], 0u, sel), 4 * h);
      ar[j][2] = nibbles_bf16x2(__byte_perm(wt[r1], 0u, sel), 4 * h);
      ar[j][3] = nibbles_bf16x2(__byte_perm(wt[r1 + 8], 0u, sel), 4 * h);
    }
  };

  // the walk's position (half h, tile t, ring slot st) and the refill's,
  // kF32sStages - 2 stages ahead
  int h = 0, t = 0, st = 0, ih = 0, itl = 0, ist = 0;
  auto advance = [&](int& hh, int& tt, int& ss) {
    if (++tt == Th) {
      tt = 0;
      ++hh;
    }
    if (++ss == kF32sStages) ss = 0;
  };
  // stage u: wait for its copies, refill the ring, build its A registers
  // (ar: one of two sets, while the previous stage's products still read
  // the other, prev), then its products
  auto stage = [&](int u, uint32_t (&ar)[4][4], uint32_t (&prev)[4][4]) {
    cp_async_wait<kF32sStages - 3>();  // this thread's copies of stage u landed
    fence_proxy_async();
    // everyone's did, and every warpgroup has waited for stage u - 2's
    // products (wait<1> after stage u - 1's): its slot and A set are free
    __syncthreads();
    if (u + kF32sStages - 2 < U) {
      issue(ih, itl, ist);
      advance(ih, itl, ist);
    }
    cp_async_commit();
    build(ws + st * kWWords, h, ar);
    const uint32_t xt = xs0 + st * kXBytes;
    const uint64_t desc = sw128_desc(xt);  // + 2 per 16-k step: 32 bytes
    if (g % 16 == 0) {  // uniform across the block
      // every A register is written before the fence, none between the products
      keep_regs(ar);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wgmma_rs<MC>(part, ar[j], desc + 2 * j, fresh ? 0 : 1);
        fresh = 0;
        if (--left == 0) {  // the group closes with this step
          wgmma_commit();
          const float s0 = ns0, s1 = ns1;
          if (++grp < 2 * Gh) {
            ns0 = scale(grp, cl0);
            ns1 = scale(grp, cl0 + 8);
          }
          promote(s0, s1);
          left = steps_per_group;
          wgmma_fence();
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
      // the previous stage's products are done: only now may its A set be
      // written (kept live until here, so no build reuses its registers)
      keep_regs(prev);
    } else {
      // a group closes inside a step: one product per group the step
      // touches, the other groups' pairs zeroed
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kh = kF32sK * t + 16 * j;
        const int g_first = kh / g, g_last = (kh + 15) / g;
        for (int gi = g_first; gi <= g_last; ++gi) {
          // a pair's halves are k and k + 1 (lower k in the lower half);
          // group gi holds k in [gi g, gi g + g)
          const int glo = gi * g;
          auto half_mask = [&](int k) {
            const int e = k - glo;
            return (e >= 0 && e < g ? 0x0000FFFFu : 0u) | (e + 1 >= 0 && e + 1 < g ? 0xFFFF0000u : 0u);
          };
          const uint32_t m0v = half_mask(kh + 2 * c), m1v = half_mask(kh + 2 * c + 8);
          const uint32_t am[4] = {ar[j][0] & m0v, ar[j][1] & m0v, ar[j][2] & m1v, ar[j][3] & m1v};
          wgmma_fence();
          wgmma_rs<MC>(part, am, desc + 2 * j, fresh ? 0 : 1);
          fresh = 0;
          wgmma_commit();
          if ((gi + 1) * g <= kh + 16)
            promote(scale(h * Gh + gi, cl0), scale(h * Gh + gi, cl0 + 8));
          else
            wgmma_wait<0>();
        }
      }
    }
    advance(h, t, st);
  };

#pragma unroll
  for (int i = 0; i < kF32sStages - 2; ++i) {
    if (i < U) {
      issue(ih, itl, ist);
      advance(ih, itl, ist);
    }
    cp_async_commit();
  }
  uint32_t ar0[4][4] = {}, ar1[4][4] = {};
  for (int u = 0; u < U; u += 2) {
    stage(u, ar0, ar1);
    if (u + 1 < U) stage(u + 1, ar1, ar0);
  }
  cp_async_wait<0>();
  wgmma_wait<0>();

  // D element 4i + e: column cl0 + 8 (e >> 1), x row 8i + 2c + (e & 1) of the chunk
#pragma unroll
  for (int mc = 0; mc < MC; ++mc)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 64 * mc + 8 * i + 2 * c + (e & 1);
        if (m < M) out[static_cast<size_t>(m) * Np + n0 + cl0 + 8 * (e >> 1)] = acc[mc][4 * i + e];
      }
}

template <int MC>
int launch_f32s_wgmma(dim3 grid, cudaStream_t st, const __nv_bfloat16* x, const uint32_t* qw, const float* sc,
                      float* out, int M, int K, int Np, int g) {
  constexpr int bytes = f32s_smem_bytes<MC>();
  static int allowed[kMaxDevices];
  if (const int e = allow_dynamic_smem(f32s_wgmma_kernel<MC>, bytes, allowed)) return e;
  f32s_wgmma_kernel<MC><<<grid, kF32sThreads, bytes, st>>>(x, qw, sc, out, M, K, Np, g);
  return 0;
}

}  // namespace

// splits: blocks along K, each units_per_split word rows; part: splits * M
// * Np floats when K is split
QLLM_API int qllm_w4_planar_f32s_gemv(const void* x, const void* qweight, const void* scales, void* part, void* out,
                                      int layer, int M, int K, int Np, int g, int splits, int units_per_split,
                                      void* stream) {
  using stacked_mma::aligned16;
  if (M < 1 || M > 32 || !planar_geometry_ok(K, g) || Np < 32 || Np % 32 != 0 ||
      !stacked_mma::split_plan_ok(K / 8, splits, units_per_split) || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qw = static_cast<const uint32_t*>(qweight) + layer * (static_cast<size_t>(K / 8) * Np);
  const auto* sc = static_cast<const float*>(scales) + layer * (static_cast<size_t>(K / g) * Np);
  if (!aligned16(x) || !aligned16(qw) || !aligned16(sc)) return static_cast<int>(cudaErrorInvalidValue);
  return stacked_mma::run_planar<false>(static_cast<const __nv_bfloat16*>(x), qw, sc, nullptr, nullptr, 0, 0.f,
                                        static_cast<float*>(part), out, M, K, Np, g, splits, units_per_split,
                                        static_cast<cudaStream_t>(stream));
}

QLLM_API int qllm_w4_planar_f32s_gemm(const void* x, const void* qweight, const void* scales, void* out,
                                      int layer, int M, int K, int Np, int g, void* stream) {
  if (M < 1 || !planar_geometry_ok(K, g) || Np % kF32sCols != 0 || Np / kF32sCols > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t lw = static_cast<size_t>(K / 8) * Np;
  const size_t ls = static_cast<size_t>(K / g) * Np;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qw = static_cast<const uint32_t*>(qweight) + layer * lw;
  const auto* sc = static_cast<const float*>(scales) + layer * ls;
  auto* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const int MC = M <= 64 ? 1 : 2;
  const dim3 grid((M + 64 * MC - 1) / (64 * MC), Np / kF32sCols);
  const int e = MC == 1 ? launch_f32s_wgmma<1>(grid, st, xb, qw, sc, o, M, K, Np, g)
                        : launch_f32s_wgmma<2>(grid, st, xb, qw, sc, o, M, K, Np, g);
  return e != 0 ? e : qllm_launch_status();
}
