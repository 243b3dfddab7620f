// K10 gptq_gemm: the per-layer quantized matmul y = x @ dequant(W) at M >
// 32 on GPTQ-order packed words (the counterpart of _qmm_2d,
// qllm_tpu/ops/pallas_qmm.py:300). Word row r of qweight [K/pf, N] (pf =
// 32 / bits, bits in {2, 4, 8}) holds k = r * pf + s at bit offset bits *
// s; scales and zeros [G, N] are read in the dtype they are stored in (0 =
// f32, 1 = fp16, 2 = bf16) and converted in registers. The output is bf16
// [M, N]. Its decode counterpart K9 gptq_gemv (M <= 32) runs the
// tensor-core body of csrc/stacked_mma.cuh (entry in gptq_stacked.cu).
//
// The kernel splits its sums without atomics: a row's result depends only
// on that row of x and the weights, never on M or on the run.

#include "wgmma.cuh"

// ---------------------------------------------------------------------------
// K10 gptq_gemm (prefill and speculative verify, M > 32).
//
// Replaces _qmm_kernel (pallas_qmm.py:119) as _qmm_2d runs it at M > 32:
// x in bf16, w = bf16(q * s) (the zero point NOT subtracted), a bf16 x
// bf16 product with f32 accumulation, then y = bf16(y1 - xsum_g @ (z*s))
// with xsum_g the f32 sums of the unrounded x over each group (:469-473).
// The kernel rounds where the TPU kernel does: the zero-point mass (~8x
// the final magnitude) stays in the f32 sums and is taken off at the end.
//
// Bound on the H100: 2*M flops per 4-bit weight (half a byte) is 4M flops
// a weight byte, so the words' bytes bound the verify shapes (M = 40) and
// the tensor-core rate bounds prefill (M = 256 and beyond: the bf16 ridge
// is ~295 flops a byte).
//
// Design (csrc/wgmma.cuh): wgmma.mma_async with the product swapped, so
// that 64 output columns are the instruction's 64 rows and the rows of x
// its width: D [64 columns, 64 x rows] += bf16(q * s) [64, 16 k] x x^T.
// A block is two warpgroups over 128 output columns and MC x 64 rows of x
// (MC = 1 at M <= 64, where rows past M are masked, else 2). Its k-tiles
// of 64 (one 128-byte x row) stream through a ring of shared-memory stages
// filled by cp.async kWgStages - 2 tiles ahead: the x tile in the 128-byte
// swizzle wgmma reads as its B operand, and the tile's word rows (GPTQ
// order: pf consecutive k of one column a word), each thread's copies
// planned once for the block. Each thread dequantizes its A registers
// (columns gq and gq + 8 of its warp, k 2c, 2c+1, 2c+8, 2c+9 of each 16-k
// step) from the staged words, q * s as one FFMA of the field OR-ed into
// 2^23 (no int-to-float conversion), with its group's scales loaded a group
// ahead (one pair a tile where g % 64 == 0): a tile's four steps at once,
// into one of two register sets while the previous tile's products (one
// group of four m64n(64 MC)k16 instructions) still run on the other. Both
// sets stay held until the wait that retires their products (keep_regs),
// so the compiler gives no other value their registers and never has to
// serialize the products.
//
// K splits into S segments of `per` tiles, S fixed by (K, N) alone. Each
// segment's dot starts a fresh accumulator and is added to the running sum
// (in shared memory: registers hold the accumulator and the two A sets) in
// segment order; where the grid is small (the verify shapes) each
// segment is a block of its own (gridDim.z = S), its sums go to a partial
// buffer and a second kernel adds them in the same order, so a row's bits
// depend on neither M nor the launch. The zero-point term is taken off in
// group order after the sum, by the same code in either launch.
// ---------------------------------------------------------------------------

namespace {

constexpr int kWgThreads = 256;  // two warpgroups
constexpr int kWgCols = 128;     // output columns of a block, 64 a warpgroup
constexpr int kWgK = 64;         // k of a stage: one 128-byte x row
constexpr int kWgStages = 6;     // the ring; copies run kWgStages - 2 tiles ahead
constexpr int kWPitch = 136;     // words of a staged word row: 128 used, rows 8 banks apart

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

struct GemmArgs {
  const __nv_bfloat16* x;  // [M, Kp] bf16, Kp = K rounded up to 64, zero-padded
  const uint32_t* qw;      // [K/pf, N]
  const void* sc;          // [G, N] scales and zeros in s_type
  const void* zr;
  const float* xsum;       // [M, G]
  float* part;             // [S, M, N] (split launches)
  __nv_bfloat16* out;      // [M, N]
  int s_type, M, K, Kp, N, g, S, per, vec;  // vec: word rows copied 16 bytes at a time
};

// (z * s)[gi, n] in f32, 0 past N
__device__ __forceinline__ float zero_scale(const void* zr, const void* sc, int s_type, int N, int gi, int n) {
  if (n >= N) return 0.f;
  const size_t at = static_cast<size_t>(gi) * N + n;
  return load_param(zr, s_type, at) * load_param(sc, s_type, at);
}

template <int BITS, int MC>
constexpr int wgmma_smem_bytes() {
  // the ring of stages, then the running sums [MC * 32][threads] of a
  // launch that walks several segments (thread-private, conflict-free)
  return kWgStages * (MC * 64 * 128 + (kWgK / (32 / BITS)) * kWPitch * 4) + MC * 32 * kWgThreads * 4 + 1024;
}

template <int BITS, int MC>
// MC = 1 (the verify shapes) fits two blocks an SM in 128 registers a thread
__global__ void __launch_bounds__(kWgThreads, MC == 1 ? 2 : 1) gptq_wgmma_kernel(const GemmArgs a) {
  constexpr int PF = 32 / BITS;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  constexpr int R = kWgK / PF;            // word rows of a stage
  constexpr int kXBytes = MC * 64 * 128;  // x bytes of a stage
  constexpr int kWWords = R * kWPitch;    // staged words of a stage
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = atom_aligned(smem_raw);
  const uint32_t xs0 = smem_u32(smem);
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem + kWgStages * kXBytes);
  float* tots = reinterpret_cast<float*>(ws + kWgStages * kWWords);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, c = lane & 3;
  const int n0 = blockIdx.x * kWgCols, m0 = blockIdx.y * 64 * MC;
  const int cl0 = 64 * (warp >> 2) + 16 * (warp & 3) + gq;  // this thread's columns cl0, cl0 + 8
  const int col0 = n0 + cl0, col1 = col0 + 8;
  const int T = a.Kp / kWgK, G = a.K / a.g, rows = a.K / PF;
  const bool split = gridDim.z > 1;  // one segment a block
  const int t_begin = split ? blockIdx.z * a.per : 0;
  const int t_end = split ? min(T, t_begin + a.per) : T;
  const bool several = !split && a.S > 1;  // running sums in shared memory

  // The copy plan, fixed for the block: x chunk `it` of a tile is row
  // (tid >> 3) + 32 it, 16-byte chunk tid & 7; word chunk `it` (16-byte
  // copies) is word row (tid >> 5) + 8 it, columns n0 + 4 (tid & 31) ..+3.
  const int xr = tid >> 3, xq = tid & 7, wr0 = tid >> 5, wq = tid & 31;
  const __nv_bfloat16* xsrc = a.x + static_cast<size_t>(m0 + xr) * a.Kp + 8 * xq;
  const uint32_t xdst = sw128_offset(xr, xq);  // + 4096 per 32 rows: the same swizzle
  unsigned xok = 0;
#pragma unroll
  for (int it = 0; it < 2 * MC; ++it) xok |= (m0 + xr + 32 * it < a.M ? 1u : 0u) << it;
  const bool wcol_ok = n0 + 4 * wq < a.N;
  const uint32_t* wsrc = a.qw + static_cast<size_t>(wr0) * a.N + n0 + 4 * wq;

  // tile t into stage st: the x tile (swizzled), then the word rows
  auto issue = [&](int t, int st) {
    const uint32_t xt = xs0 + st * kXBytes + xdst;
    const __nv_bfloat16* xs = xsrc + kWgK * t;
#pragma unroll
    for (int it = 0; it < 2 * MC; ++it) {
      const bool ok = (xok >> it) & 1u;
      cp_async16_s(xt + it * 4096, ok ? xs + static_cast<size_t>(32 * it) * a.Kp : a.x, ok);
    }
    uint32_t* wt = ws + st * kWWords;
    if (a.vec) {
      const uint32_t* wsrc_t = wsrc + static_cast<size_t>(t) * R * a.N;
#pragma unroll
      for (int it = 0; it < (R * 32 + kWgThreads - 1) / kWgThreads; ++it) {
        const int rr = wr0 + 8 * it;
        const bool ok = wcol_ok && t * R + rr < rows;
        if (rr < R) cp_async16(wt + rr * kWPitch + 4 * wq, ok ? wsrc_t + static_cast<size_t>(8 * it) * a.N : a.qw, ok);
      }
    } else {
#pragma unroll
      for (int it = 0; it < R * 128 / kWgThreads; ++it) {
        const int i = tid + it * kWgThreads, rr = i >> 7, q = i & 127, wr = t * R + rr, col = n0 + q;
        const bool ok = wr < rows && col < a.N;
        cp_async4(wt + rr * kWPitch + q, ok ? a.qw + static_cast<size_t>(wr) * a.N + col : a.qw, ok);
      }
    }
  };

  auto scale = [&](int gi, int col) {
    return col < a.N ? load_param(a.sc, a.s_type, static_cast<size_t>(gi) * a.N + col) : 0.f;
  };
  // A registers of the four 16-k steps of a tile: bf16(q * s) of columns
  // cl0 (a0, a2) and cl0 + 8 (a1, a3) at k 2c, 2c+1 (pair 0) and 2c+8,
  // 2c+9 (pair 1) of each step. Pair h of step j sits in word row (16j +
  // 8h) / pf (+ c / 2 at pf = 4) of the stage, at field shift sh[h].
  const int sh0 = BITS * ((2 * c) % PF), sh1 = BITS * ((2 * c + 8) % PF);
  const uint32_t* wcol = ws + (PF == 4 ? (c >> 1) : 0) * kWPitch + cl0;
  // q * s rounded once: with f = 2^23 + q (the field OR-ed into 2^23's
  // mantissa) and o = -2^23 s (exact), fma(f, s, o) = RN(q * s), the f32
  // product the plain version rounds to bf16
  auto pair = [&](const uint32_t* wt, int j, int h, float sa, float oa, float sb, float ob, uint32_t (&ar)[4][4]) {
    const int rr = (16 * j + 8 * h) / PF, sh = h ? sh1 : sh0;
    const uint32_t w0 = wt[rr * kWPitch], w1 = wt[rr * kWPitch + 8];
    const float f00 = __int_as_float(0x4B000000u | ((w0 >> sh) & kMask));
    const float f01 = __int_as_float(0x4B000000u | ((w0 >> (sh + BITS)) & kMask));
    const float f10 = __int_as_float(0x4B000000u | ((w1 >> sh) & kMask));
    const float f11 = __int_as_float(0x4B000000u | ((w1 >> (sh + BITS)) & kMask));
    ar[j][2 * h] = bf16x2_bits(__floats2bfloat162_rn(fmaf(f00, sa, oa), fmaf(f01, sa, oa)));
    ar[j][2 * h + 1] = bf16x2_bits(__floats2bfloat162_rn(fmaf(f10, sb, ob), fmaf(f11, sb, ob)));
  };

  // g % 64 == 0: a tile lies in one group; its two scales are loaded a
  // group ahead and taken when the tile starts a group (uniform)
  const bool tile_group = a.g % kWgK == 0;
  int tg = -2, tg_end = 0;
  float ts0 = 0.f, ts1 = 0.f, tn0 = 0.f, tn1 = 0.f;
  auto build_tile = [&](int st, int t, uint32_t (&ar)[4][4]) {
    if (kWgK * t >= tg_end) {
      const int gi = min(kWgK * t / a.g, G - 1);  // padded k past K stay in the last group
      if (gi == tg + 1) {
        ts0 = tn0;
        ts1 = tn1;
      } else {
        ts0 = scale(gi, col0);
        ts1 = scale(gi, col1);
      }
      tg = gi;
      tg_end = gi == G - 1 ? 0x7fffffff : (gi + 1) * a.g;
      if (gi + 1 < G) {
        tn0 = scale(gi + 1, col0);
        tn1 = scale(gi + 1, col1);
      }
    }
    const uint32_t* wt = wcol + st * kWWords;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) pair(wt, j, h, ts0, -8388608.f * ts0, ts1, -8388608.f * ts1, ar);
  };
  // any other g (a multiple of pf): each pair's group, its scales reloaded
  // when k passes the group's end (and loaded a group ahead)
  int cg[2] = {-2, -2}, g_end[2] = {0, 0};
  float s0[2] = {0.f, 0.f}, s1[2] = {0.f, 0.f}, n0s[2] = {0.f, 0.f}, n1s[2] = {0.f, 0.f};
  auto build_pairs = [&](int st, int t, uint32_t (&ar)[4][4]) {
    const uint32_t* wt = wcol + st * kWWords;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = kWgK * t + 16 * j + 2 * c + 8 * h;
        if (k >= g_end[h]) {
          const int gi = min(k / a.g, G - 1);
          if (gi == cg[h] + 1) {
            s0[h] = n0s[h];
            s1[h] = n1s[h];
          } else {
            s0[h] = scale(gi, col0);
            s1[h] = scale(gi, col1);
          }
          cg[h] = gi;
          g_end[h] = gi == G - 1 ? 0x7fffffff : (gi + 1) * a.g;
          if (gi + 1 < G) {
            n0s[h] = scale(gi + 1, col0);
            n1s[h] = scale(gi + 1, col1);
          }
        }
        pair(wt, j, h, s0[h], -8388608.f * s0[h], s1[h], -8388608.f * s1[h], ar);
      }
  };
  auto build = [&](int st, int t, uint32_t (&ar)[4][4]) {
    if (tile_group)
      build_tile(st, t, ar);
    else
      build_pairs(st, t, ar);
  };

  float acc[MC][32];
#pragma unroll
  for (int mc = 0; mc < MC; ++mc)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mc][i] = 0.f;

  // tile t: wait for its copies, refill the ring, build its A registers
  // (ar: one of two sets, while the previous tile's products still read
  // the other, prev) and issue its four products as one group; fresh: the
  // first tile of a segment starts a fresh accumulator
  auto tile = [&](int t, bool fresh, uint32_t (&ar)[4][4], uint32_t (&prev)[4][4]) {
    const int u = t - t_begin, st = u % kWgStages;
    cp_async_wait<kWgStages - 3>();  // this thread's copies of tile t landed
    fence_proxy_async();
    // everyone's did, and every warpgroup has waited for tile t - 2's
    // products (wait<1> after tile t - 1's): its stage and A set are free
    __syncthreads();
    if (t + kWgStages - 2 < t_end) issue(t + kWgStages - 2, (u + kWgStages - 2) % kWgStages);
    cp_async_commit();
    build(st, t, ar);
    // every A register is written before the fence, none between the products
    keep_regs(ar);
    wgmma_fence();
    const uint64_t desc = sw128_desc(xs0 + st * kXBytes);  // + 2 per 16-k step: 32 bytes
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_rs<MC>(acc, ar[j], desc + 2 * j, (fresh && j == 0) ? 0 : 1);
    wgmma_commit();
    wgmma_wait<1>();
    // the previous tile's products are done: only now may its A set be
    // written (kept live until here, so no build reuses its registers)
    keep_regs(prev);
  };

#pragma unroll
  for (int i = 0; i < kWgStages - 2; ++i) {
    if (t_begin + i < t_end) issue(t_begin + i, i);
    cp_async_commit();
  }
  uint32_t ar0[4][4] = {}, ar1[4][4] = {};
  for (int s0t = t_begin; s0t < t_end; s0t += a.per) {  // one segment, then its sum in order
    const int s1t = min(t_end, s0t + a.per);
    for (int t = s0t; t < s1t; t += 2) {
      tile(t, t == s0t, ar0, ar1);
      if (t + 1 < s1t) tile(t + 1, false, ar1, ar0);
    }
    if (several) {  // running sum += the segment, from 0 as the split launch's sum kernel
      wgmma_wait<0>();
#pragma unroll
      for (int mc = 0; mc < MC; ++mc) {
        fence_regs(acc[mc]);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float* p = tots + (mc * 32 + i) * kWgThreads + tid;
          *p = (s0t == t_begin ? 0.f : *p) + acc[mc][i];
        }
      }
    }
  }
  cp_async_wait<0>();
  wgmma_wait<0>();
#pragma unroll
  for (int mc = 0; mc < MC; ++mc) {
    fence_regs(acc[mc]);
    if (several)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[mc][i] = tots[(mc * 32 + i) * kWgThreads + tid];
  }

  // D element 4i + e: column cl0 + 8 (e >> 1), x row 8i + 2c + (e & 1) of the chunk
  if (split) {
    float* p = a.part + static_cast<size_t>(blockIdx.z) * a.M * a.N;
#pragma unroll
    for (int mc = 0; mc < MC; ++mc)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + 64 * mc + 8 * i + 2 * c + (e & 1), n = (e >> 1) ? col1 : col0;
          if (m < a.M && n < a.N) p[static_cast<size_t>(m) * a.N + n] = acc[mc][4 * i + e];
        }
    return;
  }
  // y = sum - sum_g xsum[m, g] * (z * s)[g, n] in group order, then bf16
  for (int gi = 0; gi < G; ++gi) {
    const float z0 = zero_scale(a.zr, a.sc, a.s_type, a.N, gi, col0);
    const float z1 = zero_scale(a.zr, a.sc, a.s_type, a.N, gi, col1);
#pragma unroll
    for (int mc = 0; mc < MC; ++mc)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + 64 * mc + 8 * i + 2 * c;
        const float xa = m < a.M ? __ldg(a.xsum + static_cast<size_t>(m) * G + gi) : 0.f;
        const float xb = m + 1 < a.M ? __ldg(a.xsum + static_cast<size_t>(m + 1) * G + gi) : 0.f;
        acc[mc][4 * i + 0] = fmaf(-xa, z0, acc[mc][4 * i + 0]);
        acc[mc][4 * i + 1] = fmaf(-xb, z0, acc[mc][4 * i + 1]);
        acc[mc][4 * i + 2] = fmaf(-xa, z1, acc[mc][4 * i + 2]);
        acc[mc][4 * i + 3] = fmaf(-xb, z1, acc[mc][4 * i + 3]);
      }
  }
#pragma unroll
  for (int mc = 0; mc < MC; ++mc)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 64 * mc + 8 * i + 2 * c + (e & 1), n = (e >> 1) ? col1 : col0;
        if (m < a.M && n < a.N) a.out[static_cast<size_t>(m) * a.N + n] = __float2bfloat16_rn(acc[mc][4 * i + e]);
      }
}

// a split launch's sum: the segments' partials in segment order, then the
// zero-point term in group order (the arithmetic of the kernel above). A
// thread takes one column and kSumRows rows, so each (z * s) is loaded
// once for its rows and the partials' loads are coalesced along the columns.
constexpr int kSumRows = 8;
__global__ void gptq_split_sum_kernel(const GemmArgs a) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x, m0 = blockIdx.y * kSumRows;
  if (n >= a.N) return;
  const size_t MN = static_cast<size_t>(a.M) * a.N;
  const int G = a.K / a.g, rows = min(kSumRows, a.M - m0);
  float acc[kSumRows];
#pragma unroll
  for (int r = 0; r < kSumRows; ++r) {
    acc[r] = 0.f;
    if (r < rows)
      for (int s = 0; s < a.S; ++s) acc[r] += a.part[s * MN + static_cast<size_t>(m0 + r) * a.N + n];
  }
  // unrolled so that later groups' loads are in flight (the sums keep group order)
#pragma unroll 8
  for (int gi = 0; gi < G; ++gi) {
    const float zs = zero_scale(a.zr, a.sc, a.s_type, a.N, gi, n);
#pragma unroll
    for (int r = 0; r < kSumRows; ++r)
      if (r < rows) acc[r] = fmaf(-__ldg(a.xsum + static_cast<size_t>(m0 + r) * G + gi), zs, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < kSumRows; ++r)
    if (r < rows) a.out[static_cast<size_t>(m0 + r) * a.N + n] = __float2bfloat16_rn(acc[r]);
}

template <int BITS, int MC>
int launch_wgmma(const GemmArgs& a, dim3 grid, cudaStream_t st) {
  constexpr int bytes = wgmma_smem_bytes<BITS, MC>();
  static int allowed[kMaxDevices];
  if (const int e = allow_dynamic_smem(gptq_wgmma_kernel<BITS, MC>, bytes, allowed)) return e;
  gptq_wgmma_kernel<BITS, MC><<<grid, kWgThreads, bytes, st>>>(a);
  return 0;
}

template <int BITS>
int launch_wgmma_bits(const GemmArgs& a, int MC, dim3 grid, cudaStream_t st) {
  return MC == 1 ? launch_wgmma<BITS, 1>(a, grid, st) : launch_wgmma<BITS, 2>(a, grid, st);
}

}  // namespace

// x_mma: x in bf16 [M, Kp] (the MMA operand, zero-padded to Kp = K rounded
// up to 64); x / x_f32: x as the caller holds it [M, K] (the group sums
// read it unrounded); xsum: scratch of M * (K / g) floats. K splits into
// `splits` segments of `per` 64-k tiles; split_launch runs one block a
// segment into `part` (splits * M * N floats) and sums after; vec: the
// word rows start 16-byte aligned (N % 4 == 0 and an aligned qweight).
QLLM_API int qllm_gptq_gemm(const void* x_mma, int Kp, const void* x, int x_f32, const void* qweight,
                            const void* scales, const void* zeros, int s_type, void* xsum, void* part, void* out,
                            int bits, int M, int K, int N, int g, int splits, int per, int split_launch, int vec,
                            void* stream) {
  const int pf = bits > 0 ? 32 / bits : 0;
  const int T = Kp / kWgK;
  if ((bits != 2 && bits != 4 && bits != 8) || M < 1 || M > 65535 * 64 || N < 1 || K < 1 || K % pf != 0 ||
      g < pf || g % pf != 0 || K % g != 0 || Kp % kWgK != 0 || Kp < K || Kp >= K + kWgK || splits < 1 ||
      splits > 65535 || per < 1 || static_cast<long long>(splits) * per < T || (splits - 1) * per >= T ||
      (split_launch && (splits < 2 || part == nullptr || (M + kSumRows - 1) / kSumRows > 65535)) || s_type < 0 ||
      s_type > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const long long entries = static_cast<long long>(M) * (K / g);
  group_sum_kernel<<<static_cast<unsigned>((entries + 7) / 8), 256, 0, st>>>(x, x_f32, M, K, g,
                                                                            static_cast<float*>(xsum));
  GemmArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x_mma);
  a.qw = static_cast<const uint32_t*>(qweight);
  a.sc = scales;
  a.zr = zeros;
  a.xsum = static_cast<const float*>(xsum);
  a.part = static_cast<float*>(part);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.s_type = s_type;
  a.M = M;
  a.K = K;
  a.Kp = Kp;
  a.N = N;
  a.g = g;
  a.S = splits;
  a.per = per;
  a.vec = vec;
  const int MC = M <= 64 ? 1 : 2;
  const dim3 grid((N + kWgCols - 1) / kWgCols, (M + 64 * MC - 1) / (64 * MC), split_launch ? splits : 1);
  int e = bits == 2 ? launch_wgmma_bits<2>(a, MC, grid, st)
                    : bits == 4 ? launch_wgmma_bits<4>(a, MC, grid, st) : launch_wgmma_bits<8>(a, MC, grid, st);
  if (e != 0) return e;
  if (split_launch) {
    const dim3 sum_grid((N + 127) / 128, (M + kSumRows - 1) / kSumRows);
    gptq_split_sum_kernel<<<sum_grid, 128, 0, st>>>(a);
  }
  return qllm_launch_status();
}
