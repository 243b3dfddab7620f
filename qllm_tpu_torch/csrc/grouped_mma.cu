// K8 w4_grouped_gemv (MoE decode) on the tensor-core body of
// csrc/stacked_mma.cuh.
//
// Replaces _qmm_kernel_planar_full as qmatmul_grouped_experts runs it
// (qllm_tpu/ops/pallas_qmm.py:1843, pallas_call :1914): for every
// (token, expert) selection i, y[i] = x[0 if x_shared else i] @
// dequant(W[ids[i]]) from an [E]- (or [L*E]-) stacked planar 4-bit weight
// with bf16 scales and prefolded bf16 zs = zeros * scales, all selections
// in one launch:
//   y[i, n] = bf16(sum_g (s_g[n] (x_g . q_g[:, n]) - sum(x_g) zs_g[n])),
// f32 group dots scaled at the group's end. The TPU kernel takes the ids by
// scalar prefetch into its weight index maps; here each block reads them
// itself, so they never leave the device.
//
// Bound on the H100: bytes, each expert the ids touch read once (its
// words, scales and zs). What the design does about it:
//   * Runs of equal ids as rows. Selections arrive sorted by id. The block
//     of selection i heads a run when i is the run's first selection or lies
//     a multiple of kRunRows past it; a head takes the next (up to kRunRows)
//     selections of its run as its M rows, and every other block exits at
//     once. An expert that r selections chose streams ceil(r / kRunRows)
//     times, not r times (the TPU grid skips the re-read the same way,
//     pallas_qmm.py:1865-1869). The plan comes from the ids around each
//     block, in the launch: no host read, no extra launch. A row's bits
//     depend neither on its run nor on its place in it.
//   * The body's producer warp streams the expert's word rows into a
//     shared-memory ring by bulk copies (cp.async.bulk, full / empty
//     mbarriers), while four consumer warps run mma.sync on them.
//   * K is split over gridDim.z by a count the wrapper takes from K and Np
//     alone (so that a row's bits depend neither on the selection count nor
//     on its run), sized for a few heads to fill the card in one wave; a
//     second kernel adds the splits in split order.
//
// Planar words as the A operand (the Planar policy): GptqOrder<4>::pair(s)
// of a word row r is the bf16 pair 128 + q of k (4r + j, 4r + j + 2), j =
// s / 2, of the low half of K for s even and of the high half for s odd.
// So a step runs one m16n8k16 MMA per half (pairs s = h and h + 2) into an
// accumulator set per half, with a ones-MMA per half for sum x: the low
// half's k lie in group gl and the high half's in G/2 + gl, which close at
// the same word row since (K/2) % g == 0. A lane stages x of its unit as
// [x[4r .. 4r+3] | x[K/2 + 4r .. +3]]. At a group's end, for each half,
// dot = acc - 128 sum x, y += dot * s - sum x * zs (K14's fused close).
// A step whose k hold a group's end runs once per group it touches, the
// other groups' x zeroed one value at a time (any g with (K/2) % g == 0).

#include "common.cuh"
#include "stacked_mma.cuh"

namespace {

using namespace stacked_mma;

constexpr int kRunRows = 8;     // the most selections a head takes as its rows (one n-tile of x)
constexpr int kMinBlocks = 4;   // blocks an SM the registers leave room for
constexpr int kStep = 16;       // k of each half a step covers (4 units of 4)

// bytes of a staged x row of `units` units (16 bytes each); the pad puts
// rows 2i and 2i + 1 in the two halves of the banks
__host__ __device__ inline int grouped_x_row_bytes(int units) { return (units * 16 + 127) / 128 * 128 + 64; }
// bytes of a chunk's parameter tables: scales and zs of each half, ngc groups each
__host__ __device__ inline int grouped_param_bytes(int ngc) { return 4 * ngc * kCols * 2; }

// The rows selection i takes: 0 unless it heads a run (its run's first
// selection, or a multiple of `rows` past it), else how many of its run's
// selections it takes from i on (at most `rows`, 1 <= rows <= kRunRows).
// Every warp works it out alike: the run's start is found 32 ids at a time
// by a ballot
__device__ __forceinline__ int run_rows(const int* __restrict__ ids, int n, int i, int e, int lane, int rows) {
  int start = 0;
  for (int base = i - 1; base >= 0; base -= 32) {
    const int j = base - lane;
    const unsigned diff = __ballot_sync(0xffffffffu, j >= 0 && __ldg(ids + j) != e);
    if (diff != 0u) {
      start = base - (__ffs(diff) - 1) + 1;
      break;
    }
  }
  if ((i - start) % rows != 0) return 0;
  int m = 1;
  while (m < rows && i + m < n && __ldg(ids + i + m) == e) ++m;
  return m;
}

// one block per (128 columns, selection, split of K); kc: units staged per
// chunk (a multiple of 4)
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    planar_grouped_kernel(const __nv_bfloat16* __restrict__ x,   // [n, K], or [1, K] when x_shared
                          const uint32_t* __restrict__ qw,       // [E, K/8, Np] planar words
                          const __nv_bfloat16* __restrict__ sc,  // [E, G, Np]
                          const __nv_bfloat16* __restrict__ zs,  // [E, G, Np] zeros * scales
                          const int* __restrict__ ids, int n, int n_experts, int x_shared, int K, int Np, int g,
                          int units_per_split, int kc, int run_rows_max,
                          float* __restrict__ part,             // [splits, n, Np] when split
                          __nv_bfloat16* __restrict__ out) {    // [n, Np]
  using P = Planar;
  constexpr int S = P::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sel = blockIdx.y;
  const int e = __ldg(ids + sel);
  const int M = run_rows(ids, n, sel, e, lane, run_rows_max);
  if (M == 0) return;  // not a head: uniform across the block
  const int n0 = blockIdx.x * kCols;
  const int Kh = K / 2, W = K / 8, G = K / g, Gh = G / 2;
  const int u0 = blockIdx.z * units_per_split, u1 = min(W, u0 + units_per_split);
  float* prt = part != nullptr ? part + (static_cast<size_t>(blockIdx.z) * n + sel) * Np : nullptr;
  __nv_bfloat16* o = out + static_cast<size_t>(sel) * Np;
  if (e < 0 || e >= n_experts) {  // rows of NaN (uniform across the block)
    for (int i = threadIdx.x; i < M * kCols; i += blockDim.x) {
      const int m = i / kCols, col = n0 + i % kCols;
      if (col >= Np) continue;
      if (prt != nullptr)
        prt[static_cast<size_t>(m) * Np + col] = __int_as_float(0x7fc00000);
      else
        o[static_cast<size_t>(m) * Np + col] = __float2bfloat16_rn(__int_as_float(0x7fc00000));
    }
    return;
  }
  // expert e's words and parameters: 64-bit offsets (an [L*E] stack passes 2^31 words)
  qw += static_cast<size_t>(e) * W * Np;
  sc += static_cast<size_t>(e) * G * Np;
  zs += static_cast<size_t>(e) * G * Np;

  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S;
  unsigned char* ring = smem + kBarBytes;
  unsigned char* xt = ring + S * 4 * ring_row_bytes<P>();
  const int rb = grouped_x_row_bytes(kc);
  const int ngc = groups_of_chunk(4 * kc, g);
  unsigned char* pt = xt + M * rb;  // [half][scales, zs][ngc][kCols] bf16

  init_ring<S>(full, empty, 1);
  if (warp == kWarps) {
    produce<P>(qw, full, empty, ring, lane, n0, Np, u0, u1, W, 1);
    return;
  }

  const int gq = lane >> 2, c = lane & 3;
  const int lcol = warp * 32 + 4 * gq;  // the lane's first column in the block
  const int h0 = 4 * u0, h1 = 4 * u1;   // the split's k in each half

  // x of units [c0, c1) into the tile (zero past c1 up to a whole step),
  // and the scales and zs of every group the chunk touches, in both halves
  auto stage_chunk = [&](int c0, int c1) {
    const int gf = 4 * c0 / g, ng = (4 * c1 - 1) / g - gf + 1;
    stage_params(pt, sc, zs, 2, ngc, gf, ng, n0, Np, 2, 1);
    stage_params(param_row(pt, 2, ngc, 0, 0, 2), sc, zs, 2, ngc, Gh + gf, ng, n0, Np, 2, 1);
    const int U = (c1 - c0 + 3) / 4 * 4;
    for (int i = threadIdx.x; i < M * 2 * U; i += kThreads) {
      const int m = i / (2 * U), r = i - m * 2 * U;
      const int ul = r >> 1, half = r & 1, u = c0 + ul;
      const bool on = u < c1;
      const __nv_bfloat16* src =
          on ? x + static_cast<size_t>(x_shared ? 0 : sel + m) * K + half * Kh + 4 * u : x;
      cp_async8(xt + m * rb + ul * 16 + 8 * half, src, on);
    }
    cp_async_commit();
    cp_async_wait<0>();
    consumers_sync();
  };

  // acc[half]: sum (128 + q) x of the open group; xs[half]: sum x (the
  // ones MMA); y: the closed groups. Registers as the body's: y[pr][e] is
  // column lcol + 2pr + (e >> 1), row 2c + (e & 1)
  float acc[2][2][4], xs[2][4], y[2][4];
#pragma unroll
  for (int e4 = 0; e4 < 4; ++e4) {
    y[0][e4] = y[1][e4] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) acc[h][0][e4] = acc[h][1][e4] = xs[h][e4] = 0.f;
  }

  // one step's products of this lane's unit ul (at k kunit of each half);
  // masked: only the k in [lo, hi) of each half
  auto compute = [&](const uint32_t (&w)[1][4], int ul, int kunit, int lo, int hi, bool masked) {
    const uint4 v = gq < M ? *reinterpret_cast<const uint4*>(xt + gq * rb + ul * 16) : make_uint4(0u, 0u, 0u, 0u);
    uint32_t m0 = 0xFFFFFFFFu, m1 = 0xFFFFFFFFu;  // B lanes (k0, k2) and (k1, k3)
    if (masked) {
      auto in = [&](int j) { return kunit + j >= lo && kunit + j < hi; };
      m0 = (in(0) ? 0x0000FFFFu : 0u) | (in(2) ? 0xFFFF0000u : 0u);
      m1 = (in(1) ? 0x0000FFFFu : 0u) | (in(3) ? 0xFFFF0000u : 0u);
    }
    const uint32_t none[2] = {0u, 0u};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t a01 = h ? v.z : v.x, a23 = h ? v.w : v.y;  // x (k0, k1), (k2, k3) of half h
      const uint32_t b0 = __byte_perm(a01, a23, 0x5410) & m0, b1 = __byte_perm(a01, a23, 0x7632) & m1;
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        // A rows gq / gq + 8: columns 2pr / 2pr + 1; k slots 2c.. pair h, 2c + 8.. pair h + 2
        const uint32_t a0 = GptqOrder<4>::pair(w, none, 2 * pr, h, 0);
        const uint32_t a1 = GptqOrder<4>::pair(w, none, 2 * pr + 1, h, 0);
        const uint32_t a2 = GptqOrder<4>::pair(w, none, 2 * pr, h + 2, 0);
        const uint32_t a3 = GptqOrder<4>::pair(w, none, 2 * pr + 1, h + 2, 0);
        mma_bf16_16816(acc[h][pr], a0, a1, a2, a3, b0, b1);
      }
      mma_bf16_16816(xs[h], kOnes, kOnes, kOnes, kOnes, b0, b1);
    }
  };

  // close the open group of each half (the low half's row `row` of the
  // chunk's tables; the high half's, Gh groups on, row `row` of tables 2, 3)
  auto close = [&](int row) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned char* srow = param_row(pt, 2 * h, ngc, row, lcol, 2);
      const unsigned char* zrow = param_row(pt, 2 * h + 1, ngc, row, lcol, 2);
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = 2 * pr + half;
          const float s = param_at(srow, 2, col), z = param_at(zrow, 2, col);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e4 = 2 * half + r;
            const float dot = fmaf(-128.f, xs[h][r], acc[h][pr][e4]);
            y[pr][e4] = fmaf(-xs[h][r], z, fmaf(dot, s, y[pr][e4]));
            acc[h][pr][e4] = 0.f;
          }
        }
      }
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) xs[h][e4] = 0.f;
    }
  };

  // the body's walk on the k of each half (4 a unit), chunks of kc units
  walk_split<P>(full, empty, ring, c, lcol, lane, h0, h1, 4 * kc, kStep, 4, g,
                [&](int ch0, int ch1) { stage_chunk(ch0 / 4, ch1 / 4); }, compute, close);

  const int ncol = n0 + lcol;
  if (ncol >= Np) return;  // Np % 4 == 0: a lane's four columns are in range or not
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = 2 * c + r;
    if (m >= M) continue;
    const float v[4] = {y[0][r], y[0][2 + r], y[1][r], y[1][2 + r]};
    if (prt != nullptr)
      *reinterpret_cast<float4*>(prt + static_cast<size_t>(m) * Np + ncol) = make_float4(v[0], v[1], v[2], v[3]);
    else
      *reinterpret_cast<uint2*>(o + static_cast<size_t>(m) * Np + ncol) =
          make_uint2(bf16x2_bits(__floats2bfloat162_rn(v[0], v[1])), bf16x2_bits(__floats2bfloat162_rn(v[2], v[3])));
  }
}

}  // namespace

// K8: x [n, K] bf16 (or [1, K] with x_shared) against the experts ids[i]
// of the stack qweight [E, K/8, Np], scales / zs [E, G, Np] bf16 -> bf16
// [n, Np]; an id outside [0, E) gives a row of NaN. splits: blocks along
// K, each units_per_split word rows; when split, `part` holds splits * n *
// Np floats. run_rows: the most selections of a run a head takes (kRunRows;
// 1 serves every selection on its own, with the same bits)
QLLM_API int qllm_w4_grouped_gemv(const void* x, const void* qweight, const void* scales, const void* zs,
                                  const void* ids, void* part, void* out, int n, int n_experts, int x_shared, int K,
                                  int Np, int g, int splits, int units_per_split, int run_rows, void* stream) {
  const int W = K / 8;
  // the planar geometry (csrc/planar_gemv.cuh planar_geometry_ok)
  if (n < 1 || n > 65535 || n_experts < 1 || K % 128 != 0 || K >= (1 << 17) || g < 1 || (K / 2) % g != 0 ||
      Np < 32 || Np % 32 != 0 || splits < 1 || splits > 65535 || units_per_split < 1 || run_rows < 1 ||
      run_rows > kRunRows ||
      static_cast<long long>(splits) * units_per_split < W || static_cast<long long>(splits - 1) * units_per_split >= W ||
      (splits > 1 && part == nullptr) || !stacked_mma::aligned16(x) || !stacked_mma::aligned16(qweight) ||
      !stacked_mma::aligned16(scales) || !stacked_mma::aligned16(zs))
    return static_cast<int>(cudaErrorInvalidValue);
  // the chunk of a split that a block stages at once: its x rows (up to
  // run_rows) and both halves' parameters within the body's budget
  const int rows = n < run_rows ? n : run_rows;
  int kc = (units_per_split + 3) / 4 * 4;
  auto chunk = [&](int k) { return rows * grouped_x_row_bytes(k) + grouped_param_bytes(stacked_mma::groups_of_chunk(4 * k, g)); };
  while (kc > 4 && chunk(kc) > stacked_mma::kXBudget) kc -= 4;
  const int smem = stacked_mma::ring_bytes<stacked_mma::Planar>() + chunk(kc);
  static int allowed[kMaxDevices];
  const int e = allow_dynamic_smem(planar_grouped_kernel, smem, allowed);
  if (e != 0) return e;
  const auto st = static_cast<cudaStream_t>(stream);
  float* p = splits > 1 ? static_cast<float*>(part) : nullptr;
  const dim3 grid((Np + stacked_mma::kCols - 1) / stacked_mma::kCols, n, splits);
  planar_grouped_kernel<<<grid, stacked_mma::kBlock, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(qweight),
      static_cast<const __nv_bfloat16*>(scales), static_cast<const __nv_bfloat16*>(zs), static_cast<const int*>(ids),
      n, n_experts, x_shared, K, Np, g, units_per_split, kc, run_rows, p, static_cast<__nv_bfloat16*>(out));
  if (splits > 1) {
    const int MN = n * Np;
    split_sum_out_kernel<<<(MN + 255) / 256, 256, 0, st>>>(p, splits, MN, 1, out);
  }
  return qllm_launch_status();
}
