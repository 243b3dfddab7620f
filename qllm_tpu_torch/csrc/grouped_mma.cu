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
// The consumers are the body's planar consumer (stacked_mma.cuh
// planar_consume; K1's and K17's too), fused, one n-tile of rows.

#include "common.cuh"
#include "stacked_mma.cuh"

using namespace stacked_mma;

namespace {

constexpr int kRunRows = 8;     // the most selections a head takes as its rows (one n-tile of x)
constexpr int kMinBlocks = 4;   // blocks an SM the registers leave room for

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
  const int W = K / 8, G = K / g;
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
  init_ring<S>(full, empty, false);
  if (warp == kWarps) {
    produce<P>(qw, full, empty, ring, lane, n0, Np, u0, u1, W, kCopyLanes);
    return;
  }
  planar_consume<1, kXBf16, true>(full, empty, ring, ring + S * 4 * ring_row_bytes<P>(),
                                  x + (x_shared ? 0 : static_cast<size_t>(sel) * K), x_shared ? 0 : K, nullptr, sc, zs,
                                  M, K, Np, g, n0, u0, u1, kc, prt, o);
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
  if (n < 1 || n > 65535 || n_experts < 1 || !planar_geometry_ok(K, g) || Np < 32 || Np % 32 != 0 ||
      !split_plan_ok(K / 8, splits, units_per_split) || run_rows < 1 || run_rows > kRunRows ||
      (splits > 1 && part == nullptr) || !aligned16(x) || !aligned16(qweight) || !aligned16(scales) || !aligned16(zs))
    return static_cast<int>(cudaErrorInvalidValue);
  // the chunk of a split that a block stages at once: its x rows (up to
  // run_rows) and both halves' parameters within the body's budget
  const int rows = n < run_rows ? n : run_rows;
  const int kc = planar_chunk_units(rows, units_per_split, g, 2, 2, false);
  const int smem = ring_bytes<Planar>() + planar_chunk_bytes(rows, kc, g, 2, 2, false);
  static int allowed[kMaxDevices];
  const int e = allow_dynamic_smem(planar_grouped_kernel, smem, allowed);
  if (e != 0) return e;
  const auto st = static_cast<cudaStream_t>(stream);
  float* p = splits > 1 ? static_cast<float*>(part) : nullptr;
  const dim3 grid((Np + kCols - 1) / kCols, n, splits);
  planar_grouped_kernel<<<grid, kBlock, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(qweight),
      static_cast<const __nv_bfloat16*>(scales), static_cast<const __nv_bfloat16*>(zs), static_cast<const int*>(ids),
      n, n_experts, x_shared, K, Np, g, units_per_split, kc, run_rows, p, static_cast<__nv_bfloat16*>(out));
  if (splits > 1) {
    const int MN = n * Np;
    split_sum_out_kernel<<<(MN + 255) / 256, 256, 0, st>>>(p, splits, MN, 1, out);
  }
  return qllm_launch_status();
}
