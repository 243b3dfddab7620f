// K19 w4_grouped_fused_mlp and K20 w4_pnp_gemv: two W4 products with a
// serial dependency between them, each pair in ONE cooperative launch.
//
// K19 replaces _qmm_kernel_grouped_fused (qllm_tpu/ops/pallas_qmm.py:2239,
// called by qmatmul_grouped_experts_fused :2363): for every MoE selection
// i with e = ids[i],
//   gu = x_i @ GU[e] (f32), a = act(gu[:, :K2]) * gu[:, K2:2K2] (f32),
//   y_i = a @ DN[e] -> bf16,
// a single token's whole expert MLP (Qwen3-30B-A3B at batch 1: 8
// selections, K1 = 2048, K2 = 768).
//
// K20 replaces _qmm_kernel_pnp (:1950, called by qmatmul_pnp_stacked
// :2109): hn = h + x1 @ W1[layer] (f32), y2 = rmsnorm(hn) @ W2[layer] ->
// (hn f32, y2 bf16), o_proj, the residual, the post-attention RMSNorm and
// gate|up of a decode step.
//
// Every product is the planar full-K per-group product of the TPU
// kernels (fullk, :1976-2006): y[m,n] = sum_g (x_g . q_g[:,n]) * s_g[n] -
// (sum x_g) * zs_g[n] in f32, bf16 scales and prefolded zs. The second
// product of each pair reads an f32 row (the activation, the normalised
// residual) that the TPU kernels keep in VMEM and never round to bf16;
// here it lives in a scratch in device memory, read through L2.
//
// The TPU kernel walks its grid in order on one core, so phase 2 simply
// follows phase 1. On the H100 the blocks run in parallel, so each kernel
// is a cooperative launch (every block co-resident, or the launch is
// refused) whose phases meet at grid-wide barriers (one arrival count in
// device memory, left ready for the next launch; no atomics in any sum:
// the same inputs give the same bits).
//
// Both run on the tensor-core body (csrc/stacked_mma.cuh, planar_consume):
// persistent blocks, each a producer warp that streams the words of its
// items into the shared-memory ring and four consumer warps on mma.sync.
// The producer's running stage count carries the ring from item to item
// and from phase to phase, so it streams the next phase's words while the
// consumers wait at a barrier. Every split of K comes from the shapes
// alone, and every sum runs in a fixed order, so a row's bits depend
// neither on the other rows nor on the grid.
//
// K19, an item one selection (e = ids[sel], one x row):
//   phase 1: gate|up's (selection, 128 of its 2 K2 columns, split of K1)
//            items on bf16 x, each split's f32 partial sums to scratch;
//   barrier; merge, by (selection, 128 columns of K2): gate and up = their
//            splits in split order, a = act(gate) * up in f32, written as
//            three exact bf16 parts planar-interleaved;
//   barrier; phase 2: down's (selection, 128 columns, split of K2) items
//            on a's parts (kXRows3: the parts as B rows 0-2 of one MMA),
//            the splits' partial sums to scratch (unsplit: bf16 straight
//            out);
//   barrier; out = bf16(the splits in split order).
// An id outside [0, E): producer and consumers skip the selection's items
// alike (the ring's parities stay matched), and its row is NaN. Bound:
// bytes (the selected experts' words, scales and zs, read once), 19 MB at
// Qwen3-30B-A3B batch 1 (5.7 us at 3.35 TB/s).
//
// K20, an item up to 8 rows (one n-tile):
//   phase 1: o_proj's (row chunk, 128 columns, split of K1) items on bf16
//            x1 (exact in bf16), each split's f32 partial sums to scratch;
//   barrier; merge, by (row, 128 columns) over the grid: hn = (the splits
//            in split order) + h, written out; x~ = hn * w (f32) as three
//            exact bf16 parts hi + mid + lo, stored planar-interleaved; sum
//            hn^2 of each (row, tile) in a fixed order;
//   barrier; r_m = rsqrt(sum of the tiles' sums / D + eps), each block;
//   phase 2: gate|up's items on x~ (kXParts3: three MMAs on each A), the
//            splits' partial sums to scratch (unsplit: bf16(r_m y) straight
//            out);
//   barrier; y2 = bf16(r_m * the splits in split order).
// The splits of K1 and D are ops.qmm.planar_splits. Bound: bytes (both layers'
// words, scales and zs, read once), 57 MB at the 7B (17 us at 3.35 TB/s).
#include <algorithm>

#include "common.cuh"
#include "stacked_mma.cuh"

namespace {

// the gate activation of _qmm_kernel_grouped_fused (:2297-2308): silu, or
// gelu in its tanh form
__device__ __forceinline__ float gate_act(float gt, int gelu) {
  if (gelu) return 0.5f * gt * (1.0f + tanhf(0.7978845608f * (gt + 0.044715f * gt * gt * gt)));
  return gt * (1.0f / (1.0f + expf(-gt)));
}

// Every block of the (cooperative, hence co-resident) grid waits at its
// barrier j until all have arrived; sync() joins the block's threads that
// take part (thread 0 among them). bar is one 64-bit arrival count, never
// reset, that every launch leaves at a multiple of kBarStride: thread 0
// arrives by one acquire-release add, takes the launch's base from its
// first arrival, and polls with acquire loads until barrier j's (j + 1) *
// gridDim.x arrivals have landed (the last to arrive does not wait); the
// last arrival at the launch's final barrier rounds the count up to the
// next multiple for the next launch. Writes before the barrier are visible
// after it; what another block wrote is read through L2 (__ldcg,
// cp.async.cg).
constexpr unsigned long long kBarStride = 1ull << 16;  // more than a launch's arrivals: 3 barriers of <= 2^14 blocks

template <class Sync>
__device__ void grid_barrier(unsigned* bar, unsigned long long& base, int j, bool last, Sync sync) {
  sync();
  if (threadIdx.x == 0) {
    unsigned long long* word = reinterpret_cast<unsigned long long*>(bar);
    unsigned long long old;
    asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], 1;" : "=l"(old) : "l"(word) : "memory");
    if (j == 0) base = old & ~(kBarStride - 1);
    const unsigned long long target = base + static_cast<unsigned long long>(j + 1) * gridDim.x;
    if (old + 1 == target) {
      if (last) asm volatile("red.relaxed.gpu.global.add.u64 [%0], %1;" ::"l"(word), "l"(base + kBarStride - target)
                              : "memory");
    } else {
      unsigned spins = 0;
      while (true) {
        unsigned long long now;
        asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(now) : "l"(word) : "memory");
        if (now >= target) break;
        __nanosleep(64);
        if (++spins > (1u << 28)) __trap();  // a lost block: fail, never hang
      }
    }
  }
  sync();
}

namespace sm = stacked_mma;

constexpr int kPnpRows = 8;  // the rows of x an item takes: one n-tile (K20)
// the x rows and parameters a chunk may stage: with the ring, four blocks an SM
constexpr int kCoopXBudget = 38 * 1024;

// K19: the stacks' pointers (expert e at e * its size); part1, a3, part2
// as the C entry's
__global__ void __launch_bounds__(sm::kBlock, 4)
    fused_mlp_kernel(const __nv_bfloat16* __restrict__ x,    // [n or 1, K1]
                     const uint32_t* __restrict__ gqw,       // [E, K1/8, Np1]
                     const __nv_bfloat16* __restrict__ gsc, const __nv_bfloat16* __restrict__ gzs,  // [E, G1, Np1]
                     const uint32_t* __restrict__ dqw,       // [E, K2/8, Np2]
                     const __nv_bfloat16* __restrict__ dsc, const __nv_bfloat16* __restrict__ dzs,  // [E, G2, Np2]
                     const int* __restrict__ ids,            // [n]
                     float* part1, __nv_bfloat16* a3, float* part2, unsigned* bar,
                     __nv_bfloat16* __restrict__ out,        // [n, Np2]
                     int n, int n_experts, int x_shared, int K1, int K2, int Np1, int Np2, int g, int splits1,
                     int per1, int splits2, int per2, int kc1, int kc2, int gelu) {
  constexpr int S = sm::Planar::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S;
  unsigned char* ring = smem + sm::kBarBytes;
  unsigned char* xt = ring + S * 4 * sm::ring_row_bytes<sm::Planar>();
  const int T1 = 2 * K2 / sm::kCols, T2 = (Np2 + sm::kCols - 1) / sm::kCols, W1 = K1 / 8, W2 = K2 / 8;
  const int items1 = n * T1 * splits1, items2 = n * T2 * splits2;
  const size_t E1 = static_cast<size_t>(W1) * Np1, E2 = static_cast<size_t>(W2) * Np2;  // words an expert
  const size_t P1 = static_cast<size_t>(K1 / g) * Np1, P2 = static_cast<size_t>(K2 / g) * Np2;  // parameters
  auto expert = [&](int sel) {  // ids[sel], or -1 outside [0, E)
    const int e = __ldg(ids + sel);
    return e >= 0 && e < n_experts ? e : -1;
  };
  // item i of a phase: selection i % n, columns of tile (i / n) % T, split i / (n T)
  sm::init_ring<S>(full, empty, false);
  if ((threadIdx.x >> 5) == sm::kWarps) {  // the producer: phase 1's items, then phase 2's, without a stop
    const int lane = threadIdx.x & 31;
    int t = 0;
    for (int i = blockIdx.x; i < items1; i += gridDim.x) {
      const int e = expert(i % n), ct = i / n % T1, u0 = i / (n * T1) * per1;
      if (e < 0) continue;
      t = sm::produce<sm::Planar>(gqw + e * E1, full, empty, ring, lane, ct * sm::kCols, Np1, u0, min(W1, u0 + per1),
                                  W1, sm::kCopyLanes, t);
    }
    for (int i = blockIdx.x; i < items2; i += gridDim.x) {
      const int e = expert(i % n), ct = i / n % T2, u0 = i / (n * T2) * per2;
      if (e < 0) continue;
      t = sm::produce<sm::Planar>(dqw + e * E2, full, empty, ring, lane, ct * sm::kCols, Np2, u0, min(W2, u0 + per2),
                                  W2, sm::kCopyLanes, t);
    }
    return;
  }
  const int tid = threadIdx.x;
  const auto sync = [] { sm::consumers_sync(); };
  const size_t gu_n = static_cast<size_t>(n) * 2 * K2;  // a split's partial sums
  int t = 0;
  unsigned long long base = 0;  // thread 0's: the launch's first arrival count
  // phase 1: gate|up of the selection's row, each split's partial sums [n, 2 K2]
  for (int i = blockIdx.x; i < items1; i += gridDim.x) {
    const int sel = i % n, e = expert(sel), ct = i / n % T1, s = i / (n * T1), u0 = s * per1;
    if (e < 0) continue;
    sync();  // the last item's tile is read
    t = sm::planar_consume<1, sm::kXBf16, true>(
        full, empty, ring, xt, x + (x_shared ? 0 : static_cast<size_t>(sel) * K1), K1, nullptr, gsc + e * P1,
        gzs + e * P1, 1, K1, Np1, g, ct * sm::kCols, u0, min(W1, u0 + per1), kc1,
        part1 + s * gu_n + static_cast<size_t>(sel) * 2 * K2, nullptr, nullptr, t);
  }
  grid_barrier(bar, base, 0, false, sync);
  // merge, item (selection, tile ct of K2): column c = ct * 128 + tid; gate
  // and up the splits in split order, a = act(gate) * up as hi, mid, lo
  // (each difference exact in f32) at the planar-interleaved place of k =
  // c in rows 3 sel .. 3 sel + 2
  const int TK = K2 / sm::kCols;
  for (int i = blockIdx.x; i < n * TK; i += gridDim.x) {
    const int sel = i / TK, c = (i - sel * TK) * sm::kCols + tid;
    if (expert(sel) < 0) continue;
    const float* pg = part1 + static_cast<size_t>(sel) * 2 * K2 + c;
    float gt = 0.f, up = 0.f;
    for (int s = 0; s < splits1; ++s) {
      gt += __ldcg(pg + s * gu_n);
      up += __ldcg(pg + s * gu_n + K2);
    }
    const int half = c >= K2 / 2, k = c - half * (K2 / 2);
    __nv_bfloat16* ar = a3 + static_cast<size_t>(3 * sel) * K2 + (k / 4) * 8 + 4 * half + (k & 3);
    float p = gate_act(gt, gelu) * up;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const __nv_bfloat16 b = __float2bfloat16_rn(p);
      ar[static_cast<size_t>(q) * K2] = b;
      p -= __bfloat162float(b);
    }
  }
  grid_barrier(bar, base, 1, splits2 == 1, sync);
  // phase 2: down on a's parts
  const size_t y_n = static_cast<size_t>(n) * Np2;
  for (int i = blockIdx.x; i < items2; i += gridDim.x) {
    const int sel = i % n, e = expert(sel), ct = i / n % T2, s = i / (n * T2), u0 = s * per2;
    __nv_bfloat16* orow = out + static_cast<size_t>(sel) * Np2;
    if (e < 0) {  // unsplit, this is the row's only writer (split: the sum below)
      const int c = ct * sm::kCols + tid;
      if (splits2 == 1 && c < Np2) orow[c] = __float2bfloat16_rn(__int_as_float(0x7fc00000));
      continue;
    }
    sync();
    t = sm::planar_consume<1, sm::kXRows3, true>(
        full, empty, ring, xt, a3 + static_cast<size_t>(3 * sel) * K2, K2, nullptr, dsc + e * P2, dzs + e * P2, 1, K2,
        Np2, g, ct * sm::kCols, u0, min(W2, u0 + per2), kc2,
        splits2 > 1 ? part2 + s * y_n + static_cast<size_t>(sel) * Np2 : nullptr, orow, nullptr, t);
  }
  if (splits2 == 1) return;
  grid_barrier(bar, base, 2, true, sync);
  // out = bf16(the splits in split order), NaN for an id outside the stack
  for (size_t i = static_cast<size_t>(blockIdx.x) * sm::kThreads + tid; i < y_n;
       i += static_cast<size_t>(gridDim.x) * sm::kThreads) {
    float acc = 0.f;
    for (int s = 0; s < splits2; ++s) acc += __ldcg(part2 + s * y_n + i);
    out[i] = __float2bfloat16_rn(expert(static_cast<int>(i / Np2)) < 0 ? __int_as_float(0x7fc00000) : acc);
  }
}

// K20: one layer's pointers; hn, part1, x3, sq, part2 as the C entry's
__global__ void __launch_bounds__(sm::kBlock, 4)
    pnp_kernel(const __nv_bfloat16* __restrict__ x1,  // [M, K1]
               const float* __restrict__ h,           // [M, D]
               const void* __restrict__ nw, int nw_f32,  // [D] the norm weight
               const uint32_t* __restrict__ w1,       // [K1/8, D]
               const __nv_bfloat16* __restrict__ s1, const __nv_bfloat16* __restrict__ z1,  // [G1, D]
               const uint32_t* __restrict__ w2,       // [D/8, Np2]
               const __nv_bfloat16* __restrict__ s2, const __nv_bfloat16* __restrict__ z2,  // [G2, Np2]
               float* hn, float* part1, __nv_bfloat16* x3, float* sq, float* part2, unsigned* bar,
               __nv_bfloat16* __restrict__ y2, int M, int K1, int D, int Np2, int g1, int g2, int splits1,
               int per1, int splits2, int per2, int kc1, int kc2, float eps) {
  constexpr int S = sm::Planar::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[sm::kWarps];  // a merge's sum of squares by warp
  __shared__ float rr[32];           // the rows' norm factors
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S;
  unsigned char* ring = smem + sm::kBarBytes;
  unsigned char* xt = ring + S * 4 * sm::ring_row_bytes<sm::Planar>();
  const int chunks = (M + kPnpRows - 1) / kPnpRows;
  const int T1 = D / sm::kCols, T2 = (Np2 + sm::kCols - 1) / sm::kCols, W1 = K1 / 8, W2 = D / 8;
  const int items1 = chunks * T1 * splits1, items2 = chunks * T2 * splits2;
  // item i of a phase: rows of chunk i % chunks, columns of tile (i /
  // chunks) % T, split i / (chunks T)
  sm::init_ring<S>(full, empty, false);
  if ((threadIdx.x >> 5) == sm::kWarps) {  // the producer: phase 1's items, then phase 2's, without a stop
    const int lane = threadIdx.x & 31;
    int t = 0;
    for (int i = blockIdx.x; i < items1; i += gridDim.x) {
      const int ct = i / chunks % T1, u0 = i / (chunks * T1) * per1;
      t = sm::produce<sm::Planar>(w1, full, empty, ring, lane, ct * sm::kCols, D, u0, min(W1, u0 + per1), W1,
                                  sm::kCopyLanes, t);
    }
    for (int i = blockIdx.x; i < items2; i += gridDim.x) {
      const int ct = i / chunks % T2, u0 = i / (chunks * T2) * per2;
      t = sm::produce<sm::Planar>(w2, full, empty, ring, lane, ct * sm::kCols, Np2, u0, min(W2, u0 + per2), W2,
                                  sm::kCopyLanes, t);
    }
    return;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const auto sync = [] { sm::consumers_sync(); };
  int t = 0;
  unsigned long long base = 0;  // thread 0's: the launch's first arrival count
  // phase 1: o_proj, each split's partial sums
  for (int i = blockIdx.x; i < items1; i += gridDim.x) {
    const int m0 = i % chunks * kPnpRows, ct = i / chunks % T1, s = i / (chunks * T1), u0 = s * per1;
    sync();  // the last item's tile is read
    t = sm::planar_consume<1, sm::kXBf16, true>(full, empty, ring, xt, x1 + static_cast<size_t>(m0) * K1, K1,
                                                nullptr, s1, z1, min(kPnpRows, M - m0), K1, D, g1, ct * sm::kCols, u0,
                                                min(W1, u0 + per1), kc1,
                                                part1 + (static_cast<size_t>(s) * M + m0) * D, nullptr, nullptr, t);
  }
  grid_barrier(bar, base, 0, false, sync);
  // merge, item (row m, tile ct): columns n = ct * 128 + tid of row m; hn =
  // the splits in split order + h; x~ = hn * w as hi, mid, lo (each
  // difference exact in f32) at the planar-interleaved place of k = n in
  // rows 3m .. 3m + 2; the row's sum of squares over the tile
  for (int i = blockIdx.x; i < M * T1; i += gridDim.x) {
    const int m = i / T1, ct = i - m * T1, n = ct * sm::kCols + tid;
    float acc = 0.f;
    for (int s = 0; s < splits1; ++s) acc += __ldcg(part1 + (static_cast<size_t>(s) * M + m) * D + n);
    const float v = acc + __ldg(h + static_cast<size_t>(m) * D + n);
    hn[static_cast<size_t>(m) * D + n] = v;
    const float w = nw_f32 ? __ldg(static_cast<const float*>(nw) + n)
                           : __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(nw) + n));
    const int half = n >= D / 2, k = n - half * (D / 2);
    __nv_bfloat16* xr = x3 + static_cast<size_t>(3 * m) * D + (k / 4) * 8 + 4 * half + (k & 3);
    float p = v * w;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const __nv_bfloat16 b = __float2bfloat16_rn(p);
      xr[static_cast<size_t>(q) * D] = b;
      p -= __bfloat162float(b);
    }
    const float ss = warp_sum(v * v);
    if (lane == 0) red[warp] = ss;
    sync();
    if (tid == 0) sq[static_cast<size_t>(m) * T1 + ct] = ((red[0] + red[1]) + red[2]) + red[3];
    sync();
  }
  grid_barrier(bar, base, 1, splits2 == 1, sync);
  if (tid < M) {  // read after the next sync
    float q = 0.f;
    for (int ct = 0; ct < T1; ++ct) q += __ldcg(sq + static_cast<size_t>(tid) * T1 + ct);
    rr[tid] = rsqrtf(q * (1.0f / static_cast<float>(D)) + eps);
  }
  // phase 2: gate|up on x~'s parts
  for (int i = blockIdx.x; i < items2; i += gridDim.x) {
    const int m0 = i % chunks * kPnpRows, ct = i / chunks % T2, s = i / (chunks * T2), u0 = s * per2;
    sync();
    t = sm::planar_consume<1, sm::kXParts3, true>(
        full, empty, ring, xt, x3 + static_cast<size_t>(3 * m0) * D, D, nullptr, s2, z2, min(kPnpRows, M - m0), D,
        Np2, g2, ct * sm::kCols, u0, min(W2, u0 + per2), kc2,
        splits2 > 1 ? part2 + (static_cast<size_t>(s) * M + m0) * Np2 : nullptr, y2 + static_cast<size_t>(m0) * Np2,
        rr + m0, t);
  }
  if (splits2 == 1) return;
  grid_barrier(bar, base, 2, true, sync);
  // y2 = bf16(r_m * the splits in split order)
  const size_t MN = static_cast<size_t>(M) * Np2;
  for (size_t i = static_cast<size_t>(blockIdx.x) * sm::kThreads + tid; i < MN;
       i += static_cast<size_t>(gridDim.x) * sm::kThreads) {
    float acc = 0.f;
    for (int s = 0; s < splits2; ++s) acc += __ldcg(part2 + s * MN + i);
    y2[i] = __float2bfloat16_rn(acc * rr[i / Np2]);
  }
}

// the grid of a cooperative launch: one block per work item, at most as
// many as fit on the card at once; 0 where the card takes no cooperative launch
int coop_grid(const void* kernel, int items, int threads, int smem) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) != cudaSuccess)
    return 0;
  if (!coop || per_sm < 1) return 0;
  return std::max(1, std::min({items, per_sm * sms, static_cast<int>(kBarStride / 4)}));
}

}  // namespace

// K19: ids [n] int32; scratch part1 [splits1, n, 2 K2] f32, a3 [n, 3, K2]
// bf16 and, when splits2 > 1, part2 [splits2, n, Np2] f32; K1 split in
// splits1 of per1 word rows, K2 in splits2 of per2; bar: the grid
// barriers' arrival count (64 bits)
QLLM_API int qllm_w4_grouped_fused_mlp(const void* x, const void* gqw, const void* gsc, const void* gzs, const void* dqw,
                                       const void* dsc, const void* dzs, const void* ids, void* part1, void* a3,
                                       void* part2, void* bar, void* out, int n, int n_experts, int x_shared, int K1,
                                       int K2, int Np1, int Np2, int g, int splits1, int per1, int splits2, int per2,
                                       int gelu, void* stream) {
  using sm::aligned16;
  if (n < 1 || n > 65535 || n_experts < 1 || !planar_geometry_ok(K1, g) || !planar_geometry_ok(K2, g) ||
      Np1 < 2 * K2 || Np1 % 4 || Np2 % 4 || Np2 < 4 || !sm::split_plan_ok(K1 / 8, splits1, per1) ||
      !sm::split_plan_ok(K2 / 8, splits2, per2) || (splits2 > 1 && part2 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(x) || !aligned16(gqw) || !aligned16(gsc) || !aligned16(gzs) || !aligned16(dqw) || !aligned16(dsc) ||
      !aligned16(dzs) || !aligned16(part1) || !aligned16(a3) || (part2 != nullptr && !aligned16(part2)))
    return static_cast<int>(cudaErrorInvalidValue);
  int kc1 = sm::planar_chunk_units(1, per1, g, 2, 2, false, kCoopXBudget);
  int kc2 = sm::planar_chunk_units(3, per2, g, 2, 2, false, kCoopXBudget);
  const int smem = sm::ring_bytes<sm::Planar>() + std::max(sm::planar_chunk_bytes(1, kc1, g, 2, 2, false),
                                                           sm::planar_chunk_bytes(3, kc2, g, 2, 2, false));
  static int allowed[kMaxDevices];
  if (const int e = allow_dynamic_smem(fused_mlp_kernel, smem, allowed)) return e;
  const int items = n * std::max({2 * K2 / sm::kCols * splits1, (Np2 + sm::kCols - 1) / sm::kCols * splits2,
                                  K2 / sm::kCols});
  const void* kernel = (const void*)fused_mlp_kernel;
  const int grid = coop_grid(kernel, items, sm::kBlock, smem);
  if (grid < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&x, &gqw, &gsc, &gzs, &dqw, &dsc, &dzs, &ids, &part1, &a3, &part2, &bar, &out, &n, &n_experts,
                  &x_shared, &K1, &K2, &Np1, &Np2, &g, &splits1, &per1, &splits2, &per2, &kc1, &kc2, &gelu};
  const cudaError_t err =
      cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(sm::kBlock), args, smem, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? static_cast<int>(err) : qllm_launch_status();
}

// K20: layer `layer` of the stacks; hn [M, D] and y2 [M, Np2] the outputs;
// scratch part1 [splits1, M, D] f32, x3 [M, 3, D] bf16, sq [M, D / 128]
// f32 and, when splits2 > 1, part2 [splits2, M, Np2] f32; K1 split in
// splits1 of per1 word rows, D in splits2 of per2; bar: the grid barriers'
// arrival count (64 bits)
QLLM_API int qllm_w4_pnp_gemv(const void* x1, const void* h, const void* nw, int nw_f32, const void* qw1,
                              const void* s1, const void* z1, const void* qw2, const void* s2, const void* z2, void* hn,
                              void* part1, void* x3, void* sq, void* part2, void* bar, void* y2, int layer, int M,
                              int K1, int D, int Np2, int g1, int g2, int splits1, int per1, int splits2, int per2,
                              float eps, void* stream) {
  using sm::aligned16;
  if (M < 1 || M > 32 || layer < 0 || !planar_geometry_ok(K1, g1) || !planar_geometry_ok(D, g2) || Np2 % 4 ||
      Np2 < 4 || !sm::split_plan_ok(K1 / 8, splits1, per1) || !sm::split_plan_ok(D / 8, splits2, per2) ||
      (splits2 > 1 && part2 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t l = static_cast<size_t>(layer), G1 = K1 / g1, G2 = D / g2;
  const auto* w1 = static_cast<const uint32_t*>(qw1) + l * (K1 / 8) * D;
  const auto* sc1 = static_cast<const __nv_bfloat16*>(s1) + l * G1 * D;
  const auto* zs1 = static_cast<const __nv_bfloat16*>(z1) + l * G1 * D;
  const auto* w2 = static_cast<const uint32_t*>(qw2) + l * (D / 8) * Np2;
  const auto* sc2 = static_cast<const __nv_bfloat16*>(s2) + l * G2 * Np2;
  const auto* zs2 = static_cast<const __nv_bfloat16*>(z2) + l * G2 * Np2;
  const void* nwl = static_cast<const char*>(nw) + l * D * (nw_f32 ? 4 : 2);
  if (!aligned16(x1) || !aligned16(w1) || !aligned16(sc1) || !aligned16(zs1) || !aligned16(w2) || !aligned16(sc2) ||
      !aligned16(zs2) || !aligned16(part1) || !aligned16(x3) || (part2 != nullptr && !aligned16(part2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = std::min(M, kPnpRows);
  int kc1 = sm::planar_chunk_units(rows, per1, g1, 2, 2, false, kCoopXBudget);
  int kc2 = sm::planar_chunk_units(3 * rows, per2, g2, 2, 2, false, kCoopXBudget);
  const int smem = sm::ring_bytes<sm::Planar>() + std::max(sm::planar_chunk_bytes(rows, kc1, g1, 2, 2, false),
                                                           sm::planar_chunk_bytes(3 * rows, kc2, g2, 2, 2, false));
  static int allowed[kMaxDevices];
  if (const int e = allow_dynamic_smem(pnp_kernel, smem, allowed)) return e;
  const int chunks = (M + kPnpRows - 1) / kPnpRows;
  const int items = std::max(chunks * (D / sm::kCols) * splits1, chunks * ((Np2 + sm::kCols - 1) / sm::kCols) * splits2);
  const void* kernel = (const void*)pnp_kernel;
  const int grid = coop_grid(kernel, items, sm::kBlock, smem);
  if (grid < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&x1, &h, &nwl, &nw_f32, &w1, &sc1, &zs1, &w2, &sc2, &zs2, &hn, &part1, &x3, &sq, &part2, &bar, &y2,
                  &M, &K1, &D, &Np2, &g1, &g2, &splits1, &per1, &splits2, &per2, &kc1, &kc2, &eps};
  const cudaError_t err =
      cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(sm::kBlock), args, smem, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? static_cast<int>(err) : qllm_launch_status();
}
