// K13 stream_pass: the streaming microbench's read-only pass (the
// counterpart of _stream_kernel, qllm_tpu/ops/stream_bench.py:26, as
// stream_pass_seconds drives it, :54). It reads every word of one layer
// of an [L, K/8, N] int32 stack and reduces it to per-column sums, so no
// read can be dropped; nothing is dequantized or multiplied. The time of
// a pass is the card's practical streaming rate for the serving
// kernels' weights, the ceiling decode is judged against.
//
// Bound on the H100: bytes (the layer's words, read once). Design: a
// block covers 128 columns (a warp reads 512 contiguous bytes of a row,
// 16 bytes a lane) over one chunk of rows, its 8 warps taking every 8th
// row of the chunk; the warps' sums meet in shared memory and one lane
// per 4 columns adds them to the output with integer atomics (exact and
// order-free: sums modulo 2^32). The chunks are sized so that the grid
// is one full wave of resident blocks (8 a SM): every SM streams the same
// share. One entry point runs `passes` passes, the layer cycling from
// `layer` so that L2 does not serve a pass from the last one; the output
// is zeroed once and holds the sum over all of them.

#include "common.cuh"

namespace {

constexpr int kStreamThreads = 256;
constexpr int kStreamWarps = kStreamThreads / 32;
constexpr int kStreamBlocksPerSm = 8;

__global__ void __launch_bounds__(kStreamThreads)
    stream_pass_kernel(const int4* __restrict__ qw,  // [rows, N/4] one layer
                       int rows, int N4, int rows_per_chunk, int* __restrict__ out) {
  __shared__ int4 part[kStreamWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(rows, r0 + rows_per_chunk);
  int4 acc = make_int4(0, 0, 0, 0);
  if (j < N4) {
#pragma unroll 4
    for (int r = r0 + warp; r < r1; r += kStreamWarps) {
      const int4 v = __ldcs(qw + static_cast<size_t>(r) * N4 + j);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp != 0 || j >= N4) return;
#pragma unroll
  for (int w = 1; w < kStreamWarps; ++w) {
    const int4 p = part[w][lane];
    acc.x += p.x;
    acc.y += p.y;
    acc.z += p.z;
    acc.w += p.w;
  }
  atomicAdd(out + 4 * j, acc.x);
  atomicAdd(out + 4 * j + 1, acc.y);
  atomicAdd(out + 4 * j + 2, acc.z);
  atomicAdd(out + 4 * j + 3, acc.w);
}

}  // namespace

QLLM_API int qllm_stream_pass(const void* qweight, void* out, int L, int rows, int N, int layer, int passes,
                              void* stream) {
  if (L < 1 || rows < 1 || N < 4 || N % 4 != 0 || layer < 0 || layer >= L || passes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(out, 0, static_cast<size_t>(N) * sizeof(int), st);
  const int N4 = N / 4;
  const int col_blocks = (N4 + 31) / 32;
  // row chunks: one wave of resident blocks, at least 8 rows (one a warp) each
  const int chunks = max(1, min((rows + kStreamWarps - 1) / kStreamWarps, sms * kStreamBlocksPerSm / col_blocks));
  const int rows_per_chunk = (rows + chunks - 1) / chunks;
  const dim3 grid(col_blocks, (rows + rows_per_chunk - 1) / rows_per_chunk);
  const size_t layer_words = static_cast<size_t>(rows) * N;
  for (int i = 0; i < passes; ++i) {
    const auto* q = static_cast<const int*>(qweight) + static_cast<size_t>((layer + i) % L) * layer_words;
    stream_pass_kernel<<<grid, kStreamThreads, 0, st>>>(reinterpret_cast<const int4*>(q), rows, N4, rows_per_chunk,
                                                         static_cast<int*>(out));
  }
  return qllm_launch_status();
}
