// K4 planarize_w4: GPTQ-order 4-bit words -> planar words, bit-exact.
//
// Replaces the TPU kernel _repack_kernel / planarize_packed_pallas
// (qllm_tpu/ops/pallas_repack.py:47, :108). Source word i holds k =
// 8i..8i+7 in nibbles 0..7; planar word j holds k = 4j+b in the low
// nibble of byte b and k = K/2+4j+b in the high nibble. Viewing the
// source as [E, 2, K/16, N] (low and high half of K), planar row 2m
// takes nibbles 0-3 of rows m and K/16+m, row 2m+1 nibbles 4-7.
//
// Bound on the H100: bytes (one read and one write of the packed words,
// a few integer ops per word). One thread per (e, m, n) output pair;
// neighbouring threads touch neighbouring n, so every load and store is
// a coalesced 128-byte line per warp. Runs once per stacked tensor at
// load time.

#include "common.cuh"

__device__ __forceinline__ uint32_t deposit4(uint32_t x16) {
  // spread the 4 nibbles of the low 16 bits into the low nibble of
  // each byte
  return (x16 & 0xFu) | ((x16 & 0xF0u) << 4) | ((x16 & 0xF00u) << 8) | ((x16 & 0xF000u) << 12);
}

__global__ void planarize_w4_kernel(const uint32_t* __restrict__ in,  // [E, 2, R, N]
                                    uint32_t* __restrict__ out,       // [E, R, 2, N]
                                    int E, int R, int N) {
  const size_t total = static_cast<size_t>(E) * R * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const size_t n = i % N;
  const size_t r = (i / N) % R;
  const size_t e = i / (static_cast<size_t>(N) * R);
  const uint32_t lo = in[((e * 2 + 0) * R + r) * N + n];
  const uint32_t hi = in[((e * 2 + 1) * R + r) * N + n];
  const uint32_t even = deposit4(lo & 0xFFFFu) | (deposit4(hi & 0xFFFFu) << 4);
  const uint32_t odd = deposit4(lo >> 16) | (deposit4(hi >> 16) << 4);
  out[((e * R + r) * 2 + 0) * N + n] = even;
  out[((e * R + r) * 2 + 1) * N + n] = odd;
}

QLLM_API int qllm_planarize_w4(const void* in, void* out, int E, int R, int N, void* stream) {
  const size_t total = static_cast<size_t>(E) * R * N;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  planarize_w4_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), E, R, N);
  return qllm_launch_status();
}
