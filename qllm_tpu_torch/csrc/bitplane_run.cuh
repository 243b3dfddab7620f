// K16's launch at one width (csrc/bitplane.cu holds its C entry and the
// 3- and 5-bit instances of the body; csrc/bitplane_67.cu the 6- and
// 7-bit ones, so that the build compiles the two halves of K16's 48 kernel
// instances at once).
#pragma once

#include "common.cuh"
#include "stacked_mma.cuh"

template <int BITS>
int bitplane_run(const void* x, int x_f32, const uint32_t* qw, const void* sc, const void* zs, int s_type, void* part,
                 void* out, int fused, int M, int K, int Np, int g, int splits, int wps, cudaStream_t st) {
  return stacked_mma::run<stacked_mma::BitPlane<BITS>>(x, x_f32, qw, sc, zs, s_type, part, out, fused, M, K, Np, g,
                                                       splits, wps, st);
}

// compiled in bitplane_67.cu
extern template int bitplane_run<6>(const void*, int, const uint32_t*, const void*, const void*, int, void*, void*,
                                    int, int, int, int, int, int, int, cudaStream_t);
extern template int bitplane_run<7>(const void*, int, const uint32_t*, const void*, const void*, int, void*, void*,
                                    int, int, int, int, int, int, int, cudaStream_t);
