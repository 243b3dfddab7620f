// K16 bitplane_stacked_gemv at 6 and 7 bits: the instances of the
// tensor-core body (csrc/stacked_mma.cuh) that bitplane.cu's C entry calls
// for those widths, in a source of their own so that they compile beside
// bitplane.cu's 3- and 5-bit ones (the kernel's note is in bitplane.cu).

#include "bitplane_run.cuh"

template int bitplane_run<6>(const void*, int, const uint32_t*, const void*, const void*, int, void*, void*, int, int,
                             int, int, int, int, int, cudaStream_t);
template int bitplane_run<7>(const void*, int, const uint32_t*, const void*, const void*, int, void*, void*, int, int,
                             int, int, int, int, int, cudaStream_t);
