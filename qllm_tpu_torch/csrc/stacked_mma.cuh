// The tensor-core body shared by the decode GEMVs (M <= 32): on GPTQ-order
// and bit-plane words K14 gptq_stacked_gemv, K15 gptq_stacked_w4a8_gemv,
// K12 gptq_w4a8_gemv and K9 gptq_gemv (csrc/gptq_stacked.cu), K16
// bitplane_stacked_gemv (csrc/bitplane.cu); on planar words (the Planar
// policy and planar_consume, at the end) K1 w4_planar_gemv (csrc/qmm.cu),
// K17 w4_planar_f32s_gemv (csrc/planar_f32.cu), K8 w4_grouped_gemv
// (csrc/grouped_mma.cu) and both products of K20 w4_pnp_gemv
// (csrc/fused_mlp.cu), and K11 w4a8_planar_gemv (csrc/w4a8.cu) on its int8
// twin, planar_s8_kernel. Each GPTQ-order or bit-plane GEMV reads one
// layer of 2/4/8-bit GPTQ-order or 3/5/6/7-bit bit-plane words (a
// per-layer weight is layer 0), with x in bf16 or f32 (K15: int8). With q
// the unsigned field, the bf16 kernel (stacked_mma_kernel) computes
//   unfused: y[m, n] = sum_g s_g[n] * (x_g . q_g[:, n]), f32 out (the
//            caller takes off xsum_g @ zs_g outside, as JAX does);
//   fused:   y[m, n] = sum_g (s_g[n] * (x_g . q_g[:, n]) - sum(x_g) * zs_g[n]),
//            rounded to bf16, zs_g read prefolded (K14, K16) or formed as
//            z_g * s_g in f32 from the zero points (K9),
// as the TPU kernels do: an f32 dot per group, scaled at the group's end.
// The int8 kernel (stacked_s8_kernel, K15 and K12) computes y = sum_g s_g
// * d_g with d_g = x8_g . q_g an exact s32 dot, f32 out.
//
// Bound on the H100: bytes (the layer's words, scales and zs, read once).
// The dots run on the tensor cores: mma.sync m16n8k16 bf16 with f32
// accumulators (m16n8k32 s8 with s32 accumulators for K15), 16 output columns as
// the A operand and 8 rows of x as the B operand (the swapped product). A
// field q is OR-ed into the mantissa of 128.0: the bf16 value 128 + q,
// exact (q < 128), with no conversion and no subtraction. An 8-bit field
// is two such values, 16 * (128 + hi) (its high nibble OR-ed into 2048.0)
// and 128 + lo, run as two MMAs into one accumulator. A bf16 x is exact
// too, so every product is exact; the MMA
// sums (bias + q) x in f32, and a second MMA with A all ones sums x over
// the same k (the group sum: masked and ordered like the dot). At the
// group's end, dot = sum (bias + q) x - bias * sum x, then y += dot * s (-
// sum x * zs when fused). An f32 x is split into three bf16 parts hi + mid
// + lo, which hold its 24 bits (outside subnormals), and each part runs its
// own MMAs on the same A. K15's and K12's fields are exact s8 values below
// 2^bits: a shift and a per-byte mask place four of them in a register,
// against x8 staged in the same k order.
//
// Layout. The order of k inside one MMA is free as long as A and B agree,
// and so is the order of the output columns inside a tile. A lane (gq =
// lane / 4, c = lane % 4) owns 4 adjacent columns and, in each step, one
// "unit" of the weight: a word row of 32/bits k (GPTQ order) or a word
// index of 32 k in every bit plane (K16); the four lanes of a quad take
// four consecutive units (rows of the stage). The unit's k are paired
// (k_a, k_b) so that a shift and a mask (GPTQ order) or a byte permute of
// the plane sum (K16) give the bf16 pair; columns n + 2i and n + 2i + 1 are
// A rows gq and gq + 8 of one MMA, and the lane reads x for its B
// registers from a tile in shared memory at the k its own fields hold.
//
// Groups close as the JAX kernels close them: an f32 accumulator per
// group, y += acc * s (- xsum * zs) at its end. A step whose k span holds
// a group end runs once per group it touches, with the other groups' k
// zeroed in B (as K18 does). K is split over gridDim.y by a count the
// wrapper takes from K and N alone, each split writes its partial sums and
// split_sum_out_kernel adds them in split order in a second launch.
// A row's bits depend neither on M nor on the other rows nor on the run.
//
// Bytes in flight: a producer warp keeps the next S steps' weight rows of
// the block in a ring in shared memory, one bulk copy (cp.async.bulk, the
// copy engine of TMA) a row and plane (or, for most planar GEMVs, a
// 16-byte cp.async by each of its 32 lanes: kCopyLanes; 4-byte ones when
// Np % 4 != 0), each stage's arrival and release tracked by a pair of
// mbarriers, so the four consumer warps spend no issue slots on loads and
// do not wait for them (a ring filled by the consumers' own cp.async held
// K14 at twice this time: their loads and products did not overlap); the
// block's x tile and its scales (and zs) are staged by the consumers once
// per chunk of its split (one chunk unless they would pass kXBudget).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace stacked_mma {

constexpr int kWarps = 4;                // consumer warps
constexpr int kThreads = 32 * kWarps;    // consumer threads
constexpr int kBlock = kThreads + 32;    // and the producer warp
constexpr int kCols = 32 * kWarps;       // output columns of a block, 4 a lane
constexpr int kXBudget = 96 * 1024;      // bytes of x tile and parameters a chunk may take
constexpr uint32_t kOnes = 0x3F803F80u;  // bf16 pair (1, 1)
constexpr int kBarBytes = 256;           // the mbarriers, before the ring

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b)) : "memory");
}
// arrive, and expect `bytes` more of bulk copies before the phase completes
__device__ __forceinline__ void mbar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(b)), "r"(bytes) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
  } while (!done);
}
// `bytes` (a multiple of 16) global -> shared, completing on mbarrier b
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* b) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(b))
               : "memory");
}
// arrive on b once this thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(b)) : "memory");
}
// the consumer warps' barrier (the producer warp takes no part)
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory"); }

// (x & M) | c in one LOP3 (written as `(x & M) | C` the compiler makes two,
// since one instruction holds one immediate); c in a register
template <uint32_t M>
__device__ __forceinline__ uint32_t and_or(uint32_t x, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(d) : "r"(x), "n"(M), "r"(c));
  return d;
}

// GPTQ-order words (K9, K14, K15): word row r holds k = r * pf + f at bit
// offset bits * f; pair s (s < pf / 2) is fields (s, s + pf / 2), which one
// shift and one mask place in the two halves of a word. An 8-bit pair is
// two parts: the low nibbles as 128 + lo, the high as 16 * (128 + hi)
template <int BITS>
struct GptqOrder {
  static constexpr int kUnitK = 32 / BITS;
  static constexpr int kHalf = kUnitK;  // a half of kHalf k holds pairs (s, s + kHalf / 2)
  static constexpr int kPlanes = 1;
  static constexpr int kStages = 8;
  static constexpr int kParts = BITS == 8 ? 2 : 1;                // A values a field
  static constexpr float kBias = BITS == 8 ? 2176.f : 128.f;     // what the parts add to q
  // the blocks an SM the registers must leave room for (__launch_bounds__),
  // n-tiles by n-tiles, as measured fastest on the H100
  __host__ __device__ static constexpr int min_blocks(int nt) { return nt == 1 ? 4 : 2; }
  __device__ static size_t row(int, int unit, int) { return static_cast<size_t>(unit); }
  // the material a pair needs (none: the word itself)
  __device__ static void material(const uint32_t (&)[kPlanes][4], int, int, uint32_t (&)[2]) {}
  // part `part` of pair s of column col as bf16 (bias + q_a, bias + q_b)
  __device__ static uint32_t pair(const uint32_t (&w)[kPlanes][4], const uint32_t (&)[2], int col, int s, int part) {
    if constexpr (BITS == 8) {
      return part == 0 ? and_or<0x000F000Fu>(w[0][col] >> (8 * s), 0x43004300u)
                       : and_or<0x000F000Fu>(w[0][col] >> (8 * s + 4), 0x45004500u);
    } else {
      constexpr uint32_t m = (1u << BITS) - 1u;
      return and_or<m | (m << 16)>(w[0][col] >> (BITS * s), 0x43004300u);
    }
  }
};

// K16's planes: plane b is word rows [b * W, (b + 1) * W) and bit 8c + p of
// word w holds bit b of k = 32w + 8c + p. Summing the planes' bits p of
// each byte (the TPU kernel's shifts and 0x01010101 masks) gives four q
// bytes v[p] (byte c: k = 32w + 8c + p); pair 8h + p is bytes (2h, 2h + 1)
// of v[p], k = (32w + 16h + p, 32w + 16h + 8 + p), set beside 0x43 by a
// byte permute
template <int BITS>
struct BitPlane {
  static constexpr int kUnitK = 32;
  static constexpr int kHalf = 16;
  static constexpr int kPlanes = BITS;
  static constexpr int kStages = 4;
  static constexpr int kParts = 1;
  static constexpr float kBias = 128.f;
  // as K14's; at 4 n-tiles a cap of two blocks (204 registers) spills and is slower
  __host__ __device__ static constexpr int min_blocks(int nt) { return nt == 1 ? 3 : nt == 2 ? 2 : 1; }
  __device__ static size_t row(int b, int unit, int W) { return static_cast<size_t>(b) * W + unit; }
  // v[p] of column col for p = 2 p2 and 2 p2 + 1
  __device__ static void material(const uint32_t (&w)[kPlanes][4], int col, int p2, uint32_t (&v)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = 2 * p2 + i;
      uint32_t a = 0u;
#pragma unroll
      for (int b = 0; b < BITS; ++b) {
        // bit 8c + p of plane b to bit 8c + b (no byte overflows: q < 128)
        const uint32_t sh = p >= b ? (w[b][col] >> ((p - b) & 31)) : (w[b][col] << ((b - p) & 31));
        a |= sh & (0x01010101u << b);
      }
      v[i] = a;
    }
  }
  __device__ static uint32_t pair(const uint32_t (&)[kPlanes][4], const uint32_t (&v)[2], int, int s, int) {
    return __byte_perm(v[s & 1], 0x43434343u, s < 8 ? 0x4140 : 0x4342);
  }
};

// Planar words (K1, K17, K8; qllm_tpu/quant/qtensor.py:157-161): word row
// r holds k = 4r + j in the low nibble of byte j and k = K/2 + 4r + j in
// its high nibble. Read as GPTQ-order 4-bit fields, field f is k =
// 4r + f/2 of the low half (f even) or of the high half (f odd), so
// GptqOrder<4>::pair(s) is the bf16 pair of k (4r + s/2, 4r + s/2 + 2) of
// the low half for s even and of the high half for s odd. A unit is one
// word row: 4 k of each half
struct Planar {
  static constexpr int kUnitK = 8;
  static constexpr int kPlanes = 1;
  static constexpr int kStages = 8;
  __device__ static size_t row(int, int unit, int) { return static_cast<size_t>(unit); }
};

// bytes of a ring row: every plane's kCols words (the pad spreads the quad's rows over banks)
template <class P>
__host__ __device__ constexpr int ring_row_bytes() {
  return P::kPlanes * kCols * 4 + 32;
}

// The x tile: row m of a chunk at m * row_bytes, unit u at u * kUnitK *
// esize, its pieces j (16 bytes, 8 where a unit holds 8) at piece * (j ^
// swizzle(u)); the row pitch and the swizzle keep the lanes' reads of one
// B load in distinct bank groups for bf16 x
template <int UNIT_K>
__host__ __device__ inline int x_row_bytes(int kc, int esize) {
  const int pieces = UNIT_K * esize / 16;
  const int off = esize == 2 ? (pieces == 1 ? 4 : pieces == 2 ? 1 : 2) : 1;
  return (kc * esize + 127) / 128 * 128 + 16 * off;
}
// K15's x8 tile: a unit's kUnitK bytes, a quad's four units a row
// (32 or 64 bytes) apart by the pitch's pad from the next row's
template <int UNIT_K>
__host__ __device__ inline int x8_row_bytes(int kc) {
  return (kc + 127) / 128 * 128 + 4 * UNIT_K;
}

// the groups a chunk of kc k can touch (it need not start at a group's start)
__host__ __device__ inline int groups_of_chunk(int kc, int g) { return (kc - 1) / g + 2; }

template <int UNIT_K, bool XF32>
__device__ __forceinline__ int x_swizzle(int u) {
  return (!XF32 && UNIT_K * 2 / 16 == 4) ? ((u >> 1) & 1) : 0;
}

// 8 bytes global -> shared (zero-filled when !pred), through L1
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem), "r"(pred ? 8 : 0));
}

// parameter i of a row staged as type 0 (f32), 1 (fp16) or 2 (bf16), as f32
__device__ __forceinline__ float param_at(const unsigned char* row, int type, int i) {
  if (type == 0) return reinterpret_cast<const float*>(row)[i];
  if (type == 1) return __half2float(reinterpret_cast<const __half*>(row)[i]);
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[i]);
}

// an f32 pair (x0 in the lower half) as three exact bf16 pairs, x = hi +
// mid + lo (each difference is exact in f32)
__device__ __forceinline__ void split3(float x0, float x1, uint32_t (&b)[3]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  b[0] = bf16x2_bits(h);
  b[1] = bf16x2_bits(m);
  b[2] = bf16x2_bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

// the ring's barriers: full[i] completes when stage i's rows have landed
// (one arrival and the bulk copies' bytes when bulk, else the 32 producer
// lanes' cp.async), empty[i] when the four consumer warps are done with it
template <int S>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, bool bulk) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, bulk ? 1 : 32);
      mbar_init(empty + i, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// How the producer fills the ring: kCopyBulk, one bulk copy a row and
// plane; kCopyLanes, a 16-byte cp.async by each of its 32 lanes (both need
// Np % 4 == 0 and 16-byte aligned words); kCopyWords, 4-byte cp.async.
// The planar GEMVs take the lanes' copies at two or more blocks an SM
// (4-16% faster than bulk copies at M <= 8 on the H100: K1, K17, K8, K11,
// K20; K11 also at M = 17-32) and bulk copies at one (K1 and K17 at four
// n-tiles, where the lanes' were 3-7% slower)
enum : int { kCopyWords = 0, kCopyBulk = 1, kCopyLanes = 2 };

// The producer warp: stage t of the ring holds units u0 + 4t .. + 3 of
// every plane, the block's kCols columns each (units past u1 are left as
// they are: the consumers' x is zero there), copied as `copy` says (the
// stacked kernels pass vec: bulk copies or words). t0: the stages the ring
// took before (a persistent block's earlier items, K20); returns the count
// after
template <class P>
__device__ __forceinline__ int produce(const uint32_t* __restrict__ qw, uint64_t* full, uint64_t* empty,
                                       unsigned char* ring, int lane, int n0, int Np, int u0, int u1, int W,
                                       int copy, int t0 = 0) {
  constexpr int PL = P::kPlanes, S = P::kStages, RS = ring_row_bytes<P>();
  const int T = (u1 - u0 + 3) / 4;
  const int seg = min(kCols, Np - n0) * 4;  // bytes of a row in range
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const int tt = t0 + t, st = tt & (S - 1);
    if (tt >= S) mbar_wait(empty + st, ((tt / S) - 1) & 1);
    unsigned char* dst = ring + st * 4 * RS;
    const int rows = min(4, u1 - u0 - 4 * t);
    if (copy == kCopyBulk) {
      if (lane == 0) {
        mbar_expect(full + st, static_cast<uint32_t>(rows * PL * seg));
        for (int r = 0; r < rows; ++r)
          for (int b = 0; b < PL; ++b)
            bulk_copy(dst + r * RS + b * kCols * 4, qw + P::row(b, u0 + 4 * t + r, W) * Np + n0, seg, full + st);
      }
    } else if (copy == kCopyLanes) {  // four columns a lane (Np % 4 == 0: in range or not)
      const bool on = 4 * lane < Np - n0;
      for (int r = 0; r < rows; ++r)
        for (int b = 0; b < PL; ++b)
          cp_async16(dst + r * RS + (b * kCols + 4 * lane) * 4,
                     on ? qw + P::row(b, u0 + 4 * t + r, W) * Np + n0 + 4 * lane : qw, on);
      cp_async_arrive(full + st);
    } else {
      for (int i = lane; i < 4 * PL * kCols; i += 32) {
        const int r = i / (PL * kCols), b = (i / kCols) % PL, col = i % kCols;
        const bool on = r < rows && n0 + col < Np;
        const uint32_t* src = on ? qw + P::row(b, u0 + 4 * t + r, W) * Np + n0 + col : qw;
        cp_async4(dst + r * RS + (b * kCols + col) * 4, src, on);
      }
      cp_async_arrive(full + st);
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  return t0 + T;
}

// a consumer's step t: wait for its stage, read the lane's row c (four
// columns of every plane) and release the stage to the producer
template <class P>
__device__ __forceinline__ void take_stage(uint64_t* full, uint64_t* empty, const unsigned char* ring, int t, int c,
                                           int lcol, int lane, uint32_t (&w)[P::kPlanes][4]) {
  constexpr int S = P::kStages, RS = ring_row_bytes<P>();
  const int st = t & (S - 1);
  mbar_wait(full + st, (t / S) & 1);  // the stage's rows have landed
  const unsigned char* src = ring + st * 4 * RS + c * RS + lcol * 4;
#pragma unroll
  for (int b = 0; b < P::kPlanes; ++b) {
    const uint4 v = *reinterpret_cast<const uint4*>(src + b * kCols * 4);
    w[b][0] = v.x;
    w[b][1] = v.y;
    w[b][2] = v.z;
    w[b][3] = v.w;
  }
  __syncwarp();
  if (lane == 0) mbar_arrive(empty + st);  // the producer may refill it
}

// Entry (table f, row gl, column col) of a chunk's parameter tables pt
// [tables][ngc][kCols] of ps-byte entries: row gl holds the chunk's group gl
template <class T>
__device__ __forceinline__ T* param_row(T* pt, int f, int ngc, int gl, int col, int ps) {
  return pt + ((f * ngc + gl) * kCols + col) * ps;
}

// The block's parameters of groups [gf, gf + ng) into pt [nf][ngc][kCols]
// (ps bytes each; nf = 2: the scales, then zs or the zero points), by the
// consumers' cp.async (committed by the caller); zero past Np
__device__ __forceinline__ void stage_params(unsigned char* pt, const void* sc, const void* zs, int nf, int ngc,
                                             int gf, int ng, int n0, int Np, int ps, int vec) {
  for (int i = threadIdx.x; i < nf * ng * (kCols / 4); i += kThreads) {
    const int f = i / (ng * (kCols / 4)), r = i - f * (ng * (kCols / 4));
    const int gl = r / (kCols / 4), col = 4 * (r - gl * (kCols / 4));
    const unsigned char* src =
        static_cast<const unsigned char*>(f ? zs : sc) + (static_cast<size_t>(gf + gl) * Np + n0 + col) * ps;
    unsigned char* dst = param_row(pt, f, ngc, gl, col, ps);
    const int left = Np - n0 - col;
    if (vec) {
      if (ps == 4)
        cp_async16(dst, left > 0 ? src : sc, left > 0);
      else
        cp_async8(dst, left > 0 ? src : sc, left > 0);
    } else {
      for (int j = 0; j < 4; ++j) {
        if (ps == 4)
          reinterpret_cast<uint32_t*>(dst)[j] = j < left ? __ldg(reinterpret_cast<const uint32_t*>(src) + j) : 0u;
        else
          reinterpret_cast<unsigned short*>(dst)[j] =
              j < left ? __ldg(reinterpret_cast<const unsigned short*>(src) + j) : static_cast<unsigned short>(0);
      }
    }
  }
}

// The consumers' walk over their split's k [k0, k1), the same for every
// body (K8's on the k of each half of K): chunks of at most kc k, each
// staged by stage(ch0, ch1) before its steps; steps of `step` k taken from
// the ring, lane c's unit unit_k * c k into it. A step inside one group
// runs compute(w, ul, kunit, 0, 0, false) once; a step that holds a group's
// end runs compute(w, ul, kunit, lo, hi, true) once per group it touches,
// only k in [lo, hi) of the lane's unit taken. close(row) closes the open
// group (or the part of it in this split), whose parameters are row `row`
// of the chunk's tables. t0 and the result: the ring's stages taken, as
// produce's.
template <class P, class Stage, class Compute, class Close>
__device__ __forceinline__ int walk_split(uint64_t* full, uint64_t* empty, const unsigned char* ring, int c, int lcol,
                                          int lane, int k0, int k1, int kc, int step, int unit_k, int g,
                                          Stage&& stage, Compute&& compute, Close&& close, int t0 = 0) {
  // the open group, its end, and the chunk's first group (row 0 of its tables)
  int gcur = k0 / g;
  int kend = (gcur + 1) * g;
  int gf_chunk = gcur;
  auto flush = [&]() {
    close(gcur - gf_chunk);
    ++gcur;
    kend += g;
  };
  int ch0 = k0, ch1 = min(k0 + kc, k1);
  stage(ch0, ch1);
  int t = t0;
#pragma unroll 1
  while (true) {
#pragma unroll 1
    for (int ka = ch0; ka < ch1; ka += step, ++t) {
      uint32_t w[P::kPlanes][4];
      take_stage<P>(full, empty, ring, t, c, lcol, lane, w);
      const int ul = (ka - ch0) / unit_k + c, kunit = ka + c * unit_k;
      const int kz = min(ka + step, k1);
      if (kz <= kend) {  // one group: uniform across the block
        compute(w, ul, kunit, 0, 0, false);
        if (kz == kend || kz == k1) flush();
      } else {
        // the step holds a group end: once per group, the others zeroed
#pragma unroll 1
        for (int lo = ka; lo < kz;) {
          const int hi = min(kend, kz);
          compute(w, ul, kunit, lo, hi, true);
          if (hi == kend || hi == k1) flush();
          lo = hi;
        }
      }
    }
    if (ch1 >= k1) break;
    // the next chunk (only when the split's x and parameters pass kXBudget)
    ch0 = ch1;
    ch1 = min(ch0 + kc, k1);
    gf_chunk = ch0 / g;
    consumers_sync();
    stage(ch0, ch1);
  }
  return t;
}

// The lane's outputs: rows mt * 8 + 2c + r, its four columns, from the
// accumulator layout (y[mt][pr][e]: column 2pr + (e >> 1), row 2c + (e &
// 1)), to the split's partial sums, or (no split) to out in f32 or bf16
template <int NT>
__device__ __forceinline__ void write_out(const float (&y)[NT][2][4], int c, int M, int Np, int n, int vec,
                                          float* part, void* out, bool out_bf16) {
  const int nv = Np - n;  // the lane's valid columns, if below 4
#pragma unroll
  for (int mt = 0; mt < NT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = mt * 8 + 2 * c + r;
      if (m >= M || nv <= 0) continue;
      const float v[4] = {y[mt][0][r], y[mt][0][2 + r], y[mt][1][r], y[mt][1][2 + r]};
      if (part != nullptr || !out_bf16) {
        float* dst = part != nullptr ? part + (static_cast<size_t>(blockIdx.y) * M + m) * Np + n
                                     : static_cast<float*>(out) + static_cast<size_t>(m) * Np + n;
        if (vec) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < nv) dst[j] = v[j];
        }
      } else {
        __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out) + static_cast<size_t>(m) * Np + n;
        if (vec) {
          *reinterpret_cast<uint2*>(dst) = make_uint2(bf16x2_bits(__floats2bfloat162_rn(v[0], v[1])),
                                                      bf16x2_bits(__floats2bfloat162_rn(v[2], v[3])));
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < nv) dst[j] = __float2bfloat16_rn(v[j]);
        }
      }
    }
  }
}

// P: GptqOrder<BITS> or BitPlane<BITS>; NT: n-tiles of 8 rows of x (M <=
// 8 NT); XF32: x stored f32 (three MMAs a product); FUSE: the zero-point
// term in the kernel, bf16 out (zeros = 1: zs holds the zero points z,
// and z * s is formed at each group's end). units_per_split: units (word
// rows / word indices) of each split; kc: k staged per chunk (a multiple
// of 4 units); vec: Np % 4 == 0 and every pointer 16-byte aligned
template <class P, int NT, bool XF32, bool FUSE>
__global__ void __launch_bounds__(kBlock, P::min_blocks(NT))
    stacked_mma_kernel(const void* __restrict__ x,        // [M, K]
                       const uint32_t* __restrict__ qw,   // the layer's words
                       const void* __restrict__ sc, const void* __restrict__ zs, int s_type,  // [G, Np]
                       int zeros, int M, int K, int Np, int g, int units_per_split, int kc, int vec,
                       float* __restrict__ part,   // [splits, M, Np] when split
                       void* __restrict__ out) {   // [M, Np] f32 (unfused) or bf16 (fused)
  constexpr int UK = P::kUnitK, HS = P::kHalf, PL = P::kPlanes, S = P::kStages;
  constexpr int STEP = 4 * UK;      // k of one step of a warp
  constexpr int NH = UK / HS;       // halves of a unit
  constexpr int JH = HS / 4;        // MMAs of a half (two pairs each)
  constexpr int ES = XF32 ? 4 : 2;  // bytes of an x element
  constexpr int XP = XF32 ? 3 : 1;  // bf16 parts of an x element
  constexpr int PB = UK * ES < 16 ? UK * ES : 16;  // bytes of an x piece
  static_assert((S & (S - 1)) == 0 && 2 * S * 8 <= kBarBytes, "ring stages: a power of two");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [S]: a stage's rows have landed
  uint64_t* empty = full + S;                          // [S]: the consumers are done with a stage
  unsigned char* ring = smem + kBarBytes;              // [S][4 rows][ring_row_bytes]
  unsigned char* xt = ring + S * 4 * ring_row_bytes<P>();
  const int rb = x_row_bytes<UK>(kc, ES);
  const int ps = s_type == 0 ? 4 : 2;  // bytes of a parameter
  const int ngc = groups_of_chunk(kc, g);
  unsigned char* pt = xt + M * rb;  // [FUSE ? 2 : 1][ngc][kCols] scales, then zs (or z)

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, c = lane & 3;
  const int n0 = blockIdx.x * kCols;
  const int W = K / UK;
  const int u0 = blockIdx.y * units_per_split, u1 = min(W, u0 + units_per_split);
  const int k0 = u0 * UK, k1 = u1 * UK;

  init_ring<S>(full, empty, vec);
  if (warp == kWarps) {
    produce<P>(qw, full, empty, ring, lane, n0, Np, u0, u1, W, vec);
    return;
  }

  const int lcol = warp * 32 + 4 * gq;  // the lane's first column in the block
  const int n = n0 + lcol;              // and in the layer

  // x[:, ch0:ch1) into the tile, zero past ch1 up to a whole step, and
  // the block's scales (and zs) of every group the chunk touches
  auto stage_chunk = [&](int ch0, int ch1) {
    stage_params(pt, sc, zs, FUSE ? 2 : 1, ngc, ch0 / g, (ch1 - 1) / g - ch0 / g + 1, n0, Np, ps, vec);
    constexpr int CE = PB / ES;       // elements of a piece
    constexpr int JC = UK * ES / PB;  // pieces of a unit
    const int U = (ch1 - ch0 + STEP - 1) / STEP * 4;
    const int per_row = U * JC;
    for (int i = threadIdx.x; i < M * per_row; i += kThreads) {
      const int m = i / per_row, r = i - m * per_row;
      const int ul = r / JC, j = r - ul * JC;
      const int e = ch0 + ul * UK + j * CE;
      unsigned char* dst = xt + m * rb + ul * UK * ES + PB * (j ^ x_swizzle<UK, XF32>(ul));
      const bool on = e < ch1;
      const void* src = on ? static_cast<const unsigned char*>(x) + (static_cast<size_t>(m) * K + e) * ES : x;
      if constexpr (PB == 16)
        cp_async16(dst, src, on);
      else
        cp_async8(dst, src, on);
    }
    cp_async_commit();
    cp_async_wait<0>();
    consumers_sync();
  };

  // acc: sum (bias + q) x of the open group; xs: sum x (the ones MMA); y:
  // the scaled groups so far
  float acc[NT][2][4], y[NT][2][4], xs[NT][4];
#pragma unroll
  for (int mt = 0; mt < NT; ++mt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      xs[mt][e] = 0.f;
      acc[mt][0][e] = acc[mt][1][e] = y[mt][0][e] = y[mt][1][e] = 0.f;
    }
  }

  // one step's products over the k in [lo, hi) (all of them when !masked)
  // of this lane's unit: x from the tile at unit ul of the chunk
  auto compute = [&](const uint32_t (&w)[PL][4], int ul, int kunit, int lo, int hi, bool masked) {
    // B: the bf16 words of the unit for every n-tile (rows past M are 0)
    uint32_t xb[NT][UK / 2];
    float xf[NT][UK];
#pragma unroll
    for (int mt = 0; mt < NT; ++mt) {
      const int m = mt * 8 + gq;
      const unsigned char* xr = xt + m * rb + ul * UK * ES;
      if constexpr (!XF32 && UK >= 8) {
#pragma unroll
        for (int i = 0; i < UK / 8; ++i) {
          const uint4 v = m < M ? *reinterpret_cast<const uint4*>(xr + 16 * (i ^ x_swizzle<UK, XF32>(ul)))
                                : make_uint4(0u, 0u, 0u, 0u);
          xb[mt][4 * i] = v.x;
          xb[mt][4 * i + 1] = v.y;
          xb[mt][4 * i + 2] = v.z;
          xb[mt][4 * i + 3] = v.w;
        }
      } else if constexpr (!XF32) {
        const uint2 v = m < M ? *reinterpret_cast<const uint2*>(xr) : make_uint2(0u, 0u);
        xb[mt][0] = v.x;
        xb[mt][1] = v.y;
      } else {
#pragma unroll
        for (int i = 0; i < UK / 4; ++i) {
          const float4 v = m < M ? *reinterpret_cast<const float4*>(xr + 16 * i) : make_float4(0.f, 0.f, 0.f, 0.f);
          xf[mt][4 * i] = v.x;
          xf[mt][4 * i + 1] = v.y;
          xf[mt][4 * i + 2] = v.z;
          xf[mt][4 * i + 3] = v.w;
        }
      }
    }
#pragma unroll
    for (int p2 = 0; p2 < JH; ++p2) {
      uint32_t mat[4][2];
#pragma unroll
      for (int col = 0; col < 4; ++col) P::material(w, col, p2, mat[col]);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const int s0 = h * (HS / 2) + 2 * p2;  // pairs s0, s0 + 1: k (hs + 2p2 [+1], hs + HS/2 + 2p2 [+1])
        // the group mask of this half: its low k (pair lower halves) and its
        // high k (upper halves), HS / 2 each
        uint32_t keep = 0xFFFFFFFFu;
        if (masked) {
          const int ka = kunit + h * HS, kb = ka + HS / 2;
          keep = (ka >= lo && ka < hi ? 0x0000FFFFu : 0u) | (kb >= lo && kb < hi ? 0xFFFF0000u : 0u);
        }
#pragma unroll
        for (int pa = 0; pa < P::kParts; ++pa) {
          uint32_t a[2][4];
#pragma unroll
          for (int pr = 0; pr < 2; ++pr) {
            a[pr][0] = P::pair(w, mat[2 * pr], 2 * pr, s0, pa);
            a[pr][1] = P::pair(w, mat[2 * pr + 1], 2 * pr + 1, s0, pa);
            a[pr][2] = P::pair(w, mat[2 * pr], 2 * pr, s0 + 1, pa);
            a[pr][3] = P::pair(w, mat[2 * pr + 1], 2 * pr + 1, s0 + 1, pa);
          }
#pragma unroll
          for (int mt = 0; mt < NT; ++mt) {
            uint32_t b0[XP], b1[XP];
            if constexpr (!XF32) {
              const uint32_t lo_w = xb[mt][h * (HS / 2) + p2], hi_w = xb[mt][h * (HS / 2) + HS / 4 + p2];
              b0[0] = __byte_perm(lo_w, hi_w, 0x5410) & keep;
              b1[0] = __byte_perm(lo_w, hi_w, 0x7632) & keep;
            } else {
              const bool kl = keep & 1u, kh = keep >> 31;
              const float* v = xf[mt] + h * HS;
              uint32_t p0[3], p1[3];
              split3(kl ? v[2 * p2] : 0.f, kh ? v[HS / 2 + 2 * p2] : 0.f, p0);
              split3(kl ? v[2 * p2 + 1] : 0.f, kh ? v[HS / 2 + 2 * p2 + 1] : 0.f, p1);
#pragma unroll
              for (int q = 0; q < 3; ++q) {
                b0[q] = p0[q];
                b1[q] = p1[q];
              }
            }
#pragma unroll
            for (int q = 0; q < XP; ++q) {
#pragma unroll
              for (int pr = 0; pr < 2; ++pr)
                mma_bf16_16816(acc[mt][pr], a[pr][0], a[pr][1], a[pr][2], a[pr][3], b0[q], b1[q]);
              if (pa == 0) mma_bf16_16816(xs[mt], kOnes, kOnes, kOnes, kOnes, b0[q], b1[q]);
            }
          }
        }
      }
    }
  };

  // close the open group (or the part of it in this split): its
  // parameters are row `row` of the chunk's tables
  auto close = [&](int row) {
    const unsigned char* srow = param_row(pt, 0, ngc, row, lcol, ps);
    const unsigned char* zrow = param_row(pt, 1, ngc, row, lcol, ps);
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // C registers: (column 2pr: rows 2c, 2c+1), (column 2pr+1: rows 2c, 2c+1)
        const int col = 2 * pr + half;
        const float s = param_at(srow, s_type, col);
        float z = 0.f;
        if (FUSE) {
          z = param_at(zrow, s_type, col);
          if (zeros) z *= s;
        }
#pragma unroll
        for (int mt = 0; mt < NT; ++mt) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * half + r;
            const float dot = fmaf(-P::kBias, xs[mt][r], acc[mt][pr][e]);
            const float t = fmaf(dot, s, y[mt][pr][e]);
            y[mt][pr][e] = FUSE ? fmaf(-xs[mt][r], z, t) : t;
            acc[mt][pr][e] = 0.f;
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < NT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[mt][e] = 0.f;
  };

  walk_split<P>(full, empty, ring, c, lcol, lane, k0, k1, kc, STEP, UK, g, stage_chunk, compute, close);
  write_out<NT>(y, c, M, Np, n, vec, part, out, FUSE);
}

// K15's (and K12's) consumer: x8 (int8) against GPTQ-order 2/4-bit fields on
// mma.sync m16n8k32 s8. A unit (a word row of UK = 32 / BITS k) holds
// NPAR = 8 / BITS parities: (w >> BITS p) & 0x0101..01 * (2^BITS - 1) is
// fields p + NPAR b (b = 0..3) as four s8 values. The unit's x8 is staged
// parity by parity (word p: k = p + NPAR b of the unit), so MMA j of a
// unit takes parities 2j (A k 4c..4c+3) and 2j + 1 (A k 4c+16..+19) and
// its B words are the staged words 2j and 2j + 1. Every dot is exact in
// s32; at a group's end y += float(d) * s. units_per_split, kc, vec as
// stacked_mma_kernel's; out f32 (or the split's partial sums).
template <int BITS, int NT>
__global__ void __launch_bounds__(kBlock, GptqOrder<BITS>::min_blocks(NT))
    stacked_s8_kernel(const int8_t* __restrict__ x8,     // [M, K]
                      const uint32_t* __restrict__ qw,   // the layer's words
                      const void* __restrict__ sc, int s_type,  // [G, Np]
                      int M, int K, int Np, int g, int units_per_split, int kc, int vec,
                      float* __restrict__ part,   // [splits, M, Np] when split
                      float* __restrict__ out) {  // [M, Np] when not
  using P = GptqOrder<BITS>;
  constexpr int UK = P::kUnitK, S = P::kStages;
  constexpr int STEP = 4 * UK;
  constexpr int NPAR = 8 / BITS;
  constexpr uint32_t kMask = ((1u << BITS) - 1u) * 0x01010101u;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S;
  unsigned char* ring = smem + kBarBytes;
  unsigned char* xt = ring + S * 4 * ring_row_bytes<P>();
  const int rb = x8_row_bytes<UK>(kc);
  const int ps = s_type == 0 ? 4 : 2;
  const int ngc = groups_of_chunk(kc, g);
  unsigned char* pt = xt + M * rb;  // [ngc][kCols] scales

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, c = lane & 3;
  const int n0 = blockIdx.x * kCols;
  const int W = K / UK;
  const int u0 = blockIdx.y * units_per_split, u1 = min(W, u0 + units_per_split);
  const int k0 = u0 * UK, k1 = u1 * UK;

  init_ring<S>(full, empty, vec);
  if (warp == kWarps) {
    produce<P>(qw, full, empty, ring, lane, n0, Np, u0, u1, W, vec);
    return;
  }
  const int lcol = warp * 32 + 4 * gq;

  // x8[:, ch0:ch1) into the tile unit by unit, its bytes by parity (zero
  // past ch1 up to a whole step), and the block's scales of the chunk
  auto stage_chunk = [&](int ch0, int ch1) {
    stage_params(pt, sc, nullptr, 1, ngc, ch0 / g, (ch1 - 1) / g - ch0 / g + 1, n0, Np, ps, vec);
    cp_async_commit();
    const int U = (ch1 - ch0 + STEP - 1) / STEP * 4;
    for (int i = threadIdx.x; i < M * U; i += kThreads) {
      const int m = i / U, ul = i - m * U;
      const int e = ch0 + ul * UK;
      unsigned char* dst = xt + m * rb + ul * UK;
      const int8_t* src = x8 + static_cast<size_t>(m) * K + e;
      if constexpr (BITS == 4) {
        const uint2 v = e < ch1 ? __ldg(reinterpret_cast<const uint2*>(src)) : make_uint2(0u, 0u);
        *reinterpret_cast<uint2*>(dst) = make_uint2(__byte_perm(v.x, v.y, 0x6420), __byte_perm(v.x, v.y, 0x7531));
      } else {
        const uint4 v = e < ch1 ? __ldg(reinterpret_cast<const uint4*>(src)) : make_uint4(0u, 0u, 0u, 0u);
        // a 4 x 4 byte transpose: parity p is byte p of each word
        const uint32_t t0 = __byte_perm(v.x, v.y, 0x5140), t1 = __byte_perm(v.z, v.w, 0x5140);
        const uint32_t t2 = __byte_perm(v.x, v.y, 0x7362), t3 = __byte_perm(v.z, v.w, 0x7362);
        *reinterpret_cast<uint4*>(dst) = make_uint4(__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                                                    __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632));
      }
    }
    cp_async_wait<0>();
    consumers_sync();
  };

  int acc[NT][2][4];
  float y[NT][2][4];
#pragma unroll
  for (int mt = 0; mt < NT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[mt][0][e] = acc[mt][1][e] = 0;
      y[mt][0][e] = y[mt][1][e] = 0.f;
    }

  // one step's products of this lane's unit ul (B zero unless keep: the
  // unit lies in the group being summed)
  auto compute = [&](const uint32_t (&w)[1][4], int ul, bool keep) {
    uint32_t xb[NT][NPAR];
#pragma unroll
    for (int mt = 0; mt < NT; ++mt) {
      const int m = mt * 8 + gq;
      const unsigned char* xr = xt + m * rb + ul * UK;
      const bool on = keep && m < M;
      if constexpr (NPAR == 2) {
        const uint2 v = on ? *reinterpret_cast<const uint2*>(xr) : make_uint2(0u, 0u);
        xb[mt][0] = v.x;
        xb[mt][1] = v.y;
      } else {
        const uint4 v = on ? *reinterpret_cast<const uint4*>(xr) : make_uint4(0u, 0u, 0u, 0u);
        xb[mt][0] = v.x;
        xb[mt][1] = v.y;
        xb[mt][2] = v.z;
        xb[mt][3] = v.w;
      }
    }
#pragma unroll
    for (int j = 0; j < NPAR / 2; ++j) {
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        const uint32_t a0 = (w[0][2 * pr] >> (BITS * 2 * j)) & kMask;
        const uint32_t a1 = (w[0][2 * pr + 1] >> (BITS * 2 * j)) & kMask;
        const uint32_t a2 = (w[0][2 * pr] >> (BITS * (2 * j + 1))) & kMask;
        const uint32_t a3 = (w[0][2 * pr + 1] >> (BITS * (2 * j + 1))) & kMask;
#pragma unroll
        for (int mt = 0; mt < NT; ++mt) mma_s8_16832(acc[mt][pr], a0, a1, a2, a3, xb[mt][2 * j], xb[mt][2 * j + 1]);
      }
    }
  };

  auto close = [&](int row) {
    const unsigned char* srow = param_row(pt, 0, ngc, row, lcol, ps);
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float s = param_at(srow, s_type, 2 * pr + half);
#pragma unroll
        for (int mt = 0; mt < NT; ++mt) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * half + r;
            y[mt][pr][e] = fmaf(static_cast<float>(acc[mt][pr][e]), s, y[mt][pr][e]);
            acc[mt][pr][e] = 0;
          }
        }
      }
    }
  };

  // a unit never straddles a group (g % (32 / BITS) == 0): in a step that
  // holds a group end, the lane's unit is in the group being summed or out
  walk_split<P>(full, empty, ring, c, lcol, lane, k0, k1, kc, STEP, UK, g, stage_chunk,
                [&](const uint32_t (&w)[1][4], int ul, int kunit, int lo, int hi, bool masked) {
                  compute(w, ul, !masked || (kunit >= lo && kunit < hi));
                },
                close);
  write_out<NT>(y, c, M, Np, n0 + lcol, vec, part, out, false);
}

// the shared memory of a block: the barriers and the ring; then a chunk's
// x rows (row_bytes each) and parameter table (nf tables)
template <class P>
inline int ring_bytes() {
  return kBarBytes + P::kStages * 4 * ring_row_bytes<P>();
}
inline int chunk_bytes(int M, int row_bytes, int kc, int g, int ps, int nf) {
  return M * row_bytes + nf * groups_of_chunk(kc, g) * kCols * ps;
}

// The chunk (k) a block stages at once: its split's k in whole steps,
// unless its x rows and parameters would pass kXBudget
template <class RowBytes>
inline int chunk_k(int M, int units_per_split, int unit_k, int g, int ps, int nf, RowBytes row_bytes) {
  const int step = 4 * unit_k;
  int kc = (units_per_split + 3) / 4 * step;
  while (kc > step && chunk_bytes(M, row_bytes(kc), kc, g, ps, nf) > kXBudget) kc -= step;
  return kc;
}

template <class P, int NT, bool XF32, bool FUSE>
int launch(int splits, cudaStream_t st, const void* x, const uint32_t* qw, const void* sc, const void* zs,
           int s_type, int zeros, int M, int K, int Np, int g, int ups, int vec, float* part, void* out) {
  static int allowed[kMaxDevices];
  constexpr int es = XF32 ? 4 : 2;
  const int ps = s_type == 0 ? 4 : 2;
  auto rows = [](int kc) { return x_row_bytes<P::kUnitK>(kc, es); };
  const int kc = chunk_k(M, ups, P::kUnitK, g, ps, FUSE ? 2 : 1, rows);
  const int smem = ring_bytes<P>() + chunk_bytes(M, rows(kc), kc, g, ps, FUSE ? 2 : 1);
  auto kern = stacked_mma_kernel<P, NT, XF32, FUSE>;
  const int e = allow_dynamic_smem(kern, smem, allowed);
  if (e != 0) return e;
  const dim3 grid((Np + kCols - 1) / kCols, splits);
  kern<<<grid, kBlock, smem, st>>>(x, qw, sc, zs, s_type, zeros, M, K, Np, g, ups, kc, vec, part, out);
  return 0;
}

template <class P, bool XF32, bool FUSE>
int launch_m(int splits, cudaStream_t st, const void* x, const uint32_t* qw, const void* sc, const void* zs,
             int s_type, int zeros, int M, int K, int Np, int g, int ups, int vec, float* part, void* out) {
  if (M <= 8)
    return launch<P, 1, XF32, FUSE>(splits, st, x, qw, sc, zs, s_type, zeros, M, K, Np, g, ups, vec, part, out);
  if (M <= 16)
    return launch<P, 2, XF32, FUSE>(splits, st, x, qw, sc, zs, s_type, zeros, M, K, Np, g, ups, vec, part, out);
  return launch<P, 4, XF32, FUSE>(splits, st, x, qw, sc, zs, s_type, zeros, M, K, Np, g, ups, vec, part, out);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// the whole launch of the bf16 body for (x type, M): the layer's pointers,
// then the split sum in a second kernel; a cudaError_t
template <class P, bool FUSE>
int run_body(const void* x, int x_f32, const uint32_t* qw, const void* sc, const void* zs, int s_type, int zeros,
             void* part, void* out, int M, int K, int Np, int g, int splits, int ups, cudaStream_t st) {
  const size_t pe = s_type == 0 ? 4 : 2;
  const bool vec = Np % 4 == 0 && aligned16(qw) && (reinterpret_cast<uintptr_t>(sc) % (4 * pe)) == 0 &&
                   (!FUSE || (reinterpret_cast<uintptr_t>(zs) % (4 * pe)) == 0);
  if (!aligned16(x)) return static_cast<int>(cudaErrorMisalignedAddress);
  float* p = splits > 1 ? static_cast<float*>(part) : nullptr;
  const int e = x_f32 ? launch_m<P, true, FUSE>(splits, st, x, qw, sc, zs, s_type, zeros, M, K, Np, g, ups, vec, p, out)
                      : launch_m<P, false, FUSE>(splits, st, x, qw, sc, zs, s_type, zeros, M, K, Np, g, ups, vec, p,
                                                 out);
  if (e != 0) return e;
  if (splits > 1) {
    const int MN = M * Np;
    split_sum_out_kernel<<<(MN + 255) / 256, 256, 0, st>>>(p, splits, MN, FUSE ? 1 : 0, out);
  }
  return qllm_launch_status();
}

// K14 / K16: fused or not, zs prefolded, the split sum in a second kernel
template <class P>
int run(const void* x, int x_f32, const uint32_t* qw, const void* sc, const void* zs, int s_type, void* part,
        void* out, int fused, int M, int K, int Np, int g, int splits, int ups, cudaStream_t st) {
  return fused ? run_body<P, true>(x, x_f32, qw, sc, zs, s_type, 0, part, out, M, K, Np, g, splits, ups, st)
               : run_body<P, false>(x, x_f32, qw, sc, zs, s_type, 0, part, out, M, K, Np, g, splits, ups, st);
}

template <int BITS, int NT>
int launch_s8(int splits, cudaStream_t st, const int8_t* x8, const uint32_t* qw, const void* sc, int s_type, int M,
              int K, int Np, int g, int ups, int vec, float* part, float* out) {
  static int allowed[kMaxDevices];
  using P = GptqOrder<BITS>;
  const int ps = s_type == 0 ? 4 : 2;
  auto rows = [](int kc) { return x8_row_bytes<P::kUnitK>(kc); };
  const int kc = chunk_k(M, ups, P::kUnitK, g, ps, 1, rows);
  const int smem = ring_bytes<P>() + chunk_bytes(M, rows(kc), kc, g, ps, 1);
  auto kern = stacked_s8_kernel<BITS, NT>;
  const int e = allow_dynamic_smem(kern, smem, allowed);
  if (e != 0) return e;
  const dim3 grid((Np + kCols - 1) / kCols, splits);
  kern<<<grid, kBlock, smem, st>>>(x8, qw, sc, s_type, M, K, Np, g, ups, kc, vec, part, out);
  return 0;
}

// K15's whole launch: the int8 body for M, then the split sum in a second
// kernel; a cudaError_t. keep_part (K12): the body writes its partial sums
// to part at any split count and the caller's epilogue adds them
template <int BITS>
int run_s8(const int8_t* x8, const uint32_t* qw, const void* sc, int s_type, void* part, float* out, int M, int K,
           int Np, int g, int splits, int ups, cudaStream_t st, bool keep_part = false) {
  const size_t pe = s_type == 0 ? 4 : 2;
  const bool vec = Np % 4 == 0 && aligned16(qw) && (reinterpret_cast<uintptr_t>(sc) % (4 * pe)) == 0;
  if (!aligned16(x8)) return static_cast<int>(cudaErrorMisalignedAddress);
  float* p = splits > 1 || keep_part ? static_cast<float*>(part) : nullptr;
  const int e = M <= 8 ? launch_s8<BITS, 1>(splits, st, x8, qw, sc, s_type, M, K, Np, g, ups, vec, p, out)
                : M <= 16 ? launch_s8<BITS, 2>(splits, st, x8, qw, sc, s_type, M, K, Np, g, ups, vec, p, out)
                          : launch_s8<BITS, 4>(splits, st, x8, qw, sc, s_type, M, K, Np, g, ups, vec, p, out);
  if (e != 0) return e;
  if (splits > 1 && !keep_part) {
    const int MN = M * Np;
    split_sum_out_kernel<<<(MN + 255) / 256, 256, 0, st>>>(p, splits, MN, 0, out);
  }
  return qllm_launch_status();
}

// ---------------------------------------------------------------------------
// The planar consumer: K1 w4_planar_gemv and K17 w4_planar_f32s_gemv
// (planar_mma_kernel below, one block per 128 columns and split of K along
// gridDim.z, the rows of x as NT n-tiles), K8 w4_grouped_gemv (its own
// kernel, csrc/grouped_mma.cu, a run of selections as the rows) and K20
// w4_pnp_gemv (csrc/fused_mlp.cu: persistent blocks take item after item,
// the ring's stages counted on from one to the next).
//
// Planar words as the A operand (the Planar policy): GptqOrder<4>::pair(s)
// of a word row r is the bf16 pair 128 + q of k (4r + j, 4r + j + 2), j =
// s / 2, of the low half of K for s even and of the high half for s odd.
// So a step runs one m16n8k16 MMA per half (pairs s = h and h + 2) into an
// accumulator set per half, with a ones-MMA per half for sum x: the low
// half's k lie in group gl and the high half's in G/2 + gl, which close at
// the same word row since (K/2) % g == 0. A lane stages x of its unit as
// [x[4r .. 4r+3] | x[K/2 + 4r .. +3]]. At a group's end, for each half,
// dot = acc - 128 sum x, y += dot * s (- sum x * zs when fused). A step
// whose k hold a group's end runs once per group it touches, the other
// groups' x zeroed one value at a time (any g with (K/2) % g == 0).
// With the norm (K1), x~ = x * w in f32 (w the norm weight, staged as f32
// once a chunk) enters as exact bf16 parts (split3; two of them hold it
// when w is bf16), each run on the same A; the row factor rsqrt(mean(x^2)
// + eps) is planar_out_kernel's. K20's second product takes an f32 x as
// its three exact bf16 parts, split once by K20 and stored planar-
// interleaved (kXParts3): three tile rows an x row, each run on the same A.
//
// Its int8 twin, planar_s8_kernel (K11 w4a8_planar_gemv, csrc/w4a8.cu),
// is at the end.
// ---------------------------------------------------------------------------

// bytes of a staged x row of `units` units (16 bytes each); the pad puts
// rows 2i and 2i + 1 in the two halves of the banks
__host__ __device__ inline int planar_x_row_bytes(int units) { return (units * 16 + 127) / 128 * 128 + 64; }
// bytes of a chunk of `units` units: M x rows (tile rows), the norm weight
// (32 bytes a unit) and the parameter tables, nf (scales, and zs when
// fused) of ps bytes for each half
__host__ __device__ inline int planar_chunk_bytes(int M, int units, int g, int nf, int ps, bool norm) {
  return M * planar_x_row_bytes(units) + (norm ? 32 * units : 0) + 2 * nf * groups_of_chunk(4 * units, g) * kCols * ps;
}
// the units a block stages at once: its split's in whole steps (4 units),
// unless its x rows, norm weight and parameters would pass `budget`
inline int planar_chunk_units(int M, int units_per_split, int g, int nf, int ps, bool norm, int budget = kXBudget) {
  int kc = (units_per_split + 3) / 4 * 4;
  while (kc > 4 && planar_chunk_bytes(M, kc, g, nf, ps, norm) > budget) kc -= 4;
  return kc;
}
// splits of `per` units that cover `units`, none empty (a grid's z)
inline bool split_plan_ok(int units, int splits, int per) {
  return splits >= 1 && splits <= 65535 && per >= 1 && static_cast<long long>(splits) * per >= units &&
         static_cast<long long>(splits - 1) * per < units;
}

// The parts a planar consumer takes x in: 1, x in bf16 (no norm); with the
// norm, x~ = x * w in f32 as bf16 parts hi + mid (+ lo): a bf16 x times a
// bf16 w has at most 16 significant bits, which hi and mid hold exactly
// (lo would be 0), a product with an f32 w needs all three; kXParts3: the
// three parts of an f32 x, given as three bf16 rows [M][3][K] planar-
// interleaved (row r's unit u at r K + 8 u: x[4u .. 4u+3], x[K/2 + 4u ..]);
// kXRows3: the same three rows of one x row (M = 1, K19) as B rows 0-2 of
// a single MMA, each row's products exact, the rows added at the store as
// (hi + mid) + lo: one MMA on each A where kXParts3 runs three
enum : int { kXBf16 = 1, kNormBf16 = 2, kNormF32 = 3, kXParts3 = 4, kXRows3 = 5 };
// tile rows an x row takes, and the MMAs a product runs on each A
__host__ __device__ constexpr int staged_parts(int xp) { return xp == kXParts3 || xp == kXRows3 ? 3 : 1; }
__host__ __device__ constexpr int mma_parts(int xp) { return xp == kXParts3 ? 3 : xp == kXRows3 ? 1 : xp; }

// A planar consumer's rows: y[mt][pr][e] is column ncol + 2pr + (e >> 1),
// row 8 mt + 2c + (e & 1); to prt (the split's f32 partial sums, [M, Np])
// if given, else to o ([M, Np], bf16 or f32) times rs[m] when rs is given
template <int NT>
__device__ __forceinline__ void planar_store(const float (&y)[NT][2][4], int M, int Np, int ncol,
                                             float* __restrict__ prt, void* __restrict__ o, bool out_bf16,
                                             const float* rs) {
  const int c = threadIdx.x & 3;
  if (ncol >= Np) return;  // Np % 4 == 0: a lane's four columns are in range or not
#pragma unroll
  for (int mt = 0; mt < NT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = mt * 8 + 2 * c + r;
      if (m >= M) continue;
      const float f = prt == nullptr && rs != nullptr ? rs[m] : 1.f;
      const float v[4] = {y[mt][0][r] * f, y[mt][0][2 + r] * f, y[mt][1][r] * f, y[mt][1][2 + r] * f};
      const size_t at = static_cast<size_t>(m) * Np + ncol;
      if (prt != nullptr || !out_bf16)
        *reinterpret_cast<float4*>((prt != nullptr ? prt : static_cast<float*>(o)) + at) =
            make_float4(v[0], v[1], v[2], v[3]);
      else
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(o) + at) =
            make_uint2(bf16x2_bits(__floats2bfloat162_rn(v[0], v[1])), bf16x2_bits(__floats2bfloat162_rn(v[2], v[3])));
    }
  }
}

// The consumer warps' whole part of a planar block: units [u0, u1) of the
// layer (word rows), columns n0 .. n0 + kCols, M <= 8 NT rows of x (row m
// at x + m * x_stride; stride 0: one row for all; kXParts3: tile row r at
// x + r * x_stride), chunks of kc units staged at xt. FUSE: bf16 scales
// and zs [G, Np] (the zero-point term in the kernel), bf16 out; else f32
// scales, f32 out. XP: kXBf16, the norm x~ = x * nw with nw [K] bf16
// (kNormBf16) or f32 (kNormF32), kXParts3, or kXRows3 (M = 1). Writes the rows to prt (the
// split's f32 partial sums, [M, Np]) if given, else to o ([M, Np]), times
// rs[m] when rs is given. t0 and the result: the ring's stages taken.
template <int NT, int XP, bool FUSE>
__device__ __forceinline__ int planar_consume(uint64_t* full, uint64_t* empty, const unsigned char* ring,
                                              unsigned char* xt, const __nv_bfloat16* __restrict__ x,
                                              size_t x_stride, const void* __restrict__ nw,
                                              const void* __restrict__ sc, const void* __restrict__ zs, int M,
                                              int K, int Np, int g, int n0, int u0, int u1, int kc,
                                              float* __restrict__ prt, void* __restrict__ o,
                                              const float* rs = nullptr, int t0 = 0) {
  constexpr bool NORM = XP == kNormBf16 || XP == kNormF32;
  constexpr int SP = staged_parts(XP), MP = mma_parts(XP);
  constexpr int LP = XP == kXRows3 ? 1 : SP;  // tile rows a lane loads for its B row
  static_assert(XP != kXRows3 || NT == 1, "kXRows3 takes one x row");
  constexpr int NF = FUSE ? 2 : 1;  // parameter tables of each half: the scales (and zs)
  constexpr int PS = FUSE ? 2 : 4;  // bytes of a parameter
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, c = lane & 3;
  const int lcol = warp * 32 + 4 * gq;  // the lane's first column in the block
  const int Kh = K / 2, Gh = K / g / 2;
  const int rb = planar_x_row_bytes(kc);
  const int ngc = groups_of_chunk(4 * kc, g);
  float* wt = reinterpret_cast<float*>(xt + SP * M * rb);       // NORM: [kc units][low 4 | high 4] f32
  unsigned char* pt = xt + SP * M * rb + (NORM ? 32 * kc : 0);  // [half][NF][ngc][kCols]

  // x of units [c0, c1) into the tile (zero past c1 up to a whole step),
  // the norm weight's, and the parameters of every group the chunk touches
  // in both halves
  auto stage_chunk = [&](int c0, int c1) {
    const int gf = 4 * c0 / g, ng = (4 * c1 - 1) / g - gf + 1;
    stage_params(pt, sc, zs, NF, ngc, gf, ng, n0, Np, PS, 1);
    stage_params(param_row(pt, NF, ngc, 0, 0, PS), sc, zs, NF, ngc, Gh + gf, ng, n0, Np, PS, 1);
    const int U = (c1 - c0 + 3) / 4 * 4;
    if constexpr (SP == 3) {  // whole units, 16 bytes each, through L2 (written by this launch)
      for (int i = threadIdx.x; i < 3 * M * U; i += kThreads) {
        const int r = i / U, ul = i - r * U, u = c0 + ul;
        const bool on = u < c1;
        cp_async16(xt + r * rb + ul * 16, on ? x + r * x_stride + 8 * u : x, on);
      }
    } else {
      for (int i = threadIdx.x; i < M * 2 * U; i += kThreads) {
        const int m = i / (2 * U), r = i - m * 2 * U;
        const int ul = r >> 1, half = r & 1, u = c0 + ul;
        const bool on = u < c1;
        cp_async8(xt + m * rb + ul * 16 + 8 * half, on ? x + m * x_stride + half * Kh + 4 * u : x, on);
      }
    }
    if constexpr (NORM) {
      for (int i = threadIdx.x; i < 2 * U; i += kThreads) {
        const int ul = i >> 1, half = i & 1, u = c0 + ul, k = half * Kh + 4 * u;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (u < c1 && XP == kNormF32) {
          v = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(nw) + k));
        } else if (u < c1) {
          const uint2 b = __ldg(reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(nw) + k));
          v = make_float4(__uint_as_float(b.x << 16), __uint_as_float(b.x & 0xFFFF0000u), __uint_as_float(b.y << 16),
                          __uint_as_float(b.y & 0xFFFF0000u));
        }
        *reinterpret_cast<float4*>(wt + 8 * ul + 4 * half) = v;
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    consumers_sync();
  };

  // acc[mt][half]: sum (128 + q) x of the open group; xs[mt][half]: sum x
  // (the ones MMA); y: the closed groups. y[mt][pr][e] is column lcol + 2pr
  // + (e >> 1), row 8 mt + 2c + (e & 1)
  float acc[NT][2][2][4], xs[NT][2][4], y[NT][2][4];
#pragma unroll
  for (int mt = 0; mt < NT; ++mt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      y[mt][0][e] = y[mt][1][e] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) acc[mt][h][0][e] = acc[mt][h][1][e] = xs[mt][h][e] = 0.f;
    }
  }

  // one step's products of this lane's unit ul (at k kunit of each half);
  // masked: only the k in [lo, hi) of each half
  auto compute = [&](const uint32_t (&w)[1][4], int ul, int kunit, int lo, int hi, bool masked) {
    bool in[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) in[j] = !masked || (kunit + j >= lo && kunit + j < hi);
    // B lanes (k0, k2) and (k1, k3)
    const uint32_t m0 = (in[0] ? 0x0000FFFFu : 0u) | (in[2] ? 0xFFFF0000u : 0u);
    const uint32_t m1 = (in[1] ? 0x0000FFFFu : 0u) | (in[3] ? 0xFFFF0000u : 0u);
    // A rows gq / gq + 8: columns 2pr / 2pr + 1; k slots 2c.. pair h, 2c + 8.. pair h + 2
    const uint32_t none[2] = {0u, 0u};
    uint32_t a[2][2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        a[h][pr][0] = GptqOrder<4>::pair(w, none, 2 * pr, h, 0);
        a[h][pr][1] = GptqOrder<4>::pair(w, none, 2 * pr + 1, h, 0);
        a[h][pr][2] = GptqOrder<4>::pair(w, none, 2 * pr, h + 2, 0);
        a[h][pr][3] = GptqOrder<4>::pair(w, none, 2 * pr + 1, h + 2, 0);
      }
    }
    float4 wn[2];
    if constexpr (NORM) {
      wn[0] = *reinterpret_cast<const float4*>(wt + 8 * ul);
      wn[1] = *reinterpret_cast<const float4*>(wt + 8 * ul + 4);
    }
#pragma unroll
    for (int mt = 0; mt < NT; ++mt) {
      const int m = mt * 8 + gq;
      uint4 v[LP];
      if constexpr (XP == kXRows3) {  // B row gq: part gq of the one x row
        v[0] = gq < 3 ? *reinterpret_cast<const uint4*>(xt + gq * rb + ul * 16) : make_uint4(0u, 0u, 0u, 0u);
      } else {
#pragma unroll
        for (int q = 0; q < SP; ++q)
          v[q] = m < M ? *reinterpret_cast<const uint4*>(xt + (SP * m + q) * rb + ul * 16) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t b0[3], b1[3];  // B registers of each part
        if constexpr (!NORM) {
#pragma unroll
          for (int q = 0; q < LP; ++q) {
            const uint32_t a01 = h ? v[q].z : v[q].x, a23 = h ? v[q].w : v[q].y;  // x (k0, k1), (k2, k3) of half h
            b0[q] = __byte_perm(a01, a23, 0x5410) & m0;
            b1[q] = __byte_perm(a01, a23, 0x7632) & m1;
          }
        } else {
          // x~ of k0..k3 in f32, the other groups' zeroed, as parts (k0, k2) and (k1, k3)
          const uint32_t a01 = h ? v[0].z : v[0].x, a23 = h ? v[0].w : v[0].y;
          const float4 wv = wn[h];
          split3(in[0] ? __uint_as_float(a01 << 16) * wv.x : 0.f, in[2] ? __uint_as_float(a23 << 16) * wv.z : 0.f, b0);
          split3(in[1] ? __uint_as_float(a01 & 0xFFFF0000u) * wv.y : 0.f,
                 in[3] ? __uint_as_float(a23 & 0xFFFF0000u) * wv.w : 0.f, b1);
        }
#pragma unroll
        for (int q = 0; q < MP; ++q) {
#pragma unroll
          for (int pr = 0; pr < 2; ++pr)
            mma_bf16_16816(acc[mt][h][pr], a[h][pr][0], a[h][pr][1], a[h][pr][2], a[h][pr][3], b0[q], b1[q]);
          mma_bf16_16816(xs[mt][h], kOnes, kOnes, kOnes, kOnes, b0[q], b1[q]);
        }
      }
    }
  };

  // close the open group of each half (the low half's row `row` of the
  // chunk's tables, the high half's, Gh groups on, row `row` of its own)
  auto close = [&](int row) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned char* srow = param_row(pt, NF * h, ngc, row, lcol, PS);
      const unsigned char* zrow = param_row(pt, NF * h + NF - 1, ngc, row, lcol, PS);
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = 2 * pr + half;
          const float s = param_at(srow, FUSE ? 2 : 0, col);
          const float z = FUSE ? param_at(zrow, 2, col) : 0.f;
#pragma unroll
          for (int mt = 0; mt < NT; ++mt) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int e = 2 * half + r;
              const float dot = fmaf(-128.f, xs[mt][h][r], acc[mt][h][pr][e]);
              const float t = fmaf(dot, s, y[mt][pr][e]);
              y[mt][pr][e] = FUSE ? fmaf(-xs[mt][h][r], z, t) : t;
              acc[mt][h][pr][e] = 0.f;
            }
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < NT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) xs[mt][h][e] = 0.f;
    }
  };

  // the body's walk on the k of each half (4 a unit), chunks of kc units
  const int t = walk_split<Planar>(full, empty, ring, c, lcol, lane, 4 * u0, 4 * u1, 4 * kc, 16, 4, g,
                                   [&](int ch0, int ch1) { stage_chunk(ch0 / 4, ch1 / 4); }, compute, close, t0);
  if constexpr (XP == kXRows3) {  // row 0 = (hi + mid) + lo: C rows 0 and 1 in lane c = 0, row 2 in lane c = 1
#pragma unroll
    for (int pr = 0; pr < 2; ++pr)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float lo = __shfl_down_sync(0xffffffffu, y[0][pr][2 * j], 1);
        y[0][pr][2 * j] = (y[0][pr][2 * j] + y[0][pr][2 * j + 1]) + lo;
      }
  }
  planar_store<NT>(y, XP == kXRows3 ? 1 : M, Np, n0 + lcol, prt, o, FUSE, rs);
  return t;
}

// K1 (FUSE: bf16 scales and zs, bf16 out; XP: the fused RMSNorm, f32
// partial sums always) and K17 (f32 scales, f32 out): one block per (128
// columns, split of K of units_per_split word rows along gridDim.z). Blocks
// an SM the registers leave room for: at 4 n-tiles one, so that the
// accumulators of both halves do not spill (two fit by what they use)
template <int NT, int XP, bool FUSE>
__global__ void __launch_bounds__(kBlock, NT == 1 ? 4 : NT == 2 ? 2 : 1)
    planar_mma_kernel(const __nv_bfloat16* __restrict__ x,              // [M, K]
                      const uint32_t* __restrict__ qw,                  // [K/8, Np] the layer's words
                      const void* __restrict__ sc, const void* __restrict__ zs,  // [G, Np]
                      const void* __restrict__ nw,                      // [K] the norm weight (XP > 1)
                      int M, int K, int Np, int g, int units_per_split, int kc,
                      float* __restrict__ part,   // [splits, M, Np] when split (the norm: always)
                      void* __restrict__ out) {   // [M, Np] when not
  constexpr int S = Planar::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S;
  unsigned char* ring = smem + kBarBytes;
  const int W = K / 8, n0 = blockIdx.x * kCols;
  const int u0 = blockIdx.z * units_per_split, u1 = min(W, u0 + units_per_split);
  constexpr int kCopy = NT == 4 ? kCopyBulk : kCopyLanes;  // one block an SM at four n-tiles
  init_ring<S>(full, empty, kCopy == kCopyBulk);
  if ((threadIdx.x >> 5) == kWarps) {
    produce<Planar>(qw, full, empty, ring, threadIdx.x & 31, n0, Np, u0, u1, W, kCopy);
    return;
  }
  planar_consume<NT, XP, FUSE>(full, empty, ring, ring + S * 4 * ring_row_bytes<Planar>(), x, K, nw, sc, zs, M, K, Np,
                               g, n0, u0, u1, kc,
                               part != nullptr ? part + static_cast<size_t>(blockIdx.z) * M * Np : nullptr, out);
}

// The planar GEMVs' second kernel: y[m, n] = r_m * sum_s part[s, m, n] in
// split order, as OutT (K1 and K11 bf16, K17 f32), with r_m = rsqrt(sum_k
// x[m, k]^2 / K + eps) when x is given (K1's norm), rs[m] when rs is given
// (K11's token scale), else 1. Block (i, m) takes columns [256 i, 256 (i +
// 1)) of row m and sums the row's squares itself, the same way at any M.
// Static: each source that launches it has its own
template <class OutT>
static __global__ void __launch_bounds__(256)
    planar_out_kernel(const float* __restrict__ part, int splits, int M, int Np, const __nv_bfloat16* __restrict__ x,
                      int K, float eps, const float* __restrict__ rs, OutT* __restrict__ out) {
  const int m = blockIdx.y, n = blockIdx.x * 256 + threadIdx.x;
  const size_t MN = static_cast<size_t>(M) * Np, i = static_cast<size_t>(m) * Np + n;
  float acc = 0.f;
  if (n < Np) {
#pragma unroll 4
    for (int s = 0; s < splits; ++s) acc += part[s * MN + i];
  }
  if (x != nullptr) {  // uniform across the block
    __shared__ float red[8];
    const __nv_bfloat16* xr = x + static_cast<size_t>(m) * K;
    float sq = 0.f;
    for (int k = 8 * threadIdx.x; k < K; k += 8 * 256) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(xr + k));
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float lo = __uint_as_float(w[j] << 16), hi = __uint_as_float(w[j] & 0xFFFF0000u);
        sq = fmaf(hi, hi, fmaf(lo, lo, sq));
      }
    }
    sq = warp_sum(sq);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = sq;
    __syncthreads();
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) q += red[j];
    acc *= rsqrtf(q * (1.0f / static_cast<float>(K)) + eps);
  }
  if (rs != nullptr) acc *= __ldg(rs + m);
  if (n >= Np) return;
  if constexpr (std::is_same<OutT, float>::value)
    out[i] = acc;
  else
    out[i] = __float2bfloat16_rn(acc);
}

template <int NT, int XP, bool FUSE>
int launch_planar(int splits, cudaStream_t st, const __nv_bfloat16* x, const uint32_t* qw, const void* sc,
                  const void* zs, const void* nw, int M, int K, int Np, int g, int ups, float* part, void* out) {
  static int allowed[kMaxDevices];
  constexpr int nf = FUSE ? 2 : 1, ps = FUSE ? 2 : 4;
  const int kc = planar_chunk_units(M, ups, g, nf, ps, XP != kXBf16);
  const int smem = ring_bytes<Planar>() + planar_chunk_bytes(M, kc, g, nf, ps, XP != kXBf16);
  auto kern = planar_mma_kernel<NT, XP, FUSE>;
  if (const int e = allow_dynamic_smem(kern, smem, allowed)) return e;
  kern<<<dim3((Np + kCols - 1) / kCols, 1, splits), kBlock, smem, st>>>(x, qw, sc, zs, nw, M, K, Np, g, ups, kc, part,
                                                                         out);
  return 0;
}

// The whole K1 / K17 launch: the body for M (1, 2 or 4 n-tiles), then, if
// K is split or the norm is on, planar_out_kernel; a cudaError_t. part:
// [splits, M, Np] f32 (unused when neither)
template <bool FUSE>
int run_planar(const __nv_bfloat16* x, const uint32_t* qw, const void* sc, const void* zs, const void* nw, int nw_f32,
               float eps, float* part, void* out, int M, int K, int Np, int g, int splits, int ups, cudaStream_t st) {
  const int xp = !FUSE || nw == nullptr ? kXBf16 : nw_f32 ? kNormF32 : kNormBf16;
  float* p = splits > 1 || xp != kXBf16 ? part : nullptr;
  auto launch_m = [&](auto xp_tag) {
    constexpr int XP = decltype(xp_tag)::value;
    return M <= 8    ? launch_planar<1, XP, FUSE>(splits, st, x, qw, sc, zs, nw, M, K, Np, g, ups, p, out)
           : M <= 16 ? launch_planar<2, XP, FUSE>(splits, st, x, qw, sc, zs, nw, M, K, Np, g, ups, p, out)
                     : launch_planar<4, XP, FUSE>(splits, st, x, qw, sc, zs, nw, M, K, Np, g, ups, p, out);
  };
  int e;
  if constexpr (FUSE)
    e = xp == kNormF32   ? launch_m(std::integral_constant<int, kNormF32>{})
        : xp == kNormBf16 ? launch_m(std::integral_constant<int, kNormBf16>{})
                          : launch_m(std::integral_constant<int, kXBf16>{});
  else
    e = launch_m(std::integral_constant<int, kXBf16>{});
  if (e != 0) return e;
  using OutT = typename std::conditional<FUSE, __nv_bfloat16, float>::type;
  if (p != nullptr)
    planar_out_kernel<OutT><<<dim3((Np + 255) / 256, M), 256, 0, st>>>(p, splits, M, Np, xp != kXBf16 ? x : nullptr, K,
                                                                       eps, nullptr, static_cast<OutT*>(out));
  return qllm_launch_status();
}

// ---------------------------------------------------------------------------
// K11's int8 twin of the planar consumer (planar_s8_kernel): the
// quantizer's x8 against the planar nibbles on mma.sync m16n8k16 s8 with
// s32 accumulators, one block per (128 columns, split of K along
// gridDim.z), the rows of x8 as NT n-tiles. A planar word masked with
// 0x0F0F0F0F is four s8 values of k = 4r .. 4r + 3 of the low half, and its
// high nibbles are the same k of the high half: lane c's word row of a
// stage fills A's k slots 4c .. 4c + 3 (rows gq / gq + 8: columns 2pr /
// 2pr + 1) with no conversion, and x8 staged at the same k (a row's low
// half's bytes, then its high half's) is B. One MMA per half into its own
// accumulator set, as the bf16 consumer keeps them; one m16n8k32 MMA with
// A rows gq ones on k 0..15 and rows gq + 8 ones on k 16..31, against
// (low, high), gives both halves' sum x8 of each row in the C layout. At a
// group's end, y += d * s - sum(x8) * zs (d an exact s32 dot, y f32); a
// step that holds a group's end runs once per group it touches, the other
// groups' bytes of B zeroed. K is split by whole 4-row steps (x8 is staged
// by 16-byte copies) from (K, Np) alone, so a row's bits do not depend on
// M; the rows are written as bf16(sx * y), or as partial sums that
// planar_out_kernel adds in split order and scales by sx.
// ---------------------------------------------------------------------------

// bytes of a staged x8 row of kc units (kc % 4 == 0): the low half's 4 kc
// bytes, then the high half's; the pad puts rows 0..7 in distinct 16-byte
// bank groups
__host__ __device__ inline int planar_x8_row_bytes(int kc) { return (8 * kc + 127) / 128 * 128 + 16; }
// a chunk's x8 rows and both halves' bf16 scales and zs
__host__ __device__ inline int planar_s8_chunk_bytes(int M, int kc, int g) {
  return M * planar_x8_row_bytes(kc) + 2 * 2 * groups_of_chunk(4 * kc, g) * kCols * 2;
}

template <int NT>
__global__ void __launch_bounds__(kBlock, NT == 1 ? 4 : 2)
    planar_s8_kernel(const int8_t* __restrict__ x8,      // [M, K]
                     const float* __restrict__ sx,       // [M]
                     const uint32_t* __restrict__ qw,    // [K/8, Np] the layer's words
                     const __nv_bfloat16* __restrict__ sc, const __nv_bfloat16* __restrict__ zs,  // [G, Np]
                     int M, int K, int Np, int g, int units_per_split, int kc,
                     float* __restrict__ part,            // [splits, M, Np] when split
                     __nv_bfloat16* __restrict__ out) {   // [M, Np] when not
  constexpr int S = Planar::kStages;
  constexpr uint32_t kLow = 0x0F0F0F0Fu, kOnes8 = 0x01010101u;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S;
  unsigned char* ring = smem + kBarBytes;
  const int W = K / 8, n0 = blockIdx.x * kCols;
  const int u0 = blockIdx.z * units_per_split, u1 = min(W, u0 + units_per_split);
  init_ring<S>(full, empty, false);
  if ((threadIdx.x >> 5) == kWarps) {
    produce<Planar>(qw, full, empty, ring, threadIdx.x & 31, n0, Np, u0, u1, W, kCopyLanes);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, c = lane & 3;
  const int lcol = warp * 32 + 4 * gq;
  const int Kh = K / 2, Gh = K / g / 2;
  const int rb = planar_x8_row_bytes(kc), hb = 4 * kc;  // a row's bytes; the high half's offset in it
  const int ngc = groups_of_chunk(4 * kc, g);
  unsigned char* xt = ring + S * 4 * ring_row_bytes<Planar>();
  unsigned char* pt = xt + M * rb;  // [half][scales, zs][ngc][kCols] bf16

  // x8 of units [c0, c1) (whole steps) of both halves into the tile, and
  // both halves' scales and zs of every group the chunk touches
  auto stage_chunk = [&](int c0, int c1) {
    const int gf = 4 * c0 / g, ng = (4 * c1 - 1) / g - gf + 1;
    stage_params(pt, sc, zs, 2, ngc, gf, ng, n0, Np, 2, 1);
    stage_params(param_row(pt, 2, ngc, 0, 0, 2), sc, zs, 2, ngc, Gh + gf, ng, n0, Np, 2, 1);
    const int Q = (c1 - c0) / 4;  // 16-byte pieces of a half
    for (int i = threadIdx.x; i < M * 2 * Q; i += kThreads) {
      const int m = i / (2 * Q), r = i - m * 2 * Q, half = r / Q, j = r - half * Q;
      cp_async16(xt + m * rb + half * hb + 16 * j, x8 + static_cast<size_t>(m) * K + half * Kh + 4 * c0 + 16 * j, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    consumers_sync();
  };

  // acc[mt][half]: the open group's dot; xs[mt]: its sum x8, rows 2c, 2c + 1
  // of the low half, then of the high; y: the closed groups
  int acc[NT][2][2][4], xs[NT][4];
  float y[NT][2][4];
#pragma unroll
  for (int mt = 0; mt < NT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      xs[mt][e] = 0;
      y[mt][0][e] = y[mt][1][e] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) acc[mt][h][0][e] = acc[mt][h][1][e] = 0;
    }

  auto compute = [&](const uint32_t (&w)[1][4], int ul, int kunit, int lo, int hi, bool masked) {
    uint32_t keep = 0xFFFFFFFFu;  // the bytes of B in the group being summed
    if (masked) {
      keep = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) keep |= (kunit + j >= lo && kunit + j < hi ? 0xFFu : 0u) << (8 * j);
    }
    uint32_t a[2][2][2];  // [half][pr][column 2pr, 2pr + 1]
#pragma unroll
    for (int pr = 0; pr < 2; ++pr)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[0][pr][i] = w[0][2 * pr + i] & kLow;
        a[1][pr][i] = (w[0][2 * pr + i] >> 4) & kLow;
      }
#pragma unroll
    for (int mt = 0; mt < NT; ++mt) {
      const int m = mt * 8 + gq;
      const unsigned char* xr = xt + m * rb + 4 * ul;
      const uint32_t b[2] = {m < M ? *reinterpret_cast<const uint32_t*>(xr) & keep : 0u,
                             m < M ? *reinterpret_cast<const uint32_t*>(xr + hb) & keep : 0u};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) mma_s8_16816(acc[mt][h][pr], a[h][pr][0], a[h][pr][1], b[h]);
      mma_s8_16832(xs[mt], kOnes8, 0u, 0u, kOnes8, b[0], b[1]);
    }
  };

  auto close = [&](int row) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned char* srow = param_row(pt, 2 * h, ngc, row, lcol, 2);
      const unsigned char* zrow = param_row(pt, 2 * h + 1, ngc, row, lcol, 2);
#pragma unroll
      for (int pr = 0; pr < 2; ++pr)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float s = param_at(srow, 2, 2 * pr + half), z = param_at(zrow, 2, 2 * pr + half);
#pragma unroll
          for (int mt = 0; mt < NT; ++mt)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int e = 2 * half + r;
              const float t = fmaf(static_cast<float>(acc[mt][h][pr][e]), s, y[mt][pr][e]);
              y[mt][pr][e] = fmaf(-static_cast<float>(xs[mt][2 * h + r]), z, t);
              acc[mt][h][pr][e] = 0;
            }
        }
    }
#pragma unroll
    for (int mt = 0; mt < NT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[mt][e] = 0;
  };

  walk_split<Planar>(full, empty, ring, c, lcol, lane, 4 * u0, 4 * u1, 4 * kc, 16, 4, g,
                     [&](int ch0, int ch1) { stage_chunk(ch0 / 4, ch1 / 4); }, compute, close);
  planar_store<NT>(y, M, Np, n0 + lcol, part != nullptr ? part + static_cast<size_t>(blockIdx.z) * M * Np : nullptr,
                   out, true, sx);
}

}  // namespace stacked_mma
