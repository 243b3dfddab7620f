// The tensor-core body shared by K14 gptq_stacked_gemv (csrc/gptq_stacked.cu)
// and K16 bitplane_stacked_gemv (csrc/bitplane.cu): the decode matmul
// (M <= 32) on one layer of an [L]-stacked 2/4-bit GPTQ-order or
// 3/5/6/7-bit bit-plane weight, with x in bf16 or f32. With q the unsigned
// field, both compute
//   unfused: y[m, n] = sum_g s_g[n] * (x_g . q_g[:, n]), f32 out (the
//            caller takes off xsum_g @ zs_g outside, as JAX does);
//   fused:   y[m, n] = sum_g (s_g[n] * (x_g . q_g[:, n]) - sum(x_g) * zs_g[n]),
//            rounded to bf16,
// as the TPU kernels do: an f32 dot per group, scaled at the group's end.
//
// Bound on the H100: bytes (the layer's words, scales and zs, read once).
// The dots run on the tensor cores: mma.sync m16n8k16 bf16 with f32
// accumulators, 16 output columns as the A operand and 8 rows of x as the
// B operand (the swapped product of K1, planar_gemv.cuh). A field q is
// OR-ed into the mantissa of 128.0: the bf16 value 128 + q, exact (q <
// 128), with no conversion and no subtraction. A bf16 x is exact too, so
// every product is exact; the MMA sums (128 + q) x in f32, and a second
// MMA with A all ones sums x over the same k (the group sum: masked and
// ordered like the dot). At the group's end, dot = sum (128 + q) x - 128 *
// sum x, then y += dot * s (- sum x * zs when fused). An f32 x is split
// into three bf16 parts hi + mid + lo, which hold its 24 bits (outside
// subnormals), and each part runs its own MMAs on the same A.
//
// Layout. The order of k inside one MMA is free as long as A and B agree,
// and so is the order of the output columns inside a tile. A lane (gq =
// lane / 4, c = lane % 4) owns 4 adjacent columns and, in each step, one
// "unit" of the weight: a word row of 32/bits k (K14) or a word index of
// 32 k in every bit plane (K16); the four lanes of a quad take four
// consecutive units (rows of the stage). The unit's k are paired
// (k_a, k_b) so that a shift and a mask (K14) or a byte permute of the
// plane sum (K16) give the bf16 pair; columns n + 2i and n + 2i + 1 are A
// rows gq and gq + 8 of one MMA, and the lane reads x for its B registers
// from a tile in shared memory at the k its own fields hold.
//
// Groups close as the JAX kernels close them: an f32 accumulator per
// group, y += acc * s (- xsum * zs) at its end. A step whose k span holds
// a group end runs once per group it touches, with the other groups' k
// zeroed in B (as K18 does). K is split over gridDim.y by a count
// the wrapper takes from K and N alone, each split writes its partial
// sums and split_sum_out_kernel adds them in split order, so a row's bits
// depend neither on M nor on the other rows nor on the run.
//
// Bytes in flight: a producer warp keeps the next S steps' weight rows of
// the block in a ring in shared memory, one bulk copy (cp.async.bulk, the
// copy engine of TMA) a row and plane (4-byte cp.async by its 32 lanes
// when Np % 4 != 0), each stage's arrival and release tracked by a pair of
// mbarriers, so the four consumer warps spend no issue slots on loads and
// do not wait for them (a ring filled by the consumers' own cp.async held
// K14 at twice this time: their loads and products did not overlap); the
// block's x tile and its scales (and zs) are staged by the consumers'
// cp.async once per chunk of its split (one chunk unless they would pass
// kXBudget).
#pragma once

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

// K14's words: word row r holds k = r * pf + f at bit offset bits * f; pair
// s (s < pf / 2) is fields (s, s + pf / 2), which one shift and one mask
// place in the two halves of a word
template <int BITS>
struct GptqOrder {
  static constexpr int kUnitK = 32 / BITS;
  static constexpr int kHalf = kUnitK;  // a half of kHalf k holds pairs (s, s + kHalf / 2)
  static constexpr int kPlanes = 1;
  static constexpr int kStages = 8;
  // the blocks an SM the registers must leave room for (__launch_bounds__),
  // n-tiles by n-tiles, as measured fastest on the H100
  __host__ __device__ static constexpr int min_blocks(int nt) { return nt == 1 ? 4 : 2; }
  __device__ static size_t row(int, int unit, int) { return static_cast<size_t>(unit); }
  // the material a pair needs (none: the word itself)
  __device__ static void material(const uint32_t (&)[kPlanes][4], int, int, uint32_t (&)[2]) {}
  // pair s of column col as bf16 (128 + q_a, 128 + q_b)
  __device__ static uint32_t pair(const uint32_t (&w)[kPlanes][4], const uint32_t (&)[2], int col, int s) {
    constexpr uint32_t m = (1u << BITS) - 1u;
    return and_or<m | (m << 16)>(w[0][col] >> (BITS * s), 0x43004300u);
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
  __device__ static uint32_t pair(const uint32_t (&)[kPlanes][4], const uint32_t (&v)[2], int, int s) {
    return __byte_perm(v[s & 1], 0x43434343u, s < 8 ? 0x4140 : 0x4342);
  }
};

// The x tile: row m of a chunk at m * row_bytes, unit u at u * kUnitK *
// esize, its 16-byte pieces j at 16 * (j ^ swizzle(u)); the row pitch
// and the swizzle keep the lanes' 16-byte reads of one B load in distinct
// bank groups for bf16 x
template <int UNIT_K>
__host__ __device__ inline int x_row_bytes(int kc, int esize) {
  const int pieces = UNIT_K * esize / 16;
  const int off = esize == 2 ? (pieces == 1 ? 4 : pieces == 2 ? 1 : 2) : 1;
  return (kc * esize + 127) / 128 * 128 + 16 * off;
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

// P: GptqOrder<BITS> or BitPlane<BITS>; NT: n-tiles of 8 rows of x (M <=
// 8 NT); XF32: x stored f32 (three MMAs a product); FUSE: the zero-point
// term in the kernel, bf16 out. units_per_split: units (word rows / word
// indices) of each split; kc: k staged per chunk (a multiple of 4 units);
// vec: Np % 4 == 0 and every pointer 16-byte aligned
template <class P, int NT, bool XF32, bool FUSE>
__global__ void __launch_bounds__(kBlock, P::min_blocks(NT))
    stacked_mma_kernel(const void* __restrict__ x,        // [M, K]
                       const uint32_t* __restrict__ qw,   // the layer's words
                       const void* __restrict__ sc, const void* __restrict__ zs, int s_type,  // [G, Np]
                       int M, int K, int Np, int g, int units_per_split, int kc, int vec,
                       float* __restrict__ part,   // [splits, M, Np] when split
                       void* __restrict__ out) {   // [M, Np] f32 (unfused) or bf16 (fused) when not
  constexpr int UK = P::kUnitK, HS = P::kHalf, PL = P::kPlanes, S = P::kStages;
  constexpr int STEP = 4 * UK;      // k of one step of a warp
  constexpr int NH = UK / HS;       // halves of a unit
  constexpr int JH = HS / 4;        // MMAs of a half (two pairs each)
  constexpr int ES = XF32 ? 4 : 2;  // bytes of an x element
  constexpr int XP = XF32 ? 3 : 1;  // bf16 parts of an x element
  constexpr int RS = PL * kCols * 4 + 32;  // bytes of a stage row (the pad spreads the quad's rows over banks)
  static_assert((S & (S - 1)) == 0 && 2 * S * 8 <= kBarBytes, "ring stages: a power of two");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [S]: a stage's rows have landed
  uint64_t* empty = full + S;                          // [S]: the consumers are done with a stage
  unsigned char* ring = smem + kBarBytes;              // [S][4 rows][RS]
  unsigned char* xt = ring + S * 4 * RS;
  const int rb = x_row_bytes<UK>(kc, ES);
  const int ps = s_type == 0 ? 4 : 2;  // bytes of a parameter
  const int ngc = groups_of_chunk(kc, g);
  unsigned char* pt = xt + M * rb;  // [FUSE ? 2 : 1][ngc][kCols] scales, then zs

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, c = lane & 3;
  const int n0 = blockIdx.x * kCols;
  const int W = K / UK;
  const int u0 = blockIdx.y * units_per_split, u1 = min(W, u0 + units_per_split);
  const int k0 = u0 * UK, k1 = u1 * UK;
  const int T = (u1 - u0 + 3) / 4;  // steps

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, vec ? 1 : 32);
      mbar_init(empty + i, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {
    // the producer: stage t holds rows u0 + 4t .. + 3 of every plane, the
    // block's kCols columns each
    const int seg = min(kCols, Np - n0) * 4;  // bytes of a row in range
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      const int st = t & (S - 1);
      if (t >= S) mbar_wait(empty + st, ((t / S) - 1) & 1);
      unsigned char* dst = ring + st * 4 * RS;
      const int rows = min(4, u1 - u0 - 4 * t);
      if (vec) {
        if (lane == 0) {
          mbar_expect(full + st, static_cast<uint32_t>(rows * PL * seg));
          for (int r = 0; r < rows; ++r)
            for (int b = 0; b < PL; ++b)
              bulk_copy(dst + r * RS + b * kCols * 4, qw + P::row(b, u0 + 4 * t + r, W) * Np + n0, seg, full + st);
        }
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
    return;
  }

  const int lcol = warp * 32 + 4 * gq;  // the lane's first column in the block
  const int n = n0 + lcol;              // and in the layer
  const int nv = Np - n;                // its valid columns, if below 4

  // x[:, ch0:ch1) into the tile, zero past ch1 up to a whole step, and
  // the block's scales (and zs) of every group the chunk touches
  auto stage_chunk = [&](int ch0, int ch1) {
    const int gf = ch0 / g, ng = (ch1 - 1) / g - gf + 1;
    const int nf = FUSE ? 2 : 1;
    for (int i = threadIdx.x; i < nf * ng * (kCols / 4); i += kThreads) {
      const int f = i / (ng * (kCols / 4)), r = i - f * (ng * (kCols / 4));
      const int gl = r / (kCols / 4), col = 4 * (r - gl * (kCols / 4));
      const unsigned char* src = static_cast<const unsigned char*>(f ? zs : sc) +
                                 (static_cast<size_t>(gf + gl) * Np + n0 + col) * ps;
      unsigned char* dst = pt + ((f * ngc + gl) * kCols + col) * ps;
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
    constexpr int CE = 16 / ES;       // elements of a 16-byte piece
    constexpr int JC = UK * ES / 16;  // pieces of a unit
    const int U = (ch1 - ch0 + STEP - 1) / STEP * 4;
    const int per_row = U * JC;
    for (int i = threadIdx.x; i < M * per_row; i += kThreads) {
      const int m = i / per_row, r = i - m * per_row;
      const int ul = r / JC, j = r - ul * JC;
      const int e = ch0 + ul * UK + j * CE;
      unsigned char* dst = xt + m * rb + ul * UK * ES + 16 * (j ^ x_swizzle<UK, XF32>(ul));
      const bool on = e < ch1;
      cp_async16(dst, on ? static_cast<const unsigned char*>(x) + (static_cast<size_t>(m) * K + e) * ES : x, on);
    }
    cp_async_commit();
    cp_async_wait<0>();
    consumers_sync();
  };

  // acc: sum (128 + q) x of the open group; xs: sum x (the ones MMA); y: the
  // scaled groups so far
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
      if constexpr (!XF32) {
#pragma unroll
        for (int i = 0; i < UK / 8; ++i) {
          const uint4 v = m < M ? *reinterpret_cast<const uint4*>(xr + 16 * (i ^ x_swizzle<UK, XF32>(ul)))
                                : make_uint4(0u, 0u, 0u, 0u);
          xb[mt][4 * i] = v.x;
          xb[mt][4 * i + 1] = v.y;
          xb[mt][4 * i + 2] = v.z;
          xb[mt][4 * i + 3] = v.w;
        }
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
        uint32_t a[2][4];
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) {
          a[pr][0] = P::pair(w, mat[2 * pr], 2 * pr, s0);
          a[pr][1] = P::pair(w, mat[2 * pr + 1], 2 * pr + 1, s0);
          a[pr][2] = P::pair(w, mat[2 * pr], 2 * pr, s0 + 1);
          a[pr][3] = P::pair(w, mat[2 * pr + 1], 2 * pr + 1, s0 + 1);
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
            mma_bf16_16816(xs[mt], kOnes, kOnes, kOnes, kOnes, b0[q], b1[q]);
          }
        }
      }
    }
  };

  // the open group: its index and its end; gf_chunk: the chunk's first
  // group (its parameters are row 0 of the chunk's table)
  int gcur = k0 / g;
  int kend = (gcur + 1) * g;
  int gf_chunk = k0 / g;
  // close the open group (or the part of it in this split)
  auto flush = [&]() {
    const unsigned char* srow = pt + ((gcur - gf_chunk) * kCols + lcol) * ps;
    const unsigned char* zrow = pt + ((ngc + gcur - gf_chunk) * kCols + lcol) * ps;
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // C registers: (column 2pr: rows 2c, 2c+1), (column 2pr+1: rows 2c, 2c+1)
        const int col = 2 * pr + half;
        const float s = param_at(srow, s_type, col);
        const float z = FUSE ? param_at(zrow, s_type, col) : 0.f;
#pragma unroll
        for (int mt = 0; mt < NT; ++mt) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * half + r;
            const float dot = fmaf(-128.f, xs[mt][r], acc[mt][pr][e]);
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
    ++gcur;
    kend += g;
  };

  int ch0 = k0, ch1 = min(k0 + kc, k1);
  stage_chunk(ch0, ch1);
  int t = 0;
#pragma unroll 1
  while (true) {
#pragma unroll 1
    for (int ka = ch0; ka < ch1; ka += STEP, ++t) {
      const int st = t & (S - 1);
      mbar_wait(full + st, (t / S) & 1);  // the stage's rows have landed
      uint32_t w[PL][4];
      const unsigned char* src = ring + st * 4 * RS + c * RS + lcol * 4;
#pragma unroll
      for (int b = 0; b < PL; ++b) {
        const uint4 v = *reinterpret_cast<const uint4*>(src + b * kCols * 4);
        w[b][0] = v.x;
        w[b][1] = v.y;
        w[b][2] = v.z;
        w[b][3] = v.w;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);  // the producer may refill it
      const int ul = (ka - ch0) / UK + c, kunit = ka + c * UK;
      const int kz = min(ka + STEP, k1);
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
    // the next chunk (only when the split's passes the budget)
    ch0 = ch1;
    ch1 = min(ch0 + kc, k1);
    gf_chunk = ch0 / g;
    consumers_sync();
    stage_chunk(ch0, ch1);
  }

#pragma unroll
  for (int mt = 0; mt < NT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = mt * 8 + 2 * c + r;
      if (m >= M || nv <= 0) continue;
      const float v[4] = {y[mt][0][r], y[mt][0][2 + r], y[mt][1][r], y[mt][1][2 + r]};
      if (part != nullptr || !FUSE) {
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

// the shared memory of a block: the barriers and the ring; a chunk's x rows
// and parameter table
template <class P>
inline int ring_bytes() {
  return kBarBytes + P::kStages * 4 * (P::kPlanes * kCols * 4 + 32);
}
template <class P>
inline int chunk_bytes(int M, int kc, int esize, int g, int ps, bool fused) {
  return M * x_row_bytes<P::kUnitK>(kc, esize) + (fused ? 2 : 1) * groups_of_chunk(kc, g) * kCols * ps;
}

// The chunk (k) a block stages at once: its split's k in whole steps,
// unless its x rows and parameters would pass kXBudget
template <class P>
inline int chunk_k(int M, int units_per_split, int esize, int g, int ps, bool fused) {
  const int step = 4 * P::kUnitK;
  int kc = (units_per_split + 3) / 4 * step;
  while (kc > step && chunk_bytes<P>(M, kc, esize, g, ps, fused) > kXBudget) kc -= step;
  return kc;
}

template <class P, int NT, bool XF32, bool FUSE>
int launch(int splits, cudaStream_t st, const void* x, const uint32_t* qw, const void* sc, const void* zs,
           int s_type, int M, int K, int Np, int g, int ups, int vec, float* part, void* out) {
  static int allowed[kMaxDevices];
  constexpr int es = XF32 ? 4 : 2;
  const int ps = s_type == 0 ? 4 : 2;
  const int kc = chunk_k<P>(M, ups, es, g, ps, FUSE);
  const int smem = ring_bytes<P>() + chunk_bytes<P>(M, kc, es, g, ps, FUSE);
  auto kern = stacked_mma_kernel<P, NT, XF32, FUSE>;
  const int e = allow_dynamic_smem(kern, smem, allowed);
  if (e != 0) return e;
  const dim3 grid((Np + kCols - 1) / kCols, splits);
  kern<<<grid, kBlock, smem, st>>>(x, qw, sc, zs, s_type, M, K, Np, g, ups, kc, vec, part, out);
  return 0;
}

template <class P, bool XF32, bool FUSE>
int launch_m(int splits, cudaStream_t st, const void* x, const uint32_t* qw, const void* sc, const void* zs,
             int s_type, int M, int K, int Np, int g, int ups, int vec, float* part, void* out) {
  if (M <= 8) return launch<P, 1, XF32, FUSE>(splits, st, x, qw, sc, zs, s_type, M, K, Np, g, ups, vec, part, out);
  if (M <= 16) return launch<P, 2, XF32, FUSE>(splits, st, x, qw, sc, zs, s_type, M, K, Np, g, ups, vec, part, out);
  return launch<P, 4, XF32, FUSE>(splits, st, x, qw, sc, zs, s_type, M, K, Np, g, ups, vec, part, out);
}

// the whole launch: the layer's pointers, the body for (x type, fused, M),
// then the split sum; a cudaError_t
template <class P>
int run(const void* x, int x_f32, const uint32_t* qw, const void* sc, const void* zs, int s_type, void* part,
        void* out, int fused, int M, int K, int Np, int g, int splits, int ups, cudaStream_t st) {
  const size_t pe = s_type == 0 ? 4 : 2;
  auto al16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; };
  const bool vec = Np % 4 == 0 && al16(qw) && (reinterpret_cast<uintptr_t>(sc) % (4 * pe)) == 0 &&
                   (!fused || (reinterpret_cast<uintptr_t>(zs) % (4 * pe)) == 0);
  if (!al16(x)) return static_cast<int>(cudaErrorMisalignedAddress);
  float* p = splits > 1 ? static_cast<float*>(part) : nullptr;
  int e;
  if (x_f32)
    e = fused ? launch_m<P, true, true>(splits, st, x, qw, sc, zs, s_type, M, K, Np, g, ups, vec, p, out)
              : launch_m<P, true, false>(splits, st, x, qw, sc, zs, s_type, M, K, Np, g, ups, vec, p, out);
  else
    e = fused ? launch_m<P, false, true>(splits, st, x, qw, sc, zs, s_type, M, K, Np, g, ups, vec, p, out)
              : launch_m<P, false, false>(splits, st, x, qw, sc, zs, s_type, M, K, Np, g, ups, vec, p, out);
  if (e != 0) return e;
  if (splits > 1) {
    const int MN = M * Np;
    split_sum_out_kernel<<<(MN + 255) / 256, 256, 0, st>>>(p, splits, MN, fused, out);
  }
  return qllm_launch_status();
}

}  // namespace stacked_mma
