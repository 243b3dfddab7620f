// K3a kv_write_int8, K3b decode_attn_int8, K22 decode_attn_int8_4d, K21
// decode_attn_int8_partial, K6 decode_attention_ring and K7
// kv_ring_flush: the decode step's KV write and single-query attention
// over the int8 KV cache (k/v [L, B, Hkv, S, D] int8, scales
// [L, B, Hkv, S] f32; K22 one layer's [B, Hkv, S, D]), a sequence shard's
// partial statistics, and the bf16 rings ([L, B, Hkv, 8, D]).

#include "common.cuh"

// ---------------------------------------------------------------------------
// K3a kv_write_int8.
//
// Replaces _kv_write_kernel / kv_cache_write_pallas
// (qllm_tpu/ops/pallas_attention.py:134, :186): quantize this step's k
// and v per (batch, kv-head) symmetrically, scale = max(amax/127, 1e-8),
// q = clip(round_half_even(x / scale), -127, 127), and write row pos[b]
// of layer `layer` and its scale in place. The TPU kernel's 8-row window
// is a Mosaic constraint; a CUDA thread block writes the single row.
//
// Bound on the H100: bytes, and tiny (B*Hkv*D*2 values in, as many int8
// out); the launch itself dominates. One warp a (b, kv head, k or v) row,
// eight rows a 256-thread block: each lane holds 4 consecutive d of each
// 128-wide chunk of the row (one 8-byte load in bf16, one 16-byte load in
// f32), the row's amax is a warp shuffle max (no shared memory, no block
// barrier), and each lane stores its four int8 as one 32-bit word. D % 4
// == 0 and D <= 512 (the wrapper refuses the rest; every model served has
// D in 64-256).
// ---------------------------------------------------------------------------

namespace {

constexpr int kWriteRows = 8;       // warps (rows) a block
constexpr int kWriteChunks = 4;     // 128-wide chunks a lane may hold: D <= 512

__global__ void __launch_bounds__(32 * kWriteRows)
    kv_write_kernel(const void* __restrict__ k_new, const void* __restrict__ v_new, int in_f32,
                    int8_t* __restrict__ kc, int8_t* __restrict__ vc, float* __restrict__ ks,
                    float* __restrict__ vs, const int* __restrict__ pos, int layer, int B, int H,
                    int S, int D) {
  const int r = blockIdx.x * kWriteRows + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= 2 * B * H) return;  // uniform across the warp
  const int which = r & 1, bh = r >> 1, b = bh / H;
  const size_t in_at = static_cast<size_t>(bh) * D;
  float v[kWriteChunks][4];
  float amax = 0.f;
#pragma unroll
  for (int ch = 0; ch < kWriteChunks; ++ch) {
    const int d = ch * 128 + 4 * lane;
    if (d < D) {
      if (in_f32) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(which ? v_new : k_new) + in_at + d));
        v[ch][0] = f.x, v[ch][1] = f.y, v[ch][2] = f.z, v[ch][3] = f.w;
      } else {
        const uint2 u = __ldg(reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(which ? v_new : k_new) + in_at + d));
        v[ch][0] = __uint_as_float(u.x << 16), v[ch][1] = __uint_as_float(u.x & 0xFFFF0000u);
        v[ch][2] = __uint_as_float(u.y << 16), v[ch][3] = __uint_as_float(u.y & 0xFFFF0000u);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) amax = fmaxf(amax, fabsf(v[ch][j]));
    }
  }
  const int p = __ldg(pos + b);  // loaded with the row, not before it
  if (p < 0 || p >= S) return;    // the row is left untouched
  amax = warp_max(amax);
  const float scale = fmaxf(amax / 127.0f, 1e-8f);
  const size_t row = ((static_cast<size_t>(layer) * B + b) * H + bh % H) * S + p;
  int8_t* dst = (which ? vc : kc) + row * D;
#pragma unroll
  for (int ch = 0; ch < kWriteChunks; ++ch) {
    const int d = ch * 128 + 4 * lane;
    if (d < D) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // divide (not multiply by the reciprocal) and round half to even,
        // as jnp.round does, so the int8 values equal the JAX kernel's
        const float q = fminf(fmaxf(rintf(v[ch][j] / scale), -127.f), 127.f);
        word |= (static_cast<uint32_t>(static_cast<int>(q)) & 0xFFu) << (8 * j);
      }
      *reinterpret_cast<uint32_t*>(dst + d) = word;
    }
  }
  if (lane == 0) (which ? vs : ks)[row] = scale;
}

}  // namespace

QLLM_API int qllm_kv_write_int8(const void* k_new, const void* v_new, void* k_cache,
                                void* v_cache, void* k_scale, void* v_scale, const void* pos,
                                int in_f32, int layer, int B, int H, int S, int D, void* stream) {
  const uintptr_t in_align = in_f32 ? 16 : 8;
  if (B < 1 || H < 1 || D < 4 || D % 4 || D > 128 * kWriteChunks ||
      (reinterpret_cast<uintptr_t>(k_new) | reinterpret_cast<uintptr_t>(v_new)) % in_align ||
      (reinterpret_cast<uintptr_t>(k_cache) | reinterpret_cast<uintptr_t>(v_cache)) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = 2 * B * H;
  kv_write_kernel<<<(rows + kWriteRows - 1) / kWriteRows, 32 * kWriteRows, 0, static_cast<cudaStream_t>(stream)>>>(
      k_new, v_new, in_f32, static_cast<int8_t*>(k_cache), static_cast<int8_t*>(v_cache),
      static_cast<float*>(k_scale), static_cast<float*>(v_scale), static_cast<const int*>(pos),
      layer, B, H, S, D);
  return qllm_launch_status();
}

// ---------------------------------------------------------------------------
// K3b decode_attn_int8, K22 decode_attn_int8_4d, K21
// decode_attn_int8_partial and K6 decode_attention_ring: one device body.
//
// K3b replaces _attn_kernel_stacked / _decode_attention_stacked
// (pallas_attention.py:97, :457) behind decode_attention_pallas (:574),
// S <= 8192, and _attn_kernel_stacked_chunked /
// _decode_attention_stacked_chunked (:284, :371), the key-chunked online
// softmax the TPU takes at S > 8192: one query token per sequence
// attends over its first lengths[b] cache rows. q is scaled by D^-0.5 in
// f32 and rounded to bf16; scores = (q . k_int8) * ks, then the options
// in _attn_kernel's order (:57-83): the logit softcap cap * tanh(s / cap)
// (exact tanhf), the ALiBi bias slopes[h] * s (JAX adds a precomputed f32
// bias array, _alibi_bias_block :561, so the product is rounded before
// the add: every product and sum of the score is an explicit _rn
// intrinsic, which nvcc cannot contract into an FMA), then the mask
// len - win <= s < len (win = S + 1 when no window is given; it is an
// int32 in device memory, as JAX's is traced). Softmax in f32; the
// probabilities times vs are rounded to bf16 before the product with
// v_int8 (the v scale folds into the probabilities); output f32
// [B, H, D].
//
// K22 replaces _attn_kernel (:39), the 4-D branch of
// decode_attention_pallas (call :671): the same function over one
// layer's [B, Hkv, S, D] cache, i.e. this body with layer 0 of a one-layer
// stack.
//
// K21 replaces _attn_kernel_stacked_partial / decode_attention_partial
// (:1053, :1098), the sequence-parallel building block: no options, and
// the UNNORMALISED statistics of the local shard: acc = sum of
// bf16(p * vs) * v, m = the shard's largest score, den = the sum of the
// unrounded p, with p = exp(s - m) over the valid rows only. A
// zero-length shard writes exactly m = -1e30, acc = 0, den = 0.
//
// K6 replaces _attn_kernel_stacked_ring / decode_attention_ring
// (pallas_attention.py:1212, :1309): lengths[b] = pos counts the past
// tokens; rows [0, flushed = pos / 8 * 8) are int8 in the cache, rows
// [flushed, pos) bf16 in ring slots [0, nring = pos - flushed), and the
// current token's k / v arrive as operands. The ring rows' scores are
// bf16 products with f32 sums and their probabilities are rounded to bf16
// for P.V; the current token's score sum(bf16(q) * k_new) and value
// p * v_new stay f32. The kernel writes the bf16 k_new / v_new into ring
// slot nring of this layer in place, once a (b, kv head); no other slot
// or layer is touched, and the int8 cache is read only.
//
// Bound on the H100: bytes. Every int8 K and V row of the sequence is
// read once, about 2 flops a byte a query head, far below the tensor-core
// ridge, so f32 FMAs on the CUDA cores do the products.
//
// Design. The grid is (query group x key split, b x kv head). A group is
// at most 8 query heads of one kv head (any n_rep: JAX pads its group to a
// multiple of 8, pallas_attention.py:613-619), held in 1, 4 or 8 rows of
// registers and shared memory (instances for n_rep = 1, <= 4 and more, so
// multi-head attention carries no unused rows); the groups of one split are
// neighbouring blocks, so a group after the first reads the split's K/V
// rows from L2 (only a multi-query model has more than one group, and its
// one kv head's cache is small). Split j covers the key rows
// [j * C, (j + 1) * C), C = `split`, a multiple of the 128-key tile and one
// constant for every B, S and length, so a sequence's bits depend on its
// own rows alone. Splits wholly past the length, or below the window's
// first row, exit at once; every other split walks its tiles from the
// one holding its first valid row, so no walked tile is fully masked.
//
// A block stages its split's K tiles, then its V tiles, through a ring of
// two shared-memory slots with 16-byte cp.async copies (the next tile in
// flight while one is used), rows padded by 16 bytes so that a thread's
// K row reads are free of bank conflicts. The scales of the split land
// with the first tile. Scores: one key a thread over the staged K row,
// for each of the group's rows (q held in shared memory, a broadcast
// read). The split's max and denominator are exact over its keys (two
// passes over the scores kept in shared memory; no rescaling). P.V: a
// thread takes 4 head dimensions of one key slice and reads 4 bytes of a
// staged V row a key; the slices are summed in order at the end. int8
// values become f32 exactly by a byte permute into the mantissa of 2^23.
//
// The splits of a (b, kv head, group) meet in the same launch: each
// writes its unnormalised (acc, m, den) to scratch; the last to arrive
// (an arrival count in device memory, reset by that block) merges them in
// split order: m = max m_j, w_j = exp(m_j - m), den = sum den_j w_j,
// acc = sum acc_j w_j. K3b, K22 and K6 then divide acc / den; K21 writes
// (acc, m, den), so a one-rank sp_decode_attention (lse_merge's weight
// exp(0) = 1) gives K3b's division bit for bit. A sequence with one split
// writes its result directly. Running maxima start at JAX's _NEG = -1e30.
// In ring mode the last split of the flushed rows also takes the ring
// rows and the current token, and writes the ring slot. Offsets are
// 64-bit.
// ---------------------------------------------------------------------------

namespace {

constexpr int kAttnThreads = 128;
constexpr int kTile = 128;  // keys per staged tile (one a thread in the score pass)
constexpr int kGroup = 8;   // query heads a block serves; the scratch's rows a slot
constexpr int kStages = 2;  // shared-memory slots of the copy ring
constexpr int kMaxD = 256;
constexpr int kMaxSplit = 1024;
constexpr int kRingRows = 8;
constexpr int kMergeChunk = 64;  // splits whose weights the merge holds at once
constexpr float kNeg = -1e30f;   // JAX's _NEG (pallas_attention.py:281)

enum AttnMode { kOneShot = 0, kRingMode = 1, kPartial = 2 };

// the operands only some modes read
struct AttnExtra {
  // kOneShot options
  float cap, inv_cap;   // logit softcap (kSoftcap)
  const float* slopes;  // [H] ALiBi slopes (kAlibi)
  const int* window;    // [1] sliding window, or nullptr (S + 1)
  // kRingMode: this step's k / v [B, Hkv, D] and the rings
  const __nv_bfloat16* k_new;
  const __nv_bfloat16* v_new;
  __nv_bfloat16* rk;
  __nv_bfloat16* rv;
  // kPartial: m and den [B, H]
  float* m_out;
  float* den_out;
};

struct AttnArgs {
  const __nv_bfloat16* q;  // [B, H, D]
  const int8_t* kc;
  const int8_t* vc;
  const float* ks;
  const float* vs;
  const int* lengths;
  float* out;       // [B, H, D]
  float* part;      // scratch: acc [slots, kGroup, D], then m, den [slots, kGroup]
  unsigned* count;  // [B * Hkv * groups] arrival counts, zero between launches
  int layer, B, Hkv, S, D, n_rep, split, n_splits, groups;
  float qscale;
};

// byte offsets of the dynamic shared memory's regions
struct AttnSmem {
  int stage, qs, sc, ksc, vsc, red, ring, total;
};

// (rows: the query rows a block holds, 1, 4 or kGroup)
__host__ __device__ inline AttnSmem attn_smem(int D, int split, bool ring, int rows) {
  AttnSmem s;
  const int stage = kStages * kTile * (D + 16);
  const int slices = kAttnThreads * 4 * rows * 4;  // the P.V slices' sums, reusing the ring
  s.stage = 0;
  s.qs = s.stage + (stage > slices ? stage : slices);
  s.sc = s.qs + rows * D * 4;
  s.ksc = s.sc + split * rows * 4;
  s.vsc = s.ksc + split * 4;
  s.red = s.vsc + split * 4;
  s.ring = s.red + 64 * 4;  // warp partials [4][rows], m [rows], den [rows], flag
  s.total = s.ring + (ring ? (kRingRows + 1) * (D + rows) * 4 : 0);
  return s;
}

// 4 int8 values -> exact f32: each byte (offset by 128) becomes the low
// mantissa byte of 2^23, then 2^23 + 128 is taken off
__device__ __forceinline__ void int8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + i)) - 8388736.f;
}

// dot[r][kChain] += the products of 16 head dimensions from d0 of row r of
// q' (shared memory) with a staged int8 K row; two chains (even and odd
// chunks) halve the dependent FMAs of a row
template <int kRows, int kChain>
__device__ __forceinline__ void dot16(const int8_t* krow, const float* qs, int D, int d0, int R,
                                      float (&dot)[kRows][2]) {
  const uint4 w = *reinterpret_cast<const uint4*>(krow + d0);
  float kf[16];
  int8x4_to_f32(w.x, kf);
  int8x4_to_f32(w.y, kf + 4);
  int8x4_to_f32(w.z, kf + 8);
  int8x4_to_f32(w.w, kf + 12);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < R) {
      const float4* qr = reinterpret_cast<const float4*>(qs + r * D + d0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 qv = qr[e];
        dot[r][kChain] = fmaf(qv.x, kf[4 * e], dot[r][kChain]);
        dot[r][kChain] = fmaf(qv.y, kf[4 * e + 1], dot[r][kChain]);
        dot[r][kChain] = fmaf(qv.z, kf[4 * e + 2], dot[r][kChain]);
        dot[r][kChain] = fmaf(qv.w, kf[4 * e + 3], dot[r][kChain]);
      }
    }
  }
}

// kRows: the query rows a block holds, 1, 4 or kGroup (at least the group's).
// Four blocks an SM (what the shared memory allows) let ptxas use up to 128
// registers a thread; left to itself it held the 4-row instance to 72 and
// spilled.
template <int kMode, bool kSoftcap, bool kAlibi, int kRows>
__global__ void __launch_bounds__(kAttnThreads, 4) decode_attn_kernel(AttnArgs a, AttnExtra x) {
  constexpr bool kRing = kMode == kRingMode;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = a.groups, g = blockIdx.x % G, j = blockIdx.x / G;
  const int bh = blockIdx.y, b = bh / a.Hkv, hk = bh % a.Hkv;
  const int D = a.D, S = a.S, C = a.split;
  const int len_b = a.lengths[b];
  // K3b: the first lengths[b] rows; the ring kernel: the flushed rows
  const int len = kRing ? min(max(len_b, 0) / kRingRows * kRingRows, S) : min(max(len_b, 0), S);
  // the first row the window keeps: len - win <= s
  const int lo = (kMode == kOneShot && x.window != nullptr) ? max(len_b - *x.window, 0) : 0;
  const bool any = lo < len;
  const int j0 = any ? lo / C : 0, j1 = any ? (len - 1) / C : 0;
  if (j < j0 || j > j1) return;  // uniform across the block
  const int n_part = j1 - j0 + 1;
  const bool ring_here = kRing && j == j1;

  const int H = a.Hkv * a.n_rep;
  const int R = min(kRows, a.n_rep - kGroup * g);  // rows of this group
  const int h0 = hk * a.n_rep + kGroup * g;        // its first query head
  // this split's keys [k_lo, k_hi), walked in tiles from t_lo
  const int k_lo = any ? max(j * C, lo) : 0, k_hi = any ? min((j + 1) * C, len) : 0;
  const int t_lo = k_lo / kTile * kTile;
  const int n_tiles = k_hi > k_lo ? (k_hi - t_lo + kTile - 1) / kTile : 0;
  const size_t base = ((static_cast<size_t>(a.layer) * a.B + b) * a.Hkv + hk) * S;  // cache row 0
  const int pitch = D + 16;

  const AttnSmem L = attn_smem(D, C, kRing, kRows);
  int8_t* stage = reinterpret_cast<int8_t*>(smem + L.stage);
  float* qs = reinterpret_cast<float*>(smem + L.qs);    // [kRows][D]
  float* sc = reinterpret_cast<float*>(smem + L.sc);    // [split keys][kRows]: scores, then bf16(p * vs)
  float* ksc = reinterpret_cast<float*>(smem + L.ksc);  // [split keys]
  float* vsc = reinterpret_cast<float*>(smem + L.vsc);
  float* red = reinterpret_cast<float*>(smem + L.red);  // [4][kRows]
  float* m_s = red + 4 * kRows;
  float* den_s = m_s + kRows;
  int* flag = reinterpret_cast<int*>(den_s + kRows);

  // copy i of the ring: K tiles 0 .. n_tiles - 1, then V tiles; rows
  // outside [k_lo, k_hi) are zero-filled and never read from memory
  auto issue = [&](int i) {
    if (i < 2 * n_tiles) {
      const int8_t* src = i < n_tiles ? a.kc : a.vc;
      const int s0 = t_lo + (i < n_tiles ? i : i - n_tiles) * kTile;
      int8_t* dst = stage + (i % kStages) * kTile * pitch;
      const int chunks = D / 16;
      for (int c = tid; c < kTile * chunks; c += kAttnThreads) {
        const int r = c / chunks, ch = c % chunks;
        const int s = s0 + r;
        const bool in = s >= k_lo && s < k_hi;
        cp_async16(dst + r * pitch + ch * 16, src + (base + (in ? s : k_lo)) * D + ch * 16, in);
      }
    }
    cp_async_commit();
  };
  for (int i = tid; i < n_tiles * kTile; i += kAttnThreads) {
    const int s = t_lo + i;
    const bool in = s >= k_lo && s < k_hi;
    cp_async4(ksc + i, a.ks + base + (in ? s : k_lo), in);
    cp_async4(vsc + i, a.vs + base + (in ? s : k_lo), in);
  }
  issue(0);
  issue(1);

  for (int i = tid; i < kRows * D; i += kAttnThreads) {
    const int r = i / D, d = i % D;
    qs[i] = r < R ? round_bf16(bf2f(a.q[(static_cast<size_t>(b) * H + h0 + r) * D + d]) * a.qscale) : 0.f;
  }
  float slope[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) slope[r] = (kAlibi && r < R) ? x.slopes[h0 + r] : 0.f;

  // the ring rows and the current token (entry nring), their v rows in f32
  int nring = 0;
  size_t rbase = 0, nbase = 0;
  float* vt = reinterpret_cast<float*>(smem + L.ring);  // [kRingRows + 1][D]
  float* rp = vt + (kRingRows + 1) * D;                 // [kRingRows + 1][kRows]
  if constexpr (kRing) {
    nring = min(max(len_b - len, 0), kRingRows - 1);
    rbase = ((static_cast<size_t>(a.layer) * a.B + b) * a.Hkv + hk) * kRingRows * D;
    nbase = static_cast<size_t>(bh) * D;
    if (ring_here)
      for (int i = tid; i < (nring + 1) * D; i += kAttnThreads) {
        const int e = i / D, d = i % D;
        vt[i] = bf2f(e < nring ? x.rv[rbase + static_cast<size_t>(e) * D + d] : x.v_new[nbase + d]);
      }
  }

  // pass 1: the scores of key t_lo + kk, kk = i * kTile + tid
  float tmax[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) tmax[r] = kNeg;
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<1>();
    __syncthreads();
    const int kk = i * kTile + tid;
    const int s = t_lo + kk;
    const bool valid = s >= k_lo && s < k_hi;
    float dot[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) dot[r][0] = dot[r][1] = 0.f;
    if (valid) {
      const int8_t* krow = stage + (i % kStages) * kTile * pitch + tid * pitch;
      int d0 = 0;
#pragma unroll 2
      for (; d0 + 32 <= D; d0 += 32) {
        dot16<kRows, 0>(krow, qs, D, d0, R, dot);
        dot16<kRows, 1>(krow, qs, D, d0 + 16, R, dot);
      }
      if (d0 < D) dot16<kRows, 0>(krow, qs, D, d0, R, dot);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float score = neg_inf();
      if (valid) {
        score = __fmul_rn(__fadd_rn(dot[r][0], dot[r][1]), ksc[kk]);
        if constexpr (kSoftcap) score = __fmul_rn(x.cap, tanhf(__fmul_rn(score, x.inv_cap)));
        if constexpr (kAlibi) score = __fadd_rn(score, __fmul_rn(slope[r], static_cast<float>(s)));
      }
      sc[kk * kRows + r] = score;
      tmax[r] = fmaxf(tmax[r], score);
    }
    __syncthreads();  // the slot is refilled next
    issue(i + 2);
  }
  // the ring entries' scores: entry e by warp e % 4, its lanes over the
  // head dimensions, the lanes' sums added by a butterfly
  if (ring_here) {
    for (int e = warp; e <= nring; e += kAttnThreads / 32) {
      const __nv_bfloat16* krow = e < nring ? x.rk + rbase + static_cast<size_t>(e) * D : x.k_new + nbase;
      float part[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) part[r] = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float kv = bf2f(krow[d]);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r < R) part[r] = fmaf(qs[r * D + d], kv, part[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float score = warp_sum(part[r]);
        if (lane == 0 && r < R) {
          rp[e * kRows + r] = score;
          tmax[r] = fmaxf(tmax[r], score);
        }
      }
    }
  }

  // the split's max per row, from -1e30
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float w = warp_max(tmax[r]);
    if (lane == 0) red[warp * kRows + r] = w;
  }
  __syncthreads();
  if (tid < kRows) {
    float m = kNeg;
    for (int w = 0; w < kAttnThreads / 32; ++w) m = fmaxf(m, red[w * kRows + tid]);
    m_s[tid] = m;
  }
  __syncthreads();

  // p = exp(s - m): the denominator takes p, P.V bf16(p * vs)
  float dsum[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) dsum[r] = 0.f;
  for (int kk = tid; kk < n_tiles * kTile; kk += kAttnThreads) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < R) {
        const float p = expf(sc[kk * kRows + r] - m_s[r]);
        dsum[r] += p;
        sc[kk * kRows + r] = round_bf16(p * vsc[kk]);
      }
    }
  }
  if (ring_here && tid <= nring) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < R) {
        const float p = expf(rp[tid * kRows + r] - m_s[r]);
        dsum[r] += p;
        rp[tid * kRows + r] = tid < nring ? round_bf16(p) : p;  // the current token's p stays f32
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float w = warp_sum(dsum[r]);
    if (lane == 0) red[warp * kRows + r] = w;
  }
  __syncthreads();
  if (tid < kRows) {
    float sum = 0.f;
    for (int w = 0; w < kAttnThreads / 32; ++w) sum += red[w * kRows + tid];
    den_s[tid] = sum;
  }

  // pass 2: P.V; thread (slice sl, dims 4 dc .. 4 dc + 3) takes the keys
  // sl, sl + n_sl, ... of each tile
  const int n_dc = D / 4, n_sl = kAttnThreads / n_dc;
  const int sl = tid / n_dc, dc = tid % n_dc;
  float acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<1>();
    __syncthreads();
    if (sl < n_sl) {
      const int8_t* vtile = stage + ((n_tiles + i) % kStages) * kTile * pitch + 4 * dc;
      const float* pt = sc + i * kTile * kRows;
      const int nk = min(kTile, k_hi - (t_lo + i * kTile));  // rows past it are zero
#pragma unroll 4
      for (int jj = sl; jj < nk; jj += n_sl) {
        float vf[4];
        int8x4_to_f32(*reinterpret_cast<const uint32_t*>(vtile + jj * pitch), vf);
        float p[kRows];
        if constexpr (kRows % 4 == 0) {
#pragma unroll
          for (int r = 0; r < kRows; r += 4) {
            const float4 p4 = *reinterpret_cast<const float4*>(pt + jj * kRows + r);
            p[r] = p4.x, p[r + 1] = p4.y, p[r + 2] = p4.z, p[r + 3] = p4.w;
          }
        } else {
#pragma unroll
          for (int r = 0; r < kRows; ++r) p[r] = pt[jj * kRows + r];
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r < R)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][e] = fmaf(p[r], vf[e], acc[r][e]);
      }
    }
    __syncthreads();
    issue(n_tiles + i + 2);
  }
  cp_async_wait<0>();
  if (ring_here && sl < n_sl) {
    for (int e = sl; e <= nring; e += n_sl) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < R)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(rp[e * kRows + r], vt[e * D + 4 * dc + c], acc[r][c]);
    }
  }
  // append this token to ring slot nring (read by no block of this launch)
  if (ring_here && g == 0) {
    for (int d = tid; d < D; d += kAttnThreads) {
      x.rk[rbase + static_cast<size_t>(nring) * D + d] = x.k_new[nbase + d];
      x.rv[rbase + static_cast<size_t>(nring) * D + d] = x.v_new[nbase + d];
    }
  }
  // the slices' sums, added in slice order
  __syncthreads();
  float* slices = reinterpret_cast<float*>(stage);  // [n_sl][kRows][D]
  if (sl < n_sl) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < R)
#pragma unroll
        for (int e = 0; e < 4; ++e) slices[(sl * kRows + r) * D + 4 * dc + e] = acc[r][e];
  }
  __syncthreads();

  const size_t row0 = static_cast<size_t>(b) * H + h0;  // this group's first output row
  if (n_part == 1) {
    for (int i = tid; i < R * D; i += kAttnThreads) {
      const int r = i / D, d = i % D;
      float v = slices[r * D + d];
      for (int t = 1; t < n_sl; ++t) v += slices[(t * kRows + r) * D + d];
      a.out[(row0 + r) * D + d] = kMode == kPartial ? v : v / den_s[r];
    }
    if (kMode == kPartial && tid < R) {
      x.m_out[row0 + tid] = m_s[tid];
      x.den_out[row0 + tid] = den_s[tid];
    }
    return;
  }

  // several splits: this one's partial to scratch, then the last to arrive merges
  const size_t slots = static_cast<size_t>(a.B) * a.Hkv * G * a.n_splits;
  const size_t slot0 = (static_cast<size_t>(bh) * G + g) * a.n_splits;  // split 0 of this group
  float* p_acc = a.part + slot0 * kGroup * D;
  float* p_m = a.part + slots * kGroup * D + slot0 * kGroup;
  float* p_den = p_m + slots * kGroup;
  for (int i = tid; i < R * D; i += kAttnThreads) {
    const int r = i / D, d = i % D;
    float v = slices[r * D + d];
    for (int t = 1; t < n_sl; ++t) v += slices[(t * kRows + r) * D + d];
    p_acc[(static_cast<size_t>(j) * kGroup + r) * D + d] = v;
  }
  if (tid < R) {
    p_m[j * kGroup + tid] = m_s[tid];
    p_den[j * kGroup + tid] = den_s[tid];
  }
  // the block's partial is written (bar.sync); one release-acquire add at
  // gpu scope publishes it, and the last arrival sees every split's
  __syncthreads();
  unsigned* count = a.count + static_cast<size_t>(bh) * G + g;
  if (tid == 0) {
    unsigned prev;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;" : "=r"(prev) : "l"(count) : "memory");
    *flag = prev == static_cast<unsigned>(n_part - 1);
  }
  __syncthreads();
  if (!*flag) return;

  // the merge, in split order
  if (tid < R) {
    float m = kNeg;
    for (int t = j0; t <= j1; ++t) m = fmaxf(m, __ldcg(p_m + t * kGroup + tid));
    m_s[tid] = m;
    den_s[tid] = 0.f;
  }
  constexpr int kPer = kRows * kMaxD / kAttnThreads;  // (row, dim) pairs a thread
  float out[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) out[k] = 0.f;
  float* w_s = sc;  // [kMergeChunk][kRows]
  for (int c0 = j0; c0 <= j1; c0 += kMergeChunk) {
    const int nc = min(kMergeChunk, j1 + 1 - c0);
    __syncthreads();  // m_s is set; the previous chunk's weights are used
    for (int i = tid; i < nc * kRows; i += kAttnThreads) {
      const int t = i / kRows, r = i % kRows;
      w_s[i] = r < R ? expf(__ldcg(p_m + (c0 + t) * kGroup + r) - m_s[r]) : 0.f;
    }
    __syncthreads();
    if (tid < R)
      for (int t = 0; t < nc; ++t)
        den_s[tid] = fmaf(__ldcg(p_den + (c0 + t) * kGroup + tid), w_s[t * kRows + tid], den_s[tid]);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = tid + k * kAttnThreads;
      if (i < R * D) {
        const int r = i / D, d = i % D;
        for (int t = 0; t < nc; ++t)
          out[k] = fmaf(__ldcg(p_acc + (static_cast<size_t>(c0 + t) * kGroup + r) * D + d), w_s[t * kRows + r], out[k]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = tid + k * kAttnThreads;
    if (i < R * D) {
      const int r = i / D, d = i % D;
      a.out[(row0 + r) * D + d] = kMode == kPartial ? out[k] : out[k] / den_s[r];
    }
  }
  if (kMode == kPartial && tid < R) {
    x.m_out[row0 + tid] = m_s[tid];
    x.den_out[row0 + tid] = den_s[tid];
  }
  if (tid == 0) *count = 0u;  // for the next launch
}

bool attn_shape_ok(int B, int Hkv, int S, int D, int n_rep, int split) {
  const long long groups = (n_rep + kGroup - 1) / kGroup, n_splits = (S + static_cast<long long>(split) - 1) / split;
  return n_rep >= 1 && D >= 16 && D <= kMaxD && D % 16 == 0 && B >= 1 && Hkv >= 1 && S >= 1 &&
         static_cast<long long>(B) * Hkv <= 65535 && split >= kTile && split <= kMaxSplit && split % kTile == 0 &&
         groups * n_splits <= 0x7fffffffLL;
}

template <int kMode, bool kSoftcap, bool kAlibi, int kRows>
int launch_rows(const AttnArgs& a, const AttnExtra& x, void* stream) {
  const int bytes = attn_smem(a.D, a.split, kMode == kRingMode, kRows).total;
  static int allowed[kMaxDevices];
  if (const int e = allow_dynamic_smem(decode_attn_kernel<kMode, kSoftcap, kAlibi, kRows>, bytes, allowed)) return e;
  const dim3 grid(a.groups * a.n_splits, a.B * a.Hkv);
  decode_attn_kernel<kMode, kSoftcap, kAlibi, kRows>
      <<<grid, kAttnThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a, x);
  return qllm_launch_status();
}

// a block holds as many query rows as its group has, in 1, 4 or kGroup
// registers and shared-memory rows (multi-head attention, n_rep <= 4, more)
template <int kMode, bool kSoftcap, bool kAlibi>
int launch_attn(const AttnArgs& a, const AttnExtra& x, void* stream) {
  if (a.n_rep == 1) return launch_rows<kMode, kSoftcap, kAlibi, 1>(a, x, stream);
  if (a.n_rep <= 4) return launch_rows<kMode, kSoftcap, kAlibi, 4>(a, x, stream);
  return launch_rows<kMode, kSoftcap, kAlibi, kGroup>(a, x, stream);
}

AttnArgs attn_args(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
                   const void* v_scale, const void* lengths, void* out, void* scratch, void* counts, int layer,
                   int B, int Hkv, int S, int D, int n_rep, int split, float qscale) {
  AttnArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kc = static_cast<const int8_t*>(k_cache);
  a.vc = static_cast<const int8_t*>(v_cache);
  a.ks = static_cast<const float*>(k_scale);
  a.vs = static_cast<const float*>(v_scale);
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<float*>(out);
  a.part = static_cast<float*>(scratch);
  a.count = static_cast<unsigned*>(counts);
  a.layer = layer;
  a.B = B;
  a.Hkv = Hkv;
  a.S = S;
  a.D = D;
  a.n_rep = n_rep;
  a.split = split;
  a.n_splits = (S + split - 1) / split;
  a.groups = (n_rep + kGroup - 1) / kGroup;
  a.qscale = qscale;
  return a;
}

// K3b / K22: the options pick the instance
int launch_one_shot(const AttnArgs& a, float softcap, float inv_softcap, const void* slopes, const void* window,
                    void* stream) {
  AttnExtra x{};
  x.cap = softcap;
  x.inv_cap = inv_softcap;
  x.slopes = static_cast<const float*>(slopes);
  x.window = static_cast<const int*>(window);
  const bool cap = softcap != 0.f, alibi = slopes != nullptr;
  if (cap) return alibi ? launch_attn<kOneShot, true, true>(a, x, stream) : launch_attn<kOneShot, true, false>(a, x, stream);
  return alibi ? launch_attn<kOneShot, false, true>(a, x, stream) : launch_attn<kOneShot, false, false>(a, x, stream);
}

}  // namespace

// The scratch holds B * Hkv * ceil(n_rep / 8) * ceil(S / split) * 8 * (D + 2)
// floats; counts B * Hkv * ceil(n_rep / 8) words that are zero between
// launches (each launch leaves them so).
QLLM_API int qllm_decode_attn_int8(const void* q, const void* k_cache, const void* v_cache,
                                   const void* k_scale, const void* v_scale, const void* lengths,
                                   void* out, int layer, int B, int Hkv, int S, int D, int n_rep,
                                   float qscale, float softcap, float inv_softcap, const void* slopes,
                                   const void* window, void* scratch, void* counts, int split, void* stream) {
  if (!attn_shape_ok(B, Hkv, S, D, n_rep, split)) return static_cast<int>(cudaErrorInvalidValue);
  const AttnArgs a = attn_args(q, k_cache, v_cache, k_scale, v_scale, lengths, out, scratch, counts, layer, B, Hkv,
                               S, D, n_rep, split, qscale);
  return launch_one_shot(a, softcap, inv_softcap, slopes, window, stream);
}

// K22: a per-layer [B, Hkv, S, D] cache is a one-layer stack
QLLM_API int qllm_decode_attn_int8_4d(const void* q, const void* k_cache, const void* v_cache,
                                      const void* k_scale, const void* v_scale, const void* lengths,
                                      void* out, int B, int Hkv, int S, int D, int n_rep, float qscale,
                                      float softcap, float inv_softcap, const void* slopes,
                                      const void* window, void* scratch, void* counts, int split, void* stream) {
  return qllm_decode_attn_int8(q, k_cache, v_cache, k_scale, v_scale, lengths, out, 0, B, Hkv, S, D, n_rep, qscale,
                               softcap, inv_softcap, slopes, window, scratch, counts, split, stream);
}

QLLM_API int qllm_decode_attn_int8_partial(const void* q, const void* k_cache, const void* v_cache,
                                           const void* k_scale, const void* v_scale, const void* lengths,
                                           void* acc, void* m, void* den, int layer, int B, int Hkv,
                                           int S, int D, int n_rep, float qscale, void* scratch, void* counts,
                                           int split, void* stream) {
  if (!attn_shape_ok(B, Hkv, S, D, n_rep, split)) return static_cast<int>(cudaErrorInvalidValue);
  AttnExtra x{};
  x.m_out = static_cast<float*>(m);
  x.den_out = static_cast<float*>(den);
  const AttnArgs a = attn_args(q, k_cache, v_cache, k_scale, v_scale, lengths, acc, scratch, counts, layer, B, Hkv,
                               S, D, n_rep, split, qscale);
  return launch_attn<kPartial, false, false>(a, x, stream);
}

QLLM_API int qllm_decode_attn_ring(const void* q, const void* k_new, const void* v_new,
                                   const void* k_cache, const void* v_cache, const void* k_scale,
                                   const void* v_scale, void* ring_k, void* ring_v,
                                   const void* lengths, void* out, int layer, int B, int Hkv, int S,
                                   int D, int n_rep, float qscale, void* scratch, void* counts, int split,
                                   void* stream) {
  if (!attn_shape_ok(B, Hkv, S, D, n_rep, split)) return static_cast<int>(cudaErrorInvalidValue);
  AttnExtra x{};
  x.k_new = static_cast<const __nv_bfloat16*>(k_new);
  x.v_new = static_cast<const __nv_bfloat16*>(v_new);
  x.rk = static_cast<__nv_bfloat16*>(ring_k);
  x.rv = static_cast<__nv_bfloat16*>(ring_v);
  const AttnArgs a = attn_args(q, k_cache, v_cache, k_scale, v_scale, lengths, out, scratch, counts, layer, B, Hkv,
                               S, D, n_rep, split, qscale);
  return launch_attn<kRingMode, false, false>(a, x, stream);
}

// ---------------------------------------------------------------------------
// K7 kv_ring_flush.
//
// Replaces _ring_flush_kernel / kv_ring_flush_pallas
// (pallas_attention.py:1423, :1470): every layer's FULL ring (8 bf16 rows
// per (layer, b, kv-head)) is quantized as K3a quantizes a token, scale =
// max(amax / 127, 1e-8) by division, round half to even, clip to +-127,
// and written with its scales into rows [pos[b] - 8, pos[b]) in place;
// one launch for all layers. The TPU kernel scatters the 8 scales into
// the whole [S] scale row through a one-hot sum; here each row's scale
// is one store.
//
// Bound on the H100: bytes (each ring read once, int8 rows and scales
// written once), a few microseconds at 7B; grid (L, B, Hkv) blocks of
// 8 warps, one warp per ring row.
// ---------------------------------------------------------------------------

namespace {

constexpr int kFlushThreads = 32 * kRingRows;

__global__ void __launch_bounds__(kFlushThreads)
    ring_flush_kernel(const __nv_bfloat16* __restrict__ rk, const __nv_bfloat16* __restrict__ rv,
                      int8_t* __restrict__ kc, int8_t* __restrict__ vc, float* __restrict__ ks,
                      float* __restrict__ vs, const int* __restrict__ pos, int B, int H, int S,
                      int D) {
  const int lbh = blockIdx.x;  // (layer * B + b) * H + h
  const int b = (lbh / H) % B;
  const int p = pos[b];
  if (p < kRingRows || p > S) return;  // uniform across the block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t src = (static_cast<size_t>(lbh) * kRingRows + warp) * D;
  const size_t row = static_cast<size_t>(lbh) * S + (p - kRingRows + warp);
  for (int which = 0; which < 2; ++which) {
    const __nv_bfloat16* ring = which ? rv : rk;
    int8_t* cache = which ? vc : kc;
    float* scale_row = which ? vs : ks;
    float amax = 0.f;
    for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(bf2f(ring[src + d])));
    amax = warp_max(amax);
    const float scale = fmaxf(amax / 127.0f, 1e-8f);
    for (int d = lane; d < D; d += 32) {
      float qv = rintf(bf2f(ring[src + d]) / scale);  // divide, half to even: as jnp
      qv = fminf(fmaxf(qv, -127.f), 127.f);
      cache[row * D + d] = static_cast<int8_t>(qv);
    }
    if (lane == 0) scale_row[row] = scale;
  }
}

}  // namespace

QLLM_API int qllm_kv_ring_flush(const void* ring_k, const void* ring_v, void* k_cache,
                                void* v_cache, void* k_scale, void* v_scale, const void* pos,
                                int L, int B, int H, int S, int D, void* stream) {
  if (L < 1 || B < 1 || H < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  ring_flush_kernel<<<L * B * H, kFlushThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(ring_k), static_cast<const __nv_bfloat16*>(ring_v),
      static_cast<int8_t*>(k_cache), static_cast<int8_t*>(v_cache), static_cast<float*>(k_scale),
      static_cast<float*>(v_scale), static_cast<const int*>(pos), B, H, S, D);
  return qllm_launch_status();
}
