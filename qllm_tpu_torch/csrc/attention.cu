// K3a kv_write_int8, K3b decode_attn_int8, K6 decode_attention_ring and
// K7 kv_ring_flush: the decode step's KV write and single-query
// attention over the int8 KV cache (k/v [L, B, Hkv, S, D] int8, scales
// [L, B, Hkv, S] f32) and its bf16 rings ([L, B, Hkv, 8, D]).

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
// out); the launch itself dominates. One block per (b, kv-head), one
// thread per element, one block-wide max.
// ---------------------------------------------------------------------------

namespace {

constexpr int kWriteThreads = 128;

__device__ __forceinline__ float load_in(const void* p, int f32, size_t i) {
  return f32 ? static_cast<const float*>(p)[i] : bf2f(static_cast<const __nv_bfloat16*>(p)[i]);
}

__global__ void __launch_bounds__(kWriteThreads)
    kv_write_kernel(const void* __restrict__ k_new, const void* __restrict__ v_new, int in_f32,
                    int8_t* __restrict__ kc, int8_t* __restrict__ vc, float* __restrict__ ks,
                    float* __restrict__ vs, const int* __restrict__ pos, int layer, int B, int H,
                    int S, int D) {
  __shared__ float red[kWriteThreads / 32];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int p = pos[b];
  if (p < 0 || p >= S) return;  // uniform across the block
  const size_t row = ((static_cast<size_t>(layer) * B + b) * H + h) * S + p;
  for (int which = 0; which < 2; ++which) {
    const void* src = which ? v_new : k_new;
    int8_t* cache = which ? vc : kc;
    float* scale_row = which ? vs : ks;
    float amax = 0.f;
    for (int d = tid; d < D; d += kWriteThreads)
      amax = fmaxf(amax, fabsf(load_in(src, in_f32, static_cast<size_t>(bh) * D + d)));
    amax = warp_max(amax);
    if ((tid & 31) == 0) red[tid >> 5] = amax;
    __syncthreads();
    amax = red[0];
    for (int w = 1; w < kWriteThreads / 32; ++w) amax = fmaxf(amax, red[w]);
    const float scale = fmaxf(amax / 127.0f, 1e-8f);
    for (int d = tid; d < D; d += kWriteThreads) {
      // divide (not multiply by the reciprocal) and round half to even,
      // as jnp.round does, so the int8 values equal the JAX kernel's
      float q = rintf(load_in(src, in_f32, static_cast<size_t>(bh) * D + d) / scale);
      q = fminf(fmaxf(q, -127.f), 127.f);
      cache[row * D + d] = static_cast<int8_t>(q);
    }
    if (tid == 0) scale_row[row] = scale;
    __syncthreads();  // red is reused by the next tensor
  }
}

}  // namespace

QLLM_API int qllm_kv_write_int8(const void* k_new, const void* v_new, void* k_cache,
                                void* v_cache, void* k_scale, void* v_scale, const void* pos,
                                int in_f32, int layer, int B, int H, int S, int D, void* stream) {
  if (B < 1 || H < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  kv_write_kernel<<<B * H, kWriteThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      k_new, v_new, in_f32, static_cast<int8_t*>(k_cache), static_cast<int8_t*>(v_cache),
      static_cast<float*>(k_scale), static_cast<float*>(v_scale), static_cast<const int*>(pos),
      layer, B, H, S, D);
  return qllm_launch_status();
}

// ---------------------------------------------------------------------------
// K3b decode_attn_int8.
//
// Replaces _attn_kernel_stacked / _decode_attention_stacked
// (pallas_attention.py:97, :457) behind decode_attention_pallas (:574),
// S <= 8192, and _attn_kernel_stacked_chunked /
// _decode_attention_stacked_chunked (:284, :371), the key-chunked online
// softmax the TPU takes at S > 8192: one query token per sequence
// attends over its first lengths[b] cache rows. q is scaled by D^-0.5 in f32 and rounded to
// bf16; scores = (q . k_int8) * ks, positions >= lengths[b] are masked,
// softmax in f32; the probabilities times vs are rounded to bf16 before
// the product with v_int8 (the v scale folds into the probabilities);
// output f32 [B, H, D].
//
// Bound on the H100: bytes (every int8 K and V row of the sequence is
// read once, ~2 flops per byte per query head). Design: one block per
// (b, kv-head) serving its n_rep query heads, so each K/V row is read
// once for the whole GQA group; the TPU's one-shot kernel holds the whole
// [S, D] block in VMEM, which 227 KB of shared memory cannot at S = 8192,
// so the block walks S in tiles of 128 keys with an online softmax
// (running max and denominator, accumulators rescaled per tile): the
// chunked kernel's function at any S. Offsets are 64-bit (a 16384-row
// cache passes 2^31 bytes). At long S one block walks every tile of its
// (b, kv-head) in turn: B * Hkv blocks, S / 128 tiles each, so the time
// follows S, not the card's width (splitting S over blocks is the fix). Scores: one key
// per thread, 16-byte loads of its K row; P.V: one head dimension per
// thread, a warp reading one 128-byte V row per key.
//
// K6 decode_attention_ring is the same kernel with kRing set.
//
// Replaces _attn_kernel_stacked_ring / decode_attention_ring
// (pallas_attention.py:1212, :1309): lengths[b] = pos counts the past
// tokens; rows [0, flushed = pos / 8 * 8) are int8 in the cache, rows
// [flushed, pos) bf16 in ring slots [0, nring = pos - flushed), and the
// current token's k / v arrive as operands. The int8 rows run through
// K3b's tiles (reading only [0, flushed) computes the same function as
// the TPU kernel's masked full-S block), then one last tile holds the
// nring ring rows (bf16 products, f32 sums, probabilities rounded to
// bf16 for P.V) and the current token (score sum(bf16(q) * k_new) and
// value p * v_new, both in f32, unrounded). The kernel then writes the
// bf16 k_new / v_new into ring slot nring of this layer in place;
// no other slot or layer is touched, and the int8 cache is read only.
// Bound on the H100: bytes, as K3b; at batch 1 it runs Hkv = 32 blocks
// on 132 SMs, which is what holds it back.
// ---------------------------------------------------------------------------

namespace {

constexpr int kAttnThreads = 128;  // = keys per tile
constexpr int kMaxRep = 8;
constexpr int kMaxD = 256;
constexpr int kRingRows = 8;

template <bool kRing>
__global__ void __launch_bounds__(kAttnThreads)
    decode_attn_kernel(const __nv_bfloat16* __restrict__ q,  // [B, H, D]
                       const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
                       const float* __restrict__ ks, const float* __restrict__ vs,
                       const int* __restrict__ lengths, float* __restrict__ out,  // [B, H, D]
                       int layer, int B, int Hkv, int S, int D, int n_rep, float qscale,
                       // kRing only: this step's k / v [B, Hkv, D] and the rings
                       const __nv_bfloat16* __restrict__ k_new, const __nv_bfloat16* __restrict__ v_new,
                       __nv_bfloat16* __restrict__ rk, __nv_bfloat16* __restrict__ rv) {
  __shared__ float qs[kMaxRep][kMaxD];
  __shared__ float pt[kMaxRep][kAttnThreads];  // scores, then bf16(p * vs)
  __shared__ float red[kMaxRep][kAttnThreads / 32];
  __shared__ float m_run[kMaxRep], l_run[kMaxRep], alpha[kMaxRep];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;  // b * Hkv + hk
  const int b = bh / Hkv, hk = bh % Hkv;
  const int H = Hkv * n_rep;
  // K3b: the first lengths[b] rows; the ring kernel: the flushed rows
  const int len = kRing ? min(lengths[b] / kRingRows * kRingRows, S) : min(lengths[b], S);
  const size_t base = ((static_cast<size_t>(layer) * B + b) * Hkv + hk) * S;  // cache row 0

  for (int i = tid; i < n_rep * D; i += kAttnThreads) {
    const int r = i / D, d = i % D;
    qs[r][d] = round_bf16(bf2f(q[(static_cast<size_t>(b) * H + hk * n_rep + r) * D + d]) * qscale);
  }
  if (tid < n_rep) {
    m_run[tid] = neg_inf();
    l_run[tid] = 0.f;
  }
  float acc[kMaxRep][kMaxD / kAttnThreads];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r)
#pragma unroll
    for (int i = 0; i < kMaxD / kAttnThreads; ++i) acc[r][i] = 0.f;
  __syncthreads();

  // the tile's new running max per head (after pt holds the scores and
  // red the warps' maxima) and the factor alpha for the old sums
  auto update_max = [&]() {
    __syncthreads();
    if (tid < n_rep) {
      float tmax = red[tid][0];
      for (int w = 1; w < kAttnThreads / 32; ++w) tmax = fmaxf(tmax, red[tid][w]);
      const float m_new = fmaxf(m_run[tid], tmax);
      alpha[tid] = expf(m_run[tid] - m_new);  // 0 on the first tile
      m_run[tid] = m_new;
    }
    __syncthreads();
  };
  auto update_sum = [&]() {
    __syncthreads();
    if (tid < n_rep) {
      float tsum = 0.f;
      for (int w = 0; w < kAttnThreads / 32; ++w) tsum += red[tid][w];
      l_run[tid] = l_run[tid] * alpha[tid] + tsum;
    }
  };

  for (int s0 = 0; s0 < len; s0 += kAttnThreads) {
    const int s = s0 + tid;
    const bool valid = s < len;
    // scores for this thread's key, every head of the group
    for (int r = 0; r < n_rep; ++r) {
      float score = neg_inf();
      if (valid) {
        const int8_t* krow = kc + (base + s) * D;
        float dot = 0.f;
        for (int d0 = 0; d0 < D; d0 += 16) {
          const int4 kv = *reinterpret_cast<const int4*>(krow + d0);
          const int8_t* kb = reinterpret_cast<const int8_t*>(&kv);
#pragma unroll
          for (int i = 0; i < 16; ++i) dot = fmaf(qs[r][d0 + i], static_cast<float>(kb[i]), dot);
        }
        score = dot * ks[base + s];
      }
      pt[r][tid] = score;
      const float wmax = warp_max(score);
      if (lane == 0) red[r][warp] = wmax;
    }
    update_max();
    for (int r = 0; r < n_rep; ++r) {
      float p = 0.f, pv = 0.f;
      if (valid) {
        p = expf(pt[r][tid] - m_run[r]);
        pv = round_bf16(p * vs[base + s]);
      }
      pt[r][tid] = pv;
      const float wsum = warp_sum(p);
      if (lane == 0) red[r][warp] = wsum;
    }
    update_sum();
    const int nk = min(kAttnThreads, len - s0);
    // head loops run to the compile-time bound so acc stays in registers
#pragma unroll
    for (int i = 0; i < kMaxD / kAttnThreads; ++i) {
      const int d = tid + i * kAttnThreads;
      if (d < D) {
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r)
          if (r < n_rep) acc[r][i] *= alpha[r];
        const int8_t* vcol = vc + (base + s0) * D + d;
        for (int j = 0; j < nk; ++j) {
          const float v = static_cast<float>(vcol[static_cast<size_t>(j) * D]);
#pragma unroll
          for (int r = 0; r < kMaxRep; ++r)
            if (r < n_rep) acc[r][i] = fmaf(pt[r][j], v, acc[r][i]);
        }
      }
    }
    __syncthreads();  // pt / red / alpha are rewritten by the next tile
  }

  if constexpr (kRing) {
    // the last tile: ring rows [0, nring), then the current token as entry nring
    __shared__ float vt[kRingRows + 1][kMaxD];  // their v rows in f32
    const int nring = min(max(lengths[b] - len, 0), kRingRows - 1);
    const size_t rbase = ((static_cast<size_t>(layer) * B + b) * Hkv + hk) * kRingRows * D;
    const size_t nbase = static_cast<size_t>(bh) * D;
    for (int i = tid; i < (nring + 1) * D; i += kAttnThreads) {
      const int j = i / D, d = i % D;
      vt[j][d] = bf2f(j < nring ? rv[rbase + static_cast<size_t>(j) * D + d] : v_new[nbase + d]);
    }
    const bool valid = tid <= nring;
    for (int r = 0; r < n_rep; ++r) {
      float score = neg_inf();
      if (valid) {
        float dot = 0.f;
        if (tid < nring) {
          const __nv_bfloat16* krow = rk + rbase + static_cast<size_t>(tid) * D;
          for (int d = 0; d < D; ++d) dot = fmaf(qs[r][d], bf2f(krow[d]), dot);
        } else {
          for (int d = 0; d < D; ++d) dot = fmaf(qs[r][d], bf2f(k_new[nbase + d]), dot);
        }
        score = dot;
      }
      pt[r][tid] = score;
      const float wmax = warp_max(score);
      if (lane == 0) red[r][warp] = wmax;
    }
    update_max();
    for (int r = 0; r < n_rep; ++r) {
      float p = 0.f;
      if (valid) p = expf(pt[r][tid] - m_run[r]);
      pt[r][tid] = tid < nring ? round_bf16(p) : p;  // the current token's p stays f32
      const float wsum = warp_sum(p);
      if (lane == 0) red[r][warp] = wsum;
    }
    update_sum();
#pragma unroll
    for (int i = 0; i < kMaxD / kAttnThreads; ++i) {
      const int d = tid + i * kAttnThreads;
      if (d < D) {
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r)
          if (r < n_rep) acc[r][i] *= alpha[r];
        for (int j = 0; j <= nring; ++j) {
          const float v = vt[j][d];
#pragma unroll
          for (int r = 0; r < kMaxRep; ++r)
            if (r < n_rep) acc[r][i] = fmaf(pt[r][j], v, acc[r][i]);
        }
      }
    }
    // append this token to ring slot nring (never read above)
    for (int d = tid; d < D; d += kAttnThreads) {
      rk[rbase + static_cast<size_t>(nring) * D + d] = k_new[nbase + d];
      rv[rbase + static_cast<size_t>(nring) * D + d] = v_new[nbase + d];
    }
    __syncthreads();  // l_run is final
  }

#pragma unroll
  for (int i = 0; i < kMaxD / kAttnThreads; ++i) {
    const int d = tid + i * kAttnThreads;
    if (d < D) {
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r)
        if (r < n_rep) out[(static_cast<size_t>(b) * H + hk * n_rep + r) * D + d] = acc[r][i] / l_run[r];
    }
  }
}

}  // namespace

QLLM_API int qllm_decode_attn_int8(const void* q, const void* k_cache, const void* v_cache,
                                   const void* k_scale, const void* v_scale, const void* lengths,
                                   void* out, int layer, int B, int Hkv, int S, int D, int n_rep,
                                   float qscale, void* stream) {
  if (n_rep < 1 || n_rep > kMaxRep || D > kMaxD || D % 16 != 0 || B < 1 || Hkv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  decode_attn_kernel<false><<<B * Hkv, kAttnThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k_cache),
      static_cast<const int8_t*>(v_cache), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(lengths),
      static_cast<float*>(out), layer, B, Hkv, S, D, n_rep, qscale, nullptr, nullptr, nullptr, nullptr);
  return qllm_launch_status();
}

QLLM_API int qllm_decode_attn_ring(const void* q, const void* k_new, const void* v_new,
                                   const void* k_cache, const void* v_cache, const void* k_scale,
                                   const void* v_scale, void* ring_k, void* ring_v,
                                   const void* lengths, void* out, int layer, int B, int Hkv, int S,
                                   int D, int n_rep, float qscale, void* stream) {
  if (n_rep < 1 || n_rep > kMaxRep || D > kMaxD || D % 16 != 0 || B < 1 || Hkv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  decode_attn_kernel<true><<<B * Hkv, kAttnThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k_cache),
      static_cast<const int8_t*>(v_cache), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(lengths),
      static_cast<float*>(out), layer, B, Hkv, S, D, n_rep, qscale,
      static_cast<const __nv_bfloat16*>(k_new), static_cast<const __nv_bfloat16*>(v_new),
      static_cast<__nv_bfloat16*>(ring_k), static_cast<__nv_bfloat16*>(ring_v));
  return qllm_launch_status();
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
