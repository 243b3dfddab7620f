// K5 flash_prefill: causal GQA prefill attention over int8 cache-native
// or bf16 K/V, with an online softmax over key tiles.
//
// Replaces _flash_prefill_kernel_1kv and _flash_prefill_kernel behind
// prefill_attention_flash (qllm_tpu/ops/pallas_attention.py:751, :791,
// :872). Both TPU kernels compute one function (the first for caches
// that fit one key block, the second with an online softmax), so one
// kernel serves both:
//   q' = bf16(f32(q) * D^-0.5); scores = (q' . k) [* ks per key];
//   key s is visible to query t of sequence b iff s <= pos[b] + t and
//   s < S (else -1e30); p = exp(score - running max); the denominator
//   sums p in f32; P.V takes bf16(p [* vs per key]) against bf16 / int8
//   V with f32 sums; out = acc / den.
// int8 K / V enter the MMA as bf16 (exact); the per-key k scale
// multiplies the score columns and the v scale the probabilities, as
// in the TPU kernel (pallas_attention.py:704-748).
//
// Bound on the H100: at T = S = 2048 (H = 32, D = 128) the causal
// products are ~3.4e10 flops per layer against ~35 MB, far above the
// bf16 ridge, so the tensor cores bound it; at T = 512 it is near the
// ridge. Design: the products run on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulate). One block per (b, kv-head,
// q-tile): its 64 rows are q positions x the n_rep heads of the group,
// so each K/V tile is read once per group, as in the TPU kernel. Four
// warps own 16 rows each; q stays in registers as the A operand of
// Q.K^T, the score fragments become the A operand of P.V in registers,
// and K / V tiles of 64 keys are staged in shared memory as bf16 (rows
// padded by 16 bytes so the fragment reads are free of bank conflicts).
// The key loop stops at the last key visible to the tile, as the TPU
// kernel skips invisible tiles (pallas_attention.py:833-860), and the
// tiles with the longest key ranges are scheduled first. wgmma / TMA /
// a pipelined tile ring are later work.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows of a block (q positions x heads of the group)
constexpr int kKeys = 64;           // keys per tile
constexpr int kD = 128;
constexpr int kRowPitch = kD + 8;  // bf16 per staged row
constexpr int kMaxRep = 8;
constexpr float kMasked = -1e30f;  // the TPU kernel's mask value (pallas_attention.py:281)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bf16x2_bits(__floats2bfloat162_rn(lo, hi));
}

// 16 int8 values -> 16 exact bf16 values in two 16-byte words
__device__ __forceinline__ void int8x16_to_bf16(int4 raw, uint4& lo, uint4& hi) {
  const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = pack_bf16(static_cast<float>(v[2 * i]), static_cast<float>(v[2 * i + 1]));
  lo = make_uint4(w[0], w[1], w[2], w[3]);
  hi = make_uint4(w[4], w[5], w[6], w[7]);
}

template <bool kInt8, bool kOutF32>
__global__ void __launch_bounds__(kThreads)
    flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,  // [B, T, H, D]
                         const void* __restrict__ k,           // row (b, h, s) at b*sb + h*sh + s*ss
                         const void* __restrict__ v,
                         const float* __restrict__ ks,  // [B, Hkv, S] (int8 K/V)
                         const float* __restrict__ vs,
                         const int* __restrict__ pos,  // [B]
                         void* __restrict__ out,       // [B, T, H, D]
                         int T, int S, int Hkv, int n_rep, long long sb, long long sh, long long ss,
                         float qscale) {
  __shared__ __align__(16) __nv_bfloat16 Ks[kKeys][kRowPitch];
  __shared__ __align__(16) __nv_bfloat16 Vs[kKeys][kRowPitch];
  __shared__ float kss[kKeys], vss[kKeys];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, c = lane & 3;
  const int tq = kRows / n_rep;                         // q positions per block
  const int tile = gridDim.x - 1 - blockIdx.x;          // longest key ranges first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int H = Hkv * n_rep;
  const int t0 = tile * tq;
  const int p0 = pos[b];
  const int kend = min(S, p0 + min(T, t0 + tq));       // keys [0, kend) are visible to the tile

  // this thread's two rows (gq and gq + 8 of the warp's 16): query t, head
  // hk * n_rep + rep; a row past the tile or past T computes row t0, head
  // 0 of the group, and is not stored
  int row_t[2], row_h[2], row_pos[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gq + 8 * i;
    const int t = t0 + r / n_rep;
    row_ok[i] = r < tq * n_rep && t < T;
    row_t[i] = row_ok[i] ? t : t0;
    row_h[i] = hk * n_rep + (row_ok[i] ? r % n_rep : 0);
    row_pos[i] = p0 + row_t[i];
  }

  // q' as the A operand of Q.K^T: 8 k-steps of 16 head dimensions
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat16* qr = q + ((static_cast<size_t>(b) * T + row_t[i]) * H + row_h[i]) * kD + 16 * kk + 2 * c;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qr + 8 * half));
        qa[kk][i + 2 * half] = pack_bf16(f.x * qscale, f.y * qscale);
      }
    }
  }

  float o[kD / 8][4];
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m_run[2] = {kMasked, kMasked}, l_run[2] = {0.f, 0.f};

  constexpr int kElt = kInt8 ? 1 : 2;
  const char* kbase = static_cast<const char*>(k) + (b * sb + hk * sh) * kElt;
  const char* vbase = static_cast<const char*>(v) + (b * sb + hk * sh) * kElt;
  const size_t sbase = (static_cast<size_t>(b) * Hkv + hk) * S;

  for (int j0 = 0; j0 < kend; j0 += kKeys) {
    __syncthreads();  // the previous tile's reads are done
    // stage keys [j0, j0 + 64) as bf16; rows past kend are zeros
    constexpr int kChunks = kD * kElt / 16;  // 16-byte chunks per row
    for (int i = tid; i < kKeys * kChunks; i += kThreads) {
      const int j = i / kChunks, ch = i % kChunks;
      const long long off = (j0 + j) * ss * kElt + ch * 16;
      const bool in = j0 + j < kend;
      const int4 kr = in ? *reinterpret_cast<const int4*>(kbase + off) : make_int4(0, 0, 0, 0);
      const int4 vr = in ? *reinterpret_cast<const int4*>(vbase + off) : make_int4(0, 0, 0, 0);
      if constexpr (kInt8) {
        uint4 lo, hi;
        int8x16_to_bf16(kr, lo, hi);
        *reinterpret_cast<uint4*>(&Ks[j][16 * ch]) = lo;
        *reinterpret_cast<uint4*>(&Ks[j][16 * ch + 8]) = hi;
        int8x16_to_bf16(vr, lo, hi);
        *reinterpret_cast<uint4*>(&Vs[j][16 * ch]) = lo;
        *reinterpret_cast<uint4*>(&Vs[j][16 * ch + 8]) = hi;
      } else {
        *reinterpret_cast<int4*>(&Ks[j][8 * ch]) = kr;
        *reinterpret_cast<int4*>(&Vs[j][8 * ch]) = vr;
      }
    }
    if constexpr (kInt8) {
      if (tid < kKeys) {
        const bool in = j0 + tid < kend;
        kss[tid] = in ? ks[sbase + j0 + tid] : 0.f;
        vss[tid] = in ? vs[sbase + j0 + tid] : 0.f;
      }
    }
    __syncthreads();

    // scores: 16 rows x 64 keys per warp, 8 fragments of 8 keys
    float sc[kKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt) {
        const __nv_bfloat16* kr = &Ks[nt * 8 + gq][16 * kk + 2 * c];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
        mma_bf16_16816(sc[nt], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], b0, b1);
      }
    }

    // k scale, causal mask, running max per row
    float tmax[2] = {kMasked, kMasked};
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = nt * 8 + 2 * c + (e & 1), i = e >> 1;
        const int s = j0 + jj;
        float x = sc[nt][e];
        if constexpr (kInt8) x *= kss[jj];
        if (s > row_pos[i] || s >= S) x = kMasked;
        sc[nt][e] = x;
        tmax[i] = fmaxf(tmax[i], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m_run[i], tmax[i]);
      corr[i] = expf(m_run[i] - m_new);  // 0 on the first tile
      m_run[i] = m_new;
    }

    // probabilities: the denominator takes p, P.V takes bf16(p [* vs])
    float psum[2] = {0.f, 0.f};
    uint32_t pa[kKeys / 8][2];  // bf16 pairs (row gq, row gq + 8) per 8-key fragment
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(sc[nt][e] - m_run[e >> 1]);
        psum[e >> 1] += p[e];
        if constexpr (kInt8) p[e] *= vss[nt * 8 + 2 * c + (e & 1)];
      }
      pa[nt][0] = pack_bf16(p[0], p[1]);
      pa[nt][1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
      l_run[i] = l_run[i] * corr[i] + psum[i];
    }
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      o[nt][0] *= corr[0];
      o[nt][1] *= corr[0];
      o[nt][2] *= corr[1];
      o[nt][3] *= corr[1];
    }

    // P.V: 4 k-steps of 16 keys; the B fragment pairs two keys of one
    // head dimension, read as two halves from the row-major V tile
    const unsigned short* vbits = reinterpret_cast<const unsigned short*>(&Vs[0][0]);
#pragma unroll
    for (int kc = 0; kc < kKeys / 16; ++kc) {
      const uint32_t a0 = pa[2 * kc][0], a1 = pa[2 * kc][1];
      const uint32_t a2 = pa[2 * kc + 1][0], a3 = pa[2 * kc + 1][1];
      const int key = 16 * kc + 2 * c;
#pragma unroll
      for (int nt = 0; nt < kD / 8; ++nt) {
        const int col = nt * 8 + gq;
        const uint32_t b0 = vbits[key * kRowPitch + col] | (static_cast<uint32_t>(vbits[(key + 1) * kRowPitch + col]) << 16);
        const uint32_t b1 =
            vbits[(key + 8) * kRowPitch + col] | (static_cast<uint32_t>(vbits[(key + 9) * kRowPitch + col]) << 16);
        mma_bf16_16816(o[nt], a0, a1, a2, a3, b0, b1);
      }
    }
  }

  // out = acc / den for this thread's rows, head dimensions nt*8 + 2c, +1
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    const size_t orow = ((static_cast<size_t>(b) * T + row_t[i]) * H + row_h[i]) * kD;
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      const float x0 = o[nt][2 * i] / l_run[i], x1 = o[nt][2 * i + 1] / l_run[i];
      const size_t at = orow + nt * 8 + 2 * c;
      if constexpr (kOutF32)
        *reinterpret_cast<float2*>(static_cast<float*>(out) + at) = make_float2(x0, x1);
      else
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + at) = __floats2bfloat162_rn(x0, x1);
    }
  }
}

template <bool kInt8>
void launch_flash(bool out_f32, dim3 grid, cudaStream_t st, const __nv_bfloat16* q, const void* k, const void* v,
                  const float* ks, const float* vs, const int* pos, void* out, int T, int S, int Hkv, int n_rep,
                  long long sb, long long sh, long long ss, float qscale) {
  if (out_f32)
    flash_prefill_kernel<kInt8, true><<<grid, kThreads, 0, st>>>(q, k, v, ks, vs, pos, out, T, S, Hkv, n_rep, sb,
                                                                 sh, ss, qscale);
  else
    flash_prefill_kernel<kInt8, false><<<grid, kThreads, 0, st>>>(q, k, v, ks, vs, pos, out, T, S, Hkv, n_rep, sb,
                                                                  sh, ss, qscale);
}

}  // namespace

// K/V row (b, kv-head h, key s) starts at element b*sb + h*sh + s*ss and
// holds D contiguous values; every row start must be 16-byte aligned.
QLLM_API int qllm_flash_prefill(const void* q, const void* k, const void* v, const void* k_scale,
                                const void* v_scale, const void* pos, void* out, int B, int T, int S,
                                int Hkv, int n_rep, int D, long long sb, long long sh, long long ss,
                                int kv_int8, int out_f32, float qscale, void* stream) {
  if (B < 1 || T < 1 || S < 1 || Hkv < 1 || n_rep < 1 || n_rep > kMaxRep || D != kD)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tq = kRows / n_rep;
  const dim3 grid((T + tq - 1) / tq, Hkv, B);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* ksf = static_cast<const float*>(k_scale);
  const auto* vsf = static_cast<const float*>(v_scale);
  const auto* pp = static_cast<const int*>(pos);
  if (kv_int8)
    launch_flash<true>(out_f32 != 0, grid, st, qb, k, v, ksf, vsf, pp, out, T, S, Hkv, n_rep, sb, sh, ss, qscale);
  else
    launch_flash<false>(out_f32 != 0, grid, st, qb, k, v, ksf, vsf, pp, out, T, S, Hkv, n_rep, sb, sh, ss, qscale);
  return qllm_launch_status();
}
