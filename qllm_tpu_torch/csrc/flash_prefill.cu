// K5 flash_prefill: causal GQA prefill attention over int8 cache-native
// or bf16 K/V, with an online softmax over key tiles, the logit softcap
// and a sliding window.
//
// Replaces _flash_prefill_kernel_1kv and _flash_prefill_kernel behind
// prefill_attention_flash (qllm_tpu/ops/pallas_attention.py:751, :791,
// :872). Both TPU kernels compute one function (the first for caches
// that fit one key block, the second with an online softmax), so one
// kernel serves both:
//   q' = bf16(f32(q) * D^-0.5); scores = (q' . k) [* ks per key];
//   with a softcap, cap * tanh(score / cap) (_flash_qk :705-727, exact
//   tanhf); key s is visible to query t of sequence b iff
//   pos[b] + t - win < s <= pos[b] + t and s < S (else -1e30;
//   _flash_mask :730-738, win = S + 1 without a window, an int32 in device
//   memory); p = exp(score - running max); the denominator sums p in f32;
//   P.V takes bf16(p [* vs per key]) against bf16 / int8 V with f32 sums;
//   out = acc / den.
// int8 K / V enter the MMA as bf16 (exact); the per-key k scale
// multiplies the score columns and the v scale the probabilities, as
// in the TPU kernel (pallas_attention.py:704-748).
//
// Bound on the H100: at T = S = 2048 (H = 32, D = 128) the causal
// products are ~3.4e10 flops per layer against ~35 MB, far above the
// bf16 ridge, so the tensor cores bound it; at T = 512 it is near the
// ridge. Design: the products run on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulate). A block takes 64 rows of the flat
// (q position, query head of the group) order of one (b, kv head), so
// each K/V tile is read once for the group's heads at any n_rep (JAX
// serves any n_rep too). Four warps own 16 rows each; at D = 128 q stays
// in registers as the A operand of Q.K^T, at D = 256 it is staged in
// shared memory (the registers hold the 256-wide output instead) and the
// key tiles are 32 keys; the score fragments become the A operand of P.V
// in registers, and K / V tiles are staged in shared memory as bf16 (rows
// padded by 16 bytes so the fragment reads are free of bank conflicts).
// At D = 384 and 512 the 64 x D f32 output does not fit in registers, so
// the output width is split across blocks: each block scores with the
// full D (q staged as at D = 256) and runs P.V for its slice of kDV = 128
// (D = 384) or 256 (D = 512) head dimensions, staging only that slice of
// V; every slice computes the same softmax statistics.
// The key loop walks only the keys visible to the block: from the tile
// holding pos + t_first - win + 1 to the last key visible to its last
// row, as the TPU kernel skips invisible tiles (pallas_attention.py:
// 833-860); the visible keys of consecutive rows overlap, so no walked
// tile is invisible to every row. The tiles with the longest key ranges
// are scheduled first. wgmma / TMA / a pipelined tile ring are later work.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows of a block (flat q position x head of the group)
constexpr float kMasked = -1e30f;   // the TPU kernel's mask value (pallas_attention.py:281)

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

template <int kD>
struct FlashShape {
  static constexpr int kKeys = kD == 128 ? 64 : 32;  // keys per tile
  static constexpr int kPitch = kD + 8;              // bf16 per staged K (and q) row
  static constexpr int kDV = kD == 384 ? 128 : kD == 512 ? 256 : kD;  // output width of a block
  static constexpr int kVPitch = kDV + 8;            // bf16 per staged V row
  static constexpr int kSlices = kD / kDV;
  static constexpr bool kQInRegs = kD == 128;
  // Ks [kKeys][kPitch], Vs [kKeys][kVPitch] bf16, kss, vss [kKeys] f32, then Qs [kRows][kPitch] bf16 at D >= 256
  static constexpr int kSmem =
      kKeys * (kPitch + kVPitch) * 2 + 2 * kKeys * 4 + (kQInRegs ? 0 : kRows * kPitch * 2);
};

struct FlashArgs {
  const __nv_bfloat16* q;  // [B, T, H, D]
  const void* k;           // row (b, h, s) at b*sb + h*sh + s*ss
  const void* v;
  const float* ks;  // [B, Hkv, S] (int8 K/V)
  const float* vs;
  const int* pos;     // [B]
  const int* window;  // [1] or nullptr
  void* out;          // [B, T, H, D]
  int T, S, Hkv, n_rep, out_f32;
  long long sb, sh, ss;
  float qscale, cap, inv_cap;
};

template <int kD, bool kInt8, bool kSoftcap>
__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(FlashArgs a) {
  using Shape = FlashShape<kD>;
  constexpr int kKeys = Shape::kKeys, kPitch = Shape::kPitch, kDV = Shape::kDV, kVPitch = Shape::kVPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  auto Ks = reinterpret_cast<__nv_bfloat16(*)[kPitch]>(smem);
  auto Vs = reinterpret_cast<__nv_bfloat16(*)[kVPitch]>(Ks + kKeys);
  float* kss = reinterpret_cast<float*>(Vs + kKeys);
  float* vss = kss + kKeys;
  auto Qs = reinterpret_cast<__nv_bfloat16(*)[kPitch]>(vss + kKeys);  // D >= 256 only

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, c = lane & 3;
  const int n_rep = a.n_rep, T = a.T, S = a.S;
  // longest key ranges first; the slices of one row tile side by side
  const int tile = gridDim.x / Shape::kSlices - 1 - blockIdx.x / Shape::kSlices;
  const int dv0 = kDV * (blockIdx.x % Shape::kSlices);  // this block's output dimensions [dv0, dv0 + kDV)
  const int hk = blockIdx.y, b = blockIdx.z;
  const int H = a.Hkv * n_rep;
  const long long f0 = static_cast<long long>(tile) * kRows;  // first flat row: t * n_rep + rep
  const long long n_flat = static_cast<long long>(T) * n_rep;
  const int t_first = static_cast<int>(f0 / n_rep);
  const int t_last = static_cast<int>(min(n_flat - 1, f0 + kRows - 1) / n_rep);
  const int p0 = a.pos[b];
  const int win = a.window != nullptr ? *a.window : S + 1;
  const int kend = min(S, p0 + t_last + 1);                    // keys [kstart, kend) are visible to the block
  const int kstart = max(0, min(p0 + t_first - win + 1, kend));

  // flat row f of the block: query t, head hk * n_rep + rep; a row past
  // T * n_rep computes query t_first, head 0 of the group, and is not stored
  auto row_of = [&](int r, int& t, int& h) {
    const long long f = f0 + r;
    const bool ok = f < n_flat;
    t = ok ? static_cast<int>(f / n_rep) : t_first;
    h = hk * n_rep + (ok ? static_cast<int>(f % n_rep) : 0);
    return ok;
  };
  // this thread's two rows (gq and gq + 8 of the warp's 16)
  int row_t[2], row_h[2], row_pos[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_ok[i] = row_of(warp * 16 + gq + 8 * i, row_t[i], row_h[i]);
    row_pos[i] = p0 + row_t[i];
  }

  // q' as the A operand of Q.K^T: kD / 16 k-steps of 16 head dimensions
  uint32_t qa[Shape::kQInRegs ? kD / 16 : 1][4];
  if constexpr (Shape::kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* qr =
            a.q + ((static_cast<size_t>(b) * T + row_t[i]) * H + row_h[i]) * kD + 16 * kk + 2 * c;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qr + 8 * half));
          qa[kk][i + 2 * half] = pack_bf16(f.x * a.qscale, f.y * a.qscale);
        }
      }
    }
  } else {
    // each warp stages its own 16 rows
    for (int i = lane; i < 16 * kD / 2; i += 32) {
      const int r = warp * 16 + i / (kD / 2), d = 2 * (i % (kD / 2));
      int t, h;
      row_of(r, t, h);
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(a.q + ((static_cast<size_t>(b) * T + t) * H + h) * kD + d));
      *reinterpret_cast<uint32_t*>(&Qs[r][d]) = pack_bf16(f.x * a.qscale, f.y * a.qscale);
    }
    __syncwarp();
  }

  float o[kDV / 8][4];
#pragma unroll
  for (int nt = 0; nt < kDV / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m_run[2] = {kMasked, kMasked}, l_run[2] = {0.f, 0.f};

  constexpr int kElt = kInt8 ? 1 : 2;
  const char* kbase = static_cast<const char*>(a.k) + (b * a.sb + hk * a.sh) * kElt;
  const char* vbase = static_cast<const char*>(a.v) + (b * a.sb + hk * a.sh) * kElt;
  const size_t sbase = (static_cast<size_t>(b) * a.Hkv + hk) * S;

  for (int j0 = kstart / kKeys * kKeys; j0 < kend; j0 += kKeys) {
    __syncthreads();  // the previous tile's reads are done
    // stage keys [j0, j0 + kKeys) as bf16, all of K and this block's slice
    // of V; keys outside [kstart, kend) are zeros
    constexpr int kChunks = kD * kElt / 16;  // 16-byte chunks per K row
    for (int i = tid; i < kKeys * kChunks; i += kThreads) {
      const int j = i / kChunks, ch = i % kChunks;
      const long long off = (j0 + j) * a.ss * kElt + ch * 16;
      const bool in = j0 + j >= kstart && j0 + j < kend;
      const int4 kr = in ? *reinterpret_cast<const int4*>(kbase + off) : make_int4(0, 0, 0, 0);
      if constexpr (kInt8) {
        uint4 lo, hi;
        int8x16_to_bf16(kr, lo, hi);
        *reinterpret_cast<uint4*>(&Ks[j][16 * ch]) = lo;
        *reinterpret_cast<uint4*>(&Ks[j][16 * ch + 8]) = hi;
      } else {
        *reinterpret_cast<int4*>(&Ks[j][8 * ch]) = kr;
      }
    }
    constexpr int kVChunks = kDV * kElt / 16;  // 16-byte chunks per V row slice
    for (int i = tid; i < kKeys * kVChunks; i += kThreads) {
      const int j = i / kVChunks, ch = i % kVChunks;
      const long long off = (j0 + j) * a.ss * kElt + dv0 * kElt + ch * 16;
      const bool in = j0 + j >= kstart && j0 + j < kend;
      const int4 vr = in ? *reinterpret_cast<const int4*>(vbase + off) : make_int4(0, 0, 0, 0);
      if constexpr (kInt8) {
        uint4 lo, hi;
        int8x16_to_bf16(vr, lo, hi);
        *reinterpret_cast<uint4*>(&Vs[j][16 * ch]) = lo;
        *reinterpret_cast<uint4*>(&Vs[j][16 * ch + 8]) = hi;
      } else {
        *reinterpret_cast<int4*>(&Vs[j][8 * ch]) = vr;
      }
    }
    if constexpr (kInt8) {
      if (tid < kKeys) {
        const bool in = j0 + tid >= kstart && j0 + tid < kend;
        kss[tid] = in ? a.ks[sbase + j0 + tid] : 0.f;
        vss[tid] = in ? a.vs[sbase + j0 + tid] : 0.f;
      }
    }
    __syncthreads();

    // scores: 16 rows x kKeys keys per warp, fragments of 8 keys
    float sc[kKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t a0, a1, a2, a3;
      if constexpr (Shape::kQInRegs) {
        a0 = qa[kk][0], a1 = qa[kk][1], a2 = qa[kk][2], a3 = qa[kk][3];
      } else {  // rows gq, gq + 8 of the warp at k 2c, then at k 2c + 8
        const uint32_t* q0 = reinterpret_cast<const uint32_t*>(&Qs[warp * 16 + gq][16 * kk + 2 * c]);
        const uint32_t* q1 = reinterpret_cast<const uint32_t*>(&Qs[warp * 16 + gq + 8][16 * kk + 2 * c]);
        a0 = q0[0], a1 = q1[0], a2 = q0[4], a3 = q1[4];
      }
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt) {
        const __nv_bfloat16* kr = &Ks[nt * 8 + gq][16 * kk + 2 * c];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
        mma_bf16_16816(sc[nt], a0, a1, a2, a3, b0, b1);
      }
    }

    // k scale, softcap, causal and window masks, running max per row
    float tmax[2] = {kMasked, kMasked};
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = nt * 8 + 2 * c + (e & 1), i = e >> 1;
        const int s = j0 + jj;
        float x = sc[nt][e];
        if constexpr (kInt8) x *= kss[jj];
        if constexpr (kSoftcap) x = __fmul_rn(a.cap, tanhf(__fmul_rn(x, a.inv_cap)));
        if (s > row_pos[i] || s >= S || s <= row_pos[i] - win) x = kMasked;
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
      corr[i] = expf(m_run[i] - m_new);  // 0 once a visible key lifts the max
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
    for (int nt = 0; nt < kDV / 8; ++nt) {
      o[nt][0] *= corr[0];
      o[nt][1] *= corr[0];
      o[nt][2] *= corr[1];
      o[nt][3] *= corr[1];
    }

    // P.V: k-steps of 16 keys; the B fragment pairs two keys of one
    // head dimension, read as two halves from the row-major V tile
    const unsigned short* vbits = reinterpret_cast<const unsigned short*>(&Vs[0][0]);
#pragma unroll
    for (int kc = 0; kc < kKeys / 16; ++kc) {
      const uint32_t a0 = pa[2 * kc][0], a1 = pa[2 * kc][1];
      const uint32_t a2 = pa[2 * kc + 1][0], a3 = pa[2 * kc + 1][1];
      const int key = 16 * kc + 2 * c;
#pragma unroll
      for (int nt = 0; nt < kDV / 8; ++nt) {
        const int col = nt * 8 + gq;
        const uint32_t b0 =
            vbits[key * kVPitch + col] | (static_cast<uint32_t>(vbits[(key + 1) * kVPitch + col]) << 16);
        const uint32_t b1 =
            vbits[(key + 8) * kVPitch + col] | (static_cast<uint32_t>(vbits[(key + 9) * kVPitch + col]) << 16);
        mma_bf16_16816(o[nt], a0, a1, a2, a3, b0, b1);
      }
    }
  }

  // out = acc / den for this thread's rows, head dimensions dv0 + nt*8 + 2c, +1
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    const size_t orow = ((static_cast<size_t>(b) * T + row_t[i]) * H + row_h[i]) * kD + dv0;
#pragma unroll
    for (int nt = 0; nt < kDV / 8; ++nt) {
      const float x0 = o[nt][2 * i] / l_run[i], x1 = o[nt][2 * i + 1] / l_run[i];
      const size_t at = orow + nt * 8 + 2 * c;
      if (a.out_f32)
        *reinterpret_cast<float2*>(static_cast<float*>(a.out) + at) = make_float2(x0, x1);
      else
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.out) + at) = __floats2bfloat162_rn(x0, x1);
    }
  }
}

template <int kD, bool kInt8, bool kSoftcap>
int launch_flash(const FlashArgs& a, dim3 grid, cudaStream_t st) {
  constexpr int bytes = FlashShape<kD>::kSmem;
  static int allowed[kMaxDevices];
  if (const int e = allow_dynamic_smem(flash_prefill_kernel<kD, kInt8, kSoftcap>, bytes, allowed)) return e;
  flash_prefill_kernel<kD, kInt8, kSoftcap><<<grid, kThreads, bytes, st>>>(a);
  return qllm_launch_status();
}

template <int kD>
int launch_width(const FlashArgs& a, bool int8, dim3 grid, cudaStream_t st) {
  const bool cap = a.cap != 0.f;
  if (int8) return cap ? launch_flash<kD, true, true>(a, grid, st) : launch_flash<kD, true, false>(a, grid, st);
  return cap ? launch_flash<kD, false, true>(a, grid, st) : launch_flash<kD, false, false>(a, grid, st);
}

}  // namespace

// K/V row (b, kv-head h, key s) starts at element b*sb + h*sh + s*ss and
// holds D contiguous values; every row start must be 16-byte aligned.
// softcap 0 is off; window is an int32 in device memory, or null (off).
QLLM_API int qllm_flash_prefill(const void* q, const void* k, const void* v, const void* k_scale,
                                const void* v_scale, const void* pos, void* out, int B, int T, int S,
                                int Hkv, int n_rep, int D, long long sb, long long sh, long long ss,
                                int kv_int8, int out_f32, float qscale, float softcap, float inv_softcap,
                                const void* window, void* stream) {
  const long long tiles = (static_cast<long long>(T) * n_rep + kRows - 1) / kRows;
  if (B < 1 || T < 1 || S < 1 || Hkv < 1 || n_rep < 1 || (D != 128 && D != 256 && D != 384 && D != 512) ||
      B > 65535 || Hkv > 65535 || tiles * (D / 128) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = k;
  a.v = v;
  a.ks = static_cast<const float*>(k_scale);
  a.vs = static_cast<const float*>(v_scale);
  a.pos = static_cast<const int*>(pos);
  a.window = static_cast<const int*>(window);
  a.out = out;
  a.T = T;
  a.S = S;
  a.Hkv = Hkv;
  a.n_rep = n_rep;
  a.out_f32 = out_f32;
  a.sb = sb;
  a.sh = sh;
  a.ss = ss;
  a.qscale = qscale;
  a.cap = softcap;
  a.inv_cap = inv_softcap;
  const auto st = static_cast<cudaStream_t>(stream);
  const bool int8 = kv_int8 != 0;
  // row tiles x the output slices of D (FlashShape::kSlices)
  auto grid = [&](int slices) { return dim3(static_cast<unsigned>(tiles * slices), Hkv, B); };
  if (D == 128) return launch_width<128>(a, int8, grid(1), st);
  if (D == 256) return launch_width<256>(a, int8, grid(1), st);
  if (D == 384) return launch_width<384>(a, int8, grid(3), st);
  return launch_width<512>(a, int8, grid(2), st);
}
