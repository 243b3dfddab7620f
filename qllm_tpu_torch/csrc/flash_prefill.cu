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
// int8 K / V enter the products as bf16 (exact); the per-key k scale
// multiplies the score columns and the v scale the probabilities, as
// in the TPU kernel (pallas_attention.py:704-748). The exponentials are
// 2^x of log2(e)-scaled scores (ex2.approx): the same function within
// ~2^-22 relative.
//
// Bound on the H100: at T = S = 2048 (H = 32, D = 128) the causal
// products are ~3.4e10 flops per layer against ~35 MB, far above the
// bf16 ridge, so the tensor cores bound it; at T = 512 it is near the
// ridge.
//
// Design (csrc/wgmma.cuh). A block is two warpgroups over 128 rows of the
// flat (q position, query head of the group) order of one (b, kv head),
// so each K/V tile is read, and converted, once for the group's heads at
// any n_rep, and shared by both warpgroups (64 rows each). Both products
// run on wgmma.mma_async: S = Q.K^T with q' staged once in 128-byte-
// swizzled shared memory (A) and the K tile (B, K-major: keys are rows of
// D values); O += P.V with the probabilities from registers (A) and the V
// tile read through the descriptor's transpose (B, MN-major: its rows are
// keys of head dimensions, the reduction runs over keys). K and V tiles
// share one layout: 64-dimension panels of [keys][64] bf16, swizzled.
// Tiles come through a ring: bf16 K/V land by cp.async directly in one of
// two tile slots, one tile ahead; int8 K/V land raw (with their scales)
// in one of three raw slots, two tiles ahead, and each thread converts
// the chunks it copied (PRMT-built f32, whose high half is the exact bf16)
// into the next tile slot after issuing the current tile's S product, so
// the conversion is done once a tile for the whole block. The copy and
// conversion loops run a fixed count of chunks a thread, and a tile every
// row of the block sees entirely skips the masks: the per-tile integer
// work is what sets the pace beside the products (the tensor cores run
// both products at full rate).
// Key tiles are 64 keys at D = 128, 32 at D = 256 / 384 and 16 at D = 512
// (shared memory). At D = 384 and 512 the 64 x D f32 output does not fit
// in registers, so the output width is split across blocks: each block
// scores with the full D and runs P.V for its slice of kDV = 128 (D =
// 384) or 256 (D = 256, 512) head dimensions, staging only that slice of
// V; every slice computes the same softmax statistics.
// The key loop walks only the keys visible to the block: from the tile
// holding pos + t_first - win + 1 to the last key visible to its last
// row, as the TPU kernel skips invisible tiles (pallas_attention.py:
// 833-860); the visible keys of consecutive rows overlap, so no walked
// tile is invisible to every row. The tiles with the longest key ranges
// are scheduled first.

#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;      // two warpgroups
constexpr int kRows = 128;         // rows of a block (flat q position x head of the group), 64 a warpgroup
constexpr float kMasked = -1e30f;  // the TPU kernel's mask value (pallas_attention.py:281)
constexpr float kLog2e = 1.4426950408889634f;

template <int kD, bool kInt8>
struct FlashShape {
  static constexpr int kKeys = kD == 128 ? 64 : kD == 512 ? 16 : 32;  // keys per tile
  static constexpr int kDV = kD == 384 ? 128 : kD == 128 ? 128 : 256;  // output width of a block
  static constexpr int kSlices = kD / kDV;
  static constexpr int kPanel = kKeys * 128;  // bytes of one 64-dimension panel of a K / V tile
  static constexpr int kKBytes = kD / 64 * kPanel, kVBytes = kDV / 64 * kPanel;
  static constexpr int kTile = kKBytes + kVBytes;  // a bf16 tile slot
  static constexpr int kQBytes = kRows * kD * 2;   // q': kD / 64 panels of [128 rows][64]
  // an int8 raw slot: K [kKeys][kD], V [kKeys][kDV], ks, vs [kKeys]
  static constexpr int kRawK = kKeys * kD, kRawV = kKeys * kDV;
  static constexpr int kRaw = kInt8 ? kRawK + kRawV + 2 * kKeys * 4 : 0;
  static constexpr int kRaws = kInt8 ? 3 : 0;
  static constexpr int kSmem = kQBytes + 2 * kTile + kRaws * kRaw + 1024;
  static constexpr int kElt = kInt8 ? 1 : 2;
  // 16-byte chunks of a tile's K rows and V row slices in device memory,
  // a whole number a thread
  static constexpr int kKChunks = kKeys * kD * kElt / 16, kVChunks = kKeys * kDV * kElt / 16;
  static_assert(kKChunks % kThreads == 0 && kVChunks % kThreads == 0, "whole chunks a thread");
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bf16x2_bits(__floats2bfloat162_rn(lo, hi));
}

// four int8 values (a word) -> two exact bf16 pairs: v ^ 0x80 = v + 128,
// PRMT builds 2^23 + v + 128 as an f32, one FADD removes 2^23 + 128; an
// integer of at most 8 significant bits has zeros in the low half of its
// f32, so the high halves are its bf16, paired by one more PRMT (no
// conversion instruction)
__device__ __forceinline__ uint2 int8x4_to_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = __float_as_uint(__int_as_float(__byte_perm(u, 0x4B000000u, 0x7440u + b)) - 8388736.f);
  return make_uint2(__byte_perm(f[0], f[1], 0x7632), __byte_perm(f[2], f[3], 0x7632));
}

// 2^x (ex2.approx: relative error ~2^-22, far inside the prefill tolerance)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int kD, bool kInt8, bool kSoftcap>
__global__ void __launch_bounds__(kThreads, 1) flash_prefill_kernel(FlashArgs a) {
  using Sh = FlashShape<kD, kInt8>;
  constexpr int kKeys = Sh::kKeys, kDV = Sh::kDV, kPanel = Sh::kPanel;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = atom_aligned(smem_raw);
  const uint32_t qs0 = smem_u32(smem);                  // q' panels
  const uint32_t tile0 = qs0 + Sh::kQBytes;             // two tile slots: K panels, then V panels
  unsigned char* raw0 = smem + Sh::kQBytes + 2 * Sh::kTile;  // int8 raw slots

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, gq = lane >> 2, c = lane & 3;
  const int n_rep = a.n_rep, T = a.T, S = a.S;
  // longest key ranges first; the slices of one row tile side by side
  const int tile = gridDim.x / Sh::kSlices - 1 - blockIdx.x / Sh::kSlices;
  const int dv0 = kDV * (blockIdx.x % Sh::kSlices);  // this block's output dimensions [dv0, dv0 + kDV)
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
  const int jfirst = kstart / kKeys * kKeys;
  const int ntiles = kend > jfirst ? (kend - jfirst + kKeys - 1) / kKeys : 0;

  // flat row f of the block: query t, head hk * n_rep + rep; a row past
  // T * n_rep computes query t_first, head 0 of the group, and is not stored
  const int rep0 = static_cast<int>(f0 - static_cast<long long>(t_first) * n_rep);  // row 0's head in the group
  auto row_of = [&](int r, int& t, int& h) {
    const bool ok = f0 + r < n_flat;
    const int q = (rep0 + r) / n_rep;  // 32-bit: rep0 + r < n_rep + kRows
    t = ok ? t_first + q : t_first;
    h = hk * n_rep + (ok ? rep0 + r - q * n_rep : 0);
    return ok;
  };
  // this thread's two rows (gq and gq + 8 of its warp's 16)
  int row_t[2], row_h[2], row_pos[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_ok[i] = row_of(64 * wg + 16 * (warp & 3) + gq + 8 * i, row_t[i], row_h[i]);
    row_pos[i] = p0 + row_t[i];
  }

  constexpr int kElt = Sh::kElt;
  const char* kbase = static_cast<const char*>(a.k) + (b * a.sb + hk * a.sh) * kElt;
  const char* vbase = static_cast<const char*>(a.v) + (b * a.sb + hk * a.sh) * kElt + dv0 * kElt;
  const size_t sbase = (static_cast<size_t>(b) * a.Hkv + hk) * S;
  const long long row_bytes = a.ss * kElt;

  // key lies in [kstart, kend)
  auto visible = [&](int key) {
    return static_cast<unsigned>(key - kstart) < static_cast<unsigned>(kend - kstart);
  };
  // tile i's copies: bf16 straight into tile slot i % 2, int8 raw (and the
  // scales) into raw slot i % 3; keys outside [kstart, kend) are zeros.
  // Chunk n = tid + kThreads q of a thread: key row n / (chunks a row), chunk
  // n % (chunks a row), a fixed count of them, so the loops unroll whole.
  auto issue = [&](int i) {
    if (i >= ntiles) return;
    const int j0 = jfirst + i * kKeys;
    const char* kt0 = kbase + j0 * row_bytes;  // tile i's first key row
    const char* vt0 = vbase + j0 * row_bytes;
    if constexpr (kInt8) {
      unsigned char* r = raw0 + (i % 3) * Sh::kRaw;
#pragma unroll
      for (int q = 0; q < Sh::kKChunks / kThreads; ++q) {
        const int n = tid + q * kThreads, j = n / (kD / 16), ch = n % (kD / 16);
        const bool in = visible(j0 + j);
        cp_async16(r + 16 * n, in ? kt0 + j * row_bytes + 16 * ch : kbase, in);
      }
#pragma unroll
      for (int q = 0; q < Sh::kVChunks / kThreads; ++q) {
        const int n = tid + q * kThreads, j = n / (kDV / 16), ch = n % (kDV / 16);
        const bool in = visible(j0 + j);
        cp_async16(r + Sh::kRawK + 16 * n, in ? vt0 + j * row_bytes + 16 * ch : vbase, in);
      }
      if (tid < 2 * kKeys) {
        const int j = tid % kKeys;
        const bool in = visible(j0 + j);
        const float* src = (tid < kKeys ? a.ks : a.vs) + sbase + (in ? j0 + j : 0);
        cp_async4(r + Sh::kRawK + Sh::kRawV + 4 * tid, src, in);
      }
    } else {
      const uint32_t kt = tile0 + (i % 2) * Sh::kTile, vt = kt + Sh::kKBytes;
#pragma unroll
      for (int q = 0; q < Sh::kKChunks / kThreads; ++q) {
        const int n = tid + q * kThreads, j = n / (kD / 8), ch = n % (kD / 8);
        const bool in = visible(j0 + j);
        cp_async16_s(kt + (ch / 8) * kPanel + sw128_offset(j, ch % 8), in ? kt0 + j * row_bytes + 16 * ch : kbase,
                     in);
      }
#pragma unroll
      for (int q = 0; q < Sh::kVChunks / kThreads; ++q) {
        const int n = tid + q * kThreads, j = n / (kDV / 8), ch = n % (kDV / 8);
        const bool in = visible(j0 + j);
        cp_async16_s(vt + (ch / 8) * kPanel + sw128_offset(j, ch % 8), in ? vt0 + j * row_bytes + 16 * ch : vbase,
                     in);
      }
    }
  };
  // int8: the chunks this thread copied of tile i (raw slot i % 3) as
  // bf16 into tile slot i % 2 (16 values: two 16-byte chunks of a panel row)
  auto convert = [&](int i) {
    if constexpr (kInt8) {
      if (i >= ntiles) return;
      const unsigned char* r = raw0 + (i % 3) * Sh::kRaw;
      unsigned char* kt = smem + Sh::kQBytes + (i % 2) * Sh::kTile;
      unsigned char* vt = kt + Sh::kKBytes;
      auto put = [&](const unsigned char* src, unsigned char* dst, int j, int ch) {
        const uint4 w = *reinterpret_cast<const uint4*>(src);
        const uint2 b0 = int8x4_to_bf16(w.x), b1 = int8x4_to_bf16(w.y), b2 = int8x4_to_bf16(w.z),
                    b3 = int8x4_to_bf16(w.w);
        unsigned char* p = dst + (ch / 4) * kPanel;  // 16 dims: chunks 2 (ch % 4), +1 of panel ch / 4
        *reinterpret_cast<uint4*>(p + sw128_offset(j, 2 * (ch % 4))) = make_uint4(b0.x, b0.y, b1.x, b1.y);
        *reinterpret_cast<uint4*>(p + sw128_offset(j, 2 * (ch % 4) + 1)) = make_uint4(b2.x, b2.y, b3.x, b3.y);
      };
#pragma unroll
      for (int q = 0; q < Sh::kKChunks / kThreads; ++q) {
        const int n = tid + q * kThreads;
        put(r + 16 * n, kt, n / (kD / 16), n % (kD / 16));
      }
#pragma unroll
      for (int q = 0; q < Sh::kVChunks / kThreads; ++q) {
        const int n = tid + q * kThreads;
        put(r + Sh::kRawK + 16 * n, vt, n / (kDV / 16), n % (kDV / 16));
      }
    }
  };

  issue(0);
  cp_async_commit();
  if constexpr (kInt8) {
    issue(1);
    cp_async_commit();
  }
  // q' = bf16(f32(q) * D^-0.5) into its panels, 8 dimensions a chunk
#pragma unroll
  for (int i = 0; i < kRows * kD / 8 / kThreads; ++i) {
    const int n = tid + i * kThreads, r = n / (kD / 8), ch = n % (kD / 8);
    int t, h;
    row_of(r, t, h);
    const uint4 v = *reinterpret_cast<const uint4*>(a.q + ((static_cast<size_t>(b) * T + t) * H + h) * kD + 8 * ch);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
      o[e] = pack_bf16(f.x * a.qscale, f.y * a.qscale);
    }
    *reinterpret_cast<uint4*>(smem + (ch / 8) * (kRows * 128) + sw128_offset(r, ch % 8)) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
  if constexpr (kInt8) {
    cp_async_wait<1>();  // this thread's copies of tile 0 landed
    convert(0);
  }

  float o[kDV / 128][64];
#pragma unroll
  for (int v2 = 0; v2 < kDV / 128; ++v2)
#pragma unroll
    for (int e = 0; e < 64; ++e) o[v2][e] = 0.f;
  float m_run[2] = {kMasked * kLog2e, kMasked * kLog2e}, l_run[2] = {0.f, 0.f};
  const uint32_t qwg = qs0 + wg * 64 * 128;  // this warpgroup's 64 rows of each q' panel

  for (int it = 0; it < ntiles; ++it) {
    const int j0 = jfirst + it * kKeys;
    if constexpr (!kInt8) cp_async_wait<0>();  // this thread's copies of tile it landed
    fence_proxy_async();
    // everyone's copies (or conversions) of tile it are in; both warpgroups
    // are done with tile it - 1, so its slots are free
    __syncthreads();
    issue(kInt8 ? it + 2 : it + 1);
    cp_async_commit();
    const uint32_t kt = tile0 + (it % 2) * Sh::kTile, vt = kt + Sh::kKBytes;

    // S = q' K^T: 64 rows x kKeys keys a warpgroup
    float s[kKeys / 2];
#pragma unroll
    for (int e = 0; e < kKeys / 2; ++e) s[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 dimensions: 32 bytes into the panel row
      wgmma_ss<kKeys>(s, sw128_desc(qwg + (kk / 4) * (kRows * 128) + off), sw128_desc(kt + (kk / 4) * kPanel + off),
                      kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    if constexpr (kInt8) {
      cp_async_wait<1>();  // this thread's copies of tile it + 1 landed
      convert(it + 1);     // while the tensor cores run S
    }
    wgmma_wait<0>();
    fence_regs(s);

    // k scale, softcap, causal and window masks, in log2 units; running max
    // per row. S element 4n + e: row gq + 8 (e >> 1), key 8n + 2c + (e & 1).
    // A tile whose keys every row of the block sees (uniform) needs no mask.
    const float* kss = reinterpret_cast<const float*>(raw0 + (it % 3) * Sh::kRaw + Sh::kRawK + Sh::kRawV);
    const float* vss = kss + kKeys;
    const bool seen = j0 + kKeys - 1 <= p0 + t_first && j0 + kKeys <= S && j0 > p0 + t_last - win;
    float tmax[2] = {kMasked * kLog2e, kMasked * kLog2e};
    auto scores = [&](auto masked) {
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
        float2 ksn = make_float2(1.f, 1.f);
        if constexpr (kInt8) ksn = *reinterpret_cast<const float2*>(kss + 8 * n + 2 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = 8 * n + 2 * c + (e & 1), i = e >> 1;
          const int key = j0 + jj;
          float x = s[4 * n + e];
          if constexpr (kInt8) x *= (e & 1) ? ksn.y : ksn.x;
          if constexpr (kSoftcap) x = __fmul_rn(a.cap, tanhf(__fmul_rn(x, a.inv_cap)));
          if constexpr (decltype(masked)::value)
            if (key > row_pos[i] || key >= S || key <= row_pos[i] - win) x = kMasked;
          x *= kLog2e;
          s[4 * n + e] = x;
          tmax[i] = fmaxf(tmax[i], x);
        }
      }
    };
    if (seen)  // uniform across the block: two bodies, no per-score mask
      scores(std::false_type{});
    else
      scores(std::true_type{});
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m_run[i], tmax[i]);
      corr[i] = fast_exp2(m_run[i] - m_new);  // 0 once a visible key lifts the max
      m_run[i] = m_new;
    }

    // probabilities: the denominator takes p, P.V takes bf16(p [* vs]);
    // A of the 16-key step kc: rows gq / gq + 8 at keys 2c.. and 2c + 8..
    float psum[2] = {0.f, 0.f};
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
      float p[4];
      float2 vsn = make_float2(1.f, 1.f);
      if constexpr (kInt8) vsn = *reinterpret_cast<const float2*>(vss + 8 * n + 2 * c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = fast_exp2(s[4 * n + e] - m_run[e >> 1]);
        psum[e >> 1] += p[e];
        if constexpr (kInt8) p[e] *= (e & 1) ? vsn.y : vsn.x;
      }
      pa[n / 2][2 * (n % 2)] = pack_bf16(p[0], p[1]);
      pa[n / 2][2 * (n % 2) + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
      l_run[i] = l_run[i] * corr[i] + psum[i];
    }
    if (!__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) {  // the max moved for some row
#pragma unroll
      for (int v2 = 0; v2 < kDV / 128; ++v2)
#pragma unroll
        for (int e = 0; e < 64; ++e) o[v2][e] *= corr[(e >> 1) & 1];
    }

    // O += P V: the V tile through the transpose, 128 dimensions an instruction
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kKeys / 16; ++kc)
#pragma unroll
      for (int v2 = 0; v2 < kDV / 128; ++v2)
        wgmma_m64n128k16_rs_tb(o[v2], pa[kc], sw128_desc_mn(vt + 2 * v2 * kPanel + kc * 2048, kPanel));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int v2 = 0; v2 < kDV / 128; ++v2) fence_regs(o[v2]);
  }
  cp_async_wait<0>();

  // out = acc / den for this thread's rows; O element 4n + e: row gq + 8
  // (e >> 1), dimension dv0 + 128 v2 + 8n + 2c + (e & 1)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    const size_t orow = ((static_cast<size_t>(b) * T + row_t[i]) * H + row_h[i]) * kD + dv0;
    const float inv = 1.f / l_run[i];  // one division a row
#pragma unroll
    for (int v2 = 0; v2 < kDV / 128; ++v2)
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const float x0 = o[v2][4 * n + 2 * i] * inv, x1 = o[v2][4 * n + 2 * i + 1] * inv;
        const size_t at = orow + 128 * v2 + 8 * n + 2 * c;
        if (a.out_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + at) = make_float2(x0, x1);
        else
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.out) + at) = __floats2bfloat162_rn(x0, x1);
      }
  }
}

template <int kD, bool kInt8, bool kSoftcap>
int launch_flash(const FlashArgs& a, dim3 grid, cudaStream_t st) {
  constexpr int bytes = FlashShape<kD, kInt8>::kSmem;
  static int allowed[kMaxDevices];
  if (const int e = allow_dynamic_smem(flash_prefill_kernel<kD, kInt8, kSoftcap>, bytes, allowed)) return e;
  flash_prefill_kernel<kD, kInt8, kSoftcap><<<grid, kThreads, bytes, st>>>(a);
  return qllm_launch_status();
}

// the grid: row tiles x the output slices of D, kv heads, sequences
template <int kD>
int launch_width(const FlashArgs& a, bool int8, long long tiles, int B, cudaStream_t st) {
  const bool cap = a.cap != 0.f;
  const dim3 grid(static_cast<unsigned>(tiles * FlashShape<kD, true>::kSlices), a.Hkv, B);
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
  if (D == 128) return launch_width<128>(a, int8, tiles, B, st);
  if (D == 256) return launch_width<256>(a, int8, tiles, B, st);
  if (D == 384) return launch_width<384>(a, int8, tiles, B, st);
  return launch_width<512>(a, int8, tiles, B, st);
}
