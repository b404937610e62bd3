// Prefill (flash) attention for Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py
// (`flash_attention`, pallas_call at :89, body `_flash_kernel` :24):
// softmax(q k^T * hd^-0.5) v over a whole prompt with a causal mask and an
// optional sliding window (rel < window), kv padding masked, fp32 online
// softmax. It reads grouped K/V (B, L, Hkv, hd) directly: query head h uses
// kv head h / (H / Hkv), so the expanded copy the TPU path builds
// (`_expand_kv`) never exists. Unlike the TPU kernel it takes optional
// per-row key lengths: keys at or past kv_len[b] are masked, as the
// reference's plain path masks them in a length-bucketed prefill
// (repro/models/transformer.py:324). Real rows of such a bucket never see
// those keys anyway; the pad rows then do not either, so their hidden
// states, which choose experts and compete for expert capacity in an MoE
// layer, equal the plain path's.
//
// What bounds it on an H100: operations. A 64-row query tile does
// 4 * 64 * hd FLOPs per key row it reads, well above the card's
// FLOP-per-byte balance at serving prompt lengths. The products run on the
// tensor cores through mma.sync.m16n8k8 in TF32. TF32 keeps 10 mantissa
// bits, too few for the port's fp32 tolerance, so fp32 takes "3xTF32":
// each operand x splits into hi = tf32(x) (rounded to nearest) and
// lo = x - hi, and every product is lo*hi + hi*lo + hi*hi accumulated in
// fp32 (lo*lo dropped; the tensor core truncates lo to TF32), which keeps
// about 21 bits of each product, at three times the tensor work.
// tests/test_torch_flash_tf32.py shows, with this arithmetic emulated on
// the CPU, that one TF32 pass misses the fp32 tolerance and 3xTF32 meets
// it. bf16 values are exact in TF32, so the bf16 instantiation runs the hi
// pass alone (P rounded to TF32 for P V). The softmax runs in fp32 on the
// CUDA cores. So the least time is the larger of the bytes over the
// memory rate and 3 x FLOPs over the TF32 rate.
//
// Design (FlashAttention-2 layout): one block of 4 warps per (64-row query
// tile, head, batch row); each warp owns 16 query rows. Its scores, running
// max, running sum and output accumulator stay in registers in the MMA
// fragment layouts; row max and sum go through quad shuffles, and scores
// never touch shared memory: the score fragment of keys 2t, 2t+1 feeds the
// P V product as the A fragment of a key order permuted within each 8-key
// step, and V's rows are read in that same order, so the sum is unchanged.
// Head dims are permuted the same way for Q and K within each 16-wide
// chunk, so a lane's Q and K fragments of two k-steps are one 16-byte
// shared load each.
// K/V tiles of 32 keys stream through a 2-stage shared-memory ring filled
// by 16-byte cp.async copies (element copies where a base is not 16-byte
// aligned): the next tile's copy is in flight while this tile's MMAs run,
// with one block barrier per tile. Padded row strides make every fragment
// load from shared memory free of bank conflicts (FlashSmem). Shared
// memory is 107,520 bytes at fp32 hd 128, so two blocks fit on an SM.
// At hd 256 (recurrentgemma-2b's local attention) it is 205,824 bytes at
// fp32 (138,240 at bf16): one block an SM, whose launch bound lets a
// thread take all 255 registers, the output accumulator alone being
// 16 x 256 / 32 = 128 of them.
// Q stays in shared memory (fp32, unscaled; the scale goes into exp2) and
// is split per fragment as it is loaded, since its hi and lo fragments
// held whole would take 128 registers a thread at hd 128. fp32 Q comes by
// cp.async with tile 0's copies; the output is staged through the warp's
// Q rows and stored coalesced.
// Key tiles that the causal mask, the window or kv_len remove entirely are
// never loaded; a warp skips the tiles that hold no key for any of its
// rows, and the per-element mask runs only on diagonal, window-edge and
// kv_len-edge tiles. Query tiles launch heaviest first (the grid's slowest
// axis runs the causal tiles from the last). A block serves one query
// head: the G query heads of a kv head are separate blocks, which read the
// same K/V tiles through the L2 cache (a K/V tile feeds 64 query rows
// either way). Two runs give the same bits: no atomics, and every sum runs
// in a fixed order.
#include <type_traits>

#include "attention_common.cuh"

constexpr int FA_BQ = 64;                  // query rows per block
constexpr int FA_BK = 32;                  // keys per tile
constexpr int FA_WARPS = FA_BQ / 16;       // 16 query rows per warp
constexpr int FA_THREADS = 32 * FA_WARPS;
constexpr int FA_STAGES = 2;

// Shared memory of one block: Q (BQ rows of QS floats), then the K and V
// rings (STAGES x BK rows of KS and VS elements). The strides keep every
// fragment load free of bank conflicts: Q and K rows are read 16 (fp32) or
// 8 (bf16) bytes a lane, and QS, KS put the rows that one phase of such a
// load reads on distinct banks; V is read 4 or 2 bytes a lane from rows
// 2 t and 2 t + 1, which VS (HD + 16 bytes) spreads alike.
template <typename T, int HD>
struct FlashSmem {
  static constexpr int QS = pad_to(HD, 16, 32);
  static constexpr int KS =
      sizeof(T) == 4 ? pad_to(HD, 16, 32) : pad_to(HD, 16, 64);
  static constexpr int VS = HD + 16 / static_cast<int>(sizeof(T));
  static constexpr size_t q_bytes = sizeof(float) * FA_BQ * QS;
  static constexpr size_t k_elems = (size_t)FA_STAGES * FA_BK * KS;
  static constexpr size_t v_elems = (size_t)FA_STAGES * FA_BK * VS;
  static constexpr size_t bytes = q_bytes + sizeof(T) * (k_elems + v_elems);
};
// two blocks per SM at hd 128: the H100 gives an SM 228 KB, and takes
// 1 KB of it for each block
static_assert(2 * (FlashSmem<float, 128>::bytes + 1024) <= 228 * 1024,
              "flash_kernel: two fp32 hd-128 blocks must fit on an SM");
// one fp32 hd-256 block fits the 227 KB a block may use
static_assert(FlashSmem<float, 256>::bytes <= 232448,
              "flash_kernel: an fp32 hd-256 block must fit on an SM");

// blocks an SM holds at once: two up to hd 128, one at hd 256
template <typename T, int HD>
__global__ void __launch_bounds__(FA_THREADS, HD > 128 ? 1 : 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ kv_len,
             T* __restrict__ o, int L, int H, int Hkv, float scale_log2,
             int causal, int window, int vec) {
  using SM = FlashSmem<T, HD>;
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int QS = SM::QS, KS = SM::KS, VS = SM::VS, NK = FA_BK / 8,
                ND = HD / 8;
  constexpr unsigned FULL = 0xffffffffu;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * FA_BQ;   // heaviest first
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;   // fragment row group, column pair
  const int r0 = q0 + warp * 16;           // the warp's first query row
  const int klen = kv_len ? min(L, kv_len[b]) : L;   // keys [0, klen) valid

  extern __shared__ __align__(16) unsigned char fa_smem[];
  float* Qw = reinterpret_cast<float*>(fa_smem) + warp * 16 * QS;
  T* Kring = reinterpret_cast<T*>(fa_smem + SM::q_bytes);
  T* Vring = Kring + SM::k_elems;

  // the warp's 16 query rows (only this warp reads them): fp32 rows by
  // cp.async, in flight with tile 0's copies; bf16 rows converted
  if (SPLIT && vec) {
    constexpr int CH = HD / 4;
    for (int e = lane; e < 16 * CH; e += 32) {
      const int r = e / CH, c = (e - r * CH) * 4;
      const int qp = r0 + r;
      copy_unit<16>(Qw + r * QS + c,
                    q + (((size_t)b * L + min(qp, L - 1)) * H + h) * HD + c,
                    qp < L);
    }
  } else {
    for (int e = lane; e < 16 * HD; e += 32) {
      const int r = e / HD, d = e - r * HD;
      const int qp = r0 + r;
      Qw[r * QS + d] =
          qp < L ? to_float(q[(((size_t)b * L + qp) * H + h) * HD + d]) : 0.f;
    }
  }
  cp_async_commit();

  // key tiles that can hold an unmasked key for some query of this tile
  const int kend = causal ? min(klen, q0 + FA_BQ) : klen;
  const int kbeg = window > 0 ? max(0, q0 - window + 1) / FA_BK * FA_BK : 0;
  const int ntiles = kend > kbeg ? (kend - kbeg + FA_BK - 1) / FA_BK : 0;
  const size_t kv_row = (size_t)Hkv * HD;            // elements a key row
  const size_t kv_base = ((size_t)b * L * Hkv + hk) * HD;

  // copy tile tt's K and V rows into stage tt % FA_STAGES; rows at or past
  // klen are zero-filled (their weight is 0, and 0 * V must stay finite)
  auto load_tile = [&](int tt) {
    const int k0 = kbeg + tt * FA_BK;
    T* Ks = Kring + (tt % FA_STAGES) * FA_BK * KS;
    T* Vs = Vring + (tt % FA_STAGES) * FA_BK * VS;
    if (vec) {
      constexpr int EPC = 16 / static_cast<int>(sizeof(T));   // per chunk
      constexpr int CH = HD / EPC;                             // chunks a row
      for (int e = tid; e < FA_BK * CH; e += FA_THREADS) {
        const int r = e / CH, c = (e - r * CH) * EPC;
        const bool ok = k0 + r < klen;
        const size_t off = kv_base + (ok ? (size_t)(k0 + r) * kv_row : 0) + c;
        copy_unit<16>(Ks + r * KS + c, k + off, ok);
        copy_unit<16>(Vs + r * VS + c, v + off, ok);
      }
    } else {
      for (int e = tid; e < FA_BK * HD; e += FA_THREADS) {
        const int r = e / HD, d = e - r * HD;
        const bool ok = k0 + r < klen;
        const size_t off = kv_base + (size_t)(k0 + r) * kv_row + d;
        Ks[r * KS + d] = ok ? k[off] : from_float<T>(0.f);
        Vs[r * VS + d] = ok ? v[off] : from_float<T>(0.f);
      }
    }
    cp_async_commit();
  };

  float acc[ND][4];   // rows g, g + 8; columns 8 j + 2 t, + 1
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  float m_lo = NEG_INF_F, m_hi = NEG_INF_F;   // running max of rows g, g + 8
  float l_lo = 0.f, l_hi = 0.f;               // this thread's share of the sum
  const int qa = r0 + g, qb = r0 + g + 8;

  if (ntiles > 0) load_tile(0);
  for (int tt = 0; tt < ntiles; ++tt) {
    cp_async_wait<0>();
    __syncthreads();   // tile tt landed; every warp is done with tile tt - 1
    if (tt + 1 < ntiles) load_tile(tt + 1);
    const int k0 = kbeg + tt * FA_BK;
    // warp-uniform: no key of the tile is unmasked for any row of the warp
    if (r0 >= L || (causal && k0 > r0 + 15) ||
        (window > 0 && r0 - (k0 + FA_BK - 1) >= window))
      continue;
    const bool edge = (causal && k0 + FA_BK - 1 > r0) ||
                      (window > 0 && r0 + 15 - k0 >= window) ||
                      k0 + FA_BK > klen;
    const T* Ks = Kring + (tt % FA_STAGES) * FA_BK * KS;
    const T* Vs = Vring + (tt % FA_STAGES) * FA_BK * VS;

    // S = Q K^T: s[n] holds rows g, g + 8 of keys k0 + 8 n + 2 t, + 1
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
    // head dims permuted within each 16-wide chunk c, alike for Q and K:
    // d = 16 c + 4 t + i holds column t (i = 0, 2) or t + 4 (i = 1, 3) of
    // k-step 2 c (i < 2) or 2 c + 1, so a thread's four values of both
    // k-steps are one 16-byte load
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      const float* qr = Qw + g * QS + 16 * c + 4 * t;
      const float4 x0 = *reinterpret_cast<const float4*>(qr);
      const float4 x8 = *reinterpret_cast<const float4*>(qr + 8 * QS);
      uint32_t ah0[4], al0[4], ah1[4], al1[4];
      split_tf32<SPLIT>(x0.x, ah0[0], al0[0]);
      split_tf32<SPLIT>(x8.x, ah0[1], al0[1]);
      split_tf32<SPLIT>(x0.y, ah0[2], al0[2]);
      split_tf32<SPLIT>(x8.y, ah0[3], al0[3]);
      split_tf32<SPLIT>(x0.z, ah1[0], al1[0]);
      split_tf32<SPLIT>(x8.z, ah1[1], al1[1]);
      split_tf32<SPLIT>(x0.w, ah1[2], al1[2]);
      split_tf32<SPLIT>(x8.w, ah1[3], al1[3]);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        float kx[4];
        load4(Ks + (n * 8 + g) * KS + 16 * c + 4 * t, kx);
        uint32_t bh0[2], bl0[2], bh1[2], bl1[2];
        split_tf32<SPLIT>(kx[0], bh0[0], bl0[0]);
        split_tf32<SPLIT>(kx[1], bh0[1], bl0[1]);
        split_tf32<SPLIT>(kx[2], bh1[0], bl1[0]);
        split_tf32<SPLIT>(kx[3], bh1[1], bl1[1]);
        mma3<SPLIT>(s[n], ah0, al0, bh0, bl0);
        mma3<SPLIT>(s[n], ah1, al1, bh1, bl1);
      }
    }

    if (edge) {
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kp = k0 + n * 8 + 2 * t + (i & 1);
          const int qp = i < 2 ? qa : qb;
          const bool ok = kp < klen && (!causal || kp <= qp) &&
                          (window <= 0 || qp - kp < window);
          if (!ok) s[n][i] = -INFINITY;
        }
    }

    // online softmax on the unscaled scores: p = 2^((s - m) scale log2 e)
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
    }
    mx_lo = quad_max(mx_lo);
    mx_hi = quad_max(mx_hi);
    const float a_lo = exp2f((m_lo - mx_lo) * scale_log2);
    const float a_hi = exp2f((m_hi - mx_hi) * scale_log2);
    m_lo = mx_lo;
    m_hi = mx_hi;
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      s[n][0] = exp2f((s[n][0] - mx_lo) * scale_log2);
      s[n][1] = exp2f((s[n][1] - mx_lo) * scale_log2);
      s[n][2] = exp2f((s[n][2] - mx_hi) * scale_log2);
      s[n][3] = exp2f((s[n][3] - mx_hi) * scale_log2);
      ps_lo += s[n][0] + s[n][1];
      ps_hi += s[n][2] + s[n][3];
    }
    l_lo = l_lo * a_lo + ps_lo;
    l_hi = l_hi * a_hi + ps_hi;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= a_lo;
      acc[j][1] *= a_lo;
      acc[j][2] *= a_hi;
      acc[j][3] *= a_hi;
    }

    // O += P V over each 8-key step kk: the A fragment's column t is key
    // 2 t and column t + 4 key 2 t + 1, so it is s[kk] reordered, and V's
    // rows are read in the same order
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (SPLIT) {
        split_tf32<true>(s[kk][0], ah[0], al[0]);
        split_tf32<true>(s[kk][2], ah[1], al[1]);
        split_tf32<true>(s[kk][1], ah[2], al[2]);
        split_tf32<true>(s[kk][3], ah[3], al[3]);
      } else {
        ah[0] = to_tf32(s[kk][0]);
        ah[1] = to_tf32(s[kk][2]);
        ah[2] = to_tf32(s[kk][1]);
        ah[3] = to_tf32(s[kk][3]);
      }
      const T* vr = Vs + (kk * 8 + 2 * t) * VS + g;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        uint32_t bh[2], bl[2];
        split_tf32<SPLIT>(to_float(vr[j * 8]), bh[0], bl[0]);
        split_tf32<SPLIT>(to_float(vr[VS + j * 8]), bh[1], bl[1]);
        mma3<SPLIT>(acc[j], ah, al, bh, bl);
      }
    }
  }
  cp_async_wait<0>();

  // out = acc / max(l, 1e-20), by one reciprocal a row, staged through
  // the warp's own Q rows so that the stores to global memory coalesce
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  const float d_lo = fmaxf(l_lo, 1e-20f), d_hi = fmaxf(l_hi, 1e-20f);
  __syncwarp(FULL);
  const float i_lo = 1.f / d_lo, i_hi = 1.f / d_hi;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    float* lo = Qw + g * QS + j * 8 + 2 * t;
    lo[0] = acc[j][0] * i_lo;
    lo[1] = acc[j][1] * i_lo;
    lo[8 * QS] = acc[j][2] * i_hi;
    lo[8 * QS + 1] = acc[j][3] * i_hi;
  }
  __syncwarp(FULL);
  for (int e = lane; e < 16 * HD; e += 32) {
    const int r = e / HD, d = e - r * HD;
    const int qp = r0 + r;
    if (qp < L)
      o[(((size_t)b * L + qp) * H + h) * HD + d] =
          from_float<T>(Qw[r * QS + d]);
  }
}

template <typename T, int HD>
static int launch(const void* q, const void* k, const void* v,
                  const int* kv_len, void* out, int B, int L, int H, int Hkv,
                  int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = FlashSmem<T, HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (L + FA_BQ - 1) / FA_BQ);
  const int vec = aligned(q, 16) && aligned(k, 16) && aligned(v, 16);
  flash_kernel<T, HD><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(out), L, H, Hkv,
      1.4426950408889634f / sqrtf(static_cast<float>(HD)), causal, window,
      vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_hd(const void* q, const void* k, const void* v,
                     const int* kl, void* out, int B, int L, int H, int Hkv,
                     int hd, int causal, int window, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, kl, out, B, L, H, Hkv, causal, window, st);
    case 32: return launch<T, 32>(q, k, v, kl, out, B, L, H, Hkv, causal, window, st);
    case 64: return launch<T, 64>(q, k, v, kl, out, B, L, H, Hkv, causal, window, st);
    case 128: return launch<T, 128>(q, k, v, kl, out, B, L, H, Hkv, causal, window, st);
    case 256: return launch<T, 256>(q, k, v, kl, out, B, L, H, Hkv, causal, window, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// q: (B, L, H, hd); k/v: (B, L, Hkv, hd), Hkv | H; kv_len: (B,) int32 in
// [1, L], or null for all L keys; out like q. dtype: F32 or BF16; hd in
// {16, 32, 64, 128, 256}. Returns cudaGetLastError().
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               const void* kv_len, void* out, int B, int L,
                               int H, int Hkv, int hd, int causal, int window,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* kl = static_cast<const int*>(kv_len);
  if (dtype == F32)
    return launch_hd<float>(q, k, v, kl, out, B, L, H, Hkv, hd, causal,
                            window, st);
  if (dtype == BF16)
    return launch_hd<__nv_bfloat16>(q, k, v, kl, out, B, L, H, Hkv, hd,
                                    causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
