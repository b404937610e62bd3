// Cross-modal consistency scoring (paper Eq. 8-9) for Hopper (sm_90a).
//
// Replaces the two TPU kernels of repro/kernels/xmodal_score.py:
//   K4a `_mean_kernel` (pallas_call at :112):
//       sum1[b] = sum_t mask[b, t] * sum_j cos(tok[b, t], vis[b, j])
//   K4b `_max_kernel` (pallas_call at :127):
//       sum2[b] = sum_r max_j cos(txt[b, r], vis[b, j])
// with cos(x, y) = x.y / (max(|x|, 1e-8) * max(|y|, 1e-8)) in fp32. The
// wrapper (kernels/ops.py xmodal_score) forms
//   S_align[b] = 0.5 * (sum1 / (max(sum_t mask, 1) * Nv) + sum2 / Nt).
//
// What bounds them on an H100, at the serving shape (B 1, L 32, Nv 576,
// Nt 256, d 4096, fp32): K4a by bytes (its L + Nv rows, 9.96 MB, read
// once: 3.0 us at 3.35 TB/s), K4b by operations: 2 Nt Nv d = 1.2 GFLOP,
// which it runs three times over as 3xTF32 on the tensor cores (7.3 us
// at 495 TFLOP/s; 18.0 us on the CUDA cores in fp32), against 4.1 us for
// its 13.6 MB of input.
//
// K4a's design: the sum factors exactly,
//   sum1 = sum_t m_t inv_t (tok_t . u),  u = sum_j inv_j vis_j,
//   inv_x = 1 / max(|x|, 1e-8),
// so it needs no dot product between a token and a visual row. Pass 1
// (`xmodal_mean_kernel_inv`) takes the inverse norms of all B (L + Nv)
// rows, 128 threads a row with 16-byte loads; it is the pass that reads
// the inputs from device memory. Pass 2 (`xmodal_mean_kernel_sum`) cuts d
// into 32-column chunks, one block each (128 at the serving shape):
// u's chunk from the visual rows, which pass 1 left in the 50 MB L2, then
// every token's partial dot with it; the last block of a batch row folds
// the chunks' sums in chunk order.
//
// K4b's design (`xmodal_max_kernel`, one launch): the max over visual rows
// does not factor, so the Nt x Nv dot products run on the tensor cores,
// mma.sync m16n8k8 in TF32 with the helpers of the prefill kernel
// (attention_common.cuh). TF32 keeps 10 mantissa bits, too few for the
// port's fp32 tolerance, so fp32 runs as 3xTF32 (hi = tf32(x), lo =
// x - hi; lo*hi + hi*lo + hi*hi), about 21 bits a product; bf16 values
// are exact in TF32 and take the hi pass alone.
// tests/test_torch_xmodal_max_tf32.py emulates this arithmetic, the split
// plan and the fold order on the CPU. A block of 4 warps takes a tile of
// 64 text rows x 64 visual rows (a warp 16 x 64: 8 accumulator fragments)
// over one split of d: the grid is (tiles, splits, batch rows). One such
// block keeps an SM's tensor pipe busy (a second block on the SM, or
// more warps a block, adds nothing), so the split plan
// (ops.xmodal_max_splits, fixed on the host from the shapes and the SM
// count) takes the fewest splits whose last wave of blocks is 90% full:
// 7 at the serving shape, 252 blocks of 608 columns for its 36 tiles.
// The split's 32-column chunks of both row sets stream through a 3-stage
// ring of cp.async copies (16-byte units where the rows and bases allow
// it, element copies otherwise; the ragged edges of d and of both row
// sets are zero-filled), with one barrier a chunk. The columns of a
// 16-wide group are permuted alike for both operands, as in the prefill
// kernel, so each fragment is one 16-byte shared load, and row strides of
// 16 (mod 32) words keep those loads free of bank conflicts. Each warp
// also sums the squares of its 16 text rows (from its A fragments) and of
// 16 visual rows over the split, from the fp32 values in shared memory,
// so the norms cost no second pass.
// The fold has a fixed order. With more than one split, each block writes
// its partial dot tile (each thread's fragments as float4s, coalesced)
// and squared norms to an fp32 workspace and takes an integer ticket for
// its tile; the last block of the tile sums the splits' partials in split
// order, scales them by the inverse norms, masks visual rows past Nv with
// NEG_INF_F and writes each text row's max over the tile. A second ticket
// per batch row lets the last tile fold the row maxima over the visual
// tiles and sum the rows in a fixed order. The tickets count with
// atomicInc, which wraps to 0 at the last block, so they are left zero
// for the next call and need no fill.
//
// Neither kernel uses float atomics, so repeated runs give bitwise equal
// scores and the same CAMD decisions. Row counts and d need not be tile
// or chunk multiples: the ragged edge loads zeros and is masked out of
// the results. A zero row has inv = 1e8 and adds exactly 0, and a masked
// token adds 0 * (finite), as in the plain version.
#include <type_traits>

#include "attention_common.cuh"

constexpr float XM_EPS = 1e-8f;

// ---------------------------------------------------------------------------
// K4a, factored. sum1 = sum_t m_t inv_t (tok_t . u) with u = sum_j inv_j
// vis_j: two passes that read each input byte once from device memory
// and form no (L x Nv) tile.

// Vector loads of a row: V elements of T as one 16-byte load where the
// launcher found every row 16-byte aligned, one element otherwise.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&f)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_float(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_float(p[i]);
  }
}

constexpr int XA_ROW_THREADS = 128;  // threads that share a row in pass 1
constexpr int XA_INV_ROWS = 2;       // rows a block of pass 1
constexpr int XA_INV_THREADS = XA_ROW_THREADS * XA_INV_ROWS;
constexpr int XA_INV_UNROLL = 8;     // vector loads in flight a thread
constexpr int XA_COLS = 32;          // columns of d a block of pass 2 takes
constexpr int XA_THREADS = 1024;
constexpr int XA_WARPS = XA_THREADS / 32;
constexpr int XA_UNROLL = 18;        // visual rows in flight a lane

// Pass 1: inv[r] = 1 / max(|row r|, 1e-8) for the B L token rows, then
// the B Nv visual rows. XA_ROW_THREADS threads share a row (16 KB at
// d 4096 fp32: 8 vector loads a thread, all in flight at once); their
// sums of squares fold by a butterfly in each warp, then in warp order.
// Block 0 also zeroes the tickets of pass 2, which runs after it on the
// same stream.
template <typename T, int V>
__global__ void __launch_bounds__(XA_INV_THREADS)
xmodal_mean_kernel_inv(const T* __restrict__ tok, const T* __restrict__ vis,
                       float* __restrict__ inv, int* __restrict__ ticket,
                       int B, int L, int Nv, int d) {
  __shared__ float red[XA_INV_THREADS / 32];
  if (blockIdx.x == 0)
    for (int b = threadIdx.x; b < B; b += XA_INV_THREADS) ticket[b] = 0;
  const int rt = threadIdx.x % XA_ROW_THREADS;
  const long r =
      (long)blockIdx.x * XA_INV_ROWS + threadIdx.x / XA_ROW_THREADS;
  const long n_tok = (long)B * L, rows = n_tok + (long)B * Nv;
  float sq = 0.f;
  if (r < rows) {
    const T* row = r < n_tok ? tok + r * d : vis + (r - n_tok) * d;
    for (int c0 = rt * V; c0 < d; c0 += XA_ROW_THREADS * V * XA_INV_UNROLL) {
      float x[XA_INV_UNROLL][V];
#pragma unroll
      for (int u = 0; u < XA_INV_UNROLL; ++u) {
        const int c = c0 + u * XA_ROW_THREADS * V;
#pragma unroll
        for (int i = 0; i < V; ++i) x[u][i] = 0.f;
        if (c < d) load_vec<T, V>(row + c, x[u]);
      }
#pragma unroll
      for (int u = 0; u < XA_INV_UNROLL; ++u)
#pragma unroll
        for (int i = 0; i < V; ++i) sq += x[u][i] * x[u][i];
    }
  }
  sq = warp_sum(sq);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = sq;
  __syncthreads();
  if (rt == 0 && r < rows) {
    constexpr int W = XA_ROW_THREADS / 32;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) t += red[threadIdx.x / 32 + w];
    inv[r] = 1.f / fmaxf(sqrtf(t), XM_EPS);
  }
}

struct MeanSmem {
  float u[XA_WARPS][XA_COLS];        // each warp's share of u's columns
  float red[XA_WARPS];
  int last;
};

// Fixed-order sum over the block of one value a warp (valid in lane 0);
// the result is valid in thread 0.
__device__ float mean_block_sum(float v, MeanSmem& sm) {
  if (threadIdx.x % 32 == 0) sm.red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < XA_WARPS; ++w) t += sm.red[w];
  __syncthreads();
  return t;
}

// Pass 2, grid (column chunks of XA_COLS, B). Lane l of every warp owns
// column c = chunk * XA_COLS + l: warp w sums inv_j vis[j][c] over the
// visual rows j = w (mod XA_WARPS), XA_UNROLL loads in flight (the rows
// come from the L2, where pass 1 left them), and after one barrier each
// warp folds the XA_WARPS shares of u[c] in warp order itself. Warp w
// then takes the token rows t = w (mod XA_WARPS): the chunk's dot
// tok_t . u by a butterfly, weighted by m_t inv_t. The block's sum goes
// to partial[b][chunk]; the last block of batch row b (integer ticket)
// folds the row's partials in chunk order. No float atomics: two runs
// give the same bits.
template <typename T>
__global__ void __launch_bounds__(XA_THREADS)
xmodal_mean_kernel_sum(const T* __restrict__ tok,
                       const float* __restrict__ mask,
                       const T* __restrict__ vis,
                       const float* __restrict__ inv, float* partial,
                       int* ticket, float* __restrict__ out, int L, int Nv,
                       int d) {
  __shared__ MeanSmem sm;
  const int b = blockIdx.y, B = gridDim.y, chunks = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * XA_COLS + lane;
  const bool live = c < d;
  const float* inv_t = inv + (size_t)b * L;
  const float* inv_v = inv + (size_t)B * L + (size_t)b * Nv;
  tok += (size_t)b * L * d + c;
  vis += (size_t)b * Nv * d + c;
  // the warp's first token (value, mask, inverse norm), in flight beside
  // the visual rows
  const bool t0 = warp < L;
  const float x0 = (t0 && live) ? to_float(tok[(size_t)warp * d]) : 0.f;
  const float m0 = t0 ? mask[(size_t)b * L + warp] : 0.f;
  const float i0 = t0 ? inv_t[warp] : 0.f;
  float acc = 0.f;
  for (int j0 = warp; j0 < Nv; j0 += XA_WARPS * XA_UNROLL) {
    float x[XA_UNROLL], w[XA_UNROLL];
#pragma unroll
    for (int i = 0; i < XA_UNROLL; ++i) {
      const int j = j0 + i * XA_WARPS;
      w[i] = j < Nv ? inv_v[j] : 0.f;
      x[i] = (j < Nv && live) ? to_float(vis[(size_t)j * d]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < XA_UNROLL; ++i) acc += w[i] * x[i];
  }
  sm.u[warp][lane] = acc;
  __syncthreads();
  float u = 0.f;
#pragma unroll
  for (int w = 0; w < XA_WARPS; ++w) u += sm.u[w][lane];
  float s = 0.f;
  for (int t = warp; t < L; t += XA_WARPS) {
    const bool first = t == warp;
    const float x =
        first ? x0 : (live ? to_float(tok[(size_t)t * d]) : 0.f);
    const float dot = warp_sum(x * u);
    s += (first ? m0 : mask[(size_t)b * L + t]) *
         ((first ? i0 : inv_t[t]) * dot);
  }
  s = mean_block_sum(s, sm);
  float* part = partial + (size_t)b * chunks;
  if (threadIdx.x == 0) {             // publish, then take a ticket
    part[blockIdx.x] = s;
    __threadfence();
    sm.last = atomicAdd(&ticket[b], 1) == chunks - 1;
  }
  __syncthreads();
  if (!sm.last) return;
  float t = 0.f;
  for (int i = threadIdx.x; i < chunks; i += XA_THREADS) t += __ldcg(&part[i]);
  t = mean_block_sum(warp_sum(t), sm);
  if (threadIdx.x == 0) out[b] = t;
}

// ---------------------------------------------------------------------------
// K4b on the tensor cores: sum2 = sum_r max_j cos(txt_r, vis_j).

constexpr int XM_ROWS = 64;                   // text rows of a tile
constexpr int XM_COLS = 64;                   // visual rows of a tile
constexpr int XM_WARPS = XM_ROWS / 16;        // a warp per 16 text rows
constexpr int XM_THREADS = 32 * XM_WARPS;
constexpr int XM_NT = XM_COLS / 8;            // 8-row n-tiles of a warp
constexpr int XM_KC = 32;                     // columns of d a chunk
constexpr int XM_STAGES = 3;                  // chunks in the ring
constexpr int XM_NORMS = XM_ROWS + XM_COLS;   // rows a tile stages
constexpr int XM_TILE = XM_ROWS * XM_COLS;    // dot products of a tile
static_assert(XM_THREADS == XM_NORMS && XM_COLS == 16 * XM_WARPS,
              "a thread per staged row's norm; a warp squares 16 visual "
              "rows");

// Dynamic shared memory of a block: the ring (STAGES chunks of the 64 text
// rows, then the 64 visual rows, KS elements a row), then the block's
// squared norms and the tile's inverse norms (a float per staged row
// each). KS as the prefill kernel's K rows: fp32 fragments are 16-byte
// loads, bf16 8-byte ones, and the rows that one phase of such a load
// reads lie on distinct banks.
template <typename T>
struct MaxSmem {
  static constexpr int KS =
      sizeof(T) == 4 ? pad_to(XM_KC, 16, 32) : pad_to(XM_KC, 16, 64);
  static constexpr int STAGE = XM_NORMS * KS;
  static constexpr size_t ring_bytes = sizeof(T) * XM_STAGES * STAGE;
  static constexpr size_t bytes = ring_bytes + sizeof(float) * 2 * XM_NORMS;
};

// Grid (tiles, splits, batch rows). Tile x = it * tiles_v + iv covers text
// rows [64 it, 64 it + 64) and visual rows [64 iv, 64 iv + 64); split s
// columns [s cols, min(d, (s + 1) cols)) of d. Warp w takes text rows
// 16 w + [0, 16) against all 64 visual rows, and squares its text rows
// and visual rows 16 w + [0, 16). part: (B, tiles, splits, XM_NT,
// XM_THREADS) float4, thread i's accumulator fragment n at [.., n, i]
// (coalesced), and norms: (B, tiles, splits, 128) fp32, both used with
// more than one split; rowmax: (B, tiles_v, Nt) fp32; ticket: (B tiles +
// B) zeros, left zero; out: (B,) fp32. vec: rows and bases allow 16-byte
// copies.
template <typename T>
__global__ void __launch_bounds__(XM_THREADS)
xmodal_max_kernel(const T* __restrict__ txt, const T* __restrict__ vis,
                  float4* part, float* norms, float* rowmax,
                  unsigned* ticket, float* __restrict__ out, int Nt, int Nv,
                  int d, int cols, int vec) {
  using SM = MaxSmem<T>;
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int KS = SM::KS;
  const int tiles = gridDim.x, S = gridDim.y;
  const int s = blockIdx.y, b = blockIdx.z;
  const int tiles_v = (Nv + XM_COLS - 1) / XM_COLS;
  const int it = blockIdx.x / tiles_v, iv = blockIdx.x - it * tiles_v;
  const int r0 = it * XM_ROWS, v0 = iv * XM_COLS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;   // fragment row group, column pair
  const int k_beg = s * cols, k_end = min(d, k_beg + cols);
  const int nchunks = (k_end - k_beg + XM_KC - 1) / XM_KC;

  extern __shared__ __align__(16) unsigned char xm_smem[];
  T* ring = reinterpret_cast<T*>(xm_smem);
  float* sq_s = reinterpret_cast<float*>(xm_smem + SM::ring_bytes);
  float* inv_s = sq_s + XM_NORMS;
  __shared__ float red[XM_WARPS];
  __shared__ int last;

  const T* tb = txt + (size_t)b * Nt * d;
  const T* vb = vis + (size_t)b * Nv * d;

  // copy chunk kc of the split (both row sets) into stage kc % XM_STAGES;
  // rows past Nt or Nv and columns past the split's end are zero-filled
  auto load_chunk = [&](int kc) {
    T* st = ring + (kc % XM_STAGES) * SM::STAGE;
    const int k0 = k_beg + kc * XM_KC;
    if (vec) {
      constexpr int EPC = 16 / static_cast<int>(sizeof(T));   // per unit
      constexpr int CH = XM_KC / EPC;                          // units a row
#pragma unroll
      for (int i = 0; i < XM_NORMS * CH / XM_THREADS; ++i) {
        const int e = tid + i * XM_THREADS;
        const int r = e / CH, c = (e - r * CH) * EPC;
        const bool is_t = r < XM_ROWS;
        const int row = is_t ? r0 + r : v0 + r - XM_ROWS;
        const bool ok = row < (is_t ? Nt : Nv) && k0 + c < k_end;
        const T* src = (is_t ? tb : vb) + (ok ? (size_t)row * d + k0 + c : 0);
        copy_unit<16>(st + r * KS + c, src, ok);
      }
    } else {
      for (int e = tid; e < XM_NORMS * XM_KC; e += XM_THREADS) {
        const int r = e / XM_KC, c = e - r * XM_KC;
        const bool is_t = r < XM_ROWS;
        const int row = is_t ? r0 + r : v0 + r - XM_ROWS;
        const bool ok = row < (is_t ? Nt : Nv) && k0 + c < k_end;
        st[r * KS + c] = ok ? (is_t ? tb : vb)[(size_t)row * d + k0 + c]
                            : from_float<T>(0.f);
      }
    }
    cp_async_commit();
  };

  // acc[n]: text rows 16 warp + g, + 8 against visual rows 8 n + 2 t, + 1;
  // sq: the squares of those two text rows and of visual rows 16 warp + g,
  // + 8, over this lane's columns
  float acc[XM_NT][4];
#pragma unroll
  for (int n = 0; n < XM_NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float sq[4] = {0.f, 0.f, 0.f, 0.f};

#pragma unroll
  for (int kc = 0; kc < XM_STAGES - 1; ++kc) {
    if (kc < nchunks) load_chunk(kc);
    else cp_async_commit();
  }
  for (int kc = 0; kc < nchunks; ++kc) {
    cp_async_wait<XM_STAGES - 2>();
    __syncthreads();   // chunk kc landed; every warp is done with kc - 1
    if (kc + XM_STAGES - 1 < nchunks) load_chunk(kc + XM_STAGES - 1);
    else cp_async_commit();
    const T* A = ring + (kc % XM_STAGES) * SM::STAGE + 16 * warp * KS;
    const T* V = ring + (kc % XM_STAGES) * SM::STAGE + XM_ROWS * KS;
    const T* Vw = V + 16 * warp * KS;
    // column 16 c + 4 t + i holds column t (i = 0, 2) or t + 4 (i = 1, 3)
    // of k-step 2 c + i / 2, alike for both operands, so a lane's values
    // of both k-steps are one load
#pragma unroll
    for (int c = 0; c < XM_KC / 16; ++c) {
      const int col = 16 * c + 4 * t;
      float x0[4], x8[4], y0[4], y8[4];
      load4(A + g * KS + col, x0);
      load4(A + (g + 8) * KS + col, x8);
      load4(Vw + g * KS + col, y0);
      load4(Vw + (g + 8) * KS + col, y8);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sq[0] = fmaf(x0[i], x0[i], sq[0]);
        sq[1] = fmaf(x8[i], x8[i], sq[1]);
        sq[2] = fmaf(y0[i], y0[i], sq[2]);
        sq[3] = fmaf(y8[i], y8[i], sq[3]);
      }
      uint32_t ah[2][4], al[2][4];         // k-steps 2 c, 2 c + 1
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        split_tf32<SPLIT>(x0[2 * k], ah[k][0], al[k][0]);
        split_tf32<SPLIT>(x8[2 * k], ah[k][1], al[k][1]);
        split_tf32<SPLIT>(x0[2 * k + 1], ah[k][2], al[k][2]);
        split_tf32<SPLIT>(x8[2 * k + 1], ah[k][3], al[k][3]);
      }
#pragma unroll
      for (int n = 0; n < XM_NT; ++n) {
        float kx[4];
        load4(V + (n * 8 + g) * KS + col, kx);
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          split_tf32<SPLIT>(kx[2 * k], bh[k][0], bl[k][0]);
          split_tf32<SPLIT>(kx[2 * k + 1], bh[k][1], bl[k][1]);
          mma3<SPLIT>(acc[n], ah[k], al[k], bh[k], bl[k]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // this block's squared norms (text rows 0..63, then visual rows) and,
  // in the ring's space, its partial dot tile
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float v = quad_sum(sq[q]);
    const int r = (q < 2 ? 0 : XM_ROWS) + 16 * warp + 8 * (q & 1) + g;
    if (t == 0) sq_s[r] = v;
  }
  __syncthreads();

  // publish this split's partials and take the tile's ticket: the last of
  // its S blocks folds the tile
  const size_t tile = (size_t)b * tiles + blockIdx.x;
  const float4* tpart = part + tile * S * XM_NT * XM_THREADS + tid;
  const float* tnorm = norms + tile * S * XM_NORMS;
  if (S > 1) {
    float4* p = part + (tile * S + s) * XM_NT * XM_THREADS + tid;
#pragma unroll
    for (int n = 0; n < XM_NT; ++n)
      p[n * XM_THREADS] = make_float4(acc[n][0], acc[n][1], acc[n][2],
                                      acc[n][3]);
    norms[(tile * S + s) * XM_NORMS + tid] = sq_s[tid];
    __threadfence();
    __syncthreads();
    if (tid == 0)
      last = atomicInc(&ticket[tile], S - 1) == static_cast<unsigned>(S - 1);
    __syncthreads();
    if (!last) return;
  }

  // inverse norms of the tile's rows, their squares summed in split order
  {
    float n2 = 0.f;
    for (int j = 0; j < S; ++j)
      n2 += j == s ? sq_s[tid] : __ldcg(&tnorm[(size_t)j * XM_NORMS + tid]);
    inv_s[tid] = 1.f / fmaxf(sqrtf(n2), XM_EPS);
  }
  // dot products, the splits' partials summed in split order, two splits'
  // loads in flight at a time
  float dot[XM_NT][4];
#pragma unroll
  for (int n = 0; n < XM_NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dot[n][i] = 0.f;
  for (int j0 = 0; j0 < S; j0 += 2) {
    float4 v[2][XM_NT];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + h;
      if (j < S && j != s)
#pragma unroll
        for (int n = 0; n < XM_NT; ++n)
          v[h][n] = __ldcg(tpart + (j * XM_NT + n) * XM_THREADS);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + h;
      if (j >= S) break;
#pragma unroll
      for (int n = 0; n < XM_NT; ++n) {
        const float4 x = j == s ? make_float4(acc[n][0], acc[n][1],
                                              acc[n][2], acc[n][3])
                                : v[h][n];
        dot[n][0] += x.x;
        dot[n][1] += x.y;
        dot[n][2] += x.z;
        dot[n][3] += x.w;
      }
    }
  }
  __syncthreads();   // inv_s complete

  // each text row's max over the tile's visual rows; padded ones never win
  const int rl = 16 * warp + g;
  const float ia = inv_s[rl], ib = inv_s[rl + 8];
  float m_lo = NEG_INF_F, m_hi = NEG_INF_F;
#pragma unroll
  for (int n = 0; n < XM_NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * n + 2 * t + e;
      if (v0 + c < Nv) {
        const float ic = inv_s[XM_ROWS + c];
        m_lo = fmaxf(m_lo, dot[n][e] * ia * ic);
        m_hi = fmaxf(m_hi, dot[n][2 + e] * ib * ic);
      }
    }
  m_lo = quad_max(m_lo);
  m_hi = quad_max(m_hi);
  float* rm = rowmax + ((size_t)b * tiles_v + iv) * Nt + r0;
  if (t == 0 && r0 + rl < Nt) rm[rl] = m_lo;
  if (t == 0 && r0 + rl + 8 < Nt) rm[rl + 8] = m_hi;

  // the last tile of batch row b sums the rows' maxima over all visual
  // tiles: thread i takes rows i, i + 128, ..., in order, then a butterfly
  // a warp and the warps' sums in warp order
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicInc(&ticket[(size_t)gridDim.z * tiles + b], tiles - 1) ==
           static_cast<unsigned>(tiles - 1);
  __syncthreads();
  if (!last) return;
  const float* rmb = rowmax + (size_t)b * tiles_v * Nt;
  float total = 0.f;
  for (int r = tid; r < Nt; r += XM_THREADS) {
    float m = NEG_INF_F;
#pragma unroll 4
    for (int j = 0; j < tiles_v; ++j)
      m = fmaxf(m, __ldcg(&rmb[(size_t)j * Nt + r]));
    total += m;
  }
  total = warp_sum(total);
  if (lane == 0) red[warp] = total;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < XM_WARPS; ++w) sum += red[w];
    out[b] = sum;
  }
}

static inline unsigned cdiv(int n, int m) { return (n + m - 1) / m; }

template <typename T, int V>
static void launch_mean(const void* tok, const float* mask, const void* vis,
                        float* work, int* ticket, float* out, int B, int L,
                        int Nv, int d, cudaStream_t st) {
  const T* t = static_cast<const T*>(tok);
  const T* v = static_cast<const T*>(vis);
  const int rows = B * (L + Nv);
  xmodal_mean_kernel_inv<T, V><<<cdiv(rows, XA_INV_ROWS), XA_INV_THREADS,
                                 0, st>>>(
      t, v, work, ticket, B, L, Nv, d);
  const dim3 grid(cdiv(d, XA_COLS), B);
  xmodal_mean_kernel_sum<T><<<grid, XA_THREADS, 0, st>>>(
      t, mask, v, work, work + rows, ticket, out, L, Nv, d);
}

// tok: (B, L, d); mask: (B, L) fp32; vis: (B, Nv, d); work: (B (L + Nv)
// + B ceil(d/32)) fp32 (the rows' inverse norms, then the chunks'
// partials); ticket: (B,) int32, zeroed by the first kernel; out: (B,)
// fp32. dtype: F32 or BF16 (tok and vis alike). Returns
// cudaGetLastError().
extern "C" int xmodal_score_mean(const void* tok, const void* mask,
                                 const void* vis, void* work, void* ticket,
                                 void* out, int B, int L, int Nv, int d,
                                 int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  float* w = static_cast<float*>(work);
  int* tk = static_cast<int*>(ticket);
  float* o = static_cast<float*>(out);
  if (dtype != F32 && dtype != BF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = dtype == F32 ? 4 : 2;
  const bool vec = (long)d * elem % 16 == 0 && aligned(tok, 16) &&
                   aligned(vis, 16);
  if (dtype == F32 && vec)
    launch_mean<float, 4>(tok, m, vis, w, tk, o, B, L, Nv, d, st);
  else if (dtype == F32)
    launch_mean<float, 1>(tok, m, vis, w, tk, o, B, L, Nv, d, st);
  else if (vec)
    launch_mean<__nv_bfloat16, 8>(tok, m, vis, w, tk, o, B, L, Nv, d, st);
  else
    launch_mean<__nv_bfloat16, 1>(tok, m, vis, w, tk, o, B, L, Nv, d, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_max(const void* txt, const void* vis, float* work,
                      unsigned* ticket, float* out, int B, int Nt, int Nv,
                      int d, int n_split, int cols, int vec, cudaStream_t st) {
  constexpr size_t smem = MaxSmem<T>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      xmodal_max_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tiles = cdiv(Nt, XM_ROWS) * cdiv(Nv, XM_COLS);
  const size_t parts = n_split > 1 ? (size_t)B * tiles * n_split : 0;
  float4* part = reinterpret_cast<float4*>(work);
  float* norms = work + parts * XM_TILE;
  float* rowmax = norms + parts * XM_NORMS;
  const dim3 grid(tiles, n_split, B);
  xmodal_max_kernel<T><<<grid, XM_THREADS, smem, st>>>(
      static_cast<const T*>(txt), static_cast<const T*>(vis), part, norms,
      rowmax, ticket, out, Nt, Nv, d, cols, vec);
  return static_cast<int>(cudaGetLastError());
}

// txt: (B, Nt, d); vis: (B, Nv, d); n_split splits of cols columns of d
// each (a multiple of 32, (n_split - 1) cols < d <= n_split cols:
// ops.xmodal_max_splits); work: fp32, B T n_split (64 x 64 + 128) floats
// when n_split > 1 (none otherwise), then B ceil(Nv/64) Nt, with
// T = ceil(Nt/64) ceil(Nv/64) tiles; ticket: (B T + B) uint32, zero on
// entry and left zero; out: (B,) fp32. dtype: F32 or BF16 (txt and vis
// alike). Returns cudaGetLastError().
extern "C" int xmodal_score_max(const void* txt, const void* vis, void* work,
                                void* ticket, void* out, int B, int Nt, int Nv,
                                int d, int n_split, int cols, int dtype,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  unsigned* tk = static_cast<unsigned*>(ticket);
  float* o = static_cast<float*>(out);
  if ((dtype != F32 && dtype != BF16) || n_split < 1 || cols <= 0 ||
      cols % XM_KC != 0 || (long)(n_split - 1) * cols >= d ||
      (long)n_split * cols < d)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = dtype == F32 ? 4 : 2;
  const int vec = (long)d * elem % 16 == 0 && aligned(txt, 16) &&
                  aligned(vis, 16);
  if (dtype == F32)
    return launch_max<float>(txt, vis, w, tk, o, B, Nt, Nv, d, n_split,
                             cols, vec, st);
  return launch_max<__nv_bfloat16>(txt, vis, w, tk, o, B, Nt, Nv, d, n_split,
                                   cols, vec, st);
}
