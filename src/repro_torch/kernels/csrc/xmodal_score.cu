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
// once: 3.0 us at 3.35 TB/s), K4b by fp32 operations (2 Nt Nv d = 1.2
// GFLOP on the CUDA cores; the tensor cores would need TF32, which rounds
// the products to 10 mantissa bits).
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
// K4b's design: a block of 128 threads computes
// the 32 x 64 tile of dot products between rows [r0, r0 + 32) and visual
// rows [v0, v0 + 64), each thread a 4 x 4 micro-tile in registers. The d
// loop stages 64-wide chunks through shared memory, stored k-major so each
// step of the product reads four rows and four visual rows with one 16-byte
// load each (16 multiply-adds per 2-3 shared-memory wavefronts a warp); the
// next chunk's global loads start before the current chunk's products,
// so their latency hides behind them. The loaders cover 4 rows x 8 columns
// of d per warp instruction (four full 32-byte sectors), which with a row
// stride of 4 (mod 32) words also makes their transposing stores
// conflict-free. The squared norms of the rows accumulate in the loaders'
// registers on the way, so normalising costs no second pass. The grid
// covers (text row tiles, visual tiles, batch rows), 72 blocks at the
// serving shape. Each block reduces its tile to each row's max over its
// visual rows, and the last block of a batch row to finish, found by an
// integer atomic ticket, folds all partials in a fixed order.
//
// Neither kernel uses float atomics, so repeated runs give bitwise equal
// scores and the same CAMD decisions. Row counts and d need not be tile
// or chunk multiples: the ragged edge loads zeros and is masked out of
// the results. A zero row has inv = 1e8 and adds exactly 0, and a masked
// token adds 0 * (finite), as in the plain version.
#include "attention_common.cuh"

constexpr int XM_ROWS = 32;        // rows (tokens or text) per block
constexpr int XM_COLS = 64;        // visual rows per block
constexpr int XM_K = 64;           // d chunk staged through shared memory
constexpr int XM_KG = XM_K / 8;    // 8-column groups of a chunk
constexpr int XM_THREADS = 128;    // 8 x 16 threads, 4 x 4 outputs each
constexpr int XM_WARPS = XM_THREADS / 32;
constexpr int XM_A_LOADS = XM_ROWS * XM_K / XM_THREADS;   // 16 a thread
constexpr int XM_V_LOADS = XM_COLS * XM_K / XM_THREADS;   // 32 a thread
constexpr float XM_EPS = 1e-8f;

struct TileSmem {
  float a[XM_K][XM_ROWS + 4];      // k-major; stride 4 (mod 32) words
  float v[XM_K][XM_COLS + 4];
  float inv_a[XM_ROWS];            // 1 / max(|row|, eps)
  float inv_v[XM_COLS];
  float red[XM_WARPS];
  int last;
};

// Loader role: instruction j of warp w covers rows
// (w * J / XM_KG + j / XM_KG) * 4 + lane / 8 and columns
// (j % XM_KG) * 8 + lane % 8 of a chunk.
template <int J>
__device__ __forceinline__ int load_row(int j) {
  return ((threadIdx.x / 32) * (J / XM_KG) + j / XM_KG) * 4 +
         (threadIdx.x % 32) / 8;
}
template <int J>
__device__ __forceinline__ int load_col(int j) {
  return (j % XM_KG) * 8 + threadIdx.x % 8;
}

template <int J, typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ x, int n,
                                           int r0, int d, int k0,
                                           float (&reg)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int row = r0 + load_row<J>(j), k = k0 + load_col<J>(j);
    reg[j] = (row < n && k < d) ? to_float(x[(size_t)row * d + k]) : 0.f;
  }
}

template <int J, int W>
__device__ __forceinline__ void store_chunk(float (*s)[W],
                                            const float (&reg)[J],
                                            float (&sq)[J / XM_KG]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    s[load_col<J>(j)][load_row<J>(j)] = reg[j];
    sq[j / XM_KG] += reg[j] * reg[j];
  }
}

// Inverse norms of the rows this thread's loads covered: the 8 lanes that
// share a row hold its partial sums of squares.
template <int J>
__device__ __forceinline__ void store_inv(float* inv,
                                          float (&sq)[J / XM_KG]) {
#pragma unroll
  for (int q = 0; q < J / XM_KG; ++q) {
    float t = sq[q];
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (threadIdx.x % 8 == 0) inv[load_row<J>(XM_KG * q)] =
        1.f / fmaxf(sqrtf(t), XM_EPS);
  }
}

// Dot products of rows [r0, r0 + 32) of a (n_a, d) with rows [v0, v0 + 64)
// of vis (n_v, d): thread (tx, ty) = (tid % 16, tid / 16) gets rows
// 4 ty + i against visual rows 4 tx + j in acc[i][j], and sm.inv_a /
// sm.inv_v hold the inverse norms of all rows of both sides on return.
template <typename T>
__device__ void cos_tile(const T* __restrict__ a, int n_a, int r0,
                         const T* __restrict__ vis, int n_v, int v0, int d,
                         TileSmem& sm, float (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float ra[XM_A_LOADS], rv[XM_V_LOADS];
  float sq_a[XM_A_LOADS / XM_KG] = {}, sq_v[XM_V_LOADS / XM_KG] = {};
  load_chunk(a, n_a, r0, d, 0, ra);
  load_chunk(vis, n_v, v0, d, 0, rv);
  for (int k0 = 0; k0 < d; k0 += XM_K) {
    store_chunk(sm.a, ra, sq_a);
    store_chunk(sm.v, rv, sq_v);
    __syncthreads();
    if (k0 + XM_K < d) {               // in flight during the products
      load_chunk(a, n_a, r0, d, k0 + XM_K, ra);
      load_chunk(vis, n_v, v0, d, k0 + XM_K, rv);
    }
#pragma unroll 8
    for (int kk = 0; kk < XM_K; ++kk) {
      const float4 x = *reinterpret_cast<const float4*>(&sm.a[kk][4 * ty]);
      const float4 y = *reinterpret_cast<const float4*>(&sm.v[kk][4 * tx]);
      const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += xs[i] * ys[j];
    }
    __syncthreads();
  }
  store_inv<XM_A_LOADS>(sm.inv_a, sq_a);
  store_inv<XM_V_LOADS>(sm.inv_v, sq_v);
  __syncthreads();
}

// Sum of v over the block in a fixed order; the result is valid in thread 0.
__device__ float block_sum(float v, TileSmem& sm) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) sm.red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < XM_WARPS; ++w) t += sm.red[w];
  __syncthreads();
  return t;
}

// Publish this block's partials (written before the call by any thread) and
// take a ticket; true in every thread of the last block of batch row b.
__device__ bool last_block(int* ticket, int b, int blocks, TileSmem& sm) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) sm.last = atomicAdd(&ticket[b], 1) == blocks - 1;
  __syncthreads();
  return sm.last;
}

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

// K4b. partial: (B, gridDim.y, Nt) fp32 row maxima per visual tile; ticket:
// (B,) int32 zeros; out: (B,) fp32 sum2.
template <typename T>
__global__ void __launch_bounds__(XM_THREADS)
xmodal_max_kernel(const T* __restrict__ txt, const T* __restrict__ vis,
                  float* partial, int* ticket, float* out, int Nt, int Nv,
                  int d) {
  __shared__ __align__(16) TileSmem sm;
  const int b = blockIdx.z;
  const int r0 = blockIdx.x * XM_ROWS, v0 = blockIdx.y * XM_COLS;
  txt += (size_t)b * Nt * d;
  vis += (size_t)b * Nv * d;
  float acc[4][4] = {};
  cos_tile(txt, Nt, r0, vis, Nv, v0, d, sm, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_vt = gridDim.y;
  float* part = partial + (size_t)b * n_vt * Nt;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    float m = NEG_INF_F;               // padded visual rows never win
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * tx + j;
      if (v0 + c < Nv) m = fmaxf(m, acc[i][j] * sm.inv_a[r] * sm.inv_v[c]);
    }
    // the 16 threads of row r are one half of a warp
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (tx == 0 && r0 + r < Nt) part[(size_t)blockIdx.y * Nt + r0 + r] = m;
  }
  if (!last_block(ticket, b, gridDim.x * n_vt, sm)) return;
  float t = 0.f;
  for (int r = threadIdx.x; r < Nt; r += XM_THREADS) {
    float m = NEG_INF_F;
    for (int iv = 0; iv < n_vt; ++iv)
      m = fmaxf(m, __ldcg(&part[(size_t)iv * Nt + r]));
    t += m;
  }
  t = block_sum(t, sm);
  if (threadIdx.x == 0) out[b] = t;
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

// txt: (B, Nt, d); vis: (B, Nv, d); partial: (B, ceil(Nv/64), Nt) fp32;
// ticket: (B,) int32 zeros; out: (B,) fp32. dtype: F32 or BF16 (txt and vis
// alike). Returns cudaGetLastError().
extern "C" int xmodal_score_max(const void* txt, const void* vis,
                                void* partial, void* ticket, void* out, int B,
                                int Nt, int Nv, int d, int dtype,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(cdiv(Nt, XM_ROWS), cdiv(Nv, XM_COLS), B);
  float* p = static_cast<float*>(partial);
  int* tk = static_cast<int*>(ticket);
  float* o = static_cast<float*>(out);
  if (dtype == F32)
    xmodal_max_kernel<float><<<grid, XM_THREADS, 0, st>>>(
        static_cast<const float*>(txt), static_cast<const float*>(vis), p, tk,
        o, Nt, Nv, d);
  else if (dtype == BF16)
    xmodal_max_kernel<__nv_bfloat16><<<grid, XM_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(txt),
        static_cast<const __nv_bfloat16*>(vis), p, tk, o, Nt, Nv, d);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
