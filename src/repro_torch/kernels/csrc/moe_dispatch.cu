// Mixture-of-experts dispatch and combine for Hopper (sm_90a).
//
// Replaces the two TPU kernels of repro/kernels/moe_dispatch.py:
//   K5a `moe_dispatch` (pallas_call at :67, body `_dispatch_kernel`):
//       expert_in[gr, e, c] = x[gr, idx[gr, e, c]], or zeros where the
//       slot is empty (idx = -1);
//   K5b `moe_combine` (pallas_call at :88, body `_combine_kernel`), with
//       eo the expert outputs:
//       out[gr, t] = sum_j gates[gr, t, j] * eo[gr].flat[slot[gr, t, j]]
//       over the choices j whose slot is not -1 (dropped), summed in j order
//       in fp32.
// Both are gathers: the capacity-dispatch one-hot einsums of the
// reference's moe_apply (repro/models/moe.py:115, :136) compute the same
// function with O(E * C) work per token where these move O(k) rows.
//
// What bounds them on an H100: bytes. Neither does arithmetic worth the
// name (K5b: 2 k d FLOPs per token against 4 k d bytes read).
//
// Design. The TPU kernels run one program per token group, which on this
// card would be 8 blocks at a prefill bucket and 1 at decode for 132 SMs.
// Here:
//   K5a: a flat grid over the output's copy units, MD_UNITS per thread
//        (16 bytes where the row's byte length and both base addresses
//        allow it, 4- or 2-byte units otherwise: the copy is bitwise, so
//        one kernel serves fp32 and bf16). A block first resolves the
//        source row of each slot row its units fall in (one token id load
//        per row, into shared memory), then every thread loads its units
//        and stores them; neighbouring threads take neighbouring units.
//        At granite's decode shape (320 slot rows of 384 units) that is
//        240 blocks of 256 threads, each thread two 16-byte copies, where
//        one warp per row gave 40 blocks of 12 copies a lane. Empty slots
//        are written as zeros without reading anything.
//   K5b: one warp per (token, 32 V columns of d), V = 4 fp32 or 8 bf16
//        values a lane (one 16-byte load of each row) where the row's
//        byte length and both base addresses allow it, V = 1 otherwise;
//        at granite's decode shape 96 warps in 24 blocks. Its cost there
//        is latency, not bytes (0.44 MB, 0.13 us at 3.35 TB/s): two
//        dependent loads, the token's slot ids and then the rows they
//        name. So nothing else stands between them: at k = 8 (a
//        compile-time constant) every lane loads the 8 ids and gates
//        itself, two 16-byte loads each, where the tables are 16-byte
//        aligned; otherwise lane j < k loads choice j's and the warp
//        broadcasts them by shuffles. No shared memory, no barrier; the
//        rows' loads (8 at a time) are all issued before the first
//        multiply-add. Each lane sums its columns over the k choices in
//        j order in fp32 registers, with no atomics, so two runs give
//        the same bits.
// Ids outside their range (token ids outside [0, g), slot ids outside
// [0, E * C)) count as empty or dropped, so a bad id never reads outside
// its group.
#include "attention_common.cuh"

constexpr int MD_THREADS = 256;
constexpr int MD_UNITS = 2;                   // copy units per thread
constexpr int MD_CHUNK = MD_THREADS * MD_UNITS;   // units per block
constexpr int MC_THREADS = 128;
constexpr int MC_WARPS = MC_THREADS / 32;     // column spans a block
constexpr int MC_MAX_K = 32;                  // ops.py checks k <= this
constexpr int MC_GROUP = 8;                   // row loads in flight a lane

template <typename V>
__global__ void __launch_bounds__(MD_THREADS)
moe_dispatch_kernel(const int* __restrict__ idx, const V* __restrict__ x,
                    V* __restrict__ out, long rows, int EC, int g, int nv) {
  // source row (group * g + token) of each slot row this block writes,
  // -1 for an empty slot; a chunk of MD_CHUNK units spans at most
  // MD_CHUNK rows (nv = 1)
  __shared__ long src_s[MD_CHUNK];
  const long total = rows * nv;
  const long u0 = (long)blockIdx.x * MD_CHUNK;
  const long r0 = u0 / nv;
  const long r1 = (min(u0 + MD_CHUNK, total) - 1) / nv;
  for (long r = r0 + threadIdx.x; r <= r1; r += MD_THREADS) {
    const int t = idx[r];
    src_s[r - r0] = (t >= 0 && t < g) ? (r / EC) * g + t : -1;
  }
  __syncthreads();
  V val[MD_UNITS];
#pragma unroll
  for (int a = 0; a < MD_UNITS; ++a) {
    const int lu = (int)(u0 - r0 * nv) + threadIdx.x + a * MD_THREADS;
    const int rr = lu / nv;
    val[a] = V{};
    if (u0 + threadIdx.x + a * MD_THREADS < total) {
      const long src = src_s[rr];
      if (src >= 0) val[a] = x[src * nv + (lu - rr * nv)];
    }
  }
#pragma unroll
  for (int a = 0; a < MD_UNITS; ++a) {
    const long u = u0 + threadIdx.x + a * MD_THREADS;
    if (u < total) out[u] = val[a];
  }
}

// Lane loads of V values of T at p (16 bytes where V > 1) as fp32.
template <typename T, int V>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&f)[V]) {
  if constexpr (V > 1) {
    static_assert(V * sizeof(T) == 16, "one 16-byte load a lane");
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_float(e[i]);
  } else {
    f[0] = to_float(__ldg(p));
  }
}

// Grid (G g tokens, column spans / MC_WARPS): warp w of block (t, y)
// takes span y MC_WARPS + w of token t. K > 0: k == K at compile time;
// K == 0: any k <= MC_MAX_K.
template <typename T, int V, int K>
__global__ void __launch_bounds__(MC_THREADS)
moe_combine_kernel(const int* __restrict__ slot,
                   const float* __restrict__ gates, const T* __restrict__ eo,
                   float* __restrict__ out, int g, int k, int EC, int d,
                   int spans) {
  if constexpr (K > 0) k = K;
  const int span = blockIdx.y * MC_WARPS + threadIdx.x / 32;
  if (span >= spans) return;                   // the whole warp
  const int lane = threadIdx.x % 32;
  const long tok = blockIdx.x;                 // flat (group, token)
  const int c = span * 32 * V + lane * V;
  // K: every lane loads the token's K ids and gates itself (the launcher
  // takes this path only where both tables are 16-byte aligned); else
  // lane j < k loads choice j's and the warp shuffles them out
  int my_slot = -1, ids[K > 0 ? K : 1];
  float my_gate = 0.f, gts[K > 0 ? K : 1];
  if constexpr (K > 0) {
    static_assert(K % 4 == 0 && K <= MC_GROUP, "one group of 16-byte loads");
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      const int4 s4 =
          __ldg(reinterpret_cast<const int4*>(slot + tok * K + i));
      const float4 g4 =
          __ldg(reinterpret_cast<const float4*>(gates + tok * K + i));
      ids[i] = s4.x; ids[i + 1] = s4.y; ids[i + 2] = s4.z; ids[i + 3] = s4.w;
      gts[i] = g4.x; gts[i + 1] = g4.y; gts[i + 2] = g4.z; gts[i + 3] = g4.w;
    }
  } else if (lane < k) {
    my_slot = __ldg(&slot[tok * k + lane]);
    my_gate = __ldg(&gates[tok * k + lane]);
  }
  const bool live = c < d;
  const T* base = eo + (long)(blockIdx.x / g) * EC * d + c;
  float acc[V] = {};
  for (int j0 = 0; j0 < k; j0 += MC_GROUP) {
    float v[MC_GROUP][V], gate[MC_GROUP];
    bool use[MC_GROUP];
#pragma unroll
    for (int i = 0; i < MC_GROUP; ++i) {
      const int j = j0 + i;
      int s;
      if constexpr (K > 0) {
        s = ids[i];
        gate[i] = gts[i];
      } else {
        s = __shfl_sync(0xffffffffu, my_slot, j % 32);
        gate[i] = __shfl_sync(0xffffffffu, my_gate, j % 32);
      }
      use[i] = j < k && s >= 0 && s < EC;
      if (use[i] && live) load_row<T, V>(base + (long)s * d, v[i]);
    }
#pragma unroll
    for (int i = 0; i < MC_GROUP; ++i)
      if (use[i] && live)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] += gate[i] * v[i][e];
  }
  if (!live) return;
  float* o = out + tok * d + c;
  if constexpr (V > 1) {
#pragma unroll
    for (int e = 0; e < V; e += 4)
      *reinterpret_cast<float4*>(o + e) =
          make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
  } else {
    o[0] = acc[0];
  }
}

template <typename V>
static int launch_dispatch(const void* idx, const void* x, void* out,
                           long rows, int EC, int g, int nv,
                           cudaStream_t st) {
  const unsigned blocks =
      static_cast<unsigned>((rows * nv + MD_CHUNK - 1) / MD_CHUNK);
  moe_dispatch_kernel<V><<<blocks, MD_THREADS, 0, st>>>(
      static_cast<const int*>(idx), static_cast<const V*>(x),
      static_cast<V*>(out), rows, EC, g, nv);
  return static_cast<int>(cudaGetLastError());
}

// idx: (G, E, C) int32, -1 empty; x: (G, g, d) of elem_bytes 4 (fp32) or 2
// (bf16); out: (G, E, C, d) like x. Returns cudaGetLastError().
extern "C" int moe_dispatch(const void* idx, const void* x, void* out, int G,
                            int E, int C, int g, int d, int elem_bytes,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes != 4 && elem_bytes != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long rows = (long)G * E * C;
  const long row_bytes = (long)d * elem_bytes;
  if (row_bytes % 16 == 0 && aligned(x, 16) && aligned(out, 16))
    return launch_dispatch<uint4>(idx, x, out, rows, E * C, g,
                                  static_cast<int>(row_bytes / 16), st);
  if (row_bytes % 4 == 0 && aligned(x, 4) && aligned(out, 4))
    return launch_dispatch<uint32_t>(idx, x, out, rows, E * C, g,
                                     static_cast<int>(row_bytes / 4), st);
  return launch_dispatch<uint16_t>(idx, x, out, rows, E * C, g,
                                   static_cast<int>(row_bytes / 2), st);
}

template <typename T, int V>
static int launch_combine(const int* slot, const float* gates, const void* eo,
                          float* out, int G, int g, int k, int EC, int d,
                          cudaStream_t st) {
  const int spans = (d + 32 * V - 1) / (32 * V);
  const dim3 grid(static_cast<unsigned>((long)G * g),
                  (spans + MC_WARPS - 1) / MC_WARPS);
  const T* e = static_cast<const T*>(eo);
  if (k == 8 && aligned(slot, 16) && aligned(gates, 16))
    moe_combine_kernel<T, V, 8><<<grid, MC_THREADS, 0, st>>>(
        slot, gates, e, out, g, k, EC, d, spans);
  else
    moe_combine_kernel<T, V, 0><<<grid, MC_THREADS, 0, st>>>(
        slot, gates, e, out, g, k, EC, d, spans);
  return static_cast<int>(cudaGetLastError());
}

// slot: (G, g, k) int32 flat E*C slot ids, -1 dropped; gates: (G, g, k)
// fp32; eo: (G, E*C, d) in dtype F32 or BF16; out: (G, g, d) fp32;
// k <= MC_MAX_K. Returns cudaGetLastError().
extern "C" int moe_combine(const void* slot, const void* gates,
                           const void* eo, void* out, int G, int g, int k,
                           int EC, int d, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k > MC_MAX_K || (dtype != F32 && dtype != BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* s = static_cast<const int*>(slot);
  const float* gt = static_cast<const float*>(gates);
  float* o = static_cast<float*>(out);
  const int elem = dtype == F32 ? 4 : 2;
  // 16-byte lanes: every eo row and out row (d fp32) 16-byte aligned
  const bool vec = (long)d * elem % 16 == 0 && d % 4 == 0 &&
                   aligned(eo, 16) && aligned(out, 16);
  if (dtype == F32)
    return vec ? launch_combine<float, 4>(s, gt, eo, o, G, g, k, EC, d, st)
               : launch_combine<float, 1>(s, gt, eo, o, G, g, k, EC, d, st);
  return vec
      ? launch_combine<__nv_bfloat16, 8>(s, gt, eo, o, G, g, k, EC, d, st)
      : launch_combine<__nv_bfloat16, 1>(s, gt, eo, o, G, g, k, EC, d, st);
}
