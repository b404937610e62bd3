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
//   K5b: one block of 256 threads per (token, 256 columns of d). The block
//        stages the token's k slot ids and gates in shared memory; each
//        thread accumulates its column over the k rows in a fixed order in
//        an fp32 register. Neighbouring threads read neighbouring columns
//        of a row (coalesced), and there are no atomics, so two runs give
//        the same bits.
// Ids outside their range (token ids outside [0, g), slot ids outside
// [0, E * C)) count as empty or dropped, so a bad id never reads outside
// its group.
#include "attention_common.cuh"

constexpr int MD_THREADS = 256;
constexpr int MD_UNITS = 2;                   // copy units per thread
constexpr int MD_CHUNK = MD_THREADS * MD_UNITS;   // units per block
constexpr int MC_THREADS = 256;               // columns per block
constexpr int MC_MAX_K = 32;                  // ops.py checks k <= this

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

template <typename T>
__global__ void __launch_bounds__(MC_THREADS)
moe_combine_kernel(const int* __restrict__ slot,
                   const float* __restrict__ gates, const T* __restrict__ eo,
                   float* __restrict__ out, int g, int k, int EC, int d) {
  __shared__ int s_slot[MC_MAX_K];
  __shared__ float s_gate[MC_MAX_K];
  const long tok = blockIdx.x;                 // flat (group, token)
  if (threadIdx.x < k) {
    const int s = slot[tok * k + threadIdx.x];
    s_slot[threadIdx.x] = (s >= 0 && s < EC) ? s : -1;
    s_gate[threadIdx.x] = gates[tok * k + threadIdx.x];
  }
  __syncthreads();
  const int c = blockIdx.y * MC_THREADS + threadIdx.x;
  if (c >= d) return;
  const T* base = eo + (tok / g) * (long)EC * d + c;
  float acc = 0.f;
#pragma unroll 8
  for (int j = 0; j < k; ++j) {
    const int s = s_slot[j];
    if (s >= 0) acc += s_gate[j] * to_float(base[(long)s * d]);
  }
  out[tok * d + c] = acc;
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

// slot: (G, g, k) int32 flat E*C slot ids, -1 dropped; gates: (G, g, k)
// fp32; eo: (G, E*C, d) in dtype F32 or BF16; out: (G, g, d) fp32;
// k <= MC_MAX_K. Returns cudaGetLastError().
extern "C" int moe_combine(const void* slot, const void* gates,
                           const void* eo, void* out, int G, int g, int k,
                           int EC, int d, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k > MC_MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((long)G * g),
                  (d + MC_THREADS - 1) / MC_THREADS);
  const int* s = static_cast<const int*>(slot);
  const float* gt = static_cast<const float*>(gates);
  float* o = static_cast<float*>(out);
  if (dtype == F32)
    moe_combine_kernel<float><<<grid, MC_THREADS, 0, st>>>(
        s, gt, static_cast<const float*>(eo), o, g, k, EC, d);
  else if (dtype == BF16)
    moe_combine_kernel<__nv_bfloat16><<<grid, MC_THREADS, 0, st>>>(
        s, gt, static_cast<const __nv_bfloat16*>(eo), o, g, k, EC, d);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
