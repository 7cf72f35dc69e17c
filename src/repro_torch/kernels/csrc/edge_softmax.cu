// Per-destination softmax over incoming edges (GAT attention) for Hopper
// (sm_90a), float32 throughout.
//
// Replaces the TPU kernel `edge_softmax_pallas` (`_softmax_stats_kernel` and
// `_softmax_norm_kernel`) in src/repro/kernels/segment_spmm.py. Semantics are
// those of `edge_softmax_ref` (src/repro/kernels/ref.py): for each batch row
// b, edge e and head h, with s' = em > 0 ? s : -FLT_MAX (finfo.min),
//
//   m[b, d, h]   = max over the real edges into d of s          (-FLT_MAX if none)
//   m_safe       = m > -FLT_MAX ? m : 0
//   p[b, e, h]   = exp(s' - m_safe[dst_e]) * em
//   den[b, d, h] = sum over the edges into d of p
//   att[b, e, h] = p / max(den[dst_e], FLT_MIN)
//
// The TPU kernel walks edge tiles in order and keeps a running (max,
// denominator) per destination in the revisited output block, rescaling the
// denominator whenever the max grows. Hopper blocks run in no order, so this
// is three passes over the edges with per-(b, dst, head) scratch, in one C
// call of four launches:
//
//   * Init: the max scratch to the encoding of -FLT_MAX, the denominator to 0.
//   * Max: atomicMax on an order-preserving unsigned encoding of the float
//     (sign-flipped for negatives, so unsigned order is float order). Masked
//     edges are skipped. A positive NaN encodes above every number and wins,
//     so it is never dropped as fmaxf would drop it; m_safe then reads 0, as
//     the reference's `m > finfo.min` test does, and the NaN reaches the
//     denominator and every weight of its destination.
//   * Exp: p written to the output, atomicAdd of p into the denominator.
//   * Normalize: every edge, masked ones too, divided by max(den, FLT_MIN),
//     taken so that a NaN denominator stays NaN, as clamp_min keeps it.
//
// One thread per (b, e, h), heads fastest, so the reads of scores, the writes
// of the output and the atomics of neighbouring heads are coalesced.
//
// What bounds it on the H100: launches. At the GAT full bin (B=1, E=6656,
// H=4, N=4096) it moves about 0.27 MB, 0.08 us at 3.35 TB/s, and each pass
// is one short wave of 26,624 threads; the four launches and their gaps are
// the time. Fusing the passes would need a grid-wide barrier or a
// destination-sorted CSR built at staging; that is later work.
//
// Tolerance: the denominator is summed with atomics in an order that changes
// from run to run, and expf is not the CPU's exp, so the weights agree with
// the plain version to about 1e-7 relative; masked edges and empty
// destinations are exact zeros.
//
// Edges whose destination falls outside [0, N) get weight 0 and touch no
// scratch; the packed layout never produces one.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned int encode(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float decode(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

struct Args {
  const float* scores;  // [B, E, H]
  const int* dst;       // [B, E]
  const float* em;      // [B, E]
  float* out;           // [B, E, H]
  unsigned int* mx;     // [B, N, H] scratch
  float* den;           // [B, N, H] scratch
  int b, e, h, n;
};

// The (b, e, h) of flat index idx, and the scratch slot of its destination
// (-1 when the destination is out of range).
struct Slot {
  long long edge;  // b * E + e
  long long node;  // (b * N + dst) * H + h, or -1
};

__device__ __forceinline__ Slot slot_of(const Args& a, long long idx) {
  const long long edge = idx / a.h;
  const int head = static_cast<int>(idx - edge * a.h);
  const long long bi = edge / a.e;
  const int d = a.dst[edge];
  Slot s{edge, -1};
  if (d >= 0 && d < a.n) s.node = (bi * a.n + d) * a.h + head;
  return s;
}

__global__ void __launch_bounds__(kThreads) init_kernel(Args a, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const unsigned int lowest = encode(-FLT_MAX);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    a.mx[i] = lowest;
    a.den[i] = 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads) max_kernel(Args a, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const Slot s = slot_of(a, i);
    if (s.node < 0 || !(a.em[s.edge] > 0.0f)) continue;
    atomicMax(&a.mx[s.node], encode(a.scores[i]));
  }
}

__global__ void __launch_bounds__(kThreads) exp_kernel(Args a, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const Slot s = slot_of(a, i);
    if (s.node < 0) {
      a.out[i] = 0.0f;
      continue;
    }
    const float w = a.em[s.edge];
    const bool live = w > 0.0f;
    const float m = decode(a.mx[s.node]);
    const float m_safe = m > -FLT_MAX ? m : 0.0f;   // NaN and empty read 0
    const float sc = live ? a.scores[i] : -FLT_MAX;  // masked before the exp
    const float p = expf(sc - m_safe) * w;
    a.out[i] = p;
    if (live) atomicAdd(&a.den[s.node], p);
  }
}

__global__ void __launch_bounds__(kThreads) normalize_kernel(Args a, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const Slot s = slot_of(a, i);
    if (s.node < 0) continue;
    const float d = a.den[s.node];
    a.out[i] = a.out[i] / (d < FLT_MIN ? FLT_MIN : d);  // keeps a NaN
  }
}

unsigned blocks_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride covers the rest
  return static_cast<unsigned>(blocks);
}

}  // namespace

extern "C" {

// att [B, E, H] = the per-destination softmax of scores over the real edges
// (see the top of this file). mx and den are caller-allocated scratch of
// B * N * H elements each (any contents). Four launches on `stream`; returns
// the cudaError_t of the first one that failed, else 0.
int edge_softmax(const float* scores, const int* dst, const float* em,
                 float* out, unsigned int* mx, float* den, int b, int e, int h,
                 int n, void* stream) {
  if (b <= 0 || e <= 0 || h <= 0) return 0;
  Args a{scores, dst, em, out, mx, den, b, e, h, n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long edges = static_cast<long long>(b) * e * h;
  const long long nodes = static_cast<long long>(b) * n * h;
  cudaError_t rc;
  if (nodes > 0) {
    init_kernel<<<blocks_for(nodes), kThreads, 0, st>>>(a, nodes);
    if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  }
  max_kernel<<<blocks_for(edges), kThreads, 0, st>>>(a, edges);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  exp_kernel<<<blocks_for(edges), kThreads, 0, st>>>(a, edges);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  normalize_kernel<<<blocks_for(edges), kThreads, 0, st>>>(a, edges);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
