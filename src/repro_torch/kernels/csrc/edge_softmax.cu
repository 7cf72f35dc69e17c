// Per-destination softmax over incoming edges (GAT attention) for Hopper
// (sm_90a), float32 throughout, over a destination-sorted CSR.
//
// Replaces the TPU kernel `edge_softmax_pallas` (`_softmax_stats_kernel` and
// `_softmax_norm_kernel`) in src/repro/kernels/segment_spmm.py. Semantics are
// those of `edge_softmax_ref` (src/repro_torch/kernels/ref.py): for each batch
// row b, edge e and head h, with s' = em > 0 ? s : -FLT_MAX (finfo.min),
//
//   m[b, d, h]   = max over the live edges into d of s     (-FLT_MAX if none)
//   m_safe       = m > -FLT_MAX ? m : 0                    (NaN and empty: 0)
//   p[b, e, h]   = exp(s' - m_safe[dst_e]) * em
//   den[b, d, h] = sum over the edges into d of p
//   att[b, e, h] = p / max(den[dst_e], FLT_MIN)          (a NaN den kept)
//
// An edge whose destination falls outside [0, N) gets 0. A NaN score of a
// live edge poisons every weight of its destination and head, the masked
// ones too (its p, then den, is NaN); masked weights are exact zeros
// otherwise.
//
// The TPU kernel walks edge tiles in order and keeps a running (max,
// denominator) per destination in a revisited output block. Hopper blocks
// run in no order; here the edges come sorted by destination (dst_csr.cuh:
// the CSR of dst alone, built once a bin and shared by the bin's layers and
// by gat_aggregate.cu), so one launch does it all, with no scratch and no
// atomic on a float:
//
//   * A thread a (destination, head) whose segment has at most kShort
//     entries loads them all at once into registers (the H threads of a
//     destination are neighbours, so their loads of an edge's scores are
//     one run), takes the max, the denominator in ascending edge order
//     from +0 (each p rounded before it is added: the plain version's
//     index_add_ order) and writes every weight of the segment.
//   * A longer segment (the padding pile at node 0, 562 entries at the GAT
//     full bin; hubs) goes to a twin block, one a block of destinations,
//     which runs beside the short rows: its threads take the entries
//     (thread t: entries t, t + 256, ..., the first kLongPer kept in
//     registers), each reads its entries for the max and the denominator
//     (in its entries' order) and writes the weights; the threads meet in
//     a fixed tree (a warp's lane i adds lane i + 16, 8, 4, 2, 1; then the
//     warps' sums in warp order), once for the max and once for the sum.
//   * The short rows' threads, by edge index, write 0 to every edge
//     outside [0, N), the edges in no segment.
//   Every weight is written once, and the sums are the same bits from run
//   to run. A masked edge's p and weight take no exp and no division (the
//   division's slow path on a zero numerator slowed the padding pile),
//   with the same bits as the full expression.
//
// What bounds it on the H100: latency. At the GAT full bin (B = 1,
// E = 6656, H = 4, N = 4096) it moves about 0.27 MB, 0.08 us at 3.35 TB/s;
// a thread's chain is rowptr, perm, then its edges' scores and the store,
// and the pile's twin adds two block-wide meetings and the pile's loads.
//
// Tolerance: expf is not the CPU's exp (a few ulp), and a long segment adds
// its denominator in tree order, not index_add_'s; the weights agree with
// the plain version to about 1e-6 relative. The tests and chip_smoke.py hold
// them to 1e-4 absolute + 1e-4 relative; masked edges and empty
// destinations are exact zeros.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeads = 4;    // heads a worker takes
constexpr int kShort = 8;    // entries a thread takes alone, in registers
constexpr int kLongPer = 4;  // entries a thread of a long row keeps
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* scores;  // [B, E, H]
  const int* dst;       // [B, E]
  const float* em;      // [B, E]
  const int* rowptr;    // [B, N + 1] (dst_csr.cuh, of dst alone)
  const int* perm;      // [B, E]
  float* out;           // [B, E, H]
  int e, h, n;
};

// The max in which a NaN wins, as the plain version's amax keeps it.
__device__ __forceinline__ float max_nan(float m, float v) {
  return (v > m || v != v) ? v : m;
}
__device__ __forceinline__ float safe_max(float m) {
  return m > -FLT_MAX ? m : 0.0f;   // NaN and empty read 0
}
// p of a score s whose edge has weight w, under m_safe ms. A weight of
// +-0 gives +-0 at once: the exp is then of s' - m_safe <= 0, in [0, 1].
__device__ __forceinline__ float p_of(float s, float w, float ms) {
  if (w == 0.0f) return 0.0f * w;
  const float sc = w > 0.0f ? s : -FLT_MAX;   // masked before the exp
  return __fmul_rn(expf(__fsub_rn(sc, ms)), w);
}
// max(den, FLT_MIN), keeping a NaN as clamp_min does
__device__ __forceinline__ float floor_den(float d) {
  return d < FLT_MIN ? FLT_MIN : d;
}
// p / den for a floored den; a zero p (every masked edge) is its own
// quotient unless den is NaN, which keeps __fdiv_rn off its slow path
__device__ __forceinline__ float weight(float p, float den) {
  return p == 0.0f && den == den ? p : __fdiv_rn(p, den);
}

// A destination's segment of at most kShort entries, head x, by one
// thread (the H threads of a destination are neighbours, so its score and
// weight loads are one run).
__device__ __forceinline__ void short_row(const Args& a, long long row0,
                                          int k0, int cnt, int x) {
  long long at[kShort];
  float w[kShort], v[kShort];
#pragma unroll
  for (int j = 0; j < kShort; ++j)
    at[j] = j < cnt ? row0 + __ldg(a.perm + row0 + k0 + j) : 0;
#pragma unroll
  for (int j = 0; j < kShort; ++j) {
    w[j] = j < cnt ? __ldg(a.em + at[j]) : 0.0f;
    v[j] = j < cnt ? __ldg(a.scores + at[j] * a.h + x) : 0.0f;
  }
  float m = -FLT_MAX;
#pragma unroll
  for (int j = 0; j < kShort; ++j)
    if (j < cnt && w[j] > 0.0f) m = max_nan(m, v[j]);
  const float ms = safe_max(m);
  float den = 0.0f;
#pragma unroll
  for (int j = 0; j < kShort; ++j) {
    if (j < cnt) {
      v[j] = p_of(v[j], w[j], ms);
      den = __fadd_rn(den, v[j]);
    }
  }
  den = floor_den(den);
#pragma unroll
  for (int j = 0; j < kShort; ++j)
    if (j < cnt) a.out[at[j] * a.h + x] = weight(v[j], den);
}

// Every thread's value, met in a fixed tree: in each warp lane i adds lane
// i + 16, then 8, 4, 2, 1 (max_nan for the max, __fadd_rn for the sum);
// then every thread adds the warps' results in warp order from `init`.
template <bool kMax>
__device__ __forceinline__ void block_meet(float (&x)[kHeads], float init,
                                           float (&red)[kWarps][kHeads]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < kHeads; ++c) {
      const float y = __shfl_down_sync(kFull, x[c], off);
      x[c] = kMax ? max_nan(x[c], y) : __fadd_rn(x[c], y);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kHeads; ++c) red[warp][c] = x[c];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kHeads; ++c) {
    float t = init;
    for (int w = 0; w < kWarps; ++w)
      t = kMax ? max_nan(t, red[w][c]) : __fadd_rn(t, red[w][c]);
    x[c] = t;
  }
  __syncthreads();   // red is free again
}

// A destination's longer segment, heads h0 .. h0 + kHeads - 1, by the
// whole block: thread t takes entries k0 + t, k0 + t + kThreads, ..., the
// first kLongPer of them loaded at once and kept in registers (a segment
// of up to kLongPer * kThreads entries is read once), the rest read again
// for each pass.
__device__ void long_row(const Args& a, long long row0, int k0, int cnt,
                         int h0, float (&red)[kWarps][kHeads]) {
  const int tid = threadIdx.x;
  auto load = [&](int k, float& w, float (&v)[kHeads]) {
    const long long be = row0 + __ldg(a.perm + row0 + k0 + k);
    w = __ldg(a.em + be);
#pragma unroll
    for (int x = 0; x < kHeads; ++x)
      v[x] = h0 + x < a.h ? __ldg(a.scores + be * a.h + h0 + x) : 0.0f;
    return be;
  };
  long long at[kLongPer];
  float cw[kLongPer], cv[kLongPer][kHeads];
#pragma unroll
  for (int i = 0; i < kLongPer; ++i) {
    const int k = tid + i * kThreads;
    cw[i] = 0.0f;
    at[i] = k < cnt ? load(k, cw[i], cv[i]) : 0;
  }
  const int rest = kLongPer * kThreads;
  float m[kHeads];
#pragma unroll
  for (int x = 0; x < kHeads; ++x) {
    m[x] = -FLT_MAX;
#pragma unroll
    for (int i = 0; i < kLongPer; ++i)
      if (tid + i * kThreads < cnt && cw[i] > 0.0f)
        m[x] = max_nan(m[x], cv[i][x]);
  }
  for (int k = rest + tid; k < cnt; k += kThreads) {
    float w, v[kHeads];
    load(k, w, v);
    if (w > 0.0f) {
#pragma unroll
      for (int x = 0; x < kHeads; ++x) m[x] = max_nan(m[x], v[x]);
    }
  }
  block_meet<true>(m, -FLT_MAX, red);
  float den[kHeads];
#pragma unroll
  for (int x = 0; x < kHeads; ++x) {
    m[x] = safe_max(m[x]);
    den[x] = 0.0f;
#pragma unroll
    for (int i = 0; i < kLongPer; ++i) {
      if (tid + i * kThreads < cnt) {
        cv[i][x] = p_of(cv[i][x], cw[i], m[x]);
        den[x] = __fadd_rn(den[x], cv[i][x]);
      }
    }
  }
  for (int k = rest + tid; k < cnt; k += kThreads) {
    float w, v[kHeads];
    load(k, w, v);
#pragma unroll
    for (int x = 0; x < kHeads; ++x)
      den[x] = __fadd_rn(den[x], p_of(v[x], w, m[x]));
  }
  block_meet<false>(den, 0.0f, red);
#pragma unroll
  for (int x = 0; x < kHeads; ++x) {
    den[x] = floor_den(den[x]);
    if (h0 + x >= a.h) continue;
#pragma unroll
    for (int i = 0; i < kLongPer; ++i)
      if (tid + i * kThreads < cnt)
        a.out[at[i] * a.h + h0 + x] = weight(cv[i][x], den[x]);
  }
  for (int k = rest + tid; k < cnt; k += kThreads) {
    float w, v[kHeads];
    const long long be = load(k, w, v);
#pragma unroll
    for (int x = 0; x < kHeads; ++x)
      if (h0 + x < a.h)
        a.out[be * a.h + h0 + x] = weight(p_of(v[x], w, m[x]), den[x]);
  }
}

// Blocks (x, b) of batch row b, x < `half`: thread t is worker w = x *
// kThreads + t, head w % H of destination w / H when that destination's
// segment is short, and edge w's zero if that edge is in no segment.
// Blocks x >= half are their twins: each takes the long segments of the
// destinations its twin covers, one after another, with all its threads,
// while the short rows run beside it.
__global__ void __launch_bounds__(kThreads) softmax_kernel(Args a, int half) {
  __shared__ int longs[kThreads];
  __shared__ int n_long;
  __shared__ float red[kWarps][kHeads];
  const int bi = blockIdx.y, tid = threadIdx.x;
  const bool twin = static_cast<int>(blockIdx.x) >= half;
  const long long w =
      static_cast<long long>(blockIdx.x - (twin ? half : 0)) * kThreads + tid;
  const long long row0 = static_cast<long long>(bi) * a.e;
  const int* rp = a.rowptr + static_cast<long long>(bi) * (a.n + 1);
  const bool mine = w < static_cast<long long>(a.n) * a.h;
  const int d = mine ? static_cast<int>(w / a.h) : 0;
  const int k0 = mine ? __ldg(rp + d) : 0;
  const int cnt = mine ? __ldg(rp + d + 1) - k0 : 0;
  if (!twin) {
    if (w < a.e) {
      const int t = __ldg(a.dst + row0 + w);
      if (t < 0 || t >= a.n)
        for (int x = 0; x < a.h; ++x) a.out[(row0 + w) * a.h + x] = 0.0f;
    }
    if (mine && cnt <= kShort)
      short_row(a, row0, k0, cnt, static_cast<int>(w % a.h));
    return;
  }
  if (tid == 0) n_long = 0;
  __syncthreads();
  if (mine && cnt > kShort && w % a.h == 0)
    longs[atomicAdd(&n_long, 1)] = d;   // an integer slot of the list
  __syncthreads();
  const int total = n_long;   // the same in every thread: whole-block loop
  for (int i = 0; i < total; ++i) {
    const int dl = longs[i];
    const int kl = __ldg(rp + dl), cl = __ldg(rp + dl + 1) - kl;
    for (int h0 = 0; h0 < a.h; h0 += kHeads)
      long_row(a, row0, kl, cl, h0, red);
  }
}

}  // namespace

extern "C" {

// att [B, E, H] = the per-destination softmax of scores over the live edges
// (see the top of this file), one launch on `stream` over the CSR of dst
// alone (rowptr [B, N + 1], perm [B, E]: dst_csr in segment_aggregate.cu).
// Every element of out is written. Returns the cudaError_t of the launch.
int edge_softmax(const float* scores, const int* dst, const float* em,
                 const int* rowptr, const int* perm, float* out, int b, int e,
                 int h, int n, void* stream) {
  if (b <= 0 || e <= 0 || h <= 0) return 0;
  if (b > 65535 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{scores, dst, em, rowptr, perm, out, e, h, n};
  const long long workers = static_cast<long long>(n) * h;
  const long long span = workers > e ? workers : e;
  const long long half = (span + kThreads - 1) / kThreads;
  const long long twins = (workers + kThreads - 1) / kThreads;
  if (half + twins > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(half + twins), b);
  softmax_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<int>(half));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
