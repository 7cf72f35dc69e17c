// Segmented sums over a destination-sorted CSR, and a weighted row gather,
// for Hopper (sm_90a), float32 throughout.
//
// Replaces the TPU kernels `segment_aggregate_pallas` (`_seg_gather_kernel`,
// then `_seg_scatter_kernel` through `_scatter_with_degree`) and
// `segment_scatter_pallas` (`_seg_scatter_kernel` alone) in
// src/repro/kernels/segment_spmm.py. Semantics are those of
// `segment_aggregate_ref`, `segment_scatter_ref` and `segment_gather_ref`
// (src/repro_torch/kernels/ref.py), over [B, E] edge lists and [B, N, F]
// node rows:
//
//   segment_scatter:  out[b, d] = sum_{e: dst_e = d} em[b, e] * m[b, e]
//                     deg[b, d] = sum_{e: dst_e = d} em[b, e]
//                     mean:  out[b, d] /= max(deg[b, d], 1)
//     with m[b, e] = h[b, src_e] (segment_aggregate, B5) or msgs[b, e]
//     (segment_scatter, B6).
//   segment_gather:   out[b, e] = w[b, e] * h[b, idx_e]
//
// The TPU kernel gathers every edge's message into a [B, E, F] array with a
// one-hot matmul, then scatters it with a second one-hot matmul into node
// tiles it revisits in order. Hopper's blocks run in no order, so here the
// edges are first sorted by destination (dst_csr.cuh, one launch), and then
// one warp (or thread) owns each output row (a second launch): it reads the
// row's messages in ascending edge order, h[src] straight from h for an
// aggregate, so the [B, E, F] messages never reach device memory, and
// writes the row, its degree and its mean once. No float atomic, no
// zero-fill of the output, no launch for the mean, and the sums are the
// same bits from run to run.
//
// The sum's three routes, which segment_spmm.segment_plan picks from the
// shapes (F, its alignment):
//   wide_vec, wide_scalar (F > 8): a warp a destination's column tile,
//     lanes along the features, V float4s (wide_vec: F a multiple of 4 on
//     16-byte aligned rows) or V floats a lane, V in {1, 2, 4, 8}; each
//     lane's loads of kWideWords 32-bit words are issued before the first
//     of them is added.
//   narrow (F <= 8: GAT's per-head scores, degrees, the readout's counts):
//     a thread a destination, its row in registers, kInFlight edges' loads
//     in flight. A warp of lanes along 4 features would leave most lanes
//     idle; a thread a row writes a warp's 32 rows as one run.
// Every route adds a row's edges in ascending edge order, each term w * v
// rounded and then added (__fmul_rn, __fadd_rn: no FMA contraction), from
// +0: a row's sum is the plain version's sequential sum, bit for bit.
// A segment longer than the route's chunk (kWideChunk or kNarrowChunk
// edges: a high in-degree node, the padded edges of a batch row, which all
// sit at (0, 0), or a graph of the packed readout's backward) is summed in
// pieces (seg_chunks.cuh, shared with gat_aggregate.cu): the batch row's
// entries are cut into windows of `chunk`, and a warp takes a window's
// pieces of such segments (at most two). On the wide routes it does so per
// 32-unit column slice, one unit a lane and
// kChunkInFlight edges in flight; on the narrow route its lanes take the
// piece's entries, one each, and meet in a fixed shuffle tree (lane i adds
// lane i + 16, then i + 8, 4, 2, 1). Each warp writes its piece's partial
// sum and degree to scratch and counts its arrival on an integer counter:
// the last of each group of kGroup chunks adds the group's partials in
// window order, ((0 + p0) + p1) + ..., and the last group adds the groups'
// sums in order and writes the row. The order is fixed whatever order the
// warps run in, and no warp reads more than kGroup partials of a level.
//
// Masking and NaN: every edge with both endpoints in [0, N) is in its
// segment whatever its weight, so NaN * 0 of a masked edge reaches its
// destination exactly as in the plain versions (adding w * v = +-0 of a
// finite message changes no sum). The division takes max(deg, 1) as
// `deg < 1 ? 1 : deg` so that a NaN degree stays NaN, as clamp_min keeps it.
// Edges whose endpoints fall outside [0, N) are in no segment (the gather
// reads 0 for them); the batch layouts never produce one.
//
// What bounds the sum on the H100: bytes, each message row read once and
// each output row written once; at the packed training step (B=1, E=8192,
// F=512) 33.6 MB, 10.0 us at 3.35 TB/s. The build is latency-bound and
// about half of a call there; a long segment adds its chunks' and its
// combine's latency.
//
// The gather (the TPU's `_seg_gather_kernel`, a one-hot matmul per edge
// tile) is bound by bytes: it reads B*E rows of h and writes them once,
// 33.6 MB at the packed step, 10.0 us at 3.35 TB/s. A warp takes kRows rows
// a step, V units a lane a row (float4s, or floats when F is not a
// multiple of 4; kRows * V = 8, so F = 512 is V = 4, kRows = 2): lane r <
// kRows reads row r's index and weight and computes its offsets, which the
// warp passes round with __shfl_sync, and all of a step's row loads are
// issued before its first store. V is a compile-time unroll; rows wider
// than 8 units a lane loop. The grid is sized from the SM count, asked once
// per device: a step a warp up to 8 blocks an SM, beyond which a warp's
// next step's loads are issued before this step's stores. Offsets are
// 32-bit unless B*N*F, B*E*F or the index view's extent need 64.
//
// Tolerance: a row of at most one chunk is the plain version's sum on the
// CPU bit for bit; a chunked segment's combine adds in another order, a
// float32 rounding apart. The tests and chip_smoke.py hold every route to
// 1e-4 absolute + 1e-4 relative against the plain version on the card
// (whose index_add_ adds with atomics), and two runs to the same bits.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

#include "dst_csr.cuh"
#include "seg_chunks.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kRowThreads = 256;    // eight warps a block
constexpr unsigned kFull = 0xffffffffu;

dim3 row_block() { return dim3(kWarp, kRowThreads / kWarp); }

using chunks::kGroup;
using chunks::ldcg;
using chunks::ldg;
using chunks::plus;
using chunks::term_add;
using chunks::zero_unit;
__device__ __forceinline__ float scaled(float v, float w) { return v * w; }
__device__ __forceinline__ float4 scaled(float4 v, float w) {
  return make_float4(v.x * w, v.y * w, v.z * w, v.w * w);
}

// Rows a warp gathers per step with V units a lane: 8 units a lane a step.
template <int V>
__host__ __device__ constexpr int gather_rows() {
  return V == 0 ? 1 : 8 / V;
}

// out[b, e] = w[b, e] * h[b, idx_e] (w null: weight 1); an index outside
// [0, N) gathers 0. Unit is float4 or float and F is counted in units; Off
// is int or long long. V units a lane per row (32 * V >= units): kRows rows
// a step, and a warp with more than one step issues the next step's loads
// before this step's stores. V = 0: any width, one row a step, four units a
// lane at a time.
template <int V, class Unit, class Off>
__global__ void __launch_bounds__(kRowThreads)
gather_kernel(const Unit* __restrict__ h, const int* __restrict__ idx,
              int idx_stride, const float* __restrict__ w,
              Unit* __restrict__ out, int b, int n, int e, int units) {
  constexpr int kRows = gather_rows<V>();
  const int lane = threadIdx.x;
  const Off rows = static_cast<Off>(b) * e;
  const Off step = static_cast<Off>(gridDim.x) * blockDim.y * kRows;
  // lane r < kRows reads row base + r's index and weight: its source
  // offset, its weight and its state (0: past the end, 1: gathers 0,
  // 2: live)
  auto meta = [&](Off base, Off& src, float& wt, int& state) {
    src = 0;
    wt = 1.0f;
    state = 0;
    if (lane < kRows && base + lane < rows) {
      const Off row = base + lane;
      const int s = idx[row * idx_stride];
      state = 1;
      if (s >= 0 && s < n) {
        state = 2;
        src = (static_cast<Off>(row / e) * n + s) * units;
      }
      if (w != nullptr) wt = w[row];
    }
  };
  Off base = (static_cast<Off>(blockIdx.x) * blockDim.y + threadIdx.y) * kRows;
  if (base >= rows) return;   // whole warps leave together
  Off src;
  float wt;
  int state;
  meta(base, src, wt, state);
  if constexpr (V == 0) {
    for (; base < rows; base += step) {
      const Off sr = __shfl_sync(0xffffffffu, src, 0);
      const float wr = __shfl_sync(0xffffffffu, wt, 0);
      const int st = __shfl_sync(0xffffffffu, state, 0);
      meta(base + step, src, wt, state);   // the next row's, in flight now
      Unit* o = out + base * units;
      for (int c0 = 0; c0 < units; c0 += 4 * kWarp) {
        Unit v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = c0 + lane + kWarp * u;
          v[u] = (st == 2 && c < units) ? h[sr + c] : zero_unit<Unit>();
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = c0 + lane + kWarp * u;
          if (c < units) o[c] = st == 2 ? scaled(v[u], wr) : zero_unit<Unit>();
        }
      }
    }
  } else {
    auto load = [&](Unit (&v)[kRows][V], Off src_r, int state_r) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const Off sr = __shfl_sync(0xffffffffu, src_r, r);
        const int st = __shfl_sync(0xffffffffu, state_r, r);
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const int c = lane + kWarp * u;
          v[r][u] = (st == 2 && c < units) ? h[sr + c] : zero_unit<Unit>();
        }
      }
    };
    Unit cur[kRows][V];
    load(cur, src, state);
    float wt_cur = wt;
    int state_cur = state;
    meta(base + step, src, wt, state);
    for (;;) {
      const Off next = base + step;
      Unit nxt[kRows][V];
      if (next < rows) load(nxt, src, state);   // in flight during the stores
      const float wt_next = wt;
      const int state_next = state;
      meta(next + step, src, wt, state);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float wr = __shfl_sync(0xffffffffu, wt_cur, r);
        const int st = __shfl_sync(0xffffffffu, state_cur, r);
        Unit* o = out + (base + r) * units;
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const int c = lane + kWarp * u;
          if (st != 0 && c < units)
            o[c] = st == 2 ? scaled(cur[r][u], wr) : zero_unit<Unit>();
        }
      }
      if (next >= rows) break;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int u = 0; u < V; ++u) cur[r][u] = nxt[r][u];
      wt_cur = wt_next;
      state_cur = state_next;
      base = next;
    }
  }
}

// The SM count of the current device, asked once per device.
int sm_count() {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) dev = 0;
  int sms = dev >= 0 && dev < kMaxDevices ? cached[dev].load() : 0;
  if (sms <= 0) {
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms <= 0)
      sms = 132;
    if (dev >= 0 && dev < kMaxDevices) cached[dev].store(sms);
  }
  return sms;
}

// Resident blocks of gather warps per SM the grid aims for; a grid-stride
// loop covers the rows beyond them.
constexpr int kGatherBlocksPerSm = 8;

template <int V, class Unit, class Off>
void launch_gather(const float* h, const int* idx, int idx_stride,
                   const float* w, float* out, int b, int n, int e, int units,
                   cudaStream_t s) {
  const long long rows = static_cast<long long>(b) * e;
  const long long per_block = (kRowThreads / kWarp) * gather_rows<V>();
  const long long blocks =
      std::min((rows + per_block - 1) / per_block,
               static_cast<long long>(sm_count()) * kGatherBlocksPerSm);
  gather_kernel<V, Unit, Off><<<static_cast<unsigned>(blocks), row_block(),
                                0, s>>>(
      reinterpret_cast<const Unit*>(h), idx, idx_stride, w,
      reinterpret_cast<Unit*>(out), b, n, e, units);
}

// V = the units a lane takes per row, rounded up to 1, 2, 4 or 8; 0 past 8.
template <class Unit, class Off>
void dispatch_gather(const float* h, const int* idx, int idx_stride,
                     const float* w, float* out, int b, int n, int e,
                     int units, cudaStream_t s) {
  const int per_lane = (units + kWarp - 1) / kWarp;
  if (per_lane <= 1) {
    launch_gather<1, Unit, Off>(h, idx, idx_stride, w, out, b, n, e, units, s);
  } else if (per_lane <= 2) {
    launch_gather<2, Unit, Off>(h, idx, idx_stride, w, out, b, n, e, units, s);
  } else if (per_lane <= 4) {
    launch_gather<4, Unit, Off>(h, idx, idx_stride, w, out, b, n, e, units, s);
  } else if (per_lane <= 8) {
    launch_gather<8, Unit, Off>(h, idx, idx_stride, w, out, b, n, e, units, s);
  } else {
    launch_gather<0, Unit, Off>(h, idx, idx_stride, w, out, b, n, e, units, s);
  }
}


// ---------------------------------------------------------------------------
// segmented sums over the CSR
// ---------------------------------------------------------------------------

// the sum's routes, numbered as segment_spmm.SEGMENT_ROUTES numbers them
constexpr int kNarrow = 0, kWideScalar = 1, kWideVec = 2;
constexpr int kWideChunk = 32;     // edges a warp sums on the wide routes
constexpr int kNarrowChunk = 16;   // edges a thread sums on the narrow route
constexpr int kNarrowF = 8;        // the narrow route's widest row
constexpr int kInFlight = 8;       // rows a narrow thread loads before it
                                   // adds
constexpr int kWideWords = 32;     // 32-bit words a wide lane does
constexpr int kChunkInFlight = 16; // rows in flight on a chunk's slice

struct SumArgs {
  const float* m;          // message rows: h [B*N, F] or msgs [B*E, F]
  const int* rowptr;       // [B, N + 1] (dst_csr.cuh)
  const int* csr_row;      // [B*E]
  const float* csr_w;      // [B*E]
  const int* csr_dst;      // [B*E]
  int* counters;           // [B*N, slices]: groups arrived, long segments
  int* group_counters;     // [B, cells, 2, slices]: chunks arrived, a
                           // group's first chunk's slot
  float* part;             // [B, cells, 2, F]: chunk sums
  float* dpart;            // [B, cells, 2, slices]: chunk degrees
  float* out;              // [B, N, F]
  float* deg;              // [B, N] or null
  int mean;
  int b, n, e, f, units;   // units: F / 4 float4s (wide_vec) or F floats
  int chunk, cells, slices;   // cells: ceil(E / chunk) windows a row
  int tiles;               // wide: column tiles a row, a warp each
  long long chunk_workers; // the grid's first warps (wide: B * cells *
                           // slices) or threads (narrow: 32 B * cells)
  // the destination of flat entry k (seg_chunks.cuh)
  __device__ int entry_dst(long long k) const { return __ldg(csr_dst + k); }
};

__device__ __forceinline__ float quot(float v, float d) {
  return __fdiv_rn(v, d);
}
__device__ __forceinline__ float4 quot(float4 v, float d) {
  return make_float4(__fdiv_rn(v.x, d), __fdiv_rn(v.y, d), __fdiv_rn(v.z, d),
                     __fdiv_rn(v.w, d));
}
// max(deg, 1), keeping a NaN as clamp_min does
__device__ __forceinline__ float divisor(float deg) {
  return deg < 1.0f ? 1.0f : deg;
}
// The sum over j < cnt, ascending, of the weights lane j holds.
__device__ __forceinline__ float weight_sum(float w, int cnt) {
  float d = 0.0f;
  for (int j = 0; j < cnt; ++j) d = __fadd_rn(d, __shfl_sync(kFull, w, j));
  return d;
}

// acc[u] += w_j * m[row_j, c0 + lane + 32 u] over the cnt <= 32 edges whose
// message row and weight lane j holds, in ascending j; the loads of kDepth
// edges are issued before the first of them is added.
template <class Unit, int V, int kDepth>
__device__ __forceinline__ void sum_rows(const Unit* __restrict__ m,
                                         int units, int c0, int cnt, int row,
                                         float w, Unit (&acc)[V]) {
  const int lane = threadIdx.x;
  for (int j0 = 0; j0 < cnt; j0 += kDepth) {
    Unit v[kDepth][V];
#pragma unroll
    for (int t = 0; t < kDepth; ++t) {
      const int j = j0 + t;
      const long long r =
          static_cast<long long>(__shfl_sync(kFull, row, j & 31)) * units;
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int c = c0 + lane + kWarp * u;
        v[t][u] = j < cnt && c < units ? ldg(m + r + c) : zero_unit<Unit>();
      }
    }
#pragma unroll
    for (int t = 0; t < kDepth; ++t) {
      const int j = j0 + t;
      const float wj = __shfl_sync(kFull, w, j & 31);
      if (j < cnt) {
#pragma unroll
        for (int u = 0; u < V; ++u) acc[u] = term_add(acc[u], wj, v[t][u]);
      }
    }
  }
}

// the window pieces of long segments and the order their partials meet in
using chunks::last_arrival;
using chunks::part_row;
using chunks::Piece;
using chunks::pieces_of;

// Output row r = b * N + d's entries; false when its segment is chunked.
__device__ __forceinline__ bool row_of(const SumArgs& a, long long r,
                                       long long& at, int& cnt) {
  const int bi = static_cast<int>(r / a.n);
  const int* rp = a.rowptr + r + bi;     // rowptr[b, d]: N + 1 a row
  const int k0 = __ldg(rp);
  cnt = __ldg(rp + 1) - k0;
  at = static_cast<long long>(bi) * a.e + k0;
  return cnt <= a.chunk;
}

// The row and weight of entry at + lane (lane < cnt), else row 0, weight 0.
__device__ __forceinline__ void entry(const SumArgs& a, long long at, int cnt,
                                      int& row, float& w) {
  const int lane = threadIdx.x;
  row = 0;
  w = 0.0f;
  if (lane < cnt) {
    row = __ldg(a.csr_row + at + lane);
    w = __ldg(a.csr_w + at + lane);
  }
}

// wide routes: one column tile (32 V units) of output row r; each lane's
// loads of kWideWords 32-bit words are issued before they are added
template <class Unit, int V>
__device__ void wide_row(const SumArgs& a, long long r, int tile) {
  constexpr int kWords = V * static_cast<int>(sizeof(Unit) / 4);
  constexpr int kDepth = kWords >= kWideWords ? 1 : kWideWords / kWords;
  long long at;
  int cnt;
  if (!row_of(a, r, at, cnt)) return;   // the chunk warps write it
  int row;
  float w;
  entry(a, at, cnt, row, w);
  const float deg = a.mean || a.deg != nullptr ? weight_sum(w, cnt) : 0.0f;
  const float div = divisor(deg);
  const int c0 = tile * kWarp * V;
  Unit acc[V];
#pragma unroll
  for (int u = 0; u < V; ++u) acc[u] = zero_unit<Unit>();
  sum_rows<Unit, V, kDepth>(reinterpret_cast<const Unit*>(a.m), a.units, c0,
                            cnt, row, w, acc);
  Unit* o = reinterpret_cast<Unit*>(a.out) + r * a.units;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int c = c0 + threadIdx.x + kWarp * u;
    if (c < a.units) o[c] = a.mean && div != 1.0f ? quot(acc[u], div) : acc[u];
  }
  if (a.deg != nullptr && tile == 0 && threadIdx.x == 0) a.deg[r] = deg;
}

// The sum, in order, of `count` partials of a segment starting at entry s
// (its chunks first, first + step, ...), column col of one slice, and of
// their degrees: ((0 + p0) + p1) + ...
template <class Unit>
__device__ __forceinline__ void add_partials(const SumArgs& a, int bi, int s,
                                             int first, int step, int count,
                                             int col, int slice, Unit& tot,
                                             float& dtot) {
  const Unit* part = reinterpret_cast<const Unit*>(a.part);
  tot = zero_unit<Unit>();
  dtot = 0.0f;
  for (int c0 = 0; c0 < count; c0 += kChunkInFlight) {
    Unit v[kChunkInFlight];
    float dv[kChunkInFlight];
#pragma unroll
    for (int c = 0; c < kChunkInFlight; ++c) {
      const bool ok = c0 + c < count;
      const long long p = ok ? part_row(a, bi, s, first + (c0 + c) * step)
                             : 0;
      v[c] = ok && col < a.units ? ldcg(part + p * a.units + col)
                                 : zero_unit<Unit>();
      dv[c] = ok ? ldcg(a.dpart + p * a.slices + slice) : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < kChunkInFlight; ++c) {
      if (c0 + c < count) {
        tot = plus(tot, v[c]);
        dtot = __fadd_rn(dtot, dv[c]);
      }
    }
  }
}

// wide routes: one 32-unit column slice of one window's pieces; the chunk
// that arrives last of its group of kGroup adds the group, the group that
// arrives last adds the groups and writes the slice of the row
template <class Unit>
__device__ void wide_chunk(const SumArgs& a, long long g) {
  const int slice = static_cast<int>(g % a.slices);
  const long long cell = g / a.slices;
  const int bi = static_cast<int>(cell / a.cells);
  const int j = static_cast<int>(cell % a.cells);
  Piece pieces[2];
  const int np = pieces_of(a, bi, j, pieces);
  const int col = slice * kWarp + threadIdx.x;
  Unit* part = reinterpret_cast<Unit*>(a.part);
  for (int q = 0; q < np; ++q) {
    const Piece& k = pieces[q];
    int row;
    float w;
    entry(a, k.at, k.cnt, row, w);
    Unit acc[1] = {zero_unit<Unit>()};
    sum_rows<Unit, 1, kChunkInFlight>(reinterpret_cast<const Unit*>(a.m),
                                      a.units, slice * kWarp, k.cnt, row, w,
                                      acc);
    const float dsum = weight_sum(w, k.cnt);
    const long long mine = (cell * 2 + k.slot);
    if (col < a.units) part[mine * a.units + col] = acc[0];
    if (threadIdx.x == 0) a.dpart[mine * a.slices + slice] = dsum;
    const long long r = static_cast<long long>(bi) * a.n + k.d;
    const int s = __ldg(a.rowptr + r + bi);
    // first level: the last of the chunk's group adds the group's partials
    // into its first chunk's slot; second: the last group adds the groups
    const int c0 = k.c / kGroup * kGroup;
    const long long head = part_row(a, bi, s, c0);
    if (!last_arrival(a.group_counters + head * a.slices + slice,
                      min(kGroup, k.nch - c0)))
      continue;
    Unit tot;
    float dtot;
    add_partials<Unit>(a, bi, s, c0, 1, min(kGroup, k.nch - c0), col, slice,
                       tot, dtot);
    if (col < a.units) part[head * a.units + col] = tot;
    if (threadIdx.x == 0) a.dpart[head * a.slices + slice] = dtot;
    const int groups = (k.nch + kGroup - 1) / kGroup;
    if (!last_arrival(a.counters + r * a.slices + slice, groups)) continue;
    add_partials<Unit>(a, bi, s, 0, kGroup, groups, col, slice, tot, dtot);
    const float div = divisor(dtot);
    if (col < a.units)
      reinterpret_cast<Unit*>(a.out)[r * a.units + col] =
          a.mean && div != 1.0f ? quot(tot, div) : tot;
    if (a.deg != nullptr && slice == 0 && threadIdx.x == 0) a.deg[r] = dtot;
  }
}

// The chunk warps first, so that the long segments start early; then a
// warp an output row's column tile.
template <class Unit, int V>
__global__ void __launch_bounds__(kRowThreads) wide_sum_kernel(SumArgs a) {
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (g < a.chunk_workers) {
    wide_chunk<Unit>(a, g);
  } else if (g - a.chunk_workers <
             static_cast<long long>(a.b) * a.n * a.tiles) {
    const long long x = g - a.chunk_workers;
    wide_row<Unit, V>(a, x / a.tiles, static_cast<int>(x % a.tiles));
  }
}

// narrow route: one thread adds entries at .. at + cnt - 1 (rows of
// f <= kNarrowF floats) in ascending order, as the wide routes do, with the
// loads of kInFlight entries issued before the first of them is added.
__device__ __forceinline__ void narrow_sum(const SumArgs& a, long long at,
                                           int cnt, float (&acc)[kNarrowF],
                                           float& deg) {
#pragma unroll
  for (int c = 0; c < kNarrowF; ++c) acc[c] = 0.0f;
  deg = 0.0f;
  for (int j0 = 0; j0 < cnt; j0 += kInFlight) {
    int row[kInFlight];
    float w[kInFlight], v[kInFlight][kNarrowF];
#pragma unroll
    for (int t = 0; t < kInFlight; ++t) {
      const bool live = j0 + t < cnt;
      row[t] = live ? __ldg(a.csr_row + at + j0 + t) : 0;
      w[t] = live ? __ldg(a.csr_w + at + j0 + t) : 0.0f;
    }
#pragma unroll
    for (int t = 0; t < kInFlight; ++t) {
      const float* mr = a.m + static_cast<long long>(row[t]) * a.f;
#pragma unroll
      for (int c = 0; c < kNarrowF; ++c)
        v[t][c] = j0 + t < cnt && c < a.f ? __ldg(mr + c) : 0.0f;
    }
#pragma unroll
    for (int t = 0; t < kInFlight; ++t) {
      if (j0 + t < cnt) {
#pragma unroll
        for (int c = 0; c < kNarrowF; ++c)
          acc[c] = term_add(acc[c], w[t], v[t][c]);
        deg = __fadd_rn(deg, w[t]);
      }
    }
  }
}

// The row r = b * N + d of f <= kNarrowF floats, and its degree.
__device__ __forceinline__ void narrow_store(const SumArgs& a, long long r,
                                             const float (&acc)[kNarrowF],
                                             float deg) {
  const float div = divisor(deg);
  float* o = a.out + r * a.f;
#pragma unroll
  for (int c = 0; c < kNarrowF; ++c)
    if (c < a.f) o[c] = a.mean && div != 1.0f ? __fdiv_rn(acc[c], div)
                                              : acc[c];
  if (a.deg != nullptr) a.deg[r] = deg;
}

__device__ void narrow_row(const SumArgs& a, long long r) {
  long long at;
  int cnt;
  if (!row_of(a, r, at, cnt)) return;   // the chunk warps write it
  float acc[kNarrowF], deg;
  narrow_sum(a, at, cnt, acc, deg);
  narrow_store(a, r, acc, deg);
}

// The sum, in order, of `count` partials of a segment starting at entry s
// (its chunks first, first + step, ...) and of their degrees, in every
// lane: the lanes load 32 at a time, lane 0's first, and all add them in
// lane order.
__device__ __forceinline__ void narrow_add(const SumArgs& a, int bi, int s,
                                           int first, int step, int count,
                                           float (&acc)[kNarrowF],
                                           float& deg) {
  const int lane = threadIdx.x;
#pragma unroll
  for (int c = 0; c < kNarrowF; ++c) acc[c] = 0.0f;
  deg = 0.0f;
  for (int c0 = 0; c0 < count; c0 += kWarp) {
    float v[kNarrowF], dv = 0.0f;
    const bool ok = c0 + lane < count;
    const long long p = ok ? part_row(a, bi, s, first + (c0 + lane) * step)
                           : 0;
#pragma unroll
    for (int c = 0; c < kNarrowF; ++c)
      v[c] = ok && c < a.f ? ldcg(a.part + p * a.f + c) : 0.0f;
    if (ok) dv = ldcg(a.dpart + p);
    const int here = min(kWarp, count - c0);
    for (int t = 0; t < here; ++t) {
#pragma unroll
      for (int c = 0; c < kNarrowF; ++c)
        acc[c] = __fadd_rn(acc[c], __shfl_sync(kFull, v[c], t));
      deg = __fadd_rn(deg, __shfl_sync(kFull, dv, t));
    }
  }
}

// narrow route: one window's pieces, a warp each, its lanes along the
// piece's entries (lane j entry j) meeting in a fixed tree (lane i adds
// lane i + 16, then i + 8, 4, 2, 1); the partials meet in two levels as
// on the wide routes
__device__ void narrow_chunk(const SumArgs& a, long long cell) {
  const int lane = threadIdx.x;
  const int bi = static_cast<int>(cell / a.cells);
  Piece pieces[2];
  const int np = pieces_of(a, bi, static_cast<int>(cell % a.cells), pieces);
  for (int q = 0; q < np; ++q) {
    const Piece& k = pieces[q];
    int row;
    float w;
    entry(a, k.at, k.cnt, row, w);
    float acc[kNarrowF];
    const float* mr = a.m + static_cast<long long>(row) * a.f;
#pragma unroll
    for (int c = 0; c < kNarrowF; ++c)
      acc[c] = lane < k.cnt && c < a.f ? term_add(0.0f, w, __ldg(mr + c))
                                       : 0.0f;
    float deg = w;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < kNarrowF; ++c)
        acc[c] = __fadd_rn(acc[c], __shfl_down_sync(kFull, acc[c], off));
      deg = __fadd_rn(deg, __shfl_down_sync(kFull, deg, off));
    }
    const long long mine = cell * 2 + k.slot;
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kNarrowF; ++c)
        if (c < a.f) a.part[mine * a.f + c] = acc[c];
      a.dpart[mine] = deg;
    }
    const long long r = static_cast<long long>(bi) * a.n + k.d;
    const int s = __ldg(a.rowptr + r + bi);
    // two levels, as on the wide routes
    const int c0 = k.c / kGroup * kGroup;
    const long long head = part_row(a, bi, s, c0);
    if (!last_arrival(a.group_counters + head, min(kGroup, k.nch - c0)))
      continue;
    narrow_add(a, bi, s, c0, 1, min(kGroup, k.nch - c0), acc, deg);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kNarrowF; ++c)
        if (c < a.f) a.part[head * a.f + c] = acc[c];
      a.dpart[head] = deg;
    }
    const int groups = (k.nch + kGroup - 1) / kGroup;
    if (!last_arrival(a.counters + r, groups)) continue;
    narrow_add(a, bi, s, 0, kGroup, groups, acc, deg);
    if (lane == 0) narrow_store(a, r, acc, deg);
  }
}

// The chunk warps first, then a thread an output row.
__global__ void __launch_bounds__(kRowThreads) narrow_sum_kernel(SumArgs a) {
  const long long g = static_cast<long long>(blockIdx.x) * kRowThreads +
                      threadIdx.y * kWarp + threadIdx.x;
  if (g < a.chunk_workers) {
    narrow_chunk(a, g / kWarp);   // a warp a window
  } else if (g - a.chunk_workers < static_cast<long long>(a.b) * a.n) {
    narrow_row(a, g - a.chunk_workers);
  }
}

// Where each array of a segment_scatter call lies in its scratch, in
// 32-bit words, each array on a 16-byte boundary.
struct Layout {
  int chunk, cells, slices, units;
  long long rowptr, csr_row, csr_w, csr_dst, counters, group_counters, dpart,
      part, words;
};

Layout layout(int b, int n, int e, int f, int route) {
  Layout l;
  l.chunk = route == kNarrow ? kNarrowChunk : kWideChunk;
  l.units = route == kWideVec ? f / 4 : f;
  l.slices = route == kNarrow ? 1 : (l.units + kWarp - 1) / kWarp;
  l.cells = (e + l.chunk - 1) / l.chunk;
  const long long rows = b, slots = rows * l.cells * 2;
  long long at = 0;
  auto take = [&at](long long words) {
    const long long here = at;
    at += (words + 3) / 4 * 4;
    return here;
  };
  l.rowptr = take(rows * (n + 1));
  l.csr_row = take(rows * e);
  l.csr_w = take(rows * e);
  l.csr_dst = take(rows * e);
  l.counters = take(rows * n * l.slices);
  l.group_counters = take(slots * l.slices);
  l.dpart = take(slots * l.slices);
  l.part = take(slots * f);
  l.words = at;
  return l;
}

template <class Unit>
cudaError_t launch_wide(const SumArgs& a, int v, unsigned blocks,
                        cudaStream_t s) {
  switch (v) {
    case 1: wide_sum_kernel<Unit, 1><<<blocks, row_block(), 0, s>>>(a); break;
    case 2: wide_sum_kernel<Unit, 2><<<blocks, row_block(), 0, s>>>(a); break;
    case 4: wide_sum_kernel<Unit, 4><<<blocks, row_block(), 0, s>>>(a); break;
    case 8: wide_sum_kernel<Unit, 8><<<blocks, row_block(), 0, s>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
}  // namespace

extern "C" {

// 32-bit words of device scratch a segment_scatter call of these shapes on
// `route` needs (the CSR, the chunk plan and partials, and the build's
// table where it does not fit shared memory).
long long segment_scatter_scratch_words(int b, int n, int e, int f,
                                        int route) {
  return layout(b, n, e, f, route).words;
}

// Weighted segmented sum with degree over a destination-sorted CSR, two
// launches: the CSR build (dst_csr.cuh) and the sum on `route` (kNarrow,
// kWideScalar, kWideVec) with v units a lane (wide routes: 1, 2, 4 or 8).
// With src not null the message of edge e is h[b, src_e] (segment
// aggregate); with src null it is msgs[b, e] (segment scatter). src and dst
// are read at element strides src_stride and dst_stride, so the two columns
// of an [B, E, 2] edge array are passed without a copy. Every element of out
// [B, N, F] is written, and of deg [B, N] when it is not null (the mean
// does not need it). scratch holds segment_scatter_scratch_words words,
// 16-byte aligned.
// Returns the cudaError_t of the launches.
int segment_scatter(const float* h, const float* msgs, const int* src,
                    int src_stride, const int* dst, int dst_stride,
                    const float* em, float* out, float* deg, int mean, int b,
                    int n, int e, int f, int route, int v, void* scratch,
                    void* stream) {
  if (b <= 0 || n <= 0 || e <= 0 || f <= 0) return 0;
  if (route < kNarrow || route > kWideVec ||
      (route == kNarrow && f > kNarrowF) || (route == kWideVec && f % 4) ||
      (route != kNarrow && v != 1 && v != 2 && v != 4 && v != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l = layout(b, n, e, f, route);
  int* w = static_cast<int*>(scratch);
  csr::BuildArgs ba{};
  ba.dst = dst;
  ba.dst_stride = dst_stride;
  ba.src = src;
  ba.src_stride = src_stride;
  ba.em = em;
  ba.b = b;
  ba.n = n;
  ba.e = e;
  ba.rowptr = w + l.rowptr;
  ba.csr_row = w + l.csr_row;
  ba.csr_w = reinterpret_cast<float*>(w + l.csr_w);
  ba.csr_dst = w + l.csr_dst;
  ba.chunk = l.chunk;
  ba.group = kGroup;
  ba.cells = l.cells;
  ba.slices = l.slices;
  ba.counters = w + l.counters;
  ba.group_counters = w + l.group_counters;
  cudaError_t err = csr::launch_build(ba, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  SumArgs a{};
  a.m = src != nullptr ? h : msgs;
  a.rowptr = ba.rowptr;
  a.csr_row = ba.csr_row;
  a.csr_w = ba.csr_w;
  a.csr_dst = ba.csr_dst;
  a.counters = ba.counters;
  a.group_counters = ba.group_counters;
  a.part = reinterpret_cast<float*>(w + l.part);
  a.dpart = reinterpret_cast<float*>(w + l.dpart);
  a.out = out;
  a.deg = deg;
  a.mean = mean;
  a.b = b;
  a.n = n;
  a.e = e;
  a.f = f;
  a.units = l.units;
  a.chunk = l.chunk;
  a.cells = l.cells;
  a.slices = l.slices;
  a.tiles = route == kNarrow ? 1 : (l.units + kWarp * v - 1) / (kWarp * v);
  // a warp a window's slice, then a warp an output row's column tile
  // (wide) or a thread an output row (narrow); chunk_workers counts threads
  // on the narrow route
  const long long cells = static_cast<long long>(b) * l.cells * l.slices;
  a.chunk_workers = route == kNarrow ? cells * kWarp : cells;
  const long long workers =
      a.chunk_workers + static_cast<long long>(b) * n * a.tiles;
  const long long per_block =
      route == kNarrow ? kRowThreads : kRowThreads / kWarp;
  const unsigned blocks =
      static_cast<unsigned>((workers + per_block - 1) / per_block);
  if (route == kNarrow) {
    narrow_sum_kernel<<<blocks, row_block(), 0, s>>>(a);
    err = cudaGetLastError();
  } else if (route == kWideVec) {
    err = launch_wide<float4>(a, v, blocks, s);
  } else {
    err = launch_wide<float>(a, v, blocks, s);
  }
  return static_cast<int>(err);
}

// 32-bit words of the arrival counters that dst_csr zeroes.
long long dst_csr_counter_words(int b, int n, int e) {
  return chunks::counter_words(b, n, e);
}

// The destination-sorted CSR alone, one launch (dst_csr.cuh): rowptr
// [B, N + 1] and perm [B, E] (-1 past each row's rowptr[b, N]). src may be
// null (then only dst decides which edges are in a segment). counters, when
// not null, holds dst_csr_counter_words words: the build zeroes those of
// the segments longer than chunks::kCsrChunk, which the GAT aggregate
// (gat_aggregate.cu) counts its window pieces' arrivals on. Returns the
// cudaError_t of the launch.
int dst_csr(const int* dst, int dst_stride, const int* src, int src_stride,
            int* rowptr, int* perm, int* counters, int b, int n, int e,
            void* stream) {
  csr::BuildArgs ba{};
  ba.dst = dst;
  ba.dst_stride = dst_stride;
  ba.src = src;
  ba.src_stride = src_stride;
  ba.b = b;
  ba.n = n;
  ba.e = e;
  ba.rowptr = rowptr;
  ba.perm = perm;
  if (counters != nullptr) {
    ba.chunk = chunks::kCsrChunk;
    ba.group = chunks::kGroup;
    ba.cells = (e + chunks::kCsrChunk - 1) / chunks::kCsrChunk;
    ba.slices = chunks::kCsrSlots;
    ba.counters = counters;
    ba.group_counters =
        counters + static_cast<long long>(b) * n * chunks::kCsrSlots;
  }
  return static_cast<int>(
      csr::launch_build(ba, static_cast<cudaStream_t>(stream)));
}

// out[b, e] = w[b, e] * h[b, idx_e] (w null: weight 1), one launch; idx is
// read at element stride idx_stride, and an index outside [0, N) gathers 0.
// Every element of out is written. vec as for segment_scatter (h and out).
// Returns the cudaError_t of the launch.
int segment_gather(const float* h, const int* idx, int idx_stride,
                   const float* w, float* out, int b, int n, int e, int f,
                   int vec, void* stream) {
  const long long rows = static_cast<long long>(b) * e;
  if (rows <= 0 || f <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long limit = 0x7fffffffLL;
  const bool wide = static_cast<long long>(b) * n * f > limit ||
                    rows * f > limit ||
                    (rows - 1) * idx_stride + 1 > limit;
  if (vec) {
    if (wide) {
      dispatch_gather<float4, long long>(h, idx, idx_stride, w, out, b, n, e,
                                         f / 4, s);
    } else {
      dispatch_gather<float4, int>(h, idx, idx_stride, w, out, b, n, e,
                                   f / 4, s);
    }
  } else {
    if (wide) {
      dispatch_gather<float, long long>(h, idx, idx_stride, w, out, b, n, e,
                                        f, s);
    } else {
      dispatch_gather<float, int>(h, idx, idx_stride, w, out, b, n, e, f, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
