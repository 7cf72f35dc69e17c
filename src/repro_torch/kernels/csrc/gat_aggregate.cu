// Fused GAT aggregate over the packed flat node axis for Hopper (sm_90a),
// float32 throughout, over a destination-sorted CSR.
//
// Replaces the TPU kernel `fused_gat_aggregate_pallas` / `_fused_gat_kernel`
// in src/repro/kernels/segment_spmm.py. Semantics are those of
// `fused_gat_aggregate_ref` (src/repro_torch/kernels/ref.py):
//
//   out[i, c] = node_mask[i] * sum_{e: dst_e = i} (z[src_e, c] * att[e, c / dh]) * em[e]
//
// with D = H * dh features, each head's weight broadcast over its dh-wide
// slice. The TPU kernel ran a phased grid with one-hot gather and scatter
// matmuls over edge tiles it walked in order. Hopper's blocks run in no
// order, so here the edges come sorted by destination (dst_csr.cuh, built
// once a bin and shared by the bin's layers and by edge_softmax.cu), and a
// warp owns each output row, or a 32 V-unit column tile of it:
//
//   * It reads the row's CSR entries in ascending edge order, z[src] rows
//     straight from z, lanes along the features: V float4s a lane (route
//     wide_vec: dh a multiple of 4 and z on a 16-byte boundary, so a lane's
//     float4 lies in one head and takes one weight) or V floats (route
//     wide_scalar). The loads of kWideWords words a lane are issued before
//     the first of them is added.
//   * Each term is (z * att) * em, rounded apart, and added to a sum from
//     +0 (__fmul_rn, __fadd_rn: no FMA contraction); the node mask
//     multiplies the sum once. A row of at most one chunk is the plain
//     version's index_add_ sum on the CPU, bit for bit.
//   * Each output row is written once: no zero-fill, no float atomic, no
//     second pass, and the same bits from run to run.
//
// Long segments are where a warp a row hurts: every padded edge of a packed
// bin sits at (0, 0), so node 0's row holds every padding entry of the bin
// (562 of 6,656 at the GAT full bin), and hubs exist. A segment longer than
// kChunk entries is summed in window pieces (seg_chunks.cuh, shared with
// segment_aggregate.cu): a warp takes a window's pieces of such segments
// per 32-unit column slice, one unit a lane, 8 (float4) or 16 (float)
// entries in flight. Slice sl counts its arrival on counter slot
// sl % kSlots; the last arrival of a group's chunks there adds the group's
// partials of that slot's slices in window order, all its loads in flight
// at once, and writes the row when the segment is one group (the pile of
// the full bin is 18 chunks: one group of 16 and one of 2, so two levels);
// else the last group adds the groups. While the row warps stream z, every
// dependent trip to memory takes microseconds, so the pile's path is cut
// to few of them: with one counter for all slices, and the slices added one
// after another, the pile took longer than all the rows. The counters come
// zeroed with the CSR and are left at 0.
//
// Masking and NaN: every edge whose destination is in [0, P) is in its
// segment whatever its weight, so a masked edge's NaN * 0 reaches its
// destination as in the plain version; an edge whose source falls outside
// [0, P) is skipped (the packed layout never produces one).
//
// What bounds it on the H100: bytes. At the GAT full bin (P = 4096,
// Q = 6656, D = 512, H = 4) it must read z and write out, 8.4 MB each:
// 5.07 us at 3.35 TB/s. The row warps read z[src] with a chain of three
// dependent loads ahead of them (rowptr, perm, edges), which the many rows
// in flight hide; the padding pile's pieces and their combine are the
// longest chain.
//
// Tolerance: a chunked row adds in another order than the plain version, a
// float32 rounding apart; the card's plain version adds with atomics. The
// tests and chip_smoke.py hold it to 1e-4 absolute + 1e-4 relative.

#include <cuda_runtime.h>

#include "seg_chunks.cuh"

namespace {

using chunks::kGroup;
using chunks::last_arrival;
using chunks::ldcg;
using chunks::ldg;
using chunks::part_row;
using chunks::Piece;
using chunks::pieces_of;
using chunks::plus;
using chunks::zero_unit;

constexpr int kWarp = 32;
constexpr int kRowThreads = 128;    // four warps a block
constexpr unsigned kFull = 0xffffffffu;
// the routes, numbered as segment_spmm.GAT_ROUTES numbers them
constexpr int kWideScalar = 1, kWideVec = 2;
constexpr int kChunk = chunks::kCsrChunk;   // entries a row warp sums
constexpr int kWideWords = 32;     // 32-bit words of z a row lane loads
                                   // before it adds
constexpr int kSlots = chunks::kCsrSlots;   // counters a destination

struct GatArgs {
  const float* z;          // [P, D]
  const int* edges;        // [Q, 2] (src, dst)
  const float* em;         // [Q]
  const float* att;        // [Q, H]
  const float* nm;         // [P]
  const int* rowptr;       // [1, P + 1] (dst_csr.cuh)
  const int* perm;         // [1, Q]
  int* counters;           // [P, kSlots]: groups arrived, long segments
  int* group_counters;     // [cells, 2, kSlots]: chunk slices arrived, at
                           // a group's first chunk's slot
  float* part;             // [cells, 2, D]: chunk and group sums
  float* out;              // [P, D]
  int n, e, h, dh;         // n = P, e = Q
  int units, unit_floats;  // D / 4 float4s (wide_vec) or D floats
  int chunk, cells, slices;   // cells: ceil(Q / chunk) windows
  int tiles;               // column tiles a row, a warp each
  long long chunk_workers; // the grid's first warps: cells * slices
  // the destination of CSR entry k (seg_chunks.cuh)
  __device__ int entry_dst(long long k) const {
    return __ldg(edges + 2LL * __ldg(perm + k) + 1);
  }
};

__device__ __forceinline__ float term_add(float acc, float z, float al,
                                          float w) {
  return __fadd_rn(acc, __fmul_rn(__fmul_rn(z, al), w));   // no FMA
}
__device__ __forceinline__ float4 term_add(float4 acc, float4 z, float al,
                                           float w) {
  return make_float4(term_add(acc.x, z.x, al, w), term_add(acc.y, z.y, al, w),
                     term_add(acc.z, z.z, al, w), term_add(acc.w, z.w, al, w));
}
__device__ __forceinline__ float scaled(float v, float m) {
  return __fmul_rn(v, m);
}
__device__ __forceinline__ float4 scaled(float4 v, float m) {
  return make_float4(__fmul_rn(v.x, m), __fmul_rn(v.y, m), __fmul_rn(v.z, m),
                     __fmul_rn(v.w, m));
}

// Lane j < cnt: entry at + j's edge, source row and weight, and whether
// its source is in [0, P); other lanes: edge 0, row 0, skipped.
__device__ __forceinline__ void entry(const GatArgs& a, long long at, int cnt,
                                      int& eix, int& src, float& w, int& ok) {
  eix = src = ok = 0;
  w = 0.0f;
  if (static_cast<int>(threadIdx.x) < cnt) {
    eix = __ldg(a.perm + at + threadIdx.x);
    const int s = __ldg(a.edges + 2LL * eix);
    w = __ldg(a.em + eix);
    ok = s >= 0 && s < a.n;
    src = ok ? s : 0;
  }
}

// acc[u] += (z[src_j, c] * att[e_j, head(c)]) * em_j, c = c0 + lane + 32 u,
// over the cnt <= 32 entries whose edge, source and weight lane j holds, in
// ascending j; the loads of kDepth entries are issued before the first of
// them is added.
template <class Unit, int V, int kDepth>
__device__ __forceinline__ void sum_entries(const GatArgs& a, int c0, int cnt,
                                            int eix, int src, float w, int ok,
                                            Unit (&acc)[V]) {
  const int lane = threadIdx.x;
  const Unit* z = reinterpret_cast<const Unit*>(a.z);
  int head[V];
#pragma unroll
  for (int u = 0; u < V; ++u)
    head[u] = (c0 + lane + kWarp * u) * a.unit_floats / a.dh;
  for (int j0 = 0; j0 < cnt; j0 += kDepth) {
    Unit v[kDepth][V];
    float al[kDepth][V];
#pragma unroll
    for (int t = 0; t < kDepth; ++t) {
      const int j = j0 + t;
      const long long row =
          static_cast<long long>(__shfl_sync(kFull, src, j & 31)) * a.units;
      const long long arow =
          static_cast<long long>(__shfl_sync(kFull, eix, j & 31)) * a.h;
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int c = c0 + lane + kWarp * u;
        const bool live = j < cnt && c < a.units;
        v[t][u] = live ? ldg(z + row + c) : zero_unit<Unit>();
        al[t][u] = live ? __ldg(a.att + arow + head[u]) : 0.0f;
      }
    }
#pragma unroll
    for (int t = 0; t < kDepth; ++t) {
      const int j = j0 + t;
      const float wj = __shfl_sync(kFull, w, j & 31);
      const int okj = __shfl_sync(kFull, ok, j & 31);
      if (j < cnt && okj) {
#pragma unroll
        for (int u = 0; u < V; ++u)
          acc[u] = term_add(acc[u], v[t][u], al[t][u], wj);
      }
    }
  }
}

// One column tile (32 V units) of output row r, when its segment is at
// most one chunk long (else the chunk warps write it).
template <class Unit, int V>
__device__ void gat_row(const GatArgs& a, int r, int tile) {
  constexpr int kWords = V * static_cast<int>(sizeof(Unit) / 4);
  constexpr int kDepth = kWords >= kWideWords ? 1 : kWideWords / kWords;
  const int k0 = __ldg(a.rowptr + r);
  const int cnt = __ldg(a.rowptr + r + 1) - k0;
  if (cnt > a.chunk) return;
  int eix, src, ok;
  float w;
  entry(a, k0, cnt, eix, src, w, ok);
  const int c0 = tile * kWarp * V;
  Unit acc[V];
#pragma unroll
  for (int u = 0; u < V; ++u) acc[u] = zero_unit<Unit>();
  sum_entries<Unit, V, kDepth>(a, c0, cnt, eix, src, w, ok, acc);
  const float m = __ldg(a.nm + r);
  Unit* o = reinterpret_cast<Unit*>(a.out) + static_cast<long long>(r) *
                                                 a.units;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int c = c0 + threadIdx.x + kWarp * u;
    if (c < a.units) o[c] = scaled(acc[u], m);
  }
}

// The sum, in order, of `count` <= kGroup partials of a segment starting at
// entry s (its chunks first, first + step, ...), column col, their loads
// all in flight: ((0 + p0) + p1) + ...
template <class Unit>
__device__ __forceinline__ Unit add_partials(const GatArgs& a, int s,
                                             int first, int step, int count,
                                             int col) {
  const Unit* part = reinterpret_cast<const Unit*>(a.part);
  Unit v[kGroup];
#pragma unroll
  for (int c = 0; c < kGroup; ++c) {
    const bool ok = c < count && col < a.units;
    const long long p = ok ? part_row(a, 0, s, first + c * step) : 0;
    v[c] = ok ? ldcg(part + p * a.units + col) : zero_unit<Unit>();
  }
  Unit tot = zero_unit<Unit>();
#pragma unroll
  for (int c = 0; c < kGroup; ++c)
    if (c < count) tot = plus(tot, v[c]);
  return tot;
}

// One 32-unit column slice of one window's pieces. Slice sl counts its
// arrival on counter slot sl % kCsrSlots of the group's first chunk; the
// warp that arrives last there adds the group's partials of that slot's
// slices in window order, in one round of loads, and, for a segment of one
// group, writes them to the row; else the last group of the slot adds the
// groups and writes the row.
template <class Unit>
__device__ void gat_chunk(const GatArgs& a, long long g) {
  constexpr int kDepth = sizeof(Unit) == 16 ? 8 : 16;   // entries in flight
  const int slice = static_cast<int>(g % a.slices);
  const int j = static_cast<int>(g / a.slices);
  const int slot = slice % kSlots;
  const int sharing = (a.slices - slot + kSlots - 1) / kSlots;
  Piece pieces[2];
  const int np = pieces_of(a, 0, j, pieces);
  const int lane = threadIdx.x;
  Unit* part = reinterpret_cast<Unit*>(a.part);
  for (int q = 0; q < np; ++q) {
    const Piece& k = pieces[q];
    int eix, src, ok;
    float w;
    entry(a, k.at, k.cnt, eix, src, w, ok);
    Unit acc[1] = {zero_unit<Unit>()};
    sum_entries<Unit, 1, kDepth>(a, slice * kWarp, k.cnt, eix, src, w, ok,
                                 acc);
    const int col = slice * kWarp + lane;
    const long long mine = static_cast<long long>(j) * 2 + k.slot;
    if (col < a.units) part[mine * a.units + col] = acc[0];
    const int s = __ldg(a.rowptr + k.d);
    const int c0 = k.c / kGroup * kGroup;
    const long long head = part_row(a, 0, s, c0);
    const int count = min(kGroup, k.nch - c0);
    const int groups = (k.nch + kGroup - 1) / kGroup;
    if (!last_arrival(a.group_counters + head * kSlots + slot,
                      count * sharing))
      continue;
    const float m = __ldg(a.nm + k.d);
    Unit* o = reinterpret_cast<Unit*>(a.out) + static_cast<long long>(k.d) *
                                                   a.units;
    for (int sl = slot; sl < a.slices; sl += kSlots) {
      const int cl = sl * kWarp + lane;
      const Unit tot = add_partials<Unit>(a, s, c0, 1, count, cl);
      if (cl < a.units) {
        if (groups == 1) {
          o[cl] = scaled(tot, m);
        } else {
          part[head * a.units + cl] = tot;
        }
      }
    }
    if (groups == 1 ||
        !last_arrival(a.counters + static_cast<long long>(k.d) * kSlots + slot,
                      groups))
      continue;
    for (int sl = slot; sl < a.slices; sl += kSlots) {
      const int cl = sl * kWarp + lane;
      const Unit tot = add_partials<Unit>(a, s, 0, kGroup, groups, cl);
      if (cl < a.units) o[cl] = scaled(tot, m);
    }
  }
}

// The chunk warps first, so that the long segments start early; then a
// warp an output row's column tile.
template <class Unit, int V>
__global__ void __launch_bounds__(kRowThreads) gat_kernel(GatArgs a) {
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (g < a.chunk_workers) {
    gat_chunk<Unit>(a, g);
  } else if (g - a.chunk_workers < static_cast<long long>(a.n) * a.tiles) {
    const long long x = g - a.chunk_workers;
    gat_row<Unit, V>(a, static_cast<int>(x / a.tiles),
                     static_cast<int>(x % a.tiles));
  }
}

template <class Unit>
cudaError_t launch(const GatArgs& a, int v, unsigned blocks, cudaStream_t s) {
  const dim3 block(kWarp, kRowThreads / kWarp);
  switch (v) {
    case 1: gat_kernel<Unit, 1><<<blocks, block, 0, s>>>(a); break;
    case 2: gat_kernel<Unit, 2><<<blocks, block, 0, s>>>(a); break;
    case 4: gat_kernel<Unit, 4><<<blocks, block, 0, s>>>(a); break;
    case 8: gat_kernel<Unit, 8><<<blocks, block, 0, s>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 32-bit words of the partials' scratch a call of these shapes needs.
long long fused_gat_aggregate_scratch_words(int q, int d) {
  const long long cells = (static_cast<long long>(q) + kChunk - 1) / kChunk;
  return cells * 2 * d;
}

// out [P, D] = node_mask * the per-destination sum of (z[src] * att[head]) *
// em over the CSR of edges' destinations (rowptr [1, P + 1], perm [1, Q],
// and its counters, dst_csr in segment_aggregate.cu), one launch on `route`
// (kWideScalar, kWideVec) with v units a lane (1, 2, 4 or 8). Every element
// of out is written. part holds fused_gat_aggregate_scratch_words words,
// 16-byte aligned. Returns the cudaError_t of the launch.
int fused_gat_aggregate(const float* z, const int* edges, const float* em,
                        const float* att, const float* nm, const int* rowptr,
                        const int* perm, int* counters, float* part,
                        float* out, int p, int d, int q, int h, int route,
                        int v, void* stream) {
  if (p <= 0 || d <= 0 || q <= 0) return 0;
  if (h <= 0 || d % h != 0 || (route != kWideScalar && route != kWideVec) ||
      (route == kWideVec && (d / h) % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  GatArgs a{};
  a.z = z;
  a.edges = edges;
  a.em = em;
  a.att = att;
  a.nm = nm;
  a.rowptr = rowptr;
  a.perm = perm;
  a.counters = counters;
  a.group_counters = counters + static_cast<long long>(p) * kSlots;
  a.part = part;
  a.out = out;
  a.n = p;
  a.e = q;
  a.h = h;
  a.dh = d / h;
  a.unit_floats = route == kWideVec ? 4 : 1;
  a.units = d / a.unit_floats;
  a.chunk = kChunk;
  a.cells = (q + kChunk - 1) / kChunk;
  a.slices = (a.units + kWarp - 1) / kWarp;
  a.tiles = (a.units + kWarp * v - 1) / (kWarp * v);
  a.chunk_workers = static_cast<long long>(a.cells) * a.slices;
  const long long workers =
      a.chunk_workers + static_cast<long long>(p) * a.tiles;
  const long long per_block = kRowThreads / kWarp;
  const unsigned blocks =
      static_cast<unsigned>((workers + per_block - 1) / per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(route == kWideVec ? launch<float4>(a, v, blocks, s)
                                            : launch<float>(a, v, blocks, s));
}

}  // extern "C"
