// Long segments of a destination-sorted CSR cut into window pieces, and the
// fixed order their partial sums meet in, for Hopper (sm_90a). Shared by the
// segmented sums (segment_aggregate.cu, B5 and B6) and the GAT aggregate
// (gat_aggregate.cu, B4).
//
// A batch row's CSR entries (dst_csr.cuh) are cut into windows of `chunk`
// entries. A segment longer than `chunk` (a high in-degree node, or the
// padded edges of a batch row, which all sit at (0, 0)) is summed a window
// at a time: a warp takes a window's pieces of such segments (at most two:
// the one that covers its first entry, slot 0, and one that starts inside
// it, slot 1) and writes each piece's partial to scratch at its window's
// slot. The partials meet in two levels, each added in window order from
// +0 by the warp that arrives last on an integer counter: a group of kGroup
// chunks into the group's first chunk's slot, then the groups into the
// output row. The order is fixed whatever order the warps run in, and no
// warp reads more than kGroup partials of a level.
//
// The counters are zeroed by the CSR build (dst_csr.cuh) for the segments
// longer than `chunk`, and left at 0 by the last arrival (atomicInc wraps
// at the arrival count), so one CSR serves any number of launches in
// stream order.
//
// An args type A passes its CSR to these helpers: rowptr [B, N + 1], n, e
// (entries a batch row), chunk, cells (windows a row: ceil(E / chunk)) and
// entry_dst(k), the destination of the flat entry k = b * E + entry.

#pragma once

#include <cuda_runtime.h>

namespace chunks {

constexpr int kGroup = 16;           // chunks a first-level combine adds
constexpr unsigned kFull = 0xffffffffu;
// the chunk of a CSR built alone (dst_csr), which the GAT aggregate sums in
constexpr int kCsrChunk = 32;
// the counters a CSR built alone keeps for each destination and window
// slot: column slice s of a row counts on counter s % kCsrSlots
constexpr int kCsrSlots = 8;

// A CSR built alone carries the arrival counters of its long segments at
// chunk kCsrChunk: kCsrSlots per destination, [B, N, slots], then kCsrSlots
// per window slot, [B, cells, 2, slots]; their 32-bit words.
inline long long counter_words(int b, int n, int e) {
  const long long cells = (static_cast<long long>(e) + kCsrChunk - 1) /
                          kCsrChunk;
  return static_cast<long long>(b) * (n + cells * 2) * kCsrSlots;
}

// Publish this warp's partial and count its arrival on `counter`; true in
// the warp that arrives last of `arrivals`, which may then read them all.
// The last arrival leaves the counter at 0.
__device__ __forceinline__ bool last_arrival(int* counter, int arrivals) {
  __threadfence();
  __syncwarp();
  unsigned prev = 0;
  if (threadIdx.x == 0)
    prev = atomicInc(reinterpret_cast<unsigned*>(counter),
                     static_cast<unsigned>(arrivals - 1));
  prev = __shfl_sync(kFull, prev, 0);
  if (prev != static_cast<unsigned>(arrivals - 1)) return false;
  __threadfence();
  return true;
}

// A chunked segment's piece in one window of its batch row's entries.
struct Piece {
  int d, c, nch, slot;     // destination, chunk (window) index, chunks, slot
  int cnt;                 // entries
  long long at;            // the first entry in the [B*E] CSR arrays
};

// The pieces of window j of row bi (0, 1 or 2).
template <class A>
__device__ __forceinline__ int pieces_of(const A& a, int bi, int j,
                                         Piece (&p)[2]) {
  const int* rp = a.rowptr + static_cast<long long>(bi) * (a.n + 1);
  const int k0 = j * a.chunk;
  const int k1 = min(k0 + a.chunk, __ldg(rp + a.n));
  if (k0 >= k1) return 0;
  const long long row0 = static_cast<long long>(bi) * a.e;
  const int first = a.entry_dst(row0 + k0), last = a.entry_dst(row0 + k1 - 1);
  int np = 0;
  for (int q = 0; q < 2; ++q) {
    const int d = q ? last : first;
    if (q && last == first) break;
    const int s = __ldg(rp + d), t = __ldg(rp + d + 1);
    if (t - s <= a.chunk) continue;
    Piece& x = p[np++];
    x.d = d;
    x.c = j - s / a.chunk;
    x.nch = (t - 1) / a.chunk - s / a.chunk + 1;
    x.slot = x.c == 0 && s % a.chunk != 0;
    const int lo = max(s, k0);
    x.cnt = min(t, k1) - lo;
    x.at = row0 + lo;
  }
  return np;
}

// Where chunk c of a segment starting at entry s keeps its partials: its
// window's slot, as pieces_of assigned it.
template <class A>
__device__ __forceinline__ long long part_row(const A& a, int bi, int s,
                                              int c) {
  const int slot = c == 0 && s % a.chunk != 0;
  return (static_cast<long long>(bi) * a.cells + s / a.chunk + c) * 2 + slot;
}

__device__ __forceinline__ float term_add(float acc, float w, float v) {
  return __fadd_rn(acc, __fmul_rn(w, v));   // rounded apart: no FMA
}
__device__ __forceinline__ float4 term_add(float4 acc, float w, float4 v) {
  return make_float4(term_add(acc.x, w, v.x), term_add(acc.y, w, v.y),
                     term_add(acc.z, w, v.z), term_add(acc.w, w, v.w));
}
__device__ __forceinline__ float plus(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float4 plus(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float4 ldg(const float4* p) { return __ldg(p); }
// scratch another warp of this launch wrote: from L2, past this SM's L1
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float4 ldcg(const float4* p) { return __ldcg(p); }

template <class Unit>
__device__ __forceinline__ Unit zero_unit();
template <>
__device__ __forceinline__ float zero_unit<float>() { return 0.0f; }
template <>
__device__ __forceinline__ float4 zero_unit<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

}  // namespace chunks
