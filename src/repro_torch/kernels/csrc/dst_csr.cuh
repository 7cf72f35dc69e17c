// Destination-sorted CSR of a batched edge list, built on the device, for
// Hopper (sm_90a). The segmented sums of segment_aggregate.cu run over it,
// built each call; the GAT kernels (edge_softmax.cu, gat_aggregate.cu) over
// one built alone (the dst_csr entry) once a bin.
//
// For each batch row b of a [B, E] edge list, a stable counting sort of the
// edge indices by destination:
//
//   rowptr[b, d] .. rowptr[b, d + 1]   the entries of row b's list that hold
//                                      the edges into d, ascending by edge
//   perm[b, k]                         entry k's edge index (or -1 past
//                                      rowptr[b, N])
//   csr_row, csr_w, csr_dst [b*E + k]  entry k's message row (b*N + src_e
//                                      when src is given, else b*E + e),
//                                      weight (em, or 1 without em) and
//                                      destination
//
// An edge whose destination, or whose source where src is given, falls
// outside [0, N) is in no segment; every other edge is, whatever its weight.
// So a weight-0 edge's NaN * 0 reaches its destination as the plain versions
// add it, and the padded edges of a batch row, all at (0, 0), form one long
// segment at node 0, which the sums cut into chunks (seg_chunks.cuh).
// dst and src are read at element strides, so the columns of a [B, E, 2]
// edge array are passed without a copy.
//
// The build is one launch of ceil(N / kRange) blocks per batch row; block
// j owns the destinations [64 j, 64 j + 64), so no block waits for another.
// Pass 1 reads the row's whole edge list (from L2 once a first block has
// brought it there), keeps the first kKeyCache destinations in shared
// memory, counts its destinations' edges (integer atomics in shared
// memory) and the row's live edges into lower destinations: that count is
// where its range starts in the row's list. In pass 2 each warp takes a
// contiguous run of the edges, 32 at a time in edge order, and counts its
// edges into each destination of the range (equal destinations within 32
// are found with one ballot a bit of the destination's offset in the
// range; the group's leader adds). A prefix over the warps turns the
// counts into each warp's first place for each destination, and the warps
// walk their runs again: an edge's place is the range's start + its
// destination's start + the earlier warps' edges into it + its rank among
// its own warp's, that is its rank among the earlier edges into the same
// destination: the sort is stable. The block also writes rowptr for its
// destinations, the last block rowptr[N] and perm's tail, and zeroes the
// arrival counters of its destinations whose segments are longer than
// `chunk` (the sums cut those into chunks).
//
// What bounds it on the H100: every block reads the whole edge row, 64 KB
// at the packed step (B = 1, E = 8192, N = 8192: 128 blocks, 8 MB from
// L2), and each warp's walks are chains of shared-memory reads, ballots
// and barriers; the build takes about 10 us there (chip_smoke.py's
// csr_build_ms), not its bytes' time.

#pragma once

#include <cuda_runtime.h>

namespace csr {

constexpr int kThreads = 1024;            // a build block
// keys a block keeps for pass 2: with the static arrays, under the 48 KB a
// block has without an opt-in
constexpr int kKeyCache = 8192;
constexpr int kWarps = kThreads / 32;
constexpr int kRangeBits = 6;
constexpr int kRange = 1 << kRangeBits;   // destinations a block owns
constexpr unsigned kFull = 0xffffffffu;

struct BuildArgs {
  const int* dst;
  int dst_stride;
  const int* src;        // null: the message row is b*E + e
  int src_stride;
  const float* em;       // [B, E] weights for csr_w; null: weight 1
  int b, n, e;
  int* rowptr;           // [B, N + 1]
  int* perm;             // [B, E] or null
  int* csr_row;          // [B * E] or null; then csr_w and csr_dst too
  float* csr_w;          // [B * E]
  int* csr_dst;          // [B * E]: entry k's destination
  // a segment longer than `chunk` is summed in chunks of the row's windows
  // (seg_chunks.cuh), in groups of `group`: its arrival counters
  // are zeroed here, one per slice for the segment and one per slice for
  // each group, at the group's first chunk's slot of [B, cells, 2]
  int chunk, group, cells, slices;
  int* counters;         // [B * N, slices] or null
  int* group_counters;   // [B, cells, 2, slices]
};

// The edge's destination, or -1 when it is in no segment.
__device__ __forceinline__ int edge_key(const BuildArgs& a, int bi, int i) {
  const long long be = static_cast<long long>(bi) * a.e + i;
  const int d = __ldg(a.dst + be * a.dst_stride);
  bool live = d >= 0 && d < a.n;
  if (a.src != nullptr) {
    const int s = __ldg(a.src + be * a.src_stride);
    live = live && s >= 0 && s < a.n;
  }
  return live ? d : -1;
}

__global__ void __launch_bounds__(kThreads) build_kernel(BuildArgs a) {
  extern __shared__ int keys[];     // pass 1's keys, the first kKeyCache
  __shared__ int cnt[kRange], start[kRange], wsum[kWarps];
  __shared__ int run[kWarps][kRange + 1];   // per warp and destination
  const int bi = blockIdx.y, n = a.n, e = a.e;
  const int d_lo = blockIdx.x * kRange, d_hi = min(d_lo + kRange, n);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const unsigned lt = (1u << lane) - 1u;
  for (int x = tid; x < kRange; x += kThreads) cnt[x] = 0;
  for (int x = tid; x < kWarps * (kRange + 1); x += kThreads)
    (&run[0][0])[x] = 0;
  __syncthreads();

  // pass 1: the range's counts, and the live edges into lower destinations
  int below = 0;
  for (int k = tid; k < e; k += kThreads) {
    const int key = edge_key(a, bi, k);
    if (k < kKeyCache) keys[k] = key;
    below += key >= 0 && key < d_lo;
    if (key >= d_lo && key < d_hi) atomicAdd(&cnt[key - d_lo], 1);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    below += __shfl_down_sync(kFull, below, off);
  if (lane == 0) wsum[warp] = below;
  __syncthreads();
  below = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) below += wsum[w];
  if (warp == 0) {   // exclusive scan of the counts, kRange / 32 a lane
    constexpr int kPer = kRange / 32;
    int c[kPer], sum = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      c[j] = cnt[lane * kPer + j];
      sum += c[j];
    }
    int x = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    x -= sum;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      start[lane * kPer + j] = x;
      x += c[j];
    }
  }
  __syncthreads();
  int* rp = a.rowptr + static_cast<long long>(bi) * (n + 1);
  for (int x = tid; x < d_hi - d_lo; x += kThreads) {
    const int d = d_lo + x, s0 = below + start[x];
    rp[d] = s0;
    if (a.counters == nullptr || cnt[x] <= a.chunk) continue;
    for (int s = 0; s < a.slices; ++s)
      a.counters[(static_cast<long long>(bi) * n + d) * a.slices + s] = 0;
    const int nch = (s0 + cnt[x] - 1) / a.chunk - s0 / a.chunk + 1;
    for (int c = 0; c < nch; c += a.group) {
      const long long head =
          (static_cast<long long>(bi) * a.cells + s0 / a.chunk + c) * 2 +
          (c == 0 && s0 % a.chunk != 0);
      for (int s = 0; s < a.slices; ++s)
        a.group_counters[head * a.slices + s] = 0;
    }
  }
  const long long row0 = static_cast<long long>(bi) * e;
  const int total_in = start[kRange - 1] + cnt[kRange - 1];
  if (d_hi == n) {   // the last range: the row's count, perm's tail
    if (tid == 0) rp[n] = below + total_in;
    if (a.perm != nullptr)
      for (int k = below + total_in + tid; k < e; k += kThreads)
        a.perm[row0 + k] = -1;
  }

  // pass 2: warp w walks a contiguous run of the edges, 32 at a time in
  // edge order; run[w][d] counts the run's edges into d, then, after a
  // prefix over the warps, is the place of the next of them
  const int per = (e + kWarps - 1) / kWarps;
  const int lo = min(warp * per, e), hi = min(lo + per, e);
  auto key_at = [&](int k) {
    return k < kKeyCache ? keys[k] : edge_key(a, bi, k);
  };
  // the edges of lanes whose destination is lk, as a mask: one ballot a bit
  auto group = [&](unsigned live, int lk) {
#pragma unroll
    for (int bit = 0; bit < kRangeBits; ++bit) {
      const unsigned set = __ballot_sync(kFull, (lk >> bit) & 1);
      live &= (lk >> bit) & 1 ? set : ~set;
    }
    return live;
  };
  for (int base = lo; base < hi; base += 32) {
    const int k = base + lane;
    const int key = k < hi ? key_at(k) : -1;
    const bool in = key >= d_lo && key < d_hi;
    const unsigned m = __ballot_sync(kFull, in);
    if (m == 0) continue;
    const int lk = in ? key - d_lo : 0;
    const unsigned peers = group(m, lk);
    if (in && lane == __ffs(peers) - 1) run[warp][lk] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int d = warp; d < kRange; d += kWarps) {   // lane: the warp index
    const int v = run[lane][d];
    int x = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    run[lane][d] = start[d] + x - v;
  }
  __syncthreads();
  for (int base = lo; base < hi; base += 32) {
    const int k = base + lane;
    const int key = k < hi ? key_at(k) : -1;
    const bool in = key >= d_lo && key < d_hi;
    const unsigned m = __ballot_sync(kFull, in);
    if (m == 0) continue;
    const int lk = in ? key - d_lo : 0;
    const unsigned peers = group(m, lk);
    const int place = in ? run[warp][lk] + __popc(peers & lt) : 0;
    __syncwarp();
    if (in && lane == __ffs(peers) - 1) run[warp][lk] += __popc(peers);
    __syncwarp();
    if (in) {   // global stores: no wait on them before the next shared read
      const long long at = row0 + below + place;
      if (a.perm != nullptr) __stcg(a.perm + at, k);
      if (a.csr_row != nullptr) {
        __stcg(a.csr_row + at,
               a.src != nullptr
                   ? bi * n + __ldg(a.src + (row0 + k) * a.src_stride)
                   : static_cast<int>(row0 + k));
        __stcg(a.csr_w + at, a.em != nullptr ? __ldg(a.em + row0 + k) : 1.0f);
        __stcg(a.csr_dst + at, key);
      }
    }
  }
}

// One launch of the build over a.b rows.
inline cudaError_t launch_build(const BuildArgs& a, cudaStream_t s) {
  if (a.b <= 0) return cudaSuccess;
  if (a.b > 65535) return cudaErrorInvalidValue;
  const dim3 grid(a.n > 0 ? (a.n + kRange - 1) / kRange : 1, a.b);
  const size_t cache = sizeof(int) * (a.e < kKeyCache ? a.e : kKeyCache);
  build_kernel<<<grid, kThreads, cache, s>>>(a);
  return cudaGetLastError();
}

}  // namespace csr
