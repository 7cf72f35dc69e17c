// Per-graph pooled readout over the packed flat node axis, and its
// gradient, for Hopper (sm_90a), float32 throughout.
//
// Replaces the TPU kernel `segment_readout_pallas` / `_seg_readout_kernel` in
// src/repro/kernels/segment_spmm.py. Semantics are those of
// `segment_readout_ref` (src/repro/kernels/ref.py). A row is real when its
// mask value w = node_mask[i] is > 0; over the real rows of graph g,
//
//   sum[g] = sum_i w_i * h[i],   cnt[g] = sum_i w_i,   max[g] = max_i h[i],
//   out[g] = sum[g] / max(cnt[g], 1)                   (kind "mean", [G, F])
//   out[g] = mean[g] ++ (cnt[g] > 0 ? max[g] : 0)      (kind "mean_max", [G, 2F])
//
// and the max starts at -FLT_MAX (finfo.min), as the plain version and the
// Pallas kernel do. A NaN of a real row reaches the sum, the mean and the
// max. A row with w <= 0 (or NaN) is never read: it adds nothing, not
// even 0 * h, so a non-finite value in a masked row does not reach its
// graph (the plain version's 0 * NaN does; the packed layout never holds
// one, since every layer writes its padded rows as 0). A real row whose id
// falls outside [0, G) is dropped, as jax.ops.segment_sum drops it.
//
// The gradient (segment_readout_backward), with g_mean / g_max the halves
// of the incoming gradient of graph gid_i, and ties[g] the real rows that
// equal max[g], column by column:
//
//   dh[i] = w_i * (g_mean / max(cnt, 1)) + eq_i * (g_max / max(ties, 1))
//
// with eq_i = 1.0f or 0.0f multiplied in, as the plain version writes it;
// a row that is not real, or whose id is outside [0, G), reads 0.
//
// Design. One launch each way; each output element is written once, by
// plain stores: no fill, no scratch in device memory, no float atomic, and
// the same bits run to run.
//
//   * Every block stages a key per row in shared memory (the id of a real
//     row, INT_MIN for the others) and checks, from the same loads, the
//     packed layout's contract: the real rows form a prefix whose ids do
//     not decrease. Every block reads the same rows, so all take the same
//     route.
//   * Runs (the contract holds, as collate_packed lays a bin out): a block
//     owns (graph, 128-column tile) pairs, the pairs blockIdx.x,
//     blockIdx.x + gridDim.x, ... Its warps find each pair's rows
//     [start, end) by a search of the staged keys, 16 probes a round for
//     each end. A graph of at most
//     kWindow rows is one warp's: its rows are added in ascending order, so
//     its sum is the plain version's sequential index_add_ sum bit for bit.
//     A longer one is cut into nw = min(kWarps, ceil(n / kWindow)) pieces of
//     ceil(n / nw) rows, one warp each, summed in ascending order; warp 0
//     adds the pieces' sums and counts in piece order from shared memory.
//   * General (ids in any order, a masked row inside the real ones): one
//     warp a pair, walking all P keys in ascending order, a ballot of 32 at a
//     time. Slow; off the main path.
//   * Lanes lie along the tile's columns, four each: float4 loads where F is
//     a multiple of 4 and the arrays are 16-byte aligned, else four floats
//     32 apart. A warp keeps kUnroll rows' loads in flight.
//   * Block 0 adds the route it took to the caller's integer counters
//     (routes[0..1] forward, routes[2..3] backward). Integer atomics only.
//
// The gradient runs the same way: per pair the count and the ties (a first
// pass, pieces added in the forward's order), then every row of the graph
// written once (a second pass over the same rows); the rows of no graph are
// zeroed by a grid-stride loop. It builds no CSR and calls no other kernel.
//
// What bounds it on the H100: bytes. At the engine's full bin (P=4096,
// 4,095 real rows, F=512, G=256) the forward reads 8.4 MB of h and 32 KB
// of ids and mask and writes 1 MB, about 2.8 us at 3.35 TB/s; every block
// reads the 32 KB again from L2 to stage its keys.
//
// Tolerance: the sums are float32 in the order above; the plain version's
// index_add_ on the card adds with atomics, so the kernel holds it to
// 1e-4 + 1e-4 relative, and the CPU's to the same bits for a graph of at
// most kWindow rows. The max is exact and keeps NaN where the plain version
// does.

#include <cfloat>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 128;           // columns of a (graph, tile) pair
constexpr int kWindow = 16;          // rows one warp sums alone
constexpr int kUnroll = 8;           // rows a warp keeps in flight
constexpr int kBatch = 256;          // pairs a block searches at once
constexpr int kStageRows = 32768;    // keys staged in shared memory up to this P
constexpr int kMasked = INT_MIN;     // the key of a row that is not real
constexpr unsigned kFull = 0xffffffffu;
enum { kRuns = 0, kGeneral = 1 };

struct Args {
  const float* h;     // [P, F]
  const int* gid;     // [P]
  const float* nm;    // [P]
  const float* z;     // [G, width]: the forward's output (backward, max)
  const float* gz;    // [G, width]: the incoming gradient (backward)
  float* out;         // [G, width] forward; dh [P, F] backward
  unsigned long long* routes;
  int p, f, g, tiles, width;
  bool want_max;
};

// Shared memory: partials of kWarps pieces, the pair ranges of a batch, and
// the keys. The backward reuses the sum area for its ties (ints) and for
// the per-pair factors a and b.
struct Smem {
  float* sum;   // [kWarps][kTile]
  float* mx;    // [kWarps][kTile]
  float* cnt;   // [kWarps]
  int* lo;      // [kBatch]
  int* hi;      // [kBatch]
  int* meta;    // [4]
  int* keys;    // [P] where staged
};

constexpr size_t kFixedWords = 2 * kWarps * kTile + 32 + 2 * kBatch + 4;

__device__ __forceinline__ Smem carve(float4* base) {
  Smem s;
  s.sum = reinterpret_cast<float*>(base);
  s.mx = s.sum + kWarps * kTile;
  s.cnt = s.mx + kWarps * kTile;
  s.lo = reinterpret_cast<int*>(s.cnt + 32);
  s.hi = s.lo + kBatch;
  s.meta = s.hi + kBatch;
  s.keys = s.meta + 4;
  return s;
}

// The max in which a NaN wins, as the plain version's amax keeps it.
__device__ __forceinline__ float max_nan(float m, float v) {
  return (v > m || v != v) ? v : m;
}

__device__ __forceinline__ int key_of(const int* gid, const float* nm, int i) {
  return __ldg(nm + i) > 0.0f ? __ldg(gid + i) : kMasked;
}

struct Keys {
  const int* gid;
  const float* nm;
  const int* staged;   // shared memory, or null: computed from gid and nm
  __device__ __forceinline__ int operator()(int i) const {
    return staged != nullptr ? staged[i] : key_of(gid, nm, i);
  }
};

// Stages the keys (where they fit) and checks the contract; returns the
// route, and in p_real the end of the last real row. A thread takes four
// rows at a time (int4 / float4 loads where they are aligned) and the row
// after them, every load issued at once. On the runs route the same pass
// bounds the rows with an id in [0, G) (meta[1], meta[2]: the first real
// row with an id >= 0 and the first with an id >= G, INT_MAX for none),
// which the gradient zeroes around; the general route does not read them.
__device__ __forceinline__ int stage(const Args& a, const Smem& s, bool staged, int& p_real) {
  if (threadIdx.x == 0) {
    s.meta[0] = 0;
    s.meta[1] = s.meta[2] = INT_MAX;
  }
  int viol = 0, last = 0, first_in = INT_MAX, first_past = INT_MAX;
  const bool v4 = a.p % 4 == 0 && reinterpret_cast<size_t>(a.gid) % 16 == 0 &&
                  reinterpret_cast<size_t>(a.nm) % 16 == 0;
#pragma unroll 2
  for (int i0 = threadIdx.x * 4; i0 < a.p; i0 += kThreads * 4) {
    int id[5];
    float w[5];
    if (v4) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(a.gid + i0));
      const float4 y = __ldg(reinterpret_cast<const float4*>(a.nm + i0));
      id[0] = x.x; id[1] = x.y; id[2] = x.z; id[3] = x.w;
      w[0] = y.x; w[1] = y.y; w[2] = y.z; w[3] = y.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        id[j] = i0 + j < a.p ? __ldg(a.gid + i0 + j) : 0;
        w[j] = i0 + j < a.p ? __ldg(a.nm + i0 + j) : 0.0f;
      }
    }
    id[4] = i0 + 4 < a.p ? __ldg(a.gid + i0 + 4) : 0;
    w[4] = i0 + 4 < a.p ? __ldg(a.nm + i0 + 4) : 0.0f;
    int k[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) k[j] = w[j] > 0.0f ? id[j] : kMasked;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i0 + j >= a.p) break;
      if (staged) s.keys[i0 + j] = k[j];
      if (k[j] != kMasked) last = i0 + j + 1;
      if (k[j + 1] != kMasked && (k[j] == kMasked || k[j + 1] < k[j])) viol = 1;
      if (k[j] != kMasked && k[j] >= 0) first_in = min(first_in, i0 + j);
      if (k[j] != kMasked && k[j] >= a.g) first_past = min(first_past, i0 + j);
    }
  }
  viol = __syncthreads_or(viol);
  last = __reduce_max_sync(kFull, last);
  first_in = __reduce_min_sync(kFull, first_in);
  first_past = __reduce_min_sync(kFull, first_past);
  if ((threadIdx.x & 31) == 0) {
    atomicMax(s.meta, last);
    atomicMin(s.meta + 1, first_in);
    atomicMin(s.meta + 2, first_past);
  }
  __syncthreads();
  p_real = s.meta[0];
  const int route = viol ? kGeneral : kRuns;
  if (blockIdx.x == 0 && threadIdx.x == 0 && a.routes != nullptr)
    atomicAdd(a.routes + route, 1ull);
  return route;
}

// The rows [lo, hi) of graph g among the first n keys (not decreasing), by
// a warp: lanes 0-15 look for the first key >= g, lanes 16-31 for the
// first key >= g + 1, each half with 16 probes a round.
__device__ __forceinline__ void warp_range(const Keys& keys, int n, int g, int lane,
                                           int& lo_out, int& hi_out) {
  const int half = lane >> 4, hl = lane & 15;
  const int target = g + half;
  const unsigned mine = half ? 0xffff0000u : 0x0000ffffu;
  int lo = 0, hi = n;
  while (__any_sync(kFull, hi - lo > 16)) {
    const int step = (hi - lo + 15) / 16;
    const int pos = lo + hl * step;
    const bool less = step > 0 && pos < hi && keys(pos) < target;
    const int c = __popc(__ballot_sync(kFull, less) & mine);
    const int nlo = c == 0 ? lo : lo + (c - 1) * step + 1;
    hi = min(hi, lo + c * step);
    lo = nlo;
  }
  const int pos = lo + hl;
  const bool less = pos < hi && keys(pos) < target;
  const int found = lo + __popc(__ballot_sync(kFull, less) & mine);
  lo_out = __shfl_sync(kFull, found, 0);
  hi_out = __shfl_sync(kFull, found, 16);
}

// A lane's columns of a tile: four consecutive (kVec) or four 32 apart;
// tile_col is the place of the lane's j-th column in the tile.
template <bool kVec>
__device__ __forceinline__ int tile_col(int lane, int j) {
  return kVec ? lane * 4 + j : lane + 32 * j;
}

template <bool kVec>
__device__ __forceinline__ void load_cols(const float* row, int c0, int f,
                                          int lane, float v[4]) {
  if (kVec) {
    const int col = c0 + lane * 4;
    if (col < f) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(row + col));
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.0f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + lane + 32 * j;
      v[j] = col < f ? __ldg(row + col) : 0.0f;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store_cols(float* row, int c0, int f, int lane,
                                           const float v[4]) {
  if (kVec) {
    const int col = c0 + lane * 4;
    if (col < f)
      *reinterpret_cast<float4*>(row + col) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + lane + 32 * j;
      if (col < f) row[col] = v[j];
    }
  }
}

// A running (sum, count, max) of a lane's four columns.
struct Acc {
  float s[4], m[4], c;
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < 4; ++j) { s[j] = 0.0f; m[j] = -FLT_MAX; }
    c = 0.0f;
  }
  // w * h rounded, then added: the plain version's h * w[:, None] and
  // index_add_, with no contraction into an FMA
  __device__ __forceinline__ void add(const float v[4], float w) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = __fadd_rn(s[j], __fmul_rn(v[j], w));
      m[j] = max_nan(m[j], v[j]);
    }
    c = __fadd_rn(c, w);
  }
};

// Adds rows[0..n) (n <= kUnroll) in order, every load issued first.
template <bool kVec>
__device__ __forceinline__ void add_rows(const Args& a, const int rows[kUnroll],
                                         int n, int c0, int lane, Acc& acc) {
  float v[kUnroll][4], w[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (u < n) {
      w[u] = __ldg(a.nm + rows[u]);
      load_cols<kVec>(a.h + static_cast<long long>(rows[u]) * a.f, c0, a.f,
                      lane, v[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (u < n) acc.add(v[u], w[u]);
}

// Adds the rows [r0, r1) in ascending order.
template <bool kVec>
__device__ __forceinline__ void add_range(const Args& a, int r0, int r1, int c0,
                                          int lane, Acc& acc) {
  for (int r = r0; r < r1; r += kUnroll) {
    int rows[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) rows[u] = r + u;
    add_rows<kVec>(a, rows, min(kUnroll, r1 - r), c0, lane, acc);
  }
}

// Calls fn(rows, n) for the rows whose key is g, in ascending order, up to
// kUnroll at a time: the general route's walk over all P keys.
template <typename Fn>
__device__ __forceinline__ void walk_rows(const Keys& keys, int p, int g, int lane,
                                          Fn&& fn) {
  for (int base = 0; base < p; base += 32) {
    const int i = base + lane;
    unsigned m = __ballot_sync(kFull, i < p && keys(i) == g);
    while (m) {
      int rows[kUnroll];
      int n = 0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        rows[u] = base + (m ? __ffs(m) - 1 : 0);
        if (m) { m &= m - 1; ++n; }
      }
      fn(rows, n);
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void write_out(const Args& a, int g, int c0, int lane,
                                          const Acc& acc) {
  const float d = fmaxf(acc.c, 1.0f);
  float mean[4], mx[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mean[j] = __fdiv_rn(acc.s[j], d);
    mx[j] = acc.c > 0.0f ? acc.m[j] : 0.0f;
  }
  float* row = a.out + static_cast<long long>(g) * a.width;
  store_cols<kVec>(row, c0, a.f, lane, mean);
  if (a.want_max) store_cols<kVec>(row + a.f, c0, a.f, lane, mx);
}

// The pieces of a pair of n rows: nw warps of c rows each.
__device__ __forceinline__ void pieces(int n, int& nw, int& c) {
  nw = n <= kWindow ? 1 : min(kWarps, (n + kWindow - 1) / kWindow);
  c = (n + nw - 1) / nw;
}

// Searches the ranges of a batch of this block's pairs into s.lo / s.hi.
__device__ __forceinline__ void search_batch(const Args& a, const Smem& s, const Keys& keys,
                             int p_real, int b0, int nb, int warp,
                             int lane) {
  for (int k = warp; k < nb; k += kWarps) {
    int lo, hi;
    warp_range(keys, p_real, (blockIdx.x + (b0 + k) * gridDim.x) / a.tiles,
               lane, lo, hi);
    if (lane == 0) { s.lo[k] = lo; s.hi[k] = hi; }
  }
  __syncthreads();
}

// The pairs of this block, blockIdx.x + k * gridDim.x; the wrapper keeps
// G * tiles below 2^31.
__device__ __forceinline__ int my_pairs(int pairs) {
  return pairs > static_cast<int>(blockIdx.x)
             ? (pairs - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1 : 0;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1) readout_kernel(Args a) {
  extern __shared__ float4 smem[];
  const Smem s = carve(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool staged = a.p <= kStageRows;
  const Keys keys{a.gid, a.nm, staged ? s.keys : nullptr};
  int p_real;
  const int route = stage(a, s, staged, p_real);
  const int pairs = a.g * a.tiles;

  if (route == kGeneral) {
    for (int pair = blockIdx.x * kWarps + warp; pair < pairs;
         pair += gridDim.x * kWarps) {
      const int g = pair / a.tiles;
      const int c0 = (pair - g * a.tiles) * kTile;
      Acc acc;
      acc.init();
      walk_rows(keys, a.p, g, lane, [&](const int* rows, int n) {
        add_rows<kVec>(a, rows, n, c0, lane, acc);
      });
      write_out<kVec>(a, g, c0, lane, acc);
    }
    return;
  }

  const int mine = my_pairs(pairs);
  for (int b0 = 0; b0 < mine; b0 += kBatch) {
    const int nb = min(kBatch, mine - b0);
    search_batch(a, s, keys, p_real, b0, nb, warp, lane);
    // a graph longer than one window: the block's warps, pieces in order
    for (int k = 0; k < nb; ++k) {
      const int lo = s.lo[k], n = s.hi[k] - lo;
      if (n <= kWindow) continue;
      const int pair = blockIdx.x + (b0 + k) * gridDim.x;
      const int g = pair / a.tiles;
      const int c0 = (pair - g * a.tiles) * kTile;
      int nw, c;
      pieces(n, nw, c);
      if (warp < nw) {
        Acc acc;
        acc.init();
        const int r0 = lo + warp * c;
        add_range<kVec>(a, r0, min(lo + n, r0 + c), c0, lane, acc);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s.sum[warp * kTile + tile_col<kVec>(lane, j)] = acc.s[j];
          s.mx[warp * kTile + tile_col<kVec>(lane, j)] = acc.m[j];
        }
        if (lane == 0) s.cnt[warp] = acc.c;
      }
      __syncthreads();
      if (warp == 0) {
        Acc acc;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc.s[j] = s.sum[tile_col<kVec>(lane, j)];
          acc.m[j] = s.mx[tile_col<kVec>(lane, j)];
        }
        acc.c = s.cnt[0];
        for (int w = 1; w < nw; ++w) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc.s[j] = __fadd_rn(acc.s[j], s.sum[w * kTile + tile_col<kVec>(lane, j)]);
            acc.m[j] = max_nan(acc.m[j], s.mx[w * kTile + tile_col<kVec>(lane, j)]);
          }
          acc.c = __fadd_rn(acc.c, s.cnt[w]);
        }
        write_out<kVec>(a, g, c0, lane, acc);
      }
      __syncthreads();
    }
    // a graph of at most one window (or none): one warp
    for (int k = warp; k < nb; k += kWarps) {
      const int lo = s.lo[k], n = s.hi[k] - lo;
      if (n > kWindow) continue;
      const int pair = blockIdx.x + (b0 + k) * gridDim.x;
      const int g = pair / a.tiles;
      const int c0 = (pair - g * a.tiles) * kTile;
      Acc acc;
      acc.init();
      add_range<kVec>(a, lo, lo + n, c0, lane, acc);
      write_out<kVec>(a, g, c0, lane, acc);
    }
    __syncthreads();   // before the next batch reuses lo / hi
  }
}

// ---------------------------------------------------------------------------
// the gradient
// ---------------------------------------------------------------------------

// A lane's share of a pair's count and ties (the forward's order for the
// count; ties are integers, so any order).
struct Ties {
  int t[4];
  float c;
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < 4; ++j) t[j] = 0;
    c = 0.0f;
  }
};

template <bool kVec>
__device__ __forceinline__ void count_rows(const Args& a, const int rows[kUnroll],
                                           int n, int c0, int lane,
                                           const float zmax[4], Ties& t) {
  float v[kUnroll][4], w[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (u < n) {
      w[u] = __ldg(a.nm + rows[u]);
      if (a.want_max)
        load_cols<kVec>(a.h + static_cast<long long>(rows[u]) * a.f, c0, a.f,
                        lane, v[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (u < n) {
      t.c = __fadd_rn(t.c, w[u]);
      if (a.want_max) {
#pragma unroll
        for (int j = 0; j < 4; ++j) t.t[j] += v[u][j] == zmax[j];
      }
    }
  }
}

// dh of rows[0..n): w * fa + eq * fb, each row written once.
template <bool kVec>
__device__ __forceinline__ void grad_rows(const Args& a, const int rows[kUnroll],
                                          int n, int c0, int lane,
                                          const float zmax[4], const float fa[4],
                                          const float fb[4]) {
  float v[kUnroll][4], w[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (u < n) {
      w[u] = __ldg(a.nm + rows[u]);
      if (a.want_max)
        load_cols<kVec>(a.h + static_cast<long long>(rows[u]) * a.f, c0, a.f,
                        lane, v[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (u < n) {
      float d[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        d[j] = __fmul_rn(w[u], fa[j]);
        if (a.want_max)
          d[j] = __fadd_rn(d[j], __fmul_rn(v[u][j] == zmax[j] ? 1.0f : 0.0f,
                                           fb[j]));
      }
      store_cols<kVec>(a.out + static_cast<long long>(rows[u]) * a.f, c0, a.f,
                       lane, d);
    }
  }
}

// The factors of a pair from its count and ties: g_mean / max(cnt, 1) and
// g_max / max(ties, 1), and the max each row is compared with.
template <bool kVec>
__device__ __forceinline__ void pair_factors(const Args& a, int g, int c0,
                                             int lane, const float zmax[4],
                                             float cnt, const int ties[4],
                                             float fa[4], float fb[4]) {
  const float* gr = a.gz + static_cast<long long>(g) * a.width;
  float gm[4], gx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  load_cols<kVec>(gr, c0, a.f, lane, gm);
  if (a.want_max) load_cols<kVec>(gr + a.f, c0, a.f, lane, gx);
  const float d = fmaxf(cnt, 1.0f);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    fa[j] = __fdiv_rn(gm[j], d);
    fb[j] = __fdiv_rn(gx[j], fmaxf(static_cast<float>(ties[j]), 1.0f));
  }
}

template <bool kVec>
__device__ __forceinline__ void load_zmax(const Args& a, int g, int c0, int lane,
                                          float zmax[4]) {
  if (a.want_max) {
    load_cols<kVec>(a.z + static_cast<long long>(g) * a.width + a.f, c0, a.f,
                    lane, zmax);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) zmax[j] = 0.0f;
  }
}

// Zeroes dh's rows [r0, r1) with every thread of the grid.
template <bool kVec>
__device__ __forceinline__ void zero_rows(const Args& a, long long r0, long long r1) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (kVec) {
    float4* base = reinterpret_cast<float4*>(a.out + r0 * a.f);
    const long long n4 = (r1 - r0) * a.f / 4;
    for (long long i = first; i < n4; i += stride)
      base[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    float* base = a.out + r0 * a.f;
    const long long n = (r1 - r0) * a.f;
    for (long long i = first; i < n; i += stride) base[i] = 0.0f;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1) readout_backward_kernel(Args a) {
  extern __shared__ float4 smem[];
  const Smem s = carve(smem);
  int* s_ties = reinterpret_cast<int*>(s.sum);   // [kWarps][kTile]
  float* s_fa = s.mx;                            // [kTile]
  float* s_fb = s.mx + kTile;                    // [kTile]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool staged = a.p <= kStageRows;
  const Keys keys{a.gid, a.nm, staged ? s.keys : nullptr};
  int p_real;
  const int route = stage(a, s, staged, p_real);
  const int pairs = a.g * a.tiles;

  if (route == kGeneral) {
    // the rows of no graph
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
         i < static_cast<long long>(a.p) * a.f; i += stride) {
      const int k = keys(static_cast<int>(i / a.f));
      if (k < 0 || k >= a.g) a.out[i] = 0.0f;
    }
    for (int pair = blockIdx.x * kWarps + warp; pair < pairs;
         pair += gridDim.x * kWarps) {
      const int g = pair / a.tiles;
      const int c0 = (pair - g * a.tiles) * kTile;
      float zmax[4], fa[4], fb[4];
      load_zmax<kVec>(a, g, c0, lane, zmax);
      Ties t;
      t.init();
      walk_rows(keys, a.p, g, lane, [&](const int* rows, int n) {
        count_rows<kVec>(a, rows, n, c0, lane, zmax, t);
      });
      pair_factors<kVec>(a, g, c0, lane, zmax, t.c, t.t, fa, fb);
      walk_rows(keys, a.p, g, lane, [&](const int* rows, int n) {
        grad_rows<kVec>(a, rows, n, c0, lane, zmax, fa, fb);
      });
    }
    return;
  }

  // the rows of no graph: ids below 0 or from G on, then the masked tail
  const int lo0 = min(s.meta[1], p_real), hi0 = min(s.meta[2], p_real);
  zero_rows<kVec>(a, 0, lo0);
  zero_rows<kVec>(a, hi0, a.p);

  const int mine = my_pairs(pairs);
  for (int b0 = 0; b0 < mine; b0 += kBatch) {
    const int nb = min(kBatch, mine - b0);
    search_batch(a, s, keys, p_real, b0, nb, warp, lane);
    for (int k = 0; k < nb; ++k) {
      const int lo = s.lo[k], n = s.hi[k] - lo;
      if (n <= kWindow) continue;
      const int pair = blockIdx.x + (b0 + k) * gridDim.x;
      const int g = pair / a.tiles;
      const int c0 = (pair - g * a.tiles) * kTile;
      int nw, c;
      pieces(n, nw, c);
      float zmax[4];
      load_zmax<kVec>(a, g, c0, lane, zmax);
      const int r0 = lo + warp * c, r1 = min(lo + n, r0 + c);
      if (warp < nw) {
        Ties t;
        t.init();
        for (int r = r0; r < r1; r += kUnroll) {
          int rows[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) rows[u] = r + u;
          count_rows<kVec>(a, rows, min(kUnroll, r1 - r), c0, lane, zmax, t);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) s_ties[warp * kTile + tile_col<kVec>(lane, j)] = t.t[j];
        if (lane == 0) s.cnt[warp] = t.c;
      }
      __syncthreads();
      if (warp == 0) {
        int ties[4];
        float cnt = s.cnt[0];
#pragma unroll
        for (int j = 0; j < 4; ++j) ties[j] = s_ties[tile_col<kVec>(lane, j)];
        for (int w = 1; w < nw; ++w) {
#pragma unroll
          for (int j = 0; j < 4; ++j) ties[j] += s_ties[w * kTile + tile_col<kVec>(lane, j)];
          cnt = __fadd_rn(cnt, s.cnt[w]);
        }
        float fa[4], fb[4];
        pair_factors<kVec>(a, g, c0, lane, zmax, cnt, ties, fa, fb);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s_fa[tile_col<kVec>(lane, j)] = fa[j];
          s_fb[tile_col<kVec>(lane, j)] = fb[j];
        }
      }
      __syncthreads();
      if (warp < nw) {
        float fa[4], fb[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          fa[j] = s_fa[tile_col<kVec>(lane, j)];
          fb[j] = s_fb[tile_col<kVec>(lane, j)];
        }
        for (int r = r0; r < r1; r += kUnroll) {
          int rows[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) rows[u] = r + u;
          grad_rows<kVec>(a, rows, min(kUnroll, r1 - r), c0, lane, zmax, fa, fb);
        }
      }
      __syncthreads();
    }
    for (int k = warp; k < nb; k += kWarps) {
      const int lo = s.lo[k], n = s.hi[k] - lo;
      if (n > kWindow || n == 0) continue;
      const int pair = blockIdx.x + (b0 + k) * gridDim.x;
      const int g = pair / a.tiles;
      const int c0 = (pair - g * a.tiles) * kTile;
      float zmax[4], fa[4], fb[4];
      load_zmax<kVec>(a, g, c0, lane, zmax);
      Ties t;
      t.init();
      for (int r = lo; r < lo + n; r += kUnroll) {
        int rows[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) rows[u] = r + u;
        count_rows<kVec>(a, rows, min(kUnroll, lo + n - r), c0, lane, zmax, t);
      }
      pair_factors<kVec>(a, g, c0, lane, zmax, t.c, t.t, fa, fb);
      for (int r = lo; r < lo + n; r += kUnroll) {
        int rows[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) rows[u] = r + u;
        grad_rows<kVec>(a, rows, min(kUnroll, lo + n - r), c0, lane, zmax, fa, fb);
      }
    }
    __syncthreads();
  }
}

size_t smem_bytes(int p) {
  return (kFixedWords + (p <= kStageRows ? static_cast<size_t>(p) : 0)) * 4;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

template <typename Kernel>
int launch(Kernel kernel, const Args& a, long long blocks, void* stream) {
  const size_t bytes = smem_bytes(a.p);
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const long long grid = blocks < 1 ? 1 : (blocks < sms ? blocks : sms);
  kernel<<<static_cast<unsigned>(grid), kThreads, bytes,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const float* h, const int* gid, const float* nm, const float* z,
               const float* gz, float* out, unsigned long long* routes, int p,
               int f, int g, int want_max) {
  Args a;
  a.h = h; a.gid = gid; a.nm = nm; a.z = z; a.gz = gz; a.out = out;
  a.routes = routes;
  a.p = p; a.f = f; a.g = g;
  a.tiles = (f + kTile - 1) / kTile;
  a.want_max = want_max != 0;
  a.width = a.want_max ? 2 * f : f;
  return a;
}

}  // namespace

extern "C" {

// The readout in one launch: out [G, F] (want_max 0) or [G, 2F], each element
// written once. routes: 4 unsigned 64-bit counters on the device (forward
// runs, general; backward runs, general) or null. vec: F % 4 == 0 and h, out
// 16-byte aligned. Returns the cudaError_t of the launch.
int segment_readout(const float* h, const int* gid, const float* nm, float* out,
                    unsigned long long* routes, int p, int f, int g,
                    int want_max, int vec, void* stream) {
  if (f <= 0 || g <= 0) return 0;
  const Args a = make_args(h, gid, nm, nullptr, nullptr, out, routes, p, f, g,
                           want_max);
  const long long pairs = static_cast<long long>(g) * a.tiles;
  return vec ? launch(readout_kernel<true>, a, pairs, stream)
             : launch(readout_kernel<false>, a, pairs, stream);
}

// The readout's gradient in one launch: dh [P, F] from h, the ids and mask,
// the forward's output z and the incoming gradient gz (both [G, width]; z is
// read for its max half only), every element written once. The counters
// at routes + 2. vec: F % 4 == 0 and h, z, gz, dh 16-byte aligned. Returns
// the cudaError_t of the launch.
int segment_readout_backward(const float* h, const int* gid, const float* nm,
                             const float* z, const float* gz, float* dh,
                             unsigned long long* routes, int p, int f, int g,
                             int want_max, int vec, void* stream) {
  if (p <= 0 || f <= 0) return 0;
  const Args a = make_args(h, gid, nm, z, gz, dh,
                           routes == nullptr ? nullptr : routes + 2, p, f, g,
                           want_max);
  const long long pairs = static_cast<long long>(g) * a.tiles;
  const long long blocks = pairs > 0 ? pairs : 1;
  return vec ? launch(readout_backward_kernel<true>, a, blocks, stream)
             : launch(readout_backward_kernel<false>, a, blocks, stream);
}

}  // extern "C"
