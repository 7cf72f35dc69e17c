// Dense neighbourhood aggregation for Hopper (sm_90a), float32 throughout.
//
// Replaces the TPU kernel `dense_aggregate_pallas` / `_sage_kernel` in
// src/repro/kernels/sage_spmm.py (`sage_aggregate_pallas` wraps it).
// Semantics are those of `dense_aggregate_ref` (src/repro_torch/kernels/ref.py),
// extended by two arguments that make the backward pass the same kernel:
//
//   A'       = adj[b]        (trans = 0)   or   adj[b]^T   (trans = 1)
//   deg[i]   = sum_k A'[i, k]
//   out[b]   = A' @ (s * h[b])              s: per-source-row scale, or 1
//   mean:      out[b, i] /= max(deg[i], 1)
//
// with adj [B, N, N] holding adj[b, dst, src] (weights allowed: GCN passes
// its normalized adjacency) and h [B, N, F]. The forward of a mean layer is
// (trans 0, s 1, mean); its backward is dh = A^T @ (g / max(deg, 1)), which is
// (trans 1, s = 1 / max(deg, 1), sum), with deg written by the forward. The
// normalized adjacency is never materialized, and the division is the
// epilogue's, as the TPU kernel's epilogue divides.
//
// The TPU kernel holds whole in-neighbourhood rows (bn x N) and the source
// block (N x bf) in VMEM for one MXU product per tile, zeros and all.
//
// What bounds it on the H100: bytes. The dense layout's adjacency is mostly
// zeros: at the largest dense training bucket used by chip_smoke.py (B=32,
// N=256, F=512) it holds 7,919 nonzeros of 2,097,152 (0.38 %), at most 5 in
// a row, so the data's own work is 8 MFLOP where the dense product does 2.1
// GFLOP (32 us on the 67 TFLOP/s float32 FMA peak). The least time is that
// of reading adj (8.4 MB) and h (16.8 MB) once and writing out (16.8 MB)
// once: 12.5 us at 3.35 TB/s. Skipping all-zero tiles of a dense product
// would not get there: a random DAG's edges land all over its block, so
// most 128x16 tiles hold a nonzero.
//
// The design, two launches in one C call:
//
// 1. scan_kernel reads A' once. A block stages 8 rows x 256 depths of it in
//    shared memory (rows of adj untransposed, columns transposed, each
//    loaded coalesced); a warp walks a row 32 depths per ballot and
//    compacts its nonzeros in depth order into a list of at most kList
//    (k, value) pairs in global scratch, with the row's nonzero count and
//    its row sum (deg). Blocks are small (1,024 at the training bucket), so
//    that many are resident on every SM while A' streams in.
// 2. aggregate_kernel: one block per (256-row group, 64-column slab, b)
//    writes its outputs once, without atomics. A 128-row strip of the
//    group whose rows all have every nonzero in their lists is sparse: the
//    block stages its slab of s * h (N x 64, 256 rows at a time, cp.async)
//    in shared memory and sums value * (s * h)[k, slab] over each row's
//    list in registers. A strip with a longer row (a hub, a random 10 %
//    adjacency, a weight matrix) is dense and runs the tiled float32 SGEMM
//    of sgemm_tile.cuh over A', as fused_mp.cu's node phase does: 128x64
//    outputs per block of 256 threads, two shared-memory stages, A stored
//    depth-major and loaded in the order that keeps its global reads
//    coalesced. The sparse sums hold their rows as that tile holds a strip,
//    and the choice is the block's own, inside the launch; nothing is read
//    back to the host.
//
// NaN and inf: the dense product multiplies every zero of A' too, so an inf
// or NaN at (s * h)[k, c] makes column c of every output row NaN (0 * inf
// is NaN), whether or not A'[i, k] is zero. A list skips the zeros, so the
// sparse path checks its whole staged slab of s * h and sends both strips
// to the dense path if any element is not finite. A non-finite value of A' is a nonzero
// and sits in its row's list. Over the nonzeros the sparse sum is the dense
// path's fmaf chain in the same depth order, less terms that add exactly 0,
// so both paths give the same floats.
//
// At the training bucket the sparse path moves adj once (the scan), h once
// (one group at N = 256), about 1 MB of lists and counts, and out once. A
// dense strip reads its rows of A' once per column slab, as before, after
// the scan has read them once.
//
// Tolerance: the product sums in another order than the CPU, and the mean is
// taken after the sum rather than on the normalized adjacency, so the result
// agrees with the plain version to about 1e-6 relative at depth 256; the
// tests and chip_smoke.py hold it to 1e-4 absolute + 1e-4 relative. NaN in a
// row of h reaches every output row whose adjacency column there is nonzero
// or zero alike (0 * NaN), as in the plain product.

#include <cuda_runtime.h>

#include "sgemm_tile.cuh"

namespace {

constexpr int kList = 16;         // (k, value) pairs a row's list holds
constexpr int kRows = 2 * kBM;    // output rows of an aggregate block
constexpr int kChunk = 256;       // rows of the h slab staged at a time
constexpr int kScanRows = 8;      // rows of A' a scan block lists
constexpr int kScanDepth = 256;   // depths of A' per shared-memory pass
static_assert(kRows == kThreads, "one row of counts and lists a thread");
// The staged A' rows: [row][depth] with a row padding of 4 untransposed,
// [depth][row] with a padding of 1 transposed (conflict-free ballots).
constexpr int kFwdStride = kScanDepth + 4;
constexpr int kTrStride = kScanRows + 1;
constexpr int kScanTile = kScanDepth * kTrStride;
static_assert(kScanRows * kFwdStride <= kScanTile, "scan tile");

struct Args {
  const float* adj;    // [B, N, N]
  const float* h;      // [B, N, F]
  const float* scale;  // [B, N] per source row, or null
  float* out;          // [B, N, F]
  float* deg;          // [B, N] row sums of A' (written by the scan)
  int2* lists;         // [B, N, kList] (k, value bits), from the scan
  int* count;          // [B, N] nonzeros per row of A', from the scan
  int n, f;
  int mean;
};

// Not inf and not NaN: the exponent bits are not all ones.
__device__ __forceinline__ bool finite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) != 0x7f800000u;
}

// Rows i0 .. i0+31 of A' for batch row blockIdx.y: their lists, counts and
// row sums. kVec loads float4s (N a multiple of 4, adj 16-byte aligned).
// Out-of-range elements stage as 0 and so are never listed.
template <bool kVec, bool kTrans>
__global__ void __launch_bounds__(kThreads) scan_kernel(Args p) {
  __shared__ __align__(16) float tile[kScanTile];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int n = p.n;
  const int i0 = blockIdx.x * kScanRows;
  const long long bz = blockIdx.y;
  const float* adj = p.adj + bz * n * n;
  int cnt[kScanRows / 8];
  float dsum[kScanRows / 8];
#pragma unroll
  for (int j = 0; j < kScanRows / 8; ++j) {
    cnt[j] = 0;
    dsum[j] = 0.0f;
  }
  for (int k0 = 0; k0 < n; k0 += kScanDepth) {
    __syncthreads();   // the previous pass's ballots are done with the tile
    // untransposed, A'[i, k] = adj[i0 + i, k0 + k]; transposed, A'[i, k] =
    // adj[k0 + k, i0 + i]: either way a thread reads along a global row of
    // adj, every load in flight before the first store
    if (kVec) {
      constexpr int kU = kScanRows * kScanDepth / 4 / kThreads;
      float4 v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int x = tid + u * kThreads;
        const int i = kTrans ? 4 * (x % (kScanRows / 4)) : x / (kScanDepth / 4);
        const int k = kTrans ? x / (kScanRows / 4) : 4 * (x % (kScanDepth / 4));
        const int gr = kTrans ? k0 + k : i0 + i;
        const int gc = kTrans ? i0 + i : k0 + k;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gr < n && gc < n)
          v[u] = *reinterpret_cast<const float4*>(
              adj + static_cast<long long>(gr) * n + gc);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int x = tid + u * kThreads;
        if (kTrans) {
          float* t = &tile[(x / (kScanRows / 4)) * kTrStride +
                           4 * (x % (kScanRows / 4))];
          t[0] = v[u].x; t[1] = v[u].y; t[2] = v[u].z; t[3] = v[u].w;
        } else {
          *reinterpret_cast<float4*>(
              &tile[(x / (kScanDepth / 4)) * kFwdStride +
                    4 * (x % (kScanDepth / 4))]) = v[u];
        }
      }
    } else {
      constexpr int kU = kScanRows * kScanDepth / kThreads;
      constexpr int kBatch = 8;
#pragma unroll
      for (int u0 = 0; u0 < kU; u0 += kBatch) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int x = tid + (u0 + u) * kThreads;
          const int i = kTrans ? x % kScanRows : x / kScanDepth;
          const int k = kTrans ? x / kScanRows : x % kScanDepth;
          const int gr = kTrans ? k0 + k : i0 + i;
          const int gc = kTrans ? i0 + i : k0 + k;
          v[u] = (gr < n && gc < n) ? adj[static_cast<long long>(gr) * n + gc]
                                    : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int x = tid + (u0 + u) * kThreads;
          if (kTrans) {
            tile[(x / kScanRows) * kTrStride + x % kScanRows] = v[u];
          } else {
            tile[(x / kScanDepth) * kFwdStride + x % kScanDepth] = v[u];
          }
        }
      }
    }
    __syncthreads();
    // warp w lists rows w, w + 8, ...: independent chains
    const int depth = min(kScanDepth, n - k0);
    for (int kk = 0; kk < depth; kk += 32) {
      const int k = kk + lane;   // < kScanDepth: staged, 0 past the end
#pragma unroll
      for (int j = 0; j < kScanRows / 8; ++j) {
        const int i = warp + 8 * j;
        const float v = kTrans ? tile[k * kTrStride + i] : tile[i * kFwdStride + k];
        const bool nz = v != 0.0f;   // NaN is a nonzero
        const unsigned mask = __ballot_sync(0xffffffffu, nz);
        const int slot = cnt[j] + __popc(mask & ((1u << lane) - 1u));
        if (nz && slot < kList)
          p.lists[(bz * n + i0 + i) * kList + slot] =
              make_int2(k0 + k, __float_as_int(v));
        cnt[j] += __popc(mask);
        dsum[j] += v;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kScanRows / 8; ++j) {
    const int i = i0 + warp + 8 * j;
    float d = dsum[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
    if (lane == 0 && i < n) {
      p.count[bz * n + i] = cnt[j];
      p.deg[bz * n + i] = d;
    }
  }
}

// The sparse path's shared memory: a chunk of the block's slab of h and of
// the row scale, and the lists and counts of its rows.
struct Sparse {
  float hs[kChunk][kBN];
  float sc[kChunk];
  int2 kv[kRows][kList];
  int cnt[kRows];
};

union Smem {
  Tiles tiles;
  Sparse sp;
};
constexpr int kSmemBytes = sizeof(Smem);

// Thread (tx, ty) = (tid % 16, tid / 16) holds output columns 4tx .. 4tx+3
// of the slab and rows row_of(i, ty), i < 16: rows tile_row(i, ty) of the
// first 128-row strip (i < 8) and of the second, as sgemm_tile.cuh's tile
// holds a strip.
__device__ __forceinline__ int row_of(int i, int ty) {
  return kBM * (i / 8) + tile_row(i % 8, ty);
}

// One stage of A (depth kBK x kBM rows) and B (kBK x kBN), held in registers
// between its global loads and its stores to shared memory: eight A values
// and four B values per thread. kVec loads float4s (N and F multiples of 4,
// 16-byte aligned bases, checked by the wrapper). Out-of-range elements load
// as 0, so they add nothing to the product.
template <bool kVec, bool kTrans>
struct Stage {
  float a[8];
  float b[4];

  __device__ __forceinline__ void load(const Args& p, const float* adj,
                                       const float* h, const float* scale,
                                       int row0, int k0, int col0) {
    const int tid = threadIdx.x;
    if (!kTrans) {
      // rows tid/4 and 64 + tid/4, depth 4*(tid%4) .. +3: along a global row
      const int k = k0 + 4 * (tid % 4);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = row0 + tid / 4 + u * (kBM / 2);
        const long long base = static_cast<long long>(r) * p.n + k;
        if (kVec) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r < p.n && k < p.n) v = *reinterpret_cast<const float4*>(adj + base);
          a[4 * u] = v.x; a[4 * u + 1] = v.y; a[4 * u + 2] = v.z; a[4 * u + 3] = v.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            a[4 * u + j] = (r < p.n && k + j < p.n) ? adj[base + j] : 0.0f;
        }
      }
    } else {
      // depth tid/32 and 8 + tid/32, rows 4*(tid%32) .. +3: A'[i, k] =
      // adj[k, i], so a global row of adj runs along the output rows
      const int r = row0 + 4 * (tid % 32);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int k = k0 + tid / 32 + u * (kBK / 2);
        const long long base = static_cast<long long>(k) * p.n + r;
        if (kVec) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (k < p.n && r < p.n) v = *reinterpret_cast<const float4*>(adj + base);
          a[4 * u] = v.x; a[4 * u + 1] = v.y; a[4 * u + 2] = v.z; a[4 * u + 3] = v.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            a[4 * u + j] = (k < p.n && r + j < p.n) ? adj[base + j] : 0.0f;
        }
      }
    }
    const int kb = k0 + tid / (kBN / 4);
    const int col = col0 + 4 * (tid % (kBN / 4));
    const long long hb = static_cast<long long>(kb) * p.f + col;
    const float s = (scale != nullptr && kb < p.n) ? scale[kb] : 1.0f;
    if (kVec) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kb < p.n && col < p.f) v = *reinterpret_cast<const float4*>(h + hb);
      b[0] = v.x * s; b[1] = v.y * s; b[2] = v.z * s; b[3] = v.w * s;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = (kb < p.n && col + j < p.f) ? h[hb + j] * s : 0.0f;
    }
  }

  // As is depth-major with a row padding of 4, so the product reads a
  // thread's rows as float4.
  __device__ __forceinline__ void store(float (*As)[kBM + 4],
                                        float (*Bs)[kBN]) const {
    const int tid = threadIdx.x;
    if (!kTrans) {
      const int k = 4 * (tid % 4);
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) As[k + j][tid / 4 + u * (kBM / 2)] = a[4 * u + j];
    } else {
      const int r = 4 * (tid % 32);
#pragma unroll
      for (int u = 0; u < 2; ++u)
        *reinterpret_cast<float4*>(&As[tid / 32 + u * (kBK / 2)][r]) =
            make_float4(a[4 * u], a[4 * u + 1], a[4 * u + 2], a[4 * u + 3]);
    }
    *reinterpret_cast<float4*>(&Bs[tid / (kBN / 4)][4 * (tid % (kBN / 4))]) =
        make_float4(b[0], b[1], b[2], b[3]);
  }
};

// Asynchronous copies into shared memory, 16 or 4 bytes; with full false
// nothing is read and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Output row r of the group, columns col .. col+3: acc, divided by
// max(deg, 1) for the mean.
template <bool kVec>
__device__ __forceinline__ void store_row(const Args& p, float* out,
                                          const float* degs, int g0, int r,
                                          int col, const float (&acc)[4]) {
  if (g0 + r >= p.n) return;
  float d = degs[r];
  d = d < 1.0f ? 1.0f : d;   // max(deg, 1), keeping a NaN
  const float inv = 1.0f / d;
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = p.mean ? acc[j] * inv : acc[j];
  float* o = out + static_cast<long long>(g0 + r) * p.f + col;
  if (kVec) {
    if (col < p.f)
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < p.f) o[j] = v[j];
  }
}

// One block per (64-column slab, 256-row group, b): two strips of 128 rows.
// Thread tid reads the count and degree of row g0 + tid; a strip with a row
// past kList is dense. The sparse strips' rows sum their lists over the
// slab of s * h, staged kChunk rows at a time in shared memory; a
// non-finite value anywhere in the slab sends both strips to the dense
// path. Each dense strip runs sgemm_tile.cuh's SGEMM.
template <bool kVec, bool kTrans>
__global__ void __launch_bounds__(kThreads, 2) aggregate_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  __shared__ float degs[kRows];
  __shared__ int strip_dense[2];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n = p.n;
  const int col0 = blockIdx.x * kBN;
  const int g0 = blockIdx.y * kRows;
  const long long bz = blockIdx.z;
  const float* adj = p.adj + bz * n * n;
  const float* h = p.h + bz * n * p.f;
  const float* scale = p.scale != nullptr ? p.scale + bz * n : nullptr;
  float* out = p.out + bz * n * p.f;
  const int col = col0 + 4 * tx;

  const int own = g0 + tid < n ? p.count[bz * n + g0 + tid] : 0;
  degs[tid] = (p.mean && g0 + tid < n) ? p.deg[bz * n + g0 + tid] : 1.0f;
  if (tid < 2) strip_dense[tid] = 0;
  __syncthreads();
  if (own > kList) strip_dense[tid / kBM] = 1;
  __syncthreads();
  bool dense[2] = {strip_dense[0] != 0, strip_dense[1] != 0};

  if (!dense[0] || !dense[1]) {
    // this thread's row's list, whole where the row fits it
    sm.sp.cnt[tid] = own;
    if (own <= kList) {
      const int4* src = reinterpret_cast<const int4*>(
          p.lists + (bz * n + g0 + tid) * kList);
      int4* dst = reinterpret_cast<int4*>(sm.sp.kv[tid]);
#pragma unroll
      for (int e = 0; e < kList / 2; ++e)
        if (2 * e < own) dst[e] = src[e];
    }
    float acc[16][4];
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
    bool bad = false;
    for (int c0 = 0; c0 < n && !bad; c0 += kChunk) {
      __syncthreads();   // the last chunk's sums are done with hs
      // stage h[c0 + ty + 16 u, slab] and scale[c0 .. c0 + kChunk), all in
      // flight at once; past the edge, zeros
#pragma unroll
      for (int u = 0; u < kChunk / 16; ++u) {
        const int k = c0 + ty + 16 * u;
        const float* hk = h + static_cast<long long>(k) * p.f + col;
        float* d = &sm.sp.hs[ty + 16 * u][4 * tx];
        if (kVec) {
          const bool ok = k < n && col < p.f;
          cp_async16(d, ok ? hk : h, ok);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const bool ok = k < n && col + c < p.f;
            cp_async4(d + c, ok ? hk + c : h, ok);
          }
        }
      }
      if (scale != nullptr) {
        const bool ok = c0 + tid < n;
        cp_async4(&sm.sp.sc[tid], ok ? scale + c0 + tid : scale, ok);
      }
      cp_async_wait_all();
      __syncthreads();
      // s * h in place; any inf or NaN makes both strips dense
#pragma unroll
      for (int u = 0; u < kChunk / 16; ++u) {
        const int r = ty + 16 * u;
        float4 x = *reinterpret_cast<const float4*>(&sm.sp.hs[r][4 * tx]);
        if (scale != nullptr) {
          const float sv = sm.sp.sc[r];
          x = make_float4(x.x * sv, x.y * sv, x.z * sv, x.w * sv);
          *reinterpret_cast<float4*>(&sm.sp.hs[r][4 * tx]) = x;
        }
        bad |= !finite(x.x) || !finite(x.y) || !finite(x.z) || !finite(x.w);
      }
      bad = __syncthreads_or(bad);
      if (bad) break;
      // each sparse row's list entries in this chunk, in depth order: the
      // SGEMM's fmaf chain less its exact zeros
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (dense[i / 8]) continue;
        const int r = row_of(i, ty);
        const int cnt = sm.sp.cnt[r];
        for (int e = 0; e < cnt; ++e) {
          const int2 kv = sm.sp.kv[r][e];
          if (kv.x < c0 || kv.x >= c0 + kChunk) continue;
          const float v = __int_as_float(kv.y);
          const float4 x =
              *reinterpret_cast<const float4*>(&sm.sp.hs[kv.x - c0][4 * tx]);
          acc[i][0] = fmaf(v, x.x, acc[i][0]);
          acc[i][1] = fmaf(v, x.y, acc[i][1]);
          acc[i][2] = fmaf(v, x.z, acc[i][2]);
          acc[i][3] = fmaf(v, x.w, acc[i][3]);
        }
      }
    }
    if (bad) {
      dense[0] = dense[1] = true;
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (!dense[i / 8])
          store_row<kVec>(p, out, degs, g0, row_of(i, ty), col, acc[i]);
    }
  }

  // the dense strips
  for (int s = 0; s < 2; ++s) {
    if (!dense[s] || g0 + s * kBM >= n) continue;
    float acc[8][4];
    Stage<kVec, kTrans> st;
    const int row0 = g0 + s * kBM;
    __syncthreads();   // shared memory is the SGEMM's from here
    sgemm_mainloop(
        sm.tiles, (n + kBK - 1) / kBK, acc,
        [&](int step) { st.load(p, adj, h, scale, row0, step * kBK, col0); },
        [&](float (*As)[kBM + 4], float (*Bs)[kBN]) { st.store(As, Bs); },
        [](const float (*)[kBM + 4]) {});
#pragma unroll
    for (int i = 0; i < 8; ++i)
      store_row<kVec>(p, out, degs, g0, row_of(8 * s + i, ty), col, acc[i]);
  }
}

template <bool kVec, bool kTrans>
cudaError_t launch(const Args& a, int b, cudaStream_t s) {
  static bool configured = false;   // the opt-in above 48 KB, once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        aggregate_kernel<kVec, kTrans>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 scan_grid((a.n + kScanRows - 1) / kScanRows, b);
  scan_kernel<kVec, kTrans><<<scan_grid, kThreads, 0, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((a.f + kBN - 1) / kBN, (a.n + kRows - 1) / kRows, b);
  aggregate_kernel<kVec, kTrans><<<grid, kThreads, kSmemBytes, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Ints of scratch that dense_aggregate takes for B x N rows: each row's
// list of kList (k, value) pairs, then each row's count.
int dense_aggregate_scratch_ints(int b, int n) {
  return b * n * (2 * kList + 1);
}

// out[B, N, F] = A' @ (scale * h), divided by max(deg, 1) when mean != 0,
// with A' = adj or adj^T (trans != 0); deg [B, N] receives the row sums of
// A'. scale [B, N] may be null (1). scratch holds
// dense_aggregate_scratch_ints(b, n) ints, 16-byte aligned. vec != 0
// selects float4 loads: N and F multiples of 4 and adj, h 16-byte aligned.
// Two launches (the scan, then the aggregate); returns the cudaError_t.
int dense_aggregate(const float* adj, const float* h, const float* scale,
                    float* out, float* deg, int* scratch, int b, int n, int f,
                    int trans, int mean, int vec, void* stream) {
  if (b <= 0 || n <= 0 || f <= 0) return 0;
  int2* lists = reinterpret_cast<int2*>(scratch);
  int* count = scratch + 2LL * kList * b * n;
  Args a{adj, h, scale, out, deg, lists, count, n, f, mean};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec) {
    err = trans ? launch<true, true>(a, b, s) : launch<true, false>(a, b, s);
  } else {
    err = trans ? launch<false, true>(a, b, s) : launch<false, false>(a, b, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
