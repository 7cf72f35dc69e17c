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
// normalized adjacency is never materialized: the row sums are taken from the
// A tiles as they pass through shared memory, and the division is the
// epilogue's, as the TPU kernel's epilogue divides.
//
// The TPU kernel holds whole in-neighbourhood rows (bn x N) and the source
// block (N x bf) in VMEM for one MXU product per tile. Here it is the tiled
// SGEMM of sgemm_tile.cuh, which fused_mp.cu's node phase runs too (a 128x64
// output tile per block of 256 threads, two shared-memory stages with the
// next stage's global loads in flight, float4 operand reads). A goes into
// shared memory depth-major; untransposed its global rows run along the
// depth, transposed along the output rows, and each case loads in the order
// that keeps its global reads coalesced. One block row per batch row:
// blockIdx.z is b.
//
// What bounds it on the H100: the product. At the largest dense training
// bucket used by chip_smoke.py (B=32, N=256, F=512) a layer is 2.1 GFLOP
// against 25 MB, compute-bound at 32 us on the 67 TFLOP/s float32 FMA peak.
// The adjacency is mostly zeros and the product does not skip them; TF32 or
// wgmma would be other arithmetic than the float32 reference, so both are
// later work.
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

struct Args {
  const float* adj;    // [B, N, N]
  const float* h;      // [B, N, F]
  const float* scale;  // [B, N] per source row, or null
  float* out;          // [B, N, F]
  float* deg;          // [B, N] row sums of A', or null
  int n, f;
  int mean;
};

// One stage of A (depth kBK x kBM rows) and B (kBK x kBN), held in registers
// between its global loads and its stores to shared memory: eight A values
// and four B values per thread. kVec loads float4s (N and F multiples of 4,
// 16-byte aligned bases, checked by the wrapper). Out-of-range elements load
// as 0, so they add nothing to the product or the row sums.
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

template <bool kVec, bool kTrans>
__global__ void __launch_bounds__(kThreads, 2) dense_gemm_kernel(Args p) {
  __shared__ __align__(16) Tiles tiles;
  __shared__ float rowsum[kBM];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  const long long bz = blockIdx.z;
  const float* adj = p.adj + bz * p.n * p.n;
  const float* h = p.h + bz * p.n * p.f;
  const float* scale = p.scale != nullptr ? p.scale + bz * p.n : nullptr;
  // the row sums are needed for the mean, or to hand deg to the backward
  const bool sums = p.mean || (p.deg != nullptr && blockIdx.y == 0);

  float rs = 0.0f;   // thread tid < kBM: the row sum of tile row tid
  Stage<kVec, kTrans> st;
  float acc[8][4];
  sgemm_mainloop(
      tiles, (p.n + kBK - 1) / kBK, acc,
      [&](int step) { st.load(p, adj, h, scale, row0, step * kBK, col0); },
      [&](float (*As)[kBM + 4], float (*Bs)[kBN]) { st.store(As, Bs); },
      [&](const float (*As)[kBM + 4]) {
        if (sums && tid < kBM) {
#pragma unroll
          for (int kk = 0; kk < kBK; ++kk) rs += As[kk][tid];
        }
      });
  if (sums && tid < kBM) {
    rowsum[tid] = rs;
    const int r = row0 + tid;
    if (p.deg != nullptr && blockIdx.y == 0 && r < p.n)
      p.deg[bz * p.n + r] = rs;
  }
  __syncthreads();

  float* out = p.out + bz * p.n * p.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int tr = tile_row(i, ty);
    const int r = row0 + tr;
    if (r >= p.n) continue;
    float d = 1.0f;
    if (p.mean) {
      d = rowsum[tr];
      d = d < 1.0f ? 1.0f : d;   // max(deg, 1), keeping a NaN
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + 4 * tx + j;
      if (col >= p.f) continue;
      out[static_cast<long long>(r) * p.f + col] =
          p.mean ? acc[i][j] / d : acc[i][j];
    }
  }
}

template <bool kVec>
void launch(const Args& a, int trans, dim3 grid, cudaStream_t s) {
  if (trans) {
    dense_gemm_kernel<kVec, true><<<grid, kThreads, 0, s>>>(a);
  } else {
    dense_gemm_kernel<kVec, false><<<grid, kThreads, 0, s>>>(a);
  }
}

}  // namespace

extern "C" {

// out[B, N, F] = A' @ (scale * h), divided by max(deg, 1) when mean != 0,
// with A' = adj or adj^T (trans != 0); deg [B, N] receives the row sums of
// A' when not null. scale [B, N] may be null (1). vec != 0 selects float4
// loads: N and F multiples of 4 and adj, h 16-byte aligned. One launch;
// returns its cudaError_t.
int dense_aggregate(const float* adj, const float* h, const float* scale,
                    float* out, float* deg, int b, int n, int f, int trans,
                    int mean, int vec, void* stream) {
  if (b <= 0 || n <= 0 || f <= 0) return 0;
  Args a{adj, h, scale, out, deg, n, f, mean};
  dim3 grid((n + kBM - 1) / kBM, (f + kBN - 1) / kBN, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    launch<true>(a, trans, grid, s);
  } else {
    launch<false>(a, trans, grid, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
