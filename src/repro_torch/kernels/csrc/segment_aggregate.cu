// Edge-list segment aggregation for Hopper (sm_90a), float32 throughout.
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
// tiles it revisits in order. Here the aggregate is one pass, the weighted
// edge scatter of edge_rows.cuh that fused_mp.cu's edge phase also runs: a
// warp reads h[src] and adds it straight into out[dst] with an atomic, so
// the [B, E, F] messages never reach device memory (half the bytes of
// gather-then-scatter). Blocks run in no order, so the mean needs every
// edge's weight in deg before it can divide: a second, short launch
// divides. Both passes are one C call. The gather is one warp per (b, e)
// row as well.
//
// What bounds it on the H100: the atomics in L2. At a packed training step
// (B=1, E=8192, F=512) it issues about 4M of them against 34 MB of traffic.
// A destination-sorted CSR without atomics is later work.
//
// Masking and NaN are edge_rows.cuh's (NaN * 0 reaches the destination).
// The division takes max(deg, 1) as `deg < 1 ? 1 : deg` so that a NaN
// degree stays NaN, as clamp_min keeps it.
//
// Tolerance: the atomics add in an order that changes from run to run, so
// sums agree with the plain version to about 1e-6 relative; the tests and
// chip_smoke.py hold them to 1e-4 absolute + 1e-4 relative.
//
// Edges whose endpoints fall outside [0, N) are skipped by the scatter and
// gather 0; the batch layouts never produce one.

#include <cuda_runtime.h>

#include "edge_rows.cuh"

namespace {

template <bool kVec>
__global__ void __launch_bounds__(kRowThreads)
mean_kernel(float* __restrict__ out, const float* __restrict__ deg,
            long long rows, int f) {
  FOR_EACH_ROW(r, rows) {
    float d = deg[r];
    d = d < 1.0f ? 1.0f : d;   // max(deg, 1), keeping a NaN
    float* o = out + r * f;
    if (kVec) {
      for (int c = 4 * threadIdx.x; c < f; c += 4 * kWarp) {
        float4 v = *reinterpret_cast<float4*>(o + c);
        v.x /= d; v.y /= d; v.z /= d; v.w /= d;
        *reinterpret_cast<float4*>(o + c) = v;
      }
    } else {
      for (int c = threadIdx.x; c < f; c += kWarp) o[c] = o[c] / d;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kRowThreads)
gather_kernel(const float* __restrict__ h, const int* __restrict__ idx,
              int idx_stride, const float* __restrict__ w,
              float* __restrict__ out, int b, int n, int e, int f) {
  FOR_EACH_ROW(be, static_cast<long long>(b) * e) {
    const int bi = static_cast<int>(be / e);
    const int s = idx[be * idx_stride];
    const bool live = s >= 0 && s < n;
    const float wt = w != nullptr ? w[be] : 1.0f;
    const float* src = h + (static_cast<long long>(bi) * n + (live ? s : 0)) * f;
    float* o = out + be * f;
    if (kVec) {
      for (int c = 4 * threadIdx.x; c < f; c += 4 * kWarp) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (live) {
          v = *reinterpret_cast<const float4*>(src + c);
          if (w != nullptr) { v.x *= wt; v.y *= wt; v.z *= wt; v.w *= wt; }
        }
        *reinterpret_cast<float4*>(o + c) = v;
      }
    } else {
      for (int c = threadIdx.x; c < f; c += kWarp) {
        float v = 0.0f;
        if (live) {
          v = src[c];
          if (w != nullptr) v *= wt;
        }
        o[c] = v;
      }
    }
  }
}

}  // namespace

extern "C" {

// Weighted scatter with degree, two launches at most. With src not null the
// message of edge e is h[b, src_e] (segment aggregate); with src null it is
// msgs[b, e] (segment scatter). out [B, N, F] and deg [B, N] (null allowed
// unless mean != 0) must be zeroed by the caller. src and dst are read at
// element strides src_stride and dst_stride, so the two columns of an
// [B, E, 2] edge array are passed without a copy. vec != 0 selects float4
// loads: F a multiple of 4, h / msgs / out 16-byte aligned. Returns the
// cudaError_t of the launches.
int segment_scatter(const float* h, const float* msgs, const int* src,
                    int src_stride, const int* dst, int dst_stride,
                    const float* em, float* out, float* deg, int mean, int b,
                    int n, int e, int f, int vec, void* stream) {
  if (b <= 0 || n <= 0 || f <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ScatterArgs a{h, msgs, src, dst, src_stride, dst_stride, em, out, deg,
                b, n, e, f};
  const cudaError_t err = launch_scatter(a, vec != 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (mean) {
    const long long nodes = static_cast<long long>(b) * n;
    if (vec) {
      mean_kernel<true><<<row_grid(nodes), row_block(), 0, s>>>(out, deg, nodes, f);
    } else {
      mean_kernel<false><<<row_grid(nodes), row_block(), 0, s>>>(out, deg, nodes, f);
    }
  }
  return static_cast<int>(cudaGetLastError());
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
  if (vec) {
    gather_kernel<true><<<row_grid(rows), row_block(), 0, s>>>(
        h, idx, idx_stride, w, out, b, n, e, f);
  } else {
    gather_kernel<false><<<row_grid(rows), row_block(), 0, s>>>(
        h, idx, idx_stride, w, out, b, n, e, f);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
