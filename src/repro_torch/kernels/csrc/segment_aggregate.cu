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
// divides. Both passes are one C call.
//
// What bounds the aggregate on the H100: the atomics in L2. At a packed
// training step (B=1, E=8192, F=512) it issues about 4M of them against
// 34 MB of traffic. A destination-sorted CSR without atomics is later work.
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

#include <algorithm>
#include <atomic>

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

template <class Unit>
__device__ __forceinline__ Unit zero_unit();
template <>
__device__ __forceinline__ float zero_unit<float>() { return 0.0f; }
template <>
__device__ __forceinline__ float4 zero_unit<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
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
