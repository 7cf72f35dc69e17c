// The weighted edge scatter with degree that fused_mp.cu's edge phase and
// segment_aggregate.cu share, float32, over [B, E] edge lists and [B, N, F]
// node rows:
//
//   out[b, d] += em[b, e] * m[b, e]      for every edge e with dst_e = d
//   deg[b, d] += em[b, e]                (when deg is not null)
//
// with m[b, e] = h[b, src_e] (an aggregate) or msgs[b, e] (a scatter of
// per-edge messages). One warp per (b, e) row, its lanes along the features
// (float4 loads when F is a multiple of 4 and the rows are 16-byte aligned),
// so the read of a message row and the atomics into its destination row are
// coalesced and the row's indices, weight and offsets are computed once per
// row. out and deg must be zeroed by the caller; blocks run in no order, so
// anything that needs the whole degree (the mean) is a later launch.
//
// Masking and NaN follow the plain versions: a masked edge's message is
// multiplied by its weight, so NaN * 0 reaches the destination. An edge of
// weight 0 whose message is finite adds exactly 0 and is skipped, which
// keeps the padded edges of a batch row (all at (0, 0)) from piling their
// atomics onto node 0. Edges whose endpoints fall outside [0, N) are
// skipped, so a bad index never writes outside out; the batch layouts never
// produce one.
//
// What bounds it on the H100: the atomics in L2, one per message element.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;           // lanes along the features of one row
constexpr int kRowThreads = 256;    // eight rows per block
constexpr long long kMaxRowBlocks = 1LL << 20;  // grid-stride covers the rest

// Not inf and not NaN: the exponent bits are not all ones.
__device__ __forceinline__ bool finite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) != 0x7f800000u;
}

struct ScatterArgs {
  const float* h;      // [B, N, F], read at src_e (aggregate); or null
  const float* msgs;   // [B, E, F] per-edge messages (scatter); or null
  const int* src;      // [B, E] at stride src_stride; null with msgs
  const int* dst;      // [B, E] at stride dst_stride
  int src_stride, dst_stride;
  const float* em;     // [B, E]
  float* out;          // [B, N, F], zeroed by the caller
  float* deg;          // [B, N], zeroed by the caller; or null
  int b, n, e, f;
};

// The rows this warp walks: row = warp, warp + warps, ... < rows.
#define FOR_EACH_ROW(row, rows)                                              \
  for (long long row = static_cast<long long>(blockIdx.x) * blockDim.y +     \
                       threadIdx.y;                                          \
       row < (rows); row += static_cast<long long>(gridDim.x) * blockDim.y)

template <bool kVec>
__global__ void __launch_bounds__(kRowThreads) scatter_kernel(ScatterArgs a) {
  FOR_EACH_ROW(be, static_cast<long long>(a.b) * a.e) {
    const int bi = static_cast<int>(be / a.e);
    const int d = a.dst[be * a.dst_stride];
    if (d < 0 || d >= a.n) continue;
    const float* m;
    if (a.src != nullptr) {
      const int s = a.src[be * a.src_stride];
      if (s < 0 || s >= a.n) continue;
      m = a.h + (static_cast<long long>(bi) * a.n + s) * a.f;
    } else {
      m = a.msgs + be * a.f;
    }
    const float w = a.em[be];
    float* o = a.out + (static_cast<long long>(bi) * a.n + d) * a.f;
    if (kVec) {
      for (int c = 4 * threadIdx.x; c < a.f; c += 4 * kWarp) {
        const float4 v = *reinterpret_cast<const float4*>(m + c);
        // w == 0 with finite messages adds exactly +0: skip it
        if (w == 0.0f && finite(v.x) && finite(v.y) && finite(v.z) &&
            finite(v.w))
          continue;
        atomicAdd(o + c, w * v.x);
        atomicAdd(o + c + 1, w * v.y);
        atomicAdd(o + c + 2, w * v.z);
        atomicAdd(o + c + 3, w * v.w);
      }
    } else {
      for (int c = threadIdx.x; c < a.f; c += kWarp) {
        const float v = m[c];
        if (w == 0.0f && finite(v)) continue;
        atomicAdd(o + c, w * v);
      }
    }
    if (a.deg != nullptr && threadIdx.x == 0 && w != 0.0f)
      atomicAdd(&a.deg[static_cast<long long>(bi) * a.n + d], w);
  }
}

dim3 row_block() { return dim3(kWarp, kRowThreads / kWarp); }

unsigned row_grid(long long rows) {
  long long blocks = (rows + kRowThreads / kWarp - 1) / (kRowThreads / kWarp);
  if (blocks > kMaxRowBlocks) blocks = kMaxRowBlocks;
  return static_cast<unsigned>(blocks);
}

// One launch of scatter_kernel over a.b * a.e rows (none when that is 0).
// vec selects float4 loads: F a multiple of 4, h / msgs / out 16-byte
// aligned.
cudaError_t launch_scatter(const ScatterArgs& a, bool vec, cudaStream_t s) {
  const long long rows = static_cast<long long>(a.b) * a.e;
  if (rows <= 0 || a.n <= 0 || a.f <= 0) return cudaSuccess;
  if (vec) {
    scatter_kernel<true><<<row_grid(rows), row_block(), 0, s>>>(a);
  } else {
    scatter_kernel<false><<<row_grid(rows), row_block(), 0, s>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace
