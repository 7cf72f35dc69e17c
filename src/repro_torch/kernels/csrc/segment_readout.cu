// Per-graph pooled readout over the packed flat node axis, for Hopper
// (sm_90a), float32 throughout.
//
// Replaces the TPU kernel `segment_readout_pallas` / `_seg_readout_kernel` in
// src/repro/kernels/segment_spmm.py. Semantics are those of
// `segment_readout_ref` (src/repro/kernels/ref.py): over the rows with
// node_mask > 0,
//
//   sum[g] = sum_{i: gid_i = g} w_i * h[i],  cnt[g] = sum_{i: gid_i = g} w_i,
//   max[g] = max_{i: gid_i = g} h[i],
//   out[g] = sum[g] / max(cnt[g], 1)            (kind "mean", [G, F])
//   out[g] = mean[g] ++ (cnt[g] > 0 ? max[g] : 0)   (kind "mean_max", [G, 2F])
//
// The TPU kernel revisited its output blocks over a sequential node-tile grid
// with a one-hot selection matmul. Hopper blocks run in no order, so this is
// two launches:
//
//   * Accumulate: each block owns 32 node rows x 128 features, one feature
//     per thread. The block stages its rows' ids and mask values in shared
//     memory, each thread loads its 32 values of h at once (a sequential
//     walk would pay one memory latency per row), then walks the rows in
//     order and keeps a running (sum, count, max) for the current graph id.
//     It flushes the run when the id changes and when the tile ends:
//     atomicAdd for the sum and the count,
//     and an atomic float max (a compare-and-swap loop on the bits). That is
//     right for ids in any order, and cheap for the contiguous runs that
//     collate_packed produces, where a tile flushes only once or twice. The
//     max scratch starts at -FLT_MAX (finfo.min), as the reference does.
//   * Finalize: mean = sum / max(cnt, 1), max set to 0 where cnt == 0, and
//     the concatenation.
//
// What bounds it on the H100: bytes. At P=4096, F=512, G=256 it reads 8.4 MB
// of h and writes 1 MB, about 2.8 us at 3.35 TB/s, and does a few operations
// per byte. Reads of h are coalesced across the threads of a block; the
// atomics per tile are few.
//
// A NaN in a real row reaches the sum, and so the mean: the prediction engine
// relies on that to reject non-finite outputs. The max ignores it.
//
// Tolerance: the sums are added with atomics in an order that changes from
// run to run, so the mean agrees with the plain version to about 1e-6
// relative; the max is exact.
//
// Rows whose graph id falls outside [0, G) are skipped, as
// jax.ops.segment_sum drops them; the packed layout never produces one.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;       // node rows per block
constexpr int kFeatures = 128;  // features per block, one per thread

__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  int* bits = reinterpret_cast<int*>(addr);
  int old = *bits;
  while (v > __int_as_float(old)) {
    const int prev = atomicCAS(bits, old, __float_as_int(v));
    if (prev == old) return;
    old = prev;
  }
}

__device__ __forceinline__ void flush(float* sums, float* cnt, float* mx,
                                      int cur, int f, int col, bool counts,
                                      float s, float c, float m) {
  atomicAdd(&sums[static_cast<long long>(cur) * f + col], s);
  if (mx != nullptr) atomic_max_f32(&mx[static_cast<long long>(cur) * f + col], m);
  if (counts) atomicAdd(&cnt[cur], c);
}

__global__ void __launch_bounds__(kFeatures)
readout_accumulate_kernel(const float* __restrict__ h, const int* __restrict__ gid,
                          const float* __restrict__ nm, float* __restrict__ sums,
                          float* __restrict__ cnt, float* __restrict__ mx,
                          int p, int f, int g) {
  __shared__ int s_id[kRows];
  __shared__ float s_w[kRows];
  const int r0 = blockIdx.x * kRows;
  if (threadIdx.x < kRows) {
    const int r = r0 + threadIdx.x;
    const bool live = r < p && nm[r] > 0.0f;   // masked and tail rows: w = 0
    s_id[threadIdx.x] = live ? gid[r] : -1;
    s_w[threadIdx.x] = live ? nm[r] : 0.0f;
  }
  __syncthreads();
  const int col = blockIdx.y * kFeatures + threadIdx.x;
  if (col >= f) return;
  const bool counts = blockIdx.y == 0 && threadIdx.x == 0;
  // issue every row's load before the first use, so the tile's reads are in
  // flight together instead of one latency per row
  float v[kRows];
#pragma unroll
  for (int t = 0; t < kRows; ++t)
    v[t] = s_w[t] > 0.0f ? h[static_cast<long long>(r0 + t) * f + col] : 0.0f;
  int cur = -1;
  float s = 0.0f, c = 0.0f, m = -FLT_MAX;
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    const float w = s_w[t];
    const int id = s_id[t];
    if (!(w > 0.0f) || id < 0 || id >= g) continue;
    if (id != cur) {
      if (cur >= 0) flush(sums, cnt, mx, cur, f, col, counts, s, c, m);
      cur = id;
      s = 0.0f;
      c = 0.0f;
      m = -FLT_MAX;
    }
    s += v[t] * w;
    m = v[t] > m ? v[t] : m;
    c += w;
  }
  if (cur >= 0) flush(sums, cnt, mx, cur, f, col, counts, s, c, m);
}

__global__ void readout_finalize_kernel(const float* __restrict__ sums,
                                        const float* __restrict__ cnt,
                                        const float* __restrict__ mx,
                                        float* __restrict__ out, int f, int g) {
  const long long total = static_cast<long long>(g) * f;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int width = mx != nullptr ? 2 * f : f;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const long long gi = idx / f;
    const int col = static_cast<int>(idx - gi * f);
    const float c = cnt[gi];
    out[gi * width + col] = sums[idx] / fmaxf(c, 1.0f);
    if (mx != nullptr) out[gi * width + f + col] = c > 0.0f ? mx[idx] : 0.0f;
  }
}

}  // namespace

extern "C" {

// Accumulates per-graph sum, count and (when mx is not null) max into the
// caller's scratch: sums [G, F] and cnt [G] zeroed, mx [G, F] filled with
// -FLT_MAX. Returns the cudaError_t of the launch.
int segment_readout_accumulate(const float* h, const int* gid, const float* nm,
                               float* sums, float* cnt, float* mx, int p,
                               int f, int g, void* stream) {
  if (p <= 0 || f <= 0 || g <= 0) return 0;
  dim3 grid((p + kRows - 1) / kRows, (f + kFeatures - 1) / kFeatures);
  readout_accumulate_kernel<<<grid, kFeatures, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      h, gid, nm, sums, cnt, mx, p, f, g);
  return static_cast<int>(cudaGetLastError());
}

// Writes out [G, F] (mx null) or [G, 2F] from the accumulated scratch.
// Returns the cudaError_t of the launch.
int segment_readout_finalize(const float* sums, const float* cnt,
                             const float* mx, float* out, int f, int g,
                             void* stream) {
  if (f <= 0 || g <= 0) return 0;
  const long long total = static_cast<long long>(g) * f;
  long long blocks = (total + 255) / 256;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  readout_finalize_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      sums, cnt, mx, out, f, g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
