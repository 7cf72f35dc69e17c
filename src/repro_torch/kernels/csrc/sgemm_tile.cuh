// The float32 SGEMM tile that fused_mp.cu's node phase and
// dense_aggregate.cu share: a 128x64 output tile per block of 256 threads,
// 8x4 outputs per thread in registers, depth 16 per stage, two shared-memory
// stages so that the next stage's global loads are in flight during this
// stage's product, and operands read from shared memory as float4 (32 FMAs
// for every three 16-byte loads). A goes into shared memory depth-major with
// a row padding of 4. Each kernel brings its own stage loader (where its A
// and B come from, and the prologue that builds them) and its own epilogue.
//
// Thread tid holds columns 4tx .. 4tx+3 (tx = tid % 16) of the tile rows
// tile_row(0..7, ty) (ty = tid / 16).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;  // output rows per block
constexpr int kBN = 64;   // output columns per block
constexpr int kBK = 16;   // depth per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 4 outputs each

// Two stages of A (depth-major, rows padded by 4) and B.
struct Tiles {
  float As[2][kBK][kBM + 4];
  float Bs[2][kBK][kBN];
};

// The tile row of output row i (0..7) of a thread in row group ty: rows
// 4ty .. 4ty+3, then 64+4ty .. 64+4ty+3.
__device__ __forceinline__ int tile_row(int i, int ty) {
  return i < 4 ? 4 * ty + i : kBM / 2 + 4 * ty + i - 4;
}

// acc = the product over `steps` stages of depth kBK. load(step) reads stage
// `step` from global memory into the loader's registers; store(As, Bs)
// writes them to one shared-memory stage; visit(As) sees each stage's A
// tile once, before its product (dense_aggregate.cu takes its row sums
// there).
template <class Load, class Store, class Visit>
__device__ __forceinline__ void sgemm_mainloop(Tiles& t, int steps,
                                               float (&acc)[8][4], Load load,
                                               Store store, Visit visit) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  if (steps > 0) {
    load(0);
    store(t.As[0], t.Bs[0]);
  }
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    const bool more = step + 1 < steps;
    if (more) load(step + 1);  // in flight during this stage's product
    visit(t.As[buf]);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&t.As[buf][kk][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&t.As[buf][kk][kBM / 2 + 4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&t.Bs[buf][kk][4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) store(t.As[buf ^ 1], t.Bs[buf ^ 1]);
    __syncthreads();
  }
}

}  // namespace
