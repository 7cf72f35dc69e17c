// One packed message-passing layer for Hopper (sm_90a), float32 throughout.
//
// Replaces the TPU kernel `fused_mp_layer_pallas` / `_fused_mp_kernel` in
// src/repro/kernels/segment_spmm.py. Semantics are those of
// `fused_mp_layer_ref` (src/repro/kernels/ref.py):
//
//   agg[d]  = sum_{e: dst_e = d} em[e] * x[src_e]          (edge phase)
//   deg[d]  = sum_{e: dst_e = d} em[e]                      (mode "mean")
//   split:  y = x @ Ws + (agg / max(deg, 1)) @ Wn
//   pre:    y = (s * x + agg / max(deg, 1)) @ Wn             (s scalar or [P])
//   y = act(y + b) * node_mask
//
// The TPU kernel ran one sequential phased grid with one-hot gather/scatter
// matmuls and a whole-[P, F] accumulator in VMEM. Hopper blocks run in no
// order, so the two phases are two launches here:
//
//   * Edge phase: the weighted edge scatter of edge_rows.cuh, which
//     segment_aggregate.cu runs too: one warp per edge, its lanes along the
//     features, so the read of x[src] and the atomicAdd into agg[dst] are
//     both coalesced. It is bound by the L2 atomics: at the packed bin of
//     P=4096, Q=6656, F=512 it issues 3.4M of them, a few microseconds of
//     work.
//   * Node phase: the shared-memory tiled SGEMM of sgemm_tile.cuh (a 128x64
//     output tile per block of 256 threads, two shared-memory stages,
//     float4 operand reads). Its prologue builds the A tile on the fly: for
//     `split`, A = [x | agg/d] against B = [Ws; Wn], one product of depth
//     2F; for `pre`, A = s*x + agg/d against Wn, with d = max(deg, 1). Each
//     thread loads the same two A rows at every stage, so it reads their
//     1/d and s once. The epilogue adds the bias, applies relu and the node
//     mask.
//
// What bounds it on the H100: the node phase. At F=H=512 it does 4.3 GFLOP
// per layer against 19 MB of traffic, so it is compute-bound (64 us at the
// 67 TFLOP/s float32 peak outside the tensor cores). TF32 would be other
// arithmetic, not a faster version of this one, so the product stays on the
// float32 FMA pipes. A destination-sorted CSR without atomics, and the
// product on wgmma with TMA loads, are later work.
//
// Tolerance: the atomics add in an order that changes from run to run, the
// product sums in another order than the CPU, and agg/d is taken as
// agg * (1/d). Against the plain PyTorch version the layer agrees to about
// 1e-6 relative at depth 64 and about 1e-5 at depth 1024; the tests and
// chip_smoke.py hold it to 1e-4 absolute + 1e-4 relative.
//
// Edges whose endpoints fall outside [0, P) are skipped, so a bad index can
// never write outside agg; the packed layout never produces one.

#include <cstdint>

#include <cuda_runtime.h>

#include "edge_rows.cuh"
#include "sgemm_tile.cuh"

namespace {

struct NodeArgs {
  const float* x;        // [P, F]
  const float* agg;      // [P, F]
  const float* deg;      // [P] or null (mode "sum")
  const float* ss;       // pre: self scale, [P] (stride 1) or [1] (stride 0)
  int ss_stride;
  const float* w_self;   // split: [F, H]
  const float* w_neigh;  // [F, H]
  const float* bias;     // [H] or null
  const float* node_mask;  // [P] or null
  float* out;            // [P, H]
  int p, f, h;
  int split, relu;
};

// The A rows one thread loads at every stage, and their constants. Thread t
// loads depth 4*(t%4) .. 4*(t%4)+3 of tile rows t/4 and 64 + t/4, so it reads
// each row's 1/max(deg, 1) and self scale once for the whole product.
struct Rows {
  int row[2];
  bool live[2];
  float inv[2];
  float s[2];
};

// One stage (depth kBK = 16) of A and B, held in registers between its
// loads and its stores to shared memory: two float4 of A and one of B per
// thread. kVec loads float4s; it needs F and H to be multiples of 4 and
// 16-byte aligned bases, which the wrapper checks. Out-of-range elements
// load as 0.
template <bool kVec>
struct Stage {
  float a[2][4];
  float b[4];

  __device__ __forceinline__ void load(const NodeArgs& p, const Rows& rows,
                                       int seg, int k0, int col0) {
    const int tid = threadIdx.x;
    const int k = k0 + 4 * (tid % 4);
    const bool pre = !p.split;
    const bool neigh = pre || seg == 1;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const long long base = static_cast<long long>(rows.row[u]) * p.f + k;
      const float inv = rows.inv[u], s = rows.s[u];
      if (kVec) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (rows.live[u] && k < p.f) {
          if (neigh) {
            v = *reinterpret_cast<const float4*>(p.agg + base);
            v.x *= inv; v.y *= inv; v.z *= inv; v.w *= inv;
            if (pre) {
              const float4 xv = *reinterpret_cast<const float4*>(p.x + base);
              v.x = fmaf(s, xv.x, v.x); v.y = fmaf(s, xv.y, v.y);
              v.z = fmaf(s, xv.z, v.z); v.w = fmaf(s, xv.w, v.w);
            }
          } else {
            v = *reinterpret_cast<const float4*>(p.x + base);
          }
        }
        a[u][0] = v.x; a[u][1] = v.y; a[u][2] = v.z; a[u][3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v = 0.0f;
          if (rows.live[u] && k + j < p.f) {
            if (neigh) {
              v = p.agg[base + j] * inv;
              if (pre) v = fmaf(s, p.x[base + j], v);
            } else {
              v = p.x[base + j];
            }
          }
          a[u][j] = v;
        }
      }
    }
    const int kb = k0 + tid / (kBN / 4);
    const int col = col0 + 4 * (tid % (kBN / 4));
    const float* w = (p.split && seg == 0) ? p.w_self : p.w_neigh;
    const long long wb = static_cast<long long>(kb) * p.h + col;
    if (kVec) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kb < p.f && col < p.h) v = *reinterpret_cast<const float4*>(w + wb);
      b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = (kb < p.f && col + j < p.h) ? w[wb + j] : 0.0f;
    }
  }

  // A goes in transposed (depth-major), so the product reads a thread's
  // rows as float4; the row padding of 4 keeps these stores at 2-way bank
  // conflicts at most.
  __device__ __forceinline__ void store(float (*As)[kBM + 4],
                                        float (*Bs)[kBN]) const {
    const int tid = threadIdx.x;
    const int k = 4 * (tid % 4);
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) As[k + j][tid / 4 + u * (kBM / 2)] = a[u][j];
    *reinterpret_cast<float4*>(&Bs[tid / (kBN / 4)][4 * (tid % (kBN / 4))]) =
        make_float4(b[0], b[1], b[2], b[3]);
  }
};

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2) node_gemm_kernel(NodeArgs p) {
  __shared__ __align__(16) Tiles tiles;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;

  Rows rows;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = row0 + tid / 4 + u * (kBM / 2);
    const bool live = r < p.p;
    rows.row[u] = r;
    rows.live[u] = live;
    rows.inv[u] = (live && p.deg != nullptr)
                      ? __frcp_rn(fmaxf(p.deg[r], 1.0f)) : 1.0f;
    rows.s[u] = (live && !p.split)
                    ? p.ss[static_cast<long long>(r) * p.ss_stride] : 0.0f;
  }

  const int per_seg = (p.f + kBK - 1) / kBK;
  const int steps = (p.split ? 2 : 1) * per_seg;
  Stage<kVec> st;
  float acc[8][4];
  sgemm_mainloop(
      tiles, steps, acc,
      [&](int step) {
        st.load(p, rows, step / per_seg, (step % per_seg) * kBK, col0);
      },
      [&](float (*As)[kBM + 4], float (*Bs)[kBN]) { st.store(As, Bs); },
      [](const float (*)[kBM + 4]) {});

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + tile_row(i, ty);
    if (r >= p.p) continue;
    const float nm = p.node_mask != nullptr ? p.node_mask[r] : 1.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + 4 * tx + j;
      if (col >= p.h) continue;
      float y = acc[i][j] + (p.bias != nullptr ? p.bias[col] : 0.0f);
      if (p.relu) y = y < 0.0f ? 0.0f : y;  // keeps a NaN, as relu does
      p.out[static_cast<long long>(r) * p.h + col] = y * nm;
    }
  }
}

}  // namespace

extern "C" {

// Scatter-adds em[e] * x[src_e] into agg[dst_e] (and em[e] into deg[dst_e]
// when deg is not null): edge_rows.cuh's scatter over one edge list, read
// from the two columns of edges [Q, 2]. agg and deg must be zeroed by the
// caller. Returns the cudaError_t of the launch.
int fused_mp_edge_phase(const float* x, const int* edges, const float* em,
                        float* agg, float* deg, int p, int f, int q,
                        void* stream) {
  ScatterArgs a{x, nullptr, edges, edges + 1, 2, 2, em, agg, deg, 1, p, q, f};
  // float4 loads need rows of whole float4s on 16-byte aligned bases
  const bool vec = f % 4 == 0 &&
                   reinterpret_cast<std::uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(agg) % 16 == 0;
  return static_cast<int>(
      launch_scatter(a, vec, static_cast<cudaStream_t>(stream)));
}

// out[P, H] = act(A @ B + bias) * node_mask with A, B built as described at
// the top of this file. vec != 0 selects float4 loads: F and H multiples of
// 4 and x, agg, the weights 16-byte aligned. Returns the cudaError_t of the
// launch.
int fused_mp_node_phase(const float* x, const float* agg, const float* deg,
                        const float* ss, int ss_stride, const float* w_self,
                        const float* w_neigh, const float* bias,
                        const float* node_mask, float* out, int p, int f,
                        int h, int split, int relu, int vec, void* stream) {
  if (p <= 0 || h <= 0) return 0;
  NodeArgs a{x, agg, deg, ss, ss_stride, w_self, w_neigh, bias, node_mask,
             out, p, f, h, split, relu};
  dim3 grid((p + kBM - 1) / kBM, (h + kBN - 1) / kBN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    node_gemm_kernel<true><<<grid, kThreads, 0, s>>>(a);
  } else {
    node_gemm_kernel<false><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
