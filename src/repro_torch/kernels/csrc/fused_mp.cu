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
//   * Edge phase: one thread per (edge, feature). Neighbouring threads take
//     neighbouring features of one edge, so the read of x[src] and the
//     atomicAdd into agg[dst] are both coalesced. It is bound by the L2
//     atomics: at the packed bin of P=4096, Q=6656, F=512 it issues 3.4M of
//     them, a few microseconds of work.
//   * Node phase: a shared-memory tiled SGEMM: a 128x64 output tile per
//     block of 256 threads, 8x4 outputs per thread in registers, depth 16
//     per stage, two shared-memory stages so that the next stage's loads are in
//     flight during this stage's product, and operands read from shared
//     memory as float4 (32 FMAs for every three 16-byte loads). Its
//     prologue builds the A tile on the fly: for `split`, A = [x | agg/d]
//     against B = [Ws; Wn], one product of depth 2F; for `pre`,
//     A = s*x + agg/d against Wn, with d = max(deg, 1). Each thread loads
//     the same two A rows at every stage, so it reads their 1/d and s once.
//     The epilogue adds the bias, applies relu and the node mask.
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

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;  // output rows per block
constexpr int kBN = 64;   // output columns per block
constexpr int kBK = 16;   // depth per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 4 outputs each
constexpr int kEdgeThreads = 256;

__global__ void __launch_bounds__(kEdgeThreads)
edge_scatter_kernel(const float* __restrict__ x, const int* __restrict__ edges,
                    const float* __restrict__ em, float* __restrict__ agg,
                    float* __restrict__ deg, int p, int f, int q) {
  const long long total = static_cast<long long>(q) * f;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int e = static_cast<int>(idx / f);
    const int col = static_cast<int>(idx - static_cast<long long>(e) * f);
    const int s = edges[2 * e];
    const int d = edges[2 * e + 1];
    if (s < 0 || s >= p || d < 0 || d >= p) continue;
    const float w = em[e];
    atomicAdd(&agg[static_cast<long long>(d) * f + col],
              w * x[static_cast<long long>(s) * f + col]);
    if (deg != nullptr && col == 0) atomicAdd(&deg[d], w);
  }
}

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
  __shared__ __align__(16) float As[2][kBK][kBM + 4];
  __shared__ __align__(16) float Bs[2][kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;   // columns 4tx .. 4tx+3
  const int ty = tid / 16;   // rows 4ty .. 4ty+3 and 64+4ty .. 64+4ty+3
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

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const int per_seg = (p.f + kBK - 1) / kBK;
  const int steps = (p.split ? 2 : 1) * per_seg;
  Stage<kVec> st;
  if (steps > 0) {
    st.load(p, rows, 0, 0, col0);
    st.store(As[0], Bs[0]);
  }
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    const bool more = step + 1 < steps;
    if (more) {   // the next stage's loads are in flight during this product
      const int nxt = step + 1;
      st.load(p, rows, nxt / per_seg, (nxt % per_seg) * kBK, col0);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][kBM / 2 + 4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[buf][kk][4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) st.store(As[buf ^ 1], Bs[buf ^ 1]);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? 4 * ty + i : kBM / 2 + 4 * ty + i - 4);
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
// when deg is not null). agg and deg must be zeroed by the caller.
// Returns the cudaError_t of the launch.
int fused_mp_edge_phase(const float* x, const int* edges, const float* em,
                        float* agg, float* deg, int p, int f, int q,
                        void* stream) {
  if (q <= 0 || f <= 0 || p <= 0) return 0;
  const long long total = static_cast<long long>(q) * f;
  long long blocks = (total + kEdgeThreads - 1) / kEdgeThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride covers the rest
  edge_scatter_kernel<<<static_cast<unsigned>(blocks), kEdgeThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, edges, em, agg, deg, p, f, q);
  return static_cast<int>(cudaGetLastError());
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
