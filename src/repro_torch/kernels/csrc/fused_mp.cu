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
//     P=4096, Q=6656, F=512 it issues 3.4M of them.
//   * Node phase: the product, A against B, with A built on the fly: for
//     `split`, A = [x | agg/d] against B = [Ws; Wn], one product of depth
//     2F; for `pre`, A = s*x + agg/d against Wn, with d = max(deg, 1) and
//     agg/d taken as agg * (1/d). The epilogue adds the bias, applies relu
//     and the node mask.
//
// What bounds it on the H100: the node phase's product. At F=H=512 it is
// 4.3 GFLOP per layer against 19 MB of traffic: 64 us at the 67 TFLOP/s
// float32 FMA peak, 26 us for the three TF32 products below at 495 TFLOP/s.
// So the node phase runs on the tensor cores, in tf32x3_tile.cuh's 3xTF32
// split: each float32 operand becomes hi = tf32(v) and lo = v - hi, and the
// product sums A_lo B_hi + A_hi B_lo (their own accumulator) and A_hi B_hi.
// One TF32 product keeps 11 bits an operand and misses the float32 bar
// below by an order of magnitude at depth 1024; the split keeps about 22,
// and the dropped A_lo B_lo is about 2^-22 of the result
// (tests/test_torch_kernels.py emulates both, summing in float32 per depth
// step as the kernel does). After it, the layer's next cost is the edge
// phase's atomics (ROADMAP B6: a destination-sorted CSR).
//
// The tensor-core route is two launches. split_transpose_kernel writes the
// weights split and transposed ([Ws; Wn] or Wn, K-major, hi and lo) into the
// wrapper's scratch, since wgmma's tf32 form reads B K-major only. Then
// tf32x3_node_kernel: a 128x128 output tile per block of two warpgroups, so
// the full bin's 4096 x 512 output is 128 blocks, one wave on the 132 SMs;
// with 128 accumulators a thread there is room for one block an SM, and a
// 128x64 tile would double the reads of A. The raw x and agg tiles of depth
// 32 and B's rows are staged by cp.async into a ring of three stages, two in
// flight while one is multiplied; each warp builds its A fragments from the
// raw tiles in registers (agg * 1/d, and s*x added for `pre`, as the FMA
// kernel does), splits them there and feeds wgmma m64n128k8 with A from
// registers. Depth past F within a stage is copied as zeros, so F need only
// be a multiple of 4.
//
// Non-finite values. The split does not keep them: inf - inf makes lo NaN,
// and inf * 0 in a cross term makes NaN where float32 gives +-inf. A
// non-finite operand makes every split output of its row (in A) or column
// (in B) NaN, since its lo is NaN; so a block whose split tile holds any
// non-finite value has staged a non-finite operand (or overflowed), and it
// computes its tile again on the FMA pipes (fma_tile, sgemm_tile.cuh),
// which gives the plain version's inf and NaN. This is a branch on the data
// inside the kernel, taken by the blocks that hold such a value only.
//
// Route. The copies move 16 bytes, so the tensor-core kernel takes F and H
// multiples of 4 and x, agg and the weights 16-byte aligned; other shapes
// and views run node_gemm_kernel, the float32 SGEMM of sgemm_tile.cuh (a
// 128x64 tile, scalar loads). The wrapper picks the route from the shapes
// and the pointers alone (`fused_mp_plan`, repro_torch/kernels/
// segment_spmm.py).
//
// Tolerance: the atomics add in an order that changes from run to run, the
// product sums in another order than the CPU, and agg/d is taken as
// agg * (1/d). The tests and chip_smoke.py hold the layer to 1e-4 absolute
// + 1e-4 relative against the plain PyTorch version on either route.
//
// Edges whose endpoints fall outside [0, P) are skipped, so a bad index can
// never write outside agg; the packed layout never produces one.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

#include "edge_rows.cuh"
#include "sgemm_tile.cuh"
#include "tf32x3_tile.cuh"

namespace {

namespace tc = tf32x3;

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
  // the tensor-core route's B, split and transposed (tf32x3::SplitB)
  const uint32_t* b_hi;
  const uint32_t* b_lo;
};

// bias, relu (which keeps a NaN, as relu does) and the node mask
__device__ __forceinline__ float epilogue(const NodeArgs& p, float acc,
                                          int col, float nm) {
  float y = acc + (p.bias != nullptr ? p.bias[col] : 0.0f);
  if (p.relu) y = y < 0.0f ? 0.0f : y;
  return y * nm;
}

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

// The float32 FMA product and epilogue of the 128x64 output tile at
// (row0, col0), by the block's 256 threads.
template <bool kVec>
__device__ __forceinline__ void fma_tile(const NodeArgs& p, Tiles& tiles,
                                         int row0, int col0) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

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
      p.out[static_cast<long long>(r) * p.h + col] =
          epilogue(p, acc[i][j], col, nm);
    }
  }
}

// The FMA route: F or H not a multiple of 4, or an operand not 16-byte
// aligned, so every load is a scalar one.
__global__ void __launch_bounds__(kThreads, 2) node_gemm_kernel(NodeArgs p) {
  __shared__ __align__(16) Tiles tiles;
  fma_tile<false>(p, tiles, blockIdx.x * kBM, blockIdx.y * kBN);
}

// The stage's copies of A for the tensor-core route: depth tile kt of A's
// raw tiles (split: x for the first F depths, agg for the next F; pre: x
// and agg), zeros past P and F, each 16-byte chunk at its swizzled place.
template <bool kSplit>
__device__ __forceinline__ void issue_stage(const NodeArgs& p, int kt,
                                            int per_seg, int row0,
                                            tc::Stage<kSplit ? 1 : 2>& st) {
  const int tid = threadIdx.x;
  const int seg = kSplit ? kt / per_seg : 1;
  const int k0 = (kt % per_seg) * tc::kBK;
  const float* a0 = (kSplit && seg == 1) ? p.agg : p.x;
#pragma unroll
  for (int u = 0; u < (tc::kBM * tc::kBK / 4) / tc::kThreads; ++u) {
    const int c = tid + u * tc::kThreads;
    const int r = c / (tc::kBK / 4), k = 4 * (c % (tc::kBK / 4));
    const bool ok = row0 + r < p.p && k0 + k < p.f;
    const long long off =
        ok ? static_cast<long long>(row0 + r) * p.f + k0 + k : 0;
    const int dst = tc::swizzled(r, k) / 4;
    tc::cp_async16(&st.a[0][dst], a0 + off, ok);
    if constexpr (!kSplit) tc::cp_async16(&st.a[1][dst], p.agg + off, ok);
  }
}

template <bool kSplit>
__global__ void __launch_bounds__(tc::kThreads, 1)
    tf32x3_node_kernel(NodeArgs p) {
  constexpr int kRawA = kSplit ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  tc::Stage<kRawA>* ring = tc::carve<kRawA>(smem);
  const int row0 = blockIdx.x * tc::kBM;
  const int col0 = blockIdx.y * tc::kBN;

  // 1/max(deg, 1) and the self scale of this thread's two fragment rows
  float inv[2], s[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + tc::frag_row(h);
    const bool live = r < p.p;
    inv[h] = (live && p.deg != nullptr) ? __frcp_rn(fmaxf(p.deg[r], 1.0f))
                                        : 1.0f;
    s[h] = (live && !kSplit)
               ? p.ss[static_cast<long long>(r) * p.ss_stride] : 0.0f;
  }

  const int per_seg = (p.f + tc::kBK - 1) / tc::kBK;
  const int ktiles = (kSplit ? 2 : 1) * per_seg;
  const tc::SplitB b{p.b_hi, p.b_lo, static_cast<long long>(ktiles) * tc::kBK,
                     col0, p.h};
  tc::Acc big, small;
  tc::mainloop(
      ring, b, ktiles, big, small,
      [&](int kt, tc::Stage<kRawA>& st) {
        issue_stage<kSplit>(p, kt, per_seg, row0, st);
      },
      [&](int kt, const tc::Stage<kRawA>& st, int k8, float (&v)[4]) {
        // the same arithmetic as Stage<kVec>::load above; v[u] is in row
        // g (u even) or g + 8 (u odd)
        tc::load_frag(v, st.a[0], k8);
        if constexpr (kSplit) {
          if (kt >= per_seg) {
#pragma unroll
            for (int u = 0; u < 4; ++u) v[u] *= inv[u & 1];
          }
        } else {
          float xv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) xv[u] = v[u];
          tc::load_frag(v, st.a[1], k8);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            v[u] = fmaf(s[u & 1], xv[u], v[u] * inv[u & 1]);
        }
      });

  bool bad = false;
#pragma unroll
  for (int i = 0; i < tc::kBN / 2; ++i) {
    const float y = big[i] + small[i];
    bad |= !(fabsf(y) <= FLT_MAX);
    big[i] = y;
  }
  if (__syncthreads_or(bad)) {
    // a non-finite operand (or an overflow) in this tile: the plain
    // float32 product, in the shared memory the mainloop left free
    Tiles& tiles = *reinterpret_cast<Tiles*>(smem);
    fma_tile<true>(p, tiles, row0, col0);
    if (col0 + kBN < p.h) fma_tile<true>(p, tiles, row0, col0 + kBN);
    return;
  }

  const int col_t = col0 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + tc::frag_row(h);
    if (r >= p.p) continue;
    const float nm = p.node_mask != nullptr ? p.node_mask[r] : 1.0f;
    float* out = p.out + static_cast<long long>(r) * p.h;
#pragma unroll
    for (int j = 0; j < tc::kBN / 8; ++j) {
      const int col = col_t + 8 * j;
      if (col >= p.h) continue;  // H % 4 == 0, so col + 1 < H too
      *reinterpret_cast<float2*>(out + col) =
          make_float2(epilogue(p, big[4 * j + 2 * h], col, nm),
                      epilogue(p, big[4 * j + 2 * h + 1], col + 1, nm));
    }
  }
}

// Depths of one segment of the split B: F rounded up to whole stages
int seg_depth(int f) { return (f + tc::kBK - 1) / tc::kBK * tc::kBK; }

// B split and transposed into `scratch` (split_transpose_kernel), then the
// product
template <bool kSplit>
cudaError_t launch_tf32x3(NodeArgs a, uint32_t* scratch, cudaStream_t s) {
  static bool configured = false;   // the opt-in above 48 KB, once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        tf32x3_node_kernel<kSplit>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        tc::smem_bytes<kSplit ? 1 : 2>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int kp = seg_depth(a.f), nseg = kSplit ? 2 : 1;
  a.b_hi = scratch;
  a.b_lo = scratch + static_cast<long long>(a.h) * nseg * kp;
  if (kp > 0) {
    const dim3 tgrid((a.h + 31) / 32, kp / 32, nseg);
    tc::split_transpose_kernel<<<tgrid, dim3(32, 8), 0, s>>>(
        kSplit ? a.w_self : a.w_neigh, a.w_neigh, a.f, a.h, kp,
        const_cast<uint32_t*>(a.b_hi), const_cast<uint32_t*>(a.b_lo));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.p + tc::kBM - 1) / tc::kBM,
                  (a.h + tc::kBN - 1) / tc::kBN);
  tf32x3_node_kernel<kSplit>
      <<<grid, tc::kThreads, tc::smem_bytes<kSplit ? 1 : 2>(), s>>>(a);
  return cudaGetLastError();
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

// The 32-bit words of scratch the tensor-core route takes for a layer of F
// inputs and H outputs: the weights split and transposed, hi and lo.
int fused_mp_scratch_words(int f, int h, int split) {
  return 2 * h * (split ? 2 : 1) * seg_depth(f);
}

// out[P, H] = act(A @ B + bias) * node_mask with A, B built as described at
// the top of this file. route 1 runs the tensor-core kernel (F and H
// multiples of 4; x, agg and the weights 16-byte aligned: the wrapper's
// `fused_mp_plan` checks it) with `scratch` of fused_mp_scratch_words
// words, 16-byte aligned; route 0 the FMA kernel with scalar loads, and
// scratch may be null. Returns the cudaError_t of the launches.
int fused_mp_node_phase(const float* x, const float* agg, const float* deg,
                        const float* ss, int ss_stride, const float* w_self,
                        const float* w_neigh, const float* bias,
                        const float* node_mask, float* out, int p, int f,
                        int h, int split, int relu, int route, void* scratch,
                        void* stream) {
  if (p <= 0 || h <= 0) return 0;
  NodeArgs a{x, agg, deg, ss, ss_stride, w_self, w_neigh, bias, node_mask,
             out, p, f, h, split, relu, nullptr, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    uint32_t* words = static_cast<uint32_t*>(scratch);
    return static_cast<int>(split ? launch_tf32x3<true>(a, words, s)
                                  : launch_tf32x3<false>(a, words, s));
  }
  dim3 grid((p + kBM - 1) / kBM, (h + kBN - 1) / kBN);
  node_gemm_kernel<<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
