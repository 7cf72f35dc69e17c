// Fused GAT aggregate over the packed flat node axis for Hopper (sm_90a),
// float32 throughout.
//
// Replaces the TPU kernel `fused_gat_aggregate_pallas` / `_fused_gat_kernel`
// in src/repro/kernels/segment_spmm.py. Semantics are those of
// `fused_gat_aggregate_ref` (src/repro/kernels/ref.py):
//
//   out[i, c] = node_mask[i] * sum_{e: dst_e = i} em[e] * att[e, c / dh] * z[src_e, c]
//
// with D = H * dh features, each head's weight broadcast over its dh-wide
// slice. The TPU kernel ran a phased grid with one-hot gather and scatter
// matmuls and broadcast the heads through a one-hot expansion matmul; on
// Hopper the head of feature c is just c / dh, and the phases become one
// atomic scatter into an output the wrapper zeroes:
//
//   * One thread per (edge, feature). Neighbouring threads take neighbouring
//     features of one edge, so the read of z[src] and the atomicAdd into
//     out[dst] are coalesced; the edge's indices, mask and head weight are
//     the same for a warp's 32 features and come from L1.
//   * The node mask is folded into every term as node_mask[dst]: it scales a
//     destination's whole sum, so multiplying each term by it is the same
//     product up to rounding, and for the {0, 1} masks of the packed layout
//     exactly the same, NaN * 0 included. That saves the second pass over
//     [P, D] that a separate masking would need.
//
// Terms of padded edges (em = 0) are still added, as the plain version
// adds them: a NaN in z[src] of a padded edge reaches out[dst] in both.
//
// What bounds it on the H100: bytes, and in practice the L2 atomics. At the
// GAT full bin (P=4096, Q=6656, D=512, H=4) it must read z (8.4 MB) and
// write out (8.4 MB), 5 us at 3.35 TB/s, and it issues 3.4M atomics, as
// fused_mp.cu's edge phase does. A destination-sorted CSR built at staging
// would replace the atomics by a per-row sum; that is later work.
//
// Tolerance: the atomics add in an order that changes from run to run, so
// the output agrees with the plain version to about 1e-6 relative.
//
// Edges whose endpoints fall outside [0, P) are skipped; the packed layout
// never produces one.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gat_scatter_kernel(const float* __restrict__ z, const int* __restrict__ edges,
                   const float* __restrict__ em, const float* __restrict__ att,
                   const float* __restrict__ nm, float* __restrict__ out,
                   int p, int d, int q, int h, int dh) {
  const long long total = static_cast<long long>(q) * d;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int e = static_cast<int>(idx / d);
    const int col = static_cast<int>(idx - static_cast<long long>(e) * d);
    const int s = edges[2 * e];
    const int t = edges[2 * e + 1];
    if (s < 0 || s >= p || t < 0 || t >= p) continue;
    const float a = att[static_cast<long long>(e) * h + col / dh];
    const float v = z[static_cast<long long>(s) * d + col] * a * em[e] * nm[t];
    atomicAdd(&out[static_cast<long long>(t) * d + col], v);
  }
}

}  // namespace

extern "C" {

// Scatter-adds node_mask[dst] * em[e] * att[e, head] * z[src_e] into out
// [P, D], which the caller must zero. Returns the cudaError_t of the launch.
int fused_gat_aggregate(const float* z, const int* edges, const float* em,
                        const float* att, const float* nm, float* out, int p,
                        int d, int q, int h, void* stream) {
  if (q <= 0 || d <= 0 || p <= 0 || h <= 0 || d % h != 0) return 0;
  const long long total = static_cast<long long>(q) * d;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride covers the rest
  gat_scatter_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      z, edges, em, att, nm, out, p, d, q, h, d / h);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
