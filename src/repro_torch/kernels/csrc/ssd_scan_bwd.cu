// The gradient of the Mamba2 chunked SSD scan for Hopper (sm_90a): dx, ddt,
// dA, dB, dC and ds0 of the forward in ssd_scan.cu, from the gradient dy on
// y and d_last on the last state. x, B, C and their gradients in float32 or
// bfloat16; dt, A, s0, dy, d_last and every sum in float32.
//
// Replaces no Pallas kernel: the JAX package differentiates the plain-jnp
// `_ssd_chunked` (src/repro/models/layers.py:739-791) with `jax.grad`; its
// Pallas `ssd_scan_pallas` has no VJP. This is that gradient on the card, in
// closed form; its plain twin is `ssd_scan_bwd_ref`
// (src/repro_torch/kernels/ref.py), which states the formulas. Per batch
// row b and head h, with group g = h / (H / G), and per chunk of rows
// i >= j, cum = cumsum(dt A), tot = cum[-1],
//
//   K_ij = (C_i . B_j) e^(cum_i - cum_j),  Q_ij = dy_i . x_j,
//   w_j = e^(tot - cum_j) dt_j,  Sin the chunk's entry state, Gout the
//   gradient on its exit state (d_last after the last chunk);
//   dx_j  = dt_j sum_i K_ij dy_i + w_j (B_j Gout)
//   dB_j += dt_j sum_i Q_ij e^(cum_i - cum_j) C_i + w_j (Gout x_j)
//   dC_i += sum_j Q_ij e^(cum_i - cum_j) dt_j B_j + e^(cum_i) (Sin dy_i)
//   ddt_j = sum_i K_ij Q_ij + e^(tot - cum_j) (B_j Gout) . x_j
//           + A sum_{k >= j} gcum_k,   dA += sum_j dt_j sum_{k >= j} gcum_k
//   Gin   = e^tot Gout + sum_i e^(cum_i) C_i (x) dy_i   (after chunk 0: ds0)
//
// with gcum the gradient on cum (the twin's docstring). No term divides by
// dt: a padded row (past S, staged as zeros: dt = 0, the identity decay)
// adds nothing, as in the forward. The decay is masked to i >= j before
// the exp.
//
// Both routes block the sequence in chunks of kLc = 64 rows whatever the
// model's chunk (the same function, blocked otherwise, as the forward's
// `ssd_plan` does), on the caller's stream, one C call, and carry nothing
// between blocks: every output element is written by one thread after
// sums in a fixed order, with no atomics, so a run gives the same bits as
// the last.
//
// Bound, at mamba2-370m's training shape (x [8, 2048, 32, 64], B/C
// [8, 2048, 1, 128], bf16): bytes. Inputs read once and outputs written
// once are 315 MB, 93.9 us at 3.35 TB/s; the 2 T (3 N + 2 P) flops of the
// T = Lc (Lc + 1) / 2 pairs i >= j a (b, chunk, h) keeps and 12 Lc N P of
// the state products are 69.0 GFLOP, 69.8 us at the bf16 peak
// (zamba2-2.7b's x [8, 2048, 80, 64], N 64: 721 MB, 215 us).
//
// 1. bfloat16 x, B, C: the tensor cores (namespace tc), four launches.
//
//    What held the FMA route back there (9.45 ms on an NVIDIA H100 80GB
//    HBM3 at 700 W, 100x its bound): every product on the FMA pipes from
//    float32 tiles (189,184 bytes, one block an SM); 13 passes of 268 MB
//    of float32 chunk states, exit gradients and per-head dB / dC; a scan
//    that kept one float a thread in flight. The design:
//    - `ssd_bwd_walk_kernel`, a block per (h, b, direction): the entry
//      states Sin forward from s0 and the exit gradients Gout backward
//      from d_last, carried in float32 accumulators over the chunks as the
//      forward kernel carries its state, each chunk adding (w B)^T x or
//      (e^cum C)^T dy on `mma.sync`. Each state goes out once, split into
//      two bf16 terms (hi, lo), through shared memory in 16-byte stores;
//      the backward walk writes dy's two terms beside it. No chunk-term
//      scratch and no scan: 0.67 GB written where the FMA route moved
//      3.5 GB.
//    - `ssd_bwd_tc_grad_kernel`, a block per (head slice, chunk, b): a
//      group's H / G heads in ceil(H / G / 8) slices, each walked in
//      ascending order with the chunk's B and C staged once and each
//      head's x, dy, Gout and Sin landing by 16-byte `cp.async` in a
//      two-slot ring of XOR-swizzled rows while the last head runs. Warps
//      0-3 own 16 rows j (dx, dB, the column sums), 4-7 16 rows i (dC, the
//      row sums); warps w and w + 4 share a scheduler and take 4 - w and
//      w + 1 blocks of the causal triangle. Every product is `mma.sync`
//      m16n8k16 from `ldmatrix` (.trans for the transposed operands): B
//      C^T and x dy^T on the j side (C B^T and dy x^T on the i side) are
//      built into K_ij dt_j and Q_ij D_ij dt_j in their accumulators and
//      split there into the A fragments of dx, dB and dC, the decay masked
//      to i >= j before the power (2^(cum_i - cum_j), cum in log2 units);
//      the row and column sums behind gcum and ddt are quad shuffles; a
//      head's gcum suffix sum, ddt and part of dA are one warp's scan
//      while the others start the next head. dB and dC stay in float32
//      registers over the slice and go out as one partial a slice: at
//      mamba2's G = 1, H = 32 four partials of 33.5 MB where the FMA
//      route wrote 268 MB per head.
//    - the partials summed in order (`ssd_bwd_group_kernel`, shared with
//      the FMA route) and dA by a warp a head (`ssd_bwd_tc_da_kernel`).
//    Every float operand is split into bf16 terms, hi = bf16(v), lo =
//    bf16(v - hi), as the forward splits them: dy, the scaled B and C of
//    the walks, K dt, Q D dt, Gout and Sin, two terms each; a product of
//    two split operands issues hi hi, hi lo and lo hi. One term each
//    would hold the bar, but near it (up to 0.7 of it in a float32
//    emulation), and would move ddt, dA and ds0 (the float32 outputs) by
//    3e-3 to 9e-3 of their scale where two keep them within 1e-5
//    (tests/test_torch_ssd_train.py emulates both). x, B and C
//    are exact in bf16; the sums are float32; dx, dB and dC round to bf16
//    once, at the end.
//
//    The chunk stays at 64 rows: a warp a 16-row tile on each side, and
//    the registers (255 a thread at N = 128, P = 64: dB or dC of the slice,
//    dx, the fragments) hold no wider tile. 128 rows would halve the
//    states' bytes (0.54 GB of the gradient kernel's 1.1 GB reads and
//    writes at mamba2's shape) but take 16 warps or two tiles a warp.
//    Shared memory: the gradient block 256 N' + 2 (384 P' + 8 N' P') +
//    5,184 bytes (N', P' the widths padded to a power of two >= 16;
//    218,176 at N = 128, P = 64), one block an SM; a walk block 256 N' +
//    512 P' + 512 + 4 N' P' (98,816), two an SM. N <= 128, P <= 64.
//
//    On an NVIDIA H100 80GB HBM3 at 700 W the call takes 1.07 ms at
//    mamba2-370m's shape (walks 352-354 us, gradients 689-702, sums 31),
//    8.8x faster than the FMA route, and 1.66 ms at zamba2-2.7b's; the
//    design's own floor, its bytes (the bound's, the states' and dy's terms
//    written and read once, the partials) at 3.35 TB/s, is 0.53 and
//    0.87 ms. The walks run near their bytes (0.87 GB at mamba2's shape,
//    0.26 ms). What bounds the gradient kernel: issue and latency at one
//    block of 8 warps an SM (about 20 cycles a scheduler per m16n8k16 it
//    issues), each warp reading all of Gout or Sin through `ldmatrix`;
//    wider warp tiles need registers it does not have, so `wgmma` would be
//    its next redesign.
//
//    Tolerance against the plain twin: 1e-2 of each gradient's largest
//    magnitude (dx, dB and dC are bf16).
//
// 2. float32 x, B, C: the FMA pipes, five launches:
//   1. `ssd_bwd_chunk_kernel`, a block per (h, chunk, b): the chunk's own
//      state sum_j w_j B_j (x) x_j and gradient sum_i e^(cum_i) C_i (x) dy_i
//      ([N, P] each) into scratch, and tot;
//   2. `ssd_bwd_scan_kernel`, a thread per (b, h, state element): the entry
//      states forward over the chunks and the exit gradients backward, in
//      place over (1)'s scratch, and ds0;
//   3. `ssd_bwd_grad_kernel`, a block per (h, chunk, b): everything else.
//      It writes dx and ddt, the head's part of dB and dC (float32 scratch
//      [Bt, S, H, N]) and of dA ([Bt, nc, H]);
//   4. `ssd_bwd_group_kernel`: dB and dC, each group's heads summed in
//      ascending order;
//   5. `ssd_bwd_da_kernel`: dA, the (b, chunk) parts summed in ascending
//      order.
//   Products on the FMA pipes from float32 tiles in shared memory, 4 x 4
//   register tiles a thread with scalar loads (rows padded to an odd
//   stride, so the 16 rows a warp reads fall in 16 banks), one block an SM
//   at N = 128 (189,184 bytes): 9.48 ms at mamba2-370m's shape, 22.7x its
//   bound (three TF32 products a product at the TF32 peak). Tolerance:
//   float32 sums in another order, 1e-4 of each gradient's largest
//   magnitude.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLc = 64;              // rows a chunk
constexpr int kRg = kLc / 4;         // row groups of a [kLc, *] tile map
constexpr int kMaxSmem = 232448;

struct BwdArgs {
  const void* x;       // [Bt, S, H, P]
  const float* dt;     // [Bt, S, H]
  const float* A;      // [H]
  const void* B;       // [Bt, S, G, N]
  const void* C;       // [Bt, S, G, N]
  const float* s0;     // [Bt, H, N, P] or null
  const float* dy;     // [Bt, S, H, P]
  const float* dlast;  // [Bt, H, N, P] or null
  float* sin;          // [Bt, nc, H, N, P]: chunk states, then entry states
  float* gout;         // [Bt, nc, H, N, P]: chunk terms, then exit gradients
  float* tot;          // [Bt, nc, H]
  void* dx;            // [Bt, S, H, P]
  float* ddt;          // [Bt, S, H]
  float* dbh;          // [Bt, S, H, N]: each head's part of dB
  float* dch;          // [Bt, S, H, N]: each head's part of dC
  float* dah;          // [Bt, nc, H]: each (b, chunk, h)'s part of dA
  float* da;           // [H]
  void* db;            // [Bt, S, G, N]
  void* dc;            // [Bt, S, G, N]
  float* ds0;          // [Bt, H, N, P] or null
  int bt, s, h, p, g, n, nc;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// acc[m][q] += sum_{k < kn} a(m, k) * b(k, q): a 4 x 4 register tile on the
// FMA pipes.
template <typename FA, typename FB>
__device__ __forceinline__ void tile44(float (&acc)[4][4], int kn, FA a,
                                       FB b) {
#pragma unroll 2
  for (int k = 0; k < kn; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) av[m] = a(m, k);
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = b(k, q);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][q] = fmaf(av[m], bv[q], acc[m][q]);
  }
}

__device__ __forceinline__ void zero44(float (&acc)[4][4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[m][q] = 0.0f;
}

// A chunk's operands in shared memory: rows padded to an odd stride.
struct Stage {
  float* cs;     // [kLc][n + 1]  C of the group
  float* bs;     // [kLc][n + 1]  B of the group
  float* xs;     // [kLc][p + 1]  x of the head
  float* dys;    // [kLc][p + 1]  dy of the head
  float* dts;    // [kLc]
  float* cum;    // [kLc]
  float* ecum;   // [kLc]  e^cum
  float* ew;     // [kLc]  e^(tot - cum)
  float* ws;     // [kLc]  e^(tot - cum) dt
  float* end;    // the first float after these
};

__host__ __device__ __forceinline__ int stage_floats(int n, int p) {
  return 2 * kLc * (n + 1) + 2 * kLc * (p + 1) + 5 * kLc;
}

__device__ __forceinline__ Stage carve(float* smem, int n, int p) {
  Stage st;
  st.cs = smem;
  st.bs = st.cs + kLc * (n + 1);
  st.xs = st.bs + kLc * (n + 1);
  st.dys = st.xs + kLc * (p + 1);
  st.dts = st.dys + kLc * (p + 1);
  st.cum = st.dts + kLc;
  st.ecum = st.cum + kLc;
  st.ew = st.ecum + kLc;
  st.ws = st.ew + kLc;
  st.end = st.ws + kLc;
  return st;
}

// Stage chunk c of (b, h): x, dy, B, C, dt (zeros past S), then the prefix
// sum of dt A and its exponentials. Returns tot. Ends on a barrier.
template <typename T>
__device__ float stage_chunk(const BwdArgs& a, const Stage& st, int b, int c,
                             int hh) {
  const int tid = threadIdx.x, n = a.n, p = a.p;
  const int gi = hh / (a.h / a.g);
  const int c0 = c * kLc;
  const int lr = a.s - c0 < kLc ? a.s - c0 : kLc;
  const T* const x = static_cast<const T*>(a.x);
  const T* const B = static_cast<const T*>(a.B);
  const T* const C = static_cast<const T*>(a.C);
  for (int idx = tid; idx < kLc * p; idx += kThreads) {
    const int i = idx / p, pp = idx % p;
    float xv = 0.0f, dv = 0.0f;
    if (i < lr) {
      const long long off =
          ((static_cast<long long>(b) * a.s + c0 + i) * a.h + hh) * p + pp;
      xv = to_f32(x[off]);
      dv = a.dy[off];
    }
    st.xs[i * (p + 1) + pp] = xv;
    st.dys[i * (p + 1) + pp] = dv;
  }
  for (int idx = tid; idx < kLc * n; idx += kThreads) {
    const int i = idx / n, nn = idx % n;
    float bv = 0.0f, cv = 0.0f;
    if (i < lr) {
      const long long off =
          ((static_cast<long long>(b) * a.s + c0 + i) * a.g + gi) * n + nn;
      bv = to_f32(B[off]);
      cv = to_f32(C[off]);
    }
    st.bs[i * (n + 1) + nn] = bv;
    st.cs[i * (n + 1) + nn] = cv;
  }
  for (int i = tid; i < kLc; i += kThreads)
    st.dts[i] = i < lr ? a.dt[(static_cast<long long>(b) * a.s + c0 + i) *
                                  a.h + hh]
                       : 0.0f;
  __syncthreads();
  if (tid < 32) {                        // prefix sum of dt A, one warp
    const float A = a.A[hh];
    const int i0 = 2 * tid;              // kLc = 64: two rows a lane
    const float v0 = st.dts[i0] * A, v1 = st.dts[i0 + 1] * A;
    const float local = v0 + v1;
    float incl = local;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl += v;
    }
    const float run = incl - local;
    st.cum[i0] = run + v0;
    st.cum[i0 + 1] = run + v0 + v1;
  }
  __syncthreads();
  const float tot = st.cum[kLc - 1];
  for (int i = tid; i < kLc; i += kThreads) {
    st.ecum[i] = expf(st.cum[i]);
    st.ew[i] = expf(tot - st.cum[i]);
    st.ws[i] = st.ew[i] * st.dts[i];
  }
  __syncthreads();
  return tot;
}

// ---------------------------------------------------------------------------
// 1. each chunk's own state and state gradient
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_chunk_kernel(BwdArgs a) {
  extern __shared__ float4 smem4[];
  const int n = a.n, p = a.p, tid = threadIdx.x;
  const int hh = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const Stage st = carve(reinterpret_cast<float*>(smem4), n, p);
  const float tot = stage_chunk<T>(a, st, b, c, hh);
  // fold w into B and e^cum into C: neither is read again here
  for (int idx = tid; idx < kLc * n; idx += kThreads) {
    const int i = idx / n, nn = idx % n;
    st.bs[i * (n + 1) + nn] *= st.ws[i];
    st.cs[i * (n + 1) + nn] *= st.ecum[i];
  }
  __syncthreads();
  const long long slot =
      ((static_cast<long long>(b) * a.nc + c) * a.h + hh) * n * p;
  const int rgn = n / 4, tiles = (n / 4) * (p / 4);
  for (int t = tid; t < tiles; t += kThreads) {
    const int rg = t % rgn, p0 = (t / rgn) * 4;
    float cs[4][4], ls[4][4];
    zero44(cs);
    zero44(ls);
    tile44(cs, kLc, [&](int m, int k) { return st.bs[k * (n + 1) + rg + rgn * m]; },
           [&](int k, int q) { return st.xs[k * (p + 1) + p0 + q]; });
    tile44(ls, kLc, [&](int m, int k) { return st.cs[k * (n + 1) + rg + rgn * m]; },
           [&](int k, int q) { return st.dys[k * (p + 1) + p0 + q]; });
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long e = slot + (rg + rgn * m) * p + p0 + q;
        a.sin[e] = cs[m][q];
        a.gout[e] = ls[m][q];
      }
  }
  if (tid == 0)
    a.tot[(static_cast<long long>(b) * a.nc + c) * a.h + hh] = tot;
}

// ---------------------------------------------------------------------------
// 2. entry states forward, exit gradients backward
// ---------------------------------------------------------------------------

// Each thread walks its element's chunks in batches of kScanBatch: the
// batch's loads are issued together, before its stores, so that they are
// in flight at once. One load a step, each after the store before it,
// leaves the walk bound by the latency of device memory.
constexpr int kScanBatch = 8;

__device__ __forceinline__ float walk(float* buf, const float* tot, float v,
                                      long long row0, long long row_step,
                                      int np, int e, int nc) {
  for (int c0 = 0; c0 < nc; c0 += kScanBatch) {
    float own[kScanBatch], decay[kScanBatch];
#pragma unroll
    for (int k = 0; k < kScanBatch; ++k)
      if (c0 + k < nc) {
        const long long row = row0 + (c0 + k) * row_step;
        own[k] = buf[row * np + e];
        decay[k] = expf(tot[row]);
      }
#pragma unroll
    for (int k = 0; k < kScanBatch; ++k)
      if (c0 + k < nc) {
        buf[(row0 + (c0 + k) * row_step) * np + e] = v;
        v = decay[k] * v + own[k];
      }
  }
  return v;
}

__global__ void __launch_bounds__(kThreads) ssd_bwd_scan_kernel(BwdArgs a) {
  const int np = a.n * a.p;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int bh = blockIdx.y, b = bh / a.h, hh = bh % a.h;
  if (e >= np) return;
  const long long head = static_cast<long long>(bh) * np + e;
  // rows (b, c, hh) of [Bt, nc, H]: forward from chunk 0, backward from
  // chunk nc - 1
  const long long first = static_cast<long long>(b) * a.nc * a.h + hh;
  const long long last = first + static_cast<long long>(a.nc - 1) * a.h;
  walk(a.sin, a.tot, a.s0 != nullptr ? a.s0[head] : 0.0f, first, a.h, np, e,
       a.nc);
  const float grad = walk(a.gout, a.tot,
                          a.dlast != nullptr ? a.dlast[head] : 0.0f, last,
                          -static_cast<long long>(a.h), np, e, a.nc);
  if (a.ds0 != nullptr) a.ds0[head] = grad;
}

// ---------------------------------------------------------------------------
// 3. the gradients of a (b, chunk, h)
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ int grad_floats(int n, int p) {
  return stage_floats(n, p)
         + 2 * kLc * (kLc + 1)      // K dt, Q D dt
         + n * (p + 1)              // Gout, then Sin
         + 3 * kRg * kLc            // t row / column parts, K Q column parts
         + 2 * (p / 4) * kLc        // (B Gout).x and (C Sin).dy parts
         + kThreads                 // <Gout, Sin> parts
         + 2 * kLc;                 // gcum, u
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_grad_kernel(BwdArgs a) {
  extern __shared__ float4 smem4[];
  const int n = a.n, p = a.p, tid = threadIdx.x;
  const int hh = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int ldn = n + 1, ldp = p + 1, ldl = kLc + 1, pg = p / 4;
  const Stage st = carve(reinterpret_cast<float*>(smem4), n, p);
  float* const kt = st.end;               // [kLc][ldl]  K_ij dt_j, i >= j
  float* const qdt = kt + kLc * ldl;      // [kLc][ldl]  Q_ij D_ij dt_j
  float* const ss = qdt + kLc * ldl;      // [n][ldp]    Gout, then Sin
  float* const prow = ss + n * ldp;       // [kRg][kLc]  sum_j t_ij parts
  float* const pcol = prow + kRg * kLc;   // [kRg][kLc]  sum_i t_ij parts
  float* const pkq = pcol + kRg * kLc;    // [kRg][kLc]  sum_i K_ij Q_ij parts
  float* const pr = pkq + kRg * kLc;      // [pg][kLc]   (B_j Gout).x_j parts
  float* const pv = pr + pg * kLc;        // [pg][kLc]   (C_i Sin).dy_i parts
  float* const red = pv + pg * kLc;       // [kThreads]  <Gout, Sin> parts
  float* const gc = red + kThreads;       // [kLc]       gcum
  float* const us = gc + kLc;             // [kLc]       u

  const float tot = stage_chunk<T>(a, st, b, c, hh);
  const long long row0 = static_cast<long long>(b) * a.s + c * kLc;
  const int lr = a.s - c * kLc < kLc ? a.s - c * kLc : kLc;
  const long long slot =
      ((static_cast<long long>(b) * a.nc + c) * a.h + hh) * n * p;
  for (int idx = tid; idx < n * p; idx += kThreads)
    ss[(idx / p) * ldp + idx % p] = a.gout[slot + idx];

  // K and Q over the chunk's (i, j) pairs: a 4 x 4 tile a thread, rows
  // i = rg + 16 m, columns j = j0 + q
  {
    const int rg = tid % kRg, j0 = (tid / kRg) * 4;
    float cb[4][4], qq[4][4];
    zero44(cb);
    zero44(qq);
    tile44(cb, n, [&](int m, int k) { return st.cs[(rg + kRg * m) * ldn + k]; },
           [&](int k, int q) { return st.bs[(j0 + q) * ldn + k]; });
    tile44(qq, p, [&](int m, int k) { return st.dys[(rg + kRg * m) * ldp + k]; },
           [&](int k, int q) { return st.xs[(j0 + q) * ldp + k]; });
    float row[4] = {}, col[4] = {}, kq[4] = {};
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = rg + kRg * m, j = j0 + q;
        float kv = 0.0f, qv = 0.0f;
        if (i >= j) {
          const float d = expf(st.cum[i] - st.cum[j]);
          kv = cb[m][q] * d;
          qv = qq[m][q] * d * st.dts[j];
          const float t = kv * st.dts[j] * qq[m][q];
          row[m] += t;
          col[q] += t;
          kq[q] += kv * qq[m][q];
        }
        kt[i * ldl + j] = kv * st.dts[j];
        qdt[i * ldl + j] = qv;
      }
#pragma unroll
    for (int m = 0; m < 4; ++m) prow[(j0 / 4) * kLc + rg + kRg * m] = row[m];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      pcol[rg * kLc + j0 + q] = col[q];
      pkq[rg * kLc + j0 + q] = kq[q];
    }
  }
  __syncthreads();

  T* const dx = static_cast<T*>(a.dx);
  // dx_j = sum_i K_ij dt_j dy_i + w_j (B_j Gout); (B_j Gout).x_j parts
  for (int t = tid; t < kRg * pg; t += kThreads) {
    const int rg = t % kRg, cg = t / kRg, p0 = cg * 4;
    float ai[4][4], ag[4][4];
    zero44(ai);
    zero44(ag);
    tile44(ai, kLc, [&](int m, int k) { return kt[k * ldl + rg + kRg * m]; },
           [&](int k, int q) { return st.dys[k * ldp + p0 + q]; });
    tile44(ag, n, [&](int m, int k) { return st.bs[(rg + kRg * m) * ldn + k]; },
           [&](int k, int q) { return ss[k * ldp + p0 + q]; });
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = rg + kRg * m;
      float r = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        r = fmaf(ag[m][q], st.xs[j * ldp + p0 + q], r);
        if (j < lr)
          dx[((row0 + j) * a.h + hh) * p + p0 + q] =
              from_f32<T>(ai[m][q] + st.ws[j] * ag[m][q]);
      }
      pr[cg * kLc + j] = r;
    }
  }
  // dB_j (this head's part) = sum_i Q_ij D_ij dt_j C_i + w_j (Gout x_j)
  for (int t = tid; t < kRg * (n / 4); t += kThreads) {
    const int rg = t % kRg, n0 = (t / kRg) * 4;
    float ad[4][4], ag[4][4];
    zero44(ad);
    zero44(ag);
    tile44(ad, kLc, [&](int m, int k) { return qdt[k * ldl + rg + kRg * m]; },
           [&](int k, int q) { return st.cs[k * ldn + n0 + q]; });
    tile44(ag, p, [&](int m, int k) { return st.xs[(rg + kRg * m) * ldp + k]; },
           [&](int k, int q) { return ss[(n0 + q) * ldp + k]; });
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = rg + kRg * m;
      if (j >= lr) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        a.dbh[((row0 + j) * a.h + hh) * n + n0 + q] =
            ad[m][q] + st.ws[j] * ag[m][q];
    }
  }
  __syncthreads();                       // every reader of Gout is done

  // Sin in place of Gout, and this thread's part of <Gout, Sin>
  float dot = 0.0f;
  for (int idx = tid; idx < n * p; idx += kThreads) {
    const float sv = a.sin[slot + idx];
    dot = fmaf(a.gout[slot + idx], sv, dot);
    ss[(idx / p) * ldp + idx % p] = sv;
  }
  red[tid] = dot;
  __syncthreads();

  // dC_i (this head's part) = sum_j Q_ij D_ij dt_j B_j + e^cum_i (Sin dy_i)
  for (int t = tid; t < kRg * (n / 4); t += kThreads) {
    const int rg = t % kRg, n0 = (t / kRg) * 4;
    float ae[4][4], as[4][4];
    zero44(ae);
    zero44(as);
    tile44(ae, kLc, [&](int m, int k) { return qdt[(rg + kRg * m) * ldl + k]; },
           [&](int k, int q) { return st.bs[k * ldn + n0 + q]; });
    tile44(as, p, [&](int m, int k) { return st.dys[(rg + kRg * m) * ldp + k]; },
           [&](int k, int q) { return ss[(n0 + q) * ldp + k]; });
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = rg + kRg * m;
      if (i >= lr) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        a.dch[((row0 + i) * a.h + hh) * n + n0 + q] =
            ae[m][q] + st.ecum[i] * as[m][q];
    }
  }
  // (C_i Sin).dy_i parts
  for (int t = tid; t < kRg * pg; t += kThreads) {
    const int rg = t % kRg, cg = t / kRg, p0 = cg * 4;
    float av[4][4];
    zero44(av);
    tile44(av, n, [&](int m, int k) { return st.cs[(rg + kRg * m) * ldn + k]; },
           [&](int k, int q) { return ss[k * ldp + p0 + q]; });
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = rg + kRg * m;
      float v = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v = fmaf(av[m][q], st.dys[i * ldp + p0 + q], v);
      pv[cg * kLc + i] = v;
    }
  }
  __syncthreads();

  // gcum, each part summed in ascending order
  float rsum = 0.0f;
  if (tid < kLc) {
    const int k = tid;
    float rt = 0.0f, ct = 0.0f, r = 0.0f, v = 0.0f;
    for (int q = 0; q < kRg; ++q) {
      rt += prow[q * kLc + k];
      ct += pcol[q * kLc + k];
    }
    for (int q = 0; q < pg; ++q) {
      r += pr[q * kLc + k];
      v += pv[q * kLc + k];
    }
    rsum = r;
    const float u = st.ws[k] * r;
    us[k] = u;
    gc[k] = rt - ct + st.ecum[k] * v - u;
  }
  __syncthreads();
  if (tid == 0) {
    float usum = 0.0f, dsum = 0.0f;
    for (int k = 0; k < kLc; ++k) usum += us[k];
    for (int k = 0; k < kThreads; ++k) dsum += red[k];
    gc[kLc - 1] += usum + expf(tot) * dsum;
    float suffix = 0.0f, da = 0.0f;
    for (int k = kLc - 1; k >= 0; --k) {   // gc becomes its suffix sums
      suffix += gc[k];
      gc[k] = suffix;
    }
    for (int k = 0; k < kLc; ++k) da = fmaf(st.dts[k], gc[k], da);
    a.dah[(static_cast<long long>(b) * a.nc + c) * a.h + hh] = da;
  }
  __syncthreads();
  if (tid < lr) {
    const int j = tid;
    float kq = 0.0f;
    for (int q = 0; q < kRg; ++q) kq += pkq[q * kLc + j];
    a.ddt[(row0 + j) * a.h + hh] =
        kq + st.ew[j] * rsum + a.A[hh] * gc[j];
  }
}

// ---------------------------------------------------------------------------
// 4.-5. the sums over a group's heads and over (b, chunk)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_group_kernel(BwdArgs a) {
  const long long total = static_cast<long long>(a.bt) * a.s * a.g * a.n;
  const long long e = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (e >= total) return;
  const int nn = static_cast<int>(e % a.n);
  const long long rest = e / a.n;
  const int gi = static_cast<int>(rest % a.g);
  const long long row = rest / a.g;              // b * S + s
  const int hpg = a.h / a.g;
  float sb = 0.0f, sc = 0.0f;
  for (int k = 0; k < hpg; ++k) {
    const long long src = (row * a.h + gi * hpg + k) * a.n + nn;
    sb += a.dbh[src];
    sc += a.dch[src];
  }
  static_cast<T*>(a.db)[e] = from_f32<T>(sb);
  static_cast<T*>(a.dc)[e] = from_f32<T>(sc);
}

__global__ void __launch_bounds__(kThreads) ssd_bwd_da_kernel(BwdArgs a) {
  for (int hh = threadIdx.x; hh < a.h; hh += kThreads) {
    float s = 0.0f;
    for (long long r = 0; r < static_cast<long long>(a.bt) * a.nc; ++r)
      s += a.dah[r * a.h + hh];
    a.da[hh] = s;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

typedef __nv_bfloat16 bf16;
constexpr int kHeadsMax = 8;         // heads a gradient block walks at most
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const bf16* x;       // [Bt, S, H, P]
  const float* dt;     // [Bt, S, H]
  const float* A;      // [H]
  const bf16* B;       // [Bt, S, G, N]
  const bf16* C;       // [Bt, S, G, N]
  const float* s0;     // [Bt, H, N, P] or null
  const float* dy;     // [Bt, S, H, P]
  const float* dlast;  // [Bt, H, N, P] or null
  bf16* sin;           // [Bt, nc, H, 2, N', P']: entry states, hi and lo
  bf16* gout;          // [Bt, nc, H, 2, N', P']: exit gradients, hi and lo
  bf16* dys;           // [Bt, nc, H, 2, kLc, P']: dy, hi and lo
  bf16* dx;            // [Bt, S, H, P]
  float* ddt;          // [Bt, S, H]
  float* dbp;          // [Bt, S, G * nsl, N]: each head slice's part of dB
  float* dcp;          // [Bt, S, G * nsl, N]: ... of dC
  float* dah;          // [Bt, nc, H]
  float* ds0;          // [Bt, H, N, P] or null
  int bt, s, h, p, g, n, nc, hs, nsl;
};

// Byte offset of element (r, k) in a tile of rows of WT bf16: the 16-byte
// chunks of a row are XOR-swizzled so that the 8 rows an `ldmatrix` matrix
// reads at one chunk fall in 8 distinct bank groups (as in ssd_scan.cu).
// The pattern repeats every 8 rows, so tiles stacked at multiples of 8
// rows keep it.
template <int WT>
__device__ __forceinline__ uint32_t chunk_off(int r, int c) {
  constexpr int W = WT / 8;
  const int sw = W >= 8 ? (c ^ (r & 7)) : (c ^ ((r / (8 / W)) & (W - 1)));
  return static_cast<uint32_t>(r * WT * 2 + sw * 16);
}
template <int WT>
__device__ __forceinline__ uint32_t elem_off(int r, int k) {
  return chunk_off<WT>(r, k >> 3) + (k & 7) * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes, bool ok) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 16 : 0) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 8 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// d += a b: m16n8k16, bf16 in, float32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 2^v, MUFU.EX2 (relative error about 2^-22)
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
// (a, b) -> hi = bf16(a, b), lo = bf16((a, b) - hi), a in the low half
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}
// The four A-fragment registers of a 16 x 16 block held as two n8
// accumulator tiles v[u][e] (rows g, g + 8; columns 8 u + 2 t (+ 1)),
// split into hi and lo terms.
__device__ __forceinline__ void split_frag(const float (&v)[2][4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split(v[0][0], v[0][1], hi[0], lo[0]);
  split(v[0][2], v[0][3], hi[1], lo[1]);
  split(v[1][0], v[1][1], hi[2], lo[2]);
  split(v[1][2], v[1][3], hi[3], lo[3]);
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
// The prefix sum of dt A log2(e) over a chunk, rows 2 lane and 2 lane + 1
// of one warp: (cum of both rows, the chunk's total in every lane).
__device__ __forceinline__ float chunk_cum(float d0, float d1, float a2,
                                           float& cum0, float& cum1) {
  const int lane = threadIdx.x & 31;
  const float v0 = d0 * a2, local = v0 + d1 * a2;
  float incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const float excl = incl - local;
  cum0 = excl + v0;
  cum1 = excl + local;
  return __shfl_sync(0xffffffffu, cum1, 31);
}

// Rows [0, kLc) of one operand of a chunk into a swizzled tile of WT
// columns: row i from global element src_row0 + i * stride, `width`
// elements; rows at or past `lr` stage as zeros (ssd_scan.cu's copy).
template <int WT>
__device__ __forceinline__ void stage_rows(uint32_t dst, const bf16* src,
                                           long long src_row0,
                                           long long stride, int width,
                                           int lr) {
  if (width == WT) {
    constexpr int kPer = WT / 8;
    for (int idx = threadIdx.x; idx < kLc * kPer; idx += kThreads) {
      const int i = idx / kPer, c = idx % kPer;
      const bool ok = i < lr;
      cp_async(dst + chunk_off<WT>(i, c),
               ok ? src + src_row0 + i * stride + 8 * c : src, 16, ok);
    }
    return;
  }
  const int bytes = width % 8 == 0 ? 16 : 8;
  const int per_row = width * 2 / bytes;
  for (int idx = threadIdx.x; idx < kLc * per_row; idx += kThreads) {
    const int i = idx / per_row, piece = idx % per_row;
    const int k = piece * bytes / 2;
    const bool ok = i < lr;
    cp_async(dst + elem_off<WT>(i, k), ok ? src + src_row0 + i * stride + k
                                          : src,
             bytes, ok);
  }
}
// Zero columns [width, WT) of kLc rows: padding that no copy writes.
template <int WT>
__device__ __forceinline__ void zero_pad(uint8_t* tile, int width) {
  const int cols = WT - width;
  for (int idx = threadIdx.x; idx < kLc * cols; idx += kThreads) {
    const int r = idx / cols, k = width + idx % cols;
    *reinterpret_cast<bf16*>(tile + elem_off<WT>(r, k)) =
        __float2bfloat16(0.0f);
  }
}
// `rows` contiguous rows of WT bf16 (the scratch, whole rows) into a
// swizzled tile
template <int WT>
__device__ __forceinline__ void copy_rows(uint32_t dst, const bf16* src,
                                          int rows) {
  constexpr int kPer = WT / 8;
  for (int idx = threadIdx.x; idx < rows * kPer; idx += kThreads)
    cp_async(dst + chunk_off<WT>(idx / kPer, idx % kPer), src + 8 * idx, 16,
             true);
}

// ---- the walks: entry states forward, exit gradients backward ----------

template <int NT, int PT>
struct WalkShape {
  static constexpr int RT = NT / 16;             // row tiles of the state
  static constexpr int WPR = 8 / RT;             // warps a row tile
  static constexpr int P8 = PT / 8;              // n8 tiles over P
  static constexpr int NPW = P8 / WPR >= 2 ? P8 / WPR : 2;   // a warp's
  static constexpr int CG = P8 / NPW;            // column groups in use
  static constexpr int kOp = kLc * NT * 2;       // the B or C tile
  static constexpr int kVal = kLc * PT * 2;      // x, or one term of dy
  static constexpr int kSlot = kOp + 2 * kVal;
  static constexpr int kState = 2 * NT * PT * 2;   // the state's two terms
  static constexpr int kSmem = 2 * kSlot + 2 * kLc * 4 + kState;
  static constexpr int kDyV = kLc * PT / 4 / kThreads;   // float4 a thread
};

// A block per (head, batch row, direction). Direction 0 walks the chunks
// forward from s0 and writes each chunk's entry state Sin; direction 1
// walks them backward from d_last and writes each chunk's exit gradient
// Gout, dy split into two bf16 terms on the way, and ds0. The [N, P]
// state stays in float32 accumulators, 16 of its rows and 2-8 n8 tiles a
// warp; a chunk adds (w B)^T x (forward: w_j = e^(tot - cum_j) dt_j) or
// (e^cum C)^T dy (backward), the scaled operand split into two bf16
// terms, dy too (its lo x lo product is not issued).
template <int NT, int PT>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_bwd_walk_kernel(Args a) {
  using W = WalkShape<NT, PT>;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  float* const sc_s = reinterpret_cast<float*>(smem + 2 * W::kSlot);
  uint8_t* const state_s = smem + 2 * W::kSlot + 2 * kLc * 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr8 = lane & 7, q1 = (lane >> 3) & 1, q2 = lane >> 4;
  const int head = blockIdx.x, b = blockIdx.y;
  const bool fwd = blockIdx.z == 0;
  const int gi = head / (a.h / a.g);
  const float a2 = a.A[head] * kLog2e;
  const long long row_bs = static_cast<long long>(b) * a.s;
  const int nc = a.nc;
  const int rt = warp % W::RT, cw = warp / W::RT;
  const bool active = cw < W::CG;
  const int n0 = 16 * rt, pt0 = cw * W::NPW;
  const long long head_state = (static_cast<long long>(b) * a.h + head) *
                               a.n * a.p;

  auto stage = [&](int st, int c) {
    const int c0 = c * kLc, lr = min(kLc, a.s - c0);
    uint8_t* const at = smem + st * W::kSlot;
    const uint32_t dst = base + st * W::kSlot;
    if (a.n < NT) zero_pad<NT>(at, a.n);
    stage_rows<NT>(dst, fwd ? a.B : a.C, ((row_bs + c0) * a.g + gi) * a.n,
                   static_cast<long long>(a.g) * a.n, a.n, lr);
    if (fwd) {
      if (a.p < PT) zero_pad<PT>(at + W::kOp, a.p);
      stage_rows<PT>(dst + W::kOp, a.x, ((row_bs + c0) * a.h + head) * a.p,
                     static_cast<long long>(a.h) * a.p, a.p, lr);
    }
  };
  float4 dyr[W::kDyV];
  auto load_dy = [&](int c) {
    const int c0 = c * kLc;
#pragma unroll
    for (int k = 0; k < W::kDyV; ++k) {
      const int idx = threadIdx.x + k * kThreads;
      const int i = idx / (PT / 4), col = (idx % (PT / 4)) * 4;
      dyr[k] = c0 + i < a.s && col < a.p
                   ? *reinterpret_cast<const float4*>(
                         a.dy + ((row_bs + c0 + i) * a.h + head) * a.p + col)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  // dy's two terms into the slot's value tiles and the scratch
  auto store_dy = [&](int st, int c) {
    uint8_t* const vt = smem + st * W::kSlot + W::kOp;
    bf16* const gs = a.dys + ((static_cast<long long>(b) * nc + c) * a.h +
                              head) * 2 * kLc * PT;
#pragma unroll
    for (int k = 0; k < W::kDyV; ++k) {
      const int idx = threadIdx.x + k * kThreads;
      const int i = idx / (PT / 4), col = (idx % (PT / 4)) * 4;
      uint32_t h0, l0, h1, l1;
      split(dyr[k].x, dyr[k].y, h0, l0);
      split(dyr[k].z, dyr[k].w, h1, l1);
      *reinterpret_cast<uint2*>(vt + elem_off<PT>(i, col)) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(vt + W::kVal + elem_off<PT>(i, col)) =
          make_uint2(l0, l1);
      *reinterpret_cast<uint2*>(gs + i * PT + col) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(gs + kLc * PT + i * PT + col) =
          make_uint2(l0, l1);
    }
  };
  float dtr[2];
  auto load_dt = [&](int c) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = c * kLc + 2 * lane + k;
      dtr[k] = i < a.s ? a.dt[(row_bs + i) * a.h + head] : 0.0f;
    }
  };

  float acc[W::NPW][4];
  const float* const init = fwd ? a.s0 : a.dlast;
#pragma unroll
  for (int j = 0; j < W::NPW; ++j)
#pragma unroll
    for (int hv = 0; hv < 2; ++hv) {
      const int r = n0 + g + 8 * hv, col = 8 * (pt0 + j) + 2 * t;
      float2 v = make_float2(0.0f, 0.0f);
      if (init != nullptr && active && r < a.n && col < a.p)
        v = *reinterpret_cast<const float2*>(init + head_state + r * a.p +
                                             col);
      acc[j][2 * hv] = v.x;
      acc[j][2 * hv + 1] = v.y;
    }
  // the state before chunk c, split, into shared memory; then the whole
  // [2, N', P'] into the scratch (padding included) in 16-byte stores
  auto split_state = [&]() {
    if (!active) return;
#pragma unroll
    for (int j = 0; j < W::NPW; ++j)
#pragma unroll
      for (int hv = 0; hv < 2; ++hv) {
        const int r = n0 + g + 8 * hv, col = 8 * (pt0 + j) + 2 * t;
        uint32_t hi, lo;
        split(acc[j][2 * hv], acc[j][2 * hv + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(state_s + elem_off<PT>(r, col)) = hi;
        *reinterpret_cast<uint32_t*>(state_s + elem_off<PT>(NT + r, col)) =
            lo;
      }
  };
  auto write_state = [&](int c) {
    bf16* const dst = (fwd ? a.sin : a.gout) +
                      ((static_cast<long long>(b) * nc + c) * a.h + head) *
                          2 * NT * PT;
    for (int idx = threadIdx.x; idx < 2 * NT * PT / 8; idx += kThreads)
      *reinterpret_cast<uint4*>(dst + 8 * idx) =
          *reinterpret_cast<const uint4*>(
              state_s + chunk_off<PT>(idx / (PT / 8), idx % (PT / 8)));
  };

  const int first = fwd ? 0 : nc - 1, step = fwd ? 1 : -1;
  stage(0, first);
  cp_async_commit();
  load_dt(first);
  if (!fwd) load_dy(first);
  for (int k = 0; k < nc; ++k) {
    const int c = first + step * k, st = k & 1;
    const uint32_t ot = base + st * W::kSlot, vt = ot + W::kOp;
    float* const sc = sc_s + st * kLc;
    if (!fwd) store_dy(st, c);
    float cum0, cum1;
    const float tot = chunk_cum(dtr[0], dtr[1], a2, cum0, cum1);
    if (warp == 0) {
      sc[2 * lane] = fwd ? ex2(tot - cum0) * dtr[0] : ex2(cum0);
      sc[2 * lane + 1] = fwd ? ex2(tot - cum1) * dtr[1] : ex2(cum1);
    }
    const float decay = ex2(tot);
    cp_async_wait<0>();
    __syncthreads();          // chunk c's tiles and scales; the other slot
                              // and the state's tiles free
    split_state();
    if (k + 1 < nc) {
      stage(st ^ 1, c + step);
      load_dt(c + step);
      if (!fwd) load_dy(c + step);
    }
    cp_async_commit();
    __syncthreads();          // the state's split
    write_state(c);
    if (!active) continue;
#pragma unroll
    for (int j = 0; j < W::NPW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= decay;
#pragma unroll
    for (int ks = 0; ks < kLc / 16; ++ks) {
      const int j0 = 16 * ks;
      uint32_t af[4], ah[4], al[4];
      ldsm_t(af, ot + chunk_off<NT>(j0 + lr8 + 8 * q2, 2 * rt + q1));
      const float2 s0v = *reinterpret_cast<const float2*>(sc + j0 + 2 * t);
      const float2 s1v = *reinterpret_cast<const float2*>(sc + j0 + 8 + 2 * t);
      const float2 f0 = unpack(af[0]), f1 = unpack(af[1]);
      const float2 f2 = unpack(af[2]), f3 = unpack(af[3]);
      split(f0.x * s0v.x, f0.y * s0v.y, ah[0], al[0]);
      split(f1.x * s0v.x, f1.y * s0v.y, ah[1], al[1]);
      split(f2.x * s1v.x, f2.y * s1v.y, ah[2], al[2]);
      split(f3.x * s1v.x, f3.y * s1v.y, ah[3], al[3]);
#pragma unroll
      for (int pp = 0; pp < W::NPW / 2; ++pp) {
        const uint32_t off = chunk_off<PT>(j0 + lr8 + 8 * q1,
                                           pt0 + 2 * pp + q2);
        uint32_t vh[4];
        ldsm_t(vh, vt + off);
        mma(acc[2 * pp], ah, vh[0], vh[1]);
        mma(acc[2 * pp + 1], ah, vh[2], vh[3]);
        mma(acc[2 * pp], al, vh[0], vh[1]);
        mma(acc[2 * pp + 1], al, vh[2], vh[3]);
        if (!fwd) {
          uint32_t vl[4];
          ldsm_t(vl, vt + W::kVal + off);
          mma(acc[2 * pp], ah, vl[0], vl[1]);
          mma(acc[2 * pp + 1], ah, vl[2], vl[3]);
        }
      }
    }
  }
  if (!fwd && a.ds0 != nullptr && active)
#pragma unroll
    for (int j = 0; j < W::NPW; ++j)
#pragma unroll
      for (int hv = 0; hv < 2; ++hv) {
        const int r = n0 + g + 8 * hv, col = 8 * (pt0 + j) + 2 * t;
        if (r < a.n && col < a.p)
          *reinterpret_cast<float2*>(a.ds0 + head_state + r * a.p + col) =
              make_float2(acc[j][2 * hv], acc[j][2 * hv + 1]);
      }
}

// ---- the gradients of a (head slice, chunk, batch row) ----------------

template <int NT, int PT>
struct GradShape {
  static constexpr int kBC = kLc * NT * 2;       // the B or C tile
  static constexpr int kX = kLc * PT * 2;        // x; a term of dy
  static constexpr int kS = NT * PT * 2;         // a term of Gout or Sin
  // a head's slot: x, dy (2 terms), Gout (2), Sin (2)
  static constexpr int kSlot = 3 * kX + 4 * kS;
  // two heads' per-row terms (5), the warps' row sums (5) and <Gout, Sin>
  // parts (8)
  static constexpr int kRowFloats = 10 * kLc + 8;
  static constexpr int kRows = 2 * kRowFloats * 4;
  static constexpr int kSmem = 2 * kBC + 2 * kSlot + kRows;
};

// Warps 0-3 own 16 rows j of the chunk (dx, dB, the column sums), warps
// 4-7 16 rows i (dC, the row sums); warps w and w + 4 share a scheduler and
// take 4 - w and w + 1 blocks of the causal triangle. A block of C B^T
// (transposed on the j side, B C^T) becomes K_ij dt_j in its accumulators,
// and one of dy x^T (x dy^T) Q_ij D_ij dt_j; both are recomputed a head,
// beside each other, rather than held across heads (32 registers a thread
// that the state products' wider accumulator chains take instead). The
// block walks its slice's heads in ascending order, each head's operands
// landing in a two-slot ring while the last runs, and keeps the slice's dB
// and dC rows in float32 registers.
template <int NT, int PT>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_tc_grad_kernel(Args a) {
  using GS = GradShape<NT, PT>;
  constexpr int KN = NT / 16, KP = PT / 16;     // k steps over N and P
  constexpr int N8 = NT / 8, P8 = PT / 8;       // n8 tiles over N and P
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t bts = base, cts = base + GS::kBC, slots = cts + GS::kBC;
  float* const rows =
      reinterpret_cast<float*>(smem + 2 * GS::kBC + 2 * GS::kSlot);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr8 = lane & 7, q1 = (lane >> 3) & 1, q2 = lane >> 4;
  const int sl = blockIdx.x % a.nsl, gi = blockIdx.x / a.nsl;
  const int c = blockIdx.y, b = blockIdx.z;
  const int hpg = a.h / a.g;
  const int h0 = gi * hpg + sl * a.hs;
  const int nh = min(a.hs, hpg - sl * a.hs);
  const int c0 = c * kLc, lr = min(kLc, a.s - c0);
  const long long row_bs = static_cast<long long>(b) * a.s;
  const bool jside = warp < 4;
  const int tile = warp & 3, r0 = 16 * tile;

  auto stage_head = [&](int st, int hh) {
    const uint32_t dst = slots + st * GS::kSlot;
    if (a.p < PT) zero_pad<PT>(smem + 2 * GS::kBC + st * GS::kSlot, a.p);
    stage_rows<PT>(dst, a.x, ((row_bs + c0) * a.h + hh) * a.p,
                   static_cast<long long>(a.h) * a.p, a.p, lr);
    const long long bch = (static_cast<long long>(b) * a.nc + c) * a.h + hh;
    copy_rows<PT>(dst + GS::kX, a.dys + bch * 2 * kLc * PT, 2 * kLc);
    copy_rows<PT>(dst + 3 * GS::kX, a.gout + bch * 2 * NT * PT, 2 * NT);
    copy_rows<PT>(dst + 3 * GS::kX + 2 * GS::kS, a.sin + bch * 2 * NT * PT,
                  2 * NT);
  };
  // The tail warp (j side's last tile: its scheduler's pair has the least
  // work) takes each head's per-row terms from dt a head ahead, and each
  // head's gcum, ddt and part of dA after the others have moved on.
  constexpr int kTail = 3;
  float dtr[2];
  auto load_dt = [&](int hh) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = 2 * lane + q;
      dtr[q] = i < lr ? a.dt[(row_bs + c0 + i) * a.h + hh] : 0.0f;
    }
  };
  auto row_terms = [&](float* rk, int hh) {
    float cum0, cum1;
    const float tot = chunk_cum(dtr[0], dtr[1], a.A[hh] * kLog2e, cum0, cum1);
    const float e0 = ex2(tot - cum0), e1 = ex2(tot - cum1);
    *reinterpret_cast<float2*>(rk + 2 * lane) = make_float2(cum0, cum1);
    *reinterpret_cast<float2*>(rk + kLc + 2 * lane) =
        make_float2(ex2(cum0), ex2(cum1));
    *reinterpret_cast<float2*>(rk + 2 * kLc + 2 * lane) = make_float2(e0, e1);
    *reinterpret_cast<float2*>(rk + 3 * kLc + 2 * lane) =
        make_float2(e0 * dtr[0], e1 * dtr[1]);
    *reinterpret_cast<float2*>(rk + 4 * kLc + 2 * lane) =
        make_float2(dtr[0], dtr[1]);
  };

  if (a.n < NT) {
    zero_pad<NT>(smem, a.n);
    zero_pad<NT>(smem + GS::kBC, a.n);
  }
  stage_rows<NT>(bts, a.B, ((row_bs + c0) * a.g + gi) * a.n,
                 static_cast<long long>(a.g) * a.n, a.n, lr);
  stage_rows<NT>(cts, a.C, ((row_bs + c0) * a.g + gi) * a.n,
                 static_cast<long long>(a.g) * a.n, a.n, lr);
  stage_head(0, h0);
  cp_async_commit();
  if (nh > 1) stage_head(1, h0 + 1);
  cp_async_commit();
  if (warp == kTail) {
    load_dt(h0);
    row_terms(rows, h0);
    if (nh > 1) load_dt(h0 + 1);
  }
  cp_async_wait<1>();       // B, C and the first head
  __syncthreads();

  float acc[N8][4];         // the slice's dB (j side) or dC (i side) rows
#pragma unroll
  for (int nt = 0; nt < N8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;

  for (int k = 0; k < nh; ++k) {
    const int hh = h0 + k, st = k & 1;
    const uint32_t xs = slots + st * GS::kSlot, dys = xs + GS::kX;
    const uint32_t gos = xs + 3 * GS::kX, sis = gos + 2 * GS::kS;
    // this head's per-row terms and row sums, in one of two buffers
    float* const rk = rows + st * GS::kRowFloats;
    const float* const cum_s = rk;              // log2 units
    const float* const ecum_s = rk + kLc;       // e^cum
    const float* const ew_s = rk + 2 * kLc;     // e^(tot - cum)
    const float* const w_s = rk + 3 * kLc;      // e^(tot - cum) dt
    const float* const dt_s = rk + 4 * kLc;
    float* const ct_x = rk + 5 * kLc;           // sum_i t_ij (j side)
    float* const kq_x = rk + 6 * kLc;           // sum_i K_ij Q_ij
    float* const r_x = rk + 7 * kLc;            // (B_j Gout).x_j
    float* const rt_x = rk + 8 * kLc;           // sum_j t_ij (i side)
    float* const v_x = rk + 9 * kLc;            // e^cum_i (C_i Sin).dy_i
    float* const dot_x = rk + 10 * kLc;         // <Gout, Sin> by warp

    if (jside) {
      // x_j's A fragments over P
      uint32_t xa[KP][4];
#pragma unroll
      for (int ks = 0; ks < KP; ++ks)
        ldsm(xa[ks], xs + chunk_off<PT>(r0 + lr8 + 8 * q1, 2 * ks + q2));
      float dxa[P8][4];
#pragma unroll
      for (int pt = 0; pt < P8; ++pt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dxa[pt][e] = 0.0f;
      float ctr[2] = {0.0f, 0.0f}, kqr[2] = {0.0f, 0.0f}, rr[2] = {0.0f, 0.0f};
      const float cj[2] = {cum_s[r0 + g], cum_s[r0 + g + 8]};
      const float dj[2] = {dt_s[r0 + g], dt_s[r0 + g + 8]};
      const float wj[2] = {w_s[r0 + g], w_s[r0 + g + 8]};
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        if (kb < tile) continue;
        // B_j C_i^T (the group's) and Q^T = x_j . dy_i (dy in two terms),
        // six accumulator chains
        float sb[2][4] = {}, qt[2][4] = {}, q2t[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < KN; ++ks) {
          uint32_t af[4], bf[4];
          ldsm(af, bts + chunk_off<NT>(r0 + lr8 + 8 * q1, 2 * ks + q2));
          ldsm(bf, cts + chunk_off<NT>(16 * kb + lr8 + 8 * q2, 2 * ks + q1));
          mma(sb[0], af, bf[0], bf[1]);
          mma(sb[1], af, bf[2], bf[3]);
        }
#pragma unroll
        for (int ks = 0; ks < KP; ++ks) {
          const uint32_t off =
              chunk_off<PT>(16 * kb + lr8 + 8 * q2, 2 * ks + q1);
          uint32_t bh[4], bl[4];
          ldsm(bh, dys + off);
          ldsm(bl, dys + GS::kX + off);
          mma(qt[0], xa[ks], bh[0], bh[1]);
          mma(qt[1], xa[ks], bh[2], bh[3]);
          mma(q2t[0], xa[ks], bl[0], bl[1]);
          mma(q2t[1], xa[ks], bl[2], bl[3]);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) qt[u][e] += q2t[u][e];
        // K_ij dt_j and Q_ij D_ij dt_j at (j, i), masked to i >= j before
        // the power
        float kd[2][4], qd[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = r0 + g + 8 * (e >> 1);
            const int i = 16 * kb + 8 * u + 2 * t + (e & 1);
            const bool keep = i >= j;
            const float diff = keep ? cum_s[i] - cj[e >> 1] : 0.0f;
            const float d = keep ? ex2(diff) : 0.0f;
            const float sd = sb[u][e] * d;
            kd[u][e] = sd * dj[e >> 1];
            qd[u][e] = qt[u][e] * d * dj[e >> 1];
            ctr[e >> 1] += kd[u][e] * qt[u][e];
            kqr[e >> 1] += sd * qt[u][e];
          }
        uint32_t kh[4], kl[4], qh[4], ql[4];
        split_frag(kd, kh, kl);
        split_frag(qd, qh, ql);
        // dx_j += sum_i K_ij dt_j dy_i (lo x lo not issued)
#pragma unroll
        for (int pp = 0; pp < KP; ++pp) {
          const uint32_t off = chunk_off<PT>(16 * kb + lr8 + 8 * q1,
                                             2 * pp + q2);
          uint32_t bh[4], bl[4];
          ldsm_t(bh, dys + off);
          ldsm_t(bl, dys + GS::kX + off);
          mma(dxa[2 * pp], kh, bh[0], bh[1]);
          mma(dxa[2 * pp + 1], kh, bh[2], bh[3]);
          mma(dxa[2 * pp], kl, bh[0], bh[1]);
          mma(dxa[2 * pp + 1], kl, bh[2], bh[3]);
          mma(dxa[2 * pp], kh, bl[0], bl[1]);
          mma(dxa[2 * pp + 1], kh, bl[2], bl[3]);
        }
        // dB_j += sum_i Q_ij D_ij dt_j C_i
#pragma unroll
        for (int np = 0; np < KN; ++np) {
          uint32_t bc[4];
          ldsm_t(bc, cts + chunk_off<NT>(16 * kb + lr8 + 8 * q1, 2 * np + q2));
          mma(acc[2 * np], qh, bc[0], bc[1]);
          mma(acc[2 * np + 1], qh, bc[2], bc[3]);
          mma(acc[2 * np], ql, bc[0], bc[1]);
          mma(acc[2 * np + 1], ql, bc[2], bc[3]);
        }
      }
      // B_j Gout: dx_j += w_j (B_j Gout); r_j = (B_j Gout).x_j; two
      // 16-column blocks of P at once
#pragma unroll
      for (int pp0 = 0; pp0 < KP; pp0 += 2) {
        float bg[2][2][4] = {};
#pragma unroll
        for (int ks = 0; ks < KN; ++ks) {
          uint32_t af[4];
          ldsm(af, bts + chunk_off<NT>(r0 + lr8 + 8 * q1, 2 * ks + q2));
#pragma unroll
          for (int d = 0; d < 2; ++d) {
            if (pp0 + d >= KP) continue;
#pragma unroll
            for (int term = 0; term < 2; ++term) {
              uint32_t bf[4];
              ldsm_t(bf, gos + term * GS::kS +
                             chunk_off<PT>(16 * ks + lr8 + 8 * q1,
                                           2 * (pp0 + d) + q2));
              mma(bg[d][0], af, bf[0], bf[1]);
              mma(bg[d][1], af, bf[2], bf[3]);
            }
          }
        }
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          if (pp0 + d >= KP) continue;
          const int pp = pp0 + d;
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int hv = 0; hv < 2; ++hv) {
              const float2 xv = unpack(lds32(xs + elem_off<PT>(
                  r0 + g + 8 * hv, 16 * pp + 8 * u + 2 * t)));
              rr[hv] += bg[d][u][2 * hv] * xv.x + bg[d][u][2 * hv + 1] * xv.y;
              dxa[2 * pp + u][2 * hv] += wj[hv] * bg[d][u][2 * hv];
              dxa[2 * pp + u][2 * hv + 1] += wj[hv] * bg[d][u][2 * hv + 1];
            }
        }
      }
      // x_j Gout^T: dB_j += w_j (Gout x_j), two 16-column blocks of N at once
#pragma unroll
      for (int np0 = 0; np0 < KN; np0 += 2) {
        float xg[2][2][4] = {};
#pragma unroll
        for (int ks = 0; ks < KP; ++ks)
#pragma unroll
          for (int d = 0; d < 2; ++d) {
            if (np0 + d >= KN) continue;
#pragma unroll
            for (int term = 0; term < 2; ++term) {
              uint32_t bf[4];
              ldsm(bf, gos + term * GS::kS +
                           chunk_off<PT>(16 * (np0 + d) + lr8 + 8 * q2,
                                         2 * ks + q1));
              mma(xg[d][0], xa[ks], bf[0], bf[1]);
              mma(xg[d][1], xa[ks], bf[2], bf[3]);
            }
          }
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          if (np0 + d >= KN) continue;
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[2 * (np0 + d) + u][e] += wj[e >> 1] * xg[d][u][e];
        }
      }
      // dx rows j, bf16
#pragma unroll
      for (int hv = 0; hv < 2; ++hv) {
        const int j = r0 + g + 8 * hv;
        if (j >= lr) continue;
        bf16* const out = a.dx + ((row_bs + c0 + j) * a.h + hh) * a.p;
#pragma unroll
        for (int pt = 0; pt < P8; ++pt) {
          const int col = 8 * pt + 2 * t;
          if (col < a.p)
            *reinterpret_cast<__nv_bfloat162*>(out + col) =
                __floats2bfloat162_rn(dxa[pt][2 * hv], dxa[pt][2 * hv + 1]);
        }
      }
#pragma unroll
      for (int hv = 0; hv < 2; ++hv) {
        const float c1 = quad_sum(ctr[hv]), k1 = quad_sum(kqr[hv]);
        const float r1 = quad_sum(rr[hv]);
        if (t == 0) {
          const int j = r0 + g + 8 * hv;
          ct_x[j] = c1;
          kq_x[j] = k1;
          r_x[j] = r1;
        }
      }
    } else {
      // dy_i's A fragments over P, two terms
      uint32_t da[2][KP][4];
#pragma unroll
      for (int term = 0; term < 2; ++term)
#pragma unroll
        for (int ks = 0; ks < KP; ++ks)
          ldsm(da[term][ks], dys + term * GS::kX +
                                 chunk_off<PT>(r0 + lr8 + 8 * q1, 2 * ks + q2));
      float rtr[2] = {0.0f, 0.0f}, vr[2] = {0.0f, 0.0f};
      const float ci[2] = {cum_s[r0 + g], cum_s[r0 + g + 8]};
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        if (kb > tile) continue;
        // C_i B_j^T (the group's) and Q = dy_i . x_j (dy in two terms),
        // six accumulator chains
        float sb[2][4] = {}, q[2][4] = {}, qlo[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < KN; ++ks) {
          uint32_t af[4], bf[4];
          ldsm(af, cts + chunk_off<NT>(r0 + lr8 + 8 * q1, 2 * ks + q2));
          ldsm(bf, bts + chunk_off<NT>(16 * kb + lr8 + 8 * q2, 2 * ks + q1));
          mma(sb[0], af, bf[0], bf[1]);
          mma(sb[1], af, bf[2], bf[3]);
        }
#pragma unroll
        for (int ks = 0; ks < KP; ++ks) {
          uint32_t bf[4];
          ldsm(bf, xs + chunk_off<PT>(16 * kb + lr8 + 8 * q2, 2 * ks + q1));
          mma(q[0], da[0][ks], bf[0], bf[1]);
          mma(q[1], da[0][ks], bf[2], bf[3]);
          mma(qlo[0], da[1][ks], bf[0], bf[1]);
          mma(qlo[1], da[1][ks], bf[2], bf[3]);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) q[u][e] += qlo[u][e];
        float qd[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = r0 + g + 8 * (e >> 1);
            const int j = 16 * kb + 8 * u + 2 * t + (e & 1);
            const bool keep = i >= j;
            const float diff = keep ? ci[e >> 1] - cum_s[j] : 0.0f;
            const float ddt = (keep ? ex2(diff) : 0.0f) * dt_s[j];
            qd[u][e] = q[u][e] * ddt;
            rtr[e >> 1] += sb[u][e] * ddt * q[u][e];
          }
        uint32_t qh[4], ql[4];
        split_frag(qd, qh, ql);
        // dC_i += sum_j Q_ij D_ij dt_j B_j
#pragma unroll
        for (int np = 0; np < KN; ++np) {
          uint32_t bb[4];
          ldsm_t(bb, bts + chunk_off<NT>(16 * kb + lr8 + 8 * q1, 2 * np + q2));
          mma(acc[2 * np], qh, bb[0], bb[1]);
          mma(acc[2 * np + 1], qh, bb[2], bb[3]);
          mma(acc[2 * np], ql, bb[0], bb[1]);
          mma(acc[2 * np + 1], ql, bb[2], bb[3]);
        }
      }
      const float ei[2] = {ecum_s[r0 + g], ecum_s[r0 + g + 8]};
      // dy_i Sin^T: dC_i += e^cum_i (Sin dy_i) (lo x lo not issued), two
      // 16-column blocks of N at once
#pragma unroll
      for (int np0 = 0; np0 < KN; np0 += 2) {
        float ds[2][2][4] = {};
#pragma unroll
        for (int ks = 0; ks < KP; ++ks)
#pragma unroll
          for (int d = 0; d < 2; ++d) {
            if (np0 + d >= KN) continue;
#pragma unroll
            for (int term = 0; term < 2; ++term) {
              uint32_t bf[4];
              ldsm(bf, sis + term * GS::kS +
                           chunk_off<PT>(16 * (np0 + d) + lr8 + 8 * q2,
                                         2 * ks + q1));
              mma(ds[d][0], da[0][ks], bf[0], bf[1]);
              mma(ds[d][1], da[0][ks], bf[2], bf[3]);
              if (term == 0) {
                mma(ds[d][0], da[1][ks], bf[0], bf[1]);
                mma(ds[d][1], da[1][ks], bf[2], bf[3]);
              }
            }
          }
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          if (np0 + d >= KN) continue;
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[2 * (np0 + d) + u][e] += ei[e >> 1] * ds[d][u][e];
        }
      }
      // C_i Sin: v_i = e^cum_i (C_i Sin).dy_i, two 16-column blocks of P at
      // once
#pragma unroll
      for (int pp0 = 0; pp0 < KP; pp0 += 2) {
        float cs[2][2][4] = {};
#pragma unroll
        for (int ks = 0; ks < KN; ++ks) {
          uint32_t af[4];
          ldsm(af, cts + chunk_off<NT>(r0 + lr8 + 8 * q1, 2 * ks + q2));
#pragma unroll
          for (int d = 0; d < 2; ++d) {
            if (pp0 + d >= KP) continue;
#pragma unroll
            for (int term = 0; term < 2; ++term) {
              uint32_t bf[4];
              ldsm_t(bf, sis + term * GS::kS +
                             chunk_off<PT>(16 * ks + lr8 + 8 * q1,
                                           2 * (pp0 + d) + q2));
              mma(cs[d][0], af, bf[0], bf[1]);
              mma(cs[d][1], af, bf[2], bf[3]);
            }
          }
        }
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          if (pp0 + d >= KP) continue;
          const int pp = pp0 + d;
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int hv = 0; hv < 2; ++hv) {
              const uint32_t o =
                  elem_off<PT>(r0 + g + 8 * hv, 16 * pp + 8 * u + 2 * t);
              const float2 dh = unpack(lds32(dys + o));
              const float2 dl = unpack(lds32(dys + GS::kX + o));
              vr[hv] += cs[d][u][2 * hv] * (dh.x + dl.x) +
                        cs[d][u][2 * hv + 1] * (dh.y + dl.y);
            }
        }
      }
#pragma unroll
      for (int hv = 0; hv < 2; ++hv) {
        const float r1 = quad_sum(rtr[hv]), v1 = quad_sum(vr[hv]);
        if (t == 0) {
          const int i = r0 + g + 8 * hv;
          rt_x[i] = r1;
          v_x[i] = ei[hv] * v1;
        }
      }
    }
    // <Gout, Sin>, this thread's pairs (padding is zero)
    {
      float dot = 0.0f;
      for (int e = threadIdx.x; e < NT * PT / 2; e += kThreads) {
        const uint32_t o = elem_off<PT>(e / (PT / 2), (e % (PT / 2)) * 2);
        const float2 gh = unpack(lds32(gos + o));
        const float2 gl = unpack(lds32(gos + GS::kS + o));
        const float2 sh = unpack(lds32(sis + o));
        const float2 sl2 = unpack(lds32(sis + GS::kS + o));
        dot += (gh.x + gl.x) * (sh.x + sl2.x) + (gh.y + gl.y) * (sh.y + sl2.y);
      }
      dot = warp_sum(dot);
      if (lane == 0) dot_x[warp] = dot;
    }
    if (warp == kTail && k + 1 < nh) {
      row_terms(rows + (st ^ 1) * GS::kRowFloats, hh + 1);
      if (k + 2 < nh) load_dt(hh + 2);
    }
    cp_async_wait<0>();     // this thread's copies of head k + 1
    __syncthreads();        // the row sums and the next head's terms and
                            // slot; every reader of slot st is done
    if (k + 2 < nh) stage_head(st, hh + 2);
    cp_async_commit();
    if (warp == kTail) {
      // gcum, its suffix sums, ddt and this (b, chunk, h)'s part of dA
      float gc[2], usum = 0.0f;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int i = 2 * lane + q;
        const float u = w_s[i] * r_x[i];
        usum += u;
        gc[q] = rt_x[i] - ct_x[i] + v_x[i] - u;
      }
      usum = warp_sum(usum);
      float dsum = 0.0f;
#pragma unroll
      for (int w = 0; w < 8; ++w) dsum += dot_x[w];
      if (lane == 31) gc[1] += usum + ex2(cum_s[kLc - 1]) * dsum;
      const float local = gc[0] + gc[1];
      float incl = local;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += v;
      }
      const float suf1 = incl - local + gc[1], suf0 = suf1 + gc[0];
      const float ah = a.A[hh];
      const float suf[2] = {suf0, suf1};
      float da = 0.0f;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int i = 2 * lane + q;
        da += dt_s[i] * suf[q];
        if (i < lr)
          a.ddt[(row_bs + c0 + i) * a.h + hh] =
              kq_x[i] + ew_s[i] * r_x[i] + ah * suf[q];
      }
      da = warp_sum(da);
      if (lane == 0)
        a.dah[(static_cast<long long>(b) * a.nc + c) * a.h + hh] = da;
    }
  }

  // the slice's dB (j side) or dC (i side) rows, float32, as partial sl
  float* const part = jside ? a.dbp : a.dcp;
  const int parts = a.g * a.nsl;
#pragma unroll
  for (int hv = 0; hv < 2; ++hv) {
    const int r = r0 + g + 8 * hv;
    if (r >= lr) continue;
    float* const out =
        part + ((row_bs + c0 + r) * parts + gi * a.nsl + sl) * a.n;
#pragma unroll
    for (int nt = 0; nt < N8; ++nt) {
      const int col = 8 * nt + 2 * t;
      if (col < a.n)
        *reinterpret_cast<float2*>(out + col) =
            make_float2(acc[nt][2 * hv], acc[nt][2 * hv + 1]);
    }
  }
}

// dA: a warp a head sums the (b, chunk) parts, lane l the rows l, l + 32,
// ... in ascending order, then the lanes in a fixed tree
__global__ void __launch_bounds__(32) ssd_bwd_tc_da_kernel(const float* dah,
                                                           float* da, int h,
                                                           long long rows) {
  const int head = blockIdx.x, lane = threadIdx.x;
  float v = 0.0f;
  for (long long r = lane; r < rows; r += 32) v += dah[r * h + head];
  v = warp_sum(v);
  if (lane == 0) da[head] = v;
}

// the padded width a kernel takes: a power of two >= 16
__host__ __device__ inline int pad_width(int v) {
  int w = 16;
  while (w < v) w *= 2;
  return w;
}
// Heads a gradient block walks: a group's heads in ceil(hpg / 8) slices,
// as even as they go
inline int slice_heads(int h, int g) {
  const int hpg = h / g, nsl = (hpg + kHeadsMax - 1) / kHeadsMax;
  return (hpg + nsl - 1) / nsl;
}
inline int walk_smem(int nt, int pt) {
  return 2 * (kLc * nt * 2 + 2 * kLc * pt * 2) + 2 * kLc * 4 + 4 * nt * pt;
}
inline int grad_smem(int nt, int pt) {
  return 2 * kLc * nt * 2 + 2 * (3 * kLc * pt * 2 + 4 * nt * pt * 2)
         + 2 * (10 * kLc + 8) * 4;
}

}  // namespace tc

// The opt-in above 48 KB, once per kernel.
cudaError_t configure(const void* k) {
  constexpr int kKinds = 32;
  static const void* done[kKinds] = {};
  for (int i = 0; i < kKinds; ++i)
    if (done[i] == k) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < kKinds; ++i)
    if (done[i] == nullptr) {
      done[i] = k;
      break;
    }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  const int smem1 = 4 * stage_floats(a.n, a.p);
  const int smem3 = 4 * grad_floats(a.n, a.p);
  cudaError_t err = configure(reinterpret_cast<const void*>(
      ssd_bwd_chunk_kernel<T>));
  if (err == cudaSuccess)
    err = configure(reinterpret_cast<const void*>(ssd_bwd_grad_kernel<T>));
  if (err != cudaSuccess) return err;
  const dim3 blocks(a.h, a.nc, a.bt);
  ssd_bwd_chunk_kernel<T><<<blocks, kThreads, smem1, stream>>>(a);
  ssd_bwd_scan_kernel<<<dim3((a.n * a.p + kThreads - 1) / kThreads,
                             a.bt * a.h),
                kThreads, 0, stream>>>(a);
  ssd_bwd_grad_kernel<T><<<blocks, kThreads, smem3, stream>>>(a);
  const long long sums = static_cast<long long>(a.bt) * a.s * a.g * a.n;
  if (sums > 0)
    ssd_bwd_group_kernel<T><<<static_cast<unsigned>((sums + kThreads - 1) /
                                                kThreads),
                          kThreads, 0, stream>>>(a);
  ssd_bwd_da_kernel<<<1, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// The tensor-core route's two kernels for padded widths (nt, pt), or null
// outside them.
struct TcKernels {
  const void* walk;
  const void* grad;
  void (*run)(const tc::Args&, int, int, cudaStream_t);
};

template <int NT, int PT>
void run_tc(const tc::Args& a, int walk_bytes, int grad_bytes,
            cudaStream_t stream) {
  tc::ssd_bwd_walk_kernel<NT, PT><<<dim3(a.h, a.bt, 2), kThreads, walk_bytes,
                            stream>>>(a);
  tc::ssd_bwd_tc_grad_kernel<NT, PT><<<dim3(a.g * a.nsl, a.nc, a.bt), kThreads,
                            grad_bytes, stream>>>(a);
}

template <int NT, int PT>
TcKernels tc_entry() {
  return {reinterpret_cast<const void*>(tc::ssd_bwd_walk_kernel<NT, PT>),
          reinterpret_cast<const void*>(tc::ssd_bwd_tc_grad_kernel<NT, PT>),
          run_tc<NT, PT>};
}

template <int NT>
TcKernels tc_kernels_p(int pt) {
  switch (pt) {
    case 16: return tc_entry<NT, 16>();
    case 32: return tc_entry<NT, 32>();
    case 64: return tc_entry<NT, 64>();
  }
  return {nullptr, nullptr, nullptr};
}

TcKernels tc_kernels(int n, int p) {
  const int pt = tc::pad_width(p);
  switch (tc::pad_width(n)) {
    case 16: return tc_kernels_p<16>(pt);
    case 32: return tc_kernels_p<32>(pt);
    case 64: return tc_kernels_p<64>(pt);
    case 128: return tc_kernels_p<128>(pt);
  }
  return {nullptr, nullptr, nullptr};
}

cudaError_t launch_tc(const tc::Args& a, float* da, void* db, void* dc,
                      cudaStream_t stream) {
  const TcKernels k = tc_kernels(a.n, a.p);
  const int nt = tc::pad_width(a.n), pt = tc::pad_width(a.p);
  cudaError_t err = configure(k.walk);
  if (err == cudaSuccess) err = configure(k.grad);
  if (err != cudaSuccess) return err;
  k.run(a, tc::walk_smem(nt, pt), tc::grad_smem(nt, pt), stream);
  // the partials of each group summed in order (the FMA route's sums with
  // the partials in the place of heads), and dA
  BwdArgs s{};
  s.dbh = a.dbp;
  s.dch = a.dcp;
  s.db = db;
  s.dc = dc;
  s.bt = a.bt;
  s.s = a.s;
  s.g = a.g;
  s.n = a.n;
  s.h = a.g * a.nsl;
  const long long sums = static_cast<long long>(a.bt) * a.s * a.g * a.n;
  ssd_bwd_group_kernel<__nv_bfloat16><<<
      static_cast<unsigned>((sums + kThreads - 1) / kThreads), kThreads, 0,
      stream>>>(s);
  tc::ssd_bwd_tc_da_kernel<<<a.h, 32, 0, stream>>>(
      a.dah, da, a.h, static_cast<long long>(a.bt) * a.nc);
  return cudaGetLastError();
}

bool tc_shapes(int n, int p) { return n <= 128 && p <= 64; }

}  // namespace

extern "C" {

// The dynamic shared memory of the route's largest block (the gradient
// kernel) for dtype 0 (float32, the FMA route) or 1 (bfloat16, the tensor
// cores), N and P; 0 for a bfloat16 N > 128 or P > 64.
int ssd_scan_bwd_smem(int dtype, int n, int p) {
  if (dtype == 0) return 4 * grad_floats(n, p);
  if (!tc_shapes(n, p)) return 0;
  return tc::grad_smem(tc::pad_width(n), tc::pad_width(p));
}

// The chunk both routes block the sequence in.
int ssd_scan_bwd_chunk(int dtype) {
  (void)dtype;
  return kLc;
}

// The heads a gradient block walks: 1 on the FMA route, a slice of a
// group's heads on the tensor cores (each slice one float32 partial of dB
// and dC).
int ssd_scan_bwd_heads(int dtype, int h, int g) {
  return dtype == 0 || g <= 0 || h % g != 0 ? 1 : tc::slice_heads(h, g);
}

// The blocks an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// of kernel `which`: 0 the gradient kernel, 1 the chunk kernel (float32)
// or the walks (bfloat16). Returns the cudaError_t.
int ssd_scan_bwd_occupancy(int dtype, int n, int p, int which,
                           int* blocks) {
  const void* k = nullptr;
  int smem = 0;
  if (dtype == 0) {
    k = which == 0 ? reinterpret_cast<const void*>(ssd_bwd_grad_kernel<float>)
                   : reinterpret_cast<const void*>(ssd_bwd_chunk_kernel<float>);
    smem = which == 0 ? 4 * grad_floats(n, p) : 4 * stage_floats(n, p);
  } else if (tc_shapes(n, p)) {
    const TcKernels t = tc_kernels(n, p);
    const int nt = tc::pad_width(n), pt = tc::pad_width(p);
    k = which == 0 ? t.grad : t.walk;
    smem = which == 0 ? tc::grad_smem(nt, pt) : tc::walk_smem(nt, pt);
  }
  if (k == nullptr || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure(k);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, kThreads,
                                                        smem);
  return static_cast<int>(err);
}

// One call. dtype 0: float32 x, B, C, dx, dB, dC on the FMA pipes, five
// launches; sin, gout [Bt, nc, H, N, P], tot and dah [Bt, nc, H], dbh and
// dch [Bt, S, H, N] float32 scratch, dys unused. dtype 1: bfloat16 on the
// tensor cores (N <= 128, P <= 64), four launches; with N', P' the widths
// padded to a power of two >= 16 and nsl = ceil(H / G / heads) slices a
// group (heads = ssd_scan_bwd_heads), sin and gout [Bt, nc, H, 2, N', P']
// and dys [Bt, nc, H, 2, 64, P'] bfloat16 scratch, dbh and dch [Bt, S,
// G * nsl, N] and dah [Bt, nc, H] float32, tot unused. dt, A, s0 (null:
// zero), dy, d_last (null: zero), ddt, dA and ds0 (null when s0 is) are
// float32; nc = ceil(S / ssd_scan_bwd_chunk()). Everything contiguous and
// 16-byte aligned; P % 4 == 0, N % 4 == 0, H % G == 0, Bt <= 65535,
// Bt * H <= 65535, the gradient kernel's shared memory within 227 KB (the
// wrapper checks each). Returns the cudaError_t.
int ssd_scan_bwd(const void* x, const float* dt, const float* A,
                 const void* B, const void* C, const float* s0,
                 const float* dy, const float* dlast, float* sin, float* gout,
                 float* tot, void* dx, float* ddt, float* dbh, float* dch,
                 float* dah, float* da, void* db, void* dc, float* ds0,
                 void* dys, int dtype, int bt, int s, int h, int p, int g,
                 int n, void* stream) {
  if (bt <= 0 || h <= 0 || s <= 0) return 0;
  if (p % 4 != 0 || n % 4 != 0 || p <= 0 || n <= 0 || g <= 0 || h % g != 0 ||
      bt > 65535 || bt * h > 65535 || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && !tc_shapes(n, p)) ||
      ssd_scan_bwd_smem(dtype, n, p) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (s + kLc - 1) / kLc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const int hs = tc::slice_heads(h, g);
    const int nsl = (h / g + hs - 1) / hs;
    const tc::Args a{static_cast<const __nv_bfloat16*>(x), dt, A,
                     static_cast<const __nv_bfloat16*>(B),
                     static_cast<const __nv_bfloat16*>(C), s0, dy, dlast,
                     reinterpret_cast<__nv_bfloat16*>(sin),
                     reinterpret_cast<__nv_bfloat16*>(gout),
                     static_cast<__nv_bfloat16*>(dys),
                     static_cast<__nv_bfloat16*>(dx), ddt, dbh, dch, dah, ds0,
                     bt, s, h, p, g, n, nc, hs, nsl};
    return static_cast<int>(launch_tc(a, da, db, dc, st));
  }
  const BwdArgs a{x,  dt,  A,   B,   C,   s0, dy, dlast, sin, gout, tot,
                  dx, ddt, dbh, dch, dah, da, db, dc,    ds0, bt,   s,
                  h,  p,   g,   n,   nc};
  return static_cast<int>(launch<float>(a, st));
}

}  // extern "C"
