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
// The kernel blocks the sequence in chunks of kLc = 64 rows whatever the
// model's chunk (the same function, blocked otherwise, as the forward's
// `ssd_plan` does). Five launches on the caller's stream, one C call, none
// of which carries anything between blocks:
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
// No atomics: every output element is written by one thread after sums in
// a fixed order, so a run gives the same bits as the last.
//
// Bound: operations. Per (b, 64-row chunk, h) the products take
// 2 Lc^2 (3 N + 2 P) flops (C B^T, dy x^T and the three intra-chunk
// products) and 12 Lc N P (the four state products here, two in (1)):
// 10.5 MFLOP at N = 128, P = 64, twice the forward's per row. At
// mamba2-370m's training shape (x [8, 2048, 32, 64], B/C [8, 2048, 1, 128])
// that is 86 GFLOP, 1.28 ms at the float32 FMA peak, against 0.13 ms for
// its bytes. This first kernel is the simple one: products on the FMA pipes
// from float32 tiles in shared memory, 4 x 4 register tiles a thread with
// scalar loads (rows padded to an odd stride, so the 16 rows a warp reads
// fall in 16 banks), one block an SM at N = 128 (189,184 bytes); mma.sync
// or wgmma is later work.
//
// Tolerance against the plain twin: float32 sums in another order, 1e-4
// of each gradient's largest magnitude; bfloat16 x, B, C stage exactly in
// float32 and only dx, dB and dC round to bf16 at the end: 1e-2.

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
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

// The opt-in above 48 KB, once per kernel.
cudaError_t configure(const void* k) {
  constexpr int kKinds = 4;
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

}  // namespace

extern "C" {

// The dynamic shared memory of the gradient kernel (the larger of the two
// that stage a chunk) for N and P.
int ssd_scan_bwd_smem(int n, int p) { return 4 * grad_floats(n, p); }

// The chunk the kernel blocks the sequence in.
int ssd_scan_bwd_chunk() { return kLc; }

// One call, five launches. dtype 0: float32 x, B, C, dx, dB, dC; 1:
// bfloat16. dt, A, s0 (null: zero), dy, d_last (null: zero), ddt, dA and
// ds0 (null when s0 is) are float32; sin, gout [Bt, nc, H, N, P], tot and
// dah [Bt, nc, H], dbh and dch [Bt, S, H, N] are float32 scratch, with
// nc = ceil(S / ssd_scan_bwd_chunk()). Everything contiguous; P % 4 == 0,
// N % 4 == 0, H % G == 0, Bt <= 65535, Bt * H <= 65535, the gradient
// kernel's shared memory within 227 KB (the wrapper checks each). Returns
// the cudaError_t.
int ssd_scan_bwd(const void* x, const float* dt, const float* A,
                 const void* B, const void* C, const float* s0,
                 const float* dy, const float* dlast, float* sin, float* gout,
                 float* tot, void* dx, float* ddt, float* dbh, float* dch,
                 float* dah, float* da, void* db, void* dc, float* ds0,
                 int dtype, int bt, int s, int h, int p, int g, int n,
                 void* stream) {
  if (bt <= 0 || h <= 0 || s <= 0) return 0;
  if (p % 4 != 0 || n % 4 != 0 || p <= 0 || n <= 0 || g <= 0 || h % g != 0 ||
      bt > 65535 || bt * h > 65535 || 4 * grad_floats(n, p) > kMaxSmem ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (s + kLc - 1) / kLc;
  const BwdArgs a{x,  dt,  A,   B,   C,   s0, dy, dlast, sin, gout, tot,
                  dx, ddt, dbh, dch, dah, da, db, dc,    ds0, bt,   s,
                  h,  p,   g,   n,   nc};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch<float>(a, st)
                                     : launch<__nv_bfloat16>(a, st);
  return static_cast<int>(err);
}

}  // extern "C"
