// The Mamba2 chunked SSD scan for Hopper (sm_90a): x, B, C in float32 or
// bfloat16, dt and A in float32, y and the state in float32.
//
// Replaces the TPU kernel `ssd_scan_pallas` (`_ssd_kernel`) in
// src/repro/kernels/ssd_scan.py. It computes the function of `_ssd_chunked`
// (src/repro/models/layers.py): y and, beside it, the last state, from an
// optional initial state s0; the Pallas kernel is the case s0 = 0 with the
// state dropped. Semantics are those of `ssd_scan_ref` (src/repro_torch/
// kernels/ref.py). Per batch row b and head h, with group g = h / (H / G):
//
//   a_t = dt_t * A_h,  S_t = exp(a_t) S_{t-1} + dt_t B_t (x) x_t,
//   y_t = C_t . S_t,   S_{-1} = s0,
//
// evaluated in chunks of Lc steps: with cum the prefix sum of a inside a
// chunk, y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
// + exp(cum_i) C_i . S_in, and S_out = exp(cum_last) S_in
// + sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j.
//
// Design. One block of 256 threads per (head, batch row): the Pallas grid's
// sequential chunk axis, whose [N, P] state lived in VMEM, becomes a loop
// inside the block with the state in shared memory. Per chunk the block
// stages C and B transposed ([N, Lc]) and x ([Lc, P]) as float32, takes the
// prefix sum of dt * A (one warp), builds M^T[j, i] =
// (C_i . B_j) exp(cum_i - cum_j) dt_j for i >= j (masked BEFORE the exp, as
// `_ssd_kernel` does: exp(cum_i - cum_j) for i < j overflows), then
// y = M @ x + exp(cum) * (C @ S_in), and updates the state in place (each
// thread owns the state elements it updates). Every product is a loop over
// 4 x 4 register tiles with float4 reads of shared memory, on the FMA
// pipes in float32. B and C are read per group, never repeated to heads.
// A ragged last chunk is handled by bounds: rows past the sequence stage as
// zeros (dt = 0 is the identity decay and adds nothing), and nothing is
// padded in device memory.
//
// Shared memory: 4 * (2 N Lc + Lc P + Lc^2 + N P + 3 Lc) bytes, 181,760 at
// the zamba2 shapes (Lc = 128, N = P = 64), above the 48 KB static limit:
// it is dynamic, opted into with cudaFuncSetAttribute. The wrapper picks
// the chunk: the model's, halved until it fits 227 KB (the chunk length is
// a blocking of the same function; only the rounding moves).
//
// What bounds it on the H100: operations. Per chunk and (b, h) it does
// about Lc^2 N / 2 + Lc^2 P / 2 + 2 Lc N P multiply-adds in float32 outside
// the tensor cores against Lc (2 N + P) staged inputs; one block per SM at
// this shared memory. Tensor-core products over bf16 tiles are later work.
//
// Tolerance against the plain version: float32 sums in another order,
// 1e-4 absolute + 1e-4 relative.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;

struct SsdArgs {
  const void* x;      // [Bt, S, H, P]
  const float* dt;    // [Bt, S, H]
  const float* A;     // [H]
  const void* B;      // [Bt, S, G, N]
  const void* C;      // [Bt, S, G, N]
  const float* s0;    // [Bt, H, N, P] or null
  float* y;           // [Bt, S, H, P]
  float* state;       // [Bt, H, N, P]
  int bt, s, h, p, g, n, lc;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

int smem_bytes(int n, int p, int lc) {
  return 4 * (2 * n * lc + lc * p + lc * lc + n * p + 3 * lc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_kernel(SsdArgs a) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int n = a.n, p = a.p, lc = a.lc;
  float* const ct = smem;              // [N][Lc]  C transposed
  float* const bt = ct + n * lc;       // [N][Lc]  B transposed
  float* const xs = bt + n * lc;       // [Lc][P]
  float* const mt = xs + lc * p;       // [Lc][Lc] M transposed: mt[j][i]
  float* const st = mt + lc * lc;      // [N][P]   the carried state
  float* const cum = st + n * p;       // [Lc]
  float* const dts = cum + lc;         // [Lc]
  float* const ws = dts + lc;          // [Lc]     exp(cum_last - cum_j) dt_j

  const int tid = threadIdx.x;
  const int hi = blockIdx.x, bi = blockIdx.y;
  const int gi = hi / (a.h / a.g);
  const float A = a.A[hi];
  const T* const x = static_cast<const T*>(a.x);
  const T* const B = static_cast<const T*>(a.B);
  const T* const C = static_cast<const T*>(a.C);
  const long long head_state = (static_cast<long long>(bi) * a.h + hi) * n * p;

  for (int idx = tid; idx < n * p; idx += kThreads)
    st[idx] = a.s0 != nullptr ? a.s0[head_state + idx] : 0.0f;

  const int tiles_m = (lc / 4) * (lc / 4);
  const int tiles_y = (lc / 4) * (p / 4);
  const int tiles_s = (n / 4) * (p / 4);

  for (int c0 = 0; c0 < a.s; c0 += lc) {
    const int lr = a.s - c0 < lc ? a.s - c0 : lc;
    __syncthreads();                     // the last chunk's readers are done
    for (int idx = tid; idx < lc * p; idx += kThreads) {
      const int i = idx / p, pp = idx % p;
      xs[idx] = i < lr ? to_f32(x[((static_cast<long long>(bi) * a.s + c0 + i)
                                   * a.h + hi) * p + pp])
                       : 0.0f;
    }
    for (int idx = tid; idx < lc * n; idx += kThreads) {
      const int i = idx % lc, nn = idx / lc;
      float bv = 0.0f, cv = 0.0f;
      if (i < lr) {
        const long long off = ((static_cast<long long>(bi) * a.s + c0 + i)
                               * a.g + gi) * n + nn;
        bv = to_f32(B[off]);
        cv = to_f32(C[off]);
      }
      bt[nn * lc + i] = bv;
      ct[nn * lc + i] = cv;
    }
    for (int i = tid; i < lc; i += kThreads)
      dts[i] = i < lr ? a.dt[(static_cast<long long>(bi) * a.s + c0 + i)
                             * a.h + hi]
                      : 0.0f;
    __syncthreads();
    if (tid < 32) {                      // prefix sum of dt * A, one warp
      const int per = (lc + 31) / 32, i0 = tid * per;
      const int i1 = i0 + per < lc ? i0 + per : lc;
      float local = 0.0f;
      for (int i = i0; i < i1; ++i) local += dts[i] * A;
      float incl = local;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      float run = incl - local;
      for (int i = i0; i < i1; ++i) {
        run += dts[i] * A;
        cum[i] = run;
      }
    }
    __syncthreads();
    const float total = cum[lc - 1];
    for (int j = tid; j < lc; j += kThreads)
      ws[j] = expf(total - cum[j]) * dts[j];

    // M^T[j][i] = (C_i . B_j) exp(cum_i - cum_j) dt_j for i >= j, else 0
    for (int t = tid; t < tiles_m; t += kThreads) {
      const int i0 = (t / (lc / 4)) * 4, j0 = (t % (lc / 4)) * 4;
      float m[4][4] = {};
      if (i0 + 3 >= j0) {
        for (int k = 0; k < n; ++k) {
          const float4 cv = ld4(ct + k * lc + i0);
          const float4 bv = ld4(bt + k * lc + j0);
          const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
          const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              m[ii][jj] = fmaf(c4[ii], b4[jj], m[ii][jj]);
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int i = i0 + ii, j = j0 + jj;
            m[ii][jj] = i >= j ? m[ii][jj] * expf(cum[i] - cum[j]) * dts[j]
                               : 0.0f;
          }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        st4(mt + (j0 + jj) * lc + i0,
            make_float4(m[0][jj], m[1][jj], m[2][jj], m[3][jj]));
    }
    __syncthreads();

    // y = M @ x + exp(cum) * (C @ S_in)
    for (int t = tid; t < tiles_y; t += kThreads) {
      const int i0 = (t / (p / 4)) * 4, p0 = (t % (p / 4)) * 4;
      if (i0 >= lr) continue;
      float yi[4][4] = {}, ye[4][4] = {};
      const int jmax = i0 + 4 < lc ? i0 + 4 : lc;
      for (int j = 0; j < jmax; ++j) {
        const float4 mv = ld4(mt + j * lc + i0);
        const float4 xv = ld4(xs + j * p + p0);
        const float m4[4] = {mv.x, mv.y, mv.z, mv.w};
        const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int pp = 0; pp < 4; ++pp)
            yi[ii][pp] = fmaf(m4[ii], x4[pp], yi[ii][pp]);
      }
      for (int k = 0; k < n; ++k) {
        const float4 cv = ld4(ct + k * lc + i0);
        const float4 sv = ld4(st + k * p + p0);
        const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
        const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int pp = 0; pp < 4; ++pp)
            ye[ii][pp] = fmaf(c4[ii], s4[pp], ye[ii][pp]);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = i0 + ii;
        if (i >= lr) break;
        const float e = expf(cum[i]);
        float* const yo = a.y + ((static_cast<long long>(bi) * a.s + c0 + i)
                                 * a.h + hi) * p + p0;
        st4(yo, make_float4(yi[ii][0] + ye[ii][0] * e, yi[ii][1] + ye[ii][1] * e,
                            yi[ii][2] + ye[ii][2] * e, yi[ii][3] + ye[ii][3] * e));
      }
    }
    __syncthreads();                     // every reader of S_in is done

    // S_out = exp(total) S_in + sum_j (w_j B_j) (x) x_j, in place
    const float decay = expf(total);
    for (int t = tid; t < tiles_s; t += kThreads) {
      const int n0 = (t / (p / 4)) * 4, p0 = (t % (p / 4)) * 4;
      float u[4][4] = {};
      for (int j = 0; j < lr; ++j) {
        const float w = ws[j];
        const float b4[4] = {bt[n0 * lc + j] * w, bt[(n0 + 1) * lc + j] * w,
                             bt[(n0 + 2) * lc + j] * w,
                             bt[(n0 + 3) * lc + j] * w};
        const float4 xv = ld4(xs + j * p + p0);
        const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int pp = 0; pp < 4; ++pp)
            u[kk][pp] = fmaf(b4[kk], x4[pp], u[kk][pp]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float* const so = st + (n0 + kk) * p + p0;
        const float4 sv = ld4(so);
        st4(so, make_float4(sv.x * decay + u[kk][0], sv.y * decay + u[kk][1],
                            sv.z * decay + u[kk][2], sv.w * decay + u[kk][3]));
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < n * p; idx += kThreads)
    a.state[head_state + idx] = st[idx];
}

template <typename T>
cudaError_t launch(const SsdArgs& a, cudaStream_t stream) {
  static bool configured = false;   // the opt-in above 48 KB, once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(a.h, a.bt);
  ssd_kernel<T><<<grid, kThreads, smem_bytes(a.n, a.p, a.lc), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The chunk length the kernel runs for N, P and the model's chunk (already
// cut to the sequence): rounded up to a multiple of 4, then halved while
// the shared memory exceeds the card's 227 KB; 0 if none fits.
int ssd_scan_chunk(int n, int p, int chunk) {
  int lc = (chunk + 3) / 4 * 4;
  while (lc > 4 && smem_bytes(n, p, lc) > kMaxSmem) lc = (lc / 2 + 3) / 4 * 4;
  return lc >= 4 && smem_bytes(n, p, lc) <= kMaxSmem ? lc : 0;
}

// One launch. dtype 0: float32 x, B, C; 1: bfloat16. dt, A, s0 (null: a
// zero initial state), y and state are float32. Everything contiguous and
// 16-byte aligned; P % 4 == 0, N % 4 == 0, H % G == 0, lc from
// ssd_scan_chunk, Bt <= 65535 (the wrapper checks each). Returns the
// cudaError_t.
int ssd_scan(const void* x, const float* dt, const float* A, const void* B,
             const void* C, const float* s0, float* y, float* state,
             int dtype, int bt, int s, int h, int p, int g, int n, int lc,
             void* stream) {
  if (bt <= 0 || h <= 0) return 0;
  if (p % 4 != 0 || n % 4 != 0 || g <= 0 || h % g != 0 || lc < 4 ||
      lc % 4 != 0 || smem_bytes(n, p, lc) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const SsdArgs a{x, dt, A, B, C, s0, y, state, bt, s, h, p, g, n, lc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 1 ? launch<__nv_bfloat16>(a, st)
                                     : launch<float>(a, st);
  return static_cast<int>(err);
}

}  // extern "C"
