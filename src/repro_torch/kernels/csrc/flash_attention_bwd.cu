// The gradient of flash attention for Hopper (sm_90a): dq, dk, dv of the
// forward in flash_attention.cu, float32 or bfloat16 in and out, float32
// sums inside.
//
// Replaces no Pallas kernel: the TPU package differentiates its flash
// attention through the custom VJP of `_make_flash` (`bwd`,
// src/repro/models/layers.py:162-215), a jnp recomputation over key and
// query chunks that XLA compiles. This is that `bwd` on the card; its plain
// twin is `flash_attention_bwd_ref` (src/repro_torch/kernels/ref.py). Over
// the model's layout q [B, Sq, H, D], k [B, Skv, Hkv, D], v [B, Skv, Hkv,
// Dv], out, dout [B, Sq, H, Dv] (Dv <= D: MLA's 192 / 128), lse [B, H, Sq]
// (the forward's log-sum-exp, natural log):
//
//   delta_i = sum_c dout[i, c] out[i, c] over the Dv columns;
//   p_ij = exp(scale * q_i . k_j - lse_i) on the kept pairs (the forward's
//   mask: key position >= 0, causal, window, q_off, kv_off), 0 elsewhere,
//   so a row with no kept key gives exactly 0 whatever its lse;
//   dv_j = sum_i p_ij dout_i;  ds_ij = p_ij (dout_i . v_j - delta_i) scale;
//   dq_i = sum_j ds_ij k_j;    dk_j = sum_i ds_ij q_i;
//   dk and dv of a kv head summed over its H / Hkv query heads.
//
// Three launches on the caller's stream, one C call:
//   1. `delta_kernel`: a warp a (batch, row, head), delta into float32
//      scratch [B, H, Sq];
//   2. `dkdv_kernel`: a block per (64-key tile, batch * kv head) holds its K
//      and V tile and walks every query head of the group and every 64-row
//      query tile that keeps a key of the tile (the causal and window masks
//      skip the rest), recomputing p and ds; dk and dv sum in registers and
//      are written once;
//   3. `dq_kernel`: a block per (64-row query tile, batch * head) walks the
//      live key tiles (as the forward does), dq summed in registers and
//      written once.
// No atomics: every output element is written by one thread after sums in
// a fixed order, so a run gives the same bits as the last.
//
// Bound: the products, 2 * (3 D + 2 Dv) flops per kept pair (s = q . k and
// dq, dk over D; dout . v and dv over Dv), about 43 GFLOP for qwen2.5-3b's
// [4, 1024, 16, 128] over 2 kv heads, causal (44 us at the bf16 tensor-core
// peak); the bytes (the inputs read once, the outputs written once) are
// about 76 MB (23 us). This first kernel is the simple one: products on the
// FMA pipes from float32 tiles in shared memory (4 x 4 score tiles a
// thread; 2 FMA per float loaded), one block an SM. wgmma and TMA are later
// work.
//
// Shared memory: K at a pitch of D + 4 floats and V at Dv + 4 (a thread
// reads 16 key rows at one column: the pad puts them on distinct banks); Q
// and dO unpadded at D and Dv (a warp reads two of their rows at a time,
// as broadcasts). A block of dkdv_kernel takes 4 * (64 (2 D + 2 Dv + 8) + 2
// * 64 * 64 + 128) bytes: 166,400 at D = Dv = 128, 199,168 at MLA's D 192
// / Dv 128, 231,936 at D = Dv = 192 (the opt-in ceiling is 232,448; with
// all four tiles padded it would be 233,984); a block of dq_kernel 16,384
// fewer. Columns: a thread accumulates 4 of each
// 64-column group of dk / dv / dq; two groups up to D = 128 and three past
// it, a template argument, so that the narrow instance keeps its
// registers.
//
// Tolerance against the plain twin: float32 sums in another order,
// 1e-5 of each gradient's largest magnitude in float32; in bfloat16 2e-2
// (the gradients round to 8 bits of mantissa, and the forward's bf16 out
// enters delta).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 192;
constexpr int kNarrowD = 128;   // two column groups up to it, three past
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int BQ = 64;   // query rows a tile
constexpr int BK = 64;   // keys a tile

struct BwdArgs {
  const void* q;      // [B, Sq, H, D]
  const void* k;      // [B, Skv, Hkv, D]
  const void* v;      // [B, Skv, Hkv, Dv]
  const void* out;    // [B, Sq, H, Dv]
  const void* dout;   // [B, Sq, H, Dv]
  const float* lse;   // [B, H, Sq]
  float* delta;       // [B, H, Sq] scratch
  void* dq;           // [B, Sq, H, D]
  void* dk;           // [B, Skv, Hkv, D]
  void* dv;           // [B, Skv, Hkv, Dv]
  int b, sq, skv, h, hkv, d, dv_dim;   // dv_dim: v's head dim, Dv
  float scale;
  int causal, window, q_off, kv_off;
};

__device__ __forceinline__ bool kept(int row, int col, const BwdArgs& a) {
  bool ok = col >= 0;
  if (a.causal) ok = ok && col <= row;
  if (a.window > 0) ok = ok && col >= row - a.window + 1;
  return ok;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// eight values of a row in device memory, as float
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 x = load4(p), y = load4(p + 4);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  f[4] = y.x; f[5] = y.y; f[6] = y.z; f[7] = y.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
// four values into a row in device memory
__device__ __forceinline__ void store4g(float* p, float4 v) { store4(p, v); }
__device__ __forceinline__ void store4g(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}
__device__ __forceinline__ void axpy4(float s, float4 x, float4& acc) {
  acc.x = fmaf(s, x.x, acc.x);
  acc.y = fmaf(s, x.y, acc.y);
  acc.z = fmaf(s, x.z, acc.z);
  acc.w = fmaf(s, x.w, acc.w);
}

// Rows [r0, r0 + rows) of one head of a [B, S, heads, d] tensor (`base` at
// the batch and head, `stride` = heads * d) into shared memory as float32
// [rows][pitch]; rows at or past `n` read as 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long stride, int r0, int n,
                                          int rows, int d, int pitch) {
  const int d8 = d / 8;
  for (int idx = threadIdx.x; idx < rows * d8; idx += kThreads) {
    const int r = idx / d8, c = (idx % d8) * 8;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r0 + r < n) load8(base + (r0 + r) * stride + c, f);
    store4(dst + r * pitch + c, make_float4(f[0], f[1], f[2], f[3]));
    store4(dst + r * pitch + c + 4, make_float4(f[4], f[5], f[6], f[7]));
  }
}

// The products of query rows ty + 16 a (x [rows][lx], unpadded) against
// keys tx + 16 b (y [keys][lx + 4]) over n columns, a, b < 4, unscaled.
__device__ __forceinline__ void dot_tile(const float* x, const float* y,
                                         int n, int ty, int tx,
                                         float (&s)[4][4]) {
  const int ly = n + 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = 0.0f;
  for (int c = 0; c < n; c += 4) {
    float4 xv[4], yv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) xv[a] = load4(x + (ty + 16 * a) * n + c);
#pragma unroll
    for (int b = 0; b < 4; ++b) yv[b] = load4(y + (tx + 16 * b) * ly + c);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = dot4(xv[a], yv[b], s[a][b]);
  }
}

// The scores of the tiles in shared memory: s = q . k over D and dp =
// dout . v over Dv, unscaled.
__device__ __forceinline__ void score_tile(const float* qs, const float* dos,
                                           const float* ks, const float* vs,
                                           int d, int dv, int ty, int tx,
                                           float (&s)[4][4],
                                           float (&dp)[4][4]) {
  dot_tile(qs, ks, d, ty, tx, s);
  dot_tile(dos, vs, dv, ty, tx, dp);
}

// p and ds of the score tile, in place of s and dp: rows q0 + ty + 16 r
// (positions q_off + ...), keys j0 + tx + 16 c; lse and delta of the tile's
// rows in shared memory.
__device__ __forceinline__ void p_ds(const BwdArgs& a, int q0, int j0,
                                     int ty, int tx, const float* lse_s,
                                     const float* delta_s, float (&s)[4][4],
                                     float (&dp)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    const bool row_ok = q0 + i < a.sq;
    const float l = lse_s[i], dl = delta_s[i];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      const bool ok = row_ok && j0 + j < a.skv &&
                      kept(a.q_off + q0 + i, a.kv_off + j0 + j, a);
      const float p = ok ? expf(s[r][c] * a.scale - l) : 0.0f;
      s[r][c] = p;
      dp[r][c] = p * (dp[r][c] - dl) * a.scale;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) delta_kernel(BwdArgs a) {
  const long long rows = static_cast<long long>(a.b) * a.sq * a.h;
  const long long r =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* const o = static_cast<const T*>(a.out) + r * a.dv_dim;
  const T* const g = static_cast<const T*>(a.dout) + r * a.dv_dim;
  float sum = 0.0f;
  for (int c = lane; c < a.dv_dim; c += 32)
    sum = fmaf(to_float(o[c]), to_float(g[c]), sum);
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, x);
  if (lane == 0) {
    const int hh = static_cast<int>(r % a.h);
    const long long bi_i = r / a.h;   // bi * Sq + i
    const int i = static_cast<int>(bi_i % a.sq);
    const long long bi = bi_i / a.sq;
    a.delta[(bi * a.h + hh) * a.sq + i] = sum;
  }
}

// K [BK][d + 4], V [BK][dv + 4], Q [BQ][d], dO [BQ][dv], the score tiles
// (two for dk / dv, one for dq), lse and delta
constexpr int dkdv_smem_floats(int d, int dv) {
  return BK * (d + 4) + BK * (dv + 4) + BQ * (d + dv) + 2 * BQ * BK + 2 * BQ;
}
constexpr int dq_smem_floats(int d, int dv) {
  return dkdv_smem_floats(d, dv) - BQ * BK;
}

template <typename T, int NG>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int d = a.d, dvd = a.dv_dim, lk = d + 4, lv = dvd + 4;
  float* const ks = smem;                    // [BK][lk]
  float* const vs = ks + BK * lk;            // [BK][lv]
  float* const qs = vs + BK * lv;            // [BQ][d]
  float* const dos = qs + BQ * d;            // [BQ][dvd]
  float* const ps = dos + BQ * dvd;          // [BQ][BK]
  float* const dss = ps + BQ * BK;           // [BQ][BK]
  float* const lse_s = dss + BQ * BK;        // [BQ]
  float* const delta_s = lse_s + BQ;         // [BQ]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;    // score tile: rows, keys
  // accumulation: columns 4 tx + 64 c of dk (c < NG, below D) and dv
  // (below Dv)
  const int bi = blockIdx.y / a.hkv, hk = blockIdx.y % a.hkv;
  const int group = a.h / a.hkv;
  const int j0 = blockIdx.x * BK;
  const int jn = min(BK, a.skv - j0);
  const long long k_stride = static_cast<long long>(a.hkv) * d;
  const long long v_stride = static_cast<long long>(a.hkv) * dvd;
  const long long q_stride = static_cast<long long>(a.h) * d;
  const long long o_stride = static_cast<long long>(a.h) * dvd;
  const long long k_base = static_cast<long long>(bi) * a.skv * k_stride +
                           static_cast<long long>(hk) * d;
  const long long v_base = static_cast<long long>(bi) * a.skv * v_stride +
                           static_cast<long long>(hk) * dvd;
  load_tile(ks, static_cast<const T*>(a.k) + k_base, k_stride, j0, a.skv,
            BK, d, lk);
  load_tile(vs, static_cast<const T*>(a.v) + v_base, v_stride, j0, a.skv,
            BK, dvd, lv);

  // the query rows that keep a key of this tile
  const int j_lo = max(j0, -a.kv_off), j_hi = j0 + jn - 1;
  int i_lo = 0, i_hi = a.sq - 1;
  if (a.causal) i_lo = max(i_lo, a.kv_off + j_lo - a.q_off);
  if (a.window > 0)
    i_hi = min(i_hi, a.kv_off + j_hi + a.window - 1 - a.q_off);
  const bool any = j_lo <= j_hi && i_lo <= i_hi;
  const int qt0 = any ? i_lo / BQ : 0, qt1 = any ? i_hi / BQ + 1 : 0;

  float4 dk[4][NG], dv[4][NG];               // keys ty + 16 r
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NG; ++c)
      dk[r][c] = dv[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int g = 0; g < group; ++g) {
    const int hi = hk * group + g;
    const long long q_base = static_cast<long long>(bi) * a.sq * q_stride +
                             static_cast<long long>(hi) * d;
    const long long o_base = static_cast<long long>(bi) * a.sq * o_stride +
                             static_cast<long long>(hi) * dvd;
    const long long row_base = (static_cast<long long>(bi) * a.h + hi) * a.sq;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();                       // the last tile's readers are done
      load_tile(qs, static_cast<const T*>(a.q) + q_base, q_stride, q0, a.sq,
                BQ, d, d);
      load_tile(dos, static_cast<const T*>(a.dout) + o_base, o_stride, q0,
                a.sq, BQ, dvd, dvd);
      if (tid < BQ) {
        const bool ok = q0 + tid < a.sq;
        lse_s[tid] = ok ? a.lse[row_base + q0 + tid] : 0.0f;
        delta_s[tid] = ok ? a.delta[row_base + q0 + tid] : 0.0f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];               // then p and ds
      score_tile(qs, dos, ks, vs, d, dvd, ty, tx, s, dp);
      p_ds(a, q0, j0, ty, tx, lse_s, delta_s, s, dp);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ps[(ty + 16 * r) * BK + tx + 16 * c] = s[r][c];
          dss[(ty + 16 * r) * BK + tx + 16 * c] = dp[r][c];
        }
      __syncthreads();
      const int rows = min(BQ, a.sq - q0);
      for (int i = 0; i < rows; ++i) {       // dv += p^T dout, dk += ds^T q
        float4 ov[NG], qv[NG];
#pragma unroll
        for (int c = 0; c < NG; ++c) {
          const int col = 4 * tx + 64 * c;
          ov[c] = qv[c] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (col < dvd) ov[c] = load4(dos + i * dvd + col);
          if (col < d) qv[c] = load4(qs + i * d + col);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float pv = ps[i * BK + ty + 16 * r];
          const float dsv = dss[i * BK + ty + 16 * r];
#pragma unroll
          for (int c = 0; c < NG; ++c) {
            axpy4(pv, ov[c], dv[r][c]);
            axpy4(dsv, qv[c], dk[r][c]);
          }
        }
      }
    }
  }

  T* const dkb = static_cast<T*>(a.dk) + k_base;
  T* const dvb = static_cast<T*>(a.dv) + v_base;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = ty + 16 * r;
    if (j >= jn) continue;
#pragma unroll
    for (int c = 0; c < NG; ++c) {
      const int col = 4 * tx + 64 * c;
      if (col < d) store4g(dkb + (j0 + j) * k_stride + col, dk[r][c]);
      if (col < dvd) store4g(dvb + (j0 + j) * v_stride + col, dv[r][c]);
    }
  }
}

// The key tiles [t0, t1) of width BK that hold a kept key for some query
// position in [row_lo, row_hi] (flash_attention.cu's `tile_range`).
__device__ __forceinline__ void tile_range(const BwdArgs& a, int row_lo,
                                           int row_hi, int& t0, int& t1) {
  int j_min = a.kv_off < 0 ? -a.kv_off : 0;
  if (a.window > 0) j_min = max(j_min, row_lo - a.window + 1 - a.kv_off);
  int j_max = a.skv - 1;
  if (a.causal) j_max = min(j_max, row_hi - a.kv_off);
  if (j_max < j_min) {
    t0 = t1 = 0;
    return;
  }
  t0 = j_min / BK;
  t1 = j_max / BK + 1;
}

template <typename T, int NG>
__global__ void __launch_bounds__(kThreads) dq_kernel(BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int d = a.d, dvd = a.dv_dim, lk = d + 4, lv = dvd + 4;
  float* const ks = smem;                    // [BK][lk]
  float* const vs = ks + BK * lk;            // [BK][lv]
  float* const qs = vs + BK * lv;            // [BQ][d]
  float* const dos = qs + BQ * d;            // [BQ][dvd]
  float* const dss = dos + BQ * dvd;         // [BQ][BK]
  float* const lse_s = dss + BQ * BK;        // [BQ]
  float* const delta_s = lse_s + BQ;         // [BQ]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int bi = blockIdx.y / a.h, hi = blockIdx.y % a.h;
  const int hk = hi / (a.h / a.hkv);
  const int q0 = blockIdx.x * BQ;
  const long long q_stride = static_cast<long long>(a.h) * d;
  const long long o_stride = static_cast<long long>(a.h) * dvd;
  const long long k_stride = static_cast<long long>(a.hkv) * d;
  const long long v_stride = static_cast<long long>(a.hkv) * dvd;
  const long long q_base = static_cast<long long>(bi) * a.sq * q_stride +
                           static_cast<long long>(hi) * d;
  const long long o_base = static_cast<long long>(bi) * a.sq * o_stride +
                           static_cast<long long>(hi) * dvd;
  const long long k_base = static_cast<long long>(bi) * a.skv * k_stride +
                           static_cast<long long>(hk) * d;
  const long long v_base = static_cast<long long>(bi) * a.skv * v_stride +
                           static_cast<long long>(hk) * dvd;
  const long long row_base = (static_cast<long long>(bi) * a.h + hi) * a.sq;
  load_tile(qs, static_cast<const T*>(a.q) + q_base, q_stride, q0, a.sq, BQ,
            d, d);
  load_tile(dos, static_cast<const T*>(a.dout) + o_base, o_stride, q0, a.sq,
            BQ, dvd, dvd);
  if (tid < BQ) {
    const bool ok = q0 + tid < a.sq;
    lse_s[tid] = ok ? a.lse[row_base + q0 + tid] : 0.0f;
    delta_s[tid] = ok ? a.delta[row_base + q0 + tid] : 0.0f;
  }

  float4 dq[4][NG];                 // rows ty + 16 r, columns 4 tx + 64 c
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NG; ++c) dq[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int last_row = min(q0 + BQ, a.sq) - 1;
  int t0, t1;
  tile_range(a, a.q_off + q0, a.q_off + last_row, t0, t1);
  for (int t = t0; t < t1; ++t) {
    const int j0 = t * BK;
    __syncthreads();                         // the last tile's readers are done
    load_tile(ks, static_cast<const T*>(a.k) + k_base, k_stride, j0, a.skv,
              BK, d, lk);
    load_tile(vs, static_cast<const T*>(a.v) + v_base, v_stride, j0, a.skv,
              BK, dvd, lv);
    __syncthreads();
    float s[4][4], dp[4][4];                 // then p and ds
    score_tile(qs, dos, ks, vs, d, dvd, ty, tx, s, dp);
    p_ds(a, q0, j0, ty, tx, lse_s, delta_s, s, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dss[(ty + 16 * r) * BK + tx + 16 * c] = dp[r][c];
    __syncthreads();
    const int jn = min(BK, a.skv - j0);
    for (int j = 0; j < jn; ++j) {           // dq += ds k
      float4 kv[NG];
#pragma unroll
      for (int c = 0; c < NG; ++c) {
        const int col = 4 * tx + 64 * c;
        kv[c] = col < d ? load4(ks + j * lk + col)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float dsv = dss[(ty + 16 * r) * BK + j];
#pragma unroll
        for (int c = 0; c < NG; ++c) axpy4(dsv, kv[c], dq[r][c]);
      }
    }
  }

  T* const dqb = static_cast<T*>(a.dq) + q_base;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    if (q0 + i >= a.sq) continue;
#pragma unroll
    for (int c = 0; c < NG; ++c) {
      const int col = 4 * tx + 64 * c;
      if (col < d) store4g(dqb + (q0 + i) * q_stride + col, dq[r][c]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& configured) {
  if (configured) return cudaSuccess;   // the opt-in above 48 KB, once
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) configured = true;
  return err;
}

// NG column groups of 64: the instance's largest D and Dv set its
// shared-memory opt-in
template <typename T, int NG>
int launch(const BwdArgs& a, cudaStream_t s) {
  static bool dkdv_ok = false, dq_ok = false;
  constexpr int kD = 64 * NG;
  cudaError_t err = allow_smem(
      dkdv_kernel<T, NG>,
      dkdv_smem_floats(kD, kD) * static_cast<int>(sizeof(float)), dkdv_ok);
  if (err == cudaSuccess)
    err = allow_smem(dq_kernel<T, NG>,
                     dq_smem_floats(kD, kD) * static_cast<int>(sizeof(float)),
                     dq_ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(a.b) * a.sq * a.h;
  delta_kernel<T><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps),
                    kThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<T, NG><<<dim3((a.skv + BK - 1) / BK, a.b * a.hkv), kThreads,
                       dkdv_smem_floats(a.d, a.dv_dim) * sizeof(float),
                       s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T, NG><<<dim3((a.sq + BQ - 1) / BQ, a.b * a.h), kThreads,
                     dq_smem_floats(a.d, a.dv_dim) * sizeof(float), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const BwdArgs& a, cudaStream_t s) {
  return a.d <= kNarrowD ? launch<T, 2>(a, s) : launch<T, 3>(a, s);
}

}  // namespace

extern "C" {

// One call: delta, then dk / dv, then dq. dtype 0: float32 q, k, v, out,
// dout, dq, dk, dv; 1: bfloat16. q, k, dq, dk are D wide, v, out, dout, dv
// Dv wide. lse and delta are float32 [B, H, Sq] (delta is scratch the call
// overwrites). All are contiguous and 16-byte aligned; D % 8 == 0, D <=
// 192, Dv % 8 == 0, Dv <= D, H % Hkv == 0, B * H <= 65535 (the wrapper
// checks each). Returns 0 or a cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const void* lse,
                        void* delta, void* dq, void* dk, void* dv, int dtype,
                        int b, int sq, int skv, int h, int hkv, int d,
                        int dv_dim, float scale, int causal, int window,
                        int q_off, int kv_off, void* stream) {
  if (d <= 0 || d > kMaxD || d % 8 != 0 || dv_dim <= 0 || dv_dim > d ||
      dv_dim % 8 != 0 || hkv <= 0 || h % hkv != 0 || b < 0 || sq < 0 ||
      skv < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t elem = dtype == 1 ? 2 : 4;
  if (b == 0 || h == 0) return 0;
  if (sq == 0 || skv == 0) {   // nothing kept: every gradient is 0
    cudaError_t err = cudaMemsetAsync(
        dq, 0, static_cast<size_t>(b) * sq * h * d * elem, s);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(dk, 0, static_cast<size_t>(b) * skv * hkv * d *
                                       elem, s);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(dv, 0, static_cast<size_t>(b) * skv * hkv *
                                       dv_dim * elem, s);
    return static_cast<int>(err);
  }
  const BwdArgs a{q, k, v, out, dout, static_cast<const float*>(lse),
                  static_cast<float*>(delta), dq, dk, dv, b, sq, skv, h, hkv,
                  d, dv_dim, scale, causal, window, q_off, kv_off};
  return dtype == 1 ? dispatch<__nv_bfloat16>(a, s) : dispatch<float>(a, s);
}

}  // extern "C"
