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
//   so a row with no kept key gives exactly 0 whatever its lse (a select,
//   never a product with exp of a huge number);
//   dv_j = sum_i p_ij dout_i;  ds_ij = p_ij (dout_i . v_j - delta_i) scale;
//   dq_i = sum_j ds_ij k_j;    dk_j = sum_i ds_ij q_i;
//   dk and dv of a kv head summed over its H / Hkv query heads.
//
// Bound: the products, 2 * (3 D + 2 Dv) flops per kept pair (s = q . k and
// dq, dk over D; dout . v and dv over Dv), about 43 GFLOP for qwen2.5-3b's
// [4, 1024, 16, 128] over 2 kv heads, causal (44 us at the bf16 tensor-core
// peak); the bytes (the inputs read once, the outputs written once) are
// about 76 MB (23 us). Both routes below recompute s and dout . v in each of
// their two kernels, so they run 2 * (4 D + 3 Dv) flops a kept pair: 7 / 5
// of the bound at D = Dv, the design's own floor. They take no atomics:
// FlashAttention-2 adds dq across key tiles with float atomics, whose order
// changes from run to run; here dk / dv and dq come from two kernels that
// each own their output rows, every element is written once after sums in
// a fixed order, and a run gives the same bits as the last.
//
// Two routes, by dtype. Neither falls back to the other.
//
// bfloat16: the tensor cores (`tc::`), mma.sync m16n8k16 (bf16 operands,
// float32 sums) fed by ldmatrix (.trans for the operands that are read
// down their rows: dout and q in p^T dout and ds^T q, k in ds k). wgmma and
// TMA are later work. Three or four launches, one C call:
//   1. `delta_kernel`: a warp a (batch, row, head), delta into float32
//      scratch [B, H, Sq];
//   2. `tc::dkdv_kernel`: a block of four warps per (64-key tile, batch *
//      kv head, head split) holds its K and V tiles and walks the query
//      heads of its split and every query tile that keeps a key of the
//      tile (the causal and window masks skip the rest), Q, dO, lse and
//      delta streamed through a two-stage cp.async ring. A warp owns 16
//      keys: it computes s^T = K Q^T and dp^T = V dO^T (keys x rows), turns
//      them into p^T and ds^T in registers, and their accumulator layout is
//      the A operand of dV += p^T dO and dK += ds^T Q, so p and ds never
//      touch shared memory. dk and dv sum in registers over the whole
//      walk and are written once;
//   3. `tc::dq_kernel`: a block of four warps per (64-row query tile, batch
//      * head) holds its Q and dO tiles and walks the live key tiles (as
//      the forward does) through a two-stage cp.async ring of K and V; a
//      warp owns 16 rows: s = Q K^T, dp = dO V^T, ds, dQ += ds K;
//   4. with a head split (`n_split` > 1: grouped heads, too few key tiles
//      to fill the card, as qwen2.5-3b's 2 kv heads give 128 blocks with
//      the heaviest causal one walking 128 steps), each split writes its
//      float32 partial dk / dv to scratch and `tc::sum_kernel` adds the
//      splits in order and rounds once. The wrapper's
//      `flash_bwd_splits` picks n_split from the card's SM count.
//   Rounding: q, k, v, dout are bf16 already; p is rounded to bf16 before
//   p^T dO, ds (with its scale) before ds^T Q and ds K; s, dp, p, ds and
//   every sum stay float32, and each output is rounded to bf16 once.
//   p = 2^(s scale log2(e) - lse log2(e)) on ex2.approx. The element mask
//   runs only on the (query tile, key tile) pairs that cross the diagonal,
//   the window edge, position 0 or the ends of Sq and Skv (a masked and an
//   unmasked copy of the score pass, chosen once a tile); a pair inside
//   the mask takes every element.
//   Instructions issued, more than bytes, set these kernels' time: the
//   tile copies divide nothing (`Walk`), and the dq kernel loads the next
//   k-step's fragments before this one's products (`gemm_nt2`); the dk /
//   dv kernel's score products keep one fragment set, as a second costs
//   it spills.
//   Head dims: the k-step is 16, so D and Dv are padded to DP, DVP, the
//   next multiple of 16 (D = 8, 24, 120 give 16, 32, 128; hubert's 80 is
//   five k-steps); cp.async writes zeros into the pad columns and they are
//   never stored. Shared rows are DP + 8 bf16 wide, (DP + 8) / 8 an odd
//   number of 16-byte words, so the eight rows of an ldmatrix phase fall on
//   distinct banks. Four instances by the largest D and Dv they hold (the
//   register accumulators are sized by them), with the query rows a dk /
//   dv step takes (BQ) and the keys a dq tile takes (BKQ):
//     D <= 64:               BQ 64, BKQ 64; <= 56,320 + 55,296 bytes;
//     D <= 128:              BQ 64, BKQ 64; <= 105,472 + 104,448 bytes,
//                            two blocks an SM;
//     D <= 192, Dv <= 128:   BQ 32, BKQ 32; 86,528 + 86,016 bytes;
//     D <= 192, Dv <= 192:   BQ 16, BKQ 32; 77,056 + 102,400 bytes;
//   (dk / dv block + dq block at the instance's widest D and Dv; a call
//   takes the bytes of its own D and Dv, `tc::dkdv_smem` / `tc::dq_smem`,
//   which the wrapper's `flash_bwd_plan` repeats). A dk / dv warp holds DP
//   / 2 + DVP / 2 accumulators a thread and BQ / 2 of each score tile:
//   192 floats at D = Dv = 128 and at MLA's 192 / 128, so the wide
//   instances take fewer query rows a step; ptxas gives the dk / dv
//   kernels 245-255 registers (a 32-byte spill at D <= 128) and the dq
//   kernels 207-225, which leaves two blocks of four warps an SM.
//
// float32: the FMA pipes (the parity dtype: tensor cores would compute it
// in TF32). Three launches, one C call: `delta_kernel`; `dkdv_kernel` (a
// block of 256 threads per (64-key tile, batch * kv head) walks every
// query head of the group and every live 64-row query tile, p and ds
// recomputed into shared memory, dk and dv summed in registers, 4 x 4
// score tiles a thread, 2 FMA per float loaded); `dq_kernel` (a block per
// (64-row query tile, batch * head) over the live key tiles). Shared
// memory: K at a pitch of D + 4 floats and V at Dv + 4, Q and dO
// unpadded; a block of dkdv_kernel takes 4 * (64 (2 D + 2 Dv + 8) + 2 * 64
// * 64 + 128) bytes: 166,400 at D = Dv = 128, 199,168 at MLA's D 192 / Dv
// 128, 231,936 at D = Dv = 192 (the opt-in ceiling is 232,448); a block of
// dq_kernel 16,384 fewer. A thread accumulates 4 of each 64-column group
// of dk / dv / dq; two groups up to D = 128 and three past it, a template
// argument, so that the narrow instance keeps its registers.
//
// Tolerance against the plain twin: float32 sums in another order,
// 1e-5 of each gradient's largest magnitude in float32; in bfloat16 2e-2
// (the gradients round to 8 bits of mantissa, p and ds round to bf16
// before their products, and the forward's bf16 out enters delta).

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

// eight values of a float32 row in device memory
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 x = load4(p), y = load4(p + 4);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  f[4] = y.x; f[5] = y.y; f[6] = y.z; f[7] = y.w;
}
// four values into a float32 row in device memory
__device__ __forceinline__ void store4g(float* p, float4 v) { store4(p, v); }

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

template <typename T>
cudaError_t launch_delta(const BwdArgs& a, cudaStream_t s) {
  const long long rows = static_cast<long long>(a.b) * a.sq * a.h;
  delta_kernel<T><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps),
                    kThreads, 0, s>>>(a);
  return cudaGetLastError();
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
  if (err == cudaSuccess) err = launch_delta<T>(a, s);
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

// ---------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

typedef __nv_bfloat16 bf16;
constexpr int kThreads = 128;   // four warps of 16 keys (dk / dv) or rows (dq)
constexpr int BK = 64;          // keys a dk / dv block
constexpr int BQD = 64;         // query rows a dq block
constexpr int kPad = 8;         // bf16 past a shared row's padded width
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int pad16(int d) { return (d + 15) / 16 * 16; }
__host__ __device__ constexpr int pitch(int d) { return pad16(d) + kPad; }
// query rows a dk / dv step and keys a dq tile, by the instance's widest
// (padded) D and Dv: fewer past D = 128, so that the accumulators and the
// score tiles stay in registers
__host__ __device__ constexpr int bq_of(int dp, int dvp) {
  return dvp > 128 ? 16 : dp > 128 ? 32 : 64;
}
__host__ __device__ constexpr int bkq_of(int dp) { return dp > 128 ? 32 : 64; }

// dk / dv block: K [BK][pitch D], V [BK][pitch Dv], two stages of Q [bq]
// [pitch D] and dO [bq][pitch Dv] in bf16, then two stages of lse and delta
// [bq] in float32
__host__ __device__ constexpr int dkdv_smem(int d, int dv, int bq) {
  return 2 * (pitch(d) + pitch(dv)) * (BK + 2 * bq) + 4 * 2 * 2 * bq;
}
// dq block: Q [BQD][pitch D], dO [BQD][pitch Dv], two stages of K [bkq]
// [pitch D] and V [bkq][pitch Dv]
__host__ __device__ constexpr int dq_smem(int d, int dv, int bkq) {
  return 2 * (pitch(d) + pitch(dv)) * (BQD + 2 * bkq);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, or 16 zero bytes when !ok (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// four 8 x 8 bf16 matrices from shared memory, lane l giving row l % 8 of
// matrix l / 8; .trans hands each thread the transposed matrices' pairs
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// d (16 x 8, f32) += a (16 x 16, bf16, row-major) . b (16 x 8, bf16)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.0f;
}
// The A operand of a product over 16 columns (n-tiles 2 kk, 2 kk + 1) of an
// accumulator x[n][4]: the m16n8k16 accumulator layout is the A layout,
// rounded to bf16.
template <int N>
__device__ __forceinline__ void a_frag(uint32_t (&r)[4],
                                       const float (&x)[N][4], int kk) {
  r[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
  r[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
  r[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  r[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

// acc[N][4] (16 rows of this warp x 8 N columns) += A . B^T over k < kp:
// A rows at `ar` (this warp's 16, pitch la), B rows (the N columns) at `br`
// (pitch lb), both row-major in shared memory with k along the row
template <int KP, int N>
__device__ __forceinline__ void gemm_nt(float (&acc)[N][4], const bf16* ar,
                                        int la, const bf16* br, int lb,
                                        int kp, int lane) {
  const bf16* const a0 = ar + (lane & 15) * la + (lane >> 4) * 8;
  const bf16* const b0 =
      br + ((lane & 7) + ((lane >> 4) << 3)) * lb + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int k0 = 0; k0 < KP; k0 += 16) {
    if (k0 >= kp) break;
    uint32_t af[4];
    ldsm_x4(af, a0 + k0);
#pragma unroll
    for (int n2 = 0; n2 < N / 2; ++n2) {
      uint32_t bf[4];
      ldsm_x4(bf, b0 + n2 * 16 * lb + k0);
      mma16816(acc[2 * n2], af, bf[0], bf[1]);
      mma16816(acc[2 * n2 + 1], af, bf[2], bf[3]);
    }
  }
}

// gemm_nt with the next k-step's fragments loaded before this one's
// products (two register sets)
template <int KP, int N>
__device__ __forceinline__ void gemm_nt2(float (&acc)[N][4], const bf16* ar,
                                         int la, const bf16* br, int lb,
                                         int kp, int lane) {
  const bf16* const a0 = ar + (lane & 15) * la + (lane >> 4) * 8;
  const bf16* const b0 =
      br + ((lane & 7) + ((lane >> 4) << 3)) * lb + ((lane >> 3) & 1) * 8;
  uint32_t af[2][4], bf[2][N / 2][4];
  ldsm_x4(af[0], a0);
#pragma unroll
  for (int n2 = 0; n2 < N / 2; ++n2) ldsm_x4(bf[0][n2], b0 + n2 * 16 * lb);
#pragma unroll
  for (int k = 0; k < KP / 16; ++k) {
    if (k * 16 >= kp) break;
    const int cur = k & 1;
    if (k + 1 < KP / 16 && (k + 1) * 16 < kp) {
      ldsm_x4(af[cur ^ 1], a0 + (k + 1) * 16);
#pragma unroll
      for (int n2 = 0; n2 < N / 2; ++n2)
        ldsm_x4(bf[cur ^ 1][n2], b0 + n2 * 16 * lb + (k + 1) * 16);
    }
#pragma unroll
    for (int n2 = 0; n2 < N / 2; ++n2) {
      mma16816(acc[2 * n2], af[cur], bf[cur][n2][0], bf[cur][n2][1]);
      mma16816(acc[2 * n2 + 1], af[cur], bf[cur][n2][2], bf[cur][n2][3]);
    }
  }
}

// acc[NC][4] (16 rows x 8 NC columns below cp) += x (16 rows x 16 KK
// columns, an accumulator rounded to bf16) . Y, Y's 16 KK rows row-major at
// `yr` (pitch ly), read with ldmatrix.trans
template <int KK, int NC>
__device__ __forceinline__ void gemm_rt(float (&acc)[NC][4],
                                        const float (&x)[2 * KK][4],
                                        const bf16* yr, int ly, int cp,
                                        int lane) {
  const bf16* const y0 =
      yr + ((lane & 7) + ((lane >> 3) & 1) * 8) * ly + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    uint32_t af[4];
    a_frag(af, x, kk);
#pragma unroll
    for (int n2 = 0; n2 < NC / 2; ++n2) {
      if (n2 * 16 < cp) {
        uint32_t bf[4];
        ldsm_x4_t(bf, y0 + kk * 16 * ly + n2 * 16);
        mma16816(acc[2 * n2], af, bf[0], bf[1]);
        mma16816(acc[2 * n2 + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// How a block's threads walk the 16-byte chunks of a tile whose rows are
// w bf16 wide (padded to a multiple of 16): thread t starts at chunk t of
// the row-major order and steps kThreads chunks at a time, kept as a (row,
// chunk) pair advanced by (dr, dc), so that the copies divide nothing (a
// runtime integer divide is a sequence of some twenty instructions).
struct Walk {
  int r, c, dr, dc, chunks;
};
__device__ __forceinline__ Walk walk(int w) {
  const int chunks = pad16(w) / 8;
  return {static_cast<int>(threadIdx.x) / chunks,
          static_cast<int>(threadIdx.x) % chunks, kThreads / chunks,
          kThreads % chunks, chunks};
}

// rows [r0, r0 + rows) of one head of a [B, S, heads, w] bf16 tensor into
// shared memory [rows][pitch], cp.async, 16 bytes a copy: rows at or past n
// and the columns from w to the padded width read as zeros
__device__ __forceinline__ void load_rows(bf16* dst, int pitch_, const bf16* g,
                                          long long row_stride, int r0, int n,
                                          int rows, int w, const Walk& m) {
  for (int r = m.r, c = m.c; r < rows;) {
    const bool ok = r0 + r < n && c * 8 < w;
    cp_async16(dst + r * pitch_ + c * 8,
               ok ? g + (r0 + r) * row_stride + c * 8 : g, ok);
    r += m.dr;
    c += m.dc;
    if (c >= m.chunks) {
      c -= m.chunks;
      ++r;
    }
  }
}

// Whether every (row, key) of a tile of query rows [q0, q0 + rows) and keys
// [j0, j0 + keys) is kept and inside Sq and Skv: then no element mask.
__device__ __forceinline__ bool tile_full(const BwdArgs& a, int q0, int rows,
                                          int j0, int keys) {
  const int r_lo = a.q_off + q0, r_hi = r_lo + rows - 1;
  const int c_lo = a.kv_off + j0, c_hi = c_lo + keys - 1;
  return q0 + rows <= a.sq && j0 + keys <= a.skv && c_lo >= 0 &&
         (!a.causal || c_hi <= r_lo) &&
         (a.window <= 0 || c_lo >= r_hi - a.window + 1);
}

// p^T and ds^T of a dk / dv warp's score tiles, in place of s^T and dp^T:
// keys jr and jr + 8 (rows of the tiles) against query rows q0 + n * 8 + 2 t
// + e (columns); lse and delta of the step's rows in shared memory. kMask:
// the tile crosses the mask, so each element is selected by its own (row,
// key) position; a dropped pair is 0 whatever exp2 gave.
template <bool kMask, int N>
__device__ __forceinline__ void p_ds_t(const BwdArgs& a, float (&st)[N][4],
                                       float (&pt)[N][4], const float* lse_s,
                                       const float* del_s, int q0, int jr,
                                       int t4, float sl2) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = n * 8 + 2 * t4 + e;
      const float l2 = lse_s[i] * kLog2e, dl = del_s[i];
      float p0 = fast_exp2(st[n][e] * sl2 - l2);
      float p1 = fast_exp2(st[n][2 + e] * sl2 - l2);
      if (kMask) {
        const int row = a.q_off + q0 + i;
        const bool in = q0 + i < a.sq;
        p0 = in && jr < a.skv && kept(row, a.kv_off + jr, a) ? p0 : 0.0f;
        p1 = in && jr + 8 < a.skv && kept(row, a.kv_off + jr + 8, a)
                 ? p1 : 0.0f;
      }
      st[n][e] = p0;
      st[n][2 + e] = p1;
      pt[n][e] = p0 * (pt[n][e] - dl) * a.scale;
      pt[n][2 + e] = p1 * (pt[n][2 + e] - dl) * a.scale;
    }
  }
}

// ds of a dq warp's score tiles, in place of dp: rows row0 and row0 + 8
// (in0, in1: inside Sq) against keys j0 + n * 8 + 2 t + e.
template <bool kMask, int N>
__device__ __forceinline__ void p_ds(const BwdArgs& a, const float (&sc)[N][4],
                                     float (&dpp)[N][4], float l2_0,
                                     float l2_1, float dl0, float dl1,
                                     int row0, bool in0, bool in1, int j0,
                                     int t4, float sl2) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float p0 = fast_exp2(sc[n][e] * sl2 - l2_0);
      float p1 = fast_exp2(sc[n][2 + e] * sl2 - l2_1);
      if (kMask) {
        const int j = j0 + n * 8 + 2 * t4 + e, col = a.kv_off + j;
        const bool jin = j < a.skv;
        p0 = in0 && jin && kept(row0, col, a) ? p0 : 0.0f;
        p1 = in1 && jin && kept(row0 + 8, col, a) ? p1 : 0.0f;
      }
      dpp[n][e] = p0 * (dpp[n][e] - dl0) * a.scale;
      dpp[n][2 + e] = p1 * (dpp[n][2 + e] - dl1) * a.scale;
    }
  }
}

// A block per (64-key tile, batch * kv head, head split). Warp w holds keys
// 16 w .. 16 w + 15 of the tile; this thread keys g and g + 8 of them (g =
// lane / 4) and query rows or columns 2 t, 2 t + 1 of each 8-wide n-tile
// (t = lane % 4), the m16n8k16 accumulator layout.
template <int DP, int DVP>
__global__ void __launch_bounds__(kThreads, 2)
    dkdv_kernel(BwdArgs a, float* part, int n_split) {
  constexpr int BQ = bq_of(DP, DVP);
  extern __shared__ float4 smem4[];
  bf16* const sm = reinterpret_cast<bf16*>(smem4);
  const int d = a.d, dvd = a.dv_dim, dp = pad16(d), dvp = pad16(dvd);
  const int lk = dp + kPad, lv = dvp + kPad;
  bf16* const ks = sm;                    // [BK][lk]
  bf16* const vs = ks + BK * lk;          // [BK][lv]
  bf16* const qs = vs + BK * lv;          // [2][BQ][lk]
  bf16* const os = qs + 2 * BQ * lk;      // [2][BQ][lv]
  float* const rs = reinterpret_cast<float*>(os + 2 * BQ * lv);  // [2][2][BQ]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const Walk wk = walk(d), wv = walk(dvd);
  const int bi = blockIdx.y / a.hkv, hk = blockIdx.y % a.hkv;
  const int group = a.h / a.hkv, per = (group + n_split - 1) / n_split;
  const int g_lo = blockIdx.z * per, g_hi = min(group, g_lo + per);
  const int j0 = blockIdx.x * BK;
  const bf16* const qg = static_cast<const bf16*>(a.q);
  const bf16* const og = static_cast<const bf16*>(a.dout);
  const long long q_stride = static_cast<long long>(a.h) * d;
  const long long o_stride = static_cast<long long>(a.h) * dvd;
  const long long k_stride = static_cast<long long>(a.hkv) * d;
  const long long v_stride = static_cast<long long>(a.hkv) * dvd;
  const long long k_base = static_cast<long long>(bi) * a.skv * k_stride +
                           static_cast<long long>(hk) * d;
  const long long v_base = static_cast<long long>(bi) * a.skv * v_stride +
                           static_cast<long long>(hk) * dvd;
  load_rows(ks, lk, static_cast<const bf16*>(a.k) + k_base, k_stride, j0,
            a.skv, BK, d, wk);
  load_rows(vs, lv, static_cast<const bf16*>(a.v) + v_base, v_stride, j0,
            a.skv, BK, dvd, wv);

  // the query rows that keep a key of this tile
  const int jn = min(BK, a.skv - j0);
  const int j_lo = max(j0, -a.kv_off), j_hi = j0 + jn - 1;
  int i_lo = 0, i_hi = a.sq - 1;
  if (a.causal) i_lo = max(i_lo, a.kv_off + j_lo - a.q_off);
  if (a.window > 0)
    i_hi = min(i_hi, a.kv_off + j_hi + a.window - 1 - a.q_off);
  const bool any = j_lo <= j_hi && i_lo <= i_hi && g_lo < g_hi;
  const int qt0 = any ? i_lo / BQ : 0, nqt = any ? i_hi / BQ + 1 - qt0 : 0;
  const int n_steps = nqt * (any ? g_hi - g_lo : 0);

  // step s: query head hk * group + g_lo + s / nqt, query tile qt0 + s %
  // nqt, walked as (head, tile) counters: the next step to load
  int ld_h = hk * group + g_lo, ld_t = qt0;
  auto load_step = [&](int stage) {
    const int hi = ld_h, q0 = ld_t * BQ;
    if (++ld_t == qt0 + nqt) {
      ld_t = qt0;
      ++ld_h;
    }
    const long long rb = static_cast<long long>(bi) * a.sq;
    load_rows(qs + stage * BQ * lk, lk,
              qg + rb * q_stride + static_cast<long long>(hi) * d, q_stride,
              q0, a.sq, BQ, d, wk);
    load_rows(os + stage * BQ * lv, lv,
              og + rb * o_stride + static_cast<long long>(hi) * dvd, o_stride,
              q0, a.sq, BQ, dvd, wv);
    if (threadIdx.x < 2 * BQ) {
      const int r = threadIdx.x % BQ;
      const bool ok = q0 + r < a.sq;
      const float* const src =
          (threadIdx.x < BQ ? a.lse : a.delta) +
          (static_cast<long long>(bi) * a.h + hi) * a.sq + (ok ? q0 + r : 0);
      cp_async4(rs + stage * 2 * BQ + threadIdx.x, src, ok);
    }
  };
  if (n_steps > 0) load_step(0);
  cp_async_commit();

  float dk[DP / 8][4], dv[DVP / 8][4];
  zero(dk);
  zero(dv);
  const float sl2 = a.scale * kLog2e;
  const int kr = warp * 16;               // this warp's keys in the tile
  const int jr = j0 + kr + g8;            // this thread's keys jr, jr + 8
  int cur_t = qt0;                        // the query tile of step s

  for (int s = 0; s < n_steps; ++s) {
    const int stage = s & 1;
    cp_async_wait_all();
    __syncthreads();            // step s has landed; step s - 1 is read
    if (s + 1 < n_steps) load_step(stage ^ 1);
    cp_async_commit();
    const bf16* const qt = qs + stage * BQ * lk;
    const bf16* const ot = os + stage * BQ * lv;
    const float* const lse_s = rs + stage * 2 * BQ;
    const float* const del_s = lse_s + BQ;
    const int q0 = cur_t * BQ;
    if (++cur_t == qt0 + nqt) cur_t = qt0;

    // s^T = K Q^T and dp^T = V dO^T: this warp's 16 keys x BQ rows
    float st[BQ / 8][4], pt[BQ / 8][4];
    zero(st);
    zero(pt);
    gemm_nt<DP>(st, ks + kr * lk, lk, qt, lk, dp, lane);
    gemm_nt<DVP>(pt, vs + kr * lv, lv, ot, lv, dvp, lane);

    // p^T and ds^T in place; the mask only where the tile crosses it
    if (tile_full(a, q0, BQ, j0, BK))
      p_ds_t<false>(a, st, pt, lse_s, del_s, q0, jr, t4, sl2);
    else
      p_ds_t<true>(a, st, pt, lse_s, del_s, q0, jr, t4, sl2);

    // dV += p^T dO, dK += ds^T Q: the score tiles are the A operands
    gemm_rt<BQ / 16>(dv, st, ot, lv, dvp, lane);
    gemm_rt<BQ / 16>(dk, pt, qt, lk, dp, lane);
  }
  cp_async_wait_all();          // a block with no step still has K and V

  // rows jr and jr + 8, columns n * 8 + 2 t of dk and dv; with a head
  // split, float32 partials [n_split][dk's elements, then dv's]
  const long long nk = static_cast<long long>(a.b) * a.skv * k_stride;
  const long long nv = static_cast<long long>(a.b) * a.skv * v_stride;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = jr + 8 * half;
    if (j >= a.skv) continue;
    const long long ko = k_base + j * k_stride, vo = v_base + j * v_stride;
    if (n_split == 1) {
      bf16* const dkr = static_cast<bf16*>(a.dk) + ko;
      bf16* const dvr = static_cast<bf16*>(a.dv) + vo;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int c = n * 8 + 2 * t4;
        if (c < d)
          *reinterpret_cast<__nv_bfloat162*>(dkr + c) = __floats2bfloat162_rn(
              dk[n][2 * half], dk[n][2 * half + 1]);
      }
#pragma unroll
      for (int n = 0; n < DVP / 8; ++n) {
        const int c = n * 8 + 2 * t4;
        if (c < dvd)
          *reinterpret_cast<__nv_bfloat162*>(dvr + c) = __floats2bfloat162_rn(
              dv[n][2 * half], dv[n][2 * half + 1]);
      }
    } else {
      float* const pk = part + blockIdx.z * (nk + nv) + ko;
      float* const pv = part + blockIdx.z * (nk + nv) + nk + vo;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int c = n * 8 + 2 * t4;
        if (c < d)
          *reinterpret_cast<float2*>(pk + c) =
              make_float2(dk[n][2 * half], dk[n][2 * half + 1]);
      }
#pragma unroll
      for (int n = 0; n < DVP / 8; ++n) {
        const int c = n * 8 + 2 * t4;
        if (c < dvd)
          *reinterpret_cast<float2*>(pv + c) =
              make_float2(dv[n][2 * half], dv[n][2 * half + 1]);
      }
    }
  }
}

// dk and dv from the splits' partials: element i of [dk's, then dv's] is
// the sum over splits 0, 1, ... in order, rounded once
__global__ void __launch_bounds__(256)
    sum_kernel(const float* part, long long nk, long long nv, int n_split,
               bf16* dk, bf16* dv) {
  const long long n = nk + nv;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * 256) {
    float sum = 0.0f;
    for (int z = 0; z < n_split; ++z) sum += part[z * n + i];
    if (i < nk)
      dk[i] = __float2bfloat16(sum);
    else
      dv[i - nk] = __float2bfloat16(sum);
  }
}

// A block per (64-row query tile, batch * head). Warp w holds rows 16 w ..
// 16 w + 15 of the tile; this thread rows g and g + 8 of them.
template <int DP, int DVP>
__global__ void __launch_bounds__(kThreads, 2) dq_kernel(BwdArgs a) {
  constexpr int BKQ = bkq_of(DP);
  extern __shared__ float4 smem4[];
  bf16* const sm = reinterpret_cast<bf16*>(smem4);
  const int d = a.d, dvd = a.dv_dim, dp = pad16(d), dvp = pad16(dvd);
  const int lk = dp + kPad, lv = dvp + kPad;
  bf16* const qs = sm;                    // [BQD][lk]
  bf16* const os = qs + BQD * lk;         // [BQD][lv]
  bf16* const ks = os + BQD * lv;         // [2][BKQ][lk]
  bf16* const vs = ks + 2 * BKQ * lk;     // [2][BKQ][lv]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const Walk wk = walk(d), wv = walk(dvd);
  const int bi = blockIdx.y / a.h, hi = blockIdx.y % a.h;
  const int hk = hi / (a.h / a.hkv);
  const int q0 = blockIdx.x * BQD;
  const long long q_stride = static_cast<long long>(a.h) * d;
  const long long o_stride = static_cast<long long>(a.h) * dvd;
  const long long k_stride = static_cast<long long>(a.hkv) * d;
  const long long v_stride = static_cast<long long>(a.hkv) * dvd;
  const long long q_base = static_cast<long long>(bi) * a.sq * q_stride +
                           static_cast<long long>(hi) * d;
  const long long o_base = static_cast<long long>(bi) * a.sq * o_stride +
                           static_cast<long long>(hi) * dvd;
  const bf16* const kg = static_cast<const bf16*>(a.k) +
                         static_cast<long long>(bi) * a.skv * k_stride +
                         static_cast<long long>(hk) * d;
  const bf16* const vg = static_cast<const bf16*>(a.v) +
                         static_cast<long long>(bi) * a.skv * v_stride +
                         static_cast<long long>(hk) * dvd;
  load_rows(qs, lk, static_cast<const bf16*>(a.q) + q_base, q_stride, q0,
            a.sq, BQD, d, wk);
  load_rows(os, lv, static_cast<const bf16*>(a.dout) + o_base, o_stride, q0,
            a.sq, BQD, dvd, wv);

  const int last_row = min(q0 + BQD, a.sq) - 1;
  int t0 = 0, t1 = 0;
  {   // the key tiles of width BKQ that keep a key for some row of the tile
    const int row_lo = a.q_off + q0, row_hi = a.q_off + last_row;
    int j_min = a.kv_off < 0 ? -a.kv_off : 0;
    if (a.window > 0) j_min = max(j_min, row_lo - a.window + 1 - a.kv_off);
    int j_max = a.skv - 1;
    if (a.causal) j_max = min(j_max, row_hi - a.kv_off);
    if (j_max >= j_min) {
      t0 = j_min / BKQ;
      t1 = j_max / BKQ + 1;
    }
  }
  auto load_tile = [&](int t, int stage) {
    load_rows(ks + stage * BKQ * lk, lk, kg, k_stride, t * BKQ, a.skv, BKQ,
              d, wk);
    load_rows(vs + stage * BKQ * lv, lv, vg, v_stride, t * BKQ, a.skv, BKQ,
              dvd, wv);
  };
  if (t0 < t1) load_tile(t0, 0);
  cp_async_commit();

  const int r0 = warp * 16 + g8;          // this thread's rows r0, r0 + 8
  const long long rb = (static_cast<long long>(bi) * a.h + hi) * a.sq + q0;
  const bool in0 = q0 + r0 < a.sq, in1 = q0 + r0 + 8 < a.sq;
  const float l2_0 = in0 ? a.lse[rb + r0] * kLog2e : 0.0f;
  const float l2_1 = in1 ? a.lse[rb + r0 + 8] * kLog2e : 0.0f;
  const float dl0 = in0 ? a.delta[rb + r0] : 0.0f;
  const float dl1 = in1 ? a.delta[rb + r0 + 8] : 0.0f;
  const int row0 = a.q_off + q0 + r0;
  const float sl2 = a.scale * kLog2e;
  float dq[DP / 8][4];
  zero(dq);

  for (int t = t0; t < t1; ++t) {
    const int stage = (t - t0) & 1;
    cp_async_wait_all();
    __syncthreads();            // tile t has landed; tile t - 1 is read
    if (t + 1 < t1) load_tile(t + 1, stage ^ 1);
    cp_async_commit();
    const bf16* const kt = ks + stage * BKQ * lk;
    const bf16* const vt = vs + stage * BKQ * lv;
    const int j0 = t * BKQ;

    float sc[BKQ / 8][4], dpp[BKQ / 8][4];   // this warp's 16 rows x BKQ keys
    zero(sc);
    zero(dpp);
    gemm_nt2<DP>(sc, qs + warp * 16 * lk, lk, kt, lk, dp, lane);
    gemm_nt2<DVP>(dpp, os + warp * 16 * lv, lv, vt, lv, dvp, lane);

    if (tile_full(a, q0, BQD, j0, BKQ))
      p_ds<false>(a, sc, dpp, l2_0, l2_1, dl0, dl1, row0, in0, in1, j0, t4,
                  sl2);
    else
      p_ds<true>(a, sc, dpp, l2_0, l2_1, dl0, dl1, row0, in0, in1, j0, t4,
                 sl2);
    gemm_rt<BKQ / 16>(dq, dpp, kt, lk, dp, lane);   // dQ += ds K
  }
  cp_async_wait_all();          // a block with no key tile still has Q, dO

  bf16* const dqb = static_cast<bf16*>(a.dq) + q_base;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = q0 + r0 + 8 * half;
    if (i >= a.sq) continue;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = n * 8 + 2 * t4;
      if (c < d)
        *reinterpret_cast<__nv_bfloat162*>(dqb + i * q_stride + c) =
            __floats2bfloat162_rn(dq[n][2 * half], dq[n][2 * half + 1]);
    }
  }
}

// the instance of (DP, DVP): its opt-in is its widest call's bytes
template <int DP, int DVP>
int launch(const BwdArgs& a, float* part, int n_split, cudaStream_t s) {
  static bool dkdv_ok = false, dq_ok = false;
  constexpr int BQ = bq_of(DP, DVP), BKQ = bkq_of(DP);
  cudaError_t err = allow_smem(dkdv_kernel<DP, DVP>,
                               dkdv_smem(DP, DVP, BQ), dkdv_ok);
  if (err == cudaSuccess)
    err = allow_smem(dq_kernel<DP, DVP>, dq_smem(DP, DVP, BKQ), dq_ok);
  if (err == cudaSuccess) err = launch_delta<bf16>(a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<DP, DVP><<<dim3((a.skv + BK - 1) / BK, a.b * a.hkv, n_split),
                         kThreads, dkdv_smem(a.d, a.dv_dim, BQ), s>>>(
      a, part, n_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<DP, DVP><<<dim3((a.sq + BQD - 1) / BQD, a.b * a.h), kThreads,
                       dq_smem(a.d, a.dv_dim, BKQ), s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  const long long nk = static_cast<long long>(a.b) * a.skv * a.hkv * a.d;
  const long long nv = static_cast<long long>(a.b) * a.skv * a.hkv * a.dv_dim;
  const long long blocks = min((nk + nv + 255) / 256, 4096LL);
  sum_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      part, nk, nv, n_split, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv));
  return static_cast<int>(cudaGetLastError());
}

// The instance a call takes: by D, and past D = 128 by Dv.
__host__ __device__ constexpr int instance(int d, int dv) {
  return d <= 64 ? 0 : d <= 128 ? 1 : dv <= 128 ? 2 : 3;
}

}  // namespace tc

template <typename T>
int dispatch(const BwdArgs& a, cudaStream_t s) {
  return a.d <= kNarrowD ? launch<T, 2>(a, s) : launch<T, 3>(a, s);
}

// the kernel of a call's dk / dv (which 0) or dq (which 1) launch, by
// dtype, D and Dv: its dynamic shared memory at this call's D and Dv, and
// the opt-in its launch sets (the instance's widest call's bytes)
struct KernelSmem {
  const void* fn;
  int bytes, opt_in;
};
KernelSmem kernel_smem(int dtype, int d, int dv, int which) {
  if (dtype != 1) {
    const int kd = d <= kNarrowD ? 128 : 192;
    const int f = static_cast<int>(sizeof(float));
    const int bytes = f * (which == 0 ? dkdv_smem_floats(d, dv)
                                      : dq_smem_floats(d, dv));
    const int opt_in = f * (which == 0 ? dkdv_smem_floats(kd, kd)
                                       : dq_smem_floats(kd, kd));
    if (d <= kNarrowD)
      return {which == 0 ? reinterpret_cast<const void*>(dkdv_kernel<float, 2>)
                         : reinterpret_cast<const void*>(dq_kernel<float, 2>),
              bytes, opt_in};
    return {which == 0 ? reinterpret_cast<const void*>(dkdv_kernel<float, 3>)
                       : reinterpret_cast<const void*>(dq_kernel<float, 3>),
            bytes, opt_in};
  }
  switch (tc::instance(d, dv)) {
#define TC_CASE(I, DP, DVP)                                                   \
  case I:                                                                     \
    return which == 0                                                         \
               ? KernelSmem{reinterpret_cast<const void*>(                    \
                                tc::dkdv_kernel<DP, DVP>),                    \
                            tc::dkdv_smem(d, dv, tc::bq_of(DP, DVP)),         \
                            tc::dkdv_smem(DP, DVP, tc::bq_of(DP, DVP))}       \
               : KernelSmem{reinterpret_cast<const void*>(                    \
                                tc::dq_kernel<DP, DVP>),                      \
                            tc::dq_smem(d, dv, tc::bkq_of(DP)),               \
                            tc::dq_smem(DP, DVP, tc::bkq_of(DP))};
    TC_CASE(0, 64, 64)
    TC_CASE(1, 128, 128)
    TC_CASE(2, 192, 128)
    TC_CASE(3, 192, 192)
#undef TC_CASE
  }
  return {nullptr, 0, 0};
}

}  // namespace

extern "C" {

// One call. dtype 0: float32 q, k, v, out, dout, dq, dk, dv (the FMA
// kernels: delta, dk / dv, dq); 1: bfloat16 (the tensor-core kernels:
// delta, dk / dv over n_split head splits, dq, and with n_split > 1 the
// splits' sum). q, k, dq, dk are D wide, v, out, dout, dv Dv wide. lse
// and delta are float32 [B, H, Sq] (delta is scratch the call
// overwrites); `part` is float32 scratch of n_split * B * Skv * Hkv * (D +
// Dv) when bf16 and n_split > 1, else unused. All are contiguous and
// 16-byte aligned; D % 8 == 0, D <= 192, Dv % 8 == 0, Dv <= D, H % Hkv ==
// 0, B * H <= 65535, 1 <= n_split <= H / Hkv (the wrapper checks each;
// float32 takes n_split 1). Returns 0 or a cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const void* lse,
                        void* delta, void* part, void* dq, void* dk, void* dv,
                        int dtype, int b, int sq, int skv, int h, int hkv,
                        int d, int dv_dim, float scale, int causal, int window,
                        int q_off, int kv_off, int n_split, void* stream) {
  if (d <= 0 || d > kMaxD || d % 8 != 0 || dv_dim <= 0 || dv_dim > d ||
      dv_dim % 8 != 0 || hkv <= 0 || h % hkv != 0 || b < 0 || sq < 0 ||
      skv < 0 || n_split < 1 || n_split > h / hkv ||
      (dtype != 1 && n_split != 1) || (n_split > 1 && part == nullptr))
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
  if (dtype != 1) return dispatch<float>(a, s);
  float* const p = static_cast<float*>(part);
  switch (tc::instance(d, dv_dim)) {
    case 0: return tc::launch<64, 64>(a, p, n_split, s);
    case 1: return tc::launch<128, 128>(a, p, n_split, s);
    case 2: return tc::launch<192, 128>(a, p, n_split, s);
    default: return tc::launch<192, 192>(a, p, n_split, s);
  }
}

// The dynamic shared memory of a call's dk / dv block (which 0) or dq
// block (which 1), by dtype, D and Dv: what the wrapper's flash_bwd_plan
// must repeat. -1 for a D or Dv the kernels do not take.
int flash_attention_bwd_smem(int dtype, int d, int dv, int which) {
  if (d <= 0 || d > kMaxD || d % 8 || dv <= 0 || dv > d || dv % 8)
    return -1;
  return kernel_smem(dtype, d, dv, which).bytes;
}

// The blocks an SM holds of that kernel at that call's shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks. It sets
// the kernel's opt-in to what its launch sets, the instance's widest
// call's bytes: a smaller one would refuse a later, wider launch, whose
// `launch` sets the opt-in only once. Returns 0 or a cudaError_t.
int flash_attention_bwd_occupancy(int dtype, int d, int dv, int which,
                                  int* blocks) {
  if (d <= 0 || d > kMaxD || d % 8 || dv <= 0 || dv > d || dv % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const KernelSmem ks = kernel_smem(dtype, d, dv, which);
  cudaError_t err = cudaFuncSetAttribute(
      ks.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, ks.opt_in);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, ks.fn, dtype == 1 ? tc::kThreads : kThreads, ks.bytes);
  return static_cast<int>(err);
}

}  // extern "C"
